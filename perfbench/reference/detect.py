"""Refine, decode and deduplicate quad candidates, plain PyTorch: a frozen
copy of the port's plain version (``detect_candidates_plain``).

Per candidate: AprilTag-style edge-line refinement of the corners (or
cornerSubPix's iteration), the bit grid sampled through the quad's
homography, Otsu's threshold and a per-cell majority, a border, contrast
and Hamming-distance gate against the dictionary, a second attempt over
the cells' central half; then cross-window duplicate suppression and
compaction per frame.  The quad geometry computes in the ``dtype`` given
to :func:`detect` (float64 as configured; float32 is the control).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from .pnp import homography_4pt


class DetectorParams(NamedTuple):
    """The detector's configuration (cv.aruco.DetectorParameters' roles),
    with the upstream project's tuned values (its cam.py:131-135)."""

    win_sizes: tuple = (3, 9, 13, 19, 23, 29, 33)
    thresh_const: float = 10.0
    max_candidates: int = 16  # per window size
    max_candidates_4conn: int = 8  # extra per-window slots for 4-connected splits
    max_detections: int = 24  # per image, after dedup
    ccl_passes: int = 10  # label-propagation passes of the pure mode's CCL
    min_area: float = 64.0  # px^2, component area
    max_area_rate: float = 0.25  # fraction of image area
    border_margin: int = 2  # px, candidates touching the border are dropped
    refine_samples: int = 16  # samples per edge for subpixel refinement
    refine_offsets: int = 5  # perpendicular probes per sample
    corner_refine: str = "apriltag"
    max_border_err_rate: float = 0.35  # erroneous border bits tolerated
    # Hamming budget for id matching; None = auto (resolve_error_correction)
    error_correction_bits: int | None = None
    error_correction_rate: float = 0.6  # cv2 errorCorrectionRate default
    decode_samples: int = 5  # NxN samples per bit cell
    # the pure mode's re-fit of degenerate quads: slots per image, and the
    # rows subsampled from a component for its hull points
    max_refit_candidates: int = 6
    refit_rows: int = 128
    subpix_win: int = 5  # cornerSubPix half-window (cv2 winSize=(5,5))
    subpix_iters: int = 50  # cornerRefinementMaxIterations (cam.py:133)
    subpix_acc: float = 0.05  # cornerRefinementMinAccuracy (cam.py:131)
    min_cell_contrast: float = 20.0  # grey levels between darkest/brightest cell means
    refine_clamp_px: float = 4.0  # reject refinements moving a corner farther
    dedup_radius_rate: float = 0.5  # x min quad edge length: duplicate-center radius



def _bilinear(gray: torch.Tensor, bi: torch.Tensor, x: torch.Tensor, y: torch.Tensor):
    """Bilinear samples of frames ``gray (B, H, W)`` at float coordinates,
    clamped to the frame; ``bi`` (broadcast
    against ``x``) is each sample's frame.  Returns ``x``'s dtype.

    XLA clamps an out-of-range gather index; torch would read out of bounds
    (a device assert on the card), so non-finite coordinates are replaced
    first: they only occur on slots that the validity masks drop."""
    B, H, W = gray.shape
    x = torch.clamp(torch.nan_to_num(x), 0.0, W - 1.001)
    y = torch.clamp(torch.nan_to_num(y), 0.0, H - 1.001)
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = x - x0
    fy = y - y0
    idx = bi * (H * W) + y0.long() * W + x0.long()
    flat = gray.reshape(-1)
    v00 = flat[idx].to(x.dtype)
    v01 = flat[idx + 1].to(x.dtype)
    v10 = flat[idx + W].to(x.dtype)
    v11 = flat[idx + W + 1].to(x.dtype)
    return v00 * (1 - fx) * (1 - fy) + v01 * fx * (1 - fy) + v10 * (1 - fx) * fy + v11 * fx * fy


def _dominant_direction(a, b, c):
    """Unit eigenvector of the largest eigenvalue of ``[[a, b], [b, c]]``
    (``eigh(...)[1][:, 1]`` up to sign), closed form; ``(0, 1)`` when the
    matrix is a multiple of the identity, as LAPACK returns."""
    lam = 0.5 * (a + c) + torch.sqrt(0.25 * (a - c) ** 2 + b * b)
    v1 = torch.stack([lam - c, b], dim=-1)
    v2 = torch.stack([b, lam - a], dim=-1)
    n1 = torch.linalg.vector_norm(v1, dim=-1)
    n2 = torch.linalg.vector_norm(v2, dim=-1)
    v = torch.where((n1 >= n2)[..., None], v1, v2)
    n = torch.maximum(n1, n2)
    fallback = torch.tensor([0.0, 1.0], dtype=a.dtype, device=a.device)
    return torch.where((n > 0)[..., None], v / torch.clamp_min(n, 1e-300)[..., None], fallback)


def _edge_probes(S: int, O: int, dt, dev):
    """The edge fit's sample positions along an edge (``S`` in [0.12,
    0.88]) and its probe offsets along the normal (``O`` in px)."""
    return (torch.linspace(0.12, 0.88, S, dtype=dt, device=dev),
            torch.linspace(-(O // 2), O // 2, O, dtype=dt, device=dev))


def _subpix_window(win: int, dt, dev):
    """cornerSubPix's window offsets ``(ox, oy)`` and Gaussian weights
    ``w``, each ``(2 win + 1, 2 win + 1)`` (row = y offset)."""
    dx = torch.arange(-win, win + 1, dtype=dt, device=dev)
    oy, ox = torch.meshgrid(dx, dx, indexing="ij")
    return ox, oy, torch.exp(-((ox / win) ** 2)) * torch.exp(-((oy / win) ** 2))


def _decode_positions(S: int, frac: float, dt, dev):
    """The ``S`` bit-sample positions across a cell, over its central
    ``frac``, in cell units."""
    return ((torch.arange(S, dtype=dt, device=dev) + 0.5) / S) * frac + (1.0 - frac) * 0.5


def refine_corners(gray, bi, quads, params: DetectorParams):
    """Subpixel corners by gradient-weighted edge line fits (AprilTag style,
    CORNER_REFINE_APRILTAG, cam.py:130): for each edge, probe the gradient
    along the normal at ``refine_samples`` points and ``refine_offsets``
    offsets, fit a weighted total-least-squares line through the per-sample
    centroids, intersect adjacent lines.  ``quads (N, 4, 2)``."""
    S = params.refine_samples
    ts, offs = _edge_probes(S, params.refine_offsets, quads.dtype, quads.device)
    a = quads
    b = torch.roll(quads, -1, dims=1)
    d = b - a  # (N, 4, 2)
    length = torch.linalg.vector_norm(d, dim=-1)
    n = torch.stack([-d[..., 1], d[..., 0]], dim=-1) / torch.clamp_min(length, 1e-6)[..., None]
    base = a[:, :, None, :] + ts[:, None] * d[:, :, None, :]  # (N, 4, S, 2)
    pts = base[:, :, :, None, :] + offs[:, None] * n[:, :, None, None, :]  # (N, 4, S, O, 2)
    step = 0.7
    nx, ny = n[:, :, None, None, 0], n[:, :, None, None, 1]
    bb = bi[:, None, None, None]
    gplus = _bilinear(gray, bb, pts[..., 0] + step * nx, pts[..., 1] + step * ny)
    gminus = _bilinear(gray, bb, pts[..., 0] - step * nx, pts[..., 1] - step * ny)
    w = torch.abs(gplus - gminus)  # (N, 4, S, O)
    wsum = torch.clamp_min(torch.sum(w, dim=-1, keepdim=True), 1e-6)
    centroid = torch.sum(w[..., None] * pts, dim=3) / wsum  # (N, 4, S, 2)
    sw = torch.sum(w, dim=-1)
    wn = sw / torch.clamp_min(torch.sum(sw, dim=-1, keepdim=True), 1e-6)
    mean = torch.sum(wn[..., None] * centroid, dim=2)  # (N, 4, 2)
    dc = centroid - mean[:, :, None, :]
    cov = torch.einsum("nes,nesi,nesj->neij", wn, dc, dc)
    direction = _dominant_direction(cov[..., 0, 0], cov[..., 0, 1], cov[..., 1, 1])
    normal = torch.stack([-direction[..., 1], direction[..., 0]], dim=-1)
    # fall back to the coarse edge when the gradients are washed out
    ok = (torch.sum(sw, dim=-1) > 1e-3 * S)[..., None]
    normal = torch.where(ok, normal, n)
    mean = torch.where(ok, mean, (a + b) * 0.5)

    # corner i = intersection of edge i-1 and edge i: solve (A + 1e-12 I) p = r
    n1, p1 = torch.roll(normal, 1, dims=1), torch.roll(mean, 1, dims=1)
    n2, p2 = normal, mean
    r1 = torch.sum(n1 * p1, dim=-1)
    r2 = torch.sum(n2 * p2, dim=-1)
    det = n1[..., 0] * n2[..., 1] - n1[..., 1] * n2[..., 0]
    a00, a01 = n1[..., 0] + 1e-12, n1[..., 1]
    a10, a11 = n2[..., 0], n2[..., 1] + 1e-12
    det_r = a00 * a11 - a01 * a10
    sol = torch.stack([(r1 * a11 - a01 * r2) / det_r, (a00 * r2 - a10 * r1) / det_r], dim=-1)
    refined = torch.where((torch.abs(det) > 1e-6)[..., None], sol, quads)
    # reject refinements that moved corners implausibly far
    dist = torch.linalg.vector_norm(refined - quads, dim=-1)
    return torch.where((dist < params.refine_clamp_px)[..., None], refined, quads)


def refine_corners_subpix(gray, bi, quads, params: DetectorParams):
    """cornerSubPix-style refinement (CORNER_REFINE_SUBPIX): iterate the
    gradient orthogonality normal equations ``(sum w g g^T) q = sum w g g^T
    p`` over a Gaussian-weighted window, each corner until its update falls
    under ``subpix_acc`` or ``subpix_iters`` trips.  One could stop
    each corner in a ``while_loop``; here all corners step together and a
    corner that has stopped is frozen, which gives the same result."""
    dt, dev = quads.dtype, quads.device
    ox, oy, w = _subpix_window(params.subpix_win, dt, dev)
    q0 = quads.reshape(-1, 2)
    bb = bi.repeat_interleave(4)[:, None, None]
    q = q0
    move = torch.full(q0.shape[:1], torch.inf, dtype=dt, device=dev)
    for _ in range(params.subpix_iters):
        active = move >= params.subpix_acc
        if not bool(active.any()):
            break
        px = q[:, 0, None, None] + ox
        py = q[:, 1, None, None] + oy
        gx = (_bilinear(gray, bb, px + 1.0, py) - _bilinear(gray, bb, px - 1.0, py)) * 0.5
        gy = (_bilinear(gray, bb, px, py + 1.0) - _bilinear(gray, bb, px, py - 1.0)) * 0.5
        gxx = torch.sum(w * gx * gx, dim=(1, 2))
        gxy = torch.sum(w * gx * gy, dim=(1, 2))
        gyy = torch.sum(w * gy * gy, dim=(1, 2))
        bx = torch.sum(w * (gx * gx * px + gx * gy * py), dim=(1, 2))
        by = torch.sum(w * (gx * gy * px + gy * gy * py), dim=(1, 2))
        det = gxx * gyy - gxy * gxy
        den = torch.where(det == 0, 1.0, det)
        qn = torch.stack([(gyy * bx - gxy * by) / den, (-gxy * bx + gxx * by) / den], dim=-1)
        qn = torch.where((torch.abs(det) > 1e-9)[:, None], qn, q)
        step = torch.linalg.vector_norm(qn - q, dim=-1)
        q = torch.where(active[:, None], qn, q)
        move = torch.where(active, step, move)
    keep = torch.linalg.vector_norm(q - q0, dim=-1) < params.refine_clamp_px
    return torch.where(keep[:, None], q, q0).reshape(quads.shape)


def refine_quad(gray, bi, quads, params: DetectorParams):
    """Corner refinement by ``params.corner_refine``: ``"apriltag"``,
    ``"subpix"`` or ``"none"`` (CORNER_REFINE_NONE: the raw quads)."""
    if params.corner_refine == "apriltag":
        return refine_corners(gray, bi, quads, params)
    if params.corner_refine == "subpix":
        return refine_corners_subpix(gray, bi, quads, params)
    if params.corner_refine == "none":
        return quads
    raise ValueError(f"unknown corner_refine kind: {params.corner_refine!r}")


def _otsu(values: torch.Tensor, bins: int = 64) -> torch.Tensor:
    """Otsu's threshold of each row of ``values (N, P)`` (fixed-bin histogram)."""
    lo = values.amin(dim=1, keepdim=True)
    hi = values.amax(dim=1, keepdim=True)
    span = torch.clamp_min(hi - lo, 1e-6)
    idx = torch.clamp(((values - lo) / span * bins).to(torch.int32), 0, bins - 1).long()
    hist = torch.zeros((values.shape[0], bins), dtype=values.dtype, device=values.device)
    hist.scatter_add_(1, idx, torch.ones_like(values))
    centers = lo + (torch.arange(bins, dtype=values.dtype, device=values.device) + 0.5) * (span / bins)
    w0 = torch.cumsum(hist, dim=1)
    s0 = torch.cumsum(hist * centers, dim=1)
    w1 = w0[:, -1:] - w0
    mu0 = s0 / torch.clamp_min(w0, 1e-6)
    mu1 = (s0[:, -1:] - s0) / torch.clamp_min(w1, 1e-6)
    k = torch.argmax(w0 * w1 * (mu0 - mu1) ** 2, dim=1, keepdim=True)
    return (lo + (k.to(values.dtype) + 1.0) * (span / bins))[:, 0]


def _popcount(v: torch.Tensor) -> torch.Tensor:
    """Set bits of non-negative int64 values below 2^63 (SWAR)."""
    v = v - ((v >> 1) & 0x5555555555555555)
    v = (v & 0x3333333333333333) + ((v >> 2) & 0x3333333333333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F0F0F0F0F
    v = v + (v >> 8)
    v = v + (v >> 16)
    v = v + (v >> 32)
    return v & 0x7F


def dictionary_codes(table: np.ndarray, device=None) -> torch.Tensor:
    """The rotation table ``(size, 4, n*n)`` uint8 (``marker_bits_table``)
    as one int64 word per (id, rotation), bit k = cell k in row-major
    order: ``(size * 4,)``."""
    L = table.shape[-1]
    weights = np.left_shift(np.int64(1), np.arange(L, dtype=np.int64))
    codes = (table.reshape(-1, L).astype(np.int64) * weights).sum(-1)
    return torch.as_tensor(codes, device=device)


def _quad_homography(quads, n_cells: int):
    """Homographies ``(N, 3, 3)`` from marker-cell coordinates (u, v) in
    [0, n_cells] to the image: cell (0, 0) is the outer border's top-left,
    and the quad corners sit at the grid's corners."""
    src = torch.tensor([[0.0, 0.0], [n_cells, 0.0], [n_cells, n_cells], [0.0, n_cells]],
                       dtype=quads.dtype, device=quads.device)
    return homography_4pt(src, quads)


def _decode_attempt(gray, bi, Hm, n_bits, params, frac):
    """One sampling pass of :func:`decode_quads` with bit samples over the
    central ``frac`` of each cell: ``(bits (N, c, c), means (N, c, c))``."""
    cells = n_bits + 2
    S = params.decode_samples
    dt, dev = Hm.dtype, Hm.device
    lin = _decode_positions(S, frac, dt, dev)
    ar = torch.arange(cells, dtype=dt, device=dev)
    # samples[n, r, c, s, t] sit at cell coords (u, v) = (c + lin[t], r + lin[s])
    u = (ar[None, :, None, None] + lin[None, None, None, :]).expand(cells, cells, S, S)
    v = (ar[:, None, None, None] + lin[None, None, :, None]).expand(cells, cells, S, S)
    H = Hm[:, :, :, None, None, None, None]
    pz = H[:, 2, 0] * u + H[:, 2, 1] * v + H[:, 2, 2]
    x = (H[:, 0, 0] * u + H[:, 0, 1] * v + H[:, 0, 2]) / pz
    y = (H[:, 1, 0] * u + H[:, 1, 1] * v + H[:, 1, 2]) / pz
    samples = _bilinear(gray, bi[:, None, None, None, None], x, y)  # (N, c, c, S, S)
    means = samples.mean(dim=(3, 4))
    # Otsu over all sampled intensities, then a per-cell majority
    tau = _otsu(samples.reshape(samples.shape[0], -1))
    above = (samples > tau[:, None, None, None, None]).sum(dim=(3, 4))
    return 2 * above > S * S, means


def _decode_bars(params: DetectorParams, n_bits: int) -> tuple[int, int]:
    """The decode's bars: the erroneous border bits tolerated and the
    Hamming budget of the dictionary match."""
    ec_bits = params.error_correction_bits if params.error_correction_bits is not None else 0
    return math.floor(params.max_border_err_rate * (4 * (n_bits + 2) - 4)), ec_bits


def _decode_pass(gray, bi, Hm, valid, codes, n_bits: int, params: DetectorParams, frac: float):
    """One pass of :func:`decode_quads` through homographies ``Hm (N, 3,
    3)``, its bit samples over the central ``frac`` of each cell, with its
    border, contrast and dictionary gates: ``(ids, rotations, ok)``."""
    cells = n_bits + 2
    dev = Hm.device
    max_border_errs, ec_bits = _decode_bars(params, n_bits)
    border = torch.ones((cells, cells), dtype=torch.bool, device=dev)
    border[1:-1, 1:-1] = False
    weights = torch.bitwise_left_shift(torch.ones((), dtype=torch.int64, device=dev),
                                       torch.arange(n_bits * n_bits, device=dev))
    bits, means = _decode_attempt(gray, bi, Hm, n_bits, params, frac)
    border_ok = (bits & border).sum(dim=(1, 2)) <= max_border_errs
    contrast_ok = (means.amax(dim=(1, 2)) - means.amin(dim=(1, 2))) > params.min_cell_contrast
    word = (bits[:, 1:-1, 1:-1].reshape(-1, n_bits * n_bits).long() * weights).sum(-1)
    dists = _popcount(word[:, None] ^ codes[None, :])  # (N, size * 4)
    best = torch.argmin(dists, dim=1)
    best_dist = torch.gather(dists, 1, best[:, None])[:, 0]
    ok = valid & border_ok & contrast_ok & (best_dist <= ec_bits)
    return best // 4, best % 4, ok


def decode_quads(gray, bi, quads, valid, codes, n_bits: int, params: DetectorParams):
    """Sample each quad's bit grid and match it against the dictionary
    (every quad at once; each quad
    samples its own frame ``bi``).

    ``codes``: :func:`dictionary_codes` of the rotation table.  A first
    pass samples whole cells; quads it rejects get a second pass over the
    central half of each cell.  Matching
    is by Hamming distance over packed words (XOR + popcount), the same
    distances as an elementwise compare.  Returns ``(ids,
    rotations, corners (N, 4, 2) rolled so index 0 is the canonical
    top-left, ok)``."""
    Hm = _quad_homography(quads, n_bits + 2)
    id1, rot1, ok1 = _decode_pass(gray, bi, Hm, valid, codes, n_bits, params, 1.0)
    id2, rot2, ok2 = _decode_pass(gray, bi, Hm, valid, codes, n_bits, params, 0.5)
    ids = torch.where(ok1, id1, id2)
    rots = torch.where(ok1, rot1, rot2)
    idx = (torch.arange(4, device=quads.device)[None, :] + rots[:, None]) % 4
    corners = torch.gather(quads, 1, idx[..., None].expand(-1, 4, 2))
    return ids, rots, corners, ok1 | ok2


class Detections(NamedTuple):
    corners: torch.Tensor  # (B, D, 4, 2) canonical order, subpixel
    ids: torch.Tensor  # (B, D) int64
    valid: torch.Tensor  # (B, D) bool
    score: torch.Tensor  # (B, D) quad area (larger = better)


def dedup_and_compact(corners, ids, ok, area, params: DetectorParams) -> Detections:
    """Cross-window duplicate suppression and compaction, per frame: a
    candidate is suppressed when a better (larger-area, then lower-index)
    valid candidate's center lies within ``dedup_radius_rate`` of the
    smaller quad edge; survivors fill ``max_detections`` slots best first
    (a stable sort, as ``jnp.argsort``).  Inputs ``(B, M, ...)``."""
    centers = corners.mean(dim=2)
    d2 = torch.sum((centers[:, :, None, :] - centers[:, None, :, :]) ** 2, dim=-1)
    edge = torch.sqrt(torch.clamp_min(area, 1.0))  # ~ quad edge length
    close = d2 < (params.dedup_radius_rate * torch.minimum(edge[:, :, None], edge[:, None, :])) ** 2
    M = area.shape[1]
    j_lt_i = torch.ones((M, M), dtype=torch.bool, device=area.device).tril(-1)
    better = (area[:, None, :] > area[:, :, None]) | (
        (area[:, None, :] == area[:, :, None]) & j_lt_i)
    suppressed = torch.any(close & better & ok[:, None, :], dim=2)
    keep = ok & ~suppressed
    key = torch.where(keep, -area, torch.inf)
    sel = torch.argsort(key, dim=1, stable=True)[:, : params.max_detections]
    return Detections(
        corners=torch.gather(corners, 1, sel[..., None, None].expand(-1, -1, 4, 2)),
        ids=torch.gather(ids, 1, sel),
        valid=torch.gather(keep, 1, sel),
        score=torch.gather(area, 1, sel),
    )


def detect(gray, quads, valid, areas, codes, n_bits: int, params: DetectorParams,
           dtype=torch.float64) -> Detections:
    """Candidates ``quads (B, Q, 4, 2)``, ``valid (B, Q)``, ``areas (B, Q)``
    over frames ``gray (B, H, W)`` -> :class:`Detections` ``(B, D)``: only
    the valid slots are refined and decoded, since the others can neither
    be kept nor suppress a kept one; the geometry in ``dtype``."""
    dev = gray.device
    B, Q = valid.shape
    q = torch.as_tensor(quads).to(dev, dtype).reshape(B * Q, 4, 2)
    area = torch.as_tensor(areas).to(dev)
    idx = torch.as_tensor(valid).to(dev).reshape(-1).nonzero()[:, 0]
    corners = torch.zeros_like(q)
    ids = torch.zeros(B * Q, dtype=torch.int64, device=dev)
    ok = torch.zeros(B * Q, dtype=torch.bool, device=dev)
    if idx.numel():  # a batch without candidates has nothing to sample
        bi = idx // Q
        refined = refine_quad(gray, bi, q[idx], params)
        ids_v, _, corners_v, ok_v = decode_quads(
            gray, bi, refined, torch.ones_like(idx, dtype=torch.bool), codes, n_bits, params)
        corners.index_copy_(0, idx, corners_v)
        ids.index_copy_(0, idx, ids_v)
        ok.index_copy_(0, idx, ok_v)
    return dedup_and_compact(corners.reshape(B, Q, 4, 2), ids.reshape(B, Q),
                             ok.reshape(B, Q), area, params)
