"""ArUco marker detection over frame batches on PyTorch.

The port of ``vican_tpu.ops.detect``.  The device mode runs the last three
stages on the candidates that the host extracted from the threshold masks
(``vican_tpu/perception.py:_build_hybrid``); the pure mode
(:func:`detect_markers`) runs them all on the device:

1. :func:`adaptive_threshold`   -- the mean-C threshold at every window
                                   size; on the card the CUDA kernel of
                                   :func:`vican_torch.ops.threshold.
                                   multi_threshold`, whose packed bits
                                   :func:`unpack_masks` spreads out;
2. :func:`connected_components` -- label propagation: neighbourhood min,
                                   row and column run minima, pointer jumps;
3. :func:`extract_quads`        -- the top components by (downsampled) area,
                                   farthest-point corners, validity gates;
                                   :func:`extract_split_quads` adds the
                                   4-connected split candidates and
                                   :func:`refit_degenerate_quads` re-fits
                                   collapsed quads on the component hull;
4. :func:`refine_quad`          -- subpixel corners: edge line fits
                                   (:func:`refine_corners`, AprilTag style) or
                                   the cornerSubPix iteration
                                   (:func:`refine_corners_subpix`);
5. :func:`decode_quads`         -- homography bit sampling, Otsu threshold,
                                   rotation-aware dictionary match;
6. :func:`dedup_and_compact`    -- cross-window duplicate suppression and
                                   compaction to ``max_detections`` slots.

The JAX functions take one image or one quad and are ``vmap``-ed; these take
a batch at once: label images ``(..., H, W)``, and quads ``(N, 4, 2)`` with
``bi (N,)``, the frame of each quad in a gray batch ``(B, H, W)``.  The
JAX package ``vmap``s a full-frame mask per candidate slot; here every
pixel finds its slot through one table lookup, and per-slot sums, maxima
and first-index argmaxes are segment reductions over the selected pixels.
Candidate extraction keeps JAX's float32 arithmetic, so its corners and
gates are JAX's; refine and decode compute quad geometry in float64 (the
JAX package's tests run them in float64 too, through x64 promotion); the
gray frames stay float32, whose values are exact integers.

Returned corners follow OpenCV's convention: top-left first, clockwise in
image coordinates.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from .. import _kernels
from .pnp import homography_4pt
from .threshold import adaptive_threshold

__all__ = [
    "BIG",
    "DetectorParams",
    "Detections",
    "QuadCandidates",
    "detector_params_from_jax",
    "resolve_error_correction",
    "preprocess",
    "adaptive_threshold",
    "unpack_masks",
    "connected_components",
    "extract_quads",
    "extract_split_quads",
    "refit_degenerate_quads",
    "device_candidates",
    "detect_candidates",
    "detect_candidates_plain",
    "detect_markers",
    "refine_corners",
    "refine_corners_subpix",
    "refine_quad",
    "decode_quads",
    "dictionary_codes",
    "dedup_and_compact",
]


class DetectorParams(NamedTuple):
    """Static detector configuration (mirrors cv.aruco.DetectorParameters),
    with the JAX package's field names and defaults (the reference's tuned
    values, cam.py:131-135).  The fields that only picked a TPU transport
    (``use_pallas_threshold``, ``roi_*``, ``mask_tile_rate``) are gone:
    :func:`detector_params_from_jax` drops them."""

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


# fields of vican_tpu.ops.detect.DetectorParams that only choose a TPU
# transport or kernel switch (ROADMAP "Deliberate omissions")
_DROPPED_FIELDS = frozenset({
    "use_pallas_threshold", "roi_matmul_sampling", "roi_tiers", "roi_margin",
    "mask_tile_rate",
})

# background label of the connected components (labels are pixel indices)
BIG = 2 ** 30


def detector_params_from_jax(fields: dict) -> DetectorParams:
    """The port's params from ``jax_params._asdict()``: TPU transport fields
    are dropped, every other field carries over; an unknown field raises."""
    unknown = set(fields) - set(DetectorParams._fields) - _DROPPED_FIELDS
    if unknown:
        raise ValueError(f"unknown detector parameters: {sorted(unknown)}")
    return DetectorParams(**{k: v for k, v in fields.items() if k in DetectorParams._fields})


def resolve_error_correction(params: DetectorParams, aruco: str) -> DetectorParams:
    """Fill in the auto Hamming budget ``floor(rate * (tau - 1) // 2)`` from
    the dictionary's minimum distance (0 for DICT_4X4_1000: strict)."""
    if params.error_correction_bits is not None:
        return params
    from .dictionary import max_correction_bits

    budget = int(params.error_correction_rate * max_correction_bits(aruco))
    return params._replace(error_correction_bits=budget)


def preprocess(im: torch.Tensor, brightness: float = 0.0, contrast: float = 0.0) -> torch.Tensor:
    """The reference's contrast/brightness transform and BGR->gray
    (cam.py:137-145) on uint8 ``(..., H, W, 3)`` or ``(..., H, W)``:
    float32 gray in [0, 255]."""
    x = im.to(torch.float32)
    if contrast != 0:
        x = x * (contrast / 127.0 + 1.0) - contrast
    x = torch.floor(torch.clamp(x + brightness, 0.0, 255.0))
    if x.dim() >= 3 and x.shape[-1] == 3:
        x = torch.floor(0.114 * x[..., 0] + 0.587 * x[..., 1] + 0.299 * x[..., 2] + 0.5)
    return x


def unpack_masks(packed: torch.Tensor, W: int) -> torch.Tensor:
    """Bit-packed masks ``(..., ceil(W/8))`` uint8, little-endian within a
    byte (:func:`vican_torch.ops.threshold.pack_bits`), back to bool
    ``(..., W)``, on the tensor's device."""
    shifts = torch.arange(8, dtype=torch.uint8, device=packed.device)
    bits = torch.bitwise_and(torch.bitwise_right_shift(packed[..., None], shifts), 1)
    return bits.reshape(*packed.shape[:-1], -1)[..., :W].bool()


def _neighbor_min(labels, fg, diagonal: bool = True):
    """Min of the 8- (or 4-) neighbourhood labels, masked to the foreground;
    ``labels (..., H, W)`` int32, borders padded with :data:`BIG`
    (``vican_tpu.ops.detect._neighbor_min``: the row minimum first, then
    the vertical neighbours of the row minimum, which brings in the
    diagonals, or of the labels for 4-connectivity)."""
    row = labels.clone()
    torch.minimum(row[..., 1:], labels[..., :-1], out=row[..., 1:])
    torch.minimum(row[..., :-1], labels[..., 1:], out=row[..., :-1])
    vert = row if diagonal else labels
    out = row.clone()
    torch.minimum(out[..., 1:, :], vert[..., :-1, :], out=out[..., 1:, :])
    torch.minimum(out[..., :-1, :], vert[..., 1:, :], out=out[..., :-1, :])
    return out.masked_fill_(~fg, BIG)


def _run_min_scan(labels, fg, axis: int):
    """Every pixel of a contiguous foreground run along ``axis`` gets the
    run's minimum label (``vican_tpu.ops.detect._run_min_scan``, JAX's
    segmented ``associative_scan`` forwards and backwards).

    A cumulative sum along each line numbers its segments, each foreground
    run one segment and every background pixel a segment of its own; a
    ``scatter_reduce`` ``amin`` over the segment numbers and a gather back
    give the same integers as JAX's scans, with no two background pixels
    contending for one slot."""
    axis = axis % labels.dim()
    n = fg.shape[axis]
    # a segment starts at every pixel but the foreground after foreground
    seg = torch.ones_like(fg)
    torch.logical_and(fg.narrow(axis, 1, n - 1), fg.narrow(axis, 0, n - 1),
                      out=seg.narrow(axis, 1, n - 1)).logical_not_()
    local = torch.cumsum(seg, dim=axis, dtype=torch.int32)  # 1..n within a line
    # a segment's number is its row-major index in the labels' shape with
    # ``n + 1`` places along the axis, ``local`` being its place there: the
    # numbers run in memory order, so the scatter and gather stay local
    shape = list(labels.shape)
    shape[axis] = n + 1
    base = torch.zeros((), dtype=torch.int64, device=labels.device)
    stride = 1
    for d in reversed(range(len(shape))):
        if d == axis:
            axis_stride = stride
        else:
            view = [1] * len(shape)
            view[d] = shape[d]
            base = base + torch.arange(shape[d], device=labels.device).view(view) * stride
        stride *= shape[d]
    if stride >= 1 << 31:
        local = local.long()
    ids = (local * axis_stride + base).view(-1)
    table = torch.full((stride,), BIG, dtype=labels.dtype, device=labels.device)
    table.scatter_reduce_(0, ids, labels.reshape(-1), "amin")
    return table.gather(0, ids).view(labels.shape)


def connected_components(fg, passes: int = 10, diagonal: bool = True):
    """8-connected (``diagonal``) or 4-connected component labels of
    foreground masks ``(..., H, W)`` bool: int32, the minimum linear pixel
    index of the component within its image, :data:`BIG` on the background
    (``vican_tpu.ops.detect.connected_components``).

    Each of ``passes`` passes runs, in JAX's order, the neighbourhood min,
    the row and the column run minima and two pointer jumps
    (``label <- label[label]``).  The labels equal JAX's after any number of
    passes, converged or not: an image that a pass leaves unchanged is
    converged, every later pass would leave it so, and it drops out of the
    passes that remain."""
    H, W = fg.shape[-2:]
    lead = fg.shape[:-2]
    fg = fg.reshape(-1, H, W)
    group = max(1, _chunk_pixels(fg.device) // (H * W))
    if fg.shape[0] > group:
        return torch.cat([connected_components(fg[s:s + group], passes, diagonal)
                          for s in range(0, fg.shape[0], group)]).view(*lead, H, W)
    lin = torch.arange(H * W, dtype=torch.int32, device=fg.device).view(H, W)
    labels = torch.where(fg, lin, BIG)

    def jump(labels, f):
        flat = labels.view(labels.shape[0], H * W)
        idx = torch.clamp(flat, 0, H * W - 1).long()
        return torch.minimum(labels, flat.gather(1, idx).view_as(labels)).masked_fill_(~f, BIG)

    active = torch.arange(fg.shape[0], device=fg.device)
    for _ in range(passes):
        whole = active.numel() == fg.shape[0]
        cur = labels if whole else labels[active]
        f = fg if whole else fg[active]
        new = _neighbor_min(cur, f, diagonal)
        new = _run_min_scan(new, f, -1)
        new = _run_min_scan(new, f, -2)
        new = jump(jump(new, f), f)
        changed = (new != cur).view(new.shape[0], -1).any(1)
        if whole:
            labels = new
        else:
            labels[active] = new
        active = active[changed]
        if active.numel() == 0:
            break
    return labels.view(*lead, H, W)


def _ds_areas(labels, HW: int):
    """Component areas ``(N, HW + 1)`` int64 estimated on the 2x-downsampled
    grid of ``labels (N, H, W)`` (4 per sampled pixel; the background's
    sentinel column ``HW`` stays 0)."""
    N = labels.shape[0]
    ds = labels[:, ::2, ::2].reshape(N, -1)
    n, p = (ds != BIG).nonzero(as_tuple=True)
    areas = torch.zeros(N * (HW + 1), dtype=torch.int64, device=labels.device)
    areas.index_add_(0, n * (HW + 1) + ds[n, p].long(), torch.ones_like(n))
    return areas.view(N, HW + 1) * 4


def _top_k(values, K: int):
    """The ``K`` largest of each row of non-negative integers ``values (N,
    L)``, equal values lowest index first (``lax.top_k``'s order; a
    composite key makes every key distinct, so ``torch.topk``'s order is
    that one).  Returns ``(indices int64, values)``."""
    L = values.shape[-1]
    idx = torch.arange(L, device=values.device)
    key = values.long() * L + (L - 1 - idx)
    top = torch.topk(key, K, dim=-1).values
    return L - 1 - top % L, top // L


def _top_k_labels(labels, K: int, H: int, W: int, max_area=None, min_area=None):
    """The ``K`` labels of the largest components of each image of
    ``labels (..., H, W)``, by the area on the 2x-downsampled grid
    (``vican_tpu.ops.detect._top_k_labels``): components whose estimate
    lies outside ``[0.25 min_area, 2 max_area]`` rank as area 0, ties go to
    the lowest label.  Returns ``(labels (..., K) int32, areas (..., K))``."""
    lead = labels.shape[:-2]
    areas = _ds_areas(labels.reshape(-1, H, W), H * W)
    if max_area is not None:
        areas = torch.where(areas > 2.0 * max_area, 0, areas)
    if min_area is not None:
        areas = torch.where(areas < 0.25 * min_area, 0, areas)
    top, vals = _top_k(areas, K)
    return top.to(torch.int32).view(*lead, K), vals.view(*lead, K)


class QuadCandidates(NamedTuple):
    corners: torch.Tensor  # (..., K, 4, 2) float32 (x, y)
    valid: torch.Tensor  # (..., K) bool
    area: torch.Tensor  # (..., K) float32 quad area (dedup score)
    label: torch.Tensor | None = None  # (..., K) int32 component label
    area_px: torch.Tensor | None = None  # (..., K) float32 component pixel area
    refit: torch.Tensor | None = None  # (..., K) bool gate-rejected degenerate


def _segment_first_argmax(v, seg, p, n_seg: int):
    """Per segment, the pixel index ``p`` of the first maximum of ``v``
    (``jnp.argmax`` over a masked full frame: the largest value, then the
    lowest linear index among the pixels that reach it); 0 for an empty
    segment, as ``argmax`` of an all-masked frame."""
    mx = torch.full((n_seg,), -torch.inf, dtype=v.dtype, device=v.device)
    mx.scatter_reduce_(0, seg, v, "amax")
    none = torch.iinfo(torch.int64).max
    first = torch.full((n_seg,), none, dtype=torch.int64, device=v.device)
    first.scatter_reduce_(0, seg, torch.where(v == mx[seg], p, none), "amin")
    return torch.where(first == none, 0, first)


def _quad_gates(quad, area_px, H: int, W: int, params):
    """Clockwise winding and the validity gates of ``extract_quads`` (and of
    the re-fit) in float32, JAX's arithmetic: ``quad (..., 4, 2)``,
    ``area_px (...)`` float32 component areas.  Returns ``(quad, gates ok,
    quad_area, edge_ok, convex)``."""
    x, y = quad[..., 0], quad[..., 1]
    shoelace = torch.sum(x * torch.roll(y, -1, -1) - torch.roll(x, -1, -1) * y, dim=-1)
    quad = torch.where((shoelace < 0)[..., None, None], quad[..., [0, 3, 2, 1], :], quad)
    edges = torch.roll(quad, -1, dims=-2) - quad
    edge_len = torch.sqrt(edges[..., 0] * edges[..., 0] + edges[..., 1] * edges[..., 1])
    quad_area = 0.5 * torch.abs(shoelace)
    m = params.border_margin
    inside = ((quad[..., 0] >= m) & (quad[..., 0] <= W - 1 - m)
              & (quad[..., 1] >= m) & (quad[..., 1] <= H - 1 - m)).all(-1)
    e_next = torch.roll(edges, -1, dims=-2)
    crosses = edges[..., 0] * e_next[..., 1] - edges[..., 1] * e_next[..., 0]
    convex = (crosses > 0).all(-1) | (crosses < 0).all(-1)
    fill = area_px / torch.clamp_min(quad_area, 1.0)
    min_hollow_side = 4.0 * max(params.win_sizes)
    perim = ((edge_len[..., 0] + edge_len[..., 1]) + edge_len[..., 2]) + edge_len[..., 3]
    outline = (area_px >= torch.clamp_min(perim, 1.0)) & (
        quad_area >= min_hollow_side * min_hollow_side)
    edge_ok = edge_len.amin(-1) >= 5.0
    ok = edge_ok & inside & convex & ((fill > 0.2) | outline)
    return quad, ok, quad_area, edge_ok, convex


def _slot_pixels(labels, top_labels):
    """The pixels of the top components: ``labels (N, HW)``, ``top_labels
    (N, K)`` distinct per row -> ``(seg, p)``, the slot ``n * K + k`` of
    every pixel whose label is a top label, and its index in the image.
    Each label finds its slot in one ``(N, HW + 1)`` table."""
    N, HW = labels.shape
    K = top_labels.shape[1]
    table = torch.full((N, HW + 1), -1, dtype=torch.int32, device=labels.device)
    slots = torch.arange(K, dtype=torch.int32, device=labels.device).expand(N, K)
    table.scatter_(1, top_labels.long(), slots)
    table[:, HW] = -1  # the background's sentinel is never a slot
    slot = table.gather(1, torch.clamp(labels.long(), max=HW))
    n, p = (slot >= 0).nonzero(as_tuple=True)
    return n * K + slot[n, p].long(), p


def extract_quads(labels, params: DetectorParams, top_labels=None,
                  parent_labels=None, k_slots=None) -> QuadCandidates:
    """Corner extraction for the top components of label images ``(..., H,
    W)`` (``vican_tpu.ops.detect.extract_quads``).

    Farthest-point geometry: p1 farthest from the centroid, p2 farthest from
    p1, p3/p4 the extremes of the signed distance to the line p1 -> p2,
    wound clockwise.  ``top_labels``/``parent_labels``/``k_slots`` serve the
    4-connected split pass (:func:`extract_split_quads`): explicit
    candidate labels, and the 8-connected labels whose component must be
    strictly larger than the candidate's.

    The centroid sums the integer coordinates exactly and rounds the sums to
    float32 before JAX's float32 division; JAX sums in float32, which is
    exact while a component's coordinate sum stays under 2^24 (a
    16k-pixel component at x ~ 1000), so past that the centroids may differ
    in the last bits (the farthest points only where that flips a tie)."""
    H, W = labels.shape[-2:]
    HW = H * W
    lead = labels.shape[:-2]
    flat = labels.reshape(-1, HW)
    N = flat.shape[0]
    K = k_slots if k_slots is not None else params.max_candidates
    max_area = params.max_area_rate * H * W
    if top_labels is None:
        top_labels, _ = _top_k_labels(flat.view(N, H, W), K, H, W, max_area=max_area,
                                      min_area=params.min_area)
    top_labels = top_labels.reshape(N, K)
    dev = labels.device
    seg, p = _slot_pixels(flat, top_labels)
    NK = N * K
    xs = (p % W).to(torch.float32)
    ys = (p // W).to(torch.float32)
    area = torch.bincount(seg, minlength=NK)
    sx = torch.zeros(NK, dtype=torch.int64, device=dev).index_add_(0, seg, p % W)
    sy = torch.zeros(NK, dtype=torch.int64, device=dev).index_add_(0, seg, p // W)
    areaf = torch.clamp_min(area.to(torch.float32), 1.0)
    cx = sx.to(torch.float32) / areaf
    cy = sy.to(torch.float32) / areaf

    def point(i):
        return torch.stack([(i % W).to(torch.float32), (i // W).to(torch.float32)], -1)

    def farthest(q):
        d2 = (xs - q[seg, 0]) ** 2 + (ys - q[seg, 1]) ** 2
        return point(_segment_first_argmax(d2, seg, p, NK))

    p1 = farthest(torch.stack([cx, cy], -1))
    p2 = farthest(p1)
    d = p2 - p1
    cross = (xs - p1[seg, 0]) * d[seg, 1] - (ys - p1[seg, 1]) * d[seg, 0]
    p3 = point(_segment_first_argmax(cross, seg, p, NK))
    p4 = point(_segment_first_argmax(-cross, seg, p, NK))
    quad = torch.stack([p1, p3, p2, p4], dim=1)  # cyclic order around the quad
    area_px = area.to(torch.float32)
    quad, gates, quad_area, edge_ok, convex = _quad_gates(quad, area_px, H, W, params)
    lab = top_labels.reshape(-1)
    emitted = (lab != BIG) & (area >= params.min_area) & (area <= max_area)
    if parent_labels is not None:
        # split gate: the 4-connected component must be a strict subset of
        # its 8-connected parent, the 8-label at the candidate's root pixel
        pflat = parent_labels.reshape(N, HW)
        par = pflat.gather(1, torch.clamp(top_labels.long(), 0, HW - 1))
        area8 = _label_counts(pflat, par)
        emitted = emitted & (area < area8.reshape(-1))
    valid = emitted & gates
    refit = emitted & ~valid & (~edge_ok | ~convex)
    shape = (*lead, K)
    return QuadCandidates(corners=quad.view(*shape, 4, 2), valid=valid.view(shape),
                          area=quad_area.view(shape), label=top_labels.view(shape),
                          area_px=area_px.view(shape), refit=refit.view(shape))


def _label_counts(labels, which):
    """Pixels of ``labels (N, HW)`` equal to each of ``which (N, J)``
    (``jnp.sum(labels == v)``; for :data:`BIG`, the background's count):
    int64 ``(N, J)``.  Only the pixels of the labels asked for are scattered."""
    N, HW = labels.shape
    marks = torch.zeros((N, HW + 1), dtype=torch.bool, device=labels.device)
    wanted = torch.where(which == BIG, HW, which.long())
    marks.scatter_(1, wanted, True)
    marks[:, HW] = False
    lab = torch.where(labels == BIG, HW, labels.long())
    n, p = marks.gather(1, lab).nonzero(as_tuple=True)
    counts = torch.zeros(N * (HW + 1), dtype=torch.int64, device=labels.device)
    counts.index_add_(0, n * (HW + 1) + lab[n, p], torch.ones_like(n))
    counts = counts.view(N, HW + 1)
    counts[:, HW] = (labels == BIG).sum(1)
    return counts.gather(1, wanted)


def extract_split_quads(labels8, labels4, params: DetectorParams) -> QuadCandidates:
    """The 4-connected split candidates (``vican_tpu.ops.detect.
    extract_split_quads``): 4-connected components whose downsampled area
    is below their 8-connected parent's rank by that area, and take the
    exact ``area4 < area8`` gate in :func:`extract_quads`."""
    H, W = labels4.shape[-2:]
    HW = H * W
    lead = labels4.shape[:-2]
    l8 = labels8.reshape(-1, H, W)
    l4 = labels4.reshape(-1, H, W)
    est4 = _ds_areas(l4, HW)
    est8 = _ds_areas(l8, HW)
    # the parent 8-label of each candidate 4-label (labels are pixel indices)
    par = l8.reshape(-1, HW)
    par_est = est8.gather(1, torch.where(par == BIG, HW, par.long()))
    e4 = est4[:, :HW]
    ranked = torch.where(
        (e4 > 0) & (e4 < par_est) & (e4 >= 0.25 * params.min_area)
        & (e4 <= 2.0 * params.max_area_rate * H * W), e4, 0)
    top4, _ = _top_k(ranked, params.max_candidates_4conn)
    return extract_quads(labels4, params, top_labels=top4.to(torch.int32).view(*lead, -1),
                         parent_labels=labels8, k_slots=params.max_candidates_4conn)


def _max_area_quads(px, py, pv):
    """The maximum-area quadrilateral over each point set ``(R, m)`` float32
    with validity ``pv`` (``refit_degenerate_quads``' scan): for every
    ordered pair (i, j) the farthest valid point on each side of the line
    i -> j; the first i, then the first j, of the largest area wins, and an
    all-invalid set leaves zeros.  Cross products of integer coordinates
    are exact in float32, so the areas are exact integers."""
    R, m = px.shape
    out = torch.zeros((R, 4, 2), dtype=px.dtype, device=px.device)
    idx = torch.arange(m, device=px.device)
    neg_inf = torch.tensor(-torch.inf, dtype=px.dtype, device=px.device)
    pos_inf = torch.tensor(torch.inf, dtype=px.dtype, device=px.device)
    rows = 64  # values of i per step: (rows, m, m) float32 products

    def per_i(r, i):
        dx = px[r][None, :] - px[r][i][:, None]  # (ni, m) over k and j alike
        dy = py[r][None, :] - py[r][i][:, None]
        cr = dx[:, :, None] * dy[:, None, :] - dy[:, :, None] * dx[:, None, :]  # (ni, k, j)
        up = torch.where(pv[r][None, :, None], cr, neg_inf)
        dn = torch.where(pv[r][None, :, None], cr, pos_inf)
        up_v, up_i = up.max(dim=1)
        dn_v, dn_i = dn.min(dim=1)
        jmask = pv[r][None, :] & (idx[None, :] != i[:, None]) & pv[r][i][:, None]
        areas = torch.where(jmask, torch.abs(up_v) + torch.abs(dn_v), -1.0)
        a, j = areas.max(dim=1)
        return a, j, up_i.gather(1, j[:, None])[:, 0], dn_i.gather(1, j[:, None])[:, 0]

    for r in range(R):
        parts = [per_i(r, idx[s:s + rows]) for s in range(0, m, rows)]
        a, j, u, d = (torch.cat(t) for t in zip(*parts))
        i = int(torch.argmax(a))
        if not bool(a[i] > -1.0):
            continue
        pts = torch.stack([px[r], py[r]], -1)
        out[r] = pts[torch.stack([idx[i], u[i], j[i], d[i]])]
    return out


def refit_degenerate_quads(cand: QuadCandidates, labels8, labels4, params: DetectorParams):
    """Re-fit collapsed quads on the component hull
    (``vican_tpu.ops.detect.refit_degenerate_quads``, the device mirror of
    the host re-fit).

    ``cand``: the merged per-window candidates ``(..., Wn, Ks)``, split slots
    at index >= ``max_candidates``; ``labels8``/``labels4`` ``(..., Wn, H,
    W)``.  Per image, the ``max_refit_candidates`` largest gate-rejected
    degenerate candidates are re-fit by the maximum-area quadrilateral over
    ``2 refit_rows`` points, the x-extremes of rows subsampled across the
    component's bounding box (exact while the box is at most ``refit_rows``
    tall), and re-gated.  Only selected slots with a positive area are
    computed: the others cannot change, as in JAX."""
    Wn, Ks = cand.valid.shape[-2:]
    H, W = labels8.shape[-2:]
    K = params.max_candidates
    R = params.max_refit_candidates
    M = params.refit_rows
    lead = cand.valid.shape[:-2]
    Bf = cand.valid[..., 0, 0].numel()
    dev = cand.valid.device
    score = torch.where(cand.refit, cand.area_px, -1.0).reshape(Bf, Wn * Ks)
    sel = torch.sort(score, dim=1, descending=True, stable=True).indices[:, :R]
    ok = score.gather(1, sel) > 0.0
    f, r = ok.nonzero(as_tuple=True)
    if f.numel() == 0:
        return cand
    corners = cand.corners.reshape(Bf, Wn * Ks, 4, 2).clone()
    valid = cand.valid.reshape(Bf, Wn * Ks).clone()
    area = cand.area.reshape(Bf, Wn * Ks).clone()
    slot = sel[f, r]
    wi = slot // Ks
    conn4 = (slot % Ks) >= K
    l8 = labels8.reshape(Bf, Wn, H, W)
    l4 = labels4.reshape(Bf, Wn, H, W)
    limg = torch.where(conn4[:, None, None], l4[f, wi], l8[f, wi])  # (n, H, W)
    mask = limg == cand.label.reshape(Bf, Wn * Ks)[f, slot][:, None, None]
    xs_w = torch.arange(W, device=dev)
    ys_h = torch.arange(H, device=dev)
    # per-row x-extremes of the component and its bounding-box rows
    xmin = torch.where(mask, xs_w, W).amin(-1)
    xmax = torch.where(mask, xs_w, -1).amax(-1)
    rowv = mask.any(-1)
    y0 = torch.where(rowv, ys_h, H).amin(-1)
    y1 = torch.where(rowv, ys_h, -1).amax(-1)
    h = torch.clamp_min(y1 - y0, 0)
    ri = torch.clamp(y0[:, None] + (torch.arange(M, device=dev) * h[:, None]) // max(M - 1, 1),
                     0, H - 1)
    px = torch.cat([xmin.gather(1, ri), xmax.gather(1, ri)], 1).to(torch.float32)
    py = torch.cat([ri, ri], 1).to(torch.float32)
    pv = torch.cat([rowv.gather(1, ri), rowv.gather(1, ri)], 1)
    quads = _max_area_quads(px, py, pv)
    area_px = cand.area_px.reshape(Bf, Wn * Ks)[f, slot]
    quads, ok_new, qarea, _, _ = _quad_gates(quads, area_px, H, W, params)
    corners[f, slot] = torch.where(ok_new[:, None, None], quads, corners[f, slot])
    area[f, slot] = torch.where(ok_new, qarea, area[f, slot])
    valid[f, slot] = valid[f, slot] | ok_new
    return cand._replace(corners=corners.view(*lead, Wn, Ks, 4, 2),
                         valid=valid.view(*lead, Wn, Ks), area=area.view(*lead, Wn, Ks))


def _chunk_pixels(device) -> int:
    """Label pixels worked on at once.  On the card 2^26: the int64
    temporaries (~6 alive) stay near 3 GB and 10 frames of 7 windows at
    1280x720 fit.  On the CPU 2^20, one 720p window: its temporaries (int64
    ones of 8 MB) stay under glibc's largest mmap threshold, so they are
    reused from the heap instead of mapped and faulted in anew per op."""
    return 1 << 20 if device.type == "cpu" else 1 << 26


def device_candidates(fg, params: DetectorParams):
    """Quad candidates of threshold masks ``fg (B, Wn, H, W)`` bool, on
    their device: the 8-connected components and their top ``max_candidates``
    quads per window, then (``max_candidates_4conn > 0``) the 4-connected
    split candidates, then the degenerate re-fit, as
    ``vican_tpu.ops.detect.detect_markers`` orders them (per window, the 8-
    then the 4-connected slots).  Frames are worked on in chunks of
    :func:`_chunk_pixels`.  Returns ``(quads (B, Wn * Ks, 4, 2) float32,
    valid (B, Wn * Ks), quad areas (B, Wn * Ks) float32)``."""
    B, Wn, H, W = fg.shape
    K2 = params.max_candidates_4conn
    step = max(1, _chunk_pixels(fg.device) // (Wn * H * W))
    outs = []
    for s in range(0, B, step):
        f = fg[s:s + step]
        labels = connected_components(f, params.ccl_passes)
        cand = extract_quads(labels, params)
        labels4 = labels
        if K2 > 0:
            labels4 = connected_components(f, params.ccl_passes, diagonal=False)
            cand4 = extract_split_quads(labels, labels4, params)
            cand = QuadCandidates(*(torch.cat([a, b], dim=2) for a, b in zip(cand, cand4)))
        if params.max_refit_candidates > 0:
            cand = refit_degenerate_quads(cand, labels, labels4, params)
        n = cand.valid.shape[0]
        outs.append((cand.corners.reshape(n, -1, 4, 2), cand.valid.reshape(n, -1),
                     cand.area.reshape(n, -1)))
        del labels, labels4, cand
    return tuple(torch.cat(t) for t in zip(*outs))


def _bilinear(gray: torch.Tensor, bi: torch.Tensor, x: torch.Tensor, y: torch.Tensor):
    """Bilinear samples of frames ``gray (B, H, W)`` at float coordinates,
    clamped like ``vican_tpu.ops.detect._bilinear``; ``bi`` (broadcast
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
    under ``subpix_acc`` or ``subpix_iters`` trips.  The JAX package stops
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
    (``vican_tpu.ops.detect.decode_one`` for every quad at once; each quad
    samples its own frame ``bi``).

    ``codes``: :func:`dictionary_codes` of the rotation table.  A first
    pass samples whole cells; quads it rejects get a second pass over the
    central half of each cell (vican_tpu/ops/detect.py:951-962).  Matching
    is by Hamming distance over packed words (XOR + popcount), the same
    distances as the JAX package's elementwise compare.  Returns ``(ids,
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


def detect_candidates_plain(gray, quads, valid, areas, codes, n_bits: int,
                            params: DetectorParams) -> Detections:
    """The plain version of :func:`detect_candidates`, op by op: only the
    valid slots are refined and decoded (a ``nonzero`` picks them, a host
    sync on the card), since the others can neither be kept nor suppress a
    kept one.  ``gray`` may be uint8 or float32: its values are cast to
    the coordinates' float64 either way."""
    dev = gray.device
    B, Q = valid.shape
    q = torch.as_tensor(quads).to(dev, torch.float64).reshape(B * Q, 4, 2)
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


# detect.cu's refine codes
REFINE_KINDS = {"none": 0, "apriltag": 1, "subpix": 2}
_tables: dict = {}


def detect_tables(params: DetectorParams, device) -> torch.Tensor:
    """detect.cu's float64 tables on ``device``, made by the plain
    version's own expressions there (so both read the same values): the
    edge fit's sample positions and probe offsets, the cornerSubPix
    weights (row-major), then the decode's sample positions over whole
    cells and over their central half.  Made once a device and shape."""
    key = (params.refine_samples, params.refine_offsets, params.subpix_win,
           params.decode_samples, torch.device(device))
    tab = _tables.get(key)
    if tab is None:
        dt = torch.float64
        ts, offs = _edge_probes(params.refine_samples, params.refine_offsets, dt, device)
        w = _subpix_window(params.subpix_win, dt, device)[2]
        S = params.decode_samples
        tab = torch.cat([ts, offs, w.reshape(-1), _decode_positions(S, 1.0, dt, device),
                         _decode_positions(S, 0.5, dt, device)])
        _tables[key] = tab
    return tab


def detect_scalars(params: DetectorParams, n_bits: int, B: int, H: int, W: int, Q: int,
                   ncodes: int) -> list:
    """The C entry ``detect_candidates_f64``'s arguments after its pointers,
    in its order: the sizes and counts, then the float64 bars and the
    float32 dedup rate (as Python floats: ``_kernels.SOURCES`` names their
    C types)."""
    return [B, H, W, Q, min(params.max_detections, Q), REFINE_KINDS[params.corner_refine],
            params.refine_samples, params.refine_offsets, params.subpix_win,
            params.subpix_iters, n_bits, params.decode_samples, *_decode_bars(params, n_bits),
            ncodes, float(params.subpix_acc), float(params.refine_clamp_px),
            float(params.min_cell_contrast), float(params.dedup_radius_rate)]


def _detect_inputs(gray, quads, valid, areas, codes, params: DetectorParams):
    """:func:`detect_candidates`' inputs on ``gray``'s device, checked:
    numpy arrays are moved there, a tensor on another device raises, as
    does a dtype or shape the kernel does not take."""
    if not isinstance(gray, torch.Tensor) or gray.dim() != 3 or gray.dtype != torch.uint8:
        raise ValueError("detect_candidates: gray must be a (B, H, W) uint8 tensor")
    dev = gray.device
    B = gray.shape[0]
    args = {"quads": quads, "valid": valid, "areas": areas, "codes": codes}
    for name, x in args.items():
        if isinstance(x, torch.Tensor):
            if x.device != dev:
                raise ValueError(f"detect_candidates: {name} is on {x.device}, gray on {dev}")
        else:
            args[name] = torch.as_tensor(np.asarray(x), device=dev)
    Q = args["valid"].shape[-1] if args["valid"].dim() == 2 else -1
    want = {"quads": (torch.float32, (B, Q, 4, 2)), "valid": (torch.bool, (B, Q)),
            "areas": (torch.float32, (B, Q)), "codes": (torch.int64, (args["codes"].numel(),))}
    for name, (dtype, shape) in want.items():
        x = args[name]
        if x.dtype != dtype or tuple(x.shape) != shape:
            raise ValueError(f"detect_candidates: {name} must be a {dtype} {shape} tensor, "
                             f"got {x.dtype} {tuple(x.shape)}")
    if params.corner_refine not in REFINE_KINDS:
        raise ValueError(f"unknown corner_refine kind: {params.corner_refine!r}")
    return args["quads"], args["valid"], args["areas"], args["codes"]


def detect_candidates(gray, quads, valid, areas, codes, n_bits: int,
                      params: DetectorParams) -> Detections:
    """Refine, decode and deduplicate quad candidates over their frames:
    ``gray (B, H, W)`` uint8 on the device, ``quads (B, Q, 4, 2)``
    float32, ``valid (B, Q)`` bool and ``areas (B, Q)`` float32 (the dedup
    score), each a tensor on ``gray``'s device or a numpy array (moved
    there); ``codes``: :func:`dictionary_codes`.  Returns
    :class:`Detections` ``(B, D)`` with ``D = min(max_detections, Q)``.

    CPU tensors take :func:`detect_candidates_plain`.  CUDA tensors launch
    the kernels of ``vican_torch/csrc/detect.cu`` (a warp a candidate
    slot: refine, by ``params.corner_refine``, and decode in float64; a
    block a frame, a warp a slot: dedup and compaction), no host sync, or
    raise (the C entry refuses sizes past the card's shared memory); each
    launch adds one to ``detect_candidates.launches``.
    """
    quads, valid, areas, codes = _detect_inputs(gray, quads, valid, areas, codes, params)
    if not gray.is_cuda:
        return detect_candidates_plain(gray, quads, valid, areas, codes, n_bits, params)
    B, H, W = gray.shape
    Q = valid.shape[1]
    D = min(params.max_detections, Q)
    dev = gray.device
    corners = torch.empty((B, D, 4, 2), dtype=torch.float64, device=dev)
    ids = torch.empty((B, D), dtype=torch.int64, device=dev)
    keep = torch.empty((B, D), dtype=torch.bool, device=dev)
    score = torch.empty((B, D), dtype=torch.float32, device=dev)
    if B * Q:
        # each slot's refined, rolled corners, id and decode verdict
        slot_corners = torch.empty((B * Q, 4, 2), dtype=torch.float64, device=dev)
        slot_ids = torch.empty(B * Q, dtype=torch.int64, device=dev)
        slot_ok = torch.empty(B * Q, dtype=torch.bool, device=dev)
        _kernels.launch(
            "detect", "detect_candidates_f64", gray.contiguous(), quads.contiguous(),
            valid.contiguous(),
            areas.contiguous(), codes.contiguous(), detect_tables(params, dev), slot_corners,
            slot_ids, slot_ok, corners, ids, keep, score,
            *detect_scalars(params, n_bits, B, H, W, Q, codes.numel()))
        detect_candidates.launches += 1
    return Detections(corners, ids, keep, score)


detect_candidates.launches = 0


def detect_markers(gray, table, n_bits: int, params: DetectorParams, device=None) -> Detections:
    """The whole detection on the device (``vican_tpu.ops.detect.
    detect_markers``, the pure mode): the threshold at every window, the 8-
    and 4-connected components, the candidates and their re-fit, refine,
    decode and dedup.

    ``gray``: preprocessed grey levels ``(H, W)`` or ``(B, H, W)`` (integer
    values in [0, 255], float or uint8; a numpy array or a tensor);
    ``table``: the rotation table ``(size, 4, n*n)`` of
    ``dictionary.marker_bits_table``.  On
    the card the threshold is the ``multi_threshold`` kernel, whose masks
    equal :func:`adaptive_threshold`'s.  ``device=None`` is the CUDA card.
    Returns :class:`Detections` with ``max_detections`` slots (a leading
    batch axis for a batch)."""
    from ..utils import resolve_device
    from .threshold import multi_threshold

    device = resolve_device(device)
    g = torch.as_tensor(gray).to(device)
    single = g.dim() == 2
    g8 = g.reshape(-1, *g.shape[-2:]).to(torch.uint8).contiguous()
    codes = dictionary_codes(np.asarray(table), device)
    fg = unpack_masks(multi_threshold(g8, params.win_sizes, params.thresh_const), g8.shape[-1])
    quads, valid, area = device_candidates(fg, params)
    det = detect_candidates(g8, quads, valid, area, codes, n_bits, params)
    return Detections(*(x[0] for x in det)) if single else det
