"""Camera model and planar-square PnP over batches of markers.

The port of ``vican_tpu.ops.pnp``.  The JAX functions take one marker and
are ``vmap``-ed; these take a leading batch axis ``N`` and run it at once:

- :func:`project_points`   <- cv.projectPoints (12-coefficient rational +
                              thin-prism model, reference cam.py:31-32)
- :func:`undistort_points` <- cv.undistortPoints (fixed-point iteration)
- :func:`homography_4pt`   <- the 4-point DLT
- :func:`ippe_square`      <- cv.solvePnP(SOLVEPNP_IPPE_SQUARE)
- :func:`iterative_planar` <- cv.solvePnP(SOLVEPNP_ITERATIVE), planar case
- :func:`refine_lm`        <- cv.solvePnPRefineLM (forward-mode Jacobian)
- :func:`reprojection_error_max` <- max per-corner L2 (cam.py:176-179)
- :func:`pnp_block`        <- perception's PnP block (vican_tpu/perception.py:
                              883 ``_pnp_block``): every detection slot of a
                              batch to one packed ``(B*D, 23)`` result; on
                              the card one CUDA kernel (``csrc/pnp.cu``)

Shapes: corners ``(N, 4, 2)``, ``K (N, 3, 3)``, ``dist (N, 14)`` (zero-padded
distortion, taux/tauy not modeled).  Degenerate inputs (the all-zero quads
of empty detection slots) give non-finite results, never an exception:
every small solve goes through ``torch.linalg.solve_ex``.
"""
from __future__ import annotations

import torch

from .. import _kernels
from .lie import hat, project_so3, rodrigues, so3_log

__all__ = [
    "marker_object_points",
    "pad_distortion",
    "project_points",
    "undistort_points",
    "homography_4pt",
    "ippe_square",
    "iterative_planar",
    "refine_lm",
    "reprojection_error_max",
    "solve_marker_pose",
    "pnp_block",
    "pnp_block_plain",
]

PNP_METHODS = {"ippe_square": 0, "iterative": 1}  # pnp.cu's method codes


def marker_object_points(marker_size, dtype=torch.float64, device=None) -> torch.Tensor:
    """Square marker corners in the marker frame, TL, TR, BR, BL
    (cam.py:149-153): ``(4, 3)``."""
    pts = torch.tensor([[-1, 1, 0], [1, 1, 0], [1, -1, 0], [-1, -1, 0]],
                       dtype=dtype, device=device)
    return pts * (marker_size * 0.5)


def pad_distortion(dist) -> torch.Tensor:
    """Zero-pad a distortion vector (``(..., k)``, k <= 14) to 14 coefficients."""
    dist = torch.atleast_1d(torch.as_tensor(dist))[..., :14]
    return torch.nn.functional.pad(dist, (0, 14 - dist.shape[-1]))


def _coeffs(dist):
    """The 12 modeled coefficients of ``dist (N, 14)``, each ``(N, 1)``."""
    return [dist[:, i:i + 1] for i in range(12)]


def _distort(xy, dist):
    """The OpenCV distortion model on ideal normalized coords ``(N, P, 2)``."""
    k1, k2, p1, p2, k3, k4, k5, k6, s1, s2, s3, s4 = _coeffs(dist)
    x, y = xy[..., 0], xy[..., 1]
    r2 = x * x + y * y
    r4 = r2 * r2
    r6 = r4 * r2
    radial = (1.0 + k1 * r2 + k2 * r4 + k3 * r6) / (1.0 + k4 * r2 + k5 * r4 + k6 * r6)
    xd = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x) + s1 * r2 + s2 * r4
    yd = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y + s3 * r2 + s4 * r4
    return torch.stack([xd, yd], dim=-1)


def project_points(pts, R, t, K, dist):
    """Project points ``(N, P, 3)`` (or ``(P, 3)``, shared) through poses
    ``R (N, 3, 3)``, ``t (N, 3)`` and cameras ``K (N, 3, 3)``,
    ``dist (N, 14)``: pixel coordinates ``(N, P, 2)``."""
    pc = torch.einsum("nij,pj->npi" if pts.dim() == 2 else "nij,npj->npi", R, pts)
    pc = pc + t[:, None, :]
    xy = pc[..., :2] / pc[..., 2:3]
    xyd = _distort(xy, dist)
    fx, fy = K[:, 0, 0, None], K[:, 1, 1, None]
    cx, cy = K[:, 0, 2, None], K[:, 1, 2, None]
    return torch.stack([fx * xyd[..., 0] + cx, fy * xyd[..., 1] + cy], dim=-1)


def undistort_points(pts_px, K, dist, iters: int = 8):
    """Pixel coords ``(N, P, 2)`` -> ideal normalized coords
    (cv.undistortPoints): ``iters`` fixed-point steps from the distorted
    normalized coords."""
    fx, fy = K[:, 0, 0, None], K[:, 1, 1, None]
    cx, cy = K[:, 0, 2, None], K[:, 1, 2, None]
    tx = (pts_px[..., 0] - cx) / fx
    ty = (pts_px[..., 1] - cy) / fy
    k1, k2, p1, p2, k3, k4, k5, k6, s1, s2, s3, s4 = _coeffs(dist)
    x, y = tx, ty
    for _ in range(iters):
        r2 = x * x + y * y
        r4 = r2 * r2
        r6 = r4 * r2
        radial = (1.0 + k1 * r2 + k2 * r4 + k3 * r6) / (1.0 + k4 * r2 + k5 * r4 + k6 * r6)
        dx = 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x) + s1 * r2 + s2 * r4
        dy = p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y + s3 * r2 + s4 * r4
        x, y = (tx - dx) / radial, (ty - dy) / radial
    return torch.stack([x, y], dim=-1)


def _solve(A, b):
    """Batched ``A x = b`` that never raises: singular systems give
    non-finite or garbage rows, which the callers' validity masks drop."""
    return torch.linalg.solve_ex(A, b[..., None])[0][..., 0]


def homography_4pt(src, dst):
    """Homographies mapping 4 source points to 4 destination points (DLT,
    ``H[2, 2] = 1``).  ``src`` ``(4, 2)`` or ``(N, 4, 2)``, ``dst``
    ``(N, 4, 2)``; returns ``(N, 3, 3)``."""
    src = src.expand(dst.shape[0], 4, 2) if src.dim() == 2 else src
    x, y = src[..., 0], src[..., 1]
    u, v = dst[..., 0], dst[..., 1]
    one, zero = torch.ones_like(x), torch.zeros_like(x)
    r1 = torch.stack([x, y, one, zero, zero, zero, -u * x, -u * y], dim=-1)
    r2 = torch.stack([zero, zero, zero, x, y, one, -v * x, -v * y], dim=-1)
    A = torch.stack([r1, r2], dim=-2).reshape(-1, 8, 8)
    b = torch.stack([u, v], dim=-1).reshape(-1, 8)
    h = _solve(A, b)
    return torch.cat([h, torch.ones_like(h[:, :1])], dim=1).reshape(-1, 3, 3)


def _rotate_vec_to_z(v):
    """Rotations ``Rv`` with ``Rv @ unit(v) = (0, 0, 1)``: ``(N, 3)`` -> ``(N, 3, 3)``."""
    n = v / torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    ax = torch.stack([n[:, 1], -n[:, 0], torch.zeros_like(n[:, 0])], dim=-1)
    s = torch.linalg.vector_norm(ax, dim=-1)
    c = n[:, 2]
    ok = s > 1e-12
    ex = torch.tensor([1.0, 0.0, 0.0], dtype=v.dtype, device=v.device)
    safe = torch.where(ok[:, None], ax / torch.clamp_min(s, 1e-12)[:, None], ex)
    Kx = hat(safe)
    eye = torch.eye(3, dtype=v.dtype, device=v.device)
    R = eye + s[:, None, None] * Kx + (1.0 - c)[:, None, None] * (Kx @ Kx)
    return torch.where(ok[:, None, None], R, eye)


def _translation_lsq(R, obj, xy):
    """Best translation for each rotation: linear least squares on the
    projection equations ``(Rq + t)_x - x (Rq + t)_z = 0`` (and y)."""
    Rq = torch.einsum("nij,pj->npi", R, obj)  # (N, 4, 3)
    x, y = xy[..., 0], xy[..., 1]
    one, zero = torch.ones_like(x), torch.zeros_like(x)
    A = torch.cat([torch.stack([one, zero, -x], dim=-1),
                   torch.stack([zero, one, -y], dim=-1)], dim=1)  # (N, 8, 3)
    b = torch.cat([x * Rq[..., 2] - Rq[..., 0], y * Rq[..., 2] - Rq[..., 1]], dim=1)
    At = A.transpose(1, 2)
    return _solve(At @ A, (At @ b[..., None])[..., 0])


def ippe_square(corners_px, K, dist, marker_size):
    """Closed-form planar pose of square markers (IPPE, Collins & Bartoli
    2014, as ``cv.solvePnP(SOLVEPNP_IPPE_SQUARE)``, cam.py:161-165): both
    candidate rotations, their least-squares translations, the one with the
    smaller reprojection error.  Returns ``(R, t, err2)``, ``err2`` the sum
    of squared residuals in normalized coordinates."""
    dt, dev = corners_px.dtype, corners_px.device
    obj = marker_object_points(marker_size, dt, dev)
    xy = undistort_points(corners_px, K, dist)
    H = homography_4pt(obj[:, :2], xy)
    v = H[:, :2, 2]  # the image of the model origin (H22 = 1)
    J = torch.stack([
        torch.stack([H[:, 0, 0] - v[:, 0] * H[:, 2, 0], H[:, 0, 1] - v[:, 0] * H[:, 2, 1]], -1),
        torch.stack([H[:, 1, 0] - v[:, 1] * H[:, 2, 0], H[:, 1, 1] - v[:, 1] * H[:, 2, 1]], -1),
    ], dim=-2)
    Rv = _rotate_vec_to_z(torch.cat([v, torch.ones_like(v[:, :1])], dim=1))
    Bm = torch.stack([
        torch.stack([Rv[:, 0, 0] - v[:, 0] * Rv[:, 0, 2], Rv[:, 1, 0] - v[:, 0] * Rv[:, 1, 2]], -1),
        torch.stack([Rv[:, 0, 1] - v[:, 1] * Rv[:, 0, 2], Rv[:, 1, 1] - v[:, 1] * Rv[:, 1, 2]], -1),
    ], dim=-2)
    A = torch.linalg.solve_ex(Bm, J)[0]
    # the largest singular value of A
    ata = A.transpose(1, 2) @ A
    tr = ata[:, 0, 0] + ata[:, 1, 1]
    gap = torch.sqrt(torch.clamp_min((ata[:, 0, 0] - ata[:, 1, 1]) ** 2 + 4.0 * ata[:, 0, 1] ** 2, 0.0))
    gamma = torch.sqrt(torch.clamp_min(0.5 * (tr + gap), 1e-30))
    P = A / gamma[:, None, None]
    b0 = torch.sqrt(torch.clamp_min(1.0 - P[:, 0, 0] ** 2 - P[:, 1, 0] ** 2, 0.0))
    b1 = torch.sqrt(torch.clamp_min(1.0 - P[:, 0, 1] ** 2 - P[:, 1, 1] ** 2, 0.0))
    sp = -(P[:, 0, 0] * P[:, 0, 1] + P[:, 1, 0] * P[:, 1, 1])
    b1 = torch.where(sp < 0, -b1, b1)

    def solution(sign):
        c1 = torch.stack([P[:, 0, 0], P[:, 1, 0], sign * b0], dim=-1)
        c2 = torch.stack([P[:, 0, 1], P[:, 1, 1], sign * b1], dim=-1)
        Rc = torch.stack([c1, c2, torch.linalg.cross(c1, c2)], dim=-1)
        R = Rv.transpose(1, 2) @ Rc
        t = _translation_lsq(R, obj, xy)
        pc = torch.einsum("nij,pj->npi", R, obj) + t[:, None, :]
        err2 = torch.sum((pc[..., :2] / pc[..., 2:3] - xy) ** 2, dim=(1, 2))
        # a solution with the marker behind the camera is invalid
        err2 = torch.where(pc[..., 2].amin(dim=1) <= 0, torch.inf, err2)
        return R, t, err2

    R1, t1, e1 = solution(1.0)
    R2, t2, e2 = solution(-1.0)
    pick1 = e1 <= e2
    return (torch.where(pick1[:, None, None], R1, R2), torch.where(pick1[:, None], t1, t2),
            torch.where(pick1, e1, e2))


def iterative_planar(corners_px, K, dist, marker_size, lm_iters: int = 20):
    """``cv.solvePnP(SOLVEPNP_ITERATIVE)`` for the planar square: the
    homography initialization of cvFindExtrinsicCameraParams2 (``R ~ [h1/s,
    h2/s, h1 x h2 / s^2]`` projected onto SO(3), ``t = h3/s``,
    ``s = sqrt(|h1||h2|)``), then Levenberg-Marquardt.  Returns
    ``(R, t, err2)`` as :func:`ippe_square`."""
    dt, dev = corners_px.dtype, corners_px.device
    obj = marker_object_points(marker_size, dt, dev)
    xy = undistort_points(corners_px, K, dist)
    H = homography_4pt(obj[:, :2], xy)
    h1, h2, h3 = H[:, :, 0], H[:, :, 1], H[:, :, 2]
    s = torch.sqrt(torch.clamp_min(torch.linalg.vector_norm(h1, dim=-1)
                                   * torch.linalg.vector_norm(h2, dim=-1), 1e-30))[:, None]
    R0 = torch.stack([h1 / s, h2 / s, torch.linalg.cross(h1, h2) / (s * s)], dim=-1)
    R0 = project_so3(R0)
    R, t = refine_lm(R0, h3 / s, corners_px, K, dist, marker_size, iters=lm_iters)
    pc = torch.einsum("nij,pj->npi", R, obj) + t[:, None, :]
    err2 = torch.sum((pc[..., :2] / pc[..., 2:3] - xy) ** 2, dim=(1, 2))
    return R, t, err2


def refine_lm(R, t, corners_px, K, dist, marker_size, iters: int = 20):
    """Levenberg-Marquardt pose refinement (cv.solvePnPRefineLM parity) over
    ``(rvec, t)`` on the pixel residuals, adaptive damping, ``iters`` fixed
    trips.  The Jacobian is forward-mode AD, the six parameter JVPs in one
    vectorized pass, as ``jax.jacfwd`` computes it
    (vican_tpu/ops/pnp.py:309)."""
    obj = marker_object_points(marker_size, corners_px.dtype, corners_px.device)

    def residuals(p):
        proj = project_points(obj, rodrigues(p[:, :3]), p[:, 3:], K, dist)
        return (proj - corners_px).reshape(p.shape[0], 8)

    p = torch.cat([so3_log(R), t], dim=1)
    lam = torch.full((p.shape[0],), 1e-3, dtype=p.dtype, device=p.device)
    eye6 = torch.eye(6, dtype=p.dtype, device=p.device)
    basis = eye6[:, None, :].expand(6, p.shape[0], 6)  # tangent k of every marker
    for _ in range(iters):
        r = residuals(p)
        # the six JVPs in one pass (vmap over the tangent), as jacfwd does
        Jac = torch.func.vmap(lambda v: torch.func.jvp(residuals, (p,), (v,))[1])(basis)
        Jac = Jac.permute(1, 2, 0)  # (N, 8, 6)
        Jt = Jac.transpose(1, 2)
        JtJ = Jt @ Jac
        g = (Jt @ r[..., None])[..., 0]
        damp = lam[:, None, None] * torch.diag_embed(torch.diagonal(JtJ, dim1=1, dim2=2))
        step = _solve(JtJ + damp + 1e-12 * eye6, g)
        p_new = p - step
        accept = torch.sum(residuals(p_new) ** 2, dim=1) < torch.sum(r * r, dim=1)
        p = torch.where(accept[:, None], p_new, p)
        lam = torch.clamp(torch.where(accept, lam * 0.3, lam * 3.0), 1e-12, 1e12)
    return rodrigues(p[:, :3]), p[:, 3:]


def reprojection_error_max(R, t, corners_px, K, dist, marker_size):
    """Max per-corner L2 pixel reprojection error (cam.py:176-179): ``(N,)``."""
    obj = marker_object_points(marker_size, corners_px.dtype, corners_px.device)
    proj = project_points(obj, R, t, K, dist)
    return torch.linalg.vector_norm(proj - corners_px, dim=-1).amax(dim=-1)


def solve_marker_pose(corners_px, K, dist, marker_size, lm_iters: int = 20,
                      method: str = "ippe_square"):
    """Per-marker pose: PnP initialization (``"ippe_square"`` or
    ``"iterative"``, the reference's ``flags``, cam.py:161-165), the
    unconditional LM refinement (cam.py:168-173), the max reprojection
    error.  Returns ``(R (N, 3, 3), t (N, 3), err (N,))``."""
    if method == "ippe_square":
        R0, t0, _ = ippe_square(corners_px, K, dist, marker_size)
    elif method == "iterative":
        R0, t0, _ = iterative_planar(corners_px, K, dist, marker_size, lm_iters=lm_iters)
    else:
        raise ValueError(f"unknown PnP method: {method!r}")
    R, t = refine_lm(R0, t0, corners_px, K, dist, marker_size, iters=lm_iters)
    return R, t, reprojection_error_max(R, t, corners_px, K, dist, marker_size)


def pnp_block_plain(corners, ids, valid, Ks, dists, marker_size, lm_iters: int = 20,
                    method: str = "ippe_square"):
    """The plain version of :func:`pnp_block`: :func:`solve_marker_pose` on
    the valid slots only (a ``nonzero`` picks them, a host sync on the
    card), scattered into the packed buffer."""
    N = corners.shape[0]
    D = N // Ks.shape[0]
    out = torch.zeros((N, 23), dtype=torch.float64, device=corners.device)
    out[:, 0:8] = corners.reshape(N, 8)
    out[:, 8] = ids.to(torch.float64)
    sel = valid.nonzero()[:, 0]
    if sel.numel():
        im_of = sel // D
        R, t, err = solve_marker_pose(corners[sel], Ks[im_of], dists[im_of], marker_size,
                                      lm_iters=lm_iters, method=method)
        finite = (torch.isfinite(err) & torch.isfinite(R).all(dim=(1, 2))
                  & torch.isfinite(t).all(dim=1))
        out[sel, 9] = finite.to(torch.float64)
        out[sel, 10:19] = R.reshape(-1, 9)
        out[sel, 19:22] = t
        out[sel, 22] = err
    return out


def pnp_block(corners, ids, valid, Ks, dists, marker_size, lm_iters: int = 20,
              method: str = "ippe_square"):
    """Poses of a batch's detection slots, packed as
    vican_tpu/perception.py:_pnp_block packs them.

    ``corners (B*D, 4, 2)`` float64 in pixels, ``ids (B*D,)`` int64,
    ``valid (B*D,)`` bool, ``Ks (B, 3, 3)`` and ``dists (B, 14)`` float64,
    slot ``i`` seen by camera ``i // D``.  Returns float64 ``(B*D, 23)``:
    corners (8), id, ok, R (9), t (3), reprojection error (px).  A slot that
    is not valid keeps its corners and id and is zero elsewhere; ``ok`` is 1
    where a valid slot's pose and error are finite.

    CPU tensors take :func:`pnp_block_plain`.  CUDA tensors launch the
    kernel of ``vican_torch/csrc/pnp.cu`` (one warp per slot, its lanes
    across the LM Jacobian's tangents and corners, float64, no host sync),
    or raise; each launch adds one to ``pnp_block.launches``.
    """
    if method not in PNP_METHODS:
        raise ValueError(f"unknown PnP method: {method!r}")
    if not corners.is_cuda:
        return pnp_block_plain(corners, ids, valid, Ks, dists, marker_size, lm_iters, method)
    N, B = corners.shape[0], Ks.shape[0]
    want = {"corners": (corners, torch.float64, (N, 4, 2)), "ids": (ids, torch.int64, (N,)),
            "valid": (valid, torch.bool, (N,)), "Ks": (Ks, torch.float64, (B, 3, 3)),
            "dists": (dists, torch.float64, (B, 14))}
    for name, (x, dtype, shape) in want.items():
        if x.dtype != dtype or tuple(x.shape) != shape or not x.is_contiguous():
            raise ValueError(f"pnp_block: {name} must be a contiguous {dtype} {shape} tensor, "
                             f"got {x.dtype} {tuple(x.shape)}")
        if x.device != corners.device:
            raise ValueError(f"pnp_block: {name} is on {x.device}, corners on {corners.device}")
    if B == 0 or N % B:
        raise ValueError(f"pnp_block: {N} slots do not split over {B} cameras")
    out = torch.empty((N, 23), dtype=torch.float64, device=corners.device)
    if N:
        _kernels.launch("pnp", "pnp_block_f64", corners, ids, valid, Ks, dists, out, N, N // B,
                        int(lm_iters), PNP_METHODS[method], float(marker_size))
        pnp_block.launches += 1
    return out


pnp_block.launches = 0
