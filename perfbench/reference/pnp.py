"""Planar-square PnP, plain PyTorch: a frozen copy of the port's plain version.

The camera model (OpenCV's 12-coefficient rational and thin-prism
distortion), undistortion by fixed-point steps, the 4-point DLT, IPPE for
square markers (Collins and Bartoli 2014, as ``cv.solvePnP`` with
``SOLVEPNP_IPPE_SQUARE``), Levenberg-Marquardt refinement with a
forward-mode Jacobian (``cv.solvePnPRefineLM``) and the largest corner
reprojection error, batched over markers.  Every function computes in the
dtype of its corners, so float32 corners give the control.
"""
from __future__ import annotations

import torch


def hat(v: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric matrices of ``(..., 3)`` vectors -> ``(..., 3, 3)``."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    return torch.stack(
        [
            torch.stack([zero, -z, y], dim=-1),
            torch.stack([z, zero, -x], dim=-1),
            torch.stack([-y, x, zero], dim=-1),
        ],
        dim=-2,
    )


def rodrigues(vec: torch.Tensor) -> torch.Tensor:
    """Axis-angle ``(..., 3)`` -> rotation matrices ``(..., 3, 3)``, with the
    series forms of ``sin(t)/t`` and ``(1-cos(t))/t^2`` near zero, so forward
    derivatives stay finite there."""
    theta2 = torch.sum(vec * vec, dim=-1)
    theta = torch.sqrt(torch.clamp_min(theta2, 1e-32))
    small = theta2 < 1e-16
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / theta2)
    K = hat(vec)
    eye = torch.eye(3, dtype=vec.dtype, device=vec.device).expand(K.shape)
    return eye + a[..., None, None] * K + b[..., None, None] * (K @ K)


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrices ``(..., 3, 3)`` -> axis-angle ``(..., 3)``: the
    inverse of :func:`rodrigues`, guarded near 0 and near pi."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_t = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
    theta = torch.arccos(cos_t)
    # the antisymmetric part is 2 sin(theta) * axis
    w = torch.stack(
        [R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0], R[..., 1, 0] - R[..., 0, 1]],
        dim=-1,
    )
    scale_generic = theta / torch.clamp_min(2.0 * torch.sin(theta), 1e-12)
    scale_small = 0.5 + theta * theta / 12.0
    near_pi = cos_t < -1.0 + 1e-6
    generic = w * torch.where(theta < 1e-6, scale_small, scale_generic)[..., None]
    # near pi: the axis is the dominant column of R + I, signed like w
    B = R + torch.eye(3, dtype=R.dtype, device=R.device)
    col = torch.argmax(torch.linalg.vector_norm(B, dim=-2), dim=-1)
    axis = torch.take_along_dim(B, col[..., None, None], dim=-1)[..., 0]
    axis = axis / torch.clamp_min(torch.linalg.vector_norm(axis, dim=-1, keepdim=True), 1e-12)
    sign = torch.where(torch.sum(axis * w, dim=-1, keepdim=True) < 0, -1.0, 1.0)
    return torch.where(near_pi[..., None], axis * sign * theta[..., None], generic)



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


def refine_lm(R, t, corners_px, K, dist, marker_size, iters: int = 20):
    """Levenberg-Marquardt pose refinement (cv.solvePnPRefineLM parity) over
    ``(rvec, t)`` on the pixel residuals, adaptive damping, ``iters`` fixed
    trips.  The Jacobian is forward-mode AD, the six parameter JVPs in one
    vectorized pass."""
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


def marker_poses(corners_px, K, dist, marker_size, lm_iters: int = 20):
    """IPPE, then the LM refinement, then the reprojection error of each
    marker: ``(R (N, 3, 3), t (N, 3), err (N,))`` in the corners' dtype."""
    R0, t0, _ = ippe_square(corners_px, K, dist, marker_size)
    R, t = refine_lm(R0, t0, corners_px, K, dist, marker_size, iters=lm_iters)
    return R, t, reprojection_error_max(R, t, corners_px, K, dist, marker_size)
