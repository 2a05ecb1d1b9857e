"""Batched SO(3) ops on tensors (any leading batch dimensions).

The port of ``vican_tpu.ops.lie``: the skew matrix, Rodrigues and its
inverse, quaternion decoding, the one-sided Jacobi 3x3 SVD with its SO(3)
projection, rotation angles, rigid-transform algebra, the Procrustes
gauges and the batched Langevin sampler.  Every function runs on the
device of its input (:func:`random_langevin` on the device it is given).
"""
from __future__ import annotations

import math

import torch

__all__ = [
    "hat",
    "rodrigues",
    "so3_log",
    "quat_to_mat",
    "svd3_so3",
    "project_so3",
    "angle_deg",
    "distance_so3",
    "se3_compose",
    "se3_inverse",
    "se3_apply",
    "random_langevin",
    "gauge_procrustes_so3",
    "gauge_procrustes_se3",
]


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
    derivatives stay finite there (``vican_tpu.ops.lie.rodrigues``)."""
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


def quat_to_mat(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternions ``(..., 4)`` (w, x, y, z) -> rotations ``(..., 3, 3)``;
    the input is normalized first."""
    q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack(
        [
            torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)], -1),
            torch.stack([2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)], -1),
            torch.stack([2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)], -1),
        ],
        dim=-2,
    )


def _svd3_jacobi(x: torch.Tensor, sweeps: int = 5):
    """Batched 3x3 SVD by one-sided (Hestenes) Jacobi, elementwise.

    Same algorithm and constants as ``vican_tpu.ops.lie._svd3_jacobi``:
    rotate column pairs of ``A V`` to mutual orthogonality over ``sweeps``
    cyclic sweeps, then ``sigma_i = |A v_i|`` and ``u_i = A v_i / sigma_i``.
    Only ``V`` is carried between rotations; the working columns are
    re-derived as ``A @ v_j`` at every step, so ``U S V^T = A`` holds by
    construction whatever the rounding of the two update chains.  A
    Gram-Schmidt pass returns ``U`` to orthonormality on low-rank blocks.

    Returns ``(u, s, vt)`` with ``s`` descending (``det`` of ``u``/``vt``
    may be -1, the LAPACK convention).
    """
    f64 = x.dtype == torch.float64
    tiny = 1e-30 if f64 else 1e-20
    eps2 = 1e-30 if f64 else 6e-14
    rel = 1e-12 if f64 else 1e-6
    one = torch.ones(x.shape[:-2], dtype=x.dtype, device=x.device)
    zero = torch.zeros_like(one)
    a_cols = [[x[..., i, j] for i in range(3)] for j in range(3)]
    V = [[one, zero, zero], [zero, one, zero], [zero, zero, one]]

    def dot(a, b):
        return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]

    def av(v):
        """A @ v from component triples (a column of A V)."""
        return [
            a_cols[0][i] * v[0] + a_cols[1][i] * v[1] + a_cols[2][i] * v[2]
            for i in range(3)
        ]

    for _ in range(sweeps):
        for p, q in ((0, 1), (0, 2), (1, 2)):
            bp, bq = av(V[p]), av(V[q])
            alpha = dot(bp, bp)
            beta = dot(bq, bq)
            gamma = dot(bp, bq)
            # t^2 + 2*zeta*t - 1 = 0, t = sign(zeta)/(|zeta| + sqrt(1+zeta^2))
            zeta = (beta - alpha) / torch.clamp_min(2.0 * torch.abs(gamma), tiny)
            zeta = torch.where(gamma < 0, -zeta, zeta)
            t = 1.0 / (torch.abs(zeta) + torch.sqrt(1.0 + zeta * zeta))
            t = torch.where(zeta < 0, -t, t)  # 45 deg when alpha == beta
            c = 1.0 / torch.sqrt(1.0 + t * t)
            s = c * t
            # already orthogonal (threshold near machine eps: the dual
            # blocks have clustered sigmas) -> identity rotation
            ortho = gamma * gamma <= eps2 * alpha * beta
            c = c.masked_fill(ortho, 1.0)
            s = s.masked_fill(ortho, 0.0)
            vp, vq = V[p], V[q]
            V[p] = [c * a - s * b for a, b in zip(vp, vq)]
            V[q] = [s * a + c * b for a, b in zip(vp, vq)]

    B = [av(V[j]) for j in range(3)]
    sig = [torch.sqrt(dot(B[j], B[j])) for j in range(3)]

    # sort descending: compare-swap network over (sigma, B, V)
    for i, j in ((0, 1), (0, 2), (1, 2)):
        swap = sig[i] < sig[j]
        sig[i], sig[j] = (torch.where(swap, sig[j], sig[i]),
                          torch.where(swap, sig[i], sig[j]))
        for M in (B, V):
            M[i], M[j] = ([torch.where(swap, b, a) for a, b in zip(M[i], M[j])],
                          [torch.where(swap, a, b) for a, b in zip(M[i], M[j])])

    def normalize(col):
        n = torch.sqrt(dot(col, col))
        inv = 1.0 / torch.clamp_min(n, tiny)
        return [a * inv for a in col], n

    def cross(a, b):
        return [a[1] * b[2] - a[2] * b[1],
                a[2] * b[0] - a[0] * b[2],
                a[0] * b[1] - a[1] * b[0]]

    # U columns b_i / sigma_i, with an orthonormal completion for
    # (near-)rank-deficient blocks
    ex = [one, zero, zero]
    ey = [zero, one, zero]
    u0, _ = normalize(B[0])
    u0 = [torch.where(sig[0] <= tiny, e, a) for a, e in zip(u0, ex)]
    w0, wn0 = normalize(cross(u0, ex))
    w1, wn1 = normalize(cross(u0, ey))
    fb1 = [torch.where(wn0 > wn1, a, b) for a, b in zip(w0, w1)]
    u1, _ = normalize(B[1])
    bad1 = sig[1] <= rel * sig[0]
    u1 = [torch.where(bad1, f, a) for a, f in zip(u1, fb1)]
    # Gram-Schmidt cleanup (see the docstring)
    d01 = dot(u0, u1)
    u1, _ = normalize([a - d01 * b for a, b in zip(u1, u0)])
    u2, _ = normalize(B[2])
    bad2 = sig[2] <= rel * sig[0]
    fb2, _ = normalize(cross(u0, u1))
    u2 = [torch.where(bad2, f, a) for a, f in zip(u2, fb2)]
    d02 = dot(u0, u2)
    d12 = dot(u1, u2)
    u2, _ = normalize([a - d02 * b - d12 * c_ for a, b, c_ in zip(u2, u0, u1)])

    u = torch.stack([torch.stack(c, dim=-1) for c in (u0, u1, u2)], dim=-1)
    vt = torch.stack([torch.stack(c, dim=-1) for c in (V[0], V[1], V[2])], dim=-2)
    s = torch.stack(sig, dim=-1)
    return u, s, vt


def _det3(m: torch.Tensor) -> torch.Tensor:
    """Closed-form determinant of ``(..., 3, 3)`` blocks."""
    return (
        m[..., 0, 0] * (m[..., 1, 1] * m[..., 2, 2] - m[..., 1, 2] * m[..., 2, 1])
        - m[..., 0, 1] * (m[..., 1, 0] * m[..., 2, 2] - m[..., 1, 2] * m[..., 2, 0])
        + m[..., 0, 2] * (m[..., 1, 0] * m[..., 2, 1] - m[..., 1, 1] * m[..., 2, 0])
    )


def svd3_so3(x: torch.Tensor):
    """SVD of ``(..., 3, 3)`` blocks with the SO(3)-projected factor.

    Returns ``(r, u, s, vt)`` with ``r = u diag(1, 1, det(u vt)) vt`` the
    closest rotation (bipgo.py:295-332's per-block SVD loops, batched).
    """
    u, s, vt = _svd3_jacobi(x)
    det = _det3(u) * _det3(vt)
    fix = torch.stack([torch.ones_like(det), torch.ones_like(det), det], dim=-1)
    r = torch.matmul(u * fix[..., None, :], vt)
    return r, u, s, vt


def project_so3(x: torch.Tensor) -> torch.Tensor:
    """Project ``(..., 3, 3)`` matrices onto SO(3) (geometry.py:175-191)."""
    return svd3_so3(x)[0]


def angle_deg(R: torch.Tensor) -> torch.Tensor:
    """Rotation angle in degrees of ``(..., 3, 3)`` matrices."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    rad = torch.arccos(torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0))
    return rad * (180.0 / math.pi)


def distance_so3(r1: torch.Tensor, r2: torch.Tensor) -> torch.Tensor:
    """Pairwise geodesic angle (degrees) between batched rotations."""
    return angle_deg(torch.matmul(r1.transpose(-1, -2), r2))


def se3_compose(Ra, ta, Rb, tb):
    """Compose (Ra, ta) . (Rb, tb) -> (Ra Rb, Ra tb + ta), batched."""
    return Ra @ Rb, torch.einsum("...ij,...j->...i", Ra, tb) + ta


def se3_inverse(R, t):
    """Inverse of batched rigid transforms."""
    Rt = R.transpose(-1, -2)
    return Rt, -torch.einsum("...ij,...j->...i", Rt, t)


def se3_apply(R, t, x):
    """Apply batched rigid transforms to points ``(..., 3)``."""
    return torch.einsum("...ij,...j->...i", R, x) + t


def random_langevin(generator: torch.Generator, k: float, shape=(), device=None) -> torch.Tensor:
    """Batched isotropic-Langevin SO(3) samples (geometry.py:13-30 model),
    float32 ``shape + (3, 3)`` on ``device`` (``None``: the CUDA card),
    drawn from ``generator`` (a generator of that device).

    Axis ~ isotropic Gaussian (normalized), magnitude ~ von Mises(``k``) by
    :func:`_von_mises`, through Rodrigues; the algorithm of
    ``vican_tpu.ops.lie.random_langevin``, whose PRNG stream a torch
    generator cannot reproduce: the two agree in distribution.  The sample
    is drawn in float64: in float32 the sampler's ``r - f`` and
    ``arccos(f)`` lose the angle's low digits at large ``k`` (at k = 1e5
    the angles fall on ~75 levels)."""
    from ..utils import resolve_device

    dev = resolve_device(device)
    shape = tuple(shape)
    axis = torch.randn(shape + (3,), generator=generator, device=dev, dtype=torch.float64)
    axis = axis / torch.clamp_min(torch.linalg.vector_norm(axis, dim=-1, keepdim=True), 1e-12)
    mag = _von_mises(generator, torch.tensor(k, dtype=torch.float64, device=dev), shape)
    return rodrigues(axis * mag[..., None]).to(torch.float32)


def _von_mises(generator: torch.Generator, kappa: torch.Tensor, shape=()) -> torch.Tensor:
    """Best-Fisher von Mises sampler with a fixed proposal budget, on the
    device and in the dtype of ``kappa``.

    Draws ROUNDS proposals per sample at once and keeps the first accepted
    one (the envelope accepts ~0.66 of proposals, so 16 rounds fail with
    probability < 1e-7; a failed sample keeps the first proposal, as
    ``jnp.argmax`` of an all-false column does in the JAX package).  No
    loop depends on the data."""
    ROUNDS = 16
    tau = 1.0 + torch.sqrt(1.0 + 4.0 * kappa * kappa)
    rho = (tau - torch.sqrt(2.0 * tau)) / (2.0 * kappa)
    r = (1.0 + rho * rho) / (2.0 * rho)
    u1, u2, u3 = torch.rand((3, ROUNDS) + tuple(shape), generator=generator,
                            device=kappa.device, dtype=kappa.dtype)
    z = torch.cos(math.pi * u1)
    f = (1.0 + r * z) / (r + z)
    c = kappa * (r - f)
    accept = (c * (2.0 - c) - u2 > 0) | (torch.log(c / torch.clamp_min(u2, 1e-30)) + 1.0 - c >= 0)
    theta = torch.sign(u3 - 0.5) * torch.arccos(torch.clamp(f, -1.0, 1.0))
    first = torch.argmax(accept.to(torch.uint8), dim=0)
    return torch.take_along_dim(theta, first[None], dim=0)[0]


def gauge_procrustes_so3(Ra: torch.Tensor, Rb: torch.Tensor) -> torch.Tensor:
    """Rotation aligning stacks ``Ra ~ Rb @ g`` (geometry.py:264-291).

    ``Ra``/``Rb``: (N, 3, 3).  Returns the 3x3 gauge rotation.
    """
    acc = torch.sum(torch.matmul(Ra.transpose(-1, -2), Rb), dim=0)
    return project_so3(acc.T)


def gauge_procrustes_se3(Ra, ta, Rb, tb):
    """SE(3) gauge aligning ``(Ra, ta) ~ (Rb, tb) @ g`` (geometry.py:294-325).

    Inputs are (N, 3, 3) rotation stacks and (N, 3) translation stacks.
    Returns ``(g_R, g_t)``.
    """
    g_r = gauge_procrustes_so3(Ra, Rb)
    g_t = torch.mean(torch.einsum("nji,nj->ni", Rb, ta - tb), dim=0)
    return g_r, g_t
