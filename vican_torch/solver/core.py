"""Dense-route solver: primal-dual bipartite SO(3) sync + translation solves.

The port of ``vican_tpu.solver.core``'s dense route (reference
vican/bipgo.py:145-490), in plain PyTorch on whatever device the inputs
live on:

- constraint folding is one batched einsum; the per-(c,t) aggregation the
  reference does in a dict loop is the scatter-add (``index_add_``) that
  builds the block operator, where duplicate (c,t) cells accumulate;
- the block operator is kept flat, ``B (3C, 3T)`` with
  ``B[3i+a, 3t+b] = M_it[a,b]`` (the JAX package's ``(C,3,T,3)`` tensor
  is the same array), so the power graph ``R~ = B Lambda_T B^T``
  (bipgo.py:273,334) is one einsum and one GEMM, and the time-dual input
  ``R_ct^T r`` (bipgo.py:318) is one GEMM;
- the bottom-5 eigenpairs (ARPACK shift-invert, bipgo.py:288) come from a
  dense ``torch.linalg.eigh`` of the normalized (3C, 3C) Laplacian,
  re-ordered like ARPACK;
- the per-block SVDs are the batched Jacobi SVD of :mod:`..ops.lie`;
- the while loop with the certificate early exit (bipgo.py:282-284) is a
  Python loop that reads the certificate once per iteration;
- translations: CG on the normal equations with SciPy/JAX semantics, or
  LSQR, both matrix-free.

Callers turn TF32 off (:func:`vican_torch.utils.no_tf32`): every product
here needs true float32.  On a CUDA device the scatter-adds are atomic, so
their sums are ordered differently from run to run.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops.lie import project_so3, quat_to_mat, svd3_so3
from ..utils import no_tf32

__all__ = [
    "HIST_CAP",
    "SyncResult",
    "fold_constraints",
    "so3_sync",
    "translation_rhs",
    "solve_translations_cg",
    "solve_translations_lsqr",
]

# Capacity of the per-iteration diagnostic histories (the reference runs
# maxiter=4; iterations past the cap overwrite the last slot).
HIST_CAP = 32


class SyncResult(NamedTuple):
    """Output of :func:`so3_sync` (all world-frame, like bipgo.py:343-350)."""

    r_cam: torch.Tensor  # (C, 3, 3) world-frame camera rotations
    r_time: torch.Tensor  # (T, 3, 3) world-frame object rotations per timestep
    evals: torch.Tensor  # (5,) final eigenvalues nearest -1e-6
    eigengap: torch.Tensor  # |evals[3]/evals[2]| of the final iteration
    num_iters: int  # iterations executed
    evals_hist: torch.Tensor | None = None  # (HIST_CAP, 5)
    gap_hist: torch.Tensor | None = None  # (HIST_CAP,)


def fold_constraints(R_e, k_r, marker_idx, R_con, root_idx):
    """Per-edge constraint folding (bipgo.py:209-213):
    ``k_r * R_edge @ R_m^T @ R_0``.  ``R_e`` may be (E, 4) quaternions."""
    if R_e.ndim == 2:
        R_e = quat_to_mat(R_e)
    R0 = R_con[root_idx]
    Rm = R_con[marker_idx]
    return k_r[:, None, None] * torch.einsum("eij,ekj,kl->eil", R_e, Rm, R0)


def block_matrix(KR, cam_idx, time_idx, C: int, T: int):
    """Flat ``B (3C, 3T)``: ``B[3i+a, 3t+b] = sum of KR_e[a, b]`` over the
    edges ``e`` of cell (i, t)."""
    dev = KR.device
    a3 = torch.arange(3, device=dev)
    rows = 3 * cam_idx.long()[:, None, None] + a3[None, :, None]
    cols = 3 * time_idx.long()[:, None, None] + a3[None, None, :]
    B = torch.zeros(3 * C * 3 * T, dtype=KR.dtype, device=dev)
    B.index_add_(0, (rows * (3 * T) + cols).reshape(-1), KR.reshape(-1))
    return B.view(3 * C, 3 * T)


def _power_graph(B, lbd_t):
    """Dense power graph ``R~ = B Lambda_T B^T`` (3C, 3C), with the
    block-diagonal ``Lambda_T`` applied blockwise (bipgo.py:273,334)."""
    n = B.shape[0]
    T = lbd_t.shape[0]
    Y = torch.einsum("rtb,tbd->rtd", B.view(n, T, 3), lbd_t).reshape(n, 3 * T)
    return Y @ B.T


def _add_block_diag(dense, blocks):
    """Add (C,3,3) blocks onto the 3x3 diagonal blocks of a (3C,3C) matrix
    (in place; returns it)."""
    C = blocks.shape[0]
    diag = torch.diagonal(dense.view(C, 3, C, 3), dim1=0, dim2=2)  # (3, 3, C)
    diag.add_(blocks.permute(1, 2, 0))
    return dense


def _bottom5_like_arpack(L):
    """The 5 eigenpairs nearest sigma = -1e-6, in increasing
    ``|lambda - sigma|`` order like ``eigs(L, k=5, sigma=-1e-6)``
    (bipgo.py:288).  ``L`` is normalized by its largest diagonal entry for
    float32 accuracy; eigenvalues are scaled back."""
    scale = torch.clamp_min(torch.diagonal(L).abs().max(), 1e-30)
    evals, evecs = torch.linalg.eigh(L / scale)
    evals = evals * scale
    sel = torch.argsort(torch.abs(evals + 1e-6), stable=True)[:5]
    return evals[sel], evecs[:, sel]


def so3_sync(KR, k_r, cam_idx, time_idx, *, C: int, T: int, maxiter: int,
             cert_tol=1e-6) -> SyncResult:
    """Primal-dual SO(3) synchronization over the camera power graph.

    Faithful to ``large_bipartite_so3sync`` (bipgo.py:145-350): degree-dual
    initialization, then per iteration primal rounding -> camera dual via
    SVD of ``R~ r`` -> time dual via SVD of ``R_ct^T r`` -> power-graph
    refresh, stopping early once the certificate ``max |eval| <= cert_tol``
    holds at the top of an iteration (bipgo.py:283-284).

    ``KR (E,3,3)`` folded blocks, ``k_r (E,)`` weights, ``cam_idx``/
    ``time_idx (E,)`` node indices, all on one device.
    """
    no_tf32()
    dtype, dev = KR.dtype, KR.device
    deg_t = torch.zeros(T, dtype=dtype, device=dev).index_add_(0, time_idx, k_r)
    deg_c = torch.zeros(C, dtype=dtype, device=dev).index_add_(0, cam_idx, k_r)
    B = block_matrix(KR, cam_idx, time_idx, C, T)

    eye3 = torch.eye(3, dtype=dtype, device=dev)
    lbd_t = eye3 / torch.clamp_min(deg_t, 1e-30)[:, None, None]
    lbd_c = deg_c[:, None, None] * eye3
    r_c = eye3.expand(C, 3, 3)
    r_t = eye3.expand(T, 3, 3)
    evals5 = torch.zeros(5, dtype=dtype, device=dev)
    eigengap = torch.zeros((), dtype=dtype, device=dev)
    ev_hist = torch.zeros(HIST_CAP, 5, dtype=dtype, device=dev)
    gap_hist = torch.zeros(HIST_CAP, dtype=dtype, device=dev)

    it, max_eval = 0, 1.0
    while it < maxiter and max_eval > cert_tol:
        pwr = _power_graph(B, lbd_t)
        L = _add_block_diag(-pwr, lbd_c)
        L = 0.5 * (L + L.T)
        evals5, V5 = _bottom5_like_arpack(L)
        eigengap = torch.abs(evals5[3] / evals5[2])

        # primal rounding (bipgo.py:295-297): anchor the gauge to block 0,
        # project every 3x3 block onto SO(3)
        V3 = V5[:, :3]
        r = V3 @ torch.linalg.inv(V3[:3, :3])
        r_blocks = project_so3(r.reshape(C, 3, 3))

        # camera dual (bipgo.py:300-315): SVD of the (R~ r) blocks
        rtr = (pwr @ r_blocks.reshape(3 * C, 3)).reshape(C, 3, 3)
        r_c, u, s, _ = svd3_so3(rtr)
        lbd_c = (u * s[:, None, :]) @ u.transpose(-1, -2)

        # time dual (bipgo.py:317-332): SVD of (R_ct^T r) blocks; the
        # pseudo-inverse guard zeroes near-rank-deficient directions
        rt_raw = (B.T @ r_c.reshape(3 * C, 3)).reshape(T, 3, 3)
        r_t, ut, st, _ = svd3_so3(rt_raw)
        st_inv = torch.where(st > 1e-9 * st[..., :1], 1.0 / torch.clamp_min(st, 1e-30), 0.0)
        lbd_t = (ut * st_inv[:, None, :]) @ ut.transpose(-1, -2)

        slot = min(it, HIST_CAP - 1)
        ev_hist[slot] = evals5
        gap_hist[slot] = eigengap
        it += 1
        max_eval = float(torch.abs(evals5).max())

    return SyncResult(
        r_cam=r_c.transpose(-1, -2),
        r_time=r_t.transpose(-1, -2),
        evals=evals5,
        eigengap=eigengap,
        num_iters=it,
        evals_hist=ev_hist,
        gap_hist=gap_hist,
    )


# ---------------------------------------------------------------------------
# Translation stage (bipgo.py:420-481)
# ---------------------------------------------------------------------------


def translation_rhs(
    r_cam, r_time, t_e, k_t, cam_idx, time_idx, marker_idx, R_con, t_con, root_idx
):
    """Per-edge translation measurements (bipgo.py:449-455):
    ``t~_e = k_t (R^w_c t_e + R^w_t R_0^T R_m t_{m->0})`` with
    ``t_{m->0} = -R_m^T (t_m - t_0)``."""
    R0 = R_con[root_idx]
    t0 = t_con[root_idx]
    Rm = R_con[marker_idx]
    tm = t_con[marker_idx]
    r0m = torch.einsum("ji,ejk->eik", R0, Rm)  # R_0^T R_m
    tm0 = torch.einsum("eji,ej->ei", Rm, t0 - tm)
    term_c = torch.einsum("eij,ej->ei", r_cam[cam_idx], t_e)
    term_t = torch.einsum("eij,ej->ei", r_time[time_idx], torch.einsum("eij,ej->ei", r0m, tm0))
    return k_t[:, None] * (term_c + term_t)


def _normal_matvec(x, k_t2, cam_idx, time_idx, C, T):
    """``A^T A x`` for the stacked incidence system (bipgo.py:457-469): one
    3-row block per edge, ``-k_t I`` at the camera, ``+k_t I`` at the time
    node; nodes ordered cameras then times."""
    xc, xt = x[:C], x[C:]
    z = k_t2[:, None] * (xt[time_idx] - xc[cam_idx])
    out_c = -torch.zeros((C, 3), dtype=x.dtype, device=x.device).index_add_(0, cam_idx, z)
    out_t = torch.zeros((T, 3), dtype=x.dtype, device=x.device).index_add_(0, time_idx, z)
    return torch.cat([out_c, out_t], dim=0)


# Budget for the dense (C, T) weighted bipartite adjacency of the CG
# matvec: 4 MB at 100 x 10k, 400 MB at 10k x 10k.  Past it, the per-
# iteration scatter formulation takes over.
_DENSE_ADJ_BUDGET_BYTES = int(1 << 30)


def _make_normal_mv(k_t2, cam_idx, time_idx, C, T):
    """CG matvec for ``A^T A = blockdiag(deg) - W``, with the (C, T)
    adjacency ``W`` materialized once when it fits the budget (two thin
    GEMMs per iteration instead of two scatters)."""
    dtype, dev = k_t2.dtype, k_t2.device
    if C * T * k_t2.element_size() <= _DENSE_ADJ_BUDGET_BYTES:
        W = torch.zeros(C * T, dtype=dtype, device=dev)
        W.index_add_(0, cam_idx.long() * T + time_idx, k_t2)
        W = W.view(C, T)
        deg_c = W.sum(dim=1)
        deg_t = W.sum(dim=0)

        def mv(x):
            xc, xt = x[:C], x[C:]
            yc = deg_c[:, None] * xc - W @ xt
            yt = deg_t[:, None] * xt - W.T @ xc
            return torch.cat([yc, yt], dim=0)

        return mv
    return lambda x: _normal_matvec(x, k_t2, cam_idx, time_idx, C, T)


def _translation_normal_rhs(t_tilde, k_t, cam_idx, time_idx, C, T):
    kt = k_t[:, None] * t_tilde
    z = dict(dtype=t_tilde.dtype, device=t_tilde.device)
    atb_c = -torch.zeros((C, 3), **z).index_add_(0, cam_idx, kt)
    atb_t = torch.zeros((T, 3), **z).index_add_(0, time_idx, kt)
    return torch.cat([atb_c, atb_t], dim=0)


def _cg(mv, b, tol, maxiter):
    """Conjugate gradient with ``jax.scipy.sparse.linalg.cg``'s semantics:
    ``x0 = 0``, stop once ``|r|^2 <= tol^2 |b|^2``, ``maxiter = 10 * b.size``
    when None.  The stopping test is read on the host once per iteration."""
    if maxiter is None:
        maxiter = 10 * b.numel()
    x = torch.zeros_like(b)
    atol2 = (tol * tol) * torch.sum(b * b)
    r = b - mv(x)
    p = r
    gamma = torch.sum(r * r)
    k = 0
    while k < maxiter and bool(gamma > atol2):
        Ap = mv(p)
        alpha = gamma / torch.sum(p * Ap)
        x = x + alpha * p
        r = r - alpha * Ap
        gamma_new = torch.sum(r * r)
        p = r + (gamma_new / gamma) * p
        gamma = gamma_new
        k += 1
    return x


def solve_translations_cg(t_tilde, k_t, cam_idx, time_idx, *, C: int, T: int,
                          tol=1e-5, maxiter=None):
    """CG on the normal equations (bipgo.py:476-478), from ``x0 = 0`` with
    relative tolerance ``tol``.  The system is singular (global translation
    gauge) but consistent; CG stays in the range space, like the reference.
    Returns ``(x (C+T, 3), relative residual)``."""
    no_tf32()
    b = _translation_normal_rhs(t_tilde, k_t, cam_idx, time_idx, C, T)
    mv = _make_normal_mv(k_t * k_t, cam_idx, time_idx, C, T)
    x = _cg(mv, b, tol, maxiter)
    res = torch.linalg.vector_norm(mv(x) - b) / torch.clamp_min(
        torch.linalg.vector_norm(b), 1e-30)
    return x, res


def solve_translations_lsqr(t_tilde, k_t, cam_idx, time_idx, *, C: int, T: int,
                            atol=1e-8, btol=1e-8, maxiter=None):
    """LSQR (Paige & Saunders) on the incidence operator, one coordinate
    column at a time; the reference's "direct" path
    (``scipy.sparse.linalg.lsqr``, bipgo.py:479-480).  Stops on SciPy's
    test 2, ``|A^T r| <= atol |A| |r|``: running past Krylov exhaustion on
    the rank-deficient system makes the recurrences diverge."""
    no_tf32()
    N = C + T
    if maxiter is None:
        maxiter = 2 * N
    dtype, dev = t_tilde.dtype, t_tilde.device

    def A_col(x):  # (N,) -> (E,)
        return k_t * (x[C:][time_idx] - x[:C][cam_idx])

    def At_col(y):  # (E,) -> (N,)
        ky = k_t * y
        return torch.cat([
            -torch.zeros(C, dtype=dtype, device=dev).index_add_(0, cam_idx, ky),
            torch.zeros(T, dtype=dtype, device=dev).index_add_(0, time_idx, ky),
        ])

    def norm(v):
        return torch.linalg.vector_norm(v)

    def lsqr_1d(b):
        beta0 = norm(b)
        u = b / torch.clamp_min(beta0, 1e-30)
        v = At_col(u)
        alpha = norm(v)
        v = v / torch.clamp_min(alpha, 1e-30)
        w = v
        x = torch.zeros(N, dtype=dtype, device=dev)
        phibar, rhobar = beta0, alpha
        anorm2 = alpha * alpha
        normar = alpha * beta0
        i = 0
        while i < maxiter and bool(normar > atol * torch.sqrt(anorm2) * torch.abs(phibar) + 1e-30):
            u1 = A_col(v) - alpha * u
            beta = norm(u1)
            u1 = u1 / torch.clamp_min(beta, 1e-30)
            v1 = At_col(u1) - beta * v
            alpha1 = norm(v1)
            v1 = v1 / torch.clamp_min(alpha1, 1e-30)
            rho = torch.sqrt(rhobar * rhobar + beta * beta)
            c = rhobar / torch.clamp_min(rho, 1e-30)
            sgn = beta / torch.clamp_min(rho, 1e-30)
            theta = sgn * alpha1
            rhobar = -c * alpha1
            phi = c * phibar
            phibar = sgn * phibar
            x = x + (phi / torch.clamp_min(rho, 1e-30)) * w
            w = v1 - (theta / torch.clamp_min(rho, 1e-30)) * w
            anorm2 = anorm2 + alpha * alpha + beta * beta
            normar = torch.abs(phibar) * alpha1 * torch.abs(c)
            u, v, alpha = u1, v1, alpha1
            i += 1
        return x

    x_cols = torch.stack([lsqr_1d(t_tilde[:, j]) for j in range(3)], dim=1)

    def A(x):
        return k_t[:, None] * (x[C:][time_idx] - x[:C][cam_idx])

    def At(y):
        return _translation_normal_rhs(y, k_t, cam_idx, time_idx, C, T)

    res = norm(At(A(x_cols) - t_tilde)) / torch.clamp_min(norm(At(t_tilde)), 1e-30)
    return x_cols, res
