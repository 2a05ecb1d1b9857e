"""Large-graph SO(3) sync: the 10k-camera / million-edge route.

The port of ``vican_tpu.solver.scale``'s materialized-operator path.  The
dense route (:mod:`.core`) needs a dense ``eigh`` of the (3C, 3C) Laplacian
every iteration, O((3C)^3); this module keeps the same primal-dual
algorithm (reference vican/bipgo.py:145-350) with three substitutions:

1. **Flat block operator**: edges are sorted by time chunk on the host and
   scattered once into ``B (3C, 3T_pad)`` (loop-invariant: only the duals
   move between iterations).
2. **Matrix-free power graph**: ``R~ = B Lambda_T B^T`` is never formed;
   every consumer needs ``R~ X`` for a thin ``X`` (width 10 for the
   eigensolver subspace, 1 for the lambda_max probes, 3 for the duals).
3. **CheFSI eigensolver**: the bottom-5 eigenpairs come from Chebyshev-
   filtered subspace iteration, warm-started across iterations (the role
   of ARPACK shift-invert, bipgo.py:288).  For float32 problems the filter
   products run on a bfloat16 copy of the operator through the CUDA kernel
   of :mod:`.pwr`; a short full-precision polish filter and full-precision
   Rayleigh-Ritz extractions keep the eigenpairs at float32 quality.

Float64 problems filter in full precision (``filter_dtype="auto"``), with
``torch.matmul`` on the float64 operator: the kernel serves float32 only.
Past the memory budget for ``B`` plus its bfloat16 copy the JAX package
streams per-chunk re-scatters; that fallback is not ported yet, and this
module raises there.

Control flow is host Python: the ``lax.cond(it == 0, ...)`` branches are
``if it == 0`` and the loop reads the certificate once per iteration.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops.lie import project_so3, svd3_so3
from ..utils import no_tf32, resolve_device
from .core import HIST_CAP, SyncResult, block_matrix
from .pwr import filter_operator, pwr_apply

__all__ = ["sort_edges_by_time", "so3_sync_large"]

# Device-memory budget for the loop-invariant operator plus its bfloat16
# filter copy (5.4 GB at 10k cameras x 10k timesteps in float32).
_MATERIALIZE_BUDGET_BYTES = int(6e9)


def _chunk_pack(arrays, pad_values, time_idx, T: int, chunk_t: int):
    """Sort edges by time chunk and pack into ``ceil(T/chunk_t)`` chunks of
    equal edge capacity.  Returns the chunked arrays plus ``tloc_s`` (the
    timestep local to its chunk)."""
    time_idx = np.asarray(time_idx)
    n_chunks = -(-T // chunk_t)
    chunk_of = time_idx // chunk_t
    order = np.argsort(chunk_of, kind="stable")
    time_idx = time_idx[order]
    chunk_of = chunk_of[order]
    counts = np.bincount(chunk_of, minlength=n_chunks)
    cap = int(counts.max()) if len(counts) else 1
    starts = np.concatenate([[0], np.cumsum(counts)])

    outs = []
    for a, pad in zip(arrays, pad_values):
        a = np.asarray(a)[order]
        out = np.empty((n_chunks, cap) + a.shape[1:], a.dtype)
        out[...] = pad
        for c in range(n_chunks):
            s, e = starts[c], starts[c + 1]
            out[c, : e - s] = a[s:e]
        outs.append(out)

    tloc_s = np.zeros((n_chunks, cap), np.int32)
    for c in range(n_chunks):
        s, e = starts[c], starts[c + 1]
        tloc_s[c, : e - s] = time_idx[s:e] - c * chunk_t
    return outs, tloc_s


def sort_edges_by_time(KR, k_r, cam_idx, time_idx, T: int, chunk_t: int):
    """Host preparation: group edges into ``ceil(T / chunk_t)`` time chunks
    of equal capacity, padded with zero-weight edges.  Returns NumPy
    ``(KR_s, k_r_s, cam_s, tloc_s)``; ``tloc`` is local to the chunk."""
    (KR_s, k_s, cam_s), tloc_s = _chunk_pack(
        (KR, k_r, np.asarray(cam_idx, np.int32)), (0, 0, 0), time_idx, T, chunk_t
    )
    return KR_s, k_s, cam_s, tloc_s


def _cheb_filter(mv, X, deg: int, a, b, a0=0.0):
    """Scaled Chebyshev filter (Zhou et al. CheFSI): damp [a, b], amplify
    the spectrum below ``a``.  ``mv`` is the scaled-operator product on
    (n, w) blocks; it is called ``deg`` times."""
    e = (b - a) * 0.5
    c = (b + a) * 0.5
    sigma = e / (a0 - c)
    tau = 2.0 / sigma  # fixed by the first sigma (three-term recurrence)
    Y = (mv(X) - c * X) * (sigma / e)
    for _ in range(deg - 1):
        sigma2 = 1.0 / (tau - sigma)
        Ynew = 2.0 * (sigma2 / e) * (mv(Y) - c * Y) - (sigma * sigma2) * X
        X, Y, sigma = Y, Ynew, sigma2
    return Y


def _lmax_refine(mv, v, iters: int):
    """Warm-started power iteration for the scaled operator's lambda_max;
    ``v (n, 1)``.  Returns (Rayleigh quotient, refined v)."""
    for _ in range(iters):
        w = mv(v)
        v = w / torch.clamp_min(torch.linalg.vector_norm(w), 1e-30)
    return torch.sum(v * mv(v)), v


def _lmax_lanczos(mv, v0, k: int):
    """Safeguarded Lanczos upper bound for lambda_max of an SPD operator:
    ``theta_max + beta_k`` (the CheFSI estimator; a window below lambda_max
    would amplify the components above it).  Full reorthogonalization.
    Returns ``(bound, ritz_vec (n, 1))``."""
    n = v0.shape[0]
    dtype, dev = v0.dtype, v0.device
    v = (v0 / torch.clamp_min(torch.linalg.vector_norm(v0), 1e-30)).reshape(n)
    V = torch.zeros((n, k), dtype=dtype, device=dev)
    alphas = torch.zeros(k, dtype=dtype, device=dev)
    betas = torch.zeros(k, dtype=dtype, device=dev)
    prev = torch.zeros(n, dtype=dtype, device=dev)
    beta = torch.zeros((), dtype=dtype, device=dev)
    for j in range(k):
        V[:, j] = v
        w = mv(v[:, None])[:, 0] - beta * prev
        alpha = torch.dot(v, w)
        w = w - alpha * v
        w = w - V @ (V.T @ w)
        beta_new = torch.linalg.vector_norm(w)
        # breakdown guard: an invariant Krylov subspace leaves w at round-off;
        # contribute zeros rather than a huge w / 1e-30
        broke = beta_new <= 1e-7 * torch.clamp_min(torch.abs(alpha), 1.0)
        v_new = torch.where(broke, 0.0, w / torch.clamp_min(beta_new, 1e-30))
        alphas[j] = alpha
        betas[j] = beta_new
        prev, v, beta = v, v_new, beta_new
    Tm = torch.diag(alphas) + torch.diag(betas[: k - 1], 1) + torch.diag(betas[: k - 1], -1)
    theta, S = torch.linalg.eigh(Tm)
    return theta[-1] + betas[-1], (V @ S[:, -1])[:, None]


def _chefsi_bottom(mv_filt, mv_full, X, b, k: int, deg: int, rounds: int,
                   polish_deg: int, a0, mv_polish=None):
    """Bottom-k eigenpairs by Chebyshev-filtered subspace iteration with an
    adaptive window lower edge: a Rayleigh-Ritz pass after every filter
    round moves ``a`` to the first unwanted Ritz value.  ``mv_filt`` is the
    (possibly bfloat16) filter product, ``mv_full`` the full-precision one
    of the Rayleigh-Ritz extractions; ``polish_deg`` full-precision filter
    steps damp the bfloat16 contamination before the last extraction.
    Returns ``(evals (k,), vectors (n, k), X_next (n, m), a_next)``."""

    def rayleigh_ritz(Q):
        S = Q.T @ mv_full(Q)
        theta, W = torch.linalg.eigh(0.5 * (S + S.T))  # ascending
        return theta, Q @ W

    Q, a = X, a0
    for _ in range(rounds):
        Q, _ = torch.linalg.qr(_cheb_filter(mv_filt, Q, deg, a, b))
        theta, Q = rayleigh_ritz(Q)
        a = torch.clamp(theta[k], 1e-6 * b, 0.5 * b)
    if polish_deg > 0:
        Q, _ = torch.linalg.qr(_cheb_filter(mv_polish or mv_full, Q, polish_deg, a, b))
    theta, V = rayleigh_ritz(Q)
    a_next = torch.clamp(theta[k], 1e-6 * b, 0.5 * b)
    return theta[:k], V[:, :k], V, a_next


def _resolve_filter_dtype(filter_dtype: str, dtype):
    """'auto' -> bfloat16 filtering for float32 problems, full precision for
    float64."""
    if filter_dtype == "auto":
        return torch.bfloat16 if dtype == torch.float32 else None
    if filter_dtype == "bfloat16":
        return torch.bfloat16
    if filter_dtype in ("none", "full"):
        return None
    raise ValueError(f"unknown filter_dtype: {filter_dtype!r}")


def _blockdiag_mv(blocks, X):
    """(n/3, 3, 3) block-diagonal @ (n, w)."""
    n, w = X.shape
    return torch.matmul(blocks, X.reshape(-1, 3, w)).reshape(n, w)


def _make_operator(KR_s, cam_s, tloc_s, *, C, chunk_t, f_dtype, budget):
    """Scatter the flat operator once and build its product closures.

    Returns ``(prepare, time_products)``: ``prepare(lbd_c, lbd_t,
    inv_scale) -> (mv_full, mv_filt, mv_polish, apply_pwr)`` once per
    iteration, where ``mv_*`` multiply by the scaled Laplacian
    ``(blockdiag(Lambda_C) - R~) * inv_scale`` and ``apply_pwr`` by the raw
    ``R~``; ``time_products(r)`` is ``rt_raw[t] = sum_i M_it^T r[i]``
    (bipgo.py:318), (T_pad, 3, 3).
    """
    n_chunks = cam_s.shape[0]
    T_pad = n_chunks * chunk_t
    n = 3 * C
    dtype, dev = KR_s.dtype, KR_s.device
    bytes_full = n * 3 * T_pad * KR_s.element_size()
    bytes_filt = n * 3 * T_pad * 2 if f_dtype is not None else 0
    if bytes_full + bytes_filt > budget:
        raise NotImplementedError(
            f"the {bytes_full + bytes_filt} B operator exceeds the {budget} B "
            "budget; the streaming fallback of the large-graph route is not "
            "ported yet"
        )
    chunk_base = torch.arange(n_chunks, device=dev)[:, None] * chunk_t
    gtime = (chunk_base + tloc_s.long()).reshape(-1)
    B = block_matrix(KR_s.reshape(-1, 3, 3), cam_s.reshape(-1).long(), gtime, C, T_pad)
    Bt = filter_operator(B) if f_dtype == torch.bfloat16 else None

    def apply_full(X, lbd_t):
        w = X.shape[1]
        Z = B.T @ X
        # blockwise Lambda: a dense (3T, 3T) block-diagonal product would
        # spend ~T times its flops on zeros
        Z = torch.einsum("tab,tbw->taw", lbd_t, Z.view(T_pad, 3, w)).reshape(3 * T_pad, w)
        return B @ Z

    def prepare(lbd_c, lbd_t, inv_scale):
        def mv_full(X):
            return (_blockdiag_mv(lbd_c, X) - apply_full(X, lbd_t)) * inv_scale

        if Bt is not None:
            def mv_filt(X):
                return (_blockdiag_mv(lbd_c, X) - pwr_apply(Bt, lbd_t, X)) * inv_scale
        else:
            mv_filt = mv_full

        # The JAX package polishes with a 3-pass bfloat16 product of the
        # float32 operator (Precision.HIGH, a TPU saving); here the polish
        # product is full float32, at least as accurate.
        return mv_full, mv_filt, mv_full, lambda X: apply_full(X, lbd_t)

    def time_products(r):
        return (B.T @ r.reshape(n, 3)).reshape(T_pad, 3, 3)

    return prepare, time_products


def _subspace_init(n, m, dtype, device):
    """Deterministic orthonormal start (warm-started across iterations)."""
    ii = torch.arange(n, dtype=dtype, device=device)[:, None]
    jj = torch.arange(m, dtype=dtype, device=device)[None, :]
    X0, _ = torch.linalg.qr(torch.cos(ii * (jj + 1.0) * 0.37 + jj))
    v0 = torch.cos(torch.arange(n, dtype=dtype, device=device))[:, None]
    return X0, v0 / torch.linalg.vector_norm(v0)


def so3_sync_large(
    KR_s,
    k_s,
    cam_s,
    tloc_s,
    *,
    C: int,
    T: int,
    chunk_t: int,
    maxiter: int,
    cert_tol=1e-6,
    cheb_degree: int = 60,
    cheb_rounds: int = 2,
    cheb_degree_warm: int = 28,
    subspace: int = 10,
    filter_dtype: str = "auto",
    polish_deg: int = 6,
    materialize_budget: int = _MATERIALIZE_BUDGET_BYTES,
    device=None,
) -> SyncResult:
    """Primal-dual SO(3) sync without the dense (C, 3, T, 3) block tensor
    and without ever forming the (3C, 3C) power graph.

    Inputs are the chunked edge arrays of :func:`sort_edges_by_time` (NumPy
    or tensors).  The first iteration runs the full Chebyshev budget
    (``cheb_degree`` x ``cheb_rounds``); later ones start from the warm
    subspace with one ``cheb_degree_warm`` pass.  Mathematically the same
    iteration as :func:`vican_torch.solver.core.so3_sync` (same
    initialization, update order and certificate).  ``device`` defaults to
    the CUDA card.
    """
    device = resolve_device(device)
    no_tf32()
    KR_s = torch.as_tensor(KR_s, device=device)
    dtype = KR_s.dtype
    k_s = torch.as_tensor(k_s, device=device).to(dtype)
    cam_s = torch.as_tensor(cam_s, device=device).long()
    tloc_s = torch.as_tensor(tloc_s, device=device).long()
    f_dtype = _resolve_filter_dtype(filter_dtype, dtype)
    n_chunks = cam_s.shape[0]
    T_pad = n_chunks * chunk_t
    n = 3 * C

    gtime = (torch.arange(n_chunks, device=device)[:, None] * chunk_t + tloc_s).reshape(-1)
    deg_t = torch.zeros(T_pad, dtype=dtype, device=device).index_add_(0, gtime, k_s.reshape(-1))
    deg_c = torch.zeros(C, dtype=dtype, device=device).index_add_(
        0, cam_s.reshape(-1), k_s.reshape(-1))
    prepare, time_products = _make_operator(
        KR_s, cam_s, tloc_s, C=C, chunk_t=chunk_t, f_dtype=f_dtype,
        budget=materialize_budget,
    )

    eye3 = torch.eye(3, dtype=dtype, device=device)
    lbd_t = eye3 / torch.clamp_min(deg_t, 1e-30)[:, None, None]
    lbd_c = deg_c[:, None, None] * eye3
    r_c = eye3.expand(C, 3, 3)
    r_t = eye3.expand(T_pad, 3, 3)
    evals5 = torch.zeros(5, dtype=dtype, device=device)
    eigengap = torch.zeros((), dtype=dtype, device=device)
    ev_hist = torch.zeros(HIST_CAP, 5, dtype=dtype, device=device)
    gap_hist = torch.zeros(HIST_CAP, dtype=dtype, device=device)
    X, vmax = _subspace_init(n, subspace, dtype, device)
    lmax_raw_prev = torch.zeros((), dtype=dtype, device=device)
    a_raw_prev = torch.zeros((), dtype=dtype, device=device)
    pol = polish_deg if f_dtype is not None else 0

    it, max_eval = 0, 1.0
    while it < maxiter and max_eval > cert_tol:
        # normalize by the largest Lambda_C diagonal entry (>= max |diag L|)
        # for float32-stable filtering; eigenvalues are scaled back
        scale = torch.clamp_min(torch.diagonal(lbd_c, dim1=1, dim2=2).abs().max(), 1e-30)
        inv_scale = 1.0 / scale
        mv_full, mv_filt, mv_polish, apply_pwr = prepare(lbd_c, lbd_t, inv_scale)

        # lambda_max: a Lanczos upper bound on the first iteration, then
        # warm power refinement; the previous iteration's estimate is a
        # lower bound, so the window never shrinks below it
        if it == 0:
            lmax, vmax = _lmax_lanczos(mv_filt, vmax, 12)
        else:
            lmax, vmax = _lmax_refine(mv_filt, vmax, 4)
        lmax = torch.maximum(lmax, lmax_raw_prev * inv_scale)
        lmax_raw = lmax * scale
        b = lmax * 1.15

        # window lower edge: carried from the previous Rayleigh-Ritz,
        # 0.05 b on the first iteration
        a0 = torch.where(a_raw_prev > 0, a_raw_prev * inv_scale, 0.05 * b)
        a0 = torch.clamp(a0, 1e-6 * b, 0.5 * b)
        if it == 0:
            evals5, V5, X, a_next = _chefsi_bottom(
                mv_filt, mv_full, X, b, 5, cheb_degree, cheb_rounds, pol, a0,
                mv_polish=mv_polish)
        else:
            evals5, V5, X, a_next = _chefsi_bottom(
                mv_filt, mv_full, X, b, 5, cheb_degree_warm, 1, pol, a0,
                mv_polish=mv_polish)
        a_raw = a_next * scale
        evals5 = evals5 * scale
        eigengap = torch.abs(evals5[3] / evals5[2])

        # primal rounding (bipgo.py:295-297)
        V3 = V5[:, :3]
        r = V3 @ torch.linalg.inv(V3[:3, :3])
        r_blocks = project_so3(r.reshape(C, 3, 3))

        # camera dual (bipgo.py:300-315): width-3 matrix-free product
        rtr = apply_pwr(r_blocks.reshape(n, 3)).reshape(C, 3, 3)
        r_c, u, s, _ = svd3_so3(rtr)
        lbd_c = (u * s[:, None, :]) @ u.transpose(-1, -2)

        # time dual (bipgo.py:317-332), pseudo-inverse guard as core.so3_sync
        r_t, ut, st, _ = svd3_so3(time_products(r_c))
        st_inv = torch.where(st > 1e-9 * st[..., :1], 1.0 / torch.clamp_min(st, 1e-30), 0.0)
        lbd_t = (ut * st_inv[:, None, :]) @ ut.transpose(-1, -2)

        slot = min(it, HIST_CAP - 1)
        ev_hist[slot] = evals5
        gap_hist[slot] = eigengap
        lmax_raw_prev, a_raw_prev = lmax_raw, a_raw
        it += 1
        max_eval = float(torch.abs(evals5).max())

    return SyncResult(
        r_cam=r_c.transpose(-1, -2),
        r_time=r_t[:T].transpose(-1, -2),
        evals=evals5,
        eigengap=eigengap,
        num_iters=it,
        evals_hist=ev_hist,
        gap_hist=gap_hist,
    )
