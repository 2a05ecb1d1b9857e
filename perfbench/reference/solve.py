"""Camera-network synchronization, plain PyTorch: the reference of the
solve cells.

The semantics of the upstream ``bipartite_se3sync`` (its bipgo.py:145-350
and 420-481), from the problem's arrays:

1. keep the edges whose reprojection error is under the bound; weights
   ``k_r = k_t = 1`` (the cells' noise models);
2. fold the marker constraints into each edge, ``KR_e = k_r R_e R_m^T R_0``
   (``R_0`` the constraint of the lexicographically least marker id), into
   the operator ``B (3C, 3T)`` whose (camera, timestep) block sums its
   edges' ``KR_e``;
3. the primal-dual iteration, ``maxiter`` times (or until every one of the
   five eigenvalues is under 1e-6): from ``Lambda_T = I / deg_t`` and
   ``Lambda_C = deg_c I``, the five eigenpairs of ``L = blockdiag(Lambda_C)
   - B Lambda_T B^T`` nearest -1e-6; the primal ``r = V_3 V_3[:3]^-1``
   projected onto SO(3) block by block; the camera dual from the SVD of ``B
   Lambda_T B^T r`` (rotation ``U diag(1, 1, det) V^T``, ``Lambda_C = U S
   U^T``); the time dual from the SVD of ``B^T r_C`` (``Lambda_T = U S^+
   U^T``, singular values under 1e-9 of the largest dropped);
4. translations: the least-squares solution of least norm of ``x_t - x_c
   = R_c t_e + R_t R_0^T R_m R_m^T (t_0 - t_m)`` over the edges.

Every step is direct, with no stopping rule: ``L`` is formed densely and
decomposed whole (``eigh``), and the translations' normal equations are
solved by eliminating the timesteps (their block is diagonal) and
factoring the cameras' Schur complement.  In float64 that is the answer of
these steps to rounding.  With ``control=True`` the same code in float32,
with every product's operands rounded to TF32, is the control.
"""
from __future__ import annotations

import numpy as np
import torch


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to TF32's 10-bit mantissa (to nearest, ties
    to even): what a TF32 tensor core multiplies.  cuBLAS takes TF32 for
    large products only, and a scatter or a small batched product never, so
    the control rounds the operands of every product itself."""
    i = x.contiguous().view(torch.int32)
    i = (i + 0x0FFF + ((i >> 13) & 1)) & -0x2000
    return i.view(torch.float32)


def _same(x):
    return x


def _so3(x):
    """Closest rotations of ``(..., 3, 3)`` blocks and their SVD."""
    u, s, vt = torch.linalg.svd(x)
    d = torch.linalg.det(u @ vt)
    fix = torch.stack([torch.ones_like(d), torch.ones_like(d), d], dim=-1)
    return (u * fix[..., None, :]) @ vt, u, s


def solve(arrays: dict, config: dict, device, control: bool = False) -> dict:
    """World poses of every camera and timestep: ``{"r_cam" (C, 3, 3),
    "t_cam" (C, 3), "r_time" (T, 3, 3), "t_time" (T, 3), "iterations"}``,
    numpy float64, indexed by camera and timestep number."""
    prob = Problem(arrays, config, device, control)
    r_cam, r_time, it = prob.sync()
    x = prob.translations(r_cam, r_time)
    host = lambda y: y.double().cpu().numpy()  # noqa: E731
    return {"r_cam": host(r_cam), "t_cam": host(x[:prob.C]), "r_time": host(r_time),
            "t_time": host(x[prob.C:]), "iterations": it}


class Problem:
    """A problem's edges, folded and weighted, on ``device``: in float64,
    or for the control in float32 with TF32 products."""

    def __init__(self, arrays: dict, config: dict, device, control: bool = False):
        dt = torch.float32 if control else torch.float64
        self.config, self.device, self.dt = config, device, dt
        r = self.rnd = to_tf32 if control else _same
        C, T = self.C, self.T = config["n_cams"], config["n_times"]
        keep = np.asarray(arrays["errs"]) < config["max_reprojected_err"]
        f = lambda x: torch.as_tensor(np.asarray(x)[keep], device=device).to(dt)  # noqa: E731
        i = lambda x: torch.as_tensor(np.asarray(x)[keep], device=device).long()  # noqa: E731
        self.t_e, self.ci, self.ti, mi = f(arrays["t"]), i(arrays["ci"]), i(arrays["ti"]), \
            i(arrays["mi"])
        Rm = torch.as_tensor(arrays["Rm"], device=device).to(dt)
        tm = torch.as_tensor(arrays["tm"], device=device).to(dt)
        root = min(range(len(Rm)), key=str)
        R0, t0 = Rm[root], tm[root]
        E = len(self.ci)
        self.k_r = torch.full((E,), config["noise_model_r"], dtype=dt, device=device)
        self.k_t = torch.full((E,), config["noise_model_t"], dtype=dt, device=device)
        KR = self.k_r[:, None, None] * torch.einsum("eij,ekj,kl->eil", r(f(arrays["R"])),
                                                    r(Rm[mi]), r(R0))
        # B (3C, 3T), dense: a (camera, timestep) block sums its edges' KR
        a = torch.arange(3, device=device)
        rows = 3 * self.ci[:, None, None] + a[None, :, None]
        cols = 3 * self.ti[:, None, None] + a[None, None, :]
        self.B = torch.zeros(3 * C * 3 * T, dtype=dt, device=device).index_add_(
            0, (rows * (3 * T) + cols).reshape(-1), KR.reshape(-1)).view(3 * C, 3 * T)
        # the markers' offsets in the root marker's frame, R_0^T R_m R_m^T (t_0 - t_m)
        self.offset = torch.einsum("ji,ejk,ek->ei", r(R0), r(Rm[mi]),
                                   r(torch.einsum("eji,ej->ei", r(Rm[mi]), r(t0 - tm[mi]))))

    def power(self, lbd_t):
        """``B Lambda_T B^T`` (3C, 3C)."""
        r, C, T = self.rnd, self.C, self.T
        Y = torch.einsum("rtb,tbd->rtd", r(self.B).view(3 * C, T, 3), r(lbd_t))
        return r(Y.reshape(3 * C, 3 * T)) @ r(self.B).T

    def time_products(self, r_c):
        """``B^T r_C``, a (3, 3) block a timestep."""
        return (self.rnd(self.B).T @ self.rnd(r_c).reshape(3 * self.C, 3)).view(self.T, 3, 3)

    def sync(self):
        """The rotation stage: ``(r_cam (C, 3, 3), r_time (T, 3, 3),
        iterations)``."""
        C, T, dt, dev, r = self.C, self.T, self.dt, self.device, self.rnd
        eye = torch.eye(3, dtype=dt, device=dev)
        deg_c = torch.zeros(C, dtype=dt, device=dev).index_add_(0, self.ci, self.k_r)
        deg_t = torch.zeros(T, dtype=dt, device=dev).index_add_(0, self.ti, self.k_r)
        lbd_c = deg_c[:, None, None] * eye
        lbd_t = eye / deg_t[:, None, None]
        it, max_eval = 0, 1.0
        r_c = r_t = None
        while it < self.config["maxiter"] and max_eval > 1e-6:
            pwr = self.power(lbd_t)
            L = -pwr
            diag = torch.diagonal(L.view(C, 3, C, 3), dim1=0, dim2=2)
            diag += lbd_c.permute(1, 2, 0)
            evals, V = torch.linalg.eigh(0.5 * (L + L.T))
            sel = torch.argsort(torch.abs(evals + 1e-6), stable=True)[:5]
            evals, V = evals[sel], V[:, sel]
            V3 = V[:, :3]
            primal = r(V3) @ r(torch.linalg.inv(V3[:3]))
            project = _so3(primal.reshape(C, 3, 3))[0]
            rtr = (r(pwr) @ r(project.reshape(3 * C, 3))).reshape(C, 3, 3)
            r_c, u, s = _so3(rtr)
            lbd_c = r(u * s[:, None, :]) @ r(u.transpose(-1, -2))
            r_t, ut, st = _so3(self.time_products(r_c))
            st_inv = torch.where(st > 1e-9 * st[..., :1], 1.0 / torch.clamp_min(st, 1e-30),
                                 torch.zeros_like(st))
            lbd_t = r(ut * st_inv[:, None, :]) @ r(ut.transpose(-1, -2))
            it += 1
            max_eval = float(evals.abs().max())
        return r_c.transpose(-1, -2), r_t.transpose(-1, -2), it

    def time_rotations(self, r_cam):
        """The last step of the rotation stage from given camera rotations:
        each timestep's rotation, the closest to ``B^T r_C``."""
        r_c = torch.as_tensor(r_cam, device=self.device).to(self.dt).transpose(-1, -2)
        return _so3(self.time_products(r_c))[0].transpose(-1, -2)

    def _normal(self, r_cam, r_time):
        """The translations' normal equations ``A^T A x = A^T t~`` for given
        rotations: ``(matvec, right-hand side)``."""
        C, T, dt, dev, ci, ti = self.C, self.T, self.dt, self.device, self.ci, self.ti
        r_cam = torch.as_tensor(r_cam, device=dev).to(dt)
        r_time = torch.as_tensor(r_time, device=dev).to(dt)
        r = self.rnd
        rhs = self.k_t[:, None] * (torch.einsum("eij,ej->ei", r(r_cam[ci]), r(self.t_e))
                                   + torch.einsum("eij,ej->ei", r(r_time[ti]), r(self.offset)))
        kt2 = self.k_t * self.k_t

        def scatter(z):
            return torch.cat([-torch.zeros((C, 3), dtype=dt, device=dev).index_add_(0, ci, z),
                              torch.zeros((T, 3), dtype=dt, device=dev).index_add_(0, ti, z)])

        return (lambda x: scatter(kt2[:, None] * (x[C:][ti] - x[:C][ci])),
                scatter(self.k_t[:, None] * rhs))

    def translations(self, r_cam, r_time):
        """The least-squares translations of least norm, cameras then
        timesteps, ``(C + T, 3)``: ``A^T A = [[D_c, -W], [-W^T, D_t]]``
        with ``D_t`` diagonal, so the cameras solve ``(D_c - W D_t^-1 W^T)
        x_c = b_c + W D_t^-1 b_t`` (camera 0 held at 0: the graph is
        connected and the system consistent), the timesteps follow, and
        the mean over every node is taken off (the null space)."""
        C, T, dt, dev, r = self.C, self.T, self.dt, self.device, self.rnd
        _, b = self._normal(r_cam, r_time)
        kt2 = self.k_t * self.k_t
        Wm = torch.zeros(C * T, dtype=dt, device=dev).index_add_(
            0, self.ci * T + self.ti, kt2).view(C, T)
        d_c = Wm.sum(1)
        d_t_inv = 1.0 / Wm.sum(0)
        WD = r(Wm) * r(d_t_inv)[None]
        S = torch.diag(d_c) - r(WD) @ r(Wm).T
        rhs = b[:C] + r(WD) @ r(b[C:])
        x_c = torch.zeros((C, 3), dtype=dt, device=dev)
        x_c[1:] = torch.linalg.solve(S[1:, 1:], rhs[1:])
        x_t = d_t_inv[:, None] * (b[C:] + r(Wm).T @ r(x_c))
        x = torch.cat([x_c, x_t])
        return x - x.mean(0)

    def residual(self, r_cam, r_time, t):
        """The relative residual ``|A^T A x - A^T t~| / |A^T t~|`` of
        translations ``t (C + T, 3)`` for given rotations."""
        normal, b = self._normal(r_cam, r_time)
        x = torch.as_tensor(t, device=self.device).to(self.dt)
        return float(torch.linalg.vector_norm(normal(x) - b) / torch.linalg.vector_norm(b))
