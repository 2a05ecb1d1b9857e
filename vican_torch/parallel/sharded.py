"""Sharded solver paths over a ``torch.distributed`` mesh.

The port of ``vican_tpu.parallel.sharded``.  The JAX package places the
edge arrays sharded and lets GSPMD place the collectives; here every rank
is given the whole problem (as every JAX process serves its shards from a
full host copy), keeps its contiguous share of the edges (padded to a
multiple of the world size with zero-weight edges, which add nothing to any
sum), scatters only those, and all-reduces every sum over edges: the degree
vectors, the block operator, the CG right-hand side and operator
(``reduce=`` of :mod:`vican_torch.solver.core`).  The camera state is
replicated.  Results come back as host arrays, as in JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from ..solver import core
from ..utils import no_tf32, resolve_device

__all__ = ["so3_sync_sharded", "se3sync_sharded", "pad_to_multiple"]


def pad_to_multiple(arr: np.ndarray, multiple: int, axis: int = 0, fill=0):
    """Pad ``arr`` along ``axis`` to the next multiple (shard evenness)."""
    n = arr.shape[axis]
    rem = (-n) % multiple
    if rem == 0:
        return arr
    widths = [(0, 0)] * arr.ndim
    widths[axis] = (0, rem)
    return np.pad(arr, widths, constant_values=fill)


def _group(mesh):
    """``(group, rank, world size, reduce)`` of a 1-D mesh; ``reduce(x)``
    sums ``x`` over the ranks in place and returns it.  Anything but a
    ``DeviceMesh`` raises ``TypeError``."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    if not isinstance(mesh, DeviceMesh):
        raise TypeError(f"mesh must be a torch.distributed DeviceMesh "
                        f"(vican_torch.parallel.make_mesh), not {type(mesh).__name__}")
    group = mesh.get_group()

    def reduce(x):
        dist.all_reduce(x, group=group)
        return x

    return group, dist.get_rank(group), dist.get_world_size(group), reduce


def _my_edges(world: int, rank: int, arrays, device):
    """This rank's contiguous share of each per-edge array, zero-padded to
    a multiple of ``world``, as tensors on ``device``."""
    out = []
    for a in arrays:
        a = pad_to_multiple(np.ascontiguousarray(a), world)
        n = a.shape[0] // world
        out.append(torch.as_tensor(a[rank * n:(rank + 1) * n], device=device))
    return out


def _host(result: core.SyncResult) -> core.SyncResult:
    return core.SyncResult(*(x.cpu().numpy() if isinstance(x, torch.Tensor) else x
                             for x in result))


def so3_sync_sharded(KR, k_r, cam_idx, time_idx, *, C, T, maxiter, mesh, dtype=np.float32,
                     device=None):
    """:func:`vican_torch.solver.core.so3_sync` with the edges split over
    the ranks of ``mesh``; the degrees and the block operator are
    all-reduced, the camera block replicated.  Returns the ``SyncResult``
    as host arrays."""
    device = resolve_device(device)
    no_tf32()
    _, rank, world, reduce = _group(mesh)
    KR, k_r = _my_edges(world, rank, (np.asarray(KR, dtype), np.asarray(k_r, dtype)), device)
    cam, tim = (x.long() for x in _my_edges(world, rank, (cam_idx, time_idx), device))
    return _host(core.so3_sync(KR, k_r, cam, tim, C=C, T=T, maxiter=maxiter, reduce=reduce))


def se3sync_sharded(packed, *, maxiter, mesh, dtype=np.float32,
                    lsqr_solver="conjugate_gradient", device=None):
    """The whole SE(3) sync of a packed problem with the edges split over
    the ranks of ``mesh``: :func:`vican_torch.solver.core.se3sync_full`
    (``lsqr_solver="conjugate_gradient"``), or the rotations, the
    translation measurements and LSQR (``"direct"``).  Returns ``(r_cam,
    r_time, t_est, residual)`` as host arrays, cameras first in ``t_est``,
    on every rank."""
    device = resolve_device(device)
    no_tf32()
    _, rank, world, reduce = _group(mesh)
    C, T = packed.num_cams, packed.num_times
    tdt = torch.float64 if np.dtype(dtype) == np.float64 else torch.float32
    # rotations as matrices: a zero-padded quaternion would not fold to zero
    R_e, t_e, k_r, k_t = (x.to(tdt) for x in _my_edges(
        world, rank, (packed.R_e, packed.t_e, packed.k_r, packed.k_t), device))
    cam, tim, mk = (x.long() for x in _my_edges(
        world, rank, (packed.cam_idx, packed.time_idx, packed.marker_idx), device))
    R_con = torch.as_tensor(np.asarray(packed.R_con), device=device).to(tdt)
    t_con = torch.as_tensor(np.asarray(packed.t_con), device=device).to(tdt)
    if lsqr_solver == "conjugate_gradient":
        result, poses, res = core.se3sync_full(
            R_e, t_e, k_r, k_t, cam, tim, mk, R_con, t_con, root_idx=packed.root_idx,
            C=C, T=T, maxiter=maxiter, reduce=reduce)
        t_est = poses[:, :3, 3]
    else:
        KR = core.fold_constraints(R_e, k_r, mk, R_con, packed.root_idx)
        result = core.so3_sync(KR, k_r, cam, tim, C=C, T=T, maxiter=maxiter, reduce=reduce)
        t_tilde = core.translation_rhs(result.r_cam, result.r_time, t_e, k_t, cam, tim, mk,
                                       R_con, t_con, packed.root_idx)
        t_est, res = core.solve_translations_lsqr(t_tilde, k_t, cam, tim, C=C, T=T,
                                                  reduce=reduce)
    return (result.r_cam.cpu().numpy(), result.r_time.cpu().numpy(), t_est.cpu().numpy(),
            float(res))
