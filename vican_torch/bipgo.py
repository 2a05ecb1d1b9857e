"""Bipartite pose-graph optimization: the public API on PyTorch.

Drop-in counterparts of ``vican_tpu.bipgo`` (reference vican/bipgo.py):

- :func:`bipartite_se3sync`        (bipgo.py:353-490)
- :func:`object_bipartite_se3sync` (bipgo.py:493-545)
- :func:`large_bipartite_so3sync`  (bipgo.py:145-350), rotations only
- :func:`bipartite_so3sync`        (bipgo.py:18-142), the reference's
  small-graph variant with its own conventions

Same edge-dict input, same callable hooks (``noise_model_r/t`` and
``edge_filter``, evaluated per edge on the host), same ``{node: SE3}``
output keyed by camera id and ``"<t>_0"`` (the rotation-only entry points
return (3, 3) arrays under the same keys).  One new keyword, ``device``:
``None`` means the CUDA card, and raises when there is none.

Two routes, chosen as the JAX package chooses them (``_use_scale_path``):
the dense route (:mod:`.solver.core`, a dense ``eigh`` per iteration) up
to ``VICAN_TPU_SCALE_MIN_CAMS`` cameras (default 1024) while the
(C,3,T,3) block tensor fits ``VICAN_TPU_BLOCK_BUDGET_BYTES`` (default
2 GiB); past either, the large-graph route (:mod:`.solver.scale`, CheFSI
on the matrix-free power graph, whose float32 filter runs on the CUDA
kernel of :mod:`.solver.pwr`; past the 6 GB operator budget, its streaming
regime, on the kernel of :mod:`.solver.mv`).  Translations are solved on
the device by CG or LSQR in the requested dtype on both routes; float64
computes in float64 on the device.

``mesh=`` (a ``DeviceMesh`` of :mod:`vican_torch.parallel`, one card per
rank) splits the large-graph route's time chunks over the ranks
(:func:`.solver.scale.so3_sync_large_sharded`); the translations and the
dense route run whole on every rank.
"""
from __future__ import annotations

import os
import warnings
from functools import partial
from typing import Callable

import numpy as np
import torch

from .geometry import SE3
from .solver import core as _core
from .solver.packing import PackedProblem, pack_problem
from .utils import PhaseTimer, no_tf32, resolve_device

__all__ = [
    "bipartite_se3sync",
    "object_bipartite_se3sync",
    "large_bipartite_so3sync",
    "bipartite_so3sync",
]


def _solver_dtype(dtype) -> np.dtype:
    """float32 or float64; both compute natively on the card."""
    dtype = np.dtype(dtype)
    if dtype not in (np.float32, np.float64):
        raise ValueError(f"unsupported solver dtype {dtype}; use float32 or float64")
    return dtype


def _log_sync_result(tm: PhaseTimer, result) -> None:
    """Per-iteration eigenvalues and eigengap (the reference's tqdm postfix,
    bipgo.py:336-340), then the summary line."""
    n = int(result.num_iters)
    if result.evals_hist is not None:
        eh = result.evals_hist.cpu().numpy()
        gh = result.gap_hist.cpu().numpy()
        shown = min(n, eh.shape[0])
        for i in range(shown):
            # past the history capacity the last slot holds the last iteration
            label = f"{i + 1}/{n}" if (n <= eh.shape[0] or i < shown - 1) else f"{n}/{n}"
            tm.log("  it {}: evals: {}  eigengap: {:1.3e}".format(
                label, np.array2string(eh[i], precision=3), float(gh[i])))
        if n > eh.shape[0]:
            tm.log(f"  (per-iteration history capped at {eh.shape[0]} rows; "
                   f"iterations {shown}..{n - 1} not recorded)")
    tm.log("Iterations: {}  evals: {}  eigengap: {:1.3e}".format(
        n, result.evals.cpu().numpy(), float(result.eigengap)))


def _device_arrays(packed: PackedProblem, dtype: torch.dtype, device) -> dict:
    """Per-edge arrays on the device; rotations as quaternions when the
    packer verified them (reconstructed exactly in the fold)."""
    rot = packed.q_e if packed.q_e is not None else packed.R_e

    def f(x):
        return torch.as_tensor(np.ascontiguousarray(x), device=device).to(dtype)

    def i(x):
        return torch.as_tensor(np.ascontiguousarray(x), device=device).long()

    return dict(
        R_e=f(rot), t_e=f(packed.t_e), k_r=f(packed.k_r), k_t=f(packed.k_t),
        cam_idx=i(packed.cam_idx), time_idx=i(packed.time_idx),
        marker_idx=i(packed.marker_idx), R_con=f(packed.R_con), t_con=f(packed.t_con),
    )


def _block_budget_bytes() -> int:
    """Memory budget for the dense (C, 3, T, 3) block tensor; past it the
    dict API reroutes to the large-graph route.  ``VICAN_TPU_BLOCK_BUDGET_BYTES``
    overrides it (read per call)."""
    return int(os.environ.get("VICAN_TPU_BLOCK_BUDGET_BYTES", 2 << 30))


def _use_scale_path(C: int, T: int, dtype) -> bool:
    """Large-graph route on memory grounds (the dense block tensor past
    :func:`_block_budget_bytes`) or eigensolver-size grounds (a dense
    O((3C)^3) ``eigh`` per iteration past ``VICAN_TPU_SCALE_MIN_CAMS``
    cameras, default 1024)."""
    block_bytes = C * T * 9 * np.dtype(dtype).itemsize
    min_cams = int(os.environ.get("VICAN_TPU_SCALE_MIN_CAMS", 1024))
    return block_bytes > _block_budget_bytes() or C > min_cams


def _solve_translations(result, arrs, packed, lsqr_solver, C, T, counters=None):
    """Translation stage (bipgo.py:420-481) from the synced rotations;
    ``counters`` receives the CG's or LSQR's ``iterations`` and
    ``host_reads``."""
    t_tilde = _core.translation_rhs(
        result.r_cam, result.r_time, arrs["t_e"], arrs["k_t"], arrs["cam_idx"],
        arrs["time_idx"], arrs["marker_idx"], arrs["R_con"], arrs["t_con"],
        packed.root_idx,
    )
    solve = (_core.solve_translations_cg if lsqr_solver == "conjugate_gradient"
             else _core.solve_translations_lsqr)
    return solve(t_tilde, arrs["k_t"], arrs["cam_idx"], arrs["time_idx"], C=C, T=T,
                 counters=counters)


def _poses_out(packed, result, t_est) -> dict:
    """``{node: SE3}`` from the device results, one host copy; the SE3s are
    views of one (C+T, 4, 4) array in the solver dtype."""
    C, T = packed.num_cams, packed.num_times
    N = C + T
    poses = torch.zeros((N, 4, 4), dtype=t_est.dtype, device=t_est.device)
    poses[:C, :3, :3] = result.r_cam
    poses[C:, :3, :3] = result.r_time
    poses[:, :3, 3] = t_est
    poses[:, 3, 3] = 1.0
    poses = poses.cpu().numpy()
    from_pose = SE3._from_pose_view
    out = {}
    for i, c in enumerate(packed.cam_ids):
        out[c] = from_pose(poses[i])
    for j, t in enumerate(packed.time_ids):
        out[t + "_0"] = from_pose(poses[C + j])
    return out


def _fold_and_chunk(packed: PackedProblem, dtype):
    """The large-graph route's host preparation: fold the constraints into
    the edge blocks and group the edges into time chunks (~8 by default,
    ``VICAN_TPU_SCALE_CHUNK_T`` timesteps each when set).  Returns
    ``(chunked arrays of scale.sort_edges_by_time, chunk_t)``."""
    from .solver import scale as _scale

    T = packed.num_times
    chunk_t = int(os.environ.get("VICAN_TPU_SCALE_CHUNK_T", 0)) or min(
        T, max(64, -(-T // 8)))
    R0 = packed.R_con[packed.root_idx]
    Rm = packed.R_con[packed.marker_idx]
    R_fold = np.matmul(packed.R_e, np.matmul(Rm.transpose(0, 2, 1), R0))
    KR = packed.k_r[:, None, None] * R_fold
    chunked = _scale.sort_edges_by_time(
        KR.astype(dtype), packed.k_r.astype(dtype),
        packed.cam_idx, packed.time_idx, T, chunk_t,
    )
    return chunked, chunk_t


def _so3_sync_large_from_packed(packed: PackedProblem, dtype, maxiter, tm, verbose, device,
                                mesh=None):
    """Rotation stage of the large-graph route: fold on the host, chunk by
    time, solve on the device, or on every card of ``mesh`` with the chunks
    split over them.  Returns a :class:`~.solver.core.SyncResult`."""
    from .solver import scale as _scale

    C, T = packed.num_cams, packed.num_times
    with tm.phase("Folding constraints (host, chunked)"):
        chunked, chunk_t = _fold_and_chunk(packed, dtype)
    block_bytes = C * T * 9 * np.dtype(dtype).itemsize
    reason = ("block-tensor budget exceeded" if block_bytes > _block_budget_bytes()
              else "camera count past the dense-eigh threshold")
    tm.log("Large-graph path: {} chunks of {} timesteps ({})".format(
        chunked[0].shape[0], chunk_t, reason))
    solve = (_scale.so3_sync_large if mesh is None
             else partial(_scale.so3_sync_large_sharded, mesh=mesh))
    with tm.phase("Optimizing (chunked power graph)") as counts:
        result = solve(*chunked, C=C, T=T, chunk_t=chunk_t, maxiter=maxiter,
                       cert_tol=1e-6 / packed.k_r_scale, device=device, counters=counts)
    if verbose:
        _log_sync_result(tm, result)
    return result


def _start(src_edges, constraints, noise_model_r, noise_model_t, edge_filter,
           dtype, verbose, device, mesh=None, timer=None):
    """What every entry point does first: check ``mesh`` (``None`` or a
    ``DeviceMesh``, else ``TypeError``), resolve the device (``None`` is the
    card), turn TF32 off, check the dtype, log the graph's size and pack the
    edge dict.  ``timer``: the caller's :class:`PhaseTimer`, or None for a
    new one on the device that prints when ``verbose``.  Returns
    ``(device, dtype, torch dtype, timer, packed)``."""
    if mesh is not None:
        from .parallel.sharded import _group

        _group(mesh)
    device = resolve_device(device)
    no_tf32()
    dtype = _solver_dtype(dtype)
    tdt = torch.float64 if dtype == np.float64 else torch.float32
    tm = timer or PhaseTimer(verbose=verbose, device=device)
    if verbose:  # the node-count set over 2E keys is pure logging cost
        tm.log("Received graph with {} nodes {} edges".format(
            len({n for e in src_edges for n in e}), len(src_edges)))
    with tm.phase("Applying constraints"):
        packed = pack_problem(
            src_edges, constraints, noise_model_r, noise_model_t, edge_filter, dtype=dtype
        )
    return device, dtype, tdt, tm, packed


def bipartite_se3sync(
    src_edges: dict,
    constraints: dict,
    noise_model_r: Callable,
    noise_model_t: Callable,
    edge_filter: Callable,
    maxiter: int,
    lsqr_solver: str = "conjugate_gradient",
    dtype=np.float32,
    verbose: bool = True,
    mesh=None,
    device=None,
    timer: PhaseTimer | None = None,
) -> dict:
    """SE(3) synchronization in large bipartite graphs with node constraints.

    Rotations by the power-graph primal-dual sync; translations from the
    weighted incidence least-squares system, solved matrix-free on the
    device (``lsqr_solver``: ``"conjugate_gradient"`` for CG on the normal
    equations, ``"direct"`` for LSQR, bipgo.py:476-480).  Returns
    ``{node: SE3}`` world-frame poses for cameras and ``"<t>_0"`` object
    nodes.  ``mesh``: a ``DeviceMesh`` of :mod:`vican_torch.parallel`, run
    on every one of its ranks; the large-graph route splits its time chunks
    over the ranks' cards and every rank solves the translations on its
    own, so every rank returns the whole result (the dense route ignores
    ``mesh``, as in JAX).  ``device``: where the solve runs; ``None`` is
    the CUDA card (the rank's own under a mesh).  ``timer`` collects the
    phases (:func:`_start`).  On the dense route "Optimizing + solving
    (device)" holds "Folding constraints (device)", "Rotation sync
    (device)" and "Translations (device)"; the last two count their
    ``iterations`` and ``host_reads``, as the large-graph route's
    "Optimizing (chunked power graph)" and "Solving translations
    (matrix-free)" do.
    """
    if lsqr_solver not in ("conjugate_gradient", "direct"):
        raise ValueError(
            f"unknown lsqr_solver: {lsqr_solver!r}; "
            "expected 'conjugate_gradient' or 'direct'"
        )
    device, dtype, tdt, tm, packed = _start(
        src_edges, constraints, noise_model_r, noise_model_t, edge_filter, dtype, verbose,
        device, mesh, timer)
    tm.log("Bipartite graph: {} cameras, {} timesteps, {} edges.".format(
        packed.num_cams, packed.num_times, packed.num_edges))

    C, T = packed.num_cams, packed.num_times
    if _use_scale_path(C, T, dtype):
        result = _so3_sync_large_from_packed(packed, dtype, maxiter, tm, verbose, device, mesh)
        with tm.phase("Solving translations (matrix-free)") as translations:
            arrs = _device_arrays(packed, tdt, device)
            t_est, res = _solve_translations(result, arrs, packed, lsqr_solver, C, T,
                                             translations)
    else:
        with tm.phase("Optimizing + solving (device)"):
            with tm.phase("Folding constraints (device)"):
                arrs = _device_arrays(packed, tdt, device)
                KR = _core.fold_constraints(
                    arrs["R_e"], arrs["k_r"], arrs["marker_idx"], arrs["R_con"],
                    packed.root_idx,
                )
            with tm.phase("Rotation sync (device)") as rotations:
                result = _core.so3_sync(
                    KR, arrs["k_r"], arrs["cam_idx"], arrs["time_idx"], C=C, T=T,
                    maxiter=maxiter, cert_tol=1e-6 / packed.k_r_scale, counters=rotations,
                )
            with tm.phase("Translations (device)") as translations:
                t_est, res = _solve_translations(result, arrs, packed, lsqr_solver, C, T,
                                                 translations)
        if verbose:
            _log_sync_result(tm, result)
    if verbose:
        tm.log("Translation iterations: {}".format(translations["iterations"]))
    res = float(res)
    if res > 1e-3:
        warnings.warn(f"translation solve residual {res:.3e} (poorly converged)")
    out = _poses_out(packed, result, t_est)
    tm.log("Done!")
    return out


def large_bipartite_so3sync(
    src_edges: dict,
    constraints: dict,
    noise_model: Callable,
    edge_filter: Callable,
    maxiter: int,
    dtype=np.float32,
    verbose: bool = True,
    mesh=None,
    device=None,
    timer: PhaseTimer | None = None,
) -> dict:
    """SO(3) synchronization in large bipartite graphs with node constraints:
    the rotation stage of :func:`bipartite_se3sync` alone, on the same two
    routes.  Edge keys are ``(camera_id, "<t>_<marker>")``; values carry at
    least ``"pose"``.  Returns world-frame (3, 3) rotations keyed by camera
    id and ``"<t>_0"``.  ``mesh``: as in :func:`bipartite_se3sync` (a
    keyword the JAX function lacks).  ``device``: where the solve runs;
    ``None`` is the CUDA card.  ``timer``: as in :func:`bipartite_se3sync`."""
    device, dtype, tdt, tm, packed = _start(
        src_edges, constraints, noise_model, lambda e: 1.0, edge_filter, dtype, verbose,
        device, mesh, timer)
    tm.log("Bipartite graph: {} cameras, {} timesteps, {} edges.".format(
        packed.num_cams, packed.num_times, packed.num_edges))
    C, T = packed.num_cams, packed.num_times
    if _use_scale_path(C, T, dtype):
        result = _so3_sync_large_from_packed(packed, dtype, maxiter, tm, verbose, device, mesh)
    else:
        with tm.phase("Optimizing") as rotations:
            arrs = _device_arrays(packed, tdt, device)
            KR = _core.fold_constraints(
                arrs["R_e"], arrs["k_r"], arrs["marker_idx"], arrs["R_con"],
                packed.root_idx,
            )
            result = _core.so3_sync(
                KR, arrs["k_r"], arrs["cam_idx"], arrs["time_idx"], C=C, T=T,
                maxiter=maxiter, cert_tol=1e-6 / packed.k_r_scale, counters=rotations,
            )
        if verbose:
            _log_sync_result(tm, result)
    r_cam = result.r_cam.cpu().numpy()
    r_time = result.r_time.cpu().numpy()
    out = {c: r_cam[i] for i, c in enumerate(packed.cam_ids)}
    out.update({t + "_0": r_time[j] for j, t in enumerate(packed.time_ids)})
    return out


def bipartite_so3sync(
    src_edges: dict,
    constraints: dict,
    noise_model: Callable,
    edge_filter: Callable,
    maxiter: int,
    dtype=np.float32,
    verbose: bool = True,
    device=None,
    timer: PhaseTimer | None = None,
) -> dict:
    """SO(3) sync on the full bipartite connection Laplacian: the
    reference's small-graph variant (bipgo.py:18-142), with its own
    conventions kept (:func:`.solver.core.so3_sync_small`): folding
    ``R_e @ R_m @ R_0^T``, a (3n, 3n) Laplacian over cameras and time nodes,
    one ``U S U^T`` dual for every node, exactly ``maxiter`` iterations and
    untransposed (3, 3) output blocks keyed by camera id and ``"<t>_0"``.
    Nodes are ordered as the reference orders its ``'c<id>'``/``'t<id>'``
    names, cameras first.  O((3(C+T))^3) per iteration: for small graphs.
    ``device``: where the solve runs; ``None`` is the CUDA card.
    ``timer``: as in :func:`bipartite_se3sync`."""
    device, dtype, tdt, tm, packed = _start(
        src_edges, constraints, noise_model, lambda e: 1.0, edge_filter, dtype, verbose,
        device, timer=timer)
    C, T = packed.num_cams, packed.num_times
    n = C + T
    if verbose:
        tm.log("New SO(3) graph contains {} nodes {} edges".format(n, packed.num_edges))
    with tm.phase("Optimizing (full bipartite Laplacian)"):
        arrs = _device_arrays(packed, tdt, device)
        KR = _core.fold_constraints_small(
            arrs["R_e"], arrs["k_r"], arrs["marker_idx"], arrs["R_con"], packed.root_idx,
        )
        # packed ids are sorted and every 'c*' name sorts before every 't*'
        # one, so the reference's node order is [cameras..., times...]
        r, evals, eigengap = _core.so3_sync_small(
            KR, arrs["k_r"], arrs["cam_idx"], C + arrs["time_idx"], n=n, maxiter=maxiter,
        )
        r = r.cpu().numpy()
    if verbose:
        tm.log("Eigenvalues: {}  eigengap: {:1.3e}".format(
            evals.cpu().numpy(), float(eigengap)))
    out = {c: r[i] for i, c in enumerate(packed.cam_ids)}
    out.update({t + "_0": r[C + j] for j, t in enumerate(packed.time_ids)})
    return out


def object_bipartite_se3sync(
    src_edges: dict,
    noise_model_r: Callable,
    noise_model_t: Callable,
    edge_filter: Callable,
    maxiter: int,
    lsqr_solver: str = "conjugate_gradient",
    dtype=np.float32,
    verbose: bool = True,
    device=None,
    timer: PhaseTimer | None = None,
) -> dict:
    """Calibrate a marker object from a single static camera.

    Re-keys edges so markers play the "camera" role and each frame the
    "time" role, with inverted poses (bipgo.py:524-531), then runs
    :func:`bipartite_se3sync` with an identity constraint on the lowest
    marker id.  Returns only the marker poses (keys without ``"_"``), in
    the root-marker frame.  ``timer``: as in :func:`bipartite_se3sync`.
    """
    edges = {}
    root = str(min(int(e[1].split("_")[1]) for e in src_edges))
    for (t_key, tm_key), v in src_edges.items():
        t, marker_id = tm_key.split("_")
        new_v = dict(v)
        new_v["pose"] = v["pose"].inv()
        edges[(marker_id, t + "_" + root)] = new_v

    out = bipartite_se3sync(
        edges,
        constraints={root: SE3(pose=np.eye(4))},
        noise_model_r=noise_model_r,
        noise_model_t=noise_model_t,
        edge_filter=edge_filter,
        maxiter=maxiter,
        lsqr_solver=lsqr_solver,
        dtype=dtype,
        verbose=verbose,
        device=device,
        timer=timer,
    )
    return {k: v for k, v in out.items() if "_" not in k}
