"""Smoke test of the PyTorch/CUDA port (``vican_torch``) on one NVIDIA GPU.

Run from the repository root on a machine with a CUDA card and ``nvcc``:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``vican_torch/csrc`` (one ``nvcc``
per source, all at once) and the C modules, holds each kernel against
its plain PyTorch version at the main paths' shapes (``pwr_apply`` at cells
B's and C's in both its designs, one read and two; ``thin_mv`` also at the
shape of the JAX package's matvec probe; ``pnp_block`` on seeded slots and
on the perception scene's first batch; ``detect_candidates`` on that batch
at each refine kind) and times both with each kernel's device split, then
drives two paths:

- the solver, ``vican_torch.bipgo.bipartite_se3sync``, on three synthetic
  problems: A, bench.py's large_shop problem (100 cameras, 10k timesteps,
  120k edges), the dense route, checked against the JAX package's accuracy
  on the same problem; B, 10k cameras / 10k timesteps / 1M edges, the
  large-graph route, whose CheFSI filter runs on the ``pwr_apply`` kernel;
  C, 2048 cameras / 10k timesteps / 240k edges through both routes, which
  must agree; D, 10k cameras / 12k timesteps / 1.2M edges, whose operator
  passes the 6 GB budget, so the large-graph route streams and filters on
  the ``thin_mv`` kernel, checked against the materialized regime on the
  same packed problem; every problem packed by the C packer;
- perception in its default mode, ``vican_torch.perception.
  estimate_pose_gray``, on 384 frames at 1280x720 (8 cameras around a
  24-marker cube, 48 timesteps, rendered on the card by
  ``vican_torch.render``), thresholded by the ``multi_threshold`` kernel and
  labeled, gated and re-fit by the C module in one call a batch on the
  pipeline's feed thread over the host's cores, refined, decoded and
  deduplicated by the ``detect_candidates`` kernels and PnP solved by the
  ``pnp_block`` kernel once a batch (:func:`pnp_phase` and
  :func:`detect_phase` then hold them to their plain versions on the
  scene's first batch); the same frames on the CPU
  must give the same
  detections, the edges must be accurate against ground truth, and
  ``bipartite_se3sync`` on them must recover all 8 cameras; then the
  ``host`` mode (host threshold, no kernel launch) over the same frames and
  ``roi`` and ``auto`` over 64 of them must give the same edges; then the
  feed/drain pipeline (:func:`pipeline_phase`: the default depth and depth
  1 in turns, identical edges, each run's feed, drain and overlap seconds;
  the frames as JPEG files through ``cam.estimate_pose_mp`` where cv2
  imports; a ``torch.profiler`` trace of 96 frames); then the
  ``pure`` mode (:func:`pure_phase`: the components, candidates and re-fit
  on the card too) over those 64 frames, held to the ``device`` run and to
  the CPU;
- the sharded solve, :func:`mesh_phase`: in a child process, one rank over
  NCCL, ``bipartite_se3sync(mesh=make_mesh())`` on cell C's problem, whose
  large-graph route runs ``pwr_apply`` on the rank's chunks, against
  ``mesh=None``, ``se3sync_sharded`` on cell A's against
  ``bipartite_se3sync``, and ``cam.estimate_pose_mp(mesh=...)`` on 64 of
  the scene's frames against ``mesh=None``;
- the tutorial flow (examples/tutorial.py, the reference's main.ipynb),
  :func:`tutorial_phase`: a 250-frame cube capture and a 4-camera,
  252-frame room capture rendered on the card at 1280x720, the tutorial's
  preprocess on the host, detection in the default mode, the cube's 24
  markers calibrated from its capture, the camera network solved from the
  room's detections and evaluated against ground truth; the first 8 room
  frames on the CPU must give the same detections and the room's edge dict
  must survive ``save_edges``/``load_edges``.

One JSON line per phase; any failed check raises, so the exit code is not
0.  The last lines are the card's ``nvidia-smi`` name and power limit, the
kernels' JSON line, and ``{"ok": true, "device": {...}}``.  Without a CUDA
card, or without the rest of the repository beside it, it fails before
printing any result.

Every perception run must launch the detect and PnP kernels once per
batch and find its host candidates with the C labeler and the C gates.

``python3 chip_smoke.py --perception`` builds the threshold, PnP and
detect kernels and the C modules, runs the perception phases and, where the checkout has the
host modes, :func:`perception_modes`, and stops (it also runs in an older
checkout, to time its perception in the same call);
``python3 chip_smoke.py --kernels`` stops after the kernel phases;
``python3 chip_smoke.py --split`` only times each solver kernel through its
public wrapper (:func:`split_phase`), so a copy of this file times an
older checkout's kernels too; ``python3 chip_smoke.py --threshold`` builds
the threshold kernel, renders the 32 frames its phase needs, runs
:func:`threshold_phase` (it too runs in an older checkout), then, where
the checkout has the launch plan, :func:`threshold_sweep`, and stops;
``python3 chip_smoke.py --tutorial`` builds the threshold, PnP and detect
kernels and the C modules, runs :func:`tutorial_phase`, and stops; ``--pnp`` builds
the same, renders 32 frames and runs :func:`pnp_phase` alone; ``--pure``
builds the same, runs the perception phases and :func:`pure_phase`, with ``--save
PATH`` writes the pure phase's frames and both modes' edges to ``PATH``
(:func:`save_pure_frames`), and stops;
``--detect`` builds the same, renders 32 frames and runs
:func:`detect_phase` alone;
``--mesh`` builds ``pwr.cu``, the threshold, PnP and detect kernels and
the C modules, runs :func:`mesh_phase`, and stops; ``--pipeline`` builds the
threshold, PnP and detect kernels and the C modules,
renders the perception scene, runs it once to warm up, then
:func:`pipeline_phase`, and stops.
"""
from __future__ import annotations

import contextlib
import importlib.util
import io
import json
import os
import re
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

# bench.py's CONFIG and hooks (bench.py:40-49)
CONFIG_A = dict(seed=0, n_cams=100, n_times=10_000, n_markers=24, n_edges=120_000,
                kappa_r=1e4, sigma_t=1e-3)
CONFIG_B = dict(seed=0, n_cams=10_000, n_times=10_000, n_edges=1_000_000)
CONFIG_C = dict(seed=1, n_cams=2048, n_times=10_000, n_edges=240_000)
# cell B's density (100 edges per timestep) over a 20% longer capture: the
# (3C, 3T) operator and its bf16 copy, 6.48 GB, pass the 6 GB budget
CONFIG_D = dict(seed=2, n_cams=10_000, n_times=12_000, n_edges=1_200_000)
MAXITER = 4


def _one(e):
    return 1.0


def _filt(e):
    return e["reprojected_err"] < 0.05


# Config A through vican_tpu.bipgo.bipartite_se3sync (float32, dense route),
# measured with JAX on the CPU (JAX_PLATFORMS=cpu VICAN_TPU_WIRE=fused), with
# bench.py's accuracy(): gauge-aligned mean camera errors against ground truth.
JAX_A_ROT_DEG = 0.24737583009352426
JAX_A_TRANS_M = 0.028339771405383067
A_ROT_TOL_DEG = 0.01
A_TRANS_TOL_M = 1e-3
KERNEL_REL_TOL = 1e-3  # max |kernel - plain| / max |plain|; see kernel_phase
# thin_mv: the same exact bf16 products summed in another float32 order;
# the probe's own bar (mv_kernel_probe.py:12-14, 107)
MV_REL_TOL = 1e-5
PROBE_SHAPE = (30208, 31744, 128)  # M, K, w of mv_kernel_probe.py:73

# Published peaks of one H100 SXM at its 700 W limit (NVIDIA's data sheet,
# dense): device-memory bytes/s and bf16 tensor-core FLOP/s; and its int32
# and fp32 rates, 64 INT32 and 128 FP32 lanes per SM (Hopper architecture
# white paper) x 132 SMs x the 1.98 GHz boost clock.  The card's name and
# power limit are printed beside every time.
PEAK_BYTES_S = 3.35e12
PEAK_BF16_FLOPS = 989e12
PEAK_INT32_OPS = 64 * 132 * 1.98e9
PEAK_FP32_OPS = 128 * 132 * 1.98e9
# float64 outside the tensor cores (NVIDIA's data sheet); the 67 TFLOP/s
# of its float64 tensor cores are for matrix products, which PnP's small
# dependent solves are not
PEAK_FP64_FLOPS = 34e12

# PnP (csrc/pnp.cu): float64 operations of one valid slot, tallied from the
# kernel's source: each +, -, x, / and each sqrt, sin, cos, acos counts
# one; a product or quotient of two dual numbers with six tangents 19, a
# sum 7.  An LM trip: the dual Rodrigues (387), four dual projections
# (2196), the J^T J, J^T r and cost sums (456), the damped 6x6 solve (209),
# the trial step and its cost (265), the update (3); a pass adds so3_log
# and the closing Rodrigues (71); IPPE: the 8-trip undistortion (1488),
# the homography's 8x8 solve (444), the rest of IPPE with both candidates
# and their translations (972); the iterative method's initialization: the
# undistortion, the homography, the SVD projection (1456) and the rest
# (33); the reprojection error (220).  The bound counts the valid slots
# only: the kernel returns at once from the others.
PNP_FLOPS = dict(lm_trip=3516, lm_pass=71, ippe=2904, iterative_init=3421, error=220)
# Kernel vs plain bars (float64): the LM stops anywhere in the float64
# basin of its minimum (where the cost no longer tells two poses apart), so
# two float64 implementations of it land up to ~7e-8 apart in a pose entry
# on the few ill-conditioned slots (small, far markers); the plain version
# batched against itself slot by slot differs by 3.5e-8 on the CPU.  The
# bar on every slot is 15x that; the median gap must stay at rounding level.
PNP_TOL = 1e-6             # R entries, t (m), reprojection error (px)
PNP_MEDIAN_TOL = 1e-10     # median R-entry and t gaps
PNP_MARKER = 0.138         # tests/test_torch_pnp.py's scene
PNP_DIST = np.array([-0.25, 0.08, 1.5e-3, -1.2e-3, -0.012, -0.02, 0.004, -0.001,
                     0.0, 0.0, 0.0, 0.0, 0.0, 0.0])
PNP_SEEDED = (171, 24)     # cameras x slots: 4104 seeded slots a case

# Detect (csrc/detect.cu): float64 operations tallied from the kernel's
# source, each +, -, x, /, sqrt, floor, min and max one.  A bilinear
# sample 23 (the clamps 4, floors 2, fractions 2, weights 4, products 8,
# sums 3); the edge fit a probe offset: the position 4, the two probes' 8
# and their samples, the weight 2, the sums 6; an (edge, sample) 20 more
# and a slot 250 for the fits and intersections; a cornerSubPix pixel in a
# trip: the position 2, four samples, the gradients 4, the products 18, a
# corner-trip's solve 20; a decode attempt a sample: the position 2, the
# homography's 14, the sample, the min and max 2, the bin 4, the mean,
# majority 2; a cell 4, Otsu 15 a bin; the dictionary: xor, popcount and
# compare a code, counted at the int32 rate; the homography's LU 460.
# The bound counts this run's data: valid slots, second attempts, and each
# corner's cornerSubPix trips (the kernel returns at once from a slot that
# is not valid).
DETECT_OPS = dict(bilinear=23, probe=20, edge_sample=20, slot_fit=250, subpix_pixel=24,
                  subpix_solve=20, sample=27, cell=4, otsu_bin=15, code=3, homography=460)
# Kernel vs plain bars: ids, valid and scores identical on every output
# slot; the corners of the kept slots within DETECT_TOL px (they differ
# by the sum order of the fits, ~1e-12 px); every slot's within the
# card-vs-CPU bar, since cornerSubPix on a rejected candidate's
# ill-conditioned window moves its corners ~1e-6 px under a sum order
# (9.8e-7 px seen in a host-C++ build of the kernel).
DETECT_TOL = 1e-6
DETECT_ALL_TOL = 1e-3
DETECT_KINDS = ("apriltag", "subpix", "none")

# Perception scene: the JAX package's perception-bench recipe
# (vican_tpu/synthetic.py:273-323: f = 0.55 (W + H), the 24-marker cube of
# 0.48 * 0.575 m markers tumbling about (0, 0, 1), wander=True, seed 4, 48
# timesteps at 1280x720) seen by 8 cameras 2.2-2.6 m away, two of them with
# the 12-coefficient distortion of tests/test_perception.py:132.
SCENE_RES = (1280, 720)
SCENE_FRAMES = 48
SCENE_MARKER = 0.48 * 0.575
SCENE_DIST = np.array([-0.25, 0.08, 1.5e-3, -1.2e-3, -0.012, -0.02, 0.004, -0.001,
                       0.0, 0.0, 0.0, 0.0])
SCENE_DISTORTED = ("1", "5")
PERCEPTION_KW = dict(aruco="DICT_4X4_1000", marker_size=SCENE_MARKER,
                     corner_refine="CORNER_REFINE_APRILTAG", flags="SOLVEPNP_IPPE_SQUARE",
                     batch_size=32, verbose=False)

# Tutorial flow (examples/tutorial.py's synthetic mode, the reference's
# main.ipynb): its marker size, ids, 4-camera rig (examples/tutorial.py:72-74,
# wander, seed 1) and cube-calibration camera, at an eighth of the reference
# captures' scale, both at 1280x720: 250 cube frames (the reference's
# cube_calib has 2000) and 63 room timesteps over 4 cameras, 252 frames
# (the notebook's tmax of 2000 timesteps would be 8000 frames).  At 2000 +
# 2000 frames the phase took 318 s on an H100, over its ~300 s share of the
# smoke's time; once the pure and mesh phases came, the smoke read 421 s
# with 1000 + 1000 frames (T 121 s) and 367 s with 500 + 500 (T 84 s), past
# its ~330 s.
TUTORIAL_MARKER = 0.138
TUTORIAL_IDS = [str(i) for i in range(24)]
TUTORIAL_RIG = [(3, 0, 1.2), (0, 3, 1.5), (-3, 0, 1.0), (0, -3, 1.3)]
TUTORIAL_CUBE_POS = (1.1, 0.2, 1.1)
TUTORIAL_CUBE_FRAMES = 250
TUTORIAL_ROOM_STEPS = 63
TUTORIAL_TMAX = 2000
TUTORIAL_RES = (1280, 720)
TUTORIAL_PREPROCESS = dict(brightness=-150.0, contrast=120.0)
TUTORIAL_KW = dict(aruco="DICT_4X4_1000", marker_size=TUTORIAL_MARKER,
                   corner_refine="CORNER_REFINE_APRILTAG", flags="SOLVEPNP_IPPE_SQUARE",
                   batch_size=32, verbose=False)
RENDER_CHUNK = 64  # frames rendered on the card per call


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def _rate_ms(fn, reps: int = 50) -> float:
    """ms per call over ``reps`` warm calls launched back to back between
    two CUDA events: the device time of a steady stream of calls, the host's
    launch work hidden behind the device's as in the solver's filter loop."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _device_ms(fn, reps: int = 50) -> float:
    """ms per call of ``reps`` warm calls queued behind ~0.1 s of device
    sleep, so the host has enqueued them all before the first runs: the
    device time alone, where a call's host work is as long as its kernel."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _median_ms(fn, reps: int = 20) -> float:
    """Median of ``reps`` warm launches, each timed alone with CUDA events:
    the device time plus the host's launch work before the first kernel."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def accuracy(prob, est):
    """bench.py's accuracy(): gauge-aligned mean rotation (deg) and
    translation (m) errors of the cameras against ground truth."""
    from vican_torch.geometry import distance_SO3, optimize_gauge_SE3

    valid = [c for c in prob.cams_gt if c in est]
    G = optimize_gauge_SE3([prob.cams_gt[c].inv() for c in valid],
                           [est[c].inv() for c in valid])
    r = [distance_SO3(np.asarray(prob.cams_gt[c].R(), np.float64),
                      np.asarray((G.inv() @ est[c]).R(), np.float64)) for c in valid]
    t = [np.linalg.norm(prob.cams_gt[c].t() - (G.inv() @ est[c]).t()) for c in valid]
    return float(np.mean(r)), float(np.mean(t))


def _last_packer() -> str | None:
    """Which packer the last pack_problem call ran ("c" or "python")."""
    from vican_torch.solver import packing

    return packing.last_packer


def _check_packer() -> None:
    """Raise unless the last pack_problem call ran the C packer."""
    if _last_packer() != "c":
        raise AssertionError(f"packed by the {_last_packer()} packer, not the C one")


@contextlib.contextmanager
def _env(**env):
    """Environment variables set for the body, restored after it."""
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def solve(prob, **env):
    """One timed bipartite_se3sync call, packed by the C packer; returns
    (poses, seconds, log lines)."""
    import torch

    from vican_torch import bipgo

    buf = io.StringIO()
    with _env(**env):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            est = bipgo.bipartite_se3sync(
                prob.edges, constraints=prob.constraints(), noise_model_r=_one,
                noise_model_t=_one, edge_filter=_filt, maxiter=MAXITER,
                lsqr_solver="conjugate_gradient", dtype=np.float32, verbose=True,
            )
        seconds = time.perf_counter() - t0
        _check_packer()
    return est, seconds, buf.getvalue().splitlines()


def _ptxas_functions(log: str) -> dict:
    """Each function of nvcc's ``-Xptxas -v`` report, by (mangled) name:
    whether it is a kernel, and its registers, shared memory, stack frame
    and spill bytes where the report gives them."""
    per, name = {}, None
    for line in log.splitlines():
        m = re.search(r"(Compiling entry function|Function properties for) '?([^'\s]+)", line)
        if m:
            name = m.group(2)
            per.setdefault(name, {"kernel": False})["kernel"] |= m.group(1).startswith("Comp")
            continue
        if name is not None:
            for key, pat in (("registers", r"Used (\d+) registers"),
                             ("smem", r"(\d+) bytes smem"),
                             ("stack_frame", r"(\d+) bytes stack frame"),
                             ("spill_stores", r"(\d+) bytes spill stores"),
                             ("spill_loads", r"(\d+) bytes spill loads")):
                m = re.search(pat, line)
                if m:
                    per[name][key] = int(m.group(1))
    return per


def _ptxas_summary(log: str) -> dict:
    """Kernel count, most registers and shared memory of any kernel, and
    the functions that spill, from nvcc's ``-Xptxas -v`` report."""
    per = _ptxas_functions(log)
    kernels = [v for v in per.values() if v["kernel"]]
    return {
        "kernels": len(kernels),
        "max_registers": max((v.get("registers", 0) for v in kernels), default=0),
        "max_smem": max((v.get("smem", 0) for v in kernels), default=0),
        "spilling": sorted(k for k, v in per.items() if v.get("spill_stores")),
    }


def _kernel_split(fn, reps: int = 10) -> dict:
    """Device ms per call of each kernel ``fn`` launches (``torch.profiler``
    over ``reps`` warm calls), keyed by the kernel's name."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    split = {}
    for e in prof.key_averages():
        us = getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0)
        if us > 0:
            split[e.key[:90]] = us / reps * 1e-3
    return split


def filter_problem(dev, cfg: dict):
    """``(Bt, lbd, n, T)`` built like the main path's at ``cfg``'s size:
    random 3x3 rotation blocks on the config's edges in a (3C, 3T)
    operator, every camera and timestep touched; Lambda_T the
    degree-normalized initial time dual plus a random non-symmetric part,
    so a transposed Lambda would show."""
    import torch

    from vican_torch.ops.lie import quat_to_mat
    from vican_torch.solver.core import block_matrix
    from vican_torch.solver.pwr import filter_operator

    C, T, E = cfg["n_cams"], cfg["n_times"], cfg["n_edges"]
    g = torch.Generator(device=dev).manual_seed(0)
    cam = torch.randint(0, C, (E,), generator=g, device=dev)
    tim = torch.randint(0, T, (E,), generator=g, device=dev)
    cam[:C] = torch.arange(C, device=dev)
    tim[-T:] = torch.arange(T, device=dev)
    blocks = quat_to_mat(torch.randn((E, 4), generator=g, device=dev))
    Bt = filter_operator(block_matrix(blocks, cam, tim, C, T))
    deg_t = torch.zeros(T, device=dev).index_add_(0, tim, torch.ones(E, device=dev))
    lbd = torch.eye(3, device=dev) / deg_t[:, None, None]
    lbd = lbd + 0.1 * torch.rand((T, 3, 3), generator=g, device=dev) * lbd[:, :1, :1]
    return Bt, lbd, 3 * C, T


def split_phase(dev) -> None:
    """Each hand kernel of the solver through its public wrapper alone,
    ``pwr_apply`` at cells B's and C's shapes (w = 1, 10, 16) and
    ``thin_mv`` at :func:`thin_mv_cases`: ms per call and the device ms of
    each kernel it launches.  Touches no option of the wrappers, so the same
    lines time an earlier design of the kernels
    (``python3 chip_smoke.py --split``)."""
    import torch

    from vican_torch.solver.mv import thin_mv
    from vican_torch.solver.pwr import pwr_apply

    def timed(fn):
        return dict(ms=_rate_ms(fn), launch_ms=_median_ms(fn), kernels=_kernel_split(fn))

    for cell, cfg in (("B", CONFIG_B), ("C", CONFIG_C)):
        Bt, lbd, n, T = filter_problem(dev, cfg)
        g = torch.Generator(device=dev).manual_seed(1)
        for w in (1, 10, 16):
            X = torch.randn((n, w), generator=g, device=dev)
            emit("pwr_split", cell=cell, shape=[3 * T, n, w],
                 **timed(lambda: pwr_apply(Bt, lbd, X)))
        del Bt, lbd
        torch.cuda.empty_cache()
    for case, B, X in thin_mv_cases(dev):
        emit("thin_mv_split", case=case, shape=[*B.shape, X.shape[1]],
             **timed(lambda: thin_mv(B, X)))
    torch.cuda.empty_cache()


def kernel_phase(dev):
    """pwr_apply against its plain version at cells B's and C's shapes
    (10k and 2048 cameras, 10k timesteps) on operators built like the main
    path's (:func:`filter_problem`) and an orthonormal X, in both designs
    (one read of Bt and two), each timed beside the bound, the plain
    version and two library matmuls, with its kernels' device split.

    The bar, 1e-3 of max |Y|: the kernel sums Z = B^T X in float32 in
    another order than cuBLAS, which can flip the bf16 rounding of single
    entries of W = Lambda Z.  One flip moves every Y entry it touches by
    2^-8 |W_q| |B_qi|; with ~300 nonzeros per column of this operator that
    is ~6e-5 of max |Y| (1.2e-4 measured at w=10 on an H100).  1e-3 admits
    a dozen flips on one entry; an indexing or masking fault shows at O(1).
    Returns the rows of the design the wrapper picks, keyed by (cell, w).
    """
    import torch

    from vican_torch import _kernels
    from vican_torch.solver import pwr
    from vican_torch.solver.pwr import pwr_apply, pwr_apply_plain, pwr_plan, single_capacity
    from vican_torch.solver.tiles import SINGLE_P

    rows = {}
    for cell, cfg in (("B", CONFIG_B), ("C", CONFIG_C)):
        Bt, lbd, n, T = filter_problem(dev, cfg)
        g = torch.Generator(device=dev).manual_seed(0)

        def library(X):
            # yardstick only: two bf16 matmuls with the blockwise Lambda between
            w = X.shape[1]
            Z = torch.matmul(Bt[:, :n], X.to(torch.bfloat16)).float()
            Z = torch.einsum("tab,tbw->taw", lbd, Z.view(T, 3, w)).reshape(3 * T, w)
            return torch.matmul(Bt[:, :n].T, Z.to(torch.bfloat16))

        for w in (1, 10, 16):
            X, _ = torch.linalg.qr(torch.randn((n, w), generator=g, device=dev))
            ref = pwr_apply_plain(Bt, lbd, X)
            plain_ms = _rate_ms(lambda: pwr_apply_plain(Bt, lbd, X))
            library_ms = _rate_ms(lambda: library(X))
            nbytes = Bt.numel() * 2 + n * w * 2 + T * 9 * 4 + n * w * 4
            ops = 2 * 2 * 3 * T * n * w
            t_bytes, t_ops = nbytes / PEAK_BYTES_S, ops / PEAK_BF16_FLOPS
            occ = pwr.phase_occupancy(dev, w)
            picked = pwr_plan(n, T, w, _kernels.sm_count(dev), None, occ).design
            for design in ("single", "two"):
                plan = pwr_plan(n, T, w, _kernels.sm_count(dev), design, occ)
                if design == "single":
                    sp = plan.single
                    how = dict(cs=sp.cs, panel_timesteps=SINGLE_P, cols_per_cta=sp.cc, smem=sp.smem,
                               clusters=min(sp.clusters, single_capacity(sp.cs, w, sp.mt, dev)))
                else:
                    how = dict(splits=[plan.phase1.splits, plan.phase2.splits])
                out = pwr_apply(Bt, lbd, X, design=design)
                torch.cuda.synchronize()
                abs_err = float((out - ref).abs().max())
                rel_err = abs_err / float(ref.abs().max())
                again = pwr_apply(Bt, lbd, X, design=design)
                if not (rel_err < KERNEL_REL_TOL and torch.isfinite(out).all()):
                    raise AssertionError(f"pwr_apply {cell} w={w} {design}: rel err {rel_err}")
                if not torch.equal(out, again):
                    raise AssertionError(f"pwr_apply {cell} w={w} {design}: not bit for bit")
                row = dict(w=w, design=design, picked=design == picked, plan=how,
                           max_abs_err=abs_err, max_rel_err=rel_err,
                           ms=_rate_ms(lambda: pwr_apply(Bt, lbd, X, design=design)),
                           launch_ms=_median_ms(lambda: pwr_apply(Bt, lbd, X, design=design)),
                           plain_ms=plain_ms, library_ms=library_ms,
                           bound_ms=max(t_bytes, t_ops) * 1e3,
                           bound_by="bytes" if t_bytes >= t_ops else "operations",
                           bytes=nbytes, ops=ops,
                           split=_kernel_split(lambda: pwr_apply(Bt, lbd, X, design=design)))
                emit("kernel", name="pwr_apply", cell=cell, shape=[3 * T, n, w], **row)
                if design == picked:
                    rows[cell, w] = row
        del Bt, lbd
        torch.cuda.empty_cache()
    return rows


def thin_mv_phase(dev) -> dict:
    """thin_mv against its plain version at the probe's shape (its cos
    operands, mv_kernel_probe.py:73-81), at the streaming regime's (a
    30000^2 symmetric bf16 operator, w = 10 and 1) and at a ragged shape
    (M, K not multiples of 8), each timed beside its bound and a library
    yardstick.  Returns the rows keyed by case."""
    import torch

    from vican_torch.solver import mv
    from vican_torch.solver.mv import thin_mv, thin_mv_plain
    from vican_torch.solver.tiles import mma_plan, n_tiles

    rows = {}

    def check(case, B, X):
        M, K = B.shape
        w = X.shape[1]
        out = thin_mv(B, X)
        torch.cuda.synchronize()
        ref = thin_mv_plain(B, X)
        abs_err = float((out - ref).abs().max())
        rel_err = abs_err / float(ref.abs().max())
        if not (rel_err < MV_REL_TOL and torch.isfinite(out).all()):
            raise AssertionError(f"thin_mv {case}: rel err {rel_err} >= {MV_REL_TOL}")
        Xb = X.to(torch.bfloat16)
        ms = _rate_ms(lambda: thin_mv(B, X))
        launch_ms = _median_ms(lambda: thin_mv(B, X))
        plain_ms = _rate_ms(lambda: thin_mv_plain(B, X))
        # yardstick only, never called by the port: cuBLAS accumulates in
        # float32 but rounds Y to bfloat16
        library_ms = _rate_ms(lambda: torch.matmul(B, Xb))
        nbytes = M * K * 2 + K * w * 2 + M * w * 4
        ops = 2 * M * K * w
        t_bytes, t_ops = nbytes / PEAK_BYTES_S, ops / PEAK_BF16_FLOPS
        again = thin_mv(B, X)
        if not torch.equal(out, again):
            raise AssertionError(f"thin_mv {case}: not bit for bit")
        rows[case] = dict(shape=[M, K, w], max_abs_err=abs_err, max_rel_err=rel_err, ms=ms,
                          launch_ms=launch_ms, plain_ms=plain_ms, library_ms=library_ms,
                          split=_kernel_split(lambda: thin_mv(B, X)),
                          plan=mma_plan(M, K, w, mv._slots(dev, n_tiles(w))).__dict__,
                          bound_ms=max(t_bytes, t_ops) * 1e3,
                          bound_by="bytes" if t_bytes >= t_ops else "operations",
                          bytes=nbytes, ops=ops, vector_rows=B.stride(0) % 8 == 0)
        emit("thin_mv_kernel", case=case, library="torch.matmul, bf16 out (yardstick)",
             **rows[case])

    for case, B, X in thin_mv_cases(dev):
        check(case, B, X)
    torch.cuda.empty_cache()
    return rows


def thin_mv_cases(dev):
    """The operands of :func:`thin_mv_phase`, one case at a time:
    ``(case, B, X)``."""
    import torch

    from vican_torch.solver.mv import aligned_bf16

    g = torch.Generator(device=dev).manual_seed(3)
    # the probe's operands (mv_kernel_probe.py:72-81)
    M, K, w = PROBE_SHAPE
    fi = lambda k: torch.arange(k, dtype=torch.float32, device=dev)  # noqa: E731
    B = torch.cos(fi(M)[:, None] * 1e-3 + fi(K)[None, :] * 1e-5).to(torch.bfloat16)
    X = torch.cos(fi(K)[:, None] + fi(w)[None, :]).to(torch.bfloat16)
    yield "probe", B, X
    del B, X

    # the streaming regime's operator: symmetric, 3C = 30000
    n = 3 * CONFIG_D["n_cams"]
    R = torch.randn((n, n), generator=g, device=dev)
    S = torch.add(R, R.T, out=torch.empty_like(R))
    del R
    B = aligned_bf16(S)
    del S
    for w in (10, 1):
        X, _ = torch.linalg.qr(torch.randn((n, w), generator=g, device=dev))
        yield f"streaming w={w}", B, X
    del B

    B = aligned_bf16(torch.randn((n - 1, n + 1), generator=g, device=dev))
    X = torch.randn((n + 1, 10), generator=g, device=dev)
    yield "ragged", B, X


def config_d_phase(dev) -> dict:
    """Config D through bipartite_se3sync: past the 6 GB operator budget,
    so the large-graph route's streaming regime, whose filter runs on the
    thin_mv kernel.  Then D's packed problem through scale.so3_sync_large
    twice, materialized (pwr_apply) and streaming under ``torch.profiler``,
    which must agree."""
    import torch

    from torch.profiler import ProfilerActivity, profile, record_function

    from vican_torch import bipgo
    from vican_torch.ops.lie import distance_so3
    from vican_torch.solver import packing, scale
    from vican_torch.solver.mv import thin_mv
    from vican_torch.solver.pwr import pwr_apply
    from vican_torch.synthetic import make_problem_arrays

    C, T = CONFIG_D["n_cams"], CONFIG_D["n_times"]
    t0 = time.perf_counter()
    prob = make_problem_arrays(**CONFIG_D)
    gen_s = time.perf_counter() - t0
    assert bipgo._use_scale_path(C, T, np.float32)
    torch.cuda.reset_peak_memory_stats()
    thin_mv.launches = pwr_apply.launches = 0
    est, solve_s, log = solve(prob)
    launches = {"thin_mv": thin_mv.launches, "pwr_apply": pwr_apply.launches}
    peak = torch.cuda.max_memory_allocated()
    r_err, t_err = accuracy(prob, est)
    R = np.stack([est[c].R() for c in prob.cams_gt]).astype(np.float64)
    ortho = float(np.abs(R @ R.transpose(0, 2, 1) - np.eye(3)).max())
    finite = all(np.isfinite(p.pose()).all() for p in est.values())
    emit("config_D", route="large-graph, streaming", gen_s=gen_s, solve_s=solve_s,
         rot_err_deg=r_err, trans_err_m=t_err, kernel_launches=launches,
         packer=_last_packer(), max_memory_allocated=peak, ortho_err=ortho, log=log)
    if not any("Large-graph path" in line for line in log):
        raise AssertionError("config D did not take the large-graph route")
    if launches["thin_mv"] <= 0 or launches["pwr_apply"] != 0:
        raise AssertionError(f"config D did not stream through thin_mv: {launches}")
    if not (finite and ortho < 1e-4 and r_err < 3.0):
        raise AssertionError(f"config D: finite={finite} ortho={ortho} rot_err={r_err}")
    del est

    # D's packed problem, folded and chunked as the large-graph route does,
    # through both regimes of so3_sync_large
    packed = packing.pack_problem(prob.edges, prob.constraints(), _one, _one, _filt,
                                  dtype=np.float32)
    del prob
    chunked, chunk_t = bipgo._fold_and_chunk(packed, np.float32)
    kw = dict(C=packed.num_cams, T=packed.num_times, chunk_t=chunk_t, maxiter=MAXITER,
              cert_tol=1e-6 / packed.k_r_scale, device=dev)
    out = {}
    for regime, budget in (("materialized", int(1e10)),
                           ("streaming", scale._MATERIALIZE_BUDGET_BYTES)):
        thin_mv.launches = pwr_apply.launches = 0
        torch.cuda.synchronize()
        # the streaming solve is traced: where its device time goes
        trace = (profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
                 if regime == "streaming" else contextlib.nullcontext())
        with trace as prof, record_function(f"{regime} solve"):
            t0 = time.perf_counter()
            res = scale.so3_sync_large(*chunked, materialize_budget=budget, **kw)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
        out[regime] = dict(seconds=seconds, r_cam=res.r_cam,
                           evals=res.evals.cpu().tolist(),
                           launches={"thin_mv": thin_mv.launches,
                                     "pwr_apply": pwr_apply.launches})
    del res
    trace = _trace_summary(prof, "streaming solve", "thin::")
    d = distance_so3(out["streaming"]["r_cam"].double(), out["materialized"]["r_cam"].double())
    d_max = float(d.max())
    emit("config_D_regimes", max_cam_rot_diff_deg=d_max,
         mean_cam_rot_diff_deg=float(d.mean()),
         **{k: {key: v[key] for key in ("seconds", "launches", "evals")}
            for k, v in out.items()},
         streaming_trace=trace)
    if (out["streaming"]["launches"]["pwr_apply"] or not out["streaming"]["launches"]["thin_mv"]
            or not out["materialized"]["launches"]["pwr_apply"]):
        raise AssertionError(f"config D regimes took the wrong kernels: {out}")
    if not d_max < 0.25:
        raise AssertionError(f"config D: streaming and materialized differ by {d_max} deg")
    return {"launches": launches["thin_mv"], "solve_s": solve_s}


def _trace_summary(prof, range_prefix: str, tag: str) -> dict:
    """Device time by kernel in a ``torch.profiler`` trace, and the share of
    the host range whose name starts with ``range_prefix`` during which the
    card ran a kernel; ``tag_kernels_s`` sums the kernels whose names hold
    ``tag``.  Empty when the trace holds no device work (not measured)."""
    from torch.autograd import DeviceType

    events = prof.events()
    # host ranges also appear on the device timeline, under their host
    # names: keep only device work
    host_names = {e.name for e in events if e.device_type == DeviceType.CPU}
    kernels = [e for e in events
               if e.device_type == DeviceType.CUDA and e.name not in host_names]
    rng = next((e for e in events if e.name.startswith(range_prefix)), None)
    if not kernels or rng is None:
        return {"device_kernels": len(kernels)}
    lo, hi = rng.time_range.start, rng.time_range.end
    busy, end = 0.0, lo
    for s, e in sorted((max(k.time_range.start, lo), min(k.time_range.end, hi))
                       for k in kernels):
        if e > max(s, end):
            busy += e - max(s, end)
            end = e
    by_name: dict = {}
    for k in kernels:
        by_name[k.name] = by_name.get(k.name, 0.0) + (k.time_range.end - k.time_range.start)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    return dict(
        device_kernels=len(kernels), range_s=(hi - lo) * 1e-6, device_busy_s=busy * 1e-6,
        device_busy_share=busy / (hi - lo),
        tag_kernels_s=sum(v for n, v in by_name.items() if tag in n) * 1e-6,
        all_kernels_s=sum(by_name.values()) * 1e-6,
        top_kernels=[[n[:80], v * 1e-6] for n, v in top],
    )


def profile_phase(prob) -> dict:
    """Cell B's solve again under ``torch.profiler`` with the solver's
    phase ranges on: device time by kernel, and the share of the
    large-graph solve phase during which the card ran a kernel."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, seconds, log = solve(prob, VICAN_TPU_TRACE="1")
    summary = _trace_summary(prof, "Optimizing (chunked", "pwr_")
    if "range_s" in summary:
        summary["solve_phase_s"] = summary.pop("range_s")
        summary["pwr_kernels_s"] = summary.pop("tag_kernels_s")
    return {"traced_solve_s": seconds, "log": log, **summary}


def perception_scene(dev, timesteps: int = SCENE_FRAMES):
    """The smoke's perception scene over its first ``timesteps``, rendered
    on ``dev``: ``(cams, traj, markers, frames (8 timesteps, 720, 1280)
    uint8, names, frame_cams)``."""
    from vican_torch import render
    from vican_torch.cam import Camera

    W, H = SCENE_RES
    f = 0.55 * (W + H)
    K = np.array([[f, 0, W / 2.0], [0, f, H / 2.0], [0, 0, 1.0]])
    cams = {}
    for k in range(8):
        az, r = 2 * np.pi * k / 8, 2.2 + 0.4 * k / 7
        pos = (r * np.cos(az), r * np.sin(az), 1.0 + 0.3 * (-1) ** k)
        dist = SCENE_DIST if str(k) in SCENE_DISTORTED else np.zeros(12)
        cams[str(k)] = Camera(id=str(k), intrinsics=K, distortion=dist.copy(),
                              extrinsics=render.look_at(pos, (0.0, 0.0, 1.0)),
                              resolution_x=W, resolution_y=H)
    traj = render.cube_trajectory(timesteps, seed=4, wander=True)
    markers = render.make_cube_markers()
    frames, names, frame_cams = render.render_frames(cams, traj, markers,
                                                     marker_size=SCENE_MARKER, device=dev)
    return cams, traj, markers, frames, names, frame_cams


def threshold_phase(frames, ptxas: str = "") -> dict:
    """multi_threshold against its plain version (0 differing bytes) on a
    32-frame batch of the scene, at ragged shapes and on a view at an odd
    storage offset, timed beside its bound, the plain version and a library
    yardstick; ``ptxas``: the kernel's ``-Xptxas -v`` report.  Reads only
    the wrapper and, where the checkout has it, its launch plan, so it also
    times an older checkout's kernel (``--threshold``)."""
    import torch
    import torch.nn.functional as F

    from vican_torch.ops import threshold as th
    from vican_torch.ops.threshold import (WIN_SIZES, multi_threshold,
                                           multi_threshold_plain, pack_bits)

    C = 10.0
    batch = frames[:32].contiguous()
    ragged = _ragged(batch)
    cases = {"scene 32x720x1280": batch, "ragged 2x721x1283": ragged,
             "B=1": batch[:1].contiguous(), "odd offset 1x721x1283": ragged[1:]}

    def library(g8):
        # yardstick only: seven average pools of the replicate-padded frame
        # (float sums, so not exact), the compare and the pack
        g = g8.float()[:, None]
        fg = [g <= F.avg_pool2d(F.pad(g, (w // 2,) * 4, mode="replicate"), w, stride=1) - C
              for w in WIN_SIZES]
        return pack_bits(torch.cat(fg, dim=1))

    def plan(g):
        if not hasattr(th, "threshold_plan"):
            return None
        from vican_torch import _kernels

        p = th.threshold_plan(*g.shape, len(WIN_SIZES), th._alignment(g.data_ptr()),
                              _kernels.sm_count(g.device))
        return dict(rows=p.rows, grid=list(p.grid), smem=p.smem, aligned=p.aligned)

    checks = []
    for name, g in cases.items():
        out = multi_threshold(g, WIN_SIZES, C)
        torch.cuda.synchronize()
        ref = multi_threshold_plain(g, WIN_SIZES, C)
        diff = int((out != ref).sum())
        checks.append({"case": name, "shape": list(g.shape), "differing_bytes": diff,
                       "max_abs_err": float((out.int() - ref.int()).abs().max()),
                       "ms": _rate_ms(lambda: multi_threshold(g, WIN_SIZES, C)),
                       "plan": plan(g)})
        if diff:
            raise AssertionError(f"multi_threshold {name}: {diff} bytes differ from plain")
    # the plain version on the card is the spec: as on the CPU
    small = cases["ragged 2x721x1283"]
    if not torch.equal(multi_threshold_plain(small, WIN_SIZES, C).cpu(),
                       multi_threshold_plain(small.cpu(), WIN_SIZES, C)):
        raise AssertionError("multi_threshold_plain: the card and the CPU differ")
    ms = _rate_ms(lambda: multi_threshold(batch, WIN_SIZES, C))
    launch_ms = _median_ms(lambda: multi_threshold(batch, WIN_SIZES, C))
    # the device time alone: at ~0.17 ms a call the wrapper's host work
    # (~0.1-0.25 ms on a loaded host) can set the back-to-back rate
    kernel_ms = _device_ms(lambda: multi_threshold(batch, WIN_SIZES, C))
    plain_ms = _rate_ms(lambda: multi_threshold_plain(batch, WIN_SIZES, C))
    library_ms = _rate_ms(lambda: library(batch))
    B, H, W = batch.shape
    nbytes = B * H * W + B * len(WIN_SIZES) * H * (-(-W // 8))
    # the int32 operations the function needs, not this design's: one
    # integral image of each replicate-padded frame (2 per entry), g + C
    # once per pixel, and per window and pixel a 3-term box sum, the scale
    # and the compare
    R = max(WIN_SIZES) // 2
    ops = B * (H + 2 * R) * (W + 2 * R) * 2 + B * H * W * (1 + 5 * len(WIN_SIZES))
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, ops / PEAK_INT32_OPS
    # the same operations issued on the FP32 and INT32 pipes together, as
    # a design with exact float arithmetic may: a second, lower bound
    t_pipes = ops / (PEAK_FP32_OPS + PEAK_INT32_OPS)
    row = dict(shape=list(batch.shape), checks=checks, ms=ms, launch_ms=launch_ms,
               kernel_ms=kernel_ms, plain_ms=plain_ms,
               library_ms=library_ms, bytes=nbytes, ops=ops,
               bytes_ms=t_bytes * 1e3, ops_ms=t_ops * 1e3,
               bound_ms=max(t_bytes, t_ops) * 1e3,
               bound_by="bytes" if t_bytes >= t_ops else "operations",
               pipes_bound_ms=max(t_bytes, t_pipes) * 1e3,
               pipes_bound_by="bytes" if t_bytes >= t_pipes else "operations on fp32+int32",
               max_abs_err=max(c["max_abs_err"] for c in checks),
               differing_bytes=sum(c["differing_bytes"] for c in checks),
               design=("column bands, 32-row steps, sliding boxes" if hasattr(th, "threshold_plan")
                       else "16x128 tiles, shared-memory integral (earlier design)"),
               smem_dynamic=getattr(th, "SMEM", None), **_threshold_resources(ptxas))
    emit("threshold_kernel", name="multi_threshold", **row)
    return row


def _threshold_resources(ptxas: str) -> dict:
    """Registers, static shared memory and local memory of the threshold
    kernel's variants as the runtime loaded them, where the checkout's
    library reports them (``threshold_attribute``); the spilling variants
    from this run's ``-Xptxas -v`` report, ``None`` where this run built
    nothing (the library was cached)."""
    from vican_torch import _kernels

    ptx = _ptxas_summary(ptxas) if ptxas else None
    res = {"spilling": ptx and ptx["spilling"], "ptxas_kernels": ptx and ptx["kernels"]}
    if "threshold_attribute" in _kernels.SOURCES["threshold"]:
        names = ("bytes/float C", "16-byte/float C", "bytes/integral C", "16-byte/integral C")
        attrs = {names[v]: dict(zip(("registers", "smem_static", "local_bytes"),
                                    (_kernels.call("threshold", "threshold_attribute", v, w)
                                     for w in range(3)))) for v in range(4)}
        if any(x < 0 for a in attrs.values() for x in a.values()):
            raise AssertionError(f"threshold_attribute failed: {attrs}")
        res.update(registers=max(a["registers"] for a in attrs.values()),
                   smem_static=max(a["smem_static"] for a in attrs.values()), variants=attrs)
    else:
        res.update(registers=ptx and ptx["max_registers"], smem_static=ptx and ptx["max_smem"])
    return res


def threshold_sweep(batch) -> None:
    """The threshold kernel on ``batch`` through its wrapper, at every cut
    of its rows into segments (``rows`` per CTA) and with the first 1..7
    default windows at the plan's cut: the times its fixed cut
    (``threshold.SEGMENT_ROWS``) and the per-window cost are read from."""
    from vican_torch import _kernels
    from vican_torch.ops import threshold as th

    B, H, W = batch.shape
    plan = th.threshold_plan(B, H, W, len(th.WIN_SIZES), th._alignment(batch.data_ptr()),
                             _kernels.sm_count(batch.device))
    steps = -(-H // th.STEP_ROWS)
    cuts = sorted({-(-steps // segs) * th.STEP_ROWS for segs in range(1, steps + 1)})
    rows_ms = {rows: _device_ms(lambda: th.multi_threshold(batch, th.WIN_SIZES, 10.0, rows))
               for rows in cuts}
    windows_ms = {n: _device_ms(lambda: th.multi_threshold(batch, th.WIN_SIZES[:n], 10.0))
                  for n in range(1, 8)}
    emit("threshold_sweep", shape=list(batch.shape), planned_rows=plan.rows, rows_ms=rows_ms,
         windows_ms=windows_ms)


def pnp_flops(method: str, lm_iters: int) -> int:
    """Float64 operations of one valid slot (:data:`PNP_FLOPS`)."""
    f = PNP_FLOPS
    lm = f["lm_pass"] + lm_iters * f["lm_trip"]
    init = f["ippe"] + lm if method == "ippe_square" else f["iterative_init"] + 2 * lm
    return init + f["error"]


def pnp_slots(B: int, D: int, seed: int, distorted: bool, dev):
    """``B`` cameras (640x360, f = 420) x ``D`` slots of 0.138 m markers
    0.6-3 m away, tilted up to 60 degrees, their corners projected and
    jittered by 0.2 px (tests/test_torch_pnp.py's scene, with and without
    its distortion); a third of the slots not valid, all-zero quads in a
    tenth, half of those still valid.  The PnP block's inputs on ``dev``."""
    import torch

    from vican_torch.ops.lie import rodrigues
    from vican_torch.ops.pnp import marker_object_points, project_points

    rng = np.random.default_rng(seed)
    n = B * D
    K = np.array([[420.0, 0, 320], [0, 420.0, 180], [0, 0, 1]])
    Ks = np.repeat(K[None], B, 0)
    dists = np.repeat((PNP_DIST if distorted else np.zeros(14))[None], B, 0)
    axis = rng.normal(size=(n, 3))
    axis *= rng.uniform(0.0, np.pi / 3, (n, 1)) / np.linalg.norm(axis, axis=1, keepdims=True)
    flip = torch.diag(torch.tensor([1.0, -1.0, -1.0], dtype=torch.float64))
    R = rodrigues(torch.tensor(axis)) @ flip  # marker +z toward the camera
    z = rng.uniform(0.6, 3.0, n)
    t = np.stack([rng.uniform(-0.25, 0.25, n) * z, rng.uniform(-0.15, 0.15, n) * z, z], 1)
    im = np.arange(n) // D
    px = project_points(marker_object_points(PNP_MARKER), R, torch.tensor(t),
                        torch.tensor(Ks[im]), torch.tensor(dists[im])).numpy()
    px = px + rng.normal(scale=0.2, size=px.shape)
    valid = rng.random(n) > 1 / 3
    zero = rng.random(n) < 0.1
    px[zero] = 0.0
    valid[zero & (rng.random(n) < 0.5)] = False
    ids = rng.integers(0, 1000, n)
    return [torch.tensor(a).to(dev) for a in (px, ids, valid, Ks, dists)]


def _pnp_gaps(out, ref) -> dict:
    """Kernel-vs-plain gaps of two packed ``(N, 23)`` buffers: the largest
    and median pose-entry, translation and error gaps over the slots the
    plain version calls ok, and whether ok, corners and ids are identical
    and the slots not ok zero past their id where the plain version's are."""
    out, ref = out.cpu().numpy(), ref.cpu().numpy()
    ok = ref[:, 9] > 0.5
    dR = np.abs(out[ok, 10:19] - ref[ok, 10:19]).max(1)
    dt = np.abs(out[ok, 19:22] - ref[ok, 19:22]).max(1)
    de = np.abs(out[ok, 22] - ref[ok, 22])
    zero_ref = (ref[:, 9:] == 0).all(1)
    return dict(slots=len(ref), ok=int(ok.sum()),
                same_ok=bool(np.array_equal(out[:, 9], ref[:, 9])),
                same_head=bool(np.array_equal(out[:, :9], ref[:, :9])),
                same_zeros=bool((out[zero_ref, 9:] == 0).all()),
                R=float(dR.max()), t=float(dt.max()), err=float(de.max()),
                R_median=float(np.median(dR)), t_median=float(np.median(dt)))


def capture_pnp_batch(frames, names, frame_cams) -> list:
    """The PnP block's arguments for P's first batch, as the drain hands
    them to ``vican_torch.ops.pnp.pnp_block`` (corners, ids, valid, Ks,
    dists, marker size, LM trips, method), copied on the card."""
    import torch

    from vican_torch.ops import pnp
    from vican_torch.perception import estimate_pose_gray

    seen, wrapper = [], pnp.pnp_block

    def spy(*args):
        if not seen:
            seen.append([a.clone() if isinstance(a, torch.Tensor) else a for a in args])
        return wrapper(*args)

    B = PERCEPTION_KW["batch_size"]
    spy.launches = 0  # the wrapper counts on the module's name, the spy here
    pnp.pnp_block = spy
    try:
        estimate_pose_gray(frames[:B], names[:B], frame_cams[:B], **PERCEPTION_KW)
    finally:
        pnp.pnp_block = wrapper
    return seen[0]


def pnp_phase(dev, p_batch, ptxas: str = "") -> dict:
    """The PnP kernel against ``pnp_block_plain`` on the card: 4104 seeded
    slots (:func:`pnp_slots`) for both methods, with and without
    distortion, then P's first batch of detections (``p_batch``, from
    :func:`capture_pnp_batch`) in both methods.  ``ok``, corners and ids
    must be identical, the pose and error gaps within :data:`PNP_TOL` and
    their medians within :data:`PNP_MEDIAN_TOL`.  At P's shape, in both
    methods, the kernel's device time (``_device_ms``), back-to-back rate
    and launch time, beside the plain version's time and the bound; its
    device time on a seeded case and on P's batch with one valid slot (one
    slot's chain: the latency floor); its registers, stack and spills from
    the ``-Xptxas -v`` report.  The one-slot times are taken with no LM
    trip and with P's, so their difference over the trip count is one LM
    trip's chain."""
    import torch

    from vican_torch.ops.pnp import pnp_block, pnp_block_plain

    corners, ids, valid, Ks, dists, marker_size, lm_iters, method = p_batch
    cases = {}
    for m in ("ippe_square", "iterative"):
        for distorted in (False, True):
            tag = f"seeded {m} {'distorted' if distorted else 'pinhole'}"
            cases[tag] = (pnp_slots(*PNP_SEEDED, 7 + 2 * distorted + (m == "iterative"),
                                    distorted, dev), PNP_MARKER, 20, m)
        cases[f"P batch {m}"] = ([corners, ids, valid, Ks, dists], marker_size, lm_iters, m)
    checks, faults = [], []
    for tag, (args, size, iters, m) in cases.items():
        out = pnp_block(*args, size, iters, m)
        torch.cuda.synchronize()
        gaps = _pnp_gaps(out, pnp_block_plain(*args, size, iters, m))
        checks.append(dict(case=tag, **gaps))
        if not (gaps["same_ok"] and gaps["same_head"] and gaps["same_zeros"]
                and max(gaps["R"], gaps["t"], gaps["err"]) <= PNP_TOL
                and max(gaps["R_median"], gaps["t_median"]) <= PNP_MEDIAN_TOL and gaps["ok"]):
            faults.append(f"{tag}: {gaps}")
        del out

    times = {}
    for m in (method, "iterative" if method == "ippe_square" else "ippe_square"):
        def run(m=m):
            return pnp_block(corners, ids, valid, Ks, dists, marker_size, lm_iters, m)
        times[m] = dict(kernel_ms=_device_ms(run), ms=_rate_ms(run), launch_ms=_median_ms(run))
    seeded_args, size, iters, m = cases[f"seeded {method} distorted"]
    seeded_ms = _device_ms(lambda: pnp_block(*seeded_args, size, iters, m))
    # one valid slot, with no LM trip and with P's: its setup and its trips
    one = torch.zeros_like(valid)
    one[int(valid.nonzero()[0, 0])] = True
    one_slot = {f"lm_iters_{it}": _device_ms(
        lambda it=it: pnp_block(corners, ids, one, Ks, dists, marker_size, it, method))
        for it in (0, lm_iters)}
    plain_ms = _median_ms(lambda: pnp_block_plain(corners, ids, valid, Ks, dists, marker_size,
                                                  lm_iters, method), reps=5)
    n_valid = int(valid.sum())
    N, B = corners.shape[0], Ks.shape[0]
    nbytes = N * (8 * 8 + 8 + 1 + 23 * 8) + B * (9 + 14) * 8
    ops = n_valid * pnp_flops(method, lm_iters)
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, ops / PEAK_FP64_FLOPS
    resources = {k: v for k, v in _ptxas_functions(ptxas).items() if "pnp_block_kernel" in k}
    row = dict(shape=[N, 4, 2], cameras=B, valid_slots=n_valid, method=method,
               lm_iters=lm_iters, checks=checks, **times[method],
               **{f"{k}_{m}": v for m, t in times.items() if m != method for k, v in t.items()},
               seeded_kernel_ms=seeded_ms, seeded_slots=int(seeded_args[0].shape[0]),
               seeded_valid=int(seeded_args[2].sum()), one_slot_kernel_ms=one_slot,
               plain_ms=plain_ms,
               bytes=nbytes, ops=ops, flops_per_slot=pnp_flops(method, lm_iters),
               bytes_ms=t_bytes * 1e3, ops_ms=t_ops * 1e3, bound_ms=max(t_bytes, t_ops) * 1e3,
               bound_by="bytes" if t_bytes >= t_ops else "operations",
               library_ms=None, library="none: no single PyTorch call computes it",
               max_abs_err=max(max(c["R"], c["t"], c["err"]) for c in checks),
               design="a warp a slot, float64: lanes across the Jacobian's 6 tangents x 4 "
                      "corners on 1-tangent dual numbers, J^T J entries a lane in row order, "
                      "the 6x6 LU on every lane, reciprocals beside the chain; 4 slots a block",
               ptxas=resources)
    emit("pnp_kernel", name="pnp_block", **row)
    if faults:
        raise AssertionError(f"pnp: {faults}")
    return row


def capture_detect_batch(frames, names, frame_cams) -> list:
    """The detect program's arguments for P's first batch, as the drain
    hands them to ``vican_torch.ops.detect.detect_candidates`` (frames,
    quads, valid, areas, codes, n_bits, params), copied on the card."""
    import torch

    from vican_torch.ops import detect
    from vican_torch.perception import estimate_pose_gray

    seen, wrapper = [], detect.detect_candidates

    def spy(*args):
        if not seen:
            seen.append([a.clone() if isinstance(a, torch.Tensor) else a for a in args])
        return wrapper(*args)

    B = PERCEPTION_KW["batch_size"]
    spy.launches = 0  # the wrapper counts on the module's name, the spy here
    detect.detect_candidates = spy
    try:
        estimate_pose_gray(frames[:B], names[:B], frame_cams[:B], **PERCEPTION_KW)
    finally:
        detect.detect_candidates = wrapper
    return seen[0]


def _detect_gaps(out, ref) -> dict:
    """Kernel against plain on one batch's Detections: valid, ids and
    scores identical on every slot, the kept slots' corner gap and every
    slot's."""
    kept = ref.valid
    gap = (out.corners - ref.corners).abs()
    return dict(same_valid=bool((out.valid == ref.valid).all()),
                same_ids=bool((out.ids == ref.ids).all()),
                same_score=bool((out.score == ref.score).all()), kept=int(kept.sum()),
                corners=float(gap[kept].max()) if bool(kept.any()) else 0.0,
                corners_all=float(gap.max()) if gap.numel() else 0.0)


def _detect_ok(gaps: dict) -> bool:
    return (gaps["same_valid"] and gaps["same_ids"] and gaps["same_score"]
            and gaps["corners"] <= DETECT_TOL and gaps["corners_all"] <= DETECT_ALL_TOL)


def _subpix_trips(gray, bi, q, params) -> int:
    """The cornerSubPix trips the corners of quads ``q`` take in
    ``refine_corners_subpix`` (each corner until its step falls under
    ``subpix_acc``): the kernel's trips, which freeze a stopped corner."""
    import torch

    from vican_torch.ops import detect as TD

    ox, oy, w = TD._subpix_window(params.subpix_win, q.dtype, q.device)
    cur = q.reshape(-1, 2)
    bb = bi.repeat_interleave(4)[:, None, None]
    move = torch.full(cur.shape[:1], torch.inf, dtype=q.dtype, device=q.device)
    trips = 0
    for _ in range(params.subpix_iters):
        active = move >= params.subpix_acc
        trips += int(active.sum())
        if not bool(active.any()):
            break
        px, py = cur[:, 0, None, None] + ox, cur[:, 1, None, None] + oy
        gx = (TD._bilinear(gray, bb, px + 1.0, py) - TD._bilinear(gray, bb, px - 1.0, py)) * 0.5
        gy = (TD._bilinear(gray, bb, px, py + 1.0) - TD._bilinear(gray, bb, px, py - 1.0)) * 0.5
        gxx, gxy, gyy = ((w * a * b).sum(dim=(1, 2)) for a, b in ((gx, gx), (gx, gy), (gy, gy)))
        bx = (w * (gx * gx * px + gx * gy * py)).sum(dim=(1, 2))
        by = (w * (gx * gy * px + gy * gy * py)).sum(dim=(1, 2))
        det = gxx * gyy - gxy * gxy
        den = torch.where(det == 0, 1.0, det)
        qn = torch.stack([(gyy * bx - gxy * by) / den, (-gxy * bx + gxx * by) / den], dim=-1)
        qn = torch.where((torch.abs(det) > 1e-9)[:, None], qn, cur)
        step = torch.linalg.vector_norm(qn - cur, dim=-1)
        cur = torch.where(active[:, None], qn, cur)
        move = torch.where(active, step, move)
    return trips


def _first_attempts(gray, quads, valid, codes, n_bits, params):
    """The valid slots' flat indices and whether each passes its first
    decode attempt, by the plain version's refine and first pass."""
    import torch

    from vican_torch.ops import detect as TD

    Q = valid.shape[1]
    idx = valid.reshape(-1).nonzero()[:, 0]
    bi = idx // Q
    refined = TD.refine_quad(gray, bi, quads.reshape(-1, 4, 2)[idx].double(), params)
    Hm = TD._quad_homography(refined, n_bits + 2)
    ok1 = TD._decode_pass(gray, bi, Hm, torch.ones_like(idx, dtype=torch.bool), codes, n_bits,
                          params, 1.0)[2]
    return idx, ok1


def _one_slot_batches(gray, quads, valid, codes, n_bits, params) -> dict:
    """The batch with one valid slot left: the first valid slot whose first
    decode attempt passes, and the first that takes the second."""
    import torch

    idx, ok1 = _first_attempts(gray, quads, valid, codes, n_bits, params)
    batches = {}
    for case, pick in (("first_attempt", ok1), ("second_attempt", ~ok1)):
        one = torch.zeros_like(valid)
        one.view(-1)[idx[pick.nonzero()[0, 0]]] = True
        batches[case] = one
    return batches


def _detect_work(gray, quads, valid, areas, codes, n_bits, params) -> dict:
    """What the detect kernels must do on these inputs, with this run's
    data: the valid slots, the second decode attempts (slots the first
    rejects, found by the plain version's first pass), cornerSubPix's
    corner trips; the float64 and int32 operations of :data:`DETECT_OPS`,
    and the bytes: the candidates, codes and tables read once, the
    Detections written once, and the frame bytes under the bilinear
    samples (4 pixels a sample, at most the frames)."""
    B, Q = valid.shape
    idx, ok1 = _first_attempts(gray, quads, valid, codes, n_bits, params)
    bi = idx // Q
    q = quads.reshape(-1, 4, 2)[idx].double()
    cells = n_bits + 2
    n_valid, n_second = int(idx.numel()), int((~ok1).sum())
    o = DETECT_OPS
    S, O, side = params.refine_samples, params.refine_offsets, 2 * params.subpix_win + 1
    samples = cells * cells * params.decode_samples ** 2
    trips = _subpix_trips(gray, bi, q, params) if params.corner_refine == "subpix" else 0
    refine_ops, refine_samples = {
        "apriltag": (4 * S * (O * (o["probe"] + 2 * o["bilinear"]) + o["edge_sample"])
                     + o["slot_fit"], 4 * S * O * 2),
        "subpix": (0, 0), "none": (0, 0)}[params.corner_refine]
    attempt = (samples * (o["sample"] + o["bilinear"]) + cells * cells * o["cell"]
               + 64 * o["otsu_bin"])
    attempts = n_valid + n_second
    fp64 = (n_valid * (refine_ops + o["homography"]) + attempts * attempt
            + trips * (side * side * (o["subpix_pixel"] + 4 * o["bilinear"]) + o["subpix_solve"]))
    int32 = attempts * codes.numel() * o["code"]
    bilinear = n_valid * refine_samples + trips * side * side * 4 + attempts * samples
    D = min(params.max_detections, Q)
    nbytes = (B * Q * (32 + 1 + 4) + codes.numel() * 8
              + (S + O + side * side + 2 * params.decode_samples) * 8
              + B * D * (64 + 8 + 1 + 4)
              + min(4 * bilinear, gray.numel()) * gray.element_size())
    return dict(valid_slots=n_valid, second_attempts=n_second, subpix_corner_trips=trips,
                bilinear_samples=bilinear, fp64_ops=fp64, int32_ops=int32, bytes=nbytes)


def _detect_split(fn) -> dict:
    """Device ms a call of each detect kernel ``fn`` launches."""
    return {k: ms for name, ms in _kernel_split(fn).items()
            for k in ("detect_slots_kernel", "dedup_kernel") if k in name}


def _source_title(name: str) -> str:
    """The first sentence of this checkout's ``vican_torch/csrc/<name>.cu``
    header: its kernels and their layout (the design a run timed)."""
    with open(os.path.join(REPO, "vican_torch", "csrc", f"{name}.cu")) as f:
        head = []
        for line in f:
            head.append(line.strip().lstrip("/").strip())
            if head[-1].endswith("."):
                break
    return " ".join(head)


def detect_phase(d_batch, ptxas: str = "") -> dict:
    """The detect kernels against ``detect_candidates_plain`` on the card,
    on P's first batch as the drain hands it over (``d_batch``, from
    :func:`capture_detect_batch`), at each refine kind of
    :data:`DETECT_KINDS`: valid, ids and scores identical on every slot,
    the kept slots' corners within :data:`DETECT_TOL` px and every slot's
    within :data:`DETECT_ALL_TOL`, one launch a call, and no host sync (the
    call runs under ``torch.cuda.set_sync_debug_mode("error")``).  At each
    kind the kernels' device time (``_device_ms``), back-to-back rate and
    launch time beside the plain version's and the bound from
    :func:`_detect_work`, and each kernel's device time (``_detect_split``);
    at the batch's own kind, its device time with one valid slot left, one
    that passes its first decode attempt and one that takes the second
    (:func:`_one_slot_batches`: one slot's chain, the latency floor); the
    ptxas registers, stack and spills of both kernels.  Runs in an older
    checkout too (``design`` is its detect.cu's title)."""
    import torch

    from vican_torch.ops.detect import detect_candidates, detect_candidates_plain

    gray, quads, valid, areas, codes, n_bits, params = d_batch
    quads, valid, areas = (torch.as_tensor(x, device=gray.device) for x in (quads, valid, areas))
    rows, faults = {}, []
    for kind in DETECT_KINDS:
        p = params._replace(corner_refine=kind)

        def run(p=p):
            return detect_candidates(gray, quads, valid, areas, codes, n_bits, p)

        before = detect_candidates.launches
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = run()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        launches = detect_candidates.launches - before
        ref = detect_candidates_plain(gray, quads, valid, areas, codes, n_bits, p)
        gaps = _detect_gaps(out, ref)
        if not _detect_ok(gaps) or launches != 1:
            faults.append(f"{kind}: {launches} launches, {gaps}")
        work = _detect_work(gray, quads, valid, areas, codes, n_bits, p)
        t_bytes = work["bytes"] / PEAK_BYTES_S
        t_ops = max(work["fp64_ops"] / PEAK_FP64_FLOPS, work["int32_ops"] / PEAK_INT32_OPS)
        rows[kind] = dict(
            kernel_ms=_device_ms(run), ms=_rate_ms(run), launch_ms=_median_ms(run),
            plain_ms=_median_ms(lambda p=p: detect_candidates_plain(
                gray, quads, valid, areas, codes, n_bits, p), reps=3),
            split=_detect_split(run), **gaps, **work, bytes_ms=t_bytes * 1e3,
            ops_ms=t_ops * 1e3, bound_ms=max(t_bytes, t_ops) * 1e3,
            bound_by="bytes" if t_bytes >= t_ops else "operations")
    one_slot = {case: _device_ms(lambda one=one: detect_candidates(
        gray, quads, one, areas, codes, n_bits, params))
        for case, one in _one_slot_batches(gray, quads, valid, codes, n_bits, params).items()}
    resources = {k: v for k, v in _ptxas_functions(ptxas).items()
                 if "detect_slots_kernel" in k or "dedup_kernel" in k}
    main = rows[params.corner_refine]
    row = dict(shape=list(quads.shape), frames=list(gray.shape), dtype=str(gray.dtype),
               refine=params.corner_refine, kinds=rows, ptxas=resources,
               one_slot_kernel_ms=one_slot,
               max_abs_err=max(r["corners"] for r in rows.values()),
               library_ms=None, library="none: no single PyTorch call computes it",
               design=_source_title("detect") + " Float64, --fmad=false, no host sync.",
               **{k: main[k] for k in ("kernel_ms", "ms", "launch_ms", "plain_ms", "bound_ms",
                                       "bound_by", "split")})
    emit("detect_kernel", name="detect_candidates", **row)
    if faults:
        raise AssertionError(f"detect: {faults}")
    return row


def _ragged(batch):
    """A 2-frame 721 x 1283 batch from the scene's frames (edge rows and
    columns repeated): W % 8 != 0 and H % 16 != 0."""
    import torch.nn.functional as F

    g = batch[:2].float()[:, None]
    return F.pad(g, (0, 3, 0, 1), mode="replicate")[:, 0].to(batch.dtype).contiguous()


def _perception_run(frames, names, frame_cams, base=PERCEPTION_KW, **kw):
    """One timed ``estimate_pose_gray`` run on the card with the arguments
    ``base`` and ``kw``: ``(edges, row)``, the row with images/s, the summed
    phase split (:data:`PHASES` of the checkout), the threshold kernel's
    launches, the PnP kernel's (None in a checkout without it), the
    labeler (a checkout without ``perception.last_labeler`` has only
    scipy's), the gates (``perception.last_gates``; None in a checkout
    that gates in numpy on the drain) and the run's re-fit counts
    (``perception.gate_counts``, None there); where the timer's events
    carry a ``stage``, also the summed seconds of each stage, the feed's
    and the drain's ``host candidates`` seconds apart, their overlap (feed
    + drain - wall) and the seconds in which the worker's host candidates
    and the drain's PnP ran at once."""
    import torch

    from vican_torch import perception
    from vican_torch.ops.threshold import multi_threshold
    from vican_torch.perception import PHASES, estimate_pose_gray
    from vican_torch.utils import PhaseTimer

    timer = PhaseTimer(verbose=False, device=torch.device("cuda"))
    pnp, det = _pnp_wrapper(), _detect_wrapper()
    multi_threshold.launches = 0
    for wrapper in (pnp, det):
        if wrapper is not None:
            wrapper.launches = 0
    gate_counts = getattr(perception, "gate_counts", None)
    if gate_counts is not None:
        gate_counts.update(dict.fromkeys(gate_counts, 0))
    t0 = time.perf_counter()
    edges = estimate_pose_gray(frames, names, frame_cams, timer=timer, **base, **kw)
    seconds = time.perf_counter() - t0
    launches = multi_threshold.launches
    split = {p: sum(e["seconds"] for e in timer.events if e["name"] == p) for p in PHASES}
    row = dict(frames=len(names), seconds=seconds, images_per_s=len(names) / seconds,
               phase_s=split, detections=len(edges), kernel_launches=launches,
               pnp_launches=None if pnp is None else pnp.launches,
               detect_launches=None if det is None else det.launches,
               batches=-(-len(names) // base["batch_size"]),
               labeler=getattr(perception, "last_labeler", "scipy"),
               gates=getattr(perception, "last_gates", None),
               gate_counts=None if gate_counts is None else dict(gate_counts))
    stages: dict = {}
    for e in timer.events:
        if e.get("stage"):
            stages[e["stage"]] = stages.get(e["stage"], 0.0) + e["seconds"]
    if stages:
        # the seconds the feed's and the drain's phases ran at once, and
        # those of them in which the worker's candidates met the PnP
        spans = {n: [(e["start"], e["start"] + e["seconds"]) for e in timer.events
                     if e["name"] == n and e["stage"] == st]
                 for n, st in (("host candidates", "feed"), ("PnP", "drain"))}
        candidates = {st: sum(e["seconds"] for e in timer.events
                              if e["name"] == "host candidates" and e["stage"] == st)
                      for st in ("feed", "drain")}
        row.update(stage_s=stages, overlap_s=sum(stages.values()) - seconds,
                   host_candidates_s=candidates,
                   overlap_candidates_pnp_s=_overlap(spans["host candidates"], spans["PnP"]))
    return edges, row


def _pnp_wrapper():
    """The PnP kernel's wrapper, ``vican_torch.ops.pnp.pnp_block``, or None
    in an older checkout that solves PnP op by op."""
    from vican_torch.ops import pnp

    return getattr(pnp, "pnp_block", None)


def _host_faults(tag: str, run: dict) -> list:
    """A host-mode run whose candidates did not come from the C labeler and
    the C gates (an older checkout without ``last_gates`` is held to its
    labeler alone)."""
    faults = [] if run["labeler"] == "c" else [f"{tag}: labeled by {run['labeler']}"]
    if run.get("gates", "c") not in ("c", None):
        faults.append(f"{tag}: gated by {run['gates']}")
    return faults


def _detect_wrapper():
    """The detect kernels' wrapper, ``vican_torch.ops.detect.
    detect_candidates``, or None in an older checkout that detects op by
    op (its function counts no launches)."""
    from vican_torch.ops import detect

    fn = getattr(detect, "detect_candidates", None)
    return fn if hasattr(fn, "launches") else None


def _launch_faults(tag: str, run: dict) -> list:
    """A run whose PnP, or whose detect program, did not launch its kernel
    once per batch (a checkout without the kernel has nothing to check)."""
    faults = []
    for what, key in (("PnP", "pnp_launches"), ("detect", "detect_launches")):
        n = run.get(key)
        if n is not None and n != run["batches"]:
            faults.append(f"{tag}: {n} {what} launches for {run['batches']} batches")
    return faults


def perception_phases(dev, ptxas: str = "") -> tuple[dict, tuple]:
    """Drive perception in the default mode over the scene on the card,
    check it against the CPU, against ground truth and through calibration.
    Returns the threshold phase's row with the threshold and PnP kernels'
    launches in the card run, and ``(frames, names, frame_cams, edges)``
    of that run."""
    import torch

    from vican_torch import bipgo, perception
    from vican_torch.geometry import distance_SO3, optimize_gauge_SE3
    from vican_torch.ops.shoelace import polygon_area
    from vican_torch.perception import estimate_pose_gray

    t0 = time.perf_counter()
    cams, traj, markers, frames, names, frame_cams = perception_scene(dev)
    torch.cuda.synchronize()
    render_s = time.perf_counter() - t0
    host = frames.cpu().numpy()  # frames arrive from the host, as decoded files would
    row = threshold_phase(frames, ptxas)
    del frames
    torch.cuda.empty_cache()

    edges, run = _perception_run(host, names, frame_cams)
    launches, n_batches = run["kernel_launches"], run["batches"]
    emit("perception", resolution=list(SCENE_RES), render_s=render_s,
         upload_mb_per_batch=PERCEPTION_KW["batch_size"] * host[0].nbytes / 1e6, **run)
    if launches != n_batches:
        raise AssertionError(f"perception: {launches} threshold launches for {n_batches} batches")
    faults = _launch_faults("perception", run)
    if faults:
        raise AssertionError(faults)
    if hasattr(perception, "last_labeler") and _host_faults("perception", run):
        raise AssertionError(_host_faults("perception", run))
    if len(edges) < 10 * SCENE_FRAMES:
        raise AssertionError(f"perception: only {len(edges)} detections")

    # the first 8 frames again on the CPU (the kernels' plain versions)
    t0 = time.perf_counter()
    cpu = estimate_pose_gray(host[:8], names[:8], frame_cams[:8], device="cpu",
                             **PERCEPTION_KW)
    cpu_s = time.perf_counter() - t0
    first = {k: v for k, v in edges.items() if v["im_filename"] in set(names[:8])}
    d_corner = max((float(np.abs(first[k]["corners"] - cpu[k]["corners"]).max())
                    for k in cpu if k in first), default=0.0)
    emit("perception_cpu", frames=8, seconds=cpu_s, detections_cpu=len(cpu),
         detections_card=len(first), same_keys=set(cpu) == set(first),
         max_corner_diff_px=d_corner)
    if set(cpu) != set(first) or not d_corner < 1e-3:
        raise AssertionError(f"perception_cpu: keys {set(cpu) ^ set(first)}, "
                             f"corners {d_corner} px apart")

    # edge accuracy against ground truth (tests/test_perception.py:73-89)
    rot, tr = [], []
    for (c, tm), v in edges.items():
        if v["reprojected_err"] >= 0.1:
            continue
        t, m = tm.split("_")
        gt = cams[c].extrinsics.inv() @ traj[t] @ markers[m]
        rot.append(distance_SO3(np.asarray(v["pose"].R(), np.float64),
                                np.asarray(gt.R(), np.float64)))
        tr.append(float(np.linalg.norm(v["pose"].t() - gt.t())))
    med_r, med_t = float(np.median(rot)), float(np.median(tr))
    emit("perception_accuracy", edges_used=len(rot), median_rot_err_deg=med_r,
         median_trans_err_m=med_t, mean_rot_err_deg=float(np.mean(rot)),
         mean_trans_err_m=float(np.mean(tr)))
    if not (len(rot) > 100 and med_r < 2.0 and med_t < 0.02):
        raise AssertionError(f"perception_accuracy: {len(rot)} edges, medians {med_r} deg, "
                             f"{med_t} m")

    # calibration on those edges (tests/test_perception.py:96-119)
    t0 = time.perf_counter()
    est = bipgo.bipartite_se3sync(
        edges, constraints=dict(markers),
        noise_model_r=lambda e: 0.001 * polygon_area(e["corners"]) ** 1.0,
        noise_model_t=lambda e: 0.001 * polygon_area(e["corners"]) ** 2.0,
        edge_filter=lambda e: e["reprojected_err"] < 0.15, maxiter=4,
        lsqr_solver="conjugate_gradient", dtype=np.float64, verbose=False)
    calib_s = time.perf_counter() - t0
    _check_packer()
    found = [c for c in cams if c in est]
    G = optimize_gauge_SE3([cams[c].extrinsics.inv() for c in found],
                           [est[c].inv() for c in found])
    r_err = [distance_SO3(np.asarray(cams[c].extrinsics.R(), np.float64),
                          np.asarray((G.inv() @ est[c]).R(), np.float64)) for c in found]
    t_err = [float(np.linalg.norm(cams[c].extrinsics.t() - (G.inv() @ est[c]).t()))
             for c in found]
    emit("calibration", seconds=calib_s, packer=_last_packer(), cameras_found=len(found),
         cameras=len(cams),
         mean_rot_err_deg=float(np.mean(r_err)), mean_trans_err_m=float(np.mean(t_err)),
         max_rot_err_deg=float(np.max(r_err)), max_trans_err_m=float(np.max(t_err)))
    if not (len(found) == len(cams) and np.mean(r_err) < 1.5 and np.mean(t_err) < 0.05):
        raise AssertionError(f"calibration: {len(found)} cameras, mean errors "
                             f"{np.mean(r_err)} deg, {np.mean(t_err)} m")
    row["launches"] = launches
    row["pnp_launches"] = run["pnp_launches"]
    row["detect_launches"] = run["detect_launches"]
    return row, (host, names, frame_cams, edges)


def _edge_diff(ref: dict, out: dict) -> dict:
    """How far two edge dicts are apart: same keys (in order), the largest
    corner and pose-entry differences over the common keys, and whether
    they are identical."""
    common = [k for k in ref if k in out]
    d_corner = max((float(np.abs(out[k]["corners"] - ref[k]["corners"]).max())
                    for k in common), default=0.0)
    d_pose = max((float(np.abs(out[k]["pose"].pose() - ref[k]["pose"].pose()).max())
                  for k in common), default=0.0)
    same_keys = list(ref) == list(out)
    return dict(same_keys=same_keys, keys_only_one=len(set(ref) ^ set(out)),
                max_corner_diff_px=d_corner, max_pose_entry_diff=d_pose,
                identical=same_keys and d_corner == 0.0 and d_pose == 0.0)


def perception_modes(device_run) -> None:
    """The ``host`` mode over the scene's frames (the host threshold, no
    launch of the kernel), then the default mode again, so that the two
    modes run in turns (default, host, default); then ``roi`` and ``auto``
    on the first 64 frames.  Every mode must give the default run's edges:
    identical where two default runs are, else the same keys and corners
    within the card-vs-CPU bar of 1e-3 px."""
    frames, names, frame_cams, device_edges = device_run
    host_edges, host = _perception_run(frames, names, frame_cams, pipeline_mode="host")
    again_edges, again = _perception_run(frames, names, frame_cams, pipeline_mode="device")
    run_to_run = _edge_diff(device_edges, again_edges)
    n = 64
    first = set(names[:n])
    device_first = {k: v for k, v in device_edges.items() if v["im_filename"] in first}
    host_first = {k: v for k, v in host_edges.items() if v["im_filename"] in first}
    roi_edges, roi = _perception_run(frames[:n], names[:n], frame_cams[:n], pipeline_mode="roi")
    auto_edges, auto = _perception_run(frames[:n], names[:n], frame_cams[:n],
                                       pipeline_mode="auto")
    diffs = {"host vs device": _edge_diff(device_edges, host_edges),
             "roi vs host": _edge_diff(host_first, roi_edges),
             "auto vs device": _edge_diff(device_first, auto_edges)}
    emit("perception_modes", host=host, device_again=again, roi=roi, auto=auto,
         device_run_to_run=run_to_run, diffs=diffs)
    faults = [f"{m}: {r['kernel_launches']} threshold launches"
              for m, r, want in (("host", host, 0), ("roi", roi, 0),
                                 ("auto", auto, auto["batches"]))
              if r["kernel_launches"] != want]
    for m, r in (("host", host), ("roi", roi), ("auto", auto)):
        faults += _host_faults(m, r)
    for m, r in (("host", host), ("device", again), ("roi", roi), ("auto", auto)):
        faults += _launch_faults(m, r)
    for name, d in diffs.items():
        if run_to_run["identical"] and not d["identical"]:
            faults.append(f"{name}: {d} (two default runs are identical)")
        elif not (d["same_keys"] and d["max_corner_diff_px"] < 1e-3):
            faults.append(f"{name}: {d}")
    if faults:
        raise AssertionError(f"perception_modes: {faults}")


# The default mode's detections on the scene's 384 frames on the card, the
# same in every run (two default runs give identical edges)
P_DETECTIONS = 3377


def _intervals(spans) -> list:
    """The union of ``(start, end)`` spans as sorted disjoint spans."""
    out: list = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _overlap(a, b) -> float:
    """The length of the intersection of two unions of spans."""
    a, b = _intervals(a), _intervals(b)
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        total += max(0.0, min(a[i][1], b[j][1]) - max(a[i][0], b[j][0]))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def _kernels_under(event) -> int:
    """CUDA kernels launched by the operators under a host range of a
    ``torch.profiler`` trace (the profiler links each kernel to the
    operator that launched it)."""
    stack, n = list(event.cpu_children), 0
    while stack:
        e = stack.pop()
        n += len(e.kernels)
        stack.extend(e.cpu_children)
    return n


TRACE_FRAMES = 96  # 3 of the scene's 12 batches; see pipeline_trace


def pipeline_trace(frames, names, frame_cams) -> dict:
    """A warm pipelined run of the scene's first :data:`TRACE_FRAMES`
    frames under ``torch.profiler``, its phases as named ranges
    (``PhaseTimer(trace=True)``), on every thread where this torch can
    record them (``profile_all_threads``): the device busy share over the
    run and the top kernels (:func:`_trace_summary`), the CUDA kernels
    launched per batch in the ``PnP`` and ``detect program`` ranges, and
    how long the worker's ``host candidates`` ranges (the C labeler and
    gates) overlap
    the calling thread's ``PnP`` ranges, from the trace where it holds the
    worker's ranges and from the timer's events in any case.  The detect
    program's split (``detect_split``): where it runs op by op (an older
    checkout), ``refine_quad``, ``decode_quads`` and ``dedup_and_compact``
    run under ``refine``, ``decode`` and ``dedup`` ranges, each with its
    launches and seconds a batch; on the kernels, each hand kernel's
    launches and device seconds a batch.  Three
    batches, not twelve: a batch launches ~1e4 kernels, each with its host
    operators, and the profiler's parse of a whole run's events would take
    minutes."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from vican_torch.perception import estimate_pose_gray
    from vican_torch.utils import PhaseTimer

    extra: dict = {}
    try:
        from torch._C._profiler import _ExperimentalConfig

        extra["experimental_config"] = _ExperimentalConfig(profile_all_threads=True)
    except (ImportError, TypeError):
        pass
    frames, names, frame_cams = (frames[:TRACE_FRAMES], names[:TRACE_FRAMES],
                                 frame_cams[:TRACE_FRAMES])
    timer = PhaseTimer(verbose=False, trace=True, device=torch.device("cuda"))
    from vican_torch.ops import detect

    stages = {"refine": "refine_quad", "decode": "decode_quads", "dedup": "dedup_and_compact"}
    plain = {n: getattr(detect, f) for n, f in stages.items()}

    def ranged(name):
        def fn(*args, **kw):
            with record_function(name):
                return plain[name](*args, **kw)
        return fn

    for n, f in stages.items():
        setattr(detect, f, ranged(n))
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], **extra) as prof:
            with record_function("pipelined P"):
                t0 = time.perf_counter()
                edges = estimate_pose_gray(frames, names, frame_cams, timer=timer,
                                           **PERCEPTION_KW)
                seconds = time.perf_counter() - t0
    finally:
        for n, f in stages.items():
            setattr(detect, f, plain[n])
    t0 = time.perf_counter()
    summary = _trace_summary(prof, "pipelined P", "threshold")
    ranges: dict = {}
    events = prof.events()
    for e in events:
        if e.device_type == DeviceType.CPU and e.name in ("PnP", "detect program",
                                                          "host candidates", *stages):
            ranges.setdefault(e.name, []).append(e)
    batches = -(-len(names) // PERCEPTION_KW["batch_size"])
    # the hand kernels launch through ctypes, outside any torch operator, so
    # the trace links none of them to a range: count them on the device's
    # timeline (the PnP kernel is launched in the PnP range alone)
    host_names = {e.name for e in events if e.device_type == DeviceType.CPU}
    device = [e for e in events if e.device_type == DeviceType.CUDA and e.name not in host_names]
    hand_names = ("pnp_block_kernel", "threshold_band_kernel", "detect_slots_kernel",
                  "dedup_kernel")
    hand = {n: sum(1 for e in device if n in e.name) / batches for n in hand_names}
    split = {n: dict(launches=sum(_kernels_under(e) for e in ranges[n]) / batches,
                     seconds=sum((e.time_range.end - e.time_range.start) * 1e-6
                                 for e in ranges[n]) / batches)
             for n in stages if n in ranges}
    split.update({n: dict(launches=hand[n], device_seconds=sum(
        (e.time_range.end - e.time_range.start) * 1e-6 for e in device if n in e.name) / batches)
        for n in ("detect_slots_kernel", "dedup_kernel") if hand[n]})
    span = lambda e: (e.time_range.start * 1e-6, e.time_range.end * 1e-6)
    ranges.setdefault("host candidates", [])
    # (an in-order checkout's events have neither stage nor start)
    timer_spans = {n: [(e["start"], e["start"] + e["seconds"]) for e in timer.events
                       if e["name"] == n and e.get("stage") == st]
                   for n, st in (("PnP", "drain"), ("host candidates", "feed"))}
    row = dict(
        profile_all_threads=bool(extra), seconds=seconds, detections=len(edges),
        ranges={n: len(v) for n, v in ranges.items()},
        launches_per_batch={n: sum(_kernels_under(e) for e in v) / batches
                            for n, v in ranges.items() if n in ("PnP", "detect program")},
        hand_kernels_per_batch=hand, detect_split=split,
        overlap_candidates_pnp_trace_s=(
            _overlap([span(e) for e in ranges["host candidates"]],
                     [span(e) for e in ranges["PnP"]])
            if ranges["host candidates"] and "PnP" in ranges else None),
        overlap_candidates_pnp_timer_s=_overlap(timer_spans["host candidates"],
                                                timer_spans["PnP"]),
        candidates_s=sum(e - s for s, e in timer_spans["host candidates"]),
        pnp_s=sum(e - s for s, e in timer_spans["PnP"]),
        trace_read_s=time.perf_counter() - t0, **summary)
    return row


def pipeline_phase(frames, names, frame_cams, device_edges=None) -> None:
    """Perception's feed/drain pipeline over the scene's frames (host
    arrays, as decoded files would be): the default depth and
    ``VICAN_TPU_PIPELINE_DEPTH=1`` in turns (default, 1, default), each
    with its images/s, the summed seconds of the feed's and the drain's
    phases and their overlap (feed + drain - wall); every run must give
    the same edges, identical, with :data:`P_DETECTIONS` detections, one
    threshold launch per batch and the C labeler and gates, and those of
    ``device_edges`` where given.  Then, where cv2 imports, the frames as
    JPEG files through ``cam.estimate_pose_mp`` against
    ``estimate_pose_gray`` on ``load_images`` of the same files
    (identical); then :func:`pipeline_trace`."""
    import tempfile

    runs, faults = [], []
    ref = device_edges
    for depth in ("", "1", ""):
        with _env(VICAN_TPU_PIPELINE_DEPTH=depth):
            edges, run = _perception_run(frames, names, frame_cams)
        run["depth"] = depth or "default (2)"
        if ref is None:
            ref = edges
        run["vs_reference"] = _edge_diff(ref, edges)
        runs.append(run)
        if not run["vs_reference"]["identical"] or len(edges) != P_DETECTIONS:
            faults.append(f"depth {run['depth']}: {len(edges)} detections, "
                          f"{run['vs_reference']}")
        if run["kernel_launches"] != run["batches"]:
            faults.append(f"depth {run['depth']}: {run['kernel_launches']} launches for "
                          f"{run['batches']} batches")
        faults += _host_faults(f"depth {run['depth']}", run)
        faults += _launch_faults(f"depth {run['depth']}", run)
    emit("pipeline", runs=runs)

    try:
        import cv2
    except ImportError:
        cv2 = None
    if cv2 is None:
        emit("pipeline_files", ran=False, reason="cv2 does not import: the file path did not run")
    else:
        from vican_torch.cam import estimate_pose_mp
        from vican_torch.perception import estimate_pose_gray, load_images

        with tempfile.TemporaryDirectory() as tmp:
            t0 = time.perf_counter()
            files = []
            for img, name in zip(frames, names):
                path = os.path.join(tmp, name)
                os.makedirs(os.path.dirname(path), exist_ok=True)
                if not cv2.imwrite(path, img):
                    raise AssertionError(f"pipeline_files: could not write {path}")
                files.append(path)
            write_s = time.perf_counter() - t0
            pnp, det = _pnp_wrapper(), _detect_wrapper()
            for wrapper in (pnp, det):
                if wrapper is not None:
                    wrapper.launches = 0
            t0 = time.perf_counter()
            via_files = estimate_pose_mp(files, frame_cams, brightness=0, contrast=0,
                                         marker_ids=None, **PERCEPTION_KW)
            files_s = time.perf_counter() - t0
            files_run = dict(pnp_launches=None if pnp is None else pnp.launches,
                             detect_launches=None if det is None else det.launches,
                             batches=-(-len(files) // PERCEPTION_KW["batch_size"]))
            gray = load_images(files, grayscale=True)
            via_gray = estimate_pose_gray(gray, files, frame_cams, **PERCEPTION_KW)
        diff = _edge_diff(via_gray, via_files)
        emit("pipeline_files", ran=True, frames=len(files), write_s=write_s,
             seconds=files_s, images_per_s=len(files) / files_s, detections=len(via_files),
             vs_gray=diff, **files_run)
        if not diff["identical"] or len(via_files) < 10 * SCENE_FRAMES:
            faults.append(f"files: {len(via_files)} detections, {diff}")
        faults += _launch_faults("files", files_run)
    if faults:
        raise AssertionError(f"pipeline: {faults}")
    trace = pipeline_trace(frames, names, frame_cams)
    emit("pipeline_trace", **trace)
    # one PnP kernel a batch and the few torch operators' kernels around
    # it, where ~1e4 launches ran before the kernel
    pnp_per_batch = (trace["launches_per_batch"].get("PnP", 0)
                     + trace["hand_kernels_per_batch"]["pnp_block_kernel"])
    if _pnp_wrapper() is not None and not pnp_per_batch <= 8:
        raise AssertionError(f"pipeline_trace: {pnp_per_batch} PnP launches a batch")
    # the two detect kernels a batch and the torch operators' kernels
    # around them, where ~556 launches ran before the kernels
    detect_per_batch = (trace["launches_per_batch"].get("detect program", 0)
                        + trace["hand_kernels_per_batch"]["detect_slots_kernel"]
                        + trace["hand_kernels_per_batch"]["dedup_kernel"])
    if _detect_wrapper() is not None and not detect_per_batch <= 10:
        raise AssertionError(f"pipeline_trace: {detect_per_batch} detect launches a batch")


PURE_FRAMES = 64  # P's first two batches
# The JAX package's pure and device modes on P's first 64 frames (the
# frames fetched from the card, both modes of vican_tpu.cam.estimate_pose_mp
# on the CPU, JAX_PLATFORMS=cpu): the keys only one mode finds, and the
# largest corner gap over the keys both find.  The modes' candidates differ
# in tie-breaking, the row-subsampled re-fit and the dedup score, so on
# these frames the JAX package's own modes miss its close-range bar
# (tests/test_perception.py:618-627: the same set, 0.5 px); the port's
# pure edges equalled the JAX package's pure edges there (the same keys,
# corners within 1.2e-6 px), and its device edges the JAX device edges.
JAX_PURE_ONLY = {("0", "7_392"), ("0", "7_400"), ("1", "1_106"), ("2", "3_19"),
                 ("5", "2_400"), ("6", "7_373")}
JAX_DEVICE_ONLY = {("3", "4_703"), ("6", "0_109"), ("6", "1_2"), ("6", "5_190")}
JAX_PURE_VS_DEVICE_PX = 5.976840510898619


def save_pure_frames(device_run, path: str) -> None:
    """Write the pure phase's frames and the port's edges in both modes on
    them to ``path`` (``--pure --save path``), for ``tools/pure_vs_jax.py``,
    which runs the JAX package's two modes on the same frames on the CPU."""
    frames, names, frame_cams, device_edges = device_run
    n = PURE_FRAMES
    pure, _ = _perception_run(frames[:n], names[:n], frame_cams[:n], pipeline_mode="pure")
    first = set(names[:n])
    dev = {k: v for k, v in device_edges.items() if v["im_filename"] in first}

    def keys(edges):
        return np.array([f"{c}|{m}" for c, m in edges])

    os.makedirs(os.path.dirname(path), exist_ok=True)
    np.savez_compressed(path, frames=frames[:n], names=np.array(names[:n]),
                        cams=np.array([c.id for c in frame_cams[:n]]),
                        device_keys=keys(dev), device_corners=np.stack([v["corners"] for v in dev.values()]),
                        pure_keys=keys(pure), pure_corners=np.stack([v["corners"] for v in pure.values()]))


def pure_phase(device_run) -> tuple[int, int, int]:
    """The ``pure`` mode on the scene's first :data:`PURE_FRAMES` frames:
    the threshold kernel once per batch, then the components, candidates
    and re-fit on the card.  Against the ``device`` run on those frames it
    must differ exactly as the JAX package's two modes do there (the keys
    of :data:`JAX_PURE_ONLY` and :data:`JAX_DEVICE_ONLY`; the largest corner
    gap within 2e-3 px, twice the card-vs-CPU bar, of
    :data:`JAX_PURE_VS_DEVICE_PX`), and its first 8 frames on the CPU must
    give the card's keys with corners within 1e-3 px.  Prints images/s, the
    phase split and the peak memory.  Returns the threshold, PnP and
    detect kernels' launches."""
    import torch

    frames, names, frame_cams, device_edges = device_run
    n = PURE_FRAMES
    first = set(names[:n])
    device_first = {k: v for k, v in device_edges.items() if v["im_filename"] in first}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    edges, run = _perception_run(frames[:n], names[:n], frame_cams[:n], pipeline_mode="pure")
    peak = torch.cuda.max_memory_allocated()
    vs_device = _edge_diff(device_first, edges)
    t0 = time.perf_counter()
    cpu = _perception_run_cpu(frames[:8], names[:8], frame_cams[:8], pipeline_mode="pure")
    cpu_s = time.perf_counter() - t0
    card8 = {k: v for k, v in edges.items() if v["im_filename"] in set(names[:8])}
    d_cpu = max((float(np.abs(card8[k]["corners"] - cpu[k]["corners"]).max())
                 for k in cpu if k in card8), default=0.0)
    emit("pure", **run, max_memory_allocated=peak,
         vs_device=dict(vs_device, pure_only=sorted(set(edges) - set(device_first)),
                        device_only=sorted(set(device_first) - set(edges))),
         cpu=dict(frames=8, seconds=cpu_s, detections=len(cpu), same_keys=set(cpu) == set(card8),
                  max_corner_diff_px=d_cpu))
    faults = []
    if run["kernel_launches"] != run["batches"]:
        faults.append(f"{run['kernel_launches']} threshold launches for {run['batches']} batches")
    faults += _launch_faults("pure", run)
    if len(edges) < 10 * (n // 8):
        faults.append(f"only {len(edges)} detections")
    pure_only, device_only = set(edges) - set(device_first), set(device_first) - set(edges)
    if (pure_only, device_only) != (JAX_PURE_ONLY, JAX_DEVICE_ONLY) or not abs(
            vs_device["max_corner_diff_px"] - JAX_PURE_VS_DEVICE_PX) < 2e-3:
        faults.append(f"against the device mode: {vs_device}, pure only {sorted(pure_only)}, "
                      f"device only {sorted(device_only)}")
    if set(cpu) != set(card8) or not d_cpu < 1e-3:
        faults.append(f"against the CPU: keys {set(cpu) ^ set(card8)}, corners {d_cpu} px")
    if faults:
        raise AssertionError(f"pure: {faults}")
    return run["kernel_launches"], run["pnp_launches"], run["detect_launches"]


def _perception_run_cpu(frames, names, frame_cams, **kw):
    """``estimate_pose_gray`` on the CPU (the kernels' plain versions)."""
    from vican_torch.perception import estimate_pose_gray

    return estimate_pose_gray(frames, names, frame_cams, device="cpu", **PERCEPTION_KW, **kw)


MESH_TIMEOUT_S = 600
MESH_ROT_TOL_DEG = 0.01
MESH_TRANS_TOL_M = 1e-3


def _pose_gap(ref: dict, out: dict) -> tuple[float, float]:
    """Largest rotation (degrees) and translation (m) gap over the keys of
    ``ref``, which ``out`` must all have.  The angle comes from the chord,
    ``|R1 - R2|_F = 2 sqrt(2) sin(angle / 2)``: the arccos of a float32
    trace cannot resolve angles below ~0.02 degrees."""
    missing = set(ref) - set(out)
    if missing:
        raise AssertionError(f"mesh: {len(missing)} nodes missing from the sharded result")
    chord = max(float(np.linalg.norm(np.asarray(ref[k].R(), np.float64)
                                     - np.asarray(out[k].R(), np.float64))) for k in ref)
    rot = np.degrees(2.0 * np.arcsin(min(1.0, chord / (2.0 * np.sqrt(2.0)))))
    tr = max(float(np.linalg.norm(ref[k].t() - out[k].t())) for k in ref)
    return float(rot), tr


def mesh_child() -> None:
    """The ``mesh`` phase's body (``chip_smoke.py --mesh-child``): a world of
    one rank over NCCL, then ``bipartite_se3sync(mesh=make_mesh())`` on cell
    C's problem (the large-graph route, chunks split over the mesh) against
    ``mesh=None``, and ``se3sync_sharded`` on cell A's problem against
    ``bipartite_se3sync``: each in float32, where the sharded filter runs
    ``pwr_apply``, and in float64.  Two float32 runs without the mesh give
    the float32 route's own run-to-run gap.  Prints one JSON line."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, REPO)
    from vican_torch import bipgo
    from vican_torch.geometry import SE3
    from vican_torch.parallel import init_distributed, make_mesh, se3sync_sharded
    from vican_torch.solver.packing import pack_problem
    from vican_torch.solver.pwr import pwr_apply
    from vican_torch.synthetic import make_problem_arrays

    init_distributed()
    mesh = make_mesh()
    out = {"backend": dist.get_backend(), "world": mesh.size()}

    def kw(dtype):
        return dict(noise_model_r=_one, noise_model_t=_one, edge_filter=_filt, maxiter=MAXITER,
                    lsqr_solver="conjugate_gradient", dtype=dtype, verbose=False)

    prob = make_problem_arrays(**CONFIG_C)
    assert bipgo._use_scale_path(CONFIG_C["n_cams"], CONFIG_C["n_times"], np.float32)
    runs = {}
    for name, m, dtype in (("mesh", mesh, np.float32), ("single", None, np.float32),
                           ("single_again", None, np.float32), ("mesh_f64", mesh, np.float64),
                           ("single_f64", None, np.float64)):
        pwr_apply.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        est = bipgo.bipartite_se3sync(prob.edges, prob.constraints(), mesh=m, **kw(dtype))
        torch.cuda.synchronize()
        runs[name] = (est, time.perf_counter() - t0, pwr_apply.launches)
    out["cell_C"] = dict(
        float64=_pose_gap(runs["single_f64"][0], runs["mesh_f64"][0]),
        float32=_pose_gap(runs["single"][0], runs["mesh"][0]),
        float32_run_to_run=_pose_gap(runs["single"][0], runs["single_again"][0]),
        seconds={k: v[1] for k, v in runs.items()},
        pwr_launches={k: v[2] for k, v in runs.items()})
    del runs, prob

    prob = make_problem_arrays(**CONFIG_A)
    out["cell_A"] = {}
    for dtype in (np.float32, np.float64):
        single = bipgo.bipartite_se3sync(prob.edges, prob.constraints(), **kw(dtype))
        packed = pack_problem(prob.edges, prob.constraints(), _one, _one, _filt, dtype=dtype)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r_cam, _, t_est, res = se3sync_sharded(packed, maxiter=MAXITER, mesh=mesh, dtype=dtype)
        seconds = time.perf_counter() - t0
        sharded = {c: SE3(R=r_cam[i], t=t_est[i]) for i, c in enumerate(packed.cam_ids)}
        out["cell_A"][np.dtype(dtype).name] = dict(
            gap=_pose_gap({c: single[c] for c in packed.cam_ids}, sharded), seconds=seconds,
            cg_residual=res)
    del prob
    out["perception"] = mesh_perception(mesh)
    dist.destroy_process_group()
    print(json.dumps(out), flush=True)


MESH_PERCEPTION_STEPS = 8  # P's scene over 8 timesteps: 64 frames, 2 batches


def mesh_perception(mesh) -> dict:
    """``cam.estimate_pose_mp(mesh=mesh)`` over the first
    :data:`MESH_PERCEPTION_STEPS` timesteps of P's scene written as JPEG
    files, against ``mesh=None``: each rank runs its share of every batch,
    PnP on the kernel once per batch.  Needs cv2 for the files (the card
    machine has it); without it the row says so and nothing is checked."""
    import tempfile

    import torch

    try:
        import cv2
    except ImportError:
        return dict(ran=False, reason="cv2 does not import: the file path did not run")
    from vican_torch import perception
    from vican_torch.cam import estimate_pose_mp

    frames, names, frame_cams = perception_scene(torch.device("cuda"),
                                                 MESH_PERCEPTION_STEPS)[3:]
    host = frames.cpu().numpy()
    del frames
    pnp, det = _pnp_wrapper(), _detect_wrapper()
    kw = dict(brightness=0, contrast=0, marker_ids=None, **PERCEPTION_KW)
    with tempfile.TemporaryDirectory() as tmp:
        files = []
        for img, name in zip(host, names):
            path = os.path.join(tmp, name)
            os.makedirs(os.path.dirname(path), exist_ok=True)
            if not cv2.imwrite(path, img):
                raise AssertionError(f"mesh: could not write {path}")
            files.append(path)
        pnp.launches = det.launches = 0
        t0 = time.perf_counter()
        sharded = estimate_pose_mp(files, frame_cams, mesh=mesh, **kw)
        seconds = time.perf_counter() - t0
        launches, detect_launches = pnp.launches, det.launches
        labeler, gates = perception.last_labeler, perception.last_gates
        single = estimate_pose_mp(files, frame_cams, **kw)
    return dict(ran=True, frames=len(names), seconds=seconds, detections=len(sharded),
                batches=-(-len(names) // PERCEPTION_KW["batch_size"]), pnp_launches=launches,
                detect_launches=detect_launches, labeler=labeler, gates=gates,
                vs_single=_edge_diff(single, sharded))


def mesh_phase() -> tuple[int, int, int]:
    """Phase ``mesh``: :func:`mesh_child` in a process of its own, under its
    own timeout, so the process group ends with it.  Fails when a float64
    gap passes :data:`MESH_ROT_TOL_DEG` / :data:`MESH_TRANS_TOL_M` or the
    sharded float32 route did not launch ``pwr_apply``.  The bar holds the
    float64 solves: the float32 large-graph route moves by about as much
    between two runs without a mesh (its run-to-run gap is printed beside
    the mesh's; the JAX package gates its mesh parity in float64 for the
    same reason, __graft_entry__.py:104-112).  Perception with ``mesh=``
    (:func:`mesh_perception`) must give ``mesh=None``'s edges, identical,
    with one PnP and one detect launch a batch.  Returns the sharded
    float32 run's ``pwr_apply`` launches and the perception run's PnP and
    detect launches."""
    t0 = time.perf_counter()
    env = {k: v for k, v in os.environ.items()
           if k not in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--mesh-child"],
                          cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=MESH_TIMEOUT_S)
    if proc.returncode != 0:
        raise AssertionError(f"mesh: the child failed ({proc.returncode}): "
                             f"{proc.stdout[-2000:]} {proc.stderr[-4000:]}")
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    emit("mesh", seconds=time.perf_counter() - t0, **out)
    faults = [f"{cell}: {gap[0]} deg, {gap[1]} m"
              for cell, gap in (("C", out["cell_C"]["float64"]),
                                ("A", out["cell_A"]["float64"]["gap"]))
              if not (gap[0] <= MESH_ROT_TOL_DEG and gap[1] <= MESH_TRANS_TOL_M)]
    launches = out["cell_C"]["pwr_launches"]["mesh"]
    if launches <= 0:
        faults.append("the sharded route never launched pwr_apply")
    per = out["perception"]
    if per["ran"]:
        faults += _launch_faults("perception", per) + _host_faults("perception", per)
        if not per["vs_single"]["identical"] or per["detections"] < 10 * MESH_PERCEPTION_STEPS:
            faults.append(f"perception: {per['detections']} detections, {per['vs_single']}")
    if (out["backend"], out["world"]) != ("nccl", 1):
        faults.append(f"backend {out['backend']}, world {out['world']}")
    if faults:
        raise AssertionError(f"mesh: {faults}")
    return launches, per.get("pnp_launches"), per.get("detect_launches")


def _tutorial_capture(cams: dict, traj: dict, markers: dict, dev):
    """One capture of the tutorial, rendered on the card in chunks of
    timesteps, fetched to the host as decoded files would arrive there,
    and preprocessed there as the tutorial asks (brightness -150, contrast
    120; ``perception.host_preprocess``).  Returns ``(gray (N, H, W) uint8,
    names, frame_cams, render_s, preprocess_s)``."""
    import torch

    from vican_torch import render
    from vican_torch.perception import host_preprocess

    steps = list(traj)
    per_chunk = max(RENDER_CHUNK // len(cams), 1)
    W, H = TUTORIAL_RES
    gray = np.empty((len(steps) * len(cams), H, W), np.uint8)
    names, frame_cams = [], []
    render_s = preprocess_s = 0.0
    for s in range(0, len(steps), per_chunk):
        chunk = {t: traj[t] for t in steps[s:s + per_chunk]}
        t0 = time.perf_counter()
        frames, n, c = render.render_frames(cams, chunk, markers, marker_size=TUTORIAL_MARKER,
                                            device=dev)
        frames = frames.cpu().numpy()
        t1 = time.perf_counter()
        gray[len(names):len(names) + len(n)] = host_preprocess(frames, **TUTORIAL_PREPROCESS)
        preprocess_s += time.perf_counter() - t1
        render_s += t1 - t0
        names += n
        frame_cams += c
    torch.cuda.synchronize()
    return gray, names, frame_cams, render_s, preprocess_s


def tutorial_phase(dev) -> tuple[int, int, int]:
    """Phase T: examples/tutorial.py's flow on the card at half the
    reference captures' scale, with its hyperparameters.  Both captures
    are rendered on the card; the cube is calibrated from its capture (float64), the
    room capture's detections solve the camera network (float32), and the
    result is evaluated against ground truth (cell 9).  Fails unless all 24
    markers calibrate, the cameras come within 1 degree and 10 cm on
    average (tests/test_tutorial.py's bars), the threshold kernel launched
    once per batch and the PnP and detect kernels once per batch, the first 8 room
    frames on the CPU give the same detections, and the room's edge dict
    survives ``save_edges`` / ``load_edges`` unchanged.  Returns T's
    launches of the threshold, PnP and detect kernels."""
    import tempfile

    import torch

    from vican_torch.bipgo import bipartite_se3sync, object_bipartite_se3sync
    from vican_torch.evaluation import evaluate_calibration
    from vican_torch.ops.shoelace import polygon_area
    from vican_torch.perception import estimate_pose_gray
    from vican_torch.render import make_cube_markers
    from vican_torch.serialization import load_edges, save_edges
    from vican_torch.synthetic import _cube_scene, calibration_sweep

    torch.cuda.reset_peak_memory_stats()
    t_start = time.perf_counter()
    markers = make_cube_markers()

    def detect(gray, names, frame_cams):
        """One capture's detections of the tutorial's markers, and all of
        them, with the run's row (the kernel's launches counted from 0)."""
        edges, run = _perception_run(gray, names, frame_cams, base=TUTORIAL_KW)
        ids = set(TUTORIAL_IDS)
        kept = {k: v for k, v in edges.items() if k[1].split("_")[1] in ids}
        return kept, edges, dict(run, kept=len(kept))

    # 1. the cube from its own capture (main.ipynb cell 3)
    cube_cams, cube_traj = _cube_scene(
        [TUTORIAL_CUBE_POS], TUTORIAL_CUBE_FRAMES, seed=2, res=TUTORIAL_RES,
        traj=calibration_sweep(TUTORIAL_CUBE_FRAMES, TUTORIAL_CUBE_POS))
    gray, names, frame_cams, render_s, pre_s = _tutorial_capture(cube_cams, cube_traj, markers,
                                                                 dev)
    aux, _, cube_run = detect(gray, names, frame_cams)
    del gray
    emit("tutorial_capture", capture="cube", render_s=render_s, preprocess_s=pre_s, **cube_run)
    t0 = time.perf_counter()
    obj_pose_est = object_bipartite_se3sync(
        aux,
        noise_model_r=lambda e: 0.01 * polygon_area(e["corners"]) ** 2,
        noise_model_t=lambda e: 0.001 * polygon_area(e["corners"]) ** 2.0,
        edge_filter=lambda e: e["reprojected_err"] < 0.1,
        maxiter=4, lsqr_solver="conjugate_gradient", dtype=np.float64, verbose=False)
    object_s = time.perf_counter() - t0
    emit("tutorial_object", markers=len(obj_pose_est), edges=len(aux), seconds=object_s)
    if sorted(obj_pose_est, key=int) != TUTORIAL_IDS:
        raise AssertionError(f"tutorial: the object stage recovered {len(obj_pose_est)} of "
                             f"{len(TUTORIAL_IDS)} markers")

    # 2. the room capture (cell 5), 3. the camera network (cell 7)
    room_cams, room_traj = _cube_scene(TUTORIAL_RIG, TUTORIAL_ROOM_STEPS, seed=1,
                                       res=TUTORIAL_RES, wander=True)
    gray, names, frame_cams, render_s, pre_s = _tutorial_capture(room_cams, room_traj, markers,
                                                                 dev)
    cam_marker_edges, room_all, room_run = detect(gray, names, frame_cams)
    emit("tutorial_capture", capture="room", render_s=render_s, preprocess_s=pre_s, **room_run)
    edges = {k: v for k, v in cam_marker_edges.items()
             if int(k[1].split("_")[0]) < TUTORIAL_TMAX}
    t0 = time.perf_counter()
    pose_est = bipartite_se3sync(
        edges, constraints=obj_pose_est,
        noise_model_r=lambda e: 0.001 * polygon_area(e["corners"]) ** 1.0,
        noise_model_t=lambda e: 0.001 * polygon_area(e["corners"]) ** 2.0,
        edge_filter=lambda e: e["reprojected_err"] < 0.05,
        maxiter=4, lsqr_solver="conjugate_gradient", dtype=np.float32, verbose=False)
    network_s = time.perf_counter() - t0
    _check_packer()

    # 4. ground truth (cell 9)
    report = evaluate_calibration(room_cams, pose_est)
    summary = report.summary()
    emit("tutorial_network", seconds=network_s, edges=len(edges),
         cameras=len(report.valid_cam_ids), summary=summary, report=str(report).splitlines())
    launches = cube_run["kernel_launches"] + room_run["kernel_launches"]
    pnp_launches = cube_run["pnp_launches"] + room_run["pnp_launches"]
    detect_launches = cube_run["detect_launches"] + room_run["detect_launches"]
    peak = torch.cuda.max_memory_allocated()
    batches = cube_run["batches"] + room_run["batches"]

    # the first 8 room frames on the CPU (the kernels' plain versions)
    cpu = estimate_pose_gray(gray[:8], names[:8], frame_cams[:8], device="cpu", **TUTORIAL_KW)
    first = {k: v for k, v in room_all.items() if v["im_filename"] in set(names[:8])}
    d_corner = max((float(np.abs(first[k]["corners"] - cpu[k]["corners"]).max())
                    for k in cpu if k in first), default=0.0)
    del gray
    # the room's edge dict through the .pt interchange
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "cam_marker_edges.pt")
        save_edges(path, cam_marker_edges)
        back = load_edges(path)
    round_trip = list(back) == list(cam_marker_edges) and all(
        np.array_equal(back[k]["pose"].pose(), v["pose"].pose())
        and np.array_equal(back[k]["corners"], v["corners"])
        and back[k]["reprojected_err"] == v["reprojected_err"]
        and back[k]["im_filename"] == v["im_filename"] for k, v in cam_marker_edges.items())
    emit("tutorial", seconds=time.perf_counter() - t_start, kernel_launches=launches,
         pnp_launches=pnp_launches, detect_launches=detect_launches, batches=batches,
         max_memory_allocated=peak, cpu_frames=8,
         detections_cpu=len(cpu), detections_card=len(first), same_keys=set(cpu) == set(first),
         max_corner_diff_px=d_corner, save_load_identical=round_trip)
    faults = []
    if launches < batches:
        faults.append(f"{launches} threshold launches for {batches} batches")
    faults += _launch_faults("T", dict(pnp_launches=pnp_launches, detect_launches=detect_launches,
                                    batches=batches))
    faults += _host_faults("cube", cube_run) + _host_faults("room", room_run)
    if not (summary["SO3_deg"]["avg"] < 1.0 and summary["E3_cm"]["avg"] < 10.0):
        faults.append(f"camera errors {summary['SO3_deg']['avg']} deg, "
                      f"{summary['E3_cm']['avg']} cm on average")
    if report.missing_cam_ids:
        faults.append(f"cameras {report.missing_cam_ids} not calibrated")
    if set(cpu) != set(first) or not d_corner < 1e-3:
        faults.append(f"CPU keys {set(cpu) ^ set(first)}, corners {d_corner} px apart")
    if not round_trip:
        faults.append("save_edges / load_edges changed the edge dict")
    if faults:
        raise AssertionError(f"tutorial: {faults}")
    return launches, pnp_launches, detect_launches


def _build_native(only_present: bool = False) -> list:
    """Build the port's C modules (the edge packer, the labeler, the host
    threshold) and raise naming any that did not build; ``only_present``
    skips those the checkout has no getter for (an older checkout)."""
    from vican_torch import _native

    names = [n for n in ("fastpack", "fastccl", "fastthresh")
             if not only_present or hasattr(_native, f"get_{n}")]
    missing = [n for n in names if getattr(_native, f"get_{n}")() is None]
    if missing:
        raise AssertionError(f"the C modules {missing} did not build: {_native.build_errors}")
    return names


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device is available")
    if "--mesh-child" in sys.argv:
        mesh_child()
        return
    sys.path.insert(0, REPO)
    from vican_torch import _kernels, bipgo
    from vican_torch.geometry import distance_SO3
    from vican_torch.solver.pwr import pwr_apply
    from vican_torch.synthetic import make_problem_arrays

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    # the host packages the card machine offers: the port's card path needs
    # none of them (JPEG I/O and plots are host work)
    host_packages = {m: importlib.util.find_spec(m) is not None
                     for m in ("cv2", "PIL", "matplotlib")}
    emit("device", kind=name, count=count, nvidia_smi=smi, torch=torch.__version__,
         cuda=torch.version.cuda, host_packages=host_packages)

    # the perception modes launch the threshold and PnP kernels (a checkout
    # without pnp.cu builds the threshold kernel alone); --mesh's child
    # runs the solver and perception
    partial = any(a in sys.argv for a in ("--threshold", "--perception", "--tutorial", "--pure",
                                          "--pipeline", "--pnp", "--detect"))
    perception_kernels = [k for k in ("threshold", "pnp", "detect") if k in _kernels.SOURCES]
    t0 = time.perf_counter()
    logs = _kernels.build(["threshold"] if "--threshold" in sys.argv
                          else perception_kernels if partial
                          else ["pwr", *perception_kernels] if "--mesh" in sys.argv else None)
    build_s = time.perf_counter() - t0
    ptxas = logs.get("threshold", {}).get("ptxas", "")
    pnp_ptxas = logs.get("pnp", {}).get("ptxas", "")
    detect_ptxas = logs.get("detect", {}).get("ptxas", "")
    if "--threshold" in sys.argv:
        emit("build", seconds=build_s,
             kernels={k: _ptxas_summary(v["ptxas"]) for k, v in logs.items()})
        frames = perception_scene(dev, 32 // 8)[3]
        threshold_phase(frames, ptxas)
        from vican_torch.ops import threshold as th

        if hasattr(th, "threshold_plan"):
            threshold_sweep(frames[:32].contiguous())
        return
    t0 = time.perf_counter()
    native = _build_native(only_present="--perception" in sys.argv)
    emit("build", seconds=build_s, native_seconds=time.perf_counter() - t0, native=native,
         kernels={k: _ptxas_summary(v["ptxas"]) for k, v in logs.items()})
    if "--tutorial" in sys.argv:
        tutorial_phase(dev)
        return
    if "--pnp" in sys.argv:
        frames, names, frame_cams = perception_scene(dev, 32 // 8)[3:]
        pnp_phase(dev, capture_pnp_batch(frames.cpu().numpy(), names, frame_cams), pnp_ptxas)
        return
    if "--detect" in sys.argv:
        frames, names, frame_cams = perception_scene(dev, 32 // 8)[3:]
        detect_phase(capture_detect_batch(frames.cpu().numpy(), names, frame_cams), detect_ptxas)
        return
    if "--mesh" in sys.argv:
        mesh_phase()
        return
    if "--pipeline" in sys.argv:
        scene = perception_scene(dev)
        host, names, frame_cams = scene[3].cpu().numpy(), scene[4], scene[5]
        del scene
        torch.cuda.empty_cache()
        # a warm-up run: the first perception of a process pays CUDA's and
        # the allocator's start-up
        _, warm = _perception_run(host, names, frame_cams)
        emit("pipeline_warmup", **warm)
        pipeline_phase(host, names, frame_cams)
        return
    if "--pure" in sys.argv:
        _, device_run = perception_phases(dev, ptxas)
        pure_phase(device_run)
        if "--save" in sys.argv:
            save_pure_frames(device_run, sys.argv[sys.argv.index("--save") + 1])
        return
    if "--perception" in sys.argv:
        th, device_run = perception_phases(dev, ptxas)
        from vican_torch.perception import PHASES

        if "host threshold" in PHASES:
            perception_modes(device_run)
        return

    if "--split" in sys.argv:
        split_phase(dev)
        return
    rows = kernel_phase(dev)
    mv_rows = thin_mv_phase(dev)
    if "--kernels" in sys.argv:
        return

    # A: bench.py's problem, dense route, against the JAX package's accuracy
    prob = make_problem_arrays(**CONFIG_A)
    assert not bipgo._use_scale_path(CONFIG_A["n_cams"], CONFIG_A["n_times"], np.float32)
    pwr_apply.launches = 0
    est, first_s, _ = solve(prob)
    est, warm_s, log = solve(prob)
    r_err, t_err = accuracy(prob, est)
    emit("config_A", route="dense", packer=_last_packer(), first_s=first_s, warm_s=warm_s,
         rot_err_deg=r_err, trans_err_m=t_err, jax_rot_err_deg=JAX_A_ROT_DEG,
         jax_trans_err_m=JAX_A_TRANS_M, kernel_launches=pwr_apply.launches, log=log)
    if not (abs(r_err - JAX_A_ROT_DEG) < A_ROT_TOL_DEG
            and abs(t_err - JAX_A_TRANS_M) < A_TRANS_TOL_M):
        raise AssertionError(f"config A: ({r_err}, {t_err}) vs JAX "
                             f"({JAX_A_ROT_DEG}, {JAX_A_TRANS_M})")
    del prob, est

    # B: 10k cameras, the large-graph route through the kernel
    t0 = time.perf_counter()
    prob = make_problem_arrays(**CONFIG_B)
    gen_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    pwr_apply.launches = 0
    est, solve_s, log = solve(prob)
    launches = pwr_apply.launches
    r_err, t_err = accuracy(prob, est)
    R = np.stack([est[c].R() for c in prob.cams_gt]).astype(np.float64)
    ortho = float(np.abs(R @ R.transpose(0, 2, 1) - np.eye(3)).max())
    finite = all(np.isfinite(p.pose()).all() for p in est.values())
    emit("config_B", route="large-graph", packer=_last_packer(), gen_s=gen_s, solve_s=solve_s,
         rot_err_deg=r_err, trans_err_m=t_err, kernel_launches=launches,
         max_memory_allocated=torch.cuda.max_memory_allocated(), ortho_err=ortho, log=log)
    if not any("Large-graph path" in line for line in log):
        raise AssertionError("config B did not take the large-graph route")
    if launches <= 0:
        raise AssertionError("config B: the filter kernel was never launched")
    if not (finite and ortho < 1e-4 and r_err < 3.0):
        raise AssertionError(f"config B: finite={finite} ortho={ortho} rot_err={r_err}")
    del est
    emit("profile_B", **profile_phase(prob))
    del prob

    # C: 2048 cameras through both routes
    prob = make_problem_arrays(**CONFIG_C)
    pwr_apply.launches = 0
    large, large_s, log_large = solve(prob)
    launches_c = pwr_apply.launches
    dense, dense_s, log_dense = solve(prob, VICAN_TPU_SCALE_MIN_CAMS="4096")
    if not any("Large-graph path" in line for line in log_large) or any(
            "Large-graph path" in line for line in log_dense):
        raise AssertionError("config C: routes were not large-graph then dense")
    d_cam = max(distance_SO3(np.asarray(large[c].R(), np.float64),
                             np.asarray(dense[c].R(), np.float64)) for c in prob.cams_gt)
    emit("config_C", packer=_last_packer(), large_s=large_s, dense_s=dense_s,
         max_cam_rot_diff_deg=d_cam,
         kernel_launches_large=launches_c, acc_large=accuracy(prob, large),
         acc_dense=accuracy(prob, dense), log_large=log_large, log_dense=log_dense)
    if not d_cam < 0.2:
        raise AssertionError(f"config C: routes differ by {d_cam} deg")
    del prob, large, dense

    d = config_d_phase(dev)
    torch.cuda.empty_cache()
    launches_mesh, pnp_mesh, detect_mesh = mesh_phase()

    th, device_run = perception_phases(dev, ptxas)
    pnp = pnp_phase(dev, capture_pnp_batch(*device_run[:3]), pnp_ptxas)
    det = detect_phase(capture_detect_batch(*device_run[:3]), detect_ptxas)
    perception_modes(device_run)
    pipeline_phase(*device_run)
    launches_pure, pnp_pure, detect_pure = pure_phase(device_run)
    del device_run
    launches_t, pnp_t, detect_t = tutorial_phase(dev)

    w10 = rows["B", 10]
    kernels = [{
        "name": "pwr_apply", "route": "cuda", "source": "vican_torch/csrc/pwr.cu",
        "replaces": "vican_tpu/solver/pallas_pwr.py:65",
        "launches": launches, "launches_mesh": launches_mesh,
        "max_abs_err": max(r["max_abs_err"] for r in rows.values()),
        "max_rel_err": max(r["max_rel_err"] for r in rows.values()),
        "ms": w10["ms"], "kernel_ms": w10["ms"], "plain_ms": w10["plain_ms"],
        "bound_ms": w10["bound_ms"], "bound_by": w10["bound_by"],
        "library_ms": w10["library_ms"], "w": 10, "design": w10["design"],
        "cell_C": {k: rows["C", 10][k] for k in ("ms", "bound_ms", "library_ms", "design")},
    }, {
        "name": "multi_threshold", "route": "cuda", "source": "vican_torch/csrc/threshold.cu",
        "replaces": "vican_tpu/ops/pallas/threshold.py:33",
        "launches": th["launches"], "launches_pure": launches_pure, "launches_T": launches_t,
        "max_abs_err": th["max_abs_err"],
        "differing_bytes": th["differing_bytes"], "ms": th["ms"], "kernel_ms": th["kernel_ms"],
        "plain_ms": th["plain_ms"],
        "bound_ms": th["bound_ms"], "bound_by": th["bound_by"],
        "pipes_bound_ms": th["pipes_bound_ms"], "pipes_bound_by": th["pipes_bound_by"],
        "library_ms": th["library_ms"], "shape": th["shape"], "design": th["design"],
        "registers": th["registers"], "smem_static": th["smem_static"],
        "smem_dynamic": th["smem_dynamic"], "spilling": th["spilling"],
        "cases_ms": {c["case"]: c["ms"] for c in th["checks"]},
    }, {
        "name": "thin_mv", "route": "cuda", "source": "vican_torch/csrc/mv.cu",
        "replaces": "benchmarks/mv_kernel_probe.py:36",
        "launches": d["launches"],
        "max_abs_err": max(r["max_abs_err"] for r in mv_rows.values()),
        "max_rel_err": max(r["max_rel_err"] for r in mv_rows.values()),
        **{k: mv_rows["streaming w=10"][k]
           for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "shape")},
        "probe": {k: mv_rows["probe"][k] for k in ("ms", "library_ms", "bound_ms", "shape")},
    }, {
        "name": "pnp_block", "route": "cuda", "source": "vican_torch/csrc/pnp.cu",
        "replaces": "vican_tpu/perception.py:883",
        "launches": th["pnp_launches"], "launches_pure": pnp_pure, "launches_T": pnp_t,
        "launches_mesh": pnp_mesh, "max_abs_err": pnp["max_abs_err"],
        **{k: pnp[k] for k in ("ms", "kernel_ms", "launch_ms", "plain_ms", "bound_ms",
                               "bound_by", "library_ms", "shape", "valid_slots", "method",
                               "design", "one_slot_kernel_ms")},
    }, {
        "name": "detect_candidates", "route": "cuda", "source": "vican_torch/csrc/detect.cu",
        "replaces": "vican_tpu/perception.py:939",
        "launches": th["detect_launches"], "launches_pure": detect_pure, "launches_T": detect_t,
        "launches_mesh": detect_mesh, "max_abs_err": det["max_abs_err"],
        **{k: det[k] for k in ("ms", "kernel_ms", "launch_ms", "plain_ms", "bound_ms",
                               "bound_by", "library_ms", "shape", "refine", "design", "split",
                               "one_slot_kernel_ms")},
        "kinds_kernel_ms": {k: v["kernel_ms"] for k, v in det["kinds"].items()},
    }]
    emit("done", seconds=time.perf_counter() - t_start)
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": count}}))


if __name__ == "__main__":
    main()
