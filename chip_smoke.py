"""Smoke test of the PyTorch/CUDA port (``vican_torch``) on one NVIDIA GPU.

Run from the repository root on a machine with a CUDA card and ``nvcc``:

    python3 chip_smoke.py

It builds the port's CUDA kernel from ``vican_torch/csrc``, holds it against
its plain PyTorch version at the 10k-camera shapes and times both, then
drives the public entry point ``vican_torch.bipgo.bipartite_se3sync`` on
three synthetic problems:

- A, bench.py's large_shop problem (100 cameras, 10k timesteps, 120k
  edges), the dense route, checked against the JAX package's accuracy on
  the same problem;
- B, 10k cameras / 10k timesteps / 1M edges, the large-graph route, whose
  CheFSI filter runs on the kernel (launches counted);
- C, 2048 cameras / 10k timesteps / 240k edges through both routes, which
  must agree.

One JSON line per phase; any failed check raises, so the exit code is not
0.  The last lines are the card's ``nvidia-smi`` name and power limit, the
kernels' JSON line, and ``{"ok": true, "device": {...}}``.  Without a CUDA
card, or without the rest of the repository beside it, it fails before
printing any result.
"""
from __future__ import annotations

import contextlib
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

# Published peaks of one H100 SXM at its 700 W limit (NVIDIA's data sheet,
# dense): device-memory bytes/s and bf16 tensor-core FLOP/s.  The card's
# name and power limit are printed beside every time.
PEAK_BYTES_S = 3.35e12
PEAK_BF16_FLOPS = 989e12


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def _median_ms(fn, reps: int = 20) -> float:
    """Median of ``reps`` warm launches, each timed with CUDA events."""
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


def solve(prob, **env):
    """One timed bipartite_se3sync call; returns (poses, seconds, log lines)."""
    import torch

    from vican_torch import bipgo

    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    buf = io.StringIO()
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            est = bipgo.bipartite_se3sync(
                prob.edges, constraints=prob.constraints(), noise_model_r=_one,
                noise_model_t=_one, edge_filter=_filt, maxiter=MAXITER,
                lsqr_solver="conjugate_gradient", dtype=np.float32, verbose=True,
            )
        seconds = time.perf_counter() - t0
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return est, seconds, buf.getvalue().splitlines()


def _ptxas_summary(log: str) -> dict:
    """Kernel count, most registers and shared memory of any kernel, and
    the kernels that spill, from nvcc's ``-Xptxas -v`` report."""
    per, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
            per[name] = {"registers": 0, "smem": 0, "spill_stores": 0}
        elif name is not None:
            for key, pat in (("registers", r"Used (\d+) registers"),
                             ("smem", r"(\d+) bytes smem"),
                             ("spill_stores", r"(\d+) bytes spill stores")):
                m = re.search(pat, line)
                if m:
                    per[name][key] = int(m.group(1))
    return {
        "kernels": len(per),
        "max_registers": max((v["registers"] for v in per.values()), default=0),
        "max_smem": max((v["smem"] for v in per.values()), default=0),
        "spilling": sorted(k for k, v in per.items() if v["spill_stores"]),
    }


def kernel_phase(dev):
    """pwr_apply against its plain version at the 10k-camera shapes, on an
    operator built like the main path's (1M random 3x3 rotation blocks in a
    (3C, 3T) operator; Lambda_T the degree-normalized initial time dual
    plus a random non-symmetric part, so a transposed Lambda would show; an
    orthonormal X), and timed beside its bound and two library matmuls.

    The bar, 1e-3 of max |Y|: the kernel sums Z = B^T X in float32 in
    another order than cuBLAS, which can flip the bf16 rounding of single
    entries of W = Lambda Z.  One flip moves every Y entry it touches by
    2^-8 |W_q| |B_qi|; with ~300 nonzeros per column of this operator that
    is ~6e-5 of max |Y| (1.2e-4 measured at w=10 on an H100).  1e-3 admits
    a dozen flips on one entry; an indexing or masking fault shows at O(1).
    """
    import torch

    from vican_torch.ops.lie import quat_to_mat
    from vican_torch.solver.core import block_matrix
    from vican_torch.solver.pwr import filter_operator, pwr_apply, pwr_apply_plain

    C, T, E = CONFIG_B["n_cams"], CONFIG_B["n_times"], CONFIG_B["n_edges"]
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
    n = 3 * C

    def library(X):
        # yardstick only: two bf16 matmuls with the blockwise Lambda between
        w = X.shape[1]
        Z = torch.matmul(Bt[:, :n], X.to(torch.bfloat16)).float()
        Z = torch.einsum("tab,tbw->taw", lbd, Z.view(T, 3, w)).reshape(3 * T, w)
        return torch.matmul(Bt[:, :n].T, Z.to(torch.bfloat16))

    rows = {}
    for w in (1, 10, 16):
        X, _ = torch.linalg.qr(torch.randn((n, w), generator=g, device=dev))
        out = pwr_apply(Bt, lbd, X)
        torch.cuda.synchronize()
        ref = pwr_apply_plain(Bt, lbd, X)
        abs_err = float((out - ref).abs().max())
        rel_err = abs_err / float(ref.abs().max())
        if not (rel_err < KERNEL_REL_TOL and torch.isfinite(out).all()):
            raise AssertionError(f"pwr_apply w={w}: rel err {rel_err} >= {KERNEL_REL_TOL}")
        ms = _median_ms(lambda: pwr_apply(Bt, lbd, X))
        plain_ms = _median_ms(lambda: pwr_apply_plain(Bt, lbd, X))
        library_ms = _median_ms(lambda: library(X))
        nbytes = Bt.numel() * 2 + n * w * 2 + T * 9 * 4 + n * w * 4
        ops = 2 * 2 * 3 * T * n * w
        t_bytes, t_ops = nbytes / PEAK_BYTES_S, ops / PEAK_BF16_FLOPS
        rows[w] = dict(w=w, max_abs_err=abs_err, max_rel_err=rel_err, ms=ms,
                       plain_ms=plain_ms, library_ms=library_ms,
                       bound_ms=max(t_bytes, t_ops) * 1e3,
                       bound_by="bytes" if t_bytes >= t_ops else "operations",
                       bytes=nbytes, ops=ops)
        emit("kernel", name="pwr_apply", shape=[3 * T, n, w], **rows[w])
    del Bt
    torch.cuda.empty_cache()
    return rows


def profile_phase(prob) -> dict:
    """Cell B's solve again under ``torch.profiler`` with the solver's
    phase ranges on: device time by kernel, and the share of the
    large-graph solve phase during which the card ran a kernel."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, seconds, log = solve(prob, VICAN_TPU_TRACE="1")
    events = prof.events()
    # the phase ranges also appear on the device timeline, under the names
    # of their host-side ranges: keep only device work
    host_names = {e.name for e in events if e.device_type == DeviceType.CPU}
    kernels = [e for e in events
               if e.device_type == DeviceType.CUDA and e.name not in host_names]
    out = {"traced_solve_s": seconds, "device_kernels": len(kernels), "log": log}
    phase = next((e for e in events if e.name.startswith("Optimizing (chunked")), None)
    if not kernels or phase is None:
        return out  # no device activity in the trace: not measured
    lo, hi = phase.time_range.start, phase.time_range.end
    busy, end = 0.0, lo
    for s, e in sorted((max(k.time_range.start, lo), min(k.time_range.end, hi))
                       for k in kernels):
        if e > max(s, end):
            busy += e - max(s, end)
            end = e
    by_name: dict = {}
    for k in kernels:
        by_name[k.name] = by_name.get(k.name, 0.0) + (k.time_range.end - k.time_range.start)
    pwr_us = sum(v for n, v in by_name.items() if "pwr_" in n)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    out.update(
        solve_phase_s=(hi - lo) * 1e-6, device_busy_s=busy * 1e-6,
        device_busy_share=busy / (hi - lo), pwr_kernels_s=pwr_us * 1e-6,
        all_kernels_s=sum(by_name.values()) * 1e-6,
        top_kernels=[[n[:80], v * 1e-6] for n, v in top],
    )
    return out


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device is available")
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
    emit("device", kind=name, count=count, nvidia_smi=smi, torch=torch.__version__,
         cuda=torch.version.cuda)

    t0 = time.perf_counter()
    logs = _kernels.build()
    emit("build", seconds=time.perf_counter() - t0,
         kernels={k: _ptxas_summary(v["ptxas"]) for k, v in logs.items()})

    rows = kernel_phase(dev)

    # A: bench.py's problem, dense route, against the JAX package's accuracy
    prob = make_problem_arrays(**CONFIG_A)
    assert not bipgo._use_scale_path(CONFIG_A["n_cams"], CONFIG_A["n_times"], np.float32)
    pwr_apply.launches = 0
    est, first_s, _ = solve(prob)
    est, warm_s, log = solve(prob)
    r_err, t_err = accuracy(prob, est)
    emit("config_A", route="dense", first_s=first_s, warm_s=warm_s,
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
    emit("config_B", route="large-graph", gen_s=gen_s, solve_s=solve_s,
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
    emit("config_C", large_s=large_s, dense_s=dense_s, max_cam_rot_diff_deg=d_cam,
         kernel_launches_large=launches_c, acc_large=accuracy(prob, large),
         acc_dense=accuracy(prob, dense), log_large=log_large, log_dense=log_dense)
    if not d_cam < 0.2:
        raise AssertionError(f"config C: routes differ by {d_cam} deg")

    w10 = rows[10]
    kernels = [{
        "name": "pwr_apply", "route": "cuda", "source": "vican_torch/csrc/pwr.cu",
        "replaces": "vican_tpu/solver/pallas_pwr.py:65",
        "launches": launches, "max_abs_err": max(r["max_abs_err"] for r in rows.values()),
        "max_rel_err": max(r["max_rel_err"] for r in rows.values()),
        "ms": w10["ms"], "kernel_ms": w10["ms"], "plain_ms": w10["plain_ms"],
        "bound_ms": w10["bound_ms"], "bound_by": w10["bound_by"],
        "library_ms": w10["library_ms"], "w": 10,
    }]
    emit("done", seconds=time.perf_counter() - t_start)
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": count}}))


if __name__ == "__main__":
    main()
