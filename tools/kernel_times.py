"""Time each hand kernel of the port alone on the card through its public
wrapper, at the shapes of PERF.md's kernel table.  Needs a CUDA card.

    python3 tools/kernel_times.py [pwr_apply thin_mv multi_threshold pnp_block detect_candidates]

(all five by default).  Prints the card's name and power limit, the ptxas
report of each kernel it built, then one JSON line a case: ``ms`` (warm
calls back to back), ``launch_ms`` (the median call alone, launch work
included), ``kernel_ms`` (the device time alone, behind a device sleep),
``split`` (each CUDA kernel's device ms, ``torch.profiler``), ``plain_ms``
(the plain version on the card) and ``bound_ms`` (the least time the
card's peaks allow for the work the function needs).  Cases: ``pwr_apply``
at ``tests/torch_bars.CELLS`` B and C, w = 1, 10, 16; ``thin_mv`` at
``torch_bars.thin_mv_cases``; the rest on P's first batch
(``torch_bars.p_first_batch``: 32 frames of 1280x720) as the pipeline hands
it over: the threshold; PnP in both methods, on 4104 seeded slots
and with one valid slot (the chain's floor); detect at each refine kind
and with one valid slot (one and two decode attempts).  It only times
(``tests/test_torch_gpu.py`` checks); copied with ``tests/torch_bars.py``
into an older checkout, it times that checkout's kernels.
"""
import json
import os
import re
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [REPO, os.path.join(REPO, "tests")]

# Peaks of one H100 SXM at 700 W: device-memory bytes/s, dense bf16
# tensor-core FLOP/s and float64 outside the tensor cores (NVIDIA's data
# sheet); int32 and fp32 lanes (64 and 128 an SM, Hopper white paper) x 132
# SMs x the 1.98 GHz boost clock
PEAK_BYTES_S, PEAK_BF16, PEAK_FP64 = 3.35e12, 989e12, 34e12
PEAK_INT32, PEAK_FP32 = 64 * 132 * 1.98e9, 128 * 132 * 1.98e9
# Float64 operations of a valid PnP slot from csrc/pnp.cu (+, -, x, /, sqrt,
# sin, cos, acos one each; a dual product 19, a dual sum 7): an LM trip
# (Rodrigues 387, projections 2196, sums 456, 6x6 solve 209, trial 265,
# update 3), a pass, IPPE (undistortion 1488, homography 444, the rest 972),
# the iterative method's start (those two and 1489), the reprojection error
PNP_FLOPS = dict(lm_trip=3516, lm_pass=71, ippe=2904, iterative_init=3421, error=220)
# Detect's float64 operations from csrc/detect.cu (+, -, x, /, sqrt, floor,
# min, max one each); a dictionary code's xor, popcount and compare int32
DETECT_OPS = dict(bilinear=23, probe=20, edge_sample=20, slot_fit=250, subpix_pixel=24,
                  subpix_solve=20, sample=27, cell=4, otsu_bin=15, code=3, homography=460)
SOURCES = {"pwr_apply": "pwr", "thin_mv": "mv", "multi_threshold": "threshold",
           "pnp_block": "pnp", "detect_candidates": "detect"}

def emit(case: str, **fields) -> None:
    print(json.dumps({"case": case, **fields}), flush=True)


def rate_ms(fn, reps: int = 50, sleep: bool = False) -> float:
    """ms a call of ``reps`` warm calls back to back between two CUDA
    events, the host's work hidden; ``sleep``: queued behind ~0.1 s of
    device sleep, so the host enqueues them all before the first runs."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    if sleep:
        torch.cuda._sleep(200_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn) -> float:
    """The device time alone, where a call's host work is as long as its kernel."""
    return rate_ms(fn, sleep=True)


def median_ms(fn, reps: int = 20) -> float:
    """The median warm call timed alone: device time and launch work."""
    return float(np.median([rate_ms(fn, 1) for _ in range(reps)]))


def kernel_split(fn, reps: int = 10) -> dict:
    """Device ms a call of each kernel ``fn`` launches, by its name."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return {e.key[:90]: us / reps * 1e-3 for e in prof.key_averages()
            if (us := getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0))}


def ptxas_kernels(log: str) -> dict:
    """Each kernel of an ``-Xptxas -v`` report by (mangled) name: its
    registers, shared memory, stack frame and spill bytes."""
    per, name = {}, None
    for line in log.splitlines():
        if m := re.search(r"(Compiling entry function|Function properties for) '?([^'\s]+)", line):
            name = m.group(2)
            if m.group(1).startswith("Comp"):
                per[name] = {}
        elif name in per:
            per[name].update((k.replace(" ", "_"), int(v)) for v, k in re.findall(
                r"(\d+) (?:bytes )?(registers|smem|stack frame|spill stores|spill loads)", line))
    return per


def bound(nbytes: float, ops_s: float) -> dict:
    """The larger of the bytes' time and the operations' (``ops_s``)."""
    t_bytes = nbytes / PEAK_BYTES_S
    return dict(bytes=nbytes, bound_ms=max(t_bytes, ops_s) * 1e3,
                bound_by="bytes" if t_bytes >= ops_s else "operations")


def pwr_apply_cases(dev) -> None:
    import torch

    from torch_bars import CELLS, filter_problem
    from vican_torch.solver.pwr import pwr_apply, pwr_apply_plain, pwr_plan

    for cell, cfg in CELLS.items():
        Bt, lbd, n, T = filter_problem(dev, cfg)
        g = torch.Generator(device=dev).manual_seed(1)
        for w in (1, 10, 16):
            X = torch.randn((n, w), generator=g, device=dev)
            run = lambda: pwr_apply(Bt, lbd, X)  # noqa: E731
            emit("pwr_apply", cell=cell, shape=[3 * T, n, w], design=pwr_plan(n, T, w).design,
                 ms=rate_ms(run), launch_ms=median_ms(run), split=kernel_split(run),
                 plain_ms=rate_ms(lambda: pwr_apply_plain(Bt, lbd, X)),
                 **bound(Bt.numel() * 2 + n * w * 6 + T * 36, 12 * T * n * w / PEAK_BF16))
        del Bt, lbd
        torch.cuda.empty_cache()


def thin_mv_cases(dev) -> None:
    import torch_bars
    from vican_torch.solver.mv import thin_mv, thin_mv_plain

    for label, B, X in torch_bars.thin_mv_cases(dev):
        (M, K), w = B.shape, X.shape[1]
        run = lambda: thin_mv(B, X)  # noqa: E731
        emit("thin_mv", label=label, shape=[M, K, w], ms=rate_ms(run), launch_ms=median_ms(run),
             split=kernel_split(run), plain_ms=rate_ms(lambda: thin_mv_plain(B, X)),
             **bound(M * K * 2 + K * w * 2 + M * w * 4, 2 * M * K * w / PEAK_BF16))


def multi_threshold_cases(frames) -> None:
    """The int32 operations the function needs: an integral image of each
    replicate-padded frame (2 an entry), g + C a pixel, and per window and
    pixel a 3-term box sum, the scale and the compare; ``pipes_bound_ms``
    on the FP32 and INT32 pipes together."""
    from vican_torch.ops.threshold import WIN_SIZES, multi_threshold, multi_threshold_plain

    B, H, W = frames.shape
    R, n = max(WIN_SIZES) // 2, len(WIN_SIZES)
    ops = B * (H + 2 * R) * (W + 2 * R) * 2 + B * H * W * (1 + 5 * n)
    nbytes = B * H * W + B * n * H * (-(-W // 8))
    run = lambda: multi_threshold(frames, WIN_SIZES, 10.0)  # noqa: E731
    emit("multi_threshold", shape=[B, H, W], kernel_ms=device_ms(run), ms=rate_ms(run),
         launch_ms=median_ms(run), split=kernel_split(run),
         plain_ms=rate_ms(lambda: multi_threshold_plain(frames, WIN_SIZES, 10.0)), ops=ops,
         pipes_bound_ms=bound(nbytes, ops / (PEAK_FP32 + PEAK_INT32))["bound_ms"],
         **bound(nbytes, ops / PEAK_INT32))


def pnp_block_cases(p_batch, dev) -> None:
    import torch

    from torch_bars import PNP_MARKER, pnp_slots
    from vican_torch.ops.pnp import pnp_block, pnp_block_plain

    corners, ids, valid, Ks, dists, size, iters, method = p_batch
    one = torch.zeros_like(valid)
    one[int(valid.nonzero()[0, 0])] = True
    N, n_valid = corners.shape[0], int(valid.sum())
    for m in ("ippe_square", "iterative"):
        def run(m=m, v=valid, it=iters):
            return pnp_block(corners, ids, v, Ks, dists, size, it, m)

        row = dict(kernel_ms=device_ms(run), ms=rate_ms(run), launch_ms=median_ms(run))
        if m == method:
            seeded = pnp_slots(171, 24, 9, True, dev)
            row.update(seeded_kernel_ms=device_ms(lambda: pnp_block(*seeded, PNP_MARKER, 20, m)),
                       one_slot_kernel_ms={f"lm_iters_{it}": device_ms(lambda it=it: run(
                           v=one, it=it)) for it in (0, iters)},
                       plain_ms=median_ms(lambda: pnp_block_plain(
                           corners, ids, valid, Ks, dists, size, iters, m), reps=5))
        f = PNP_FLOPS
        lm = f["lm_pass"] + iters * f["lm_trip"]  # a valid slot's, in each method
        ops = n_valid * (f["error"] + (f["ippe"] + lm if m == "ippe_square"
                                       else f["iterative_init"] + 2 * lm))
        emit("pnp_block", shape=[N, 4, 2], valid_slots=n_valid, method=m, lm_iters=iters, **row,
             ops=ops, **bound(N * 257 + Ks.shape[0] * 184, ops / PEAK_FP64))


def _first_attempts(gray, quads, valid, codes, n_bits, params):
    """The valid slots' flat indices and whether each passes its first
    decode attempt, by the plain version's refine and first pass."""
    import torch

    from vican_torch.ops import detect as TD

    idx = valid.reshape(-1).nonzero()[:, 0]
    bi = idx // valid.shape[1]
    refined = TD.refine_quad(gray, bi, quads.reshape(-1, 4, 2)[idx].double(), params)
    ok1 = TD._decode_pass(gray, bi, TD._quad_homography(refined, n_bits + 2),
                          torch.ones_like(idx, dtype=torch.bool), codes, n_bits, params, 1.0)[2]
    return idx, ok1


def one_slot_batches(gray, quads, valid, codes, n_bits, params) -> dict:
    """``valid`` with one valid slot left: the first whose first decode
    attempt passes, and the first that takes the second."""
    import torch

    idx, ok1 = _first_attempts(gray, quads, valid, codes, n_bits, params)
    out = {}
    for case, pick in (("first_attempt", ok1), ("second_attempt", ~ok1)):
        out[case] = torch.zeros_like(valid)
        out[case].view(-1)[idx[pick.nonzero()[0, 0]]] = True
    return out


def detect_work(gray, quads, valid, codes, n_bits, params) -> dict:
    """What the detect kernels must do on these inputs: the valid slots,
    second decode attempts and, under subpix, each corner's first
    cornerSubPix trip (every corner takes one; the later ones are not
    counted, so the bound stays a floor); the float64 and int32 operations
    (:data:`DETECT_OPS`); the bytes of the candidates, codes and tables read
    once, the Detections written once and the frame bytes under the
    bilinear samples (4 pixels a sample, at most the frames)."""
    B, Q = valid.shape
    idx, ok1 = _first_attempts(gray, quads, valid, codes, n_bits, params)
    o, cells = DETECT_OPS, n_bits + 2
    n_valid, n_second = int(idx.numel()), int((~ok1).sum())
    S, O, side = params.refine_samples, params.refine_offsets, 2 * params.subpix_win + 1
    samples = cells * cells * params.decode_samples ** 2
    trips = 4 * n_valid if params.corner_refine == "subpix" else 0
    april = params.corner_refine == "apriltag"
    refine = 4 * S * (O * (o["probe"] + 2 * o["bilinear"]) + o["edge_sample"]) + o["slot_fit"]
    attempts = n_valid + n_second
    fp64 = (n_valid * (april * refine + o["homography"])
            + attempts * (samples * (o["sample"] + o["bilinear"]) + cells * cells * o["cell"]
                          + 64 * o["otsu_bin"])
            + trips * (side * side * (o["subpix_pixel"] + 4 * o["bilinear"]) + o["subpix_solve"]))
    int32 = attempts * codes.numel() * o["code"]
    taps = n_valid * april * 8 * S * O + trips * side * side * 4 + attempts * samples
    nbytes = (B * Q * 37 + codes.numel() * 8 + (S + O + side * side + 2 * params.decode_samples) * 8
              + B * min(params.max_detections, Q) * 77
              + min(4 * taps, gray.numel()) * gray.element_size())
    return dict(valid_slots=n_valid, second_attempts=n_second, subpix_first_trips=trips,
                fp64_ops=fp64, int32_ops=int32,
                **bound(nbytes, max(fp64 / PEAK_FP64, int32 / PEAK_INT32)))


def detect_candidates_cases(d_batch) -> None:
    import torch

    from vican_torch.ops.detect import detect_candidates, detect_candidates_plain

    gray, quads, valid, areas, codes, n_bits, params = d_batch
    quads, valid, areas = (torch.as_tensor(x, device=gray.device) for x in (quads, valid, areas))
    for kind in ("apriltag", "subpix", "none"):
        p = params._replace(corner_refine=kind)

        def run(p=p, v=valid):
            return detect_candidates(gray, quads, v, areas, codes, n_bits, p)

        row = dict(kernel_ms=device_ms(run), ms=rate_ms(run), launch_ms=median_ms(run),
                   split=kernel_split(run), plain_ms=median_ms(lambda: detect_candidates_plain(
                       gray, quads, valid, areas, codes, n_bits, p), reps=3))
        if kind == params.corner_refine:
            row["one_slot_kernel_ms"] = {case: device_ms(lambda one=one: run(v=one)) for case, one
                                         in one_slot_batches(gray, quads, valid, codes, n_bits,
                                                             params).items()}
        emit("detect_candidates", shape=list(quads.shape), frames=list(gray.shape), refine=kind,
             **row, **detect_work(gray, quads, valid, codes, n_bits, p))


def main() -> None:
    import torch

    from torch_bars import p_first_batch
    from vican_torch import _kernels

    wanted = [a for a in sys.argv[1:] if a in SOURCES] or list(SOURCES)
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(json.dumps({"card": smi, "torch": torch.__version__, "cuda": torch.version.cuda}))
    logs = _kernels.build([SOURCES[k] for k in wanted])
    print(json.dumps({"ptxas": {k: ptxas_kernels(v["ptxas"]) for k, v in logs.items()}}),
          flush=True)
    if "pwr_apply" in wanted:
        pwr_apply_cases(dev)
    if "thin_mv" in wanted:
        thin_mv_cases(dev)
    if {"multi_threshold", "pnp_block", "detect_candidates"} & set(wanted):
        frames, d_batch, p_batch = p_first_batch(dev)
        if "multi_threshold" in wanted:
            multi_threshold_cases(frames)
        if "pnp_block" in wanted:
            pnp_block_cases(p_batch, dev)
        if "detect_candidates" in wanted:
            detect_candidates_cases(d_batch)


if __name__ == "__main__":
    main()
