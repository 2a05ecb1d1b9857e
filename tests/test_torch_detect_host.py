"""The detect kernels of ``vican_torch/csrc/detect.cu`` built as host C++
(``g++ -std=c++20``) and held to ``detect_candidates_plain`` on the CPU.

A stand-in for ``cuda_runtime.h`` (:data:`SHIM`) defines the CUDA
qualifiers away and runs each CUDA thread of a block as a fiber
(``ucontext``) on one OS thread: a warp's lanes exchange a shuffle's or
vote's operands through 32 shared slots and a warp barrier, at which a
waiting fiber hands over to the next one, round robin; ``__syncthreads``
is the block's barrier, and a grid runs block by block.  (32 OS threads a
warp meeting at a ``std::barrier`` each step took over 120 s a case on a
host loaded by other work; the fibers' speed does not depend on it.)
The source is cut where its anonymous namespace ends (the C entry with
its ``<<<>>>`` launches stays out) and :data:`RUNNER` runs the kernels
grid by grid through the source's own ``plan_launches``.  Each case runs
in a child process under its own timeout, so a barrier that never opens
(a warp-wide step some lanes skip) fails the test.  The bars are
``tests/torch_bars.py``'s: valid, ids and scores identical on every output slot,
kept corners within ``DETECT_TOL`` px, every slot's within
``DETECT_ALL_TOL``.  The kernels' arithmetic is built with
``-ffp-contract=off``, as ``nvcc --fmad=false`` builds it on the card.
"""
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from torch_bars import detect_gaps, detect_ok
from torch_threads import two_threads  # noqa: F401
from vican_torch import perception, render
from vican_torch.cam import Camera
from vican_torch.ops import detect as TD
from vican_torch.ops.dictionary import marker_bits_table
from vican_torch.ops.threshold import multi_threshold

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(REPO, "vican_torch", "csrc", "detect.cu")
ARUCO = "DICT_4X4_1000"
TIMEOUT_S = 120

SHIM = r"""
// cuda_runtime.h for a host build of a CUDA source's kernels: a block's
// threads are fibers (ucontext) on one OS thread, switched round robin
// whenever one waits at a barrier, so the build's speed does not hang on
// how the host schedules dozens of threads that meet at every warp step
#pragma once
#include <cstdint>
#include <cstring>
#include <functional>
#include <math.h>
#include <memory>
#include <ucontext.h>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __shared__
#define __launch_bounds__(...)

struct HostDim3 { unsigned x = 0, y = 0, z = 0; };
inline HostDim3 threadIdx, blockIdx;  // the running fiber's

// A block in flight.  A warp's lanes take every warp-wide step in one
// order, so each counts its waits alike; an exchange uses the slots of its
// wait's parity, written again two waits later, after every lane has
// passed the wait in between: one wait an exchange.
struct HostFiber {
  ucontext_t ctx;
  unsigned waits = 0;
  bool done = false;
};
struct HostBlock {
  std::vector<HostFiber> fibers;
  std::vector<unsigned> warp_arrived, warp_gen;
  std::vector<uint64_t> slots;  // [warp][parity][lane]
  unsigned block_arrived = 0, block_gen = 0;
  ucontext_t main;
};
inline HostBlock* host_block = nullptr;
inline std::function<void()>* host_body = nullptr;

// run the next fiber that has not returned; back here when it waits
inline void host_yield() {
  HostBlock& b = *host_block;
  const unsigned me = threadIdx.x, n = b.fibers.size();
  unsigned next = me;
  do next = (next + 1) % n; while (b.fibers[next].done && next != me);
  if (next == me) return;
  threadIdx.x = next;
  swapcontext(&b.fibers[me].ctx, &b.fibers[next].ctx);
  threadIdx.x = me;
}

inline void __syncwarp(unsigned = 0xffffffffu) {
  HostBlock& b = *host_block;
  const unsigned w = threadIdx.x / 32, gen = b.warp_gen[w];
  if (++b.warp_arrived[w] == 32) {
    b.warp_arrived[w] = 0;
    ++b.warp_gen[w];
  } else {
    while (b.warp_gen[w] == gen) host_yield();
  }
  ++b.fibers[threadIdx.x].waits;
}

inline void __syncthreads() {
  HostBlock& b = *host_block;
  const unsigned gen = b.block_gen;
  if (++b.block_arrived == b.fibers.size()) {
    b.block_arrived = 0;
    ++b.block_gen;
  } else {
    while (b.block_gen == gen) host_yield();
  }
}

// every lane's v, through the warp's slots
template <class T> inline void host_gather(T v, T all[32]) {
  static_assert(sizeof(T) <= sizeof(uint64_t), "a slot holds 8 bytes");
  HostBlock& b = *host_block;
  const unsigned t = threadIdx.x;
  uint64_t* slot = &b.slots[((t / 32) * 2 + (b.fibers[t].waits & 1)) * 32];
  uint64_t bits = 0;
  std::memcpy(&bits, &v, sizeof(T));
  slot[t & 31] = bits;
  __syncwarp();
  for (int l = 0; l < 32; ++l) std::memcpy(&all[l], &slot[l], sizeof(T));
}
template <class T> inline T __shfl_sync(unsigned, T v, int src) {
  T all[32];
  host_gather(v, all);
  return all[src & 31];
}
template <class T> inline T __shfl_xor_sync(unsigned, T v, int mask) {
  T all[32];
  host_gather(v, all);
  return all[(threadIdx.x & 31) ^ mask];
}
template <class T> inline T __shfl_up_sync(unsigned, T v, unsigned delta) {
  T all[32];
  host_gather(v, all);
  const int lane = threadIdx.x & 31;
  return lane >= (int)delta ? all[lane - delta] : v;
}
inline unsigned __ballot_sync(unsigned, int pred) {
  int all[32];
  host_gather(pred ? 1 : 0, all);
  unsigned m = 0;
  for (int l = 0; l < 32; ++l) m |= all[l] ? 1u << l : 0u;
  return m;
}
inline int __any_sync(unsigned mask, int pred) { return __ballot_sync(mask, pred) != 0; }
inline int __popc(unsigned x) { return __builtin_popcount(x); }
inline int __popcll(unsigned long long x) { return __builtin_popcountll(x); }
inline int __ffs(int x) { return __builtin_ffs(x); }

// a fiber: the kernel's body, then the next fiber still running, or the
// grid's loop once all have returned
inline void host_fiber() {
  (*host_body)();
  HostBlock& b = *host_block;
  b.fibers[threadIdx.x].done = true;
  const unsigned n = b.fibers.size();
  for (unsigned k = 1; k < n; ++k) {
    const unsigned next = (threadIdx.x + k) % n;
    if (!b.fibers[next].done) {
      threadIdx.x = next;
      setcontext(&b.fibers[next].ctx);
    }
  }
  setcontext(&b.main);
}

// body as a grid of `blocks` blocks of `threads` threads, a block at a
// time, each thread a fiber with a stack of its own
template <class F> inline void host_grid(unsigned blocks, unsigned threads, F body) {
  constexpr size_t STACK = 256 * 1024;
  std::unique_ptr<char[]> stacks(new char[STACK * threads]);
  std::function<void()> fn = body;
  host_body = &fn;
  for (unsigned blk = 0; blk < blocks; ++blk) {
    HostBlock b;
    b.fibers.resize(threads);
    b.warp_arrived.assign(threads / 32, 0);
    b.warp_gen.assign(threads / 32, 0);
    b.slots.assign(threads / 32 * 2 * 32, 0);
    for (unsigned t = 0; t < threads; ++t) {
      ucontext_t& c = b.fibers[t].ctx;
      getcontext(&c);
      c.uc_stack.ss_sp = stacks.get() + STACK * t;
      c.uc_stack.ss_size = STACK;
      c.uc_link = nullptr;
      makecontext(&c, host_fiber, 0);
    }
    host_block = &b;
    blockIdx.x = blk;
    threadIdx.x = 0;
    swapcontext(&b.main, &b.fibers[0].ctx);
  }
}
"""

RUNNER = r"""
}  // namespace

double detect_smem[1 << 21];  // a block's dynamic shared memory, 16 MB

// detect_candidates_f64 without its stream: 0, or 1 where the source's plan
// refuses the sizes, 2 where a block's shared memory passes detect_smem.
extern "C" int host_detect(
    const unsigned char* gray, const float* quads, const unsigned char* valid, const float* areas,
    const long long* codes, const double* tab, double* slot_corners, long long* slot_ids,
    unsigned char* slot_ok, double* corners, long long* ids, unsigned char* keep, float* score,
    int B, int H, int W, int Q, int D, int refine, int S, int O, int win, int iters, int n_bits,
    int Sd, int max_border_errs, int ec_bits, int ncodes, double subpix_acc, double clamp_px,
    double min_cell_contrast, float dedup_rate) {
  Plan l;
  if (!plan_launches(B, H, W, Q, D, refine, S, O, win, iters, n_bits, Sd, max_border_errs,
                     ec_bits, ncodes, subpix_acc, clamp_px, min_cell_contrast, &l))
    return 1;
  if (l.slot_smem > sizeof(detect_smem) || l.frame_smem > sizeof(detect_smem)) return 2;
  host_grid(l.slot_blocks, SLOT_WARPS * 32, [&] {
    detect_slots_kernel(gray, quads, valid, codes, tab, slot_corners, slot_ids, slot_ok, l.p);
  });
  host_grid(B, FRAME_THREADS, [&] {
    dedup_kernel(valid, areas, slot_corners, slot_ids, slot_ok, corners, ids, keep, score, Q, D,
                 dedup_rate);
  });
  return 0;
}
"""

# The child: load the inputs, run host_detect, save the Detections.
CHILD = r"""
import ctypes, json, sys
import numpy as np
lib = ctypes.CDLL(sys.argv[1])
x = np.load(sys.argv[2])
scalars = json.loads(sys.argv[3])
B, Q, D = scalars[0], scalars[3], scalars[4]
out = {"corners": np.zeros((B, D, 4, 2)), "ids": np.zeros((B, D), np.int64),
       "valid": np.zeros((B, D), np.bool_), "score": np.zeros((B, D), np.float32)}
scratch = [np.zeros((B * Q, 4, 2)), np.zeros(B * Q, np.int64), np.zeros(B * Q, np.bool_)]
ptrs = [x[k] for k in ("gray", "quads", "valid", "areas", "codes", "tab")] + scratch + [
    out[k] for k in ("corners", "ids", "valid", "score")]
lib.host_detect.argtypes = ([ctypes.c_void_p] * 13 + [ctypes.c_int] * 15
                            + [ctypes.c_double] * 3 + [ctypes.c_float])
rc = lib.host_detect(*[a.ctypes.data for a in ptrs], *scalars)
if rc:
    sys.exit(f"host_detect: {rc}")
np.savez(sys.argv[4], **out)
"""


def _host_toolchain() -> bool:
    """g++ with C++20 and <ucontext.h>."""
    if shutil.which("g++") is None:
        return False
    probe = subprocess.run(["g++", "-std=c++20", "-fsyntax-only", "-x", "c++", "-"],
                           input="#include <ucontext.h>\n", capture_output=True, text=True,
                           timeout=TIMEOUT_S)
    return probe.returncode == 0


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    """detect.cu's kernels, the shim and the runner as one shared library."""
    if not _host_toolchain():
        pytest.skip("no g++ with C++20 and <ucontext.h>")
    d = tmp_path_factory.mktemp("detect_host")
    (d / "cuda_runtime.h").write_text(SHIM)
    src = open(SOURCE).read()
    cut = src.index("}  // namespace")
    (d / "detect_host.cpp").write_text(src[:cut] + RUNNER)
    lib = d / "libdetect_host.so"
    proc = subprocess.run(
        ["g++", "-std=c++20", "-O2", "-ffp-contract=off", "-shared", "-fPIC",
         "-I", str(d), "-o", str(lib), str(d / "detect_host.cpp")],
        capture_output=True, text=True, timeout=TIMEOUT_S)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return str(lib)


@pytest.fixture(scope="module")
def batch():
    """Three 640x360 views of the 24-marker cube (the port's renderer on
    the CPU) and their candidates as the feed hands them to the drain: the
    threshold's masks, the C labeler's gated quads, the dictionary's
    codes."""
    K = np.array([[420.0, 0, 320], [0, 420.0, 180], [0, 0, 1]])
    cams = {str(i): Camera(id=str(i), intrinsics=K, distortion=np.zeros(12),
                           extrinsics=render.look_at(pos, (0, 0, 1.0)),
                           resolution_x=640, resolution_y=360)
            for i, pos in enumerate([(2.4, 0, 1.2), (0, 2.4, 1.4), (-2.4, 0.5, 1.0)])}
    frames = render.render_frames(cams, render.cube_trajectory(1, seed=7),
                                  render.make_cube_markers(), marker_size=0.138,
                                  device="cpu")[0]
    params = TD.resolve_error_correction(TD.DetectorParams(), ARUCO)
    packed = multi_threshold(frames, params.win_sizes, params.thresh_const).numpy()
    quads, valid, areas = perception.quads_from_packed_masks(packed, 360, 640, params)
    codes = TD.dictionary_codes(marker_bits_table(ARUCO))
    return frames, quads, valid, areas, codes, params


def _run_host(lib, tmp_path, frames, quads, valid, areas, codes, params) -> TD.Detections:
    """The host build's Detections, from a child process under TIMEOUT_S."""
    B, H, W = frames.shape
    scalars = TD.detect_scalars(params, 4, B, H, W, valid.shape[1], codes.numel())
    inputs, outputs = tmp_path / "inputs.npz", tmp_path / "outputs.npz"
    np.savez(inputs, gray=frames.numpy(), quads=quads, valid=valid, areas=areas,
             codes=codes.numpy(), tab=TD.detect_tables(params, "cpu").numpy())
    proc = subprocess.run([sys.executable, "-c", CHILD, lib, str(inputs), json.dumps(scalars),
                           str(outputs)], capture_output=True, text=True, timeout=TIMEOUT_S)
    assert proc.returncode == 0, proc.stderr[-4000:]
    out = np.load(outputs)
    return TD.Detections(*(torch.from_numpy(out[k]) for k in TD.Detections._fields))


@pytest.mark.parametrize("case", ["apriltag", "subpix", "none", "no_valid_slot"])
def test_detect_kernels_on_the_host_match_plain(host_lib, batch, tmp_path, case, two_threads):
    """The kernels' host build against ``detect_candidates_plain`` on three
    rendered frames at each refine kind, and on a batch with no valid slot
    (every output slot empty); the plain version's torch ops on two
    threads, as the pure mode's tests run theirs beside the other workers."""
    frames, quads, valid, areas, codes, params = batch
    if case == "no_valid_slot":
        valid = np.zeros_like(valid)
    else:
        params = params._replace(corner_refine=case)
    out = _run_host(host_lib, tmp_path, frames, quads, valid, areas, codes, params)
    ref = TD.detect_candidates_plain(frames, torch.from_numpy(quads), torch.from_numpy(valid),
                                     torch.from_numpy(areas), codes, 4, params)
    gaps = detect_gaps(out, ref)
    assert detect_ok(gaps), gaps
    if case == "no_valid_slot":
        assert gaps["kept"] == 0 and not out.ids.any() and not out.corners.any()
    else:
        assert gaps["kept"] >= 20, gaps
