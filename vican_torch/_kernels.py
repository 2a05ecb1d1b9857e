"""Build and bind the port's CUDA kernels: nvcc + a plain C interface + ctypes.

Each source under ``csrc/`` is compiled at first use into ``_build/`` (a
directory git ignores) as a shared library for ``sm_90a``, named by a hash
of the source and flags, so an edit rebuilds and a clean checkout builds
from its own sources.  :func:`build` starts one ``nvcc`` per source, all at
once.  Each C entry point launches on the caller's stream and returns
``cudaGetLastError()``; :func:`launch` raises when that is not 0.

Nothing here runs at import: the CPU tests import every module, and
``nvcc`` is needed only where a kernel is launched.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

import torch

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG, "csrc")
BUILD = os.path.join(_PKG, "_build")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P, _I, _F, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_double
# source -> {C function: argtypes}; the CUDA stream is appended to each call
SOURCES = {
    "pwr": {"pwr_apply_bf16": [*[_P] * 8, *[_I] * 10, _P],
            "pwr_single_bf16": [*[_P] * 5, *[_I] * 7, _P],
            "pwr_single_clusters": [_I, _I, _I], "pwr_mma_occupancy": [_I, _I]},
    "threshold": {"threshold_pack_u8": [_P, _P, *[_I] * 14, _F, *[_I] * 3, _P],
                  "threshold_constant": [_I], "threshold_attribute": [_I, _I]},
    "mv": {"thin_mv_bf16": [*[_P] * 5, *[_I] * 9, _P], "thin_mv_occupancy": [_I]},
    # corners, ids, valid, Ks, dists, out; slots, D, lm_iters, method; marker_size
    "pnp": {"pnp_block_f64": [*[_P] * 6, *[_I] * 4, _D, _P]},
    # gray, the candidates, codes, tables, slot scratch, Detections; 16 sizes
    # and counts; subpix_acc, refine_clamp_px, min_cell_contrast; the
    # float32 dedup_radius_rate
    "detect": {"detect_candidates_f64": [*[_P] * 13, *[_I] * 15, _D, _D, _D, _F, _P]},
}
# flags of one source beside NVCC_FLAGS: detect.cu rounds every product
# as the plain version's separate torch ops do, so nothing is fused
SOURCE_FLAGS = {"detect": ("--fmad=false",)}

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()
# ptxas report and seconds of each build this process made
build_logs: dict[str, dict] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _paths(name: str) -> tuple[str, str]:
    """The source and its library, named by a hash of the source, every
    header under ``csrc/`` (an edit to a shared header rebuilds its
    includers) and the flags."""
    src = os.path.join(CSRC, f"{name}.cu")
    h = hashlib.sha256()
    for path in [src, *sorted(os.path.join(CSRC, f) for f in os.listdir(CSRC)
                              if f.endswith(".cuh"))]:
        with open(path, "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS + SOURCE_FLAGS.get(name, ())).encode())
    return src, os.path.join(BUILD, f"{name}_{h.hexdigest()[:12]}.so")


def build(names=None) -> dict[str, dict]:
    """Compile the named sources (all by default) that are not built yet,
    one ``nvcc`` each, all started together.  Returns :data:`build_logs`."""
    names = list(SOURCES) if names is None else list(names)
    os.makedirs(BUILD, exist_ok=True)
    running = {}
    for name in names:
        src, out = _paths(name)
        if os.path.exists(out):
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        proc = subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, *SOURCE_FLAGS.get(name, ()), "-o", tmp, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        running[name] = (proc, tmp, out, time.perf_counter())
    failed = []
    for name, (proc, tmp, out, t0) in running.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}.cu:\n{log}")
            continue
        os.replace(tmp, out)
        build_logs[name] = {"seconds": time.perf_counter() - t0, "ptxas": log}
    if failed:
        raise RuntimeError("\n".join(failed))
    return build_logs


def _load(name: str) -> ctypes.CDLL:
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(_paths(name)[1])
            for fn, argtypes in SOURCES[name].items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            err = getattr(lib, f"{name}_error_string")
            err.argtypes = [ctypes.c_int]
            err.restype = ctypes.c_char_p
            _libs[name] = lib
        return lib


def launch(name: str, fn: str, *args) -> None:
    """Call C function ``fn`` of source ``name`` on the current CUDA stream.

    Tensors pass as device pointers, floats as the C float or C double that
    the function's argtypes in :data:`SOURCES` name (ctypes converts them:
    a ``c_float`` would round ``marker_size`` = 0.138 by ~1e-9 relative,
    so pnp.cu's is a ``c_double``), other scalars as C ints; the tensors'
    device is the launch device.  Raises if the launch reports a CUDA
    error.
    """
    lib = _load(name)
    dev = next(a.device for a in args if isinstance(a, torch.Tensor))
    cargs = [ctypes.c_void_p(a.data_ptr()) if isinstance(a, torch.Tensor)
             else a if isinstance(a, float) else int(a) for a in args]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = getattr(lib, fn)(*cargs, ctypes.c_void_p(stream))
    if rc != 0:
        msg = getattr(lib, f"{name}_error_string")(rc).decode()
        raise RuntimeError(f"{fn}: CUDA error {rc} ({msg})")


def call(name: str, fn: str, *args: int) -> int:
    """Call host function ``fn`` of source ``name`` with C ints (no stream)
    and return its int result."""
    return getattr(_load(name), fn)(*(int(a) for a in args))


_sms: dict[int, int] = {}


def sm_count(dev) -> int:
    """Streaming multiprocessors of CUDA device ``dev`` (asked once)."""
    idx = torch.device(dev).index
    idx = torch.cuda.current_device() if idx is None else idx
    if idx not in _sms:
        _sms[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _sms[idx]
