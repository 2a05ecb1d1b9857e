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

_P, _I = ctypes.c_void_p, ctypes.c_int
# source -> {C function: argtypes}; the CUDA stream is appended to each call
SOURCES = {
    "pwr": {"pwr_apply_bf16": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P]},
}

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
    src = os.path.join(CSRC, f"{name}.cu")
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return src, os.path.join(BUILD, f"{name}_{digest}.so")


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
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
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

    Tensors pass as device pointers, ints as C ints; the tensors' device is
    the launch device.  Raises if the launch reports a CUDA error.
    """
    lib = _load(name)
    dev = next(a.device for a in args if isinstance(a, torch.Tensor))
    cargs = [ctypes.c_void_p(a.data_ptr()) if isinstance(a, torch.Tensor) else int(a)
             for a in args]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = getattr(lib, fn)(*cargs, ctypes.c_void_p(stream))
    if rc != 0:
        msg = getattr(lib, f"{name}_error_string")(rc).decode()
        raise RuntimeError(f"{fn}: CUDA error {rc} ({msg})")
