"""Host C components of the port, built at first use.

- ``get_fastpack()``: the edge-dict packer (``fastpack.c``);
- ``get_fastccl()``: run-based union-find connected components and quad
  candidates over bit-packed mask rows (``fastccl.c``), perception's host
  labeler, with the candidates' gates and degenerate re-fit
  (``quad_gates.h``, which it includes);
- ``get_fastthresh()``: the multi-window adaptive threshold on the host,
  bit-packed out (``fastthresh.c``), for the ``host`` and ``roi``
  perception modes.

Each is a CPython extension module copied from the JAX package's
``_native``.  A source compiles with the host ``gcc`` (``$CC``) against
this interpreter's and numpy's headers into ``_build/`` (git ignores it),
named by a hash of the source, the headers here and the flags.  When the build fails, or under
``VICAN_TPU_NO_NATIVE=1``, the getter returns None and the caller takes its
numpy/scipy/Python path, whose output is identical; :data:`build_errors`
keeps the compiler's message.  A lock makes the first call of each getter
build and load its module once, whichever threads call it.  The labeler
with its gates and the host threshold release the GIL while they run,
unlike the JAX package's copies.
"""
from __future__ import annotations

import glob
import hashlib
import importlib.util
import os
import subprocess
import sys
import sysconfig
import threading

_HERE = os.path.dirname(os.path.abspath(__file__))
_cache: dict = {}
_lock = threading.Lock()
# the compiler's output of each build that failed in this process
build_errors: dict[str, str] = {}


def _build(name: str, here: str = _HERE) -> str | None:
    """Compile ``<name>.c`` of the directory ``here`` (this one by default)
    into a content-hash-named .so under its ``_build/``; return its path,
    or None when the compiler fails."""
    import numpy as np

    src = os.path.join(here, f"{name}.c")
    # -march=native: the .so is built on the host that runs it; -pthread:
    # fastccl.c spreads a batch over threads; the flags and every header
    # here (fastccl.c includes quad_gates.h) are part of the name
    flags = ["-O3", "-march=native", "-pthread"]
    digest = hashlib.sha256(" ".join(flags).encode())
    for path in [src, *sorted(glob.glob(os.path.join(here, "*.h")))]:
        with open(path, "rb") as f:
            digest.update(f.read())
    tag = digest.hexdigest()[:12]
    tag += f"_py{sys.version_info.major}{sys.version_info.minor}"
    cache_dir = os.path.join(here, "_build")
    os.makedirs(cache_dir, exist_ok=True)
    so_path = os.path.join(cache_dir, f"{name}_{tag}.so")
    if os.path.exists(so_path):
        return so_path
    tmp = f"{so_path}.{os.getpid()}.tmp"
    cmd = [os.environ.get("CC", "gcc"), *flags, "-shared", "-fPIC",
           f"-I{sysconfig.get_paths()['include']}", f"-I{np.get_include()}",
           src, "-o", tmp]
    try:
        subprocess.run(cmd, check=True, capture_output=True, text=True, timeout=120)
    except (OSError, subprocess.SubprocessError) as e:
        build_errors[name] = getattr(e, "stderr", None) or repr(e)
        return None
    os.replace(tmp, so_path)
    return so_path


def _get_module(name: str):
    if name in _cache:
        return _cache[name]
    # perception's feed thread may make the first call while another
    # thread makes its own: one builds and loads, the other waits for it
    with _lock:
        if name in _cache:
            return _cache[name]
        mod = None
        if not os.environ.get("VICAN_TPU_NO_NATIVE"):
            so_path = _build(name)
            if so_path is not None:
                spec = importlib.util.spec_from_file_location(f"vican_torch._native.{name}",
                                                              so_path)
                mod = importlib.util.module_from_spec(spec)
                spec.loader.exec_module(mod)
        _cache[name] = mod
        return mod


def get_fastpack():
    """The compiled edge-packing module, or None when it is unavailable."""
    return _get_module("fastpack")


def get_fastccl():
    """The compiled labeling / quad-candidate module, or None when it is
    unavailable."""
    return _get_module("fastccl")


def get_fastthresh():
    """The compiled host threshold module, or None when it is unavailable."""
    return _get_module("fastthresh")
