"""Structured phase timing.

The reference prints ad-hoc ``time.time()`` deltas around each solver phase
(vican/bipgo.py:201-223, 242-277, 444-481).  :class:`PhaseTimer` keeps the
same printed phase names, records them as structured events, and on a CUDA
device synchronizes the calling thread's current stream at the end of every
phase, so a phase's time covers the device work it queued and not only the
host's enqueue.  ``sync`` takes the place of the JAX package's
``block_until_ready`` on given arrays (vican_tpu/utils/timing.py:32-50): it
synchronizes the calling thread's current stream on each device that holds
one of the given tensors, so it waits for a tensor written on that stream
and not for one written on another.
"""
from __future__ import annotations

import os
import threading
import time
from contextlib import contextmanager
from typing import Any

import torch


class PhaseTimer:
    """Collects named phase durations; optionally prints like the reference.

    ``device``: the device the phases run on; on a CUDA device each phase
    ends by synchronizing the calling thread's current stream.  Only that
    stream: perception's feed and drain run their phases at once on two
    threads and two streams, and a whole-device synchronize would make
    each wait for the other's kernels.  The solver runs on one stream, for
    which the two are the same.  ``trace=True`` (or env
    ``VICAN_TPU_TRACE``) wraps every phase in
    ``torch.profiler.record_function`` so it shows up as a named range in a
    captured profiler trace.

    Each event is a dict with ``name``, ``stage`` (the keyword ``stage``
    given to :meth:`phase`: ``"feed"`` or ``"drain"`` in perception, else
    None),
    ``start`` (``time.perf_counter()`` at the phase's start) and
    ``seconds``.  Phases may run on several threads at once; each prints
    its line whole when it ends.
    """

    def __init__(self, verbose: bool = True, trace: bool = False, device=None):
        self.verbose = verbose
        self.trace = trace or bool(os.environ.get("VICAN_TPU_TRACE"))
        self.device = torch.device(device) if device is not None else None
        self.events: list[dict[str, Any]] = []
        self._print_lock = threading.Lock()

    @contextmanager
    def phase(self, name: str, sync: Any = None, *, stage: str | None = None):
        """Time a phase; the yielded dict collects extra fields of the event.

        ``sync`` (a tensor, or a nested list, tuple or dict of them) and
        ``out["sync"]``, where the body sets it, name the devices to wait
        for before the phase's time is read: the calling thread's current
        stream on each CUDA tensor's device is synchronized.  Work queued
        on another stream is not waited for.
        """
        ann = torch.profiler.record_function(name) if self.trace else None
        if ann is not None:
            ann.__enter__()
        start = time.perf_counter()
        out: dict[str, Any] = {"name": name, "stage": stage, "start": start}
        try:
            yield out
        finally:
            _block(sync)
            _block(out.get("sync"))
            if self.device is not None and self.device.type == "cuda":
                torch.cuda.current_stream(self.device).synchronize()
            dur = time.perf_counter() - start
            out["seconds"] = dur
            self.events.append(out)
            if ann is not None:
                ann.__exit__(None, None, None)
            if self.verbose:
                with self._print_lock:
                    print("{} ({:.3f}s).".format(name, dur), flush=True)

    def log(self, msg: str):
        if self.verbose:
            with self._print_lock:
                print(msg)

    def as_dict(self) -> dict[str, float]:
        return {e["name"]: e["seconds"] for e in self.events}


def _block(tree) -> None:
    """Synchronize the current stream of every CUDA device that holds a
    tensor of ``tree`` (a tensor, or nested lists, tuples and dicts)."""
    devices, todo = set(), [tree]
    while todo:
        x = todo.pop()
        if isinstance(x, torch.Tensor):
            if x.is_cuda:
                devices.add(x.device)
        elif isinstance(x, dict):
            todo.extend(x.values())
        elif isinstance(x, (list, tuple)):
            todo.extend(x)
    for dev in devices:
        torch.cuda.current_stream(dev).synchronize()
