"""Structured phase timing.

The reference prints ad-hoc ``time.time()`` deltas around each solver phase
(vican/bipgo.py:201-223, 242-277, 444-481).  :class:`PhaseTimer` keeps the
same printed phase names, records them as structured events, and on a CUDA
device synchronizes at the end of every phase, so a phase's time covers the
device work it queued and not only the host's enqueue.
"""
from __future__ import annotations

import os
import time
from contextlib import contextmanager
from typing import Any

import torch


class PhaseTimer:
    """Collects named phase durations; optionally prints like the reference.

    ``device``: the device the phases run on; a CUDA device is synchronized
    as each phase ends.  ``trace=True`` (or env ``VICAN_TPU_TRACE``) wraps
    every phase in ``torch.profiler.record_function`` so it shows up as a
    named range in a captured profiler trace.
    """

    def __init__(self, verbose: bool = True, trace: bool = False, device=None):
        self.verbose = verbose
        self.trace = trace or bool(os.environ.get("VICAN_TPU_TRACE"))
        self.device = torch.device(device) if device is not None else None
        self.events: list[dict[str, Any]] = []

    @contextmanager
    def phase(self, name: str):
        """Time a phase; the yielded dict collects extra fields of the event."""
        if self.verbose:
            print(name, end=" ", flush=True)
        ann = torch.profiler.record_function(name) if self.trace else None
        if ann is not None:
            ann.__enter__()
        start = time.perf_counter()
        out: dict[str, Any] = {"name": name}
        try:
            yield out
        finally:
            if self.device is not None and self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            dur = time.perf_counter() - start
            out["seconds"] = dur
            self.events.append(out)
            if ann is not None:
                ann.__exit__(None, None, None)
            if self.verbose:
                print("({:.3f}s).".format(dur))

    def log(self, msg: str):
        if self.verbose:
            print(msg)
