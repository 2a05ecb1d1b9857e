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

    Each event is a dict with these fields:

    - ``name``; ``stage``, the keyword ``stage`` given to :meth:`phase`
      (``"feed"`` or ``"drain"`` in perception, else None);
    - ``start`` (``time.perf_counter()`` at the phase's start) and
      ``seconds``;
    - ``parent``: the name of the phase open around it on the same thread,
      or None.  Phases nest per thread (perception's feed and drain open
      theirs at once), so a phase's self time is its ``seconds`` less its
      children's;
    - ``batch``: the index that :meth:`in_batch` set on the thread the
      phase ran on (perception's batch within the call), else None;
    - ``device_seconds``: in a phase opened with ``device_time=True`` on a
      CUDA device, the time between two timing events recorded on the
      phase's stream at its start and at its end, read after the phase's
      own synchronization; else None;
    - any counter the body sets in the yielded dict (as ``out["sync"]``).

    Timing events are opt-in: recorded on every synchronizing phase of a
    720p capture, they cost ~4% of its wall on an H100 host, where the
    synchronizations alone cost nothing measurable.
    ``phase(..., host_only=True)`` opens a host-only phase, for work that
    queues nothing on the device: it records no events and synchronizes
    nothing, so a phase on a thread outside a stream's
    context does not wait for another thread's kernels.  Every event is
    whole once its phase has ended.  Phases may run on several threads at
    once; each prints its line whole when it ends.
    """

    def __init__(self, verbose: bool = True, trace: bool = False, device=None):
        self.verbose = verbose
        self.trace = trace or bool(os.environ.get("VICAN_TPU_TRACE"))
        self.device = torch.device(device) if device is not None else None
        self.events: list[dict[str, Any]] = []
        self._print_lock = threading.Lock()
        # per thread: the names of its open phases, its batch index and its
        # spare timing events, by CUDA device
        self._local = threading.local()

    def _thread(self) -> threading.local:
        local = self._local
        if not hasattr(local, "open"):
            local.open, local.batch, local.spare = [], None, {}
        return local

    @contextmanager
    def in_batch(self, index: int | None):
        """Phases opened on the calling thread inside carry ``batch=index``."""
        local = self._thread()
        saved, local.batch = local.batch, index
        try:
            yield
        finally:
            local.batch = saved

    @contextmanager
    def phase(self, name: str, sync: Any = None, *, stage: str | None = None,
              host_only: bool = False, device_time: bool = False):
        """Time a phase; the yielded dict collects extra fields of the event.

        ``sync`` (a tensor, or a nested list, tuple or dict of them) and
        ``out["sync"]``, where the body sets it, name the devices to wait
        for before the phase's time is read: the calling thread's current
        stream on each CUDA tensor's device is synchronized.  Work queued
        on another stream is not waited for.  ``host_only``: a phase that
        waits for no device, ``device_time``: one that records
        ``device_seconds`` (class docstring); a host-only phase takes
        neither ``sync`` nor ``device_time``.
        """
        if host_only and (sync is not None or device_time):
            raise ValueError("a host-only phase synchronizes nothing")
        local = self._thread()
        ann = torch.profiler.record_function(name) if self.trace else None
        if ann is not None:
            ann.__enter__()
        cuda = not host_only and self.device is not None and self.device.type == "cuda"
        marks = None
        start = time.perf_counter()
        if cuda and device_time:
            stream = torch.cuda.current_stream(self.device)
            spare = local.spare.setdefault(stream.device_index, [])
            marks = [spare.pop() if spare else torch.cuda.Event(enable_timing=True)
                     for _ in range(2)]
            # after ``start`` and before the synchronization, so that
            # device_seconds <= seconds
            marks[0].record(stream)
        out: dict[str, Any] = {"name": name, "stage": stage, "start": start,
                               "parent": local.open[-1] if local.open else None,
                               "batch": local.batch, "device_seconds": None}
        local.open.append(name)
        try:
            yield out
        finally:
            local.open.pop()
            if not host_only:
                _block(sync)
                _block(out.get("sync"))
            if cuda:
                stream = torch.cuda.current_stream(self.device)
                if marks is not None:
                    marks[1].record(stream)
                stream.synchronize()
            dur = time.perf_counter() - start
            out["seconds"] = dur
            if marks is not None:
                out["device_seconds"] = 1e-3 * marks[0].elapsed_time(marks[1])
                local.spare[stream.device_index].extend(marks)
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
