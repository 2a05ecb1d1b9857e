"""One span of work under ``torch.profiler``, read into what the metrics use.

:func:`capture` runs a function between two synchronizations of the card
inside a named range and returns:

- ``window_s``: the range's length; ``busy_s``: the seconds in which some
  operation (kernel, copy, set) ran on the device within it;
- ``kernels``: ``{name: [count, device seconds]}`` of the device
  operations in the range;
- ``breakdown``: the device operations that took most time, and the idle
  gaps summed by the phases the host was in (up to 10 entries each).

Every thread's ranges are recorded where this torch can
(``profile_all_threads``); the device's activity is recorded whatever thread
launched it.
"""
from __future__ import annotations

import time

SPAN = "perfbench.traced"


def _extra() -> dict:
    try:
        from torch._C._profiler import _ExperimentalConfig

        return {"experimental_config": _ExperimentalConfig(profile_all_threads=True)}
    except (ImportError, TypeError):
        return {}


def capture(fn, phase_names=(), cuda: bool = True) -> dict:
    """Profile ``fn()`` on the card (with ``cuda=False``, the host alone:
    the tests on the CPU); see the module's docstring."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    sync = torch.cuda.synchronize if cuda else (lambda: None)
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    sync()
    with profile(activities=activities, **_extra()) as prof:
        with record_function(SPAN):
            fn()
            sync()
    t0 = time.perf_counter()
    out = summarize(prof.events(), phase_names)
    out["read_s"] = time.perf_counter() - t0
    return out


def _union(spans) -> list:
    out: list = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        elif e > s:
            out.append([s, e])
    return out


def summarize(events, phase_names=()) -> dict:
    """The module docstring's dict from a profiler's events (times in us)."""
    from torch.autograd import DeviceType

    host = [e for e in events if e.device_type == DeviceType.CPU]
    host_names = {e.name for e in host}
    span = next(e for e in host if e.name == SPAN)
    lo, hi = span.time_range.start, span.time_range.end
    # host ranges also appear on the device's timeline under their names
    device = [e for e in events if e.device_type == DeviceType.CUDA and e.name not in host_names]
    kernels: dict = {}
    spans = []
    for e in device:
        s, t = max(e.time_range.start, lo), min(e.time_range.end, hi)
        if t <= s:
            continue
        k = kernels.setdefault(e.name, [0, 0.0])
        k[0] += 1
        k[1] += (e.time_range.end - e.time_range.start) * 1e-6
        spans.append((s, t))
    busy = _union(spans)
    # the program's phases (PhaseTimer ranges) label the idle gaps
    phases = [(e.time_range.start, e.time_range.end, e.name) for e in host
              if e.name in phase_names]
    gaps: dict = {}
    prev = lo
    for s, t in busy + [[hi, hi]]:
        if s > prev:
            mid = 0.5 * (s + prev)
            label = "+".join(sorted({n for a, b, n in phases if a <= mid < b})) or "no phase"
            gaps[label] = gaps.get(label, 0.0) + (s - prev) * 1e-6
        prev = max(prev, t)
    top = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:10]
    return {
        "window_s": (hi - lo) * 1e-6,
        "busy_s": sum(t - s for s, t in busy) * 1e-6,
        "kernels": kernels,
        "breakdown": {
            "device_ops": [[n[:120], v[1]] for n, v in top],
            "idle_gaps": [[n, v] for n, v in sorted(gaps.items(), key=lambda kv: -kv[1])[:10]],
        },
    }


def kernel_time(run: dict, names, counter: str) -> float | None:
    """Device seconds a launch of a hand kernel whose trace names hold one
    of ``names``: read only where the trace counts as many of each name's
    kernels as the wrapper's ``counter`` counted over the traced span; else
    None (the trace missed launches, or saw others)."""
    trace, launches = run.get("trace"), run.get("launches", {}).get(counter)
    if not trace or not launches:
        return None
    total = 0.0
    for name in names:
        hits = [v for k, v in trace["kernels"].items() if name in k]
        if sum(v[0] for v in hits) != launches:
            return None
        total += sum(v[1] for v in hits)
    return total / launches


def phase_mean(run: dict, name: str, stage: str) -> float | None:
    """Seconds a batch of a perception phase: the mean of its ``PhaseTimer``
    events of ``stage`` over the window's captures; None where none ran."""
    seconds = [e["seconds"] for e in run.get("phases", [])
               if e["name"] == name and e.get("stage") == stage]
    return sum(seconds) / len(seconds) if seconds else None


def solver_phase_mean(run: dict, name: str) -> float | None:
    """Seconds a solve of a solver phase, as its verbose log prints it,
    averaged over the traced run's solves; None where none ran."""
    seconds = [p[name] for p in run.get("solver_phases", []) if name in p]
    return sum(seconds) / len(seconds) if seconds else None


def idle_percent(run: dict) -> float | None:
    trace = run.get("trace")
    if not trace or trace["window_s"] <= 0 or trace["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])
