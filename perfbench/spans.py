"""Fields of the program's ``PhaseTimer`` events, read into what the metrics use.

A perception run records every event of the window's captures (the
driver's ``phases``): ``name``, ``stage``, ``seconds``, and, where the
program records them, ``device_seconds`` and the counters a span sets (the
labeler's and the gates' thread-seconds of "host candidates").  A program
that lacks a span or a counter leaves the field out, and the metric that
reads it is then left out of the line.
"""
from __future__ import annotations


def mean_ms(run: dict, name: str, stage: str, field: str = "seconds") -> float | None:
    """The mean of ``field`` (seconds) over the events named ``name`` of
    ``stage`` (a batch each), in milliseconds: None where no such event
    carries it, or it is None (a device time on the CPU)."""
    values = [e[field] for e in run.get("phases", [])
              if e["name"] == name and e.get("stage") == stage and e.get(field) is not None]
    return 1e3 * sum(values) / len(values) if values else None
