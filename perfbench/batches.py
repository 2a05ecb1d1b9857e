"""Batch intervals of a rig's captures, by frame size.

A perception call's batches leave the drain one after another: batch i's
"dict" phase ends the batch.  The interval between two consecutive
batches' ends is the time the pipeline took for the later one, whichever
stage held it.  Each batch's frame size is the ``height`` and ``width``
counters of its "upload" event; a program without them, or a run whose
events carry no ``capture`` tag (``perfbench/drivers/perceive_rig.py`` sets it),
reads nothing.
"""
from __future__ import annotations

import statistics


def interval_ms(run: dict, pick) -> float | None:
    """The median interval (ms) over the batches whose frames have
    ``pick`` (min or max) of the run's pixels a frame; a capture's first
    batch has none.  None where nothing can be read."""
    ends, pixels = {}, {}
    for e in run.get("phases", []):
        key = (e.get("capture"), e.get("batch"))
        if key[0] is None or key[1] is None:
            continue
        if e["name"] == "dict" and e.get("stage") == "drain":
            ends[key] = e["start"] + e["seconds"]
        elif e["name"] == "upload" and e.get("stage") == "feed" and "height" in e:
            pixels[key] = e["height"] * e["width"]
    if not pixels:
        return None
    size = pick(pixels.values())
    gaps = [end - ends[(c, b - 1)] for (c, b), end in ends.items()
            if pixels.get((c, b)) == size and (c, b - 1) in ends]
    return 1e3 * statistics.median(gaps) if gaps else None
