"""batch.small_frames_ms: the median milliseconds between consecutive
batches' ends (their "dict" phases), over the batches of the frame size
with the fewest pixels (by their "upload" counters), over the window's
captures: the rate at which the rig's small frames go through."""
from perfbench import batches


def read(run):
    return batches.interval_ms(run, min)
