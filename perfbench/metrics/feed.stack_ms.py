"""feed.stack_ms: milliseconds a batch that the feed thread takes to stack a
batch from a sequence of frames (``perception.estimate_pose_gray``'s
sequence form): the host-only span "stack", stage "feed", averaged over
every batch of the window's captures, of every frame size."""
from perfbench import spans


def read(run):
    return spans.mean_ms(run, "stack", "feed")
