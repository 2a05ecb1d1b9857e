"""drain.wait_feed_ms: milliseconds a batch that the drain waits for the feed to
hand the batch over: the host-only span "wait for feed", stage "drain",
averaged over every batch of the window's captures.  Long where the feed sets
the rate."""
from perfbench import spans


def read(run):
    return spans.mean_ms(run, "wait for feed", "drain")
