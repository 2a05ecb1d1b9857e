"""feed.preprocess_ms: milliseconds a batch of the brightness, contrast and
gray preprocess on the feed thread (``perception.host_preprocess``): the
host-only span "preprocess", stage "feed", averaged over every batch of the
window's captures."""
from perfbench import spans


def read(run):
    return spans.mean_ms(run, "preprocess", "feed")
