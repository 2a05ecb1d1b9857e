"""feed.decode_ms: milliseconds a batch of the JPEG decode on the feed thread
(``perception.load_images``): the host-only span "decode", stage "feed", of
``estimate_pose_batched``'s loader, averaged over every batch of the window's
captures."""
from perfbench import spans


def read(run):
    return spans.mean_ms(run, "decode", "feed")
