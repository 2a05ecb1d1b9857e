"""drain.detect_device_ms: milliseconds a batch of the drain's stream between the
two timing events of the "detect program" span (its ``device_seconds``):
the detect kernels, the gaps between their launches and the queueing behind
the feed's work on the card, averaged over every batch of the window's
captures."""
from perfbench import spans


def read(run):
    return spans.mean_ms(run, "detect program", "drain", "device_seconds")
