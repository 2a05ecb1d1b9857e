"""feed.labeler_ms: thread-milliseconds a batch in the C labeler (``qc_core``
of ``_native/fastccl.c``, or the scipy labeler without it): the counter
``labeler_s`` of the "host candidates" span, summed over the threads of its
one call, averaged over every batch of the window's captures."""
from perfbench import spans


def read(run):
    return spans.mean_ms(run, "host candidates", "feed", "labeler_s")
