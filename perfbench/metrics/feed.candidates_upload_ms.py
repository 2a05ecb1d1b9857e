"""feed.candidates_upload_ms: milliseconds a batch of the gated candidates'
move to the card: the span "candidates upload", stage "feed", nested in
"host candidates", averaged over every batch of the window's captures."""
from perfbench import spans


def read(run):
    return spans.mean_ms(run, "candidates upload", "feed")
