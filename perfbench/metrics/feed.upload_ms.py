"""feed.upload_ms: milliseconds a batch of perception's "upload" phase (its
``PhaseTimer`` events, stage "feed"), averaged over every batch of the
window's captures."""
from perfbench import trace


def read(run):
    s = trace.phase_mean(run, "upload", "feed")
    return None if s is None else 1e3 * s
