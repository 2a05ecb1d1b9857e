"""feed.host_candidates_ms: milliseconds a batch of perception's "host candidates" phase (its
``PhaseTimer`` events, stage "feed"), averaged over every batch of the
window's captures."""
from perfbench import trace


def read(run):
    s = trace.phase_mean(run, "host candidates", "feed")
    return None if s is None else 1e3 * s
