"""drain.detect_ms: milliseconds a batch of perception's "detect program" phase (its
``PhaseTimer`` events, stage "drain"), averaged over every batch of the
window's captures."""
from perfbench import trace


def read(run):
    s = trace.phase_mean(run, "detect program", "drain")
    return None if s is None else 1e3 * s
