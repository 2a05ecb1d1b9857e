"""detect.kernel_ms: the detect kernels' traced device time a batch (ms),
``detect_slots_kernel`` and ``dedup_kernel`` together.  Read only where the
trace counts as many launches of each as the wrapper's counter."""
from perfbench import trace


def read(run):
    t = trace.kernel_time(run, ["detect_slots_kernel", "dedup_kernel"], "detect_candidates")
    return None if t is None else 1e3 * t
