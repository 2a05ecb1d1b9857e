"""threshold.roofline: the threshold kernel's share of its roofline (%):
the least time its work allows (perfbench.roofline.threshold_work at the
batch's shape: int32 operations over the derived int32 peak, bytes over
the bandwidth) over its traced device time a launch.  Read only where the
trace counts as many launches as the wrapper's counter."""
from perfbench import roofline, trace


def read(run):
    t = trace.kernel_time(run, ["threshold_band_kernel"], "multi_threshold")
    work = run.get("work", {}).get("threshold")
    if t is None or work is None:
        return None
    return 100.0 * roofline.bound_s(work) / t
