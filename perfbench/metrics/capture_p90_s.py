"""capture_p90_s: the 90th percentile of the wall time of every capture
call in the window (a capture in, its edge dict out)."""
import statistics


def read(run):
    seconds = [end - start for start, end, _ in run["calls"]]
    if len(seconds) < 2:
        return None
    return statistics.quantiles(seconds, n=10, method="inclusive")[8]
