"""drain.pnp_device_ms: milliseconds a batch of the drain's stream between the
two timing events of the "PnP" span (its ``device_seconds``), averaged over
every batch of the window's captures."""
from perfbench import spans


def read(run):
    return spans.mean_ms(run, "PnP", "drain", "device_seconds")
