"""device_idle.solve: the share (%) of a traced solve in which no
operation ran on the card."""
from perfbench import trace


def read(run):
    return trace.idle_percent(run)
