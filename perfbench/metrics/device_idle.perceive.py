"""device_idle.perceive: the share (%) of a traced capture in which no
operation ran on the card."""
from perfbench import trace


def read(run):
    return trace.idle_percent(run)
