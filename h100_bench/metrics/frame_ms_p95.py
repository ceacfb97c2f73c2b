"""The 95th percentile (nearest rank) of the window's frame times, each
from request to sync on the host clock, in ms."""
import math


def read(run):
    if run.unit != "frame" or not run.durations or run.trace is not None:
        return None
    d = sorted(run.durations)
    return d[max(math.ceil(0.95 * len(d)) - 1, 0)] * 1e3
