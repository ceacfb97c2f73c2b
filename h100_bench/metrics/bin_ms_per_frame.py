"""Device time of the kernels launched inside the program's ``sj.bin``
span (tile spans, depth sort, K1, tile sort, bounds, block order) per
traced frame, in ms; `sort_ms_per_frame` is a part of it."""
import spans


def read(run):
    t = run.trace
    if t is None or run.unit != "frame" or not t.units:
        return None
    s = spans.device_s(t, "sj.bin")
    return None if s is None else s * 1e3 / t.units
