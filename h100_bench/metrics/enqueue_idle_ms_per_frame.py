"""Time in which the device ran nothing while the host was inside the
program's ``sj.frame`` span, per traced frame, in ms: the part of the
device's idle time the frame's own enqueue leaves. Read from a profiled
run, whose per-op cost stretches the host, so it reads high."""
import spans


def read(run):
    t = run.trace
    if t is None or run.unit != "frame" or not t.units:
        return None
    s = spans.idle_s(t, "sj.frame")
    return None if s is None else s * 1e3 / t.units
