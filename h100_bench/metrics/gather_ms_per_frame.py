"""Device time of the kernels launched inside the program's ``sj.gather``
span per traced frame, in ms: the row pack and gather of an exact frame,
the parameter-cache gather of a rebuild (in the orbit only the rebuild
frames gather, averaged over every traced frame)."""
import spans


def read(run):
    t = run.trace
    if t is None or run.unit != "frame" or not t.units:
        return None
    s = spans.device_s(t, "sj.gather")
    return None if s is None else s * 1e3 / t.units
