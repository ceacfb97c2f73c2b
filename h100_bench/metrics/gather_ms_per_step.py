"""The row gather's device time per traced training step, in ms: the
kernels launched inside the program's ``sj.gather`` (row pack + gather)
and ``sj.gather_bwd`` (its transpose: slot positions, K5-K7) spans."""
import spans


def read(run):
    t = run.trace
    if t is None or run.unit != "step" or not t.units:
        return None
    fwd = spans.device_s(t, "sj.gather")
    bwd = spans.device_s(t, "sj.gather_bwd")
    if fwd is None or bwd is None:
        return None
    return (fwd + bwd) * 1e3 / t.units
