"""The redistribution's device time per traced band step, in ms: the
kernels launched inside the program's ``sj.redistribute`` (the all_to_all
send buffer and the all_to_all) and ``sj.redistribute_bwd`` (the reverse
all_to_all and the send buffer's transpose) spans, on rank 0."""
import spans


def read(run):
    t = run.trace
    if t is None or run.unit != "step" or not t.units:
        return None
    fwd = spans.device_s(t, "sj.redistribute")
    bwd = spans.device_s(t, "sj.redistribute_bwd")
    if fwd is None or bwd is None:
        return None
    return (fwd + bwd) * 1e3 / t.units
