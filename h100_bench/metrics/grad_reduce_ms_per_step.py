"""The gradient's all_reduce, device time per traced band step, in ms:
the kernels launched inside the program's ``sj.grad_reduce`` span (the
flat copy of every leaf's gradient, the all_reduce, the division and the
copy back), on rank 0."""
import spans


def read(run):
    t = run.trace
    if t is None or run.unit != "step" or not t.units:
        return None
    s = spans.device_s(t, "sj.grad_reduce")
    return None if s is None else s * 1e3 / t.units
