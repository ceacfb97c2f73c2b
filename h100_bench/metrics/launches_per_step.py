"""Kernel records in the traced window per step."""


def read(run):
    t = run.trace
    if t is None or run.unit != "step" or not t.units:
        return None
    return len(t.kernels) / t.units
