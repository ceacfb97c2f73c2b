"""Kernel records in the traced window per frame."""


def read(run):
    t = run.trace
    if t is None or run.unit != "frame" or not t.units:
        return None
    return len(t.kernels) / t.units
