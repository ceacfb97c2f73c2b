"""Device time of the kernels launched inside ``Optimizer.step`` per
traced step, in ms."""

ANNOTATION = "Optimizer.step"


def read(run):
    t = run.trace
    if t is None or run.unit != "step" or not t.units:
        return None
    s = t.launched_within(ANNOTATION)
    return s * 1e3 / t.units if s > 0 else None
