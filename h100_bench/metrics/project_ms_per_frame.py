"""Device time of the kernels launched inside the program's ``sj.project``
span (covariances, projection, SH, support boxes) per traced frame, in
ms. In the orbit K3 projects inside itself, so only the rebuild frames'
projection counts there, averaged over every traced frame."""
import spans


def read(run):
    t = run.trace
    if t is None or run.unit != "frame" or not t.units:
        return None
    s = spans.device_s(t, "sj.project")
    return None if s is None else s * 1e3 / t.units
