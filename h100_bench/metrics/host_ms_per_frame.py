"""Host time inside the program's ``sj.frame`` span (``SplatRenderer.render``
up to its return, before the caller's sync: the frame's enqueue) per
traced frame, in ms. The profiler's per-op cost stretches the host, so it
reads high against an untraced frame."""
import spans


def read(run):
    t = run.trace
    if t is None or run.unit != "frame" or not t.units:
        return None
    s = spans.host_s(t, "sj.frame")
    return None if s is None else s * 1e3 / t.units
