"""Projection's device time per traced training step, in ms: the kernels
launched inside the program's ``sj.project`` span, plus the self time of
``sj.render_bwd`` (the render's backward less K4 in ``sj.rasterize_bwd``
and the gather transpose in ``sj.gather_bwd``). That self time also holds
the backward of the activations (``to_scene``), of
``features_from_projection`` and of the image assembly, all small
elementwise work whose forward is in no span."""
import spans


def read(run):
    t = run.trace
    if t is None or run.unit != "step" or not t.units:
        return None
    fwd = spans.device_s(t, "sj.project")
    bwd = spans.device_s(t, "sj.render_bwd",
                         exclude=("sj.rasterize_bwd", "sj.gather_bwd"))
    if fwd is None or bwd is None:
        return None
    return (fwd + bwd) * 1e3 / t.units
