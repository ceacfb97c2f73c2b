"""The loss's device time per traced training step, in ms: every kernel
launched inside the program's ``sj.loss`` (L1 + SSIM forward) and
``sj.loss_bwd`` (their backward) spans, the elementwise maps included,
where `loss_ms_per_step` counts only the convolutions."""
import spans


def read(run):
    t = run.trace
    if t is None or run.unit != "step" or not t.units:
        return None
    fwd = spans.device_s(t, "sj.loss")
    bwd = spans.device_s(t, "sj.loss_bwd")
    if fwd is None or bwd is None:
        return None
    return (fwd + bwd) * 1e3 / t.units
