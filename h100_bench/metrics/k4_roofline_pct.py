"""K4 (the backward rasterizer) against its roofline, in %."""
import roofline

KERNEL = "rasterize_bwd"


def read(run):
    t, work = run.trace, run.work.get("bwd")
    if t is None or not work:
        return None
    dev_s = t.kernel_s(KERNEL)
    if dev_s <= 0:
        return None
    rb = int(run.config["fit"]["feature_bytes"])
    return 100.0 * sum(roofline.backward(w, rb) for w in work) / dev_s
