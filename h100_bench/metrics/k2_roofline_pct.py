"""K2 (the forward rasterizer on packed rows) against its roofline, in %:
the least time its frames' work needs over its device time."""
import roofline

KERNEL = "rasterize_fwd"


def read(run):
    t, work = run.trace, run.work.get("fwd")
    if t is None or not work:
        return None
    dev_s = t.kernel_s(KERNEL)
    if dev_s <= 0:
        return None
    rb = int(run.traffic["feature_bytes"])
    return 100.0 * sum(roofline.forward(w, rb) for w in work) / dev_s
