"""K3 (the fused redraw: projection of cached rows inside the blend)
against its roofline, in %."""
import roofline

KERNEL = "rasterize_cached"


def read(run):
    t, work = run.trace, run.work.get("cached")
    if t is None or not work:
        return None
    dev_s = t.kernel_s(KERNEL)
    if dev_s <= 0:
        return None
    return 100.0 * sum(roofline.cached(w) for w in work) / dev_s
