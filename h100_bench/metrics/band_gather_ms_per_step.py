"""The band tiles' exchange, device time per traced band step, in ms: the
kernels launched inside the program's ``sj.band_gather`` (the tile
all_gather) and ``sj.band_gather_bwd`` (its reduce_scatter) spans, on
rank 0."""
import spans


def read(run):
    t = run.trace
    if t is None or run.unit != "step" or not t.units:
        return None
    fwd = spans.device_s(t, "sj.band_gather")
    bwd = spans.device_s(t, "sj.band_gather_bwd")
    if fwd is None or bwd is None:
        return None
    return (fwd + bwd) * 1e3 / t.units
