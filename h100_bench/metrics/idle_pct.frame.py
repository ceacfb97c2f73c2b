"""The device's idle share of the traced window, in %: 100 x (1 - the
union of its kernel, copy and set intervals / the window)."""


def read(run):
    t = run.trace
    if t is None or run.unit != "frame" or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s() / t.window_s)
