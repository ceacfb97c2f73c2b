"""Device time of the sorts' kernels per traced frame, in ms."""

PATTERNS = ("RadixSort", "radixSort", "SortKV", "sort_")


def read(run):
    t = run.trace
    if t is None or run.unit != "frame" or not t.units:
        return None
    s = t.kernel_s(*PATTERNS)
    return s * 1e3 / t.units if s > 0 else None
