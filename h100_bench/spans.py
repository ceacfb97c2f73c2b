"""The program's own spans and counters in a traced run.

``splatjax_torch.trace`` annotates the port's layers (``sj.frame``,
``sj.project``, ``sj.gather``, ...) while a profiler records, so they are
host annotations of the same trace as the kernel records and on its
clock. A span is matched by its exact name here: ``Trace.launched_within``
matches substrings, and ``sj.gather`` would take ``sj.gather_bwd`` too.

A kernel belongs to a span when the host launched it inside the span, by
the launch times ``Trace.kernels`` holds. Backward spans run on the
autograd engine's thread, but in time they lie inside the main thread's
``sj.render_bwd``. Every reader returns None where the trace holds no span
of the name, or the program keeps no counters (a program without
``splatjax_torch.trace``)."""
from __future__ import annotations

import bisect
from typing import Optional


def _union(spans) -> list:
    """Sorted, merged (start, end) intervals."""
    out = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def intervals(trace, name: str) -> list:
    """The (start, end) microseconds of the spans named ``name``, merged."""
    return _union((s, s + d) for n, s, d in trace.host if n == name)


def _within(t: float, union: list, starts: list) -> bool:
    i = bisect.bisect_right(starts, t) - 1
    return i >= 0 and t <= union[i][1]


def device_s(trace, name: str, exclude=()) -> Optional[float]:
    """Device seconds of the kernels launched inside a span named ``name``
    and outside every span named in ``exclude`` (its children, for a self
    time)."""
    inside = intervals(trace, name)
    if not inside:
        return None
    outside = [intervals(trace, n) for n in exclude]
    keys = [[s for s, _ in u] for u in [inside] + outside]
    return sum(
        d for _, _, d, t in trace.kernels
        if t is not None and _within(t, inside, keys[0])
        and not any(_within(t, u, k) for u, k in zip(outside, keys[1:]))
    ) / 1e6


def host_s(trace, name: str) -> Optional[float]:
    """Host seconds spent inside the spans named ``name``."""
    spans = intervals(trace, name)
    if not spans:
        return None
    return sum(e - s for s, e in spans) / 1e6


def idle_s(trace, name: str) -> Optional[float]:
    """Seconds inside the spans named ``name`` (within the window) in which
    the device ran no kernel, copy or set."""
    spans = intervals(trace, name)
    if not spans:
        return None
    lo, hi = trace.window
    busy = _union((max(s, lo), min(s + d, hi)) for _, _, s, d in trace.device
                  if s < hi and s + d > lo)
    idle = 0.0
    for a, b in spans:
        a, b = max(a, lo), min(b, hi)
        if b <= a:
            continue
        idle += (b - a) - sum(max(0.0, min(b, e) - max(a, s))
                              for s, e in busy)
    return idle / 1e6


def records(run, root: str) -> list:
    """The program's counter records of the traced window's frames or
    steps: the last ``trace.units`` records of roots named ``root``. Only
    profiled sessions record, and the window is the last of them."""
    t = run.trace
    if t is None or not t.units:
        return []
    try:
        from splatjax_torch import trace as program
    except ImportError:
        return []
    recs = [r for r in program.records() if r.name == root]
    return recs[-t.units:] if len(recs) >= t.units else []


def live_rows_pct(run, root: str) -> Optional[float]:
    """100 x the rows the gather launched over that hold an instance
    (min(instances, rows) a record) over all of them, summed over the
    records that counted both."""
    pairs = [(r.get("instances"), r.get("rows")) for r in records(run, root)]
    pairs = [(i, n) for i, n in pairs if i is not None and n]
    if not pairs:
        return None
    return 100.0 * sum(min(i, n) for i, n in pairs) / sum(n for _, n in pairs)
