"""A torch.profiler window read from its Chrome trace: device intervals,
kernel records with the host time of their launch, and host annotations.

The trace is written under ``TMPDIR`` and deleted once read."""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import tempfile

WINDOW = "h100_bench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation")


@dataclasses.dataclass
class Trace:
    window: tuple            # (start, end) microseconds, trace clock
    device: list             # (name, cat, start, dur) microseconds
    kernels: list            # (name, start, dur, launch_ts or None)
    host: list               # (name, start, dur) host ops and annotations
    units: int               # frames or steps inside the window

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e6

    def busy_s(self) -> float:
        """Union of the device intervals inside the window."""
        lo, hi = self.window
        spans = sorted((max(s, lo), min(s + d, hi))
                       for _, _, s, d in self.device)
        busy, end = 0.0, lo
        for s, e in spans:
            if e <= end:
                continue
            busy += e - max(s, end)
            end = e
        return busy / 1e6

    def kernel_s(self, *patterns: str) -> float:
        """Device seconds of the kernels whose name holds any pattern."""
        return sum(d for n, _, d, _ in self.kernels
                   if any(p in n for p in patterns)) / 1e6

    def launched_within(self, annotation: str) -> float:
        """Device seconds of the kernels launched while the host was inside
        an annotation whose name holds ``annotation``."""
        spans = [(s, s + d) for n, s, d in self.host if annotation in n]
        return sum(d for _, _, d, t in self.kernels
                   if t is not None and any(a <= t <= b for a, b in spans)
                   ) / 1e6

    def top_ops(self, k: int = 10) -> list:
        tot = {}
        for n, _, _, d in self.device:
            tot[n] = tot.get(n, 0.0) + d
        return [[n[:120], d / 1e6] for n, d in
                sorted(tot.items(), key=lambda x: -x[1])[:k]]

    def idle_gaps(self, k: int = 10) -> list:
        """The longest gaps between device intervals, each named by the
        innermost host op running at its middle."""
        lo, hi = self.window
        spans = sorted((s, s + d) for _, _, s, d in self.device)
        gaps, end = [], lo
        for s, e in spans:
            if s > end:
                gaps.append((end, min(s, hi)))
            end = max(end, e)
        if end < hi:
            gaps.append((end, hi))
        gaps = sorted((g for g in gaps if g[1] > g[0]),
                      key=lambda g: g[0] - g[1])[:k]
        out = []
        for a, b in gaps:
            mid = 0.5 * (a + b)
            inner = [(s, n) for n, s, d in self.host
                     if s <= mid <= s + d and n != WINDOW]
            name = max(inner)[1] if inner else "host outside any op"
            out.append([name[:120], (b - a) / 1e6])
        return out


def parse(path: str, units: int) -> Trace:
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    launches = {}
    device, kernels, host, window = [], [], [], None
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        args = e.get("args", {})
        if cat == "cuda_runtime" or cat == "cuda_driver":
            if "correlation" in args:
                launches[args["correlation"]] = float(e["ts"])
        elif cat in DEVICE_CATS:
            device.append((e["name"], cat, float(e["ts"]), float(e["dur"])))
        elif cat in HOST_CATS:
            host.append((e["name"], float(e["ts"]), float(e["dur"])))
            if e["name"] == WINDOW:
                window = (float(e["ts"]), float(e["ts"]) + float(e["dur"]))
    if window is None:
        raise RuntimeError(f"the trace holds no {WINDOW!r} annotation")
    device = [d for d in device if d[2] < window[1] and d[2] + d[3] > window[0]]
    for e in events:
        if e.get("ph") == "X" and e.get("cat") == "kernel":
            ts = float(e["ts"])
            if window[0] < ts + float(e["dur"]) and ts < window[1]:
                corr = e.get("args", {}).get("correlation")
                kernels.append((e["name"], ts, float(e["dur"]),
                                launches.get(corr)))
    return Trace(window, device, kernels, host, units)


def _activities() -> list:
    import torch
    from torch.profiler import ProfilerActivity

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return acts


def dropped(fn) -> None:
    """Run ``fn`` under a profiler session whose trace is dropped."""
    from torch.profiler import profile

    with profile(activities=_activities()):
        fn()


@contextlib.contextmanager
def traced(units: int, out: list):
    """Profile the body (CPU and CUDA activity) inside the window
    annotation; append the parsed :class:`Trace` to ``out``."""
    from torch.profiler import profile, record_function

    with profile(activities=_activities()) as prof:
        with record_function(WINDOW):
            yield
    fd, path = tempfile.mkstemp(suffix=".json", prefix="h100_bench_trace_")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        out.append(parse(path, units))
    finally:
        os.remove(path)
