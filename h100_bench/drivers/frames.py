"""Viewer frames in a closed loop: ``SplatRenderer.render`` over a cycle of
eyes, the next frame asked for once the last one has synced.

Traffic keys: ``eyes`` (see ``inputs.eyes``), ``feature_bytes`` and
``resort_interval`` (the renderer's), ``reference_rows`` (the row
rounding the reference applies: "32", "16" or null for float32 rows),
``capacity_margin``, ``warmup_frames`` (a multiple of the resort
interval), ``trace_frames``, ``sample_frames`` (frames compared),
``kernel`` (a name the traced window must hold) and ``work`` (the
roofline's key: "fwd" or "cached")."""
from __future__ import annotations

import time

import torch

import compare
import harness
import inputs
import reference
import profiling

TRACE_TRIES = 3


def _sync(dev) -> None:
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


class Frames:
    def __init__(self, cell, seed, device, bench_dir):
        self.cfg, self.tr, self.seed, self.dev = \
            cell.config, cell.traffic, seed, device
        self.base = inputs.parse_splat(bench_dir / self.cfg["base_scene"])
        self.views = inputs.views(inputs.eyes(self.tr["eyes"], seed),
                                  self.cfg, device)
        self.n = len(self.views)
        self.ri = int(self.tr["resort_interval"])
        if self.n % self.ri:
            raise ValueError("the eye cycle must be a multiple of the "
                             "resort interval")
        self.es = float(self.cfg["early_stop"])
        self.clip = self.cfg["alpha_clip"]

    def scene(self) -> dict:
        return inputs.tiled_scene(self.base, self.cfg, self.seed, self.dev)

    def index_view(self, r: int):
        """The view whose tile lists frame residue ``r`` draws with."""
        return self.views[r // self.ri * self.ri]

    def reference(self, scene, r: int, dtype=torch.float32):
        v = self.views[r]
        lv = None if self.ri == 1 else self.index_view(r)
        return reference.render(scene, v, rows=self.tr["reference_rows"],
                                alpha_clip=self.clip, early_stop=self.es,
                                dtype=dtype, lists_view=lv)

    def demands(self, scene) -> list:
        with torch.no_grad():
            return [reference.demand(reference.project_scene(
                scene, v, support_eps=self.es), v)
                for v in self.views[::self.ri]]

    def renderer(self, scene, capacity, feature_bytes=None):
        import splatjax_torch as sj

        return sj.SplatRenderer(
            scene=sj.GaussianScene(**scene), capacity=capacity,
            feature_bytes=feature_bytes or self.tr["feature_bytes"],
            resort_interval=self.ri, tile_size=int(self.cfg["tile_size"]),
            alpha_clip=self.clip, early_stop=self.es, device=self.dev)

    def cameras(self):
        from splatjax_torch.camera import Camera

        return [Camera(v.modelview, v.projection, v.width, v.height)
                for v in self.views]

    def frame_fn(self, renderer):
        cams = self.cameras()

        def frame(g):
            cam = cams[g % self.n]
            if self.ri == 1:
                return renderer.render(cam, return_overflow=True)
            img = renderer.render(cam)
            bins = getattr(renderer, "_bins", None)
            return img, getattr(getattr(bins, "bins", None), "overflow", 0)

        return frame

    def sample(self, residues: list, demands: list) -> list:
        """``sample_frames`` residues drawn from the seed among
        ``residues``, with the deepest index's stalest frame among them."""
        k = int(self.tr["sample_frames"])
        deepest = max(residues, key=lambda r: (
            demands[r // self.ri], r % self.ri))
        rest = [r for r in residues if r != deepest]
        pick = inputs.rng(self.seed, "sample").choice(
            len(rest), size=min(k - 1, len(rest)), replace=False)
        return sorted([deepest] + [rest[i] for i in pick])


def run(cell, *, seed, seconds, trace, device, t0, bench_dir):
    fr = Frames(cell, seed, device, bench_dir)
    scene = fr.scene()
    demands = fr.demands(scene)
    cap = inputs.capacity(demands, float(fr.tr["capacity_margin"]))
    harness.log(f"[capacity] {cap} for the largest demand {max(demands)} "
                f"(+{fr.tr['capacity_margin']}, 1024-aligned); instances "
                f"per index view: {demands}")
    renderer = fr.renderer(scene, cap)
    frame = fr.frame_fn(renderer)
    warm = int(fr.tr["warmup_frames"])
    n_tr = int(fr.tr["trace_frames"])
    residues = ([(warm + i) % fr.n for i in range(n_tr)] if trace
                else list(range(fr.n)))
    sample = fr.sample(residues, demands)
    durations, overflow, finite, kept = [], [], [], {}

    def tick(g, record=True) -> float:
        """One frame as the window draws it, with its checks."""
        a = time.perf_counter()
        img, ov = frame(g)
        _sync(device)
        b = time.perf_counter()
        ok = torch.isfinite(img).all()
        if record:
            durations.append(b - a)
            overflow.append(ov)
            finite.append(ok)
            if g % fr.n in sample:
                kept[g % fr.n] = img
        return b

    # warm-up draws what the window draws; in a traced run its last resort
    # interval runs under a profiler whose trace is dropped, since a
    # process's first profiler session pays the profiler's start-up
    tail = fr.ri if trace else 0
    for g in range(warm - tail):
        tick(g, record=False)
    if tail:
        profiling.dropped(lambda: [tick(g, record=False)
                                   for g in range(warm - tail, warm)])
    _sync(device)
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - t0

    traces = []
    if trace:
        for _ in range(TRACE_TRIES):
            traces.clear()
            with profiling.traced(n_tr, traces):
                for g in range(warm, warm + n_tr):
                    tick(g)
            if device != "cuda" or traces[0].kernel_s(fr.tr["kernel"]) > 0:
                break
            harness.log(f"[trace] no {fr.tr['kernel']!r} kernel record in "
                        "the trace; tracing again")
            durations, overflow, finite = [], [], []
        window_s = traces[0].window_s
    else:
        g = warm
        start = time.perf_counter()
        while True:
            b = tick(g)
            g += 1
            if b - start >= seconds:
                break
        window_s = b - start
    peak = (torch.cuda.max_memory_allocated()
            if torch.device(device).type == "cuda" else 0)
    bad = sum(int(o) != 0 or not bool(f) for o, f in zip(overflow, finite))
    harness.log(f"[window] {len(durations)} frames in {window_s:.6f} s, "
                f"{bad} failed; compared residues {sample}")
    del renderer, frame, scene
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()

    scene = fr.scene()
    work = []
    states = residues if trace else sample
    refs = {}
    for r in states:
        if r not in refs:
            refs[r] = fr.reference(scene, r)
        b = refs[r]
        v = fr.views[r]
        work.append({"fragments": b.fragments, "instances": b.instances,
                     "pixels": v.num_tiles * v.tile * v.tile})
        harness.log(f"[reference] residue {r}: {b.listed} instances, "
                    f"{b.walked_instances} walked, {b.instances} needed, "
                    f"{b.fragments} fragments")
    pairs = [(kept[r], refs[r].image) for r in sample if r in kept]
    checks = compare.images(pairs)
    # a compared frame the window never drew is a frame that never came
    checks["missing_frames"] = len(sample) - len(pairs)
    return harness.Run(
        unit="frame", attempted=len(durations), failed=bad,
        durations=durations, window_s=window_s, setup_s=setup_s,
        checks=checks, memory_peak_bytes=int(peak),
        trace=traces[0] if traces else None,
        work={fr.tr["work"]: work} if trace else {},
        config=fr.cfg, traffic=fr.tr)
