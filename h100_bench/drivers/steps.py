"""Training steps in a closed loop: the step of
``splatjax_torch.train.fit.make_train_step`` over a cycle of views in
``fit()``'s order (step i renders view i mod views), each ending in a sync.

Set-up builds the one step object with its parameters and Adam state and
drives it through its first ``reference_steps`` steps; the window goes on
with the same object. Traffic keys: ``eyes``, ``noise`` (std of the
seeded noise on each raw leaf named), ``capacity_margin``,
``reference_steps``, ``trace_steps`` (steps 2 onwards are the traced
window, inside the steps the reference follows), ``kernel`` and
``work``."""
from __future__ import annotations

import time

import torch

import compare
import harness
import inputs
import profiling
import reference

LEAVES = ("means", "log_scales", "quats", "logit_opacities", "colors", "sh")
# FitConfig's learning rate of each leaf: lr_<name>
LR_NAMES = {"means": "means", "log_scales": "scales", "quats": "quats",
            "logit_opacities": "opacities", "colors": "colors", "sh": "sh"}


def _sync(dev) -> None:
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


class Steps:
    def __init__(self, cell, seed, device, bench_dir):
        self.cfg, self.tr, self.seed, self.dev = \
            cell.config, cell.traffic, seed, device
        self.base = inputs.parse_splat(bench_dir / self.cfg["base_scene"])
        self.views = inputs.views(inputs.eyes(self.tr["eyes"], seed),
                                  self.cfg, device)
        self.fit = self.cfg["fit"]

    def start(self) -> dict:
        """The noisy start, as raw leaves."""
        scene = inputs.tiled_scene(self.base, self.cfg, self.seed, self.dev)
        return inputs.noisy(inputs.raw_leaves(scene), self.tr["noise"],
                            self.seed)

    def targets(self) -> list:
        """One image per view of the unperturbed scene, by the reference."""
        scene = inputs.tiled_scene(self.base, self.cfg, self.seed, self.dev)
        return [reference.render(scene, v, rows=None,
                                 alpha_clip=self.fit["alpha_clip"],
                                 early_stop=self.fit["early_stop"]).image
                for v in self.views]

    def demands(self, raw: dict) -> list:
        with torch.no_grad():
            scene = reference.activate(raw)
            return [reference.demand(reference.project_scene(
                scene, v, support_eps=self.fit["early_stop"]), v)
                for v in self.views]

    def reference_steps(self, targets, steps: int, dtype=torch.float32,
                        rows_in_loss=None):
        """The reference's first ``steps`` steps from the start: losses,
        first gradient norms, change norms and each step's blend."""
        raw = self.start()
        raw0 = {k: None if v is None else v.clone() for k, v in raw.items()}
        lrs = {k: self.fit[f"lr_{LR_NAMES[k]}"]
               for k in LEAVES if raw.get(k) is not None}
        adam = reference.Adam(lrs)
        losses, blends, grad = [], [], {}
        for i in range(steps):
            v = i % len(self.views)
            loss, grads, done = reference.train_step(
                raw, adam, self.views[v], targets[v],
                rows=str(self.fit["feature_bytes"]),
                alpha_clip=self.fit["alpha_clip"],
                early_stop=self.fit["early_stop"],
                ssim_weight=self.fit["ssim_weight"], dtype=dtype,
                rows_in_loss=rows_in_loss)
            losses.append(loss)
            blends.append(done)
            if i == 0:
                grad = {k: float(g.norm()) for k, g in grads.items()}
        change = {k: float((raw[k] - raw0[k]).norm()) for k in grad}
        return {"loss": losses, "grad": grad, "change": change}, blends


def run(cell, *, seed, seconds, trace, device, t0, bench_dir):
    from splatjax_torch.camera import Camera
    from splatjax_torch.scene import TrainableGaussians
    from splatjax_torch.train.fit import (
        FitConfig,
        _optimizer,
        make_train_step,
    )

    st = Steps(cell, seed, device, bench_dir)
    targets = st.targets()
    raw = st.start()
    demands = st.demands(raw)
    cap = inputs.capacity(demands, float(st.tr["capacity_margin"]))
    harness.log(f"[capacity] {cap} for the largest demand {max(demands)}; "
                f"instances per view at the start: {demands}")
    params = TrainableGaussians(**{k: raw[k] for k in LEAVES})
    del raw
    fit_cfg = FitConfig(**st.fit)
    opt = _optimizer(params, fit_cfg)
    cams = [Camera(v.modelview, v.projection, v.width, v.height)
            for v in st.views]
    step = make_train_step(cams, fit_cfg, cap)
    n = len(st.views)

    def one(i):
        v = i % n
        return step(params, opt, st.views[v].modelview,
                    st.views[v].projection, targets[v])

    k = int(st.tr["reference_steps"])
    n_tr = int(st.tr["trace_steps"]) if trace else 0
    prog = {"loss": [], "grad": {}, "change": {}}
    traces, durations, losses = [], [], []
    setup_s = None
    for i in range(k):
        in_trace = 1 <= i <= n_tr
        if i == 1 and in_trace:
            if torch.device(device).type == "cuda":
                torch.cuda.reset_peak_memory_stats()
            setup_s = time.perf_counter() - t0
            profile = profiling.traced(n_tr, traces)
            profile.__enter__()
        a = time.perf_counter()
        if i == 0 and trace:
            # a process's first profiler session pays its start-up
            out = []
            profiling.dropped(lambda: out.append(one(i)[0]))
            loss = out[0]
        else:
            loss = one(i)[0]
        _sync(device)
        if in_trace:
            durations.append(time.perf_counter() - a)
            losses.append(loss)
            if i == n_tr:
                profile.__exit__(None, None, None)
        prog["loss"].append(float(loss))
        if i == 0:
            b1 = opt.param_groups[0]["betas"][0]
            # Adam's first moment after one step is (1 - beta1) x the
            # gradient it got; an optimizer that kept no state got none
            prog["grad"] = {
                name: float(opt.state[p]["exp_avg"].norm()) / (1.0 - b1)
                if "exp_avg" in opt.state.get(p, {}) else 0.0
                for name, p in params.named_parameters()}
    raw0 = st.start()
    prog["change"] = {name: float((p.detach() - raw0[name]).norm())
                      for name, p in params.named_parameters()}
    del raw0
    harness.log(f"[steps] program losses of steps 1-{k}: {prog['loss']}")

    if not trace:
        _sync(device)
        if torch.device(device).type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        setup_s = time.perf_counter() - t0
        i = k
        start = time.perf_counter()
        while True:
            a = time.perf_counter()
            losses.append(one(i)[0])
            _sync(device)
            b = time.perf_counter()
            durations.append(b - a)
            i += 1
            if b - start >= seconds:
                break
        window_s = b - start
    else:
        window_s = traces[0].window_s
    peak = (torch.cuda.max_memory_allocated()
            if torch.device(device).type == "cuda" else 0)
    bad = sum(not bool(torch.isfinite(x)) for x in losses)
    end_demand = st.demands({name: p.detach() for name, p in
                             params.named_parameters()})
    if max(end_demand) > cap:
        bad = max(len(durations), 1)
    harness.log(f"[window] {len(durations)} steps in {window_s:.6f} s, "
                f"{bad} failed; instances per view at the end: {end_demand}")
    if losses:
        harness.log(f"[window] losses: first {float(losses[0])}, last "
                    f"{float(losses[-1])}")
    del params, opt, step, one
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()

    ref, blends = st.reference_steps(targets, k)
    harness.log(f"[reference] losses {ref['loss']}; first gradient norms "
                f"{ref['grad']} (program {prog['grad']}); change norms "
                f"{ref['change']} (program {prog['change']})")
    work = []
    for b, i in zip(blends, range(k)):
        harness.log(f"[reference] step {i + 1}: {b.listed} instances, "
                    f"{b.walked_instances} walked, {b.instances} needed, "
                    f"{b.fragments} fragments")
        if 1 <= i <= n_tr:
            v = st.views[i % n]
            work.append({"fragments": b.fragments, "instances": b.instances,
                         "pixels": v.num_tiles * v.tile * v.tile})
    return harness.Run(
        unit="step", attempted=len(durations), failed=bad,
        durations=durations, window_s=window_s, setup_s=setup_s,
        checks=compare.training(prog, ref), memory_peak_bytes=int(peak),
        trace=traces[0] if traces else None,
        work={st.tr["work"]: work} if trace else {},
        config=st.cfg, traffic=st.tr)
