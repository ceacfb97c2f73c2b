"""Training steps on a (view x band) mesh of cards in a closed loop: the
step of ``splatjax_torch.parallel.make_dp_band_train_step`` over a cycle
of view pairs in ``fit(mesh=...)``'s order (step j renders views 2j and
2j + 1 mod the view count, one on each view group), each ending in a
sync on every rank.

One process a card. ``run`` is rank 0, in the calling process (run.py's,
so its trace and the program's counter records are read there); it
spawns ranks 1 .. D-1 as this file run as a script,

    python3 h100_bench/drivers/band.py --rank <r> --dir <run dir>

which reads the cell and the run's arguments from ``<run dir>/run.json``.
The ranks join one process group (NCCL on cards, gloo on the CPU) over a
``FileStore`` in a directory under ``TMPDIR``, with a finite timeout. A
rank that fails ends the run: rank 0 watches the others, and on the
first that exits with an error it kills the rest and exits 1; each other
rank exits once rank 0 is gone.

Each rank takes its own disjoint share of the CPUs and a fixed thread
count. Set-up: the seeded scene, broadcast from rank 0 so every rank
starts from the same bytes; the reference's targets of the unperturbed
scene, a quarter of the views on each rank, all-gathered; the step object
driven through its first ``reference_steps`` steps (rank 0 keeps their
losses, first gradient and change for the comparison), then
``warmup_steps`` more, from whose times rank 0 sets the window's step
count: whole cycles of the views, as near ``--seconds`` as they come,
agreed by every rank. The window starts after a barrier. After it every
rank's parameter bytes are compared with rank 0's, and rank 0, alone and
with the program's tensors freed, runs ``reference_band`` over the first
steps. ``--trace 1`` profiles rank 0 over steps 2 onwards instead of a
window (every rank runs the same calls).

Traffic keys: ``eyes``, ``noise``, ``redistribute``, ``balance``,
``reference_steps``, ``trace_steps``, ``warmup_steps``,
``timeout_s`` (the process group's, and the wait for the ranks' exit),
``threads`` (torch threads a rank) and ``control``."""
from __future__ import annotations

import argparse
import datetime
import json
import math
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time
import traceback
from pathlib import Path

HERE = Path(__file__).resolve().parent
BENCH = HERE.parent
ROOT = BENCH.parent
for _p in (str(BENCH), str(ROOT)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

import compare  # noqa: E402
import harness  # noqa: E402
import inputs  # noqa: E402
import profiling  # noqa: E402
import reference  # noqa: E402
import reference_band  # noqa: E402

# the fit cell's driver: its leaves, learning-rate names and noisy start
steps = harness.load_module(HERE / "steps.py", "h100_bench_driver_steps")


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _pin(rank: int, world: int, threads: int) -> str:
    """This process on its own share of the CPUs, with ``threads`` torch
    threads."""
    cpus = sorted(os.sched_getaffinity(0))
    share = len(cpus) // world
    if share:
        os.sched_setaffinity(0, cpus[rank * share:(rank + 1) * share])
    torch.set_num_threads(max(1, min(threads, share or threads)))
    mine = sorted(os.sched_getaffinity(0))
    return f"cpus {mine[0]}-{mine[-1]} ({len(mine)}), " \
           f"{torch.get_num_threads()} threads"


def _mesh_shape(cfg: dict) -> tuple:
    return int(cfg["mesh"]["view"]), int(cfg["mesh"]["band"])


def _log(rank: int, msg: str) -> None:
    """Rank 0's diagnostic line; the others keep theirs to errors."""
    if rank == 0:
        harness.log(msg)


class Rank:
    """One rank's inputs: the views, their targets and the start."""

    def __init__(self, cell, rank, world, seed, device, bench_dir):
        self.rank, self.world, self.seed, self.dev = rank, world, seed, device
        self.cfg, self.tr = cell.config, cell.traffic
        self.st = steps.Steps(cell, seed, device, Path(bench_dir))
        self.views = self.st.views
        self.n_view, self.n_band = _mesh_shape(self.cfg)
        n = len(self.views)
        if n % world or n % self.n_view:
            raise ValueError(f"{n} views do not split over {world} ranks "
                             f"and {self.n_view} view groups")
        self.pairs = n // self.n_view

    def start(self, group=None) -> dict:
        """The noisy start, the same bytes on every rank of ``group``
        (rank 0's)."""
        raw = self.st.start()
        for k in steps.LEAVES:
            if raw.get(k) is not None:
                dist.broadcast(raw[k], 0, group=group)
        return raw

    def targets(self) -> torch.Tensor:
        """(views, H, W, 4): the reference's image of each view of the
        unperturbed scene; rank r renders its quarter, every rank gets
        all."""
        scene = inputs.tiled_scene(self.st.base, self.cfg, self.seed,
                                   self.dev)
        fit = self.st.fit
        per = len(self.views) // self.world
        mine = torch.stack([
            reference.render(scene, v, rows=None,
                             alpha_clip=fit["alpha_clip"],
                             early_stop=fit["early_stop"]).image
            for v in self.views[self.rank * per:(self.rank + 1) * per]])
        del scene
        out = mine.new_empty((len(self.views),) + tuple(mine.shape[1:]))
        dist.all_gather_into_tensor(out, mine.contiguous())
        return out

    def by_step(self, x: torch.Tensor) -> torch.Tensor:
        """Stacked per-view tensors grouped as (pairs, view groups, ...):
        step j takes row j mod pairs."""
        return x.reshape((self.pairs, self.n_view) + tuple(x.shape[1:]))


def _mismatch(params, dev) -> int:
    """The ranks whose parameter bytes differ from rank 0's."""
    differs = torch.zeros((), dtype=torch.int64, device=dev)
    for p in params.parameters():
        mine = p.detach()
        zero = mine.clone()
        dist.broadcast(zero, 0)
        if not torch.equal(zero, mine):
            differs.fill_(1)
        del zero
    dist.all_reduce(differs)
    return int(differs)


def _body(cell, rank, world, seed, seconds, trace, device, t0, bench_dir):
    """Every rank's work; rank 0 returns the run, the others None."""
    from splatjax_torch.camera import Camera
    from splatjax_torch.parallel import (
        make_dp_band_train_step,
        make_mesh_2d,
    )
    from splatjax_torch.scene import TrainableGaussians
    from splatjax_torch.train.fit import FitConfig, _optimizer

    dev = torch.device(device)
    rk = Rank(cell, rank, world, seed, dev, bench_dir)
    tr, fit = rk.tr, rk.st.fit
    tg = rk.by_step(rk.targets())
    raw = rk.start()
    _log(rank, f"[band] {rk.cfg['splats']} splats, {len(rk.views)} views "
               f"at {rk.cfg['width']}x{rk.cfg['height']}, mesh (view, band) "
               f"= ({rk.n_view}, {rk.n_band}); targets and start ready")
    params = TrainableGaussians(**{k: raw[k] for k in steps.LEAVES})
    del raw
    fit_cfg = FitConfig(**fit)
    opt = _optimizer(params, fit_cfg)
    cams = [Camera(v.modelview, v.projection, v.width, v.height)
            for v in rk.views]
    mesh = make_mesh_2d((rk.n_view, rk.n_band), ("view", "band"),
                        device=dev.type)
    step = make_dp_band_train_step(
        cams, fit_cfg, mesh, view_axis="view", band_axis="band",
        tile_size=int(rk.cfg["tile_size"]),
        redistribute=tr["redistribute"], balance=tr["balance"])
    mvs = rk.by_step(torch.stack([v.modelview for v in rk.views]).to(dev))
    prs = rk.by_step(torch.stack([v.projection for v in rk.views]).to(dev))

    def one(i):
        j = i % rk.pairs
        return step(params, opt, mvs[j], prs[j], tg[j])

    k = int(tr["reference_steps"])
    n_tr = int(tr["trace_steps"]) if trace else 0
    profiled = trace and rank == 0
    prog = {"loss": [], "grad": {}, "change": {}}
    traces, durations, outs = [], [], []
    setup_s = None
    for i in range(k):
        in_trace = 1 <= i <= n_tr
        if i == 1 and in_trace:
            _sync(dev)
            if dev.type == "cuda":
                torch.cuda.reset_peak_memory_stats(dev)
            setup_s = time.perf_counter() - t0
            if profiled:
                profile = profiling.traced(n_tr, traces)
                profile.__enter__()
        a = time.perf_counter()
        if i == 0 and profiled:
            # a process's first profiler session pays its start-up
            got = []
            profiling.dropped(lambda: got.append(one(i)))
            out = got[0]
        else:
            out = one(i)
        _sync(dev)
        if in_trace:
            durations.append(time.perf_counter() - a)
            outs.append(out)
            if i == n_tr and profiled:
                profile.__exit__(None, None, None)
        prog["loss"].append(float(out[0]))
        if i == 0:
            b1 = opt.param_groups[0]["betas"][0]
            # Adam's first moment after one step is (1 - beta1) x the
            # gradient it got
            prog["grad"] = {
                name: float(opt.state[p]["exp_avg"].norm()) / (1.0 - b1)
                if "exp_avg" in opt.state.get(p, {}) else 0.0
                for name, p in params.named_parameters()}
    raw0 = rk.st.start()
    prog["change"] = {name: float((p.detach() - raw0[name]).norm())
                      for name, p in params.named_parameters()}
    del raw0
    _log(rank, f"[steps] program losses of steps 1-{k}: {prog['loss']}")

    if not trace:
        warm = []
        for i in range(k, k + int(tr["warmup_steps"])):
            a = time.perf_counter()
            one(i)
            _sync(dev)
            warm.append(time.perf_counter() - a)
        # whole cycles of the views, as near the window's seconds as come
        cycle = sorted(warm)[len(warm) // 2] * rk.pairs
        n_steps = torch.tensor(
            [max(1, round(seconds / cycle)) * rk.pairs], device=dev)
        dist.broadcast(n_steps, 0)
        n_steps = int(n_steps)
        _log(rank, f"[warmup] {len(warm)} steps, median "
                   f"{sorted(warm)[len(warm) // 2] * 1e3:.3f} ms; window "
                   f"of {n_steps} steps")
        _sync(dev)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        dist.barrier()
        setup_s = time.perf_counter() - t0
        first = k + len(warm)
        reserved = torch.cuda.memory_reserved(dev) if dev.type == "cuda" \
            else 0
        start = time.perf_counter()
        for i in range(first, first + n_steps):
            a = time.perf_counter()
            outs.append(one(i))
            _sync(dev)
            durations.append(time.perf_counter() - a)
        window_s = time.perf_counter() - start
        q = sorted(durations)
        spread = " / ".join(f"{q[int(f * (len(q) - 1))] * 1e3:.3f}"
                            for f in (0, 0.1, 0.5, 0.9, 1))
        after = torch.cuda.memory_reserved(dev) if dev.type == "cuda" else 0
        _log(rank, f"[window] step ms min / p10 / p50 / p90 / max: "
                   f"{spread}; allocator reserved {reserved} B before the "
                   f"window, {after} B after")
    else:
        window_s = traces[0].window_s if traces else sum(durations)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    bad_steps = sum(1 for o in outs
                    if not bool(torch.isfinite(o[0])) or int(o[3]) > 0)
    drops = sum(int(o[3]) for o in outs)
    rank_mismatch = _mismatch(params, dev)
    per_rank = torch.tensor([peak, drops], dtype=torch.int64, device=dev)
    every = per_rank.new_empty((world * 2,))
    dist.all_gather_into_tensor(every, per_rank)
    for r, (pk, dr) in enumerate(every.reshape(world, 2).tolist()):
        _log(rank, f"[window] rank {r}: memory_peak_bytes {pk}, drops {dr}")
    failed = len(durations) if rank_mismatch else bad_steps
    _log(rank, f"[window] {len(durations)} steps in {window_s:.6f} s, "
               f"{failed} failed; ranks whose parameters differ from rank "
               f"0's: {rank_mismatch}")
    if outs:
        _log(rank, f"[window] losses: first {float(outs[0][0])}, last "
                   f"{float(outs[-1][0])}")
    # the reference: one process a view of each step, ranks 0 .. views-1
    n_ref = rk.n_view
    ref_group = dist.new_group(list(range(n_ref)))
    del params, opt, step, one, outs, mesh
    if rank >= n_ref:
        dist.destroy_process_group()
        return None
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    def reduce(tensors):
        for t in tensors:
            dist.all_reduce(t, group=ref_group)

    lrs = {k_: fit[f"lr_{steps.LR_NAMES[k_]}"] for k_ in steps.LEAVES}
    raw = rk.start(ref_group)
    raw0 = {k_: v.clone() for k_, v in raw.items() if v is not None}
    mine = [(j % rk.pairs, rank) for j in range(k)]
    ref_loss, ref_grad, blends = reference_band.run_steps(
        raw, lrs, [[rk.views[p * rk.n_view + v]] for p, v in mine],
        [[tg[p][v]] for p, v in mine], k, reduce=reduce,
        rows=str(fit["feature_bytes"]), alpha_clip=fit["alpha_clip"],
        early_stop=fit["early_stop"], ssim_weight=fit["ssim_weight"])
    ref = {"loss": ref_loss,
           "grad": {k_: float(g.norm()) for k_, g in ref_grad.items()},
           "change": {k_: float((raw[k_] - raw0[k_]).norm())
                      for k_ in ref_grad}}
    dist.destroy_process_group()
    if rank:
        return None
    harness.log(f"[reference] losses {ref['loss']}; first gradient norms "
                f"{ref['grad']} (program {prog['grad']}); change norms "
                f"{ref['change']} (program {prog['change']})")
    for j, b in enumerate(blends):
        harness.log(f"[reference] step {j + 1} view {rank}: {b.listed} "
                    f"instances, {b.walked_instances} walked, {b.fragments} "
                    "fragments")
    checks = compare.training(prog, ref)
    checks["rank_mismatch"] = rank_mismatch
    return harness.Run(
        unit="step", attempted=len(durations), failed=failed,
        durations=durations, window_s=window_s, setup_s=setup_s,
        checks=checks, memory_peak_bytes=int(peak),
        trace=traces[0] if traces else None,
        config=rk.cfg, traffic=tr)


def _init(rank: int, world: int, store: str, device: str,
          timeout_s: float) -> None:
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(rank)
    dist.init_process_group(
        "nccl" if dev.type == "cuda" else "gloo",
        store=dist.FileStore(store, world), rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=timeout_s))


def _rank_device(device: str, rank: int) -> str:
    return f"cuda:{rank}" if torch.device(device).type == "cuda" else "cpu"


class _Watch:
    """Rank 0's watch over the other ranks: the first that exits with an
    error, or is killed, ends the run (the rest killed, exit 1)."""

    def __init__(self, procs):
        self.procs, self.done = procs, threading.Event()
        self.thread = threading.Thread(target=self._loop, daemon=True)
        self.thread.start()

    def _loop(self):
        while not self.done.wait(0.5):
            for r, p in enumerate(self.procs, 1):
                rc = p.poll()
                if rc is not None and rc != 0:
                    harness.log(f"[band] rank {r} exited with {rc}: ending "
                                "the run")
                    kill(self.procs)
                    os._exit(1)

    def stop(self):
        self.done.set()
        self.thread.join()


def kill(procs) -> None:
    for p in procs:
        if p.poll() is None:
            p.send_signal(signal.SIGKILL)
    for p in procs:
        p.wait()


def run(cell, *, seed, seconds, trace, device, t0, bench_dir):
    world = math.prod(_mesh_shape(cell.config))
    tr = cell.traffic
    timeout_s = float(tr["timeout_s"])
    if torch.device(device).type == "cuda":
        from splatjax_torch import kernels

        kernels.build()             # once, before the ranks load it
    run_dir = tempfile.mkdtemp(prefix="h100_bench_band_")
    procs, watch = [], None
    try:
        (Path(run_dir) / "run.json").write_text(json.dumps({
            "cell": {"name": cell.name, "chips": cell.chips,
                     "config": cell.config, "traffic": tr,
                     "limits": cell.limits},
            "world": world, "seed": seed, "seconds": seconds,
            "trace": bool(trace), "device": device,
            "bench_dir": str(bench_dir)}))
        for r in range(1, world):
            procs.append(subprocess.Popen(
                [sys.executable, str(Path(__file__).resolve()), "--rank",
                 str(r), "--dir", run_dir], stdout=sys.stderr))
        harness.log(f"[band] {world} ranks: 0 is pid {os.getpid()}, "
                    + ", ".join(f"{r} pid {p.pid}"
                                for r, p in enumerate(procs, 1)))
        watch = _Watch(procs)
        harness.log(f"[band] rank 0: {_pin(0, world, int(tr['threads']))}")
        _init(0, world, os.path.join(run_dir, "store"), device, timeout_s)
        out = _body(cell, 0, world, seed, seconds, trace,
                    _rank_device(device, 0), t0, bench_dir)
        watch.stop()
        watch = None
        for r, p in enumerate(procs, 1):
            try:
                rc = p.wait(timeout=timeout_s)
            except subprocess.TimeoutExpired:
                raise RuntimeError(f"rank {r} did not exit")
            if rc:
                raise RuntimeError(f"rank {r} exited with {rc}")
        return out
    finally:
        if watch is not None:
            watch.stop()            # rank 0 failed: its error is the run's
        kill(procs)
        shutil.rmtree(run_dir, ignore_errors=True)


def _watch_parent() -> None:
    """End this rank once rank 0's process is gone."""
    parent = os.getppid()

    def loop():
        while True:
            time.sleep(0.5)
            if os.getppid() != parent:
                os._exit(1)

    threading.Thread(target=loop, daemon=True).start()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="one rank of a band-step run")
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--dir", required=True)
    args = ap.parse_args(argv)
    _watch_parent()
    spec = json.loads((Path(args.dir) / "run.json").read_text())
    c = spec["cell"]
    cell = harness.Cell(c["name"], c["chips"], c["config"], c["traffic"],
                        c["limits"], [], [])
    world = spec["world"]
    try:
        pinned = _pin(args.rank, world, int(c["traffic"]["threads"]))
        print(f"[band] rank {args.rank}: {pinned}", file=sys.stderr,
              flush=True)
        _init(args.rank, world, os.path.join(args.dir, "store"),
              spec["device"], float(c["traffic"]["timeout_s"]))
        _body(cell, args.rank, world, spec["seed"], spec["seconds"],
              spec["trace"], _rank_device(spec["device"], args.rank),
              time.perf_counter(), spec["bench_dir"])
    except Exception:  # noqa: BLE001 - the rank's boundary: report, exit 1
        traceback.print_exc()
        return 1
    found = harness.forbidden_modules()
    if found:
        print(f"[rank {args.rank}] loaded {found}", file=sys.stderr)
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(main())
