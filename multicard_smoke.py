#!/usr/bin/env python3
"""Multi-card check of the port's multi-device slice
(``splatjax_torch.parallel``) on every card of one host.

    python3 multicard_smoke.py

``chip_smoke.py`` holds the slice to one card, a one-rank NCCL group.
This script spawns one process per card (at least 2, an even count D),
each starting NCCL through ``init_distributed`` (a FileStore under
``build/``) on its own card, and drives on chip_smoke.py's serving scene
(the trained fixture tiled to 1M splats, 1920x1080):

  1. ``render_sharded`` with splatjax's defaults over ``make_mesh(D)``
     (all_to_all, load-balanced bands; then equal bands) and over
     ``make_mesh_2d((2, D/2))`` with ``axis=("host", "chip")``: overflow 0,
     the image against ``render()`` on the rank's own card (max error, and
     at most MAX_TIE_PIXELS pixels over 1e-3: band-local and global tile
     origins round apart, and exactly equal depths can sort apart), the
     same bytes on every rank;
  2. ``fit(mesh=make_mesh(D))`` one step over D views and
     ``make_dp_band_train_step`` on the (view, band) = (2, D/2) mesh one
     step over 2 views, both with 32-byte rows, against the one-card
     gradient of the views' mean loss on the rank's card (the gradient
     gate: atol 2e-3 x max, rtol 2e-3); the parameters the same bytes on
     every rank; the band step run twice from one start, bit for bit;
  3. times on rank 0 (every rank runs the same calls): frame and step
     medians by host clock, device busy and the NCCL kernels' share by
     torch.profiler, each collective alone by CUDA events. These are the
     checks' side readings at 1M splats and 1080p; the timed source of
     4-card step times is the benchmark's ``sharded_4m_4k.band_step``
     cell (``h100_bench/drivers/band.py``, ``h100_bench/run.py``).

Each line names the rank's card and power limit; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": D}}``.
Without at least two CUDA devices it prints no result and exits 1.
"""
from __future__ import annotations

import hashlib
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
# tests/test_distributed.py allows 3 such pixels at 512x512; the same rate
# at 1920x1080
MAX_TIE_PIXELS = 24
FRAMES = 10
STEPS = 5


def digest(tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def same_on_every_rank(value: str, what: str) -> None:
    import torch.distributed as dist

    got = [None] * dist.get_world_size()
    dist.all_gather_object(got, value)
    if len(set(got)) != 1:
        raise AssertionError(f"{what} differs between ranks")


def frames(cs, scene, cam, ref, smi, log):
    """Phase 1: render_sharded against render()."""
    import torch
    from splatjax_torch.parallel import (
        make_mesh, make_mesh_2d, render_sharded,
    )

    d = torch.distributed.get_world_size()
    mesh = make_mesh(d)
    cases = (("make_mesh", mesh, "dev", "load"),
             ("make_mesh", mesh, "dev", "equal"),
             ("make_mesh_2d", make_mesh_2d((2, d // 2)), ("host", "chip"),
              "load"))
    with torch.no_grad():
        for label, m, axis, balance in cases:
            img, ov = render_sharded(scene, cam, m, axis=axis,
                                     balance=balance, return_overflow=True)
            cs.check_frame(img, f"render_sharded {label} {balance}")
            diff = (img - ref).abs().amax(dim=-1)
            ties = int((diff > 1e-3).sum())
            same_on_every_rank(digest([img, ov]), f"{label} {balance} image")
            if int(ov.sum()) != 0 or ties > MAX_TIE_PIXELS:
                raise AssertionError(f"render_sharded {label} {balance}: "
                                     f"overflow {ov.tolist()}, {ties} pixels "
                                     "over 1e-3")
            log(f"[multi] render_sharded {label}({d}) {balance}: overflow "
                f"{ov.tolist()}, max |image - render()| "
                f"{float(diff.max()):.3g}, pixels over 1e-4 "
                f"{int((diff > 1e-4).sum())}, over 1e-3 {ties}; the same "
                f"bytes on every rank; {smi}")


def reference_grads(cs, start, cams, targets, cfg, capacity):
    """The one-card gradient of the views' mean loss."""
    from splatjax_torch.render import render
    from splatjax_torch.train.loss import combined_loss

    p = fresh(start)
    loss = sum(combined_loss(render(p.to_scene(), c, capacity=capacity,
                                    alpha_clip=cfg.alpha_clip,
                                    early_stop=cfg.early_stop,
                                    feature_bytes=cfg.feature_bytes), t,
                             ssim_weight=cfg.ssim_weight)
               for c, t in zip(cams, targets)) / len(cams)
    loss.backward()
    return {k: getattr(p, k).grad for k in cs.LEAVES}


def fresh(start):
    from splatjax_torch.scene import TrainableGaussians

    return TrainableGaussians(**{
        k: None if getattr(start, k) is None
        else getattr(start, k).detach().clone()
        for k in TrainableGaussians.LEAVES})


def steps(cs, start, cams, targets, capacity, smi, log):
    """Phase 2: the DP and (view, band) steps against the one-card mean
    gradient."""
    import torch
    from splatjax_torch.parallel import (
        make_dp_band_train_step, make_mesh, make_mesh_2d,
    )
    from splatjax_torch.train import FitConfig, fit
    from splatjax_torch.train.fit import _optimizer

    d = torch.distributed.get_world_size()
    cfg = FitConfig(capacity=capacity, feature_bytes=32)

    def grads(p):
        return {k: getattr(p, k).grad for k in cs.LEAVES}

    def leaves(p):
        return [getattr(p, k) for k in cs.LEAVES]

    want = reference_grads(cs, start, cams[:d], targets[:d], cfg, capacity)
    dp, _ = fit(fresh(start), cams[:d], targets[:d],
                FitConfig(steps=1, log_every=1, capacity=capacity,
                          feature_bytes=32), mesh=make_mesh(d))
    err, _ = cs.grad_gate(grads(dp), want, "fit(mesh=make_mesh)")
    same_on_every_rank(digest(leaves(dp)), "DP parameters")
    log(f"[multi] fit(mesh=make_mesh({d})) one step over {d} views: "
        f"gradients max err {err:.3g} against the one-card mean; the same "
        f"parameters on every rank; {smi}")

    band_mesh = make_mesh_2d((2, d // 2), ("view", "band"))
    step = make_dp_band_train_step(cams[:2], cfg, band_mesh,
                                   view_axis="view", band_axis="band")
    mv = torch.stack([c.modelview for c in cams[:2]])
    pr = torch.stack([c.projection for c in cams[:2]])
    tg = torch.stack(targets[:2])
    want = reference_grads(cs, start, cams[:2], targets[:2], cfg, capacity)
    runs = []
    for _ in range(2):
        p = fresh(start)
        _, _, _, drops = step(p, _optimizer(p, cfg), mv, pr, tg)
        runs.append((p, int(drops)))
    err, _ = cs.grad_gate(grads(runs[0][0]), want, "band step")
    twice = digest(leaves(runs[0][0]) + list(grads(runs[0][0]).values())) \
        == digest(leaves(runs[1][0]) + list(grads(runs[1][0]).values()))
    same_on_every_rank(digest(leaves(runs[0][0])), "band parameters")
    if runs[0][1] or runs[1][1]:
        raise AssertionError(f"band step dropped {runs[0][1]} instances")
    log(f"[multi] make_dp_band_train_step (2, {d // 2}) one step over 2 "
        f"views: gradients max err {err:.3g} against the one-card mean; "
        f"drops 0; the same parameters on every rank; two runs "
        f"bit-identical {twice}; {smi}")
    return step, runs[0][0], cfg, (mv, pr, tg)


def timing(cs, scene, cam, band, smi, log):
    """Phase 3: frame and step times."""
    import torch
    from splatjax_torch.parallel import make_mesh, render_sharded
    from splatjax_torch.parallel.dist_render import (
        _default_pair_capacity, all_gather, all_to_all, max_band_rows,
    )
    from splatjax_torch.parallel.mesh import mesh_group
    from splatjax_torch.train.fit import _optimizer

    d = torch.distributed.get_world_size()
    mesh = make_mesh(d)

    def frame():
        with torch.no_grad():
            return render_sharded(scene, cam, mesh)

    def median_ms(fn, n):
        ms = []
        for _ in range(n):
            cs.sync()
            torch.distributed.barrier()
            t0 = time.perf_counter()
            fn()
            cs.sync()
            ms.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(ms), ms

    step, params, cfg, batch = band
    opt = _optimizer(params, cfg)

    def one_step():
        return step(params, opt, *batch)

    for what, fn, n in (("frame", frame, FRAMES),
                        ("band step", one_step, STEPS)):
        med, ms = median_ms(fn, n)
        busy, nccl, _ = cs.collective_share(fn, 3)
        log(f"[multi] {what}, {d} ranks: median {med:.3f} ms (all: "
            f"{', '.join(f'{t:.3f}' for t in ms)}); device busy "
            f"{busy:.3f} ms, NCCL kernels {nccl:.4f} ms "
            f"({nccl / busy:.4f} of it); rank 0 {smi}")
    group = mesh_group(mesh)
    pc = _default_pair_capacity(scene.num_gaussians // d, d)
    send = torch.zeros((d * pc, 13), device=scene.device)
    tiles = torch.zeros((-(-cam.width // 16) * max_band_rows(
        cam.height, d, 16), 8, 256), device=scene.device)
    a2a = cs.cuda_ms(lambda: all_to_all(send, group), 20)
    ag = cs.cuda_ms(lambda: all_gather(tiles, group), 20)
    log(f"[multi] collectives by CUDA events, {d} ranks: all_to_all of the "
        f"{tuple(send.shape)} f32 send buffer {a2a:.4f} ms, all_gather of "
        f"the {tuple(tiles.shape)} f32 band tiles {ag:.4f} ms; rank 0 {smi}")


def rank_main(rank: int, world: int, store: str) -> None:
    import torch
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    from splatjax_torch import make_camera
    from splatjax_torch.io import load_splat, tile_scene
    from splatjax_torch.parallel import init_distributed
    from splatjax_torch.render import render

    if not init_distributed("file://" + store, world, rank, device="cuda"):
        raise AssertionError("init_distributed started no group")
    smi = subprocess.run(
        ["nvidia-smi", f"--id={torch.cuda.current_device()}",
         "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()

    def log(msg):
        if rank == 0:
            print(msg, flush=True)

    print(f"[multi] rank {rank} on card {torch.cuda.current_device()}: "
          f"{smi}", flush=True)
    torch.backends.cudnn.allow_tf32 = False
    try:
        scene = tile_scene(load_splat(cs.FIXTURE), cs.N_SPLATS)
        # world views on chip_smoke.py's orbit
        cams = [make_camera((0.02 * math.sin(2.0 * math.pi * i / world),
                             0.02 * math.cos(2.0 * math.pi * i / world),
                             2.8), (0, 0, 0), width=cs.WIDTH,
                            height=cs.HEIGHT) for i in range(world)]
        start = cs.noisy_start(scene)
        need = max(max(cs.demand(scene, c), cs.demand(start.to_scene(), c))
                   for c in cams)
        capacity = -(-int(need * 1.03) // 1024) * 1024
        with torch.no_grad():
            targets = [render(scene, c, capacity=capacity) for c in cams]
        log(f"[multi] {world} ranks, {scene.num_gaussians} splats "
            f"{cs.WIDTH}x{cs.HEIGHT}, {len(cams)} views, capacity "
            f"{capacity}")
        frames(cs, scene, cams[0], targets[0], smi, log)
        band = steps(cs, start, cams, targets, capacity, smi, log)
        timing(cs, scene, cams[0], band, smi, log)
        torch.distributed.barrier()
    finally:
        torch.distributed.destroy_process_group()


def main() -> int:
    import torch
    import torch.multiprocessing as mp

    world = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if world < 2 or world % 2:
        print(f"multicard_smoke: needs an even count of at least 2 CUDA "
              f"devices, found {world}", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    from splatjax_torch import kernels

    t0 = time.perf_counter()
    kernels.build()
    os.makedirs(os.path.join(HERE, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(HERE, "build"),
                                     prefix="multicard_") as workdir:
        mp.spawn(rank_main, args=(world, os.path.join(workdir, "store")),
                 nprocs=world, join=True)
    print(f"[multi] total {time.perf_counter() - t0:.1f} s", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": world}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
