"""Generate a trained-asset fixture (PyTorch port of
``splatjax/tools/make_fixture.py``).

The reference's de-facto integration asset is train.splat — a scene
produced by a real 3DGS optimization (index.html:13). The fixture is made
the same way: fit gaussians from random init against multi-view images of
an analytic 3D scene (checkered sphere over a striped ground plane), with
adaptive density control, then freeze to .ply/.splat.

    python -m splatjax_torch.tools.make_fixture [--steps 1200] \
        [--out build/splatjax_torch/fixture] [--device cuda] [--seed 11]

The default ``--out`` lies under the build directory: the committed
``tests/fixtures`` asset is splatjax's and stays as it is.
"""
from __future__ import annotations

import argparse
import dataclasses
import math
import os
import time

import numpy as np
import torch

from splatjax_torch.kernels import BUILD_DIR

DEFAULT_OUT = str(BUILD_DIR / "fixture")


def _ray_dirs(cam, width, height):
    pr = cam.projection.cpu().numpy()
    focal = (height / 2.0) * abs(pr[1, 1])
    ys, xs = np.mgrid[0:height, 0:width]
    px = (xs + 0.5) - width / 2.0
    py = (height - 1 - ys + 0.5) - height / 2.0
    d = np.stack([px / focal, py / focal, -np.ones_like(px)], -1)
    mv = cam.modelview.cpu().numpy()
    rot = mv[:3, :3]
    origin = -rot.T @ mv[:3, 3]
    dirs = d @ rot  # camera->world (rows of mv[:3,:3] are world axes in cam)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    return origin.astype(np.float32), dirs.astype(np.float32)


def analytic_target(cam, width, height):
    """Ray-traced RGBA of a checkered sphere + striped tilted disc."""
    o, d = _ray_dirs(cam, width, height)
    img = np.zeros((height, width, 4), np.float32)
    tbest = np.full((height, width), np.inf, np.float32)

    # sphere at origin, r=0.35, checker by octants
    b = d @ o
    c = o @ o - 0.35 ** 2
    disc = b * b - c
    hit = disc > 0
    t = -b - np.sqrt(np.maximum(disc, 0))
    ok = hit & (t > 0)
    p = o + d * t[..., None]
    checker = ((p[..., 0] > 0).astype(int) + (p[..., 1] > 0).astype(int)
               + (p[..., 2] > 0).astype(int)) % 2
    n = p / 0.35
    lam = np.clip(n @ np.array([0.5, 0.7, 0.5]) / 1.0, 0.15, 1.0)
    col = np.where(checker[..., None] > 0,
                   np.array([0.9, 0.35, 0.2]), np.array([0.2, 0.5, 0.9]))
    m = ok & (t < tbest)
    img[m, :3] = (col * lam[..., None])[m]
    img[m, 3] = 1.0
    tbest[m] = t[m]

    # tilted disc (plane y = -0.4, |x|,|z| <= 0.6) with stripes
    denom = d[..., 1]
    tp = np.where(np.abs(denom) > 1e-6, (-0.4 - o[1]) / denom, np.inf)
    pp = o + d * tp[..., None]
    on = (tp > 0) & (np.abs(pp[..., 0]) < 0.6) & (np.abs(pp[..., 2]) < 0.6)
    stripes = (np.floor(pp[..., 0] * 6) + np.floor(pp[..., 2] * 6)) % 2
    pcol = np.where(stripes[..., None] > 0,
                    np.array([0.85, 0.8, 0.3]), np.array([0.35, 0.3, 0.45]))
    m = on & (tp < tbest)
    img[m, :3] = pcol[m]
    img[m, 3] = 1.0
    return img


def main(argv=None) -> dict:
    """Fit, freeze and write the fixture. Returns the written paths
    (``ply``, ``splat``), the frozen row count (``rows``), the final PSNR
    on view 0 (``psnr``), the fit's wall time (``wall_s``) and its
    ``history``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=1200)
    ap.add_argument("--res", type=int, default=96)
    ap.add_argument("--views", type=int, default=10)
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=11)
    args = ap.parse_args(argv)

    from splatjax_torch.camera import make_camera
    from splatjax_torch.device import resolve_device, synchronize
    from splatjax_torch.io import save_ply, save_splat
    from splatjax_torch.render import render
    from splatjax_torch.scene import GaussianScene
    from splatjax_torch.train import (
        DensifyConfig,
        FitConfig,
        fit,
        init_random,
        psnr,
    )

    dev = resolve_device(args.device)
    w = h = args.res
    cams, targets = [], []
    for i in range(args.views):
        ang = 2 * math.pi * i / args.views
        el = 0.25 + 0.25 * (i % 3)
        pos = (1.9 * math.cos(ang) * math.cos(el),
               1.9 * math.sin(el),
               1.9 * math.sin(ang) * math.cos(el))
        cam = make_camera(pos, (0, 0, 0), width=w, height=h, device=dev)
        cams.append(cam)
        targets.append(torch.from_numpy(analytic_target(cam, w, h)).to(dev))

    init = init_random(512, torch.Generator().manual_seed(args.seed),
                       extent=0.5, initial_scale=0.06, device=dev)
    cfg = FitConfig(steps=args.steps, log_every=max(args.steps // 6, 1),
                    capacity=1 << 17, lr_means=2e-3)
    synchronize(dev)
    t0 = time.perf_counter()
    params, history = fit(
        init, cams, targets, cfg,
        densify=DensifyConfig(
            start=100, stop=args.steps // 2, every=100,
            grad_threshold=5e-7, split_scale=0.05,
            max_gaussians=6000, prune_opacity=0.01,
        ),
        log_fn=lambda r: print(r),
    )
    synchronize(dev)
    wall = time.perf_counter() - t0
    with torch.no_grad():
        scene = params.to_scene()
        final_psnr = float(psnr(render(scene, cams[0]), targets[0]))
    print(f"fit done: {params.means.shape[0]} rows, psnr={final_psnr:.2f}")

    # drop dead (pruned / ~transparent) slots before freezing
    alive = scene.opacities > 0.01
    scene = GaussianScene(**{
        f.name: None if getattr(scene, f.name) is None
        else getattr(scene, f.name)[alive]
        for f in dataclasses.fields(scene)
    })
    print(f"frozen: {scene.num_gaussians} gaussians")

    os.makedirs(args.out, exist_ok=True)
    ply = os.path.join(args.out, "trained_scene.ply")
    splat = os.path.join(args.out, "trained_scene.splat")
    save_ply(ply, scene)
    save_splat(splat, scene)
    print("wrote", args.out)
    return dict(ply=ply, splat=splat, rows=scene.num_gaussians,
                psnr=final_psnr, wall_s=wall, history=history)


if __name__ == "__main__":
    main()
