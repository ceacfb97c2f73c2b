"""Demo: fit a Gaussian scene from scratch against rendered target views.

The capability the reference viewer lacks entirely (it only displays
pre-trained assets): differentiable optimization of means / scales /
rotations / opacities / colors with Adam, optional 3DGS adaptive density
control, and export of the result as a .splat that loads in the upstream
viewer.

    python -m splatjax_torch.examples.demo_train [--steps 600] [--n 400] \
        [--densify] [--device cuda]

Targets are renders of a synthetic ground-truth scene from a ring of
cameras (a self-contained stand-in for a photo dataset); the fit starts
from random gaussians and reports PSNR against a held-out view.
"""
from __future__ import annotations

import argparse
import math
import os
import tempfile
import time

import torch


def main(argv=None) -> dict:
    """Returns ``history`` (fit's records), ``held`` and ``held_target``
    (float32 numpy), ``held_psnr_start`` and ``held_psnr`` (dB, before and
    after the fit), ``wall_s`` and the exported ``path``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=600)
    ap.add_argument("--n", type=int, default=400, help="fit capacity")
    ap.add_argument("--views", type=int, default=10)
    ap.add_argument("--res", default="128x96")
    ap.add_argument("--densify", action="store_true")
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(),
                                                  "splatjax_fit.splat"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    w, h = (int(v) for v in args.res.split("x"))

    from splatjax_torch import make_camera
    from splatjax_torch.device import resolve_device, synchronize
    from splatjax_torch.io import synthetic_scene
    from splatjax_torch.render import render
    from splatjax_torch.train import (
        DensifyConfig,
        FitConfig,
        export_splat,
        fit,
        init_random,
        psnr,
    )

    dev = resolve_device(args.device)
    gt = synthetic_scene(120, seed=3, extent=0.55, scale_range=(0.04, 0.1),
                         device=dev)
    cams, targets = [], []
    with torch.no_grad():
        for i in range(args.views):
            a = 2 * math.pi * i / args.views
            cam = make_camera(
                (2.3 * math.sin(a), 0.35 * math.cos(2 * a),
                 2.3 * math.cos(a)),
                (0, 0, 0), width=w, height=h, device=dev,
            )
            cams.append(cam)
            targets.append(render(gt, cam, early_stop=0.0))
        held_cam = make_camera((0.9, 0.8, 2.0), (0, 0, 0), width=w,
                               height=h, device=dev)
        held_tgt = render(gt, held_cam, early_stop=0.0)

    params = init_random(args.n, torch.Generator().manual_seed(0),
                         extent=0.6, device=dev)
    with torch.no_grad():
        start = float(psnr(render(params.to_scene(), held_cam,
                                  early_stop=0.0), held_tgt))
    print(f"held-out view PSNR at the start: {start:.2f} dB")
    densify = DensifyConfig() if args.densify else None
    synchronize(dev)
    t0 = time.perf_counter()
    params, history = fit(
        params, cams, targets,
        FitConfig(steps=args.steps, log_every=max(args.steps // 10, 1)),
        densify=densify,
        log_fn=lambda m: print(
            f"step {m['step']:5d}  loss {m['loss']:.4f}  "
            f"psnr {m['psnr']:.2f} dB" if "loss" in m
            else f"step {m['step']:5d}  densify: {m['densify']}"
        ),
    )
    synchronize(dev)
    dt = time.perf_counter() - t0

    with torch.no_grad():
        held = render(params.to_scene(), held_cam, early_stop=0.0)
        held_psnr = float(psnr(held, held_tgt))
    print(f"\ntrained {args.steps} steps in {dt:.1f}s "
          f"({args.steps / dt:.1f} steps/s)")
    print(f"held-out view PSNR: {held_psnr:.2f} dB")

    export_splat(args.out, params)
    print(f"exported {args.out} — loads in the upstream WebGL viewer")
    return dict(history=history, held=held.cpu().numpy(),
                held_target=held_tgt.cpu().numpy(),
                held_psnr_start=start, held_psnr=held_psnr, wall_s=dt,
                path=args.out)


if __name__ == "__main__":
    main()
