"""Fit-from-scratch quality evidence (BASELINE.json config 4).

Reconstructs the in-repo trained fixture (``tests/fixtures/
trained_scene.splat``) from random initialization with adaptive density
control, against rendered target views — the run that shows the training
loop can build a scene, not just descend:

    python -m splatjax_torch.examples.fit_trained_fixture    # full run
    python -m splatjax_torch.examples.fit_trained_fixture \
        --steps 400 --res 128x128 --device cuda

Writes ``fit_trained_fixture.json`` (history + final train/held-out PSNR)
and side-by-side PNG comparisons (``fit_fixture_{target,recon}_*.png``)
into ``--out-dir`` (default ``build/splatjax_torch/artifacts``; splatjax's
committed ``examples/artifacts`` stay as they are). The bar is >= 25 dB on
the held-out views at 256x256 (min of the two).
"""
from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import time
from pathlib import Path

import numpy as np
import torch

from splatjax_torch.kernels import BUILD_DIR

FIXTURE = str(Path(__file__).resolve().parents[2] / "tests" / "fixtures"
              / "trained_scene.splat")
DEFAULT_OUT_DIR = str(BUILD_DIR / "artifacts")


def ring_camera(i, n, radius, height_amp, w, h, device="cuda"):
    from splatjax_torch import make_camera

    a = 2 * math.pi * i / n
    return make_camera(
        (radius * math.sin(a), height_amp * math.cos(2 * a),
         radius * math.cos(a)),
        (0, 0, 0), width=w, height=h, device=device,
    )


def device_name(dev: torch.device) -> str:
    """The card's name and the power limit nvidia-smi reports for the
    first card, or "cpu"."""
    if dev.type != "cuda":
        return "cpu"
    limit = subprocess.run(
        ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.splitlines()[0].strip()
    return f"{torch.cuda.get_device_name(dev)}, {limit}"


def main(argv=None) -> dict:
    """Returns the JSON record written to ``path``, plus ``params`` (the
    fitted ``TrainableGaussians``), ``held_cameras``, ``held_images`` and
    ``held_targets`` (float32 numpy), ``train_psnrs``, ``wall_s`` (unrounded) and
    ``png_paths``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=3000)
    ap.add_argument("--views", type=int, default=12)
    ap.add_argument("--res", default="256x256")
    ap.add_argument("--init-n", type=int, default=4096)
    ap.add_argument("--out-dir", default=DEFAULT_OUT_DIR)
    ap.add_argument("--save-pngs", type=int, default=2,
                    help="held-out comparison PNG count")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    w, h = (int(v) for v in args.res.split("x"))

    from splatjax_torch import make_camera
    from splatjax_torch.device import resolve_device, synchronize
    from splatjax_torch.io import load_splat
    from splatjax_torch.render import render
    from splatjax_torch.train import (
        DensifyConfig,
        FitConfig,
        fit,
        init_random,
        psnr,
    )
    from splatjax_torch.utils import write_png

    dev = resolve_device(args.device)
    gt = load_splat(FIXTURE, device=dev)
    print(f"target: trained fixture, {gt.num_gaussians} gaussians")
    extent = float(np.percentile(np.abs(gt.means.cpu().numpy()), 97))

    cams, targets = [], []
    with torch.no_grad():
        for i in range(args.views):
            cam = ring_camera(i, args.views, 2.6, 0.5, w, h, device=dev)
            cams.append(cam)
            targets.append(render(gt, cam, early_stop=0.0))
        held_cams = [
            make_camera((1.3, 0.9, 2.2), (0, 0, 0), width=w, height=h,
                        device=dev),
            make_camera((-1.6, -0.4, 1.9), (0, 0, 0), width=w, height=h,
                        device=dev),
        ]
        held_tgts = [render(gt, c, early_stop=0.0) for c in held_cams]

    params = init_random(args.init_n, torch.Generator().manual_seed(0),
                         extent=extent, initial_scale=0.05 * extent,
                         device=dev)
    densify = DensifyConfig(
        start=200, stop=int(args.steps * 0.7), every=150,
        grad_threshold=1.5e-4, split_scale=0.03 * extent,
        prune_opacity=0.01, max_gaussians=1 << 16,
    )
    cfg = FitConfig(
        steps=args.steps,
        lr_means=1.6e-4 * extent,
        log_every=max(args.steps // 20, 1),
    )
    history = []
    synchronize(dev)
    t0 = time.perf_counter()
    params, _ = fit(
        params, cams, targets, cfg, densify=densify,
        log_fn=lambda m: (
            history.append(m),
            print(f"step {m['step']:5d}  loss {m['loss']:.4f}  "
                  f"psnr {m['psnr']:.2f} dB" if "loss" in m
                  else f"step {m['step']:5d}  densify: {m['densify']}"),
        ),
    )
    synchronize(dev)
    dt = time.perf_counter() - t0

    with torch.no_grad():
        scene = params.to_scene()
        train_psnrs = [
            float(psnr(render(scene, c, early_stop=0.0), t))
            for c, t in zip(cams, targets)
        ]
        held_imgs = [render(scene, c, early_stop=0.0) for c in held_cams]
        held_psnrs = [float(psnr(i, t))
                      for i, t in zip(held_imgs, held_tgts)]
        alive = int((torch.sigmoid(params.logit_opacities) > 0.01).sum())
    held_imgs = [i.cpu().numpy() for i in held_imgs]
    held_tgts = [t.cpu().numpy() for t in held_tgts]

    print(f"\ntrained {args.steps} steps in {dt:.1f}s; "
          f"{alive} live gaussians")
    print(f"train-view PSNR: mean {np.mean(train_psnrs):.2f} dB "
          f"(min {min(train_psnrs):.2f})")
    for i, p in enumerate(held_psnrs):
        print(f"held-out view {i} PSNR: {p:.2f} dB")

    os.makedirs(args.out_dir, exist_ok=True)
    rec = {
        "metric": "fit-from-scratch PSNR on trained fixture (held-out)",
        "value": round(min(held_psnrs), 2),
        "unit": "dB",
        "resolution": args.res,
        "steps": args.steps,
        "views": args.views,
        "init_gaussians": args.init_n,
        "final_live_gaussians": alive,
        "train_psnr_mean": round(float(np.mean(train_psnrs)), 2),
        "held_out_psnr": [round(p, 2) for p in held_psnrs],
        "wall_s": round(dt, 1),
        "device": device_name(dev),
        "history": [
            {k: (round(v, 4) if isinstance(v, float) else v)
             for k, v in m.items()} for m in history if "loss" in m
        ],
    }
    path = os.path.join(args.out_dir, "fit_trained_fixture.json")
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    print(f"wrote {path}")

    png_paths = []
    for i in range(min(args.save_pngs, len(held_cams))):
        tp = os.path.join(args.out_dir, f"fit_fixture_target_{i}.png")
        rp = os.path.join(args.out_dir, f"fit_fixture_recon_{i}.png")
        write_png(tp, held_tgts[i][..., :3])
        write_png(rp, held_imgs[i][..., :3])
        png_paths.append((tp, rp))
        print(f"wrote {tp} / {rp}")
    return dict(rec, path=path, params=params, held_cameras=held_cams,
                held_images=held_imgs, held_targets=held_tgts, held_psnrs=held_psnrs,
                train_psnrs=train_psnrs, wall_s=dt, png_paths=png_paths)


if __name__ == "__main__":
    main()
