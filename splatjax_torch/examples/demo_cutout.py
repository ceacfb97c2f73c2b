"""Demo: cutout box culling — the analogue of cutout-demo.html.

The reference shows two instances of one asset, one clipped by an invisible
<a-box> (cutout-demo.html:23-25). Here: render the same scene twice, once
whole and once restricted to a unit box, and composite them side by side.

    python -m splatjax_torch.examples.demo_cutout [scene.splat] \
        [--device cuda]
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time

import numpy as np
import torch


def main(argv=None) -> dict:
    """Returns ``full``, ``clipped`` and ``side`` (the image written to
    ``path``) as float32 numpy, ``kept`` (the clipped frame's share of the
    full frame's covered pixels) and ``ms`` (both renders, their sync and
    readback, host clock)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("src", nargs="?", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from splatjax_torch import make_camera
    from splatjax_torch.device import resolve_device, synchronize
    from splatjax_torch.io import synthetic_scene
    from splatjax_torch.utils import write_png
    from splatjax_torch.viewer import SplatRenderer

    dev = resolve_device(args.device)
    scene = None
    if not args.src:
        scene = synthetic_scene(50_000, seed=3, extent=0.8,
                                scale_range=(0.01, 0.03), device=dev)

    # cutout box: scaled 0.8, offset +x — world->box = inv(box world matrix)
    box_world = np.diag([0.8, 0.8, 0.8, 1.0]).astype(np.float32)
    box_world[:3, 3] = [0.3, 0.0, 0.0]
    cutout = torch.from_numpy(np.linalg.inv(box_world)).to(dev)

    full = SplatRenderer(src=args.src, scene=scene, device=dev)
    clipped = SplatRenderer(src=args.src, scene=scene, cutout=cutout,
                            device=dev)

    cam = make_camera((0, 0.3, 2.6), (0, 0, 0), width=640, height=480,
                      device=dev)
    synchronize(dev)
    t0 = time.perf_counter()
    img_full = full.render(cam).detach().cpu().numpy()
    img_cut = clipped.render(cam).detach().cpu().numpy()
    ms = (time.perf_counter() - t0) * 1e3
    side = np.concatenate([img_full, img_cut], axis=1)
    path = os.path.join(tempfile.gettempdir(), "splatjax_cutout_demo.png")
    write_png(path, side)
    kept = (img_cut[..., 3] > 0).sum() / max((img_full[..., 3] > 0).sum(), 1)
    print(f"cutout kept {kept*100:.1f}% of covered pixels -> {path}")
    return dict(full=img_full, clipped=img_cut, side=side, path=path,
                kept=float(kept), camera=cam, ms=ms)


if __name__ == "__main__":
    main()
