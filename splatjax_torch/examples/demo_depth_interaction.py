"""Demo: opaque geometry intersecting the splat volume (depth interaction).

The reference demo page animates opaque spheres THROUGH the splat cloud
(index.html:9-14) — splats behind a sphere are hidden by the GPU depth test
(depthTest: true, index.js:177-181). This reproduces that behavior on the
port's pipeline: an analytically ray-traced sphere provides the z-buffer
and color layer; render(..., zbuf=...) discards occluded splat fragments
inside the sweep and composite_over lays the sphere under the survivors.

    python -m splatjax_torch.examples.demo_depth_interaction [--frames 6] \
        [--device cuda]
"""
from __future__ import annotations

import argparse
import math
import os
import tempfile
import time

import numpy as np
import torch


def sphere_layer(cam, center, radius, width, height):
    """Analytic sphere rasterization: (H, W) camera-z buffer + RGB layer.

    Rays through pixel centers in the camera frame; depth = camera z of the
    nearest intersection (negative in front), -inf where missed. NumPy on
    the host: the camera is read through ``.cpu()``.
    """
    mv = cam.modelview.cpu().numpy()
    pr = cam.projection.cpu().numpy()
    focal = (height / 2.0) * abs(pr[1, 1])
    c_cam = mv[:3, :3] @ np.asarray(center, np.float32) + mv[:3, 3]

    ys, xs = np.mgrid[0:height, 0:width]
    # y-up screen frame, row 0 top -> flip rows
    px = (xs + 0.5) - width / 2.0
    py = (height - 1 - ys + 0.5) - height / 2.0
    dirs = np.stack([px / focal, py / focal, -np.ones_like(px)], -1)

    b = dirs @ c_cam
    cc = c_cam @ c_cam - radius * radius
    disc = b * b - (dirs * dirs).sum(-1) * cc
    hit = disc > 0
    tnear = (b - np.sqrt(np.maximum(disc, 0.0))) / (dirs * dirs).sum(-1)
    z = np.where(hit & (tnear > 0), -tnear, np.inf)
    zbuf = np.where(np.isfinite(z), z, -np.inf).astype(np.float32)

    # simple lambert shading for the visual layer
    p = dirs * tnear[..., None]
    n = p - c_cam
    n = n / np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-9)
    light = np.clip(n @ np.array([0.4, 0.7, 0.6]) / 1.0, 0.1, 1.0)
    rgb = np.where(hit[..., None], light[..., None] *
                   np.array([0.9, 0.4, 0.3]), 0.0).astype(np.float32)
    return zbuf, rgb, hit


def main(argv=None) -> dict:
    """Returns ``frames`` (float32 numpy), ``paths`` and ``frame_ms``
    (render, composite, sync and readback, host clock)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=6)
    ap.add_argument("--width", type=int, default=480)
    ap.add_argument("--height", type=int, default=270)
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(),
                                                  "splatjax_depth_demo"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from splatjax_torch.camera import make_camera
    from splatjax_torch.device import resolve_device, synchronize
    from splatjax_torch.io import synthetic_scene
    from splatjax_torch.render import composite_over, render
    from splatjax_torch.utils import write_png

    dev = resolve_device(args.device)
    os.makedirs(args.out, exist_ok=True)
    scene = synthetic_scene(20000, seed=3, extent=0.6,
                            scale_range=(0.01, 0.03), device=dev)
    cam = make_camera((0, 0, 2.4), (0, 0, 0),
                      width=args.width, height=args.height, device=dev)

    out = dict(frames=[], paths=[], frame_ms=[])
    for f in range(args.frames):
        ang = 2 * math.pi * f / args.frames
        center = (0.45 * math.cos(ang), 0.15 * math.sin(ang),
                  0.45 * math.sin(ang))
        zbuf, sphere_rgb, hit = sphere_layer(
            cam, center, 0.25, args.width, args.height
        )
        zbuf, sphere_rgb, hit = (torch.from_numpy(a).to(dev)
                                 for a in (zbuf, sphere_rgb, hit))
        synchronize(dev)
        t0 = time.perf_counter()
        img = render(scene, cam, zbuf=zbuf)
        frame = composite_over(img, sphere_rgb, under_mask=hit)
        frame = frame.detach().cpu().numpy()
        out["frame_ms"].append((time.perf_counter() - t0) * 1e3)
        path = os.path.join(args.out, f"frame_{f:02d}.png")
        write_png(path, frame)
        print(f"frame {f}: sphere at {np.round(center, 2)} -> {path}")
        out["frames"].append(frame)
        out["paths"].append(path)
    print("done:", args.out)
    return out


if __name__ == "__main__":
    main()
