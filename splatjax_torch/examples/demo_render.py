"""Demo: load (or synthesize) a scene and render an orbit of frames.

The analogue of the reference's index.html demo page (index.html:8-14): a
splat scene plus animated viewpoints. Writes .png frames (stdlib-only PNG
writer, :mod:`splatjax_torch.utils.png`) and prints per-frame timings.

    python -m splatjax_torch.examples.demo_render [scene.splat|scene.ply] \
        [--frames 8] [--device cuda]
"""
from __future__ import annotations

import argparse
import math
import os
import tempfile
import time


def main(argv=None) -> dict:
    """Returns ``frames`` (H, W, 4 float32 numpy), ``frame_ms`` (render,
    device sync and readback, host clock), ``cameras``, ``paths`` and
    ``gaussians``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("src", nargs="?", default=None)
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--width", type=int, default=960)
    ap.add_argument("--height", type=int, default=540)
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(),
                                                  "splatjax_demo"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from splatjax_torch import make_camera
    from splatjax_torch.device import resolve_device, synchronize
    from splatjax_torch.io import synthetic_scene
    from splatjax_torch.utils import write_png
    from splatjax_torch.viewer import SplatRenderer

    dev = resolve_device(args.device)
    if args.src:
        renderer = SplatRenderer(src=args.src, device=dev)
    else:
        print("no asset given; using a 100k synthetic scene")
        renderer = SplatRenderer(
            scene=synthetic_scene(100_000, seed=0, extent=0.8,
                                  scale_range=(0.005, 0.02), device=dev),
            device=dev,
        )
    n = renderer.scene.num_gaussians
    print(f"scene: {n} gaussians")

    os.makedirs(args.out, exist_ok=True)
    out = dict(frames=[], frame_ms=[], cameras=[], paths=[], gaussians=n)
    for i in range(args.frames):
        a = 2 * math.pi * i / args.frames
        cam = make_camera(
            (3.0 * math.sin(a), 0.4, 3.0 * math.cos(a)), (0, 0, 0),
            width=args.width, height=args.height, device=dev,
        )
        synchronize(dev)
        t0 = time.perf_counter()
        # the readback is part of the frame, as the viewer's blit is
        img = renderer.render(cam).detach().cpu().numpy()
        dt = time.perf_counter() - t0
        path = os.path.join(args.out, f"frame_{i:03d}.png")
        write_png(path, img)
        print(f"frame {i}: {dt*1e3:.1f} ms  alpha_max={img[..., 3].max():.3f}"
              f"  -> {path}")
        out["frames"].append(img)
        out["frame_ms"].append(dt * 1e3)
        out["cameras"].append(cam)
        out["paths"].append(path)
    return out


if __name__ == "__main__":
    main()
