"""Demo: interactive-style orbit redraw loop with a cached tile index.

The reference's RAF loop redraws every frame with the worker's most
recent sort order (index.js:438-455). This is that loop on the card: bins
are built once per ``resort_interval`` frames (``cache_params=True`` also
gathers the per-instance parameters once, so a 16-byte redraw is one K3
launch), and every frame projects and shades fresh at display rate.

    python -m splatjax_torch.examples.demo_orbit [scene.splat] \
        [--frames 24] [--device cuda]

Writes an orbit strip PNG and prints the measured redraw fps.
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time

import numpy as np


def main(argv=None) -> dict:
    """Returns ``frames`` (every frame, float32 numpy), ``strip`` (the
    image written to ``path``), ``frame_ms`` (each frame's render and
    readback, host clock) and ``fps`` (frames 1.. only)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("src", nargs="?", default=None)
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(),
                                                  "splatjax_orbit.png"))
    ap.add_argument("--frames", type=int, default=24)
    ap.add_argument("--resort-interval", type=int, default=8)
    ap.add_argument("--res", default="640x480")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from splatjax_torch import make_camera
    from splatjax_torch.device import resolve_device, synchronize
    from splatjax_torch.io import load_splat, synthetic_scene
    from splatjax_torch.utils import write_png
    from splatjax_torch.viewer import SplatRenderer

    dev = resolve_device(args.device)
    if args.src:
        scene = load_splat(args.src, device=dev)
    else:
        scene = synthetic_scene(20000, seed=9, extent=0.8,
                                scale_range=(0.01, 0.04), device=dev)
    w, h = (int(v) for v in args.res.split("x"))
    r = SplatRenderer(
        scene=scene, resort_interval=args.resort_interval, feature_bytes=16,
        device=dev,
    )

    imgs, frame_ms = [], []
    t0 = None
    for i in range(args.frames):
        ang = 2.0 * np.pi * i / args.frames
        eye = (0.35 * np.sin(ang), 0.1 * np.sin(2 * ang),
               2.5 + 0.2 * np.cos(ang))
        cam = make_camera(eye, (0, 0, 0), width=w, height=h, device=dev)
        synchronize(dev)
        ts = time.perf_counter()
        img = r.render(cam)
        if i == 0:
            # frame 0 pays the caching allocator's first requests and the
            # kernels' first launches (module load); the fps leaves it out
            synchronize(dev)
            t0 = time.perf_counter()
        imgs.append(img.detach().cpu().numpy())
        frame_ms.append((time.perf_counter() - ts) * 1e3)
    dt = time.perf_counter() - t0
    fps = (args.frames - 1) / max(dt, 1e-9)

    # strip of every 4th frame
    strip = np.concatenate(imgs[:: max(args.frames // 6, 1)][:6], axis=1)
    write_png(args.out, strip)
    print(f"wrote {args.out}; {args.frames} frames at {w}x{h}, "
          f"resort_interval={args.resort_interval}: {fps:.1f} fps "
          f"(incl. host loop + readback)")
    return dict(frames=imgs, strip=strip, path=args.out, frame_ms=frame_ms,
                fps=fps)


if __name__ == "__main__":
    main()
