"""Demo: WebXR-style stereo eye pair.

The reference renders per-eye inside the browser's XR session with the
framebuffer scaled by xrPixelRatio (default 0.5, index.js:13-15) and one
worker sort order shared by both eyes per frame (index.js:438-455). This
renders a left/right pair with render_stereo and writes them side by side.

    python -m splatjax_torch.examples.demo_stereo [scene.splat] \
        [--shared-bins] [--device cuda]
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time

import numpy as np


def main(argv=None) -> dict:
    """Returns ``left``, ``right`` and ``pair`` (the image written to
    ``path``) as float32 numpy, and ``ms`` (both eyes, their sync and
    readback, host clock)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("src", nargs="?", default=None)
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(),
                                                  "splatjax_stereo.png"))
    ap.add_argument("--ipd", type=float, default=0.06,
                    help="inter-pupillary distance in scene units")
    ap.add_argument("--xr-pixel-ratio", type=float, default=0.5)
    ap.add_argument("--shared-bins", action="store_true",
                    help="reuse the left eye's tile index for the right "
                         "eye (the reference's shared per-frame order)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from splatjax_torch import make_camera
    from splatjax_torch.device import resolve_device, synchronize
    from splatjax_torch.io import load_splat, synthetic_scene
    from splatjax_torch.render import render_stereo
    from splatjax_torch.utils import write_png

    dev = resolve_device(args.device)
    if args.src:
        scene = load_splat(args.src, device=dev)
    else:
        scene = synthetic_scene(5000, seed=3, extent=0.8,
                                scale_range=(0.01, 0.05), device=dev)

    w, h = 640, 480
    half = args.ipd / 2.0
    cl = make_camera((-half, 0, 2.5), (0, 0, 0), width=w, height=h,
                     device=dev)
    cr = make_camera((+half, 0, 2.5), (0, 0, 0), width=w, height=h,
                     device=dev)
    synchronize(dev)
    t0 = time.perf_counter()
    il, ir = render_stereo(
        scene, cl, cr, xr_pixel_ratio=args.xr_pixel_ratio,
        shared_bins=args.shared_bins,
    )
    left, right = il.detach().cpu().numpy(), ir.detach().cpu().numpy()
    ms = (time.perf_counter() - t0) * 1e3
    pair = np.concatenate([left, right], axis=1)
    write_png(args.out, pair)
    print(f"wrote {args.out}  ({pair.shape[1]}x{pair.shape[0]}, "
          f"xr_pixel_ratio={args.xr_pixel_ratio}, "
          f"shared_bins={args.shared_bins}) in {ms:.1f} ms")
    return dict(left=left, right=right, pair=pair, path=args.out, ms=ms)


if __name__ == "__main__":
    main()
