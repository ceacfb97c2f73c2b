"""End-to-end differentiable rendering: scene + camera -> (H, W, 4) image
(PyTorch port of ``splatjax/render.py``'s ``render``).

covariances -> EWA projection and culls -> tile binning (expansion
kernel) -> packed-row gather -> forward rasterize kernel -> image. Every
step runs on the scene's device; on a CUDA device the kernels of
:mod:`splatjax_torch.kernels` carry the expansion and the rasterization.

The image is differentiable w.r.t. every scene tensor that requires grad
(and the background): the gather + rasterize step is a
``torch.autograd.Function`` whose backward runs the backward rasterize
kernel and the per-gaussian segment sum (:mod:`.ops.rasterize_vjp`);
torch autograd covers projection and covariances.
"""
from __future__ import annotations

from typing import Optional

import torch

from splatjax_torch.camera import Camera
from splatjax_torch.device import matmul_f32
from splatjax_torch.ops.binning import (
    TileConfig,
    bin_gaussians,
    features_from_projection,
)
from splatjax_torch.ops.projection import project_gaussians
from splatjax_torch.ops.rasterize import (
    tiles_to_depth,
    tiles_to_image,
    zbuffer_to_tiles,
)
from splatjax_torch.ops.rasterize_vjp import (
    rasterize_gathered,
    render_image_gathered,
)
from splatjax_torch.scene import (
    GaussianScene,
    build_covariances,
    cov6_to_mat,
    covariance_upper,
    dequantize_covariances_int16,
    quantize_covariances_int16,
)

# Clamp that keeps 1/(1 - alpha) bounded for the backward; "auto" resolves
# to it except in viewer_exact mode, which keeps the WebGL blend exact.
DEFAULT_ALPHA_CLIP = 0.999


def default_capacity(num_gaussians: int, dup_factor: int = 4) -> int:
    """Static instance-buffer capacity: ~dup_factor x N, 1024-aligned."""
    cap = max(dup_factor * max(num_gaussians, 1), 1024)
    return -(-cap // 1024) * 1024


def resolve_alpha_clip(alpha_clip, viewer_exact: bool) -> Optional[float]:
    if isinstance(alpha_clip, str):
        if alpha_clip != "auto":
            raise ValueError(
                f"alpha_clip must be float, None or 'auto', got {alpha_clip!r}"
            )
        return None if viewer_exact else DEFAULT_ALPHA_CLIP
    return alpha_clip


def resolve_feature_bytes(feature_bytes, viewer_exact: bool) -> int:
    """Resolve the packed instance-row width. "auto" = 32 (full-precision
    rows, inside the 1e-3 viewer-parity budget). 16 selects the
    fixed-point / bf16 / RGBA8 training rows: the training default, and a
    speed knob for redraw, not a parity mode."""
    if isinstance(feature_bytes, str):
        if feature_bytes != "auto":
            raise ValueError("feature_bytes must be 16, 32 or 'auto', got "
                             f"{feature_bytes!r}")
        return 32
    fb = int(feature_bytes)
    if fb not in (16, 32):
        raise ValueError(f"feature_bytes must be 16, 32 or 'auto', got {fb}")
    if fb == 16 and viewer_exact:
        raise ValueError(
            "feature_bytes=16 is not a parity mode; use 32 with viewer_exact"
        )
    return fb


def _render_impl(scene: GaussianScene, modelview, projection, width, height,
                 *, capacity, alpha_clip, early_stop, viewer_exact, cutout,
                 background, zbuf, return_depth, packed16):
    dev = scene.device
    cov3d = build_covariances(scene.quats, scene.scales)
    if viewer_exact:
        q, qs = quantize_covariances_int16(covariance_upper(cov3d))
        cov3d = cov6_to_mat(dequantize_covariances_int16(q, qs))
    proj = project_gaussians(
        scene.means, cov3d, scene.colors, scene.opacities,
        modelview, projection, width, height,
        max_scales=scene.scales.amax(dim=-1),
        cutout=cutout,
        sh=scene.sh,
        support_eps=None if viewer_exact else early_stop,
    )
    cfg = TileConfig(width, height)
    with torch.no_grad():
        b = bin_gaussians(proj, cfg, capacity)
    feat_n = features_from_projection(proj)
    zbuf_tiles = None if zbuf is None else zbuffer_to_tiles(
        zbuf.to(dev), cfg)
    bg = None if background is None else background.to(dev, torch.float32)
    res = (b.gauss_id, b.starts, b.ends, b.cum, b.count, b.perm, b.cum_d,
           b.count_d, b.overflow)
    if not return_depth:
        # image-level backward: K4 takes the image cotangent directly
        img = render_image_gathered(feat_n, *res, bg, zbuf_tiles, cfg,
                                    alpha_clip, early_stop, packed16)
        return img, None, b.overflow
    out_tiles, _ = rasterize_gathered(feat_n, *res, zbuf_tiles, cfg,
                                      alpha_clip, early_stop, packed16)
    img = tiles_to_image(out_tiles, cfg, bg)
    return img, tiles_to_depth(out_tiles, cfg), b.overflow


def _as_tensor(x, dev) -> Optional[torch.Tensor]:
    if x is None:
        return None
    return torch.as_tensor(x, dtype=torch.float32, device=dev)


def render(
    scene: GaussianScene,
    camera: Camera,
    *,
    capacity: Optional[int] = None,
    alpha_clip="auto",
    early_stop: float = 1e-4,
    viewer_exact: bool = False,
    cutout=None,
    background=None,
    zbuf=None,
    model=None,
    return_overflow: bool = False,
    return_depth: bool = False,
    feature_bytes="auto",
):
    """Render a scene with the tiled pipeline on the scene's device.

    Args (as ``splatjax.render.render``; tiles are always 16x16):
      capacity: static instance-buffer size (None -> 4x N). Instances past
        it are dropped, depth-farthest first; ``return_overflow=True``
        returns their count as a 0-d int32 tensor.
      alpha_clip: "auto" (0.999, or None under viewer_exact), a float, or
        None for no clamp.
      early_stop: stop a tile once every transmittance is below it
        (0.0 = exact blend).
      viewer_exact: the viewer's int16 covariance quantization.
      cutout: optional (4, 4) world -> unit-box cull matrix.
      background: optional (3,) RGB composited under the splats.
      zbuf: optional (H, W) camera-z buffer (row 0 top, -inf = empty).
      model: optional (4, 4) object -> world transform.
      return_depth: also return the (H, W) alpha-weighted camera z.
      feature_bytes: "auto" (32), 32, or 16 for the training rows.
    Returns the image, then depth and overflow when asked for. The image
    (and depth) are differentiable w.r.t. the scene's tensors and the
    background.
    """
    fb = resolve_feature_bytes(feature_bytes, viewer_exact)
    dev = scene.device
    if capacity is None:
        capacity = default_capacity(scene.num_gaussians)
    if scene.num_gaussians == 0:
        out = (torch.zeros((camera.height, camera.width, 4),
                           dtype=torch.float32, device=dev),)
        if return_depth:
            out += (torch.zeros((camera.height, camera.width),
                                dtype=torch.float32, device=dev),)
        if return_overflow:
            out += (torch.zeros((), dtype=torch.int32, device=dev),)
        return out[0] if len(out) == 1 else out
    modelview = camera.modelview.to(dev, torch.float32)
    if model is not None:
        modelview = matmul_f32(modelview, _as_tensor(model, dev))
    img, depth, overflow = _render_impl(
        scene, modelview, camera.projection.to(dev, torch.float32),
        camera.width, camera.height,
        capacity=capacity,
        alpha_clip=resolve_alpha_clip(alpha_clip, viewer_exact),
        early_stop=early_stop,
        viewer_exact=viewer_exact,
        cutout=_as_tensor(cutout, dev),
        background=_as_tensor(background, dev),
        zbuf=_as_tensor(zbuf, dev),
        return_depth=return_depth,
        packed16=fb == 16,
    )
    out = (img,)
    if return_depth:
        out += (depth,)
    if return_overflow:
        out += (overflow,)
    return out[0] if len(out) == 1 else out
