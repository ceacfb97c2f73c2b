"""Scene-graph composition: many opaque layers and many splat entities in
one depth-correct frame (PyTorch port of ``splatjax/compose.py``).

1. every opaque layer carries an (H, W) camera-z buffer (negative in front,
   -inf where the layer is empty) and an (H, W, 3) color; the layers merge
   per pixel like a depth buffer (nearest wins);
2. every splat entity projects with its own model and cutout, and all of
   them bin and sort together (:func:`render_instances`);
3. the merged z-buffer culls splat fragments behind the nearest opaque
   surface inside the rasterizer, and the merged opaque color is laid
   under the surviving splats.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch

from splatjax_torch.camera import Camera
from splatjax_torch.render import composite_over, render_instances


class OpaqueLayer(NamedTuple):
    """One opaque element already rasterized to the camera: ``rgb``
    (H, W, 3) and ``z`` (H, W) camera-space depth (negative in front,
    -inf where the layer has no coverage). Tensors or arrays."""

    rgb: object
    z: object


def merge_opaque_layers(layers: Sequence[OpaqueLayer]):
    """Per-pixel nearest-wins z-merge of opaque layers (the depth-buffer
    resolve). Returns (rgb (H, W, 3), z (H, W), mask (H, W) bool).
    Requires at least one layer."""
    if not layers:
        raise ValueError("merge_opaque_layers requires at least one layer")
    rgb, z = _f32(layers[0].rgb), _f32(layers[0].z)
    for layer in layers[1:]:
        lz = _f32(layer.z)
        nearer = lz > z  # camera z is negative in front: nearer is larger
        z = torch.where(nearer, lz, z)
        rgb = torch.where(nearer[..., None], _f32(layer.rgb), rgb)
    return rgb, z, torch.isfinite(z)


def _f32(x, device=None) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def compose_scene(
    splat_instances,
    opaque_layers: Sequence[OpaqueLayer],
    camera: Camera,
    *,
    background=None,
    tile_size: int = 16,
    capacity: Optional[int] = None,
    alpha_clip="auto",
    early_stop: float = 1e-4,
    feature_bytes="auto",
) -> torch.Tensor:
    """Depth-correct (H, W, 4) frame of many splat entities and many opaque
    layers: splats blended front to back across all entities, culled
    against the merged opaque depth, over the merged opaque color, over the
    optional (3,) background.

    splat_instances: as :func:`splatjax_torch.render.render_instances`;
    tile_size as :func:`splatjax_torch.render.render`.
    Differentiable w.r.t. the splat parameters (the z-cull is a mask)."""
    dev = splat_instances[0][0].device
    zbuf = None
    if opaque_layers:
        mesh_rgb, zbuf, mesh_mask = merge_opaque_layers([
            OpaqueLayer(_f32(layer.rgb, dev), _f32(layer.z, dev))
            for layer in opaque_layers])
    img = render_instances(
        splat_instances, camera, tile_size=tile_size, capacity=capacity,
        alpha_clip=alpha_clip, early_stop=early_stop, zbuf=zbuf,
        feature_bytes=feature_bytes,
    )
    if opaque_layers:
        # lay the opaque resolve under the splats only where it covers
        under = torch.where(mesh_mask[..., None], mesh_rgb,
                            torch.zeros_like(mesh_rgb))
        img = composite_over(img, under, under_mask=mesh_mask)
    if background is not None:
        bg = _f32(background, dev)
        rgb = img[..., :3] + (1.0 - img[..., 3:4]) * bg
        img = torch.cat([rgb, img[..., 3:4]], dim=-1)
    return img
