"""Synthetic and tiled scenes for tests and the chip smoke run (port of
``splatjax/io/synthetic.py``, drawing the same numbers from the same
``np.random.default_rng`` seeds)."""
from __future__ import annotations

import numpy as np
import torch

from splatjax_torch.scene import GaussianScene, scene_from_numpy


def synthetic_arrays(
    n: int,
    seed: int = 0,
    *,
    extent: float = 1.0,
    scale_range: tuple[float, float] = (0.01, 0.08),
    opacity_range: tuple[float, float] = (0.3, 1.0),
) -> dict[str, np.ndarray]:
    """Random Gaussians in a cube of half-width ``extent``, as numpy."""
    rng = np.random.default_rng(seed)
    means = rng.uniform(-extent, extent, size=(n, 3)).astype(np.float32)
    scales = rng.uniform(*scale_range, size=(n, 3)).astype(np.float32)
    q = rng.normal(size=(n, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    colors = rng.uniform(0.0, 1.0, size=(n, 3)).astype(np.float32)
    opac = rng.uniform(*opacity_range, size=(n,)).astype(np.float32)
    return dict(means=means, scales=scales, quats=q, colors=colors,
                opacities=opac)


def synthetic_scene(n: int, seed: int = 0, *, extent: float = 1.0,
                    scale_range: tuple[float, float] = (0.01, 0.08),
                    opacity_range: tuple[float, float] = (0.3, 1.0),
                    device="cuda") -> GaussianScene:
    """Random Gaussians on ``device`` (same draws as splatjax's)."""
    return scene_from_numpy(
        synthetic_arrays(n, seed, extent=extent, scale_range=scale_range,
                         opacity_range=opacity_range),
        device,
    )


def synthetic_splat_bytes(n: int, seed: int = 0) -> bytes:
    """Raw .splat bytes of a random scene (splatjax's bytes for the same
    ``(n, seed)``)."""
    from splatjax_torch.io.splat_format import scene_to_splat_bytes

    return scene_to_splat_bytes(synthetic_scene(n, seed, device="cpu"))


def tile_scene(base: GaussianScene, n: int, *, scale: float = 0.25,
               jitter: float = 0.9, seed: int = 11) -> GaussianScene:
    """Tile a small scene into an n-splat one on the base scene's device:
    each repeat is shrunk by ``scale`` and shifted by a uniform offset in
    [-jitter, jitter]^3 (the offsets splatjax draws from the same seed)."""
    reps = -(-n // base.num_gaussians)
    rng = np.random.default_rng(seed)
    offs = torch.from_numpy(
        rng.uniform(-jitter, jitter, (reps, 3)).astype(np.float32)
    ).to(base.device)
    means = (base.means[None] * scale + offs[:, None, :]).reshape(-1, 3)
    return GaussianScene(
        means=means[:n].contiguous(),
        scales=(base.scales * scale).repeat(reps, 1)[:n].contiguous(),
        quats=base.quats.repeat(reps, 1)[:n].contiguous(),
        colors=base.colors.repeat(reps, 1)[:n].contiguous(),
        opacities=base.opacities.repeat(reps)[:n].contiguous(),
    )
