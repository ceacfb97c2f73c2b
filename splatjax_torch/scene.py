"""Gaussian scene container and covariance math (PyTorch port of
``splatjax/scene.py``).

World space is the reference viewer's internal space: the loaders in
:mod:`splatjax_torch.io` negate Z and conjugate the quaternions so that the
standard 3DGS covariance ``Sigma = R(q) diag(s^2) R(q)^T`` holds downstream.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Optional

import numpy as np
import torch

from splatjax_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class GaussianScene:
    """A set of 3D Gaussians in framework world space (activated values).

    Attributes:
      means:      (N, 3) float32 positions.
      scales:     (N, 3) float32 linear per-axis standard deviations.
      quats:      (N, 4) float32 rotations, (w, x, y, z); may be slightly
                  un-normalized after u8 quantization, as in the viewer.
      colors:     (N, 3) float32 DC colors in [0, 1].
      opacities:  (N,) float32 opacity in [0, 1].
      sh:         optional (N, K, 3) SH coefficients of bands >= 1.
    """

    means: torch.Tensor
    scales: torch.Tensor
    quats: torch.Tensor
    colors: torch.Tensor
    opacities: torch.Tensor
    sh: Optional[torch.Tensor] = None

    @property
    def num_gaussians(self) -> int:
        return self.means.shape[0]

    @property
    def device(self) -> torch.device:
        return self.means.device

    def normalized(self) -> "GaussianScene":
        """A copy with unit quaternions (the training path)."""
        q = self.quats / torch.linalg.norm(self.quats, dim=-1, keepdim=True)
        return dataclasses.replace(self, quats=q)


_FIELDS = ("means", "scales", "quats", "colors", "opacities", "sh")


def scene_from_numpy(d: Mapping[str, Optional[np.ndarray]], device="cuda"
                     ) -> GaussianScene:
    """Build a scene from numpy parameters keyed like splatjax's
    ``GaussianScene`` fields (``means, scales, quats, colors, opacities``
    and optional ``sh``). All become contiguous float32 tensors on
    ``device``."""
    dev = resolve_device(device)

    def conv(a):
        if a is None:
            return None
        return torch.from_numpy(np.array(a, dtype=np.float32)).to(dev)

    return GaussianScene(**{k: conv(d.get(k)) for k in _FIELDS})


class TrainableGaussians(torch.nn.Module):
    """Raw optimization parameters (port of splatjax's
    ``TrainableGaussians``), each an ``nn.Parameter``; activations follow
    the 3DGS convention: exp on scales, sigmoid on opacity and color,
    normalized quaternions."""

    LEAVES = ("means", "log_scales", "quats", "logit_opacities", "colors",
              "sh")

    def __init__(self, means, log_scales, quats, logit_opacities, colors,
                 sh=None):
        super().__init__()
        self.means = torch.nn.Parameter(means)              # (N, 3)
        self.log_scales = torch.nn.Parameter(log_scales)    # (N, 3)
        self.quats = torch.nn.Parameter(quats)              # (N, 4) w,x,y,z
        self.logit_opacities = torch.nn.Parameter(logit_opacities)  # (N,)
        self.colors = torch.nn.Parameter(colors)            # (N, 3) raw
        self.sh = None if sh is None else torch.nn.Parameter(sh)

    @property
    def num_gaussians(self) -> int:
        return self.means.shape[0]

    def to_scene(self) -> GaussianScene:
        q = self.quats / (
            torch.linalg.norm(self.quats, dim=-1, keepdim=True) + 1e-12)
        return GaussianScene(
            means=self.means,
            scales=torch.exp(self.log_scales),
            quats=q,
            colors=torch.sigmoid(self.colors),
            opacities=torch.sigmoid(self.logit_opacities),
            sh=self.sh,
        )

    @staticmethod
    def from_scene(scene: GaussianScene) -> "TrainableGaussians":
        eps = 1e-6
        col = scene.colors.clamp(eps, 1.0 - eps)
        opa = scene.opacities.clamp(eps, 1.0 - eps)
        return TrainableGaussians(
            means=scene.means.detach().clone(),
            log_scales=torch.log(scene.scales.clamp_min(1e-12)).detach(),
            quats=scene.quats.detach().clone(),
            logit_opacities=(torch.log(opa) - torch.log1p(-opa)).detach(),
            colors=(torch.log(col) - torch.log1p(-col)).detach(),
            sh=None if scene.sh is None else scene.sh.detach().clone(),
        )


def trainable_from_numpy(d: Mapping[str, Optional[np.ndarray]],
                         device="cuda") -> TrainableGaussians:
    """Build :class:`TrainableGaussians` from numpy leaves keyed like
    splatjax's (``means, log_scales, quats, logit_opacities, colors`` and
    optional ``sh``), as contiguous float32 parameters on ``device``."""
    dev = resolve_device(device)
    return TrainableGaussians(**{
        k: None if d.get(k) is None else torch.from_numpy(
            np.array(d[k], dtype=np.float32)).to(dev)
        for k in TrainableGaussians.LEAVES
    })


def quat_to_rotmat(quats: torch.Tensor) -> torch.Tensor:
    """Quaternion (w, x, y, z) -> 3x3 rotation matrix, batched, with the
    bilinear formula of THREE.Matrix4.makeRotationFromQuaternion (so that
    R(q)^T == R(conj q) also for un-normalized q)."""
    w, x, y, z = quats[..., 0], quats[..., 1], quats[..., 2], quats[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    r = torch.stack(
        [
            1.0 - 2.0 * (yy + zz), 2.0 * (xy - wz), 2.0 * (xz + wy),
            2.0 * (xy + wz), 1.0 - 2.0 * (xx + zz), 2.0 * (yz - wx),
            2.0 * (xz - wy), 2.0 * (yz + wx), 1.0 - 2.0 * (xx + yy),
        ],
        dim=-1,
    )
    return r.reshape(quats.shape[:-1] + (3, 3))


def build_covariances(quats: torch.Tensor, scales: torch.Tensor
                      ) -> torch.Tensor:
    """3D covariances Sigma = R diag(s^2) R^T, (N, 3, 3), elementwise in
    f32 (no matmul, so no TF32 path on the card)."""
    m = quat_to_rotmat(quats) * scales[..., None, :]
    return (m[..., :, None, :] * m[..., None, :, :]).sum(dim=-1)


def covariance_upper(covs: torch.Tensor) -> torch.Tensor:
    """(N, 3, 3) -> (N, 6) upper triangle (s11, s12, s13, s22, s23, s33)."""
    return torch.stack(
        [
            covs[..., 0, 0], covs[..., 0, 1], covs[..., 0, 2],
            covs[..., 1, 1], covs[..., 1, 2], covs[..., 2, 2],
        ],
        dim=-1,
    )


def quantize_covariances_int16(cov6: torch.Tensor
                               ) -> tuple[torch.Tensor, torch.Tensor]:
    """The viewer's int16 covariance quantization: q = trunc(c * 32767 /
    max|c|) and dequant scale max|c| / 32767. Returns (q, scale)."""
    max_val = cov6.abs().amax(dim=-1, keepdim=True)
    safe = torch.where(max_val > 0, max_val, torch.ones_like(max_val))
    q = torch.trunc(cov6 * 32767.0 / safe).to(torch.int16)
    return q, max_val[..., 0] / 32767.0


def dequantize_covariances_int16(q: torch.Tensor, scale: torch.Tensor
                                 ) -> torch.Tensor:
    """Inverse of :func:`quantize_covariances_int16`."""
    return q.to(torch.float32) * scale[..., None]


def cov6_to_mat(cov6: torch.Tensor) -> torch.Tensor:
    """(N, 6) upper triangle -> (N, 3, 3) symmetric matrices."""
    s11, s12, s13, s22, s23, s33 = cov6.unbind(-1)
    row0 = torch.stack([s11, s12, s13], dim=-1)
    row1 = torch.stack([s12, s22, s23], dim=-1)
    row2 = torch.stack([s13, s23, s33], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2)


def importance(scene: GaussianScene) -> torch.Tensor:
    """Per-gaussian importance = volume x opacity (scales.prod() times
    opacity), the metric the reference viewer sorts by before truncating
    an asset at its texture capacity."""
    s = scene.scales.to(torch.float32)
    return s[:, 0] * s[:, 1] * s[:, 2] * scene.opacities.to(torch.float32)


def select_important(scene: GaussianScene, fraction: float
                     ) -> GaussianScene:
    """Level-of-detail subset: the top ``fraction`` of gaussians by
    :func:`importance`, importance-descending (a stable sort, so ties keep
    their order, as splatjax's ``argsort``)."""
    if not (0.0 < fraction <= 1.0):
        raise ValueError(f"fraction must be in (0, 1], got {fraction}")
    k = max(int(round(scene.num_gaussians * fraction)), 1)
    order = torch.argsort(-importance(scene), stable=True)[:k]
    return GaussianScene(**{
        f: None if getattr(scene, f) is None else getattr(scene, f)[order]
        for f in _FIELDS
    })
