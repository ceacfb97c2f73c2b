"""Cameras: modelview/projection pairs (PyTorch port of
``splatjax/camera.py``).

Pixel convention: pixel (row i, col j) has its center at
``px = (ndc_x + 1) W / 2`` and ``row = (1 - ndc_y) H / 2``; the focal length
is ``(H / 2) |P[1][1]|``, as the reference viewer derives it per frame.

Constructors: :func:`make_camera` (clean GL matrices from
:func:`perspective` and :func:`look_at`) and :meth:`Camera.from_three`
(THREE.js-style matrices with the reference viewer's Y flips).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from splatjax_torch.device import resolve_device

_FLIP_Y = np.diag(np.array([1.0, -1.0, 1.0, 1.0], dtype=np.float32))


@dataclasses.dataclass(frozen=True)
class Camera:
    """A render camera: float32 (4, 4) matrices plus the viewport size."""

    modelview: torch.Tensor   # (4, 4) world -> camera
    projection: torch.Tensor  # (4, 4) camera -> clip
    width: int
    height: int

    @property
    def focal(self) -> torch.Tensor:
        return (self.height / 2.0) * self.projection[1, 1].abs()

    @staticmethod
    def from_three(camera_world: np.ndarray, projection: np.ndarray,
                   object_world: np.ndarray | None = None, *, width: int,
                   height: int, device="cuda") -> "Camera":
        """Build from THREE.js-style matrices with the reference viewer's
        flips: projection column 1 negated, and with F = diag(1, -1, 1, 1)
        the modelview ``F @ camera_world^-1 @ object_world @ F``, in float64
        on the host, then float32 on ``device``."""
        dev = resolve_device(device)
        if object_world is None:
            object_world = np.eye(4, dtype=np.float32)
        proj = np.asarray(projection, dtype=np.float64).copy()
        proj[:, 1] *= -1.0
        cw = np.asarray(camera_world, dtype=np.float64)
        ow = np.asarray(object_world, dtype=np.float64)
        mv = _FLIP_Y @ np.linalg.inv(cw) @ ow @ _FLIP_Y
        return Camera(
            modelview=torch.from_numpy(mv.astype(np.float32)).to(dev),
            projection=torch.from_numpy(proj.astype(np.float32)).to(dev),
            width=width,
            height=height,
        )


def perspective(fov_y_deg: float, aspect: float, near: float = 0.1,
                far: float = 1000.0) -> np.ndarray:
    """Symmetric GL perspective matrix (THREE.PerspectiveCamera)."""
    f = 1.0 / np.tan(np.deg2rad(fov_y_deg) / 2.0)
    p = np.zeros((4, 4), dtype=np.float32)
    p[0, 0] = f / aspect
    p[1, 1] = f
    p[2, 2] = -(far + near) / (far - near)
    p[2, 3] = -2.0 * far * near / (far - near)
    p[3, 2] = -1.0
    return p


def look_at(eye, target, up=(0.0, 1.0, 0.0)) -> np.ndarray:
    """GL-style view matrix (world -> camera, camera looks down -Z)."""
    eye = np.asarray(eye, dtype=np.float64)
    target = np.asarray(target, dtype=np.float64)
    up = np.asarray(up, dtype=np.float64)
    fwd = target - eye
    fwd = fwd / np.linalg.norm(fwd)
    right = np.cross(fwd, up)
    right = right / np.linalg.norm(right)
    true_up = np.cross(right, fwd)
    view = np.eye(4, dtype=np.float64)
    view[0, :3] = right
    view[1, :3] = true_up
    view[2, :3] = -fwd
    view[:3, 3] = -view[:3, :3] @ eye
    return view.astype(np.float32)


def make_camera(eye, target, *, width: int, height: int,
                fov_y_deg: float = 60.0, up=(0.0, 1.0, 0.0),
                near: float = 0.1, far: float = 1000.0,
                device="cuda") -> Camera:
    """Clean-convention camera in framework world space, on ``device``."""
    dev = resolve_device(device)
    proj = perspective(fov_y_deg, width / height, near, far)
    view = look_at(eye, target, up)
    return Camera(
        modelview=torch.from_numpy(view).to(dev),
        projection=torch.from_numpy(proj).to(dev),
        width=width,
        height=height,
    )
