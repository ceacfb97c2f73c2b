"""splatjax_torch: the PyTorch/CUDA port of splatjax for NVIDIA Hopper.

The package mirrors splatjax's module names. It imports torch and numpy
only (never jax or splatjax); its hand-written CUDA kernels live in
``csrc/`` and are built with nvcc at first use (:mod:`.kernels`).
Entry points default to ``device="cuda"`` and raise without a card unless
the caller passes ``device="cpu"``.
"""
from splatjax_torch.camera import Camera, look_at, make_camera, perspective
from splatjax_torch.render import render
from splatjax_torch.scene import (
    GaussianScene,
    TrainableGaussians,
    scene_from_numpy,
    trainable_from_numpy,
)
from splatjax_torch.viewer import SplatRenderer

__all__ = [
    "Camera",
    "GaussianScene",
    "SplatRenderer",
    "TrainableGaussians",
    "look_at",
    "make_camera",
    "perspective",
    "render",
    "scene_from_numpy",
    "trainable_from_numpy",
]
