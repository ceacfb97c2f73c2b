"""splatjax_torch: the PyTorch/CUDA port of splatjax for NVIDIA Hopper.

The package mirrors splatjax's module names. It imports torch and numpy
only (never jax or splatjax); its hand-written CUDA kernels live in
``csrc/`` and are built with nvcc at first use (:mod:`.kernels`).
Entry points default to ``device="cuda"`` and raise without a card unless
the caller passes ``device="cpu"``.
"""
from splatjax_torch.camera import Camera, look_at, make_camera, perspective
from splatjax_torch.compose import (
    OpaqueLayer,
    compose_scene,
    merge_opaque_layers,
)
from splatjax_torch.render import (
    CachedBins,
    bin_scene,
    composite_over,
    render,
    render_binned,
    render_instances,
    render_stereo,
)
from splatjax_torch.scene import (
    GaussianScene,
    TrainableGaussians,
    build_covariances,
    importance,
    scene_from_numpy,
    select_important,
    trainable_from_numpy,
)
from splatjax_torch.viewer import SplatRenderer
from splatjax_torch import io

__all__ = [
    "CachedBins",
    "Camera",
    "GaussianScene",
    "OpaqueLayer",
    "SplatRenderer",
    "TrainableGaussians",
    "bin_scene",
    "build_covariances",
    "compose_scene",
    "composite_over",
    "importance",
    "io",
    "look_at",
    "make_camera",
    "merge_opaque_layers",
    "perspective",
    "render",
    "render_binned",
    "render_instances",
    "render_stereo",
    "scene_from_numpy",
    "select_important",
    "trainable_from_numpy",
]
