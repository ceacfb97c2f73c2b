from splatjax_torch.train.checkpoint import (
    CheckpointManager,
    export_ply,
    export_splat,
)
from splatjax_torch.train.densify import DensifyConfig, densify_and_prune
from splatjax_torch.train.fit import (
    FitConfig,
    fit,
    init_random,
    make_dp_train_step,
    make_train_step,
)
from splatjax_torch.train.loss import combined_loss, l1, psnr, ssim

__all__ = [
    "CheckpointManager",
    "DensifyConfig",
    "FitConfig",
    "combined_loss",
    "densify_and_prune",
    "export_ply",
    "export_splat",
    "fit",
    "init_random",
    "l1",
    "make_dp_train_step",
    "make_train_step",
    "psnr",
    "ssim",
]
