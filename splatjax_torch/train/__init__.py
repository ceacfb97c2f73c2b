from splatjax_torch.train.fit import (
    FitConfig,
    fit,
    init_random,
    make_train_step,
)
from splatjax_torch.train.loss import combined_loss, l1, psnr, ssim

__all__ = [
    "FitConfig",
    "combined_loss",
    "fit",
    "init_random",
    "l1",
    "make_train_step",
    "psnr",
    "ssim",
]
