"""Training losses: L1 + SSIM, the standard 3DGS objective (PyTorch port of
``splatjax/train/loss.py``).

The 11x11 Gaussian blur of SSIM is ``F.conv2d`` in full float32 (cuDNN's
TF32 is switched off, as splatjax runs its convolution at the highest
precision)."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def _gaussian_window(size: int = 11, sigma: float = 1.5,
                     device=None) -> torch.Tensor:
    x = torch.arange(size, dtype=torch.float32, device=device) \
        - (size - 1) / 2.0
    g = torch.exp(-(x ** 2) / (2.0 * sigma ** 2))
    g = g / g.sum()
    return torch.outer(g, g)


def _blur(x: torch.Tensor, win: torch.Tensor) -> torch.Tensor:
    """(H, W, C) -> per-channel 'valid' blur (H', W', C)."""
    torch.backends.cudnn.allow_tf32 = False
    y = F.conv2d(x.permute(2, 0, 1)[:, None], win[None, None])
    return y[:, 0].permute(1, 2, 0)


def ssim(img1: torch.Tensor, img2: torch.Tensor, *,
         window_size: int = 11) -> torch.Tensor:
    """Mean SSIM over an (H, W, C) pair, NVS-standard constants."""
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    win = _gaussian_window(window_size, device=img1.device)
    mu1, mu2 = _blur(img1, win), _blur(img2, win)
    mu1_sq, mu2_sq, mu12 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    s1 = _blur(img1 * img1, win) - mu1_sq
    s2 = _blur(img2 * img2, win) - mu2_sq
    s12 = _blur(img1 * img2, win) - mu12
    num = (2 * mu12 + c1) * (2 * s12 + c2)
    den = (mu1_sq + mu2_sq + c1) * (s1 + s2 + c2)
    return (num / den).mean()


def l1(img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
    return (img1 - img2).abs().mean()


def combined_loss(pred: torch.Tensor, target: torch.Tensor, *,
                  ssim_weight: float = 0.2) -> torch.Tensor:
    """(1 - w) * L1 + w * (1 - SSIM), on RGB channels."""
    p, t = pred[..., :3], target[..., :3]
    return (1.0 - ssim_weight) * l1(p, t) + ssim_weight * (1.0 - ssim(p, t))


def psnr(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    mse = ((pred[..., :3] - target[..., :3]) ** 2).mean()
    return -10.0 * torch.log10(mse.clamp_min(1e-12))
