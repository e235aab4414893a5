"""Windowed SSIM, 11x11 Gaussian window, sigma 1.5 (port of
texgs/losses/ssim.py): a depthwise 'same' zero-padded separable blur
(two ``F.conv2d`` passes), C1 = 0.01^2, C2 = 0.03^2.  Returns the
similarity; callers use 1 - ssim as the loss term.  cuDNN's TF32 is off
(texgs_torch/__init__.py), so the blur runs in full float32 on the card.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def _gaussian_window(window_size: int, sigma: float) -> list:
    xs = [math.exp(-((x - window_size // 2) ** 2) / (2 * sigma ** 2))
          for x in range(window_size)]
    s = sum(xs)
    return [x / s for x in xs]


def _blur(img: torch.Tensor, window: torch.Tensor) -> torch.Tensor:
    c = img.shape[0]
    pad = window.shape[0] // 2
    kh = window.reshape(1, 1, -1, 1).expand(c, 1, -1, 1)
    kw = window.reshape(1, 1, 1, -1).expand(c, 1, 1, -1)
    x = F.conv2d(img[None], kh, padding=(pad, 0), groups=c)
    x = F.conv2d(x, kw, padding=(0, pad), groups=c)
    return x[0]


def ssim_loss(img1: torch.Tensor, img2: torch.Tensor, window_size: int = 11,
              sigma: float = 1.5) -> torch.Tensor:
    """img1, img2: (C, H, W) in [0, 1].  Returns the mean SSIM."""
    window = torch.tensor(_gaussian_window(window_size, sigma),
                          dtype=img1.dtype, device=img1.device)
    mu1 = _blur(img1, window)
    mu2 = _blur(img2, window)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = _blur(img1 * img1, window) - mu1_sq
    sigma2_sq = _blur(img2 * img2, window) - mu2_sq
    sigma12 = _blur(img1 * img2, window) - mu1_mu2
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    ssim_map = (((2 * mu1_mu2 + c1) * (2 * sigma12 + c2))
                / ((mu1_sq + mu2_sq + c1) * (sigma1_sq + sigma2_sq + c2)))
    return ssim_map.mean()
