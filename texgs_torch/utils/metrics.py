"""Evaluation metrics (port of texgs/utils/metrics.py): PSNR, the normal
maps' mean angular error, the paper's geometric-mean ``avg_error`` and the
optional LPIPS."""

from __future__ import annotations

import functools

import numpy as np
import torch


def psnr(img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
    """Per-image PSNR over flattened pixels, (C, H, W) -> (C, 1)."""
    mse = ((img1 - img2) ** 2).reshape(img1.shape[0], -1).mean(1, keepdim=True)
    return 20 * torch.log10(1.0 / torch.sqrt(mse))


def mae(pred_normal: torch.Tensor, gt_normal: torch.Tensor,
        mask=None) -> torch.Tensor:
    """Mean angular error in degrees between normal maps (3, H, W), over
    the pixels where mask (1, H, W) > 0.5 when one is given."""
    cos = torch.clamp((pred_normal * gt_normal).sum(0), -1.0, 1.0)
    ang = torch.rad2deg(torch.arccos(cos))
    if mask is not None:
        m = mask[0] > 0.5
        return (ang * m).sum() / torch.clamp(m.sum(), min=1)
    return ang.mean()


def avg_error(psnr_v: float, ssim_v: float, lpips_v: float) -> float:
    """The paper's geometric mean of 10^(-PSNR/10), sqrt(1 - SSIM) and
    LPIPS."""
    psnr_term = 10 ** (-psnr_v / 10)
    ssim_term = np.sqrt(1 - ssim_v)
    return float(np.exp(np.mean(np.log(np.array(
        [psnr_term, ssim_term, lpips_v])))))


@functools.lru_cache(maxsize=None)
def _lpips_net(device: str):
    import lpips as lpips_pkg

    return lpips_pkg.LPIPS(net="vgg").to(device).eval()


@torch.no_grad()
def lpips(img1: torch.Tensor, img2: torch.Tensor):
    """LPIPS (VGG) of two (3, H, W) images in [0, 1], or None where the
    ``lpips`` package is not installed, as texgs degrades."""
    try:
        import lpips as _  # noqa: F401
    except ImportError:
        return None
    net = _lpips_net(str(img1.device))
    return float(net(img1[None] * 2 - 1, img2[None] * 2 - 1))
