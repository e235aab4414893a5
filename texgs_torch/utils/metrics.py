"""Evaluation metrics (port of texgs/utils/metrics.py: ``psnr``)."""

from __future__ import annotations

import torch


def psnr(img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
    """Per-image PSNR over flattened pixels, (C, H, W) -> (C, 1)."""
    mse = ((img1 - img2) ** 2).reshape(img1.shape[0], -1).mean(1, keepdim=True)
    return 20 * torch.log10(1.0 / torch.sqrt(mse))
