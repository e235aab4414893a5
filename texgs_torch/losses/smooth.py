"""Bilateral edge-aware smoothness (port of texgs/losses/smooth.py:
``smooth_loss``): first order, over 4 neighbour pairs (x, y and both
diagonals), with exp(-|d rgb| / gamma) weights and a mask."""

from __future__ import annotations

import torch


def _bilateral(x, gamma):
    return torch.exp(-x.abs().sum(0, keepdim=True) / gamma)


def smooth_loss(rgb, value, mask=None, gamma: float = 0.1):
    """rgb: (3, H, W) guidance image; value: (C, H, W); mask: (1, H, W)."""
    w1 = _bilateral(rgb[:, :, :-1] - rgb[:, :, 1:], gamma)
    w2 = _bilateral(rgb[:, :-1, :] - rgb[:, 1:, :], gamma)
    w3 = _bilateral(rgb[:, :-1, :-1] - rgb[:, 1:, 1:], gamma)
    w4 = _bilateral(rgb[:, 1:, :-1] - rgb[:, :-1, 1:], gamma)
    if mask is not None:
        mask = mask.to(rgb.dtype)
        w1 = w1 * mask[:, :, :-1] * mask[:, :, 1:]
        w2 = w2 * mask[:, :-1, :] * mask[:, 1:, :]
        w3 = w3 * mask[:, :-1, :-1] * mask[:, 1:, 1:]
        w4 = w4 * mask[:, 1:, :-1] * mask[:, :-1, 1:]
    l1 = (w1 * (value[:, :, :-1] - value[:, :, 1:])).abs().sum() / (w1.sum() + 1e-6)
    l2 = (w2 * (value[:, :-1, :] - value[:, 1:, :])).abs().sum() / (w2.sum() + 1e-6)
    l3 = (w3 * (value[:, :-1, :-1] - value[:, 1:, 1:])).abs().sum() / (w3.sum() + 1e-6)
    l4 = (w4 * (value[:, 1:, :-1] - value[:, :-1, 1:])).abs().sum() / (w4.sum() + 1e-6)
    return (l1 + l2 + l3 + l4) / 4
