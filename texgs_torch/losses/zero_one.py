"""Opacity binarisation regulariser (port of texgs/losses/zero_one.py):
mean(log v + log(1 - v)), most negative at v in {0, 1}."""

import torch


def zero_one_loss(value, epsilon: float = 1e-3):
    val = torch.clamp(value, epsilon, 1 - epsilon)
    return (torch.log(val) + torch.log(1 - val)).mean()
