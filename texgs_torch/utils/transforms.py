"""Quaternion / covariance helpers (port of texgs/utils/transforms.py).

Channel form, as in texgs: the 3x3 matrices are kept as nine (N,)
channels, so the math is elementwise.
"""

from __future__ import annotations

import torch


def rotation_channels(q: torch.Tensor):
    """(N, 4) wxyz quaternions -> the 9 rotation-matrix entries as (N,)
    channels (r00..r22, row-major)."""
    q = q / (torch.linalg.norm(q, dim=-1, keepdim=True) + 1e-12)
    r, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return (1 - 2 * (y * y + z * z), 2 * (x * y - r * z), 2 * (x * z + r * y),
            2 * (x * y + r * z), 1 - 2 * (x * x + z * z), 2 * (y * z - r * x),
            2 * (x * z - r * y), 2 * (y * z + r * x), 1 - 2 * (x * x + y * y))


def build_covariance_packed(scaling: torch.Tensor, rotation: torch.Tensor,
                            scaling_modifier: float = 1.0) -> torch.Tensor:
    """Sigma = R diag(s^2) R^T packed as (N, 6) upper triangle
    (xx, xy, xz, yy, yz, zz)."""
    r00, r01, r02, r10, r11, r12, r20, r21, r22 = rotation_channels(rotation)
    s = scaling_modifier * scaling
    s0, s1, s2 = s[..., 0] ** 2, s[..., 1] ** 2, s[..., 2] ** 2
    xx = s0 * r00 * r00 + s1 * r01 * r01 + s2 * r02 * r02
    xy = s0 * r00 * r10 + s1 * r01 * r11 + s2 * r02 * r12
    xz = s0 * r00 * r20 + s1 * r01 * r21 + s2 * r02 * r22
    yy = s0 * r10 * r10 + s1 * r11 * r11 + s2 * r12 * r12
    yz = s0 * r10 * r20 + s1 * r11 * r21 + s2 * r12 * r22
    zz = s0 * r20 * r20 + s1 * r21 * r21 + s2 * r22 * r22
    return torch.stack([xx, xy, xz, yy, yz, zz], dim=-1)


def strip_symmetric(cov: torch.Tensor) -> torch.Tensor:
    """(N, 3, 3) symmetric -> (N, 6) packed upper triangle
    (xx, xy, xz, yy, yz, zz)."""
    return torch.stack([cov[..., 0, 0], cov[..., 0, 1], cov[..., 0, 2],
                        cov[..., 1, 1], cov[..., 1, 2], cov[..., 2, 2]],
                       dim=-1)
