"""Gaussian parameters and their initialisation (port of texgs/core/state.py).

texgs keeps arrays at a fixed capacity with the first ``n_alive`` rows
live, because dynamic shapes force retraces on the TPU.  PyTorch runs
eagerly, so the port holds exactly N live Gaussians and needs no padding.

Parameterization (same as texgs):
  scaling  = exp(scaling)            rotation = normalize(rotation) [wxyz]
  opacity  = sigmoid(opacity)        features = SH coefficients, DC first
"""

from __future__ import annotations

import dataclasses

import torch

from texgs_torch.kernels.knn import mean_sq_dist_3nn
from texgs_torch.utils.sh import rgb2sh


@dataclasses.dataclass
class GaussianState:
    xyz: torch.Tensor            # (N, 3) world-space centers
    features_dc: torch.Tensor    # (N, 1, 3) SH degree-0 coefficients
    features_rest: torch.Tensor  # (N, (deg+1)^2-1, 3) higher-order SH
    scaling: torch.Tensor        # (N, 3) log-scales
    rotation: torch.Tensor       # (N, 4) unnormalized quaternions (w, x, y, z)
    opacity: torch.Tensor        # (N, 1) logit opacities


def inverse_sigmoid(x):
    return torch.log(x / (1.0 - x))


def init_from_pcd(points, colors, max_sh_degree: int, device="cuda",
                  knn_dist2=None) -> GaussianState:
    """Initialise from a point cloud: colors -> SH DC, log-scale =
    0.5*log(mean sq dist to 3 NN), identity rotation, opacity 0.1."""
    points = torch.as_tensor(points, dtype=torch.float32, device=device)
    colors = torch.as_tensor(colors, dtype=torch.float32, device=device)
    n = points.shape[0]
    if knn_dist2 is None:
        knn_dist2 = mean_sq_dist_3nn(points)
    dist2 = torch.clamp(knn_dist2, min=1e-7)
    scales = torch.log(torch.sqrt(dist2))[:, None].repeat(1, 3)
    n_rest = (max_sh_degree + 1) ** 2 - 1
    rots = torch.zeros((n, 4), dtype=torch.float32, device=device)
    rots[:, 0] = 1.0
    return GaussianState(
        xyz=points,
        features_dc=rgb2sh(colors)[:, None, :],
        features_rest=torch.zeros((n, n_rest, 3), dtype=torch.float32,
                                  device=device),
        scaling=scales,
        rotation=rots,
        opacity=inverse_sigmoid(
            0.1 * torch.ones((n, 1), dtype=torch.float32, device=device)),
    )
