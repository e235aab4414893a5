"""Chamfer distance and farthest-point sampling (port of
texgs/kernels/chamfer.py).

Stage 2's chamfer losses and extract_pcd's downsampling.  Plain PyTorch:
texgs computes them outside any kernel.  The pairwise distances are
blocked matrix products (``torch.matmul``), so peak memory stays at
block x M.
"""

from __future__ import annotations

import torch


def _min_dists_sq(a: torch.Tensor, b: torch.Tensor,
                  block: int = 4096) -> torch.Tensor:
    """Per-point-in-a squared distance to its nearest neighbour in b."""
    b_sq = (b * b).sum(-1)
    out = []
    for i in range(0, a.shape[0], block):
        q = a[i:i + block]
        d2 = (q * q).sum(-1)[:, None] - 2.0 * q @ b.T + b_sq[None, :]
        out.append(d2.min(dim=1).values)
    return torch.clamp(torch.cat(out), min=0.0)


def chamfer_distance(x: torch.Tensor, y: torch.Tensor,
                     single_directional: bool = False) -> torch.Tensor:
    """Mean squared nearest-neighbour distance, pytorch3d semantics: the
    sum of the two directional means, or x -> y alone."""
    d_xy = _min_dists_sq(x, y).mean()
    if single_directional:
        return d_xy
    return d_xy + _min_dists_sq(y, x).mean()


@torch.no_grad()
def farthest_point_sampling(points: torch.Tensor, k: int) -> torch.Tensor:
    """Indices (k,) of k farthest-point samples, starting at index 0 (texgs
    without a key): each next sample is the point farthest from those
    taken, the first of several at the same distance."""
    n = points.shape[0]
    idx = torch.empty(k, dtype=torch.int64, device=points.device)
    min_d2 = torch.full((n,), float("inf"), device=points.device)
    last = torch.tensor(0, device=points.device)
    for i in range(k):
        idx[i] = last
        d2 = ((points - points[last][None, :]) ** 2).sum(-1)
        min_d2 = torch.minimum(min_d2, d2)
        last = torch.argmax(min_d2)
    return idx
