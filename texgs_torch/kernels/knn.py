"""Brute-force KNN for initial scales (port of texgs/kernels/knn.py).

Mean squared distance from each point to its 3 nearest neighbours, in
blocks of queries so peak memory is block_size x N.
"""

from __future__ import annotations

import torch


def mean_sq_dist_3nn(points: torch.Tensor, block_size: int = 1024) -> torch.Tensor:
    """points: (N, 3) -> (N,) mean of squared distances to the 3 NN."""
    points = points.to(torch.float32)
    n = points.shape[0]
    sq = (points * points).sum(-1)
    k = min(4, n)
    out = []
    for i in range(0, n, block_size):
        q = points[i:i + block_size]
        d2 = (q * q).sum(-1)[:, None] - 2.0 * q @ points.T + sq[None, :]
        rows = torch.arange(i, i + q.shape[0], device=points.device)
        # exclude the point itself explicitly (its d2 is ~0, but rounding
        # can leave another point's d2 below it)
        d2[torch.arange(q.shape[0], device=points.device), rows] = torch.inf
        top = torch.topk(d2, k - 1, dim=-1, largest=False).values
        out.append(top)
    d2 = torch.cat(out, dim=0)
    return torch.clamp(d2, min=0.0).mean(dim=-1)
