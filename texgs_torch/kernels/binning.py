"""Tile binning: Gaussian -> (tile, depth-rank)-sorted pair list.

Port of texgs/kernels/binning.py:88 ``build_pairs``.  The pair set, the
(tile, depth-rank) order, ``tile_counts``, ``n_pairs`` and ``overflowed``
are texgs's.  The chunk-aligned padded layout, ``chunk_first``,
``_safe_tiles`` and ``n_live_chunks`` existed only to feed a sequential
TPU grid; the port instead hands the kernel per-tile ``[start, end)``
ranges over the sorted pair list.  PyTorch holds dynamic shapes, so the
list has exactly the kept pairs (one host read of the pair count).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from texgs_torch.kernels.reference import TILE, tile_rect


class PairList(NamedTuple):
    pair_gauss: torch.Tensor   # (P,) int32 Gaussian index, (tile, depth) order
    pair_tile: torch.Tensor    # (P,) int32 tile id of each pair
    tile_start: torch.Tensor   # (T,) int32 first pair of each tile
    tile_end: torch.Tensor     # (T,) int32 one past the last pair
    tile_counts: torch.Tensor  # (T,) int32 pair count per tile
    n_pairs: torch.Tensor      # () int64 true (uncapped) pair count
    overflowed: torch.Tensor   # () bool: pair_cap exceeded (pairs dropped)


def grid_shape(height: int, width: int) -> tuple[int, int]:
    return (-(-height // TILE), -(-width // TILE))


def build_pairs(means2d: torch.Tensor, depths: torch.Tensor,
                radii: torch.Tensor, height: int, width: int,
                pair_cap: Optional[int] = None) -> PairList:
    """Build the (tile, depth-rank)-sorted pair list.

    Every visible Gaussian emits one pair per covered 16x16 tile
    (``tile_rect``), in Gaussian-index order; with ``pair_cap`` set, pairs
    past the cap in that order are dropped and ``overflowed`` is set, as
    in texgs.  ``pair_cap=None`` keeps every pair.
    """
    device = means2d.device
    n = means2d.shape[0]
    gy, gx = grid_shape(height, width)
    n_tiles = gy * gx

    xmin, xmax, ymin, ymax = tile_rect(means2d, radii, width, height)
    visible = radii > 0
    rect_w = (xmax - xmin).to(torch.int64)
    per_g = torch.where(visible, rect_w * (ymax - ymin).to(torch.int64), 0)
    total = per_g.sum()
    n_total = int(total)
    n_keep = n_total if pair_cap is None else min(n_total, int(pair_cap))

    # depth rank per Gaussian, ties broken by index (stable sort, as jnp's
    # argsort); culled Gaussians rank last
    depth_key = torch.where(visible, depths, torch.full_like(depths, torch.inf))
    order_g = torch.sort(depth_key, stable=True).indices
    rank = torch.empty(n, dtype=torch.int64, device=device)
    rank[order_g] = torch.arange(n, dtype=torch.int64, device=device)

    # expansion: slot -> Gaussian in index order, then the tile inside its rect
    offs = torch.cumsum(per_g, 0) - per_g
    g = torch.repeat_interleave(torch.arange(n, device=device), per_g,
                                output_size=n_total)[:n_keep]
    local = torch.arange(n_keep, dtype=torch.int64, device=device) - offs[g]
    w_g = torch.clamp(rect_w[g], min=1)
    ty = ymin[g].to(torch.int64) + local // w_g
    tx = xmin[g].to(torch.int64) + local % w_g
    tile = ty * gx + tx

    # (tile, depth-rank) order: one sort of a unique int64 key
    order = torch.sort(tile * n + rank[g], stable=True).indices
    pair_tile = tile[order]
    counts = torch.bincount(pair_tile, minlength=n_tiles)
    tile_end = torch.cumsum(counts, 0)
    tile_start = tile_end - counts
    return PairList(
        pair_gauss=g[order].to(torch.int32),
        pair_tile=pair_tile.to(torch.int32),
        tile_start=tile_start.to(torch.int32),
        tile_end=tile_end.to(torch.int32),
        tile_counts=counts.to(torch.int32),
        n_pairs=total,
        overflowed=total > n_keep,
    )
