"""Rasterizer constants, the output record and the tile-rect rule.

Port of the constants of texgs/kernels/reference.py:33-36, its
``RasterOutput`` and ``tile_rect``.  Blending follows the sequential
semantics of the 3DGS CUDA rasterizer:
  alpha_i = min(0.99, opacity_i * exp(power)), skipped when power > 0 or
  alpha < 1/255; front-to-back transmittance T with a hard stop *before*
  the Gaussian that would push T below 1e-4.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

TILE = 16
ALPHA_CLAMP = 0.99
MIN_ALPHA = 1.0 / 255.0
T_STOP = 1e-4


class RasterOutput(NamedTuple):
    image: torch.Tensor   # (3, H, W)
    depth: torch.Tensor   # (1, H, W)
    norm: torch.Tensor    # (3, H, W)
    alpha: torch.Tensor   # (1, H, W)
    extra: Optional[torch.Tensor]  # (E, H, W) or None
    n_pairs: Optional[torch.Tensor] = None     # () true uncapped pair count
    overflowed: Optional[torch.Tensor] = None  # () bool: pair_cap exceeded
    image_no_sh: Optional[torch.Tensor] = None  # (3, H, W) texture-only image


def tile_rect(means2d: torch.Tensor, radii: torch.Tensor, width: int,
              height: int):
    """Per-Gaussian covered tile rectangle [min, max), CUDA getRect parity.

    Returns int32 tensors (xmin, xmax, ymin, ymax) in tile units.
    """
    grid_x = (width + TILE - 1) // TILE
    grid_y = (height + TILE - 1) // TILE
    r = radii.to(torch.float32)
    px, py = means2d[:, 0], means2d[:, 1]
    # float -> int32 truncates toward zero, as jnp's astype does
    xmin = torch.clamp(((px - r) / TILE).to(torch.int32), 0, grid_x)
    xmax = torch.clamp(((px + r + TILE - 1) / TILE).to(torch.int32), 0, grid_x)
    ymin = torch.clamp(((py - r) / TILE).to(torch.int32), 0, grid_y)
    ymax = torch.clamp(((py + r + TILE - 1) / TILE).to(torch.int32), 0, grid_y)
    return xmin, xmax, ymin, ymax
