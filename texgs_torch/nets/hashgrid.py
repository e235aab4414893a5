"""Multiresolution hash-grid encoding (port of texgs/nets/hashgrid.py).

L levels x F features, a 2^log2_hashmap-entry table per level, base
resolution 16, per-level scale 1.447, the spatial hash with the standard
primes (uint32 wrap-around), trilinear interpolation.  Hashing and the
trilinear weights are plain PyTorch; the gather of the 8 corner rows per
level is kernel K5 (nets/hash_gather.py) on CUDA tensors.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
from torch import nn

from texgs_torch.nets.hash_gather import hash_gather

PRIMES = (1, 2654435761, 805459861)
BASE_RESOLUTION = 16
PER_LEVEL_SCALE = 1.447
U32 = 0xFFFFFFFF


def level_resolution(level: int) -> int:
    """floor(16 * 1.447^level), in Python floats as texgs computes it."""
    return int(math.floor(BASE_RESOLUTION * PER_LEVEL_SCALE ** level))


def _mul_u32(a: torch.Tensor, p: int) -> torch.Tensor:
    """(a * p) mod 2^32 for int64 a, as uint32 arithmetic wraps.  The
    prime is split in 16-bit halves so no int64 product overflows."""
    a = a & U32
    return (a * (p & 0xFFFF) + (((a * (p >> 16)) & 0xFFFF) << 16)) & U32


def _hash(ix, iy, iz, table_size: int) -> torch.Tensor:
    """tcnn's spatial hash with uint32 wrap-around, computed in int64."""
    h = _mul_u32(ix, PRIMES[0]) ^ _mul_u32(iy, PRIMES[1]) \
        ^ _mul_u32(iz, PRIMES[2])
    return (h % table_size).to(torch.int32)


def indices_and_weights(x: torch.Tensor, n_levels: int, table_size: int):
    """Corner hash indices (L * 8, N) int32 and trilinear weights (L * 8, N)
    of the points x (N, 3) in [0, 1].  The weights are differentiable in x;
    the indices are integers."""
    idxs, ws = [], []
    for level in range(n_levels):
        pos = x * level_resolution(level)
        ipos = torch.floor(pos).to(torch.int32)
        frac = pos - ipos
        ip = ipos.to(torch.int64)
        for corner in range(8):
            dx, dy, dz = corner & 1, (corner >> 1) & 1, (corner >> 2) & 1
            idxs.append(_hash(ip[:, 0] + dx, ip[:, 1] + dy, ip[:, 2] + dz,
                              table_size))
            ws.append((frac[:, 0] if dx else 1 - frac[:, 0])
                      * (frac[:, 1] if dy else 1 - frac[:, 1])
                      * (frac[:, 2] if dz else 1 - frac[:, 2]))
    return torch.stack(idxs), torch.stack(ws)


class HashGrid(nn.Module):
    """The encoding's tables (L, 2^log2, F), initialised uniform in
    [-1e-4, 1e-4] as texgs's ``init_hashgrid``."""

    def __init__(self, n_levels: int, n_features_per_level: int,
                 log2_hashmap_size: int,
                 generator: Optional[torch.Generator] = None, device="cuda"):
        super().__init__()
        shape = (n_levels, 2 ** log2_hashmap_size, n_features_per_level)
        table = torch.rand(shape, generator=generator,
                           device=generator.device if generator is not None
                           else device) * 2e-4 - 1e-4
        self.table = nn.Parameter(table.to(device))

    @property
    def out_dim(self) -> int:
        return self.table.shape[0] * self.table.shape[2]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (N, 3) in [0, 1] -> (N, L * F) encoded features."""
        n_levels, table_size, n_feat = self.table.shape
        n = x.shape[0]
        idx, w = indices_and_weights(x, n_levels, table_size)
        gathered = hash_gather(self.table, idx.contiguous())   # (L*8, F, N)
        feats = (gathered * w[:, None, :]).reshape(
            n_levels, 8, n_feat, n).sum(dim=1)                  # (L, F, N)
        return feats.permute(2, 0, 1).reshape(n, n_levels * n_feat)

    def load_jax_params(self, params: dict) -> None:
        """Copy texgs hash-grid params {"table": (L, T, F)}."""
        table = torch.as_tensor(np.array(params["table"], np.float32))
        if table.shape != self.table.shape:
            raise ValueError(f"hash grid expects {tuple(self.table.shape)}, "
                             f"got {tuple(table.shape)}")
        with torch.no_grad():
            self.table.copy_(table)

    def jax_params(self) -> dict:
        return {"table": self.table.detach().cpu().numpy().copy()}
