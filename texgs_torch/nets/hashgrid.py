"""Multiresolution hash-grid encoding (port of texgs/nets/hashgrid.py).

L levels x F features, a 2^log2_hashmap-entry table per level, base
resolution 16, per-level scale 1.447, the spatial hash with the standard
primes (uint32 wrap-around), trilinear interpolation.  The whole encode,
hashing, weights, gather and sum, is kernel K5' (nets/hash_encode.py) on
CUDA tensors, and its backward kernel K5''.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from texgs_torch.nets.hash_encode import hash_encode
from texgs_torch.nets.hash_encode import (  # noqa: F401 (re-exported)
    indices_and_weights, level_resolution)


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
        return hash_encode(self.table, x.contiguous())

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
