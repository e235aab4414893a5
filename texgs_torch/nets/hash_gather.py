"""Kernel K5: the hash-grid gather of the multiresolution encoding.

Replaces the TPU kernel ``hash_gather`` of texgs/nets/pallas_hashgrid.py:63
(pallas_call at :81).  The CUDA kernel is csrc/hash_gather.cu.
``gather_plain`` below is its plain PyTorch version (advanced indexing).
The TPU kernel's ``BLOCK_Q`` padding and 128-lane table segments are TPU
layout and are not ported.

The port's ``HashGrid`` no longer calls it: the fused hash encode of
nets/hash_encode.py (kernels K5' and K5'') computes the whole encoding.
This gather stays as the counterpart of texgs's Pallas ``hash_gather``,
held against its plain version on a training step's own corner indices.

``hash_gather`` is differentiable in the table.  Its backward is plain
PyTorch, ``index_put_(..., accumulate=True)``, as texgs's is an XLA
scatter-add (pallas_hashgrid.py:103-114): texgs has no backward kernel
here.  The forward runs the plain version only for tensors on the CPU; for
CUDA tensors it launches the kernel or raises.  Each launch adds one to
``hash_gather.launches``.
"""

from __future__ import annotations

import torch

from texgs_torch import _build
from texgs_torch.utils.spans import spanned


def gather_plain(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain version: (L, T, F) table and (L * C, N) corner indices ->
    (L * C, F, N) gathered rows, corner row r reading level r // C."""
    levels = table.shape[0]
    corners = idx.shape[0] // levels
    level_of = torch.arange(levels, device=idx.device).repeat_interleave(corners)
    return table[level_of[:, None], idx.long()].permute(0, 2, 1)


def _gather_backward(table_shape, idx: torch.Tensor,
                     g: torch.Tensor) -> torch.Tensor:
    """d table for the cotangent g (L * C, F, N): a scatter-add of every
    gathered row's cotangent into its table row."""
    levels = table_shape[0]
    corners = idx.shape[0] // levels
    level_of = torch.arange(levels, device=idx.device).repeat_interleave(corners)
    d_table = torch.zeros(table_shape, dtype=g.dtype, device=g.device)
    d_table.index_put_((level_of[:, None].expand_as(idx), idx.long()),
                       g.permute(0, 2, 1), accumulate=True)
    return d_table


@spanned("kernel.hash_gather")
def hash_gather_forward(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Kernel K5 without autograd.  CPU tensors take the plain version;
    CUDA tensors launch csrc/hash_gather.cu."""
    if idx.dim() != 2 or table.dim() != 3 or idx.shape[0] % table.shape[0]:
        raise ValueError(f"hash_gather: table must be (L, T, F) and idx "
                         f"(L * C, N), got {tuple(table.shape)} and "
                         f"{tuple(idx.shape)}")
    if table.device.type == "cpu":
        return gather_plain(table, idx)
    _build.require("hash_gather", "table", table, like=table)
    _build.require("hash_gather", "idx", idx, like=table, dtype=torch.int32)
    levels, size, n_feat = table.shape
    rows, n = idx.shape
    out = torch.empty((rows, n_feat, n), device=table.device)
    # the C entry launches nothing for an empty query
    _build.launch("hash_gather", "hash_gather_forward", "PPiiiiiP", table,
                  idx, levels, rows // levels, size, n_feat, n, out,
                  like=table, counter=hash_gather, launched=rows * n > 0)
    return out


class _HashGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.table_shape = table.shape
        return hash_gather_forward(table, idx)

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        return _gather_backward(ctx.table_shape, idx, g), None


def hash_gather(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(L, T, F) f32 table and (L * C, N) int32 corner indices -> (L * C, F,
    N) gathered rows, differentiable in the table.  Every index must lie in
    [0, T): the hash reduces it modulo T."""
    return _HashGather.apply(table, idx)


hash_gather.launches = 0
