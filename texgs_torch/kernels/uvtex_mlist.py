"""Kernel 2 and its backward 2': the per-pixel M-lists of the two-kernel
stage-3 render, differentiable.

Replaces the TPU kernel ``mlist_pairs`` of texgs/kernels/pallas_uvtex.py:237
(forward ``_fwd_kernel``, :94; backward ``_bwd_kernel``, :137), which texgs's
``backend="pallas"`` runs beside kernel 1's blend (uvtex_raster.py:536-552).
The CUDA kernels are csrc/uvtex_mlist.cu and csrc/uvtex_mlist_bwd.cu; their
source comments give the designs and the semantics they keep.

The plain versions reuse kernel A's (kernels.uvtex_fused): the M-list that
``mlist_scan`` builds beside its blend is the function kernel 2 computes,
and ``mlist_scan_vjp`` with zero blend and T cotangents is 2''s.  Kernel 2
reads no blend channel, so the plain versions zero the table's channel
columns first: a NaN channel of an entry no pixel composites then reaches
neither output, as in the kernels, which never read it.

``mlist_pairs`` is differentiable in the table's quadratic columns and the
uv rows; its backward calls ``mlist_pairs_backward``.  Both run the plain
version only for tensors on the CPU; for CUDA tensors they launch their
kernel or raise.  Each launch adds one to ``mlist_pairs.launches`` or
``mlist_pairs_backward.launches``.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from texgs_torch import _build
from texgs_torch.kernels.binning import PairList, tile_order_arg
from texgs_torch.kernels.tile_raster import (COL_ANCHOR, N_FIXED_F, PIX,
                                             ROW_F0, TABLE_FIXED)
from texgs_torch.kernels.uvtex_fused import (check_float4, check_pair_args,
                                             mlist_scan, mlist_scan_vjp,
                                             rays9)
from texgs_torch.utils.spans import spanned


def _without_channels(table: torch.Tensor) -> torch.Tensor:
    """The table with its blend channel columns zeroed."""
    t = table.clone()
    t[:, ROW_F0:COL_ANCHOR] = 0.0
    t[:, TABLE_FIXED:] = 0.0
    return t


def mlist_only_scan(table: torch.Tensor, uv_rows: torch.Tensor,
                    pairs: PairList, rays: np.ndarray, gx: int, m: int,
                    tile0: int = 0):
    """Plain version of kernel 2: the M-lists (T, PIX, m, 4) of
    ``uvtex_fused.mlist_scan`` (tile0 as there)."""
    return mlist_scan(_without_channels(table), uv_rows, pairs, rays, gx,
                      m, tile0)[2]


def mlist_only_scan_vjp(table: torch.Tensor, uv_rows: torch.Tensor,
                        pairs: PairList, rays: np.ndarray, gx: int, m: int,
                        g_mlist: torch.Tensor):
    """Plain version of kernel 2': ``uvtex_fused.mlist_scan_vjp`` with zero
    blend and T cotangents.  Returns (d_table (N, 16 + E), nonzero in the
    quadratic columns 0-5 only; d_uv_rows (N, 24), in columns 0-11)."""
    n_tiles = pairs.tile_counts.shape[0]
    n_f = table.shape[1] - TABLE_FIXED + N_FIXED_F
    zeros = torch.zeros((n_tiles, PIX, n_f), device=table.device)
    return mlist_scan_vjp(_without_channels(table), uv_rows, pairs, rays, gx,
                          m, zeros, zeros[..., 0], g_mlist)


_P, _I = ctypes.c_void_p, ctypes.c_int
_RAYS = ctypes.POINTER(ctypes.c_float)
_FWD_ARGS = [_P, _I, _P, _P, _P, _P, _P, _RAYS, _I, _I, _I, _P, _P]
_BWD_ARGS = [_P, _I, _P, _P, _P, _P, _P, _RAYS, _I, _I, _I, _P, _P, _P, _P,
             _P]


@spanned("kernel.uvtex_mlist")
def mlist_pairs_forward(table: torch.Tensor, uv_rows: torch.Tensor,
                        pairs: PairList, rays: np.ndarray, gx: int, m: int):
    """Kernel 2 without autograd: the M-lists (T, PIX, m, 4) of every tile.
    CPU tensors take the plain version; CUDA tensors launch
    csrc/uvtex_mlist.cu, which takes the tiles in the pair list's
    ``tile_order`` (heaviest first; computed here for a list without
    one).  The order changes no output."""
    if table.device.type == "cpu":
        return mlist_only_scan(table, uv_rows, pairs, rays, gx, m)
    check_pair_args("mlist_pairs", table, uv_rows, pairs, m)
    n_tiles = pairs.tile_counts.shape[0]
    order = tile_order_arg("mlist_pairs", pairs, table.device)
    mlist = torch.empty((n_tiles, PIX, m, 4), device=table.device)
    p = _build.ptr
    err = _build.function("uvtex_mlist", "uvtex_mlist_forward", _FWD_ARGS)(
        p(table), table.shape[1], p(uv_rows), p(pairs.pair_gauss),
        p(pairs.tile_start), p(pairs.tile_end), p(order), rays9(rays),
        n_tiles, gx, m, p(mlist), _build.stream_of(table))
    if err:
        raise RuntimeError(f"uvtex_mlist_forward failed: CUDA error {err}")
    if n_tiles > 0:  # the C entry launches nothing for an empty grid
        mlist_pairs.launches += 1
    return mlist


@spanned("kernel.uvtex_mlist_bwd")
def mlist_pairs_backward(table: torch.Tensor, uv_rows: torch.Tensor,
                         pairs: PairList, rays: np.ndarray, gx: int, m: int,
                         mlist: torch.Tensor, g_mlist: torch.Tensor):
    """Kernel 2': the VJP of kernel 2 into (d_table, d_uv_rows).  mlist is
    kernel 2's output for these arguments and g_mlist its cotangent.  CPU
    tensors take the plain version (``mlist_only_scan_vjp``); CUDA tensors
    launch csrc/uvtex_mlist_bwd.cu."""
    if table.device.type == "cpu":
        return mlist_only_scan_vjp(table, uv_rows, pairs, rays, gx, m,
                                   g_mlist)
    check_pair_args("mlist_pairs_backward", table, uv_rows, pairs, m)
    n_tiles = pairs.tile_counts.shape[0]
    shape = (n_tiles, PIX, m, 4)
    for arg in (mlist, g_mlist):
        if (tuple(arg.shape) != shape or arg.device != table.device
                or arg.dtype != torch.float32 or not arg.is_contiguous()):
            raise ValueError("mlist_pairs_backward: the M-lists and their "
                             f"cotangent must be contiguous float32 {shape} "
                             f"tensors on {table.device}")
    check_float4("mlist_pairs_backward", mlist, g_mlist)
    order = tile_order_arg("mlist_pairs_backward", pairs, table.device)
    d_table = torch.zeros_like(table)
    d_uv = torch.zeros_like(uv_rows)
    p = _build.ptr
    err = _build.function("uvtex_mlist_bwd", "uvtex_mlist_backward",
                          _BWD_ARGS)(
        p(table), table.shape[1], p(uv_rows), p(pairs.pair_gauss),
        p(pairs.tile_start), p(pairs.tile_end), p(order), rays9(rays),
        n_tiles, gx, m, p(mlist), p(g_mlist), p(d_table), p(d_uv),
        _build.stream_of(table))
    if err:
        raise RuntimeError(f"uvtex_mlist_backward failed: CUDA error {err}")
    if n_tiles > 0:
        mlist_pairs_backward.launches += 1
    return d_table, d_uv


class _MlistPairs(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, uv_rows, pairs, rays, gx, m):
        mlist = mlist_pairs_forward(table, uv_rows, pairs, rays, gx, m)
        ctx.save_for_backward(table, uv_rows, mlist)
        ctx.args = (pairs, rays, gx, m)
        return mlist

    @staticmethod
    def backward(ctx, g_mlist):
        table, uv_rows, mlist = ctx.saved_tensors
        d_table, d_uv = mlist_pairs_backward(table, uv_rows, *ctx.args, mlist,
                                             g_mlist.contiguous())
        return d_table, d_uv, None, None, None, None


def mlist_pairs(table: torch.Tensor, uv_rows: torch.Tensor, pairs: PairList,
                rays: np.ndarray, gx: int, m: int):
    """The M-lists (T, PIX, m, 4) of every tile, [w, uv] slots,
    differentiable in ``table`` and ``uv_rows``.  The forward is one launch
    of kernel 2 on CUDA tensors, the backward one of kernel 2'."""
    return _MlistPairs.apply(table, uv_rows, pairs, rays, gx, m)


mlist_pairs.launches = 0
mlist_pairs_backward.launches = 0
