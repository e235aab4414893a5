"""Kernel 1 and its backward 1': the front-to-back blend of stages 1 and 2
and of the two-kernel stage-3 render, differentiable.

Replaces the TPU kernel ``raster_pairs`` of texgs/kernels/pallas_raster.py:309
(forward ``_fwd_kernel``, :182; backward ``_bwd_kernel``, :214).  The CUDA
kernels are csrc/raster.cu and csrc/raster_bwd.cu; their source comments
give the designs and the semantics they keep.  ``raster_scan`` below is the
forward's plain PyTorch version: texgs's ``rasterize_scan`` blend
(``chunk_blend``), walked over chunks of every tile's depth-sorted pairs
with all tiles in one batch, as ``uvtex_fused.mlist_scan`` walks them;
``raster_scan_vjp`` (autograd through it) is the backward's.

``raster_pairs`` is differentiable in the per-Gaussian table; its backward
calls ``raster_pairs_backward``.  Both run the plain version only for
tensors on the CPU; for CUDA tensors they launch their kernel or raise.
Each launch adds one to ``raster_pairs.launches`` or
``raster_pairs_backward.launches``.
"""

from __future__ import annotations

import torch

from texgs_torch import _build
from texgs_torch.kernels.binning import (PairList, require_pairs,
                                         tile_order_arg)
from texgs_torch.kernels.reference import TILE
from texgs_torch.kernels.tile_raster import (COL_ANCHOR, N_FIXED_F, NEG_INF,
                                             PIX, ROW_LOGOP, TABLE_FIXED,
                                             blend_features, chunk_weights,
                                             shift_to_tile, tile_power)
from texgs_torch.utils.spans import spanned

# blend channels the kernels are instantiated for: rgb, depth and normal
# (stages 1 and 2), and those plus the 3 no-SH channels of the two-kernel
# stage-3 render
KERNEL_F = (7, 10)
CHUNK = 64  # pairs of each tile the plain version takes per step
# table columns with no gradient: the log-opacity (read only by the
# power > 0 skip) and the anchor corner (a floor of the projected mean)
NO_GRAD_COLS = (ROW_LOGOP, COL_ANCHOR, COL_ANCHOR + 1)


def raster_scan(table: torch.Tensor, pairs: PairList, gx: int,
                tile0: int = 0):
    """Plain version of kernel 1.

    table: (N, 16 + E) from tile_raster.build_gauss_table.  Returns
    (tiles_out (T, PIX, F), t_final (T, PIX), n_eval (T, PIX) int32: the
    pairs of its tile each pixel evaluated, the one that stopped it
    included), F = 7 + E.  tile0: the frame tile that the pair list's
    first tile is (a band of whole tile rows; 0 for a whole frame)."""
    device = table.device
    n_tiles = pairs.tile_counts.shape[0]
    n_f = table.shape[1] - TABLE_FIXED + N_FIXED_F
    tiles = torch.arange(tile0, tile0 + n_tiles, device=device)
    tile_x = ((tiles % gx) * TILE).to(torch.float32)[:, None]
    tile_y = ((tiles // gx) * TILE).to(torch.float32)[:, None]

    out = torch.zeros((n_tiles, PIX, n_f), device=device, dtype=table.dtype)
    t_buf = torch.ones((n_tiles, PIX), device=device, dtype=table.dtype)
    done = torch.zeros((n_tiles, PIX), dtype=torch.bool, device=device)
    n_eval = torch.zeros((n_tiles, PIX), dtype=torch.int32, device=device)

    counts = pairs.tile_counts.to(torch.int64)
    starts = pairs.tile_start.to(torch.int64)
    n_pairs = pairs.pair_gauss.shape[0]
    max_count = int(counts.max()) if n_tiles else 0
    for c0 in range(0, max_count, CHUNK):
        k = torch.arange(c0, c0 + CHUNK, device=device)
        live = k[None, :] < counts[:, None]                       # (T, K)
        idx = torch.clamp(starts[:, None] + k[None, :], max=n_pairs - 1)
        rows = table[pairs.pair_gauss[idx].to(torch.int64)]      # (T, K, C)
        quad = shift_to_tile(rows, tile_x, tile_y)
        quad[..., 5] = torch.where(live, quad[..., 5], NEG_INF)
        power = tile_power(quad)                                  # (T, PIX, K)
        logop = rows[..., ROW_LOGOP][:, None, :]

        w, t_out, done_m, fail = chunk_weights(power, logop, t_buf, done)
        # an entry no pixel of its tile composites passes zeros by select,
        # so a NaN in its channels reaches neither the image nor a gradient
        feats = torch.where((w > 0).any(1)[..., None], blend_features(rows),
                            0.0)
        out = out + torch.bmm(w, feats)

        # evaluated: live entries not behind an earlier stop
        fail_i = fail.to(torch.int32)
        stopped = done[..., None] | (torch.cumsum(fail_i, -1) - fail_i > 0)
        n_eval += (live[:, None, :] & ~stopped).sum(-1, dtype=torch.int32)
        t_buf, done = t_out, done_m[..., -1]
    return out, t_buf, n_eval


def raster_scan_vjp(table: torch.Tensor, pairs: PairList, gx: int,
                    g_blend: torch.Tensor, g_t_final: torch.Tensor):
    """Plain version of kernel 1': autograd through ``raster_scan``.

    Returns d_table (N, 16 + E); NO_GRAD_COLS, whose upstream gradient is
    zero anyway, are zeroed, as kernel 1' leaves them."""
    with torch.enable_grad():
        t = table.detach().requires_grad_(True)
        blend, t_final, _ = raster_scan(t, pairs, gx)
        d_table = None
        if blend.requires_grad:  # else no tile has a pair
            (d_table,) = torch.autograd.grad((blend, t_final), (t,),
                                             (g_blend, g_t_final),
                                             allow_unused=True)
    d_table = torch.zeros_like(table) if d_table is None else d_table
    d_table[:, list(NO_GRAD_COLS)] = 0.0
    return d_table


def _check_args(name: str, table, pairs: PairList) -> int:
    """Refuses kernel 1's (or 1''s) common arguments where its C entry
    cannot take them; returns the blend channel count F."""
    _build.require(name, "table", table, like=table, shape=(None, None))
    n_f = table.shape[1] - TABLE_FIXED + N_FIXED_F
    if n_f not in KERNEL_F:
        raise ValueError(f"{name}: {n_f} blend channels, the kernel takes "
                         f"{' or '.join(map(str, KERNEL_F))}")
    require_pairs(name, pairs, table)
    return n_f


@spanned("kernel.raster")
def raster_pairs_forward(table: torch.Tensor, pairs: PairList, gx: int):
    """Kernel 1 without autograd: blend channels, T_final and evaluated-pair
    counts of every tile (shapes: ``raster_scan``).  CPU tensors take the
    plain version; CUDA tensors launch csrc/raster.cu, whose blocks take
    the tiles in the pair list's ``tile_order``, heaviest first (computed
    here for a list without one).  Every render sets the order, where no
    gradient follows too: its sort (5 launches, 0.028 ms on the H100)
    costs less device time than the order saves kernel 1 (0.05 ms at F = 7,
    0.08 ms at F = 10).  The order changes no output bit."""
    if table.device.type == "cpu":
        return raster_scan(table, pairs, gx)
    n_f = _check_args("raster_pairs", table, pairs)
    n_tiles = pairs.tile_counts.shape[0]
    dev = table.device
    order = tile_order_arg("raster_pairs", pairs, dev)
    blend = torch.empty((n_tiles, PIX, n_f), device=dev)
    t_final = torch.empty((n_tiles, PIX), device=dev)
    n_eval = torch.empty((n_tiles, PIX), dtype=torch.int32, device=dev)
    # the C entry launches nothing for an empty grid
    _build.launch("raster", "raster_forward", "PiPPPPiiiPPP", table,
                  table.shape[1], pairs.pair_gauss, pairs.tile_start,
                  pairs.tile_end, order, n_tiles, gx, n_f, blend, t_final,
                  n_eval, like=table, counter=raster_pairs,
                  launched=n_tiles > 0)
    return blend, t_final, n_eval


@spanned("kernel.raster_bwd")
def raster_pairs_backward(table: torch.Tensor, pairs: PairList, gx: int,
                          blend: torch.Tensor, t_final: torch.Tensor,
                          g_blend: torch.Tensor, g_t_final: torch.Tensor):
    """Kernel 1': the VJP of kernel 1 into d_table.  blend and t_final are
    kernel 1's outputs for these arguments and g_* their cotangents.  CPU
    tensors take the plain version (``raster_scan_vjp``); CUDA tensors
    launch csrc/raster_bwd.cu."""
    if table.device.type == "cpu":
        return raster_scan_vjp(table, pairs, gx, g_blend, g_t_final)
    name = "raster_pairs_backward"
    n_f = _check_args(name, table, pairs)
    n_tiles = pairs.tile_counts.shape[0]
    for arg, t in (("blend", blend), ("g_blend", g_blend)):
        _build.require(name, arg, t, like=table, shape=(n_tiles, PIX, n_f))
    for arg, t in (("t_final", t_final), ("g_t_final", g_t_final)):
        _build.require(name, arg, t, like=table, shape=(n_tiles, PIX))
    order = tile_order_arg(name, pairs, table.device)
    d_table = torch.zeros_like(table)
    _build.launch("raster_bwd", "raster_backward", "PiPPPPiiiPPPPP", table,
                  table.shape[1], pairs.pair_gauss, pairs.tile_start,
                  pairs.tile_end, order, n_tiles, gx, n_f, blend, t_final,
                  g_blend, g_t_final, d_table, like=table,
                  counter=raster_pairs_backward, launched=n_tiles > 0)
    return d_table


class _RasterPairs(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, pairs, gx):
        blend, t_final, n_eval = raster_pairs_forward(table, pairs, gx)
        ctx.save_for_backward(table, blend, t_final)
        ctx.args = (pairs, gx)
        ctx.mark_non_differentiable(n_eval)
        return blend, t_final, n_eval

    @staticmethod
    def backward(ctx, g_blend, g_t_final, _g_n_eval):
        table, blend, t_final = ctx.saved_tensors
        d_table = raster_pairs_backward(table, *ctx.args, blend, t_final,
                                        g_blend.contiguous(),
                                        g_t_final.contiguous())
        return d_table, None, None


def raster_pairs(table: torch.Tensor, pairs: PairList, gx: int):
    """Blend channels, T_final and evaluated-pair counts of every tile
    (shapes: ``raster_scan``), differentiable in ``table`` (``n_eval``
    carries no gradient).  The forward is one launch of kernel 1 on CUDA
    tensors, the backward one of kernel 1'."""
    return _RasterPairs.apply(table, pairs, gx)


raster_pairs.launches = 0
raster_pairs_backward.launches = 0
