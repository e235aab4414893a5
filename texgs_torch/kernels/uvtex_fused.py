"""Kernel A and its backward A': blend channels + per-pixel M-lists in one
pass (stage 3), differentiable.

Replaces the TPU kernel ``fused_pairs`` of
texgs/kernels/pallas_uvtex_fused.py:263 (forward ``_fused_fwd_kernel``,
:45; backward ``_fused_bwd_kernel``, :117).  The CUDA kernels are
csrc/uvtex_fused.cu and csrc/uvtex_fused_bwd.cu; their source comments
give the designs and the semantics they keep.  ``mlist_scan`` below is the
forward's plain PyTorch version: texgs's ``chunk_blend`` blend plus its
``mlist_scan`` M-list, walked over chunks of each tile's depth-sorted pairs
with all tiles in one batch; ``mlist_scan_vjp`` (autograd through it) is
the backward's.

``fused_pairs`` is differentiable in the table and the uv rows; its
backward calls ``fused_pairs_backward``.  Both run the plain version only
for tensors on the CPU; for CUDA tensors they launch their kernel or
raise.  Each launch adds one to ``fused_pairs.launches`` or
``fused_pairs_backward.launches``.
"""

from __future__ import annotations

import numpy as np
import torch

from texgs_torch import _build
from texgs_torch.kernels.binning import (PairList, require_pairs,
                                         tile_order_arg)
from texgs_torch.kernels.reference import TILE
from texgs_torch.kernels.tile_raster import (COL_ANCHOR, N_FIXED_F, NEG_INF,
                                             PIX, ROW_LOGOP, TABLE_FIXED,
                                             blend_features, chunk_weights,
                                             shift_to_tile, tile_basis,
                                             tile_power)
from texgs_torch.kernels.uvtex_raster import UV_COLS, intersect_uv
from texgs_torch.utils.spans import spanned

# blend channels the kernel is instantiated for: rgb, depth and normal, and
# those plus the 3 no-SH channels of rasterize_uvtex
KERNEL_F = (7, 10)
CHUNK = 64  # pairs of each tile the plain version takes per step


def _tile_rays(rays: np.ndarray, n_tiles: int, gx: int, device,
               tile0: int = 0):
    """Per-tile corner (tile_x, tile_y) and the (T, PIX, 3) pixel rays of
    the frame tiles tile0 .. tile0 + n_tiles - 1."""
    tiles = torch.arange(tile0, tile0 + n_tiles, device=device)
    tile_x = ((tiles % gx) * TILE).to(torch.float32)
    tile_y = ((tiles // gx) * TILE).to(torch.float32)
    basis = tile_basis(device)
    px = tile_x[:, None] + basis[None, :, 3]
    py = tile_y[:, None] + basis[None, :, 4]
    r = torch.as_tensor(rays, device=device)
    d = r[2] + px[..., None] * r[0] + py[..., None] * r[1]
    return tile_x, tile_y, d


def mlist_scan(table: torch.Tensor, uv_rows: torch.Tensor, pairs: PairList,
               rays: np.ndarray, gx: int, m: int, tile0: int = 0):
    """Plain version of kernel A.

    table: (N, 16 + E) from tile_raster.build_gauss_table; uv_rows:
    (N, 24) from uvtex_raster.build_uv_rows; rays: (3, 3) [ax, by, c0].
    Returns (tiles_out (T, PIX, F), t_final (T, PIX), mlist
    (T, PIX, m, 4) of [w, uv] slots, n_eval (T, PIX) int32: the pairs of
    its tile each pixel evaluated, the one that stopped it included).
    tile0: the frame tile that the pair list's first tile is (a band of
    whole tile rows; 0 for a whole frame).
    """
    device = table.device
    n_tiles = pairs.tile_counts.shape[0]
    n_f = table.shape[1] - TABLE_FIXED + N_FIXED_F
    tile_x, tile_y, d = _tile_rays(rays, n_tiles, gx, device, tile0)

    out = torch.zeros((n_tiles, PIX, n_f), device=device)
    t_buf = torch.ones((n_tiles, PIX), device=device)
    done = torch.zeros((n_tiles, PIX), dtype=torch.bool, device=device)
    count = torch.zeros((n_tiles, PIX), dtype=torch.int64, device=device)
    n_eval = torch.zeros((n_tiles, PIX), dtype=torch.int32, device=device)
    mlist = torch.zeros((n_tiles * PIX * m, 4), device=device)

    counts = pairs.tile_counts.to(torch.int64)
    starts = pairs.tile_start.to(torch.int64)
    n_pairs = pairs.pair_gauss.shape[0]
    max_count = int(counts.max()) if n_tiles else 0
    for c0 in range(0, max_count, CHUNK):
        k = torch.arange(c0, c0 + CHUNK, device=device)
        live = k[None, :] < counts[:, None]                       # (T, K)
        idx = torch.clamp(starts[:, None] + k[None, :], max=n_pairs - 1)
        g = pairs.pair_gauss[idx].to(torch.int64)
        rows = table[g]                                           # (T, K, C)
        quad = shift_to_tile(rows, tile_x[:, None], tile_y[:, None])
        quad[..., 5] = torch.where(live, quad[..., 5], NEG_INF)
        power = tile_power(quad)                                  # (T, PIX, K)
        logop = rows[..., ROW_LOGOP][:, None, :]

        w, t_out, done_m, fail = chunk_weights(power, logop, t_buf, done)
        out += torch.bmm(w, blend_features(rows))

        # evaluated: live entries not behind an earlier stop
        failed_before = torch.cumsum(fail.to(torch.int32), -1) - fail.to(torch.int32)
        stopped = done[..., None] | (failed_before > 0)
        n_eval += (live[:, None, :] & ~stopped).sum(-1, dtype=torch.int32)

        # M-list: the accepted entries (w > 0) of rank < m, scattered by rank
        accept = w > 0.0
        acc_i = accept.to(torch.int64)
        rank = count[..., None] + torch.cumsum(acc_i, -1) - acc_i
        ti, pi, ki = torch.nonzero(accept & (rank < m), as_tuple=True)
        if ti.numel():
            uv = intersect_uv(d[ti, pi], uv_rows[g[ti, ki]])
            slot = (ti * PIX + pi) * m + rank[ti, pi, ki]
            mlist[slot] = torch.cat([w[ti, pi, ki, None], uv], dim=-1)
        count += acc_i.sum(-1)
        t_buf, done = t_out, done_m[..., -1]
    return out, t_buf, mlist.view(n_tiles, PIX, m, 4), n_eval


# table columns with no gradient: the log-opacity (read only by the
# power > 0 skip) and the anchor corner (a floor of the projected mean)
NO_GRAD_COLS = (ROW_LOGOP, COL_ANCHOR, COL_ANCHOR + 1)
UV_GRAD_COLS = 12  # sv, siginv, base_uv; J is a constant of the render


def mlist_scan_vjp(table: torch.Tensor, uv_rows: torch.Tensor,
                   pairs: PairList, rays: np.ndarray, gx: int, m: int,
                   g_blend: torch.Tensor, g_t_final: torch.Tensor,
                   g_mlist: torch.Tensor):
    """Plain version of kernel A': autograd through ``mlist_scan``.

    Returns (d_table (N, 16 + E), d_uv_rows (N, 24)).  The columns kernel
    A' leaves at zero are zeroed here too: NO_GRAD_COLS of the table, whose
    upstream gradient is zero anyway, and the J columns of the uv rows,
    which the render detaches (as texgs's kernel does).  Only the slots an
    entry was written to pass a cotangent: a dead slot's is not read."""
    with torch.enable_grad():
        t = table.detach().requires_grad_(True)
        u = uv_rows.detach().requires_grad_(True)
        blend, t_final, mlist, _ = mlist_scan(t, u, pairs, rays, gx, m)
        d_table = d_uv = None
        if blend.requires_grad:  # else no tile has a pair
            d_table, d_uv = torch.autograd.grad(
                (blend, t_final, mlist), (t, u),
                (g_blend, g_t_final, g_mlist), allow_unused=True)
    d_table = torch.zeros_like(table) if d_table is None else d_table
    d_uv = torch.zeros_like(uv_rows) if d_uv is None else d_uv
    d_table[:, list(NO_GRAD_COLS)] = 0.0
    d_uv[:, UV_GRAD_COLS:] = 0.0
    return d_table, d_uv


def check_pair_args(name: str, table, uv_rows, pairs: PairList, m: int):
    """Refuses the arguments kernels A, A', 2 and 2' share where their C
    entries cannot take them."""
    _build.require(name, "table", table, like=table, shape=(None, None))
    if table.shape[1] < TABLE_FIXED:
        raise ValueError(f"{name}: table must be (N, >= {TABLE_FIXED}), got "
                         f"{tuple(table.shape)}")
    if m < 1:
        raise ValueError(f"{name}: m must be >= 1, got {m}")
    _build.require(name, "uv_rows", uv_rows, like=table,
                   shape=(table.shape[0], UV_COLS))
    require_pairs(name, pairs, table)


def _check_args(name: str, table, uv_rows, pairs: PairList, m: int) -> int:
    """Refuses kernel A's (or A''s) common arguments where its C entry
    cannot take them; returns the blend channel count F."""
    check_pair_args(name, table, uv_rows, pairs, m)
    n_f = table.shape[1] - TABLE_FIXED + N_FIXED_F
    if n_f not in KERNEL_F:
        raise ValueError(f"{name}: {n_f} blend channels, the kernel "
                         f"takes {' or '.join(map(str, KERNEL_F))}")
    return n_f


def rays9(rays: np.ndarray) -> np.ndarray:
    """The (3, 3) ray constants as the C entries take them: 9 host floats."""
    return np.ascontiguousarray(rays, dtype=np.float32)


@spanned("kernel.uvtex_fused")
def fused_pairs_forward(table: torch.Tensor, uv_rows: torch.Tensor,
                        pairs: PairList, rays: np.ndarray, gx: int, m: int):
    """Kernel A without autograd: blend channels, T_final, M-lists and
    evaluated-pair counts of every tile (shapes: ``mlist_scan``).  CPU
    tensors take the plain version; CUDA tensors launch
    csrc/uvtex_fused.cu, which takes the tiles in the pair list's
    ``tile_order`` (heaviest first; computed here for a list without
    one).  The order changes no output."""
    if table.device.type == "cpu":
        return mlist_scan(table, uv_rows, pairs, rays, gx, m)
    n_f = _check_args("fused_pairs", table, uv_rows, pairs, m)
    n_tiles = pairs.tile_counts.shape[0]
    dev = table.device
    order = tile_order_arg("fused_pairs", pairs, dev)
    blend = torch.empty((n_tiles, PIX, n_f), device=dev)
    t_final = torch.empty((n_tiles, PIX), device=dev)
    mlist = torch.empty((n_tiles, PIX, m, 4), device=dev)
    n_eval = torch.empty((n_tiles, PIX), dtype=torch.int32, device=dev)
    # the C entry launches nothing for an empty grid
    _build.launch("uvtex_fused", "uvtex_fused_forward", "PiPPPPPPiiiiPPPP",
                  table, table.shape[1], uv_rows, pairs.pair_gauss,
                  pairs.tile_start, pairs.tile_end, order, rays9(rays),
                  n_tiles, gx, n_f, m, blend, t_final, mlist, n_eval,
                  like=table, counter=fused_pairs, launched=n_tiles > 0)
    return blend, t_final, mlist, n_eval


@spanned("kernel.uvtex_fused_bwd")
def fused_pairs_backward(table: torch.Tensor, uv_rows: torch.Tensor,
                         pairs: PairList, rays: np.ndarray, gx: int, m: int,
                         blend: torch.Tensor, t_final: torch.Tensor,
                         mlist: torch.Tensor, g_blend: torch.Tensor,
                         g_t_final: torch.Tensor, g_mlist: torch.Tensor):
    """Kernel A': the VJP of kernel A into (d_table, d_uv_rows).  blend,
    t_final and mlist are kernel A's outputs for these arguments and g_*
    their cotangents.  CPU tensors take the plain version
    (``mlist_scan_vjp``); CUDA tensors launch csrc/uvtex_fused_bwd.cu."""
    if table.device.type == "cpu":
        return mlist_scan_vjp(table, uv_rows, pairs, rays, gx, m, g_blend,
                              g_t_final, g_mlist)
    name = "fused_pairs_backward"
    n_f = _check_args(name, table, uv_rows, pairs, m)
    n_tiles = pairs.tile_counts.shape[0]
    for arg, t in (("blend", blend), ("g_blend", g_blend)):
        _build.require(name, arg, t, like=table, shape=(n_tiles, PIX, n_f))
    for arg, t in (("t_final", t_final), ("g_t_final", g_t_final)):
        _build.require(name, arg, t, like=table, shape=(n_tiles, PIX))
    for arg, t in (("mlist", mlist), ("g_mlist", g_mlist)):
        _build.require(name, arg, t, like=table, shape=(n_tiles, PIX, m, 4),
                       align16=True)
    d_table = torch.zeros_like(table)
    d_uv = torch.zeros_like(uv_rows)
    _build.launch("uvtex_fused_bwd", "uvtex_fused_backward",
                  "PiPPPPPiiiiPPPPPPPP", table, table.shape[1], uv_rows,
                  pairs.pair_gauss, pairs.tile_start, pairs.tile_end,
                  rays9(rays), n_tiles, gx, n_f, m, blend, t_final, mlist,
                  g_blend, g_t_final, g_mlist, d_table, d_uv, like=table,
                  counter=fused_pairs_backward, launched=n_tiles > 0)
    return d_table, d_uv


class _FusedPairs(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, uv_rows, pairs, rays, gx, m):
        blend, t_final, mlist, n_eval = fused_pairs_forward(
            table, uv_rows, pairs, rays, gx, m)
        ctx.save_for_backward(table, uv_rows, blend, t_final, mlist)
        ctx.args = (pairs, rays, gx, m)
        ctx.mark_non_differentiable(n_eval)
        return blend, t_final, mlist, n_eval

    @staticmethod
    def backward(ctx, g_blend, g_t_final, g_mlist, _g_n_eval):
        table, uv_rows, blend, t_final, mlist = ctx.saved_tensors
        d_table, d_uv = fused_pairs_backward(
            table, uv_rows, *ctx.args, blend, t_final, mlist,
            g_blend.contiguous(), g_t_final.contiguous(), g_mlist.contiguous())
        return d_table, d_uv, None, None, None, None


def fused_pairs(table: torch.Tensor, uv_rows: torch.Tensor, pairs: PairList,
                rays: np.ndarray, gx: int, m: int):
    """Blend channels, T_final, M-lists and evaluated-pair counts of every
    tile (shapes: ``mlist_scan``), differentiable in ``table`` and
    ``uv_rows`` (``n_eval`` carries no gradient).  The forward is one launch
    of kernel A on CUDA tensors, the backward one of kernel A'."""
    return _FusedPairs.apply(table, uv_rows, pairs, rays, gx, m)


fused_pairs.launches = 0
fused_pairs_backward.launches = 0
