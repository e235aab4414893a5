"""Kernel A: blend channels + per-pixel M-lists in one pass (stage 3).

Replaces the TPU kernel ``fused_pairs`` of
texgs/kernels/pallas_uvtex_fused.py:263 (forward ``_fused_fwd_kernel``,
:45).  The CUDA kernel is csrc/uvtex_fused.cu; its source comment gives
the design and the semantics it keeps.  ``mlist_scan`` below is its plain
PyTorch version: texgs's ``chunk_blend`` blend plus its ``mlist_scan``
M-list, walked over chunks of each tile's depth-sorted pairs with all
tiles in one batch.

``fused_pairs`` runs the plain version only for tensors on the CPU; for
CUDA tensors it launches the kernel or raises.  Each launch adds one to
``fused_pairs.launches``.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from texgs_torch import _build
from texgs_torch.kernels.binning import PairList
from texgs_torch.kernels.reference import TILE
from texgs_torch.kernels.tile_raster import (N_FIXED_F, NEG_INF, PIX,
                                             ROW_LOGOP, TABLE_FIXED,
                                             blend_features, chunk_weights,
                                             shift_to_tile, tile_basis,
                                             tile_power)
from texgs_torch.kernels.uvtex_raster import UV_COLS, intersect_uv

# blend channels the kernel is instantiated for: rgb, depth and normal, and
# those plus the 3 no-SH channels of rasterize_uvtex
KERNEL_F = (7, 10)
CHUNK = 64  # pairs of each tile the plain version takes per step


def _tile_rays(rays: np.ndarray, n_tiles: int, gx: int, device):
    """Per-tile corner (tile_x, tile_y) and the (T, PIX, 3) pixel rays."""
    tiles = torch.arange(n_tiles, device=device)
    tile_x = ((tiles % gx) * TILE).to(torch.float32)
    tile_y = ((tiles // gx) * TILE).to(torch.float32)
    basis = tile_basis(device)
    px = tile_x[:, None] + basis[None, :, 3]
    py = tile_y[:, None] + basis[None, :, 4]
    r = torch.as_tensor(rays, device=device)
    d = r[2] + px[..., None] * r[0] + py[..., None] * r[1]
    return tile_x, tile_y, d


def mlist_scan(table: torch.Tensor, uv_rows: torch.Tensor, pairs: PairList,
               rays: np.ndarray, gx: int, m: int):
    """Plain version of kernel A.

    table: (N, 16 + E) from tile_raster.build_gauss_table; uv_rows:
    (N, 24) from uvtex_raster.build_uv_rows; rays: (3, 3) [ax, by, c0].
    Returns (tiles_out (T, PIX, F), t_final (T, PIX), mlist
    (T, PIX, m, 4) of [w, uv] slots, n_eval (T, PIX) int32: the pairs of
    its tile each pixel evaluated, the one that stopped it included).
    """
    device = table.device
    n_tiles = pairs.tile_counts.shape[0]
    n_f = table.shape[1] - TABLE_FIXED + N_FIXED_F
    tile_x, tile_y, d = _tile_rays(rays, n_tiles, gx, device)

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


def _lib() -> ctypes.CDLL:
    lib = _build.load("uvtex_fused")
    fn = lib.uvtex_fused_forward
    if fn.argtypes is None:
        p = ctypes.c_void_p
        fn.argtypes = [p, ctypes.c_int, p, p, p, p,
                       ctypes.POINTER(ctypes.c_float), ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int, p, p, p, p, p]
        fn.restype = ctypes.c_int
    return lib


def fused_pairs(table: torch.Tensor, uv_rows: torch.Tensor, pairs: PairList,
                rays: np.ndarray, gx: int, m: int):
    """Blend channels, T_final, M-lists and evaluated-pair counts of every
    tile; see ``mlist_scan`` for the shapes.  CPU tensors take the plain
    version; CUDA tensors launch csrc/uvtex_fused.cu."""
    if table.device.type == "cpu":
        return mlist_scan(table, uv_rows, pairs, rays, gx, m)
    if table.device.type != "cuda":
        raise ValueError(f"fused_pairs: unsupported device {table.device}")
    n_tiles = pairs.tile_counts.shape[0]
    n_f = table.shape[1] - TABLE_FIXED + N_FIXED_F
    if n_f not in KERNEL_F:
        raise ValueError(f"fused_pairs: {n_f} blend channels, the kernel "
                         f"takes {' or '.join(map(str, KERNEL_F))}")
    if m < 1:
        raise ValueError(f"fused_pairs: m must be >= 1, got {m}")
    for name, t, dtype in (("table", table, torch.float32),
                           ("uv_rows", uv_rows, torch.float32),
                           ("pair_gauss", pairs.pair_gauss, torch.int32),
                           ("tile_start", pairs.tile_start, torch.int32),
                           ("tile_end", pairs.tile_end, torch.int32)):
        if t.device != table.device or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"fused_pairs: {name} must be a contiguous "
                             f"{dtype} tensor on {table.device}")
    if uv_rows.shape != (table.shape[0], UV_COLS):
        raise ValueError(f"fused_pairs: uv_rows must be ({table.shape[0]}, "
                         f"{UV_COLS}), got {tuple(uv_rows.shape)}")

    dev = table.device
    blend = torch.empty((n_tiles, PIX, n_f), device=dev)
    t_final = torch.empty((n_tiles, PIX), device=dev)
    mlist = torch.empty((n_tiles, PIX, m, 4), device=dev)
    n_eval = torch.empty((n_tiles, PIX), dtype=torch.int32, device=dev)
    rays9 = (ctypes.c_float * 9)(*np.asarray(rays, np.float32).reshape(-1))
    p = _build.ptr
    err = _lib().uvtex_fused_forward(
        p(table), table.shape[1], p(uv_rows), p(pairs.pair_gauss),
        p(pairs.tile_start), p(pairs.tile_end), rays9, n_tiles, gx, n_f, m,
        p(blend), p(t_final), p(mlist), p(n_eval), _build.stream_of(table))
    if err:
        raise RuntimeError(f"uvtex_fused_forward failed: CUDA error {err}")
    fused_pairs.launches += 1
    return blend, t_final, mlist, n_eval


fused_pairs.launches = 0
