"""Tile-rasterizer building blocks (port of texgs/kernels/tile_raster.py).

The Gaussian log-density at a pixel is a quadratic in the pixel
coordinates.  Its six coefficients are kept in each Gaussian's own anchor
tile frame (``build_gauss_table``) and shifted per pair into the covered
tile's frame (``shift_to_tile``), so the exponent is evaluated in
*tile-local* pixel coordinates (0..15), where f32 keeps its precision;
global coordinates squared would not.

``chunk_weights``/``chunk_blend`` are the front-to-back weights of one
depth-ordered chunk of pairs, with the 3DGS sequential-stop semantics
reproduced exactly (texgs.kernels.reference).  They form the plain versions
of kernel 1 (texgs_torch.kernels.raster, the stage-1/2 blend) and of the
blend half of the fused stage-3 kernel (texgs_torch.kernels.uvtex_fused).
"""

from __future__ import annotations

from typing import Optional

import torch

from texgs_torch.kernels.binning import (build_pairs, grid_shape,
                                         with_tile_order)
from texgs_torch.kernels.project import ProjectedGaussians
from texgs_torch.kernels.reference import (ALPHA_CLAMP, MIN_ALPHA, T_STOP,
                                           TILE, RasterOutput)

# Columns of the per-Gaussian table (N, TABLE_FIXED + n_extra):
#   0..5: quadratic exponent coefficients [x^2, y^2, x*y, x, y, 1] in the
#         anchor-tile frame (log-opacity folded into the constant)
#   6:    log-opacity (recovers the raw exponent for the power > 0 skip)
#   7..9: rgb; 10: view depth; 11..13: world normal
#   14, 15: anchor tile corner (x, y) in pixels
#   16..: extra blend channels
N_QUAD = 6
ROW_LOGOP = 6
ROW_F0 = 7
N_FIXED_F = 7  # rgb(3) + depth(1) + normal(3)
COL_ANCHOR = 14
TABLE_FIXED = 16
PIX = TILE * TILE  # pixels per tile
NEG_INF = -1e20


def tile_basis(device=None, dtype=torch.float32) -> torch.Tensor:
    """(PIX, 6) polynomial basis of tile-local pixel coords."""
    idx = torch.arange(PIX, device=device)
    x = (idx % TILE).to(dtype)
    y = (idx // TILE).to(dtype)
    return torch.stack([x * x, y * y, x * y, x, y, torch.ones_like(x)], dim=-1)


def tile_power(quad: torch.Tensor) -> torch.Tensor:
    """Exponent at the 256 tile-local pixels: quad (..., K, 6) -> (..., PIX, K).

    Evaluated term by term, left to right, one rounding per operation: the
    CUDA kernel (csrc/uvtex_fused.cu) rounds the same operations in the same
    order, so both see the same exponent bit for bit."""
    basis = tile_basis(quad.device, quad.dtype)
    x, y = basis[:, 3:4], basis[:, 4:5]                  # (PIX, 1)
    q = [quad[..., None, :, i] for i in range(N_QUAD)]   # (..., 1, K)
    return x * x * q[0] + y * y * q[1] + x * y * q[2] + x * q[3] + y * q[4] + q[5]


def build_gauss_table(proj: ProjectedGaussians,
                      extra_attrs: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-Gaussian packed attribute table (N, 16 + n_extra).

    The quadratic coefficients are expressed relative to each Gaussian's
    anchor tile corner (columns 14/15), where they are O(10), so the
    per-pair shift to the covered tile's frame stays well-conditioned."""
    mx, my = proj.means2d[:, 0], proj.means2d[:, 1]
    a, b, c = proj.conics.unbind(dim=1)
    logop = torch.log(torch.clamp(proj.opacities, min=1e-12))

    anchor_x = torch.floor(mx / TILE) * TILE
    anchor_y = torch.floor(my / TILE) * TILE
    mxa = mx - anchor_x
    mya = my - anchor_y

    qxx = -0.5 * a
    qyy = -0.5 * c
    qxy = -b
    qx = a * mxa + b * mya
    qy = c * mya + b * mxa
    qc = -0.5 * (a * mxa * mxa + c * mya * mya) - b * mxa * mya + logop

    cols = [qxx, qyy, qxy, qx, qy, qc, logop,
            proj.colors[:, 0], proj.colors[:, 1], proj.colors[:, 2],
            proj.depths,
            proj.normals[:, 0], proj.normals[:, 1], proj.normals[:, 2],
            anchor_x, anchor_y]
    if extra_attrs is not None:
        cols.extend(extra_attrs.unbind(dim=1))
    return torch.stack(cols, dim=1).contiguous()


def shift_to_tile(rows: torch.Tensor, tile_x: torch.Tensor,
                  tile_y: torch.Tensor) -> torch.Tensor:
    """Shift gathered table rows' anchor-frame quadratic into the frame of
    the tile whose corner is (tile_x, tile_y) pixels.  Returns (..., 6)
    coefficients [x^2, y^2, x*y, x, y, 1] (texgs build_pair_attrs)."""
    dtx = tile_x - rows[..., COL_ANCHOR]
    dty = tile_y - rows[..., COL_ANCHOR + 1]
    qxx, qyy, qxy = rows[..., 0], rows[..., 1], rows[..., 2]
    qx_a, qy_a, qc_a = rows[..., 3], rows[..., 4], rows[..., 5]
    qx = qx_a + 2.0 * qxx * dtx + qxy * dty
    qy = qy_a + 2.0 * qyy * dty + qxy * dtx
    qc = (qc_a + qxx * dtx * dtx + qyy * dty * dty + qxy * dtx * dty
          + qx_a * dtx + qy_a * dty)
    return torch.stack([qxx, qyy, qxy, qx, qy, qc], dim=-1)


def blend_features(rows: torch.Tensor) -> torch.Tensor:
    """The blendable channels of gathered table rows: rgb, depth, normal,
    extras -> (..., 7 + n_extra)."""
    return torch.cat([rows[..., ROW_F0:COL_ANCHOR], rows[..., TABLE_FIXED:]],
                     dim=-1)


def _exclusive_cumprod(x: torch.Tensor) -> torch.Tensor:
    return torch.cat([torch.ones_like(x[..., :1]),
                      torch.cumprod(x[..., :-1], dim=-1)], dim=-1)


def chunk_weights(power: torch.Tensor, logop: torch.Tensor,
                  t_in: torch.Tensor, done_in: torch.Tensor):
    """Front-to-back weights of one depth-ordered chunk.

    power: (..., PIX, K) exponent incl. log-opacity; logop: (..., 1, K);
    t_in/done_in: (..., PIX) incoming transmittance and stop flags.
    Returns (w, t_out, done, fail): w (..., PIX, K); t_out (..., PIX);
    done (..., PIX, K) inclusive stop flags; fail (..., PIX, K) the
    entries that trip the T < 1e-4 stop.
    """
    alpha = torch.clamp(torch.exp(power), max=ALPHA_CLAMP)
    # CUDA-parity skips: raw exponent > 0, or alpha below threshold
    alpha = torch.where(power - logop > 0.0, 0.0, alpha)
    alpha = torch.where(alpha < MIN_ALPHA, 0.0, alpha)
    one_minus = 1.0 - alpha
    t_excl = t_in[..., None] * _exclusive_cumprod(one_minus)
    fail = t_excl * one_minus < T_STOP
    done = done_in[..., None] | (torch.cumsum(fail.to(torch.int32), -1) > 0)
    w = alpha * t_excl * (~done)
    t_out = t_in * torch.prod(torch.where(done, 1.0, one_minus), dim=-1)
    return w, t_out, done, fail


def chunk_blend(power, logop, f_attrs, t_in, done_in):
    """Blend one chunk of Gaussians into one tile.

    power: (PIX, K); logop: (K,); f_attrs: (K, F); t_in: (PIX,);
    done_in: (PIX,) bool.  Returns (out (PIX, F), t_out (PIX,),
    done_out (PIX,))."""
    w, t_out, done, _ = chunk_weights(power, logop[None, :], t_in, done_in)
    return w @ f_attrs, t_out, done[:, -1]


def tiles_to_image(tiles: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """(T, PIX, C) per-tile pixels -> (C, H, W) image."""
    gy, gx = grid_shape(height, width)
    c = tiles.shape[-1]
    img = tiles.reshape(gy, gx, TILE, TILE, c)
    img = img.permute(4, 0, 2, 1, 3).reshape(c, gy * TILE, gx * TILE)
    return img[:, :height, :width]


def assemble_image(tiles_out: torch.Tensor, t_final: torch.Tensor,
                   height: int, width: int, bg: torch.Tensor, n_extra: int,
                   normalize_depth: bool = True) -> RasterOutput:
    """(T, PIX, F) tile buffers -> full-image RasterOutput."""
    img = tiles_to_image(tiles_out, height, width)
    t_fin = tiles_to_image(t_final[..., None], height, width)

    acc = 1.0 - t_fin
    rgb = img[0:3] + t_fin * bg[:, None, None]
    dep = img[3:4]
    if normalize_depth:
        dep = dep / torch.clamp(acc, min=1e-6)
    nrm = img[4:7]
    extra = img[7:7 + n_extra] if n_extra else None
    return RasterOutput(image=rgb, depth=dep, norm=nrm, alpha=acc, extra=extra)


def rasterize_tiled(proj: ProjectedGaussians, height: int, width: int,
                    bg: torch.Tensor,
                    normalize_depth: bool = True) -> RasterOutput:
    """Tile-binned rasterization of the rgb, depth and normal channels
    (texgs ``rasterize_tiled``, :278): ``build_pairs`` ->
    ``build_gauss_table`` -> kernel 1 (``raster_pairs``, differentiable in
    ``proj``) -> ``assemble_image``.  The port has one path, so texgs's
    ``backend`` and ``chunk`` have no counterpart, and it keeps every pair
    (texgs caps them at max(4N, 2^14) and flags an overflow)."""
    from texgs_torch.kernels.raster import raster_pairs

    pairs = build_pairs(proj.means2d, proj.depths, proj.radii, height, width)
    table = build_gauss_table(proj)
    # kernels 1 and 1' take the tiles heaviest first
    pairs = with_tile_order(pairs)
    tiles_out, t_final, _ = raster_pairs(table, pairs,
                                         grid_shape(height, width)[1])
    out = assemble_image(tiles_out, t_final, height, width, bg, 0,
                         normalize_depth)
    return out._replace(n_pairs=pairs.n_pairs, overflowed=pairs.overflowed)
