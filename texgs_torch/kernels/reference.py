"""Rasterizer constants, the output record, the tile-rect rule and the
dense oracle (port of texgs/kernels/reference.py).

Blending follows the sequential semantics of the 3DGS CUDA rasterizer:
  alpha_i = min(0.99, opacity_i * exp(power)), skipped when power > 0 or
  alpha < 1/255; front-to-back transmittance T with a hard stop *before*
  the Gaussian that would push T below 1e-4.
The oracle, ``rasterize_reference``, composites every Gaussian at every
pixel in plain torch (texgs runs it in plain XLA, outside any Pallas
kernel): the correctness reference of the tiled path, and the renderer of
``backend: reference``.  It covers pixels with the binner's tile-rect
rule, so it and the tiled kernels make the same coverage decisions.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

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


def gaussian_alpha(px, py, means2d, conics, opacities):
    """Raw blending alpha of each Gaussian at each pixel.

    px/py: (P,) pixel centres; Gaussian tensors: (K, ...).  Returns (P, K).
    """
    dx = px[:, None] - means2d[None, :, 0]
    dy = py[:, None] - means2d[None, :, 1]
    a, b, c = conics[:, 0], conics[:, 1], conics[:, 2]
    power = -0.5 * (a[None, :] * dx * dx + c[None, :] * dy * dy) \
        - b[None, :] * dx * dy
    alpha = torch.clamp(opacities[None, :] * torch.exp(power),
                        max=ALPHA_CLAMP)
    alpha = torch.where(power > 0.0, 0.0, alpha)
    return torch.where(alpha < MIN_ALPHA, 0.0, alpha)


def _blend_chunk(alpha: torch.Tensor, carry=None):
    """``blend_weights`` of one depth-ordered chunk of Gaussians, carrying
    (unmasked T, stopped, T_final) of each pixel over the chunks before."""
    one_minus = 1.0 - alpha
    head = torch.ones_like(alpha[:, :1])
    if carry is not None:
        head = carry[0][:, None]
    # exclusive cumulative product of (1 - alpha) along the depth axis
    t_excl = torch.cumprod(torch.cat([head, one_minus[:, :-1]], dim=1), dim=1)
    fail = t_excl * one_minus < T_STOP
    done = torch.cumsum(fail.to(torch.int32), dim=1) > 0
    if carry is not None:
        done = done | carry[1][:, None]
    weights = alpha * t_excl * (~done)
    t_final = torch.prod(torch.where(done, 1.0, one_minus), dim=1)
    if carry is not None:
        t_final = carry[2] * t_final
    return weights, (t_excl[:, -1] * one_minus[:, -1], done[:, -1], t_final)


def blend_weights(alpha: torch.Tensor):
    """Sequential-consistent over-compositing weights.

    alpha: (P, K) in front-to-back depth order.  Returns (weights (P, K),
    final transmittance (P,)).
    """
    weights, carry = _blend_chunk(alpha)
    return weights, carry[2]


# elements of one (pixels, Gaussians) block of the oracle: the Gaussians
# are taken in chunks beyond it
ORACLE_BLOCK = 1 << 22


def depth_sorted_visible(proj):
    """Indices of the visible Gaussians (radius > 0) in depth order, ties
    in index order, as texgs's stable argsort with +inf keys puts them."""
    idx = torch.nonzero(proj.radii > 0).squeeze(1)
    return idx[torch.argsort(proj.depths[idx], stable=True)]


def dense_blend(proj, order, height: int, width: int, channels,
                texture_term=None, row_block: int = 16,
                block: int = ORACLE_BLOCK):
    """Composite the Gaussians ``order`` (depth-sorted) densely over the
    image, ``row_block`` rows at a time and at most ``block`` (pixel,
    Gaussian) elements at once.

    channels: (K, C) per-Gaussian values blended with the weights.
    texture_term(px, py, k0, k1, weights) -> (P, 3) adds a per-intersection
    term of Gaussians k0..k1 to the first three channels (the stage-3
    texture).  Returns the blended
    channels (H, W, C) and the final transmittance (H, W).
    """
    dev = proj.means2d.device
    means2d, conics = proj.means2d[order], proj.conics[order]
    opacities = proj.opacities[order]
    xmin, xmax, ymin, ymax = tile_rect(means2d, proj.radii[order], width,
                                       height)
    k = order.numel()
    n_rows = -(-height // row_block)
    chunk = max(1, min(k, block // (row_block * width)))
    xs = torch.arange(width, dtype=torch.float32, device=dev)
    rows, t_rows = [], []
    for r in range(n_rows):
        ys = r * row_block + torch.arange(row_block, dtype=torch.float32,
                                          device=dev)
        py = ys.repeat_interleave(width)
        px = xs.repeat(row_block)
        tx = (px / TILE).to(torch.int32)
        ty = (py / TILE).to(torch.int32)
        acc = torch.zeros((px.numel(), channels.shape[1]), device=dev)
        carry = (torch.ones_like(px), torch.zeros_like(px, dtype=torch.bool),
                 torch.ones_like(px))
        for k0 in range(0, k, chunk):
            k1 = min(k, k0 + chunk)
            alpha = gaussian_alpha(px, py, means2d[k0:k1], conics[k0:k1],
                                   opacities[k0:k1])
            # tile-rect coverage, the binner's rule
            cov = ((tx[:, None] >= xmin[None, k0:k1])
                   & (tx[:, None] < xmax[None, k0:k1])
                   & (ty[:, None] >= ymin[None, k0:k1])
                   & (ty[:, None] < ymax[None, k0:k1]))
            alpha = torch.where(cov, alpha, 0.0)
            weights, carry = _blend_chunk(alpha, carry if k0 else None)
            acc = acc + weights @ channels[k0:k1]
            if texture_term is not None:
                term = texture_term(px, py, k0, k1, weights)
                acc = acc + F.pad(term, (0, acc.shape[1] - term.shape[1]))
        rows.append(acc.reshape(row_block, width, -1))
        t_rows.append(carry[2].reshape(row_block, width))
    return torch.cat(rows)[:height], torch.cat(t_rows)[:height]


def compose(blended, t_final, bg, normalize_depth: bool,
            n_extra: int) -> RasterOutput:
    """RasterOutput of blended [rgb, depth, normal, extra] channels (H, W,
    7 + E): the background behind T_final, depth divided by the alpha."""
    rgb = blended[..., 0:3] + t_final[..., None] * bg
    dep = blended[..., 3:4]
    acc = 1.0 - t_final
    if normalize_depth:
        dep = dep / torch.clamp(acc, min=1e-6)[..., None]
    extra = blended[..., 7:7 + n_extra].permute(2, 0, 1) if n_extra else None
    return RasterOutput(image=rgb.permute(2, 0, 1), depth=dep.permute(2, 0, 1),
                        norm=blended[..., 4:7].permute(2, 0, 1),
                        alpha=acc[None], extra=extra)


def rasterize_reference(proj, height: int, width: int, bg: torch.Tensor,
                        extra_attrs=None, normalize_depth: bool = True,
                        row_block: int = 16) -> RasterOutput:
    """Rasterize projected Gaussians densely (the oracle), differentiable
    in every field of ``proj`` and in ``extra_attrs`` (N, E).

    Culled Gaussians (radius 0) take no part; their alpha would be 0.
    """
    order = depth_sorted_visible(proj)
    cols = [proj.colors, proj.depths[:, None], proj.normals]
    if extra_attrs is not None:
        cols.append(extra_attrs)
    channels = torch.cat(cols, dim=1)[order]
    blended, t_final = dense_blend(proj, order, height, width, channels,
                                   row_block=row_block)
    n_extra = 0 if extra_attrs is None else extra_attrs.shape[1]
    return compose(blended, t_final, bg, normalize_depth, n_extra)
