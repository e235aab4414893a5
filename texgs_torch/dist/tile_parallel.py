"""Row-band rendering across ranks (port of texgs/dist/tile_parallel.py).

Each rank of a ``tile`` axis bins and rasterizes one horizontal band of
the image with the unchanged single-card render: the projected means move
up by the band's first row and the band is rendered as a short image
(``render(..., row_offset, band_height)``), so the kernels only ever see
band-local tiles.  The bands are tile-aligned and of one height; the last
is padded below the image.  The Gaussians are replicated; the gradients of
the band renders are summed over the axis.

``dp_tile_train_step`` composes this with data parallelism on a (data,
tile) mesh: each ``data`` rank takes one camera and its ``tile`` ranks
split that camera's rows.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

from texgs_torch.core.camera import Camera
from texgs_torch.core.state import GaussianState
from texgs_torch.dist.collectives import (axis_index, axis_size, flat_grads,
                                          gather_stack, pmean_, psum_,
                                          set_grads)
from texgs_torch.dist.data_parallel import _train_leaves, rank_camera
from texgs_torch.kernels.reference import TILE
from texgs_torch.render.render import render
from texgs_torch.train.optim import Adam

CHANNELS = ("render", "depth", "norm", "alpha")


def band_height(height: int, n_bands: int) -> int:
    """Each rank's band height: whole tile rows, the last band padded."""
    tiles_y = -(-height // TILE)
    band_tiles = -(-tiles_y // n_bands)
    return band_tiles * TILE


def render_band(camera: Camera, row_offset: int, band_h: int,
                render_fn=render, **render_kwargs) -> dict:
    """Render rows [row_offset, row_offset + band_h) of ``camera``'s image
    through ``render_fn`` (``render``, or ``uv_tex_render`` for stage 3).
    Returns the render's dict with (C, band_h, W) images."""
    band_cam = dataclasses.replace(camera, image=None, alpha_mask=None,
                                   normal=None, depth=None)
    return render_fn(band_cam, row_offset=row_offset, band_height=band_h,
                     **render_kwargs)


def stitch_bands(bands: torch.Tensor, height: int) -> torch.Tensor:
    """(n, C, band_h, W) bands, top first -> (C, height, W), the padding
    below the image cropped."""
    n, c, bh, w = bands.shape
    return bands.permute(1, 0, 2, 3).reshape(c, n * bh, w)[:, :height]


def render_tile_sharded(mesh, axis: str, camera: Camera, *, xyz, opacity,
                        scaling, rotation, features, active_sh_degree: int,
                        bg_color, backend: str = "auto") -> dict:
    """The whole image with its rows split over ``axis``: each rank renders
    its band, the bands are gathered and stitched on every rank.  Returns
    render, depth, norm and alpha."""
    n_bands = axis_size(mesh, axis)
    band_h = band_height(camera.height, n_bands)
    out = render_band(camera, axis_index(mesh, axis) * band_h, band_h,
                      xyz=xyz, opacity=opacity, scaling=scaling,
                      rotation=rotation, features=features,
                      active_sh_degree=active_sh_degree, bg_color=bg_color,
                      backend=backend)
    band = torch.cat([out[k] for k in CHANNELS], dim=0)
    full = stitch_bands(gather_stack(band, mesh, axis), camera.height)
    return dict(zip(CHANNELS, full.split([3, 1, 3, 1])))


def dp_tile_train_step(mesh, state: GaussianState, adam: Adam,
                       camera_batch: Sequence[Camera], active_sh_degree: int,
                       lr: float, lambda_dssim: float = 0.2,
                       data_axis: str = "data",
                       tile_axis: str = "tile") -> torch.Tensor:
    """One step over a (data, tile) mesh: cameras over ``data_axis``, each
    camera's rows over ``tile_axis``; the L1 of the whole image is the sum
    of the bands' masked sums over the pixel count (texgs, like its step,
    takes the L1 alone here, whatever ``lambda_dssim``).  The gradients are
    summed over ``tile`` and averaged over ``data``; every rank takes the
    same Adam step.  ``state`` and ``adam`` change in place; returns the
    loss averaged over the cameras."""
    cam = rank_camera(mesh, camera_batch, data_axis)
    n_bands = axis_size(mesh, tile_axis)
    band_h = band_height(cam.height, n_bands)
    row0 = axis_index(mesh, tile_axis) * band_h
    dev = state.xyz.device
    params = _train_leaves(state)

    gt = torch.as_tensor(cam.image, dtype=torch.float32, device=dev)
    gt = torch.nn.functional.pad(gt, (0, 0, 0, n_bands * band_h - cam.height))
    gt_band = gt[:, row0:row0 + band_h]
    # rows below the true image must not reach the loss
    rows = row0 + torch.arange(band_h, device=dev)
    row_mask = (rows < cam.height).to(torch.float32)[None, :, None]
    n_px = 3 * cam.height * cam.width
    with torch.enable_grad():
        out = render_band(cam, row0, band_h, xyz=state.xyz,
                          opacity=state.get_opacity(),
                          scaling=state.get_scaling(),
                          rotation=state.get_rotation(),
                          features=state.get_features(),
                          active_sh_degree=active_sh_degree,
                          bg_color=torch.zeros(3, device=dev), backend="scan")
        err = ((out["render"] * row_mask - gt_band * row_mask).abs().sum()
               / n_px)
        err.backward()
    leaves = list(params.values())
    # each band's gradient is its part of the whole image's: summed over
    # tile, averaged over the cameras
    grads = pmean_(psum_(flat_grads(leaves), mesh, [tile_axis]), mesh,
                   data_axis)
    set_grads(leaves, grads)
    adam.step(params, {k: lr for k in params})
    loss = psum_(err.detach().reshape(1), mesh, [tile_axis])
    return pmean_(loss, mesh, data_axis)[0]
