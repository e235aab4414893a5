"""Depth-ordered Gaussian slices folded with the over operator (port of
texgs/dist/gauss_sharded.py).

Alpha compositing is associative, so depth-contiguous subsets of the
Gaussians rendered apart fold into the whole image:

    C = C_front + T_front * C_back        T = T_front * T_back

Every rank of the axis projects all the (replicated) Gaussians, takes its
contiguous slice of their depth ranks (a stable argsort of the view depth,
culled Gaussians last with the key +inf), renders only that slice with the
unchanged single-card kernels (premultiplied channels, the background
deferred, depth unnormalised), gathers every slice's (channels,
transmittance) image over the axis and folds them front to back.

Against one render of all the Gaussians, the T < 1e-4 stop tests each
slice's own transmittance, so an entry that the whole render stops can
still add across a slice boundary: at most ALPHA_CLAMP * T_STOP /
(1 - ALPHA_CLAMP) ~= 1e-2 a channel, near-opaque Gaussians right at the
stop (texgs :22-29).  In stage 3 each slice writes its own M-list of m
slots, so a pixel whose list the whole render cuts at m gains contributors.

The loss is computed on every rank from the folded image, so each slice's
cotangent arrives through the gather's backward n times: the 1/n
``grad_scale`` before the gather makes the caller's sum of the parameter
gradients over the axis count every pixel once.  The port keeps every
pair, so texgs's ``slice_cap`` has no counterpart and ``pair_overflow`` is
False.
"""

from __future__ import annotations

from typing import Optional

import torch

from texgs_torch.core.camera import Camera
from texgs_torch.dist.collectives import (all_gather, axis_index, axis_size,
                                          grad_scale)
from texgs_torch.kernels import project as proj_k
from texgs_torch.kernels.project import ProjectedGaussians, band_rows
from texgs_torch.kernels.reference import rasterize_reference
from texgs_torch.kernels.tile_raster import rasterize_tiled
from texgs_torch.kernels.uvtex_raster import rasterize_uvtex


def over_fold(channels: torch.Tensor, trans: torch.Tensor):
    """Fold depth-ordered premultiplied slices with the over operator.

    channels: (n, F, H, W) per-slice channel sums, front slice first;
    trans: (n, 1, H, W) per-slice transmittance.  Returns (C (F, H, W),
    T (1, H, W))."""
    t_excl = torch.cat([torch.ones_like(trans[:1]),
                        torch.cumprod(trans[:-1], dim=0)], dim=0)
    c_total = (t_excl * channels).sum(dim=0)
    t_total = torch.prod(trans, dim=0)[0]
    return c_total, t_total[None]


def depth_slice(proj: ProjectedGaussians, index: int,
                n_slices: int) -> torch.Tensor:
    """The Gaussians of depth slice ``index`` of ``n_slices``: contiguous
    ranks of a stable argsort of the view depth (jnp.argsort is stable, so
    ties pick texgs's slices), culled Gaussians last.  The slices are
    ceil(N / n_slices) ranks long (texgs requires N % n_slices == 0, where
    they are N / n_slices)."""
    key = torch.where(proj.radii > 0, proj.depths.detach(),
                      torch.full_like(proj.depths, torch.inf))
    order = torch.argsort(key, stable=True)
    s = -(-order.shape[0] // n_slices)
    return order[index * s:(index + 1) * s]


def finish_fold(channels: torch.Tensor, trans: torch.Tensor, bg,
                normalize_depth: bool = True) -> dict:
    """The render's channels from the gathered slices: folded, the
    background composited under the whole stack, the depth normalised by
    the folded alpha.  Channels 7..9, where present, are the no-SH image."""
    c_tot, t_tot = over_fold(channels, trans)
    bg = torch.as_tensor(bg, dtype=torch.float32, device=c_tot.device)
    acc = 1.0 - t_tot
    dep = c_tot[3:4]
    if normalize_depth:
        dep = dep / torch.clamp(acc, min=1e-6)
    out = {"render": c_tot[0:3] + t_tot * bg[:, None, None], "depth": dep,
           "norm": c_tot[4:7], "alpha": acc}
    if c_tot.shape[0] > 7:
        out["render_no_sh"] = c_tot[7:10] + t_tot * bg[:, None, None]
    return out


def render_slice(camera: Camera, *, xyz, opacity, scaling, rotation,
                 features=None, active_sh_degree: int = 0,
                 override_color=None, ndc_offset=None, backend: str = "scan",
                 index: int, n_slices: int, row_offset: Optional[int] = None,
                 band_height: Optional[int] = None):
    """Depth slice ``index`` of ``n_slices`` through the stage-1 render
    (kernel 1; ``backend="reference"`` the dense oracle), premultiplied,
    no background, depth unnormalised.  Returns (channels (7, H, W),
    transmittance (1, H, W), the radii of all the Gaussians, the slice's
    pair count (None on the oracle))."""
    cam = camera
    dev = xyz.device

    def on_device(a):
        return torch.as_tensor(a, dtype=torch.float32, device=dev)

    colors = (proj_k.sh_colors(features, xyz, on_device(cam.camera_center),
                               active_sh_degree)
              if override_color is None else override_color)
    proj = proj_k.project_gaussians(
        xyz, scaling, rotation, opacity, colors, cam.world_view,
        cam.full_proj, cam.camera_center, cam.width, cam.height, cam.tanfovx,
        cam.tanfovy, ndc_offset=ndc_offset)
    radii, height = proj.radii, cam.height
    if row_offset is not None:
        proj, height = band_rows(proj, row_offset, band_height)
    mine = depth_slice(proj, index, n_slices)
    sliced = ProjectedGaussians(*(f[mine] for f in proj))
    raster = rasterize_reference if backend == "reference" else rasterize_tiled
    part = raster(sliced, height, cam.width, torch.zeros(3, device=dev),
                  normalize_depth=False)
    chans = torch.cat([part.image, part.depth, part.norm], dim=0)
    return chans, 1.0 - part.alpha, radii, part.n_pairs


def render_uv_slice(camera: Camera, *, xyz, opacity, scaling, rotation, uvs,
                    grad_uvs, texture, shs=None, active_sh_degree: int = 0,
                    m: int = 32, filter_mode: str = "bilinear",
                    backend: str = "scan", tex_backend: str = "xla",
                    with_no_sh: bool = False, index: int, n_slices: int,
                    row_offset: Optional[int] = None,
                    band_height: Optional[int] = None):
    """Depth slice ``index`` of ``n_slices`` through the stage-3 render
    (kernels A and B, or 1, 2 and B), its own M-lists of m slots,
    premultiplied, no background, depth unnormalised.  The texture term is
    linear in the blend weights, so it folds with the other channels.
    Returns (channels (7, or 10 with the no-SH image, H, W),
    transmittance (1, H, W), the radii of all the Gaussians, the slice's
    pair count)."""
    cam = camera
    dev = xyz.device
    # colors come from the texture (rasterize_uvtex)
    proj = proj_k.project_gaussians(
        xyz, scaling, rotation, opacity, None, cam.world_view, cam.full_proj,
        cam.camera_center, cam.width, cam.height, cam.tanfovx, cam.tanfovy)
    mine = depth_slice(proj, index, n_slices)
    out = rasterize_uvtex(
        ProjectedGaussians(*(None if f is None else f[mine] for f in proj)),
        scaling[mine], rotation[mine], xyz[mine], uvs[mine], grad_uvs[mine],
        texture,
        None if shs is None else shs[mine], active_sh_degree, cam,
        torch.zeros(3, device=dev), m=m, filter_mode=filter_mode,
        with_no_sh=with_no_sh, backend=backend, tex_backend=tex_backend,
        normalize_depth=False, row_offset=row_offset,
        band_height=band_height)
    parts = [out.image, out.depth, out.norm]
    if with_no_sh:
        parts.append(out.image_no_sh)
    return torch.cat(parts, dim=0), 1.0 - out.alpha, proj.radii, out.n_pairs


def _gather_fold(chans, trans, mesh, axis_name: str, bg,
                 normalize_depth: bool) -> dict:
    """Every slice of the axis gathered (one collective) and folded."""
    n = axis_size(mesh, axis_name)
    both = grad_scale(torch.cat([chans, trans], dim=0), 1.0 / n)
    g = all_gather(both, mesh, axis_name)
    return finish_fold(g[:, :-1], g[:, -1:], bg, normalize_depth)


def gauss_sharded_render(camera: Camera, *, mesh, axis_name: str = "gauss",
                         xyz, opacity, scaling, rotation, features=None,
                         active_sh_degree: int = 0, bg_color,
                         override_color=None, ndc_offset=None,
                         backend: str = "scan", normalize_depth: bool = True,
                         row_offset: Optional[int] = None,
                         band_height: Optional[int] = None) -> dict:
    """``render`` with its Gaussians split into depth slices over
    ``axis_name``; every Gaussian input replicated.  Returns the whole
    image's dict on every rank (with row_offset/band_height, the folded
    band, which the caller gathers over its tile axis: the (data, tile,
    gauss) decomposition).  ``radii`` are all the Gaussians' (the
    projection is replicated); ``n_pairs`` is this rank's slice's."""
    chans, trans, radii, n_pairs = render_slice(
        camera, xyz=xyz, opacity=opacity, scaling=scaling, rotation=rotation,
        features=features, active_sh_degree=active_sh_degree,
        override_color=override_color, ndc_offset=ndc_offset,
        backend=backend, index=axis_index(mesh, axis_name),
        n_slices=axis_size(mesh, axis_name), row_offset=row_offset,
        band_height=band_height)
    out = _gather_fold(chans, trans, mesh, axis_name, bg_color,
                       normalize_depth)
    out.update(extra=None, radii=radii, visibility_filter=radii > 0,
               n_pairs=n_pairs, pair_overflow=torch.zeros(
                   (), dtype=torch.bool, device=xyz.device))
    return out


def gauss_sharded_uv_tex_render(camera: Camera, *, mesh,
                                axis_name: str = "gauss", xyz, opacity,
                                scaling, rotation, uvs, grad_uvs, texture,
                                shs=None, active_sh_degree: int = 0,
                                bg_color, m: int = 32,
                                filter_mode: str = "bilinear",
                                backend: str = "scan",
                                tex_backend: str = "xla",
                                normalize_depth: bool = True,
                                row_offset: Optional[int] = None,
                                band_height: Optional[int] = None,
                                with_no_sh: bool = False) -> dict:
    """``uv_tex_render`` with its Gaussians split into depth slices over
    ``axis_name`` (each slice its own m M-list slots; the same bounded
    local-T_STOP divergence as ``gauss_sharded_render``)."""
    chans, trans, radii, n_pairs = render_uv_slice(
        camera, xyz=xyz, opacity=opacity, scaling=scaling, rotation=rotation,
        uvs=uvs, grad_uvs=grad_uvs, texture=texture, shs=shs,
        active_sh_degree=active_sh_degree, m=m, filter_mode=filter_mode,
        backend=backend, tex_backend=tex_backend, with_no_sh=with_no_sh,
        index=axis_index(mesh, axis_name),
        n_slices=axis_size(mesh, axis_name), row_offset=row_offset,
        band_height=band_height)
    out = _gather_fold(chans, trans, mesh, axis_name, bg_color,
                       normalize_depth)
    out.setdefault("render_no_sh", None)
    out.update(extra=None, radii=radii, visibility_filter=radii > 0,
               n_pairs=n_pairs, pair_overflow=torch.zeros(
                   (), dtype=torch.bool, device=xyz.device),
               tex_miss=None)
    return out
