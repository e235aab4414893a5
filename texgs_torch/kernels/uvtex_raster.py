"""UV-texture rasterizer: Taylor-expanded UVs + cubemap fetch per intersection.

Port of texgs/kernels/uvtex_raster.py, forward only.  For every
pixel-Gaussian intersection the color is
    color = max(0, 0.5 + SH_rest(view dir)) + C0 * tex(uv*)
    uv*   = normalize(uv_c + J (x* - mu))
where x* = o + t* d is the maximum-response point of the Gaussian along
the pixel ray, t* = (d . Sigma^-1 v) / (d . Sigma^-1 d) with v = mu - o,
and tex is a bilinear 6-face cubemap fetch in SH0 space.

The per-pixel color splits into a per-Gaussian part (the SH residual,
blended like any channel) and the per-intersection texture term, which is
computed from each pixel's list of its first ``m`` contributors (the
M-list).  On the render path two CUDA kernels carry it:

  * kernels.uvtex_fused: blend channels + M-lists in one pass over each
    tile's depth-sorted pairs (plain version: ``mlist_scan`` there);
  * kernels.tex_term: the texture term from the M-lists (plain version:
    ``mlist_tex_term`` there).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from texgs_torch.core.camera import Camera
from texgs_torch.kernels.binning import build_pairs, grid_shape
from texgs_torch.kernels.cubemap import sample_cubemap
from texgs_torch.kernels.project import ProjectedGaussians
from texgs_torch.kernels.reference import RasterOutput
from texgs_torch.kernels.tile_raster import (assemble_image, build_gauss_table,
                                             tiles_to_image)
from texgs_torch.utils.sh import C0, eval_sh
from texgs_torch.utils.transforms import rotation_channels

T_STAR_MAX = 1e4
# per-Gaussian uv row: sv(3), siginv(6: xx,xy,xz,yy,yz,zz), base_uv(3),
# J row-major(9), padding(3)
UV_COLS = 24


class UVTexTables(NamedTuple):
    """Per-Gaussian intersection data (all world-space)."""
    sv: torch.Tensor        # (N, 3) Sigma^-1 (mu - o)
    siginv: torch.Tensor    # (N, 6) packed inverse covariance
    base_uv: torch.Tensor   # (N, 3) uv_c - J (mu - o)
    jmat: torch.Tensor      # (N, 9) duv/dxyz row-major (constant)


def residual_sh_colors(shs: Optional[torch.Tensor], xyz, campos,
                       active_sh_degree: int) -> torch.Tensor:
    """max(0, 0.5 + SH_rest), the per-Gaussian part of the color.  ``shs``
    holds coefficients for degrees >= 1 only ((N, K-1, 3))."""
    n = xyz.shape[0]
    if shs is None or active_sh_degree == 0:
        return torch.full((n, 3), 0.5, device=xyz.device)
    dirs = xyz - campos[None, :]
    dirs = dirs / (torch.linalg.norm(dirs, dim=-1, keepdim=True) + 1e-12)
    full = torch.cat([torch.zeros((n, 1, 3), device=xyz.device), shs], dim=1)
    rest = eval_sh(active_sh_degree, full.transpose(-1, -2), dirs)
    return torch.clamp(0.5 + rest, min=0.0)


def build_uvtex_tables(xyz, scaling, rotation, uvs, grad_uvs,
                       campos) -> UVTexTables:
    """scaling: activated world scales; rotation: normalized quats.
    Sigma^-1 = R diag(1/s^2) R^T in channel form."""
    r00, r01, r02, r10, r11, r12, r20, r21, r22 = rotation_channels(rotation)
    i0 = 1.0 / torch.clamp(scaling[:, 0] * scaling[:, 0], min=1e-24)
    i1 = 1.0 / torch.clamp(scaling[:, 1] * scaling[:, 1], min=1e-24)
    i2 = 1.0 / torch.clamp(scaling[:, 2] * scaling[:, 2], min=1e-24)
    sxx = i0 * r00 * r00 + i1 * r01 * r01 + i2 * r02 * r02
    sxy = i0 * r00 * r10 + i1 * r01 * r11 + i2 * r02 * r12
    sxz = i0 * r00 * r20 + i1 * r01 * r21 + i2 * r02 * r22
    syy = i0 * r10 * r10 + i1 * r11 * r11 + i2 * r12 * r12
    syz = i0 * r10 * r20 + i1 * r11 * r21 + i2 * r12 * r22
    szz = i0 * r20 * r20 + i1 * r21 * r21 + i2 * r22 * r22
    v = xyz - campos[None, :]
    vx, vy, vz = v.unbind(dim=1)
    sv = torch.stack([sxx * vx + sxy * vy + sxz * vz,
                      sxy * vx + syy * vy + syz * vz,
                      sxz * vx + syz * vy + szz * vz], dim=-1)
    jmat = grad_uvs.detach()                       # (N, 9) row-major
    jv = torch.stack([
        jmat[:, 0] * vx + jmat[:, 1] * vy + jmat[:, 2] * vz,
        jmat[:, 3] * vx + jmat[:, 4] * vy + jmat[:, 5] * vz,
        jmat[:, 6] * vx + jmat[:, 7] * vy + jmat[:, 8] * vz], dim=-1)
    siginv = torch.stack([sxx, sxy, sxz, syy, syz, szz], dim=-1)
    return UVTexTables(sv=sv, siginv=siginv, base_uv=uvs - jv, jmat=jmat)


def build_uv_rows(tables: UVTexTables) -> torch.Tensor:
    """(N, UV_COLS) per-Gaussian rows [sv, siginv, base_uv, J, pad].

    texgs gathers these per pair for the TPU; the CUDA kernel reads them
    by Gaussian index."""
    pad = torch.zeros((tables.sv.shape[0], 3), device=tables.sv.device)
    return torch.cat([tables.sv, tables.siginv, tables.base_uv, tables.jmat,
                      pad], dim=1).contiguous()


def ray_constants(camera: Camera) -> np.ndarray:
    """(3, 3) float32 rows [ax, by, c0] with the world ray direction
    d(px, py) = c0 + px*ax + py*by (unnormalized).

    ndc = (2 p + 1)/S - 1; d_cam = (ndc_x tanfovx, ndc_y tanfovy, 1);
    d_world = Wmat @ d_cam with Wmat = world_view[:3, :3] (= R_c2w)."""
    Wm = np.asarray(camera.world_view, np.float32)[:3, :3]
    w, h = camera.width, camera.height
    ax = Wm @ np.array([2.0 * camera.tanfovx / w, 0.0, 0.0], np.float32)
    by = Wm @ np.array([0.0, 2.0 * camera.tanfovy / h, 0.0], np.float32)
    c0 = Wm @ np.array([camera.tanfovx * (1.0 / w - 1.0),
                        camera.tanfovy * (1.0 / h - 1.0), 1.0], np.float32)
    return np.stack([ax, by, c0]).astype(np.float32)


def intersect_uv(d: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """Unit uv* of rays d (..., 3) against Gaussians whose uv rows
    (..., >= 21) broadcast against d.  Returns (..., 3).

    Normalises as texgs's intersect_uv does: uv / (|uv| + 1e-12)."""
    dx, dy, dz = d[..., 0], d[..., 1], d[..., 2]
    r = rows
    num = dx * r[..., 0] + dy * r[..., 1] + dz * r[..., 2]
    den = (dx * dx * r[..., 3] + 2 * dx * dy * r[..., 4]
           + 2 * dx * dz * r[..., 5] + dy * dy * r[..., 6]
           + 2 * dy * dz * r[..., 7] + dz * dz * r[..., 8])
    den = torch.where(den.abs() < 1e-20, 1e-20, den)
    t_star = torch.clamp(num / den, 0.0, T_STAR_MAX)
    jd = torch.stack([dx * r[..., 12 + 3 * i] + dy * r[..., 13 + 3 * i]
                      + dz * r[..., 14 + 3 * i] for i in range(3)], dim=-1)
    uv = r[..., 9:12] + t_star[..., None] * jd
    return uv / (torch.linalg.norm(uv, dim=-1, keepdim=True) + 1e-12)


def tail_tex_term(mlist: torch.Tensor, t_final: torch.Tensor,
                  texture: torch.Tensor, height: int, width: int,
                  filter_mode: str = "bilinear") -> torch.Tensor:
    """Residual-transmittance tail correction for m-truncated lists.

    The dropped tail's total blend weight is known exactly from the blend
    pass, w_tail = (1 - T_final) - sum_slots w, and its UVs are
    approximated by the deepest captured slot's UV.  Returns the (3, H, W)
    additive term (C0-scaled); zero where no slot filled or w_tail <= 0.
    """
    t, pix, m, _ = mlist.shape
    w = mlist[..., 0]
    count = (w > 0.0).sum(dim=-1)
    last = torch.clamp(count - 1, 0, m - 1)
    uv_last = torch.gather(
        mlist[..., 1:4], 2,
        last[..., None, None].expand(t, pix, 1, 3))[:, :, 0].detach()
    w_tail = torch.clamp((1.0 - t_final) - w.sum(dim=-1), min=0.0)
    w_tail = torch.where(count > 0, w_tail, 0.0)
    tex = sample_cubemap(texture, uv_last.reshape(-1, 3),
                         filter_mode).reshape(t, pix, 3)
    return tiles_to_image(C0 * w_tail[..., None] * tex, height, width)


def rasterize_uvtex(proj: ProjectedGaussians, scaling, rotation, xyz,
                    uvs, grad_uvs, texture, shs, active_sh_degree: int,
                    camera: Camera, bg: torch.Tensor, m: int = 32,
                    filter_mode: str = "bilinear", with_no_sh: bool = False,
                    m_tail: bool = False) -> RasterOutput:
    """Full UV-texture rasterization (texgs backend 'fused' with the exact
    texture term).

    proj must carry zero colors (the base SH residual is injected here).
    with_no_sh: also return ``image_no_sh``, the texture-only image a
    second rasterization at active_sh_degree=0 would give.  The
    per-intersection color is linear in the per-Gaussian SH term, so one
    blend pass suffices: ``clamp(.5+SH_rest) - .5`` rides as 3 extra blend
    channels and is subtracted from the composited image.  The kernel thus
    sees F = 10 blend channels with the no-SH image, else F = 7.
    """
    from texgs_torch.kernels.tex_term import tex_term
    from texgs_torch.kernels.uvtex_fused import fused_pairs

    base_colors = residual_sh_colors(shs, xyz, torch.as_tensor(
        camera.camera_center, device=xyz.device), active_sh_degree)
    proj = proj._replace(colors=base_colors)

    append_ns = with_no_sh and shs is not None and active_sh_degree > 0
    extra_attrs = base_colors - 0.5 if append_ns else None
    n_extra = 0 if extra_attrs is None else extra_attrs.shape[1]

    tables = build_uvtex_tables(xyz, scaling, rotation, uvs, grad_uvs,
                                torch.as_tensor(camera.camera_center,
                                                device=xyz.device))
    height, width = camera.height, camera.width
    pairs = build_pairs(proj.means2d, proj.depths, proj.radii, height, width)
    table = build_gauss_table(proj, extra_attrs)
    tiles_out, t_final, mlist, _ = fused_pairs(
        table, build_uv_rows(tables), pairs, ray_constants(camera),
        grid_shape(height, width)[1], m)
    base = assemble_image(tiles_out, t_final, height, width, bg, n_extra)
    tex_img = tex_term(mlist, texture, height, width, filter_mode)
    if m_tail:
        tex_img = tex_img + tail_tex_term(mlist, t_final, texture, height,
                                          width, filter_mode)

    out = RasterOutput(image=base.image + tex_img, depth=base.depth,
                       norm=base.norm, alpha=base.alpha, extra=base.extra,
                       n_pairs=pairs.n_pairs, overflowed=pairs.overflowed)
    if not with_no_sh:
        return out
    if not append_ns:
        # degree 0 (or no residual SH): the no-SH render IS the render
        return out._replace(image_no_sh=out.image)
    return out._replace(image_no_sh=out.image - out.extra, extra=None)
