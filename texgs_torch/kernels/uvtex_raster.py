"""UV-texture rasterizer: Taylor-expanded UVs + cubemap fetch per intersection.

Port of texgs/kernels/uvtex_raster.py.  For every
pixel-Gaussian intersection the color is
    color = max(0, 0.5 + SH_rest(view dir)) + C0 * tex(uv*)
    uv*   = normalize(uv_c + J (x* - mu))
where x* = o + t* d is the maximum-response point of the Gaussian along
the pixel ray, t* = (d . Sigma^-1 v) / (d . Sigma^-1 d) with v = mu - o,
and tex is a bilinear 6-face cubemap fetch in SH0 space.

The per-pixel color splits into a per-Gaussian part (the SH residual,
blended like any channel) and the per-intersection texture term, which is
computed from each pixel's list of its first ``m`` contributors (the
M-list).  The blend and the M-lists take one of two paths
(``resolve_backends``):

  * fused (texgs's ``auto`` and ``fused``): kernels.uvtex_fused, blend
    channels + M-lists in one pass over each tile's depth-sorted pairs
    (kernel A; plain version ``mlist_scan`` there);
  * two-kernel (texgs's ``pallas`` and ``scan``): kernels.raster blends the
    channels (kernel 1; plain version ``raster_scan``) and
    kernels.uvtex_mlist writes the M-lists from the same pairs (kernel 2;
    plain version ``mlist_only_scan``).

Either way kernels.tex_term computes the texture term from the M-lists
(kernel B; plain version ``mlist_tex_term`` there).  texgs's
``reference`` backend is the dense oracle, ``rasterize_uvtex_reference``:
every intersection of every pixel, no M-list, in plain torch.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from texgs_torch.core.camera import Camera
from texgs_torch.kernels.binning import (build_pairs, grid_shape,
                                         with_tile_order)
from texgs_torch.kernels.cubemap import sample_cubemap
from texgs_torch.kernels.project import ProjectedGaussians, band_rows
from texgs_torch.kernels.reference import (RasterOutput, compose,
                                           dense_blend, depth_sorted_visible)
from texgs_torch.kernels.tile_raster import (assemble_image, build_gauss_table,
                                             tiles_to_image)
from texgs_torch.utils.sh import C0, eval_sh
from texgs_torch.utils.spans import span
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


def ray_constants(camera: Camera, row_offset: Optional[int] = None) -> np.ndarray:
    """(3, 3) float32 rows [ax, by, c0] with the world ray direction
    d(px, py) = c0 + px*ax + py*by (unnormalized).

    ndc = (2 p + 1)/S - 1; d_cam = (ndc_x tanfovx, ndc_y tanfovy, 1);
    d_world = Wmat @ d_cam with Wmat = world_view[:3, :3] (= R_c2w).
    row_offset: a band's first pixel row.  Band rendering makes py
    band-local, so the offset is folded into c0 (c0 += row_offset * by)
    and every ray formula downstream stays as it is; the NDC terms keep
    the full ``camera.height`` (texgs uvtex_raster.py:109-126)."""
    Wm = np.asarray(camera.world_view, np.float32)[:3, :3]
    w, h = camera.width, camera.height
    ax = Wm @ np.array([2.0 * camera.tanfovx / w, 0.0, 0.0], np.float32)
    by = Wm @ np.array([0.0, 2.0 * camera.tanfovy / h, 0.0], np.float32)
    c0 = Wm @ np.array([camera.tanfovx * (1.0 / w - 1.0),
                        camera.tanfovy * (1.0 / h - 1.0), 1.0], np.float32)
    if row_offset is not None:
        c0 = c0 + np.float32(row_offset) * by
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


def rasterize_uvtex_reference(proj: ProjectedGaussians,
                              tables: UVTexTables, texture: torch.Tensor,
                              camera: Camera, bg: torch.Tensor,
                              extra_attrs=None, normalize_depth: bool = True,
                              filter_mode: str = "bilinear",
                              row_block: int = 16) -> RasterOutput:
    """Dense differentiable oracle (texgs uvtex_raster.py:159): the exact
    texture term of every intersection, no M-list truncation.  texgs's
    samples bilinear whatever the model's filter; this one takes
    ``filter_mode``, the same at its default."""
    order = depth_sorted_visible(proj)
    cols = [proj.colors, proj.depths[:, None], proj.normals]
    if extra_attrs is not None:
        cols.append(extra_attrs)
    channels = torch.cat(cols, dim=1)[order]
    rows = build_uv_rows(tables)[order]
    ax, by, c0 = torch.as_tensor(ray_constants(camera),
                                 device=channels.device)

    def texture_term(px, py, k0, k1, weights):
        d = c0 + px[:, None] * ax + py[:, None] * by          # (P, 3)
        uv = intersect_uv(d[:, None, :], rows[None, k0:k1])  # (P, K, 3)
        tex = sample_cubemap(texture, uv.reshape(-1, 3), filter_mode)
        return C0 * (weights[..., None] * tex.reshape(uv.shape)).sum(1)

    # the texture term holds ~20 (pixel, Gaussian) temporaries at once
    blended, t_final = dense_blend(proj, order, camera.height, camera.width,
                                   channels, texture_term, row_block,
                                   block=1 << 19)
    n_extra = 0 if extra_attrs is None else extra_attrs.shape[1]
    return compose(blended, t_final, bg, normalize_depth, n_extra)


# texgs's backend names -> the port's path for the blend and the M-lists
_PATHS = {"auto": "fused", "fused": "fused", "pallas": "two_kernel",
          "scan": "two_kernel", "reference": "reference"}
TEX_BACKENDS = ("auto", "xla", "textile")


def resolve_backends(backend: str = "auto", tex_backend: str = "auto"):
    """texgs's ``backend`` and ``tex_backend`` (texgs uvtex_raster.py:421)
    -> the port's path for the blend and the M-lists: ``"fused"``,
    ``"two_kernel"`` or ``"reference"``.

    ``auto`` and ``fused`` take the fused path (kernel A) on every device
    (texgs's ``auto`` takes its oracle on the CPU for N <= 4096); ``pallas``
    and ``scan``, which texgs runs as two passes (its Pallas kernels or
    their XLA twins), take the two-kernel path (kernels 1 and 2);
    ``reference`` takes the dense oracle, ``rasterize_uvtex_reference``.
    Every ``tex_backend`` takes the exact texture term of kernel B: texgs's
    ``textile`` is a windowed approximation of that same term (ROADMAP.md
    queue 2, item 4), and its ``xla`` is the term itself."""
    if backend not in _PATHS:
        raise ValueError(f"unknown backend {backend!r}; one of "
                         f"{sorted(_PATHS)}")
    if tex_backend not in TEX_BACKENDS:
        raise ValueError(f"unknown tex_backend {tex_backend!r}; one of "
                         f"{list(TEX_BACKENDS)}")
    return _PATHS[backend]


def rasterize_uvtex(proj: ProjectedGaussians, scaling, rotation, xyz,
                    uvs, grad_uvs, texture, shs, active_sh_degree: int,
                    camera: Camera, bg: torch.Tensor, m: int = 32,
                    filter_mode: str = "bilinear", with_no_sh: bool = False,
                    m_tail: bool = False, backend: str = "auto",
                    tex_backend: str = "auto", normalize_depth: bool = True,
                    row_offset: Optional[int] = None,
                    band_height: Optional[int] = None) -> RasterOutput:
    """Full UV-texture rasterization with the exact texture term.

    backend, tex_backend: texgs's names (``resolve_backends``): the fused
    path (kernel A) for ``auto`` and ``fused``, the two-kernel path
    (kernels 1 and 2) for ``pallas`` and ``scan``, the dense oracle for
    ``reference`` (``m`` and ``m_tail`` then have no part); kernel B's
    exact texture term for every ``tex_backend``.
    proj's colors are not read (the base SH residual takes their place
    here; uv_tex_render passes None).
    with_no_sh: also return ``image_no_sh``, the texture-only image a
    second rasterization at active_sh_degree=0 would give.  The
    per-intersection color is linear in the per-Gaussian SH term, so one
    blend pass suffices: ``clamp(.5+SH_rest) - .5`` rides as 3 extra blend
    channels and is subtracted from the composited image.  The kernel thus
    sees F = 10 blend channels with the no-SH image, else F = 7.
    normalize_depth=False leaves the depth channel the blended sum (a
    depth slice's, folded later; texgs gauss_sharded.py:263).
    row_offset, band_height: render the band of rows [row_offset,
    row_offset + band_height) as a short image (texgs :450-553): the
    projected means move up by row_offset and c0 of the rays down by it
    (``ray_constants``), so the kernels see band-local tiles only and no
    kernel takes an argument for it.  A tiled path only.
    """
    from texgs_torch.kernels.raster import raster_pairs
    from texgs_torch.kernels.tex_term import tex_term
    from texgs_torch.kernels.uvtex_fused import fused_pairs
    from texgs_torch.kernels.uvtex_mlist import mlist_pairs

    path = resolve_backends(backend, tex_backend)
    base_colors = residual_sh_colors(shs, xyz, torch.as_tensor(
        camera.camera_center, device=xyz.device), active_sh_degree)
    proj = proj._replace(colors=base_colors)

    append_ns = with_no_sh and shs is not None and active_sh_degree > 0
    extra_attrs = base_colors - 0.5 if append_ns else None
    n_extra = 0 if extra_attrs is None else extra_attrs.shape[1]

    tables = build_uvtex_tables(xyz, scaling, rotation, uvs, grad_uvs,
                                torch.as_tensor(camera.camera_center,
                                                device=xyz.device))
    if path == "reference":
        if row_offset is not None:
            raise ValueError("band rendering needs a tiled backend, not "
                             "reference")
        out = rasterize_uvtex_reference(proj, tables, texture, camera, bg,
                                        extra_attrs, normalize_depth,
                                        filter_mode=filter_mode)
        return _with_no_sh(out, with_no_sh, append_ns)
    height, width = camera.height, camera.width
    if row_offset is not None:
        proj, height = band_rows(proj, row_offset, band_height)
    with span("render.binning"):
        pairs = build_pairs(proj.means2d, proj.depths, proj.radii, height,
                            width)
        # kernel A, or kernels 1, 2, 1' and 2', take the tiles heaviest first
        pairs = with_tile_order(pairs)
    table = build_gauss_table(proj, extra_attrs)
    uv_rows, rays = build_uv_rows(tables), ray_constants(camera, row_offset)
    gx = grid_shape(height, width)[1]
    with span("render.blend"):
        if path == "fused":
            tiles_out, t_final, mlist, _ = fused_pairs(table, uv_rows, pairs,
                                                       rays, gx, m)
        else:
            tiles_out, t_final, _ = raster_pairs(table, pairs, gx)
            mlist = mlist_pairs(table, uv_rows, pairs, rays, gx, m)
        base = assemble_image(tiles_out, t_final, height, width, bg, n_extra,
                              normalize_depth)
    with span("render.tex_term"):
        tex_img = tex_term(mlist, texture, height, width, filter_mode)
        if m_tail:
            tex_img = tex_img + tail_tex_term(mlist, t_final, texture, height,
                                              width, filter_mode)

    out = RasterOutput(image=base.image + tex_img, depth=base.depth,
                       norm=base.norm, alpha=base.alpha, extra=base.extra,
                       n_pairs=pairs.n_pairs, overflowed=pairs.overflowed)
    return _with_no_sh(out, with_no_sh, append_ns)


def _with_no_sh(out: RasterOutput, with_no_sh: bool,
                append_ns: bool) -> RasterOutput:
    """The texture-only image from the blended SH channels."""
    if not with_no_sh:
        return out
    if not append_ns:
        # degree 0 (or no residual SH): the no-SH render IS the render
        return out._replace(image_no_sh=out.image)
    return out._replace(image_no_sh=out.image - out.extra, extra=None)
