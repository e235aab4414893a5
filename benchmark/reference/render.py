"""Plain PyTorch stage-3 render: projection, binning, the front-to-back
blend with per-pixel M-lists, the seamless cubemap and the texture term.

Frozen copies, differentiable by autograd, of:
  texgs_torch/kernels/project.py      project_gaussians, compute_cov2d,
                                      flat_normals
  texgs_torch/utils/transforms.py     rotation_channels,
                                      build_covariance_packed
  texgs_torch/utils/sh.py             eval_sh (degrees 0-3)
  texgs_torch/kernels/reference.py    tile_rect and the blend constants
  texgs_torch/kernels/binning.py      build_pairs
  texgs_torch/kernels/tile_raster.py  build_gauss_table, shift_to_tile,
                                      tile_power, chunk_weights,
                                      tiles_to_image, assemble_image
  texgs_torch/kernels/uvtex_raster.py residual_sh_colors,
                                      build_uvtex_tables, ray_constants,
                                      intersect_uv, rasterize_uvtex
  texgs_torch/kernels/uvtex_fused.py  mlist_scan (kernel A's plain version)
  texgs_torch/kernels/cubemap.py      sample_cubemap (seamless bilinear)
  texgs_torch/kernels/tex_term.py     mlist_tex_term (kernel B's plain
                                      version)
The M-list and texture term are differentiated by autograd, never by a
written-out VJP.  Nothing here imports the program.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

TILE = 16
PIX = TILE * TILE
ALPHA_CLAMP = 0.99
MIN_ALPHA = 1.0 / 255.0
T_STOP = 1e-4
NEAR_CULL = 0.2
COV2D_DILATION = 0.3
T_STAR_MAX = 1e4
NEG_INF = -1e20
CHUNK = 64          # pairs of each tile taken per step of the scan
C0 = 0.28209479177387814
C1 = 0.4886025119029199
C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
      -1.0925484305920792, 0.5462742152960396)
C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
      0.3731763325901154, -0.4570457994644658, 1.445305721320277,
      -0.5900435899266435)
# table columns: quad 0..5, log-opacity 6, rgb 7..9, depth 10, normal
# 11..13, anchor corner 14..15, extra channels 16..
ROW_LOGOP, ROW_F0, COL_ANCHOR, TABLE_FIXED = 6, 7, 14, 16


class Cam(NamedTuple):
    world_view: np.ndarray   # (4, 4) float32, row-vector world -> view
    full_proj: np.ndarray    # (4, 4) float32, row-vector world -> clip
    campos: np.ndarray       # (3,) float32
    width: int
    height: int
    fovx: float
    fovy: float

    @property
    def tanfovx(self) -> float:
        return math.tan(self.fovx * 0.5)

    @property
    def tanfovy(self) -> float:
        return math.tan(self.fovy * 0.5)


# ------------------------------------------------------------ geometry
def rotation_channels(q):
    q = q / (torch.linalg.norm(q, dim=-1, keepdim=True) + 1e-12)
    r, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return (1 - 2 * (y * y + z * z), 2 * (x * y - r * z), 2 * (x * z + r * y),
            2 * (x * y + r * z), 1 - 2 * (x * x + z * z), 2 * (y * z - r * x),
            2 * (x * z - r * y), 2 * (y * z + r * x), 1 - 2 * (x * x + y * y))


def covariance_packed(scaling, rotation):
    r00, r01, r02, r10, r11, r12, r20, r21, r22 = rotation_channels(rotation)
    s0, s1, s2 = scaling[..., 0] ** 2, scaling[..., 1] ** 2, scaling[..., 2] ** 2
    return torch.stack([
        s0 * r00 * r00 + s1 * r01 * r01 + s2 * r02 * r02,
        s0 * r00 * r10 + s1 * r01 * r11 + s2 * r02 * r12,
        s0 * r00 * r20 + s1 * r01 * r21 + s2 * r02 * r22,
        s0 * r10 * r10 + s1 * r11 * r11 + s2 * r12 * r12,
        s0 * r10 * r20 + s1 * r11 * r21 + s2 * r12 * r22,
        s0 * r20 * r20 + s1 * r21 * r21 + s2 * r22 * r22], dim=-1)


def eval_sh(deg: int, sh, dirs):
    """sh (..., C, K), dirs (..., 3) -> (..., C), degrees 0-3."""
    result = C0 * sh[..., 0]
    if deg > 0:
        x, y, z = dirs[..., 0:1], dirs[..., 1:2], dirs[..., 2:3]
        result = (result - C1 * y * sh[..., 1] + C1 * z * sh[..., 2]
                  - C1 * x * sh[..., 3])
        if deg > 1:
            xx, yy, zz = x * x, y * y, z * z
            xy, yz, xz = x * y, y * z, x * z
            result = (result + C2[0] * xy * sh[..., 4] + C2[1] * yz * sh[..., 5]
                      + C2[2] * (2.0 * zz - xx - yy) * sh[..., 6]
                      + C2[3] * xz * sh[..., 7] + C2[4] * (xx - yy) * sh[..., 8])
            if deg > 2:
                result = (result
                          + C3[0] * y * (3 * xx - yy) * sh[..., 9]
                          + C3[1] * xy * z * sh[..., 10]
                          + C3[2] * y * (4 * zz - xx - yy) * sh[..., 11]
                          + C3[3] * z * (2 * zz - 3 * xx - 3 * yy) * sh[..., 12]
                          + C3[4] * x * (4 * zz - xx - yy) * sh[..., 13]
                          + C3[5] * z * (xx - yy) * sh[..., 14]
                          + C3[6] * x * (xx - 3 * yy) * sh[..., 15])
    return result


class Projected(NamedTuple):
    means2d: torch.Tensor
    depths: torch.Tensor
    conics: torch.Tensor
    radii: torch.Tensor
    opacities: torch.Tensor
    normals: torch.Tensor


def project(xyz, scaling, rotation, opacity, cam: Cam) -> Projected:
    """EWA projection: cull, centres, +0.3 px dilated conics, 3-sigma radii,
    camera-facing shortest-axis normals."""
    dev = xyz.device
    wv = torch.as_tensor(cam.world_view, device=dev, dtype=xyz.dtype)
    fp = torch.as_tensor(cam.full_proj, device=dev, dtype=xyz.dtype)
    campos = torch.as_tensor(cam.campos, device=dev, dtype=xyz.dtype)
    w, h = cam.width, cam.height
    focal_x, focal_y = w / (2.0 * cam.tanfovx), h / (2.0 * cam.tanfovy)
    cov3d = covariance_packed(scaling, rotation)

    ones = torch.ones_like(xyz[:, :1])
    p_hom = torch.cat([xyz, ones], dim=-1) @ fp
    p_w = 1.0 / (p_hom[:, 3] + 1e-7)
    ndc = p_hom[:, :2] * p_w[:, None]
    means2d = torch.stack([((ndc[:, 0] + 1.0) * w - 1.0) * 0.5,
                           ((ndc[:, 1] + 1.0) * h - 1.0) * 0.5], dim=-1)
    depths = p_hom[:, 3]

    t = (torch.cat([xyz, ones], dim=-1) @ wv)[:, :3]
    limx, limy = 1.3 * cam.tanfovx, 1.3 * cam.tanfovy
    tz = t[:, 2]
    txtz = torch.clamp(t[:, 0] / tz, -limx, limx) * tz
    tytz = torch.clamp(t[:, 1] / tz, -limy, limy) * tz
    inv_z = 1.0 / tz
    inv_z2 = inv_z * inv_z
    a0, c0 = focal_x * inv_z, -focal_x * txtz * inv_z2
    b1, c1 = focal_y * inv_z, -focal_y * tytz * inv_z2
    W = wv[:3, :3].T
    rows = []
    for (i, j) in [(0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2)]:
        wi, wj = W[i], W[j]
        rows.append(torch.stack([
            wi[0] * wj[0], wi[0] * wj[1] + wi[1] * wj[0],
            wi[0] * wj[2] + wi[2] * wj[0], wi[1] * wj[1],
            wi[1] * wj[2] + wi[2] * wj[1], wi[2] * wj[2]]))
    q = cov3d @ torch.stack(rows, dim=1)
    s00, s01, s02, s11, s12, s22 = q.unbind(dim=1)
    a = a0 * a0 * s00 + 2 * a0 * c0 * s02 + c0 * c0 * s22 + COV2D_DILATION
    b = a0 * b1 * s01 + a0 * c1 * s02 + c0 * b1 * s12 + c0 * c1 * s22
    c = b1 * b1 * s11 + 2 * b1 * c1 * s12 + c1 * c1 * s22 + COV2D_DILATION

    det = a * c - b * b
    det_ok = det != 0.0
    inv_det = torch.where(det_ok, 1.0 / torch.where(det_ok, det,
                                                    torch.ones_like(det)),
                          torch.zeros_like(det))
    conics = torch.stack([c * inv_det, -b * inv_det, a * inv_det], dim=-1)
    mid = 0.5 * (a + c)
    lam1 = mid + torch.sqrt(torch.clamp(mid * mid - det, min=0.1))
    radius = torch.ceil(3.0 * torch.sqrt(lam1))
    op = opacity.reshape(-1)
    visible = (depths > NEAR_CULL) & det_ok & (op > 0.0)
    radii = torch.where(visible, radius, torch.zeros_like(radius)).to(torch.int32)
    op = torch.where(visible, op, torch.zeros_like(op))

    r00, r01, r02, r10, r11, r12, r20, r21, r22 = rotation_channels(rotation)
    idx = torch.argmin(scaling, dim=-1)
    is0, is1 = idx == 0, idx == 1
    n = torch.stack([torch.where(is0, r00, torch.where(is1, r01, r02)),
                     torch.where(is0, r10, torch.where(is1, r11, r12)),
                     torch.where(is0, r20, torch.where(is1, r21, r22))], -1)
    sign = torch.sign((n * (campos[None, :] - xyz)).sum(-1, keepdim=True))
    sign = torch.where(sign == 0, torch.ones_like(sign), sign)
    return Projected(means2d, depths, conics, radii, op, n * sign)


# ------------------------------------------------------------- binning
class Pairs(NamedTuple):
    pair_gauss: torch.Tensor   # (P,) int64, (tile, depth) order
    tile_start: torch.Tensor   # (T,) int64
    tile_counts: torch.Tensor  # (T,) int64


def grid_shape(height: int, width: int):
    return -(-height // TILE), -(-width // TILE)


def tile_rect(means2d, radii, width: int, height: int):
    """The covered tile rectangle [min, max): the 3-sigma tile rule."""
    gy, gx = grid_shape(height, width)
    r = radii.to(torch.float32)
    px, py = means2d[:, 0], means2d[:, 1]
    xmin = torch.clamp(((px - r) / TILE).to(torch.int32), 0, gx)
    xmax = torch.clamp(((px + r + TILE - 1) / TILE).to(torch.int32), 0, gx)
    ymin = torch.clamp(((py - r) / TILE).to(torch.int32), 0, gy)
    ymax = torch.clamp(((py + r + TILE - 1) / TILE).to(torch.int32), 0, gy)
    return xmin, xmax, ymin, ymax


def build_pairs(means2d, depths, radii, height: int, width: int) -> Pairs:
    """One pair per covered tile of every visible Gaussian, in (tile,
    depth rank) order, ties by index."""
    dev = means2d.device
    n = means2d.shape[0]
    gy, gx = grid_shape(height, width)
    xmin, xmax, ymin, ymax = tile_rect(means2d, radii, width, height)
    visible = radii > 0
    rect_w = (xmax - xmin).to(torch.int64)
    per_g = torch.where(visible, rect_w * (ymax - ymin).to(torch.int64), 0)
    n_total = int(per_g.sum())
    key = torch.where(visible, depths, torch.full_like(depths, torch.inf))
    order_g = torch.sort(key, stable=True).indices
    rank = torch.empty(n, dtype=torch.int64, device=dev)
    rank[order_g] = torch.arange(n, dtype=torch.int64, device=dev)
    offs = torch.cumsum(per_g, 0) - per_g
    g = torch.repeat_interleave(torch.arange(n, device=dev), per_g,
                                output_size=n_total)
    local = torch.arange(n_total, dtype=torch.int64, device=dev) - offs[g]
    w_g = torch.clamp(rect_w[g], min=1)
    tile = ((ymin[g].to(torch.int64) + local // w_g) * gx
            + xmin[g].to(torch.int64) + local % w_g)
    order = torch.sort(tile * n + rank[g], stable=True).indices
    counts = torch.bincount(tile[order], minlength=gy * gx)
    return Pairs(g[order], torch.cumsum(counts, 0) - counts, counts)


# ----------------------------------------------------- the tile blend
def tile_basis(device):
    idx = torch.arange(PIX, device=device)
    dt = torch.get_default_dtype()
    x, y = (idx % TILE).to(dt), (idx // TILE).to(dt)
    return torch.stack([x * x, y * y, x * y, x, y, torch.ones_like(x)], -1)


def gauss_table(p: Projected, colors, extra=None):
    """(N, 16 + E) rows: the exponent's quadratic in the anchor tile's
    frame, log-opacity, rgb, depth, normal, anchor corner, extras."""
    mx, my = p.means2d[:, 0], p.means2d[:, 1]
    a, b, c = p.conics.unbind(dim=1)
    logop = torch.log(torch.clamp(p.opacities, min=1e-12))
    ax, ay = torch.floor(mx / TILE) * TILE, torch.floor(my / TILE) * TILE
    mxa, mya = mx - ax, my - ay
    cols = [-0.5 * a, -0.5 * c, -b, a * mxa + b * mya, c * mya + b * mxa,
            -0.5 * (a * mxa * mxa + c * mya * mya) - b * mxa * mya + logop,
            logop, colors[:, 0], colors[:, 1], colors[:, 2], p.depths,
            p.normals[:, 0], p.normals[:, 1], p.normals[:, 2], ax, ay]
    if extra is not None:
        cols.extend(extra.unbind(dim=1))
    return torch.stack(cols, dim=1)


def shift_to_tile(rows, tile_x, tile_y):
    dtx = tile_x - rows[..., COL_ANCHOR]
    dty = tile_y - rows[..., COL_ANCHOR + 1]
    qxx, qyy, qxy = rows[..., 0], rows[..., 1], rows[..., 2]
    qx_a, qy_a, qc_a = rows[..., 3], rows[..., 4], rows[..., 5]
    qx = qx_a + 2.0 * qxx * dtx + qxy * dty
    qy = qy_a + 2.0 * qyy * dty + qxy * dtx
    qc = (qc_a + qxx * dtx * dtx + qyy * dty * dty + qxy * dtx * dty
          + qx_a * dtx + qy_a * dty)
    return torch.stack([qxx, qyy, qxy, qx, qy, qc], dim=-1)


def tile_power(quad):
    """quad (..., K, 6) -> the exponent at the 256 tile pixels (..., PIX, K),
    term by term, left to right."""
    basis = tile_basis(quad.device)
    x, y = basis[:, 3:4], basis[:, 4:5]
    q = [quad[..., None, :, i] for i in range(6)]
    return x * x * q[0] + y * y * q[1] + x * y * q[2] + x * q[3] + y * q[4] + q[5]


def chunk_weights(power, logop, t_in, done_in):
    """Front-to-back weights of one depth-ordered chunk with the 3DGS
    sequential stop: alpha = min(0.99, exp(power)), skipped where the raw
    exponent is positive or alpha < 1/255; stop before T < 1e-4."""
    alpha = torch.clamp(torch.exp(power), max=ALPHA_CLAMP)
    alpha = torch.where(power - logop > 0.0, 0.0, alpha)
    alpha = torch.where(alpha < MIN_ALPHA, 0.0, alpha)
    one_minus = 1.0 - alpha
    excl = torch.cat([torch.ones_like(one_minus[..., :1]),
                      torch.cumprod(one_minus[..., :-1], dim=-1)], dim=-1)
    t_excl = t_in[..., None] * excl
    fail = t_excl * one_minus < T_STOP
    done = done_in[..., None] | (torch.cumsum(fail.to(torch.int32), -1) > 0)
    w = alpha * t_excl * (~done)
    t_out = t_in * torch.prod(torch.where(done, 1.0, one_minus), dim=-1)
    return w, t_out, done, fail


def ray_constants(cam: Cam) -> np.ndarray:
    """(3, 3) rows [ax, by, c0]: the world ray d(px, py) = c0 + px ax + py by."""
    Wm = np.asarray(cam.world_view, np.float32)[:3, :3]
    w, h = cam.width, cam.height
    ax = Wm @ np.array([2.0 * cam.tanfovx / w, 0.0, 0.0], np.float32)
    by = Wm @ np.array([0.0, 2.0 * cam.tanfovy / h, 0.0], np.float32)
    c0 = Wm @ np.array([cam.tanfovx * (1.0 / w - 1.0),
                        cam.tanfovy * (1.0 / h - 1.0), 1.0], np.float32)
    return np.stack([ax, by, c0]).astype(np.float32)


def uv_rows(xyz, scaling, rotation, uvs, jac, campos):
    """(N, 21) rows [sv, siginv (6), base_uv, J]: Sigma^-1 (mu - o), the
    packed inverse covariance, uv_c - J (mu - o) and the (constant)
    Jacobian."""
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
    j = jac.detach()
    jv = torch.stack([j[:, 0] * vx + j[:, 1] * vy + j[:, 2] * vz,
                      j[:, 3] * vx + j[:, 4] * vy + j[:, 5] * vz,
                      j[:, 6] * vx + j[:, 7] * vy + j[:, 8] * vz], dim=-1)
    return torch.cat([sv, torch.stack([sxx, sxy, sxz, syy, syz, szz], -1),
                      uvs - jv, j], dim=1)


def intersect_uv(d, rows):
    """Unit uv* of rays d (..., 3) against uv rows (..., 21)."""
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


def mlist_scan(table, rows, pairs: Pairs, rays: np.ndarray, gx: int, m: int):
    """Blend channels (T, PIX, F), T_final (T, PIX), M-lists (T, PIX, m, 4)
    of [w, uv] and evaluated-pair counts (T, PIX) of every tile, walking
    each tile's depth-sorted pairs CHUNK at a time, all tiles at once."""
    dev = table.device
    n_tiles = pairs.tile_counts.shape[0]
    n_f = table.shape[1] - TABLE_FIXED + 7
    tiles = torch.arange(n_tiles, device=dev)
    tile_x = ((tiles % gx) * TILE).to(table.dtype)
    tile_y = ((tiles // gx) * TILE).to(table.dtype)
    basis = tile_basis(dev)
    r = torch.as_tensor(rays, device=dev, dtype=table.dtype)
    d = (r[2] + (tile_x[:, None] + basis[None, :, 3])[..., None] * r[0]
         + (tile_y[:, None] + basis[None, :, 4])[..., None] * r[1])

    out = torch.zeros((n_tiles, PIX, n_f), device=dev)
    t_buf = torch.ones((n_tiles, PIX), device=dev)
    done = torch.zeros((n_tiles, PIX), dtype=torch.bool, device=dev)
    count = torch.zeros((n_tiles, PIX), dtype=torch.int64, device=dev)
    n_eval = torch.zeros((n_tiles, PIX), dtype=torch.int64, device=dev)
    mlist = torch.zeros((n_tiles * PIX * m, 4), device=dev)
    counts, starts = pairs.tile_counts, pairs.tile_start
    n_pairs = pairs.pair_gauss.shape[0]
    max_count = int(counts.max()) if n_tiles and n_pairs else 0
    for k0 in range(0, max_count, CHUNK):
        k = torch.arange(k0, k0 + CHUNK, device=dev)
        live = k[None, :] < counts[:, None]
        g = pairs.pair_gauss[torch.clamp(starts[:, None] + k[None, :],
                                         max=n_pairs - 1)]
        # index_select: its backward adds rows with atomics; a fancy
        # index's would sort them, serially over repeated rows
        rws = table.index_select(0, g.reshape(-1)).reshape(*g.shape, -1)
        quad = shift_to_tile(rws, tile_x[:, None], tile_y[:, None])
        quad = torch.cat([quad[..., :5], torch.where(
            live, quad[..., 5], NEG_INF)[..., None]], dim=-1)
        power = tile_power(quad)
        logop = rws[..., ROW_LOGOP][:, None, :]
        w, t_out, done_m, fail = chunk_weights(power, logop, t_buf, done)
        feats = torch.cat([rws[..., ROW_F0:COL_ANCHOR], rws[..., TABLE_FIXED:]],
                          dim=-1)
        out = out + torch.bmm(w, feats)
        fi = fail.to(torch.int64)
        stopped = done[..., None] | ((torch.cumsum(fi, -1) - fi) > 0)
        n_eval = n_eval + (live[:, None, :] & ~stopped).sum(-1)
        accept = w > 0.0
        acc_i = accept.to(torch.int64)
        rank = count[..., None] + torch.cumsum(acc_i, -1) - acc_i
        ti, pi, ki = torch.nonzero(accept & (rank < m), as_tuple=True)
        if ti.numel():
            uv = intersect_uv(d[ti, pi], rows.index_select(0, g[ti, ki]))
            slot = (ti * PIX + pi) * m + rank[ti, pi, ki]
            wk = w.reshape(-1).index_select(0, (ti * PIX + pi) * CHUNK + ki)
            mlist = mlist.index_put((slot,), torch.cat([wk[:, None], uv], -1))
        count = count + acc_i.sum(-1)
        t_buf, done = t_out, done_m[..., -1]
    return out, t_buf, mlist.view(n_tiles, PIX, m, 4), n_eval


def tiles_to_image(tiles, height: int, width: int):
    gy, gx = grid_shape(height, width)
    c = tiles.shape[-1]
    img = tiles.reshape(gy, gx, TILE, TILE, c).permute(4, 0, 2, 1, 3)
    return img.reshape(c, gy * TILE, gx * TILE)[:, :height, :width]


# ------------------------------------------------------------- cubemap
def _face_uv(dirs):
    x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    ax, ay, az = x.abs(), y.abs(), z.abs()
    is_x = (ax >= ay) & (ax >= az)
    is_y = (~is_x) & (ay >= az)
    ma = torch.clamp(torch.where(is_x, ax, torch.where(is_y, ay, az)), min=1e-12)
    face = torch.where(is_x, torch.where(x >= 0, 0, 1),
                       torch.where(is_y, torch.where(y >= 0, 2, 3),
                                   torch.where(z >= 0, 4, 5)))
    u = torch.where(is_x, torch.where(x >= 0, -z, z),
                    torch.where(is_y, x, torch.where(z >= 0, x, -x)))
    v = torch.where(is_x, -y, torch.where(is_y, torch.where(y >= 0, z, -z), -y))
    return face, u / ma, v / ma


def face_uv_to_direction(face, u, v):
    one = torch.ones_like(u)
    dirs = torch.stack([
        torch.stack([one, -v, -u], -1), torch.stack([-one, -v, u], -1),
        torch.stack([u, one, v], -1), torch.stack([u, -one, -v], -1),
        torch.stack([u, -v, one], -1), torch.stack([-u, -v, -one], -1)], 0)
    idx = face[None, ..., None].expand((1,) + face.shape + (3,))
    return torch.gather(dirs, 0, idx)[0]


def _texel(coord, res: int):
    return torch.clamp(((coord * 0.5 + 0.5) * res).to(torch.int64), 0, res - 1)


def sample_cubemap(texture, dirs):
    """Seamless bilinear fetch: texture (6, R, R, 3), dirs (N, 3) -> (N, 3).
    Taps past a face edge are re-resolved through their direction onto the
    adjacent face; a tap past two edges averages the three texels.  The
    texel indices carry no gradient; the fetches are ``index_select``s of
    the flattened texture."""
    res = texture.shape[1]
    flat = texture.reshape(-1, 3)
    face, u, v = _face_uv(dirs)
    fu = (u * 0.5 + 0.5) * res - 0.5
    fv = (v * 0.5 + 0.5) * res - 0.5
    x0, y0 = torch.floor(fu).detach(), torch.floor(fv).detach()
    wx, wy = (fu - x0)[..., None], (fv - y0)[..., None]

    def index(f, y, x):
        return (f * res + y) * res + x

    def reresolve(u_t, v_t):
        f2, u2, v2 = _face_uv(face_uv_to_direction(face, u_t, v_t))
        return index(f2, _texel(v2, res), _texel(u2, res))

    def tap(xi, yi):
        with torch.no_grad():
            u_t = (xi + 0.5) / res * 2.0 - 1.0
            v_t = (yi + 0.5) / res * 2.0 - 1.0
            out_u = (u_t.abs() > 1.0)[..., None]
            out_v = (v_t.abs() > 1.0)[..., None]
            lim = 1.0 - 1.0 / res
            ip = reresolve(u_t, torch.clamp(v_t, -lim, lim))
            iq = reresolve(torch.clamp(u_t, -lim, lim), v_t)
            ir = index(face, torch.clamp(yi.to(torch.int64), 0, res - 1),
                       torch.clamp(xi.to(torch.int64), 0, res - 1))
        P, Q, R = (flat.index_select(0, i) for i in (ip, iq, ir))
        return torch.where(out_u & out_v, (P + Q + R) / 3.0,
                           torch.where(out_u, P, torch.where(out_v, Q, R)))

    top = tap(x0, y0) * (1 - wx) + tap(x0 + 1, y0) * wx
    bot = tap(x0, y0 + 1) * (1 - wx) + tap(x0 + 1, y0 + 1) * wx
    return top * (1 - wy) + bot * wy


def tex_term(mlist, texture, height: int, width: int):
    """C0 * sum_m w_m * sample_cubemap(texture, uv_m) -> (3, H, W), over
    the live slots (w != 0): a dead slot adds nothing and its zeros come
    from no input."""
    t, pix, m, _ = mlist.shape
    flat = mlist.reshape(-1, 4)
    live = torch.nonzero(flat[:, 0] != 0).squeeze(1)
    sl = flat.index_select(0, live)
    term = C0 * sl[:, :1] * sample_cubemap(texture, sl[:, 1:4])
    img = torch.zeros((t * pix, 3), dtype=mlist.dtype, device=mlist.device)
    return tiles_to_image(img.index_add(0, live // m, term).reshape(t, pix, 3),
                          height, width)


def texels_touched(mlist, res: int) -> int:
    """Texels that some live slot's seamless bilinear taps weight nonzero:
    the gradient of the term with unit weights, counted."""
    live = mlist[mlist[..., 0] != 0][:, 1:4]
    with torch.enable_grad():
        probe = torch.ones((6, res, res, 3), device=mlist.device,
                           requires_grad=True)
        sample_cubemap(probe, live).sum().backward()
    return int((probe.grad.abs().sum(-1) > 0).sum())


# -------------------------------------------------------------- render
def render(cam: Cam, xyz, opacity, scaling, rotation, uvs, jac, texture, shs,
           active_sh_degree: int, bg, m: int, with_no_sh: bool,
           keep: Optional[dict] = None) -> dict:
    """The stage-3 render from activated Gaussians (opacity in [0, 1],
    scaling positive, rotation normalised), uvs (N, 3) and their (N, 9)
    Jacobian: image, no-SH image, depth, normal, alpha.  ``keep`` receives
    the pair list and the M-lists, which the benchmark's counts read."""
    dev = xyz.device
    campos = torch.as_tensor(cam.campos, device=dev, dtype=xyz.dtype)
    proj = project(xyz, scaling, rotation, opacity, cam)
    n = xyz.shape[0]
    if shs is None or active_sh_degree == 0:
        colors = torch.full((n, 3), 0.5, device=dev)
    else:
        dirs = xyz - campos[None, :]
        dirs = dirs / (torch.linalg.norm(dirs, dim=-1, keepdim=True) + 1e-12)
        full = torch.cat([torch.zeros((n, 1, 3), device=dev), shs], dim=1)
        colors = torch.clamp(0.5 + eval_sh(active_sh_degree,
                                           full.transpose(-1, -2), dirs), min=0.0)
    append_ns = with_no_sh and shs is not None and active_sh_degree > 0
    table = gauss_table(proj, colors, colors - 0.5 if append_ns else None)
    rows = uv_rows(xyz, scaling, rotation, uvs, jac, campos)
    h, w = cam.height, cam.width
    pairs = build_pairs(proj.means2d, proj.depths, proj.radii, h, w)
    blend, t_final, mlist, n_eval = mlist_scan(table, rows, pairs,
                                               ray_constants(cam),
                                               grid_shape(h, w)[1], m)
    if keep is not None:
        keep.update(pairs=pairs, mlist=mlist.detach(), n_eval=n_eval,
                    n_f=blend.shape[-1])
    img = tiles_to_image(blend, h, w)
    t_fin = tiles_to_image(t_final[..., None], h, w)
    alpha = 1.0 - t_fin
    image = img[0:3] + t_fin * bg[:, None, None] + tex_term(mlist, texture, h, w)
    depth = img[3:4] / torch.clamp(alpha, min=1e-6)
    image_ns = image - img[7:10] if append_ns else image
    return dict(image=image, image_no_sh=image_ns, depth=depth, norm=img[4:7],
                alpha=alpha)


def sphere_texel_dirs(res: int, device) -> torch.Tensor:
    """(6, R, R, 3) unit directions of the cubemap's texel centres."""
    c = (torch.arange(res, device=device, dtype=torch.float32) + 0.5) / res * 2 - 1
    v, u = torch.meshgrid(c, c, indexing="ij")
    face = torch.arange(6, device=device)[:, None, None].expand(6, res, res)
    d = face_uv_to_direction(face, u.expand(6, res, res), v.expand(6, res, res))
    return d / torch.linalg.norm(d, dim=-1, keepdim=True)

