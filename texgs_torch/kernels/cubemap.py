"""Cubemap sampling and cube <-> latlong conversion (port of texgs/kernels/cubemap.py).

Face convention (OpenGL cube-map order +x,-x,+y,-y,+z,-z):
  face 0 (+x): u = -z/|x|, v = -y/|x|      face 1 (-x): u =  z/|x|, v = -y/|x|
  face 2 (+y): u =  x/|y|, v =  z/|y|      face 3 (-y): u =  x/|y|, v = -z/|y|
  face 4 (+z): u =  x/|z|, v = -y/|z|      face 5 (-z): u = -x/|z|, v = -y/|z|
Default 'bilinear' filtering is SEAMLESS: taps that cross a face edge are
re-resolved through their 3D direction onto the adjacent face, and taps at
the 8 cube corners average the 3 face-corner texels.  This module is the
plain version of the tap math in csrc/tex_term.cu and
csrc/cubemap_maps.cu.

``cubemap_maps`` makes one of the viewer's two maps of an SH0 texture
(the latlong panorama or the cross image, after ``sh02rgb``): the plain
functions below for CPU tensors, one launch of csrc/cubemap_maps.cu for
CUDA tensors.  Each launch adds one to ``cubemap_maps.launches``.
"""

from __future__ import annotations

import math

import torch

from texgs_torch import _build
from texgs_torch.utils.sh import sh02rgb
from texgs_torch.utils.spans import spanned


def direction_to_face_uv(dirs: torch.Tensor):
    """dirs: (..., 3) -> (face int64, u, v in [-1, 1])."""
    x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    ax, ay, az = x.abs(), y.abs(), z.abs()

    is_x = (ax >= ay) & (ax >= az)
    is_y = (~is_x) & (ay >= az)

    ma = torch.where(is_x, ax, torch.where(is_y, ay, az))
    ma = torch.clamp(ma, min=1e-12)

    face = torch.where(
        is_x, torch.where(x >= 0, 0, 1),
        torch.where(is_y, torch.where(y >= 0, 2, 3),
                    torch.where(z >= 0, 4, 5)))
    u = torch.where(is_x, torch.where(x >= 0, -z, z),
                    torch.where(is_y, x, torch.where(z >= 0, x, -x)))
    v = torch.where(is_x, -y,
                    torch.where(is_y, torch.where(y >= 0, z, -z), -y))
    return face, u / ma, v / ma


def face_uv_to_direction(face: torch.Tensor, u: torch.Tensor, v: torch.Tensor):
    """Inverse of direction_to_face_uv (unnormalized direction)."""
    one = torch.ones_like(u)
    dirs = torch.stack([
        torch.stack([one, -v, -u], -1),   # +x
        torch.stack([-one, -v, u], -1),   # -x
        torch.stack([u, one, v], -1),     # +y
        torch.stack([u, -one, -v], -1),   # -y
        torch.stack([u, -v, one], -1),    # +z
        torch.stack([-u, -v, -one], -1),  # -z
    ], dim=0)
    idx = face[None, ..., None].expand((1,) + face.shape + (3,))
    return torch.gather(dirs, 0, idx)[0]


def _texel_index(coord: torch.Tensor, res: int) -> torch.Tensor:
    """(c * 0.5 + 0.5) * res truncated to an int texel index in [0, res)."""
    return torch.clamp(((coord * 0.5 + 0.5) * res).to(torch.int64), 0, res - 1)


def sample_cubemap(texture: torch.Tensor, dirs: torch.Tensor,
                   filter_mode: str = "bilinear") -> torch.Tensor:
    """Cubemap fetch.  texture: (6, R, R, 3); dirs: (N, 3) any norm.
    Returns (N, 3).

    filter_mode: 'bilinear' (4 taps, seamless across face edges, 3-texel
    average at cube corners), 'bilinear_clamp' (4 taps clamped at face
    edges) or 'nearest' (1 tap)."""
    res = texture.shape[1]
    face, u, v = direction_to_face_uv(dirs)

    if filter_mode == "nearest":
        return texture[face, _texel_index(v, res), _texel_index(u, res)]
    if filter_mode not in ("bilinear", "bilinear_clamp"):
        raise ValueError(f"unknown filter_mode {filter_mode!r}")

    fu = (u * 0.5 + 0.5) * res - 0.5
    fv = (v * 0.5 + 0.5) * res - 0.5
    x0 = torch.floor(fu)
    y0 = torch.floor(fv)
    wx = (fu - x0)[..., None]
    wy = (fv - y0)[..., None]

    def clamped(xi, yi):
        xi = torch.clamp(xi.to(torch.int64), 0, res - 1)
        yi = torch.clamp(yi.to(torch.int64), 0, res - 1)
        return texture[face, yi, xi]

    def reresolve(u_t, v_t):
        # texel centers map to u_t = (xi + .5)/res*2 - 1 (|u_t| > 1 past
        # the edge); the majorant axis of the reconstructed direction
        # selects the adjacent face, and the gnomonic re-projection lands
        # on the angular-nearest texel across the edge
        f2, u2, v2 = direction_to_face_uv(face_uv_to_direction(face, u_t, v_t))
        return texture[f2, _texel_index(v2, res), _texel_index(u2, res)]

    def seamless(xi, yi):
        u_t = (xi + 0.5) / res * 2.0 - 1.0
        v_t = (yi + 0.5) / res * 2.0 - 1.0
        out_u = (u_t.abs() > 1.0)[..., None]
        out_v = (v_t.abs() > 1.0)[..., None]
        lim = 1.0 - 1.0 / res
        uc = torch.clamp(u_t, -lim, lim)
        vc = torch.clamp(v_t, -lim, lim)
        P = reresolve(u_t, vc)   # crosses the u edge (v held in-face)
        Q = reresolve(uc, v_t)   # crosses the v edge (u held in-face)
        R = clamped(xi, yi)      # the home face's clamped texel
        return torch.where(out_u & out_v, (P + Q + R) / 3.0,
                           torch.where(out_u, P, torch.where(out_v, Q, R)))

    tap = seamless if filter_mode == "bilinear" else clamped
    t00 = tap(x0, y0)
    t10 = tap(x0 + 1, y0)
    t01 = tap(x0, y0 + 1)
    t11 = tap(x0 + 1, y0 + 1)
    top = t00 * (1 - wx) + t10 * wx
    bot = t01 * (1 - wx) + t11 * wx
    return top * (1 - wy) + bot * wy


def cubemap_to_latlong(cubemap: torch.Tensor, resolution) -> torch.Tensor:
    """(6, R, R, 3) -> (H, W, 3) equirectangular panorama (NVDIFFREC's
    spherical parameterization)."""
    h, w = resolution
    dev = cubemap.device
    gy = (torch.arange(h, device=dev, dtype=torch.float32) + 0.5) / h
    gx = (torch.arange(w, device=dev, dtype=torch.float32) + 0.5) / w
    gv, gu = torch.meshgrid(gy, gx, indexing="ij")
    sintheta = torch.sin(gv * math.pi)
    costheta = torch.cos(gv * math.pi)
    sinphi = torch.sin(gu * 2 * math.pi - math.pi)
    cosphi = torch.cos(gu * 2 * math.pi - math.pi)
    dirs = torch.stack([sintheta * sinphi, costheta, -sintheta * cosphi], -1)
    return sample_cubemap(cubemap, dirs.reshape(-1, 3)).reshape(h, w, 3)


def chessboard_cubemap(resolution: int = 6, cell: int = 16,
                       device="cuda") -> torch.Tensor:
    """Cyan/red checkerboard on all six faces, (6, n, n, 3) with
    n = resolution * cell."""
    n = resolution * cell
    i = torch.arange(n, device=device) // cell
    parity = (i[:, None] + i[None, :]) % 2
    c0 = torch.tensor([0.0, 1.0, 1.0], device=device)
    c1 = torch.tensor([1.0, 0.0, 0.0], device=device)
    img = torch.where(parity[..., None] == 0, c0, c1)
    return img[None].repeat(6, 1, 1, 1)


# Cross layout (3R, 4R): (row, col) block of each face, as the reference's
# texture export and retexture tools lay it out.
CROSS_BLOCKS = ((1, 2), (1, 0), (0, 1), (2, 1), (1, 1), (1, 3))


def faces_to_cross(faces: torch.Tensor) -> torch.Tensor:
    """(6, R, R, C) faces -> (3R, 4R, C) cross image, zeros elsewhere."""
    res = faces.shape[1]
    out = faces.new_zeros((3 * res, 4 * res, faces.shape[-1]))
    for f, (r, c) in enumerate(CROSS_BLOCKS):
        out[r * res:(r + 1) * res, c * res:(c + 1) * res] = faces[f]
    return out


def cross_to_faces(cross: torch.Tensor) -> torch.Tensor:
    """(3R, 4R, C) cross image -> (6, R, R, C) faces."""
    res = cross.shape[0] // 3
    if cross.shape[:2] != (3 * res, 4 * res):
        raise ValueError(f"cross image must be (3R, 4R, C), got {tuple(cross.shape)}")
    return torch.stack([cross[r * res:(r + 1) * res, c * res:(c + 1) * res]
                        for r, c in CROSS_BLOCKS])


@spanned("kernel.cubemap_maps")
def cubemap_maps(sh0: torch.Tensor, resolution=None) -> torch.Tensor:
    """An rgb map of a (6, R, R, 3) SH0 cubemap, computed anew each call:
    for a ``resolution`` (H, W) the (H, W, 3)
    ``cubemap_to_latlong(sh02rgb(sh0), resolution)``, else the (3R, 4R, 3)
    ``faces_to_cross(sh02rgb(sh0))``.  CPU tensors take those plain
    functions; CUDA tensors one launch of csrc/cubemap_maps.cu, which
    applies sh02rgb to each texel as it reads it."""
    if sh0.device.type == "cpu":
        rgb = sh02rgb(sh0)
        return (faces_to_cross(rgb) if resolution is None
                else cubemap_to_latlong(rgb, resolution))
    res = sh0.shape[1] if sh0.dim() == 4 else 0
    _build.require("cubemap_maps", "sh0", sh0, like=sh0,
                   shape=(6, res, res, 3))
    if res < 1:
        raise ValueError("cubemap_maps: an empty texture")
    if resolution is None:
        out = sh0.new_empty((3 * res, 4 * res, 3))
        _build.launch("cubemap_maps", "cubemap_cross", "PiP", sh0, res, out,
                      like=sh0, counter=cubemap_maps)
    else:
        h, w = int(resolution[0]), int(resolution[1])
        if h < 1 or w < 1:
            raise ValueError(f"cubemap_maps: bad panorama size {resolution}")
        out = sh0.new_empty((h, w, 3))
        _build.launch("cubemap_maps", "cubemap_latlong", "PiiiP", sh0, res, h,
                      w, out, like=sh0, counter=cubemap_maps)
    return out


cubemap_maps.launches = 0
