"""Cubemap sampling and cube <-> latlong conversion (port of texgs/kernels/cubemap.py).

Face convention (OpenGL cube-map order +x,-x,+y,-y,+z,-z):
  face 0 (+x): u = -z/|x|, v = -y/|x|      face 1 (-x): u =  z/|x|, v = -y/|x|
  face 2 (+y): u =  x/|y|, v =  z/|y|      face 3 (-y): u =  x/|y|, v = -z/|y|
  face 4 (+z): u =  x/|z|, v = -y/|z|      face 5 (-z): u = -x/|z|, v = -y/|z|
Default 'bilinear' filtering is SEAMLESS: taps that cross a face edge are
re-resolved through their 3D direction onto the adjacent face, and taps at
the 8 cube corners average the 3 face-corner texels.  This module is the
plain version of the tap math in csrc/tex_term.cu.
"""

from __future__ import annotations

import math

import torch


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
