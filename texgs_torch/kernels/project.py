"""Gaussian projection: EWA splatting (port of texgs/kernels/project.py).

Frustum cull, perspective projection of centers, first-order projection of
the 3D covariance to a 2D screen covariance with the +0.3 px low-pass
dilation, conic + radius, and the flattened-Gaussian shortest-axis world
normal.  Batched elementwise tensor code, in texgs's channel form.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from texgs_torch.utils.sh import eval_sh
from texgs_torch.utils.transforms import (build_covariance_packed,
                                          rotation_channels, strip_symmetric)

# Gaussians closer than this view-space depth are culled (3DGS convention).
NEAR_CULL = 0.2
# Low-pass filter added to the diagonal of the 2D covariance (pixels^2).
COV2D_DILATION = 0.3


class ProjectedGaussians(NamedTuple):
    means2d: torch.Tensor   # (N, 2) pixel coordinates of projected centers
    depths: torch.Tensor    # (N,) view-space z
    conics: torch.Tensor    # (N, 3) inverse 2D covariance (a, b, c) packed
    radii: torch.Tensor     # (N,) int32 screen-space radius (0 = culled)
    colors: torch.Tensor    # (N, 3) per-Gaussian RGB
    opacities: torch.Tensor  # (N,) activated opacity
    normals: torch.Tensor   # (N, 3) world-space unit normal, camera-facing


def ndc2pix(v: torch.Tensor, size: int) -> torch.Tensor:
    return ((v + 1.0) * size - 1.0) * 0.5


def project_points(xyz, full_proj, width: int, height: int,
                   ndc_offset=None):
    """World points -> (pixel xy, clip w), row-vector convention.

    ``ndc_offset`` is an optional (N, 2) zeros tensor added to the NDC
    means: its gradient is the screen-space positional gradient the
    densifier reads, in texgs's NDC units (pixel gradient * [W/2, H/2])."""
    ones = torch.ones_like(xyz[:, :1])
    p_hom = torch.cat([xyz, ones], dim=-1) @ full_proj  # (N, 4)
    p_w = 1.0 / (p_hom[:, 3] + 1e-7)
    ndc_xy = p_hom[:, :2] * p_w[:, None]
    if ndc_offset is not None:
        ndc_xy = ndc_xy + ndc_offset
    means2d = torch.stack([ndc2pix(ndc_xy[:, 0], width),
                           ndc2pix(ndc_xy[:, 1], height)], dim=-1)
    return means2d, p_hom[:, 3]


def compute_cov2d(xyz, cov3d, world_view, tanfovx: float, tanfovy: float,
                  focal_x: float, focal_y: float) -> torch.Tensor:
    """EWA projection of the packed (N, 6) 3D covariance to the packed
    (N, 3) screen covariance (a, b, c), +0.3 dilation applied.

    T = J @ W rows are expanded as T0 = a0 W0 + c0 W2, T1 = b1 W1 + c1 W2,
    so cov2d needs only the six scalars Wi Sigma Wj^T: one (N, 6) x (6, 6)
    contraction plus elementwise math."""
    ones = torch.ones_like(xyz[:, :1])
    t = (torch.cat([xyz, ones], dim=-1) @ world_view)[:, :3]

    limx = 1.3 * tanfovx
    limy = 1.3 * tanfovy
    tz = t[:, 2]
    txtz = torch.clamp(t[:, 0] / tz, -limx, limx) * tz
    tytz = torch.clamp(t[:, 1] / tz, -limy, limy) * tz

    inv_z = 1.0 / tz
    inv_z2 = inv_z * inv_z
    a0 = focal_x * inv_z
    c0 = -focal_x * txtz * inv_z2
    b1 = focal_y * inv_z
    c1 = -focal_y * tytz * inv_z2

    W = world_view[:3, :3].T  # world->view rotation, column form
    rows = []
    for (i, j) in [(0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2)]:
        wi, wj = W[i], W[j]
        rows.append(torch.stack([
            wi[0] * wj[0],
            wi[0] * wj[1] + wi[1] * wj[0],
            wi[0] * wj[2] + wi[2] * wj[0],
            wi[1] * wj[1],
            wi[1] * wj[2] + wi[2] * wj[1],
            wi[2] * wj[2],
        ]))
    quad_mat = torch.stack(rows, dim=1)       # (6 channels, 6 pairs)
    q = cov3d @ quad_mat                      # (N, 6) scalars Wi S Wj
    s00, s01, s02, s11, s12, s22 = q.unbind(dim=1)

    a = a0 * a0 * s00 + 2 * a0 * c0 * s02 + c0 * c0 * s22 + COV2D_DILATION
    b = a0 * b1 * s01 + a0 * c1 * s02 + c0 * b1 * s12 + c0 * c1 * s22
    c = b1 * b1 * s11 + 2 * b1 * c1 * s12 + c1 * c1 * s22 + COV2D_DILATION
    return torch.stack([a, b, c], dim=-1)


def flat_normals(scaling, rotation, xyz, campos) -> torch.Tensor:
    """Shortest-axis normal of each (flattened) Gaussian, flipped to face
    the camera."""
    r00, r01, r02, r10, r11, r12, r20, r21, r22 = rotation_channels(rotation)
    idx = torch.argmin(scaling, dim=-1)
    is0 = idx == 0
    is1 = idx == 1
    nx = torch.where(is0, r00, torch.where(is1, r01, r02))
    ny = torch.where(is0, r10, torch.where(is1, r11, r12))
    nz = torch.where(is0, r20, torch.where(is1, r21, r22))
    n = torch.stack([nx, ny, nz], dim=-1)
    to_cam = campos[None, :] - xyz
    sign = torch.sign((n * to_cam).sum(-1, keepdim=True))
    sign = torch.where(sign == 0, torch.ones_like(sign), sign)
    return n * sign


def project_gaussians(xyz, scaling, rotation, opacity, colors,
                      world_view, full_proj, campos,
                      width: int, height: int, tanfovx: float, tanfovy: float,
                      scaling_modifier: float = 1.0,
                      cov3d_precomp=None, ndc_offset=None) -> ProjectedGaussians:
    """Cull + project + conic/radius + normals.

    world_view/full_proj/campos are tensors on the Gaussians' device.
    Culled Gaussians get radius 0 and opacity 0.  ``cov3d_precomp``: the
    world covariances, (N, 3, 3) or packed (N, 6) upper triangle (xx, xy,
    xz, yy, yz, zz), in place of the ones built from scaling and rotation
    (which still give the normals).  ``ndc_offset``: see ``project_points``.
    """
    focal_x = width / (2.0 * tanfovx)
    focal_y = height / (2.0 * tanfovy)

    if cov3d_precomp is None:
        cov3d = build_covariance_packed(scaling, rotation, scaling_modifier)
    elif cov3d_precomp.dim() == 3:       # (N, 3, 3) full matrices
        cov3d = strip_symmetric(cov3d_precomp)
    else:                                # already packed (N, 6)
        cov3d = cov3d_precomp
    means2d, depths = project_points(xyz, full_proj, width, height,
                                     ndc_offset)
    cov2d = compute_cov2d(xyz, cov3d, world_view, tanfovx, tanfovy,
                          focal_x, focal_y)

    a, b, c = cov2d.unbind(dim=1)
    det = a * c - b * b
    det_ok = det != 0.0
    inv_det = torch.where(det_ok, 1.0 / torch.where(det_ok, det,
                                                    torch.ones_like(det)),
                          torch.zeros_like(det))
    conics = torch.stack([c * inv_det, -b * inv_det, a * inv_det], dim=-1)

    mid = 0.5 * (a + c)
    lam1 = mid + torch.sqrt(torch.clamp(mid * mid - det, min=0.1))
    radius = torch.ceil(3.0 * torch.sqrt(lam1))

    # zero-opacity Gaussians contribute nothing: culling them here keeps
    # them out of the tile pair lists
    op = opacity.reshape(-1)
    visible = (depths > NEAR_CULL) & det_ok & (op > 0.0)
    radii = torch.where(visible, radius, torch.zeros_like(radius)).to(torch.int32)
    op = torch.where(visible, op, torch.zeros_like(op))

    normals = flat_normals(scaling, rotation, xyz, campos)
    return ProjectedGaussians(means2d=means2d, depths=depths, conics=conics,
                              radii=radii, colors=colors, opacities=op,
                              normals=normals)


def sh_colors(features: torch.Tensor, xyz: torch.Tensor, campos: torch.Tensor,
              active_sh_degree: int) -> torch.Tensor:
    """Per-Gaussian view-dependent color from SH coefficients (N, K, 3)
    (direction = campos -> center), clamped at 0 after the +0.5 offset, as
    the CUDA preprocess does."""
    dirs = xyz - campos[None, :]
    dirs = dirs / (torch.linalg.norm(dirs, dim=-1, keepdim=True) + 1e-12)
    rgb = eval_sh(active_sh_degree, features.transpose(-1, -2), dirs) + 0.5
    return torch.clamp(rgb, min=0.0)
