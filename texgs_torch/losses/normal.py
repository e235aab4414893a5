"""Normal losses (port of texgs/losses/normal.py): the cosine normal loss
and the consistency of rendered normals with normals derived from the
rendered depth."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _shift_replicate(x: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """Shift a (C, H, W) image by (dy, dx) with replicate padding."""
    xp = F.pad(x[None], (1, 1, 1, 1), mode="replicate")[0]
    h, w = x.shape[1], x.shape[2]
    return xp[:, 1 + dy:1 + dy + h, 1 + dx:1 + dx + w]


def norm_from_depth(depth: torch.Tensor, tanfovx: float, tanfovy: float,
                    world_view, threshold: float = 1e-2):
    """Pseudo ground-truth normals from a (1, H, W) view-z depth map.
    world_view: the (4, 4) row-vector world->view matrix.  Returns
    (normal (3, H, W) world-space unit, mask (1, H, W) float)."""
    _, h, w = depth.shape
    pix_x = torch.arange(w, dtype=depth.dtype, device=depth.device).reshape(1, 1, w)
    pix_y = torch.arange(h, dtype=depth.dtype, device=depth.device).reshape(1, h, 1)
    ndc_x = (2.0 * pix_x + 1.0) / w - 1.0
    ndc_y = (2.0 * pix_y + 1.0) / h - 1.0
    coord_c = torch.cat([ndc_x * tanfovx * depth, ndc_y * tanfovy * depth,
                         depth, torch.ones_like(depth)], dim=0)
    wv = torch.as_tensor(world_view, dtype=depth.dtype, device=depth.device)
    inv_view = torch.linalg.inv(wv.T)
    xyz = (inv_view @ coord_c.reshape(4, h * w)).reshape(4, h, w)[:3]

    grad_l = xyz - _shift_replicate(xyz, 0, -1)
    grad_r = _shift_replicate(xyz, 0, 1) - xyz
    grad_u = xyz - _shift_replicate(xyz, -1, 0)
    grad_d = _shift_replicate(xyz, 1, 0) - xyz
    grad_x = (grad_r + grad_l) / 2
    grad_y = (grad_d + grad_u) / 2

    def small(g):
        return torch.linalg.norm(g, dim=0, keepdim=True) < threshold

    mask = small(grad_l) & small(grad_r) & small(grad_u) & small(grad_d)
    normal = torch.linalg.cross(grad_y, grad_x, dim=0)
    normal = normal / torch.clamp(torch.linalg.norm(normal, dim=0, keepdim=True),
                                  min=1e-6)
    return normal, mask.to(depth.dtype)


def norm_loss(pred: torch.Tensor, gt: torch.Tensor, mask=None):
    """pred/gt: (3, H, W) unit normals; mask: (1, H, W) or None."""
    cos = (pred * gt).sum(dim=0, keepdim=True)
    if mask is None:
        return (1.0 - cos).mean()
    return ((1.0 - cos) * mask).sum() / (mask.sum() + 1e-6)


def norm_reg_loss(norm, depth, tanfovx: float, tanfovy: float, world_view,
                  gt_alpha):
    """Rendered normals against normals derived from the detached depth."""
    norm2, mask = norm_from_depth(depth.detach(), tanfovx, tanfovy, world_view)
    return norm_loss(norm, norm2, gt_alpha * mask)
