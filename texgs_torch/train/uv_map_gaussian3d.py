"""Stage 2, the part stage 3 uses (port of texgs/train/uv_map_gaussian3d.py
``depth2world``).  The stage-2 trainer waits for its own slice."""

from __future__ import annotations

import torch


def depth2world(depth: torch.Tensor, full_proj, zfar: float,
                znear: float) -> torch.Tensor:
    """(H, W) view-z depth -> (H, W, 3) world points:
    clip = [ndc_x d, ndc_y d, zclip(d), d], world = clip @ inv(full_proj)
    (row-vector convention)."""
    h, w = depth.shape
    dev, dt = depth.device, depth.dtype
    ndc_x = (torch.arange(w, dtype=dt, device=dev) * 2 + 1) / w - 1.0
    ndc_y = (torch.arange(h, dtype=dt, device=dev) * 2 + 1) / h - 1.0
    ndc_y, ndc_x = torch.meshgrid(ndc_y, ndc_x, indexing="ij")
    zclip = zfar * depth / (zfar - znear) - zfar * znear / (zfar - znear)
    clip = torch.stack([ndc_x * depth, ndc_y * depth, zclip, depth],
                       dim=-1).reshape(-1, 4)
    fp = torch.as_tensor(full_proj, dtype=dt, device=dev)
    world = clip @ torch.linalg.inv(fp)
    return world[:, :3].reshape(h, w, 3)
