"""3DGS render path: SH-coloured Gaussian splatting (stages 1-2).

Port of texgs/render/render.py:22: SH colours -> projection and cull ->
tiled raster through kernel 1 (kernels/raster.py).  Returns the same keys.
The screen-space positional gradient is harvested by differentiating
against ``ndc_offset`` (a zeros (N, 2) tensor with ``requires_grad``), in
texgs's NDC units.  texgs's ``backend`` switch, its dense oracle, its
band rendering (``row_offset``), ``cov3d_precomp``, ``extra_attrs`` and
``pair_cap`` have no caller on the stage-1/2 paths and are not ported: the
port has one path, which keeps every pair (``pair_overflow`` is False).
"""

from __future__ import annotations

from typing import Optional

import torch

from texgs_torch.core.camera import Camera
from texgs_torch.kernels import project as proj_k
from texgs_torch.kernels.tile_raster import rasterize_tiled


def render(viewpoint_camera: Camera, *,
           xyz: torch.Tensor,
           opacity: torch.Tensor,
           scaling: torch.Tensor,
           rotation: torch.Tensor,
           features: Optional[torch.Tensor] = None,
           active_sh_degree: int = 0,
           bg_color: torch.Tensor,
           scaling_modifier: float = 1.0,
           override_color: Optional[torch.Tensor] = None,
           ndc_offset: Optional[torch.Tensor] = None,
           normalize_depth: bool = True) -> dict:
    """Render one view.

    All Gaussian inputs are activated values (exp-scaling, normalised
    rotation, sigmoid opacity).  ``features`` are SH coefficients
    (N, K, 3); ``override_color`` (N, 3) bypasses SH."""
    cam = viewpoint_camera
    dev = xyz.device

    def on_device(a):
        return torch.as_tensor(a, dtype=torch.float32, device=dev)

    campos = on_device(cam.camera_center)
    if override_color is None:
        colors = proj_k.sh_colors(features, xyz, campos, active_sh_degree)
    else:
        colors = override_color
    proj = proj_k.project_gaussians(
        xyz, scaling, rotation, opacity, colors, on_device(cam.world_view),
        on_device(cam.full_proj), campos, cam.width, cam.height, cam.tanfovx,
        cam.tanfovy, scaling_modifier=scaling_modifier, ndc_offset=ndc_offset)
    out = rasterize_tiled(proj, cam.height, cam.width,
                          torch.as_tensor(bg_color, dtype=torch.float32,
                                          device=dev),
                          normalize_depth=normalize_depth)
    return {
        "render": out.image,
        "depth": out.depth,
        "norm": out.norm,
        "alpha": out.alpha,
        "extra": out.extra,
        "radii": proj.radii,
        "visibility_filter": proj.radii > 0,
        "n_pairs": out.n_pairs,
        "pair_overflow": out.overflowed,
    }
