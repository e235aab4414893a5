"""UV-texture render path (stage 3): Taylor-expanded UV + cubemap texture.

Port of texgs/render/uv_tex_render.py on texgs_torch.kernels.uvtex_raster,
returning the same keys.  ``tex_miss`` and ``tex_miss_total`` are None, as
on texgs's exact ('xla') texture backend: the port's texture kernel
fetches every tap and cannot miss.
"""

from __future__ import annotations

from typing import Optional

import torch

from texgs_torch.core.camera import Camera
from texgs_torch.kernels import project as proj_k
from texgs_torch.kernels.uvtex_raster import rasterize_uvtex
from texgs_torch.utils.spans import span


def uv_tex_render(viewpoint_camera: Camera, *,
                  xyz: torch.Tensor,
                  opacity: torch.Tensor,
                  scaling: torch.Tensor,
                  rotation: torch.Tensor,
                  uvs: torch.Tensor,
                  grad_uvs: torch.Tensor,
                  texture: torch.Tensor,
                  shs: Optional[torch.Tensor] = None,
                  active_sh_degree: int = 0,
                  bg_color: torch.Tensor,
                  m: int = 32,
                  filter_mode: str = "bilinear",
                  with_no_sh: bool = False,
                  m_tail: bool = False,
                  backend: str = "auto",
                  tex_backend: str = "auto",
                  normalize_depth: bool = True,
                  row_offset: Optional[int] = None,
                  band_height: Optional[int] = None) -> dict:
    """Render one view with per-intersection UV-mapped cubemap appearance.

    uvs: (N, 3) unit-sphere UV centers; grad_uvs: (N, 9) flattened
    duv/dxyz Jacobians (constants); texture: (6, R, R, 3) cubemap in SH0
    space; shs: (N, K-1, 3) view-dependent residual SH (degrees >= 1).
    with_no_sh: also return ``render_no_sh``, the texture-only image,
    from the same blend pass.  backend, tex_backend: texgs's names, which
    pick the fused or the two-kernel path (uvtex_raster.resolve_backends).
    normalize_depth, row_offset, band_height: as ``rasterize_uvtex``
    takes them (a depth slice's unnormalised depth; a band of rows).
    """
    cam = viewpoint_camera
    with span("render.project"):
        # colors come from the texture (rasterize_uvtex); the camera's host
        # arrays go to kernel P by value
        proj = proj_k.project_gaussians(
            xyz, scaling, rotation, opacity, None, cam.world_view,
            cam.full_proj, cam.camera_center, cam.width, cam.height,
            cam.tanfovx, cam.tanfovy)

    out = rasterize_uvtex(
        proj, scaling, rotation, xyz, uvs, grad_uvs, texture, shs,
        active_sh_degree, cam, bg_color, m=m, filter_mode=filter_mode,
        with_no_sh=with_no_sh, m_tail=m_tail, backend=backend,
        tex_backend=tex_backend, normalize_depth=normalize_depth,
        row_offset=row_offset, band_height=band_height)

    return {
        "render": out.image,
        "render_no_sh": out.image_no_sh,
        "depth": out.depth,
        "norm": out.norm,
        "alpha": out.alpha,
        "extra": out.extra,
        "radii": proj.radii,
        "visibility_filter": proj.radii > 0,
        "n_pairs": out.n_pairs,
        "pair_overflow": out.overflowed,
        "tex_miss": None,
        "tex_miss_total": None,
    }
