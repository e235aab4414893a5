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
                  tex_backend: str = "auto") -> dict:
    """Render one view with per-intersection UV-mapped cubemap appearance.

    uvs: (N, 3) unit-sphere UV centers; grad_uvs: (N, 9) flattened
    duv/dxyz Jacobians (constants); texture: (6, R, R, 3) cubemap in SH0
    space; shs: (N, K-1, 3) view-dependent residual SH (degrees >= 1).
    with_no_sh: also return ``render_no_sh``, the texture-only image,
    from the same blend pass.  backend, tex_backend: texgs's names, which
    pick the fused or the two-kernel path (uvtex_raster.resolve_backends).
    """
    cam = viewpoint_camera
    dev = xyz.device

    def on_device(a):
        return torch.as_tensor(a, dtype=torch.float32, device=dev)

    proj = proj_k.project_gaussians(
        xyz, scaling, rotation, opacity,
        torch.zeros_like(xyz),  # colors come from the texture per intersection
        on_device(cam.world_view), on_device(cam.full_proj),
        on_device(cam.camera_center), cam.width, cam.height,
        cam.tanfovx, cam.tanfovy)

    out = rasterize_uvtex(
        proj, scaling, rotation, xyz, uvs, grad_uvs, texture, shs,
        active_sh_degree, cam, bg_color, m=m, filter_mode=filter_mode,
        with_no_sh=with_no_sh, m_tail=m_tail, backend=backend,
        tex_backend=tex_backend)

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
