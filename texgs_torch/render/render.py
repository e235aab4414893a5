"""3DGS render path: SH-coloured Gaussian splatting (stages 1-2).

Port of texgs/render/render.py:22: SH colours -> projection and cull ->
raster.  Returns the same keys.  The screen-space positional gradient is
harvested by differentiating against ``ndc_offset`` (a zeros (N, 2)
tensor with ``requires_grad``), in texgs's NDC units.  texgs's band
rendering (``row_offset``), ``extra_attrs`` and ``pair_cap`` have no
caller on the ported paths and are not ported: the tiled path keeps every
pair (``pair_overflow`` is False).
"""

from __future__ import annotations

from typing import Optional

import torch

from texgs_torch.core.camera import Camera
from texgs_torch.kernels import project as proj_k
from texgs_torch.kernels.reference import rasterize_reference
from texgs_torch.kernels.tile_raster import rasterize_tiled

BACKENDS = ("auto", "reference", "scan", "pallas")


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
           cov3d_precomp: Optional[torch.Tensor] = None,
           backend: str = "auto",
           normalize_depth: bool = True) -> dict:
    """Render one view.

    All Gaussian inputs are activated values (exp-scaling, normalised
    rotation, sigmoid opacity).  ``features`` are SH coefficients
    (N, K, 3); ``override_color`` (N, 3) bypasses SH.  ``cov3d_precomp``
    (N, 3, 3) or packed (N, 6) replaces the covariances built from
    scaling and rotation.

    backend: ``auto``, ``scan`` and ``pallas`` take the tiled path (kernel
    1 on the card); ``reference`` the dense oracle
    (``kernels.reference.rasterize_reference``), on any device.  texgs's
    ``auto`` takes its oracle on the CPU for N <= 4096; the port's takes
    the tiled path on every device, so its CPU runs check what the card
    runs."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; one of {BACKENDS}")
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
        cam.tanfovy, scaling_modifier=scaling_modifier,
        cov3d_precomp=cov3d_precomp, ndc_offset=ndc_offset)
    bg = torch.as_tensor(bg_color, dtype=torch.float32, device=dev)
    if backend == "reference":
        out = rasterize_reference(proj, cam.height, cam.width, bg,
                                  normalize_depth=normalize_depth)
    else:
        out = rasterize_tiled(proj, cam.height, cam.width, bg,
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
