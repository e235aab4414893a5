"""Model registry (port of texgs/train/models.py)."""

from __future__ import annotations


def create_model(model_cfg, device="cuda"):
    t = model_cfg.type
    if t == "Gaussian3D":
        from texgs_torch.train.gaussian3d import Gaussian3D
        return Gaussian3D(model_cfg, device=device)
    if t == "UVMapGaussian3D":
        from texgs_torch.train.uv_map_gaussian3d import UVMapGaussian3D
        return UVMapGaussian3D(model_cfg, device=device)
    if t == "TextureGaussian3D":
        from texgs_torch.train.texture_gaussian3d import TextureGaussian3D
        return TextureGaussian3D(model_cfg, device=device)
    raise KeyError(f"unknown model type {t}")
