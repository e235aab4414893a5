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


def load_model(cfg, ckpt_path: str, device="cuda"):
    """The model of ``cfg.model_cfg`` from a checkpoint in texgs's schema,
    bound to ``cfg.train_cfg`` and the dataset's background, as texgs's
    tools load one.  Returns (model, the checkpoint's iteration)."""
    from texgs_torch.io import checkpoint as ckpt

    model = create_model(cfg.model_cfg, device)
    model.bind_train_cfg(cfg.train_cfg,
                         cfg.dataset_cfg.get_or("background", [0, 0, 0]))
    sd, iteration = ckpt.load(ckpt_path)
    model.load_state_dict(sd)
    return model, iteration
