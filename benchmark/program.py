"""The system under test, built from the benchmark's state: the program's
``TextureGaussian3D`` and its cameras.  The only module of the harness
that imports the program (``texgs_torch``), and only inside functions."""

from __future__ import annotations

import copy

import torch

GAUSS_KEYS = ("xyz", "opacity", "scaling", "rotation", "shs")


def model_cfg(cfg: dict):
    from texgs_torch.config import Cfg
    mc = copy.deepcopy(cfg["model_cfg"])
    for k in ("init_from", "init_uv_map_from"):
        mc.pop(k, None)
    return Cfg(mc)


def build_model(cfg: dict, state: dict, hyper: dict, device, train: bool):
    """The program's stage-3 model holding copies of ``state``; with
    ``train``, its three Adams at the counts of ``hyper`` (zero moments)."""
    from texgs_torch.config import Cfg
    from texgs_torch.train.texture_gaussian3d import TextureGaussian3D

    model = TextureGaussian3D(model_cfg(cfg), device=device)
    with torch.no_grad():
        model.gauss = {k: state[k].clone() for k in GAUSS_KEYS}
        model.texture = state["texture"].clone()
        for k, p in model._uv_leaves().items():
            p.copy_(state[k])
    model.active_sh_degree = int(hyper["active_sh_degree"])
    model.spatial_lr_scale = float(hyper["spatial_lr_scale"])
    model._uv_step_count = int(hyper["uv_step_count"])
    model.bind_train_cfg(Cfg(cfg["train_cfg"]), cfg["model_cfg"]["background"])
    if train:
        model.setup_optim(Cfg(cfg["optim_cfg"]))
        counts = hyper["adam_counts"]
        for adam, key in ((model.adam_g, "gauss"), (model.adam_uv, "uv"),
                          (model.adam_tex, "tex")):
            for k in adam.count:
                adam.count[k] = int(counts[key])
    return model


def leaves(model) -> dict:
    """Every trainable leaf by its optimiser name."""
    return {**model._gauss_leaves(), **model._uv_leaves(),
            **model._tex_leaves()}


def moments(model) -> dict:
    return {**model.adam_g.mu, **model.adam_uv.mu, **model.adam_tex.mu}


def camera(cam, view: dict | None = None):
    """The program's camera for the benchmark's ``cam``, with the view's
    ground truth when one is given."""
    from texgs_torch.core.camera import Camera, with_ground_truth
    c = Camera(world_view=cam.world_view, full_proj=cam.full_proj,
               camera_center=cam.campos, width=cam.width, height=cam.height,
               fovx=cam.fovx, fovy=cam.fovy)
    if view is None:
        return c
    return with_ground_truth(c, view["image"], view["alpha"],
                             normal=view["normal"])


def kernel_functions():
    """The functions whose device work a roofline share reads, by the name
    the share uses: {name: (module, attribute)}."""
    from texgs_torch.kernels import tex_term, uvtex_fused
    return {"uvtex_fused": (uvtex_fused, "fused_pairs_forward"),
            "uvtex_fused_bwd": (uvtex_fused, "fused_pairs_backward"),
            "tex_term": (tex_term, "tex_term_forward"),
            "tex_term_bwd": (tex_term, "tex_term_backward")}
