"""The stage-2 system under test, built from the benchmark's frozen
Gaussians and cloud: the program's ``UVMapGaussian3D`` and its cameras.
Beside ``program.py`` and ``program_gs1.py``, the only module of the
harness that imports the program (``texgs_torch``), and only inside
functions."""

from __future__ import annotations

import copy
import dataclasses

import torch


def build_model(cfg: dict, gauss: dict, pcd, seed: int, hyper: dict, device):
    """The program's stage-2 model through its own constructor (its nets,
    table and embedding seeded from ``seed``), ``bind_train_cfg`` and
    ``setup_optim``; copies of the frozen Gaussians and the cloud in
    ``gauss`` and ``pcd``; its Adam at ``hyper``'s count on every leaf
    (zero moments) and its schedule at ``hyper``'s step count."""
    from texgs_torch.config import Cfg
    from texgs_torch.train.uv_map_gaussian3d import UVMapGaussian3D

    mc = {**copy.deepcopy(cfg["model_cfg"]), "seed": int(seed)}
    model = UVMapGaussian3D(Cfg(mc), device=device)
    model.bind_train_cfg(Cfg(cfg["train_cfg"]),
                         cfg["dataset_cfg"]["background"])
    model.gauss = {k: v.clone() for k, v in gauss.items()}
    model.pcd = pcd.clone()
    model.setup_optim(Cfg(cfg["optim_cfg"]))
    for k in model.adam.count:
        model.adam.count[k] = int(hyper["adam_count"])
    model._step_count = int(hyper["step_count"])
    return model


def leaves(model) -> dict:
    """Every trainable leaf by its Adam name."""
    return model._leaves()


@torch.no_grad()
def load_leaves(model, state: dict) -> None:
    for k, p in leaves(model).items():
        p.copy_(state[k])


def moments(model) -> dict:
    return model.adam.mu


def camera(cam, index: int):
    """The program's camera for the benchmark's ``cam``, named by its
    index: the model caches a view's frozen render by (uid, image_name)."""
    from benchmark import program
    return dataclasses.replace(program.camera(cam), uid=int(index),
                               image_name=f"spiral_{index:03d}")


def kernel_functions():
    """The functions whose device work a roofline share reads, by the name
    the share uses: {name: (module, attribute)}."""
    from texgs_torch.nets import hash_encode
    return {"hash_encode": (hash_encode, "hash_encode_forward"),
            "hash_encode_bwd": (hash_encode, "hash_encode_backward")}
