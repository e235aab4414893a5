"""Data-parallel training step (port of texgs/dist/data_parallel.py).

texgs stacks one camera per chip (``stack_cameras``) and shards the batch
over the mesh's ``data`` axis (``index_camera`` inside ``shard_map``).  In
the port every rank holds the batch as a list of cameras and takes camera
``data_rank`` of it (``rank_camera``).  The Gaussians are replicated; the
gradients are averaged over ``data`` before the same Adam update on every
rank, so the replicas stay identical.
"""

from __future__ import annotations

from typing import Sequence

import torch

from texgs_torch import losses
from texgs_torch.core.camera import Camera
from texgs_torch.core.state import GaussianState
from texgs_torch.dist.collectives import (axis_index, flat_grads, pmean_,
                                          set_grads)
from texgs_torch.render.render import render
from texgs_torch.train.optim import Adam


def rank_camera(mesh, camera_batch: Sequence[Camera],
                data_axis: str = "data") -> Camera:
    """The camera of this rank's ``data`` coordinate (texgs's
    ``index_camera(cam_shard, 0)`` under ``P("data")``)."""
    n = mesh.size(mesh.mesh_dim_names.index(data_axis))
    if len(camera_batch) != n:
        raise ValueError(f"{len(camera_batch)} cameras for a '{data_axis}' "
                         f"axis of {n} ranks")
    return camera_batch[axis_index(mesh, data_axis)]


def _train_leaves(state: GaussianState) -> dict:
    params = state.params_dict()
    for p in params.values():
        p.requires_grad_(True)
        p.grad = None
    return params


def dp_train_step(mesh, state: GaussianState, adam: Adam,
                  camera_batch: Sequence[Camera], active_sh_degree: int,
                  lr: float, lambda_dssim: float = 0.2,
                  data_axis: str = "data") -> torch.Tensor:
    """One data-parallel step over ``mesh`` (axis ``data``): each rank
    renders its camera (the tiled path, kernel 1), takes texgs's
    (1 - dssim) L1 + dssim (1 - SSIM) against its ground truth, the
    gradients are averaged over ``data`` and every rank takes the same Adam
    step at ``lr`` on every leaf.  ``state`` and ``adam`` change in place;
    returns the loss averaged over the cameras."""
    cam = rank_camera(mesh, camera_batch, data_axis)
    dev = state.xyz.device
    params = _train_leaves(state)
    gt = torch.as_tensor(cam.image, dtype=torch.float32, device=dev)
    with torch.enable_grad():
        out = render(cam, xyz=state.xyz, opacity=state.get_opacity(),
                     scaling=state.get_scaling(),
                     rotation=state.get_rotation(),
                     features=state.get_features(),
                     active_sh_degree=active_sh_degree,
                     bg_color=torch.zeros(3, device=dev), backend="scan")
        img = out["render"]
        loss = ((1 - lambda_dssim) * losses.l1_loss(img, gt)
                + lambda_dssim * (1 - losses.ssim_loss(img, gt)))
        loss.backward()
    leaves = list(params.values())
    set_grads(leaves, pmean_(flat_grads(leaves), mesh, data_axis))
    adam.step(params, {k: lr for k in params})
    return pmean_(loss.detach().reshape(1), mesh, data_axis)[0]
