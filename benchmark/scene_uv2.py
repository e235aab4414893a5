"""What the stage-2 cell starts from, made on the device from the seed: the
frozen stage-1 Gaussians and their farthest-point cloud.

The Gaussians are the stage-3 cells' flat discs on the textured sphere,
drawn as ``scene_gs1.make_state`` draws them (the order of
``scene.make_state``, so one seed gives all the cells the same geometry);
stage 2 keeps their geometry alone.  The cloud is ``pcd_points`` of their
centres by farthest-point sampling from the first, as extract_pcd.py
makes it between stages 1 and 2.  The views are ``scene.py``'s.  The
nets start from the program's seeded constructor; ``prefit_inverse_net``
fits the inverse net to the UV net's map as ``scene.prefit_uv_net`` fits
the UV net to the sphere's.
"""

from __future__ import annotations

import torch

from benchmark import scene, scene_gs1
from benchmark.reference import stage2 as ref2

GEOMETRY = ("xyz", "opacity", "scaling", "rotation")


def make_gaussians(cfg: dict, seed: int, device) -> dict:
    """The frozen Gaussians' raw leaves (``GEOMETRY``)."""
    a = {**cfg["assumed"], "f_rest_std": 0.0}
    state, _ = scene_gs1.make_state({"assumed": a,
                                     "model_cfg": {"sh_degree": 0}},
                                    seed, device)
    return {k: state[k] for k in GEOMETRY}


@torch.no_grad()
def farthest_points(points, k: int):
    """The ``k`` farthest-point samples of ``points`` (N, 3), starting at
    row 0: each next one is the point farthest from those taken, the first
    of several at the same distance."""
    idx = torch.empty(k, dtype=torch.int64, device=points.device)
    min_d2 = torch.full((points.shape[0],), float("inf"),
                        device=points.device)
    last = torch.zeros((), dtype=torch.int64, device=points.device)
    for i in range(k):
        idx[i] = last
        min_d2 = torch.minimum(min_d2,
                               ((points - points[last]) ** 2).sum(-1))
        last = torch.argmax(min_d2)
    return points[idx]


def prefit_inverse_net(s: dict, xyz, steps: int = scene.PREFIT_STEPS):
    """Fits the inverse net and its table to map the UV net's uvs of
    ``xyz`` back to ``xyz``: full-batch Adam (lr 1e-3) on the mean squared
    distance, in place, through the reference's nets."""
    keys = [k for k in s if k.startswith("inv_uv_net.")]
    with torch.no_grad():
        uv = ref2.uv_net(s, xyz)
    mu = {k: torch.zeros_like(s[k]) for k in keys}
    nu = {k: torch.zeros_like(s[k]) for k in keys}
    for t in range(1, steps + 1):
        leaves = [s[k].requires_grad_(True) for k in keys]
        with torch.enable_grad():
            loss = ((ref2.inv_uv_net(s, uv) - xyz) ** 2).sum(-1).mean()
            grads = torch.autograd.grad(loss, leaves)
        with torch.no_grad():
            for k, g in zip(keys, grads):
                s[k].requires_grad_(False)
                mu[k].mul_(0.9).add_(0.1 * g)
                nu[k].mul_(0.999).add_(0.001 * g * g)
                s[k].sub_(scene.PREFIT_LR * (mu[k] / (1 - 0.9 ** t))
                          / (torch.sqrt(nu[k] / (1 - 0.999 ** t)) + 1e-15))
    return float(loss.detach())


def build(cfg: dict, seed: int, device):
    """(gaussians, cloud, cameras)."""
    a = cfg["assumed"]
    gauss = make_gaussians(cfg, seed, device)
    n = min(int(a["pcd_points"]), gauss["xyz"].shape[0])
    return (gauss, farthest_points(gauss["xyz"], n),
            scene.spiral_views(a["views"]))
