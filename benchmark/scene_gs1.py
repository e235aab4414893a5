"""The state the stage-1 cell starts from, made on the device from the seed.

The Gaussians of the stage-3 cells' scene (``scene.make_state``: flat
discs tangent to the textured sphere, each smallest log-scale -20, as the
min-scale reset leaves them), drawn from the generator in the same order,
so one seed gives both the same geometry; then SH coefficients of degree 3
in place of the texture and UV nets: ``f_dc`` the scene's colour pattern at
each Gaussian's direction, ``f_rest`` N(0, ``f_rest_std``^2).  The views
and their targets are ``scene.py``'s.
"""

from __future__ import annotations

import math

import torch

from benchmark import scene
from benchmark.reference import render as R

LEAVES = ("xyz", "f_dc", "f_rest", "opacity", "scaling", "rotation")


def make_state(cfg: dict, seed: int, device) -> tuple[dict, dict]:
    """(state, scene): the six leaves named as the program's Adam names
    them, and the scene's phases (for the targets)."""
    a = cfg["assumed"]
    gen = torch.Generator(device=device).manual_seed(int(seed))
    dev = torch.device(device)
    n, radius = int(a["n_gaussians"]), float(a["sphere_radius"])

    def rn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    def ru(*shape):
        return torch.rand(shape, generator=gen, device=dev)

    normal = rn(n, 3)
    normal = normal / torch.linalg.norm(normal, dim=-1, keepdim=True)
    tilt = normal + float(a["disc_tilt"]) * rn(n, 3)
    tilt = tilt / torch.linalg.norm(tilt, dim=-1, keepdim=True)
    align = torch.stack([1.0 + tilt[:, 2], -tilt[:, 1], tilt[:, 0],
                         torch.zeros(n, device=dev)], -1)
    align = torch.where((1.0 + tilt[:, 2] < 1e-6)[:, None],
                        torch.tensor([0.0, 1.0, 0.0, 0.0], device=dev), align)
    theta = math.pi * ru(n)
    twist = torch.stack([torch.cos(theta), torch.zeros(n, device=dev),
                         torch.zeros(n, device=dev), torch.sin(theta)], -1)
    rotation = scene._qmul(
        align / torch.linalg.norm(align, dim=-1, keepdim=True), twist)
    spacing = math.sqrt(4 * math.pi * radius ** 2 / n)
    log_s = math.log(spacing) + float(a["log_scale_jitter"]) * rn(n, 2)
    scaling = torch.cat([log_s, torch.full((n, 1), float(a["min_log_scale"]),
                                           device=dev)], 1)
    lo, hi = a["opacity_logit_range"]
    opacity = lo + (hi - lo) * ru(n, 1)
    phase = 2 * math.pi * ru(4)
    freq = float(a["pattern_freq"])

    n_rest = (int(cfg["model_cfg"]["sh_degree"]) + 1) ** 2 - 1
    f_dc = ((scene.pattern(normal, phase, freq) - 0.5) / R.C0)[:, None, :]
    f_rest = float(a["f_rest_std"]) * rn(n, n_rest, 3)
    state = {"xyz": normal * radius, "f_dc": f_dc, "f_rest": f_rest,
             "opacity": opacity, "scaling": scaling, "rotation": rotation}
    return state, {"phase": phase, "freq": freq, "radius": radius}
