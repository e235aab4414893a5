"""The state both stage-3 cells start from, made on the device from the seed.

Gaussians on the textured sphere (flat discs: each smallest log-scale is
-20, as stage 1's min-scale reset leaves them), zero residual SH, a
procedural 1024^2 cubemap in SH0 space, UV-net weights pre-fitted to
normalize(xyz) by the plain Adam loop below, the inverse net's weights and
hash tables, and the training views with procedural targets and the
sphere's analytic silhouette, normals and mask.  Every tensor comes from
one ``torch.Generator`` on the device.  Camera matrices follow the 3DGS
row-vector convention (copied from texgs_torch/utils/graphics.py and
texgs_torch/core/camera.py).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.reference import render as R

ZNEAR, ZFAR = 0.01, 100.0
PREFIT_STEPS, PREFIT_LR = 300, 1e-3


# ------------------------------------------------------------ cameras
def look_at(eye, width: int, height: int, fovx: float) -> R.Cam:
    """A camera at ``eye`` looking at the origin, +z up."""
    eye = np.asarray(eye, np.float64)
    fovy = 2 * math.atan(math.tan(fovx / 2) * height / width)
    fwd = -eye / np.linalg.norm(eye)
    right = np.cross(fwd, [0.0, 0.0, 1.0])
    right /= np.linalg.norm(right)
    down = np.cross(fwd, right)
    r_w2c = np.stack([right, down, fwd])
    w2v = np.eye(4)
    w2v[:3, :3] = r_w2c
    w2v[:3, 3] = -r_w2c @ eye
    tx, ty = math.tan(fovx / 2), math.tan(fovy / 2)
    proj = np.zeros((4, 4))
    proj[0, 0], proj[1, 1] = 1.0 / tx, 1.0 / ty
    proj[3, 2] = 1.0
    proj[2, 2] = ZFAR / (ZFAR - ZNEAR)
    proj[2, 3] = -(ZFAR * ZNEAR) / (ZFAR - ZNEAR)
    world_view = w2v.astype(np.float32).T
    full_proj = (world_view @ proj.astype(np.float32).T).astype(np.float32)
    campos = np.linalg.inv(world_view)[3, :3].astype(np.float32)
    return R.Cam(world_view, full_proj, campos, int(width), int(height),
                 float(fovx), float(fovy))


def orbit_eye(az_deg: float, el_deg: float, radius: float):
    az, el = math.radians(az_deg), math.radians(el_deg)
    return [radius * math.cos(az) * math.cos(el),
            radius * math.sin(az) * math.cos(el), radius * math.sin(el)]


def spiral_views(v: dict):
    """The training views: ``n`` eyes over ``turns`` turns at ``radius``,
    the elevation swept from ``el_min`` to ``el_max`` degrees."""
    n = int(v["n"])
    return [look_at(orbit_eye(360.0 * v["turns"] * i / n,
                              v["el_min"] + (v["el_max"] - v["el_min"])
                              * i / max(n - 1, 1), v["radius"]),
                    v["width"], v["height"], math.radians(v["fov_deg"]))
            for i in range(n)]


def extent(cams) -> float:
    """texgs's cameras_extent: 1.1 x the largest distance of a camera
    centre from their mean."""
    c = np.stack([cam.campos for cam in cams]).astype(np.float64)
    return float(1.1 * np.linalg.norm(c - c.mean(0), axis=1).max())


# ---------------------------------------------------------- the state
def pattern(d: torch.Tensor, phase: torch.Tensor, freq: float) -> torch.Tensor:
    """The object's colour at unit directions d (..., 3): the textured
    sphere's bands, phase-shifted by the seed."""
    bands = ((torch.sin(freq * d[..., 0] + phase[0])
              * torch.sin(freq * d[..., 1] + phase[1])
              * torch.sin(freq * d[..., 2] + phase[2])) > 0).float()
    return torch.stack([0.15 + 0.7 * bands,
                        0.5 + 0.3 * torch.sin(2 * d[..., 1] + phase[3]),
                        0.85 - 0.7 * bands], -1)


def _qmul(a, b):
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack([aw * bw - ax * bx - ay * by - az * bz,
                        aw * bx + ax * bw + ay * bz - az * by,
                        aw * by - ax * bz + ay * bw + az * bx,
                        aw * bz + ax * by - ay * bx + az * bw], -1)


def _he(shape, gen, dev):
    return torch.randn(shape, generator=gen, device=dev) * math.sqrt(2.0 / shape[1])


def _mlp_leaves(prefix: str, d_in: int, d_out: int, mc: dict, gen, dev):
    dims = [d_in] + [int(mc["n_neurons"])] * int(mc["n_hidden_layers"]) + [d_out]
    out = {}
    for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
        out[f"{prefix}.w.{i}"] = _he((b, a), gen, dev)
        out[f"{prefix}.b.{i}"] = torch.zeros(b, device=dev)
    return out


def _uv_forward(s: dict, x):
    def mlp(part, h):
        i = 0
        while f"uv_net.{part}.w.{i}" in s:
            h = torch.nn.functional.linear(h, s[f"uv_net.{part}.w.{i}"],
                                           s[f"uv_net.{part}.b.{i}"])
            i += 1
            if f"uv_net.{part}.w.{i}" in s:
                h = torch.relu(h)
        return h
    o = mlp("mlp", torch.relu(mlp("pre_mlp", x) + s["geo_emb"][None]))
    return o / (torch.linalg.norm(o, dim=-1, keepdim=True) + 1e-12)


def prefit_uv_net(s: dict, xyz, steps: int = PREFIT_STEPS):
    """Fits the UV net to the analytic sphere map normalize(xyz): full-batch
    Adam (lr 1e-3) on the mean squared distance, in place."""
    keys = [k for k in s if k.startswith("uv_net.")]
    target = xyz / (torch.linalg.norm(xyz, dim=-1, keepdim=True) + 1e-9)
    mu = {k: torch.zeros_like(s[k]) for k in keys}
    nu = {k: torch.zeros_like(s[k]) for k in keys}
    for t in range(1, steps + 1):
        leaves = [s[k].requires_grad_(True) for k in keys]
        with torch.enable_grad():
            loss = ((_uv_forward(s, xyz) - target) ** 2).sum(-1).mean()
            grads = torch.autograd.grad(loss, leaves)
        with torch.no_grad():
            for k, g in zip(keys, grads):
                s[k].requires_grad_(False)
                mu[k].mul_(0.9).add_(0.1 * g)
                nu[k].mul_(0.999).add_(0.001 * g * g)
                s[k].sub_(PREFIT_LR * (mu[k] / (1 - 0.9 ** t))
                          / (torch.sqrt(nu[k] / (1 - 0.999 ** t)) + 1e-15))
    return float(loss.detach())


def make_state(cfg: dict, seed: int, device) -> tuple[dict, dict]:
    """(state, scene): the model's leaves named as the program's optimisers
    name them, and the scene's phases (for the targets)."""
    a, mc = cfg["assumed"], cfg["model_cfg"]
    gen = torch.Generator(device=device).manual_seed(int(seed))
    dev = torch.device(device)
    n, radius = int(a["n_gaussians"]), float(a["sphere_radius"])

    def rn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    def ru(*shape):
        return torch.rand(shape, generator=gen, device=dev)

    normal = rn(n, 3)
    normal = normal / torch.linalg.norm(normal, dim=-1, keepdim=True)
    xyz = normal * radius
    # discs tangent to the sphere, tilted a little: the local z axis (the
    # smallest scale) maps to a perturbed normal, twisted about it
    tilt = normal + float(a["disc_tilt"]) * rn(n, 3)
    tilt = tilt / torch.linalg.norm(tilt, dim=-1, keepdim=True)
    align = torch.stack([1.0 + tilt[:, 2], -tilt[:, 1], tilt[:, 0],
                         torch.zeros(n, device=dev)], -1)
    align = torch.where((1.0 + tilt[:, 2] < 1e-6)[:, None],
                        torch.tensor([0.0, 1.0, 0.0, 0.0], device=dev), align)
    theta = math.pi * ru(n)
    twist = torch.stack([torch.cos(theta), torch.zeros(n, device=dev),
                         torch.zeros(n, device=dev), torch.sin(theta)], -1)
    rotation = _qmul(align / torch.linalg.norm(align, dim=-1, keepdim=True),
                     twist)
    spacing = math.sqrt(4 * math.pi * radius ** 2 / n)
    log_s = math.log(spacing) + float(a["log_scale_jitter"]) * rn(n, 2)
    scaling = torch.cat([log_s, torch.full((n, 1), float(a["min_log_scale"]),
                                           device=dev)], 1)
    lo, hi = a["opacity_logit_range"]
    opacity = lo + (hi - lo) * ru(n, 1)
    n_rest = (int(mc["tex_cfg"]["max_sh_degree"]) + 1) ** 2 - 1

    res = int(mc["tex_cfg"]["resolution"])
    phase = 2 * math.pi * ru(4)
    freq = float(a["pattern_freq"])
    rgb = pattern(R.sphere_texel_dirs(res, dev), phase, freq)
    rgb = (rgb + float(a["texture_noise"]) * rn(6, res, res, 3)).clamp(0, 1)

    state = {"xyz": xyz, "opacity": opacity, "scaling": scaling,
             "rotation": rotation, "shs": torch.zeros(n, n_rest, 3, device=dev)}
    uc, ic = mc["uv_net_cfg"], mc["inv_uv_net_cfg"]
    emb = int(uc["emb_dim"])
    state.update(_mlp_leaves("uv_net.pre_mlp", 3, emb, uc["pre_mlp_cfg"], gen, dev))
    state.update(_mlp_leaves("uv_net.mlp", emb, 3, uc["mlp_cfg"], gen, dev))
    hg = ic["pre_mlp_cfg"]["hash_grid_cfg"]
    state["inv_uv_net.hashgrid.table"] = ru(
        int(hg["n_levels"]), 2 ** int(hg["max_hashmap"]),
        int(hg["n_features_per_level"])) * 2e-4 - 1e-4
    hg_out = int(hg["n_levels"]) * int(hg["n_features_per_level"])
    state.update(_mlp_leaves("inv_uv_net.pre_mlp", hg_out, int(ic["emb_dim"]),
                             ic["pre_mlp_cfg"], gen, dev))
    state.update(_mlp_leaves("inv_uv_net.mlp", int(ic["emb_dim"]), 3,
                             ic["mlp_cfg"], gen, dev))
    state["geo_emb"] = rn(int(mc["geo_emb_dim"]))
    state["texture"] = (rgb - 0.5) / R.C0
    prefit_uv_net(state, xyz)
    return state, {"phase": phase, "freq": freq, "radius": radius}


def view_targets(cam: R.Cam, scene: dict, device) -> dict:
    """The view's procedural target: the sphere's colour where a pixel's
    ray meets it, its silhouette as the mask, its world normals."""
    dev = torch.device(device)
    rays = torch.as_tensor(R.ray_constants(cam), device=dev)
    py, px = torch.meshgrid(torch.arange(cam.height, device=dev, dtype=torch.float32),
                            torch.arange(cam.width, device=dev, dtype=torch.float32),
                            indexing="ij")
    d = rays[2] + px[..., None] * rays[0] + py[..., None] * rays[1]
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    o = torch.as_tensor(cam.campos, device=dev)
    b = (d * o).sum(-1)
    disc = b * b - (o * o).sum() + scene["radius"] ** 2
    hit = disc > 0
    t = -b - torch.sqrt(torch.clamp(disc, min=0.0))
    p = (o + t[..., None] * d) / scene["radius"]
    mask = hit.float()[None]
    image = (pattern(p, scene["phase"], scene["freq"]).permute(2, 0, 1)
             * mask).clamp(0, 1)
    return {"cam": cam, "image": image.contiguous(), "alpha": mask,
            "normal": (p.permute(2, 0, 1) * mask).contiguous()}
