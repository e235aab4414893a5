"""Stage-3 full-train-step benchmark (port of texgs/tools/bench_stage3.py).

Times the production TextureGaussian3D step: uv_tex_render with the no-SH
image from the same pass, the hand-rolled UV Jacobian, SSIM twice, the
inverse consistency loss and the three Adam updates, at the flagship
shape (100k Gaussians, 800x600, m = 32, a 1024^2 cubemap, the fused path:
kernels A, A', B, B', K5', K5''), driven through ``model.compute_loss`` and
``optimize_step`` as training drives it.

The model is built in code, with no checkpoints: textured-sphere
Gaussians and fresh UV nets with configs/prod_texture.yaml's
hyperparameters, the UV net pre-fitted to the analytic sphere map.

Timing: each step runs between ``torch.cuda.synchronize()`` calls and is
timed on the host clock; ``measure`` returns the median and the spread.
(texgs's two-point slope worked around a TPU platform whose
block_until_ready returned early; a synchronize does not.)

    python -m texgs_torch.tools.bench_stage3 [--device cuda|cpu]

Env: BENCH3_N (default 100000), BENCH3_W/H (800x600), BENCH3_TEX (1024),
     BENCH3_ITERS (8).
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from texgs_torch.utils.logger import get_logger

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
PREFIT_STEPS = 300
# iteration 6001 of 10000: every loss gate and all three optimizers on
# (prod_texture.yaml's ranges open at 2500), and no min-scale reset in the
# timed window
FIRST_ITER, END_ITER = 6001, 10000


def build_model(n: int, tex_res: int, width: int, height: int, log=None,
                device="cuda"):
    """(model, camera with its ground truth, config): the stage-3 model of
    configs/prod_texture.yaml over ``n`` textured-sphere Gaussians, its UV
    net pre-fitted to normalize(xyz), and one orbit view."""
    from texgs_torch.config import Cfg, load_config
    from texgs_torch.core.camera import with_ground_truth
    from texgs_torch.core.state import init_from_pcd
    from texgs_torch.data.synthetic import (orbit_cameras,
                                            textured_sphere_point_cloud)
    from texgs_torch.train import optim
    from texgs_torch.train.texture_gaussian3d import TextureGaussian3D

    log = log or get_logger("texgs-bench3")
    cfg = load_config(os.path.join(REPO, "configs", "prod_texture.yaml"))
    mc = cfg.model_cfg
    del mc["init_from"], mc["init_uv_map_from"]
    mc.tex_cfg.resolution = tex_res

    model = TextureGaussian3D(Cfg(mc), device=device)
    pcd = textured_sphere_point_cloud(n, seed=0)
    state = init_from_pcd(pcd.points, pcd.colors,
                          max_sh_degree=int(mc.tex_cfg.max_sh_degree),
                          device=device)
    shs = np.random.default_rng(3).normal(size=tuple(state.features_rest.shape))
    model.gauss = {"xyz": state.xyz, "opacity": state.opacity,
                   "scaling": state.scaling, "rotation": state.rotation,
                   "shs": torch.as_tensor(0.01 * shs, dtype=torch.float32,
                                          device=device)}
    model.spatial_lr_scale = 3.5
    model.setup_optim(cfg.optim_cfg)
    model.bind_train_cfg(cfg.train_cfg, [0, 0, 0])
    model.active_sh_degree = int(mc.tex_cfg.max_sh_degree)

    # Pre-fit the UV net to the analytic sphere map uv = normalize(xyz), so
    # the texture fetches follow a trained map's pattern, not a fresh
    # random MLP's
    xyz = state.xyz
    target = xyz / (torch.linalg.norm(xyz, dim=-1, keepdim=True) + 1e-9)
    leaves = dict(model.uv_net.named_parameters())
    adam = optim.Adam(leaves)
    lrs = {k: 1e-3 for k in leaves}
    for _ in range(PREFIT_STEPS):
        for p in leaves.values():
            p.grad = None
        with torch.enable_grad():
            loss = ((model.uv_net(xyz, model.geo_emb) - target) ** 2
                    ).sum(-1).mean()
            loss.backward()
        adam.step(leaves, lrs)
    for p in leaves.values():
        p.grad = None
    log.info(f"bench uv_net prefit: final map err {loss.item():.4f}")

    cam = orbit_cameras(1, radius=3.5, width=width, height=height)[0]
    image = np.random.default_rng(1).uniform(size=(3, height, width))
    return model, with_ground_truth(cam, image), cfg


def measure(n=None, width=None, height=None, tex_res=None, iters=None,
            log=None, device="cuda"):
    """(median seconds per full stage-3 train step, aux): aux holds
    ``loss0`` (the first step's loss), ``n_pairs`` (its pair count), the
    shape (``n``, ``width``, ``height``, ``tex_res``) and ``spread_ms``,
    the fastest and slowest timed step."""
    n = n or int(os.environ.get("BENCH3_N", 100_000))
    width = width or int(os.environ.get("BENCH3_W", 800))
    height = height or int(os.environ.get("BENCH3_H", 600))
    tex_res = tex_res or int(os.environ.get("BENCH3_TEX", 1024))
    iters = iters or int(os.environ.get("BENCH3_ITERS", 8))
    dev = torch.device(device)

    model, cam, cfg = build_model(n, tex_res, width, height, log=log,
                                  device=dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def step(i):
        loss, stats, extra = model.compute_loss(i, END_ITER, cam, None,
                                                cfg.loss_cfg)
        model.optimize_step(i, END_ITER, cfg.train_cfg, extra)
        return loss, stats

    loss, stats = step(FIRST_ITER)   # the kernels' build and first launches
    step(FIRST_ITER + 1)
    times = []
    for j in range(iters):
        sync()
        t0 = time.perf_counter()
        step(FIRST_ITER + 2 + j)
        sync()
        times.append(time.perf_counter() - t0)
    aux = {"loss0": float(loss), "n_pairs": int(stats["n_pairs"]),
           "n": n, "width": width, "height": height, "tex_res": tex_res,
           "spread_ms": [min(times) * 1e3, max(times) * 1e3]}
    return float(np.median(times)), aux


if __name__ == "__main__":
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    dt, aux = measure(device=parser.parse_args().device)
    print(f"stage-3 full train step: {dt * 1e3:.1f} ms  {aux}")
