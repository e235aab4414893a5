"""Multi-rank dry run of the sharded production steps (port of
``dryrun_multichip``, __graft_entry__.py:71-236).

    python -m texgs_torch.dist.dryrun N [--device cuda|cpu]

spawns N ranks (the spawn start method, one torch thread each, a free
localhost port) and runs every shard mode at texgs's dry-run shapes: 512
Gaussians of ``blob_point_cloud``, 32x32 views whose ground truth is the
dense oracle's render, SH degree 1, a 32^2 texture and m = 8.  Stage 1 and
stage 3 each take one step in tile mode on a (data, tile) mesh, in gauss
mode on the same mesh, and, where N is a multiple of 4, in tile+gauss mode
on a (N/4, 2, 2) mesh (texgs runs that mesh where N is a multiple of 8).
Each step must give a finite loss, move the parameters (the texture in
stage 3), track the densify stats (stage 1) and leave the replicas
identical; a gauss-mode loss must lie within 1e-3 of the tile mode's.

On CUDA the ranks use NCCL where each has a card of its own; ranks that
share a card (NCCL refuses two ranks on one device) use gloo over CUDA
tensors.  The parent builds every kernel first, so the ranks compile
nothing.  texgs's ``_comm_model`` (TPU interconnect constants and step
times) is not ported.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import socket
import sys
from pathlib import Path

import numpy as np
import torch

CONFIG = Path(__file__).resolve().parents[2] / "configs" / "synthetic_texture.yaml"
N_GAUSS, SIZE, TEX = 512, 32, 32
S1_FLAGS = (True, True, False, False, True, False, True)
S1_LAMBDAS = dict(dssim=0.2, alpha=1.0, opacity_reg=0.01, depth=0.0,
                  norm=0.0, norm_smooth=0.5, norm_reg=0.0)
S1_LRS = dict(xyz=1e-3, f_dc=2.5e-3, f_rest=1.25e-4, opacity=5e-2,
              scaling=5e-3, rotation=1e-3)
S3_FLAGS = (True, True, False, False, False, True, True, True, True)
S3_LAMBDAS = dict(dssim=0.2, alpha=1.0, depth=0.0, norm=0.0, norm_reg=0.0,
                  norm_smooth=0.5, opacity_reg=0.01, no_sh=2.0, inverse=0.1)
S3_LRS = dict(xyz=1e-4, opacity=5e-2, scaling=5e-3, rotation=1e-3, shs=1e-3,
              uv_net=2e-5, inv_uv_net=2e-5, tex=2.5e-3)
N_INV_POINTS, M = 64, 8


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def pick_backend(n: int, device) -> str:
    """NCCL where every rank has a card of its own, gloo where ranks share
    one (or on the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and n <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def tile_count(n: int) -> int:
    """texgs's (data, tile) split: as square as possible, at most 4 tiles
    (__graft_entry__.py:113-118)."""
    n_tile = 1
    while (n_tile * 2 <= n // max(1, n // (n_tile * 2))
           and n % (n_tile * 2) == 0 and n_tile * 2 <= 4):
        n_tile *= 2
    return n_tile


def scene(device):
    """texgs's dry-run scene: (Gaussians at SH degree 2, 8 orbit cameras
    with the oracle's renders as their images)."""
    from texgs_torch.core.state import init_from_pcd
    from texgs_torch.data.synthetic import blob_point_cloud, orbit_cameras
    from texgs_torch.render.render import render

    pcd = blob_point_cloud(N_GAUSS, seed=0)
    state = init_from_pcd(pcd.points, pcd.colors, max_sh_degree=2,
                          device=device)
    cams = []
    with torch.no_grad():
        for c in orbit_cameras(8, radius=3.5, width=SIZE, height=SIZE):
            img = render(c, xyz=state.xyz, opacity=state.get_opacity(),
                         scaling=state.get_scaling(),
                         rotation=state.get_rotation(),
                         features=state.get_features(), active_sh_degree=0,
                         bg_color=torch.zeros(3, device=device),
                         backend="reference")["render"]
            cams.append(dataclasses.replace(c, image=img))
    # colours moved off the ground truth: a loss and gradients to follow
    dc = np.random.default_rng(0).normal(size=tuple(state.features_dc.shape))
    state.features_dc = state.features_dc + 0.3 * torch.as_tensor(
        dc, dtype=torch.float32, device=device)
    return state, cams


def stage3_model(state, device):
    """texgs's dry-run stage-3 model: synthetic_texture.yaml's nets with a
    4-level inverse hash grid, SH degree 1, a 32^2 texture."""
    from texgs_torch.config import load_config
    from texgs_torch.train.optim import Adam
    from texgs_torch.train.texture_gaussian3d import TextureGaussian3D

    mc = load_config(CONFIG).model_cfg
    mc.tex_cfg.resolution = TEX
    mc.tex_cfg.max_sh_degree = 1
    mc.inv_uv_net_cfg.pre_mlp_cfg.hash_grid_cfg.n_levels = 4
    model = TextureGaussian3D(mc, device=device)
    rng = np.random.default_rng(3)

    def t(a):
        return torch.as_tensor(a, dtype=torch.float32, device=device)

    model.gauss = {"xyz": state.xyz.detach().clone(),
                   "opacity": state.opacity.detach().clone(),
                   "scaling": state.scaling.detach().clone(),
                   "rotation": state.rotation.detach().clone(),
                   "shs": t(0.01 * rng.normal(size=(N_GAUSS, 3, 3)))}
    model.texture = t(0.1 * rng.normal(size=(6, TEX, TEX, 3))).contiguous()
    model.adam_g = Adam(model._gauss_leaves())
    uv = model._uv_leaves()
    model.adam_uv = Adam(uv, {k for k in uv if ".w." in k})
    model.adam_tex = Adam(model._tex_leaves())
    return model


def _rank_main(rank: int, n: int, port: int, device: str, backend: str):
    torch.set_num_threads(1)
    from texgs_torch.core.state import GaussianState
    from texgs_torch.dist.collectives import replica_divergence
    from texgs_torch.dist.mesh import initialize_dist, make_mesh, transport
    from texgs_torch.dist.sharded import (stage1_sharded_step,
                                          stage3_sharded_step)
    from texgs_torch.train import densify
    from texgs_torch.train.optim import Adam

    dev = initialize_dist(backend, device, f"tcp://localhost:{port}", n, rank)
    state0, cams = scene(dev)
    n_tile = tile_count(n)
    n_data = n // n_tile
    mesh2d = make_mesh(("data", "tile"), (n_data, n_tile), dev)
    say = print if rank == 0 else (lambda *a, **k: None)
    say(f"dryrun_multichip({n}): {transport(mesh2d)}", flush=True)
    meshes = [("tile", mesh2d, (n_data, n_tile)),
              ("gauss", mesh2d, (n_data, n_tile))]
    if n % 4 == 0:
        meshes.append(("tile+gauss",
                       make_mesh(("data", "tile", "gauss"), (n // 4, 2, 2),
                                 dev), (n // 4, 2, 2)))
    bg = torch.zeros(3, device=dev)

    def check_replicas(what, tensors):
        d = replica_divergence(tensors)
        if d != 0.0:
            raise AssertionError(f"{what}: the replicas differ by {d:.3e}")

    losses = {}
    for mode, mesh, shape in meshes:
        state = GaussianState(**{f.name: getattr(state0, f.name).detach().clone()
                                 for f in dataclasses.fields(GaussianState)})
        adam = Adam(state.params_dict())
        stats = densify.init_stats(state.n_alive, dev)
        f_dc0 = state.features_dc.detach().clone()
        loss, _, new_stats = stage1_sharded_step(
            mesh, state, adam, stats, (cams * n)[:shape[0]], S1_LRS,
            {"bg": bg, **S1_LAMBDAS}, True, S1_FLAGS, 1, backend="scan",
            shard_mode=mode)
        loss = float(loss)
        assert np.isfinite(loss), f"stage-1 {mode} step: loss {loss}"
        assert float((state.features_dc.detach() - f_dc0).abs().max()) > 0, (
            f"stage-1 {mode} step: the parameters did not move")
        assert float(new_stats.denom.sum()) > 0, (
            f"stage-1 {mode} step: densify stats not tracked")
        check_replicas(f"stage-1 {mode}", list(state.params_dict().values()))
        losses[("s1", mode)] = loss
        say(f"dryrun_multichip({n}): stage-1 {mode} "
            f"({'x'.join(map(str, shape))}) loss={loss:.4f} OK", flush=True)

        model = stage3_model(state0, dev)
        tex0 = model.texture.detach().clone()
        gen = torch.Generator(device=dev).manual_seed(7)
        loss3, _ = stage3_sharded_step(
            mesh, model, (cams * n)[:shape[0]], S3_LRS,
            {"bg": bg, **S3_LAMBDAS}, (True, True, True), S3_FLAGS, 1,
            N_INV_POINTS, m=M, backend="scan", tex_backend="xla",
            generator=gen, shard_mode=mode)
        loss3 = float(loss3)
        assert np.isfinite(loss3), f"stage-3 {mode} step: loss {loss3}"
        assert float((model.texture.detach() - tex0).abs().max()) > 0, (
            f"stage-3 {mode} step: the texture did not move")
        check_replicas(f"stage-3 {mode}",
                       [*model._gauss_leaves().values(),
                        *model._uv_leaves().values(), model.texture])
        losses[("s3", mode)] = loss3
        say(f"dryrun_multichip({n}): stage-3 {mode} "
            f"({'x'.join(map(str, shape))}) loss={loss3:.4f} OK", flush=True)
    for stage in ("s1", "s3"):
        gap = abs(losses[(stage, "gauss")] - losses[(stage, "tile")])
        assert gap < 1e-3, (f"{stage} gauss-mode loss {gap:.2e} from the "
                            "tile mode's")
    torch.distributed.destroy_process_group()


def dryrun_multichip(n: int, device: str = "cuda") -> None:
    """Spawn ``n`` ranks and run every shard mode once (the module's
    docstring); raises if a rank fails."""
    import torch.multiprocessing as mp

    if torch.device(device).type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("dryrun_multichip: no GPU visible; pass "
                               "device='cpu'")
        from texgs_torch import _build
        _build.build()  # the ranks load these libraries and compile nothing
    backend = pick_backend(n, device)
    print(f"dryrun_multichip({n}): {n} ranks on {device}, backend {backend}",
          flush=True)
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    mp.start_processes(_rank_main, args=(n, free_port(), device, backend),
                       nprocs=n, start_method="spawn")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("n", type=int)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    dryrun_multichip(args.n, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
