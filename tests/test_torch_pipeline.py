"""The three stages through the port's driver on the CPU: stage 1 on
``synthetic://blob?n=512&views=6&size=48``, extract_pcd, stage 2 from the
stage-1 checkpoint and cloud, stage 3 from both checkpoints.  A few dozen
iterations each, from the repo's synthetic configs cut to size.  Checks:
the metrics are finite, stage 1's test PSNR beats the untrained model's,
and every checkpoint the port writes loads in texgs.
"""

import logging

import numpy as np
import pytest
import torch

from texgs_torch.config import load_config
from texgs_torch.train import driver

ROOT = "synthetic://blob?n=512&views=6&size=48"
ITERS = 40
# the tier-1 run shares the machine's cores among several workers
THREADS = 2


def cut(path, work_dir, **model_cfg):
    cfg = load_config(path)
    cfg.dataset_cfg.data_root_dir = ROOT
    cfg.train_cfg.num_iterations = ITERS
    cfg.train_cfg.visual_iters = [ITERS]
    cfg.train_cfg.ckpt_iters = [ITERS]
    for k, v in model_cfg.items():
        cfg.model_cfg[k] = v
    cfg.work_dir = str(work_dir)
    return cfg


def run_pipeline(tmp_path_factory):
    from texgs_torch.data.scene import create_dataset
    from texgs_torch.tools.extract_pcd import extract_pcd
    from texgs_torch.train.models import create_model

    log = logging.getLogger("texgs-torch-pipeline")
    base = tmp_path_factory.mktemp("pipe")
    s1 = cut("configs/synthetic_smoke.yaml", base / "s1")
    s1.train_cfg.update(densification_interval=20, densify_from_iter=10,
                        densify_until_iter=30)
    s1.optim_cfg.position_lr_max_steps = ITERS
    s1.loss_cfg.update(norm_range=[20, None], norm_smooth_range=[20, None],
                       opacity_reg_range=[20, None])
    scene = create_dataset(s1.dataset_cfg, log, s1.work_dir, device="cpu")
    untrained = create_model(s1.model_cfg, "cpu")
    untrained.bind_train_cfg(s1.train_cfg, [0, 0, 0])
    untrained.initialize(scene.scene_info.point_cloud, scene.cameras_extent)
    before = driver.visualize(None, 0, ITERS, untrained, scene, log)
    n_init = untrained.n_points
    m1, _, ev1 = driver.train(s1, log, scene=scene, progress=False,
                              device="cpu")
    ck1 = f"{s1.work_dir}/checkpoints/{ITERS}"
    pcd = extract_pcd(ck1, str(base / "pcd"), 256, device="cpu")

    s2 = cut("configs/synthetic_uv_map.yaml", base / "s2", init_from=ck1,
             pcd_load_from=str(base / "pcd.npy"))
    m2, _, ev2 = driver.train(s2, log, progress=False, device="cpu")
    ck2 = f"{s2.work_dir}/checkpoints/{ITERS}"

    s3 = cut("configs/synthetic_texture.yaml", base / "s3", init_from=ck1,
             init_uv_map_from=ck2)
    s3.model_cfg.tex_cfg.resolution = 32
    m3, _, ev3 = driver.train(s3, log, progress=False, device="cpu")
    ck3 = f"{s3.work_dir}/checkpoints/{ITERS}"
    return dict(before=before, evals=(ev1, ev2, ev3), ckpts=(ck1, ck2, ck3),
                cfgs=(s1, s2, s3), models=(m1, m2, m3), pcd=pcd,
                n_init=n_init)


@pytest.fixture(scope="module")
def pipeline(tmp_path_factory):
    threads = torch.get_num_threads()
    torch.set_num_threads(THREADS)
    try:
        return run_pipeline(tmp_path_factory)
    finally:
        torch.set_num_threads(threads)


def test_metrics_finite_and_stage1_learns(pipeline):
    for ev in pipeline["evals"]:
        for split in ev.values():
            assert all(np.isfinite(v) for v in split.values()), ev
    assert pipeline["evals"][0]["test"]["psnr"] > \
        pipeline["before"]["test"]["psnr"] + 1.0
    # densification at iteration 20 changed the Gaussian count
    assert pipeline["models"][0].n_points != pipeline["n_init"]


def test_extracted_cloud(pipeline):
    pcd = pipeline["pcd"]
    assert pcd.shape == (256, 3) and np.isfinite(pcd).all()
    xyz = pipeline["models"][0].state.xyz.detach().numpy()
    # farthest-point samples are points of the stage-1 cloud
    d = ((pcd[:, None] - xyz[None]) ** 2).sum(-1).min(1)
    assert d.max() < 1e-12


def test_every_checkpoint_loads_in_texgs(pipeline):
    from texgs.config import Cfg as JCfg
    from texgs.io import checkpoint as jckpt
    from texgs.train.models import create_model as jax_create_model

    log = logging.getLogger("texgs-test")
    for cfg, path, model in zip(pipeline["cfgs"], pipeline["ckpts"],
                                pipeline["models"]):
        sd, it = jckpt.load(path)
        assert it == ITERS
        jmodel = jax_create_model(JCfg(cfg.model_cfg.to_dict()), log, "/x")
        jmodel.load_state_dict(sd, JCfg(cfg.optim_cfg.to_dict()))
        back = jmodel.state_dict()
        mine = model.state_dict()
        part = "params" if "params" in mine else "net_state"
        for k, v in (mine[part].items() if part == "params" else
                     [("geo_emb", mine[part]["geo_emb"])]):
            np.testing.assert_array_equal(np.asarray(back[part][k]),
                                          np.asarray(v), err_msg=k)


def test_stage3_writes_its_point_cloud(pipeline):
    """texgs's driver writes ``pcds/{iter}.ply`` at each visual iteration
    of every stage; the port's stage 3 writes the alive centres there, the
    checkpoint's of the same iteration."""
    from texgs_torch.io import checkpoint
    from texgs_torch.io.ply import read_pcd

    cfg = pipeline["cfgs"][2]
    pcd = read_pcd(f"{cfg.work_dir}/pcds/{ITERS}.ply")
    params = checkpoint.load(pipeline["ckpts"][2])[0]["params"]
    n = int(params["n_alive"])
    assert n == pipeline["models"][2].n_points
    assert pcd.points.shape == (n, 3)
    np.testing.assert_array_equal(pcd.points, params["xyz"][:n])
