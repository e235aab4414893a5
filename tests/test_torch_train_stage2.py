"""Stage 2 (UV map): texgs's UVMapGaussian3D against the port's, and the
chamfer / farthest-point-sampling helpers against texgs's.

Both models load the same numpy state (texgs's ``state_dict()``) and the
same stage-1 checkpoint and cloud.  UV nets of emb 16 and an inverse net
with a 2-level hash grid; every stage-2 loss is on, and
``max_inverse_points`` is below the pixel count, so the inverse loss picks
its pixels by top-k.  At ``max_inverse_points`` 0 the port's loss takes
the masked pixels' world points, compacted once per view and cached,
where texgs carries every pixel weighted by its mask: one step of each
from the same state and draws agrees at the same tolerances.  The port's step takes texgs's draws (the pixel
scores, the sphere and cap samples that texgs's ``_train_step`` derives
from its key) and texgs's cached depth and alpha, so the comparison
isolates the step.  Tolerances, as the stage-3 test holds them: each
step's loss at rtol 1e-4; the first step's gradients (mu = 0.1 g) at atol
2e-3 of the leaf's max |grad|; the parameters after the steps: 99.9% of
each leaf within 1e-5, none beyond 3 lr.  The frozen depth/alpha renders
(texgs: its dense oracle on the CPU; the port: kernel 1's tiled raster)
at tests/test_rasterizer.py's tiled-vs-oracle tolerances.
"""

import dataclasses
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_rasterizer import assert_close_mostly
from tests.test_torch_uvtex_fused import torch_camera
from texgs.config import Cfg as JCfg
from texgs.core.camera import look_at_camera as jax_look_at_camera
from texgs.core.state import init_from_pcd as jax_init_from_pcd
from texgs.data.synthetic import blob_point_cloud
from texgs.data.synthetic import orbit_cameras as jax_orbit_cameras
from texgs.io import checkpoint as jckpt
from texgs.kernels import chamfer as jchamfer
from texgs.nets.uv_net import patch_sample_sphere as jax_patch_sample_sphere
from texgs.nets.uv_net import sample_sphere as jax_sample_sphere
from texgs.train.uv_map_gaussian3d import UVMapGaussian3D as JaxModel
from texgs_torch.config import Cfg
from texgs_torch.kernels import chamfer
from texgs_torch.train.optim import flatten_tree
from texgs_torch.train.uv_map_gaussian3d import UVMapGaussian3D, from_jax_state
from tests.torch_threads import one_thread  # noqa: F401

N, SIZE = 400, 32
ITERS = (1, 2, 3)
NET = {"emb_dim": 16, "pre_mlp_cfg": {"n_hidden_layers": 1, "n_neurons": 16},
       "mlp_cfg": {"n_hidden_layers": 2, "n_neurons": 16}}
MODEL_CFG = {
    "type": "UVMapGaussian3D", "max_inverse_points": 300, "geo_emb_dim": 16,
    "uv_net_cfg": NET,
    "inv_uv_net_cfg": dict(NET, n_sample_points=64, patch_scale=4,
                           pre_mlp_cfg={"n_hidden_layers": 1, "n_neurons": 16,
                                        "hash_grid_cfg": {
                                            "n_levels": 2,
                                            "n_features_per_level": 4,
                                            "max_hashmap": 8}}),
    "seed": 4,
}
OPTIM_CFG = {"uv_net_lr": 1e-3, "inv_uv_net_lr": 2e-3,
             "uv_net_milestones": [2], "uv_net_gamma": 0.5}
LOSS_CFG = {"lambda_inverse": 1.0, "inverse_range": [0, None],
            "lambda_chamfer": 1.0, "chamfer_range": [0, None],
            "lambda_patch_chamfer": 0.5, "patch_chamfer_range": [0, None],
            "lambda_inverse2": 1.0, "inverse_range2": [0, None]}


@pytest.fixture(scope="module")
def stage1_files(tmp_path_factory):
    """A texgs stage-1 checkpoint (capacity padding included) and a
    pseudo ground-truth cloud."""
    d = tmp_path_factory.mktemp("s1")
    pcd = blob_point_cloud(N, seed=2)
    st = jax_init_from_pcd(pcd.points, pcd.colors, max_sh_degree=0,
                           capacity=N + 24)
    st = st.replace(opacity=st.opacity.at[:N].set(3.0))
    params = {k: np.asarray(v) for k, v in st.params_dict().items()}
    jckpt.save(str(d / "ckpt"), {"params": {**params, "n_alive": np.asarray(
        N, np.int32)}})
    np.save(d / "pcd.npy", pcd.points[::2])
    return str(d / "ckpt"), str(d / "pcd.npy")


def cfg_with(files):
    return dict(MODEL_CFG, init_from=files[0], pcd_load_from=files[1])


def camera():
    """texgs's first orbit camera with near and far planes at 1 and 10
    (depth2world inverts the projection in float32; see the stage-3
    test)."""
    orbit = jax_orbit_cameras(1, radius=3.5, width=SIZE, height=SIZE)[0]
    eye = np.linalg.inv(np.asarray(orbit.world_view, np.float64))[3, :3]
    cam = jax_look_at_camera(eye, np.zeros(3), np.array([0.0, 0.0, 1.0]),
                             orbit.fovx, orbit.fovy, SIZE, SIZE, znear=1.0,
                             zfar=10.0)
    return cam, dataclasses.replace(torch_camera(cam), znear=1.0, zfar=10.0)


def texgs_draws(jmodel, n_px):
    """The draws texgs's next ``_train_step`` derives from its key
    (uv_map_gaussian3d.py:164,181-199)."""
    _, key = jax.random.split(jmodel._rng)
    k1, k2 = jax.random.split(jax.random.fold_in(key, 1))
    ic = jmodel.cfg.inv_uv_net_cfg
    n = int(ic.n_sample_points)
    return {k: torch.as_tensor(np.array(v)) for k, v in dict(
        score=jax.random.uniform(key, (n_px,)),
        sample_uvs=jax_sample_sphere(k1, n),
        patch_uvs=jax_patch_sample_sphere(k2, n, int(ic.patch_scale))).items()}


@pytest.fixture(scope="module")
def trained(stage1_files):
    cfg = cfg_with(stage1_files)
    jmodel = JaxModel(JCfg(cfg), logging.getLogger("texgs-test"), "/x")
    jmodel.initialize(None, None)
    jmodel.bind_train_cfg(JCfg({}), [0, 0, 0])
    jmodel.setup_optim(JCfg(OPTIM_CFG))
    model = from_jax_state(jmodel.state_dict(), Cfg(cfg), device="cpu",
                           optim_cfg=Cfg(OPTIM_CFG))
    model.bind_train_cfg(Cfg({}), [0, 0, 0])
    jcam, tcam = camera()
    jdepth = jmodel.depth_alpha(jcam)
    # both steps see texgs's frozen render; the port's own is compared
    # separately
    port_render = model.depth_alpha(tcam)
    model._depth_alpha_cache[(tcam.uid, tcam.image_name)] = tuple(
        torch.as_tensor(np.array(a)) for a in jdepth)
    run = {"losses": [], "sd": [], "render": (jdepth, port_render)}
    for it in ITERS:
        draws = texgs_draws(jmodel, SIZE * SIZE)
        jstats = jmodel.compute_loss(it, 100, jcam, None, JCfg(LOSS_CFG))[1]
        jstats = jmodel.flush() or jstats
        _, stats, _ = model.compute_loss(it, 100, tcam, None, Cfg(LOSS_CFG),
                                         draws=draws)
        run["losses"].append(({k: float(v) for k, v in jstats.items()},
                              {k: float(v) for k, v in stats.items()}))
        if "grads" not in run:
            run["grads"] = tuple(
                {k: np.asarray(v) / 0.1 for k, v in
                 flatten_tree(s["optim_state"]["mu"]).items()}
                for s in (jmodel.state_dict(), model.state_dict()))
        jmodel.optimize_step(it, 100, JCfg({}), {})
        model.optimize_step(it, 100, Cfg({}), {})
        run["sd"].append((jmodel.state_dict(), model.state_dict()))
    return model, run


@pytest.fixture(scope="module")
def compacted(stage1_files):
    """One step of texgs and of the port at ``max_inverse_points`` 0 from
    the same state, view, frozen render and draws."""
    cfg = dict(cfg_with(stage1_files), max_inverse_points=0)
    jmodel = JaxModel(JCfg(cfg), logging.getLogger("texgs-test"), "/x")
    jmodel.initialize(None, None)
    jmodel.bind_train_cfg(JCfg({}), [0, 0, 0])
    jmodel.setup_optim(JCfg(OPTIM_CFG))
    model = from_jax_state(jmodel.state_dict(), Cfg(cfg), device="cpu",
                           optim_cfg=Cfg(OPTIM_CFG))
    model.bind_train_cfg(Cfg({}), [0, 0, 0])
    jcam, tcam = camera()
    model._depth_alpha_cache[(tcam.uid, tcam.image_name)] = tuple(
        torch.as_tensor(np.array(a)) for a in jmodel.depth_alpha(jcam))
    draws = texgs_draws(jmodel, SIZE * SIZE)
    jstats = jmodel.compute_loss(1, 100, jcam, None, JCfg(LOSS_CFG))[1]
    jstats = jmodel.flush() or jstats
    _, stats, _ = model.compute_loss(1, 100, tcam, None, Cfg(LOSS_CFG),
                                     draws=draws)
    grads = tuple({k: np.asarray(v) / 0.1 for k, v in
                   flatten_tree(s["optim_state"]["mu"]).items()}
                  for s in (jmodel.state_dict(), model.state_dict()))
    return model, tcam, ({k: float(v) for k, v in jstats.items()},
                         {k: float(v) for k, v in stats.items()}), grads


def test_masked_points_losses_match_texgs_all_pixels(compacted):
    _, _, (want, got), _ = compacted
    assert set(got) == set(want) and "Linv" in got
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)


def test_masked_points_gradients_match_texgs_all_pixels(compacted):
    _, _, _, (want, got) = compacted
    assert set(got) == set(want)
    for k in sorted(want):
        a, b = want[k].astype(np.float32), got[k].astype(np.float32)
        denom = np.abs(a).max() + 1e-8
        np.testing.assert_allclose(b / denom, a / denom, atol=2e-3,
                                   err_msg=f"grad mismatch: {k}")
        assert np.abs(b).max() > 0, k


def test_cached_points_are_the_masked_pixels(compacted):
    from texgs_torch.train.uv_map_gaussian3d import depth2world
    model, tcam, _, _ = compacted
    depth, alpha, _, _ = model.depth_alpha(tcam)
    fresh = depth2world(depth[0], tcam.full_proj, tcam.zfar,
                        tcam.znear).reshape(-1, 3)[alpha.reshape(-1) > 0.5]
    points = model.inverse_points(tcam)
    assert 0 < points.shape[0] < SIZE * SIZE
    assert torch.equal(points, fresh)


def test_a_second_step_on_a_view_runs_no_depth2world(compacted, monkeypatch):
    from texgs_torch.train import uv_map_gaussian3d as U
    model, tcam, _, _ = compacted
    calls = []
    monkeypatch.setattr(U, "depth2world",
                        lambda *a: calls.append(1) or pytest.fail("called"))
    cached = model.inverse_points(tcam)
    _, stats, _ = model.compute_loss(2, 100, tcam, None, Cfg(LOSS_CFG))
    assert not calls and np.isfinite(float(stats["Linv"]))
    assert model.inverse_points(tcam) is cached


def test_losses_match(trained):
    _, run = trained
    for it, (want, got) in zip(ITERS, run["losses"]):
        assert set(got) == set(want) == {"Linv", "Lchamfer", "Lpatch_chamfer",
                                         "Linv2", "total_loss"}
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4,
                                       err_msg=f"iter {it}: {k}")


def test_gradients_match(trained):
    _, run = trained
    want, got = run["grads"]
    assert set(got) == set(want)
    for k in sorted(want):
        a, b = want[k].astype(np.float32), got[k].astype(np.float32)
        assert a.shape == b.shape, k
        denom = np.abs(a).max() + 1e-8
        np.testing.assert_allclose(b / denom, a / denom, atol=2e-3,
                                   err_msg=f"grad mismatch: {k}")
        assert np.abs(b).max() > 0, k


def test_parameters_and_step_count_match(trained):
    _, run = trained
    jsd, tsd = run["sd"][-1]
    want, got = flatten_tree(jsd["net_state"]), flatten_tree(tsd["net_state"])
    assert set(got) == set(want)
    for k in want:
        a, b = np.asarray(want[k]), np.asarray(got[k])
        err = np.abs(a - b)
        lr = OPTIM_CFG["inv_uv_net_lr" if k.startswith("inv_uv_net")
                       else "uv_net_lr"]
        assert (err <= 1e-5).mean() >= 0.999, f"{k}: {(err > 1e-5).sum()}"
        assert err.max() <= 3 * lr, k
    assert tsd["optim_state"]["step_count"] == jsd["optim_state"]["step_count"] == 3


def test_frozen_render_matches_texgs_oracle(trained):
    _, run = trained
    want, got = run["render"]
    # tests/test_rasterizer.py:89-93: depth at 2e-4 (hard 2e-2), the rest
    # at 2e-5 (hard 5e-3)
    for name, w, g, atol, hard in zip(("depth", "alpha", "norm"), want[:3],
                                      got[:3], (2e-4, 2e-5, 2e-5),
                                      (2e-2, 5e-3, 5e-3)):
        assert_close_mostly(g.numpy(), np.asarray(w), atol=atol, frac=0.999,
                            hard_atol=hard, name=name)


def test_state_dict_round_trips_through_texgs(trained, stage1_files):
    model, _ = trained
    sd = model.state_dict()
    other = JaxModel(JCfg(cfg_with(stage1_files)), logging.getLogger("t"), "/x")
    other.load_state_dict(sd, JCfg(OPTIM_CFG))
    back = other.state_dict()
    for part in ("net_state", "optim_state"):
        a, b = flatten_tree(sd[part]), flatten_tree(back[part])
        assert set(a) == set(b), part
        for k in a:
            np.testing.assert_array_equal(np.asarray(b[k]), np.asarray(a[k]),
                                          err_msg=f"{part}.{k}")


def test_stage1_checkpoint_hand_off(tmp_path):
    """The port's stage-1 checkpoint initialises both packages' stage 2
    with the same frozen Gaussians."""
    from texgs_torch.core.state import init_from_pcd
    from texgs_torch.io import checkpoint as ckpt
    from texgs_torch.train.gaussian3d import Gaussian3D

    pcd = blob_point_cloud(200, seed=3)
    s1 = Gaussian3D(Cfg({"sh_degree": 1}), device="cpu")
    s1.state = init_from_pcd(pcd.points, pcd.colors, 1, device="cpu")
    s1.setup_optim(Cfg({"position_lr_init": 1e-4, "position_lr_final": 1e-6,
                        "position_lr_delay_mult": 0.01,
                        "position_lr_max_steps": 10}))
    ckpt.save(str(tmp_path / "s1"), s1.state_dict(), 10)
    np.save(tmp_path / "pcd.npy", pcd.points)
    cfg = cfg_with((str(tmp_path / "s1"), str(tmp_path / "pcd.npy")))
    jm = JaxModel(JCfg(cfg), logging.getLogger("t"), "/x")
    jm.initialize(None, None)
    tm = UVMapGaussian3D(Cfg(cfg), device="cpu")
    tm.initialize()
    assert int(jm.gauss["n_alive"]) == tm.gauss["xyz"].shape[0] == 200
    for k in ("xyz", "scaling", "rotation", "opacity"):
        np.testing.assert_array_equal(tm.gauss[k].numpy(),
                                      np.asarray(jm.gauss[k]))
    np.testing.assert_array_equal(tm.pcd.numpy(), np.asarray(jm.pcd))


@pytest.mark.parametrize("single", [False, True], ids=["both", "single"])
def test_chamfer_matches_texgs(single):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(700, 3)).astype(np.float32)
    y = rng.normal(size=(5000, 3)).astype(np.float32)
    want = jchamfer.chamfer_distance(jnp.asarray(x), jnp.asarray(y),
                                     single_directional=single)
    got = chamfer.chamfer_distance(torch.as_tensor(x), torch.as_tensor(y),
                                   single_directional=single)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def test_farthest_point_sampling_matches_texgs():
    pts = blob_point_cloud(600, seed=5).points
    want = np.asarray(jchamfer.farthest_point_sampling(jnp.asarray(pts), 64))
    got = chamfer.farthest_point_sampling(torch.as_tensor(pts), 64).numpy()
    np.testing.assert_array_equal(got, want)
