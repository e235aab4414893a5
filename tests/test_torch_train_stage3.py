"""The stage-3 training step: texgs's TextureGaussian3D against the port's.

Both models load the same numpy state (texgs's ``state_dict()``) through
``from_jax_state``: 300 Gaussians, all alive, 48x48 views, a 16^2
cubemap, UV nets of emb 16 and an inverse net with a 2-level hash grid.
texgs trains with ``backend: scan`` and ``tex_backend: xla``, whose math
the port's kernels A and B follow; the port runs their plain versions on
the CPU.  Every loss flag is on and ``max_inverse_points`` exceeds H * W,
so neither package samples the inverse loss's pixels.

Four iterations; the third is a min-scale reset (scaling lr 0, then its
moments zeroed) and an SH-degree step, and the fourth trains at the new
degree.  Tolerances:
  * gradients (read from the first step's Adam moments, mu = 0.1 g) at
    atol 2e-3 of the leaf's max |grad|, as tests/test_uvtex_raster.py
    compares the fused and scan backwards;
  * the total loss of each step at rtol 1e-4;
  * the parameters after three steps, the reset included: 99.9% of each
    leaf's elements within 1e-5, none off by more than 3 lr of the leaf.
    Adam's first steps move an element by +-lr whatever the size of its
    gradient, so a gradient near 0 whose sign differs in the last bits
    moves it 2 lr apart.  After the reset every flattened axis has a
    gradient of that kind and zeroed moments, so the parameters are
    compared before the step that follows it.
"""

import contextlib
import dataclasses
import logging

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_uvtex_fused import torch_camera
from texgs.config import Cfg as JCfg
from texgs.core.camera import look_at_camera as jax_look_at_camera
from texgs.core.state import init_from_pcd as jax_init_from_pcd
from texgs.data.synthetic import blob_point_cloud
from texgs.data.synthetic import orbit_cameras as jax_orbit_cameras
from texgs.train.texture_gaussian3d import TextureGaussian3D as JaxModel
from texgs_torch.config import Cfg
from texgs_torch.core.camera import with_ground_truth
from texgs_torch.train.optim import flatten_tree
from texgs_torch.train.texture_gaussian3d import (TextureGaussian3D,
                                                  from_jax_state)

N, SIZE, RES = 300, 48, 16
BG = [0.1, 0.2, 0.3]
ITERS = (1998, 1999, 2000, 2001)
MODEL_CFG = {
    "uv_net_cfg": {"emb_dim": 16,
                   "pre_mlp_cfg": {"n_hidden_layers": 1, "n_neurons": 16},
                   "mlp_cfg": {"n_hidden_layers": 2, "n_neurons": 16}},
    "inv_uv_net_cfg": {
        "emb_dim": 16,
        "pre_mlp_cfg": {"hash_grid_cfg": {"n_levels": 2,
                                          "n_features_per_level": 4,
                                          "max_hashmap": 8},
                        "n_hidden_layers": 1, "n_neurons": 16},
        "mlp_cfg": {"n_hidden_layers": 1, "n_neurons": 16}},
    "tex_cfg": {"resolution": RES, "max_sh_degree": 3},
    "geo_emb_dim": 16,
    "max_inverse_points": 4 * SIZE * SIZE,
    "backend": "scan",
    "tex_backend": "xla",
    "uvtex_m": 32,
    "seed": 3,
}
TRAIN_CFG = {"min_scale_reset_interval": 1000}
OPTIM_CFG = {
    "uv_net_lr": 2e-4, "inv_uv_net_lr": 3e-4, "uv_net_milestones": [2500],
    "uv_net_gamma": 0.5, "tex_optim_range": [0, None], "tex_lr": 0.0025,
    "gaussian_optim_range": [0, None], "position_lr_init": 1e-4,
    "position_lr_final": 1e-6, "position_lr_delay_mult": 0.01,
    "position_lr_max_steps": 7500, "opacity_lr": 0.05, "scaling_lr": 0.005,
    "rotation_lr": 0.001,
}
LOSS_CFG = {
    "lambda_dssim": 0.2, "rgb_range": [0, None],
    "lambda_alpha": 1.0, "alpha_range": [0, None],
    "lambda_depth": 0.05, "depth_range": [0, None],
    "lambda_norm": 0.1, "norm_range": [0, None],
    "lambda_norm_reg": 0.05, "norm_reg_range": [0, None],
    "lambda_norm_smooth": 0.5, "norm_smooth_range": [0, None],
    "lambda_opacity_reg": 0.01, "opacity_reg_range": [0, None],
    "lambda_no_sh": 2.0, "rgb_no_sh_range": [0, None],
    "lambda_inverse": 0.1, "inverse_range": [0, None],
}


def build_jax_model() -> JaxModel:
    from tests.test_uvtex_raster import _texture

    model = JaxModel(JCfg(MODEL_CFG), logging.getLogger("texgs-test"),
                     "/nonexistent")
    pcd = blob_point_cloud(N, seed=7)
    state = jax_init_from_pcd(pcd.points, pcd.colors, max_sh_degree=3,
                              capacity=N)
    rng = np.random.default_rng(0)
    model.gauss_params = {
        "xyz": state.xyz,
        "scaling": state.scaling + jnp.asarray(
            0.2 * rng.normal(size=(N, 3)), jnp.float32),
        "rotation": state.rotation,
        "opacity": jnp.asarray(rng.uniform(-1.0, 4.0, size=(N, 1)), jnp.float32),
        "shs": jnp.asarray(0.05 * rng.normal(size=(N, 15, 3)), jnp.float32)}
    model.n_alive = jnp.asarray(N, jnp.int32)
    model.tex_params = {"texture": _texture(RES)}
    model.active_sh_degree = 1
    model.spatial_lr_scale = 2.0
    model.bind_train_cfg(JCfg(TRAIN_CFG), BG)
    model.setup_optim(JCfg(OPTIM_CFG))
    return model


def cameras(jmodel):
    """The training view twice, as a texgs Camera and as the port's, with
    the same ground truth: the model's render plus noise, a binary alpha
    mask, its normals and its depth, scaled.  The view is texgs's first
    orbit camera with near and far planes at 1 and 10: depth2world inverts
    the projection in float32, which at texgs's default planes (0.01, 100)
    leaves world points 1e-4 apart between two LU implementations."""
    orbit = jax_orbit_cameras(1, radius=3.5, width=SIZE, height=SIZE)[0]
    eye = np.linalg.inv(np.asarray(orbit.world_view, np.float64))[3, :3]
    cam = jax_look_at_camera(eye, np.zeros(3), np.array([0.0, 0.0, 1.0]),
                             orbit.fovx, orbit.fovy, SIZE, SIZE,
                             znear=1.0, zfar=10.0)
    out = jmodel.visual_step(0, 1, cam, None)
    rng = np.random.default_rng(1)
    image = np.clip(np.asarray(out["image"])
                    + 0.1 * rng.normal(size=(3, SIZE, SIZE)), 0.0, 1.0)
    alpha = (np.asarray(out["alpha"]) > 0.3).astype(np.float32)
    normal = np.asarray(out["norm"]).astype(np.float32)
    depth = (np.asarray(out["depth"]) * 1.05
             + 0.02 * rng.normal(size=(1, SIZE, SIZE))).astype(np.float32)
    jcam = dataclasses.replace(cam, image=(image * alpha).astype(np.float32),
                               alpha_mask=alpha, normal=normal, depth=depth)
    tcam = dataclasses.replace(torch_camera(cam), znear=cam.znear,
                               zfar=cam.zfar)
    tcam = with_ground_truth(tcam, image, alpha, normal, depth)
    return jcam, tcam


def port_model(sd):
    model = from_jax_state(sd, Cfg(MODEL_CFG), device="cpu",
                           optim_cfg=Cfg(OPTIM_CFG))
    model.bind_train_cfg(Cfg(TRAIN_CFG), BG)
    return model


@contextlib.contextmanager
def one_thread():
    """torch's CPU kernels sum in the same order from run to run only on
    one thread: on several, a step's small gradients differ in their last
    bits between two runs of one process."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def leaves(sd, *parts):
    out = {}
    for part in parts:
        out.update({f"{part}.{k}": np.asarray(v, np.float32)
                    for k, v in flatten_tree(sd[part]).items()})
    return out


def assert_params_close(want: dict, got: dict, tol: float):
    """Each leaf: 99.9% of its elements within tol, none beyond 3 lr."""
    assert set(got) == set(want)
    oc = OPTIM_CFG
    lr = {"params.xyz": oc["position_lr_init"] * 2.0,
          "params.opacity": oc["opacity_lr"], "params.scaling": oc["scaling_lr"],
          "params.rotation": oc["rotation_lr"], "params.shs": oc["tex_lr"] / 20,
          "params.texture": oc["tex_lr"]}
    for k in sorted(want):
        a, b = want[k], got[k]
        assert a.shape == b.shape, k
        err = np.abs(a - b)
        leaf_lr = lr.get(k, oc["inv_uv_net_lr"] if ".inv_uv_net." in k
                         else oc["uv_net_lr"])
        assert (err <= tol).mean() >= 0.999, \
            f"{k}: {(err > tol).sum()} of {err.size} beyond {tol}"
        assert err.max() <= 3 * leaf_lr + 1e-6, f"{k}: max err {err.max():.3e}"


@pytest.fixture(scope="module")
def trained():
    """Both packages through ITERS, the port on one thread.  ``run`` keeps
    each step's losses, the first step's gradients, the SH degrees, and
    the state dicts after each step."""
    jmodel = build_jax_model()
    jcam, tcam = cameras(jmodel)
    model = port_model(jmodel.state_dict())
    jlc, tlc = JCfg(LOSS_CFG), Cfg(LOSS_CFG)
    run = {"losses": [], "sh": [], "sd": []}
    for it in ITERS:
        jmodel.compute_loss(it, 10000, jcam, None, jlc)
        jloss = float(jmodel.flush()["total_loss"])
        with one_thread():
            tloss, stats, _ = model.compute_loss(it, 10000, tcam, None, tlc)
        run["losses"].append((jloss, float(tloss)))
        run.setdefault("stats", stats)
        if "grads" not in run:
            # from zero moments, Adam's first step leaves mu = (1 - b1) g
            run["grads"] = tuple(
                {k: v / 0.1 for k, v in flatten_tree(s["optim_state"]).items()
                 if ".mu." in f".{k}."}
                for s in (jmodel.state_dict(), model.state_dict()))
        jmodel.optimize_step(it, 10000, JCfg(TRAIN_CFG), {})
        model.optimize_step(it, 10000, Cfg(TRAIN_CFG), {})
        run["sh"].append((jmodel.active_sh_degree, model.active_sh_degree))
        run["sd"].append((jmodel.state_dict(), model.state_dict()))
    return model, tcam, run


def test_losses_match(trained):
    _, _, run = trained
    for it, (jl, tl) in zip(ITERS, run["losses"]):
        assert np.isfinite(tl)
        np.testing.assert_allclose(tl, jl, rtol=1e-4, err_msg=f"iter {it}")


def test_step_stats_carry_every_term(trained):
    _, _, run = trained
    stats = run["stats"]
    for k in ("Ll1", "Lssim", "Lalpha", "Ldepth", "Lnorm", "Lnorm_reg",
              "Lnorm_smooth", "Lopacity_reg", "Ll1_nosh", "Lssim_nosh", "Linv"):
        assert k in stats and torch.isfinite(stats[k]), k
    assert int(stats["n_pairs"]) > 0


def test_gradients_match(trained):
    _, _, run = trained
    want, got = run["grads"]
    assert set(got) == set(want)
    for k in sorted(want):
        a, b = np.asarray(want[k], np.float32), np.asarray(got[k], np.float32)
        assert a.shape == b.shape, k
        denom = np.abs(a).max() + 1e-8
        np.testing.assert_allclose(b / denom, a / denom, atol=2e-3,
                                   err_msg=f"grad mismatch: {k}")
    # every group of leaves is trained by this step
    for k in ("gauss.mu.xyz", "gauss.mu.opacity", "gauss.mu.shs",
              "uv.mu.uv_net.mlp.w.0", "uv.mu.inv_uv_net.hashgrid.table",
              "uv.mu.geo_emb", "tex.mu.texture"):
        assert np.abs(np.asarray(got[k])).max() > 0, k


def test_parameters_match_after_steps(trained):
    _, _, run = trained
    jsd, tsd = run["sd"][2]
    assert_params_close(leaves(jsd, "params", "net_state"),
                        leaves(tsd, "params", "net_state"), 1e-5)


def test_min_scale_reset_and_sh_degree_step(trained):
    _, _, run = trained
    # iteration 2000 is a reset and an SH-degree step in both packages
    assert run["sh"] == [(1, 1), (1, 1), (2, 2), (2, 2)]
    rows = np.arange(N)
    for sd2, sd3 in zip(*run["sd"][1:3]):
        before = np.asarray(sd2["params"]["scaling"])
        after = np.asarray(sd3["params"]["scaling"])
        np.testing.assert_array_equal(after[rows, before.argmin(1)], -20.0)
        # lr 0 on the reset iteration: the other axes did not move
        keep = np.ones_like(before, bool)
        keep[rows, before.argmin(1)] = False
        np.testing.assert_array_equal(after[keep], before[keep])
        for moment in ("mu", "nu"):
            assert not np.asarray(
                sd3["optim_state"]["gauss"][moment]["scaling"]).any()


def test_state_dict_round_trips_through_texgs(trained):
    """port -> texgs load_state_dict -> texgs state_dict -> port."""
    model, _, _ = trained
    sd = model.state_dict()
    other = build_jax_model()
    other.load_state_dict(sd, JCfg(OPTIM_CFG))
    back = port_model(other.state_dict())
    again = back.state_dict()
    for part in ("params", "net_state", "optim_state"):
        a, b = flatten_tree(sd[part]), flatten_tree(again[part])
        assert set(a) == set(b), part
        for k in a:
            np.testing.assert_array_equal(np.asarray(b[k]), np.asarray(a[k]),
                                          err_msg=f"{part}.{k}")
    assert again["hyperparams"] == sd["hyperparams"]
    assert back.active_sh_degree == model.active_sh_degree == 2


def test_step_after_round_trip_matches(trained):
    """A model restored from the first step's state dict takes the second
    step as the trained model did (both on one thread)."""
    _, tcam, run = trained
    restored = port_model(run["sd"][0][1])
    with one_thread():
        loss = restored.compute_loss(ITERS[1], 10000, tcam, None,
                                     Cfg(LOSS_CFG))[0]
    np.testing.assert_allclose(float(loss), run["losses"][1][1], rtol=1e-6)
    assert_params_close(leaves(run["sd"][1][1], "params", "net_state"),
                        leaves(restored.state_dict(), "params", "net_state"),
                        1e-6)


def test_initialize_from_stage1_and_stage2_checkpoints(tmp_path):
    """``initialize`` reads the stage-1 Gaussians and the stage-2 UV nets
    from texgs checkpoints, as texgs's does: capacity padding sliced off,
    residual SH at zero."""
    from texgs.io import checkpoint as jckpt

    jmodel = build_jax_model()
    sd = jmodel.state_dict()
    params = {k: np.asarray(v) for k, v in sd["params"].items()
              if k in ("xyz", "opacity", "scaling", "rotation")}
    pad = {k: np.concatenate([v, np.zeros((8,) + v.shape[1:], v.dtype)])
           for k, v in params.items()}
    jckpt.save(str(tmp_path / "s1"),
               {"params": {**pad, "n_alive": np.asarray(N, np.int32)}})
    jckpt.save(str(tmp_path / "s2"), {"net_state": sd["net_state"]})
    cfg = dict(MODEL_CFG, init_from=str(tmp_path / "s1"),
               init_uv_map_from=str(tmp_path / "s2"))
    model = TextureGaussian3D(Cfg(cfg), device="cpu")
    model.initialize(None, 2.5)
    assert model.spatial_lr_scale == 2.5 and model.n_points == N
    for k, v in params.items():
        np.testing.assert_array_equal(model.gauss[k].numpy(), v)
    assert model.gauss["shs"].shape == (N, 15, 3) and not model.gauss["shs"].any()
    got = model.state_dict()["net_state"]
    for k, v in flatten_tree(sd["net_state"]).items():
        np.testing.assert_array_equal(np.asarray(flatten_tree(got)[k]),
                                      np.asarray(v), err_msg=k)
