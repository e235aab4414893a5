"""The stage-1 training step: texgs's Gaussian3D against the port's.

Both models start from the same numpy state (texgs's ``state_dict()`` at
capacity == n_alive): 300 Gaussians on a blob, SH degree 2, 48x48 views.
texgs trains with ``backend: scan``, whose math kernels 1 and 1' follow;
the port runs their plain versions on the CPU.  Every stage-1 loss term is
on.  Five iterations, 998..1002: 999 is an opacity prune (a surgery
iteration: neither package takes the Adam step, nor advances its counts),
1000 raises the SH degree, 1002 densifies (clone + split + prune) with
texgs's split draws handed to the port.  The opacity regulariser is on
until the prune (texgs's then averages over its padded rows).  Tolerances:
  * gradients (read from the first step's Adam moments, mu = 0.1 g) at
    atol 2e-3 of the leaf's max |grad|, as the stage-3 test holds them;
  * each step's total loss at rtol 1e-4;
  * the densification stats (NDC-offset gradient norms, visibility counts,
    max radii) at rtol 1e-4 / atol 1e-7;
  * the parameters after each step: 99.9% of each leaf's elements within
    1e-5, none off by more than 3 lr of the leaf (Adam's first steps move
    an element by +-lr whatever the size of its gradient, so a gradient
    near 0 whose sign differs in the last bits moves it 2 lr apart).
"""

import contextlib
import dataclasses
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_uvtex_fused import torch_camera
from texgs.config import Cfg as JCfg
from texgs.core.state import init_from_pcd as jax_init_from_pcd
from texgs.data.synthetic import blob_point_cloud
from texgs.data.synthetic import orbit_cameras as jax_orbit_cameras
from texgs.train.gaussian3d import Gaussian3D as JaxModel
from texgs_torch.config import Cfg
from texgs_torch.core.camera import with_ground_truth
from texgs_torch.train.gaussian3d import from_jax_state

N, SIZE = 300, 48
BG = [0.1, 0.2, 0.3]
ITERS = (998, 999, 1000, 1001, 1002)
MODEL_CFG = {"type": "Gaussian3D", "sh_degree": 2, "backend": "scan",
             "seed": 5}
TRAIN_CFG = {"densification_interval": 1002, "densify_from_iter": 500,
             "densify_until_iter": 5000, "opacity_reset_interval": 10000,
             "densify_grad_threshold": 0.0002, "min_scale_reset_interval": 0,
             "min_scale_reset_from_iter": 0, "opacity_prune_interval": 999,
             "opacity_prune_theshold": 0.4}
OPTIM_CFG = {"position_lr_init": 0.00016, "position_lr_final": 0.0000016,
             "position_lr_delay_mult": 0.01, "position_lr_max_steps": 7500,
             "feature_lr": 0.0025, "opacity_lr": 0.05, "scaling_lr": 0.005,
             "rotation_lr": 0.001, "percent_dense": 0.05}
# the opacity regulariser stops at the prune: texgs then pads the pruned
# rows, and its regulariser averages over them too
LOSS_CFG = {"lambda_dssim": 0.2, "lambda_alpha": 1.0,
            "lambda_opacity_reg": 0.01, "opacity_reg_range": [0, 999],
            "lambda_depth": 0.05,
            "lambda_norm": 0.1, "lambda_norm_smooth": 0.1,
            "lambda_norm_reg": 0.05}
EXTENT = 2.0


def build_jax_model() -> JaxModel:
    model = JaxModel(JCfg(MODEL_CFG), logging.getLogger("texgs-test"),
                     "/nonexistent")
    pcd = blob_point_cloud(N, seed=7)
    st = jax_init_from_pcd(pcd.points, pcd.colors, max_sh_degree=2)
    rng = np.random.default_rng(0)
    model.state = st.replace(
        scaling=st.scaling + jnp.asarray(0.2 * rng.normal(size=(N, 3)),
                                         jnp.float32),
        opacity=jnp.asarray(rng.uniform(-1.0, 4.0, size=(N, 1)), jnp.float32),
        features_rest=jnp.asarray(0.05 * rng.normal(size=(N, 8, 3)),
                                  jnp.float32))
    model.spatial_lr_scale = EXTENT
    model.bind_train_cfg(JCfg(TRAIN_CFG), BG)
    model.setup_optim(JCfg(OPTIM_CFG))
    return model


def cameras(jmodel):
    """The training view as a texgs Camera and as the port's, with the
    same ground truth off the model's render (so no L1 term sits at its
    kink): the render plus noise, a binary alpha mask, rolled normals and
    scaled depth."""
    cam = jax_orbit_cameras(1, radius=3.5, width=SIZE, height=SIZE)[0]
    out = jmodel.visual_step(0, 1, cam, None)
    rng = np.random.default_rng(1)
    image = np.clip(np.asarray(out["image"])
                    + 0.1 * rng.normal(size=(3, SIZE, SIZE)), 0.0, 1.0)
    alpha = (np.asarray(out["alpha"]) > 0.3).astype(np.float32)
    normal = np.roll(np.asarray(out["norm"]), 1, axis=0).astype(np.float32)
    depth = (np.asarray(out["depth"]) * 1.05
             + 0.02 * rng.normal(size=(1, SIZE, SIZE))).astype(np.float32)
    jcam = dataclasses.replace(cam, image=(image * alpha).astype(np.float32),
                               alpha_mask=alpha, normal=normal, depth=depth)
    tcam = with_ground_truth(torch_camera(cam), image, alpha, normal, depth)
    return jcam, tcam


def port_model(sd):
    model = from_jax_state(sd, Cfg(MODEL_CFG), device="cpu",
                           optim_cfg=Cfg(OPTIM_CFG))
    model.bind_train_cfg(Cfg(TRAIN_CFG), BG)
    return model


@contextlib.contextmanager
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def gap_threshold(avg):
    """A densify threshold in the widest gap of the middle third of the
    sorted average gradients, so no Gaussian sits on it."""
    v = np.sort(avg[avg > 0])
    lo, hi = len(v) // 3, 2 * len(v) // 3
    i = lo + int(np.argmax(np.diff(v[lo:hi + 1])))
    return float(0.5 * (v[i] + v[i + 1]))


@pytest.fixture(scope="module")
def trained():
    """Both packages through ITERS, the port on one thread."""
    jmodel = build_jax_model()
    jcam, tcam = cameras(jmodel)
    model = port_model(jmodel.state_dict())
    jlc, tlc = JCfg(LOSS_CFG), Cfg(LOSS_CFG)
    run = {"losses": [], "sh": [], "sd": [], "n": []}
    for it in ITERS:
        # texgs validates its first step at once and later ones on flush()
        jstats = jmodel.compute_loss(it, 10000, jcam, None, jlc)[1]
        jstats = jmodel.flush() or jstats
        with one_thread():
            tloss, stats, _ = model.compute_loss(it, 10000, tcam, None, tlc)
        run["losses"].append((float(jstats["total_loss"]), float(tloss)))
        run.setdefault("stats", (jstats, stats))
        if "grads" not in run:
            # from zero moments, Adam's first step leaves mu = (1 - b1) g
            run["grads"] = tuple({k: np.asarray(v) / 0.1 for k, v in
                                  s["adam"]["mu"].items()}
                                 for s in (jmodel.state_dict(),
                                           model.state_dict()))
        tc = dict(TRAIN_CFG)
        if it % TRAIN_CFG["densification_interval"] == 0:
            from texgs.train import densify as jdensify
            tc["densify_grad_threshold"] = gap_threshold(
                np.asarray(jdensify.avg_grads(jmodel.stats)))
            draws = split_draws(jmodel, model.n_points,
                                tc["densify_grad_threshold"])
            model.split_noise = lambda d=draws: d
        run["pre"] = (jmodel.state_dict(), model.state_dict())
        jmodel.optimize_step(it, 10000, JCfg(tc), {})
        model.optimize_step(it, 10000, Cfg(tc), {})
        run["sh"].append((jmodel.active_sh_degree, model.active_sh_degree))
        run["sd"].append((jmodel.state_dict(), model.state_dict()))
        run["n"].append((int(jmodel.state.n_alive), model.n_points))
    return model, tcam, run


def split_draws(jmodel, n, threshold):
    """texgs's split-child normal draws of the coming densification, as
    its densify_and_prune will draw them (after the capacity growth),
    cut to the n live rows."""
    from texgs.train import densify as jdensify

    need = int(jdensify.required_capacity(
        jmodel.state, jmodel.stats, threshold, jmodel.spatial_lr_scale,
        OPTIM_CFG["percent_dense"]))
    cap = jmodel.state.capacity
    if need > cap:
        cap = 2048
        while cap < need:
            cap *= 2
    _, key = jax.random.split(jmodel._rng)
    k1, k2 = jax.random.split(key)
    return torch.as_tensor(np.stack([
        np.asarray(jax.random.normal(k, (cap, 3)))[:n] for k in (k1, k2)]))


def rows(sd, n):
    """The first n rows of every parameter, moment and stat of a stage-1
    state dict, by dotted name."""
    out = {f"params.{k}": np.asarray(v)[:n] for k, v in sd["params"].items()
           if k != "n_alive"}
    for m in ("mu", "nu"):
        out.update({f"adam.{m}.{k}": np.asarray(v)[:n]
                    for k, v in sd["adam"][m].items()})
    out.update({f"stats.{k}": np.asarray(v)[:n] for k, v in sd["stats"].items()})
    return out


def assert_params_close(want: dict, got: dict, tol: float):
    """Each parameter leaf: 99.9% of its elements within tol, none beyond
    3 lr of the leaf."""
    oc = OPTIM_CFG
    lr = {"xyz": oc["position_lr_init"] * EXTENT, "f_dc": oc["feature_lr"],
          "f_rest": oc["feature_lr"] / 20, "opacity": oc["opacity_lr"],
          "scaling": oc["scaling_lr"], "rotation": oc["rotation_lr"]}
    for k, leaf_lr in lr.items():
        a, b = want[f"params.{k}"], got[f"params.{k}"]
        assert a.shape == b.shape, k
        err = np.abs(a - b)
        assert (err <= tol).mean() >= 0.999, \
            f"{k}: {(err > tol).sum()} of {err.size} beyond {tol}"
        assert err.max() <= 3 * leaf_lr + 1e-6, f"{k}: max err {err.max():.3e}"


def test_losses_match(trained):
    _, _, run = trained
    for it, (jl, tl) in zip(ITERS, run["losses"]):
        assert np.isfinite(tl)
        np.testing.assert_allclose(tl, jl, rtol=1e-4, err_msg=f"iter {it}")


def test_step_stats_carry_every_term(trained):
    _, _, run = trained
    jstats, stats = run["stats"]
    for k in ("Ll1", "Lssim", "Lalpha", "Lopacity_reg", "Ldepth", "Lnorm",
              "Lnorm_smooth", "Lnorm_reg"):
        assert k in stats and torch.isfinite(stats[k]), k
        np.testing.assert_allclose(float(stats[k]), float(jstats[k]),
                                   rtol=1e-4, atol=1e-7, err_msg=k)
    assert int(stats["n_pairs"]) == int(jstats["n_pairs"]) > 0


def test_gradients_match(trained):
    _, _, run = trained
    want, got = run["grads"]
    assert set(got) == set(want)
    for k in sorted(want):
        a, b = want[k].astype(np.float32), got[k].astype(np.float32)
        assert a.shape == b.shape, k
        denom = np.abs(a).max() + 1e-8
        np.testing.assert_allclose(b / denom, a / denom, atol=2e-3,
                                   err_msg=f"grad mismatch: {k}")
        assert np.abs(b).max() > 0 or k == "f_rest", k


def test_densify_stats_match(trained):
    _, _, run = trained
    for it, (jsd, tsd) in zip(ITERS, run["sd"]):
        n = tsd["params"]["xyz"].shape[0]
        for k in ("xyz_gradient_accum", "denom", "max_radii2d"):
            np.testing.assert_allclose(tsd["stats"][k],
                                       np.asarray(jsd["stats"][k])[:n],
                                       rtol=1e-4, atol=1e-7,
                                       err_msg=f"iter {it}: {k}")
    # the step before the densification accumulated nonzero stats
    pre = run["pre"][1]["stats"]
    assert pre["xyz_gradient_accum"].max() > 0 and pre["denom"].max() == 5


def test_parameters_match_after_each_step(trained):
    _, _, run = trained
    for it, (jsd, tsd), (jn, tn) in zip(ITERS, run["sd"], run["n"]):
        assert jn == tn, f"iter {it}: {jn} vs {tn} Gaussians"
        assert_params_close(rows(jsd, jn), rows(tsd, tn), 1e-5)


def test_surgery_skips_adam_and_keeps_counts(trained):
    _, _, run = trained
    counts = [(int(np.asarray(j["adam"]["count"]["xyz"])),
               int(np.asarray(t["adam"]["count"]["xyz"]))) for j, t in run["sd"]]
    # 999 (prune) and 1002 (densify) skip the step
    assert counts == [(1, 1), (1, 1), (2, 2), (3, 3), (3, 3)]
    n = [t for _, t in run["n"]]
    assert n[1] < N, "the opacity prune removed Gaussians"
    assert n[4] > n[3], "densification added Gaussians"


def test_densified_rows_and_moments_match(trained):
    """After densification: the Adam moments of the rows (originals,
    clones, split children, in texgs's order; zero for new rows) at atol
    2e-3 of the leaf's max, and the reset stats."""
    _, _, run = trained
    (jsd, tsd), (jn, tn) = run["sd"][-1], run["n"][-1]
    want, got = rows(jsd, jn), rows(tsd, tn)
    for k in (k for k in want if k.startswith("adam.")):
        denom = np.abs(want[k]).max() + 1e-12
        np.testing.assert_allclose(got[k] / denom, want[k] / denom, atol=2e-3,
                                   err_msg=k)
    n_new = tn - run["n"][-2][1]
    assert (np.abs(got["adam.mu.xyz"]).sum(-1) == 0).sum() >= n_new
    for k in ("xyz_gradient_accum", "denom", "max_radii2d"):
        assert not tsd["stats"][k].any() and not want[f"stats.{k}"].any()


def test_sh_degree_step(trained):
    _, _, run = trained
    assert run["sh"] == [(0, 0), (0, 0), (1, 1), (1, 1), (1, 1)]


def test_state_dict_round_trips_and_renders_in_texgs(trained):
    """port -> texgs load_state_dict -> texgs renders the same image and
    gives back the same state dict, which the port loads again."""
    model, tcam, _ = trained
    sd = model.state_dict()
    other = build_jax_model()
    other.load_state_dict(sd, JCfg(OPTIM_CFG))
    cam = jax_orbit_cameras(1, radius=3.5, width=SIZE, height=SIZE)[0]
    other.bind_train_cfg(JCfg(TRAIN_CFG), BG)
    want = other.visual_step(0, 1, cam, None)
    got = model.visual_step(0, 1, tcam)
    for k in ("image", "alpha", "depth", "norm"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=3e-5, err_msg=k)
    back = port_model(other.state_dict()).state_dict()
    for part in ("params", "stats"):
        for k, v in sd[part].items():
            np.testing.assert_array_equal(np.asarray(back[part][k]),
                                          np.asarray(v), err_msg=k)
    for m in ("mu", "nu", "count"):
        for k, v in sd["adam"][m].items():
            np.testing.assert_array_equal(np.asarray(back["adam"][m][k]),
                                          np.asarray(v), err_msg=f"{m}.{k}")
    assert back["hyperparams"] == sd["hyperparams"]


def test_load_slices_texgs_capacity_padding():
    """A texgs state padded to capacity 2048 (its initialize) loads with
    its n_alive rows and renders as texgs does."""
    jm = JaxModel(JCfg(MODEL_CFG), logging.getLogger("texgs-test"), "/x")
    pcd = blob_point_cloud(N, seed=7)
    from texgs.utils.graphics import BasicPointCloud
    jm.initialize(BasicPointCloud(pcd.points, pcd.colors, pcd.normals), 2.0)
    jm.setup_optim(JCfg(OPTIM_CFG))
    jm.bind_train_cfg(JCfg(TRAIN_CFG), BG)
    assert jm.state.capacity == 2048
    model = port_model(jm.state_dict())
    assert model.n_points == N and model.stats.denom.shape == (N, 1)
    cam = jax_orbit_cameras(1, radius=3.5, width=SIZE, height=SIZE)[0]
    want = jm.visual_step(0, 1, cam, None)
    got = model.visual_step(0, 1, torch_camera(cam))
    np.testing.assert_allclose(got["image"].numpy(), np.asarray(want["image"]),
                               atol=3e-5)
