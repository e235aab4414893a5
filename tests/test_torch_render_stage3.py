"""The whole stage-3 render slice: texgs's TextureGaussian3D against the
port's, through ``from_jax_state`` on a JAX-built ``state_dict()``.

The JAX model renders with cfg ``backend: fused`` (the Pallas blend +
M-list kernel, in interpret mode on the CPU) and ``tex_backend: xla`` (the
exact texture term the port's kernel B computes).  Its Gaussians sit in a
capacity-padded buffer with dead slots, which ``from_jax_state`` slices
off.  Tolerances are those of tests/test_uvtex_raster.py:187-197 through
the same ``assert_close_mostly``; the texture tools (envmap, cube cross,
change_texture) are elementwise and agree to float32 rounding.
"""

import logging
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_rasterizer import assert_close_mostly
from tests.test_torch_uvtex_fused import torch_camera
from tests.test_uvtex_raster import _texture
from texgs.config import Cfg as JCfg
from texgs.config import load_config
from texgs.core.state import init_from_pcd as jax_init_from_pcd
from texgs.data.synthetic import blob_point_cloud
from texgs.data.synthetic import orbit_cameras as jax_orbit_cameras
from texgs.io import checkpoint as jckpt
from texgs.nets.uv_net import apply_uv_net
from texgs.train.texture_gaussian3d import TextureGaussian3D as JaxModel
from texgs_torch.config import Cfg
from texgs_torch.io import checkpoint as tckpt
from texgs_torch.train.texture_gaussian3d import (TextureGaussian3D,
                                                  cfg_from_state,
                                                  from_jax_state)

REPO = Path(__file__).resolve().parent.parent
N_ALIVE, CAPACITY, SIZE = 200, 256, 32
BG = [0.1, 0.2, 0.3]
MODEL_CFG = {
    "uv_net_cfg": {"emb_dim": 16,
                   "pre_mlp_cfg": {"n_hidden_layers": 1, "n_neurons": 16},
                   "mlp_cfg": {"n_hidden_layers": 2, "n_neurons": 16}},
    "inv_uv_net_cfg": {"emb_dim": 16,
                       "pre_mlp_cfg": {"n_hidden_layers": 1, "n_neurons": 16},
                       "mlp_cfg": {"n_hidden_layers": 1, "n_neurons": 16}},
    "tex_cfg": {"resolution": 64, "max_sh_degree": 3},
    "geo_emb_dim": 16,
    "backend": "fused",
    "tex_backend": "xla",
    "uvtex_m": 32,
    "seed": 3,
}


def build_jax_model() -> JaxModel:
    """A JAX stage-3 model with N_ALIVE live Gaussians in a CAPACITY
    buffer, random-but-seeded opacities and residual SH, and a smooth
    texture."""
    model = JaxModel(JCfg(MODEL_CFG), logging.getLogger("texgs-test"),
                     "/nonexistent")
    pcd = blob_point_cloud(N_ALIVE, seed=7)
    state = jax_init_from_pcd(pcd.points, pcd.colors, max_sh_degree=3,
                              capacity=CAPACITY)
    rng = np.random.default_rng(0)
    opacity = np.full((CAPACITY, 1), -20.0, np.float32)
    opacity[:N_ALIVE, 0] = rng.uniform(-1.0, 4.0, size=N_ALIVE)
    model.gauss_params = {
        "xyz": state.xyz, "scaling": state.scaling,
        "rotation": state.rotation, "opacity": jnp.asarray(opacity),
        "shs": jnp.asarray(0.05 * rng.normal(size=(CAPACITY, 15, 3)),
                           jnp.float32)}
    model.n_alive = jnp.asarray(N_ALIVE, jnp.int32)
    model.tex_params = {"texture": _texture()}
    model.active_sh_degree = 3
    model.bind_train_cfg(None, BG)
    model.spatial_lr_scale = 1.0
    model.setup_optim(load_config(REPO / "configs" / "prod_texture.yaml").optim_cfg)
    return model


def port_model(sd) -> TextureGaussian3D:
    model = from_jax_state(sd, Cfg(MODEL_CFG), device="cpu")
    model.bind_train_cfg(None, BG)
    return model


@pytest.fixture(scope="module")
def rendered():
    jmodel = build_jax_model()
    cam = jax_orbit_cameras(1, radius=3.5, width=SIZE, height=SIZE)[0]
    want = jmodel.visual_step(0, 1, cam, None)
    sd = jmodel.state_dict()
    got = port_model(sd).visual_step(0, 1, torch_camera(cam))
    return jmodel, sd, cam, want, got


@pytest.mark.parametrize("key,atol,frac,hard", [
    ("image", 1e-4, 0.995, 3e-2),
    ("image_no_sh", 1e-4, 0.995, 3e-2),
    ("alpha", 3e-5, 0.999, 5e-3),
    ("depth", 1e-4, 0.999, 5e-3),
    ("norm", 3e-5, 0.999, 5e-3),
])
def test_visual_step_matches_jax(rendered, key, atol, frac, hard):
    _, _, _, want, got = rendered
    w, g = np.asarray(want[key]), got[key].numpy()
    assert g.shape == w.shape
    assert np.isfinite(g).all()
    assert_close_mostly(g, w, atol=atol, frac=frac, hard_atol=hard, name=key)


@pytest.mark.parametrize("key", ["envmap", "cubemap"])
def test_texture_views_match_jax(rendered, key):
    _, _, _, want, got = rendered
    np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                               atol=1e-5)


def test_render_is_not_trivial(rendered):
    _, _, _, _, got = rendered
    alpha = got["alpha"].numpy()
    assert 0.05 < alpha.mean() < 0.95
    # the residual SH makes the two images differ where the object is
    assert (got["image"] - got["image_no_sh"]).abs().max().item() > 1e-3


def test_from_jax_state_slices_capacity_and_transposes(rendered):
    jmodel, sd, _, _, _ = rendered
    model = port_model(sd)
    assert model.n_points == N_ALIVE
    xyz = np.asarray(sd["params"]["xyz"])[:N_ALIVE]
    want = apply_uv_net(jmodel.uv_params["uv_net"], jmodel.cfg.uv_net_cfg,
                        jnp.asarray(xyz), jmodel.uv_params["geo_emb"])
    got = model.uv_net(torch.as_tensor(xyz), model.geo_emb).detach()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    np.testing.assert_array_equal(model.texture.numpy(),
                                  np.asarray(sd["params"]["texture"]))
    assert model.active_sh_degree == 3


def test_cfg_from_state_reads_widths(rendered):
    _, sd, _, _, _ = rendered
    cfg = cfg_from_state(sd)
    assert cfg.uv_net_cfg.emb_dim == 16
    assert cfg.uv_net_cfg.mlp_cfg.n_hidden_layers == 2
    assert cfg.tex_cfg.resolution == 64 and cfg.tex_cfg.max_sh_degree == 3
    assert cfg.geo_emb_dim == 16


def test_checkpoint_written_by_jax_loads_in_port(rendered, tmp_path):
    jmodel, sd, cam, _, got = rendered
    path = str(tmp_path / "stage3" / "ckpt")
    jckpt.save(path, sd, iteration=1234)
    loaded, iteration = tckpt.load(path)
    assert iteration == 1234
    again = port_model(loaded).visual_step(0, 1, torch_camera(cam))
    for key in ("image", "image_no_sh", "depth", "norm", "alpha"):
        torch.testing.assert_close(again[key], got[key], rtol=0, atol=0)


def test_checkpoint_written_by_port_loads_in_jax(rendered, tmp_path):
    _, sd, _, _, _ = rendered
    path = str(tmp_path / "ckpt.npz")
    tckpt.save(path, {"params": {k: torch.as_tensor(np.asarray(v))
                                 for k, v in sd["params"].items()},
                      "net_state": sd["net_state"],
                      "hyperparams": sd["hyperparams"]}, iteration=7)
    back, iteration = jckpt.load(path)
    assert iteration == 7
    for k, v in sd["params"].items():
        np.testing.assert_array_equal(back["params"][k], np.asarray(v))
    w_back = back["net_state"]["uv_net"]["mlp"]["w"]
    assert isinstance(w_back, list) and len(w_back) == 3


@pytest.mark.parametrize("mode", [-1, 0, 1, 2, 3])
def test_change_texture_matches_jax(rendered, mode):
    jmodel, sd, _, _, _ = rendered
    res = MODEL_CFG["tex_cfg"]["resolution"]
    cross = np.random.default_rng(mode + 10).uniform(
        0.05, 1.0, size=(3 * res, 4 * res, 3)).astype(np.float32)
    cross[: res // 2, : res // 2] = 0.0      # a masked-out corner for mode 3
    original = jmodel.tex_params
    try:
        jmodel.change_texture(cross, mode)
        want = np.asarray(jmodel.tex_params["texture"])
    finally:
        jmodel.tex_params = original
    model = port_model(sd)
    model.change_texture(cross, mode)
    np.testing.assert_allclose(model.texture.numpy(), want, rtol=1e-5,
                               atol=1e-5)


def test_stage3_guard_rejects_hash_grid_uv_net():
    cfg = Cfg(MODEL_CFG)
    cfg.uv_net_cfg.pre_mlp_cfg.hash_grid_cfg = {"n_levels": 2}
    with pytest.raises(ValueError, match="MLP-only"):
        TextureGaussian3D(cfg, device="cpu")
