"""Module parity of texgs_torch against texgs, one module at a time.

Inputs come from numpy seeds (or texgs's own deterministic synthetic
scenes) and go through both packages on the CPU.  Integer outputs
(radii, pair lists, cube faces) must be equal; float outputs agree to
float32 rounding of the same formulas (stated per test).
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_uvtex_fused import jax_project, scene, to_torch_proj
from texgs.config import Cfg as JCfg
from texgs.config import load_config as jax_load_config
from texgs.core import camera as jcam
from texgs.core.state import init_from_pcd as jax_init_from_pcd
from texgs.data import synthetic as jsyn
from texgs.io import checkpoint as jckpt
from texgs.kernels import binning as jbin
from texgs.kernels import knn as jknn
from texgs.kernels import tile_raster as jtr
from texgs.kernels import uvtex_raster as juv
from texgs.nets import uv_net as juvnet
from texgs.utils import sh as jsh
from texgs_torch.config import Cfg, load_config
from texgs_torch.core import camera as tcam
from texgs_torch.core.state import init_from_pcd
from texgs_torch.data import synthetic as tsyn
from texgs_torch.io import checkpoint as tckpt
from texgs_torch.kernels import binning as tbin
from texgs_torch.kernels import knn as tknn
from texgs_torch.kernels import project as tproj_k
from texgs_torch.kernels import tile_raster as ttr
from texgs_torch.kernels import uvtex_raster as tuv
from texgs_torch.nets.uv_net import UVNet
from texgs_torch.utils import sh as tsh
from tests.torch_threads import one_thread  # noqa: F401

REPO = Path(__file__).resolve().parent.parent


def t(a):
    return torch.as_tensor(np.array(a))


# ------------------------------------------------------------- config


def test_cfg_missing_keys_are_falsy_and_not_inserted():
    cfg = Cfg({"a": {"b": 1}, "lst": [{"c": 2}]})
    assert not cfg.missing and not cfg["missing"] and not cfg.a.nope
    assert "missing" not in cfg
    assert cfg.a.b == 1 and cfg.lst[0].c == 2
    assert cfg.get_or("missing", 5) == 5 and cfg.get_or("a", None) == {"b": 1}


def test_load_config_matches_jax():
    path = REPO / "configs" / "prod_texture.yaml"
    assert load_config(path).to_dict() == jax_load_config(path).to_dict()


def test_chip_smoke_model_cfg_is_prod_texture():
    """chip_smoke.py carries configs/prod_texture.yaml's model_cfg inline
    (the GPU machine may lack PyYAML); it must not drift."""
    import chip_smoke

    want = jax_load_config(REPO / "configs" / "prod_texture.yaml").model_cfg
    want = {k: v for k, v in want.to_dict().items()
            if k not in ("init_from", "init_uv_map_from")}
    assert chip_smoke.MODEL_CFG == want


# ------------------------------------------------- cameras and scenes


def test_orbit_cameras_match_jax():
    for kw in ({}, {"spiral": True, "n_cams": 5, "width": 80, "height": 60}):
        for a, b in zip(jsyn.orbit_cameras(**kw), tsyn.orbit_cameras(**kw)):
            for f in ("world_view", "full_proj", "camera_center"):
                np.testing.assert_array_equal(getattr(b, f),
                                              np.asarray(getattr(a, f)))
            assert (a.width, a.height, a.fovx, a.fovy) == (
                b.width, b.height, b.fovx, b.fovy)
            assert a.tanfovx == b.tanfovx


def test_textured_sphere_matches_jax():
    a = jsyn.textured_sphere_point_cloud(500, seed=4)
    b = tsyn.textured_sphere_point_cloud(500, seed=4)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def test_knn_and_init_from_pcd_match_jax():
    pcd = jsyn.blob_point_cloud(700, seed=2)
    want = np.asarray(jknn.mean_sq_dist_3nn(jnp.asarray(pcd.points)))
    got = tknn.mean_sq_dist_3nn(t(pcd.points), block_size=256).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-9)
    js = jax_init_from_pcd(pcd.points, pcd.colors, max_sh_degree=2)
    ts = init_from_pcd(pcd.points, pcd.colors, 2, device="cpu")
    np.testing.assert_allclose(ts.scaling.numpy(), np.asarray(js.scaling),
                               rtol=1e-4, atol=1e-5)
    for f in ("xyz", "features_dc", "features_rest", "rotation", "opacity"):
        np.testing.assert_allclose(getattr(ts, f).numpy(),
                                   np.asarray(getattr(js, f)), atol=1e-6)


# ------------------------------------------------------ SH and tables


@pytest.mark.parametrize("deg", [0, 1, 2, 3, 4])
def test_eval_sh_matches_jax(deg):
    rng = np.random.default_rng(deg)
    sh = rng.normal(size=(50, 3, 25)).astype(np.float32)
    d = rng.normal(size=(50, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    want = jsh.eval_sh(deg, jnp.asarray(sh), jnp.asarray(d))
    got = tsh.eval_sh(deg, t(sh), t(d))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_uvtex_tables_and_intersections_match_jax():
    sc = scene(n=128)
    cam = sc["cam"]
    args = [sc[k] for k in ("xyz", "scaling", "rotation", "uvs", "jac")]
    jt = juv.build_uvtex_tables(*map(jnp.asarray, args), cam.camera_center)
    tt = tuv.build_uvtex_tables(*map(t, args), t(cam.camera_center))
    for a, b in zip(jt, tt):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=2e-5,
                                   atol=1e-5)
    base = juv.residual_sh_colors(jnp.asarray(sc["shs"]),
                                  jnp.asarray(sc["xyz"]), cam.camera_center, 3)
    ours = tuv.residual_sh_colors(t(sc["shs"]), t(sc["xyz"]),
                                  t(cam.camera_center), 3)
    np.testing.assert_allclose(ours.numpy(), np.asarray(base), atol=1e-6)

    rays_j = np.stack([np.asarray(r) for r in juv.ray_constants(cam)])
    from tests.test_torch_uvtex_fused import torch_camera
    rays_t = tuv.ray_constants(torch_camera(cam))
    np.testing.assert_allclose(rays_t, rays_j, rtol=1e-6, atol=1e-7)

    d = np.random.default_rng(1).normal(size=(40, 3)).astype(np.float32)
    want = juv.intersect_uv(jnp.asarray(d), jt)                   # (P, K, 3)
    rows = tuv.build_uv_rows(tt)
    got = tuv.intersect_uv(t(d)[:, None, :], rows[None, :, :])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


# ----------------------------------------------- projection, binning


def test_project_gaussians_matches_jax():
    sc = scene(n=256, size=48)
    cam = sc["cam"]
    want = jax_project(sc)
    got = tproj_k.project_gaussians(
        *(t(sc[k]) for k in ("xyz", "scaling", "rotation", "opacity")),
        torch.zeros(256, 3), t(cam.world_view), t(cam.full_proj),
        t(cam.camera_center), cam.width, cam.height, cam.tanfovx, cam.tanfovy)
    np.testing.assert_allclose(got.means2d.numpy(), np.asarray(want.means2d),
                               atol=2e-4)
    np.testing.assert_allclose(got.depths.numpy(), np.asarray(want.depths),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got.conics.numpy(), np.asarray(want.conics),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(got.radii.numpy(), np.asarray(want.radii))
    np.testing.assert_array_equal(got.opacities.numpy(),
                                  np.asarray(want.opacities))
    np.testing.assert_allclose(got.normals.numpy(), np.asarray(want.normals),
                               atol=1e-6)


def _tile_sequences_jax(pairs, n_tiles):
    ct = np.asarray(pairs.chunk_tile)
    chunk = np.asarray(pairs.pair_gauss).shape[0] // ct.shape[0]
    seqs = {i: [] for i in range(n_tiles)}
    for c, tile in enumerate(ct):
        if tile >= 0:
            g = np.asarray(pairs.pair_gauss)[c * chunk:(c + 1) * chunk]
            v = np.asarray(pairs.pair_valid)[c * chunk:(c + 1) * chunk]
            seqs[int(tile)].extend(g[v].tolist())
    return seqs


@pytest.mark.parametrize("pair_cap", [None, 150], ids=["uncapped", "cap150"])
def test_build_pairs_matches_jax(pair_cap):
    """Same pair set, same (tile, depth-rank) order per tile, same counts;
    with a cap, the same pairs are dropped and both report overflow."""
    sc = scene(n=256, size=48, opacity=2.0)
    cam = sc["cam"]
    proj = jax_project(sc)
    # ties in depth break by index in both packages
    depths = np.asarray(proj.depths).copy()
    depths[10:20] = depths[10]
    proj = proj._replace(depths=jnp.asarray(depths))
    h, w = cam.height, cam.width
    cap = 4 * 256 if pair_cap is None else pair_cap
    jp = jbin.build_pairs(proj.means2d, proj.depths, proj.radii, h, w, cap, 32)
    tp = to_torch_proj(proj)
    ours = tbin.build_pairs(tp.means2d, tp.depths, tp.radii, h, w, pair_cap)
    n_tiles = 9
    want = _tile_sequences_jax(jp, n_tiles)
    for tile in range(n_tiles):
        s, e = int(ours.tile_start[tile]), int(ours.tile_end[tile])
        assert ours.pair_gauss[s:e].tolist() == want[tile], f"tile {tile}"
        assert (ours.pair_tile[s:e] == tile).all()
    assert int(ours.n_pairs) == int(jp.n_pairs)
    assert bool(ours.overflowed) == bool(jp.overflowed) == (pair_cap is not None)
    if pair_cap is None:
        np.testing.assert_array_equal(ours.tile_counts.numpy(),
                                      np.asarray(jp.tile_counts))


def test_build_pairs_empty_scene():
    z = torch.zeros(5)
    pairs = tbin.build_pairs(torch.zeros(5, 2), z, z.to(torch.int32), 32, 48)
    assert pairs.pair_gauss.numel() == 0 and int(pairs.n_pairs) == 0
    assert pairs.tile_counts.shape == (6,) and int(pairs.tile_counts.sum()) == 0


def test_gauss_table_and_image_assembly_match_jax():
    sc = scene(n=128, size=48)
    proj = jax_project(sc)
    extra = np.random.default_rng(2).normal(size=(128, 3)).astype(np.float32)
    want = jtr.build_gauss_table(proj, jnp.asarray(extra))
    got = ttr.build_gauss_table(to_torch_proj(proj), t(extra))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-4)
    rng = np.random.default_rng(3)
    tiles = rng.uniform(size=(9, 256, 10)).astype(np.float32)
    tfin = rng.uniform(size=(9, 256)).astype(np.float32)
    bg = np.array([0.2, 0.3, 0.4], np.float32)
    a = jtr.assemble_image(jnp.asarray(tiles), jnp.asarray(tfin), 40, 44,
                           jnp.asarray(bg), 3)
    b = ttr.assemble_image(t(tiles), t(tfin), 40, 44, t(bg), 3)
    for x, y in zip(a[:5], b[:5]):
        np.testing.assert_allclose(y.numpy(), np.asarray(x), rtol=1e-6)


# ------------------------------------------------------------ UV net


@pytest.mark.parametrize("prescale", [False, True],
                         ids=["plain", "xyz_offset_scale"])
def test_uv_net_with_jac_matches_jax(prescale):
    spec = {"emb_dim": 16,
            "pre_mlp_cfg": {"n_hidden_layers": 1, "n_neurons": 16},
            "mlp_cfg": {"n_hidden_layers": 2, "n_neurons": 16}}
    if prescale:
        spec.update(xyz_offset=[0.1, -0.2, 0.3], xyz_scale=[1.5, 0.7, 2.0])
    params = juvnet.init_uv_net(jax.random.PRNGKey(4), JCfg(spec))
    rng = np.random.default_rng(5)
    geo = (0.3 * rng.normal(size=16)).astype(np.float32)
    xyz = rng.normal(size=(300, 3)).astype(np.float32)
    uvs_j, jac_j = juvnet.apply_uv_net_with_jac(params, JCfg(spec),
                                                jnp.asarray(xyz),
                                                jnp.asarray(geo))
    net = UVNet(Cfg(spec), device="cpu")
    net.load_jax_params(jax.tree.map(np.asarray, params))
    uvs, jac = net.forward_with_jac(t(xyz), t(geo))
    np.testing.assert_allclose(uvs.detach().numpy(), np.asarray(uvs_j),
                               atol=1e-5)
    np.testing.assert_allclose(jac.numpy(), np.asarray(jac_j), rtol=1e-4,
                               atol=1e-4)
    plain = net(t(xyz), t(geo)).detach()
    np.testing.assert_allclose(plain.numpy(), np.asarray(uvs_j), atol=1e-5)
    assert not jac.requires_grad and uvs.requires_grad


def test_uv_net_init_is_seeded():
    spec = Cfg({"emb_dim": 8, "pre_mlp_cfg": {"n_hidden_layers": 1,
                                              "n_neurons": 8},
                "mlp_cfg": {"n_hidden_layers": 1, "n_neurons": 8}})
    a = UVNet(spec, torch.Generator().manual_seed(1), device="cpu")
    b = UVNet(spec, torch.Generator().manual_seed(1), device="cpu")
    for p, q in zip(a.parameters(), b.parameters()):
        torch.testing.assert_close(p, q, rtol=0, atol=0)
    w = a.pre_mlp.layers[0].weight
    assert abs(w.std().item() - np.sqrt(2.0 / 3)) < 0.3


# --------------------------------------------------------- checkpoint


def test_checkpoint_roundtrip_both_ways(tmp_path):
    tree = {"params": {"xyz": np.arange(12, dtype=np.float32).reshape(4, 3),
                       "n_alive": np.asarray(3)},
            "net_state": {"mlp": {"w": [np.ones((2, 3), np.float32),
                                        np.zeros((3, 1), np.float32)],
                                  "b": (np.ones(3), np.ones(1))}},
            "hyperparams": {"active_sh_degree": 2, "rng_key": None}}
    jckpt.save(str(tmp_path / "a"), tree, iteration=5)
    ours, it = tckpt.load(str(tmp_path / "a"))
    assert it == 5 and ours["hyperparams"] == {"active_sh_degree": 2,
                                               "rng_key": None}
    assert isinstance(ours["net_state"]["mlp"]["b"], tuple)
    np.testing.assert_array_equal(ours["params"]["xyz"], tree["params"]["xyz"])
    tckpt.save(str(tmp_path / "b.npz"), ours, iteration=6)
    back, it = jckpt.load(str(tmp_path / "b.npz"))
    assert it == 6
    np.testing.assert_array_equal(back["net_state"]["mlp"]["w"][1],
                                  tree["net_state"]["mlp"]["w"][1])


def test_camera_dataclass_matches_jax_make_camera():
    rng = np.random.default_rng(8)
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    T = rng.normal(size=3)
    a = jcam.make_camera(q, T, 0.9, 0.7, 64, 48)
    b = tcam.make_camera(q, T, 0.9, 0.7, 64, 48)
    for f in ("world_view", "full_proj", "camera_center"):
        np.testing.assert_array_equal(getattr(b, f), np.asarray(getattr(a, f)))
