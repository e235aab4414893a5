"""The port's stage-1/2 ``render`` against texgs's ``render(backend="scan")``
(and the synthetic scene built on it against texgs's).

Both packages get the same numpy-seeded Gaussians: SH degrees 0-3,
``override_color``, ``scaling_modifier`` and ``normalize_depth``, and the
gradient of the NDC offset that densification reads.  Tolerances: the
forward at tests/test_pallas_raster.py's 3e-5, through
``assert_close_mostly`` as tests/test_torch_uvtex_fused.py holds kernel A's
blend: the two packages round the exponent differently in the last ulp, so
0.5% of the pixels may flip across the alpha = 1/255 or T = 1e-4
thresholds, by at most 1e-3; depth, whose values are ~4, at
tests/test_rasterizer.py's depth tolerance (2e-4, at most 2e-2); gradients
at 5e-4 / 1e-3.
The synthetic scene's ground truth comes from texgs's dense oracle and the
port's tiled render, so it is held at tests/test_rasterizer.py's
tiled-vs-oracle tolerance (99.9% of pixels within 2e-5, none beyond 5e-3),
and a few alpha-mask pixels may flip at 0.5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_rasterizer import assert_close_mostly
from tests.test_torch_uvtex_fused import torch_camera
from texgs.data.synthetic import blob_point_cloud
from texgs.data.synthetic import orbit_cameras as jax_orbit_cameras
from texgs.render.render import render as jax_render
from texgs_torch.render.render import render
from tests.torch_threads import one_thread  # noqa: F401

N, SIZE = 320, 40
BG = np.array([0.2, 0.1, 0.3], np.float32)


def gaussians(sh_degree=3, seed=4):
    """Activated numpy Gaussians on a blob with random SH."""
    pcd = blob_point_cloud(N, seed=seed)
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(N, 4)).astype(np.float32)
    k = (sh_degree + 1) ** 2
    feats = 0.2 * rng.normal(size=(N, k, 3))
    feats[:, 0] = (pcd.colors - 0.5) / 0.28209479177387814
    return dict(
        xyz=pcd.points,
        opacity=rng.uniform(0.2, 0.95, size=(N, 1)).astype(np.float32),
        scaling=np.exp(rng.uniform(-3.6, -2.6, size=(N, 3))).astype(np.float32),
        rotation=q / np.linalg.norm(q, axis=-1, keepdims=True),
        features=feats.astype(np.float32))


def both(cam, g, **kw):
    """(texgs's output, the port's output) on the same inputs."""
    jkw = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
           for k, v in kw.items()}
    tkw = {k: (torch.as_tensor(v) if isinstance(v, np.ndarray) else v)
           for k, v in kw.items()}
    want = jax_render(cam, **{k: jnp.asarray(v) for k, v in g.items()},
                      bg_color=jnp.asarray(BG), backend="scan", **jkw)
    got = render(torch_camera(cam), **{k: torch.as_tensor(v)
                                       for k, v in g.items()},
                 bg_color=torch.as_tensor(BG), **tkw)
    return want, got


def assert_outputs_close(want, got):
    for k, atol, hard in (("render", 3e-5, 1e-3), ("depth", 2e-4, 2e-2),
                          ("norm", 3e-5, 1e-3), ("alpha", 3e-5, 1e-3)):
        assert_close_mostly(got[k].detach().numpy(), np.asarray(want[k]),
                            atol=atol, frac=0.995, hard_atol=hard, name=k)
    np.testing.assert_array_equal(got["radii"].numpy(), np.asarray(want["radii"]))
    assert int(got["n_pairs"]) == int(want["n_pairs"]) > 0


@pytest.mark.parametrize("deg", [0, 1, 2, 3])
def test_render_matches_texgs_sh_degrees(deg):
    cam = jax_orbit_cameras(3, radius=3.5, width=SIZE, height=SIZE)[deg % 3]
    want, got = both(cam, gaussians(), active_sh_degree=deg)
    assert_outputs_close(want, got)


@pytest.mark.parametrize("case", ["override_color", "scaling_modifier",
                                  "raw_depth"])
def test_render_options_match_texgs(case):
    cam = jax_orbit_cameras(1, radius=3.5, width=SIZE, height=SIZE)[0]
    g = gaussians()
    kw = {"active_sh_degree": 1}
    if case == "override_color":
        g.pop("features")
        kw = {"override_color": np.random.default_rng(1).uniform(
            size=(N, 3)).astype(np.float32)}
    elif case == "scaling_modifier":
        kw["scaling_modifier"] = 0.7
    else:
        kw["normalize_depth"] = False
    want, got = both(cam, g, **kw)
    assert_outputs_close(want, got)


def test_ndc_offset_and_input_gradients_match_texgs():
    """The NDC-offset gradient (texgs's NDC units, which densification
    thresholds) and every Gaussian input's gradient."""
    cam = jax_orbit_cameras(1, radius=3.5, width=SIZE, height=SIZE)[0]
    g = gaussians(sh_degree=2)
    target = np.random.default_rng(2).uniform(size=(3, SIZE, SIZE)).astype(
        np.float32)
    names = ["xyz", "opacity", "scaling", "rotation", "features"]

    def jloss(ndc, *args):
        out = jax_render(cam, **dict(zip(names, args)), active_sh_degree=2,
                         bg_color=jnp.asarray(BG), ndc_offset=ndc,
                         backend="scan")
        return (jnp.abs(out["render"] - target).mean() + out["alpha"].mean()
                + 0.01 * out["depth"].mean() + 0.01 * out["norm"].mean())

    want = jax.grad(jloss, argnums=tuple(range(6)))(
        jnp.zeros((N, 2)), *(jnp.asarray(g[k]) for k in names))
    t = {k: torch.as_tensor(g[k]).requires_grad_(True) for k in names}
    ndc = torch.zeros((N, 2), requires_grad=True)
    out = render(torch_camera(cam), **t, active_sh_degree=2,
                 bg_color=torch.as_tensor(BG), ndc_offset=ndc)
    loss = ((out["render"] - torch.as_tensor(target)).abs().mean()
            + out["alpha"].mean() + 0.01 * out["depth"].mean()
            + 0.01 * out["norm"].mean())
    got = torch.autograd.grad(loss, [ndc] + [t[k] for k in names])
    for name, a, b in zip(["ndc_offset"] + names, got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=5e-4,
                                   rtol=1e-3, err_msg=name)
    assert float(got[0].abs().max()) > 1e-4


def test_synthetic_scene_matches_texgs():
    """make_synthetic_scene_info: same cameras, extent and init cloud;
    ground truth at the tiled-vs-oracle tolerance."""
    from texgs.config import Cfg as JCfg
    from texgs.data.synthetic_scene import make_synthetic_scene_info as jmake
    from texgs_torch.config import Cfg
    from texgs_torch.data.synthetic_scene import make_synthetic_scene_info

    uri = "synthetic://blob?n=384&views=8&size=32"
    want = jmake(uri, JCfg({"background": [0, 0, 0]}))
    got = make_synthetic_scene_info(uri, Cfg({"background": [0, 0, 0]}),
                                    device="cpu")
    assert want.nerf_normalization["radius"] == pytest.approx(
        got.nerf_normalization["radius"], rel=1e-6)
    np.testing.assert_array_equal(got.point_cloud.points,
                                  want.point_cloud.points)
    assert len(got.train_cameras) == len(want.train_cameras) == 7
    for a, b in zip(got.train_cameras + got.test_cameras,
                    want.train_cameras + want.test_cameras):
        assert a.image_name == b.image_name
        np.testing.assert_allclose(a.R, b.R, atol=1e-6)
        np.testing.assert_allclose(a.T, b.T, atol=1e-6)
        assert_close_mostly(a.image, b.image, atol=2e-5, name="image")
        assert_close_mostly(a.normal, b.normal, atol=2e-5, name="normal")
        assert (a.alpha != b.alpha).mean() <= 0.005
