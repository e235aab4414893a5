"""The dense oracle and ``cov3d_precomp``: the port's
``rasterize_reference`` and ``rasterize_uvtex_reference`` against texgs's,
outputs and input gradients, on the well-conditioned scenes of
tests/test_pallas_raster.py and tests/test_torch_uvtex_grads.py, at the
tolerances those tests use (forward atol 3e-5, gradients atol 5e-4 / rtol
1e-3; the stage-3 gradients atol 2e-3 of the leaf's max |grad|).  Also
the port's oracle against its own tiled path at tests/test_rasterizer.py's
tolerances, the oracle taken in Gaussian chunks against one block,
``render(cov3d_precomp=...)`` in both shapes against the built
covariances, and the port's stage-2 render at ``backend: reference``
against texgs's CPU stage-2 render (its dense oracle) directly.
"""

import logging
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_rasterizer import assert_close_mostly
from tests.test_torch_raster import jax_project, scene, torch_project
from tests.test_torch_uvtex_grads import NAMES, jax_grads, port_grads
from tests.test_torch_uvtex_fused import scene as uvtex_scene
from tests.test_torch_uvtex_fused import torch_camera
from texgs.kernels.reference import rasterize_reference as jax_reference
from texgs_torch.kernels import reference as tref
from texgs_torch.kernels import tile_raster
from texgs_torch.render.render import render
from texgs_torch.utils.transforms import build_covariance_packed
from tests.torch_threads import one_thread  # noqa: F401

KEYS = ("xyz", "scaling", "rotation", "opacity", "features_dc",
        "features_rest")
OUTPUTS = ("image", "alpha", "depth", "norm")


def extra_of(n, seed=9):
    return np.random.default_rng(seed).uniform(size=(n, 2)).astype(np.float32)


@pytest.mark.parametrize("bg", [(0.0, 0.0, 0.0), (0.2, 0.5, 1.0)])
@pytest.mark.parametrize("with_extra", [False, True])
def test_rasterize_reference_matches_jax(bg, with_extra):
    leaves, cam = scene()
    extra = extra_of(leaves["xyz"].shape[0]) if with_extra else None
    want = jax_reference(
        jax_project({k: jnp.asarray(v) for k, v in leaves.items()}, cam),
        cam.height, cam.width, jnp.asarray(bg),
        extra_attrs=None if extra is None else jnp.asarray(extra))
    got = tref.rasterize_reference(
        torch_project({k: torch.as_tensor(v) for k, v in leaves.items()}, cam),
        cam.height, cam.width, torch.as_tensor(bg),
        extra_attrs=None if extra is None else torch.as_tensor(extra))
    names = OUTPUTS + (("extra",) if with_extra else ())
    for name in names:
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)), atol=3e-5,
                                   err_msg=name)
    assert got.alpha.max() > 0.9


def test_rasterize_reference_grads_match_jax():
    leaves, cam = scene()
    target = np.random.default_rng(4).uniform(
        size=(3, cam.height, cam.width)).astype(np.float32)

    def jax_loss(*args):
        out = jax_reference(jax_project(dict(zip(KEYS, args)), cam),
                            cam.height, cam.width, jnp.zeros(3))
        return (jnp.abs(out.image - target).mean() + 0.1 * out.alpha.mean()
                + 0.01 * out.depth.mean() + 0.01 * out.norm.mean())

    want = jax.grad(jax_loss, argnums=tuple(range(len(KEYS))))(
        *[jnp.asarray(leaves[k]) for k in KEYS])
    params = {k: torch.tensor(leaves[k], requires_grad=True) for k in KEYS}
    out = tref.rasterize_reference(torch_project(params, cam), cam.height,
                                   cam.width, torch.zeros(3))
    loss = ((out.image - torch.as_tensor(target)).abs().mean()
            + 0.1 * out.alpha.mean() + 0.01 * out.depth.mean()
            + 0.01 * out.norm.mean())
    loss.backward()
    for k, w in zip(KEYS, want):
        g = params[k].grad.numpy()
        assert np.abs(g).max() > 0, k
        np.testing.assert_allclose(g, np.asarray(w), atol=5e-4, rtol=1e-3,
                                   err_msg=f"grad mismatch: {k}")


def test_reference_matches_tiled():
    """The oracle against the port's tiled path (kernel 1's plain version
    here), at tests/test_rasterizer.py:89-93's tolerances."""
    leaves, cam = scene(n=512, size=64, seed=0)
    proj = torch_project({k: torch.as_tensor(v) for k, v in leaves.items()},
                         cam)
    ref = tref.rasterize_reference(proj, cam.height, cam.width, torch.zeros(3))
    tiled = tile_raster.rasterize_tiled(proj, cam.height, cam.width,
                                        torch.zeros(3))
    for name, atol, hard in (("image", 2e-5, 5e-3), ("alpha", 2e-5, 5e-3),
                             ("depth", 2e-4, 2e-2), ("norm", 2e-5, 5e-3)):
        assert_close_mostly(getattr(tiled, name).numpy(),
                            getattr(ref, name).numpy(), atol=atol,
                            hard_atol=hard, name=name)


def test_reference_in_gaussian_chunks():
    """Chunks of 7 Gaussians (the transmittance and the stop carried from
    chunk to chunk) give the one-block image to float32 rounding."""
    leaves, cam = scene()
    proj = torch_project({k: torch.as_tensor(v) for k, v in leaves.items()},
                         cam)
    order = tref.depth_sorted_visible(proj)
    channels = torch.cat([proj.colors, proj.depths[:, None], proj.normals],
                         dim=1)[order]
    whole = tref.dense_blend(proj, order, cam.height, cam.width, channels)
    chunked = tref.dense_blend(proj, order, cam.height, cam.width, channels,
                               block=7 * 16 * cam.width)
    for a, b in zip(chunked, whole):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=2e-6)


def test_reference_of_an_empty_scene_is_background():
    leaves, cam = scene()
    params = {k: torch.as_tensor(v) for k, v in leaves.items()}
    params["xyz"] = params["xyz"] + torch.tensor([0.0, 0.0, 100.0])
    out = tref.rasterize_reference(torch_project(params, cam), cam.height,
                                   cam.width, torch.tensor([1.0, 0.5, 0.0]))
    np.testing.assert_allclose(out.image.numpy()[:, 3, 5], [1.0, 0.5, 0.0])
    assert out.alpha.abs().max() == 0


@pytest.mark.parametrize("backend", ["auto", "reference"])
@pytest.mark.parametrize("packed", [True, False], ids=["N6", "N33"])
def test_render_cov3d_precomp(backend, packed):
    """``cov3d_precomp`` of the covariances ``render`` builds itself gives
    the same render bit for bit, packed (N, 6) or full (N, 3, 3)."""
    leaves, cam = scene()
    p = {k: torch.as_tensor(v) for k, v in leaves.items()}
    scaling = torch.exp(p["scaling"])
    rot = p["rotation"] / torch.linalg.norm(p["rotation"], dim=-1,
                                            keepdim=True)
    cov = build_covariance_packed(scaling, rot)
    if not packed:
        xx, xy, xz, yy, yz, zz = cov.unbind(-1)
        cov = torch.stack([torch.stack([xx, xy, xz], -1),
                           torch.stack([xy, yy, yz], -1),
                           torch.stack([xz, yz, zz], -1)], -2)
    args = dict(xyz=p["xyz"], opacity=torch.sigmoid(p["opacity"]),
                scaling=scaling, rotation=rot,
                features=torch.cat([p["features_dc"], p["features_rest"]], 1),
                active_sh_degree=1, bg_color=torch.zeros(3), backend=backend)
    cam_t = torch_camera(cam)
    want = render(cam_t, **args)
    # the precomputed covariance alone sets the footprint: scaling the
    # Gaussians' own scales no longer changes it
    args["scaling"] = scaling * 3.0
    got = render(cam_t, cov3d_precomp=cov, **args)
    for k in ("render", "alpha", "depth"):
        assert torch.equal(got[k], want[k]), k
    assert torch.equal(got["radii"], want["radii"])


def test_render_rejects_an_unknown_backend():
    leaves, cam = scene(n=16)
    p = {k: torch.as_tensor(v) for k, v in leaves.items()}
    with pytest.raises(ValueError):
        render(torch_camera(cam), xyz=p["xyz"], opacity=torch.ones(16, 1),
               scaling=torch.exp(p["scaling"]), rotation=p["rotation"],
               override_color=torch.zeros(16, 3), bg_color=torch.zeros(3),
               backend="dense")


@pytest.mark.parametrize("with_no_sh", [False, True], ids=["F7", "F10"])
def test_uvtex_reference_grads_match_jax(with_no_sh):
    """texgs's and the port's ``rasterize_uvtex`` at ``backend="reference"``
    through the same loss as tests/test_torch_uvtex_grads.py: every input
    gradient at atol 2e-3 of the leaf's max |grad|."""
    sc = uvtex_scene(n=192, size=32, opacity=2.0)
    want = jax_grads(sc, "reference", with_no_sh, m=32)
    got = port_grads(sc, with_no_sh, m=32, backend="reference")
    for name, a, b in zip(NAMES, want, got):
        a, b = np.asarray(a), b.numpy()
        assert np.isfinite(b).all(), name
        denom = np.abs(a).max() + 1e-8
        np.testing.assert_allclose(b / denom, a / denom, atol=2e-3,
                                   err_msg=f"grad mismatch: {name}")
    assert np.abs(got[5].numpy()).max() > 0, "the texture must get gradient"


def uvtex_outputs(sc, backend, m=96):
    """texgs's (backend "reference") or the port's rasterize_uvtex on the
    uvtex scene, with the no-SH image."""
    from texgs.kernels import project as jproj
    from texgs.kernels import uvtex_raster as juv
    from texgs_torch.kernels import project as tproj
    from texgs_torch.kernels import uvtex_raster as tuv

    cam, bg = sc["cam"], np.array([0.3, 0.2, 0.1], np.float32)
    if backend == "texgs":
        j = {k: jnp.asarray(sc[k]) for k in ("xyz", "scaling", "rotation",
                                             "opacity", "uvs", "jac", "shs",
                                             "texture")}
        proj = jproj.project_gaussians(
            j["xyz"], j["scaling"], j["rotation"], j["opacity"],
            jnp.zeros_like(j["xyz"]), cam.world_view, cam.full_proj,
            cam.camera_center, cam.width, cam.height, cam.tanfovx,
            cam.tanfovy)
        out = juv.rasterize_uvtex(proj, j["scaling"], j["rotation"], j["xyz"],
                                  j["uvs"], j["jac"], j["texture"], j["shs"],
                                  2, cam, jnp.asarray(bg),
                                  backend="reference", with_no_sh=True)
        return {k: np.asarray(getattr(out, k)) for k in OUTPUTS
                + ("image_no_sh",)}
    t = {k: torch.as_tensor(sc[k]) for k in ("xyz", "scaling", "rotation",
                                             "opacity", "uvs", "jac", "shs",
                                             "texture")}
    tcam = torch_camera(cam)
    a = torch.as_tensor
    proj = tproj.project_gaussians(
        t["xyz"], t["scaling"], t["rotation"], t["opacity"],
        torch.zeros_like(t["xyz"]), a(tcam.world_view), a(tcam.full_proj),
        a(tcam.camera_center), cam.width, cam.height, cam.tanfovx,
        cam.tanfovy)
    out = tuv.rasterize_uvtex(proj, t["scaling"], t["rotation"], t["xyz"],
                              t["uvs"], t["jac"], t["texture"], t["shs"], 2,
                              tcam, a(bg), m=m, with_no_sh=True,
                              backend=backend)
    return {k: getattr(out, k).numpy() for k in OUTPUTS + ("image_no_sh",)}


def test_uvtex_reference_matches_jax():
    sc = uvtex_scene(n=256, size=32, opacity=2.0)
    want = uvtex_outputs(sc, "texgs")
    got = uvtex_outputs(sc, "reference")
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=3e-5, err_msg=k)
    assert got["alpha"].max() > 0.5


def test_uvtex_reference_matches_fused_path():
    """The oracle against the port's fused path with m above the scene's
    contributor count, at tests/test_uvtex_raster.py's scan-vs-oracle
    tolerances."""
    sc = uvtex_scene(n=256, size=32, opacity=2.0)
    ref = uvtex_outputs(sc, "reference")
    fused = uvtex_outputs(sc, "auto", m=96)
    assert_close_mostly(fused["image"], ref["image"], atol=1e-4, frac=0.995,
                        hard_atol=3e-2, name="image")
    for k in ("alpha", "norm"):
        assert_close_mostly(fused[k], ref[k], atol=2e-5, name=k)


def test_stage2_render_matches_texgs():
    """The port's stage-2 frozen render at ``model_cfg.backend:
    reference`` against texgs's CPU stage-2 render (``backend="auto"``: its
    dense oracle for N <= 4096), at the forward tolerance."""
    from tests.test_torch_train_stage2 import OPTIM_CFG, camera, cfg_with
    from texgs.config import Cfg as JCfg
    from texgs.core.state import init_from_pcd as jax_init_from_pcd
    from texgs.data.synthetic import blob_point_cloud
    from texgs.io import checkpoint as jckpt
    from texgs.train.uv_map_gaussian3d import UVMapGaussian3D as JaxModel
    from texgs_torch.config import Cfg
    from texgs_torch.train.uv_map_gaussian3d import from_jax_state

    with tempfile.TemporaryDirectory() as d:
        n = 400
        pcd = blob_point_cloud(n, seed=2)
        st = jax_init_from_pcd(pcd.points, pcd.colors, max_sh_degree=0,
                               capacity=n + 24)
        st = st.replace(opacity=st.opacity.at[:n].set(3.0))
        params = {k: np.asarray(v) for k, v in st.params_dict().items()}
        jckpt.save(f"{d}/ckpt", {"params": {**params, "n_alive": np.asarray(
            n, np.int32)}})
        np.save(f"{d}/pcd.npy", pcd.points[::2])
        cfg = cfg_with((f"{d}/ckpt", f"{d}/pcd.npy"))
        jmodel = JaxModel(JCfg(cfg), logging.getLogger("texgs-test"), "/x")
        jmodel.initialize(None, None)
        jmodel.bind_train_cfg(JCfg({}), [0, 0, 0])
        jmodel.setup_optim(JCfg(OPTIM_CFG))
        model = from_jax_state(jmodel.state_dict(),
                               Cfg(dict(cfg, backend="reference")),
                               device="cpu")
        model.bind_train_cfg(Cfg({}), [0, 0, 0])
        jcam, tcam = camera()
        want = jmodel.depth_alpha(jcam)
        got = model.depth_alpha(tcam)
    for name, w, g in zip(("depth", "alpha", "norm", "render"), want, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=3e-5,
                                   err_msg=name)
    assert got[1].max() > 0.9
