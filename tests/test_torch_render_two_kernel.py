"""The two-kernel stage-3 path of the port (``backend: pallas``: kernel 1's
blend, kernel 2's M-lists, kernel B's texture term) against texgs.

* ``rasterize_uvtex(backend="pallas")`` against texgs's ``backend="pallas"``
  (its Pallas kernels in interpret mode on the CPU) and ``"scan"`` (their
  XLA twins), for F = 7 and F = 10 blend channels, with the exact texture
  term (``tex_backend="xla"``: on the CPU texgs would resolve ``auto`` to
  its windowed textile term).  Tolerances: tests/test_uvtex_raster.py's,
  through the same ``assert_close_mostly``.
* The port's two paths against each other: the same function, so the
  images agree exactly and the gradients to float32 rounding.
* texgs's TextureGaussian3D with ``backend: pallas`` against the port's:
  ``visual_step`` at the tolerances of tests/test_torch_render_stage3.py,
  and one training step at those of tests/test_torch_train_stage3.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests.test_torch_render_stage3 as render3
import tests.test_torch_train_stage3 as train3
from tests.test_rasterizer import assert_close_mostly
from tests.test_torch_uvtex_fused import jax_project, scene, torch_camera
from tests.test_torch_uvtex_grads import port_grads
from texgs.config import Cfg as JCfg
from texgs.data.synthetic import orbit_cameras as jax_orbit_cameras
from texgs.kernels import uvtex_raster as juv
from texgs_torch.config import Cfg
from texgs_torch.kernels import uvtex_raster as tuv
from texgs_torch.kernels.project import project_gaussians
from texgs_torch.kernels.uvtex_fused import fused_pairs
from texgs_torch.train.optim import flatten_tree
from texgs_torch.train.texture_gaussian3d import from_jax_state
from tests.torch_threads import one_thread  # noqa: F401

BG = np.array([0.3, 0.2, 0.1], np.float32)
KEYS = ("xyz", "scaling", "rotation", "uvs", "jac", "texture", "shs")


def _t(a):
    return torch.as_tensor(np.array(a))


def port_render(sc, backend, with_no_sh, m=32):
    cam = sc["cam"]
    xyz, scaling, rotation, uvs, jac, tex, shs = (sc[k] for k in KEYS)
    proj = project_gaussians(
        _t(xyz), _t(scaling), _t(rotation), _t(sc["opacity"]),
        torch.zeros(xyz.shape), _t(cam.world_view), _t(cam.full_proj),
        _t(cam.camera_center), cam.width, cam.height, cam.tanfovx,
        cam.tanfovy)
    return tuv.rasterize_uvtex(
        proj, _t(scaling), _t(rotation), _t(xyz), _t(uvs), _t(jac), _t(tex),
        _t(shs), 2, torch_camera(cam), _t(BG), m=m, with_no_sh=with_no_sh,
        backend=backend)


@pytest.mark.parametrize("jax_backend", ["pallas", "scan"])
@pytest.mark.parametrize("with_no_sh", [False, True], ids=["F7", "F10"])
def test_rasterize_uvtex_matches_jax(jax_backend, with_no_sh):
    sc = scene(n=192, size=32, opacity=2.0)
    cam = sc["cam"]
    xyz, scaling, rotation, uvs, jac, tex, shs = (jnp.asarray(sc[k])
                                                  for k in KEYS)
    want = juv.rasterize_uvtex(
        jax_project(sc), scaling, rotation, xyz, uvs, jac, tex, shs, 2, cam,
        jnp.asarray(BG), backend=jax_backend, chunk=64, m=32,
        tex_backend="xla", with_no_sh=with_no_sh)
    before = fused_pairs.launches
    got = port_render(sc, "pallas", with_no_sh)
    assert fused_pairs.launches == before
    checks = [("image", 1e-4, 0.995, 3e-2), ("alpha", 3e-5, 0.999, 5e-3),
              ("depth", 1e-4, 0.999, 5e-3), ("norm", 3e-5, 0.999, 5e-3)]
    if with_no_sh:
        checks.append(("image_no_sh", 1e-4, 0.995, 3e-2))
    for name, atol, frac, hard in checks:
        assert_close_mostly(getattr(got, name).numpy(),
                            np.asarray(getattr(want, name)), atol=atol,
                            frac=frac, hard_atol=hard, name=name)
    assert int(got.n_pairs) == int(want.n_pairs)


@pytest.mark.parametrize("with_no_sh", [False, True], ids=["F7", "F10"])
def test_two_kernel_path_matches_fused_path(with_no_sh):
    """Kernels 1 + 2 compute what kernel A computes: on the CPU their plain
    versions give the same images bit for bit and the same gradients to
    float32 rounding: the blend's backward sums in another order, and where
    a Gaussian's terms cancel that moves its gradient by ~1e-5 of the max."""
    sc = scene(n=192, size=32, opacity=2.0)
    fused = port_render(sc, "fused", with_no_sh)
    two = port_render(sc, "pallas", with_no_sh)
    for name in ("image", "image_no_sh", "depth", "norm", "alpha"):
        a, b = getattr(fused, name), getattr(two, name)
        if a is not None or b is not None:
            torch.testing.assert_close(b, a, rtol=0, atol=0)
    got = port_grads(sc, with_no_sh, 32, backend="pallas")
    want = port_grads(sc, with_no_sh, 32, backend="fused")
    for a, b in zip(want, got):
        denom = a.abs().max() + 1e-12
        torch.testing.assert_close(b / denom, a / denom, rtol=0, atol=1e-4)


def test_resolve_backends():
    assert tuv.resolve_backends() == "fused"
    assert tuv.resolve_backends("fused", "textile") == "fused"
    assert tuv.resolve_backends("pallas", "auto") == "two_kernel"
    assert tuv.resolve_backends("scan", "xla") == "two_kernel"
    assert tuv.resolve_backends("reference") == "reference"
    with pytest.raises(ValueError):
        tuv.resolve_backends("triton")
    with pytest.raises(ValueError):
        tuv.resolve_backends("auto", "mip")


@pytest.fixture(scope="module")
def rendered():
    cfg = dict(render3.MODEL_CFG, backend="pallas", tex_backend="xla")
    jmodel = render3.build_jax_model()
    jmodel.cfg = JCfg(cfg)
    cam = jax_orbit_cameras(1, radius=3.5, width=render3.SIZE,
                            height=render3.SIZE)[0]
    want = jmodel.visual_step(0, 1, cam, None)
    model = from_jax_state(jmodel.state_dict(), Cfg(cfg), device="cpu")
    model.bind_train_cfg(None, render3.BG)
    before = fused_pairs.launches
    got = model.visual_step(0, 1, torch_camera(cam))
    assert fused_pairs.launches == before
    return want, got


@pytest.mark.parametrize("key,atol,frac,hard", [
    ("image", 1e-4, 0.995, 3e-2),
    ("image_no_sh", 1e-4, 0.995, 3e-2),
    ("alpha", 3e-5, 0.999, 5e-3),
    ("depth", 1e-4, 0.999, 5e-3),
    ("norm", 3e-5, 0.999, 5e-3),
])
def test_visual_step_matches_jax(rendered, key, atol, frac, hard):
    want, got = rendered
    w, g = np.asarray(want[key]), got[key].numpy()
    assert g.shape == w.shape and np.isfinite(g).all()
    assert_close_mostly(g, w, atol=atol, frac=frac, hard_atol=hard, name=key)


def test_train_step_matches_jax():
    """One step of every loss term with ``backend: pallas``: the total loss
    at rtol 1e-4 and every leaf's gradient (from the step's Adam moments,
    mu = 0.1 g) at atol 2e-3 of its max |grad|."""
    cfg = dict(train3.MODEL_CFG, backend="pallas", tex_backend="xla")
    jmodel = train3.build_jax_model()
    jmodel.cfg = JCfg(cfg)
    jcam, tcam = train3.cameras(jmodel)
    model = from_jax_state(jmodel.state_dict(), Cfg(cfg), device="cpu",
                           optim_cfg=Cfg(train3.OPTIM_CFG))
    model.bind_train_cfg(Cfg(train3.TRAIN_CFG), train3.BG)
    it = train3.ITERS[0]
    jmodel.compute_loss(it, 10000, jcam, None, JCfg(train3.LOSS_CFG))
    jloss = float(jmodel.flush()["total_loss"])
    with train3.one_thread():
        tloss = float(model.compute_loss(it, 10000, tcam, None,
                                         Cfg(train3.LOSS_CFG))[0])
    np.testing.assert_allclose(tloss, jloss, rtol=1e-4)
    want, got = (
        {k: np.asarray(v, np.float32) / 0.1
         for k, v in flatten_tree(sd["optim_state"]).items()
         if ".mu." in f".{k}."}
        for sd in (jmodel.state_dict(), model.state_dict()))
    assert set(got) == set(want)
    for k in sorted(want):
        denom = np.abs(want[k]).max() + 1e-8
        np.testing.assert_allclose(got[k] / denom, want[k] / denom, atol=2e-3,
                                   err_msg=f"grad mismatch: {k}")
