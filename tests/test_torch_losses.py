"""The port's stage-3 losses and depth2world against texgs's, values and
gradients, on the same numpy inputs.  They are plain tensor code in both
packages, so they agree to float32 rounding (atol 1e-6 on values of order
one, 1e-5 on gradients); world points to 5e-4 (see test_depth2world)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from texgs import losses as jl
from texgs.data.synthetic import orbit_cameras
from texgs.train.uv_map_gaussian3d import depth2world as jax_depth2world
from texgs_torch import losses as tl
from texgs_torch.train.uv_map_gaussian3d import depth2world
from tests.torch_threads import one_thread  # noqa: F401

H, W = 24, 32


def _images(seed=0, c=3):
    rng = np.random.default_rng(seed)
    a = rng.uniform(size=(c, H, W)).astype(np.float32)
    b = np.clip(a + 0.2 * rng.normal(size=a.shape), 0, 1).astype(np.float32)
    return a, b


def _unit(seed):
    n = np.random.default_rng(seed).normal(size=(3, H, W))
    return (n / np.linalg.norm(n, axis=0, keepdims=True)).astype(np.float32)


def _mask(seed=3):
    return (np.random.default_rng(seed).uniform(size=(1, H, W)) > 0.3
            ).astype(np.float32)


def _depth(seed=4):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W]
    # a near tilted plane on the left (its pixels lie < 1e-2 apart, so they
    # pass norm_from_depth's mask), a far one on the right
    d = np.where(xx < W // 2, 0.2 + 0.0005 * xx + 0.0003 * yy,
                 3.0 + 0.01 * xx)
    return (d + 1e-4 * rng.normal(size=(H, W)))[None].astype(np.float32)


def _check(jfn, tfn, args, diff_args, atol=1e-6):
    """Values and the gradients of the arguments in ``diff_args``."""
    want = jfn(*[jnp.asarray(a) for a in args])
    targs = [torch.tensor(a, requires_grad=i in diff_args)
             for i, a in enumerate(args)]
    got = tfn(*targs)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=atol, rtol=1e-5)
    g_want = jax.grad(lambda *xs: jfn(*xs), argnums=tuple(diff_args))(
        *[jnp.asarray(a) for a in args])
    g_got = torch.autograd.grad(got, [targs[i] for i in diff_args])
    for a, b in zip(g_want, g_got):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-5,
                                   rtol=1e-4)


def test_l1_l2():
    a, b = _images()
    _check(jl.l1_loss, tl.l1_loss, (a, b), (0,))
    _check(jl.l2_loss, tl.l2_loss, (a, b), (0,))


def test_ssim():
    a, b = _images(1)
    _check(jl.ssim_loss, tl.ssim_loss, (a, b), (0, 1))


@pytest.mark.parametrize("masked", [False, True])
def test_smooth(masked):
    rgb, _ = _images(2)
    value = _unit(5)
    if masked:
        _check(jl.smooth_loss, tl.smooth_loss, (rgb, value, _mask()), (0, 1))
    else:
        _check(jl.smooth_loss, tl.smooth_loss, (rgb, value), (0, 1))


@pytest.mark.parametrize("masked", [False, True])
def test_norm_loss(masked):
    args = (_unit(6), _unit(7)) + ((_mask(),) if masked else ())
    _check(jl.norm_loss, tl.norm_loss, args, (0, 1))


def test_norm_from_depth_and_norm_reg():
    cam = orbit_cameras(1, radius=3.5, width=W, height=H)[0]
    depth = _depth()
    wv = np.asarray(cam.world_view)
    n_w, m_w = jl.norm_from_depth(jnp.asarray(depth), cam.tanfovx,
                                  cam.tanfovy, jnp.asarray(wv))
    n_t, m_t = tl.norm_from_depth(torch.as_tensor(depth), cam.tanfovx,
                                  cam.tanfovy, wv)
    assert 0 < m_t.sum() < m_t.numel()
    np.testing.assert_array_equal(m_t.numpy(), np.asarray(m_w))
    np.testing.assert_allclose(n_t.numpy(), np.asarray(n_w), atol=1e-4)
    _check(lambda n, d, a: jl.norm_reg_loss(n, d, cam.tanfovx, cam.tanfovy,
                                            jnp.asarray(wv), a),
           lambda n, d, a: tl.norm_reg_loss(n, d, cam.tanfovx, cam.tanfovy,
                                            wv, a),
           (_unit(8), depth, _mask()), (0,), atol=1e-5)


def test_zero_one():
    v = np.random.default_rng(9).uniform(-0.1, 1.1, size=(500, 1)).astype(np.float32)
    _check(jl.zero_one_loss, tl.zero_one_loss, (v,), (0,))


def test_depth2world():
    cam = orbit_cameras(1, radius=3.5, width=W, height=H)[0]
    depth = _depth()[0]
    want = jax_depth2world(jnp.asarray(depth), cam.full_proj, cam.zfar,
                           cam.znear)
    got = depth2world(torch.as_tensor(depth), np.asarray(cam.full_proj),
                      cam.zfar, cam.znear)
    assert got.shape == (H, W, 3)
    # both invert the ill-conditioned projection (near 0.01, far 100) in
    # float32, each with its own LU: points agree to ~1e-4 of their scale
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-4)
    # in float64 the port's points are the camera's own ray points
    exact = depth2world(torch.as_tensor(depth, dtype=torch.float64),
                        np.asarray(cam.full_proj, np.float64), cam.zfar,
                        cam.znear)
    center = np.asarray(cam.camera_center, np.float64)
    dist = np.linalg.norm(exact.numpy() - center, axis=-1)
    assert (dist >= depth - 1e-6).all()
