"""Kernel B''s plain version (``mlist_tex_term_vjp``) against ``jax.vjp`` of
texgs's exact ``uvtex_raster.mlist_tex_term``, on the M-lists that set
kernel B' its hardest cases: m = 1 and m = 33, where the kernel's warps
(one thread per slot) straddle pixels, and lists whose every live slot
points at one cube corner, so that every tap of every pixel lands on the
same few texels and the corner taps average three.  The frame (40 x 56) has
partial edge tiles, and a quarter of its pixels get a zero cotangent.

Tolerance: tests/test_torch_uvtex_grads.py's for this VJP (texgs's
tests/test_textile.py), atol 3e-5 / rtol 1e-3 on d texture and on the live
slots' d M-list.  Dead slots are not compared: there the plain VJP
differentiates the texture term at the zero direction, which kernel B'
gives no cotangent.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from texgs.kernels import uvtex_raster as juv
from texgs_torch.kernels.tex_term import mlist_tex_term_vjp
from tests.torch_threads import one_thread  # noqa: F401

MODES = ["bilinear", "nearest", "bilinear_clamp"]
H, W = 40, 56            # 3 x 4 tiles, the last row and column partial
N_TILES = 12
RES = 16


def vjp_inputs(m, seed, corner=False):
    """(mlist (12, 256, m, 4), texture (6, 16, 16, 3), g (3, H, W)) as
    numpy float32: 70% of the slots live, directions random or all on the
    (+1, +1, +1) corner at random lengths."""
    rng = np.random.default_rng(seed)
    n = N_TILES * 256 * m
    w = rng.uniform(0.01, 0.4, size=(n, 1)) * (rng.uniform(size=(n, 1)) < 0.7)
    if corner:
        d = np.ones((n, 3)) * rng.uniform(0.5, 2.0, size=(n, 1))
    else:
        d = rng.normal(size=(n, 3))
    d = np.where(w > 0, d, 0.0)
    ml = np.concatenate([w, d], axis=1).astype(np.float32).reshape(
        N_TILES, 256, m, 4)
    tex = rng.uniform(-1.5, 1.5, size=(6, RES, RES, 3)).astype(np.float32)
    g = rng.normal(size=(3, H, W)) * (rng.uniform(size=(1, H, W)) < 0.75)
    return ml, tex, g.astype(np.float32)


def assert_vjp_matches_jax(ml, tex, g, mode):
    _, vjp = jax.vjp(lambda a, b: juv.mlist_tex_term(a, b, H, W, mode),
                     jnp.asarray(ml), jnp.asarray(tex))
    g_ml_w, g_tex_w = vjp(jnp.asarray(g))
    g_ml, g_tex = mlist_tex_term_vjp(torch.as_tensor(ml), torch.as_tensor(tex),
                                     torch.as_tensor(g), H, W, mode)
    np.testing.assert_allclose(g_tex.numpy(), np.asarray(g_tex_w), atol=3e-5,
                               rtol=1e-3)
    live = ml[..., 0] > 0
    np.testing.assert_allclose(g_ml.numpy()[live], np.asarray(g_ml_w)[live],
                               atol=3e-5, rtol=1e-3)
    return g_tex.numpy()


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("m", [1, 33])
def test_plain_vjp_matches_jax_where_warps_straddle_pixels(m, mode):
    assert_vjp_matches_jax(*vjp_inputs(m, seed=m), mode)


@pytest.mark.parametrize("mode", ["bilinear", "bilinear_clamp"])
def test_plain_vjp_matches_jax_with_every_slot_on_one_corner(mode):
    ml, tex, g = vjp_inputs(8, seed=3, corner=True)
    g_tex = assert_vjp_matches_jax(ml, tex, g, mode)
    # every tap of every slot lands on the corner's texels: the one face-0
    # texel the clamped taps share, or the three that meet at the corner
    touched = np.argwhere(np.abs(g_tex).sum(-1) > 0)
    assert len(touched) == (3 if mode == "bilinear" else 1)
