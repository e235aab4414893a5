"""Kernel B's plain version (texgs_torch.kernels.tex_term.mlist_tex_term)
and the port's cubemap sampling against texgs.

The JAX side is texgs's exact ``uvtex_raster.mlist_tex_term`` and the
Pallas textile kernel, run as texgs's own tests run it, in interpret mode
on the CPU (``tex_term_textile(..., catch_size=0)``), on the coherent
in-face M-lists of tests/test_textile.py:23-38, and at m = 1 and 33 on
pixels of 0, 1, 31 and m live slots (tests/test_torch_kernels_cuda.py's
live_count_mlist).  Tolerance: atol 2e-5 /
rtol 1e-4 (tests/test_textile.py:53-54); the cubemap taps themselves must
agree to float32 rounding.
"""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_textile import H, W, _random_mlist, _texture
from tests.test_torch_kernels_cuda import live_count_mlist
from texgs.kernels import cubemap as jcube
from texgs.kernels import uvtex_raster as juv
from texgs.kernels.pallas_textile import tex_term_textile
from texgs.train.texture_gaussian3d import TextureGaussian3D as JaxModel
from texgs_torch.kernels import cubemap as tcube
from texgs_torch.kernels import uvtex_raster as tuv
from texgs_torch.kernels.tex_term import mlist_tex_term, tex_term
from texgs_torch.train.texture_gaussian3d import TextureGaussian3D
from tests.torch_threads import one_thread  # noqa: F401

MODES = ["bilinear", "nearest", "bilinear_clamp"]


def edge_corner_dirs(n=4000, seed=0):
    """Directions on and near the 12 cube edges and 8 corners."""
    rng = np.random.default_rng(seed)
    d = rng.choice([-1.0, 1.0], size=(n, 3))
    edge = rng.uniform(size=n) < 0.5
    free = rng.integers(0, 3, size=n)
    d[edge, free[edge]] = rng.uniform(-1, 1, size=edge.sum())
    jitter = 10.0 ** rng.uniform(-7, -1.5, size=(n, 1))
    d += rng.normal(size=(n, 3)) * jitter
    d[: n // 8] = np.round(d[: n // 8])          # exact corners and edges
    return (d * rng.uniform(0.3, 3.0, size=(n, 1))).astype(np.float32)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("res", [8, 64])
def test_sample_cubemap_matches_jax_on_edges_and_corners(mode, res):
    tex = np.random.default_rng(res).uniform(
        -1.5, 1.5, size=(6, res, res, 3)).astype(np.float32)
    d = edge_corner_dirs(seed=res)
    want = np.asarray(jcube.sample_cubemap(jnp.asarray(tex), jnp.asarray(d),
                                           mode))
    got = tcube.sample_cubemap(torch.as_tensor(tex), torch.as_tensor(d),
                               mode).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)


def test_direction_face_uv_roundtrip_matches_jax():
    d = edge_corner_dirs(seed=11)
    jf, ju, jv = jcube.direction_to_face_uv(jnp.asarray(d))
    tf, tu, tv = tcube.direction_to_face_uv(torch.as_tensor(d))
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    np.testing.assert_array_equal(tu.numpy(), np.asarray(ju))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    back = tcube.face_uv_to_direction(tf, tu, tv).numpy()
    np.testing.assert_array_equal(
        back, np.asarray(jcube.face_uv_to_direction(jf, ju, jv)))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("coherent", [True, False],
                         ids=["coherent", "incoherent"])
def test_mlist_tex_term_matches_jax(mode, coherent):
    ml = np.array(_random_mlist(seed=3, coherent=coherent))
    tex = np.array(_texture())
    want = juv.mlist_tex_term(jnp.asarray(ml), jnp.asarray(tex), H, W, mode)
    got = mlist_tex_term(torch.as_tensor(ml), torch.as_tensor(tex), H, W, mode)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=1e-4)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("m", [1, 33])
def test_mlist_tex_term_matches_jax_at_live_counts(m, mode):
    """At m = 1 and 33 (where kernel B's warps straddle pixels), on pixels
    of 0, 1, 31 and m live slots, a prefix of each list, over random
    directions: the plain version the card tests hold kernel B to."""
    ml = live_count_mlist(4, m, seed=m)[0].numpy()
    counts = (ml[..., 0] != 0).sum(-1)
    assert {0, 1, m} <= set(counts.ravel().tolist())
    tex = np.array(_texture())
    want = juv.mlist_tex_term(jnp.asarray(ml), jnp.asarray(tex), H, W, mode)
    got = mlist_tex_term(torch.as_tensor(ml), torch.as_tensor(tex), H, W, mode)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=1e-4)


@pytest.mark.parametrize("mode", ["bilinear", "nearest"])
def test_mlist_tex_term_matches_textile_interpret(mode):
    """Against the Pallas textile kernel itself, on footprints that stay
    inside a face, where its windows serve every tap exactly."""
    ml = _random_mlist(seed=0)
    tex = _texture()
    want, miss, _ = tex_term_textile(ml, tex, H, W, mode, catch_size=0)
    assert int(miss) == 0
    got = tex_term(torch.as_tensor(np.asarray(ml)),
                   torch.as_tensor(np.asarray(tex)), H, W, mode)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=1e-4)


def test_tail_tex_term_matches_jax():
    rng = np.random.default_rng(4)
    ml = np.array(_random_mlist(seed=5))
    t_final = rng.uniform(0.0, 0.5, size=ml.shape[:2]).astype(np.float32)
    tex = np.array(_texture())
    want = juv.tail_tex_term(jnp.asarray(ml), jnp.asarray(t_final),
                             jnp.asarray(tex), H, W)
    got = tuv.tail_tex_term(torch.as_tensor(ml), torch.as_tensor(t_final),
                            torch.as_tensor(tex), H, W)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=1e-4)


def test_cubemap_to_latlong_matches_jax():
    tex = np.array(_texture(seed=2))
    want = jcube.cubemap_to_latlong(jnp.asarray(tex), (24, 48))
    got = tcube.cubemap_to_latlong(torch.as_tensor(tex), (24, 48))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("res", [8, 16])
def test_texture_maps_match_jax_past_the_clamp(res):
    """The port's sphere_map and cube_map (``cubemap_maps``, which runs the
    plain functions on CPU tensors and launches nothing) against texgs's,
    on an SH0 texture whose C0 * sh0 + 0.5 spans [-0.35, 1.35], so
    sh02rgb's clamp bites."""
    sh0 = np.random.default_rng(res).uniform(
        -3.0, 3.0, size=(6, res, res, 3)).astype(np.float32)
    jmodel = SimpleNamespace(tex_params={"texture": jnp.asarray(sh0)},
                             tex_res=res)
    model = SimpleNamespace(texture=torch.as_tensor(sh0))
    before = tcube.cubemap_maps.launches
    pano = TextureGaussian3D.sphere_map(model, (24, 48))
    cross = TextureGaussian3D.cube_map(model)
    assert tcube.cubemap_maps.launches == before
    assert pano.shape == (24, 48, 3) and cross.shape == (3 * res, 4 * res, 3)
    np.testing.assert_allclose(pano.numpy(),
                               JaxModel.sphere_map(jmodel, (24, 48)),
                               atol=1e-5)
    np.testing.assert_allclose(cross.numpy(),
                               np.asarray(JaxModel.cube_map(jmodel)),
                               rtol=0, atol=1e-6)


def test_chessboard_cubemap_matches_jax():
    want = np.asarray(jcube.chessboard_cubemap(3, 4))
    got = tcube.chessboard_cubemap(3, 4, device="cpu").numpy()
    np.testing.assert_array_equal(got, want)


def test_cross_layout_roundtrip():
    faces = torch.as_tensor(np.array(_texture(seed=3)))
    cross = tcube.faces_to_cross(faces)
    assert cross.shape == (3 * faces.shape[1], 4 * faces.shape[1], 3)
    torch.testing.assert_close(tcube.cross_to_faces(cross), faces,
                               rtol=0, atol=0)
