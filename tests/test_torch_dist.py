"""Band rendering and the fold of texgs_torch.dist against texgs, in one
process (no process group).

* ``band_height`` for several heights and band counts; ``over_fold`` on
  random slices (and its associativity: the fold of depth slices equals
  the blend of the whole sequence); ``grad_scale``'s value and gradient.
* ``render(..., row_offset, band_height)`` against texgs's
  (``backend="scan"``) at 48 wide x 40 high: 40 rows are three tile rows,
  so 2 bands of 32 rows leave the second padded.  Both bands, forward and
  the gradients of every input (the NDC offset included).  Forward at
  texgs's 3e-5 (tests/test_dist.py:55-58) through ``assert_close_mostly``,
  as tests/test_torch_render_stage1.py holds the whole frame: the packages
  round the tile-local exponent differently in its last ulp, so 0.5% of
  the pixels may flip an alpha or T threshold (by at most 1e-3); depth at
  2e-4 (at most 2e-2); gradients at 5e-4 + 1e-3 |g|.
* ``uv_tex_render(..., row_offset, band_height)`` against texgs's
  (``backend="scan"``, ``tex_backend="xla"``, m = 8, a 16^2 texture), the
  port on its two-kernel path (texgs's ``scan``) and on its fused path
  (kernel A's plain version), both against texgs's scan twin: forward at
  tests/test_uvtex_raster.py's fused-vs-scan tolerances (image 1e-4 for
  99.5%, at most 3e-2: an alpha flip moves a pixel's M-list by one entry),
  gradients at 2e-3 of each leaf's max |grad| (its grad tolerance).
* The stitched bands against the whole frame, on the port alone.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_rasterizer import assert_close_mostly
from tests.test_torch_uvtex_fused import torch_camera, uv_jacobians
from texgs.data.synthetic import blob_point_cloud
from texgs.data.synthetic import orbit_cameras as jax_orbit_cameras
from texgs.dist import gauss_sharded as jgs
from texgs.dist import sharded as jsh
from texgs.dist import tile_parallel as jtp
from texgs.render.render import render as jax_render
from texgs.render.uv_tex_render import uv_tex_render as jax_uv_tex_render
from texgs_torch.dist import collectives, gauss_sharded, tile_parallel
from texgs_torch.render.render import render
from texgs_torch.render.uv_tex_render import uv_tex_render

N, W, H, BAND_H = 256, 48, 40, 32
GAUSS_NAMES = ("xyz", "opacity", "scaling", "rotation", "features")
BG = np.array([0.2, 0.1, 0.3], np.float32)
ROW_OFFSETS = (0, BAND_H)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("height,n_bands", [(64, 4), (600, 4), (600, 2),
                                            (40, 2), (48, 8), (16, 3),
                                            (1, 1), (1080, 4)])
def test_band_height_matches_texgs(height, n_bands):
    got = tile_parallel.band_height(height, n_bands)
    assert got == jtp.band_height(height, n_bands)
    assert got % 16 == 0 and n_bands * got >= height


def test_over_fold_matches_texgs_and_blends_the_whole_sequence():
    rng = np.random.default_rng(0)
    k, f, h, w, per = 4, 3, 8, 8, 5
    alphas = rng.uniform(0.0, 0.9, size=(k, per, h, w)).astype(np.float32)
    colors = rng.uniform(size=(k, per, f, h, w)).astype(np.float32)
    chans, trans = [], []
    for i in range(k):
        t = np.ones((h, w), np.float32)
        c = np.zeros((f, h, w), np.float32)
        for j in range(per):
            c += alphas[i, j] * t * colors[i, j]
            t = t * (1 - alphas[i, j])
        chans.append(c)
        trans.append(t[None])
    chans, trans = np.stack(chans), np.stack(trans)
    c_tot, t_tot = gauss_sharded.over_fold(torch.as_tensor(chans),
                                           torch.as_tensor(trans))
    jc, jt = jgs.over_fold(jnp.asarray(chans), jnp.asarray(trans))
    np.testing.assert_allclose(c_tot.numpy(), np.asarray(jc), atol=1e-6)
    np.testing.assert_allclose(t_tot.numpy(), np.asarray(jt), atol=1e-6)
    # the blend of the concatenated sequence
    t = np.ones((h, w), np.float32)
    c = np.zeros((f, h, w), np.float32)
    for i in range(k):
        for j in range(per):
            c += alphas[i, j] * t * colors[i, j]
            t = t * (1 - alphas[i, j])
    np.testing.assert_allclose(c_tot.numpy(), c, atol=1e-6)
    np.testing.assert_allclose(t_tot.numpy()[0], t, atol=1e-6)
    # associativity: folding two halves first, then the halves
    c01, t01 = gauss_sharded.over_fold(torch.as_tensor(chans[:2]),
                                       torch.as_tensor(trans[:2]))
    c23, t23 = gauss_sharded.over_fold(torch.as_tensor(chans[2:]),
                                       torch.as_tensor(trans[2:]))
    c2, t2 = gauss_sharded.over_fold(torch.stack([c01, c23]),
                                     torch.stack([t01, t23]))
    np.testing.assert_allclose(c2.numpy(), c_tot.numpy(), atol=1e-6)
    np.testing.assert_allclose(t2.numpy(), t_tot.numpy(), atol=1e-6)


def test_over_fold_gradients_match_texgs():
    rng = np.random.default_rng(1)
    chans = rng.uniform(size=(3, 4, 6, 5)).astype(np.float32)
    trans = rng.uniform(0.05, 1.0, size=(3, 1, 6, 5)).astype(np.float32)
    cot = rng.normal(size=(4, 6, 5)).astype(np.float32)

    def jloss(c, t):
        ct, tt = jgs.over_fold(c, t)
        return (ct * cot).sum() + 0.5 * tt.sum()

    want = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(chans),
                                           jnp.asarray(trans))
    c = torch.tensor(chans, requires_grad=True)
    t = torch.tensor(trans, requires_grad=True)
    ct, tt = gauss_sharded.over_fold(c, t)
    ((ct * torch.as_tensor(cot)).sum() + 0.5 * tt.sum()).backward()
    np.testing.assert_allclose(c.grad.numpy(), np.asarray(want[0]), atol=1e-6)
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(want[1]),
                               atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("s", [1.0, 0.5, 0.25])
def test_grad_scale_matches_texgs(s):
    x = np.random.default_rng(2).normal(size=(7,)).astype(np.float32)
    want_v = np.asarray(jsh._grad_scale(jnp.asarray(x), s))
    want_g = np.asarray(jax.grad(
        lambda a: (jsh._grad_scale(a, s) ** 2).sum())(jnp.asarray(x)))
    t = torch.tensor(x, requires_grad=True)
    y = collectives.grad_scale(t, s)
    (y ** 2).sum().backward()
    np.testing.assert_array_equal(y.detach().numpy(), want_v)
    np.testing.assert_allclose(y.detach().numpy(), x, rtol=1e-6)
    np.testing.assert_allclose(t.grad.numpy(), want_g, rtol=1e-6)
    np.testing.assert_allclose(t.grad.numpy(), 2 * s * x, rtol=1e-6)


def gaussians(seed=4):
    """Activated numpy Gaussians on a blob, SH degree 2."""
    pcd = blob_point_cloud(N, seed=seed)
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(N, 4)).astype(np.float32)
    feats = 0.2 * rng.normal(size=(N, 9, 3))
    feats[:, 0] = (pcd.colors - 0.5) / 0.28209479177387814
    return dict(
        xyz=pcd.points.astype(np.float32),
        opacity=rng.uniform(0.2, 0.95, size=(N, 1)).astype(np.float32),
        scaling=np.exp(rng.uniform(-3.4, -2.4, size=(N, 3))).astype(np.float32),
        rotation=(q / np.linalg.norm(q, axis=-1, keepdims=True)),
        features=feats.astype(np.float32))


def camera():
    return jax_orbit_cameras(1, radius=3.5, width=W, height=H)[0]


def band_target(row0, c, seed):
    return np.random.default_rng(seed + row0).uniform(
        size=(c, BAND_H, W)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _render_band_grad():
    """texgs's band render and its gradients, jitted once with the band's
    row offset traced (as texgs's tile axis traces it)."""
    cam = camera()

    def jloss(row0, tgt, ndc, *args):
        out = jax_render(cam, **dict(zip(GAUSS_NAMES, args)),
                         active_sh_degree=2, bg_color=jnp.asarray(BG),
                         ndc_offset=ndc, backend="scan", row_offset=row0,
                         band_height=BAND_H)
        loss = (jnp.abs(out["render"] - tgt).mean() + out["alpha"].mean()
                + 0.01 * out["depth"].mean() + 0.01 * out["norm"].mean())
        return loss, out

    return jax.jit(jax.value_and_grad(jloss, argnums=tuple(range(2, 8)),
                                      has_aux=True))


@pytest.mark.parametrize("row0", ROW_OFFSETS, ids=["band0", "band1_padded"])
def test_render_band_matches_texgs(row0):
    cam, g = camera(), gaussians()
    names = list(g)
    tgt = band_target(row0, 3, 7)
    (_, want), want_g = _render_band_grad()(
        row0, jnp.asarray(tgt), jnp.zeros((N, 2)),
        *(jnp.asarray(g[k]) for k in names))
    t = {k: torch.tensor(g[k], requires_grad=True) for k in names}
    ndc = torch.zeros((N, 2), requires_grad=True)
    got = render(torch_camera(cam), **t, active_sh_degree=2,
                 bg_color=torch.as_tensor(BG), ndc_offset=ndc,
                 row_offset=row0, band_height=BAND_H)
    loss = ((got["render"] - torch.as_tensor(tgt)).abs().mean()
            + got["alpha"].mean() + 0.01 * got["depth"].mean()
            + 0.01 * got["norm"].mean())
    got_g = torch.autograd.grad(loss, [ndc] + [t[k] for k in names])
    for k, atol, hard in (("render", 3e-5, 1e-3), ("depth", 2e-4, 2e-2),
                          ("norm", 3e-5, 1e-3), ("alpha", 3e-5, 1e-3)):
        assert got[k].shape == (want[k].shape[0], BAND_H, W)
        assert_close_mostly(got[k].detach().numpy(), np.asarray(want[k]),
                            atol=atol, frac=0.995, hard_atol=hard, name=k)
    np.testing.assert_array_equal(got["radii"].numpy(),
                                  np.asarray(want["radii"]))
    assert int(got["n_pairs"]) == int(want["n_pairs"]) > 0
    for name, a, b in zip(["ndc_offset"] + names, got_g, want_g):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=5e-4,
                                   rtol=1e-3, err_msg=name)
    assert float(got_g[0].abs().max()) > 1e-4


def uv_scene(seed=7):
    """Stage-3 inputs as numpy: uv = normalize(xyz) with its Jacobian,
    residual SH of degree 1, a smooth 16^2 texture."""
    from tests.test_uvtex_raster import _texture

    g = gaussians(seed)
    rng = np.random.default_rng(seed)
    xyz = g["xyz"]
    return dict(xyz=xyz, opacity=g["opacity"], scaling=g["scaling"],
                rotation=g["rotation"],
                uvs=(xyz / np.linalg.norm(xyz, axis=-1, keepdims=True)
                     ).astype(np.float32),
                grad_uvs=uv_jacobians(xyz),
                texture=np.asarray(_texture(16)),
                shs=(0.05 * rng.normal(size=(N, 3, 3))).astype(np.float32))


UV_GRAD_NAMES = ("xyz", "opacity", "scaling", "rotation", "uvs", "texture",
                 "shs")


@pytest.fixture(scope="module")
def uv_band_texgs():
    """texgs's scan-twin band renders and gradients, one per band."""
    sc, cam = uv_scene(), camera()

    def jloss(row0, tgt, *args):
        kw = dict(zip(UV_GRAD_NAMES, args))
        r = jax_uv_tex_render(
            cam, **kw, grad_uvs=jnp.asarray(sc["grad_uvs"]),
            active_sh_degree=1, bg_color=jnp.asarray(BG), m=8,
            backend="scan", tex_backend="xla", with_no_sh=True,
            row_offset=row0, band_height=BAND_H)
        loss = (jnp.abs(r["render"] - tgt).mean() + 0.1 * r["alpha"].mean()
                + 0.01 * r["depth"].mean() + 0.01 * r["norm"].mean()
                + 0.5 * jnp.abs(r["render_no_sh"] - tgt).mean())
        return loss, r

    run = jax.jit(jax.value_and_grad(jloss, argnums=tuple(range(2, 9)),
                                     has_aux=True))
    out = {}
    for row0 in ROW_OFFSETS:
        tgt = band_target(row0, 3, 11)
        (_, r), grads = run(row0, jnp.asarray(tgt),
                            *(jnp.asarray(sc[k]) for k in UV_GRAD_NAMES))
        out[row0] = (r, grads, tgt)
    return sc, cam, out


@pytest.mark.parametrize("backend", ["scan", "auto"],
                         ids=["two_kernel", "fused"])
@pytest.mark.parametrize("row0", ROW_OFFSETS, ids=["band0", "band1_padded"])
def test_uv_tex_render_band_matches_texgs(uv_band_texgs, backend, row0):
    sc, cam, runs = uv_band_texgs
    want, want_g, tgt = runs[row0]
    leaves = {k: torch.tensor(sc[k], requires_grad=True)
              for k in UV_GRAD_NAMES}
    got = uv_tex_render(torch_camera(cam), **leaves,
                        grad_uvs=torch.as_tensor(sc["grad_uvs"]),
                        active_sh_degree=1, bg_color=torch.as_tensor(BG),
                        m=8, backend=backend, tex_backend="xla",
                        with_no_sh=True, row_offset=row0, band_height=BAND_H)
    t = torch.as_tensor(tgt)
    loss = ((got["render"] - t).abs().mean() + 0.1 * got["alpha"].mean()
            + 0.01 * got["depth"].mean() + 0.01 * got["norm"].mean()
            + 0.5 * (got["render_no_sh"] - t).abs().mean())
    got_g = torch.autograd.grad(loss, [leaves[k] for k in UV_GRAD_NAMES])
    for k, atol, frac, hard in (("render", 1e-4, 0.995, 3e-2),
                                ("render_no_sh", 1e-4, 0.995, 3e-2),
                                ("alpha", 3e-5, 0.999, 5e-3),
                                ("depth", 1e-4, 0.999, 5e-3),
                                ("norm", 3e-5, 0.999, 5e-3)):
        assert got[k].shape == (want[k].shape[0], BAND_H, W)
        assert_close_mostly(got[k].detach().numpy(), np.asarray(want[k]),
                            atol=atol, frac=frac, hard_atol=hard, name=k)
    for name, a, b in zip(UV_GRAD_NAMES, got_g, want_g):
        b = np.asarray(b)
        denom = np.abs(b).max() + 1e-8
        np.testing.assert_allclose(a.numpy() / denom, b / denom, atol=2e-3,
                                   err_msg=f"grad {name}")
    assert float(got_g[5].abs().max()) > 0


@pytest.mark.parametrize("n_bands", [2, 3])
def test_stitched_bands_equal_the_whole_frame(n_bands):
    """On the port alone: the bands stitched (the padded rows cropped)
    against one render of the frame, both stages' renders."""
    sc, cam = uv_scene(), torch_camera(camera())
    band_h = tile_parallel.band_height(H, n_bands)
    g = {k: torch.as_tensor(v) for k, v in gaussians().items()}
    kw = dict(active_sh_degree=2, bg_color=torch.as_tensor(BG), **g)
    whole = render(cam, **kw)
    bands = torch.stack([torch.cat([b["render"], b["alpha"]]) for b in (
        tile_parallel.render_band(cam, i * band_h, band_h, **kw)
        for i in range(n_bands))])
    got = tile_parallel.stitch_bands(bands, H)
    want = torch.cat([whole["render"], whole["alpha"]])
    assert_close_mostly(got.numpy(), want.numpy(), atol=3e-5, frac=0.999,
                        hard_atol=1e-3, name="stage 1")

    uv = {k: torch.tensor(v) for k, v in sc.items()}
    kw = dict(active_sh_degree=1, bg_color=torch.as_tensor(BG), m=8, **uv)
    whole = uv_tex_render(cam, **kw)
    bands = torch.stack([torch.cat([b["render"], b["alpha"]]) for b in (
        tile_parallel.render_band(cam, i * band_h, band_h, uv_tex_render,
                                  **kw) for i in range(n_bands))])
    got = tile_parallel.stitch_bands(bands, H)
    want = torch.cat([whole["render"], whole["alpha"]])
    assert_close_mostly(got.numpy(), want.numpy(), atol=1e-4, frac=0.995,
                        hard_atol=3e-2, name="stage 3")


def test_band_with_no_pair_passes_zero_gradients():
    """A band below every Gaussian holds no pair: the render gives the
    background and its backward (kernel A''s plain version) zero
    gradients."""
    sc, cam = uv_scene(), torch_camera(camera())
    leaves = {k: torch.tensor(v, requires_grad=True) for k, v in sc.items()}
    far = dict(leaves, xyz=leaves["xyz"] + torch.tensor([0.0, 0.0, 50.0]))
    out = uv_tex_render(cam, **far, active_sh_degree=1,
                        bg_color=torch.as_tensor(BG), m=8,
                        row_offset=10 * BAND_H, band_height=BAND_H)
    assert int(out["n_pairs"]) == 0
    np.testing.assert_array_equal(out["alpha"].detach().numpy(), 0.0)
    (out["render"].sum() + out["alpha"].sum()).backward()
    for k in ("xyz", "opacity", "uvs", "texture"):
        g = leaves[k].grad
        assert g is None or not g.any(), k
