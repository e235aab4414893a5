"""Kernel 2's plain versions (texgs_torch.kernels.uvtex_mlist) against
texgs's M-list pass of the two-kernel stage-3 render.

The JAX side runs the Pallas kernel ``mlist_pallas`` as texgs's own tests
do, in interpret mode on the CPU, and its scan twin ``mlist_scan``.  Both
packages get the same projected Gaussians, made from numpy-seeded inputs
(the scene of tests/test_uvtex_raster.py:48-57).  Slots are compared as
tests/test_torch_uvtex_fused.py compares kernel A's: a tiny fraction of
pixels may flip across the alpha = 1/255 or T = 1e-4 thresholds, since the
two packages round the exponent differently in the last ulp.  The VJP is
held against ``jax.vjp`` of ``mlist_pallas`` on the well-conditioned
soft-opacity scene (opacities far from the 0.99 clamp), at atol 2e-3 of
each input's max |grad|, as tests/test_uvtex_raster.py compares texgs's own
backwards.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_kernels_cuda import opaque_stack_mlist_inputs
from tests.test_torch_uvtex_fused import (CHUNK, _assert_mlist, jax_project,
                                          scene, to_torch_proj, torch_camera)
from texgs.kernels import binning as jbin
from texgs.kernels import tile_raster as jtr
from texgs.kernels import uvtex_raster as juv
from texgs.kernels.pallas_uvtex import mlist_pallas
from texgs_torch.kernels import binning as tbin
from texgs_torch.kernels import tile_raster as ttr
from texgs_torch.kernels import uvtex_raster as tuv
from texgs_torch.kernels.uvtex_mlist import (mlist_only_scan,
                                             mlist_only_scan_vjp, mlist_pairs,
                                             mlist_pairs_backward)
from tests.torch_threads import one_thread  # noqa: F401

PROJ_KEYS = ("means2d", "conics", "opacities")
UV_KEYS = ("sv", "siginv", "base_uv")


def _both(sc):
    """Both packages' inputs for the same projected Gaussians (JAX's):
    texgs's (proj, tables, pairs) and the port's kernel arguments."""
    cam = sc["cam"]
    h, w = cam.height, cam.width
    proj = jax_project(sc)
    tables = juv.build_uvtex_tables(
        jnp.asarray(sc["xyz"]), jnp.asarray(sc["scaling"]),
        jnp.asarray(sc["rotation"]), jnp.asarray(sc["uvs"]),
        jnp.asarray(sc["jac"]), cam.camera_center)
    n = sc["xyz"].shape[0]
    pairs = jbin.build_pairs(proj.means2d, proj.depths, proj.radii, h, w,
                             max(4 * n, 1 << 14), CHUNK)
    tproj = to_torch_proj(proj)
    tpairs = tbin.build_pairs(tproj.means2d, tproj.depths, tproj.radii, h, w)
    ttables = tuv.UVTexTables(*(torch.as_tensor(np.asarray(a)) for a in tables))
    port = (tproj, ttables, tpairs, tuv.ray_constants(torch_camera(cam)),
            jbin.grid_shape(h, w)[1])
    return (proj, tables, pairs), port


def _kernel_args(port, m):
    tproj, ttables, tpairs, rays, gx = port
    return (ttr.build_gauss_table(tproj), tuv.build_uv_rows(ttables), tpairs,
            rays, gx, m)


@pytest.fixture(scope="module", params=[1, 8, 33, 96],
                ids=["m1", "m8", "m33", "m96"])
def mlist_runs(request):
    m = request.param
    sc = scene()
    (proj, tables, pairs), port = _both(sc)
    cam = sc["cam"]
    attrs = jtr.build_pair_attrs(proj, pairs, cam.height, cam.width)
    uv_rows = juv.build_uv_rows(tables, pairs)
    want_pallas = mlist_pallas(attrs, uv_rows.T, pairs, cam, CHUNK, m)
    want_scan = juv.mlist_scan(attrs, uv_rows, pairs, cam, CHUNK, m)
    return m, want_pallas, want_scan, mlist_only_scan(*_kernel_args(port, m))


def test_plain_matches_jax_mlist_pallas(mlist_runs):
    m, want, _, got = mlist_runs
    _assert_mlist(got, want, f"pallas m={m}")


def test_plain_matches_jax_mlist_scan(mlist_runs):
    m, _, want, got = mlist_runs
    _assert_mlist(got, want, f"scan m={m}")


def test_plain_fills_slots_in_order(mlist_runs):
    """Occupied slots are a prefix of each list, every weight lies in
    (0, 1], slot uvs are unit vectors, and unvisited tiles are zero."""
    m, _, _, got = mlist_runs
    ml = got.numpy()
    live = ml[..., 0] > 0
    assert (live == (np.arange(m)[None, None] < live.sum(-1)[..., None])).all()
    assert ml[..., 0].max() <= 1.0 and ml[..., 0].min() >= 0.0
    np.testing.assert_allclose(np.linalg.norm(ml[..., 1:], axis=-1)[live], 1.0,
                               atol=1e-5)
    assert not ml[~live].any()


@pytest.mark.parametrize("m", [8, 32])
def test_vjp_matches_jax_mlist_pallas(m):
    """Kernel 2''s plain version, through autograd from the projected
    Gaussians' quadratic inputs and the uv tables, against jax.vjp of the
    interpret-mode Pallas kernel with the same cotangent."""
    sc = scene(n=192, size=32, opacity=2.0)
    cam = sc["cam"]
    (proj, tables, pairs), port = _both(sc)
    tproj, ttables, tpairs, rays, gx = port
    n_tiles = int(np.prod(jbin.grid_shape(cam.height, cam.width)))
    cot = np.random.default_rng(3).normal(
        size=(n_tiles, 256, m, 4)).astype(np.float32)

    def jax_f(means2d, conics, opacities, sv, siginv, base_uv):
        p = proj._replace(means2d=means2d, conics=conics, opacities=opacities)
        attrs = jtr.build_pair_attrs(p, pairs, cam.height, cam.width)
        t = tables._replace(sv=sv, siginv=siginv, base_uv=base_uv)
        return mlist_pallas(attrs, juv.build_uv_rows(t, pairs).T, pairs, cam,
                            CHUNK, m)

    primals = [getattr(proj, k) for k in PROJ_KEYS] + [getattr(tables, k)
                                                       for k in UV_KEYS]
    out, vjp = jax.vjp(jax_f, *primals)
    want = vjp(jnp.asarray(cot))

    leaves = [torch.tensor(np.array(a), requires_grad=True) for a in primals]
    tp = tproj._replace(**dict(zip(PROJ_KEYS, leaves[:3])))
    tt = ttables._replace(**dict(zip(UV_KEYS, leaves[3:])))
    ml = mlist_pairs(ttr.build_gauss_table(tp), tuv.build_uv_rows(tt), tpairs,
                     rays, gx, m)
    _assert_mlist(ml.detach(), out, f"vjp forward m={m}")
    (ml * torch.as_tensor(cot)).sum().backward()
    for name, a, leaf in zip(PROJ_KEYS + UV_KEYS, want, leaves):
        a, b = np.asarray(a), leaf.grad.numpy()
        assert np.isfinite(b).all(), name
        denom = np.abs(a).max() + 1e-8
        np.testing.assert_allclose(b / denom, a / denom, atol=2e-3,
                                   err_msg=f"grad mismatch: {name}")
        assert np.abs(b).max() > 0, name


def test_nan_on_dead_entries_and_slots_reaches_no_gradient():
    """NaN channels and uv rows behind an opaque stack, and NaN cotangents
    on the empty slots: the M-lists and both gradients stay finite, and the
    dead entries get no gradient."""
    args = opaque_stack_mlist_inputs()
    ml = mlist_only_scan(*args)
    live = ml[..., 0] > 0
    assert bool(torch.isfinite(ml).all())
    assert bool(live[..., :5].all()) and not bool(live[..., 5:].any())
    g = torch.as_tensor(np.random.default_rng(5).normal(size=tuple(ml.shape)),
                        dtype=torch.float32)
    g[~live] = float("nan")
    d_table, d_uv = mlist_only_scan_vjp(*args, g)
    assert bool(torch.isfinite(d_table).all()) and bool(torch.isfinite(d_uv).all())
    assert not bool(d_table[5:].any()) and not bool(d_uv[5:].any())
    # the live entries get gradient in their quadratic and in sv, siginv
    # and base_uv only
    assert bool(d_table[:5, :6].any()) and not bool(d_table[:, 6:].any())
    assert bool(d_uv[:5, :12].any()) and not bool(d_uv[:, 12:].any())


def test_wrappers_take_plain_version_on_cpu():
    (_, _, _), port = _both(scene(n=128, size=32))
    args = _kernel_args(port, 16)
    ml = mlist_only_scan(*args)
    g = torch.as_tensor(np.random.default_rng(6).normal(size=tuple(ml.shape)),
                        dtype=torch.float32)
    before = (mlist_pairs.launches, mlist_pairs_backward.launches)
    got = mlist_pairs(*args)
    d_table, d_uv = mlist_pairs_backward(*args, got, g)
    assert (mlist_pairs.launches, mlist_pairs_backward.launches) == before, \
        "no kernel launch on the CPU"
    torch.testing.assert_close(got, ml, rtol=0, atol=0)
    want = mlist_only_scan_vjp(*args, g)
    # autograd's CPU scatter-adds sum in a varying order
    torch.testing.assert_close(d_table, want[0], rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(d_uv, want[1], rtol=1e-4, atol=1e-5)
    # only the quadratic columns of the table get gradient
    assert bool(d_table[:, :6].any()) and not bool(d_table[:, 6:].any())
