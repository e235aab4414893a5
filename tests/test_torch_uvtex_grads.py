"""Gradients of the stage-3 render: the port's autograd through kernel A's
and kernel B's plain backward versions against texgs.

* The whole ``rasterize_uvtex`` (projection, tables, blend + M-lists,
  texture term, no-SH channels) against ``jax.grad`` of texgs's on its
  scan backend and on its fused Pallas kernel in interpret mode, with the
  exact texture term, for F = 7 and F = 10 blend channels; and the port's
  two-kernel path (``backend="pallas"``: kernels 1 and 2) against texgs's
  scan backend and its two-kernel Pallas path in interpret mode.  Tolerance: atol
  2e-3 of the leaf's max |grad|, as tests/test_uvtex_raster.py compares
  texgs's own backends; the scene is its well-conditioned soft-opacity
  one (opacities far from the 0.99 clamp).
* Kernel B's plain backward against ``jax.grad`` of texgs's exact
  ``mlist_tex_term`` (every filter mode) and of the interpret-mode Pallas
  ``tex_term_textile`` without its catch-all pack, on coherent M-lists
  whose footprints stay inside a face, at tests/test_textile.py's
  tolerances.
* Empty tiles and dead M-list slots: an empty tile passes no gradient, and
  a NaN cotangent on a dead slot reaches no gradient.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_textile import _random_mlist
from tests.test_torch_uvtex_fused import scene, torch_camera
from texgs.kernels import project as jproj
from texgs.kernels import uvtex_raster as juv
from texgs.kernels.pallas_textile import tex_term_textile
from texgs_torch.kernels import binning as tbin
from texgs_torch.kernels import project as tproj
from texgs_torch.kernels import tile_raster as ttr
from texgs_torch.kernels import uvtex_raster as tuv
from texgs_torch.kernels.tex_term import mlist_tex_term_vjp, tex_term
from texgs_torch.kernels.uvtex_fused import fused_pairs, mlist_scan_vjp
from tests.torch_threads import one_thread  # noqa: F401

BG = np.array([0.3, 0.2, 0.1], np.float32)
NAMES = ("xyz", "log_scaling", "rotation", "opacity", "uvs", "texture", "shs")


def _inputs(sc):
    rng = np.random.default_rng(11)
    return (sc["xyz"], np.log(sc["scaling"]).astype(np.float32),
            (sc["rotation"] + 0.05 * rng.normal(size=sc["rotation"].shape)
             ).astype(np.float32),
            np.full((sc["xyz"].shape[0], 1), 1.0, np.float32),
            sc["uvs"], sc["texture"], sc["shs"])


def _target(cam, seed=12):
    return np.random.default_rng(seed).uniform(
        size=(3, cam.height, cam.width)).astype(np.float32)


def jax_grads(sc, backend, with_no_sh, m):
    cam, jac = sc["cam"], jnp.asarray(sc["jac"])
    target = jnp.asarray(_target(cam))

    def loss(xyz, log_s, rot, op_raw, uvs, tex, shs):
        scaling = jnp.exp(log_s)
        rot = rot / jnp.linalg.norm(rot, axis=-1, keepdims=True)
        op = jax.nn.sigmoid(op_raw)
        proj = jproj.project_gaussians(
            xyz, scaling, rot, op, jnp.zeros_like(xyz), cam.world_view,
            cam.full_proj, cam.camera_center, cam.width, cam.height,
            cam.tanfovx, cam.tanfovy)
        out = juv.rasterize_uvtex(
            proj, scaling, rot, xyz, uvs, jac, tex, shs, 2, cam,
            jnp.asarray(BG), backend=backend, chunk=64, m=m,
            tex_backend="xla", with_no_sh=with_no_sh)
        total = (jnp.abs(out.image - target).mean() + 0.1 * out.alpha.mean()
                 + 0.01 * out.depth.mean() + 0.01 * out.norm.mean())
        if with_no_sh:
            total = total + 0.5 * jnp.abs(out.image_no_sh - target).mean()
        return total

    args = [jnp.asarray(a) for a in _inputs(sc)]
    return jax.grad(loss, argnums=tuple(range(7)))(*args)


def port_grads(sc, with_no_sh, m, backend="auto"):
    cam = torch_camera(sc["cam"])
    target = torch.as_tensor(_target(sc["cam"]))
    leaves = [torch.tensor(a, requires_grad=True) for a in _inputs(sc)]
    xyz, log_s, rot, op_raw, uvs, tex, shs = leaves
    scaling = torch.exp(log_s)
    rot = rot / torch.linalg.norm(rot, dim=-1, keepdim=True)
    op = torch.sigmoid(op_raw)
    t = torch.as_tensor
    proj = tproj.project_gaussians(
        xyz, scaling, rot, op, torch.zeros_like(xyz), t(cam.world_view),
        t(cam.full_proj), t(cam.camera_center), cam.width, cam.height,
        cam.tanfovx, cam.tanfovy)
    out = tuv.rasterize_uvtex(proj, scaling, rot, xyz, uvs,
                              t(sc["jac"]), tex, shs, 2, cam, t(BG), m=m,
                              with_no_sh=with_no_sh, backend=backend)
    total = ((out.image - target).abs().mean() + 0.1 * out.alpha.mean()
             + 0.01 * out.depth.mean() + 0.01 * out.norm.mean())
    if with_no_sh:
        total = total + 0.5 * (out.image_no_sh - target).abs().mean()
    total.backward()
    return [p.grad for p in leaves]


@functools.lru_cache(maxsize=None)
def _render_grads_jax(backend, with_no_sh):
    """jax_grads on the well-conditioned scene, once for both port paths."""
    return jax_grads(scene(n=192, size=32, opacity=2.0), backend, with_no_sh,
                     m=32)


@pytest.mark.parametrize("backend,port_backend", [
    ("scan", "auto"), ("fused", "auto"), ("scan", "pallas"),
    ("pallas", "pallas")],
    ids=["scan", "fused", "scan-port_pallas", "pallas-port_pallas"])
@pytest.mark.parametrize("with_no_sh", [False, True], ids=["F7", "F10"])
def test_render_grads_match_jax(backend, port_backend, with_no_sh):
    sc = scene(n=192, size=32, opacity=2.0)
    want = _render_grads_jax(backend, with_no_sh)
    got = port_grads(sc, with_no_sh, m=32, backend=port_backend)
    for name, a, b in zip(NAMES, want, got):
        a, b = np.asarray(a), b.numpy()
        assert np.isfinite(b).all(), name
        denom = np.abs(a).max() + 1e-8
        np.testing.assert_allclose(b / denom, a / denom, atol=2e-3,
                                   err_msg=f"grad mismatch: {name}")
    assert np.abs(got[5].numpy()).max() > 0, "the texture must get gradient"


def _mlist_cot(seed=5):
    return np.random.default_rng(seed).normal(size=(3, 32, 32)).astype(np.float32)


@pytest.mark.parametrize("filter_mode", ["bilinear", "bilinear_clamp", "nearest"])
def test_tex_term_vjp_matches_jax_twin(filter_mode):
    ml = np.array(_random_mlist(seed=0, coherent=False))
    tex = np.random.default_rng(4).uniform(size=(6, 16, 16, 3)).astype(np.float32)
    cot = _mlist_cot()
    g_ml_w, g_tex_w = jax.grad(
        lambda m_, t_: jnp.sum(juv.mlist_tex_term(m_, t_, 32, 32, filter_mode)
                               * cot), argnums=(0, 1))(jnp.asarray(ml),
                                                       jnp.asarray(tex))
    g_ml, g_tex = mlist_tex_term_vjp(torch.as_tensor(ml), torch.as_tensor(tex),
                                     torch.as_tensor(cot), 32, 32, filter_mode)
    np.testing.assert_allclose(g_tex.numpy(), np.asarray(g_tex_w), atol=3e-5,
                               rtol=1e-3)
    live = ml[..., 0] > 0
    np.testing.assert_allclose(g_ml.numpy()[live], np.asarray(g_ml_w)[live],
                               atol=3e-5, rtol=1e-3)


def test_tex_term_grads_match_jax_textile():
    """Through ``tex_term``'s autograd (its backward on the CPU is the plain
    VJP) against interpret-mode textile, catch-all off, on coherent lists
    whose bilinear footprints the windows serve (no miss)."""
    ml = _random_mlist(seed=0)
    tex = jnp.asarray(np.random.default_rng(4).uniform(
        size=(6, 64, 64, 3)).astype(np.float32))
    assert int(tex_term_textile(ml, tex, 32, 32, catch_size=0)[1]) == 0
    cot = _mlist_cot(6)
    g_ml_w, g_tex_w = jax.grad(
        lambda m_, t_: jnp.sum(tex_term_textile(m_, t_, 32, 32,
                                                catch_size=0)[0] * cot),
        argnums=(0, 1))(ml, tex)
    t_ml = torch.tensor(np.asarray(ml), requires_grad=True)
    t_tex = torch.tensor(np.asarray(tex), requires_grad=True)
    (tex_term(t_ml, t_tex, 32, 32) * torch.as_tensor(cot)).sum().backward()
    np.testing.assert_allclose(t_tex.grad.numpy(), np.asarray(g_tex_w),
                               atol=3e-5, rtol=1e-3)
    live = np.asarray(ml[..., 0]) > 0
    np.testing.assert_allclose(t_ml.grad.numpy()[live],
                               np.asarray(g_ml_w)[live], atol=3e-5, rtol=1e-3)
    # dead slots carry no uv cotangent
    assert not t_ml.grad.numpy()[~live][..., 1:].any()


def _kernel_a_args(sc, m=8):
    cam = sc["cam"]
    t = torch.as_tensor
    proj = tproj.project_gaussians(
        t(sc["xyz"]), t(sc["scaling"]), t(sc["rotation"]), t(sc["opacity"]),
        torch.zeros(sc["xyz"].shape), t(cam.world_view), t(cam.full_proj),
        t(cam.camera_center), cam.width, cam.height, cam.tanfovx, cam.tanfovy)
    pairs = tbin.build_pairs(proj.means2d, proj.depths, proj.radii,
                             cam.height, cam.width)
    tables = tuv.build_uvtex_tables(t(sc["xyz"]), t(sc["scaling"]),
                                    t(sc["rotation"]), t(sc["uvs"]),
                                    t(sc["jac"]), t(cam.camera_center))
    return (ttr.build_gauss_table(proj), tuv.build_uv_rows(tables), pairs,
            tuv.ray_constants(torch_camera(cam)),
            tbin.grid_shape(cam.height, cam.width)[1], m)


def test_empty_tiles_pass_no_gradient():
    """Emptying some tiles' pair ranges gives those tiles T = 1 and empty
    lists, and the gradient of the others' cotangents alone."""
    sc = scene(n=256, size=48, opacity=2.0)
    table, uv_rows, pairs, rays, gx, m = _kernel_a_args(sc)
    n_tiles = pairs.tile_counts.shape[0]
    empty = torch.arange(n_tiles) % 2 == 0
    cut = pairs._replace(tile_end=torch.where(empty, pairs.tile_start,
                                              pairs.tile_end),
                         tile_counts=torch.where(empty, 0, pairs.tile_counts))
    t = table.clone().requires_grad_(True)
    u = uv_rows.clone().requires_grad_(True)
    blend, t_final, mlist, n_eval = fused_pairs(t, u, cut, rays, gx, m)
    assert bool((t_final[empty] == 1).all()) and not bool(mlist[empty].any())
    assert not bool(blend[empty].any()) and not bool(n_eval[empty].any())
    rng = np.random.default_rng(3)
    cots = [torch.as_tensor(rng.normal(size=tuple(o.shape)), dtype=torch.float32)
            for o in (blend, t_final, mlist)]
    got = torch.autograd.grad((blend, t_final, mlist), (t, u), cots)
    # the full pair list with the emptied tiles' cotangents zeroed
    for c in cots:
        c[empty] = 0.0
    want = mlist_scan_vjp(table, uv_rows, pairs, rays, gx, m, *cots)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-6)


def test_nan_on_dead_slots_reaches_no_gradient():
    sc = scene(n=256, size=32, opacity=2.0)
    args = _kernel_a_args(sc, m=32)
    blend, t_final, mlist, _ = fused_pairs(*args)
    dead = mlist[..., 0] == 0
    assert bool(dead.any()) and bool((~dead).any())
    rng = np.random.default_rng(8)
    g_ml = torch.as_tensor(rng.normal(size=tuple(mlist.shape)), dtype=torch.float32)
    g_ml[dead] = float("nan")
    d_table, d_uv = mlist_scan_vjp(*args, torch.ones_like(blend),
                                   torch.ones_like(t_final), g_ml)
    assert bool(torch.isfinite(d_table).all()) and bool(torch.isfinite(d_uv).all())
