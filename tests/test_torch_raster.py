"""Kernel 1's plain version (texgs_torch.kernels.raster) and the port's
``rasterize_tiled`` against texgs's tiled rasterizer.

The JAX side runs as tests/test_pallas_raster.py runs it: its scan twin
(``backend="scan"``) and the Pallas kernel in interpret mode on the CPU
(``backend="pallas"``), on that file's scenes, and on projected Gaussians
whose tiles hold 1, 257 and 900 pairs.  Both packages get the same
numpy-seeded Gaussians.  Tolerances are that file's: forward atol 3e-5,
gradients atol 5e-4 / rtol 1e-3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from texgs.core.state import init_from_pcd as jax_init_from_pcd
from texgs.data.synthetic import blob_point_cloud
from texgs.data.synthetic import orbit_cameras as jax_orbit_cameras
from texgs.kernels import project as jproj
from texgs.kernels.tile_raster import rasterize_tiled as jax_rasterize_tiled
from tests.test_torch_kernels_cuda import opaque_stack_inputs
from texgs_torch.kernels import binning, project, tile_raster
from texgs_torch.kernels.raster import (NO_GRAD_COLS, raster_pairs,
                                        raster_pairs_backward, raster_scan,
                                        raster_scan_vjp)
from tests.torch_threads import one_thread  # noqa: F401

CHUNK = 64
BACKENDS = ["scan", "pallas"]


def scene(n=384, size=48, seed=3):
    """tests/test_pallas_raster.py's scene as numpy leaves + its camera."""
    pcd = blob_point_cloud(n, seed=seed)
    st = jax_init_from_pcd(pcd.points, pcd.colors, max_sh_degree=1)
    leaves = {k: np.asarray(getattr(st, k)) for k in (
        "xyz", "scaling", "rotation", "opacity", "features_dc",
        "features_rest")}
    return leaves, jax_orbit_cameras(1, radius=3.5, width=size, height=size)[0]


def jax_project(p, cam):
    xyz = p["xyz"]
    feats = jnp.concatenate([p["features_dc"], p["features_rest"]], axis=1)
    colors = jproj.sh_colors(feats, xyz, cam.camera_center, 1)
    rot = p["rotation"] / (jnp.linalg.norm(p["rotation"], axis=-1,
                                           keepdims=True) + 1e-12)
    return jproj.project_gaussians(
        xyz, jnp.exp(p["scaling"]), rot, jax.nn.sigmoid(p["opacity"]), colors,
        cam.world_view, cam.full_proj, cam.camera_center, cam.width,
        cam.height, cam.tanfovx, cam.tanfovy)


def torch_project(p, cam):
    feats = torch.cat([p["features_dc"], p["features_rest"]], dim=1)
    campos = torch.as_tensor(np.asarray(cam.camera_center))
    colors = project.sh_colors(feats, p["xyz"], campos, 1)
    rot = p["rotation"] / (torch.linalg.norm(p["rotation"], dim=-1,
                                             keepdim=True) + 1e-12)
    return project.project_gaussians(
        p["xyz"], torch.exp(p["scaling"]), rot, torch.sigmoid(p["opacity"]),
        colors, torch.as_tensor(np.asarray(cam.world_view)),
        torch.as_tensor(np.asarray(cam.full_proj)), campos, cam.width,
        cam.height, cam.tanfovx, cam.tanfovy)


@pytest.mark.parametrize("backend", BACKENDS)
def test_rasterize_tiled_matches_jax(backend):
    leaves, cam = scene()
    want = jax_rasterize_tiled(jax_project(
        {k: jnp.asarray(v) for k, v in leaves.items()}, cam), cam.height,
        cam.width, jnp.zeros(3), chunk=CHUNK, backend=backend)
    got = tile_raster.rasterize_tiled(
        torch_project({k: torch.as_tensor(v) for k, v in leaves.items()}, cam),
        cam.height, cam.width, torch.zeros(3))
    for name in ("image", "alpha", "depth", "norm"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)), atol=3e-5,
                                   err_msg=name)
    assert int(got.n_pairs) == int(want.n_pairs) > 0
    assert not bool(got.overflowed) and not bool(want.overflowed)


def test_raster_scan_matches_jax_tiles():
    """raster_scan's (T, PIX, F) tiles and T_final on the projected
    Gaussians of texgs itself, against texgs's scan-twin tiles."""
    from texgs.kernels import binning as jbin
    from texgs.kernels import tile_raster as jtr

    leaves, cam = scene()
    proj = jax_project({k: jnp.asarray(v) for k, v in leaves.items()}, cam)
    h, w = cam.height, cam.width
    jpairs = jbin.build_pairs(proj.means2d, proj.depths, proj.radii, h, w,
                              1 << 14, CHUNK)
    want = jtr.rasterize_scan(jtr.build_pair_attrs(proj, jpairs, h, w),
                              jpairs, h, w, CHUNK)
    tproj = project.ProjectedGaussians(*(torch.as_tensor(np.array(a))
                                         for a in proj))
    pairs = binning.build_pairs(tproj.means2d, tproj.depths, tproj.radii, h, w)
    got = raster_scan(tile_raster.build_gauss_table(tproj), pairs,
                      binning.grid_shape(h, w)[1])
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=3e-5)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), atol=3e-5)
    n_eval = got[2].numpy()
    assert n_eval.min() >= 0 and n_eval.max() <= int(pairs.tile_counts.max())
    assert (n_eval.sum(-1) > 0).any()


# tiles of the 48 x 48 frame (3 x 3 tiles) and the pairs each holds
COUNTED_TILES = {"diagonal": {0: 1, 4: 257, 8: 900},
                 "edge_row": {2: 900, 5: 1, 6: 257}}


def counted_scene(tiles, size=48, seed=7):
    """texgs ProjectedGaussians of a size x size frame in which tile t
    holds tiles[t] pairs: each Gaussian's mean lies 5..11 pixels into its
    tile and its radius is 3, so it covers that tile alone; random
    conics (sigma 1-4 pixels), depths, colours, opacities and normals."""
    from texgs.kernels.project import ProjectedGaussians

    rng = np.random.default_rng(seed)
    gx = size // 16
    tile = np.repeat(list(tiles), list(tiles.values()))
    n = tile.size
    corner = np.stack([tile % gx, tile // gx], -1) * 16.0
    sx, sy = rng.uniform(1.0, 4.0, size=(2, n))
    rho = rng.uniform(-0.5, 0.5, size=n)
    det = (sx * sy) ** 2 * (1 - rho ** 2)
    conics = np.stack([sy ** 2, -rho * sx * sy, sx ** 2], -1) / det[:, None]
    normals = rng.normal(size=(n, 3))
    leaves = (corner + rng.uniform(5.0, 11.0, size=(n, 2)),
              rng.uniform(1.0, 5.0, size=n), conics,
              np.full(n, 3, np.int32), rng.uniform(0.0, 1.0, size=(n, 3)),
              rng.uniform(0.05, 0.99, size=n),
              normals / np.linalg.norm(normals, axis=-1, keepdims=True))
    return ProjectedGaussians(*(jnp.asarray(a if a.dtype == np.int32
                                            else a.astype(np.float32))
                                for a in leaves))


def jax_scan_tiles(proj, h, w):
    """texgs's scan-twin tiles and T_final of the projected Gaussians."""
    from texgs.kernels import binning as jbin
    from texgs.kernels import tile_raster as jtr

    jpairs = jbin.build_pairs(proj.means2d, proj.depths, proj.radii, h, w,
                              1 << 14, CHUNK)
    return jtr.rasterize_scan(jtr.build_pair_attrs(proj, jpairs, h, w),
                              jpairs, h, w, CHUNK)


@pytest.mark.parametrize("layout", list(COUNTED_TILES))
def test_raster_scan_matches_jax_tiles_of_1_257_900_pairs(layout):
    """raster_scan against texgs's scan twin on tiles of 1, 257 and 900
    pairs (a batch of kernel 1 and one past it, and about the flagship's
    heaviest tile), the other tiles empty."""
    tiles = COUNTED_TILES[layout]
    proj = counted_scene(tiles)
    want = jax_scan_tiles(proj, 48, 48)
    tproj = project.ProjectedGaussians(*(torch.as_tensor(np.array(a))
                                         for a in proj))
    pairs = binning.build_pairs(tproj.means2d, tproj.depths, tproj.radii, 48,
                                48)
    counts = dict.fromkeys(range(9), 0) | tiles
    assert pairs.tile_counts.tolist() == [counts[t] for t in range(9)]
    got = raster_scan(tile_raster.build_gauss_table(tproj), pairs, 3)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=3e-5)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), atol=3e-5)
    n_eval = got[2].numpy()
    for t, n in counts.items():
        assert n_eval[t].max() <= n
        if n <= 1:
            assert (n_eval[t] == n).all()
    assert (n_eval[[t for t, n in tiles.items() if n == 900][0]] < 900).any()


@pytest.mark.parametrize("backend", BACKENDS)
def test_grads_match_jax(backend):
    """Every input gradient through the port's autograd (kernel 1' on CPU
    tensors is raster_scan_vjp) against jax.grad of texgs's backend."""
    leaves, cam = scene(n=256, size=32)
    names = ["xyz", "scaling", "rotation", "opacity", "features_dc"]
    target = np.zeros((3, cam.height, cam.width), np.float32)

    def jax_loss(*args):
        p = dict(leaves, **dict(zip(names, args)))
        out = jax_rasterize_tiled(jax_project(p, cam), cam.height, cam.width,
                                  jnp.zeros(3), chunk=CHUNK, backend=backend)
        return (jnp.abs(out.image - target).mean() + out.alpha.mean()
                + 0.01 * out.depth.mean() + 0.01 * out.norm.mean())

    want = jax.grad(jax_loss, argnums=tuple(range(5)))(
        *(jnp.asarray(leaves[k]) for k in names))

    p = {k: torch.as_tensor(v).requires_grad_(k in names)
         for k, v in leaves.items()}
    before = raster_pairs_backward.launches
    out = tile_raster.rasterize_tiled(torch_project(p, cam), cam.height,
                                      cam.width, torch.zeros(3))
    loss = ((out.image - torch.as_tensor(target)).abs().mean()
            + out.alpha.mean() + 0.01 * out.depth.mean()
            + 0.01 * out.norm.mean())
    got = torch.autograd.grad(loss, [p[k] for k in names])
    assert raster_pairs_backward.launches == before, "no launch on the CPU"
    for name, a, b in zip(names, got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=5e-4,
                                   rtol=1e-3, err_msg=f"grad mismatch: {name}")


def _table_inputs(n=256, size=32):
    leaves, cam = scene(n=n, size=size)
    proj = torch_project({k: torch.as_tensor(v) for k, v in leaves.items()},
                         cam)
    pairs = binning.build_pairs(proj.means2d, proj.depths, proj.radii,
                                cam.height, cam.width)
    return (tile_raster.build_gauss_table(proj), pairs,
            binning.grid_shape(cam.height, cam.width)[1])


def test_raster_scan_vjp_matches_autograd():
    table, pairs, gx = _table_inputs()
    rng = np.random.default_rng(1)
    blend, t_final, _ = raster_scan(table, pairs, gx)
    g_blend = torch.as_tensor(rng.normal(size=blend.shape), dtype=torch.float32)
    g_t = torch.as_tensor(rng.normal(size=t_final.shape), dtype=torch.float32)
    t = table.clone().requires_grad_(True)
    outs = raster_pairs(t, pairs, gx)
    (want,) = torch.autograd.grad(outs[:2], (t,), (g_blend, g_t))
    got = raster_scan_vjp(table, pairs, gx, g_blend, g_t)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    assert not bool(got[:, list(NO_GRAD_COLS)].any())
    assert float(got[:, :6].abs().max()) > 0 and float(got[:, 7:14].abs().max()) > 0


def test_empty_scene():
    """Everything behind the camera: no pairs, the background everywhere,
    and no gradient."""
    leaves, cam = scene(n=64, size=32)
    leaves["xyz"] = leaves["xyz"] + np.array([0.0, 0.0, 1e4], np.float32)
    p = {k: torch.as_tensor(v).requires_grad_(True) for k, v in leaves.items()}
    out = tile_raster.rasterize_tiled(torch_project(p, cam), cam.height,
                                      cam.width, torch.ones(3))
    np.testing.assert_allclose(out.image.detach().numpy(), 1.0, atol=1e-6)
    np.testing.assert_allclose(out.alpha.detach().numpy(), 0.0, atol=1e-6)
    assert int(out.n_pairs) == 0
    (g,) = torch.autograd.grad(out.image.sum() + out.alpha.sum(), [p["xyz"]],
                               allow_unused=True)
    assert g is None or not bool(g.any())


def test_nan_in_dead_entry_reaches_no_gradient():
    table, pairs, gx = opaque_stack_inputs()
    blend, t_final, n_eval = raster_scan(table, pairs, gx)
    assert bool(torch.isfinite(blend).all()) and bool((n_eval < 6).all())
    g = raster_scan_vjp(table, pairs, gx, torch.ones_like(blend),
                        torch.ones_like(t_final))
    assert bool(torch.isfinite(g).all())
    assert not bool(g[4:].any())
