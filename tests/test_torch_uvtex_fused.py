"""Kernel A's plain version (texgs_torch.kernels.uvtex_fused.mlist_scan)
against texgs's fused blend + M-list pass.

The JAX side runs the Pallas kernel as texgs's own tests do, in interpret
mode on the CPU (``fused_pallas``), and its scan twins (``rasterize_scan``
+ ``mlist_scan``).  Both packages get the same projected Gaussians, made
from numpy-seeded inputs, so the comparison isolates the blend/M-list
semantics.  Scene: tests/test_uvtex_raster.py:48-57.  Tolerances: those of
tests/test_uvtex_raster.py:187-197, through the same
``assert_close_mostly`` (a tiny fraction of pixels may flip across the
alpha = 1/255 or T = 1e-4 thresholds, since the two packages round the
exponent differently in the last ulp).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_rasterizer import assert_close_mostly
from texgs.core.state import init_from_pcd as jax_init_from_pcd
from texgs.data.synthetic import blob_point_cloud
from texgs.data.synthetic import orbit_cameras as jax_orbit_cameras
from texgs.kernels import binning as jbin
from texgs.kernels import project as jproj
from texgs.kernels import tile_raster as jtr
from texgs.kernels import uvtex_raster as juv
from texgs.kernels.pallas_uvtex_fused import fused_pallas
from texgs_torch.core.camera import Camera
from texgs_torch.kernels import binning as tbin
from texgs_torch.kernels import tile_raster as ttr
from texgs_torch.kernels import uvtex_raster as tuv
from texgs_torch.kernels.project import ProjectedGaussians
from texgs_torch.kernels.uvtex_fused import fused_pairs, mlist_scan
from tests.torch_threads import one_thread  # noqa: F401

CHUNK = 64


def uv_jacobians(xyz):
    """Exact Jacobian of uv = xyz / |xyz| as (N, 9), numpy."""
    x = np.asarray(xyz, np.float64)
    r = np.linalg.norm(x, axis=-1, keepdims=True)
    eye = np.eye(3)[None]
    jac = eye / r[..., None] - x[:, :, None] * x[:, None, :] / r[..., None] ** 3
    return jac.reshape(-1, 9).astype(np.float32)


def scene(n=256, size=32, opacity=6.0, seed=7):
    """The uvtex test scene as numpy arrays: Gaussians on a blob, uv =
    normalize(xyz) with its exact Jacobian, residual SH, a smooth cubemap
    texture, one orbit camera (a texgs Camera)."""
    from tests.test_uvtex_raster import _texture

    pcd = blob_point_cloud(n, seed=seed)
    state = jax_init_from_pcd(pcd.points, pcd.colors, max_sh_degree=3)
    xyz = np.asarray(state.xyz)
    rng = np.random.default_rng(seed)
    return dict(
        xyz=xyz,
        scaling=np.exp(np.asarray(state.scaling)),
        rotation=np.asarray(state.rotation) / np.linalg.norm(
            np.asarray(state.rotation), axis=-1, keepdims=True),
        opacity=np.full((n, 1), 1.0 / (1.0 + np.exp(-opacity)), np.float32),
        uvs=(xyz / np.linalg.norm(xyz, axis=-1, keepdims=True)).astype(np.float32),
        jac=uv_jacobians(xyz),
        shs=(0.05 * rng.normal(size=(n, 15, 3))).astype(np.float32),
        texture=np.asarray(_texture()),
        cam=jax_orbit_cameras(1, radius=3.5, width=size, height=size)[0],
    )


def torch_camera(cam) -> Camera:
    """The port's Camera with the same matrices as a texgs Camera."""
    return Camera(world_view=np.asarray(cam.world_view),
                  full_proj=np.asarray(cam.full_proj),
                  camera_center=np.asarray(cam.camera_center),
                  width=cam.width, height=cam.height, fovx=cam.fovx,
                  fovy=cam.fovy)


def jax_project(sc):
    cam = sc["cam"]
    return jproj.project_gaussians(
        jnp.asarray(sc["xyz"]), jnp.asarray(sc["scaling"]),
        jnp.asarray(sc["rotation"]), jnp.asarray(sc["opacity"]),
        jnp.zeros_like(jnp.asarray(sc["xyz"])), cam.world_view, cam.full_proj,
        cam.camera_center, cam.width, cam.height, cam.tanfovx, cam.tanfovy)


def to_torch_proj(proj) -> ProjectedGaussians:
    return ProjectedGaussians(*(torch.as_tensor(np.array(a))
                                for a in proj))


def _run_both(sc, m, deg=2):
    """Both packages' fused pass on the same projected Gaussians (JAX's),
    with the no-SH channels appended (F = 10)."""
    cam = sc["cam"]
    h, w = cam.height, cam.width
    proj = jax_project(sc)
    base = juv.residual_sh_colors(jnp.asarray(sc["shs"]), jnp.asarray(sc["xyz"]),
                                  cam.camera_center, deg)
    proj = proj._replace(colors=base)
    extra = base - 0.5
    tables = juv.build_uvtex_tables(
        jnp.asarray(sc["xyz"]), jnp.asarray(sc["scaling"]),
        jnp.asarray(sc["rotation"]), jnp.asarray(sc["uvs"]),
        jnp.asarray(sc["jac"]), cam.camera_center)

    n = sc["xyz"].shape[0]
    pairs = jbin.build_pairs(proj.means2d, proj.depths, proj.radii, h, w,
                             max(4 * n, 1 << 14), CHUNK)
    attrs = jtr.build_pair_attrs(proj, pairs, h, w, extra)
    uv_rows = juv.build_uv_rows(tables, pairs)
    jax_fused = fused_pallas(attrs, uv_rows.T, pairs, cam, CHUNK, m)
    jax_scan = (*jtr.rasterize_scan(attrs, pairs, h, w, CHUNK),
                juv.mlist_scan(attrs, uv_rows, pairs, cam, CHUNK, m))

    tproj = to_torch_proj(proj)
    tpairs = tbin.build_pairs(tproj.means2d, tproj.depths, tproj.radii, h, w)
    table = ttr.build_gauss_table(tproj, torch.as_tensor(np.asarray(extra)))
    ttables = tuv.UVTexTables(*(torch.as_tensor(np.asarray(a)) for a in tables))
    tcam = torch_camera(cam)
    inputs = (table, tuv.build_uv_rows(ttables), tpairs,
              tuv.ray_constants(tcam), jbin.grid_shape(h, w)[1], m)
    return jax_fused, jax_scan, mlist_scan(*inputs), inputs


@pytest.fixture(scope="module", params=[8, 96], ids=["m8", "m96"])
def fused_runs(request):
    sc = scene()
    return request.param, _run_both(sc, request.param)


def _assert_blend(got, want, tag):
    tiles_got, tfin_got = got[0].numpy(), got[1].numpy()
    tiles_want, tfin_want = np.asarray(want[0]), np.asarray(want[1])
    assert tiles_got.shape == tiles_want.shape
    assert_close_mostly(tiles_got[..., 0:3], tiles_want[..., 0:3], atol=1e-4,
                        frac=0.995, hard_atol=3e-2, name=f"rgb[{tag}]")
    assert_close_mostly(tiles_got[..., 3], tiles_want[..., 3], atol=1e-4,
                        name=f"depth[{tag}]")
    assert_close_mostly(tiles_got[..., 4:7], tiles_want[..., 4:7], atol=3e-5,
                        name=f"norm[{tag}]")
    assert_close_mostly(tiles_got[..., 7:], tiles_want[..., 7:], atol=3e-5,
                        name=f"no_sh channels[{tag}]")
    assert_close_mostly(tfin_got, tfin_want, atol=3e-5, name=f"T_final[{tag}]")


def _assert_mlist(got, want, tag):
    got, want = got.numpy(), np.asarray(want)
    assert got.shape == want.shape
    # slot weights and unit uvs; a pixel whose contributor set flips at a
    # threshold shifts its later slots, hence the fraction
    assert_close_mostly(got[..., 0], want[..., 0], atol=3e-5, frac=0.995,
                        hard_atol=1.0, name=f"slot w[{tag}]")
    assert_close_mostly(got[..., 1:], want[..., 1:], atol=1e-4, frac=0.995,
                        hard_atol=2.0, name=f"slot uv[{tag}]")
    live_got, live_want = got[..., 0] > 0, want[..., 0] > 0
    assert (live_got == live_want).mean() >= 0.999, f"slot occupancy[{tag}]"


def test_plain_matches_jax_fused_pallas_blend(fused_runs):
    m, (jax_fused, _, ours, _) = fused_runs
    _assert_blend(ours, jax_fused, f"fused m={m}")


def test_plain_matches_jax_fused_pallas_mlist(fused_runs):
    m, (jax_fused, _, ours, _) = fused_runs
    _assert_mlist(ours[2], jax_fused[2], f"fused m={m}")


def test_plain_matches_jax_scan_twins(fused_runs):
    m, (_, jax_scan, ours, _) = fused_runs
    _assert_blend(ours, jax_scan, f"scan m={m}")
    _assert_mlist(ours[2], jax_scan[2], f"scan m={m}")


def test_mlist_fills_slots_in_order(fused_runs):
    """Occupied slots are a prefix of each list, every weight lies in
    (0, 1], and slot uvs are unit vectors."""
    m, (_, _, ours, _) = fused_runs
    ml = ours[2].numpy()
    live = ml[..., 0] > 0
    count = live.sum(-1)
    assert (live == (np.arange(m)[None, None] < count[..., None])).all()
    assert ml[..., 0].max() <= 1.0 and ml[..., 0].min() >= 0.0
    norms = np.linalg.norm(ml[..., 1:], axis=-1)[live]
    np.testing.assert_allclose(norms, 1.0, atol=1e-5)


def sequential_pixel(table, uv_rows, pairs, rays, gx, m, tile, pix):
    """The kernel's per-pixel loop written out literally, in float32:
    (blend channels, T, M-list, pairs evaluated) of one pixel."""
    f32 = np.float32
    tab, uvr = table.numpy(), uv_rows.numpy()
    x, y = f32(pix % 16), f32(pix // 16)
    tile_x, tile_y = f32(tile % gx * 16), f32(tile // gx * 16)
    d = rays[2] + (tile_x + x) * rays[0] + (tile_y + y) * rays[1]
    start, end = int(pairs.tile_start[tile]), int(pairs.tile_end[tile])
    acc = np.zeros(tab.shape[1] - 9, f32)
    t, count, evals = f32(1.0), 0, 0
    mlist = np.zeros((m, 4), f32)
    for j in range(start, end):
        g = int(pairs.pair_gauss[j])
        q = ttr.shift_to_tile(torch.as_tensor(tab[g]), torch.tensor(tile_x),
                              torch.tensor(tile_y)).numpy()
        power = (x * x * q[0] + y * y * q[1] + x * y * q[2] + x * q[3]
                 + y * q[4] + q[5])
        alpha = min(f32(np.exp(power)), f32(0.99))
        if power - tab[g, 6] > 0 or alpha < f32(1 / 255):
            alpha = f32(0.0)
        evals += 1
        t_next = t * (f32(1) - alpha)
        if t_next < f32(1e-4):
            break
        w = alpha * t
        acc += w * np.concatenate([tab[g, 7:14], tab[g, 16:]])
        t = t_next
        if w > 0:
            if count < m:
                uv = tuv.intersect_uv(torch.as_tensor(d), torch.as_tensor(uvr[g]))
                mlist[count] = [w, *uv.numpy()]
            count += 1
    return acc, t, mlist, evals


def test_plain_matches_sequential_loop(fused_runs):
    """mlist_scan's chunked, tile-batched math equals the kernel's literal
    per-pixel loop (stop rule, accepted entries, slot order, n_eval) on a
    sample of pixels, to float32 rounding."""
    m, (_, _, ours, inputs) = fused_runs
    rng = np.random.default_rng(0)
    covered = np.nonzero(ours[1].numpy() < 1.0)
    pick = rng.choice(len(covered[0]), size=24, replace=False)
    for tile, pix in zip(covered[0][pick], covered[1][pick]):
        acc, t, mlist, evals = sequential_pixel(*inputs, tile, pix)
        np.testing.assert_allclose(ours[0][tile, pix].numpy(), acc,
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(float(ours[1][tile, pix]), t, rtol=1e-5,
                                   atol=1e-7)
        np.testing.assert_allclose(ours[2][tile, pix].numpy(), mlist,
                                   rtol=1e-5, atol=1e-6)
        assert int(ours[3][tile, pix]) == evals


def test_smoke_exact_uv_route_refuses_a_turned_uv(fused_runs):
    """chip_smoke.py's exact-uv route of check_kernel_a takes the plain
    version's own M-lists, and refuses them with 40 slots' uv turned by
    0.02 rad (the control phase 24 runs on the card)."""
    import chip_smoke

    m, (_, _, ours, inputs) = fused_runs
    exact_uv = chip_smoke.exact_uv_check(torch, inputs)
    chip_smoke.check_kernel_a(torch, ours, ours, exact_uv)
    chip_smoke.exact_uv_control(torch, ours, ours, exact_uv)


def test_smoke_intersect_error_bound_holds(fused_runs):
    """chip_smoke.intersect_error_bound bounds the float32 intersect_uv's
    distance from the float64 one, for every pixel of each tile against
    every Gaussian of that tile, taking the float32 rays as exact."""
    import chip_smoke
    from texgs_torch.kernels.uvtex_fused import _tile_rays

    m, (_, _, _, inputs) = fused_runs
    _, uv_rows, pairs, rays, gx, _ = inputs
    n_tiles = pairs.tile_counts.numel()
    _, _, d = _tile_rays(rays, n_tiles, gx, "cpu")
    checked = 0
    for t in range(n_tiles):
        g = pairs.pair_gauss[int(pairs.tile_start[t]):
                             int(pairs.tile_end[t])].long()
        if g.numel() == 0:
            continue
        rows = uv_rows[g][None].expand(d.shape[1], -1, -1).reshape(
            -1, uv_rows.shape[1])
        dt = d[t][:, None].expand(-1, g.numel(), -1).reshape(-1, 3)
        f32 = tuv.intersect_uv(dt, rows).double()
        f64 = tuv.intersect_uv(dt.double(), rows.double())
        bound = chip_smoke.intersect_error_bound(
            torch, dt.double(), rows.double(), torch.zeros_like(f64))
        err = (f32 - f64).abs().max(-1).values
        assert bool(torch.isfinite(bound).all())
        assert bool((err <= bound).all()), float((err - bound).max())
        checked += err.numel()
    assert checked > 0


def test_wrapper_takes_plain_version_on_cpu():
    sc = scene(n=128, size=32)
    cam = sc["cam"]
    tproj = to_torch_proj(jax_project(sc))
    tpairs = tbin.build_pairs(tproj.means2d, tproj.depths, tproj.radii,
                              cam.height, cam.width)
    table = ttr.build_gauss_table(tproj)
    ttables = tuv.build_uvtex_tables(*(torch.as_tensor(sc[k]) for k in (
        "xyz", "scaling", "rotation", "uvs", "jac")),
        torch.as_tensor(np.asarray(cam.camera_center)))
    args = (table, tuv.build_uv_rows(ttables), tpairs,
            tuv.ray_constants(torch_camera(cam)), 2, 16)
    before = fused_pairs.launches
    got = fused_pairs(*args)
    want = mlist_scan(*args)
    assert fused_pairs.launches == before, "no kernel launch on the CPU"
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("m_tail", [False, True], ids=["m8", "m8_tail"])
def test_rasterize_uvtex_matches_jax(m_tail):
    """The port's whole rasterize_uvtex (its own projection and binning,
    the one-pass no-SH image, the optional m-tail term) against texgs's on
    its scan backend with the exact texture term, at a truncating m = 8."""
    from texgs_torch.kernels.project import project_gaussians

    sc = scene(n=192, size=32, opacity=2.0)
    cam = sc["cam"]
    bg = np.array([0.3, 0.2, 0.1], np.float32)
    keys = ("xyz", "scaling", "rotation", "uvs", "jac", "texture", "shs")
    xyz, scaling, rotation, uvs, jac, tex, shs = (sc[k] for k in keys)
    want = juv.rasterize_uvtex(
        jax_project(sc), jnp.asarray(scaling), jnp.asarray(rotation),
        jnp.asarray(xyz), jnp.asarray(uvs), jnp.asarray(jac), jnp.asarray(tex),
        jnp.asarray(shs), 2, cam, jnp.asarray(bg), backend="scan",
        chunk=CHUNK, m=8, tex_backend="xla", with_no_sh=True, m_tail=m_tail)

    def t(a):
        return torch.as_tensor(np.array(a))

    tproj = project_gaussians(
        t(xyz), t(scaling), t(rotation), t(sc["opacity"]), torch.zeros(192, 3),
        t(cam.world_view), t(cam.full_proj), t(cam.camera_center), cam.width,
        cam.height, cam.tanfovx, cam.tanfovy)
    got = tuv.rasterize_uvtex(
        tproj, t(scaling), t(rotation), t(xyz), t(uvs), t(jac), t(tex), t(shs),
        2, torch_camera(cam), t(bg), m=8, with_no_sh=True, m_tail=m_tail)
    for name, atol, frac, hard in (("image", 1e-4, 0.995, 3e-2),
                                   ("image_no_sh", 1e-4, 0.995, 3e-2),
                                   ("alpha", 3e-5, 0.999, 5e-3),
                                   ("depth", 1e-4, 0.999, 5e-3),
                                   ("norm", 3e-5, 0.999, 5e-3)):
        assert_close_mostly(getattr(got, name).numpy(),
                            np.asarray(getattr(want, name)), atol=atol,
                            frac=frac, hard_atol=hard, name=name)
    assert got.extra is None and want.extra is None
    assert int(got.n_pairs) == int(want.n_pairs)
    assert not bool(got.overflowed)
