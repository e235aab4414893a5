"""texgs_torch's CUDA kernels against their plain PyTorch versions.

This file imports the port only (no JAX), so it also runs on the GPU
machine, where the kernels are built and launched:

    python -m pytest -p no:cacheprovider -n 0 -m cuda tests/test_torch_kernels_cuda.py

Tests marked ``cuda`` skip on a machine without an NVIDIA GPU.  The
unmarked tests check the wrappers' CPU rule there: on CPU tensors a wrapper
runs its plain version and launches nothing.

Tolerances: kernel B picks texels with explicitly rounded arithmetic, so
it matches its plain version to f32 rounding of the weighted sums
(atol 2e-5, rtol 1e-4).  Kernel A rounds its exponent in the plain
version's order, but its running product T rounds differently from the
plain version's chunked cumprod, so a pixel whose T lands within an ulp
of the T = 1e-4 stop may stop one Gaussian apart: at most 4 pixels of a
frame may differ beyond atol 1e-5 / rtol 1e-4, and no blend channel,
T_final or slot weight by more than 0.05.

The backward kernels sum each Gaussian's gradient over pixels with
atomics, in an order that changes from run to run.  A' is compared per
column group (quad, channels, uv rows) at atol 1e-3 max|plain| + rtol
1e-3, with at most 4 Gaussians beyond (the stop flips above move whole
entries); B' at tests/test_textile.py's tolerances (d texture 1e-5 +
1e-3 |x|, live-slot d M-lists 3e-5 + 1e-3 |x|); the hash gather exactly.
The fused hash encode K5' picks its corners and weights exactly as its
plain version does (compared bit for bit) and sums them at atol 1e-6 /
rtol 1e-5.  Its backward K5'' adds the table gradient with atomics, at
1e-5 + 1e-4 |x|; the point gradient sums levels in another order than the
plain version, and its terms (res_l g . row, ~10^3 at a table in [-1, 1])
cancel, so it is held at tests/test_hashgrid.py's query tolerance, 1e-4 +
1e-4 |x|.
The viewer's maps kernel (csrc/cubemap_maps.cu) writes the cross image
bit for bit as its plain version and picks the panorama's texels with
kernel B's explicitly rounded helpers, blending in the plain version's
order and rounding as it does on CUDA tensors: the panorama is held at
atol 1e-6 on texels of contrast ~1, so a tap that read another texel
with a weight above ~1e-6 would show.
Kernels 1 and 1' (the stage-1/2 blend, and the two-kernel stage-3 blend at
F = 10) are held as A and A' are, without the M-list and uv rows; kernels
2 and 2' (the two-kernel stage-3 M-lists) as A and A' are, without the
blend channels.
The projection's kernel P (csrc/project.cu) rounds the plain chain's
elementwise operations one at a time in its order: means2d and depths are
held at 1e-6 of their largest value + 1e-6 |x|, normals at 1e-6 (a
quaternion norm summed in another order), the culled opacities and the
visible set exactly; a radius may differ by one only where 3 sqrt(lambda1)
rounds across an integer, and the differing radii are counted.  A conic
inverts a 2x2 covariance whose determinant cancels for a disc seen edge
on, so two float32 orders part by about as much as either parts from
float64: each Gaussian's conic may lie from the plain chain's by twice the
plain chain's own largest distance from its float64 evaluation (relative
to the conic's norm).  P' (csrc/project_bwd.cu) is held against autograd
through the plain chain at 1e-5 max|x| + 1e-4 |x| on the Gaussians whose
det is well conditioned ((|ac| + b^2) / |det| <= 10, or det = 0), and on
all within twice autograd's own largest distance from float64, + 1e-5 of
the largest gradient.
"""

import math

import numpy as np
import pytest
import torch

from texgs_torch.core.state import init_from_pcd
from texgs_torch.data.synthetic import (orbit_cameras,
                                        textured_sphere_point_cloud)
from texgs_torch.kernels import binning, project, tile_raster, uvtex_raster
from texgs_torch.kernels.cubemap import (cubemap_maps, cubemap_to_latlong,
                                         direction_to_face_uv, faces_to_cross)
from texgs_torch.kernels.tex_term import (mlist_tex_term, mlist_tex_term_vjp,
                                          tex_term, tex_term_backward)
from texgs_torch.kernels.uvtex_fused import (fused_pairs, fused_pairs_backward,
                                             mlist_scan, mlist_scan_vjp)
from texgs_torch.kernels.raster import (raster_pairs, raster_pairs_backward,
                                        raster_scan, raster_scan_vjp)
from texgs_torch.kernels.uvtex_mlist import (mlist_only_scan,
                                             mlist_only_scan_vjp, mlist_pairs,
                                             mlist_pairs_backward)
from texgs_torch.nets.hash_gather import gather_plain, hash_gather
from texgs_torch.nets.hash_encode import (encode_backward_plain, encode_plain,
                                          hash_encode, hash_encode_backward,
                                          hash_encode_forward,
                                          indices_and_weights,
                                          level_resolution)
from texgs_torch.utils.sh import sh02rgb


# the suite runs in several xdist workers at once: torch's default of
# a thread a core in each slows every worker many times over
@pytest.fixture(autouse=True, scope="module")
def two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cuda_device():
    """The GPU for tests marked ``cuda``; they skip on a machine without
    one (the CPU tier-1 run) and run on the GPU machine."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel, no CPU mode)")
    return torch.device("cuda")


def kernel_a_inputs(n=3000, width=80, height=64, m=32, seed=0, n_extra=3):
    """Kernel A's inputs for one view of a textured sphere (CPU tensors):
    (table, uv_rows, pairs, rays, gx, m), with F = 7 + n_extra blend
    channels."""
    pcd = textured_sphere_point_cloud(n, seed=seed)
    st = init_from_pcd(pcd.points, pcd.colors, 3, device="cpu")
    cam = orbit_cameras(1, radius=3.5, width=width, height=height)[0]
    rng = np.random.default_rng(seed)
    xyz = st.xyz
    scaling = torch.exp(st.scaling)
    rot = st.rotation
    opacity = torch.full((n, 1), 0.6)
    shs = torch.as_tensor(0.05 * rng.normal(size=(n, 15, 3)), dtype=torch.float32)
    uvs = xyz / torch.linalg.norm(xyz, dim=-1, keepdim=True)
    jac = torch.as_tensor(rng.normal(size=(n, 9)) * 0.3, dtype=torch.float32)
    campos = torch.as_tensor(cam.camera_center)
    proj = project.project_gaussians(
        xyz, scaling, rot, opacity, torch.zeros_like(xyz),
        torch.as_tensor(cam.world_view), torch.as_tensor(cam.full_proj),
        campos, width, height, cam.tanfovx, cam.tanfovy)
    base = uvtex_raster.residual_sh_colors(shs, xyz, campos, 3)
    proj = proj._replace(colors=base)
    extra = torch.as_tensor(rng.normal(size=(n, n_extra)), dtype=torch.float32)
    table = tile_raster.build_gauss_table(proj, extra if n_extra else None)
    uv_rows = uvtex_raster.build_uv_rows(uvtex_raster.build_uvtex_tables(
        xyz, scaling, rot, uvs, jac, campos))
    pairs = binning.build_pairs(proj.means2d, proj.depths, proj.radii,
                                height, width)
    return (table, uv_rows, pairs, uvtex_raster.ray_constants(cam),
            binning.grid_shape(height, width)[1], m)


def random_mlist(n_tiles, m, seed=0, edges=False):
    """(n_tiles, 256, m, 4) M-lists with random weights (some zero) and
    directions, or directions on cube edges and corners."""
    rng = np.random.default_rng(seed)
    n = n_tiles * 256 * m
    if edges:
        d = rng.choice([-1.0, 1.0], size=(n, 3))
        edge = rng.uniform(size=n) < 0.5
        free = rng.integers(0, 3, size=n)
        d[edge, free[edge]] = rng.uniform(-1, 1, size=edge.sum())
        d += rng.normal(scale=10.0 ** rng.uniform(-6, -2, size=(n, 1)),
                        size=(n, 3))
    else:
        d = rng.normal(size=(n, 3))
    w = rng.uniform(0.0, 0.3, size=(n, 1)) * (rng.uniform(size=(n, 1)) < 0.7)
    ml = np.concatenate([w, d], axis=1).astype(np.float32)
    return torch.as_tensor(ml).reshape(n_tiles, 256, m, 4)


def random_texture(res, seed=1):
    rng = np.random.default_rng(seed)
    return torch.as_tensor(rng.uniform(-1.5, 1.5, size=(6, res, res, 3)),
                           dtype=torch.float32)


def _pairs_to(dev, pairs):
    return binning.PairList(*(None if t is None else t.to(dev) for t in pairs))


def _to(dev, args):
    table, uv_rows, pairs, rays, gx, m = args
    return (table.to(dev), uv_rows.to(dev),
            _pairs_to(dev, pairs), rays, gx, m)


def test_fused_wrapper_runs_plain_version_on_cpu():
    args = kernel_a_inputs(n=600, width=48, height=32)
    before = fused_pairs.launches
    got = fused_pairs(*args)
    want = mlist_scan(*args)
    assert fused_pairs.launches == before
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("mode", ["bilinear", "nearest", "bilinear_clamp"])
def test_tex_term_wrapper_runs_plain_version_on_cpu(mode):
    ml = random_mlist(9, 8)
    tex = random_texture(16)
    before = tex_term.launches
    got = tex_term(ml, tex, 40, 48, mode)
    assert tex_term.launches == before
    torch.testing.assert_close(got, mlist_tex_term(ml, tex, 40, 48, mode),
                               rtol=0, atol=0)


@pytest.mark.cuda
def test_fused_wrapper_rejects_too_many_channels(cuda_device):
    args = _to(cuda_device, kernel_a_inputs(n=200, n_extra=10))
    with pytest.raises(ValueError, match="blend channels"):
        fused_pairs(*args)


@pytest.mark.cuda
def test_fused_wrapper_rejects_channels_off_the_path(cuda_device):
    """The kernel is built for the stage-3 path's F = 7 and F = 10 only."""
    args = _to(cuda_device, kernel_a_inputs(n=200, n_extra=1))
    with pytest.raises(ValueError, match="blend channels"):
        fused_pairs(*args)


def test_tex_term_rejects_unknown_filter_mode():
    with pytest.raises(ValueError):
        tex_term(random_mlist(4, 2), random_texture(8), 32, 32, "trilinear")


def _pixels_off(got, want):
    """Pixels where kernel A and its plain version disagree: a blend
    channel, T_final or M-list value beyond atol 1e-5 (1e-6 for T) +
    rtol 1e-4, or a different n_eval."""
    def beyond(g, w, atol):
        return (g - w).abs() > atol + 1e-4 * w.abs()

    return int((beyond(got[0], want[0], 1e-5).any(-1)
                | beyond(got[1], want[1], 1e-6)
                | beyond(got[2], want[2], 1e-5).flatten(2).any(-1)
                | (got[3] != want[3])).sum())


@pytest.mark.cuda
@pytest.mark.parametrize("m,n_extra", [(8, 3), (32, 3), (32, 0), (5, 3)])
def test_fused_kernel_matches_plain(cuda_device, m, n_extra):
    args = _to(cuda_device, kernel_a_inputs(m=m, n_extra=n_extra))
    before = fused_pairs.launches
    got = fused_pairs(*args)
    torch.cuda.synchronize()
    assert fused_pairs.launches == before + 1
    want = mlist_scan(*args)
    assert _pixels_off(got, want) <= 4
    for a, b in ((got[0], want[0]), (got[1], want[1]),
                 (got[2][..., 0], want[2][..., 0])):
        assert (a - b).abs().max().item() <= 0.05


@pytest.mark.cuda
def test_fused_kernel_empty_scene(cuda_device):
    """No pairs at all: every pixel keeps T = 1 and an empty list."""
    table, uv_rows, pairs, rays, gx, m = _to(cuda_device, kernel_a_inputs())
    empty = binning.PairList(
        pairs.pair_gauss[:0], pairs.pair_tile[:0],
        torch.zeros_like(pairs.tile_start), torch.zeros_like(pairs.tile_end),
        torch.zeros_like(pairs.tile_counts), pairs.n_pairs * 0,
        pairs.overflowed)
    blend, t_final, mlist, n_eval = fused_pairs(table, uv_rows, empty, rays,
                                                gx, m)
    assert bool((blend == 0).all()) and bool((t_final == 1).all())
    assert bool((mlist == 0).all()) and bool((n_eval == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["bilinear", "nearest", "bilinear_clamp"])
@pytest.mark.parametrize("edges", [False, True], ids=["random", "edges"])
@pytest.mark.parametrize("res", [8, 64])
def test_tex_term_kernel_matches_plain(cuda_device, mode, edges, res):
    ml = random_mlist(12, 16, seed=res, edges=edges).to(cuda_device)
    tex = random_texture(res).to(cuda_device)
    before = tex_term.launches
    got = tex_term(ml, tex, 48, 64, mode)
    torch.cuda.synchronize()
    assert tex_term.launches == before + 1
    want = mlist_tex_term(ml, tex, 48, 64, mode)
    torch.testing.assert_close(got, want, atol=2e-5, rtol=1e-4)


# live slots a pixel of live_count_mlist, capped at m
LIVE_COUNTS = (0, 1, 31)


def live_count_mlist(n_tiles, m, seed=0, edges=False):
    """(n_tiles, 256, m, 4) M-lists whose pixels hold 0, 1, 31 or m live
    slots (capped at m; drawn per pixel), a prefix of each list as kernels
    A and 2 write them; the dead slots keep random_mlist's directions with
    w = 0.  Returns (M-lists, (n_tiles, 256, m) bool live mask)."""
    ml = random_mlist(n_tiles, m, seed=seed, edges=edges)
    rng = np.random.default_rng(seed + 100)
    counts = np.array(LIVE_COUNTS + (m,))[
        rng.integers(0, len(LIVE_COUNTS) + 1, size=(n_tiles, 256, 1))]
    live = torch.as_tensor(np.arange(m) < np.minimum(counts, m))
    w = torch.as_tensor(rng.uniform(0.01, 0.3, size=(n_tiles, 256, m)),
                        dtype=torch.float32)
    ml[..., 0] = torch.where(live, w, 0.0)
    return ml, live


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["bilinear", "nearest", "bilinear_clamp"])
@pytest.mark.parametrize("edges", [False, True], ids=["random", "edges"])
@pytest.mark.parametrize("m", [1, 4, 32, 33, 300])
def test_tex_term_kernel_where_warps_straddle_pixels(cuda_device, m, edges,
                                                      mode):
    """Kernel B runs one thread per slot and sums a pixel's slots over its
    lanes: at m = 1, 4 and 33 a warp holds slots of several pixels, at 33
    a pixel spans two warps, at 300 two rounds of the block.  Pixels hold
    0, 1, 31 or m live slots, the 40 x 56 frame has partial edge tiles, and
    NaN written into every dead slot's uv changes no output bit."""
    ml, live = live_count_mlist(12, m, seed=m, edges=edges)
    ml, live = ml.to(cuda_device), live.to(cuda_device)
    tex = random_texture(16).to(cuda_device)
    before = tex_term.launches
    got = tex_term(ml, tex, 40, 56, mode)
    torch.cuda.synchronize()
    assert tex_term.launches == before + 1
    torch.testing.assert_close(got, mlist_tex_term(ml, tex, 40, 56, mode),
                               atol=2e-5, rtol=1e-4)
    nan = ml.clone()
    nan[..., 1:][~live] = float("nan")
    got_nan = tex_term(nan, tex, 40, 56, mode)
    assert bool(torch.isfinite(got_nan).all())
    assert torch.equal(got_nan, got)


def kernel_a_cotangents(outputs, seed=2):
    """Seeded random cotangents of kernel A's blend, T_final and M-lists,
    on their device."""
    rng = np.random.default_rng(seed)
    return tuple(torch.as_tensor(rng.normal(size=tuple(t.shape)),
                                 dtype=torch.float32, device=t.device)
                 for t in outputs[:3])


def test_fused_backward_runs_plain_version_on_cpu():
    args = kernel_a_inputs(n=600, width=48, height=32, m=8)
    outs = mlist_scan(*args)
    cots = kernel_a_cotangents(outs)
    before = fused_pairs_backward.launches
    got = fused_pairs_backward(*args, *outs[:3], *cots)
    assert fused_pairs_backward.launches == before
    # autograd's CPU scatter-adds sum in a varying order
    for a, b in zip(got, mlist_scan_vjp(*args, *cots)):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)


def test_tex_term_backward_runs_plain_version_on_cpu():
    ml, tex = random_mlist(9, 8), random_texture(16)
    g = torch.as_tensor(np.random.default_rng(3).normal(size=(3, 40, 48)),
                        dtype=torch.float32)
    before = tex_term_backward.launches
    got = tex_term_backward(ml, tex, g, 40, 48)
    assert tex_term_backward.launches == before
    for a, b in zip(got, mlist_tex_term_vjp(ml, tex, g, 40, 48)):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)


def hash_inputs(levels=8, size=4096, feats=4, n=8192, seed=4):
    rng = np.random.default_rng(seed)
    table = torch.as_tensor(rng.uniform(-1, 1, size=(levels, size, feats)),
                            dtype=torch.float32)
    idx = torch.as_tensor(rng.integers(0, size, size=(levels * 8, n)),
                          dtype=torch.int32)
    return table, idx


def test_hash_gather_runs_plain_version_on_cpu():
    table, idx = hash_inputs(levels=2, size=256, n=100)
    before = hash_gather.launches
    got = hash_gather(table, idx)
    assert hash_gather.launches == before
    torch.testing.assert_close(got, gather_plain(table, idx), rtol=0, atol=0)


def assert_a_backward_close(got, want, max_off=4):
    """Kernel A' against its plain version: per column group, atol 1e-3
    of the group's max |plain| + rtol 1e-3, at most max_off Gaussians
    beyond."""
    (d_table, d_uv), (d_table_w, d_uv_w) = got, want
    groups = {"quad": (d_table[:, :6], d_table_w[:, :6]),
              "channels": (torch.cat([d_table[:, 7:14], d_table[:, 16:]], 1),
                           torch.cat([d_table_w[:, 7:14], d_table_w[:, 16:]], 1)),
              "uv rows": (d_uv[:, :12], d_uv_w[:, :12])}
    for name, (g, w) in groups.items():
        assert bool(torch.isfinite(g).all()), name
        tol = 1e-3 * w.abs().max() + 1e-3 * w.abs()
        off = int(((g - w).abs() > tol).any(-1).sum())
        assert off <= max_off, f"{name}: {off} Gaussians beyond tolerance"
    # columns the kernel leaves at zero
    assert not bool(d_table[:, [6, 14, 15]].any()) and not bool(d_uv[:, 12:].any())


@pytest.mark.cuda
@pytest.mark.parametrize("m,n_extra", [(8, 3), (32, 3), (32, 0), (4, 0),
                                       (4, 3)])
def test_fused_backward_kernel_matches_plain(cuda_device, m, n_extra):
    """At m = 4 most entries fall past each pixel's list, so A' reduces the
    uv columns only for warps where some lanes hold the pair in their list
    (F = 7 and F = 10)."""
    args = _to(cuda_device, kernel_a_inputs(m=m, n_extra=n_extra))
    outs = fused_pairs(*args)
    cots = kernel_a_cotangents(outs)
    before = fused_pairs_backward.launches
    got = fused_pairs_backward(*args, *outs[:3], *cots)
    torch.cuda.synchronize()
    assert fused_pairs_backward.launches == before + 1
    assert_a_backward_close(got, mlist_scan_vjp(*args, *cots))


@pytest.mark.cuda
def test_fused_backward_through_autograd(cuda_device):
    """fused_pairs' backward launches kernel A' once and agrees with
    autograd through the plain version."""
    table, uv_rows, pairs, rays, gx, m = _to(cuda_device, kernel_a_inputs())
    t = table.clone().requires_grad_(True)
    u = uv_rows.clone().requires_grad_(True)
    outs = fused_pairs(t, u, pairs, rays, gx, m)
    cots = kernel_a_cotangents(outs, seed=7)
    before = fused_pairs_backward.launches
    got = torch.autograd.grad(outs[:3], (t, u), cots)
    assert fused_pairs_backward.launches == before + 1
    assert_a_backward_close(got, mlist_scan_vjp(table, uv_rows, pairs, rays,
                                                gx, m, *cots))


@pytest.mark.cuda
def test_fused_backward_kernel_empty_scene(cuda_device):
    table, uv_rows, pairs, rays, gx, m = _to(cuda_device, kernel_a_inputs())
    empty = binning.PairList(
        pairs.pair_gauss[:0], pairs.pair_tile[:0],
        torch.zeros_like(pairs.tile_start), torch.zeros_like(pairs.tile_end),
        torch.zeros_like(pairs.tile_counts), pairs.n_pairs * 0,
        pairs.overflowed)
    outs = fused_pairs(table, uv_rows, empty, rays, gx, m)
    d_table, d_uv = fused_pairs_backward(table, uv_rows, empty, rays, gx, m,
                                         *outs[:3], *kernel_a_cotangents(outs))
    assert not bool(d_table.any()) and not bool(d_uv.any())


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["bilinear", "nearest", "bilinear_clamp"])
@pytest.mark.parametrize("edges", [False, True], ids=["random", "edges"])
@pytest.mark.parametrize("res", [8, 64])
def test_tex_term_backward_kernel_matches_plain(cuda_device, mode, edges, res):
    ml = random_mlist(12, 16, seed=res, edges=edges).to(cuda_device)
    tex = random_texture(res).to(cuda_device)
    g = torch.as_tensor(np.random.default_rng(res + 1).normal(size=(3, 48, 64)),
                        dtype=torch.float32, device=cuda_device)
    before = tex_term_backward.launches
    d_ml, d_tex = tex_term_backward(ml, tex, g, 48, 64, mode)
    torch.cuda.synchronize()
    assert tex_term_backward.launches == before + 1
    d_ml_w, d_tex_w = mlist_tex_term_vjp(ml, tex, g, 48, 64, mode)
    torch.testing.assert_close(d_tex, d_tex_w, atol=1e-5, rtol=1e-3)
    live = ml[..., 0] != 0
    torch.testing.assert_close(d_ml[live], d_ml_w[live], atol=3e-5, rtol=1e-3)
    assert not bool(d_ml[~live].any())


@pytest.mark.cuda
def test_tex_term_backward_through_autograd(cuda_device):
    ml = random_mlist(12, 16, seed=3).to(cuda_device).requires_grad_(True)
    tex = random_texture(64).to(cuda_device).requires_grad_(True)
    g = torch.as_tensor(np.random.default_rng(9).normal(size=(3, 48, 64)),
                        dtype=torch.float32, device=cuda_device)
    before = (tex_term.launches, tex_term_backward.launches)
    d_ml, d_tex = torch.autograd.grad(tex_term(ml, tex, 48, 64), (ml, tex), g)
    assert (tex_term.launches, tex_term_backward.launches) == (
        before[0] + 1, before[1] + 1)
    d_ml_w, d_tex_w = mlist_tex_term_vjp(ml.detach(), tex.detach(), g, 48, 64)
    torch.testing.assert_close(d_tex, d_tex_w, atol=1e-5, rtol=1e-3)
    live = ml[..., 0] != 0
    torch.testing.assert_close(d_ml[live], d_ml_w[live], atol=3e-5, rtol=1e-3)


def assert_tex_term_backward_matches_plain(ml, tex, g, height, width, mode):
    """Kernel B' against its plain version at this file's B' tolerances;
    dead slots and pixels without a cotangent get zeros."""
    before = tex_term_backward.launches
    d_ml, d_tex = tex_term_backward(ml, tex, g, height, width, mode)
    torch.cuda.synchronize()
    assert tex_term_backward.launches == before + 1
    d_ml_w, d_tex_w = mlist_tex_term_vjp(ml, tex, g, height, width, mode)
    torch.testing.assert_close(d_tex, d_tex_w, atol=1e-5, rtol=1e-3)
    live = ml[..., 0] != 0
    torch.testing.assert_close(d_ml[live], d_ml_w[live], atol=3e-5, rtol=1e-3)
    assert not bool(d_ml[~live].any())
    # a pixel without a cotangent (outside the frame, or g = 0) gets none
    gy, gx = binning.grid_shape(height, width)
    pad = torch.zeros((3, gy * 16, gx * 16), device=g.device)
    pad[:, :height, :width] = g
    g_tiles = pad.reshape(3, gy, 16, gx, 16).permute(1, 3, 2, 4, 0).reshape(
        gy * gx, 256, 3)
    assert not bool(d_ml[(g_tiles == 0).all(-1)].any())
    return d_tex


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["bilinear", "nearest", "bilinear_clamp"])
@pytest.mark.parametrize("m", [1, 4, 33])
def test_tex_term_backward_where_warps_straddle_pixels(cuda_device, m, mode):
    """B' runs one thread per slot, so at m = 1, 4 and 33 a warp holds
    slots of several pixels; the 40 x 56 frame has partial edge tiles, and
    a quarter of its pixels get a zero cotangent."""
    ml = random_mlist(12, m, seed=m).to(cuda_device)
    tex = random_texture(16).to(cuda_device)
    rng = np.random.default_rng(m + 1)
    g = rng.normal(size=(3, 40, 56)) * (rng.uniform(size=(1, 40, 56)) < 0.75)
    assert_tex_term_backward_matches_plain(
        ml, tex, torch.as_tensor(g, dtype=torch.float32, device=cuda_device),
        40, 56, mode)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [8, 32])
@pytest.mark.parametrize("corner", [False, True], ids=["texel", "corner"])
def test_tex_term_backward_with_every_slot_on_one_texel(cuda_device, corner,
                                                         m):
    """Every live slot of every pixel points one way: inside face 0, so
    all taps land on the same 4 texels, or at the (+1, +1, +1) cube
    corner, whose seamless taps average 3 texels; up to 32 lanes of a warp
    then add into one texel."""
    rng = np.random.default_rng(m)
    n = 4 * 256 * m
    d = np.array([1.0, 1.0, 1.0] if corner else [1.0, 0.1, 0.2])
    w = rng.uniform(0.01, 0.3, size=(n, 1)) * (rng.uniform(size=(n, 1)) < 0.7)
    dirs = d * rng.uniform(0.5, 2.0, size=(n, 1))
    ml = torch.as_tensor(np.concatenate([w, dirs], axis=1), dtype=torch.float32,
                         device=cuda_device).reshape(4, 256, m, 4)
    tex = random_texture(16).to(cuda_device)
    g = torch.as_tensor(rng.normal(size=(3, 32, 32)), dtype=torch.float32,
                        device=cuda_device)
    for mode in ("bilinear", "bilinear_clamp"):
        d_tex = assert_tex_term_backward_matches_plain(ml, tex, g, 32, 32, mode)
        touched = int((d_tex.abs().sum(-1) > 0).sum())
        assert touched == (3 if corner and mode == "bilinear"
                           else 1 if corner else 4)


@pytest.mark.cuda
@pytest.mark.parametrize("feats", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("levels,size,n", [(8, 4096, 8192), (2, 256, 1000),
                                           (2, 256, 4)])
def test_hash_gather_kernel_matches_plain(cuda_device, levels, size, n,
                                          feats):
    """The gather exactly, on its vector path (F = 2 or 4 and n % 4 == 0)
    and its scalar path (other F, n = 1000), with every corner row's first
    and last query on table rows 0 and T - 1."""
    table, idx = hash_inputs(levels, size, feats, n=n)
    idx[:, 0], idx[:, -1] = 0, size - 1
    table, idx = table.to(cuda_device), idx.to(cuda_device)
    before = hash_gather.launches
    got = hash_gather(table, idx)
    torch.cuda.synchronize()
    assert hash_gather.launches == before + 1
    torch.testing.assert_close(got, gather_plain(table, idx), rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("what", ["table", "idx"])
def test_hash_gather_kernel_on_unaligned_tensors(cuda_device, what):
    """A table or index tensor 4 bytes past a 16-byte boundary takes the
    gather's scalar path: the same values exactly."""
    table, idx = hash_inputs(8, 4096, 4, n=8192)
    table, idx = table.to(cuda_device), idx.to(cuda_device)
    src = table if what == "table" else idx
    moved = torch.empty(src.numel() + 1, dtype=src.dtype,
                        device=cuda_device)[1:].view(src.shape)
    moved.copy_(src)
    assert moved.data_ptr() % 16 == 4
    if what == "table":
        table = moved
    else:
        idx = moved
    got = hash_gather(table, idx)
    torch.testing.assert_close(got, gather_plain(table, idx), rtol=0, atol=0)


def encode_inputs(levels=8, feats=4, log2=12, n=8192, seed=4):
    """(table, points, cotangent) on the CPU: n random points from `seed`,
    then for each level 64 points whose coordinates lie exactly on its grid
    lines (k / res_l), where an FMA in x * res_l - floor would flip the
    floor, and the unit cube's corners."""
    rng = np.random.default_rng(seed)
    table = rng.uniform(-1, 1, size=(levels, 2 ** log2, feats))
    pts = [rng.uniform(size=(n, 3))]
    for level in range(levels):
        res = level_resolution(level)
        pts.append(rng.integers(0, res + 1, size=(64, 3)) / res)
    pts.append([[(c >> a) & 1 for a in range(3)] for c in range(8)])
    x = np.concatenate(pts).astype(np.float32)
    cot = rng.normal(size=(x.shape[0], levels * feats))
    return tuple(torch.as_tensor(a, dtype=torch.float32)
                 for a in (table, x, cot))


def test_hash_encode_runs_plain_versions_on_cpu():
    table, x, cot = encode_inputs(levels=2, feats=2, log2=8, n=100)
    before = (hash_encode.launches, hash_encode_backward.launches)
    got, idx, w = hash_encode_forward(table, x, corners=True)
    d_table, d_x = hash_encode_backward(table, x, cot)
    assert (hash_encode.launches, hash_encode_backward.launches) == before
    torch.testing.assert_close(got, encode_plain(table, x), rtol=0, atol=0)
    idx_w, w_w = indices_and_weights(x, 2, 256)
    assert torch.equal(idx, idx_w) and torch.equal(w, w_w)
    d_table_w, d_x_w = encode_backward_plain(table, x, cot)
    torch.testing.assert_close(d_table, d_table_w, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(d_x, d_x_w, rtol=0, atol=0)


@pytest.mark.cuda
def test_hash_encode_rejects_too_many_features(cuda_device):
    table, x, _ = encode_inputs(levels=2, feats=9, log2=4, n=10)
    with pytest.raises(ValueError, match="features"):
        hash_encode_forward(table.to(cuda_device), x.to(cuda_device))


@pytest.mark.cuda
@pytest.mark.parametrize("levels,feats,log2,n", [(8, 4, 12, 8192),
                                                 (4, 2, 10, 1500),
                                                 (3, 5, 6, 700)])
def test_hash_encode_kernel_matches_plain(cuda_device, levels, feats, log2, n):
    """The forward on grid-line points: every corner index and weight as
    the plain version's, bit for bit; the features within atol 1e-6 /
    rtol 1e-5."""
    table, x, _ = (t.to(cuda_device) for t in
                   encode_inputs(levels, feats, log2, n))
    before = hash_encode.launches
    got, idx, w = hash_encode_forward(table, x, corners=True)
    torch.cuda.synchronize()
    assert hash_encode.launches == before + 1
    idx_w, w_w = indices_and_weights(x, levels, 2 ** log2)
    assert torch.equal(idx, idx_w), int((idx != idx_w).sum())
    assert torch.equal(w, w_w)
    torch.testing.assert_close(got, encode_plain(table, x), rtol=1e-5,
                               atol=1e-6)
    torch.testing.assert_close(hash_encode_forward(table, x), got, rtol=0,
                               atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("levels,feats,log2,n", [(8, 4, 12, 8192),
                                                 (4, 2, 10, 1500),
                                                 (3, 5, 6, 700)])
def test_hash_encode_backward_kernel_matches_plain(cuda_device, levels, feats,
                                                   log2, n):
    table, x, cot = (t.to(cuda_device) for t in
                     encode_inputs(levels, feats, log2, n))
    before = hash_encode_backward.launches
    d_table, d_x = hash_encode_backward(table, x, cot)
    torch.cuda.synchronize()
    assert hash_encode_backward.launches == before + 1
    d_table_w, d_x_w = encode_backward_plain(table, x, cot)
    assert bool(d_table_w.any()) and bool(d_x_w.abs().max() > 1e-3)
    torch.testing.assert_close(d_table, d_table_w, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(d_x, d_x_w, rtol=1e-4, atol=1e-4)
    d_table_only, none = hash_encode_backward(table, x, cot, need_x=False)
    assert none is None
    torch.testing.assert_close(d_table_only, d_table_w, rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
def test_hash_encode_through_autograd(cuda_device):
    """hash_encode launches K5' once forward and K5'' once backward, and
    agrees with autograd through the plain forward."""
    table, x, cot = (t.to(cuda_device) for t in encode_inputs(n=3000))
    t = table.clone().requires_grad_(True)
    xt = x.clone().requires_grad_(True)
    before = (hash_encode.launches, hash_encode_backward.launches)
    d_t, d_x = torch.autograd.grad(hash_encode(t, xt), (t, xt), cot)
    assert (hash_encode.launches, hash_encode_backward.launches) == (
        before[0] + 1, before[1] + 1)
    t_w = table.clone().requires_grad_(True)
    x_w = x.clone().requires_grad_(True)
    d_t_w, d_x_w = torch.autograd.grad(encode_plain(t_w, x_w), (t_w, x_w), cot)
    torch.testing.assert_close(d_t, d_t_w, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(d_x, d_x_w, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_hash_encode_kernels_empty_query(cuda_device):
    table, x, cot = (t.to(cuda_device) for t in encode_inputs(n=0))
    x, cot = x[:0].contiguous(), cot[:0].contiguous()
    before = (hash_encode.launches, hash_encode_backward.launches)
    assert hash_encode_forward(table, x).shape == (0, 32)
    d_table, d_x = hash_encode_backward(table, x, cot)
    assert (hash_encode.launches, hash_encode_backward.launches) == before
    assert not bool(d_table.any()) and d_x.shape == (0, 3)


def _train_model(device, sd=None):
    """A small stage-3 model with every loss term's inputs: 3,000
    Gaussians, SH 3, an inverse net with a 2-level hash grid, a 32^2
    cubemap; from the CPU model's state dict when one is given."""
    from texgs_torch.config import Cfg
    from texgs_torch.train.texture_gaussian3d import TextureGaussian3D

    net = {"emb_dim": 16, "pre_mlp_cfg": {"n_hidden_layers": 1, "n_neurons": 16},
           "mlp_cfg": {"n_hidden_layers": 1, "n_neurons": 16}}
    inv = dict(net, pre_mlp_cfg={"n_hidden_layers": 1, "n_neurons": 16,
                                 "hash_grid_cfg": {"n_levels": 2,
                                                   "n_features_per_level": 4,
                                                   "max_hashmap": 10}})
    cfg = Cfg({"uv_net_cfg": net, "inv_uv_net_cfg": inv,
               "max_inverse_points": 10 ** 6, "geo_emb_dim": 16,
               "tex_cfg": {"resolution": 32, "max_sh_degree": 3}})
    optim_cfg = Cfg({"uv_net_lr": 1e-4, "inv_uv_net_lr": 1e-4,
                     "uv_net_milestones": [], "uv_net_gamma": 0.5,
                     "tex_lr": 0.0025, "gaussian_optim_range": [0, None],
                     "position_lr_init": 1e-4, "position_lr_final": 1e-6,
                     "position_lr_delay_mult": 0.01,
                     "position_lr_max_steps": 7500, "opacity_lr": 0.05,
                     "scaling_lr": 0.005, "rotation_lr": 0.001})
    model = TextureGaussian3D(cfg, device=device)
    if sd is None:
        pcd = textured_sphere_point_cloud(3000, seed=0)
        st = init_from_pcd(pcd.points, pcd.colors, 3, device=device)
        rng = np.random.default_rng(0)
        model.gauss = dict(
            xyz=st.xyz, scaling=st.scaling, rotation=st.rotation,
            opacity=torch.as_tensor(rng.uniform(-1, 3, size=(3000, 1)),
                                    dtype=torch.float32, device=device),
            shs=torch.as_tensor(0.05 * rng.normal(size=(3000, 15, 3)),
                                dtype=torch.float32, device=device))
        model.texture = random_texture(32).to(device)
        model.active_sh_degree = 2
        model.spatial_lr_scale = 1.0
        model.setup_optim(optim_cfg)
    else:
        model.load_state_dict(sd, optim_cfg)
    model.bind_train_cfg(Cfg({}), [0.1, 0.2, 0.3])
    return model


@pytest.mark.cuda
def test_train_step_on_card_matches_cpu(cuda_device):
    """One stage-3 training step with every prod loss term: the card's
    kernels (A, A', B, B', the hash encode and its backward, once each)
    against the CPU's
    plain versions, from the same state.  The loss at rtol 1e-4; every
    leaf's gradient, read from the Adam moments of the first step (mu =
    0.1 g), at atol 2e-3 of its max |grad|, as the CPU tests hold the port
    to texgs.  (Adam's first step moves an element by +-lr whatever its
    gradient's size, so the parameters themselves part wherever a gradient
    near 0 rounds to the other sign.)"""
    from texgs_torch.config import Cfg
    from texgs_torch.core.camera import with_ground_truth
    from texgs_torch.kernels import tex_term as kt
    from texgs_torch.kernels import uvtex_fused as kf
    from texgs_torch.nets import hash_encode as ke
    from texgs_torch.train.optim import flatten_tree

    cpu = _train_model("cpu")
    card = _train_model(cuda_device, cpu.state_dict())
    cam = orbit_cameras(1, radius=3.5, width=80, height=64)[0]
    out = cpu.render(cam)
    # ground truth off the render, so no L1 term sits at its kink
    cam = with_ground_truth(cam, (out["render"] + 0.05).clamp(0, 1),
                            0.8 * out["alpha"] + 0.1,
                            normal=torch.roll(out["norm"], 1, dims=0))
    loss_cfg = Cfg({"lambda_dssim": 0.2, "lambda_alpha": 1.0,
                    "lambda_norm": 0.1, "lambda_norm_smooth": 0.5,
                    "lambda_no_sh": 2.0, "lambda_inverse": 0.1})
    counters = (kf.fused_pairs, kf.fused_pairs_backward, kt.tex_term,
                kt.tex_term_backward, ke.hash_encode, ke.hash_encode_backward)
    before = [fn.launches for fn in counters]
    loss_card = card.compute_loss(1, 10, cam, None, loss_cfg)[0].item()
    torch.cuda.synchronize()
    assert [fn.launches - b for fn, b in zip(counters, before)] == [1] * 6
    loss_cpu = cpu.compute_loss(1, 10, cam, None, loss_cfg)[0].item()
    np.testing.assert_allclose(loss_card, loss_cpu, rtol=1e-4)
    want = flatten_tree(cpu.state_dict()["optim_state"])
    got = flatten_tree(card.state_dict()["optim_state"])
    assert set(got) == set(want)
    for k in (k for k in want if ".mu." in f".{k}."):
        a, b = np.asarray(want[k]) / 0.1, np.asarray(got[k]) / 0.1
        assert np.isfinite(b).all(), k
        denom = np.abs(a).max() + 1e-8
        np.testing.assert_allclose(b / denom, a / denom, atol=2e-3,
                                   err_msg=f"grad mismatch: {k}")


def kernel_1_inputs(n=3000, width=80, height=64, seed=0, n_extra=0):
    """Kernel 1's inputs for one view of a textured sphere with SH colours
    (CPU tensors): (table, pairs, gx), with F = 7 + n_extra blend
    channels."""
    pcd = textured_sphere_point_cloud(n, seed=seed)
    st = init_from_pcd(pcd.points, pcd.colors, 3, device="cpu")
    cam = orbit_cameras(1, radius=3.5, width=width, height=height)[0]
    rng = np.random.default_rng(seed)
    campos = torch.as_tensor(cam.camera_center)
    feats = torch.cat([st.features_dc, torch.as_tensor(
        0.1 * rng.normal(size=(n, 15, 3)), dtype=torch.float32)], dim=1)
    opacity = torch.as_tensor(rng.uniform(0.05, 0.99, size=(n, 1)),
                              dtype=torch.float32)
    proj = project.project_gaussians(
        st.xyz, torch.exp(st.scaling), st.rotation, opacity,
        project.sh_colors(feats, st.xyz, campos, 3),
        torch.as_tensor(cam.world_view), torch.as_tensor(cam.full_proj),
        campos, width, height, cam.tanfovx, cam.tanfovy)
    pairs = binning.build_pairs(proj.means2d, proj.depths, proj.radii,
                                height, width)
    extra = torch.as_tensor(rng.normal(size=(n, n_extra)), dtype=torch.float32)
    return (tile_raster.build_gauss_table(proj, extra if n_extra else None),
            pairs, binning.grid_shape(height, width)[1])


def opaque_stack_inputs(n_opaque=4, n_dead=2):
    """One 16x16 tile covered by n_opaque flat layers of alpha 0.99 and,
    behind them, n_dead layers whose channels are NaN: every pixel stops
    before reaching them.  Returns (table, pairs, gx=1)."""
    n = n_opaque + n_dead
    table = torch.zeros((n, 16))
    logop = float(np.log(0.999))
    table[:, 5] = logop          # flat exponent: power = log-opacity
    table[:, 6] = logop
    table[:, 7:14] = torch.linspace(0.1, 0.7, 7)
    table[n_opaque:, 7:14] = float("nan")
    pairs = binning.PairList(
        pair_gauss=torch.arange(n, dtype=torch.int32),
        pair_tile=torch.zeros(n, dtype=torch.int32),
        tile_start=torch.zeros(1, dtype=torch.int32),
        tile_end=torch.full((1,), n, dtype=torch.int32),
        tile_counts=torch.full((1,), n, dtype=torch.int32),
        n_pairs=torch.tensor(n), overflowed=torch.tensor(False))
    return table, pairs, 1


def _to1(dev, args):
    table, pairs, gx = args
    return table.to(dev), _pairs_to(dev, pairs), gx


# pair counts on and beside the backward kernels' GROUP (32 pairs between
# barriers) and BATCH (64 or 128 staged pairs) boundaries, and one tile
# near the flagship view's heaviest (881 pairs); in ascending order and
# shuffled, so that the heaviest-first order permutes the tiles both ways
EDGE_COUNTS = {"ascending": (0, 1, 31, 32, 33, 63, 64, 65, 129, 897),
               "shuffled": (64, 897, 0, 33, 129, 1, 65, 31, 63, 32)}


def edge_count_inputs(counts, n_extra=3, m=32):
    """Kernel A's arguments (table, uv_rows, pairs, rays, gx = 5, m) on a
    grid of len(counts) tiles, tile t holding counts[t] pairs: the depth-
    ordered pairs of kernel_a_inputs' heaviest tile, cycled, each a table
    row of its own whose anchor moves with the tile, so that every tile
    sees the same Gaussians in its own frame."""
    table, uv_rows, pairs, rays, gx, _ = kernel_a_inputs(n_extra=n_extra)
    src = int(torch.argmax(pairs.tile_counts))
    s0, n_src = int(pairs.tile_start[src]), int(pairs.tile_counts[src])
    corner = lambda t: torch.tensor([t % gx, t // gx], dtype=torch.float32) * 16
    rows, uvs = [], []
    for t, n in enumerate(counts):
        g = pairs.pair_gauss[s0 + torch.arange(n) % n_src].long()
        r = table[g].clone()
        r[:, 14:16] += corner(t) - corner(src)
        rows.append(r)
        uvs.append(uv_rows[g])
    counts = torch.tensor(counts, dtype=torch.int32)
    end = torch.cumsum(counts, 0).to(torch.int32)
    n = int(end[-1])
    edge = binning.PairList(
        pair_gauss=torch.arange(n, dtype=torch.int32),
        pair_tile=torch.repeat_interleave(
            torch.arange(len(counts), dtype=torch.int32), counts),
        tile_start=end - counts, tile_end=end, tile_counts=counts,
        n_pairs=torch.tensor(n), overflowed=torch.tensor(False))
    return (torch.cat(rows).contiguous(), torch.cat(uvs).contiguous(),
            binning.with_tile_order(edge), rays, gx, m)


# EDGE_COUNTS with tiles on and beside kernel A's batch of 256 staged
# records
A_EDGE_COUNTS = {"ascending": (0, 1, 31, 32, 33, 63, 64, 65, 129, 255, 256,
                               257, 897),
                 "shuffled": (64, 897, 256, 0, 33, 129, 1, 255, 65, 31, 63,
                              257, 32)}


@pytest.mark.cuda
@pytest.mark.parametrize("order", list(A_EDGE_COUNTS))
def test_fused_kernel_at_batch_edges(cuda_device, order):
    """Kernel A on tiles of A_EDGE_COUNTS pairs, taken heaviest first and in
    launch order: the outputs are the same bit for bit, and agree with the
    plain version."""
    counts = A_EDGE_COUNTS[order]
    table, uv_rows, pairs, rays, gx, m = _to(cuda_device,
                                             edge_count_inputs(counts))
    got = fused_pairs(table, uv_rows, pairs, rays, gx, m)
    launch_order = pairs._replace(tile_order=torch.arange(
        len(counts), device=cuda_device))
    assert not torch.equal(pairs.tile_order, launch_order.tile_order)
    again = fused_pairs(table, uv_rows, launch_order, rays, gx, m)
    torch.cuda.synchronize()
    for a, b in zip(got, again):
        assert torch.equal(a, b)
    assert got[3].amax(-1).tolist() == list(counts)
    want = mlist_scan(table, uv_rows, pairs, rays, gx, m)
    assert _pixels_off(got, want) <= 4
    for a, b in ((got[0], want[0]), (got[1], want[1]),
                 (got[2][..., 0], want[2][..., 0])):
        assert (a - b).abs().max().item() <= 0.05


@pytest.mark.cuda
def test_fused_kernel_dead_slots_zero_over_nan_memory(cuda_device):
    """Kernel A writes every slot of its M-lists: where the caching
    allocator hands it a block that held NaN, the dead slots (those after
    a pixel's last entry) come out exactly zero."""
    args = _to(cuda_device, kernel_a_inputs(m=32))
    shape = (args[2].tile_counts.numel(), 256, 32, 4)
    junk = [torch.full(shape, float("nan"), device=cuda_device)
            for _ in range(4)]
    ptrs = {t.data_ptr() for t in junk}
    del junk
    got = fused_pairs(*args)
    torch.cuda.synchronize()
    mlist = got[2]
    assert mlist.data_ptr() in ptrs
    assert bool(torch.isfinite(mlist).all())
    w = mlist[..., 0]
    n_live = (w != 0).sum(-1, keepdim=True)
    dead = torch.arange(32, device=cuda_device) >= n_live
    assert bool((w[~dead] > 0).all())
    assert not bool(mlist[dead].any())
    assert _pixels_off(got, mlist_scan(*args)) <= 4


def _raster_pixels_off(got, want):
    """Pixels where kernel 1 and its plain version disagree: a channel or
    T_final beyond atol 1e-5 (1e-6 for T) + rtol 1e-4, or another n_eval."""
    def beyond(g, w, atol):
        return (g - w).abs() > atol + 1e-4 * w.abs()

    return int((beyond(got[0], want[0], 1e-5).any(-1)
                | beyond(got[1], want[1], 1e-6) | (got[2] != want[2])).sum())


def test_raster_wrappers_run_plain_version_on_cpu():
    args = kernel_1_inputs(n=600, width=48, height=32)
    outs = raster_scan(*args)
    cots = kernel_a_cotangents(outs[:2] + (outs[0],))[:2]
    before = (raster_pairs.launches, raster_pairs_backward.launches)
    got = raster_pairs(*args)
    d_table = raster_pairs_backward(*args, *outs[:2], *cots)
    assert (raster_pairs.launches, raster_pairs_backward.launches) == before
    for a, b in zip(got, outs):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    torch.testing.assert_close(d_table, raster_scan_vjp(*args, *cots),
                               rtol=1e-4, atol=1e-5)


def test_heaviest_first_tile_order():
    """The order in which kernels 1' and 2' take the tiles: descending pair
    counts, ties by tile index, computed once per pair list."""
    counts = torch.tensor([3, 0, 7, 3, 9, 7, 0, 1], dtype=torch.int32)
    order = binning.heaviest_first(counts)
    assert order.dtype == torch.int64
    assert order.tolist() == [4, 2, 5, 0, 3, 7, 1, 6]
    table, _, pairs, _, gx, _ = edge_count_inputs(EDGE_COUNTS["shuffled"])
    assert pairs.tile_order.tolist() == np.argsort(
        -np.array(EDGE_COUNTS["shuffled"]), kind="stable").tolist()
    assert binning.with_tile_order(pairs).tile_order is pairs.tile_order
    assert binning.tile_order_arg("test", pairs, table.device) is \
        pairs.tile_order


@pytest.mark.parametrize("grad", [True, False], ids=["train", "render"])
def test_tile_order_set_where_a_render_is_differentiated(monkeypatch, grad):
    """rasterize_tiled hands kernel 1 a pair list with its tile order where
    the blend will be differentiated, and in a render too (kernel 1 takes
    the tiles heaviest first)."""
    from texgs_torch.kernels import raster as kr

    pcd = textured_sphere_point_cloud(300, seed=0)
    st = init_from_pcd(pcd.points, pcd.colors, 0, device="cpu")
    cam = orbit_cameras(1, radius=3.5, width=48, height=32)[0]
    xyz = st.xyz.clone().requires_grad_(grad)
    proj = project.project_gaussians(
        xyz, torch.exp(st.scaling), st.rotation, torch.full((300, 1), 0.6),
        torch.zeros_like(st.xyz), torch.as_tensor(cam.world_view),
        torch.as_tensor(cam.full_proj), torch.as_tensor(cam.camera_center),
        48, 32, cam.tanfovx, cam.tanfovy)
    seen = []
    raster = kr.raster_pairs
    monkeypatch.setattr(kr, "raster_pairs",
                        lambda t, p, gx: seen.append(p) or raster(t, p, gx))
    tile_raster.rasterize_tiled(proj, 32, 48, torch.zeros(3))
    (pairs,) = seen
    assert torch.equal(pairs.tile_order,
                       binning.heaviest_first(pairs.tile_counts))


@pytest.mark.parametrize("grad", [True, False], ids=["train", "render"])
def test_tile_order_set_on_the_fused_path(monkeypatch, grad):
    """rasterize_uvtex hands kernel A a pair list with its tile order (A
    takes the tiles heaviest first), in a render and where the render is
    differentiated."""
    from texgs_torch.kernels import uvtex_fused as kf

    n = 300
    pcd = textured_sphere_point_cloud(n, seed=0)
    st = init_from_pcd(pcd.points, pcd.colors, 1, device="cpu")
    cam = orbit_cameras(1, radius=3.5, width=48, height=32)[0]
    xyz = st.xyz.clone().requires_grad_(grad)
    scaling, rot = torch.exp(st.scaling), st.rotation
    campos = torch.as_tensor(cam.camera_center)
    proj = project.project_gaussians(
        xyz, scaling, rot, torch.full((n, 1), 0.6), torch.zeros_like(st.xyz),
        torch.as_tensor(cam.world_view), torch.as_tensor(cam.full_proj),
        campos, 48, 32, cam.tanfovx, cam.tanfovy)
    uvs = xyz / torch.linalg.norm(xyz, dim=-1, keepdim=True)
    seen = []
    fused = kf.fused_pairs
    monkeypatch.setattr(kf, "fused_pairs",
                        lambda *a: seen.append(a[2]) or fused(*a))
    uvtex_raster.rasterize_uvtex(
        proj, scaling, rot, xyz, uvs, torch.zeros((n, 9)),
        random_texture(8), torch.zeros((n, 15, 3)), 1, cam, torch.zeros(3),
        m=8)
    (pairs,) = seen
    assert torch.equal(pairs.tile_order,
                       binning.heaviest_first(pairs.tile_counts))


@pytest.mark.parametrize("grad", [True, False], ids=["train", "render"])
def test_tile_order_set_on_the_two_kernel_path(monkeypatch, grad):
    """rasterize_uvtex's two-kernel path (``backend="pallas"``) hands
    kernels 1 and 2 one pair list with its tile order, in a render and
    where the render is differentiated."""
    from texgs_torch.kernels import raster as kr
    from texgs_torch.kernels import uvtex_mlist as km

    n = 300
    pcd = textured_sphere_point_cloud(n, seed=0)
    st = init_from_pcd(pcd.points, pcd.colors, 1, device="cpu")
    cam = orbit_cameras(1, radius=3.5, width=48, height=32)[0]
    xyz = st.xyz.clone().requires_grad_(grad)
    scaling, rot = torch.exp(st.scaling), st.rotation
    campos = torch.as_tensor(cam.camera_center)
    proj = project.project_gaussians(
        xyz, scaling, rot, torch.full((n, 1), 0.6), torch.zeros_like(st.xyz),
        torch.as_tensor(cam.world_view), torch.as_tensor(cam.full_proj),
        campos, 48, 32, cam.tanfovx, cam.tanfovy)
    uvs = xyz / torch.linalg.norm(xyz, dim=-1, keepdim=True)
    seen, seen_fwd = [], []
    raster, mlist = kr.raster_pairs, km.mlist_pairs
    mlist_fwd = km.mlist_pairs_forward
    monkeypatch.setattr(kr, "raster_pairs",
                        lambda t, p, gx: seen.append(p) or raster(t, p, gx))
    monkeypatch.setattr(km, "mlist_pairs",
                        lambda *a: seen.append(a[2]) or mlist(*a))
    # kernel 2's own entry, which launches it on the card
    monkeypatch.setattr(km, "mlist_pairs_forward",
                        lambda *a: seen_fwd.append(a[2]) or mlist_fwd(*a))
    uvtex_raster.rasterize_uvtex(
        proj, scaling, rot, xyz, uvs, torch.zeros((n, 9)),
        random_texture(8), torch.zeros((n, 15, 3)), 1, cam, torch.zeros(3),
        m=8, backend="pallas")
    assert len(seen) == 2 and seen[0] is seen[1]
    assert seen_fwd == [seen[0]]
    assert torch.equal(seen[0].tile_order,
                       binning.heaviest_first(seen[0].tile_counts))


@pytest.mark.cuda
def test_raster_rejects_channels_off_the_path(cuda_device):
    """Kernel 1 is built for F = 7 (stages 1 and 2) and F = 10 (the
    two-kernel stage-3 render) only: the wrapper refuses another F, and so
    does the C entry (cudaErrorInvalidValue)."""
    from texgs_torch import _build
    from texgs_torch.kernels import raster as kr

    table, pairs, gx = _to1(cuda_device, kernel_1_inputs(n=200))
    wide = torch.cat([table, table[:, :1]], dim=1).contiguous()   # F = 8
    with pytest.raises(ValueError, match="blend channels"):
        raster_pairs(wide, pairs, gx)
    n_tiles = pairs.tile_counts.numel()
    out = torch.empty((n_tiles, 256, 8), device=cuda_device)
    t_fin = torch.empty((n_tiles, 256), device=cuda_device)
    n_eval = torch.empty((n_tiles, 256), dtype=torch.int32, device=cuda_device)
    p = _build.ptr
    order = binning.heaviest_first(pairs.tile_counts)
    err = _build.function("raster", "raster_forward", kr._FWD_ARGS)(
        p(wide), wide.shape[1], p(pairs.pair_gauss), p(pairs.tile_start),
        p(pairs.tile_end), p(order), n_tiles, gx, 8, p(out), p(t_fin),
        p(n_eval), _build.stream_of(wide))
    assert err == 1  # cudaErrorInvalidValue
    err = _build.function("raster_bwd", "raster_backward", kr._BWD_ARGS)(
        p(wide), wide.shape[1], p(pairs.pair_gauss), p(pairs.tile_start),
        p(pairs.tile_end), p(order), n_tiles, gx, 8, p(out), p(t_fin), p(out),
        p(t_fin), p(wide), _build.stream_of(wide))
    assert err == 1


@pytest.mark.cuda
@pytest.mark.parametrize("n_extra", [0, 3], ids=["F7", "F10"])
@pytest.mark.parametrize("size", [(80, 64), (200, 136)], ids=str)
def test_raster_kernel_matches_plain(cuda_device, size, n_extra):
    args = _to1(cuda_device, kernel_1_inputs(width=size[0], height=size[1],
                                             n_extra=n_extra))
    before = raster_pairs.launches
    got = raster_pairs(*args)
    torch.cuda.synchronize()
    assert raster_pairs.launches == before + 1
    want = raster_scan(*args)
    assert _raster_pixels_off(got, want) <= 4
    for a, b in zip(got[:2], want[:2]):
        assert (a - b).abs().max().item() <= 0.05
    assert int(got[2].sum()) > 0


def assert_raster_orders_agree(table, pairs, gx):
    """Kernel 1 with the tiles heaviest first and in launch order: the
    same outputs bit for bit, within _raster_pixels_off's allowance of the
    plain version.  Returns the outputs."""
    heavy = binning.with_tile_order(pairs)
    launch = pairs._replace(tile_order=torch.arange(
        pairs.tile_counts.numel(), device=table.device))
    if pairs.tile_counts.numel() > 1:
        assert not torch.equal(heavy.tile_order, launch.tile_order)
    got = raster_pairs(table, heavy, gx)
    again = raster_pairs(table, launch, gx)
    torch.cuda.synchronize()
    for a, b in zip(got, again):
        assert torch.equal(a, b)
    want = raster_scan(table, pairs, gx)
    assert _raster_pixels_off(got, want) <= 4
    for a, b in zip(got[:2], want[:2]):
        assert (a - b).abs().max().item() <= 0.05
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("order", list(A_EDGE_COUNTS))
@pytest.mark.parametrize("n_extra", [0, 3], ids=["F7", "F10"])
def test_raster_kernel_at_batch_edges(cuda_device, n_extra, order):
    """Kernel 1 on tiles of A_EDGE_COUNTS pairs (0, 1, 255, 256, 257, 897
    among them), heaviest first and in launch order."""
    counts = A_EDGE_COUNTS[order]
    table, _, pairs, _, gx, _ = _to(cuda_device, edge_count_inputs(
        counts, n_extra=n_extra))
    got = assert_raster_orders_agree(table, pairs, gx)
    assert got[2].amax(-1).tolist() == list(counts)


# the pair index at which every pixel of a tile stops, one tile each:
# each position of the look-ahead groups of 2, 4 and 8 pairs, and the
# pairs around the batch boundary at 256
STOP_AT = (13, 14, 15, 16, 17, 18, 19, 20, 21, 254, 255, 256, 257)


def stop_at_inputs(n_extra, stop_at=STOP_AT):
    """Flat layers, one tile per entry of stop_at: tile t holds
    stop_at[t] - 13 transparent pairs (alpha 0, evaluated), then 14 pairs
    of alpha 0.5, the 14th of which takes T below 1e-4 and stops every
    pixel (after 13, T = 0.5^13 > 1e-4), then 3 pairs with NaN channels
    that no pixel reaches.  Returns (table, pairs, gx = len(stop_at))."""
    table = torch.zeros((3, 16 + n_extra))
    logop = float(np.log(0.5))
    table[:, 5] = table[:, 6] = logop   # flat exponent: power = log-opacity
    table[0, 5] = -30.0                 # transparent: alpha = 0
    table[:, 7:14] = torch.linspace(0.1, 0.7, 7)
    table[:, 16:] = torch.linspace(-0.5, 0.5, n_extra)
    table[2, 7:14] = table[2, 16:] = float("nan")
    lists = [[0] * (k - 13) + [1] * 14 + [2] * 3 for k in stop_at]
    counts = torch.tensor([len(x) for x in lists], dtype=torch.int32)
    end = torch.cumsum(counts, 0).to(torch.int32)
    pairs = binning.PairList(
        pair_gauss=torch.tensor(sum(lists, []), dtype=torch.int32),
        pair_tile=torch.repeat_interleave(
            torch.arange(len(lists), dtype=torch.int32), counts),
        tile_start=end - counts, tile_end=end, tile_counts=counts,
        n_pairs=end[-1].to(torch.int64), overflowed=torch.tensor(False))
    return table, pairs, len(stop_at)


@pytest.mark.cuda
@pytest.mark.parametrize("n_extra", [0, 3], ids=["F7", "F10"])
def test_raster_kernel_stops_at_look_ahead_group_edges(cuda_device, n_extra):
    """Kernel 1 computes a group of alphas ahead of the T chain: a stop on
    the first, a middle or the last pair of a group (and around the batch
    boundary) counts the stopping pair in n_eval, composites nothing from
    it on, and no alpha computed past it reaches an output."""
    table, pairs, gx = _to1(cuda_device, stop_at_inputs(n_extra))
    blend, t_final, n_eval = assert_raster_orders_agree(table, pairs, gx)
    want = torch.tensor(STOP_AT, device=cuda_device)[:, None] + 1
    assert torch.equal(n_eval, want.expand_as(n_eval).to(torch.int32))
    assert bool(torch.isfinite(blend).all())
    torch.testing.assert_close(t_final, torch.full_like(t_final, 0.5 ** 13),
                               rtol=1e-5, atol=0)
    torch.testing.assert_close(blend[0], blend[-1], rtol=0, atol=0)


def assert_columns_close(groups, max_off=4):
    """A backward kernel against its plain version, per column group {name:
    (got, want)}: atol 1e-3 of the group's max |plain| + rtol 1e-3, at most
    max_off Gaussians beyond; a zero output must fail."""
    for name, (g, w) in groups.items():
        assert bool(torch.isfinite(g).all()), name
        tol = 1e-3 * w.abs().max() + 1e-3 * w.abs()
        off = int(((g - w).abs() > tol).any(-1).sum())
        assert off <= max_off, f"{name}: {off} Gaussians beyond tolerance"
        assert int((w.abs() > tol).any(-1).sum()) > max_off, \
            f"{name}: the check could not refuse zeros"


def assert_raster_backward_close(got, want, max_off=4):
    """Kernel 1' against its plain version: per column group (quad,
    channels), atol 1e-3 of the group's max |plain| + rtol 1e-3, at most
    max_off Gaussians beyond; a zero output must fail."""
    channels = [*range(7, 14), *range(16, got.shape[1])]
    assert_columns_close({"quad": (got[:, :6], want[:, :6]),
                          "channels": (got[:, channels], want[:, channels])},
                         max_off)
    assert not bool(got[:, [6, 14, 15]].any())


@pytest.mark.cuda
@pytest.mark.parametrize("n_extra", [0, 3], ids=["F7", "F10"])
def test_raster_backward_kernel_matches_plain(cuda_device, n_extra):
    args = _to1(cuda_device, kernel_1_inputs(n_extra=n_extra))
    outs = raster_pairs(*args)
    rng = np.random.default_rng(5)
    cots = [torch.as_tensor(rng.normal(size=tuple(t.shape)), dtype=torch.float32,
                            device=cuda_device) for t in outs[:2]]
    before = raster_pairs_backward.launches
    got = raster_pairs_backward(*args, *outs[:2], *cots)
    torch.cuda.synchronize()
    assert raster_pairs_backward.launches == before + 1
    assert_raster_backward_close(got, raster_scan_vjp(*args, *cots))


@pytest.mark.cuda
@pytest.mark.parametrize("order", list(EDGE_COUNTS))
@pytest.mark.parametrize("n_extra", [0, 3], ids=["F7", "F10"])
def test_raster_backward_kernel_at_batch_edges(cuda_device, n_extra, order):
    """Kernel 1' on tiles of EDGE_COUNTS pairs, every pixel of the tiles up
    to 129 pairs evaluating all of them."""
    counts = EDGE_COUNTS[order]
    table, _, pairs, _, gx, _ = _to(cuda_device, edge_count_inputs(
        counts, n_extra=n_extra))
    outs = raster_pairs(table, pairs, gx)
    assert outs[2].amax(-1).tolist() == list(counts)
    rng = np.random.default_rng(6)
    cots = [torch.as_tensor(rng.normal(size=tuple(t.shape)), dtype=torch.float32,
                            device=cuda_device) for t in outs[:2]]
    got = raster_pairs_backward(table, pairs, gx, *outs[:2], *cots)
    assert_raster_backward_close(got, raster_scan_vjp(table, pairs, gx, *cots))


@pytest.mark.cuda
def test_raster_backward_through_autograd(cuda_device):
    table, pairs, gx = _to1(cuda_device, kernel_1_inputs())
    t = table.clone().requires_grad_(True)
    outs = raster_pairs(t, pairs, gx)
    rng = np.random.default_rng(8)
    cots = [torch.as_tensor(rng.normal(size=tuple(o.shape)), dtype=torch.float32,
                            device=cuda_device) for o in outs[:2]]
    before = raster_pairs_backward.launches
    (got,) = torch.autograd.grad(outs[:2], (t,), cots)
    assert raster_pairs_backward.launches == before + 1
    assert_raster_backward_close(got, raster_scan_vjp(table, pairs, gx, *cots))


@pytest.mark.cuda
def test_raster_kernels_empty_scene_and_dead_nan(cuda_device):
    """No pairs: T = 1, zero channels and no gradient.  An opaque stack
    with NaN channels behind it: the NaN reaches neither output."""
    table, pairs, gx = _to1(cuda_device, kernel_1_inputs(n=300))
    empty = binning.PairList(
        pairs.pair_gauss[:0], pairs.pair_tile[:0],
        torch.zeros_like(pairs.tile_start), torch.zeros_like(pairs.tile_end),
        torch.zeros_like(pairs.tile_counts), pairs.n_pairs * 0,
        pairs.overflowed)
    blend, t_final, n_eval = raster_pairs(table, empty, gx)
    assert bool((blend == 0).all()) and bool((t_final == 1).all())
    assert not bool(n_eval.any())
    d = raster_pairs_backward(table, empty, gx, blend, t_final,
                              torch.ones_like(blend), torch.ones_like(t_final))
    assert not bool(d.any())
    table, pairs, gx = _to1(cuda_device, opaque_stack_inputs())
    blend, t_final, n_eval = raster_pairs(table, pairs, gx)
    assert bool(torch.isfinite(blend).all()) and bool((n_eval < 6).all())
    d = raster_pairs_backward(table, pairs, gx, blend, t_final,
                              torch.ones_like(blend), torch.ones_like(t_final))
    assert bool(torch.isfinite(d).all()) and not bool(d[4:].any())


def _stage1_model(device, sd=None):
    """A small stage-1 model: 3,000 Gaussians, SH degree 3 (2 active),
    random opacities; from the CPU model's state dict when one is given."""
    from texgs_torch.config import Cfg
    from texgs_torch.train.gaussian3d import Gaussian3D

    optim_cfg = Cfg({"position_lr_init": 1.6e-4, "position_lr_final": 1.6e-6,
                     "position_lr_delay_mult": 0.01,
                     "position_lr_max_steps": 7500, "feature_lr": 0.0025,
                     "opacity_lr": 0.05, "scaling_lr": 0.005,
                     "rotation_lr": 0.001, "percent_dense": 0.01})
    model = Gaussian3D(Cfg({"sh_degree": 3}), device=device)
    if sd is None:
        pcd = textured_sphere_point_cloud(3000, seed=0)
        model.initialize(pcd, 3.85)
        rng = np.random.default_rng(0)
        model.state.opacity = torch.as_tensor(
            rng.uniform(-1, 3, size=(3000, 1)), dtype=torch.float32,
            device=device)
        model.state.features_rest = torch.as_tensor(
            0.05 * rng.normal(size=(3000, 15, 3)), dtype=torch.float32,
            device=device)
        model.setup_optim(optim_cfg)
        model.active_sh_degree = 2
    else:
        model.load_state_dict(sd, optim_cfg)
    # configs/prod_stage1.yaml's schedule: iteration 2581 is no surgery
    model.bind_train_cfg(Cfg({
        "densification_interval": 100, "opacity_reset_interval": 3000,
        "densify_from_iter": 125, "densify_until_iter": 3750,
        "min_scale_reset_interval": 0, "opacity_prune_interval": 0}),
        [0.1, 0.2, 0.3])
    return model


@pytest.mark.cuda
def test_stage1_step_on_card_matches_cpu(cuda_device):
    """One stage-1 training step with every prod loss term: the card's
    kernels 1 and 1' (once each) against the CPU's plain versions, from
    the same state.  The loss at rtol 1e-4; every leaf's gradient (read
    from the first step's Adam moments, mu = 0.1 g) and the NDC-offset
    gradient norms of the densification stats at atol 2e-3 of their max."""
    from texgs_torch.config import Cfg
    from texgs_torch.core.camera import with_ground_truth
    from texgs_torch.kernels import raster as kr

    cpu = _stage1_model("cpu")
    card = _stage1_model(cuda_device, cpu.state_dict())
    cam = orbit_cameras(1, radius=3.5, width=80, height=64)[0]
    out = cpu.visual_step(0, 1, cam)
    # ground truth off the render, so no L1 term sits at its kink
    cam = with_ground_truth(cam, (out["image"] + 0.05).clamp(0, 1),
                            0.8 * out["alpha"] + 0.1,
                            normal=torch.roll(out["norm"], 1, dims=0))
    loss_cfg = Cfg({"lambda_dssim": 0.2, "lambda_alpha": 1.0,
                    "lambda_norm": 0.1, "lambda_norm_smooth": 0.1,
                    "lambda_opacity_reg": 0.001})
    before = (kr.raster_pairs.launches, kr.raster_pairs_backward.launches)
    loss_card = card.compute_loss(2581, 7500, cam, None, loss_cfg)[0].item()
    torch.cuda.synchronize()
    assert (kr.raster_pairs.launches - before[0],
            kr.raster_pairs_backward.launches - before[1]) == (1, 1)
    loss_cpu = cpu.compute_loss(2581, 7500, cam, None, loss_cfg)[0].item()
    np.testing.assert_allclose(loss_card, loss_cpu, rtol=1e-4)
    want, got = cpu.state_dict(), card.state_dict()
    pairs = [(want["adam"]["mu"][k] / 0.1, got["adam"]["mu"][k] / 0.1, k)
             for k in want["adam"]["mu"]]
    pairs.append((want["stats"]["xyz_gradient_accum"],
                  got["stats"]["xyz_gradient_accum"], "ndc grad norms"))
    for a, b, k in pairs:
        assert np.isfinite(b).all(), k
        denom = np.abs(a).max() + 1e-12
        np.testing.assert_allclose(b / denom, a / denom, atol=2e-3,
                                   err_msg=f"grad mismatch: {k}")


def opaque_stack_mlist_inputs(n_opaque=5, n_dead=2, m=8):
    """Kernel 2's arguments (table, uv_rows, pairs, rays, gx = 1, m) for one
    16x16 tile covered by n_opaque flat layers of alpha 0.8 and, behind
    them, n_dead layers whose blend channels and uv rows are NaN: every
    pixel stops at the first of them (T = 0.2^6 < 1e-4)."""
    n = n_opaque + n_dead
    table = torch.zeros((n, 19))
    logop = float(np.log(0.8))
    table[:, 5] = logop          # flat exponent: power = log-opacity
    table[:, 6] = logop
    table[n_opaque:, 7:14] = float("nan")
    table[n_opaque:, 16:] = float("nan")
    rng = np.random.default_rng(4)
    uv_rows = torch.as_tensor(rng.normal(size=(n, 24)), dtype=torch.float32)
    uv_rows[:, 3:9] = torch.tensor([1.0, 0.0, 0.0, 1.0, 0.0, 1.0])
    uv_rows[n_opaque:] = float("nan")
    pairs = binning.PairList(
        pair_gauss=torch.arange(n, dtype=torch.int32),
        pair_tile=torch.zeros(n, dtype=torch.int32),
        tile_start=torch.zeros(1, dtype=torch.int32),
        tile_end=torch.full((1,), n, dtype=torch.int32),
        tile_counts=torch.full((1,), n, dtype=torch.int32),
        n_pairs=torch.tensor(n), overflowed=torch.tensor(False))
    rays = np.array([[0.01, 0, 0], [0, 0.01, 0], [-0.08, -0.08, 1.0]],
                    np.float32)
    return table, uv_rows, pairs, rays, 1, m


def test_mlist_wrappers_run_plain_version_on_cpu():
    args = kernel_a_inputs(n=600, width=48, height=32, m=8)
    want = mlist_only_scan(*args)
    g = kernel_a_cotangents((want, want, want))[0]
    before = (mlist_pairs.launches, mlist_pairs_backward.launches)
    got = mlist_pairs(*args)
    grads = mlist_pairs_backward(*args, got, g)
    assert (mlist_pairs.launches, mlist_pairs_backward.launches) == before
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    for a, b in zip(grads, mlist_only_scan_vjp(*args, g)):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)


def _slots_off(got, want):
    """Pixels where kernel 2 and its plain version disagree: an M-list
    value beyond atol 1e-5 + rtol 1e-4."""
    return int(((got - want).abs() > 1e-5 + 1e-4 * want.abs())
               .flatten(2).any(-1).sum())


def assert_mlist_orders_agree(args):
    """Kernel 2 with the tiles heaviest first and in launch order
    (tile_order = arange): the same M-lists bit for bit, within
    _slots_off's allowance of the plain version.  Returns the M-lists."""
    table, uv_rows, pairs, rays, gx, m = args
    heavy = binning.with_tile_order(pairs)
    launch = pairs._replace(tile_order=torch.arange(
        pairs.tile_counts.numel(), device=table.device))
    if bool((pairs.tile_counts[1:] > pairs.tile_counts[:-1]).any()):
        assert not torch.equal(heavy.tile_order, launch.tile_order)
    before = mlist_pairs.launches
    got = mlist_pairs(table, uv_rows, heavy, rays, gx, m)
    again = mlist_pairs(table, uv_rows, launch, rays, gx, m)
    torch.cuda.synchronize()
    assert mlist_pairs.launches == before + 2
    assert torch.equal(got, again)
    want = mlist_only_scan(*args)
    assert _slots_off(got, want) <= 4
    assert (got[..., 0] - want[..., 0]).abs().max().item() <= 0.05
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("m,n_extra", [(8, 3), (32, 3), (32, 0), (5, 0)])
def test_mlist_kernel_matches_plain(cuda_device, m, n_extra):
    """Kernel 2 against its plain version in both tile orders, and against
    kernel A's M-lists: the two-kernel render and the fused one keep the
    same contributors."""
    args = _to(cuda_device, kernel_a_inputs(m=m, n_extra=n_extra))
    got = assert_mlist_orders_agree(args)
    want = fused_pairs(*args)[2]
    assert _slots_off(got, want) <= 4
    assert (got[..., 0] - want[..., 0]).abs().max().item() <= 0.05
    assert bool((got[..., 0] > 0).any())


@pytest.mark.cuda
@pytest.mark.parametrize("order", list(A_EDGE_COUNTS))
@pytest.mark.parametrize("m", [1, 8, 32, 33])
def test_mlist_kernel_at_batch_edges(cuda_device, m, order):
    """Kernel 2 on tiles of A_EDGE_COUNTS pairs (0, 1, 255, 256, 257, 897
    among them), heaviest first and in launch order, at m = 1 and 33 (a
    pixel's slots straddle warps in the block's zeroing) beside 8 and 32:
    each pixel's live slots are a prefix of its list, and the empty tile
    holds none."""
    counts = A_EDGE_COUNTS[order]
    args = _to(cuda_device, edge_count_inputs(counts, m=m))
    got = assert_mlist_orders_agree(args)
    live = got[..., 0] != 0
    n_live = live.sum(-1, keepdim=True)
    assert torch.equal(live, torch.arange(m, device=cuda_device) < n_live)
    empty = torch.tensor(counts, device=cuda_device) == 0
    assert not bool(got[empty].any())


@pytest.mark.cuda
@pytest.mark.parametrize("m", [8, 32, 33])
def test_mlist_kernel_dead_slots_zero_over_nan_memory(cuda_device, m):
    """Kernel 2 writes every slot of its M-lists: where the caching
    allocator hands it a block that held NaN, the dead slots (those after
    a pixel's last entry) come out exactly zero.  The tile order is set
    first, so that the wrapper allocates the M-lists alone."""
    table, uv_rows, pairs, rays, gx, _ = _to(cuda_device,
                                             kernel_a_inputs(m=m))
    args = (table, uv_rows, binning.with_tile_order(pairs), rays, gx, m)
    shape = (pairs.tile_counts.numel(), 256, m, 4)
    junk = [torch.full(shape, float("nan"), device=cuda_device)
            for _ in range(4)]
    ptrs = {t.data_ptr() for t in junk}
    del junk
    got = mlist_pairs(*args)
    torch.cuda.synchronize()
    assert got.data_ptr() in ptrs
    assert bool(torch.isfinite(got).all())
    w = got[..., 0]
    n_live = (w != 0).sum(-1, keepdim=True)
    dead = torch.arange(m, device=cuda_device) >= n_live
    assert bool((w[~dead] > 0).all())
    assert not bool(got[dead].any())
    assert _slots_off(got, mlist_only_scan(*args)) <= 4


@pytest.mark.cuda
def test_mlist_kernel_empty_scene(cuda_device):
    table, uv_rows, pairs, rays, gx, m = _to(cuda_device, kernel_a_inputs())
    empty = binning.PairList(
        pairs.pair_gauss[:0], pairs.pair_tile[:0],
        torch.zeros_like(pairs.tile_start), torch.zeros_like(pairs.tile_end),
        torch.zeros_like(pairs.tile_counts), pairs.n_pairs * 0,
        pairs.overflowed)
    ml = mlist_pairs(table, uv_rows, empty, rays, gx, m)
    assert not bool(ml.any())
    d_table, d_uv = mlist_pairs_backward(table, uv_rows, empty, rays, gx, m,
                                         ml, torch.ones_like(ml))
    assert not bool(d_table.any()) and not bool(d_uv.any())


def assert_mlist_backward_close(got, want, max_off=4):
    """Kernel 2' against its plain version: the quad columns of the table
    and the uv rows' first 12 columns per group, as A' is held; every other
    column zero."""
    (d_table, d_uv), (d_table_w, d_uv_w) = got, want
    assert_columns_close({"quad": (d_table[:, :6], d_table_w[:, :6]),
                          "uv rows": (d_uv[:, :12], d_uv_w[:, :12])}, max_off)
    assert not bool(d_table[:, 6:].any()) and not bool(d_uv[:, 12:].any())


@pytest.mark.cuda
@pytest.mark.parametrize("m,n_extra", [(8, 3), (32, 0)])
def test_mlist_backward_kernel_matches_plain(cuda_device, m, n_extra):
    args = _to(cuda_device, kernel_a_inputs(m=m, n_extra=n_extra))
    ml = mlist_pairs(*args)
    g = kernel_a_cotangents((ml, ml, ml), seed=4)[0]
    before = mlist_pairs_backward.launches
    got = mlist_pairs_backward(*args, ml, g)
    torch.cuda.synchronize()
    assert mlist_pairs_backward.launches == before + 1
    assert_mlist_backward_close(got, mlist_only_scan_vjp(*args, g))


@pytest.mark.cuda
@pytest.mark.parametrize("order", list(EDGE_COUNTS))
@pytest.mark.parametrize("m", [8, 32])
def test_mlist_backward_kernel_at_batch_edges(cuda_device, m, order):
    """Kernel 2' on tiles of EDGE_COUNTS pairs."""
    args = _to(cuda_device, edge_count_inputs(EDGE_COUNTS[order], m=m))
    ml = mlist_pairs(*args)
    g = kernel_a_cotangents((ml, ml, ml), seed=4)[0]
    got = mlist_pairs_backward(*args, ml, g)
    assert_mlist_backward_close(got, mlist_only_scan_vjp(*args, g))


@pytest.mark.cuda
def test_mlist_backward_through_autograd(cuda_device):
    """mlist_pairs' backward launches kernel 2' once and agrees with
    autograd through the plain version; with kernel 1' beside it, the
    two-kernel render's gradient is kernel A''s."""
    table, uv_rows, pairs, rays, gx, m = _to(cuda_device, kernel_a_inputs())
    t = table.clone().requires_grad_(True)
    u = uv_rows.clone().requires_grad_(True)
    ml = mlist_pairs(t, u, pairs, rays, gx, m)
    blend, t_final, _ = raster_pairs(t, pairs, gx)
    g_blend, g_t, g_ml = kernel_a_cotangents((blend, t_final, ml), seed=7)
    before = mlist_pairs_backward.launches
    got = torch.autograd.grad(ml, (t, u), g_ml, retain_graph=True)
    assert mlist_pairs_backward.launches == before + 1
    assert_mlist_backward_close(got, mlist_only_scan_vjp(
        table, uv_rows, pairs, rays, gx, m, g_ml))
    two = torch.autograd.grad((blend, t_final, ml), (t, u), (g_blend, g_t, g_ml))
    outs = fused_pairs(table, uv_rows, pairs, rays, gx, m)
    assert_a_backward_close(two, fused_pairs_backward(
        table, uv_rows, pairs, rays, gx, m, *outs[:3], g_blend, g_t, g_ml))


@pytest.mark.cuda
def test_mlist_kernels_dead_nan(cuda_device):
    """NaN channels and uv rows behind an opaque stack, NaN cotangents on
    the empty slots: finite M-lists and gradients, none for the dead
    entries."""
    args = _to(cuda_device, opaque_stack_mlist_inputs())
    ml = mlist_pairs(*args)
    live = ml[..., 0] > 0
    assert bool(torch.isfinite(ml).all())
    assert bool(live[..., :5].all()) and not bool(live[..., 5:].any())
    g = torch.ones_like(ml)
    g[~live] = float("nan")
    d_table, d_uv = mlist_pairs_backward(*args, ml, g)
    assert bool(torch.isfinite(d_table).all()) and bool(torch.isfinite(d_uv).all())
    assert not bool(d_table[5:].any()) and not bool(d_uv[5:].any())
    assert bool(d_table[:5, :6].any()) and bool(d_uv[:5, :12].any())


def _small_verifier(monkeypatch):
    """verify_compiled at 20,000 Gaussians, 128x128 and a 64^2 cubemap."""
    from texgs_torch.tools import verify_compiled

    for k, v in (("VERIFY_N", "20000"), ("VERIFY_W", "128"),
                 ("VERIFY_H", "128"), ("VERIFY_TEX", "64")):
        monkeypatch.setenv(k, v)
    return verify_compiled


@pytest.mark.cuda
def test_verifier_on_the_card(cuda_device, monkeypatch, capsys):
    """Every kernel against its plain twin through whole renders: ok, and
    compiled."""
    import json

    verify_compiled = _small_verifier(monkeypatch)
    assert verify_compiled.main(["--device", "cuda"]) == 0
    verdict = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert verdict["ok"] is True and verdict["compiled"] is True
    for check in ("raster", "uvtex", "uvtex_fused", "tex_term"):
        assert verdict[check]["ok"] is True


@pytest.mark.cuda
def test_verifier_refuses_a_corrupted_tile_row_on_the_card(cuda_device,
                                                           monkeypatch):
    """Kernel B's output plus 0.05 in one tile row of the image: the
    verifier's fused-path check fails."""
    from texgs_torch.kernels import tex_term as kt

    verify_compiled = _small_verifier(monkeypatch)
    clean = kt.tex_term

    def corrupted(*args):
        img = clean(*args)
        rows = torch.arange(img.shape[1], device=img.device) // 16 == 1
        return img + torch.where(rows[:, None], 0.05, 0.0)
    corrupted.launches = 0  # kernel B's wrapper counts through this name
    monkeypatch.setattr(kt, "tex_term", corrupted)
    ok, results = verify_compiled.verify_uvtex(20000, 128, 128, 64,
                                               device=cuda_device,
                                               backend="auto")
    assert not ok
    assert results["fwd_image"] > verify_compiled.REL_TOL_FWD


# ------------------------------------------------- the viewer's maps kernel
def sh0_texture(res, seed=6):
    """A (6, R, R, 3) SH0 texture whose C0 * sh0 + 0.5 spans about
    [-0.35, 1.35], so sh02rgb's clamp bites on both sides."""
    rng = np.random.default_rng(seed)
    return torch.as_tensor(rng.uniform(-3.0, 3.0, size=(6, res, res, 3)),
                           dtype=torch.float32)


def panorama_taps(res, height, width):
    """For the (height, width) panorama of a res^2 cubemap (the pixel
    directions of cubemap_to_latlong): how many pixels have a tap past one
    face edge, and the set of cube corners (octants) that pixels with a tap
    past two edges (a 3-texel corner mean) sit in."""
    gv, gu = torch.meshgrid((torch.arange(height) + 0.5) / height,
                            (torch.arange(width) + 0.5) / width,
                            indexing="ij")
    theta, phi = gv * math.pi, gu * 2 * math.pi - math.pi
    d = torch.stack([torch.sin(theta) * torch.sin(phi), torch.cos(theta),
                     -torch.sin(theta) * torch.cos(phi)], -1).reshape(-1, 3)
    _, u, v = direction_to_face_uv(d)
    x0 = torch.floor((u * 0.5 + 0.5) * res - 0.5)
    y0 = torch.floor((v * 0.5 + 0.5) * res - 0.5)
    out_u = (x0 < 0) | (x0 + 1 > res - 1)
    out_v = (y0 < 0) | (y0 + 1 > res - 1)
    corner = out_u & out_v
    octants = {tuple(s) for s in (d[corner] > 0).int().tolist()}
    return int((out_u ^ out_v).sum()), octants


def test_panorama_reaches_every_cube_corner():
    """The card test's (512, 1024) panorama of a 16^2 cubemap taps across
    face edges and takes the 3-texel mean at all 8 cube corners."""
    n_edge, octants = panorama_taps(16, 512, 1024)
    assert n_edge > 1000
    assert len(octants) == 8


@pytest.mark.parametrize("res", [8, 16])
@pytest.mark.parametrize("resolution", [(24, 48), None],
                         ids=["latlong", "cross"])
def test_cubemap_maps_wrapper_runs_plain_version_on_cpu(res, resolution):
    tex = sh0_texture(res)
    before = cubemap_maps.launches
    got = cubemap_maps(tex, resolution)
    assert cubemap_maps.launches == before
    rgb = sh02rgb(tex)
    want = (faces_to_cross(rgb) if resolution is None
            else cubemap_to_latlong(rgb, resolution))
    assert torch.equal(got, want)


def _nan_filled_pool(device, *shapes):
    """Leaves NaN-filled blocks of these shapes in the caching allocator,
    so outputs allocated next reuse them: an element a kernel skips
    stays NaN."""
    held = [torch.full(s, float("nan"), device=device) for s in shapes]
    del held


@pytest.mark.cuda
@pytest.mark.parametrize("res", [12, 16, 1024])
@pytest.mark.parametrize("hw", [(24, 48), (512, 1024)], ids=["24x48",
                                                           "512x1024"])
def test_cubemap_maps_kernel_matches_plain(cuda_device, res, hw):
    """Both maps against the plain chain on the card, one launch each; R =
    12 is no power of two, so there the seamless taps' (xi + 0.5) / R
    rounds otherwise in the kernel than in the plain chain, and must still
    pick the same texels."""
    tex = sh0_texture(res).to(cuda_device)
    rgb = sh02rgb(tex)
    want_pano = cubemap_to_latlong(rgb, hw)
    want_cross = faces_to_cross(rgb)
    _nan_filled_pool(cuda_device, (*hw, 3), (3 * res, 4 * res, 3))
    before = cubemap_maps.launches
    pano = cubemap_maps(tex, hw)
    assert cubemap_maps.launches == before + 1
    image = cubemap_maps(tex)
    assert cubemap_maps.launches == before + 2
    torch.cuda.synchronize()
    assert pano.shape == (*hw, 3) and image.shape == (3 * res, 4 * res, 3)
    assert torch.equal(image, want_cross)
    off = (pano - want_pano).abs().max().item()
    print(f"cubemap_maps R = {res}, {hw}: panorama max |kernel - plain| "
          f"{off:.3g}, {int((pano != want_pano).sum())} values not equal")
    assert off <= 1e-6


@pytest.mark.cuda
def test_cubemap_maps_rejects_a_strided_texture(cuda_device):
    tex = sh0_texture(16).to(cuda_device).transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        cubemap_maps(tex, (24, 48))


# ------------------------------------------- the projection, kernels P and P'
PROJ_OUTPUTS = ("means2d", "depths", "conics", "opacities", "normals")
PROJ_INPUTS = ("xyz", "scaling", "rotation", "opacity", "cov3d_precomp",
               "ndc_offset")


def projection_camera():
    """A camera at the origin looking down +z (world_view the identity,
    its centre 0), tan(fov / 2) 0.5 and 0.375 at 64x48: both focals are
    64, so at depth 4 on the axis J's diagonal is 16, exactly."""
    from texgs_torch.core.camera import make_camera
    return make_camera(np.eye(3), np.zeros(3), 2 * math.atan(0.5),
                       2 * math.atan(0.375), 64, 48)


# (xyz, scaling, rotation (w, x, y, z), opacity) of the edge cases, seen
# from projection_camera
PROJ_EDGE_ROWS = (
    ((0.0, 0.0, 0.1), (0.1, 0.2, 0.3), (0.9, 0.1, 0.2, 0.3), 0.5),   # near
    ((0.3, 0.2, -1.0), (0.1, 0.2, 0.3), (0.9, 0.1, 0.2, 0.3), 0.5),  # behind
    ((10.0, 0.5, 2.0), (0.1, 0.2, 0.3), (0.8, -0.3, 0.2, 0.1), 0.5),  # x clamp
    ((0.2, -10.0, 2.0), (0.3, 0.2, 0.1), (0.8, 0.3, -0.2, 0.4), 0.5),  # y clamp
    ((0.1, 0.1, 3.0), (0.1, 0.2, 0.3), (0.7, 0.1, 0.5, 0.2), 0.0),  # op 0
    ((0.5, 0.2, 5.0), (0.1, 0.1, 0.2), (0.6, 0.2, 0.1, 0.3), 0.6),  # ties
    ((0.5, -0.2, 5.0), (0.2, 0.1, 0.1), (0.6, 0.2, 0.1, 0.3), 0.6),
    ((-0.3, 0.1, 4.0), (0.1, 0.1, 0.1), (0.6, -0.2, 0.1, 0.3), 0.6),
    ((1.0, 0.0, 4.0), (0.2, 0.05, 0.2), (1.0, 0.0, 0.0, 0.0), 0.7),  # sign 0
    ((0.0, 0.0, 4.0), (0.2, 0.2, 0.05), (1.0, 0.0, 0.0, 0.0), 0.7),  # away
)
# a packed covariance at (0, 0, 4) whose dilated screen covariance has
# a = b = 0 exactly (16^2 * (-0.3 / 256) = -0.3): det = 0
DEGENERATE_XYZ = (0.0, 0.0, 4.0)
DEGENERATE_COV = (-0.3 / 256.0, 0.0, 0.0, 0.02, 0.0, 0.05)


def projection_inputs(case, n=2000, seed=0):
    """CPU inputs of a projection case: (dict of PROJ_INPUTS, camera,
    scaling_modifier).  Random Gaussians in and around the frustum of
    projection_camera (unnormalised quaternions, opacities in [0.05, 1])
    after PROJ_EDGE_ROWS; ``flat_discs`` is the benchmark's stage-3 scene
    cut to its test size, seen from one of its views."""
    rng = np.random.default_rng(seed)
    if case == "flat_discs":
        from benchmark import program, scene
        from benchmark.tests.tiny import tiny_cell
        cfg = tiny_cell("tgs3-dtu-train")["config"]
        state, _ = scene.make_state(cfg, 7, "cpu")
        cam = program.camera(scene.spiral_views(cfg["assumed"]["views"])[0])
        inputs = {"xyz": state["xyz"], "scaling": torch.exp(state["scaling"]),
                  "rotation": state["rotation"],
                  "opacity": torch.sigmoid(state["opacity"]),
                  "cov3d_precomp": None, "ndc_offset": None}
        return {k: v if v is None else v.detach().contiguous()
                for k, v in inputs.items()}, cam, 1.0
    cam = projection_camera()
    z = rng.uniform(0.5, 8.0, size=n)
    xy = rng.uniform(-0.9, 0.9, size=(n, 2)) * z[:, None] * [0.5, 0.375]
    rows = list(zip(*PROJ_EDGE_ROWS))
    xyz = np.concatenate([rows[0], np.column_stack([xy, z])])
    scaling = np.concatenate([rows[1],
                              np.exp(rng.uniform(-4.0, -1.0, size=(n, 3)))])
    rotation = np.concatenate([rows[2], rng.normal(size=(n, 4))])
    opacity = np.concatenate([rows[3], rng.uniform(0.05, 1.0, size=n)])
    def f32(a):
        return torch.as_tensor(np.ascontiguousarray(a, dtype=np.float32))
    inputs = {"xyz": f32(xyz), "scaling": f32(scaling),
              "rotation": f32(rotation), "opacity": f32(opacity[:, None]),
              "cov3d_precomp": None, "ndc_offset": None}
    modifier = 0.7 if case == "modifier" else 1.0
    if case == "ndc":
        inputs["ndc_offset"] = f32(rng.normal(scale=0.01, size=(len(xyz), 2)))
    if case in ("packed", "full"):
        a = rng.normal(scale=0.05, size=(len(xyz), 3, 3))
        full = a @ a.transpose(0, 2, 1)
        full[0] = [[DEGENERATE_COV[0], 0.0, 0.0], [7.0, 0.02, 0.0],
                   [7.0, 7.0, 0.05]]   # the lower triangle is never read
        inputs["xyz"][0] = f32(DEGENERATE_XYZ)
        iu = np.triu_indices(3)
        inputs["cov3d_precomp"] = (f32(full) if case == "full"
                                   else f32(full[:, iu[0], iu[1]]))
    return inputs, cam, modifier


def project_with(fn, inputs, cam, modifier, device, dtype=torch.float32):
    """fn (project_gaussians or project_plain) on copies of the inputs on
    ``device`` that require a gradient: (ProjectedGaussians, leaves)."""
    leaves = {k: None if v is None
              else v.to(device, copy=True).requires_grad_(True)
              for k, v in inputs.items()}
    as_t = (lambda a: torch.as_tensor(a, dtype=dtype, device=device)) \
        if fn is project.project_plain else (lambda a: a)
    out = fn(leaves["xyz"], leaves["scaling"], leaves["rotation"],
             leaves["opacity"], None, as_t(cam.world_view),
             as_t(cam.full_proj), as_t(cam.camera_center), cam.width,
             cam.height, cam.tanfovx, cam.tanfovy,
             scaling_modifier=modifier,
             cov3d_precomp=leaves["cov3d_precomp"],
             ndc_offset=leaves["ndc_offset"])
    return out, leaves


@pytest.mark.parametrize("case", ["plain", "packed", "full"])
def test_projection_wrapper_runs_plain_version_on_cpu(case):
    """On CPU tensors project_gaussians is project_plain, bit for bit,
    outputs and gradients, from the camera's numpy arrays, and counts no
    launch."""
    inputs, cam, modifier = projection_inputs(case, n=200)
    before = (project.project_gaussians.launches,
              project.project_gaussians_backward.launches)
    got, got_leaves = project_with(project.project_gaussians, inputs, cam,
                                   modifier, "cpu")
    want, want_leaves = project_with(project.project_plain, inputs, cam,
                                     modifier, "cpu")
    for name in (*PROJ_OUTPUTS, "radii"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    cots = [torch.ones_like(getattr(want, k)) for k in PROJ_OUTPUTS]
    torch.autograd.backward([getattr(got, k) for k in PROJ_OUTPUTS], cots)
    torch.autograd.backward([getattr(want, k) for k in PROJ_OUTPUTS], cots)
    for k, leaf in got_leaves.items():
        if leaf is not None:
            assert (leaf.grad is None) == (want_leaves[k].grad is None), k
            if leaf.grad is not None:
                assert torch.equal(leaf.grad, want_leaves[k].grad), k
    assert (project.project_gaussians.launches,
            project.project_gaussians_backward.launches) == before


def test_camera_arg_holds_the_plain_chains_numbers():
    """Kernel P's camera: the matrices and centre as float32, the focals
    and clamp limits as a float32 tensor meets them, and compute_cov2d's
    quad matrix, each entry rounded as the plain chain forms it."""
    cam = orbit_cameras(1, radius=3.5, width=80, height=64)[0]
    arg = project.camera_arg(cam.world_view, cam.full_proj,
                             cam.camera_center, 80, 64, cam.tanfovx,
                             cam.tanfovy, 0.7)
    f32 = np.float32
    assert list(arg.world_view) == cam.world_view.ravel().tolist()
    assert list(arg.full_proj) == cam.full_proj.ravel().tolist()
    assert list(arg.campos) == cam.camera_center.tolist()
    assert arg.focal_x == f32(80 / (2.0 * cam.tanfovx))
    assert arg.lim_y == f32(1.3 * cam.tanfovy)
    assert (arg.width, arg.height, arg.scaling_modifier) == (80, 64, f32(0.7))
    w = torch.as_tensor(cam.world_view)[:3, :3].T
    quad = torch.stack([torch.stack([
        w[i][0] * w[j][0], w[i][0] * w[j][1] + w[i][1] * w[j][0],
        w[i][0] * w[j][2] + w[i][2] * w[j][0], w[i][1] * w[j][1],
        w[i][1] * w[j][2] + w[i][2] * w[j][1], w[i][2] * w[j][2]])
        for i, j in zip([0, 0, 0, 1, 1, 2], [0, 1, 2, 1, 2, 2])], dim=1)
    assert list(arg.quad) == quad.ravel().tolist()
    # a tensor camera gives the same numbers
    again = project.camera_arg(*(torch.as_tensor(a) for a in (
        cam.world_view, cam.full_proj, cam.camera_center)), 80, 64,
        cam.tanfovx, cam.tanfovy, 0.7)
    assert bytes(again) == bytes(arg)


@pytest.mark.cuda
def test_projection_rejects_bad_inputs(cuda_device):
    inputs, cam, _ = projection_inputs("plain", n=64)
    args = {k: v if v is None else v.to(cuda_device)
            for k, v in inputs.items()}
    arg = project.camera_arg(cam.world_view, cam.full_proj, cam.camera_center,
                             cam.width, cam.height, cam.tanfovx, cam.tanfovy)
    bad = dict(args, rotation=args["rotation"].T.contiguous().T)
    with pytest.raises(ValueError, match="contiguous"):
        project.project_gaussians_forward(arg, *bad.values())
    bad = dict(args, opacity=args["opacity"].double())
    with pytest.raises(ValueError, match="float32"):
        project.project_gaussians_forward(arg, *bad.values())
    bad = dict(args, cov3d_precomp=torch.zeros(
        (args["xyz"].shape[0], 5), device=cuda_device))
    with pytest.raises(ValueError, match="cov3d_precomp"):
        project.project_gaussians_forward(arg, *bad.values())


def assert_projection_close(got, want, exact, case):
    """Kernel P's outputs against the plain chain's (tolerances: the module
    docstring); exact: the plain chain in float64.  Returns the count of
    radii that differ."""
    rel, plain_err, off = project.conic_offsets(got.conics, want.conics,
                                                exact.conics)
    print(f"projection {case}: conics max |kernel - plain| / |float64| "
          f"{rel.max().item() if rel.numel() else 0.0:.3g} a Gaussian, the "
          f"plain chain's own max {plain_err:.3g} off float64, {off} beyond "
          f"twice that")
    assert off == 0, "conics"
    for name, atol, rtol in (("means2d", 1e-6, 1e-6), ("depths", 1e-6, 1e-6),
                             ("normals", 1e-6, 0.0)):
        g, w = getattr(got, name), getattr(want, name)
        scale = w.abs().max().item() if w.numel() else 0.0
        err = (g - w).abs()
        off = int((err > atol * scale + rtol * w.abs()).sum())
        print(f"projection {case}: {name} max |kernel - plain| "
              f"{err.max().item() if err.numel() else 0.0:.3g} (max "
              f"|plain| {scale:.3g}), {off} beyond")
        assert off == 0, name
    assert torch.equal(got.opacities, want.opacities)
    assert torch.equal(got.radii > 0, want.radii > 0), "the visible set"
    differ = got.radii != want.radii
    # a radius may differ only where 3 sqrt(lambda1) lies within rounding
    # of an integer, and then by one
    assert bool(((got.radii - want.radii).abs()[differ] == 1).all())
    return int(differ.sum())


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["plain", "modifier", "ndc", "packed",
                                  "full", "flat_discs"])
def test_projection_kernels_match_plain(cuda_device, case):
    """Kernel P against the plain chain on the card, and P' against
    autograd through it on the same cotangents (read through strided
    views), for every input that takes a gradient; one launch each; the
    plain chain in float64 tells how far two float32 orders may part."""
    inputs, cam, modifier = projection_inputs(case)
    before = (project.project_gaussians.launches,
              project.project_gaussians_backward.launches)
    runs = [project_with(project.project_gaussians, inputs, cam, modifier,
                         cuda_device),
            project_with(project.project_plain, inputs, cam, modifier,
                         cuda_device),
            project_with(project.project_plain, {
                k: None if v is None else v.double()
                for k, v in inputs.items()}, cam, modifier, cuda_device,
                torch.float64)]
    (got, got_leaves), (want, want_leaves), (exact, exact_leaves) = runs
    n_radii = assert_projection_close(got, want, exact, case)
    print(f"projection {case}: {n_radii} of {got.radii.numel()} radii differ")
    if case != "flat_discs":   # the edge rows do what they are there for
        radii = got.radii.tolist()
        assert radii[1] == radii[4] == 0            # behind, opacity 0
        assert radii[0] == 0                        # near plane, or det = 0
        assert got.normals[8].tolist() == [0.0, 1.0, 0.0]    # sign 0 -> +1
        assert got.normals[9].tolist() == [0.0, 0.0, -1.0]   # faces away
        if case in ("packed", "full"):
            assert got.conics[0].tolist() == [0.0, 0.0, 0.0]
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    n = got.depths.shape[0]
    block = torch.randn((n, 16), generator=gen, device=cuda_device)
    # column views of one block: strided cotangents
    cots = [block[:, 0:2], block[:, 2], block[:, 3:6], block[:, 6],
            block[:, 7:10]]
    for out, dtype in ((got, None), (want, torch.float32),
                       (exact, torch.float64)):
        torch.autograd.backward(
            [getattr(out, k) for k in PROJ_OUTPUTS],
            cots if dtype is None else [c.to(dtype) for c in cots])
    assert (project.project_gaussians.launches - before[0],
            project.project_gaussians_backward.launches - before[1]) == (1, 1)
    # Gaussians whose float32 det is 0 have no float64 twin (there det is
    # not 0): they are held at the tight tolerance
    live = (want.conics != 0).any(1)
    well = (project.det_condition(exact.conics) <= 10.0) | ~live
    for k in PROJ_INPUTS:
        g, w, e = got_leaves[k], want_leaves[k], exact_leaves[k]
        if g is None:
            continue
        assert (g.grad is None) == (w.grad is None), k
        if w.grad is None:   # scaling beside a given covariance
            continue
        assert bool(torch.isfinite(g.grad).all()), k
        err = (g.grad - w.grad).abs()
        rows = err.reshape(n, -1)[well]
        want_rows = w.grad.reshape(n, -1)[well]
        scale = want_rows.abs().max().item() if want_rows.numel() else 0.0
        off = int((rows > 1e-5 * scale + 1e-4 * want_rows.abs()).sum())
        own = (w.grad.double() - e.grad).reshape(n, -1)[live].abs()
        own = own.max().item() if own.numel() else 0.0
        top = e.grad.reshape(n, -1)[live].abs()
        top = top.max().item() if top.numel() else 0.0
        err_live = err.reshape(n, -1)[live]
        err_live = err_live.max().item() if err_live.numel() else 0.0
        print(f"projection {case}: d {k} max |kernel - autograd| "
              f"{err.max().item():.3g} (max |autograd| "
              f"{w.grad.abs().max().item():.3g}); {off} beyond on the "
              f"{int(well.sum())} Gaussians with a well-conditioned det; "
              f"autograd's own max {own:.3g} off float64")
        assert off == 0, k
        assert err_live <= 2 * own + 1e-5 * top, k


@pytest.mark.cuda
def test_projection_kernels_empty(cuda_device):
    inputs, cam, _ = projection_inputs("plain", n=0)
    inputs = {k: v if v is None else v[:0].contiguous()
              for k, v in inputs.items()}
    before = (project.project_gaussians.launches,
              project.project_gaussians_backward.launches)
    got, leaves = project_with(project.project_gaussians, inputs, cam, 1.0,
                               cuda_device)
    assert got.means2d.shape == (0, 2) and got.radii.shape == (0,)
    (got.means2d.sum() + got.conics.sum()).backward()
    assert leaves["xyz"].grad.shape == (0, 3)
    assert (project.project_gaussians.launches,
            project.project_gaussians_backward.launches) == before


@pytest.mark.cuda
def test_projection_without_grad_launches_no_backward(cuda_device):
    inputs, cam, _ = projection_inputs("plain", n=64)
    before = (project.project_gaussians.launches,
              project.project_gaussians_backward.launches)
    with torch.no_grad():
        got, _ = project_with(project.project_gaussians, inputs, cam, 1.0,
                              cuda_device)
    assert not got.means2d.requires_grad
    plain = {k: None if v is None else v.to(cuda_device)
             for k, v in inputs.items()}
    project.project_gaussians(
        plain["xyz"], plain["scaling"], plain["rotation"], plain["opacity"],
        None, cam.world_view, cam.full_proj, cam.camera_center, cam.width,
        cam.height, cam.tanfovx, cam.tanfovy)   # no input needs a gradient
    assert (project.project_gaussians.launches - before[0],
            project.project_gaussians_backward.launches - before[1]) == (2, 0)


def test_plain_twin_swaps_the_projection():
    """verify_compiled's plain twin replaces project_gaussians with
    project_plain, fed the camera's numpy arrays as tensors, so the twin's
    renders check kernels P and P'."""
    from texgs_torch.tools.verify_compiled import plain_kernels

    inputs, cam, modifier = projection_inputs("ndc", n=200)
    want, _ = project_with(project.project_plain, inputs, cam, modifier,
                           "cpu")
    wrapper = project.project_gaussians
    with plain_kernels():
        assert project.project_gaussians is not wrapper
        got, _ = project_with(project.project_gaussians, inputs, cam,
                              modifier, "cpu")
    assert project.project_gaussians is wrapper
    for name in (*PROJ_OUTPUTS, "radii"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name


@pytest.mark.cuda
def test_verifier_refuses_a_corrupted_projection_on_the_card(cuda_device,
                                                            monkeypatch):
    """Kernel P's means moved one pixel right: the verifier's stage-1
    check, whose twin runs the plain projection, fails."""
    verify_compiled = _small_verifier(monkeypatch)
    clean = project.project_gaussians_forward

    def corrupted(*args, **kw):
        means2d, *rest = clean(*args, **kw)
        return (means2d + torch.tensor([1.0, 0.0], device=means2d.device),
                *rest)
    monkeypatch.setattr(project, "project_gaussians_forward", corrupted)
    ok, results = verify_compiled.verify_raster(20000, 128, 128,
                                                device=cuda_device)
    assert not ok
    assert results["fwd_image"] > verify_compiled.REL_TOL_FWD


def reduced_spans(tmp_path, fn, n):
    """benchmark.spans' reduction of a torch.profiler trace of n calls of
    fn, behind a spin kernel (the trace can miss a profile's first device
    events)."""
    import json

    from torch.profiler import ProfilerActivity, profile

    from benchmark import spans
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(4_000_000)
        torch.cuda.synchronize()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    return spans.reduce(json.loads(path.read_text())["traceEvents"])


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["gs1-dtu-train", "tgs3-dtu-train",
                                  "tgs3-obj-view"])
def test_projection_engages_in_each_cell(cuda_device, tmp_path, cell):
    """On the benchmark's cells cut to their test size, a training step or
    a viewer frame runs render.project as one launch of kernel P and no
    host sync, and a training step's backward one launch of P'; a frame
    (rendered under no_grad) launches no P'."""
    from benchmark.tests.tiny import tiny_cell
    if cell == "gs1-dtu-train":
        from benchmark.drivers import gs1_train_loop
        from benchmark.tests.tiny_gs1 import tiny_gs1_cell
        c = tiny_gs1_cell()
        ses = gs1_train_loop.Session(c["config"], c["work"]["traffic_params"],
                                     7, cuda_device)
        fn, grads = ses.step, 1
    elif cell == "tgs3-dtu-train":
        from benchmark.drivers import train_loop
        c = tiny_cell(cell)
        ses = train_loop.Session(c["config"], c["work"]["traffic_params"], 7,
                                 cuda_device)
        fn, grads = ses.step, 1
    else:
        from benchmark import program, scene
        from benchmark.drivers import view_loop
        c = tiny_cell(cell)
        cfg, work = c["config"], c["work"]["traffic_params"]
        state, _ = scene.make_state(cfg, 7, cuda_device)
        model = program.build_model(cfg, state, view_loop.hyper(cfg),
                                    cuda_device, train=False)
        cam = program.camera(view_loop.orbit(work, 7)(0))

        def fn():
            model.visual_step(0, 0, cam, None)
        grads = 0
    fn()
    n = 2
    before = (project.project_gaussians.launches,
              project.project_gaussians_backward.launches)
    rows = reduced_spans(tmp_path, fn, n)["spans"]
    assert (project.project_gaussians.launches - before[0],
            project.project_gaussians_backward.launches - before[1]) == \
        (n, grads * n)
    empty = {"launches": 0, "syncs": 0}
    own, kernel = rows["render.project"], rows.get("kernel.project", empty)
    bwd = rows.get("kernel.project_bwd", empty)
    print(f"{cell}: render.project {own['launches']} + kernel.project "
          f"{kernel['launches']} launches, {own['syncs'] + kernel['syncs']} "
          f"syncs in {n} renders; kernel.project_bwd {bwd['launches']}")
    assert own["launches"] + kernel["launches"] == n
    assert own["syncs"] + kernel["syncs"] == 0
    assert bwd["launches"] == grads * n and bwd["syncs"] == 0
