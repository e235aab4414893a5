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
Kernels 1 and 1' (the stage-1/2 blend, and the two-kernel stage-3 blend at
F = 10) are held as A and A' are, without the M-list and uv rows; kernels
2 and 2' (the two-kernel stage-3 M-lists) as A and A' are, without the
blend channels.
"""

import numpy as np
import pytest
import torch

from texgs_torch.core.state import init_from_pcd
from texgs_torch.data.synthetic import (orbit_cameras,
                                        textured_sphere_point_cloud)
from texgs_torch.kernels import binning, project, tile_raster, uvtex_raster
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


def _to(dev, args):
    table, uv_rows, pairs, rays, gx, m = args
    return (table.to(dev), uv_rows.to(dev),
            binning.PairList(*(t.to(dev) for t in pairs)), rays, gx, m)


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


@pytest.mark.cuda
@pytest.mark.parametrize("levels,size,n", [(8, 4096, 8192), (2, 256, 1000)])
def test_hash_gather_kernel_matches_plain(cuda_device, levels, size, n):
    table, idx = hash_inputs(levels, size, n=n)
    table, idx = table.to(cuda_device), idx.to(cuda_device)
    before = hash_gather.launches
    got = hash_gather(table, idx)
    torch.cuda.synchronize()
    assert hash_gather.launches == before + 1
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
    return table.to(dev), binning.PairList(*(t.to(dev) for t in pairs)), gx


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
    err = _build.function("raster", "raster_forward", kr._FWD_ARGS)(
        p(wide), wide.shape[1], p(pairs.pair_gauss), p(pairs.tile_start),
        p(pairs.tile_end), n_tiles, gx, 8, p(out), p(t_fin), p(n_eval),
        _build.stream_of(wide))
    assert err == 1  # cudaErrorInvalidValue
    err = _build.function("raster_bwd", "raster_backward", kr._BWD_ARGS)(
        p(wide), wide.shape[1], p(pairs.pair_gauss), p(pairs.tile_start),
        p(pairs.tile_end), n_tiles, gx, 8, p(out), p(t_fin), p(out),
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


@pytest.mark.cuda
@pytest.mark.parametrize("m,n_extra", [(8, 3), (32, 3), (32, 0), (5, 0)])
def test_mlist_kernel_matches_plain(cuda_device, m, n_extra):
    """Kernel 2 against its plain version, and against kernel A's M-lists:
    the two-kernel render and the fused one keep the same contributors."""
    args = _to(cuda_device, kernel_a_inputs(m=m, n_extra=n_extra))
    before = mlist_pairs.launches
    got = mlist_pairs(*args)
    torch.cuda.synchronize()
    assert mlist_pairs.launches == before + 1
    for want in (mlist_only_scan(*args), fused_pairs(*args)[2]):
        assert _slots_off(got, want) <= 4
        assert (got[..., 0] - want[..., 0]).abs().max().item() <= 0.05
    assert bool((got[..., 0] > 0).any())


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
