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
"""

import numpy as np
import pytest
import torch

from texgs_torch.core.state import init_from_pcd
from texgs_torch.data.synthetic import (orbit_cameras,
                                        textured_sphere_point_cloud)
from texgs_torch.kernels import binning, project, tile_raster, uvtex_raster
from texgs_torch.kernels.tex_term import mlist_tex_term, tex_term
from texgs_torch.kernels.uvtex_fused import fused_pairs, mlist_scan


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
