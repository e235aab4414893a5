"""On-card kernel verification: every CUDA kernel against its plain twin
(port of texgs/tools/verify_compiled.py).

The tests hold the kernels against their plain versions on small inputs;
this tool holds them at production shapes, through whole renders, on the
outputs and on every parameter gradient, and prints one JSON verdict.
The "twin" is the same render with every kernel wrapper swapped for its
plain PyTorch version (``plain_kernels``); nothing on the main path
reaches that swap.

Checks:
  raster      : the stage-1 render (kernels P, 1, P', 1'): image, alpha,
                depth (covered pixels), norm; gradients into xyz, scaling,
                rotation, opacity, f_dc and f_rest
  uvtex       : uv_tex_render at m = 32 on the two-kernel path
                (backend "pallas": kernels P, 1, 2, B, P', 1', 2', B'): the
                image; gradients into the texture, the uvs and xyz
  uvtex_fused : the same on the fused path (backend "auto": P, A, B, P',
                A', B'), the port's main path
  tex_term    : kernels B and B' on a coherent M-list: the term, and its
                gradients into the M-list's live slots and the texture

Gradient tolerances are relative to the twin gradient's max magnitude, at
its 99.9th percentile: autodiff of the blend near the 0.99 alpha clamp is
ill-conditioned in any implementation, and a borderline contribution can
flip between two f32 implementations that round differently.  A max
guard catches a corrupted band that the percentile would not see.

The plain backward of the M-list scan keeps ~24 (tiles, 256, 64) f32
intermediates a chunk of 64 pairs, which need not fit on the card at
800x600.  The twin's gradients are then built over bands of tile rows:
each band's plain scans run on that band's tiles alone (its slice of the
pair list, at the band's place in the frame), with the image cotangent
masked to the band; the bands' gradients are summed.  That is the same
gradient apart from the order of the sums.  The verdict gives each check's ``plain_tile_groups``.

Unlike texgs's tool, the tex_term check has no ``unserved`` count: kernel
B computes the exact texture term (texgs's textile kernel missed texels
by design).

    python -m texgs_torch.tools.verify_compiled [--device cuda|cpu]
    python -m texgs_torch.tools.bench --verify

Env: VERIFY_N (Gaussians, default 100000), VERIFY_W/H (800x600),
     VERIFY_TEX (cubemap resolution, 512).  Exit 0 when every check holds.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import sys
import time

import numpy as np
import torch

REL_TOL_FWD = 1e-4    # vs output max, 99.9th percentile
REL_TOL_GRAD = 2e-2   # vs grad max, 99.9th percentile
# gross-corruption guards on the max: loose enough for a borderline
# contribution flipping inclusion (alpha >= 1/255, ~4e-3 relative; a
# sign-flipped max gradient element, ~1), tight enough that a corrupted
# pixel band (< 0.1% of pixels, invisible to the percentile) still fails
MAX_TOL_FWD = 100 * REL_TOL_FWD
MAX_TOL_GRAD = 1.0
# f32 intermediates of the plain M-list backward per (tile, pixel, pair of
# a chunk), and the share of the card's free memory a band may take
PLAIN_INTERMEDIATES = 24
PLAIN_MEMORY_SHARE = 0.5
TEX_TERM_TILES = 256  # tiles of the tex_term check's M-list (texgs's)


def _rel_err(got, ref):
    """(q999, max) of |got - ref| relative to max|ref|.

    The gate is the 99.9th percentile, not the max: the sequential-stop
    semantics (alpha >= 1/255, alpha clamp 0.99, T < 1e-4 stop) make a
    handful of borderline contributions flip inclusion between any two
    f32 implementations that round differently, and one flipped
    contribution dominates a max-based metric while the field agrees to
    ~1e-7 everywhere else."""
    def as_np(a):
        if hasattr(a, "detach"):
            a = a.detach().cpu().numpy()
        return np.asarray(a, np.float64)

    got, ref = as_np(got), as_np(ref)
    denom = max(float(np.abs(ref).max()), 1e-12)
    err = np.abs(got - ref) / denom
    return float(np.quantile(err, 0.999)), float(err.max())


# ------------------------------------------------------------- the twin
@contextlib.contextmanager
def _swapped(swaps):
    """Each (module, name, fn) of ``swaps``: module.name is fn inside."""
    old = [(mod, name, getattr(mod, name)) for mod, name, _ in swaps]
    for mod, name, fn in swaps:
        setattr(mod, name, fn)
    try:
        yield
    finally:
        for mod, name, fn in old:
            setattr(mod, name, fn)


def _band_pairs(pairs, band):
    """The pair list of the tile rows [r0, r1) of a grid ``gx`` tiles
    wide, and the band's first and one-past-last frame tile."""
    r0, r1, gx = band
    t0, t1 = r0 * gx, r1 * gx
    sub = pairs._replace(tile_start=pairs.tile_start[t0:t1],
                         tile_end=pairs.tile_end[t0:t1],
                         tile_counts=pairs.tile_counts[t0:t1], tile_order=None)
    return sub, (t0, t1)


def _in_frame(outs, n_tiles, span):
    """Band outputs (tiles first) placed among zeros for the frame's
    ``n_tiles`` tiles."""
    t0, t1 = span

    def place(o):
        before = o.new_zeros((t0, *o.shape[1:]))
        after = o.new_zeros((n_tiles - t1, *o.shape[1:]))
        return torch.cat([before, o, after])
    return tuple(place(o) for o in outs)


@contextlib.contextmanager
def plain_kernels(band=None, seen=None):
    """Every kernel wrapper on the render paths (P, 1, 2, A, B with their
    backwards) swapped for its plain PyTorch version, differentiable by
    autograd, inside the block.

    band: (r0, r1, gx), the tile rows the plain versions compute; the
    other tiles' outputs are zeros (a cotangent masked to the band sees no
    difference).  seen: a dict that gets the largest tile's pair count and
    the tile count of the pair lists the block's scans took."""
    from texgs_torch.kernels import project as kp
    from texgs_torch.kernels import raster as kr
    from texgs_torch.kernels import tex_term as kt
    from texgs_torch.kernels import uvtex_fused as kf
    from texgs_torch.kernels import uvtex_mlist as km
    from texgs_torch.kernels.reference import TILE

    def scan(fn, pairs_at):
        """fn's plain version; its pair list is argument ``pairs_at``."""
        def plain(*args):
            pairs = args[pairs_at]
            if seen is not None:
                seen["max_tile_pairs"] = max(seen.get("max_tile_pairs", 0),
                                             int(pairs.tile_counts.max()))
                seen["n_tiles"] = pairs.tile_counts.numel()
            if band is None:
                return fn(*args)
            sub, span = _band_pairs(pairs, band)
            out = fn(*args[:pairs_at], sub, *args[pairs_at + 1:],
                     tile0=span[0])
            n_tiles = pairs.tile_counts.numel()
            if isinstance(out, tuple):
                return _in_frame(out, n_tiles, span)
            return _in_frame((out,), n_tiles, span)[0]
        return plain

    def tex(mlist, texture, height, width, filter_mode="bilinear"):
        if band is None:
            return kt.mlist_tex_term(mlist, texture, height, width,
                                     filter_mode)
        r0, r1, gx = band
        img = kt.mlist_tex_term(mlist[r0 * gx:r1 * gx], texture,
                                (r1 - r0) * TILE, width, filter_mode)
        rows = -(-height // TILE) * TILE
        img = torch.cat([img.new_zeros((3, r0 * TILE, width)), img,
                         img.new_zeros((3, rows - r1 * TILE, width))], dim=1)
        return img[:, :height]

    def project(xyz, scaling, rotation, opacity, colors, world_view,
                full_proj, campos, *args, **kw):
        def on_device(a):
            return torch.as_tensor(a, dtype=torch.float32, device=xyz.device)
        return kp.project_plain(xyz, scaling, rotation, opacity, colors,
                                on_device(world_view), on_device(full_proj),
                                on_device(campos), *args, **kw)

    with _swapped([(kp, "project_gaussians", project),
                   (kr, "raster_pairs", scan(kr.raster_scan, 1)),
                   (km, "mlist_pairs", scan(km.mlist_only_scan, 2)),
                   (kf, "fused_pairs", scan(kf.mlist_scan, 2)),
                   (kt, "tex_term", tex)]):
        yield


def tile_bands(gy: int, groups: int):
    """``groups`` bands of whole tile rows covering ``gy`` rows:
    [(r0, r1), ...]."""
    edges = np.linspace(0, gy, groups + 1).round().astype(int)
    return [(int(a), int(b)) for a, b in zip(edges[:-1], edges[1:]) if b > a]


def plain_groups(seen: dict, device) -> int:
    """How many bands of tile rows the plain backward needs to fit in half
    of the card's free memory (1 on the CPU)."""
    device = torch.device(device)
    if device.type != "cuda" or not seen:
        return 1
    from texgs_torch.kernels.uvtex_fused import CHUNK

    n_chunks = -(-seen["max_tile_pairs"] // CHUNK)
    need = (n_chunks * PLAIN_INTERMEDIATES * seen["n_tiles"] * 256 * CHUNK
            * 4)
    free = torch.cuda.mem_get_info(device)[0]
    return max(1, math.ceil(need / (PLAIN_MEMORY_SHARE * free)))


def _grads(loss_fn, leaves):
    """(gradients of loss_fn()'s loss into ``leaves``, its outputs)."""
    for p in leaves.values():
        p.grad = None
    with torch.enable_grad():
        loss, outs = loss_fn()
        loss.backward()
    grads = {k: p.grad.detach().clone() for k, p in leaves.items()}
    for p in leaves.values():
        p.grad = None
    return grads, [o.detach() for o in outs]


def kernel_and_plain(loss_fn, leaves, cot, groups=None):
    """Gradients and outputs of ``loss_fn(cot)`` on the kernel path and on
    the plain twin, the twin over ``groups`` bands of tile rows (None:
    as many as the card's memory needs).  Returns (kernel (grads, outs),
    twin (grads, outs), the bands used)."""
    from texgs_torch.kernels.reference import TILE

    kernel = _grads(lambda: loss_fn(cot), leaves)
    seen = {}
    with torch.no_grad(), plain_kernels(seen=seen):
        outs = [o.detach() for o in loss_fn(cot)[1]]
    if groups is None:
        groups = plain_groups(seen, cot.device)
    if groups == 1:
        with plain_kernels():
            grads, _ = _grads(lambda: loss_fn(cot), leaves)
        return kernel, (grads, outs), 1
    height, width = cot.shape[-2:]
    gy, gx = -(-height // TILE), -(-width // TILE)
    bands = tile_bands(gy, groups)
    grads = {k: torch.zeros_like(p) for k, p in leaves.items()}
    rows = torch.arange(height, device=cot.device)[:, None]
    for r0, r1 in bands:
        keep = (rows >= r0 * TILE) & (rows < r1 * TILE)
        cot_b = torch.where(keep, cot, 0.0)
        with plain_kernels(band=(r0, r1, gx)):
            g, _ = _grads(lambda: loss_fn(cot_b), leaves)
        for k in grads:
            grads[k] += g[k]
    return kernel, (grads, outs), len(bands)


def _judge(results, fwd, grads):
    """ok when every forward and gradient metric meets its tolerances."""
    return (all(results[f"fwd_{k}"] <= REL_TOL_FWD
                and results[f"fwd_{k}_max"] <= MAX_TOL_FWD for k in fwd)
            and all(results[f"grad_{k}"] <= REL_TOL_GRAD
                    and results[f"grad_{k}_max"] <= MAX_TOL_GRAD
                    for k in grads))


# --------------------------------------------------------------- checks
def _scene(n, width, height, device):
    from texgs_torch.core.state import init_from_pcd
    from texgs_torch.data.synthetic import blob_point_cloud, orbit_cameras

    pcd = blob_point_cloud(n, seed=0)
    state = init_from_pcd(pcd.points, pcd.colors, max_sh_degree=2,
                          device=device)
    cam = orbit_cameras(1, radius=3.5, width=width, height=height)[0]
    return state, cam


def verify_raster(n, width, height, device="cuda", groups=None):
    """The stage-1 render, kernel path against the twin.  Returns (ok,
    results)."""
    from texgs_torch.render.render import render

    device = torch.device(device)
    state, cam = _scene(n, width, height, device)
    cot = torch.as_tensor(np.random.default_rng(7).normal(
        size=(3, height, width)), dtype=torch.float32, device=device)
    params = {k: p.detach().clone().requires_grad_(True)
              for k, p in state.params_dict().items()}
    bg = torch.zeros(3, device=device)

    def loss(c):
        rot = params["rotation"]
        out = render(cam, xyz=params["xyz"],
                     opacity=torch.sigmoid(params["opacity"]),
                     scaling=torch.exp(params["scaling"]),
                     rotation=rot / (torch.linalg.norm(
                         rot, dim=-1, keepdim=True) + 1e-12),
                     features=torch.cat([params["f_dc"], params["f_rest"]], 1),
                     active_sh_degree=2, bg_color=bg)
        return (out["render"] * c).sum(), (out["render"], out["alpha"],
                                           out["depth"], out["norm"])

    (g_k, v_k), (g_p, v_p), n_groups = kernel_and_plain(loss, params, cot,
                                                        groups)
    results = {}
    # depth is alpha-normalised: near-empty pixels give noise-amplified
    # quotients on both sides, so depth counts covered pixels only
    covered = v_p[1] > 1e-2
    for name, i in (("image", 0), ("alpha", 1), ("depth", 2), ("norm", 3)):
        a, b = v_k[i], v_p[i]
        if name == "depth":
            a, b = a[covered], b[covered]
        results[f"fwd_{name}"], results[f"fwd_{name}_max"] = _rel_err(a, b)
    for k in params:
        results[f"grad_{k}"], results[f"grad_{k}_max"] = _rel_err(g_k[k],
                                                                  g_p[k])
    results["plain_tile_groups"] = n_groups
    return _judge(results, ("image", "alpha", "depth", "norm"), params), results


def verify_uvtex(n, width, height, tex_res, device="cuda", backend="pallas",
                 groups=None):
    """uv_tex_render at m = 32, bilinear, on ``backend``'s path ("pallas":
    kernels 1 and 2; "auto": A), kernel path against the twin.  UVs are a
    smooth analytic map, normalize(xyz), with its true Jacobian, as a
    trained stage-2 net gives.  Returns (ok, results)."""
    from texgs_torch.render.uv_tex_render import uv_tex_render

    device = torch.device(device)
    state, cam = _scene(n, width, height, device)
    rng = np.random.default_rng(11)
    xyz0 = state.xyz
    norm = torch.linalg.norm(xyz0, dim=-1, keepdim=True) + 1e-9
    uvs0 = xyz0 / norm
    # d(x/|x|)/dx = (I - u u^T) / |x|, flattened (N, 9)
    eye = torch.eye(3, device=device)[None]
    grad_uvs = ((eye - uvs0[:, :, None] * uvs0[:, None, :])
                / norm[:, :, None]).reshape(-1, 9)

    def arr(a):
        return torch.as_tensor(a, dtype=torch.float32, device=device)

    leaves = {"texture": arr(rng.uniform(size=(6, tex_res, tex_res, 3))),
              "uvs": uvs0.clone(), "xyz": xyz0.clone()}
    for p in leaves.values():
        p.requires_grad_(True)
    shs = arr(rng.normal(size=(xyz0.shape[0], 8, 3)) * 0.01)
    cot = arr(rng.normal(size=(3, height, width)))
    bg = torch.zeros(3, device=device)
    opacity, scaling = state.get_opacity(), state.get_scaling()
    rotation = state.get_rotation()

    def loss(c):
        out = uv_tex_render(
            cam, xyz=leaves["xyz"], opacity=opacity, scaling=scaling,
            rotation=rotation, uvs=leaves["uvs"], grad_uvs=grad_uvs,
            texture=leaves["texture"], shs=shs, active_sh_degree=2,
            bg_color=bg, m=32, filter_mode="bilinear", backend=backend,
            tex_backend="xla")
        return (out["render"] * c).sum(), (out["render"],)

    (g_k, v_k), (g_p, v_p), n_groups = kernel_and_plain(loss, leaves, cot,
                                                        groups)
    results = {}
    results["fwd_image"], results["fwd_image_max"] = _rel_err(v_k[0], v_p[0])
    for k in leaves:
        results[f"grad_{k}"], results[f"grad_{k}_max"] = _rel_err(g_k[k],
                                                                  g_p[k])
    results["plain_tile_groups"] = n_groups
    return _judge(results, ("image",), leaves), results


def coherent_mlist(tex_res, n_tiles=256, m=32, seed=3):
    """(M-lists (n_tiles, 256, m, 4), texture (6, R, R, 3), cotangent
    (3, H, W), H = W) as numpy arrays: texgs's coherent M-list
    (verify_compiled.py:196-231): each tile's live slots point into one
    face near a per-tile center, away from the face's edges; dead slots
    (w = 0) have a zero direction."""
    h = w = int(np.sqrt(n_tiles)) * 16
    rng = np.random.default_rng(seed)
    wgt = rng.uniform(0.01, 0.4, size=(n_tiles, 256, m)).astype(np.float32)
    wgt = wgt * (rng.uniform(size=wgt.shape) < 0.6)
    face = rng.integers(0, 6, size=(n_tiles, 1, 1))
    fu = rng.uniform(-0.55, 0.55, size=(n_tiles, 1, 1))
    fv = rng.uniform(-0.55, 0.55, size=(n_tiles, 1, 1))
    u = fu + 0.02 * rng.normal(size=(n_tiles, 256, m))
    v = fv + 0.02 * rng.normal(size=(n_tiles, 256, m))
    u = np.clip(u, -0.9, 0.9)
    v = np.clip(v, -0.9, 0.9)
    one = np.ones_like(u)
    by_face = np.stack([
        np.stack([one, -v, -u], -1), np.stack([-one, -v, u], -1),
        np.stack([u, one, v], -1), np.stack([u, -one, -v], -1),
        np.stack([u, -v, one], -1), np.stack([-u, -v, -one], -1)],
        axis=0)                                  # (6, T, 256, m, 3)
    dirs = by_face[face[:, 0, 0], np.arange(n_tiles)]   # (T, 256, m, 3)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    dirs = np.where(wgt[..., None] > 0, dirs, 0.0).astype(np.float32)
    mlist = np.concatenate([wgt[..., None], dirs], axis=-1)
    tex = rng.uniform(size=(6, tex_res, tex_res, 3)).astype(np.float32)
    cot = rng.normal(size=(3, h, w)).astype(np.float32)
    return mlist, tex, cot


def verify_tex_term(tex_res, device="cuda", n_tiles=256, m=32):
    """Kernels B and B' against the plain ``mlist_tex_term`` and its
    autograd on a coherent M-list: the term, and the gradients into the
    M-list's live slots and the texture.  Returns (ok, results)."""
    from texgs_torch.kernels import tex_term as kt

    device = torch.device(device)
    mlist, tex, cot = (torch.as_tensor(a, device=device)
                       for a in coherent_mlist(tex_res, n_tiles, m))
    h, w = cot.shape[1:]
    leaves = {"mlist": mlist.requires_grad_(True),
              "texture": tex.requires_grad_(True)}

    def loss():
        img = kt.tex_term(leaves["mlist"], leaves["texture"], h, w)
        return (img * cot).sum(), (img,)

    g_k, v_k = _grads(loss, leaves)
    with plain_kernels():
        g_p, v_p = _grads(loss, leaves)
    live = mlist[..., 0].detach() > 0
    results = {}
    results["fwd_image"], results["fwd_image_max"] = _rel_err(v_k[0], v_p[0])
    results["grad_texture"], results["grad_texture_max"] = _rel_err(
        g_k["texture"], g_p["texture"])
    results["grad_mlist"], results["grad_mlist_max"] = _rel_err(
        g_k["mlist"][live], g_p["mlist"][live])
    return _judge(results, ("image",), ("texture", "mlist")), results


def main(argv=None) -> int:
    import argparse

    from texgs_torch.tools.bench import device_name

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    device = torch.device(parser.parse_args(argv).device)
    n = int(os.environ.get("VERIFY_N", 100_000))
    width = int(os.environ.get("VERIFY_W", 800))
    height = int(os.environ.get("VERIFY_H", 600))
    tex_res = int(os.environ.get("VERIFY_TEX", 512))

    verdict = {
        "backend": device_name(device),
        "compiled": device.type == "cuda",
        "shapes": {"n_gauss": n, "width": width, "height": height,
                   "tex_res": tex_res, "m": 32},
        "rel_tol_fwd": REL_TOL_FWD,
        "rel_tol_grad": REL_TOL_GRAD,
    }

    def record(name, check, *args, **kw):
        t0 = time.perf_counter()
        ok, results = check(*args, device=device, **kw)
        verdict[name] = {"ok": ok, **{k: (round(v, 8) if isinstance(v, float)
                                          else v) for k, v in results.items()},
                         "seconds": round(time.perf_counter() - t0, 3)}
        return ok

    t0 = time.perf_counter()
    oks = [record("raster", verify_raster, n, width, height),
           record("uvtex", verify_uvtex, n, width, height, tex_res,
                  backend="pallas"),
           record("uvtex_fused", verify_uvtex, n, width, height, tex_res,
                  backend="auto"),
           record("tex_term", verify_tex_term, tex_res,
                  n_tiles=TEX_TERM_TILES)]
    verdict["ok"] = all(oks)
    verdict["seconds"] = round(time.perf_counter() - t0, 3)
    print(json.dumps(verdict), flush=True)
    return 0 if verdict["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
