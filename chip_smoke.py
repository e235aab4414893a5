#!/usr/bin/env python3
"""GPU smoke run of texgs_torch, the PyTorch + CUDA port of texgs.

Run from the repository root on a machine with an NVIDIA H100:

    python3 chip_smoke.py

It imports the port only (no JAX, nothing of the texgs package) and needs
one card.  Phases, in order; any failure exits non-zero:

  1. device  -- requires CUDA, prints the card's name and power limit;
  2. build   -- compiles every kernel of the stage-3 render from
                texgs_torch/csrc (one nvcc per source, all started together);
  3. setup   -- the flagship stage-3 model at full width: 100,000
                Gaussians on a textured sphere, SH degree 3, an MLP UV net
                (emb 128, 128-wide) pre-fitted to normalize(xyz), a 1024^2
                cubemap, 800x600 views, m = 32;
  4. kernels -- each kernel against its plain PyTorch version on the card,
                on the inputs the main path gives it for the first view;
                kernel B also on cube edge and corner directions;
  5. main    -- 3 orbit views through TextureGaussian3D.visual_step, a
                change_texture(chessboard, mode=0) retexture, the 3 views
                again; every kernel's launch count is read over this phase;
  6. timings -- per-view and per-kernel times (CUDA events, median of 5),
                and one render under torch.profiler: the device's busy
                share and its time by kernel and by operator.

The line before the last is a JSON object with one entry per kernel; the
last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import json
import math
import subprocess
import sys
import time

import numpy as np

N_GAUSS = 100_000
WIDTH, HEIGHT = 800, 600
TEX_RES = 1024
N_VIEWS = 3
REPS = 5

# model_cfg of configs/prod_texture.yaml (the flagship stage-3 config of
# texgs/tools/bench_stage3.py), minus its checkpoint paths
MODEL_CFG = {
    "type": "TextureGaussian3D",
    "background": [0, 0, 0],
    "max_inverse_points": 8192,
    "uv_net_cfg": {
        "emb_dim": 128,
        "pre_mlp_cfg": {"n_hidden_layers": 1, "n_neurons": 128},
        "mlp_cfg": {"n_hidden_layers": 2, "n_neurons": 128},
    },
    "inv_uv_net_cfg": {
        "emb_dim": 128,
        "n_sample_points": 2048,
        "patch_scale": 8,
        "pre_mlp_cfg": {
            "hash_grid_cfg": {"n_levels": 8, "n_features_per_level": 4,
                              "max_hashmap": 12},
            "n_hidden_layers": 1, "n_neurons": 128},
        "mlp_cfg": {"n_hidden_layers": 2, "n_neurons": 128},
    },
    "tex_cfg": {"resolution": 1024, "max_sh_degree": 3},
    "geo_emb_dim": 128,
}

H100_BYTES_PER_S = 3.35e12   # HBM3, H100 SXM data sheet
H100_F32_FLOPS = 67e12       # f32 outside the tensor cores
# f32 operations of kernel A per evaluated (pixel, pair) besides the
# 2 * F of the blend, per written M-list slot; of kernel B per live slot
OPS_A_EVAL = 16
OPS_A_SLOT = 60
OPS_B_SLOT = 300   # seamless bilinear, the main path's filter
# pixels of a frame where kernel A may stop one Gaussian apart from its
# plain version (see check_kernel_a)
MAX_OFF_PIXELS = 16


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def median_ms(torch, fn, reps=REPS):
    """Median of `reps` CUDA-event timings of fn(), after one warm-up."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def check_close(torch, name, got, want, atol, rtol=0.0, max_off=0,
                hard=math.inf):
    """At most `max_off` elements may lie beyond atol + rtol*|want|, and
    none may be off by more than `hard`.  Returns the max abs error."""
    got, want = got.float(), want.float()
    if got.shape != want.shape:
        fail(f"{name}: shape {tuple(got.shape)} vs {tuple(want.shape)}")
    err = (got - want).abs()
    n_off = int((err > atol + rtol * want.abs()).sum())
    max_err = err.max().item() if err.numel() else 0.0
    log(f"  {name}: max_abs_err {max_err:.3e}, {n_off} of {err.numel()} "
        f"beyond atol {atol:g} + rtol {rtol:g} (allowed {max_off}, "
        f"max <= {hard:g})")
    if not (n_off <= max_off and max_err <= hard and math.isfinite(max_err)):
        fail(f"{name} disagrees with its plain version")
    return max_err


def check_kernel_a(torch, got, want):
    """Kernel A against its plain version, pixel by pixel.

    A pixel is off if a blend channel, its T_final or an M-list value lies
    beyond atol 1e-5 (1e-6 for T) + rtol 1e-4, or its n_eval differs.  The
    kernel's running product T and the plain version's chunked cumprod
    round differently, so a pixel whose T lands within an ulp of the 1e-4
    stop may stop one Gaussian apart: that moves its channels and T by
    less than 0.05 (the entry's weight is below 1e-2) and adds or drops its
    last slot.  At most MAX_OFF_PIXELS pixels may be off, and no blend
    channel, T_final or slot weight anywhere by more than 0.05.  Returns
    the max abs error over blend, T_final and slots."""
    (blend, t_fin, mlist, n_eval), (blend_w, t_w, mlist_w, n_eval_w) = got, want

    def beyond(g, w, atol):
        return (g - w).abs() > atol + 1e-4 * w.abs()

    off = (beyond(blend, blend_w, 1e-5).any(-1) | beyond(t_fin, t_w, 1e-6)
           | beyond(mlist, mlist_w, 1e-5).flatten(2).any(-1)
           | (n_eval != n_eval_w))
    errs = {"blend": (blend - blend_w).abs().max().item(),
            "T_final": (t_fin - t_w).abs().max().item(),
            "slot w": (mlist[..., 0] - mlist_w[..., 0]).abs().max().item(),
            "slot uv": (mlist[..., 1:] - mlist_w[..., 1:]).abs().max().item()}
    n_off = int(off.sum())
    log(f"  A: {n_off} of {off.numel()} pixels off (allowed "
        f"{MAX_OFF_PIXELS}); max abs err "
        + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
        + f"; {int((n_eval != n_eval_w).sum())} n_eval counts differ")
    hard = max(errs["blend"], errs["T_final"], errs["slot w"])
    if not (n_off <= MAX_OFF_PIXELS and hard <= 0.05
            and all(math.isfinite(v) for v in errs.values())):
        fail("kernel A disagrees with its plain version")
    return max(errs.values())


@contextlib.contextmanager
def swapped(module, name, fn):
    """module.name is fn inside the block."""
    old = getattr(module, name)
    setattr(module, name, fn)
    try:
        yield
    finally:
        setattr(module, name, old)


def main_path_kernel_args(model, cam):
    """Render `cam` once and return the arguments the render handed the
    wrappers of kernel A and kernel B."""
    from texgs_torch.kernels import tex_term as kt
    from texgs_torch.kernels import uvtex_fused as kf

    seen = {}

    def recording(name, fn):
        def wrapper(*args, **kwargs):
            seen[name] = (args, kwargs)
            return fn(*args, **kwargs)
        # a kernel wrapper counts its launch through its module's global
        # name, which is this recorder while it is swapped in
        wrapper.launches = 0
        return wrapper

    rec_a = recording("A", kf.fused_pairs)
    rec_b = recording("B", kt.tex_term)
    with swapped(kf, "fused_pairs", rec_a), swapped(kt, "tex_term", rec_b):
        model.render(cam)
    if (set(seen) != {"A", "B"} or any(kw for _, kw in seen.values())
            or (rec_a.launches, rec_b.launches) != (1, 1)):
        fail(f"the render called the kernel wrappers as {seen.keys()}, "
             f"launches {rec_a.launches} and {rec_b.launches}")
    return seen["A"][0], seen["B"][0]


def plain_render(model, cam):
    """model.render(cam) with every kernel wrapper swapped for its plain
    PyTorch version."""
    from texgs_torch.kernels import tex_term as kt
    from texgs_torch.kernels import uvtex_fused as kf

    with swapped(kf, "fused_pairs", kf.mlist_scan), \
            swapped(kt, "tex_term", kt.mlist_tex_term):
        return model.render(cam)


def texel_directions(res, device, torch):
    """(6, res, res, 3) world direction of every texel center."""
    from texgs_torch.kernels.cubemap import face_uv_to_direction

    c = (torch.arange(res, device=device, dtype=torch.float32) + 0.5) / res * 2 - 1
    fv, fu = torch.meshgrid(c, c, indexing="ij")
    dirs = []
    for f in range(6):
        face = torch.full(fu.shape, f, device=device, dtype=torch.int64)
        d = face_uv_to_direction(face, fu, fv)
        dirs.append(d / torch.linalg.norm(d, dim=-1, keepdim=True))
    return torch.stack(dirs)


def textured_cubemap(res, device, torch):
    """SH0-space cubemap with the textured sphere's band pattern."""
    from texgs_torch.utils.sh import rgb2sh

    d = texel_directions(res, device, torch)
    bands = ((torch.sin(12 * d[..., 0]) * torch.sin(12 * d[..., 1])
              * torch.sin(12 * d[..., 2])) > 0).float()
    rgb = torch.stack([0.15 + 0.7 * bands, 0.5 + 0.3 * torch.sin(2 * d[..., 1]),
                       0.85 - 0.7 * bands], dim=-1)
    return rgb2sh(rgb).contiguous()


def edge_corner_mlist(n_tiles, m, device, torch, seed=5):
    """(n_tiles, 256, m, 4) M-lists whose slots point at cube edges and
    corners (plus a small jitter), with random weights."""
    rng = np.random.default_rng(seed)
    n = n_tiles * 256 * m
    signs = rng.choice([-1.0, 1.0], size=(n, 3))
    d = signs.copy()
    kind = rng.integers(0, 2, size=n)               # 0: corner, 1: edge
    free = rng.integers(0, 3, size=n)
    edge = kind == 1
    d[edge, free[edge]] = rng.uniform(-1, 1, size=edge.sum())
    d += rng.normal(scale=10.0 ** rng.uniform(-6, -2, size=(n, 1)), size=(n, 3))
    d *= rng.uniform(0.5, 2.0, size=(n, 1))
    w = rng.uniform(0.0, 0.2, size=(n, 1)) * (rng.uniform(size=(n, 1)) < 0.8)
    ml = np.concatenate([w, d], axis=1).astype(np.float32)
    return torch.as_tensor(ml, device=device).reshape(n_tiles, 256, m, 4)


def profile_render(torch, model, cam, render_ms, top=12):
    """torch.profiler over one render: the device's busy time, as a share
    of the profiled render's wall time and of `render_ms` (the render's
    median without the profiler), and by kernel and by operator."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with torch.no_grad():
        model.render(cam)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            model.render(cam)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.device_time_total for e in kernels) / 1e3
    if not kernels or busy_ms <= 0:
        log("[profile] torch.profiler saw no device time: device busy share "
            "not measured")
        return
    log(f"[profile] one render of view 0 under torch.profiler: wall "
        f"{wall_ms:.3f} ms, device busy {busy_ms:.3f} ms "
        f"({busy_ms / wall_ms:.1%} of it, {busy_ms / render_ms:.1%} of the "
        f"{render_ms:.3f} ms unprofiled median), "
        f"{sum(e.count for e in kernels)} kernel launches")
    for e in sorted(kernels, key=lambda e: -e.device_time_total)[:top]:
        log(f"  kernel {e.device_time_total / 1e3:9.3f} ms  x{e.count:<4d} "
            f"{e.key[:90]}")
    ops = [e for e in events if e.device_type == DeviceType.CPU
           and e.self_device_time_total > 0]
    for e in sorted(ops, key=lambda e: -e.self_device_time_total)[:top]:
        log(f"  op     {e.self_device_time_total / 1e3:9.3f} ms  "
            f"x{e.count:<4d} {e.key[:90]}")


def build_model(torch, device):
    from texgs_torch.config import Cfg
    from texgs_torch.core.state import init_from_pcd
    from texgs_torch.data.synthetic import textured_sphere_point_cloud
    from texgs_torch.train.texture_gaussian3d import TextureGaussian3D

    cfg = Cfg(MODEL_CFG)
    model = TextureGaussian3D(cfg, device=device,
                              generator=torch.Generator().manual_seed(0))
    pcd = textured_sphere_point_cloud(N_GAUSS, seed=0)
    state = init_from_pcd(pcd.points, pcd.colors,
                          max_sh_degree=int(cfg.tex_cfg.max_sh_degree),
                          device=device)
    shs = np.random.default_rng(3).normal(size=tuple(state.features_rest.shape))
    model.gauss = {"xyz": state.xyz, "opacity": state.opacity,
                   "scaling": state.scaling, "rotation": state.rotation,
                   "shs": torch.as_tensor(0.01 * shs, dtype=torch.float32,
                                          device=device)}
    model.active_sh_degree = int(cfg.tex_cfg.max_sh_degree)
    model.texture = textured_cubemap(TEX_RES, device, torch)
    model.bind_train_cfg(None, cfg.background)

    # pre-fit the UV net to the analytic sphere map uv = normalize(xyz), as
    # texgs/tools/bench_stage3.py does, so the texture fetches follow a
    # trained map's pattern
    xyz = state.xyz
    target = xyz / (torch.linalg.norm(xyz, dim=-1, keepdim=True) + 1e-9)
    opt = torch.optim.Adam(model.uv_net.parameters(), lr=1e-3)
    for _ in range(300):
        opt.zero_grad(set_to_none=True)
        loss = ((model.uv_net(xyz, model.geo_emb) - target) ** 2).sum(-1).mean()
        loss.backward()
        opt.step()
    return model, loss.item()


def main() -> int:
    import torch

    # ---------------------------------------------------------- 1. device
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke "
              "run needs an NVIDIA GPU", file=sys.stderr)
        return 2
    from texgs_torch import _build  # importing the package turns TF32 off
    from texgs_torch.data.synthetic import orbit_cameras
    from texgs_torch.kernels.cubemap import (chessboard_cubemap, faces_to_cross,
                                             sample_cubemap)
    from texgs_torch.kernels.tex_term import mlist_tex_term, tex_term
    from texgs_torch.kernels.tile_raster import N_FIXED_F, TABLE_FIXED
    from texgs_torch.kernels.uvtex_fused import fused_pairs, mlist_scan

    device = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    log(f"[device] {kind}, {torch.cuda.device_count()} card(s); torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}")
    log(f"[device] nvidia-smi: {card}")

    # ----------------------------------------------------------- 2. build
    t0 = time.perf_counter()
    reports = _build.build()
    log(f"[build] {len(reports)} kernels in {time.perf_counter() - t0:.1f} s")
    for name, report in reports.items():
        for line in report.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    # ----------------------------------------------------------- 3. setup
    t0 = time.perf_counter()
    model, fit_err = build_model(torch, device)
    cams = orbit_cameras(N_VIEWS, radius=3.5, width=WIDTH, height=HEIGHT)
    torch.cuda.synchronize()
    log(f"[setup] {N_GAUSS} Gaussians, {WIDTH}x{HEIGHT}, cubemap {TEX_RES}^2, "
        f"m={int(model.cfg.get_or('uvtex_m', 32))}, UV-net prefit map err "
        f"{fit_err:.4f}, {time.perf_counter() - t0:.1f} s")

    # the arguments the main path hands each kernel wrapper, for view 0
    a_args, b_args = main_path_kernel_args(model, cams[0])
    table, uv_rows, pairs, _, _, m = a_args
    mlist, texture = b_args[:2]
    n_f = table.shape[1] - TABLE_FIXED + N_FIXED_F
    log(f"[setup] view 0: {int(pairs.n_pairs)} pairs over "
        f"{pairs.tile_counts.numel()} tiles (max {int(pairs.tile_counts.max())} "
        f"a tile), F = {n_f} blend channels, m = {m}")

    # --------------------------------------------------------- 4. kernels
    log("[kernels] each kernel against its plain version, on the arguments "
        "the view-0 render gave it")
    with torch.no_grad():
        got_a = fused_pairs(*a_args)
        want_a = mlist_scan(*a_args)
        torch.cuda.synchronize()
        err_a = check_kernel_a(torch, got_a, want_a)

        got_b = tex_term(*b_args)
        want_b = mlist_tex_term(*b_args)
        err_b = check_close(torch, "B texture term (main-path M-lists)",
                            got_b, want_b, atol=2e-5, rtol=1e-4)
        edge_ml = edge_corner_mlist(16, m, device, torch)
        small_tex = torch.as_tensor(np.random.default_rng(6).uniform(
            -1.5, 1.5, size=(6, 16, 16, 3)), dtype=torch.float32, device=device)
        for tex_name, tex in (("1024^2", texture), ("16^2", small_tex)):
            for mode in ("bilinear", "nearest", "bilinear_clamp"):
                err_b = max(err_b, check_close(
                    torch, f"B edge/corner directions, {tex_name}, {mode}",
                    tex_term(edge_ml, tex, 64, 64, mode),
                    mlist_tex_term(edge_ml, tex, 64, 64, mode),
                    atol=2e-5, rtol=1e-4))
        # the end-to-end image of view 0 with the plain versions swapped in
        plain_image = plain_render(model, cams[0])["render"]

    # ------------------------------------------------------ 5. main path
    chess = faces_to_cross(chessboard_cubemap(TEX_RES // 16, 16, device=device))
    fused_pairs.launches = 0
    tex_term.launches = 0
    t0 = time.perf_counter()
    views, retextured = [], []
    for c in cams:
        views.append(model.visual_step(0, 1, c))
    model.change_texture(chess, mode=0)
    for c in cams:
        retextured.append(model.visual_step(0, 1, c))
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    launches = {"uvtex_fused": fused_pairs.launches,
                "tex_term": tex_term.launches}
    log(f"[main] {2 * N_VIEWS} views (3 + 3 retextured) in {main_s:.3f} s; "
        f"launches {launches}")
    for name, n in launches.items():
        if n != 2 * N_VIEWS:
            fail(f"kernel {name} launched {n} times on the main path, "
                 f"expected one a view ({2 * N_VIEWS})")

    keys = ("image", "image_no_sh", "depth", "norm", "alpha", "envmap",
            "cubemap")
    for i, (v, r) in enumerate(zip(views, retextured)):
        for out in (v, r):
            for k in keys:
                if not bool(torch.isfinite(out[k]).all()):
                    fail(f"view {i}: {k} is not finite")
            if out["image"].shape != (3, HEIGHT, WIDTH):
                fail(f"view {i}: image shape {tuple(out['image'].shape)}")
        cover = v["alpha"].mean().item()
        diff = (v["image"] - r["image"]).abs().mean().item()
        log(f"  view {i}: alpha mean {cover:.4f}, image mean "
            f"{v['image'].mean().item():.4f}, retexture changed the image by "
            f"{diff:.4f} (mean abs)")
        if not 0.05 < cover < 0.95:
            fail(f"view {i}: alpha covers {cover:.3f} of the frame")
        if diff < 1e-3:
            fail(f"view {i}: change_texture did not change the image")
    check_close(torch, "view-0 image vs the plain versions' image",
                views[0]["image"], plain_image, atol=1e-4, rtol=1e-4,
                max_off=3 * MAX_OFF_PIXELS, hard=0.05)

    # -------------------------------------------------------- 6. timings
    with torch.no_grad():
        view_ms = [median_ms(torch, lambda c=c: model.visual_step(0, 1, c))
                   for c in cams]
        for i, t in enumerate(view_ms):
            log(f"[time] view {i}: visual_step {t:.3f} ms (median of {REPS})")
        render_ms = median_ms(torch, lambda: model.render(cams[0]))
        log(f"[time] view 0: render (no envmap / cube cross) {render_ms:.3f} ms")
        a_ms = median_ms(torch, lambda: fused_pairs(*a_args))
        a_plain_ms = median_ms(torch, lambda: mlist_scan(*a_args))
        b_ms = median_ms(torch, lambda: tex_term(*b_args))
        b_plain_ms = median_ms(torch, lambda: mlist_tex_term(*b_args))

        # bounds from this run's inputs
        def nbytes(*ts):
            return sum(t.numel() * t.element_size() for t in ts)

        a_bytes = nbytes(table, uv_rows, pairs.pair_gauss, pairs.tile_start,
                         pairs.tile_end, *got_a)
        live_slots = int((mlist[..., 0] != 0).sum())
        a_ops = (int(got_a[3].sum()) * (OPS_A_EVAL + 2 * n_f)
                 + live_slots * OPS_A_SLOT)
        a_bound = max(a_bytes / H100_BYTES_PER_S, a_ops / H100_F32_FLOPS) * 1e3
        # texels kernel B touches: those with a nonzero bilinear weight in
        # some live slot (the gradient of the plain term, unit weights)
        live = mlist[mlist[..., 0] != 0]
        with torch.enable_grad():
            probe = torch.ones_like(texture, requires_grad=True)
            sample_cubemap(probe, live[:, 1:4]).sum().backward()
        texels = int((probe.grad.abs().sum(-1) > 0).sum())
        b_bytes = nbytes(mlist) + texels * 12 + nbytes(got_b)
        b_ops = live_slots * OPS_B_SLOT
        b_bound = max(b_bytes / H100_BYTES_PER_S, b_ops / H100_F32_FLOPS) * 1e3
    log(f"[time] kernel A uvtex_fused: {a_ms:.4f} ms, plain {a_plain_ms:.3f} ms, "
        f"bound {a_bound:.4f} ms ({a_bytes / 1e6:.1f} MB, "
        f"{a_ops / 1e9:.3f} GFLOP)")
    log(f"[time] kernel B tex_term: {b_ms:.4f} ms, plain {b_plain_ms:.3f} ms, "
        f"bound {b_bound:.4f} ms ({b_bytes / 1e6:.1f} MB incl. {texels} "
        f"texels touched, {live_slots} live slots)")

    def entry(name, source, replaces, ms, plain_ms, bound, by, err):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches[name],
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound, "bound_by": by, "library_ms": None}

    kernels = [
        entry("uvtex_fused", "texgs_torch/csrc/uvtex_fused.cu",
              "texgs/kernels/pallas_uvtex_fused.py:263", a_ms, a_plain_ms,
              a_bound, "bytes" if a_bytes / H100_BYTES_PER_S
              >= a_ops / H100_F32_FLOPS else "operations", err_a),
        entry("tex_term", "texgs_torch/csrc/tex_term.cu",
              "texgs/kernels/pallas_textile.py:774", b_ms, b_plain_ms,
              b_bound, "bytes" if b_bytes / H100_BYTES_PER_S
              >= b_ops / H100_F32_FLOPS else "operations", err_b),
    ]
    profile_render(torch, model, cams[0], render_ms)
    log(card)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
