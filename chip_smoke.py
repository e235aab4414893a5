#!/usr/bin/env python3
"""GPU smoke run of texgs_torch, the PyTorch + CUDA port of texgs.

Run from the repository root on a machine with an NVIDIA H100:

    python3 chip_smoke.py

It imports the port only (no JAX, nothing of the texgs package) and needs
one card.  Phases, in order; any failure exits non-zero:

  1. device  -- requires CUDA, prints the card's name and power limit;
  2. build   -- compiles every kernel of the port from texgs_torch/csrc
                (one nvcc per source, all started together);
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
                share and its time by kernel and by operator;
  7. train   -- the stage-3 training step at full width, with
                configs/prod_texture.yaml's inverse UV net (8-level hash
                grid), optim_cfg, loss_cfg and min-scale reset interval:
                the 3 views of phase 5 (band texture) are the ground truth
                (image, alpha as alpha_mask, normals), training starts from
                the chessboard retexture at iteration 2501, where every
                prod loss term is on and all three Adams step.  One step
                captures the arguments each backward kernel gets (the hash
                grid's: its table, points and output cotangent); then
                STEPS steps are counted: every loss and parameter must stay
                finite, the last 5 steps' mean loss must lie below the
                first 5's, and kernels A, A', B, B', the fused hash encode
                K5' and its backward K5'' must each launch once a step (the
                K5 gather never);
  8. train kernels -- A' and B' against their plain versions on the
                captured arguments;
  9. train timings -- the step's median time, each kernel's time, plain
                time and bound, one step under torch.profiler (its device
                launches); then K5', K5'' and the K5 gather on the
                captured hash-grid arguments: the corners K5' picks (bit
                for bit), its features and the gradients of K5'' against
                their plain versions, the gather on the step's own corner
                indices; their times beside their plain versions, bounds
                and library calls (the gather as table[level, idx], the
                scatter as index_put_); one HashGrid call's device launches
                (at most 6) beside the plain chain's;
 10. stage-1 setup -- configs/prod_stage1.yaml on its checker scene at full
                width: 50,000 points of textured_sphere_point_cloud(seed 0),
                800x600; the ground truth is 8 spiral views of that cloud at
                opacity logit 4.0 and SH degree 0 (image, alpha as the mask,
                normals), as scripts/make_synthetic_dataset.py builds them,
                rendered by the port; the model is Gaussian3D of the config,
                initialised from the cloud through a .ply file;
 11. stage-1 training -- one capture step (the arguments of kernels 1 and
                1'), then STAGE1_STEPS steps at iterations 2581..2600 with SH
                degree 2 and every prod loss term on; 2600 densifies and
                prunes and skips Adam.  Every loss and parameter finite, the
                loss falling, kernels 1 and 1' once a step;
 12. stage-1 kernels -- kernel 1 against its plain version pixel by pixel,
                kernel 1' per column group, on the captured arguments;
 13. stage-1 timings -- the step's median, kernel 1 and 1' times, plain
                times and bounds, and one step under torch.profiler;
 14. stage 2 -- the stage-1 model handed off through files (a checkpoint,
                then extract_pcd to 16,384 points), UVMapGaussian3D of
                configs/prod_uv_map.yaml trained 1 + STAGE2_STEPS steps over
                the 8 views: finite, the loss falling, kernel 1 once per
                camera (the render cache), K5' and K5'' once a step; one
                step under torch.profiler (its device launches);
 15. driver -- driver.train through the port's command line on
                configs/synthetic_smoke.yaml cut to 150 iterations
                (densification at 100), then configs/synthetic_uv_map.yaml
                for 50 iterations from its checkpoint; each stage's test PSNR;
 16. two-kernel render -- the model of phase 3 with model_cfg.backend
                pallas (kernel 1 blends, kernel 2 writes the M-lists):
                kernels 2 and 1 (F = 10) against their plain versions on
                view 0's arguments; the 3 views, the chessboard retexture and
                the 3 views again through visual_step, each image held
                against the fused path's of phase 5, with kernels 1, 2 and B
                launched once a view and A never;
 17. two-kernel training -- 1 + STEPS steps of phase 7's joint phase on
                that path: finite, the loss falling, kernels 1, 1', 2, 2',
                B, B', K5' and K5'' once a step; the capture step's
                table and uv-row gradients (1' + 2') against kernel A''s on
                the same cotangents, by column group; 2' against its plain
                version; times of 2, 2' and 1 at F = 10 with their plain
                versions and bounds, the two-kernel render and step beside
                the fused ones, and one step under torch.profiler;
 18. tools -- that model saved with io/checkpoint; extract_texture,
                evaluate and retexture through their main() on a
                synthetic://sphere scene of 600x600 views, and the viewer
                as a process of its own, asked for one /frame over HTTP:
                finite metrics, every PNG read back, one frame.

The line before the last is a JSON object with one entry per kernel
(eleven); the last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import json
import math
import subprocess
import sys
import tempfile
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
# GPU cycles the stream spins before a queued timing (about 2 ms)
QUEUE_CYCLES = 4_000_000
# f32 operations of kernel A per evaluated (pixel, pair) besides the
# 2 * F of the blend, per written M-list slot; of kernel B per live slot
OPS_A_EVAL = 16
OPS_A_SLOT = 60
OPS_B_SLOT = 300   # seamless bilinear, the main path's filter
# f32 operations of kernel A' per evaluated (pixel, pair) besides 3 F for
# the channels (replay, suffix form, exponent gradient, block sums), per
# in-list slot (intersection and its gradient); of kernel B' per live slot
OPS_A_BWD_EVAL = 40
OPS_A_BWD_SLOT = 90
OPS_B_BWD_SLOT = 500
# pixels of a frame where kernel A may stop one Gaussian apart from its
# plain version (see check_kernel_a); Gaussians whose A' gradient may then
# differ
MAX_OFF_PIXELS = 16
MAX_OFF_GAUSSIANS = 16

# the training phase: configs/prod_texture.yaml's optim_cfg, loss_cfg and
# train_cfg (min_scale_reset_interval); its joint phase starts after 2500
OPTIM_CFG = {
    "uv_net_lr": 0.00002, "inv_uv_net_lr": 0.00002,
    "uv_net_milestones": [2500, 5000], "uv_net_gamma": 0.5,
    "tex_optim_range": [0, None], "tex_lr": 0.0025,
    "gaussian_optim_range": [2500, None], "position_lr_init": 0.0001,
    "position_lr_final": 0.000001, "position_lr_delay_mult": 0.01,
    "position_lr_max_steps": 7500, "opacity_lr": 0.05, "scaling_lr": 0.005,
    "rotation_lr": 0.001,
}
LOSS_CFG = {
    "lambda_dssim": 0.2, "rgb_range": [0, None],
    "lambda_no_sh": 2.0, "rgb_no_sh_range": [2500, None],
    "lambda_alpha": 1.0, "alpha_range": [2500, None],
    "lambda_norm": 0.1, "norm_range": [2500, None],
    "lambda_norm_smooth": 0.5, "norm_smooth_range": [2500, None],
    "lambda_inverse": 0.1, "inverse_range": [2500, None],
}
TRAIN_CFG = {"min_scale_reset_interval": 250}
FIRST_ITER = 2501
STEPS = 20

# stages 1 and 2: configs/prod_stage1.yaml and configs/prod_uv_map.yaml
N_STAGE1 = 50_000
STAGE1_VIEWS = 8           # of the config's 64 training views
STAGE1_FIRST_ITER = 2580   # the capture step; the counted steps follow
STAGE1_STEPS = 20
STAGE1_SH_DEGREE = 2       # active from iteration 2000 to 2999
STAGE1_MODEL_CFG = {"type": "Gaussian3D", "sh_degree": 3}
STAGE1_TRAIN_CFG = {
    "densification_interval": 100, "opacity_reset_interval": 3000,
    "densify_from_iter": 125, "densify_until_iter": 3750,
    "densify_grad_threshold": 0.0002, "min_scale_reset_interval": 0,
    "min_scale_reset_from_iter": 0, "opacity_prune_interval": 0}
STAGE1_OPTIM_CFG = {
    "position_lr_init": 0.00016, "position_lr_final": 0.0000016,
    "position_lr_delay_mult": 0.01, "position_lr_max_steps": 7500,
    "feature_lr": 0.0025, "opacity_lr": 0.05, "scaling_lr": 0.005,
    "rotation_lr": 0.001, "percent_dense": 0.01}
STAGE1_LOSS_CFG = {
    "lambda_dssim": 0.2, "lambda_alpha": 1.0,
    "lambda_norm": 0.1, "norm_range": [2500, None],
    "lambda_norm_smooth": 0.1, "norm_smooth_range": [2500, None],
    "lambda_opacity_reg": 0.001, "opacity_reg_range": [2500, None]}
STAGE2_STEPS = 20
PCD_POINTS = 16_384
NET_128 = {"emb_dim": 128,
           "pre_mlp_cfg": {"n_hidden_layers": 1, "n_neurons": 128},
           "mlp_cfg": {"n_hidden_layers": 2, "n_neurons": 128}}
STAGE2_MODEL_CFG = {
    "type": "UVMapGaussian3D", "background": [0, 0, 0],
    "max_inverse_points": 8192, "uv_net_cfg": NET_128,
    "inv_uv_net_cfg": dict(NET_128, n_sample_points=2048, patch_scale=8,
                           pre_mlp_cfg={"hash_grid_cfg": {
                               "n_levels": 8, "n_features_per_level": 4,
                               "max_hashmap": 12},
                               "n_hidden_layers": 1, "n_neurons": 128}),
    "geo_emb_dim": 128}
STAGE2_OPTIM_CFG = {"uv_net_lr": 0.0001, "inv_uv_net_lr": 0.0001,
                    "uv_net_milestones": [2500], "uv_net_gamma": 0.33}
STAGE2_LOSS_CFG = {"lambda_inverse": 1.0, "inverse_range": [0, None],
                   "lambda_chamfer": 1.0, "chamfer_range": [0, None],
                   "lambda_inverse2": 1.0, "inverse_range2": [0, None]}
DRIVER_S1_ITERS = 150
DRIVER_S2_ITERS = 50
# the tools phase's synthetic://sphere scene
TOOLS_POINTS = 50_000
TOOLS_VIEWS = 8
TOOLS_SIZE = 600
# the scene's camera extent, texgs's spatial_lr_scale: the orbit radius
# times the 1.1 of its scene normalisation
SPATIAL_LR_SCALE = 3.5 * 1.1


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def timed_once(torch, fn):
    """(fn(), its time in ms by CUDA events) for work too slow to repeat."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def median_ms(torch, fn, reps=REPS, queued=False):
    """Median of `reps` CUDA-event timings of fn(), after one warm-up.

    Without `queued` the start event runs as soon as it is recorded, so the
    time includes the host's work in fn before (and between) its launches:
    a view's or a step's time.  With `queued` the stream first spins for
    QUEUE_CYCLES, long enough for the host to enqueue a kernel wrapper's
    work behind the start event, so the time is the device's alone from
    the first launch to the last (host time beyond the spin still shows)."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if queued:
            torch.cuda._sleep(QUEUE_CYCLES)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def kernel_ms(torch, fn, reps=REPS):
    """(device ms, host-launched ms) of a kernel wrapper's call: the
    median_ms with `queued` (the kernel's time, the JSON line's "ms"), and
    without (the wrapper's host time included, as this script timed its
    kernels before it had the queued reading)."""
    return (median_ms(torch, fn, reps, queued=True),
            median_ms(torch, fn, reps))


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


@contextlib.contextmanager
def recording(module, name, seen, clone=False):
    """module.name records its positional arguments (tensors detached from
    any graph, and copied with `clone`, for a parameter that a later step
    updates in place) in seen[name] and calls through, inside the block,
    which gets the recorder.  A kernel wrapper counts its launches through its
    module's global name, so while the recorder is swapped in for a kernel
    wrapper, the recorder's `launches` counts that kernel's launches."""
    fn = getattr(module, name)

    def wrapper(*args):
        seen[name] = tuple((a.detach().clone() if clone else a.detach())
                           if hasattr(a, "detach") else a for a in args)
        return fn(*args)
    wrapper.launches = 0
    with swapped(module, name, wrapper):
        yield wrapper


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def bound(n_bytes, n_ops):
    """(bound ms, what bounds it) on the H100 SXM's data-sheet rates."""
    t_bytes, t_ops = n_bytes / H100_BYTES_PER_S, n_ops / H100_F32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def entry(name, source, replaces, launches, ms, plain_ms, bound_ms, by, err,
          library_ms=None):
    """One kernel's object of the {"kernels": [...]} line."""
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": by, "library_ms": library_ms}


def main_path_kernel_args(model, cam):
    """Render `cam` once and return the arguments the render handed the
    wrappers of kernel A and kernel B."""
    from texgs_torch.kernels import tex_term as kt
    from texgs_torch.kernels import uvtex_fused as kf

    seen = {}
    with recording(kf, "fused_pairs", seen) as rec_a, \
            recording(kt, "tex_term", seen) as rec_b:
        model.render(cam)
    if (set(seen) != {"fused_pairs", "tex_term"}
            or (rec_a.launches, rec_b.launches) != (1, 1)):
        fail(f"the render called the kernel wrappers {sorted(seen)}, "
             f"launches {rec_a.launches} and {rec_b.launches}")
    return seen["fused_pairs"], seen["tex_term"]


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


def profile_device(torch, what, fn, median, top=12):
    """torch.profiler over one call of fn (after one unprofiled call): the
    device's busy time, as a share of the profiled call's wall time and of
    `median` (fn's median without the profiler), and by kernel and by
    operator.  Returns the call's device launches (None if the profiler saw
    no device time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        # the trace can miss a profile's first device events: a spin
        # kernel, not counted, goes first (see device_launches)
        torch.cuda._sleep(QUEUE_CYCLES)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA
               and "spin_kernel" not in e.key]
    busy_ms = sum(e.device_time_total for e in kernels) / 1e3
    if not kernels or busy_ms <= 0:
        log(f"[profile] {what}: torch.profiler saw no device time: device "
            "busy share not measured")
        return None
    log(f"[profile] {what} under torch.profiler: wall "
        f"{wall_ms:.3f} ms, device busy {busy_ms:.3f} ms "
        f"({busy_ms / wall_ms:.1%} of it, {busy_ms / median:.1%} of the "
        f"{median:.3f} ms unprofiled median), "
        f"{sum(e.count for e in kernels)} kernel launches")
    for e in sorted(kernels, key=lambda e: -e.device_time_total)[:top]:
        log(f"  kernel {e.device_time_total / 1e3:9.3f} ms  x{e.count:<4d} "
            f"{e.key[:90]}")
    ops = [e for e in events if e.device_type == DeviceType.CPU
           and e.self_device_time_total > 0]
    for e in sorted(ops, key=lambda e: -e.self_device_time_total)[:top]:
        log(f"  op     {e.self_device_time_total / 1e3:9.3f} ms  "
            f"x{e.count:<4d} {e.key[:90]}")
    return sum(e.count for e in kernels)


def device_launches(torch, fn, reps=REPS):
    """The device operations (kernels, copies, fills) one call of fn()
    launches, counted by torch.profiler over `reps` calls after one
    warm-up call: (their number a call, {name: count a call}).  The trace
    can drop a device event now and then (a profile's first ones most of
    all), so a spin kernel that is not counted goes first (as in
    profile_device) and the counts are the mean over the calls, rounded."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(QUEUE_CYCLES)
        torch.cuda.synchronize()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    ops = {e.key: e.count / reps for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA and "spin_kernel" not in e.key}
    return round(sum(ops.values())), ops


def check_scaled(torch, name, got, want, rel_atol, rtol, max_off=0,
                 rows=False):
    """`got` against its plain version `want` at atol = rel_atol *
    max|want| + rtol * |want|: a gradient's scale follows the loss's, so
    the tolerance follows the values it compares.  With `rows`, an element
    beyond marks its row (a Gaussian) off.  At most `max_off` elements
    (rows) may be off.  Logs max and median |want| over its nonzero
    elements and how many elements (rows) an output of zeros would put
    beyond, and fails if that is within the allowance: the check must be
    able to refuse such a kernel.  Returns the max abs error."""
    err = (got - want).abs()
    mag = want.abs()
    atol = rel_atol * mag.max().item()
    beyond = err > atol + rtol * mag
    zero_beyond = mag > atol + rtol * mag
    if rows:
        beyond, zero_beyond = beyond.any(-1), zero_beyond.any(-1)
    n_off, n_zero = int(beyond.sum()), int(zero_beyond.sum())
    nonzero = mag[mag > 0]
    median = nonzero.median().item() if nonzero.numel() else 0.0
    max_err = err.max().item()
    unit = "Gaussians" if rows else "values"
    log(f"  {name}: max_abs_err {max_err:.3e}; |plain| max "
        f"{mag.max().item():.3e}, median of {nonzero.numel()} nonzero "
        f"{median:.3e}; {n_off} of {beyond.numel()} {unit} beyond atol "
        f"{rel_atol:g} max|plain| = {atol:.3e} + rtol {rtol:g} (allowed "
        f"{max_off}); zeros would put {n_zero} beyond")
    if not (n_off <= max_off and math.isfinite(max_err)
            and bool(torch.isfinite(got).all())):
        fail(f"{name} disagrees with its plain version")
    if n_zero <= max_off:
        fail(f"{name}: the check could not refuse a kernel that wrote zeros")
    return max_err


def check_a_backward(torch, got, want, label="A'"):
    """Kernel A' (or 1' + 2', under `label`) against `want`, per column
    group (quad, channels, uv rows): at most MAX_OFF_GAUSSIANS Gaussians
    beyond atol 1e-3 of the group's max |want| + rtol 1e-3 (kernel A's
    threshold flips move whole entries, and the atomics sum in a varying
    order).  The columns the kernels leave at zero must be zero.  Returns
    the max abs error."""
    (d_table, d_uv), (d_table_w, d_uv_w) = got, want
    groups = {"quad": (d_table[:, :6], d_table_w[:, :6]),
              "channels": (torch.cat([d_table[:, 7:14], d_table[:, 16:]], 1),
                           torch.cat([d_table_w[:, 7:14], d_table_w[:, 16:]], 1)),
              "uv rows": (d_uv[:, :12], d_uv_w[:, :12])}
    max_err = max(check_scaled(torch, f"{label} {name}", g, w, 1e-3, 1e-3,
                               MAX_OFF_GAUSSIANS, rows=True)
                  for name, (g, w) in groups.items())
    if d_table[:, [6, 14, 15]].any() or d_uv[:, 12:].any():
        fail(f"{label} wrote gradient into a column it must leave at zero")
    return max_err


def restricted_tiles(pairs, keep):
    """The pair list with the tiles outside `keep` (a bool mask) emptied."""
    import torch

    return pairs._replace(
        tile_end=torch.where(keep, pairs.tile_end, pairs.tile_start),
        tile_counts=torch.where(keep, pairs.tile_counts, 0))


def plain_backward_tiles(torch, pairs, device, chunk):
    """The tiles on which a plain M-list backward (autograd through
    uvtex_fused.mlist_scan, about 24 (tiles, 256, chunk) f32 intermediates
    per chunk) fits in the card's free memory: all, or every fourth.
    Returns (bool mask over tiles, the note to log)."""
    n_tiles = pairs.tile_counts.numel()
    n_chunks = -(-int(pairs.tile_counts.max()) // chunk)
    need = n_chunks * 24 * n_tiles * 256 * chunk * 4
    free = torch.cuda.mem_get_info()[0]
    keep = torch.ones(n_tiles, dtype=torch.bool, device=device)
    if need > 0.8 * free:
        keep = torch.arange(n_tiles, device=device) % 4 == 0
    return keep, (f"{int(keep.sum())} of {n_tiles} tiles (plain backward "
                  f"needs about {need / 1e9:.1f} GB, {free / 1e9:.1f} GB free)")


def stage3_stepper(model, cams, gt_views):
    """Sets `model` up for phase 7's joint phase on `cams` with the ground
    truth `gt_views` (image, alpha as the mask, normals) and returns
    step(iteration) -> (loss, stats): compute_loss + optimize_step."""
    from texgs_torch.config import Cfg
    from texgs_torch.core.camera import with_ground_truth

    train_cams = [with_ground_truth(c, v["image"], v["alpha"], normal=v["norm"])
                  for c, v in zip(cams, gt_views)]
    loss_cfg, train_cfg = Cfg(LOSS_CFG), Cfg(TRAIN_CFG)
    model.spatial_lr_scale = SPATIAL_LR_SCALE
    model.setup_optim(Cfg(OPTIM_CFG))
    model.bind_train_cfg(train_cfg, model.bg)

    def step(it):
        loss, stats, _ = model.compute_loss(it, 10000, train_cams[it % len(cams)],
                                            None, loss_cfg)
        model.optimize_step(it, 10000, train_cfg, {})
        return loss, stats
    return step


def check_train_run(torch, what, model, step, counters, expect):
    """STEPS steps after the capture step: every loss term finite, every
    kernel of `counters` launched `expect[name]` times, every parameter
    finite and the mean loss of the last 5 steps below that of the first
    5.  Returns the launch counts."""
    from texgs_torch.train.optim import flatten_tree

    for fn in counters.values():
        fn.launches = 0
    losses = []
    t0 = time.perf_counter()
    for it in range(FIRST_ITER + 1, FIRST_ITER + 1 + STEPS):
        loss, stats = step(it)
        losses.append(loss.item())
        if not all(math.isfinite(v.item()) for v in stats.values()):
            fail(f"{what} step {it}: a loss term is not finite: {stats}")
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    log(f"[{what}] {STEPS} steps ({FIRST_ITER + 1}..{FIRST_ITER + STEPS}) in "
        f"{train_s:.3f} s; launches {launches}; n_pairs of the last step "
        f"{int(stats['n_pairs'])}")
    log("  total loss by step: " + ", ".join(f"{v:.5f}" for v in losses))
    first, last = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    log(f"  mean loss of the first 5 steps {first:.5f}, of the last 5 "
        f"{last:.5f} ({(last - first) / first:+.2%})")
    for name, n in launches.items():
        if n != expect[name]:
            fail(f"kernel {name} launched {n} times in {STEPS} {what} steps, "
                 f"expected {expect[name]}")
    sd = model.state_dict()
    for part in ("params", "net_state"):
        for name, a in flatten_tree(sd[part]).items():
            if not np.isfinite(a).all():
                fail(f"parameter {part}.{name} is not finite after {what}")
    if not last < first:
        fail(f"the {what} loss did not fall")
    return launches


def hash_counters():
    """Launch counters of the hash-grid kernels, by JSON name: the fused
    encode K5' and its backward K5'' run once a step on the main paths; the
    K5 gather is on none of them (0 a step)."""
    from texgs_torch.nets import hash_encode as ke
    from texgs_torch.nets import hash_gather as kh

    return {"hash_encode": ke.hash_encode,
            "hash_encode_bwd": ke.hash_encode_backward,
            "hash_gather": kh.hash_gather}


def hash_kernel_phase(torch, enc_args, launches):
    """Kernels K5', K5'' and the K5 gather on the arguments a training
    step's hash grid got (table, x and the cotangent of its output): each
    against its plain version (the corners exactly, the values within
    tolerance), timed beside its plain version, bound and library call; and
    one HashGrid call's device launches and time beside the plain chain's.
    Returns their JSON entries, with the main path's `launches`."""
    from texgs_torch.nets import hash_encode as ke
    from texgs_torch.nets import hash_gather as kh
    from texgs_torch.nets.hashgrid import HashGrid

    table, x, g = enc_args[:3]
    levels, size, n_feat = table.shape
    n = x.shape[0]
    log(f"[hash kernels] on the step-{FIRST_ITER} hash grid's arguments: "
        f"{n} points, {levels} levels of {size} rows of {n_feat} features")
    with torch.no_grad():
        out, idx, w = ke.hash_encode_forward(table, x, corners=True)
        idx_w, w_w = ke.indices_and_weights(x, levels, size)
        n_idx, n_w = int((idx != idx_w).sum()), int((w != w_w).sum())
        log(f"  K5' corners: {n_idx} of {idx.numel()} indices and {n_w} "
            "weights differ from the plain version's")
        if n_idx or n_w:
            fail("kernel K5' picked other corners or weights than its plain "
                 "version")
        err_f = check_close(torch, "K5' hash encode", out,
                            ke.encode_plain(table, x), atol=1e-6, rtol=1e-5)
        got_b = ke.hash_encode_backward(table, x, g)
        want_b = ke.encode_backward_plain(table, x, g)
        # the table's atomics and the levels' sum run in another order than
        # the plain version's: each gradient at 1e-4 of its max |plain|
        err_b = max(check_scaled(torch, "K5'' d table", got_b[0], want_b[0],
                                 1e-4, 1e-4),
                    check_scaled(torch, "K5'' d x", got_b[1], want_b[1],
                                 1e-4, 1e-4))
        got_k = kh.hash_gather(table, idx_w)
        err_k = check_close(torch, "K5 hash gather (the step's corners)",
                            got_k, kh.gather_plain(table, idx_w), atol=0.0)

        # the library calls: the gather as advanced indexing, and the
        # plain backward's scatter-add (index_put_) on the same cotangent
        lvl = torch.arange(levels, device=table.device).repeat_interleave(
            8)[:, None].expand_as(idx_w)
        idx64 = idx_w.long()
        g_rows = (w_w.view(levels, 8, 1, n)
                  * g.reshape(n, levels, n_feat).permute(1, 2, 0)[:, None])
        vals = g_rows.reshape(levels * 8, n_feat, n).permute(0, 2, 1)
        acc = torch.zeros_like(table)
        f_ms, f_host = kernel_ms(torch, lambda: ke.hash_encode_forward(table, x))
        f_plain = median_ms(torch, lambda: ke.encode_plain(table, x),
                            queued=True)
        lib_gather, lib_gather_host = kernel_ms(torch,
                                                lambda: table[lvl, idx64])
        b_ms, b_host = kernel_ms(torch,
                                 lambda: ke.hash_encode_backward(table, x, g))
        b_plain = median_ms(torch, lambda: ke.encode_backward_plain(table, x, g),
                            queued=True)
        lib_scatter, lib_scatter_host = kernel_ms(torch, lambda: acc.index_put_(
            (lvl, idx64), vals, accumulate=True))
        k_ms, k_host = kernel_ms(torch, lambda: kh.hash_gather(table, idx_w))
        k_plain = median_ms(torch, lambda: kh.gather_plain(table, idx_w),
                            queued=True)

    # f32 operations per (point, level): the cell (12) and, per corner, the
    # weight (2) and F multiply-adds; the backward adds per corner the
    # table row's dot product with g (2F), the three weight derivatives (12)
    # and the level's scale (3).  The integer hash is not counted.
    f_bytes = nbytes(x, out, table)
    f_bound, f_by = bound(f_bytes, n * levels * (12 + 8 * (2 + 2 * n_feat)))
    b_bytes = nbytes(x, g, table) + nbytes(table, x)  # + d_table, d_x
    b_bound, b_by = bound(b_bytes,
                          n * levels * (15 + 8 * (14 + 4 * n_feat)))
    k_bytes = nbytes(table, idx_w, got_k)
    k_bound, k_by = bound(k_bytes, 0)
    log(f"[time] kernel K5' hash_encode: {f_ms:.4f} ms (host-launched "
        f"{f_host:.4f}), plain {f_plain:.4f} ms, library gather (table[level, "
        f"idx]) {lib_gather:.4f} ms (host-launched {lib_gather_host:.4f}), "
        f"bound {f_bound:.5f} ms ({f_by}: {f_bytes / 1e6:.2f} MB)")
    log(f"[time] kernel K5'' hash_encode_bwd: {b_ms:.4f} ms (host-launched "
        f"{b_host:.4f}), plain {b_plain:.4f} ms, library scatter (index_put_ "
        f"of the gather's backward) {lib_scatter:.4f} ms (host-launched "
        f"{lib_scatter_host:.4f}), bound {b_bound:.5f} ms ({b_by}: "
        f"{b_bytes / 1e6:.2f} MB)")
    log(f"[time] kernel K5 hash_gather: {k_ms:.4f} ms (host-launched "
        f"{k_host:.4f}), plain {k_plain:.4f} ms, library (table[level, idx]) "
        f"{lib_gather:.4f} ms, bound {k_bound:.5f} ms ({k_by}: "
        f"{k_bytes / 1e6:.2f} MB)")
    log(f"  K5' at or below the library gather: {f_ms <= lib_gather}; K5'' "
        f"at or below the library scatter: {b_ms <= lib_scatter}")

    # one HashGrid call, forward + backward, through the kernels and
    # through the plain chain, on a copy of the step's table
    grid = HashGrid(levels, n_feat, size.bit_length() - 1, device=table.device)
    with torch.no_grad():
        grid.table.copy_(table)
    xg = x.clone().requires_grad_(True)

    def fused_call():
        grid.table.grad = xg.grad = None
        grid(xg).backward(g)

    def plain_call():
        grid.table.grad = xg.grad = None
        ke.encode_plain(grid.table, xg).backward(g)

    n_fused, fused_ops = device_launches(torch, fused_call)
    n_plain, _ = device_launches(torch, plain_call)
    call_ms, plain_call_ms = (median_ms(torch, fused_call),
                              median_ms(torch, plain_call))
    log(f"[launches] one HashGrid call, forward + backward: {n_fused} device "
        f"launches, {call_ms:.4f} ms; the plain chain (indices_and_weights, "
        f"gather_plain, the weighted sum, autograd) {n_plain} launches, "
        f"{plain_call_ms:.4f} ms")
    log(f"  a call's device operations (mean of {REPS} calls): " + "; ".join(
        f"{n:g} x {name[:60]}" for name, n in fused_ops.items()))
    if n_fused > 6:
        fail(f"one HashGrid call launched {n_fused} device operations, "
             "expected at most 6")
    return [
        entry("hash_encode", "texgs_torch/csrc/hash_encode.cu",
              "texgs/nets/pallas_hashgrid.py:63", launches["hash_encode"],
              f_ms, f_plain, f_bound, f_by, err_f, lib_gather),
        entry("hash_encode_bwd", "texgs_torch/csrc/hash_encode_bwd.cu",
              "texgs/nets/pallas_hashgrid.py:103", launches["hash_encode_bwd"],
              b_ms, b_plain, b_bound, b_by, err_b, lib_scatter),
        entry("hash_gather", "texgs_torch/csrc/hash_gather.cu",
              "texgs/nets/pallas_hashgrid.py:63", launches["hash_gather"],
              k_ms, k_plain, k_bound, k_by, err_k, lib_gather),
    ]


def train_phases(torch, model, cams, gt_views):
    """Phases 7-9 (see the module docstring).  Returns (the JSON entries of
    kernels A', B', K5', K5'' and the K5 gather, the step's median ms, its
    device launches)."""
    from texgs_torch.kernels import tex_term as kt
    from texgs_torch.kernels import uvtex_fused as kf
    from texgs_torch.kernels.cubemap import sample_cubemap
    from texgs_torch.nets import hash_encode as ke

    # ------------------------------------------------------------ 7. train
    step = stage3_stepper(model, cams, gt_views)
    t0 = time.perf_counter()
    seen = {}
    with recording(kf, "fused_pairs_backward", seen), \
            recording(kt, "tex_term_backward", seen), \
            recording(ke, "hash_encode_backward", seen, clone=True):
        loss, stats = step(FIRST_ITER)
    torch.cuda.synchronize()
    if set(seen) != {"fused_pairs_backward", "tex_term_backward",
                     "hash_encode_backward"}:
        fail(f"a training step called {sorted(seen)}")
    log(f"[train] capture step {FIRST_ITER}: loss {loss.item():.5f}, "
        f"{time.perf_counter() - t0:.2f} s (first step, kernels warm up); "
        "terms " + ", ".join(f"{k} {v.item():.4f}" for k, v in stats.items()
                             if k.startswith("L")))
    want_terms = {"Ll1", "Lssim", "Lalpha", "Lnorm", "Lnorm_smooth",
                  "Ll1_nosh", "Lssim_nosh", "Linv"}
    if not want_terms <= set(stats):
        fail(f"the joint phase misses loss terms {want_terms - set(stats)}")

    counters = {"uvtex_fused": kf.fused_pairs, "tex_term": kt.tex_term,
                "uvtex_fused_bwd": kf.fused_pairs_backward,
                "tex_term_bwd": kt.tex_term_backward, **hash_counters()}
    launches = check_train_run(
        torch, "train", model, step, counters,
        {name: 0 if name == "hash_gather" else STEPS for name in counters})

    # --------------------------------------------------- 8. train kernels
    a_args = seen["fused_pairs_backward"]
    b_args = seen["tex_term_backward"]
    table, uv_rows, pairs, rays, gx, m = a_args[:6]
    g_blend, g_t_final, g_mlist = a_args[9:]
    mlist, texture, g_img, height, width = b_args[:5]
    log("[train kernels] each against its plain version, on the arguments "
        f"the step-{FIRST_ITER} backward gave it")
    n_tiles = pairs.tile_counts.numel()
    keep, note = plain_backward_tiles(torch, pairs, table.device, kf.CHUNK)
    a_sub = (table, uv_rows, restricted_tiles(pairs, keep), rays, gx, m)
    cots = [torch.where(keep.view(-1, *[1] * (c.dim() - 1)), c, 0.0).contiguous()
            for c in (g_blend, g_t_final, g_mlist)]
    log(f"  A' is checked on {note}")
    with torch.no_grad():
        fwd_sub = kf.fused_pairs_forward(*a_sub)
        got_a = kf.fused_pairs_backward(*a_sub, *fwd_sub[:3], *cots)
        torch.cuda.reset_peak_memory_stats()
        want_a = kf.mlist_scan_vjp(*a_sub, *cots)
        torch.cuda.synchronize()
        log(f"  A' plain backward peak memory "
            f"{torch.cuda.max_memory_allocated() / 1e9:.1f} GB")
        err_a = check_a_backward(torch, got_a, want_a)
        del want_a

        got_b = kt.tex_term_backward(*b_args)
        # the plain VJP takes seconds at this shape: this one call is timed
        want_b, b_plain_ms = timed_once(
            torch, lambda: kt.mlist_tex_term_vjp(*b_args))
        # the loss is a mean over the frame, so these gradients are small:
        # each output is held at 1e-4 of its own max |plain|
        live = mlist[..., 0] != 0
        got_live, want_live = got_b[0][live], want_b[0][live]
        err_b = max(
            check_scaled(torch, "B' d texture", got_b[1], want_b[1], 1e-4, 1e-3),
            check_scaled(torch, "B' d w (live slots)", got_live[:, 0],
                         want_live[:, 0], 1e-4, 1e-3),
            check_scaled(torch, "B' d uv (live slots)", got_live[:, 1:],
                         want_live[:, 1:], 1e-4, 1e-3))
        if got_b[0][~live][:, 1:].any():
            fail("kernel B' wrote a uv cotangent into a dead slot")

    # -------------------------------------------------- 9. train timings
    it = [FIRST_ITER + STEPS + 1]

    def timed_step():
        step(it[0])
        it[0] += 1

    step_ms = median_ms(torch, timed_step)
    log(f"[time] training step: {step_ms:.3f} ms (median of {REPS}, compute_"
        "loss + optimize_step)")
    fwd = kf.fused_pairs_forward(table, uv_rows, pairs, rays, gx, m)
    full_a = (table, uv_rows, pairs, rays, gx, m, *fwd[:3], g_blend, g_t_final,
              g_mlist)
    with torch.no_grad():
        a_ms, a_host = kernel_ms(torch,
                                 lambda: kf.fused_pairs_backward(*full_a))
        a_plain_ms = median_ms(torch, lambda: kf.mlist_scan_vjp(*a_sub, *cots),
                               reps=3)   # median of 3
        b_ms, b_host = kernel_ms(torch, lambda: kt.tex_term_backward(*b_args))

    n_f = table.shape[1] - 9
    n_eval = int(fwd[3].sum())
    n_slots = fwd[2][..., 0].numel()
    slots = int((fwd[2][..., 0] != 0).sum())
    # what A' must move: the table, uv rows and pair list, the blend and
    # T_final with their cotangents, every slot's w (4 B; the slot uv is
    # not read), the cotangent of the in-list slots only (16 B), and the
    # two gradients it writes
    a_bytes = (nbytes(table, uv_rows, pairs.pair_gauss, pairs.tile_start,
                      pairs.tile_end, *fwd[:2], g_blend, g_t_final,
                      table, uv_rows)   # the last two: d_table and d_uv
               + 4 * n_slots + 16 * slots)
    a_ops = n_eval * (OPS_A_BWD_EVAL + 3 * n_f) + slots * OPS_A_BWD_SLOT
    a_bound, a_by = bound(a_bytes, a_ops)
    b_live = int(live.sum())
    with torch.enable_grad():
        probe = torch.ones_like(texture, requires_grad=True)
        sample_cubemap(probe, mlist[live][:, 1:4]).sum().backward()
    texels = int((probe.grad.abs().sum(-1) > 0).sum())
    # what B' must move: every slot's w (4 B) and the live slots' uv
    # (12 B), the image cotangent, the touched texels (12 B each), the
    # M-list cotangent and the texture gradient each written once
    b_bytes = (4 * mlist[..., 0].numel() + 12 * b_live + nbytes(g_img)
               + texels * 12 + nbytes(mlist, texture))
    b_bound, b_by = bound(b_bytes, b_live * OPS_B_BWD_SLOT)
    sub = "" if bool(keep.all()) else f" on {int(keep.sum())} of {n_tiles} tiles"
    log(f"[time] kernel A' uvtex_fused_bwd: {a_ms:.4f} ms (host-launched "
        f"{a_host:.4f}), plain "
        f"{a_plain_ms:.3f} ms{sub}, bound {a_bound:.4f} ms ({a_by}: "
        f"{a_bytes / 1e6:.1f} MB, {a_ops / 1e9:.3f} GFLOP; {n_eval} evaluated "
        f"pairs, {slots} slots)")
    log(f"[time] kernel B' tex_term_bwd: {b_ms:.4f} ms (host-launched "
        f"{b_host:.4f}), plain "
        f"{b_plain_ms:.3f} ms (one call), bound {b_bound:.4f} ms ({b_by}: "
        f"{b_bytes / 1e6:.1f} MB incl. {texels} texels touched, {b_live} "
        "live slots)")
    step_launches = profile_device(torch, "one training step", timed_step,
                                   step_ms)
    hash_entries = hash_kernel_phase(torch, seen["hash_encode_backward"],
                                     launches)

    return [
        entry("uvtex_fused_bwd", "texgs_torch/csrc/uvtex_fused_bwd.cu",
              "texgs/kernels/pallas_uvtex_fused.py:324",
              launches["uvtex_fused_bwd"], a_ms, a_plain_ms, a_bound, a_by,
              err_a),
        entry("tex_term_bwd", "texgs_torch/csrc/tex_term_bwd.cu",
              "texgs/kernels/pallas_textile.py:819", launches["tex_term_bwd"],
              b_ms, b_plain_ms, b_bound, b_by, err_b),
        *hash_entries,
    ], step_ms, step_launches


def check_kernel_1(torch, got, want):
    """Kernel 1 against its plain version, pixel by pixel, as check_kernel_a
    holds kernel A: a pixel is off if a channel or its T_final lies beyond
    atol 1e-5 (1e-6 for T) + rtol 1e-4, or its n_eval differs; at most
    MAX_OFF_PIXELS pixels may be off (T-ulp stop flips), and no channel or
    T_final anywhere by more than 0.05.  Returns the max abs error."""
    (blend, t_fin, n_eval), (blend_w, t_w, n_eval_w) = got, want

    def beyond(g, w, atol):
        return (g - w).abs() > atol + 1e-4 * w.abs()

    off = (beyond(blend, blend_w, 1e-5).any(-1) | beyond(t_fin, t_w, 1e-6)
           | (n_eval != n_eval_w))
    errs = {"blend": (blend - blend_w).abs().max().item(),
            "T_final": (t_fin - t_w).abs().max().item()}
    n_off = int(off.sum())
    log(f"  1: {n_off} of {off.numel()} pixels off (allowed "
        f"{MAX_OFF_PIXELS}); max abs err blend {errs['blend']:.3e}, T_final "
        f"{errs['T_final']:.3e}; {int((n_eval != n_eval_w).sum())} n_eval "
        "counts differ")
    if not (n_off <= MAX_OFF_PIXELS and max(errs.values()) <= 0.05
            and all(math.isfinite(v) for v in errs.values())):
        fail("kernel 1 disagrees with its plain version")
    return max(errs.values())


def spiral_ground_truth(torch, device, pcd, cams):
    """Ground-truth views of the cloud at opacity logit 4.0 and SH degree 0
    (scripts/make_synthetic_dataset.py:209-265), rendered by the port:
    cameras with image, alpha as the mask, and normals."""
    from texgs_torch.core.camera import with_ground_truth
    from texgs_torch.core.state import init_from_pcd
    from texgs_torch.render.render import render

    gt = init_from_pcd(pcd.points, pcd.colors, 0, device=device)
    gt.opacity = torch.full_like(gt.opacity, 4.0)
    out = []
    with torch.no_grad():
        for cam in cams:
            v = render(cam, xyz=gt.xyz, opacity=gt.get_opacity(),
                       scaling=gt.get_scaling(), rotation=gt.get_rotation(),
                       features=gt.get_features(), active_sh_degree=0,
                       bg_color=torch.zeros(3, device=device))
            out.append(with_ground_truth(cam, v["render"].clamp(0, 1),
                                         v["alpha"], normal=v["norm"]))
    return out


def stage1_phases(torch, device, work_dir):
    """Phases 10-13 (see the module docstring).  Returns (the trained
    model, its training views, the JSON entries of kernels 1 and 1')."""
    from texgs_torch.config import Cfg
    from texgs_torch.data.synthetic import (orbit_cameras,
                                            textured_sphere_point_cloud)
    from texgs_torch.io.ply import read_pcd, write_ply_xyz
    from texgs_torch.kernels import raster as kr
    from texgs_torch.train.gaussian3d import Gaussian3D

    # ----------------------------------------------------- 10. stage-1 setup
    t0 = time.perf_counter()
    pcd = textured_sphere_point_cloud(N_STAGE1, seed=0)
    cams = orbit_cameras(STAGE1_VIEWS, radius=3.5, width=WIDTH, height=HEIGHT,
                         spiral=True)
    views = spiral_ground_truth(torch, device, pcd, cams)
    # the model starts from the cloud through the dataset's .ply, as the
    # config's data (make_synthetic_dataset.py --init_ply) hands it over
    ply = f"{work_dir}/points3d.ply"
    write_ply_xyz(ply, pcd.points, colors=pcd.colors)
    model = Gaussian3D(Cfg(STAGE1_MODEL_CFG), device=device)
    train_cfg = Cfg(STAGE1_TRAIN_CFG)
    model.bind_train_cfg(train_cfg, [0, 0, 0])
    model.initialize(read_pcd(ply), SPATIAL_LR_SCALE)
    model.setup_optim(Cfg(STAGE1_OPTIM_CFG))
    model.active_sh_degree = STAGE1_SH_DEGREE
    torch.cuda.synchronize()
    cover = float(np.mean([v.alpha_mask.mean().item() for v in views]))
    log(f"[stage1 setup] {model.n_points} Gaussians, {WIDTH}x{HEIGHT}, "
        f"{len(views)} spiral views (alpha covers {cover:.3f}), SH degree "
        f"{model.active_sh_degree} of {model.max_sh_degree}, "
        f"{time.perf_counter() - t0:.1f} s")

    # -------------------------------------------------- 11. stage-1 training
    loss_cfg = Cfg(STAGE1_LOSS_CFG)

    def step(it):
        loss, stats, _ = model.compute_loss(it, 7500, views[it % len(views)],
                                            None, loss_cfg)
        model.optimize_step(it, 7500, train_cfg, {})
        return loss, stats

    seen = {}
    t0 = time.perf_counter()
    with recording(kr, "raster_pairs_forward", seen), \
            recording(kr, "raster_pairs_backward", seen):
        loss, stats = step(STAGE1_FIRST_ITER)
    torch.cuda.synchronize()
    if set(seen) != {"raster_pairs_forward", "raster_pairs_backward"}:
        fail(f"a stage-1 step called {sorted(seen)}")
    log(f"[stage1 train] capture step {STAGE1_FIRST_ITER}: loss "
        f"{loss.item():.5f}, {time.perf_counter() - t0:.2f} s; terms "
        + ", ".join(f"{k} {v.item():.4f}" for k, v in stats.items()
                    if k.startswith("L"))
        + f"; {int(stats['n_pairs'])} pairs")
    want_terms = {"Ll1", "Lssim", "Lalpha", "Lnorm", "Lnorm_smooth",
                  "Lopacity_reg"}
    if not want_terms <= set(stats):
        fail(f"stage 1 misses loss terms {want_terms - set(stats)}")

    counters = {"raster": kr.raster_pairs,
                "raster_bwd": kr.raster_pairs_backward}
    for fn in counters.values():
        fn.launches = 0
    losses = []
    t0 = time.perf_counter()
    last = STAGE1_FIRST_ITER + STAGE1_STEPS
    for it in range(STAGE1_FIRST_ITER + 1, last + 1):
        n_before = model.n_points
        loss, stats = step(it)
        losses.append(loss.item())
        if not all(math.isfinite(v.item()) for v in stats.values()):
            fail(f"stage-1 step {it}: a loss term is not finite: {stats}")
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    log(f"[stage1 train] {STAGE1_STEPS} steps ({STAGE1_FIRST_ITER + 1}.."
        f"{last}) in {train_s:.3f} s; launches {launches}; densification at "
        f"{last}: {n_before} -> {model.n_points} Gaussians")
    log("  total loss by step: " + ", ".join(f"{v:.5f}" for v in losses))
    first, last_mean = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    log(f"  mean loss of the first 5 steps {first:.5f}, of the last 5 "
        f"{last_mean:.5f} ({(last_mean - first) / first:+.2%})")
    for name, n in launches.items():
        if n != STAGE1_STEPS:
            fail(f"kernel {name} launched {n} times in {STAGE1_STEPS} "
                 "stage-1 steps")
    if model.n_points == n_before:
        fail("the densification step left the Gaussian count unchanged")
    for name, a in model.state_dict()["params"].items():
        if not np.isfinite(a).all():
            fail(f"stage-1 parameter {name} is not finite after training")
    if not last_mean < first:
        fail("the stage-1 training loss did not fall")

    # -------------------------------------------------- 12. stage-1 kernels
    table, pairs, gx = seen["raster_pairs_forward"]
    b_args = seen["raster_pairs_backward"]
    blend, t_final, g_blend, g_t_final = b_args[3:]
    log("[stage1 kernels] each against its plain version, on the arguments "
        f"the step-{STAGE1_FIRST_ITER} render and backward gave it")
    n_tiles = pairs.tile_counts.numel()
    n_chunks = -(-int(pairs.tile_counts.max()) // kr.CHUNK)
    # the plain backward keeps about 16 (tiles, 256, CHUNK) f32
    # intermediates per chunk for autograd; where that would not fit, the
    # check keeps a prefix of whole tile rows (tile coordinates follow the
    # tile index)
    need = n_chunks * 16 * n_tiles * 256 * kr.CHUNK * 4
    free = torch.cuda.mem_get_info()[0]
    rows = -(-n_tiles // gx)
    if need > 0.6 * free:
        rows = max(1, int(rows * 0.6 * free / need))
    t_sub = min(n_tiles, rows * gx)
    sub = pairs._replace(tile_start=pairs.tile_start[:t_sub],
                         tile_end=pairs.tile_end[:t_sub],
                         tile_counts=pairs.tile_counts[:t_sub])
    cots = (g_blend[:t_sub].contiguous(), g_t_final[:t_sub].contiguous())
    log(f"  {int(pairs.n_pairs)} pairs over {n_tiles} tiles (at most "
        f"{int(pairs.tile_counts.max())} a tile); 1' is checked on the first "
        f"{t_sub} tiles (plain backward needs about {need / 1e9:.1f} GB for "
        f"all, {free / 1e9:.1f} GB free)")
    with torch.no_grad():
        got_1 = kr.raster_pairs_forward(table, pairs, gx)
        want_1 = kr.raster_scan(table, pairs, gx)
        err_1 = check_kernel_1(torch, got_1, want_1)
        fwd_sub = kr.raster_pairs_forward(table, sub, gx)
        got_1b = kr.raster_pairs_backward(table, sub, gx, *fwd_sub[:2], *cots)
        torch.cuda.reset_peak_memory_stats()
        want_1b = kr.raster_scan_vjp(table, sub, gx, *cots)
        torch.cuda.synchronize()
        log(f"  1' plain backward peak memory "
            f"{torch.cuda.max_memory_allocated() / 1e9:.1f} GB")
        err_1b = max(check_scaled(torch, f"1' {name}", got_1b[:, cols],
                                  want_1b[:, cols], 1e-3, 1e-3,
                                  MAX_OFF_GAUSSIANS, rows=True)
                     for name, cols in (("quad", slice(0, 6)),
                                        ("channels", slice(7, 14))))
        if got_1b[:, [6, 14, 15]].any():
            fail("kernel 1' wrote gradient into a column it must leave at zero")
        del want_1b

    # -------------------------------------------------- 13. stage-1 timings
    it = [last + 1]

    def timed_step():
        step(it[0])
        it[0] += 1

    step_ms = median_ms(torch, timed_step)
    log(f"[time] stage-1 step: {step_ms:.3f} ms (median of {REPS}, compute_"
        "loss + optimize_step)")
    full_b = (table, pairs, gx, *got_1[:2], g_blend, g_t_final)
    with torch.no_grad():
        ms_1, host_1 = kernel_ms(
            torch, lambda: kr.raster_pairs_forward(table, pairs, gx))
        plain_1 = median_ms(torch, lambda: kr.raster_scan(table, pairs, gx),
                            reps=3)
        ms_1b, host_1b = kernel_ms(
            torch, lambda: kr.raster_pairs_backward(*full_b))
        plain_1b = median_ms(torch, lambda: kr.raster_scan_vjp(
            table, sub, gx, *cots), reps=3)
    n_f = 7
    n_eval = int(got_1[2].sum())
    pair_bytes = nbytes(table, pairs.pair_gauss, pairs.tile_start,
                        pairs.tile_end)
    # kernel 1 reads the table and the pair list and writes the channels,
    # T_final and n_eval; 16 + 2F f32 ops per evaluated (pixel, pair)
    bytes_1 = pair_bytes + nbytes(*got_1)
    bound_1, by_1 = bound(bytes_1, n_eval * (OPS_A_EVAL + 2 * n_f))
    # kernel 1' reads those, the channels and T_final with their
    # cotangents, and writes the table gradient; 40 + 3F ops an entry
    bytes_1b = pair_bytes + nbytes(*got_1[:2], g_blend, g_t_final, table)
    ops_1b = n_eval * (OPS_A_BWD_EVAL + 3 * n_f)
    bound_1b, by_1b = bound(bytes_1b, ops_1b)
    sub_note = "" if t_sub == n_tiles else f" on {t_sub} of {n_tiles} tiles"
    log(f"[time] kernel 1 raster: {ms_1:.4f} ms (host-launched "
        f"{host_1:.4f}), plain {plain_1:.3f} ms, "
        f"bound {bound_1:.4f} ms ({by_1}: {bytes_1 / 1e6:.1f} MB, "
        f"{n_eval * (OPS_A_EVAL + 2 * n_f) / 1e9:.3f} GFLOP; {n_eval} "
        "evaluated pairs)")
    log(f"[time] kernel 1' raster_bwd: {ms_1b:.4f} ms (host-launched "
        f"{host_1b:.4f}), plain {plain_1b:.3f} "
        f"ms{sub_note}, bound {bound_1b:.4f} ms ({by_1b}: "
        f"{bytes_1b / 1e6:.1f} MB, {ops_1b / 1e9:.3f} GFLOP)")
    profile_device(torch, "one stage-1 step", timed_step, step_ms)
    entries = [
        entry("raster", "texgs_torch/csrc/raster.cu",
              "texgs/kernels/pallas_raster.py:309", launches["raster"], ms_1,
              plain_1, bound_1, by_1, err_1),
        entry("raster_bwd", "texgs_torch/csrc/raster_bwd.cu",
              "texgs/kernels/pallas_raster.py:359", launches["raster_bwd"],
              ms_1b, plain_1b, bound_1b, by_1b, err_1b),
    ]
    return model, views, entries


def stage2_phase(torch, device, stage1, views, work_dir):
    """Phase 14 (see the module docstring).  Returns the step's device
    launches."""
    from texgs_torch.config import Cfg
    from texgs_torch.io import checkpoint as ckpt
    from texgs_torch.kernels import raster as kr
    from texgs_torch.tools.extract_pcd import extract_pcd
    from texgs_torch.train.optim import flatten_tree
    from texgs_torch.train.uv_map_gaussian3d import UVMapGaussian3D

    t0 = time.perf_counter()
    ck = f"{work_dir}/stage1/checkpoints/7500"
    ckpt.save(ck, stage1.state_dict(), 7500)
    extract_pcd(ck, f"{work_dir}/stage1/pcd", PCD_POINTS, device=device)
    torch.cuda.synchronize()
    log(f"[stage2] stage-1 checkpoint ({stage1.n_points} Gaussians) and "
        f"extract_pcd to {PCD_POINTS} points: {time.perf_counter() - t0:.1f} s")
    cfg = dict(STAGE2_MODEL_CFG, init_from=ck,
               pcd_load_from=f"{work_dir}/stage1/pcd.npy")
    model = UVMapGaussian3D(Cfg(cfg), device=device)
    model.bind_train_cfg(Cfg({}), [0, 0, 0])
    model.initialize()
    model.setup_optim(Cfg(STAGE2_OPTIM_CFG))
    loss_cfg = Cfg(STAGE2_LOSS_CFG)

    def step(it):
        loss, stats, _ = model.compute_loss(it, 4000, views[it % len(views)],
                                            None, loss_cfg)
        model.optimize_step(it, 4000, Cfg({}), {})
        return loss, stats

    loss, stats = step(1)
    log(f"[stage2] first step: loss {loss.item():.5f}; terms "
        + ", ".join(f"{k} {v.item():.4f}" for k, v in stats.items()
                    if k.startswith("L")))
    if set(stats) != {"Linv", "Lchamfer", "Linv2", "total_loss"}:
        fail(f"stage 2 computed {sorted(stats)}")
    counters = {"raster": kr.raster_pairs, **hash_counters()}
    for fn in counters.values():
        fn.launches = 0
    cached = len(model._depth_alpha_cache)
    losses = []
    t0 = time.perf_counter()
    for it in range(2, STAGE2_STEPS + 2):
        loss, stats = step(it)
        losses.append(loss.item())
        if not all(math.isfinite(v.item()) for v in stats.values()):
            fail(f"stage-2 step {it}: a loss term is not finite: {stats}")
    torch.cuda.synchronize()
    s = time.perf_counter() - t0
    new_cams = len(model._depth_alpha_cache) - cached
    launches = {name: fn.launches for name, fn in counters.items()}
    log(f"[stage2] {STAGE2_STEPS} steps in {s:.3f} s ({s / STAGE2_STEPS * 1e3:.1f} "
        f"ms a step incl. {new_cams} first renders); launches {launches}")
    log("  total loss by step: " + ", ".join(f"{v:.5f}" for v in losses))
    first, last = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    log(f"  mean loss of the first 5 steps {first:.5f}, of the last 5 "
        f"{last:.5f} ({(last - first) / first:+.2%})")
    expect = {"raster": new_cams, "hash_encode": STAGE2_STEPS,
              "hash_encode_bwd": STAGE2_STEPS, "hash_gather": 0}
    if launches != expect:
        fail(f"stage 2 launched {launches}; expected kernel 1 once for each "
             f"of the {new_cams} cameras first seen, K5' and K5'' once a "
             "step and the K5 gather never")
    for name, a in flatten_tree(model.state_dict()["net_state"]).items():
        if not np.isfinite(a).all():
            fail(f"stage-2 parameter {name} is not finite after training")
    if not last < first:
        fail("the stage-2 training loss did not fall")
    it = [STAGE2_STEPS + 2]

    def timed_step():
        step(it[0])
        it[0] += 1

    step_ms = median_ms(torch, timed_step)
    log(f"[time] stage-2 step: {step_ms:.3f} ms (median of {REPS}, cached "
        "renders)")
    return profile_device(torch, "one stage-2 step", timed_step, step_ms)


def driver_phase(work_dir, device):
    """Phase 15: the port's command line, stage 1 then stage 2 from its
    checkpoint.  Returns each stage's test PSNR."""
    import glob

    from texgs_torch.config import dump_config, load_config
    from texgs_torch.tools.extract_pcd import extract_pcd
    from texgs_torch.train.__main__ import main as train_main

    def run(config, run_name, n_iter, **edits):
        cfg = load_config(config)
        cfg.train_cfg.update(num_iterations=n_iter, visual_iters=[n_iter],
                             ckpt_iters=[n_iter])
        for section, values in edits.items():
            cfg[section].update(values)
        path = f"{work_dir}/{run_name}.yaml"
        dump_config(cfg, path)
        t0 = time.perf_counter()
        _, _, ev = train_main([path, "--workspace", work_dir, "--run_name",
                               run_name, "--device", str(device)])
        log(f"[driver] {run_name} ({config}): {n_iter} iterations in "
            f"{time.perf_counter() - t0:.1f} s, test PSNR "
            f"{ev['test']['psnr']:.2f} dB, train PSNR "
            f"{ev['train']['psnr']:.2f} dB")
        ck = sorted(glob.glob(f"{work_dir}/{run_name}/*/checkpoints/"
                              f"{n_iter}.npz"))[-1]
        return ev["test"]["psnr"], ck[:-len(".npz")]

    # cut to DRIVER_S1_ITERS iterations, densifying at 100
    psnr1, ck1 = run("configs/synthetic_smoke.yaml", "s1", DRIVER_S1_ITERS,
                     train_cfg={"densify_from_iter": 50},
                     optim_cfg={"position_lr_max_steps": DRIVER_S1_ITERS})
    if not math.isfinite(psnr1):
        fail(f"the driver's stage-1 test PSNR is {psnr1}")
    extract_pcd(ck1, f"{work_dir}/s1_pcd", 4096, device=device)
    psnr2, _ = run("configs/synthetic_uv_map.yaml", "s2", DRIVER_S2_ITERS,
                   model_cfg={"init_from": ck1,
                              "pcd_load_from": f"{work_dir}/s1_pcd.npy"})
    return psnr1, psnr2


def check_kernel_2(torch, got, want):
    """Kernel 2 against its plain version, pixel by pixel, as check_kernel_a
    holds kernel A's M-lists: a pixel is off if a slot value lies beyond
    atol 1e-5 + rtol 1e-4 (a T-ulp stop flip adds or drops its last slot);
    at most MAX_OFF_PIXELS pixels may be off, and no slot weight anywhere
    by more than 0.05.  Returns the max abs error."""
    off = ((got - want).abs() > 1e-5 + 1e-4 * want.abs()).flatten(2).any(-1)
    errs = {"slot w": (got[..., 0] - want[..., 0]).abs().max().item(),
            "slot uv": (got[..., 1:] - want[..., 1:]).abs().max().item()}
    n_off = int(off.sum())
    log(f"  2: {n_off} of {off.numel()} pixels off (allowed {MAX_OFF_PIXELS}); "
        "max abs err " + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
        + f"; {int((got[..., 0] != 0).sum())} live slots")
    if not (n_off <= MAX_OFF_PIXELS and errs["slot w"] <= 0.05
            and all(math.isfinite(v) for v in errs.values())):
        fail("kernel 2 disagrees with its plain version")
    return max(errs.values())


def mlist_evaluated(torch, table, pairs, rays, gx, m):
    """The (pixel, pair) entries kernels 2 and 2' evaluate: each pixel's
    pairs up to its m-th contributor or its T stop, whichever comes first,
    counted chunk by chunk with the plain scan's rules."""
    from texgs_torch.kernels.tile_raster import (NEG_INF, ROW_LOGOP,
                                                 chunk_weights, shift_to_tile,
                                                 tile_power)
    from texgs_torch.kernels.uvtex_fused import CHUNK, _tile_rays

    n_tiles = pairs.tile_counts.shape[0]
    tile_x, tile_y, _ = _tile_rays(rays, n_tiles, gx, table.device)
    t_buf = torch.ones((n_tiles, 256), device=table.device)
    done = torch.zeros_like(t_buf, dtype=torch.bool)
    count = torch.zeros_like(t_buf, dtype=torch.int64)
    counts = pairs.tile_counts.to(torch.int64)
    starts = pairs.tile_start.to(torch.int64)
    total = 0
    for c0 in range(0, int(counts.max()) if n_tiles else 0, CHUNK):
        k = torch.arange(c0, c0 + CHUNK, device=table.device)
        live = k[None, :] < counts[:, None]
        idx = torch.clamp(starts[:, None] + k[None, :],
                          max=pairs.pair_gauss.shape[0] - 1)
        rows = table[pairs.pair_gauss[idx].to(torch.int64)]
        quad = shift_to_tile(rows, tile_x[:, None], tile_y[:, None])
        quad[..., 5] = torch.where(live, quad[..., 5], NEG_INF)
        w, t_out, done_m, fail = chunk_weights(
            tile_power(quad), rows[..., ROW_LOGOP][:, None, :], t_buf, done)
        acc = (w > 0).to(torch.int64)
        rank = count[..., None] + torch.cumsum(acc, -1) - acc
        fail_i = fail.to(torch.int64)
        stopped = done[..., None] | (torch.cumsum(fail_i, -1) - fail_i > 0)
        total += int((live[:, None, :] & ~stopped & (rank < m)).sum())
        count += acc.sum(-1)
        t_buf, done = t_out, done_m[..., -1]
    return total


def two_kernel_phases(torch, device, sd0, cams, views, retextured, chess,
                      fused_render_ms, fused_step_ms):
    """Phases 16 and 17 (see the module docstring): `sd0` is the state of
    phase 3's model, `views` and `retextured` the fused path's images of
    phase 5.  Returns (the trained two-kernel model, the JSON entries of
    kernels 2 and 2')."""
    from texgs_torch.config import Cfg
    from texgs_torch.kernels import raster as kr
    from texgs_torch.kernels import tex_term as kt
    from texgs_torch.kernels import uvtex_fused as kf
    from texgs_torch.kernels import uvtex_mlist as km
    from texgs_torch.kernels.tile_raster import N_FIXED_F, TABLE_FIXED
    from texgs_torch.train.texture_gaussian3d import from_jax_state

    # ------------------------------------------------ 16. two-kernel render
    model = from_jax_state(sd0, Cfg(dict(MODEL_CFG, backend="pallas")),
                           device=device)
    model.bind_train_cfg(None, MODEL_CFG["background"])
    seen = {}
    with recording(kr, "raster_pairs", seen) as rec_1, \
            recording(km, "mlist_pairs", seen) as rec_2, \
            recording(kt, "tex_term", seen) as rec_b:
        model.render(cams[0])
    if (set(seen) != {"raster_pairs", "mlist_pairs", "tex_term"}
            or (rec_1.launches, rec_2.launches, rec_b.launches) != (1, 1, 1)):
        fail(f"the two-kernel render called {sorted(seen)}, launches "
             f"{rec_1.launches}, {rec_2.launches} and {rec_b.launches}")
    table, pairs, gx = seen["raster_pairs"]
    m_args = seen["mlist_pairs"]
    uv_rows, m = m_args[1], m_args[5]
    n_f = table.shape[1] - TABLE_FIXED + N_FIXED_F
    log(f"[two-kernel] view 0: {int(pairs.n_pairs)} pairs over "
        f"{pairs.tile_counts.numel()} tiles, F = {n_f}, m = {m}; kernels 1 "
        "and 2 against their plain versions on the arguments it gave them")
    with torch.no_grad():
        got_1 = kr.raster_pairs_forward(table, pairs, gx)
        err_1 = check_kernel_1(torch, got_1, kr.raster_scan(table, pairs, gx))
        got_2 = km.mlist_pairs_forward(*m_args)
        err_2 = check_kernel_2(torch, got_2, km.mlist_only_scan(*m_args))

    counters = {"raster": kr.raster_pairs, "uvtex_mlist": km.mlist_pairs,
                "tex_term": kt.tex_term, "uvtex_fused": kf.fused_pairs}
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    two = [model.visual_step(0, 1, c) for c in cams]
    model.change_texture(chess, mode=0)
    two += [model.visual_step(0, 1, c) for c in cams]
    torch.cuda.synchronize()
    main_launches = {name: fn.launches for name, fn in counters.items()}
    log(f"[two-kernel main] {2 * N_VIEWS} views (3 + 3 retextured) in "
        f"{time.perf_counter() - t0:.3f} s; launches {main_launches}")
    expect = {"raster": 2 * N_VIEWS, "uvtex_mlist": 2 * N_VIEWS,
              "tex_term": 2 * N_VIEWS, "uvtex_fused": 0}
    if main_launches != expect:
        fail(f"the two-kernel views launched {main_launches}, expected {expect}")
    for i, (got, want) in enumerate(zip(two, views + retextured)):
        for k in ("image", "image_no_sh", "depth", "norm", "alpha"):
            if not bool(torch.isfinite(got[k]).all()):
                fail(f"two-kernel view {i}: {k} is not finite")
        check_close(torch, f"two-kernel image {i} vs the fused path's",
                    got["image"], want["image"], atol=1e-4, rtol=1e-4,
                    max_off=3 * MAX_OFF_PIXELS, hard=0.05)
    del two

    with torch.no_grad():
        render_ms = median_ms(torch, lambda: model.render(cams[0]))
        ms_1, host_1 = kernel_ms(
            torch, lambda: kr.raster_pairs_forward(table, pairs, gx))
        plain_1 = median_ms(torch, lambda: kr.raster_scan(table, pairs, gx),
                            reps=3)
        ms_2, host_2 = kernel_ms(torch,
                                 lambda: km.mlist_pairs_forward(*m_args))
        plain_2 = median_ms(torch, lambda: km.mlist_only_scan(*m_args), reps=3)
        eval_2 = mlist_evaluated(torch, table, pairs, m_args[3], gx, m)
    n_eval = int(got_1[2].sum())
    live = int((got_2[..., 0] != 0).sum())
    pair_bytes = nbytes(pairs.pair_gauss, pairs.tile_start, pairs.tile_end)
    # kernel 1 reads the table and the pair list and writes the channels,
    # T_final and n_eval; kernel 2 reads the table, the uv rows and the
    # pair list and writes the M-lists, evaluating each pixel's pairs up to
    # its m-th contributor or its stop
    bytes_1 = nbytes(table) + pair_bytes + nbytes(*got_1)
    bound_1, by_1 = bound(bytes_1, n_eval * (OPS_A_EVAL + 2 * n_f))
    bytes_2 = nbytes(table, uv_rows, got_2) + pair_bytes
    bound_2, by_2 = bound(bytes_2, eval_2 * OPS_A_EVAL + live * OPS_A_SLOT)
    log(f"[time] two-kernel render of view 0: {render_ms:.3f} ms (median of "
        f"{REPS}; the fused path's {fused_render_ms:.3f} ms)")
    log(f"[time] kernel 1 raster at F = {n_f}: {ms_1:.4f} ms (host-launched "
        f"{host_1:.4f}), plain "
        f"{plain_1:.3f} ms, bound {bound_1:.4f} ms ({by_1}: "
        f"{bytes_1 / 1e6:.1f} MB, {n_eval} evaluated pairs)")
    log(f"[time] kernel 2 uvtex_mlist: {ms_2:.4f} ms (host-launched "
        f"{host_2:.4f}), plain {plain_2:.3f} ms, "
        f"bound {bound_2:.4f} ms ({by_2}: {bytes_2 / 1e6:.1f} MB, {eval_2} "
        f"evaluated pairs, {live} live slots)")

    # ---------------------------------------------- 17. two-kernel training
    step = stage3_stepper(model, cams, views)
    seen = {}
    t0 = time.perf_counter()
    with recording(kr, "raster_pairs_backward", seen), \
            recording(km, "mlist_pairs_backward", seen):
        loss, stats = step(FIRST_ITER)
    torch.cuda.synchronize()
    if set(seen) != {"raster_pairs_backward", "mlist_pairs_backward"}:
        fail(f"a two-kernel training step called {sorted(seen)}")
    log(f"[two-kernel train] capture step {FIRST_ITER}: loss "
        f"{loss.item():.5f}, {time.perf_counter() - t0:.2f} s")
    counters = {"raster": kr.raster_pairs,
                "raster_bwd": kr.raster_pairs_backward,
                "uvtex_mlist": km.mlist_pairs,
                "uvtex_mlist_bwd": km.mlist_pairs_backward,
                "tex_term": kt.tex_term, "tex_term_bwd": kt.tex_term_backward,
                **hash_counters(), "uvtex_fused": kf.fused_pairs,
                "uvtex_fused_bwd": kf.fused_pairs_backward}
    expect = {name: 0 if name.startswith("uvtex_fused") or name == "hash_gather"
              else STEPS for name in counters}
    train_launches = check_train_run(torch, "two-kernel train", model, step,
                                     counters, expect)

    table, pairs, gx, blend, t_final, g_blend, g_t_final = \
        seen["raster_pairs_backward"]
    b_args = seen["mlist_pairs_backward"]
    uv_rows, rays, m, mlist, g_mlist = b_args[1], b_args[3], b_args[5], \
        b_args[6], b_args[7]
    log("[two-kernel kernels] on the arguments the step-"
        f"{FIRST_ITER} backward gave kernels 1' and 2'")
    with torch.no_grad():
        d_1 = kr.raster_pairs_backward(table, pairs, gx, blend, t_final,
                                       g_blend, g_t_final)
        d_2 = km.mlist_pairs_backward(*b_args)
        fwd_a = kf.fused_pairs_forward(table, uv_rows, pairs, rays, gx, m)
        want_a = kf.fused_pairs_backward(table, uv_rows, pairs, rays, gx, m,
                                         *fwd_a[:3], g_blend, g_t_final,
                                         g_mlist)
        err_ab = check_a_backward(torch, (d_1 + d_2[0], d_2[1]), want_a,
                                  label="1' + 2' vs A'")
        del fwd_a, want_a, d_1

        keep, note = plain_backward_tiles(torch, pairs, table.device, kf.CHUNK)
        sub = (table, uv_rows, restricted_tiles(pairs, keep), rays, gx, m)
        g_sub = torch.where(keep.view(-1, 1, 1, 1), g_mlist, 0.0).contiguous()
        log(f"  2' is checked on {note}")
        got_2b = km.mlist_pairs_backward(*sub, km.mlist_pairs_forward(*sub),
                                         g_sub)
        want_2b = km.mlist_only_scan_vjp(*sub, g_sub)
        err_2b = max(
            check_scaled(torch, "2' quad", got_2b[0][:, :6], want_2b[0][:, :6],
                         1e-3, 1e-3, MAX_OFF_GAUSSIANS, rows=True),
            check_scaled(torch, "2' uv rows", got_2b[1][:, :12],
                         want_2b[1][:, :12], 1e-3, 1e-3, MAX_OFF_GAUSSIANS,
                         rows=True))
        if got_2b[0][:, 6:].any() or got_2b[1][:, 12:].any():
            fail("kernel 2' wrote gradient into a column it must leave at zero")
        del want_2b

    it = [FIRST_ITER + STEPS + 1]

    def timed_step():
        step(it[0])
        it[0] += 1

    step_ms = median_ms(torch, timed_step)
    log(f"[time] two-kernel training step: {step_ms:.3f} ms (median of {REPS}; "
        f"the fused path's {fused_step_ms:.3f} ms)")
    with torch.no_grad():
        ms_2b, host_2b = kernel_ms(
            torch, lambda: km.mlist_pairs_backward(*b_args))
        plain_2b = median_ms(torch, lambda: km.mlist_only_scan_vjp(*sub, g_sub),
                             reps=3)
        eval_2b = mlist_evaluated(torch, table, pairs, rays, gx, m)
        # kernel 1' at F = 10 on the same step's arguments
        ms_1b, host_1b = kernel_ms(torch, lambda: kr.raster_pairs_backward(
            table, pairs, gx, blend, t_final, g_blend, g_t_final))
        cots_1b = [torch.where(keep.view(-1, *[1] * (c.dim() - 1)), c,
                               0.0).contiguous() for c in (g_blend, g_t_final)]
        plain_1b = median_ms(torch, lambda: kr.raster_scan_vjp(
            table, sub[2], gx, *cots_1b), reps=3)
        eval_1b = int(kr.raster_pairs_forward(table, pairs, gx)[2].sum())
    live = int((mlist[..., 0] != 0).sum())
    # what 2' must move: the table, uv rows and pair list, every slot's w
    # (4 B), the live slots' cotangents (16 B) and the two gradients it
    # writes; its replay evaluates the entries kernel 2 did
    bytes_2b = (nbytes(table, uv_rows, pairs.pair_gauss, pairs.tile_start,
                       pairs.tile_end, table, uv_rows)
                + 4 * mlist[..., 0].numel() + 16 * live)
    bound_2b, by_2b = bound(bytes_2b, eval_2b * OPS_A_BWD_EVAL
                            + live * OPS_A_BWD_SLOT)
    sub_note = "" if bool(keep.all()) else f" on {int(keep.sum())} tiles"
    # kernel 1' reads the table, the pair list, the channels and T_final
    # with their cotangents, and writes the table gradient; 40 + 3F ops an
    # evaluated entry
    bytes_1b = nbytes(table, pairs.pair_gauss, pairs.tile_start,
                      pairs.tile_end, blend, t_final, g_blend, g_t_final,
                      table)
    ops_1b = eval_1b * (OPS_A_BWD_EVAL + 3 * n_f)
    bound_1b, by_1b = bound(bytes_1b, ops_1b)
    log(f"[time] kernel 1' raster_bwd at F = {n_f}: {ms_1b:.4f} ms "
        f"(host-launched {host_1b:.4f}), plain "
        f"{plain_1b:.3f} ms{sub_note}, bound {bound_1b:.4f} ms ({by_1b}: "
        f"{bytes_1b / 1e6:.1f} MB, {ops_1b / 1e9:.3f} GFLOP; {eval_1b} "
        "evaluated pairs)")
    log(f"[time] kernel 2' uvtex_mlist_bwd: {ms_2b:.4f} ms (host-launched "
        f"{host_2b:.4f}), plain "
        f"{plain_2b:.3f} ms{sub_note}, bound {bound_2b:.4f} ms ({by_2b}: "
        f"{bytes_2b / 1e6:.1f} MB, {eval_2b} evaluated pairs, {live} live "
        "slots)")
    log(f"  1' + 2' against A' on the capture step: max abs err {err_ab:.3e}; "
        f"kernel 1 at F = {n_f} max abs err {err_1:.3e}")
    profile_device(torch, "one two-kernel training step", timed_step, step_ms)
    return model, [
        entry("uvtex_mlist", "texgs_torch/csrc/uvtex_mlist.cu",
              "texgs/kernels/pallas_uvtex.py:237", main_launches["uvtex_mlist"],
              ms_2, plain_2, bound_2, by_2, err_2),
        entry("uvtex_mlist_bwd", "texgs_torch/csrc/uvtex_mlist_bwd.cu",
              "texgs/kernels/pallas_uvtex.py:290",
              train_launches["uvtex_mlist_bwd"], ms_2b, plain_2b, bound_2b,
              by_2b, err_2b),
    ]


def tools_phase(torch, device, model, work_dir):
    """Phase 18 (see the module docstring)."""
    import socket
    import urllib.error
    import urllib.request
    from pathlib import Path

    from texgs_torch.config import Cfg, dump_config
    from texgs_torch.io import checkpoint as ckpt
    from texgs_torch.io import png
    from texgs_torch.tools import evaluate, extract_texture, retexture

    d = f"{work_dir}/tools"
    ck = f"{d}/checkpoints/{FIRST_ITER + STEPS}"
    ckpt.save(ck, model.state_dict(), FIRST_ITER + STEPS)
    cfg_path = f"{d}/stage3.yaml"
    dump_config(Cfg({
        "dataset_cfg": {"type": "scene", "data_root_dir":
                        f"synthetic://sphere?n={TOOLS_POINTS}&views="
                        f"{TOOLS_VIEWS}&size={TOOLS_SIZE}",
                        "background": [0, 0, 0], "shuffle": False,
                        "resolution": 1, "resolution_scales": [1.0]},
        "model_cfg": dict(MODEL_CFG, backend="pallas"),
        "train_cfg": {}}), cfg_path)
    common = ["--ckpt", ck, "--device", str(device)]

    t0 = time.perf_counter()
    cube = extract_texture.main([cfg_path, *common, "--out", f"{d}/tex.png"])
    back = png.read(f"{d}/tex.png")
    if not np.array_equal(back, (np.clip(cube, 0, 1) * 255).astype(np.uint8)):
        fail("extract_texture's PNG does not read back as its cube map")
    log(f"[tools] extract_texture: {back.shape[1]}x{back.shape[0]} cube cross "
        f"in {time.perf_counter() - t0:.1f} s (written and read back)")

    t0 = time.perf_counter()
    summary, rows = evaluate.main([cfg_path, *common, "--out",
                                   f"{d}/metrics.json", "--save_images",
                                   f"{d}/eval"])
    saved = png.read(f"{d}/eval/00000.png")
    values = [summary[k] for k in ("psnr", "ssim", "l1")] + [
        r["normal_mae_deg"] for r in rows]
    if not all(math.isfinite(v) for v in values) or saved.shape != (
            TOOLS_SIZE, TOOLS_SIZE, 3):
        fail(f"evaluate: metrics {summary}, saved image {saved.shape}")
    log(f"[tools] evaluate: {summary['n_views']} test view(s) of "
        f"{TOOLS_SIZE}x{TOOLS_SIZE}, PSNR {summary['psnr']:.3f} dB, SSIM "
        f"{summary['ssim']:.4f}, L1 {summary['l1']:.4f}, normal MAE "
        f"{rows[0]['normal_mae_deg']:.2f} deg, {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    cross = (np.indices((3 * 256, 4 * 256)).sum(0) // 32 % 2 * 200 + 30)
    png.write(f"{d}/cross.png", np.repeat(cross[..., None], 3, -1)
              .astype(np.uint8))
    _, outs = retexture.main([cfg_path, *common, "--out", f"{d}/retex",
                              "--load_texture_from", f"{d}/cross.png",
                              "--mode", "0"])
    images = [png.read(p) for split in ("train", "test") for p in outs[split]]
    if (len(images) != TOOLS_VIEWS or any(im.shape != (TOOLS_SIZE, TOOLS_SIZE, 3)
                                          for im in images)
            or not any(im.any() for im in images)):
        fail(f"retexture wrote {len(images)} views")
    log(f"[tools] retexture: a {cross.shape[1]}x{cross.shape[0]} cross resized "
        f"to the {TEX_RES}^2 texture, {len(images)} views written and read "
        f"back, {time.perf_counter() - t0:.1f} s")

    # the viewer as a user starts it, in a process of its own
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    t0 = time.perf_counter()
    with open(f"{d}/viewer.log", "w") as out:
        proc = subprocess.Popen(
            [sys.executable, "-m", "texgs_torch.tools.viewer", cfg_path,
             *common, "--port", str(port)],
            cwd=str(Path(__file__).resolve().parent), stdout=out,
            stderr=subprocess.STDOUT)
        try:
            url = f"http://127.0.0.1:{port}"
            while True:
                try:
                    with urllib.request.urlopen(url + "/", timeout=10):
                        break
                except (urllib.error.URLError, ConnectionError):
                    if proc.poll() is not None or time.perf_counter() - t0 > 300:
                        fail("the viewer did not start: "
                             + Path(f"{d}/viewer.log").read_text()[-2000:])
                    time.sleep(1)
            up_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            with urllib.request.urlopen(
                    url + "/frame?az=0.5&el=0.3&r=3.5&mode=rgb&scale=1&fov=50",
                    timeout=120) as resp:
                frame = png.decode(resp.read())
            frame_s = time.perf_counter() - t0
        finally:
            proc.terminate()
            try:
                proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
    if frame.shape != (480, 640, 3) or not frame.any():
        fail(f"the viewer's frame is {frame.shape}, nonzero {bool(frame.any())}")
    log(f"[tools] viewer: up in {up_s:.1f} s, one 640x480 /frame PNG in "
        f"{frame_s:.3f} s ({int((frame.sum(-1) > 0).sum())} pixels lit)")


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

    # phase 3's model, for the two-kernel phases
    sd0 = model.state_dict()
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
        a_ms, a_host = kernel_ms(torch, lambda: fused_pairs(*a_args))
        a_plain_ms = median_ms(torch, lambda: mlist_scan(*a_args))
        b_ms, b_host = kernel_ms(torch, lambda: tex_term(*b_args))
        b_plain_ms = median_ms(torch, lambda: mlist_tex_term(*b_args))

        # bounds from this run's inputs
        a_bytes = nbytes(table, uv_rows, pairs.pair_gauss, pairs.tile_start,
                         pairs.tile_end, *got_a)
        live_slots = int((mlist[..., 0] != 0).sum())
        a_ops = (int(got_a[3].sum()) * (OPS_A_EVAL + 2 * n_f)
                 + live_slots * OPS_A_SLOT)
        a_bound, a_by = bound(a_bytes, a_ops)
        # texels kernel B touches: those with a nonzero bilinear weight in
        # some live slot (the gradient of the plain term, unit weights)
        live = mlist[mlist[..., 0] != 0]
        with torch.enable_grad():
            probe = torch.ones_like(texture, requires_grad=True)
            sample_cubemap(probe, live[:, 1:4]).sum().backward()
        texels = int((probe.grad.abs().sum(-1) > 0).sum())
        b_bytes = nbytes(mlist) + texels * 12 + nbytes(got_b)
        b_ops = live_slots * OPS_B_SLOT
        b_bound, b_by = bound(b_bytes, b_ops)
    log(f"[time] kernel A uvtex_fused: {a_ms:.4f} ms (host-launched "
        f"{a_host:.4f}), plain {a_plain_ms:.3f} ms, "
        f"bound {a_bound:.4f} ms ({a_bytes / 1e6:.1f} MB, "
        f"{a_ops / 1e9:.3f} GFLOP)")
    log(f"[time] kernel B tex_term: {b_ms:.4f} ms (host-launched "
        f"{b_host:.4f}), plain {b_plain_ms:.3f} ms, "
        f"bound {b_bound:.4f} ms ({b_bytes / 1e6:.1f} MB incl. {texels} "
        f"texels touched, {live_slots} live slots)")

    kernels = [
        entry("uvtex_fused", "texgs_torch/csrc/uvtex_fused.cu",
              "texgs/kernels/pallas_uvtex_fused.py:263",
              launches["uvtex_fused"], a_ms, a_plain_ms, a_bound, a_by, err_a),
        entry("tex_term", "texgs_torch/csrc/tex_term.cu",
              "texgs/kernels/pallas_textile.py:774", launches["tex_term"],
              b_ms, b_plain_ms, b_bound, b_by, err_b),
    ]
    with torch.no_grad():
        profile_device(torch, "one render of view 0",
                       lambda: model.render(cams[0]), render_ms)

    entries, step_ms, step3_launches = train_phases(torch, model, cams, views)
    kernels += entries
    del model, a_args, b_args, got_a, want_a, got_b, want_b
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as work_dir:
        stage1, s1_views, entries = stage1_phases(torch, device, work_dir)
        kernels += entries
        step2_launches = stage2_phase(torch, device, stage1, s1_views,
                                      work_dir)
        del stage1, s1_views
        torch.cuda.empty_cache()
        driver_phase(work_dir, device)
        model, entries = two_kernel_phases(torch, device, sd0, cams, views,
                                           retextured, chess, render_ms,
                                           step_ms)
        kernels += entries
        del views, retextured
        torch.cuda.empty_cache()
        tools_phase(torch, device, model, work_dir)
    log(f"[launches] device launches of one step under torch.profiler: "
        f"stage 3 {step3_launches}, stage 2 {step2_launches}")
    log(card)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
