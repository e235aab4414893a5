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
                kernel A also with its tiles in launch order instead of
                the pair list's heaviest-first order (the same outputs bit
                for bit); kernel B also on cube edge and corner directions,
                on M-lists of m = 1, 4 and 33 slots (warps that straddle
                pixels; pixels of 0, 1, 31 and m live slots), and with NaN
                in every dead slot's uv, there and on view 0's M-lists (the
                same output bit for bit); kernel M's two maps of the
                model's texture (visual_step's 512x1024 panorama and the
                cross image) against the plain chain, the cross bit for bit;
  4b. projection -- kernels P and P' (csrc/project.cu, project_bwd.cu) on
                the benchmark's stage-3 DTU scene (100,000 flat discs) and
                its first 800x600 view, in the stage-3 form and with stage
                1's NDC offset: every output against the plain chain
                (project_plain; the culled opacities and the visible set
                exactly, the radii counted where they differ) and every
                gradient against autograd through it; each path's device
                launches (P and P' one each); P and P' timed queued and
                host-launched beside their bounds (88 and 128 B a
                Gaussian) and the 0.02 ms target, and profiled; its
                entries carry P's launches over phase 5 and P''s over phase
                7 (run after phase 9);
  4c. rows   -- kernels G and G' (csrc/uvtex_rows.cu, uvtex_rows_bwd.cu) on
                the same scene and view, projected by P, its uvs
                normalize(xyz) with that map's Jacobian, at E = 0 and E = 3:
                the table and the uv rows against the plain chain
                (uvtex_rows_plain) bit for bit, every gradient against
                autograd through it at 1e-5 of each column's largest (a G'
                with an in-plane scaling column zeroed must fail); each
                path's device launches (G and G'
                one each); G and G' timed queued and host-launched beside
                their bounds (300 and 316 B a Gaussian), and profiled; their
                entries carry G's launches over phase 5 and G''s over phase
                7 (run after phase 4b);
  4d. adam   -- the Adam kernel (csrc/adam.cu) on the benchmark's stage-3
                leaves (scene.py's state at iteration 10,000: 100,000
                Gaussians at SH 3, the UV nets and embedding, the 1024^2
                texture; the three Adams at the cell's step counts) with
                random gradients, none for the inverse net (the DTU
                config has no inverse loss): two steps of the three Adams
                against adam_plain on copies, every parameter and moment
                bit for bit; the device launches of both (3 and the plain
                chain's); the three launches timed queued and host-launched
                beside their bound (28 B an element, 24 without a
                gradient), the 0.30 ms target and the plain chain's time,
                Adam.step's host time, and profiled; the kernel's ptxas
                report; its entry carries its launches over phase 7 (run
                after phase 4c);
  5. main    -- 3 orbit views through TextureGaussian3D.visual_step, a
                change_texture(chessboard, mode=0) retexture, the 3 views
                again; every kernel's launch count is read over this phase
                (A, B, P and G once a view, M twice: one launch a map, P'
                and G' never: a view renders under no_grad);
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
                first 5's, and kernels A, A', B, B', P, P', G, G', the
                fused hash encode K5' and its backward K5'' must each launch
                once a step (the K5 gather never), the Adam kernel three
                times (one an optimiser);
  8. train kernels -- A' and B' against their plain versions on the
                captured arguments;
  9. train timings -- the step's median time, each kernel's time, plain
                time and bound, one step under torch.profiler (its device
                launches); then K5', K5'' and the K5 gather on the
                captured hash-grid arguments: the corners K5' picks (bit
                for bit), its features and the gradients of K5'' against
                their plain versions, the gather on the step's own corner
                indices (and on all but its last 3 queries, the gather's
                scalar path); their times beside their plain versions, bounds
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
                and with its tiles in launch order instead of the pair
                list's heaviest-first order (the same outputs bit for bit);
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
                (densification at 100) with --profile_dir (the trace of
                iterations 100-110 must hold device events of kernels 1 and
                1'), then configs/synthetic_uv_map.yaml for 50 iterations
                from its checkpoint; each stage's test PSNR; then a
                --debug --debug_nans run of DRIVER_NAN_ITERS stage-1
                iterations (anomaly mode) with a finite test PSNR;
 16. two-kernel render -- the model of phase 3 with model_cfg.backend
                pallas (kernel 1 blends, kernel 2 writes the M-lists):
                kernels 2 and 1 (F = 10) against their plain versions on
                view 0's arguments, both also in both tile orders (bit
                for bit), kernel 2 also into output memory that held NaN
                (bit for bit: every dead slot written 0) and at m = 1 and
                33; the 3 views, the chessboard retexture and
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

 19. golden -- tests/test_pipeline_3stage.py on the port from files on
                disk: python -m texgs_torch.tools.make_dataset writes its
                Blender scene (512 points, 6 + 2 views of 48^2, the dense
                oracle's renders), then driver.train runs stage 1
                (synthetic_smoke.yaml, 150 iterations), extract_pcd (512
                points), stage 2 (synthetic_uv_map.yaml, 120) and stage 3
                (synthetic_texture.yaml, 240) with the test's overrides
                but an M-list that cuts no pixel's list (GOLDEN_M), and
                the untrained stage-3 baseline; gated as the test gates
                texgs: tests/goldens/pipeline_3stage.json's floors (s1, s3
                PSNR, s3 SSIM), s3 >= s1 - 5.5 dB, s3 >= the baseline + 2
                dB, a texture that got a gradient, unit UVs with a cycle
                error under 2 and both chess colours; and stage 3's test
                renders against the port's dense oracle; kernels
                1 and 1' at least once a stage-1 step, K5' and K5'' a
                stage-2 step, A, A', B and B' a stage-3 step (K5' and K5''
                a step of the inverse loss);
 20. formats -- stage 1 (150 iterations) from a COLMAP and from a NeILF
                scene the writer made (16 spiral views of 48^2):
                the 14 / 2 splits, the masks and normals of NeILF, the
                native IO library built and agreeing with the Python
                parsers, a test PSNR above 15 dB;
 21. prod scene -- configs/prod_stage1.yaml's checker_prod scene (50,000
                points, 64 + 8 spiral views of 800x600, tiled renders)
                written, read back through Scene (each ground truth
                against the writer's float render, to 8-bit
                quantisation) and trained 20 iterations through
                driver.train with an evaluation; the seconds of each;
 22. measure -- the tools of measurement: python -m
                texgs_torch.tools.verify_compiled at its defaults (100,000
                Gaussians, 800x600; kernels 1, 1', 2, 2', A, A', B, B'
                against the plain twin through whole renders) as a process
                of its own, which must print ok and compiled; python -m
                texgs_torch.tools.bench, whose two metric lines
                (stage3_step_ms, then rays_per_s_fwd_bwd_cuda) must be
                finite and positive with mfu_pct and hbm_util_pct in
                (0, 100]; in this process bench_stage3.measure must launch
                A, A', B, B', K5' and K5'' once a step and the bench's
                stage-1 step 1 and 1' once a step; the roofline tables of
                both steps.

 23. dist -- texgs_torch.dist on the card.  In this process, phase 3's
                model and the bench's blob (blob_point_cloud(100,000), SH
                3, 800x600): view 0 in 2 bands (304 rows, 8 padded) and in
                4 (160 rows, the last 120 real) through render_band,
                stitched and held against the whole frame as phase 5
                holds its image (A, B and 1 once a band); kernels A, B and
                1 on band 1 of 2's arguments and A', B' and 1' on one step
                of the padded last band of 4, against their plain
                versions; 2 and 4 depth slices folded with the over
                operator against the whole frame, within the local-T_STOP
                bound (stage 3 at the longest live M-list of view 0, so
                no list is cut; at m = 32 the difference is reported).
                Then dryrun_multichip(2) and (4) on CUDA tensors; and at
                full width, 2 ranks in a (data 1, tile 2) mesh (gloo over
                CUDA tensors: NCCL refuses two ranks on one card) take
                phase 7's stage-3 step (tile; gauss at m = 32 and at that
                longest list) and the blob's stage-1 step (tile, gauss),
                each held against the single-card compute_loss step on
                the same model and camera, the replicas identical after
                it, three more steps timed beside the bytes the
                collectives moved; then the same on one rank over NCCL,
                within 1e-6 of the single-card step.
 24. pipeline -- python -m texgs_torch.tools.prod_pipeline --quick in
                this process (scripts/run_prod_pipeline.py's three stages
                of 750, 400 and 1,000 iterations at 800x600 on phase 21's
                checker_prod, the production configs' model widths): each
                stage's launches counted (stage 1: 1 and 1' once an
                iteration, 1 once an evaluated view; stage 2: kernel 1 once
                a camera, K5' and K5'' once a step, K5' once an
                evaluation's point cloud; stage 3: A, A', B and B' once a
                step, A and B once an evaluated view, K5' and K5'' once a
                step of the inverse loss; kernels 2 and 2' never), each
                stage's seconds and peak device memory; A, A', B and B'
                against their plain versions on the last stage-3 step's
                arguments (A's uv slots off the plain version's on flat
                Gaussians held against the float64 uv, and the route
                shown to refuse 40 slots' uv turned by 0.02 rad);
                pipeline_prod_metrics.json with texgs's keys
                and finite PSNRs; the final stage-1 and stage-3 test PSNRs
                at least the first card reading less 1.5 dB.

The line before the last is a JSON object with one entry per kernel
(seventeen); the last line is {"ok": true, "device": {...}}.

    python3 chip_smoke.py --golden-seeds 0,1,2

runs phases 1 and 19 alone, once for each training seed (Python's,
numpy's and torch's generators, and each stage model's).

    python3 chip_smoke.py --dist

runs phases 1-3 and 23 alone.

    python3 chip_smoke.py --prod-full

runs phases 1 and 2, then phase 24 at the production schedules (7,500 +
4,000 + 10,000 iterations, the dataset written anew) without its PSNR
gates, and prints its record: the metrics, each stage's seconds, peak
memory, launches and every evaluation, and stage 3's pairs a step.
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

# GPU cycles the stream spins before a queued timing (about 2 ms)
QUEUE_CYCLES = 4_000_000
# f32 operations of kernel A per evaluated (pixel, pair) besides the
# 2 * F of the blend, per written M-list slot; of kernel B per live slot
OPS_A_EVAL = 16
OPS_A_SLOT = 60
OPS_B_SLOT = 300   # seamless bilinear, the main path's filter
# of kernel M per panorama pixel: its direction, footprint, four seamless
# taps (up to 12 texels through sh02rgb) and the blend
OPS_M_PIXEL = 400
# visual_step's envmap: the (H, W) of its panorama
PANORAMA = (512, 1024)
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
DRIVER_NAN_ITERS = 20
# timed steps of the bench's stage-3 and stage-1 steps whose launches
# phase 22 counts in this process
MEASURE_ITERS = 3
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


def check_kernel_a(torch, got, want, exact_uv=None):
    """Kernel A against its plain version, pixel by pixel.

    A pixel is off if a blend channel, its T_final or an M-list value lies
    beyond atol 1e-5 (1e-6 for T) + rtol 1e-4, or its n_eval differs.  The
    kernel's running product T and the plain version's chunked cumprod
    round differently, so a pixel whose T lands within an ulp of the 1e-4
    stop may stop one Gaussian apart: that moves its channels and T by
    less than 0.05 (the entry's weight is below 1e-2) and adds or drops its
    last slot.  At most MAX_OFF_PIXELS pixels may be off, and no blend
    channel, T_final or slot weight anywhere by more than 0.05.  With
    `exact_uv`, a slot whose uv alone lies beyond the plain version's is
    held instead against the exact value (``exact_uv(got, want, slots)``
    returns the slots still off).  Returns the max abs error over blend,
    T_final and slots."""
    (blend, t_fin, mlist, n_eval), (blend_w, t_w, mlist_w, n_eval_w) = got, want

    def beyond(g, w, atol):
        return (g - w).abs() > atol + 1e-4 * w.abs()

    uv_off = beyond(mlist[..., 1:], mlist_w[..., 1:], 1e-5).any(-1)
    if exact_uv is not None and bool(uv_off.any()):
        uv_off = exact_uv(got, want, uv_off)
    off = (beyond(blend, blend_w, 1e-5).any(-1) | beyond(t_fin, t_w, 1e-6)
           | beyond(mlist[..., 0], mlist_w[..., 0], 1e-5).any(-1)
           | uv_off.any(-1) | (n_eval != n_eval_w))
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


# unit roundoff of float32
F32_U = 2.0 ** -24


def intersect_error_bound(torch, d, rows, d_err):
    """A bound on the error of any float32 evaluation of
    uvtex_raster.intersect_uv's unit uv, for float64 rays d (k, 3), uv rows
    (k, >= 21) and the absolute error d_err (k, 3) of each ray component
    as float32 forms it: every product and sum rounds once (unit roundoff
    U), in any order, with or without fused multiply-adds; first order in
    U, and infinite where the intersection's denominator is 0.  Where t*
    lies beyond the clamp to [0, T_STAR_MAX] by more than its own error
    bound, every evaluation clamps it to the same end, and its error drops
    out.  For a flat Gaussian (the inverse covariance of the uv row reaches
    1e15 on a trained model) numerator and denominator are sums of terms
    far larger than themselves, and base_uv and t* J d nearly cancel, so
    the unit uv of a float32 evaluation may be 1e-3 to 1 off."""
    from texgs_torch.kernels.uvtex_raster import T_STAR_MAX

    U = F32_U
    r = rows
    d_abs, e = d.abs(), d_err
    num = (d * r[:, 0:3]).sum(-1)
    e_num = (3 * U * (d_abs * r[:, 0:3].abs()).sum(-1)
             + (e * r[:, 0:3].abs()).sum(-1))
    # den = d^T S d
    sym = torch.stack([r[:, [3, 4, 5]], r[:, [4, 6, 7]], r[:, [5, 7, 8]]], 1)
    den = (d * (sym * d[:, None, :]).sum(-1)).sum(-1)
    s_abs = (sym.abs() * d_abs[:, None, :]).sum(-1)
    e_den = 8 * U * (d_abs * s_abs).sum(-1) + 2 * (s_abs * e).sum(-1)
    t_raw = num / den
    e_t = (e_num + t_raw.abs() * e_den) / den.abs() + t_raw.abs() * U
    clamped = (t_raw - e_t > T_STAR_MAX) | (t_raw + e_t < 0)
    e_t = torch.where(clamped, torch.zeros_like(e_t), e_t)
    t = t_raw.clamp(0.0, T_STAR_MAX)[:, None]
    jac = r[:, 12:21].reshape(-1, 3, 3)
    jd = (jac * d[:, None, :]).sum(-1)
    e_jd = (3 * U * (jac.abs() * d_abs[:, None, :]).sum(-1)
            + (jac.abs() * e[:, None, :]).sum(-1))
    u = r[:, 9:12] + t * jd
    e_u = (2 * U * (r[:, 9:12].abs() + (t * jd).abs())
           + jd.abs() * e_t[:, None] + t * e_jd)
    return 2 * e_u.norm(dim=-1) / u.norm(dim=-1) + 4 * U


# the exact-uv route of check_kernel_a: at most this many slots, on at
# most this many Gaussians, may go through it (the full pipeline's last
# stage-3 step sent 1,563 slots on 69 Gaussians, the quick one's 191-312
# on 33-53); a float32 bound from EXACT_UV_VACUOUS on says nothing of a
# unit uv, and at most EXACT_UV_MAX_VACUOUS slots may have one (10 of 191
# on the quick pipeline's last step, before the bound knew the clamp)
EXACT_UV_MAX_SLOTS = 2000
EXACT_UV_MAX_GAUSSIANS = 100
EXACT_UV_VACUOUS = 0.5
EXACT_UV_MAX_VACUOUS = 100


def exact_uv_check(torch, a_args):
    """An ``exact_uv`` for check_kernel_a on kernel A's arguments
    `a_args`: each slot whose uv differs between kernel A and the plain
    version is traced to its Gaussian (the one of its tile whose plain
    intersect_uv is nearest the plain slot's), its unit uv evaluated in
    float64 and bounded by ``intersect_error_bound``.  A slot stays off
    where the kernel's uv lies beyond atol 1e-5 + rtol 1e-4 + that bound of
    the exact value; the plain version's uv must lie within it (else the
    bound is no bound, and the check fails).  A bound of EXACT_UV_VACUOUS
    or more holds nothing, so at most EXACT_UV_MAX_VACUOUS slots may have
    one; every routed kernel uv must be a unit vector (within 1e-3), every
    bound finite, and the route may take at most EXACT_UV_MAX_SLOTS slots
    on EXACT_UV_MAX_GAUSSIANS Gaussians."""
    from texgs_torch.kernels.tile_raster import TILE
    from texgs_torch.kernels.uvtex_fused import _tile_rays
    from texgs_torch.kernels.uvtex_raster import intersect_uv

    table, uv_rows, pairs, rays, gx, m = a_args[:6]
    device = table.device
    n_tiles = pairs.tile_counts.numel()
    rays64 = np.asarray(rays, np.float64)

    def exact_uv(got, want, slots):
        mlist, mlist_w = got[2], want[2]
        _, _, d32 = _tile_rays(rays, n_tiles, gx, device)
        _, _, d64 = _tile_rays(rays64, n_tiles, gx, device)
        ti, pi, si = torch.nonzero(slots, as_tuple=True)
        gauss = []
        for t, p, s in zip(ti.tolist(), pi.tolist(), si.tolist()):
            g = pairs.pair_gauss[int(pairs.tile_start[t]):
                                 int(pairs.tile_end[t])].long()
            dist = (intersect_uv(d32[t, p], uv_rows[g])
                    - mlist_w[t, p, s, 1:]).abs().max(-1).values
            gauss.append(g[torch.argmin(dist)])
        rows = uv_rows[torch.stack(gauss)].double()
        d = d64[ti, pi]
        # the pixel's coordinates, and the error of its ray in float32
        px = ((ti % gx) * TILE + pi % TILE).double()[:, None]
        py = ((ti // gx) * TILE + pi // TILE).double()[:, None]
        r = torch.as_tensor(rays64, device=device)
        d_err = 4 * F32_U * (r[2].abs() + (px * r[0]).abs()
                             + (py * r[1]).abs())
        exact = intersect_uv(d, rows)
        f32 = intersect_error_bound(torch, d, rows, d_err)
        tol = 1e-5 + 1e-4 * exact.abs() + f32[:, None]
        err_k = (mlist[ti, pi, si, 1:].double() - exact).abs()
        err_p = (mlist_w[ti, pi, si, 1:].double() - exact).abs()
        still = (err_k > tol).any(-1)
        n_gauss = len(set(int(g) for g in gauss))
        vacuous = f32 >= EXACT_UV_VACUOUS
        mean_k = err_k.max(-1).values[vacuous].mean().item()
        mean_p = err_p.max(-1).values[vacuous].mean().item()
        unit_err = (mlist[ti, pi, si, 1:].double().norm(dim=-1) - 1).abs()
        log(f"  A: {len(gauss)} slots' uv beyond the plain version's, on "
            f"{n_gauss} Gaussians, held against the exact uv (float64): "
            f"kernel max abs err {err_k.max().item():.3e}, plain "
            f"{err_p.max().item():.3e}; float32 bound median "
            f"{f32.median().item():.3e}, max {f32.max().item():.3e}; "
            f"{int(still.sum())} slots of the kernel and "
            f"{int((err_p > tol).any(-1).sum())} of the plain version "
            f"beyond it; {int(vacuous.sum())} slots' bound >= "
            f"{EXACT_UV_VACUOUS:g}, where the mean error is kernel "
            f"{mean_k:.3e}, plain {mean_p:.3e}; kernel uv norms within "
            f"{unit_err.max().item():.3e} of 1")
        if len(gauss) > EXACT_UV_MAX_SLOTS or n_gauss > EXACT_UV_MAX_GAUSSIANS:
            fail(f"the exact-uv route took {len(gauss)} slots on {n_gauss} "
                 f"Gaussians (at most {EXACT_UV_MAX_SLOTS} on "
                 f"{EXACT_UV_MAX_GAUSSIANS})")
        if not bool(torch.isfinite(f32).all()):
            fail("the float32 bound of the uv intersection is not finite")
        if bool((err_p > tol).any()):
            fail("the float32 bound of the uv intersection does not hold "
                 "for the plain version")
        if int(vacuous.sum()) > EXACT_UV_MAX_VACUOUS:
            fail(f"{int(vacuous.sum())} slots' float32 bound is "
                 f">= {EXACT_UV_VACUOUS:g} (at most {EXACT_UV_MAX_VACUOUS})")
        if not bool((unit_err <= 1e-3).all()):
            fail("kernel A's uv is not a unit vector")
        out = torch.zeros_like(slots)
        out[ti[still], pi[still], si[still]] = True
        return out
    return exact_uv


def exact_uv_control(torch, got, want, exact_uv, n=40, angle=0.02):
    """check_kernel_a with `exact_uv` must refuse kernel A's output `got`
    with the first slot's uv of `n` pixels (spread over the frame, where
    kernel and plain version agree) turned by `angle` radians: a unit uv
    still, off by about 0.01 or more in a component.  Fails if it is
    taken."""
    blend, t_fin, mlist, n_eval = got
    ml, ml_w = mlist[..., 0, :], want[2][..., 0, :]
    agree = (ml[..., 0] != 0) & ((ml - ml_w).abs() <= 1e-6).all(-1)
    where = torch.nonzero(agree)
    if where.shape[0] < n:
        fail(f"only {where.shape[0]} slots for the exact-uv control")
    where = where[torch.linspace(0, where.shape[0] - 1, n,
                                 device=where.device).long()]
    t, p = where[:, 0], where[:, 1]
    uv = mlist[t, p, 0, 1:]
    axis = torch.zeros_like(uv)
    axis[torch.arange(n, device=uv.device), uv.abs().argmin(-1)] = 1
    side = torch.linalg.cross(uv, axis)
    side = side / side.norm(dim=-1, keepdim=True)
    bad = mlist.clone()
    bad[t, p, 0, 1:] = uv * math.cos(angle) + side * math.sin(angle)
    try:
        check_kernel_a(torch, (blend, t_fin, bad, n_eval), want, exact_uv)
    except SystemExit as e:
        if "kernel A disagrees" not in str(e):
            raise
        log(f"  A: the exact-uv route refused {n} slots' uv turned by "
            f"{angle:g} rad, as it must")
        return
    fail(f"the exact-uv route took {n} slots' uv turned by {angle:g} rad")


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
def recording(module, name, seen, clone=False, when=None):
    """module.name records its positional arguments (tensors detached from
    any graph, and copied with `clone`, for a parameter that a later step
    updates in place) in seen[name] and calls through, inside the block,
    which gets the recorder; with `when`, only on calls where when() is
    true.  A kernel wrapper counts its launches through its module's global
    name, so while the recorder is swapped in for a kernel wrapper, the
    recorder's `launches` counts that kernel's launches."""
    fn = getattr(module, name)

    def wrapper(*args):
        if when is None or when():
            seen[name] = tuple((a.detach().clone() if clone else a.detach())
                               if hasattr(a, "detach") else a for a in args)
        return fn(*args)
    wrapper.launches = 0
    with swapped(module, name, wrapper):
        yield wrapper


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def bound(n_bytes, n_ops):
    """(bound ms, what bounds it) on the H100 SXM's data-sheet rates (the
    peaks of texgs_torch/tools/roofline.py)."""
    from texgs_torch.tools.roofline import H100_BYTES_PER_S, H100_F32_FLOPS

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
    PyTorch version (verify_compiled's twin)."""
    from texgs_torch.tools.verify_compiled import plain_kernels

    with plain_kernels():
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


def live_count_mlist(n_tiles, m, device, torch, seed=7):
    """edge_corner_mlist's M-lists whose pixels hold 0, 1, 31 or m live
    slots (capped at m; drawn per pixel), a prefix of each list as kernels
    A and 2 write them.  Returns (M-lists, the (n_tiles, 256, m) bool live
    mask)."""
    ml = edge_corner_mlist(n_tiles, m, device, torch, seed)
    rng = np.random.default_rng(seed + 100)
    counts = np.minimum(np.array([0, 1, 31, m])[
        rng.integers(0, 4, size=(n_tiles, 256, 1))], m)
    live = torch.as_tensor(np.arange(m) < counts, device=device)
    w = torch.as_tensor(rng.uniform(0.01, 0.2, size=(n_tiles, 256, m)),
                        dtype=torch.float32, device=device)
    ml[..., 0] = torch.where(live, w, 0.0)
    return ml, live


def check_dead_nan(torch, name, ml, live, got, call):
    """Kernel B on `ml` with NaN in every dead slot's uv must give `got`,
    its output on `ml`, bit for bit: a dead slot is selected away."""
    nan = ml.clone()
    nan[..., 1:][~live] = float("nan")
    again = call(nan)
    same = bool(torch.isfinite(again).all()) and torch.equal(again, got)
    log(f"  {name}, NaN in the uv of all {int((~live).sum())} dead slots: "
        f"finite and bit for bit the clean output: {same}")
    if not same:
        fail(f"{name}: a dead slot's uv reached kernel B's sum")


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
    profile_device) and the counts are the mean over the calls, rounded.
    The device-side copies of the program's ``texgs::`` spans, which the
    profiler lists beside the device events, are no operations and are
    left out."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from texgs_torch.utils.spans import PREFIX

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
           if e.device_type == DeviceType.CUDA and "spin_kernel" not in e.key
           and not e.key.startswith(PREFIX)}
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


def check_a_prime(torch, a_args, label="A'"):
    """Kernel A' against its plain version on the arguments a step's
    backward handed it, on the tiles where the plain backward fits in the
    card's memory (``plain_backward_tiles``).  Returns (max abs err, the
    tiles kept, the restricted arguments, their cotangents)."""
    from texgs_torch.kernels import uvtex_fused as kf

    table, uv_rows, pairs, rays, gx, m = a_args[:6]
    keep, note = plain_backward_tiles(torch, pairs, table.device, kf.CHUNK)
    a_sub = (table, uv_rows, restricted_tiles(pairs, keep), rays, gx, m)
    cots = [torch.where(keep.view(-1, *[1] * (c.dim() - 1)), c, 0.0).contiguous()
            for c in a_args[9:]]
    log(f"  {label} is checked on {note}")
    with torch.no_grad():
        fwd_sub = kf.fused_pairs_forward(*a_sub)
        got_a = kf.fused_pairs_backward(*a_sub, *fwd_sub[:3], *cots)
        torch.cuda.reset_peak_memory_stats()
        want_a = kf.mlist_scan_vjp(*a_sub, *cots)
        torch.cuda.synchronize()
        log(f"  {label} plain backward peak memory "
            f"{torch.cuda.max_memory_allocated() / 1e9:.1f} GB")
        err_a = check_a_backward(torch, got_a, want_a, label)
    return err_a, keep, a_sub, cots


def check_b_prime(torch, b_args, label="B'"):
    """Kernel B' against its plain version on the arguments a step's
    backward handed it.  Returns (max abs err, the plain call's ms, the
    live slots)."""
    from texgs_torch.kernels import tex_term as kt

    mlist = b_args[0]
    with torch.no_grad():
        got_b = kt.tex_term_backward(*b_args)
        # the plain VJP takes seconds at this shape: this one call is timed
        want_b, b_plain_ms = timed_once(
            torch, lambda: kt.mlist_tex_term_vjp(*b_args))
        # the loss is a mean over the frame, so these gradients are small:
        # each output is held at 1e-4 of its own max |plain|
        live = mlist[..., 0] != 0
        got_live, want_live = got_b[0][live], want_b[0][live]
        err_b = max(
            check_scaled(torch, f"{label} d texture", got_b[1], want_b[1],
                         1e-4, 1e-3),
            check_scaled(torch, f"{label} d w (live slots)", got_live[:, 0],
                         want_live[:, 0], 1e-4, 1e-3),
            check_scaled(torch, f"{label} d uv (live slots)", got_live[:, 1:],
                         want_live[:, 1:], 1e-4, 1e-3))
        if got_b[0][~live][:, 1:].any():
            fail(f"kernel {label} wrote a uv cotangent into a dead slot")
    return err_b, b_plain_ms, live


def restricted_tiles(pairs, keep):
    """The pair list with the tiles outside `keep` (a bool mask) emptied."""
    import torch

    return pairs._replace(
        tile_end=torch.where(keep, pairs.tile_end, pairs.tile_start),
        tile_counts=torch.where(keep, pairs.tile_counts, 0))


def plain_backward_tiles(torch, pairs, device, chunk):
    """The tiles on which a plain M-list backward (autograd through
    uvtex_fused.mlist_scan, about 24 (tiles, 256, chunk) f32 intermediates
    per chunk) fits in the card's free memory: all, every fourth, or
    sparser.
    Returns (bool mask over tiles, the note to log)."""
    n_tiles = pairs.tile_counts.numel()
    n_chunks = -(-int(pairs.tile_counts.max()) // chunk)
    need = n_chunks * 24 * n_tiles * 256 * chunk * 4
    free = torch.cuda.mem_get_info()[0]
    stride = 1
    if need > 0.8 * free:
        # every fourth tile, or sparser where that would not fit: on a
        # trained model's step (1.17 M pairs) every fourth tile peaked at
        # 1.66 times the estimate
        stride = max(4, math.ceil(2 * need / (0.8 * free)))
    keep = torch.arange(n_tiles, device=device) % stride == 0
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
        # a query count that is no multiple of 4 takes the scalar path
        idx_odd = idx_w[:, :n - n % 4 - 3].contiguous()
        err_k = max(err_k, check_close(
            torch, f"K5 hash gather (the first {idx_odd.shape[1]} queries)",
            kh.hash_gather(table, idx_odd), kh.gather_plain(table, idx_odd),
            atol=0.0))

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
    device launches, phase 7's launch counts by kernel)."""
    from texgs_torch.kernels import project as pj
    from texgs_torch.kernels import tex_term as kt
    from texgs_torch.kernels import uvtex_fused as kf
    from texgs_torch.kernels import uvtex_raster as kg
    from texgs_torch.kernels.cubemap import sample_cubemap
    from texgs_torch.nets import hash_encode as ke
    from texgs_torch.train import optim

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
                "tex_term_bwd": kt.tex_term_backward, **hash_counters(),
                "project": pj.project_gaussians,
                "project_bwd": pj.project_gaussians_backward,
                "uvtex_rows": kg.uvtex_rows,
                "uvtex_rows_bwd": kg.uvtex_rows_backward,
                "adam": optim.adam_step}
    a_step = {"hash_gather": 0, "adam": 3}   # else once a step
    launches = check_train_run(
        torch, "train", model, step, counters,
        {name: a_step.get(name, 1) * STEPS for name in counters})

    # --------------------------------------------------- 8. train kernels
    a_args = seen["fused_pairs_backward"]
    b_args = seen["tex_term_backward"]
    table, uv_rows, pairs, rays, gx, m = a_args[:6]
    g_blend, g_t_final, g_mlist = a_args[9:]
    mlist, texture, g_img, height, width = b_args[:5]
    log("[train kernels] each against its plain version, on the arguments "
        f"the step-{FIRST_ITER} backward gave it")
    n_tiles = pairs.tile_counts.numel()
    err_a, keep, a_sub, cots = check_a_prime(torch, a_args)
    err_b, b_plain_ms, live = check_b_prime(torch, b_args)

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
    ], step_ms, step_launches, launches


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


def check_tile_orders(torch, table, pairs, gx, got):
    """Kernel 1 with its tiles heaviest first and in launch order must give
    `got`, its output on `pairs`, bit for bit."""
    from texgs_torch.kernels import binning
    from texgs_torch.kernels import raster as kr

    n_tiles = pairs.tile_counts.numel()
    for name, order in (
            ("heaviest first", binning.with_tile_order(pairs).tile_order),
            ("launch order", torch.arange(n_tiles, device=table.device))):
        out = kr.raster_pairs_forward(table, pairs._replace(tile_order=order),
                                      gx)
        same = [torch.equal(x, y) for x, y in zip(out, got)]
        log(f"  1 with its tiles {name}: blend, T_final, n_eval bit for bit: "
            f"{same}")
        if not all(same):
            fail("kernel 1's outputs depend on the order it takes the tiles "
                 "in")


def check_1_prime(torch, b_args, label="1'"):
    """Kernel 1' against its plain version on the arguments a step's
    backward handed it (F = 7), on a prefix of whole tile rows where the
    plain backward would not fit in the card's memory.  Returns (max abs
    err, the restricted pair list, its cotangents, its tile count)."""
    from texgs_torch.kernels import raster as kr

    table, pairs, gx = b_args[:3]
    g_blend, g_t_final = b_args[5:]
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
        f"{int(pairs.tile_counts.max())} a tile); {label} is checked on the "
        f"first {t_sub} tiles (plain backward needs about {need / 1e9:.1f} GB "
        f"for all, {free / 1e9:.1f} GB free)")
    with torch.no_grad():
        fwd_sub = kr.raster_pairs_forward(table, sub, gx)
        got_1b = kr.raster_pairs_backward(table, sub, gx, *fwd_sub[:2], *cots)
        torch.cuda.reset_peak_memory_stats()
        want_1b = kr.raster_scan_vjp(table, sub, gx, *cots)
        torch.cuda.synchronize()
        log(f"  {label} plain backward peak memory "
            f"{torch.cuda.max_memory_allocated() / 1e9:.1f} GB")
        err_1b = max(check_scaled(torch, f"{label} {name}", got_1b[:, cols],
                                  want_1b[:, cols], 1e-3, 1e-3,
                                  MAX_OFF_GAUSSIANS, rows=True)
                     for name, cols in (("quad", slice(0, 6)),
                                        ("channels", slice(7, 14))))
        if got_1b[:, [6, 14, 15]].any():
            fail(f"kernel {label} wrote gradient into a column it must leave "
                 "at zero")
    return err_1b, sub, cots, t_sub


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
    with torch.no_grad():
        got_1 = kr.raster_pairs_forward(table, pairs, gx)
        want_1 = kr.raster_scan(table, pairs, gx)
        err_1 = check_kernel_1(torch, got_1, want_1)
        if pairs.tile_order is None:
            fail("the stage-1 step handed kernel 1 a pair list without its "
                 "tile order")
        check_tile_orders(torch, table, pairs, gx, got_1)
    err_1b, sub, cots, t_sub = check_1_prime(torch, b_args)

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

    def cut(config, run_name, n_iter, **edits):
        cfg = load_config(config)
        cfg.train_cfg.update(num_iterations=n_iter, visual_iters=[n_iter],
                             ckpt_iters=[n_iter])
        for section, values in edits.items():
            cfg[section].update(values)
        path = f"{work_dir}/{run_name}.yaml"
        dump_config(cfg, path)
        return path

    def run(config, run_name, n_iter, flags=(), **edits):
        path = cut(config, run_name, n_iter, **edits)
        t0 = time.perf_counter()
        _, _, ev = train_main([path, "--workspace", work_dir, "--run_name",
                               run_name, "--device", str(device), *flags])
        log(f"[driver] {run_name} ({config}): {n_iter} iterations in "
            f"{time.perf_counter() - t0:.1f} s, test PSNR "
            f"{ev['test']['psnr']:.2f} dB, train PSNR "
            f"{ev['train']['psnr']:.2f} dB")
        ck = sorted(glob.glob(f"{work_dir}/{run_name}/*/checkpoints/"
                              f"{n_iter}.npz"))[-1]
        return ev["test"]["psnr"], ck[:-len(".npz")]

    # cut to DRIVER_S1_ITERS iterations, densifying at 100, traced over
    # iterations 100-110
    trace_dir = f"{work_dir}/s1_trace"
    psnr1, ck1 = run("configs/synthetic_smoke.yaml", "s1", DRIVER_S1_ITERS,
                     flags=("--profile_dir", trace_dir),
                     train_cfg={"densify_from_iter": 50},
                     optim_cfg={"position_lr_max_steps": DRIVER_S1_ITERS})
    if not math.isfinite(psnr1):
        fail(f"the driver's stage-1 test PSNR is {psnr1}")
    check_trace(trace_dir)
    extract_pcd(ck1, f"{work_dir}/s1_pcd", 4096, device=device)
    psnr2, _ = run("configs/synthetic_uv_map.yaml", "s2", DRIVER_S2_ITERS,
                   model_cfg={"init_from": ck1,
                              "pcd_load_from": f"{work_dir}/s1_pcd.npy"})

    # a debug run under autograd's anomaly mode: a backward that made NaN
    # would raise
    path = cut("configs/synthetic_smoke.yaml", "s1_nans", DRIVER_NAN_ITERS)
    t0 = time.perf_counter()
    _, _, ev = train_main([path, "--debug", "--debug_nans", "--device",
                           str(device)])
    psnr_nans = ev["test"]["psnr"]
    log(f"[driver] --debug --debug_nans: {DRIVER_NAN_ITERS} stage-1 "
        f"iterations in {time.perf_counter() - t0:.1f} s, test PSNR "
        f"{psnr_nans:.2f} dB")
    if not math.isfinite(psnr_nans):
        fail(f"the --debug_nans run's test PSNR is {psnr_nans}")
    return psnr1, psnr2


def check_trace(trace_dir):
    """The driver's trace of iterations 100-110 must exist and hold device
    events of kernels 1 and 1' (their CUDA functions raster_fwd and
    raster_bwd).  The names are asked for, not counts: the profiler drops
    an event now and then."""
    import glob
    import os

    files = glob.glob(f"{trace_dir}/*.json")
    if len(files) != 1:
        fail(f"the driver's --profile_dir holds {files}")
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
    found = {name: sum(name in k for k in kernels)
             for name in ("raster_fwd<", "raster_bwd<")}
    log(f"[driver] profiler trace {os.path.basename(files[0])}: "
        f"{os.path.getsize(files[0]) / 1e6:.1f} MB, {len(events)} events, "
        f"{len(kernels)} device kernels; kernel 1 (raster_fwd) "
        f"{found['raster_fwd<']}, kernel 1' (raster_bwd) "
        f"{found['raster_bwd<']}")
    if not all(found.values()):
        fail("the driver's profiler trace holds no device event of kernel "
             f"1 or 1': {found}")


GOLDEN = "tests/goldens/pipeline_3stage.json"
# tests/test_pipeline_3stage.py's scene (:52-58), written by the port
GOLDEN_SCENE = ["--n", "512", "--views", "6", "--test_views", "2",
                "--size", "48", "--init_ply"]
# stage 3's M-list length.  texgs recorded the golden on the CPU, where its
# `auto` backend renders stage 3 with the dense oracle (N <= 4096), whose
# texture term no M-list cuts: kernel A computes that term when m exceeds
# every pixel's contributor count (at most 111 at the end of this stage's
# CPU rehearsals), and the phase checks it against the port's oracle.  The
# test's m = 16 (which texgs's oracle ignores) cuts the term where a pixel
# has more contributors: texgs's own M-list path at m = 16 (its scan twin)
# reached 19.763 dB against its oracle's 20.652 on one scene (PERF.md).
GOLDEN_M = 256
# tests/test_pipeline_{colmap,neilf}.py's scenes
FORMAT_SCENE = ["--n", "512", "--views", "16", "--test_views", "0",
                "--size", "48", "--spiral"]
# scripts/run_prod_pipeline.py:115-118, the data of configs/prod_stage1.yaml
PROD_SCENE = ["--kind", "checker", "--spiral", "--backend", "scan",
              "--n", "50000", "--views", "64", "--test_views", "8",
              "--width", "800", "--height", "600", "--init_ply"]
PROD_ITERS = 20


def seeded(torch, seed):
    """The seeds of the port's command line (train/__main__.py)."""
    import random

    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


def stage_cfg(config, work_dir, data_root, iters, seed=0, **sections):
    """A config of configs/ cut as the tests cut it: `iters` iterations,
    one evaluation and one checkpoint at the end, the data on disk at
    `data_root`, `sections` merged into its sections.  A stage's model
    seed is its default plus 100 `seed`."""
    import os

    from texgs_torch.config import load_config

    cfg = load_config(config)
    cfg.work_dir = work_dir
    os.makedirs(f"{work_dir}/checkpoints", exist_ok=True)
    cfg.debug = False
    cfg.dataset_cfg.data_root_dir = data_root
    cfg.train_cfg.update(num_iterations=iters, visual_iters=[iters],
                         ckpt_iters=[iters])
    for section, values in sections.items():
        for key, value in values.items():    # "a.b.c": a nested key
            *parents, leaf = key.split(".")
            target = cfg[section]
            for part in parents:
                target = target[part]
            target[leaf] = value
    default = {"Gaussian3D": 0, "UVMapGaussian3D": 1,
               "TextureGaussian3D": 2}[cfg.model_cfg.type]
    cfg.model_cfg.seed = default + 100 * seed
    return cfg


def counted_train(torch, cfg, counters, device, scene=None):
    """driver.train with the kernels of `counters` counted from 0.
    Returns (model, scene, evaluation, seconds, launches)."""
    from texgs_torch.train import driver
    from texgs_torch.utils.logger import get_logger

    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    model, scene, ev = driver.train(cfg, get_logger("texgs_torch.smoke"),
                                    scene=scene, progress=False,
                                    device=device)
    if device.type == "cuda":
        torch.cuda.synchronize()
    return (model, scene, ev, time.perf_counter() - t0,
            {name: fn.launches for name, fn in counters.items()})


def check_launches(what, launches, at_least):
    """Every kernel of `at_least` launched at least that often."""
    for name, n in at_least.items():
        if launches[name] < n:
            fail(f"{what}: kernel {name} launched {launches[name]} times, "
                 f"expected at least {n} (once a step)")


def golden_phase(torch, device, work_dir, seed=0, m=GOLDEN_M):
    """Phase 19 (see the module docstring): tests/test_pipeline_3stage.py
    on the port, from files its writer made, gated on
    tests/goldens/pipeline_3stage.json.  Returns each stage's
    (test PSNR, test SSIM, seconds), the untrained baseline's, and the
    gates it missed ("missed")."""
    from texgs_torch.kernels import raster as kr
    from texgs_torch.kernels import tex_term as kt
    from texgs_torch.kernels import uvtex_fused as kf
    from texgs_torch.tools import make_dataset
    from texgs_torch.tools.extract_pcd import extract_pcd
    from texgs_torch.train import driver
    from texgs_torch.train.models import create_model
    from texgs_torch.data.synthetic import orbit_cameras
    from texgs_torch.utils.logger import get_logger

    with open(GOLDEN) as f:
        golden = json.load(f)
    root = f"{work_dir}/golden_{seed}"
    t0 = time.perf_counter()
    make_dataset.main([f"{root}/scene", *GOLDEN_SCENE, "--device",
                       device.type])
    write_s = time.perf_counter() - t0
    seeded(torch, seed)
    ranges = {k: [0, None] for k in ("norm_range", "norm_smooth_range",
                                     "opacity_reg_range")}
    cfg1 = stage_cfg("configs/synthetic_smoke.yaml", f"{root}/s1",
                     f"{root}/scene", 150, seed,
                     train_cfg={"densify_from_iter": 20,
                                "densification_interval": 50,
                                "densify_until_iter": 120},
                     loss_cfg=ranges)
    _, scene, ev1, s1_s, l1 = counted_train(
        torch, cfg1, {"raster": kr.raster_pairs,
                      "raster_bwd": kr.raster_pairs_backward}, device)
    check_launches("golden stage 1", l1, {"raster": 150, "raster_bwd": 150})
    ck1 = f"{root}/s1/checkpoints/150"
    extract_pcd(ck1, f"{root}/pcd", 512, device=device)

    net = {"max_inverse_points": 2048,
           "inv_uv_net_cfg.n_sample_points": 256,
           "inv_uv_net_cfg.pre_mlp_cfg.hash_grid_cfg.n_levels": 4}
    cfg2 = stage_cfg("configs/synthetic_uv_map.yaml", f"{root}/s2",
                     f"{root}/scene", 120, seed,
                     model_cfg=dict(net, init_from=ck1,
                                    pcd_load_from=f"{root}/pcd.npy"))
    model2, _, ev2, s2_s, l2 = counted_train(
        torch, cfg2, {"raster": kr.raster_pairs, **hash_counters()}, device,
        scene)
    check_launches("golden stage 2", l2, {"raster": 1, "hash_encode": 120,
                                          "hash_encode_bwd": 120})
    # the UV map: on the unit sphere, and the inverse cycle in range
    # (tests/test_pipeline_3stage.py:119-137)
    with torch.no_grad():
        xyz = model2.gauss["xyz"]
        uv = model2.uv_net(xyz, model2.geo_emb)
        norm_err = (torch.linalg.norm(uv, dim=1) - 1).abs().max().item()
        cycle = torch.linalg.norm(xyz - model2.inv_uv_net(
            uv, model2.geo_emb), dim=1).mean().item()
        chess = model2.visual_step(0, 0, orbit_cameras(
            1, radius=3.5, width=48, height=48)[0])["chess_image"]
    if not norm_err <= 1e-4:
        fail(f"golden stage 2: |uv| is 1 only to {norm_err:.2e}")
    if not cycle < 2.0:
        fail(f"golden stage 2: the inverse cycle error is {cycle}")
    # both chess colours on the surface (:140-158)
    chess = chess.cpu().numpy()
    fg = chess.max(axis=0) > 0.2
    rb = chess[0][fg] - chess[2][fg]
    if not (chess.shape == (3, 48, 48) and np.isfinite(chess).all()
            and fg.sum() > 50 and (rb > 0.1).any() and (rb < -0.1).any()):
        fail("golden stage 2: the chess image lacks a colour (UVs not "
             "mapped)")
    ck2 = f"{root}/s2/checkpoints/120"

    cfg3 = stage_cfg(
        "configs/synthetic_texture.yaml", f"{root}/s3", f"{root}/scene", 240,
        seed, train_cfg={"min_scale_reset_interval": 0},
        model_cfg=dict(net, init_from=ck1, init_uv_map_from=ck2,
                       **{"tex_cfg.resolution": 64, "tex_cfg.max_sh_degree": 1,
                          "uvtex_m": m}),
        optim_cfg={"gaussian_optim_range": [30, None], "tex_lr": 0.02},
        loss_cfg={k: [30, None] for k in ("rgb_no_sh_range", "alpha_range",
                                          "norm_smooth_range",
                                          "inverse_range")})
    # the untrained (zero-texture) baseline on the same scene (:201-209)
    glog = get_logger("texgs_torch.smoke")
    m0 = create_model(cfg3.model_cfg, device)
    m0.bind_train_cfg(cfg3.train_cfg, cfg3.dataset_cfg.background)
    m0.initialize(scene.scene_info.point_cloud, scene.cameras_extent)
    m0.setup_optim(cfg3.optim_cfg)
    ev0 = driver.visualize(None, 0, 60, m0, scene, glog)
    del m0
    stage3 = {"uvtex_fused": kf.fused_pairs,
              "uvtex_fused_bwd": kf.fused_pairs_backward,
              "tex_term": kt.tex_term, "tex_term_bwd": kt.tex_term_backward,
              **hash_counters()}
    model3, _, ev3, s3_s, l3 = counted_train(torch, cfg3, stage3, device,
                                             scene)
    # the inverse loss, which runs the hash grid, on iterations 31..240
    check_launches("golden stage 3", l3, {
        "uvtex_fused": 240, "uvtex_fused_bwd": 240, "tex_term": 240,
        "tex_term_bwd": 240, "hash_encode": 210, "hash_encode_bwd": 210})
    tex_max = model3.texture.abs().max().item()
    # the kernel path's test renders against the dense oracle's: equal
    # where no M-list was cut (tests/test_uvtex_raster.py's scan-vs-oracle
    # tolerance: 0.5% of the values beyond 1e-4, none beyond 3e-2)
    worst, n_off = 0.0, 0
    with torch.no_grad():
        for cam in scene.getTestCameras():
            got = model3.render(cam)["render"]
            model3.cfg["backend"] = "reference"
            want = model3.render(cam)["render"]
            model3.cfg["backend"] = "auto"
            err = (got - want).abs()
            worst = max(worst, err.max().item())
            n_off += int((err > 1e-4).sum()) - err.numel() // 200
    result = {"s1": (ev1["test"]["psnr"], ev1["test"]["ssim"], s1_s),
              "s2": (ev2["test"]["psnr"], ev2["test"]["ssim"], s2_s),
              "s3": (ev3["test"]["psnr"], ev3["test"]["ssim"], s3_s),
              "ev0": (ev0["test"]["psnr"], ev0["test"]["ssim"], 0.0)}
    log(f"[golden] seed {seed}, m = {m}: scene written in {write_s:.1f} s; "
        + "; ".join(f"{k} test PSNR {p:.3f} dB SSIM {q:.4f} ({t:.1f} s)"
                    for k, (p, q, t) in result.items())
        + f"; UV norm err {norm_err:.2e}, cycle {cycle:.4f}; stage-3 test "
        f"renders vs the oracle: max abs err {worst:.3e}; launches s1 {l1}, "
        f"s2 {l2}, s3 {l3}")
    s1, s3 = ev1["test"], ev3["test"]
    gates = [
        ("texture received a gradient", tex_max > 1e-3),
        ("s3 test PSNR finite and > 10 dB",
         math.isfinite(s3["psnr"]) and s3["psnr"] > 10.0),
        ("s3 >= ev0 + 2.0 dB", s3["psnr"] >= ev0["test"]["psnr"] + 2.0),
        (f"s1 >= {golden['stage1_test_psnr'] - golden['margin_db']:.3f} dB",
         s1["psnr"] >= golden["stage1_test_psnr"] - golden["margin_db"]),
        (f"s3 >= {golden['stage3_test_psnr'] - golden['margin_db']:.3f} dB",
         s3["psnr"] >= golden["stage3_test_psnr"] - golden["margin_db"]),
        (f"s3 SSIM >= "
         f"{golden['stage3_test_ssim'] - golden['margin_ssim']:.4f}",
         s3["ssim"] >= golden["stage3_test_ssim"] - golden["margin_ssim"]),
        (f"s3 >= s1 - {golden['rel_margin_db']} dB",
         s3["psnr"] >= s1["psnr"] - golden["rel_margin_db"]),
        ("stage-3 test renders equal the dense oracle's",
         worst <= 3e-2 and n_off <= 0),
    ]
    result["missed"] = [name for name, ok in gates if not ok]
    return result


def check_golden(seed, run):
    if run["missed"]:
        fail(f"the tiny 3-stage golden (seed {seed}) missed: "
             + "; ".join(run["missed"]) + f" ({run})")


def formats_phase(torch, device, work_dir):
    """Phase 20 (see the module docstring): stage 1 from a COLMAP and from
    a NeILF scene on disk (tests/test_pipeline_{colmap,neilf}.py).
    Returns each format's test PSNR and seconds."""
    from texgs_torch.data import colmap as cm
    from texgs_torch.data import native
    from texgs_torch.kernels import raster as kr
    from texgs_torch.tools import make_dataset

    if not native.available():
        fail("the native IO library was not built (no C++ compiler)")
    counters = {"raster": kr.raster_pairs,
                "raster_bwd": kr.raster_pairs_backward}
    densify = {"densify_from_iter": 20, "densification_interval": 50,
               "densify_until_iter": 120}
    # COLMAP scenes carry no alpha or normal: photometric only
    losses = {
        "colmap": {"lambda_alpha": 0.0, "lambda_norm": 0.0,
                   "lambda_norm_smooth": 0.0},
        "neilf": {k: [0, None] for k in ("norm_range", "norm_smooth_range",
                                         "opacity_reg_range")}}
    result = {}
    for fmt, name in (("colmap", "colmap_synth"), ("neilf", "dtu_synth")):
        root = f"{work_dir}/{fmt}"
        t0 = time.perf_counter()
        make_dataset.main([f"{root}/{name}", "--format", fmt, *FORMAT_SCENE,
                           "--device", device.type])
        write_s = time.perf_counter() - t0
        seeded(torch, 0)
        cfg = stage_cfg("configs/synthetic_smoke.yaml", f"{root}/s1",
                        f"{root}/{name}", 150, train_cfg=densify,
                        loss_cfg=losses[fmt])
        _, scene, ev, train_s, launches = counted_train(torch, cfg, counters,
                                                        device)
        check_launches(f"{fmt} stage 1", launches,
                       {"raster": 150, "raster_bwd": 150})
        train, test = scene.getTrainCameras(), scene.getTestCameras()
        # llffhold 8 over 16 COLMAP views; DTU's test indexes 6 and 13
        if (len(train), len(test)) != (14, 2):
            fail(f"{fmt}: {len(train)} train and {len(test)} test views")
        for cam in train + test:
            if tuple(cam.image.shape) != (3, 48, 48):
                fail(f"{fmt}: a ground truth of {tuple(cam.image.shape)}")
        if fmt == "neilf":
            cam = train[0]
            if cam.alpha_mask is None or cam.normal is None:
                fail("neilf: the masks or normals did not reach the cameras")
            # premultiplied: black where the mask is 0
            if cam.image[:, cam.alpha_mask[0] < 0.5].abs().max().item() != 0:
                fail("neilf: the ground truth is not masked")
        else:
            # the scene read through the native library equals the one the
            # Python parsers read
            sparse = f"{root}/{name}/sparse/0"
            for fast, slow in (
                    (native.read_images_binary(f"{sparse}/images.bin"),
                     cm.read_images_binary(f"{sparse}/images.bin")),
                    (native.read_cameras_binary(f"{sparse}/cameras.bin"),
                     cm.read_cameras_binary(f"{sparse}/cameras.bin"))):
                if fast is None or sorted(fast) != sorted(slow) or any(
                        not all(np.array_equal(a, b) for a, b in
                                zip(fast[k], slow[k])) for k in slow):
                    fail("colmap: the native reader disagrees with the "
                         "Python parser")
            nat = native.read_points3d_binary(f"{sparse}/points3D.bin")
            py = cm.read_points3d_binary(f"{sparse}/points3D.bin")
            if not all(np.array_equal(a, b) for a, b in zip(nat, py)):
                fail("colmap: the native points3D reader disagrees")
        psnr = ev["test"]["psnr"]
        log(f"[{fmt}] scene of 16 views written in {write_s:.1f} s; stage 1, "
            f"150 iterations in {train_s:.1f} s: test PSNR {psnr:.3f} dB, "
            f"SSIM {ev['test']['ssim']:.4f}; launches {launches}")
        if not (math.isfinite(psnr) and psnr > 15.0):
            fail(f"{fmt}: stage-1 test PSNR {psnr}")
        result[fmt] = (psnr, train_s)
    return result


def prod_scene_phase(torch, device, work_dir, card):
    """Phase 21 (see the module docstring): configs/prod_stage1.yaml's
    checker_prod scene written at full width, read back and trained.
    Returns the seconds of the write, the read and the iterations."""
    from texgs_torch.config import load_config
    from texgs_torch.data.scene import Scene
    from texgs_torch.kernels import raster as kr
    from texgs_torch.tools import make_dataset
    from texgs_torch.utils.logger import get_logger

    root = f"{work_dir}/checker_prod"
    args = make_dataset.parse_args([root, *PROD_SCENE, "--device",
                                    device.type])
    t0 = time.perf_counter()
    n_views = make_dataset.make_dataset(args)
    write_s = time.perf_counter() - t0
    cfg = load_config("configs/prod_stage1.yaml")
    cfg.dataset_cfg.data_root_dir = root
    seeded(torch, 0)
    t0 = time.perf_counter()
    scene = Scene(cfg.dataset_cfg, get_logger("texgs_torch.smoke"),
                  f"{work_dir}/prod_s1", device=device)
    if device.type == "cuda":
        torch.cuda.synchronize()
    read_s = time.perf_counter() - t0
    train, test = scene.getTrainCameras(), scene.getTestCameras()
    if (len(train), len(test)) != (args.views, args.test_views):
        fail(f"checker_prod: {len(train)} train and {len(test)} test views")
    # each ground truth read back against the writer's float render: the
    # writer truncates rgb and alpha to 8 bits (as texgs's script), so the
    # reader's composite rgb·a + bg·(1 - a), masked by alpha > 0.5, lies
    # within 2/255 of the float one
    cams, gt_view, _ = make_dataset.ground_truth(args)
    bg = torch.as_tensor(cfg.dataset_cfg.background, dtype=torch.float32,
                         device=device)[:, None, None]
    worst = 0.0
    for split, views, offset in (("train", train, 0),
                                 ("test", test, args.views)):
        for cam in views:
            if (cam.width, cam.height) != (args.width, args.height):
                fail(f"checker_prod: a {cam.width}x{cam.height} view")
            out = gt_view(cams[offset + int(cam.image_name.split("_")[1])])
            rgb = torch.as_tensor(out["rgb"], device=device).permute(2, 0, 1)
            a = torch.as_tensor(out["alpha"], device=device)[None]
            mask = (a > 0.5).float()
            if not torch.equal(cam.alpha_mask, mask):
                fail(f"checker_prod {split} {cam.image_name}: the mask "
                     "read back differs")
            want = (rgb * a + bg * (1 - a)) * mask
            worst = max(worst, (cam.image - want).abs().max().item())
    if not worst <= 2.0 / 255 + 1e-6:
        fail(f"checker_prod: a ground truth read back is {worst} off")
    bytes_gt = sum(sum(t.numel() * 4 for t in (c.image, c.alpha_mask,
                                               c.normal))
                   for c in train + test)

    cfg.work_dir = f"{work_dir}/prod_s1"
    cfg.debug = False
    cfg.train_cfg.update(num_iterations=PROD_ITERS,
                         visual_iters=[PROD_ITERS], ckpt_iters=[])
    counters = {"raster": kr.raster_pairs,
                "raster_bwd": kr.raster_pairs_backward}
    model, _, ev, train_s, launches = counted_train(torch, cfg, counters,
                                                    device, scene)
    check_launches("checker_prod stage 1", launches,
                   {"raster": PROD_ITERS, "raster_bwd": PROD_ITERS})
    psnr = ev["test"]["psnr"]
    if not math.isfinite(psnr):
        fail(f"checker_prod: stage-1 test PSNR {psnr}")
    log(f"[prod scene] checker_prod ({model.n_points} Gaussians, "
        f"{n_views} views of {args.width}x{args.height}): written in {write_s:.1f} s, read "
        f"back in {read_s:.1f} s ({bytes_gt / 1e9:.3f} GB of ground truth "
        f"on the device, worst pixel {worst * 255:.3f}/255 off the float "
        f"render), {PROD_ITERS} iterations of prod_stage1.yaml with the "
        f"evaluation in {train_s:.1f} s: test PSNR {psnr:.3f} dB; launches "
        f"{launches}; {card}")
    return write_s, read_s, train_s


# phase 24: texgs_torch.tools.prod_pipeline --quick (750 + 400 + 1,000
# iterations at 800x600) on phase 21's scene.  Its final stage-1 and
# stage-3 test PSNRs must reach the first card reading of that run less
# PIPELINE_MARGIN_DB (the tiny golden's margin): the first run of the
# --quick pipeline on the card, an NVIDIA H100 80GB HBM3 at 700 W
# (2026-10-17); a second run read 30.76 and 19.32 dB.
PIPELINE_FIRST_READING = {"stage1": 30.72, "texture": 18.73}
PIPELINE_MARGIN_DB = 1.5
# the keys of scripts/run_prod_pipeline.py's write_metrics, and of each of
# its evaluations
PIPELINE_KEYS = {"stage1", "uv_map", "texture", "stage3_minus_stage1_db"}
EVAL_KEYS = {"iter", "l1", "psnr", "ssim"}
# each stage's run name and config
PIPELINE_STAGES = {"prod_stage1": "configs/prod_stage1.yaml",
                   "prod_uv_map": "configs/prod_uv_map.yaml",
                   "prod_texture": "configs/prod_texture.yaml"}


def stage_evaluations(out, run):
    """Every '[ITER n] Evaluating <set>: ...' line of a stage's log, as
    {set: {iteration: (L1, PSNR, SSIM)}}."""
    from texgs_torch.tools.prod_pipeline import EVAL

    evals = {}
    with open(f"{out}/{run}/latest/TextureGS.log") as f:
        for line in f:
            mm = EVAL.search(line)
            if mm:
                evals.setdefault(mm.group(2), {})[int(mm.group(1))] = tuple(
                    float(mm.group(i)) for i in (3, 4, 5))
    return evals


def expected_pipeline_launches(out, run, n_train, n_test):
    """The launches each kernel must make in a stage of the pipeline, from
    the stage's runtime config: a step's, and the evaluations' (n_test
    test views and 5 train views each, and a point cloud)."""
    import os

    from texgs_torch.config import load_config

    name = os.path.basename(PIPELINE_STAGES[run])
    cfg = load_config(f"{out}/_run_cfgs/{name}")
    iters = int(cfg.train_cfg.num_iterations)
    evals = len(set(cfg.train_cfg.visual_iters))
    views = evals * (n_test + 5)
    zero = dict.fromkeys(("raster", "raster_bwd", "uvtex_mlist",
                          "uvtex_mlist_bwd", "uvtex_fused", "uvtex_fused_bwd",
                          "tex_term", "tex_term_bwd", "hash_encode",
                          "hash_encode_bwd", "hash_gather"), 0)
    if run == "prod_stage1":
        return iters, dict(zero, raster=iters + views, raster_bwd=iters)
    if run == "prod_uv_map":
        # kernel 1 once a camera (the render cache); the inverse net's
        # point cloud at each evaluation
        return iters, dict(zero, raster=n_train + n_test,
                           hash_encode=iters + evals, hash_encode_bwd=iters)
    # the inverse loss runs the hash grid on iterations (start, end]
    inverse = max(iters - int(cfg.loss_cfg.inverse_range[0]), 0)
    return iters, dict(zero, uvtex_fused=iters + views, uvtex_fused_bwd=iters,
                       tex_term=iters + views, tex_term_bwd=iters,
                       hash_encode=inverse, hash_encode_bwd=inverse)


def prod_pipeline_phase(torch, device, work_dir, card, full=False):
    """Phase 24 (see the module docstring), or with `full` the whole
    pipeline at its production schedules with the dataset written anew.
    Returns its record: the metrics file, each stage's seconds, peak
    device memory, launches and evaluations, and stage 3's pair counts."""
    import os

    from texgs_torch.kernels import raster as kr
    from texgs_torch.kernels import tex_term as kt
    from texgs_torch.kernels import uvtex_fused as kf
    from texgs_torch.kernels import uvtex_mlist as km
    from texgs_torch.tools import prod_pipeline as pp
    from texgs_torch.train.texture_gaussian3d import TextureGaussian3D

    out = f"{work_dir}/prod_pipeline"
    if not full:
        # phase 21 wrote checker_prod with the pipeline's own arguments
        if PROD_SCENE != pp.DATASET_ARGS:
            fail("phase 21's scene is not the pipeline's")
        os.makedirs(f"{out}/data")
        os.symlink(f"{work_dir}/checker_prod", f"{out}/data/checker_prod")

    # stage 3's pair count at every step, and the arguments of kernels A'
    # and B' on its last step (B''s texture is updated in place after it)
    pairs_at, last, seen = {}, [False], {}
    compute_loss = TextureGaussian3D.compute_loss

    def counted_loss(self, cur_iter, total_iter, *args):
        last[0] = cur_iter == total_iter
        try:
            loss, stats, extra = compute_loss(self, cur_iter, total_iter,
                                              *args)
        finally:
            last[0] = False
        pairs_at[cur_iter] = int(stats["n_pairs"])
        return loss, stats, extra

    records = {}
    run_stage = pp.run_stage
    with swapped(TextureGaussian3D, "compute_loss", counted_loss), \
            recording(kf, "fused_pairs_backward", seen, clone=True,
                      when=lambda: last[0]) as rec_a, \
            recording(kt, "tex_term_backward", seen, clone=True,
                      when=lambda: last[0]) as rec_b:
        counters = {"raster": kr.raster_pairs,
                    "raster_bwd": kr.raster_pairs_backward,
                    "uvtex_mlist": km.mlist_pairs,
                    "uvtex_mlist_bwd": km.mlist_pairs_backward,
                    "uvtex_fused": kf.fused_pairs, "uvtex_fused_bwd": rec_a,
                    "tex_term": kt.tex_term, "tex_term_bwd": rec_b,
                    **hash_counters()}

        def counted_stage(name, fn, argv, dev):
            for c in counters.values():
                c.launches = 0
            record = run_stage(name, fn, argv, dev)
            record["launches"] = {k: c.launches for k, c in counters.items()}
            records[name] = record
            return record

        argv = ["--workspace", out, "--device", device.type]
        with swapped(pp, "run_stage", counted_stage):
            result = pp.main(argv if full else ["--quick", *argv])
    if set(seen) != {"fused_pairs_backward", "tex_term_backward"}:
        fail(f"the pipeline's last stage-3 step called {sorted(seen)}")

    metrics = result["metrics"]
    key = "full" if full else f"quick_div{pp.QUICK_DIV}"
    with open(f"{out}/pipeline_prod_metrics.json") as f:
        written = json.load(f)
    entry = written.get(key, {})
    if written != metrics or set(entry) != PIPELINE_KEYS:
        fail(f"pipeline_prod_metrics.json holds {written}, not texgs's keys")
    for stage in ("stage1", "uv_map", "texture"):
        for split in ("test", "train"):
            ev = entry[stage].get(split, {})
            if set(ev) != EVAL_KEYS or not math.isfinite(ev["psnr"]):
                fail(f"the pipeline's {stage} {split} evaluation is {ev}")

    scene = pp.DATASET_ARGS
    n_train, n_test = (int(scene[scene.index(k) + 1])
                       for k in ("--views", "--test_views"))
    evals = {}
    for run in PIPELINE_STAGES:
        iters, want = expected_pipeline_launches(out, run, n_train, n_test)
        got = records[run]["launches"]
        evals[run] = stage_evaluations(out, run)
        log(f"[pipeline] {run}: {iters} iterations in "
            f"{records[run]['seconds']:.1f} s, peak "
            f"{records[run].get('peak_gib', math.nan):.3f} GiB, "
            f"{records[run].get('left_gib', math.nan):.3f} GiB left after "
            "it; launches "
            f"{got}; evaluations {evals[run]}")
        for name, n in want.items():
            if got[name] != n:
                fail(f"pipeline {run}: kernel {name} launched {got[name]} "
                     f"times, expected {n}")

    # kernels A, A', B and B' on the last stage-3 step's arguments
    a_args, b_args = seen["fused_pairs_backward"], seen["tex_term_backward"]
    pairs, m = a_args[2], a_args[5]
    mlist, texture, _, height, width, mode = b_args[:6]
    log(f"[pipeline kernels] on the last stage-3 step's arguments: "
        f"{int(pairs.n_pairs)} pairs over {pairs.tile_counts.numel()} tiles "
        f"(max {int(pairs.tile_counts.max())} a tile), m = {m}")
    with torch.no_grad():
        got_a = kf.fused_pairs(*a_args[:6])
        want_a = kf.mlist_scan(*a_args[:6])
        exact_uv = exact_uv_check(torch, a_args)
        err = {"A": check_kernel_a(torch, got_a, want_a, exact_uv)}
        exact_uv_control(torch, got_a, want_a, exact_uv)
        del got_a, want_a
        err["B"] = check_close(
            torch, "B (last stage-3 step)",
            kt.tex_term(mlist, texture, height, width, mode),
            kt.mlist_tex_term(mlist, texture, height, width, mode),
            atol=2e-5, rtol=1e-4)
    err["A'"] = check_a_prime(torch, a_args, "A' (last stage-3 step)")[0]
    err["B'"] = check_b_prime(torch, b_args, "B' (last stage-3 step)")[0]

    s1 = entry["stage1"]["test"]["psnr"]
    s3 = entry["texture"]["test"]["psnr"]
    # the mean pair count of each of 20 windows of stage-3 steps
    its = sorted(pairs_at)
    span = max(1, len(its) // 20)
    curve = {its[k]: int(np.mean([pairs_at[i] for i in its[k:k + span]]))
             for k in range(0, len(its), span)}
    record = {"metrics": metrics, "stages": records, "evaluations": evals,
              "stage3_pairs": {it: pairs_at[it] for it in
                               sorted(evals["prod_texture"].get("test", {}))
                               if it in pairs_at},
              "stage3_pairs_mean": curve, "kernel_err": err, "card": card}
    log(f"[pipeline] {key}: stage-1 test {s1:.2f} dB, stage-3 test "
        f"{s3:.2f} dB; stage-3 pairs at its evaluations "
        f"{record['stage3_pairs']}; {card}")
    if not full:
        for stage, got in (("stage1", s1), ("texture", s3)):
            floor = PIPELINE_FIRST_READING[stage] - PIPELINE_MARGIN_DB
            if not got >= floor:
                fail(f"the quick pipeline's {stage} test PSNR {got:.2f} dB "
                     f"is below {floor:.2f}")
    return record


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


def check_kernel_2_more(torch, m_args, got):
    """Kernel 2 on view 0's arguments `m_args`, beyond check_kernel_2: with
    its tiles heaviest first and in launch order, and into output memory
    that held NaN, each the M-lists `got` bit for bit (a dead slot is
    written 0, not left); at m = 1 and 33 against its plain version."""
    from texgs_torch.kernels import binning
    from texgs_torch.kernels import uvtex_mlist as km

    table, uv_rows, pairs, rays, gx, m = m_args
    n_tiles = pairs.tile_counts.numel()
    for name, order in (
            ("heaviest first", binning.with_tile_order(pairs).tile_order),
            ("launch order", torch.arange(n_tiles, device=table.device))):
        out = km.mlist_pairs_forward(table, uv_rows, pairs._replace(
            tile_order=order), rays, gx, m)
        same = torch.equal(out, got)
        log(f"  2 with its tiles {name}: M-lists bit for bit: {same}")
        if not same:
            fail("kernel 2's outputs depend on the order it takes the tiles "
                 "in")
    del out
    junk = [torch.full(got.shape, math.nan, device=table.device)
            for _ in range(2)]
    ptrs = {t.data_ptr() for t in junk}
    del junk
    again = km.mlist_pairs_forward(*m_args)
    n_dead = int((got[..., 0] == 0).sum())
    same = again.data_ptr() in ptrs and torch.equal(again, got)
    log(f"  2 into output memory that held NaN: M-lists bit for bit, "
        f"{n_dead} dead slots written 0: {same}")
    if not same:
        fail("kernel 2 left a dead slot unwritten, or its output memory "
             "held no NaN")
    del again
    for m_more in (1, 33):
        args = (*m_args[:5], m_more)
        log(f"  2 at m = {m_more}:")
        check_kernel_2(torch, km.mlist_pairs_forward(*args),
                       km.mlist_only_scan(*args))


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
        if pairs.tile_order is None:
            fail("the two-kernel render handed kernel 1 a pair list without "
                 "its tile order")
        check_tile_orders(torch, table, pairs, gx, got_1)
        if m_args[2].tile_order is None:
            fail("the two-kernel render handed kernel 2 a pair list without "
                 "its tile order")
        got_2 = km.mlist_pairs_forward(*m_args)
        err_2 = check_kernel_2(torch, got_2, km.mlist_only_scan(*m_args))
        check_kernel_2_more(torch, m_args, got_2)

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


def run_tool(module, log_path):
    """`python -m module` from the repository root, as a process of its
    own, its output kept in log_path.  Returns (its stdout lines, its
    seconds); fails if it exits non-zero."""
    from pathlib import Path

    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", module],
                          cwd=str(Path(__file__).resolve().parent),
                          capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    Path(log_path).write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        fail(f"{module} exited {proc.returncode}: "
             + (proc.stdout + proc.stderr)[-3000:])
    return proc.stdout.splitlines(), seconds


def measure_phase(torch, device, work_dir):
    """Phase 22 (see the module docstring)."""
    from texgs_torch.kernels import raster as kr
    from texgs_torch.kernels import tex_term as kt
    from texgs_torch.kernels import uvtex_fused as kf
    from texgs_torch.nets import hash_encode as ke
    from texgs_torch.nets import hash_gather as kg
    from texgs_torch.tools import bench, bench_stage3, roofline

    lines, seconds = run_tool("texgs_torch.tools.verify_compiled",
                              f"{work_dir}/verify.log")
    verdict = json.loads(lines[-1])
    log(f"[measure] verify_compiled in {seconds:.1f} s: {json.dumps(verdict)}")
    if not (verdict["ok"] is True and verdict["compiled"] is True):
        fail("verify_compiled's verdict is not ok and compiled")

    lines, seconds = run_tool("texgs_torch.tools.bench",
                              f"{work_dir}/bench.log")
    metrics = [json.loads(line) for line in lines if line.startswith("{")]
    log(f"[measure] bench in {seconds:.1f} s:")
    for m in metrics:
        log(f"  {json.dumps(m)}")
    if [m["metric"] for m in metrics] != ["stage3_step_ms",
                                          "rays_per_s_fwd_bwd_cuda"]:
        fail(f"bench printed the metrics {[m['metric'] for m in metrics]}")
    for m in metrics:
        if not (math.isfinite(m["value"]) and m["value"] > 0
                and 0 < m["mfu_pct"] <= 100 and 0 < m["hbm_util_pct"] <= 100):
            fail(f"bench line out of range: {m}")

    # the launches of the bench's steps, in this process
    counters = {"A": kf.fused_pairs, "A'": kf.fused_pairs_backward,
                "B": kt.tex_term, "B'": kt.tex_term_backward,
                "K5'": ke.hash_encode, "K5''": ke.hash_encode_backward,
                "K5": kg.hash_gather, "1": kr.raster_pairs,
                "1'": kr.raster_pairs_backward}
    for fn in counters.values():
        fn.launches = 0
    dt3, aux3 = bench_stage3.measure(iters=MEASURE_ITERS, device=device)
    steps3 = 2 + MEASURE_ITERS
    got3 = {k: counters[k].launches for k in counters}
    for fn in counters.values():
        fn.launches = 0
    dt1, aux1 = bench.measure_stage1(iters=MEASURE_ITERS, device=device)
    steps1 = 1 + MEASURE_ITERS
    got1 = {k: counters[k].launches for k in counters}
    log(f"[measure] bench_stage3.measure: {steps3} steps, median "
        f"{dt3 * 1e3:.3f} ms (spread {aux3['spread_ms']}), launches {got3}")
    log(f"[measure] bench stage-1 step: {steps1} steps, median "
        f"{dt1 * 1e3:.3f} ms (spread {aux1['spread_ms']}), launches {got1}")
    want3 = {k: (steps3 if k in ("A", "A'", "B", "B'", "K5'", "K5''") else 0)
             for k in counters}
    want1 = {k: (steps1 if k in ("1", "1'") else 0) for k in counters}
    if got3 != want3 or got1 != want1:
        fail(f"the bench's steps launched {got3} and {got1}, expected "
             f"{want3} and {want1}")
    for what, comps, dt in (
            ("stage-1", roofline.stage1_counts(aux1["n"], aux1["n_pairs"],
                                              aux1["width"], aux1["height"]),
             dt1),
            ("stage-3", roofline.stage3_counts(
                aux3["n"], aux3["n_pairs"], aux3["width"], aux3["height"],
                tex_res=aux3["tex_res"]), dt3)):
        log(f"[measure] roofline of the {what} step at this run's pair "
            f"count: {json.dumps(roofline.summarize(comps, dt))}")
        log(roofline.table(comps))


# ------------------------------------------------------------------ 23. dist
# bands and depth slices of the in-process checks
DIST_SPLITS = (2, 4)
# ranks of the full-width sharded steps; steps timed after the checked one
DIST_RANKS = 2
DIST_TIMED = 3
# the full-width stage-1 step: the bench's blob, SH degree 3
DIST_S1_SH = 3


def sync(torch, device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def stitched(torch, render_fn, cam, n, keys):
    """render_fn's n row bands of `cam`, stitched: {key: (C, H, W)}."""
    from texgs_torch.dist.tile_parallel import (band_height, render_band,
                                                stitch_bands)

    bh = band_height(cam.height, n)
    outs = [render_band(cam, i * bh, bh, render_fn) for i in range(n)]
    return {k: stitch_bands(torch.stack([o[k] for o in outs]), cam.height)
            for k in keys}


def band_rows_of(torch, image, row0, bh, height):
    """Rows [row0, row0 + bh) of a (C, H, W) image, zero below the image,
    and the mask of the rows inside it."""
    pad = torch.nn.functional.pad(image, (0, 0, 0, row0 + bh - height)) \
        if row0 + bh > height else image
    rows = torch.arange(row0, row0 + bh, device=image.device)
    return pad[:, row0:row0 + bh], (rows < height).float()[None, :, None]


def fold_error(torch, name, got, want, bound):
    """Max and q99.9 of |got - want|; fails beyond `bound`."""
    err = (got - want).abs().flatten()
    q = torch.quantile(err[::max(1, err.numel() // (1 << 24))].float(), 0.999)
    log(f"  {name}: max {err.max().item():.3e}, q99.9 {q.item():.3e} "
        f"(bound {bound:.3e})")
    if not err.max().item() <= bound:
        fail(f"{name}: the folded slices leave the local-T_STOP bound")
    return err.max().item()


def dist_inprocess_phase(torch, device, model, s1, cam, gt3, gt1):
    """Phase 23's checks in this process: stitched bands and folded depth
    slices against the whole frame, kernels on band arguments.  Returns
    the M-list length that cuts no pixel's list of view 0."""
    from texgs_torch.dist.gauss_sharded import (finish_fold, render_slice,
                                                render_uv_slice)
    from texgs_torch.dist.tile_parallel import band_height, render_band
    from texgs_torch.kernels import project as proj_k
    from texgs_torch.kernels import raster as kr
    from texgs_torch.kernels import tex_term as kt
    from texgs_torch.kernels import uvtex_fused as kf
    from texgs_torch.kernels.reference import ALPHA_CLAMP, T_STOP
    from texgs_torch.kernels.uvtex_raster import residual_sh_colors
    from texgs_torch.utils.sh import C0

    height = cam.height
    close = dict(atol=1e-4, rtol=1e-4, max_off=3 * MAX_OFF_PIXELS, hard=0.05)
    counters = {"uvtex_fused": kf.fused_pairs, "tex_term": kt.tex_term,
                "raster": kr.raster_pairs}
    with torch.no_grad():
        whole3 = model.render(cam)
        whole1 = s1._render(cam)
        for n in DIST_SPLITS:
            bh = band_height(height, n)
            for fn in counters.values():
                fn.launches = 0
            got3 = stitched(torch, model._render, cam, n,
                            ("render", "render_no_sh", "alpha"))
            got1 = stitched(torch, s1._render, cam, n, ("render", "alpha"))
            sync(torch, device)
            launches = {k: fn.launches for k, fn in counters.items()}
            log(f"[dist] {n} bands of {bh} rows (the last {height - (n - 1) * bh}"
                f" real, {n * bh - height} padded); launches {launches}")
            if device.type == "cuda" and launches != {k: n for k in counters}:
                fail(f"{n} bands launched {launches}, expected each kernel "
                     "once a band")
            for k in ("render", "render_no_sh", "alpha"):
                check_close(torch, f"stage-3 {k}, {n} bands stitched vs the "
                            "whole frame", got3[k], whole3[k], **close)
            for k in ("render", "alpha"):
                check_close(torch, f"stage-1 {k}, {n} bands stitched vs the "
                            "whole frame", got1[k], whole1[k], **close)

        # kernels A, B and 1 on the arguments of band 1 of 2
        bh = band_height(height, 2)
        seen = {}
        with recording(kf, "fused_pairs", seen), \
                recording(kt, "tex_term", seen), \
                recording(kr, "raster_pairs", seen):
            model._render(cam, row_offset=bh, band_height=bh)
            s1._render(cam, row_offset=bh, band_height=bh)
        a_args, b_args, r_args = (seen["fused_pairs"], seen["tex_term"],
                                  seen["raster_pairs"])
        log(f"[dist kernels] on band 1 of 2 (rows {bh}..{2 * bh}, "
            f"{2 * bh - height} padded): stage 3 {int(a_args[2].n_pairs)} "
            f"pairs over {a_args[2].tile_counts.numel()} band-local tiles, "
            f"stage 1 {int(r_args[1].n_pairs)}; the band's first row rides "
            "in the rays' c0, so the plain scans take tile0 = 0")
        check_kernel_a(torch, kf.fused_pairs_forward(*a_args),
                       kf.mlist_scan(*a_args, tile0=0))
        check_close(torch, "B on the band's M-lists", kt.tex_term(*b_args),
                    kt.mlist_tex_term(*b_args), atol=2e-5, rtol=1e-4)
        check_kernel_1(torch, kr.raster_pairs_forward(*r_args),
                       kr.raster_scan(*r_args, tile0=0))

    # A', B' and 1' on one step of the padded last band of 4
    bh = band_height(height, 4)
    row0 = 3 * bh
    seen = {}
    for leaves in (model._gauss_leaves(), model._uv_leaves(),
                   model._tex_leaves(), s1.state.params_dict()):
        for p in leaves.values():
            p.requires_grad_(True)
            p.grad = None
    with recording(kf, "fused_pairs_backward", seen), \
            recording(kt, "tex_term_backward", seen), \
            recording(kr, "raster_pairs_backward", seen), \
            torch.enable_grad():
        for mdl, gt in ((model, gt3), (s1, gt1)):
            out = render_band(cam, row0, bh, mdl._render)
            img, mask = band_rows_of(torch, gt["image"], row0, bh, height)
            alpha, _ = band_rows_of(torch, gt["alpha"], row0, bh, height)
            loss = (((out["render"] - img) * mask).abs().mean()
                    + ((out["alpha"] - alpha) * mask).abs().mean())
            if "render_no_sh" in out:
                loss = loss + ((out["render_no_sh"] - img) * mask).abs().mean()
            loss.backward()
    log(f"[dist kernels] one band step on band 3 of 4 (rows {row0}.."
        f"{row0 + bh}, {row0 + bh - height} padded): A', B' and 1' against "
        "their plain versions on its arguments")
    check_a_prime(torch, seen["fused_pairs_backward"], "A' (band)")
    check_b_prime(torch, seen["tex_term_backward"], "B' (band)")
    check_1_prime(torch, seen["raster_pairs_backward"], "1' (band)")
    for leaves in (model._gauss_leaves(), model._uv_leaves(),
                   model._tex_leaves(), s1.state.params_dict()):
        for p in leaves.values():
            p.grad = None

    # depth slices folded with the over operator
    bound = ALPHA_CLAMP * T_STOP / (1 - ALPHA_CLAMP)
    with torch.no_grad():
        m0 = int(model.cfg.get_or("uvtex_m", 32))
        model.cfg.uvtex_m = 256
        seen = {}
        with recording(kt, "tex_term", seen):
            model.render(cam)
        slots = (seen["tex_term"][0][..., 0] != 0).sum(-1)
        m_nocut = int(slots.max())
        cut = int((slots > m0).sum())
        log(f"[dist slices] the longest live M-list of view 0 holds "
            f"{m_nocut} entries ({cut} pixels hold more than m = {m0}); "
            f"the slices are held at m = {m_nocut}, which cuts no list")
        if m_nocut >= 256:
            fail("view 0 has a pixel list of 256 entries or more")
        act = model._activated()
        uvs, jac = model._uvs_and_jac(act["xyz"])
        campos = torch.as_tensor(cam.camera_center, device=device)
        c_max3 = (residual_sh_colors(act["shs"], act["xyz"], campos,
                                     model.active_sh_degree).max().item()
                  + C0 * model.texture.abs().max().item())
        st = s1.state
        c_max1 = proj_k.sh_colors(st.get_features(), st.xyz, campos,
                                  s1.active_sh_degree).max().item()
        kw3 = dict(xyz=act["xyz"], opacity=act["opacity"],
                   scaling=act["scaling"], rotation=act["rotation"], uvs=uvs,
                   grad_uvs=jac, texture=model.texture, shs=act["shs"],
                   active_sh_degree=model.active_sh_degree, backend="auto",
                   tex_backend="auto", with_no_sh=True)
        kw1 = dict(xyz=st.xyz, opacity=st.get_opacity(),
                   scaling=st.get_scaling(), rotation=st.get_rotation(),
                   features=st.get_features(),
                   active_sh_degree=s1.active_sh_degree)
        for m in (m_nocut, m0):
            model.cfg.uvtex_m = m
            whole = model.render(cam)
            for n in DIST_SPLITS:
                parts = [render_uv_slice(cam, m=m, index=i, n_slices=n, **kw3)
                         for i in range(n)]
                fold = finish_fold(torch.stack([p[0] for p in parts]),
                                   torch.stack([p[1] for p in parts]),
                                   model.bg)
                for k in ("render", "alpha"):
                    b = bound * (c_max3 if k == "render" else 1.0)
                    name = f"stage-3 {k}, {n} depth slices folded, m = {m}"
                    if m == m_nocut:
                        fold_error(torch, name, fold[k], whole[k], b + 1e-4)
                    else:  # each slice its own m slots: no bound holds
                        err = (fold[k] - whole[k]).abs()
                        log(f"  {name}: max {err.max().item():.3e}, mean "
                            f"{err.mean().item():.3e} (each slice keeps its "
                            f"own {m} slots; {cut} pixels hold more)")
        model.cfg.uvtex_m = m0
        for n in DIST_SPLITS:
            parts = [render_slice(cam, index=i, n_slices=n, **kw1)
                     for i in range(n)]
            fold = finish_fold(torch.stack([p[0] for p in parts]),
                               torch.stack([p[1] for p in parts]), s1.bg)
            for k in ("render", "alpha"):
                b = bound * (c_max1 if k == "render" else 1.0)
                fold_error(torch, f"stage-1 {k}, {n} depth slices folded",
                           fold[k], whole1[k], b + 1e-4)
    return m_nocut


def dist_stage3_model(torch, inp, device, m=None):
    """Phase 3's model as phase 7 trains it (the chessboard retexture,
    stage3_stepper's setup), from phase 23's inputs."""
    from texgs_torch.config import Cfg
    from texgs_torch.train.texture_gaussian3d import from_jax_state

    cfg = dict(inp["model_cfg"]) if m is None else dict(inp["model_cfg"],
                                                        uvtex_m=m)
    model = from_jax_state(inp["sd3"], Cfg(cfg), device=device)
    # training starts from the chessboard retexture, as in phase 7: the
    # ground truth is the model's own render before it
    model.change_texture(inp["chess"], mode=0)
    model.spatial_lr_scale = SPATIAL_LR_SCALE
    model.setup_optim(Cfg(OPTIM_CFG))
    seed_nu(model.adam_g, model.adam_uv, model.adam_tex)
    model.bind_train_cfg(Cfg(TRAIN_CFG), cfg["background"])
    return model


def dist_stage1_model(torch, params, device):
    """The bench's blob as configs/prod_stage1.yaml trains it, SH 3."""
    from texgs_torch.config import Cfg
    from texgs_torch.core.state import GaussianState
    from texgs_torch.train.gaussian3d import Gaussian3D

    model = Gaussian3D(Cfg(STAGE1_MODEL_CFG), device=device)
    model.bind_train_cfg(Cfg(STAGE1_TRAIN_CFG), [0, 0, 0])
    model.spatial_lr_scale = SPATIAL_LR_SCALE
    model.state = GaussianState.from_params(
        {k: torch.as_tensor(v, device=device).clone()
         for k, v in params.items()})
    model.setup_optim(Cfg(STAGE1_OPTIM_CFG))
    seed_nu(model.adam)
    model.active_sh_degree = DIST_S1_SH
    return model


def seed_nu(*adams):
    """Adam's second moments at 1e-6, as texgs's sharded tests seed theirs
    (tests/test_dist_sharded.py:222-229): a first step from zero moments
    moves an element by +-lr whatever its gradient's size, so a gradient
    near 0 whose sign the atomics of two runs round apart would move it
    2 lr apart; seeded, an update follows its gradient smoothly."""
    for adam in adams:
        for v in adam.nu.values():
            v.add_(1e-6)


def stage3_leaves(model):
    """{name: (leaf, its Adam)} of a stage-3 model."""
    return {**{f"gauss.{k}": (v, model.adam_g)
               for k, v in model._gauss_leaves().items()},
            **{f"uv.{k}": (v, model.adam_uv)
               for k, v in model._uv_leaves().items()},
            "tex.texture": (model.texture, model.adam_tex)}


def stage1_leaves(model):
    return {k: (v, model.adam) for k, v in model.state.params_dict().items()}


def compare_densify(torch, got, want, mode, exact):
    """The densify stats of a sharded stage-1 step against the single-card
    step's: visibility counts and max radii equal, the NDC-gradient norms
    within 1e-3 of their max (tile), 3e-2 (gauss: the local T stop), or
    1e-6 (one rank)."""
    for k in ("denom", "max_radii2d"):
        if not torch.equal(getattr(got, k), getattr(want, k)):
            fail(f"densify stats: {k} differs from the single-card step's")
    a, b = got.xyz_gradient_accum, want.xyz_gradient_accum
    diff = (a - b).abs().max().item()
    err = diff / (b.abs().max().item() + 1e-12)
    if not (diff <= 1e-6 if exact
            else err <= (1e-3 if mode == "tile" else 3e-2)):
        fail(f"densify stats: the NDC-gradient norms differ by {diff:.3e}, "
             f"{err:.3e} of their max")
    return (f"densify stats: counts and radii equal, norms {diff:.2e} apart "
            f"({err:.2e} of their max)")


def compare_steps(torch, what, got, want, loss, want_loss, mode, exact=False,
                  enforce=True):
    """A sharded step's result (`got`: {name: (leaf, adam)} after it)
    against the single-card step's (`want`).  Tile mode: loss rtol 1e-4,
    parameters atol 3e-4 where |grad| > 1e-6 (texgs's
    tests/test_dist_sharded.py:127-135); gauss mode: the local-T_STOP
    divergence, loss rtol 3e-3 and gradients at 2e-2 of each leaf's max
    (texgs's :556-559) for 99.9% of each leaf's elements, none beyond the
    max (an L1 residual within an ulp of 0 takes the other sign in the
    fold, and a texel or Gaussian that such pixels alone reach moves by a
    whole pixel's share); `exact`: every value within 1e-6.  Without
    `enforce` only finite values are required.  Returns a summary for the
    log."""
    rel_loss = abs(loss - want_loss) / max(abs(want_loss), 1e-12)
    worst_p = worst_g = 0.0
    bitwise = loss == want_loss
    for name, (leaf, adam) in want.items():
        key = name.split(".", 1)[-1]
        p_want, g_want = leaf.detach(), adam.mu[key] / 0.1
        g_leaf, g_adam = got[name]
        p_got, g_got = g_leaf.detach(), g_adam.mu[key] / 0.1
        bitwise = bitwise and torch.equal(p_got, p_want)
        if not (torch.isfinite(p_got).all() and torch.isfinite(g_got).all()):
            fail(f"{what}: {name} is not finite")
        rel = (g_got - g_want).abs() / (g_want.abs().max() + 1e-12)
        g_err = rel.max().item()
        g_off = (rel > 2e-2).float().mean().item()
        worst_g = max(worst_g, g_err)
        moving = g_want.abs() > 1e-6
        p_err = ((p_got - p_want).abs()[moving].max().item()
                 if bool(moving.any()) else 0.0)
        worst_p = max(worst_p, p_err)
        if not enforce:
            continue
        if exact:
            p_err = (p_got - p_want).abs().max().item()
            if p_err > 1e-6:
                fail(f"{what}: {name} differs by {p_err:.3e}")
        elif mode == "tile" and p_err > 3e-4:
            fail(f"{what}: {name} differs by {p_err:.3e} where |grad| > 1e-6")
        elif mode == "gauss" and (g_off > 1e-3 or g_err > 1.0):
            fail(f"{what}: {name}'s gradient differs by {g_err:.3e} of its "
                 f"max, {g_off:.2e} of its elements by more than 2e-2")
    tol = 1e-6 if exact else (1e-4 if mode == "tile" else 3e-3)
    if not math.isfinite(loss) or (enforce and not (
            abs(loss - want_loss) <= 1e-6 if exact else rel_loss <= tol)):
        fail(f"{what}: loss {loss!r} vs the single-card step's {want_loss!r}")
    return (f"loss {loss:.6f} vs {want_loss:.6f} (rel {rel_loss:.2e}); max "
            f"param diff where |grad| > 1e-6 {worst_p:.2e}, max grad diff "
            f"{worst_g:.2e} of the leaf's max; bit for bit: {bitwise}"
            + ("" if enforce else " (reported, not held)"))


def dist_rank_main(rank, world, port, backend, device_type, in_path,
                   out_path):
    """One rank of phase 23's full-width sharded steps (spawned)."""
    import pickle

    import torch

    from texgs_torch.config import Cfg
    from texgs_torch.dist import collectives
    from texgs_torch.dist.mesh import initialize_dist, make_mesh, transport
    from texgs_torch.dist.sharded import (stage1_sharded_step,
                                          stage3_sharded_step)
    from texgs_torch.kernels import raster as kr
    from texgs_torch.kernels import tex_term as kt
    from texgs_torch.kernels import uvtex_fused as kf
    from texgs_torch.nets import hash_encode as ke

    torch.set_num_threads(1)
    device = initialize_dist(backend, device_type, f"tcp://localhost:{port}",
                             world, rank)
    with open(in_path, "rb") as f:
        inp = pickle.load(f)
    mesh = make_mesh(("data", "tile"), (1, world), device.type)
    counters = {"uvtex_fused": kf.fused_pairs, "tex_term": kt.tex_term,
                "uvtex_fused_bwd": kf.fused_pairs_backward,
                "tex_term_bwd": kt.tex_term_backward,
                "hash_encode": ke.hash_encode,
                "hash_encode_bwd": ke.hash_encode_backward,
                "raster": kr.raster_pairs,
                "raster_bwd": kr.raster_pairs_backward}
    report = {"transport": transport(mesh), "steps": []}
    cam3, cam1 = inp["cam3"], inp["cam1"]
    loss3_cfg, loss1_cfg = Cfg(LOSS_CFG), Cfg(STAGE1_LOSS_CFG)
    modes = ("tile", "gauss") if world > 1 else ("tile",)
    runs = [(3, mode, m) for mode in modes
            for m in ((32, inp["m_nocut"]) if mode == "gauss" else (32,))]
    runs += [(1, mode, None) for mode in modes]
    for stage, mode, m in runs:
        if stage == 3:
            model = dist_stage3_model(torch, inp, device, m)
            flags, lambdas, lrs, apply = model.step_settings(
                FIRST_ITER, cam3, loss3_cfg)

            def step():
                return stage3_sharded_step(
                    mesh, model, [cam3], lrs, {"bg": model.bg, **lambdas},
                    apply, flags, model.active_sh_degree,
                    int(model.cfg.max_inverse_points), m=m, backend="auto",
                    tex_backend="auto", shard_mode=mode)[0]
            leaves = stage3_leaves
        else:
            model = dist_stage1_model(torch, inp["s1_params"], device)
            flags, lambdas, lrs, apply = model.step_settings(
                STAGE1_FIRST_ITER, cam1, loss1_cfg)

            def step():
                loss, _, model.stats = stage1_sharded_step(
                    mesh, model.state, model.adam, model.stats, [cam1], lrs,
                    {"bg": model.bg, **lambdas}, apply, flags,
                    model.active_sh_degree, backend="auto", shard_mode=mode)
                return loss
            leaves = stage1_leaves
        for fn in counters.values():
            fn.launches = 0
        traffic0 = dict(collectives.TRAFFIC)
        loss = float(step())
        sync(torch, device)
        launches = {k: fn.launches for k, fn in counters.items()}
        traffic = {k: v - traffic0[k] for k, v in collectives.TRAFFIC.items()}
        got = leaves(model)
        divergence = collectives.replica_divergence(
            [leaf for leaf, _ in got.values()])
        if divergence != 0.0:
            fail(f"stage {stage} {mode} m={m}: the replicas differ by "
                 f"{divergence:.3e}")
        if world == 1:  # NCCL carries one collective of the step's loss
            t = torch.tensor([loss], device=device)
            torch.distributed.all_reduce(t)
            if t.item() != loss:
                fail("a one-rank all_reduce changed its value")
        summary = None
        if rank == 0:
            # the single-card step on the same model and camera; a gauss
            # step at m = 32 is only reported: each slice keeps its own m
            # slots, so a pixel whose list the whole frame cuts gains
            # contributors
            enforce = not (stage == 3 and mode == "gauss" and m == 32)
            if stage == 3:
                ref = dist_stage3_model(torch, inp, device, m)
                want_loss = float(ref.compute_loss(FIRST_ITER, 10000, cam3,
                                                   None, loss3_cfg)[0])
            else:
                ref = dist_stage1_model(torch, inp["s1_params"], device)
                want_loss = float(ref.compute_loss(STAGE1_FIRST_ITER, 7500,
                                                   cam1, None, loss1_cfg)[0])
            summary = compare_steps(
                torch, f"stage {stage} {mode} over {world} rank(s)", got,
                leaves(ref), loss, want_loss, mode, exact=world == 1,
                enforce=enforce)
            if stage == 1:
                summary += "; " + compare_densify(torch, model.stats,
                                                  ref.stats, mode, world == 1)
            if world == 1:
                # the control: a second single-card step on the same inputs
                ref2 = (dist_stage3_model(torch, inp, device, m) if stage == 3
                        else dist_stage1_model(torch, inp["s1_params"], device))
                it, c, lc = ((FIRST_ITER, cam3, loss3_cfg) if stage == 3
                             else (STAGE1_FIRST_ITER, cam1, loss1_cfg))
                ref2.compute_loss(it, 10000, c, None, lc)
                same = all(torch.equal(a.detach(), b.detach()) for (a, _), (b, _)
                           in zip(leaves(ref).values(), leaves(ref2).values()))
                summary += (f"; two single-card steps bit for bit: {same}")
                del ref2
            del ref
        torch.distributed.barrier()
        times = []
        for _ in range(DIST_TIMED):
            sync(torch, device)
            t0 = time.perf_counter()
            step()
            sync(torch, device)
            times.append(time.perf_counter() - t0)
        report["steps"].append({
            "stage": stage, "mode": mode, "m": m, "loss": loss,
            "check": summary, "launches": launches, "traffic": traffic,
            "seconds": float(np.median(times)), "divergence": divergence})
        del model
        if device.type == "cuda":
            torch.cuda.empty_cache()
    if rank == 0:
        with open(out_path, "w") as f:
            json.dump(report, f)
    torch.distributed.destroy_process_group()


def dist_spawn(torch, world, backend, inputs, device, work_dir):
    """Phase 23's ranks over `world` processes; returns rank 0's report."""
    import socket

    import torch.multiprocessing as mp

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    out = f"{work_dir}/dist_{world}_{backend}.json"
    mp.start_processes(dist_rank_main,
                       args=(world, port, backend, device.type, inputs, out),
                       nprocs=world, start_method="spawn")
    with open(out) as f:
        return json.load(f)


def dist_phase(torch, device, sd0, cams, gt0, work_dir, card):
    """Phase 23 (see the module docstring)."""
    import pickle

    from texgs_torch.core.camera import with_ground_truth
    from texgs_torch.data.synthetic import blob_point_cloud
    from texgs_torch.config import Cfg
    from texgs_torch.core.state import init_from_pcd
    from texgs_torch.dist.dryrun import dryrun_multichip, pick_backend
    from texgs_torch.kernels.cubemap import chessboard_cubemap, faces_to_cross
    from texgs_torch.train.texture_gaussian3d import from_jax_state

    t_phase = time.perf_counter()
    cam = cams[0]
    chess = faces_to_cross(chessboard_cubemap(TEX_RES // 16, 16,
                                              device=device))
    model = from_jax_state(sd0, Cfg(MODEL_CFG), device=device)
    model.change_texture(chess, mode=0)
    model.bind_train_cfg(None, MODEL_CFG["background"])
    pcd = blob_point_cloud(N_GAUSS, seed=0)
    state = init_from_pcd(pcd.points, pcd.colors, DIST_S1_SH, device=device)
    params = {k: v.detach().cpu().numpy()
              for k, v in state.params_dict().items()}
    s1 = dist_stage1_model(torch, params, device)
    cam1 = spiral_ground_truth(torch, device, pcd, [cam])[0]
    gt1 = {"image": cam1.image, "alpha": cam1.alpha_mask}
    m_nocut = dist_inprocess_phase(torch, device, model, s1, cam, gt0, gt1)
    del model, s1
    if device.type == "cuda":
        torch.cuda.empty_cache()

    def host(a):
        return None if a is None else a.detach().cpu().numpy()

    # the steps' stage-3 ground truth: view 0's image (the model starts
    # from the chessboard) lifted by 0.05, its alpha as a binary mask and
    # its normals turned 5 degrees, so that few loss residuals lie near 0,
    # where an L1 term's gradient turns on the sign of a difference that
    # the sharded and the single-card renders round apart
    mask = (gt0["alpha"] > 0.5).float()
    c, s_ = math.cos(math.radians(5.0)), math.sin(math.radians(5.0))
    nx, ny, nz = gt0["norm"]
    normal = torch.stack([c * nx - s_ * ny, s_ * nx + c * ny, nz])
    inputs = f"{work_dir}/dist_inputs.pkl"
    with open(inputs, "wb") as f:
        pickle.dump({
            "sd3": sd0, "model_cfg": MODEL_CFG, "chess": host(chess),
            "s1_params": params,
            "m_nocut": m_nocut,
            "cam3": with_ground_truth(cam, host(gt0["image"] + 0.05),
                                      host(mask), normal=host(normal)),
            "cam1": with_ground_truth(cam, host(cam1.image),
                                      host(cam1.alpha_mask),
                                      normal=host(cam1.normal))}, f)

    for n in (2, 4):
        t0 = time.perf_counter()
        dryrun_multichip(n, device=device.type)
        log(f"[dist] dryrun_multichip({n}) on {device.type} tensors in "
            f"{time.perf_counter() - t0:.1f} s")
    for world in (DIST_RANKS, 1):
        backend = pick_backend(world, device)
        t0 = time.perf_counter()
        report = dist_spawn(torch, world, backend, inputs, device, work_dir)
        log(f"[dist] {world} rank(s) in a (data 1, tile {world}) mesh at full "
            f"width, {report['transport']}; {time.perf_counter() - t0:.1f} s")
        for st in report["steps"]:
            lbl = (f"stage {st['stage']} {st['mode']}"
                   + (f" m = {st['m']}" if st["m"] else ""))
            log(f"  {lbl}: {st['check']}; replicas identical "
                f"(max diff {st['divergence']}); launches {st['launches']}")
            log(f"  {lbl}: {st['seconds'] * 1e3:.1f} ms a step (median of "
                f"{DIST_TIMED}); collectives moved {st['traffic']} bytes a "
                f"rank; {card}"
                + ("; gloo through the host on one card: not a multi-GPU "
                   "figure" if backend == "gloo" else ""))
            want = (("uvtex_fused", "tex_term", "uvtex_fused_bwd",
                     "tex_term_bwd", "hash_encode", "hash_encode_bwd")
                    if st["stage"] == 3 else ("raster", "raster_bwd"))
            if device.type == "cuda" and not all(st["launches"][k] >= 1
                                                 for k in want):
                fail(f"{lbl} did not launch each of {want}")
    log(f"[dist] phase 23 in {time.perf_counter() - t_phase:.1f} s")


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


# kernels P and P' (csrc/project.cu, project_bwd.cu): the bytes a Gaussian
# moves in the timed stage-3 form (P reads xyz, scaling, rotation and
# opacity, 44 B, and writes means2d, depth, conic, radius, opacity and
# normal, 44 B; P' reads the 44 B of inputs and 40 B of cotangents and
# writes the 44 B of their gradients, no NDC offset's) and the f32
# operations a Gaussian (counted from the sources: the chain, and the chain
# replayed with its transpose)
P_BYTES, P_BWD_BYTES = 88, 128
OPS_P, OPS_P_BWD = 250, 600
# each is below an empty launch's queued reading (0.0049 ms): the target
P_TARGET_MS = 0.02


def projection_phase(torch, device, launches):
    """Kernels P and P' on the benchmark's stage-3 DTU scene (100,000 flat
    discs, the gs1 and tgs3 cells' geometry) and its first 800x600 view:
    each output against the plain chain and each gradient against
    autograd through it, in the stage-3 form and with stage 1's NDC
    offset; the device launches of both paths; the times beside the
    bounds.  launches: {"project": P's launches over phase 5,
    "project_bwd": P''s over phase 7's steps}.  Returns the two kernels'
    entries."""
    from benchmark import harness, program, scene
    from texgs_torch.kernels import project as pj

    cfg = harness.cell("tgs3-dtu-train")["config"]
    state, _ = scene.make_state(cfg, 0, device)
    cam = program.camera(scene.spiral_views(cfg["assumed"]["views"])[0])
    rot = state["rotation"]
    inputs = {"xyz": state["xyz"], "scaling": torch.exp(state["scaling"]),
              "rotation": rot / (torch.linalg.norm(rot, dim=-1, keepdim=True)
                                 + 1e-12),
              "opacity": torch.sigmoid(state["opacity"])}
    inputs = {k: v.detach().contiguous() for k, v in inputs.items()}
    n = inputs["xyz"].shape[0]
    host = (cam.world_view, cam.full_proj, cam.camera_center, cam.width,
            cam.height, cam.tanfovx, cam.tanfovy)
    dev_cam = [torch.as_tensor(a, device=device) for a in host[:3]]
    log(f"[projection] P and P' on {n} flat discs (the DTU cells' scene), "
        f"view 0 at {cam.width}x{cam.height}")
    outputs = ("means2d", "depths", "conics", "opacities", "normals")
    gen = torch.Generator(device=device).manual_seed(11)
    block = torch.randn((n, 10), generator=gen, device=device)
    cots = [block[:, 0:2], block[:, 2], block[:, 3:6], block[:, 6],
            block[:, 7:10]]
    err_p = err_pb = 0.0
    for form in ("stage 3", "stage 1 (NDC offset)"):
        ndc = torch.zeros((n, 2), device=device) if form != "stage 3" \
            else None

        def run(fn, cam_args, dtype=torch.float32):
            leaves = {k: v.to(dtype, copy=True).requires_grad_(True)
                      for k, v in inputs.items()}
            off = None if ndc is None else \
                ndc.to(dtype, copy=True).requires_grad_(True)
            out = fn(leaves["xyz"], leaves["scaling"], leaves["rotation"],
                     leaves["opacity"], None, *cam_args, *host[3:],
                     ndc_offset=off)
            wrt = [*leaves.values()] + ([] if off is None else [off])
            grads = torch.autograd.grad(
                [getattr(out, k) for k in outputs], wrt,
                [c.to(dtype, copy=True) for c in cots])
            return out, grads
        before = (pj.project_gaussians.launches,
                  pj.project_gaussians_backward.launches)
        got, got_g = run(pj.project_gaussians, host[:3])
        if (pj.project_gaussians.launches - before[0],
                pj.project_gaussians_backward.launches - before[1]) != (1, 1):
            fail("the projection did not launch P and P' once each")
        want, want_g = run(pj.project_plain, dev_cam)
        exact, exact_g = run(pj.project_plain, [a.double() for a in dev_cam],
                             torch.float64)
        torch.cuda.synchronize()
        for name in ("means2d", "depths", "normals"):
            g, w = getattr(got, name), getattr(want, name)
            err_p = max(err_p, check_scaled(
                torch, f"P {form} {name}", g, w, 1e-6, 1e-5))
        # each Gaussian's conic may lie from the plain chain's by twice
        # the plain chain's largest distance from float64 (conic_offsets)
        rel, own, n_off = pj.conic_offsets(got.conics, want.conics,
                                           exact.conics)
        log(f"  P {form} conics: max |kernel - plain| / |float64| a Gaussian "
            f"{rel.max().item():.3e}; the plain chain's own max "
            f"{own:.3e} off float64; {n_off} beyond twice that")
        if n_off:
            fail(f"P {form}: conics disagree with the plain chain")
        err_p = max(err_p, (got.conics - want.conics).abs().max().item())
        if not torch.equal(got.opacities, want.opacities):
            fail(f"P {form}: the culled opacities differ from the plain chain")
        if not torch.equal(got.radii > 0, want.radii > 0):
            fail(f"P {form}: the visible set differs from the plain chain")
        differ = got.radii != want.radii
        log(f"  P {form}: {int((got.radii > 0).sum())} visible, "
            f"{int(differ.sum())} of {n} radii differ from the plain chain's "
            f"(by at most {int((got.radii - want.radii).abs().max())})")
        if bool(((got.radii - want.radii).abs() > 1).any()):
            fail(f"P {form}: a radius differs by more than one")
        # the gradients: on Gaussians whose determinant is well conditioned
        # at the check's tolerance; on all, within twice the plain chain's
        # own largest distance from float64
        live = (want.conics != 0).any(1)
        well = (pj.det_condition(exact.conics) <= 10.0) | ~live
        names = ["xyz", "scaling", "rotation", "opacity"] + \
            ([] if ndc is None else ["ndc_offset"])
        for name, g, w, e in zip(names, got_g, want_g, exact_g):
            g, w, e = (t.reshape(n, -1) for t in (g, w, e))
            err_pb = max(err_pb, check_scaled(
                torch, f"P' {form} d {name} ({int(well.sum())} Gaussians "
                f"with a well-conditioned det)", g[well], w[well], 1e-5,
                1e-4))
            own = (w.double() - e)[live].abs().max().item()
            off = (g - w)[live].abs().max().item()
            log(f"  P' {form} d {name}, all {int(live.sum())} with a conic: "
                f"max |kernel - plain| {off:.3e}, the plain chain's own max "
                f"{own:.3e} off float64")
            if not off <= 2 * own + 1e-5 * e[live].abs().max().item():
                fail(f"P' {form} d {name} disagrees with autograd")

    # launches and times, the stage-3 form (the bound's)
    arg = pj.camera_arg(*host)
    args = tuple(inputs.values())
    out = pj.project_gaussians_forward(arg, *args)
    needs = (True, True, True, True, False, False)

    def fwd():
        return pj.project_gaussians_forward(arg, *args)

    def bwd():
        return pj.project_gaussians_backward(arg, *args, None, cots, needs)

    def plain_fwd():
        return pj.project_plain(*args[:4], None, *dev_cam, *host[3:])

    def plain_fwd_bwd():
        leaves = [a.clone().requires_grad_(True) for a in args]
        o = pj.project_plain(*leaves, None, *dev_cam, *host[3:])
        torch.autograd.grad([getattr(o, k) for k in outputs], leaves,
                            [c.contiguous() for c in cots])
    del out
    p_launches, p_ops = device_launches(torch, fwd)
    pb_launches, pb_ops = device_launches(torch, bwd)
    plain_launches, _ = device_launches(torch, plain_fwd)
    plain_all, _ = device_launches(torch, plain_fwd_bwd)
    log(f"[projection] device launches: P {p_launches}, P' {pb_launches}; "
        f"the plain chain {plain_launches} forward (the three camera copies "
        f"not among them here: its camera is already on the card), "
        f"{plain_all - plain_launches} in autograd's backward")
    if (p_launches, pb_launches) != (1, 1):
        fail(f"P and P' launched {p_launches} and {pb_launches} device "
             f"operations, not one each: {p_ops}, {pb_ops}")
    p_ms, p_host = kernel_ms(torch, fwd)
    pb_ms, pb_host = kernel_ms(torch, bwd)
    plain_ms = median_ms(torch, plain_fwd)
    plain_all_ms = median_ms(torch, plain_fwd_bwd)
    p_bound, p_by = bound(n * P_BYTES, n * OPS_P)
    pb_bound, pb_by = bound(n * P_BWD_BYTES, n * OPS_P_BWD)
    log(f"[time] kernel P project: {p_ms:.4f} ms queued (host-launched "
        f"{p_host:.4f}), bound {p_bound:.4f} ms ({n * P_BYTES / 1e6:.1f} MB, "
        f"by {p_by}), target {P_TARGET_MS}; plain chain {plain_ms:.3f} ms "
        "host-launched")
    log(f"[time] kernel P' project_bwd: {pb_ms:.4f} ms queued (host-launched "
        f"{pb_host:.4f}), bound {pb_bound:.4f} ms "
        f"({n * P_BWD_BYTES / 1e6:.1f} MB, by {pb_by}), target "
        f"{P_TARGET_MS}; plain forward and autograd backward "
        f"{plain_all_ms:.3f} ms host-launched")
    profile_device(torch, "kernel P", fwd, p_host)
    profile_device(torch, "kernel P'", bwd, pb_host)
    profile_device(torch, "the plain projection, forward and backward",
                   plain_fwd_bwd, plain_all_ms)
    for name, ms in (("P", p_ms), ("P'", pb_ms)):
        if ms > P_TARGET_MS:
            log(f"  kernel {name}: {ms:.4f} ms queued, above the "
                f"{P_TARGET_MS} ms target")
    replaces = "none (XLA ops: texgs/kernels/project.py project_gaussians)"
    return [entry("project", "texgs_torch/csrc/project.cu", replaces,
                  launches["project"], p_ms, plain_ms, p_bound, p_by, err_p),
            entry("project_bwd", "texgs_torch/csrc/project_bwd.cu",
                  replaces + " and its autodiff", launches["project_bwd"],
                  pb_ms, plain_all_ms, pb_bound, pb_by, err_pb)]


# kernels G and G' (csrc/uvtex_rows.cu, uvtex_rows_bwd.cu): the bytes a
# Gaussian moves at E = 0, the cells' (G reads xyz, scaling, rotation, uvs,
# J, means2d, depth, conic, opacity, normal and colour, 140 B, and writes a
# table row of 64 B and a uv row of 96; G' reads those inputs but the
# colour, depth and normal, whose cotangents pass straight through, 112 B,
# and 112 of cotangents, 16 table and 12 uv-row columns, and writes 92 B of
# gradients, the colours' not wanted as in a step at SH degree 0) and the
# f32 operations a Gaussian (counted from the sources)
G_BYTES, G_BWD_BYTES = 300, 316
OPS_G, OPS_G_BWD = 110, 330


def check_columns(torch, name, got, want, rel_atol):
    """check_scaled column by column (a 1-D tensor is one column), each
    at rel_atol of its own largest |want|: on a flat disc the thin axis's
    1/s^2 (~2e17) dominates an input's largest gradient, and must set no
    tolerance for the other columns.  Returns the max abs error."""
    if got.dim() == 1:
        return check_scaled(torch, name, got, want, rel_atol, 0.0)
    return max(check_scaled(torch, f"{name}[:, {j}]", got[:, j], want[:, j],
                            rel_atol, 0.0) for j in range(got.shape[1]))


def refuse_in_plane(torch, got, want):
    """G''s d scaling with an in-plane column (the one whose largest
    |want| is smallest: not the thin axis) zeroed must fail
    check_columns' rule; logs how many values it puts beyond that rule and
    beyond one tolerance for the whole input (1e-5 of its largest)."""
    col = int(want.abs().amax(0).argmin())
    bad = got.clone()
    bad[:, col] = 0.0
    err, mag = (bad - want).abs(), want.abs()
    by_column = int((err > 1e-5 * mag.amax(0)).sum())
    by_input = int((err > 1e-5 * mag.max()).sum())
    log(f"  G' d scaling with column {col} zeroed: {by_column} values beyond "
        f"1e-5 of their column's largest (refused); {by_input} beyond 1e-5 "
        f"of the input's largest")
    if by_column == 0:
        fail("the per-column check could not refuse a G' whose in-plane "
             "scaling gradient were zero")


def rows_phase(torch, device, launches):
    """Kernels G and G' on the benchmark's stage-3 DTU scene (100,000 flat
    discs) and its first 800x600 view, projected by kernel P, its uvs
    normalize(xyz) with that map's Jacobian: the table and the uv rows
    against the plain chain (uvtex_rows_plain) bit for bit and each
    column of each gradient against autograd through it (check_columns; a
    G' with an in-plane scaling column zeroed must fail), at E = 0 (SH
    degree 0, the cells') and E = 3 (the no-SH channels); the device
    launches of both paths; the times beside the bounds.  launches:
    {"uvtex_rows": G's launches over phase 5, "uvtex_rows_bwd": G''s over
    phase 7's steps}.  Returns the two kernels' entries."""
    from benchmark import harness, program, scene
    from texgs_torch.kernels import project as pj
    from texgs_torch.kernels import uvtex_raster as kg

    cfg = harness.cell("tgs3-dtu-train")["config"]
    state, _ = scene.make_state(cfg, 0, device)
    cam = program.camera(scene.spiral_views(cfg["assumed"]["views"])[0])
    with torch.no_grad():
        rot = state["rotation"]
        xyz = state["xyz"].detach().contiguous()
        scaling = torch.exp(state["scaling"])
        rotation = rot / (torch.linalg.norm(rot, dim=-1, keepdim=True) + 1e-12)
        proj = pj.project_gaussians(
            xyz, scaling, rotation, torch.sigmoid(state["opacity"]), None,
            cam.world_view, cam.full_proj, cam.camera_center, cam.width,
            cam.height, cam.tanfovx, cam.tanfovy)
        norm = torch.linalg.norm(xyz, dim=-1, keepdim=True)
        uvs = xyz / norm
        eye = torch.eye(3, device=device)[None]
        jac = ((eye - uvs[:, :, None] * uvs[:, None, :])
               / norm[:, :, None]).reshape(-1, 9)
    n = xyz.shape[0]
    inputs = {"xyz": xyz, "scaling": scaling, "rotation": rotation,
              "uvs": uvs, "means2d": proj.means2d, "depths": proj.depths,
              "conics": proj.conics, "opacities": proj.opacities,
              "normals": proj.normals,
              "colors": torch.full((n, 3), 0.5, device=device)}
    campos = cam.camera_center
    campos_dev = torch.as_tensor(campos, device=device)
    gen = torch.Generator(device=device).manual_seed(13)
    log(f"[rows] G and G' on {n} flat discs (the DTU cells' scene), view 0 "
        f"at {cam.width}x{cam.height}: {int((proj.radii > 0).sum())} visible")
    err_g = err_gb = 0.0
    cots = {}
    for n_extra in (0, 3):
        extra = (0.1 * torch.randn((n, 3), generator=gen, device=device)
                 if n_extra else None)
        width = 16 + n_extra
        block = torch.randn((n, width + 24), generator=gen, device=device)
        cots[n_extra] = (block[:, :width], block[:, width:])

        def run(fn, where):
            leaves = {k: v.clone().requires_grad_(True)
                      for k, v in inputs.items()}
            if extra is not None:
                leaves["extra"] = extra.clone().requires_grad_(True)
            out = fn(pj.ProjectedGaussians(
                leaves["means2d"], leaves["depths"], leaves["conics"],
                proj.radii, leaves["colors"], leaves["opacities"],
                leaves["normals"]), leaves.get("extra"), leaves["xyz"],
                leaves["scaling"], leaves["rotation"], leaves["uvs"], jac,
                where)
            return out, dict(zip(leaves, torch.autograd.grad(
                out, list(leaves.values()), cots[n_extra])))
        before = (kg.uvtex_rows.launches, kg.uvtex_rows_backward.launches)
        got, got_g = run(kg.uvtex_rows, campos)
        if (kg.uvtex_rows.launches - before[0],
                kg.uvtex_rows_backward.launches - before[1]) != (1, 1):
            fail("the rows did not launch G and G' once each")
        want, want_g = run(kg.uvtex_rows_plain, campos_dev)
        torch.cuda.synchronize()
        for name, g, w in (("table", got[0], want[0]),
                           ("uv rows", got[1], want[1])):
            same = torch.equal(g, w)
            log(f"  G E = {n_extra} {name} {tuple(g.shape)}: equal to the "
                f"plain chain's bit for bit: {same}")
            if not same:
                fail(f"G E = {n_extra}: the {name} differ from the plain "
                     "chain's")
        for name in got_g:
            err_gb = max(err_gb, check_columns(
                torch, f"G' E = {n_extra} d {name}", got_g[name],
                want_g[name], 1e-5))
        if n_extra == 0:
            refuse_in_plane(torch, got_g["scaling"], want_g["scaling"])

    # launches and times, E = 0 and the gradients a step at SH 0 wants
    args = (xyz, scaling, rotation, uvs, jac, proj.means2d, proj.depths,
            proj.conics, proj.opacities, proj.normals, inputs["colors"],
            None)
    needs = (True,) * 4 + (False,) + (True,) * 5 + (False, False)
    plain_proj = proj._replace(colors=inputs["colors"])
    diff = [k for k in inputs if k != "colors"]

    def fwd():
        return kg.uvtex_rows_forward(campos, *args)

    def bwd():
        return kg.uvtex_rows_backward(campos, args, *cots[0], needs)

    def plain_fwd():
        return kg.uvtex_rows_plain(plain_proj, None, xyz, scaling, rotation,
                                   uvs, jac, campos_dev)

    def plain_fwd_bwd():
        leaves = {k: inputs[k].clone().requires_grad_(True) for k in diff}
        out = kg.uvtex_rows_plain(plain_proj._replace(
            means2d=leaves["means2d"], depths=leaves["depths"],
            conics=leaves["conics"], opacities=leaves["opacities"],
            normals=leaves["normals"]), None, leaves["xyz"],
            leaves["scaling"], leaves["rotation"], leaves["uvs"], jac,
            campos_dev)
        torch.autograd.grad(out, list(leaves.values()),
                            [c.contiguous() for c in cots[0]])
    g_launches, g_ops = device_launches(torch, fwd)
    gb_launches, gb_ops = device_launches(torch, bwd)
    plain_launches, _ = device_launches(torch, plain_fwd)
    plain_all, _ = device_launches(torch, plain_fwd_bwd)
    log(f"[rows] device launches: G {g_launches}, G' {gb_launches}; the "
        f"plain chain {plain_launches} forward (its camera centre already on "
        f"the card), {plain_all - plain_launches} in autograd's backward")
    if (g_launches, gb_launches) != (1, 1):
        fail(f"G and G' launched {g_launches} and {gb_launches} device "
             f"operations, not one each: {g_ops}, {gb_ops}")
    g_ms, g_host = kernel_ms(torch, fwd)
    gb_ms, gb_host = kernel_ms(torch, bwd)
    plain_ms = median_ms(torch, plain_fwd)
    plain_all_ms = median_ms(torch, plain_fwd_bwd)
    g_bound, g_by = bound(n * G_BYTES, n * OPS_G)
    gb_bound, gb_by = bound(n * G_BWD_BYTES, n * OPS_G_BWD)
    log(f"[time] kernel G uvtex_rows: {g_ms:.4f} ms queued (host-launched "
        f"{g_host:.4f}), bound {g_bound:.4f} ms ({n * G_BYTES / 1e6:.1f} MB, "
        f"by {g_by}); plain chain {plain_ms:.3f} ms host-launched")
    log(f"[time] kernel G' uvtex_rows_bwd: {gb_ms:.4f} ms queued "
        f"(host-launched {gb_host:.4f}), bound {gb_bound:.4f} ms "
        f"({n * G_BWD_BYTES / 1e6:.1f} MB, by {gb_by}); plain forward and "
        f"autograd backward {plain_all_ms:.3f} ms host-launched")
    profile_device(torch, "kernel G", fwd, g_host)
    profile_device(torch, "kernel G'", bwd, gb_host)
    profile_device(torch, "the plain rows, forward and backward",
                   plain_fwd_bwd, plain_all_ms)
    replaces = ("none (XLA ops: texgs/kernels/uvtex_raster.py "
                "build_uvtex_tables, build_uv_rows; tile_raster.py "
                "build_gauss_table)")
    return [entry("uvtex_rows", "texgs_torch/csrc/uvtex_rows.cu", replaces,
                  launches["uvtex_rows"], g_ms, plain_ms, g_bound, g_by,
                  err_g),
            entry("uvtex_rows_bwd", "texgs_torch/csrc/uvtex_rows_bwd.cu",
                  replaces + " and their autodiff", launches["uvtex_rows_bwd"],
                  gb_ms, plain_all_ms, gb_bound, gb_by, err_gb)]


# csrc/adam.cu: an element reads p, g, m and v and writes p, m and v (24 B
# without a gradient), in ~12 f32 operations; the target for stage 3's
# three launches
ADAM_BYTES, ADAM_BYTES_NO_GRAD, OPS_ADAM = 28, 24, 12
ADAM_TARGET_MS = 0.30


def adam_phase(torch, device, launches):
    """Phase 4d (see the module docstring).  launches: the kernel's
    launches over phase 7's steps.  Returns its entry."""
    from benchmark import harness, program, scene
    from benchmark.drivers import train_loop
    from texgs_torch import _build
    from texgs_torch.train import optim

    cfg = harness.cell("tgs3-dtu-train")["config"]
    state, _ = scene.make_state(cfg, 0, device)
    hy = train_loop.hyper(cfg, scene.spiral_views(cfg["assumed"]["views"]))
    model = program.build_model(cfg, state, hy, device, train=True)
    del state
    groups = [(model.adam_g, model._gauss_leaves()),
              (model.adam_uv, model._uv_leaves()),
              (model.adam_tex, model._tex_leaves())]
    gen = torch.Generator(device=device).manual_seed(25)
    lrs, n_bytes, n_elems, n_no_grad = [], 0, 0, 0
    for _, leaves in groups:
        lrs.append({})
        for i, (k, p) in enumerate(leaves.items()):
            lrs[-1][k] = 1e-4 * (1 + i % 7)
            p.grad = (None if k.startswith("inv_uv_net.") else
                      1e-3 * torch.randn(p.shape, generator=gen,
                                         device=device))
            n_no_grad += p.grad is None
            n_elems += p.numel()
            n_bytes += p.numel() * (ADAM_BYTES_NO_GRAD if p.grad is None
                                    else ADAM_BYTES)
    counts = [sorted(set(adam.count.values())) for adam, _ in groups]
    log(f"[adam] the Adam kernel on the stage-3 cell's "
        f"{sum(len(lv) for _, lv in groups)} leaves in 3 Adams "
        f"({n_elems / 1e6:.2f} M elements, {n_no_grad} leaves without a "
        f"gradient), step counts {counts}")
    # the plain chain's arguments on copies: (p, g, m, v, lr, count)
    plain = {k: [p.clone(), p.grad, adam.mu[k].clone(), adam.nu[k].clone(),
                 lr[k], adam.count[k]]
             for (adam, leaves), lr in zip(groups, lrs)
             for k, p in leaves.items()}

    def kernel_step():
        for (adam, leaves), lr in zip(groups, lrs):
            adam.step(leaves, lr)

    def plain_step():
        for args in plain.values():
            optim.adam_plain(*args)

    before = optim.adam_step.launches
    for _ in range(2):
        kernel_step()
        for args in plain.values():
            args[5] += 1
        plain_step()
    torch.cuda.synchronize()
    if optim.adam_step.launches - before != 6:
        fail(f"two steps of the three Adams launched the kernel "
             f"{optim.adam_step.launches - before} times, not 6")
    off = [k for (adam, leaves) in groups for k, p in leaves.items()
           if not (torch.equal(p, plain[k][0])
                   and torch.equal(adam.mu[k], plain[k][2])
                   and torch.equal(adam.nu[k], plain[k][3]))]
    log(f"  two steps: every parameter and moment equal to the plain "
        f"chain's bit for bit: {not off}")
    if off:
        fail(f"the Adam kernel differs from the plain chain on {off}")

    k_launches, k_ops = device_launches(torch, kernel_step)
    p_launches, _ = device_launches(torch, plain_step)
    log(f"[adam] device launches of the three Adams: kernel {k_launches} "
        f"({k_ops}), the plain chain {p_launches}")
    if k_launches != 3:
        fail(f"the three Adams launched {k_launches} device operations, "
             "not 3")
    ms, host_ms = kernel_ms(torch, kernel_step)
    plain_ms, plain_host_ms = kernel_ms(torch, plain_step)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(REPS):
        kernel_step()
    host_us = (time.perf_counter() - t0) / REPS * 1e6
    torch.cuda.synchronize()
    a_bound, a_by = bound(n_bytes, n_elems * OPS_ADAM)
    log(f"[time] the Adam kernel, stage 3's three launches: {ms:.4f} ms "
        f"queued (host-launched {host_ms:.4f}; Adam.step's host time "
        f"{host_us:.0f} us for the three), bound {a_bound:.4f} ms "
        f"({n_bytes / 1e6:.1f} MB, by {a_by}), target {ADAM_TARGET_MS}; "
        f"plain chain {plain_ms:.4f} ms queued (host-launched "
        f"{plain_host_ms:.3f})")
    if ms > ADAM_TARGET_MS:
        log(f"  the kernel is above its {ADAM_TARGET_MS} ms target")
    profile_device(torch, "the Adam kernel, three Adams", kernel_step,
                   host_ms)
    profile_device(torch, "the plain Adam chain, three Adams",
                   plain_step, plain_host_ms)
    report = _build.library_path("adam")
    report = report.with_name(report.name + ".log")
    for line in (report.read_text().splitlines() if report.exists() else
                 ["(no report: the library was built before this run)"]):
        if "registers" in line or "spill" in line or "stack" in line or \
                "(no report" in line:
            log(f"  adam ptxas: {line.strip()}")
    del model, groups, plain
    torch.cuda.empty_cache()
    return entry("adam", "texgs_torch/csrc/adam.cu",
                 "none (XLA ops: texgs/train/optim.py update)", launches,
                 ms, plain_ms, a_bound, a_by, 0.0)


def main(argv=None) -> int:
    import argparse

    import torch

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--golden-seeds", default=None,
                        help="comma-separated training seeds: run only the "
                             "golden phase, once for each")
    parser.add_argument("--golden-m", type=int, default=GOLDEN_M,
                        help="stage 3's M-list length in those runs")
    parser.add_argument("--dist", action="store_true",
                        help="run phases 1-3 and 23 (texgs_torch.dist) only")
    parser.add_argument("--prod-full", action="store_true",
                        help="run phases 1 and 2, then the production "
                             "pipeline at its full schedules only")
    args = parser.parse_args(argv)

    # ---------------------------------------------------------- 1. device
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke "
              "run needs an NVIDIA GPU", file=sys.stderr)
        return 2
    from texgs_torch import _build  # importing the package turns TF32 off
    from texgs_torch.data.synthetic import orbit_cameras
    from texgs_torch.kernels.cubemap import (chessboard_cubemap, cubemap_maps,
                                             cubemap_to_latlong, faces_to_cross,
                                             sample_cubemap)
    from texgs_torch.kernels import project as pj
    from texgs_torch.kernels import uvtex_raster as kg
    from texgs_torch.kernels.tex_term import mlist_tex_term, tex_term
    from texgs_torch.kernels.tile_raster import N_FIXED_F, TABLE_FIXED
    from texgs_torch.kernels.uvtex_fused import fused_pairs, mlist_scan
    from texgs_torch.utils.sh import sh02rgb

    device = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    log(f"[device] {kind}, {torch.cuda.device_count()} card(s); torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}")
    log(f"[device] nvidia-smi: {card}")
    if args.golden_seeds is not None:
        with tempfile.TemporaryDirectory() as work_dir:
            runs = [(seed, golden_phase(torch, device, f"{work_dir}/{i}",
                                        seed, args.golden_m))
                    for i, seed in enumerate(
                        map(int, args.golden_seeds.split(",")))]
        log(json.dumps({"golden": runs, "m": args.golden_m, "card": card}))
        for seed, run in runs:
            check_golden(seed, run)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": kind,
            "count": torch.cuda.device_count()}}), flush=True)
        return 0

    # ----------------------------------------------------------- 2. build
    t0 = time.perf_counter()
    reports = _build.build()
    log(f"[build] {len(reports)} kernels in {time.perf_counter() - t0:.1f} s")
    for name, report in reports.items():
        for line in report.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    if args.prod_full:
        with tempfile.TemporaryDirectory() as work_dir:
            record = prod_pipeline_phase(torch, device, work_dir, card,
                                         full=True)
        log(json.dumps(record))
        log(card)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": kind,
            "count": torch.cuda.device_count()}}), flush=True)
        return 0

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
    if args.dist:
        with torch.no_grad():
            v = model.visual_step(0, 1, cams[0])
        del model
        torch.cuda.empty_cache()
        with tempfile.TemporaryDirectory() as work_dir:
            dist_phase(torch, device, sd0, cams,
                       {k: v[k] for k in ("image", "alpha", "norm")},
                       work_dir, card)
        log(card)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": kind,
            "count": torch.cuda.device_count()}}), flush=True)
        return 0
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
        # the order in which A takes the tiles changes no output bit
        if pairs.tile_order is None:
            fail("the render handed kernel A a pair list without its tile "
                 "order")
        in_launch_order = fused_pairs(table, uv_rows, pairs._replace(
            tile_order=torch.arange(pairs.tile_counts.numel(), device=device)),
            *a_args[3:])
        same = [torch.equal(x, y) for x, y in zip(got_a, in_launch_order)]
        log(f"  A with its tiles in launch order: blend, T_final, M-lists, "
            f"n_eval equal to the heaviest-first outputs bit for bit: {same}")
        if not all(same):
            fail("kernel A's outputs depend on the order it takes the tiles "
                 "in")

        got_b = tex_term(*b_args)
        want_b = mlist_tex_term(*b_args)
        err_b = check_close(torch, "B texture term (main-path M-lists)",
                            got_b, want_b, atol=2e-5, rtol=1e-4)
        check_dead_nan(torch, "B (main-path M-lists)", mlist,
                       mlist[..., 0] != 0, got_b,
                       lambda ml: tex_term(ml, *b_args[1:]))
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
        # one thread a slot: at m = 1, 4 and 33 a warp straddles pixels
        for sm in (1, 4, 33):
            ml, live = live_count_mlist(12, sm, device, torch, seed=sm)
            for mode in ("bilinear", "nearest", "bilinear_clamp"):
                got = tex_term(ml, small_tex, 40, 56, mode)
                err_b = max(err_b, check_close(
                    torch, f"B m = {sm} (0, 1, 31, m live slots), {mode}",
                    got, mlist_tex_term(ml, small_tex, 40, 56, mode),
                    atol=2e-5, rtol=1e-4))
                check_dead_nan(torch, f"B m = {sm}, {mode}", ml, live, got,
                               lambda x, mode=mode: tex_term(
                                   x, small_tex, 40, 56, mode))
        # kernel M: visual_step's maps of the model's texture
        rgb = sh02rgb(texture)
        want_maps = (cubemap_to_latlong(rgb, PANORAMA), faces_to_cross(rgb))
        del rgb
        got_maps = (cubemap_maps(texture, PANORAMA), cubemap_maps(texture))
        torch.cuda.synchronize()
        same = torch.equal(got_maps[1], want_maps[1])
        log(f"  M cross image {tuple(got_maps[1].shape)}: equal to the plain "
            f"chain's bit for bit: {same}")
        if not same:
            fail("kernel M's cross image differs from its plain version")
        err_m = check_close(torch, f"M panorama {PANORAMA}", got_maps[0],
                            want_maps[0], atol=1e-6)
        del want_maps
        # the end-to-end image of view 0 with the plain versions swapped in
        plain_image = plain_render(model, cams[0])["render"]

    # ------------------------------------------------------ 5. main path
    chess = faces_to_cross(chessboard_cubemap(TEX_RES // 16, 16, device=device))
    main_counters = {"uvtex_fused": fused_pairs, "tex_term": tex_term,
                     "cubemap_maps": cubemap_maps,
                     "project": pj.project_gaussians,
                     "project_bwd": pj.project_gaussians_backward,
                     "uvtex_rows": kg.uvtex_rows,
                     "uvtex_rows_bwd": kg.uvtex_rows_backward}
    for fn in main_counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    views, retextured = [], []
    for c in cams:
        views.append(model.visual_step(0, 1, c))
    model.change_texture(chess, mode=0)
    for c in cams:
        retextured.append(model.visual_step(0, 1, c))
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in main_counters.items()}
    log(f"[main] {2 * N_VIEWS} views (3 + 3 retextured) in {main_s:.3f} s; "
        f"launches {launches}")
    # a view renders once, under no_grad (no P' or G'), and makes two maps
    a_view = {"cubemap_maps": 2, "project_bwd": 0, "uvtex_rows_bwd": 0}
    for name, n in launches.items():
        if n != a_view.get(name, 1) * 2 * N_VIEWS:
            fail(f"kernel {name} launched {n} times on the main path, "
                 f"expected {a_view.get(name, 1)} a view "
                 f"({a_view.get(name, 1) * 2 * N_VIEWS})")

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

        def maps():
            return cubemap_maps(texture, PANORAMA), cubemap_maps(texture)

        def plain_maps():
            rgb = sh02rgb(texture)
            return cubemap_to_latlong(rgb, PANORAMA), faces_to_cross(rgb)
        m_ms, m_host = kernel_ms(torch, maps)
        m_plain_ms, m_plain_host = kernel_ms(torch, plain_maps)

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
        # M reads the texture once and writes both maps once
        m_bytes = nbytes(texture, *got_maps)
        m_bound, m_by = bound(m_bytes, PANORAMA[0] * PANORAMA[1] * OPS_M_PIXEL)
    log(f"[time] kernel A uvtex_fused: {a_ms:.4f} ms (host-launched "
        f"{a_host:.4f}), plain {a_plain_ms:.3f} ms, "
        f"bound {a_bound:.4f} ms ({a_bytes / 1e6:.1f} MB, "
        f"{a_ops / 1e9:.3f} GFLOP)")
    log(f"[time] kernel B tex_term: {b_ms:.4f} ms (host-launched "
        f"{b_host:.4f}), plain {b_plain_ms:.3f} ms, "
        f"bound {b_bound:.4f} ms ({b_bytes / 1e6:.1f} MB incl. {texels} "
        f"texels touched, {live_slots} live slots)")
    log(f"[time] kernel M cubemap_maps (both maps, 2 launches): {m_ms:.4f} "
        f"ms (host-launched {m_host:.4f}), plain chain {m_plain_ms:.3f} ms "
        f"queued (host-launched {m_plain_host:.3f}), bound {m_bound:.4f} ms "
        f"({m_bytes / 1e6:.1f} MB)")
    with torch.no_grad():
        profile_device(torch, "kernel M, both maps", maps, m_host)
        profile_device(torch, "the maps' plain chain", plain_maps,
                       m_plain_host)

    kernels = [
        entry("uvtex_fused", "texgs_torch/csrc/uvtex_fused.cu",
              "texgs/kernels/pallas_uvtex_fused.py:263",
              launches["uvtex_fused"], a_ms, a_plain_ms, a_bound, a_by, err_a),
        entry("tex_term", "texgs_torch/csrc/tex_term.cu",
              "texgs/kernels/pallas_textile.py:774", launches["tex_term"],
              b_ms, b_plain_ms, b_bound, b_by, err_b),
        entry("cubemap_maps", "texgs_torch/csrc/cubemap_maps.cu",
              "none (XLA ops: texgs/kernels/cubemap.py:209, "
              "texgs/train/texture_gaussian3d.py:610)",
              launches["cubemap_maps"], m_ms, m_plain_host, m_bound, m_by,
              err_m),
    ]
    with torch.no_grad():
        profile_device(torch, "one render of view 0",
                       lambda: model.render(cams[0]), render_ms)

    entries, step_ms, step3_launches, train_launches = train_phases(
        torch, model, cams, views)
    kernels += entries

    # --------------------------------------------------- 4b. projection
    kernels += projection_phase(torch, device, {
        "project": launches["project"],
        "project_bwd": train_launches["project_bwd"]})
    # ------------------------------------------------------------ 4c. rows
    kernels += rows_phase(torch, device, {
        "uvtex_rows": launches["uvtex_rows"],
        "uvtex_rows_bwd": train_launches["uvtex_rows_bwd"]})
    # ------------------------------------------------------------ 4d. adam
    kernels.append(adam_phase(torch, device, train_launches["adam"]))
    del model, a_args, b_args, got_a, want_a, got_b, want_b, got_maps
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as work_dir:
        stage1, s1_views, entries = stage1_phases(torch, device, work_dir)
        kernels += entries
        step2_launches = stage2_phase(torch, device, stage1, s1_views,
                                      work_dir)
        del stage1, s1_views
        torch.cuda.empty_cache()
        driver_phase(work_dir, device)
        check_golden(0, golden_phase(torch, device, work_dir))
        formats_phase(torch, device, work_dir)
        prod_scene_phase(torch, device, work_dir, card)
        torch.cuda.empty_cache()
        model, entries = two_kernel_phases(torch, device, sd0, cams, views,
                                           retextured, chess, render_ms,
                                           step_ms)
        kernels += entries
        # view 0's fused image, alpha and normals: phase 23's ground truth
        gt0 = {k: views[0][k] for k in ("image", "alpha", "norm")}
        del views, retextured
        torch.cuda.empty_cache()
        tools_phase(torch, device, model, work_dir)
        del model
        torch.cuda.empty_cache()
        measure_phase(torch, device, work_dir)
        torch.cuda.empty_cache()
        dist_phase(torch, device, sd0, cams, gt0, work_dir, card)
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        pipeline = prod_pipeline_phase(torch, device, work_dir, card)
        log(f"[pipeline] phase 24 in {time.perf_counter() - t0:.1f} s: "
            + json.dumps(pipeline["metrics"]))
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
