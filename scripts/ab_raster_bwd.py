#!/usr/bin/env python3
"""A/B timing of kernels 1' and 2' (and A') against variants of themselves
and against another tree's sources, on an NVIDIA H100.

Run from the repository root on a machine with the card:

    python3 scripts/ab_raster_bwd.py [--parent DIR]

DIR is the root of another checkout of the repository (the parent commit
unpacked with `git archive` into the git-ignored build/, say); its
texgs_torch/csrc sources are built as the variant "parent" of each kernel.

Captures the arguments the main paths hand the backward kernels, as
chip_smoke.py does: kernel 1' at F = 7 from one stage-1 step (configs/
prod_stage1.yaml, 50,000 Gaussians, 800x600); A' from one step of the
flagship stage-3 model's joint phase (100,000 Gaussians, m = 32, F = 10);
1' at F = 10 and 2' from one step of the same model on the two-kernel path
(`backend: pallas`).  Each variant in VARIANTS is a kernel's source with a
few text substitutions, compiled with texgs_torch._build's flags (ptxas
reports printed: registers, shared memory, spills) and checked against the
committed source's output by column group (chip_smoke's tolerances).  Then
each kernel's variants are timed in turns, first to last and last to first
("parent" first), each turn the median of 5 queued CUDA-event timings of
the wrapper (chip_smoke.median_ms), and once under torch.profiler: the
kernel's own device time and the wrapper's other device work (the fills
that zero its outputs).  Needs one card and imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))

# 1' runs without a register bound, 2' with A''s (at most 64 registers)
BOUNDED = [("__launch_bounds__(PIX)", "__launch_bounds__(PIX, 4)")]
UNBOUNDED = [("__launch_bounds__(PIX, 4)", "__launch_bounds__(PIX)")]
# blocks take the tiles in launch order instead of heaviest first
LAUNCH_ORDER = [("const int tile = static_cast<int>(tile_order[blockIdx.x]);",
                 "const int tile = blockIdx.x;")]
VARIANTS = {
    "raster_bwd": {"committed": [], "bounded": BOUNDED,
                   "launch_order": LAUNCH_ORDER},
    "uvtex_mlist_bwd": {"committed": [], "unbounded": UNBOUNDED,
                        "launch_order": LAUNCH_ORDER},
    # the shared reduce-scatter moved into warp_reduce.cuh: the parent's
    # A' against this tree's
    "uvtex_fused_bwd": {"committed": []},
}
# a parent whose kernels 1' and 2' take no tile order: their C entries gain
# an argument they ignore, so that this tree's wrappers call them
PARENT = {
    "raster_bwd": [("const void* tile_end, int n_tiles, int gx,\n",
                    "const void* tile_end, const void*, int n_tiles, "
                    "int gx,\n")],
    "uvtex_mlist_bwd": [("const void* tile_end, const float* rays9,",
                         "const void* tile_end, const void*, "
                         "const float* rays9,")],
    "uvtex_fused_bwd": [],
}
# the kernel function each library launches, as torch.profiler names it
KERNEL_NAMES = {"raster_bwd": "raster_bwd", "uvtex_mlist_bwd": "mlist_backward",
                "uvtex_fused_bwd": "fused_backward"}


def profile_call(torch, cs, fn, kernel_name, reps):
    """torch.profiler over `reps` calls of fn after a spin kernel (not
    counted): (the named kernel's mean device ms a call, {other device
    operation: (ms a call, launches a call)})."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(cs.QUEUE_CYCLES)
        torch.cuda.synchronize()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    kernel_ms, other = None, {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA or "spin_kernel" in e.key:
            continue
        if kernel_name in e.key:
            kernel_ms = e.device_time_total / 1e3 / e.count
        else:
            other[e.key[:60]] = (e.device_time_total / 1e3 / reps,
                                 e.count / reps)
    return kernel_ms, other


def stage1_capture(torch, cs, device):
    """The arguments one stage-1 step (chip_smoke's phase 11) hands 1'."""
    from texgs_torch.config import Cfg
    from texgs_torch.data.synthetic import (orbit_cameras,
                                            textured_sphere_point_cloud)
    from texgs_torch.io.ply import read_pcd, write_ply_xyz
    from texgs_torch.kernels import raster as kr
    from texgs_torch.train.gaussian3d import Gaussian3D

    pcd = textured_sphere_point_cloud(cs.N_STAGE1, seed=0)
    cams = orbit_cameras(cs.STAGE1_VIEWS, radius=3.5, width=cs.WIDTH,
                         height=cs.HEIGHT, spiral=True)
    views = cs.spiral_ground_truth(torch, device, pcd, cams)
    model = Gaussian3D(Cfg(cs.STAGE1_MODEL_CFG), device=device)
    train_cfg = Cfg(cs.STAGE1_TRAIN_CFG)
    model.bind_train_cfg(train_cfg, [0, 0, 0])
    with tempfile.TemporaryDirectory() as work_dir:
        ply = f"{work_dir}/points3d.ply"
        write_ply_xyz(ply, pcd.points, colors=pcd.colors)
        model.initialize(read_pcd(ply), cs.SPATIAL_LR_SCALE)
    model.setup_optim(Cfg(cs.STAGE1_OPTIM_CFG))
    model.active_sh_degree = cs.STAGE1_SH_DEGREE
    it = cs.STAGE1_FIRST_ITER
    seen = {}
    with cs.recording(kr, "raster_pairs_backward", seen):
        model.compute_loss(it, 7500, views[it % len(views)], None,
                           Cfg(cs.STAGE1_LOSS_CFG))
    return seen["raster_pairs_backward"]


def stage3_captures(torch, cs, device):
    """The arguments one fused-path step hands A' and one two-kernel step
    hands 1' (F = 10) and 2' (chip_smoke's phases 7 and 17)."""
    from texgs_torch.config import Cfg
    from texgs_torch.data.synthetic import orbit_cameras
    from texgs_torch.kernels import raster as kr
    from texgs_torch.kernels import uvtex_fused as kf
    from texgs_torch.kernels import uvtex_mlist as km
    from texgs_torch.kernels.cubemap import chessboard_cubemap, faces_to_cross
    from texgs_torch.train.texture_gaussian3d import from_jax_state

    model, _ = cs.build_model(torch, device)
    sd0 = model.state_dict()
    cams = orbit_cameras(cs.N_VIEWS, radius=3.5, width=cs.WIDTH,
                         height=cs.HEIGHT)
    with torch.no_grad():
        views = [model.visual_step(0, 1, c) for c in cams]
    chess = faces_to_cross(chessboard_cubemap(cs.TEX_RES // 16, 16,
                                              device=device))
    seen = {}
    for backend in ("fused", "pallas"):
        if backend == "pallas":
            model = from_jax_state(sd0, Cfg(dict(cs.MODEL_CFG,
                                                 backend="pallas")),
                                   device=device)
            model.bind_train_cfg(None, cs.MODEL_CFG["background"])
        model.change_texture(chess, mode=0)
        step = cs.stage3_stepper(model, cams, views)
        with cs.recording(kf, "fused_pairs_backward", seen), \
                cs.recording(kr, "raster_pairs_backward", seen), \
                cs.recording(km, "mlist_pairs_backward", seen):
            step(cs.FIRST_ITER)
    return (seen["fused_pairs_backward"], seen["raster_pairs_backward"],
            seen["mlist_pairs_backward"])


def main() -> int:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--parent", help="root of another checkout, whose "
                        "kernel sources are built as the variant 'parent'")
    opts = parser.parse_args()
    if not torch.cuda.is_available():
        print("ab_raster_bwd: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from ab_fused_bwd import build_variants
    from texgs_torch import _build
    from texgs_torch.kernels import binning
    from texgs_torch.kernels import raster as kr
    from texgs_torch.kernels import uvtex_fused as kf
    from texgs_torch.kernels import uvtex_mlist as km

    device = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"[device] {card}", flush=True)
    out_dir = ROOT / "build" / "texgs_torch" / "ab_raster_bwd"
    libs = {}
    for source, variants in VARIANTS.items():
        variants = dict(variants)
        csrc = {}
        if opts.parent:
            variants = {"parent": PARENT[source], **variants}
            csrc["parent"] = Path(opts.parent) / "texgs_torch" / "csrc"
        libs[source] = build_variants(source, variants, out_dir, csrc)

    captures = {}
    s1 = stage1_capture(torch, cs, device)
    with torch.no_grad():
        fwd = kr.raster_pairs_forward(*s1[:3])
    captures["1' F=7 (stage 1)"] = ("raster_bwd", s1[1], (*s1[:3], *fwd[:2],
                                                          *s1[5:]))
    a_args, r_args, m_args = stage3_captures(torch, cs, device)
    captures["1' F=10 (two-kernel)"] = ("raster_bwd", r_args[1], r_args)
    captures["2' (two-kernel)"] = ("uvtex_mlist_bwd", m_args[2], m_args)
    with torch.no_grad():
        fwd = kf.fused_pairs_forward(*a_args[:6])
    captures["A' (fused)"] = ("uvtex_fused_bwd", a_args[2],
                              (*a_args[:6], *fwd[:3], *a_args[9:]))
    wrappers = {"raster_bwd": kr.raster_pairs_backward,
                "uvtex_mlist_bwd": km.mlist_pairs_backward,
                "uvtex_fused_bwd": kf.fused_pairs_backward}

    def check(source, got, want, label):
        if source == "uvtex_fused_bwd":
            return cs.check_a_backward(torch, got, want, label=label)
        if source == "raster_bwd":
            groups = {"quad": list(range(6)),
                      "channels": [*range(7, 14), *range(16, got.shape[1])]}
            return max(cs.check_scaled(torch, f"{label} {g}", got[:, c],
                                       want[:, c], 1e-3, 1e-3,
                                       cs.MAX_OFF_GAUSSIANS, rows=True)
                       for g, c in groups.items())
        return max(cs.check_scaled(torch, f"{label} quad", got[0][:, :6],
                                   want[0][:, :6], 1e-3, 1e-3,
                                   cs.MAX_OFF_GAUSSIANS, rows=True),
                   cs.check_scaled(torch, f"{label} uv rows", got[1][:, :12],
                                   want[1][:, :12], 1e-3, 1e-3,
                                   cs.MAX_OFF_GAUSSIANS, rows=True))

    for label, (source, pairs, args) in captures.items():
        counts = pairs.tile_counts
        print(f"[capture] {label}: {int(pairs.n_pairs)} pairs over "
              f"{counts.numel()} tiles (mean {counts.float().mean().item():.1f},"
              f" max {int(counts.max())})", flush=True)

        def call(name, source=source, args=args):
            _build._loaded[source] = libs[source][name]
            return wrappers[source](*args)

        names = list(libs[source])
        with torch.no_grad():
            want = call("committed")
            for name in names:
                if name != "committed":
                    check(source, call(name), want,
                          f"{label} {name} vs committed")
            times = {name: [] for name in names}
            for name in names + names[::-1]:
                times[name].append(cs.median_ms(torch, lambda: call(name),
                                                queued=True))
            for name in names:
                t = times[name]
                k_ms, other = profile_call(torch, cs, lambda: call(name),
                                           KERNEL_NAMES[source], cs.REPS)
                rest = "; ".join(f"{k} {ms:.4f} ms x{n:g}"
                                 for k, (ms, n) in other.items())
                k_txt = "not seen" if k_ms is None else f"{k_ms:.4f} ms"
                print(f"[time] {label} {name}: queued {t[0]:.4f} and "
                      f"{t[1]:.4f} ms (median of {cs.REPS} each turn), "
                      f"profiler kernel {k_txt}; other device work a call: "
                      f"{rest or 'none'}", flush=True)
            # the gradients the wrapper zeroes: the table's, and the uv
            # rows' for 2' and A'
            fills = args[:1] if source == "raster_bwd" else args[:2]
            fill_ms = cs.median_ms(
                torch, lambda: [torch.zeros_like(a) for a in fills],
                queued=True)
            sort_ms = cs.median_ms(
                torch, lambda: binning.heaviest_first(counts), queued=True)
            sort_n, _ = cs.device_launches(
                torch, lambda: binning.heaviest_first(counts))
        print(f"[time] {label}: the wrapper's zero fills alone "
              f"({len(fills)}) {fill_ms:.4f} ms queued; the heaviest-first "
              f"order (once per pair list) {sort_ms:.4f} ms queued, "
              f"{sort_n} device launches; pair list has it: "
              f"{pairs.tile_order is not None}",
              flush=True)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
