#!/usr/bin/env python3
"""A/B timing of kernel 1 (texgs_torch/csrc/raster.cu, the forward blend)
against variants of itself and against another tree's sources, on an
NVIDIA H100.

Run from the repository root on a machine with the card:

    python3 scripts/ab_raster_fwd.py [--parent DIR]

DIR is the root of another checkout of the repository (the parent commit
unpacked with `git archive` into the git-ignored build/, say); its
texgs_torch/csrc sources are built as the variant "parent".

Captures the arguments the main paths hand kernel 1, as chip_smoke.py
does: at F = 7 from one stage-1 step (configs/prod_stage1.yaml, 50,000
Gaussians, 800x600; the step sets the pair list's heaviest-first tile
order), and at F = 10 from the render of view 0 of the flagship stage-3
model on the two-kernel path (`backend: pallas`).
Each variant in VARIANTS is raster.cu with a few text substitutions (the
look-ahead group size, a register bound), compiled with texgs_torch._build's flags (ptxas
reports printed: registers, shared memory, spills), and every variant's
blend, T_final and n_eval must equal the committed kernel's bit for bit,
in both tile orders.  Each capture's variants are then timed with the
tiles heaviest first and in launch order, in turns, first to last and last
to first ("parent" first), each turn the median of 5 queued CUDA-event
timings of the wrapper (chip_smoke.median_ms), and once under
torch.profiler (the kernel's own device time).  Last, the sort that sets
the order (binning.heaviest_first) is timed alone, and the two-kernel
render of view 0 with it (the committed tree) and without it, kernel 1
taking the tiles in launch order, in turns (wall and device time).
Needs one card and imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))

LOOK = "constexpr int LOOK = 8;"
BOUNDS = "__launch_bounds__(PIX)\n    raster_fwd("
VARIANTS = {"committed": [],
            **{f"look_{n}": [(LOOK, f"constexpr int LOOK = {n};")]
               for n in (1, 2, 4, 16)},
            # asked to fit 6 or 8 blocks of 256 threads an SM (at most 40
            # or 32 registers; the committed kernel's 49-51 fit 5)
            **{f"blocks_{n}": [(BOUNDS, f"__launch_bounds__(PIX, {n})\n"
                                "    raster_fwd(")] for n in (6, 8)}}
# a parent whose kernel 1 takes no tile order: its C entry gains an
# argument it ignores, so that this tree's wrapper calls it
PARENT = [("const void* tile_end, int n_tiles, int gx,\n",
           "const void* tile_end, const void*, int n_tiles, int gx,\n")]
ORDERS = ("heaviest first", "launch order")


def two_kernel_capture(torch, cs, device):
    """The arguments the two-kernel render of view 0 hands kernel 1 (F =
    10), the model and its cameras."""
    from texgs_torch.config import Cfg
    from texgs_torch.data.synthetic import orbit_cameras
    from texgs_torch.kernels import raster as kr
    from texgs_torch.train.texture_gaussian3d import from_jax_state

    model, _ = cs.build_model(torch, device)
    model = from_jax_state(model.state_dict(),
                           Cfg(dict(cs.MODEL_CFG, backend="pallas")),
                           device=device)
    model.bind_train_cfg(None, cs.MODEL_CFG["background"])
    cams = orbit_cameras(cs.N_VIEWS, radius=3.5, width=cs.WIDTH,
                         height=cs.HEIGHT)
    seen = {}
    with torch.no_grad(), cs.recording(kr, "raster_pairs", seen):
        model.render(cams[0])
    return seen["raster_pairs"], model, cams


def device_ms(torch, cs, fn, reps):
    """torch.profiler over `reps` calls of fn after a spin kernel (not
    counted): the device time of one call, all its kernels and copies."""
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
    return sum(e.device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and "spin_kernel" not in e.key) / 1e3 / reps


@contextlib.contextmanager
def unsorted_renders(torch, cs, uvr, kr):
    """The two-kernel render without the heaviest-first sort: it hands
    kernel 1 its pair list as built, and kernel 1's wrapper passes a cached
    arange (no device work)."""
    cache = {}

    def arange(name, pairs, device):
        n = pairs.tile_counts.numel()
        if n not in cache:
            cache[n] = torch.arange(n, device=device)
        return cache[n]

    with cs.swapped(kr, "tile_order_arg", arange), \
            cs.swapped(uvr, "with_tile_order", lambda pairs: pairs):
        yield


def main() -> int:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--parent", help="root of another checkout, whose "
                        "kernel sources are built as the variant 'parent'")
    opts = parser.parse_args()
    if not torch.cuda.is_available():
        print("ab_raster_fwd: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from ab_fused_bwd import build_variants
    from ab_raster_bwd import profile_call, stage1_capture
    from texgs_torch import _build
    from texgs_torch.kernels import binning
    from texgs_torch.kernels import raster as kr
    from texgs_torch.kernels import uvtex_raster as uvr

    device = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"[device] {card}", flush=True)
    variants, csrc = dict(VARIANTS), {}
    if opts.parent:
        variants = {"parent": PARENT, **variants}
        csrc["parent"] = Path(opts.parent) / "texgs_torch" / "csrc"
    libs = build_variants("raster", variants, ROOT / "build" / "texgs_torch"
                          / "ab_raster_fwd", csrc)

    s1 = stage1_capture(torch, cs, device)
    r_args, model, cams = two_kernel_capture(torch, cs, device)
    captures = {"1 F=7 (stage-1 step)": s1[:3],
                "1 F=10 (two-kernel view 0)": r_args}
    for label, (table, pairs, gx) in captures.items():
        counts = pairs.tile_counts
        print(f"[capture] {label}: {int(pairs.n_pairs)} pairs over "
              f"{counts.numel()} tiles (mean {counts.float().mean().item():.1f},"
              f" max {int(counts.max())}); tile order set: "
              f"{pairs.tile_order is not None}", flush=True)
        ordered = {"heaviest first": binning.with_tile_order(pairs),
                   "launch order": pairs._replace(tile_order=torch.arange(
                       counts.numel(), device=device))}

        def call(name, order, table=table, gx=gx, ordered=ordered):
            _build._loaded["raster"] = libs[name]
            return kr.raster_pairs_forward(table, ordered[order], gx)

        names = list(libs)
        with torch.no_grad():
            want = call("committed", ORDERS[0])
            print(f"  {int(want[2].sum())} evaluated (pixel, pair) entries",
                  flush=True)
            for name in names:
                for order in ORDERS:
                    same = [torch.equal(a, b)
                            for a, b in zip(call(name, order), want)]
                    print(f"  {name}, {order}: blend, T_final, n_eval equal to "
                          f"the committed kernel's bit for bit: {same}",
                          flush=True)
                    if not all(same):
                        cs.fail(f"{label}: kernel 1 {name} ({order}) differs")
            runs = [(n, o) for n in names for o in ORDERS]
            times = {run: [] for run in runs}
            for run in runs + runs[::-1]:
                times[run].append(cs.median_ms(torch, lambda: call(*run),
                                               queued=True))
            for run in runs:
                k_ms, _ = profile_call(torch, cs, lambda: call(*run),
                                       "raster_fwd", cs.REPS)
                t = times[run]
                k_txt = "not seen" if k_ms is None else f"{k_ms:.4f} ms"
                print(f"[time] {label} {run[0]}, {run[1]}: queued "
                      f"{t[0]:.4f} and {t[1]:.4f} ms (median of {cs.REPS} "
                      f"each turn), profiler kernel {k_txt}", flush=True)
            sort_ms = cs.median_ms(
                torch, lambda: binning.heaviest_first(counts), queued=True)
            sort_n, _ = cs.device_launches(
                torch, lambda: binning.heaviest_first(counts))
        print(f"[time] {label}: the heaviest-first order alone "
              f"{sort_ms:.4f} ms queued, {sort_n} device launches", flush=True)
    _build._loaded["raster"] = libs["committed"]

    def render():
        with torch.no_grad():
            return model.render(cams[0])

    rows = {}
    for turn in ("heaviest first", "launch order") * 4:
        ctx = (unsorted_renders(torch, cs, uvr, kr) if turn == "launch order"
               else contextlib.nullcontext())
        with ctx:
            rows.setdefault(turn, []).append(
                (cs.median_ms(torch, render),
                 device_ms(torch, cs, render, cs.REPS),
                 cs.device_launches(torch, render)[0]))
    for turn, r in rows.items():
        print(f"[time] two-kernel render of view 0, kernel 1's tiles {turn}: "
              "wall " + " and ".join(f"{w:.3f}" for w, _, _ in r)
              + " ms, device " + " and ".join(f"{d:.4f}" for _, d, _ in r)
              + f" ms (medians of {cs.REPS}, {len(r)} turns); device launches "
              f"{r[0][2]}", flush=True)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
