"""Headline benchmark of the port (port of the root bench.py).

Two metric lines, one JSON object each, in texgs's order:

1. ``stage3_step_ms``: the full stage-3 train step of
   ``texgs_torch.tools.bench_stage3`` (100k Gaussians, 800x600, m = 32, a
   1024^2 cubemap, the fused path, every loss and the three Adams).  Its
   ``vs_baseline`` denominator is texgs's estimate of the reference's
   stage-3 step, 250 ms (bench.py:133).
2. ``rays_per_s_fwd_bwd_<device>``, the headline: one differentiable
   stage-1 render (SH evaluation, projection, binning, kernel 1 and its
   backward 1') of ``blob_point_cloud(N, seed=0)`` at SH degree 3 and
   800x600, with gradients into every Gaussian parameter, in rays (pixels)
   a second.  ``vs_baseline`` is against texgs's 5.76e6 rays/s (12 it/s of
   the reference at 800x600, bench.py:48).

Each line carries ``mfu_pct``, ``hbm_util_pct`` and ``analytic_bound``
from ``texgs_torch.tools.roofline`` at the render's own pair count
(``n_pairs``), the median step time's spread and the card's name.  Each
step is timed between ``torch.cuda.synchronize()`` calls.  There is no
fallback: a kernel that fails to build or launch raises, and the command
exits non-zero.

    python -m texgs_torch.tools.bench [--device cuda|cpu] [--verify]

``--verify`` runs ``texgs_torch.tools.verify_compiled`` instead.
Env: BENCH_N (100000), BENCH_W/H (800x600), BENCH_ITERS (20),
BENCH_SKIP_STAGE3=1 skips line 1; bench_stage3 reads its BENCH3_* variables.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np
import torch

BASELINE_RAYS_PER_S = 12.0 * 800 * 600  # texgs bench.py:48
BASELINE_STAGE3_MS = 250.0               # texgs bench.py:133


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def device_name(device) -> str:
    device = torch.device(device)
    return (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")


def measure_stage1(n=None, width=None, height=None, iters=None,
                   device="cuda"):
    """(median seconds of one differentiable stage-1 render, aux): aux
    holds ``n_pairs`` (the render's pair count), the shape and
    ``spread_ms``, the fastest and slowest timed step.  One warm-up step
    comes first; every step runs kernel 1 once and 1' once on the card."""
    from texgs_torch.core.state import init_from_pcd
    from texgs_torch.data.synthetic import blob_point_cloud, orbit_cameras
    from texgs_torch.render.render import render

    n = n or int(os.environ.get("BENCH_N", 100_000))
    width = width or int(os.environ.get("BENCH_W", 800))
    height = height or int(os.environ.get("BENCH_H", 600))
    iters = iters or int(os.environ.get("BENCH_ITERS", 20))
    dev = torch.device(device)

    pcd = blob_point_cloud(n, seed=0)
    params = init_from_pcd(pcd.points, pcd.colors, max_sh_degree=3,
                           device=dev).params_dict()
    for p in params.values():
        p.requires_grad_(True)
    cam = orbit_cameras(1, radius=3.5, width=width, height=height)[0]
    target = torch.zeros((3, height, width), device=dev)
    bg = torch.zeros(3, device=dev)

    def step():
        for p in params.values():
            p.grad = None
        with torch.enable_grad():
            rot = params["rotation"]
            out = render(cam, xyz=params["xyz"],
                         opacity=torch.sigmoid(params["opacity"]),
                         scaling=torch.exp(params["scaling"]),
                         rotation=rot / (torch.linalg.norm(
                             rot, dim=-1, keepdim=True) + 1e-12),
                         features=torch.cat([params["f_dc"],
                                             params["f_rest"]], 1),
                         active_sh_degree=3, bg_color=bg)
            loss = ((out["render"] - target).abs().mean()
                    + out["alpha"].mean() * 0.1)
            loss.backward()
        return out["n_pairs"]

    n_pairs = int(step())
    times = []
    for _ in range(iters):
        _sync(dev)
        t0 = time.perf_counter()
        step()
        _sync(dev)
        times.append(time.perf_counter() - t0)
    aux = {"n_pairs": n_pairs, "n": n, "width": width, "height": height,
           "spread_ms": [min(times) * 1e3, max(times) * 1e3]}
    return float(np.median(times)), aux


def _utilization(comps, dt):
    from texgs_torch.tools.roofline import summarize

    util = summarize(comps, dt)
    return {"mfu_pct": util["mfu_pct"], "hbm_util_pct": util["hbm_util_pct"],
            "analytic_bound": util["bound"]}


def stage1_line(device) -> dict:
    from texgs_torch.tools.roofline import stage1_counts

    dt, aux = measure_stage1(device=device)
    rays_per_s = aux["width"] * aux["height"] / dt
    return {
        "metric": f"rays_per_s_fwd_bwd_{torch.device(device).type}",
        "value": round(rays_per_s, 1),
        "unit": "rays/s",
        "vs_baseline": round(rays_per_s / BASELINE_RAYS_PER_S, 3),
        **_utilization(stage1_counts(aux["n"], aux["n_pairs"], aux["width"],
                                     aux["height"]), dt),
        "n_pairs": aux["n_pairs"],
        "step_ms": dt * 1e3,
        "spread_ms": aux["spread_ms"],
        "device": device_name(device),
    }


def stage3_line(device) -> dict:
    from texgs_torch.tools.bench_stage3 import measure
    from texgs_torch.tools.roofline import stage3_counts

    dt, aux = measure(device=device)
    return {
        "metric": "stage3_step_ms",
        "value": round(dt * 1e3, 1),
        "unit": "ms",
        "vs_baseline": round(BASELINE_STAGE3_MS / (dt * 1e3), 3),
        **_utilization(stage3_counts(aux["n"], aux["n_pairs"], aux["width"],
                                     aux["height"], tex_res=aux["tex_res"]),
                       dt),
        "n_pairs": aux["n_pairs"],
        "spread_ms": aux["spread_ms"],
        "device": device_name(device),
    }


def main(argv=None) -> int:
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--verify", action="store_true",
                        help="run texgs_torch.tools.verify_compiled instead")
    args = parser.parse_args(argv)
    if args.verify:
        from texgs_torch.tools.verify_compiled import main as verify_main
        return verify_main(["--device", args.device])

    if not os.environ.get("BENCH_SKIP_STAGE3"):
        print(json.dumps(stage3_line(args.device)), flush=True)
    print(json.dumps(stage1_line(args.device)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
