#!/usr/bin/env python3
"""A/B timing of source variants of kernel A' on an NVIDIA H100.

Run from the repository root on a machine with the card:

    python3 scripts/ab_fused_bwd.py

Builds chip_smoke.py's flagship stage-3 model (100,000 Gaussians,
800x600, m = 32, F = 10), renders its 3 views as ground truth, retextures
it and captures the arguments one training step of configs/
prod_texture.yaml's joint phase hands kernel A'
(texgs_torch/csrc/uvtex_fused_bwd.cu).  Each variant in VARIANTS is that
source with a few text substitutions; all are compiled with
texgs_torch._build's flags (their ptxas reports printed), checked against
the committed source's output with chip_smoke.check_a_backward, and timed
in turns (first to last, then last to first), each turn the median of 5
queued CUDA-event timings (chip_smoke.median_ms).  Needs one card and
imports nothing of JAX.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

# name -> [(text of the committed source, its replacement), ...].  The
# committed kernel asks for 4 blocks an SM (at most 64 registers) and pads
# the warp sums' rows; the variants undo either or both.
VARIANTS = {
    "committed": [],
    # no register bound: 80 registers, so 3 blocks of 256 threads an SM
    "3_blocks_an_sm": [("__launch_bounds__(PIX, 4)", "__launch_bounds__(PIX)")],
    # the warp sums of a pair, read by lane l of warp 0's epilogue, 256
    # floats apart per lane (all on one shared-memory bank) instead of 257
    "unpadded_sums": [
        ("s_red[GROUP][WARPS * 2 * HALF + 1];",
         "s_red[GROUP][WARPS][2 * HALF];"),
        ("s_red[kk][warp * 2 * HALF + lane] = col;",
         "s_red[kk][warp][lane] = col;"),
        ("s_red[lane][wi * 2 * HALF + i];", "s_red[lane][wi][i];"),
        ("s_red[kk][wi * 2 * HALF + c];", "s_red[kk][wi][c];"),
    ],
}
VARIANTS["3_blocks_unpadded"] = (VARIANTS["3_blocks_an_sm"]
                                 + VARIANTS["unpadded_sums"])


def variant_source(text: str, subs) -> str:
    for old, new in subs:
        if text.count(old) != 1:
            raise SystemExit(f"ab_fused_bwd: {old!r} is not in the source once")
        text = text.replace(old, new)
    return text


def build_variants(out_dir: Path) -> dict:
    """Compiles every variant (one nvcc each, all started together);
    returns {name: loaded library}."""
    from texgs_torch import _build

    src = (_build.CSRC / "uvtex_fused_bwd.cu").read_text()
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, subs in VARIANTS.items():
        cu = out_dir / f"uvtex_fused_bwd_{name}.cu"
        cu.write_text(variant_source(src, subs))
        so = out_dir / f"lib{name}.so"
        procs[name] = (so, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o",
             str(so), str(cu)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log_text, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for variant {name}:\n{log_text}")
        for line in log_text.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}", flush=True)
        libs[name] = ctypes.CDLL(str(so))
    return libs


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("ab_fused_bwd: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from texgs_torch import _build
    from texgs_torch.data.synthetic import orbit_cameras
    from texgs_torch.kernels import uvtex_fused as kf
    from texgs_torch.kernels.cubemap import chessboard_cubemap, faces_to_cross

    device = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"[device] {card}", flush=True)
    libs = build_variants(ROOT / "build" / "texgs_torch" / "ab_fused_bwd")

    model, _ = cs.build_model(torch, device)
    cams = orbit_cameras(cs.N_VIEWS, radius=3.5, width=cs.WIDTH,
                         height=cs.HEIGHT)
    with torch.no_grad():
        views = [model.visual_step(0, 1, c) for c in cams]
    model.change_texture(faces_to_cross(chessboard_cubemap(
        cs.TEX_RES // 16, 16, device=device)), mode=0)
    step = cs.stage3_stepper(model, cams, views)
    seen = {}
    with cs.recording(kf, "fused_pairs_backward", seen):
        step(cs.FIRST_ITER)
    table, uv_rows, pairs, rays, gx, m = seen["fused_pairs_backward"][:6]
    cots = seen["fused_pairs_backward"][9:]
    with torch.no_grad():
        fwd = kf.fused_pairs_forward(table, uv_rows, pairs, rays, gx, m)
    args = (table, uv_rows, pairs, rays, gx, m, *fwd[:3], *cots)
    print(f"[capture] step {cs.FIRST_ITER}: {int(pairs.n_pairs)} pairs over "
          f"{pairs.tile_counts.numel()} tiles, {int(fwd[3].sum())} evaluated "
          "entries", flush=True)

    def call(name):
        _build._loaded["uvtex_fused_bwd"] = libs[name]
        return kf.fused_pairs_backward(*args)

    names = list(VARIANTS)
    with torch.no_grad():
        want = call(names[0])
        for name in names[1:]:
            cs.check_a_backward(torch, call(name), want,
                                label=f"{name} vs committed")
        times = {name: [] for name in names}
        for name in names + names[::-1]:
            times[name].append(cs.median_ms(torch, lambda: call(name),
                                            queued=True))
    for name in names:
        t = times[name]
        print(f"[time] A' {name}: {t[0]:.4f} and {t[1]:.4f} ms (queued, "
              f"median of {cs.REPS} each turn), mean {sum(t) / 2:.4f} ms",
              flush=True)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
