#!/usr/bin/env python3
"""A/B timing of kernel 2 (texgs_torch/csrc/uvtex_mlist.cu, the two-kernel
path's M-lists) and of the K5 gather (texgs_torch/csrc/hash_gather.cu)
against variants of themselves and against another tree's sources, on an
NVIDIA H100.

Run from the repository root on a machine with the card:

    python3 scripts/ab_mlist_gather.py [--parent DIR] [--no-time]

DIR is the root of another checkout of the repository (the parent commit
unpacked with `git archive` into the git-ignored build/, say); its
texgs_torch/csrc sources are built as the variant "parent".

Captures the arguments the main paths hand each kernel, as chip_smoke.py
does: kernel 2's from the render of view 0 of the flagship stage-3 model
on the two-kernel path (`backend: pallas`), the gather's as the corner
indices of the hash grid of one training step of configs/
prod_texture.yaml's joint phase (8 levels of 4,096 rows of 4 features,
8,192 points).  Each variant is the committed source with a few text
substitutions, compiled with texgs_torch._build's flags (ptxas reports
printed: registers, shared memory, spills):

- kernel 2: its pair loop one pair at a time ("plain", the parent's loop)
  or with the alphas of LOOK pairs computed ahead of the T chain
  ("look_N"), its dead slots zeroed by the block in flat order or one
  pixel a thread ("pixel_tail", the parent's); each is run with the tiles
  heaviest first and in launch order, so "plain_pixel_tail" heaviest first
  is the order alone and "plain" in launch order the tail alone; and the
  committed kernel bounded to 5 or 6 blocks an SM ("blocks_N");
- the gather: the vector path forced off ("scalar"), plain 16-byte stores
  in place of streaming ones ("plain_stores"), one thread per four queries
  with no cap on the grid ("uncapped"), at most one wave ("waves_1").

Every variant's output must equal the committed kernel's bit for bit
(kernel 2, in both tile orders) or exactly (the gather) before it is
timed; the committed kernel 2 is also held against its plain version.
Then each kernel's variants are timed in turns, first to last and last to
first ("parent" first), each turn the median of 5 queued CUDA-event
timings of the wrapper (chip_smoke.median_ms), and once under
torch.profiler (the kernel's own device time); an empty launch is timed
queued beside the gather, the part of a queued reading that is no
kernel's work.  Last, the two-kernel
render of view 0 with the committed kernel 2 and with the parent's, in
turns (wall and device time).  `--no-time` builds and checks only.  Needs
one card and imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))

# kernel 2's pair loop, with the alphas of LOOK pairs computed ahead of the
# T chain, and as its parent ran it, one pair at a time
GROUP_LOOP = """\
    for (int k0 = 0; k0 < n_batch && !done; k0 += LOOK) {
      float alpha[LOOK];
#pragma unroll
      for (int i = 0; i < LOOK; ++i) {
        // a group's tail past the batch repeats its last record, unused
        const float* q = s_quad[min(k0 + i, n_batch - 1)];
        float e;
        alpha[i] = pixel_alpha(pixel_power(x, y, q), q[6], &e);
      }
#pragma unroll
      for (int i = 0; i < LOOK; ++i) {
        if (k0 + i == n_batch) break;
        const float t_next = T * (1.f - alpha[i]);
        if (t_next < T_STOP) {
          done = true;
          break;
        }
        const float w = alpha[i] * T;
        T = t_next;
        if (w > 0.f) {
          const Intersection it = intersect(d, s_uv[k0 + i]);
          list[count] = make_float4(w, it.uvn[0], it.uvn[1], it.uvn[2]);
          if (++count == m) {
            done = true;
            break;
          }
        }
      }
    }
"""
PLAIN_LOOP = """\
    for (int k = 0; k < n_batch && !done; ++k) {
      const float* q = s_quad[k];
      float e;
      const float alpha = pixel_alpha(pixel_power(x, y, q), q[6], &e);
      const float t_next = T * (1.f - alpha);
      if (t_next < T_STOP) {
        done = true;
        break;
      }
      const float w = alpha * T;
      T = t_next;
      if (w > 0.f) {
        const Intersection it = intersect(d, s_uv[k]);
        list[count] = make_float4(w, it.uvn[0], it.uvn[1], it.uvn[2]);
        done = ++count == m;
      }
    }
"""
BATCH_LINE = "constexpr int BATCH = PIX;  // one staged record per thread\n"
LOOK_RE = re.compile(r"constexpr int LOOK = (\d+);")
# kernel 2's dead slots: zeroed by the block in flat order, or one pixel a
# thread, as its parent zeroed them
FLAT_TAIL = """\
  for (int f = tid; f < PIX * m; f += PIX)
    if (f % m >= s_count[f / m])
      tile_list[f] = make_float4(0.f, 0.f, 0.f, 0.f);
"""
PIXEL_TAIL = ("  for (int s = count; s < m; ++s) "
              "list[s] = make_float4(0.f, 0.f, 0.f, 0.f);\n")
LOOKS = (1, 4, 8, 16)
BOUNDS = "__launch_bounds__(PIX)\n    mlist_forward("
# a parent whose kernel 2 takes no tile order: its C entry gains an
# argument it ignores, so that this tree's wrapper calls it
MLIST_PARENT = [("const void* tile_end, const float* rays9,",
                 "const void* tile_end, const void*, const float* rays9,")]
GATHER_VARIANTS = {
    "committed": [],
    "scalar": [("const bool vec = (", "const bool vec = false && (")],
    "plain_stores": [("__stcs(reinterpret_cast<float4*>(p), v);",
                      "*reinterpret_cast<float4*>(p) = v;")],
    "uncapped": [("  if (blocks > cap) blocks = cap;\n", "")],
    "waves_1": [("constexpr int WAVES = 2;", "constexpr int WAVES = 1;")],
}
ORDERS = ("heaviest first", "launch order")


def mlist_variants(text: str) -> dict:
    """{name: substitutions} of kernel 2's variants, from its committed
    source `text`, whichever loop and tail it holds."""
    look = int(LOOK_RE.search(text).group(1)) if GROUP_LOOP in text else None

    def loop(n):  # the group loop with LOOK = n, or the plain loop (n = 0)
        if look is None:
            return [] if n == 0 else [
                (PLAIN_LOOP, GROUP_LOOP),
                (BATCH_LINE, BATCH_LINE + f"constexpr int LOOK = {n};\n")]
        if n == 0:  # LOOK stays declared, unused
            return [(GROUP_LOOP, PLAIN_LOOP)]
        return ([] if n == look else
                [(f"constexpr int LOOK = {look};", f"constexpr int LOOK = {n};")])

    def tail(flat):
        if (FLAT_TAIL in text) == flat:
            return []
        return [(PIXEL_TAIL, FLAT_TAIL) if flat else (FLAT_TAIL, PIXEL_TAIL)]

    return {"committed": [],
            "plain_pixel_tail": loop(0) + tail(False),
            "plain": loop(0) + tail(True),
            **{f"look_{n}": loop(n) + tail(True) for n in LOOKS},
            # the committed kernel asked to fit 5 or 6 blocks of 256
            # threads an SM (at most 51 or 42 registers)
            **{f"blocks_{n}": [(BOUNDS, BOUNDS.replace("(PIX)", f"(PIX, {n})"))]
               for n in (5, 6)}}


def render_capture(torch, cs, model_fused, cams, device):
    """The arguments the two-kernel render of view 0 hands kernel 2, and
    the two-kernel model (model_fused's state on `backend: pallas`)."""
    from texgs_torch.config import Cfg
    from texgs_torch.kernels import uvtex_mlist as km
    from texgs_torch.train.texture_gaussian3d import from_jax_state

    model = from_jax_state(model_fused.state_dict(),
                           Cfg(dict(cs.MODEL_CFG, backend="pallas")),
                           device=device)
    model.bind_train_cfg(None, cs.MODEL_CFG["background"])
    seen = {}
    with torch.no_grad(), cs.recording(km, "mlist_pairs", seen):
        model.render(cams[0])
    return seen["mlist_pairs"], model


def step_hash_capture(torch, cs, model, cams, device):
    """The hash grid's (table, points) of one training step of phase 7's
    joint phase (the fused path), from the band-texture views as ground
    truth and the chessboard retexture, as chip_smoke.py trains."""
    from texgs_torch.kernels.cubemap import chessboard_cubemap, faces_to_cross
    from texgs_torch.nets import hash_encode as ke

    with torch.no_grad():
        views = [model.visual_step(0, 1, c) for c in cams]
    model.change_texture(faces_to_cross(chessboard_cubemap(
        cs.TEX_RES // 16, 16, device=device)), mode=0)
    step = cs.stage3_stepper(model, cams, views)
    seen = {}
    with cs.recording(ke, "hash_encode_backward", seen):
        step(cs.FIRST_ITER)
    return seen["hash_encode_backward"][:2]


def timed_turns(torch, cs, runs, call, profile_call, kernel_name, label):
    """Each run of `runs` timed queued in two turns (first to last, last to
    first), then once under the profiler; prints a line per run."""
    times = {run: [] for run in runs}
    for run in runs + runs[::-1]:
        times[run].append(cs.median_ms(torch, lambda: call(*run), queued=True))
    for run in runs:
        k_ms, _ = profile_call(torch, cs, lambda: call(*run), kernel_name,
                               cs.REPS)
        t = times[run]
        k_txt = "not seen" if k_ms is None else f"{k_ms:.4f} ms"
        print(f"[time] {label} {', '.join(map(str, run))}: queued "
              f"{t[0]:.4f} and {t[1]:.4f} ms (median of {cs.REPS} each "
              f"turn), profiler kernel {k_txt}", flush=True)


def main() -> int:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--parent", help="root of another checkout, whose "
                        "kernel sources are built as the variant 'parent'")
    parser.add_argument("--no-time", action="store_true",
                        help="build and check the variants, time nothing")
    opts = parser.parse_args()
    if not torch.cuda.is_available():
        print("ab_mlist_gather: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from ab_fused_bwd import build_variants
    from ab_raster_bwd import profile_call
    from ab_raster_fwd import device_ms
    from texgs_torch import _build
    from texgs_torch.data.synthetic import orbit_cameras
    from texgs_torch.kernels import binning
    from texgs_torch.kernels import uvtex_mlist as km
    from texgs_torch.nets import hash_encode as ke
    from texgs_torch.nets import hash_gather as kh

    device = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"[device] {card}", flush=True)
    out_dir = ROOT / "build" / "texgs_torch" / "ab_mlist_gather"
    m_vars = mlist_variants((_build.CSRC / "uvtex_mlist.cu").read_text())
    g_vars, csrc = dict(GATHER_VARIANTS), {}
    if opts.parent:
        m_vars = {"parent": MLIST_PARENT, **m_vars}
        g_vars = {"parent": [], **g_vars}
        csrc["parent"] = Path(opts.parent) / "texgs_torch" / "csrc"
    m_libs = build_variants("uvtex_mlist", m_vars, out_dir, csrc)
    g_libs = build_variants("hash_gather", g_vars, out_dir, csrc)

    model, _ = cs.build_model(torch, device)
    cams = orbit_cameras(cs.N_VIEWS, radius=3.5, width=cs.WIDTH,
                         height=cs.HEIGHT)
    m_args, model2 = render_capture(torch, cs, model, cams, device)
    table, uv_rows, pairs, rays, gx, m = m_args
    counts = pairs.tile_counts
    print(f"[capture] kernel 2, two-kernel view 0: {int(pairs.n_pairs)} pairs "
          f"over {counts.numel()} tiles (mean {counts.float().mean().item():.1f}"
          f", max {int(counts.max())}), m = {m}; tile order set: "
          f"{pairs.tile_order is not None}", flush=True)
    ordered = {"heaviest first": binning.with_tile_order(pairs),
               "launch order": pairs._replace(tile_order=torch.arange(
                   counts.numel(), device=device))}

    def call_2(name, order):
        _build._loaded["uvtex_mlist"] = m_libs[name]
        return km.mlist_pairs_forward(table, uv_rows, ordered[order], rays,
                                      gx, m)

    m_runs = [(n, o) for n in m_libs for o in ORDERS
              if n != "parent" or o == "launch order"]
    with torch.no_grad():
        want = call_2("committed", ORDERS[0])
        live = int((want[..., 0] != 0).sum())
        print(f"  {live} live of {want[..., 0].numel()} slots", flush=True)
        cs.check_kernel_2(torch, want, km.mlist_only_scan(*m_args))
        for run in m_runs:
            same = torch.equal(call_2(*run), want)
            print(f"  2 {run[0]}, {run[1]}: M-lists equal to the committed "
                  f"kernel's bit for bit: {same}", flush=True)
            if not same:
                cs.fail(f"kernel 2 {run[0]} ({run[1]}) differs")
        if not opts.no_time:
            timed_turns(torch, cs, m_runs, call_2, profile_call,
                        "mlist_forward", "2 view 0")
    _build._loaded["uvtex_mlist"] = m_libs["committed"]

    table_h, x = step_hash_capture(torch, cs, model, cams, device)
    levels, size, n_feat = table_h.shape
    idx, _ = ke.indices_and_weights(x, levels, size)
    print(f"[capture] K5, the step-{cs.FIRST_ITER} hash grid: {x.shape[0]} "
          f"points, {levels} levels of {size} rows of {n_feat} features, "
          f"corner indices {tuple(idx.shape)}", flush=True)
    g_cases = {"the step's corners": idx,
               "n % 4 != 0": idx[:, :idx.shape[1] - 3].contiguous()}

    def call_k5(name, case):
        _build._loaded["hash_gather"] = g_libs[name]
        return kh.hash_gather_forward(table_h, g_cases[case])

    with torch.no_grad():
        for case, ix in g_cases.items():
            want_k = call_k5("committed", case)
            if not torch.equal(want_k, kh.gather_plain(table_h, ix)):
                cs.fail(f"K5 ({case}) differs from its plain version")
            for name in g_libs:
                same = torch.equal(call_k5(name, case), want_k)
                print(f"  K5 {name}, {case}: equal to the committed kernel's: "
                      f"{same}", flush=True)
                if not same:
                    cs.fail(f"K5 {name} ({case}) differs")
        if not opts.no_time:
            # the tables, the indices and the (L * 8, F, N) output
            k_bytes = cs.nbytes(table_h, idx) + 4 * n_feat * idx.numel()
            print(f"  K5 bound {cs.bound(k_bytes, 0)[0]:.5f} ms "
                  f"({k_bytes / 1e6:.2f} MB)", flush=True)
            timed_turns(torch, cs, [(n, "the step's corners") for n in g_libs],
                        call_k5, profile_call, "hash_gather",
                        "K5 gather")
            lvl = torch.arange(levels, device=device).repeat_interleave(
                8)[:, None].expand_as(idx)
            idx64 = idx.long()
            lib_ms = cs.median_ms(torch, lambda: table_h[lvl, idx64],
                                  queued=True)
            print(f"[time] K5 library call (table[level, idx]): "
                  f"{lib_ms:.4f} ms queued", flush=True)
            # what the queued window holds beyond a kernel's own time: one
            # launch of a kernel that returns at once
            floor_ms = cs.median_ms(torch, lambda: torch.cuda._sleep(1),
                                    queued=True)
            print(f"[time] an empty launch (torch.cuda._sleep(1)): "
                  f"{floor_ms:.4f} ms queued", flush=True)
    _build._loaded["hash_gather"] = g_libs["committed"]

    if opts.parent and not opts.no_time:
        def render():
            with torch.no_grad():
                return model2.render(cams[0])

        rows = {}
        for turn in ("parent", "committed") * 4:
            _build._loaded["uvtex_mlist"] = m_libs[turn]
            rows.setdefault(turn, []).append(
                (cs.median_ms(torch, render),
                 device_ms(torch, cs, render, cs.REPS),
                 cs.device_launches(torch, render)[0]))
        _build._loaded["uvtex_mlist"] = m_libs["committed"]
        for turn, r in rows.items():
            print(f"[time] two-kernel render of view 0, kernel 2 {turn}: wall "
                  + " and ".join(f"{w:.3f}" for w, _, _ in r) + " ms, device "
                  + " and ".join(f"{d:.4f}" for _, d, _ in r)
                  + f" ms (medians of {cs.REPS}, {len(r)} turns); device "
                  f"launches {r[0][2]}", flush=True)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
