#!/usr/bin/env python3
"""A/B timing of kernels B (texgs_torch/csrc/tex_term.cu), B'
(texgs_torch/csrc/tex_term_bwd.cu) and A (texgs_torch/csrc/uvtex_fused.cu)
against variants of themselves and against another tree's sources, on an
NVIDIA H100.

Run from the repository root on a machine with the card:

    python3 scripts/ab_tex_term.py [--parent DIR] [--no-time]
                                   [--kernels tex_term,tex_term_bwd,...]

DIR is the root of another checkout of the repository (the parent commit
unpacked with `git archive` into the git-ignored build/, say); its
texgs_torch/csrc sources are built as the variant "parent" of each kernel.

Builds chip_smoke.py's flagship stage-3 model (100,000 Gaussians, 800x600,
m = 32, F = 10; the model gives no F = 7 call) and captures the arguments
the main path hands the kernels: A's and B's from the render of view 0 and
from one training step of configs/prod_texture.yaml's joint phase, B''s
from that step.  It counts, with plain torch ops on the card, what B''s texel
scatter issues: the scalar atomics of one thread per pixel (3 a live slot's
tap texel), the (warp, tap, texel) groups a warp merge (the variant
warp_merge) would add instead, the distinct (warp, texel) and
(block, texel) pairs, how many of a pixel's live slots share a tap texel
with another of its slots, and the shuffle rounds the merge takes; and A's
dead slots.  Each variant in VARIANTS is a kernel's
source with a few text substitutions, compiled with texgs_torch._build's
flags (ptxas reports printed: registers, shared memory, spills) and checked
against the committed source's output: B at 2e-5 + 1e-4 |x|, B' at
chip_smoke.py's tolerances, A bit for bit.  With --no-time it stops there.  Otherwise each capture's
variants are timed in turns, first to last and last to first ("parent"
first), each turn the median of 5 queued CUDA-event timings of the wrapper
(chip_smoke.median_ms), and once under torch.profiler (the kernel's own
device time, and the wrapper's other device work); then the render of view
0 and the training step are timed with A's tiles heaviest first (the
committed tree) and in launch order without the sort, in turns.
--kernels limits the run to the named sources (all three by default).
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

# kernel A taking the tiles in launch order
LAUNCH_ORDER = [("const int tile = static_cast<int>(tile_order[blockIdx.x]);",
                 "const int tile = blockIdx.x;")]
ADD_V4 = "  atomicAdd(d_acc + t, make_float4(v.x, v.y, v.z, 0.f));"
KERNEL = "__global__ void __launch_bounds__(BLOCK)\n    tex_term_backward("
DIRECT = """    if (t.n > 0 && t.weight != 0.f) {
      // constant indices keep the taps in registers
      add_texel(d_acc, t.idx[0], v);
      if (t.n == 3) {
        add_texel(d_acc, t.idx[1], v);
        add_texel(d_acc, t.idx[2], v);
      }
    }"""
# the scatter merged over the warp, one round a tap and two more for a
# corner tap's other texels: the lanes offering one texel find each other
# with __match_any_sync and the lowest adds their sum (merge_add)
MERGED = """    const int lane = threadIdx.x & 31;
    const bool adds = t.n > 0 && t.weight != 0.f;
    merge_add(d_acc, adds ? t.idx[0] : -1 - lane, v, lane);
    if (__any_sync(0xffffffffu, adds && t.n == 3)) {
      const bool corner = adds && t.n == 3;
      merge_add(d_acc, corner ? t.idx[1] : -1 - lane, v, lane);
      merge_add(d_acc, corner ? t.idx[2] : -1 - lane, v, lane);
    }"""
# merge_add summing a group by shuffles into its lowest lane (lane order),
# every lane shuffling as often as the largest group needs; a lane with
# nothing to add passes a negative key of its own
SHUFFLE_SUMS = """__device__ __forceinline__ void merge_add(float4* __restrict__ d_acc,
                                          int key, float3 v, int lane) {
  const unsigned peers = __match_any_sync(0xffffffffu, key);
  const bool lead = __ffs(peers) - 1 == lane;
  unsigned rest = lead ? peers & (peers - 1) : 0u;
  const unsigned rounds = __reduce_max_sync(
      0xffffffffu, static_cast<unsigned>(__popc(rest)));
  for (unsigned r = 0; r < rounds; ++r) {
    const int src = rest ? __ffs(rest) - 1 : lane;
    const float x = __shfl_sync(0xffffffffu, v.x, src);
    const float y = __shfl_sync(0xffffffffu, v.y, src);
    const float z = __shfl_sync(0xffffffffu, v.z, src);
    if (rest) {
      v.x += x;
      v.y += y;
      v.z += z;
      rest &= rest - 1;
    }
  }
  if (key >= 0 && lead) add_texel(d_acc, key, v);
}

"""
# merge_add summing a group by shared-memory atomics into its lowest
# lane's row of the warp's
SHARED_SUMS_FN = """__device__ __forceinline__ void merge_add(float4* __restrict__ d_acc,
                                          int key, float3 v, int lane) {
  __shared__ float s_sum[BLOCK / 32][32][4];
  const unsigned peers = __match_any_sync(0xffffffffu, key);
  const int leader = __ffs(peers) - 1;
  const bool alone = peers == (1u << lane);
  float* sum = s_sum[threadIdx.x >> 5][leader];
  if (!alone && leader == lane) {
    sum[0] = v.x;
    sum[1] = v.y;
    sum[2] = v.z;
  }
  __syncwarp();
  if (!alone && leader != lane) {
    atomicAdd(sum, v.x);
    atomicAdd(sum + 1, v.y);
    atomicAdd(sum + 2, v.z);
  }
  __syncwarp();
  if (!alone && leader == lane) v = make_float3(sum[0], sum[1], sum[2]);
  __syncwarp();
  if (key >= 0 && leader == lane) add_texel(d_acc, key, v);
}

"""
WARP_MERGE = [(KERNEL, SHUFFLE_SUMS + KERNEL), (DIRECT, MERGED)]
SHARED_SUMS = [(KERNEL, SHARED_SUMS_FN + KERNEL), (DIRECT, MERGED)]
# B' as first designed: the warp merge, and three scalar atomics a texel
# group into the unpadded (6, R, R, 3) gradient (no pack)
SCALAR = WARP_MERGE + [(ADD_V4, """  float* p = reinterpret_cast<float*>(d_acc) + static_cast<size_t>(t) * 3;
  atomicAdd(p, v.x);
  atomicAdd(p + 1, v.y);
  atomicAdd(p + 2, v.z);""")]
# the same with a float2 and a scalar atomic a texel group (a texel's 12
# bytes hold one 8-byte-aligned pair)
V2_SPLIT = WARP_MERGE + [(ADD_V4, """  float* p = reinterpret_cast<float*>(d_acc) + static_cast<size_t>(t) * 3;
  if (t & 1) {
    atomicAdd(p, v.x);
    atomicAdd(reinterpret_cast<float2*>(p + 1), make_float2(v.y, v.z));
  } else {
    atomicAdd(reinterpret_cast<float2*>(p), make_float2(v.x, v.y));
    atomicAdd(p + 2, v.z);
  }""")]
# B' without its texel scatter: a floor for the rest of the kernel, timed
# but not checked (it computes no texture gradient)
NO_SCATTER = [(ADD_V4, "")]
UNCHECKED = {"no_scatter"}
# variants called as the parent's C entry is: into a zeroed (6, R, R, 3)
# gradient, with no pack (call_unpadded)
UNPADDED = {"parent", "scalar", "v2_split"}
# Kernel B's variants.  The committed design runs one thread a slot; the
# variants replace its kernel and launch (B_KERNEL: the source from the
# kernel's comment to the end of its namespace) or its texel read.
_B_SRC = (ROOT / "texgs_torch" / "csrc" / "tex_term.cu").read_text()
B_KERNEL = _B_SRC[_B_SRC.index("// Block b holds pixels"):
                  _B_SRC.index("}  // namespace")]
B_LAUNCH = _B_SRC[_B_SRC.index("void launch("):_B_SRC.index("}  // namespace")]
# (b) one thread a pixel, as the parent design, over the tile's M-lists
# staged into shared memory CH slots at a time in coalesced chunks: a warp
# loads 4 pixels' 8 slots, 512 contiguous bytes (36 KB staged, rows padded
# to 9 slots)
PER_PIXEL_STAGED = [(B_KERNEL, """constexpr int CH = 8;

__global__ void __launch_bounds__(PIX)
    tex_term_forward_staged(const float4* __restrict__ mlist,
                            const float* __restrict__ tex, int res,
                            float lim, int mode, int m, int gx, int height,
                            int width, float* __restrict__ out) {
  __shared__ float4 s_ml[PIX][CH + 1];
  const int tile = blockIdx.x, tid = threadIdx.x;
  const float4* tl = mlist + static_cast<size_t>(tile) * PIX * m;
  float r = 0.f, g = 0.f, b = 0.f;
  for (int c0 = 0; c0 < m; c0 += CH) {
    const int n = min(CH, m - c0);
    __syncthreads();
    for (int i = tid; i < PIX * n; i += PIX)
      s_ml[i / n][i % n] = tl[static_cast<size_t>(i / n) * m + c0 + i % n];
    __syncthreads();
    for (int j = 0; j < n; ++j) {
      const float4 e = s_ml[tid][j];
      if (e.x == 0.f) continue;
      const float3 t = sample_cube(tex, res, lim, mode, e.y, e.z, e.w);
      r += e.x * t.x;
      g += e.x * t.y;
      b += e.x * t.z;
    }
  }
  const int y = (tile / gx) * TILE + tid / TILE;
  const int x = (tile % gx) * TILE + tid % TILE;
  if (y < height && x < width) {
    const size_t plane = static_cast<size_t>(height) * width;
    const size_t at = static_cast<size_t>(y) * width + x;
    out[at] = C0 * r;
    out[plane + at] = C0 * g;
    out[2 * plane + at] = C0 * b;
  }
}

void launch(const float4* mlist, const float* tex, int res, float lim,
            int mode, int n_tiles, int m, int gx, int height, int width,
            float* out, cudaStream_t stream) {
  tex_term_forward_staged<<<n_tiles, PIX, 0, stream>>>(
      mlist, tex, res, lim, mode, m, gx, height, width, out);
}

""")]
# (c) the committed design reading each texel as one float4 from a copy of
# the cubemap padded to (6, R, R, 4), made by a first kernel in every call
# (the texture changes every training step); the copy's buffer is kept
# between calls, allocated at the first
PADDED_TEXELS = [
    ("""  const float* p = tex + static_cast<size_t>(at) * 3;
  return make_float3(__ldg(p), __ldg(p + 1), __ldg(p + 2));""",
     """  const float4 v = __ldg(reinterpret_cast<const float4*>(tex) + at);
  return make_float3(v.x, v.y, v.z);"""),
    (B_LAUNCH, """__global__ void __launch_bounds__(BLOCK)
    pad_texels(const float* __restrict__ tex, int n, float4* __restrict__ out) {
  const int i = blockIdx.x * BLOCK + threadIdx.x;
  if (i < n) out[i] = make_float4(tex[3 * i], tex[3 * i + 1], tex[3 * i + 2],
                                  0.f);
}

void launch(const float4* mlist, const float* tex, int res, float lim,
            int mode, int n_tiles, int m, int gx, int height, int width,
            float* out, cudaStream_t stream) {
  static float4* padded = nullptr;
  static int cap = 0;
  const int n = 6 * res * res;
  if (n > cap) {
    cudaFree(padded);
    cudaMalloc(&padded, static_cast<size_t>(n) * sizeof(float4));
    cap = n;
  }
  pad_texels<<<(n + BLOCK - 1) / BLOCK, BLOCK, 0, stream>>>(tex, n, padded);
  const int n_pix = n_tiles * PIX;
  const int ppb = max(1, BLOCK / m);
  tex_term_forward<<<(n_pix + ppb - 1) / ppb, BLOCK, 0, stream>>>(
      mlist, reinterpret_cast<const float*>(padded), res, lim, mode, m, ppb,
      n_pix, gx, height, width, out);
}

""")]
# the committed kernel asked to fit 4 (no bound: 58 registers), 5 or 8
# blocks of 256 threads an SM in place of its 6 (at most 40 registers)
B_BOUNDS = "__launch_bounds__(BLOCK, 6)\n    tex_term_forward("
VARIANTS = {
    "tex_term": {"committed": [], "per_pixel_staged": PER_PIXEL_STAGED,
                 "padded_texels": PADDED_TEXELS,
                 **{f"blocks_{n}": [(B_BOUNDS, "__launch_bounds__(BLOCK"
                                     + (f", {n}" if n != 4 else "")
                                     + ")\n    tex_term_forward(")]
                    for n in (4, 5, 8)}},
    "tex_term_bwd": {"committed": [], "warp_merge": WARP_MERGE,
                     "shared_sums": SHARED_SUMS, "scalar": SCALAR,
                     "v2_split": V2_SPLIT, "no_scatter": NO_SCATTER},
    "uvtex_fused": {"committed": [], "launch_order": LAUNCH_ORDER},
}
# a parent whose kernel A takes no tile order: its C entry gains an
# argument it ignores, so that this tree's wrapper calls it
PARENT = {
    "tex_term": [],
    "tex_term_bwd": [],
    "uvtex_fused": [("const void* tile_end, const float* rays9,",
                     "const void* tile_end, const void*, "
                     "const float* rays9,")],
}
# the kernel function each library launches, as torch.profiler names it
KERNEL_NAMES = {"tex_term": "tex_term_forward",
                "tex_term_bwd": "tex_term_backward",
                "uvtex_fused": "fused_forward"}


def tap_texels(torch, dirs, res):
    """The texels of each direction's 4 seamless bilinear taps, as
    csrc/cubemap_taps.cuh picks them: ((N, 4, 3) linear texel indices, -1
    past a tap's count, (N, 4) scatter weights: a third at a cube
    corner)."""
    from texgs_torch.kernels.cubemap import (_texel_index,
                                             direction_to_face_uv,
                                             face_uv_to_direction)

    face, u, v = direction_to_face_uv(dirs)
    fu = (u * 0.5 + 0.5) * res - 0.5
    fv = (v * 0.5 + 0.5) * res - 0.5
    x0, y0 = torch.floor(fu), torch.floor(fv)
    wx, wy = fu - x0, fv - y0
    lim = 1.0 - 1.0 / res

    def reresolve(u_t, v_t):
        f2, u2, v2 = direction_to_face_uv(face_uv_to_direction(face, u_t, v_t))
        return (f2 * res + _texel_index(v2, res)) * res + _texel_index(u2, res)

    idx, weights = [], []
    for xi, yi, w in ((x0, y0, (1 - wx) * (1 - wy)), (x0 + 1, y0, wx * (1 - wy)),
                      (x0, y0 + 1, (1 - wx) * wy), (x0 + 1, y0 + 1, wx * wy)):
        xc = torch.clamp(xi.to(torch.int64), 0, res - 1)
        yc = torch.clamp(yi.to(torch.int64), 0, res - 1)
        home = (face * res + yc) * res + xc
        u_t = (xi + 0.5) / res * 2.0 - 1.0
        v_t = (yi + 0.5) / res * 2.0 - 1.0
        out_u, out_v = u_t.abs() > 1.0, v_t.abs() > 1.0
        corner = out_u & out_v
        p = reresolve(u_t, torch.clamp(v_t, -lim, lim))
        q = reresolve(torch.clamp(u_t, -lim, lim), v_t)
        none = torch.full_like(home, -1)
        idx.append(torch.stack([
            torch.where(out_u, p, torch.where(out_v, q, home)),
            torch.where(corner, q, none), torch.where(corner, home, none)], -1))
        weights.append(torch.where(corner, w / 3.0, w))
    return torch.stack(idx, 1), torch.stack(weights, 1)


def b_scatter_counts(torch, mlist, texture, g_img, height, width):
    """What B''s texel scatter issues on these arguments (seamless
    bilinear, the main path's filter): a dict of counts."""
    from texgs_torch.kernels.binning import grid_shape

    n_tiles, pix, m, _ = mlist.shape
    gy, gx = grid_shape(height, width)
    pad = torch.zeros((3, gy * 16, gx * 16), device=mlist.device)
    pad[:, :height, :width] = g_img
    has_g = (pad.reshape(3, gy, 16, gx, 16).permute(1, 3, 2, 4, 0)
             .reshape(n_tiles * pix, 3) != 0).any(-1)
    flat = mlist.reshape(-1, 4)
    slot = torch.arange(flat.shape[0], device=mlist.device)
    live = (flat[:, 0] != 0) & has_g[slot // m]
    s = slot[live]
    idx, w = tap_texels(torch, flat[live, 1:4], texture.shape[1])
    n_live = int(s.numel())
    # one entry per (live slot, tap, texel) the scatter adds into
    take = (idx >= 0) & (w != 0)[..., None]
    ent_s = s[:, None, None].expand_as(idx)[take]
    ent_k = torch.arange(4, device=s.device)[None, :, None].expand_as(idx)[take]
    ent_j = torch.arange(3, device=s.device)[None, None, :].expand_as(idx)[take]
    ent_t = idx[take]
    n_tex = 6 * texture.shape[1] ** 2
    warp = ent_s // 32
    # the warp merge (variant warp_merge), one round a tap: (warp, tap,
    # texel of the tap, texel)
    round_key = (warp * 12 + ent_k * 3 + ent_j) * n_tex + ent_t
    groups, sizes = torch.unique(round_key, return_counts=True)
    # shuffle rounds: per (warp, tap, j) the largest group less one
    per_round = groups // n_tex
    rounds_key, inv = torch.unique(per_round, return_inverse=True)
    largest = torch.zeros(rounds_key.numel(), dtype=sizes.dtype,
                          device=s.device).scatter_reduce_(
        0, inv, sizes, "amax")
    warp_texel = torch.unique(warp * n_tex + ent_t).numel()
    block_texel = torch.unique((ent_s // 256) * n_tex + ent_t).numel()
    # the live slots of each (pixel, texel), and the slots that share a
    # tap texel with another slot of their pixel
    pt_key = (ent_s // m) * n_tex + ent_t
    pt, pt_inv = torch.unique(pt_key, return_inverse=True)
    slot_pt = torch.unique(pt_key * m + ent_s % m)  # (pixel, texel, slot)
    per_pt = torch.zeros(pt.numel(), dtype=torch.int64,
                         device=s.device).index_add_(
        0, torch.searchsorted(pt, slot_pt // m), torch.ones_like(slot_pt))
    sharing = torch.zeros(flat.shape[0], dtype=torch.bool, device=s.device)
    sharing[ent_s[per_pt[pt_inv] >= 2]] = True
    most = torch.zeros(n_tiles * pix, dtype=torch.int64,
                       device=s.device).scatter_reduce_(0, pt // n_tex,
                                                        per_pt, "amax")
    n_pixels = int((most > 0).sum())
    return {"slots": flat.shape[0], "live slots (w != 0, g != 0)": n_live,
            "tap texels (the committed kernel's vector atomics)":
                int(ent_t.numel()),
            "corner taps": int((ent_j == 1).sum()),
            "scalar atomics, one thread a pixel": 3 * int(ent_t.numel()),
            "merged groups, a round a tap (warp, tap, texel)":
                int(groups.numel()),
            "scalar atomics, merged": 3 * int(groups.numel()),
            "distinct (warp, texel)": int(warp_texel),
            "distinct (256-slot block, texel)": int(block_texel),
            "largest group": int(sizes.max()) if sizes.numel() else 0,
            "mean group": float(sizes.float().mean()) if sizes.numel() else 0,
            "shuffle rounds (sum over warps and merge rounds)":
                int((largest - 1).sum()),
            "merge rounds (warp, tap, j)": int(rounds_key.numel()),
            "live slots sharing a tap texel with another slot of the pixel":
                int(sharing.sum()),
            "pixels with a live slot": n_pixels,
            "mean over those pixels of the most live slots on one texel":
                float(most.sum()) / max(n_pixels, 1)}


def captures(torch, cs, device):
    """{label: view 0's and the step's A and B arguments, the step's B'
    arguments}, the model, its cameras, its step function."""
    from texgs_torch.data.synthetic import orbit_cameras
    from texgs_torch.kernels import tex_term as kt
    from texgs_torch.kernels import uvtex_fused as kf
    from texgs_torch.kernels.cubemap import chessboard_cubemap, faces_to_cross

    model, _ = cs.build_model(torch, device)
    cams = orbit_cameras(cs.N_VIEWS, radius=3.5, width=cs.WIDTH,
                         height=cs.HEIGHT)
    with torch.no_grad():
        a_view, b_view = cs.main_path_kernel_args(model, cams[0])
        views = [model.visual_step(0, 1, c) for c in cams]
    model.change_texture(faces_to_cross(chessboard_cubemap(
        cs.TEX_RES // 16, 16, device=device)), mode=0)
    step = cs.stage3_stepper(model, cams, views)
    seen = {}
    with cs.recording(kf, "fused_pairs", seen), \
            cs.recording(kt, "tex_term", seen), \
            cs.recording(kt, "tex_term_backward", seen):
        step(cs.FIRST_ITER)
    return ({"A (view 0)": a_view, "A (step)": seen["fused_pairs"],
             "B (view 0)": b_view, "B (step)": seen["tex_term"],
             "B' (step)": seen["tex_term_backward"]}, model, cams, step)


def call_unpadded(torch, lib, args):
    """Kernel B' of a library whose C entry adds into the (6, R, R, 3)
    gradient itself (the parent's, UNPADDED): the wrapper's call with a
    zeroed gradient and no pack."""
    from texgs_torch import _build
    from texgs_torch.kernels.tex_term import FILTER_MODES

    mlist, texture, g_img, height, width, mode = args
    n_tiles, _, m, _ = mlist.shape
    d_mlist = torch.empty_like(mlist)
    d_texture = torch.zeros_like(texture)
    _build._loaded["tex_term_bwd"] = lib
    _build.launch("tex_term_bwd", "tex_term_backward", "PPiiiiiiiPPP", mlist,
                  texture, texture.shape[1], FILTER_MODES[mode], n_tiles, m,
                  -(-width // 16), height, width, g_img, d_mlist, d_texture,
                  like=mlist)
    return d_mlist, d_texture


def check_b(torch, cs, got, want, mlist, label):
    live = mlist[..., 0] != 0
    err = max(
        cs.check_scaled(torch, f"{label} d texture", got[1], want[1], 1e-4,
                        1e-3),
        cs.check_scaled(torch, f"{label} d w (live slots)", got[0][live][:, 0],
                        want[0][live][:, 0], 1e-4, 1e-3),
        cs.check_scaled(torch, f"{label} d uv (live slots)",
                        got[0][live][:, 1:], want[0][live][:, 1:], 1e-4, 1e-3))
    if got[0][~live].any():
        cs.fail(f"{label}: a cotangent in a dead slot")
    return err


def check_a(torch, cs, got, want, label):
    same = [torch.equal(g, w) for g, w in zip(got, want)]
    cs.log(f"  {label}: blend, T_final, M-lists, n_eval bit for bit: {same}")
    if not all(same):
        cs.fail(f"{label}: kernel A's outputs differ")


@contextlib.contextmanager
def launch_order(torch, cs, kf, uvr):
    """The fused path without the heaviest-first sort: the render hands A
    its pair list as built, and A's wrapper passes a cached arange (no
    device work), for a library whose kernel ignores the order."""
    cache = {}

    def arange(name, pairs, device):
        n = pairs.tile_counts.numel()
        if n not in cache:
            cache[n] = torch.arange(n, device=device)
        return cache[n]

    with cs.swapped(kf, "tile_order_arg", arange), \
            cs.swapped(uvr, "with_tile_order", lambda pairs: pairs):
        yield


def main() -> int:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--parent", help="root of another checkout, whose "
                        "kernel sources are built as the variant 'parent'")
    parser.add_argument("--no-time", action="store_true",
                        help="count, build and check; time nothing")
    parser.add_argument("--kernels", default=",".join(VARIANTS),
                        help="the sources to build, check and time, "
                        "comma-separated (default: all)")
    opts = parser.parse_args()
    sources = opts.kernels.split(",")
    if not set(sources) <= set(VARIANTS):
        parser.error(f"--kernels: choose from {', '.join(VARIANTS)}")
    if not torch.cuda.is_available():
        print("ab_tex_term: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from ab_fused_bwd import build_variants
    from ab_raster_bwd import profile_call
    from texgs_torch import _build
    from texgs_torch.kernels import binning
    from texgs_torch.kernels import tex_term as kt
    from texgs_torch.kernels import uvtex_fused as kf
    from texgs_torch.kernels import uvtex_raster as uvr

    device = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"[device] {card}", flush=True)
    out_dir = ROOT / "build" / "texgs_torch" / "ab_tex_term"
    libs = {}
    for source in sources:
        variants = dict(VARIANTS[source])
        csrc = {}
        if opts.parent:
            variants = {"parent": PARENT[source], **variants}
            csrc["parent"] = Path(opts.parent) / "texgs_torch" / "csrc"
        libs[source] = build_variants(source, variants, out_dir, csrc)

    args_of, model, cams, step = captures(torch, cs, device)
    mlist, texture, g_img, height, width, mode = args_of["B' (step)"]
    if "tex_term_bwd" in sources:
        with torch.no_grad():
            counts = b_scatter_counts(torch, mlist, texture, g_img, height,
                                      width)
        print(f"[count] B' on the step-{cs.FIRST_ITER} arguments ({mode}, "
              f"{texture.shape[1]}^2 cubemap, m = {mlist.shape[2]}):",
              flush=True)
        for k, v in counts.items():
            print(f"  {k}: {v}", flush=True)
    for label in ("view 0", "step"):
        if "tex_term" in sources:
            w = args_of[f"B ({label})"][0][..., 0]
            live = (w != 0).sum(-1)
            mean = live[live > 0].float().mean().item()
            print(f"[count] B, {label}: {int(live.sum())} live of {w.numel()} "
                  f"slots; pixels with 0 live slots {int((live == 0).sum())}, "
                  f"mean over the others {mean:.2f}, most {int(live.max())}",
                  flush=True)
        if "uvtex_fused" not in sources:
            continue
        args = args_of[f"A ({label})"]
        with torch.no_grad():
            out = kf.fused_pairs_forward(*args)
        w = out[2][..., 0]
        pairs = args[2]
        print(f"[count] A, {label}: {int(pairs.n_pairs)} pairs over "
              f"{pairs.tile_counts.numel()} tiles (mean "
              f"{pairs.tile_counts.float().mean().item():.1f}, max "
              f"{int(pairs.tile_counts.max())}); {int((w != 0).sum())} live "
              f"of {w.numel()} slots, {int((w == 0).sum()) * 16 / 1e6:.1f} MB "
              f"of dead slots; tile order set: {pairs.tile_order is not None}",
              flush=True)

    kernel_of = {"B": "tex_term", "B'": "tex_term_bwd", "A": "uvtex_fused"}
    tests = {label: (kernel_of[label.split()[0]], args)
             for label, args in args_of.items()
             if kernel_of[label.split()[0]] in sources}
    wrappers = {"tex_term": kt.tex_term_forward,
                "tex_term_bwd": kt.tex_term_backward,
                "uvtex_fused": kf.fused_pairs_forward}
    for label, (source, args) in tests.items():
        def call(name, source=source, args=args):
            if source == "tex_term_bwd" and name in UNPADDED:
                return call_unpadded(torch, libs[source][name], args)
            _build._loaded[source] = libs[source][name]
            return wrappers[source](*args)

        names = list(libs[source])
        with torch.no_grad():
            want = call("committed")
            for name in names:
                if name == "committed" or name in UNCHECKED:
                    continue
                if source == "tex_term":
                    cs.check_close(torch, f"{label} {name} vs committed",
                                   call(name), want, atol=2e-5, rtol=1e-4)
                elif source == "tex_term_bwd":
                    check_b(torch, cs, call(name), want, mlist,
                            f"{label} {name} vs committed")
                else:
                    check_a(torch, cs, call(name), want,
                            f"{label} {name} vs committed")
            if opts.no_time:
                continue
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
        _build._loaded[source] = libs[source]["committed"]

    if not opts.no_time and "uvtex_fused" in sources:
        counts_t = args_of["A (view 0)"][2].tile_counts
        sort_ms = cs.median_ms(torch, lambda: binning.heaviest_first(counts_t),
                               queued=True)
        sort_n, _ = cs.device_launches(
            torch, lambda: binning.heaviest_first(counts_t))
        print(f"[time] the heaviest-first order alone: {sort_ms:.4f} ms "
              f"queued, {sort_n} device launches", flush=True)
        it = [cs.FIRST_ITER + 1]

        def timed_step():
            step(it[0])
            it[0] += 1

        def render():
            with torch.no_grad():
                return model.render(cams[0])

        walls = {}
        for turn in ("heaviest first", "launch order", "launch order",
                     "heaviest first") * 2:
            lib = "launch_order" if turn == "launch order" else "committed"
            _build._loaded["uvtex_fused"] = libs["uvtex_fused"][lib]
            ctx = (launch_order(torch, cs, kf, uvr) if turn == "launch order"
                   else contextlib.nullcontext())
            with ctx:
                r_ms = cs.median_ms(torch, render)
                s_ms = cs.median_ms(torch, timed_step)
                r_n, _ = cs.device_launches(torch, render)
            walls.setdefault(turn, []).append((r_ms, s_ms, r_n))
        _build._loaded["uvtex_fused"] = libs["uvtex_fused"]["committed"]
        for turn, rows in walls.items():
            print(f"[time] A's tiles {turn}: render of view 0 "
                  + " and ".join(f"{r:.3f}" for r, _, _ in rows)
                  + " ms, training step "
                  + " and ".join(f"{s:.3f}" for _, s, _ in rows)
                  + f" ms (medians of {cs.REPS}, {len(rows)} turns); render device "
                  f"launches {rows[0][2]}", flush=True)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
