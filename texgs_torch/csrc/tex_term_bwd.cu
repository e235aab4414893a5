// Kernel B': the backward of kernel B, the VJP of the stage-3 texture term
// C0 * sum over slots of w * tex(dir) into the M-lists and the cubemap.
//
// Replaces the TPU kernel texgs/kernels/pallas_textile.py:626 (_bwd_kernel
// of textile_apply, :774, launched at :848).  It computes the exact VJP of
// texgs/kernels/uvtex_raster.py:385 mlist_tex_term, whose port's autograd
// is the plain PyTorch version (texgs_torch/kernels/tex_term.py,
// mlist_tex_term_vjp).
//
// What it computes, per live slot (w != 0) of a pixel with image cotangent
// g (3 channels):
//   d w   = C0 <g, tex(dir)>;
//   d dir = C0 w <g, d tex / d dir>, through the bilinear fractions wx, wy
//           (the texels themselves are picked by floors and carry none) and
//           the gnomonic face projection u = u_sel / |major axis|;
//   d texel += C0 w g * (bilinear weight of the tap); a cube-corner tap
//           gives a third to each of its three texels, as cube_tap
//           averages them.
// 'nearest' carries no direction gradient.  A dead slot (w = 0) and a
// pixel outside the image get zeros, written by a select.
//
// Design.  One thread per M-list slot: the threads run flat over the
// (n_tiles, 256, m) slots, slot fastest, so a warp reads its 32 slots as
// 512 contiguous bytes and writes their cotangents the same way.  Slot i
// belongs to pixel i / m, whose cotangent g every thread of the pixel
// reads (at m = 32 a warp is one pixel; at other m a warp straddles
// pixels).  The texel scatter adds each tap texel's 3 channels with one
// vector atomic (red.global.add.v4.f32) into a (6, R, R, 4) accumulator
// padded to 16 bytes a texel; a second kernel packs it to (6, R, R, 3).
// The taps are picked by the same code as kernel B's (cubemap_taps.cuh),
// so the scatter lands on exactly the texels the forward read.
//
// No merge of the scatter within the warp: the slots of a pixel lie on
// one ray and share texels, yet the lanes that add into one texel in the
// same tap's round are few (1.31 a group at the flagship step), and
// finding them (__match_any_sync) and summing them (shuffles or
// shared-memory atomics) cost more than the vector atomics they save
// (scripts/ab_tex_term.py builds the merge as a variant and times it).
//
// Bound on Hopper: bytes.  The M-list is read and its cotangent written
// (2 m 16 bytes a pixel); the touched texels are read once per tap and
// updated atomically: at the flagship step 27 M tap texels, one L2 atomic
// each (the parent design issued 3 scalar ones each), which take about
// half of the kernel's time.

#include <cuda_runtime.h>

#include <climits>

#include "cubemap_taps.cuh"

namespace {

using namespace texgs;

constexpr int TILE = 16;
constexpr int PIX = TILE * TILE;
constexpr int BLOCK = 256;

__device__ __forceinline__ float3 texel(const float* __restrict__ tex,
                                        int at) {
  const float* p = tex + static_cast<size_t>(at) * 3;
  return make_float3(__ldg(p), __ldg(p + 1), __ldg(p + 2));
}

__device__ __forceinline__ float dot3(float3 a, float3 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z;
}

// The texels of one tap and the weight each receives of the slot's scaled
// cotangent: n = 0 where the slot adds nothing.
struct Tap {
  int idx[3];
  int n;
  float weight;
};

// One tap: its value (as cube_tap forms it); its texels and scatter weight
// go to t.
__device__ __forceinline__ float3 tap(const float* __restrict__ tex, int res,
                                      float lim, bool seamless, int face,
                                      float xi, float yi, float weight,
                                      Tap& t) {
  t.n = tap_texels(res, lim, seamless, face, xi, yi, t.idx);
  if (t.n == 1) {
    t.weight = weight;
    return texel(tex, t.idx[0]);
  }
  const float3 p = texel(tex, t.idx[0]), q = texel(tex, t.idx[1]),
               r = texel(tex, t.idx[2]);
  t.weight = weight / 3.f;
  return make_float3(__fdiv_rn(p.x + q.x + r.x, 3.f),
                     __fdiv_rn(p.y + q.y + r.y, 3.f),
                     __fdiv_rn(p.z + q.z + r.z, 3.f));
}

// Direction cotangent from the face-coordinate cotangents (g_u, g_v):
// the transpose of cubemap.direction_to_face_uv.
__device__ __forceinline__ float3 face_uv_vjp(const Footprint& fp, float dx,
                                              float dy, float dz, float g_u,
                                              float g_v) {
  const float ma = fmaxf(fp.ma_raw, 1e-12f);
  const float gu = g_u / ma, gv = g_v / ma;
  // u = u_sel / ma: d ma = -(g_u u + g_v v) / ma, none where ma is clamped
  const float g_ma = fp.ma_raw >= 1e-12f ? -(g_u * fp.u + g_v * fp.v) / ma
                                         : 0.f;
  auto sgn = [](float a) { return a > 0.f ? 1.f : (a < 0.f ? -1.f : 0.f); };
  switch (fp.face) {
    case 0: return make_float3(g_ma * sgn(dx), -gv, -gu);    // u=-z v=-y
    case 1: return make_float3(g_ma * sgn(dx), -gv, gu);     // u= z v=-y
    case 2: return make_float3(gu, g_ma * sgn(dy), gv);      // u= x v= z
    case 3: return make_float3(gu, g_ma * sgn(dy), -gv);     // u= x v=-z
    case 4: return make_float3(gu, -gv, g_ma * sgn(dz));     // u= x v=-y
    default: return make_float3(-gu, -gv, g_ma * sgn(dz));   // u=-x v=-y
  }
}

// Adds v into texel t of the padded accumulator with one vector atomic.
__device__ __forceinline__ void add_texel(float4* __restrict__ d_acc, int t,
                                          float3 v) {
  atomicAdd(d_acc + t, make_float4(v.x, v.y, v.z, 0.f));
}

__global__ void __launch_bounds__(BLOCK)
    tex_term_backward(const float4* __restrict__ mlist,
                      const float* __restrict__ tex, int res, float lim,
                      int mode, int m, int gx, int height, int width,
                      const float* __restrict__ g_img,
                      float4* __restrict__ d_mlist,
                      float4* __restrict__ d_acc) {
  const int slot = blockIdx.x * BLOCK + threadIdx.x;
  const int pix = slot / m;
  const int tile = pix / PIX, tid = pix % PIX;
  const int y = (tile / gx) * TILE + tid / TILE;
  const int x = (tile % gx) * TILE + tid % TILE;
  float3 g = make_float3(0.f, 0.f, 0.f);
  if (y < height && x < width) {
    const size_t plane = static_cast<size_t>(height) * width;
    const size_t at = static_cast<size_t>(y) * width + x;
    g = make_float3(g_img[at], g_img[plane + at], g_img[2 * plane + at]);
  }
  const bool has_g = g.x != 0.f || g.y != 0.f || g.z != 0.f;
  const float fres = static_cast<float>(res);
  const float4 e = mlist[slot];
  float4 out = make_float4(0.f, 0.f, 0.f, 0.f);
  float3 gs = make_float3(0.f, 0.f, 0.f);
  Tap taps[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) taps[k] = Tap{{0, 0, 0}, 0, 0.f};
  if (e.x != 0.f && has_g) {
    gs = make_float3(C0 * e.x * g.x, C0 * e.x * g.y, C0 * e.x * g.z);
    if (mode == NEAREST) {
      int face;
      float u, v;
      dir_to_face_uv(e.y, e.z, e.w, face, u, v);
      const float3 t = tap(tex, res, lim, false, face,
                           static_cast<float>(texel_index(u, res)),
                           static_cast<float>(texel_index(v, res)), 1.f,
                           taps[0]);
      out.x = C0 * dot3(g, t);
    } else {
      const Footprint fp = footprint(res, e.y, e.z, e.w);
      const bool seamless = mode == BILINEAR;
      const float wx = fp.wx, wy = fp.wy, ax = 1.f - wx, ay = 1.f - wy;
      const float3 t00 = tap(tex, res, lim, seamless, fp.face, fp.x0, fp.y0,
                             ax * ay, taps[0]);
      const float3 t10 = tap(tex, res, lim, seamless, fp.face, fp.x0 + 1.f,
                             fp.y0, wx * ay, taps[1]);
      const float3 t01 = tap(tex, res, lim, seamless, fp.face, fp.x0,
                             fp.y0 + 1.f, ax * wy, taps[2]);
      const float3 t11 = tap(tex, res, lim, seamless, fp.face, fp.x0 + 1.f,
                             fp.y0 + 1.f, wx * wy, taps[3]);
      const float3 top = make_float3(t00.x * ax + t10.x * wx,
                                     t00.y * ax + t10.y * wx,
                                     t00.z * ax + t10.z * wx);
      const float3 bot = make_float3(t01.x * ax + t11.x * wx,
                                     t01.y * ax + t11.y * wx,
                                     t01.z * ax + t11.z * wx);
      const float3 t = make_float3(top.x * ay + bot.x * wy,
                                   top.y * ay + bot.y * wy,
                                   top.z * ay + bot.z * wy);
      out.x = C0 * dot3(g, t);
      // d tex / d wx and d wy, then d wx / d u = d wy / d v = res / 2
      const float3 dwx = make_float3(
          (t10.x - t00.x) * ay + (t11.x - t01.x) * wy,
          (t10.y - t00.y) * ay + (t11.y - t01.y) * wy,
          (t10.z - t00.z) * ay + (t11.z - t01.z) * wy);
      const float3 dwy = make_float3(
          (t01.x - t00.x) * ax + (t11.x - t10.x) * wx,
          (t01.y - t00.y) * ax + (t11.y - t10.y) * wx,
          (t01.z - t00.z) * ax + (t11.z - t10.z) * wx);
      const float g_u = dot3(gs, dwx) * 0.5f * fres;
      const float g_v = dot3(gs, dwy) * 0.5f * fres;
      const float3 gd = face_uv_vjp(fp, e.y, e.z, e.w, g_u, g_v);
      out.y = gd.x;
      out.z = gd.y;
      out.w = gd.z;
    }
  }
  d_mlist[slot] = out;

  // the texel scatter: a vector atomic a tap texel
  const int n_taps = mode == NEAREST ? 1 : 4;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (k == n_taps) break;
    const Tap& t = taps[k];
    const float3 v = make_float3(t.weight * gs.x, t.weight * gs.y,
                                 t.weight * gs.z);
    if (t.n > 0 && t.weight != 0.f) {
      // constant indices keep the taps in registers
      add_texel(d_acc, t.idx[0], v);
      if (t.n == 3) {
        add_texel(d_acc, t.idx[1], v);
        add_texel(d_acc, t.idx[2], v);
      }
    }
  }
}

// The (n, 3) texture gradient from the padded (n, 4) accumulator.
__global__ void __launch_bounds__(BLOCK)
    pack_texels(const float4* __restrict__ d_acc, int n,
                float* __restrict__ d_tex) {
  const int i = blockIdx.x * BLOCK + threadIdx.x;
  if (i >= n) return;
  const float4 a = d_acc[i];
  float* p = d_tex + static_cast<size_t>(i) * 3;
  p[0] = a.x;
  p[1] = a.y;
  p[2] = a.z;
}

}  // namespace

// VJP of kernel B: d_mlist (n_tiles, 256, m, 4), written whole, and the
// texture gradient added into d_texture4, a (6, res, res, 4) accumulator
// (texels padded to 16 bytes), which the caller zeroes; tex_term_pack then
// writes the (6, res, res, 3) gradient.  g_img is the (3, height, width)
// cotangent of the texture term.  The n_tiles * 256 * m slots must fit an
// int.  Returns the launch's cudaGetLastError().
extern "C" int tex_term_backward(const void* mlist, const void* texture,
                                 int res, int mode, int n_tiles, int m,
                                 int gx, int height, int width,
                                 const void* g_img, void* d_mlist,
                                 void* d_texture4, void* stream) {
  if (n_tiles <= 0) return 0;
  if (m <= 0 || res <= 0 || mode < BILINEAR || mode > NEAREST ||
      static_cast<long long>(n_tiles) * PIX * m > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const float lim = static_cast<float>(1.0 - 1.0 / res);
  // PIX * m slots a tile: a whole number of blocks
  const int blocks = n_tiles * (PIX / BLOCK) * m;
  tex_term_backward<<<blocks, BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(mlist), static_cast<const float*>(texture),
      res, lim, mode, m, gx, height, width, static_cast<const float*>(g_img),
      static_cast<float4*>(d_mlist), static_cast<float4*>(d_texture4));
  return static_cast<int>(cudaGetLastError());
}

// d_texture (n_texels, 3) from tex_term_backward's (n_texels, 4)
// accumulator.  Returns the launch's cudaGetLastError().
extern "C" int tex_term_pack(const void* d_texture4, int n_texels,
                             void* d_texture, void* stream) {
  if (n_texels <= 0) return 0;
  pack_texels<<<(n_texels + BLOCK - 1) / BLOCK, BLOCK, 0,
                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(d_texture4), n_texels,
      static_cast<float*>(d_texture));
  return static_cast<int>(cudaGetLastError());
}
