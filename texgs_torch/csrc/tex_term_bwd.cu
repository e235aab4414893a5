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
//   d texel += C0 w g * (bilinear weight of the tap), one atomicAdd per
//           texel and channel; a cube-corner tap gives a third to each of
//           its three texels, as cube_tap averages them.
// 'nearest' carries no direction gradient.  A dead slot (w = 0) and a
// pixel outside the image get zeros, written by a select.
//
// Design.  One thread block per 16x16 tile, one thread per pixel, as
// kernel B; the taps are picked by the same code (cubemap_taps.cuh), so the
// scatter lands on exactly the texels the forward read.
//
// Bound on Hopper: bytes.  The M-list is read and its cotangent written
// (2 m 16 bytes a pixel); the touched texels are read once per tap and
// updated atomically, which bounds it where many taps share a texel.

#include <cuda_runtime.h>

#include "cubemap_taps.cuh"

namespace {

using namespace texgs;

constexpr int TILE = 16;
constexpr int PIX = TILE * TILE;

__device__ __forceinline__ float3 texel(const float* __restrict__ tex,
                                        int at) {
  const float* p = tex + static_cast<size_t>(at) * 3;
  return make_float3(__ldg(p), __ldg(p + 1), __ldg(p + 2));
}

__device__ __forceinline__ float dot3(float3 a, float3 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z;
}

// One tap: its value (as cube_tap forms it) and, if gs is not zero, the
// scatter of weight * gs into its texels.
__device__ __forceinline__ float3 tap(const float* __restrict__ tex,
                                      float* __restrict__ d_tex, int res,
                                      float lim, bool seamless, int face,
                                      float xi, float yi, float weight,
                                      float3 gs) {
  int idx[3];
  const int n = tap_texels(res, lim, seamless, face, xi, yi, idx);
  float3 val;
  if (n == 1) {
    val = texel(tex, idx[0]);
  } else {
    const float3 p = texel(tex, idx[0]), q = texel(tex, idx[1]),
                 r = texel(tex, idx[2]);
    val = make_float3(__fdiv_rn(p.x + q.x + r.x, 3.f),
                      __fdiv_rn(p.y + q.y + r.y, 3.f),
                      __fdiv_rn(p.z + q.z + r.z, 3.f));
    weight = weight / 3.f;
  }
  if (weight != 0.f) {
    for (int i = 0; i < n; ++i) {
      float* p = d_tex + static_cast<size_t>(idx[i]) * 3;
      atomicAdd(p, weight * gs.x);
      atomicAdd(p + 1, weight * gs.y);
      atomicAdd(p + 2, weight * gs.z);
    }
  }
  return val;
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

__global__ void __launch_bounds__(PIX)
    tex_term_backward(const float4* __restrict__ mlist,
                      const float* __restrict__ tex, int res, float lim,
                      int mode, int m, int gx, int height, int width,
                      const float* __restrict__ g_img,
                      float4* __restrict__ d_mlist,
                      float* __restrict__ d_tex) {
  const int tile = blockIdx.x;
  const int tid = threadIdx.x;
  const size_t pix = static_cast<size_t>(tile) * PIX + tid;
  const float4* list = mlist + pix * m;
  float4* d_list = d_mlist + pix * m;
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
  for (int s = 0; s < m; ++s) {
    const float4 e = list[s];
    float4 out = make_float4(0.f, 0.f, 0.f, 0.f);
    if (e.x != 0.f && has_g) {
      const float3 gs = make_float3(C0 * e.x * g.x, C0 * e.x * g.y,
                                    C0 * e.x * g.z);
      if (mode == NEAREST) {
        int face;
        float u, v;
        dir_to_face_uv(e.y, e.z, e.w, face, u, v);
        const float3 t = tap(tex, d_tex, res, lim, false, face,
                             static_cast<float>(texel_index(u, res)),
                             static_cast<float>(texel_index(v, res)), 1.f, gs);
        out.x = C0 * dot3(g, t);
      } else {
        const Footprint fp = footprint(res, e.y, e.z, e.w);
        const bool seamless = mode == BILINEAR;
        const float wx = fp.wx, wy = fp.wy, ax = 1.f - wx, ay = 1.f - wy;
        const float3 t00 = tap(tex, d_tex, res, lim, seamless, fp.face, fp.x0,
                               fp.y0, ax * ay, gs);
        const float3 t10 = tap(tex, d_tex, res, lim, seamless, fp.face,
                               fp.x0 + 1.f, fp.y0, wx * ay, gs);
        const float3 t01 = tap(tex, d_tex, res, lim, seamless, fp.face, fp.x0,
                               fp.y0 + 1.f, ax * wy, gs);
        const float3 t11 = tap(tex, d_tex, res, lim, seamless, fp.face,
                               fp.x0 + 1.f, fp.y0 + 1.f, wx * wy, gs);
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
    d_list[s] = out;
  }
}

}  // namespace

// VJP of kernel B: d_mlist (n_tiles, 256, m, 4), written whole, and
// d_texture (6, res, res, 3), which the caller zeroes and the kernel adds
// into.  g_img is the (3, height, width) cotangent of the texture term.
// Returns the launch's cudaGetLastError().
extern "C" int tex_term_backward(const void* mlist, const void* texture,
                                 int res, int mode, int n_tiles, int m,
                                 int gx, int height, int width,
                                 const void* g_img, void* d_mlist,
                                 void* d_texture, void* stream) {
  if (n_tiles <= 0) return 0;
  if (m <= 0 || res <= 0 || mode < BILINEAR || mode > NEAREST)
    return static_cast<int>(cudaErrorInvalidValue);
  const float lim = static_cast<float>(1.0 - 1.0 / res);
  tex_term_backward<<<n_tiles, PIX, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(mlist), static_cast<const float*>(texture),
      res, lim, mode, m, gx, height, width, static_cast<const float*>(g_img),
      static_cast<float4*>(d_mlist), static_cast<float*>(d_texture));
  return static_cast<int>(cudaGetLastError());
}
