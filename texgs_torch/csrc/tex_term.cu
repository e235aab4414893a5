// Kernel B: the stage-3 texture term, sum over slots of C0 * w * tex(dir),
// for every pixel's M-list.
//
// Replaces the TPU kernel texgs/kernels/pallas_textile.py:568 (_fwd_kernel
// of textile_apply, :774, launched at :799; entry tex_term_textile, :988).
// It computes the exact function of texgs/kernels/uvtex_raster.py:385
// mlist_tex_term, whose port is the plain PyTorch version
// (texgs_torch/kernels/tex_term.py, mlist_tex_term).
//
// Design.  One thread block per 16x16 tile, one thread per pixel.  For each
// slot with w != 0 the thread reads the slot as one float4 and samples the
// (6, R, R, 3) cubemap: 4 bilinear taps (1 at 'nearest'), each a 12-byte
// texel read straight from device memory through L2.  A tap past a face
// edge is re-resolved through its 3D direction onto the adjacent face, and
// a tap past a cube corner averages the 3 texels that meet there
// (cube_tap; texgs/kernels/cubemap.py:111-153).  The TPU kernel worked
// over VMEM windows, a mip atlas and a 16^2 catch-all pack because TPU
// gathers are slow, and those approximate this function; here every tap is
// fetched exactly, so nothing can miss.
//
// Bound on Hopper: bytes.  The M-list read (m * 16 bytes a pixel) and the
// texels touched dominate; a live slot costs about 300 f32 operations.  The
// coordinate arithmetic that picks a texel uses explicitly rounded
// intrinsics (__fmul_rn, __fadd_rn), so the compiler cannot contract it
// into FMAs and pick a different texel than the plain version at a
// boundary.

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

// One bilinear tap: its texel, or the average of a cube corner's three.
__device__ __forceinline__ float3 cube_tap(const float* __restrict__ tex,
                                           int res, float lim, bool seamless,
                                           int face, float xi, float yi) {
  int idx[3];
  if (tap_texels(res, lim, seamless, face, xi, yi, idx) == 1)
    return texel(tex, idx[0]);
  const float3 p = texel(tex, idx[0]), q = texel(tex, idx[1]),
               r = texel(tex, idx[2]);
  return make_float3(__fdiv_rn(p.x + q.x + r.x, 3.f),
                     __fdiv_rn(p.y + q.y + r.y, 3.f),
                     __fdiv_rn(p.z + q.z + r.z, 3.f));
}

// cubemap.sample_cubemap for one direction
__device__ __forceinline__ float3 sample_cube(const float* __restrict__ tex,
                                              int res, float lim, int mode,
                                              float dx, float dy, float dz) {
  if (mode == NEAREST) {
    int face;
    float u, v;
    dir_to_face_uv(dx, dy, dz, face, u, v);
    return texel(tex, texel_at(res, face, texel_index(v, res),
                               texel_index(u, res)));
  }
  const Footprint fp = footprint(res, dx, dy, dz);
  const bool seamless = mode == BILINEAR;
  const float3 t00 = cube_tap(tex, res, lim, seamless, fp.face, fp.x0, fp.y0);
  const float3 t10 =
      cube_tap(tex, res, lim, seamless, fp.face, fp.x0 + 1.f, fp.y0);
  const float3 t01 =
      cube_tap(tex, res, lim, seamless, fp.face, fp.x0, fp.y0 + 1.f);
  const float3 t11 =
      cube_tap(tex, res, lim, seamless, fp.face, fp.x0 + 1.f, fp.y0 + 1.f);
  const float wx = fp.wx, wy = fp.wy;
  const float ax = 1.f - wx, ay = 1.f - wy;
  const float3 top = make_float3(t00.x * ax + t10.x * wx,
                                 t00.y * ax + t10.y * wx,
                                 t00.z * ax + t10.z * wx);
  const float3 bot = make_float3(t01.x * ax + t11.x * wx,
                                 t01.y * ax + t11.y * wx,
                                 t01.z * ax + t11.z * wx);
  return make_float3(top.x * ay + bot.x * wy, top.y * ay + bot.y * wy,
                     top.z * ay + bot.z * wy);
}

__global__ void __launch_bounds__(PIX)
    tex_term_forward(const float4* __restrict__ mlist,
                     const float* __restrict__ tex, int res, float lim,
                     int mode, int m, int gx, int height, int width,
                     float* __restrict__ out) {
  const int tile = blockIdx.x;
  const int tid = threadIdx.x;
  const float4* list = mlist + (static_cast<size_t>(tile) * PIX + tid) * m;
  float r = 0.f, g = 0.f, b = 0.f;
  for (int s = 0; s < m; ++s) {
    const float4 e = list[s];
    if (e.x == 0.f) continue;  // w = 0 adds 0 * tex
    const float3 t = sample_cube(tex, res, lim, mode, e.y, e.z, e.w);
    r += e.x * t.x;
    g += e.x * t.y;
    b += e.x * t.z;
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

}  // namespace

// (3, height, width) texture term of the (n_tiles, 256, m, 4) M-lists over
// the (6, res, res, 3) cubemap.  mode: 0 bilinear (seamless), 1 bilinear
// clamped at face edges, 2 nearest.  Returns the launch's
// cudaGetLastError().
extern "C" int tex_term_forward(const void* mlist, const void* texture,
                                int res, int mode, int n_tiles, int m, int gx,
                                int height, int width, void* out,
                                void* stream) {
  if (n_tiles <= 0) return 0;
  if (m <= 0 || res <= 0 || mode < BILINEAR || mode > NEAREST)
    return static_cast<int>(cudaErrorInvalidValue);
  const float lim = static_cast<float>(1.0 - 1.0 / res);
  tex_term_forward<<<n_tiles, PIX, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(mlist), static_cast<const float*>(texture),
      res, lim, mode, m, gx, height, width, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
