// Kernel M: the viewer's two texture maps of the stage-3 cubemap, straight
// from its SH0 texels: the equirectangular panorama (H, W, 3) and the cross
// image (3R, 4R, 3), each texel through sh02rgb (clamp(C0 * sh0 + 0.5, 0,
// 1)) as it is read.
//
// Replaces no TPU kernel: texgs computes both maps with XLA ops
// (texgs/kernels/cubemap.py, cubemap_to_latlong and faces_to_cross, after
// sh02rgb), and so did the port's plain PyTorch chain
// (texgs_torch/kernels/cubemap.py), which stays as this kernel's plain
// version: at a 1024^2 cubemap and a 512x1024 panorama it took 794 device
// launches a frame (the seamless sample_cubemap's ~150 small ops a tap,
// two sh02rgb passes over the texture, a zero fill of the cross and six
// copies into it).
//
// Design.  Two grids, one launch each, one entry point each.
//  - latlong: one thread a panorama pixel.  It computes the pixel's
//    direction with sinf/cosf as the plain version does, picks the face,
//    the four seamless taps and a cube corner's three texels with the
//    explicitly rounded helpers of cubemap_taps.cuh (the texels kernel B
//    reads), applies sh02rgb to each texel as it reads it (the plain
//    version clamps the whole texture first), and blends top, bottom, then
//    the row weight with explicitly rounded products and sums in the plain
//    version's order.  It rounds as the plain version does on CUDA
//    tensors: there PyTorch divides a tensor by a Python number as a
//    product with the number's float reciprocal, so the pixel centres
//    (y + 0.5) / h and (x + 0.5) / w and the corner mean's / 3 are such
//    products here too.  The seamless taps' (xi + 0.5) / res is a quotient
//    in the helpers (kernel B's): the same value for a power-of-two R, and
//    for any R it only decides which texel an edge tap reads, with a
//    margin of 1 / res, so no R changes a pick.
//  - cross: a flat, coalesced pass over the output, four floats (one
//    16-byte store) a thread.  Each float is sh02rgb of its face texel or
//    zero where the cross is empty, so every element is written once: no
//    zero fill and no second pass.
// Any R and any (H, W); the grids follow the shapes.
//
// Bound on Hopper: bytes.  The cross writes 36 R^2 floats and reads the
// 18 R^2 of the texture; the panorama writes 3 H W floats (its texel reads
// hit L2 after the cross's or the render's).  A panorama pixel costs about
// 400 f32 operations, far below the bytes' time at these shapes.

#include <cuda_runtime.h>

#include "cubemap_taps.cuh"

namespace {

using namespace texgs;

constexpr int BLOCK = 256;
constexpr float PI = 3.14159265358979323846f;  // float32(math.pi), as torch
constexpr float THIRD = 1.f / 3.f;  // the float reciprocal of 3.0

// sh02rgb: clamp(C0 * s + 0.5, 0, 1), rounded after each operation as the
// plain version's tensor ops are; a NaN stays NaN, as in torch.clamp.
__device__ __forceinline__ float sh0_to_rgb(float s) {
  const float c = __fadd_rn(__fmul_rn(C0, s), 0.5f);
  return c < 0.f ? 0.f : (c > 1.f ? 1.f : c);
}

__device__ __forceinline__ float3 rgb_texel(const float* __restrict__ sh0,
                                            int at) {
  const float* p = sh0 + static_cast<size_t>(at) * 3;
  return make_float3(sh0_to_rgb(__ldg(p)), sh0_to_rgb(__ldg(p + 1)),
                     sh0_to_rgb(__ldg(p + 2)));
}

// One seamless bilinear tap: its texel, or the mean of a cube corner's
// three ((P + Q + R) * (1 / 3) in the plain version's order).
__device__ __forceinline__ float3 rgb_tap(const float* __restrict__ sh0,
                                          int res, float lim, int face,
                                          float xi, float yi) {
  int idx[3];
  if (tap_texels(res, lim, true, face, xi, yi, idx) == 1)
    return rgb_texel(sh0, idx[0]);
  const float3 p = rgb_texel(sh0, idx[0]), q = rgb_texel(sh0, idx[1]),
               r = rgb_texel(sh0, idx[2]);
  return make_float3(__fmul_rn(__fadd_rn(__fadd_rn(p.x, q.x), r.x), THIRD),
                     __fmul_rn(__fadd_rn(__fadd_rn(p.y, q.y), r.y), THIRD),
                     __fmul_rn(__fadd_rn(__fadd_rn(p.z, q.z), r.z), THIRD));
}

// a * wa + b * wb, each product and the sum rounded
__device__ __forceinline__ float lerp_rn(float a, float wa, float b, float wb) {
  return __fadd_rn(__fmul_rn(a, wa), __fmul_rn(b, wb));
}

__device__ __forceinline__ float3 lerp3(float3 a, float wa, float3 b,
                                        float wb) {
  return make_float3(lerp_rn(a.x, wa, b.x, wb), lerp_rn(a.y, wa, b.y, wb),
                     lerp_rn(a.z, wa, b.z, wb));
}

// cubemap.cubemap_to_latlong of sh02rgb(sh0): pixel (y, x) of the (h, w)
// panorama samples the direction (sin t sin p, cos t, -sin t cos p) at
// t = pi (y + 0.5) / h, p = 2 pi (x + 0.5) / w - pi; inv_h and inv_w are
// the float reciprocals of h and w.
__global__ void __launch_bounds__(BLOCK)
    latlong_kernel(const float* __restrict__ sh0, int res, float lim, int h,
                   int w, float inv_h, float inv_w, float* __restrict__ out) {
  const long long pix = static_cast<long long>(blockIdx.x) * BLOCK +
                        threadIdx.x;
  if (pix >= static_cast<long long>(h) * w) return;
  const int y = static_cast<int>(pix / w), x = static_cast<int>(pix % w);
  const float gv = __fmul_rn(__fadd_rn(static_cast<float>(y), 0.5f), inv_h);
  const float gu = __fmul_rn(__fadd_rn(static_cast<float>(x), 0.5f), inv_w);
  const float theta = __fmul_rn(gv, PI);
  const float phi = __fadd_rn(__fmul_rn(__fmul_rn(gu, 2.f), PI), -PI);
  const float st = sinf(theta), ct = cosf(theta);
  const float sp = sinf(phi), cp = cosf(phi);
  const Footprint fp = footprint(res, __fmul_rn(st, sp), ct,
                                 __fmul_rn(-st, cp));
  const float3 t00 = rgb_tap(sh0, res, lim, fp.face, fp.x0, fp.y0);
  const float3 t10 = rgb_tap(sh0, res, lim, fp.face, fp.x0 + 1.f, fp.y0);
  const float3 t01 = rgb_tap(sh0, res, lim, fp.face, fp.x0, fp.y0 + 1.f);
  const float3 t11 =
      rgb_tap(sh0, res, lim, fp.face, fp.x0 + 1.f, fp.y0 + 1.f);
  const float ax = __fadd_rn(1.f, -fp.wx), ay = __fadd_rn(1.f, -fp.wy);
  const float3 top = lerp3(t00, ax, t10, fp.wx);
  const float3 bot = lerp3(t01, ax, t11, fp.wx);
  const float3 c = lerp3(top, ay, bot, fp.wy);
  float* o = out + pix * 3;
  o[0] = c.x;
  o[1] = c.y;
  o[2] = c.z;
}

// The face in block (br, bc) of the cross, -1 where it is empty
// (cubemap.CROSS_BLOCKS: +x (1, 2), -x (1, 0), +y (0, 1), -y (2, 1),
// +z (1, 1), -z (1, 3)).
__device__ __forceinline__ int cross_face(int br, int bc) {
  if (br == 1) return bc == 0 ? 1 : (bc == 1 ? 4 : (bc == 2 ? 0 : 5));
  if (bc != 1) return -1;
  return br == 0 ? 2 : 3;
}

// cubemap.faces_to_cross of sh02rgb(sh0).  A cross row holds 12 R floats
// (4 blocks of R texels of 3), so no float4 of the output straddles two
// rows; it can straddle two blocks of a row.  Within block bc of row
// (br, yr), float k of the block is float k of texture row (face, yr).
__global__ void __launch_bounds__(BLOCK)
    cross_kernel(const float* __restrict__ sh0, int res,
                 long long n4, float4* __restrict__ out) {
  const long long q = static_cast<long long>(blockIdx.x) * BLOCK +
                      threadIdx.x;
  if (q >= n4) return;
  const int seg = 3 * res;  // floats of one block of a row
  const long long e0 = q * 4;
  const int row = static_cast<int>(e0 / (4 * seg));
  const int in_row = static_cast<int>(e0 - static_cast<long long>(row) * 4 * seg);
  const int br = row / res, yr = row - br * res;
  const int bc0 = in_row / seg;
  float v[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int e = in_row + k;
    const int bc = e >= (bc0 + 1) * seg ? bc0 + 1 : bc0;
    const int f = cross_face(br, bc);
    v[k] = f < 0 ? 0.f
                 : sh0_to_rgb(__ldg(sh0 + static_cast<size_t>(f * res + yr) *
                                             seg + (e - bc * seg)));
  }
  out[q] = make_float4(v[0], v[1], v[2], v[3]);
}

}  // namespace

// Into `out` the (h, w, 3) panorama of the (6, res, res, 3) SH0 cubemap
// `sh0`: one launch.  Returns cudaGetLastError() after it.
extern "C" int cubemap_latlong(const void* sh0, int res, int h, int w,
                               void* out, void* stream) {
  if (res <= 0 || h <= 0 || w <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long n_pix = static_cast<long long>(h) * w;
  // the reciprocals as PyTorch forms them: 1.0f / float(n), on the host
  latlong_kernel<<<static_cast<unsigned>((n_pix + BLOCK - 1) / BLOCK), BLOCK,
                   0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(sh0), res,
      static_cast<float>(1.0 - 1.0 / res), h, w,
      1.f / static_cast<float>(h), 1.f / static_cast<float>(w),
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

// Into `out` the (3 res, 4 res, 3) cross image of the (6, res, res, 3) SH0
// cubemap `sh0`: one launch.  Returns cudaGetLastError() after it.
extern "C" int cubemap_cross(const void* sh0, int res, void* out,
                             void* stream) {
  if (res <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long n4 = 9LL * res * res;  // 36 res^2 floats, 4 a thread
  cross_kernel<<<static_cast<unsigned>((n4 + BLOCK - 1) / BLOCK), BLOCK, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(sh0), res, n4, static_cast<float4*>(out));
  return static_cast<int>(cudaGetLastError());
}
