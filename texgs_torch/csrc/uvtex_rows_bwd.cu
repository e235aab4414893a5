// Kernel G': the VJP of kernel G (uvtex_rows.cu), the per-Gaussian rows of
// the stage-3 render, one Gaussian a thread, in one launch.
//
// Replaces no TPU kernel: texgs differentiates its XLA rows
// (texgs/kernels/uvtex_raster.py, tile_raster.py) with JAX's autodiff, and
// the port's plain chain (texgs_torch/kernels/uvtex_raster.py
// uvtex_rows_plain) with autograd, which stays as this kernel's plain
// version.  On the H100 autograd's pass through that chain took ~390 device
// launches a training step, in the step's most idle phase (benchmark
// `backward`).
//
// Design.  A thread recomputes its Gaussian's forward intermediates from
// the inputs (uvtex_rows_common.cuh, rounded as kernel G rounds them), then
// writes the exact VJP of the plain chain, term for term as autograd forms
// it:
//  - the table's quadratic into the conic and the anchor-frame centre, the
//    anchor (a floor) passing no gradient, so the centre's gradient is the
//    projected mean's;
//  - the log-opacity (columns 5 and 6) into the opacity, where it lies at
//    or above the 1e-12 clamp (torch.clamp's backward);
//  - the blend channels (colour, depth, normal, extra) through unchanged;
//  - base_uv = uv - J v into the uv and the view vector (J is a constant);
//  - Sigma^-1 v and Sigma^-1 into the view vector and Sigma^-1's entries,
//    those into the reciprocal squared scales and the rotation matrix
//    (project_common.cuh packed_rdr_vjp), the scales through the clamp at
//    1e-24, the matrix into the quaternion through rotation_channels'
//    renormalisation (project_common.cuh rotation_vjp);
//  - the view vector v = mu - o into the mean.
// The cotangents of the table and the uv rows are read through their
// strides (autograd may hand a broadcast), either may be absent (zero),
// and each gradient is written once, in full, so nothing needs a zero
// fill: one launch a differentiated render.
//
// Bound on Hopper: bytes, and far below a launch.  A Gaussian reads 112 B
// of inputs (all of G's but the colour, depth and normal, whose cotangents
// pass straight through) and 112 of cotangents (16 table and 12 uv-row
// columns) and writes 92 (xyz, scaling, rotation, uvs, means2d, depth,
// conic, opacity, normal; 104 and 116 with the colours and E = 3 extras):
// 32 MB at 100,000 Gaussians, 0.0094 ms at 3.35 TB/s, against ~330 f32
// operations a Gaussian (the forward replayed and its transpose; 33
// MFLOP).

#include <cuda_runtime.h>

#include "uvtex_rows_common.cuh"

namespace texgs {
namespace rows {

// The C entry's argument structs live in a named namespace: a type of the
// anonymous one would give the entry internal linkage.
//
// The cotangents of G's outputs, null where autograd has none; strides in
// elements.  The layout is ctypes' (uvtex_raster.py _Cotangents).
struct Cotangents {
  const float* table;    // (N, 16 + E)
  const float* uv_rows;  // (N, 24)
  long long table_s0, table_s1, uv_rows_s0, uv_rows_s1;
};

// Where the gradients go, null where none is wanted; contiguous, shaped as
// the inputs.  The layout is ctypes' (uvtex_raster.py _Gradients).
struct Gradients {
  float* xyz;
  float* scaling;
  float* rotation;
  float* uvs;
  float* means2d;
  float* depths;
  float* conics;
  float* opacities;
  float* normals;
  float* colors;
  float* extra;
};

}  // namespace rows
}  // namespace texgs

namespace {

using namespace texgs::rows;

constexpr int BLOCK = 256;

__device__ __forceinline__ float at(const float* p, long long i) {
  return p == nullptr ? 0.f : p[i];
}

__global__ void __launch_bounds__(BLOCK)
uvtex_rows_bwd_kernel(const __grid_constant__ Inputs in, int n,
                      const __grid_constant__ Cotangents g,
                      const __grid_constant__ Gradients d) {
  const int i = blockIdx.x * BLOCK + threadIdx.x;
  if (i >= n) return;
  const long long k = i;
  const long long t0 = k * g.table_s0, u0 = k * g.uv_rows_s0;

  // ---- the table (build_gauss_table)
  float gt[TABLE_FIXED];
#pragma unroll
  for (int j = 0; j < TABLE_FIXED; ++j) gt[j] = at(g.table, t0 + j * g.table_s1);
  if (d.means2d != nullptr || d.conics != nullptr || d.opacities != nullptr) {
    const Quad q = quad_of(in, k);
    const float a = in.conics[3 * k], b = in.conics[3 * k + 1],
                c = in.conics[3 * k + 2];
    const float mxa = q.mxa, mya = q.mya;
    // qxx = -a / 2, qyy = -c / 2, qxy = -b
    float da = -0.5f * gt[0], dc = -0.5f * gt[1], db = -gt[2];
    // qx = a mx' + b my'
    da += gt[3] * mxa;
    db += gt[3] * mya;
    float d_mxa = gt[3] * a, d_mya = gt[3] * b;
    // qy = c my' + b mx'
    dc += gt[4] * mya;
    db += gt[4] * mxa;
    d_mya += gt[4] * c;
    d_mxa += gt[4] * b;
    // qc = -(a mx' mx' + c my' my') / 2 - b mx' my' + logop, each product
    // taken left to right
    const float d_sum = -0.5f * gt[5];
    const float d_amx = d_sum * mxa, d_cmy = d_sum * mya;
    d_mxa += d_sum * (a * mxa) + d_amx * a;
    da += d_amx * mxa;
    d_mya += d_sum * (c * mya) + d_cmy * c;
    dc += d_cmy * mya;
    const float d_bmx = -gt[5] * mya;
    d_mya += -gt[5] * (b * mxa);
    db += d_bmx * mxa;
    d_mxa += d_bmx * b;
    if (d.means2d != nullptr) {
      d.means2d[2 * k] = d_mxa;
      d.means2d[2 * k + 1] = d_mya;
    }
    if (d.conics != nullptr) {
      d.conics[3 * k] = da;
      d.conics[3 * k + 1] = db;
      d.conics[3 * k + 2] = dc;
    }
    if (d.opacities != nullptr) {
      // log(max(op, 1e-12)): 1 / op where op is at or above the clamp
      const float op = in.opacities[k];
      d.opacities[k] = op >= OPACITY_MIN ? (gt[5] + gt[6]) / op : 0.f;
    }
  }
  if (d.colors != nullptr)
    for (int j = 0; j < 3; ++j) d.colors[3 * k + j] = gt[7 + j];
  if (d.depths != nullptr) d.depths[k] = gt[10];
  if (d.normals != nullptr)
    for (int j = 0; j < 3; ++j) d.normals[3 * k + j] = gt[11 + j];
  if (d.extra != nullptr)
    for (int j = 0; j < in.n_extra; ++j)
      d.extra[in.n_extra * k + j] =
          at(g.table, t0 + (TABLE_FIXED + j) * g.table_s1);

  // ---- the uv rows (build_uvtex_tables, build_uv_rows)
  if (d.xyz == nullptr && d.scaling == nullptr && d.rotation == nullptr
      && d.uvs == nullptr)
    return;
  float g_sv[3], g_b[3], dS[6];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    g_sv[j] = at(g.uv_rows, u0 + j * g.uv_rows_s1);
    g_b[j] = at(g.uv_rows, u0 + (9 + j) * g.uv_rows_s1);
  }
#pragma unroll
  for (int e = 0; e < 6; ++e) dS[e] = at(g.uv_rows, u0 + (3 + e) * g.uv_rows_s1);
  if (d.uvs != nullptr)
    for (int j = 0; j < 3; ++j) d.uvs[3 * k + j] = g_b[j];
  const Sigma s = sigma_of(in, k);
  const float* v = s.v;
  const float* jac = in.jac + 9 * k;
  // base_uv = uv - J v, sv = Sigma^-1 v
  float dv[3];
#pragma unroll
  for (int j = 0; j < 3; ++j)
    dv[j] = -(g_b[0] * jac[j] + g_b[1] * jac[3 + j] + g_b[2] * jac[6 + j]);
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    float row[3];
    sym_row(s.s, r, row);
    for (int j = 0; j < 3; ++j) dv[j] += g_sv[r] * row[j];
  }
  dS[0] += g_sv[0] * v[0];
  dS[1] += g_sv[0] * v[1] + g_sv[1] * v[0];
  dS[2] += g_sv[0] * v[2] + g_sv[2] * v[0];
  dS[3] += g_sv[1] * v[1];
  dS[4] += g_sv[1] * v[2] + g_sv[2] * v[1];
  dS[5] += g_sv[2] * v[2];
  if (d.xyz != nullptr)
    for (int j = 0; j < 3; ++j) d.xyz[3 * k + j] = dv[j];
  if (d.scaling == nullptr && d.rotation == nullptr) return;

  float dR[9] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f}, d_inv[3];
  texgs::proj::packed_rdr_vjp(s.rot.r, s.inv, dS, dR, d_inv);
  if (d.scaling != nullptr) {
    for (int c = 0; c < 3; ++c) {
      // inv = reciprocal(max(sq, 1e-24)) * 1.0, sq = s * s
      const float d_sq = s.sq[c] >= SCALE_SQ_MIN
                             ? -d_inv[c] * (s.inv[c] * s.inv[c]) : 0.f;
      const float sc = in.scaling[3 * k + c];
      d.scaling[3 * k + c] = d_sq * sc + d_sq * sc;
    }
  }
  if (d.rotation != nullptr)
    texgs::proj::rotation_vjp(s.rot, in.rotation + 4 * k, dR,
                              d.rotation + 4 * k);
}

}  // namespace

// The VJP of uvtex_rows_forward for the same inputs: one launch on
// `stream`, none for n = 0.  *in, *g and *d are host structs passed to the
// kernel by value.  Returns cudaGetLastError() after the launch.
extern "C" int uvtex_rows_backward(const Inputs* in, int n,
                                   const Cotangents* g, const Gradients* d,
                                   void* stream) {
  if (n < 0 || in->n_extra < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return static_cast<int>(cudaSuccess);
  if (in->n_extra > 0 && in->extra == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  uvtex_rows_bwd_kernel<<<(n + BLOCK - 1) / BLOCK, BLOCK, 0,
                          static_cast<cudaStream_t>(stream)>>>(*in, n, *g,
                                                               *d);
  return static_cast<int>(cudaGetLastError());
}
