// Device code shared by kernel G (uvtex_rows.cu), the per-Gaussian rows of
// the stage-3 render, and its backward G' (uvtex_rows_bwd.cu): the inputs
// each takes by value and the forward chain of one Gaussian.  G' recomputes
// G's intermediates from the inputs instead of reading them from memory,
// so both must round every operation the same way: one definition here
// keeps them together.
//
// The chain is the plain version's (kernels/uvtex_raster.py uvtex_rows_plain:
// uvtex_raster.build_uvtex_tables and build_uv_rows, and
// tile_raster.build_gauss_table) for one Gaussian.  Its elementwise
// operations are rounded one at a time, in the order of the plain
// version's tensor expressions (project_common.cuh's __f*_rn helpers, so
// the compiler cannot contract them into FMAs), and the quaternion's norm
// is summed in the order of torch's reduction on the card (row_norm).  So
// G's rows equal the plain chain's on the card bit for bit.

#pragma once

#include <cuda_runtime.h>

#include "project_common.cuh"

namespace texgs {
namespace rows {

using proj::add;
using proj::div;
using proj::mul;
using proj::sub;

constexpr float TILE = 16.f;             // reference.TILE
constexpr int TABLE_FIXED = 16;          // tile_raster.TABLE_FIXED
constexpr int UV_COLS = 24;              // uvtex_raster.UV_COLS
constexpr float SCALE_SQ_MIN = 1e-24f;   // build_uvtex_tables' clamp
constexpr float OPACITY_MIN = 1e-12f;    // build_gauss_table's clamp

// G's and G''s inputs: the Gaussians' rows, contiguous float32, and the
// camera centre, filled on the host (kernels/uvtex_raster.py _Inputs) and
// passed by value: no host-to-device copy.  Keep the two layouts in step.
struct Inputs {
  const float* xyz;        // (N, 3)
  const float* scaling;    // (N, 3) activated scales
  const float* rotation;   // (N, 4) wxyz quaternions
  const float* uvs;        // (N, 3) uv centres
  const float* jac;        // (N, 9) duv/dxyz row-major, a constant
  const float* means2d;    // (N, 2) projected centres (band-local)
  const float* depths;     // (N,)
  const float* conics;     // (N, 3)
  const float* opacities;  // (N,)
  const float* normals;    // (N, 3)
  const float* colors;     // (N, 3) the base (SH residual) colours
  const float* extra;      // (N, n_extra), null where n_extra = 0
  int n_extra;
  float campos[3];         // the camera centre
};

// torch.clamp(v, min=lo): a NaN stays NaN.
__device__ __forceinline__ float clamp_min(float v, float lo) {
  return v < lo ? lo : v;
}

// torch.linalg.norm of a row of four on the card: a lane a square, the
// lanes' sum taken at shuffle offsets 2, then 1.
__device__ __forceinline__ float row_norm(const float* q) {
  return __fsqrt_rn(add(add(mul(q[0], q[0]), mul(q[2], q[2])),
                        add(mul(q[1], q[1]), mul(q[3], q[3]))));
}

// build_uvtex_tables for one Gaussian: Sigma^-1 = R diag(1/s^2) R^T and
// the view vector v = mu - o.
struct Sigma {
  proj::Rotation rot;
  float sq[3];    // s_k * s_k, before the clamp
  float inv[3];   // 1 / max(s_k^2, 1e-24)
  float s[6];     // Sigma^-1 packed (xx, xy, xz, yy, yz, zz)
  float v[3];     // xyz - campos
};

__device__ __forceinline__ Sigma sigma_of(const Inputs& in, long long k) {
  Sigma o;
  const float* q = in.rotation + 4 * k;
  o.rot = proj::rotation_with_norm(q[0], q[1], q[2], q[3], row_norm(q));
  const float* r = o.rot.r;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float s = in.scaling[3 * k + c];
    o.sq[c] = mul(s, s);
    // 1.0 / x is torch's reciprocal(x) * 1.0: one rounding
    o.inv[c] = div(1.f, clamp_min(o.sq[c], SCALE_SQ_MIN));
  }
  // entry (a, b): i0 r_a0 r_b0 + i1 r_a1 r_b1 + i2 r_a2 r_b2, left to right
  const int I[6] = {0, 0, 0, 1, 1, 2}, J[6] = {0, 1, 2, 1, 2, 2};
#pragma unroll
  for (int e = 0; e < 6; ++e) {
    const int a = I[e], b = J[e];
    float acc = mul(mul(o.inv[0], r[3 * a]), r[3 * b]);
    acc = add(acc, mul(mul(o.inv[1], r[3 * a + 1]), r[3 * b + 1]));
    o.s[e] = add(acc, mul(mul(o.inv[2], r[3 * a + 2]), r[3 * b + 2]));
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) o.v[c] = sub(in.xyz[3 * k + c], in.campos[c]);
  return o;
}

// Row i of the packed symmetric matrix s, as three entries.
__device__ __forceinline__ void sym_row(const float* s, int i, float* row) {
  const int at[3][3] = {{0, 1, 2}, {1, 3, 4}, {2, 4, 5}};
#pragma unroll
  for (int j = 0; j < 3; ++j) row[j] = s[at[i][j]];
}

// build_gauss_table's anchor-frame terms for one Gaussian.
struct Quad {
  float anchor_x, anchor_y;  // floor(m / 16) * 16
  float mxa, mya;            // the centre in the anchor frame
  float logop;               // log(max(opacity, 1e-12))
};

__device__ __forceinline__ Quad quad_of(const Inputs& in, long long k) {
  Quad o;
  const float mx = in.means2d[2 * k], my = in.means2d[2 * k + 1];
  // m / 16 is exact as torch's product with the reciprocal 1/16 is
  o.anchor_x = mul(floorf(div(mx, TILE)), TILE);
  o.anchor_y = mul(floorf(div(my, TILE)), TILE);
  o.mxa = sub(mx, o.anchor_x);
  o.mya = sub(my, o.anchor_y);
  o.logop = logf(clamp_min(in.opacities[k], OPACITY_MIN));
  return o;
}

}  // namespace rows
}  // namespace texgs
