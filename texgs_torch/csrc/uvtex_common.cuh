// Device code shared by kernel A (uvtex_fused.cu), its backward A'
// (uvtex_fused_bwd.cu), kernel 1 (raster.cu), its backward 1'
// (raster_bwd.cu), kernel 2 (uvtex_mlist.cu) and its backward 2'
// (uvtex_mlist_bwd.cu): constants, the staging of one pair's record, the
// per-pixel alpha, the uv intersection and the transpose of the tile
// shift.  A backward replays its forward's alpha, T and stop decisions,
// and the two-kernel render's M-lists must follow its blend's, so all six
// must round every operation of that chain the same way: one definition
// here keeps them from drifting apart.

#pragma once

#include <cuda_runtime.h>

namespace texgs {

constexpr int TILE = 16;
constexpr int PIX = TILE * TILE;
constexpr float ALPHA_CLAMP = 0.99f;
constexpr float MIN_ALPHA = 1.0f / 255.0f;
constexpr float T_STOP = 1e-4f;
constexpr float T_STAR_MAX = 1e4f;
// columns of tile_raster.build_gauss_table
constexpr int COL_LOGOP = 6;
constexpr int COL_F0 = 7;
constexpr int COL_ANCHOR = 14;
constexpr int TABLE_FIXED = 16;
constexpr int N_FIXED_F = 7;
// columns of uvtex_raster.build_uv_rows: sv(3) siginv(6) base_uv(3) J(9) pad
constexpr int UV_COLS = 24;
constexpr int UV_USED = 21;

// The exponent and its tile shift are rounded once per operation, in the
// order of the plain version's tensor expressions (tile_raster.shift_to_tile
// and tile_power), so the compiler cannot contract them into FMAs: kernel,
// backward and plain version then make the same alpha = 1/255 and
// power > 0 decisions.
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }

struct Rays {
  float ax[3], by[3], c0[3];  // d(px, py) = c0 + px * ax + py * by
};

__device__ __forceinline__ void pixel_ray(const Rays& rays, float px, float py,
                                          float d[3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
    d[i] = rays.c0[i] + px * rays.ax[i] + py * rays.by[i];
}

// Column of the table that holds blend channel f.
__device__ __forceinline__ int feature_col(int f) {
  return f < N_FIXED_F ? COL_F0 + f : TABLE_FIXED + f - N_FIXED_F;
}

// Stage one pair's blend record: the Gaussian's exponent quadratic shifted
// from its anchor tile into the tile at (tile_x, tile_y) (tile_raster.
// shift_to_tile), its log-opacity and its NF blend channels.  q receives
// [qxx, qyy, qxy, qx, qy, qc, logop].  Kernels 1 and 1' (raster*.cu) stage
// this alone; A, A', 2 and 2' add the uv row (stage_record; 2 and 2' with
// NF = 0 and no channels).
template <int NF>
__device__ __forceinline__ void stage_quad(const float* __restrict__ row,
                                           float tile_x, float tile_y,
                                           float* q, float* feat) {
  const float dtx = tile_x - row[COL_ANCHOR];
  const float dty = tile_y - row[COL_ANCHOR + 1];
  const float qxx = row[0], qyy = row[1], qxy = row[2];
  const float qx_a = row[3], qy_a = row[4], qc_a = row[5];
  q[0] = qxx;
  q[1] = qyy;
  q[2] = qxy;
  q[3] = add(add(qx_a, mul(mul(2.f, qxx), dtx)), mul(qxy, dty));
  q[4] = add(add(qy_a, mul(mul(2.f, qyy), dty)), mul(qxy, dtx));
  q[5] = add(add(add(add(add(qc_a, mul(mul(qxx, dtx), dtx)),
                             mul(mul(qyy, dty), dty)),
                         mul(mul(qxy, dtx), dty)),
                     mul(qx_a, dtx)),
                 mul(qy_a, dty));
  q[6] = row[COL_LOGOP];
#pragma unroll
  for (int f = 0; f < NF; ++f) feat[f] = row[feature_col(f)];
}

// stage_quad plus the pair's uv row (kernels A, A', 2 and 2').
template <int NF>
__device__ __forceinline__ void stage_record(const float* __restrict__ row,
                                             const float* __restrict__ uv,
                                             float tile_x, float tile_y,
                                             float* q, float* feat,
                                             float* uv_out) {
  stage_quad<NF>(row, tile_x, tile_y, q, feat);
#pragma unroll
  for (int k = 0; k < UV_USED; ++k) uv_out[k] = uv[k];
}

// The transpose of shift_to_tile: the gradient dq of the tile-frame
// quadratic [qxx, qyy, qxy, qx, qy, qc] taken back to the anchor frame,
// for the shift (dtx, dty) = tile corner - anchor corner.
__device__ __forceinline__ void unshift_grad(const float dq[6], float dtx,
                                             float dty, float out[6]) {
  out[0] = dq[0] + 2.f * dtx * dq[3] + dtx * dtx * dq[5];
  out[1] = dq[1] + 2.f * dty * dq[4] + dty * dty * dq[5];
  out[2] = dq[2] + dty * dq[3] + dtx * dq[4] + dtx * dty * dq[5];
  out[3] = dq[3] + dtx * dq[5];
  out[4] = dq[4] + dty * dq[5];
  out[5] = dq[5];
}

// The exponent at tile-local pixel (x, y) (tile_raster.tile_power).
__device__ __forceinline__ float pixel_power(float x, float y, const float* q) {
  return add(add(add(add(add(mul(x * x, q[0]), mul(y * y, q[1])),
                         mul(x * y, q[2])),
                     mul(x, q[3])),
                 mul(y, q[4])),
             q[5]);
}

// alpha = min(0.99, exp(power)), zeroed where power - logop > 0 or
// alpha < 1/255 (tile_raster.chunk_weights).  *e receives exp(power).
__device__ __forceinline__ float pixel_alpha(float power, float logop,
                                             float* e) {
  *e = expf(power);
  float alpha = fminf(*e, ALPHA_CLAMP);
  if (power - logop > 0.f) alpha = 0.f;
  if (alpha < MIN_ALPHA) alpha = 0.f;
  return alpha;
}

// uvtex_raster.intersect_uv for one ray and one Gaussian's uv row r, with
// the intermediates the backward needs.
struct Intersection {
  float uvn[3];    // the unit uv the M-list stores
  float jd[3];     // J d
  float t_raw;     // num / den before the clamp to [0, T_STAR_MAX]
  float den;       // den after the |den| < 1e-20 guard
  bool den_small;  // the guard replaced den
  float norm;      // |uv| before the normalisation
};

__device__ __forceinline__ Intersection intersect(const float d[3],
                                                  const float* r) {
  Intersection it;
  const float dx = d[0], dy = d[1], dz = d[2];
  const float num = dx * r[0] + dy * r[1] + dz * r[2];
  float den = dx * dx * r[3] + 2.f * dx * dy * r[4] + 2.f * dx * dz * r[5] +
              dy * dy * r[6] + 2.f * dy * dz * r[7] + dz * dz * r[8];
  it.den_small = fabsf(den) < 1e-20f;
  if (it.den_small) den = 1e-20f;
  it.den = den;
  it.t_raw = num / den;
  const float t = fminf(fmaxf(it.t_raw, 0.f), T_STAR_MAX);
  float u[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    it.jd[i] = dx * r[12 + 3 * i] + dy * r[13 + 3 * i] + dz * r[14 + 3 * i];
    u[i] = r[9 + i] + t * it.jd[i];
  }
  it.norm = sqrtf(u[0] * u[0] + u[1] * u[1] + u[2] * u[2]);
  const float s = it.norm + 1e-12f;
#pragma unroll
  for (int i = 0; i < 3; ++i) it.uvn[i] = u[i] / s;
  return it;
}

// The VJP of intersect into the uv row's first 12 entries [sv, siginv,
// base_uv], for the cotangent g of the unit uv, through the normalisation,
// t* (active for 0 <= t* <= 1e4, as torch.clamp's gradient is) and J d.  J
// is a constant of the render: its columns get no gradient.
__device__ __forceinline__ void intersect_grad(const float d[3],
                                               const Intersection& it,
                                               const float g[3],
                                               float out[12]) {
  const float s = it.norm + 1e-12f;
  const float dot = it.uvn[0] * g[0] + it.uvn[1] * g[1] + it.uvn[2] * g[2];
  float du[3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
    du[i] = g[i] / s - (it.norm > 0.f ? it.uvn[i] * dot / it.norm : 0.f);
  float g_t = du[0] * it.jd[0] + du[1] * it.jd[1] + du[2] * it.jd[2];
  if (!(it.t_raw >= 0.f && it.t_raw <= T_STAR_MAX)) g_t = 0.f;
  const float g_num = g_t / it.den;
  const float g_den = it.den_small ? 0.f : -g_t * it.t_raw / it.den;
  const float dx = d[0], dy = d[1], dz = d[2];
  out[0] = g_num * dx;
  out[1] = g_num * dy;
  out[2] = g_num * dz;
  out[3] = g_den * dx * dx;
  out[4] = g_den * 2.f * dx * dy;
  out[5] = g_den * 2.f * dx * dz;
  out[6] = g_den * dy * dy;
  out[7] = g_den * 2.f * dy * dz;
  out[8] = g_den * dz * dz;
  out[9] = du[0];
  out[10] = du[1];
  out[11] = du[2];
}

}  // namespace texgs
