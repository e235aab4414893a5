// Kernel A: blend channels + per-pixel M-lists of the stage-3 render, in
// one pass over each tile's depth-sorted pairs.
//
// Replaces the TPU kernel texgs/kernels/pallas_uvtex_fused.py:45
// (_fused_fwd_kernel, launched by fused_pairs at :263 / :303).  Plain
// PyTorch version: texgs_torch/kernels/uvtex_fused.py, mlist_scan.
//
// Design.  One thread block per 16x16 tile and one thread per pixel.  The
// block walks its tile's pairs [tile_start, tile_end) in batches of BATCH:
// each thread stages one pair's record into shared memory (the Gaussian's
// exponent quadratic shifted into this tile's frame, its blend channels
// and its uv row, all read by Gaussian index), then every pixel runs the
// sequential front-to-back loop over the batch, reading the records as
// shared-memory broadcasts.  A pixel writes slot `count` of its M-list
// while count < m, and the block leaves as soon as every pixel has stopped
// (__syncthreads_count).  On the TPU the grid walked 128-pair chunks in
// order and carried T, `done` and the list count in scratch from one grid
// step to the next; here those carries are registers of the pixel's
// thread.
//
// Semantics (texgs/kernels/reference.py; pallas_raster.py:138-160):
//   power = the tile-local quadratic (log-opacity folded in), evaluated
//     at tile-local pixel coordinates 0..15, which keeps it well
//     conditioned in f32 (texgs/kernels/tile_raster.py:36-46);
//   alpha = min(0.99, exp(power)); alpha = 0 where power - logop > 0 or
//     alpha < 1/255;
//   an entry with T * (1 - alpha) < 1e-4 is NOT composited, and the pixel
//     stops there;
//   w = alpha * T, and an entry joins the M-list iff w > 0.
// T_final follows the scan's product form (tile_raster.chunk_blend): the
// running product of (1 - alpha), not the Pallas kernel's log-sum.  The uv
// is normalised as uvtex_raster.intersect_uv does, uv / (|uv| + 1e-12), not
// with the Pallas kernel's rsqrt(max(|uv|^2, 1e-24)).
//
// Bound on Hopper: bytes.  The M-list output is m * 16 bytes a pixel
// (512 B at m = 32), more than the per-pair records and the blend output
// together at the flagship shape; the work per evaluated (pixel, pair) is
// about 16 + 2F f32 operations, and about 60 more for each M-list slot.
// The design reads each record once per block and shares it among the
// tile's 256 pixels, and writes each slot as one 16-byte store.

#include <cuda_runtime.h>

#include <cstring>

namespace {

constexpr int TILE = 16;
constexpr int PIX = TILE * TILE;
constexpr int BATCH = PIX;  // one staged record per thread
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
// and tile_power), so the compiler cannot contract them into FMAs: both
// versions then make the same alpha = 1/255 and power > 0 decisions.
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }

struct Rays {
  float ax[3], by[3], c0[3];  // d(px, py) = c0 + px * ax + py * by
};

// uvtex_raster.intersect_uv for one ray and one Gaussian's uv row r.
__device__ __forceinline__ float3 intersect_uv(const float d[3],
                                               const float* r) {
  const float dx = d[0], dy = d[1], dz = d[2];
  const float num = dx * r[0] + dy * r[1] + dz * r[2];
  float den = dx * dx * r[3] + 2.f * dx * dy * r[4] + 2.f * dx * dz * r[5] +
              dy * dy * r[6] + 2.f * dy * dz * r[7] + dz * dz * r[8];
  if (fabsf(den) < 1e-20f) den = 1e-20f;
  const float t = fminf(fmaxf(num / den, 0.f), T_STAR_MAX);
  float u[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float jd = dx * r[12 + 3 * i] + dy * r[13 + 3 * i] +
                     dz * r[14 + 3 * i];
    u[i] = r[9 + i] + t * jd;
  }
  const float nrm = sqrtf(u[0] * u[0] + u[1] * u[1] + u[2] * u[2]) + 1e-12f;
  return make_float3(u[0] / nrm, u[1] / nrm, u[2] / nrm);
}

template <int NF>
__global__ void __launch_bounds__(PIX)
    fused_forward(const float* __restrict__ table, int tab_cols,
                  const float* __restrict__ uv_rows,
                  const int* __restrict__ pair_gauss,
                  const int* __restrict__ tile_start,
                  const int* __restrict__ tile_end, Rays rays, int gx, int m,
                  float* __restrict__ blend, float* __restrict__ t_final,
                  float4* __restrict__ mlist, int* __restrict__ n_eval) {
  __shared__ float s_quad[BATCH][8];  // 6 coefficients, log-opacity, pad
  __shared__ float s_feat[BATCH][NF];
  __shared__ float s_uv[BATCH][UV_USED];

  const int tile = blockIdx.x;
  const int tid = threadIdx.x;
  const float tile_x = static_cast<float>((tile % gx) * TILE);
  const float tile_y = static_cast<float>((tile / gx) * TILE);
  const float x = static_cast<float>(tid % TILE);
  const float y = static_cast<float>(tid / TILE);
  const float px = tile_x + x, py = tile_y + y;
  float d[3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
    d[i] = rays.c0[i] + px * rays.ax[i] + py * rays.by[i];

  const int start = tile_start[tile], end = tile_end[tile];
  const size_t pix = static_cast<size_t>(tile) * PIX + tid;
  float4* list = mlist + pix * m;
  float acc[NF];
#pragma unroll
  for (int f = 0; f < NF; ++f) acc[f] = 0.f;
  float T = 1.f;
  bool done = false;
  int count = 0, evals = 0;

  for (int base = start; base < end; base += BATCH) {
    // every thread takes part, so this also fences the previous batch's
    // shared-memory reads before the records are overwritten
    if (__syncthreads_count(!done) == 0) break;
    const int j = base + tid;
    if (j < end) {
      const int g = pair_gauss[j];
      const float* row = table + static_cast<size_t>(g) * tab_cols;
      // tile_raster.shift_to_tile: anchor frame -> this tile's frame
      const float dtx = tile_x - row[COL_ANCHOR];
      const float dty = tile_y - row[COL_ANCHOR + 1];
      const float qxx = row[0], qyy = row[1], qxy = row[2];
      const float qx_a = row[3], qy_a = row[4], qc_a = row[5];
      float* q = s_quad[tid];
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
      for (int f = 0; f < NF; ++f)
        s_feat[tid][f] =
            row[f < N_FIXED_F ? COL_F0 + f : TABLE_FIXED + f - N_FIXED_F];
      const float* uv = uv_rows + static_cast<size_t>(g) * UV_COLS;
#pragma unroll
      for (int k = 0; k < UV_USED; ++k) s_uv[tid][k] = uv[k];
    }
    __syncthreads();

    const int n_batch = min(BATCH, end - base);
    for (int k = 0; k < n_batch && !done; ++k) {
      const float* q = s_quad[k];
      const float power =
          add(add(add(add(add(mul(x * x, q[0]), mul(y * y, q[1])),
                          mul(x * y, q[2])),
                      mul(x, q[3])),
                  mul(y, q[4])),
              q[5]);
      float alpha = fminf(expf(power), ALPHA_CLAMP);
      if (power - q[6] > 0.f) alpha = 0.f;
      if (alpha < MIN_ALPHA) alpha = 0.f;
      ++evals;
      const float t_next = T * (1.f - alpha);
      if (t_next < T_STOP) {
        done = true;
        break;
      }
      const float w = alpha * T;
#pragma unroll
      for (int f = 0; f < NF; ++f) acc[f] += w * s_feat[k][f];
      T = t_next;
      if (w > 0.f) {
        if (count < m) {
          const float3 uv = intersect_uv(d, s_uv[k]);
          list[count] = make_float4(w, uv.x, uv.y, uv.z);
        }
        ++count;
      }
    }
  }

#pragma unroll
  for (int f = 0; f < NF; ++f) blend[pix * NF + f] = acc[f];
  t_final[pix] = T;
  n_eval[pix] = evals;
  for (int s = min(count, m); s < m; ++s)
    list[s] = make_float4(0.f, 0.f, 0.f, 0.f);
}

template <int NF>
void launch(const void* table, int tab_cols, const void* uv_rows,
            const void* pair_gauss, const void* tile_start,
            const void* tile_end, const Rays& rays, int n_tiles, int gx,
            int m, void* blend, void* t_final, void* mlist, void* n_eval,
            cudaStream_t stream) {
  fused_forward<NF><<<n_tiles, PIX, 0, stream>>>(
      static_cast<const float*>(table), tab_cols,
      static_cast<const float*>(uv_rows), static_cast<const int*>(pair_gauss),
      static_cast<const int*>(tile_start), static_cast<const int*>(tile_end),
      rays, gx, m, static_cast<float*>(blend), static_cast<float*>(t_final),
      static_cast<float4*>(mlist), static_cast<int*>(n_eval));
}

}  // namespace

// Blend channels (n_tiles, 256, n_f), T_final (n_tiles, 256), M-lists
// (n_tiles, 256, m, 4) and evaluated-pair counts (n_tiles, 256) of every
// tile.  rays9 is host memory [ax, by, c0].  Returns the launch's
// cudaGetLastError().
extern "C" int uvtex_fused_forward(const void* table, int tab_cols,
                                   const void* uv_rows, const void* pair_gauss,
                                   const void* tile_start,
                                   const void* tile_end, const float* rays9,
                                   int n_tiles, int gx, int n_f, int m,
                                   void* blend, void* t_final, void* mlist,
                                   void* n_eval, void* stream) {
  if (n_tiles <= 0) return 0;
  if (m <= 0 || tab_cols != TABLE_FIXED + n_f - N_FIXED_F)
    return static_cast<int>(cudaErrorInvalidValue);
  Rays rays;
  std::memcpy(rays.ax, rays9, 3 * sizeof(float));
  std::memcpy(rays.by, rays9 + 3, 3 * sizeof(float));
  std::memcpy(rays.c0, rays9 + 6, 3 * sizeof(float));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define TEXGS_CASE(NF)                                                       \
  case NF:                                                                   \
    launch<NF>(table, tab_cols, uv_rows, pair_gauss, tile_start, tile_end,  \
               rays, n_tiles, gx, m, blend, t_final, mlist, n_eval, s);     \
    break;
  // the stage-3 path blends rgb, depth and normal (F = 7), plus the three
  // no-SH channels when the model has residual SH (F = 10)
  switch (n_f) {
    TEXGS_CASE(7)
    TEXGS_CASE(10)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef TEXGS_CASE
  return static_cast<int>(cudaGetLastError());
}
