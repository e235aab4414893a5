// Kernel 1': the backward of kernel 1 (the stage-1/2 blend).
//
// Replaces the TPU kernel texgs/kernels/pallas_raster.py:359 (_raster_bwd;
// body _bwd_kernel at :214, pallas_call at :383).  Plain PyTorch version:
// texgs_torch/kernels/raster.py, raster_scan_vjp (autograd through
// raster_scan).
//
// What it computes.  The vector-Jacobian product of kernel 1's outputs
// (blend channels, T_final) into the per-Gaussian table (N, 16 + F - 7).
// Built for F = 7 and F = 10, as kernel 1 is.  Per
// (pixel, pair) entry j with weight w_j = alpha_j T_j and channel
// cotangent g_j = sum_F feat_F g_out_F, texgs's suffix form gives
//   d alpha_j = T_j g_j - (sum_{i>j} w_i g_i + T_final g_T) / (1 - alpha_j),
// with sum_{i>j} w_i g_i = tot - prefix_j and tot = sum_F out_F g_out_F,
// and d feat_F = w_j g_out_F.  d power = alpha d alpha where alpha is
// neither zeroed nor clamped at 0.99.
//
// Design.  Kernel A' (uvtex_fused_bwd.cu) without the M-list and uv rows:
// one thread block per 16x16 tile, one thread per pixel.  The block
// replays the tile's pairs in depth order with kernel 1's own alpha, T and
// stop arithmetic (uvtex_common.cuh), so a pixel stops at the same pair as
// in the forward.  All threads walk the pairs in step; a pixel that has
// stopped, and a pair past the tile's end, contribute zeros, written by
// select (texgs multiplies a dead entry's garbage by 0, which lets NaN
// through).  Each pair's 6 + F values (6 quadratic coefficients, F channels)
// are summed over the tile's 256 pixels: warp shuffles reduce them to 8
// partials, which go to shared memory; every GROUP pairs the block adds the
// partials and issues one atomicAdd per pair and nonzero column into the
// per-Gaussian gradient.  The kernel reads the table by Gaussian index and
// shifts the quadratic into the tile's frame itself, so it applies the
// transpose of that shift (unshift_grad) before the atomics.  The
// log-opacity column (used only by the power > 0 skip) and the anchor
// columns (a floor of the projected mean) get no gradient.
//
// Bound on Hopper: operations at the stage-1 shape.  It reads the table
// rows of each tile's pairs, the blend and T_final with their cotangents,
// and writes the gradient; per evaluated (pixel, pair) it does the replay,
// the suffix form and 6 + F warp sums (about 40 + 3F f32 operations).  The
// block reduction is what a later PR would make cheaper.

#include <cuda_runtime.h>

#include "uvtex_common.cuh"

namespace {

using namespace texgs;

constexpr int BATCH = 128;  // pair records staged per pass
constexpr int GROUP = 8;    // pairs whose partial sums wait in shared memory
constexpr int WARPS = PIX / 32;
constexpr unsigned FULL = 0xffffffffu;
constexpr int FEAT = 6;     // first channel value, after the 6 coefficients

template <int NF>
__global__ void __launch_bounds__(PIX)
    raster_bwd(const float* __restrict__ table,
               const int* __restrict__ pair_gauss,
               const int* __restrict__ tile_start,
               const int* __restrict__ tile_end, int gx,
               const float* __restrict__ blend,
               const float* __restrict__ t_final,
               const float* __restrict__ g_blend,
               const float* __restrict__ g_t_final,
               float* __restrict__ d_table) {
  constexpr int TAB_COLS = TABLE_FIXED + NF - N_FIXED_F;
  constexpr int N_COLS = 6 + NF;
  __shared__ float s_quad[BATCH][8];
  __shared__ float s_feat[BATCH][NF];
  __shared__ int s_gauss[BATCH];
  __shared__ float s_shift[BATCH][2];
  __shared__ float s_red[GROUP][WARPS][N_COLS];

  const int tile = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const float tile_x = static_cast<float>((tile % gx) * TILE);
  const float tile_y = static_cast<float>((tile / gx) * TILE);
  const float x = static_cast<float>(tid % TILE);
  const float y = static_cast<float>(tid / TILE);

  const int start = tile_start[tile], end = tile_end[tile];
  const size_t pix = static_cast<size_t>(tile) * PIX + tid;

  float g_out[NF];
  float tot = 0.f;
#pragma unroll
  for (int f = 0; f < NF; ++f) {
    g_out[f] = g_blend[pix * NF + f];
    tot += blend[pix * NF + f] * g_out[f];
  }
  const float bg_term = t_final[pix] * g_t_final[pix];

  float T = 1.f, prefix = 0.f;
  bool done = false;

  for (int base = start; base < end; base += BATCH) {
    if (__syncthreads_count(!done) == 0) break;
    const int j = base + tid;
    if (tid < BATCH && j < end) {
      const int g = pair_gauss[j];
      const float* row = table + static_cast<size_t>(g) * TAB_COLS;
      stage_quad<NF>(row, tile_x, tile_y, s_quad[tid], s_feat[tid]);
      s_gauss[tid] = g;
      s_shift[tid][0] = tile_x - row[COL_ANCHOR];
      s_shift[tid][1] = tile_y - row[COL_ANCHOR + 1];
    }
    __syncthreads();

    const int n_batch = min(BATCH, end - base);
    for (int k0 = 0; k0 < n_batch; k0 += GROUP) {
      for (int kk = 0; kk < GROUP; ++kk) {
        const int k = k0 + kk;
        float v[N_COLS];
#pragma unroll
        for (int c = 0; c < N_COLS; ++c) v[c] = 0.f;
        bool any = false;
        if (k < n_batch && !done) {
          const float* q = s_quad[k];
          float e;
          const float alpha = pixel_alpha(pixel_power(x, y, q), q[6], &e);
          const float t_next = T * (1.f - alpha);
          if (t_next < T_STOP) {
            done = true;
          } else {
            const float w = alpha * T;
            float g_w = 0.f;
#pragma unroll
            for (int f = 0; f < NF; ++f) g_w += s_feat[k][f] * g_out[f];
            prefix += w * g_w;
            const float suffix = tot - prefix;
            const float g_alpha = T * g_w - (suffix + bg_term) / (1.f - alpha);
            const float g_power =
                (alpha > 0.f && e <= ALPHA_CLAMP) ? g_alpha * alpha : 0.f;
            v[0] = x * x * g_power;
            v[1] = y * y * g_power;
            v[2] = x * y * g_power;
            v[3] = x * g_power;
            v[4] = y * g_power;
            v[5] = g_power;
#pragma unroll
            for (int f = 0; f < NF; ++f) v[FEAT + f] = w * g_out[f];
            any = alpha > 0.f;  // alpha = 0 leaves every value 0
            T = t_next;
          }
        }
        // warp sums; a warp none of whose pixels took part writes zeros
        if (__any_sync(FULL, any)) {
#pragma unroll
          for (int c = 0; c < N_COLS; ++c) {
            float a = v[c];
#pragma unroll
            for (int o = 16; o > 0; o >>= 1) a += __shfl_xor_sync(FULL, a, o);
            v[c] = a;
          }
        }
        if (lane == 0) {
#pragma unroll
          for (int c = 0; c < N_COLS; ++c) s_red[kk][warp][c] = v[c];
        }
      }
      __syncthreads();

      // one thread per (pair of the group, output column)
      if (tid < GROUP * N_COLS) {
        const int kk = tid / N_COLS, c = tid % N_COLS;
        const int k = k0 + kk;
        if (k < n_batch) {
          float val;
          int col;
          if (c < 6) {
            float dq[6];
#pragma unroll
            for (int i = 0; i < 6; ++i) {
              float a = 0.f;
#pragma unroll
              for (int wi = 0; wi < WARPS; ++wi) a += s_red[kk][wi][i];
              dq[i] = a;
            }
            float anchor[6];
            unshift_grad(dq, s_shift[k][0], s_shift[k][1], anchor);
            val = anchor[c];
            col = c;
          } else {
            float a = 0.f;
#pragma unroll
            for (int wi = 0; wi < WARPS; ++wi) a += s_red[kk][wi][c];
            val = a;
            col = feature_col(c - FEAT);
          }
          if (val != 0.f)
            atomicAdd(d_table + static_cast<size_t>(s_gauss[k]) * TAB_COLS + col,
                      val);
        }
      }
      __syncthreads();
    }
  }
}

template <int NF>
void launch(const void* table, const void* pair_gauss, const void* tile_start,
            const void* tile_end, int n_tiles, int gx, const void* blend,
            const void* t_final, const void* g_blend, const void* g_t_final,
            void* d_table, cudaStream_t stream) {
  raster_bwd<NF><<<n_tiles, PIX, 0, stream>>>(
      static_cast<const float*>(table), static_cast<const int*>(pair_gauss),
      static_cast<const int*>(tile_start), static_cast<const int*>(tile_end),
      gx, static_cast<const float*>(blend),
      static_cast<const float*>(t_final), static_cast<const float*>(g_blend),
      static_cast<const float*>(g_t_final), static_cast<float*>(d_table));
}

}  // namespace

// Adds the VJP of kernel 1 into d_table (N, tab_cols), which the caller
// zeroes.  blend and t_final are kernel 1's outputs for the same
// arguments, g_blend and g_t_final their cotangents, of the same shapes.
// n_f = 7 and n_f = 10 are built (tab_cols = 16 + n_f - 7).  Returns the
// launch's cudaGetLastError().
extern "C" int raster_backward(const void* table, int tab_cols,
                               const void* pair_gauss, const void* tile_start,
                               const void* tile_end, int n_tiles, int gx,
                               int n_f, const void* blend,
                               const void* t_final, const void* g_blend,
                               const void* g_t_final, void* d_table,
                               void* stream) {
  if (tab_cols != TABLE_FIXED + n_f - N_FIXED_F)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define TEXGS_CASE(NF)                                                       \
  case NF:                                                                   \
    if (n_tiles <= 0) return 0;                                              \
    launch<NF>(table, pair_gauss, tile_start, tile_end, n_tiles, gx, blend,  \
               t_final, g_blend, g_t_final, d_table, s);                     \
    break;
  switch (n_f) {
    TEXGS_CASE(7)
    TEXGS_CASE(10)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef TEXGS_CASE
  return static_cast<int>(cudaGetLastError());
}
