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
// one thread block per 16x16 tile, one thread per pixel, the blocks taking
// the tiles heaviest first (a tile's pairs run one after another in its
// block, so a heavy tile launched late would set the kernel's tail).  The
// block replays the tile's pairs in depth order with kernel 1's own alpha,
// T and stop arithmetic (uvtex_common.cuh), so a pixel stops at the same
// pair as in the forward.  All threads walk the pairs in step; a pixel that
// has stopped, and a pair past the tile's end, contribute zeros, written by
// select (texgs multiplies a dead entry's garbage by 0, which lets NaN
// through).  Each pair's 6 + F values (6 quadratic coefficients, F
// channels) fill one 16-column half of A''s vector, and a warp reduces them
// as A' does when no pixel is in an M-list (warp_reduce.cuh): a
// reduce-scatter over each 16-lane half, one shuffle across the halves, and
// lane c stores column c's warp sum (16 shuffles and one store a lane,
// where a butterfly per column took 5 shuffles a column and 6 + F serial
// stores).  GROUP pairs' warp sums wait in shared memory between two
// barriers; then warp 0 sums each pair's quad columns over the warps and
// takes them back to the anchor frame (the kernel reads the table by
// Gaussian index and shifts the quadratic into the tile's frame itself:
// unshift_grad is the transpose of that shift) once a pair, and the other
// warps sum the channel columns, each issuing one atomicAdd per pair and
// nonzero column into the per-Gaussian gradient.  The block leaves once
// every pixel has stopped.  It takes 58-60 registers, so 4 blocks share an
// SM without a register bound; A''s bound of 64 measured 3-6% slower at
// F = 7 and within 2% at F = 10 (scripts/ab_raster_bwd.py).  The
// log-opacity column (used only by the power > 0 skip) and the anchor
// columns (a floor of the projected mean) get no gradient.
//
// Bound on Hopper: operations at the stage-1 shape.  It reads the table
// rows of each tile's pairs, the blend and T_final with their cotangents,
// and writes the gradient; per evaluated (pixel, pair) it does the replay,
// the suffix form and its share of the block sums (about 40 + 3F f32
// operations).

#include <cuda_runtime.h>

#include <cstdint>

#include "uvtex_common.cuh"
#include "warp_reduce.cuh"

namespace {

using namespace texgs;

constexpr int BATCH = 128;  // pair records staged per pass
constexpr int GROUP = 32;   // pairs whose warp sums wait in shared memory
constexpr int WARPS = PIX / 32;
constexpr int FEAT = 6;     // first channel value, after the 6 coefficients

template <int NF>
__global__ void __launch_bounds__(PIX)
    raster_bwd(const float* __restrict__ table,
               const int* __restrict__ pair_gauss,
               const int* __restrict__ tile_start,
               const int* __restrict__ tile_end,
               const int64_t* __restrict__ tile_order, int gx,
               const float* __restrict__ blend,
               const float* __restrict__ t_final,
               const float* __restrict__ g_blend,
               const float* __restrict__ g_t_final,
               float* __restrict__ d_table) {
  constexpr int TAB_COLS = TABLE_FIXED + NF - N_FIXED_F;
  constexpr int N_COLS = FEAT + NF;
  // a pair's warp sums, warp-major; WARPS * N_COLS is even, so the pad
  // puts lane l of warp 0's epilogue (pair l) on a bank of its own
  constexpr int RED_ROW = WARPS * N_COLS + 1;
  static_assert(N_COLS <= HALF, "quad and channels fill one half");
  static_assert(GROUP == 32, "warp 0 takes one pair of the group a lane");
  __shared__ float s_quad[BATCH][8];
  __shared__ float s_feat[BATCH][NF];
  __shared__ int s_gauss[BATCH];
  __shared__ float s_shift[BATCH][2];
  __shared__ float s_red[GROUP][RED_ROW];

  const int tile = static_cast<int>(tile_order[blockIdx.x]);
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
      const int n_group = min(GROUP, n_batch - k0);
      for (int kk = 0; kk < n_group; ++kk) {
        const int k = k0 + kk;
        // quad (0-5), channels (6..), zeros to the half's end
        float v[HALF];
#pragma unroll
        for (int c = 0; c < HALF; ++c) v[c] = 0.f;
        bool any = false;
        if (!done) {
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
        // the warp's sums, lane c holding column c; a warp none of whose
        // pixels took part writes zeros
        float col = 0.f;
        if (__any_sync(FULL, any)) {
          col = scatter16(v, lane);
          col += __shfl_xor_sync(FULL, col, HALF);
        }
        if (lane < N_COLS) s_red[kk][warp * N_COLS + lane] = col;
      }
      // the block leaves after this group once every pixel has stopped
      const bool live = __syncthreads_count(!done) > 0;

      if (warp == 0) {
        // one lane per pair: its quad columns summed over the warps and
        // taken back to the anchor frame
        if (lane < n_group) {
          const int k = k0 + lane;
          float dq[6];
#pragma unroll
          for (int i = 0; i < 6; ++i) {
            float sum = 0.f;
#pragma unroll
            for (int wi = 0; wi < WARPS; ++wi)
              sum += s_red[lane][wi * N_COLS + i];
            dq[i] = sum;
          }
          float anchor[6];
          unshift_grad(dq, s_shift[k][0], s_shift[k][1], anchor);
          float* out = d_table + static_cast<size_t>(s_gauss[k]) * TAB_COLS;
#pragma unroll
          for (int i = 0; i < 6; ++i)
            if (anchor[i] != 0.f) atomicAdd(out + i, anchor[i]);
        }
      } else {
        // the other warps: one (pair, channel) at a time
        for (int i = tid - 32; i < n_group * NF; i += PIX - 32) {
          const int kk = i / NF, f = i % NF;
          float sum = 0.f;
#pragma unroll
          for (int wi = 0; wi < WARPS; ++wi)
            sum += s_red[kk][wi * N_COLS + FEAT + f];
          if (sum != 0.f)
            atomicAdd(d_table + static_cast<size_t>(s_gauss[k0 + kk]) *
                                    TAB_COLS + feature_col(f),
                      sum);
        }
      }
      __syncthreads();
      if (!live) return;
    }
  }
}

template <int NF>
void launch(const void* table, const void* pair_gauss, const void* tile_start,
            const void* tile_end, const void* tile_order, int n_tiles, int gx,
            const void* blend, const void* t_final, const void* g_blend,
            const void* g_t_final, void* d_table, cudaStream_t stream) {
  raster_bwd<NF><<<n_tiles, PIX, 0, stream>>>(
      static_cast<const float*>(table), static_cast<const int*>(pair_gauss),
      static_cast<const int*>(tile_start), static_cast<const int*>(tile_end),
      static_cast<const int64_t*>(tile_order), gx,
      static_cast<const float*>(blend), static_cast<const float*>(t_final),
      static_cast<const float*>(g_blend),
      static_cast<const float*>(g_t_final), static_cast<float*>(d_table));
}

}  // namespace

// Adds the VJP of kernel 1 into d_table (N, tab_cols), which the caller
// zeroes.  blend and t_final are kernel 1's outputs for the same
// arguments, g_blend and g_t_final their cotangents, of the same shapes.
// tile_order is a permutation of the n_tiles tiles (int64), the order in
// which the blocks take them: heaviest first (binning.heaviest_first), so
// that a heavy tile does not start last and set the kernel's tail.  n_f = 7
// and n_f = 10 are built (tab_cols = 16 + n_f - 7).  Returns the launch's
// cudaGetLastError().
extern "C" int raster_backward(const void* table, int tab_cols,
                               const void* pair_gauss, const void* tile_start,
                               const void* tile_end, const void* tile_order,
                               int n_tiles, int gx, int n_f,
                               const void* blend, const void* t_final,
                               const void* g_blend, const void* g_t_final,
                               void* d_table, void* stream) {
  if (tab_cols != TABLE_FIXED + n_f - N_FIXED_F)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define TEXGS_CASE(NF)                                                       \
  case NF:                                                                   \
    if (n_tiles <= 0) return 0;                                              \
    launch<NF>(table, pair_gauss, tile_start, tile_end, tile_order, n_tiles, \
               gx, blend, t_final, g_blend, g_t_final, d_table, s);          \
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
