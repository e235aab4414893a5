// Kernel 1: the front-to-back blend of stages 1 and 2 (rgb, depth, normal)
// and of the two-kernel stage-3 render over each tile's depth-sorted pairs,
// with the final transmittance.
//
// Replaces the TPU kernel texgs/kernels/pallas_raster.py:309 (raster_pairs;
// body _fwd_kernel at :182 with _chunk_core at :138, pallas_call at :345).
// Plain PyTorch version: texgs_torch/kernels/raster.py, raster_scan.
//
// Design.  Kernel A (uvtex_fused.cu) without the M-list: one thread block
// per 16x16 tile and one thread per pixel; the blocks take the tiles in
// the order `tile_order` gives (heaviest first on the main paths:
// binning.heaviest_first), so that a heavy tile does not start last and
// set the kernel's tail.  The block walks its tile's pairs
// [tile_start, tile_end) in batches of 256: each thread stages one pair's
// record into shared memory (the exponent quadratic shifted into this
// tile's frame, the log-opacity and the F blend channels, read by
// Gaussian index; uvtex_common.cuh stage_quad), then every pixel runs the
// front-to-back loop over the batch, reading the records as shared-memory
// broadcasts.  The loop takes the pairs LOOK at a time: it first computes
// the LOOK alphas (they do not depend on T), so their exponents and exps
// overlap, then applies them one by one with the exact stop rule; alphas
// computed past a stop are discarded.  Every value is rounded as in the
// parent design, so the outputs do not depend on LOOK or on the tile
// order.  The block leaves as soon as every pixel has stopped
// (__syncthreads_count).  The TPU walked 128-pair chunks in order and
// carried T and the stop flag in scratch between grid steps, with chunk
// flags, _safe_tiles and a dynamic grid bound to skip dead chunks; here
// the carries are registers and a block visits only its own range.
//
// Semantics (texgs/kernels/tile_raster.py chunk_blend, reference.py):
//   power = the tile-local quadratic (log-opacity folded in), at tile-local
//     pixel coordinates 0..15, rounded one operation at a time in the plain
//     version's order (uvtex_common.cuh pixel_power);
//   alpha = min(0.99, exp(power)); alpha = 0 where power - logop > 0 or
//     alpha < 1/255;
//   an entry with T * (1 - alpha) < 1e-4 is NOT composited, and the pixel
//     stops there.
// T_final is the running product of (1 - alpha), as the scan twin takes it
// (tile_raster.py:206), not the Pallas kernel's log-sum (:157).  n_eval
// counts the pairs each pixel evaluated, the one that stopped it included.
//
// Built for F = 7 (rgb, depth, normal: stages 1 and 2) and F = 10 (those
// plus the three no-SH channels of the two-kernel stage-3 render), as
// kernel A is.
//
// Bound on Hopper: operations at the stage-1 shape.  It reads a record of
// 16 + F - 7 floats per pair and writes F + 2 values a pixel; the work per
// evaluated (pixel, pair) is about 16 + 2F f32 operations.  The design
// reads each record once per block and shares it among the tile's 256
// pixels.

#include <cuda_runtime.h>

#include <cstdint>

#include "uvtex_common.cuh"

namespace {

using namespace texgs;

constexpr int BATCH = PIX;  // one staged record per thread
// alphas computed ahead of the T chain: 8 ran fastest of 1, 2, 4, 8 and
// 16 (16 no faster, 59 registers; scripts/ab_raster_fwd.py)
constexpr int LOOK = 8;
static_assert(BATCH % LOOK == 0, "a look-ahead group stays in its batch");

template <int NF>
__global__ void __launch_bounds__(PIX)
    raster_fwd(const float* __restrict__ table,
               const int* __restrict__ pair_gauss,
               const int* __restrict__ tile_start,
               const int* __restrict__ tile_end,
               const int64_t* __restrict__ tile_order, int gx,
               float* __restrict__ blend, float* __restrict__ t_final,
               int* __restrict__ n_eval) {
  constexpr int TAB_COLS = TABLE_FIXED + NF - N_FIXED_F;
  __shared__ float s_quad[BATCH][8];  // 6 coefficients, log-opacity, pad
  __shared__ float s_feat[BATCH][NF];

  const int tile = static_cast<int>(tile_order[blockIdx.x]);
  const int tid = threadIdx.x;
  const float tile_x = static_cast<float>((tile % gx) * TILE);
  const float tile_y = static_cast<float>((tile / gx) * TILE);
  const float x = static_cast<float>(tid % TILE);
  const float y = static_cast<float>(tid / TILE);

  const int start = tile_start[tile], end = tile_end[tile];
  const size_t pix = static_cast<size_t>(tile) * PIX + tid;
  float acc[NF];
#pragma unroll
  for (int f = 0; f < NF; ++f) acc[f] = 0.f;
  float T = 1.f;
  bool done = false;
  int evals = 0;

  for (int base = start; base < end; base += BATCH) {
    // every thread takes part, so this also fences the previous batch's
    // shared-memory reads before the records are overwritten
    if (__syncthreads_count(!done) == 0) break;
    const int j = base + tid;
    if (j < end) {
      const int g = pair_gauss[j];
      stage_quad<NF>(table + static_cast<size_t>(g) * TAB_COLS, tile_x,
                     tile_y, s_quad[tid], s_feat[tid]);
    }
    __syncthreads();

    const int n_batch = min(BATCH, end - base);
    for (int k0 = 0; k0 < n_batch && !done; k0 += LOOK) {
      float alpha[LOOK];
#pragma unroll
      for (int i = 0; i < LOOK; ++i) {
        // a group's tail past the batch repeats its last record, unused
        const float* q = s_quad[min(k0 + i, n_batch - 1)];
        float e;
        alpha[i] = pixel_alpha(pixel_power(x, y, q), q[6], &e);
      }
#pragma unroll
      for (int i = 0; i < LOOK; ++i) {
        if (k0 + i == n_batch) break;
        ++evals;
        const float t_next = T * (1.f - alpha[i]);
        if (t_next < T_STOP) {
          done = true;
          break;
        }
        const float w = alpha[i] * T;
#pragma unroll
        for (int f = 0; f < NF; ++f) acc[f] += w * s_feat[k0 + i][f];
        T = t_next;
      }
    }
  }

#pragma unroll
  for (int f = 0; f < NF; ++f) blend[pix * NF + f] = acc[f];
  t_final[pix] = T;
  n_eval[pix] = evals;
}

template <int NF>
void launch(const void* table, const void* pair_gauss, const void* tile_start,
            const void* tile_end, const void* tile_order, int n_tiles, int gx,
            void* blend, void* t_final, void* n_eval, cudaStream_t stream) {
  raster_fwd<NF><<<n_tiles, PIX, 0, stream>>>(
      static_cast<const float*>(table), static_cast<const int*>(pair_gauss),
      static_cast<const int*>(tile_start), static_cast<const int*>(tile_end),
      static_cast<const int64_t*>(tile_order), gx, static_cast<float*>(blend),
      static_cast<float*>(t_final), static_cast<int*>(n_eval));
}

}  // namespace

// Blend channels (n_tiles, 256, n_f), T_final (n_tiles, 256) and
// evaluated-pair counts (n_tiles, 256) of every tile, from the
// per-Gaussian table (N, tab_cols) of tile_raster.build_gauss_table.
// n_f = 7 and n_f = 10 are built (tab_cols = 16 + n_f - 7).  tile_order
// is a permutation of the n_tiles tiles (int64), the order in which the
// blocks take them.  Returns the launch's cudaGetLastError().
extern "C" int raster_forward(const void* table, int tab_cols,
                              const void* pair_gauss, const void* tile_start,
                              const void* tile_end, const void* tile_order,
                              int n_tiles, int gx, int n_f, void* blend,
                              void* t_final, void* n_eval, void* stream) {
  if (tab_cols != TABLE_FIXED + n_f - N_FIXED_F)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define TEXGS_CASE(NF)                                                      \
  case NF:                                                                  \
    if (n_tiles <= 0) return 0;                                             \
    launch<NF>(table, pair_gauss, tile_start, tile_end, tile_order, n_tiles, \
               gx, blend, t_final, n_eval, s);                              \
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
