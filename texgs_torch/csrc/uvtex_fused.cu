// Kernel A: blend channels + per-pixel M-lists of the stage-3 render, in
// one pass over each tile's depth-sorted pairs.
//
// Replaces the TPU kernel texgs/kernels/pallas_uvtex_fused.py:45
// (_fused_fwd_kernel, launched by fused_pairs at :263 / :303).  Plain
// PyTorch version: texgs_torch/kernels/uvtex_fused.py, mlist_scan.
//
// Design.  One thread block per 16x16 tile and one thread per pixel; the
// blocks take the tiles in the pair list's tile order, heaviest first
// (binning.heaviest_first), so that a heavy tile does not start last and
// set the kernel's tail.  The block walks its tile's pairs
// [tile_start, tile_end) in batches of BATCH:
// each thread stages one pair's record into shared memory (the Gaussian's
// exponent quadratic shifted into this tile's frame, its blend channels
// and its uv row, all read by Gaussian index), then every pixel runs the
// sequential front-to-back loop over the batch, reading the records as
// shared-memory broadcasts.  A pixel writes slot `count` of its M-list
// while count < m, and the block leaves as soon as every pixel has stopped
// (__syncthreads_count).  Then the block zeroes the tile's dead slots
// (count..m-1 of every pixel) in flat order, slot fastest, so that a
// warp's zero stores are contiguous.  On the TPU the grid walked 128-pair
// chunks in order and carried T, `done` and the list count in scratch from
// one grid step to the next; here those carries are registers of the
// pixel's thread.
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
// tile's 256 pixels, and writes each slot as one 16-byte store.  Most of
// the slots are dead: their zeros go out as 512 contiguous bytes a warp.

#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

#include "uvtex_common.cuh"

namespace {

using namespace texgs;

constexpr int BATCH = PIX;  // one staged record per thread

template <int NF>
__global__ void __launch_bounds__(PIX)
    fused_forward(const float* __restrict__ table, int tab_cols,
                  const float* __restrict__ uv_rows,
                  const int* __restrict__ pair_gauss,
                  const int* __restrict__ tile_start,
                  const int* __restrict__ tile_end,
                  const int64_t* __restrict__ tile_order, Rays rays, int gx,
                  int m, float* __restrict__ blend,
                  float* __restrict__ t_final,
                  float4* __restrict__ mlist, int* __restrict__ n_eval) {
  __shared__ float s_quad[BATCH][8];  // 6 coefficients, log-opacity, pad
  __shared__ float s_feat[BATCH][NF];
  __shared__ float s_uv[BATCH][UV_USED];
  __shared__ int s_count[PIX];  // each pixel's written slots

  const int tile = static_cast<int>(tile_order[blockIdx.x]);
  const int tid = threadIdx.x;
  const float tile_x = static_cast<float>((tile % gx) * TILE);
  const float tile_y = static_cast<float>((tile / gx) * TILE);
  const float x = static_cast<float>(tid % TILE);
  const float y = static_cast<float>(tid / TILE);
  const float px = tile_x + x, py = tile_y + y;
  float d[3];
  pixel_ray(rays, px, py, d);

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
      stage_record<NF>(table + static_cast<size_t>(g) * tab_cols,
                       uv_rows + static_cast<size_t>(g) * UV_COLS, tile_x,
                       tile_y, s_quad[tid], s_feat[tid], s_uv[tid]);
    }
    __syncthreads();

    const int n_batch = min(BATCH, end - base);
    for (int k = 0; k < n_batch && !done; ++k) {
      const float* q = s_quad[k];
      float e;
      const float alpha = pixel_alpha(pixel_power(x, y, q), q[6], &e);
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
          const Intersection it = intersect(d, s_uv[k]);
          list[count] = make_float4(w, it.uvn[0], it.uvn[1], it.uvn[2]);
        }
        ++count;
      }
    }
  }

#pragma unroll
  for (int f = 0; f < NF; ++f) blend[pix * NF + f] = acc[f];
  t_final[pix] = T;
  n_eval[pix] = evals;
  // the dead slots, zeroed by the block in flat order over the tile's
  // PIX * m slots; every thread reaches the barrier (the batch loop above
  // leaves together)
  s_count[tid] = min(count, m);
  __syncthreads();
  float4* tile_list = mlist + static_cast<size_t>(tile) * PIX * m;
  for (int f = tid; f < PIX * m; f += PIX)
    if (f % m >= s_count[f / m])
      tile_list[f] = make_float4(0.f, 0.f, 0.f, 0.f);
}

template <int NF>
void launch(const void* table, int tab_cols, const void* uv_rows,
            const void* pair_gauss, const void* tile_start,
            const void* tile_end, const void* tile_order, const Rays& rays,
            int n_tiles, int gx, int m, void* blend, void* t_final,
            void* mlist, void* n_eval, cudaStream_t stream) {
  fused_forward<NF><<<n_tiles, PIX, 0, stream>>>(
      static_cast<const float*>(table), tab_cols,
      static_cast<const float*>(uv_rows), static_cast<const int*>(pair_gauss),
      static_cast<const int*>(tile_start), static_cast<const int*>(tile_end),
      static_cast<const int64_t*>(tile_order), rays, gx, m,
      static_cast<float*>(blend), static_cast<float*>(t_final),
      static_cast<float4*>(mlist), static_cast<int*>(n_eval));
}

}  // namespace

// Blend channels (n_tiles, 256, n_f), T_final (n_tiles, 256), M-lists
// (n_tiles, 256, m, 4) and evaluated-pair counts (n_tiles, 256) of every
// tile.  tile_order is a permutation of the n_tiles tiles (int64), the
// order in which the blocks take them.  rays9 is host memory [ax, by, c0].
// Returns the launch's cudaGetLastError().
extern "C" int uvtex_fused_forward(const void* table, int tab_cols,
                                   const void* uv_rows, const void* pair_gauss,
                                   const void* tile_start,
                                   const void* tile_end,
                                   const void* tile_order, const float* rays9,
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
               tile_order, rays, n_tiles, gx, m, blend, t_final, mlist,     \
               n_eval, s);                                                  \
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
