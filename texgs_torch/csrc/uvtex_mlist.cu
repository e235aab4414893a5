// Kernel 2: the per-pixel M-lists of the two-kernel stage-3 render (the
// blend is kernel 1's, raster.cu), in one pass over each tile's
// depth-sorted pairs.
//
// Replaces the TPU kernel texgs/kernels/pallas_uvtex.py:94 (_fwd_kernel,
// launched by mlist_pairs at :237 / :272).  Plain PyTorch version:
// texgs_torch/kernels/uvtex_mlist.py, mlist_only_scan.
//
// What it computes.  For every pixel, its first m contributors (entries
// with w > 0) in depth order, each slot [w, normalize(base_uv + t* J d)],
// zeros in the slots past the last contributor and in every slot of a tile
// no pair covers (as mlist_pallas zeroes unvisited tiles,
// pallas_uvtex.py:376-377).
//
// Semantics.  The alpha, T and stop decisions are kernel 1's and kernel A's
// (uvtex_common.cuh stage_quad, pixel_power, pixel_alpha): alpha =
// min(0.99, exp(power)), zeroed where power - logop > 0 or alpha < 1/255;
// an entry with T * (1 - alpha) < 1e-4 is not composited and stops the
// pixel; w = alpha * T.  Sharing their rounding keeps the M-list and the
// blend of one render on the same contributors.  The uv is normalised as
// the scan twin uvtex_raster.intersect_uv does, uv / (|uv| + 1e-12), not
// with the Pallas kernel's rsqrt(max(|uv|^2, 1e-24)) (pallas_uvtex.py:75).
//
// Design.  Kernel A (uvtex_fused.cu) without the blend: one thread block
// per 16x16 tile and one thread per pixel; the blocks take the tiles in the
// order `tile_order` gives (heaviest first on the two-kernel path:
// binning.heaviest_first), so that a heavy tile does not start last and set
// the kernel's tail.  A tile's pair count is only a proxy for its work
// here, which ends at its pixels' m-th contributor.  The block walks its
// tile's pairs [tile_start, tile_end) in batches of 256.  Each thread
// stages one pair's record (the exponent quadratic shifted into this
// tile's frame, the log-opacity and the uv row, read by Gaussian index)
// into shared memory; then every pixel runs the front-to-back loop over
// the batch, reading the records as shared-memory broadcasts, and writes
// slot `count` as one 16-byte store.  The loop takes the pairs LOOK at a
// time: it first computes the LOOK alphas (they do not depend on T), so
// that their exponents and exps overlap, then applies them one by one with
// the exact stop rule; alphas computed past a stop are discarded.  Every
// value is rounded as without the look-ahead, so the outputs depend
// neither on LOOK nor on the tile order.  With no blend to finish, a pixel
// is done once it holds m entries or has hit the T stop, and the block
// leaves once every pixel is done (__syncthreads_count per batch): texgs's
// min(count_in) < m skip (pallas_uvtex.py:115).  Then the block zeroes the
// tile's dead slots (count..m-1 of every pixel) in flat order, slot
// fastest, so that a warp's zero stores are contiguous.  The TPU carried
// T, `done` and the list count in scratch between 128-pair grid steps;
// here they are registers.
//
// Bound on Hopper: bytes at the flagship shape.  The M-list output is m * 16
// bytes a pixel (512 B at m = 32), more than the records it reads; the work
// is about 16 f32 operations per evaluated (pixel, pair) and 60 per slot.
// Most of the slots are dead (57% at the flagship's view 0): their zeros go
// out as 512 contiguous bytes a warp.

#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

#include "uvtex_common.cuh"

namespace {

using namespace texgs;

constexpr int BATCH = PIX;  // one staged record per thread
// alphas computed ahead of the T chain: 8 ran fastest of 1, 4, 8 and 16
// (61 registers, 4 blocks an SM; scripts/ab_mlist_gather.py)
constexpr int LOOK = 8;
static_assert(BATCH % LOOK == 0, "a look-ahead group stays in its batch");

__global__ void __launch_bounds__(PIX)
    mlist_forward(const float* __restrict__ table, int tab_cols,
                  const float* __restrict__ uv_rows,
                  const int* __restrict__ pair_gauss,
                  const int* __restrict__ tile_start,
                  const int* __restrict__ tile_end,
                  const int64_t* __restrict__ tile_order, Rays rays, int gx,
                  int m, float4* __restrict__ mlist) {
  __shared__ float s_quad[BATCH][8];  // 6 coefficients, log-opacity, pad
  __shared__ float s_uv[BATCH][UV_USED];
  __shared__ int s_count[PIX];  // each pixel's written slots

  const int tile = static_cast<int>(tile_order[blockIdx.x]);
  const int tid = threadIdx.x;
  const float tile_x = static_cast<float>((tile % gx) * TILE);
  const float tile_y = static_cast<float>((tile / gx) * TILE);
  const float x = static_cast<float>(tid % TILE);
  const float y = static_cast<float>(tid / TILE);
  float d[3];
  pixel_ray(rays, tile_x + x, tile_y + y, d);

  const int start = tile_start[tile], end = tile_end[tile];
  float4* tile_list = mlist + static_cast<size_t>(tile) * PIX * m;
  float4* list = tile_list + static_cast<size_t>(tid) * m;
  float T = 1.f;
  bool done = false;
  int count = 0;

  for (int base = start; base < end; base += BATCH) {
    // every thread takes part, so this also fences the previous batch's
    // shared-memory reads before the records are overwritten
    if (__syncthreads_count(!done) == 0) break;
    const int j = base + tid;
    if (j < end) {
      const int g = pair_gauss[j];
      stage_record<0>(table + static_cast<size_t>(g) * tab_cols,
                      uv_rows + static_cast<size_t>(g) * UV_COLS, tile_x,
                      tile_y, s_quad[tid], nullptr, s_uv[tid]);
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
        const float t_next = T * (1.f - alpha[i]);
        if (t_next < T_STOP) {
          done = true;
          break;
        }
        const float w = alpha[i] * T;
        T = t_next;
        if (w > 0.f) {
          const Intersection it = intersect(d, s_uv[k0 + i]);
          list[count] = make_float4(w, it.uvn[0], it.uvn[1], it.uvn[2]);
          if (++count == m) {
            done = true;
            break;
          }
        }
      }
    }
  }

  // the dead slots, zeroed by the block in flat order over the tile's
  // PIX * m slots; every thread reaches the barrier (the batch loop above
  // leaves together: its __syncthreads_count is the same in every thread)
  s_count[tid] = min(count, m);
  __syncthreads();
  for (int f = tid; f < PIX * m; f += PIX)
    if (f % m >= s_count[f / m])
      tile_list[f] = make_float4(0.f, 0.f, 0.f, 0.f);
}

}  // namespace

// M-lists (n_tiles, 256, m, 4) of every tile from the per-Gaussian table
// (N, tab_cols >= 16) of tile_raster.build_gauss_table (only its quadratic,
// log-opacity and anchor columns are read) and the uv rows (N, 24).
// tile_order is a permutation of the n_tiles tiles (int64), the order in
// which the blocks take them.  rays9 is host memory [ax, by, c0].  Returns
// the launch's cudaGetLastError().
extern "C" int uvtex_mlist_forward(const void* table, int tab_cols,
                                   const void* uv_rows, const void* pair_gauss,
                                   const void* tile_start,
                                   const void* tile_end,
                                   const void* tile_order, const float* rays9,
                                   int n_tiles, int gx, int m, void* mlist,
                                   void* stream) {
  if (m <= 0 || tab_cols < TABLE_FIXED)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_tiles <= 0) return 0;
  Rays rays;
  std::memcpy(rays.ax, rays9, 3 * sizeof(float));
  std::memcpy(rays.by, rays9 + 3, 3 * sizeof(float));
  std::memcpy(rays.c0, rays9 + 6, 3 * sizeof(float));
  mlist_forward<<<n_tiles, PIX, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(table), tab_cols,
      static_cast<const float*>(uv_rows), static_cast<const int*>(pair_gauss),
      static_cast<const int*>(tile_start), static_cast<const int*>(tile_end),
      static_cast<const int64_t*>(tile_order), rays, gx, m,
      static_cast<float4*>(mlist));
  return static_cast<int>(cudaGetLastError());
}
