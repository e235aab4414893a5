// Kernel A': the backward of kernel A (blend channels + M-lists of the
// stage-3 render).
//
// Replaces the TPU kernel texgs/kernels/pallas_uvtex_fused.py:117
// (_fused_bwd_kernel, launched by fused_pairs' VJP at :324 / :366).  Plain
// PyTorch version: texgs_torch/kernels/uvtex_fused.py, mlist_scan_vjp
// (autograd through mlist_scan).
//
// What it computes.  The vector-Jacobian product of kernel A's outputs
// (blend channels, T_final, M-list slots [w, uv]) into the per-Gaussian
// table (N, 16 + E) and uv rows (N, 24).  Per (pixel, pair) entry j with
// weight w_j = alpha_j T_j, the cotangents of the blend, of T_final and of
// the M-list w add into one per-entry g_j, and texgs's suffix form gives
//   d alpha_j = T_j g_j - (sum_{i>j} w_i g_i + T_final g_T) / (1 - alpha_j),
// with sum_{i>j} w_i g_i = tot - prefix_j, tot = sum_F out g_out +
// sum_slots w g_w.  The uv cotangent of an in-list entry runs back through
// the intersection into sv, siginv and base_uv (uvtex_common.cuh
// intersect_grad).  J is a constant of the render (the table's J columns
// get no gradient, as in texgs's kernel).
//
// Design.  One thread block per 16x16 tile, one thread per pixel, as kernel
// A.  The block replays the tile's pairs in depth order with kernel A's own
// alpha, T and stop arithmetic (uvtex_common.cuh), so a pixel stops at the
// same pair as in the forward.  All threads walk the pairs in step; a
// pixel that has stopped contributes zeros.  Each pair's gradient is a sum
// over the tile's 256 pixels of a 32-column vector: the 6 tile-frame quad
// coefficients and the NF blend channels fill its first half, the 12 uv-row
// entries its second (the rest pads).  A warp reduce-scatters that vector
// (warp_reduce.cuh, shared with kernels 1' and 2'): each round halves the
// columns a lane holds and swaps the other half with the partner lane,
// 16 + 8 + 4 + 2 + 1 = 31 shuffles in all, after which
// lane c holds column c's warp sum and stores it to shared memory itself
// (a butterfly per column took 5 shuffles a column, 140 at F = 10, and 28
// serial stores).  The uv half is reduced only when a ballot finds a pixel
// of the warp with the pair in its M-list (past each pixel's m-th
// contributor those columns are zero): then the first half alone takes
// 15 + 1 shuffles.  GROUP pairs' warp sums wait in shared memory between
// two barriers; then warp 0 sums each pair's quad columns over the warps
// and takes them back to the anchor frame (the kernel reads the table by
// Gaussian index and shifts the quadratic into the tile's frame itself) once
// a pair, and the other warps sum the channel and uv columns, each issuing
// one atomicAdd per pair and nonzero column into the per-Gaussian outputs.
// The block asks for at most 64 registers, so 4 blocks share an SM (3 at
// the 80 registers it takes unbounded; the few bytes it then spills cost
// less than the occupancy gains: scripts/ab_fused_bwd.py).
// The log-opacity column (used only by the power > 0 skip) and the anchor
// columns (a floor) get no gradient.
//
// Bound on Hopper: operations at the stage-3 view (per evaluated entry the
// replay, the suffix form, the exponent's gradient and its share of the
// block sums; per in-list entry the intersection and its gradient), then
// bytes: per pixel the M-list weights and the in-list slots' cotangents,
// the blend channels and theirs; per pair the table and uv rows.

#include <cuda_runtime.h>

#include <cstring>

#include "uvtex_common.cuh"
#include "warp_reduce.cuh"

namespace {

using namespace texgs;

constexpr int BATCH = 64;   // pair records staged per pass
constexpr int GROUP = 32;   // pairs whose warp sums wait in shared memory
constexpr int WARPS = PIX / 32;
constexpr int UV_GRAD = 12;  // sv(3), siginv(6), base_uv(3)
constexpr int FEAT = 6;      // first blend channel's column; quad before it

template <int NF>
__global__ void __launch_bounds__(PIX, 4)
    fused_backward(const float* __restrict__ table, int tab_cols,
                   const float* __restrict__ uv_rows,
                   const int* __restrict__ pair_gauss,
                   const int* __restrict__ tile_start,
                   const int* __restrict__ tile_end, Rays rays, int gx, int m,
                   const float* __restrict__ blend,
                   const float* __restrict__ t_final,
                   const float4* __restrict__ mlist,
                   const float* __restrict__ g_blend,
                   const float* __restrict__ g_t_final,
                   const float4* __restrict__ g_mlist,
                   float* __restrict__ d_table, float* __restrict__ d_uv) {
  static_assert(FEAT + NF <= HALF, "quad and channels fill one half");
  static_assert(GROUP == 32, "warp 0 takes one pair of the group a lane");
  __shared__ float s_quad[BATCH][8];
  __shared__ float s_feat[BATCH][NF];
  __shared__ float s_uv[BATCH][UV_USED];
  __shared__ int s_gauss[BATCH];
  __shared__ float s_shift[BATCH][2];
  // one pair's warp sums, warp-major; the pad puts lane l of warp 0's
  // epilogue (pair l) on bank l
  __shared__ float s_red[GROUP][WARPS * 2 * HALF + 1];

  const int tile = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const float tile_x = static_cast<float>((tile % gx) * TILE);
  const float tile_y = static_cast<float>((tile / gx) * TILE);
  const float x = static_cast<float>(tid % TILE);
  const float y = static_cast<float>(tid / TILE);
  float d[3];
  pixel_ray(rays, tile_x + x, tile_y + y, d);

  const int start = tile_start[tile], end = tile_end[tile];
  const size_t pix = static_cast<size_t>(tile) * PIX + tid;
  const float4* list = mlist + pix * m;
  const float4* g_list = g_mlist + pix * m;

  // the suffix total: sum_F out g_out + sum_slots w g_w.  A dead slot
  // (w = 0) adds nothing, by a select: its cotangent is not read.
  float g_out[NF];
  float tot = 0.f;
#pragma unroll
  for (int f = 0; f < NF; ++f) {
    g_out[f] = g_blend[pix * NF + f];
    tot += blend[pix * NF + f] * g_out[f];
  }
  for (int s = 0; s < m; ++s) {
    const float w = list[s].x;
    if (w != 0.f) tot += w * g_list[s].x;
  }
  const float bg_term = t_final[pix] * g_t_final[pix];

  float T = 1.f, prefix = 0.f;
  bool done = false;
  int count = 0;

  for (int base = start; base < end; base += BATCH) {
    if (__syncthreads_count(!done) == 0) break;
    const int j = base + tid;
    if (tid < BATCH && j < end) {
      const int g = pair_gauss[j];
      const float* row = table + static_cast<size_t>(g) * tab_cols;
      stage_record<NF>(row, uv_rows + static_cast<size_t>(g) * UV_COLS,
                       tile_x, tile_y, s_quad[tid], s_feat[tid], s_uv[tid]);
      s_gauss[tid] = g;
      s_shift[tid][0] = tile_x - row[COL_ANCHOR];
      s_shift[tid][1] = tile_y - row[COL_ANCHOR + 1];
    }
    __syncthreads();

    const int n_batch = min(BATCH, end - base);
    for (int k0 = 0; k0 < n_batch; k0 += GROUP) {
      for (int kk = 0; kk < GROUP; ++kk) {
        const int k = k0 + kk;
        // a: quad (0-5) and channels (6..); b: the uv-row gradient
        float a[HALF], b[HALF];
#pragma unroll
        for (int c = 0; c < HALF; ++c) a[c] = b[c] = 0.f;
        bool any = false, in_list = false;
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
            float4 g_slot = make_float4(0.f, 0.f, 0.f, 0.f);
            if (w > 0.f) {
              if (count < m) {
                in_list = true;
                g_slot = g_list[count];
                g_w += g_slot.x;
              }
              ++count;
            }
            prefix += w * g_w;
            const float suffix = tot - prefix;
            const float g_alpha = T * g_w - (suffix + bg_term) / (1.f - alpha);
            // d alpha / d power = exp(power) where alpha is neither zeroed
            // nor clamped at 0.99
            const float g_power =
                (alpha > 0.f && e <= ALPHA_CLAMP) ? g_alpha * alpha : 0.f;
            a[0] = x * x * g_power;
            a[1] = y * y * g_power;
            a[2] = x * y * g_power;
            a[3] = x * g_power;
            a[4] = y * g_power;
            a[5] = g_power;
#pragma unroll
            for (int f = 0; f < NF; ++f) a[FEAT + f] = w * g_out[f];
            if (in_list) {
              const float g[3] = {g_slot.y, g_slot.z, g_slot.w};
              intersect_grad(d, intersect(d, s_uv[k]), g, b);
            }
            any = alpha > 0.f;  // alpha = 0 leaves every value 0
            T = t_next;
          }
        }
        // the warp's sums, lane c holding column c; a warp none of whose
        // pixels took part writes zeros
        float col = 0.f;
        if (__any_sync(FULL, any)) {
          const bool hi = lane & HALF;
          if (__any_sync(FULL, in_list)) {
            float r[HALF];
#pragma unroll
            for (int i = 0; i < HALF; ++i) {
              const float send = hi ? a[i] : b[i];
              const float keep = hi ? b[i] : a[i];
              r[i] = keep + __shfl_xor_sync(FULL, send, HALF);
            }
            col = scatter16(r, lane);
          } else {
            col = scatter16(a, lane);
            col += __shfl_xor_sync(FULL, col, HALF);
            if (hi) col = 0.f;  // the uv half is all zeros
          }
        }
        s_red[kk][warp * 2 * HALF + lane] = col;
      }
      __syncthreads();

      if (warp == 0) {
        // one lane per pair: its quad columns summed over the warps and
        // taken back to the anchor frame (the transpose of shift_to_tile)
        const int k = k0 + lane;
        if (k < n_batch) {
          float dq[6];
#pragma unroll
          for (int i = 0; i < 6; ++i) {
            float sum = 0.f;
#pragma unroll
            for (int wi = 0; wi < WARPS; ++wi)
              sum += s_red[lane][wi * 2 * HALF + i];
            dq[i] = sum;
          }
          float anchor[6];
          unshift_grad(dq, s_shift[k][0], s_shift[k][1], anchor);
          float* out = d_table + static_cast<size_t>(s_gauss[k]) * tab_cols;
#pragma unroll
          for (int i = 0; i < 6; ++i)
            if (anchor[i] != 0.f) atomicAdd(out + i, anchor[i]);
        }
      } else {
        // the other warps: one (pair, channel or uv column) at a time
        constexpr int COLS = NF + UV_GRAD;
        for (int i = tid - 32; i < GROUP * COLS; i += PIX - 32) {
          const int kk = i / COLS, j = i % COLS;
          const int k = k0 + kk;
          if (k >= n_batch) continue;
          const int c = j < NF ? FEAT + j : HALF + (j - NF);
          float sum = 0.f;
#pragma unroll
          for (int wi = 0; wi < WARPS; ++wi)
            sum += s_red[kk][wi * 2 * HALF + c];
          if (sum == 0.f) continue;
          const size_t g = static_cast<size_t>(s_gauss[k]);
          if (j < NF)
            atomicAdd(d_table + g * tab_cols + feature_col(j), sum);
          else
            atomicAdd(d_uv + g * UV_COLS + (j - NF), sum);
        }
      }
      __syncthreads();
    }
  }
}

template <int NF>
void launch(const void* table, int tab_cols, const void* uv_rows,
            const void* pair_gauss, const void* tile_start,
            const void* tile_end, const Rays& rays, int n_tiles, int gx,
            int m, const void* blend, const void* t_final, const void* mlist,
            const void* g_blend, const void* g_t_final, const void* g_mlist,
            void* d_table, void* d_uv, cudaStream_t stream) {
  fused_backward<NF><<<n_tiles, PIX, 0, stream>>>(
      static_cast<const float*>(table), tab_cols,
      static_cast<const float*>(uv_rows), static_cast<const int*>(pair_gauss),
      static_cast<const int*>(tile_start), static_cast<const int*>(tile_end),
      rays, gx, m, static_cast<const float*>(blend),
      static_cast<const float*>(t_final), static_cast<const float4*>(mlist),
      static_cast<const float*>(g_blend),
      static_cast<const float*>(g_t_final),
      static_cast<const float4*>(g_mlist), static_cast<float*>(d_table),
      static_cast<float*>(d_uv));
}

}  // namespace

// Adds the VJP of kernel A into d_table (N, tab_cols) and d_uv (N, 24),
// which the caller zeroes.  blend, t_final and mlist are kernel A's outputs
// for the same arguments; g_* their cotangents, of the same shapes.  rays9
// is host memory [ax, by, c0].  Returns the launch's cudaGetLastError().
extern "C" int uvtex_fused_backward(
    const void* table, int tab_cols, const void* uv_rows,
    const void* pair_gauss, const void* tile_start, const void* tile_end,
    const float* rays9, int n_tiles, int gx, int n_f, int m,
    const void* blend, const void* t_final, const void* mlist,
    const void* g_blend, const void* g_t_final, const void* g_mlist,
    void* d_table, void* d_uv, void* stream) {
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
               rays, n_tiles, gx, m, blend, t_final, mlist, g_blend,        \
               g_t_final, g_mlist, d_table, d_uv, s);                       \
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
