// Kernel 2': the backward of kernel 2 (the M-lists of the two-kernel
// stage-3 render).
//
// Replaces the TPU kernel texgs/kernels/pallas_uvtex.py:137 (_bwd_kernel,
// launched by mlist_pairs' VJP _mlist_bwd at :290 / :324).  Plain PyTorch
// version: texgs_torch/kernels/uvtex_mlist.py, mlist_only_scan_vjp.
//
// What it computes.  The vector-Jacobian product of the M-list slots
// [w, uv] into the per-Gaussian table's quadratic columns (0-5) and the uv
// rows' first 12 columns (sv, siginv, base_uv).  Per (pixel, pair) entry j
// with weight w_j = alpha_j T_j and slot cotangent g_j (0 for an entry in
// no slot), texgs's suffix form gives
//   d alpha_j = T_j g_j - (sum_{i>j} w_i g_i) / (1 - alpha_j),
// with sum_{i>j} w_i g_i = tot - prefix_j and tot = sum_slots w g_w taken
// from the forward slots and their cotangent (pallas_uvtex.py:168-227).
// d power = alpha d alpha where alpha is neither zeroed nor clamped: the
// clamp is tested as exp(power) <= 0.99, the rule of kernels A' and 1' and
// of the scan twin, not the Pallas kernel's alpha < 0.99
// (pallas_uvtex.py:211).  The uv cotangent of an in-list entry runs back
// through the intersection (uvtex_common.cuh intersect_grad); J is a
// constant of the render.
//
// Design.  Kernel A' (uvtex_fused_bwd.cu) without the blend channels: one
// thread block per 16x16 tile, one thread per pixel, replaying the tile's
// pairs in depth order with kernel 2's own alpha, T and stop arithmetic.
// An entry past a pixel's m-th accepted one carries no cotangent and
// changes no slot, so the pixel stops there, as it does at the T stop, and
// the block leaves once every pixel has stopped.  A pixel that has stopped
// contributes zeros, by select: texgs multiplies a dead tail by its mask
// (pallas_uvtex.py:336-339), which lets NaN through.  Each pair's 18 values
// (6 quadratic coefficients, 12 uv entries) are summed over the tile's 256
// pixels: warp shuffles reduce them to 8 partials in shared memory; every
// GROUP pairs the block adds the partials and issues one atomicAdd per
// pair and nonzero column.  The quadratic was shifted into the tile's
// frame, so its gradient goes back through the transpose of that shift
// (unshift_grad) before the atomics.
//
// Bound on Hopper: operations at the flagship shape.  Per pixel it reads
// every slot's w and the live slots' cotangents; per pair the table and uv
// rows; the replay, suffix form and warp sums cost about 40 f32 operations
// an evaluated entry and the intersection and its gradient about 90 an
// in-list one.

#include <cuda_runtime.h>

#include <cstring>

#include "uvtex_common.cuh"

namespace {

using namespace texgs;

constexpr int BATCH = 128;  // pair records staged per pass
constexpr int GROUP = 8;    // pairs whose partial sums wait in shared memory
constexpr int WARPS = PIX / 32;
constexpr unsigned FULL = 0xffffffffu;
constexpr int UV = 6;       // first uv value, after the 6 coefficients
constexpr int N_COLS = 6 + 12;

__global__ void __launch_bounds__(PIX)
    mlist_backward(const float* __restrict__ table, int tab_cols,
                   const float* __restrict__ uv_rows,
                   const int* __restrict__ pair_gauss,
                   const int* __restrict__ tile_start,
                   const int* __restrict__ tile_end, Rays rays, int gx, int m,
                   const float4* __restrict__ mlist,
                   const float4* __restrict__ g_mlist,
                   float* __restrict__ d_table, float* __restrict__ d_uv) {
  __shared__ float s_quad[BATCH][8];
  __shared__ float s_uv[BATCH][UV_USED];
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
  float d[3];
  pixel_ray(rays, tile_x + x, tile_y + y, d);

  const int start = tile_start[tile], end = tile_end[tile];
  const size_t pix = static_cast<size_t>(tile) * PIX + tid;
  const float4* list = mlist + pix * m;
  const float4* g_list = g_mlist + pix * m;

  // the suffix total sum_slots w g_w; a dead slot (w = 0) adds nothing, by
  // a select: its cotangent is not read
  float tot = 0.f;
  for (int s = 0; s < m; ++s) {
    const float w = list[s].x;
    if (w != 0.f) tot += w * g_list[s].x;
  }

  float T = 1.f, prefix = 0.f;
  bool done = false;
  int count = 0;

  for (int base = start; base < end; base += BATCH) {
    if (__syncthreads_count(!done) == 0) break;
    const int j = base + tid;
    if (tid < BATCH && j < end) {
      const int g = pair_gauss[j];
      const float* row = table + static_cast<size_t>(g) * tab_cols;
      stage_record<0>(row, uv_rows + static_cast<size_t>(g) * UV_COLS, tile_x,
                      tile_y, s_quad[tid], nullptr, s_uv[tid]);
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
          } else if (alpha > 0.f) {  // alpha = 0 leaves every value 0
            // w > 0: the entry holds slot `count` (< m, else done)
            const float w = alpha * T;
            const float4 g_slot = g_list[count];
            prefix += w * g_slot.x;
            const float suffix = tot - prefix;
            const float g_alpha = T * g_slot.x - suffix / (1.f - alpha);
            const float g_power = e <= ALPHA_CLAMP ? g_alpha * alpha : 0.f;
            v[0] = x * x * g_power;
            v[1] = y * y * g_power;
            v[2] = x * y * g_power;
            v[3] = x * g_power;
            v[4] = y * g_power;
            v[5] = g_power;
            const float g_uv[3] = {g_slot.y, g_slot.z, g_slot.w};
            intersect_grad(d, intersect(d, s_uv[k]), g_uv, v + UV);
            any = true;
            T = t_next;
            done = ++count == m;
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
          const int g = s_gauss[k];
          float val;
          float* out;
          if (c < UV) {
            float dq[6];
#pragma unroll
            for (int i = 0; i < 6; ++i) {
              float a = 0.f;
#pragma unroll
              for (int wi = 0; wi < WARPS; ++wi) a += s_red[kk][wi][i];
              dq[i] = a;
            }
            // transpose of shift_to_tile: tile-frame -> anchor-frame
            float anchor[6];
            unshift_grad(dq, s_shift[k][0], s_shift[k][1], anchor);
            val = anchor[c];
            out = d_table + static_cast<size_t>(g) * tab_cols + c;
          } else {
            float a = 0.f;
#pragma unroll
            for (int wi = 0; wi < WARPS; ++wi) a += s_red[kk][wi][c];
            val = a;
            out = d_uv + static_cast<size_t>(g) * UV_COLS + (c - UV);
          }
          if (val != 0.f) atomicAdd(out, val);
        }
      }
      __syncthreads();
    }
  }
}

}  // namespace

// Adds the VJP of kernel 2 into d_table (N, tab_cols) and d_uv (N, 24),
// which the caller zeroes.  mlist is kernel 2's output for the same
// arguments and g_mlist its cotangent, of the same shape.  rays9 is host
// memory [ax, by, c0].  Returns the launch's cudaGetLastError().
extern "C" int uvtex_mlist_backward(const void* table, int tab_cols,
                                    const void* uv_rows,
                                    const void* pair_gauss,
                                    const void* tile_start,
                                    const void* tile_end, const float* rays9,
                                    int n_tiles, int gx, int m,
                                    const void* mlist, const void* g_mlist,
                                    void* d_table, void* d_uv, void* stream) {
  if (m <= 0 || tab_cols < TABLE_FIXED)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_tiles <= 0) return 0;
  Rays rays;
  std::memcpy(rays.ax, rays9, 3 * sizeof(float));
  std::memcpy(rays.by, rays9 + 3, 3 * sizeof(float));
  std::memcpy(rays.c0, rays9 + 6, 3 * sizeof(float));
  mlist_backward<<<n_tiles, PIX, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(table), tab_cols,
      static_cast<const float*>(uv_rows), static_cast<const int*>(pair_gauss),
      static_cast<const int*>(tile_start), static_cast<const int*>(tile_end),
      rays, gx, m, static_cast<const float4*>(mlist),
      static_cast<const float4*>(g_mlist), static_cast<float*>(d_table),
      static_cast<float*>(d_uv));
  return static_cast<int>(cudaGetLastError());
}
