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
// thread block per 16x16 tile, one thread per pixel, the blocks taking the
// tiles heaviest first (as kernel 1'), each replaying the tile's pairs in
// depth order with kernel 2's own alpha, T and stop arithmetic.  An entry
// past a pixel's m-th accepted one carries no cotangent and changes no
// slot, so the pixel stops there, as it does at the T stop, and the block
// leaves once every pixel has stopped.  A pixel that has stopped
// contributes zeros, by select: texgs multiplies a dead tail by its mask
// (pallas_uvtex.py:336-339), which lets NaN through.  Each pair's 6
// quadratic coefficients fill one 16-column half of A''s vector and its 12
// uv entries the other.  Every entry the kernel evaluates is in its pixel's
// list, so a warp always reduces the whole vector as A' does for a warp
// with an in-list pixel (warp_reduce.cuh): the halves swapped across the
// warp's halves, then a reduce-scatter over each, 31 shuffles in all (a
// butterfly per column took 90), after which lane c stores column c's warp
// sum.  GROUP pairs' warp sums wait in shared memory between two barriers;
// then warp 0 sums each pair's quad columns over the warps and takes them
// back to the anchor frame (unshift_grad, the transpose of the shift into
// the tile's frame) once a pair, and the other warps sum the uv columns,
// each issuing one atomicAdd per pair and nonzero column.  The block asks
// for at most 64 registers, as A' does, so 4 blocks share an SM; without
// the bound it takes the same 64 and the same time
// (scripts/ab_raster_bwd.py).
//
// Bound on Hopper: operations at the flagship shape.  Per pixel it reads
// every slot's w and the live slots' cotangents; per pair the table and uv
// rows; the replay, suffix form and block sums cost about 40 f32
// operations an evaluated entry and the intersection and its gradient about
// 90 an in-list one.

#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

#include "uvtex_common.cuh"
#include "warp_reduce.cuh"

namespace {

using namespace texgs;

constexpr int BATCH = 128;   // pair records staged per pass
constexpr int GROUP = 32;    // pairs whose warp sums wait in shared memory
constexpr int WARPS = PIX / 32;
constexpr int UV = 6;        // first uv column of a warp's sums
constexpr int UV_GRAD = 12;  // sv(3), siginv(6), base_uv(3)
constexpr int N_COLS = UV + UV_GRAD;
// a pair's warp sums, warp-major; WARPS * N_COLS is even, so the pad puts
// lane l of warp 0's epilogue (pair l) on a bank of its own
constexpr int RED_ROW = WARPS * N_COLS + 1;

__global__ void __launch_bounds__(PIX, 4)
    mlist_backward(const float* __restrict__ table, int tab_cols,
                   const float* __restrict__ uv_rows,
                   const int* __restrict__ pair_gauss,
                   const int* __restrict__ tile_start,
                   const int* __restrict__ tile_end,
                   const int64_t* __restrict__ tile_order, Rays rays, int gx,
                   int m, const float4* __restrict__ mlist,
                   const float4* __restrict__ g_mlist,
                   float* __restrict__ d_table, float* __restrict__ d_uv) {
  static_assert(GROUP == 32, "warp 0 takes one pair of the group a lane");
  __shared__ float s_quad[BATCH][8];
  __shared__ float s_uv[BATCH][UV_USED];
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
  float d[3];
  pixel_ray(rays, tile_x + x, tile_y + y, d);
  // the column this lane's warp sum holds: quad c in lane c < 6, uv entry
  // c in lane 16 + c < 28; the other lanes hold zeros
  const int red_col = lane < HALF ? (lane < UV ? lane : -1)
                                  : (lane - HALF < UV_GRAD ? UV + lane - HALF
                                                           : -1);

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
      const int n_group = min(GROUP, n_batch - k0);
      for (int kk = 0; kk < n_group; ++kk) {
        const int k = k0 + kk;
        // a: quad (0-5); b: the uv-row gradient (0-11); zeros elsewhere
        float a[HALF], b[HALF];
#pragma unroll
        for (int c = 0; c < HALF; ++c) a[c] = b[c] = 0.f;
        bool any = false;
        if (!done) {
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
            a[0] = x * x * g_power;
            a[1] = y * y * g_power;
            a[2] = x * y * g_power;
            a[3] = x * g_power;
            a[4] = y * g_power;
            a[5] = g_power;
            const float g_uv[3] = {g_slot.y, g_slot.z, g_slot.w};
            intersect_grad(d, intersect(d, s_uv[k]), g_uv, b);
            any = true;
            T = t_next;
            done = ++count == m;
          }
        }
        // the warp's sums, lane l holding column l of a (l < 16) or l - 16
        // of b; a warp none of whose pixels took part writes zeros
        float col = 0.f;
        if (__any_sync(FULL, any)) {
          const bool hi = lane & HALF;
          float r[HALF];
#pragma unroll
          for (int i = 0; i < HALF; ++i) {
            const float send = hi ? a[i] : b[i];
            const float keep = hi ? b[i] : a[i];
            r[i] = keep + __shfl_xor_sync(FULL, send, HALF);
          }
          col = scatter16(r, lane);
        }
        if (red_col >= 0) s_red[kk][warp * N_COLS + red_col] = col;
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
          float* out = d_table + static_cast<size_t>(s_gauss[k]) * tab_cols;
#pragma unroll
          for (int i = 0; i < 6; ++i)
            if (anchor[i] != 0.f) atomicAdd(out + i, anchor[i]);
        }
      } else {
        // the other warps: one (pair, uv column) at a time
        for (int i = tid - 32; i < n_group * UV_GRAD; i += PIX - 32) {
          const int kk = i / UV_GRAD, c = i % UV_GRAD;
          float sum = 0.f;
#pragma unroll
          for (int wi = 0; wi < WARPS; ++wi)
            sum += s_red[kk][wi * N_COLS + UV + c];
          if (sum != 0.f)
            atomicAdd(d_uv + static_cast<size_t>(s_gauss[k0 + kk]) * UV_COLS +
                          c,
                      sum);
        }
      }
      __syncthreads();
      if (!live) return;
    }
  }
}

}  // namespace

// Adds the VJP of kernel 2 into d_table (N, tab_cols) and d_uv (N, 24),
// which the caller zeroes.  mlist is kernel 2's output for the same
// arguments and g_mlist its cotangent, of the same shape.  tile_order is a
// permutation of the n_tiles tiles (int64), the order in which the blocks
// take them: heaviest first (binning.heaviest_first), so that a heavy tile
// does not start last and set the kernel's tail.  rays9 is host memory
// [ax, by, c0].  Returns the launch's cudaGetLastError().
extern "C" int uvtex_mlist_backward(const void* table, int tab_cols,
                                    const void* uv_rows,
                                    const void* pair_gauss,
                                    const void* tile_start,
                                    const void* tile_end,
                                    const void* tile_order, const float* rays9,
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
      static_cast<const int64_t*>(tile_order), rays, gx, m,
      static_cast<const float4*>(mlist), static_cast<const float4*>(g_mlist),
      static_cast<float*>(d_table), static_cast<float*>(d_uv));
  return static_cast<int>(cudaGetLastError());
}
