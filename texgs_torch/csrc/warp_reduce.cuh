// The warp reduce-scatter shared by the backward kernels A'
// (uvtex_fused_bwd.cu), 1' (raster_bwd.cu) and 2' (uvtex_mlist_bwd.cu).
// Each sums a vector of per-pixel values over a tile's pixels, a pair at a
// time: a warp first reduces it to one warp sum a column, held by one lane
// each, in place of a butterfly (5 shuffles) a column.

#pragma once

#include <cuda_runtime.h>

namespace texgs {

constexpr unsigned FULL = 0xffffffffu;
constexpr int HALF = 16;  // columns a 16-lane half of the warp reduces

// One round of the reduce-scatter: lanes whose bit W is set keep columns
// W..2W-1 of the 2W they hold, the others 0..W-1; each sends its partner
// (lane ^ W) the half the partner keeps.
template <int W>
__device__ __forceinline__ void scatter_round(float r[HALF], int lane) {
  const bool up = lane & W;
#pragma unroll
  for (int i = 0; i < W; ++i) {
    const float send = up ? r[i] : r[i + W];
    const float keep = up ? r[i + W] : r[i];
    r[i] = keep + __shfl_xor_sync(FULL, send, W);
  }
}

// Reduce-scatter of 16 columns over each 16-lane half of the warp: lane l
// returns the sum over its half of column l & 15 (15 shuffles).
__device__ __forceinline__ float scatter16(float r[HALF], int lane) {
  scatter_round<8>(r, lane);
  scatter_round<4>(r, lane);
  scatter_round<2>(r, lane);
  scatter_round<1>(r, lane);
  return r[0];
}

}  // namespace texgs
