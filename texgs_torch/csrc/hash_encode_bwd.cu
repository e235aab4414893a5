// Kernel K5'': the backward of the fused hash encode K5' (hash_encode.cu).
//
// texgs differentiates apply_hashgrid (texgs/nets/hashgrid.py:60-100) with
// JAX autodiff; its TPU gather (texgs/nets/pallas_hashgrid.py:63) has an
// XLA scatter-add for a backward.  Plain PyTorch version:
// texgs_torch/nets/hash_encode.py, encode_backward_plain.
//
// For the cotangent g (N, L F) of the encode's output:
//   d_table[l, h_c] += w_c g[n, l]           for the 8 corners c,
//   d_x[n, a] = sum_l res_l sum_c (g[n, l] . table[l, h_c]) dw_c / dfrac_a,
// with dw_c / dfrac_a = +-(the product of the corner's other two factors);
// floor has no gradient, as under JAX autodiff.  The inverse net's input
// is the UV net's output, so d_x is needed; it is skipped when the caller
// passes no d_x.
//
// Design.  One thread per (point, level), the level fastest, as the
// forward: the thread recomputes its cell, corners and weights from x
// (cell_of rounds as the forward does, so it finds the same rows), adds
// w g into its 8 rows of d_table with atomics (one float4 atomicAdd a row
// of 4 features, which sm_90 has for global memory), and sums its level's
// share of d_x.  A point's levels sit on neighbouring lanes of one warp, so
// a __shfl_xor_sync butterfly over those lanes adds the levels up and the
// first lane writes d_x: no atomics on d_x.  Many points of a coarse level
// share a vertex (17^3 of them at level 0), so the table atomics sum in an
// order that varies from run to run.
//
// Bound on Hopper: bytes (x, g, the tables read once and their gradient
// written once, d_x: 3.4 MB at the flagship's 8,192 points); at that size
// a launch's own cost and the atomics' contention at coarse levels.

#include "hash_encode_common.cuh"

namespace {

using namespace texgs_hash;

template <int F>
__device__ __forceinline__ void add_row(float* __restrict__ row,
                                        const float v[F]) {
#if defined(__CUDA_ARCH__) && __CUDA_ARCH__ >= 900
  if constexpr (F == 4) {
    atomicAdd(reinterpret_cast<float4*>(row),
              make_float4(v[0], v[1], v[2], v[3]));
    return;
  }
#endif
#pragma unroll
  for (int f = 0; f < F; ++f) atomicAdd(row + f, v[f]);
}

template <int F>
__global__ void __launch_bounds__(THREADS)
    hash_encode_bwd_kernel(const float* __restrict__ table,
                           const float* __restrict__ x,
                           const float* __restrict__ g, Levels levels,
                           int n_levels, int lane_bits, uint32_t table_size,
                           int n, float* __restrict__ d_table,
                           float* __restrict__ d_x) {
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  const long long q = t >> lane_bits;
  const int lanes = 1 << lane_bits;
  const int l = static_cast<int>(t & (lanes - 1));
  // every lane stays to the shuffles below; idle ones add zeros
  const bool active = q < n && l < n_levels;
  float dx[3] = {0.f, 0.f, 0.f};
  if (active) {
    const float xq[3] = {x[3 * q], x[3 * q + 1], x[3 * q + 2]};
    const Cell c = cell_of(xq, levels.res[l]);
    const size_t level_rows = static_cast<size_t>(l) * table_size;
    float gl[F];
    load_row<F>(g + static_cast<size_t>(q) * n_levels * F +
                    static_cast<size_t>(l) * F, gl);
    float dfrac[3] = {0.f, 0.f, 0.f};
#pragma unroll
    for (int corner = 0; corner < CORNERS; ++corner) {
      const size_t row = (level_rows + corner_hash(c, corner, table_size)) * F;
      float fac[3];
      corner_factors(c, corner, fac);
      const float w = corner_weight(fac);
      float wg[F];
#pragma unroll
      for (int f = 0; f < F; ++f) wg[f] = w * gl[f];
      add_row<F>(d_table + row, wg);
      if (d_x != nullptr) {
        float v[F];
        load_row<F>(table + row, v);
        float s = 0.f;
#pragma unroll
        for (int f = 0; f < F; ++f) s += gl[f] * v[f];
        const float others[3] = {fac[1] * fac[2], fac[0] * fac[2],
                                 fac[0] * fac[1]};
#pragma unroll
        for (int a = 0; a < 3; ++a)
          dfrac[a] += ((corner >> a) & 1) ? s * others[a] : -s * others[a];
      }
    }
    const float res = static_cast<float>(levels.res[l]);
#pragma unroll
    for (int a = 0; a < 3; ++a) dx[a] = res * dfrac[a];
  }
  if (d_x == nullptr) return;  // the same for every thread of the grid
#pragma unroll
  for (int a = 0; a < 3; ++a)
    for (int o = lanes >> 1; o > 0; o >>= 1)
      dx[a] += __shfl_xor_sync(FULL, dx[a], o);
  if (active && l == 0) {
#pragma unroll
    for (int a = 0; a < 3; ++a) d_x[3 * q + a] = dx[a];
  }
}

}  // namespace

// Adds the encode's VJP for g (n, n_levels * n_feat) into d_table
// (n_levels, table_size, n_feat), which the caller zeroes, and writes d_x
// (n, 3) unless it is null.  table, x and res as hash_encode_forward takes
// them; every pointer is 16-byte aligned.  Returns the launch's
// cudaGetLastError().
extern "C" int hash_encode_backward(const void* table, const void* x,
                                    const void* g, const int* res,
                                    int n_levels, int table_size, int n_feat,
                                    int n, void* d_table, void* d_x,
                                    void* stream) {
  if (n == 0) return 0;
  if (n < 0 || n_levels < 1 || n_levels > MAX_LEVELS || table_size < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Levels levels;
  for (int l = 0; l < n_levels; ++l) levels.res[l] = res[l];
  const int lane_bits = lane_bits_of(n_levels);
  const long long total = static_cast<long long>(n) << lane_bits;
  const unsigned blocks =
      static_cast<unsigned>((total + THREADS - 1) / THREADS);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define TEXGS_LAUNCH(F)                                                      \
  hash_encode_bwd_kernel<F><<<blocks, THREADS, 0, s>>>(                      \
      static_cast<const float*>(table), static_cast<const float*>(x),        \
      static_cast<const float*>(g), levels, n_levels, lane_bits,             \
      static_cast<uint32_t>(table_size), n, static_cast<float*>(d_table),    \
      static_cast<float*>(d_x))
  TEXGS_HASH_DISPATCH(n_feat, TEXGS_LAUNCH)
#undef TEXGS_LAUNCH
  return static_cast<int>(cudaGetLastError());
}
