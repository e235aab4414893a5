// Kernel K5': the fused multiresolution hash encode of the inverse UV net.
//
// Computes texgs's apply_hashgrid (texgs/nets/hashgrid.py:60-100, the xla
// branch's semantics; its TPU kernel is the gather of
// texgs/nets/pallas_hashgrid.py:63, pallas_call at :81) whole.  Plain
// PyTorch version: texgs_torch/nets/hash_encode.py, encode_plain.
//
// out[n, l F + f] = sum_c w_c(n, l) table[l, h_c(n, l), f] over the 8
// corners c of point n's cell at level l: pos = x res_l, its floor and
// fraction, the spatial hash h_c = (ix ^ iy 2654435761 ^ iz 805459861)
// mod T in uint32, the trilinear weight w_c = (wx wy) wz.
//
// Design.  One thread per (point, level), the level fastest: the lanes of
// one point are neighbours, so each thread writes its F features right
// after its neighbour's and a warp's stores to the row-major (N, L F)
// output coalesce.  A row of 4 features is one float4 load.  The TPU
// kernel held the tables in VMEM and resolved corners with lane-local
// gathers because TPU gathers are slow; on Hopper the flagship's tables
// (8 levels of 4,096 rows of 4 features, 512 KB) sit in L2 and a thread
// loads its 8 rows directly.  The hashing and weights that PyTorch ran as
// some 2,000 int64 and f32 operations a call happen here in registers.
//
// Bound on Hopper: bytes (x, the output and the tables once: 1.7 MB at the
// flagship's 8,192 points), which at that size is a launch's own cost.

#include "hash_encode_common.cuh"

namespace {

using namespace texgs_hash;

template <int F>
__global__ void __launch_bounds__(THREADS)
    hash_encode_kernel(const float* __restrict__ table,
                       const float* __restrict__ x, Levels levels,
                       int n_levels, int lane_bits, uint32_t table_size,
                       int n, float* __restrict__ out,
                       int* __restrict__ idx_out, float* __restrict__ w_out) {
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  const long long q = t >> lane_bits;
  const int l = static_cast<int>(t & ((1 << lane_bits) - 1));
  if (q >= n || l >= n_levels) return;
  const float xq[3] = {x[3 * q], x[3 * q + 1], x[3 * q + 2]};
  const Cell c = cell_of(xq, levels.res[l]);
  const float* tab = table + static_cast<size_t>(l) * table_size * F;
  float acc[F];
#pragma unroll
  for (int f = 0; f < F; ++f) acc[f] = 0.f;
#pragma unroll
  for (int corner = 0; corner < CORNERS; ++corner) {
    const uint32_t h = corner_hash(c, corner, table_size);
    float fac[3];
    corner_factors(c, corner, fac);
    const float w = corner_weight(fac);
    float row[F];
    load_row<F>(tab + static_cast<size_t>(h) * F, row);
    // each product rounded, then summed corner by corner, as the plain
    // version's (gathered * w).sum(corners)
#pragma unroll
    for (int f = 0; f < F; ++f)
      acc[f] = __fadd_rn(acc[f], __fmul_rn(w, row[f]));
    if (idx_out != nullptr) {
      const size_t at = static_cast<size_t>(l * CORNERS + corner) * n + q;
      idx_out[at] = static_cast<int>(h);
      w_out[at] = w;
    }
  }
  float* o = out + static_cast<size_t>(q) * n_levels * F +
             static_cast<size_t>(l) * F;
  if constexpr (F == 4) {
    *reinterpret_cast<float4*>(o) =
        make_float4(acc[0], acc[1], acc[2], acc[3]);
  } else {
#pragma unroll
    for (int f = 0; f < F; ++f) o[f] = acc[f];
  }
}

}  // namespace

// out (n, n_levels * n_feat) from table (n_levels, table_size, n_feat) and
// x (n, 3); res is host memory, one resolution per level.  idx_out and
// w_out, when not null, receive each corner's index (n_levels * 8, n)
// int32 and weight (n_levels * 8, n) f32.  Every pointer is 16-byte
// aligned.  Returns the launch's cudaGetLastError().
extern "C" int hash_encode_forward(const void* table, const void* x,
                                   const int* res, int n_levels,
                                   int table_size, int n_feat, int n,
                                   void* out, void* idx_out, void* w_out,
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
  hash_encode_kernel<F><<<blocks, THREADS, 0, s>>>(                          \
      static_cast<const float*>(table), static_cast<const float*>(x),        \
      levels, n_levels, lane_bits, static_cast<uint32_t>(table_size), n,     \
      static_cast<float*>(out), static_cast<int*>(idx_out),                  \
      static_cast<float*>(w_out))
  TEXGS_HASH_DISPATCH(n_feat, TEXGS_LAUNCH)
#undef TEXGS_LAUNCH
  return static_cast<int>(cudaGetLastError());
}
