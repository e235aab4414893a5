// Kernel K5: the hash-grid gather of the inverse UV net.
//
// Replaces the TPU kernel texgs/nets/pallas_hashgrid.py:63 (hash_gather,
// pallas_call at :81).  Plain PyTorch version:
// texgs_torch/nets/hash_gather.py, gather_plain.
//
// out[r, f, n] = table[r / corners, idx[r, n], f] for every corner row r of
// the (L * corners, N) index array: the feature rows of the trilinear
// corners of each query, level by level.  Hashing and the trilinear weights
// stay outside it, as in texgs; the backward is a plain index_put_, as
// texgs's is an XLA scatter-add.  The port's hash grid runs the fused
// encode of hash_encode.cu instead; this gather is kept as the counterpart
// of texgs's Pallas kernel.
//
// Design.  One thread per (corner row, query), reading the F features of
// one table row and writing them to F planes; neighbouring threads take
// neighbouring queries, so the stores coalesce.  The TPU kernel held the
// tables in VMEM and resolved corners with lane-local gathers in 128-lane
// segments because TPU gathers are slow; a Hopper thread simply loads the
// row (the 2^12-entry tables of the flagship config, 512 KB in all, stay in
// L2).
//
// Bound on Hopper: bytes, and at the flagship's 8,192 queries (64 corner
// rows) the launch itself: about 11 MB move in all.

#include <cuda_runtime.h>

namespace {

__global__ void hash_gather_kernel(const float* __restrict__ table,
                                   const int* __restrict__ idx, int corners,
                                   int table_size, int n_feat, int n,
                                   int rows, float* __restrict__ out) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (i >= static_cast<long long>(rows) * n) return;
  const int r = static_cast<int>(i / n);
  const int q = static_cast<int>(i % n);
  const int level = r / corners;
  const float* row =
      table + (static_cast<size_t>(level) * table_size + idx[i]) * n_feat;
  float* o = out + static_cast<size_t>(r) * n_feat * n + q;
  for (int f = 0; f < n_feat; ++f) o[static_cast<size_t>(f) * n] = __ldg(row + f);
}

}  // namespace

// out (rows, n_feat, n) from table (levels, table_size, n_feat) and idx
// (rows, n) int32 with rows = levels * corners; every index must lie in
// [0, table_size).  Returns the launch's cudaGetLastError().
extern "C" int hash_gather_forward(const void* table, const void* idx,
                                   int levels, int corners, int table_size,
                                   int n_feat, int n, void* out,
                                   void* stream) {
  const long long total = static_cast<long long>(levels) * corners * n;
  if (total == 0) return 0;
  if (levels <= 0 || corners <= 0 || table_size <= 0 || n_feat <= 0 || n < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  hash_gather_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(table), static_cast<const int*>(idx), corners,
      table_size, n_feat, n, levels * corners, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
