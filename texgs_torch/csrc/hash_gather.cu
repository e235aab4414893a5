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
// Design.  A thread takes four consecutive queries of one corner row: it
// loads their four indices as one 16-byte load, each table row as one
// float4 (F = 4) or float2 (F = 2), transposes the rows in registers and
// writes each of the F output planes as one 16-byte streaming store
// (__stcs: the output is written once and not read back here), so that
// a warp's stores of a plane are 512 contiguous bytes.  The grid is sized
// to at most WAVES full waves of the card, with a grid-stride loop, so the
// launch's tail is short.  Other F, an N that is not a multiple of 4, or a
// pointer not aligned for the vector accesses take a scalar path in the
// same kernel: one (corner row, query) an iteration, F scalar loads and
// stores.  The TPU kernel held the tables in VMEM and resolved corners
// with lane-local gathers in 128-lane segments because TPU gathers are
// slow; a Hopper thread simply loads the row (the 2^12-entry tables of
// the flagship config, 512 KB in all, stay in L2).
//
// Bound on Hopper: bytes, and at the flagship's 8,192 queries (64 corner
// rows) the launch itself: about 11 MB move in all.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 256;
constexpr int WAVES = 2;  // full waves of 2,048 threads an SM, at most

__device__ __forceinline__ void store4(float* p, float4 v) {
  __stcs(reinterpret_cast<float4*>(p), v);
}

// vec: F is 2 or 4, n % 4 == 0 and the pointers are aligned (host-checked).
__global__ void __launch_bounds__(THREADS)
    hash_gather_kernel(const float* __restrict__ table,
                       const int* __restrict__ idx, int corners,
                       int table_size, int n_feat, int n, int rows, bool vec,
                       float* __restrict__ out) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long first =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (vec) {
    const int n4 = n / 4;
    const long long total = static_cast<long long>(rows) * n4;
    for (long long i = first; i < total; i += stride) {
      const int r = static_cast<int>(i / n4);
      const int q = static_cast<int>(i % n4) * 4;
      // idx[r, q..q+3] starts at r * n + q = 4 i
      const int4 c = __ldg(reinterpret_cast<const int4*>(idx) + i);
      const float* level =
          table + static_cast<size_t>(r / corners) * table_size * n_feat;
      float* o = out + static_cast<size_t>(r) * n_feat * n + q;
      if (n_feat == 4) {
        const float4* rows4 = reinterpret_cast<const float4*>(level);
        const float4 a = __ldg(rows4 + c.x), b = __ldg(rows4 + c.y);
        const float4 e = __ldg(rows4 + c.z), h = __ldg(rows4 + c.w);
        store4(o, make_float4(a.x, b.x, e.x, h.x));
        store4(o + n, make_float4(a.y, b.y, e.y, h.y));
        store4(o + 2 * static_cast<size_t>(n), make_float4(a.z, b.z, e.z, h.z));
        store4(o + 3 * static_cast<size_t>(n), make_float4(a.w, b.w, e.w, h.w));
      } else {
        const float2* rows2 = reinterpret_cast<const float2*>(level);
        const float2 a = __ldg(rows2 + c.x), b = __ldg(rows2 + c.y);
        const float2 e = __ldg(rows2 + c.z), h = __ldg(rows2 + c.w);
        store4(o, make_float4(a.x, b.x, e.x, h.x));
        store4(o + n, make_float4(a.y, b.y, e.y, h.y));
      }
    }
    return;
  }
  const long long total = static_cast<long long>(rows) * n;
  for (long long i = first; i < total; i += stride) {
    const int r = static_cast<int>(i / n);
    const int q = static_cast<int>(i % n);
    const float* row =
        table + (static_cast<size_t>(r / corners) * table_size + idx[i]) *
                    n_feat;
    float* o = out + static_cast<size_t>(r) * n_feat * n + q;
    for (int f = 0; f < n_feat; ++f)
      o[static_cast<size_t>(f) * n] = __ldg(row + f);
  }
}

bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
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
  const bool vec = (n_feat == 4 || n_feat == 2) && n % 4 == 0 &&
                   aligned(table, 4 * n_feat) && aligned(idx, 16) &&
                   aligned(out, 16);
  int device = 0, sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const long long work = vec ? total / 4 : total;
  const long long cap = static_cast<long long>(sms > 0 ? sms : 1) * WAVES *
                        (2048 / THREADS);
  long long blocks = (work + THREADS - 1) / THREADS;
  if (blocks > cap) blocks = cap;
  hash_gather_kernel<<<static_cast<unsigned>(blocks), THREADS, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(table), static_cast<const int*>(idx), corners,
      table_size, n_feat, n, levels * corners, vec, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
