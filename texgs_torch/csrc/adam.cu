// The Adam step of every leaf of one optimiser, in one launch: each leaf's
// parameter, first and second moment updated in place from its gradient.
//
// Replaces no TPU kernel: texgs's Adam is XLA elementwise operations
// (texgs/train/optim.py, update), and so was the port's plain chain
// (texgs_torch/train/optim.py, adam_plain), which stays as this kernel's
// plain version.  On the H100 that chain took 14 device launches a leaf,
// one leaf at a time: 404 launches and ~6.5 idle ms of a stage-3 step's
// three Adams (the texture's, the Gaussians', the UV nets'), 308 for stage
// 2's 22 leaves, 84 for stage 1's 6.
//
// Semantics: adam_plain's chain on every element, with each leaf's own
// learning rate and step count c:
//   m = b1 m + (1 - b1) g;  v = b2 v + (1 - b2) (g g);
//   p = p - (lr (m * inv1)) / (sqrt(v * inv2) + eps),
// inv1 = 1 / (1 - b1^c) and inv2 = 1 / (1 - b2^c) taken in double and
// rounded to float32, as torch's CUDA division of a tensor by a Python
// number multiplies by that reciprocal.  Every operation is rounded on its
// own, in the chain's order (no FMA: the chain has none), so the outputs
// are the plain chain's on the card bit for bit.  A null gradient pointer
// is g = 0 (a leaf with no .grad), through the same operations.  The host
// casts every constant and per-leaf scalar to float32 as the chain's tensor
// operations do.
//
// Bound on Hopper: bytes.  An element reads p, g, m and v and writes p, m
// and v: 28 B (24 with no gradient).  Stage 3's three Adams hold ~24.5 M
// elements (the texture 18.9 M, the Gaussians 5.6 M), 0.69 GB: 0.21 ms at
// 3.35 TB/s, against ~12 f32 operations an element.  The plain chain moves
// ~128 B an element.  Design: a flat grid over the leaves, BLOCK_ELEMS
// elements a block; a block finds its leaf by a binary search of the
// table's block starts (uniform across the block).  A leaf whose four
// pointers are 16-byte aligned moves as float4, UNROLL of each stream in
// flight a thread, loads first, so a thread keeps 16 16-byte loads in
// flight; its last n % 4 elements, and every element of a leaf that is not
// aligned, take a scalar path.  A small leaf (a net's 128-wide bias) costs
// one block: ~30 of stage 3's ~6,000.

#include <cuda_runtime.h>

namespace {

// The leaves one launch takes: the table, passed by value, stays under
// the 4 KB of a kernel's parameters (3,612 B).  An optimiser with more
// leaves launches once for each MAX_LEAVES of them.
constexpr int MAX_LEAVES = 64;
constexpr int BLOCK = 256;
constexpr int UNROLL = 4;
constexpr int BLOCK_ELEMS = BLOCK * UNROLL * 4;  // texgs_torch/train/optim.py

struct Table {
  float* p[MAX_LEAVES];
  const float* g[MAX_LEAVES];  // null: no gradient (g = 0)
  float* m[MAX_LEAVES];
  float* v[MAX_LEAVES];
  long long n[MAX_LEAVES];
  int start[MAX_LEAVES + 1];   // leaf i's blocks: [start[i], start[i + 1])
  float lr[MAX_LEAVES], inv1[MAX_LEAVES], inv2[MAX_LEAVES];
  float b1, omb1, b2, omb2, eps;  // b1, 1 - b1, b2, 1 - b2, eps
  int n_leaves;
};

struct Scalars {
  float b1, omb1, b2, omb2, eps, lr, inv1, inv2;
};

__device__ __forceinline__ void update(float& p, float g, float& m, float& v,
                                       const Scalars& s) {
  m = __fadd_rn(__fmul_rn(m, s.b1), __fmul_rn(s.omb1, g));
  v = __fadd_rn(__fmul_rn(v, s.b2), __fmul_rn(s.omb2, __fmul_rn(g, g)));
  const float m_hat = __fmul_rn(m, s.inv1);
  const float v_hat = __fmul_rn(v, s.inv2);
  p = __fsub_rn(p, __fdiv_rn(__fmul_rn(s.lr, m_hat),
                             __fadd_rn(__fsqrt_rn(v_hat), s.eps)));
}

__device__ __forceinline__ void update4(float4& p, float4 g, float4& m,
                                        float4& v, const Scalars& s) {
  update(p.x, g.x, m.x, v.x, s);
  update(p.y, g.y, m.y, v.y, s);
  update(p.z, g.z, m.z, v.z, s);
  update(p.w, g.w, m.w, v.w, s);
}

__device__ __forceinline__ bool aligned16(const void* a) {
  return reinterpret_cast<unsigned long long>(a) % 16 == 0;
}

__global__ void __launch_bounds__(BLOCK)
adam_kernel(const __grid_constant__ Table t) {
  const int b = blockIdx.x;
  int lo = 0, hi = t.n_leaves;  // the leaf with start[lo] <= b < start[lo + 1]
  while (hi - lo > 1) {
    const int mid = (lo + hi) / 2;
    if (t.start[mid] <= b) lo = mid; else hi = mid;
  }
  float* __restrict__ p = t.p[lo];
  const float* __restrict__ g = t.g[lo];
  float* __restrict__ m = t.m[lo];
  float* __restrict__ v = t.v[lo];
  const Scalars s{t.b1, t.omb1, t.b2, t.omb2, t.eps,
                  t.lr[lo], t.inv1[lo], t.inv2[lo]};
  const long long base = static_cast<long long>(b - t.start[lo]) * BLOCK_ELEMS;
  const long long end = min(t.n[lo], base + BLOCK_ELEMS);

  long long scalar_from = base;  // the elements past the float4 part
  if (aligned16(p) && aligned16(g) && aligned16(m) && aligned16(v)) {
    const long long q0 = base / 4, q1 = end / 4;  // float4s [q0, q1)
    float4 P[UNROLL], G[UNROLL], M[UNROLL], V[UNROLL];
#pragma unroll
    for (int k = 0; k < UNROLL; ++k) {
      const long long q = q0 + threadIdx.x + k * BLOCK;
      if (q < q1) {
        P[k] = reinterpret_cast<const float4*>(p)[q];
        G[k] = g ? reinterpret_cast<const float4*>(g)[q]
                 : make_float4(0.f, 0.f, 0.f, 0.f);
        M[k] = reinterpret_cast<const float4*>(m)[q];
        V[k] = reinterpret_cast<const float4*>(v)[q];
      }
    }
#pragma unroll
    for (int k = 0; k < UNROLL; ++k) {
      const long long q = q0 + threadIdx.x + k * BLOCK;
      if (q < q1) {
        update4(P[k], G[k], M[k], V[k], s);
        reinterpret_cast<float4*>(p)[q] = P[k];
        reinterpret_cast<float4*>(m)[q] = M[k];
        reinterpret_cast<float4*>(v)[q] = V[k];
      }
    }
    scalar_from = 4 * q1;
  }
  // the scalar path: at most 3 elements of an aligned leaf's last block,
  // every element of a leaf that is not aligned
  constexpr int PER_THREAD = BLOCK_ELEMS / BLOCK;
  float P[PER_THREAD], G[PER_THREAD], M[PER_THREAD], V[PER_THREAD];
#pragma unroll
  for (int k = 0; k < PER_THREAD; ++k) {
    const long long i = scalar_from + threadIdx.x + k * BLOCK;
    if (i < end) {
      P[k] = p[i];
      G[k] = g ? g[i] : 0.f;
      M[k] = m[i];
      V[k] = v[i];
    }
  }
#pragma unroll
  for (int k = 0; k < PER_THREAD; ++k) {
    const long long i = scalar_from + threadIdx.x + k * BLOCK;
    if (i < end) {
      update(P[k], G[k], M[k], V[k], s);
      p[i] = P[k];
      m[i] = M[k];
      v[i] = V[k];
    }
  }
}

}  // namespace

// One Adam step of n_leaves (1..MAX_LEAVES) leaves, in one launch on
// `stream`.  Host arrays, copied into the kernel's table: ptrs (n_leaves,
// 4) the device addresses of p, g (0: no gradient), m and v; sizes
// (n_leaves,) each leaf's elements, > 0; starts (n_leaves + 1,) each
// leaf's first block, starts[0] = 0 and ceil(size / BLOCK_ELEMS) blocks a
// leaf; scalars (n_leaves, 3) each leaf's lr, 1 / (1 - b1^c) and
// 1 / (1 - b2^c); consts (5,) b1, 1 - b1, b2, 1 - b2 and eps.  Returns
// cudaErrorInvalidValue for a table that breaks these rules, else
// cudaGetLastError() after the launch.
extern "C" int adam_step(const long long* ptrs, const long long* sizes,
                         const int* starts, const float* scalars,
                         const float* consts, int n_leaves, void* stream) {
  if (n_leaves < 1 || n_leaves > MAX_LEAVES || starts[0] != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Table t;
  for (int i = 0; i < n_leaves; ++i) {
    const long long n = sizes[i];
    const long long blocks = (n + BLOCK_ELEMS - 1) / BLOCK_ELEMS;
    if (n < 1 || ptrs[4 * i] == 0 || ptrs[4 * i + 2] == 0
        || ptrs[4 * i + 3] == 0
        || static_cast<long long>(starts[i + 1]) - starts[i] != blocks)
      return static_cast<int>(cudaErrorInvalidValue);
    t.p[i] = reinterpret_cast<float*>(ptrs[4 * i]);
    t.g[i] = reinterpret_cast<const float*>(ptrs[4 * i + 1]);
    t.m[i] = reinterpret_cast<float*>(ptrs[4 * i + 2]);
    t.v[i] = reinterpret_cast<float*>(ptrs[4 * i + 3]);
    t.n[i] = n;
    t.start[i] = starts[i];
    t.lr[i] = scalars[3 * i];
    t.inv1[i] = scalars[3 * i + 1];
    t.inv2[i] = scalars[3 * i + 2];
  }
  t.start[n_leaves] = starts[n_leaves];
  t.b1 = consts[0];
  t.omb1 = consts[1];
  t.b2 = consts[2];
  t.omb2 = consts[3];
  t.eps = consts[4];
  t.n_leaves = n_leaves;
  adam_kernel<<<starts[n_leaves], BLOCK, 0,
                static_cast<cudaStream_t>(stream)>>>(t);
  return static_cast<int>(cudaGetLastError());
}
