// Device code shared by the fused hash encode K5' (hash_encode.cu) and its
// backward K5'' (hash_encode_bwd.cu): a point's cell at one level, the
// spatial hash of its 8 corners and their trilinear factors.  The backward
// recomputes what the forward picked, so both must round the same way:
// one definition here keeps them from drifting apart.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace texgs_hash {

constexpr int MAX_LEVELS = 32;  // a point's levels share one warp
constexpr int CORNERS = 8;
constexpr int THREADS = 256;
constexpr unsigned FULL = 0xffffffffu;
constexpr uint32_t PRIME_Y = 2654435761u;
constexpr uint32_t PRIME_Z = 805459861u;

// Each level's grid resolution floor(16 * 1.447^l), computed on the host in
// double precision as texgs does (device powf could round it otherwise).
struct Levels {
  int res[MAX_LEVELS];
};

// One point at one level: its cell's integer corner and the fraction
// inside the cell.  pos = x * res is one rounded product, as in the plain
// version: __fmul_rn keeps the compiler from contracting pos - floor(pos)
// into an FMA, whose unrounded product could sit on the other side of a
// grid line and pick another cell (another hash row, not a small error).
// frac = pos - floor(pos) is exact.
struct Cell {
  int ipos[3];
  float frac[3];
};

__device__ __forceinline__ Cell cell_of(const float x[3], int res) {
  Cell c;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float pos = __fmul_rn(x[a], static_cast<float>(res));
    const float fl = floorf(pos);
    c.ipos[a] = static_cast<int>(fl);
    c.frac[a] = __fsub_rn(pos, fl);
  }
  return c;
}

// tcnn's spatial hash of corner `corner` (bit a: +1 along axis a) modulo
// the table size, in uint32 arithmetic: a negative coordinate wraps as
// texgs's astype(uint32) does.
__device__ __forceinline__ uint32_t corner_hash(const Cell& c, int corner,
                                                uint32_t table_size) {
  const uint32_t ux = static_cast<uint32_t>(c.ipos[0]) + (corner & 1);
  const uint32_t uy = static_cast<uint32_t>(c.ipos[1]) + ((corner >> 1) & 1);
  const uint32_t uz = static_cast<uint32_t>(c.ipos[2]) + ((corner >> 2) & 1);
  return (ux ^ (uy * PRIME_Y) ^ (uz * PRIME_Z)) % table_size;
}

// The corner's trilinear factors along each axis: frac where its bit is
// set, 1 - frac where not.  Its weight is (f[0] f[1]) f[2], in texgs's
// order.
__device__ __forceinline__ void corner_factors(const Cell& c, int corner,
                                               float f[3]) {
#pragma unroll
  for (int a = 0; a < 3; ++a)
    f[a] = ((corner >> a) & 1) ? c.frac[a] : __fsub_rn(1.f, c.frac[a]);
}

__device__ __forceinline__ float corner_weight(const float f[3]) {
  return __fmul_rn(__fmul_rn(f[0], f[1]), f[2]);
}

// One table row of F features; a row of 4 (every config of the repo) is
// one float4 load, a row of 2 one float2 (the caller keeps the table
// 16-byte aligned).
template <int F>
__device__ __forceinline__ void load_row(const float* __restrict__ row,
                                         float v[F]) {
  if constexpr (F == 4) {
    const float4 r = __ldg(reinterpret_cast<const float4*>(row));
    v[0] = r.x;
    v[1] = r.y;
    v[2] = r.z;
    v[3] = r.w;
  } else if constexpr (F == 2) {
    const float2 r = __ldg(reinterpret_cast<const float2*>(row));
    v[0] = r.x;
    v[1] = r.y;
  } else {
#pragma unroll
    for (int f = 0; f < F; ++f) v[f] = __ldg(row + f);
  }
}

// The smallest power of two >= n_levels, as its log2: a point's levels take
// that many neighbouring lanes of a warp (the rest idle), so a warp holds
// whole points.
inline int lane_bits_of(int n_levels) {
  int bits = 0;
  while ((1 << bits) < n_levels) ++bits;
  return bits;
}

}  // namespace texgs_hash

// The launch of a kernel templated on the feature count F (1..8): expands
// CALL(F) for the matching F, else returns cudaErrorInvalidValue.
#define TEXGS_HASH_DISPATCH(n_feat, CALL)                          \
  switch (n_feat) {                                                \
    case 1: CALL(1); break;                                        \
    case 2: CALL(2); break;                                        \
    case 3: CALL(3); break;                                        \
    case 4: CALL(4); break;                                        \
    case 5: CALL(5); break;                                        \
    case 6: CALL(6); break;                                        \
    case 7: CALL(7); break;                                        \
    case 8: CALL(8); break;                                        \
    default: return static_cast<int>(cudaErrorInvalidValue);       \
  }
