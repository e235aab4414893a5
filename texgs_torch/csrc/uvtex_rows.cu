// Kernel G: the per-Gaussian rows of the stage-3 render, one Gaussian a
// thread, in one launch: the table kernels A, A', 1 and 2 read (the
// anchor-frame exponent quadratic, the log-opacity, the blend channels and
// the anchor corner) and the uv rows A, A', 2 and 2' read (Sigma^-1 v,
// Sigma^-1, base_uv and J).
//
// Replaces no TPU kernel: texgs builds these rows with XLA ops
// (texgs/kernels/uvtex_raster.py build_uvtex_tables and build_uv_rows,
// texgs/kernels/tile_raster.py build_gauss_table), and so did the port's
// plain PyTorch chain (texgs_torch/kernels/uvtex_raster.py
// uvtex_rows_plain), which stays as this kernel's plain version.  On the
// H100 that chain took ~176 device launches a render and autograd's pass
// through it ~390: host-bound in both stage-3 cells.  This kernel and its
// backward (uvtex_rows_bwd.cu) take one launch each; the camera centre
// reaches them by value.
//
// Semantics: the plain chain (uvtex_rows_common.cuh says how it is rounded
// here):
//   table (N, 16 + E): [-a/2, -c/2, -b, a mx' + b my', c my' + b mx',
//       -(a mx'^2 + c my'^2)/2 - b mx' my' + log(op), log(op), rgb, depth,
//       normal, anchor_x, anchor_y, extra (E)], with (a, b, c) the conic,
//       anchor = floor(m / 16) * 16, m' = m - anchor and op clamped to
//       1e-12 below;
//   uv_rows (N, 24): [Sigma^-1 v, Sigma^-1 packed (xx, xy, xz, yy, yz,
//       zz), uv - J v, J, 0, 0, 0], Sigma^-1 = R diag(1 / max(s^2,
//       1e-24)) R^T and v = mu - o.
// Every output has one writer; no atomics.
//
// Bound on Hopper: bytes, and far below a launch.  A Gaussian reads 140 B
// (xyz, scaling, rotation, uvs, J, means2d, depth, conic, opacity, normal,
// colour; 152 with E = 3) and writes 160 (a table row of 16 floats, a uv
// row of 24; 172 with E = 3): 30 MB at 100,000 Gaussians, 0.009 ms at
// 3.35 TB/s, against ~110 f32 operations a Gaussian (11 MFLOP).

#include <cuda_runtime.h>

#include "uvtex_rows_common.cuh"

namespace {

using namespace texgs::rows;

constexpr int BLOCK = 256;

// The N values v (in registers) to the row at dst: four a store where dst
// is 16-byte aligned, else one.  A warp's store to its 32 rows touches 32
// sectors of 32 bytes: a float4 store fills half of each, a scalar one an
// eighth.
template <int N>
__device__ __forceinline__ void store_row(float* dst, const float (&v)[N]) {
  if (N % 4 == 0 && reinterpret_cast<unsigned long long>(dst) % 16 == 0) {
#pragma unroll
    for (int j = 0; j < N; j += 4)
      *reinterpret_cast<float4*>(dst + j) =
          make_float4(v[j], v[j + 1], v[j + 2], v[j + 3]);
  } else {
#pragma unroll
    for (int j = 0; j < N; ++j) dst[j] = v[j];
  }
}

__global__ void __launch_bounds__(BLOCK)
uvtex_rows_kernel(const __grid_constant__ Inputs in, int n,
                  float* __restrict__ table, float* __restrict__ uv_rows) {
  const int g = blockIdx.x * BLOCK + threadIdx.x;
  if (g >= n) return;
  const long long k = g;  // 64-bit offsets: 24 g passes 2^31 past 89M

  // build_gauss_table
  const Quad q = quad_of(in, k);
  const float a = in.conics[3 * k], b = in.conics[3 * k + 1],
              c = in.conics[3 * k + 2];
  const float mxa = q.mxa, mya = q.mya;
  float t[TABLE_FIXED];
  t[0] = mul(-0.5f, a);
  t[1] = mul(-0.5f, c);
  t[2] = -b;
  t[3] = add(mul(a, mxa), mul(b, mya));
  t[4] = add(mul(c, mya), mul(b, mxa));
  t[5] = add(sub(mul(-0.5f, add(mul(mul(a, mxa), mxa), mul(mul(c, mya), mya))),
                 mul(mul(b, mxa), mya)),
             q.logop);
  t[6] = q.logop;
#pragma unroll
  for (int j = 0; j < 3; ++j) t[7 + j] = in.colors[3 * k + j];
  t[10] = in.depths[k];
#pragma unroll
  for (int j = 0; j < 3; ++j) t[11 + j] = in.normals[3 * k + j];
  t[14] = q.anchor_x;
  t[15] = q.anchor_y;
  float* row = table + (TABLE_FIXED + in.n_extra) * k;
  store_row(row, t);
  for (int j = 0; j < in.n_extra; ++j)
    row[TABLE_FIXED + j] = in.extra[in.n_extra * k + j];

  // build_uvtex_tables, then build_uv_rows
  const Sigma s = sigma_of(in, k);
  const float* v = s.v;
  const float* jac = in.jac + 9 * k;
  float u[UV_COLS];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    float r[3];
    sym_row(s.s, i, r);
    u[i] = add(add(mul(r[0], v[0]), mul(r[1], v[1])), mul(r[2], v[2]));
  }
#pragma unroll
  for (int e = 0; e < 6; ++e) u[3 + e] = s.s[e];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float jv = add(add(mul(jac[3 * i], v[0]), mul(jac[3 * i + 1], v[1])),
                         mul(jac[3 * i + 2], v[2]));
    u[9 + i] = sub(in.uvs[3 * k + i], jv);
  }
#pragma unroll
  for (int e = 0; e < 9; ++e) u[12 + e] = jac[e];
  u[21] = 0.f;
  u[22] = 0.f;
  u[23] = 0.f;
  store_row(uv_rows + UV_COLS * k, u);
}

}  // namespace

// The rows of n Gaussians from the inputs *in (a host struct, passed to the
// kernel by value): one launch on `stream`, none for n = 0.  table is (n,
// 16 + in->n_extra), uv_rows (n, 24), both contiguous.  Returns
// cudaGetLastError() after the launch.
extern "C" int uvtex_rows_forward(const Inputs* in, int n, void* table,
                                  void* uv_rows, void* stream) {
  if (n < 0 || in->n_extra < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return static_cast<int>(cudaSuccess);
  if (in->n_extra > 0 && in->extra == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  uvtex_rows_kernel<<<(n + BLOCK - 1) / BLOCK, BLOCK, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      *in, n, static_cast<float*>(table), static_cast<float*>(uv_rows));
  return static_cast<int>(cudaGetLastError());
}
