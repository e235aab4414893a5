// Device code shared by kernel B (tex_term.cu) and its backward B'
// (tex_term_bwd.cu): the cubemap's face projection and the texels each
// bilinear tap reads (texgs_torch/kernels/cubemap.py, sample_cubemap).  The
// backward must scatter into exactly the texels the forward read, so both
// pick them here.  The coordinate arithmetic uses explicitly rounded
// intrinsics (__fmul_rn, __fadd_rn, __fdiv_rn), so the compiler cannot
// contract it into FMAs and pick a different texel than the plain version
// at a boundary.

#pragma once

#include <cuda_runtime.h>

namespace texgs {

constexpr float C0 = 0.28209479177387814f;
enum FilterMode { BILINEAR = 0, BILINEAR_CLAMP = 1, NEAREST = 2 };

// cubemap.direction_to_face_uv.  *ma receives the major-axis magnitude
// before its clamp to 1e-12.
__device__ __forceinline__ void dir_to_face_uv(float x, float y, float z,
                                               int& face, float& u, float& v,
                                               float* ma_raw = nullptr) {
  const float ax = fabsf(x), ay = fabsf(y), az = fabsf(z);
  const bool is_x = (ax >= ay) && (ax >= az);
  const bool is_y = !is_x && (ay >= az);
  const float m = is_x ? ax : (is_y ? ay : az);
  if (ma_raw) *ma_raw = m;
  const float ma = fmaxf(m, 1e-12f);
  if (is_x) {
    face = x >= 0.f ? 0 : 1;
    u = x >= 0.f ? -z : z;
    v = -y;
  } else if (is_y) {
    face = y >= 0.f ? 2 : 3;
    u = x;
    v = y >= 0.f ? z : -z;
  } else {
    face = z >= 0.f ? 4 : 5;
    u = z >= 0.f ? x : -x;
    v = -y;
  }
  u = __fdiv_rn(u, ma);
  v = __fdiv_rn(v, ma);
}

// cubemap.face_uv_to_direction (unnormalized)
__device__ __forceinline__ void face_uv_to_dir(int face, float u, float v,
                                               float& x, float& y, float& z) {
  switch (face) {
    case 0: x = 1.f; y = -v; z = -u; break;
    case 1: x = -1.f; y = -v; z = u; break;
    case 2: x = u; y = 1.f; z = v; break;
    case 3: x = u; y = -1.f; z = -v; break;
    case 4: x = u; y = -v; z = 1.f; break;
    default: x = -u; y = -v; z = -1.f; break;
  }
}

// (c * 0.5 + 0.5) * res truncated toward zero, clamped to [0, res)
__device__ __forceinline__ int texel_index(float c, int res) {
  const float t = __fmul_rn(__fadd_rn(__fmul_rn(c, 0.5f), 0.5f),
                            static_cast<float>(res));
  return min(max(static_cast<int>(t), 0), res - 1);
}

// Linear index of texel (face, yi, xi) in the (6, res, res) grid.
__device__ __forceinline__ int texel_at(int res, int face, int yi, int xi) {
  return (face * res + yi) * res + xi;
}

__device__ __forceinline__ int reresolve(int res, int face, float u_t,
                                         float v_t) {
  float x, y, z, u2, v2;
  int f2;
  face_uv_to_dir(face, u_t, v_t, x, y, z);
  dir_to_face_uv(x, y, z, f2, u2, v2);
  return texel_at(res, f2, texel_index(v2, res), texel_index(u2, res));
}

// The texels of one bilinear tap at texel (xi, yi) of `face`
// (cubemap.sample_cubemap's tap()).  Returns how many (1 or 3) and writes
// their linear indices: an in-face tap (or any tap without seamless
// filtering) reads the clamped texel; a seamless tap past one face edge
// re-resolves onto the adjacent face; a tap past a cube corner averages the
// 3 texels of the corner, in the order P (across the u edge), Q (across the
// v edge), R (the home face's clamped texel).
__device__ __forceinline__ int tap_texels(int res, float lim, bool seamless,
                                          int face, float xi, float yi,
                                          int idx[3]) {
  const int xc = min(max(static_cast<int>(xi), 0), res - 1);
  const int yc = min(max(static_cast<int>(yi), 0), res - 1);
  const int home = texel_at(res, face, yc, xc);
  idx[0] = home;
  if (!seamless) return 1;
  const float fres = static_cast<float>(res);
  const float u_t =
      __fadd_rn(__fmul_rn(__fdiv_rn(__fadd_rn(xi, 0.5f), fres), 2.f), -1.f);
  const float v_t =
      __fadd_rn(__fmul_rn(__fdiv_rn(__fadd_rn(yi, 0.5f), fres), 2.f), -1.f);
  const bool out_u = fabsf(u_t) > 1.f, out_v = fabsf(v_t) > 1.f;
  if (!out_u && !out_v) return 1;
  const float uc = fminf(fmaxf(u_t, -lim), lim);
  const float vc = fminf(fmaxf(v_t, -lim), lim);
  if (out_u && out_v) {
    idx[0] = reresolve(res, face, u_t, vc);
    idx[1] = reresolve(res, face, uc, v_t);
    idx[2] = home;
    return 3;
  }
  idx[0] = out_u ? reresolve(res, face, u_t, vc) : reresolve(res, face, uc, v_t);
  return 1;
}

// The bilinear footprint of one direction: face, fractions and the four
// taps' corners (sample_cubemap's fu, fv, x0, y0, wx, wy).
struct Footprint {
  int face;
  float u, v;       // face coordinates in [-1, 1]
  float ma_raw;     // major-axis magnitude before the 1e-12 clamp
  float x0, y0;     // floor of the texel-space coordinates
  float wx, wy;     // bilinear fractions
};

__device__ __forceinline__ Footprint footprint(int res, float dx, float dy,
                                               float dz) {
  Footprint fp;
  dir_to_face_uv(dx, dy, dz, fp.face, fp.u, fp.v, &fp.ma_raw);
  const float fres = static_cast<float>(res);
  const float fu = __fadd_rn(
      __fmul_rn(__fadd_rn(__fmul_rn(fp.u, 0.5f), 0.5f), fres), -0.5f);
  const float fv = __fadd_rn(
      __fmul_rn(__fadd_rn(__fmul_rn(fp.v, 0.5f), 0.5f), fres), -0.5f);
  fp.x0 = floorf(fu);
  fp.y0 = floorf(fv);
  fp.wx = fu - fp.x0;
  fp.wy = fv - fp.y0;
  return fp;
}

}  // namespace texgs
