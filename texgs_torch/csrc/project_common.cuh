// Device code shared by kernel P (project.cu), the Gaussian projection, and
// its backward P' (project_bwd.cu): the camera each takes by value, the
// forward chain of one Gaussian and the VJPs of its rotation.  P'
// recomputes P's intermediates from the saved inputs instead of reading
// them from memory, so both must round every operation the same way: one
// definition here keeps them together.  Kernels G and G' (uvtex_rows*.cu)
// take the rotation and its VJPs from here too.
//
// The chain is kernels/project.py's plain version (project_plain) for one
// Gaussian.  Its elementwise operations are rounded one at a time, in the
// order of the plain version's tensor expressions (explicit __f*_rn
// intrinsics, so the compiler cannot contract them into FMAs); its three
// small matrix products (the homogeneous point times full_proj and times
// world_view, the packed covariance times the (6, 6) quad matrix) are FMA
// chains over k in order, as a GEMM accumulates them; the quaternion's norm
// is a sum of squares in order.  So P's outputs sit within a few ulps of
// the plain chain's, and its radii and visible set agree with it but where
// 3 sqrt(lambda1) lies within an ulp of an integer.

#pragma once

#include <cuda_runtime.h>

namespace texgs {
namespace proj {

constexpr float NEAR_CULL = 0.2f;       // project.NEAR_CULL
constexpr float COV2D_DILATION = 0.3f;  // project.COV2D_DILATION
constexpr float NORM_EPS = 1e-12f;      // transforms.rotation_channels
constexpr float W_EPS = 1e-7f;          // project.project_points

// The camera as the plain version sees it, every value float32 as PyTorch
// rounds it there (a Python float meets a float32 tensor as its float32
// value).  Filled on the host from the Camera's numpy arrays
// (kernels/project.py camera_arg) and passed by value: no host-to-device
// copy.  The layout is ctypes' (project.py _Camera): keep the two in step.
struct Camera {
  float world_view[16];  // (4, 4) row-major, row-vector world -> view
  float full_proj[16];   // (4, 4) row-major, row-vector world -> clip
  float quad[36];        // (6 channels, 6 pairs) row-major: compute_cov2d's
                         // quad_mat, products of world_view[:3, :3]^T rows
  float campos[3];       // camera centre
  float focal_x, focal_y;  // width / (2 tanfovx), height / (2 tanfovy)
  float lim_x, lim_y;      // 1.3 tanfovx, 1.3 tanfovy
  float width, height;     // the image size, as floats
  float scaling_modifier;
};

// Where the covariance comes from.
enum CovSource : int { COV_BUILT = 0, COV_PACKED = 1, COV_FULL = 2 };

__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float div(float a, float b) { return __fdiv_rn(a, b); }

// torch.clamp: a NaN stays NaN.
__device__ __forceinline__ float clampf(float v, float lo, float hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// Row j of [p, 1] @ m (m row-major (4, 4)), accumulated over k in order.
__device__ __forceinline__ float hom_row(const float* m, float x, float y,
                                         float z, int j) {
  float acc = mul(x, m[j]);
  acc = __fmaf_rn(y, m[4 + j], acc);
  acc = __fmaf_rn(z, m[8 + j], acc);
  return __fmaf_rn(1.f, m[12 + j], acc);
}

// The normalised quaternion and the nine entries of its rotation matrix
// (transforms.rotation_channels), row-major r[3 * i + k].
struct Rotation {
  float nrm;    // |q|
  float w, x, y, z;  // q / (|q| + 1e-12)
  float r[9];
};

// The rotation of q given its norm nrm.
__device__ __forceinline__ Rotation rotation_with_norm(float qw, float qx,
                                                       float qy, float qz,
                                                       float nrm) {
  Rotation o;
  o.nrm = nrm;
  const float d = add(o.nrm, NORM_EPS);
  const float w = div(qw, d), x = div(qx, d), y = div(qy, d), z = div(qz, d);
  o.w = w; o.x = x; o.y = y; o.z = z;
  o.r[0] = sub(1.f, mul(2.f, add(mul(y, y), mul(z, z))));
  o.r[1] = mul(2.f, sub(mul(x, y), mul(w, z)));
  o.r[2] = mul(2.f, add(mul(x, z), mul(w, y)));
  o.r[3] = mul(2.f, add(mul(x, y), mul(w, z)));
  o.r[4] = sub(1.f, mul(2.f, add(mul(x, x), mul(z, z))));
  o.r[5] = mul(2.f, sub(mul(y, z), mul(w, x)));
  o.r[6] = mul(2.f, sub(mul(x, z), mul(w, y)));
  o.r[7] = mul(2.f, add(mul(y, z), mul(w, x)));
  o.r[8] = sub(1.f, mul(2.f, add(mul(x, x), mul(y, y))));
  return o;
}

// rotation_with_norm, |q| summed in order, an FMA a square.
__device__ __forceinline__ Rotation rotation_of(float qw, float qx, float qy,
                                                float qz) {
  float s = mul(qw, qw);
  s = __fmaf_rn(qx, qx, s);
  s = __fmaf_rn(qy, qy, s);
  s = __fmaf_rn(qz, qz, s);
  return rotation_with_norm(qw, qx, qy, qz, __fsqrt_rn(s));
}

// The VJP of the packed symmetric matrix R diag(S) R^T (entry (i, j):
// S0 r_i0 r_j0 + S1 r_i1 r_j1 + S2 r_i2 r_j2, packed xx, xy, xz, yy, yz,
// zz) for its cotangent d: adds R's gradient to dR (row-major) and writes
// S's to dS.
__device__ __forceinline__ void packed_rdr_vjp(const float* r, const float* S,
                                               const float* d, float* dR,
                                               float* dS) {
  // d as a symmetric matrix M with the diagonal doubled:
  // d R[i][c] = S_c sum_j M_ij R[j][c]
  const float M[9] = {2.f * d[0], d[1], d[2],
                      d[1], 2.f * d[3], d[4],
                      d[2], d[4], 2.f * d[5]};
  for (int c = 0; c < 3; ++c) {
    const float r0 = r[c], r1 = r[3 + c], r2 = r[6 + c];
    dS[c] = d[0] * r0 * r0 + d[1] * r0 * r1 + d[2] * r0 * r2
            + d[3] * r1 * r1 + d[4] * r1 * r2 + d[5] * r2 * r2;
    for (int row = 0; row < 3; ++row)
      dR[3 * row + c] += S[c] * (M[3 * row] * r0 + M[3 * row + 1] * r1
                                 + M[3 * row + 2] * r2);
  }
}

// The VJP of rotation_with_norm: dR, the gradient of the rotation matrix's nine
// entries (row-major), through rotation_channels' entries into the
// normalised quaternion, then through q / (|q| + 1e-12) into the raw
// quaternion q, written to dq (no gradient through |q| = 0, as torch's norm
// backward).
__device__ __forceinline__ void rotation_vjp(const Rotation& rot,
                                             const float* q, const float* dR,
                                             float* dq) {
  const float w = rot.w, qx = rot.x, qy = rot.y, qz = rot.z;
  const float dw = 2.f * (-qz * dR[1] + qy * dR[2] + qz * dR[3]
                          - qx * dR[5] - qy * dR[6] + qx * dR[7]);
  const float dx = 2.f * (qy * dR[1] + qz * dR[2] + qy * dR[3] - w * dR[5]
                          + qz * dR[6] + w * dR[7])
                   - 4.f * qx * (dR[4] + dR[8]);
  const float dy = 2.f * (qx * dR[1] + w * dR[2] + qx * dR[3] + qz * dR[5]
                          - w * dR[6] + qz * dR[7])
                   - 4.f * qy * (dR[0] + dR[8]);
  const float dz = 2.f * (-w * dR[1] + qx * dR[2] + w * dR[3] + qy * dR[5]
                          + qx * dR[6] + qy * dR[7])
                   - 4.f * qz * (dR[0] + dR[4]);
  const float qr[4] = {q[0], q[1], q[2], q[3]};
  const float dn[4] = {dw, dx, dy, dz};
  const float den = add(rot.nrm, NORM_EPS);
  float d_den = 0.f;
  for (int c = 0; c < 4; ++c) d_den -= dn[c] * qr[c];
  d_den /= den * den;
  const float d_nrm = rot.nrm == 0.f ? 0.f : d_den / rot.nrm;
  for (int c = 0; c < 4; ++c) dq[c] = dn[c] / den + d_nrm * qr[c];
}

// Everything the forward computes for one Gaussian that its outputs or the
// backward read.
struct Forward {
  // project_points
  float p[4];      // [xyz, 1] @ full_proj
  float p_w;       // 1 / (p[3] + 1e-7)
  float ndc_x, ndc_y;  // before the offset
  // compute_cov2d
  float t[3];      // ([xyz, 1] @ world_view)[:3]
  float u_x, u_y;  // t.x / t.z, t.y / t.z, before the clamp
  float txtz, tytz, inv_z, inv_z2, a0, c0, b1, c1;
  float cov[6];    // packed world covariance (xx, xy, xz, yy, yz, zz)
  float s[6];      // cov @ quad: s00, s01, s02, s11, s12, s22
  float a, b, c;   // the dilated screen covariance
  float det, inv_det;
  bool det_ok;
  float radius;    // ceil(3 sqrt(lambda1)), before the cull
  // the scales squared (S_k = (modifier s_k)^2) of a built covariance
  float sm[3], sq[3];
};

// Forward chain of one Gaussian.  cov_in: its packed (6) or full (9)
// covariance row when src is COV_PACKED or COV_FULL (else unread).
__device__ __forceinline__ Forward forward_of(const Camera& cam, float x,
                                              float y, float z,
                                              const float* sc,
                                              const Rotation& rot,
                                              CovSource src,
                                              const float* cov_in) {
  Forward f;
  // project_points
  for (int j = 0; j < 4; ++j) f.p[j] = hom_row(cam.full_proj, x, y, z, j);
  f.p_w = div(1.f, add(f.p[3], W_EPS));
  f.ndc_x = mul(f.p[0], f.p_w);
  f.ndc_y = mul(f.p[1], f.p_w);

  // the world covariance: built (transforms.build_covariance_packed) or
  // given (strip_symmetric of a full one)
  if (src == COV_BUILT) {
    const float* r = rot.r;
    for (int k = 0; k < 3; ++k) {
      f.sm[k] = mul(cam.scaling_modifier, sc[k]);
      f.sq[k] = mul(f.sm[k], f.sm[k]);
    }
    // entry (i, j): S0 r_i0 r_j0 + S1 r_i1 r_j1 + S2 r_i2 r_j2
    const int I[6] = {0, 0, 0, 1, 1, 2}, J[6] = {0, 1, 2, 1, 2, 2};
#pragma unroll
    for (int e = 0; e < 6; ++e) {
      const int i = I[e], j = J[e];
      float acc = mul(mul(f.sq[0], r[3 * i]), r[3 * j]);
      acc = add(acc, mul(mul(f.sq[1], r[3 * i + 1]), r[3 * j + 1]));
      f.cov[e] = add(acc, mul(mul(f.sq[2], r[3 * i + 2]), r[3 * j + 2]));
    }
  } else if (src == COV_PACKED) {
    for (int e = 0; e < 6; ++e) f.cov[e] = cov_in[e];
  } else {
    f.cov[0] = cov_in[0]; f.cov[1] = cov_in[1]; f.cov[2] = cov_in[2];
    f.cov[3] = cov_in[4]; f.cov[4] = cov_in[5]; f.cov[5] = cov_in[8];
  }

  // compute_cov2d
  for (int j = 0; j < 3; ++j) f.t[j] = hom_row(cam.world_view, x, y, z, j);
  const float tz = f.t[2];
  f.u_x = div(f.t[0], tz);
  f.u_y = div(f.t[1], tz);
  f.txtz = mul(clampf(f.u_x, -cam.lim_x, cam.lim_x), tz);
  f.tytz = mul(clampf(f.u_y, -cam.lim_y, cam.lim_y), tz);
  f.inv_z = div(1.f, tz);
  f.inv_z2 = mul(f.inv_z, f.inv_z);
  f.a0 = mul(cam.focal_x, f.inv_z);
  f.c0 = mul(mul(-cam.focal_x, f.txtz), f.inv_z2);
  f.b1 = mul(cam.focal_y, f.inv_z);
  f.c1 = mul(mul(-cam.focal_y, f.tytz), f.inv_z2);
#pragma unroll
  for (int q = 0; q < 6; ++q) {
    float acc = mul(f.cov[0], cam.quad[q]);
#pragma unroll
    for (int k = 1; k < 6; ++k) acc = __fmaf_rn(f.cov[k], cam.quad[6 * k + q], acc);
    f.s[q] = acc;
  }
  const float a0 = f.a0, c0 = f.c0, b1 = f.b1, c1 = f.c1;
  const float s00 = f.s[0], s01 = f.s[1], s02 = f.s[2], s11 = f.s[3],
              s12 = f.s[4], s22 = f.s[5];
  f.a = add(add(add(mul(mul(a0, a0), s00), mul(mul(mul(2.f, a0), c0), s02)),
                mul(mul(c0, c0), s22)),
            COV2D_DILATION);
  f.b = add(add(add(mul(mul(a0, b1), s01), mul(mul(a0, c1), s02)),
                mul(mul(c0, b1), s12)),
            mul(mul(c0, c1), s22));
  f.c = add(add(add(mul(mul(b1, b1), s11), mul(mul(mul(2.f, b1), c1), s12)),
                mul(mul(c1, c1), s22)),
            COV2D_DILATION);

  // conic and radius
  f.det = sub(mul(f.a, f.c), mul(f.b, f.b));
  f.det_ok = f.det != 0.f;
  f.inv_det = f.det_ok ? div(1.f, f.det) : 0.f;
  const float mid = mul(0.5f, add(f.a, f.c));
  const float disc = sub(mul(mid, mid), f.det);
  const float lam1 = add(mid, __fsqrt_rn(disc < 0.1f ? 0.1f : disc));
  f.radius = ceilf(mul(3.f, __fsqrt_rn(lam1)));
  return f;
}

// torch.argmin over the three scales: the first smallest (a NaN counts as
// the smallest, the first NaN winning, as torch's reduction takes it).
__device__ __forceinline__ int argmin3(const float* s) {
  int idx = 0;
  float m = s[0];
  for (int k = 1; k < 3; ++k) {
    if (m != m) break;
    if (s[k] != s[k] || s[k] < m) {
      m = s[k];
      idx = k;
    }
  }
  return idx;
}

// flat_normals' sign: +1 where the normal faces the camera or is at right
// angles to it (torch.sign 0 -> 1), -1 where it faces away.
__device__ __forceinline__ float facing_sign(const Camera& cam,
                                             const Rotation& rot, int idx,
                                             float x, float y, float z) {
  const float d = add(add(mul(rot.r[idx], sub(cam.campos[0], x)),
                          mul(rot.r[3 + idx], sub(cam.campos[1], y))),
                      mul(rot.r[6 + idx], sub(cam.campos[2], z)));
  return d < 0.f ? -1.f : 1.f;
}

}  // namespace proj
}  // namespace texgs
