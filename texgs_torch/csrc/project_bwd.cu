// Kernel P': the VJP of kernel P (project.cu), the Gaussian projection, one
// Gaussian a thread, in one launch.
//
// Replaces no TPU kernel: texgs differentiates its XLA projection
// (texgs/kernels/project.py) with JAX's autodiff, and the port's plain
// chain (texgs_torch/kernels/project.py, project_plain) with autograd, which
// stays as this kernel's plain version.  On the H100 autograd's backward
// through that chain took 539 device launches a training step, and its
// host work sat in the step's most idle phase (benchmark `backward`).
//
// Design.  A thread recomputes its Gaussian's forward intermediates from
// the saved inputs and the camera (project_common.cuh forward_of, rounded
// as kernel P rounds them), then writes the exact VJP of the plain chain,
// term for term as autograd forms it:
//  - means2d and depth into the clip point, through p_w = 1 / (w + 1e-7);
//    the NDC offset's gradient is the NDC-space one, in the densifier's
//    units (pixel gradient * [W / 2, H / 2]);
//  - the conic into (a, b, c) through the inverse, 0 where det = 0 (the
//    forward's where); the radius has no gradient (ceil);
//  - (a, b, c) into the EWA Jacobian's terms, the view point (with the
//    clamp of t.x / t.z and t.y / t.z passing no gradient beyond
//    1.3 tan(fov), and passing it at the limits, as torch.clamp does) and
//    the packed covariance through the (6, 6) quad matrix;
//  - the covariance into the scales and rotation matrix, or into the given
//    covariance (its upper triangle, for a full (3, 3) one);
//  - the normal into its rotation column, the smallest-scale index and the
//    facing sign held constant;
//  - the rotation matrix into the quaternion through rotation_channels'
//    renormalisation q / (|q| + 1e-12) (no gradient through |q| = 0, as
//    torch's norm backward);
//  - the opacity where the Gaussian is visible.
// The cotangents are read through their strides (autograd may hand
// column views or broadcasts), any of them may be absent (zero), and each
// gradient is written once, in full, so nothing needs a zero fill: one
// launch a differentiated render.
//
// Bound on Hopper: bytes, and far below a launch.  A Gaussian reads 44 B of
// inputs and 40 of cotangents and writes 52 (xyz, scaling, rotation,
// opacity, NDC offset): 13.6 MB at 100,000 Gaussians, 0.0041 ms at
// 3.35 TB/s, against ~600 f32 operations a Gaussian (the forward replayed
// and its transpose; 60 MFLOP, 0.0009 ms).

#include <cuda_runtime.h>

#include "project_common.cuh"

namespace texgs {
namespace proj {

// The C entry's argument structs live in a named namespace: a type of the
// anonymous one would give the entry internal linkage.
//
// The cotangents of P's outputs, null where autograd has none; strides in
// elements.  The layout is ctypes' (project.py _Cotangents).
struct Cotangents {
  const float* means2d;    // (N, 2)
  const float* depths;     // (N,)
  const float* conics;     // (N, 3)
  const float* opacities;  // (N,)
  const float* normals;    // (N, 3)
  long long means2d_s0, means2d_s1, depths_s0, conics_s0, conics_s1,
      opacities_s0, normals_s0, normals_s1;
};

// Where the gradients go, null where none is wanted; contiguous.  The
// layout is ctypes' (project.py _Gradients).
struct Gradients {
  float* xyz;         // (N, 3)
  float* scaling;     // (N, 3)
  float* rotation;    // (N, 4)
  float* opacity;     // (N,) or (N, 1)
  float* ndc_offset;  // (N, 2)
  float* cov;         // (N, 6) or (N, 3, 3), as the given covariance
};

}  // namespace proj
}  // namespace texgs

namespace {

using namespace texgs::proj;

constexpr int BLOCK = 256;

__device__ __forceinline__ float at(const float* p, long long i) {
  return p == nullptr ? 0.f : p[i];
}

__global__ void __launch_bounds__(BLOCK)
project_bwd_kernel(const __grid_constant__ Camera cam, int n,
                   const float* __restrict__ xyz,
                   const float* __restrict__ scaling,
                   const float* __restrict__ rotation,
                   const float* __restrict__ opacity,
                   const float* __restrict__ cov_in, int cov_src,
                   const __grid_constant__ Cotangents g,
                   const __grid_constant__ Gradients d) {
  const int i = blockIdx.x * BLOCK + threadIdx.x;
  if (i >= n) return;
  const long long k = i;
  const float x = xyz[3 * k], y = xyz[3 * k + 1], z = xyz[3 * k + 2];
  const float sc[3] = {scaling[3 * k], scaling[3 * k + 1], scaling[3 * k + 2]};
  const Rotation rot = rotation_of(rotation[4 * k], rotation[4 * k + 1],
                                   rotation[4 * k + 2], rotation[4 * k + 3]);
  const CovSource src = static_cast<CovSource>(cov_src);
  const float* cov = src == COV_PACKED ? cov_in + 6 * k
                     : src == COV_FULL ? cov_in + 9 * k
                                       : nullptr;
  const Forward f = forward_of(cam, x, y, z, sc, rot, src, cov);

  const float g_mx = at(g.means2d, k * g.means2d_s0);
  const float g_my = at(g.means2d, k * g.means2d_s0 + g.means2d_s1);
  const float g_depth = at(g.depths, k * g.depths_s0);
  const float g_c0 = at(g.conics, k * g.conics_s0);
  const float g_c1 = at(g.conics, k * g.conics_s0 + g.conics_s1);
  const float g_c2 = at(g.conics, k * g.conics_s0 + 2 * g.conics_s1);
  const float g_op = at(g.opacities, k * g.opacities_s0);
  float g_n[3];
  for (int j = 0; j < 3; ++j)
    g_n[j] = at(g.normals, k * g.normals_s0 + j * g.normals_s1);

  // means2d = ((ndc + 1) * size - 1) * 0.5; ndc = p.xy * p_w (+ offset)
  const float d_ndc_x = g_mx * 0.5f * cam.width;
  const float d_ndc_y = g_my * 0.5f * cam.height;
  if (d.ndc_offset != nullptr) {
    d.ndc_offset[2 * k] = d_ndc_x;
    d.ndc_offset[2 * k + 1] = d_ndc_y;
  }
  float dp[4];
  dp[0] = d_ndc_x * f.p_w;
  dp[1] = d_ndc_y * f.p_w;
  dp[2] = 0.f;
  const float d_pw = d_ndc_x * f.p[0] + d_ndc_y * f.p[1];
  dp[3] = g_depth - d_pw * (f.p_w * f.p_w);

  // conic = (c, -b, a) * inv_det, inv_det = 1 / det where det != 0
  float da = g_c2 * f.inv_det, db = -(g_c1 * f.inv_det),
        dc = g_c0 * f.inv_det;
  if (f.det_ok) {
    const float d_inv = g_c0 * f.c - g_c1 * f.b + g_c2 * f.a;
    const float d_det = -d_inv * (f.inv_det * f.inv_det);
    da += d_det * f.c;
    dc += d_det * f.a;
    db += -2.f * f.b * d_det;
  }

  // (a, b, c) from the Jacobian's terms and s = cov @ quad
  const float a0 = f.a0, c0 = f.c0, b1 = f.b1, c1 = f.c1;
  const float* s = f.s;
  const float d_a0 = da * (2.f * a0 * s[0] + 2.f * c0 * s[2])
                     + db * (b1 * s[1] + c1 * s[2]);
  const float d_c0 = da * (2.f * a0 * s[2] + 2.f * c0 * s[5])
                     + db * (b1 * s[4] + c1 * s[5]);
  const float d_b1 = db * (a0 * s[1] + c0 * s[4])
                     + dc * (2.f * b1 * s[3] + 2.f * c1 * s[4]);
  const float d_c1 = db * (a0 * s[2] + c0 * s[5])
                     + dc * (2.f * b1 * s[4] + 2.f * c1 * s[5]);
  float ds[6];
  ds[0] = da * a0 * a0;
  ds[1] = db * a0 * b1;
  ds[2] = da * 2.f * a0 * c0 + db * a0 * c1;
  ds[3] = dc * b1 * b1;
  ds[4] = db * c0 * b1 + dc * 2.f * b1 * c1;
  ds[5] = da * c0 * c0 + db * c0 * c1 + dc * c1 * c1;
  float d_cov[6];
  for (int e = 0; e < 6; ++e) {
    float acc = 0.f;
    for (int q = 0; q < 6; ++q) acc += ds[q] * cam.quad[6 * e + q];
    d_cov[e] = acc;
  }

  // the Jacobian's terms from the view point t
  const float fx = cam.focal_x, fy = cam.focal_y;
  float d_inv_z = d_a0 * fx + d_b1 * fy;
  const float d_inv_z2 = d_c0 * (-fx * f.txtz) + d_c1 * (-fy * f.tytz);
  const float d_txtz = d_c0 * (-fx) * f.inv_z2;
  const float d_tytz = d_c1 * (-fy) * f.inv_z2;
  d_inv_z += 2.f * f.inv_z * d_inv_z2;
  const float tz = f.t[2];
  float dt[3];
  dt[2] = -d_inv_z * (f.inv_z * f.inv_z);
  // txtz = clamp(u_x, -lim, lim) * tz with u_x = t.x / t.z (tytz alike)
  dt[2] += d_txtz * clampf(f.u_x, -cam.lim_x, cam.lim_x)
           + d_tytz * clampf(f.u_y, -cam.lim_y, cam.lim_y);
  const float du_x = (f.u_x >= -cam.lim_x && f.u_x <= cam.lim_x)
                     ? d_txtz * tz : 0.f;
  const float du_y = (f.u_y >= -cam.lim_y && f.u_y <= cam.lim_y)
                     ? d_tytz * tz : 0.f;
  dt[0] = du_x / tz;
  dt[1] = du_y / tz;
  dt[2] += -du_x * f.t[0] / (tz * tz) - du_y * f.t[1] / (tz * tz);

  if (d.xyz != nullptr) {
    for (int j = 0; j < 3; ++j) {
      float acc = 0.f;
      for (int c = 0; c < 4; ++c) acc += dp[c] * cam.full_proj[4 * j + c];
      for (int c = 0; c < 3; ++c) acc += dt[c] * cam.world_view[4 * j + c];
      d.xyz[3 * k + j] = acc;
    }
  }

  // the rotation matrix's gradient: from the built covariance and from the
  // normal
  float dR[9] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  if (src == COV_BUILT) {
    float dS[3];
    packed_rdr_vjp(rot.r, f.sq, d_cov, dR, dS);
    // S_c = (m s_c)^2
    if (d.scaling != nullptr)
      for (int c = 0; c < 3; ++c)
        d.scaling[3 * k + c] = dS[c] * 2.f * f.sm[c] * cam.scaling_modifier;
  } else if (d.cov != nullptr) {
    float* o = d.cov + (src == COV_PACKED ? 6 : 9) * k;
    if (src == COV_PACKED) {
      for (int e = 0; e < 6; ++e) o[e] = d_cov[e];
    } else {  // strip_symmetric reads the upper triangle only
      o[0] = d_cov[0]; o[1] = d_cov[1]; o[2] = d_cov[2];
      o[3] = 0.f;      o[4] = d_cov[3]; o[5] = d_cov[4];
      o[6] = 0.f;      o[7] = 0.f;      o[8] = d_cov[5];
    }
  }
  const int idx = argmin3(sc);
  const float sign = facing_sign(cam, rot, idx, x, y, z);
  for (int row = 0; row < 3; ++row) dR[3 * row + idx] += g_n[row] * sign;

  if (d.rotation != nullptr)
    rotation_vjp(rot, rotation + 4 * k, dR, d.rotation + 4 * k);

  if (d.opacity != nullptr) {
    const bool visible = f.p[3] > NEAR_CULL && f.det_ok && opacity[k] > 0.f;
    d.opacity[k] = visible ? g_op : 0.f;
  }
}

}  // namespace

// The VJP of project_forward for the same camera and inputs: one launch on
// `stream`, none for n = 0.  *g and *d are host structs passed to the
// kernel by value.  Returns cudaGetLastError() after the launch.
extern "C" int project_backward(const Camera* cam, int n, const void* xyz,
                                const void* scaling, const void* rotation,
                                const void* opacity, const void* cov_in,
                                int cov_src, const Cotangents* g,
                                const Gradients* d, void* stream) {
  if (n < 0 || cov_src < COV_BUILT || cov_src > COV_FULL
      || (cov_src != COV_BUILT && cov_in == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return static_cast<int>(cudaSuccess);
  project_bwd_kernel<<<(n + BLOCK - 1) / BLOCK, BLOCK, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      *cam, n, static_cast<const float*>(xyz),
      static_cast<const float*>(scaling), static_cast<const float*>(rotation),
      static_cast<const float*>(opacity), static_cast<const float*>(cov_in),
      cov_src, *g, *d);
  return static_cast<int>(cudaGetLastError());
}
