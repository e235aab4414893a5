// Kernel P: the Gaussian projection of every render (EWA splatting): the
// frustum cull, the projected centre and depth, the dilated screen
// covariance's conic and radius, the culled opacity and the camera-facing
// flat normal, one Gaussian a thread, in one launch.
//
// Replaces no TPU kernel: texgs projects with XLA ops
// (texgs/kernels/project.py, project_gaussians), and so did the port's plain
// PyTorch chain (texgs_torch/kernels/project.py, project_plain), which
// stays as this kernel's plain version.  On the H100 that chain took 336
// device launches a render, the camera's three host-to-device copies and
// their host syncs, ~9 ms of host time and 0.61 device ms at 100,000
// Gaussians: host-bound in every benchmark cell.  This kernel and its
// backward (project_bwd.cu) take one launch each; the camera reaches them
// by value.
//
// Semantics: kernels/project.py's plain chain (project_common.cuh says how
// it is rounded here):
//   cov    = R diag((m s)^2) R^T from scaling s, modifier m and the
//            quaternion renormalised as transforms.rotation_channels does,
//            or the given packed (N, 6) or full (N, 3, 3) covariance;
//   means2d = ndc2pix([xyz, 1] @ full_proj, divided by w + 1e-7, plus the
//            optional NDC offset); depth = the clip w;
//   cov2d  = J W cov W^T J^T + 0.3 I, with t.x / t.z and t.y / t.z clamped
//            to 1.3 tan(fov) in J; conic = its inverse (0 where det = 0);
//   radius = ceil(3 sqrt(lambda1)), lambda1 = mid + sqrt(max(mid^2 - det,
//            0.1)); radius and opacity are 0 where depth <= 0.2, det = 0
//            or opacity <= 0;
//   normal = the rotation's column of the smallest scale (the first of
//            equal ones), times -1 where it faces away from the camera.
// Every output has one writer; no atomics.
//
// Bound on Hopper: bytes, and far below a launch.  A Gaussian reads 44 B
// (xyz, scaling, rotation, opacity; 52 with the NDC offset, 68 or 80 with
// a given covariance) and writes 44 (means2d, depth, conic, radius,
// opacity, normal): 8.8 MB at 100,000 Gaussians, 0.0026 ms at 3.35 TB/s,
// against ~250 f32 operations a Gaussian (25 MFLOP, 0.0004 ms).

#include <cuda_runtime.h>

#include "project_common.cuh"

namespace {

using namespace texgs::proj;

constexpr int BLOCK = 256;

__global__ void __launch_bounds__(BLOCK)
project_kernel(const __grid_constant__ Camera cam, int n,
               const float* __restrict__ xyz,
               const float* __restrict__ scaling,
               const float* __restrict__ rotation,
               const float* __restrict__ opacity,
               const float* __restrict__ cov_in, int cov_src,
               const float* __restrict__ ndc_offset,
               float* __restrict__ means2d, float* __restrict__ depths,
               float* __restrict__ conics, int* __restrict__ radii,
               float* __restrict__ opac_out, float* __restrict__ normals) {
  const int g = blockIdx.x * BLOCK + threadIdx.x;
  if (g >= n) return;
  const long long k = g;  // 64-bit offsets: 4 g passes 2^31 past 536M
  const float x = xyz[3 * k], y = xyz[3 * k + 1], z = xyz[3 * k + 2];
  const float sc[3] = {scaling[3 * k], scaling[3 * k + 1], scaling[3 * k + 2]};
  const Rotation rot = rotation_of(rotation[4 * k], rotation[4 * k + 1],
                                   rotation[4 * k + 2], rotation[4 * k + 3]);
  const CovSource src = static_cast<CovSource>(cov_src);
  const float* cov = src == COV_PACKED ? cov_in + 6 * k
                     : src == COV_FULL ? cov_in + 9 * k
                                       : nullptr;
  const Forward f = forward_of(cam, x, y, z, sc, rot, src, cov);

  float ndc_x = f.ndc_x, ndc_y = f.ndc_y;
  if (ndc_offset != nullptr) {
    ndc_x = add(ndc_x, ndc_offset[2 * k]);
    ndc_y = add(ndc_y, ndc_offset[2 * k + 1]);
  }
  means2d[2 * k] = mul(sub(mul(add(ndc_x, 1.f), cam.width), 1.f), 0.5f);
  means2d[2 * k + 1] = mul(sub(mul(add(ndc_y, 1.f), cam.height), 1.f), 0.5f);
  depths[k] = f.p[3];
  conics[3 * k] = mul(f.c, f.inv_det);
  conics[3 * k + 1] = mul(-f.b, f.inv_det);
  conics[3 * k + 2] = mul(f.a, f.inv_det);

  const float op = opacity[k];
  const bool visible = f.p[3] > NEAR_CULL && f.det_ok && op > 0.f;
  // float -> int32 as the plain chain's .to(torch.int32) converts on the
  // card (a NaN to 0)
  radii[k] = visible ? static_cast<int>(f.radius) : 0;
  opac_out[k] = visible ? op : 0.f;

  const int idx = argmin3(sc);
  const float sign = facing_sign(cam, rot, idx, x, y, z);
  normals[3 * k] = mul(rot.r[idx], sign);
  normals[3 * k + 1] = mul(rot.r[3 + idx], sign);
  normals[3 * k + 2] = mul(rot.r[6 + idx], sign);
}

}  // namespace

// Projects n Gaussians for the camera *cam (a host struct, passed to the
// kernel by value): one launch on `stream`, none for n = 0.  cov_src is a
// CovSource; cov_in and ndc_offset may be null where not given.  Returns
// cudaGetLastError() after the launch.
extern "C" int project_forward(const Camera* cam, int n, const void* xyz,
                               const void* scaling, const void* rotation,
                               const void* opacity, const void* cov_in,
                               int cov_src, const void* ndc_offset,
                               void* means2d, void* depths, void* conics,
                               void* radii, void* opac_out, void* normals,
                               void* stream) {
  if (n < 0 || cov_src < COV_BUILT || cov_src > COV_FULL
      || (cov_src != COV_BUILT && cov_in == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return static_cast<int>(cudaSuccess);
  project_kernel<<<(n + BLOCK - 1) / BLOCK, BLOCK, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      *cam, n, static_cast<const float*>(xyz),
      static_cast<const float*>(scaling), static_cast<const float*>(rotation),
      static_cast<const float*>(opacity), static_cast<const float*>(cov_in),
      cov_src, static_cast<const float*>(ndc_offset),
      static_cast<float*>(means2d), static_cast<float*>(depths),
      static_cast<float*>(conics), static_cast<int*>(radii),
      static_cast<float*>(opac_out), static_cast<float*>(normals));
  return static_cast<int>(cudaGetLastError());
}
