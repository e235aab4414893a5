// Kernel B: the stage-3 texture term, sum over slots of C0 * w * tex(dir),
// for every pixel's M-list.
//
// Replaces the TPU kernel texgs/kernels/pallas_textile.py:568 (_fwd_kernel
// of textile_apply, :774, launched at :799; entry tex_term_textile, :988).
// It computes the exact function of texgs/kernels/uvtex_raster.py:385
// mlist_tex_term, whose port is the plain PyTorch version
// (texgs_torch/kernels/tex_term.py, mlist_tex_term).
//
// Design.  One thread per M-list slot: the threads run flat over the
// (n_tiles, 256, m) slots, slot fastest, as kernel B' does, so a warp
// reads its 32 slots as 512 contiguous bytes (at m = 32 a warp is one
// pixel).  A thread whose slot is live (w != 0) samples the
// (6, R, R, 3) cubemap at the slot's direction: 4 bilinear taps (1 at
// 'nearest'), each a 12-byte texel read straight from device memory
// through L2.  A tap past a face edge is re-resolved through its 3D
// direction onto the adjacent face, and a tap past a cube corner averages
// the 3 texels that meet there (cube_tap; texgs/kernels/cubemap.py:111-
// 153).  A dead slot adds zero by a select, so nothing read from its uv
// (a NaN, say) reaches the sum.  The slots' w * tex are summed over each
// pixel's lanes of the warp by a segmented shuffle reduction; a block
// holds whole pixels (BLOCK / m of them, or one of m > BLOCK slots), and
// one thread a pixel adds the partial sums of the warps its pixel spans,
// in warp order, from shared memory, then writes C0 * sum.  The sums are
// deterministic.  The parent design ran one thread a pixel over its m
// slots: a warp read 32 slots 512 bytes apart, and ran as long as its
// longest list (57% of the flagship's slots are dead).  The TPU kernel
// worked over VMEM windows, a mip atlas and a 16^2 catch-all pack because
// TPU gathers are slow, and those approximate this function; here every
// tap is fetched exactly, so nothing can miss.
//
// Bound on Hopper: bytes.  The M-list read (m * 16 bytes a pixel) and the
// texels touched dominate; a live slot costs about 300 f32 operations.  The
// coordinate arithmetic that picks a texel uses explicitly rounded
// intrinsics (__fmul_rn, __fadd_rn), so the compiler cannot contract it
// into FMAs and pick a different texel than the plain version at a
// boundary.

#include <cuda_runtime.h>

#include "cubemap_taps.cuh"

namespace {

using namespace texgs;

constexpr int TILE = 16;
constexpr int PIX = TILE * TILE;
constexpr int BLOCK = 256;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float3 texel(const float* __restrict__ tex,
                                        int at) {
  const float* p = tex + static_cast<size_t>(at) * 3;
  return make_float3(__ldg(p), __ldg(p + 1), __ldg(p + 2));
}

// One bilinear tap: its texel, or the average of a cube corner's three.
__device__ __forceinline__ float3 cube_tap(const float* __restrict__ tex,
                                           int res, float lim, bool seamless,
                                           int face, float xi, float yi) {
  int idx[3];
  if (tap_texels(res, lim, seamless, face, xi, yi, idx) == 1)
    return texel(tex, idx[0]);
  const float3 p = texel(tex, idx[0]), q = texel(tex, idx[1]),
               r = texel(tex, idx[2]);
  return make_float3(__fdiv_rn(p.x + q.x + r.x, 3.f),
                     __fdiv_rn(p.y + q.y + r.y, 3.f),
                     __fdiv_rn(p.z + q.z + r.z, 3.f));
}

// cubemap.sample_cubemap for one direction
__device__ __forceinline__ float3 sample_cube(const float* __restrict__ tex,
                                              int res, float lim, int mode,
                                              float dx, float dy, float dz) {
  if (mode == NEAREST) {
    int face;
    float u, v;
    dir_to_face_uv(dx, dy, dz, face, u, v);
    return texel(tex, texel_at(res, face, texel_index(v, res),
                               texel_index(u, res)));
  }
  const Footprint fp = footprint(res, dx, dy, dz);
  const bool seamless = mode == BILINEAR;
  const float3 t00 = cube_tap(tex, res, lim, seamless, fp.face, fp.x0, fp.y0);
  const float3 t10 =
      cube_tap(tex, res, lim, seamless, fp.face, fp.x0 + 1.f, fp.y0);
  const float3 t01 =
      cube_tap(tex, res, lim, seamless, fp.face, fp.x0, fp.y0 + 1.f);
  const float3 t11 =
      cube_tap(tex, res, lim, seamless, fp.face, fp.x0 + 1.f, fp.y0 + 1.f);
  const float wx = fp.wx, wy = fp.wy;
  const float ax = 1.f - wx, ay = 1.f - wy;
  const float3 top = make_float3(t00.x * ax + t10.x * wx,
                                 t00.y * ax + t10.y * wx,
                                 t00.z * ax + t10.z * wx);
  const float3 bot = make_float3(t01.x * ax + t11.x * wx,
                                 t01.y * ax + t11.y * wx,
                                 t01.z * ax + t11.z * wx);
  return make_float3(top.x * ay + bot.x * wy, top.y * ay + bot.y * wy,
                     top.z * ay + bot.z * wy);
}

// Block b holds pixels [b * ppb, (b + 1) * ppb) of the n_pix, and walks
// their slots BLOCK at a time.  Asked to fit 6 blocks an SM (at most 40
// registers, no spills; 58 unbounded, 4 blocks): the taps' loads are the
// latency to hide, and more warps in flight hide more of it.
__global__ void __launch_bounds__(BLOCK, 6)
    tex_term_forward(const float4* __restrict__ mlist,
                     const float* __restrict__ tex, int res, float lim,
                     int mode, int m, int ppb, int n_pix, int gx, int height,
                     int width, float* __restrict__ out) {
  __shared__ float s_part[BLOCK][3];  // each warp segment's sum, at its head
  const int tid = threadIdx.x, lane = tid & 31;
  const int p0 = blockIdx.x * ppb;
  const int n_own = min(ppb, n_pix - p0);
  const long long s0 = static_cast<long long>(p0) * m;
  const long long s1 = s0 + static_cast<long long>(n_own) * m;
  float3 sum = make_float3(0.f, 0.f, 0.f);  // pixel p0 + tid's, tid < n_own

  for (long long base = s0; base < s1; base += BLOCK) {
    const long long s = base + tid;
    float3 c = make_float3(0.f, 0.f, 0.f);
    int rest = 0;  // slots of this slot's pixel after it
    bool head = lane == 0;
    if (s < s1) {
      // s - s0 < max(BLOCK, m): the slot's place in its pixel in int math
      const int k = (static_cast<int>(base - s0) + tid) % m;
      rest = m - 1 - k;
      head = head || k == 0;
      const float4 e = mlist[s];
      if (e.x != 0.f) {  // w = 0 adds 0 * tex: selected away, never summed
        const float3 t = sample_cube(tex, res, lim, mode, e.y, e.z, e.w);
        c = make_float3(e.x * t.x, e.x * t.y, e.x * t.z);
      }
    }
    // segmented sum over each pixel's run of lanes: lane l ends with the
    // sum of its slot and the later slots of its pixel in this warp
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float x = __shfl_down_sync(FULL, c.x, off);
      const float y = __shfl_down_sync(FULL, c.y, off);
      const float z = __shfl_down_sync(FULL, c.z, off);
      if (off <= rest && lane + off < 32) {
        c.x += x;
        c.y += y;
        c.z += z;
      }
    }
    if (head) {
      s_part[tid][0] = c.x;
      s_part[tid][1] = c.y;
      s_part[tid][2] = c.z;
    }
    __syncthreads();
    if (tid < n_own) {
      // the heads of pixel p0 + tid's slots in this round: its first slot
      // here, then each warp start inside its run
      const long long first = s0 + static_cast<long long>(tid) * m;
      const int lo = static_cast<int>(max(first, base) - base);
      const int hi = static_cast<int>(
          min(first + m, base + BLOCK) - base);
      for (int h = lo; h < hi; h = (h & ~31) + 32) {
        sum.x += s_part[h][0];
        sum.y += s_part[h][1];
        sum.z += s_part[h][2];
      }
    }
    __syncthreads();
  }

  if (tid < n_own) {
    const int pix = p0 + tid;
    const int tile = pix / PIX, t = pix % PIX;
    const int y = (tile / gx) * TILE + t / TILE;
    const int x = (tile % gx) * TILE + t % TILE;
    if (y < height && x < width) {
      const size_t plane = static_cast<size_t>(height) * width;
      const size_t at = static_cast<size_t>(y) * width + x;
      out[at] = C0 * sum.x;
      out[plane + at] = C0 * sum.y;
      out[2 * plane + at] = C0 * sum.z;
    }
  }
}

void launch(const float4* mlist, const float* tex, int res, float lim,
            int mode, int n_tiles, int m, int gx, int height, int width,
            float* out, cudaStream_t stream) {
  const int n_pix = n_tiles * PIX;
  const int ppb = max(1, BLOCK / m);
  tex_term_forward<<<(n_pix + ppb - 1) / ppb, BLOCK, 0, stream>>>(
      mlist, tex, res, lim, mode, m, ppb, n_pix, gx, height, width, out);
}

}  // namespace

// (3, height, width) texture term of the (n_tiles, 256, m, 4) M-lists over
// the (6, res, res, 3) cubemap.  mode: 0 bilinear (seamless), 1 bilinear
// clamped at face edges, 2 nearest.  Returns the launch's
// cudaGetLastError().
extern "C" int tex_term_forward(const void* mlist, const void* texture,
                                int res, int mode, int n_tiles, int m, int gx,
                                int height, int width, void* out,
                                void* stream) {
  if (n_tiles <= 0) return 0;
  if (m <= 0 || res <= 0 || mode < BILINEAR || mode > NEAREST)
    return static_cast<int>(cudaErrorInvalidValue);
  const float lim = static_cast<float>(1.0 - 1.0 / res);
  launch(static_cast<const float4*>(mlist), static_cast<const float*>(texture),
         res, lim, mode, n_tiles, m, gx, height, width,
         static_cast<float*>(out), static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}
