// Backward of the closest hit (K6), one thread per ray (Hopper, sm_90a).
//
// Replaces the TPU path's custom VJP of sphere_nearest_pallas
// (pathtrace_tpu/ops/intersect_pallas.py _vjp_bwd / _winner_t): the
// gradient of a min-reduction flows only through the winning sphere, so
// d t / d (center, radius, ro, rd) is the derivative of the winner's root,
// recomputed from (t, idx) in O(R). On the TPU that ran as XLA gathers and
// an XLA scatter-add; here one kernel does the per-ray derivative and the
// per-sphere sum.
//
// Per ray, with oc = ro - c, b = oc.rd, cq = oc.oc - r^2, disc = b^2 - cq
// and s = sqrt(disc), the chosen root is t = -b - s (near root in the
// window) or t = -b + s, so dt/db = -1 -/+ b/s and dt/dcq = +/- 1/(2s).
// When disc <= 0 the double-where guard of the reference (sqrt of 1
// instead of disc) gives t = -b + 1: dt/db = -1, dt/dcq = 0. A miss
// (t == t_max) gets a zero gradient.
//
// Numerics: the kernel evaluates the same operations, in the same order,
// as PyTorch's autograd through the plain version
// (intersect_kernel.sphere_nearest_bwd_plain), built with -fmad=false and
// IEEE division and square root, so the per-ray g_ro and g_rd equal the
// plain version's bit for bit. The per-sphere sums are taken in another
// order (atomics) and agree to a tolerance.
//
// What bounds it: bytes (about 64 per ray: ro, rd, t, idx, g_t in and
// g_ro, g_rd out) and the per-sphere accumulation. Every bounce sends a
// large share of its rays to the 1000-radius ground sphere, so one global
// atomicAdd per ray would serialize on a few addresses. Each block
// therefore sums into shared memory first (4 floats per sphere: 8 KB for
// 512 spheres), walking many rays per thread (grid-stride), then issues
// one global atomic per (block, touched sphere, component). Scenes too
// large for shared memory add straight into device memory.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;
// spheres whose sums fit in shared memory: 4 floats each, 48 KB
constexpr int kSharedSpheres = 3072;

template <bool kShared>
__global__ void __launch_bounds__(kThreads)
sphere_nearest_bwd_kernel(const float* __restrict__ ro,
                          const float* __restrict__ rd,
                          const float* __restrict__ t,
                          const int* __restrict__ idx,
                          const float* __restrict__ g_t, int n_rays,
                          const float* __restrict__ center,
                          const float* __restrict__ radius, int n_spheres,
                          float t_min, float t_max,
                          float* __restrict__ g_ro, float* __restrict__ g_rd,
                          float* __restrict__ g_center,
                          float* __restrict__ g_radius) {
  extern __shared__ float s_acc[];  // [4][n_spheres]: gcx, gcy, gcz, gr
  if (kShared) {
    for (int j = threadIdx.x; j < 4 * n_spheres; j += blockDim.x) {
      s_acc[j] = 0.f;
    }
    __syncthreads();
  }
  const int stride = gridDim.x * blockDim.x;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n_rays;
       i += stride) {
    const float g = (t[i] < t_max) ? g_t[i] : 0.f;
    const int j = idx[i];
    const float rox = ro[3 * i], roy = ro[3 * i + 1], roz = ro[3 * i + 2];
    const float rdx = rd[3 * i], rdy = rd[3 * i + 1], rdz = rd[3 * i + 2];
    const float ocx = rox - center[3 * j];
    const float ocy = roy - center[3 * j + 1];
    const float ocz = roz - center[3 * j + 2];
    const float r = radius[j];
    // forward twin of the plain version
    const float b = (ocx * rdx + ocy * rdy) + ocz * rdz;
    const float cq = (ocx * ocx + ocy * ocy) + ocz * ocz - r * r;
    const float disc = b * b - cq;
    const bool pos = disc > 0.f;
    const float sq = sqrtf(pos ? disc : 1.f);
    const float t0 = -b - sq;
    const bool use_t0 = pos && t0 > t_min && t0 < t_max;
    // reverse sweep, operation for operation as autograd evaluates it
    const float g_sq = use_t0 ? -g : g;
    const float g_disc = pos ? g_sq / (2.f * sq) : 0.f;
    const float g_b = g_disc * (2.f * b) + (-g);
    const float g_q = -g_disc;
    const float g_ocx = g_b * rdx + g_q * (2.f * ocx);
    const float g_ocy = g_b * rdy + g_q * (2.f * ocy);
    const float g_ocz = g_b * rdz + g_q * (2.f * ocz);
    const float g_r = g_disc * (2.f * r);
    g_ro[3 * i] = g_ocx;
    g_ro[3 * i + 1] = g_ocy;
    g_ro[3 * i + 2] = g_ocz;
    g_rd[3 * i] = g_b * ocx;
    g_rd[3 * i + 1] = g_b * ocy;
    g_rd[3 * i + 2] = g_b * ocz;
    if (g == 0.f) continue;  // misses and zero cotangents add nothing
    if (kShared) {
      atomicAdd(&s_acc[j], -g_ocx);
      atomicAdd(&s_acc[n_spheres + j], -g_ocy);
      atomicAdd(&s_acc[2 * n_spheres + j], -g_ocz);
      atomicAdd(&s_acc[3 * n_spheres + j], g_r);
    } else {
      atomicAdd(&g_center[3 * j], -g_ocx);
      atomicAdd(&g_center[3 * j + 1], -g_ocy);
      atomicAdd(&g_center[3 * j + 2], -g_ocz);
      atomicAdd(&g_radius[j], g_r);
    }
  }
  if (kShared) {
    __syncthreads();
    for (int j = threadIdx.x; j < n_spheres; j += blockDim.x) {
      const float gx = s_acc[j], gy = s_acc[n_spheres + j];
      const float gz = s_acc[2 * n_spheres + j];
      const float gr = s_acc[3 * n_spheres + j];
      if (gx != 0.f || gy != 0.f || gz != 0.f || gr != 0.f) {
        atomicAdd(&g_center[3 * j], gx);
        atomicAdd(&g_center[3 * j + 1], gy);
        atomicAdd(&g_center[3 * j + 2], gz);
        atomicAdd(&g_radius[j], gr);
      }
    }
  }
}

}  // namespace

// g_center [n_spheres, 3] and g_radius [n_spheres] must be zeroed by the
// caller; ro, rd, g_ro, g_rd are contiguous [n_rays, 3].
extern "C" int pt_sphere_nearest_bwd(const float* ro, const float* rd,
                                     const float* t, const int* idx,
                                     const float* g_t, int n_rays,
                                     const float* center, const float* radius,
                                     int n_spheres, float t_min, float t_max,
                                     float* g_ro, float* g_rd,
                                     float* g_center, float* g_radius,
                                     cudaStream_t stream) {
  if (n_rays <= 0) return static_cast<int>(cudaGetLastError());
  int device = 0, sms = 132;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  int blocks = (n_rays + kThreads - 1) / kThreads;
  if (blocks > sms * kBlocksPerSm) blocks = sms * kBlocksPerSm;
  if (n_spheres <= kSharedSpheres) {
    const size_t smem = 4 * sizeof(float) * static_cast<size_t>(n_spheres);
    sphere_nearest_bwd_kernel<true><<<blocks, kThreads, smem, stream>>>(
        ro, rd, t, idx, g_t, n_rays, center, radius, n_spheres, t_min, t_max,
        g_ro, g_rd, g_center, g_radius);
  } else {
    sphere_nearest_bwd_kernel<false><<<blocks, kThreads, 0, stream>>>(
        ro, rd, t, idx, g_t, n_rays, center, radius, n_spheres, t_min, t_max,
        g_ro, g_rd, g_center, g_radius);
  }
  return static_cast<int>(cudaGetLastError());
}
