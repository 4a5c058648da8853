// Closest hit over every sphere, one thread per ray (Hopper, sm_90a).
//
// Replaces the TPU kernel pathtrace_tpu/ops/intersect_pallas.py
// _kernel_static. There a grid step swept a [128 spheres x 512 rays] tile
// on the vector unit and carried the running (t, idx) across sphere tiles
// in the revisited output block. Here each thread owns one ray: it keeps
// the ray and its running (t, idx) in registers and walks the spheres in
// increasing index with a strict `<`, which reproduces the TPU's tie rule
// (first index of the minimum). The sphere operand, 5 floats per sphere,
// streams through shared memory in tiles of kTile spheres; every thread
// of a block reads the same sphere at once, a broadcast with no bank
// conflicts. The random_spheres scene (512 padded spheres, 10 KB) fits in
// one tile.
//
// What bounds it: fp32 arithmetic, about 20 flops per ray-sphere pair
// (R x N x 20 per bounce), against 32 bytes of device memory per ray.
//
// Numerics: built with -fmad=false and IEEE sqrt, so every operation
// rounds exactly as the plain PyTorch version's (same operation order:
// b = ro.d - (cx*dx + cy*dy + cz*dz),
// c = (|ro|^2 - 2*(cx*ox + cy*oy + cz*oz)) + cc_m_r2); the two agree bit
// for bit. Masked spheres are skipped by their mask, not by the far-away
// padding values.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 512;

__global__ void __launch_bounds__(kThreads)
sphere_nearest_kernel(const float* __restrict__ rays, long long stride,
                      int n_rays, const float* __restrict__ soa,
                      int n_spheres, float t_min, float t_max,
                      float* __restrict__ t_out, int* __restrict__ idx_out) {
  __shared__ float s_cx[kTile], s_cy[kTile], s_cz[kTile], s_c2[kTile];
  __shared__ float s_mask[kTile];

  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = i < n_rays;
  float ox = 0.f, oy = 0.f, oz = 0.f, dx = 0.f, dy = 0.f, dz = 0.f;
  if (live) {
    ox = rays[i];
    oy = rays[stride + i];
    oz = rays[2 * stride + i];
    dx = rays[3 * stride + i];
    dy = rays[4 * stride + i];
    dz = rays[5 * stride + i];
  }
  const float ro_d = ox * dx + oy * dy + oz * dz;
  const float ro_ro = ox * ox + oy * oy + oz * oz;

  float best_t = t_max;
  int best_i = 0;
  for (int base = 0; base < n_spheres; base += kTile) {
    const int count = min(kTile, n_spheres - base);
    __syncthreads();
    for (int j = threadIdx.x; j < count; j += blockDim.x) {
      s_cx[j] = soa[base + j];
      s_cy[j] = soa[n_spheres + base + j];
      s_cz[j] = soa[2 * n_spheres + base + j];
      s_c2[j] = soa[3 * n_spheres + base + j];
      s_mask[j] = soa[4 * n_spheres + base + j];
    }
    __syncthreads();
    if (!live) continue;
    for (int j = 0; j < count; ++j) {
      if (!(s_mask[j] > 0.f)) continue;
      const float cx = s_cx[j], cy = s_cy[j], cz = s_cz[j];
      const float b = ro_d - (cx * dx + cy * dy + cz * dz);
      const float c = (ro_ro - 2.0f * (cx * ox + cy * oy + cz * oz)) + s_c2[j];
      const float disc = b * b - c;
      if (!(disc > 0.f)) continue;
      const float sq = sqrtf(disc);
      const float t0 = -b - sq;
      const float t1 = -b + sq;
      float t = t_max;
      if (t0 > t_min && t0 < t_max) {
        t = t0;
      } else if (t1 > t_min && t1 < t_max) {
        t = t1;
      }
      if (t < best_t) {
        best_t = t;
        best_i = base + j;
      }
    }
  }
  if (live) {
    t_out[i] = best_t;
    idx_out[i] = best_i;
  }
}

}  // namespace

extern "C" int pt_sphere_nearest(const float* rays, long long stride,
                                 int n_rays, const float* soa, int n_spheres,
                                 float t_min, float t_max, float* t_out,
                                 int* idx_out, cudaStream_t stream) {
  if (n_rays > 0) {
    const int blocks = (n_rays + kThreads - 1) / kThreads;
    sphere_nearest_kernel<<<blocks, kThreads, 0, stream>>>(
        rays, stride, n_rays, soa, n_spheres, t_min, t_max, t_out, idx_out);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* pt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
