// Backward of the closest hit (K6), one thread per ray (Hopper, sm_90a),
// for static and moving spheres.
//
// Replaces the TPU path's custom VJP of sphere_nearest_pallas
// (pathtrace_tpu/ops/intersect_pallas.py _vjp_bwd / _winner_t): the
// gradient of a min-reduction flows only through the winning sphere, so
// d t / d (sphere leaves, ro, rd, time) is the derivative of the winner's
// root, recomputed from (t, idx) in O(R). On the TPU that ran as XLA
// gathers and an XLA scatter-add; here one kernel does the per-ray
// derivative and the per-sphere sum.
//
// Per ray, with oc = ro - c, b = oc.rd, cq = oc.oc - r^2, disc = b^2 - cq
// and s = sqrt(disc), the chosen root is t = -b - s (near root in the
// window) or t = -b + s, so dt/db = -1 -/+ b/s and dt/dcq = +/- 1/(2s).
// When disc <= 0 the double-where guard of the reference (sqrt of 1
// instead of disc) gives t = -b + 1: dt/db = -1, dt/dcq = 0. A miss
// (t == t_max) gets a zero gradient. Moving spheres (kMoving) first lerp
// the centre to the ray's time, c = c0 + u * delta with
// u = (time - time0) * inv_dt, and carry the centre's gradient on to
// c0, delta, time0, inv_dt and the ray's time.
//
// Numerics: the kernel evaluates the same operations, in the same order,
// as PyTorch's autograd through the plain version
// (intersect_kernel.sphere_nearest_bwd_plain), built with -fmad=false and
// IEEE division and square root, so the per-ray g_ro, g_rd (and g_time)
// equal the plain version's bit for bit. The per-sphere sums are taken in
// another order (atomics) and agree to a tolerance.
//
// What bounds it: bytes (about 64 per ray: ro, rd, t, idx, g_t in and
// g_ro, g_rd out; 72 with the time and g_time) and the per-sphere
// accumulation. Every bounce sends a large share of its rays to the
// 1000-radius ground sphere, so one global atomicAdd per ray would
// serialize on a few addresses. Each block therefore sums into shared
// memory first (4 floats per sphere, 9 for moving spheres: 8 KB or 18 KB
// for 512 spheres), walking many rays per thread (grid-stride), then
// issues one global atomic per (block, touched sphere, component). Scenes
// whose sums exceed the 48 KB a block gets without opting in (3072 static
// spheres, 1365 moving ones) add straight into device memory.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;
// per-block sums live in shared memory while they fit in 48 KB
constexpr size_t kSharedBytes = 48 * 1024;

// per-sphere gradient components: g_center xyz, g_radius, then for moving
// spheres g_delta xyz, g_time0, g_inv_dt
struct SphereGrads {
  float* center;
  float* radius;
  float* delta;
  float* time0;
  float* inv_dt;
};

// adds one sphere's components v[0..kComp) into the per-sphere outputs
template <int kComp>
__device__ __forceinline__ void add_sphere(const SphereGrads& out, int j,
                                           const float* v) {
  atomicAdd(&out.center[3 * j], v[0]);
  atomicAdd(&out.center[3 * j + 1], v[1]);
  atomicAdd(&out.center[3 * j + 2], v[2]);
  atomicAdd(&out.radius[j], v[3]);
  if (kComp == 9) {
    atomicAdd(&out.delta[3 * j], v[4]);
    atomicAdd(&out.delta[3 * j + 1], v[5]);
    atomicAdd(&out.delta[3 * j + 2], v[6]);
    atomicAdd(&out.time0[j], v[7]);
    atomicAdd(&out.inv_dt[j], v[8]);
  }
}

template <bool kShared, bool kMoving>
__global__ void __launch_bounds__(kThreads)
sphere_nearest_bwd_kernel(const float* __restrict__ ro,
                          const float* __restrict__ rd,
                          const float* __restrict__ time,
                          const float* __restrict__ t,
                          const int* __restrict__ idx,
                          const float* __restrict__ g_t, int n_rays,
                          const float* __restrict__ center,
                          const float* __restrict__ delta,
                          const float* __restrict__ time0,
                          const float* __restrict__ inv_dt,
                          const float* __restrict__ radius, int n_spheres,
                          float t_min, float t_max,
                          float* __restrict__ g_ro, float* __restrict__ g_rd,
                          float* __restrict__ g_time, SphereGrads out) {
  constexpr int kComp = kMoving ? 9 : 4;
  // [kComp][n_spheres]: gcx, gcy, gcz, gr (, gdx, gdy, gdz, gt0, ginv)
  extern __shared__ float s_acc[];
  if (kShared) {
    for (int j = threadIdx.x; j < kComp * n_spheres; j += blockDim.x) {
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
    float cx = center[3 * j], cy = center[3 * j + 1], cz = center[3 * j + 2];
    float dx = 0.f, dy = 0.f, dz = 0.f, dt = 0.f, inv = 0.f, u = 0.f;
    if (kMoving) {
      dx = delta[3 * j];
      dy = delta[3 * j + 1];
      dz = delta[3 * j + 2];
      inv = inv_dt[j];
      dt = time[i] - time0[j];
      u = dt * inv;
      cx = cx + dx * u;
      cy = cy + dy * u;
      cz = cz + dz * u;
    }
    const float ocx = rox - cx;
    const float ocy = roy - cy;
    const float ocz = roz - cz;
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
    // the centre's gradient, and through the lerp the motion terms: the
    // three components of g_u sum in the plain version's stack order
    const float g_cx = -g_ocx, g_cy = -g_ocy, g_cz = -g_ocz;
    float g_u = 0.f, g_dt = 0.f;
    if (kMoving) {
      g_u = (g_cx * dx + g_cy * dy) + g_cz * dz;
      g_dt = g_u * inv;
      g_time[i] = g_dt;
    }
    if (g == 0.f) continue;  // misses and zero cotangents add nothing
    float comp[kComp];
    comp[0] = g_cx;
    comp[1] = g_cy;
    comp[2] = g_cz;
    comp[3] = g_r;
    if (kMoving) {
      comp[4] = g_cx * u;
      comp[5] = g_cy * u;
      comp[6] = g_cz * u;
      comp[7] = -g_dt;
      comp[8] = g_u * dt;
    }
    if (kShared) {
#pragma unroll
      for (int k = 0; k < kComp; ++k) {
        atomicAdd(&s_acc[k * n_spheres + j], comp[k]);
      }
    } else {
      add_sphere<kComp>(out, j, comp);
    }
  }
  if (kShared) {
    __syncthreads();
    for (int j = threadIdx.x; j < n_spheres; j += blockDim.x) {
      float v[kComp];
      bool touched = false;
#pragma unroll
      for (int k = 0; k < kComp; ++k) {
        v[k] = s_acc[k * n_spheres + j];
        touched = touched || v[k] != 0.f;
      }
      if (touched) add_sphere<kComp>(out, j, v);
    }
  }
}

template <bool kMoving>
int launch(const float* ro, const float* rd, const float* time,
           const float* t, const int* idx, const float* g_t, int n_rays,
           const float* center, const float* delta, const float* time0,
           const float* inv_dt, const float* radius, int n_spheres,
           float t_min, float t_max, float* g_ro, float* g_rd, float* g_time,
           SphereGrads out, cudaStream_t stream) {
  if (n_rays <= 0) return static_cast<int>(cudaGetLastError());
  int device = 0, sms = 132;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  int blocks = (n_rays + kThreads - 1) / kThreads;
  if (blocks > sms * kBlocksPerSm) blocks = sms * kBlocksPerSm;
  const size_t smem =
      (kMoving ? 9 : 4) * sizeof(float) * static_cast<size_t>(n_spheres);
  if (smem <= kSharedBytes) {
    sphere_nearest_bwd_kernel<true, kMoving>
        <<<blocks, kThreads, smem, stream>>>(
            ro, rd, time, t, idx, g_t, n_rays, center, delta, time0, inv_dt,
            radius, n_spheres, t_min, t_max, g_ro, g_rd, g_time, out);
  } else {
    sphere_nearest_bwd_kernel<false, kMoving><<<blocks, kThreads, 0, stream>>>(
        ro, rd, time, t, idx, g_t, n_rays, center, delta, time0, inv_dt,
        radius, n_spheres, t_min, t_max, g_ro, g_rd, g_time, out);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// ro, rd, g_ro, g_rd are contiguous [n_rays, 3]; g_center [n_spheres, 3]
// and g_radius [n_spheres] must be zeroed by the caller. Moving spheres
// pass the rays' time [n_rays], delta [n_spheres, 3], time0 and inv_dt
// [n_spheres], and get g_time [n_rays] and g_delta, g_time0, g_inv_dt
// (zeroed by the caller); static spheres pass NULL for all eight.
extern "C" int pt_sphere_nearest_bwd(
    const float* ro, const float* rd, const float* time, const float* t,
    const int* idx, const float* g_t, int n_rays, const float* center,
    const float* delta, const float* time0, const float* inv_dt,
    const float* radius, int n_spheres, float t_min, float t_max,
    float* g_ro, float* g_rd, float* g_time, float* g_center, float* g_delta,
    float* g_time0, float* g_inv_dt, float* g_radius, cudaStream_t stream) {
  const SphereGrads out{g_center, g_radius, g_delta, g_time0, g_inv_dt};
  return (time != nullptr ? &launch<true> : &launch<false>)(
      ro, rd, time, t, idx, g_t, n_rays, center, delta, time0, inv_dt, radius,
      n_spheres, t_min, t_max, g_ro, g_rd, g_time, out, stream);
}
