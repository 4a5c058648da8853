// Backward of the closest hit (K6) on Hopper (sm_90a), for static and
// moving spheres: four rays a thread, per-sphere sums aggregated per warp.
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
// another order (a tree per warp, then atomics) and agree to a tolerance.
//
// What bounds it: bytes, 60 per ray (ro, rd, t, idx, g_t in and g_ro,
// g_rd out; 68 with the time and g_time). The design keeps the rest off
// that path:
// - Four consecutive rays a thread: their [R, 3] rows are three float4s,
//   so ro, rd, g_ro and g_rd move in 16-byte loads and stores, and t, idx,
//   g_t (and time, g_time) in one each.
// - Same-sphere atomics do not serialise. Every bounce sends a large
//   share of its rays to a few spheres (the 1000-radius ground), so a warp
//   often holds 128 rays on one sphere. A thread first folds its rays
//   that share its first ray's sphere; then, per ray slot, the lanes with
//   the same sphere (__match_any_sync) sum their components in a tree of
//   shuffles, and only the group's lowest lane adds them: one atomic per
//   (warp, distinct sphere, component).
// - Each block sums into shared memory (4 floats a sphere, 9 with motion;
//   opted in past 48 KB, up to the 227 KB a block may hold) and then adds
//   one atomic per (touched sphere, component) into device memory. A block
//   takes a contiguous share of the rays, neighbours on the film, which
//   touch few spheres. The wrapper launches a block per 1024 rays
//   (intersect_kernel.bwd_launch): a persistent grid of two blocks an SM,
//   which zeroes and flushes the sums fewer times, measured slower, since
//   it keeps fewer loads in flight. Scenes whose sums exceed the shared
//   memory the wrapper allows add the warp sums straight into device
//   memory.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRays = 4;  // consecutive rays a thread per step
constexpr unsigned kFull = 0xffffffffu;

struct Leaves {
  const float* center;
  const float* radius;
  const float* delta;
  const float* time0;
  const float* inv_dt;
};

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

// One ray's derivative, operation for operation as autograd evaluates the
// plain version. Writes g_ro, g_rd (and g_time) and the per-sphere
// components; returns the cotangent g (0 on a miss: nothing to add).
template <bool kMoving>
__device__ __forceinline__ float ray_grad(
    const Leaves& s, float rox, float roy, float roz, float rdx, float rdy,
    float rdz, float tm, float t, float g_t, int j, float t_min, float t_max,
    float* g_ro, float* g_rd, float& g_time, float* comp) {
  const float g = (t < t_max) ? g_t : 0.f;
  float cx = s.center[3 * j], cy = s.center[3 * j + 1];
  float cz = s.center[3 * j + 2];
  float dx = 0.f, dy = 0.f, dz = 0.f, dt = 0.f, inv = 0.f, u = 0.f;
  if (kMoving) {
    dx = s.delta[3 * j];
    dy = s.delta[3 * j + 1];
    dz = s.delta[3 * j + 2];
    inv = s.inv_dt[j];
    dt = tm - s.time0[j];
    u = dt * inv;
    cx = cx + dx * u;
    cy = cy + dy * u;
    cz = cz + dz * u;
  }
  const float ocx = rox - cx;
  const float ocy = roy - cy;
  const float ocz = roz - cz;
  const float r = s.radius[j];
  // forward twin of the plain version
  const float b = (ocx * rdx + ocy * rdy) + ocz * rdz;
  const float cq = (ocx * ocx + ocy * ocy) + ocz * ocz - r * r;
  const float disc = b * b - cq;
  const bool pos = disc > 0.f;
  const float sq = sqrtf(pos ? disc : 1.f);
  const float t0 = -b - sq;
  const bool use_t0 = pos && t0 > t_min && t0 < t_max;
  // reverse sweep
  const float g_sq = use_t0 ? -g : g;
  const float g_disc = pos ? g_sq / (2.f * sq) : 0.f;
  const float g_b = g_disc * (2.f * b) + (-g);
  const float g_q = -g_disc;
  const float g_ocx = g_b * rdx + g_q * (2.f * ocx);
  const float g_ocy = g_b * rdy + g_q * (2.f * ocy);
  const float g_ocz = g_b * rdz + g_q * (2.f * ocz);
  g_ro[0] = g_ocx;
  g_ro[1] = g_ocy;
  g_ro[2] = g_ocz;
  g_rd[0] = g_b * ocx;
  g_rd[1] = g_b * ocy;
  g_rd[2] = g_b * ocz;
  // the centre's gradient, and through the lerp the motion terms: the
  // three components of g_u sum in the plain version's stack order
  const float g_cx = -g_ocx, g_cy = -g_ocy, g_cz = -g_ocz;
  comp[0] = g_cx;
  comp[1] = g_cy;
  comp[2] = g_cz;
  comp[3] = g_disc * (2.f * r);
  if (kMoving) {
    const float g_u = (g_cx * dx + g_cy * dy) + g_cz * dz;
    const float g_dt = g_u * inv;
    g_time = g_dt;
    comp[4] = g_cx * u;
    comp[5] = g_cy * u;
    comp[6] = g_cz * u;
    comp[7] = -g_dt;
    comp[8] = g_u * dt;
  }
  return g;
}

// Sums v over the lanes of `peers` (the lanes holding the same key, this
// lane included): a tree in lane order, after which the group's lowest
// lane holds the sum. Every lane of the warp must call it.
template <int kComp>
__device__ __forceinline__ void reduce_peers(unsigned peers, float* v) {
  const int lane = threadIdx.x & 31;
  int rank = __popc(peers & ((1u << lane) - 1u));
  unsigned above = peers & ~((2u << lane) - 1u);
  while (__any_sync(kFull, above != 0u)) {
    const int next = __ffs(above) - 1;
    const int src = next < 0 ? lane : next;
#pragma unroll
    for (int k = 0; k < kComp; ++k) {
      const float x = __shfl_sync(kFull, v[k], src);
      if (next >= 0) v[k] += x;
    }
    // lanes of odd rank have handed their sums down: drop them
    above &= ~__ballot_sync(kFull, rank & 1);
    rank >>= 1;
  }
}

template <bool kShared, bool kMoving>
__global__ void __launch_bounds__(kThreads, 2)
sphere_nearest_bwd_kernel(const float* __restrict__ ro,
                          const float* __restrict__ rd,
                          const float* __restrict__ time,
                          const float* __restrict__ t,
                          const int* __restrict__ idx,
                          const float* __restrict__ g_t, int n_rays,
                          Leaves s, int n_spheres, float t_min, float t_max,
                          float* __restrict__ g_ro, float* __restrict__ g_rd,
                          float* __restrict__ g_time, SphereGrads out) {
  constexpr int kComp = kMoving ? 9 : 4;
  // [kComp][n_spheres]: gcx, gcy, gcz, gr (, gdx, gdy, gdz, gt0, ginv)
  extern __shared__ float s_acc[];
  if (kShared) {
    for (int j = threadIdx.x; j < kComp * n_spheres; j += kThreads) {
      s_acc[j] = 0.f;
    }
    __syncthreads();
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  // this block's quads of rays, a contiguous share, walked 32 quads a
  // warp at a time (the loop bound is uniform across a warp)
  const int n_quads = (n_rays + kRays - 1) / kRays;
  const int share = (n_quads + gridDim.x - 1) / gridDim.x;
  const int lo = blockIdx.x * share;
  const int hi = min(lo + share, n_quads);
  for (int base = lo + warp * 32; base < hi; base += kThreads) {
    const int q = base + lane;
    const int first = q * kRays;
    const int n_here = q < hi ? min(kRays, n_rays - first) : 0;
    float rox[kRays], roy[kRays], roz[kRays], rdx[kRays], rdy[kRays];
    float rdz[kRays], tm[kRays], tt[kRays], gt[kRays];
    int jj[kRays];
    if (n_here == kRays) {  // 16-byte loads
      const float4* ro4 = reinterpret_cast<const float4*>(ro) + 3 * q;
      const float4* rd4 = reinterpret_cast<const float4*>(rd) + 3 * q;
      const float4 a0 = ro4[0], a1 = ro4[1], a2 = ro4[2];
      const float4 d0 = rd4[0], d1 = rd4[1], d2 = rd4[2];
      rox[0] = a0.x; roy[0] = a0.y; roz[0] = a0.z; rox[1] = a0.w;
      roy[1] = a1.x; roz[1] = a1.y; rox[2] = a1.z; roy[2] = a1.w;
      roz[2] = a2.x; rox[3] = a2.y; roy[3] = a2.z; roz[3] = a2.w;
      rdx[0] = d0.x; rdy[0] = d0.y; rdz[0] = d0.z; rdx[1] = d0.w;
      rdy[1] = d1.x; rdz[1] = d1.y; rdx[2] = d1.z; rdy[2] = d1.w;
      rdz[2] = d2.x; rdx[3] = d2.y; rdy[3] = d2.z; rdz[3] = d2.w;
      const float4 t4 = reinterpret_cast<const float4*>(t)[q];
      const float4 g4 = reinterpret_cast<const float4*>(g_t)[q];
      const int4 j4 = reinterpret_cast<const int4*>(idx)[q];
      tt[0] = t4.x; tt[1] = t4.y; tt[2] = t4.z; tt[3] = t4.w;
      gt[0] = g4.x; gt[1] = g4.y; gt[2] = g4.z; gt[3] = g4.w;
      jj[0] = j4.x; jj[1] = j4.y; jj[2] = j4.z; jj[3] = j4.w;
      if (kMoving) {
        const float4 m4 = reinterpret_cast<const float4*>(time)[q];
        tm[0] = m4.x; tm[1] = m4.y; tm[2] = m4.z; tm[3] = m4.w;
      }
    } else {  // the ragged last quad, or no quad
#pragma unroll
      for (int k = 0; k < kRays; ++k) {
        const int i = k < n_here ? first + k : 0;
        rox[k] = ro[3 * i]; roy[k] = ro[3 * i + 1]; roz[k] = ro[3 * i + 2];
        rdx[k] = rd[3 * i]; rdy[k] = rd[3 * i + 1]; rdz[k] = rd[3 * i + 2];
        tt[k] = t[i];
        gt[k] = g_t[i];
        jj[k] = idx[i];
        tm[k] = kMoving ? time[i] : 0.f;
      }
    }
    float oro[3 * kRays], ord[3 * kRays], otm[kRays];
    float comp[kRays][kComp];
    bool adds[kRays];
#pragma unroll
    for (int k = 0; k < kRays; ++k) {
      const float g = ray_grad<kMoving>(
          s, rox[k], roy[k], roz[k], rdx[k], rdy[k], rdz[k], tm[k], tt[k],
          gt[k], jj[k], t_min, t_max, &oro[3 * k], &ord[3 * k], otm[k],
          comp[k]);
      // misses and zero cotangents add nothing
      adds[k] = k < n_here && g != 0.f;
    }
    if (n_here == kRays) {
      float4* gro4 = reinterpret_cast<float4*>(g_ro) + 3 * q;
      float4* grd4 = reinterpret_cast<float4*>(g_rd) + 3 * q;
#pragma unroll
      for (int v = 0; v < 3; ++v) {
        gro4[v] = make_float4(oro[4 * v], oro[4 * v + 1], oro[4 * v + 2],
                              oro[4 * v + 3]);
        grd4[v] = make_float4(ord[4 * v], ord[4 * v + 1], ord[4 * v + 2],
                              ord[4 * v + 3]);
      }
      if (kMoving) {
        reinterpret_cast<float4*>(g_time)[q] =
            make_float4(otm[0], otm[1], otm[2], otm[3]);
      }
    } else {
#pragma unroll
      for (int k = 0; k < kRays; ++k) {
        if (k >= n_here) continue;
        const int i = first + k;
        g_ro[3 * i] = oro[3 * k];
        g_ro[3 * i + 1] = oro[3 * k + 1];
        g_ro[3 * i + 2] = oro[3 * k + 2];
        g_rd[3 * i] = ord[3 * k];
        g_rd[3 * i + 1] = ord[3 * k + 1];
        g_rd[3 * i + 2] = ord[3 * k + 2];
        if (kMoving) g_time[i] = otm[k];
      }
    }
    // fold the thread's rays on its first ray's sphere into that ray's
    // slot (neighbouring rays mostly share a winner)
#pragma unroll
    for (int k = 1; k < kRays; ++k) {
      if (adds[0] && adds[k] && jj[k] == jj[0]) {
#pragma unroll
        for (int c = 0; c < kComp; ++c) comp[0][c] += comp[k][c];
        adds[k] = false;
      }
    }
    // per slot: the warp's lanes on one sphere sum, their lowest lane adds
#pragma unroll
    for (int k = 0; k < kRays; ++k) {
      if (!__any_sync(kFull, adds[k])) continue;
      const int key = adds[k] ? jj[k] : -1 - lane;
      const unsigned peers = __match_any_sync(kFull, key);
      reduce_peers<kComp>(peers, comp[k]);
      if (adds[k] && lane == __ffs(peers) - 1) {
        if (kShared) {
#pragma unroll
          for (int c = 0; c < kComp; ++c) {
            atomicAdd(&s_acc[c * n_spheres + jj[k]], comp[k][c]);
          }
        } else {
          add_sphere<kComp>(out, jj[k], comp[k]);
        }
      }
    }
  }
  if (kShared) {
    __syncthreads();
    for (int j = threadIdx.x; j < n_spheres; j += kThreads) {
      float v[kComp];
      bool touched = false;
#pragma unroll
      for (int c = 0; c < kComp; ++c) {
        v[c] = s_acc[c * n_spheres + j];
        touched = touched || v[c] != 0.f;
      }
      if (touched) add_sphere<kComp>(out, j, v);
    }
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

template <bool kShared, bool kMoving>
int launch_instance(int blocks, const float* ro, const float* rd,
                    const float* time, const float* t, const int* idx,
                    const float* g_t, int n_rays, const Leaves& s,
                    int n_spheres, float t_min, float t_max, float* g_ro,
                    float* g_rd, float* g_time, const SphereGrads& out,
                    cudaStream_t stream) {
  constexpr int kComp = kMoving ? 9 : 4;
  const size_t smem =
      kShared ? kComp * sizeof(float) * static_cast<size_t>(n_spheres) : 0;
  auto kernel = sphere_nearest_bwd_kernel<kShared, kMoving>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<blocks, kThreads, smem, stream>>>(
      ro, rd, time, t, idx, g_t, n_rays, s, n_spheres, t_min, t_max, g_ro,
      g_rd, g_time, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// ro, rd, g_ro, g_rd are contiguous [n_rays, 3]; g_center [n_spheres, 3]
// and g_radius [n_spheres] must be zeroed by the caller. Moving spheres
// pass the rays' time [n_rays], delta [n_spheres, 3], time0 and inv_dt
// [n_spheres], and get g_time [n_rays] and g_delta, g_time0, g_inv_dt
// (zeroed by the caller); static spheres pass NULL for all eight. Every
// per-ray array is 16-byte aligned. `blocks` and `shared` (per-block sums
// in shared memory, else straight into device memory) are the wrapper's
// launch rule (intersect_kernel.bwd_launch).
extern "C" int pt_sphere_nearest_bwd(
    const float* ro, const float* rd, const float* time, const float* t,
    const int* idx, const float* g_t, int n_rays, const float* center,
    const float* delta, const float* time0, const float* inv_dt,
    const float* radius, int n_spheres, float t_min, float t_max,
    float* g_ro, float* g_rd, float* g_time, float* g_center, float* g_delta,
    float* g_time0, float* g_inv_dt, float* g_radius, int blocks, int shared,
    cudaStream_t stream) {
  if (n_rays <= 0) return static_cast<int>(cudaGetLastError());
  const bool moving = time != nullptr;
  if (blocks <= 0 || !aligned16(ro) || !aligned16(rd) || !aligned16(t) ||
      !aligned16(idx) || !aligned16(g_t) || !aligned16(g_ro) ||
      !aligned16(g_rd) ||
      (moving && (!aligned16(time) || !aligned16(g_time)))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Leaves s{center, radius, delta, time0, inv_dt};
  const SphereGrads out{g_center, g_radius, g_delta, g_time0, g_inv_dt};
  if (moving) {
    return (shared ? &launch_instance<true, true>
                   : &launch_instance<false, true>)(
        blocks, ro, rd, time, t, idx, g_t, n_rays, s, n_spheres, t_min,
        t_max, g_ro, g_rd, g_time, out, stream);
  }
  return (shared ? &launch_instance<true, false>
                 : &launch_instance<false, false>)(
      blocks, ro, rd, time, t, idx, g_t, n_rays, s, n_spheres, t_min, t_max,
      g_ro, g_rd, g_time, out, stream);
}
