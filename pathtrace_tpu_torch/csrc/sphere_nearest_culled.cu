// Closest hit with per-tile AABB culls, one thread per ray (Hopper, sm_90a):
// K4, the flat cull, and K5, the two-level cull.
//
// Replaces the TPU kernels pathtrace_tpu/ops/intersect_pallas.py
// _kernel_static_culled (K4) and _kernel_static_culled2 (K5). There a
// 512-ray row skipped a 128-sphere tile when no ray of the row could beat
// its running best inside the tile's box, and K5 first tested a supertile
// box (the union of s_tiles member boxes) once per 4096-ray block. Here the
// skip unit is the warp: every ray slab-tests the box against
// min(best_t, t_max), the warp votes with __any_sync, and a warp in which no
// ray wants the tile skips its sweep. In K5 a warp that does not want a
// supertile skips all its member tiles, box tests included. A block stages a
// tile in shared memory only when one of its warps wants it
// (__syncthreads_or), so a tile that no warp of the block wants costs one
// barrier. Threads past the last ray do not vote.
//
// The sweep of a tile is K1's (sphere_nearest.cu) operation for operation,
// tiles walked in index order with K1's strict `<`, so ties still go to the
// lowest index and the result is bit-identical to K1 on the same rays: a
// tile is skipped only when its box (which holds every sphere of the tile,
// padded by 1e-3) starts no nearer than the ray's best hit so far, so no
// hit in it could win. The box test is the reference's axis_interval and
// want (intersect_pallas.py:138-175), with the 1e-12 / 1e30 reciprocal
// guard and the axis-parallel branch. One deviation: an empty tile (all
// spheres masked; its box inverted, lo > hi) is skipped outright. The
// reference's slab test turns an inverted box into the interval
// (-inf, inf), so it swept every padding tile of the two-level layout.
//
// What bounds it: fp32 arithmetic, about 20 operations per ray-sphere pair
// of the tiles swept (32 x 128 pairs per warp sweep) plus about 30 per
// ray-box test, against 32 bytes of device memory per ray. The culls cut
// the pairs; the box tests and barriers are what they cost.
//
// The optional sweep counter gets one atomic per warp per launch: the
// number of (warp, tile) sweeps the launch ran, the figure the plain
// version reproduces to show that the kernel culls as designed.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileN = 128;
constexpr float kEps = 1e-12f;
constexpr float kBig = 1e30f;

struct Ray {
  float ox, oy, oz, dx, dy, dz;
  float inv_x, inv_y, inv_z;
  bool par_x, par_y, par_z;
};

__device__ __forceinline__ void axis_interval(float lo, float hi, float o,
                                              float inv, bool par, float& tn,
                                              float& tx) {
  const float t0 = (lo - o) * inv;
  const float t1 = (hi - o) * inv;
  tn = fminf(t0, t1);
  tx = fmaxf(t0, t1);
  if (par) {  // axis-parallel: inside the slab -> whole line, else empty
    const bool inside = (o >= lo) && (o <= hi);
    tn = inside ? -kBig : kBig;
    tx = inside ? kBig : -kBig;
  }
}

// Box k of a [6, n] table (rows lo x, y, z, hi x, y, z).
__device__ __forceinline__ bool box_nonempty(const float* __restrict__ box,
                                             int n, int k) {
  return __ldg(box + k) <= __ldg(box + 3 * n + k);
}

__device__ __forceinline__ bool box_want(const float* __restrict__ box, int n,
                                         int k, const Ray& r, float best_t,
                                         float t_min, float t_max) {
  float tnx, txx, tny, txy, tnz, txz;
  axis_interval(__ldg(box + k), __ldg(box + 3 * n + k), r.ox, r.inv_x,
                r.par_x, tnx, txx);
  axis_interval(__ldg(box + n + k), __ldg(box + 4 * n + k), r.oy, r.inv_y,
                r.par_y, tny, txy);
  axis_interval(__ldg(box + 2 * n + k), __ldg(box + 5 * n + k), r.oz,
                r.inv_z, r.par_z, tnz, txz);
  const float tenter = fmaxf(fmaxf(tnx, tny), tnz);
  const float texit = fminf(fminf(txx, txy), txz);
  return (texit >= tenter) && (texit > t_min) &&
         (tenter < fminf(best_t, t_max));
}

// kHier: K5 (supertiles of s_tiles member tiles); else K4 (s_tiles unused).
template <bool kHier>
__global__ void __launch_bounds__(kThreads)
sphere_nearest_culled_kernel(const float* __restrict__ rays, long long stride,
                             int n_rays, const float* __restrict__ soa,
                             int n_spheres, const float* __restrict__ tiles,
                             int n_tiles, const float* __restrict__ supers,
                             int s_tiles, float t_min, float t_max,
                             float* __restrict__ t_out,
                             int* __restrict__ idx_out,
                             unsigned long long* __restrict__ sweeps) {
  __shared__ float s_cx[kTileN], s_cy[kTileN], s_cz[kTileN], s_c2[kTileN];
  __shared__ float s_mask[kTileN];

  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = i < n_rays;
  Ray r{};
  if (live) {
    r.ox = rays[i];
    r.oy = rays[stride + i];
    r.oz = rays[2 * stride + i];
    r.dx = rays[3 * stride + i];
    r.dy = rays[4 * stride + i];
    r.dz = rays[5 * stride + i];
  }
  r.inv_x = fabsf(r.dx) > kEps ? 1.0f / r.dx : kBig;
  r.inv_y = fabsf(r.dy) > kEps ? 1.0f / r.dy : kBig;
  r.inv_z = fabsf(r.dz) > kEps ? 1.0f / r.dz : kBig;
  r.par_x = fabsf(r.dx) <= kEps;
  r.par_y = fabsf(r.dy) <= kEps;
  r.par_z = fabsf(r.dz) <= kEps;
  const float ro_d = r.ox * r.dx + r.oy * r.dy + r.oz * r.dz;
  const float ro_ro = r.ox * r.ox + r.oy * r.oy + r.oz * r.oz;

  float best_t = t_max;
  int best_i = 0;
  unsigned long long warp_sweeps = 0;
  const int n_inner = kHier ? s_tiles : 1;
  const int n_outer = n_tiles / n_inner;
  for (int s = 0; s < n_outer; ++s) {
    bool warp_super = true;
    if (kHier) {
      const bool w = live && box_nonempty(supers, n_outer, s) &&
                     box_want(supers, n_outer, s, r, best_t, t_min, t_max);
      warp_super = __any_sync(0xffffffffu, w);
      if (!__syncthreads_or(warp_super)) continue;
    }
    for (int m = 0; m < n_inner; ++m) {
      const int tile = s * n_inner + m;
      bool warp_want = false;
      if (warp_super) {  // warp-uniform
        const bool w = live && box_nonempty(tiles, n_tiles, tile) &&
                       box_want(tiles, n_tiles, tile, r, best_t, t_min, t_max);
        warp_want = __any_sync(0xffffffffu, w);
      }
      // also the barrier before the tile's shared memory is overwritten
      if (!__syncthreads_or(warp_want)) continue;
      const int base = tile * kTileN;
      for (int j = threadIdx.x; j < kTileN; j += blockDim.x) {
        s_cx[j] = soa[base + j];
        s_cy[j] = soa[n_spheres + base + j];
        s_cz[j] = soa[2 * n_spheres + base + j];
        s_c2[j] = soa[3 * n_spheres + base + j];
        s_mask[j] = soa[4 * n_spheres + base + j];
      }
      __syncthreads();
      if (!warp_want) continue;
      ++warp_sweeps;
      if (!live) continue;
      for (int j = 0; j < kTileN; ++j) {
        if (!(s_mask[j] > 0.f)) continue;
        const float cx = s_cx[j], cy = s_cy[j], cz = s_cz[j];
        const float b = ro_d - (cx * r.dx + cy * r.dy + cz * r.dz);
        const float c =
            (ro_ro - 2.0f * (cx * r.ox + cy * r.oy + cz * r.oz)) + s_c2[j];
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
  }
  if (live) {
    t_out[i] = best_t;
    idx_out[i] = best_i;
  }
  if (sweeps != nullptr && (threadIdx.x & 31) == 0 && warp_sweeps > 0) {
    atomicAdd(sweeps, warp_sweeps);
  }
}

}  // namespace

// supers == nullptr: K4 over n_tiles tiles; else K5 over n_tiles / s_tiles
// supertiles. n_spheres = 128 * n_tiles (the operand's row stride).
extern "C" int pt_sphere_nearest_culled(
    const float* rays, long long stride, int n_rays, const float* soa,
    int n_spheres, const float* tiles, int n_tiles, const float* supers,
    int s_tiles, float t_min, float t_max, float* t_out, int* idx_out,
    unsigned long long* sweeps, cudaStream_t stream) {
  if (n_rays > 0) {
    const int blocks = (n_rays + kThreads - 1) / kThreads;
    if (supers == nullptr) {
      sphere_nearest_culled_kernel<false><<<blocks, kThreads, 0, stream>>>(
          rays, stride, n_rays, soa, n_spheres, tiles, n_tiles, nullptr, 1,
          t_min, t_max, t_out, idx_out, sweeps);
    } else {
      sphere_nearest_culled_kernel<true><<<blocks, kThreads, 0, stream>>>(
          rays, stride, n_rays, soa, n_spheres, tiles, n_tiles, supers,
          s_tiles, t_min, t_max, t_out, idx_out, sweeps);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
