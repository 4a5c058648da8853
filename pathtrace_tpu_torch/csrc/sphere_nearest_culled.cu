// Closest hit with per-tile AABB culls (Hopper, sm_90a): K4, the flat
// cull, and K5, the two-level cull, instances of one template.
//
// Replaces the TPU kernels pathtrace_tpu/ops/intersect_pallas.py
// _kernel_static_culled (K4) and _kernel_static_culled2 (K5). There a
// 512-ray row skipped a 128-sphere tile when no ray of the row could beat
// its running best inside the tile's box, and K5 first tested a supertile
// box (the union of s_tiles member boxes) once per 4096-ray block. Here the
// skip unit is the warp: each thread owns kRays rays (ray first + k *
// kThreads of its block, as K1 maps them in sphere_nearest.cu; K4 takes 2
// or 1 by the wavefront's width, K5 1, culled_rays_per_thread), every ray
// slab-tests the box against min(best_t, t_max), the warp votes with
// __any_sync over its 32 x kRays rays, and a warp in which no ray wants the
// tile skips its sweep. In K5 a warp that does not want a supertile skips
// all its member tiles, box tests included. An empty tile or supertile
// (all spheres masked; its box inverted, lo > hi) is skipped by the whole
// block before any test. A block stages a tile in shared memory only when
// one of its warps wants it (__syncthreads_or), so a tile that no warp of
// the block wants costs one barrier. Rays past the last do not vote.
//
// The sweep of a tile is K1's, operation for operation and with K1's
// shortcuts (csrc/sphere_nearest.cu): the tile's live slots are staged as
// float4 rows (cx, cy, cz, |c|^2 - r^2) in index order, by a ballot
// compaction that every warp computes from the tile's 128 mask words (so
// staging needs no barrier of its own), with their indices in a side array
// that only a win reads; the sqrt and the root choice run behind one branch
// on "some ray of the thread has disc > 0"; the root is t0 > t_min ? t0 :
// t1, with no t_max test (best_t starts at t_max). Tiles are walked in
// index order with K1's strict `<`, so ties still go to the lowest index
// and the result is bit-identical to K1 on the same rays: a tile is skipped
// only when its box (which holds every sphere of the tile, padded by 1e-3)
// starts no nearer than the ray's best hit so far, so no hit in it could
// win. The box test is the reference's axis_interval and want
// (intersect_pallas.py:138-175), with the 1e-12 / 1e30 reciprocal guard
// and the axis-parallel branch. One deviation: the reference's slab test
// turns an inverted box into the interval (-inf, inf), so it swept every
// padding tile of the two-level layout.
//
// What bounds it: issue slots, as K1. Under -fmad=false a (ray, live
// sphere) pair of a swept tile is its 16 fp32 operations and one compare,
// plus 1 / kRays of a 16-byte broadcast load and of the loop; a ray-box
// test is about 30 operations. Memory is no limit: 24 bytes read and 8
// written per ray, the operand and the boxes through the L2. The culls cut
// the pairs; the box tests and barriers are what they cost. kRays trades
// the cost of a pair against the skip: a warp of 32 x kRays rays skips a
// tile less often than one of 32 (PERF.md).
//
// The optional sweep counter gets one atomic per warp per launch: the
// number of (warp, tile) sweeps the launch ran, the figure the plain
// version reproduces at the same unit to show that the kernel culls as
// designed.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileN = 128;
constexpr int kStageWarps = kTileN / 32;  // warps that stage a tile
static_assert(kStageWarps <= kThreads / 32, "a block stages a whole tile");
constexpr float kEps = 1e-12f;
constexpr float kBig = 1e30f;

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

// A thread's rays: origin, direction, reciprocals and axis-parallel flags,
// the ray's terms of the quadratic and its running best.
template <int kRays>
struct Rays {
  float ox[kRays], oy[kRays], oz[kRays], dx[kRays], dy[kRays], dz[kRays];
  float inv_x[kRays], inv_y[kRays], inv_z[kRays];
  bool par_x[kRays], par_y[kRays], par_z[kRays], live[kRays];
  float ro_d[kRays], ro_ro[kRays], best_t[kRays];
  int best_i[kRays];
};

// Does some live ray of the thread want box k (``want``,
// intersect_pallas.py:169-175)?
template <int kRays>
__device__ __forceinline__ bool any_wants(const float* __restrict__ box,
                                          int n, int k, const Rays<kRays>& r,
                                          float t_min, float t_max) {
  const float lo_x = __ldg(box + k), lo_y = __ldg(box + n + k);
  const float lo_z = __ldg(box + 2 * n + k), hi_x = __ldg(box + 3 * n + k);
  const float hi_y = __ldg(box + 4 * n + k), hi_z = __ldg(box + 5 * n + k);
  bool want = false;
#pragma unroll
  for (int q = 0; q < kRays; ++q) {
    float tnx, txx, tny, txy, tnz, txz;
    axis_interval(lo_x, hi_x, r.ox[q], r.inv_x[q], r.par_x[q], tnx, txx);
    axis_interval(lo_y, hi_y, r.oy[q], r.inv_y[q], r.par_y[q], tny, txy);
    axis_interval(lo_z, hi_z, r.oz[q], r.inv_z[q], r.par_z[q], tnz, txz);
    const float tenter = fmaxf(fmaxf(tnx, tny), tnz);
    const float texit = fminf(fminf(txx, txy), txz);
    want = want || (r.live[q] && (texit >= tenter) && (texit > t_min) &&
                    (tenter < fminf(r.best_t[q], t_max)));
  }
  return want;
}

// kHier: K5 (supertiles of s_tiles member tiles); else K4 (s_tiles unused).
template <bool kHier, int kRays>
__global__ void __launch_bounds__(kThreads)
sphere_nearest_culled_kernel(const float* __restrict__ rays, long long stride,
                             int n_rays, const float* __restrict__ soa,
                             int n_spheres, const float* __restrict__ tiles,
                             int n_tiles, const float* __restrict__ supers,
                             int s_tiles, float t_min, float t_max,
                             float* __restrict__ t_out,
                             int* __restrict__ idx_out,
                             unsigned long long* __restrict__ sweeps) {
  // the wanted tile's live spheres, compacted in index order: cx, cy, cz,
  // |c|^2 - r^2, and their indices
  __shared__ float4 s_sph[kTileN];
  __shared__ int s_idx[kTileN];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int first = blockIdx.x * (kThreads * kRays) + threadIdx.x;
  Rays<kRays> r;
#pragma unroll
  for (int q = 0; q < kRays; ++q) {
    const int i = first + q * kThreads;
    r.live[q] = i < n_rays;
    r.ox[q] = r.oy[q] = r.oz[q] = r.dx[q] = r.dy[q] = r.dz[q] = 0.f;
    if (r.live[q]) {
      r.ox[q] = rays[i];
      r.oy[q] = rays[stride + i];
      r.oz[q] = rays[2 * stride + i];
      r.dx[q] = rays[3 * stride + i];
      r.dy[q] = rays[4 * stride + i];
      r.dz[q] = rays[5 * stride + i];
    }
    r.par_x[q] = fabsf(r.dx[q]) <= kEps;
    r.par_y[q] = fabsf(r.dy[q]) <= kEps;
    r.par_z[q] = fabsf(r.dz[q]) <= kEps;
    r.inv_x[q] = r.par_x[q] ? kBig : 1.0f / r.dx[q];
    r.inv_y[q] = r.par_y[q] ? kBig : 1.0f / r.dy[q];
    r.inv_z[q] = r.par_z[q] ? kBig : 1.0f / r.dz[q];
    r.ro_d[q] = r.ox[q] * r.dx[q] + r.oy[q] * r.dy[q] + r.oz[q] * r.dz[q];
    r.ro_ro[q] = r.ox[q] * r.ox[q] + r.oy[q] * r.oy[q] + r.oz[q] * r.oz[q];
    r.best_t[q] = t_max;
    r.best_i[q] = 0;
  }

  unsigned long long warp_sweeps = 0;
  const int n_inner = kHier ? s_tiles : 1;
  const int n_outer = n_tiles / n_inner;
  for (int s = 0; s < n_outer; ++s) {
    bool warp_super = true;
    if (kHier) {
      if (!box_nonempty(supers, n_outer, s)) continue;  // block-uniform
      warp_super = __any_sync(0xffffffffu,
                              any_wants(supers, n_outer, s, r, t_min, t_max));
      if (!__syncthreads_or(warp_super)) continue;
    }
    for (int m = 0; m < n_inner; ++m) {
      const int tile = s * n_inner + m;
      if (!box_nonempty(tiles, n_tiles, tile)) continue;  // block-uniform
      bool warp_want = false;
      if (warp_super) {  // warp-uniform
        warp_want = __any_sync(
            0xffffffffu, any_wants(tiles, n_tiles, tile, r, t_min, t_max));
      }
      // also the barrier before the tile's shared memory is overwritten
      if (!__syncthreads_or(warp_want)) continue;
      // the tile's live slots: each warp ballots all 128 mask words, so
      // every warp knows the count and each staging warp its offset
      const int base = tile * kTileN;
      const float* mask = soa + 4 * n_spheres + base;
      int n_live = 0, offset = 0;
      unsigned mine = 0;
#pragma unroll
      for (int q = 0; q < kStageWarps; ++q) {
        const unsigned ballot =
            __ballot_sync(0xffffffffu, __ldg(mask + q * 32 + lane) > 0.f);
        if (q < warp) offset += __popc(ballot);
        if (q == warp) mine = ballot;
        n_live += __popc(ballot);
      }
      if (warp < kStageWarps && ((mine >> lane) & 1u)) {
        const int g = base + warp * 32 + lane;
        const int p = offset + __popc(mine & ((1u << lane) - 1u));
        s_sph[p] = make_float4(soa[g], soa[n_spheres + g],
                               soa[2 * n_spheres + g], soa[3 * n_spheres + g]);
        s_idx[p] = g;
      }
      __syncthreads();
      if (!warp_want) continue;
      ++warp_sweeps;
#pragma unroll 2
      for (int j = 0; j < n_live; ++j) {
        const float4 sp = s_sph[j];
        float b[kRays], c[kRays], disc[kRays];
        bool any = false;
#pragma unroll
        for (int q = 0; q < kRays; ++q) {
          b[q] = r.ro_d[q] - (sp.x * r.dx[q] + sp.y * r.dy[q] + sp.z * r.dz[q]);
          c[q] = (r.ro_ro[q] - 2.0f * (sp.x * r.ox[q] + sp.y * r.oy[q] +
                                       sp.z * r.oz[q])) + sp.w;
          disc[q] = b[q] * b[q] - c[q];
          any = any || disc[q] > 0.f;
        }
        if (!any) continue;
#pragma unroll
        for (int q = 0; q < kRays; ++q) {
          if (disc[q] > 0.f) {
            const float sq = sqrtf(disc[q]);
            const float t0 = -b[q] - sq;
            const float t = t0 > t_min ? t0 : -b[q] + sq;
            if (t > t_min && t < r.best_t[q]) {
              r.best_t[q] = t;
              r.best_i[q] = s_idx[j];
            }
          }
        }
      }
    }
  }
#pragma unroll
  for (int q = 0; q < kRays; ++q) {
    if (r.live[q]) {
      const int i = first + q * kThreads;
      t_out[i] = r.best_t[q];
      idx_out[i] = r.best_i[q];
    }
  }
  if (sweeps != nullptr && lane == 0 && warp_sweeps > 0) {
    atomicAdd(sweeps, warp_sweeps);
  }
}

// Rays a thread, measured on the H100 for each kernel and width (PERF.md):
// K4 takes 2 when every SM gets at least 3 blocks of them (202,752 rays on
// 132 SMs), else 1; K5 takes 1 at every width. More rays a thread cost
// less a pair but make the skip unit coarser: on camera rays a warp of
// 128 rays sweeps ~1% more pairs than one of 32, on the scattered rays of
// every later bounce 20-28% more, and the 4-ray instances hold 80-98
// registers (2-3 blocks an SM). 4 rays a thread won only K4's camera rays
// at full width (1 launch of a frame's 11) and lost every frame.
int culled_rays_per_thread(int n_rays, bool hier) {
  if (hier) return 1;
  static int n_sm = 0;
  if (n_sm == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
    if (n_sm <= 0) n_sm = 1;
  }
  return n_rays >= 3LL * n_sm * kThreads * 2 ? 2 : 1;
}

template <bool kHier, int kRays>
void launch(const float* rays, long long stride, int n_rays, const float* soa,
            int n_spheres, const float* tiles, int n_tiles,
            const float* supers, int s_tiles, float t_min, float t_max,
            float* t_out, int* idx_out, unsigned long long* sweeps,
            cudaStream_t stream) {
  const int per_block = kThreads * kRays;
  const int blocks = (n_rays + per_block - 1) / per_block;
  sphere_nearest_culled_kernel<kHier, kRays>
      <<<blocks, kThreads, 0, stream>>>(rays, stride, n_rays, soa, n_spheres,
                                        tiles, n_tiles, supers, s_tiles,
                                        t_min, t_max, t_out, idx_out, sweeps);
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
    if (supers != nullptr) {
      launch<true, 1>(rays, stride, n_rays, soa, n_spheres, tiles, n_tiles,
                      supers, s_tiles, t_min, t_max, t_out, idx_out, sweeps,
                      stream);
    } else if (culled_rays_per_thread(n_rays, false) == 2) {
      launch<false, 2>(rays, stride, n_rays, soa, n_spheres, tiles, n_tiles,
                       nullptr, 1, t_min, t_max, t_out, idx_out, sweeps,
                       stream);
    } else {
      launch<false, 1>(rays, stride, n_rays, soa, n_spheres, tiles, n_tiles,
                       nullptr, 1, t_min, t_max, t_out, idx_out, sweeps,
                       stream);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// The rays a thread pt_sphere_nearest_culled launches n_rays rays with on
// the current device (hier: K5, else K4): the unit of its sweep count is a
// warp's 32 x that many rays.
extern "C" int pt_sphere_nearest_culled_rays(int n_rays, int hier) {
  return culled_rays_per_thread(n_rays, hier != 0);
}
