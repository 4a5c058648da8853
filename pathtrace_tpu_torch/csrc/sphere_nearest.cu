// Closest hit over every sphere (Hopper, sm_90a): K1 (static spheres) and
// K3 (moving spheres), instances of one template.
//
// Replaces the TPU kernels pathtrace_tpu/ops/intersect_pallas.py
// _kernel_static (K1) and _kernel_moving (K3). There a grid step swept a
// [128 spheres x 512 rays] tile on the vector unit and carried the running
// (t, idx) across sphere tiles in the revisited output block. Here each
// thread owns kRays rays (4 on a wide wavefront, fewer on a narrow one): it
// keeps them and their running (t, idx) in registers and walks the spheres
// in increasing index with a strict `<`, which reproduces the TPU's tie
// rule (first index of the minimum) per ray, across tiles too.
//
// What bounds it on this card: issue slots. The build keeps -fmad=false
// (every + - * rounds on its own, as in the plain version), so the 16
// additions and multiplications of a ray-sphere pair (K1; 38 for K3) are
// 16 instructions, and an SM sub-partition issues one warp instruction a
// clock: half the fp32 peak, which counts an FMA as two operations.
// Memory is no limit: 24 bytes read (28 with the time) and 8 written per
// ray, the sphere operand once per block through the L2.
//
// What the design does about it: it spends as few issue slots a pair
// beyond that arithmetic as it can.
// - Only live spheres are staged: each tile's slots are compacted in
//   index order (a warp ballot and a block-wide count per pass), so a
//   masked slot costs no issue slot in the sweep. simple_light has 3 live
//   spheres in 128 slots, the cover scenes 488 in 512.
// - A staged sphere is one float4 (cx, cy, cz, |c|^2 - r^2), read with one
//   16-byte broadcast load that serves all kRays rays of the thread; K3's
//   seven motion floats take two more float4 rows. Its index sits in a
//   separate array that only a winning pair reads.
// - A pair costs its arithmetic and one compare that ORs disc > 0 into a
//   per-thread flag; the sqrt and the root choice run behind one branch
//   on that flag, which a warp takes in ~1% of its (warp, sphere) steps on
//   the cover scenes' camera rays and ~4% on their scattered rays
//   (tools/nearest_bench.py, PERF.md).
// - The root choice needs no t_max test: t0 <= t1 (RN is monotone), and a
//   root wins only below the running best, which never exceeds t_max. So
//   t = (t0 > t_min) ? t0 : t1, and it wins iff t > t_min and t < best.
// - K3 skips the motion terms on a static slot (delta = 0, inv_dt = 0,
//   c.delta = 0, |delta|^2 = 0, |time0| <= 1e30), a branch that is uniform
//   across the block. On it every motion term is +-0 when the ray's
//   origin, direction and time are finite (|time| <= 1e30), so b and c keep
//   their values up to the sign of a zero, b*b - c is unchanged, and so is
//   t, since disc > 0 makes sq > 0. A block with any ray outside those
//   bounds takes the motion terms on every slot.
// - The operand is staged once per block of kThreads * kRays rays: 4x
//   fewer L2 reads than one ray a thread.
//
// K3 lerps each centre to the ray's time, c = c0 + s * delta with
// s = (time - time0) * inv_dt, in the reference's expanded form over the
// precomputed c0.delta and |delta|^2:
//   b = (ro.d - c0.d) - s * (delta.d)
//   c = ((((|ro|^2 - 2 c0.ro) + (|c0|^2 - r^2)) - 2 s (delta.ro))
//        + 2 s (c0.delta)) + s^2 |delta|^2
//
// Numerics: built with -fmad=false and IEEE sqrt, every operation rounds
// exactly as the plain PyTorch version's (same operation order), so the
// two agree bit for bit (t and idx).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 512;  // sphere slots staged per pass
constexpr int kWarps = kThreads / 32;
constexpr int kPer = kTile / kThreads;  // slots a thread stages per pass
static_assert(kTile % kThreads == 0, "a pass stages whole rounds of slots");
constexpr float kTimeBound = 1e30f;

__device__ __forceinline__ bool finite3(float x, float y, float z) {
  return isfinite(x) && isfinite(y) && isfinite(z);
}

// operand rows: cx, cy, cz, |c|^2 - r^2, mask (K1); K3 adds
// dx, dy, dz, time0, inv_dt, c.delta, |delta|^2
template <bool kMoving, int kRays>
__global__ void __launch_bounds__(kThreads)
sphere_nearest_kernel(const float* __restrict__ rays, long long stride,
                      const float* __restrict__ time, int n_rays,
                      const float* __restrict__ soa, int n_spheres,
                      float t_min, float t_max, float* __restrict__ t_out,
                      int* __restrict__ idx_out) {
  // the tile's live spheres, compacted in index order: cx, cy, cz,
  // |c|^2 - r^2, and their indices
  __shared__ float4 s_sph[kTile];
  __shared__ int s_idx[kTile];
  // (dx, dy, dz, time0), (inv_dt, c.delta, |delta|^2, 1 moving / 0 static)
  __shared__ float4 s_mov[kMoving ? 2 : 1][kMoving ? kTile : 1];
  // live slots per (pass, warp) of the staging ballot
  __shared__ int s_count[kPer * kWarps];

  const int first = blockIdx.x * (kThreads * kRays) + threadIdx.x;
  float ox[kRays], oy[kRays], oz[kRays], dx[kRays], dy[kRays], dz[kRays];
  float tm[kRays], ro_d[kRays], ro_ro[kRays], best_t[kRays];
  int best_i[kRays];
  bool finite = true;
#pragma unroll
  for (int k = 0; k < kRays; ++k) {
    const int i = first + k * kThreads;
    ox[k] = oy[k] = oz[k] = dx[k] = dy[k] = dz[k] = tm[k] = 0.f;
    if (i < n_rays) {
      ox[k] = rays[i];
      oy[k] = rays[stride + i];
      oz[k] = rays[2 * stride + i];
      dx[k] = rays[3 * stride + i];
      dy[k] = rays[4 * stride + i];
      dz[k] = rays[5 * stride + i];
      if (kMoving) tm[k] = time[i];
    }
    ro_d[k] = ox[k] * dx[k] + oy[k] * dy[k] + oz[k] * dz[k];
    ro_ro[k] = ox[k] * ox[k] + oy[k] * oy[k] + oz[k] * oz[k];
    best_t[k] = t_max;
    best_i[k] = 0;
    if (kMoving) {
      finite = finite && finite3(ox[k], oy[k], oz[k]) &&
               finite3(dx[k], dy[k], dz[k]) && fabsf(tm[k]) <= kTimeBound;
    }
  }
  // block-uniform: may static slots skip the motion terms?
  const bool static_ok = kMoving ? __syncthreads_and(finite) != 0 : false;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int base = 0; base < n_spheres; base += kTile) {
    const int count = min(kTile, n_spheres - base);
    __syncthreads();  // the previous tile's sweep is done
    // slot r * kThreads + threadIdx.x: its rank among the live slots of its
    // warp's ballot, and that ballot's count
    bool live[kPer];
    int rank[kPer];
#pragma unroll
    for (int r = 0; r < kPer; ++r) {
      const int j = r * kThreads + threadIdx.x;
      live[r] = j < count && soa[4 * n_spheres + base + j] > 0.f;
      const unsigned ballot = __ballot_sync(0xffffffffu, live[r]);
      rank[r] = __popc(ballot & ((1u << lane) - 1u));
      if (lane == 0) s_count[r * kWarps + warp] = __popc(ballot);
    }
    __syncthreads();
    // stable compaction: a slot's place is the live slots before it
    int n_live = 0;
    int offset[kPer];
#pragma unroll
    for (int r = 0; r < kPer; ++r) offset[r] = rank[r];
#pragma unroll
    for (int q = 0; q < kPer * kWarps; ++q) {
      const int n = s_count[q];
#pragma unroll
      for (int r = 0; r < kPer; ++r) {
        if (q < r * kWarps + warp) offset[r] += n;
      }
      n_live += n;
    }
#pragma unroll
    for (int r = 0; r < kPer; ++r) {
      if (!live[r]) continue;
      const int g = base + r * kThreads + threadIdx.x;
      const int p = offset[r];
      s_sph[p] = make_float4(soa[g], soa[n_spheres + g],
                             soa[2 * n_spheres + g], soa[3 * n_spheres + g]);
      s_idx[p] = g;
      if (kMoving) {
        const float mx = soa[5 * n_spheres + g];
        const float my = soa[6 * n_spheres + g];
        const float mz = soa[7 * n_spheres + g];
        const float time0 = soa[8 * n_spheres + g];
        const float inv_dt = soa[9 * n_spheres + g];
        const float c_dot_d = soa[10 * n_spheres + g];
        const float d2 = soa[11 * n_spheres + g];
        const bool fixed = mx == 0.f && my == 0.f && mz == 0.f &&
                           inv_dt == 0.f && c_dot_d == 0.f && d2 == 0.f &&
                           fabsf(time0) <= kTimeBound;
        s_mov[0][p] = make_float4(mx, my, mz, time0);
        s_mov[1][p] = make_float4(inv_dt, c_dot_d, d2, fixed ? 0.f : 1.f);
      }
    }
    __syncthreads();
#pragma unroll 2
    for (int j = 0; j < n_live; ++j) {
      const float4 sp = s_sph[j];
      float b[kRays], c[kRays], disc[kRays];
#pragma unroll
      for (int k = 0; k < kRays; ++k) {
        b[k] = ro_d[k] - (sp.x * dx[k] + sp.y * dy[k] + sp.z * dz[k]);
        c[k] = (ro_ro[k] - 2.0f * (sp.x * ox[k] + sp.y * oy[k] +
                                   sp.z * oz[k])) + sp.w;
      }
      if (kMoving) {
        const float4 m1 = s_mov[1][j];
        if (m1.w != 0.f || !static_ok) {
          const float4 m0 = s_mov[0][j];
#pragma unroll
          for (int k = 0; k < kRays; ++k) {
            const float s = (tm[k] - m0.w) * m1.x;
            const float dd_rd = m0.x * dx[k] + m0.y * dy[k] + m0.z * dz[k];
            const float dd_ro = m0.x * ox[k] + m0.y * oy[k] + m0.z * oz[k];
            b[k] = b[k] - s * dd_rd;
            c[k] = ((c[k] - 2.0f * s * dd_ro) + 2.0f * s * m1.y) +
                   s * s * m1.z;
          }
        }
      }
      bool any = false;
#pragma unroll
      for (int k = 0; k < kRays; ++k) {
        disc[k] = b[k] * b[k] - c[k];
        any = any || disc[k] > 0.f;
      }
      if (!any) continue;
#pragma unroll
      for (int k = 0; k < kRays; ++k) {
        if (disc[k] > 0.f) {
          const float sq = sqrtf(disc[k]);
          const float t0 = -b[k] - sq;
          const float t = t0 > t_min ? t0 : -b[k] + sq;
          if (t > t_min && t < best_t[k]) {
            best_t[k] = t;
            best_i[k] = s_idx[j];
          }
        }
      }
    }
  }
#pragma unroll
  for (int k = 0; k < kRays; ++k) {
    const int i = first + k * kThreads;
    if (i < n_rays) {
      t_out[i] = best_t[k];
      idx_out[i] = best_i[k];
    }
  }
}

// Rays a thread: the most (4, 2, 1) that still gives the SMs 1.5 blocks
// each on average. Four rays a thread issue the fewest slots a pair, but
// an SM that holds only one or two blocks of them cannot hide the shared
// loads' latency, and the late bounces of the ladder are that narrow. On
// the H100 (132 SMs) the choice switches at 101,376 and 202,752 rays,
// where the times of the three instances cross (PERF.md).
int rays_per_thread(int n_rays) {
  static int n_sm = 0;
  if (n_sm == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
    if (n_sm <= 0) n_sm = 1;
  }
  for (int k = 4; k > 1; k /= 2) {
    if (2LL * n_rays >= 3LL * n_sm * kThreads * k) return k;
  }
  return 1;
}

template <bool kMoving, int kRays>
void launch(const float* rays, long long stride, const float* time,
            int n_rays, const float* soa, int n_spheres, float t_min,
            float t_max, float* t_out, int* idx_out, cudaStream_t stream) {
  const int per_block = kThreads * kRays;
  const int blocks = (n_rays + per_block - 1) / per_block;
  sphere_nearest_kernel<kMoving, kRays><<<blocks, kThreads, 0, stream>>>(
      rays, stride, time, n_rays, soa, n_spheres, t_min, t_max, t_out,
      idx_out);
}

template <bool kMoving>
void launch_any(const float* rays, long long stride, const float* time,
                int n_rays, const float* soa, int n_spheres, float t_min,
                float t_max, float* t_out, int* idx_out,
                cudaStream_t stream) {
  switch (rays_per_thread(n_rays)) {
    case 4:
      launch<kMoving, 4>(rays, stride, time, n_rays, soa, n_spheres, t_min,
                         t_max, t_out, idx_out, stream);
      break;
    case 2:
      launch<kMoving, 2>(rays, stride, time, n_rays, soa, n_spheres, t_min,
                         t_max, t_out, idx_out, stream);
      break;
    default:
      launch<kMoving, 1>(rays, stride, time, n_rays, soa, n_spheres, t_min,
                         t_max, t_out, idx_out, stream);
  }
}

}  // namespace

extern "C" int pt_sphere_nearest(const float* rays, long long stride,
                                 int n_rays, const float* soa, int n_spheres,
                                 float t_min, float t_max, float* t_out,
                                 int* idx_out, cudaStream_t stream) {
  if (n_rays > 0) {
    launch_any<false>(rays, stride, nullptr, n_rays, soa, n_spheres, t_min,
                      t_max, t_out, idx_out, stream);
  }
  return static_cast<int>(cudaGetLastError());
}

// soa is [12, n_spheres]; time is [n_rays] (the rays' shutter times)
extern "C" int pt_sphere_nearest_moving(const float* rays, long long stride,
                                        const float* time, int n_rays,
                                        const float* soa, int n_spheres,
                                        float t_min, float t_max,
                                        float* t_out, int* idx_out,
                                        cudaStream_t stream) {
  if (n_rays > 0) {
    launch_any<true>(rays, stride, time, n_rays, soa, n_spheres, t_min,
                     t_max, t_out, idx_out, stream);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* pt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
