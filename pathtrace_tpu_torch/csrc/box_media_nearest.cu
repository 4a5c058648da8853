// Closest hit over a scene's transformed boxes and its constant-density
// media, one thread a ray, both kinds in one launch.
//
// Replaces no TPU kernel: the reference sweeps boxes and media in XLA as
// [R, N] element-wise arrays (pathtrace_tpu/ops/intersect.py:445
// box_nearest, :606 media_nearest; their plane loops at :463 and :504).
// The port's plain version (ops/intersect_box.py box_nearest_rn,
// media_nearest_rn) does the same in PyTorch, ~91 launches a chunk of
// 2^23 (ray, primitive) pairs, each pass reading and writing 4-byte
// [Rc, N] temporaries. Here each thread keeps its ray in registers and
// its running winner too: the records come into shared memory a tile at
// a time (index order) and every thread of the block reads each one.
//
// Every pair is the plain version's operations in its order: the affine
// map as ((m0 x + m1 y) + m2 z) + m3, the slab test with a direction
// component below 1e-12 in magnitude taken as +1e-12, torch.minimum /
// maximum as PTX min.NaN / max.NaN (bvh_leaf.cuh), and for a medium the
// world ray's quadratic with a = rd.rd, disc = b*b - a*c, the roots
// (-b -/+ sq) / a, t1 clamped up to t_min, t2 down to t_max, then t1 up
// to 0, and a hit at t1 + flight when flight < t2 - t1. The winner is a
// running minimum with a strict < over ascending j (torch.argmin's first
// minimum); a miss gives (MAX_T, 0). Under -fmad=false with IEEE division
// and sqrt, (t, idx) equal the plain version's bit for bit. The media's
// free flights -log(max(u, 1e-38)) / density come in as [n_media, R],
// computed by PyTorch for both versions, so the kernel has no log.
//
// Records (ops/box_media_kernel.py pack_boxes, pack_media): a box is five
// float4 rows (obj_from_world's three rows, then p0 xyz | p1.x, then
// p1.yz | mask | 0), a medium six (the same, the fifth row ending in its
// kind, then radius | 0 | 0 | 0).
//
// Bound: issue slots. A (ray, box) pair is ~80 instructions (two affine
// maps, three slabs with a division each, the tests), a (ray, medium) pair
// ~100; the bytes are 24 a ray in, 8 out for each kind, and 4 a (ray,
// medium) flight. The shared-memory reads are broadcasts.

#include <cuda_runtime.h>
#include <stdint.h>

#include "bvh_leaf.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kBoxRows = 5;    // float4 rows a box record
constexpr int kMediaRows = 6;  // float4 rows a medium record
// one tile of shared memory, 2400 float4 rows (37.5 KB): 480 boxes or 400
// media a pass
constexpr int kTileRows = 2400;
constexpr int kBoxTile = kTileRows / kBoxRows;
constexpr int kMediaTile = kTileRows / kMediaRows;

__device__ __forceinline__ void load_affine_rows(const float4* rec,
                                                 Affine& a) {
  const float4 r0 = rec[0], r1 = rec[1], r2 = rec[2];
  a.m[0] = r0.x; a.m[1] = r0.y; a.m[2] = r0.z; a.m[3] = r0.w;
  a.m[4] = r1.x; a.m[5] = r1.y; a.m[6] = r1.z; a.m[7] = r1.w;
  a.m[8] = r2.x; a.m[9] = r2.y; a.m[10] = r2.z; a.m[11] = r2.w;
}

// box_nearest_rn's candidate of one (ray, box) pair
__device__ __forceinline__ float box_candidate(const float4* rec,
                                               const float o_w[3],
                                               const float d_w[3],
                                               float t_min, float t_max) {
  Affine m;
  load_affine_rows(rec, m);
  float o[3], d[3];
  apply(m, o_w, true, o);
  apply(m, d_w, false, d);
  const float4 r3 = rec[3], r4 = rec[4];
  const float p0[3] = {r3.x, r3.y, r3.z};
  const float p1[3] = {r3.w, r4.x, r4.y};
  float tn, tf;
  slab(p0, p1, o, d, tn, tf);
  const bool crosses = tf > tn && r4.z > 0.5f;
  if (crosses && tn > t_min && tn < t_max) return tn;
  if (crosses && tn <= t_min && tf > t_min && tf < t_max) return tf;
  return kInf;
}

// media_nearest_rn's candidate of one (ray, medium) pair; a = rd.rd
__device__ __forceinline__ float media_candidate(const float4* rec,
                                                 const float o_w[3],
                                                 const float d_w[3], float a,
                                                 float flight, float t_min,
                                                 float t_max) {
  Affine m;
  load_affine_rows(rec, m);
  float o[3], d[3];
  apply(m, o_w, true, o);
  apply(m, d_w, false, d);
  const float4 r3 = rec[3], r4 = rec[4], r5 = rec[5];
  const float p0[3] = {r3.x, r3.y, r3.z};
  const float p1[3] = {r3.w, r4.x, r4.y};
  float tn, tf;
  slab(p0, p1, o, d, tn, tf);
  // the sphere boundary takes the world ray (centre in p0)
  const float oc[3] = {o_w[0] - p0[0], o_w[1] - p0[1], o_w[2] - p0[2]};
  const float b = dot3(oc, d_w);
  const float rad = r5.x;
  const float c = dot3(oc, oc) - rad * rad;
  const float disc = b * b - a * c;
  const float sq = sqrtf(disc > 0.0f ? disc : 1.0f);
  const bool is_sph = r4.w == 1.0f;  // MEDIUM_SPHERE
  float t1 = is_sph ? (-b - sq) / a : tn;
  float t2 = is_sph ? (-b + sq) / a : tf;
  const bool crosses = (is_sph ? disc > 0.0f : tf > tn) && r4.z > 0.5f;
  t1 = nmax(t1, t_min);
  t2 = nmin(t2, t_max);
  const bool ok = crosses && t1 < t2;
  t1 = nmax(t1, 0.0f);
  const bool inside = flight < t2 - t1;
  return (ok && inside) ? t1 + flight : kInf;
}

template <bool kBoxes, bool kMedia>
__global__ void __launch_bounds__(kThreads)
box_media_nearest_kernel(const float* __restrict__ rays, long long stride,
                         int n_rays, const float4* __restrict__ boxes,
                         int n_boxes, const float4* __restrict__ media,
                         int n_media, const float* __restrict__ flights,
                         float t_min, float t_max, float* __restrict__ box_t,
                         int* __restrict__ box_idx,
                         float* __restrict__ media_t,
                         int* __restrict__ media_idx) {
  __shared__ float4 tile[kTileRows];
  const int i = blockIdx.x * kThreads + threadIdx.x;
  // every thread stages records; only threads with a ray sweep them
  const bool live = i < n_rays;
  float o[3] = {0.0f, 0.0f, 0.0f}, d[3] = {0.0f, 0.0f, 0.0f};
  if (live) {
    o[0] = rays[i];
    o[1] = rays[stride + i];
    o[2] = rays[2 * stride + i];
    d[0] = rays[3 * stride + i];
    d[1] = rays[4 * stride + i];
    d[2] = rays[5 * stride + i];
  }
  if (kBoxes) {
    float best = kInf;
    int best_j = 0;
    for (int base = 0; base < n_boxes; base += kBoxTile) {
      const int count = min(kBoxTile, n_boxes - base);
      __syncthreads();
      for (int k = threadIdx.x; k < count * kBoxRows; k += kThreads)
        tile[k] = boxes[static_cast<long long>(base) * kBoxRows + k];
      __syncthreads();
      if (live) {
        for (int j = 0; j < count; ++j) {
          const float cand = box_candidate(tile + j * kBoxRows, o, d, t_min,
                                           t_max);
          if (cand < best) {
            best = cand;
            best_j = base + j;
          }
        }
      }
    }
    if (live) {
      box_t[i] = best;
      box_idx[i] = best_j;
    }
  }
  if (kMedia) {
    const float a = dot3(d, d);
    float best = kInf;
    int best_j = 0;
    for (int base = 0; base < n_media; base += kMediaTile) {
      const int count = min(kMediaTile, n_media - base);
      __syncthreads();
      for (int k = threadIdx.x; k < count * kMediaRows; k += kThreads)
        tile[k] = media[static_cast<long long>(base) * kMediaRows + k];
      __syncthreads();
      if (live) {
        for (int j = 0; j < count; ++j) {
          const float flight =
              flights[static_cast<long long>(base + j) * n_rays + i];
          const float cand = media_candidate(tile + j * kMediaRows, o, d, a,
                                             flight, t_min, t_max);
          if (cand < best) {
            best = cand;
            best_j = base + j;
          }
        }
      }
    }
    if (live) {
      media_t[i] = best;
      media_idx[i] = best_j;
    }
  }
}

}  // namespace

// boxes (n_boxes > 0) and media (n_media > 0) in one launch; either count
// may be 0, and its outputs are then not written
extern "C" int pt_box_media_nearest(const float* rays, long long stride,
                                    int n_rays, const void* boxes,
                                    int n_boxes, const void* media,
                                    int n_media, const float* flights,
                                    float t_min, float t_max, float* box_t,
                                    int* box_idx, float* media_t,
                                    int* media_idx, cudaStream_t stream) {
  if (n_rays <= 0 || (n_boxes <= 0 && n_media <= 0)) return 0;
  const int blocks = (n_rays + kThreads - 1) / kThreads;
  const float4* b = static_cast<const float4*>(boxes);
  const float4* m = static_cast<const float4*>(media);
  if (n_boxes > 0 && n_media > 0) {
    box_media_nearest_kernel<true, true><<<blocks, kThreads, 0, stream>>>(
        rays, stride, n_rays, b, n_boxes, m, n_media, flights, t_min, t_max,
        box_t, box_idx, media_t, media_idx);
  } else if (n_boxes > 0) {
    box_media_nearest_kernel<true, false><<<blocks, kThreads, 0, stream>>>(
        rays, stride, n_rays, b, n_boxes, m, n_media, flights, t_min, t_max,
        box_t, box_idx, media_t, media_idx);
  } else {
    box_media_nearest_kernel<false, true><<<blocks, kThreads, 0, stream>>>(
        rays, stride, n_rays, b, n_boxes, m, n_media, flights, t_min, t_max,
        box_t, box_idx, media_t, media_idx);
  }
  return static_cast<int>(cudaGetLastError());
}
