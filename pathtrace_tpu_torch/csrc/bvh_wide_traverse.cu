// Closest hit through the wide-node BVH, one thread a ray, the warp's
// lanes in lock-step through the pre-order rows.
//
// Replaces no TPU kernel: the reference traverses its wide tree in XLA,
// all rays in lock-step under a while_loop (pathtrace_tpu/models/bvh.py:
// 978-1101, wide_scene_nearest). Here each thread walks its own ray
// through the same pre-order. At an inner node it tests both children's
// boxes (stored in the parent's row) against its running best t and moves
// to the left child if that box is hit, else to the right one, else to the
// node's escape. At a leaf it tests each filled slot's inline sphere in
// slot order, or, in a leaf of another kind, its one primitive through its
// record, and moves to the escape. A ray visits the nodes it visits in the
// lock-step loop, in the same order, so (t, gid, visits) equal the plain
// version's (ops/bvh_kernel.py wide_traverse_plain) bit for bit, and (t,
// gid) the flat tree's: -fmad=false, IEEE division and sqrt, the sums in
// the plain version's order and PTX min.NaN / max.NaN, as in
// bvh_traverse.cu, whose leaf tests (bvh_leaf.cuh) this kernel shares for
// every kind but its sphere slots.
//
// Operand (ops/bvh_kernel.py wide_operand): a node is node_rows float4
// rows. Row 0 is (nav, escape, slots, kind) as int bits: an inner node has
// 0 slots and kind -1, a leaf its filled slots (a prefix) and its kind
// (WIDE_KIND_*). An inner node's rows 1-3 hold the two child boxes; a
// leaf's rows from 1 hold its slots' global ids, and from float slot_base
// each slot's sphere (one float4, or three with motion, laid out as the
// flat tree's inline sphere). Other leaves read their primitive's record
// of six float4 rows by global id.
//
// What the design keeps and adds (PERF.md §6; tools/bvh_bench.py
// --what wide times builds side by side):
// - The warp stays in lock-step, as in bvh_traverse.cu: neighbouring rays
//   visit the same node at the same step, so its rows are one broadcast
//   load and a leaf's slots run for most of the warp at once.
// - Instances by the operand's flags, as bvh_traverse.cu's: inline static
//   spheres alone and inline moving spheres alone test every leaf's slots
//   with no branch on the kind; every other scene takes the general
//   instance, which branches on the header's kind once a leaf.
// - The slot loop runs to the header's count and reads a slot's id only
//   when the slot wins; a slot whose discriminant is not positive returns
//   before the square root (the same bits: its candidate is INF either
//   way), so a warp whose lanes all miss a sphere skips it.
// - Each node's row address is one 32-bit multiply-add on the tree's base.
// pt_bvh_wide_traverse_plan gives the launch (grid and instance) by the
// flat kernel's rule, which ops/bvh_kernel.py traverse_plan mirrors.
//
// Bound: issue slots over data-dependent loops (ops/bvh_kernel.py
// wide_yardsticks: 54 operations an inner visit, 6 a leaf visit, 24 a
// sphere slot whose discriminant is positive and 18 one whose is not; 8
// more a slot with motion).

#include <cuda_runtime.h>
#include <stdint.h>

#include "bvh_leaf.cuh"

namespace {

constexpr int kThreads = 128;

// a leaf's kind in its header (ops/bvh_kernel.py WIDE_KIND_*)
enum LeafKind { kLeafSphere = 0, kLeafRect = 1, kLeafBox = 2, kLeafMedium = 3 };

// the slab test of a child box (lo xyz, hi xyz) against the running best
__device__ __forceinline__ bool child_hit(const float lo[3],
                                          const float hi[3],
                                          const float o[3],
                                          const float rcp[3], float best_t,
                                          float t_min) {
  const float d0x = (lo[0] - o[0]) * rcp[0], d1x = (hi[0] - o[0]) * rcp[0];
  const float d0y = (lo[1] - o[1]) * rcp[1], d1y = (hi[1] - o[1]) * rcp[1];
  const float d0z = (lo[2] - o[2]) * rcp[2], d1z = (hi[2] - o[2]) * rcp[2];
  const float tn = nmax(nmax(nmin(d0x, d1x), nmin(d0y, d1y)), nmin(d0z, d1z));
  const float tf = nmin(nmin(nmax(d0x, d1x), nmax(d0y, d1y)), nmax(d0z, d1z));
  return nmin(tf, best_t) > nmax(tn, t_min);
}

// a slot's inline sphere: bvh_leaf.cuh leaf_sphere_inline's arithmetic,
// but a non-positive discriminant returns INF before the square root
__device__ __forceinline__ float slot_sphere(const float4* sph, bool motion,
                                             const float o[3],
                                             const float d[3], float tm,
                                             float best_t, float t_min) {
  const float4 s0 = __ldg(sph);
  float c[3] = {s0.x, s0.y, s0.z};
  const float r = s0.w;
  if (motion) {
    const float4 s1 = __ldg(sph + 1);
    const float4 s2 = __ldg(sph + 2);
    const float s = (tm - s1.w) * s2.x;
    c[0] = c[0] + s * s1.x;
    c[1] = c[1] + s * s1.y;
    c[2] = c[2] + s * s1.z;
  }
  const float oc[3] = {o[0] - c[0], o[1] - c[1], o[2] - c[2]};
  const float b = dot3(oc, d);
  const float cc = dot3(oc, oc) - r * r;
  const float disc = b * b - cc;
  if (!(disc > 0.0f)) return kInf;
  const float sq = sqrtf(disc);
  return root_pick(-b - sq, -b + sq, true, best_t, t_min);
}

// One resident block an SM at least: ptxas keeps the static, moving and
// general instances in 32, 37 and 48 registers with no spills; with no
// minimum it spilled the static instance to fit 32, which measured slower
// (PERF.md §6).
template <int kKinds>
__global__ void __launch_bounds__(kThreads, 1)
bvh_wide_traverse_kernel(const float* __restrict__ rays, long long stride,
                         int n_rays, const float* __restrict__ time,
                         const float4* __restrict__ nodes, int n_nodes,
                         int node_rows, int slot_base, int slot_f,
                         const float4* __restrict__ prims,
                         const float* __restrict__ flights, int off_r,
                         int off_b, int off_m, int flags, float t_min,
                         float t_max, float* __restrict__ t_out,
                         int* __restrict__ gid_out,
                         int* __restrict__ visits_out) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n_rays) return;
  const bool motion = kKinds == kMovingSpheres ||
                      (kKinds == kAny && (flags & F_MOTION));
  const int slot_rows = kKinds == kSpheres         ? 1
                        : kKinds == kMovingSpheres ? 3
                                                   : slot_f >> 2;
  const int first_slot = slot_base >> 2;
  const float o[3] = {rays[i], rays[stride + i], rays[2 * stride + i]};
  const float d[3] = {rays[3 * stride + i], rays[4 * stride + i],
                      rays[5 * stride + i]};
  const float tm = motion ? time[i] : 0.0f;
  const float rcp[3] = {1.0f / tiny(d[0]), 1.0f / tiny(d[1]),
                        1.0f / tiny(d[2])};
  const char* base = reinterpret_cast<const char*>(nodes);
  const unsigned row_bytes = 16u * static_cast<unsigned>(node_rows);
  float best_t = t_max;
  int best_i = 0;
  int cursor = 0;
  int steps = 0;
  const int cap = 4 * n_nodes;
  while (cursor < n_nodes && steps < cap) {
    const float4* node = reinterpret_cast<const float4*>(
        base + static_cast<unsigned>(cursor) * row_bytes);
    const float4 h = __ldg(node);
    const int nav = __float_as_int(h.x);
    int next = __float_as_int(h.y);
    if (nav >= 0) {
      const float4 b0 = __ldg(node + 1), b1 = __ldg(node + 2),
                   b2 = __ldg(node + 3);
      const float l_lo[3] = {b0.x, b0.y, b0.z}, l_hi[3] = {b0.w, b1.x, b1.y};
      const float r_lo[3] = {b1.z, b1.w, b2.x}, r_hi[3] = {b2.y, b2.z, b2.w};
      if (child_hit(l_lo, l_hi, o, rcp, best_t, t_min)) {
        next = cursor + 1;
      } else if (child_hit(r_lo, r_hi, o, rcp, best_t, t_min)) {
        next = nav;
      }
    } else {
      const int* ids = reinterpret_cast<const int*>(node + 1);
      const int kind = kKinds == kAny ? __float_as_int(h.w) : kLeafSphere;
      if (kind == kLeafSphere) {
        const int count = __float_as_int(h.z);
        const float4* sph = node + first_slot;
        int win = -1;
        // rolled: the general instance's code stays small, which the
        // Cornell scenes' sets measured faster (PERF.md §6)
#pragma unroll 1
        for (int m = 0; m < count; ++m, sph += slot_rows) {
          const float cand = slot_sphere(sph, motion, o, d, tm, best_t,
                                         t_min);
          if (cand < best_t) {
            best_t = cand;
            win = m;
          }
        }
        if (win >= 0) best_i = __ldg(ids + win);
      } else {
        const int gid = __ldg(ids);
        float cand = kInf;
        if (kind == kLeafRect) {
          if (flags & F_RECTS)
            cand = leaf_rect(prims + 6 * gid, flags & F_RECT_INST, o, d,
                             best_t, t_min);
        } else if (kind == kLeafBox) {
          if (flags & F_BOXES)
            cand = leaf_box(prims + 6 * gid, o, d, best_t, t_min);
        } else if (flags & F_MEDIA) {
          const float flight =
              flights[static_cast<long long>(gid - off_m) * n_rays + i];
          cand = leaf_media(prims + 6 * gid, o, d, flight, best_t, t_min);
        }
        if (cand < best_t) {
          best_t = cand;
          best_i = gid;
        }
      }
    }
    cursor = next;
    ++steps;
  }
  t_out[i] = best_t < t_max ? best_t : kInf;
  gid_out[i] = best_i;
  if (visits_out != nullptr) visits_out[i] = steps;
}

}  // namespace

// the launch of pt_bvh_wide_traverse for n_rays rays of a tree with these
// flags (bvh_leaf.cuh traverse_plan: the flat kernel's rule)
extern "C" int pt_bvh_wide_traverse_plan(int n_rays, int flags, int* out) {
  return traverse_plan(n_rays, flags, kThreads, out);
}

extern "C" int pt_bvh_wide_traverse(const float* rays, long long stride,
                                    int n_rays, const float* time,
                                    const void* nodes, int n_nodes,
                                    int node_rows, int leaf_m, int slot_base,
                                    int slot_f, const void* prims,
                                    const float* flights, int off_r,
                                    int off_b, int off_m, int flags,
                                    float t_min, float t_max, float* t_out,
                                    int* gid_out, int* visits_out,
                                    cudaStream_t stream) {
  // leaf_m is unused (the header's slot count bounds each leaf's loop); it
  // stays in the signature so that builds of earlier sources, which read
  // it, take the same call (tools/bvh_bench.py --parent)
  (void)leaf_m;
  if (n_rays <= 0) return 0;
  if ((slot_base & 3) || (slot_f & 3)) return cudaErrorInvalidValue;
  // 32-bit row addresses
  if (16LL * n_nodes * node_rows >= (1LL << 32)) return cudaErrorInvalidValue;
  const int blocks = (n_rays + kThreads - 1) / kThreads;
  const int kinds = kinds_of(flags);
  auto kernel = kinds == kSpheres ? bvh_wide_traverse_kernel<kSpheres>
                : kinds == kMovingSpheres
                    ? bvh_wide_traverse_kernel<kMovingSpheres>
                    : bvh_wide_traverse_kernel<kAny>;
  kernel<<<blocks, kThreads, 0, stream>>>(
      rays, stride, n_rays, time, static_cast<const float4*>(nodes), n_nodes,
      node_rows, slot_base, slot_f, static_cast<const float4*>(prims),
      flights, off_r, off_b, off_m, flags, t_min, t_max, t_out, gid_out,
      visits_out);
  return static_cast<int>(cudaGetLastError());
}
