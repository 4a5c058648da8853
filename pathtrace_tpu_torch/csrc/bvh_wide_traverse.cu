// Closest hit through the wide-node BVH, one thread a ray.
//
// Replaces no TPU kernel: the reference traverses its wide tree in XLA,
// all rays in lock-step under a while_loop (pathtrace_tpu/models/bvh.py:
// 978-1101, wide_scene_nearest). Here each thread walks its own ray
// through the same pre-order. At an inner node it tests both children's
// boxes (stored in the parent's row) against its running best t and moves
// to the left child if that box is hit, else to the right one, else to the
// node's escape. At a leaf it tests each slot's inline sphere in slot
// order, then, in a leaf of another kind, that one primitive through its
// record, and moves to the escape. A ray visits the nodes it visits in the
// lock-step loop, in the same order, so (t, gid) equal the plain version's
// (ops/bvh_kernel.py wide_traverse_plain) bit for bit, and the flat
// tree's: -fmad=false, IEEE division and sqrt, the sums in the plain
// version's order and PTX min.NaN / max.NaN, as in bvh_traverse.cu, whose
// leaf tests (bvh_leaf.cuh) this kernel shares.
//
// Operand (ops/bvh_kernel.py wide_operand): a node is node_rows float4
// rows. Row 0 is (nav, escape, 0, 0) as int bits; an inner node's rows
// 1-3 hold the two child boxes; a leaf's rows from 1 hold its slots' global
// ids, and from float slot_base each slot's sphere (one float4, or three
// with motion, laid out as the flat tree's inline sphere). Non-sphere
// leaves read their primitive's record of six float4 rows by global id.
//
// Bound: issue slots (~54 instructions an inner visit, ~24-32 a sphere
// slot) over data-dependent loops; this simple form is latency-bound
// first, each visit's loads depending on the last visit's choice.

#include <cuda_runtime.h>
#include <stdint.h>

#include "bvh_leaf.cuh"

namespace {

constexpr int kThreads = 128;

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

__global__ void __launch_bounds__(kThreads)
bvh_wide_traverse_kernel(const float* __restrict__ rays, long long stride,
                         int n_rays, const float* __restrict__ time,
                         const float4* __restrict__ nodes, int n_nodes,
                         int node_rows, int leaf_m, int slot_base, int slot_f,
                         const float4* __restrict__ prims,
                         const float* __restrict__ flights, int off_r,
                         int off_b, int off_m, int flags, float t_min,
                         float t_max, float* __restrict__ t_out,
                         int* __restrict__ gid_out,
                         int* __restrict__ visits_out) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n_rays) return;
  const float o[3] = {rays[i], rays[stride + i], rays[2 * stride + i]};
  const float d[3] = {rays[3 * stride + i], rays[4 * stride + i],
                      rays[5 * stride + i]};
  const bool motion = flags & F_MOTION;
  const float tm = motion ? time[i] : 0.0f;
  const float rcp[3] = {1.0f / tiny(d[0]), 1.0f / tiny(d[1]),
                        1.0f / tiny(d[2])};
  float best_t = t_max;
  int best_i = 0;
  int cursor = 0;
  int steps = 0;
  const int cap = 4 * n_nodes;
  while (cursor < n_nodes && steps < cap) {
    const float4* node = nodes + static_cast<long long>(cursor) * node_rows;
    const float4 h = __ldg(node);
    const int nav = __float_as_int(h.x);
    const int esc = __float_as_int(h.y);
    int next = esc;
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
      if (flags & F_SPHERES) {
        for (int m = 0; m < leaf_m; ++m) {
          const int gid = __ldg(ids + m);
          if (gid < 0 || gid >= off_r) continue;
          const float4* sph =
              node + (slot_base >> 2) + ((m * slot_f) >> 2);
          const float cand =
              leaf_sphere_inline(sph, motion, o, d, tm, best_t, t_min);
          if (cand < best_t) {
            best_t = cand;
            best_i = gid;
          }
        }
      }
      const int gid0 = __ldg(ids);
      if (gid0 >= off_r) {
        float cand = kInf;
        if (gid0 < off_b) {
          if (flags & F_RECTS)
            cand = leaf_rect(prims + 6LL * gid0, flags & F_RECT_INST, o, d,
                             best_t, t_min);
        } else if (gid0 < off_m) {
          if (flags & F_BOXES)
            cand = leaf_box(prims + 6LL * gid0, o, d, best_t, t_min);
        } else if (flags & F_MEDIA) {
          const float flight =
              flights[static_cast<long long>(gid0 - off_m) * n_rays + i];
          cand = leaf_media(prims + 6LL * gid0, o, d, flight, best_t, t_min);
        }
        if (cand < best_t) {
          best_t = cand;
          best_i = gid0;
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
  if (n_rays <= 0) return 0;
  if ((slot_base & 3) || (slot_f & 3)) return cudaErrorInvalidValue;
  const int blocks = (n_rays + kThreads - 1) / kThreads;
  bvh_wide_traverse_kernel<<<blocks, kThreads, 0, stream>>>(
      rays, stride, n_rays, time, static_cast<const float4*>(nodes), n_nodes,
      node_rows, leaf_m, slot_base, slot_f,
      static_cast<const float4*>(prims), flights, off_r, off_b, off_m, flags,
      t_min, t_max, t_out, gid_out, visits_out);
  return static_cast<int>(cudaGetLastError());
}
