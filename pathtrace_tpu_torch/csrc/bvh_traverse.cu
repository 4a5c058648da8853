// Closest hit through the whole-scene BVH, one thread a ray, the warp's
// lanes in lock-step through the escape-index tree.
//
// Replaces no TPU kernel: the reference traverses the flat escape-index
// tree in XLA, all rays in lock-step under a while_loop whose trip count
// is the longest path (pathtrace_tpu/models/bvh.py:635-785,
// bvh_scene_nearest). Here each thread walks its own ray through the
// same pre-order: at node i it tests the box against the ray's running
// best t, descends to i + 1 at a hit inner node, runs the leaf's test at
// a hit leaf, and jumps to the node's escape index otherwise. A ray visits
// the nodes it visits in the lock-step loop, in the same order, so (t,
// gid) and the visit count equal the plain version's (ops/bvh_kernel.py
// bvh_traverse_plain) bit for bit: -fmad=false, IEEE division and sqrt,
// the sums in the plain version's order, and PTX min.NaN / max.NaN for
// torch.minimum / torch.maximum (a NaN ray misses every box in both).
//
// Operand: each node is two float4 rows, (min xyz, escape bits) and (max
// xyz, prim bits); with F_INLINE a sphere leaf's third row is its centre
// and radius and, with F_MOTION, rows four and five its delta, time0 and
// inv_dt. Other leaves read their primitive's record of six float4 rows
// by global id (ops/bvh_kernel.py tree_operand). Both are read through
// the read-only cache; the trees of the presets fit in L2. The leaf tests
// are bvh_leaf.cuh's, which the wide tree's kernel shares.
//
// Bound: issue slots. ops/bvh_kernel.py yardsticks counts 24 operations a
// visit and 18-80 a leaf test; the compiled visit is ~42 instructions (the
// box test's 25, its row address, the loop's control) and an inline
// sphere's test ~42 more, so this loop cannot pass ~57% of that bound. What
// the design keeps and adds, measured on the card against the other
// candidates (PERF.md; tools/bvh_bench.py times builds side by side):
// - The warp stays in lock-step. Neighbouring camera rays, and scattered
//   rays near the root, visit the same nodes at the same step, so a
//   node's rows are one broadcast load and a leaf's test runs for most of
//   the warp at once. A persistent grid whose lanes take new rays as
//   theirs end (with the next ray read ahead, or in refills of 8-32
//   lanes), leaf tests held until several lanes wait (while-while), and
//   the tree staged in shared memory each broke that coherence or added
//   control to every visit, and lost to this loop on every set.
// - Instances by the operand's flags: inline static spheres alone
//   (random_spheres, random_spheres_xl) and inline moving spheres alone
//   (random) test their leaf with no branch on the primitive's kind and no
//   flag read; every other scene takes the general instance. Each node's
//   row address is one 32-bit multiply-add on the tree's base.
// pt_bvh_traverse_plan gives the launch (grid and instance);
// ops/bvh_kernel.py traverse_plan mirrors the rule.

#include <cuda_runtime.h>
#include <stdint.h>

#include "bvh_leaf.cuh"

namespace {

constexpr int kThreads = 128;

// the leaf kinds an instance tests: every kind the flags name, or only
// inline spheres, static or moving
enum Kinds { kAny = 0, kSpheres = 1, kMovingSpheres = 2 };

int kinds_of(int flags) {
  if (flags == (F_INLINE | F_SPHERES)) return kSpheres;
  if (flags == (F_INLINE | F_SPHERES | F_MOTION)) return kMovingSpheres;
  return kAny;
}

template <int kKinds>
__global__ void __launch_bounds__(kThreads)
bvh_traverse_kernel(const float* __restrict__ rays, long long stride,
                    int n_rays, const float* __restrict__ time,
                    const float4* __restrict__ nodes, int n_nodes,
                    int node_rows, const float4* __restrict__ prims,
                    const float* __restrict__ flights, int off_r, int off_b,
                    int off_m, int flags, float t_min, float t_max,
                    float* __restrict__ t_out, int* __restrict__ gid_out,
                    int* __restrict__ visits_out) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n_rays) return;
  const bool motion = kKinds == kMovingSpheres ||
                      (kKinds == kAny && (flags & F_MOTION));
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
    const float4 lo = __ldg(node);
    const float4 hi = __ldg(node + 1);
    const float d0x = (lo.x - o[0]) * rcp[0], d1x = (hi.x - o[0]) * rcp[0];
    const float d0y = (lo.y - o[1]) * rcp[1], d1y = (hi.y - o[1]) * rcp[1];
    const float d0z = (lo.z - o[2]) * rcp[2], d1z = (hi.z - o[2]) * rcp[2];
    const float tn = nmax(nmax(nmin(d0x, d1x), nmin(d0y, d1y)), nmin(d0z, d1z));
    const float tf = nmin(nmin(nmax(d0x, d1x), nmax(d0y, d1y)), nmax(d0z, d1z));
    const bool hit = nmin(tf, best_t) > nmax(tn, t_min);
    const int prim = __float_as_int(hi.w);
    if (hit && prim >= 0) {
      float cand = kInf;
      if (prim < off_r) {
        if (kKinds != kAny) {
          cand = leaf_sphere_inline(node + 2, motion, o, d, tm, best_t,
                                    t_min);
        } else if (flags & F_SPHERES) {
          cand = (flags & F_INLINE)
                     ? leaf_sphere_inline(node + 2, motion, o, d, tm, best_t,
                                          t_min)
                     : leaf_sphere_instanced(prims + 6LL * prim, motion, o, d,
                                             tm, best_t, t_min);
        }
      } else if (kKinds == kAny) {
        if (prim < off_b) {
          if (flags & F_RECTS)
            cand = leaf_rect(prims + 6LL * prim, flags & F_RECT_INST, o, d,
                             best_t, t_min);
        } else if (prim < off_m) {
          if (flags & F_BOXES)
            cand = leaf_box(prims + 6LL * prim, o, d, best_t, t_min);
        } else if (flags & F_MEDIA) {
          const float flight =
              flights[static_cast<long long>(prim - off_m) * n_rays + i];
          cand = leaf_media(prims + 6LL * prim, o, d, flight, best_t, t_min);
        }
      }
      if (cand < best_t) {
        best_t = cand;
        best_i = prim;
      }
    }
    cursor = (hit && prim < 0) ? cursor + 1 : __float_as_int(lo.w);
    ++steps;
  }
  t_out[i] = best_t < t_max ? best_t : kInf;
  gid_out[i] = best_i;
  if (visits_out != nullptr) visits_out[i] = steps;
}

}  // namespace

// the launch of pt_bvh_traverse for n_rays rays of a tree with these
// flags: out[0] blocks, out[1] threads a block, out[2] the instance
// (0 every kind, 1 inline static spheres, 2 inline moving spheres)
extern "C" int pt_bvh_traverse_plan(int n_rays, int flags, int* out) {
  out[0] = n_rays > 0 ? (n_rays + kThreads - 1) / kThreads : 0;
  out[1] = kThreads;
  out[2] = kinds_of(flags);
  return 0;
}

extern "C" int pt_bvh_traverse(const float* rays, long long stride,
                               int n_rays, const float* time,
                               const void* nodes, int n_nodes, int node_rows,
                               const void* prims, const float* flights,
                               int off_r, int off_b, int off_m, int flags,
                               float t_min, float t_max, float* t_out,
                               int* gid_out, int* visits_out,
                               cudaStream_t stream) {
  if (n_rays <= 0) return 0;
  const int blocks = (n_rays + kThreads - 1) / kThreads;
  const int kinds = kinds_of(flags);
  auto kernel = kinds == kSpheres         ? bvh_traverse_kernel<kSpheres>
                : kinds == kMovingSpheres ? bvh_traverse_kernel<kMovingSpheres>
                                          : bvh_traverse_kernel<kAny>;
  kernel<<<blocks, kThreads, 0, stream>>>(
      rays, stride, n_rays, time, static_cast<const float4*>(nodes), n_nodes,
      node_rows, static_cast<const float4*>(prims), flights, off_r, off_b,
      off_m, flags, t_min, t_max, t_out, gid_out, visits_out);
  return static_cast<int>(cudaGetLastError());
}
