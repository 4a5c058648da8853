// The leaf tests of the whole-scene BVH's traversal kernels, shared by
// the flat tree's (bvh_traverse.cu) and the wide tree's
// (bvh_wide_traverse.cu): one primitive against one ray and its running
// best t, each a twin of ops/bvh_kernel.py's plain leaf test, bit for bit
// under -fmad=false (the sums in the plain version's order, PTX
// min.NaN / max.NaN for torch.minimum / torch.maximum, IEEE sqrt and
// division). Every function is internal to the source that includes it.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kInf = 3.402823466e38f;

constexpr int F_INLINE = 1;
constexpr int F_MOTION = 2;
constexpr int F_SPHERES = 4;
constexpr int F_RECTS = 8;
constexpr int F_BOXES = 16;
constexpr int F_MEDIA = 32;
constexpr int F_RECT_INST = 64;

// the leaf kinds a traversal instance tests: every kind the flags name,
// or only inline spheres, static or moving; the flat and the wide kernel
// pick their instance by this one rule (ops/bvh_kernel.py traverse_plan)
enum Kinds { kAny = 0, kSpheres = 1, kMovingSpheres = 2 };

int kinds_of(int flags) {
  if (flags == (F_INLINE | F_SPHERES)) return kSpheres;
  if (flags == (F_INLINE | F_SPHERES | F_MOTION)) return kMovingSpheres;
  return kAny;
}

// a traversal's launch for n_rays rays, one thread a ray in blocks of
// threads, of a tree with these flags: out[0] blocks, out[1] threads a
// block, out[2] the instance (0 every kind, 1 inline static spheres, 2
// inline moving spheres)
int traverse_plan(int n_rays, int flags, int threads, int* out) {
  out[0] = n_rays > 0 ? (n_rays + threads - 1) / threads : 0;
  out[1] = threads;
  out[2] = kinds_of(flags);
  return 0;
}

__device__ __forceinline__ float nmin(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ float nmax(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ float tiny(float d) {
  return fabsf(d) < 1e-12f ? 1e-12f : d;
}

// near root if it lies in (t_min, best_t), else the far one, else INF
__device__ __forceinline__ float root_pick(float t0, float t1, bool valid,
                                           float best_t, float t_min) {
  if (valid && t0 > t_min && t0 < best_t) return t0;
  if (valid && t1 > t_min && t1 < best_t) return t1;
  return kInf;
}

struct Affine {
  float m[12];
};

__device__ __forceinline__ Affine load_affine(const float4* rec) {
  Affine a;
  const float4 r0 = __ldg(rec + 3), r1 = __ldg(rec + 4), r2 = __ldg(rec + 5);
  a.m[0] = r0.x; a.m[1] = r0.y; a.m[2] = r0.z; a.m[3] = r0.w;
  a.m[4] = r1.x; a.m[5] = r1.y; a.m[6] = r1.z; a.m[7] = r1.w;
  a.m[8] = r2.x; a.m[9] = r2.y; a.m[10] = r2.z; a.m[11] = r2.w;
  return a;
}

// ((m0 x + m1 y) + m2 z) + m3, each operation rounded
__device__ __forceinline__ void apply(const Affine& a, const float v[3],
                                      bool translate, float out[3]) {
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    float s = __fadd_rn(__fadd_rn(__fmul_rn(a.m[4 * r], v[0]),
                                  __fmul_rn(a.m[4 * r + 1], v[1])),
                        __fmul_rn(a.m[4 * r + 2], v[2]));
    out[r] = translate ? __fadd_rn(s, a.m[4 * r + 3]) : s;
  }
}

__device__ __forceinline__ float dot3(const float a[3], const float b[3]) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a[0], b[0]), __fmul_rn(a[1], b[1])),
                   __fmul_rn(a[2], b[2]));
}

// slab test of the object-space ray (o, d) against [p0, p1]
__device__ __forceinline__ void slab(const float p0[3], const float p1[3],
                                     const float o[3], const float d[3],
                                     float& t_enter, float& t_exit) {
  float lo[3], hi[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float rcp = 1.0f / tiny(d[k]);
    const float d0 = (p0[k] - o[k]) * rcp;
    const float d1 = (p1[k] - o[k]) * rcp;
    lo[k] = nmin(d0, d1);
    hi[k] = nmax(d0, d1);
  }
  t_enter = nmax(nmax(lo[0], lo[1]), lo[2]);
  t_exit = nmin(nmin(hi[0], hi[1]), hi[2]);
}

// a sphere inline in a node: (centre, radius) at sph[0] and, with motion,
// (delta, time0) at sph[1] and inv_dt in sph[2].x
__device__ float leaf_sphere_inline(const float4* sph, bool motion,
                                    const float o[3], const float d[3],
                                    float tm, float best_t, float t_min) {
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
  const float sq = sqrtf(disc > 0.0f ? disc : 1.0f);
  return root_pick(-b - sq, -b + sq, disc > 0.0f, best_t, t_min);
}

__device__ float leaf_sphere_instanced(const float4* rec, bool motion,
                                       const float o[3], const float d[3],
                                       float tm, float best_t, float t_min) {
  const float4 r0 = __ldg(rec), r1 = __ldg(rec + 1), r2 = __ldg(rec + 2);
  float c[3] = {r0.x, r0.y, r0.z};
  const float r = r0.w;
  if (motion) {
    const float s = (tm - r1.w) * r2.x;
    c[0] = c[0] + s * r1.x;
    c[1] = c[1] + s * r1.y;
    c[2] = c[2] + s * r1.z;
  }
  const Affine m = load_affine(rec);
  float os[3], ds[3];
  apply(m, o, true, os);
  apply(m, d, false, ds);
  const float a = dot3(ds, ds);
  const float oc[3] = {os[0] - c[0], os[1] - c[1], os[2] - c[2]};
  const float b = dot3(oc, ds);
  const float cc = dot3(oc, oc) - r * r;
  const float disc = b * b - a * cc;
  const float sq = sqrtf(disc > 0.0f ? disc : 1.0f);
  const float inv_a = 1.0f / a;
  const bool valid = disc > 0.0f && r2.y > 0.5f;
  return root_pick((-b - sq) * inv_a, (-b + sq) * inv_a, valid, best_t, t_min);
}

__device__ float leaf_rect(const float4* rec, bool instanced,
                           const float o_w[3], const float d_w[3],
                           float best_t, float t_min) {
  const float4 r0 = __ldg(rec), r1 = __ldg(rec + 1);
  float o[3] = {o_w[0], o_w[1], o_w[2]};
  float d[3] = {d_w[0], d_w[1], d_w[2]};
  if (instanced) {
    const Affine m = load_affine(rec);
    apply(m, o_w, true, o);
    apply(m, d_w, false, d);
  }
  const int axis = static_cast<int>(r0.x);
  const int a_ax = axis == 0 ? 1 : 0;
  const int b_ax = axis == 2 ? 1 : 2;
  const float d_n = tiny(d[axis]);
  const float t = (r1.y - o[axis]) / d_n;
  const float pa = o[a_ax] + t * d[a_ax];
  const float pb = o[b_ax] + t * d[b_ax];
  const bool ok = r1.z > 0.5f && t > t_min && t < best_t && pa >= r0.y &&
                  pa <= r0.z && pb >= r0.w && pb <= r1.x;
  return ok ? t : kInf;
}

__device__ float leaf_box(const float4* rec, const float o_w[3],
                          const float d_w[3], float best_t, float t_min) {
  const float4 r0 = __ldg(rec), r1 = __ldg(rec + 1);
  const Affine m = load_affine(rec);
  float o[3], d[3];
  apply(m, o_w, true, o);
  apply(m, d_w, false, d);
  const float p0[3] = {r0.x, r0.y, r0.z};
  const float p1[3] = {r0.w, r1.x, r1.y};
  float t_enter, t_exit;
  slab(p0, p1, o, d, t_enter, t_exit);
  const bool crosses = t_exit > t_enter && r1.z > 0.5f;
  if (crosses && t_enter > t_min && t_enter < best_t) return t_enter;
  if (crosses && t_enter <= t_min && t_exit > t_min && t_exit < best_t)
    return t_exit;
  return kInf;
}

__device__ float leaf_media(const float4* rec, const float o_w[3],
                            const float d_w[3], float flight, float best_t,
                            float t_min) {
  const float4 r0 = __ldg(rec), r1 = __ldg(rec + 1), r2 = __ldg(rec + 2);
  const Affine m = load_affine(rec);
  float o[3], d[3];
  apply(m, o_w, true, o);
  apply(m, d_w, false, d);
  const float p0[3] = {r0.x, r0.y, r0.z};
  const float p1[3] = {r0.w, r1.x, r1.y};
  float t1b, t2b;
  slab(p0, p1, o, d, t1b, t2b);
  // the sphere boundary takes the world ray (centre in p0)
  const float oc[3] = {o_w[0] - p0[0], o_w[1] - p0[1], o_w[2] - p0[2]};
  const float b = dot3(oc, d_w);
  const float rad = r2.x;
  const float cc = dot3(oc, oc) - rad * rad;
  const float disc = b * b - cc;
  const float sq = sqrtf(disc > 0.0f ? disc : 1.0f);
  const bool is_sph = r1.w == 1.0f;  // MEDIUM_SPHERE
  float t1 = is_sph ? -b - sq : t1b;
  const float t2 = is_sph ? -b + sq : t2b;
  const bool crosses = (is_sph ? disc > 0.0f : t2b > t1b) && r1.z > 0.5f;
  t1 = nmax(t1, t_min);
  const bool ok = crosses && t1 < t2;
  t1 = nmax(t1, 0.0f);
  const bool inside = flight < t2 - t1;
  const float hit = t1 + flight;
  return (ok && inside && hit < best_t) ? hit : kInf;
}

}  // namespace
