// K7, the megakernel: a ray's whole bounce loop in one kernel, one ray a
// thread (Hopper, sm_90a).
//
// Replaces the TPU kernel pathtrace_tpu/ops/megakernel.py _make_kernel.
// There a grid step ran the loop for a 64-ray block with the scene's
// attribute tables resident in VMEM, picked each ray's winner attributes
// with a one-hot matrix product (the TPU's stand-in for a gather) and
// stopped a block once none of its rays was alive.
//
// Per pass and ray:
// * the sphere sweep, the megakernel's own quadratic from the (lerped)
//   centre: b = ro.d - c.d, c = ((|ro|^2 - 2 c.ro) + |c|^2) - r^2; the
//   lowest index among the spheres at the least t wins (the TPU's tie
//   rule, first index with a strict `<`);
// * the rect sweep (with rects); a rect beats the sphere winner only when
//   strictly nearer, and the first rect at the least t wins;
// * the winner's 14 shading floats read by index from the [N, 24] table in
//   device memory (L2-resident), then albedo (constant, checker, hash-
//   turbulence marble), emission or sky into the radiance, counter-hash
//   draws 0-3 keyed on the global ray index, and the Lambertian / metal /
//   dielectric scatter; a ray dies on a miss, on a light and on a metal
//   reflection below the horizon, and ends after pass max_depth.
//
// What bounds it: issue slots of fp32 arithmetic. Built with -fmad=false,
// a static (ray, sphere) pair needs 17 additions and multiplications
// once |c|^2 and r^2 are taken per sphere (30 where the centre is lerped),
// a (ray, rect) pair 6, a shaded segment a few hundred; 28 bytes in and
// 12 out per ray. What the design does about it:
// - The scene stays in shared memory for the whole launch (opt-in dynamic
//   shared memory, up to 227 KB a block): the sphere rows the sweep needs
//   (prep_tables' sphere_rows: every row whose geometry differs from all
//   rows before it, so one dead row stands for all of them) as float4
//   (cx, cy, cz, |c|^2) with r^2 and the row number beside, moving rows as
//   float4 (c0x, c0y, c0z, r^2) and (dx, dy, dz, time0) with inv_dt; and
//   the rect rows likewise. The only block barrier is the one after
//   staging.
// - No barrier in the bounce loop, and a persistent grid whose warps
//   leave or refill on their own (Aila and Laine's persistent while-while,
//   2009): a lane whose ray has ended takes the next ray index from a
//   global counter, one atomicAdd a warp per refill (ballot and popc), and
//   a warp stops when the counter is spent and its lanes are done. Each ray
//   keeps its own depth, and its hash stream stays keyed on its global
//   index, so its result does not depend on which thread traces it.
// - A pair costs its arithmetic and a shared-memory broadcast; the sqrt and
//   root choice run behind one branch per four rows on "some disc > 0".
//   Static rows of a moving scene (delta = 0, inv_dt = 0, |time0| <= 1e30)
//   skip the lerp: with a finite ray time it adds +-0 to the centre, which
//   changes no bit of b*b - c or t (the sign of a zero only). A ray whose
//   time is not finite hits no sphere in a moving scene (every lerped
//   disc is NaN), so it sweeps with a NaN origin.
// Segments and lane-passes (32 for each pass a warp makes) are counted
// per thread and added once per warp.
//
// Numerics: built with -fmad=false and IEEE division and sqrt, so every
// + - * / sqrt rounds as the plain PyTorch version's (trace_megakernel_plain
// in pathtrace_tpu_torch/ops/megakernel.py, which takes the sweep's root in
// float64 and rounds once). sinf, cosf, expf, logf and rsqrtf may differ
// from PyTorch's by a few ULPs, which is what the lane contract allows.

#include <cuda_runtime.h>
#include <stdint.h>

#include "pt_device.cuh"

namespace {

using namespace pt;

constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kK = 24;         // floats per table row
constexpr int kSphereShade = 9;  // first shading column of a sphere row
constexpr int kRectShade = 7;    // first shading column of a rect row

__host__ __device__ constexpr int pad4(int n) { return (n + 3) & ~3; }

// Shared bytes of the resident scene (intersect rows padded to 4 for the
// unrolled sweep): 24 a static row (float4, r^2, row), 40 a moving one
// (two float4s, inv_dt, row), 28 a rect (six floats, row). Without motion
// every sphere row takes the static form.
__host__ __device__ size_t scene_bytes(int n_static, int n_moving,
                                       int n_rects, bool motion) {
  const int s4 = pad4(motion ? n_static : n_static + n_moving);
  const int m4 = motion ? pad4(n_moving) : 0;
  return 24u * s4 + 40u * m4 + 28u * n_rects;
}

__device__ __forceinline__ float cbrt_mk(float x) {
  return expf(logf(fmaxf(x, 1e-30f)) * (1.0f / 3.0f));
}

// The running winner: the least t, and on equal t the lowest row, so the
// rows may be swept in any order (static rows, then moving ones).
__device__ __forceinline__ void take_root(float b, float disc, int row,
                                          float t_min, float& best_t,
                                          int& best_row) {
  if (disc > 0.0f) {
    const float sq = sqrtf(disc);
    const float t0 = -b - sq;
    const float t = t0 > t_min ? t0 : -b + sq;
    if (t > t_min && (t < best_t || (t == best_t && row < best_row))) {
      best_t = t;
      best_row = row;
    }
  }
}

template <bool kMotion>
__global__ void __launch_bounds__(kThreads)
megakernel(const float* __restrict__ ro, const float* __restrict__ rd,
           const float* __restrict__ time_in, int n_rays,
           const float* __restrict__ sph, const int* __restrict__ rows,
           int n_static, int n_moving, const float* __restrict__ rect,
           const int* __restrict__ rect_rows, int n_rects,
           const float* __restrict__ sky4, uint32_t seed, int max_depth,
           int flags, float t_min, float* __restrict__ out,
           unsigned long long* __restrict__ work) {
  // the resident scene (scene_bytes): float4 arrays first
  extern __shared__ float4 s_mem[];
  const int n_s = kMotion ? n_static : n_static + n_moving;  // static form
  const int n_m = kMotion ? n_moving : 0;                    // lerped
  const int s4 = pad4(n_s), m4 = pad4(n_m);
  float4* s_p = s_mem;           // [s4] cx, cy, cz, |c|^2
  float4* s_c = s_p + s4;        // [m4] c0x, c0y, c0z, r^2
  float4* s_d = s_c + m4;        // [m4] dx, dy, dz, time0
  float* s_rr = reinterpret_cast<float*>(s_d + m4);  // [s4] r^2
  float* s_inv = s_rr + s4;                          // [m4] inv_dt
  int* s_row = reinterpret_cast<int*>(s_inv + m4);   // [s4] row
  int* s_mrow = s_row + s4;                          // [m4] row
  float* s_rect = reinterpret_cast<float*>(s_mrow + m4);  // [6][n_rects]
  int* s_rrow = reinterpret_cast<int*>(s_rect + 6 * n_rects);  // [n_rects]

  const float nan = __int_as_float(0x7fc00000);
  for (int k = threadIdx.x; k < s4; k += kThreads) {
    if (k < n_s) {
      const int g = rows[k];
      const float* row = sph + static_cast<long long>(g) * kK;
      const float cx = row[0], cy = row[1], cz = row[2], r = row[8];
      s_p[k] = make_float4(cx, cy, cz, cx * cx + cy * cy + cz * cz);
      s_rr[k] = r * r;
      s_row[k] = g;
    } else {  // padding: a NaN centre never hits
      s_p[k] = make_float4(nan, nan, nan, nan);
      s_rr[k] = nan;
      s_row[k] = 0;
    }
  }
  for (int k = threadIdx.x; k < m4; k += kThreads) {
    if (k < n_m) {
      const int g = rows[n_static + k];
      const float* row = sph + static_cast<long long>(g) * kK;
      s_c[k] = make_float4(row[0], row[1], row[2], row[8] * row[8]);
      s_d[k] = make_float4(row[3], row[4], row[5], row[6]);
      s_inv[k] = row[7];
      s_mrow[k] = g;
    } else {
      s_c[k] = make_float4(nan, nan, nan, nan);
      s_d[k] = make_float4(0.f, 0.f, 0.f, 0.f);
      s_inv[k] = 0.f;
      s_mrow[k] = 0;
    }
  }
  for (int k = threadIdx.x; k < n_rects; k += kThreads) {
    const int g = rect_rows[k];
#pragma unroll
    for (int c = 0; c < 6; ++c) s_rect[c * n_rects + k] = rect[g * kK + c];
    s_rrow[k] = g;
  }
  __syncthreads();  // the only barrier: the scene is staged

  const float sky_r = sky4[0], sky_g = sky4[1], sky_b = sky4[2];
  const bool sky_grad = sky4[3] > 0.5f;
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  unsigned long long* segs_out = work;
  unsigned long long* passes_out = work + 1;
  unsigned long long* next_ray = work + 2;

  int i = -1;  // this lane's ray, -1 when it has none
  int depth = 0;
  float ox = nan, oy = nan, oz = nan, dx = 0.f, dy = 0.f, dz = 0.f, tm = 0.f;
  float th_r = 1.f, th_g = 1.f, th_b = 1.f;
  float ra_r = 0.f, ra_g = 0.f, ra_b = 0.f;
  unsigned long long segs = 0, passes = 0;
  bool drained = false;

  while (true) {
    // refill: the lanes without a ray take the next indices, one atomic
    // a warp
    if (!drained) {
      const unsigned want = __ballot_sync(kFull, i < 0);
      if (want != 0u) {
        const unsigned n_want = __popc(want);
        unsigned long long base = 0;
        if (lane == 0) base = atomicAdd(next_ray, n_want);
        base = __shfl_sync(kFull, base, 0);
        drained = base + n_want >= static_cast<unsigned long long>(n_rays);
        const unsigned long long cand = base + __popc(want & below);
        if (i < 0 && cand < static_cast<unsigned long long>(n_rays)) {
          i = static_cast<int>(cand);
          ox = ro[3 * i];
          oy = ro[3 * i + 1];
          oz = ro[3 * i + 2];
          dx = rd[3 * i];
          dy = rd[3 * i + 1];
          dz = rd[3 * i + 2];
          tm = time_in[i];
          depth = 0;
          th_r = th_g = th_b = 1.f;
          ra_r = ra_g = ra_b = 0.f;
        }
      }
    }
    const bool has = i >= 0;
    if (__ballot_sync(kFull, has) == 0u) break;
    passes += 1;
    segs += has ? 1 : 0;

    // ---- sphere sweep (a lane without a ray, or with a non-finite time
    // in a moving scene, sweeps from a NaN origin: it hits nothing)
    const bool sweeps = has && (!kMotion || isfinite(tm));
    const float sx = sweeps ? ox : nan;
    const float ro_d = sx * dx + oy * dy + oz * dz;
    const float ro_ro = sx * sx + oy * oy + oz * oz;
    float best_t = kInf;
    int best_i = 0x7fffffff;
    for (int k = 0; k < s4; k += 4) {
      const float4 rr4 = reinterpret_cast<const float4*>(s_rr)[k >> 2];
      const float rr[4] = {rr4.x, rr4.y, rr4.z, rr4.w};
      float b[4], disc[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float4 p = s_p[k + u];
        b[u] = ro_d - (p.x * dx + p.y * dy + p.z * dz);
        const float c =
            ((ro_ro - 2.0f * (p.x * ox + p.y * oy + p.z * oz)) + p.w) -
            rr[u];
        disc[u] = b[u] * b[u] - c;
      }
      if (disc[0] > 0.0f || disc[1] > 0.0f || disc[2] > 0.0f ||
          disc[3] > 0.0f) {
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          take_root(b[u], disc[u], s_row[k + u], t_min, best_t, best_i);
        }
      }
    }
    if (kMotion) {
      for (int k = 0; k < m4; k += 4) {
        const float4 inv4 = reinterpret_cast<const float4*>(s_inv)[k >> 2];
        const float inv[4] = {inv4.x, inv4.y, inv4.z, inv4.w};
        float b[4], disc[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float4 c0 = s_c[k + u];
          const float4 m = s_d[k + u];
          const float s = (tm - m.w) * inv[u];
          const float cx = c0.x + s * m.x;
          const float cy = c0.y + s * m.y;
          const float cz = c0.z + s * m.z;
          b[u] = ro_d - (cx * dx + cy * dy + cz * dz);
          const float c = ((ro_ro - 2.0f * (cx * ox + cy * oy + cz * oz)) +
                           (cx * cx + cy * cy + cz * cz)) -
                          c0.w;
          disc[u] = b[u] * b[u] - c;
        }
        if (disc[0] > 0.0f || disc[1] > 0.0f || disc[2] > 0.0f ||
            disc[3] > 0.0f) {
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            take_root(b[u], disc[u], s_mrow[k + u], t_min, best_t, best_i);
          }
        }
      }
    }
    if (!has) continue;

    // ---- rect sweep
    float t = best_t;
    int rect_i = -1;
    if (n_rects > 0) {
      float rc_t = kInf;
      for (int j = 0; j < n_rects; ++j) {
        const float axis = s_rect[j];
        const bool is_x = axis == 0.0f, is_y = axis == 1.0f;
        const bool is_z = axis == 2.0f;
        const float o_n = is_x ? ox : (is_y ? oy : oz);
        float d_n = is_x ? dx : (is_y ? dy : dz);
        const float o_a = is_x ? oy : ox, d_a = is_x ? dy : dx;
        const float o_b = is_z ? oy : oz, d_b = is_z ? dy : dz;
        d_n = fabsf(d_n) < 1e-12f ? 1e-12f : d_n;
        const float tr = (s_rect[5 * n_rects + j] - o_n) / d_n;
        const float pa = o_a + tr * d_a;
        const float pb = o_b + tr * d_b;
        const bool ok = tr > t_min && pa >= s_rect[n_rects + j] &&
                        pa <= s_rect[2 * n_rects + j] &&
                        pb >= s_rect[3 * n_rects + j] &&
                        pb <= s_rect[4 * n_rects + j];
        if (ok && tr < rc_t) {
          rc_t = tr;
          rect_i = s_rrow[j];
        }
      }
      if (rc_t < t) {
        t = rc_t;
      } else {
        rect_i = -1;
      }
    }

    bool alive = true;
    const bool hit = t < kInf;
    if (!hit) {  // the sky, and the ray dies
      float sk_r = sky_r, sk_g = sky_g, sk_b = sky_b;
      if (sky_grad) {
        const float sky_t = 0.5f * (dy + 1.0f);
        sk_r = (1.0f - sky_t) + sky_t * 0.15f;
        sk_g = (1.0f - sky_t) + sky_t * 0.21f;
        sk_b = (1.0f - sky_t) + sky_t * 0.30f;
      }
      ra_r = ra_r + th_r * sk_r;
      ra_g = ra_g + th_g * sk_g;
      ra_b = ra_b + th_b * sk_b;
      alive = false;
    } else {
      const float px = ox + t * dx;
      const float py = oy + t * dy;
      const float pz = oz + t * dz;

      // ---- the winner: normal and shading row
      float nx, ny, nz;
      const float* sh;
      if (rect_i >= 0) {
        const float* row = rect + rect_i * kK;
        const float axis = row[0], flip = row[6];
        nx = axis == 0.0f ? flip : 0.0f;
        ny = axis == 1.0f ? flip : 0.0f;
        nz = axis == 2.0f ? flip : 0.0f;
        sh = row + kRectShade;
      } else {
        const float* row = sph + static_cast<long long>(best_i) * kK;
        float cx = row[0], cy = row[1], cz = row[2];
        if (kMotion) {
          const float s = (tm - row[6]) * row[7];
          cx = cx + s * row[3];
          cy = cy + s * row[4];
          cz = cz + s * row[5];
        }
        const float r = row[8];
        const float inv_r = 1.0f / (fabsf(r) < 1e-12f ? 1.0f : r);
        nx = (px - cx) * inv_r;
        ny = (py - cy) * inv_r;
        nz = (pz - cz) * inv_r;
        sh = row + kSphereShade;
      }

      // ---- albedo
      const float mat_kind = sh[0];
      const float tex_kind = sh[3];
      float tex_r = sh[4], tex_g = sh[5], tex_b = sh[6];
      if ((flags & FLAG_CHECKER) && tex_kind == TEX_CHECKER) {
        const float sines =
            sinf(10.0f * px) * sinf(10.0f * py) * sinf(10.0f * pz);
        const int base = sines < 0.0f ? 7 : 10;
        tex_r = sh[base];
        tex_g = sh[base + 1];
        tex_b = sh[base + 2];
      }
      if ((flags & FLAG_NOISE) && tex_kind == TEX_NOISE) {
        const float marble =
            0.5f * (1.0f + sinf(sh[13] * pz + 10.0f * fast_turb(px, py, pz)));
        tex_r = tex_g = tex_b = marble;
      }

      // ---- emission
      const bool is_light = mat_kind == MAT_DIFFUSE_LIGHT;
      if (is_light) {
        ra_r = ra_r + th_r * tex_r;
        ra_g = ra_g + th_g * tex_g;
        ra_b = ra_b + th_b * tex_b;
      }

      // ---- scatter
      const uint32_t lane_id = static_cast<uint32_t>(i);
      const uint32_t d = static_cast<uint32_t>(depth);
      const float u1 = counter_uniform(lane_id, seed, d, 0u);
      const float u2 = counter_uniform(lane_id, seed, d, 1u);
      const float u3 = counter_uniform(lane_id, seed, d, 2u);
      const float uc = counter_uniform(lane_id, seed, d, 3u);
      const float zz = u1 * 2.0f - 1.0f;
      const float aa = u2 * kTwoPi;
      const float rr = sqrtf(fmaxf(1.0f - zz * zz, 0.0f));
      const float uv_x = rr * cosf(aa);
      const float uv_y = rr * sinf(aa);
      const float uv_z = zz;

      const float rdotn = dx * nx + dy * ny + dz * nz;
      const float refl_x = dx - 2.0f * rdotn * nx;
      const float refl_y = dy - 2.0f * rdotn * ny;
      const float refl_z = dz - 2.0f * rdotn * nz;

      float nd_x = uv_x, nd_y = uv_y, nd_z = uv_z;
      bool ok = true;
      const bool is_diel =
          (flags & FLAG_DIELECTRIC) && mat_kind == MAT_DIELECTRIC;
      if (is_diel) {
        const float ref_idx = sh[2];
        const bool exiting = rdotn > 0.0f;
        const float on_x = exiting ? -nx : nx;
        const float on_y = exiting ? -ny : ny;
        const float on_z = exiting ? -nz : nz;
        const float ni = exiting ? ref_idx : 1.0f / ref_idx;
        const float cos_in = exiting ? rdotn : -rdotn;
        const float ces = 1.0f - ref_idx * ref_idx * (1.0f - cos_in * cos_in);
        const float cosine = exiting ? sqrtf(fmaxf(ces, 0.0f)) : cos_in;
        const float dt = dx * on_x + dy * on_y + dz * on_z;
        const float disc = 1.0f - ni * ni * (1.0f - dt * dt);
        const bool refr_ok = disc > 0.0f;
        const float sq = sqrtf(fmaxf(disc, 0.0f));
        float r0 = (1.0f - ref_idx) / (1.0f + ref_idx);
        r0 = r0 * r0;
        const float omc = 1.0f - cosine;
        const float omc2 = omc * omc;
        const float schlick = r0 + (1.0f - r0) * omc2 * omc2 * omc;
        const float reflect_prob = refr_ok ? schlick : 1.0f;
        if (uc > reflect_prob) {
          nd_x = ni * (dx - on_x * dt) - on_x * sq;
          nd_y = ni * (dy - on_y * dt) - on_y * sq;
          nd_z = ni * (dz - on_z * dt) - on_z * sq;
        } else {
          nd_x = refl_x;
          nd_y = refl_y;
          nd_z = refl_z;
        }
      } else if ((flags & FLAG_METAL) && mat_kind == MAT_METAL) {
        const float fr = sh[1] * cbrt_mk(u3);
        nd_x = refl_x + fr * uv_x;
        nd_y = refl_y + fr * uv_y;
        nd_z = refl_z + fr * uv_z;
        ok = refl_x * nx + refl_y * ny + refl_z * nz > 0.0f;
      } else if ((flags & FLAG_LAMBERTIAN) && mat_kind == MAT_LAMBERTIAN) {
        nd_x = nx + uv_x;
        nd_y = ny + uv_y;
        nd_z = nz + uv_z;
      }
      if ((flags & FLAG_LIGHT) && is_light) ok = false;  // lights never scatter
      if (!ok) {
        alive = false;
      } else {
        const float inv_len =
            rsqrtf(fmaxf(nd_x * nd_x + nd_y * nd_y + nd_z * nd_z, 1e-38f));
        if (!is_diel) {
          th_r = th_r * tex_r;
          th_g = th_g * tex_g;
          th_b = th_b * tex_b;
        }
        ox = px;
        oy = py;
        oz = pz;
        dx = nd_x * inv_len;
        dy = nd_y * inv_len;
        dz = nd_z * inv_len;
      }
    }
    depth += 1;
    if (!alive || depth > max_depth) {  // the ray ends: its radiance out
      out[3 * i] = ra_r;
      out[3 * i + 1] = ra_g;
      out[3 * i + 2] = ra_b;
      i = -1;
      ox = oy = oz = nan;
    }
  }

  // one add a warp: its segments and its lane-passes
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) segs += __shfl_down_sync(kFull, segs, o);
  if (lane == 0) {
    if (segs > 0) atomicAdd(segs_out, segs);
    atomicAdd(passes_out, 32ull * passes);
  }
}

}  // namespace

// The resident scene's shared bytes (also mirrored by the wrapper,
// megakernel.scene_shared_bytes), and the most a block may take on this
// card.
extern "C" long long pt_megakernel_shared_bytes(int n_static, int n_moving,
                                                int n_rects, int motion) {
  return static_cast<long long>(
      scene_bytes(n_static, n_moving, n_rects, motion != 0));
}

// ro, rd: [n_rays, 3]; time: [n_rays]; sph: [n_sph, 24]; rows: the
// resident sphere rows, n_static static ones then n_moving moving ones,
// each in increasing index (megakernel.prep_tables); rect: [128, 24] and
// rect_rows [n_rects], or NULL and 0 (no rects); sky4: rgb +
// use_gradient_sky; out: [n_rays, 3]; work: three zeroed uint64s, the
// segments, the lane-passes and the ray counter.
extern "C" int pt_megakernel(const float* ro, const float* rd,
                             const float* time, int n_rays, const float* sph,
                             const int* rows, int n_static, int n_moving,
                             const float* rect, const int* rect_rows,
                             int n_rects, const float* sky4, int seed,
                             int max_depth, int flags, float t_min,
                             float* out, unsigned long long* work,
                             cudaStream_t stream) {
  if (n_rays <= 0) return static_cast<int>(cudaGetLastError());
  const bool motion = (flags & FLAG_MOTION) != 0;
  const size_t smem = scene_bytes(n_static, n_moving, n_rects, motion);
  int device = 0, sms = 0, optin = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         device);
  if (smem > static_cast<size_t>(optin)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto kernel = motion ? megakernel<true> : megakernel<false>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads,
                                                    smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  // a persistent grid: every block resident, none without a first ray
  long long blocks = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  const long long wanted = (n_rays + kThreads - 1) / kThreads;
  if (blocks > wanted) blocks = wanted;
  kernel<<<static_cast<int>(blocks), kThreads, smem, stream>>>(
      ro, rd, time, n_rays, sph, rows, n_static, n_moving, rect, rect_rows,
      n_rects, sky4, static_cast<uint32_t>(seed), max_depth, flags, t_min,
      out, work);
  return static_cast<int>(cudaGetLastError());
}
