// K7, the megakernel: a ray's whole bounce loop in one kernel, one thread
// per ray (Hopper, sm_90a).
//
// Replaces the TPU kernel pathtrace_tpu/ops/megakernel.py _make_kernel.
// There a grid step ran the loop for a 64-ray block with the scene's
// attribute tables resident in VMEM, picked each ray's winner attributes
// with a one-hot matrix product (the TPU's stand-in for a gather) and
// stopped a block once none of its rays was alive. Here a block of 128
// threads runs the same loop, block-uniform: each pass starts with
// __syncthreads_count(alive), which both ends the block's loop when no ray
// is alive (the per-block early exit) and counts the pass's segments. A
// thread whose ray is dead, or beyond the last ray, stays in the loop as a
// non-writer: it helps load the tiles and reaches every barrier.
//
// Per pass and ray:
// * the sphere sweep: the geometry streams through shared memory in tiles
//   of 128 spheres, (cx, cy, cz, r) and with motion (dx, dy, dz, time0,
//   inv_dt); every thread of a block reads the same sphere at once (a
//   broadcast). The quadratic is the megakernel's own, from the (lerped)
//   centre: b = ro.d - c.d, c = ((|ro|^2 - 2 c.ro) + |c|^2) - r^2. Dead
//   and padding rows (cx = 1e18) are swept like live ones, as the TPU
//   kernel sweeps them. Spheres in increasing index with a strict `<`:
//   the TPU's tie rule (first index within a tile, strict `<` across);
// * the rect sweep (with rects): the 128 x 7 rect geometry stays resident
//   in shared memory; a rect beats the sphere winner only when strictly
//   nearer;
// * the winner's 14 shading floats read by index from the [N, 24] table in
//   device memory (L2-resident), then albedo (constant, checker, hash-
//   turbulence marble), emission or sky into the radiance, counter-hash
//   draws 0-3 keyed on the global ray index, and the Lambertian / metal /
//   dielectric scatter; a ray dies on a miss, on a light and on a metal
//   reflection below the horizon.
//
// What bounds it: fp32 arithmetic. About 25 operations per (live segment,
// sphere) pair (31 with motion) and a few hundred of shading per segment,
// against 28 bytes in and 12 out per ray. The design gives up the
// wavefront's compaction: a warp sweeps every sphere for as long as its
// longest-lived ray lives.
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

constexpr int kThreads = 128;  // rays per block
constexpr int kTile = 128;     // spheres per shared-memory tile (= kThreads)
constexpr int kRects = 128;    // rows of the rect table
constexpr int kK = 24;         // floats per table row
constexpr int kSphereShade = 9;  // first shading column of a sphere row
constexpr int kRectShade = 7;    // first shading column of a rect row

__device__ __forceinline__ float cbrt_mk(float x) {
  return expf(logf(fmaxf(x, 1e-30f)) * (1.0f / 3.0f));
}

template <bool kMotion>
__global__ void __launch_bounds__(kThreads)
megakernel(const float* __restrict__ ro, const float* __restrict__ rd,
           const float* __restrict__ time_in, int n_rays,
           const float* __restrict__ sph, int n_sph,
           const float* __restrict__ rect, const float* __restrict__ sky4,
           uint32_t seed, int max_depth, int flags, float t_min,
           float* __restrict__ out, unsigned long long* __restrict__ segs) {
  // sphere tile: cx, cy, cz, r, then dx, dy, dz, time0, inv_dt with motion
  __shared__ float s_sph[kMotion ? 9 : 4][kTile];
  // rect geometry: axis, a0, a1, b0, b1, k (flip is read with the winner)
  __shared__ float s_rect[6][kRects];

  const int tid = threadIdx.x;
  const int i = blockIdx.x * kThreads + tid;
  const bool live = i < n_rays;
  const bool has_rects = rect != nullptr;
  float ox = 0.f, oy = 0.f, oz = 0.f, dx = 0.f, dy = 0.f, dz = 0.f;
  float tm = 0.f;
  if (live) {
    ox = ro[3 * i];
    oy = ro[3 * i + 1];
    oz = ro[3 * i + 2];
    dx = rd[3 * i];
    dy = rd[3 * i + 1];
    dz = rd[3 * i + 2];
    tm = time_in[i];
  }
  if (has_rects) {
    for (int j = tid; j < kRects; j += kThreads) {
#pragma unroll
      for (int k = 0; k < 6; ++k) s_rect[k][j] = rect[j * kK + k];
    }
  }
  const float sky_r = sky4[0], sky_g = sky4[1], sky_b = sky4[2];
  const bool sky_grad = sky4[3] > 0.5f;
  const uint32_t lane = static_cast<uint32_t>(i);

  float th_r = 1.f, th_g = 1.f, th_b = 1.f;
  float ra_r = 0.f, ra_g = 0.f, ra_b = 0.f;
  bool alive = live;
  long long block_segs = 0;

  for (int depth = 0; depth <= max_depth; ++depth) {
    // the block's loop test and its segment count in one barrier (which
    // also orders the rect table's loads before their first use)
    const int n_alive = __syncthreads_count(alive);
    if (n_alive == 0) break;
    block_segs += n_alive;

    // ---- sphere sweep
    const float ro_d = ox * dx + oy * dy + oz * dz;
    const float ro_ro = ox * ox + oy * oy + oz * oz;
    float best_t = kInf;
    int best_i = -1;
    for (int base = 0; base < n_sph; base += kTile) {
      __syncthreads();
      {
        const float* row = sph + static_cast<long long>(base + tid) * kK;
        s_sph[0][tid] = row[0];
        s_sph[1][tid] = row[1];
        s_sph[2][tid] = row[2];
        s_sph[3][tid] = row[8];
        if (kMotion) {
          s_sph[4][tid] = row[3];
          s_sph[5][tid] = row[4];
          s_sph[6][tid] = row[5];
          s_sph[7][tid] = row[6];
          s_sph[8][tid] = row[7];
        }
      }
      __syncthreads();
      if (!alive) continue;
      for (int j = 0; j < kTile; ++j) {
        float cx = s_sph[0][j], cy = s_sph[1][j], cz = s_sph[2][j];
        if (kMotion) {
          const float s = (tm - s_sph[7][j]) * s_sph[8][j];
          cx = cx + s * s_sph[4][j];
          cy = cy + s * s_sph[5][j];
          cz = cz + s * s_sph[6][j];
        }
        const float r = s_sph[3][j];
        const float b = ro_d - (cx * dx + cy * dy + cz * dz);
        const float c = ((ro_ro - 2.0f * (cx * ox + cy * oy + cz * oz)) +
                         (cx * cx + cy * cy + cz * cz)) -
                        r * r;
        const float disc = b * b - c;
        if (!(disc > 0.0f)) continue;
        const float sq = sqrtf(disc);
        const float t0 = -b - sq;
        const float t1 = -b + sq;
        float t = kInf;
        if (t0 > t_min) {
          t = t0;
        } else if (t1 > t_min) {
          t = t1;
        }
        if (t < best_t) {
          best_t = t;
          best_i = base + j;
        }
      }
    }
    if (!alive) continue;

    // ---- rect sweep
    float t = best_t;
    int rect_i = -1;
    if (has_rects) {
      float rc_t = kInf;
      for (int j = 0; j < kRects; ++j) {
        const float axis = s_rect[0][j];
        const bool is_x = axis == 0.0f, is_y = axis == 1.0f;
        const bool is_z = axis == 2.0f;
        const float o_n = is_x ? ox : (is_y ? oy : oz);
        float d_n = is_x ? dx : (is_y ? dy : dz);
        const float o_a = is_x ? oy : ox, d_a = is_x ? dy : dx;
        const float o_b = is_z ? oy : oz, d_b = is_z ? dy : dz;
        d_n = fabsf(d_n) < 1e-12f ? 1e-12f : d_n;
        const float tr = (s_rect[5][j] - o_n) / d_n;
        const float pa = o_a + tr * d_a;
        const float pb = o_b + tr * d_b;
        const bool ok = tr > t_min && pa >= s_rect[1][j] &&
                        pa <= s_rect[2][j] && pb >= s_rect[3][j] &&
                        pb <= s_rect[4][j];
        if (ok && tr < rc_t) {
          rc_t = tr;
          rect_i = j;
        }
      }
      if (rc_t < t) {
        t = rc_t;
      } else {
        rect_i = -1;
      }
    }

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
      continue;
    }
    const float px = ox + t * dx;
    const float py = oy + t * dy;
    const float pz = oz + t * dz;

    // ---- the winner: normal and shading row
    float nx, ny, nz;
    const float* sh;
    if (rect_i >= 0) {
      const float* row = rect + rect_i * kK;
      const float axis = s_rect[0][rect_i], flip = row[6];
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
    const uint32_t d = static_cast<uint32_t>(depth);
    const float u1 = counter_uniform(lane, seed, d, 0u);
    const float u2 = counter_uniform(lane, seed, d, 1u);
    const float u3 = counter_uniform(lane, seed, d, 2u);
    const float uc = counter_uniform(lane, seed, d, 3u);
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
      continue;
    }
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

  if (live) {
    out[3 * i] = ra_r;
    out[3 * i + 1] = ra_g;
    out[3 * i + 2] = ra_b;
  }
  if (tid == 0 && block_segs > 0) {
    atomicAdd(segs, static_cast<unsigned long long>(block_segs));
  }
}

}  // namespace

// ro, rd: [n_rays, 3]; time: [n_rays]; sph: [n_sph, 24], n_sph a multiple of
// 128; rect: [128, 24] or NULL (no rects); sky4: rgb + use_gradient_sky;
// out: [n_rays, 3]; segs: one int64, added to
extern "C" int pt_megakernel(const float* ro, const float* rd,
                             const float* time, int n_rays, const float* sph,
                             int n_sph, const float* rect, const float* sky4,
                             int seed, int max_depth, int flags, float t_min,
                             float* out, unsigned long long* segs,
                             cudaStream_t stream) {
  if (n_rays > 0) {
    const int blocks = (n_rays + kThreads - 1) / kThreads;
    const uint32_t s = static_cast<uint32_t>(seed);
    if (flags & FLAG_MOTION) {
      megakernel<true><<<blocks, kThreads, 0, stream>>>(
          ro, rd, time, n_rays, sph, n_sph, rect, sky4, s, max_depth, flags,
          t_min, out, segs);
    } else {
      megakernel<false><<<blocks, kThreads, 0, stream>>>(
          ro, rd, time, n_rays, sph, n_sph, rect, sky4, s, max_depth, flags,
          t_min, out, segs);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
