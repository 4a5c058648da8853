// Fused shade/scatter for one wavefront, one thread per lane (Hopper, sm_90a).
//
// Replaces the TPU kernel pathtrace_tpu/ops/shade_pallas.py _shade_kernel
// and the winner-row gather plus transpose that
// pathtrace_tpu/ops/fastpath.py _fused_shade_from_winners materialized in
// front of it ([R, 24] rows, then a (rows, 24, 128) cube). Here each
// thread reads its lane's winner row straight from the attribute table
// (512 x 24 floats for random_spheres, resident in L2), so no per-lane
// attribute copy ever reaches device memory.
//
// What bounds it: bytes. Per lane it reads 15 state planes, t and idx and
// the winner row (about 120 bytes from device memory) and writes 13
// planes, against a few hundred flops (more with the noise texture).
//
// The arithmetic follows the plain PyTorch version in
// pathtrace_tpu_torch/ops/shade_kernel.py operation for operation; built
// with -fmad=false, the + - * / sqrt results round identically. sinf,
// cosf, expf, logf and rsqrtf may differ from PyTorch's by a few ULPs.
//
// The feature flags are one runtime bitmask, uniform across the launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr float kInf = 3.402823466e38f;  // MAX_T (f32 max)
constexpr float kTwoPi = 6.283185307179586f;
constexpr int kGeo = 15;

constexpr int FLAG_CHECKER = 1;
constexpr int FLAG_NOISE = 2;
constexpr int FLAG_LAMBERTIAN = 4;
constexpr int FLAG_METAL = 8;
constexpr int FLAG_DIELECTRIC = 16;
constexpr int FLAG_LIGHT = 32;

constexpr float MAT_LAMBERTIAN = 0.f;
constexpr float MAT_METAL = 1.f;
constexpr float MAT_DIELECTRIC = 2.f;
constexpr float MAT_DIFFUSE_LIGHT = 3.f;
constexpr float TEX_CHECKER = 1.f;
constexpr float TEX_NOISE = 2.f;

// ---- counter-hash RNG and hash noise (bit-exact with the JAX package) ----

__device__ __forceinline__ uint32_t mix32(uint32_t h) {
  h = h ^ (h >> 16);
  h = h * 2146121005u;
  h = h ^ (h >> 15);
  h = h * 2654435769u;
  h = h ^ (h >> 13);
  return h;
}

__device__ __forceinline__ float counter_uniform(uint32_t lane, uint32_t seed,
                                                 uint32_t depth,
                                                 uint32_t draw) {
  uint32_t h = lane * 747796405u + seed * 2891336453u;
  h = h + depth * 1013904223u;
  h = h + draw * 374761393u;
  h = mix32(h);
  // (h >> 8) < 2^24: the int32 -> f32 conversion is exact
  return static_cast<float>(static_cast<int32_t>(h >> 8)) *
         (1.0f / 16777216.0f);
}

__device__ __forceinline__ uint32_t hash3(int32_t ix, int32_t iy,
                                          int32_t iz) {
  uint32_t h = static_cast<uint32_t>(ix) * 374761393u +
               static_cast<uint32_t>(iy) * 668265263u +
               static_cast<uint32_t>(iz) * 1103515245u;
  h = h ^ (h >> 13);
  h = h * 1274126177u;
  return h ^ (h >> 16);
}

__device__ __forceinline__ float hash_unit(uint32_t h) {
  return static_cast<float>(static_cast<int32_t>(h >> 8)) *
             (2.0f / 16777216.0f) -
         1.0f;
}

__device__ float fast_noise(float px, float py, float pz) {
  const float fx = floorf(px), fy = floorf(py), fz = floorf(pz);
  const int32_t ix = static_cast<int32_t>(fx);
  const int32_t iy = static_cast<int32_t>(fy);
  const int32_t iz = static_cast<int32_t>(fz);
  const float u = px - fx, v = py - fy, w = pz - fz;
  const float uu = u * u * (3.0f - 2.0f * u);
  const float vv = v * v * (3.0f - 2.0f * v);
  const float ww = w * w * (3.0f - 2.0f * w);
  float accum = 0.0f;
#pragma unroll
  for (int di = 0; di < 2; ++di) {
    const float wu = di ? uu : (1.0f - uu);
#pragma unroll
    for (int dj = 0; dj < 2; ++dj) {
      const float wv = dj ? vv : (1.0f - vv);
#pragma unroll
      for (int dk = 0; dk < 2; ++dk) {
        const float wwk = dk ? ww : (1.0f - ww);
        const uint32_t h = hash3(ix + di, iy + dj, iz + dk);
        const float gx = hash_unit(h);
        const float gy = hash_unit(h * 1664525u + 1013904223u);
        const float gz = hash_unit(h * 22695477u + 1u);
        const float dot = gx * (u - static_cast<float>(di)) +
                          gy * (v - static_cast<float>(dj)) +
                          gz * (w - static_cast<float>(dk));
        accum = accum + wu * wv * wwk * dot;
      }
    }
  }
  return accum;
}

__device__ float fast_turb(float px, float py, float pz) {
  float accum = 0.0f;
  float weight = 1.0f;
  for (int o = 0; o < 7; ++o) {
    accum = accum + weight * fast_noise(px, py, pz);
    weight *= 0.5f;
    px = px * 2.0f;
    py = py * 2.0f;
    pz = pz * 2.0f;
  }
  return fabsf(accum);
}

__device__ __forceinline__ float cbrt_pos(float x) {
  return expf(logf(fmaxf(x, 1e-38f)) * (1.0f / 3.0f));
}

__global__ void __launch_bounds__(kThreads)
shade_kernel(const float* __restrict__ table, int k_attr,
             const int* __restrict__ idx, const float* __restrict__ t_in,
             const float* __restrict__ planes, long long pstride,
             const float* __restrict__ time_in,
             const bool* __restrict__ alive_in,
             const int32_t* __restrict__ lane_in, int n, uint32_t seed,
             int depth, int max_depth, const float* __restrict__ sky4,
             int flags, float* __restrict__ out, bool* __restrict__ alive_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  (void)time_in;  // moving spheres are not in this kernel yet

  const float* a = table + static_cast<long long>(idx[i]) * k_attr;
  const float t = t_in[i];
  const float rox = planes[i], roy = planes[pstride + i],
              roz = planes[2 * pstride + i];
  const float rdx = planes[3 * pstride + i], rdy = planes[4 * pstride + i],
              rdz = planes[5 * pstride + i];
  const float rad[3] = {planes[6 * pstride + i], planes[7 * pstride + i],
                        planes[8 * pstride + i]};
  const float thr[3] = {planes[9 * pstride + i], planes[10 * pstride + i],
                        planes[11 * pstride + i]};
  const bool alive = alive_in[i];
  const float alive_f = alive ? 1.0f : 0.0f;
  const uint32_t lane = static_cast<uint32_t>(lane_in[i]);

  const bool hit = t < kInf;
  const float t_safe = hit ? t : 0.0f;
  const float px = rox + t_safe * rdx;
  const float py = roy + t_safe * rdy;
  const float pz = roz + t_safe * rdz;
  const float r = a[kGeo + 8];
  const float inv_r = 1.0f / (fabsf(r) < 1e-12f ? 1.0f : r);
  const float nx = (px - a[kGeo]) * inv_r;
  const float ny = (py - a[kGeo + 1]) * inv_r;
  const float nz = (pz - a[kGeo + 2]) * inv_r;

  const float tex_kind = a[3];
  float rgb[3] = {a[4], a[5], a[6]};
  if ((flags & FLAG_CHECKER) && tex_kind == TEX_CHECKER) {
    const float sines = sinf(10.0f * px) * sinf(10.0f * py) * sinf(10.0f * pz);
    const int base = sines < 0.0f ? 7 : 10;
    rgb[0] = a[base];
    rgb[1] = a[base + 1];
    rgb[2] = a[base + 2];
  }
  if ((flags & FLAG_NOISE) && tex_kind == TEX_NOISE) {
    const float marble =
        0.5f * (1.0f + sinf(a[13] * pz + 10.0f * fast_turb(px, py, pz)));
    rgb[0] = rgb[1] = rgb[2] = marble;
  }

  const float mat_kind = a[0];
  const bool is_light = mat_kind == MAT_DIFFUSE_LIGHT;
  const float sky_t = 0.5f * (rdy + 1.0f);
  const bool use_grad = sky4[3] > 0.5f;
  const float grad_k[3] = {0.15f, 0.21f, 0.30f};
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float grad_c = (1.0f - sky_t) + sky_t * grad_k[c];
    const float sky_c = use_grad ? grad_c : sky4[c];
    const float prim_c = is_light ? rgb[c] : 0.0f;
    const float emit_c = hit ? prim_c : sky_c;
    out[(6 + c) * static_cast<long long>(n) + i] =
        rad[c] + thr[c] * emit_c * alive_f;
  }

  const uint32_t d = static_cast<uint32_t>(depth);
  const float u1 = counter_uniform(lane, seed, d, 0u);
  const float u2 = counter_uniform(lane, seed, d, 1u);
  const float u3 = counter_uniform(lane, seed, d, 2u);
  const float uc = counter_uniform(lane, seed, d, 3u);
  const float zz = u1 * 2.0f - 1.0f;
  const float aa = u2 * kTwoPi;
  const float rr = sqrtf(fmaxf(1.0f - zz * zz, 0.0f));
  const float ux = rr * cosf(aa);
  const float uy = rr * sinf(aa);
  const float uz = zz;

  const float rdotn = rdx * nx + rdy * ny + rdz * nz;
  const float refl_x = rdx - 2.0f * rdotn * nx;
  const float refl_y = rdy - 2.0f * rdotn * ny;
  const float refl_z = rdz - 2.0f * rdotn * nz;

  float dir_x = ux, dir_y = uy, dir_z = uz;
  bool ok = true;
  const bool is_diel = (flags & FLAG_DIELECTRIC) && mat_kind == MAT_DIELECTRIC;
  if (is_diel) {
    const float ref_idx = a[2];
    const bool exiting = rdotn > 0.0f;
    const float sgn = exiting ? -1.0f : 1.0f;
    const float ox = sgn * nx, oy = sgn * ny, oz = sgn * nz;
    const float ni = exiting ? ref_idx : 1.0f / ref_idx;
    const float cos_in = exiting ? rdotn : -rdotn;
    const float ces = 1.0f - ref_idx * ref_idx * (1.0f - cos_in * cos_in);
    const float cosine = exiting ? sqrtf(ces > 0.0f ? ces : 1.0f) : cos_in;
    const float dt = rdx * ox + rdy * oy + rdz * oz;
    const float disc = 1.0f - ni * ni * (1.0f - dt * dt);
    const bool refr_ok = disc > 0.0f;
    const float sq = sqrtf(refr_ok ? disc : 1.0f);
    float r0 = (1.0f - ref_idx) / (1.0f + ref_idx);
    r0 = r0 * r0;
    const float omc = 1.0f - cosine;
    const float omc2 = omc * omc;
    const float schlick = r0 + (1.0f - r0) * omc2 * omc2 * omc;
    const float reflect_prob = refr_ok ? schlick : 1.0f;
    if (uc > reflect_prob) {
      dir_x = ni * (rdx - ox * dt) - ox * sq;
      dir_y = ni * (rdy - oy * dt) - oy * sq;
      dir_z = ni * (rdz - oz * dt) - oz * sq;
    } else {
      dir_x = refl_x;
      dir_y = refl_y;
      dir_z = refl_z;
    }
  } else if ((flags & FLAG_METAL) && mat_kind == MAT_METAL) {
    const float fr = a[1] * cbrt_pos(u3);
    dir_x = refl_x + fr * ux;
    dir_y = refl_y + fr * uy;
    dir_z = refl_z + fr * uz;
    ok = rdotn < 0.0f;
  } else if ((flags & FLAG_LAMBERTIAN) && mat_kind == MAT_LAMBERTIAN) {
    dir_x = nx + ux;
    dir_y = ny + uy;
    dir_z = nz + uz;
  }
  if ((flags & FLAG_LIGHT) && is_light) ok = false;  // lights never scatter

  const float inv_len =
      rsqrtf(fmaxf(dir_x * dir_x + dir_y * dir_y + dir_z * dir_z, 1e-38f));
  dir_x = dir_x * inv_len;
  dir_y = dir_y * inv_len;
  dir_z = dir_z * inv_len;

  const bool can = alive && hit && ok && depth < max_depth;
  const long long s = n;
  out[i] = can ? px : rox;
  out[s + i] = can ? py : roy;
  out[2 * s + i] = can ? pz : roz;
  out[3 * s + i] = can ? dir_x : rdx;
  out[4 * s + i] = can ? dir_y : rdy;
  out[5 * s + i] = can ? dir_z : rdz;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float atten = is_diel ? 1.0f : rgb[c];
    out[(9 + c) * s + i] = can ? thr[c] * atten : thr[c];
  }
  alive_out[i] = can;
}

}  // namespace

extern "C" int pt_shade_from_winners(
    const float* table, int k_attr, const int* idx,
    const float* t, const float* planes, long long plane_stride,
    const float* time, const bool* alive, const int32_t* lane, int n,
    int seed, int depth, int max_depth, const float* sky4, int flags,
    float* planes_out, bool* alive_out, cudaStream_t stream) {
  if (n > 0) {
    const int blocks = (n + kThreads - 1) / kThreads;
    shade_kernel<<<blocks, kThreads, 0, stream>>>(
        table, k_attr, idx, t, planes, plane_stride, time, alive, lane, n,
        static_cast<uint32_t>(seed), depth, max_depth, sky4, flags,
        planes_out, alive_out);
  }
  return static_cast<int>(cudaGetLastError());
}
