// Device helpers shared by the shading kernels (shade.cu, K2, and
// megakernel.cu, K7): the scene codes, the counter-hash RNG and the hash
// noise, each bit-exact with the JAX package's
// (pathtrace_tpu/ops/fastpath.py counter_uniform, _hash3, fast_noise_c,
// fast_turb_c; the same functions in pathtrace_tpu/ops/megakernel.py).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace pt {

constexpr float kInf = 3.402823466e38f;  // MAX_T (f32 max)
constexpr float kTwoPi = 6.283185307179586f;

// feature flags: one runtime bitmask, uniform across a launch
// (FLAG_* in pathtrace_tpu_torch/ops/shade_kernel.py)
constexpr int FLAG_CHECKER = 1;
constexpr int FLAG_NOISE = 2;
constexpr int FLAG_LAMBERTIAN = 4;
constexpr int FLAG_METAL = 8;
constexpr int FLAG_DIELECTRIC = 16;
constexpr int FLAG_LIGHT = 32;
constexpr int FLAG_MOTION = 64;
constexpr int FLAG_RECT = 128;
constexpr int FLAG_EMIT_SCALE = 256;
constexpr int FLAG_BOX = 512;
constexpr int FLAG_MEDIUM = 1024;
constexpr int FLAG_IMAGE = 2048;

// material and texture kinds, as the attribute tables store them (f32)
constexpr float MAT_LAMBERTIAN = 0.f;
constexpr float MAT_METAL = 1.f;
constexpr float MAT_DIELECTRIC = 2.f;
constexpr float MAT_DIFFUSE_LIGHT = 3.f;
constexpr float TEX_CHECKER = 1.f;
constexpr float TEX_NOISE = 2.f;
constexpr float TEX_IMAGE = 3.f;
// primitive kinds at column 14 of a row
constexpr float KIND_RECT = 1.f;
constexpr float KIND_BOX = 2.f;
constexpr float KIND_MEDIUM = 3.f;

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

// hash3's lattice constants: the hash of the corner (ix, iy, iz) mixes
// kHashX * ix + kHashY * iy + kHashZ * iz (mod 2^32)
constexpr uint32_t kHashX = 374761393u;
constexpr uint32_t kHashY = 668265263u;
constexpr uint32_t kHashZ = 1103515245u;

// hash3 after its lattice sum s = kHashX * ix + kHashY * iy + kHashZ * iz
__device__ __forceinline__ uint32_t hash_mix(uint32_t s) {
  s = s ^ (s >> 13);
  s = s * 1274126177u;
  return s ^ (s >> 16);
}

// The reference's unit float(h >> 8) * 2^-23 - 1 (fastpath.py _hash_unit)
// in one rounding: v = h >> 8 < 2^24 converts exactly, and v 2^-23 - 1, a
// multiple of 2^-23 of magnitude at most 1, is a float, so the FMA returns
// it exactly, as the reference's exact product and exact difference do:
// the same bits for every h (tests/test_torch_noise_rule.py runs all 2^24
// values of v), one instruction fewer than the product and the difference.
__device__ __forceinline__ float hash_unit(uint32_t h) {
  return __fmaf_rn(__uint2float_rn(h >> 8), 0x1p-23f, -1.0f);
}

// One octave of the hash noise: fastpath.py fast_noise_c, operation for
// operation where floats round, with its integer work shared across the
// eight corners.
// - floor: __float2int_rd(x) is (int32) floorf(x) for every float x (both
//   exact in range, both saturate alike, NaN gives 0), one conversion.
// - hash3 (ix + di, iy + dj, iz + dk) mixes kHashX (ix + di) + ... mod
//   2^32, and kHashX (ix + 1) = kHashX ix + kHashX: two terms an axis, six
//   an octave, then one three-way add a corner.
// - u - di: u - 0 is u, and u - 1 is computed once; the weight product
//   wu * wv * wwk * dot rounds left to right, so wu * wv is shared by the
//   two corners that differ in dk.
__device__ inline float fast_noise(float px, float py, float pz) {
  const float fx = floorf(px), fy = floorf(py), fz = floorf(pz);
  const uint32_t ix = static_cast<uint32_t>(__float2int_rd(px));
  const uint32_t iy = static_cast<uint32_t>(__float2int_rd(py));
  const uint32_t iz = static_cast<uint32_t>(__float2int_rd(pz));
  const float u = px - fx, v = py - fy, w = pz - fz;
  const float uu = u * u * (3.0f - 2.0f * u);
  const float vv = v * v * (3.0f - 2.0f * v);
  const float ww = w * w * (3.0f - 2.0f * w);
  const float off_u[2] = {u, u - 1.0f};
  const float off_v[2] = {v, v - 1.0f};
  const float off_w[2] = {w, w - 1.0f};
  const float wt_u[2] = {1.0f - uu, uu};
  const float wt_v[2] = {1.0f - vv, vv};
  const float wt_w[2] = {1.0f - ww, ww};
  const uint32_t hx0 = ix * kHashX, hy0 = iy * kHashY, hz0 = iz * kHashZ;
  const uint32_t hx[2] = {hx0, hx0 + kHashX};
  const uint32_t hy[2] = {hy0, hy0 + kHashY};
  const uint32_t hz[2] = {hz0, hz0 + kHashZ};
  float accum = 0.0f;
#pragma unroll
  for (int di = 0; di < 2; ++di) {
#pragma unroll
    for (int dj = 0; dj < 2; ++dj) {
      const float wuv = wt_u[di] * wt_v[dj];
#pragma unroll
      for (int dk = 0; dk < 2; ++dk) {
        const uint32_t h = hash_mix(hx[di] + hy[dj] + hz[dk]);
        const float gx = hash_unit(h);
        const float gy = hash_unit(h * 1664525u + 1013904223u);
        const float gz = hash_unit(h * 22695477u + 1u);
        const float dot = gx * off_u[di] + gy * off_v[dj] + gz * off_w[dk];
        accum = accum + wuv * wt_w[dk] * dot;
      }
    }
  }
  return accum;
}

__device__ inline float fast_turb(float px, float py, float pz) {
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

}  // namespace pt
