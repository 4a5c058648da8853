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

__device__ inline float fast_noise(float px, float py, float pz) {
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
