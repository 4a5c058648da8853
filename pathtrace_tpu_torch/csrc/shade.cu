// Fused shade/scatter for one wavefront, one thread per lane (Hopper, sm_90a).
//
// Replaces the TPU kernel pathtrace_tpu/ops/shade_pallas.py _shade_kernel
// and the winner-row gather plus transpose that
// pathtrace_tpu/ops/fastpath.py _fused_shade_from_winners materialized in
// front of it ([R, 24] rows, then a (rows, 24, 128) cube). Here each
// thread reads its lane's winner row straight from the attribute table
// (512 x 24 floats for random_spheres, resident in L2), so no per-lane
// attribute copy ever reaches device memory. With FLAG_MOTION the sphere
// normal comes from the centre lerped to the lane's time,
// c = c0 + ((time - time0) * inv_dt) * delta (shade_pallas.py:137-141).
// With FLAG_RECT a winner row of kind 1 (a rect, from the rect block of the
// table) takes the normal onehot(axis) * flip, not turned to face the ray
// (shade_pallas.py:146-152). With FLAG_BOX a winner row of kind 2 (a
// transformed box, 48-column rows) takes its face normal: the slab test
// redone in object space from the row's obj_from_world columns, the entry
// or exit face picked by |t - t_enter| < 1e-4 max(|t|, 1), signed against
// the ray and mapped back through world_from_obj (shade_pallas.py:153-204).
// With FLAG_MEDIUM a row of kind 3 (a medium) takes (1, 0, 0), which the
// isotropic scatter ignores (:205-210); its material falls to the default
// scatter, the unit-sphere direction. With FLAG_EMIT_SCALE (next-event
// estimation) the primitive emission, never the sky, is scaled by the
// lane's MIS weight, the 13th state plane (shade_pallas.py:109-115,
// 250-251); the
// kernel then also copies that plane through and writes the normal and
// the albedo it computed, six planes the estimator's tail reads instead of
// recomputing them (the 7-octave noise above all).
//
// With FLAG_IMAGE (28-column rows, whose last three columns are the atlas
// entry of the row's texture: y-offset, height, width) a lane whose
// winner texture is an image (kind 3) takes the texel at its UV as its
// albedo, after the checker and the noise (shade_pallas.py:231-236). The
// reference computes that UV and gathers the texel in an XLA pre-pass
// (fastpath.py _image_rgb_planes, ~40 element-wise ops a bounce) because a
// Pallas TPU kernel cannot gather; here the thread does both: the sphere UV
// from (p - c) * inv_r (the lerped centre under FLAG_MOTION), a rect row's
// in-plane fractions under FLAG_RECT (no flip), ii = int(u w), jj =
// int((1 - v) h - 0.001), each clamped into its image (a NaN or an
// out-of-range product cannot index outside it), then one read. The atlas
// stays in the builder's [H, W, 3] layout, so a texel is one 12-byte row:
// neighbouring lanes hit neighbouring texels, and three reads of one row
// touch one or two 32-byte sectors where the reference's [3, H*W] planes
// (chosen against the TPU's 128x padding of a minor dimension of 3) would
// touch three. The earth atlas, 256 x 512 x 3 floats (1.5 MB), stays in L2.
//
// What bounds it: bytes. Per lane it reads 15 state planes, t and idx and
// the winner row (about 120 bytes from device memory; the table itself,
// a few hundred rows, stays in L2) and writes 13 planes, against a few
// hundred flops (more with the noise texture, ~100 more for a box
// winner, ~60 and an atan2 and an asin for an image lane); with
// FLAG_EMIT_SCALE one plane more in and seven more out; with FLAG_IMAGE
// 16 bytes more of row and 12 of texel for an image lane.
//
// The arithmetic follows the plain PyTorch version in
// pathtrace_tpu_torch/ops/shade_kernel.py operation for operation; built
// with -fmad=false, the + - * / sqrt results round identically. sinf,
// cosf, expf, logf, rsqrtf, atan2f and asinf may differ from PyTorch's by
// a few ULPs; a texel index truncates the UV, so such a ULP on a texel
// boundary picks the neighbouring texel. The UV constants are the
// reference's (3.14159265, 1.5707963, 0.5 / 3.14159265, 1.0 / 3.14159265),
// each a double rounded once to float, as Python scalars are.
//
// The feature flags are one runtime bitmask, uniform across the launch.

#include <cuda_runtime.h>
#include <stdint.h>

#include "pt_device.cuh"

namespace {

using namespace pt;

constexpr int kThreads = 256;
constexpr int kGeo = 15;
constexpr float kUvPi = static_cast<float>(3.14159265);
constexpr float kUvHalfPi = static_cast<float>(1.5707963);
constexpr float kUvInvTwoPi = static_cast<float>(0.5 / 3.14159265);
constexpr float kUvInvPi = static_cast<float>(1.0 / 3.14159265);
constexpr float kUvBias = static_cast<float>(0.001);

__device__ __forceinline__ float cbrt_pos(float x) {
  return expf(logf(fmaxf(x, 1e-38f)) * (1.0f / 3.0f));
}

// jnp.sign / torch.sign: 0 for a zero (copysignf would give +-1)
__device__ __forceinline__ float sign_of(float x) {
  return static_cast<float>((x > 0.0f) - (x < 0.0f));
}

// int(x) truncated toward zero and clamped to [0, max(size - 1, 0)]; x is
// first held to [-1, size] (fmaxf drops a NaN for -1), so the conversion
// never leaves int32 (shade_kernel.py _trunc_clamp)
__device__ __forceinline__ int trunc_clamp(float x, float size) {
  const float v = fminf(fmaxf(x, -1.0f), size);
  const int hi = max(static_cast<int>(size) - 1, 0);
  return min(max(static_cast<int>(v), 0), hi);
}

// The texel of an image winner whose row is ``a`` (k_attr columns, the
// atlas entry in the last three) hit at (px, py, pz); (snx, sny) is the
// sphere normal's x and y from the row's (lerped) centre, computed for
// every kind. The twin of image_texel_index in shade_kernel.py.
__device__ __forceinline__ void image_texel(
    const float* a, int k_attr, float px, float py, float pz, float snx,
    float sny, int flags, const float* __restrict__ atlas, int atlas_w,
    float rgb[3]) {
  const float phi = atan2f(snx, sny);
  const float ny_c = sny < -1.0f ? -1.0f : (sny > 1.0f ? 1.0f : sny);
  const float theta = asinf(ny_c);
  float uu = 1.0f - (phi + kUvPi) * kUvInvTwoPi;
  float vv = (theta + kUvHalfPi) * kUvInvPi;
  if ((flags & FLAG_RECT) && a[kGeo - 1] == KIND_RECT) {
    const int axis = static_cast<int>(a[kGeo]);
    const float pa = axis == 0 ? py : px;
    const float pb = axis == 2 ? py : pz;
    const float a0 = a[kGeo + 1], a1 = a[kGeo + 2];
    const float b0 = a[kGeo + 3], b1 = a[kGeo + 4];
    float da = a1 - a0;
    float db = b1 - b0;
    da = fabsf(da) < 1e-12f ? 1.0f : da;
    db = fabsf(db) < 1e-12f ? 1.0f : db;
    uu = (pa - a0) / da;
    vv = (pb - b0) / db;
  }
  const float img_y = a[k_attr - 3], img_h = a[k_attr - 2],
              img_w = a[k_attr - 1];
  const int ii = trunc_clamp(uu * img_w, img_w);
  const int jj = trunc_clamp((1.0f - vv) * img_h - kUvBias, img_h);
  const long long flat =
      (static_cast<long long>(static_cast<int>(img_y) + jj)) * atlas_w + ii;
  const float* texel = atlas + flat * 3;
  rgb[0] = texel[0];
  rgb[1] = texel[1];
  rgb[2] = texel[2];
}

// The normal of a box winner whose row is ``a`` (48 columns: p0, p1 at
// kGeo, obj_from_world 3x4 row-major at kGeo + 6, world_from_obj's linear
// part 3x3 row-major at kGeo + 18), hit at t_safe along (ro, rd).
__device__ __forceinline__ void box_normal(const float* a, float rox,
                                           float roy, float roz, float rdx,
                                           float rdy, float rdz,
                                           float t_safe, float n[3]) {
  float ro_o[3], rd_o[3], tn[3], tf[3];
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    const float* m = a + kGeo + 6 + r * 4;
    ro_o[r] = m[0] * rox + m[1] * roy + m[2] * roz + m[3];
    const float d = m[0] * rdx + m[1] * rdy + m[2] * rdz;
    // small negatives become +1e-12 too, as in the reference
    rd_o[r] = fabsf(d) < 1e-12f ? 1e-12f : d;
  }
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    const float rcp = 1.0f / rd_o[r];
    const float d0 = (a[kGeo + r] - ro_o[r]) * rcp;
    const float d1 = (a[kGeo + 3 + r] - ro_o[r]) * rcp;
    tn[r] = fminf(d0, d1);
    tf[r] = fmaxf(d0, d1);
  }
  const float t_enter = fmaxf(fmaxf(tn[0], tn[1]), tn[2]);
  // first-max / first-min axes, as argmax / argmin
  int enter_axis = tn[1] > tn[0] ? 1 : 0;
  if (tn[2] > fmaxf(tn[0], tn[1])) enter_axis = 2;
  int exit_axis = tf[1] < tf[0] ? 1 : 0;
  if (tf[2] < fminf(tf[0], tf[1])) exit_axis = 2;
  const bool is_entry =
      fabsf(t_safe - t_enter) < 1e-4f * fmaxf(fabsf(t_safe), 1.0f);
  const int face = is_entry ? enter_axis : exit_axis;
  float fa[3];
#pragma unroll
  for (int r = 0; r < 3; ++r) fa[r] = face == r ? 1.0f : 0.0f;
  const float rd_sel = fa[0] * rd_o[0] + fa[1] * rd_o[1] + fa[2] * rd_o[2];
  const float sign_d = sign_of(rd_sel);
  const float n_sign = is_entry ? -sign_d : sign_d;
  float n_obj[3];
#pragma unroll
  for (int r = 0; r < 3; ++r) n_obj[r] = fa[r] * n_sign;
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    const float* w = a + kGeo + 18 + r * 3;
    n[r] = w[0] * n_obj[0] + w[1] * n_obj[1] + w[2] * n_obj[2];
  }
}

__global__ void __launch_bounds__(kThreads)
shade_kernel(const float* __restrict__ table, int k_attr,
             const float* __restrict__ atlas, int atlas_w,
             const int* __restrict__ idx, const float* __restrict__ t_in,
             const float* __restrict__ planes, long long pstride,
             const float* __restrict__ time_in,
             const bool* __restrict__ alive_in,
             const int32_t* __restrict__ lane_in, int n, uint32_t seed,
             int depth, int max_depth, const float* __restrict__ sky4,
             int flags, float* __restrict__ out, bool* __restrict__ alive_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;

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
  float cx = a[kGeo], cy = a[kGeo + 1], cz = a[kGeo + 2];
  if (flags & FLAG_MOTION) {
    const float s = (time_in[i] - a[kGeo + 6]) * a[kGeo + 7];
    cx = cx + s * a[kGeo + 3];
    cy = cy + s * a[kGeo + 4];
    cz = cz + s * a[kGeo + 5];
  }
  const float r = a[kGeo + 8];
  const float inv_r = 1.0f / (fabsf(r) < 1e-12f ? 1.0f : r);
  float nx = (px - cx) * inv_r;
  float ny = (py - cy) * inv_r;
  float nz = (pz - cz) * inv_r;
  const float snx = nx, sny = ny;  // the sphere UV's, for every kind
  if ((flags & FLAG_RECT) && a[kGeo - 1] == KIND_RECT) {
    const float axis = a[kGeo], flip = a[kGeo + 6];
    nx = (axis == 0.0f ? 1.0f : 0.0f) * flip;
    ny = (axis == 1.0f ? 1.0f : 0.0f) * flip;
    nz = (axis == 2.0f ? 1.0f : 0.0f) * flip;
  }
  if ((flags & FLAG_BOX) && a[kGeo - 1] == KIND_BOX) {
    float n[3];
    box_normal(a, rox, roy, roz, rdx, rdy, rdz, t_safe, n);
    nx = n[0];
    ny = n[1];
    nz = n[2];
  }
  if ((flags & FLAG_MEDIUM) && a[kGeo - 1] == KIND_MEDIUM) {
    nx = 1.0f;
    ny = 0.0f;
    nz = 0.0f;
  }

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
  if ((flags & FLAG_IMAGE) && tex_kind == TEX_IMAGE) {
    image_texel(a, k_attr, px, py, pz, snx, sny, flags, atlas, atlas_w, rgb);
  }

  const float mat_kind = a[0];
  const bool is_light = mat_kind == MAT_DIFFUSE_LIGHT;
  const float sky_t = 0.5f * (rdy + 1.0f);
  const bool use_grad = sky4[3] > 0.5f;
  const bool nee = flags & FLAG_EMIT_SCALE;
  const float esc = nee ? planes[12 * pstride + i] : 1.0f;
  const float grad_k[3] = {0.15f, 0.21f, 0.30f};
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float grad_c = (1.0f - sky_t) + sky_t * grad_k[c];
    const float sky_c = use_grad ? grad_c : sky4[c];
    float prim_c = is_light ? rgb[c] : 0.0f;
    if (nee) prim_c = prim_c * esc;
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
  if (nee) {
    out[12 * s + i] = esc;
    out[13 * s + i] = nx;
    out[14 * s + i] = ny;
    out[15 * s + i] = nz;
#pragma unroll
    for (int c = 0; c < 3; ++c) out[(16 + c) * s + i] = rgb[c];
  }
  alive_out[i] = can;
}

}  // namespace

extern "C" int pt_shade_from_winners(
    const float* table, int k_attr, const float* atlas, int atlas_w,
    const int* idx, const float* t, const float* planes, long long plane_stride,
    const float* time, const bool* alive, const int32_t* lane, int n,
    int seed, int depth, int max_depth, const float* sky4, int flags,
    float* planes_out, bool* alive_out, cudaStream_t stream) {
  if (n > 0) {
    const int blocks = (n + kThreads - 1) / kThreads;
    shade_kernel<<<blocks, kThreads, 0, stream>>>(
        table, k_attr, atlas, atlas_w, idx, t, planes, plane_stride, time,
        alive, lane, n, static_cast<uint32_t>(seed), depth, max_depth, sky4,
        flags, planes_out, alive_out);
  }
  return static_cast<int>(cudaGetLastError());
}
