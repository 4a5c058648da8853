// The 7-octave hash turbulence of the marble texture, one thread a lane,
// on the lanes a mask selects.
//
// Replaces no TPU kernel: the reference's non-fused bounce computes
// fast_turb_c in XLA for every lane (pathtrace_tpu/ops/fastpath.py:460-497,
// used by fast_bounce). Its plain twin in the port
// (ops/fastpath.py fast_turb_c) is ~5,000 element-wise launches of int64
// and float work over the whole wavefront; this kernel computes the same
// value with pt_device.cuh's fast_turb, the function K2 and K7 evaluate
// inline, bit for bit the twin (tests/test_torch_noise_rule.py holds the
// rule, and the build's -fmad=false keeps the float operations apart).
// A lane whose mask is 0 (its winner does not wear the noise texture)
// writes 0 and does no work.
//
// Bound: issue slots, ~1,708 instructions a masked-in lane (seven
// octaves of eight hashed corners), against 12 bytes read and 5 a lane.

#include <cuda_runtime.h>
#include <stdint.h>

#include "pt_device.cuh"

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
turb_kernel(const float* __restrict__ points, const uint8_t* __restrict__ mask,
            int n, float* __restrict__ out) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  float v = 0.0f;
  if (mask[i]) {
    const long long k = 3LL * i;
    v = pt::fast_turb(points[k], points[k + 1], points[k + 2]);
  }
  out[i] = v;
}

}  // namespace

// points [n, 3] f32 contiguous, mask [n] bool (one byte a lane)
extern "C" int pt_noise_turb(const float* points, const void* mask, int n,
                             float* out, cudaStream_t stream) {
  if (n <= 0) return 0;
  const int blocks = (n + kThreads - 1) / kThreads;
  turb_kernel<<<blocks, kThreads, 0, stream>>>(
      points, static_cast<const uint8_t*>(mask), n, out);
  return static_cast<int>(cudaGetLastError());
}
