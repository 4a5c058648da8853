// The Threefry-2x32 draw of jax.random on the card (Hopper, sm_90a).
//
// Replaces no TPU kernel: the reference draws its primary-ray jitter and
// lens/time uniforms with jax.random (threefry2x32, partitionable, which
// XLA computes). The port's plain twin (pathtrace_tpu_torch/utils/
// threefry.py) does the same in int64 tensors masked to 32 bits, ~140
// element-wise launches a draw; this kernel is the draw itself.
//
// A 32-bit draw at flat index i is b1 ^ b2, where (b1, b2) is Threefry-
// 2x32 (20 rounds, a key injection every 4) of i's (high, low) words
// under the key (k0, k1); a uniform is (bits >> 9 | 0x3f800000) read as a
// float, minus 1. One thread per output value.
//
// What bounds it: at ~130 integer instructions a draw (20 rounds of an
// add, a funnel-shift rotate and a xor; five injections; the index and
// the store) the issue rate, ~0.07 ms for 18.4 M draws; its bytes are
// only the 4-byte output, 0.022 ms at 3.35 TB/s. Nothing is read.
//
// Numerics: uint32 arithmetic wraps as the twin's masks do, and the one
// float subtraction is exact, so the kernel equals the plain twin bit for
// bit.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

// x + y as an integer multiply-add by a runtime 1: the compiler cannot
// fold it into an IADD3, so it issues an IMAD, which runs on the FMA pipe
// beside the ALU pipe's rotates and xors instead of queueing behind them
__device__ __forceinline__ uint32_t add_fma(uint32_t x, uint32_t y,
                                           uint32_t one) {
  return x * one + y;
}

__device__ __forceinline__ void round4(uint32_t& x0, uint32_t& x1,
                                       uint32_t one, int r0, int r1, int r2,
                                       int r3) {
  x0 = add_fma(x1, x0, one); x1 = __funnelshift_l(x1, x1, r0) ^ x0;
  x0 = add_fma(x1, x0, one); x1 = __funnelshift_l(x1, x1, r1) ^ x0;
  x0 = add_fma(x1, x0, one); x1 = __funnelshift_l(x1, x1, r2) ^ x0;
  x0 = add_fma(x1, x0, one); x1 = __funnelshift_l(x1, x1, r3) ^ x0;
}

template <bool kFloat>
__global__ void __launch_bounds__(kThreads)
threefry_kernel(uint32_t k0, uint32_t k1, uint32_t one, long long n,
                void* out) {
  const long long i =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  const unsigned long long u = static_cast<unsigned long long>(i);
  uint32_t x0 = static_cast<uint32_t>(u >> 32) + k0;
  uint32_t x1 = static_cast<uint32_t>(u) + k1;
  round4(x0, x1, one, 13, 15, 26, 6);
  x0 += k1; x1 += k2 + 1u;
  round4(x0, x1, one, 17, 29, 16, 24);
  x0 += k2; x1 += k0 + 2u;
  round4(x0, x1, one, 13, 15, 26, 6);
  x0 += k0; x1 += k1 + 3u;
  round4(x0, x1, one, 17, 29, 16, 24);
  x0 += k1; x1 += k2 + 4u;
  round4(x0, x1, one, 13, 15, 26, 6);
  x0 += k2; x1 += k0 + 5u;
  const uint32_t bits = x0 ^ x1;
  if (kFloat) {
    static_cast<float*>(out)[i] =
        __uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f;
  } else {
    static_cast<uint32_t*>(out)[i] = bits;
  }
}

}  // namespace

// n draws under the key (k0, k1) into out: float32 uniforms when
// as_float, else the uint32 bits
extern "C" int pt_threefry(unsigned k0, unsigned k1, long long n, int as_float,
                           void* out, cudaStream_t stream) {
  if (n < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n > 0) {
    const long long blocks = (n + kThreads - 1) / kThreads;
    if (blocks > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
    if (as_float) {
      threefry_kernel<true><<<static_cast<unsigned>(blocks), kThreads, 0,
                              stream>>>(k0, k1, 1u, n, out);
    } else {
      threefry_kernel<false><<<static_cast<unsigned>(blocks), kThreads, 0,
                               stream>>>(k0, k1, 1u, n, out);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
