// P2-P4: the winner-attribute layout probes (Hopper, sm_90a).
//
// Replace the TPU kernels of tools/split_probe.py: k_split (P2,
// pallas_call at :82), k_minor (P3, :109) and k_major (P4, :136). Each
// sums K attribute planes of R = rows x 128 winners into one (rows, 128)
// plane, left to right (k = 0, 1, ..., K-1), as the shade kernel would
// touch every attribute plane:
//   P2 split: K separate (rows, 128) planes (one column of the gathered
//             [R, K] rows each);
//   P3 minor: one (rows, K, 128) array, summed over its middle dimension;
//   P4 major: one (K, rows, 128) array, summed over its first dimension.
// There a grid step summed a block of 64 rows in VMEM.
//
// What bounds them: bytes. Each input element is read once and each
// output element written once, (K + 1) x 4 x R bytes: at K = 24 and
// R = 2^20, ~105 MB, ~0.031 ms at 3.35 TB/s; K - 1 adds per element are
// ~0.0004 ms of float32 work. Nothing is staged: there is no reuse to keep.
//
// P2 is one thread per output element: neighbouring threads read
// neighbouring addresses of every plane, so each warp's loads are whole
// 128-byte lines. It takes its K plane pointers as a by-value kernel
// parameter (a struct of kMaxPlanes pointers).
//
// P3 and P4 share one kernel, sum_planes4_kernel<kMinor>, built against
// the four limits of a one-float-per-thread design:
// - 16-byte loads. A unit of work is 4 consecutive outputs, a float4: the
//   thread loads one float4 of each plane, a quarter of the load
//   instructions (and L1 tag lookups) of scalar loads. P4's unit u reads
//   plane j at float4 j * (n / 4) + u; in P3 a warp covers one row's 128
//   lanes, its thread t reading float4 (row * K + j) * 32 + t, so each
//   warp load is 512 contiguous bytes in both layouts.
// - Loads before adds. Planes go in chunks of kChunk = 8: all 8 loads of
//   a chunk are issued, then their 8 adds, so 128 bytes a thread are in
//   flight; K is a runtime value and the last chunk is ragged.
// - A persistent grid. The grid is the number of blocks the card holds
//   at once (SMs x cudaOccupancyMaxActiveBlocksPerMultiprocessor,
//   computed once per device and kernel, and cached), or fewer where the
//   units need fewer; each thread strides over the units. No block is
//   launched and drained per 256 outputs.
// - Streaming loads. No input byte is read twice, so the loads are
//   __ldcs (ld.global.cs: evict first) and leave L2 to the output, which
//   is stored once as a float4.
// The caller (tools/split_probe.py) refuses a base pointer that is not
// 16-byte aligned; n is a multiple of 128, so every plane and row starts
// 16-byte aligned too. There is no scalar fallback.
//
// Numerics: float32 adds in the plain version's order (built with
// -fmad=false), so each kernel equals tools/split_probe.py's plain
// version bit for bit.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kLanes = 128;
constexpr int kMaxPlanes = 64;
constexpr int kChunk = 8;                  // float4 loads in flight a thread
constexpr int kRowUnits = kLanes / 4;      // float4 units of a 128-lane row
constexpr int kMaxDevices = 64;

struct Planes {
  const float* p[kMaxPlanes];
};

__global__ void __launch_bounds__(kThreads)
sum_split_kernel(Planes planes, int k, long long n, float* __restrict__ out) {
  const long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                      threadIdx.x;
  if (i >= n) return;
  float acc = planes.p[0][i];
#pragma unroll 8
  for (int j = 1; j < k; ++j) acc = acc + planes.p[j][i];
  out[i] = acc;
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// The sum over j = 0 .. k-1 of src[j * plane], left to right, in chunks of
// kChunk loads issued before their adds.
__device__ __forceinline__ float4 sum_unit(const float4* __restrict__ src,
                                           long long plane, int k) {
  float4 v[kChunk];
  float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  int j = 0;
  for (; j + kChunk <= k; j += kChunk) {
    const float4* p = src + j * plane;
#pragma unroll
    for (int q = 0; q < kChunk; ++q) v[q] = __ldcs(p + q * plane);
#pragma unroll
    for (int q = 0; q < kChunk; ++q) {
      acc = (j + q == 0) ? v[q] : add4(acc, v[q]);
    }
  }
  if (j < k) {  // the ragged last chunk: 1 .. kChunk - 1 planes
    const float4* p = src + j * plane;
#pragma unroll
    for (int q = 0; q < kChunk - 1; ++q) {
      if (j + q < k) v[q] = __ldcs(p + q * plane);
    }
#pragma unroll
    for (int q = 0; q < kChunk - 1; ++q) {
      if (j + q < k) acc = (j + q == 0) ? v[q] : add4(acc, v[q]);
    }
  }
  return acc;
}

// units = n / 4 float4 outputs. kMinor: a3 is (rows, k, 128), element
// (row, j, lane) at (row * k + j) * 128 + lane; else a3 is (k, rows, 128)
// = (k, n), element (j, i) at j * n + i.
template <bool kMinor>
__global__ void __launch_bounds__(kThreads)
sum_planes4_kernel(const float4* __restrict__ a3, int k,
                   unsigned long long units, float4* __restrict__ out) {
  const unsigned long long stride =
      static_cast<unsigned long long>(gridDim.x) * kThreads;
  for (unsigned long long u = blockIdx.x * static_cast<unsigned long long>(
           kThreads) + threadIdx.x; u < units; u += stride) {
    const float4* src;
    long long plane;
    if (kMinor) {
      const unsigned long long row = u / kRowUnits;
      src = a3 + row * k * kRowUnits + (u - row * kRowUnits);
      plane = kRowUnits;
    } else {
      src = a3 + u;
      plane = static_cast<long long>(units);
    }
    out[u] = sum_unit(src, plane, k);
  }
}

int blocks_for(long long n) {
  return static_cast<int>((n + kThreads - 1) / kThreads);
}

// The blocks of sum_planes4_kernel<kMinor> the current device holds at
// once, computed on the first launch there and cached.
template <bool kMinor>
cudaError_t resident_blocks(int* blocks) {
  static int cached[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (cached[dev] == 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, sum_planes4_kernel<kMinor>, kThreads, 0);
    if (err != cudaSuccess) return err;
    cached[dev] = sms * per_sm > 0 ? sms * per_sm : 1;
  }
  *blocks = cached[dev];
  return cudaSuccess;
}

template <bool kMinor>
int launch_planes4(const float* a3, int k, long long n, float* out,
                   cudaStream_t stream) {
  if (k < 1 || n < 0 || n % kLanes != 0 ||
      reinterpret_cast<std::uintptr_t>(a3) % 16 != 0 ||
      reinterpret_cast<std::uintptr_t>(out) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n > 0) {
    int blocks = 0;
    const cudaError_t err = resident_blocks<kMinor>(&blocks);
    if (err != cudaSuccess) return static_cast<int>(err);
    const long long units = n / 4;
    const long long needed = (units + kThreads - 1) / kThreads;
    if (needed < blocks) blocks = static_cast<int>(needed);
    sum_planes4_kernel<kMinor><<<blocks, kThreads, 0, stream>>>(
        reinterpret_cast<const float4*>(a3), k,
        static_cast<unsigned long long>(units), reinterpret_cast<float4*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// planes: a host array of k device pointers, each to n floats (1 <= k <=
// kMaxPlanes; n = rows * 128)
extern "C" int pt_sum_split(const float* const* planes, int k, long long n,
                            float* out, cudaStream_t stream) {
  if (k < 1 || k > kMaxPlanes) return static_cast<int>(cudaErrorInvalidValue);
  if (n > 0) {
    Planes arg{};
    for (int j = 0; j < k; ++j) arg.p[j] = planes[j];
    sum_split_kernel<<<blocks_for(n), kThreads, 0, stream>>>(arg, k, n, out);
  }
  return static_cast<int>(cudaGetLastError());
}

// a3 (rows, k, 128) and out (rows, 128), both 16-byte aligned; n = rows * 128
extern "C" int pt_sum_minor(const float* a3, int k, long long n, float* out,
                            cudaStream_t stream) {
  return launch_planes4<true>(a3, k, n, out, stream);
}

// a3 (k, rows, 128) and out (rows, 128), both 16-byte aligned; n = rows * 128
extern "C" int pt_sum_major(const float* a3, int k, long long n, float* out,
                            cudaStream_t stream) {
  return launch_planes4<false>(a3, k, n, out, stream);
}
