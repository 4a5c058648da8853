// P2-P4: the winner-attribute layout probes, one thread per output
// element (Hopper, sm_90a).
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
// There a grid step summed a block of 64 rows in VMEM. Here thread i owns
// output element (row, lane) = (i / 128, i % 128): neighbouring threads
// read neighbouring addresses of every plane, so each warp's loads are
// whole 128-byte lines in all three layouts. P2 takes its K plane
// pointers as a by-value kernel parameter (a struct of kMaxPlanes
// pointers).
//
// Numerics: float32 adds in the plain version's order (built with
// -fmad=false), so each kernel equals tools/split_probe.py's plain
// version bit for bit.
//
// What bounds it: bytes. Each input element is read once and each output
// element written once, (K + 1) x 4 x R bytes: at K = 24 and R = 2^20,
// ~105 MB, ~0.031 ms at 3.35 TB/s; K - 1 adds per element are ~0.0004 ms
// of float32 work. Nothing is staged: there is no reuse to keep.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kLanes = 128;
constexpr int kMaxPlanes = 64;

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

// a3 is (rows, k, 128): element (row, j, lane) at (row * k + j) * 128 + lane
__global__ void __launch_bounds__(kThreads)
sum_minor_kernel(const float* __restrict__ a3, int k, long long n,
                 float* __restrict__ out) {
  const long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                      threadIdx.x;
  if (i >= n) return;
  const long long row = i / kLanes;
  const float* src = a3 + row * k * kLanes + (i - row * kLanes);
  float acc = src[0];
#pragma unroll 8
  for (int j = 1; j < k; ++j) acc = acc + src[j * kLanes];
  out[i] = acc;
}

// a3 is (k, rows, 128) = (k, n): element (j, i) at j * n + i
__global__ void __launch_bounds__(kThreads)
sum_major_kernel(const float* __restrict__ a3, int k, long long n,
                 float* __restrict__ out) {
  const long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                      threadIdx.x;
  if (i >= n) return;
  float acc = a3[i];
#pragma unroll 8
  for (int j = 1; j < k; ++j) acc = acc + a3[j * n + i];
  out[i] = acc;
}

int blocks_for(long long n) {
  return static_cast<int>((n + kThreads - 1) / kThreads);
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

extern "C" int pt_sum_minor(const float* a3, int k, long long n, float* out,
                            cudaStream_t stream) {
  if (k < 1 || n % kLanes != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n > 0) {
    sum_minor_kernel<<<blocks_for(n), kThreads, 0, stream>>>(a3, k, n, out);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int pt_sum_major(const float* a3, int k, long long n, float* out,
                            cudaStream_t stream) {
  if (k < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (n > 0) {
    sum_major_kernel<<<blocks_for(n), kThreads, 0, stream>>>(a3, k, n, out);
  }
  return static_cast<int>(cudaGetLastError());
}
