// The 7-octave hash turbulence of the marble texture on the lanes a mask
// selects: a pass that lists those lanes on the card, then a pass that
// spreads each listed lane's octaves over eight threads.
//
// Replaces no TPU kernel: the reference's non-fused bounce computes
// fast_turb_c in XLA for every lane (pathtrace_tpu/ops/fastpath.py:460-497,
// used by fast_bounce). Its plain twin in the port
// (ops/fastpath.py fast_turb_c) is ~5,000 element-wise launches of int64
// and float work over the whole wavefront. This computes the same value
// with pt_device.cuh's fast_noise, the octave K2 and K7 evaluate inline,
// bit for bit the twin (tests/test_torch_noise_rule.py holds the rule,
// and the build's -fmad=false keeps the float operations apart). A lane
// whose mask is 0 (its winner does not wear the noise texture) gets 0.
//
// Bound: bytes, 5 a lane (the mask in, the value out) and 12 a noise lane
// (its point), ~0.006 ms on a full-width bounce; the operations, ~1,708
// instructions a noise lane (seven octaves of eight hashed corners), come
// to less. Only 0.8-2.3% of final_full's lanes wear the noise, and on a
// scattered bounce they are spread one or two a warp, so one thread a
// lane ran nearly every warp through seven serial octaves for one or two
// lanes. This design:
// - list_kernel, four consecutive lanes a thread, writes their zeros (one
//   16-byte store where aligned) and lists the lanes whose mask is set:
//   a warp prefix sum of the counts, one atomicAdd a block on the list's
//   count, which stays on the card (no host readback). The list's order
//   varies from run to run, the values do not: each lane's value is its
//   own.
// - octave_kernel, a persistent grid sized from the occupancy, reads the
//   count and takes four listed lanes a warp at a time: thread o of each
//   group of eight evaluates octave o (its point doubled o times, exact,
//   as fast_turb doubles it; the eighth is idle), reading the group's
//   next lane while it works, and the group's first thread sums the seven
//   in octave order, accum + weight * noise with weight halved each
//   octave, as fast_turb does, so the bits hold. Its last block out sets
//   the count back to 0 for the next launch.
// A launch uses the one count: two launches must not run at once (the
// port launches on one stream). pt_device.cuh stays as it is: K2 and K7
// include it.

#include <cuda_runtime.h>
#include <stdint.h>

#include "pt_device.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kLanes = 4;  // lanes a thread of the list pass
constexpr unsigned kFull = 0xffffffffu;

// the listed lanes, and the octave pass's blocks that have finished
__device__ int g_count = 0;
__device__ unsigned int g_done = 0;

__global__ void __launch_bounds__(kThreads)
list_kernel(const uint8_t* __restrict__ mask, int n, float* __restrict__ out,
            int* __restrict__ list) {
  __shared__ int s_warp[kThreads / 32];
  __shared__ int s_base;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long i0 =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) * kLanes;
  bool set[kLanes];
  const bool vec = i0 + kLanes <= n &&
                   (reinterpret_cast<uintptr_t>(mask + i0) & 3) == 0 &&
                   (reinterpret_cast<uintptr_t>(out + i0) & 15) == 0;
  if (vec) {
    const uchar4 m = *reinterpret_cast<const uchar4*>(mask + i0);
    set[0] = m.x != 0;
    set[1] = m.y != 0;
    set[2] = m.z != 0;
    set[3] = m.w != 0;
    // the listed lanes' zeros too: the octave pass writes them after
    *reinterpret_cast<float4*>(out + i0) = make_float4(0.f, 0.f, 0.f, 0.f);
  } else {
#pragma unroll
    for (int k = 0; k < kLanes; ++k) {
      set[k] = i0 + k < n && mask[i0 + k] != 0;
      if (i0 + k < n) out[i0 + k] = 0.0f;
    }
  }
  int cnt = 0;
#pragma unroll
  for (int k = 0; k < kLanes; ++k) cnt += set[k] ? 1 : 0;
  int incl = cnt;  // the warp's inclusive prefix
#pragma unroll
  for (int d = 1; d < 32; d *= 2) {
    const int t = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl += t;
  }
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  if (threadIdx.x == 0) {
    int total = 0;
    for (int w = 0; w < kThreads / 32; ++w) {
      const int c = s_warp[w];
      s_warp[w] = total;
      total += c;
    }
    s_base = total > 0 ? atomicAdd(&g_count, total) : 0;
  }
  __syncthreads();
  int pos = s_base + s_warp[warp] + incl - cnt;
#pragma unroll
  for (int k = 0; k < kLanes; ++k) {
    if (set[k]) list[pos++] = static_cast<int>(i0 + k);
  }
}

__global__ void __launch_bounds__(kThreads)
octave_kernel(const float* __restrict__ points, const int* __restrict__ list,
              float* __restrict__ out) {
  const int n_list = *reinterpret_cast<volatile int*>(&g_count);
  const int lane = threadIdx.x & 31;
  const int octave = lane & 7;
  const int step = gridDim.x * (kThreads / 8);
  int g = (blockIdx.x * kThreads + threadIdx.x) >> 3;
  const int warp_first = g - (lane >> 3);
  int id = -1;
  float px = 0.0f, py = 0.0f, pz = 0.0f;
  if (g < n_list) {
    id = list[g];
    px = points[3LL * id];
    py = points[3LL * id + 1];
    pz = points[3LL * id + 2];
  }
  for (int w = warp_first; w < n_list; w += step) {
    // read this group's next lane while its octaves run
    const int g_next = g + step;
    int id_next = -1;
    float nx = 0.0f, ny = 0.0f, nz = 0.0f;
    if (g_next < n_list) {
      id_next = list[g_next];
      nx = points[3LL * id_next];
      ny = points[3LL * id_next + 1];
      nz = points[3LL * id_next + 2];
    }
    float v = 0.0f;
    if (id >= 0 && octave < 7) {
      float x = px, y = py, z = pz;
      for (int o = 0; o < octave; ++o) {
        x = x * 2.0f;
        y = y * 2.0f;
        z = z * 2.0f;
      }
      v = pt::fast_noise(x, y, z);
    }
    // the group's first thread sums its octaves in order
    float accum = 0.0f;
    float weight = 1.0f;
#pragma unroll
    for (int o = 0; o < 7; ++o) {
      const float noise = __shfl_sync(kFull, v, (lane & ~7) + o);
      accum = accum + weight * noise;
      weight *= 0.5f;
    }
    if (octave == 0 && id >= 0) out[id] = fabsf(accum);
    g = g_next;
    id = id_next;
    px = nx;
    py = ny;
    pz = nz;
  }
  // the last block out sets the count back to 0
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    if (atomicAdd(&g_done, 1u) == gridDim.x - 1) {
      atomicExch(&g_count, 0);
      atomicExch(&g_done, 0u);
    }
  }
}

// the list pass's grid: kLanes lanes a thread
int list_grid(int n) {
  const long long per_block = static_cast<long long>(kThreads) * kLanes;
  return static_cast<int>((n + per_block - 1) / per_block);
}

// the octave pass's grid for n lanes: every block resident at once, no
// more than n listed lanes (eight threads each) could fill. The card's
// SM count and the occupancy are kept between calls.
cudaError_t octave_grid(int n, int* blocks, int* per_sm) {
  static int last_device = -1, sms = 0, occupancy = 0;
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return e;
  if (device != last_device) {
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (e != cudaSuccess) return e;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occupancy,
                                                      octave_kernel,
                                                      kThreads, 0);
    if (e != cudaSuccess) return e;
    last_device = device;
  }
  *per_sm = occupancy;
  if (occupancy < 1) return cudaErrorInvalidConfiguration;
  long long b = static_cast<long long>(sms) * occupancy;
  const long long wanted = (8LL * n + kThreads - 1) / kThreads;
  if (b > wanted) b = wanted;
  *blocks = static_cast<int>(b < 1 ? 1 : b);
  return cudaSuccess;
}

}  // namespace

// the launch of pt_noise_turb for n lanes: out[0] the list pass's
// blocks, out[1] the octave pass's, out[2] its resident blocks an SM,
// out[3] threads a block
extern "C" int pt_noise_turb_plan(int n, int* out) {
  int blocks = 0, per_sm = 0;
  const cudaError_t e = octave_grid(n, &blocks, &per_sm);
  out[0] = list_grid(n);
  out[1] = blocks;
  out[2] = per_sm;
  out[3] = kThreads;
  return static_cast<int>(e);
}

// points [n, 3] f32 contiguous, mask [n] bool (one byte a lane), out [n];
// list [n] int32 scratch
extern "C" int pt_noise_turb(const float* points, const void* mask, int n,
                             float* out, int* list, cudaStream_t stream) {
  if (n <= 0) return 0;
  int blocks = 0, per_sm = 0;
  cudaError_t e = octave_grid(n, &blocks, &per_sm);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int list_blocks = list_grid(n);
  list_kernel<<<list_blocks, kThreads, 0, stream>>>(
      static_cast<const uint8_t*>(mask), n, out, list);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  octave_kernel<<<blocks, kThreads, 0, stream>>>(points, list, out);
  return static_cast<int>(cudaGetLastError());
}
