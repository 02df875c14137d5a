// Key-frequency histogram for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `histogram` of
// src/repro/kernels/histogram/kernel.py:39 (pallas_call at kernel.py:53),
// the DEM global stage of Huffman-X: int32 keys -> num_bins int32 counts.
// Keys outside [0, num_bins) are counted nowhere, as in the Pallas kernel.
//
// The TPU has no atomics, so its kernel compares every key with every bin
// of a tile (a one-hot matrix) and sums.  Hopper has shared-memory atomics,
// so this kernel counts directly.
//
// What bounds it: it reads 4 B per key and writes 4 B per bin, so 2^26 keys
// are 268 MB, 0.080 ms at 3.35 TB/s.  To stay near that, a key may cost no
// more than a few issue slots, and enough bytes must be in flight
// (scripts/histogram_ablation.py measures each choice below):
//
//   * hist_shared: each CTA counts into one copy of the histogram in shared
//     memory with a plain atomic add per key: a range check, an address and
//     the add.  Lanes of a warp that hit the same bin are merged by the
//     shared-memory atomic unit itself, so a skewed stream (the exponent
//     byte of float data, the zero keys of a quantizer) costs no more than
//     an even one: finding a key's peers first (__match_any_sync and a
//     vote per key) made the kernel 4-5x slower, and replicas of the
//     histogram interleaved across lanes made it slower, not faster;
//   * loads: every thread has kUnroll 16-byte loads in flight before it
//     counts any of their keys, in CTAs of 1024 threads (two an SM, or one
//     with the widest shared window); a misaligned start is peeled (the
//     first CTA counts the keys before the first 16-byte boundary and the
//     < 4 after the last whole group);
//   * flush: each non-zero bin of a CTA's copy goes to the output with one
//     global atomic;
//   * wide alphabets: a CTA's shared memory holds the first kSharedBins
//     bins (227 KB); keys past them count with atomics straight into the
//     output, in the 50 MB L2.  Skewed key streams put their hot keys low
//     (zig-zag codes, quantizer keys), and many CTAs adding to one hot word
//     in L2 serialise: counting all of a 2^16-key alphabet in L2 took ~8 ms
//     on skewed keys, where the shared window takes the hot keys;
//   * host: the output is zeroed by cudaMemsetAsync; the shared-memory limit
//     and the CTAs an SM holds are looked up once per device and size.

#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

namespace {

constexpr int kThreads = 1024;
constexpr int kUnroll = 4;                    // 16-byte loads in flight per thread
constexpr int kSharedMax = 227 * 1024;        // one CTA's dynamic shared memory
constexpr int kSharedBins = kSharedMax / 4;   // bins a CTA counts in shared memory

// Where one key is counted: bins [0, bins.shared) in the CTA's shared copy,
// [bins.shared, bins.all) in the output.
struct Bins {
  int* hist;
  int* out;
  unsigned shared, all;
};

// What the kernel does with one key.
__device__ __forceinline__ void count(const Bins& b, int key) {
  const unsigned k = static_cast<unsigned>(key);
  if (k < b.shared) atomicAdd(b.hist + k, 1);
  else if (k < b.all) atomicAdd(b.out + k, 1);
}

__device__ __forceinline__ void count4(const Bins& b, int4 v) {
  count(b, v.x);
  count(b, v.y);
  count(b, v.z);
  count(b, v.w);
}

// Count every key of `keys`: the grid covers the 16-byte groups, the first
// CTA the keys before the first 16-byte boundary (int32 keys are 4-byte
// aligned) and the < 4 after the last group.
__device__ __forceinline__ void count_keys(const int* __restrict__ keys, long long n,
                                           const Bins& b) {
  const uintptr_t misaligned = reinterpret_cast<uintptr_t>(keys) & 15u;
  long long head = static_cast<long long>(((16u - misaligned) & 15u) >> 2);
  head = head < n ? head : n;
  const long long groups = (n - head) >> 2;
  const long long done = head + 4 * groups;
  if (blockIdx.x == 0) {
    const long long t = threadIdx.x;
    if (t < head) count(b, keys[t]);
    else if (t < head + (n - done)) count(b, keys[done + t - head]);
  }
  const int4* body = reinterpret_cast<const int4*>(keys + head);
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  long long g = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  for (; g + (kUnroll - 1) * stride < groups; g += kUnroll * stride) {
    int4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) v[u] = __ldg(body + g + u * stride);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) count4(b, v[u]);
  }
  for (; g < groups; g += stride) count4(b, __ldg(body + g));
}

__global__ void __launch_bounds__(kThreads)
hist_shared(const int* __restrict__ keys, long long n, int* __restrict__ out,
            unsigned num_bins, unsigned shared_bins) {
  extern __shared__ int sub[];
  for (unsigned i = threadIdx.x; i < shared_bins; i += kThreads) sub[i] = 0;
  __syncthreads();
  count_keys(keys, n, Bins{sub, out, shared_bins, num_bins});
  __syncthreads();
  for (unsigned i = threadIdx.x; i < shared_bins; i += kThreads) {
    const int s = sub[i];
    if (s) atomicAdd(out + i, s);
  }
}

// Per device: the SM count, and the CTAs an SM holds for each shared size
// used so far.
struct DeviceInfo {
  int sms = 0;
  bool smem_set = false;
  int sizes[16] = {};
  int ctas[16] = {};
  int known = 0;
};

std::mutex info_lock;
DeviceInfo infos[64];

// The SMs of the current device and the CTAs of hist_shared with `smem`
// bytes an SM holds.
cudaError_t shared_launch(int smem, int* sms, int* ctas_per_sm) {
  std::lock_guard<std::mutex> guard(info_lock);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  DeviceInfo* d = &infos[dev];
  if (d->sms == 0) {
    err = cudaDeviceGetAttribute(&d->sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
  }
  if (!d->smem_set) {
    err = cudaFuncSetAttribute(hist_shared, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSharedMax);
    if (err != cudaSuccess) return err;
    d->smem_set = true;
  }
  *sms = d->sms;
  for (int i = 0; i < d->known; ++i) {
    if (d->sizes[i] == smem) {
      *ctas_per_sm = d->ctas[i];
      return cudaSuccess;
    }
  }
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, hist_shared, kThreads, smem);
  if (err != cudaSuccess) return err;
  per_sm = per_sm > 0 ? per_sm : 1;
  if (d->known < 16) {
    d->sizes[d->known] = smem;
    d->ctas[d->known] = per_sm;
    ++d->known;
  }
  *ctas_per_sm = per_sm;
  return cudaSuccess;
}

}  // namespace

// out[b] = number of keys equal to b, for b in [0, num_bins).  Zeroes `out`
// first; returns the CUDA error of the launches (0 on success).
extern "C" int histogram_count(const void* keys, long long n, void* out, int num_bins,
                               void* stream) {
  if (num_bins <= 0 || n < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(out, 0, sizeof(int) * static_cast<size_t>(num_bins), s);
  if (err != cudaSuccess || n == 0) return static_cast<int>(err);
  const int* k = static_cast<const int*>(keys);
  int* o = static_cast<int*>(out);
  const long long needed = ((n + 3) / 4 + kThreads - 1) / kThreads;
  const unsigned shared_bins = num_bins < kSharedBins ? num_bins : kSharedBins;
  const int smem = 4 * static_cast<int>(shared_bins);
  int sms = 0, per_sm = 0;
  err = shared_launch(smem, &sms, &per_sm);
  if (err != cudaSuccess) return static_cast<int>(err);
  long long grid = static_cast<long long>(sms) * per_sm;
  grid = grid < needed ? grid : needed;
  hist_shared<<<static_cast<unsigned>(grid), kThreads, smem, s>>>(
      k, n, o, static_cast<unsigned>(num_bins), shared_bins);
  return static_cast<int>(cudaGetLastError());
}

// The dynamic shared memory of a launch for `num_bins` (the bins it counts
// in shared memory, times 4) and the CTAs an SM holds.  For reports.
extern "C" int histogram_launch_info(int num_bins, int* smem, int* ctas_per_sm) {
  *smem = *ctas_per_sm = 0;
  if (num_bins <= 0) return static_cast<int>(cudaErrorInvalidValue);
  *smem = 4 * (num_bins < kSharedBins ? num_bins : kSharedBins);
  int sms = 0;
  return static_cast<int>(shared_launch(*smem, &sms, ctas_per_sm));
}
