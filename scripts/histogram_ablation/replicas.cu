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
// more than a few issue slots, and enough bytes must be in flight:
//
//   * hist_shared: each CTA counts into R replicas of the histogram in
//     shared memory, interleaved so that bin b of replica r is word
//     b * R + r, and lane l adds into replica l % R.  The same bin in two
//     lanes of a warp then lies in two words (R = 32: in two banks), so a
//     skewed stream (the exponent byte of float data, the zero keys of a
//     quantizer) does not serialise a warp on one word, and no lane spends
//     a match or vote on finding its peers: a key costs a range check, a
//     shift and one shared atomic add.  R is the largest power of two up to
//     32 whose replicas fit kSharedBudget (256 bins: 32; 4096 bins: 4);
//     an alphabet that fits only once (up to kSharedMax) gets R = 1;
//   * loads: every thread has kUnroll 16-byte loads in flight before it
//     counts any of their keys; a misaligned start is peeled (the first
//     CTA counts the keys before the first 16-byte boundary and the < 4
//     after the last whole group);
//   * flush: the replicas are read word after word (no bank conflicts),
//     summed across each run of R lanes with shuffles, and each non-zero
//     bin goes to the output with one global atomic per CTA;
//   * hist_global: an alphabet above one CTA's shared memory (2^16 bins are
//     256 KB) counts with atomics straight into the output, in the 50 MB L2;
//   * host: the output is zeroed by cudaMemsetAsync; the shared-memory limit
//     and the CTAs an SM holds are looked up once per device and size.

#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

namespace {

constexpr int kThreads = 512;
constexpr int kUnroll = 4;                    // 16-byte loads in flight per thread
constexpr int kMaxReplicas = 32;
constexpr int kSharedBudget = 64 * 1024;      // replicated sub-histograms per CTA
constexpr int kSharedMax = 227 * 1024;        // one CTA's dynamic shared memory
constexpr unsigned kFull = 0xffffffffu;

// What the kernel does with one key.
__device__ __forceinline__ void count(int* mine, int key, unsigned num_bins, int shift) {
  if (static_cast<unsigned>(key) < num_bins) atomicAdd(mine + (key << shift), 1);
}

__device__ __forceinline__ void count4(int* mine, int4 v, unsigned num_bins, int shift) {
  count(mine, v.x, num_bins, shift);
  count(mine, v.y, num_bins, shift);
  count(mine, v.z, num_bins, shift);
  count(mine, v.w, num_bins, shift);
}

// Keys before the first 16-byte boundary of `keys` (int32 keys are 4-byte
// aligned), at most n.
__device__ __forceinline__ long long head_of(const int* keys, long long n) {
  const long long head = static_cast<long long>(((16u - (reinterpret_cast<uintptr_t>(keys) & 15u)) & 15u) >> 2);
  return head < n ? head : n;
}

// Count every key of `keys` into `hist` (this thread's replica); the grid
// covers the 16-byte groups, the first CTA the head and the tail.
__device__ __forceinline__ void count_keys(const int* __restrict__ keys, long long n, int* hist,
                                           unsigned num_bins, int shift) {
  const long long head = head_of(keys, n);
  const long long groups = (n - head) >> 2;
  const long long done = head + 4 * groups;  // keys [done, n): the tail, < 4
  if (blockIdx.x == 0) {
    const long long t = threadIdx.x;
    if (t < head) count(hist, keys[t], num_bins, shift);
    else if (t < head + (n - done)) count(hist, keys[done + t - head], num_bins, shift);
  }
  const int4* body = reinterpret_cast<const int4*>(keys + head);
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  long long g = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  for (; g + (kUnroll - 1) * stride < groups; g += kUnroll * stride) {
    int4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) v[u] = __ldg(body + g + u * stride);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) count4(hist, v[u], num_bins, shift);
  }
  for (; g < groups; g += stride) count4(hist, __ldg(body + g), num_bins, shift);
}

__global__ void __launch_bounds__(kThreads)
hist_shared(const int* __restrict__ keys, long long n, int* __restrict__ out,
            unsigned num_bins, int shift) {
  extern __shared__ int sub[];
  const int replicas = 1 << shift;
  const unsigned words = num_bins << shift;
  for (unsigned i = threadIdx.x; i < words; i += kThreads) sub[i] = 0;
  __syncthreads();
  count_keys(keys, n, sub + (threadIdx.x & (replicas - 1)), num_bins, shift);
  __syncthreads();
  // Word i is replica i % R of bin i / R: a warp reads 32 consecutive words
  // and sums each run of R lanes.  The loop bound is a multiple of 32, so
  // every lane of a warp shuffles.
  const unsigned padded = (words + 31u) & ~31u;
  for (unsigned i = threadIdx.x; i < padded; i += kThreads) {
    int s = i < words ? sub[i] : 0;
    for (int o = replicas >> 1; o > 0; o >>= 1) s += __shfl_down_sync(kFull, s, o, replicas);
    if ((i & (replicas - 1)) == 0 && s) atomicAdd(out + (i >> shift), s);
  }
}

__global__ void __launch_bounds__(kThreads)
hist_global(const int* __restrict__ keys, long long n, int* __restrict__ out,
            unsigned num_bins) {
  count_keys(keys, n, out, num_bins, 0);
}

// Per device: the SM count, and the CTAs an SM holds for each shared size
// used so far (a handful of sizes: one per replica count).
struct DeviceInfo {
  int sms = 0;
  bool smem_set = false;
  int sizes[16] = {};
  int ctas[16] = {};
  int known = 0;
};

std::mutex info_lock;
DeviceInfo infos[64];

cudaError_t shared_launch(int smem, int* sms, int* ctas_per_sm) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> guard(info_lock);
  DeviceInfo& d = infos[dev];
  if (d.sms == 0) {
    err = cudaDeviceGetAttribute(&d.sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
  }
  if (!d.smem_set) {
    err = cudaFuncSetAttribute(hist_shared, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSharedMax);
    if (err != cudaSuccess) return err;
    d.smem_set = true;
  }
  *sms = d.sms;
  for (int i = 0; i < d.known; ++i) {
    if (d.sizes[i] == smem) {
      *ctas_per_sm = d.ctas[i];
      return cudaSuccess;
    }
  }
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, hist_shared, kThreads, smem);
  if (err != cudaSuccess) return err;
  per_sm = per_sm > 0 ? per_sm : 1;
  if (d.known < 16) {
    d.sizes[d.known] = smem;
    d.ctas[d.known] = per_sm;
    ++d.known;
  }
  *ctas_per_sm = per_sm;
  return cudaSuccess;
}

int device_sms() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 1;
  std::lock_guard<std::mutex> guard(info_lock);
  if (infos[dev].sms == 0) cudaDeviceGetAttribute(&infos[dev].sms, cudaDevAttrMultiProcessorCount, dev);
  sms = infos[dev].sms;
  return sms > 0 ? sms : 1;
}

// log2 of the replicas for `num_bins`, or -1 where even one copy does not
// fit a CTA's shared memory.
int replica_shift(long long num_bins) {
  const long long bytes = 4 * num_bins;
  if (bytes > kSharedMax) return -1;
  int shift = 0;
  while ((2 << shift) <= kMaxReplicas && bytes * (2 << shift) <= kSharedBudget) ++shift;
  return shift;
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
  const int shift = replica_shift(num_bins);
  if (shift >= 0) {
    const int smem = (4 * num_bins) << shift;
    int sms = 0, per_sm = 0;
    err = shared_launch(smem, &sms, &per_sm);
    if (err != cudaSuccess) return static_cast<int>(err);
    long long grid = static_cast<long long>(sms) * per_sm;
    grid = grid < needed ? grid : needed;
    hist_shared<<<static_cast<unsigned>(grid), kThreads, smem, s>>>(
        k, n, o, static_cast<unsigned>(num_bins), shift);
  } else {
    long long grid = static_cast<long long>(device_sms()) * (2048 / kThreads);
    grid = grid < needed ? grid : needed;
    hist_global<<<static_cast<unsigned>(grid), kThreads, 0, s>>>(
        k, n, o, static_cast<unsigned>(num_bins));
  }
  return static_cast<int>(cudaGetLastError());
}

// The replicas and dynamic shared memory a launch for `num_bins` uses, and
// the CTAs an SM holds (0 / 0 / 0 for the global path).  For reports.
extern "C" int histogram_launch_info(int num_bins, int* replicas, int* smem, int* ctas_per_sm) {
  const int shift = num_bins > 0 ? replica_shift(num_bins) : -1;
  *replicas = *smem = *ctas_per_sm = 0;
  if (shift < 0) return 0;
  *replicas = 1 << shift;
  *smem = (4 * num_bins) << shift;
  int sms = 0;
  return static_cast<int>(shared_launch(*smem, &sms, ctas_per_sm));
}
