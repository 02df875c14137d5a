// Key-frequency histogram for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `histogram` of
// src/repro/kernels/histogram/kernel.py:39 (pallas_call at kernel.py:53),
// the DEM global stage of Huffman-X: int32 keys -> num_bins int32 counts.
// Keys outside [0, num_bins) are counted nowhere, as in the Pallas kernel.
//
// The TPU has no atomics, so its kernel compares every key with every bin
// of a tile (a one-hot matrix) and sums.  Hopper has fast shared-memory
// atomics, so this kernel counts directly:
//
//   * hist_shared: each CTA keeps `copies` sub-histograms in shared memory
//     (warp w adds into copy w % copies), walks the keys with a grid-stride
//     loop of 16-byte loads, and at the end adds each non-zero bin of its
//     copies into the output with one global atomicAdd;
//   * contention: the byte streams of float data are heavily skewed (the
//     exponent byte takes a handful of values), so each increment is
//     warp-aggregated: __match_any_sync groups the lanes holding the same
//     key and only the group's leader adds the group's popcount.  Per-warp
//     copies (up to 16 for a 256-key alphabet) keep warps off each other's
//     banks;
//   * hist_global: an alphabet whose histogram does not fit the shared
//     budget (2^16 bins are 256 KB; a CTA has 227 KB) counts with the same
//     warp-aggregated atomics straight into the output, which stays in the
//     50 MB L2.
//
// What bounds it: it reads 4 B per key and writes 4 B per bin, so 2^26 keys
// are 268 MB, 0.080 ms at 3.35 TB/s; the atomics, not the bytes, are what
// can make it slower than that.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kSharedBudget = 96 * 1024;  // bytes of sub-histograms per CTA
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ void count_key(int* hist, int key, int num_bins, int lane) {
  const bool ok = static_cast<unsigned>(key) < static_cast<unsigned>(num_bins);
  const unsigned active = __ballot_sync(kFull, ok);
  if (ok) {
    const unsigned peers = __match_any_sync(active, key);
    if (lane == __ffs(peers) - 1) atomicAdd(hist + key, __popc(peers));
  }
}

// Every lane of a warp runs the same iterations (the loop bound is per
// warp), as __ballot_sync over the full warp requires.
__device__ __forceinline__ void count_keys(const int* __restrict__ keys, long long n, bool vec,
                                           int* hist, int num_bins) {
  const int lane = threadIdx.x & 31;
  const long long groups = (n + 3) / 4;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long base = static_cast<long long>(blockIdx.x) * kThreads + (threadIdx.x & ~31);
       base < groups; base += stride) {
    const long long g = base + lane;
    int k[4] = {-1, -1, -1, -1};
    if (vec && 4 * g + 3 < n) {
      const int4 v = __ldg(reinterpret_cast<const int4*>(keys) + g);
      k[0] = v.x; k[1] = v.y; k[2] = v.z; k[3] = v.w;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (4 * g + j < n) k[j] = __ldg(keys + 4 * g + j);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) count_key(hist, k[j], num_bins, lane);
  }
}

__global__ void __launch_bounds__(kThreads)
hist_shared(const int* __restrict__ keys, long long n, bool vec, int* __restrict__ out,
            int num_bins, int copies) {
  extern __shared__ int sub[];
  for (int i = threadIdx.x; i < copies * num_bins; i += kThreads) sub[i] = 0;
  __syncthreads();
  count_keys(keys, n, vec, sub + ((threadIdx.x >> 5) % copies) * num_bins, num_bins);
  __syncthreads();
  for (int b = threadIdx.x; b < num_bins; b += kThreads) {
    int s = 0;
    for (int c = 0; c < copies; ++c) s += sub[c * num_bins + b];
    if (s) atomicAdd(out + b, s);
  }
}

__global__ void __launch_bounds__(kThreads)
hist_global(const int* __restrict__ keys, long long n, bool vec, int* __restrict__ out,
            int num_bins) {
  count_keys(keys, n, vec, out, num_bins);
}

int sm_count() {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms > 0 ? sms : 1;
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
  const bool vec = (reinterpret_cast<uintptr_t>(keys) & 15) == 0;
  const long long groups = (n + 3) / 4;
  const long long needed = (groups + kThreads - 1) / kThreads;
  const long long bytes = sizeof(int) * static_cast<long long>(num_bins);
  if (bytes <= kSharedBudget) {
    int copies = static_cast<int>(kSharedBudget / bytes);
    copies = copies < kWarps ? copies : kWarps;
    const int smem = static_cast<int>(bytes) * copies;
    err = cudaFuncSetAttribute(hist_shared, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int per_sm = smem > 64 * 1024 ? 2 : 4;
    long long grid = static_cast<long long>(sm_count()) * per_sm;
    grid = grid < needed ? grid : needed;
    hist_shared<<<static_cast<unsigned>(grid), kThreads, smem, s>>>(k, n, vec, o, num_bins,
                                                                    copies);
  } else {
    long long grid = static_cast<long long>(sm_count()) * 4;
    grid = grid < needed ? grid : needed;
    hist_global<<<static_cast<unsigned>(grid), kThreads, 0, s>>>(k, n, vec, o, num_bins);
  }
  return static_cast<int>(cudaGetLastError());
}
