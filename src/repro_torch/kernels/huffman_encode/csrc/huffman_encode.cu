// Per-key canonical-Huffman codebook gather for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `encode_lookup` of
// src/repro/kernels/huffman_encode/kernel.py:31 (pallas_call at kernel.py:44),
// the locality stage of Huffman-X: for every int32 key, the code (uint32,
// right-aligned) and its length (int32) from the canonical codebook.  Keys
// outside [0, K) are clamped into it, as XLA's gather clamps.
//
// What bounds it: 4 B read and 8 B written per key (plus the 8·K B codebook
// once), so 2^26 keys move 805 MB, 0.240 ms at 3.35 TB/s; the gathers are
// the only other work.  The design keeps the table probes off device memory
// and the stream traffic in 16-byte accesses:
//
//   * encode_shared: a codebook of up to 2^14 keys (128 KB) is staged once
//     per CTA in shared memory as (code, length) pairs, so each probe is one
//     8-byte shared load;
//   * encode_global: a larger codebook (up to 2^16 keys, 512 KB) is read
//     through the read-only path (__ldg) and stays in the 50 MB L2;
//   * each thread takes 4 consecutive keys with one 16-byte load and writes
//     4 codes and 4 lengths with one 16-byte store each, in a grid-stride
//     loop over persistent CTAs (a few per SM), so the staging is paid once
//     per CTA, not once per tile.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kSharedKeys = 1 << 14;

template <bool kShared>
__global__ void __launch_bounds__(kThreads)
encode_kernel(const int* __restrict__ keys, long long n, bool vec,
              const uint32_t* __restrict__ codes_t, const int* __restrict__ lens_t, int num_keys,
              uint32_t* __restrict__ codes, int* __restrict__ lens) {
  extern __shared__ int2 table[];
  if (kShared) {
    for (int i = threadIdx.x; i < num_keys; i += kThreads)
      table[i] = make_int2(static_cast<int>(__ldg(codes_t + i)), __ldg(lens_t + i));
    __syncthreads();
  }
  auto lookup = [&](int key, uint32_t& code, int& len) {
    key = key < 0 ? 0 : (key >= num_keys ? num_keys - 1 : key);
    if (kShared) {
      const int2 e = table[key];
      code = static_cast<uint32_t>(e.x);
      len = e.y;
    } else {
      code = __ldg(codes_t + key);
      len = __ldg(lens_t + key);
    }
  };
  const long long groups = (n + 3) / 4;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long g = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x; g < groups;
       g += stride) {
    if (vec && 4 * g + 3 < n) {
      const int4 k = __ldg(reinterpret_cast<const int4*>(keys) + g);
      uint4 c;
      int4 l;
      lookup(k.x, c.x, l.x);
      lookup(k.y, c.y, l.y);
      lookup(k.z, c.z, l.z);
      lookup(k.w, c.w, l.w);
      reinterpret_cast<uint4*>(codes)[g] = c;
      reinterpret_cast<int4*>(lens)[g] = l;
    } else {
      for (long long i = 4 * g; i < 4 * g + 4 && i < n; ++i) lookup(__ldg(keys + i), codes[i], lens[i]);
    }
  }
}

int sm_count() {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms > 0 ? sms : 1;
}

}  // namespace

// codes[i], lens[i] = codes_t[k], lens_t[k] with k = clamp(keys[i], 0, K-1).
// Returns the CUDA error of the launch (0 on success).
extern "C" int huffman_encode_lookup(const void* keys, long long n, const void* codes_t,
                                     const void* lens_t, int num_keys, void* codes, void* lens,
                                     void* stream) {
  if (num_keys <= 0 || n < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = ((reinterpret_cast<uintptr_t>(keys) | reinterpret_cast<uintptr_t>(codes) |
                     reinterpret_cast<uintptr_t>(lens)) & 15) == 0;
  const long long groups = (n + 3) / 4;
  const long long needed = (groups + kThreads - 1) / kThreads;
  const int* k = static_cast<const int*>(keys);
  const uint32_t* ct = static_cast<const uint32_t*>(codes_t);
  const int* lt = static_cast<const int*>(lens_t);
  uint32_t* c = static_cast<uint32_t*>(codes);
  int* l = static_cast<int*>(lens);
  if (num_keys <= kSharedKeys) {
    const int smem = static_cast<int>(sizeof(int2)) * num_keys;
    // The limit is the kernel's, shared by every host thread: set it to the
    // largest table, so a concurrent launch for a smaller alphabet never
    // lowers it under this launch's size.
    cudaError_t err = cudaFuncSetAttribute(encode_kernel<true>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(sizeof(int2)) * kSharedKeys);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int per_sm = smem > 64 * 1024 ? 1 : (smem > 32 * 1024 ? 2 : 4);
    long long grid = static_cast<long long>(sm_count()) * per_sm;
    grid = grid < needed ? grid : needed;
    encode_kernel<true><<<static_cast<unsigned>(grid), kThreads, smem, s>>>(
        k, n, vec, ct, lt, num_keys, c, l);
  } else {
    long long grid = static_cast<long long>(sm_count()) * 4;
    grid = grid < needed ? grid : needed;
    encode_kernel<false><<<static_cast<unsigned>(grid), kThreads, 0, s>>>(
        k, n, vec, ct, lt, num_keys, c, l);
  }
  return static_cast<int>(cudaGetLastError());
}
