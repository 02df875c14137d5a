// Per-level linear quantization and its inverse for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels `quantize` (src/repro/kernels/quantize_map/
// kernel.py:37, pallas_call at :52) and `dequantize` (kernel.py:68,
// pallas_call at :83), the Map&Process stage of MGARD-X:
//
//   quantize:   u = zigzag(int32(round_half_even(x / bins[level])))
//   dequantize: x = float32(unzigzag(u)) * bins[level]
//
// The keys are the uint32 bits carried in int32.
//
// Bit identity with XLA, which the reference runs on:
//   * XLA treats a subnormal operand as zero and flushes a subnormal result;
//     this library is built without -ftz, so both are done here explicitly
//     (daz(), on x and on the bin table as it is staged; ftz() on the
//     dequantized value);
//   * __fdiv_rn and __fmul_rn are IEEE round-to-nearest and are never
//     contracted into an FMA;
//   * __float2int_rn rounds half to even and saturates (NaN -> 0), as XLA's
//     round followed by its float -> int32 conversion does; __int2float_rn
//     rounds to nearest, as XLA's int -> float conversion does.
//   Levels outside [0, num_bins) are clamped into it (the plain version
//   clamps the same way).
//
// What bounds it: each element reads 4 B of value or key and 4 B of level
// and writes 4 B, so 135,005,697 elements (a 513^3 grid) move 1.620 GB,
// 0.484 ms at 3.35 TB/s; a division or multiplication per element is far
// below the card's arithmetic rate.  The design is one grid-stride pass over
// persistent CTAs with 16-byte loads and stores (four elements a thread a
// step), and the bin table (at most a few dozen entries) staged once per CTA
// in shared memory, so the gather costs no device-memory traffic.

#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBins = 1024;

__device__ __forceinline__ float daz(float v) {
  return fabsf(v) < FLT_MIN ? copysignf(0.0f, v) : v;
}

__device__ __forceinline__ int clamp_level(int l, int num_bins) {
  return l < 0 ? 0 : (l >= num_bins ? num_bins - 1 : l);
}

__device__ __forceinline__ int quantize_one(float x, int level, const float* bins,
                                            int num_bins) {
  const float q = __fdiv_rn(daz(x), bins[clamp_level(level, num_bins)]);
  const int qi = __float2int_rn(q);
  return static_cast<int>((static_cast<uint32_t>(qi) << 1) ^ static_cast<uint32_t>(qi >> 31));
}

__device__ __forceinline__ float dequantize_one(int key, int level, const float* bins,
                                                int num_bins) {
  const uint32_t u = static_cast<uint32_t>(key);
  const int q = static_cast<int>((u >> 1) ^ (0u - (u & 1u)));
  return daz(__fmul_rn(__int2float_rn(q), bins[clamp_level(level, num_bins)]));
}

__device__ __forceinline__ void stage_bins(float* dst, const float* __restrict__ bins,
                                           int num_bins) {
  for (int i = threadIdx.x; i < num_bins; i += kThreads) dst[i] = daz(__ldg(bins + i));
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads)
quantize_kernel(const float* __restrict__ x, const int* __restrict__ levels,
                const float* __restrict__ bins, int num_bins, long long n, bool vec,
                int* __restrict__ out) {
  __shared__ float b[kMaxBins];
  stage_bins(b, bins, num_bins);
  const long long groups = (n + 3) / 4;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long g = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x; g < groups;
       g += stride) {
    if (vec && 4 * g + 3 < n) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(x) + g);
      const int4 l = __ldg(reinterpret_cast<const int4*>(levels) + g);
      int4 o;
      o.x = quantize_one(v.x, l.x, b, num_bins);
      o.y = quantize_one(v.y, l.y, b, num_bins);
      o.z = quantize_one(v.z, l.z, b, num_bins);
      o.w = quantize_one(v.w, l.w, b, num_bins);
      reinterpret_cast<int4*>(out)[g] = o;
    } else {
      for (long long i = 4 * g; i < 4 * g + 4 && i < n; ++i)
        out[i] = quantize_one(__ldg(x + i), __ldg(levels + i), b, num_bins);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
dequantize_kernel(const int* __restrict__ keys, const int* __restrict__ levels,
                  const float* __restrict__ bins, int num_bins, long long n, bool vec,
                  float* __restrict__ out) {
  __shared__ float b[kMaxBins];
  stage_bins(b, bins, num_bins);
  const long long groups = (n + 3) / 4;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long g = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x; g < groups;
       g += stride) {
    if (vec && 4 * g + 3 < n) {
      const int4 k = __ldg(reinterpret_cast<const int4*>(keys) + g);
      const int4 l = __ldg(reinterpret_cast<const int4*>(levels) + g);
      float4 o;
      o.x = dequantize_one(k.x, l.x, b, num_bins);
      o.y = dequantize_one(k.y, l.y, b, num_bins);
      o.z = dequantize_one(k.z, l.z, b, num_bins);
      o.w = dequantize_one(k.w, l.w, b, num_bins);
      reinterpret_cast<float4*>(out)[g] = o;
    } else {
      for (long long i = 4 * g; i < 4 * g + 4 && i < n; ++i)
        out[i] = dequantize_one(__ldg(keys + i), __ldg(levels + i), b, num_bins);
    }
  }
}

int grid_for(long long n) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long needed = ((n + 3) / 4 + kThreads - 1) / kThreads;
  const long long cap = static_cast<long long>(sms > 0 ? sms : 1) * 8;
  return static_cast<int>(needed < cap ? needed : cap);
}

bool aligned(const void* a, const void* b, const void* c) {
  return ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b) |
           reinterpret_cast<uintptr_t>(c)) & 15) == 0;
}

}  // namespace

// out[i] = zigzag(int32(round(x[i] / bins[levels[i]]))) for i < n.
// Returns the CUDA error of the launch (0 on success).
extern "C" int quantize_map_quantize(const void* x, const void* levels, const void* bins,
                                     int num_bins, long long n, void* out, void* stream) {
  if (num_bins <= 0 || num_bins > kMaxBins || n < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  quantize_kernel<<<grid_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const int*>(levels),
      static_cast<const float*>(bins), num_bins, n, aligned(x, levels, out),
      static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}

// out[i] = float32(unzigzag(keys[i])) * bins[levels[i]] for i < n.
// Returns the CUDA error of the launch (0 on success).
extern "C" int quantize_map_dequantize(const void* keys, const void* levels, const void* bins,
                                       int num_bins, long long n, void* out, void* stream) {
  if (num_bins <= 0 || num_bins > kMaxBins || n < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  dequantize_kernel<<<grid_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(keys), static_cast<const int*>(levels),
      static_cast<const float*>(bins), num_bins, n, aligned(keys, levels, out),
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
