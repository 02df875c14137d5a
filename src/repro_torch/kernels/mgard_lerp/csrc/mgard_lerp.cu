// MGARD interpolation-coefficient stencil for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `lerp_coefficients` of
// src/repro/kernels/mgard_lerp/kernel.py:30 (pallas_call at kernel.py:41),
// the Locality stage of MGARD-X: for every row of odd length n = 2m + 1,
//
//   mc[i] = u[2i+1] - 0.5 * (u[2i] + u[2i+2]),   i < m.
//
// __fadd_rn / __fmul_rn / __fsub_rn keep the three roundings of the plain
// version (kernels/mgard_lerp/ref.py) in its order, never contracted into an
// FMA, so the two are bit-identical.
//
// What bounds it: every row is read once (4 B per node) and every
// coefficient written once (4 B), so the level-0 rows of a 513^3 grid,
// (B, n) = (263169, 513), move 540.0 MB in and 269.5 MB out, 0.242 ms at
// 3.35 TB/s; three flops per output are nothing beside that.  The TPU
// kernel stages whole rows in VMEM; here one thread computes one
// coefficient over a flat grid-stride index of the (B, m) output, so a
// warp writes 128 contiguous bytes and reads a 65-float window of one row
// (or two adjacent rows), whatever m is: short rows (n = 3) waste no lanes.
// The index math runs in 32 bits whenever B * n fits.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <typename Index>
__global__ void __launch_bounds__(kThreads)
lerp_kernel(const float* __restrict__ rows, float* __restrict__ out, Index batch, Index m) {
  const Index total = batch * m;
  const Index n = 2 * m + 1;
  const Index stride = static_cast<Index>(gridDim.x) * kThreads;
  for (Index o = static_cast<Index>(blockIdx.x) * kThreads + threadIdx.x; o < total;
       o += stride) {
    const Index b = o / m;
    const Index i = o - b * m;
    const float* u = rows + b * n + 2 * i;
    out[o] = __fsub_rn(__ldg(u + 1), __fmul_rn(0.5f, __fadd_rn(__ldg(u), __ldg(u + 2))));
  }
}

}  // namespace

// out (batch x m) = the interpolation coefficients of rows (batch x (2m+1)).
// Returns the CUDA error of the launch (0 on success).
extern "C" int mgard_lerp(const void* rows, void* out, long long batch, long long m,
                          void* stream) {
  if (batch < 0 || m < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0) return 0;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long total = batch * m;
  const long long needed = (total + kThreads - 1) / kThreads;
  const long long cap = static_cast<long long>(sms > 0 ? sms : 1) * 16;
  const unsigned grid = static_cast<unsigned>(needed < cap ? needed : cap);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* r = static_cast<const float*>(rows);
  float* o = static_cast<float*>(out);
  if (batch * (2 * m + 1) + static_cast<long long>(grid) * kThreads < 0x7fffffffLL) {
    lerp_kernel<uint32_t><<<grid, kThreads, 0, s>>>(r, o, static_cast<uint32_t>(batch),
                                                    static_cast<uint32_t>(m));
  } else {
    lerp_kernel<long long><<<grid, kThreads, 0, s>>>(r, o, batch, m);
  }
  return static_cast<int>(cudaGetLastError());
}
