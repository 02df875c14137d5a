// Batched Thomas solve of the 1-D FEM mass matrix for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `solve_mass` of
// src/repro/kernels/tridiag/kernel.py:48 (pallas_call at kernel.py:59), the
// Iterative stage of MGARD-X: for B independent systems of length n, solve
// M x = r with M = h * tridiag(1/6, 2/3, 1/6) (ends h/3), using the
// elimination constants cp[i] and dinv[i] the host precomputes in float64
// and rounds to float32 (core/mgard.py::_thomas_coeffs):
//
//   forward:  d[i] = (r[i] - sub * d[i-1]) * dinv[i],   d[-1] = 0, sub = h/6
//   backward: x[i] = d[i] - cp[i] * x[i+1],             x[n]  = 0
//
// Each operation is __fmul_rn / __fsub_rn, never contracted into an FMA, so
// the result is bit-identical to the plain sweep (kernels/tridiag/ref.py),
// which performs the same float32 operations in the same order; a stream
// then does not depend on the device that wrote it.
//
// Layout: the solve axis first, (n, B) row-major.  One thread owns one
// system; at every step the threads of a warp touch neighbouring systems,
// so each load and store of the sweep is a contiguous 128-byte row.  The
// forward sweep writes d into the output and the backward sweep overwrites
// it with x.  cp and dinv (8n bytes) are staged once per CTA in shared
// memory when they fit (n <= 12288), else read through the read-only path
// (every lane reads the same address: one broadcast).
//
// What bounds it: r is read once and x written once, 8 B per element, so
// the level-0 coarse solve of a 513^3 grid, (n, B) = (257, 66049), moves
// 135.8 MB, 0.041 ms at 3.35 TB/s.  This kernel moves the output twice more
// (d out, d back in) and its recurrence is sequential in n, so latency, not
// bandwidth, is its limit when B is small.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxShared = 12288;  // n up to this stages cp/dinv (96 KB)

template <bool kShared>
__global__ void __launch_bounds__(kThreads)
tridiag_kernel(const float* __restrict__ rhs, float* __restrict__ out,
               const float* __restrict__ cp_g, const float* __restrict__ dinv_g, int n,
               long long batch, float sub) {
  extern __shared__ float coeffs[];
  const float* cp = cp_g;
  const float* dinv = dinv_g;
  if (kShared) {
    for (int i = threadIdx.x; i < n; i += kThreads) {
      coeffs[i] = __ldg(cp_g + i);
      coeffs[n + i] = __ldg(dinv_g + i);
    }
    __syncthreads();
    cp = coeffs;
    dinv = coeffs + n;
  }
  const long long j = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (j >= batch) return;
  float d = 0.0f;
#pragma unroll 4
  for (int i = 0; i < n; ++i) {
    const long long at = static_cast<long long>(i) * batch + j;
    const float di = kShared ? dinv[i] : __ldg(dinv + i);
    d = __fmul_rn(__fsub_rn(__ldg(rhs + at), __fmul_rn(sub, d)), di);
    out[at] = d;
  }
  float x = 0.0f;
#pragma unroll 4
  for (int i = n - 1; i >= 0; --i) {
    const long long at = static_cast<long long>(i) * batch + j;
    const float ci = kShared ? cp[i] : __ldg(cp + i);
    x = __fsub_rn(out[at], __fmul_rn(ci, x));
    out[at] = x;
  }
}

}  // namespace

// Solve the `batch` systems stored solve-axis-first in rhs (n x batch) into
// out (same layout; may not alias rhs).  Returns the CUDA error of the
// launch (0 on success).
extern "C" int tridiag_solve(const void* rhs, void* out, const void* cp, const void* dinv, int n,
                             long long batch, float sub, void* stream) {
  if (n <= 0 || batch < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long grid = (batch + kThreads - 1) / kThreads;
  if (grid > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const float* r = static_cast<const float*>(rhs);
  float* o = static_cast<float*>(out);
  const float* c = static_cast<const float*>(cp);
  const float* dv = static_cast<const float*>(dinv);
  if (n <= kMaxShared) {
    const int smem = static_cast<int>(2 * sizeof(float)) * n;
    cudaError_t err = cudaFuncSetAttribute(tridiag_kernel<true>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    tridiag_kernel<true><<<static_cast<unsigned>(grid), kThreads, smem, s>>>(r, o, c, dv, n,
                                                                             batch, sub);
  } else {
    tridiag_kernel<false><<<static_cast<unsigned>(grid), kThreads, 0, s>>>(r, o, c, dv, n,
                                                                           batch, sub);
  }
  return static_cast<int>(cudaGetLastError());
}
