// ZFP-X fixed-rate block encode and decode for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of src/repro/kernels/zfp_block/kernel.py:
//   zfp_compress_kernel   <- compress_blocks   (pallas_call at kernel.py:93)
//   zfp_decompress_kernel <- decompress_blocks (pallas_call at kernel.py:132)
// and reproduces them bit for bit: payload words, emax and decoded floats.
//
// What bounds it.  Encode reads 4 B per value and writes rate/8 B per value
// plus 4 B of emax per 4^d block; decode moves the same bytes the other way.
// At 512^3, rate 16 that is 813.7 MB per direction: 0.243 ms at the H100's
// 3.35 TB/s.  The integer work is 4·d (lifts) + ~7 (exponent, fixed point,
// negabinary) + 2·rate (bitplane extraction) operations per value: ~51 at
// d = 3, rate 16, 6.8 G operations, 0.10 ms at 67 T operations/s.  So the
// kernel is bound by bytes, and its design keeps device memory traffic at one
// coalesced read of the input and one coalesced write of the output:
//
//   * one CTA of 256 threads owns a tile of 2048 values (2048 / 4^d blocks),
//     staged through shared memory, so global loads and stores are whole
//     contiguous rows;
//   * every stage of the chain runs in shared memory: per-block exponent
//     (warp shuffles + a shared atomicMax), fixed point, the lift along each
//     axis (one thread per 4-vector line, a barrier between axes), negabinary
//     with the sequency permutation, and the bitplane pack;
//   * the pack builds each 32-bit word with one __ballot_sync; __brev puts
//     lane 0's bit at the MSB.  For 4^d >= 32 (d = 3, 4) a warp owns a
//     block, each lane keeps 4^d / 32 coefficients in registers, and plane
//     p of coefficients 32·j .. 32·j + 31 is one ballot (two words per plane
//     at d = 3); unpacking is the mirror image.  For d = 1, 2 a word spans
//     several planes and lane l supplies flat bit 32·w + l.
//
// Bit-exactness with the reference (XLA on the TPU or CPU):
//   * the scale is read from the table the wrapper passes (XLA's inexact
//     exp2, see repro_torch/core/zfp_tables.py), indexed by clamped emax;
//   * subnormal inputs are flushed to signed zero before the exponent is
//     taken (XLA's denormals-are-zero) and subnormal decoded values are
//     flushed to signed zero (XLA's flush-to-zero).  Both are done explicitly
//     in the code; the library is built without -ftz;
//   * __float2int_rn rounds half to even and saturates, NaN -> 0, as XLA's
//     round-then-convert does; __fmul_rn keeps nvcc from contracting the
//     scale multiply into an FMA;
//   * the lifts add and subtract in uint32_t (wrapping, as XLA's int32 does)
//     and shift right on int32_t (arithmetic).
//
// C interface (loaded with ctypes): each entry point launches one kernel on
// the given stream and returns cudaGetLastError() as an int.

#include <cuda_runtime.h>

#include <cfloat>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kTileValues = 2048;  // values per CTA tile: 8 KB of float32
constexpr int kScaleEmin = -160;   // zfp_tables.EMIN
constexpr int kScaleEntries = 352; // zfp_tables.EMAX - EMIN + 1

__device__ __forceinline__ int add_wrap(int a, int b) {
  return static_cast<int>(static_cast<uint32_t>(a) + static_cast<uint32_t>(b));
}
__device__ __forceinline__ int sub_wrap(int a, int b) {
  return static_cast<int>(static_cast<uint32_t>(a) - static_cast<uint32_t>(b));
}
__device__ __forceinline__ int shl1(int a) {
  return static_cast<int>(static_cast<uint32_t>(a) << 1);
}
__device__ __forceinline__ int asr1(int a) { return a >> 1; }

__device__ __forceinline__ void fwd_lift(int& x, int& y, int& z, int& w) {
  x = add_wrap(x, w); x = asr1(x); w = sub_wrap(w, x);
  z = add_wrap(z, y); z = asr1(z); y = sub_wrap(y, z);
  x = add_wrap(x, z); x = asr1(x); z = sub_wrap(z, x);
  w = add_wrap(w, y); w = asr1(w); y = sub_wrap(y, w);
  w = add_wrap(w, asr1(y)); y = sub_wrap(y, asr1(w));
}

__device__ __forceinline__ void inv_lift(int& x, int& y, int& z, int& w) {
  y = add_wrap(y, asr1(w)); w = sub_wrap(w, asr1(y));
  y = add_wrap(y, w); w = shl1(w); w = sub_wrap(w, y);
  z = add_wrap(z, x); x = shl1(x); x = sub_wrap(x, z);
  y = add_wrap(y, z); z = shl1(z); z = sub_wrap(z, y);
  w = add_wrap(w, x); x = shl1(x); x = sub_wrap(x, w);
}

__device__ __forceinline__ int scale_row(int e) {
  return min(max(e, kScaleEmin), kScaleEmin + kScaleEntries - 1) - kScaleEmin;
}

// Lift every 4-vector line of the tile's blocks along each axis: axis 0
// (stride 4^(D-1)) first on encode, last axis first on decode.
template <int D, bool kInverse>
__device__ __forceinline__ void lift_tile(int* s) {
  constexpr int BS = 1 << (2 * D);
  constexpr int LINES = BS / 4;
  constexpr int TB = kTileValues / BS;
#pragma unroll
  for (int a = 0; a < D; ++a) {
    const int axis = kInverse ? D - 1 - a : a;
    const int stride = 1 << (2 * (D - 1 - axis));
    for (int l = threadIdx.x; l < TB * LINES; l += kThreads) {
      const int b = l / LINES, m = l % LINES;
      int* p = s + b * BS + (m / stride) * (4 * stride) + (m % stride);
      int x = p[0], y = p[stride], z = p[2 * stride], w = p[3 * stride];
      if (kInverse) {
        inv_lift(x, y, z, w);
      } else {
        fwd_lift(x, y, z, w);
      }
      p[0] = x; p[stride] = y; p[2 * stride] = z; p[3 * stride] = w;
    }
    __syncthreads();
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
zfp_compress_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ payload,
                    int* __restrict__ emax_out, const int* __restrict__ perm,
                    const float* __restrict__ scale, long long n_blocks, int rate) {
  constexpr int BS = 1 << (2 * D);
  constexpr int TB = kTileValues / BS;
  constexpr int G = BS < 32 ? BS : 32;  // lanes of one block inside a warp
  __shared__ int s_val[kTileValues];      // input bits -> fixed point -> lifted
  __shared__ uint32_t s_u[kTileValues];   // negabinary, in sequency order
  __shared__ int s_perm[BS];
  __shared__ unsigned s_absmax[TB];
  __shared__ float s_scale[TB];

  const long long tile0 = static_cast<long long>(blockIdx.x) * TB;
  const int nvalid = static_cast<int>(min(static_cast<long long>(TB), n_blocks - tile0));
  const int wpb = (rate * BS + 31) >> 5;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  for (int i = threadIdx.x; i < BS; i += kThreads) s_perm[i] = perm[i];
  for (int b = threadIdx.x; b < TB; b += kThreads) s_absmax[b] = 0u;
  __syncthreads();

  // 1. coalesced load; subnormals -> signed zero; per-block max of |x| bits
  const uint32_t* xt = x + tile0 * BS;
  const int nval = nvalid * BS;
  for (int i = threadIdx.x; i < kTileValues; i += kThreads) {
    uint32_t bits = i < nval ? xt[i] : 0u;
    uint32_t mag = bits & 0x7fffffffu;
    if (mag < 0x00800000u) {
      bits &= 0x80000000u;
      mag = 0u;
    }
    s_val[i] = static_cast<int>(bits);
#pragma unroll
    for (int off = 1; off < G; off <<= 1) {
      mag = max(mag, __shfl_xor_sync(0xffffffffu, mag, off));
    }
    if ((lane & (G - 1)) == 0) atomicMax(&s_absmax[i / BS], mag);
  }
  __syncthreads();

  // 2. block exponent = frexp's exponent of the absmax: biased exponent - 126;
  //    0 for an all-zero block and for inf or NaN (jnp.frexp's convention)
  for (int b = threadIdx.x; b < TB; b += kThreads) {
    const unsigned m = s_absmax[b];
    const int e = (m == 0u || m >= 0x7f800000u) ? 0 : static_cast<int>(m >> 23) - 126;
    s_scale[b] = scale[scale_row(e)];
    if (b < nvalid) emax_out[tile0 + b] = e;
  }
  __syncthreads();

  // 3. fixed point: saturating round-half-even of x * scale, NaN -> 0
  for (int i = threadIdx.x; i < kTileValues; i += kThreads) {
    s_val[i] = __float2int_rn(__fmul_rn(__int_as_float(s_val[i]), s_scale[i / BS]));
  }
  __syncthreads();

  // 4. forward lift along each axis
  lift_tile<D, false>(s_val);

  // 5-6. negabinary in sequency order, then the bitplane pack
  uint32_t* s_words;
  if constexpr (BS >= 32) {
    // one warp per block: lane l keeps coefficients j*32 + l (sequency
    // order) in registers; plane p of coefficients j*32 .. j*32+31 is word
    // p*NJ + j, built by one ballot
    constexpr int NJ = BS / 32;
    s_words = s_u;
    for (int b = warp; b < nvalid; b += kThreads / 32) {
      uint32_t u[NJ];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const uint32_t q = static_cast<uint32_t>(s_val[b * BS + s_perm[j * 32 + lane]]);
        u[j] = (q + 0xaaaaaaaau) ^ 0xaaaaaaaau;
      }
      uint32_t* wb = s_words + b * wpb;
      for (int p = 0; p < rate; ++p) {
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const unsigned ballot = __ballot_sync(0xffffffffu, (u[j] >> (31 - p)) & 1u);
          if (lane == 0) wb[p * NJ + j] = __brev(ballot);
        }
      }
    }
  } else {
    // a word spans 32 / 4^d planes: stage the coefficients, then one word
    // per warp step, lane l supplying flat bit 32*w + l
    for (int i = threadIdx.x; i < kTileValues; i += kThreads) {
      const int b = i / BS, c = i % BS;
      const uint32_t q = static_cast<uint32_t>(s_val[b * BS + s_perm[c]]);
      s_u[i] = (q + 0xaaaaaaaau) ^ 0xaaaaaaaau;
    }
    __syncthreads();
    s_words = reinterpret_cast<uint32_t*>(s_val);  // s_val is free again
    for (int wi = warp; wi < nvalid * wpb; wi += kThreads / 32) {
      const int b = wi / wpb, w = wi - b * wpb;
      const int k = (w << 5) + lane;
      unsigned bit = 0u;
      if (k < rate * BS) bit = (s_u[b * BS + k % BS] >> (31 - k / BS)) & 1u;
      const unsigned ballot = __ballot_sync(0xffffffffu, bit);
      if (lane == 0) s_words[wi] = __brev(ballot);
    }
  }
  __syncthreads();

  // 7. coalesced store: the tile's payload rows are contiguous
  uint32_t* pt = payload + tile0 * wpb;
  for (int i = threadIdx.x; i < nvalid * wpb; i += kThreads) pt[i] = s_words[i];
}

template <int D>
__global__ void __launch_bounds__(kThreads)
zfp_decompress_kernel(const uint32_t* __restrict__ payload, const int* __restrict__ emax,
                      uint32_t* __restrict__ out, const int* __restrict__ perm,
                      const float* __restrict__ scale, long long n_blocks, int rate) {
  constexpr int BS = 1 << (2 * D);
  constexpr int TB = kTileValues / BS;
  __shared__ uint32_t s_words[kTileValues];
  __shared__ int s_val[kTileValues];
  __shared__ int s_perm[BS];
  __shared__ float s_scale[TB];

  const long long tile0 = static_cast<long long>(blockIdx.x) * TB;
  const int nvalid = static_cast<int>(min(static_cast<long long>(TB), n_blocks - tile0));
  const int wpb = (rate * BS + 31) >> 5;

  for (int i = threadIdx.x; i < BS; i += kThreads) s_perm[i] = perm[i];
  for (int b = threadIdx.x; b < TB; b += kThreads) {
    s_scale[b] = b < nvalid ? scale[scale_row(emax[tile0 + b])] : 0.0f;
  }
  // 1. coalesced load of the tile's payload rows
  const uint32_t* pt = payload + tile0 * wpb;
  for (int i = threadIdx.x; i < nvalid * wpb; i += kThreads) s_words[i] = pt[i];
  __syncthreads();

  // 2. unpack: each coefficient (sequency order) gathers its bit of every
  //    kept plane (dropped planes read as 0), negabinary -> int, back to
  //    block order
  if constexpr (BS >= 32) {
    // one warp per block, lane l owning coefficients j*32 + l: word
    // p*NJ + j holds their plane-p bits, lane l's at bit 31 - l
    constexpr int NJ = BS / 32;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    for (int b = warp; b < nvalid; b += kThreads / 32) {
      uint32_t u[NJ] = {};
      const uint32_t* wb = s_words + b * wpb;
      for (int p = 0; p < rate; ++p) {
#pragma unroll
        for (int j = 0; j < NJ; ++j) u[j] |= ((wb[p * NJ + j] >> (31 - lane)) & 1u) << (31 - p);
      }
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        s_val[b * BS + s_perm[j * 32 + lane]] =
            static_cast<int>((u[j] ^ 0xaaaaaaaau) - 0xaaaaaaaau);
      }
    }
  } else {
    for (int i = threadIdx.x; i < kTileValues; i += kThreads) {
      const int b = i / BS, c = i % BS;
      uint32_t u = 0u;
      if (b < nvalid) {
        const uint32_t* wb = s_words + b * wpb;
        for (int p = 0; p < rate; ++p) {
          const int k = p * BS + c;
          u |= ((wb[k >> 5] >> (31 - (k & 31))) & 1u) << (31 - p);
        }
      }
      s_val[b * BS + s_perm[c]] = static_cast<int>((u ^ 0xaaaaaaaau) - 0xaaaaaaaau);
    }
  }
  __syncthreads();

  // 3. inverse lift, last axis first
  lift_tile<D, true>(s_val);

  // 4. scale back, flush subnormals to signed zero, coalesced store
  uint32_t* ot = out + tile0 * BS;
  for (int i = threadIdx.x; i < nvalid * BS; i += kThreads) {
    float r = __fmul_rn(__int2float_rn(s_val[i]), s_scale[i / BS]);
    if (fabsf(r) < FLT_MIN) r = copysignf(0.0f, r);
    ot[i] = __float_as_uint(r);
  }
}

template <int D>
int launch_compress(const void* x, void* payload, void* emax, const void* perm,
                    const void* scale, long long n_blocks, int rate, cudaStream_t stream) {
  constexpr int TB = kTileValues >> (2 * D);
  const long long grid = (n_blocks + TB - 1) / TB;
  zfp_compress_kernel<D><<<static_cast<unsigned>(grid), kThreads, 0, stream>>>(
      static_cast<const uint32_t*>(x), static_cast<uint32_t*>(payload),
      static_cast<int*>(emax), static_cast<const int*>(perm),
      static_cast<const float*>(scale), n_blocks, rate);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_decompress(const void* payload, const void* emax, void* out, const void* perm,
                      const void* scale, long long n_blocks, int rate, cudaStream_t stream) {
  constexpr int TB = kTileValues >> (2 * D);
  const long long grid = (n_blocks + TB - 1) / TB;
  zfp_decompress_kernel<D><<<static_cast<unsigned>(grid), kThreads, 0, stream>>>(
      static_cast<const uint32_t*>(payload), static_cast<const int*>(emax),
      static_cast<uint32_t*>(out), static_cast<const int*>(perm),
      static_cast<const float*>(scale), n_blocks, rate);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int zfp_block_compress(const void* x, void* payload, void* emax, const void* perm,
                                  const void* scale, long long n_blocks, int dims, int rate,
                                  void* stream) {
  if (n_blocks <= 0) return 0;
  if (rate < 1 || rate > 32) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dims) {
    case 1: return launch_compress<1>(x, payload, emax, perm, scale, n_blocks, rate, s);
    case 2: return launch_compress<2>(x, payload, emax, perm, scale, n_blocks, rate, s);
    case 3: return launch_compress<3>(x, payload, emax, perm, scale, n_blocks, rate, s);
    case 4: return launch_compress<4>(x, payload, emax, perm, scale, n_blocks, rate, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int zfp_block_decompress(const void* payload, const void* emax, void* out,
                                    const void* perm, const void* scale, long long n_blocks,
                                    int dims, int rate, void* stream) {
  if (n_blocks <= 0) return 0;
  if (rate < 1 || rate > 32) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dims) {
    case 1: return launch_decompress<1>(payload, emax, out, perm, scale, n_blocks, rate, s);
    case 2: return launch_decompress<2>(payload, emax, out, perm, scale, n_blocks, rate, s);
    case 3: return launch_decompress<3>(payload, emax, out, perm, scale, n_blocks, rate, s);
    case 4: return launch_decompress<4>(payload, emax, out, perm, scale, n_blocks, rate, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
