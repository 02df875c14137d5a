// ZFP-X fixed-rate block encode and decode for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of src/repro/kernels/zfp_block/kernel.py:
//   zfp_encode_kernel <- compress_blocks   (pallas_call at kernel.py:93)
//   zfp_decode_kernel <- decompress_blocks (pallas_call at kernel.py:132)
// and reproduces them bit for bit: payload words, emax and decoded floats.
//
// Both kernels work on a padded d-D field where it lies (every axis a
// multiple of 4, the base 16-byte aligned) and on payload rows in the field's
// row-major block order.  The TPU kernel's (N, 4^d) blocks are the field
// (4N, 4, ..., 4), whose block counts are (N, 1, ..., 1), so one kernel
// serves both forms.
//
// What bounds it.  Encode reads 4 B per value and writes rate/8 B per value
// plus 4 B of emax per 4^d block; decode moves the same bytes the other way.
// At 512^3, rate 16 that is 813.7 MB per direction: 0.243 ms at the H100's
// 3.35 TB/s.  The integer work is ~30 operations per value at d = 3,
// rate <= 16 (the lifts 12, the bitplane transpose ~6), so the card's
// integer pipes (64 lanes per SM a clock) need ~0.25 ms for it too: both
// limits are near, and the design keeps device memory busy while the
// integer pipes run.
//
//   * Persistent CTAs (as many as fit on the SMs) walk tiles of up to T
//     blocks that are consecutive in block order (see Geo).  A tile's field
//     values are a few contiguous runs, fetched with 1-D cp.async.bulk copies
//     that complete on an mbarrier, into a ring of two shared-memory stages:
//     the next tiles' reads are in flight while a tile computes.  Its payload
//     rows are one contiguous run.
//   * One thread owns one block and keeps its whole chain in registers:
//     flush and exponent, fixed point, the d lifts, negabinary, the sequency
//     permutation (compiled in, so every register index is static) and the
//     bitplanes.  The bitplanes of 32 coefficients are a 32x32 bit
//     transpose, done with the recursive swap network (Hacker's Delight
//     7-3); at rate <= 16 only its upper half is built.  Two barriers per
//     tile, none inside the chain.
//   * Shared memory is read and written without bank conflicts where the
//     last axis holds 8 blocks or more: the field stage is an image of the
//     tile's runs, so thread k's 16-byte pieces sit next to thread k+1's;
//     payload words pass through a word-major stage padded to T+1 columns.  Encode
//     writes the payload with coalesced stores from that stage; decode
//     fetches payload and emax with bulk copies of the enclosing 16-byte
//     aligned run and writes the field back with bulk copies.
//
// Bit-exactness with the reference (XLA on the TPU or CPU):
//   * the scale is read from the table the wrapper passes (XLA's inexact
//     exp2, see repro_torch/core/zfp_tables.py), indexed by clamped emax;
//   * subnormal inputs count as signed zero (XLA's denormals-are-zero) and
//     subnormal decoded values are flushed to signed zero (XLA's
//     flush-to-zero).  Both are explicit: the block exponent treats a
//     largest magnitude below FLT_MIN as zero, and the one multiply of each
//     direction is PTX mul.rn.ftz.f32, which flushes its subnormal inputs
//     and results.  Neither scale table holds a subnormal, and a subnormal
//     product rounds to integer 0 either way, so this equals flushing before
//     and after the multiply.  The library is built without -ftz;
//   * __float2int_rn rounds half to even and saturates, NaN -> 0, as XLA's
//     round-then-convert does;
//   * the lifts add and subtract in uint32_t (wrapping, as XLA's int32 does)
//     and shift right on int32_t (arithmetic), in the reference's order.
//
// C interface (loaded with ctypes): each entry point launches one kernel on
// the given stream and returns cudaGetLastError() as an int.

#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace {

constexpr int kScaleEmin = -160;    // zfp_tables.EMIN
constexpr int kScaleEntries = 352;  // zfp_tables.EMAX - EMIN + 1
constexpr int kStages = 2;          // ring depth of the input stages

template <int D>
struct Cfg {
  static constexpr int BS = 1 << (2 * D);          // values per block
  static constexpr int ROWS = BS / 4;              // rows of 4 values per block
  static constexpr int T = D == 4 ? 32 : 128;      // blocks per tile = threads per CTA
  static constexpr int NG = BS >= 32 ? BS / 32 : 1;  // 32-coefficient groups per block
  static constexpr int PPW = BS >= 32 ? 1 : 32 / BS; // planes per word (BS < 32)
};

// The sequency permutation (core/zfp.py::sequency_permutation): flat indices
// of a 4^D block by total sequency, ties by flat index.
template <int D>
struct SeqPerm {
  int v[1 << (2 * D)];
};

template <int D>
__host__ __device__ constexpr SeqPerm<D> make_perm() {
  SeqPerm<D> p{};
  int k = 0;
  for (int s = 0; s <= 3 * D; ++s) {
    for (int i = 0; i < (1 << (2 * D)); ++i) {
      int t = 0;
      for (int a = 0; a < D; ++a) t += (i >> (2 * a)) & 3;
      if (t == s) p.v[k++] = i;
    }
  }
  return p;
}

// ---------------------------------------------------------------------------
// the padded field, in blocks, and its tiles
// ---------------------------------------------------------------------------

// A tile is a box of consecutive blocks: every block of the axes after a
// split axis k, m steps along k, one index of each axis before k.  In the
// field it is 4^k contiguous runs (one per intra-block coordinate of the
// axes before k), each 4·m hyperplanes of the axes after k, so a tile is
// 4^k bulk copies: 4 of 8 KB at 512^3 (k = 1), one for the (16384, 32, 32) leaf
// view and the (N, 4^d) block form (k = 0).  k is the first axis whose
// trailing blocks fit a tile.
struct Geo {
  long long c[4];   // blocks along each axis
  long long sp[4];  // values per step along each axis
  long long tiles;
  long long nk;     // tiles per index of the axes before k
  long long ck;     // c[k]
  int k;            // split axis
  int m;            // steps along k per tile (the last one may hold fewer)
  int inner;        // blocks of the axes after k
  int spk;          // sp[k]
};

struct Tile {
  long long first;  // first block in block order
  long long goff;   // field offset of the tile's first run
  int n;            // blocks
  int L;            // values per run
};

template <int D>
__device__ __forceinline__ Tile tile_of(const Geo& g, long long t) {
  long long gi = t / g.nk;
  const long long s = (t - gi * g.nk) * g.m;
  const int mm = static_cast<int>(min(static_cast<long long>(g.m), g.ck - s));
  Tile tl;
  tl.n = mm * g.inner;
  tl.first = (gi * g.ck + s) * g.inner;
  tl.L = 4 * mm * g.spk;
  long long off = 4 * s * g.spk;
#pragma unroll
  for (int a = D - 2; a >= 0; --a) {
    if (a < g.k) {
      const long long q = gi / g.c[a];
      off += 4 * (gi - q * g.c[a]) * g.sp[a];
      gi = q;
    }
  }
  tl.goff = off;
  return tl;
}

// Field offset of run j of a tile (j: the intra-block coordinates of the
// axes before k, base 4, the last fastest).
template <int D>
__device__ __forceinline__ long long run_offset(const Geo& g, const Tile& tl, int j) {
  long long off = tl.goff;
#pragma unroll
  for (int a = D - 2; a >= 0; --a) {
    if (a < g.k) {
      off += (j & 3) * g.sp[a];
      j >>= 2;
    }
  }
  return off;
}

// Stage offset of thread lk's block in a tile's runs: its steps along k and
// along the axes after it.  The same in every tile.
template <int D>
__device__ __forceinline__ int block_base(const Geo& g, int lk) {
  const int db = lk / g.inner;
  int rest = lk - db * g.inner;
  int base = 4 * db * g.spk;
#pragma unroll
  for (int a = D - 1; a >= 1; --a) {
    if (a > g.k) {
      const int ca = static_cast<int>(g.c[a]);
      const int q = rest / ca;
      base += 4 * (rest - q * ca) * static_cast<int>(g.sp[a]);
      rest = q;
    }
  }
  return base;
}

// Stage strides of the intra-block coordinates of all axes but the last: a
// run's length (times 4^...) before k, the field's strides from k on.
template <int D>
__device__ __forceinline__ void stage_strides(const Geo& g, int L, int* ss) {
#pragma unroll
  for (int a = 0; a < D - 1; ++a) {
    ss[a] = a < g.k ? L << (2 * (g.k - 1 - a)) : static_cast<int>(g.sp[a]);
  }
}

// Stage offset of intra-block row ip (the block's coordinates on all axes
// but the last, base 4, the last fastest) of the block at `base`.
template <int D>
__device__ __forceinline__ int row_offset(const int* ss, int ip, int base) {
#pragma unroll
  for (int a = D - 2; a >= 0; --a) {
    base += (ip & 3) * ss[a];
    ip >>= 2;
  }
  return base;
}

// ---------------------------------------------------------------------------
// mbarrier and bulk-copy primitives
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::
          "r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void bulk_store(void* dst, const void* src, uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;" ::"l"(dst),
               "r"(smem_u32(src)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

__device__ __forceinline__ void bulk_wait_read_all() {
  asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}

__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// ---------------------------------------------------------------------------
// arithmetic of one block
// ---------------------------------------------------------------------------

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

// Lift every 4-vector line of the block along each axis: axis 0 (stride
// 4^(D-1)) first on encode, the last axis first on decode.
template <int D, bool kInverse>
__device__ __forceinline__ void lift_block(int* q) {
#pragma unroll
  for (int a = 0; a < D; ++a) {
    const int axis = kInverse ? D - 1 - a : a;
    const int stride = 1 << (2 * (D - 1 - axis));
#pragma unroll
    for (int m = 0; m < Cfg<D>::ROWS; ++m) {
      const int b = (m / stride) * (4 * stride) + (m % stride);
      if (kInverse) {
        inv_lift(q[b], q[b + stride], q[b + 2 * stride], q[b + 3 * stride]);
      } else {
        fwd_lift(q[b], q[b + stride], q[b + 2 * stride], q[b + 3 * stride]);
      }
    }
  }
}

__device__ __forceinline__ float mul_ftz(float a, float b) {
  float r;
  asm("mul.rn.ftz.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ int scale_row(int e) {
  return min(max(e, kScaleEmin), kScaleEmin + kScaleEntries - 1) - kScaleEmin;
}

// One stage of the swap network over n words: swap the j-bit sub-blocks
// that mask m selects between words k and k + j.
template <int N, int J>
__device__ __forceinline__ void swap_stage(uint32_t* A) {
  constexpr uint32_t m = J == 16 ? 0x0000FFFFu : J == 8 ? 0x00FF00FFu
                       : J == 4 ? 0x0F0F0F0Fu : J == 2 ? 0x33333333u : 0x55555555u;
#pragma unroll
  for (int k = 0; k < N; k = (k + J + 1) & ~J) {
    const uint32_t t = (A[k] ^ (A[k + J] >> J)) & m;
    A[k] ^= t;
    A[k + J] ^= t << J;
  }
}

// A[c] bit 31 - r  ->  A[r] bit 31 - c, for all 32 rows.
__device__ __forceinline__ void transpose32(uint32_t* A) {
  swap_stage<32, 16>(A); swap_stage<32, 8>(A); swap_stage<32, 4>(A);
  swap_stage<32, 2>(A); swap_stage<32, 1>(A);
}

// Rows 0..15 of the transpose of A into H (the upper bits of every A[c]).
__device__ __forceinline__ void transpose32_upper(const uint32_t* A, uint32_t* H) {
#pragma unroll
  for (int k = 0; k < 16; ++k) H[k] = __byte_perm(A[k + 16], A[k], 0x7632);
  swap_stage<16, 8>(H); swap_stage<16, 4>(H); swap_stage<16, 2>(H); swap_stage<16, 1>(H);
}

// The inverse: rows 0..15 in H (rows 16..31 zero) back to 32 words in A.
__device__ __forceinline__ void untranspose32_upper(uint32_t* H, uint32_t* A) {
  swap_stage<16, 1>(H); swap_stage<16, 2>(H); swap_stage<16, 4>(H); swap_stage<16, 8>(H);
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    A[k] = H[k] & 0xFFFF0000u;
    A[k + 16] = H[k] << 16;
  }
}

// The 32 words that one transpose turns into bitplane words: for 4^D >= 32
// the group's coefficients; below, every coefficient once per plane of a
// word, shifted so that the planes of word w land in row PPW * w.
template <int D>
__device__ __forceinline__ void group_rows(const uint32_t* u, int j, uint32_t* A) {
  constexpr int BS = Cfg<D>::BS;
#pragma unroll
  for (int c = 0; c < 32; ++c) A[c] = BS >= 32 ? u[32 * j + c] : u[c % BS] << (c / BS);
}

// Store the bitplane words of group j (rows R of its transpose) as column
// `col` of the word-major stage.
template <int D, int NR>
__device__ __forceinline__ void put_words(const uint32_t* R, uint32_t* s_col, int ld, int col,
                                          int j, int rate, int wpb) {
  constexpr int NG = Cfg<D>::NG, PPW = Cfg<D>::PPW;
  if constexpr (Cfg<D>::BS >= 32) {
#pragma unroll
    for (int p = 0; p < NR; ++p) {
      if (p < rate) s_col[(p * NG + j) * ld + col] = R[p];
    }
  } else {
#pragma unroll
    for (int w = 0; w < 32 / PPW; ++w) {
      if (PPW * w < NR && w < wpb) s_col[w * ld + col] = R[PPW * w];
    }
  }
}

// The inverse: rows 0..NR-1 of group j's transpose from column `col` of the
// word-major stage (planes at or past the rate read as zero).
template <int D, int NR>
__device__ __forceinline__ void get_words(const uint32_t* s_col, int ld, int col, int j,
                                          int rate, uint32_t* R) {
  constexpr int BS = Cfg<D>::BS, NG = Cfg<D>::NG, PPW = Cfg<D>::PPW;
#pragma unroll
  for (int p = 0; p < NR; ++p) {
    const uint32_t word = p < rate ? s_col[(BS >= 32 ? p * NG + j : p / PPW) * ld + col] : 0u;
    R[p] = BS >= 32 ? word : word << ((p % PPW) * BS);
  }
}

// ---------------------------------------------------------------------------
// shared memory layouts (host and device compute the same offsets)
// ---------------------------------------------------------------------------

__host__ __device__ constexpr uint32_t round_up(uint32_t x, uint32_t m) {
  return (x + m - 1) / m * m;
}

constexpr uint32_t kScaleOffset = 64;  // after the stage mbarriers
constexpr uint32_t kRingOffset = round_up(kScaleOffset + 4 * kScaleEntries, 128);

struct EncLayout {
  uint32_t stage, col, total;
};

template <int D>
__host__ __device__ inline EncLayout enc_layout(int wpb) {
  constexpr int T = Cfg<D>::T;
  EncLayout l;
  l.stage = T * Cfg<D>::BS * 4;
  l.col = kRingOffset + kStages * l.stage;
  l.total = l.col + round_up((T + 1) * wpb * 4, 128);
  return l;
}

struct DecLayout {
  uint32_t payload, stage, col, out, total;
};

template <int D>
__host__ __device__ inline DecLayout dec_layout(int wpb) {
  constexpr int T = Cfg<D>::T;
  DecLayout l;
  l.payload = round_up(T * wpb * 4 + 32, 128);  // then the emax run
  l.stage = l.payload + round_up(T * 4 + 32, 128);
  l.col = kRingOffset + kStages * l.stage;
  l.out = l.col + round_up((T + 1) * wpb * 4, 128);
  l.total = l.out + T * Cfg<D>::BS * 4;
  return l;
}

// Warp 0 copies the runs of a tile between the field and a stage (run j at
// j · L in the stage).
template <int D, bool kLoad>
__device__ __forceinline__ void copy_runs(const Geo& g, const Tile& tl, float* field,
                                          float* stage, uint64_t* bar, int lane) {
  const int nrun = 1 << (2 * g.k);
  const uint32_t bytes = 4u * tl.L;
  if (kLoad) {
    if (lane == 0) mbar_expect_tx(bar, bytes * nrun);
    __syncwarp();
  }
  for (int j = lane; j < nrun; j += 32) {
    float* gp = field + run_offset<D>(g, tl, j);
    float* sp = stage + j * tl.L;
    if (kLoad) {
      bulk_load(sp, gp, bytes, bar);
    } else {
      bulk_store(gp, sp, bytes);
    }
  }
}

// ---------------------------------------------------------------------------
// encode
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(Cfg<D>::T)
zfp_encode_kernel(const float* __restrict__ x, uint32_t* __restrict__ payload,
                  int* __restrict__ emax_out, const float* __restrict__ scale, Geo g,
                  int rate, int given_emax) {
  constexpr int BS = Cfg<D>::BS, ROWS = Cfg<D>::ROWS, T = Cfg<D>::T, NG = Cfg<D>::NG;
  extern __shared__ __align__(128) unsigned char smem[];
  const int wpb = (rate * BS + 31) >> 5;
  const EncLayout L = enc_layout<D>(wpb);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  float* s_scale = reinterpret_cast<float*>(smem + kScaleOffset);
  uint32_t* s_col = reinterpret_cast<uint32_t*>(smem + L.col);
  constexpr int ld = T + 1;
  const int k = threadIdx.x, lane = k & 31, warp = k >> 5;
  const long long step = gridDim.x;
  float* field = const_cast<float*>(x);

  for (int i = k; i < kScaleEntries; i += T) s_scale[i] = scale[i];
  if (k == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(&full[s], 1);
    fence_mbar_init();
  }
  __syncthreads();
  if (warp == 0) {
    for (int s = 0; s < kStages; ++s) {
      const long long t = blockIdx.x + s * step;
      if (t < g.tiles) {
        copy_runs<D, true>(g, tile_of<D>(g, t), field,
                           reinterpret_cast<float*>(smem + kRingOffset + s * L.stage), &full[s],
                           lane);
      }
    }
  }
  const uint32_t keep = rate >= 32 ? 0xFFFFFFFFu : ~(0xFFFFFFFFu >> rate);
  const int base = block_base<D>(g, k);
  const int dq = T / wpb, dr = T % wpb;
  const int q0 = k / wpb, r0 = k % wpb;
  constexpr SeqPerm<D> perm = make_perm<D>();

  long long it = 0;
  for (long long t = blockIdx.x; t < g.tiles; t += step, ++it) {
    const int s = static_cast<int>(it % kStages);
    const Tile tl = tile_of<D>(g, t);
    const float* st = reinterpret_cast<const float*>(smem + kRingOffset + s * L.stage);
    mbar_wait(&full[s], static_cast<uint32_t>((it / kStages) & 1));
    const bool live = k < tl.n;

    // 1. the block's values: one 16-byte piece for each row of 4
    int ss[D > 1 ? D - 1 : 1];
    stage_strides<D>(g, tl.L, ss);
    uint32_t v[BS];
#pragma unroll
    for (int ip = 0; ip < ROWS; ++ip) {
      const uint4 f = live ? *reinterpret_cast<const uint4*>(st + row_offset<D>(ss, ip, base))
                           : make_uint4(0u, 0u, 0u, 0u);
      v[4 * ip] = f.x; v[4 * ip + 1] = f.y; v[4 * ip + 2] = f.z; v[4 * ip + 3] = f.w;
    }
    __syncthreads();  // stage s is read, the payload stage is written out
    if (warp == 0) {
      const long long tn = t + kStages * step;
      if (tn < g.tiles) {
        copy_runs<D, true>(g, tile_of<D>(g, tn), field,
                           reinterpret_cast<float*>(smem + kRingOffset + s * L.stage), &full[s],
                           lane);
      }
    }

    if (live) {
      // 2. block exponent: frexp's exponent of the largest magnitude, 0 for a
      //    block of zeros and subnormals and for one holding inf or NaN; or
      //    the caller's, already in emax_out (given_emax: what the reference
      //    takes from signed integer data, whose minimum it leaves out)
      int e;
      if (given_emax) {
        e = emax_out[tl.first + k];
      } else {
        uint32_t m = 0u;
#pragma unroll
        for (int i = 0; i < BS; ++i) m = max(m, v[i] & 0x7fffffffu);
        e = (m < 0x00800000u || m >= 0x7f800000u) ? 0 : static_cast<int>(m >> 23) - 126;
        emax_out[tl.first + k] = e;
      }
      const float sc = s_scale[scale_row(e)];

      // 3. fixed point: saturating round-half-even of x * scale, NaN -> 0
      int q[BS];
#pragma unroll
      for (int i = 0; i < BS; ++i) q[i] = __float2int_rn(mul_ftz(__uint_as_float(v[i]), sc));

      // 4. forward lift along each axis
      lift_block<D, false>(q);

      // 5. negabinary in sequency order, planes below the rate cleared
      uint32_t u[BS];
#pragma unroll
      for (int c = 0; c < BS; ++c) {
        u[c] = ((static_cast<uint32_t>(q[perm.v[c]]) + 0xaaaaaaaau) ^ 0xaaaaaaaau) & keep;
      }

      // 6. bitplane words, one 32x32 transpose per group
#pragma unroll
      for (int j = 0; j < NG; ++j) {
        uint32_t A[32];
        group_rows<D>(u, j, A);
        if (rate <= 16) {
          uint32_t H[16];
          transpose32_upper(A, H);
          put_words<D, 16>(H, s_col, ld, k, j, rate, wpb);
        } else {
          transpose32(A);
          put_words<D, 32>(A, s_col, ld, k, j, rate, wpb);
        }
      }
    }
    __syncthreads();

    // 7. coalesced store of the tile's payload rows (contiguous)
    uint32_t* pt = payload + tl.first * wpb;
    const int nw = tl.n * wpb;
    for (int i = k, qq = q0, rr = r0; i < nw; i += T) {
      pt[i] = s_col[rr * ld + qq];
      qq += dq;
      rr += dr;
      if (rr >= wpb) { rr -= wpb; ++qq; }
    }
  }
}

// ---------------------------------------------------------------------------
// decode
// ---------------------------------------------------------------------------

// Fetch a tile's payload rows and emax: the 16-byte aligned runs that hold
// them (a run's ends stay inside 16-byte chunks that hold valid bytes).
__device__ __forceinline__ void load_words(const uint32_t* payload, const int* emax,
                                           long long first, int n, int wpb,
                                           unsigned char* stage, uint32_t payload_bytes,
                                           uint64_t* bar) {
  const long long pa = (first * wpb * 4) & ~15ll;
  const long long pe = ((first + n) * wpb * 4 + 15) & ~15ll;
  const long long ea = (first * 4) & ~15ll;
  const long long ee = ((first + n) * 4 + 15) & ~15ll;
  mbar_expect_tx(bar, static_cast<uint32_t>((pe - pa) + (ee - ea)));
  bulk_load(stage, reinterpret_cast<const unsigned char*>(payload) + pa,
            static_cast<uint32_t>(pe - pa), bar);
  bulk_load(stage + payload_bytes, reinterpret_cast<const unsigned char*>(emax) + ea,
            static_cast<uint32_t>(ee - ea), bar);
}

template <int D>
__global__ void __launch_bounds__(Cfg<D>::T)
zfp_decode_kernel(const uint32_t* __restrict__ payload, const int* __restrict__ emax,
                  float* __restrict__ out, const float* __restrict__ scale, Geo g, int rate) {
  constexpr int BS = Cfg<D>::BS, ROWS = Cfg<D>::ROWS, T = Cfg<D>::T, NG = Cfg<D>::NG;
  extern __shared__ __align__(128) unsigned char smem[];
  const int wpb = (rate * BS + 31) >> 5;
  const DecLayout L = dec_layout<D>(wpb);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  float* s_scale = reinterpret_cast<float*>(smem + kScaleOffset);
  uint32_t* s_col = reinterpret_cast<uint32_t*>(smem + L.col);
  float* s_out = reinterpret_cast<float*>(smem + L.out);
  constexpr int ld = T + 1;
  const int k = threadIdx.x, lane = k & 31, warp = k >> 5;
  const long long step = gridDim.x;

  for (int i = k; i < kScaleEntries; i += T) s_scale[i] = scale[i];
  if (k == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(&full[s], 1);
    fence_mbar_init();
    for (int s = 0; s < kStages; ++s) {
      const long long t = blockIdx.x + s * step;
      if (t < g.tiles) {
        const Tile tl = tile_of<D>(g, t);
        load_words(payload, emax, tl.first, tl.n, wpb, smem + kRingOffset + s * L.stage,
                   L.payload, &full[s]);
      }
    }
  }
  __syncthreads();
  const int dq = T / wpb, dr = T % wpb;
  const int q0 = k / wpb, r0 = k % wpb;
  const int base = block_base<D>(g, k);
  constexpr SeqPerm<D> perm = make_perm<D>();

  long long it = 0;
  for (long long t = blockIdx.x; t < g.tiles; t += step, ++it) {
    const int s = static_cast<int>(it % kStages);
    const Tile tl = tile_of<D>(g, t);
    unsigned char* st = smem + kRingOffset + s * L.stage;
    mbar_wait(&full[s], static_cast<uint32_t>((it / kStages) & 1));
    const bool live = k < tl.n;

    // 1. payload rows into the word-major stage; this block's emax
    const uint32_t* sp = reinterpret_cast<const uint32_t*>(st) + ((tl.first * wpb) & 3);
    const int nw = tl.n * wpb;
    for (int i = k, qq = q0, rr = r0; i < nw; i += T) {
      s_col[rr * ld + qq] = sp[i];
      qq += dq;
      rr += dr;
      if (rr >= wpb) { rr -= wpb; ++qq; }
    }
    const int e = live ? reinterpret_cast<const int*>(st + L.payload)[(tl.first & 3) + k] : 0;
    __syncthreads();  // stage s is read
    if (k == 0) {
      const long long tn = t + kStages * step;
      if (tn < g.tiles) {
        const Tile tn_l = tile_of<D>(g, tn);
        load_words(payload, emax, tn_l.first, tn_l.n, wpb, st, L.payload, &full[s]);
      }
    }

    int q[BS];
    if (live) {
      // 2. bitplanes back to negabinary coefficients (sequency order)
      uint32_t u[BS];
#pragma unroll
      for (int j = 0; j < NG; ++j) {
        uint32_t A[32];
        if (rate <= 16) {
          uint32_t H[16];
          get_words<D, 16>(s_col, ld, k, j, rate, H);
          untranspose32_upper(H, A);
        } else {
          get_words<D, 32>(s_col, ld, k, j, rate, A);
          transpose32(A);
        }
#pragma unroll
        for (int c = 0; c < (BS >= 32 ? 32 : BS); ++c) u[(BS >= 32 ? 32 * j : 0) + c] = A[c];
      }
      // 3. negabinary -> int, back to block order; inverse lift
#pragma unroll
      for (int c = 0; c < BS; ++c) {
        q[perm.v[c]] = static_cast<int>((u[c] ^ 0xaaaaaaaau) - 0xaaaaaaaau);
      }
      lift_block<D, true>(q);
    }
    // the field stage is free once the last tile's bulk store has read it
    if (warp == 0) bulk_wait_read_all();
    __syncthreads();

    if (live) {
      // 4. scale back; subnormal results flushed to signed zero
      int ss[D > 1 ? D - 1 : 1];
      stage_strides<D>(g, tl.L, ss);
      const float sc = s_scale[scale_row(e)];
#pragma unroll
      for (int ip = 0; ip < ROWS; ++ip) {
        float4 f;
        f.x = mul_ftz(__int2float_rn(q[4 * ip]), sc);
        f.y = mul_ftz(__int2float_rn(q[4 * ip + 1]), sc);
        f.z = mul_ftz(__int2float_rn(q[4 * ip + 2]), sc);
        f.w = mul_ftz(__int2float_rn(q[4 * ip + 3]), sc);
        *reinterpret_cast<float4*>(s_out + row_offset<D>(ss, ip, base)) = f;
      }
    }
    fence_proxy_async();
    __syncthreads();
    if (warp == 0) {
      copy_runs<D, false>(g, tl, out, s_out, nullptr, lane);
      bulk_commit();
    }
  }
  if (warp == 0) bulk_wait_all();
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

// The field's geometry; false if a dimension is not a positive multiple of 4.
template <int D>
bool make_geo(const long long* shape, Geo* g) {
  constexpr int T = Cfg<D>::T;
  *g = Geo{};
  for (int a = 0; a < D; ++a) {
    if (shape[a] <= 0 || shape[a] % 4) return false;
    g->c[a] = shape[a] / 4;
  }
  // k: the first axis whose trailing blocks (those of the axes after it) fit a tile
  long long trailing = 1;
  g->k = D - 1;
  for (int a = D - 1; a >= 0 && trailing <= T; --a) {
    g->k = a;
    trailing *= g->c[a];
  }
  const int k = g->k;
  long long inner = 1, before = 1;
  for (int a = k + 1; a < D; ++a) inner *= g->c[a];
  for (int a = 0; a < k; ++a) before *= g->c[a];
  g->sp[D - 1] = 1;
  for (int a = D - 2; a >= 0; --a) g->sp[a] = g->sp[a + 1] * shape[a + 1];
  g->inner = static_cast<int>(inner);
  g->m = static_cast<int>(std::min<long long>(T / inner, g->c[k]));
  g->nk = (g->c[k] + g->m - 1) / g->m;
  g->tiles = before * g->nk;
  g->spk = static_cast<int>(g->sp[k]);
  g->ck = g->c[k];
  return true;
}

// The shared-memory limit is the kernel's, shared by every host thread: it is
// set to what the largest rate needs (`smem_max`), so a concurrent launch at
// a lower rate never lowers it under this launch's size.
template <typename Kernel>
int launch_info(Kernel kernel, int threads, uint32_t smem, uint32_t smem_max, int* smem_out,
                int* per_sm) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem_max));
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel, threads, smem);
  }
  *smem_out = static_cast<int>(smem);
  return static_cast<int>(err);
}

// A grid of as many CTAs as fit on the device at once, or one per tile.
template <typename Kernel>
int launch_persistent(Kernel kernel, int threads, uint32_t smem, uint32_t smem_max,
                      long long tiles, unsigned* grid) {
  int device = 0, sms = 0, per_sm = 0, smem_set = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rc = launch_info(kernel, threads, smem, smem_max, &smem_set, &per_sm);
  if (rc) return rc;
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  *grid = static_cast<unsigned>(std::min(tiles, static_cast<long long>(per_sm) * sms));
  return 0;
}

template <int D>
int kernel_info(int rate, int decode, int* smem, int* per_sm) {
  const int wpb = (rate * Cfg<D>::BS + 31) >> 5;
  return decode ? launch_info(zfp_decode_kernel<D>, Cfg<D>::T, dec_layout<D>(wpb).total,
                              dec_layout<D>(Cfg<D>::BS).total, smem, per_sm)
                : launch_info(zfp_encode_kernel<D>, Cfg<D>::T, enc_layout<D>(wpb).total,
                              enc_layout<D>(Cfg<D>::BS).total, smem, per_sm);
}

template <int D>
int launch_encode(const void* x, void* payload, void* emax, const void* scale,
                  const long long* shape, int rate, int given_emax, cudaStream_t stream) {
  Geo g;
  if (!make_geo<D>(shape, &g)) return static_cast<int>(cudaErrorInvalidValue);
  const int wpb = (rate * Cfg<D>::BS + 31) >> 5;
  const uint32_t smem = enc_layout<D>(wpb).total;
  unsigned grid = 0;
  const int rc = launch_persistent(zfp_encode_kernel<D>, Cfg<D>::T, smem,
                                   enc_layout<D>(Cfg<D>::BS).total, g.tiles, &grid);
  if (rc) return rc;
  zfp_encode_kernel<D><<<grid, Cfg<D>::T, smem, stream>>>(
      static_cast<const float*>(x), static_cast<uint32_t*>(payload), static_cast<int*>(emax),
      static_cast<const float*>(scale), g, rate, given_emax);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_decode(const void* payload, const void* emax, void* out, const void* scale,
                  const long long* shape, int rate, cudaStream_t stream) {
  Geo g;
  if (!make_geo<D>(shape, &g)) return static_cast<int>(cudaErrorInvalidValue);
  const int wpb = (rate * Cfg<D>::BS + 31) >> 5;
  const uint32_t smem = dec_layout<D>(wpb).total;
  unsigned grid = 0;
  const int rc = launch_persistent(zfp_decode_kernel<D>, Cfg<D>::T, smem,
                                   dec_layout<D>(Cfg<D>::BS).total, g.tiles, &grid);
  if (rc) return rc;
  zfp_decode_kernel<D><<<grid, Cfg<D>::T, smem, stream>>>(
      static_cast<const uint32_t*>(payload), static_cast<const int*>(emax),
      static_cast<float*>(out), static_cast<const float*>(scale), g, rate);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

}  // namespace

// The padded field `x` (shape p0..p{dims-1}, each a multiple of 4) -> payload
// rows and emax in row-major block order.  With given_emax, `emax` already
// holds each block's exponent, which the encode uses instead of its own.
extern "C" int zfp_field_compress(const void* x, void* payload, void* emax, const void* scale,
                                  long long p0, long long p1, long long p2, long long p3,
                                  int dims, int rate, int given_emax, void* stream) {
  const long long shape[4] = {p0, p1, p2, p3};
  if (rate < 1 || rate > 32) return static_cast<int>(cudaErrorInvalidValue);
  if (!aligned16(x) || !aligned16(payload) || !aligned16(emax))
    return static_cast<int>(cudaErrorMisalignedAddress);
  for (int a = 0; a < dims && a < 4; ++a) {
    if (shape[a] == 0) return 0;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dims) {
    case 1: return launch_encode<1>(x, payload, emax, scale, shape, rate, given_emax, s);
    case 2: return launch_encode<2>(x, payload, emax, scale, shape, rate, given_emax, s);
    case 3: return launch_encode<3>(x, payload, emax, scale, shape, rate, given_emax, s);
    case 4: return launch_encode<4>(x, payload, emax, scale, shape, rate, given_emax, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The inverse: payload rows and emax -> the padded field `out`.
extern "C" int zfp_field_decompress(const void* payload, const void* emax, void* out,
                                    const void* scale, long long p0, long long p1, long long p2,
                                    long long p3, int dims, int rate, void* stream) {
  const long long shape[4] = {p0, p1, p2, p3};
  if (rate < 1 || rate > 32) return static_cast<int>(cudaErrorInvalidValue);
  if (!aligned16(payload) || !aligned16(emax) || !aligned16(out))
    return static_cast<int>(cudaErrorMisalignedAddress);
  for (int a = 0; a < dims && a < 4; ++a) {
    if (shape[a] == 0) return 0;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dims) {
    case 1: return launch_decode<1>(payload, emax, out, scale, shape, rate, s);
    case 2: return launch_decode<2>(payload, emax, out, scale, shape, rate, s);
    case 3: return launch_decode<3>(payload, emax, out, scale, shape, rate, s);
    case 4: return launch_decode<4>(payload, emax, out, scale, shape, rate, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Blocks per tile of the `dims`-D kernels (0 for an invalid dims).
extern "C" int zfp_tile_blocks(int dims) {
  switch (dims) {
    case 1: return Cfg<1>::T;
    case 2: return Cfg<2>::T;
    case 3: return Cfg<3>::T;
    case 4: return Cfg<4>::T;
    default: return 0;
  }
}

// The dynamic shared memory (bytes) and CTAs per SM of a launch of the
// `dims`-D encode (decode = 0) or decode (decode = 1) kernel at `rate`.
extern "C" int zfp_launch_info(int dims, int rate, int decode, int* smem, int* ctas_per_sm) {
  if (rate < 1 || rate > 32) return static_cast<int>(cudaErrorInvalidValue);
  switch (dims) {
    case 1: return kernel_info<1>(rate, decode, smem, ctas_per_sm);
    case 2: return kernel_info<2>(rate, decode, smem, ctas_per_sm);
    case 3: return kernel_info<3>(rate, decode, smem, ctas_per_sm);
    case 4: return kernel_info<4>(rate, decode, smem, ctas_per_sm);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
