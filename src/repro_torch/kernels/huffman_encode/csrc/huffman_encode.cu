// Huffman-X encode for Hopper (sm_90a): the per-key codebook gather
// (huffman_encode_lookup) and the serialisation that follows it
// (huffman_pack_stream).
//
// huffman_encode_lookup replaces the Pallas TPU kernel `encode_lookup` of
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
//
// huffman_pack_stream replaces no TPU kernel: the reference leaves its
// exclusive scan of the code lengths and its disjoint-bit word packing to
// XLA (src/repro/kernels/huffman_encode/ref.py:21, `pack_stream`), and the
// port's plain version (ref.pack_stream, core/bitstream.py pack_bits) runs
// about 25 int64 passes and two scatters over every symbol, the largest
// share of an MGARD compress call's device time.  It writes the reference's
// bytes: codes MSB-first, each masked to its length (32: all bits; 0:
// nothing), a code spilling into the next word, the words past the last
// code zero, and the bit offset of every chunk_size-th symbol as int32.
//
// What bounds it: 8 B read per symbol and the packed words written once, so
// MGARD's 135,005,697 keys of a 513^3 field (~0.8 Gbit packed) move
// ~1.18 GB, 0.35 ms at 3.35 TB/s.  The design keeps every per-symbol
// temporary in registers and shared memory, in three launches whatever N:
//
//   * pack_tile_sums: one CTA per tile of kPackTile (4096) symbols sums the
//     tile's lengths (at most 2^17 bits, an int) with 16-byte loads; the
//     CTAs also zero the words (the first and last word of a tile are shared
//     with its neighbours and ORed into);
//   * pack_scan_tiles: one CTA scans the tile sums into each tile's 64-bit
//     base bit offset, each warp 256 tiles in 8 warp-wide scans, so every
//     load and store is coalesced;
//   * pack_words: one CTA per tile loads 4 lengths and 4 codes a thread with
//     16-byte loads (each warp reads 512 contiguous bytes per round), scans
//     the lengths with warp shuffles, writes the offsets of the chunk starts
//     it holds, ORs each masked code into the tile's words in shared memory
//     (at most 4097 words; a thread gathers its consecutive codes in a
//     register and ORs each finished word once), then stores the words it
//     owns whole with coalesced plain stores and its first and last word,
//     shared with the neighbouring tiles, with a global atomicOr.  OR over
//     disjoint bits is order-free, so the bytes never change from run to
//     run.  CTAs of 256 threads, four an SM (64 registers), so one CTA's
//     loads overlap another's packing: with CTAs of 512 threads, one an SM
//     (91 registers), pack_words took 0.87 ms at MGARD's 513^3 keys on an
//     H100, against 0.53 ms (scripts/pack_ablation.py).
//
// Lengths are taken in [0, 32], as the codebooks give them; any other value
// gives unspecified words but never a write outside the outputs.

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

// ---------------------------------------------------------------------------
// pack_stream
// ---------------------------------------------------------------------------

constexpr int kPackThreads = 256;
constexpr int kPackWarps = kPackThreads / 32;
constexpr int kPackRounds = 4;                                   // 16-byte loads a thread
constexpr int kPackRoundSyms = 4 * kPackThreads;                 // symbols of one round
constexpr int kPackTile = kPackRounds * kPackRoundSyms;          // 4096 symbols a CTA
constexpr int kPackBufWords = kPackTile + 1;                     // words a tile's bits span
constexpr int kScanThreads = 1024;
constexpr int kScanItems = 8;                                    // tiles a scan lane takes

// Round r of thread t in tile `tile` covers symbols first + r * kPackRoundSyms
// + 4 t + [0, 4); the ones at or past n read as zero.
template <typename T, typename V>
__device__ __forceinline__ V load4(const T* __restrict__ p, long long i, long long n, bool vec) {
  if (vec && i + 3 < n) return __ldg(reinterpret_cast<const V*>(p + i));
  T v[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) v[k] = i + k < n ? __ldg(p + i + k) : T(0);
  return V{v[0], v[1], v[2], v[3]};
}

__device__ __forceinline__ int sum4(int4 v) { return v.x + v.y + v.z + v.w; }

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(0xffffffffu, v, d);
  return v;
}

__global__ void __launch_bounds__(kPackThreads)
pack_tile_sums(const int* __restrict__ lens, long long n, bool vec, long long* __restrict__ sums,
               uint32_t* __restrict__ words, long long num_words) {
  __shared__ int warp_part[kPackWarps];
  const long long first = static_cast<long long>(blockIdx.x) * kPackTile + 4 * threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * kPackThreads;
  for (long long g = static_cast<long long>(blockIdx.x) * kPackThreads + threadIdx.x;
       g < num_words; g += stride)
    words[g] = 0u;
  int s = 0;
#pragma unroll
  for (int r = 0; r < kPackRounds; ++r)
    s += sum4(load4<int, int4>(lens, first + r * kPackRoundSyms, n, vec));
  s = warp_sum(s);
  if ((threadIdx.x & 31) == 0) warp_part[threadIdx.x >> 5] = s;
  __syncthreads();
  if (threadIdx.x == 0) {
    int total = 0;
    for (int w = 0; w < kPackWarps; ++w) total += warp_part[w];
    sums[blockIdx.x] = total;
  }
}

// bases[t] = sums[0] + ... + sums[t - 1] for t in [0, tiles].  Lane l of
// warp w takes tiles w * 256 + 32 k + l of a round: each of its 8 loads and
// stores is one coalesced warp access, and 8 warp-wide scans with a running
// carry give the warp's 256 prefixes in order.
__global__ void __launch_bounds__(kScanThreads)
pack_scan_tiles(const long long* __restrict__ sums, long long tiles,
                long long* __restrict__ bases) {
  constexpr int kWarps = kScanThreads / 32;
  __shared__ long long warp_part[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  long long carry = 0;
  for (long long start = 0; start < tiles; start += kScanThreads * kScanItems) {
    const long long mine = start + static_cast<long long>(warp) * 32 * kScanItems + lane;
    long long v[kScanItems], inc[kScanItems], run = 0;
#pragma unroll
    for (int k = 0; k < kScanItems; ++k) v[k] = mine + 32 * k < tiles ? sums[mine + 32 * k] : 0;
#pragma unroll
    for (int k = 0; k < kScanItems; ++k) {
      long long x = v[k];
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const long long t = __shfl_up_sync(0xffffffffu, x, d);
        if (lane >= d) x += t;
      }
      inc[k] = run + x;
      run += __shfl_sync(0xffffffffu, x, 31);
    }
    if (lane == 0) warp_part[warp] = run;
    __syncthreads();
    long long before = 0, round = 0;
    for (int w = 0; w < kWarps; ++w) {
      before += w < warp ? warp_part[w] : 0;
      round += warp_part[w];
    }
#pragma unroll
    for (int k = 0; k < kScanItems; ++k)
      if (mine + 32 * k < tiles) bases[mine + 32 * k] = carry + before + inc[k] - v[k];
    carry += round;
    __syncthreads();  // warp_part is rewritten by the next round
  }
  if (threadIdx.x == 0) bases[tiles] = carry;
}

__device__ __forceinline__ uint32_t shl32(uint32_t x, int n) { return n >= 32 ? 0u : x << n; }
__device__ __forceinline__ uint32_t shr32(uint32_t x, int n) { return n >= 32 ? 0u : x >> n; }

// OR a finished word of a thread into the tile's shared words.
__device__ __forceinline__ void flush(uint32_t* buf, int w, uint32_t v) {
  if (v != 0u && static_cast<unsigned>(w) < static_cast<unsigned>(kPackBufWords))
    atomicOr(buf + w, v);
}

__global__ void __launch_bounds__(kPackThreads, 4)
pack_words(const uint32_t* __restrict__ codes, const int* __restrict__ lens, long long n, bool vec,
           const long long* __restrict__ bases, long long chunk,
           uint32_t* __restrict__ words, long long num_words, int* __restrict__ chunk_offsets) {
  __shared__ uint32_t buf[kPackBufWords];
  __shared__ int warp_part[kPackWarps][kPackRounds];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long first = static_cast<long long>(blockIdx.x) * kPackTile + 4 * threadIdx.x;

  int4 len[kPackRounds];
  uint4 code[kPackRounds];
#pragma unroll
  for (int r = 0; r < kPackRounds; ++r) {
    len[r] = load4<int, int4>(lens, first + r * kPackRoundSyms, n, vec);
    code[r] = load4<uint32_t, uint4>(codes, first + r * kPackRoundSyms, n, vec);
  }
  for (int i = threadIdx.x; i < kPackBufWords; i += kPackThreads) buf[i] = 0u;

  // Exclusive scan of the lengths over (round, thread), round-major.
  int s[kPackRounds], inc[kPackRounds];
#pragma unroll
  for (int r = 0; r < kPackRounds; ++r) inc[r] = s[r] = sum4(len[r]);
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
#pragma unroll
    for (int r = 0; r < kPackRounds; ++r) {
      const int t = __shfl_up_sync(0xffffffffu, inc[r], d);
      if (lane >= d) inc[r] += t;
    }
  }
  if (lane == 31) {
#pragma unroll
    for (int r = 0; r < kPackRounds; ++r) warp_part[warp][r] = inc[r];
  }
  __syncthreads();
  int start[kPackRounds], tile_bits = 0;
#pragma unroll
  for (int r = 0; r < kPackRounds; ++r) {
    int before = 0, round = 0;
    for (int w = 0; w < kPackWarps; ++w) {
      const int v = warp_part[w][r];
      before += w < warp ? v : 0;
      round += v;
    }
    start[r] = tile_bits + before + inc[r] - s[r];
    tile_bits += round;
  }
  const long long base = bases[blockIdx.x];
  const int b0 = static_cast<int>(base & 31);  // the tile's first bit in its first word
  const long long w0 = base >> 5;

  // Chunk starts: the symbols i with i % chunk == 0.  `gap` is how far the
  // first one at or past this thread's group of the round lies from it.
  long long gap = (chunk - first % chunk) % chunk;
  const long long step = kPackRoundSyms % chunk;
#pragma unroll
  for (int r = 0; r < kPackRounds; ++r) {
    const long long i0 = first + r * kPackRoundSyms;
    const int l[4] = {len[r].x, len[r].y, len[r].z, len[r].w};
    const uint32_t c[4] = {code[r].x, code[r].y, code[r].z, code[r].w};
    long long next = gap;
    int off = b0 + start[r];  // bit offset of symbol i0 + k from word w0
    int cw = -1;              // the word `acc` gathers
    uint32_t acc = 0u;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (k == next && i0 + k < n) {
        chunk_offsets[(i0 + k) / chunk] = static_cast<int>(static_cast<uint32_t>(base - b0 + off));
        next += chunk;
      }
      const int L = l[k];
      if (L > 0) {
        const int w = off >> 5, b = off & 31;
        const uint32_t v = c[k] & (L >= 32 ? 0xffffffffu : (1u << L) - 1u);
        const int sh = 32 - b - L;  // >= 0: the code fits in word w
        if (w != cw) {
          flush(buf, cw, acc);
          cw = w;
          acc = 0u;
        }
        if (sh >= 0) {
          acc |= shl32(v, sh);
        } else {  // the low bits spill into word w + 1
          acc |= shr32(v, -sh);
          flush(buf, cw, acc);
          cw = w + 1;
          acc = shl32(v, 32 + sh < 0 ? 0 : 32 + sh);
        }
      }
      off += L;
    }
    flush(buf, cw, acc);
    gap -= step;
    if (gap < 0) gap += chunk;
  }
  __syncthreads();

  // Words the tile owns whole are stored; the first and last, shared with
  // the neighbouring tiles (zeroed by pack_tile_sums), are ORed into.
  const int end = b0 + tile_bits;
  const int nbuf = tile_bits <= 0 ? 0 : min((end + 31) >> 5, kPackBufWords);
  for (int i = threadIdx.x; i < nbuf; i += kPackThreads) {
    const long long g = w0 + i;
    if (g < 0 || g >= num_words) continue;
    const bool whole = (i > 0 || b0 == 0) && (i + 1) * 32 <= end;
    if (whole) words[g] = buf[i];
    else if (buf[i] != 0u) atomicOr(words + g, buf[i]);
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

// Exclusive scan of lens[0..n) and MSB-first packing of each code, masked to
// its length, into words[0..num_words) (uint32 bits; words past the last code
// zero); chunk_offsets[c] = the bit offset of symbol c * chunk_size, as int32,
// for c < ceil(n / chunk_size).  `tile` is the caller's kPackTile and
// `scratch` holds 2 * ceil(n / tile) + 1 int64.  Three launches on `stream`;
// returns the CUDA error of the launches (0 on success).
extern "C" int huffman_pack_stream(const void* codes, const void* lens, long long n,
                                   long long num_words, long long chunk_size, int tile,
                                   void* words, void* chunk_offsets, void* scratch,
                                   void* stream) {
  if (tile != kPackTile || n < 0 || num_words < 0 || chunk_size < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long tiles = (n + kPackTile - 1) / kPackTile;
  if (tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = ((reinterpret_cast<uintptr_t>(codes) | reinterpret_cast<uintptr_t>(lens)) &
                    15) == 0;
  const uint32_t* c = static_cast<const uint32_t*>(codes);
  const int* l = static_cast<const int*>(lens);
  uint32_t* w = static_cast<uint32_t*>(words);
  long long* sums = static_cast<long long*>(scratch);
  long long* bases = sums + tiles;
  const unsigned grid = static_cast<unsigned>(tiles);
  pack_tile_sums<<<grid, kPackThreads, 0, s>>>(l, n, vec, sums, w, num_words);
  pack_scan_tiles<<<1, kScanThreads, 0, s>>>(sums, tiles, bases);
  pack_words<<<grid, kPackThreads, 0, s>>>(c, l, n, vec, bases, chunk_size, w, num_words,
                                           static_cast<int*>(chunk_offsets));
  return static_cast<int>(cudaGetLastError());
}
