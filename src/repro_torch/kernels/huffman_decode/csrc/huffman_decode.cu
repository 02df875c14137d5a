// Chunk-parallel canonical-Huffman decode for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `decode_chunks` of
// src/repro/kernels/huffman_decode/kernel.py:58 (pallas_call at kernel.py:76).
// The packed stream is self-synchronising per chunk of `chunk_size` symbols
// (the encoder stores every chunk's bit offset), so chunks decode
// independently; inside a chunk the bit cursor is sequential.  Per symbol the
// plain version (kernels/huffman_decode/ref.py) does:
//
//   1. read the 32-bit MSB-aligned window at the cursor (bits past the end
//      of the stream read as zero: repro.core.bitstream.read_window);
//   2. the code length l is the first (shortest) l in 1..max_len with
//      first_code[l] <= window >> (32 - l) < first_code[l] + count[l];
//   3. emit sym_sorted[sym_offset[l] + (window >> (32 - l)) - first_code[l]]
//      and advance the cursor by l.
//
// Where no length is valid (the padding symbols decoded past the end of the
// stream), l is 1 and the index is normalised and clamped the way the
// reference's gather treats it (a negative index counts from the end, then
// clamps into range), so every symbol of the (C, chunk_size) output equals
// the plain version's, padding included.
//
// What bounds it: it must write 4 B per symbol and read the compressed words
// once (2^26 symbols: 268 MB out plus the stream, about 0.1 ms at
// 3.35 TB/s).  One thread walks one chunk, so the work is a chain of
// dependent steps per thread, and the design keeps that chain short:
//
//   * A lookup table in shared memory, indexed by the next K = min(max_len,
//     13) bits, gives the length and the symbol of every code of length
//     <= K in one 4-byte load (for l <= K, window >> (32 - l) depends only
//     on the K-bit prefix, so the entry is exact).  It is built in the
//     prologue of every CTA from the three canonical tables;
//     ref.py::decode_lut is its plain mirror.  A prefix that no length <= K
//     accepts is an escape: the canonical scan then runs on from l = K + 1
//     on the full window, with the no-match rule above.  (Entries of 8 bytes
//     took twice the bank conflicts.)
//   * The cursor is a 128-bit window of the stream in four registers,
//     refilled one 32-bit word at a time, from the next word already read,
//     when 96 or fewer bits remain.  The next table index depends on the
//     length just decoded through one funnel shift, so a symbol's dependent
//     chain is one shared load and two shifts; the next entry is looked up
//     before the escape vote, which then waits alongside that load.  The
//     code is straight-line: the refill is predicated, and the escape scan
//     runs for the whole warp, predicated, when the vote finds an escaping
//     lane, so the lanes never split.
//   * The words come from shared memory, never straight from device
//     memory: a warp's lanes refill at different steps, and a refill that
//     waited on a device load issued one step earlier by another lane (one
//     scoreboard per register, not per lane) put a memory latency on nearly
//     every step.  Each lane decodes in batches of 32 symbols (at most
//     32 * max_len bits) and, at the start of a batch, asks cp.async for a
//     window of the words the next batch can reach; it waits for that
//     window only when the batch ends.
//   * CTAs of 128 threads; each warp stages 32 symbols of each of its 32
//     chunks in shared memory and then writes them as 32 rows of 128
//     contiguous bytes, instead of 32 scattered 16-byte pieces (which
//     measured slower on every main-path key set).
//
// With 2^26 symbols in chunks of 4096 there are only 16,384 chunks, so the
// card holds about four warps per SM, one per scheduler, and every
// instruction's latency on a lane's path is exposed: the chain, not the
// bytes, stays the limit.  Splitting a chunk between threads at
// self-synchronising bit positions is the next step.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxLen = 32;
constexpr int kLutBits = 13;
constexpr int kSymBits = 25;              // symbols the table packs beside a length
constexpr int kStage = 32;               // symbols per lane between two flushes
constexpr int kStageStride = kStage + 1;  // padded: no bank conflicts either way

struct Tables {
  uint32_t fc[kMaxLen + 1];
  int ct[kMaxLen + 1];
  int so[kMaxLen + 1];
};

// sym_sorted[so + rel] with the reference's int32 wrap, negative-from-end and
// clamp.
__device__ __forceinline__ int gather(const int* __restrict__ syms, int n_sym, int so,
                                      uint32_t rel) {
  int idx = static_cast<int>(static_cast<uint32_t>(so) + rel);
  if (idx < 0) idx += n_sym;
  idx = idx < 0 ? 0 : (idx >= n_sym ? n_sym - 1 : idx);
  return __ldg(syms + idx);
}

// A window of `size` words from word `at` (a multiple of 4) into shared
// memory, 16 bytes per cp.async; words outside [0, n_words) read as zero.
// `words` must be 16-byte aligned.
__device__ __forceinline__ void fetch_window(uint32_t* dst, const uint32_t* __restrict__ words,
                                             long long n_words, long long at, int size) {
  for (int k = 0; k < size; k += 4) {
    const long long w = at + k;
    const long long valid = w < 0 ? 0 : (n_words - w < 4 ? n_words - w : 4);
    const int bytes = valid > 0 ? static_cast<int>(valid) * 4 : 0;
    const uint32_t* src = bytes ? words + w : words;
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst + k));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
                 "r"(bytes)
                 : "memory");
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void wait_windows() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// A table entry: (symbol << 6) | length, or, where the table cannot give
// the symbol, (from << 6) with length 0: the scan must run from length
// `from` (K + 1 for a prefix no length <= K accepts; the code's own length
// for a symbol of kSymBits or more bits).
__device__ __forceinline__ uint32_t lut_entry(const Tables& t, const int* __restrict__ syms,
                                              int n_sym, uint32_t prefix, int lut_bits) {
  for (int l = 1; l <= lut_bits; ++l) {
    const uint32_t cand = prefix >> (lut_bits - l);
    const uint32_t r = cand - t.fc[l];
    if (cand >= t.fc[l] && r < static_cast<uint32_t>(t.ct[l])) {
      const uint32_t sym = static_cast<uint32_t>(gather(syms, n_sym, t.so[l], r));
      return sym < (1u << kSymBits) ? (sym << 6) | static_cast<uint32_t>(l)
                                    : static_cast<uint32_t>(l) << 6;
    }
  }
  return static_cast<uint32_t>(lut_bits + 1) << 6;
}

// The canonical scan from length `from` on, for the lanes whose entry is an
// escape (`esc`), with the no-match rule where no length is valid.  Every
// lane of the warp runs it, predicated, so the warp never splits; it stops
// when no escaping lane is still looking.
__device__ __forceinline__ int2 scan_from(bool esc, uint32_t win, int from, int max_len,
                                          const Tables& t, const int* __restrict__ syms,
                                          int n_sym) {
  int len = 1;
  uint32_t rel = (win >> 31) - t.fc[1];
  bool found = !esc;
  const int first = __reduce_min_sync(0xffffffffu, esc ? from : kMaxLen + 1);
  for (int l = first; l <= max_len && __any_sync(0xffffffffu, !found); ++l) {
    const uint32_t cand = win >> (32 - l);
    const uint32_t r = cand - t.fc[l];
    const bool hit =
        !found && l >= from && cand >= t.fc[l] && r < static_cast<uint32_t>(t.ct[l]);
    len = hit ? l : len;
    rel = hit ? r : rel;
    found = found || hit;
  }
  return make_int2(esc ? len : 0, esc ? gather(syms, n_sym, t.so[len], rel) : 0);
}

// The bit cursor of one chunk: w0..w3 hold the next 128 bits of the stream,
// most significant first, of which the top `nvalid` (97 to 128 between two
// symbols) are valid and end on a word boundary; `next` is the word at
// `win[at]`, read ahead, the next to append; `e` is the table entry of the
// symbol at the cursor, already looked up.  The table index of the next
// symbol is the top bits of w0, which depend on the length just decoded
// through one funnel shift only: refills land in w2 and w3, off that chain.
struct Cursor {
  uint32_t w0, w1, w2, w3;
  int nvalid;
  int at;
  uint32_t next;
  uint32_t e;
  const uint32_t* win;

  // `pos` is the chunk's first bit; the window holds the words from word
  // `pos / 32` rounded down to a multiple of 4.
  __device__ __forceinline__ void start(long long pos, const uint32_t* lut, int lut_bits) {
    const int b = static_cast<int>(pos & 31);
    const uint32_t* src = win + ((pos >> 5) & 3);
    w0 = __funnelshift_lc(src[1], src[0], b);
    w1 = __funnelshift_lc(src[2], src[1], b);
    w2 = __funnelshift_lc(src[3], src[2], b);
    w3 = __funnelshift_lc(0u, src[3], b);
    nvalid = 128 - b;
    at = static_cast<int>((pos >> 5) & 3) + 4;
    next = win[at];
    e = lut[w0 >> (32 - lut_bits)];
  }

  // Consumes `len` bits (0: none) and appends `next` when 96 or fewer valid
  // bits remain; branch-free (otherwise nothing is added and `next` is read
  // again).
  __device__ __forceinline__ void advance(int len) {
    w0 = __funnelshift_lc(w1, w0, len);
    w1 = __funnelshift_lc(w2, w1, len);
    w2 = __funnelshift_lc(w3, w2, len);
    w3 = __funnelshift_lc(0u, w3, len);
    nvalid -= len;
    const bool low = nvalid <= 96;
    const uint64_t add = static_cast<uint64_t>(low ? next : 0u) << (low ? 96 - nvalid : 0);
    w2 |= static_cast<uint32_t>(add >> 32);
    w3 |= static_cast<uint32_t>(add);
    nvalid += low ? 32 : 0;
    at += low ? 1 : 0;
    next = win[at];
  }

  // One symbol.  The entry of the next symbol is looked up before the
  // escape vote, so the vote waits alongside that load instead of before
  // it; an escaping lane advanced by 0, so its window is still the
  // symbol's, and it is advanced and looked up again after the scan.
  __device__ __forceinline__ int decode(const uint32_t* __restrict__ lut, int lut_bits,
                                        int max_len, const Tables& t,
                                        const int* __restrict__ syms, int n_sym) {
    const uint32_t cur = e;
    const int len = static_cast<int>(cur & 63);
    const uint32_t win32 = w0;
    advance(len);
    e = lut[w0 >> (32 - lut_bits)];
    int sym = static_cast<int>(cur >> 6);
    const bool esc = len == 0;
    if (__any_sync(0xffffffffu, esc)) {
      const int2 r = scan_from(esc, win32, sym, max_len, t, syms, n_sym);
      advance(r.x);
      if (esc) {
        sym = r.y;
        e = lut[w0 >> (32 - lut_bits)];
      }
    }
    return sym;
  }

  // Moves to the next window, fetched from word `moved` words further on.
  __device__ __forceinline__ void slide(const uint32_t* to, int moved) {
    win = to;
    at -= moved;
  }
};

// Words a window must hold: a batch of kStage symbols moves the cursor at
// most max_len words, so a window fetched at the start of one batch, from
// the read-ahead word rounded down to 16 bytes, covers the next batch (and
// the first window the four words the cursor starts with).
__host__ __device__ constexpr int window_words(int max_len) {
  return ((2 * max_len + 4 > max_len + 8 ? 2 * max_len + 4 : max_len + 8) + 3) & ~3;
}

// Words between two lanes' pairs of windows: a multiple of 4 (16-byte
// copies) and an odd number of 16-byte units, so lanes reading the same
// offset spread over the banks.
__host__ __device__ constexpr int lane_words(int max_len) {
  return 2 * window_words(max_len) + ((window_words(max_len) / 2) % 2 == 0 ? 4 : 0);
}

// Dynamic shared memory of a launch for codes of up to max_len bits: the
// lookup table, the warps' output stages and the lanes' windows.
constexpr int decode_smem(int max_len) {
  return static_cast<int>(sizeof(uint32_t)) * (1 << kLutBits) +
         static_cast<int>(sizeof(int)) * kWarps * 32 * kStageStride +
         static_cast<int>(sizeof(uint32_t)) * kThreads * lane_words(max_len);
}

__global__ void __launch_bounds__(kThreads)
decode_kernel(const uint32_t* __restrict__ words, long long n_words,
              const int* __restrict__ chunk_offsets, int n_chunks,
              const uint32_t* __restrict__ first_code, const int* __restrict__ count,
              const int* __restrict__ sym_offset, const int* __restrict__ sym_sorted, int n_sym,
              int max_len, int chunk_size, int* __restrict__ out) {
  __shared__ Tables t;
  extern __shared__ uint32_t smem[];
  const int lut_bits = max_len < kLutBits ? max_len : kLutBits;
  uint32_t* lut = smem;
  for (int i = threadIdx.x; i <= max_len; i += kThreads) {
    t.fc[i] = first_code[i];
    t.ct[i] = count[i];
    t.so[i] = sym_offset[i];
  }
  __syncthreads();
  for (int p = threadIdx.x; p < (1 << lut_bits); p += kThreads)
    lut[p] = lut_entry(t, sym_sorted, n_sym, static_cast<uint32_t>(p), lut_bits);
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int c0 = (blockIdx.x * kWarps + warp) * 32;  // this warp's first chunk
  if (c0 >= n_chunks) return;                          // whole warps only
  const int c = c0 + lane;
  const bool live = c < n_chunks;
  int* stage = reinterpret_cast<int*>(smem + (1 << kLutBits)) + warp * 32 * kStageStride;
  const int wsize = window_words(max_len);
  uint32_t* windows = smem + (1 << kLutBits) + kWarps * 32 * kStageStride +  // after the stages
                      threadIdx.x * lane_words(max_len);
  Cursor cur;
  const long long pos = live ? static_cast<long long>(chunk_offsets[c]) : 0;
  long long wa = (pos >> 5) & ~3LL;  // the window's first word
  cur.win = windows;
  fetch_window(windows, words, n_words, wa, wsize);
  wait_windows();
  cur.start(pos, lut, lut_bits);

  int* mine = stage + lane * kStageStride;
  for (int base = 0, b = 0; base < chunk_size; base += kStage, b ^= 1) {
    const int m = chunk_size - base < kStage ? chunk_size - base : kStage;
    const int moved = cur.at & ~3;  // the next window starts at the read-ahead word's 16 bytes
    uint32_t* next_win = windows + (b ^ 1) * wsize;
    if (base + m < chunk_size) fetch_window(next_win, words, n_words, wa + moved, wsize);
#pragma unroll 4
    for (int k = 0; k < m; ++k) mine[k] = cur.decode(lut, lut_bits, max_len, t, sym_sorted, n_sym);
    __syncwarp();
    if (lane < m) {
      for (int r = 0; r < 32 && c0 + r < n_chunks; ++r)
        out[static_cast<long long>(c0 + r) * chunk_size + base + lane] =
            stage[r * kStageStride + lane];
    }
    __syncwarp();
    wait_windows();
    cur.slide(next_win, moved);
    wa += moved;
  }
}

}  // namespace

// out[c, i] = the i-th symbol of chunk c.  The tables hold max_len + 1
// entries (max_len in [1, 32]); sym_sorted holds n_sym >= 1 entries;
// `words` must be 16-byte aligned.  Returns the CUDA error of the launch.
extern "C" int huffman_decode_chunks(const void* words, long long n_words,
                                     const void* chunk_offsets, int n_chunks,
                                     const void* first_code, const void* count,
                                     const void* sym_offset, const void* sym_sorted, int n_sym,
                                     int max_len, int chunk_size, void* out, void* stream) {
  if (max_len < 1 || max_len > kMaxLen || n_sym < 1 || chunk_size < 1 || n_chunks < 0 ||
      (reinterpret_cast<uintptr_t>(words) & 15) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_chunks == 0) return 0;
  const int smem = decode_smem(max_len);
  // The limit is the kernel's, shared by every host thread: set it to what the
  // longest codes need, so a concurrent launch for shorter codes never lowers
  // it under this launch's size.
  cudaError_t err = cudaFuncSetAttribute(decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         decode_smem(kMaxLen));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = (n_chunks + kThreads - 1) / kThreads;
  decode_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), n_words, static_cast<const int*>(chunk_offsets),
      n_chunks, static_cast<const uint32_t*>(first_code), static_cast<const int*>(count),
      static_cast<const int*>(sym_offset), static_cast<const int*>(sym_sorted), n_sym, max_len,
      chunk_size, static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}
