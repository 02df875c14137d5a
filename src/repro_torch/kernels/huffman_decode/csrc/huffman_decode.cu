// Chunk-parallel canonical-Huffman decode for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `decode_chunks` of
// src/repro/kernels/huffman_decode/kernel.py:58 (pallas_call at kernel.py:76).
// The packed stream is self-synchronising per chunk of `chunk_size` symbols
// (the encoder stores every chunk's bit offset), so chunks decode
// independently; inside a chunk the bit cursor is sequential.  Per symbol:
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
// Design: one thread per chunk keeps the cursor in a register.  The three
// canonical tables (at most 33 entries each) and, when it fits in 64 KB,
// sym_sorted live in shared memory, so the length scan and the symbol
// lookup never touch device memory; the words are read through the
// read-only path.  Symbols are written four at a time (one 16-byte store)
// when chunk_size allows.
//
// What bounds it: it must write 4 B per symbol and read the compressed words
// once (2^26 symbols: 268 MB out plus the stream, about 0.1 ms at
// 3.35 TB/s).  It does not come near that: 2^26 symbols in chunks of 4096
// are only 16384 threads, about 4 warps per SM, each walking its chunk one
// symbol after another, so the kernel is bound by the latency of that
// sequential chain, not by bytes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 32;
constexpr int kMaxLen = 32;
constexpr int kSharedSyms = 1 << 14;

struct Tables {
  uint32_t fc[kMaxLen + 1];
  int ct[kMaxLen + 1];
  int so[kMaxLen + 1];
};

__device__ __forceinline__ int decode_one(const uint32_t* __restrict__ words, long long n_words,
                                          long long& cursor, const Tables& t,
                                          const int* __restrict__ syms, int n_sym, int max_len) {
  const long long w = cursor >> 5;
  const int b = static_cast<int>(cursor & 31);
  const uint32_t w0 = (w >= 0 && w < n_words) ? __ldg(words + w) : 0u;
  const uint32_t w1 = (w + 1 >= 0 && w + 1 < n_words) ? __ldg(words + w + 1) : 0u;
  const uint32_t window = b ? (w0 << b) | (w1 >> (32 - b)) : w0;
  int len = 1;
  uint32_t rel = (window >> 31) - t.fc[1];
  for (int l = 1; l <= max_len; ++l) {
    const uint32_t cand = window >> (32 - l);
    const uint32_t r = cand - t.fc[l];
    if (cand >= t.fc[l] && r < static_cast<uint32_t>(t.ct[l])) {
      len = l;
      rel = r;
      break;
    }
  }
  int idx = static_cast<int>(static_cast<uint32_t>(t.so[len]) + rel);  // int32 wrap
  if (idx < 0) idx += n_sym;
  idx = idx < 0 ? 0 : (idx >= n_sym ? n_sym - 1 : idx);
  cursor += len;
  return syms[idx];
}

__global__ void __launch_bounds__(kThreads)
decode_kernel(const uint32_t* __restrict__ words, long long n_words,
              const int* __restrict__ chunk_offsets, int n_chunks,
              const uint32_t* __restrict__ first_code, const int* __restrict__ count,
              const int* __restrict__ sym_offset, const int* __restrict__ sym_sorted, int n_sym,
              int max_len, int chunk_size, bool syms_shared, int* __restrict__ out) {
  __shared__ Tables t;
  extern __shared__ int s_syms[];
  for (int i = threadIdx.x; i <= max_len; i += kThreads) {
    t.fc[i] = first_code[i];
    t.ct[i] = count[i];
    t.so[i] = sym_offset[i];
  }
  if (syms_shared)
    for (int i = threadIdx.x; i < n_sym; i += kThreads) s_syms[i] = sym_sorted[i];
  __syncthreads();
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= n_chunks) return;
  const int* syms = syms_shared ? s_syms : sym_sorted;
  long long cursor = chunk_offsets[c];
  int* o = out + static_cast<long long>(c) * chunk_size;
  if ((chunk_size & 3) == 0) {
    for (int i = 0; i < chunk_size; i += 4) {
      int4 v;
      v.x = decode_one(words, n_words, cursor, t, syms, n_sym, max_len);
      v.y = decode_one(words, n_words, cursor, t, syms, n_sym, max_len);
      v.z = decode_one(words, n_words, cursor, t, syms, n_sym, max_len);
      v.w = decode_one(words, n_words, cursor, t, syms, n_sym, max_len);
      *reinterpret_cast<int4*>(o + i) = v;
    }
  } else {
    for (int i = 0; i < chunk_size; ++i)
      o[i] = decode_one(words, n_words, cursor, t, syms, n_sym, max_len);
  }
}

}  // namespace

// out[c, i] = the i-th symbol of chunk c.  The tables hold max_len + 1
// entries (max_len in [1, 32]); sym_sorted holds n_sym >= 1 entries; `out`
// must be 16-byte aligned.  Returns the CUDA error of the launch.
extern "C" int huffman_decode_chunks(const void* words, long long n_words,
                                     const void* chunk_offsets, int n_chunks,
                                     const void* first_code, const void* count,
                                     const void* sym_offset, const void* sym_sorted, int n_sym,
                                     int max_len, int chunk_size, void* out, void* stream) {
  if (max_len < 1 || max_len > kMaxLen || n_sym < 1 || chunk_size < 1 || n_chunks < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_chunks == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool syms_shared = n_sym <= kSharedSyms;
  const int smem = syms_shared ? static_cast<int>(sizeof(int)) * n_sym : 0;
  cudaError_t err =
      cudaFuncSetAttribute(decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = (n_chunks + kThreads - 1) / kThreads;
  decode_kernel<<<grid, kThreads, smem, s>>>(
      static_cast<const uint32_t*>(words), n_words, static_cast<const int*>(chunk_offsets),
      n_chunks, static_cast<const uint32_t*>(first_code), static_cast<const int*>(count),
      static_cast<const int*>(sym_offset), static_cast<const int*>(sym_sorted), n_sym, max_len,
      chunk_size, syms_shared, static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}
