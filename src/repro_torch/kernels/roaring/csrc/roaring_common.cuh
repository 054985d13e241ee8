// Shared device helpers for the Roaring container kernels.
//
// A container row is 4096 u16 words (8 kB): a packed sorted array (first
// `card` slots, 0xFFFF padded), a 2^16-bit bitmap, or a packed list of
// (start, length-1) run pairs padded with (0xFFFF, 0xFFFF). In bitmap form
// the row read as 2048 little-endian u32 words holds bit v of the chunk at
// word v >> 5, bit v & 31 — the same bytes as the u16-word layout.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace roaring {

constexpr int kRowWords = 4096;   // u16 words per row
constexpr int kRowU32 = 2048;     // the same row as u32 words
constexpr int kMaxRuns = 2048;    // (start, length-1) pairs per row
constexpr int kThreads = 256;     // default block size of the kernels here

constexpr int KIND_EMPTY = 0;
constexpr int KIND_ARRAY = 1;
constexpr int KIND_BITMAP = 2;
constexpr int KIND_RUN = 3;

__device__ __forceinline__ int clamp_int(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// Bits [lo, hi] (0 <= lo <= hi <= 31) of a u32 word.
__device__ __forceinline__ uint32_t bit_range(int lo, int hi) {
  const uint32_t upto = hi == 31 ? 0xFFFFFFFFu : ((1u << (hi + 1)) - 1u);
  return upto & ~((1u << lo) - 1u);
}

// Coverage of u32 word w (bits 32w .. 32w+31) by a sorted, disjoint run
// list `runs` of `nr` (start, length-1) pairs: one binary search for the
// first run ending at or after 32w, then the few runs that reach into the
// word. Gather-only, so every word of a row is computed independently.
__device__ __forceinline__ uint32_t run_cov_word(const uint16_t* runs, int nr,
                                                 int w) {
  const int w_lo = 32 * w, w_hi = 32 * w + 31;
  int lo = 0, hi = nr;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    const int e = int(runs[2 * mid]) + int(runs[2 * mid + 1]);
    if (e < w_lo) lo = mid + 1; else hi = mid;
  }
  uint32_t cov = 0;
  for (int i = lo; i < nr; ++i) {
    const int s = runs[2 * i];
    const int e = s + int(runs[2 * i + 1]);
    if (e >= 65536 || s > w_hi) break;   // padding pair, or past the word
    cov |= bit_range(max(s, w_lo) - w_lo, min(e, w_hi) - w_lo);
  }
  return cov;
}

// Sum of `v` over a block of kBlock threads; the result is valid in
// thread 0.
template <int kBlock = kThreads>
__device__ __forceinline__ int block_sum(int v) {
  __shared__ int partial[kBlock / 32];
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xFFFFFFFFu, v, o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) partial[warp] = v;
  __syncthreads();
  v = 0;
  if (threadIdx.x < 32) {
    v = threadIdx.x < kBlock / 32 ? partial[threadIdx.x] : 0;
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xFFFFFFFFu, v, o);
  }
  return v;
}

}  // namespace roaring
