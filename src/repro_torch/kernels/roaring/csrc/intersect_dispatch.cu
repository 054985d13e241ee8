// Kind-dispatch container intersection: two kernels, one per entry.
//
// Replaces the Pallas kernels `intersect_dispatch_pallas` and
// `intersect_dispatch_stacked_pallas` of src/repro/kernels/roaring/kernel.py,
// whose body `_intersect_dispatch_kernel` selects one row kernel of
// dispatch.AND_TABLE per pair with @pl.when.
//
// What bounds them on an H100: memory. They do integer and bit work only (no
// tensor-core math), a few operations per byte, so the floor is the bytes a
// pair needs — 2*card for an array side, 8 kB for a bitmap side, 4*n_runs
// for a run side, plus the 8 kB hits row when it is written — over 3.35 TB/s.
//
// intersect_dispatch_kernel (key-aligned pairs, hits row and card; the
// per-op AND combine): one 128-thread block per pair.
//   * a pair with an empty side writes zeros and exits before touching its
//     payload — the counterpart of the Pallas `skip_dead_rows` DMA skip;
//   * every thread owns 8 consecutive slots or 4 consecutive words at a
//     time and writes them as one 16-byte store; slots past the array
//     side's card are zero-filled the same way, without a search;
//   * the 8 searches of a thread's slots run in lockstep (a fixed
//     ceil(log2 n) halvings each), so their shared-memory loads overlap;
//   * an array side reads its `card` values, a bitmap probe one word per
//     probe, a run side stages its `n_runs` pairs and lifts each coverage
//     word by one binary search (run_cov_word).
//
// stacked_card_kernel (card only, N slabs against one query of C rows;
// search top-k scoring and the store's sum_): grid (C, S), G lanes a pair.
//   * block (c, s) stages query row c into shared memory once — a packed
//     array, a bitmap, or its runs lifted to a coverage bitmap — with the
//     bitmap's prefix popcounts, and its 256 / G lane groups walk the pairs
//     n * C + c of its share of the N slabs (n = s, s + S, ...: heavy slabs
//     spread over the blocks). S and G come from the shapes and the SM
//     count (the wrapper's `stacked_plan`): the 2049 x 135 search grid runs
//     S = 16, G = 8 (most pairs there hold a few dozen array values, so
//     several pairs a warp keep more loads in flight), the 24 x 916 store
//     grid S = 1, G = 32;
//   * a pair reads its 24-byte meta (loaded a pair ahead) and only the
//     a-side bytes its cell needs, and reduces its card with shuffles:
//     array values 8 a lane (a loop that ends at `card`) searched in or
//     probed against the staged query; a bitmap row in 16-byte loads
//     against the staged words (or probed by the query's values); a run
//     row's pairs counted against the query's prefix popcounts (2 lookups
//     a run) or its sorted values (2 searches a run);
//   * a dead pair costs one meta read and one card store.
//   The card of an intersection does not depend on which side is searched,
//   so a cell whose table kernel treats the query as runs reads the lifted
//   coverage instead.
//
// The (kind_a, kind_b) cell switch is generated from dispatch.AND_TABLE at
// build time (and_table.inc), so kernels and registry cannot drift apart.

#include "roaring_common.cuh"
#include "and_table.inc"   // AND_KERNEL[4][4], AND_SWAP[4][4], RK_* ids

using namespace roaring;

namespace {

constexpr int kChunks = kRowWords / 8;     // 16-byte chunks of a row
constexpr int kWarps = kThreads / 32;
constexpr int kHitsThreads = 128;          // block of the key-aligned kernel

// Copy the first n u16 of a global row into shared memory in 16-byte
// chunks (the last chunk may carry up to 7 words past n; rows are 8 kB).
__device__ __forceinline__ void stage_chunks(uint4* dst,
                                             const uint16_t* __restrict__ src,
                                             int n, int tid, int nthreads) {
  const uint4* s4 = reinterpret_cast<const uint4*>(src);
  for (int i = tid; i < (n + 7) / 8; i += nthreads) dst[i] = __ldg(s4 + i);
}

__device__ __forceinline__ void unpack8(const uint4 u, int v[8]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    v[2 * k] = int(w[k] & 0xFFFFu);
    v[2 * k + 1] = int(w[k] >> 16);
  }
}

// Bit k of m -> u16 slot k (0 / 1) of a 16-byte chunk.
__device__ __forceinline__ uint4 spread8(unsigned m) {
  const auto pair = [m](int k) {
    return ((m >> k) & 1u) | (((m >> (k + 1)) & 1u) << 16);
  };
  return make_uint4(pair(0), pair(2), pair(4), pair(6));
}

// Slots [base, base + 8) that lie below n, as a bit mask.
__device__ __forceinline__ unsigned below_mask(int n, int base) {
  const int k = n - base;
  return k >= 8 ? 0xFFu : (k <= 0 ? 0u : (1u << k) - 1u);
}

// Bit k: v[k] is among the sorted s[0..n). Each search takes the last
// index whose value is <= v in ceil(log2 n) halvings, the same number for
// all 8, so their loads overlap.
__device__ __forceinline__ unsigned member8(const uint16_t* s, int n,
                                            const int v[8]) {
  if (n <= 0) return 0;
  int at[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  for (int len = n; len > 1;) {
    const int half = len >> 1;
#pragma unroll
    for (int k = 0; k < 8; ++k)
      at[k] = int(s[at[k] + half]) <= v[k] ? at[k] + half : at[k];
    len -= half;
  }
  unsigned m = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) m |= unsigned(int(s[at[k]]) == v[k]) << k;
  return m;
}

// Bit k: v[k] lies in one of the sorted (start, length-1) runs[0..nr).
__device__ __forceinline__ unsigned in_runs8(const uint16_t* runs, int nr,
                                             const int v[8]) {
  if (nr <= 0) return 0;
  int at[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  for (int len = nr; len > 1;) {
    const int half = len >> 1;
#pragma unroll
    for (int k = 0; k < 8; ++k)
      at[k] = int(runs[2 * (at[k] + half)]) <= v[k] ? at[k] + half : at[k];
    len -= half;
  }
  unsigned m = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int s = runs[2 * at[k]];
    m |= unsigned(s <= v[k] && v[k] <= s + int(runs[2 * at[k] + 1])) << k;
  }
  return m;
}

// Bit k: bit v[k] of a bitmap row (u16 words).
__device__ __forceinline__ unsigned probe8(const uint16_t* bits,
                                           const int v[8]) {
  unsigned m = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k)
    m |= ((unsigned(bits[v[k] >> 4]) >> (v[k] & 15)) & 1u) << k;
  return m;
}

__device__ __forceinline__ int popc4(const uint4 u) {
  return __popc(u.x) + __popc(u.y) + __popc(u.z) + __popc(u.w);
}

__device__ __forceinline__ uint4 and4(const uint4 a, const uint4 b) {
  return make_uint4(a.x & b.x, a.y & b.y, a.z & b.z, a.w & b.w);
}

// Coverage words 4j .. 4j+3 of a staged run list.
__device__ __forceinline__ uint4 cov4(const uint16_t* runs, int nr, int j) {
  return make_uint4(
      run_cov_word(runs, nr, 4 * j), run_cov_word(runs, nr, 4 * j + 1),
      run_cov_word(runs, nr, 4 * j + 2), run_cov_word(runs, nr, 4 * j + 3));
}

}  // namespace

__global__ void __launch_bounds__(kHitsThreads)
intersect_dispatch_kernel(const uint16_t* __restrict__ a,
                          const uint16_t* __restrict__ b,
                          const int32_t* __restrict__ meta,
                          uint16_t* __restrict__ hits,
                          int32_t* __restrict__ card, long long b_rows) {
  __shared__ uint4 sx4[kChunks];   // x's staged run pairs
  __shared__ uint4 sy4[kChunks];   // y's staged packed array or run pairs
  const uint16_t* sx = reinterpret_cast<const uint16_t*>(sx4);
  const uint16_t* sy = reinterpret_cast<const uint16_t*>(sy4);
  const long long row = blockIdx.x;
  const int32_t* m = meta + 6 * row;
  const int ka = m[0], kb = m[1];
  int kid = RK_NONE, swap = 0;
  if (ka >= 0 && ka < 4 && kb >= 0 && kb < 4) {
    kid = AND_KERNEL[ka][kb];
    swap = AND_SWAP[ka][kb];
  }
  uint4* h4 = reinterpret_cast<uint4*>(hits + row * kRowWords);
  if (kid == RK_NONE) {                // either side empty: zeros, card 0
    for (int j = threadIdx.x; j < kChunks; j += kHitsThreads)
      h4[j] = make_uint4(0, 0, 0, 0);
    if (threadIdx.x == 0) card[row] = 0;
    return;
  }
  const uint16_t* pa = a + row * kRowWords;
  const uint16_t* pb = b + (row % b_rows) * kRowWords;
  const uint16_t* x = swap ? pb : pa;
  const uint16_t* y = swap ? pa : pb;
  const uint4* x4 = reinterpret_cast<const uint4*>(x);
  const uint4* y4 = reinterpret_cast<const uint4*>(y);
  const int cx = clamp_int(swap ? m[3] : m[2], 0, kRowWords);
  const int cy = clamp_int(swap ? m[2] : m[3], 0, kRowWords);
  const int rx = clamp_int(swap ? m[5] : m[4], 0, kMaxRuns);
  const int ry = clamp_int(swap ? m[4] : m[5], 0, kMaxRuns);
  int count = 0;

  if (kid == RK_GALLOP || kid == RK_PROBE || kid == RK_RUN_GALLOP) {
    // a 0/1 mask over x's packed slots: searched in y's staged array or
    // run list, or probed against y's bitmap words
    if (kid == RK_GALLOP)
      stage_chunks(sy4, y, cy, threadIdx.x, kHitsThreads);
    if (kid == RK_RUN_GALLOP)
      stage_chunks(sy4, y, 2 * ry, threadIdx.x, kHitsThreads);
    __syncthreads();
    for (int j = threadIdx.x; j < kChunks; j += kHitsThreads) {
      unsigned hit = 0;
      if (8 * j < cx) {
        int v[8];
        unpack8(__ldg(x4 + j), v);
        hit = kid == RK_GALLOP ? member8(sy, cy, v)
              : kid == RK_PROBE ? probe8(y, v)
                                : in_runs8(sy, ry, v);
        hit &= below_mask(cx, 8 * j);
      }
      count += __popc(hit);
      h4[j] = spread8(hit);
    }
  } else {
    // AND'd bitmap words: x's row or its runs' coverage, and y's
    if (kid != RK_WORD_AND)
      stage_chunks(sx4, x, 2 * rx, threadIdx.x, kHitsThreads);
    if (kid == RK_RUN_COV_AND)
      stage_chunks(sy4, y, 2 * ry, threadIdx.x, kHitsThreads);
    __syncthreads();
    for (int j = threadIdx.x; j < kChunks; j += kHitsThreads) {
      const uint4 u = kid == RK_WORD_AND ? __ldg(x4 + j) : cov4(sx, rx, j);
      const uint4 w = kid == RK_RUN_COV_AND ? cov4(sy, ry, j) : __ldg(y4 + j);
      const uint4 r = and4(u, w);
      count += popc4(r);
      h4[j] = r;
    }
  }

  const int total = block_sum<kHitsThreads>(count);
  if (threadIdx.x == 0) card[row] = total;
}

namespace {

// The staged query of one stacked column, and what reads it.
struct Query {
  const uint4* q4;     // packed array or bitmap words (runs lifted)
  const int* below;    // below[w]: set bits in words 0 .. w-1 (w <= 2048)
  int n;               // packed values (array query)
};

// Set bits of the staged bitmap at positions < v (0 <= v <= 65536).
__device__ __forceinline__ int bits_below(const Query& q, int v) {
  const int w = v >> 5, b = v & 31;
  const uint32_t* q32 = reinterpret_cast<const uint32_t*>(q.q4);
  return q.below[w] + (b ? __popc(q32[w] & ((1u << b) - 1u)) : 0);
}

// Values of the staged sorted array that are <= v (v may be -1).
__device__ __forceinline__ int rank_le(const Query& q, int v) {
  const uint16_t* s = reinterpret_cast<const uint16_t*>(q.q4);
  if (q.n <= 0) return 0;
  int at = 0;
  for (int len = q.n; len > 1;) {
    const int half = len >> 1;
    at = int(s[at + half]) <= v ? at + half : at;
    len -= half;
  }
  return int(s[at]) <= v ? at + 1 : 0;
}

// The row kernels of one pair, read by the G lanes that share it (lane gl
// of G): each returns that lane's share of the card.

// A's first n packed values (global), 8 a lane: in the query's sorted
// array (member) or its bitmap (probe).
template <int G, bool kMember>
__device__ __forceinline__ int a_values(const uint16_t* __restrict__ pa,
                                        int n, const Query& q, int gl) {
  const uint4* a4 = reinterpret_cast<const uint4*>(pa);
  const uint16_t* s = reinterpret_cast<const uint16_t*>(q.q4);
  int count = 0;
  for (int j = gl; 8 * j < n; j += G) {
    int v[8];
    unpack8(__ldg(a4 + j), v);
    const unsigned m = kMember ? member8(s, q.n, v) : probe8(s, v);
    count += __popc(m & below_mask(n, 8 * j));
  }
  return count;
}

// The query's packed values probed against A's bitmap row (global).
template <int G>
__device__ __forceinline__ int q_values_in_a_bits(
    const uint16_t* __restrict__ pa, const Query& q, int gl) {
  int count = 0;
  for (int j = gl; 8 * j < q.n; j += G) {
    int v[8];
    unpack8(q.q4[j], v);
    unsigned m = 0;
#pragma unroll
    for (int k = 0; k < 8; ++k)
      m |= ((unsigned(__ldg(pa + (v[k] >> 4))) >> (v[k] & 15)) & 1u) << k;
    count += __popc(m & below_mask(q.n, 8 * j));
  }
  return count;
}

// A's bitmap row (global) AND the staged query words, 16 bytes a load.
template <int G>
__device__ __forceinline__ int a_words(const uint16_t* __restrict__ pa,
                                       const Query& q, int gl) {
  const uint4* a4 = reinterpret_cast<const uint4*>(pa);
  int count = 0;
#pragma unroll 4
  for (int j = gl; j < kChunks; j += G)
    count += popc4(and4(__ldg(a4 + j), q.q4[j]));
  return count;
}

// A's run pairs (global, one u32 each): per run [s, e], the query's set
// bits in it (prefix popcounts) or its values in it (two searches).
template <int G, bool kBits>
__device__ __forceinline__ int a_runs(const uint16_t* __restrict__ pa,
                                      int nr, const Query& q, int gl) {
  const uint32_t* r32 = reinterpret_cast<const uint32_t*>(pa);
  int count = 0;
  for (int i = gl; i < nr; i += G) {
    const uint32_t r = __ldg(r32 + i);
    const int s = int(r & 0xFFFFu), e = s + int(r >> 16);
    if (e >= 65536) continue;            // padding pair: no values
    count += kBits ? bits_below(q, e + 1) - bits_below(q, s)
                   : rank_le(q, e) - rank_le(q, s - 1);
  }
  return count;
}

}  // namespace

// G lanes a pair (32 / G pairs a warp at once).
template <int G>
__global__ void __launch_bounds__(kThreads)
stacked_card_kernel(const uint16_t* __restrict__ a,
                    const uint16_t* __restrict__ query,
                    const int32_t* __restrict__ meta,
                    int32_t* __restrict__ card, long long N) {
  constexpr int kGroups = kThreads / G;        // pairs a block works at once
  __shared__ uint4 sq4[kChunks];               // the query row, as staged
  __shared__ __align__(16) int below[kRowU32 + 1];  // run pairs, then prefix
  __shared__ int warp_sum[kWarps];
  const int c = blockIdx.x, C = gridDim.x;
  const int split = blockIdx.y, S = gridDim.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // every pair of column c carries the query's meta; pair c's is read
  const int kq = meta[6LL * c + 1];
  const int cq = clamp_int(meta[6LL * c + 3], 0, kRowWords);
  const int rq = clamp_int(meta[6LL * c + 5], 0, kMaxRuns);
  const uint16_t* q = query + (long long)c * kRowWords;
  uint32_t* q32 = reinterpret_cast<uint32_t*>(sq4);

  if (kq == KIND_ARRAY) {
    stage_chunks(sq4, q, cq, tid, kThreads);
  } else if (kq == KIND_BITMAP) {
    stage_chunks(sq4, q, kRowWords, tid, kThreads);
  } else if (kq == KIND_RUN) {
    stage_chunks(reinterpret_cast<uint4*>(below), q, 2 * rq, tid, kThreads);
    __syncthreads();
    const uint16_t* runs = reinterpret_cast<const uint16_t*>(below);
    for (int w = tid; w < kRowU32; w += kThreads)
      q32[w] = run_cov_word(runs, rq, w);
  }
  __syncthreads();                     // staged (and every lift has read
                                       // the runs the prefix overwrites)
  if (kq == KIND_BITMAP || kq == KIND_RUN) {
    // exclusive prefix popcounts of the 2048 words: 8 a thread, then a
    // scan over the block's threads
    constexpr int kPer = kRowU32 / kThreads;
    int pc[kPer], sum = 0;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      pc[k] = __popc(q32[tid * kPer + k]);
      sum += pc[k];
    }
    int incl = sum;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int t = __shfl_up_sync(0xFFFFFFFFu, incl, o);
      if (lane >= o) incl += t;
    }
    if (lane == 31) warp_sum[warp] = incl;
    __syncthreads();
    int before = incl - sum;
    for (int w = 0; w < warp; ++w) before += warp_sum[w];
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      below[tid * kPer + k] = before;
      before += pc[k];
    }
    if (tid == kThreads - 1) below[kRowU32] = before;
    __syncthreads();
  }
  const Query qs{sq4, below, kq == KIND_ARRAY ? cq : 0};

  // group g of the block takes the pairs n = split + S * (g + kGroups * i);
  // every lane of a warp runs the same trip count (its shuffles need all
  // 32), a group past N idles. A pair's (kind_a, card_a, nruns_a) are
  // loaded one pair ahead, so that their load overlaps the pair before.
  const int g = tid / G, gl = tid % G;
  const long long step = (long long)S * kGroups;
  const long long first = split + (long long)S * (warp * (32 / G));
  int next[3] = {0, 0, 0};
  long long n = split + (long long)S * g;
  if (n < N) {
    const int32_t* m = meta + 6 * (n * C + c);
    next[0] = m[0], next[1] = m[2], next[2] = m[4];
  }
  for (long long base = first; base < N; base += step, n += step) {
    const long long r = n * C + c;
    const int ka = n < N ? next[0] : KIND_EMPTY;
    const int ca = clamp_int(next[1], 0, kRowWords);
    const int ra = clamp_int(next[2], 0, kMaxRuns);
    if (n + step < N) {
      const int32_t* m = meta + 6 * ((n + step) * C + c);
      next[0] = m[0], next[1] = m[2], next[2] = m[4];
    }
    int kid = RK_NONE, swap = 0;
    if (ka >= 0 && ka < 4 && kq >= 0 && kq < 4) {
      kid = AND_KERNEL[ka][kq];
      swap = AND_SWAP[ka][kq];
    }
    int count = 0;
    if (kid != RK_NONE) {
      const uint16_t* pa = a + r * kRowWords;
      if (kid == RK_GALLOP) {                   // array x array
        count = a_values<G, true>(pa, ca, qs, gl);
      } else if (kid == RK_PROBE) {             // array x bitmap
        count = swap ? q_values_in_a_bits<G>(pa, qs, gl)
                     : a_values<G, false>(pa, ca, qs, gl);
      } else if (kid == RK_WORD_AND) {          // bitmap x bitmap
        count = a_words<G>(pa, qs, gl);
      } else if (kid == RK_RUN_GALLOP) {        // array x run
        count = swap ? a_runs<G, false>(pa, ra, qs, gl)  // query's values
                     : a_values<G, false>(pa, ca, qs, gl);  // lifted runs
      } else if (kid == RK_RUN_MASK) {          // run x bitmap
        count = swap ? a_words<G>(pa, qs, gl)   // the query's lifted runs
                     : a_runs<G, true>(pa, ra, qs, gl);
      } else {                                  // run x run (lifted query)
        count = a_runs<G, true>(pa, ra, qs, gl);
      }
    }
#pragma unroll
    for (int o = G / 2; o > 0; o >>= 1)
      count += __shfl_xor_sync(0xFFFFFFFFu, count, o);
    if (gl == 0 && n < N) card[r] = count;
  }
}

// n_rows pairs; pair r reads a row r, b row (r % b_rows), meta[6r .. 6r+5],
// and writes its hits row and card. Returns the cudaError_t of the launch.
extern "C" int roaring_intersect_dispatch(const void* a, const void* b,
                                          const void* meta, void* hits,
                                          void* card, long long n_rows,
                                          long long b_rows, void* stream) {
  if (n_rows > 0) {
    intersect_dispatch_kernel<<<(unsigned)n_rows, kHitsThreads, 0,
                                (cudaStream_t)stream>>>(
        static_cast<const uint16_t*>(a), static_cast<const uint16_t*>(b),
        static_cast<const int32_t*>(meta), static_cast<uint16_t*>(hits),
        static_cast<int32_t*>(card), b_rows);
  }
  return (int)cudaGetLastError();
}

// N x C pairs against one query of C rows: pair n * C + c reads a row
// n * C + c, query row c and meta[6(n * C + c) ..]; every pair of column c
// carries the same query fields (kind_b, card_b, nruns_b). `split` blocks
// share a column. Writes the card only.
extern "C" int roaring_stacked_card(const void* a, const void* query,
                                    const void* meta, void* card, long long N,
                                    long long C, int split, int lanes,
                                    void* stream) {
  if (N > 0 && C > 0) {
    const dim3 grid((unsigned)C, (unsigned)split);
    const auto args = [&](auto kernel) {
      kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
          static_cast<const uint16_t*>(a),
          static_cast<const uint16_t*>(query),
          static_cast<const int32_t*>(meta), static_cast<int32_t*>(card), N);
    };
    if (lanes == 8) args(stacked_card_kernel<8>);
    else if (lanes == 32) args(stacked_card_kernel<32>);
    else return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" const char* roaring_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
