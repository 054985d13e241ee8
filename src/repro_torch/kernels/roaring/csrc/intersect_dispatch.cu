// Kind-dispatch container intersection: one thread block per key-aligned
// container pair.
//
// Replaces the Pallas kernel `intersect_dispatch_pallas` (and its stacked
// entry `intersect_dispatch_stacked_pallas`) of
// src/repro/kernels/roaring/kernel.py, whose body `_intersect_dispatch_kernel`
// selects one row kernel of dispatch.AND_TABLE per pair with @pl.when.
//
// What bounds it on an H100: memory. It does integer and bit work only (no
// tensor-core math), a few operations per byte, so the floor is the bytes a
// pair needs — 2*card for an array side, 8 kB for a bitmap side, 4*n_runs
// for a run side, plus the 8 kB hits row when it is written — over 3.35 TB/s.
//
// What the design does about it:
//   * a pair with an empty side writes zeros (or nothing but its card, when
//     the caller omits the hits) and exits before touching its payload —
//     the counterpart of the Pallas `skip_dead_rows` DMA skip;
//   * sparse cells read only what they need: an array side reads its `card`
//     packed values, a bitmap probe reads one word per probe, a run side
//     stages its `n_runs` pairs; only bitmap x bitmap streams whole rows
//     (as 16-byte vector loads);
//   * the run lift is not the Pallas 16-pass bit search: each u32 coverage
//     word binary-searches the staged run list once (run_cov_word);
//   * `b_rows` lets the stacked scoring path pass the query's C rows once
//     (pair r reads query row r % b_rows) instead of an N-times broadcast,
//     and `hits == nullptr` skips the 8 kB hits write for card-only callers.
//
// The (kind_a, kind_b) cell switch is generated from dispatch.AND_TABLE at
// build time (and_table.inc), so kernel and registry cannot drift apart.

#include "roaring_common.cuh"
#include "and_table.inc"   // AND_KERNEL[4][4], AND_SWAP[4][4], RK_* ids

using namespace roaring;

__global__ void __launch_bounds__(kThreads)
intersect_dispatch_kernel(const uint16_t* __restrict__ a,
                          const uint16_t* __restrict__ b,
                          const int32_t* __restrict__ meta,
                          uint16_t* __restrict__ hits,
                          int32_t* __restrict__ card, long long b_rows) {
  __shared__ uint16_t sx[kRowWords];   // staged packed array / run pairs
  __shared__ uint16_t sy[kRowWords];   // second run list (run x run)
  const long long row = blockIdx.x;
  const int32_t* m = meta + 6 * row;
  const int ka = m[0], kb = m[1];
  int kid = RK_NONE, swap = 0;
  if (ka >= 0 && ka < 4 && kb >= 0 && kb < 4) {
    kid = AND_KERNEL[ka][kb];
    swap = AND_SWAP[ka][kb];
  }
  uint16_t* hrow = hits ? hits + row * kRowWords : nullptr;
  if (kid == RK_NONE) {                // either side empty: zeros, card 0
    if (hrow) {
      uint4* h4 = reinterpret_cast<uint4*>(hrow);
      for (int i = threadIdx.x; i < kRowWords / 8; i += kThreads)
        h4[i] = make_uint4(0, 0, 0, 0);
    }
    if (threadIdx.x == 0) card[row] = 0;
    return;
  }
  const uint16_t* pa = a + row * kRowWords;
  const uint16_t* pb = b + (row % b_rows) * kRowWords;
  const uint16_t* x = swap ? pb : pa;
  const uint16_t* y = swap ? pa : pb;
  const int cx = clamp_int(swap ? m[3] : m[2], 0, kRowWords);
  const int cy = clamp_int(swap ? m[2] : m[3], 0, kRowWords);
  const int rx = clamp_int(swap ? m[5] : m[4], 0, kMaxRuns);
  const int ry = clamp_int(swap ? m[4] : m[5], 0, kMaxRuns);
  int count = 0;

  if (kid == RK_GALLOP) {
    // each slot of x lower-bounds y's packed sorted prefix (staged)
    stage_u16(sx, y, cy);
    __syncthreads();
    for (int s = threadIdx.x; s < kRowWords; s += kThreads) {
      int hit = 0;
      if (s < cx) {
        const uint16_t v = x[s];
        int lo = 0, hi = cy;
        while (lo < hi) {
          const int mid = (lo + hi) >> 1;
          if (sx[mid] < v) lo = mid + 1; else hi = mid;
        }
        hit = (lo < cy && sx[lo] == v) ? 1 : 0;
      }
      count += hit;
      if (hrow) hrow[s] = uint16_t(hit);
    }
  } else if (kid == RK_PROBE) {
    // x's packed values probe y's bitmap words directly
    for (int s = threadIdx.x; s < kRowWords; s += kThreads) {
      int hit = 0;
      if (s < cx) {
        const int v = x[s];
        hit = (__ldg(y + (v >> 4)) >> (v & 15)) & 1;
      }
      count += hit;
      if (hrow) hrow[s] = uint16_t(hit);
    }
  } else if (kid == RK_WORD_AND) {
    // word AND with the popcount in the same pass, 16-byte vector loads
    const uint4* x4 = reinterpret_cast<const uint4*>(x);
    const uint4* y4 = reinterpret_cast<const uint4*>(y);
    uint4* h4 = reinterpret_cast<uint4*>(hrow);
    for (int i = threadIdx.x; i < kRowWords / 8; i += kThreads) {
      const uint4 u = __ldg(x4 + i), v = __ldg(y4 + i);
      const uint4 r = make_uint4(u.x & v.x, u.y & v.y, u.z & v.z, u.w & v.w);
      count += __popc(r.x) + __popc(r.y) + __popc(r.z) + __popc(r.w);
      if (hrow) h4[i] = r;
    }
  } else if (kid == RK_RUN_GALLOP) {
    // x's packed values binary-search y's staged run list
    stage_u16(sx, y, 2 * ry);
    __syncthreads();
    for (int s = threadIdx.x; s < kRowWords; s += kThreads) {
      int hit = 0;
      if (s < cx) {
        const int v = x[s];
        int lo = 0, hi = ry;             // # run starts <= v
        while (lo < hi) {
          const int mid = (lo + hi) >> 1;
          if (int(sx[2 * mid]) <= v) lo = mid + 1; else hi = mid;
        }
        const int i = lo - 1;
        hit = (i >= 0 && v <= int(sx[2 * i]) + int(sx[2 * i + 1])) ? 1 : 0;
      }
      count += hit;
      if (hrow) hrow[s] = uint16_t(hit);
    }
  } else if (kid == RK_RUN_MASK) {
    // x's runs lifted to coverage words, AND y's bitmap words
    stage_u16(sx, x, 2 * rx);
    __syncthreads();
    const uint32_t* y32 = reinterpret_cast<const uint32_t*>(y);
    uint32_t* h32 = reinterpret_cast<uint32_t*>(hrow);
    for (int w = threadIdx.x; w < kRowU32; w += kThreads) {
      const uint32_t r = run_cov_word(sx, rx, w) & __ldg(y32 + w);
      count += __popc(r);
      if (hrow) h32[w] = r;
    }
  } else {  // RK_RUN_COV_AND
    stage_u16(sx, x, 2 * rx);
    stage_u16(sy, y, 2 * ry);
    __syncthreads();
    uint32_t* h32 = reinterpret_cast<uint32_t*>(hrow);
    for (int w = threadIdx.x; w < kRowU32; w += kThreads) {
      const uint32_t r = run_cov_word(sx, rx, w) & run_cov_word(sy, ry, w);
      count += __popc(r);
      if (hrow) h32[w] = r;
    }
  }

  const int total = block_sum(count);
  if (threadIdx.x == 0) card[row] = total;
}

// n_rows pairs; pair r reads a row r, b row (r % b_rows), meta[6r .. 6r+5].
// `hits` may be null (card-only). Returns the cudaError_t of the launch.
extern "C" int roaring_intersect_dispatch(const void* a, const void* b,
                                          const void* meta, void* hits,
                                          void* card, long long n_rows,
                                          long long b_rows, void* stream) {
  if (n_rows > 0) {
    intersect_dispatch_kernel<<<(unsigned)n_rows, kThreads, 0,
                                (cudaStream_t)stream>>>(
        static_cast<const uint16_t*>(a), static_cast<const uint16_t*>(b),
        static_cast<const int32_t*>(meta), static_cast<uint16_t*>(hits),
        static_cast<int32_t*>(card), b_rows);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* roaring_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
