// Paged decode attention: one new token per sequence against paged KV pools
// whose per-sequence page lists come from the Roaring page table.
//
// Replaces the Pallas kernel `paged_decode_attention` (body `_decode_kernel`)
// of src/repro/kernels/sparse_attn/kernel.py. It computes the same function:
// for each (sequence b, KV head h), walk pages j < counts[b] of page_idx[b]
// (the page ids are read inside the kernel), score q.k * scale in f32, apply
// softcap * tanh(s / softcap) when softcap > 0, keep positions with
// starts[b] <= pos < lengths[b], and take the softmax-weighted sum of V with
// m / l / acc in f32; the output is acc / max(l, 1e-30) in q's dtype. Pages
// at j >= counts[b] are never read, and a page id outside [0, P) is skipped.
// A row with no live position (counts = 0, or starts >= lengths) gives
// zeros. (The Pallas kernel averages V over the visited pages when counts > 0
// but no position is live; no caller makes such a row.)
//
// What bounds it on an H100: memory. Each live position's K and V rows are
// read once (2 * KVH * D elements); the arithmetic is ~4 * G flops per
// element read, far below the card's ~295 operations per byte. The floor is
// the live K/V bytes (plus q and out) over 3.35 TB/s.
//
// Design: split-KV flash decoding, two launches.
//   * `split_kernel`: grid (split, KV head x query-head chunk, sequence).
//     A block serves a chunk of at most gc_len <= 8 query heads of its KV
//     head (the host picks gc_len); G up to 16 (starcoder2-15b's 12) splits
//     into ceil(G / gc_len) equal chunks, each a block that reads the KV
//     head's K / V itself (the chunks of a head are neighbours in the grid,
//     so the later reads mostly hit L2). Split s owns positions
//     [s * split_len, (s + 1) * split_len) and walks only their part inside
//     [max(starts, 0), min(lengths, counts * page_size)); a split with no
//     live position writes an empty partial (l = 0) and exits. The wrapper
//     picks split_len from page_idx.shape[1] * page_size alone (no sync on
//     lengths), so the grid has >= 8 blocks per SM at the serving path's
//     batch of 4 and at decode_32k.
//   * Inside a split there is no block barrier until the end. Each of the
//     4 warps walks its own tiles of 8 positions (4 when G = 8) and runs its
//     own online softmax over them for all the block's query heads. A
//     lane owns 8 columns of every row (a 16-byte bf16 vector, two of f32),
//     keeps q and acc[G][its columns] in f32 registers and forms partial
//     q.k sums for the tile's G x 8 scores; a reduce-scatter over the warp
//     leaves each lane one whole score, so the scalar work (scale, softcap,
//     exp, the page lookup) is done once per score, not once per lane.
//   * K / V arrive by 16-byte cp.async into a ring of 3 tiles per warp, two
//     in flight. Each lane copies exactly the vectors it later reads, so the
//     ring needs only cp.async.wait_group, not even a warp barrier. A
//     position that is not live (past the split's end, or on a bad page id)
//     is neither copied nor read nor multiplied, so a NaN page cannot reach
//     an output through 0 * NaN.
//   * At the end the warps merge through shared memory, and the block writes
//     one f32 partial (m, l, acc[G][D]).
//   * `combine_kernel`: four threads per output element merge its splits'
//     partials (each every fourth split, then by shuffles), skipping those
//     with l = 0, and write acc / max(l, 1e-30) in q's dtype. The wrapper allocates the partials; the kernels allocate
//     nothing.
// Replaces (NVIDIA H100 80GB HBM3, 700 W): the first version, one 256-thread
// block per (sequence, KV head) walking 32-position tiles in lock-step,
// 0.7215-0.7276 ms at the serving path's largest launch and 5.5685-5.6209 ms
// at decode_32k (PERF.md's kernel table).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kStages = 3;                // tiles in each warp's ring
constexpr int kMaxG = 8;                  // query heads of one block
constexpr int kMaxGroup = 16;             // query heads per KV head
constexpr int kMaxD = 256;                // head dim
constexpr float kNegInf = -1e30f;

// positions of one warp tile: kG times as many scores, at most one a lane
template <int kG>
__host__ __device__ constexpr int tile_positions() {
  return kG <= 4 ? 8 : 32 / kG;
}

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void narrow(float v, float* o) { *o = v; }
__device__ __forceinline__ void narrow(float v, __nv_bfloat16* o) {
  *o = __float2bfloat16(v);
}

// a 16-byte vector of T widened to f32
template <typename T>
__device__ __forceinline__ void load16(const void* p, float* out) {
  constexpr int kN = 16 / sizeof(T);
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int i = 0; i < kN; ++i) out[i] = widen(e[i]);
}

// 16-byte global -> shared copy that does not block the thread
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// One step of a butterfly reduce-scatter over the warp: lanes kO apart
// swap halves of their first 2 kO values and add, so a lane keeps the half
// its bit kO selects; the steps kO = n / 2, ..., 1 leave lane i the sum over
// those lanes of value i % n in part[0]. Unrolled at compile time, so the
// values stay in registers.
template <int kO, int kN>
__device__ __forceinline__ void reduce_scatter(float (&part)[kN], int lane) {
  if constexpr (kO >= 1) {
    const bool up = lane & kO;
#pragma unroll
    for (int k = 0; k < kO; ++k) {
      const float send = up ? part[k] : part[k + kO];
      const float keep = up ? part[k + kO] : part[k];
      part[k] = keep + __shfl_xor_sync(~0u, send, kO);
    }
    reduce_scatter<kO / 2>(part, lane);
  }
}

// the rings of the block's warps; the final merge reuses them, and needs
// at most kWarps * (kMaxG * kMaxD + 2 * kMaxG) floats, less than any ring
template <int kG, int kVPL>
constexpr int split_smem_bytes() {
  return kWarps * kStages * tile_positions<kG>() * 2 * kVPL * 32 * 16;
}
static_assert(split_smem_bytes<8, 1>() >=
                  (int)sizeof(float) * kWarps * (kMaxG * kMaxD + 2 * kMaxG),
              "the merge must fit in the rings");

// kG: a chunk's query heads rounded up to 1 / 2 / 4 / 8 (gc_len <= kG);
// kVPL: 16-byte vectors of a row per lane (1, or 2 for f32 rows past 128)
template <typename T, int kG, int kVPL>
__global__ void __launch_bounds__(kThreads, 2)
split_kernel(const T* __restrict__ q, const T* __restrict__ kp,
             const T* __restrict__ vp, const int32_t* __restrict__ page_idx,
             const int32_t* __restrict__ counts,
             const int32_t* __restrict__ lengths,
             const int32_t* __restrict__ starts, float* __restrict__ ws_ml,
             float* __restrict__ ws_acc, int KVH, int G, int D, int P,
             int page_size, int max_pages, int split_len, int n_splits,
             int n_gc, int gc_len, float scale, float softcap) {
  constexpr int kN = 16 / sizeof(T);      // elements per vector
  constexpr int kE = kVPL * kN;           // columns per lane
  constexpr int kT = tile_positions<kG>();
  constexpr int kNV = kT * kG;            // scores per tile
  extern __shared__ __align__(16) unsigned char smem[];
  const int s = blockIdx.x, h = blockIdx.y / n_gc, b = blockIdx.z;
  // this block's query heads: g0 .. g0 + Gc - 1 of the KV head's G
  const int g0 = (blockIdx.y % n_gc) * gc_len;
  const int Gc = min(G - g0, gc_len);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t bh = (size_t)b * KVH + h;
  const size_t part = bh * n_splits + s;

  const int cnt = min(max(counts[b], 0), max_pages);
  const int lo = max(max(starts[b], 0), s * split_len);
  const int hi = min(min(lengths[b], cnt * page_size), (s + 1) * split_len);
  if (hi <= lo) {                          // nothing live: an empty partial
    if (tid < Gc) {
      ws_ml[(part * G + g0 + tid) * 2] = kNegInf;
      ws_ml[(part * G + g0 + tid) * 2 + 1] = 0.f;
    }
    return;
  }

  const int vpr = D / kN;                  // vectors per row
  const int n_it = (hi - lo + kWarps * kT - 1) / (kWarps * kT);
  const int32_t* pages = page_idx + (size_t)b * max_pages;

  // this lane's columns of q: vectors lane, lane + 32
  float qr[kG][kE];
  const T* qb = q + (bh * G + g0) * D;
#pragma unroll
  for (int g = 0; g < kG; ++g)
#pragma unroll
    for (int j = 0; j < kVPL; ++j) {
      const int v = lane + j * 32;
      if (g < Gc && v < vpr) {
        load16<T>(qb + g * D + v * kN, qr[g] + j * kN);
      } else {
#pragma unroll
        for (int e = 0; e < kN; ++e) qr[g][j * kN + e] = 0.f;
      }
    }

  // this warp's ring: [stage][position][K, V][vector][lane] 16-byte slots;
  // a lane reads only the slots it copied itself
  uint4* ring = reinterpret_cast<uint4*>(smem) +
                (size_t)warp * kStages * kT * 2 * kVPL * 32;
  auto slot = [&](int st, int t, int kv, int j) {
    return ring + (((st * kT + t) * 2 + kv) * kVPL + j) * 32 + lane;
  };
  // the element offset of position pos's K / V row, or -1 if not live
  auto row_of = [&](int pos) -> long long {
    if (pos >= hi) return -1;
    const int page = pages[pos / page_size];
    if (page < 0 || page >= P) return -1;
    return (((long long)page * page_size + pos % page_size) * KVH + h) * D;
  };
  // the live positions of each staged tile, kT bits per ring slot
  unsigned live_fifo = 0;
  auto stage = [&](int it, int st) {
    const int pos0 = lo + (it * kWarps + warp) * kT;
    const long long mine = lane < kT ? row_of(pos0 + lane) : -1;
    const unsigned live = __ballot_sync(~0u, mine >= 0);
    live_fifo = (live_fifo & ~(0xffu << (8 * st))) | (live << (8 * st));
#pragma unroll
    for (int t = 0; t < kT; ++t) {
      const long long r = __shfl_sync(~0u, mine, t);
      if (r < 0) continue;
#pragma unroll
      for (int j = 0; j < kVPL; ++j) {
        const int v = lane + j * 32;
        if (v < vpr) {
          cp_async16(slot(st, t, 0, j), kp + r + v * kN);
          cp_async16(slot(st, t, 1, j), vp + r + v * kN);
        }
      }
    }
  };

  // lane i owns score (g, t) = (i % kNV) / kT, i % kT of each tile, and
  // keeps the running max / sum of its g; acc holds its columns of all g
  const int my_t = (lane & (kNV - 1)) % kT;
  const int my_g = (lane & (kNV - 1)) / kT;
  float m_run = kNegInf, l_run = 0.f;
  float acc[kG][kE];
#pragma unroll
  for (int g = 0; g < kG; ++g)
#pragma unroll
    for (int e = 0; e < kE; ++e) acc[g][e] = 0.f;

#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < n_it) stage(st, st);
    cp_async_commit();
  }
  for (int it = 0; it < n_it; ++it) {
    // refill the slot this warp finished with in the previous iteration
    if (it + kStages - 1 < n_it)
      stage(it + kStages - 1, (it + kStages - 1) % kStages);
    cp_async_commit();
    cp_async_wait<kStages - 1>();        // this lane's copies of `it` landed
    const int st = it % kStages;
    const unsigned live = (live_fifo >> (8 * st)) & 0xffu;
    if (!live) continue;                 // warp-uniform

    // partial q.k over this lane's columns, per (g, t); a position that is
    // not live is never read
    float part[kNV];
#pragma unroll
    for (int t = 0; t < kT; ++t) {
      if (live >> t & 1) {
        float kf[kE];
#pragma unroll
        for (int j = 0; j < kVPL; ++j) {
          if (lane + j * 32 < vpr) {
            load16<T>(slot(st, t, 0, j), kf + j * kN);
          } else {
#pragma unroll
            for (int e = 0; e < kN; ++e) kf[j * kN + e] = 0.f;
          }
        }
#pragma unroll
        for (int g = 0; g < kG; ++g) {
          float d = 0.f;
#pragma unroll
          for (int e = 0; e < kE; ++e) d += qr[g][e] * kf[e];
          part[g * kT + t] = d;
        }
      } else {
#pragma unroll
        for (int g = 0; g < kG; ++g) part[g * kT + t] = 0.f;
      }
    }
    // reduce-scatter: after it, lane i holds the full sum of score
    // i % kNV (each step halves the scores a lane keeps)
    reduce_scatter<kNV / 2>(part, lane);
    float x = part[0];
#pragma unroll
    for (int o = kNV; o < 32; o <<= 1) x += __shfl_xor_sync(~0u, x, o);

    // online softmax over the tile: the kT lanes of one g together
    const bool ok = (live >> my_t & 1) && my_g < Gc;
    x *= scale;
    if (softcap > 0.f) x = softcap * tanhf(x / softcap);
    x = ok ? x : kNegInf;
    float t_max = x;
#pragma unroll
    for (int o = kT / 2; o >= 1; o >>= 1)
      t_max = fmaxf(t_max, __shfl_xor_sync(~0u, t_max, o));
    const float m_new = fmaxf(m_run, t_max);
    const float p = ok ? expf(x - m_new) : 0.f;
    float p_sum = p;
#pragma unroll
    for (int o = kT / 2; o >= 1; o >>= 1)
      p_sum += __shfl_xor_sync(~0u, p_sum, o);
    const float alpha = expf(m_run - m_new);
    l_run = l_run * alpha + p_sum;
    m_run = m_new;

    // acc = acc * alpha + P @ V over this lane's columns
#pragma unroll
    for (int g = 0; g < kG; ++g) {
      const float a = __shfl_sync(~0u, alpha, g * kT);
#pragma unroll
      for (int e = 0; e < kE; ++e) acc[g][e] *= a;
    }
#pragma unroll
    for (int t = 0; t < kT; ++t) {
      if (!(live >> t & 1)) continue;    // never multiplied
      float vf[kE];
#pragma unroll
      for (int j = 0; j < kVPL; ++j) {
        if (lane + j * 32 < vpr) {
          load16<T>(slot(st, t, 1, j), vf + j * kN);
        } else {
#pragma unroll
          for (int e = 0; e < kN; ++e) vf[j * kN + e] = 0.f;
        }
      }
#pragma unroll
      for (int g = 0; g < kG; ++g) {
        const float pg = __shfl_sync(~0u, p, g * kT + t);
#pragma unroll
        for (int e = 0; e < kE; ++e) acc[g][e] += pg * vf[e];
      }
    }
  }
  cp_async_wait<0>();

  // merge the warps through shared memory (the ring is free once every
  // warp is past its loop)
  __syncthreads();
  float* sML = reinterpret_cast<float*>(smem);          // [kWarps][kG][2]
  float* sAcc = sML + kWarps * kG * 2;                   // [kWarps][Gc][D]
#pragma unroll
  for (int g = 0; g < kG; ++g) {
    const float mg = __shfl_sync(~0u, m_run, g * kT);
    const float lg = __shfl_sync(~0u, l_run, g * kT);
    if (lane == 0) {
      sML[(warp * kG + g) * 2] = mg;
      sML[(warp * kG + g) * 2 + 1] = lg;
    }
  }
#pragma unroll
  for (int g = 0; g < kG; ++g) {
    if (g >= Gc) break;
#pragma unroll
    for (int j = 0; j < kVPL; ++j) {
      const int v = lane + j * 32;
      if (v < vpr) {
#pragma unroll
        for (int e = 0; e < kN; ++e)
          sAcc[(warp * Gc + g) * D + v * kN + e] = acc[g][j * kN + e];
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < Gc * D; i += kThreads) {
    const int g = i / D;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sML[(w * kG + g) * 2]);
    float sum = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float c = expf(sML[(w * kG + g) * 2] - mx);
      sum += sML[(w * kG + g) * 2 + 1] * c;
      a += sAcc[(w * Gc + g) * D + i % D] * c;
    }
    ws_acc[(part * G + g0) * D + i] = a;
    if (i % D == 0) {
      ws_ml[(part * G + g0 + g) * 2] = mx;
      ws_ml[(part * G + g0 + g) * 2 + 1] = sum;
    }
  }
}

// grid (sequence x KV head, chunk of kCombineCols output columns): 4 lanes
// per output element each merge every 4th split's partial with a running
// max and rescaled sums, then merge with each other by shuffles. An empty
// split's acc is unwritten, so it is never read.
constexpr int kCombineCols = kThreads / 4;

template <typename T>
__global__ void __launch_bounds__(kThreads)
combine_kernel(const float* __restrict__ ws_ml,
               const float* __restrict__ ws_acc, T* __restrict__ out, int G,
               int D, int n_splits) {
  const size_t bh = blockIdx.x;
  const int i = blockIdx.y * kCombineCols + threadIdx.x / 4;
  const int lane4 = threadIdx.x % 4;
  const int g = min(i, G * D - 1) / D;
  const float* ml = ws_ml + bh * n_splits * G * 2;
  const float* acc = ws_acc + bh * n_splits * G * D;
  float mx = kNegInf, sum = 0.f, a = 0.f;
  if (i < G * D) {
    // kBatch splits' loads issued together, then merged
    constexpr int kBatch = 8;
    for (int s0 = lane4; s0 < n_splits; s0 += 4 * kBatch) {
      float ms[kBatch], ls[kBatch], as[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int s = s0 + 4 * u;
        const bool in = s < n_splits;
        ms[u] = in ? ml[(s * G + g) * 2] : kNegInf;
        ls[u] = in ? ml[(s * G + g) * 2 + 1] : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u)
        as[u] = ls[u] > 0.f ? acc[(size_t)(s0 + 4 * u) * G * D + i] : 0.f;
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const bool live = ls[u] > 0.f;
        const float mn = live ? fmaxf(mx, ms[u]) : mx;
        const float c_run = expf(mx - mn), c = live ? expf(ms[u] - mn) : 0.f;
        sum = sum * c_run + ls[u] * c;
        a = a * c_run + as[u] * c;
        mx = mn;
      }
    }
  }
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    const float mo = __shfl_xor_sync(~0u, mx, off);
    const float so = __shfl_xor_sync(~0u, sum, off);
    const float ao = __shfl_xor_sync(~0u, a, off);
    const float mn = fmaxf(mx, mo);
    const float c_run = expf(mx - mn), c = expf(mo - mn);
    sum = sum * c_run + so * c;
    a = a * c_run + ao * c;
    mx = mn;
  }
  if (i < G * D && lane4 == 0)
    narrow(a / fmaxf(sum, 1e-30f), out + bh * G * D + i);
}

template <typename T, int kG, int kVPL>
int launch_split(const void* q, const void* kp, const void* vp,
                 const void* page_idx, const void* counts,
                 const void* lengths, const void* starts, float* ws_ml,
                 float* ws_acc, int B, int KVH, int G, int D, int P,
                 int page_size, int max_pages, int split_len, int n_splits,
                 int n_gc, int gc_len, float scale, float softcap,
                 cudaStream_t stream) {
  constexpr int smem = split_smem_bytes<kG, kVPL>();
  cudaError_t err = cudaFuncSetAttribute(
      split_kernel<T, kG, kVPL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  split_kernel<T, kG, kVPL><<<dim3(n_splits, KVH * n_gc, B), kThreads, smem,
                              stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), static_cast<const int32_t*>(page_idx),
      static_cast<const int32_t*>(counts), static_cast<const int32_t*>(lengths),
      static_cast<const int32_t*>(starts), ws_ml, ws_acc, KVH, G, D, P,
      page_size, max_pages, split_len, n_splits, n_gc, gc_len, scale,
      softcap);
  return (int)cudaGetLastError();
}

template <typename T, int kVPL>
int launch_g(const void* q, const void* kp, const void* vp,
             const void* page_idx, const void* counts, const void* lengths,
             const void* starts, float* ws_ml, float* ws_acc, int B, int KVH,
             int G, int D, int P, int page_size, int max_pages, int split_len,
             int n_splits, float scale, float softcap, cudaStream_t s) {
  // ceil(G / kMaxG) chunks of equal size (12 -> 6 + 6)
  const int n_gc = (G + kMaxG - 1) / kMaxG;
  const int gc_len = (G + n_gc - 1) / n_gc;
#define PAGED_DECODE_G(KG)                                                   \
  return launch_split<T, KG, kVPL>(q, kp, vp, page_idx, counts, lengths,    \
                                   starts, ws_ml, ws_acc, B, KVH, G, D, P,  \
                                   page_size, max_pages, split_len,         \
                                   n_splits, n_gc, gc_len, scale, softcap, s)
  if (gc_len <= 1) PAGED_DECODE_G(1);
  if (gc_len <= 2) PAGED_DECODE_G(2);
  if (gc_len <= 4) PAGED_DECODE_G(4);
  PAGED_DECODE_G(8);
#undef PAGED_DECODE_G
}

template <typename T>
int launch(const void* q, const void* kp, const void* vp, const void* page_idx,
           const void* counts, const void* lengths, const void* starts,
           void* out, void* ws, int B, int KVH, int G, int D, int P,
           int page_size, int max_pages, int split_len, float scale,
           float softcap, cudaStream_t stream) {
  constexpr int kN = 16 / sizeof(T);
  if (D % kN != 0) return (int)cudaErrorInvalidValue;
  if (B * KVH == 0) return 0;
  const int vpl = (D / kN + 31) / 32;     // 16-byte vectors per lane
  const int n_splits = (max_pages * page_size + split_len - 1) / split_len;
  float* ws_ml = static_cast<float*>(ws);
  float* ws_acc = ws_ml + (size_t)B * KVH * n_splits * G * 2;
  int err;
  if constexpr (sizeof(T) == 4) {         // f32 rows past 128 take 2 a lane
    err = vpl == 1
              ? launch_g<T, 1>(q, kp, vp, page_idx, counts, lengths, starts,
                               ws_ml, ws_acc, B, KVH, G, D, P, page_size,
                               max_pages, split_len, n_splits, scale,
                               softcap, stream)
              : launch_g<T, 2>(q, kp, vp, page_idx, counts, lengths, starts,
                               ws_ml, ws_acc, B, KVH, G, D, P, page_size,
                               max_pages, split_len, n_splits, scale,
                               softcap, stream);
  } else {
    err = launch_g<T, 1>(q, kp, vp, page_idx, counts, lengths, starts, ws_ml,
                         ws_acc, B, KVH, G, D, P, page_size, max_pages,
                         split_len, n_splits, scale, softcap, stream);
  }
  if (err != 0) return err;
  combine_kernel<T><<<dim3(B * KVH, (G * D + kCombineCols - 1) /
                                         kCombineCols),
                      kThreads, 0, stream>>>(
      ws_ml, ws_acc, static_cast<T*>(out), G, D, n_splits);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, the pools and out share it). ws:
// B * KVH * n_splits * G * (D + 2) floats, n_splits = ceil(max_pages *
// page_size / split_len): (m, l) of every partial, then acc[D] of every
// partial. G above kMaxG runs as ceil(G / kMaxG) chunks of blocks. softcap
// <= 0 means no softcap. Returns a cudaError_t code.
extern "C" int sparse_attn_paged_decode(
    const void* q, const void* k_pages, const void* v_pages,
    const void* page_idx, const void* counts, const void* lengths,
    const void* starts, void* out, void* ws, int B, int KVH, int G, int D,
    int P, int page_size, int max_pages, int split_len, float scale,
    float softcap, int dtype, void* stream) {
  if (G < 1 || G > kMaxGroup || D < 1 || D > kMaxD || page_size < 1 ||
      max_pages < 1 || split_len < 1 ||
      (long long)max_pages * page_size > 0x7fffffffLL - split_len)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k_pages, v_pages, page_idx, counts,
                                 lengths, starts, out, ws, B, KVH, G, D, P,
                                 page_size, max_pages, split_len, scale,
                                 softcap, s);
  if (dtype == 0)
    return launch<float>(q, k_pages, v_pages, page_idx, counts, lengths,
                         starts, out, ws, B, KVH, G, D, P, page_size,
                         max_pages, split_len, scale, softcap, s);
  return (int)cudaErrorInvalidValue;
}
