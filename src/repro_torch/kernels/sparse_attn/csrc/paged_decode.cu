// Paged decode attention: one new token per sequence against paged KV pools
// whose per-sequence page lists come from the Roaring page table.
//
// Replaces the Pallas kernel `paged_decode_attention` (body `_decode_kernel`)
// of src/repro/kernels/sparse_attn/kernel.py. It computes the same function:
// for each (sequence b, KV head h), walk pages j < counts[b] of page_idx[b]
// (the page ids are read inside the kernel), score q.k * scale in f32, apply
// softcap * tanh(s / softcap) when softcap > 0, keep positions with
// starts[b] <= pos < lengths[b], and run an online softmax with m / l / acc
// in f32; the output is acc / max(l, 1e-30) in q's dtype. Pages at
// j >= counts[b] are never read: the padding of page_idx points at page 0,
// which belongs to another sequence. A row with no live position (counts = 0,
// or starts >= lengths) gives zeros. (The Pallas kernel averages V over the
// visited pages when counts > 0 but no position is live; no caller makes such
// a row.)
//
// What bounds it on an H100: memory. Each live position's K and V rows are
// read once (2 * KVH * D elements); the arithmetic is ~4 * G flops per
// element read, far below the card's ~295 operations per byte. The floor is
// the live K/V bytes (plus q and out) over 3.35 TB/s.
//
// What the design does about it:
//   * only live positions are staged: the walk runs over [max(starts, 0),
//     min(lengths, counts * page_size)), so a sliding-window layer skips the
//     pages before its window and the padding after counts is never touched;
//   * K and V rows arrive with 16-byte cp.async copies into a ring of
//     kStages shared-memory tiles of kTile positions (a tile may span
//     pages), so two tiles' loads are in flight while one is scored; a warp
//     stages whole rows, so each row's page id is read once, by one warp;
//   * the block has only 8 warps, so the scoring reads K as 16-byte vectors
//     for four positions at a time and the P.V pass unrolls over positions:
//     independent loads hide shared-memory latency that the few warps
//     cannot;
//   * q is widened to f32 in shared memory once per block; K / V stay in their
//     storage type in shared memory and are widened as they are read.
// One block per (b, kv-head): at the serving path's batch of 4 with gemma2's
// 4 KV heads that is 16 blocks on 132 SMs, so a long sequence is read by one
// SM. Splitting each sequence's pages over several blocks (a second pass
// combining partial m / l / acc) is the design that fills the card.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;                 // positions per tile: one per lane
constexpr int kStages = 3;                // tiles in the shared-memory ring
constexpr int kRowsPerWarp = kTile / kWarps;
constexpr int kMaxG = 8;                  // query heads per KV head
constexpr int kMaxD = 256;                // head dim: one column per thread
constexpr float kNegInf = -1e30f;

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
struct Vec16 {
  static constexpr int kN = 16 / sizeof(T);
  __device__ __forceinline__ static void load(const T* p, float* out) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < kN; ++i) out[i] = widen(e[i]);
  }
};

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(~0u, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(~0u, v, o);
  return v;
}

// 16-byte global -> shared copy that does not block the thread; with
// src_bytes = 0 it writes zeros and reads nothing
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <typename T>
size_t smem_bytes(int G, int D) {
  return 2 * (size_t)kStages * kTile * D * sizeof(T)       // K, V rings
         + sizeof(float) * ((size_t)G * D + (size_t)G * kTile + 3 * G)
         + sizeof(int) * kStages * kTile;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                    const T* __restrict__ vp,
                    const int32_t* __restrict__ page_idx,
                    const int32_t* __restrict__ counts,
                    const int32_t* __restrict__ lengths,
                    const int32_t* __restrict__ starts, T* __restrict__ out,
                    int KVH, int G, int D, int P, int page_size,
                    int max_pages, float scale, float softcap) {
  using V = Vec16<T>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.x / KVH, h = blockIdx.x % KVH;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  T* sK = reinterpret_cast<T*>(smem);                  // [kStages][kTile][D]
  T* sV = sK + kStages * kTile * D;                    // [kStages][kTile][D]
  float* sQ = reinterpret_cast<float*>(sV + kStages * kTile * D);  // [G][D]
  float* sP = sQ + G * D;                              // [G][kTile]
  float* sM = sP + G * kTile;                          // [G] running max
  float* sL = sM + G;                                  // [G] running sum
  float* sA = sL + G;                                  // [G] tile rescale
  int* sOk = reinterpret_cast<int*>(sA + G);           // [kStages][kTile]

  const T* qb = q + ((size_t)b * KVH + h) * G * D;
  for (int i = tid; i < G * D; i += kThreads) sQ[i] = widen(qb[i]);
  if (tid < G) {
    sM[tid] = kNegInf;
    sL[tid] = 0.f;
  }
  const int cnt = min(max(counts[b], 0), max_pages);
  const int lo = max(starts[b], 0);
  const int hi = min(lengths[b], cnt * page_size);
  const int n_tiles = hi > lo ? (hi - lo + kTile - 1) / kTile : 0;
  const int32_t* pages = page_idx + (size_t)b * max_pages;
  const int vpr = D / V::kN;                           // vectors per row

  // issue the copies of tile `it` into ring slot `buf`: a warp per row; a
  // row on a page id outside [0, P) is zero-filled and marked not live
  auto stage = [&](int it, int buf) {
    const int t0 = lo + it * kTile;
    const int n = min(kTile, hi - t0);
    T* dk = sK + buf * kTile * D;
    T* dv = sV + buf * kTile * D;
    for (int r = warp; r < n; r += kWarps) {
      const int pos = t0 + r;
      const int page = pages[pos / page_size];
      const bool ok = page >= 0 && page < P;
      const size_t row =
          ok ? (((size_t)page * page_size + pos % page_size) * KVH + h) * D
             : 0;
      for (int c = lane; c < vpr; c += 32) {
        cp_async16(dk + r * D + c * V::kN, kp + row + c * V::kN, ok ? 16 : 0);
        cp_async16(dv + r * D + c * V::kN, vp + row + c * V::kN, ok ? 16 : 0);
      }
      if (lane == 0) sOk[buf * kTile + r] = ok;
    }
  };

  float acc[kMaxG];
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) acc[g] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_tiles) stage(s, s);
    cp_async_commit();
  }
  for (int it = 0; it < n_tiles; ++it) {
    const int buf = it % kStages;
    // refill the slot the previous iteration finished with
    if (it + kStages - 1 < n_tiles)
      stage(it + kStages - 1, (it + kStages - 1) % kStages);
    cp_async_commit();
    cp_async_wait<kStages - 1>();        // tile `it` has landed
    __syncthreads();
    const int n = min(kTile, hi - (lo + it * kTile));
    const T* tk = sK + buf * kTile * D;
    const T* tv = sV + buf * kTile * D;
    const int* ok = sOk + buf * kTile;

    // scores: a warp per kRowsPerWarp positions, lanes across D in 16-byte
    // vectors; the positions' loads are independent
    float part[kRowsPerWarp][kMaxG];
#pragma unroll
    for (int j = 0; j < kRowsPerWarp; ++j)
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) part[j][g] = 0.f;
    for (int c = lane; c < vpr; c += 32) {
      float kv[kRowsPerWarp][V::kN];
#pragma unroll
      for (int j = 0; j < kRowsPerWarp; ++j) {
        const int t = warp + j * kWarps;
        if (t < n) {
          V::load(tk + t * D + c * V::kN, kv[j]);
        } else {
#pragma unroll
          for (int e = 0; e < V::kN; ++e) kv[j][e] = 0.f;
        }
      }
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) {
        if (g >= G) break;
        const float* qg = sQ + g * D + c * V::kN;
#pragma unroll
        for (int e = 0; e < V::kN; ++e) {
          const float qe = qg[e];
#pragma unroll
          for (int j = 0; j < kRowsPerWarp; ++j) part[j][g] += qe * kv[j][e];
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kRowsPerWarp; ++j) {
      const int t = warp + j * kWarps;
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) {
        if (g >= G) break;
        float s = warp_sum(part[j][g]) * scale;
        if (softcap > 0.f) s = softcap * tanhf(s / softcap);
        if (lane == 0 && t < n) sP[g * kTile + t] = s;
      }
    }
    __syncthreads();

    // online softmax: a warp per query head, a lane per position
    for (int g = warp; g < G; g += kWarps) {
      const bool live = lane < n && ok[lane];
      const float s = live ? sP[g * kTile + lane] : kNegInf;
      const float m_prev = sM[g];
      const float m_new = fmaxf(m_prev, warp_max(s));
      const float p = live ? expf(s - m_new) : 0.f;
      const float sum = warp_sum(p);
      sP[g * kTile + lane] = p;
      if (lane == 0) {
        const float a = expf(m_prev - m_new);
        sA[g] = a;
        sL[g] = sL[g] * a + sum;
        sM[g] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * alpha + p @ V: a thread per head-dim column; rows that
    // are not live have p = 0 and were zero-filled or hold finite staged
    // values, and rows at t >= n are never read
    if (tid < D) {
#pragma unroll
      for (int g = 0; g < kMaxG; ++g)
        if (g < G) acc[g] *= sA[g];
#pragma unroll 8
      for (int t = 0; t < n; ++t) {
        const float vv = widen(tv[t * D + tid]);
#pragma unroll
        for (int g = 0; g < kMaxG; ++g)
          if (g < G) acc[g] += sP[g * kTile + t] * vv;
      }
    }
    __syncthreads();                     // slot `buf` may be refilled next
  }
  cp_async_wait<0>();
  __syncthreads();

  if (tid < D) {
    T* ob = out + ((size_t)b * KVH + h) * G * D;
#pragma unroll
    for (int g = 0; g < kMaxG; ++g)
      if (g < G) narrow(acc[g] / fmaxf(sL[g], 1e-30f), ob + g * D + tid);
  }
}

template <typename T>
int launch(const void* q, const void* kp, const void* vp, const void* page_idx,
           const void* counts, const void* lengths, const void* starts,
           void* out, int B, int KVH, int G, int D, int P, int page_size,
           int max_pages, float scale, float softcap, cudaStream_t stream) {
  if ((D * (int)sizeof(T)) % 16 != 0) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes<T>(G, D);
  cudaError_t err = cudaFuncSetAttribute(
      paged_decode_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (B * KVH == 0) return 0;
  paged_decode_kernel<T><<<B * KVH, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), static_cast<const int32_t*>(page_idx),
      static_cast<const int32_t*>(counts), static_cast<const int32_t*>(lengths),
      static_cast<const int32_t*>(starts), static_cast<T*>(out), KVH, G, D, P,
      page_size, max_pages, scale, softcap);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, the pools and out share it).
// softcap <= 0 means no softcap. Returns a cudaError_t code.
extern "C" int sparse_attn_paged_decode(
    const void* q, const void* k_pages, const void* v_pages,
    const void* page_idx, const void* counts, const void* lengths,
    const void* starts, void* out, int B, int KVH, int G, int D, int P,
    int page_size, int max_pages, float scale, float softcap, int dtype,
    void* stream) {
  if (G < 1 || G > kMaxG || D < 1 || D > kMaxD || page_size < 1 ||
      max_pages < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k_pages, v_pages, page_idx, counts,
                                 lengths, starts, out, B, KVH, G, D, P,
                                 page_size, max_pages, scale, softcap, s);
  if (dtype == 0)
    return launch<float>(q, k_pages, v_pages, page_idx, counts, lengths,
                         starts, out, B, KVH, G, D, P, page_size, max_pages,
                         scale, softcap, s);
  return (int)cudaErrorInvalidValue;
}
