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
// Design: split-KV flash decoding, two launches. Split blocks each write one
// f32 partial (m, l, acc[G][D]) per (sequence, KV head, split) into a
// workspace the wrapper allocates, and `combine_kernel` merges them. Split
// s owns positions [s * split_len, (s + 1) * split_len) and walks only
// their part inside [max(starts, 0), min(lengths, counts * page_size)); a
// split with no live position writes an empty partial (l = 0) and exits.
// The wrapper picks split_len (64-2048) from page_idx.shape[1] * page_size
// alone, never from lengths. Two split kernels, picked by shape:
//
//   * `mma_split_kernel<D>`: bf16 at D = 64 / 80 / 128, G <= 16. A warp
//     serves all G query heads of its KV head as the M of
//     mma.sync.m16n8k16 (bf16 in, f32 accumulate; rows G..15 zero), so G
//     up to 16 is one block: S = Q K^T with positions as N and D as K (Q's
//     fragments stay in registers), the online softmax in f32 on the
//     accumulator fragments (a row's max over its 4 lanes), then O += P V
//     with D as N and positions as K. P goes in as bf16(p) + bf16(p -
//     bf16(p)) (two mmas), so it keeps ~16 bits, as the f32 reference's P
//     does; q.k products of bf16 are exact in f32, as the TPU kernel's f32
//     dot is. Padding G = 1 to 16 rows multiplies zeros: at decode_32k the
//     G = 1 shapes reach as large a share of their bound as G = 5-12.
//   * Copies: K / V rows arrive by 16-byte cp.async into a per-warp ring of
//     16-position tiles, each row padded to an odd number of 16-byte
//     vectors (ldmatrix's 8 rows land on distinct banks). The lanes copy
//     consecutive vectors of the tile's rows, so every lane copies at
//     every D: 4 rows an instruction at D = 64, 3.2 at 80, 2 at 128. A warp
//     barrier after cp.async.wait_group makes every lane's copies visible
//     to the warp's ldmatrix. A position that is not live (past the
//     split's end, or on a bad page id) is zero-filled by the copy itself
//     (a source size of 0: nothing is read from it), so a NaN page cannot
//     reach an output; a tile with no live position is neither copied nor
//     computed. Page ids are loaded an iteration before their tile is
//     staged.
//   * Memory, per head dim: at D = 64 / 80 a block serves four
//     neighbouring KV heads, a warp each, and every copy asks L2 for its
//     256-byte line, so the line that holds two heads' 128- / 160-byte
//     rows is read from memory once for both; the ring holds 4 tiles.
//     At D = 128 a block serves one KV head, its 4 warps taking every
//     fourth tile and merging through shared memory at the end, with
//     128-byte lines and a ring of 3 tiles. The head groups of a split are
//     neighbours in the grid. Blocks resident on an SM (the rings' shared
//     memory bounds them; the launch bounds let registers admit as many),
//     and the bytes in flight while each warp computes a tile:
//       D = 64:  3 blocks of 72 KB: 12 warps x 3 tiles x 4 KB = 144 KB;
//       D = 80:  2 blocks of 88 KB:  8 warps x 3 tiles x 5 KB = 120 KB;
//       D = 128: 2 blocks of 102 KB: 8 warps x 2 tiles x 8 KB = 128 KB.
//     Little's law asks ~25 KB an SM at 3.35 TB/s and ~1 us, and a ring one
//     tile shorter (more blocks an SM) runs within 1.6 %, one tile longer
//     at D = 128 (one block an SM) 7.5-9 % slower (tools/paged_decode_ab.py
//     on variant checkouts; NVIDIA H100 80GB HBM3, 700.00 W): not bytes in
//     flight but, as far as measured, how the memory serves rows of 128-256
//     bytes scattered over pages bounds it. (Registers a thread:
//     chip_smoke.py's log, from `build.ptxas_report`.)
//   * `split_kernel<T, kG, kVPL>`: f32 at any D, and bf16 at any other D
//     (gemma2-2b's 256): the CUDA cores. A block serves a chunk of at most
//     8 query heads of its KV head (G = 9-16 runs as ceil(G / 8) equal
//     chunks, each a block that reads the KV head's K / V; the chunks of a
//     head are neighbours in the grid). Each of its 4 warps walks its own
//     tiles of 8 positions (4 when G = 8); a lane owns one 16-byte vector
//     of every row (two for f32 past D = 128), keeps q and acc[G][its
//     columns] in f32 registers, forms partial q.k sums and reduce-scatters
//     them over the warp, so the scalar work is done once per score. K / V
//     arrive by 16-byte cp.async into a ring of 3 tiles a warp, each lane
//     copying exactly the vectors it later reads; a position that is not
//     live is neither copied nor read nor multiplied. The warps merge
//     through shared memory at the end. At D = 256 bf16 every lane is
//     busy; at narrower f32 rows lanes past the row idle (its time is not
//     a target).
//   * `combine_kernel`: four threads per output element merge its splits'
//     partials (each every fourth split, then by shuffles), skipping those
//     with l = 0, and write acc / max(l, 1e-30) in q's dtype. Kept as a
//     second launch: at decode_32k a split walks 1,024-2,048 positions,
//     so the partials are about 1 % or less of the bytes the split blocks
//     read.
//
// Which kernel each registry shape takes (bf16; the reduced registry's f32
// serving checks all take split_kernel):
//   gemma2-2b (KVH 4, G 2, D 256): split_kernel;
//   stablelm-1.6b (32, 1, 64), whisper-base (8, 1, 64), stablelm-3b (32,
//   1, 80): mma_split_kernel, 4 KV heads a block;
//   llama4 (8, 5, 128), dbrx-132b (8, 6, 128), qwen2-vl / jamba (8, 8,
//   128), starcoder2-15b (4, 12, 128): mma_split_kernel, 1 KV head a block.
//
// Replaces (NVIDIA H100 80GB HBM3, 700.00 W; tools/paged_decode_ab.py, the
// two versions in turns, cold L2, decode_32k with the batch cut to 32): at
// D <= 128, split_kernel with G above 8 in two chunks, whose lanes past the
// row idled (half the warp at D = 128, three quarters at 64): 4.3182 ->
// 1.4360 ms (llama4), 4.3692 -> 1.4416 (dbrx), 4.3753 -> 1.4514
// (qwen2-vl), 4.3820 -> 0.7616 (starcoder2), 9.5214 -> 2.8376
// (stablelm-1.6b), 9.5179 -> 3.5915 (stablelm-3b), 2.4585 -> 0.7427 ms
// (whisper); 84-90 % of the bound, against SDPA's 92-95 % over contiguous
// K / V. gemma2-2b's shapes keep split_kernel with longer splits: 1.4335
// -> 1.4138 ms at decode_32k. Before that split_kernel replaced the first
// version, one 256-thread block per (sequence, KV head) walking 32-position
// tiles in lock-step: 0.7215-0.7276 ms at the serving path's largest
// launch and 5.5685-5.6209 ms at decode_32k.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kStages = 3;                // tiles in each warp's ring
constexpr int kMaxG = 8;                  // query heads of a split_kernel block
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
// the same copy, or, where `live` is false, 16 zero bytes written to smem
// with nothing read from global memory (a source size of 0); it asks L2 to
// fetch the kL2-byte (128 / 256) line around the source
template <int kL2>
__device__ __forceinline__ void cp_async16_zfill(void* smem, const void* gmem,
                                                 bool live) {
  static_assert(kL2 == 128 || kL2 == 256, "an L2 line of 128 or 256 bytes");
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  if constexpr (kL2 == 256) {
    asm volatile(
        "cp.async.cg.shared.global.L2::256B [%0], [%1], 16, %2;\n" ::"r"(s),
        "l"(gmem), "r"(live ? 16 : 0)
        : "memory");
  } else {
    asm volatile(
        "cp.async.cg.shared.global.L2::128B [%0], [%1], 16, %2;\n" ::"r"(s),
        "l"(gmem), "r"(live ? 16 : 0)
        : "memory");
  }
}

// four 8x8 b16 matrices from shared memory; lane i gives the address of row
// i % 8 of matrix i / 8 (`trans`: each matrix transposed)
__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s)
      : "memory");
}
__device__ __forceinline__ void ldsm_x4_t(unsigned (&r)[4], const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s)
      : "memory");
}
// c += a (16 x 16, row) * b (16 x 8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ unsigned as_u32(__nv_bfloat162 v) {
  return *reinterpret_cast<unsigned*>(&v);
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

// A split block's last step: merge warps w0 .. w0 + nw - 1's (m, l, acc)
// from shared memory (sML [warp][ml_stride][2], sAcc [warp][Gc][D]) into
// the f32 partial of query heads row0 - part * G .. + Gc - 1 of the
// workspace.
__device__ __forceinline__ void write_partial(const float* sML, int ml_stride,
                                              const float* sAcc, int Gc,
                                              int D, int w0, int nw,
                                              float* ws_ml, float* ws_acc,
                                              size_t row0, int tid) {
  for (int i = tid; i < Gc * D; i += kThreads) {
    const int g = i / D;
    float mx = kNegInf;
    for (int w = w0; w < w0 + nw; ++w)
      mx = fmaxf(mx, sML[(w * ml_stride + g) * 2]);
    float sum = 0.f, a = 0.f;
    for (int w = w0; w < w0 + nw; ++w) {
      const float c = expf(sML[(w * ml_stride + g) * 2] - mx);
      sum += sML[(w * ml_stride + g) * 2 + 1] * c;
      a += sAcc[(w * Gc + g) * D + i % D] * c;
    }
    ws_acc[row0 * D + i] = a;
    if (i % D == 0) {
      ws_ml[(row0 + g) * 2] = mx;
      ws_ml[(row0 + g) * 2 + 1] = sum;
    }
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
  write_partial(sML, kG, sAcc, Gc, D, 0, kWarps, ws_ml, ws_acc, part * G + g0,
                tid);
}

// =============================================================================
// bf16 at D = 64 / 80 / 128: the tensor-core kernel
// =============================================================================

constexpr int kMT = 16;                   // positions of a warp tile

template <int kD>
struct MmaTile {
  static constexpr int kVPR = kD / 8;     // 16-byte vectors of a row
  // row stride in the ring, in vectors: odd, so the 8 rows of an ldmatrix
  // fall on distinct banks
  static constexpr int kLd = kVPR | 1;
  static constexpr int kKS = kD / 16;     // k steps of S = Q K^T
  static constexpr int kNT = kD / 8;      // n tiles of O
  static constexpr int kCopies = kMT * kVPR / 32;  // of K (and of V) a lane
  static constexpr int kStage = 2 * kMT * kLd;     // vectors: K rows, V rows
  static constexpr int kStages = kD <= 80 ? 4 : 3;  // tiles in a warp's ring
  static constexpr int kSmem = kWarps * kStages * kStage * 16;
  // the blocks an SM's 227 KB of shared memory holds, for the launch
  // bounds: registers never keep out a block that shared memory would admit
  static constexpr int kMinBlocks = 232448 / kSmem;
  // KV heads of a block (its warps split the positions of each head), and
  // the L2 line each copy asks for: rows of 128 / 160 bytes take four
  // neighbouring KV heads a block and 256-byte lines, so a line that holds
  // parts of two heads' rows is read from memory once for both
  static constexpr int kHeads = kD <= 80 ? 4 : 1;
  static constexpr int kL2 = kD <= 80 ? 256 : 128;
  static constexpr int kWPH = kWarps / kHeads;     // warps a KV head
  static_assert(kD % 16 == 0 && kMT * kVPR % 32 == 0, "bad head dim");
  static_assert(kStages * kMT <= 64, "the live bits of the ring: 64 bits");
  static_assert(kMinBlocks >= 1, "the ring must fit shared memory");
  static_assert(kSmem >= (int)sizeof(float) * kWarps * (kMaxGroup * kD +
                                                        2 * kMaxGroup),
                "the merge must fit in the rings");
};

// One block a (split, group of kHeads KV heads, sequence): each KV head
// has kWPH warps, and serves all its G <= 16 query heads as the M of
// mma.sync.m16n8k16 (rows G..15 zero). A warp walks every kWPH-th
// 16-position tile of the split: S = Q K^T (positions as N, D as K), the
// online softmax in f32 on the accumulator fragments, then O += P V (D as
// N, positions as K) with P split into bf16(p) and bf16(p - bf16(p)), so P
// keeps ~16 bits as in the f32 reference.
template <int kD>
__global__ void __launch_bounds__(kThreads, MmaTile<kD>::kMinBlocks)
mma_split_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ kp,
                 const __nv_bfloat16* __restrict__ vp,
                 const int32_t* __restrict__ page_idx,
                 const int32_t* __restrict__ counts,
                 const int32_t* __restrict__ lengths,
                 const int32_t* __restrict__ starts, float* __restrict__ ws_ml,
                 float* __restrict__ ws_acc, int KVH, int G, int P,
                 int page_size, int max_pages, int split_len, int n_splits,
                 float scale, float softcap) {
  using M = MmaTile<kD>;
  extern __shared__ __align__(16) unsigned char smem[];
  // the head groups of one split and sequence are neighbours in the grid,
  // so the KV heads of a page are read together
  const int n_hg = (KVH + M::kHeads - 1) / M::kHeads;
  const int s = blockIdx.x / n_hg, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int hh = warp / M::kWPH, slot = warp % M::kWPH;
  const int h = blockIdx.x % n_hg * M::kHeads + hh;
  const bool head = h < KVH;               // warp-uniform
  const int gid = lane >> 2, tq = lane & 3;   // fragment row, column pair
  const size_t part = ((size_t)b * KVH + h) * n_splits + s;

  const int cnt = min(max(counts[b], 0), max_pages);
  const int lo = max(max(starts[b], 0), s * split_len);
  const int hi = min(min(lengths[b], cnt * page_size), (s + 1) * split_len);
  if (hi <= lo) {                          // nothing live: empty partials
    if (head && slot == 0 && lane < G) {
      ws_ml[(part * G + lane) * 2] = kNegInf;
      ws_ml[(part * G + lane) * 2 + 1] = 0.f;
    }
    return;
  }
  // a warp past the last KV head walks no tile
  const int n_it = head ? (hi - lo + M::kWPH * kMT - 1) / (M::kWPH * kMT) : 0;
  const int32_t* pages = page_idx + (size_t)b * max_pages;

  // Q as the A operand: rows gid and gid + 8 are query heads (zero past G)
  unsigned qa[M::kKS][4];
  const __nv_bfloat16* qb = q + ((size_t)b * KVH + h) * G * kD;
#pragma unroll
  for (int kk = 0; kk < M::kKS; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int g = gid + (r & 1) * 8;
      const int d = kk * 16 + (r >> 1) * 8 + 2 * tq;
      qa[kk][r] = head && g < G
                      ? *reinterpret_cast<const unsigned*>(qb + g * kD + d)
                      : 0u;
    }

  // this warp's ring: [stage][K rows, V rows][position][vector]
  uint4* ring = reinterpret_cast<uint4*>(smem) +
                (size_t)warp * M::kStages * M::kStage;
  // lane t < 16: the page id of position t of this warp's tile `it`, or -1
  // past hi; loaded one iteration before the tile is staged, so the copies
  // never wait on the page list
  auto page_of = [&](int it) -> int {
    const int pos = lo + (it * M::kWPH + slot) * kMT + lane;
    return lane < kMT && pos < hi ? pages[pos / page_size] : -1;
  };
  // the live positions of each staged tile, 16 bits per ring slot
  unsigned long long live_fifo = 0;
  auto stage = [&](int it, int st, int page) {
    const int pos = lo + (it * M::kWPH + slot) * kMT + lane;
    const long long mine =
        page >= 0 && page < P
            ? (((long long)page * page_size + pos % page_size) * KVH + h) * kD
            : -1;
    const unsigned live = __ballot_sync(~0u, mine >= 0);
    live_fifo = (live_fifo & ~(0xffffull << (16 * st))) |
                ((unsigned long long)live << (16 * st));
    if (!live) return;                     // warp-uniform: the tile is skipped
    uint4* kt = ring + st * M::kStage;
    uint4* vt = kt + kMT * M::kLd;
    // the warp's lanes take consecutive vectors of the tile's rows: 32 /
    // kVPR positions a copy instruction, every lane busy; a position that
    // is not live gets zeros and nothing is read for it
#pragma unroll
    for (int i = 0; i < M::kCopies; ++i) {
      const int c = lane + 32 * i, t = c / M::kVPR, v = c % M::kVPR;
      const long long r = __shfl_sync(~0u, mine, t);
      const long long off = r >= 0 ? r + v * 8 : 0;
      cp_async16_zfill<M::kL2>(kt + t * M::kLd + v, kp + off, r >= 0);
      cp_async16_zfill<M::kL2>(vt + t * M::kLd + v, vp + off, r >= 0);
    }
  };

  float o[M::kNT][4];
#pragma unroll
  for (int n = 0; n < M::kNT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m_run[2] = {kNegInf, kNegInf}, l_run[2] = {0.f, 0.f};

#pragma unroll
  for (int st = 0; st < M::kStages - 1; ++st) {
    if (st < n_it) stage(st, st, page_of(st));
    cp_async_commit();
  }
  int page_next = page_of(M::kStages - 1);
  for (int it = 0; it < n_it; ++it) {
    __syncwarp();                        // the slot refilled here is read
    if (it + M::kStages - 1 < n_it)
      stage(it + M::kStages - 1, (it + M::kStages - 1) % M::kStages, page_next);
    cp_async_commit();
    page_next = page_of(it + M::kStages);
    cp_async_wait<M::kStages - 1>();       // this lane's copies of `it` landed
    __syncwarp();                        // and every other lane's
    const int st = it % M::kStages;
    const unsigned live = (unsigned)(live_fifo >> (16 * st)) & 0xffffu;
    if (!live) continue;                 // warp-uniform
    const uint4* kt = ring + st * M::kStage;
    const uint4* vt = kt + kMT * M::kLd;

    // S = Q K^T: sc[j] holds positions 8 j + 2 tq, + 1 of heads gid, gid + 8
    float sc[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < M::kKS; ++kk) {
      unsigned bk[4];
      ldsm_x4(bk, kt + ((lane >> 4) * 8 + (lane & 7)) * M::kLd + 2 * kk +
                      (lane >> 3 & 1));
      mma_bf16(sc[0], qa[kk], bk[0], bk[1]);
      mma_bf16(sc[1], qa[kk], bk[2], bk[3]);
    }

    // online softmax; each row's max over the 4 lanes of a fragment row,
    // its sum kept per lane until the end
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = sc[j][e] * scale;
        if (softcap > 0.f) x = softcap * tanhf(x / softcap);
        sc[j][e] = (live >> (8 * j + 2 * tq + (e & 1)) & 1) ? x : kNegInf;
        mx[e >> 1] = fmaxf(mx[e >> 1], sc[j][e]);
      }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(~0u, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(~0u, mx[r], 2));
      const float m_new = fmaxf(m_run[r], mx[r]);
      alpha[r] = expf(m_run[r] - m_new);
      m_run[r] = m_new;
    }
    unsigned ph[4], pl[4];
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        p[e] = (live >> (8 * j + 2 * tq + (e & 1)) & 1)
                   ? expf(sc[j][e] - m_run[e >> 1])
                   : 0.f;
      rs[0] += p[0] + p[1];
      rs[1] += p[2] + p[3];
      const __nv_bfloat162 h01 = __floats2bfloat162_rn(p[0], p[1]);
      const __nv_bfloat162 h23 = __floats2bfloat162_rn(p[2], p[3]);
      const float2 f01 = __bfloat1622float2(h01);
      const float2 f23 = __bfloat1622float2(h23);
      ph[2 * j] = as_u32(h01);
      ph[2 * j + 1] = as_u32(h23);
      pl[2 * j] = as_u32(__floats2bfloat162_rn(p[0] - f01.x, p[1] - f01.y));
      pl[2 * j + 1] =
          as_u32(__floats2bfloat162_rn(p[2] - f23.x, p[3] - f23.y));
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l_run[r] = l_run[r] * alpha[r] + rs[r];
#pragma unroll
    for (int n = 0; n < M::kNT; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }

    // O += P_hi V + P_lo V, 16 columns of V per ldmatrix
#pragma unroll
    for (int np = 0; np < M::kNT / 2; ++np) {
      unsigned bv[4];
      ldsm_x4_t(bv, vt + ((lane >> 3 & 1) * 8 + (lane & 7)) * M::kLd +
                        2 * np + (lane >> 4));
      mma_bf16(o[2 * np], ph, bv[0], bv[1]);
      mma_bf16(o[2 * np + 1], ph, bv[2], bv[3]);
      mma_bf16(o[2 * np], pl, bv[0], bv[1]);
      mma_bf16(o[2 * np + 1], pl, bv[2], bv[3]);
    }
  }
  cp_async_wait<0>();
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(~0u, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(~0u, l_run[r], 2);
  }

  if constexpr (M::kWPH == 1) {
    // a warp a KV head: its partial, (m, l) and acc[G][kD], straight from
    // the fragments
    if (!head) return;
    float* acc = ws_acc + part * G * kD;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int g = gid + 8 * r;
      if (g < G) {
        if (tq == 0) {
          ws_ml[(part * G + g) * 2] = m_run[r];
          ws_ml[(part * G + g) * 2 + 1] = l_run[r];
        }
#pragma unroll
        for (int n = 0; n < M::kNT; ++n)
          *reinterpret_cast<float2*>(acc + g * kD + 8 * n + 2 * tq) =
              make_float2(o[n][2 * r], o[n][2 * r + 1]);
      }
    }
  } else {
    // merge each KV head's warps through shared memory (the ring is free
    // once every warp is past its loop)
    __syncthreads();
    float* sML = reinterpret_cast<float*>(smem);   // [kWarps][kMaxGroup][2]
    float* sAcc = sML + kWarps * kMaxGroup * 2;    // [kWarps][G][kD]
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int g = gid + 8 * r;
      if (tq == 0 && g < G) {
        sML[(warp * kMaxGroup + g) * 2] = m_run[r];
        sML[(warp * kMaxGroup + g) * 2 + 1] = l_run[r];
      }
    }
#pragma unroll
    for (int n = 0; n < M::kNT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int g = gid + (e >> 1) * 8;
        if (g < G)
          sAcc[(warp * G + g) * kD + 8 * n + 2 * tq + (e & 1)] = o[n][e];
      }
    __syncthreads();
    const int h0 = blockIdx.x % n_hg * M::kHeads;
    for (int j = 0; j < M::kHeads && h0 + j < KVH; ++j)
      write_partial(sML, kMaxGroup, sAcc, G, kD, j * M::kWPH, M::kWPH, ws_ml,
                    ws_acc,
                    (((size_t)b * KVH + h0 + j) * n_splits + s) * G, tid);
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

template <int kD>
int launch_mma(const void* q, const void* kp, const void* vp,
               const void* page_idx, const void* counts, const void* lengths,
               const void* starts, float* ws_ml, float* ws_acc, int B,
               int KVH, int G, int P, int page_size, int max_pages,
               int split_len, int n_splits, float scale, float softcap,
               cudaStream_t stream) {
  constexpr int smem = MmaTile<kD>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(
      mma_split_kernel<kD>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int n_hg = (KVH + MmaTile<kD>::kHeads - 1) / MmaTile<kD>::kHeads;
  mma_split_kernel<kD><<<dim3(n_splits * n_hg, B), kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(kp),
      static_cast<const __nv_bfloat16*>(vp),
      static_cast<const int32_t*>(page_idx),
      static_cast<const int32_t*>(counts), static_cast<const int32_t*>(lengths),
      static_cast<const int32_t*>(starts), ws_ml, ws_acc, KVH, G, P,
      page_size, max_pages, split_len, n_splits, scale, softcap);
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
  } else {                                // bf16: tensor cores by D
#define PAGED_DECODE_MMA(KD)                                               \
  launch_mma<KD>(q, kp, vp, page_idx, counts, lengths, starts, ws_ml,     \
                 ws_acc, B, KVH, G, P, page_size, max_pages, split_len,   \
                 n_splits, scale, softcap, stream)
    if (D == 64)
      err = PAGED_DECODE_MMA(64);
    else if (D == 80)
      err = PAGED_DECODE_MMA(80);
    else if (D == 128)
      err = PAGED_DECODE_MMA(128);
    else
      err = launch_g<T, 1>(q, kp, vp, page_idx, counts, lengths, starts,
                           ws_ml, ws_acc, B, KVH, G, D, P, page_size,
                           max_pages, split_len, n_splits, scale, softcap,
                           stream);
#undef PAGED_DECODE_MMA
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
// partial. bf16 at D = 64 / 80 / 128 runs mma_split_kernel, anything else
// split_kernel (G above kMaxG as ceil(G / kMaxG) chunks of blocks). softcap
// <= 0 means no softcap. Returns a cudaError_t code.
extern "C" int sparse_attn_paged_decode(
    const void* q, const void* k_pages, const void* v_pages,
    const void* page_idx, const void* counts, const void* lengths,
    const void* starts, void* out, void* ws, int B, int KVH, int G, int D,
    int P, int page_size, int max_pages, int split_len, float scale,
    float softcap, int dtype, void* stream) {
  if (G < 1 || G > kMaxGroup || D < 1 || D > kMaxD || page_size < 1 ||
      max_pages < 1 || split_len < 1 || B > 65535 ||
      (long long)max_pages * page_size > 0x7fffffffLL - split_len ||
      ((long long)max_pages * page_size + split_len - 1) / split_len * KVH >
          0x7fffffffLL)
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
