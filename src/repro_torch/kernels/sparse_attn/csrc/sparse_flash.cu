// Block-sparse flash attention forward over Roaring-extracted block lists.
//
// Replaces the Pallas kernel `sparse_flash_attention` (body `_flash_kernel`)
// of src/repro/kernels/sparse_attn/kernel.py. It computes the same function
// as the reference's oracle `sparse_attention_ref`: for each query row of
// q-block qb, attend only to the key positions of the KV blocks listed in
// the first counts[qb] entries of kv_idx[qb] (GQA: query head h reads KV
// head h / G), score q.k * scale in f32, apply softcap * tanh(s / softcap)
// when softcap > 0, mask key positions after the query position when
// causal (positions come from the *listed block id*, kv_block * block_kv,
// not from the list slot), and take the softmax-weighted sum of V with
// m / l / acc in f32; the output is acc / max(l, 1e-30) in q's dtype.
// Entries of kv_idx at or after counts[qb] are never read (compile_mask pads
// them with block 0), and an id outside [0, S_kv / block_kv) is skipped. A
// row with no live score gives zeros, as the oracle does. (The Pallas kernel
// gives the mean of V over the visited blocks there: its masked scores stay
// at -1e30 = m, so exp(s - m) = 1. The model's masks always list a row's own
// block, so the training path never meets such a row; ROADMAP queue 3.)
//
// What bounds it on an H100: operations. Each live (query, key) pair costs
// 4 * D flops (QK and PV) against ~4 * D bytes of q / k / v per *row*, so at
// gemma2's shapes (D = 256, ~150 live keys per query row on average) the
// arithmetic is ~40 GFLOP per launch against ~50 MB: the floor is the
// flops over the bf16 tensor-core peak.
//
// bf16 (`sparse_flash_mma_kernel`, the training path): tensor cores.
//   * A block holds one 64-row q-tile of the G query heads of one KV head
//     (two heads a block when G is even, else one), a warp 16 rows of one
//     head, so each K / V tile is loaded once for the GQA pair. It walks
//     32-key sub-tiles of the listed blocks through a 3-stage cp.async ring;
//     one block barrier per sub-tile.
//   * S = Q K^T and O += P V run on `mma.sync.m16n8k16` bf16 -> f32, their
//     operands read by `ldmatrix` (`.trans` for V) from shared memory rows
//     padded by 16 bytes, which keeps the eight rows of each 8x8 matrix on
//     distinct banks. Q stays in shared memory; O (16 x D f32, 128 registers
//     a thread at D = 256), the running max and the row sums in registers.
//   * The scores are scaled after the product in f32 (q is not pre-scaled
//     in bf16): one multiply by scale / softcap, then the accurate tanhf
//     (the scalar work per score, not the tensor cores, takes much of the
//     time, so the division and expf give way to that multiply and exp2f of
//     a fused multiply-add, a few f32 ulps apart). P = exp(s - m) is kept
//     exact to about f32 by splitting it into P_hi = bf16(p) and P_lo =
//     bf16(p - P_hi) and issuing both P.V products: P rounded to bf16 alone
//     would add up to 2^-9 of |V| a term, more than one bf16 rounding of an
//     output that is much smaller than the V it averages.
//   * Causal: a listed block, or a sub-tile, wholly after the q-tile's last
//     row is skipped without loading it, a warp skips a sub-tile wholly
//     after its own rows, and only sub-tiles that cross a warp's diagonal
//     are masked per element; masked scores give p = 0 exactly (a select,
//     never a product), so a row without a live score stays zeros.
// D need not be a power of two, only a multiple of 16: D = 80 (stablelm-3b)
// is a bf16 row of 160 bytes, ten 16-byte vectors and five k-steps of the
// QK product; its padded row of 176 bytes still puts the eight rows of an
// ldmatrix on distinct banks. The f32 kernel gives each thread D / 16
// output columns.
// f32 (`sparse_flash_f32_kernel`): the first design on the CUDA cores, in
// f32 throughout, since neither bf16 tensor cores nor TF32 keep f32's
// precision. A block owns 64 query rows of one (batch, head) and walks
// 32-key sub-tiles: q widened once to shared memory, each K sub-tile
// transposed there, acc in registers, P through shared memory.
// Replaces (NVIDIA H100 80GB HBM3, 700 W): the f32 kernel for bf16 inputs
// too, 2.2667-2.2892 ms at the training path's global layer, where
// scaled_dot_product_attention took 0.5841-0.5872 ms (PERF.md's kernel
// table).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;            // f32 kernel
constexpr int kQT = 64;                  // query rows per block (both)
constexpr int kKT = 32;                  // keys per sub-tile (both)
constexpr int kRows = 4;                 // f32: query rows per thread
constexpr int kCols = 2;                 // f32: keys per thread in the scores
constexpr int kStages = 3;               // bf16: K / V sub-tiles in the ring
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// max / sum over the 16 lanes that share a query row (lane bits 0-3)
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(~0u, v, o));
  return v;
}
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(~0u, v, o);
  return v;
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

// =============================================================================
// f32: CUDA cores
// =============================================================================

template <int D>
constexpr size_t f32_smem_bytes() {
  return sizeof(float) * ((size_t)kQT * (D + 4)       // q, f32
                          + (size_t)D * (kKT + 1)     // K sub-tile, transposed
                          + (size_t)kKT * D           // V sub-tile
                          + (size_t)kQT * (kKT + 1)); // P
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
sparse_flash_f32_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const int32_t* __restrict__ kv_idx,
                        const int32_t* __restrict__ counts,
                        float* __restrict__ out, int H, int KVH, int S,
                        int S_kv, int max_active, int block_q, int block_kv,
                        int causal, float scale, float softcap) {
  constexpr int kNJ = D / 16;            // output columns per thread
  constexpr int kQS = D + 4;             // q row stride (16-byte aligned)
  constexpr int kKS = kKT + 1;           // K^T and P row stride
  extern __shared__ __align__(16) unsigned char smem[];
  float* sQ = reinterpret_cast<float*>(smem);          // [kQT][kQS]
  float* sKT = sQ + kQT * kQS;                         // [D][kKS]
  float* sV = sKT + D * kKS;                           // [kKT][D]
  float* sP = sV + kKT * D;                            // [kQT][kKS]

  const int tid = threadIdx.x;
  const int tx = tid & 15;               // key / column lane of a row group
  const int ty = tid >> 4;               // row group: rows ty * 4 .. + 3
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int kvh = h / (H / KVH);
  const int q0 = blockIdx.x * kQT;
  const int qb = q0 / block_q;
  const int n_kvb = S_kv / block_kv;

  const float* qp = q + ((size_t)bh * S + q0) * D;
  const float* kp = k + ((size_t)b * KVH + kvh) * S_kv * D;
  const float* vp = v + ((size_t)b * KVH + kvh) * S_kv * D;
  for (int i = tid; i < kQT * D; i += kThreads)
    sQ[(i / D) * kQS + i % D] = qp[i];

  float acc[kRows][kNJ];
  float m[kRows], l[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < kNJ; ++j) acc[i][j] = 0.f;
  }

  const int q_last = q0 + kQT - 1;
  const int cnt = min(max(counts[qb], 0), max_active);
  const int32_t* list = kv_idx + (size_t)qb * max_active;
  for (int slot = 0; slot < cnt; ++slot) {
    const int kvb = list[slot];
    if (kvb < 0 || kvb >= n_kvb) continue;
    for (int k0 = kvb * block_kv; k0 < (kvb + 1) * block_kv; k0 += kKT) {
      if (causal && k0 > q_last) break;  // this and later sub-tiles masked
      __syncthreads();                   // the previous sub-tile is consumed
      for (int i = tid; i < kKT * D; i += kThreads) {
        const int c = i / D, d = i % D;
        sKT[d * kKS + c] = kp[(size_t)(k0 + c) * D + d];
        sV[i] = vp[(size_t)k0 * D + i];
      }
      __syncthreads();

      // scores: rows ty * 4 + i, keys tx + 16 * jj
      float s[kRows][kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int jj = 0; jj < kCols; ++jj) s[i][jj] = 0.f;
#pragma unroll 4
      for (int d = 0; d < D; d += 4) {
        float kk[4][kCols];
#pragma unroll
        for (int e = 0; e < 4; ++e)
#pragma unroll
          for (int jj = 0; jj < kCols; ++jj)
            kk[e][jj] = sKT[(d + e) * kKS + tx + 16 * jj];
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          const float4 qv =
              *reinterpret_cast<const float4*>(sQ + (ty * kRows + i) * kQS + d);
#pragma unroll
          for (int jj = 0; jj < kCols; ++jj) {
            s[i][jj] += qv.x * kk[0][jj];
            s[i][jj] += qv.y * kk[1][jj];
            s[i][jj] += qv.z * kk[2][jj];
            s[i][jj] += qv.w * kk[3][jj];
          }
        }
      }

      // online softmax over the live scores of each row
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int r = ty * kRows + i;
        const int row = q0 + r;
        bool live[kCols];
        float t_max = kNegInf;
#pragma unroll
        for (int jj = 0; jj < kCols; ++jj) {
          float x = s[i][jj] * scale;
          if (softcap > 0.f) x = softcap * tanhf(x / softcap);
          live[jj] = !causal || k0 + tx + 16 * jj <= row;
          s[i][jj] = x;
          if (live[jj]) t_max = fmaxf(t_max, x);
        }
        const float m_new = fmaxf(m[i], row_max(t_max));
        float sum = 0.f;
#pragma unroll
        for (int jj = 0; jj < kCols; ++jj) {
          const float p = live[jj] ? expf(s[i][jj] - m_new) : 0.f;
          sP[r * kKS + tx + 16 * jj] = p;
          sum += p;
        }
        const float alpha = expf(m[i] - m_new);
        l[i] = l[i] * alpha + row_sum(sum);
        m[i] = m_new;
#pragma unroll
        for (int j = 0; j < kNJ; ++j) acc[i][j] *= alpha;
      }
      __syncwarp();                      // a row's P stays in its warp

      // acc += P @ V: rows ty * 4 + i, columns tx + 16 * j
#pragma unroll 4
      for (int c = 0; c < kKT; ++c) {
        float p[kRows];
#pragma unroll
        for (int i = 0; i < kRows; ++i) p[i] = sP[(ty * kRows + i) * kKS + c];
#pragma unroll
        for (int j = 0; j < kNJ; ++j) {
          const float vv = sV[c * D + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < kRows; ++i) acc[i][j] += p[i] * vv;
        }
      }
    }
  }

  float* op = out + ((size_t)bh * S + q0) * D;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
    const int r = ty * kRows + i;
#pragma unroll
    for (int j = 0; j < kNJ; ++j)
      op[(size_t)r * D + tx + 16 * j] = acc[i][j] * inv;
  }
}


// =============================================================================
// bf16: tensor cores
// =============================================================================

// bf16 elements per shared-memory row: D plus 16 bytes of padding
template <int D>
__host__ __device__ constexpr int mma_ld() {
  return D + 8;
}
template <int D, int kHeads>
constexpr size_t mma_smem_bytes() {
  return sizeof(__nv_bfloat16) * (size_t)mma_ld<D>() *
         (kHeads * kQT + 2 * kStages * kKT);
}

template <int D, int kHeads>
__global__ void __launch_bounds__(128 * kHeads, 1)
sparse_flash_mma_kernel(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v,
                        const int32_t* __restrict__ kv_idx,
                        const int32_t* __restrict__ counts,
                        __nv_bfloat16* __restrict__ out, int H, int KVH, int S,
                        int S_kv, int max_active, int block_q, int block_kv,
                        int causal, float scale, float softcap) {
  constexpr int kThr = 128 * kHeads;
  constexpr int kLd = mma_ld<D>();
  constexpr int kNT = D / 8;             // 8-column tiles of O
  constexpr int kVec = D / 8;            // 16-byte vectors of a row
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem);  // [kHeads * kQT][kLd]
  __nv_bfloat16* sK = sQ + kHeads * kQT * kLd;  // [kStages][kKT][kLd]
  __nv_bfloat16* sV = sK + kStages * kKT * kLd;  // [kStages][kKT][kLd]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int G = H / KVH;
  const int n_grp = G / kHeads;          // blocks per (batch, KV head, q-tile)
  const int b = blockIdx.y / (KVH * n_grp);
  const int kvh = blockIdx.y / n_grp % KVH;
  const int h0 = kvh * G + blockIdx.y % n_grp * kHeads;
  const int q0 = blockIdx.x * kQT;
  const int qb = q0 / block_q;
  const int n_kvb = S_kv / block_kv;
  const int q_last = q0 + kQT - 1;
  const __nv_bfloat16* kp = k + ((size_t)b * KVH + kvh) * S_kv * D;
  const __nv_bfloat16* vp = v + ((size_t)b * KVH + kvh) * S_kv * D;

  // the q-tile of each of the block's heads (committed with the first tile)
  for (int i = tid; i < kHeads * kQT * kVec; i += kThr) {
    const int r = i / kVec, c = i % kVec;
    cp_async16(sQ + r * kLd + c * 8,
               q + (((size_t)b * H + h0 + r / kQT) * S + q0 + r % kQT) * D +
                   c * 8);
  }

  // the sub-tiles of the listed blocks in list order, up to the q-tile's last
  // row when causal; `slot` reaches cnt when none is left
  const int cnt = min(max(counts[qb], 0), max_active);
  const int32_t* list = kv_idx + (size_t)qb * max_active;
  struct Walk {
    int slot, k0, end;
  };
  auto next = [&](Walk& w) {
    w.k0 += kKT;
    while (w.k0 >= w.end) {
      if (++w.slot >= cnt) return;
      const int kvb = list[w.slot];
      if (kvb < 0 || kvb >= n_kvb) {
        w.k0 = w.end = 0;
        continue;
      }
      w.k0 = kvb * block_kv;
      w.end = (kvb + 1) * block_kv;
      if (causal) w.end = min(w.end, (q_last / kKT + 1) * kKT);
    }
  };
  auto load = [&](int k0, int st) {
    __nv_bfloat16* dk = sK + st * kKT * kLd;
    __nv_bfloat16* dv = sV + st * kKT * kLd;
    for (int i = tid; i < kKT * kVec; i += kThr) {
      const int r = i / kVec, c = i % kVec;
      cp_async16(dk + r * kLd + c * 8, kp + (size_t)(k0 + r) * D + c * 8);
      cp_async16(dv + r * kLd + c * 8, vp + (size_t)(k0 + r) * D + c * 8);
    }
  };

  Walk ld{-1, 0, 0}, cur{-1, 0, 0};
  next(ld);
  next(cur);
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (ld.slot < cnt) {
      load(ld.k0, st);
      next(ld);
    }
    cp_async_commit();
  }

  // this warp: 16 rows of head h0 + hh; this thread: rows row_a, row_b
  // (lane / 4 and lane / 4 + 8), columns 2 (lane % 4) + {0, 1} of each
  // 8-column tile
  const int hh = warp / 4, wr0 = warp % 4 * 16;
  __nv_bfloat16* wq = sQ + (hh * kQT + wr0) * kLd;
  const int row_a = q0 + wr0 + (lane >> 2), row_b = row_a + 8;
  float o[kNT][4];
#pragma unroll
  for (int n = 0; n < kNT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m_a = kNegInf, m_b = kNegInf, l_a = 0.f, l_b = 0.f;
  // the score: softcap * tanh(s * scale / softcap), or s * scale
  const float cap_arg = softcap > 0.f ? scale / softcap : 0.f;

  for (int it = 0; cur.slot < cnt; ++it) {
    cp_async_wait<kStages - 2>();        // sub-tile `it` (and Q) landed
    __syncthreads();                     // ... for every thread; `it - 1` done
    if (ld.slot < cnt) {
      load(ld.k0, (it + kStages - 1) % kStages);
      next(ld);
    }
    cp_async_commit();
    const int k0 = cur.k0;
    next(cur);
    if (causal && k0 > q0 + wr0 + 15) continue;  // after all of this warp's rows
    const __nv_bfloat16* tk = sK + it % kStages * kKT * kLd;
    const __nv_bfloat16* tv = sV + it % kStages * kKT * kLd;

    // S = Q K^T: 16 rows x 32 keys as four 8-key tiles
    float sc[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      unsigned a[4];
      ldsm_x4(a, wq + ((lane & 7) + (lane >> 3 & 1) * 8) * kLd + ks * 16 +
                     (lane >> 4) * 8);
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        unsigned bk[4];
        ldsm_x4(bk, tk + (np * 16 + (lane & 7) + (lane >> 4) * 8) * kLd +
                        ks * 16 + (lane >> 3 & 1) * 8);
        mma_bf16(sc[2 * np], a, bk[0], bk[1]);
        mma_bf16(sc[2 * np + 1], a, bk[2], bk[3]);
      }
    }

    // scale, softcap, the causal mask where the sub-tile crosses the
    // warp's diagonal, and the running max of each row
    const bool diag = causal && k0 + kKT - 1 > q0 + wr0;
    float mx_a = kNegInf, mx_b = kNegInf;
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = softcap > 0.f ? softcap * tanhf(sc[j][e] * cap_arg)
                                : sc[j][e] * scale;
        const int key = k0 + 8 * j + 2 * (lane & 3) + (e & 1);
        if (diag && key > (e < 2 ? row_a : row_b)) x = kNegInf;
        sc[j][e] = x;
        if (e < 2) {
          mx_a = fmaxf(mx_a, x);
        } else {
          mx_b = fmaxf(mx_b, x);
        }
      }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      mx_a = fmaxf(mx_a, __shfl_xor_sync(~0u, mx_a, off));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(~0u, mx_b, off));
    }
    const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
    const float al_a = exp2f((m_a - mn_a) * kLog2e);
    const float al_b = exp2f((m_b - mn_b) * kLog2e);
    const float ml_a = mn_a * kLog2e, ml_b = mn_b * kLog2e;
    m_a = mn_a;
    m_b = mn_b;

    // P = exp(s - m) as the A operand of P V (keys 16 kk .. 16 kk + 15),
    // split into bf16 hi and lo parts; a masked score gives p = 0 exactly
    unsigned ph[2][4], pl[2][4];
    float rs_a = 0.f, rs_b = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        p[e] = sc[j][e] == kNegInf
                   ? 0.f
                   : exp2f(fmaf(sc[j][e], kLog2e, -(e < 2 ? ml_a : ml_b)));
      rs_a += p[0] + p[1];
      rs_b += p[2] + p[3];
      const __nv_bfloat162 h01 = __floats2bfloat162_rn(p[0], p[1]);
      const __nv_bfloat162 h23 = __floats2bfloat162_rn(p[2], p[3]);
      const float2 f01 = __bfloat1622float2(h01);
      const float2 f23 = __bfloat1622float2(h23);
      ph[j / 2][j % 2 * 2] = as_u32(h01);
      ph[j / 2][j % 2 * 2 + 1] = as_u32(h23);
      pl[j / 2][j % 2 * 2] =
          as_u32(__floats2bfloat162_rn(p[0] - f01.x, p[1] - f01.y));
      pl[j / 2][j % 2 * 2 + 1] =
          as_u32(__floats2bfloat162_rn(p[2] - f23.x, p[3] - f23.y));
    }
    l_a = l_a * al_a + rs_a;             // this thread's part of the row sum
    l_b = l_b * al_b + rs_b;
#pragma unroll
    for (int n = 0; n < kNT; ++n) {
      o[n][0] *= al_a;
      o[n][1] *= al_a;
      o[n][2] *= al_b;
      o[n][3] *= al_b;
    }

    // O += P_hi V + P_lo V, 16 columns of V per ldmatrix
#pragma unroll
    for (int kk = 0; kk < 2; ++kk)
#pragma unroll
      for (int dp = 0; dp < kNT / 2; ++dp) {
        unsigned bv[4];
        ldsm_x4_t(bv, tv + (kk * 16 + (lane & 7) + (lane >> 3 & 1) * 8) * kLd +
                          dp * 16 + (lane >> 4) * 8);
        mma_bf16(o[2 * dp], ph[kk], bv[0], bv[1]);
        mma_bf16(o[2 * dp + 1], ph[kk], bv[2], bv[3]);
        mma_bf16(o[2 * dp], pl[kk], bv[0], bv[1]);
        mma_bf16(o[2 * dp + 1], pl[kk], bv[2], bv[3]);
      }
  }

  // out = O / l, staged through this warp's own rows of sQ for 16-byte
  // stores (every thread's copies, Q's included, are done first)
  cp_async_wait<0>();
  __syncthreads();
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l_a += __shfl_xor_sync(~0u, l_a, off);
    l_b += __shfl_xor_sync(~0u, l_b, off);
  }
  const float inv_a = 1.f / fmaxf(l_a, 1e-30f);
  const float inv_b = 1.f / fmaxf(l_b, 1e-30f);
#pragma unroll
  for (int n = 0; n < kNT; ++n) {
    const int col = 8 * n + 2 * (lane & 3);
    *reinterpret_cast<__nv_bfloat162*>(wq + (lane >> 2) * kLd + col) =
        __floats2bfloat162_rn(o[n][0] * inv_a, o[n][1] * inv_a);
    *reinterpret_cast<__nv_bfloat162*>(wq + ((lane >> 2) + 8) * kLd + col) =
        __floats2bfloat162_rn(o[n][2] * inv_b, o[n][3] * inv_b);
  }
  __syncwarp();
  __nv_bfloat16* op = out + (((size_t)b * H + h0 + hh) * S + q0 + wr0) * D;
  for (int i = lane; i < 16 * kVec; i += 32) {
    const int r = i / kVec, c = i % kVec;
    *reinterpret_cast<uint4*>(op + (size_t)r * D + c * 8) =
        *reinterpret_cast<const uint4*>(wq + r * kLd + c * 8);
  }
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, const void* kv_idx,
               const void* counts, void* out, int B, int H, int KVH, int S,
               int S_kv, int max_active, int block_q, int block_kv,
               int causal, float scale, float softcap, cudaStream_t stream) {
  constexpr size_t smem = f32_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      sparse_flash_f32_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (B * H == 0 || S == 0) return 0;
  const dim3 grid(S / kQT, B * H);
  sparse_flash_f32_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const int32_t*>(kv_idx),
      static_cast<const int32_t*>(counts), static_cast<float*>(out), H, KVH,
      S, S_kv, max_active, block_q, block_kv, causal, scale, softcap);
  return (int)cudaGetLastError();
}

template <int D, int kHeads>
int launch_mma(const void* q, const void* k, const void* v, const void* kv_idx,
               const void* counts, void* out, int B, int H, int KVH, int S,
               int S_kv, int max_active, int block_q, int block_kv,
               int causal, float scale, float softcap, cudaStream_t stream) {
  constexpr size_t smem = mma_smem_bytes<D, kHeads>();
  cudaError_t err = cudaFuncSetAttribute(
      sparse_flash_mma_kernel<D, kHeads>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (B * H == 0 || S == 0) return 0;
  const dim3 grid(S / kQT, B * H / kHeads);
  sparse_flash_mma_kernel<D, kHeads><<<grid, 128 * kHeads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<const int32_t*>(kv_idx),
      static_cast<const int32_t*>(counts), static_cast<__nv_bfloat16*>(out),
      H, KVH, S, S_kv, max_active, block_q, block_kv, causal, scale, softcap);
  return (int)cudaGetLastError();
}

template <int D>
int launch_d(int dtype, const void* q, const void* k, const void* v,
             const void* kv_idx, const void* counts, void* out, int B, int H,
             int KVH, int S, int S_kv, int max_active, int block_q,
             int block_kv, int causal, float scale, float softcap,
             cudaStream_t s) {
  if (dtype == 0)
    return launch_f32<D>(q, k, v, kv_idx, counts, out, B, H, KVH, S, S_kv,
                         max_active, block_q, block_kv, causal, scale,
                         softcap, s);
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  if ((H / KVH) % 2 == 0)                // a GQA pair of heads per block
    return launch_mma<D, 2>(q, k, v, kv_idx, counts, out, B, H, KVH, S,
                            S_kv, max_active, block_q, block_kv, causal,
                            scale, softcap, s);
  return launch_mma<D, 1>(q, k, v, kv_idx, counts, out, B, H, KVH, S, S_kv,
                          max_active, block_q, block_kv, causal, scale,
                          softcap, s);
}

}  // namespace

// q [B, H, S, D], k / v [B, KVH, S_kv, D] contiguous, of one dtype (0 =
// float32, 1 = bfloat16); kv_idx int32[S / block_q, max_active], counts
// int32[S / block_q]; out like q. D in {16, 32, 64, 80, 128, 256}; block_q a
// multiple of 64, block_kv of 32; H a multiple of KVH. softcap <= 0 means
// no softcap. Returns a cudaError_t code.
extern "C" int sparse_attn_sparse_flash(
    const void* q, const void* k, const void* v, const void* kv_idx,
    const void* counts, void* out, int B, int H, int KVH, int S, int S_kv,
    int D, int max_active, int block_q, int block_kv, int causal,
    float scale, float softcap, int dtype, void* stream) {
  if (KVH < 1 || H % KVH != 0 || block_q < kQT || block_q % kQT != 0 ||
      block_kv < kKT || block_kv % kKT != 0 || S % block_q != 0 ||
      S_kv % block_kv != 0 || max_active < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
#define SPARSE_FLASH_CASE(DD)                                                \
  case DD:                                                                   \
    return launch_d<DD>(dtype, q, k, v, kv_idx, counts, out, B, H, KVH, S,  \
                        S_kv, max_active, block_q, block_kv, causal, scale,  \
                        softcap, s);
    SPARSE_FLASH_CASE(16)
    SPARSE_FLASH_CASE(32)
    SPARSE_FLASH_CASE(64)
    SPARSE_FLASH_CASE(80)
    SPARSE_FLASH_CASE(128)
    SPARSE_FLASH_CASE(256)
#undef SPARSE_FLASH_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}
