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
// not from the list slot), and run an online softmax with m / l / acc in
// f32; the output is acc / max(l, 1e-30) in q's dtype. Entries of kv_idx at
// or after counts[qb] are never read (compile_mask pads them with block 0),
// and an id outside [0, S_kv / block_kv) is skipped. A row with no live
// score gives zeros, as the oracle does. (The Pallas kernel gives the mean of
// V over the visited blocks there: its masked scores stay at -1e30 = m, so
// exp(s - m) = 1. The model's masks always list a row's own block, so the
// training path never meets such a row; ROADMAP queue 3.)
//
// What bounds it on an H100: operations. Each live (query, key) pair costs
// 4 * D flops (QK and PV) against ~4 * D bytes of q / k / v per *row*, so at
// gemma2's shapes (D = 256, ~150 live keys per query row on average) the
// arithmetic is ~40 GFLOP per launch against ~50 MB: the floor is the
// flops over the bf16 tensor-core peak.
//
// What this first design does (simple and right; it does not reach that
// floor, because it computes on the CUDA cores in f32, not the tensor cores):
//   * a block owns kQT = 64 query rows of one (batch, head) and walks the
//     listed KV blocks in sub-tiles of kKT = 32 keys, so the f32 state of a
//     q-block row never has to fit one block: acc lives in registers (4 rows
//     x D / 16 columns per thread), m and l in registers of the 16 threads
//     that share a row;
//   * q is widened to f32 in shared memory once; each K sub-tile is widened
//     into shared memory transposed ([D][kKT + 1], so the 16 threads of a row
//     read 16 consecutive keys and the transposing stores hit distinct
//     banks), each V sub-tile row-major;
//   * a thread scores 4 rows x 2 keys; the row max and sum are 16-lane
//     shuffles; P goes through shared memory to the same warp's threads for
//     P.V, so only a warp barrier separates them;
//   * causal: a listed block, or a sub-tile, wholly after the block's last
//     query row is skipped without loading it (its scores would all be
//     masked and contribute nothing).
// Tensor-core products (mma / wgmma), TMA, double-buffered sub-tiles and
// sharing K / V tiles between the G query heads of a KV head are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kQT = 64;                  // query rows per block
constexpr int kKT = 32;                  // keys per sub-tile
constexpr int kRows = 4;                 // query rows per thread
constexpr int kCols = 2;                 // keys per thread in the scores
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void narrow(float v, float* o) { *o = v; }
__device__ __forceinline__ void narrow(float v, __nv_bfloat16* o) {
  *o = __float2bfloat16(v);
}

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

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * ((size_t)kQT * (D + 4)       // q, f32
                          + (size_t)D * (kKT + 1)     // K sub-tile, transposed
                          + (size_t)kKT * D           // V sub-tile
                          + (size_t)kQT * (kKT + 1)); // P
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
sparse_flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v,
                    const int32_t* __restrict__ kv_idx,
                    const int32_t* __restrict__ counts, T* __restrict__ out,
                    int H, int KVH, int S, int S_kv, int max_active,
                    int block_q, int block_kv, int causal, float scale,
                    float softcap) {
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

  const T* qp = q + ((size_t)bh * S + q0) * D;
  const T* kp = k + ((size_t)b * KVH + kvh) * S_kv * D;
  const T* vp = v + ((size_t)b * KVH + kvh) * S_kv * D;
  for (int i = tid; i < kQT * D; i += kThreads)
    sQ[(i / D) * kQS + i % D] = widen(qp[i]);

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
        sKT[d * kKS + c] = widen(kp[(size_t)(k0 + c) * D + d]);
        sV[i] = widen(vp[(size_t)k0 * D + i]);
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

  T* op = out + ((size_t)bh * S + q0) * D;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
    const int r = ty * kRows + i;
#pragma unroll
    for (int j = 0; j < kNJ; ++j)
      narrow(acc[i][j] * inv, op + (size_t)r * D + tx + 16 * j);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* kv_idx,
           const void* counts, void* out, int B, int H, int KVH, int S,
           int S_kv, int max_active, int block_q, int block_kv, int causal,
           float scale, float softcap, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      sparse_flash_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (B * H == 0 || S == 0) return 0;
  const dim3 grid(S / kQT, B * H);
  sparse_flash_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int32_t*>(kv_idx),
      static_cast<const int32_t*>(counts), static_cast<T*>(out), H, KVH, S,
      S_kv, max_active, block_q, block_kv, causal, scale, softcap);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(const void* q, const void* k, const void* v, const void* kv_idx,
             const void* counts, void* out, int B, int H, int KVH, int S,
             int S_kv, int D, int max_active, int block_q, int block_kv,
             int causal, float scale, float softcap, cudaStream_t s) {
#define SPARSE_FLASH_CASE(DD)                                                \
  case DD:                                                                   \
    return launch<T, DD>(q, k, v, kv_idx, counts, out, B, H, KVH, S, S_kv,  \
                         max_active, block_q, block_kv, causal, scale,       \
                         softcap, s);
  switch (D) {
    SPARSE_FLASH_CASE(16)
    SPARSE_FLASH_CASE(32)
    SPARSE_FLASH_CASE(64)
    SPARSE_FLASH_CASE(128)
    SPARSE_FLASH_CASE(256)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef SPARSE_FLASH_CASE
}

}  // namespace

// q [B, H, S, D], k / v [B, KVH, S_kv, D] contiguous, of one dtype (0 =
// float32, 1 = bfloat16); kv_idx int32[S / block_q, max_active], counts
// int32[S / block_q]; out like q. D in {16, 32, 64, 128, 256}; block_q a
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
  if (dtype == 1)
    return launch_d<__nv_bfloat16>(q, k, v, kv_idx, counts, out, B, H, KVH,
                                   S, S_kv, D, max_active, block_q, block_kv,
                                   causal, scale, softcap, s);
  if (dtype == 0)
    return launch_d<float>(q, k, v, kv_idx, counts, out, B, H, KVH, S, S_kv,
                           D, max_active, block_q, block_kv, causal, scale,
                           softcap, s);
  return (int)cudaErrorInvalidValue;
}
