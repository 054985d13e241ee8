// Fused Boolean-tree evaluation: one thread block per container column
// replays a whole and/or/andnot tape over scratch slots.
//
// Replaces the Pallas kernel `fused_eval_pallas` of
// src/repro/kernels/roaring/fused.py (body `_fused_kernel`, leaf lifts
// from dispatch.make_lift_kernels).
//
// What bounds it on an H100: memory. Each live column reads every operand's
// row once (2*card bytes for an array, 8 kB for a bitmap, 4*n_runs for a
// run) and writes one 8 kB root row and its card; the word ops in between
// are a few integer operations per byte and never leave the SM.
//
// What the design does about it:
//   * intermediates stay on chip: slots live in dynamic shared memory
//     (n_slots x 8 kB, opted in above 48 kB), so only leaves are read and
//     only the root is written;
//   * the tape is runtime data (i32 rows of (opcode, a, b, dst)), so one
//     compiled kernel serves every tree shape — nothing is compiled per
//     query;
//   * a column whose operands are all empty (live flag 0) writes zeros and
//     exits without reading any operand;
//   * lifts are by kind: a bitmap row is copied, an array row zeroes its
//     slot and sets its `card` bits with shared-memory atomics, a run row
//     stages its pairs and computes each coverage word by one binary search
//     (run_cov_word) — never the Pallas 16-pass bit search;
//   * a plan whose slots do not fit in shared memory keeps them in a global
//     scratch buffer the caller allocates (`gscratch`, C x n_slots x 8 kB):
//     slower, but no plan is refused.

#include "roaring_common.cuh"

using namespace roaring;

namespace {

// tape opcodes (fused.TAPE_OPCODES); 3 is and-not
constexpr int kOpLoad = 0, kOpAnd = 1, kOpOr = 2;
constexpr int kLiftMetaFields = 3;    // (kind, card, n_runs)
constexpr int kRunStageBytes = kRowWords * 2;

__global__ void __launch_bounds__(kThreads)
fused_eval_kernel(const uint16_t* __restrict__ ops,
                  const int32_t* __restrict__ meta,
                  const int32_t* __restrict__ tape, int n_steps, int N, int C,
                  int n_slots, uint32_t* __restrict__ bits_out,
                  int32_t* __restrict__ card_out, uint32_t* gscratch) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int col = blockIdx.x;
  uint32_t* out = bits_out + (size_t)col * kRowU32;
  if (meta[(size_t)kLiftMetaFields * N * C + col] == 0) {   // dead column
    uint4* o4 = reinterpret_cast<uint4*>(out);
    for (int i = threadIdx.x; i < kRowU32 / 4; i += kThreads)
      o4[i] = make_uint4(0, 0, 0, 0);
    if (threadIdx.x == 0) card_out[col] = 0;
    return;
  }
  uint16_t* runs = reinterpret_cast<uint16_t*>(smem);
  uint32_t* slots =
      gscratch ? gscratch + (size_t)col * n_slots * kRowU32
               : reinterpret_cast<uint32_t*>(smem + kRunStageBytes);

  for (int t = 0; t < n_steps; ++t) {
    const int op = tape[4 * t], sa = tape[4 * t + 1], sb = tape[4 * t + 2];
    uint32_t* dst = slots + (size_t)tape[4 * t + 3] * kRowU32;
    if (op == kOpLoad) {
      const size_t cell = (size_t)sa * C + col;
      const int32_t* f = meta + kLiftMetaFields * cell;
      const int kind = f[0];
      const uint16_t* row = ops + cell * kRowWords;
      if (kind == KIND_BITMAP) {
        const uint4* r4 = reinterpret_cast<const uint4*>(row);
        uint4* d4 = reinterpret_cast<uint4*>(dst);
        for (int i = threadIdx.x; i < kRowU32 / 4; i += kThreads)
          d4[i] = __ldg(r4 + i);
      } else if (kind == KIND_RUN) {
        const int nr = clamp_int(f[2], 0, kMaxRuns);
        stage_u16(runs, row, 2 * nr);
        __syncthreads();
        for (int w = threadIdx.x; w < kRowU32; w += kThreads)
          dst[w] = run_cov_word(runs, nr, w);
      } else {
        for (int w = threadIdx.x; w < kRowU32; w += kThreads) dst[w] = 0;
        if (kind == KIND_ARRAY) {
          const int card = clamp_int(f[1], 0, kRowWords);
          __syncthreads();
          for (int s = threadIdx.x; s < card; s += kThreads) {
            const int v = row[s];
            atomicOr(dst + (v >> 5), 1u << (v & 31));
          }
        }
      }
    } else {
      const uint32_t* A = slots + (size_t)sa * kRowU32;
      const uint32_t* B = slots + (size_t)sb * kRowU32;
      for (int w = threadIdx.x; w < kRowU32; w += kThreads) {
        const uint32_t x = A[w], y = B[w];
        dst[w] = op == kOpAnd ? (x & y) : op == kOpOr ? (x | y) : (x & ~y);
      }
    }
    __syncthreads();
  }

  int count = 0;
  for (int w = threadIdx.x; w < kRowU32; w += kThreads) {
    const uint32_t r = slots[w];     // the root is slot 0
    out[w] = r;
    count += __popc(r);
  }
  const int total = block_sum(count);
  if (threadIdx.x == 0) card_out[col] = total;
}

}  // namespace

// Most scratch slots one block can hold in shared memory on this device
// (beside the 8 kB run staging row and the reduction's static scratch).
extern "C" int roaring_fused_max_smem_slots() {
  int dev = 0, optin = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return 0;
  cudaFuncAttributes attr;
  if (cudaFuncGetAttributes(&attr, fused_eval_kernel) != cudaSuccess) return 0;
  const long long avail = (long long)optin - (long long)attr.sharedSizeBytes
                          - kRunStageBytes;
  return avail > 0 ? (int)(avail / (kRowU32 * 4)) : 0;
}

// Evaluate the tape for C columns. ops: u16[N, C, 4096]; meta: the
// pack_lift_meta block i32[3*N*C + C]; tape: i32[n_steps, 4]; bits_out:
// u16[C, 4096]; card_out: i32[C]. gscratch null keeps slots in shared
// memory; else it holds C * n_slots * 2048 u32. Returns the cudaError_t.
extern "C" int roaring_fused_eval(const void* ops, const void* meta,
                                  const void* tape, int n_steps, int N, int C,
                                  int n_slots, void* bits_out, void* card_out,
                                  void* gscratch, void* stream) {
  const size_t smem =
      kRunStageBytes + (gscratch ? 0 : (size_t)n_slots * kRowU32 * 4);
  cudaError_t err = cudaFuncSetAttribute(
      fused_eval_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (C > 0) {
    fused_eval_kernel<<<C, kThreads, smem, (cudaStream_t)stream>>>(
        static_cast<const uint16_t*>(ops), static_cast<const int32_t*>(meta),
        static_cast<const int32_t*>(tape), n_steps, N, C, n_slots,
        static_cast<uint32_t*>(bits_out), static_cast<int32_t*>(card_out),
        static_cast<uint32_t*>(gscratch));
  }
  return (int)cudaGetLastError();
}
