// Fused Boolean-tree evaluation: each container column lifts every distinct
// operand row once into shared memory, then each thread replays the whole
// and/or/andnot program over its own words with no barrier between steps.
//
// Replaces the Pallas kernel `fused_eval_pallas` of
// src/repro/kernels/roaring/fused.py (body `_fused_kernel`, leaf lifts
// from dispatch.make_lift_kernels).
//
// What bounds it on an H100: memory. Each live column reads every distinct
// operand's row once (2*card bytes for an array, 8 kB for a bitmap,
// 4*n_runs for a run) and writes one 8 kB root row and its card; the word
// ops in between are a few integer operations per byte and never leave the
// SM. In practice the SM's instruction issue and its shared memory are as
// near: a column holds (operands + stack) x 8 kB of shared memory, so an
// SM keeps under two columns of a store query in flight, and each program
// step's decode and addressing is paid per 16-byte vector a thread
// (PERF.md, section 6).
//
// What the design does about it:
//   * the program is runtime data, derived on the host from the plan's tape
//     (fused.kernel_program, encoded by fused.encode_program for the launch
//     shape's row size): the distinct operands (`lifts`), and one int4 a
//     step (masks of the word op, byte offset of its operand row, byte
//     offset the top spills to). A leaf folded into the op that follows it
//     is one step. One compiled kernel serves every tree; nothing is
//     compiled per query;
//   * phase 0: the live flag, every operand's tags and the program's first
//     steps are loaded together, the tags staged once in shared memory. A
//     column whose operands are all empty writes zeros and exits without
//     reading an operand;
//   * phase 1, lift: every bitmap row's copy and every array's and run
//     list's packed values (staged in the stack's rows) are issued at once
//     as 16-byte `cp.async`, with one wait, so a block has all its operand
//     bytes in flight together; array and empty rows are zeroed meanwhile.
//     After one barrier, runs become coverage words (run_cov_word) and
//     arrays scatter their values with shared-memory atomics. Every live
//     operand row is read, with no data-dependent short-circuit;
//   * phase 2, replay: a thread keeps the top of the evaluation stack in
//     registers for its V 16-byte vectors of the row; the rest of the stack
//     lives in shared memory laid out as rows, [slot][vector] with vector =
//     g * T + thread: private to the thread, free of bank conflicts, never
//     spilled to local memory. No step waits on another thread, and each
//     step's operand is loaded one step ahead;
//   * phase 3, root: 16-byte stores and the block sum for the card;
//   * a block owns all of its column's row (split 1), or, when two whole-
//     row blocks do not fit an SM, half of it (split 2): the halves form a
//     thread-block cluster and hand their popcounts to the first through
//     distributed shared memory. Both halves read an array or run operand
//     whole (the second read comes from L2);
//   * a plan whose rows do not fit shared memory even at split 2 keeps its
//     tags, lifted rows and stack in a global scratch buffer the caller
//     allocates (`gscratch`, C x ((lifts + stack) x 8 kB + 16 x lifts)):
//     slower, but no plan is refused and none runs elsewhere.
// Blocks are 256 threads. The launch shape (split 1 or 2, shared or global
// rows) comes from the plan's shape alone: kernel.fused_launch_shape.

#include <cooperative_groups.h>

#include "roaring_common.cuh"

namespace cg = cooperative_groups;
using namespace roaring;

namespace {

constexpr int kLiftMetaFields = 3;    // (kind, card, n_runs)
constexpr int kRowVec = kRowU32 / 4;  // 16-byte vectors per row
constexpr int kMaxSplit = 2;

__device__ __forceinline__ void cp_async16(uint4* smem_dst,
                                           const uint4* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem_dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// One program step on the thread's vectors, then the next step's operand
// moves in. MASKS (fused.encode_program) are the bits (c1, c2, c3) of top
// = (top & c1) ^ (y & c2) ^ (top & y & c3): 2 load, 4 and, 7 or, 5 top
// and-not y, 6 y and-not top.
template <int MASKS>
__device__ __forceinline__ uint32_t step_word(uint32_t t, uint32_t w) {
  return MASKS == 2 ? w : MASKS == 4 ? (t & w) : MASKS == 7 ? (t | w)
       : MASKS == 5 ? (t & ~w) : (w & ~t);
}

template <int MASKS, int V>
__device__ __forceinline__ void step(uint4 (&top)[V], uint4 (&y)[V],
                                     const uint4 (&ny)[V]) {
#pragma unroll
  for (int g = 0; g < V; ++g) {
    top[g] = make_uint4(step_word<MASKS>(top[g].x, y[g].x),
                        step_word<MASKS>(top[g].y, y[g].y),
                        step_word<MASKS>(top[g].z, y[g].z),
                        step_word<MASKS>(top[g].w, y[g].w));
    y[g] = ny[g];
  }
}

// A lifted operand's tags, staged once per block: (kind, card, n_runs,
// operand index), card and n_runs clamped to a row.
__device__ __forceinline__ int packed_vectors(int4 f) {
  return f.x == KIND_ARRAY ? (f.y + 7) / 8
                           : f.x == KIND_RUN ? (f.z + 3) / 4 : 0;
}

// T threads, V vectors a thread: the block owns kRowVec / (T * V) of its
// column's row (kSplit parts, one cluster a column). kSmem: the tags,
// lifted rows and stack in dynamic shared memory, else in gscratch.
template <int T, int V, bool kSmem>
__global__ void __launch_bounds__(T)
fused_eval_kernel(const uint4* __restrict__ ops,
                  const int32_t* __restrict__ meta,
                  const int4* __restrict__ prog, int n_prog,
                  const int32_t* __restrict__ lifts, int n_lifts, int N,
                  int C, int n_stack, uint4* __restrict__ bits_out,
                  int32_t* __restrict__ card_out, uint4* gscratch) {
  constexpr int kSplit = kRowVec / (T * V);
  constexpr int kPart = kRowVec / kSplit;   // vectors of a row per block
  constexpr int kPartWords = 4 * kPart;     // u32 words of a row per block
  static_assert(kSplit >= 1 && kSplit <= kMaxSplit && kPart == T * V,
                "a block owns a whole row or a half");
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int part_card[kMaxSplit];
  const int col = blockIdx.x / kSplit, part = blockIdx.x % kSplit;
  const int tid = threadIdx.x;
  if constexpr (kSplit > 1)     // phase one of the cluster barrier: started
    asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  uint4* out = bits_out + (size_t)col * kRowVec + part * kPart;
  uint4* base;
  if constexpr (kSmem)
    base = reinterpret_cast<uint4*>(smem);
  else
    base = gscratch + (size_t)col * ((n_lifts + n_stack) * kRowVec + n_lifts);
  int4* info = reinterpret_cast<int4*>(base);
  uint4* rows = base + n_lifts;
  uint4* stack = rows + (size_t)n_lifts * kPart;

  // phase 0: the live flag, every operand's tags and the program's first
  // steps, loaded together
  const int live = __ldg(meta + (size_t)kLiftMetaFields * N * C + col);
  int4 cur = __ldg(prog), nxt = __ldg(prog + 1);
  for (int d = tid; d < n_lifts; d += T) {
    const int n = __ldg(lifts + d);
    const int32_t* f = meta + (size_t)kLiftMetaFields * ((size_t)n * C + col);
    info[d] = make_int4(__ldg(f), clamp_int(__ldg(f + 1), 0, kRowWords),
                        clamp_int(__ldg(f + 2), 0, kMaxRuns), n);
  }
  if (live == 0) {                       // dead column: zeros, no operand read
    for (int i = tid; i < kPart; i += T) out[i] = make_uint4(0, 0, 0, 0);
    if (part == 0 && tid == 0) card_out[col] = 0;
    return;
  }
  __syncthreads();

  // phase 1: lift. Bitmap copies issued; array and empty rows zeroed
  for (int d = 0; d < n_lifts; ++d) {
    const int4 f = info[d];
    uint4* dst = rows + (size_t)d * kPart;
    if (f.x == KIND_BITMAP) {
      const uint4* src =
          ops + ((size_t)f.w * C + col) * kRowVec + part * kPart;
      for (int i = tid; i < kPart; i += T) {
        if constexpr (kSmem)
          cp_async16(dst + i, src + i);
        else
          dst[i] = __ldg(src + i);
      }
    } else if (f.x != KIND_RUN) {
      for (int i = tid; i < kPart; i += T) dst[i] = make_uint4(0, 0, 0, 0);
    }
  }
  // packed arrays and run lists staged in the stack's rows (at least 8 kB,
  // one row's values), as many at a time as fit: all of them in one round
  // unless they pass the stack's size. One wait covers the bitmaps too
  const int cap = n_stack * kPart;
  int d0 = 0;
  do {
    int off = 0, d1 = d0;
    for (; d1 < n_lifts; ++d1) {
      const int4 f = info[d1];
      const int nvec = packed_vectors(f);
      if (off + nvec > cap) break;
      const uint4* src = ops + ((size_t)f.w * C + col) * kRowVec;
      for (int i = tid; i < nvec; i += T) {
        if constexpr (kSmem)
          cp_async16(stack + off + i, src + i);
        else
          stack[off + i] = __ldg(src + i);
      }
      off += nvec;
    }
    if constexpr (kSmem) cp_async_wait_all();
    __syncthreads();
    off = 0;
    for (int d = d0; d < d1; ++d) {
      const int4 f = info[d];
      const int nvec = packed_vectors(f);
      if (nvec == 0) continue;
      const uint16_t* vals = reinterpret_cast<const uint16_t*>(stack + off);
      uint32_t* dst = reinterpret_cast<uint32_t*>(rows + (size_t)d * kPart);
      if (f.x == KIND_RUN) {
        for (int w = tid; w < kPartWords; w += T)
          dst[w] = run_cov_word(vals, f.z, part * kPartWords + w);
      } else {
        for (int i = tid; i < f.y; i += T) {
          const int word = (vals[i] >> 5) - part * kPartWords;
          if (kSplit == 1 || (unsigned)word < (unsigned)kPartWords)
            atomicOr(dst + word, 1u << (vals[i] & 31));
        }
      }
      off += nvec;
    }
    __syncthreads();
    d0 = d1;
  } while (d0 < n_lifts);

  // phase 2: replay the program over this thread's vectors, software
  // pipelined: a step's operand is loaded one step ahead, after the step
  // before it has spilled (the thread's own store, so the load sees it).
  // Offsets are bytes from `base`; the program has two steps of padding
  unsigned char* mine = reinterpret_cast<unsigned char*>(base) + 16 * tid;
  uint4 top[V], y[V];
#pragma unroll
  for (int g = 0; g < V; ++g) {
    top[g] = make_uint4(0, 0, 0, 0);
    y[g] = *reinterpret_cast<const uint4*>(mine + cur.y + 16 * T * g);
  }
  for (int i = 0; i < n_prog; ++i) {
    const int4 after = __ldg(prog + i + 2);
    if (cur.z >= 0) {
#pragma unroll
      for (int g = 0; g < V; ++g)
        *reinterpret_cast<uint4*>(mine + cur.z + 16 * T * g) = top[g];
    }
    uint4 ny[V];
#pragma unroll
    for (int g = 0; g < V; ++g)
      ny[g] = *reinterpret_cast<const uint4*>(mine + nxt.y + 16 * T * g);
    switch (cur.x) {
      case 2: step<2, V>(top, y, ny); break;
      case 4: step<4, V>(top, y, ny); break;
      case 7: step<7, V>(top, y, ny); break;
      case 5: step<5, V>(top, y, ny); break;
      default: step<6, V>(top, y, ny); break;
    }
    cur = nxt;
    nxt = after;
  }

  // phase 3: the root (the last top) with 16-byte stores, and its card
  int count = 0;
#pragma unroll
  for (int g = 0; g < V; ++g) {
    const uint4 r = top[g];
    out[g * T + tid] = r;
    count += __popc(r.x) + __popc(r.y) + __popc(r.z) + __popc(r.w);
  }
  const int total = block_sum<T>(count);
  if constexpr (kSplit == 1) {
    if (tid == 0) card_out[col] = total;
  } else {
    // every part, once all have started (phase one), hands its count to
    // part 0's shared memory; only part 0 waits for the others (phase
    // two), then writes the card
    cg::cluster_group cluster = cg::this_cluster();
    asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
    if (tid == 0) cluster.map_shared_rank(part_card, 0)[part] = total;
    asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
    if (part == 0) {
      asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
      if (tid == 0) {
        int sum = 0;
        for (int k = 0; k < kSplit; ++k) sum += part_card[k];
        card_out[col] = sum;
      }
    }
  }
}

// Dynamic shared memory of a block: the tags (16 bytes an operand), then
// the lifted rows and the stack, each row kRowVec / split vectors.
size_t fused_smem_bytes(int n_lifts, int n_stack, int split) {
  return ((size_t)n_lifts + (size_t)(n_lifts + n_stack) * (kRowVec / split))
         * 16;
}

struct Args {
  const uint4* ops;
  const int32_t* meta;
  const int4* prog;
  int n_prog;
  const int32_t* lifts;
  int n_lifts, N, C, n_stack;
  uint4* bits;
  int32_t* card;
  uint4* gscratch;
};

// Let `kernel` take `smem` bytes of dynamic shared memory, with the SM's
// split of L1 and shared memory at its most shared.
cudaError_t set_smem(const void* kernel, size_t smem) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              (int)cudaSharedmemCarveoutMaxShared);
}

template <int T, int V, bool kSmem>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  constexpr int kSplit = kRowVec / (T * V);
  const size_t smem = kSmem ? fused_smem_bytes(a.n_lifts, a.n_stack, kSplit)
                            : 0;
  auto kernel = fused_eval_kernel<T, V, kSmem>;
  cudaError_t err = set_smem((const void*)kernel, smem);
  if (err != cudaSuccess || a.C <= 0) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)a.C * kSplit);
  cfg.blockDim = dim3(T);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kSplit;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, a.ops, a.meta, a.prog, a.n_prog,
                            a.lifts, a.n_lifts, a.N, a.C, a.n_stack, a.bits,
                            a.card, a.gscratch);
}

// The kernels built with rows in shared memory: split 1 and split 2.
const void* const kSmemKernels[] = {
    (const void*)fused_eval_kernel<kThreads, 2, true>,
    (const void*)fused_eval_kernel<kThreads, 1, true>};

}  // namespace

// Shared memory a block of the kernel can use beside its static shared
// memory, and shared memory per SM, in bytes (0 on an error).
extern "C" int roaring_fused_smem(int* per_block, int* per_sm) {
  int dev = 0, optin = 0, sm = 0;
  *per_block = *per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor,
                             dev) != cudaSuccess)
    return 0;
  size_t fixed = 0;
  for (const void* kernel : kSmemKernels) {
    cudaFuncAttributes attr;
    if (cudaFuncGetAttributes(&attr, kernel) != cudaSuccess) return 0;
    fixed = attr.sharedSizeBytes > fixed ? attr.sharedSizeBytes : fixed;
  }
  *per_block = optin - (int)fixed;
  *per_sm = sm;
  return 1;
}

// Evaluate the program for C columns. ops: u16[N, C, 4096]; meta: the
// pack_lift_meta block i32[3*N*C + C]; prog: i32[n_prog + 2, 4] and
// lifts: i32[n_lifts] from fused.encode_program for this shape's rows;
// n_stack: stack rows (at least split); split 1 or 2 with the rows in
// shared memory (gscratch null), or split 1 with gscratch holding C *
// ((n_lifts + n_stack) * 2048 + 4 * n_lifts) u32. bits_out: u16[C, 4096];
// card_out: i32[C]. Returns the cudaError_t (cudaErrorInvalidValue for a
// shape not built).
extern "C" int roaring_fused_eval(const void* ops, const void* meta,
                                  const void* prog, int n_prog,
                                  const void* lifts, int n_lifts, int N, int C,
                                  int n_stack, int split,
                                  void* bits_out, void* card_out,
                                  void* gscratch, void* stream) {
  const Args a{static_cast<const uint4*>(ops),
               static_cast<const int32_t*>(meta),
               static_cast<const int4*>(prog), n_prog,
               static_cast<const int32_t*>(lifts), n_lifts, N, C, n_stack,
               static_cast<uint4*>(bits_out), static_cast<int32_t*>(card_out),
               static_cast<uint4*>(gscratch)};
  cudaStream_t s = (cudaStream_t)stream;
  if (n_prog <= 0 || n_stack < split) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaErrorInvalidValue;
  if (gscratch == nullptr && split == 1) err = launch<kThreads, 2, true>(a, s);
  if (gscratch == nullptr && split == 2) err = launch<kThreads, 1, true>(a, s);
  if (gscratch != nullptr && split == 1) err = launch<kThreads, 2, false>(a, s);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
