// Bitmap-domain container word op and packed-array intersection: one thread
// block per key-aligned row pair.
//
// Replaces two Pallas kernels of src/repro/kernels/roaring/kernel.py:
//   * `container_op_pallas` (body `_container_op_kernel`): the word op
//     (and / or / xor / andnot) of two 2^16-bit rows plus the popcount of
//     the result, with both-EMPTY pairs giving zeros and card 0;
//   * `array_intersect_pallas` (body `_array_intersect_kernel`): every slot
//     of a packed sorted array A takes a lower-bound search in the first
//     card_b values of B; the output is the 0/1 hit mask over A's 4096 slots
//     and the hit count.
//
// What bounds them on an H100: memory. container_op does one word op and a
// popcount per 4 bytes read; a live pair moves 2 x 8 kB in and 8 kB out, a
// dead pair only its 8 kB of zeros. array_intersect reads 2 * (card_a +
// card_b) bytes and writes the 8 kB mask, which is most of its bytes at
// the store's cards; its compares stay far under the card's integer rate.
//
// What the design does about it:
//   * container_op streams each row as 16-byte vector loads (512 uint4 per
//     row, two per thread of 256), does the op on 32-bit words and counts
//     with __popc, then one warp-shuffle + shared-memory block sum;
//   * a both-EMPTY pair writes its zeros and exits before reading payload:
//     the counterpart of the Pallas `skip_dead_rows` DMA skip. One EMPTY
//     side is live (an OR with nothing still copies the other row);
//   * array_intersect runs one block of 256 threads a pair, and each thread
//     owns a contiguous span of 16 of A's slots: it loads its span as
//     16-byte vectors while B's first card_b values come in as 16-byte
//     vectors too; B's values are set in a 2^16-bit membership
//     bitmap in shared memory (8 kB, one atomicOr a value), and each of
//     A's values tests one bit: no search, no data-dependent loop. The hits
//     go out as 16-byte stores. A span that starts at or past card_a writes
//     zeros without reading A. (A lower-bound search per span followed by
//     a merge walk of B was 3-4x slower than the parent's search per slot:
//     the walk's lanes diverge; PERF.md, section 6.)
//
// Values are u16: 0xFFFF is the array padding, and every compare here is on
// unsigned 16-bit values, so a real 65535 in both arrays is a hit and the
// padding past card_b is never matched (the walk stops at card_b).

#include "roaring_common.cuh"

using namespace roaring;

namespace {

constexpr int kOpAnd = 0, kOpOr = 1, kOpXor = 2, kOpAndNot = 3;
constexpr int kRowVec = kRowWords / 8;   // 16-byte vectors per row

template <int OP>
__device__ __forceinline__ uint32_t word_op(uint32_t x, uint32_t y) {
  if (OP == kOpAnd) return x & y;
  if (OP == kOpOr) return x | y;
  if (OP == kOpXor) return x ^ y;
  return x & ~y;
}

template <int OP>
__device__ __forceinline__ uint4 vec_op(uint4 x, uint4 y, int& count) {
  uint4 r;
  r.x = word_op<OP>(x.x, y.x);
  r.y = word_op<OP>(x.y, y.y);
  r.z = word_op<OP>(x.z, y.z);
  r.w = word_op<OP>(x.w, y.w);
  count += __popc(r.x) + __popc(r.y) + __popc(r.z) + __popc(r.w);
  return r;
}

template <int OP>
__global__ void __launch_bounds__(kThreads)
container_op_kernel(const uint4* __restrict__ a, const uint4* __restrict__ b,
                    const int32_t* __restrict__ kinds, uint4* __restrict__ out,
                    int32_t* __restrict__ card) {
  const long long row = blockIdx.x;
  uint4* orow = out + row * kRowVec;
  if (kinds[2 * row] == KIND_EMPTY && kinds[2 * row + 1] == KIND_EMPTY) {
    for (int i = threadIdx.x; i < kRowVec; i += kThreads)
      orow[i] = make_uint4(0, 0, 0, 0);
    if (threadIdx.x == 0) card[row] = 0;
    return;
  }
  const uint4* arow = a + row * kRowVec;
  const uint4* brow = b + row * kRowVec;
  int count = 0;
  for (int i = threadIdx.x; i < kRowVec; i += kThreads)
    orow[i] = vec_op<OP>(__ldg(arow + i), __ldg(brow + i), count);
  const int total = block_sum(count);
  if (threadIdx.x == 0) card[row] = total;
}

// Value s (0-7, a constant once unrolled) of a 16-byte vector of u16.
__device__ __forceinline__ int vec_value(uint4 q, int s) {
  const int m = s >> 1;
  const uint32_t w = m == 0 ? q.x : m == 1 ? q.y : m == 2 ? q.z : q.w;
  return (int)((w >> (16 * (s & 1))) & 0xFFFFu);
}

// One block a pair; thread t owns A's slots [kSpan t, kSpan (t + 1)).
constexpr int kSpan = 16;

__global__ void __launch_bounds__(kRowWords / kSpan)
array_intersect_kernel(const uint4* __restrict__ a,
                       const uint4* __restrict__ b,
                       const int32_t* __restrict__ cards,
                       uint4* __restrict__ hits,
                       int32_t* __restrict__ count) {
  constexpr int T = kRowWords / kSpan;
  constexpr int kVec = kSpan / 8;            // 16-byte vectors of a span
  constexpr int kBVec = kRowVec / T;         // B's vectors a thread loads
  __shared__ uint4 member4[kRowVec];         // B as a 2^16-bit bitmap
  const long long row = blockIdx.x;
  const int card_a = clamp_int(cards[2 * row], 0, kRowWords);
  const int card_b = clamp_int(cards[2 * row + 1], 0, kRowWords);
  const int first = threadIdx.x * kSpan;
  const bool live = first < card_a;
  uint4 av[kVec], bv[kBVec];
  if (live) {                      // A's and B's loads fly together
    const uint4* arow = a + row * kRowVec + threadIdx.x * kVec;
#pragma unroll
    for (int k = 0; k < kVec; ++k) av[k] = __ldg(arow + k);
  }
  const uint4* brow = b + row * kRowVec;
#pragma unroll
  for (int k = 0; k < kBVec; ++k) {
    const int i = threadIdx.x + k * T;
    if (8 * i < card_b) bv[k] = __ldg(brow + i);
  }
#pragma unroll
  for (int k = 0; k < kBVec; ++k)
    member4[threadIdx.x + k * T] = make_uint4(0, 0, 0, 0);
  __syncthreads();
  uint32_t* member = reinterpret_cast<uint32_t*>(member4);
#pragma unroll
  for (int k = 0; k < kBVec; ++k) {
    const int i = threadIdx.x + k * T;
#pragma unroll
    for (int s = 0; s < 8; ++s) {
      if (8 * i + s < card_b) {
        const int v = vec_value(bv[k], s);
        atomicOr(member + (v >> 5), 1u << (v & 31));
      }
    }
  }
  __syncthreads();

  uint32_t hw[kSpan / 2];
#pragma unroll
  for (int k = 0; k < kSpan / 2; ++k) hw[k] = 0;
  int n = 0;
#pragma unroll
  for (int s = 0; s < kSpan; ++s) {
    if (live && first + s < card_a) {
      const int v = vec_value(av[s >> 3], s & 7);
      if ((member[v >> 5] >> (v & 31)) & 1u) {
        hw[s >> 1] |= 1u << (16 * (s & 1));
        ++n;
      }
    }
  }
  uint4* hrow = hits + row * kRowVec + threadIdx.x * kVec;
#pragma unroll
  for (int k = 0; k < kVec; ++k)
    hrow[k] = make_uint4(hw[4 * k], hw[4 * k + 1], hw[4 * k + 2],
                         hw[4 * k + 3]);
  const int total = block_sum<T>(n);
  if (threadIdx.x == 0) count[row] = total;
}

}  // namespace

// n_rows pairs of bitmap-domain rows; kinds i32[2 n_rows] interleaved
// (kind_a, kind_b); op 0 and / 1 or / 2 xor / 3 andnot. Returns the
// cudaError_t of the launch (cudaErrorInvalidValue for an unknown op).
extern "C" int roaring_container_op(const void* a, const void* b,
                                    const void* kinds, void* out, void* card,
                                    long long n_rows, int op, void* stream) {
  if (n_rows <= 0) return (int)cudaGetLastError();
  const uint4* a4 = static_cast<const uint4*>(a);
  const uint4* b4 = static_cast<const uint4*>(b);
  const int32_t* k = static_cast<const int32_t*>(kinds);
  uint4* o4 = static_cast<uint4*>(out);
  int32_t* c = static_cast<int32_t*>(card);
  cudaStream_t s = (cudaStream_t)stream;
  const unsigned grid = (unsigned)n_rows;
  switch (op) {
    case kOpAnd:
      container_op_kernel<kOpAnd><<<grid, kThreads, 0, s>>>(a4, b4, k, o4, c);
      break;
    case kOpOr:
      container_op_kernel<kOpOr><<<grid, kThreads, 0, s>>>(a4, b4, k, o4, c);
      break;
    case kOpXor:
      container_op_kernel<kOpXor><<<grid, kThreads, 0, s>>>(a4, b4, k, o4, c);
      break;
    case kOpAndNot:
      container_op_kernel<kOpAndNot><<<grid, kThreads, 0, s>>>(a4, b4, k, o4,
                                                               c);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// n_rows pairs of packed sorted arrays; cards i32[2 n_rows] interleaved
// (card_a, card_b). Returns the cudaError_t of the launch.
extern "C" int roaring_array_intersect(const void* a, const void* b,
                                       const void* cards, void* hits,
                                       void* count, long long n_rows,
                                       void* stream) {
  if (n_rows > 0) {
    array_intersect_kernel<<<(unsigned)n_rows, kRowWords / kSpan, 0,
                             (cudaStream_t)stream>>>(
        static_cast<const uint4*>(a), static_cast<const uint4*>(b),
        static_cast<const int32_t*>(cards), static_cast<uint4*>(hits),
        static_cast<int32_t*>(count));
  }
  return (int)cudaGetLastError();
}
