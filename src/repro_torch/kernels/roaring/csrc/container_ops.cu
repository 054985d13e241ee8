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
// card_b) bytes and writes the 8 kB mask; its card_a * log2(card_b + 1)
// compare-and-select steps stay far under the card's integer rate.
//
// What the design does about it:
//   * container_op streams each row as 16-byte vector loads (512 uint4 per
//     row, two per thread of 256), does the op on 32-bit words and counts
//     with __popc, then one warp-shuffle + shared-memory block sum;
//   * a both-EMPTY pair writes its zeros and exits before reading payload:
//     the counterpart of the Pallas `skip_dead_rows` DMA skip. One EMPTY
//     side is live (an OR with nothing still copies the other row);
//   * array_intersect stages B's card_b values in shared memory (8 kB at
//     most), so each thread's 13 halvings read shared memory, not HBM, and
//     reads only A's first card_a values; slots past card_a write 0.
//
// Values are u16: 0xFFFF is the array padding, and every compare here is on
// unsigned 16-bit values, so a real 65535 in both arrays is a hit and the
// padding past card_b is never searched.

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

__global__ void __launch_bounds__(kThreads)
array_intersect_kernel(const uint16_t* __restrict__ a,
                       const uint16_t* __restrict__ b,
                       const int32_t* __restrict__ cards,
                       uint16_t* __restrict__ hits,
                       int32_t* __restrict__ count) {
  __shared__ uint16_t sb[kRowWords];
  const long long row = blockIdx.x;
  const int card_a = clamp_int(cards[2 * row], 0, kRowWords);
  const int card_b = clamp_int(cards[2 * row + 1], 0, kRowWords);
  stage_u16(sb, b + row * kRowWords, card_b);
  __syncthreads();
  const uint16_t* arow = a + row * kRowWords;
  uint16_t* hrow = hits + row * kRowWords;
  int n = 0;
  for (int i = threadIdx.x; i < kRowWords; i += kThreads) {
    uint16_t hit = 0;
    if (i < card_a) {
      const uint16_t v = arow[i];
      int lo = 0, hi = card_b;              // lower bound in sb[0, card_b)
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (sb[mid] < v) lo = mid + 1; else hi = mid;
      }
      hit = (lo < card_b && sb[lo] == v) ? 1 : 0;
    }
    hrow[i] = hit;
    n += hit;
  }
  const int total = block_sum(n);
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
    array_intersect_kernel<<<(unsigned)n_rows, kThreads, 0,
                             (cudaStream_t)stream>>>(
        static_cast<const uint16_t*>(a), static_cast<const uint16_t*>(b),
        static_cast<const int32_t*>(cards), static_cast<uint16_t*>(hits),
        static_cast<int32_t*>(count));
  }
  return (int)cudaGetLastError();
}
