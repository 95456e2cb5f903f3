// Shared pieces of the B2SR row-product kernels (bmm/bmm.cu and
// spgemm/spgemm.cu).
//
// A block takes one tile-row at a time from a global counter (dynamic
// scheduling: a hub row holds one block while the others drain the
// rest), marks tile columns in a bitmap in shared memory, and finds the
// rank of a marked column among the marked ones by a prefix popcount.
// The bitmap holds one bit per tile column, the rank array one word per
// 32 tile columns, so a block needs n_tile_cols / 4 bytes of shared
// memory: at most kMaxWords bitmap words.
//
// A row's marks usually touch a short span of the bitmap (a road grid's
// tile-row reaches ~13 columns of 131,072), so the marking threads keep
// the lowest and highest word they marked (range_of), and the rank and
// the clearing cover only that span (range_rank, range_clear). The rank
// gives a warp 32 consecutive words, one a lane: the warp's reads fall in
// 32 distinct banks. A kernel that knows the span beforehand may hold a
// bitmap of the span's width alone, its word 0 the span's first word
// (mark's and rank_of's base).

#pragma once

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace rowbm {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr unsigned kFull = 0xffffffffu;
// Bitmap words whose bitmap and rank array fit the 227 KB a block may
// use, with 4 KB left for the kernels' other shared memory.
constexpr int kMaxWords = (232448 - 4096) / 8;

// The next tile-row of this block, or a value >= n_rows when none is left.
__device__ __forceinline__ int next_row(int* counter) {
  __shared__ int s_row;
  __syncthreads();  // every thread is done with the previous row
  if (threadIdx.x == 0) s_row = atomicAdd(counter, 1);
  __syncthreads();
  return s_row;
}

// Marks column c in a bitmap whose word 0 is word base of the row and
// widens [lo, hi], the words this thread marked. The plain read first
// skips the atomic when the bit is set already (on a dense row most marks
// repeat one).
__device__ __forceinline__ void mark(uint32_t* bits, int c, int base,
                                     int& lo, int& hi) {
  const int w = (c >> 5) - base;
  const uint32_t bit = 1u << (c & 31);
  if (!(bits[w] & bit)) atomicOr(bits + w, bit);
  lo = min(lo, w);
  hi = max(hi, w);
}

// The block's marked word range from each thread's [lo, hi]: [0, -1]
// when nothing was marked. s_lo and s_hi must hold INT_MAX and -1 on
// entry (range_clear leaves them so). Called by the whole block.
__device__ __forceinline__ void range_of(int& lo, int& hi, int* s_lo,
                                         int* s_hi) {
  lo = __reduce_min_sync(kFull, lo);
  hi = __reduce_max_sync(kFull, hi);
  if ((threadIdx.x & 31) == 0 && hi >= 0) {
    atomicMin(s_lo, lo);
    atomicMax(s_hi, hi);
  }
  __syncthreads();
  hi = *s_hi;
  lo = hi < 0 ? 0 : *s_lo;  // lo + threadIdx.x must not overflow
}

// The number of marked columns below c (c itself must be marked), from
// rank[w], the number of marked columns below word w (word 0: the row's
// word base).
__device__ __forceinline__ int rank_of(const uint32_t* bits,
                                       const uint32_t* rank, int c,
                                       int base) {
  const int w = (c >> 5) - base;
  return rank[w] + __popc(bits[w] & ((1u << (c & 31)) - 1u));
}

__device__ __forceinline__ uint32_t warp_inclusive_sum(uint32_t v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const uint32_t y = __shfl_up_sync(kFull, v, d);
    if (lane >= d) v += y;
  }
  return v;
}

// The sum of v over the block (every thread gets it). Called by the whole
// block; blockDim.x a multiple of 32.
__device__ uint32_t block_sum(uint32_t v) {
  __shared__ uint32_t part[32];
  const int warps = blockDim.x >> 5;
  v = __reduce_add_sync(kFull, v);
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = v;
  __syncthreads();
  uint32_t total = 0;
  for (int i = 0; i < warps; ++i) total += part[i];
  __syncthreads();  // part is written again by the next call
  return total;
}

// rank[w] = set bits of bits[lo, w) for w in [lo, hi]; returns the set
// bits of the whole range. The block goes over the range in chunks of
// blockDim.x consecutive words, one a thread (a scan within each warp,
// then over the warps' sums), carrying the chunks' totals. Called by the
// whole block.
__device__ uint32_t range_rank(const uint32_t* bits, uint32_t* rank, int lo,
                               int hi) {
  __shared__ uint32_t warp_sum[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  uint32_t carry = 0;
  for (int w0 = lo; w0 <= hi; w0 += blockDim.x) {
    const int w = w0 + threadIdx.x;
    const uint32_t p = w <= hi ? __popc(bits[w]) : 0u;
    const uint32_t incl = warp_inclusive_sum(p);
    if (lane == 31) warp_sum[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      uint32_t v = lane < warps ? warp_sum[lane] : 0u;
      v = warp_inclusive_sum(v);
      if (lane < warps) warp_sum[lane] = v;
    }
    __syncthreads();
    if (w <= hi) rank[w] = carry + (warp ? warp_sum[warp - 1] : 0u) + incl - p;
    carry += warp_sum[warps - 1];
    __syncthreads();  // warp_sum is written again by the next chunk
  }
  return carry;
}

// Zeroes bits[lo, hi] and resets the range for the next row. Called by the
// whole block once every thread is done reading *s_lo and *s_hi.
__device__ __forceinline__ void range_clear(uint32_t* bits, int lo, int hi,
                                            int* s_lo, int* s_hi) {
  for (int w = lo + threadIdx.x; w <= hi; w += blockDim.x) bits[w] = 0;
  if (threadIdx.x == 0) {
    *s_lo = INT_MAX;
    *s_hi = -1;
  }
}

// Blocks for a launch over n_rows tile-rows: as many as the card holds at
// once with smem bytes of dynamic shared memory each, at most n_rows.
inline cudaError_t row_grid(const void* kernel, size_t smem, int n_rows,
                            int* grid, int threads = kThreads) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      threads, smem);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  *grid = min(n_rows, sms * per_sm);
  return cudaSuccess;
}

}  // namespace rowbm
