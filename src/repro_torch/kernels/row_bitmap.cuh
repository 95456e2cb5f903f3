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

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace rowbm {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr unsigned kFull = 0xffffffffu;
// Bitmap words whose bitmap and rank array fit the 227 KB a block may
// use, with 4 KB left for the kernels' static shared memory.
constexpr int kMaxWords = (232448 - 4096) / 8;

// The next tile-row of this block, or a value >= n_rows when none is left.
__device__ __forceinline__ int next_row(int* counter) {
  __shared__ int s_row;
  __syncthreads();  // every thread is done with the previous row
  if (threadIdx.x == 0) s_row = atomicAdd(counter, 1);
  __syncthreads();
  return s_row;
}

__device__ __forceinline__ void mark(uint32_t* bits, int c) {
  atomicOr(bits + (c >> 5), 1u << (c & 31));
}

// The number of marked columns below c (c itself must be marked), from
// rank[w], the number of marked columns below word w.
__device__ __forceinline__ int rank_of(const uint32_t* bits,
                                       const uint32_t* rank, int c) {
  return rank[c >> 5] + __popc(bits[c >> 5] & ((1u << (c & 31)) - 1u));
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

// rank[w] = set bits of bits[0, w) for every word; returns the total.
// Called by the whole block.
__device__ uint32_t exclusive_rank(const uint32_t* bits, uint32_t* rank,
                                   int n_words) {
  __shared__ uint32_t warp_sum[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int per = (n_words + kThreads - 1) / kThreads;
  const int w0 = min(static_cast<int>(threadIdx.x) * per, n_words);
  const int w1 = min(w0 + per, n_words);
  uint32_t local = 0;
  for (int w = w0; w < w1; ++w) local += __popc(bits[w]);
  const uint32_t incl = warp_inclusive_sum(local);
  if (lane == 31) warp_sum[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    uint32_t v = lane < kWarps ? warp_sum[lane] : 0u;
    v = warp_inclusive_sum(v);
    if (lane < kWarps) warp_sum[lane] = v;
  }
  __syncthreads();
  uint32_t base = (warp ? warp_sum[warp - 1] : 0u) + incl - local;
  for (int w = w0; w < w1; ++w) {
    rank[w] = base;
    base += __popc(bits[w]);
  }
  const uint32_t total = warp_sum[kWarps - 1];
  __syncthreads();  // warp_sum is written again by the next call
  return total;
}

// Blocks for a launch over n_rows tile-rows: as many as the card holds at
// once with smem bytes of dynamic shared memory each, at most n_rows.
inline cudaError_t row_grid(const void* kernel, size_t smem, int n_rows,
                            int* grid) {
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
                                                      kThreads, smem);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  *grid = min(n_rows, sms * per_sm);
  return cudaSuccess;
}

}  // namespace rowbm
