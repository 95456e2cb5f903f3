// Boolean B2SR SpGEMM for Hopper (sm_90a): spgemm_bbb, with sparse output.
//
// Replaces mxm_bin_bin_bin_pallas in src/repro/kernels/spgemm/spgemm.py:
//
//   C<M> = A ∨.∧ B   (or C<¬M>),   C(I, J)[r] = OR_X OR_{k in A(I,X)[r]} B(X,J)[k]
//
// the paper's AND/shift word algorithm: C's bit-row r ORs in B's word k
// for every set bit k of A's word r. The TPU kernel wrote the dense tile
// grid uint32[R, C, t] (n^2 / 8 bytes: 2.2 TB for a road grid of 4.2 M
// vertices) and left the sparse top level to a host step; here the output
// is B2SR directly, in two passes over A's tile-rows:
//
//   count: a block marks the tile columns J that A's row I reaches through
//          B (for each A tile (I, X), all of B's tile-row X) in a shared-
//          memory bitmap and writes their number: an upper bound on C's
//          row I. An exclusive scan of the counts (outside) lays C out.
//   fill:  the block marks the same columns again, ranks them (prefix
//          popcount), writes each J at its rank (so C's rows come out
//          sorted) and finds its mask tile by binary search in the mask's
//          row I. Warps take A's tiles (I, X), lanes B's tiles (X, J): a
//          lane ORs B's words into C(I, J)[r] for the set bits of A's
//          word r, ANDs the mask tile (or its complement) in, and ORs the
//          word into the output with atomicOr. A keep mask without a tile
//          at (I, J) skips the pair.
//
// The wrapper drops the tiles that came out zero (a product tile can be
// zero, and the mask can zero one), as the TPU path's host compression did.
//
// Bound: device-memory bytes for the arrays read once and the output
// written once; the work is one OR per (set bit of A(I,X), tile B(X,J))
// pair, a few per pair on R-MAT. The bitmap needs n_tile_cols(B) / 4
// bytes of shared memory (the rank array included): up to 913,408 tile
// columns (rowbm::kMaxWords words).

#include "../row_bitmap.cuh"

namespace {

using rowbm::kFull;
using rowbm::kThreads;
using rowbm::kWarps;

enum MaskMode { kNoMask = 0, kKeep = 1, kComplement = 2 };

// Index of j in the sorted col[lo, hi), or -1.
__device__ __forceinline__ int find_col(const int32_t* __restrict__ col,
                                        int lo, int hi, int j) {
  const int end = hi;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (col[mid] < j) lo = mid + 1; else hi = mid;
  }
  return (lo < end && col[lo] == j) ? lo : -1;
}

template <int T, bool kFill>
__global__ void __launch_bounds__(kThreads)
spgemm_bbb_kernel(const int32_t* __restrict__ a_ptr,
                  const int32_t* __restrict__ a_col,
                  const uint32_t* __restrict__ a_tiles,
                  const int32_t* __restrict__ b_ptr,
                  const int32_t* __restrict__ b_col,
                  const uint32_t* __restrict__ b_tiles,
                  const int32_t* __restrict__ m_ptr,
                  const int32_t* __restrict__ m_col,
                  const uint32_t* __restrict__ m_tiles, int mask_mode,
                  int64_t* __restrict__ row_off,  // count: out; fill: in
                  int32_t* __restrict__ out_col,
                  int32_t* __restrict__ out_mask,  // mask tile of a slot
                  uint32_t* __restrict__ out_tiles, int n_rows, int n_words,
                  int* __restrict__ counter) {
  extern __shared__ uint32_t smem[];
  uint32_t* bits = smem;             // C's tile columns in row I
  uint32_t* rank = smem + n_words;   // marked columns below each word
  __shared__ uint32_t atile[kWarps][T];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int w = threadIdx.x; w < n_words; w += kThreads) bits[w] = 0;

  for (int row = rowbm::next_row(counter); row < n_rows;
       row = rowbm::next_row(counter)) {
    const int a0 = a_ptr[row], a1 = a_ptr[row + 1];
    if (a0 == a1) {  // uniform across the block
      if (!kFill && threadIdx.x == 0) row_off[row] = 0;
      continue;
    }
    for (int k = a0 + warp; k < a1; k += kWarps) {
      const int x = a_col[k];
      const int q1 = b_ptr[x + 1];
      for (int q = b_ptr[x] + lane; q < q1; q += 32)
        rowbm::mark(bits, b_col[q]);
    }
    __syncthreads();
    const uint32_t total = rowbm::exclusive_rank(bits, rank, n_words);
    if (!kFill) {
      if (threadIdx.x == 0) row_off[row] = total;
    } else {
      const int64_t off = row_off[row];
      for (int w = threadIdx.x; w < n_words; w += kThreads) {
        int64_t slot = off + rank[w];
        for (uint32_t word = bits[w]; word; word &= word - 1, ++slot) {
          const int j = w * 32 + __ffs(word) - 1;
          out_col[slot] = j;
          if (mask_mode != kNoMask)
            out_mask[slot] = find_col(m_col, m_ptr[row], m_ptr[row + 1], j);
        }
      }
      __syncthreads();  // out_mask is read below by other threads
      for (int k = a0 + warp; k < a1; k += kWarps) {  // warp-uniform
        const uint32_t aw =
            lane < T ? a_tiles[static_cast<size_t>(k) * T + lane] : 0u;
        const unsigned rows_set = __ballot_sync(kFull, aw != 0);
        if (lane < T) atile[warp][lane] = aw;
        __syncwarp();
        const int x = a_col[k];
        const int q1 = b_ptr[x + 1];
        for (int q = b_ptr[x] + lane; q < q1; q += 32) {
          const int j = b_col[q];
          const int64_t slot = off + rowbm::rank_of(bits, rank, j);
          const uint32_t* mt = nullptr;
          if (mask_mode != kNoMask) {
            const int mi = out_mask[slot];
            if (mi >= 0)
              mt = m_tiles + static_cast<size_t>(mi) * T;
            else if (mask_mode == kKeep)
              continue;
          }
          const uint32_t* bt = b_tiles + static_cast<size_t>(q) * T;
          uint32_t* ct = out_tiles + slot * T;
          for (unsigned rs = rows_set; rs; rs &= rs - 1) {
            const int r = __ffs(rs) - 1;
            uint32_t c = 0;
            for (uint32_t ks = atile[warp][r]; ks; ks &= ks - 1)
              c |= __ldg(bt + (__ffs(ks) - 1));
            if (mt != nullptr) {
              const uint32_t mw = __ldg(mt + r);
              c &= mask_mode == kComplement ? ~mw : mw;
            }
            if (c) atomicOr(ct + r, c);
          }
        }
        __syncwarp();  // atile[warp] is written again for the next tile
      }
      __syncthreads();
    }
    for (int w = threadIdx.x; w < n_words; w += kThreads) bits[w] = 0;
  }
}

using Kernel = void (*)(const int32_t*, const int32_t*, const uint32_t*,
                        const int32_t*, const int32_t*, const uint32_t*,
                        const int32_t*, const int32_t*, const uint32_t*, int,
                        int64_t*, int32_t*, int32_t*, uint32_t*, int, int,
                        int*);

template <bool kFill>
Kernel kernel_for(int t) {
  switch (t) {
    case 4: return spgemm_bbb_kernel<4, kFill>;
    case 8: return spgemm_bbb_kernel<8, kFill>;
    case 16: return spgemm_bbb_kernel<16, kFill>;
    case 32: return spgemm_bbb_kernel<32, kFill>;
    default: return nullptr;
  }
}

}  // namespace

extern "C" {

// fill = 0: row_off[i] = the upper bound of C's row i (int64[n_rows]).
// fill = 1: row_off is the exclusive scan (int64[n_rows + 1]); writes
// out_col, out_mask (when mask_mode != 0) and ORs into out_tiles, which
// the caller zeroes. m_* may be null when mask_mode == 0. counter:
// int32[1], zeroed by the caller for each launch.
int spgemm_bbb(const void* a_ptr, const void* a_col, const void* a_tiles,
               const void* b_ptr, const void* b_col, const void* b_tiles,
               const void* m_ptr, const void* m_col, const void* m_tiles,
               int mask_mode, void* row_off, void* out_col, void* out_mask,
               void* out_tiles, int n_rows, int n_words, int t, int fill,
               void* counter, void* stream) {
  const Kernel k = fill ? kernel_for<true>(t) : kernel_for<false>(t);
  if (k == nullptr || n_words > rowbm::kMaxWords || mask_mode < 0 ||
      mask_mode > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_rows <= 0) return 0;
  const size_t smem = 2 * static_cast<size_t>(n_words) * sizeof(uint32_t);
  int grid = 0;
  const cudaError_t e = rowbm::row_grid(reinterpret_cast<const void*>(k),
                                        smem, n_rows, &grid);
  if (e != cudaSuccess) return static_cast<int>(e);
  k<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(a_ptr), static_cast<const int32_t*>(a_col),
      static_cast<const uint32_t*>(a_tiles),
      static_cast<const int32_t*>(b_ptr), static_cast<const int32_t*>(b_col),
      static_cast<const uint32_t*>(b_tiles),
      static_cast<const int32_t*>(m_ptr), static_cast<const int32_t*>(m_col),
      static_cast<const uint32_t*>(m_tiles), mask_mode,
      static_cast<int64_t*>(row_off), static_cast<int32_t*>(out_col),
      static_cast<int32_t*>(out_mask), static_cast<uint32_t*>(out_tiles),
      n_rows, n_words, static_cast<int*>(counter));
  return static_cast<int>(cudaGetLastError());
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
