// Masked B2SR product reduction for Hopper (sm_90a): bmm_tc, the
// triangle-counting kernel.
//
// Replaces bmm_bin_bin_sum_masked_pallas in src/repro/kernels/bmm/bmm.py:
//
//   total = Σ_{(r,c): M_rc = 1} (A·B)_rc
//
// for B2SR A [R x K], B [K x C] and mask M [R x C]. B comes as Bᵀ's B2SR:
// word c of Bᵀ's tile (J, X) is bit-column c of B's tile (X, J), so the
// count tile of A(I, X)·B(X, J) at (r, c) is popc(A(I,X)[r] & Bᵀ(J,X)[c]),
// the paper's popcount dot product, with no bit transpose. For triangle
// counting A = M = Bᵀ = L, one array read three ways. The total is exact
// in 64 bits (the TPU kernel and its wrapper sum in int32 and float32).
//
// Layout: a block per work item, taken from a global counter: a run of
// mask tiles (I, J) of one tile-row I, cut by the wrapper so that a hub
// row spreads over many blocks. The block marks A's tile-row I in a
// shared-memory bitmap over the tile columns X (with, for each bitmap
// word, the row position of its first marked column: A's rows are
// sorted, so a marked X's position is that plus a popcount). Warps then
// take the item's mask tiles (I, J);
// the lanes of a warp walk Bᵀ's tile-row J and keep each X that the
// bitmap holds: the intersection of A's row I with Bᵀ's row J, one O(1)
// probe per tile of row J. For each common X and each set bit (r, c) of
// the mask tile the lane adds popc(A(I,X)[r] & Bᵀ(J,X)[c]). Lanes reduce
// by shuffles; one 64-bit atomicAdd per warp at the end.
//
// A common X costs random reads of tile words (2.1 GB of tiles for L), and
// most of them find zero words: R-MAT tiles hold 1.9 set bits in 1,024.
// So a first launch packs each tile's row occupancy (bit r set iff word r
// is non-zero) into one word per tile, 4 bytes in place of 4t, and the
// walk reads the tile words only for the mask's rows r where A(I,X)[r] is
// non-zero and columns c where Bᵀ(J,X)[c] is.
//
// The TPU kernel walked the other way, from every A tile (I, X) through
// all of B's tile-row X with a search of mask row I per product tile:
// Σ_X colcount(X)² tile pairs (8.06e10 for L of R-MAT scale 21), where
// this walk probes Σ_{(I,J) in M} len(Bᵀ row J) tiles (1.99e10).
//
// Bound: counted once, the three arrays are 2.18 GB for L of R-MAT scale
// 21, and the work is a few operations per (mask bit, common tile) pair
// (1.44e10 pairs there). What the walk pays for is the random reads per
// common tile and the probes, which read Bᵀ's column indices once per
// mask tile (1.99e10 probes). Items of bounded work and dynamic
// scheduling keep the hub rows (11 M probes in one tile-row) from
// holding one block while the rest of the card idles.
//
// out[0] += total; out[1] += Σ over (mask tile, common X) of the mask
// tile's set bits (the work count the bound is computed from).

#include "../row_bitmap.cuh"

namespace {

using rowbm::kFull;
using rowbm::kThreads;
using rowbm::kWarps;

// occ[i] bit r = (tiles[i][r] != 0): one thread per tile.
template <int T>
__global__ void tile_row_occupancy_kernel(const uint32_t* __restrict__ tiles,
                                          uint32_t* __restrict__ occ,
                                          int64_t n_tiles) {
  const int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                    threadIdx.x;
  if (i >= n_tiles) return;
  const uint4* v = reinterpret_cast<const uint4*>(tiles + i * T);
  uint32_t o = 0;
#pragma unroll
  for (int q = 0; q < T / 4; ++q) {
    const uint4 w = __ldg(v + q);
    o |= static_cast<uint32_t>(w.x != 0) << (4 * q);
    o |= static_cast<uint32_t>(w.y != 0) << (4 * q + 1);
    o |= static_cast<uint32_t>(w.z != 0) << (4 * q + 2);
    o |= static_cast<uint32_t>(w.w != 0) << (4 * q + 3);
  }
  occ[i] = o;
}

template <int T>
__global__ void __launch_bounds__(kThreads)
bmm_tc_kernel(const int32_t* __restrict__ a_ptr,
              const int32_t* __restrict__ a_col,
              const uint32_t* __restrict__ a_tiles,
              const int32_t* __restrict__ bt_ptr,
              const int32_t* __restrict__ bt_col,
              const uint32_t* __restrict__ bt_tiles,
              const int32_t* __restrict__ m_col,
              const uint32_t* __restrict__ m_tiles,
              const uint32_t* __restrict__ a_occ,
              const uint32_t* __restrict__ bt_occ,
              const int32_t* __restrict__ item_row,
              const int32_t* __restrict__ item_begin,
              unsigned long long* __restrict__ out, int n_items, int n_words,
              int* __restrict__ counter) {
  extern __shared__ uint32_t smem[];
  uint32_t* bits = smem;              // A's tile-row, one bit per column
  uint32_t* first = smem + n_words;   // row position of a word's first bit
  __shared__ uint32_t mtile[kWarps][T];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned long long acc = 0, work = 0;
  for (int w = threadIdx.x; w < n_words; w += kThreads) bits[w] = 0;

  for (int item = rowbm::next_row(counter); item < n_items;
       item = rowbm::next_row(counter)) {
    const int row = item_row[item];
    const int a0 = a_ptr[row], a1 = a_ptr[row + 1];
    const int m0 = item_begin[item], m1 = item_begin[item + 1];
    if (a0 == a1) continue;  // uniform across the block
    for (int k = a0 + threadIdx.x; k < a1; k += kThreads) {
      const int c = a_col[k];
      rowbm::mark(bits, c);
      if (k == a0 || (a_col[k - 1] >> 5) != (c >> 5)) first[c >> 5] = k - a0;
    }
    __syncthreads();
    for (int mk = m0 + warp; mk < m1; mk += kWarps) {  // warp-uniform
      const uint32_t mw =
          lane < T ? m_tiles[static_cast<size_t>(mk) * T + lane] : 0u;
      const unsigned rows_set = __ballot_sync(kFull, mw != 0);
      const unsigned cols_set = __reduce_or_sync(kFull, mw);
      const unsigned mbits = __reduce_add_sync(kFull, __popc(mw));
      if (lane < T) mtile[warp][lane] = mw;
      __syncwarp();
      const int j = m_col[mk];
      const int q1 = bt_ptr[j + 1];
      for (int q = bt_ptr[j] + lane; q < q1; q += 32) {
        const int x = bt_col[q];
        const uint32_t word = bits[x >> 5];
        const uint32_t bit = 1u << (x & 31);
        if (!(word & bit)) continue;
        const int p = a0 + first[x >> 5] + __popc(word & (bit - 1u));
        work += mbits;
        const uint32_t rs0 = __ldg(a_occ + p) & rows_set;
        if (!rs0) continue;
        const uint32_t cols = __ldg(bt_occ + q) & cols_set;
        if (!cols) continue;
        const uint32_t* at = a_tiles + static_cast<size_t>(p) * T;
        const uint32_t* bt = bt_tiles + static_cast<size_t>(q) * T;
        for (uint32_t rs = rs0; rs; rs &= rs - 1) {
          const int r = __ffs(rs) - 1;
          const uint32_t a = __ldg(at + r);
          for (uint32_t cs = mtile[warp][r] & cols; cs; cs &= cs - 1)
            acc += __popc(a & __ldg(bt + (__ffs(cs) - 1)));
        }
      }
      __syncwarp();  // mtile[warp] is written again for the next tile
    }
    __syncthreads();
    for (int k = a0 + threadIdx.x; k < a1; k += kThreads)
      bits[a_col[k] >> 5] = 0;
  }
#pragma unroll
  for (int d = 16; d; d >>= 1) {
    acc += __shfl_down_sync(kFull, acc, d);
    work += __shfl_down_sync(kFull, work, d);
  }
  if (lane == 0 && (acc || work)) {
    atomicAdd(out, acc);
    atomicAdd(out + 1, work);
  }
}

using TcKernel = void (*)(const int32_t*, const int32_t*, const uint32_t*,
                          const int32_t*, const int32_t*, const uint32_t*,
                          const int32_t*, const uint32_t*,
                          const uint32_t*, const uint32_t*, const int32_t*,
                          const int32_t*, unsigned long long*, int, int,
                          int*);
using OccKernel = void (*)(const uint32_t*, uint32_t*, int64_t);

TcKernel tc_for(int t) {
  switch (t) {
    case 4: return bmm_tc_kernel<4>;
    case 8: return bmm_tc_kernel<8>;
    case 16: return bmm_tc_kernel<16>;
    case 32: return bmm_tc_kernel<32>;
    default: return nullptr;
  }
}

OccKernel occ_for(int t) {
  switch (t) {
    case 4: return tile_row_occupancy_kernel<4>;
    case 8: return tile_row_occupancy_kernel<8>;
    case 16: return tile_row_occupancy_kernel<16>;
    case 32: return tile_row_occupancy_kernel<32>;
    default: return nullptr;
  }
}

cudaError_t occupancy(OccKernel k, const void* tiles, void* occ,
                      int64_t n_tiles, cudaStream_t stream) {
  if (n_tiles <= 0) return cudaSuccess;
  const int64_t blocks = (n_tiles + kThreads - 1) / kThreads;
  k<<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const uint32_t*>(tiles), static_cast<uint32_t*>(occ),
      n_tiles);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// out: uint64[2], zeroed by the caller; counter: int32[1], zeroed.
// a_occ / bt_occ: uint32 scratch, one word per tile of A / Bᵀ (the same
// buffer when a_tiles == bt_tiles). Item i is the mask tiles
// [item_begin[i], item_begin[i + 1]), all in tile-row item_row[i].
// n_words = ceil(A's tile columns / 32), at most rowbm::kMaxWords.
int bmm_tc(const void* a_ptr, const void* a_col, const void* a_tiles,
           const void* bt_ptr, const void* bt_col, const void* bt_tiles,
           const void* m_col, const void* m_tiles, void* a_occ, void* bt_occ, int64_t a_tiles_n, int64_t bt_tiles_n,
           const void* item_row, const void* item_begin, void* out,
           int n_items, int n_words, int t, void* counter, void* stream) {
  const TcKernel k = tc_for(t);
  const OccKernel occ_k = occ_for(t);
  if (k == nullptr || occ_k == nullptr || n_words > rowbm::kMaxWords)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_items <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = occupancy(occ_k, a_tiles, a_occ, a_tiles_n, s);
  if (e == cudaSuccess && bt_occ != a_occ)
    e = occupancy(occ_k, bt_tiles, bt_occ, bt_tiles_n, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  const size_t smem = 2 * static_cast<size_t>(n_words) * sizeof(uint32_t);
  int grid = 0;
  e = rowbm::row_grid(reinterpret_cast<const void*>(k), smem, n_items, &grid);
  if (e != cudaSuccess) return static_cast<int>(e);
  k<<<grid, kThreads, smem, s>>>(
      static_cast<const int32_t*>(a_ptr), static_cast<const int32_t*>(a_col),
      static_cast<const uint32_t*>(a_tiles),
      static_cast<const int32_t*>(bt_ptr), static_cast<const int32_t*>(bt_col),
      static_cast<const uint32_t*>(bt_tiles),
      static_cast<const int32_t*>(m_col),
      static_cast<const uint32_t*>(m_tiles),
      static_cast<const uint32_t*>(a_occ),
      static_cast<const uint32_t*>(bt_occ),
      static_cast<const int32_t*>(item_row),
      static_cast<const int32_t*>(item_begin),
      static_cast<unsigned long long*>(out), n_items, n_words,
      static_cast<int*>(counter));
  return static_cast<int>(cudaGetLastError());
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
