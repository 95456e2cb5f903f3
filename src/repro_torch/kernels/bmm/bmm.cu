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
// take the item's mask tiles (I, J) and walk Bᵀ's tile-row J, one O(1)
// probe per tile of row J: the intersection of A's row I with Bᵀ's row J.
// The wrapper gives each mask tile to the side of its shorter row: a tile
// whose A row I is shorter than Bᵀ's row J goes to a second launch with A
// and Bᵀ swapped, which reads it as the tile (J, I) with its bits
// transposed in the warp (the bitmap holds Bᵀ's row J and the walk reads
// A's row I; the popcount is the same), so the probes add up to
// Σ min(len(A row I), len(Bᵀ row J)): 9.38e9 for L of R-MAT scale 21,
// against 1.99e10 for a walk of every Bᵀ row. The wrapper's plan holds
// only the order of the mask's tiles for each launch. Each side gets its
// own launch, items in row order: choosing the operands per item costs
// registers (40 is the cap), and rows in order share Bᵀ's rows in L2
// (one launch for both, heaviest items first: 93.0 ms against 78.4).
//
// Most common tiles contribute nothing: R-MAT tiles hold 1.9 set bits in
// 1,024, so A(I,X)[r] and Bᵀ(J,X)[c] are rarely both non-zero for a mask
// bit (r, c). A first launch therefore packs each tile's row occupancy
// (bit r set iff word r is non-zero) into one word per tile, and the
// kernel works in two stages per warp:
//   1. Probe. The 32 lanes probe 32 consecutive tiles q of Bᵀ's row J
//      (coalesced reads of its column indices and occupancy words). A
//      lane that hits a tile X of A's row I reads A(I,X)'s occupancy at
//      the row position the probe computes, from device memory (staging
//      A's row occupancy in shared memory measured no faster on an H100:
//      PERF.md). The lane keeps the mask
//      rows r with A(I,X)[r] != 0 whose mask columns meet Bᵀ(J,X)'s
//      occupancy, and a prefix sum over the lanes places one entry per
//      such (tile pair, r) in a per-warp queue in shared memory: the two
//      tiles, r and the mask columns c left.
//   2. Count. When the queue is full, and once at the end, the warp
//      drains it together: each lane takes queue entries in turn,
//      several entries' two tile words loaded before their popcounts,
//      and adds popc(A(I,X)[r] & Bᵀ(J,X)[c]) for each c of the entry.
// So no lane runs a nested loop of dependent reads while the other 31
// wait. Lanes reduce by shuffles; one 64-bit atomicAdd per warp and
// output word at the end.
//
// The TPU kernel walked the other way, from every A tile (I, X) through
// all of B's tile-row X with a search of mask row I per product tile:
// Σ_X colcount(X)² tile pairs (8.06e10 for L of R-MAT scale 21), where
// these walks probe Σ_{(I,J) in M} min(len(A row I), len(Bᵀ row J))
// tiles (9.38e9).
//
// Bound: counted once, the three arrays are 2.18 GB for L of R-MAT scale
// 21; the work is a few operations per (mask bit, common tile) pair
// (1.44e10 pairs there), plus, to find the common tiles at all, the
// least a merge of two sorted rows needs, Σ over mask tiles of
// min(len(A row I), len(Bᵀ row J)). Items of bounded work and dynamic
// scheduling keep the hub rows (11 M probes in one tile-row) from holding
// one block while the rest of the card idles.
//
// out[0] += total; out[1] += Σ over (mask tile, common X) of the mask
// tile's set bits (the work count the bound is computed from); out[2] +=
// the entries queued for the count stage.
//
// count: 0 (measurements only) runs the probes alone, the total stays 0.

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

// The kernel is bound by latency: a probe step is a chain of a global
// read and three shared-memory reads, so the card needs many warps
// resident and each warp the next step's reads in flight. Entries a warp
// queues (13 bytes each: 6.5 KB of static shared memory a block, beside
// the bitmap); entries a lane loads before their popcounts when it
// drains the queue; blocks an SM should hold (the register cap, 40 at
// 6); probe steps whose reads a warp keeps in flight. On an H100 at
// R-MAT scale 21 (tools/tc_variants.py) these take 80.5 ms; 2 steps in
// flight 81.8, 4 (spilling at 40 registers) 90.1; 1 entry in flight a
// lane 81.1; 5 blocks an SM 86.4, 4 (128-entry queues) 275.
constexpr int kQueue = 64;
constexpr int kDrainUnroll = 2;
constexpr int kBlocksPerSm = 6;
constexpr int kAhead = 1;
// the launcher's error code for an A wider than the bitmap a block holds
constexpr int kErrTooWide = -1;

// The bitmap holds rows of the first operand (A, or Bᵀ for the moved
// tiles) and the walk reads rows of the second.
template <int T>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
bmm_tc_kernel(const int32_t* __restrict__ a_ptr,
              const int32_t* __restrict__ a_col,
              const uint32_t* __restrict__ a_tiles,
              const int32_t* __restrict__ bt_ptr,
              const int32_t* __restrict__ bt_col,
              const uint32_t* __restrict__ bt_tiles,
              const int32_t* __restrict__ m_col,
              const int32_t* __restrict__ m_idx,
              const uint32_t* __restrict__ m_tiles,
              const uint32_t* __restrict__ a_occ,
              const uint32_t* __restrict__ bt_occ,
              const int32_t* __restrict__ item_row,
              const int32_t* __restrict__ item_begin,
              unsigned long long* __restrict__ out, int n_items, int n_words,
              int counting, int transpose, int* __restrict__ counter) {
  // A's tile-row, one bit per column (.x), with the row position of each
  // word's first marked column (.y): one 8-byte read a probe
  extern __shared__ uint2 bits[];
  __shared__ uint32_t mtile[kWarps][T];
  __shared__ int32_t q_a_all[kWarps][kQueue];    // A's tile
  __shared__ int32_t q_b_all[kWarps][kQueue];    // Bᵀ's tile
  __shared__ uint32_t q_c_all[kWarps][kQueue];   // the mask columns c
  __shared__ uint8_t q_r_all[kWarps][kQueue];    // the mask row r
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int32_t* q_a = q_a_all[warp];
  int32_t* q_b = q_b_all[warp];
  uint32_t* q_c = q_c_all[warp];
  uint8_t* q_r = q_r_all[warp];
  unsigned long long acc = 0, work = 0, queued = 0;
  int fill = 0;  // entries queued (uniform across the warp)
  for (int w = threadIdx.x; w < n_words; w += kThreads) bits[w].x = 0;

  // the queued entries' popcounts, then an empty queue
  auto drain = [&]() {
    __syncwarp();  // the entries are visible to every lane
    for (int e0 = lane; e0 < fill; e0 += 32 * kDrainUnroll) {
      uint32_t a[kDrainUnroll], b[kDrainUnroll], cs[kDrainUnroll];
      int qb[kDrainUnroll];
#pragma unroll
      for (int u = 0; u < kDrainUnroll; ++u) {
        const int e = e0 + 32 * u;
        const bool ok = e < fill;
        cs[u] = ok ? q_c[e] : 0u;
        qb[u] = ok ? q_b[e] : 0;
        a[u] = ok ? __ldg(a_tiles + static_cast<size_t>(q_a[e]) * T + q_r[e])
                  : 0u;
        b[u] = ok ? __ldg(bt_tiles + static_cast<size_t>(qb[u]) * T +
                          (__ffs(cs[u]) - 1))
                  : 0u;
      }
#pragma unroll
      for (int u = 0; u < kDrainUnroll; ++u) {
        acc += __popc(a[u] & b[u]);
        // the entry's other mask columns (rare: a mask row of R-MAT holds
        // about one bit in a tile)
        for (uint32_t rest = cs[u] & (cs[u] - 1); rest; rest &= rest - 1)
          acc += __popc(a[u] & __ldg(bt_tiles + static_cast<size_t>(qb[u]) *
                                                    T + (__ffs(rest) - 1)));
      }
    }
    __syncwarp();  // the entries are read before the queue fills again
    fill = 0;
  };

  // the current item's row start, the current mask tile
  int a0 = 0;
  unsigned rows_set = 0, cols_set = 0, mbits = 0;
  // one probe step: the tile q of Bᵀ's row (column x, -1 past the row's
  // end, occupancy bo) against the bitmap; the mask rows kept are queued
  auto probe = [&](int x, uint32_t bo, int q) {
    uint32_t rows = 0, cols = 0;  // the mask rows this pair keeps
    int p = 0;
    const uint2 bw = x >= 0 ? bits[x >> 5] : make_uint2(0u, 0u);
    const uint32_t bit = 1u << (x & 31);
    if (bw.x & bit) {
      const int rank = bw.y + __popc(bw.x & (bit - 1u));
      work += mbits;
      p = a0 + rank;
      rows = __ldg(a_occ + p) & rows_set;
      cols = bo & cols_set;
      uint32_t keep = 0;
      for (uint32_t rs = cols ? rows : 0u; rs; rs &= rs - 1) {
        const int r = __ffs(rs) - 1;
        if (mtile[warp][r] & cols) keep |= 1u << r;
      }
      rows = keep;
    }
    // most steps keep nothing: one vote skips the queue's prefix sum
    if (!counting || !__any_sync(kFull, rows != 0)) return;
    queued += __popc(rows);
    // queue one entry per kept row; a full queue is drained first
    for (;;) {
      const int n = __popc(rows);
      const int incl = static_cast<int>(
          rowbm::warp_inclusive_sum(static_cast<uint32_t>(n)));
      const int total = __shfl_sync(kFull, incl, 31);
      if (total == 0) break;  // uniform
      if (fill + total > kQueue && fill > 0) drain();
      int off = fill + incl - n;
      for (; rows && off < kQueue; rows &= rows - 1, ++off) {
        const int r = __ffs(rows) - 1;
        q_a[off] = p;
        q_b[off] = q;
        q_r[off] = static_cast<uint8_t>(r);
        q_c[off] = mtile[warp][r] & cols;
      }
      fill = min(kQueue, fill + total);
    }
  };

  for (int item = rowbm::next_row(counter); item < n_items;
       item = rowbm::next_row(counter)) {
    const int row = item_row[item];
    const int a1 = a_ptr[row + 1];
    a0 = a_ptr[row];
    const int m0 = item_begin[item], m1 = item_begin[item + 1];
    if (a0 == a1) continue;  // uniform across the block
    for (int k = a0 + threadIdx.x; k < a1; k += kThreads) {
      const int c = a_col[k];
      atomicOr(&bits[c >> 5].x, 1u << (c & 31));
      if (k == a0 || (a_col[k - 1] >> 5) != (c >> 5)) bits[c >> 5].y = k - a0;
    }
    __syncthreads();
    for (int mk = m0 + warp; mk < m1; mk += kWarps) {  // warp-uniform
      // the mask tile: word r of lane r; a moved tile's bits transposed
      // by T votes (lane c takes the vote on bit c of every word)
      uint32_t mw = lane < T ? m_tiles[static_cast<size_t>(m_idx[mk]) * T +
                                       lane]
                             : 0u;
      if (transpose) {
        uint32_t tw = 0;
#pragma unroll
        for (int c = 0; c < T; ++c) {
          const uint32_t v = __ballot_sync(kFull, (mw >> c) & 1u);
          if (lane == c) tw = v;
        }
        mw = tw;
      }
      rows_set = __ballot_sync(kFull, mw != 0);
      cols_set = __reduce_or_sync(kFull, mw);
      mbits = __reduce_add_sync(kFull, __popc(mw));
      if (lane < T) mtile[warp][lane] = mw;
      __syncwarp();
      const int j = m_col[mk];
      const int q0 = bt_ptr[j], q1 = bt_ptr[j + 1];
      // each step's column indices and occupancy words are read kAhead
      // steps ahead, into a ring of registers
      int xs[kAhead];
      uint32_t bs[kAhead];
#pragma unroll
      for (int u = 0; u < kAhead; ++u) {
        const int q = q0 + 32 * u + lane;
        xs[u] = q < q1 ? __ldg(bt_col + q) : -1;
        bs[u] = q < q1 ? __ldg(bt_occ + q) : 0u;
      }
      for (int qs = q0; qs < q1; qs += 32 * kAhead) {  // warp-uniform
#pragma unroll
        for (int u = 0; u < kAhead; ++u) {
          const int q = qs + 32 * u + lane;
          const int x = xs[u];
          const uint32_t bo = bs[u];
          const int qn = q + 32 * kAhead;
          xs[u] = qn < q1 ? __ldg(bt_col + qn) : -1;
          bs[u] = qn < q1 ? __ldg(bt_occ + qn) : 0u;
          if (qs + 32 * u < q1) probe(x, bo, q);  // warp-uniform
        }
      }
      __syncwarp();  // mtile[warp] is written again for the next tile
    }
    __syncthreads();
    for (int k = a0 + threadIdx.x; k < a1; k += kThreads)
      bits[a_col[k] >> 5].x = 0;
  }
  if (fill) drain();
#pragma unroll
  for (int d = 16; d; d >>= 1) {
    acc += __shfl_down_sync(kFull, acc, d);
    work += __shfl_down_sync(kFull, work, d);
    queued += __shfl_down_sync(kFull, queued, d);
  }
  if (lane == 0 && (acc || work)) {
    atomicAdd(out, acc);
    atomicAdd(out + 1, work);
    atomicAdd(out + 2, queued);
  }
}

using TcKernel = void (*)(const int32_t*, const int32_t*, const uint32_t*,
                          const int32_t*, const int32_t*, const uint32_t*,
                          const int32_t*, const int32_t*, const uint32_t*,
                          const uint32_t*, const uint32_t*, const int32_t*,
                          const int32_t*, unsigned long long*, int, int,
                          int, int, int*);
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

// out: uint64[3], zeroed by the caller; counter: int32[1], zeroed.
// a_occ / bt_occ: uint32 scratch, one word per tile of A / Bᵀ (the same
// buffer when a_tiles == bt_tiles), filled here unless occ_ready (an
// earlier launch of the call filled them). Item i is the mask tiles
// [item_begin[i], item_begin[i + 1]) of m_col / m_idx, all in tile-row
// item_row[i]: tile k lies in column m_col[k] and its words are tile
// m_idx[k] of m_tiles, transposed when transpose is set.
// n_words = ceil(the tile columns / 32): kErrTooWide when the bitmap and
// the kernel's static shared memory exceed what a block may hold;
// count: 1 but for measurements. out[2] += the entries queued for the
// count.
int bmm_tc(const void* a_ptr, const void* a_col, const void* a_tiles,
           const void* bt_ptr, const void* bt_col, const void* bt_tiles,
           const void* m_col, const void* m_idx, const void* m_tiles,
           void* a_occ, void* bt_occ, int64_t a_tiles_n, int64_t bt_tiles_n,
           int occ_ready, const void* item_row, const void* item_begin,
           void* out, int n_items, int n_words, int count, int transpose,
           int t, void* counter, void* stream) {
  const TcKernel k = tc_for(t);
  const OccKernel occ_k = occ_for(t);
  if (k == nullptr || occ_k == nullptr || n_words < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_items <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaFuncAttributes attr;
  int dev = 0, optin = 0;
  cudaError_t e = cudaFuncGetAttributes(&attr, k);
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (static_cast<int64_t>(attr.sharedSizeBytes) +
          8 * static_cast<int64_t>(n_words) > optin)
    return kErrTooWide;
  if (!occ_ready) {
    e = occupancy(occ_k, a_tiles, a_occ, a_tiles_n, s);
    if (e == cudaSuccess && bt_occ != a_occ)
      e = occupancy(occ_k, bt_tiles, bt_occ, bt_tiles_n, s);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const size_t smem = 8 * static_cast<size_t>(n_words);
  int grid = 0;
  e = rowbm::row_grid(reinterpret_cast<const void*>(k), smem, n_items, &grid);
  if (e != cudaSuccess) return static_cast<int>(e);
  k<<<grid, kThreads, smem, s>>>(
      static_cast<const int32_t*>(a_ptr), static_cast<const int32_t*>(a_col),
      static_cast<const uint32_t*>(a_tiles),
      static_cast<const int32_t*>(bt_ptr), static_cast<const int32_t*>(bt_col),
      static_cast<const uint32_t*>(bt_tiles),
      static_cast<const int32_t*>(m_col), static_cast<const int32_t*>(m_idx),
      static_cast<const uint32_t*>(m_tiles),
      static_cast<const uint32_t*>(a_occ),
      static_cast<const uint32_t*>(bt_occ),
      static_cast<const int32_t*>(item_row),
      static_cast<const int32_t*>(item_begin),
      static_cast<unsigned long long*>(out), n_items, n_words, count,
      transpose, static_cast<int*>(counter));
  return static_cast<int>(cudaGetLastError());
}

const char* repro_cuda_error_string(int err) {
  if (err == kErrTooWide)
    return "A has more tile columns than the shared-memory bitmap a block "
           "holds (n_cols / tile_dim): use a larger tile_dim or the csr "
           "backend";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
