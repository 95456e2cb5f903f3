// B2SR SpMM kernels for Hopper (sm_90a): the multi-frontier traversal of
// the multi-source engine, the dense SpMM of batched PageRank and of the
// GCN input layer, and the popcount SpMM of the BitGNN hidden layers.
//
// Replace the TPU kernels in src/repro/kernels/spmm/spmm.py:
//   spmm_bbb    <- spmm_bbb_pallas  (Y = A OR.AND F, F packed frontiers)
//   spmm_dense  <- spmm_pallas      (Y = A . X, X a dense float32 matrix)
//   spmm_bbf    <- spmm_bbf_pallas  (Y = A (+).AND XW, XW packed 0/1
//                                    activations, Y int32 counts)
//
// Both walk the B2SR CSR-over-tiles arrays directly: tile_col_idx int32[nT]
// and bit_tiles uint32[nT, t], t in {4, 8, 16, 32}. The TPU kernels needed
// an ELL slab per static shape (one launch per bucket) and a sequential
// grid over the K blocks of a row; here the wrapper cuts every tile-row
// into work items, runs of at most a fixed number of its tiles, and a
// warp takes one item. A hub tile-row (40,500 tiles and 552,282 set bits
// in tile-row 0 of R-MAT scale 21) is then spread over many warps
// instead of setting a floor under every launch, as one warp per
// tile-row does in bmv_bff.
//
// --- spmm_bbb: out[i, r, w] = OR_{tiles k of row i, bits c of A(k)[r]}
//     F[col(k), c, w], then AND mask (or ~mask) ------------------------------
//
// F, mask and out are uint32 [tiles, t, W]: word w packs sources
// 32w .. 32w+31 of a node. A first launch folds F into one word per tile
// column (bit c set iff node c of the column is in any frontier), so a
// tile whose columns hold no frontier bit costs its column index and
// nothing more, as push BFS skips a zero frontier word.
//
// Layout: a warp per item, in two stages, as spmm_bbf since it was
// redesigned, with OR in place of popcount-add:
//   1. Walk and stage. The warp first gathers which bit-rows of its
//      tile-row have an allowed bit in any source word (the mask's words,
//      complemented or not) and drops the item when none has: late in a
//      BFS most of the visited mask is full. It then reads the column
//      indices of kBbbAhead batches of 32 tiles at once, coalesced, and
//      gathers each column's frontier word, all in flight together, so a
//      run of tiles whose columns hold no frontier bit (a sparse frontier)
//      costs two round trips to memory. For the batches with a live tile
//      (a frontier bit in its column), lane l loads 16-byte vectors l,
//      l + 32, ... of the live ones among the 32 tiles, so a warp load
//      covers 512 contiguous bytes where tiles are live. Each word r of a
//      live tile, in an allowed bit-row and ANDed with its column's
//      frontier word, that is not zero becomes an entry in a per-warp
//      stage in shared memory: its tile's first row of F (col * t), r and
//      its bits c; four votes a vector place the entries, where a warp
//      prefix sum per set bit cost three times the instructions (the
//      words of an R-MAT tile hold little more than one bit each).
//   2. Drain. Lanes go over C = min(32, next power of two >= W) source
//      words and the warp's 32 / C lane groups over the staged entries (at
//      W = 2 a warp takes 16 entries a step, two lanes reading the 8
//      bytes of F's row col * t + c together, c an entry's first set bit;
//      its other bits after), kBbbUnroll entries' reads issued before
//      their ORs into the warp's accumulator acc[r][c] with shared-memory
//      atomicOr (an accumulator set per lane group, which needs no
//      atomics but a merge at the end, measured slower: PERF.md).
// The stage is drained when it is full, and at the end of the item. For
// W <= 32 the accumulators hold the item's bits across
// drains and are stored once; for W > 32 every drain makes one pass over
// the staged entries per 32 source words and merges each pass into out,
// so the tiles are read once whatever W is. The store ANDs the allowed
// bits: an item that is its whole tile-row, drained once, stores its
// words; the items of a cut tile-row and the drains of a wide item merge
// with atomicOr into out (zeroed by the wrapper). This is bit-exact
// whatever the order: OR is order-free and the mask distributes over it,
// so each item may mask its own partial.
//
// Bound: device-memory bytes. Counted once: the column indices, the tiles
// whose column holds a frontier bit and whose row an allowed bit, F, the
// mask and out; at R-MAT scale 21 with every tile read (t = 32, W = 2)
// that is about 4.4 GB, 1.3 ms at 3.35 TB/s, against one OR per (set bit,
// source word): about 1.3e8, far below the operation line.
//
// --- spmm_dense: Y[i*t + r, d] = sum_{tiles k of row i, bits c of A(k)[r]}
//     X[col(k)*t + c, d] ---------------------------------------------------
//
// X float32 [n_cols, D] and Y float32 [n_rows, D], any D >= 1, unpadded.
// Layout: a warp per item. The warp walks its item's tiles once, 32 at a
// time (lane j loads tile j's words to count its set bits), and stages
// every set bit (r, c) of tile k as an entry: the row col(k)*t + c of X
// and the bit-row r. A stable counting sort over the t bit-rows then
// groups the entries by r, in shared memory (9 bytes an entry, kStage
// entries a warp; an item with more entries is staged in rounds). Only
// then does the warp loop over column passes: a pass covers 32 * V
// columns, lane l owning columns d0 + l + 32v (v < V), and walks the
// staged entries in order, each one V coalesced 128-byte reads of a row
// of X, several entries' reads issued before their adds. Because the
// entries come grouped by r, a lane sums a bit-row in V registers and
// stores it when the group ends; nothing is accumulated in shared
// memory. The tiles and column indices are thus read once per item
// whatever D is (a version that re-walked them for each chunk of 32
// columns read 45 times the 4.4 GB of tiles at D = 1,433), and the
// launcher picks V from D, so D <= 32 runs one pass of V = 1. Items are
// cut by work (set bits plus one per tile), so that the hub tile-row's
// 552,282 set bits spread over ~270 warps. The TPU kernel contracted
// unpacked 0/1 tiles with X panels on the MXU; at about 2 set bits per
// 1,024-bit tile the tensor cores would multiply zeros.
//
// Float sums must not depend on the order warps finish, so a tile-row
// cut into several items is not merged with atomics: each of its items
// writes its partial sums to a scratch slot, and a second launch adds a
// row's slots in item order. An item of a row that is not cut writes Y
// itself. A round's entries of bit-row r are added in stored order
// (tiles in order, bits by column), a later round's sums added to the
// earlier ones; so the sum order is fixed by the data and the cut alone,
// and the result is the same from run to run. Cutting also shortens the
// chains of float adds (a hub bit-row's ~17,000 terms become ~300
// partials), which keeps the rounding error well inside 1e-5 of the sum
// of |terms|.
//
// Bound: device-memory bytes. Counted once: column indices, every tile
// (X is dense, no tile can be skipped), X and Y; at R-MAT scale 21 with
// D = 32 that is about 4.6 GB, 1.4 ms at 3.35 TB/s, against one add per
// (set bit, column): 2e9 at D = 32, 0.03 ms at 67 TFLOP/s. The kernel
// reads a row of X per set bit: 63.5 M rows at scale 21, 8.1 GB at
// D = 32 and 364 GB at D = 1,433, which L2 serves only in part (X is
// 268 MB at D = 32 and 12 GB at D = 1,433), so it is bound by those
// gathers, and by how many of them are in flight, rather than by the
// bytes above.

//
// --- spmm_bbf: Y[i*t + r, j] = sum_{tiles k of row i}
//     popcount(A(k)[r] & XW[col(k), j]) ----------------------------------
//
// XW uint32[n_tile_cols, D] (a BitMatrix: word [c, j] packs nodes
// c*t .. c*t + t-1 of feature j) and Y int32[n_tile_rows * t, D], any
// D >= 1, unpadded. The TPU kernel gathered XW rows per K block and
// summed popcounts over a [block_r, block_k, t, block_d] slab in VMEM.
// Here a warp takes a work item (a run of tiles of one tile-row) in two
// stages, as spmm_dense does, without its sort (integer counts need
// none):
//   1. Walk and stage. The warp reads its item's tiles 32 at a time,
//      coalesced: lane l loads 16-byte vectors l, l + 32, ... of the 32
//      tiles' t * 32 words, so every warp load covers 512 contiguous
//      bytes and a lane holds t / 4 loads in flight. For each round of
//      32 vectors four votes (one per word of a vector) place every
//      non-zero word in a per-warp stage in shared memory, as the entry
//      (col(k) * t + r, word): an R-MAT tile at t = 32 holds about 1.9
//      set bits in 1,024, so about two entries a tile.
//   2. Drain. Lanes go over C = min(32, next power of two >= D) feature
//      columns and the warp's 32 / C lane groups over the staged
//      entries (at D = 16 the two half-warps take alternate entries).
//      Per entry a lane reads one word of XW (a group reads a row of D
//      words, coalesced; XW is 4.2 MB at scale 21, D = 16, and stays in
//      L2), kBbfUnroll entries' reads issued before their adds, and adds
//      popcount(word & x) into its own accumulator acc[r][lane] in
//      shared memory: each group has its own columns there, so no two
//      lanes touch one word and no atomics are needed.
// The stage is drained when the next round might not fit, and at the end
// of the item. For D <= 32 the accumulators hold the item's sums across
// drains and are written once at the end; for D > 32 every drain makes
// one pass over the staged entries per 32 columns and adds each pass's
// sums into Y, so the tiles are read once whatever D is. At the end the
// groups' accumulators are
// summed and a lane per (r, column) writes the count. The counts are
// integers, so several writes to one row (the items of a cut tile-row,
// the drains of a wide item) merge with atomicAdd into Y (zeroed by the
// wrapper) whatever their order; a row written once is stored directly.
// The wrapper casts Y to the caller's dtype once.
//
// Bound: device-memory bytes. Counted once: row pointers, column
// indices, every tile, XW and Y; at R-MAT scale 21, t = 32, D = 16 that
// is 4.23 GB of tiles, 0.13 GB of column indices and 0.13 GB of Y, about
// 1.34 ms at 3.35 TB/s, against one AND, popcount and add per (non-zero
// tile word, column): about 3e9 at D = 16, 0.04 ms at 67 TOP/s.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr unsigned kFull = 0xffffffffu;
// spmm_dense: warps a block; entries a warp stages per round (9 bytes
// each: the row of X and the bit-row as staged, then the row of X in
// sorted order), so that a block takes 4 * (9 * 640 + 384) = 24,576
// bytes of static shared memory and eight fit in an SM; for each V, the
// entries whose V reads of X a lane issues before their adds, and the
// blocks per SM the kernel asks the compiler for (a register cap of
// 65,536 / (128 * blocks) a thread). At R-MAT scale 21, t = 32 (tools/
// spmm_variants.py on an H100, with reads of X that skipped L1, which
// ran as fast as these: 5.14-5.16 against 5.16-5.17 ms at D = 32, 137.5
// against 137.3 at D = 1,433): D = 32, V = 1 takes 5.14-5.16 ms with 8
// entries in flight, 5.79-5.83 with 16 and 5.41 with 12; D = 1,433
// takes 213.9 ms at V = 1, 173.2 at V = 2, 141.8 at V = 4 and 137.5 at
// V = 8, which deeper loads (6 entries at 4 blocks, 127 registers: 138.0)
// do not beat: the reads of X then run at about 2.7 TB/s. A stage of 512
// entries (10 blocks at V = 1) ran D = 32 in 4.93-4.94 ms but D = 1,433
// in 139.7 (more rounds).
constexpr int kDenseWarps = 4;
constexpr int kDenseThreads = 32 * kDenseWarps;
constexpr int kStage = 640;

// spmm_bbf: warps a block; entries a warp stages (8 bytes each, with
// t * 32 accumulators of 4 bytes: 8 KB a warp at t = 32); entries a lane
// group loads before their adds. On an H100 at R-MAT scale 21, D = 16
// (tools/spmm_variants.py --kernel bbf, items of 256 tiles): stages of
// 128, 256 and 512 entries took 5.20, 4.56 and 3.46 ms (a stage that
// overflows is drained more often, and for D > 32 adds into Y more
// often: 60.0, 41.0 and 19.9 ms at D = 130); 2 and 8 entries in flight
// 5.39 and 8.37 (with spills); one accumulator set for the warp, added
// into with shared-memory atomics, 5.33 (4.00 at stage 512, against
// 3.45 for a set per lane group); 8 warps a block 4.98.
constexpr int kBbfWarps = 4;
constexpr int kBbfThreads = 32 * kBbfWarps;
constexpr int kBbfStage = 512;
constexpr int kBbfUnroll = 4;

// spmm_bbb: warps a block; entries a warp stages (9 bytes each: the
// tile's first row of F, the word and the bit-row, with t * 32
// accumulators of 4 bytes; at least 128, a vector round's most); entries
// a lane group loads before its ORs into the warp's one accumulator set.
// On an H100 at R-MAT scale 21 over an msbfs (auto) of 64 sources
// (tools/spmm_variants.py --kernel bbb, items of 256 tiles): 2 entries in
// flight took 1.19 ms a launch, 4 took 1.87; PERF.md lists the rest.
constexpr int kBbbWarps = 4;
constexpr int kBbbThreads = 32 * kBbbWarps;
constexpr int kBbbStage = 512;
constexpr int kBbbUnroll = 2;
// spmm_bbb: batches of 32 tiles whose column indices and frontier words a
// warp reads at once; blocks an SM should hold (a register cap of 65,536
// / (128 * blocks) a thread).
constexpr int kBbbAhead = 8;
constexpr int kBbbBlocks = 5;

template <int V>
struct DenseTune {
  static constexpr int entries = V == 8 ? 4 : 8;
  static constexpr int blocks = V <= 2 ? 8 : V == 4 ? 6 : 5;
};

template <int T>
__device__ __forceinline__ constexpr uint32_t lane_mask() {
  return T == 32 ? 0xffffffffu : ((1u << T) - 1u);
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

// fnz[col] bit c = some word of F[col, c, :] is non-zero. One thread per
// (col, c) pair; a warp's 32 pairs cover whole columns (32 % T == 0).
template <int T>
__global__ void __launch_bounds__(kThreads)
frontier_columns_kernel(const uint32_t* __restrict__ f,
                        uint32_t* __restrict__ fnz, int64_t n_pairs, int W) {
  const int64_t i = blockIdx.x * static_cast<int64_t>(kThreads) + threadIdx.x;
  uint32_t any = 0;
  if (i < n_pairs) {
    const uint32_t* p = f + i * W;
    for (int w = 0; w < W; ++w) any |= __ldg(p + w);
  }
  const uint32_t bits = __ballot_sync(kFull, any != 0);
  const int lane = threadIdx.x & 31;
  if (i < n_pairs && lane % T == 0) fnz[i / T] = (bits >> lane) & lane_mask<T>();
}

// One warp per item (see the head of this file).
template <int T>
__global__ void __launch_bounds__(kBbbThreads, kBbbBlocks)
spmm_bbb_kernel(const int32_t* __restrict__ col_idx,
                const uint32_t* __restrict__ tiles,
                const int32_t* __restrict__ item_row,
                const int32_t* __restrict__ item_begin,
                const int32_t* __restrict__ item_slot,
                const uint32_t* __restrict__ f,
                const uint32_t* __restrict__ fnz,
                const uint32_t* __restrict__ mask,
                uint32_t* __restrict__ out, int n_items, int W, int C,
                int complement) {
  constexpr int U = kBbbUnroll;
  constexpr int kVecs = T / 4;  // 16-byte vectors a tile holds
  __shared__ uint32_t acc_all[kBbbWarps][T * 32];
  __shared__ int32_t frow_all[kBbbWarps][kBbbStage];   // col * T
  __shared__ uint32_t word_all[kBbbWarps][kBbbStage];  // the word's bits c
  __shared__ uint8_t r_all[kBbbWarps][kBbbStage];
  __shared__ int32_t col_all[kBbbWarps][32 * kBbbAhead];  // col * T
  __shared__ uint32_t fz_all[kBbbWarps][32 * kBbbAhead];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int item = blockIdx.x * kBbbWarps + warp;
  if (item >= n_items) return;  // uniform across the warp
  uint32_t* acc = acc_all[warp];
  int32_t* s_frow = frow_all[warp];
  uint32_t* s_word = word_all[warp];
  uint8_t* s_r = r_all[warp];
  int32_t* s_col = col_all[warp];
  uint32_t* s_fz = fz_all[warp];
  const int row = item_row[item];
  const int k0 = item_begin[item];
  const int k1 = item_begin[item + 1];
  const bool cut = item_slot[item] >= 0;
  const int64_t base = static_cast<int64_t>(row) * T * W;  // (row, 0, 0)
  // bit-rows with an allowed source in any word
  uint32_t arow = lane_mask<T>();
  if (mask != nullptr) {
    uint32_t part = 0;
    for (int e = lane; e < T * W; e += 32) {
      const uint32_t m = mask[base + e];
      if (complement ? ~m : m) part |= 1u << (e / W);
    }
    arow = __reduce_or_sync(kFull, part);
    if (arow == 0) return;  // uniform: nothing of this item can land
  }
  const int groups = 32 / C;
  const int group = lane / C;
  const int c = lane - group * C;
  const bool one_chunk = W <= C;
  int fill = 0;          // entries staged
  bool written = false;  // this item has merged into out already

  auto zero_acc = [&]() {
#pragma unroll
    for (int r = 0; r < T; ++r) acc[r * 32 + lane] = 0;
    __syncwarp();
  };
  // ORs the staged entries' rows of F, source words w0 .. w0 + C - 1: an
  // entry's first set bit in the unrolled reads, its others (rare) after
  auto drain = [&](int w0) {
    const int j = w0 + c;
    const bool live = j < W;
    for (int e0 = group; e0 < fill; e0 += groups * U) {
      uint32_t x[U], rest[U];
      int r[U], frow[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int e = e0 + groups * u;
        const bool ok = e < fill;
        const uint32_t word = ok ? s_word[e] : 0u;
        r[u] = ok ? s_r[e] : 0;
        frow[u] = ok ? s_frow[e] : 0;
        rest[u] = live ? word & (word - 1) : 0u;
        x[u] = word != 0 && live
                   ? __ldg(f + static_cast<int64_t>(frow[u] + __ffs(word) - 1)
                                   * W + j)
                   : 0u;
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        for (uint32_t bits = rest[u]; bits; bits &= bits - 1)
          x[u] |= __ldg(f + static_cast<int64_t>(frow[u] + __ffs(bits) - 1)
                                * W + j);
        if (x[u] == 0) continue;
        atomicOr(acc + r[u] * 32 + c, x[u]);
      }
    }
    __syncwarp();
  };
  // the accumulators' words w0 .. w0 + C - 1, masked, into out
  auto write = [&](int w0, bool merge) {
    for (int e = lane; e < T * C; e += 32) {
      const int r = e / C;
      const int cc = e - r * C;
      if (w0 + cc >= W || !((arow >> r) & 1u)) continue;
      uint32_t v = acc[r * 32 + cc];
      if (v == 0) continue;  // out is zeroed
      const int64_t o = base + static_cast<int64_t>(r) * W + w0 + cc;
      if (mask != nullptr) {
        const uint32_t m = mask[o];
        v &= complement ? ~m : m;
      }
      if (v == 0) continue;
      if (merge) atomicOr(out + o, v);
      else out[o] = v;
    }
    __syncwarp();  // acc is read before it is cleared again
  };
  // drains the stage; the item's last call stores what is left
  auto flush = [&](bool last) {
    __syncwarp();  // the staged entries are visible to every lane
    if (one_chunk) {
      drain(0);
      if (last) write(0, cut || written);
    } else {
      for (int w0 = 0; w0 < W; w0 += C) {
        zero_acc();
        drain(w0);
        write(w0, cut || written || !last);
      }
      written = true;
    }
    fill = 0;
  };

  if (one_chunk) zero_acc();
  for (int kb0 = k0; kb0 < k1; kb0 += 32 * kBbbAhead) {
    // the column indices and frontier words of kBbbAhead batches of 32
    // tiles, all read at once (a sparse frontier skips most batches)
    int cols[kBbbAhead];
    uint32_t fzs[kBbbAhead];
#pragma unroll
    for (int a = 0; a < kBbbAhead; ++a) {
      const int k = kb0 + 32 * a + lane;
      cols[a] = k < k1 ? __ldg(col_idx + k) : 0;
    }
#pragma unroll
    for (int a = 0; a < kBbbAhead; ++a) {
      const int k = kb0 + 32 * a + lane;
      fzs[a] = k < k1 ? __ldg(fnz + cols[a]) : 0u;
    }
    uint32_t busy = 0;  // bit a: batch a holds a live tile (uniform)
#pragma unroll
    for (int a = 0; a < kBbbAhead; ++a) {
      s_col[32 * a + lane] = cols[a] * T;
      s_fz[32 * a + lane] = fzs[a];
      busy |= static_cast<uint32_t>(__any_sync(kFull, fzs[a] != 0)) << a;
    }
    __syncwarp();
    for (; busy; busy &= busy - 1) {  // uniform
      const int a = __ffs(busy) - 1;
      // the batch's live tiles (a frontier bit in their column): lane l
      // loads 16-byte vectors l, l + 32, ... of them
      const uint32_t live = __ballot_sync(kFull, s_fz[32 * a + lane] != 0);
      const uint4* vbase = reinterpret_cast<const uint4*>(
          tiles + static_cast<int64_t>(kb0 + 32 * a) * T);
      uint4 v[kVecs];
#pragma unroll
      for (int q = 0; q < kVecs; ++q) {
        const int i = lane + 32 * q;  // vector i holds words 4i .. 4i + 3
        v[q] = (live >> (i / kVecs)) & 1u ? __ldg(vbase + i)
                                          : make_uint4(0, 0, 0, 0);
      }
#pragma unroll
      for (int q = 0; q < kVecs; ++q) {
        const int i = lane + 32 * q;
        const int tile = 32 * a + i / kVecs;
        const uint32_t tfz = s_fz[tile];  // 0 for a tile that is not live
        const int frow0 = s_col[tile];
        const int r0 = (4 * i) % T;  // the vector's first bit-row
        uint32_t w[4] = {v[q].x, v[q].y, v[q].z, v[q].w};
        // the vectors' non-zero words go in order of (word b, lane): four
        // votes place them
        uint32_t nz[4];
        int total = 0;
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          w[b] = (arow >> (r0 + b)) & 1u ? w[b] & tfz : 0u;
          nz[b] = __ballot_sync(kFull, w[b] != 0);
          total += __popc(nz[b]);
        }
        if (total == 0) continue;  // uniform
        if (fill + total > kBbbStage) flush(false);
        int at = fill;
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          if (w[b]) {
            const int e = at + __popc(nz[b] & ((1u << lane) - 1u));
            s_frow[e] = frow0;
            s_word[e] = w[b];
            s_r[e] = static_cast<uint8_t>(r0 + b);
          }
          at += __popc(nz[b]);
        }
        fill += total;
      }
    }
    __syncwarp();  // s_col and s_fz are written again for the next run
  }
  flush(true);
}

// One warp per item (see the head of this file). Round by round, the
// warp stages the set bits of its tiles as (row of X, bit-row r) in tile
// order and counts them per bit-row; sorts the rows of X stably by r;
// then runs the column passes over them, each lane summing a bit-row's
// entries for its V columns in registers. The first round stores its
// sums (zeros for a bit-row without entries in a scratch slot; Y is
// zeroed by the wrapper), a later one adds to them.
template <int T, int V>
__global__ void __launch_bounds__(kDenseThreads, DenseTune<V>::blocks)
spmm_dense_kernel(const int32_t* __restrict__ col_idx,
                  const uint32_t* __restrict__ tiles,
                  const int32_t* __restrict__ item_row,
                  const int32_t* __restrict__ item_begin,
                  const int32_t* __restrict__ item_slot,
                  const float* __restrict__ x, float* __restrict__ scratch,
                  float* __restrict__ y, int n_items, int n_rows, int D) {
  constexpr int U = DenseTune<V>::entries;
  __shared__ int32_t staged_x_all[kDenseWarps][kStage];
  __shared__ uint8_t staged_r_all[kDenseWarps][kStage];
  __shared__ int32_t sorted_x_all[kDenseWarps][kStage];
  __shared__ int32_t count_all[kDenseWarps][32];
  __shared__ int32_t end_all[kDenseWarps][32];
  __shared__ int32_t next_all[kDenseWarps][32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int item = blockIdx.x * kDenseWarps + warp;
  if (item >= n_items) return;  // uniform across the warp
  int32_t* s_xu = staged_x_all[warp];
  uint8_t* s_ru = staged_r_all[warp];
  int32_t* s_x = sorted_x_all[warp];
  int32_t* count = count_all[warp];
  int32_t* end = end_all[warp];
  int32_t* next = next_all[warp];
  const int row = item_row[item];
  const int k0 = item_begin[item];
  const int k1 = item_begin[item + 1];
  const int slot = item_slot[item];
  // bit-row r of this item lands at out[r * D]; Y's last tile-row may
  // hold fewer than T rows
  float* out = slot < 0 ? y + static_cast<int64_t>(row) * T * D
                        : scratch + static_cast<int64_t>(slot) * T * D;
  const int n_r = slot < 0 ? min(T, n_rows - row * T) : T;
  count[lane] = 0;
  __syncwarp();
  int fill = 0;  // entries staged in this round
  int round = 0;

  auto run_round = [&]() {
    // bucket r holds sorted places [end[r] - count[r], end[r])
    const int cnt = count[lane];
    int off = cnt;
#pragma unroll
    for (int s = 1; s < 32; s *= 2) {
      const int v = __shfl_up_sync(kFull, off, s);
      if (lane >= s) off += v;
    }
    end[lane] = off;
    next[lane] = off - cnt;
    __syncwarp();
    // stable scatter, 32 staged entries at a time: lanes with the same r
    // take consecutive places in lane order
    for (int e0 = 0; e0 < fill; e0 += 32) {
      const int e = e0 + lane;
      const int r = e < fill ? s_ru[e] : -1;
      const unsigned peers = __match_any_sync(kFull, r);
      const int rank = __popc(peers & ((1u << lane) - 1u));
      const int pos = r >= 0 ? next[r] + rank : 0;
      __syncwarp();
      if (r >= 0) {
        if (rank == 0) next[r] += __popc(peers);
        s_x[pos] = s_xu[e];
      }
      __syncwarp();
    }
    int first = 0;  // the first bit-row with entries (uniform)
    while (first < T - 1 && count[first] == 0) ++first;
    for (int d0 = 0; d0 < D; d0 += 32 * V) {
      const int dl = d0 + lane;
      float acc[V];
#pragma unroll
      for (int j = 0; j < V; ++j) acc[j] = 0.0f;
      int cur = first;
      int stop = end[cur];
      auto emit = [&]() {  // bit-row cur's sums, then the next bit-row
        float* o = out + static_cast<int64_t>(cur) * D + dl;
#pragma unroll
        for (int j = 0; j < V; ++j) {
          if (cur < n_r && dl + 32 * j < D) {
            if (round == 0) o[32 * j] = acc[j];
            else o[32 * j] += acc[j];
          }
          acc[j] = 0.0f;
        }
        if (cur == T - 1) return;  // the last bit-row: no next one
        do ++cur; while (cur < T - 1 && count[cur] == 0);
        stop = end[cur];
      };
      for (int e = 0; e < fill; e += U) {
        float v[U][V];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const bool ok = e + u < fill;
          const float* p =
              x + static_cast<int64_t>(ok ? s_x[e + u] : 0) * D + dl;
#pragma unroll
          for (int j = 0; j < V; ++j)
            v[u][j] = ok && dl + 32 * j < D ? __ldg(p + 32 * j) : 0.0f;
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          if (e + u < fill) {  // uniform, as are cur and stop
            if (e + u == stop) emit();
#pragma unroll
            for (int j = 0; j < V; ++j) acc[j] += v[u][j];
          }
        }
      }
      if (fill) emit();
      if (round == 0 && slot >= 0) {  // a slot's bit-rows without entries
        for (int r = 0; r < T; ++r) {
          if (count[r]) continue;
          float* o = out + static_cast<int64_t>(r) * D + dl;
#pragma unroll
          for (int j = 0; j < V; ++j)
            if (dl + 32 * j < D) o[32 * j] = 0.0f;
        }
      }
    }
    __syncwarp();  // the entries and counts are read before the next round
    count[lane] = 0;
    __syncwarp();
    fill = 0;
    ++round;
  };

  for (int kb = k0; kb < k1; kb += 32) {
    const int k = kb + lane;
    const uint4* tile4 = reinterpret_cast<const uint4*>(
        tiles + static_cast<int64_t>(k < k1 ? k : k0) * T);
    int p = 0, xbase = 0;
    uint32_t nz = 0;  // bit r: word r of the tile is not zero
    if (k < k1) {
      xbase = __ldg(col_idx + k) * T;
#pragma unroll
      for (int q = 0; q < T / 4; ++q) {
        const uint4 w4 = __ldg(tile4 + q);
        p += __popc(w4.x) + __popc(w4.y) + __popc(w4.z) + __popc(w4.w);
        nz |= (static_cast<uint32_t>(w4.x != 0) |
               static_cast<uint32_t>(w4.y != 0) << 1 |
               static_cast<uint32_t>(w4.z != 0) << 2 |
               static_cast<uint32_t>(w4.w != 0) << 3) << (4 * q);
      }
    }
    int off = p;  // inclusive prefix sum of the entry counts
#pragma unroll
    for (int s = 1; s < 32; s *= 2) {
      const int v = __shfl_up_sync(kFull, off, s);
      if (lane >= s) off += v;
    }
    const int total = __shfl_sync(kFull, off, 31);
    off -= p;
    // stage the batch's entries [base, base + take) at fill onwards; a
    // full stage runs a round first
    for (int base = 0; base < total;) {
      const int take = min(total - base, kStage - fill);
      if (take == 0) {
        run_round();
        continue;
      }
      if (p && off < base + take && off + p > base) {
        // the non-zero words are read again (from L1) rather than held
        // in t registers, which at t = 32 cost occupancy and spills
        int e = off - base;
        for (uint32_t wm = nz; wm; wm &= wm - 1) {
          const int r = __ffs(wm) - 1;
          uint32_t bits = __ldg(tiles + static_cast<int64_t>(k) * T + r);
          const int n = __popc(bits);
          const int lo = max(e, 0), hi = min(e + n, take);
          if (hi > lo) atomicAdd(count + r, hi - lo);
          if (e >= take) break;  // the rest lies past the stage
          if (e + n <= 0) {
            e += n;
            continue;
          }
          while (bits) {
            const int c = __ffs(bits) - 1;
            bits &= bits - 1;
            if (e >= 0 && e < take) {
              s_xu[fill + e] = xbase + c;
              s_ru[fill + e] = static_cast<uint8_t>(r);
            }
            ++e;
          }
        }
      }
      __syncwarp();
      fill += take;
      base += take;
    }
  }
  if (fill || round == 0) run_round();
}

// Y rows of a cut tile-row: its items' partials added in item order. One
// thread per (cut row, bit-row r, column d).
template <int T>
__global__ void __launch_bounds__(kThreads)
spmm_dense_merge_kernel(const int32_t* __restrict__ cut_row,
                        const int32_t* __restrict__ cut_first,
                        const int32_t* __restrict__ cut_count,
                        const float* __restrict__ scratch,
                        float* __restrict__ y, int64_t n_cells, int n_rows,
                        int D) {
  const int64_t i = blockIdx.x * static_cast<int64_t>(kThreads) + threadIdx.x;
  if (i >= n_cells) return;
  const int d = static_cast<int>(i % D);
  const int64_t rr = i / D;
  const int r = static_cast<int>(rr % T);
  const int64_t c = rr / T;
  const int64_t yr = static_cast<int64_t>(cut_row[c]) * T + r;
  if (yr >= n_rows) return;
  const int64_t first = cut_first[c];
  float s = 0.0f;
  for (int p = 0; p < cut_count[c]; ++p)
    s += scratch[((first + p) * T + r) * D + d];
  y[yr * D + d] = s;
}

// One warp per item (see the head of this file).
template <int T>
__global__ void __launch_bounds__(kBbfThreads)
spmm_bbf_kernel(const int32_t* __restrict__ col_idx,
                const uint32_t* __restrict__ tiles,
                const int32_t* __restrict__ item_row,
                const int32_t* __restrict__ item_begin,
                const int32_t* __restrict__ item_slot,
                const uint32_t* __restrict__ xw, int32_t* __restrict__ y,
                int n_items, int D, int C) {
  constexpr int U = kBbfUnroll;
  constexpr int kVecs = T / 4;  // 16-byte vectors a lane loads per batch
  __shared__ int32_t acc_all[kBbfWarps][T * 32];
  __shared__ uint32_t key_all[kBbfWarps][kBbfStage];   // col * T + r
  __shared__ uint32_t word_all[kBbfWarps][kBbfStage];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int item = blockIdx.x * kBbfWarps + warp;
  if (item >= n_items) return;  // uniform across the warp
  int32_t* acc = acc_all[warp];
  uint32_t* s_key = key_all[warp];
  uint32_t* s_word = word_all[warp];
  const int row = item_row[item];
  const int k0 = item_begin[item];
  const int k1 = item_begin[item + 1];
  const bool cut = item_slot[item] >= 0;
  const int groups = 32 / C;
  const int group = lane / C;
  const int c = lane - group * C;
  const bool one_chunk = D <= C;
  int fill = 0;          // entries staged
  bool written = false;  // this item has added to Y already

  auto zero_acc = [&]() {
#pragma unroll
    for (int r = 0; r < T; ++r) acc[r * 32 + lane] = 0;
    __syncwarp();
  };
  // adds the staged entries' counts for columns d0 .. d0 + C - 1
  auto drain = [&](int d0) {
    const int j = d0 + c;
    const bool live = j < D;
    for (int e0 = group; e0 < fill; e0 += groups * U) {
      uint32_t x[U], w[U], key[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int e = e0 + groups * u;
        const bool ok = e < fill;
        key[u] = ok ? s_key[e] : 0u;
        w[u] = ok ? s_word[e] : 0u;
        x[u] = ok && live
                   ? __ldg(xw + static_cast<int64_t>(key[u] / T) * D + j)
                   : 0u;
      }
#pragma unroll
      for (int u = 0; u < U; ++u)  // a lane's own accumulator: no atomics
        if (e0 + groups * u < fill)
          acc[(key[u] % T) * 32 + lane] += __popc(w[u] & x[u]);
    }
    __syncwarp();
  };
  // the accumulators' counts for columns d0 .. d0 + C - 1 into Y
  auto write = [&](int d0, bool atomic) {
    for (int e = lane; e < T * C; e += 32) {
      const int r = e / C;
      const int cc = e - r * C;
      if (d0 + cc >= D) continue;
      int32_t s = 0;
      for (int g = 0; g < groups; ++g) s += acc[r * 32 + g * C + cc];
      if (s == 0) continue;  // Y is zeroed
      int32_t* o = y + (static_cast<int64_t>(row) * T + r) * D + d0 + cc;
      if (atomic) atomicAdd(o, s);
      else *o = s;
    }
    __syncwarp();  // acc is read before it is cleared again
  };
  // drains the stage; the item's last call writes what is left
  auto flush = [&](bool last) {
    __syncwarp();  // the staged entries are visible to every lane
    if (one_chunk) {
      drain(0);
      if (last) write(0, cut);
    } else {
      for (int d0 = 0; d0 < D; d0 += C) {
        zero_acc();
        drain(d0);
        write(d0, cut || written || !last);
      }
      written = true;
    }
    fill = 0;
  };

  if (one_chunk) zero_acc();
  for (int kb = k0; kb < k1; kb += 32) {
    const int nt = min(32, k1 - kb);  // tiles in this batch
    const int col = lane < nt ? __ldg(col_idx + kb + lane) : 0;
    const uint4* base =
        reinterpret_cast<const uint4*>(tiles + static_cast<int64_t>(kb) * T);
    uint4 v[kVecs];
#pragma unroll
    for (int q = 0; q < kVecs; ++q) {
      const int i = lane + 32 * q;  // vector i holds words 4i .. 4i + 3
      v[q] = i < nt * kVecs ? __ldg(base + i) : make_uint4(0, 0, 0, 0);
    }
    const uint32_t below = (1u << lane) - 1u;  // the lanes before this one
#pragma unroll
    for (int q = 0; q < kVecs; ++q) {
      const int i = lane + 32 * q;
      const uint32_t w[4] = {v[q].x, v[q].y, v[q].z, v[q].w};
      // the round's entries go in order of (word b of the vector, lane):
      // four votes place them, with no chain of shuffles
      uint32_t nz[4];
      int total = 0;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        nz[b] = __ballot_sync(kFull, w[b] != 0);
        total += __popc(nz[b]);
      }
      // the column index of the tile this vector lies in
      const uint32_t key0 =
          static_cast<uint32_t>(__shfl_sync(kFull, col, i / kVecs)) * T +
          (4 * i) % T;
      if (total == 0) continue;  // uniform
      if (fill + total > kBbfStage) flush(false);
      int base = fill;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        if (w[b]) {
          const int off = base + __popc(nz[b] & below);
          s_key[off] = key0 + b;
          s_word[off] = w[b];
        }
        base += __popc(nz[b]);
      }
      fill += total;
    }
  }
  flush(true);
}

using BbbKernel = void (*)(const int32_t*, const uint32_t*, const int32_t*,
                           const int32_t*, const int32_t*, const uint32_t*,
                           const uint32_t*, const uint32_t*, uint32_t*, int,
                           int, int, int);
using ColsKernel = void (*)(const uint32_t*, uint32_t*, int64_t, int);
using DenseKernel = void (*)(const int32_t*, const uint32_t*, const int32_t*,
                             const int32_t*, const int32_t*, const float*,
                             float*, float*, int, int, int);
using MergeKernel = void (*)(const int32_t*, const int32_t*, const int32_t*,
                             const float*, float*, int64_t, int, int);

using BbfKernel = void (*)(const int32_t*, const uint32_t*, const int32_t*,
                           const int32_t*, const int32_t*, const uint32_t*,
                           int32_t*, int, int, int);

BbfKernel bbf_for(int t) {
  switch (t) {
    case 4: return spmm_bbf_kernel<4>;
    case 8: return spmm_bbf_kernel<8>;
    case 16: return spmm_bbf_kernel<16>;
    case 32: return spmm_bbf_kernel<32>;
    default: return nullptr;
  }
}

BbbKernel bbb_for(int t) {
  switch (t) {
    case 4: return spmm_bbb_kernel<4>;
    case 8: return spmm_bbb_kernel<8>;
    case 16: return spmm_bbb_kernel<16>;
    case 32: return spmm_bbb_kernel<32>;
    default: return nullptr;
  }
}

ColsKernel cols_for(int t) {
  switch (t) {
    case 4: return frontier_columns_kernel<4>;
    case 8: return frontier_columns_kernel<8>;
    case 16: return frontier_columns_kernel<16>;
    case 32: return frontier_columns_kernel<32>;
    default: return nullptr;
  }
}

template <int V>
DenseKernel dense_for_v(int t) {
  switch (t) {
    case 4: return spmm_dense_kernel<4, V>;
    case 8: return spmm_dense_kernel<8, V>;
    case 16: return spmm_dense_kernel<16, V>;
    case 32: return spmm_dense_kernel<32, V>;
    default: return nullptr;
  }
}

DenseKernel dense_for(int t, int v) {
  switch (v) {
    case 1: return dense_for_v<1>(t);
    case 2: return dense_for_v<2>(t);
    case 4: return dense_for_v<4>(t);
    case 8: return dense_for_v<8>(t);
    default: return nullptr;
  }
}

MergeKernel merge_for(int t) {
  switch (t) {
    case 4: return spmm_dense_merge_kernel<4>;
    case 8: return spmm_dense_merge_kernel<8>;
    case 16: return spmm_dense_merge_kernel<16>;
    case 32: return spmm_dense_merge_kernel<32>;
    default: return nullptr;
  }
}

unsigned blocks_for(int64_t n, int per_block) {
  return static_cast<unsigned>((n + per_block - 1) / per_block);
}

}  // namespace

extern "C" {

// fnz: uint32[n_tile_cols] scratch; out: uint32[R, t, W], zeroed by the
// caller; mask may be null (keep every bit). Item i is the tiles
// [item_begin[i], item_begin[i + 1]) of tile-row item_row[i]; item_slot[i]
// >= 0 marks an item of a cut row.
int spmm_bbb(const void* col_idx, const void* tiles, const void* item_row,
             const void* item_begin, const void* item_slot, int n_items,
             const void* f, void* fnz, const void* mask, void* out,
             int n_tile_cols, int W, int t, int complement, void* stream) {
  const BbbKernel k = bbb_for(t);
  const ColsKernel kc = cols_for(t);
  if (k == nullptr || kc == nullptr || W <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_items <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t n_pairs = static_cast<int64_t>(n_tile_cols) * t;
  kc<<<blocks_for(n_pairs, kThreads), kThreads, 0, s>>>(
      static_cast<const uint32_t*>(f), static_cast<uint32_t*>(fnz), n_pairs,
      W);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  int C = 1;
  while (C < W && C < 32) C *= 2;
  k<<<blocks_for(n_items, kBbbWarps), kBbbThreads, 0, s>>>(
      static_cast<const int32_t*>(col_idx), static_cast<const uint32_t*>(tiles),
      static_cast<const int32_t*>(item_row),
      static_cast<const int32_t*>(item_begin),
      static_cast<const int32_t*>(item_slot), static_cast<const uint32_t*>(f),
      static_cast<const uint32_t*>(fnz), static_cast<const uint32_t*>(mask),
      static_cast<uint32_t*>(out), n_items, W, C, complement);
  return static_cast<int>(cudaGetLastError());
}

// y: float32[n_rows, D], zeroed by the caller (rows without tiles stay 0);
// scratch: float32[n_slots, t, D] for the items of cut rows; v: columns a
// lane takes per pass (1, 2, 4 or 8).
int spmm_dense(const void* col_idx, const void* tiles, const void* item_row,
               const void* item_begin, const void* item_slot, int n_items,
               const void* cut_row, const void* cut_first,
               const void* cut_count, int n_cut, const void* x, void* scratch,
               void* y, int n_rows, int D, int t, int v, void* stream) {
  const DenseKernel k = dense_for(t, v);
  const MergeKernel km = merge_for(t);
  if (k == nullptr || km == nullptr || D <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_items <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  k<<<blocks_for(n_items, kDenseWarps), kDenseThreads, 0, s>>>(
      static_cast<const int32_t*>(col_idx), static_cast<const uint32_t*>(tiles),
      static_cast<const int32_t*>(item_row),
      static_cast<const int32_t*>(item_begin),
      static_cast<const int32_t*>(item_slot), static_cast<const float*>(x),
      static_cast<float*>(scratch), static_cast<float*>(y), n_items, n_rows,
      D);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_cut <= 0) return static_cast<int>(err);
  const int64_t n_cells = static_cast<int64_t>(n_cut) * t * D;
  km<<<blocks_for(n_cells, kThreads), kThreads, 0, s>>>(
      static_cast<const int32_t*>(cut_row),
      static_cast<const int32_t*>(cut_first),
      static_cast<const int32_t*>(cut_count),
      static_cast<const float*>(scratch), static_cast<float*>(y), n_cells,
      n_rows, D);
  return static_cast<int>(cudaGetLastError());
}

// y: int32[n_tile_rows * t, D], zeroed by the caller (rows without tiles
// stay 0); xw: uint32[n_tile_cols, D].
int spmm_bbf(const void* col_idx, const void* tiles, const void* item_row,
             const void* item_begin, const void* item_slot, int n_items,
             const void* xw, void* y, int D, int t, void* stream) {
  const BbfKernel k = bbf_for(t);
  if (k == nullptr || D <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n_items <= 0) return 0;
  int C = 1;
  while (C < D && C < 32) C *= 2;
  k<<<blocks_for(n_items, kBbfWarps), kBbfThreads, 0,
      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(col_idx), static_cast<const uint32_t*>(tiles),
      static_cast<const int32_t*>(item_row),
      static_cast<const int32_t*>(item_begin),
      static_cast<const int32_t*>(item_slot), static_cast<const uint32_t*>(xw),
      static_cast<int32_t*>(y), n_items, D, C);
  return static_cast<int>(cudaGetLastError());
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
