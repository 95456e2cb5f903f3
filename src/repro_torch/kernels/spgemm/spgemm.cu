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
// is B2SR directly, in three passes (count and fill once per row list).
//
//   window: packs each of B's tiles' row occupancy into a word (bit k:
//          word k is not zero), finds each tile-row's bitmap window: the
//          words from the first to the last column of B's rows that its
//          tiles reach (a road grid's rows reach 5 of 4,096 words), and
//          sorts the tile-rows into two lists by their (A tile, B tile)
//          pairs: heavy rows (at least `heavy` pairs) and light ones. The
//          two passes below run once for each list that is not empty, a
//          list's bitmaps as wide as its widest window: many warps a
//          block for heavy rows, one warp for light ones (and fewer
//          slots), so a hub row among short rows gets a wide block and
//          the short rows stay small.
//   count: a block per tile-row of the list (taken from a global counter) marks
//          the tile columns J of the pairs (A(I,X), B(X,J)) that meet in
//          a shared-memory bitmap (row_bitmap.cuh; with a keep mask, only
//          the mask row's columns count) and writes their number: C's row
//          I has at most that many tiles, exactly that many without a
//          mask. An exclusive scan of the counts (outside) lays C out.
//   fill:  the block marks the same columns, ranks them (prefix popcount
//          over the marked words only) and builds C's tile-row in shared
//          memory: a slot of t words for each marked column, at its rank,
//          so C's rows come out sorted. The warps transpose the tiles of A
//          (at[c]: the rows r whose word r holds bit c; a butterfly of
//          shuffles); a thread's pair reads the words k of B(X, J) where
//          the two occupancies meet (16-byte vectors, several in flight:
//          a road grid's pair reads ~13 words) and ORs each into slot word
//          r for each r in at[k] with shared-memory atomicOr (skipped when
//          the bits are set already). At the end of the row t / 4 lanes
//          per slot (16 bytes a lane) AND in the slot's mask tile (or its
//          complement; found by one walk of the mask row) and store the
//          slot with plain coalesced stores, its column index and a flag:
//          the tile is not zero. The block also writes the row's non-zero
//          tiles and set bits.
//
// A pair adds to C(I, J) only where A(I,X)'s column occupancy (the OR of
// its words) meets B(X,J)'s row occupancy: on R-MAT scale 16 that holds
// for 124 M of the 272 M pairs, and they read 237 M words of B where every
// set bit of A would read 1.6 G. Both passes walk the row's tiles of A in
// runs of up to 32: warp 0 reads a run's column indices, B's row bounds
// and the tiles' column occupancies in one go (a prefix sum lays out the
// run's pairs), and the block's threads then take the run's pairs,
// consecutive threads on consecutive tiles of B. So a short row (a road
// grid's: 5 tiles of A, 25 pairs) costs a few round trips to memory, not
// a chain of them per tile of A.
//
// A row with more slots than the room holds is built in rounds of slot
// ranges: each round walks A's row again and skips the pairs whose rank
// lies outside it. The wrapper caps a round at the widest row of the
// list, sets the pairs that make a row heavy and each list's block shape
// (tools/spgemm_variants.py: a road grid's rows are all light, blocks of
// one warp; R-MAT's nearly all heavy, blocks of 32 warps), and orders the
// heavy list by pairs, most first, so that no hub row starts last.
// With no tile of C zero (A² without a mask) the output is C as it
// stands; otherwise the wrapper keeps the flagged slots. Nothing zeroes
// C's tiles beforehand and nothing scans them afterwards.
//
// Room: the fill pass holds the bitmap and its rank array (8 bytes per
// 32 tile columns of the widest window), the run's transposed tiles of A
// (4t bytes a tile) and 4t + 8 bytes a slot. Up to rowbm::kMaxWords
// bitmap words (913,408 tile columns) are accepted; where a row's window
// is that wide the bitmap leaves ~3.4 KB, so the launcher halves the
// fill's runs of A's tiles until at least kMinSlots slots fit (at the
// limit and t = 32: runs of 16 tiles, 10 slots a round), and a dense row
// then takes many rounds: slow, but every accepted width runs and is
// right.
//
// Bound: device-memory bytes for A, B, the mask and C once; the work is
// one OR per (set bit of A(I,X), tile B(X,J)) pair, a few per pair on
// R-MAT, far below the operation line.

#include "../row_bitmap.cuh"

namespace {

using rowbm::kFull;

enum MaskMode { kNoMask = 0, kKeep = 1, kComplement = 2 };

// Fewest slots a round of the fill pass must hold.
constexpr int kMinSlots = 8;

template <int T>
__device__ __forceinline__ constexpr uint32_t lane_mask() {
  return T == 32 ? 0xffffffffu : ((1u << T) - 1u);
}

// occ[q] bit k = (tiles[q][k] != 0). One thread per word; a warp's 32
// words cover whole tiles (32 % T == 0).
template <int T>
__global__ void __launch_bounds__(256)
occupancy_kernel(const uint32_t* __restrict__ tiles,
                 uint32_t* __restrict__ occ, int64_t n_words) {
  const int64_t i = blockIdx.x * 256LL + threadIdx.x;
  const uint32_t w = i < n_words ? __ldg(tiles + i) : 0u;
  const uint32_t nz = __ballot_sync(kFull, w != 0);
  const int lane = threadIdx.x & 31;
  if (i < n_words && lane % T == 0) occ[i / T] = (nz >> lane) & lane_mask<T>();
}

// Row I's window (lo, hi: the first and last bitmap word its tiles of A
// reach through B's rows X, which are sorted) and its pairs (the sum of
// B's row lengths over A's tiles (I, X)) over A's tiles k0, k0 + step, ...
// below k1.
__device__ __forceinline__ void scan_row(const int32_t* __restrict__ a_col,
                                         const int32_t* __restrict__ b_ptr,
                                         const int32_t* __restrict__ b_col,
                                         int k0, int k1, int step, int& lo,
                                         int& hi, int64_t& pairs) {
#pragma unroll 4
  for (int k = k0; k < k1; k += step) {
    const int x = __ldg(a_col + k);
    const int q0 = __ldg(b_ptr + x), q1 = __ldg(b_ptr + x + 1);
    if (q0 < q1) {
      lo = min(lo, __ldg(b_col + q0) >> 5);
      hi = max(hi, __ldg(b_col + q1 - 1) >> 5);
      pairs += q1 - q0;
    }
  }
}

// Rows a thread of window_kernel scans alone; a longer row is scanned by
// its warp.
constexpr int kLaneTiles = 32;

// Each tile-row's window and pairs: row_lo[I] = its first word,
// row_pairs[I] = its pairs. Row I goes to the heavy list rows[0, plan[2])
// when it has at least `heavy` pairs, else to the light list rows[n_rows,
// n_rows + plan[3]), and plan[0] (heavy) or plan[1] (light) rises to the
// row's words; a warp appends its rows of a list in one go. kWarp (long
// rows on average): a warp per row. Else a thread per row, the rows of
// more than kLaneTiles tiles scanned by the whole warp in turn, so a hub
// row among short ones is not one thread's loop.
template <bool kWarp>
__global__ void __launch_bounds__(256)
window_kernel(const int32_t* __restrict__ a_ptr,
              const int32_t* __restrict__ a_col,
              const int32_t* __restrict__ b_ptr,
              const int32_t* __restrict__ b_col, int32_t* __restrict__ row_lo,
              int64_t* __restrict__ row_pairs, int* __restrict__ plan,
              int32_t* __restrict__ rows, int n_rows, int64_t heavy) {
  const int lane = threadIdx.x & 31;
  const int row = kWarp ? blockIdx.x * 8 + (threadIdx.x >> 5)
                        : blockIdx.x * 256 + threadIdx.x;
  // the thread that writes the row: every thread, or a warp's lane 0
  const bool owner = row < n_rows && (!kWarp || lane == 0);
  const int a0 = row < n_rows ? a_ptr[row] : 0;
  const int a1 = row < n_rows ? a_ptr[row + 1] : 0;
  int lo = INT_MAX, hi = -1;
  int64_t pairs = 0;
  const bool alone = !kWarp && a1 - a0 <= kLaneTiles;
  if (owner && alone) scan_row(a_col, b_ptr, b_col, a0, a1, 1, lo, hi, pairs);
  for (uint32_t coop = __ballot_sync(kFull, owner && !alone); coop;
       coop &= coop - 1) {
    const int src = __ffs(coop) - 1;
    int l = INT_MAX, h = -1;
    int64_t p = 0;
    scan_row(a_col, b_ptr, b_col, __shfl_sync(kFull, a0, src) + lane,
             __shfl_sync(kFull, a1, src), 32, l, h, p);
    l = __reduce_min_sync(kFull, l);
    h = __reduce_max_sync(kFull, h);
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) p += __shfl_xor_sync(kFull, p, d);
    if (lane == src) {
      lo = l;
      hi = h;
      pairs = p;
    }
  }
  const bool is_heavy = pairs >= heavy;
  if (owner) {
    row_lo[row] = hi >= lo ? lo : 0;
    row_pairs[row] = pairs;
  }
  const uint32_t below = (1u << lane) - 1u;
#pragma unroll
  for (int list = 0; list < 2; ++list) {  // 0: heavy, 1: light
    const bool mine = owner && is_heavy == (list == 0);
    const uint32_t who = __ballot_sync(kFull, mine);
    const int words = __reduce_max_sync(kFull, mine && hi >= lo
                                                   ? hi - lo + 1 : 0);
    int at = 0;
    if (lane == 0 && who) {
      at = atomicAdd(plan + 2 + list, __popc(who));
      if (words) atomicMax(plan + list, words);
    }
    at = __shfl_sync(kFull, at, 0);
    if (mine) rows[list * n_rows + at + __popc(who & below)] = row;
  }
}

// The 32 x 32 bit transpose of the words x of the warp's lanes: lane c gets
// bit c of lane r's word as its bit r (five butterfly steps of swapping
// blocks with the lane j apart).
__device__ __forceinline__ uint32_t transpose32(uint32_t x) {
  const int lane = threadIdx.x & 31;
  const uint32_t masks[5] = {0x0000ffffu, 0x00ff00ffu, 0x0f0f0f0fu,
                             0x33333333u, 0x55555555u};
#pragma unroll
  for (int s = 0; s < 5; ++s) {
    const int j = 16 >> s;
    const uint32_t m = masks[s];
    const uint32_t y = __shfl_xor_sync(kFull, x, j);
    x = (lane & j) ? (x & ~m) | ((y & ~m) >> j) : (x & m) | ((y & m) << j);
  }
  return x;
}

// A run of the row's tiles of A in shared memory: for each of its n tiles
// (n <= kRun), the first tile q0 of B's row X, the run's pairs before it
// (pstart; pstart[kRun] = the run's pairs) and its column occupancy (the
// OR of its words); in the fill, at[i * T + c] = the rows r whose word r
// of tile i holds bit c, for each set c.
constexpr int kRun = 32;
struct Run {
  int q0[kRun];
  int pstart[kRun + 1];
  uint32_t acol[kRun];
};

// Loads the run of n tiles of A at k0. Warp 0 reads the n tiles' column
// indices, then B's row bounds (lane i: tile i; a prefix sum lays out the
// pairs), and each tile's words as 16-byte vectors for its column
// occupancy; with at, the warps transpose the tiles (transpose32). Called
// by the whole block; ends with a __syncthreads().
template <int T>
__device__ __forceinline__ void load_run(
    const int32_t* __restrict__ a_col, const uint32_t* __restrict__ a_tiles,
    const int32_t* __restrict__ b_ptr, int k0, int n, Run& run,
    uint32_t* at) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (warp == 0) {
    int q0 = 0, len = 0;
    uint32_t acol = 0;
    if (lane < n) {
      const int k = k0 + lane;
      const uint4* v = reinterpret_cast<const uint4*>(
          a_tiles + static_cast<int64_t>(k) * T);
      uint4 w[T / 4];
#pragma unroll
      for (int i = 0; i < T / 4; ++i) w[i] = __ldg(v + i);
      const int x = __ldg(a_col + k);
      q0 = __ldg(b_ptr + x);
      len = __ldg(b_ptr + x + 1) - q0;
#pragma unroll
      for (int i = 0; i < T / 4; ++i)
        acol |= w[i].x | w[i].y | w[i].z | w[i].w;
    }
    const int incl = static_cast<int>(
        rowbm::warp_inclusive_sum(static_cast<uint32_t>(len)));
    if (lane < n) {
      run.q0[lane] = q0;
      run.pstart[lane] = incl - len;
      run.acol[lane] = acol;
    }
    if (lane == 31) run.pstart[kRun] = incl;
  }
  if (at != nullptr) {
    const int warps = blockDim.x >> 5;
    for (int i = warp; i < n; i += warps) {  // warp-uniform
      const uint32_t aw =
          lane < T ? __ldg(a_tiles + static_cast<int64_t>(k0 + i) * T + lane)
                   : 0u;
      const uint32_t col = transpose32(aw);
      if (lane < T) at[i * T + lane] = col;
    }
  }
  __syncthreads();
}

// The run's tile of pair p: the last i < n with pstart[i] <= p.
__device__ __forceinline__ int run_tile(const Run& run, int n, int p) {
  int lo = 0, hi = n - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (run.pstart[mid] <= p) lo = mid;
    else hi = mid - 1;
  }
  return lo;
}

// Marks the tile columns J of row I's meeting pairs in a bitmap whose word
// 0 is word base of the row; returns the block's marked word range
// ([0, -1]: none), relative to base. The row's tiles of A go in runs of
// kRun; a run's pairs are spread over the block's threads, consecutive
// threads on consecutive tiles of B.
template <int T>
__device__ __forceinline__ void mark_row(
    const int32_t* __restrict__ a_col, const uint32_t* __restrict__ a_tiles,
    const int32_t* __restrict__ b_ptr, const int32_t* __restrict__ b_col,
    const uint32_t* __restrict__ b_occ, int a0, int a1, uint32_t* bits,
    int base, Run& run, int* s_lo, int* s_hi, int& lo, int& hi) {
  lo = INT_MAX;
  hi = -1;
  for (int k0 = a0; k0 < a1; k0 += kRun) {
    const int n = min(kRun, a1 - k0);
    load_run<T>(a_col, a_tiles, b_ptr, k0, n, run, nullptr);
    for (int p = threadIdx.x; p < run.pstart[kRun]; p += blockDim.x) {
      const int i = run_tile(run, n, p);
      const int q = run.q0[i] + p - run.pstart[i];
      if (run.acol[i] & __ldg(b_occ + q))
        rowbm::mark(bits, __ldg(b_col + q), base, lo, hi);
    }
    __syncthreads();  // the run is loaded again
  }
  rowbm::range_of(lo, hi, s_lo, s_hi);
}

// ORs B(X, J)'s words k (for k in meet) into the slot's words r of the
// rows r in at[k]. The words are read in groups of four 16-byte vectors,
// all issued before their ORs (a road grid's pair reads ~13 words).
template <int T>
__device__ __forceinline__ void or_pair(const uint32_t* __restrict__ bt,
                                        uint32_t meet, const uint32_t* at,
                                        uint32_t* ct) {
  constexpr int kVecs = T / 4 < 4 ? T / 4 : 4;
  const uint4* bv = reinterpret_cast<const uint4*>(bt);
#pragma unroll
  for (int g = 0; g < T / 4; g += kVecs) {
    uint4 v[kVecs];
#pragma unroll
    for (int i = 0; i < kVecs; ++i)
      v[i] = (meet >> (4 * (g + i))) & 0xfu ? __ldg(bv + g + i)
                                            : make_uint4(0, 0, 0, 0);
#pragma unroll
    for (int i = 0; i < kVecs; ++i) {
      const uint32_t w[4] = {v[i].x, v[i].y, v[i].z, v[i].w};
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int k = 4 * (g + i) + b;
        if (!((meet >> k) & 1u)) continue;
        for (uint32_t rs = at[k]; rs; rs &= rs - 1) {
          uint32_t* cw = ct + __ffs(rs) - 1;
          if ((*cw & w[b]) != w[b]) atomicOr(cw, w[b]);
        }
      }
    }
  }
}

// A block takes one tile-row of the list rows[0, n_rows) at a time from
// the counter. The bitmap holds n_words words (the list's widest window),
// word 0 at row_lo[row]. count: writes row_off[row] and raises *widest to
// it. fill: runs of n_run tiles of A.
template <int T, bool kFill>
__global__ void __launch_bounds__(1024, 1) spgemm_bbb_kernel(
    const int32_t* __restrict__ a_ptr, const int32_t* __restrict__ a_col,
    const uint32_t* __restrict__ a_tiles, const int32_t* __restrict__ b_ptr,
    const int32_t* __restrict__ b_col, const uint32_t* __restrict__ b_tiles,
    const uint32_t* __restrict__ b_occ, const int32_t* __restrict__ m_ptr,
    const int32_t* __restrict__ m_col, const uint32_t* __restrict__ m_tiles,
    int mask_mode,
    int64_t* __restrict__ row_off,  // count: out; fill: in
    const int32_t* __restrict__ row_lo, int32_t* __restrict__ out_col,
    uint32_t* __restrict__ out_tiles, uint8_t* __restrict__ out_flag,
    int64_t* __restrict__ row_nz, int64_t* __restrict__ row_bits,
    const int32_t* __restrict__ rows, int* __restrict__ widest, int n_rows,
    int n_words, int n_run, int n_slots, int* __restrict__ counter) {
  extern __shared__ __align__(16) uint32_t smem[];
  __shared__ int s_lo, s_hi;
  __shared__ Run run;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  // fill: the slots (16-byte aligned, first), the run's transposed A
  // tiles, each slot's column and mask tile (or -1), then the bitmap and
  // its rank array; count: the bitmap alone
  uint32_t* slots = smem;
  uint32_t* at = slots + (kFill ? n_slots * T : 0);
  int32_t* slot_col = reinterpret_cast<int32_t*>(at + (kFill ? n_run * T : 0));
  int32_t* slot_mask = slot_col + (kFill ? n_slots : 0);
  uint32_t* bits = reinterpret_cast<uint32_t*>(slot_mask + (kFill ? n_slots : 0));
  uint32_t* rank = bits + n_words;        // fill: marked columns below a word
  for (int w = threadIdx.x; w < n_words; w += blockDim.x) bits[w] = 0;
  if (threadIdx.x == 0) {
    s_lo = INT_MAX;
    s_hi = -1;
  }

  // count: the block's widest row, raised into *widest once at the end
  // (an access a row to that one word cost a road grid's count 0.2 ms)
  int widest_here = 0;
  for (int i = rowbm::next_row(counter); i < n_rows;
       i = rowbm::next_row(counter)) {
    const int row = rows[i];
    const int a0 = a_ptr[row], a1 = a_ptr[row + 1];
    const int64_t off = kFill ? row_off[row] : 0;
    const int total = kFill ? static_cast<int>(row_off[row + 1] - off) : 0;
    if (a0 == a1 || (kFill && total == 0)) {  // uniform across the block
      if (threadIdx.x == 0) {
        if (kFill) row_nz[row] = row_bits[row] = 0;
        else row_off[row] = 0;
      }
      continue;
    }
    const int base = row_lo[row];
    const int m0 = mask_mode != kNoMask ? m_ptr[row] : 0;
    const int m1 = mask_mode != kNoMask ? m_ptr[row + 1] : 0;
    int lo, hi;
    mark_row<T>(a_col, a_tiles, b_ptr, b_col, b_occ, a0, a1, bits, base,
                run, &s_lo, &s_hi, lo, hi);
    if (!kFill) {
      uint32_t c = 0;
      if (mask_mode == kKeep) {  // the mask row's marked columns
        for (int p = m0 + threadIdx.x; p < m1; p += blockDim.x) {
          const int j = m_col[p];
          const int w = (j >> 5) - base;
          c += w >= lo && w <= hi && ((bits[w] >> (j & 31)) & 1u);
        }
      } else {
        for (int w = lo + threadIdx.x; w <= hi; w += blockDim.x)
          c += __popc(bits[w]);
      }
      c = rowbm::block_sum(c);
      if (threadIdx.x == 0) {
        row_off[row] = c;
        widest_here = max(widest_here, static_cast<int>(c));
      }
      rowbm::range_clear(bits, lo, hi, &s_lo, &s_hi);
      continue;
    }

    if (mask_mode == kKeep) {  // keep only the mask row's columns
      for (int w = lo + threadIdx.x; w <= hi; w += blockDim.x) rank[w] = 0;
      __syncthreads();
      for (int p = m0 + threadIdx.x; p < m1; p += blockDim.x) {
        const int j = m_col[p];
        const int w = (j >> 5) - base;
        const uint32_t bit = 1u << (j & 31);
        if (w >= lo && w <= hi && (bits[w] & bit)) atomicOr(rank + w, bit);
      }
      __syncthreads();
      for (int w = lo + threadIdx.x; w <= hi; w += blockDim.x)
        bits[w] = rank[w];
      __syncthreads();
    }
    rowbm::range_rank(bits, rank, lo, hi);  // == total
    uint32_t n_nz = 0, n_bits = 0;  // this thread's non-zero tiles, bits

    for (int first = 0; first < total; first += n_slots) {
      const int ns = min(n_slots, total - first);
      for (int i = threadIdx.x; i < ns * T; i += blockDim.x) slots[i] = 0;
      for (int i = threadIdx.x; i < ns; i += blockDim.x) slot_mask[i] = -1;
      for (int s = threadIdx.x; s < ns; s += blockDim.x) {
        // the word that holds slot s: the last with rank <= its rank
        const uint32_t want = static_cast<uint32_t>(first + s);
        int w0 = lo, w1 = hi;
        while (w0 < w1) {
          const int mid = (w0 + w1 + 1) >> 1;
          if (rank[mid] <= want) w0 = mid;
          else w1 = mid - 1;
        }
        slot_col[s] = (w0 + base) * 32 +
                      __fns(bits[w0], 0, static_cast<int>(want - rank[w0]) + 1);
      }
      __syncthreads();  // slot_mask is cleared before the walk below
      for (int p = m0 + threadIdx.x; p < m1; p += blockDim.x) {
        const int j = m_col[p];
        const int w = (j >> 5) - base;
        if (w < lo || w > hi || !((bits[w] >> (j & 31)) & 1u)) continue;
        const int s = rowbm::rank_of(bits, rank, j, base) - first;
        if (s >= 0 && s < ns) slot_mask[s] = p;
      }
      for (int k0 = a0; k0 < a1; k0 += n_run) {
        const int n = min(n_run, a1 - k0);
        load_run<T>(a_col, a_tiles, b_ptr, k0, n, run, at);
        for (int p = threadIdx.x; p < run.pstart[kRun]; p += blockDim.x) {
          const int i = run_tile(run, n, p);
          const int q = run.q0[i] + p - run.pstart[i];
          const uint32_t meet = run.acol[i] & __ldg(b_occ + q);
          if (meet == 0) continue;
          const int j = __ldg(b_col + q);
          const int w = (j >> 5) - base;
          const uint32_t bw = bits[w];
          const uint32_t bit = 1u << (j & 31);
          if (!(bw & bit)) continue;  // a keep mask has no tile here
          const int s = rank[w] + __popc(bw & (bit - 1u)) - first;
          if (s < 0 || s >= ns) continue;  // another round's slot
          or_pair<T>(b_tiles + static_cast<int64_t>(q) * T, meet, at + i * T,
                     slots + s * T);
        }
        __syncthreads();  // the run is loaded again
      }
      __syncthreads();
      // store: a lane per 16 bytes of a slot, T / 4 lanes a slot
      constexpr int kLanes = T / 4;
      constexpr int kPerWarp = 32 / kLanes;
      const int seg = lane / kLanes, part = lane % kLanes;
      for (int s0 = warp * kPerWarp; s0 < ns; s0 += warps * kPerWarp) {
        const int s = s0 + seg;
        const bool ok = s < ns;
        uint4 v = make_uint4(0, 0, 0, 0);
        if (ok) {
          v = reinterpret_cast<const uint4*>(slots + s * T)[part];
          const int mi = slot_mask[s];
          if (mi >= 0) {
            uint4 mw = __ldg(reinterpret_cast<const uint4*>(
                               m_tiles + static_cast<int64_t>(mi) * T) + part);
            if (mask_mode == kComplement)
              mw = make_uint4(~mw.x, ~mw.y, ~mw.z, ~mw.w);
            v = make_uint4(v.x & mw.x, v.y & mw.y, v.z & mw.z, v.w & mw.w);
          }
        }
        const uint32_t nz =
            (__ballot_sync(kFull, (v.x | v.y | v.z | v.w) != 0) >>
             (seg * kLanes)) & ((1u << kLanes) - 1u);
        n_bits += __popc(v.x) + __popc(v.y) + __popc(v.z) + __popc(v.w);
        if (ok) {
          const int64_t o = off + first + s;
          reinterpret_cast<uint4*>(out_tiles + o * T)[part] = v;
          if (part == 0) {
            out_col[o] = slot_col[s];
            out_flag[o] = nz != 0;
            n_nz += nz != 0;
          }
        }
      }
      __syncthreads();  // the slots are cleared again by the next round
    }
    n_nz = rowbm::block_sum(n_nz);
    n_bits = rowbm::block_sum(n_bits);
    if (threadIdx.x == 0) {
      row_nz[row] = n_nz;
      row_bits[row] = n_bits;
    }
    rowbm::range_clear(bits, lo, hi, &s_lo, &s_hi);
  }
  if (!kFill && threadIdx.x == 0 && widest_here > 0)
    atomicMax(widest, widest_here);
}

using Kernel = void (*)(const int32_t*, const int32_t*, const uint32_t*,
                        const int32_t*, const int32_t*, const uint32_t*,
                        const uint32_t*, const int32_t*, const int32_t*,
                        const uint32_t*, int, int64_t*, const int32_t*,
                        int32_t*, uint32_t*, uint8_t*, int64_t*, int64_t*,
                        const int32_t*, int*, int, int, int, int, int*);
using OccKernel = void (*)(const uint32_t*, uint32_t*, int64_t);

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

OccKernel occ_for(int t) {
  switch (t) {
    case 4: return occupancy_kernel<4>;
    case 8: return occupancy_kernel<8>;
    case 16: return occupancy_kernel<16>;
    case 32: return occupancy_kernel<32>;
    default: return nullptr;
  }
}

}  // namespace

extern "C" {

// pass = 0 (n_rows: A's tile-rows): fills b_occ (uint32[n_b_tiles]),
// row_lo[i], the first bitmap word row i can mark (int32[n_rows]),
// row_pairs[i], its (A tile, B tile) pairs (int64[n_rows]), the row lists
// in rows (int32[2 * n_rows]: the heavy rows, those of at least `heavy`
// pairs, from 0, the light ones from n_rows) and plan[0..3] (int32,
// zeroed by the caller): the heavy and the light list's widest window in
// words, then their rows. A warp per row when threads >= 256 (A's rows
// long on average), else a thread.
// Passes 1 and 2 go over the list rows[0, n_rows) with n_words = its
// widest window, and the b_occ and row_lo that pass 0 filled:
// pass = 1 (count): row_off[i] = the tiles of C's row i (int64, indexed
// by row; with a mask an upper bound); *widest (int32, zeroed by the
// caller) rises to the list's widest row.
// pass = 2 (fill): row_off is their exclusive scan over all rows; writes
// every slot of out_col, out_tiles and out_flag (uint8, 1: the tile is
// not zero) and row_nz / row_bits (int64, indexed by row: the row's
// non-zero tiles and set bits) of the list's rows.
// m_* may be null when mask_mode == 0. threads: a block's threads (a
// multiple of 32, at most 1024); slots: most slots a round holds (fewer
// where the room is smaller; the fill's runs of A's tiles are halved
// while fewer than kMinSlots fit). shape (may be null): int[3], the
// threads, slots and run the launch used. counter: int32[1], zeroed by
// the caller for each launch.
int spgemm_bbb(const void* a_ptr, const void* a_col, const void* a_tiles,
               const void* b_ptr, const void* b_col, const void* b_tiles,
               void* b_occ, const void* m_ptr, const void* m_col,
               const void* m_tiles, int mask_mode, void* row_off,
               void* row_lo, void* row_pairs, void* plan, void* rows,
               void* widest, int64_t heavy,
               void* out_col, void* out_tiles, void* out_flag, void* row_nz,
               void* row_bits, int n_rows, int64_t n_b_tiles, int n_words,
               int t, int pass, int threads, int slots, int* shape,
               void* counter, void* stream) {
  const bool fill = pass == 2;
  const Kernel k = fill ? kernel_for<true>(t) : kernel_for<false>(t);
  const OccKernel occ_k = occ_for(t);
  int n_run = kRun;
  if (k == nullptr || occ_k == nullptr || n_words < 0 ||
      n_words > rowbm::kMaxWords || mask_mode < 0 || mask_mode > 2 ||
      threads < 32 || threads > 1024 || threads % 32 || slots < 1 ||
      pass < 0 || pass > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (pass == 0) {
    if (n_b_tiles > 0) {
      const int64_t n = n_b_tiles * t;
      occ_k<<<static_cast<unsigned>((n + 255) / 256), 256, 0, s>>>(
          static_cast<const uint32_t*>(b_tiles),
          static_cast<uint32_t*>(b_occ), n);
    }
    const int per_block = threads >= 256 ? 8 : 256;  // rows a block
    if (n_rows > 0)
      (threads >= 256 ? window_kernel<true> : window_kernel<false>)
          <<<(n_rows + per_block - 1) / per_block, 256, 0, s>>>(
              static_cast<const int32_t*>(a_ptr),
              static_cast<const int32_t*>(a_col),
              static_cast<const int32_t*>(b_ptr),
              static_cast<const int32_t*>(b_col),
              static_cast<int32_t*>(row_lo),
              static_cast<int64_t*>(row_pairs), static_cast<int*>(plan),
              static_cast<int32_t*>(rows), n_rows, heavy);
    return static_cast<int>(cudaGetLastError());
  }
  if (n_rows <= 0) return 0;
  size_t smem = 4 * static_cast<size_t>(n_words);
  if (fill) {
    cudaFuncAttributes attr;
    int dev = 0, optin = 0;
    cudaError_t e = cudaFuncGetAttributes(&attr, k);
    if (e == cudaSuccess) e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&optin,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (e != cudaSuccess) return static_cast<int>(e);
    const int64_t slot_bytes = 4 * static_cast<int64_t>(t) + 8;
    auto room = [&](int r) {  // slots that fit beside the rest
      return (optin - static_cast<int64_t>(attr.sharedSizeBytes) -
              8 * static_cast<int64_t>(n_words) -
              4 * static_cast<int64_t>(r) * t) / slot_bytes;
    };
    while (n_run > 1 && room(n_run) < kMinSlots) n_run /= 2;
    const int64_t fit = room(n_run);
    if (fit < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    slots = static_cast<int>(slots < fit ? slots : fit);
    smem = 8 * static_cast<size_t>(n_words) +
           4 * static_cast<size_t>(n_run) * t +
           static_cast<size_t>(slots) * slot_bytes;
  }
  if (shape != nullptr) {
    shape[0] = threads;
    shape[1] = fill ? slots : 0;
    shape[2] = fill ? n_run : 0;
  }
  int grid = 0;
  const cudaError_t e = rowbm::row_grid(reinterpret_cast<const void*>(k),
                                        smem, n_rows, &grid, threads);
  if (e != cudaSuccess) return static_cast<int>(e);
  k<<<grid, threads, smem, s>>>(
      static_cast<const int32_t*>(a_ptr), static_cast<const int32_t*>(a_col),
      static_cast<const uint32_t*>(a_tiles),
      static_cast<const int32_t*>(b_ptr), static_cast<const int32_t*>(b_col),
      static_cast<const uint32_t*>(b_tiles),
      static_cast<const uint32_t*>(b_occ),
      static_cast<const int32_t*>(m_ptr), static_cast<const int32_t*>(m_col),
      static_cast<const uint32_t*>(m_tiles), mask_mode,
      static_cast<int64_t*>(row_off), static_cast<const int32_t*>(row_lo),
      static_cast<int32_t*>(out_col), static_cast<uint32_t*>(out_tiles),
      static_cast<uint8_t*>(out_flag), static_cast<int64_t*>(row_nz),
      static_cast<int64_t*>(row_bits), static_cast<const int32_t*>(rows),
      static_cast<int*>(widest), n_rows, n_words, n_run, slots,
      static_cast<int*>(counter));
  return static_cast<int>(cudaGetLastError());
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
