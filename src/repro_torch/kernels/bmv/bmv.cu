// B2SR mxv kernels for Hopper (sm_90a): the BFS push and pull steps, the
// semiring mxv and the count mxv.
//
// Replace the TPU kernels in src/repro/kernels/bmv/bmv.py:
//   bmv_bbb_push  <- bmv_bin_bin_bin_pallas       (push step, mask at store)
//   bmv_bbb_pull  <- bmv_bin_bin_bin_pull_pallas  (pull step, early exit)
//   bmv_bff       <- bmv_bin_full_full_pallas     (semiring mxv, dense x)
//   bmv_bbf       <- bmv_bin_bin_full_pallas      (count mxv, packed x)
//
// All four walk the B2SR CSR-over-tiles arrays directly: tile_row_ptr
// int32[R+1], tile_col_idx int32[nT], bit_tiles uint32[nT, t]. The TPU
// kernels needed an ELL slab per static shape (and one launch per
// bucket); a warp here takes a work item, a run of one row's tiles, so
// there is no padding and one launch per step (bmv_bff: two when a row
// is cut).
//
// --- bmv_bbb_push / bmv_bbb_pull ------------------------------------------
//
// Inputs: the packed frontier x uint32[C] and the mask uint32[R]; output
// uint32[R], zeroed by the wrapper.
//
// Push and pull compute one function (the reference's pull kernel is the
// masked push with an early exit) and share one walk, bbb_walk below,
// over work items as bmv_bbf takes them (runs of at most 256 of a row's
// tiles, one warp each; the registry passes both the cut it keeps for
// bmv_bbf), so a hub tile-row spreads over many warps: one warp per
// tile-row put R-MAT scale 21's tile-row 0, 40,500 tiles, on one warp,
// 1,266 dependent steps of column index, x word and tile. The warp first
// loads its row's mask word and drops the item when no lane is allowed;
// then it walks bmv_bbf's way (below): 32 column indices, their 32 x
// words, a ballot of the non-zero ones, and only those tiles read, 32 / t
// at a time, lane (g, r) holding word r of the g-th; the lane notes
// whether word r & xw != 0, and a ballot folds the lane groups into the
// item's hit word. Every few batches of 32 tiles the item stops once
// every allowed lane is set, or, in a cut row, once the row's word, into
// which its items OR their hits, holds every allowed lane: a hub row's
// items would otherwise each walk until their own tiles set every lane.
// An item that is its whole row stores (hits & allowed); the items of a
// cut row atomicOr theirs into the output: OR is order-free and the mask
// distributes over it, so the result is the same bits whatever the cut
// and the order.
//
// The two differ in cadence (the Walk parameters below) and in one
// input. Both load 4 batches' column indices and x words at once, so
// the next batches' loads are in flight while one is worked on. Push,
// which the direction policy runs on sparse frontiers, tests its exit
// and shares a cut row's word after the 4. Pull tests its exit after
// every batch and shares after every batch once the item has a hit
// (every 8 before): on a dense frontier a hub row's items stop as soon
// as together they have set its lanes. Pull also takes the lanes that
// some tile of each row can set (kernels/items.py row_lanes, kept by the
// registry): a lane no tile can set, as an isolated vertex's, would keep
// its row walking to the end on every step, and R-MAT's tile-rows mostly
// hold one. What pull still reads on a dense frontier is mostly rows
// whose last allowed lane meets its first hit deep in the row: the
// stored order gives no shortcut to it.
//
// Bound: device-memory bytes. Per tile the work is t ANDs against a
// 4t-byte read, far below the card's operations-per-byte line; skipping
// tiles whose frontier word is zero is what keeps a sparse frontier from
// reading the whole graph, and the mask skip and early exit what keep a
// late, nearly visited one from it.
//
// Bit-exactness of the early exits: the accumulators only ever OR
// (hits & allowed), so once one equals `allowed` the tiles not yet read
// could only add bits that are already set.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr unsigned kFull = 0xffffffffu;

template <int T>
__device__ __forceinline__ constexpr uint32_t lane_mask() {
  return T == 32 ? 0xffffffffu : ((1u << T) - 1u);
}

}  // namespace

// --- bmv_bff: semiring mxv, y[i] = (+)_j (A_ij ? a (x) x_j : identity) ---
//
// Inputs: x3 float32[C, t] (x padded to whole column tiles), the scalars
// a_value and the (+)-identity; output float32[R * t]. Modes: sum
// (arithmetic), min_plus, max_times. Every mode takes the select form: a
// set bit contributes a (x) x, a clear bit nothing, so an inf in x cannot
// leak NaN through an absent edge. (The TPU kernel's sum mode contracts
// unpacked 0/1 tiles with x on the MXU; at about 2 set bits per
// 1,024-bit tile a tensor core would multiply zeros.)
//
// Work items. The wrapper cuts every tile-row into work items (runs of
// its tiles of at most 2,048 set bits plus one per tile; see
// kernels/items.py) and a warp takes one item, so a hub tile-row spreads
// over many warps. (One warp per tile-row put R-MAT scale 21's tile-row 0,
// 40,500 tiles and 552,282 set bits, on one warp: about 13 of the
// launch's 16.8 ms.) An item that is its whole row stores y itself; the
// items of a cut row write their t partials to a scratch slot each, and
// a second launch folds a row's slots in item order. No float atomics:
// the sum mode is the same, bit for bit, from run to run, and min and max
// are exact in any order.
//
// Layout inside an item: the warp reads its tiles cooperatively, lane
// (g, r) = (lane / t, lane % t) word r of tile g of each step, so a step
// reads 32 / t whole tiles as one coalesced 128-byte load. Lane r folds
// a (x) x3[col][c] for each set bit c of its word straight into bit-row
// r's accumulator; the 32 / t lane groups of a bit-row are folded by a
// shuffle at the end. kUnroll steps are loaded at once, and the next
// kUnroll steps' column indices and words are loaded before the current
// ones' bits are walked, so a warp keeps up to 2 * kUnroll tile loads in
// flight; the gathers of x3 (8.4 MB at scale 21, held in the 50 MB L2)
// for the kUnroll words are issued together too. A lane keeps one
// accumulator per unrolled step and folds them in a fixed order at the
// end, so the sum order is fixed by the data and the cut alone.
//
// Bound: device-memory bytes. Each tile is read whole (x is dense, no
// tile can be skipped): at R-MAT scale 21 with t = 32, 4.23 GB of tiles,
// 132 MB of column indices and 8.4 MB each of x and y, about 1.31 ms at
// 3.35 TB/s, against about 2 floating-point operations per set bit
// (127 M here, 100 times below the byte line).
//
// --- bmv_bbf: count mxv, y[i*t + r] = sum_k popc(tile_k[r] & x[col_k]) ---
//
// Inputs: the packed x uint32[C]; output int32[R * t]. The same work
// items (cut by tiles, at most 256 each) and the same cooperative tile
// read, with a warp-uniform skip: the warp loads 32 column indices,
// gathers their 32 x words and takes a ballot of the non-zero ones, then
// walks only those tiles, 32 / t at a time (8 steps' loads issued
// together); lane r adds popc(word_r & xw). A sparse frontier thus skips
// almost every tile for one gather per 32 tiles. The column indices and
// x words of 4 such batches are loaded together, so a warp waits for
// them once per 128 tiles. Integer sums are exact in any order, so the
// items of a cut row merge with atomicAdd into y (zeroed by the
// wrapper). Bound: bytes, by push's rule (the tiles whose x word is
// non-zero, plus every column index); at full x density about 4.36 GB,
// 1.30 ms at scale 21.

namespace {

enum Mode { kSum = 0, kMinPlus = 1, kMaxTimes = 2 };

// Steps (of 32 / t tiles each) a bmv_bff warp loads at once. At R-MAT
// scale 21, t = 32 (sum mode; tools/bmv_variants.py on an H100): 4 steps
// take 40 registers and 2.03-2.07 ms, 8 steps 64 registers and
// 2.38-2.42 ms, 16 steps 119 and 3.71-3.75 ms: more warps in flight beat
// deeper unrolling.
constexpr int kUnroll = 4;
// Batches of 32 tiles whose column indices and x words a bmv_bbf warp
// loads at once, live tiles it reads at once, and the blocks per SM it
// asks the compiler for (a cap of 40 registers; uncapped it takes 48 and
// ran 0.548-0.580 ms over a BFS's iterations against 0.508-0.526).
constexpr int kCountBatches = 4;
constexpr int kCountUnroll = 8;
constexpr int kCountBlocksPerSM = 6;
// The cadence of push's and pull's walk (bbb_walk): batches of 32 tiles
// whose column indices and x words are loaded together, batches between
// two exit tests, between two shares of a cut row's word once the item
// has a hit (and before), live tiles read at once, and the blocks per SM
// asked of the compiler (push: bmv_bbf's).
// Pull's were picked with tools/bmv_variants.py --kernel pull (R-MAT
// scale 21, t = 32, one BFS's 8 frontiers, the registry's cut and lane
// occupancy; NVIDIA H100 80GB HBM3, 700.00 W; mean ms per launch, in
// order and reversed): these constants 0.259, 0.258; exit every 2 or 4
// batches 0.266, 0.259 and 0.261, 0.261; share every 2 or 4 batches
// 0.265, 0.272 and 0.286, 0.292 (the dense fourth iteration 1.064 and
// 1.241 against 0.959); share every batch before a hit too 0.311, 0.319
// (the sparse first iteration 0.263 against 0.150), every 4 0.285,
// 0.287; groups of 1 or 2 batches 0.279, 0.291 and 0.287, 0.283; 4 live
// tiles at once 0.323, 0.298; 4 or 8 blocks per SM 0.294, 0.303 and
// 0.305, 0.313; cuts of 64 and 1,024 tiles 0.379, 0.389 and 0.253,
// 0.245 (256 is the cut push and bmv_bbf keep); no lane occupancy 0.317,
// 0.323; push on the same inputs 0.352, 0.369.
constexpr int kPushGroup = 4;
constexpr int kPushExit = 4;
constexpr int kPushShare = 4;
constexpr int kPullGroup = 4;
constexpr int kPullExit = 1;
constexpr int kPullShare = 1;
constexpr int kPullShareIdle = 8;
constexpr int kPullUnroll = 8;
constexpr int kPullBlocksPerSM = 6;

// (x) and (+) of each mode. The products are rounded on their own (no
// fused multiply-add), as the plain version rounds them; min and max
// propagate NaN as torch.minimum / torch.maximum do.
template <int M> struct Semi;
template <> struct Semi<kSum> {
  static __device__ __forceinline__ float mul(float a, float x) {
    return __fmul_rn(a, x);
  }
  static __device__ __forceinline__ float add(float p, float q) {
    return __fadd_rn(p, q);
  }
};
template <> struct Semi<kMinPlus> {
  static __device__ __forceinline__ float mul(float a, float x) {
    return __fadd_rn(a, x);
  }
  static __device__ __forceinline__ float add(float p, float q) {
    return (q < p || q != q) ? q : p;
  }
};
template <> struct Semi<kMaxTimes> {
  static __device__ __forceinline__ float mul(float a, float x) {
    return __fmul_rn(a, x);
  }
  static __device__ __forceinline__ float add(float p, float q) {
    return (q > p || q != q) ? q : p;
  }
};

// Column index and lane word of the tiles of kUnroll steps from tile kb:
// step u holds tile kb + u * G + g (G = 32 / T tiles a step, g the lane's
// group); past the item's end a lane gets word 0.
template <int T>
__device__ __forceinline__ void load_steps(const int32_t* __restrict__ col_idx,
                                           const uint32_t* __restrict__ tiles,
                                           int kb, int k1, int g, int r,
                                           int (&col)[kUnroll],
                                           uint32_t (&w)[kUnroll]) {
  constexpr int G = 32 / T;
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int k = kb + u * G + g;
    col[u] = 0;
    w[u] = 0u;
    if (k < k1) {
      col[u] = __ldg(col_idx + k);
      w[u] = __ldg(tiles + static_cast<int64_t>(k) * T + r);
    }
  }
}

template <int T, int M>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
bmv_bff_kernel(const int32_t* __restrict__ col_idx,
               const uint32_t* __restrict__ tiles,
               const int32_t* __restrict__ item_row,
               const int32_t* __restrict__ item_begin,
               const int32_t* __restrict__ item_slot,
               const float* __restrict__ x3, float* __restrict__ scratch,
               float* __restrict__ out, int n_items, float a, float ident) {
  constexpr int G = 32 / T;
  const int lane = threadIdx.x & 31;
  const int g = lane / T;
  const int r = lane - g * T;
  const int item = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (item >= n_items) return;  // uniform across the warp
  const int k0 = item_begin[item];
  const int k1 = item_begin[item + 1];
  float acc[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) acc[u] = ident;
  int col_next[kUnroll];
  uint32_t w_next[kUnroll];
  load_steps<T>(col_idx, tiles, k0, k1, g, r, col_next, w_next);
  for (int kb = k0; kb < k1; kb += kUnroll * G) {
    int col[kUnroll];
    uint32_t w[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      col[u] = col_next[u];
      w[u] = w_next[u];
    }
    if (kb + kUnroll * G < k1)  // uniform: prefetch the next steps
      load_steps<T>(col_idx, tiles, kb + kUnroll * G, k1, g, r, col_next,
                    w_next);
    // one set bit of each word per round, the gathers issued together
    while (true) {
      uint32_t any = 0;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) any |= w[u];
      if (!any) break;
      float v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        v[u] = 0.0f;
        if (w[u]) {
          const int c = __ffs(w[u]) - 1;
          v[u] = __ldg(x3 + static_cast<int64_t>(col[u]) * T + c);
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (w[u]) {
          acc[u] = Semi<M>::add(acc[u], Semi<M>::mul(a, v[u]));
          w[u] &= w[u] - 1;
        }
      }
    }
  }
  float y = acc[0];
#pragma unroll
  for (int u = 1; u < kUnroll; ++u) y = Semi<M>::add(y, acc[u]);
#pragma unroll
  for (int o = T; o < 32; o *= 2)
    y = Semi<M>::add(y, __shfl_xor_sync(kFull, y, o));
  if (g == 0) {
    const int slot = item_slot[item];
    if (slot < 0) out[static_cast<int64_t>(item_row[item]) * T + r] = y;
    else scratch[static_cast<int64_t>(slot) * T + r] = y;
  }
}

// y of a cut tile-row: its items' partials folded in item order, in four
// interleaved chains joined in a fixed order. One thread per (cut row, r).
template <int T, int M>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
bmv_bff_merge_kernel(const int32_t* __restrict__ cut_row,
                     const int32_t* __restrict__ cut_first,
                     const int32_t* __restrict__ cut_count,
                     const float* __restrict__ scratch,
                     float* __restrict__ out, int n_cells) {
  const int i = blockIdx.x * 32 * kWarpsPerBlock + threadIdx.x;
  if (i >= n_cells) return;
  const int c = i / T;
  const int r = i - c * T;
  const float* p = scratch + static_cast<int64_t>(cut_first[c]) * T + r;
  const int n = cut_count[c];  // >= 2
  float s[4];
  int j = 0;
  for (; j < 4 && j < n; ++j) s[j] = p[static_cast<int64_t>(j) * T];
  for (int q = j; q < 4; ++q) s[q] = s[0];
  for (; j + 4 <= n; j += 4) {
#pragma unroll
    for (int q = 0; q < 4; ++q)
      s[q] = Semi<M>::add(s[q], p[static_cast<int64_t>(j + q) * T]);
  }
  for (int q = 0; j < n; ++j, ++q)
    s[q] = Semi<M>::add(s[q], p[static_cast<int64_t>(j) * T]);
  // chains that got no partial of their own hold s[0] and are not folded
  float y = Semi<M>::add(s[0], s[1]);
  if (n > 2) y = Semi<M>::add(y, s[2]);
  if (n > 3) y = Semi<M>::add(y, s[3]);
  out[static_cast<int64_t>(cut_row[c]) * T + r] = y;
}

// The column indices, then the x words, of NB batches of 32 tiles from
// kb0 (of an item ending at k1), each issued together; lane l holds
// those of tile kb0 + 32 b + l (x word 0 past the item's end).
template <int NB>
__device__ __forceinline__ void load_batches(
    const int32_t* __restrict__ col_idx, const uint32_t* __restrict__ x,
    int kb0, int k1, int lane, uint32_t (&xw)[NB]) {
  int col[NB];
#pragma unroll
  for (int b = 0; b < NB; ++b) {
    const int k = kb0 + 32 * b + lane;
    col[b] = k < k1 ? __ldg(col_idx + k) : -1;
  }
#pragma unroll
  for (int b = 0; b < NB; ++b) xw[b] = col[b] >= 0 ? __ldg(x + col[b]) : 0u;
}

// The live tiles (bits of `live`, a warp ballot of the x words xw) of
// the batch of 32 tiles from kb, G = 32 / T at a time (U steps' loads
// issued together), lane (g, r) reading word r of the g-th. Calls
// f(word, x word) for every word a lane read (0 past the live tiles).
template <int T, int U, typename F>
__device__ __forceinline__ void read_live(const uint32_t* __restrict__ tiles,
                                          int kb, uint32_t live, uint32_t xw,
                                          int g, int r, F&& f) {
  constexpr int G = 32 / T;
  while (live) {  // uniform: the same mask in every lane
    uint32_t tw[U], xv[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      // group g takes the g-th of the next G live tiles
      uint32_t m = live;
      for (int q = 0; q < g; ++q) m &= m - 1;
      const int j = m ? __ffs(m) - 1 : -1;
#pragma unroll
      for (int q = 0; q < G; ++q) live &= live - 1;
      xv[u] = __shfl_sync(kFull, xw, j & 31);
      const int64_t k = static_cast<int64_t>(kb + j) * T + r;
      tw[u] = j >= 0 ? __ldg(tiles + k) : 0u;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) f(tw[u], xv[u]);
  }
}

template <int T>
__global__ void __launch_bounds__(32 * kWarpsPerBlock, kCountBlocksPerSM)
bmv_bbf_kernel(const int32_t* __restrict__ col_idx,
               const uint32_t* __restrict__ tiles,
               const int32_t* __restrict__ item_row,
               const int32_t* __restrict__ item_begin,
               const int32_t* __restrict__ item_slot,
               const uint32_t* __restrict__ x, int32_t* __restrict__ out,
               int n_items) {
  const int lane = threadIdx.x & 31;
  const int g = lane / T;
  const int r = lane - g * T;
  const int item = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (item >= n_items) return;  // uniform across the warp
  const int k0 = item_begin[item];
  const int k1 = item_begin[item + 1];
  int acc = 0;
  for (int kb0 = k0; kb0 < k1; kb0 += 32 * kCountBatches) {
    uint32_t xw[kCountBatches];
    load_batches<kCountBatches>(col_idx, x, kb0, k1, lane, xw);
#pragma unroll
    for (int b = 0; b < kCountBatches; ++b)
      read_live<T, kCountUnroll>(
          tiles, kb0 + 32 * b, __ballot_sync(kFull, xw[b] != 0), xw[b], g, r,
          [&](uint32_t w, uint32_t xv) { acc += __popc(w & xv); });
  }
#pragma unroll
  for (int o = T; o < 32; o *= 2) acc += __shfl_xor_sync(kFull, acc, o);
  if (g == 0) {
    int32_t* o = out + static_cast<int64_t>(item_row[item]) * T + r;
    if (item_slot[item] < 0) *o = acc;
    else if (acc) atomicAdd(o, acc);
  }
}

// Push's and pull's walk over work items (see the head of this file),
// each batch of 32 tiles folded into the item's hit word. W is the
// cadence: W::kGroup batches' column indices and x words are loaded
// together (so the batches after the current one are in flight while it
// is worked on); the item tests its exit after every W::kExit batches
// and, in a cut row, shares its hits through out after every W::kShare
// batches once it has a hit (every W::kShareIdle before: on a sparse
// frontier few items ever hit, and their shares would only queue on a
// hub row's word); W::kUnroll live tiles are read at once. lanes (null
// for push) narrows the allowed lanes to those some tile of the row can
// set.
template <int T, typename W>
__global__ void __launch_bounds__(32 * kWarpsPerBlock, W::kBlocksPerSM)
bbb_walk(const int32_t* __restrict__ col_idx,
         const uint32_t* __restrict__ tiles,
         const int32_t* __restrict__ item_row,
         const int32_t* __restrict__ item_begin,
         const int32_t* __restrict__ item_slot,
         const uint32_t* __restrict__ x, const uint32_t* __restrict__ mask,
         const uint32_t* __restrict__ lanes, uint32_t* __restrict__ out,
         int n_items, int complement) {
  constexpr int G = 32 / T;
  constexpr int NB = W::kGroup;
  const int lane = threadIdx.x & 31;
  const int g = lane / T;
  const int r = lane - g * T;
  const int item = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (item >= n_items) return;  // uniform across the warp
  const int row = item_row[item];
  uint32_t allowed = lane_mask<T>();
  if (mask != nullptr) {
    const uint32_t m = __ldg(mask + row);
    allowed &= complement ? ~m : m;
  }
  // a lane no tile of the row can set is not waited for
  if (lanes != nullptr) allowed &= __ldg(lanes + row);
  if (allowed == 0) return;  // uniform: nothing can land; out is zeroed
  const int k0 = item_begin[item];
  const int k1 = item_begin[item + 1];
  const bool cut = item_slot[item] >= 0;
  uint32_t acc = 0;  // warp-uniform: hits & allowed
  // a cadence of whole groups (push's) tests after a group's last batch;
  // any other counts the batches walked
  constexpr bool kByGroup = W::kExit == NB && W::kShare == NB &&
                            W::kShareIdle == NB;
  int done = 0;  // batches walked, warp-uniform
  for (int kb0 = k0; kb0 < k1; kb0 += 32 * NB) {
    uint32_t xw[NB];
    load_batches<NB>(col_idx, x, kb0, k1, lane, xw);
    bool stop = false;  // uniform
#pragma unroll
    for (int b = 0; b < NB; ++b) {  // past the item's end xw is 0
      bool hit = false;  // lane (g, r): word r of a tile it read met x
      read_live<T, W::kUnroll>(
          tiles, kb0 + 32 * b, __ballot_sync(kFull, xw[b] != 0), xw[b], g,
          r, [&](uint32_t tw, uint32_t xv) { hit |= (tw & xv) != 0; });
      const uint32_t bits = __ballot_sync(kFull, hit);  // bit g * T + r
#pragma unroll
      for (int q = 0; q < G; ++q) acc |= (bits >> (q * T)) & allowed;
      if constexpr (!kByGroup) ++done;
      if ((kByGroup ? b == NB - 1 : done % W::kExit == 0) &&
          acc == allowed) {
        stop = true;
        break;
      }
      // the items of a cut row share their hits through out: an item ORs
      // its own in and stops once the row's allowed lanes are all set
      // (its tiles not yet read could set no other bit)
      if (cut && (kByGroup ? b == NB - 1
                           : done % (acc ? W::kShare : W::kShareIdle) == 0)) {
        uint32_t seen = 0;
        if (lane == 0) seen = atomicOr(out + row, acc);
        if ((__shfl_sync(kFull, seen, 0) | acc) == allowed) {
          stop = true;
          break;
        }
      }
    }
    if (stop) break;
  }
  if (lane == 0) {
    if (!cut) out[row] = acc;
    else if (acc) atomicOr(out + row, acc);
  }
}

// Push: 4 batches a load, its exit and its share after the 4.
struct PushWalk {
  static constexpr int kGroup = kPushGroup;
  static constexpr int kExit = kPushExit;
  static constexpr int kShare = kPushShare;
  static constexpr int kShareIdle = kPushShare;
  static constexpr int kUnroll = kCountUnroll;
  static constexpr int kBlocksPerSM = kCountBlocksPerSM;
};

// Pull: push's loads; its exit after every batch, its share after every
// batch once it has a hit, every 8 before.
struct PullWalk {
  static constexpr int kGroup = kPullGroup;
  static constexpr int kExit = kPullExit;
  static constexpr int kShare = kPullShare;
  static constexpr int kShareIdle = kPullShareIdle;
  static constexpr int kUnroll = kPullUnroll;
  static constexpr int kBlocksPerSM = kPullBlocksPerSM;
};

using BffKernel = void (*)(const int32_t*, const uint32_t*, const int32_t*,
                           const int32_t*, const int32_t*, const float*,
                           float*, float*, int, float, float);
using BffMergeKernel = void (*)(const int32_t*, const int32_t*,
                                const int32_t*, const float*, float*, int);
using BbfKernel = void (*)(const int32_t*, const uint32_t*, const int32_t*,
                           const int32_t*, const int32_t*, const uint32_t*,
                           int32_t*, int);

template <int M>
BffKernel bff_for_t(int t) {
  switch (t) {
    case 4: return bmv_bff_kernel<4, M>;
    case 8: return bmv_bff_kernel<8, M>;
    case 16: return bmv_bff_kernel<16, M>;
    case 32: return bmv_bff_kernel<32, M>;
    default: return nullptr;
  }
}

BffKernel bff_for(int t, int mode) {
  switch (mode) {
    case kSum: return bff_for_t<kSum>(t);
    case kMinPlus: return bff_for_t<kMinPlus>(t);
    case kMaxTimes: return bff_for_t<kMaxTimes>(t);
    default: return nullptr;
  }
}

template <int M>
BffMergeKernel bff_merge_for_t(int t) {
  switch (t) {
    case 4: return bmv_bff_merge_kernel<4, M>;
    case 8: return bmv_bff_merge_kernel<8, M>;
    case 16: return bmv_bff_merge_kernel<16, M>;
    case 32: return bmv_bff_merge_kernel<32, M>;
    default: return nullptr;
  }
}

BffMergeKernel bff_merge_for(int t, int mode) {
  switch (mode) {
    case kSum: return bff_merge_for_t<kSum>(t);
    case kMinPlus: return bff_merge_for_t<kMinPlus>(t);
    case kMaxTimes: return bff_merge_for_t<kMaxTimes>(t);
    default: return nullptr;
  }
}

using WalkKernel = void (*)(const int32_t*, const uint32_t*, const int32_t*,
                            const int32_t*, const int32_t*, const uint32_t*,
                            const uint32_t*, const uint32_t*, uint32_t*, int,
                            int);

template <typename W>
WalkKernel walk_for(int t) {
  switch (t) {
    case 4: return bbb_walk<4, W>;
    case 8: return bbb_walk<8, W>;
    case 16: return bbb_walk<16, W>;
    case 32: return bbb_walk<32, W>;
    default: return nullptr;
  }
}

BbfKernel bbf_for(int t) {
  switch (t) {
    case 4: return bmv_bbf_kernel<4>;
    case 8: return bmv_bbf_kernel<8>;
    case 16: return bmv_bbf_kernel<16>;
    case 32: return bmv_bbf_kernel<32>;
    default: return nullptr;
  }
}

dim3 grid_for(int n) {
  return dim3((n + kWarpsPerBlock - 1) / kWarpsPerBlock);
}

int launch_walk(WalkKernel k, const void* col_idx, const void* tiles,
                const void* item_row, const void* item_begin,
                const void* item_slot, int n_items, const void* x,
                const void* mask, const void* lanes, void* out,
                int complement, void* stream) {
  if (k == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  if (n_items <= 0) return 0;
  k<<<grid_for(n_items), 32 * kWarpsPerBlock, 0,
      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(col_idx), static_cast<const uint32_t*>(tiles),
      static_cast<const int32_t*>(item_row),
      static_cast<const int32_t*>(item_begin),
      static_cast<const int32_t*>(item_slot), static_cast<const uint32_t*>(x),
      static_cast<const uint32_t*>(mask), static_cast<const uint32_t*>(lanes),
      static_cast<uint32_t*>(out), n_items, complement);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// mask may be null (keep every lane); out: uint32[R], zeroed by the caller
// (rows without tiles, or without an allowed lane, stay 0).
int bmv_bbb_push(const void* col_idx, const void* tiles, const void* item_row,
                 const void* item_begin, const void* item_slot, int n_items,
                 const void* x, const void* mask, void* out, int t,
                 int complement, void* stream) {
  return launch_walk(walk_for<PushWalk>(t), col_idx, tiles, item_row,
                     item_begin, item_slot, n_items, x, mask, nullptr, out,
                     complement, stream);
}

// bmv_bbb_push's arguments, mask not null, and lanes: uint32[R], the
// lanes some tile of each row can set (or a superset).
int bmv_bbb_pull(const void* col_idx, const void* tiles, const void* item_row,
                 const void* item_begin, const void* item_slot, int n_items,
                 const void* x, const void* mask, const void* lanes,
                 void* out, int t, int complement, void* stream) {
  if (mask == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return launch_walk(walk_for<PullWalk>(t), col_idx, tiles, item_row,
                     item_begin, item_slot, n_items, x, mask, lanes, out,
                     complement, stream);
}

// mode: 0 sum, 1 min_plus, 2 max_times; ident is the mode's identity.
// out: float32[R * t], filled with ident by the caller (rows without
// tiles keep it); scratch: float32[n_slots * t] for the items of cut rows.
int bmv_bff(const void* col_idx, const void* tiles, const void* item_row,
            const void* item_begin, const void* item_slot, int n_items,
            const void* cut_row, const void* cut_first, const void* cut_count,
            int n_cut, const void* x3, void* scratch, void* out, int t,
            int mode, float a_value, float ident, void* stream) {
  const BffKernel k = bff_for(t, mode);
  const BffMergeKernel km = bff_merge_for(t, mode);
  if (k == nullptr || km == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_items <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  k<<<grid_for(n_items), 32 * kWarpsPerBlock, 0, s>>>(
      static_cast<const int32_t*>(col_idx), static_cast<const uint32_t*>(tiles),
      static_cast<const int32_t*>(item_row),
      static_cast<const int32_t*>(item_begin),
      static_cast<const int32_t*>(item_slot), static_cast<const float*>(x3),
      static_cast<float*>(scratch), static_cast<float*>(out), n_items,
      a_value, ident);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_cut <= 0) return static_cast<int>(err);
  const int n_cells = n_cut * t;
  const int per_block = 32 * kWarpsPerBlock;
  km<<<(n_cells + per_block - 1) / per_block, per_block, 0, s>>>(
      static_cast<const int32_t*>(cut_row),
      static_cast<const int32_t*>(cut_first),
      static_cast<const int32_t*>(cut_count),
      static_cast<const float*>(scratch), static_cast<float*>(out), n_cells);
  return static_cast<int>(cudaGetLastError());
}

// out: int32[R * t], zeroed by the caller (rows without tiles stay 0).
int bmv_bbf(const void* col_idx, const void* tiles, const void* item_row,
            const void* item_begin, const void* item_slot, int n_items,
            const void* x, void* out, int t, void* stream) {
  const BbfKernel k = bbf_for(t);
  if (k == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  if (n_items <= 0) return 0;
  k<<<grid_for(n_items), 32 * kWarpsPerBlock, 0,
      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(col_idx), static_cast<const uint32_t*>(tiles),
      static_cast<const int32_t*>(item_row),
      static_cast<const int32_t*>(item_begin),
      static_cast<const int32_t*>(item_slot), static_cast<const uint32_t*>(x),
      static_cast<int32_t*>(out), n_items);
  return static_cast<int>(cudaGetLastError());
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
