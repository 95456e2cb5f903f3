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
// bucket); a warp here loops over its own row's tiles instead, so there
// is no padding and one launch per step.
//
// --- bmv_bbb_push / bmv_bbb_pull ------------------------------------------
//
// Inputs: the packed frontier x uint32[C] and the mask uint32[R]; output
// uint32[R].
//
// Layout: one warp per tile-row. Lanes stride over the row's tiles; a
// lane gathers xw = x[col] and, only when xw != 0, loads the tile's t
// words (16-byte vector loads) and sets bit r of its partial word if
// tile[r] & xw != 0. A warp OR-reduce (__reduce_or_sync) merges lanes.
//
// Bound: device-memory bytes. Per tile the work is t ANDs against a
// 4t-byte read, far below the card's operations-per-byte line; skipping
// tiles whose frontier word is zero is what keeps a sparse push frontier
// from reading the whole graph. The pull kernel also skips rows with no
// allowed lane and stops a row as soon as every allowed lane is set.
//
// Bit-exactness of the early exit: the accumulator only ever ORs
// (hits & allowed), so once it equals `allowed` the tiles not yet read
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

// Bit r of the result is set iff tile word r shares a bit with xw.
template <int T>
__device__ __forceinline__ uint32_t tile_hits(const uint32_t* __restrict__ tile,
                                              uint32_t xw) {
  uint32_t hit = 0;
  const uint4* v = reinterpret_cast<const uint4*>(tile);
#pragma unroll
  for (int q = 0; q < T / 4; ++q) {
    const uint4 w = __ldg(v + q);
    hit |= static_cast<uint32_t>((w.x & xw) != 0) << (4 * q);
    hit |= static_cast<uint32_t>((w.y & xw) != 0) << (4 * q + 1);
    hit |= static_cast<uint32_t>((w.z & xw) != 0) << (4 * q + 2);
    hit |= static_cast<uint32_t>((w.w & xw) != 0) << (4 * q + 3);
  }
  return hit;
}

template <int T>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
bmv_bbb_push_kernel(const int32_t* __restrict__ row_ptr,
                    const int32_t* __restrict__ col_idx,
                    const uint32_t* __restrict__ tiles,
                    const uint32_t* __restrict__ x,
                    const uint32_t* __restrict__ mask,
                    uint32_t* __restrict__ out, int n_rows, int complement) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= n_rows) return;  // uniform across the warp
  const int begin = row_ptr[row];
  const int end = row_ptr[row + 1];
  uint32_t acc = 0;
  for (int k = begin + lane; k < end; k += 32) {
    const uint32_t xw = __ldg(x + col_idx[k]);
    if (xw) acc |= tile_hits<T>(tiles + static_cast<size_t>(k) * T, xw);
  }
  acc = __reduce_or_sync(kFull, acc);
  if (lane == 0) {
    const uint32_t m = mask ? mask[row] : 0u;
    out[row] = acc & (complement ? ~m : m) & lane_mask<T>();
  }
}

template <int T>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
bmv_bbb_pull_kernel(const int32_t* __restrict__ row_ptr,
                    const int32_t* __restrict__ col_idx,
                    const uint32_t* __restrict__ tiles,
                    const uint32_t* __restrict__ x,
                    const uint32_t* __restrict__ mask,
                    uint32_t* __restrict__ out, int n_rows, int complement) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= n_rows) return;  // uniform across the warp
  const uint32_t m = mask[row];
  const uint32_t allowed = (complement ? ~m : m) & lane_mask<T>();
  uint32_t acc = 0;
  if (allowed) {
    const int end = row_ptr[row + 1];
    for (int k0 = row_ptr[row]; k0 < end; k0 += 32) {
      const int k = k0 + lane;
      uint32_t hit = 0;
      if (k < end) {
        const uint32_t xw = __ldg(x + col_idx[k]);
        if (xw) hit = tile_hits<T>(tiles + static_cast<size_t>(k) * T, xw);
      }
      // acc is warp-uniform, so the exit below is taken by all lanes at once
      acc |= __reduce_or_sync(kFull, hit & allowed);
      if (acc == allowed) break;
    }
  }
  if (lane == 0) out[row] = acc;
}

using Kernel = void (*)(const int32_t*, const int32_t*, const uint32_t*,
                        const uint32_t*, const uint32_t*, uint32_t*, int, int);

Kernel push_for(int t) {
  switch (t) {
    case 4: return bmv_bbb_push_kernel<4>;
    case 8: return bmv_bbb_push_kernel<8>;
    case 16: return bmv_bbb_push_kernel<16>;
    case 32: return bmv_bbb_push_kernel<32>;
    default: return nullptr;
  }
}

Kernel pull_for(int t) {
  switch (t) {
    case 4: return bmv_bbb_pull_kernel<4>;
    case 8: return bmv_bbb_pull_kernel<8>;
    case 16: return bmv_bbb_pull_kernel<16>;
    case 32: return bmv_bbb_pull_kernel<32>;
    default: return nullptr;
  }
}

int launch(Kernel k, const void* row_ptr, const void* col_idx,
           const void* tiles, const void* x, const void* mask, void* out,
           int n_rows, int complement, void* stream) {
  if (k == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  if (n_rows <= 0) return 0;
  const dim3 block(32 * kWarpsPerBlock);
  const dim3 grid((n_rows + kWarpsPerBlock - 1) / kWarpsPerBlock);
  k<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(row_ptr), static_cast<const int32_t*>(col_idx),
      static_cast<const uint32_t*>(tiles), static_cast<const uint32_t*>(x),
      static_cast<const uint32_t*>(mask), static_cast<uint32_t*>(out), n_rows,
      complement);
  return static_cast<int>(cudaGetLastError());
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
// Layout: one warp per tile-row, lanes striding over the row's tiles as
// in push. A lane keeps t accumulators, one per bit-row, loads the tile's
// t words (16-byte vector loads) and, for each set bit (r, c), gathers
// x3[col][c] and folds a (x) x into accumulator r: work per tile is its
// set bits, not t * t. A butterfly reduce-scatter (t - 1 + log2(32 / t)
// shuffles) then leaves bit-row r's total in lane r, which stores it. The
// order of the sum is fixed (tiles in lane order, then the butterfly), so
// the result is the same from run to run; it differs from a sequential
// sum by float32 rounding only.
//
// Bound: device-memory bytes. Each tile is read whole (x is dense, no
// tile can be skipped): at R-MAT scale 21 with t = 32, 4.23 GB of tiles,
// 132 MB of column indices and 8.4 MB each of x and y, about 1.31 ms at
// 3.35 TB/s, against about 2 floating-point operations per set bit
// (127 M here, 100 times below the byte line). A hub tile-row is walked
// by one warp, so the longest row (40,500 tiles) sets a floor on the
// launch, as it does for push.
//
// --- bmv_bbf: count mxv, y[i*t + r] = sum_k popc(tile_k[r] & x[col_k]) ---
//
// Inputs: the packed x uint32[C]; output int32[R * t]. Same layout as
// bmv_bff with integer accumulators: a lane skips a tile whose x word is
// zero (as push does) and otherwise adds popc(word_r & xw) to
// accumulator r. Integer sums are exact in any order. Bound: bytes, by
// push's rule (the tiles whose x word is non-zero, plus every column
// index); at full x density about 4.36 GB, 1.30 ms at scale 21.

namespace {

enum Mode { kSum = 0, kMinPlus = 1, kMaxTimes = 2 };

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

struct IntPlus {
  static __device__ __forceinline__ int add(int p, int q) { return p + q; }
};

// Reduce t per-lane accumulators across the warp: afterwards lane l holds
// the warp's total of accumulator l % T. A reduce-scatter halves the live
// values at each step (T - 1 shuffles), then the groups of T lanes fold.
template <int T, typename Op, typename V>
__device__ __forceinline__ V warp_reduce_scatter(V (&acc)[T], int lane) {
#pragma unroll
  for (int w = T / 2; w >= 1; w /= 2) {
    const bool upper = (lane & w) != 0;
#pragma unroll
    for (int i = 0; i < w; ++i) {
      const V send = upper ? acc[i] : acc[i + w];
      const V keep = upper ? acc[i + w] : acc[i];
      acc[i] = Op::add(keep, __shfl_xor_sync(kFull, send, w));
    }
  }
#pragma unroll
  for (int o = T; o < 32; o *= 2) {
    acc[0] = Op::add(acc[0], __shfl_xor_sync(kFull, acc[0], o));
  }
  return acc[0];
}

// Fold a (x) x[c] into acc for every set bit c of word w.
template <int M>
__device__ __forceinline__ void fold_bits(float& acc, uint32_t w,
                                          const float* __restrict__ xt,
                                          float a) {
  while (w) {
    const int c = __ffs(w) - 1;
    w &= w - 1;
    acc = Semi<M>::add(acc, Semi<M>::mul(a, __ldg(xt + c)));
  }
}

template <int T, int M>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
bmv_bff_kernel(const int32_t* __restrict__ row_ptr,
               const int32_t* __restrict__ col_idx,
               const uint32_t* __restrict__ tiles,
               const float* __restrict__ x3, float* __restrict__ out,
               int n_rows, float a, float ident) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= n_rows) return;  // uniform across the warp
  float acc[T];
#pragma unroll
  for (int r = 0; r < T; ++r) acc[r] = ident;
  const int end = row_ptr[row + 1];
  for (int k = row_ptr[row] + lane; k < end; k += 32) {
    const float* xt = x3 + static_cast<size_t>(col_idx[k]) * T;
    const uint4* v = reinterpret_cast<const uint4*>(
        tiles + static_cast<size_t>(k) * T);
#pragma unroll
    for (int q = 0; q < T / 4; ++q) {
      const uint4 w = __ldg(v + q);
      fold_bits<M>(acc[4 * q], w.x, xt, a);
      fold_bits<M>(acc[4 * q + 1], w.y, xt, a);
      fold_bits<M>(acc[4 * q + 2], w.z, xt, a);
      fold_bits<M>(acc[4 * q + 3], w.w, xt, a);
    }
  }
  const float y = warp_reduce_scatter<T, Semi<M>>(acc, lane);
  if (lane < T) out[static_cast<size_t>(row) * T + lane] = y;
}

template <int T>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
bmv_bbf_kernel(const int32_t* __restrict__ row_ptr,
               const int32_t* __restrict__ col_idx,
               const uint32_t* __restrict__ tiles,
               const uint32_t* __restrict__ x, int32_t* __restrict__ out,
               int n_rows) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= n_rows) return;  // uniform across the warp
  int acc[T];
#pragma unroll
  for (int r = 0; r < T; ++r) acc[r] = 0;
  const int end = row_ptr[row + 1];
  for (int k = row_ptr[row] + lane; k < end; k += 32) {
    const uint32_t xw = __ldg(x + col_idx[k]);
    if (!xw) continue;
    const uint4* v = reinterpret_cast<const uint4*>(
        tiles + static_cast<size_t>(k) * T);
#pragma unroll
    for (int q = 0; q < T / 4; ++q) {
      const uint4 w = __ldg(v + q);
      acc[4 * q] += __popc(w.x & xw);
      acc[4 * q + 1] += __popc(w.y & xw);
      acc[4 * q + 2] += __popc(w.z & xw);
      acc[4 * q + 3] += __popc(w.w & xw);
    }
  }
  const int y = warp_reduce_scatter<T, IntPlus>(acc, lane);
  if (lane < T) out[static_cast<size_t>(row) * T + lane] = y;
}

using BffKernel = void (*)(const int32_t*, const int32_t*, const uint32_t*,
                           const float*, float*, int, float, float);
using BbfKernel = void (*)(const int32_t*, const int32_t*, const uint32_t*,
                           const uint32_t*, int32_t*, int);

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

BbfKernel bbf_for(int t) {
  switch (t) {
    case 4: return bmv_bbf_kernel<4>;
    case 8: return bmv_bbf_kernel<8>;
    case 16: return bmv_bbf_kernel<16>;
    case 32: return bmv_bbf_kernel<32>;
    default: return nullptr;
  }
}

dim3 grid_for(int n_rows) {
  return dim3((n_rows + kWarpsPerBlock - 1) / kWarpsPerBlock);
}

}  // namespace

extern "C" {

// mask may be null for push (no mask: keep every lane).
int bmv_bbb_push(const void* row_ptr, const void* col_idx, const void* tiles,
                 const void* x, const void* mask, void* out, int n_rows, int t,
                 int complement, void* stream) {
  return launch(push_for(t), row_ptr, col_idx, tiles, x, mask, out, n_rows,
                complement, stream);
}

int bmv_bbb_pull(const void* row_ptr, const void* col_idx, const void* tiles,
                 const void* x, const void* mask, void* out, int n_rows, int t,
                 int complement, void* stream) {
  return launch(pull_for(t), row_ptr, col_idx, tiles, x, mask, out, n_rows,
                complement, stream);
}

// mode: 0 sum, 1 min_plus, 2 max_times; ident is the mode's identity.
int bmv_bff(const void* row_ptr, const void* col_idx, const void* tiles,
            const void* x3, void* out, int n_rows, int t, int mode,
            float a_value, float ident, void* stream) {
  const BffKernel k = bff_for(t, mode);
  if (k == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  if (n_rows <= 0) return 0;
  k<<<grid_for(n_rows), 32 * kWarpsPerBlock, 0,
      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(row_ptr), static_cast<const int32_t*>(col_idx),
      static_cast<const uint32_t*>(tiles), static_cast<const float*>(x3),
      static_cast<float*>(out), n_rows, a_value, ident);
  return static_cast<int>(cudaGetLastError());
}

int bmv_bbf(const void* row_ptr, const void* col_idx, const void* tiles,
            const void* x, void* out, int n_rows, int t, void* stream) {
  const BbfKernel k = bbf_for(t);
  if (k == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  if (n_rows <= 0) return 0;
  k<<<grid_for(n_rows), 32 * kWarpsPerBlock, 0,
      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(row_ptr), static_cast<const int32_t*>(col_idx),
      static_cast<const uint32_t*>(tiles), static_cast<const uint32_t*>(x),
      static_cast<int32_t*>(out), n_rows);
  return static_cast<int>(cudaGetLastError());
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
