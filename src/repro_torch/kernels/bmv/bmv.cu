// Boolean B2SR mxv kernels for Hopper (sm_90a): the BFS push and pull steps.
//
// Replace the TPU kernels in src/repro/kernels/bmv/bmv.py:
//   bmv_bbb_push  <- bmv_bin_bin_bin_pallas       (push step, mask at store)
//   bmv_bbb_pull  <- bmv_bin_bin_bin_pull_pallas  (pull step, early exit)
//
// Both walk the B2SR CSR-over-tiles arrays directly: tile_row_ptr
// int32[R+1], tile_col_idx int32[nT], bit_tiles uint32[nT, t], the packed
// frontier x uint32[C] and the mask uint32[R]; they write uint32[R]. The
// TPU kernels needed an ELL slab per static shape (and one launch per
// bucket); a warp here loops over its own row's tiles instead, so there
// is no padding and one launch per step.
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

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
