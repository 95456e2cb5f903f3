// Bit-packing kernels for Hopper (sm_90a): activation packing for the
// BitGNN layers, dense 0/1 -> B2SR tile packing and the per-tile bit
// transpose.
//
// Replace the TPU kernels in src/repro/kernels/bitpack/bitpack.py:
//   pack_rows      <- pack_rows_pallas      ([n, D] 0/1 -> uint32[R, D],
//                                            the node axis packed)
//   pack_dense     <- pack_dense_pallas     ([n, m] 0/1 -> uint32[R, C, t]
//                                            tiles, row- or column-major)
//   bit_transpose  <- bit_transpose_pallas  (uint32[N, t] -> each tile's
//                                            bit transpose)
//
// Words pack LSB first and keep only their low t bits, t in {4, 8, 16,
// 32}; R = ceil(n / t), C = ceil(m / t). Inputs are any shape, unpadded:
// rows and columns past n and m count as 0. An input entry is a set bit
// when it is non-zero: a 1-byte type (bool, uint8, int8), int32, or
// float32 (where -0.0 is zero). The TPU kernels did each as a VPU
// shift-and-sum over a block that the wrapper had padded to whole tiles;
// on Hopper all three move far more bytes than they compute, so each is
// laid out for coalesced loads and stores:
//
//   pack_rows: one thread per output word (c, j). It reads x[c*t + r, j]
//   for r < t: at each r a warp reads 32 neighbouring entries of a row.
//   pack_dense: one warp per (tile-row, strip of 32 columns); at each of
//   the t bit-rows the lanes read 32 neighbouring entries of one row.
//   Row-major, __ballot_sync of the lanes' bits gives the bit-row's word
//   of each tile of the strip (the paper's ballot); column-major, lane c
//   ORs its bit into bit r of its own word, which is column c's word.
//   bit_transpose: one thread per word, so a warp holds 32 / t whole
//   tiles, row r of a tile in lane r of its group; log2(t) butterfly
//   steps exchange the off-diagonal blocks of halving size between lane
//   r and lane r ^ j (__shfl_xor_sync), the register form of the paper's
//   ballot-and-rotate transpose.
//
// Bound: device-memory bytes, each input read once and each output
// written once: pack_rows n*D entries in and R*D words out; pack_dense
// n*m entries in and R*C*t words out; bit_transpose 4*N*t bytes each
// way (8.46 GB for the 33,033,055 tiles of R-MAT scale 21, t = 32:
// 2.5 ms at 3.35 TB/s). None does more than a few operations per byte.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ uint32_t low_bits(int t) {
  return t == 32 ? 0xffffffffu : ((1u << t) - 1u);
}

__device__ __forceinline__ bool nonzero(uint8_t v) { return v != 0; }
__device__ __forceinline__ bool nonzero(uint32_t v) { return v != 0; }
__device__ __forceinline__ bool nonzero(float v) { return v != 0.0f; }

template <typename E>
__global__ void __launch_bounds__(kThreads)
pack_rows_kernel(const E* __restrict__ x, uint32_t* __restrict__ out,
                 int64_t n, int D, int t, int64_t n_words) {
  const int64_t i = blockIdx.x * static_cast<int64_t>(kThreads) + threadIdx.x;
  if (i >= n_words) return;
  const int64_t c = i / D;
  const int j = static_cast<int>(i - c * D);
  uint32_t w = 0;
  for (int r = 0; r < t; ++r) {
    const int64_t row = c * t + r;
    if (row < n && nonzero(__ldg(x + row * D + j))) w |= 1u << r;
  }
  out[i] = w;
}

template <typename E>
__global__ void __launch_bounds__(kThreads)
pack_dense_kernel(const E* __restrict__ x, uint32_t* __restrict__ out,
                  int64_t n, int64_t m, int t, int64_t R, int64_t C,
                  int64_t n_strips, int col_major) {
  const int lane = threadIdx.x & 31;
  const int64_t warp = blockIdx.x * static_cast<int64_t>(kWarps) +
                       (threadIdx.x >> 5);
  const int64_t tr = warp / n_strips;
  if (tr >= R) return;  // uniform across the warp
  const int64_t col = (warp - tr * n_strips) * 32 + lane;
  const int64_t tc = col / t;  // this lane's tile of the strip
  const int c = lane % t;      // and its column in that tile
  const bool in_cols = col < m;
  uint32_t acc = 0;
  for (int r = 0; r < t; ++r) {
    const int64_t row = tr * t + r;
    const bool bit = in_cols && row < n && nonzero(__ldg(x + row * m + col));
    if (col_major) {
      acc |= static_cast<uint32_t>(bit) << r;
    } else {
      const uint32_t b = __ballot_sync(kFull, bit);
      if (c == 0 && tc < C)
        out[(tr * C + tc) * t + r] = (b >> lane) & low_bits(t);
    }
  }
  if (col_major && tc < C) out[(tr * C + tc) * t + c] = acc;
}

__global__ void __launch_bounds__(kThreads)
bit_transpose_kernel(const uint32_t* __restrict__ in,
                     uint32_t* __restrict__ out, int64_t n_words, int t) {
  const int64_t i = blockIdx.x * static_cast<int64_t>(kThreads) + threadIdx.x;
  const int lane = threadIdx.x & 31;
  // every lane takes part in the shuffles; lanes past the end carry 0
  uint32_t w = i < n_words ? (__ldg(in + i) & low_bits(t)) : 0u;
  // bits c with (c & j) == 0, for j = 16, 8, 4, 2, 1
  const uint32_t keep[5] = {0x0000ffffu, 0x00ff00ffu, 0x0f0f0f0fu,
                            0x33333333u, 0x55555555u};
  int s = 0;
  for (int j = 16; j >= 1; j >>= 1, ++s) {
    if (j >= t) continue;  // uniform: t is the same for every lane
    const uint32_t k = keep[s];
    const uint32_t o = __shfl_xor_sync(kFull, w, j);
    // the upper row of a block pair takes the lower row's left block into
    // its right block; the lower row the upper row's right block into its
    // left block
    w = (lane & j) ? ((w & ~k) | ((o >> j) & k)) : ((w & k) | ((o & k) << j));
  }
  if (i < n_words) out[i] = w;
}

bool valid_t(int t) { return t == 4 || t == 8 || t == 16 || t == 32; }

unsigned blocks_for(int64_t n, int per_block) {
  return static_cast<unsigned>((n + per_block - 1) / per_block);
}

}  // namespace

extern "C" {

// x: [n, D] entries of type elem (0: 1 byte, 1: int32, 2: float32);
// out: uint32[ceil(n / t), D].
int pack_rows(const void* x, int elem, void* out, int64_t n, int D, int t,
              void* stream) {
  if (!valid_t(t) || D <= 0 || elem < 0 || elem > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t n_words = (n + t - 1) / t * D;
  if (n_words <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  uint32_t* o = static_cast<uint32_t*>(out);
  const unsigned blocks = blocks_for(n_words, kThreads);
  if (elem == 0)
    pack_rows_kernel<<<blocks, kThreads, 0, s>>>(
        static_cast<const uint8_t*>(x), o, n, D, t, n_words);
  else if (elem == 1)
    pack_rows_kernel<<<blocks, kThreads, 0, s>>>(
        static_cast<const uint32_t*>(x), o, n, D, t, n_words);
  else
    pack_rows_kernel<<<blocks, kThreads, 0, s>>>(
        static_cast<const float*>(x), o, n, D, t, n_words);
  return static_cast<int>(cudaGetLastError());
}

// x: [n, m] entries of type elem; out: uint32[ceil(n / t), ceil(m / t), t].
int pack_dense(const void* x, int elem, void* out, int64_t n, int64_t m,
               int t, int col_major, void* stream) {
  if (!valid_t(t) || elem < 0 || elem > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t R = (n + t - 1) / t;
  const int64_t C = (m + t - 1) / t;
  if (R <= 0 || C <= 0) return 0;
  const int64_t n_strips = (C * t + 31) / 32;
  const unsigned blocks = blocks_for(R * n_strips, kWarps);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  uint32_t* o = static_cast<uint32_t*>(out);
  if (elem == 0)
    pack_dense_kernel<<<blocks, kThreads, 0, s>>>(
        static_cast<const uint8_t*>(x), o, n, m, t, R, C, n_strips,
        col_major);
  else if (elem == 1)
    pack_dense_kernel<<<blocks, kThreads, 0, s>>>(
        static_cast<const uint32_t*>(x), o, n, m, t, R, C, n_strips,
        col_major);
  else
    pack_dense_kernel<<<blocks, kThreads, 0, s>>>(
        static_cast<const float*>(x), o, n, m, t, R, C, n_strips, col_major);
  return static_cast<int>(cudaGetLastError());
}

// in, out: uint32[N, t] (n_words = N * t).
int bit_transpose(const void* in, void* out, int64_t n_words, int t,
                  void* stream) {
  if (!valid_t(t)) return static_cast<int>(cudaErrorInvalidValue);
  if (n_words <= 0) return 0;
  bit_transpose_kernel<<<blocks_for(n_words, kThreads), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(in), static_cast<uint32_t*>(out), n_words,
      t);
  return static_cast<int>(cudaGetLastError());
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
