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
//   pack_rows: a stream too ([2,097,152, 16] bool in, 4 MB of words out
//   at t = 32). A warp takes 32 consecutive rows (a group) and a run of
//   32 columns: lane l loads row l's run, with 16-byte loads where the
//   rows start on 16 bytes. Then one __ballot_sync a column gives the
//   column's 32 bits, one per row (the paper's ballot packing, which the
//   TPU kernel emulated with a shift-and-sum): word [g, j] at t = 32,
//   else 32 / t words cut t bits at a time. Lane j % 32 keeps column j's
//   bits, so each output row is stored as one coalesced run of up to 32
//   words. A warp walks kRowGroups groups, the next group's loads in
//   flight while this group's ballots run. At 16 bytes a row its
//   instructions weigh about as much as its bytes, so each ballot tests the
//   loaded word itself (__vcmpne4 for 1-byte entries: one predicate, the
//   vote and a select, about 4 instructions a column); gathering a run's
//   bits first, as pack_dense does, cost twice the instructions. Rows
//   off 16 bytes (D times the entry's bytes not a multiple of 16, a view
//   with a storage offset) are read one entry at a time; at D = 1 the
//   lanes' entries are neighbours, so those loads coalesce too.
//   pack_dense: a stream (1.07 GB of uint8 in, 134 MB of words out for a
//   [32768, 32768] matrix), laid out so that each lane loads 16 bytes at a
//   time, many loads in flight, and each tile's words are stored
//   together. A warp takes 32 consecutive rows and a run of columns:
//   lane l reads kPackRunBytes contiguous bytes of row l (at least 32
//   entries), all its 16-byte loads issued before any is used, and turns
//   them into bits a word at a time (__vcmpne4 and a multiply that
//   gathers the four bytes' top bits; 4-byte entries one compare each).
//   Its bits, cut t at a time, are word (l % t) of the run's tiles in
//   tile-row l / t, so the t lanes of a tile store its t words as one
//   coalesced run. Column-major, the t lanes first bit-transpose each
//   tile in registers with bit_transpose_kernel's butterfly. A row whose
//   start is not 16-byte aligned (a width m not a multiple of 16 bytes,
//   a view with a storage offset) and a run past the last column take a
//   scalar path in the kernel; rows past n read as 0.
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

#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ uint32_t low_bits(int t) {
  return t == 32 ? 0xffffffffu : ((1u << t) - 1u);
}

// The bit transpose of the t x t tile whose row r lane r of each group
// of t lanes holds in w (every lane of the warp takes part): log2(t)
// butterfly steps exchange the off-diagonal blocks of halving size
// between lane r and lane r ^ j.
__device__ __forceinline__ uint32_t transpose_lanes(uint32_t w, int t,
                                                   int lane) {
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
  return w;
}

// Bytes of its row a pack_dense lane reads (at least 32 entries; picked
// with tools/bitpack_variants.py on [32768, 32768] uint8 0/1, t = 32;
// NVIDIA H100 80GB HBM3, 700.00 W; ms in order and reversed, bound
// 0.361): 64 bytes 0.491, 0.465; 128 bytes 0.468, 0.497 (column-major
// 0.477, 0.488; float32 entries 1.775, 1.816, bound 1.322); 256 bytes
// 0.492, 0.489 (float32 1.92-1.93); 512 bytes 0.549-0.565.
constexpr int kPackRunBytes = 128;

// Bit i is set iff byte i of w is non-zero: __vcmpne4 sets a non-zero
// byte to 0xff, and the multiply moves the four top bits, at 7, 15, 23,
// 31, to 28..31 (no two partial products meet, so nothing carries).
__device__ __forceinline__ uint32_t byte_bits(uint32_t w) {
  return ((__vcmpne4(w, 0u) & 0x80808080u) * 0x00204081u) >> 28;
}

// Entry codes of pack_dense: 1-byte entries, int32, float32.
template <int E> struct Entries;
// Besides pack_dense's bits: pack_rows tests column i of a run held as
// 32-bit words h (kPerWord entries a word, h = word(load)) with
// h[i / kPerWord] & (kMask << (i % kPerWord) * kBytes * 8).
template <> struct Entries<0> {
  static constexpr int kBytes = 1;
  static constexpr int kPerWord = 4;
  static constexpr uint32_t kMask = 0xffu;
  static __device__ __forceinline__ uint32_t word(uint32_t v) {
    return __vcmpne4(v, 0u);  // 0xff for a non-zero byte
  }
  static __device__ __forceinline__ uint32_t bits(uint4 v) {  // 16 bits
    return byte_bits(v.x) | byte_bits(v.y) << 4 | byte_bits(v.z) << 8 |
           byte_bits(v.w) << 12;
  }
  static __device__ __forceinline__ bool one(const void* p, int64_t i) {
    return __ldg(static_cast<const uint8_t*>(p) + i) != 0;
  }
};
template <> struct Entries<1> {
  static constexpr int kBytes = 4;
  static constexpr int kPerWord = 1;
  static constexpr uint32_t kMask = 0xffffffffu;
  static __device__ __forceinline__ uint32_t word(uint32_t v) { return v; }
  static __device__ __forceinline__ uint32_t bits(uint4 v) {  // 4 bits
    return (v.x != 0) | (v.y != 0) << 1 | (v.z != 0) << 2 | (v.w != 0) << 3;
  }
  static __device__ __forceinline__ bool one(const void* p, int64_t i) {
    return __ldg(static_cast<const uint32_t*>(p) + i) != 0;
  }
};
template <> struct Entries<2> {  // float32: -0.0 is zero, NaN is not
  static constexpr int kBytes = 4;
  static constexpr uint32_t kMag = 0x7fffffffu;
  static constexpr int kPerWord = 1;
  static constexpr uint32_t kMask = kMag;
  static __device__ __forceinline__ uint32_t word(uint32_t v) { return v; }
  static __device__ __forceinline__ uint32_t bits(uint4 v) {
    return ((v.x & kMag) != 0) | ((v.y & kMag) != 0) << 1 |
           ((v.z & kMag) != 0) << 2 | ((v.w & kMag) != 0) << 3;
  }
  static __device__ __forceinline__ bool one(const void* p, int64_t i) {
    return (__ldg(static_cast<const uint32_t*>(p) + i) & kMag) != 0;
  }
};

// The head of this file: warp (row block rb, run) packs rows 32 rb ..
// 32 rb + 31, columns run * kRun .. + kRun (kRun entries, whole tiles).
// aligned: every row starts on 16 bytes.
template <int E, int T>
__global__ void __launch_bounds__(kThreads)
pack_dense_kernel(const void* __restrict__ x, uint32_t* __restrict__ out,
                  int64_t n, int64_t m, int64_t R, int64_t C,
                  int64_t n_runs, int aligned, int col_major) {
  using En = Entries<E>;
  constexpr int kRun = kPackRunBytes / En::kBytes < 32
                           ? 32 : kPackRunBytes / En::kBytes;
  constexpr int kVecs = kRun * En::kBytes / 16;   // 16-byte loads
  constexpr int kPerVec = 16 / En::kBytes;        // entries a load
  constexpr int kChunks = kRun / 32;              // words of 32 bits
  constexpr int kVecsPerChunk = 32 / kPerVec;
  const int lane = threadIdx.x & 31;
  const int64_t warp = blockIdx.x * static_cast<int64_t>(kWarps) +
                       (threadIdx.x >> 5);
  const int64_t rb = warp / n_runs;
  if (rb * 32 >= R * T) return;  // uniform across the warp
  const int64_t c0 = (warp - rb * n_runs) * kRun;
  const int64_t row = rb * 32 + lane;
  uint32_t chunk[kChunks];
  if (aligned && row < n && c0 + kRun <= m) {
    const uint4* v = reinterpret_cast<const uint4*>(
        static_cast<const char*>(x) + (row * m + c0) * En::kBytes);
    uint4 w[kVecs];
#pragma unroll
    for (int q = 0; q < kVecs; ++q) w[q] = __ldg(v + q);
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      chunk[c] = 0;
#pragma unroll
      for (int q = 0; q < kVecsPerChunk; ++q)
        chunk[c] |= En::bits(w[c * kVecsPerChunk + q]) << (q * kPerVec);
    }
  } else {  // the ragged edge, one entry at a time
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      chunk[c] = 0;
      for (int i = 0; i < 32; ++i) {
        const int64_t col = c0 + c * 32 + i;
        if (row < n && col < m && En::one(x, row * m + col))
          chunk[c] |= 1u << i;
      }
    }
  }
  const int64_t tr = row / T;  // this lane's tile-row, and word r of it
  const int r = lane % T;
#pragma unroll
  for (int j = 0; j < kRun / T; ++j) {
    uint32_t w = (chunk[j * T / 32] >> (j * T % 32)) & low_bits(T);
    if (col_major) w = transpose_lanes(w, T, lane);  // uniform
    const int64_t tc = c0 / T + j;
    if (tr < R && tc < C) out[(tr * C + tc) * T + r] = w;
  }
}

// Groups of 32 rows a pack_rows warp walks (picked with
// tools/bitpack_variants.py --kernel pack_rows on [2,097,152, 16] bool,
// t = 32; NVIDIA H100 80GB HBM3, 700.00 W; device ms in order and
// reversed, bound 0.0113): 1 group 0.0186, 0.0187; 2 0.0172, 0.0172; 4
// 0.0165, 0.0166; 8 0.0165, 0.0164 (float32 entries: 4 0.0472, 0.0473,
// 8 0.0477, 0.0476; D = 1 as bool: 4 0.0074, 0.0074, 8 0.0075, 0.0076).
constexpr int kRowGroups = 4;
// 1: rows that start on 16 bytes are read with 16-byte loads; 0: every
// row one entry at a time (a variant for the tool).
constexpr int kRowVectors = 1;

// This lane's row's run as kVecs 16-byte loads, nv of them live, all in
// flight together (a row past n loads nothing).
template <int kVecs>
__device__ __forceinline__ void load_run(const uint4* v, bool live, int nv,
                                         uint4 (&w)[kVecs]) {
#pragma unroll
  for (int q = 0; q < kVecs; ++q)
    w[q] = live && q < nv ? __ldg(v + q) : make_uint4(0, 0, 0, 0);
}

// The run's bits one entry at a time (x points at its first entry): bit i
// is entry i != 0. A whole run has its 32 loads in flight together.
template <typename En>
__device__ __forceinline__ uint32_t run_bits_scalar(const void* x,
                                                    bool live, int cols) {
  uint32_t b = 0;
  if (!live) return b;
  if (cols == 32) {
#pragma unroll
    for (int i = 0; i < 32; ++i)
      if (En::one(x, i)) b |= 1u << i;
  } else {
    for (int i = 0; i < cols; ++i)
      if (En::one(x, i)) b |= 1u << i;
  }
  return b;
}

// One group's words of its run's columns: column i is non-zero in a
// lane's run iff h[i / P] & (M << (i % P) * (32 / P)), and is 0 at and
// past cols. One ballot a column, lane i keeps column i's, and the lanes
// store each of the group's 32 / T output rows (o: its first word of
// this run) as one run of words; rows at or past R are not stored.
template <int T, int P, uint32_t M>
__device__ __forceinline__ void store_group(const uint32_t (&h)[32 / P],
                                            int lane, int cols, uint32_t* o,
                                            int64_t r0, int64_t R, int D) {
  uint32_t mine = 0;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    // uniform across the warp; the 16-byte loads' cols is a multiple of 4
    if (i % (P == 32 ? 1 : 4) == 0 && i >= cols) break;
    const uint32_t b =
        __ballot_sync(kFull, h[i / P] & (M << (i % P) * (32 / P)));
    if (lane == i) mine = b;
  }
  if (lane >= cols) return;
#pragma unroll
  for (int k = 0; k < 32 / T; ++k)
    if (r0 + k < R) o[k * static_cast<int64_t>(D)] = (mine >> (k * T)) &
                                                       low_bits(T);
}

// Warp w of the x axis packs rows 32 (w * kRowGroups + k) + lane, k <
// kRowGroups, and columns c_base + 32 blockIdx.y .. + 31. aligned: every
// row starts on 16 bytes.
template <int E, int T>
__global__ void __launch_bounds__(kThreads)
pack_rows_kernel(const void* __restrict__ x, uint32_t* __restrict__ out,
                 int64_t n, int D, int64_t R, int c_base, int aligned) {
  using En = Entries<E>;
  constexpr int kVecs = 32 * En::kBytes / 16;  // 16-byte loads a run
  const int lane = threadIdx.x & 31;
  const int c0 = c_base + blockIdx.y * 32;
  const int cols = min(32, D - c0);
  const int64_t g0 = (blockIdx.x * static_cast<int64_t>(kWarps) +
                      (threadIdx.x >> 5)) * kRowGroups;
  const int n_groups = static_cast<int>(
      min(static_cast<int64_t>(kRowGroups), (n + 31) / 32 - g0));
  if (n_groups <= 0) return;  // uniform across the warp
  const int64_t row = g0 * 32 + lane;
  const char* p = static_cast<const char*>(x) + (row * D + c0) * En::kBytes;
  const int64_t step = 32 * static_cast<int64_t>(D) * En::kBytes;
  uint32_t* o = out + g0 * (32 / T) * D + c0 + lane;
  const int64_t o_step = (32 / T) * static_cast<int64_t>(D);
  if (aligned) {
    const int nv = cols * En::kBytes / 16;
    uint4 w[2][kVecs];  // this group's loads and the next group's
    load_run(reinterpret_cast<const uint4*>(p), row < n, nv, w[0]);
#pragma unroll
    for (int k = 0; k < kRowGroups; ++k) {
      if (k >= n_groups) break;  // uniform
      if (k + 1 < kRowGroups)
        load_run(reinterpret_cast<const uint4*>(p + (k + 1) * step),
                 row + (k + 1) * 32 < n, nv, w[(k + 1) & 1]);
      uint32_t h[32 / En::kPerWord];
#pragma unroll
      for (int q = 0; q < kVecs; ++q) {
        const uint4 v = w[k & 1][q];
        const uint32_t u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int c = 0; c < 4; ++c) h[q * 4 + c] = En::word(u[c]);
      }
      store_group<T, En::kPerWord, En::kMask>(
          h, lane, cols, o + k * o_step, (g0 + k) * (32 / T), R, D);
    }
  } else {
#pragma unroll
    for (int k = 0; k < kRowGroups; ++k) {
      if (k >= n_groups) break;  // uniform
      const uint32_t h[1] = {run_bits_scalar<En>(p + k * step,
                                                 row + k * 32 < n, cols)};
      store_group<T, 32, 1u>(h, lane, cols, o + k * o_step,
                             (g0 + k) * (32 / T), R, D);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
bit_transpose_kernel(const uint32_t* __restrict__ in,
                     uint32_t* __restrict__ out, int64_t n_words, int t) {
  const int64_t i = blockIdx.x * static_cast<int64_t>(kThreads) + threadIdx.x;
  // every lane takes part in the shuffles; lanes past the end carry 0
  const uint32_t w = i < n_words ? (__ldg(in + i) & low_bits(t)) : 0u;
  const uint32_t o = transpose_lanes(w, t, threadIdx.x & 31);
  if (i < n_words) out[i] = o;
}

bool valid_t(int t) { return t == 4 || t == 8 || t == 16 || t == 32; }

using RowsKernel = void (*)(const void*, uint32_t*, int64_t, int, int64_t,
                            int, int);

template <int E>
RowsKernel rows_for_t(int t) {
  switch (t) {
    case 4: return pack_rows_kernel<E, 4>;
    case 8: return pack_rows_kernel<E, 8>;
    case 16: return pack_rows_kernel<E, 16>;
    case 32: return pack_rows_kernel<E, 32>;
    default: return nullptr;
  }
}

RowsKernel rows_for(int elem, int t) {
  switch (elem) {
    case 0: return rows_for_t<0>(t);
    case 1: return rows_for_t<1>(t);
    case 2: return rows_for_t<2>(t);
    default: return nullptr;
  }
}

using PackKernel = void (*)(const void*, uint32_t*, int64_t, int64_t, int64_t,
                            int64_t, int64_t, int, int);

template <int E>
PackKernel pack_for_t(int t) {
  switch (t) {
    case 4: return pack_dense_kernel<E, 4>;
    case 8: return pack_dense_kernel<E, 8>;
    case 16: return pack_dense_kernel<E, 16>;
    case 32: return pack_dense_kernel<E, 32>;
    default: return nullptr;
  }
}

PackKernel pack_for(int elem, int t) {
  switch (elem) {
    case 0: return pack_for_t<0>(t);
    case 1: return pack_for_t<1>(t);
    case 2: return pack_for_t<2>(t);
    default: return nullptr;
  }
}

unsigned blocks_for(int64_t n, int per_block) {
  return static_cast<unsigned>((n + per_block - 1) / per_block);
}

}  // namespace

extern "C" {

// x: [n, D] entries of type elem (0: 1 byte, 1: int32, 2: float32);
// out: uint32[ceil(n / t), D].
int pack_rows(const void* x, int elem, void* out, int64_t n, int D, int t,
              void* stream) {
  const RowsKernel k = rows_for(elem, t);
  const int64_t n_warps = ((n + 31) / 32 + kRowGroups - 1) / kRowGroups;
  if (k == nullptr || D <= 0 || (n_warps + kWarps - 1) / kWarps > INT32_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0) return 0;
  const int bytes = elem == 0 ? 1 : 4;
  const int aligned = kRowVectors && reinterpret_cast<uintptr_t>(x) % 16 == 0
                      && (static_cast<int64_t>(D) * bytes) % 16 == 0;
  // runs of 32 columns on the grid's y axis, 65,535 a launch
  const int64_t n_runs = (static_cast<int64_t>(D) + 31) / 32;
  for (int64_t r0 = 0; r0 < n_runs; r0 += 65535) {
    const dim3 grid(blocks_for(n_warps, kWarps),
                    static_cast<unsigned>(std::min<int64_t>(n_runs - r0,
                                                            65535)));
    k<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        x, static_cast<uint32_t*>(out), n, D, (n + t - 1) / t,
        static_cast<int>(r0 * 32), aligned);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

// x: [n, m] entries of type elem; out: uint32[ceil(n / t), ceil(m / t), t].
int pack_dense(const void* x, int elem, void* out, int64_t n, int64_t m,
               int t, int col_major, void* stream) {
  const PackKernel k = pack_for(elem, t);
  if (k == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t R = (n + t - 1) / t;
  const int64_t C = (m + t - 1) / t;
  if (R <= 0 || C <= 0) return 0;
  const int bytes = elem == 0 ? 1 : 4;
  const int64_t run = std::max(kPackRunBytes / bytes, 32);
  const int64_t n_runs = (C * t + run - 1) / run;
  const int64_t n_blocks32 = (R * t + 31) / 32;
  const int aligned = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                      (m * bytes) % 16 == 0;
  k<<<blocks_for(n_blocks32 * n_runs, kWarps), kThreads, 0,
      static_cast<cudaStream_t>(stream)>>>(x, static_cast<uint32_t*>(out), n,
                                           m, R, C, n_runs, aligned,
                                           col_major);
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
