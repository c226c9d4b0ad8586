// BA-CAM binary matrix product: the full score matrix d - 2 * popcount(q ^ k).
//
// Replaces the TPU kernel kernels/bacam_mvm.py::bacam_mvm of the reference
// package (and, through a loop over bit planes, kernels/bitslice_vmm.py).
//
// For every batch b, query row r and key j it writes
//     out[b, r, j] = d - 2 * popcount(q[b, r, :] ^ k[b, j, :])
// over W = d / 32 packed 32-bit words (int32 tensors carrying uint32 bits),
// 1 <= W <= 8.  The result is bit-exact; there is no masking and no padding:
// each kernel masks its own ragged edge in rows and keys.
//
// Bound.  The int32 scores are more than 99% of the bytes at every path
// shape: at camformer-bert's contiguous prefill (B * H_kv = 128, R = Skv =
// 896, W = 2) the kernel writes 411 MB from 1.8 MB of packed operands, about
// 123 us at 3.35 TB/s.  Two things can hold a design above that: its
// arithmetic, and stores that do not fill whole 128-byte lines.  Scored with
// xor, popc and add per word, recurrentgemma-2b's prefill (4, 20160, 2016),
// W = 8, needs 1.30 G popc, about 0.31 ms at 16 a clock per SM, against the
// 0.195 ms its 650 MB of scores take.  And a row of 1500 scores (whisper's
// encoder) is 6000 bytes, so a 128-byte store per warp straddles two lines
// and leaves partial sectors at both ends: the same popc kernel takes 1.55x
// its bound there and 1.11x at 1504 keys (PERF.md).
//
// Two designs; `choose_design` picks one from the shapes alone (PERF.md has
// the times the rule comes from), and `bacam_mvm_plan` reports its choice.
//
// 1. Tensor cores (R >= 64).  Grid (key tiles of 128, row tiles of 64, B);
//    4 warps, each all 64 rows by a quarter of the tile's keys.  The block
//    copies its packed q rows and keys into shared memory, every load issued
//    before the first store, multiplies (two products, below), stages the
//    int32 tile in shared memory over the operands and stores it (below).
//    - s8 (W <= 2): for +-1 vectors q . k = d - 2 popc(q ^ k), so each
//      packed word is expanded in registers into 32 signed bytes (bit 1 ->
//      +1, bit 0 -> -1) and multiplied with mma.sync m16n8k32 s8 x s8 ->
//      s32, one k-step a word: the int32 sum is the score itself, exact
//      (|score| <= 256).  A dot product does not change under a permutation
//      of the d positions that q and k share, so fragment bytes 4 t + i and
//      16 + 4 t + i of lane t take bits t + 8 i and t + 4 + 8 i of the word,
//      for both operands alike: a shift, a mask and a multiply per 4 bytes.
//    - b1 (W >= 3): the packed words are the fragments of mma.sync
//      m16n8k128 (W <= 4) or m16n8k256 .b1 .xor.popc, which sums
//      popc(q ^ k) over 128 or 256 bits (words past W are zeros in both
//      operands); the score is d - 2 * sum.  No expansion: one mma a 16 x 8
//      tile whatever W.  At W = 8 it is the faster product, at W = 2 the s8
//      one (PERF.md).
// 2. popc (R < 64: decode steps, short prefills, where a 64-row tile would
//    be mostly idle rows).  One thread per key holds the key's W words in
//    registers; the block stages 32 query rows in shared memory, where every
//    lane reads the same word (a broadcast), and writes each row's 128
//    consecutive scores straight from registers (128 bytes a warp).  These
//    launches cost about the launch floor.
//
// Store path of design 1.  Each warp writes one staged row at a time with
// 16-byte streaming stores, 512 contiguous bytes per instruction.  Where a
// row of scores is not a whole number of 128-byte lines (Skv * 4 % 128 != 0),
// a block owns, in each row, the keys from the line boundary at or below its
// tile's first key to the line boundary at or below the next tile's: every
// line of a row but its first and last is written whole, by one block, in
// one instruction.  For that the block also computes the 32 keys left of its
// tile.  Where Skv is no multiple of 4 (rows not 16-byte aligned; on no
// model path) the staged rows go out 4 bytes a lane.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

enum Design { kTensorS8 = 0, kTensorB1 = 1, kPopc = 2 };

// ---------------------------------------------------------------------------
// design 1: tensor cores

constexpr int kTcRows = 64;      // query rows per block
constexpr int kTcKeys = 128;     // keys per block tile
constexpr int kTcThreads = 128;  // 4 warps
constexpr int kLineInts = 32;    // int32 scores in a 128-byte line

// packed words a b1 product step takes: 4 (k128) up to W = 4, else 8 (k256);
// zeros past W
template <int W>
__host__ __device__ constexpr int b1_words() { return W <= 4 ? 4 : 8; }

// words of a shared operand row: s8, the W packed words, odd (the 8 rows of
// a fragment load lie in 8 banks); b1, 4 (k128: 8 rows x 4 words in 32
// banks) or 8 + 4 (k256: rows 12 words apart, 8 rows x 4 words in 32 banks)
template <int W, bool kB1>
__host__ __device__ constexpr int operand_stride() {
  return kB1 ? (W <= 4 ? 4 : 12) : (W | 1);
}

template <bool kLines>
__host__ __device__ constexpr int tile_cols() {
  return kTcKeys + (kLines ? kLineInts : 0);
}

// int32 stage row: the tile's columns + 8 (== 8 mod 32: the fragments'
// 8-byte stores do not conflict)
template <bool kLines>
__host__ __device__ constexpr int stage_stride() {
  return tile_cols<kLines>() + 8;
}

template <int W, bool kB1, bool kLines>
__host__ __device__ constexpr size_t tc_smem() {
  const size_t operands = sizeof(uint32_t) * (kTcRows + tile_cols<kLines>()) *
                          operand_stride<W, kB1>();
  const size_t stage = sizeof(int32_t) * kTcRows * stage_stride<kLines>();
  return operands > stage ? operands : stage;
}

// byte i: +1 (0x01) where bit j + 8 i of `word` is set, -1 (0xff) where not
__device__ __forceinline__ uint32_t pm1_bytes(uint32_t word, int j) {
  const uint32_t m = (word >> j) & 0x01010101u;
  return ~(m * 0xfeu);
}

__device__ __forceinline__ void mma_s8(int32_t (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += popcount(a ^ b) over 128 bits
__device__ __forceinline__ void mma_b1(int32_t (&c)[4], const uint32_t (&a)[2],
                                       uint32_t b0) {
  asm volatile(
      "mma.sync.aligned.m16n8k128.row.col.s32.b1.b1.s32.xor.popc "
      "{%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(b0));
}

// c += popcount(a ^ b) over 256 bits
__device__ __forceinline__ void mma_b1(int32_t (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.xor.popc "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Shared rows 0..N-1 <- the packed rows first..first+N-1 of `src`, kWords
// words a row (words past W, and rows outside [0, valid), are zeros;
// nothing reads the scores of those rows back).  Every load is issued
// before the first store.
template <int W, bool kB1, int N>
__device__ __forceinline__ void load_rows(uint32_t* dst,
                                          const uint32_t* __restrict__ src,
                                          int first, int valid) {
  constexpr int kWords = kB1 ? b1_words<W>() : W;
  constexpr int kIters = (N * kWords + kTcThreads - 1) / kTcThreads;
  uint32_t v[kIters];
#pragma unroll
  for (int it = 0; it < kIters; ++it) {
    const int i = threadIdx.x + it * kTcThreads;
    const int r = first + i / kWords;
    const int w = i % kWords;
    v[it] = i < N * kWords && w < W && r >= 0 && r < valid
                ? src[static_cast<size_t>(r) * W + w]
                : 0u;
  }
#pragma unroll
  for (int it = 0; it < kIters; ++it) {
    const int i = threadIdx.x + it * kTcThreads;
    if (i < N * kWords)
      dst[(i / kWords) * operand_stride<W, kB1>() + i % kWords] = v[it];
  }
}

// acc = the warp's 64 x 8 kNt scores (s8) or mismatch counts (b1), columns
// c0.. of the tile (m16n8k32, k128, k256: lane g * 4 + t holds rows g and
// g + 8 of A, column g of B)
template <int W, bool kB1, int kNt>
__device__ __forceinline__ void tile_product(int32_t (&acc)[4][kNt][4],
                                             const uint32_t* qs,
                                             const uint32_t* ks, int c0,
                                             int g, int t) {
  constexpr int kStride = operand_stride<W, kB1>();
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < kNt; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0;
  if constexpr (kB1 && b1_words<W>() == 4) {  // bits 32 t..: word t
    uint32_t a[4][2];
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
      a[mt][0] = qs[(mt * 16 + g) * kStride + t];
      a[mt][1] = qs[(mt * 16 + g + 8) * kStride + t];
    }
#pragma unroll
    for (int nt = 0; nt < kNt; ++nt) {
      const uint32_t b0 = ks[(c0 + nt * 8 + g) * kStride + t];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) mma_b1(acc[mt][nt], a[mt], b0);
    }
  } else if constexpr (kB1) {  // bits 32 t.., 128 + 32 t..: words t, t + 4
    uint32_t a[4][4];
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
      const uint32_t* p = qs + (mt * 16 + g) * kStride + t;
      a[mt][0] = p[0];
      a[mt][1] = p[8 * kStride];
      a[mt][2] = p[4];
      a[mt][3] = p[8 * kStride + 4];
    }
#pragma unroll
    for (int nt = 0; nt < kNt; ++nt) {
      const uint32_t* p = ks + (c0 + nt * 8 + g) * kStride + t;
      const uint32_t b0 = p[0];
      const uint32_t b1 = p[4];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) mma_b1(acc[mt][nt], a[mt], b0, b1);
    }
  } else {  // a k32 step a word: bytes 4 t + i, 16 + 4 t + i of lane t's
            // A and B fragments <- bits t + 8 i, t + 4 + 8 i of the word
#pragma unroll
    for (int w = 0; w < W; ++w) {
      uint32_t a[4][4];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        const uint32_t lo = qs[(mt * 16 + g) * kStride + w];
        const uint32_t hi = qs[(mt * 16 + g + 8) * kStride + w];
        a[mt][0] = pm1_bytes(lo, t);
        a[mt][1] = pm1_bytes(hi, t);
        a[mt][2] = pm1_bytes(lo, t + 4);
        a[mt][3] = pm1_bytes(hi, t + 4);
      }
#pragma unroll
      for (int nt = 0; nt < kNt; ++nt) {
        const uint32_t kw = ks[(c0 + nt * 8 + g) * kStride + w];
        const uint32_t b0 = pm1_bytes(kw, t);
        const uint32_t b1 = pm1_bytes(kw, t + 4);
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) mma_s8(acc[mt][nt], a[mt], b0, b1);
      }
    }
  }
}

// kB1: the b1 product; kLines: the block owns whole 128-byte lines of each
// row (it computes the 32 keys left of its tile too); kVec: rows are
// 16-byte aligned, the stores 16 bytes a lane.
template <int W, bool kB1, bool kLines, bool kVec>
__global__ void __launch_bounds__(kTcThreads) bacam_mvm_tc_kernel(
    const uint32_t* __restrict__ q,  // (B, R, W)
    const uint32_t* __restrict__ k,  // (B, S, W)
    int32_t* __restrict__ out,       // (B, R, S)
    int R, int S) {
  constexpr int kCols = tile_cols<kLines>();
  constexpr int kLeft = kCols - kTcKeys;  // computed keys left of the tile
  constexpr int kNt = kCols / 32;         // 8-key fragments a warp
  constexpr int kSst = stage_stride<kLines>();
  extern __shared__ int4 smem4[];
  uint32_t* qs = reinterpret_cast<uint32_t*>(smem4);
  uint32_t* ks = qs + kTcRows * operand_stride<W, kB1>();
  int32_t* stage = reinterpret_cast<int32_t*>(smem4);  // after the products

  const int b = blockIdx.z;
  const int r0 = blockIdx.y * kTcRows;
  const int n0 = blockIdx.x * kTcKeys;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;

  load_rows<W, kB1, kTcRows>(qs, q + static_cast<size_t>(b) * R * W, r0, R);
  load_rows<W, kB1, kCols>(ks, k + static_cast<size_t>(b) * S * W,
                           n0 - kLeft, S);
  __syncthreads();
  const int c0 = warp * kNt * 8;  // the warp's first tile column
  int32_t acc[4][kNt][4];
  tile_product<W, kB1, kNt>(acc, qs, ks, c0, g, t);
  if constexpr (kB1) {
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int nt = 0; nt < kNt; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 32 * W - 2 * acc[mt][nt][e];
  }

  // stage the 64 x kCols tile over the operands (column c is key
  // n0 - kLeft + c)
  __syncthreads();
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < kNt; ++nt) {
      int32_t* s = stage + (mt * 16 + g) * kSst + c0 + nt * 8 + 2 * t;
      *reinterpret_cast<int2*>(s) = make_int2(acc[mt][nt][0], acc[mt][nt][1]);
      *reinterpret_cast<int2*>(s + 8 * kSst) =
          make_int2(acc[mt][nt][2], acc[mt][nt][3]);
    }
  __syncthreads();

  // each warp stores whole staged rows: keys [ka, kb) of row r
  const size_t out_int = reinterpret_cast<uintptr_t>(out) / sizeof(int32_t);
  const int nrows = min(kTcRows, R - r0);
  for (int i = warp; i < nrows; i += kTcThreads / 32) {
    const size_t rowbase = (static_cast<size_t>(b) * R + r0 + i) * S;
    int ka = n0;
    int kb = min(S, n0 + kTcKeys);
    if constexpr (kLines) {  // to the line boundaries at or below n0, n0 + 128
      const size_t key0 = out_int + rowbase;
      ka = max(0, n0 - static_cast<int>((key0 + n0) % kLineInts));
      if (kb < S) kb -= static_cast<int>((key0 + kb) % kLineInts);
    }
    int32_t* orow = out + rowbase;
    const int32_t* srow = stage + i * kSst + kLeft - n0;  // srow[key]
    if constexpr (kVec) {
      for (int c = ka + 4 * lane; c < kb; c += 4 * 32)
        __stcs(reinterpret_cast<int4*>(orow + c),
               *reinterpret_cast<const int4*>(srow + c));
    } else {
      for (int c = ka + lane; c < kb; c += 32) __stcs(orow + c, srow[c]);
    }
  }
}

template <int W, bool kB1, bool kLines, bool kVec>
int launch_tc(const void* q, const void* k, void* out, int B, int R, int S,
              cudaStream_t stream) {
  constexpr size_t smem = tc_smem<W, kB1, kLines>();
  auto kern = bacam_mvm_tc_kernel<W, kB1, kLines, kVec>;
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  const dim3 grid((S + kTcKeys - 1) / kTcKeys, (R + kTcRows - 1) / kTcRows, B);
  kern<<<grid, kTcThreads, smem, stream>>>(
      static_cast<const uint32_t*>(q), static_cast<const uint32_t*>(k),
      static_cast<int32_t*>(out), R, S);
  return static_cast<int>(cudaGetLastError());
}

template <int W, bool kB1>
int launch_tensor(const void* q, const void* k, void* out, int B, int R, int S,
                  cudaStream_t stream) {
  const uintptr_t addr = reinterpret_cast<uintptr_t>(out);
  if (S % 4 != 0 || addr % 16 != 0)  // rows not 16-byte aligned
    return launch_tc<W, kB1, false, false>(q, k, out, B, R, S, stream);
  if (S % kLineInts == 0 && addr % 128 == 0)  // rows of whole lines
    return launch_tc<W, kB1, false, true>(q, k, out, B, R, S, stream);
  return launch_tc<W, kB1, true, true>(q, k, out, B, R, S, stream);
}

// ---------------------------------------------------------------------------
// design 2: popc

constexpr int kPcThreads = 128;  // keys per block, one per thread
constexpr int kPcRows = 32;      // query rows per block

template <int W>
__global__ void __launch_bounds__(kPcThreads) bacam_mvm_popc_kernel(
    const uint32_t* __restrict__ q,  // (B, R, W)
    const uint32_t* __restrict__ k,  // (B, S, W)
    int32_t* __restrict__ out,       // (B, R, S)
    int R, int S, int d) {
  __shared__ uint32_t qs[kPcRows * W];
  const int b = blockIdx.z;
  const int r0 = blockIdx.y * kPcRows;
  const int key = blockIdx.x * kPcThreads + threadIdx.x;
  const int nrows = min(kPcRows, R - r0);
  const uint32_t* qb = q + (static_cast<size_t>(b) * R + r0) * W;
  for (int i = threadIdx.x; i < nrows * W; i += kPcThreads) qs[i] = qb[i];

  uint32_t kw[W];
  if (key < S) {
    const uint32_t* kr = k + (static_cast<size_t>(b) * S + key) * W;
#pragma unroll
    for (int w = 0; w < W; ++w) kw[w] = kr[w];
  }
  __syncthreads();
  if (key >= S) return;

  int32_t* o = out + (static_cast<size_t>(b) * R + r0) * S + key;
  for (int r = 0; r < nrows; ++r) {
    int mism = 0;
#pragma unroll
    for (int w = 0; w < W; ++w) mism += __popc(qs[r * W + w] ^ kw[w]);
    o[static_cast<size_t>(r) * S] = d - 2 * mism;
  }
}

template <int W>
int launch_popc(const void* q, const void* k, void* out, int B, int R, int S,
                int d, cudaStream_t stream) {
  const dim3 grid((S + kPcThreads - 1) / kPcThreads,
                  (R + kPcRows - 1) / kPcRows, B);
  bacam_mvm_popc_kernel<W><<<grid, kPcThreads, 0, stream>>>(
      static_cast<const uint32_t*>(q), static_cast<const uint32_t*>(k),
      static_cast<int32_t*>(out), R, S, d);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------

Design choose_design(int R, int W) {
  if (R < kTcRows) return kPopc;
  return W <= 2 ? kTensorS8 : kTensorB1;
}

template <int W>
int launch(const void* q, const void* k, void* out, int B, int R, int S,
           Design design, cudaStream_t stream) {
  switch (design) {
    case kTensorS8: return launch_tensor<W, false>(q, k, out, B, R, S, stream);
    case kTensorB1: return launch_tensor<W, true>(q, k, out, B, R, S, stream);
    case kPopc: return launch_popc<W>(q, k, out, B, R, S, 32 * W, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

int run(const void* q, const void* k, void* out, int B, int R, int S, int W,
        int d, Design design, cudaStream_t s) {
  if (d != 32 * W) return static_cast<int>(cudaErrorInvalidValue);
  switch (W) {
    case 1: return launch<1>(q, k, out, B, R, S, design, s);
    case 2: return launch<2>(q, k, out, B, R, S, design, s);
    case 3: return launch<3>(q, k, out, B, R, S, design, s);
    case 4: return launch<4>(q, k, out, B, R, S, design, s);
    case 5: return launch<5>(q, k, out, B, R, S, design, s);
    case 6: return launch<6>(q, k, out, B, R, S, design, s);
    case 7: return launch<7>(q, k, out, B, R, S, design, s);
    case 8: return launch<8>(q, k, out, B, R, S, design, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// the design `bacam_mvm` runs at R query rows of W words (as numbered for
// `bacam_mvm_design`)
extern "C" int bacam_mvm_plan(int R, int W) { return choose_design(R, W); }

extern "C" int bacam_mvm(const void* q, const void* k, void* out, int B,
                         int R, int S, int W, int d, void* stream) {
  return run(q, k, out, B, R, S, W, d, choose_design(R, W),
             static_cast<cudaStream_t>(stream));
}

// one design, named (0 tensor cores s8, 1 tensor cores b1, 2 popc), for
// timing and tests
extern "C" int bacam_mvm_design(const void* q, const void* k, void* out,
                                int B, int R, int S, int W, int d, int design,
                                void* stream) {
  if (design < kTensorS8 || design > kPopc)
    return static_cast<int>(cudaErrorInvalidValue);
  return run(q, k, out, B, R, S, W, d, static_cast<Design>(design),
             static_cast<cudaStream_t>(stream));
}
