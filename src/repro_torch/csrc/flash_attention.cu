// Contiguous flash attention forward in bf16 on Hopper's tensor cores.
//
// Replaces the TPU kernel kernels/flash_attention.py::flash_attention of the
// reference package for bf16 inputs (float32 inputs take
// csrc/flash_attention_f32.cu).
//
// Per batch b (batch * heads folded) and query row i at position
// q_offset + i, an online-softmax attention over the keys j of k[b] / v[b]:
// s = (q . k) * scale, key j valid when j < Skv and, with `causal`,
// j <= q_offset + i (and j > q_offset + i - window when a window is set).
// Running max m, denominator l and accumulator acc stay in float32; the
// output is acc / max(l, 1e-30) in bf16, so a row with no valid key comes
// out zero.  Layout (B, S, D) with D <= 256 and D % 8 == 0 (the wrapper pads
// other widths with zero columns).
//
// Design (the FlashAttention-3 shape, one consumer warpgroup per block).
// Grid (row tiles of 64, B), the longest causal row tiles first; 160
// threads: one consumer warpgroup and one producer warp.  The producer
// loads the Q tile once and the K/V tiles of 64 keys into a 2-stage
// shared-memory ring with TMA (128-byte swizzle, one mbarrier per stage for
// "full" and one for "empty"); only tiles that some row of the block can see
// are loaded, the causal and window limits bound the loop.  D is cut into
// 64-column chunks (one 128-byte swizzle row each) and zero-filled by TMA
// past D, so three instances (D <= 64, 128, 256) cover every width.  The
// consumers compute S = Q K^T with wgmma m64n64k16 (bf16 in, f32
// accumulate, both operands from shared memory), mask only tiles that
// straddle a limit, run the online softmax on the accumulator fragment,
// convert P to bf16 in registers and accumulate O += P V with wgmma whose A
// operand is those registers and whose B operand is the V tile read
// MN-major (transposed) from shared memory.  Blocks are small (41 KB of
// shared memory at D = 64, at most 136 registers a thread) so that three
// share an SM and one block's softmax overlaps another's products.  On the
// card this ran faster than two consumer warpgroups sharing a 128-row
// block, and faster than issuing the next tile's Q K^T before this tile's
// softmax (which holds a second S in registers).
//
// Numerics.  P is split into a bf16 high part and a bf16 low part
// (p - bf16(p)) and both are multiplied with V, so the P V product carries
// about 16 bits of each weight rather than 8; l is summed from the f32 P.
// With P in bf16 alone the error on the card reached the edge of the
// 2^-7 rel + abs tolerance.
//
// Bound.  At (128, 1024, 64), causal, the function does 4 * 524,800 causal
// (row, key) pairs * 64 * 128 = 17.2 GFLOP: 17.4 us at 989 TFLOP/s of bf16,
// against 67 MB of bf16 q, k, v and out: 20.0 us at 3.35 TB/s.  It is
// bounded by bytes; the split P doubles the P V products (25.7 GFLOP in
// all, 26 us).

#include <cmath>
#include <cstdint>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBM = 64;                       // query rows per block
constexpr int kBN = 64;                       // keys per tile
constexpr int kStages = 2;                    // K/V ring depth
constexpr int kConsumers = 128;               // one warpgroup
constexpr int kThreads = kConsumers + 32;     // and one producer warp
constexpr int kChunk = 64;                    // D columns per swizzled chunk
constexpr uint32_t kQChunkBytes = kBM * 128;  // 16 KiB
constexpr uint32_t kKVChunkBytes = kBN * 128; // 8 KiB
constexpr float kNegInf = -INFINITY;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra.uni DONE;\n"
      "bra.uni LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_addr(bar)), "r"(parity) : "memory");
}

__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1),
      "r"(c2) : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle (the atom is 8 rows of
// 128 bytes, 1024-byte aligned)
__device__ __forceinline__ uint64_t desc_sw128(const void* p, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((smem_addr(p) & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 | 1ull << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// d (64 x 64 f32 fragment) (+)= A (smem, K-major) . B (smem, K-major)
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db,
                                         int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, "
      "%31}, %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]),
        "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),
        "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]),
        "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d += A (registers, bf16 pairs) . B (smem, MN-major: V read transposed)
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, "
      "%31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]),
        "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),
        "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]),
        "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t bf16_pair(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float bf16_lo(uint32_t v) {
  return __uint_as_float(v << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t v) {
  return __uint_as_float(v & 0xffff0000u);
}

template <int DC>  // D <= 64 * DC
__global__ void __launch_bounds__(kThreads, DC == 1 ? 3 : DC == 2 ? 2 : 1)
flash_bf16_kernel(
    const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ out,
    int Sq, int Skv, int D, float scale_log2, int q_offset, int causal,
    int has_window, int window) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t full[kStages], empty[kStages], qfull;
  uint8_t* qs = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint8_t* kvs = qs + DC * kQChunkBytes;  // stage s: DC K chunks, DC V chunks

  const int b = blockIdx.y;
  const int m0 = (gridDim.x - 1 - blockIdx.x) * kBM;
  // keys any row of the block may see: [k_begin, k_end)
  const int last_row = min(m0 + kBM, Sq) - 1;
  const int k_end = causal ? min(Skv, q_offset + last_row + 1) : Skv;
  const int k_begin = has_window ? max(0, q_offset + m0 - window + 1) : 0;
  const int t_first = k_begin / kBN;
  const int n_tiles = k_end > k_begin ? (k_end + kBN - 1) / kBN - t_first : 0;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers);
    }
    mbar_init(&qfull, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {  // producer warp: one thread issues TMA
    if (threadIdx.x == kConsumers && n_tiles > 0) {
      mbar_expect_tx(&qfull, DC * kQChunkBytes);
      for (int c = 0; c < DC; ++c)
        tma_load(qs + c * kQChunkBytes, &tq, &qfull, c * kChunk, m0, b);
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % kStages;
        mbar_wait(&empty[s], ((it / kStages) & 1) ^ 1);
        mbar_expect_tx(&full[s], 2 * DC * kKVChunkBytes);
        uint8_t* ks = kvs + s * 2 * DC * kKVChunkBytes;
        const int key0 = (t_first + it) * kBN;
        for (int c = 0; c < DC; ++c) {
          tma_load(ks + c * kKVChunkBytes, &tk, &full[s], c * kChunk, key0, b);
          tma_load(ks + (DC + c) * kKVChunkBytes, &tv, &full[s], c * kChunk, key0,
                   b);
        }
      }
    }
    return;
  }

  // the consumer warpgroup: this thread holds rows row_lo and row_lo + 8
  // of every fragment
  const int lane = threadIdx.x % 32;
  const int quad = lane % 4;
  const int row_lo = m0 + threadIdx.x / 32 * 16 + lane / 4;
  const int qpos[2] = {q_offset + row_lo, q_offset + row_lo + 8};

  float o[DC][32];
#pragma unroll
  for (int c = 0; c < DC; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[c][i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  if (n_tiles > 0) mbar_wait(&qfull, 0);
  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % kStages;
    mbar_wait(&full[s], (it / kStages) & 1);
    const uint8_t* ks = kvs + s * 2 * DC * kKVChunkBytes;
    const uint8_t* vs = ks + DC * kKVChunkBytes;
    const int key0 = (t_first + it) * kBN;

    // S = Q K^T over D in 16-column steps (32 bytes into a swizzled row)
    float sc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < 4 * DC; ++kc)
      wgmma_ss(sc, desc_sw128(qs + (kc / 4) * kQChunkBytes, 16, 1024) + 2 * (kc % 4),
               desc_sw128(ks + (kc / 4) * kKVChunkBytes, 16, 1024) + 2 * (kc % 4),
               kc > 0);
    wgmma_commit();
    wgmma_wait_all();

    // masked online softmax on the fragment: element i sits at row
    // (i / 2) % 2 (lo / hi) and key key0 + 8 (i / 4) + 2 quad + i % 2
    const bool masked =
        key0 + kBN > Skv || (causal && key0 + kBN - 1 > q_offset + m0) ||
        (has_window && key0 <= q_offset + last_row - window);
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      float x = sc[i] * scale_log2;
      if (masked) {
        const int kpos = key0 + 8 * (i / 4) + 2 * quad + (i % 2);
        const int qp = qpos[(i / 2) % 2];
        bool ok = kpos < Skv;
        if (causal) ok = ok && kpos <= qp;
        if (has_window) ok = ok && kpos > qp - window;
        x = ok ? x : kNegInf;
      }
      sc[i] = x;
      mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], x);
    }
    float alpha[2], base[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m[h], mx[h]);
      base[h] = m_new == kNegInf ? 0.f : m_new;  // no valid key yet
      alpha[h] = fast_exp2(m[h] - base[h]);
      m[h] = m_new;
      l[h] *= alpha[h];
    }
    // P as the A fragments of P V (keys 16 j .. 16 j + 15), high and low
    uint32_t p_hi[4][4], p_lo[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = 8 * j + 2 * r;
        const int h = r % 2;
        const float p0 = fast_exp2(sc[i] - base[h]);
        const float p1 = fast_exp2(sc[i + 1] - base[h]);
        l[h] += p0 + p1;
        const uint32_t hi = bf16_pair(p0, p1);
        p_hi[j][r] = hi;
        p_lo[j][r] = bf16_pair(p0 - bf16_lo(hi), p1 - bf16_hi(hi));
      }
#pragma unroll
    for (int c = 0; c < DC; ++c)
#pragma unroll
      for (int i = 0; i < 32; ++i) o[c][i] *= alpha[(i / 2) % 2];

    // O += P V
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < DC; ++c)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        // keys 16 j .. 16 j + 15 of chunk c: two 8-key swizzle atoms
        const uint64_t dv =
            desc_sw128(vs + c * kKVChunkBytes + j * 2048, kKVChunkBytes, 1024);
        wgmma_rs(o[c], p_hi[j], dv);
        wgmma_rs(o[c], p_lo[j], dv);
      }
    wgmma_commit();
    wgmma_wait_all();
    mbar_arrive(&empty[s]);
  }

  float inv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    inv[h] = 1.f / fmaxf(l[h], 1e-30f);
  }
#pragma unroll
  for (int c = 0; c < DC; ++c)
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int h = (i / 2) % 2;
      const int row = row_lo + 8 * h;
      const int col = c * kChunk + 8 * (i / 4) + 2 * quad;
      if (row < Sq && col < D)
        *reinterpret_cast<__nv_bfloat162*>(
            out + (static_cast<size_t>(b) * Sq + row) * D + col) =
            __floats2bfloat162_rn(o[c][i] * inv[h], o[c][i + 1] * inv[h]);
    }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e != cudaSuccess || q != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// (B, S, D) bf16 as a 3-D tensor map with boxes of 64 columns x `rows`
bool encode(EncodeTiled enc, CUtensorMap* map, const void* ptr, int B, int S,
            int D, int rows) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(D) * 2,
                                 static_cast<cuuint64_t>(S) * D * 2};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(kChunk),
                             static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t estr[3] = {1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims,
             strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int DC>
int launch(const void* q, const void* k, const void* v, void* out, int B, int Sq,
           int Skv, int D, float scale, int q_offset, int causal, int has_window,
           int window, cudaStream_t stream) {
  const EncodeTiled enc = encoder();
  CUtensorMap tq, tk, tv;
  if (enc == nullptr || !encode(enc, &tq, q, B, Sq, D, kBM) ||
      !encode(enc, &tk, k, B, Skv, D, kBN) || !encode(enc, &tv, v, B, Skv, D, kBN))
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = 1024 + DC * kQChunkBytes + kStages * 2 * DC * kKVChunkBytes;
  auto kern = flash_bf16_kernel<DC>;
  static bool configured = false;
  if (!configured) {
    const cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  const dim3 grid((Sq + kBM - 1) / kBM, B);
  kern<<<grid, kThreads, smem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(out), Sq, Skv, D,
      scale * 1.4426950408889634f, q_offset, causal, has_window, window);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* out, int B, int Sq, int Skv, int D,
                               int q_offset, int causal, int has_window, int window,
                               float scale, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D % 8 != 0 || D > 256 || Sq < 1 || Skv < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (D <= 64)
    return launch<1>(q, k, v, out, B, Sq, Skv, D, scale, q_offset, causal,
                     has_window, window, s);
  if (D <= 128)
    return launch<2>(q, k, v, out, B, Sq, Skv, D, scale, q_offset, causal,
                     has_window, window, s);
  return launch<4>(q, k, v, out, B, Sq, Skv, D, scale, q_offset, causal, has_window,
                   window, s);
}
