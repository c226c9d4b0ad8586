// Contiguous flash attention forward in float32, 3xTF32 on the tensor cores.
//
// Replaces the TPU kernel kernels/flash_attention.py::flash_attention of the
// reference package for float32 inputs (bf16 inputs take
// csrc/flash_attention.cu, whose header states the semantics: causal and
// window masks at q_offset, keys at or past Skv masked, output
// acc / max(l, 1e-30), so a row with no valid key comes out zero).  Layout
// (B, S, D) with D <= 256 and D % 4 == 0 (the wrapper pads other widths).
//
// Arithmetic.  The reference computes in full f32 and the port holds this
// kernel to 1e-5, which one TF32 pass (10-bit mantissa) cannot meet.  Each
// operand x is split into a TF32 high part h = tf32(x) and a TF32 low part
// l = tf32(x - h), and every product a . b is taken as
// a_l . b_h + a_h . b_l + a_h . b_h with f32 accumulation (3xTF32, about
// 21 bits of each operand).  The splits are made in registers as the
// fragments are loaded, for Q, K, P and V alike.
//
// Design (the FlashAttention-2 shape on mma.sync).  Grid (row tiles, B),
// the longest causal row tiles first; 4 warps, each owning 32 query rows
// for D <= 64 (each K and V fragment, once split, serves two 16-row
// tiles, whose products interleave) and 16 rows for wider heads, where the
// accumulators of O leave no registers for a second row tile.  K/V tiles
// (64 keys, 32 for D > 128) are double-buffered in shared
// memory with cp.async (16-byte copies, zero-filled past Skv and D), so the
// next tile's copy overlaps this tile's products; the causal and window
// limits bound the key loop and only tiles that straddle a limit are masked.
// S = Q K^T and O += P V run on mma.sync m16n8k8 TF32 fragments loaded
// straight from shared memory (row stride D + 4 floats, so every fragment
// load is free of bank conflicts); the online softmax runs on the S
// fragment.  P enters P V from the S accumulator registers: the
// accumulator gives a thread keys 2t and 2t + 1 of each 8 where the A
// fragment wants keys t and t + 4, so the k order inside each 8-key step is
// permuted (k = t <- key 2t, k = t + 4 <- key 2t + 1) and the V fragment
// reads its rows in the same order.
//
// Why not wgmma.  TF32 wgmma takes only K-major shared-memory operands, so a
// 3xTF32 wgmma kernel needs the low parts of K and a transposed V (high and
// low) in shared memory beside the TMA ring; at D = 256 that exceeds the
// 227 KB a block may use.  mma.sync loads each fragment per thread, so the
// split and the transposition cost registers instead.
//
// Bound.  At (128, 1024, 64), causal, the function does 17.2 GFLOP; as
// 3xTF32 that is 51.6 GFLOP of TF32 products, 104 us at 495 TFLOP/s,
// against 134 MB of f32 q, k, v and out, 40 us: bounded by operations.

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;      // 16 rows each
constexpr int kThreads = 32 * kWarps;
constexpr float kNegInf = -INFINITY;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte async copy; src_bytes == 0 zero-fills the destination
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)), "l"(src), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// x = hi + lo with hi = tf32(x) and lo = tf32(x - hi), both rounded to
// nearest, ties away from zero (what cvt.rna.tf32.f32 gives), by integer
// rounding of the f32 bits, which issues faster than the conversion
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = (__float_as_uint(x - __uint_as_float(hi)) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c[mt] += a[mt] . b in 3xTF32 from split fragments, small products first;
// the row tiles' products interleave, so no product waits on the last one
template <int MT>
__device__ __forceinline__ void mma_3xtf32(float (&c)[MT][4],
                                           const uint32_t (&ah)[MT][4],
                                           const uint32_t (&al)[MT][4],
                                           const uint32_t (&bh)[2],
                                           const uint32_t (&bl)[2]) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) mma_tf32(c[mt], al[mt], bh[0], bh[1]);
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) mma_tf32(c[mt], ah[mt], bl[0], bl[1]);
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) mma_tf32(c[mt], ah[mt], bh[0], bh[1]);
}

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// rows [row0, row0 + n) of a (B, S, D) tensor into shared memory with row
// stride `ld` floats, columns [0, d8) (zero past D and past S)
__device__ __forceinline__ void load_rows(float* dst, const float* src, int row0,
                                          int n, int S, int D, int d8, int ld) {
  const int c4 = d8 / 4;
  for (int i = threadIdx.x; i < n * c4; i += kThreads) {
    const int r = i / c4;
    const int c = (i % c4) * 4;
    const bool ok = row0 + r < S && c < D;
    cp_async16(dst + r * ld + c,
               ok ? src + static_cast<size_t>(row0 + r) * D + c : src, ok ? 16 : 0);
  }
}

template <int DC>
struct Tiles {
  static constexpr int kMT = DC == 1 ? 2 : 1;  // 16-row tiles per warp
  static constexpr int kBM = kWarps * 16 * kMT;      // query rows per block
  static constexpr int kBN = DC == 4 ? 32 : 64;      // keys per tile
  static constexpr int kLd = 64 * DC + 4;            // shared row stride
  static constexpr int kSmem = 4 * (kBM + 4 * kBN) * kLd;
};

template <int DC>  // D <= 64 * DC
__global__ void __launch_bounds__(kThreads) flash_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, float* __restrict__ out, int Sq, int Skv, int D,
    float scale_log2, int q_offset, int causal, int has_window, int window) {
  using T = Tiles<DC>;
  constexpr int kMT = T::kMT, kBM = T::kBM, kBN = T::kBN, kLd = T::kLd;
  constexpr int kNT = kBN / 8;    // 8-key steps per tile
  constexpr int kND = DC * 8;     // 8-column steps of D
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // kBM x kLd
  float* kvs = qs + kBM * kLd;                   // stage s: K then V, kBN x kLd

  const int b = blockIdx.y;
  const int m0 = (gridDim.x - 1 - blockIdx.x) * kBM;
  const int d8 = (D + 7) / 8 * 8;
  const int nd = d8 / 8;
  const float* qb = q + static_cast<size_t>(b) * Sq * D;
  const float* kb = k + static_cast<size_t>(b) * Skv * D;
  const float* vb = v + static_cast<size_t>(b) * Skv * D;

  const int last_row = min(m0 + kBM, Sq) - 1;
  const int k_end = causal ? min(Skv, q_offset + last_row + 1) : Skv;
  const int k_begin = has_window ? max(0, q_offset + m0 - window + 1) : 0;
  const int t_first = k_begin / kBN;
  const int n_tiles = k_end > k_begin ? (k_end + kBN - 1) / kBN - t_first : 0;

  load_rows(qs, qb, m0, kBM, Sq, D, d8, kLd);
  cp_async_commit();
  if (n_tiles > 0) {
    load_rows(kvs, kb, t_first * kBN, kBN, Skv, D, d8, kLd);
    load_rows(kvs + kBN * kLd, vb, t_first * kBN, kBN, Skv, D, d8, kLd);
  }
  cp_async_commit();

  // warp w owns rows m0 + 16 kMT w .. + 16 kMT - 1: row tile mt of it, rows
  // row_lo(mt) and row_lo(mt) + 8 in this thread
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int w_row0 = m0 + warp * 16 * kMT;
  const int w_row1 = min(w_row0 + 16 * kMT, Sq) - 1;
  const float* qw = qs + warp * 16 * kMT * kLd;

  float o[kND][kMT][4];
  float m[kMT][2], l[kMT][2];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
    for (int j = 0; j < kND; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[j][mt][e] = 0.f;
    m[mt][0] = m[mt][1] = kNegInf;
    l[mt][0] = l[mt][1] = 0.f;
  }

  for (int it = 0; it < n_tiles; ++it) {
    if (it + 1 < n_tiles) {
      float* nxt = kvs + ((it + 1) % 2) * 2 * kBN * kLd;
      const int key1 = (t_first + it + 1) * kBN;
      load_rows(nxt, kb, key1, kBN, Skv, D, d8, kLd);
      load_rows(nxt + kBN * kLd, vb, key1, kBN, Skv, D, d8, kLd);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* ks = kvs + (it % 2) * 2 * kBN * kLd;
    const float* vs = ks + kBN * kLd;
    const int key0 = (t_first + it) * kBN;
    const bool skip = w_row1 < w_row0 || (causal && key0 > q_offset + w_row1) ||
                      (has_window && key0 + kBN - 1 <= q_offset + w_row0 - window);
    if (!skip) {
      const bool masked =
          key0 + kBN > Skv || (causal && key0 + kBN - 1 > q_offset + w_row0) ||
          (has_window && key0 <= q_offset + w_row1 - window);
      float sc[kNT][kMT][4];
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
        for (int j = 0; j < kNT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) sc[j][mt][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kND; ++kk) {
        if (kk < nd) {
          uint32_t ah[kMT][4], al[kMT][4];
#pragma unroll
          for (int mt = 0; mt < kMT; ++mt) {
            const float* qa = qw + (16 * mt + g) * kLd + 8 * kk + t;
            split_tf32(qa[0], ah[mt][0], al[mt][0]);
            split_tf32(qa[8 * kLd], ah[mt][1], al[mt][1]);
            split_tf32(qa[4], ah[mt][2], al[mt][2]);
            split_tf32(qa[8 * kLd + 4], ah[mt][3], al[mt][3]);
          }
#pragma unroll
          for (int j = 0; j < kNT; ++j) {
            const float* kr = ks + (8 * j + g) * kLd + 8 * kk + t;
            uint32_t bh[2], bl[2];
            split_tf32(kr[0], bh[0], bl[0]);
            split_tf32(kr[4], bh[1], bl[1]);
            mma_3xtf32(sc[j], ah, al, bh, bl);
          }
        }
      }

#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        // masked online softmax: sc[j][mt][e] sits at row lo (e < 2) or hi
        // and key key0 + 8 j + 2 t + e % 2
        const int row_lo = w_row0 + 16 * mt + g;
        const int qpos[2] = {q_offset + row_lo, q_offset + row_lo + 8};
        float mx[2] = {kNegInf, kNegInf};
#pragma unroll
        for (int j = 0; j < kNT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float x = sc[j][mt][e] * scale_log2;
            if (masked) {
              const int kpos = key0 + 8 * j + 2 * t + (e % 2);
              const int qp = qpos[e / 2];
              bool ok = kpos < Skv;
              if (causal) ok = ok && kpos <= qp;
              if (has_window) ok = ok && kpos > qp - window;
              x = ok ? x : kNegInf;
            }
            sc[j][mt][e] = x;
            mx[e / 2] = fmaxf(mx[e / 2], x);
          }
        float alpha[2], base[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
          mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
          const float m_new = fmaxf(m[mt][h], mx[h]);
          base[h] = m_new == kNegInf ? 0.f : m_new;  // no valid key yet
          alpha[h] = fast_exp2(m[mt][h] - base[h]);
          m[mt][h] = m_new;
          l[mt][h] *= alpha[h];
        }
#pragma unroll
        for (int j = 0; j < kNT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            sc[j][mt][e] = fast_exp2(sc[j][mt][e] - base[e / 2]);
            l[mt][e / 2] += sc[j][mt][e];
          }
#pragma unroll
        for (int j = 0; j < kND; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) o[j][mt][e] *= alpha[e / 2];
      }

      // O += P V, the k order of each 8-key step permuted (see the header)
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        uint32_t ph[kMT][4], pl[kMT][4];
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) {
          split_tf32(sc[j][mt][0], ph[mt][0], pl[mt][0]);
          split_tf32(sc[j][mt][2], ph[mt][1], pl[mt][1]);
          split_tf32(sc[j][mt][1], ph[mt][2], pl[mt][2]);
          split_tf32(sc[j][mt][3], ph[mt][3], pl[mt][3]);
        }
        const float* vr = vs + (8 * j + 2 * t) * kLd + g;
#pragma unroll
        for (int dn = 0; dn < kND; ++dn)
          if (dn < nd) {
            uint32_t bh[2], bl[2];
            split_tf32(vr[8 * dn], bh[0], bl[0]);
            split_tf32(vr[kLd + 8 * dn], bh[1], bl[1]);
            mma_3xtf32(o[dn], ph, pl, bh, bl);
          }
      }
    }
    __syncthreads();  // the stage is reloaded two tiles on
  }
  cp_async_wait<0>();  // no copy outlives the block (n_tiles == 0)

  float* ob = out + static_cast<size_t>(b) * Sq * D;
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) {
    float inv[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l[mt][h] += __shfl_xor_sync(0xffffffffu, l[mt][h], 1);
      l[mt][h] += __shfl_xor_sync(0xffffffffu, l[mt][h], 2);
      inv[h] = 1.f / fmaxf(l[mt][h], 1e-30f);
    }
#pragma unroll
    for (int dn = 0; dn < kND; ++dn)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = w_row0 + 16 * mt + g + 8 * h;
        const int col = 8 * dn + 2 * t;
        if (row < Sq && col < D)
          *reinterpret_cast<float2*>(ob + static_cast<size_t>(row) * D + col) =
              make_float2(o[dn][mt][2 * h] * inv[h], o[dn][mt][2 * h + 1] * inv[h]);
      }
  }
}

template <int DC>
int launch(const void* q, const void* k, const void* v, void* out, int B, int Sq,
           int Skv, int D, float scale, int q_offset, int causal, int has_window,
           int window, cudaStream_t stream) {
  using T = Tiles<DC>;
  auto kern = flash_f32_kernel<DC>;
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmem);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  const dim3 grid((Sq + T::kBM - 1) / T::kBM, B);
  kern<<<grid, kThreads, T::kSmem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), Sq, Skv, D,
      scale * 1.4426950408889634f, q_offset, causal, has_window, window);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int flash_attention_f32(const void* q, const void* k, const void* v,
                                   void* out, int B, int Sq, int Skv, int D,
                                   int q_offset, int causal, int has_window,
                                   int window, float scale, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D % 4 != 0 || D > 256 || Sq < 1 || Skv < 1)
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
