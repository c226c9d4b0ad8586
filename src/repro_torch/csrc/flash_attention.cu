// Contiguous flash attention forward (dense softmax attention, f32 math).
//
// Replaces the TPU kernel kernels/flash_attention.py::flash_attention of the
// reference package.
//
// Per batch b (batch * heads folded) and query row i at position
// q_offset + i, an online-softmax attention over the keys j of k[b] / v[b]:
// s = (q . k) * scale, key j valid when j < Skv and, with `causal`,
// j <= q_offset + i (and j > q_offset + i - window when a window is set).
// Running max m, denominator l and accumulator acc stay in float32; the
// output is acc / max(l, 1e-30) in q's dtype, so a row with no valid key
// comes out zero.  Inputs are bf16 or f32 and are widened to f32 as they
// are loaded; arithmetic is f32 FMA (no TF32, no tensor cores).
//
// Design.  The row tiling of csrc/paged_flash_decode.cu over a contiguous
// cache.  Grid (row tiles of 16, B); 4 warps, each owning 4 rows at once.
// A loop over 64-key tiles takes the place of the TPU's sequential grid
// axis, the softmax state stays in registers, and causal (and window) limits
// bound the loop, so tiles no row of the block can see are never loaded.
// All warps load each K/V tile into shared memory as f32, K transposed
// (padded stride, conflict-free for lanes on neighbouring keys).  Scores:
// lane l owns keys l and l + 32 and runs the d loop once for its warp's 4
// rows, reading each K value once and the rows' query values as float4
// broadcasts.  P.V: lane l owns output columns l, l + 32, ... and reads each
// V value once for the 4 rows, their weights as float4 broadcasts.  A tile
// with no valid key for a row leaves that row's state unchanged.
//
// Bound.  At (128, 1024, 64), causal, the function does 4 * 524,800 causal
// (row, key) pairs * 64 * 128 = 17.2 GFLOP: about 256 us at 67 TFLOP/s of
// f32 FMA, against about 100 MB of bytes (about 30 us).  It is bounded by
// operations.  This first version issues one shared-memory load per 1-2
// FMAs and uses no tensor cores; wgmma tiles are later work.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float kNegInf = -1.0e9f;
constexpr int kWarps = 4;
constexpr int kRPW = 4;                // rows per warp
constexpr int kRows = kWarps * kRPW;   // rows per block
constexpr int kTK = 64;                // keys per tile: two per lane
constexpr int kKtStride = kTK + 1;     // transposed-K row stride
constexpr int kMaxCols = 8;            // D <= 256: output columns per lane

template <typename T>
__device__ __forceinline__ float to_f32(T x);
template <>
__device__ __forceinline__ float to_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__device__ __forceinline__ float lane_of(const float4& x, int i) {
  return i == 0 ? x.x : i == 1 ? x.y : i == 2 ? x.z : x.w;
}

template <typename T>
__global__ void __launch_bounds__(kWarps * 32) flash_attention_kernel(
    const T* __restrict__ q,  // (B, Sq, D)
    const T* __restrict__ k,  // (B, Skv, D)
    const T* __restrict__ v,  // (B, Skv, D)
    T* __restrict__ out,      // (B, Sq, D)
    int Sq, int Skv, int D, int Dp, float scale, int q_offset, int causal,
    int has_window, int window) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* kt = smem;                    // Dp x kKtStride, K tile transposed
  float* vs = kt + Dp * kKtStride;     // kTK x D
  float* qs = vs + kTK * D;            // kRows x Dp, zero-padded columns
  float* ps = qs + kRows * Dp;         // kRows x kTK softmax weights

  const int b = blockIdx.y;
  const int row0 = blockIdx.x * kRows;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const T* qb = q + static_cast<size_t>(b) * Sq * D;
  const T* kb = k + static_cast<size_t>(b) * Skv * D;
  const T* vb = v + static_cast<size_t>(b) * Skv * D;

  for (int i = threadIdx.x; i < kRows * Dp; i += blockDim.x) {
    const int row = row0 + i / Dp;
    const int dd = i % Dp;
    qs[i] = (row < Sq && dd < D)
                ? to_f32(qb[static_cast<size_t>(row) * D + dd]) : 0.f;
  }

  // keys any row of the block may see: [k_begin, k_end)
  const int last_row = min(row0 + kRows, Sq) - 1;
  int k_end = Skv;
  if (causal) k_end = min(Skv, q_offset + last_row + 1);
  int k_begin = 0;
  if (has_window) k_begin = max(0, q_offset + row0 - window + 1);

  float m[kRPW], l[kRPW], acc[kRPW][kMaxCols];
#pragma unroll
  for (int rr = 0; rr < kRPW; ++rr) {
    m[rr] = kNegInf;
    l[rr] = 0.f;
#pragma unroll
    for (int c = 0; c < kMaxCols; ++c) acc[rr][c] = 0.f;
  }
  float* pw = ps + warp * kRPW * kTK;
  const float* qw = qs + warp * kRPW * Dp;

  for (int t0 = k_begin / kTK * kTK; t0 < k_end; t0 += kTK) {
    const int n = min(kTK, Skv - t0);
    __syncthreads();  // every warp is done with the previous tile
    for (int i = threadIdx.x; i < kTK * Dp; i += blockDim.x) {
      const int p = i / Dp;
      const int dd = i % Dp;
      kt[dd * kKtStride + p] =
          (p < n && dd < D)
              ? to_f32(kb[static_cast<size_t>(t0 + p) * D + dd]) : 0.f;
    }
    for (int i = threadIdx.x; i < kTK * D; i += blockDim.x) {
      const int p = i / D;
      vs[i] = p < n ? to_f32(vb[static_cast<size_t>(t0) * D + i]) : 0.f;
    }
    __syncthreads();

    // scores of the warp's rows against keys lane and lane + 32
    float s[kRPW][2];
#pragma unroll
    for (int rr = 0; rr < kRPW; ++rr) s[rr][0] = s[rr][1] = 0.f;
    for (int dd = 0; dd < Dp; dd += 4) {
      float4 qv[kRPW];
#pragma unroll
      for (int rr = 0; rr < kRPW; ++rr)
        qv[rr] = *reinterpret_cast<const float4*>(qw + rr * Dp + dd);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float k0 = kt[(dd + i) * kKtStride + lane];
        const float k1 = kt[(dd + i) * kKtStride + lane + 32];
#pragma unroll
        for (int rr = 0; rr < kRPW; ++rr) {
          const float qd = lane_of(qv[rr], i);
          s[rr][0] = fmaf(qd, k0, s[rr][0]);
          s[rr][1] = fmaf(qd, k1, s[rr][1]);
        }
      }
    }

    // masked online-softmax update, one row at a time
    float alpha[kRPW];
#pragma unroll
    for (int rr = 0; rr < kRPW; ++rr) {
      const int row = row0 + warp * kRPW + rr;
      const int qpos = q_offset + row;
      float smax = kNegInf;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int p = lane + 32 * j;
        const int kpos = t0 + p;
        bool ok = p < n;
        if (causal) ok = ok && kpos <= qpos;
        if (has_window) ok = ok && kpos > qpos - window;
        s[rr][j] = ok ? s[rr][j] * scale : kNegInf;
        smax = fmaxf(smax, s[rr][j]);
      }
      smax = warp_max(smax);
      alpha[rr] = 1.f;
      if (row >= Sq || smax <= kNegInf) {  // no valid key: state unchanged
        pw[rr * kTK + lane] = 0.f;
        pw[rr * kTK + lane + 32] = 0.f;
        continue;
      }
      const float m_new = fmaxf(m[rr], smax);
      alpha[rr] = expf(m[rr] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float e = s[rr][j] > kNegInf ? expf(s[rr][j] - m_new) : 0.f;
        pw[rr * kTK + lane + 32 * j] = e;
        psum += e;
      }
      l[rr] = l[rr] * alpha[rr] + warp_sum(psum);
      m[rr] = m_new;
    }
    __syncwarp();

    // acc = acc * alpha + P . V
#pragma unroll
    for (int rr = 0; rr < kRPW; ++rr)
#pragma unroll
      for (int c = 0; c < kMaxCols; ++c) acc[rr][c] *= alpha[rr];
    const int n4 = (n + 3) & ~3;  // weights and V rows past n are zero
    for (int p = 0; p < n4; p += 4) {
      float4 w[kRPW];
#pragma unroll
      for (int rr = 0; rr < kRPW; ++rr)
        w[rr] = *reinterpret_cast<const float4*>(pw + rr * kTK + p);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int c = 0; c < kMaxCols; ++c) {
          const int dv = lane + 32 * c;
          if (dv < D) {
            const float x = vs[(p + i) * D + dv];
#pragma unroll
            for (int rr = 0; rr < kRPW; ++rr)
              acc[rr][c] = fmaf(lane_of(w[rr], i), x, acc[rr][c]);
          }
        }
      }
    }
  }

  T* ob = out + static_cast<size_t>(b) * Sq * D;
#pragma unroll
  for (int rr = 0; rr < kRPW; ++rr) {
    const int row = row0 + warp * kRPW + rr;
    if (row >= Sq) break;  // warp-uniform
    const float denom = fmaxf(l[rr], 1e-30f);
#pragma unroll
    for (int c = 0; c < kMaxCols; ++c) {
      const int dv = lane + 32 * c;
      if (dv < D)
        ob[static_cast<size_t>(row) * D + dv] =
            from_f32<T>(acc[rr][c] / denom);
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int Sq, int Skv, int D, float scale, int q_offset, int causal,
           int has_window, int window, cudaStream_t stream) {
  const int Dp = (D + 3) & ~3;
  const size_t smem =
      sizeof(float) * (static_cast<size_t>(Dp) * kKtStride +
                       static_cast<size_t>(kTK) * D +
                       static_cast<size_t>(kRows) * Dp + kRows * kTK);
  auto kern = flash_attention_kernel<T>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((Sq + kRows - 1) / kRows, B);
  kern<<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), Sq, Skv, D, Dp, scale,
      q_offset, causal, has_window, window);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* out, int B, int Sq, int Skv, int D,
                               int q_offset, int causal, int has_window,
                               int window, int is_bf16, float scale,
                               void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16>(q, k, v, out, B, Sq, Skv, D, scale,
                                 q_offset, causal, has_window, window, s);
  return launch<float>(q, k, v, out, B, Sq, Skv, D, scale, q_offset, causal,
                       has_window, window, s);
}
