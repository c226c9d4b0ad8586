// Paged flash attention for decode rows (sq == 1) and chunk rows (sq > 1).
//
// Replaces the TPU kernel kernels/paged_flash_decode.py::paged_flash_decode
// of the reference package, both its sq == 1 (decode) and sq > 1
// (chunked prefill) forms.
//
// Computes, per (slot b, kv head h, query row r), an online-softmax
// attention of the pre-scaled f32 query row over the K/V page tiles of the
// slot's page table, in logical page order.  Key kpos is valid when
// kpos < kv_len[b] and kpos <= qrow (and kpos > qrow - window when a window
// is set), with qrow = q_pos[b] for sq == 1 and q_pos[b] + r % sq for
// sq > 1.  Pages at or past kv_len are skipped (no load, no compute); a
// page with no valid key for a row leaves that row's state unchanged,
// exactly as the reference's masked update does.  The result is
// acc / max(l, 1e-30), so kv_len == 0 rows come out zero.  `binary` signs
// the K tile as it is loaded (x > 0 -> +1, else -1).
//
// Design.  Grid (row tiles, H_kv, B); 4 warps per block.  The loop over
// live pages inside the block takes the place of the TPU's sequential grid
// axis: the running max, denominator and accumulator of each row stay in
// registers for the whole walk.  Rows are tiled across blocks (RPW rows
// per warp), because at prefill R = G * Sq reaches the prompt length.  All
// warps load each K/V page tile into shared memory as f32 (K with a padded
// row stride, so the lanes' column reads do not conflict); each warp then
// scores its rows, one key per lane, and accumulates P.V with one output
// column per lane.  Arithmetic is f32 FMA throughout (no TF32, no tensor
// cores).
//
// Bound.  At 8 slots x 512 tokens the live bf16 K+V are about 16.8 MB per
// layer, about 5 us at 3.35 TB/s: decode rows are bounded by bytes.  A
// prefill chunk of 384 rows does about 1.8 GFLOP of causally valid f32 work
// per layer, about 27 us at 67 TFLOP/s: it is bounded by operations.  This
// first version moves each live byte once per row tile, walks every live
// page for every row tile (no causal page skip), and makes no use of TMA
// or wgmma; those are later work.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float kNegInf = -1.0e9f;
constexpr int kWarps = 4;
constexpr int kMaxDvPerLane = 8;  // Dv <= 256

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

template <typename T, int RPW>
__global__ void __launch_bounds__(kWarps * 32) paged_flash_kernel(
    const float* __restrict__ q,             // (B, H, R, D) pre-scaled
    const T* __restrict__ k_pages,           // (P, H, page, D)
    const T* __restrict__ v_pages,           // (P, H, page, Dv)
    const int32_t* __restrict__ page_table,  // (B, NP)
    const int32_t* __restrict__ kv_len,      // (B,)
    const int32_t* __restrict__ q_pos,       // (B,)
    float* __restrict__ out,                 // (B, H, R, Dv)
    int H, int R, int D, int Dv, int P, int page, int NP, int sq, int binary,
    int has_window, int window) {
  extern __shared__ float smem[];
  const int ks_stride = D + 1;  // padded: lane p reads column d conflict-free
  float* ks = smem;                          // page * (D + 1)
  float* vs = ks + page * ks_stride;         // page * Dv
  float* qs = vs + page * Dv;                // kWarps * RPW * D
  float* ps = qs + kWarps * RPW * D;         // kWarps * page

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int block_row0 = blockIdx.x * kWarps * RPW;
  const int row0 = block_row0 + warp * RPW;
  const int kvl = kv_len[b];
  const int qp0 = q_pos[b];
  const size_t bh = static_cast<size_t>(b) * H + h;

  for (int i = threadIdx.x; i < kWarps * RPW * D; i += blockDim.x) {
    const int row = block_row0 + i / D;
    qs[i] = row < R ? q[(bh * R + row) * D + i % D] : 0.f;
  }

  float m[RPW], l[RPW], acc[RPW][kMaxDvPerLane];
#pragma unroll
  for (int rr = 0; rr < RPW; ++rr) {
    m[rr] = kNegInf;
    l[rr] = 0.f;
#pragma unroll
    for (int c = 0; c < kMaxDvPerLane; ++c) acc[rr][c] = 0.f;
  }

  const int n_live = min(NP, (kvl + page - 1) / page);
  float* pw = ps + warp * page;
  for (int j = 0; j < n_live; ++j) {
    int phys = page_table[b * NP + j];
    phys = min(max(phys, 0), P - 1);
    const T* kt = k_pages + (static_cast<size_t>(phys) * H + h) * page * D;
    const T* vt = v_pages + (static_cast<size_t>(phys) * H + h) * page * Dv;
    __syncthreads();  // every warp is done with the previous tile
    for (int i = threadIdx.x; i < page * D; i += blockDim.x) {
      float x = to_f32(kt[i]);
      if (binary) x = x > 0.f ? 1.f : -1.f;
      ks[(i / D) * ks_stride + i % D] = x;
    }
    for (int i = threadIdx.x; i < page * Dv; i += blockDim.x)
      vs[i] = to_f32(vt[i]);
    __syncthreads();

#pragma unroll
    for (int rr = 0; rr < RPW; ++rr) {
      const int row = row0 + rr;
      if (row >= R) break;  // warp-uniform
      const int qrow = sq > 1 ? qp0 + row % sq : qp0;
      const float* qv = qs + (warp * RPW + rr) * D;
      float smax = kNegInf;
      for (int p = lane; p < page; p += 32) {
        const int kpos = j * page + p;
        bool ok = kpos < kvl && kpos <= qrow;
        if (has_window) ok = ok && kpos > qrow - window;
        float s = kNegInf;
        if (ok) {
          const float* kr = ks + p * ks_stride;
          float a = 0.f;
          for (int d = 0; d < D; ++d) a = fmaf(qv[d], kr[d], a);
          s = a;
        }
        pw[p] = s;
        smax = fmaxf(smax, s);
      }
      smax = warp_max(smax);
      if (smax <= kNegInf) {  // no valid key in this page: state unchanged
        __syncwarp();
        continue;
      }
      const float m_new = fmaxf(m[rr], smax);
      const float alpha = expf(m[rr] - m_new);
      float psum = 0.f;
      for (int p = lane; p < page; p += 32) {
        const float s = pw[p];
        const float e = s > kNegInf ? expf(s - m_new) : 0.f;
        pw[p] = e;
        psum += e;
      }
      psum = warp_sum(psum);
      l[rr] = l[rr] * alpha + psum;
      __syncwarp();
#pragma unroll
      for (int c = 0; c < kMaxDvPerLane; ++c) {
        const int dv = lane + 32 * c;
        if (dv < Dv) {
          float a = 0.f;
          for (int p = 0; p < page; ++p) a = fmaf(pw[p], vs[p * Dv + dv], a);
          acc[rr][c] = acc[rr][c] * alpha + a;
        }
      }
      m[rr] = m_new;
      __syncwarp();
    }
  }

#pragma unroll
  for (int rr = 0; rr < RPW; ++rr) {
    const int row = row0 + rr;
    if (row >= R) break;
    const float inv = 1.f / fmaxf(l[rr], 1e-30f);
#pragma unroll
    for (int c = 0; c < kMaxDvPerLane; ++c) {
      const int dv = lane + 32 * c;
      if (dv < Dv) out[(bh * R + row) * Dv + dv] = acc[rr][c] * inv;
    }
  }
}

template <typename T, int RPW>
int launch(const void* q, const void* k, const void* v, const void* pt,
           const void* kvl, const void* qpos, void* out, int B, int H, int R,
           int D, int Dv, int P, int page, int NP, int sq, int binary,
           int has_window, int window, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (static_cast<size_t>(page) * (D + 1) +
                                       static_cast<size_t>(page) * Dv +
                                       kWarps * RPW * D + kWarps * page);
  auto kern = paged_flash_kernel<T, RPW>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int rows_per_block = kWarps * RPW;
  const dim3 grid((R + rows_per_block - 1) / rows_per_block, H, B);
  kern<<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int32_t*>(pt),
      static_cast<const int32_t*>(kvl), static_cast<const int32_t*>(qpos),
      static_cast<float*>(out), H, R, D, Dv, P, page, NP, sq, binary,
      has_window, window);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int paged_flash_decode(
    const void* q, const void* k_pages, const void* v_pages,
    const void* page_table, const void* kv_len, const void* q_pos, void* out,
    int B, int H, int R, int D, int Dv, int P, int page, int NP, int sq,
    int binary, int has_window, int window, int is_bf16, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  // one row per warp while the rows fit one block, four per warp beyond
  if (is_bf16) {
    return R <= kWarps
               ? launch<__nv_bfloat16, 1>(q, k_pages, v_pages, page_table,
                                          kv_len, q_pos, out, B, H, R, D, Dv,
                                          P, page, NP, sq, binary, has_window,
                                          window, s)
               : launch<__nv_bfloat16, 4>(q, k_pages, v_pages, page_table,
                                          kv_len, q_pos, out, B, H, R, D, Dv,
                                          P, page, NP, sq, binary, has_window,
                                          window, s);
  }
  return R <= kWarps
             ? launch<float, 1>(q, k_pages, v_pages, page_table, kv_len,
                                q_pos, out, B, H, R, D, Dv, P, page, NP, sq,
                                binary, has_window, window, s)
             : launch<float, 4>(q, k_pages, v_pages, page_table, kv_len,
                                q_pos, out, B, H, R, D, Dv, P, page, NP, sq,
                                binary, has_window, window, s);
}
