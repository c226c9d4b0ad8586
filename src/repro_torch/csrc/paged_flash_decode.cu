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
// sq > 1; keys past the table's NP pages are never read.  A row with no
// valid key comes out zero (acc / max(l, 1e-30)), so kv_len == 0 rows are
// zeros.  `binary` signs K as it is read (x > 0 -> +1, else -1).
//
// Scores and the 1e-5 tolerance.  The plain version (and cuBLAS under it on
// the card) computes each score as one f32 FMA chain over d from 0.  Unscaled
// rows (|score| ~ 40 at d = 128) amplify any other order's rounding: on the
// card, scores from 3-part bf16 tensor-core products, and from 8-lane tree
// sums, put some seeds' outputs past the tolerance, where chains in the
// plain order stayed far inside it.  So every design below scores in that
// order on the CUDA cores; only P V, whose weights lie in [0, 1], changes
// order.
//
// Three designs; `choose_design` below picks one per call from the shapes
// alone.  The entry runs it, and `paged_flash_plan` tells the wrapper the
// design and the split workspace it must allocate.
//
// 1. Split-KV decode ("flash-decoding"; sq == 1, R <= 8 rows, bf16 or f32
//    pools, 16-byte row chunks a power of two in number).  Bounded by
//    bytes: at the paged path's decode step (8 slots, 1,920 live keys, 16
//    kv heads, d = 64) the live bf16 K+V are 7.86 MB, 2.35 us at 3.35 TB/s.
//    Grid (key split, H_kv, B), a split being `split_pages` pages (the
//    wrapper passes 1: 2 timed within 1-3% of it); the grid is sized
//    from NP (kv_len stays on the card) and a block whose split holds no
//    key of [lo, hi), the keys any row of the slot may see, exits at once.
//    All 128 threads copy the split's live K and V rows into shared memory
//    with 16-byte cp.async copies, all in flight together; the R rows of
//    the kv head share them.  Scores: one key per thread, its R rows' FMA
//    chains reading K 16 bytes at a time (rows padded by 16 bytes, so the
//    threads' reads do not conflict).  Softmax per row on one warp.  P.V:
//    each thread owns one 16-byte column chunk of V and a stride of keys;
//    the partial sums reduce by shuffles and then across warps in shared
//    memory.  Each split writes (m, l, acc[Dv]) in f32 to a workspace that
//    the wrapper allocates; a second kernel, launched right after on the
//    same stream, merges the splits of [lo, hi): m* = max m_s, l = sum l_s
//    e^(m_s - m*), out = sum acc_s e^(m_s - m*) / max(l, 1e-30).
// 2. Chunk rows (bf16 pools, D == Dv in {32, 64, 128}, page a multiple of
//    16 and at most 64 or a multiple of 64; every row set that design 1
//    does not take, mainly sq > 1).  Grid (B, H_kv, 64-row tile), the last
//    row tiles (the longest causal walks) started first; 4 warps of 16
//    rows.  The key loop walks 64-key tiles (or whole pages below 64) of
//    [lo, hi) only: hi = min(kv_len, the tile's last qrow + 1), lo = its
//    first qrow's window start, with the row range taken over every row of
//    the tile (a tile may cross a GQA group boundary).  K/V tiles are
//    double-buffered in shared memory with 16-byte cp.async copies; the
//    next tile's copy is in flight while this one computes.  S: each lane
//    holds a 4-row x 8-key block of its warp's 16 x 64 scores and runs
//    their FMA chains 8 d at a time, q (f32) and K (bf16) read 16 bytes at
//    a time from padded rows.  The online softmax reduces each row over
//    its 8 lanes.  O += P V runs on the tensor cores (mma.sync m16n8k16
//    bf16, f32 accumulation): V is an exact bf16 operand; P goes through
//    shared memory in f32, each warp its own 16 rows, and is split into
//    three bf16 parts as the A fragments are read, hi + lo + lo2 (its 24
//    bits; two parts leave about 2^-17 relative per product), so P V costs
//    3 products per MAC.  The tensor cores round each sum toward zero, so
//    each 16-key step's products start from zero and are added to O in
//    f32.  Why mma.sync and not wgmma: P arrives in 16-row tiles written by
//    each warp for itself, and a tile holds at most 64 keys, so a
//    warpgroup-wide product would add a block barrier per tile for little.
//    Bounded by operations at the path's 384-row chunk: 13.3 us of f32 FMA
//    scores (0.89 GFLOP at 67 TFLOP/s), with 2.7 us of 3-part bf16 P V
//    products beside them on the tensor cores, against 32.5 MB of q, out
//    (f32) and K/V (bf16), 9.7 us.
// 3. SIMT (f32 pools at sq > 1 or R > 8, and shapes the other two do not
//    take: odd widths, pages not a multiple of 16).  Checked, not timed:
//    serving pools are bf16.  Grid (row tiles, H_kv, B); each block walks
//    the slot's live pages in series with the K/V tile in shared memory as
//    f32, one key per lane for scores and one output column per lane for
//    P.V, all in f32 FMA.

#include <cmath>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxSplitRows = 8;   // design 1 rows per kv head
constexpr int kSmemMax = 232448;   // shared memory a block may use
enum Design { kSplit = 0, kMma = 1, kSimt = 2 };

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

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ int phys_page(const int32_t* page_table, int b,
                                         int NP, int j, int P) {
  return min(max(page_table[b * NP + j], 0), P - 1);
}

// [lo, hi): the keys that rows at positions qmin..qmax may see
struct KeyRange {
  int lo, hi;
};
__device__ __forceinline__ KeyRange key_range(int kvl, int qmin, int qmax,
                                              int NP, int page,
                                              int has_window, int window) {
  return {has_window ? max(0, qmin - window + 1) : 0,
          min(min(kvl, qmax + 1), NP * page)};
}

__device__ __forceinline__ float sign_pm1(float x) {
  return x > 0.f ? 1.f : -1.f;
}

// N consecutive floats of shared memory, 16 bytes a load; with N = 4 one
// 16-byte chunk of an f32 row
template <int N>
__device__ __forceinline__ void unpack16(const float* s, float (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N / 4; ++i) {
    const float4 v = reinterpret_cast<const float4*>(s)[i];
    x[4 * i] = v.x;
    x[4 * i + 1] = v.y;
    x[4 * i + 2] = v.z;
    x[4 * i + 3] = v.w;
  }
}
// one 16-byte chunk of a bf16 row as f32
__device__ __forceinline__ void unpack16(const __nv_bfloat16* s,
                                         float (&x)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(s);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

// ---------------------------------------------------------------------------
// design 1: split-KV decode

// shared memory of split_kernel
__host__ __device__ inline size_t split_smem(int R, int D, int Dv, int KS,
                                             int elt) {
  const int cprv = Dv * elt / 16;
  const int nslot = cprv < 32 ? kWarps : kThreads / cprv;
  return static_cast<size_t>(KS) * ((D + Dv) * elt + 16) +
         sizeof(float) * (static_cast<size_t>(R) * D +
                          static_cast<size_t>(R) * KS +
                          static_cast<size_t>(nslot) * R * Dv);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) split_kernel(
    const float* __restrict__ q,             // (B, H, R, D) pre-scaled
    const T* __restrict__ k_pages,           // (P, H, page, D)
    const T* __restrict__ v_pages,           // (P, H, page, Dv)
    const int32_t* __restrict__ page_table,  // (B, NP)
    const int32_t* __restrict__ kv_len,      // (B,)
    const int32_t* __restrict__ q_pos,       // (B,)
    float* __restrict__ ws,  // m, l: (B, H, NS, R); acc: (B, H, NS, R, Dv)
    int R, int D, int Dv, int P, int page, int NP, int sp, int binary,
    int has_window, int window) {
  constexpr int V = 16 / sizeof(T);  // elements per 16-byte chunk
  const int s = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int H = gridDim.y, NS = gridDim.x;
  const int qp = q_pos[b];
  const KeyRange kr = key_range(kv_len[b], qp, qp, NP, page, has_window,
                                window);
  const int KS = sp * page;
  const int ka = max(s * KS, kr.lo), kb = min((s + 1) * KS, kr.hi);
  if (ka >= kb) return;  // no key of this split is seen: the merge skips it
  const int nk = kb - ka;
  const int cpr = D / V, cprv = Dv / V;

  const int kld = D + V;  // K's shared row stride: one chunk of padding,
                          // so the threads' 16-byte row reads do not conflict
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ks = reinterpret_cast<T*>(smem_raw);             // nk x kld
  T* vs = ks + KS * kld;                               // nk x Dv
  float* qs = reinterpret_cast<float*>(vs + KS * Dv);  // R x D
  float* ps = qs + R * D;                              // R x KS
  float* red = ps + R * KS;                            // nslot x R x Dv
  const size_t bh = static_cast<size_t>(b) * H + h;

  for (int i = threadIdx.x; i < nk * cpr; i += kThreads) {
    const int key = ka + i / cpr, c = i % cpr;
    const int phys = phys_page(page_table, b, NP, key / page, P);
    cp_async16(ks + (key - ka) * kld + c * V,
               k_pages + ((static_cast<size_t>(phys) * H + h) * page +
                          key % page) * D + c * V);
  }
  for (int i = threadIdx.x; i < nk * cprv; i += kThreads) {
    const int key = ka + i / cprv, c = i % cprv;
    const int phys = phys_page(page_table, b, NP, key / page, P);
    cp_async16(vs + (key - ka) * Dv + c * V,
               v_pages + ((static_cast<size_t>(phys) * H + h) * page +
                          key % page) * Dv + c * V);
  }
  cp_async_commit();
  for (int i = threadIdx.x; i < R * D; i += kThreads) qs[i] = q[bh * R * D + i];
  cp_async_wait<0>();
  __syncthreads();

  // scores: one key per thread; each row's score is an f32 FMA chain over
  // d from 0 in order, the plain version's own order (see the header)
  for (int kk = threadIdx.x; kk < nk; kk += kThreads) {
    float sc[kMaxSplitRows];
#pragma unroll
    for (int r = 0; r < kMaxSplitRows; ++r) sc[r] = 0.f;
    for (int c = 0; c < cpr; ++c) {
      float x[V];
      unpack16(ks + kk * kld + c * V, x);
      if (binary) {
#pragma unroll
        for (int e = 0; e < V; ++e) x[e] = sign_pm1(x[e]);
      }
#pragma unroll
      for (int r = 0; r < kMaxSplitRows; ++r) {
        if (r < R) {
          float qv[V];
          unpack16(qs + r * D + c * V, qv);
#pragma unroll
          for (int e = 0; e < V; ++e) sc[r] = fmaf(qv[e], x[e], sc[r]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kMaxSplitRows; ++r)
      if (r < R) ps[r * KS + kk] = sc[r];
  }
  __syncthreads();

  // softmax of each row over the split (every key of [ka, kb) is valid)
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t n_part = static_cast<size_t>(NS) * H * gridDim.z * R;
  const size_t part = (bh * NS + s) * R;
  for (int r = warp; r < R; r += kWarps) {
    float* pr = ps + r * KS;
    float mx = -INFINITY;
    for (int i = lane; i < nk; i += 32) mx = fmaxf(mx, pr[i]);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int i = lane; i < nk; i += 32) {
      const float e = expf(pr[i] - mx);
      pr[i] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    if (lane == 0) {
      ws[part + r] = mx;
      ws[n_part + part + r] = sum;
    }
  }
  __syncthreads();

  // P.V: one 16-byte column chunk of V per thread, keys strided over the
  // thread's key group; the groups reduce by shuffles within a warp, then
  // across the warps' slots in shared memory
  const int c = threadIdx.x % cprv, kg = threadIdx.x / cprv;
  const int kgn = kThreads / cprv;
  float acc[kMaxSplitRows][V];
#pragma unroll
  for (int r = 0; r < kMaxSplitRows; ++r)
#pragma unroll
    for (int e = 0; e < V; ++e) acc[r][e] = 0.f;
  for (int kk = kg; kk < nk; kk += kgn) {
    float x[V];
    unpack16(vs + kk * Dv + c * V, x);
#pragma unroll
    for (int r = 0; r < kMaxSplitRows; ++r) {
      if (r < R) {
        const float p = ps[r * KS + kk];
#pragma unroll
        for (int e = 0; e < V; ++e) acc[r][e] = fmaf(p, x[e], acc[r][e]);
      }
    }
  }
  const int nslot = cprv < 32 ? kWarps : kgn;
  const int slot = cprv < 32 ? warp : kg;
#pragma unroll
  for (int r = 0; r < kMaxSplitRows; ++r) {
    if (r < R) {
#pragma unroll
      for (int e = 0; e < V; ++e) {
        for (int off = cprv; off < 32; off <<= 1)
          acc[r][e] += __shfl_xor_sync(0xffffffffu, acc[r][e], off);
        if (cprv >= 32 || lane < cprv)
          red[(slot * R + r) * Dv + c * V + e] = acc[r][e];
      }
    }
  }
  __syncthreads();
  float* acc_out = ws + 2 * n_part + part * Dv;
  for (int i = threadIdx.x; i < R * Dv; i += kThreads) {
    float a = 0.f;
    for (int t = 0; t < nslot; ++t) a += red[t * R * Dv + i];
    acc_out[i] = a;
  }
}

// merges the splits of [lo, hi) of each (b, h, row); grid (H, B).  One
// warp per row finds m* and the splits' weights e^(m_s - m*) into shared
// memory, then each thread sums one output column over the splits.
__global__ void __launch_bounds__(kThreads) merge_kernel(
    const float* __restrict__ ws, const int32_t* __restrict__ kv_len,
    const int32_t* __restrict__ q_pos, float* __restrict__ out, int R, int Dv,
    int page, int NP, int sp, int NS, int has_window, int window) {
  extern __shared__ float wsm[];  // R x NS weights, then R denominators
  const int h = blockIdx.x, b = blockIdx.y;
  const size_t bh = static_cast<size_t>(b) * gridDim.x + h;
  const size_t n_part = static_cast<size_t>(NS) * gridDim.x * gridDim.y * R;
  const int qp = q_pos[b];
  const KeyRange kr = key_range(kv_len[b], qp, qp, NP, page, has_window,
                                window);
  const int KS = sp * page;
  const int s0 = kr.lo / KS;
  const int n = kr.hi > kr.lo ? (kr.hi - 1) / KS + 1 - s0 : 0;
  const float* m_s = ws + (bh * NS + s0) * R;  // split s0 + t at t * R
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < R; r += kWarps) {
    float mx = -INFINITY;
    for (int t = lane; t < n; t += 32) mx = fmaxf(mx, m_s[t * R + r]);
    mx = warp_max(mx);
    float l = 0.f;
    for (int t = lane; t < n; t += 32) {
      const float w = expf(m_s[t * R + r] - mx);
      wsm[r * NS + t] = w;
      l = fmaf(m_s[n_part + t * R + r], w, l);
    }
    l = warp_sum(l);
    if (lane == 0) wsm[R * NS + r] = fmaxf(l, 1e-30f);
  }
  __syncthreads();
  const float* acc = ws + 2 * n_part + (bh * NS + s0) * R * Dv;
  for (int i = threadIdx.x; i < R * Dv; i += kThreads) {
    const int r = i / Dv;
    float a = 0.f;
#pragma unroll 4
    for (int t = 0; t < n; ++t)
      a = fmaf(acc[t * R * Dv + i], wsm[r * NS + t], a);
    out[bh * R * Dv + i] = n > 0 ? a / wsm[R * NS + r] : 0.f;
  }
}

template <typename T>
int launch_split(const void* q, const void* k, const void* v, const void* pt,
                 const void* kvl, const void* qpos, void* out, void* ws, int B,
                 int H, int R, int D, int Dv, int P, int page, int NP, int sp,
                 int binary, int has_window, int window, cudaStream_t stream) {
  const int NS = (NP + sp - 1) / sp;
  const size_t smem = split_smem(R, D, Dv, sp * page, sizeof(T));
  auto kern = split_kernel<T>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kern<<<dim3(NS, H, B), kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int32_t*>(pt),
      static_cast<const int32_t*>(kvl), static_cast<const int32_t*>(qpos),
      static_cast<float*>(ws), R, D, Dv, P, page, NP, sp, binary, has_window,
      window);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const size_t merge_smem = sizeof(float) * (static_cast<size_t>(R) * NS + R);
  if (merge_smem > 48 * 1024) {
    const cudaError_t e2 = cudaFuncSetAttribute(
        merge_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(merge_smem));
    if (e2 != cudaSuccess) return static_cast<int>(e2);
  }
  merge_kernel<<<dim3(H, B), kThreads, merge_smem, stream>>>(
      static_cast<const float*>(ws), static_cast<const int32_t*>(kvl),
      static_cast<const int32_t*>(qpos), static_cast<float*>(out), R, Dv, page,
      NP, sp, NS, has_window, window);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// design 2: tensor-core chunk rows (bf16 pools)

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// (x0, x1) = p[0] + p[1] + p[2] in bf16 pairs (x0 in the low half), each
// part rounded to nearest from what the parts before it leave
__device__ __forceinline__ void split_pair(float2 x, uint32_t (&p)[3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(x.x, x.y);
    p[i] = pack_bf16(h);
    x.x -= __low2float(h);
    x.y -= __high2float(h);
  }
}

constexpr int kTileRows = 64;  // query rows per block, 16 per warp
constexpr int kTileKeys = 64;  // keys per K/V tile at most
// P's shared row stride in floats: rows 32 bytes apart modulo 128, so the
// A fragments' 8-byte reads (4 rows x 32 bytes a half-warp) do not conflict
constexpr int kLdP = kTileKeys + 8;

template <int DT>
constexpr size_t mma_smem() {  // q, K and V (2 stages), P (f32)
  return sizeof(float) * kTileRows * (DT + 4 + kLdP) +
         sizeof(__nv_bfloat16) * 4 * kTileKeys * (DT + 8);
}

template <int DT>  // D == Dv == DT
__global__ void __launch_bounds__(kThreads, 3) mma_kernel(
    const float* __restrict__ q,             // (B, H, R, DT) pre-scaled
    const __nv_bfloat16* __restrict__ k_pages,
    const __nv_bfloat16* __restrict__ v_pages,
    const int32_t* __restrict__ page_table, const int32_t* __restrict__ kv_len,
    const int32_t* __restrict__ q_pos, float* __restrict__ out, int R, int P,
    int page, int NP, int sq, int binary, int has_window, int window) {
  constexpr int kLd = DT + 8;      // shared row stride of K and V, bf16
  constexpr int kLdQ = DT + 4;     // shared row stride of q, f32
  constexpr int kChunks = DT / 8;  // 16-byte chunks per K/V row
  // blocks start in x-fastest order: every slot's and head's last row
  // tile (the longest causal walk) first
  const int b = blockIdx.x, h = blockIdx.y, H = gridDim.y;
  const int tile = gridDim.z - 1 - blockIdx.z;
  const size_t bh = static_cast<size_t>(b) * H + h;
  const int r0 = tile * kTileRows;
  const int r_last = min(r0 + kTileRows, R) - 1;
  const int kvl = kv_len[b], qp = q_pos[b];
  const bool one_group = r0 / sq == r_last / sq;
  const KeyRange kr = key_range(kvl, qp + (one_group ? r0 % sq : 0),
                                qp + (one_group ? r_last % sq : sq - 1), NP,
                                page, has_window, window);
  const int kt = min(page, kTileKeys);
  const int t0 = kr.lo / kt;
  const int t1 = kr.hi > kr.lo ? (kr.hi - 1) / kt + 1 : t0;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* qs = reinterpret_cast<float*>(smem_raw);
  __nv_bfloat16* kbuf =
      reinterpret_cast<__nv_bfloat16*>(qs + kTileRows * kLdQ);
  __nv_bfloat16* vbuf = kbuf + 2 * kTileKeys * kLd;
  float* pbuf = reinterpret_cast<float*>(vbuf + 2 * kTileKeys * kLd);

  // K/V tile t of the slot into stage `st`; a thread copies the same
  // chunks of every tile, so it can sign its own K chunks after the wait
  auto load_tile = [&](int t, int st) {
    const int key0 = t * kt;
    const int phys = phys_page(page_table, b, NP, key0 / page, P);
    const size_t base =
        ((static_cast<size_t>(phys) * H + h) * page + key0 % page) * DT;
    for (int i = threadIdx.x; i < kt * kChunks; i += kThreads) {
      const int row = i / kChunks, c = (i % kChunks) * 8;
      cp_async16(kbuf + (st * kTileKeys + row) * kLd + c,
                 k_pages + base + row * DT + c);
      cp_async16(vbuf + (st * kTileKeys + row) * kLd + c,
                 v_pages + base + row * DT + c);
    }
  };
  if (t0 < t1) load_tile(t0, 0);
  cp_async_commit();
  for (int i = threadIdx.x; i < kTileRows * DT; i += kThreads) {
    const int row = i / DT, d = i % DT;
    qs[row * kLdQ + d] = r0 + row < R ? q[(bh * R + r0 + row) * DT + d] : 0.f;
  }

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wr0 = r0 + warp * 16;
  // score layout: lane = kq + 8 rr holds rows rr + 4 i (i < 4) of the
  // warp's 16 and keys kq + 8 j (j < 8) of the tile
  const int kq = lane % 8, rr = lane / 8;
  // mma layout: rows g and g + 8 of the warp's 16, columns 2 tq, 2 tq + 1
  const int g = lane / 4, tq = lane % 4;
  int qrow[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) qrow[i] = qp + (wr0 + rr + 4 * i) % sq;
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
  }
  float o[DT / 8][4];
#pragma unroll
  for (int n = 0; n < DT / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float* pw = pbuf + warp * 16 * kLdP;  // the warp's 16 rows of P

  for (int t = t0; t < t1; ++t) {
    const int st = (t - t0) & 1;
    if (t + 1 < t1) load_tile(t + 1, st ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __nv_bfloat16* kb = kbuf + st * kTileKeys * kLd;
    const __nv_bfloat16* vb = vbuf + st * kTileKeys * kLd;
    if (binary) {  // sign this thread's own K chunks of the tile
      for (int i = threadIdx.x; i < kt * kChunks; i += kThreads) {
        __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(
            kb + (i / kChunks) * kLd + (i % kChunks) * 8);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 f = __bfloat1622float2(p[e]);
          p[e] = __floats2bfloat162_rn(sign_pm1(f.x), sign_pm1(f.y));
        }
      }
    }
    __syncthreads();
    if (wr0 < R) {  // warp-uniform
      // S = Q K^T in f32 FMA, each score a chain over d from 0 in order
      float s[4][8];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
#pragma unroll 1
      for (int c = 0; c < DT; c += 8) {
        // 8 d of 4 q rows (f32) and of 8 keys (bf16 pairs), then the 32
        // independent chains advance one d at a time
        float qv[4][8];
        uint32_t kw[8][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          unpack16(qs + (warp * 16 + rr + 4 * i) * kLdQ + c, qv[i]);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const uint4 u =
              *reinterpret_cast<const uint4*>(kb + (kq + 8 * j) * kLd + c);
          kw[j][0] = u.x;
          kw[j][1] = u.y;
          kw[j][2] = u.z;
          kw[j][3] = u.w;
        }
#pragma unroll
        for (int e = 0; e < 8; ++e) {
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            // bf16 to f32: the 16 bits above 16 zero bits
            const uint32_t w = kw[j][e / 2];
            const float kf = __uint_as_float(e % 2 ? w & 0xffff0000u : w << 16);
#pragma unroll
            for (int i = 0; i < 4; ++i) s[i][j] = fmaf(qv[i][e], kf, s[i][j]);
          }
        }
      }
      // masks and the online softmax over the 8 lanes of each row; a row
      // with no valid key in the tile keeps its state (alpha = 1, p = 0)
      const int key0 = t * kt;
      float alpha[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float tmax = -INFINITY;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int kpos = key0 + kq + 8 * j;
          bool ok = kq + 8 * j < kt && kpos < kvl && kpos <= qrow[i];
          if (has_window) ok = ok && kpos > qrow[i] - window;
          s[i][j] = ok ? s[i][j] : -INFINITY;
          tmax = fmaxf(tmax, s[i][j]);
        }
#pragma unroll
        for (int off = 1; off < 8; off <<= 1)
          tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, off));
        const float m_new = fmaxf(m[i], tmax);
        const float m_use = m_new == -INFINITY ? 0.f : m_new;
        alpha[i] = expf(m[i] - m_use);
        m[i] = m_new;
        l[i] *= alpha[i];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float p = s[i][j] == -INFINITY ? 0.f : expf(s[i][j] - m_use);
          l[i] += p;
          pw[(rr + 4 * i) * kLdP + kq + 8 * j] = p;
        }
      }
      // alpha of rows g and g + 8, held by lane 8 (g % 4) as alpha[g / 4]
      // and alpha[2 + g / 4]
      const int src = 8 * (g % 4);
      float al[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        al[i] = __shfl_sync(0xffffffffu, alpha[i], src);
      const float a_lo = g < 4 ? al[0] : al[1], a_hi = g < 4 ? al[2] : al[3];
#pragma unroll
      for (int n = 0; n < DT / 8; ++n) {
        o[n][0] *= a_lo;
        o[n][1] *= a_lo;
        o[n][2] *= a_hi;
        o[n][3] *= a_hi;
      }
      __syncwarp();
      // O += P V on the tensor cores: V exact in bf16, P read in the A
      // fragment's layout and split into three parts, small parts first.
      // The tensor cores truncate each sum to f32 toward zero, so each
      // 16-key step's products start from zero and are added to O in f32,
      // rounded to nearest.
#pragma unroll
      for (int kk = 0; kk < kTileKeys / 16; ++kk) {
        if (kk * 16 < kt) {
          const float* pr = pw + g * kLdP + kk * 16 + 2 * tq;
          uint32_t p4[4][3], a[3][4];
          split_pair(*reinterpret_cast<const float2*>(pr), p4[0]);
          split_pair(*reinterpret_cast<const float2*>(pr + 8 * kLdP), p4[1]);
          split_pair(*reinterpret_cast<const float2*>(pr + 8), p4[2]);
          split_pair(*reinterpret_cast<const float2*>(pr + 8 * kLdP + 8),
                     p4[3]);
#pragma unroll
          for (int part = 0; part < 3; ++part)
#pragma unroll
            for (int i = 0; i < 4; ++i) a[part][i] = p4[i][part];
#pragma unroll
          for (int n2 = 0; n2 < DT / 16; ++n2) {
            uint32_t bb[4];
            ldsm_x4_t(bb, vb + (kk * 16 + ((lane / 8) % 2) * 8 + lane % 8) *
                                   kLd + n2 * 16 + (lane / 16) * 8);
            float c0[4] = {0.f, 0.f, 0.f, 0.f}, c1[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
            for (int part = 2; part >= 0; --part) {
              mma_bf16(c0, a[part], bb[0], bb[1]);
              mma_bf16(c1, a[part], bb[2], bb[3]);
            }
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              o[2 * n2][e] += c0[e];
              o[2 * n2 + 1][e] += c1[e];
            }
          }
        }
      }
    }
    __syncthreads();  // every warp is done with stage st before its refill
  }

  // each row's denominator over its 8 lanes, then to rows g and g + 8
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int off = 1; off < 8; off <<= 1)
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], off);
  float lr[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    lr[i] = __shfl_sync(0xffffffffu, l[i], 8 * (g % 4));
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int row = wr0 + g + 8 * hr;
    if (row >= R) continue;
    const float den = g < 4 ? lr[2 * hr] : lr[2 * hr + 1];
    const float inv = 1.f / fmaxf(den, 1e-30f);
    float* dst = out + (bh * R + row) * DT + 2 * tq;
#pragma unroll
    for (int n = 0; n < DT / 8; ++n)
      *reinterpret_cast<float2*>(dst + n * 8) =
          make_float2(o[n][2 * hr] * inv, o[n][2 * hr + 1] * inv);
  }
}

template <int DT>
int launch_mma(const void* q, const void* k, const void* v, const void* pt,
               const void* kvl, const void* qpos, void* out, int B, int H,
               int R, int P, int page, int NP, int sq, int binary,
               int has_window, int window, cudaStream_t stream) {
  constexpr size_t smem = mma_smem<DT>();
  auto kern = mma_kernel<DT>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid(B, H, (R + kTileRows - 1) / kTileRows);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const int32_t*>(pt),
      static_cast<const int32_t*>(kvl), static_cast<const int32_t*>(qpos),
      static_cast<float*>(out), R, P, page, NP, sq, binary, has_window,
      window);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// design 3: SIMT rows

constexpr float kNegInf = -1.0e9f;
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

template <typename T, int RPW>
__global__ void __launch_bounds__(kThreads) simt_kernel(
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
    const int phys = phys_page(page_table, b, NP, j, P);
    const T* kt = k_pages + (static_cast<size_t>(phys) * H + h) * page * D;
    const T* vt = v_pages + (static_cast<size_t>(phys) * H + h) * page * Dv;
    __syncthreads();  // every warp is done with the previous tile
    for (int i = threadIdx.x; i < page * D; i += blockDim.x) {
      float x = to_f32(kt[i]);
      if (binary) x = sign_pm1(x);
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
int launch_simt(const void* q, const void* k, const void* v, const void* pt,
                const void* kvl, const void* qpos, void* out, int B, int H,
                int R, int D, int Dv, int P, int page, int NP, int sq,
                int binary, int has_window, int window, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (static_cast<size_t>(page) * (D + 1) +
                                       static_cast<size_t>(page) * Dv +
                                       kWarps * RPW * D + kWarps * page);
  auto kern = simt_kernel<T, RPW>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int rows_per_block = kWarps * RPW;
  const dim3 grid((R + rows_per_block - 1) / rows_per_block, H, B);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int32_t*>(pt),
      static_cast<const int32_t*>(kvl), static_cast<const int32_t*>(qpos),
      static_cast<float*>(out), H, R, D, Dv, P, page, NP, sq, binary,
      has_window, window);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_simt_rows(const void* q, const void* k, const void* v,
                     const void* pt, const void* kvl, const void* qpos,
                     void* out, int B, int H, int R, int D, int Dv, int P,
                     int page, int NP, int sq, int binary, int has_window,
                     int window, cudaStream_t stream) {
  // one row per warp while the rows fit one block, four per warp beyond
  return R <= kWarps
             ? launch_simt<T, 1>(q, k, v, pt, kvl, qpos, out, B, H, R, D, Dv,
                                 P, page, NP, sq, binary, has_window, window,
                                 stream)
             : launch_simt<T, 4>(q, k, v, pt, kvl, qpos, out, B, H, R, D, Dv,
                                 P, page, NP, sq, binary, has_window, window,
                                 stream);
}

// 16-byte chunks of a row of `width` elements: a power of two in number,
// as split_kernel's P.V reduction needs
bool pow2_chunks(int width, int elt) {
  const int bytes = width * elt, n = bytes / 16;
  return bytes % 16 == 0 && n > 0 && (n & (n - 1)) == 0;
}

// the design of one call (see the header)
Design choose_design(int R, int D, int Dv, int page, int sq, int is_bf16,
                     int split_pages) {
  const int elt = is_bf16 ? 2 : 4;
  if (sq == 1 && R <= kMaxSplitRows && split_pages >= 1 &&
      pow2_chunks(D, elt) && pow2_chunks(Dv, elt) &&
      split_smem(R, D, Dv, split_pages * page, elt) <= kSmemMax)
    return kSplit;
  if (is_bf16 && D == Dv && (D == 32 || D == 64 || D == 128) &&
      page % 16 == 0 && (page <= kTileKeys || page % kTileKeys == 0))
    return kMma;
  return kSimt;
}

}  // namespace

// The design `paged_flash_decode` runs for these shapes (0 split-KV, 1
// chunk tiles, 2 SIMT), and in `ws_floats` the floats of split workspace
// it needs: B * H * ceil(NP / split_pages) * R * (Dv + 2), or 0.
extern "C" int paged_flash_plan(int B, int H, int R, int D, int Dv, int page,
                                int NP, int sq, int is_bf16, int split_pages,
                                long long* ws_floats) {
  const Design design =
      choose_design(R, D, Dv, page, sq, is_bf16, split_pages);
  *ws_floats = design == kSplit
                   ? static_cast<long long>(B) * H *
                         ((NP + split_pages - 1) / split_pages) * R *
                         (Dv + 2)
                   : 0;
  return design;
}

// `ws` is the split workspace that paged_flash_plan sizes (unused by the
// other designs).
extern "C" int paged_flash_decode(
    const void* q, const void* k_pages, const void* v_pages,
    const void* page_table, const void* kv_len, const void* q_pos, void* out,
    void* ws, int B, int H, int R, int D, int Dv, int P, int page, int NP,
    int sq, int binary, int has_window, int window, int is_bf16,
    int split_pages, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Design design =
      choose_design(R, D, Dv, page, sq, is_bf16, split_pages);
  if (design == kSplit) {
    if (ws == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    return is_bf16
               ? launch_split<__nv_bfloat16>(q, k_pages, v_pages, page_table,
                                             kv_len, q_pos, out, ws, B, H, R,
                                             D, Dv, P, page, NP, split_pages,
                                             binary, has_window, window, s)
               : launch_split<float>(q, k_pages, v_pages, page_table, kv_len,
                                     q_pos, out, ws, B, H, R, D, Dv, P, page,
                                     NP, split_pages, binary, has_window,
                                     window, s);
  }
  if (design == kMma) {
    switch (D) {
      case 32:
        return launch_mma<32>(q, k_pages, v_pages, page_table, kv_len, q_pos,
                              out, B, H, R, P, page, NP, sq, binary,
                              has_window, window, s);
      case 64:
        return launch_mma<64>(q, k_pages, v_pages, page_table, kv_len, q_pos,
                              out, B, H, R, P, page, NP, sq, binary,
                              has_window, window, s);
      default:
        return launch_mma<128>(q, k_pages, v_pages, page_table, kv_len,
                               q_pos, out, B, H, R, P, page, NP, sq, binary,
                               has_window, window, s);
    }
  }
  return is_bf16
             ? launch_simt_rows<__nv_bfloat16>(
                   q, k_pages, v_pages, page_table, kv_len, q_pos, out, B, H,
                   R, D, Dv, P, page, NP, sq, binary, has_window, window, s)
             : launch_simt_rows<float>(q, k_pages, v_pages, page_table,
                                       kv_len, q_pos, out, B, H, R, D, Dv, P,
                                       page, NP, sq, binary, has_window,
                                       window, s);
}
