// Paged BA-CAM decode: binary scoring + stage-1 top-k per group of keys.
//
// Replaces the TPU kernel kernels/bacam_decode.py::bacam_paged_topk_stage1
// of the reference package (body kernels/bacam_topk.py::score_and_stage1).
//
// For each (slot b, kv head h, logical page j) the kernel reads physical
// page page_table[b, j] of the bit-packed key pool, scores every key
// against the R query rows as d - 2 * popcount(q ^ k), masks keys with
// kpos >= kv_len[b], kpos > q_pos[b] (and kpos <= q_pos[b] - window when a
// window is set) to MASKED_SCORE, and keeps the top stage1_k (value,
// logical index) pairs of each group of `group` keys, ties to the lowest
// index.  Output order is page-major, group-major, top-k-minor.
//
// Design.  One block per (slot, kv head, a run of pages_per_block logical
// pages), one thread per key.  A thread loads its key's W packed words
// (8 bytes at d = 64) into registers once and scores all R rows with
// __popc.  The `group` lanes of one key group (a half-warp at group 16)
// pick the top stage1_k by shuffle reductions on (value, -index), so the
// lowest index wins a tie.  The block reads page_table[b, j] itself (there
// is no scalar prefetch on this card).  Pages at or past kv_len load
// nothing and still write MASKED_SCORE, because the output covers every
// logical page of the table.
//
// Bound.  At the serving shapes (8 slots, 16 kv heads, 64-key pages,
// d = 64, one row) the live packed keys are about 0.5 MB per layer: well
// under a microsecond of HBM time at 3.35 TB/s.  The kernel is bounded by
// launch latency, so it is kept to one launch per layer with no
// intermediate buffers.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaskedScore = -(1 << 30);
constexpr int kMaxWords = 8;  // d <= 256
constexpr int kKeysPerBlock = 256;

__device__ __forceinline__ bool better(int v1, int i1, int v2, int i2) {
  return v1 > v2 || (v1 == v2 && i1 < i2);
}

__global__ void bacam_paged_topk_stage1_kernel(
    const int32_t* __restrict__ q,           // (B, H, R, W)
    const int32_t* __restrict__ kp,          // (P, H, page, W)
    const int32_t* __restrict__ page_table,  // (B, NP)
    const int32_t* __restrict__ kv_len,      // (B,)
    const int32_t* __restrict__ q_pos,       // (B,)
    int32_t* __restrict__ vals,              // (B, H, R, NP * ncp)
    int32_t* __restrict__ idx,               // (B, H, R, NP * ncp)
    int H, int R, int W, int P, int page, int NP, int d, int group,
    int stage1_k, int pages_per_block, int has_window, int window) {
  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int t = threadIdx.x;
  const int j = blockIdx.x * pages_per_block + t / page;  // logical page
  const int p = t % page;                                 // key in page
  const bool active = t < pages_per_block * page && j < NP;
  const int kvl = kv_len[b];
  const int qpos = q_pos[b];
  const int kpos = j * page + p;  // logical key index (unique per thread)
  bool ok = active && kpos < kvl && kpos <= qpos;
  if (has_window) ok = ok && kpos > qpos - window;

  uint32_t kw[kMaxWords];
  if (ok) {
    int phys = page_table[b * NP + j];
    phys = min(max(phys, 0), P - 1);
    const int32_t* kr = kp + ((static_cast<size_t>(phys) * H + h) * page + p) * W;
#pragma unroll
    for (int w = 0; w < kMaxWords; ++w)
      if (w < W) kw[w] = static_cast<uint32_t>(kr[w]);
  }

  const int ncp = stage1_k * (page / group);
  const int ncand = NP * ncp;
  const bool leader = (t % group) == 0;
  const int key_group = p / group;
  for (int r = 0; r < R; ++r) {
    int score = kMaskedScore;
    if (ok) {
      const int32_t* qr = q + ((static_cast<size_t>(b) * H + h) * R + r) * W;
      int mism = 0;
#pragma unroll
      for (int w = 0; w < kMaxWords; ++w)
        if (w < W) mism += __popc(static_cast<uint32_t>(qr[w]) ^ kw[w]);
      score = d - 2 * mism;
    }
    bool taken = false;
    const size_t out_row = ((static_cast<size_t>(b) * H + h) * R + r) * ncand;
    for (int s = 0; s < stage1_k; ++s) {
      int bv = taken ? INT_MIN : score;
      int bi = kpos;
      for (int off = group / 2; off > 0; off >>= 1) {
        const int ov = __shfl_xor_sync(0xffffffffu, bv, off, group);
        const int oi = __shfl_xor_sync(0xffffffffu, bi, off, group);
        if (better(ov, oi, bv, bi)) {
          bv = ov;
          bi = oi;
        }
      }
      if (bi == kpos) taken = true;  // the winner leaves the race
      if (active && leader) {
        const size_t o = out_row + j * ncp + key_group * stage1_k + s;
        vals[o] = bv;
        idx[o] = bi;
      }
    }
  }
}

}  // namespace

extern "C" int bacam_paged_topk_stage1(
    const void* q, const void* kp, const void* page_table, const void* kv_len,
    const void* q_pos, void* vals, void* idx, int B, int H, int R, int W,
    int P, int page, int NP, int d, int group, int stage1_k, int has_window,
    int window, void* stream) {
  const int pages_per_block = page >= kKeysPerBlock ? 1 : kKeysPerBlock / page;
  const int threads = ((pages_per_block * page + 31) / 32) * 32;
  const dim3 grid((NP + pages_per_block - 1) / pages_per_block, H, B);
  bacam_paged_topk_stage1_kernel<<<grid, threads, 0,
                                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(q), static_cast<const int32_t*>(kp),
      static_cast<const int32_t*>(page_table),
      static_cast<const int32_t*>(kv_len), static_cast<const int32_t*>(q_pos),
      static_cast<int32_t*>(vals), static_cast<int32_t*>(idx), H, R, W, P,
      page, NP, d, group, stage1_k, pages_per_block, has_window, window);
  return static_cast<int>(cudaGetLastError());
}
