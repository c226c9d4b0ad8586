// Contiguous BA-CAM association: binary scoring + stage-1 top-k per group.
//
// Replaces the TPU kernel kernels/bacam_topk.py::bacam_topk_stage1 of the
// reference package (body kernels/bacam_topk.py::score_and_stage1).
//
// For each batch b (B = batch * H_kv) and query row r the kernel scores
// every key j of the contiguous packed cache as d - 2 * popcount(q ^ k),
// masks key j to MASKED_SCORE unless j < min(kv_len[b], S), and, when
// `causal` is set, j <= q_pos[b, r] (and j > q_pos[b, r] - window when a
// window is set), then keeps the top stage1_k (value, key index) pairs of
// each group of `group` keys, ties to the lowest index.  Output order is
// group-major, top-k-minor, over ceil(S / group) groups: the last group may
// reach past S, and its keys there are masked like any other.
//
// Design.  The paged decode kernel's (csrc/bacam_decode.cu), over a
// contiguous cache.  Grid (key tiles of 256, row tiles of 16, B); one thread
// per key.  A thread loads its key's W words into registers once; the
// block stages its rows' query words and positions in shared memory and
// scores them one after another (R is 1 * G at decode and G * chunk for a
// prefill chunk, so rows tile across blocks).  The `group` lanes of one key
// group pick the top stage1_k by shuffle reductions on (value, -index), so
// the lowest index wins a tie; the winner leaves the race and the reduction
// repeats.  Only the candidates reach device memory.
//
// Bound.  At a camformer-bert decode step (B * H_kv = 128, one row, 1024
// keys, d = 64) the kernel reads about 1 MiB of packed keys and writes
// 128 KiB of candidates: a fraction of a microsecond at 3.35 TB/s, so it is
// bounded by launch latency.  It is one launch per layer with no
// intermediate buffers.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaskedScore = -(1 << 30);
constexpr int kKeysPerBlock = 256;  // threads
constexpr int kRowsPerBlock = 16;

__device__ __forceinline__ bool better(int v1, int i1, int v2, int i2) {
  return v1 > v2 || (v1 == v2 && i1 < i2);
}

template <int W>
__global__ void __launch_bounds__(kKeysPerBlock) bacam_topk_stage1_kernel(
    const uint32_t* __restrict__ q,      // (B, R, W)
    const uint32_t* __restrict__ k,      // (B, S, W)
    const int32_t* __restrict__ q_pos,   // (B, R)
    const int32_t* __restrict__ kv_len,  // (B,)
    int32_t* __restrict__ vals,          // (B, R, ncand)
    int32_t* __restrict__ idx,           // (B, R, ncand)
    int R, int S, int d, int group, int stage1_k, int causal,
    int has_window, int window) {
  __shared__ uint32_t qs[kRowsPerBlock * W];
  __shared__ int qp[kRowsPerBlock];
  const int b = blockIdx.z;
  const int r0 = blockIdx.y * kRowsPerBlock;
  const int nrows = min(kRowsPerBlock, R - r0);
  const int t = threadIdx.x;
  const int kpos = blockIdx.x * kKeysPerBlock + t;  // key index of the thread
  const int ngroups = (S + group - 1) / group;
  const int ncand = ngroups * stage1_k;
  const bool in_out = kpos < ngroups * group;  // its group has an output
  const int kvl = min(kv_len[b], S);
  const bool live = kpos < kvl;

  const size_t brow = static_cast<size_t>(b) * R + r0;
  for (int i = t; i < nrows * W; i += kKeysPerBlock) qs[i] = q[brow * W + i];
  for (int i = t; i < nrows; i += kKeysPerBlock) qp[i] = q_pos[brow + i];
  uint32_t kw[W];
  if (live) {
    const uint32_t* kr = k + (static_cast<size_t>(b) * S + kpos) * W;
#pragma unroll
    for (int w = 0; w < W; ++w) kw[w] = kr[w];
  }
  __syncthreads();

  const bool leader = (t % group) == 0;
  const int key_group = kpos / group;
  for (int r = 0; r < nrows; ++r) {  // block-uniform: every lane shuffles
    const int qpos = qp[r];
    bool ok = live;
    if (causal) ok = ok && kpos <= qpos;
    if (has_window) ok = ok && kpos > qpos - window;
    int score = kMaskedScore;
    if (ok) {
      int mism = 0;
#pragma unroll
      for (int w = 0; w < W; ++w) mism += __popc(qs[r * W + w] ^ kw[w]);
      score = d - 2 * mism;
    }
    bool taken = false;
    const size_t out_row = (brow + r) * ncand;
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
      if (in_out && leader) {
        const size_t o = out_row + key_group * stage1_k + s;
        vals[o] = bv;
        idx[o] = bi;
      }
    }
  }
}

template <int W>
int launch(const void* q, const void* k, const void* q_pos,
           const void* kv_len, void* vals, void* idx, int B, int R, int S,
           int d, int group, int stage1_k, int causal, int has_window,
           int window, cudaStream_t stream) {
  const int keys = (S + group - 1) / group * group;
  const dim3 grid((keys + kKeysPerBlock - 1) / kKeysPerBlock,
                  (R + kRowsPerBlock - 1) / kRowsPerBlock, B);
  bacam_topk_stage1_kernel<W><<<grid, kKeysPerBlock, 0, stream>>>(
      static_cast<const uint32_t*>(q), static_cast<const uint32_t*>(k),
      static_cast<const int32_t*>(q_pos), static_cast<const int32_t*>(kv_len),
      static_cast<int32_t*>(vals), static_cast<int32_t*>(idx), R, S, d, group,
      stage1_k, causal, has_window, window);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int bacam_topk_stage1(
    const void* q, const void* k, const void* q_pos, const void* kv_len,
    void* vals, void* idx, int B, int R, int S, int W, int d, int group,
    int stage1_k, int causal, int has_window, int window, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define BACAM_TOPK_LAUNCH(w)                                                \
  return launch<w>(q, k, q_pos, kv_len, vals, idx, B, R, S, d, group,       \
                   stage1_k, causal, has_window, window, s)
  switch (W) {
    case 1: BACAM_TOPK_LAUNCH(1);
    case 2: BACAM_TOPK_LAUNCH(2);
    case 3: BACAM_TOPK_LAUNCH(3);
    case 4: BACAM_TOPK_LAUNCH(4);
    case 5: BACAM_TOPK_LAUNCH(5);
    case 6: BACAM_TOPK_LAUNCH(6);
    case 7: BACAM_TOPK_LAUNCH(7);
    case 8: BACAM_TOPK_LAUNCH(8);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef BACAM_TOPK_LAUNCH
}
