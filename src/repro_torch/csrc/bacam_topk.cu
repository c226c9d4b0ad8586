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
// Design.  The shared body of csrc/bacam_stage1.cuh (its header states the
// design and the bound), over a contiguous cache: grid (key tiles, row
// tiles, B), one block per tile of up to 32 groups.  The tile's key words
// are one contiguous run of batch b's keys, read with 16-byte loads when
// batch b's words start 16-byte aligned and S * W is a multiple of four,
// else a word at a time.  At a camformer-bert decode step (128 batches,
// one row, 1,024 keys) a block is 32 groups of 512 keys by teams of four
// lanes (256 blocks of 128 threads, one wave); at a 128-row prefill chunk
// it is 32 groups by 8 row lanes of 4 rows (1,024 blocks of 256 threads),
// and the (row, group) pairs past a row's causal end are written masked
// without being scored.

#include "bacam_stage1.cuh"

namespace {

namespace s1 = bacam_stage1;

// Batch b's key words: words S * W, 16-byte loads when its first word is
// 16-byte aligned and S * W is a multiple of four.
struct ContigKeys {
  const uint32_t* k;  // batch b's (S, W) words
  int words;
  bool vec;
  __device__ __forceinline__ const uint32_t* addr(int i) const {
    return k + i;
  }
};

template <int W, int KMAX, int RPL, int LPG>
__global__ void __launch_bounds__(s1::kMaxThreads) bacam_topk_stage1_kernel(
    const uint32_t* __restrict__ q,      // (B, R, W)
    const uint32_t* __restrict__ k,      // (B, S, W)
    const int32_t* __restrict__ q_pos,   // (B, R)
    const int32_t* __restrict__ kv_len,  // (B,)
    int32_t* __restrict__ vals,          // (B, R, ncand)
    int32_t* __restrict__ idx,           // (B, R, ncand)
    s1::Params p) {
  const int b = blockIdx.z;
  const int tile = blockIdx.x;
  const uint32_t* kb = k + static_cast<size_t>(b) * p.S * W;
  const ContigKeys keys{kb, p.S * W,
                        (reinterpret_cast<uintptr_t>(kb) & 15) == 0 &&
                            ((p.S * W) & 3) == 0};
  const size_t out = static_cast<size_t>(b) * p.R * p.ngroups * p.stage1_k;
  s1::stage1_block<W, KMAX, RPL, LPG>(
      keys, q + static_cast<size_t>(b) * p.R * W,
      q_pos + static_cast<size_t>(b) * p.R, 1, kv_len + b, vals + out,
      idx + out, p, tile, blockIdx.y);
}

}  // namespace

extern "C" int bacam_topk_stage1(
    const void* q, const void* k, const void* q_pos, const void* kv_len,
    void* vals, void* idx, int B, int R, int S, int W, int d, int group,
    int stage1_k, int causal, int has_window, int window, void* stream) {
  if (d != 32 * W) return static_cast<int>(cudaErrorInvalidValue);
  const int ngroups = (S + group - 1) / group;
  const s1::Plan pl = s1::plan(R, S, ngroups, W, group, stage1_k, causal,
                               has_window, window);
  const dim3 grid(pl.key_tiles, pl.p.row_tiles, B);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#ifdef BACAM_STAGE1_BOUNDS
  const unsigned long long out = 4ull * B * R * ngroups * stage1_k;
  const s1::Extent ext[s1::kNumTensors] = {
      {q, 4ull * B * R * W}, {k, 4ull * B * S * W}, {nullptr, 0},
      {q_pos, 4ull * B * R}, {kv_len, 4ull * B}, {vals, out}, {idx, out}};
  if (const int e = s1::set_extents(ext, s)) return e;
#endif
  const int err = s1::dispatch(W, pl, [&](auto w, auto kmax, auto rpl,
                                          auto lpg) {
    bacam_topk_stage1_kernel<decltype(w)::value, decltype(kmax)::value,
                             decltype(rpl)::value, decltype(lpg)::value>
        <<<grid, pl.threads, pl.smem, s>>>(
            static_cast<const uint32_t*>(q), static_cast<const uint32_t*>(k),
            static_cast<const int32_t*>(q_pos),
            static_cast<const int32_t*>(kv_len), static_cast<int32_t*>(vals),
            static_cast<int32_t*>(idx), pl.p);
    return static_cast<int>(cudaGetLastError());
  });
  return s1::finish_launch(err, s);
}
