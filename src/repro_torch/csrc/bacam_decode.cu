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
// index.  Output order is page-major, group-major, top-k-minor: since a
// page tiles by the group, that is group-major over the logical keys.
//
// Design.  The shared body of csrc/bacam_stage1.cuh (its header states the
// design and the bound), over the page table: grid (key tiles, H * row
// tiles, B), one block per tile of up to 32 groups of logical keys (R = G
// GQA rows share one q_pos).  For each 16-byte chunk of the tile the
// loader reads the page-table entry, clamps it into the pool and reads the
// key words: the one dependent step, taken for all of a thread's chunks
// at once.  Entries past kv_len point at the trash page and are loaded like
// any other (no load waits on kv_len); their groups are written masked
// without being scored.  16-byte loads need page * W to be a multiple of
// four words (a chunk then never crosses a page); otherwise the loader
// reads a word at a time.  At the serving shapes (8 slots, 16 kv heads,
// one row, 16 pages of 64 keys) a block is 32 groups of 512 keys by teams
// of four lanes: 256 blocks of 128 threads, one wave.

#include "bacam_stage1.cuh"

namespace {

namespace s1 = bacam_stage1;

// The logical key words of (b, h): words NP * page * W; word i lies in
// logical page i / (page * W), at physical page table[that], clamped into
// the pool.  16-byte loads when the pool is 16-byte aligned and page * W
// is a multiple of four (a chunk then never crosses a page).  addr reads
// the table entry, so the body calls it only for i < words: the entry it
// reads then lies inside slot b's NP entries.
template <int W>
struct PagedKeys {
  const uint32_t* pool;  // (P, H, page, W)
  const int32_t* table;  // slot b's NP entries
  int H, h, page, P;
  int words;
  bool vec;
  __device__ __forceinline__ const uint32_t* addr(int i) const {
    const int kk = i / W;
    const int j = kk / page;
    S1_CHECK(s1::kTable, table + j, 4);
    const int phys = min(max(__ldg(table + j), 0), P - 1);
    return pool + ((static_cast<size_t>(phys) * H + h) * page +
                   (kk - j * page)) * W + (i - kk * W);
  }
};

template <int W, int KMAX, int RPL, int LPG>
__global__ void __launch_bounds__(s1::kMaxThreads)
bacam_paged_topk_stage1_kernel(
    const uint32_t* __restrict__ q,          // (B, H, R, W)
    const uint32_t* __restrict__ kp,         // (P, H, page, W)
    const int32_t* __restrict__ page_table,  // (B, NP)
    const int32_t* __restrict__ kv_len,      // (B,)
    const int32_t* __restrict__ q_pos,       // (B,)
    int32_t* __restrict__ vals,              // (B, H, R, ncand)
    int32_t* __restrict__ idx,               // (B, H, R, ncand)
    s1::Params p, int H, int P, int page, int NP) {
  const int b = blockIdx.z;
  const int h = blockIdx.y / p.row_tiles;
  const int row_tile = blockIdx.y - h * p.row_tiles;
  const PagedKeys<W> keys{kp, page_table + static_cast<size_t>(b) * NP, H,
                          h, page, P, NP * page * W,
                          (reinterpret_cast<uintptr_t>(kp) & 15) == 0 &&
                              ((page * W) & 3) == 0};
  const size_t m = static_cast<size_t>(b) * H + h;  // the matrix
  const size_t out = m * p.R * p.ngroups * p.stage1_k;
  s1::stage1_block<W, KMAX, RPL, LPG>(keys, q + m * p.R * W, q_pos + b, 0,
                                      kv_len + b, vals + out, idx + out, p,
                                      blockIdx.x, row_tile);
}

}  // namespace

extern "C" int bacam_paged_topk_stage1(
    const void* q, const void* kp, const void* page_table, const void* kv_len,
    const void* q_pos, void* vals, void* idx, int B, int H, int R, int W,
    int P, int page, int NP, int d, int group, int stage1_k, int has_window,
    int window, void* stream) {
  if (d != 32 * W || page % group)
    return static_cast<int>(cudaErrorInvalidValue);
  const int S = NP * page;
  const s1::Plan pl = s1::plan(R, S, S / group, W, group, stage1_k, 1,
                               has_window, window);
  const dim3 grid(pl.key_tiles, H * pl.p.row_tiles, B);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#ifdef BACAM_STAGE1_BOUNDS
  const unsigned long long out =
      4ull * B * H * R * pl.p.ngroups * stage1_k;
  const s1::Extent ext[s1::kNumTensors] = {
      {q, 4ull * B * H * R * W}, {kp, 4ull * P * H * page * W},
      {page_table, 4ull * B * NP}, {q_pos, 4ull * B}, {kv_len, 4ull * B},
      {vals, out}, {idx, out}};
  if (const int e = s1::set_extents(ext, s)) return e;
#endif
  const int err = s1::dispatch(W, pl, [&](auto w, auto kmax, auto rpl,
                                          auto lpg) {
    bacam_paged_topk_stage1_kernel<decltype(w)::value, decltype(kmax)::value,
                                   decltype(rpl)::value, decltype(lpg)::value>
        <<<grid, pl.threads, pl.smem, s>>>(
            static_cast<const uint32_t*>(q), static_cast<const uint32_t*>(kp),
            static_cast<const int32_t*>(page_table),
            static_cast<const int32_t*>(kv_len),
            static_cast<const int32_t*>(q_pos), static_cast<int32_t*>(vals),
            static_cast<int32_t*>(idx), pl.p, H, P, page, NP);
    return static_cast<int>(cudaGetLastError());
  });
  return s1::finish_launch(err, s);
}
