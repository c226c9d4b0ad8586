// BA-CAM scoring + stage-1 top-k: the device body shared by the contiguous
// (csrc/bacam_topk.cu) and paged (csrc/bacam_decode.cu) kernels.
//
// Counterpart of the reference's kernels/bacam_topk.py::score_and_stage1,
// which both of its Pallas kernels call "so the tie-breaking and masking
// semantics can never diverge".  The two kernels here differ only in where
// a tile's key words come from (a `Keys` loader: contiguous rows of a
// cache, or pages through a page table) and in how they index rows.
//
// What it computes.  For one matrix (a batch row b, or a (slot, kv head))
// with R query rows and S logical keys in groups of `group`: the score of
// row r and key j is d - 2 * popcount(q ^ k); key j is valid for row r when
// lo_r <= j < hi_r, with hi_r = min(kv_len, S, q_pos_r + 1 when causal) and
// lo_r = q_pos_r - window + 1 when a window is set (else 0); an invalid
// score is MASKED_SCORE.  Per group the top stage1_k (value, index) pairs,
// ties to the lowest index, go out group-major, top-k-minor.  A fully
// masked group writes MASKED_SCORE with indices base + s, as the plain
// versions' stable top-k does.
//
// Design.
//  * A group of one row belongs to one thread (RPL rows of it), or at
//    decode rows to a team of LPG = 4 lanes that split its keys, so
//    selection needs no shuffle per (row, key) pair: a thread keeps the
//    running top stage1_k as packed integers p = 32 * score + (31 - j) (j
//    the key's place in its group), whose integer order is the (value,
//    -index) order, so a max and a min per slot insert a key (three
//    instructions at stage1_k <= 2); a team merges its lanes' two best in
//    two shuffle steps at the end.  A masked key packs kSentinel in place
//    of its score.  Neighbouring threads (teams) own neighbouring groups
//    of one row, so a warp's candidate stores are contiguous (8-byte
//    stores at stage1_k = 2).
//  * A block covers gt groups (a key tile of gt * group keys) by rl row
//    lanes.  A decode team reads its group's keys straight into registers
//    (a lane's span is one contiguous run, 16-byte loads where aligned; a
//    warp's eight teams read 1 KiB at W = 2), so decode needs no shared
//    memory and no barrier.  Otherwise the block reads its tile's key words
//    once, with 16-byte loads where the layout allows, and stores them in
//    shared memory as W planes of (key in group, group) with a row stride
//    of gt + 2 words, so a warp's stores and its reads hit distinct banks.
//    Each thread reads its rows' query words, positions and kv_len into
//    registers beside the key loads; key loads are predicated only on the
//    key lying inside the cache or the table, so none waits on kv_len (the
//    paged loader's page-table entry is the one dependent step).
//  * Before scoring, every (row, group) that its row's range [lo, hi) does
//    not reach writes MASKED_SCORE and base + s and is never scored: the
//    causal tiles of a prefill chunk and the keys past kv_len at decode.
//  * The source picks the block shape and the variant from the shapes
//    (`plan`): KMAX = 2 slots at stage1_k <= 2, else 32 (a generic path);
//    RPL = 4 rows a thread when a matrix has more than 8 rows (prefill
//    chunks), else LPG = 4 lanes a group (decode rows, group >= 4).
//
// Bound.  Popcount issues at 16 a clock per SM on cc 9.0, so at W words a
// (row, key) pair costs W popcounts besides about ten other instructions;
// a 128-row chunk over 1,024 keys (16.8 M pairs, about 13.6 M of them
// live) is about 7 us of popcount alone, above its 5.3 us byte bound
// (16.8 MB of candidates written).  A decode step is bounded by its launch.
//
// Bounds check (a debug build: kernels/build.py compiles the two sources
// with -DBACAM_STAGE1_BOUNDS when asked).  The host entry copies each
// tensor's byte extent into constant memory before the launch; every
// global load and store of the body, and every shared-memory store, is
// checked against its own tensor's extent (or the tile's), and an access
// outside it prints the tensor, the offset and the thread, then traps.
// The entry synchronizes after the launch, so the error it returns is
// this launch's own.

#pragma once

#include <climits>
#include <cstdint>
#include <cstdio>
#include <type_traits>
#include <cuda_runtime.h>

namespace bacam_stage1 {

// The tensors a launch touches, for the bounds check.
enum Tensor { kQ, kKeys, kTable, kQpos, kKvlen, kVals, kIdx, kNumTensors };

#ifdef BACAM_STAGE1_BOUNDS
struct Extent {
  const void* base;
  unsigned long long bytes;
};
__constant__ Extent kExtents[kNumTensors];

__device__ __noinline__ void out_of_bounds(int tensor, long long off,
                                           int bytes, int line) {
  printf("bacam stage-1 bounds check, line %d: %d bytes at offset %lld of "
         "tensor %d (-1: the shared tile; extent %llu bytes), block (%d, %d, "
         "%d) thread %d\n",
         line, bytes, off, tensor,
         tensor >= 0 ? kExtents[tensor].bytes : 0ull, blockIdx.x,
         blockIdx.y, blockIdx.z, threadIdx.x);
  __trap();
}

__device__ __forceinline__ void in_bounds(int tensor, const void* p,
                                          int bytes, int line) {
  const long long off = static_cast<const char*>(p) -
                        static_cast<const char*>(kExtents[tensor].base);
  if (off < 0 || off + bytes > static_cast<long long>(kExtents[tensor].bytes))
    out_of_bounds(tensor, off, bytes, line);
}

// Copies the extents (indexed by Tensor) for the next launch on `s`.
inline int set_extents(const Extent (&e)[kNumTensors], cudaStream_t s) {
  return static_cast<int>(cudaMemcpyToSymbolAsync(
      kExtents, e, sizeof(e), 0, cudaMemcpyHostToDevice, s));
}
#define S1_CHECK(tensor, p, bytes) \
  ::bacam_stage1::in_bounds((tensor), (p), (bytes), __LINE__)
#define S1_CHECK_SMEM(i, n)                                              \
  do {                                                                   \
    if ((i) < 0 || (i) >= (n))                                           \
      ::bacam_stage1::out_of_bounds(-1, (i), 4, __LINE__);               \
  } while (0)
#else
#define S1_CHECK(tensor, p, bytes) ((void)0)
#define S1_CHECK_SMEM(i, n) ((void)0)
#endif

// The error of one launch: with the bounds check, the launch is waited for
// so that a trap reports here, on its own launch.
inline int finish_launch(int err, cudaStream_t s) {
#ifdef BACAM_STAGE1_BOUNDS
  if (!err) err = static_cast<int>(cudaStreamSynchronize(s));
#else
  (void)s;
#endif
  return err;
}

constexpr int kMaskedScore = -(1 << 30);
constexpr int kSentinel = -(1 << 20);  // a masked score inside the packing
constexpr int kMaxThreads = 256;
constexpr int kMaxTileGroups = 32;  // gt

struct Params {
  int R, S, ngroups, d, group, gshift, stage1_k, causal, has_window, window;
  int gt, gtshift, rl, row_tiles;
};

// The block shape and the variant: KMAX slots a thread, RPL rows a thread
// and LPG lanes a group.
struct Plan {
  Params p;
  int kmax, rpl, lpg, threads, key_tiles;
  size_t smem;
};

inline int log2i(int x) {
  int s = 0;
  while ((1 << s) < x) ++s;
  return s;
}

inline Plan plan(int R, int S, int ngroups, int W, int group, int stage1_k,
                 int causal, int has_window, int window) {
  Plan pl;
  pl.kmax = stage1_k <= 2 ? 2 : 32;
  pl.rpl = (pl.kmax == 2 && R > 8) ? 4 : 1;
  pl.lpg = (pl.kmax == 2 && pl.rpl == 1 && group >= 4) ? 4 : 1;
  int gt = 1;
  while (gt < ngroups && gt < kMaxTileGroups) gt *= 2;
  const int lanes = (R + pl.rpl - 1) / pl.rpl;
  int rl = 1;
  while (rl < lanes && gt * pl.lpg * rl < kMaxThreads) rl *= 2;
  pl.threads = gt * pl.lpg * rl;
  pl.key_tiles = (ngroups + gt - 1) / gt;
  // decode teams read keys into registers; the rest tile shared memory
  pl.smem = pl.lpg > 1 ? 0
                       : static_cast<size_t>(W) * group * (gt + 2) *
                             sizeof(uint32_t);
  pl.p = Params{R, S, ngroups, 32 * W, group, log2i(group), stage1_k,
                causal, has_window, window, gt, log2i(gt), rl,
                (R + rl * pl.rpl - 1) / (rl * pl.rpl)};
  return pl;
}

// Calls launch(W, KMAX, RPL, LPG) with the four as integral constants.
template <int W, class Launch>
int by_variant(const Plan& pl, Launch&& launch) {
  using std::integral_constant;
  using Wc = integral_constant<int, W>;
  using One = integral_constant<int, 1>;
  using Two = integral_constant<int, 2>;
  using Four = integral_constant<int, 4>;
  if (pl.kmax == 32)
    return launch(Wc{}, integral_constant<int, 32>{}, One{}, One{});
  if (pl.rpl == 4) return launch(Wc{}, Two{}, Four{}, One{});
  if (pl.lpg == 4) return launch(Wc{}, Two{}, One{}, Four{});
  return launch(Wc{}, Two{}, One{}, One{});
}

template <class Launch>
int dispatch(int W, const Plan& pl, Launch&& launch) {
  switch (W) {
    case 1: return by_variant<1>(pl, launch);
    case 2: return by_variant<2>(pl, launch);
    case 3: return by_variant<3>(pl, launch);
    case 4: return by_variant<4>(pl, launch);
    case 5: return by_variant<5>(pl, launch);
    case 6: return by_variant<6>(pl, launch);
    case 7: return by_variant<7>(pl, launch);
    case 8: return by_variant<8>(pl, launch);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <int KMAX>
__device__ __forceinline__ void insert(int (&top)[KMAX], int v, int k) {
  if (KMAX == 2) {
    const int lower = min(top[0], v);
    top[0] = max(top[0], v);
    top[1] = max(top[1], lower);
  } else {
#pragma unroll
    for (int s = 0; s < KMAX; ++s) {
      if (s >= k) break;
      const int hi = max(top[s], v);
      v = min(top[s], v);
      top[s] = hi;
    }
  }
}

template <int KMAX>
__device__ __forceinline__ void write_top(int32_t* vals, int32_t* idx,
                                          const int (&top)[KMAX], int g0,
                                          int k) {
  if (KMAX == 2 && k == 2) {
    int v[2], i[2];
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const int sc = top[s] >> 5;
      v[s] = sc == kSentinel ? kMaskedScore : sc;
      i[s] = g0 + 31 - (top[s] & 31);
    }
    S1_CHECK(kVals, vals, 8);
    S1_CHECK(kIdx, idx, 8);
    *reinterpret_cast<int2*>(vals) = make_int2(v[0], v[1]);
    *reinterpret_cast<int2*>(idx) = make_int2(i[0], i[1]);
    return;
  }
#pragma unroll
  for (int s = 0; s < KMAX; ++s) {
    if (s >= k) break;
    S1_CHECK(kVals, vals + s, 4);
    S1_CHECK(kIdx, idx + s, 4);
    const int sc = top[s] >> 5;
    vals[s] = sc == kSentinel ? kMaskedScore : sc;
    idx[s] = g0 + 31 - (top[s] & 31);
  }
}

__device__ __forceinline__ void write_masked(int32_t* vals, int32_t* idx,
                                             int g0, int k) {
  if (k == 2) {
    S1_CHECK(kVals, vals, 8);
    S1_CHECK(kIdx, idx, 8);
    *reinterpret_cast<int2*>(vals) = make_int2(kMaskedScore, kMaskedScore);
    *reinterpret_cast<int2*>(idx) = make_int2(g0, g0 + 1);
    return;
  }
  for (int s = 0; s < k; ++s) {
    S1_CHECK(kVals, vals + s, 4);
    S1_CHECK(kIdx, idx + s, 4);
    vals[s] = kMaskedScore;
    idx[s] = g0 + s;
  }
}

// The keys [lo, hi) a row at position qpos can see.
__device__ __forceinline__ void key_range(const Params& p, int kv_len,
                                          int qpos, int& lo, int& hi) {
  long long h = min(kv_len, p.S);
  if (p.causal) h = min(h, static_cast<long long>(qpos) + 1);
  const long long l =
      p.has_window ? static_cast<long long>(qpos) - p.window + 1 : 0;
  lo = static_cast<int>(min(max(l, 0LL), static_cast<long long>(p.S)));
  hi = static_cast<int>(max(h, 0LL));
}

// Scores keys against a thread's RPL rows and inserts them into its lists.
template <int W, int KMAX, int RPL>
struct Scorer {
  const uint32_t (&qw)[RPL][W];
  const int (&lo)[RPL];
  const int (&hi)[RPL];
  int d, k;

  // Key j of the group starting at key g0, its words at kw.
  __device__ __forceinline__ void key(int (&top)[RPL][KMAX],
                                      const uint32_t (&kw)[W], int g0,
                                      int j) const {
    const int packed = d * 32 + 31 - j;  // 32 * d + (31 - j)
#pragma unroll
    for (int i = 0; i < RPL; ++i) {
      int m = 0;
#pragma unroll
      for (int w = 0; w < W; ++w) m += __popc(qw[i][w] ^ kw[w]);
      int v = packed - 64 * m;  // 32 * (d - 2m) + (31 - j)
      if (g0 + j < lo[i] || g0 + j >= hi[i])
        v = kSentinel * 32 + 31 - j;
      insert<KMAX>(top[i], v, k);
    }
  }

  // Every key of group column g of a shared-memory tile.
  __device__ __forceinline__ void tile(int (&top)[RPL][KMAX],
                                       const uint32_t* ks, int gtp, int g,
                                       int g0, int group) const {
#pragma unroll 4
    for (int j = 0; j < group; ++j) {
      uint32_t kw[W];
#pragma unroll
      for (int w = 0; w < W; ++w) kw[w] = ks[(w * group + j) * gtp + g];
      key(top, kw, g0, j);
    }
  }
};

// One block: key tile `tile` (groups tile * gt ...) against row tile
// `row_tile` of one matrix.  q: its (R, W) query words; q_pos: its
// positions, one per row (stride 1) or one for all rows (stride 0);
// kv_len: its valid-key count; vals / idx: its (R, ngroups * stage1_k)
// outputs.  Keys: `words` logical key words; addr(i) the address of word
// i < words; vec when 16-byte loads of words 4c.. are aligned and never
// cross a page.
template <int W, int KMAX, int RPL, int LPG, class Keys>
__device__ __forceinline__ void stage1_block(
    const Keys& keys, const uint32_t* __restrict__ q,
    const int32_t* __restrict__ q_pos, int qpos_stride,
    const int32_t* __restrict__ kv_len, int32_t* __restrict__ vals,
    int32_t* __restrict__ idx, const Params& p, int tile, int row_tile) {
  extern __shared__ uint32_t ks[];  // W planes of (group, gt + 2) words
  const int t = threadIdx.x;
  const int nthreads = blockDim.x;
  const int li = t & (LPG - 1);  // the lane in its group's team
  const int g = (t / LPG) & (p.gt - 1);
  const int lane = (t / LPG) >> p.gtshift;
  const int grp = tile * p.gt + g;
  const int g0 = grp * p.group;  // the group's first key
  const bool has_out = grp < p.ngroups;
  const bool writer = li == 0;
  const int k = p.stage1_k;
  const size_t ncand = static_cast<size_t>(p.ngroups) * k;
  const int rbase = row_tile * p.rl * RPL + lane;

  // 1. rows, positions and kv_len: loads that wait on nothing
  S1_CHECK(kKvlen, kv_len, 4);
  const int kvl_raw = __ldg(kv_len);
  int qp[RPL];
  uint32_t qw[RPL][W];
#pragma unroll
  for (int i = 0; i < RPL; ++i) {
    const int r = min(rbase + i * p.rl, p.R - 1);
    S1_CHECK(kQpos, q_pos + r * qpos_stride, 4);
    qp[i] = __ldg(q_pos + r * qpos_stride);
#pragma unroll
    for (int w = 0; w < W; ++w) {
      S1_CHECK(kQ, q + static_cast<size_t>(r) * W + w, 4);
      qw[i][w] = __ldg(q + static_cast<size_t>(r) * W + w);
    }
  }

  // 2. the keys.  Decode rows (LPG > 1): each lane reads its span of the
  // group straight into registers (a team's 16 keys are one contiguous
  // run, a warp's eight runs 1 KiB at W = 2).  Otherwise the block reads
  // its tile into shared memory once for all its rows.
  const int span = p.group / LPG;
  const int j0 = li * span;
  constexpr int kLaneKeys = LPG > 1 ? kMaxTileGroups / LPG : 1;
  uint32_t lk[kLaneKeys][W];
  const int gtp = p.gt + 2;
  if (LPG > 1) {
    const int i0 = (g0 + j0) * W;
    const int nw = span * W;
    const uint32_t* src = i0 < keys.words ? keys.addr(i0) : nullptr;
    if (keys.vec && (i0 & 3) == 0 && (nw & 3) == 0 && i0 + nw <= keys.words) {
#pragma unroll
      for (int c = 0; c < kLaneKeys * W / 4; ++c) {
        if (4 * c < nw) {
          S1_CHECK(kKeys, src + 4 * c, 16);
          const uint4 v = __ldg(reinterpret_cast<const uint4*>(src + 4 * c));
          const uint32_t e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
          for (int x = 0; x < 4; ++x)
            lk[(4 * c + x) / W][(4 * c + x) % W] = e[x];
        }
      }
    } else {
#pragma unroll
      for (int x = 0; x < kLaneKeys * W; ++x) {
        if (x < nw && i0 + x < keys.words) S1_CHECK(kKeys, src + x, 4);
        lk[x / W][x % W] =
            x < nw && i0 + x < keys.words ? __ldg(src + x) : 0u;
      }
    }
  } else {
    const int tile_words = p.gt * p.group * W;
    const int start = tile * tile_words;
    auto put = [&](int i, uint32_t v) {  // word i of the tile
      const int kk = i / W;
      const int w = i - kk * W;
      const int at =
          (w * p.group + (kk & (p.group - 1))) * gtp + (kk >> p.gshift);
      S1_CHECK_SMEM(at, W * p.group * gtp);
      ks[at] = v;
    };
    if (keys.vec && (tile_words & 3) == 0) {
#pragma unroll 4
      for (int c = t; c < tile_words / 4; c += nthreads) {
        const int i = start + 4 * c;
        if (i < keys.words) S1_CHECK(kKeys, keys.addr(i), 16);
        const uint4 v =
            i < keys.words
                ? __ldg(reinterpret_cast<const uint4*>(keys.addr(i)))
                : make_uint4(0u, 0u, 0u, 0u);
        put(4 * c, v.x);
        put(4 * c + 1, v.y);
        put(4 * c + 2, v.z);
        put(4 * c + 3, v.w);
      }
    } else {
      for (int i = t; i < tile_words; i += nthreads) {
        if (start + i < keys.words) S1_CHECK(kKeys, keys.addr(start + i), 4);
        put(i, start + i < keys.words ? __ldg(keys.addr(start + i)) : 0u);
      }
    }
  }

  // 3. each row's key range [lo, hi); a group outside it is written now
  int lo[RPL], hi[RPL];
  bool todo[RPL];
  bool any = false;
#pragma unroll
  for (int i = 0; i < RPL; ++i) {
    const int r = rbase + i * p.rl;
    key_range(p, kvl_raw, qp[i], lo[i], hi[i]);
    todo[i] = false;
    if (r < p.R && has_out) {
      if (g0 + p.group <= lo[i] || g0 >= hi[i]) {
        const size_t o = static_cast<size_t>(r) * ncand +
                         static_cast<size_t>(grp) * k;
        if (writer) write_masked(vals + o, idx + o, g0, k);
      } else {
        todo[i] = true;
        any = true;
      }
    }
  }
  if (LPG == 1) __syncthreads();
  if (!any) return;  // the whole team returns together

  // 4. score the group's keys (the lane's span of them) for every row,
  // keeping the top k packed
  int top[RPL][KMAX];
#pragma unroll
  for (int i = 0; i < RPL; ++i)
#pragma unroll
    for (int s = 0; s < KMAX; ++s) top[i][s] = INT_MIN;
  const Scorer<W, KMAX, RPL> sc{qw, lo, hi, p.d, k};
  if (LPG > 1) {
#pragma unroll
    for (int jj = 0; jj < kLaneKeys; ++jj)
      if (jj < span) sc.key(top, lk[jj], g0, j0 + jj);
  } else {
    sc.tile(top, ks, gtp, g, g0, p.group);
  }
  if (LPG > 1) {  // KMAX == 2: merge two sorted pairs per step
    const unsigned team = ((1u << LPG) - 1) << ((t & 31) & ~(LPG - 1));
#pragma unroll
    for (int off = 1; off < LPG; off <<= 1) {
#pragma unroll
      for (int i = 0; i < RPL; ++i) {
        const int o0 = __shfl_xor_sync(team, top[i][0], off);
        const int o1 = __shfl_xor_sync(team, top[i][KMAX - 1], off);
        const int lower = min(top[i][0], o0);
        top[i][0] = max(top[i][0], o0);
        top[i][KMAX - 1] = max(max(top[i][KMAX - 1], o1), lower);
      }
    }
  }
  if (!writer) return;
#pragma unroll
  for (int i = 0; i < RPL; ++i) {
    if (!todo[i]) continue;
    const size_t o = static_cast<size_t>(rbase + i * p.rl) * ncand +
                     static_cast<size_t>(grp) * k;
    write_top<KMAX>(vals + o, idx + o, top[i], g0, k);
  }
}

}  // namespace bacam_stage1
