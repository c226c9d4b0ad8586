// BA-CAM binary matrix product: the full score matrix d - 2 * popcount(q ^ k).
//
// Replaces the TPU kernel kernels/bacam_mvm.py::bacam_mvm of the reference
// package (and, through a loop over bit planes, kernels/bitslice_vmm.py).
//
// For every batch b, query row r and key j it writes
//     out[b, r, j] = d - 2 * popcount(q[b, r, :] ^ k[b, j, :])
// over W = d / 32 packed 32-bit words (int32 tensors carrying uint32 bits).
// The result is bit-exact; there is no masking and no padding: the kernel
// masks its own ragged edge in rows and keys.
//
// Design.  Grid (key tiles of 128, row tiles of 32, B); one thread per key.
// A thread holds its key's W words in registers; the block stages its 32
// query rows in shared memory, where every lane reads the same word (a
// broadcast).  For each row the 128 threads write 128 consecutive int32
// scores, so every store of a warp is one 128-byte transaction.  W is a
// template argument (1..8) so the word loop unrolls.
//
// Bound.  The output dominates: at the contiguous prefill of camformer-bert
// (B * H_kv = 128, R = Skv = 896, W = 2) the kernel writes 411 MB of int32
// scores against 1.8 MB of packed operands, about 123 us at 3.35 TB/s.  The
// xor/popc/add work, 3 * W integer operations per score, is a fraction of
// that.  The design therefore spends nothing on data reuse beyond the
// register-held key and keeps every store coalesced.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;      // keys per block, one per thread
constexpr int kRowsPerBlock = 32;  // query rows per block

template <int W>
__global__ void __launch_bounds__(kThreads) bacam_mvm_kernel(
    const uint32_t* __restrict__ q,  // (B, R, W)
    const uint32_t* __restrict__ k,  // (B, S, W)
    int32_t* __restrict__ out,       // (B, R, S)
    int R, int S, int d) {
  __shared__ uint32_t qs[kRowsPerBlock * W];
  const int b = blockIdx.z;
  const int r0 = blockIdx.y * kRowsPerBlock;
  const int key = blockIdx.x * kThreads + threadIdx.x;
  const int nrows = min(kRowsPerBlock, R - r0);
  const uint32_t* qb = q + (static_cast<size_t>(b) * R + r0) * W;
  for (int i = threadIdx.x; i < nrows * W; i += kThreads) qs[i] = qb[i];

  uint32_t kw[W];
  if (key < S) {
    const uint32_t* kr = k + (static_cast<size_t>(b) * S + key) * W;
#pragma unroll
    for (int w = 0; w < W; ++w) kw[w] = kr[w];
  }
  __syncthreads();
  if (key >= S) return;

  int32_t* o = out + (static_cast<size_t>(b) * R + r0) * S + key;
  for (int r = 0; r < nrows; ++r) {
    int mism = 0;
#pragma unroll
    for (int w = 0; w < W; ++w) mism += __popc(qs[r * W + w] ^ kw[w]);
    o[static_cast<size_t>(r) * S] = d - 2 * mism;
  }
}

template <int W>
int launch(const void* q, const void* k, void* out, int B, int R, int S,
           int d, cudaStream_t stream) {
  const dim3 grid((S + kThreads - 1) / kThreads,
                  (R + kRowsPerBlock - 1) / kRowsPerBlock, B);
  bacam_mvm_kernel<W><<<grid, kThreads, 0, stream>>>(
      static_cast<const uint32_t*>(q), static_cast<const uint32_t*>(k),
      static_cast<int32_t*>(out), R, S, d);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int bacam_mvm(const void* q, const void* k, void* out, int B,
                         int R, int S, int W, int d, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (W) {
    case 1: return launch<1>(q, k, out, B, R, S, d, s);
    case 2: return launch<2>(q, k, out, B, R, S, d, s);
    case 3: return launch<3>(q, k, out, B, R, S, d, s);
    case 4: return launch<4>(q, k, out, B, R, S, d, s);
    case 5: return launch<5>(q, k, out, B, R, S, d, s);
    case 6: return launch<6>(q, k, out, B, R, S, d, s);
    case 7: return launch<7>(q, k, out, B, R, S, d, s);
    case 8: return launch<8>(q, k, out, B, R, S, d, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
