// Bit-sliced binary-integer VMM: y = x . w^T, exact, on the int8 tensor cores.
//
// Replaces kernels/bitslice_vmm.py::bitslice_vmm of the reference package,
// which loops the BA-CAM matrix kernel (kernels/bacam_mvm.py) over the bit
// planes of w and combines the planes with shifts (paper Sec. II-B1).
//
// For every batch b, row r of x and row j of w it writes
//     out[b, r, j] = sum_c x[b, r, c] * w[b, j, c]      (int32, wrapping)
// where x is read as +1 where x > 0 and -1 elsewhere (as pack_bits reads
// it) and w as the two's-complement number in its low `bits` bits.  d is
// 32 * W with 1 <= W <= 8; R and N are any sizes (the kernel masks its own
// ragged edge; nothing is padded).
//
// Arithmetic.  w is sign-extended from `bits` bits and split into
// L = ceil(bits / 8) byte limbs, the low ones unsigned and the top one
// signed, so y = sum_i 2^(8i) * (x . limb_i).  Each x . limb_i is one
// exact s8 x s8 (top limb) or s8 x u8 (low limbs) tensor-core product with
// int32 accumulation (mma.sync m16n8k32); the limbs combine with shifts in
// uint32, which wraps as the reference's int32 sum does.  For bits <= 8
// that is one product.  The bit planes of the BA-CAM arithmetic stay in
// the plain version and in kernels/bitslice_vmm.py::plane_loop.
//
// Design.  The function is bounded by its int32 output: at (128, 896, 64)
// x (128, 896, 64) it writes 411 MB against 59 MB of inputs, about 123 us
// at 3.35 TB/s, while the int8 products (13.2 G operations) take about
// 7 us at 1,979 TOP/s.  One launch writes y once.  Grid (w tiles of 128,
// x tiles of 64, B); 4 warps, each computing 64 x 32 outputs.  The block
// converts its x tile (f32 -> s8) and w tile (int32 -> byte limb) while it
// copies them into shared memory (rows padded by 16 bytes, so fragment
// loads are conflict-free), multiplies, then stages the int32 tile in
// shared memory (over the operand tiles) and writes it row by row with
// 16-byte streaming stores, 512 contiguous bytes per warp instruction.
// Blocks are small (128 threads, at most 51 KB of shared memory), so
// several share an SM and one block's stores overlap the others' loads
// and products.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBM = 64;              // x rows per block
constexpr int kBN = 128;             // w rows per block
constexpr int kThreads = 128;        // 4 warps, each 64 x 32 outputs
constexpr int kOutStride = kBN + 8;  // staged int32 row stride (conflict-free)

__device__ __forceinline__ uint32_t pm1_bytes(float4 v) {
  // +1 -> 0x01, -1 -> 0xff, byte c from element c
  const uint32_t b0 = v.x > 0.f ? 0x01u : 0xffu;
  const uint32_t b1 = v.y > 0.f ? 0x01u : 0xffu;
  const uint32_t b2 = v.z > 0.f ? 0x01u : 0xffu;
  const uint32_t b3 = v.w > 0.f ? 0x01u : 0xffu;
  return b0 | (b1 << 8) | (b2 << 16) | (b3 << 24);
}

__device__ __forceinline__ uint32_t limb_byte(int v, int up, int shift) {
  // sign-extend from `bits` bits (up = 32 - bits), then take byte `shift`
  const int s = static_cast<int>(static_cast<uint32_t>(v) << up) >> up;
  return static_cast<uint32_t>(s >> shift) & 0xffu;
}

__device__ __forceinline__ uint32_t limb_bytes(int4 v, int up, int shift) {
  return limb_byte(v.x, up, shift) | (limb_byte(v.y, up, shift) << 8) |
         (limb_byte(v.z, up, shift) << 16) | (limb_byte(v.w, up, shift) << 24);
}

template <bool kSignedB>
__device__ __forceinline__ void mma_s8(int32_t (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  if constexpr (kSignedB) {
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  } else {
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.s8.u8.s32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
}

// acc += x_tile . limb_tile^T over d for the warp's 64 x 32 outputs
template <bool kSignedB>
__device__ __forceinline__ void tile_product(int32_t (&acc)[4][4][4],
                                             const uint32_t* xs,
                                             const uint32_t* ws, int d,
                                             int stride, int warp, int lane) {
  const int g = lane / 4;
  const int t = lane % 4;
  for (int kw = 0; kw < d / 4; kw += 8) {  // 32 bytes of d per step
    uint32_t a[4][4];
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
      const uint32_t* p = xs + (mt * 16 + g) * stride + kw + t;
      a[mt][0] = p[0];
      a[mt][1] = p[8 * stride];
      a[mt][2] = p[4];
      a[mt][3] = p[8 * stride + 4];
    }
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const uint32_t* p = ws + (warp * 32 + nt * 8 + g) * stride + kw + t;
      const uint32_t b0 = p[0];
      const uint32_t b1 = p[4];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) mma_s8<kSignedB>(acc[mt][nt], a[mt], b0, b1);
    }
  }
}

template <int L>
__global__ void __launch_bounds__(kThreads) bitslice_vmm_kernel(
    const float* __restrict__ x,    // (B, R, d), +-1
    const int32_t* __restrict__ w,  // (B, N, d)
    int32_t* __restrict__ out,      // (B, R, N)
    int R, int N, int d, int bits) {
  extern __shared__ int4 smem4[];
  const int stride = d / 4 + 4;  // words per operand row (d + 16 bytes)
  uint32_t* xs = reinterpret_cast<uint32_t*>(smem4);
  uint32_t* ws = xs + kBM * stride;
  int32_t* stage = reinterpret_cast<int32_t*>(smem4);  // after the products

  const int b = blockIdx.z;
  const int r0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int d4 = d / 4;

  const float4* xb = reinterpret_cast<const float4*>(
      x + (static_cast<size_t>(b) * R + r0) * d);
  for (int i = threadIdx.x; i < kBM * d4; i += kThreads) {
    const int row = i / d4;
    const int c = i % d4;
    xs[row * stride + c] = r0 + row < R ? pm1_bytes(xb[static_cast<size_t>(row) * d4 + c]) : 0u;
  }

  int32_t acc[4][4][4];
  const int4* wb = reinterpret_cast<const int4*>(
      w + (static_cast<size_t>(b) * N + n0) * d);
  const int up = 32 - bits;
#pragma unroll
  for (int li = 0; li < L; ++li) {
    if (li > 0) __syncthreads();  // every warp is done with the last limb
    for (int i = threadIdx.x; i < kBN * d4; i += kThreads) {
      const int row = i / d4;
      const int c = i % d4;
      ws[row * stride + c] =
          n0 + row < N ? limb_bytes(wb[static_cast<size_t>(row) * d4 + c], up, 8 * li) : 0u;
    }
    __syncthreads();
    int32_t part[4][4][4];
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[mt][nt][e] = 0;
    if (li == L - 1)
      tile_product<true>(part, xs, ws, d, stride, warp, lane);
    else
      tile_product<false>(part, xs, ws, d, stride, warp, lane);
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const uint32_t p = static_cast<uint32_t>(part[mt][nt][e]) << (8 * li);
          acc[mt][nt][e] = li == 0 ? static_cast<int32_t>(p)
                                   : static_cast<int32_t>(static_cast<uint32_t>(acc[mt][nt][e]) + p);
        }
  }

  // stage the 64 x 128 int32 tile over the operand tiles, then store it
  __syncthreads();
  const int g = lane / 4;
  const int t = lane % 4;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      int32_t* s = stage + (mt * 16 + g) * kOutStride + warp * 32 + nt * 8 + 2 * t;
      *reinterpret_cast<int2*>(s) = make_int2(acc[mt][nt][0], acc[mt][nt][1]);
      *reinterpret_cast<int2*>(s + 8 * kOutStride) =
          make_int2(acc[mt][nt][2], acc[mt][nt][3]);
    }
  __syncthreads();

  const int nrows = min(kBM, R - r0);
  const int ncols = min(kBN, N - n0);
  int32_t* ob = out + (static_cast<size_t>(b) * R + r0) * N + n0;
  if (ncols == kBN && N % 4 == 0) {  // 16-byte aligned full rows
    for (int i = threadIdx.x; i < nrows * (kBN / 4); i += kThreads) {
      const int row = i / (kBN / 4);
      const int c = i % (kBN / 4);
      __stcs(reinterpret_cast<int4*>(ob + static_cast<size_t>(row) * N) + c,
             *reinterpret_cast<const int4*>(stage + row * kOutStride + 4 * c));
    }
  } else {
    for (int i = threadIdx.x; i < nrows * kBN; i += kThreads) {
      const int row = i / kBN;
      const int c = i % kBN;
      if (c < ncols) __stcs(ob + static_cast<size_t>(row) * N + c, stage[row * kOutStride + c]);
    }
  }
}

template <int L>
int launch(const void* x, const void* w, void* out, int B, int R, int N,
           int d, int bits, cudaStream_t stream) {
  const int stride = d / 4 + 4;
  const size_t operands = sizeof(uint32_t) * static_cast<size_t>(kBM + kBN) * stride;
  const size_t staged = sizeof(int32_t) * static_cast<size_t>(kBM) * kOutStride;
  const size_t smem = operands > staged ? operands : staged;
  auto kern = bitslice_vmm_kernel<L>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((N + kBN - 1) / kBN, (R + kBM - 1) / kBM, B);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(x), static_cast<const int32_t*>(w),
      static_cast<int32_t*>(out), R, N, d, bits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int bitslice_vmm(const void* x, const void* w, void* out, int B,
                            int R, int N, int d, int bits, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d % 32 != 0 || d < 32 || d > 256 || bits < 1 || bits > 32)
    return static_cast<int>(cudaErrorInvalidValue);
  switch ((bits + 7) / 8) {
    case 1: return launch<1>(x, w, out, B, R, N, d, bits, s);
    case 2: return launch<2>(x, w, out, B, R, N, d, bits, s);
    case 3: return launch<3>(x, w, out, B, R, N, d, bits, s);
    default: return launch<4>(x, w, out, B, R, N, d, bits, s);
  }
}
