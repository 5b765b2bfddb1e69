// Fused RMSNorm -> matmul for Hopper (sm_90a): bf16 x and W, an f32 or
// bf16 norm weight, f32 accumulation, bf16 out.
//
// Replaces: paddle_tpu/ops/pallas/rmsnorm_matmul.py, `rmsnorm_matmul` (the
// Pallas `_kernel`, launched by the pallas_call at line 93).  Its backward
// is plain math in the JAX package and in the port.
//
// Computes, for x [M, H], the norm weight wl [H] and W [H, N]:
//   out[m, n] = bf16( (sum_k bf16(x[m, k] * wl[k]) * W[k, n]) * rstd[m] )
//   rstd[m]   = rsqrt(sum_k x[m, k]^2 / H + eps)          (f32)
// diag(rstd) commutes with the contraction, so the row scale is applied to
// the f32 accumulator in the epilogue, as the TPU kernel does, and the
// normalised activation [M, H] never goes to device memory: that is the
// kernel's whole point.
//
// What bounds it on the card: at the trainer's shapes (M = 16384, H = 2048,
// N = 2048 or 5504) the operations, 2 * M * H * N FLOPs on the bf16 tensor
// cores against (M * H + H * N + M * N) * 2 bytes; at decode (M = 8) the
// bytes of W.
//
// What the design does about it:
// * Each block owns a 64-row x tile and a 64-column W tile and walks H in
//   64-deep steps.  Every step loads the x tile once, as 16-byte vectors,
//   and from the same registers (a) adds each row's x^2 into f32 partial
//   sums and (b) writes bf16(x * wl) into shared memory for the product.
// * The products run on the tensor cores (nvcuda::wmma 16x16x16 bf16 ->
//   f32, four warps of 32x32), from shared-memory tiles padded against bank
//   conflicts; the next step's loads are issued before the current step's
//   products, as in int8_matmul.cu.
// * Epilogue: the eight threads that share a row reduce its partial sums by
//   shuffles, the accumulators pass through shared memory, and each output
//   element is scaled by its row's rstd and rounded once.
// * Any M and N (the ragged edges are masked), H a multiple of 16 (the
//   wrapper checks).  A simple first version: one shared-memory buffer,
//   register-staged loads and wmma; TMA, a multi-stage ring and wgmma are
//   later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include "vec_io.cuh"

namespace {

using namespace nvcuda;
using bf16 = __nv_bfloat16;

constexpr int kThreads = 128;  // 4 warps
constexpr int kBM = 64;        // rows of x per block
constexpr int kBN = 64;        // output columns per block
constexpr int kBK = 64;        // H depth of one shared-memory tile
constexpr int kPad = 8;        // bf16 padding of a tile row
constexpr int kCPad = 4;       // f32 padding of an accumulator row
constexpr int kWM = 32, kWN = 32;               // one warp's output tile
constexpr int kWarpsN = kBN / kWN;
constexpr int kFM = kWM / 16, kFN = kWN / 16;
constexpr int kChunksPerRow = kBK / 8;          // 16-byte chunks of a row
constexpr int kAChunks = kBM * kBK / 8 / kThreads;
constexpr int kBChunks = kBK * kBN / 8 / kThreads;
static_assert((kBM / kWM) * kWarpsN == kThreads / 32, "4 warps per block");
static_assert(kThreads % kChunksPerRow == 0, "threads tile the x rows");

__host__ __device__ constexpr int ceil_div(int a, int b) { return (a + b - 1) / b; }

struct __align__(32) Smem {
  bf16 a[kBM][kBK + kPad];     // bf16(x * wl) tile
  bf16 b[kBK][kBN + kPad];     // W tile
  float c[kBM][kBN + kCPad];   // accumulators for the epilogue
  float rstd[kBM];
};

template <typename TW>
__global__ void __launch_bounds__(kThreads)
rmsnorm_matmul_kernel(const bf16* __restrict__ x, const TW* __restrict__ wl,
                      const bf16* __restrict__ w, bf16* __restrict__ out,
                      int M, int N, int H, float eps) {
  __shared__ Smem sm;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int n0 = blockIdx.x * kBN;
  const int m0 = blockIdx.y * kBM;
  const int ktiles = ceil_div(H, kBK);
  const bool vec_n = (N % 8) == 0;   // W rows start on 16-byte boundaries

  uint4 ra[kAChunks];
  uint4 rb[kBChunks];
  // thread tid's x chunks all sit in column chunk tid % 8, rows
  // tid / 8 + 16 j: one partial sum of squares per row it touches
  float ssq[kAChunks];
#pragma unroll
  for (int j = 0; j < kAChunks; ++j) ssq[j] = 0.f;

  auto load = [&](int t) {
    const int k0 = t * kBK;
#pragma unroll
    for (int j = 0; j < kAChunks; ++j) {
      const int i = tid + j * kThreads;
      const int r = i / kChunksPerRow, c = i % kChunksPerRow;
      const int m = m0 + r, k = k0 + c * 8;
      ra[j] = (m < M && k < H)
          ? *reinterpret_cast<const uint4*>(x + (size_t)m * H + k)
          : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int j = 0; j < kBChunks; ++j) {
      const int i = tid + j * kThreads;
      const int r = i / (kBN / 8), c = i % (kBN / 8);
      const int k = k0 + r, n = n0 + c * 8;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (k < H) {
        const bf16* src = w + (size_t)k * N + n;
        if (vec_n && n + 8 <= N) {
          v = *reinterpret_cast<const uint4*>(src);
        } else {   // ragged N: element loads, masked at N
          bf16* vb = reinterpret_cast<bf16*>(&v);
          for (int e = 0; e < 8; ++e)
            vb[e] = n + e < N ? src[e] : __float2bfloat16_rn(0.f);
        }
      }
      rb[j] = v;
    }
  };

  auto store = [&](int t) {
    const int k0 = t * kBK;
#pragma unroll
    for (int j = 0; j < kAChunks; ++j) {
      const int i = tid + j * kThreads;
      const int r = i / kChunksPerRow, c = i % kChunksPerRow;
      const int k = k0 + c * 8;
      float xf[8], wf[8];
      vec_io::load<8>(reinterpret_cast<const bf16*>(&ra[j]), xf);
      if (k < H) {
        vec_io::load<8>(wl + k, wf);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) wf[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        ssq[j] += xf[e] * xf[e];
        xf[e] = xf[e] * wf[e];
      }
      vec_io::store<8>(&sm.a[r][c * 8], xf);
    }
#pragma unroll
    for (int j = 0; j < kBChunks; ++j) {
      const int i = tid + j * kThreads;
      const int r = i / (kBN / 8), c = i % (kBN / 8);
      *reinterpret_cast<uint4*>(&sm.b[r][c * 8]) = rb[j];
    }
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[kFM][kFN];
#pragma unroll
  for (int i = 0; i < kFM; ++i)
#pragma unroll
    for (int j = 0; j < kFN; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  const int wm = (warp / kWarpsN) * kWM;
  const int wn = (warp % kWarpsN) * kWN;
  if (ktiles > 0) load(0);
  for (int t = 0; t < ktiles; ++t) {
    __syncthreads();   // the previous tile's products are done with sm
    store(t);
    __syncthreads();
    if (t + 1 < ktiles) load(t + 1);   // in flight during the products
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>
          fa[kFM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>
          fb[kFN];
#pragma unroll
      for (int i = 0; i < kFM; ++i)
        wmma::load_matrix_sync(fa[i], &sm.a[wm + i * 16][kk], kBK + kPad);
#pragma unroll
      for (int j = 0; j < kFN; ++j)
        wmma::load_matrix_sync(fb[j], &sm.b[kk][wn + j * 16], kBN + kPad);
#pragma unroll
      for (int i = 0; i < kFM; ++i)
#pragma unroll
        for (int j = 0; j < kFN; ++j)
          wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
  }

  // each row's sum of squares: the 8 consecutive lanes of a row add theirs
#pragma unroll
  for (int j = 0; j < kAChunks; ++j) {
    float s = ssq[j];
    s += __shfl_xor_sync(0xffffffffu, s, 1);
    s += __shfl_xor_sync(0xffffffffu, s, 2);
    s += __shfl_xor_sync(0xffffffffu, s, 4);
    if (tid % kChunksPerRow == 0)
      sm.rstd[(tid + j * kThreads) / kChunksPerRow] =
          rsqrtf(s / (float)H + eps);
  }
#pragma unroll
  for (int i = 0; i < kFM; ++i)
#pragma unroll
    for (int j = 0; j < kFN; ++j)
      wmma::store_matrix_sync(&sm.c[wm + i * 16][wn + j * 16], acc[i][j],
                              kBN + kCPad, wmma::mem_row_major);
  __syncthreads();
  for (int i = tid; i < kBM * kBN; i += kThreads) {
    const int r = i / kBN, c = i % kBN;
    const int m = m0 + r, n = n0 + c;
    if (m < M && n < N)
      out[(size_t)m * N + n] = __float2bfloat16_rn(sm.c[r][c] * sm.rstd[r]);
  }
}

}  // namespace

// x [M, H] bf16, wl [H] (bf16 when wl_bf16 else f32), w [H, N] bf16 ->
// out [M, N] bf16.  All contiguous, x, wl and w on 16-byte boundaries,
// H % 16 == 0 (the wrapper checks).  Returns the launch's cudaError_t.
extern "C" int rmsnorm_matmul_bf16(const void* x, const void* wl,
                                   const void* w, void* out, int M, int N,
                                   int H, float eps, int wl_bf16,
                                   void* stream) {
  if (M == 0 || N == 0) return (int)cudaSuccess;
  if (H % 16) return (int)cudaErrorInvalidValue;
  const dim3 grid(ceil_div(N, kBN), ceil_div(M, kBM));
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (wl_bf16)
    rmsnorm_matmul_kernel<bf16><<<grid, kThreads, 0, st>>>(
        (const bf16*)x, (const bf16*)wl, (const bf16*)w, (bf16*)out, M, N,
        H, eps);
  else
    rmsnorm_matmul_kernel<float><<<grid, kThreads, 0, st>>>(
        (const bf16*)x, (const float*)wl, (const bf16*)w, (bf16*)out, M, N,
        H, eps);
  return (int)cudaGetLastError();
}
