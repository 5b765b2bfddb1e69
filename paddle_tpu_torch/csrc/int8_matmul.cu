// Weight-only int8 matmul for Hopper (sm_90a): bf16 activations, int8
// weights with one f32 scale per output column, f32 accumulation.
//
// Replaces: paddle_tpu/ops/pallas/int8_matmul.py, int8_matmul (the Pallas
// `_kernel`, launched by the pallas_call at line 102).
//
// Computes out[m, n] = bf16( (sum_k x[m, k] * q[k, n]) * s[n] ) for
// x [M, K] bf16, q [K, N] int8 (N contiguous), s [N] f32.  Every int8 code
// is exact in bf16, so the product of bf16 x and the widened codes on the
// tensor cores, summed in f32, is the plain version's f32 sum in another
// order; the scale multiplies the f32 accumulator and the result is rounded
// once, as the TPU kernel does.
//
// What bounds it on the card: at decode (M = 8) bytes.  The weight is read
// once, K*N bytes (w_gate's 45 MB takes >= 13.5 us at 3.35 TB/s), against
// 2*M*K*N FLOPs: 16 FLOPs a byte, far below the ~295 where the bf16 tensor
// cores would be the limit.  At a prefill wave (M in the thousands) the
// FLOPs bound it.
//
// What the design does about it:
// * The int8 tile goes from device memory to registers as 16-byte loads
//   along N and is widened to bf16 on its way into shared memory: the bf16
//   copy of the weight never exists in device memory, which is the point of
//   the TPU kernel.
// * The products run on the tensor cores (nvcuda::wmma 16x16x16 bf16 -> f32)
//   from shared-memory tiles padded so that the fragment loads are free of
//   bank conflicts; the next K tile's loads are issued before the current
//   tile's products, so one tile's loads are in flight during the math.
// * Small M: a 16-row tile (at M = 8 half its rows are zero padding, a
//   waste the bytes bound absorbs).  N / 64 tiles alone do not fill 132 SMs
//   (N = 4096 gives 64 blocks), so the product is split over K: each block
//   of a split writes f32 partial sums, and a second, small kernel adds the
//   splits, scales and rounds once.  int8_matmul_splits picks the split so
//   that about four blocks run per SM.  The partial sums cost
//   2 * splits * M * N * 4 bytes, under 2% of the weight bytes at M = 8.
// * Large M: 64-row tiles, each warp a 32x32 quarter of the 64x64 tile.
// This first version uses one shared-memory buffer, register-staged loads
// and wmma; TMA, a multi-stage ring and wgmma are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;

constexpr int kThreads = 128;  // 4 warps
constexpr int kBN = 64;        // output columns per block
constexpr int kBK = 64;        // K depth of one shared-memory tile
constexpr int kAPad = 8;       // bf16 padding of an x row in shared memory
constexpr int kBPad = 8;       // bf16 padding of a widened weight row
constexpr int kCPad = 4;       // f32 padding of an accumulator row
constexpr int kMaxSplits = 16;

__host__ __device__ constexpr int ceil_div(int a, int b) { return (a + b - 1) / b; }

template <int BM>
struct __align__(32) Smem {
  __nv_bfloat16 a[BM][kBK + kAPad];   // x tile
  __nv_bfloat16 b[kBK][kBN + kBPad];  // weight tile, widened to bf16
  float c[BM][kBN + kCPad];           // accumulators for the epilogue
};

// The 16 int8 codes of one 16-byte chunk as 16 bf16 values (32 bytes).
__device__ __forceinline__ void widen16(const uint4& raw, uint4* dst) {
  const int8_t* v = reinterpret_cast<const int8_t*>(&raw);
  __nv_bfloat162 w[8];
#pragma unroll
  for (int e = 0; e < 8; ++e)
    w[e] = __floats2bfloat162_rn((float)v[2 * e], (float)v[2 * e + 1]);
  dst[0] = *reinterpret_cast<const uint4*>(&w[0]);
  dst[1] = *reinterpret_cast<const uint4*>(&w[4]);
}

// grid (ceil(N / kBN), ceil(M / BM), splits).  Split z covers the K tiles
// [z * per, min((z + 1) * per, ceil(K / kBK))).  With splits == 1 the block
// writes bf16 output; otherwise f32 partial sums into ws [splits, M, N].
template <int BM>
__global__ void __launch_bounds__(kThreads)
int8_matmul_kernel(const __nv_bfloat16* __restrict__ x,
                   const int8_t* __restrict__ q,
                   const float* __restrict__ scale,
                   __nv_bfloat16* __restrict__ out,
                   float* __restrict__ ws,
                   int M, int N, int K, int splits) {
  constexpr int WM = BM == 16 ? 16 : 32;   // rows of one warp's tile
  constexpr int WN = BM == 16 ? 16 : 32;   // columns of one warp's tile
  constexpr int WARPS_N = kBN / WN;
  static_assert((BM / WM) * WARPS_N == kThreads / 32, "4 warps per block");
  constexpr int FM = WM / 16, FN = WN / 16;
  constexpr int A_CHUNKS = BM * kBK / 8 / kThreads;      // 16-byte x chunks
  constexpr int B_CHUNKS = kBK * kBN / 16 / kThreads;    // 16-byte q chunks
  static_assert(A_CHUNKS >= 1 && B_CHUNKS >= 1, "tile too small");

  __shared__ Smem<BM> sm;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int n0 = blockIdx.x * kBN;
  const int m0 = blockIdx.y * BM;
  const int ktiles = ceil_div(K, kBK);
  const int per = ceil_div(ktiles, splits);
  const int t_begin = blockIdx.z * per;
  const int t_end = min(ktiles, t_begin + per);
  const bool vec_n = (N % 16) == 0;   // q rows start on 16-byte boundaries

  uint4 ra[A_CHUNKS];
  uint4 rb[B_CHUNKS];

  auto load = [&](int t) {
    const int k0 = t * kBK;
#pragma unroll
    for (int j = 0; j < A_CHUNKS; ++j) {
      const int i = tid + j * kThreads;
      const int r = i / (kBK / 8), c = i % (kBK / 8);
      const int m = m0 + r, k = k0 + c * 8;
      ra[j] = (m < M && k < K)
          ? *reinterpret_cast<const uint4*>(x + (size_t)m * K + k)
          : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int j = 0; j < B_CHUNKS; ++j) {
      const int i = tid + j * kThreads;
      const int r = i / (kBN / 16), c = i % (kBN / 16);
      const int k = k0 + r, n = n0 + c * 16;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (k < K) {
        const int8_t* src = q + (size_t)k * N + n;
        if (vec_n && n + 16 <= N) {
          v = *reinterpret_cast<const uint4*>(src);
        } else {   // ragged N: byte loads, masked at N
          int8_t* vb = reinterpret_cast<int8_t*>(&v);
          for (int e = 0; e < 16; ++e) vb[e] = n + e < N ? src[e] : 0;
        }
      }
      rb[j] = v;
    }
  };

  auto store = [&]() {
#pragma unroll
    for (int j = 0; j < A_CHUNKS; ++j) {
      const int i = tid + j * kThreads;
      const int r = i / (kBK / 8), c = i % (kBK / 8);
      *reinterpret_cast<uint4*>(&sm.a[r][c * 8]) = ra[j];
    }
#pragma unroll
    for (int j = 0; j < B_CHUNKS; ++j) {
      const int i = tid + j * kThreads;
      const int r = i / (kBN / 16), c = i % (kBN / 16);
      widen16(rb[j], reinterpret_cast<uint4*>(&sm.b[r][c * 16]));
    }
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[FM][FN];
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  const int wm = (warp / WARPS_N) * WM;
  const int wn = (warp % WARPS_N) * WN;
  if (t_begin < t_end) load(t_begin);
  for (int t = t_begin; t < t_end; ++t) {
    __syncthreads();   // the previous tile's products are done with sm
    store();
    __syncthreads();
    if (t + 1 < t_end) load(t + 1);   // in flight during the products
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> fa[FM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> fb[FN];
#pragma unroll
      for (int i = 0; i < FM; ++i)
        wmma::load_matrix_sync(fa[i], &sm.a[wm + i * 16][kk], kBK + kAPad);
#pragma unroll
      for (int j = 0; j < FN; ++j)
        wmma::load_matrix_sync(fb[j], &sm.b[kk][wn + j * 16], kBN + kBPad);
#pragma unroll
      for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int j = 0; j < FN; ++j)
          wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
  }

  // epilogue: accumulators through shared memory, so that each thread
  // writes consecutive columns and masks the ragged M and N edges
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j)
      wmma::store_matrix_sync(&sm.c[wm + i * 16][wn + j * 16], acc[i][j],
                              kBN + kCPad, wmma::mem_row_major);
  __syncthreads();
  for (int i = tid; i < BM * kBN; i += kThreads) {
    const int r = i / kBN, c = i % kBN;
    const int m = m0 + r, n = n0 + c;
    if (m >= M || n >= N) continue;
    if (splits == 1)
      out[(size_t)m * N + n] = __float2bfloat16(sm.c[r][c] * scale[n]);
    else
      ws[((size_t)blockIdx.z * M + m) * N + n] = sm.c[r][c];
  }
}

// out[m, n] = bf16( sum_z ws[z, m, n] * s[n] )
__global__ void __launch_bounds__(256)
int8_matmul_reduce(const float* __restrict__ ws,
                   const float* __restrict__ scale,
                   __nv_bfloat16* __restrict__ out, int M, int N,
                   int splits) {
  const size_t total = (size_t)M * N;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x) {
    float sum = 0.f;
    for (int z = 0; z < splits; ++z) sum += ws[(size_t)z * total + i];
    out[i] = __float2bfloat16(sum * scale[i % N]);
  }
}

template <int BM>
void launch(const void* x, const void* q, const void* s, void* out, void* ws,
            int M, int N, int K, int splits, cudaStream_t stream) {
  dim3 grid(ceil_div(N, kBN), ceil_div(M, BM), splits);
  int8_matmul_kernel<BM><<<grid, kThreads, 0, stream>>>(
      (const __nv_bfloat16*)x, (const int8_t*)q, (const float*)s,
      (__nv_bfloat16*)out, (float*)ws, M, N, K, splits);
}

}  // namespace

// How many K slices the product is split into: 1 when the output tiles
// alone give two blocks per SM, else enough for about four blocks per SM,
// at most one slice per K tile and kMaxSplits, with no empty slice.
extern "C" int int8_matmul_splits(int M, int N, int K, int sms) {
  const int bm = M <= 16 ? 16 : 64;
  const long long tiles = (long long)ceil_div(M, bm) * ceil_div(N, kBN);
  const int ktiles = ceil_div(K, kBK);
  if (tiles >= 2LL * sms || ktiles <= 1) return 1;
  long long want = (4LL * sms + tiles - 1) / tiles;
  int s = (int)(want < kMaxSplits ? want : kMaxSplits);
  if (s > ktiles) s = ktiles;
  const int per = ceil_div(ktiles, s);
  return ceil_div(ktiles, per);
}

// x [M, K] bf16, q [K, N] int8, s [N] f32 -> out [M, N] bf16; ws is f32
// [splits, M, N] scratch when splits > 1 (else unused).  All contiguous,
// x and q on 16-byte boundaries, K % 16 == 0 (the caller checks).
// Returns the launches' cudaError_t (0 on success).
extern "C" int int8_matmul_bf16(const void* x, const void* q, const void* s,
                                void* out, void* ws, int M, int N, int K,
                                int splits, void* stream) {
  if (M == 0 || N == 0) return (int)cudaSuccess;
  if (splits < 1 || splits > kMaxSplits || (splits > 1 && ws == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (M <= 16)
    launch<16>(x, q, s, out, ws, M, N, K, splits, st);
  else
    launch<64>(x, q, s, out, ws, M, N, K, splits, st);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  const long long total = (long long)M * N;
  const int blocks = (int)((total + 255) / 256 < 4096 ? (total + 255) / 256 : 4096);
  int8_matmul_reduce<<<blocks, 256, 0, st>>>((const float*)ws, (const float*)s,
                                             (__nv_bfloat16*)out, M, N, splits);
  return (int)cudaGetLastError();
}
