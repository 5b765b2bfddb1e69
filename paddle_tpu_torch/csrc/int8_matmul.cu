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
// once, as the TPU kernel does.  The bf16 copy of the weight never exists
// in device memory, which is the point of the TPU kernel: each int8 tile is
// widened on its way into shared memory.
//
// Two paths, chosen by the wrapper from M (ops/int8_matmul.py):
//
// Decode (a batch of a few rows; the wrapper's crossover, WAVE_MIN_M).
// Bytes bound it: the weight is read once, K*N bytes (w_gate's 45 MB takes
// >= 13.5 us at 3.35 TB/s), against 2*M*K*N FLOPs, 16 FLOPs a byte at M =
// 8, far below the ~295 where the bf16 tensor cores would be the limit.
// * A block owns 16 rows x 64 columns (at M = 8 half its rows are zero
//   padding, a waste the bytes bound absorbs).  The int8 tile goes from
//   device memory to registers as 16-byte loads along N and is widened to
//   bf16 on its way into a shared-memory tile; 16x16x16 wmma products
//   (bf16 -> f32) from tiles padded against bank conflicts; the next K
//   tile's loads are issued before the current tile's products.
// * N / 64 tiles alone do not fill 132 SMs (N = 4096 gives 64 blocks), so
//   the product is split over K: each block of a split writes f32 partial
//   sums, and a second, small kernel adds the splits, scales and rounds
//   once.  int8_matmul_splits picks the split so that about four blocks
//   run per SM.  The partial sums cost 2 * splits * M * N * 4 bytes, under
//   2% of the weight bytes at M = 8.
//
// Wave (a packed prefill wave: M in the hundreds or thousands).  The
// operations bound it (2*M*K*N FLOPs over 989 TFLOP/s bf16).  Wgmma has no
// int8 x bf16 form, and a B operand comes from shared memory only, so
// widening the weight there costs a 32 KB bf16 store, a fence and a
// barrier a stage.  The kernel computes the transposed product
// out^T = W^T x^T instead, so that the widened weight is the A operand,
// which wgmma takes from registers (the mixed-input form of CUTLASS's
// Hopper GEMMs), on hopper_sm90.cuh:
// * A block of 384 threads owns 128 output columns x 256 rows of x (128
//   or 64 rows for a wave of at most that many): a producer warpgroup and
//   two consumer warpgroups of 64 columns, each accumulating out^T
//   [64, 256] in f32 registers with wgmma m64n256k16 (n128, n64), A (W^T)
//   from registers, B (x, K-major) from shared memory.  The grid
//   walks M fastest, so a wave of blocks shares a few column tiles of the
//   weight and the whole x stays in L2.
// * A four-stage TMA ring walks K in 64-deep steps: each stage holds x's
//   [256, 64] (or [128, 64], [64, 64]) box and the int8 codes' [64, 128] box, both in the 128-byte
//   swizzle (int8 needs N % 16 == 0 for its row stride).  Each consumer
//   warp reads its 16 columns of the codes with a transposing ldmatrix
//   on pairs of codes (16-bit elements), which leaves a thread the codes of
//   columns 2 g, 2 g + 1 at rows 2 t, 2 t + 1: exactly the A fragment when
//   the fragment's rows g and g + 8 stand for columns 2 g and 2 g + 1.
//   hopper::widen_s8x4 (byte permutes and a subtract, no conversion
//   instruction) turns them into the bf16 fragment registers; stages
//   alternate between two fragment sets, so the next stage's fragments are
//   built while this stage's products run, as in K11.  The epilogue undoes
//   the column order: each thread holds two neighbouring output columns.
// * Small waves do not fill the card (a tile gives 32 blocks at M = 256,
//   N = 4096), so the product is split over K as at decode, with the same
//   f32 partial sums and reduce pass.
// * Ragged shapes: TMA zero-fills rows past M and K and columns past N
//   (zeros add nothing); the epilogue stores masked at M and N.  When N %
//   16 != 0 the weight's rows are no multiple of 16 bytes and no tensor map
//   describes them: the same kernel's other instance has the producer
//   warpgroup read the codes with plain 8-byte loads (bytes when N % 8 !=
//   0), masked at K and N, into the same swizzled layout.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include "hopper_sm90.cuh"

namespace {

using namespace nvcuda;
using bf16 = __nv_bfloat16;

constexpr int kMaxSplits = 16;

__host__ __device__ constexpr int ceil_div(int a, int b) { return (a + b - 1) / b; }

// ---------------------------------------------------------------------------
// decode: 16 x 64 tiles, wmma, 128 threads
// ---------------------------------------------------------------------------
namespace decode {
constexpr int kThreads = 128;  // 4 warps, each a 16 x 16 quarter of the tile
constexpr int kBM = 16;        // rows per block
constexpr int kBN = 64;        // output columns per block
constexpr int kBK = 64;        // K depth of one shared-memory tile
constexpr int kAPad = 8;       // bf16 padding of an x row in shared memory
constexpr int kBPad = 8;       // bf16 padding of a widened weight row
constexpr int kCPad = 4;       // f32 padding of an accumulator row

struct __align__(32) Smem {
  bf16 a[kBM][kBK + kAPad];   // x tile
  bf16 b[kBK][kBN + kBPad];   // weight tile, widened to bf16
  float c[kBM][kBN + kCPad];  // accumulators for the epilogue
};
}  // namespace decode

// The 16 int8 codes of one 16-byte chunk as 16 bf16 values (32 bytes).
__device__ __forceinline__ void widen16(const uint4& raw, uint4* dst) {
  uint4 lo, hi;
  hopper::widen_s8x4(raw.x, lo.x, lo.y);
  hopper::widen_s8x4(raw.y, lo.z, lo.w);
  hopper::widen_s8x4(raw.z, hi.x, hi.y);
  hopper::widen_s8x4(raw.w, hi.z, hi.w);
  dst[0] = lo;
  dst[1] = hi;
}

// grid (ceil(N / kBN), ceil(M / kBM), splits).  Split z covers the K tiles
// [z * per, min((z + 1) * per, ceil(K / kBK))).  With splits == 1 the block
// writes bf16 output; otherwise f32 partial sums into ws [splits, M, N].
__global__ void __launch_bounds__(decode::kThreads)
int8_matmul_kernel(const bf16* __restrict__ x, const int8_t* __restrict__ q,
                   const float* __restrict__ scale, bf16* __restrict__ out,
                   float* __restrict__ ws, int M, int N, int K, int splits) {
  using namespace decode;
  constexpr int A_CHUNKS = kBM * kBK / 8 / kThreads;      // 16-byte x chunks
  constexpr int B_CHUNKS = kBK * kBN / 16 / kThreads;     // 16-byte q chunks
  static_assert(A_CHUNKS >= 1 && B_CHUNKS >= 1, "tile too small");

  __shared__ Smem sm;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int n0 = blockIdx.x * kBN;
  const int m0 = blockIdx.y * kBM;
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

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
  wmma::fill_fragment(acc, 0.f);

  const int wn = warp * 16;
  if (t_begin < t_end) load(t_begin);
  for (int t = t_begin; t < t_end; ++t) {
    __syncthreads();   // the previous tile's products are done with sm
    store();
    __syncthreads();
    if (t + 1 < t_end) load(t + 1);   // in flight during the products
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
      wmma::load_matrix_sync(fa, &sm.a[0][kk], kBK + kAPad);
      wmma::load_matrix_sync(fb, &sm.b[kk][wn], kBN + kBPad);
      wmma::mma_sync(acc, fa, fb, acc);
    }
  }

  // epilogue: accumulators through shared memory, so that each thread
  // writes consecutive columns and masks the ragged M and N edges
  wmma::store_matrix_sync(&sm.c[0][wn], acc, kBN + kCPad, wmma::mem_row_major);
  __syncthreads();
  for (int i = tid; i < kBM * kBN; i += kThreads) {
    const int r = i / kBN, c = i % kBN;
    const int m = m0 + r, n = n0 + c;
    if (m >= M || n >= N) continue;
    if (splits == 1)
      out[(size_t)m * N + n] = __float2bfloat16(sm.c[r][c] * scale[n]);
    else
      ws[((size_t)blockIdx.z * M + m) * N + n] = sm.c[r][c];
  }
}

// ---------------------------------------------------------------------------
// wave: the transposed product out^T = W^T x^T on 128 x 256 (n x m) tiles,
// a TMA ring feeding wgmma with the widened W^T as register A operand,
// 384 threads
// ---------------------------------------------------------------------------
namespace wave {
constexpr int kBN = 128;        // output columns (n) per block, 64 per consumer
constexpr int kBK = 64;         // K depth of one stage
constexpr int kStages = 4;
constexpr int kThreads = 384;   // producer warpgroup + two consumers
constexpr int kWTile = kBK * kBN;         // int8 codes of a stage's W box
// BM rows of x (m) per block: 256, or 128 / 64 for the waves that fill no
// more (the wgmma's N), so a small wave does not pay for 256 rows
__host__ __device__ constexpr int rows_for(int M) {
  return M > 128 ? 256 : M > 64 ? 128 : 64;
}
template <int BM> __host__ __device__ constexpr int smem_bytes() {
  return kStages * (BM * kBK * 2 + kWTile) + 2 * kStages * 8 + 1024;
}

// acc += a x^T over one 16-deep step: m64nBMk16, A from registers, the x
// tile the K-major B operand
template <int BM>
__device__ __forceinline__ void mma(float (&acc)[BM / 2], const uint32_t (&a)[4],
                                    uint64_t db) {
  if constexpr (BM == 256)
    hopper::wgmma_m64n256k16_rs<0>(acc, a, db, 1);
  else if constexpr (BM == 128)
    hopper::wgmma_m64n128k16_rs<0>(acc, a, db, 1);
  else
    hopper::wgmma_m64n64k16_rs<0>(acc, a, db, 1);
}
}  // namespace wave

// grid (ceil(M / BM), ceil(N / kBN), splits); split z covers the K tiles
// [z * per, min((z + 1) * per, ceil(K / kBK))) and writes f32 partial sums
// into ws [splits, M, N] when splits > 1, else the scaled bf16 output.
// kTmaW: the int8 weight arrives by TMA (N % 16 == 0); else the producer
// warpgroup reads it with plain loads into the same swizzled layout.
template <int BM, bool kTmaW>
__global__ void __launch_bounds__(wave::kThreads, 1)
int8_wave_kernel(const __grid_constant__ CUtensorMap tm_x,
                 const __grid_constant__ CUtensorMap tm_q,
                 const int8_t* __restrict__ q, const float* __restrict__ scale,
                 bf16* __restrict__ out, float* __restrict__ ws, int M, int N,
                 int K, int splits) {
  using namespace hopper;
  using namespace wave;
  constexpr int kXTile = BM * kBK;         // bf16 elements of a stage's x box
  constexpr uint32_t kTx = kXTile * 2 + (kTmaW ? kWTile : 0);
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * kBN;
  const int ktiles = ceil_div(K, kBK);
  const int per = ceil_div(ktiles, splits);
  const int kt0 = blockIdx.z * per;
  const int nk = max(0, min(ktiles, kt0 + per) - kt0);

  extern __shared__ unsigned char smem_raw[];
  bf16* Xs = reinterpret_cast<bf16*>(align_1k(smem_raw));
  uint8_t* Ws = reinterpret_cast<uint8_t*>(Xs + kStages * kXTile);
  uint64_t* full = reinterpret_cast<uint64_t*>(Ws + kStages * kWTile);
  uint64_t* empty = full + kStages;

  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      // the TMA issuer's arrival, and each producer thread's in the
      // plain-load instance
      mbar_init(full + s, kTmaW ? 1 : 1 + 128);
      mbar_init(empty + s, 8);   // one arrival per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer
    setmaxnreg_dec<24>();   // 128 x (168 - 24) = 256 x (240 - 168)
    for (int i = 0; i < nk; ++i) {
      const int s = i % kStages;
      const uint32_t ph = ((i / kStages) & 1) ^ 1;
      const int k0 = (kt0 + i) * kBK;
      uint8_t* Wt = Ws + s * kWTile;
      if (kTmaW) {
        if (tid == 0) {
          mbar_wait(empty + s, ph);
          mbar_expect_tx(full + s, kTx);
          tma_load_2d(Xs + s * kXTile, &tm_x, full + s, k0, m0);
          tma_load_2d(Wt, &tm_q, full + s, n0, k0);
        }
      } else {
        mbar_wait(empty + s, ph);
        if (tid == 0) {
          mbar_expect_tx(full + s, kTx);
          tma_load_2d(Xs + s * kXTile, &tm_x, full + s, k0, m0);
        }
        // 8-code groups, 8-byte loads when the rows allow (N % 8 == 0),
        // masked at K and N; code (k, n) at row k, 16-byte chunk
        // n / 16 ^ (k % 8): the 128-byte swizzle TMA writes
        for (int e = tid; e < kWTile / 8; e += 128) {
          const int r = e / (kBN / 8), c8 = e % (kBN / 8);
          const int k = k0 + r, n = n0 + 8 * c8;
          uint2 v = make_uint2(0, 0);
          if (k < K) {
            const int8_t* src = q + (size_t)k * N + n;
            if ((N & 7) == 0 && n + 8 <= N) {
              v = *reinterpret_cast<const uint2*>(src);
            } else {
              int8_t* vb = reinterpret_cast<int8_t*>(&v);
              for (int j = 0; j < 8; ++j) vb[j] = n + j < N ? src[j] : 0;
            }
          }
          *reinterpret_cast<uint2*>(Wt + r * kBN + (((c8 / 2) ^ (r & 7)) * 16) +
                                    (c8 & 1) * 8) = v;
        }
        mbar_arrive(full + s);
      }
    }
  } else {
    // ---- consumers: warpgroup cw owns the output columns n0 + 64 cw ..
    // + 63 as the rows of out^T.  Warp w's A fragments come from the W
    // stage's 16 columns 64 cw + 16 w .. by transposing ldmatrix on pairs
    // of codes: lane / 4 = g picks the column pair (2 g, 2 g + 1), so the
    // fragment's rows g and g + 8 are columns 2 g and 2 g + 1.
    setmaxnreg_inc<240>();
    const int cw = wg - 1;
    const int warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, t = lane % 4;
    const int chunk = 4 * cw + warp;             // the warp's 16 columns

    float acc[BM / 2];
#pragma unroll
    for (int i = 0; i < BM / 2; ++i) acc[i] = 0.f;

    // stage i: its four A fragments (k steps of 16) widened into a, then
    // its products issued behind one fence (not waited for).  Stages
    // alternate between two fragment sets, so the next stage's fragments
    // are built while this stage's products still read theirs.
    auto stage = [&](int i, uint32_t (&a)[kBK / 16][4]) {
      const int s = i % kStages;
      mbar_wait(full + s, (i / kStages) & 1);
      const uint8_t* Wt = Ws + s * kWTile;
      const bf16* Xt = Xs + s * kXTile;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        // lanes 8j .. 8j + 7 address rows 32 h + 8 j .. of matrix j
        const int k = 32 * h + lane;
        uint32_t r[4];
        ldmatrix_x4_trans(r, Wt + k * kBN + ((chunk ^ (k & 7)) * 16));
        widen_s8x4<true>(r[0], a[2 * h][0], a[2 * h][1]);
        widen_s8x4<true>(r[1], a[2 * h][2], a[2 * h][3]);
        widen_s8x4<true>(r[2], a[2 * h + 1][0], a[2 * h + 1][1]);
        widen_s8x4<true>(r[3], a[2 * h + 1][2], a[2 * h + 1][3]);
      }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)
        mma<BM>(acc, a[kk], desc_sw128(Xt + kk * 16, 0, 1024));
      wgmma_commit();
    };
    auto release = [&](int i) {
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + i % kStages);
    };
    uint32_t a0[kBK / 16][4], a1[kBK / 16][4];
    for (int i = 0; i < nk; i += 2) {
      stage(i, a0);
      if (i > 0) {
        wgmma_wait<1>();   // stage i - 1 is done
        release(i - 1);
      }
      if (i + 1 < nk) {
        stage(i + 1, a1);
        wgmma_wait<1>();   // stage i is done
        release(i);
      }
    }
    wgmma_wait<0>();
    fence_regs(acc);
    if (nk > 0) release(nk - 1);

    // epilogue: acc[4 i + e] is out^T at row 2 g + (e >= 2) of the warp's
    // 16 columns and column 8 i + 2 t + (e & 1) of the block's rows of x:
    // each thread holds two neighbouring output columns of its rows
    const int n = n0 + 64 * cw + 16 * warp + 2 * g;
    if (n < N) {
      const bool two = n + 1 < N;
      const bool pairs = two && (N & 1) == 0;   // 4- / 8-byte boundaries
      float s0 = 1.f, s1 = 1.f;
      if (splits == 1) {
        s0 = scale[n];
        if (two) s1 = scale[n + 1];
      }
#pragma unroll
      for (int i = 0; i < BM / 8; ++i) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int m = m0 + 8 * i + 2 * t + e;
          if (m >= M) continue;
          const float v0 = acc[4 * i + e] * s0;
          const float v1 = acc[4 * i + 2 + e] * s1;
          if (splits == 1) {
            bf16* dst = out + (size_t)m * N + n;
            if (pairs) {
              *reinterpret_cast<uint32_t*>(dst) = pack_bf16(v0, v1);
            } else {
              dst[0] = __float2bfloat16_rn(v0);
              if (two) dst[1] = __float2bfloat16_rn(v1);
            }
          } else {
            float* dst = ws + ((size_t)blockIdx.z * M + m) * N + n;
            if (pairs) {
              *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
            } else {
              dst[0] = v0;
              if (two) dst[1] = v1;
            }
          }
        }
      }
    }
  }
}

// out[m, n] = bf16( sum_z ws[z, m, n] * s[n] )
__global__ void __launch_bounds__(256)
int8_matmul_reduce(const float* __restrict__ ws,
                   const float* __restrict__ scale,
                   bf16* __restrict__ out, int M, int N, int splits) {
  const size_t total = (size_t)M * N;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x) {
    float sum = 0.f;
    for (int z = 0; z < splits; ++z) sum += ws[(size_t)z * total + i];
    out[i] = __float2bfloat16(sum * scale[i % N]);
  }
}

template <int BM, bool kTmaW>
cudaError_t launch_wave(const CUtensorMap& mx, const CUtensorMap& mq,
                        const void* q, const void* s, void* out, void* ws,
                        int M, int N, int K, int splits, cudaStream_t stream) {
  static bool raised[hopper::kMaxDevices] = {};
  cudaError_t err = hopper::raise_smem(int8_wave_kernel<BM, kTmaW>,
                                       wave::smem_bytes<BM>(), raised);
  if (err != cudaSuccess) return err;
  const dim3 grid(ceil_div(M, BM), ceil_div(N, wave::kBN), splits);
  int8_wave_kernel<BM, kTmaW>
      <<<grid, wave::kThreads, wave::smem_bytes<BM>(), stream>>>(
      mx, mq, (const int8_t*)q, (const float*)s, (bf16*)out, (float*)ws, M, N,
      K, splits);
  return cudaGetLastError();
}

template <int BM>
cudaError_t run_wave(const void* x, const void* q, const void* s, void* out,
                     void* ws, int M, int N, int K, int splits,
                     cudaStream_t stream) {
  if (ceil_div(N, wave::kBN) > 65535) return cudaErrorInvalidValue;
  CUtensorMap mx, mq = {};
  const uint64_t x_dims[2] = {(uint64_t)K, (uint64_t)M};
  const uint64_t x_stride[1] = {(uint64_t)K * 2};
  const uint32_t x_box[2] = {wave::kBK, BM};
  cudaError_t err = hopper::make_map(&mx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                                     x, x_dims, x_stride, x_box, true);
  if (err != cudaSuccess) return err;
  if (N % 16 == 0) {
    const uint64_t q_dims[2] = {(uint64_t)N, (uint64_t)K};
    const uint64_t q_stride[1] = {(uint64_t)N};
    const uint32_t q_box[2] = {wave::kBN, wave::kBK};
    err = hopper::make_map(&mq, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, q, q_dims,
                           q_stride, q_box, true);
    if (err != cudaSuccess) return err;
    return launch_wave<BM, true>(mx, mq, q, s, out, ws, M, N, K, splits, stream);
  }
  return launch_wave<BM, false>(mx, mq, q, s, out, ws, M, N, K, splits, stream);
}

}  // namespace

// How many K slices the product is split into on the decode path (wave 0)
// or the wave path (wave 1): 1 when the output tiles alone fill the card
// (two 128-thread blocks per SM at decode, one 384-thread block per SM on
// the wave path), else enough for about four blocks per SM at decode and
// one per SM on the wave path, at most kMaxSplits, at decode one slice per
// K tile and on the wave path four K tiles a slice at least, with no empty
// slice.
extern "C" int int8_matmul_splits(int M, int N, int K, int sms, int wave_path) {
  const long long tiles =
      wave_path ? (long long)ceil_div(M, wave::rows_for(M)) * ceil_div(N, wave::kBN)
                : (long long)ceil_div(M, decode::kBM) * ceil_div(N, decode::kBN);
  const int ktiles = ceil_div(K, wave_path ? wave::kBK : decode::kBK);
  const long long fill = wave_path ? sms : 2LL * sms;
  const int max_s = wave_path ? ktiles / 4 : ktiles;
  if (tiles >= fill || max_s <= 1) return 1;
  const long long want = ((wave_path ? 1LL : 4LL) * sms + tiles - 1) / tiles;
  int s = (int)(want < kMaxSplits ? want : kMaxSplits);
  if (s > max_s) s = max_s;
  const int per = ceil_div(ktiles, s);
  return ceil_div(ktiles, per);
}

// x [M, K] bf16, q [K, N] int8, s [N] f32 -> out [M, N] bf16 by the decode
// path (wave 0) or the wave path (wave 1); ws is f32 [splits, M, N]
// scratch when splits > 1 (else unused).  All contiguous, x and q on
// 16-byte boundaries, K % 16 == 0 (the caller checks).  Returns the
// launches' cudaError_t (0 on success).
extern "C" int int8_matmul_bf16(const void* x, const void* q, const void* s,
                                void* out, void* ws, int M, int N, int K,
                                int splits, int wave_path, void* stream) {
  if (M == 0 || N == 0) return (int)cudaSuccess;
  if (splits < 1 || splits > kMaxSplits || (splits > 1 && ws == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err;
  if (wave_path) {
    const int bm = wave::rows_for(M);
    err = bm == 256 ? run_wave<256>(x, q, s, out, ws, M, N, K, splits, st)
        : bm == 128 ? run_wave<128>(x, q, s, out, ws, M, N, K, splits, st)
                    : run_wave<64>(x, q, s, out, ws, M, N, K, splits, st);
  } else {
    const dim3 grid(ceil_div(N, decode::kBN), ceil_div(M, decode::kBM), splits);
    int8_matmul_kernel<<<grid, decode::kThreads, 0, st>>>(
        (const bf16*)x, (const int8_t*)q, (const float*)s, (bf16*)out,
        (float*)ws, M, N, K, splits);
    err = cudaGetLastError();
  }
  if (err != cudaSuccess || splits == 1) return (int)err;
  const long long total = (long long)M * N;
  const int blocks = (int)((total + 255) / 256 < 4096 ? (total + 255) / 256 : 4096);
  int8_matmul_reduce<<<blocks, 256, 0, st>>>((const float*)ws, (const float*)s,
                                             (bf16*)out, M, N, splits);
  return (int)cudaGetLastError();
}
