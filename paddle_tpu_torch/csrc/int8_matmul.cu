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
// widened in registers on its way into the products.
//
// Two paths, chosen by the wrapper from M (ops/int8_matmul.py):
//
// Decode (M <= 16: a batch of a few rows; the wrapper's crossover,
// WAVE_MIN_M).  Bytes bound it: the weight is read once, K*N bytes (w_gate's
// 45 MB takes >= 13.5 us at 3.35 TB/s), against 2*M*K*N FLOPs, 16 FLOPs a
// byte at M = 8, far below the ~295 where the bf16 tensor cores would be
// the limit.  So the design keeps as many weight bytes in flight as the SMs
// can hold and spends nothing on the way from device memory to the
// products:
// * The transposed product out^T = W^T x^T, as on the wave path: the
//   widened int8 codes are the A operand, in registers (a transposing
//   ldmatrix on pairs of codes, then hopper::widen_s8x4), and x^T is the B
//   operand with the product's N = 8 (M <= 8) or 16 (M <= 16), so no zero
//   row is multiplied at M = 8 and no widened weight goes to shared memory.
//   A block owns 128 output columns: eight consumer warps of 16 columns,
//   each running mma.sync m16n8k16 on its own (wgmma m64n8k16 over two
//   warpgroups timed the same: bytes bind, not the product), B fragments
//   by plain ldmatrix from the x stage.
// * One producer warp keeps an eight-stage TMA ring full: each stage the
//   int8 codes' [64, 128] box (8 KB, 128-byte swizzle) and x's [64, MT]
//   box beside it (TMA zero-fills rows past M and K and columns past N).
//   Two blocks fit an SM, so up to 128 KB of weight is in flight an SM.
// * Work over the 132 SMs whatever N is: the wrapper's plan
//   (decode_splits) splits K so that the column tiles times the splits
//   make about two blocks an SM, in one wave.
// * The split's sum in the same launch: each block writes f32 partials,
//   and the last block to arrive at a column tile (an atomic count per
//   tile, in a scratch buffer the wrapper keeps zeroed per stream) adds the
//   partials in split order, scales and rounds once, and puts the count
//   back to 0.  Only the count is atomic, so the result is the same bits
//   on every run, and a CUDA-graph replay finds the count at 0.
// * N % 16 != 0: no tensor map describes the int8 rows, and the producer
//   warp reads them with plain loads into the same swizzled layout.
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
//   N = 4096), so the product is split over K into f32 partial sums, and a
//   second, small kernel (int8_matmul_reduce) adds the splits, scales and
//   rounds once.
// * Ragged shapes: TMA zero-fills rows past M and K and columns past N
//   (zeros add nothing); the epilogue stores masked at M and N.  When N %
//   16 != 0 the weight's rows are no multiple of 16 bytes and no tensor map
//   describes them: the same kernel's other instance has the producer
//   warpgroup read the codes with plain 8-byte loads (bytes when N % 8 !=
//   0), masked at K and N, into the same swizzled layout.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kMaxSplits = 16;

__host__ __device__ constexpr int ceil_div(int a, int b) { return (a + b - 1) / b; }

// ---------------------------------------------------------------------------
// decode: the transposed product on 128-column tiles, a TMA ring of int8
// weight boxes feeding mma.sync, the split's sum closed in the same launch
// ---------------------------------------------------------------------------
namespace decode {
constexpr int kBN = 128;                 // output columns (n) per block
constexpr int kBK = 64;                  // K depth of one stage
constexpr int kStages = 8;
constexpr int kConsumers = kBN / 16;     // warps of 16 columns each
constexpr int kThreads = 32 * (kConsumers + 1);   // + one producer warp
constexpr int kWTile = kBK * kBN;        // int8 codes of a stage's W box
// MT rows of x per stage (8 or 16): the product's N
template <int MT> __host__ __device__ constexpr int smem_bytes() {
  return kStages * (kWTile + MT * kBK * 2) + 2 * kStages * 8 + 1024;
}
}  // namespace decode

// grid (ceil(N / kBN), splits, ceil(M / MT)); split z covers the K steps
// [z * per, min((z + 1) * per, ceil(K / kBK))), and blockIdx.z the rows
// MT blockIdx.z .. + MT - 1 of x (one block of rows at decode; more only
// when a caller forces the path above WAVE_MIN_M).  splits == 1: the block
// scales and writes bf16 out.  Otherwise each block writes its f32 partial
// sums into ws [splits, M, N] and counts itself in its tile's arrival count
// (arrivals[blockIdx.z * gridDim.x + blockIdx.x]); the block that arrives
// last adds the splits' partials in split order, scales, rounds once and
// sets the count back to 0, so the next call on the stream finds it so.
// kTmaW: the int8 weight arrives by TMA (N % 16 == 0); else the producer
// warp reads it with plain loads into the same swizzled layout.
template <int MT, bool kTmaW>
__global__ void __launch_bounds__(decode::kThreads, 2)
int8_decode_kernel(const __grid_constant__ CUtensorMap tm_x,
                   const __grid_constant__ CUtensorMap tm_q,
                   const int8_t* __restrict__ q, const float* __restrict__ scale,
                   bf16* __restrict__ out, float* __restrict__ ws,
                   unsigned* __restrict__ arrivals, int M, int N, int K,
                   int splits) {
  using namespace hopper;
  using namespace decode;
  constexpr int kXTile = MT * kBK;       // bf16 elements of a stage's x box
  constexpr uint32_t kTx = kXTile * 2 + (kTmaW ? kWTile : 0);
  const int n0 = blockIdx.x * kBN;
  const int m0 = blockIdx.z * MT;
  const int ksteps = ceil_div(K, kBK);
  const int per = ceil_div(ksteps, splits);
  const int kt0 = blockIdx.y * per;
  const int nk = max(0, min(ksteps, kt0 + per) - kt0);

  extern __shared__ unsigned char smem_raw[];
  uint8_t* Ws = reinterpret_cast<uint8_t*>(align_1k(smem_raw));
  bf16* Xs = reinterpret_cast<bf16*>(Ws + kStages * kWTile);
  uint64_t* full = reinterpret_cast<uint64_t*>(Xs + kStages * kXTile);
  uint64_t* empty = full + kStages;
  __shared__ bool closes;   // this block arrived last at its tile

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // the producer warp's lane 0 sets up the ring and, when TMA brings the
  // weight, fills its first round before the block's barrier: the first
  // bytes are on their way while the other warps start
  const int first = kTmaW ? min(nk, kStages) : 0;
  if (warp == kConsumers && lane == 0) {
    prefetch_tensormap(&tm_x);
    if (kTmaW) prefetch_tensormap(&tm_q);
    for (int s = 0; s < kStages; ++s) {
      // the TMA issuer's arrival, and each producer lane's in the
      // plain-load instance
      mbar_init(full + s, kTmaW ? 1 : 1 + 32);
      mbar_init(empty + s, kConsumers);   // one arrival per consumer warp
    }
    mbar_fence_init();
    for (int i = 0; i < first; ++i) {
      const int k0 = (kt0 + i) * kBK;
      mbar_expect_tx(full + i, kTx);
      tma_load_2d(Xs + i * kXTile, &tm_x, full + i, k0, m0);
      tma_load_2d(Ws + i * kWTile, &tm_q, full + i, n0, k0);
    }
  }
  __syncthreads();

  if (warp == kConsumers) {
    // ---- producer warp: the whole CTA's K range is at most kStages
    // ahead of the consumers
    for (int i = first; i < nk; ++i) {
      const int s = i % kStages;
      const uint32_t ph = ((i / kStages) & 1) ^ 1;
      const int k0 = (kt0 + i) * kBK;
      uint8_t* Wt = Ws + s * kWTile;
      if (kTmaW) {
        if (lane == 0) {
          mbar_wait(empty + s, ph);
          mbar_expect_tx(full + s, kTx);
          tma_load_2d(Xs + s * kXTile, &tm_x, full + s, k0, m0);
          tma_load_2d(Wt, &tm_q, full + s, n0, k0);
        }
      } else {
        mbar_wait(empty + s, ph);
        if (lane == 0) {
          mbar_expect_tx(full + s, kTx);
          tma_load_2d(Xs + s * kXTile, &tm_x, full + s, k0, m0);
        }
        // 8-code groups, 8-byte loads when the rows allow (N % 8 == 0),
        // masked at K and N; code (k, n) at row k, 16-byte chunk
        // n / 16 ^ (k % 8): the 128-byte swizzle TMA writes
        for (int e = lane; e < kWTile / 8; e += 32) {
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
    // ---- consumer warp `warp` owns the output columns n0 + 16 warp ..
    // + 15 as the rows of out^T.  Its A fragments come from the W stage's
    // 16 columns by transposing ldmatrix on pairs of codes (the wave
    // path's): fragment rows g and g + 8 are columns 2 g and 2 g + 1.  Its
    // B fragments, x^T, come from the x stage by plain ldmatrix: matrix j
    // of a 32-deep half h holds x's rows 0..7 at k 32 h + 8 j .. + 7, so
    // the thread's register is row lane / 4 at k 32 h + 8 j + 2 (lane % 4),
    // the B fragment of a 16-deep step.
    const int g = lane / 4, t = lane % 4;
    float acc[MT / 2];
#pragma unroll
    for (int i = 0; i < MT / 2; ++i) acc[i] = 0.f;
    for (int i = 0; i < nk; ++i) {
      const int s = i % kStages;
      mbar_wait(full + s, (i / kStages) & 1);
      const uint8_t* Wt = Ws + s * kWTile;
      const bf16* Xt = Xs + s * kXTile;
      uint32_t a[kBK / 16][4];
      uint32_t b[MT / 8][kBK / 16][2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        // lanes 8j .. 8j + 7 address rows 32 h + 8 j .. of matrix j
        const int k = 32 * h + lane;
        uint32_t r[4];
        ldmatrix_x4_trans(r, Wt + k * kBN + ((warp ^ (k & 7)) * 16));
        widen_s8x4<true>(r[0], a[2 * h][0], a[2 * h][1]);
        widen_s8x4<true>(r[1], a[2 * h][2], a[2 * h][3]);
        widen_s8x4<true>(r[2], a[2 * h + 1][0], a[2 * h + 1][1]);
        widen_s8x4<true>(r[3], a[2 * h + 1][2], a[2 * h + 1][3]);
#pragma unroll
        for (int mb = 0; mb < MT / 8; ++mb) {
          // lane addresses row 8 mb + lane % 8, 16-byte chunk 4 h + lane / 8
          // of the swizzled x stage
          const int row = 8 * mb + (lane & 7), c = 4 * h + lane / 8;
          uint32_t x4[4];
          ldmatrix_x4(x4, reinterpret_cast<const uint8_t*>(Xt) + row * 128 +
                              ((c ^ (row & 7)) * 16));
          b[mb][2 * h][0] = x4[0];
          b[mb][2 * h][1] = x4[1];
          b[mb][2 * h + 1][0] = x4[2];
          b[mb][2 * h + 1][1] = x4[3];
        }
      }
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)
#pragma unroll
        for (int mb = 0; mb < MT / 8; ++mb)
          mma_m16n8k16(acc + 4 * mb, a[kk], b[mb][kk][0], b[mb][kk][1]);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + s);
    }

    // epilogue: acc[4 i + e] is out^T at row 2 g + (e >= 2) of the warp's
    // 16 columns and column 8 i + 2 t + (e & 1) of x's rows: each thread
    // holds two neighbouring output columns of its rows
    const int n = n0 + 16 * warp + 2 * g;
    if (n < N) {
      const bool two = n + 1 < N;
      const bool pairs = two && (N & 1) == 0;   // 4- / 8-byte boundaries
      float s0 = 1.f, s1 = 1.f;
      if (splits == 1) {
        s0 = scale[n];
        if (two) s1 = scale[n + 1];
      }
#pragma unroll
      for (int i = 0; i < MT / 8; ++i) {
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
            float* dst = ws + ((size_t)blockIdx.y * M + m) * N + n;
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
  __syncwarp();   // the producer warp's lanes meet again
  if (splits == 1) return;

  // ---- the split's sum.  The block's barrier orders its threads'
  // partials before thread 0's count, whose release at device scope makes
  // them visible with it (the acquire half makes the other blocks'
  // partials visible to the block that counts last; the barrier after it
  // hands them to its threads).  The closing block reads every split's
  // partials through L2 (none of them was ever in its L1).
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned* count = arrivals + blockIdx.z * gridDim.x + blockIdx.x;
    unsigned prev;
    asm volatile("atom.add.acq_rel.gpu.global.u32 %0, [%1], 1;\n"
                 : "=r"(prev) : "l"(count) : "memory");
    closes = prev == (unsigned)splits - 1;
    if (closes) *count = 0;   // every split of the tile has arrived
  }
  __syncthreads();
  if (!closes) return;
  const int cols = min(kBN, N - n0), rows = min(MT, M - m0);
  if ((N & 3) == 0) {
    // four neighbouring columns a thread: 16-byte loads, eight splits'
    // issued at a time before they are added in split order, then an
    // 8-byte store
    for (int e = threadIdx.x; e < rows * (cols / 4); e += kThreads) {
      const int m = m0 + e / (cols / 4), n = n0 + 4 * (e % (cols / 4));
      float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int z0 = 0; z0 < splits; z0 += 8) {
        float4 v[8];
#pragma unroll
        for (int j = 0; j < 8; ++j)
          if (z0 + j < splits)
            v[j] = __ldcg(reinterpret_cast<const float4*>(
                ws + ((size_t)(z0 + j) * M + m) * N + n));
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if (z0 + j < splits) {
            sum.x += v[j].x; sum.y += v[j].y; sum.z += v[j].z; sum.w += v[j].w;
          }
        }
      }
      const float4 sc = *reinterpret_cast<const float4*>(scale + n);
      uint2 o;
      o.x = pack_bf16(sum.x * sc.x, sum.y * sc.y);
      o.y = pack_bf16(sum.z * sc.z, sum.w * sc.w);
      *reinterpret_cast<uint2*>(out + (size_t)m * N + n) = o;
    }
  } else {
    for (int e = threadIdx.x; e < rows * cols; e += kThreads) {
      const int m = m0 + e / cols, n = n0 + e % cols;
      float sum = 0.f;
      for (int z = 0; z < splits; ++z)
        sum += __ldcg(ws + ((size_t)z * M + m) * N + n);
      out[(size_t)m * N + n] = __float2bfloat16_rn(sum * scale[n]);
    }
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

template <int MT, bool kTmaW>
cudaError_t launch_decode(const CUtensorMap& mx, const CUtensorMap& mq,
                          const void* q, const void* s, void* out, void* ws,
                          unsigned* arrivals, int M, int N, int K, int splits,
                          cudaStream_t stream) {
  static bool raised[hopper::kMaxDevices] = {};
  cudaError_t err = hopper::raise_smem(int8_decode_kernel<MT, kTmaW>,
                                       decode::smem_bytes<MT>(), raised);
  if (err != cudaSuccess) return err;
  const dim3 grid(ceil_div(N, decode::kBN), splits, ceil_div(M, MT));
  int8_decode_kernel<MT, kTmaW>
      <<<grid, decode::kThreads, decode::smem_bytes<MT>(), stream>>>(
      mx, mq, (const int8_t*)q, (const float*)s, (bf16*)out, (float*)ws,
      arrivals, M, N, K, splits);
  return cudaGetLastError();
}

// the weight's tensor map: [K, N] int8, boxes of kBK rows x 128 columns in
// the 128-byte swizzle (both paths' tiles are 128 columns x 64 deep)
cudaError_t make_q_map(CUtensorMap* mq, const void* q, int N, int K) {
  static_assert(wave::kBN == decode::kBN && wave::kBK == decode::kBK,
                "the two paths share the weight's boxes");
  const uint64_t q_dims[2] = {(uint64_t)N, (uint64_t)K};
  const uint64_t q_stride[1] = {(uint64_t)N};
  const uint32_t q_box[2] = {wave::kBN, wave::kBK};
  return hopper::make_map(mq, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, q, q_dims,
                          q_stride, q_box, true);
}

// x [M, K] bf16 in boxes of 64 deep x `rows`, 128-byte swizzle
cudaError_t make_x_map(CUtensorMap* mx, const void* x, int M, int K,
                       int rows) {
  const uint64_t x_dims[2] = {(uint64_t)K, (uint64_t)M};
  const uint64_t x_stride[1] = {(uint64_t)K * 2};
  const uint32_t x_box[2] = {64, (uint32_t)rows};
  return hopper::make_map(mx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, x_dims,
                          x_stride, x_box, true);
}

template <int MT>
cudaError_t run_decode(const void* x, const void* q, const void* s, void* out,
                       void* ws, unsigned* arrivals, int M, int N, int K,
                       int splits, cudaStream_t stream) {
  if (splits > 65535 || ceil_div(M, MT) > 65535) return cudaErrorInvalidValue;
  CUtensorMap mx, mq = {};
  cudaError_t err = make_x_map(&mx, x, M, K, MT);
  if (err != cudaSuccess) return err;
  if (N % 16 == 0) {
    err = make_q_map(&mq, q, N, K);
    if (err != cudaSuccess) return err;
    return launch_decode<MT, true>(mx, mq, q, s, out, ws, arrivals, M, N, K,
                                   splits, stream);
  }
  return launch_decode<MT, false>(mx, mq, q, s, out, ws, arrivals, M, N, K,
                                  splits, stream);
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
  cudaError_t err = make_x_map(&mx, x, M, K, BM);
  if (err != cudaSuccess) return err;
  if (N % 16 == 0) {
    err = make_q_map(&mq, q, N, K);
    if (err != cudaSuccess) return err;
    return launch_wave<BM, true>(mx, mq, q, s, out, ws, M, N, K, splits, stream);
  }
  return launch_wave<BM, false>(mx, mq, q, s, out, ws, M, N, K, splits, stream);
}

}  // namespace

// How many K slices the wave path splits the product into: 1 when its
// output tiles alone fill the card (one 384-thread block per SM), else
// enough for about one block per SM, at most kMaxSplits, four K tiles a
// slice at least, with no empty slice.  (The decode path's plan is the
// wrapper's, ops/int8_matmul.py:decode_splits.)
extern "C" int int8_matmul_splits(int M, int N, int K, int sms) {
  const long long tiles =
      (long long)ceil_div(M, wave::rows_for(M)) * ceil_div(N, wave::kBN);
  const int ktiles = ceil_div(K, wave::kBK);
  const int max_s = ktiles / 4;
  if (tiles >= sms || max_s <= 1) return 1;
  const long long want = (sms + tiles - 1) / tiles;
  int s = (int)(want < kMaxSplits ? want : kMaxSplits);
  if (s > max_s) s = max_s;
  const int per = ceil_div(ktiles, s);
  return ceil_div(ktiles, per);
}

// x [M, K] bf16, q [K, N] int8, s [N] f32 -> out [M, N] bf16 by the decode
// path (wave 0) or the wave path (wave 1).  splits > 1 needs ws, f32
// [splits, M, N] scratch, and on the decode path arrivals, a zeroed uint32
// count per 128-column tile and 16-row block of x (8 rows at M <= 8) that
// the launch leaves zeroed (the caller keeps one set per stream: two
// launches in flight at once on one set would close each other's tiles).  All contiguous, x and q on
// 16-byte boundaries, K % 16 == 0 (the caller checks).  Returns the
// launches' cudaError_t (0 on success).
extern "C" int int8_matmul_bf16(const void* x, const void* q, const void* s,
                                void* out, void* ws, void* arrivals, int M,
                                int N, int K, int splits, int wave_path,
                                void* stream) {
  if (M == 0 || N == 0) return (int)cudaSuccess;
  if (splits < 1 || splits > kMaxSplits || (splits > 1 && ws == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (!wave_path) {
    if (splits > 1 && arrivals == nullptr) return (int)cudaErrorInvalidValue;
    unsigned* arr = (unsigned*)arrivals;
    return (int)(M <= 8
        ? run_decode<8>(x, q, s, out, ws, arr, M, N, K, splits, st)
        : run_decode<16>(x, q, s, out, ws, arr, M, N, K, splits, st));
  }
  const int bm = wave::rows_for(M);
  cudaError_t err =
      bm == 256 ? run_wave<256>(x, q, s, out, ws, M, N, K, splits, st)
      : bm == 128 ? run_wave<128>(x, q, s, out, ws, M, N, K, splits, st)
                  : run_wave<64>(x, q, s, out, ws, M, N, K, splits, st);
  if (err != cudaSuccess || splits == 1) return (int)err;
  const long long total = (long long)M * N;
  const int blocks = (int)((total + 255) / 256 < 4096 ? (total + 255) / 256 : 4096);
  int8_matmul_reduce<<<blocks, 256, 0, st>>>((const float*)ws, (const float*)s,
                                             (bf16*)out, M, N, splits);
  return (int)cudaGetLastError();
}

// The id of the capture `stream` is in (a CUDA graph being recorded), 0
// when it is in none: the wrapper keeps the arrival counts of each capture
// apart from the stream's own.
extern "C" unsigned long long int8_matmul_capture_id(void* stream) {
  cudaStreamCaptureStatus status = cudaStreamCaptureStatusNone;
  unsigned long long id = 0;
  if (cudaStreamGetCaptureInfo((cudaStream_t)stream, &status, &id) !=
          cudaSuccess ||
      status != cudaStreamCaptureStatusActive)
    return 0;
  return id;
}
