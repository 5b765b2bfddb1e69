// Fused RMSNorm -> matmul for Hopper (sm_90a): bf16 x and W, an f32 or
// bf16 norm weight, f32 accumulation, bf16 out.
//
// Replaces: paddle_tpu/ops/pallas/rmsnorm_matmul.py, `rmsnorm_matmul` (the
// Pallas `_kernel` at line 42, launched by the pallas_call at line 93).
// Its backward is plain math in the JAX package and in the port.
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
// What the design does about it (hopper_sm90.cuh holds the TMA, mbarrier
// and wgmma pieces):
// * A block owns a 128 x 256 output tile: a producer warpgroup and two
//   consumer warpgroups of 64 rows, each accumulating 64 x 256 in f32
//   registers.  128 x 256 rather than 128 x 128: each byte staged in
//   shared memory feeds twice the products (m64n256k16, the widest wgmma),
//   and the trainer's N = 5504 and 2048 leave the last column tile 2% and
//   0% empty.
// * A four-stage TMA ring walks H in 64-deep steps.  Each stage holds the
//   raw x box [128, 64], W's [64, 256] as four 64-column boxes (W is
//   [H, N] row-major: the MN-major B operand) and wl's 64 values (wl streams
//   beside x, so H has no cap), with a full and an empty barrier.
// * Prologue in registers: each consumer warp reads its x rows with
//   ldmatrix in the wgmma A-fragment layout, adds x^2 of the raw bf16 values
//   into two f32 row sums, multiplies by wl, rounds to bf16 and issues
//   wgmma with A from registers: the normalised x is never written back.
//   Stages alternate between two sets of fragments, so one stage's products
//   run while the next stage's fragments are built.  The four threads of a
//   quad reduce their sums in the epilogue, which scales the accumulator by
//   rstd, rounds once and stores masked at M, N.
// * Ragged shapes: TMA zero-fills the part of a box past M, N or H (zeros
//   add nothing to x^2 or to the product; a clipped box still counts its
//   full bytes).  When N % 8 != 0 W's row stride is no multiple of 16 bytes
//   and no tensor map describes it: the same kernel's other instance has
//   the producer warpgroup load W with plain loads, masked at H and N, into
//   the same swizzled layout.  H is a multiple of 16 (the wrapper checks).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kBM = 128;        // rows of x per block, 64 per consumer
constexpr int kBN = 256;        // output columns per block
constexpr int kBK = 64;         // H depth of one stage
constexpr int kStages = 4;
constexpr int kThreads = 384;   // producer warpgroup + two consumers
constexpr int kATile = kBM * kBK;         // elements of a stage's x box
constexpr int kBTile = kBK * kBN;         // elements of a stage's W tile
constexpr int kBAtom = kBK * 64;          // one 64-column box of it
constexpr int kWlBytes = kBK * 4;         // a stage's wl slot (f32 or bf16)

__host__ __device__ constexpr int ceil_div(int a, int b) { return (a + b - 1) / b; }
__host__ __device__ constexpr int smem_bytes() {
  return kStages * (kATile * 2 + kBTile * 2 + kWlBytes) + 2 * kStages * 8 + 1024;
}

__device__ __forceinline__ float2 wl_pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 wl_pair(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// kTmaW: W arrives by TMA (N % 8 == 0); else the producer loads it.
template <bool kTmaW, typename TW>
__global__ void __launch_bounds__(kThreads, 1)
rmsnorm_matmul_kernel(const __grid_constant__ CUtensorMap tm_x,
                      const __grid_constant__ CUtensorMap tm_wl,
                      const __grid_constant__ CUtensorMap tm_w,
                      const bf16* __restrict__ w, bf16* __restrict__ out,
                      int M, int N, int H, float eps) {
  using namespace hopper;
  constexpr uint32_t kTx = kATile * 2 + kBK * sizeof(TW) + (kTmaW ? kBTile * 2 : 0);
  const int n0 = blockIdx.x * kBN;
  const int m0 = blockIdx.y * kBM;
  const int ktiles = ceil_div(H, kBK);

  extern __shared__ unsigned char smem_raw[];
  bf16* As = reinterpret_cast<bf16*>(align_1k(smem_raw));
  bf16* Bs = As + kStages * kATile;
  unsigned char* WLs = reinterpret_cast<unsigned char*>(Bs + kStages * kBTile);
  uint64_t* full = reinterpret_cast<uint64_t*>(WLs + kStages * kWlBytes);
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
    setmaxnreg_dec<40>();   // 128 x (168 - 40) = 256 x (232 - 168)
    for (int kt = 0; kt < ktiles; ++kt) {
      const int s = kt % kStages;
      const uint32_t ph = ((kt / kStages) & 1) ^ 1;
      const int k0 = kt * kBK;
      bf16* Bt = Bs + s * kBTile;
      if (kTmaW) {
        if (tid == 0) {
          mbar_wait(empty + s, ph);
          mbar_expect_tx(full + s, kTx);
          tma_load_2d(As + s * kATile, &tm_x, full + s, k0, m0);
          tma_load_1d(WLs + s * kWlBytes, &tm_wl, full + s, k0);
#pragma unroll
          for (int j = 0; j < kBN / 64; ++j)
            tma_load_2d(Bt + j * kBAtom, &tm_w, full + s, n0 + 64 * j, k0);
        }
      } else {
        mbar_wait(empty + s, ph);
        if (tid == 0) {
          mbar_expect_tx(full + s, kTx);
          tma_load_2d(As + s * kATile, &tm_x, full + s, k0, m0);
          tma_load_1d(WLs + s * kWlBytes, &tm_wl, full + s, k0);
        }
        // W rows k0 .., columns n0 .., into the swizzled 64-column boxes
#pragma unroll 4
        for (int i = tid; i < kBTile; i += 128) {
          const int r = i / kBN, c = i % kBN;
          const int k = k0 + r, n = n0 + c;
          const bf16 v = (k < H && n < N) ? w[(size_t)k * N + n]
                                          : __float2bfloat16_rn(0.f);
          const int cc = c % 64;
          Bt[(c / 64) * kBAtom + r * 64 + (((cc / 8) ^ (r & 7)) * 8) + cc % 8] = v;
        }
        fence_proxy_async();
        mbar_arrive(full + s);
      }
    }
  } else {
    // ---- consumers: warpgroup cw owns rows 64 cw .. 64 cw + 63
    setmaxnreg_inc<232>();
    const int cw = wg - 1;
    const int warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, t = lane % 4;
    // ldmatrix: lanes 0-15 give rows 0-15 of the warp's 16 at the step's
    // first 8 columns, lanes 16-31 the same rows at the next 8
    const int lrow = cw * 64 + warp * 16 + (lane & 15);
    const int lhalf = lane >> 4;

    float acc[kBN / 2];
#pragma unroll
    for (int i = 0; i < kBN / 2; ++i) acc[i] = 0.f;
    float ssq0 = 0.f, ssq1 = 0.f;   // rows g and g + 8 of the warp

    // Stage kt: its four A fragments built into a, then its products issued
    // behind one fence (not waited for).  Stages alternate between two
    // fragment sets, so the next stage's fragments are built while this
    // stage's products still read theirs.
    auto stage = [&](int kt, uint32_t (&a)[kBK / 16][4]) {
      const int s = kt % kStages;
      mbar_wait(full + s, (kt / kStages) & 1);
      const bf16* At = As + s * kATile;
      const bf16* Bt = Bs + s * kBTile;
      const TW* wlt = reinterpret_cast<const TW*>(WLs + s * kWlBytes);
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        const int chunk = 2 * kk + lhalf;
        ldmatrix_x4(a[kk], At + lrow * 64 + ((chunk ^ (lrow & 7)) * 8));
        // a[kk][0], [1]: columns 16 kk + 2t, + 1 of rows g, g + 8; [2],
        // [3]: the same 8 columns on
        const float2 wa = wl_pair(wlt + 16 * kk + 2 * t);
        const float2 wb = wl_pair(wlt + 16 * kk + 8 + 2 * t);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float2 xf = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(&a[kk][j]));
          const float sq = xf.x * xf.x + xf.y * xf.y;
          if (j & 1) ssq1 += sq; else ssq0 += sq;
          const float2 wv = j < 2 ? wa : wb;
          a[kk][j] = pack_bf16(xf.x * wv.x, xf.y * wv.y);
        }
      }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)
        wgmma_m64n256k16_rs<1>(
            acc, a[kk], desc_sw128(Bt + kk * 16 * 64, kBAtom * 2, 1024), 1);
      wgmma_commit();
    };
    auto release = [&](int kt) {
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + kt % kStages);
    };
    uint32_t a0[kBK / 16][4], a1[kBK / 16][4];
    for (int kt = 0; kt < ktiles; kt += 2) {
      stage(kt, a0);
      if (kt > 0) {
        wgmma_wait<1>();   // stage kt - 1 is done
        release(kt - 1);
      }
      if (kt + 1 < ktiles) {
        stage(kt + 1, a1);
        wgmma_wait<1>();   // stage kt is done
        release(kt);
      }
    }
    wgmma_wait<0>();
    fence_regs(acc);
    release(ktiles - 1);

    // epilogue: each row's sum of squares over the quad, rstd, one rounding
    ssq0 += __shfl_xor_sync(0xffffffffu, ssq0, 1);
    ssq0 += __shfl_xor_sync(0xffffffffu, ssq0, 2);
    ssq1 += __shfl_xor_sync(0xffffffffu, ssq1, 1);
    ssq1 += __shfl_xor_sync(0xffffffffu, ssq1, 2);
    const float rs0 = rsqrtf(ssq0 / (float)H + eps);
    const float rs1 = rsqrtf(ssq1 / (float)H + eps);
    const int ma = m0 + cw * 64 + warp * 16 + g, mb = ma + 8;
    const bool pairs = (N & 1) == 0;   // bf16 pairs on 4-byte boundaries
#pragma unroll
    for (int i = 0; i < kBN / 8; ++i) {
      const int n = n0 + 8 * i + 2 * t;
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int m = hr ? mb : ma;
        const float rs = hr ? rs1 : rs0;
        if (m >= M || n >= N) continue;
        const float v0 = acc[4 * i + 2 * hr] * rs;
        const float v1 = acc[4 * i + 2 * hr + 1] * rs;
        bf16* dst = out + (size_t)m * N + n;
        if (pairs && n + 1 < N) {
          *reinterpret_cast<uint32_t*>(dst) = pack_bf16(v0, v1);
        } else {
          dst[0] = __float2bfloat16_rn(v0);
          if (n + 1 < N) dst[1] = __float2bfloat16_rn(v1);
        }
      }
    }
  }
}

template <bool kTmaW, typename TW>
int launch(const CUtensorMap& mx, const CUtensorMap& mwl, const CUtensorMap& mw,
           const void* w, void* out, int M, int N, int H, float eps,
           cudaStream_t stream) {
  static bool raised[hopper::kMaxDevices] = {};
  cudaError_t err = hopper::raise_smem(rmsnorm_matmul_kernel<kTmaW, TW>,
                                       smem_bytes(), raised);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(ceil_div(N, kBN), ceil_div(M, kBM));
  rmsnorm_matmul_kernel<kTmaW, TW><<<grid, kThreads, smem_bytes(), stream>>>(
      mx, mwl, mw, (const bf16*)w, (bf16*)out, M, N, H, eps);
  return (int)cudaGetLastError();
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
  if (H <= 0 || H % 16) return (int)cudaErrorInvalidValue;
  if (ceil_div(M, kBM) > 65535) return (int)cudaErrorInvalidValue;
  const CUtensorMapDataType bf = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  CUtensorMap mx, mwl, mw = {};
  const uint64_t x_dims[2] = {(uint64_t)H, (uint64_t)M};
  const uint64_t x_stride[1] = {(uint64_t)H * 2};
  const uint32_t x_box[2] = {kBK, kBM};
  const uint64_t wl_dims[1] = {(uint64_t)H};
  const uint32_t wl_box[1] = {kBK};
  const bool tma_w = N % 8 == 0;
  cudaError_t err = hopper::make_map(&mx, bf, 2, x, x_dims, x_stride, x_box, true);
  if (err == cudaSuccess)
    err = hopper::make_map(&mwl, wl_bf16 ? bf : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                           1, wl, wl_dims, nullptr, wl_box, false);
  if (err == cudaSuccess && tma_w) {
    const uint64_t w_dims[2] = {(uint64_t)N, (uint64_t)H};
    const uint64_t w_stride[1] = {(uint64_t)N * 2};
    const uint32_t w_box[2] = {64, kBK};
    err = hopper::make_map(&mw, bf, 2, w, w_dims, w_stride, w_box, true);
  }
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = (cudaStream_t)stream;
  if (tma_w)
    return wl_bf16 ? launch<true, bf16>(mx, mwl, mw, w, out, M, N, H, eps, st)
                   : launch<true, float>(mx, mwl, mw, w, out, M, N, H, eps, st);
  return wl_bf16 ? launch<false, bf16>(mx, mwl, mw, w, out, M, N, H, eps, st)
                 : launch<false, float>(mx, mwl, mw, w, out, M, N, H, eps, st);
}
