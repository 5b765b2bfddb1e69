// FlashAttention forward and backward for Hopper (sm_90a): bf16 in and
// out, f32 softmax and accumulation, causal or not, equal head counts.
//
// Replaces: paddle_tpu/ops/pallas/flash_attention.py, the three pallas_calls
// of `flash_attention`: the forward at line 285 (`_fwd_kernel`, line 34),
// the dq pass at line 319 (`_bwd_dq_kernel`) and the dk / dv pass at line
// 336 (`_bwd_dkv_kernel`).
//
// Computes, for q, k, v [B, S, H, d] (one stream per batch row and head):
//   forward:  out = softmax(q k^T / sqrt(d) [+ causal mask]) v, and
//             lse[b, h, i] = log sum_j exp(score[i, j])   (natural log)
//   dq pass:  p = exp(score - lse), dp = do v^T,
//             ds = p * (dp - delta) / sqrt(d), dq = ds k
//   dkv pass: dv = p^T do, dk = ds^T q
// with delta[b, h, i] = sum(do * out) computed by the caller.  p and ds are
// rounded to bf16 before their second product, as in the TPU kernels.
//
// What bounds it on the card: operations.  A visible (q, k) pair costs 4 * d
// FLOPs forward (6 * d in the dq pass, 8 * d in the dkv pass) per head
// against bytes that grow with S only, so from a few hundred tokens on the
// bf16 tensor-core rate is the limit, not the memory.
//
// What the forward's design does about it (hopper_sm90.cuh holds the TMA,
// mbarrier and wgmma pieces):
// * A block owns a 128-row q tile of one (batch row, head) and has three
//   warpgroups: a producer and two consumers of 64 q rows each.  The
//   producer's one thread loads Q once and streams K and V in 128-key tiles
//   through a ring of shared-memory stages (2 at d = 128, 3 at d = 64) by
//   TMA, with 4-D tensor maps over [B, S, H, d], so the row stride H * d is
//   the map's and nothing is gathered.  K and V have their own full and
//   empty barriers: a K stage is refilled once S is computed, a V stage
//   once P V is.
// * S = Q K^T runs as wgmma m64n128k16 with both operands in 128-byte
//   swizzled shared memory; the online softmax runs on the accumulator
//   registers in base 2 (sm_scale * log2(e) folded into one multiply,
//   ex2.approx), the row max and sum reduced across the four threads of a
//   quad by shuffles.  P is rounded to bf16 and re-packed in registers as the A
//   fragments of O += P V, a wgmma with A from registers and V the
//   MN-major B operand: nothing of S or P passes through shared memory.
// * Overlap: while the consumers work on one tile the producer has the
//   next in flight.  Each consumer issues S of tile j and P V of tile j - 1
//   together and does tile j's softmax while P V runs, and the two
//   consumers take turns to issue (named barriers, "ping-pong"), so one's
//   softmax runs while the other's products hold the tensor cores.
// * Causal: only tiles on or below the diagonal are visited, the diagonal
//   tile first, so only that first tile (also the one holding keys past a
//   ragged S) is masked.  A head's q tiles are neighbours in the grid, so
//   its K and V stay in L2 while they run, heavy (late) tiles first.
// * The output goes back through each consumer's own rows of the Q tile
//   and a TMA store, which writes no row past S; lse = (m2 + log2 l) ln 2.
// The backward keeps the 64-row wmma tiles of flash_tiles.cuh: the dq pass
// owns a q tile and loops over k tiles, the dkv pass owns a k tile and
// loops over q tiles (transposed scores k q^T, so its two products contract
// over the q rows without a transposed copy).  Each output is written once:
// no atomics, and the result does not change from run to run.

#include "flash_tiles.cuh"
#include "hopper_sm90.cuh"

namespace {

template <int D> __host__ __device__ constexpr int dq_smem() {
  return 4 * tile_bytes<D>() + 2 * kScoreBytes + kProbBytes;
}
template <int D> __host__ __device__ constexpr int dkv_smem() {
  return 4 * tile_bytes<D>() + 2 * kScoreBytes + 2 * kProbBytes + 2 * kT * 4;
}

// ---------------------------------------------------------------------------
// forward: grid (q tiles, H, B), 384 threads
// ---------------------------------------------------------------------------
namespace fwd {
constexpr int kBM = 128;        // q rows of a block, 64 per consumer
constexpr int kBN = 128;        // keys of a tile
constexpr int kThreads = 384;   // producer warpgroup + two consumers
template <int D> __host__ __device__ constexpr int stages() { return D == 128 ? 2 : 3; }
// Q, one K and one V tile (kBM == kBN rows of d), the barriers, and 1 KB
// to align the start
template <int D> __host__ __device__ constexpr int smem_bytes() {
  return (1 + 2 * stages<D>()) * kBN * D * 2 + 512 + 1024;
}
}  // namespace fwd

template <int D>
__global__ void __launch_bounds__(fwd::kThreads, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap tm_q,
                 const __grid_constant__ CUtensorMap tm_k,
                 const __grid_constant__ CUtensorMap tm_v,
                 const __grid_constant__ CUtensorMap tm_o,
                 float* __restrict__ lse, int S, int H, int causal,
                 float scale_log2) {
  using namespace hopper;
  constexpr int ST = fwd::stages<D>();
  constexpr int kAtom = fwd::kBN * 64;           // one 64-column atom of a tile
  constexpr int kTile = fwd::kBN * D;            // elements of a tile
  constexpr uint32_t kTileBytes = kTile * 2;
  constexpr int NA = D / 64;
  const int qt = gridDim.x - 1 - blockIdx.x;     // late (heavy) tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = qt * fwd::kBM;
  const int nkt = causal ? qt + 1 : (S + fwd::kBN - 1) / fwd::kBN;

  extern __shared__ unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(align_1k(smem_raw));
  bf16* Ks = Qs + kTile;
  bf16* Vs = Ks + ST * kTile;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(Vs + ST * kTile);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + ST;
  uint64_t* k_empty = v_full + ST;
  uint64_t* v_empty = k_empty + ST;

  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(k_full + s, 1);
      mbar_init(v_full + s, 1);
      mbar_init(k_empty + s, 8);   // one arrival per consumer warp
      mbar_init(v_empty + s, 8);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer: one thread issues every load; k tiles from the
    // diagonal (or the last) down to 0.  K and V have their own barriers:
    // a K stage frees when S is computed, a V stage when P V is.
    setmaxnreg_dec<24>();   // 128 x (168 - 24) = 256 x (240 - 168)
    if (tid == 0) {
      mbar_expect_tx(q_full, kTileBytes);
#pragma unroll
      for (int a = 0; a < NA; ++a)
        tma_load_4d(Qs + a * kAtom, &tm_q, q_full, a * 64, h, q0, b);
      for (int it = 0; it < nkt; ++it) {
        const int s = it % ST;
        const uint32_t ph = ((it / ST) & 1) ^ 1;
        const int k0 = (nkt - 1 - it) * fwd::kBN;
        mbar_wait(k_empty + s, ph);
        mbar_expect_tx(k_full + s, kTileBytes);
#pragma unroll
        for (int a = 0; a < NA; ++a)
          tma_load_4d(Ks + s * kTile + a * kAtom, &tm_k, k_full + s, a * 64,
                      h, k0, b);
        mbar_wait(v_empty + s, ph);
        mbar_expect_tx(v_full + s, kTileBytes);
#pragma unroll
        for (int a = 0; a < NA; ++a)
          tma_load_4d(Vs + s * kTile + a * kAtom, &tm_v, v_full + s, a * 64,
                      h, k0, b);
      }
    }
  } else {
    // ---- consumers: warpgroup cw owns q rows 64 cw .. 64 cw + 63.  Each
    // iteration issues S of tile it and O += P V of tile it - 1 together,
    // and does tile it's softmax while the P V product runs.
    setmaxnreg_inc<240>();
    const int cw = wg - 1;
    const int warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, t = lane % 4;
    const int r0 = cw * 64 + warp * 16 + g;      // this thread's rows r0, r0 + 8
    const int qp0 = q0 + r0, qp1 = qp0 + 8;
    bf16* Qw = Qs + cw * 64 * 64;                // this warpgroup's rows of atom 0

    // S = Q K^T of the tile in stage s: 64 rows x 128 keys (issued, not
    // waited for)
    auto qk = [&](float (&sc)[64], int s) {
      const bf16* Kt = Ks + s * kTile;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int off = (kk / 4) * kAtom + (kk % 4) * 16;
        wgmma_m64n128k16_ss<0>(sc, desc_sw128(Qw + off, 0, 1024),
                               desc_sw128(Kt + off, 0, 1024), kk > 0);
      }
      wgmma_commit();
    };
    // O += P V of the tile in stage s (issued, not waited for)
    auto pv = [&](float (&o)[D / 2], uint32_t (&pa)[8][4], int s) {
      const bf16* Vt = Vs + s * kTile;
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        const uint64_t db = desc_sw128(Vt + kk * 16 * 64, kAtom * 2, 1024);
        if constexpr (D == 128)
          wgmma_m64n128k16_rs<1>(o, pa[kk], db, 1);
        else
          wgmma_m64n64k16_rs<1>(o, pa[kk], db, 1);
      }
      wgmma_commit();
    };
    auto release = [&](uint64_t* bar) {
      __syncwarp();
      if (lane == 0) mbar_arrive(bar);
    };

    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
    uint32_t pa[8][4];
    float alpha0 = 1.f, alpha1 = 1.f;

    // online softmax of the raw scores sc of tile it (rows r0: e < 2, r0 + 8:
    // e >= 2) in base 2: updates m, l and alpha, leaves P in sc.  The first
    // tile visited is the only one that can hold keys past S or above the
    // diagonal.
    auto softmax = [&](float (&sc)[64], int it) {
      if (it == 0) {
        const int k0 = (nkt - 1) * fwd::kBN;
#pragma unroll
        for (int i = 0; i < 16; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int kpos = k0 + 8 * i + 2 * t + (e & 1);
            const int qp = e < 2 ? qp0 : qp1;
            if (!(kpos < S && (!causal || kpos <= qp))) sc[4 * i + e] = -INFINITY;
          }
      }
      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        mx0 = fmaxf(mx0, fmaxf(sc[4 * i], sc[4 * i + 1]));
        mx1 = fmaxf(mx1, fmaxf(sc[4 * i + 2], sc[4 * i + 3]));
      }
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
      mx0 = fmaxf(m0, mx0 * scale_log2);
      mx1 = fmaxf(m1, mx1 * scale_log2);
      const float ref0 = mx0 == -INFINITY ? 0.f : mx0;
      const float ref1 = mx1 == -INFINITY ? 0.f : mx1;
      alpha0 = exp2_ftz(m0 - ref0);
      alpha1 = exp2_ftz(m1 - ref1);
      m0 = mx0;
      m1 = mx1;
      float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        sc[4 * i] = exp2_ftz(fmaf(sc[4 * i], scale_log2, -ref0));
        sc[4 * i + 1] = exp2_ftz(fmaf(sc[4 * i + 1], scale_log2, -ref0));
        sc[4 * i + 2] = exp2_ftz(fmaf(sc[4 * i + 2], scale_log2, -ref1));
        sc[4 * i + 3] = exp2_ftz(fmaf(sc[4 * i + 3], scale_log2, -ref1));
        sum0 += sc[4 * i] + sc[4 * i + 1];
        sum1 += sc[4 * i + 2] + sc[4 * i + 3];
      }
      // this thread's columns; the quad adds up at the end
      l0 = l0 * alpha0 + sum0;
      l1 = l1 * alpha1 + sum1;
    };
    // P in bf16 as the A fragments of 16-key steps: n-blocks 2kk, 2kk + 1
    // (only once the previous P V product no longer reads pa)
    auto pack = [&](const float (&sc)[64]) {
#pragma unroll
      for (int kk = 0; kk < 8; ++kk)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          pa[kk][j] = pack_bf16(sc[8 * kk + 2 * j], sc[8 * kk + 2 * j + 1]);
    };

    // The two warpgroups take turns to issue their products (named
    // barriers 3 and 4), so one's softmax runs while the other's products
    // hold the tensor cores.  Each has nkt + 1 issue points; warpgroup 1
    // opens the first turn for warpgroup 0 and skips its last hand-over.
    const int n_issue = nkt + 1;
    int issued = 0;
    auto my_turn = [&]() { named_sync(3 + cw, 256); };
    auto hand_over = [&]() {
      if (++issued < n_issue || cw == 0) named_arrive(3 + (1 - cw), 256);
    };
    if (cw == 1) named_arrive(3, 256);

    mbar_wait(q_full, 0);
    {
      float sc[64];
      mbar_wait(k_full, 0);
      my_turn();
      wgmma_fence();
      qk(sc, 0);
      hand_over();
      wgmma_wait<0>();
      fence_regs(sc);
      release(k_empty);
      softmax(sc, 0);
      pack(sc);
    }
    for (int it = 1; it < nkt; ++it) {
      const int s = it % ST, sp = (it - 1) % ST;
      float sc[64];
      mbar_wait(k_full + s, (it / ST) & 1);
      mbar_wait(v_full + sp, ((it - 1) / ST) & 1);
      my_turn();
      wgmma_fence();
      qk(sc, s);
      pv(o, pa, sp);
      hand_over();
      wgmma_wait<1>();                           // S done, P V in flight
      fence_regs(sc);
      release(k_empty + s);
      softmax(sc, it);
      wgmma_wait<0>();
      fence_regs(o);
      release(v_empty + sp);
      pack(sc);
#pragma unroll
      for (int i = 0; i < D / 8; ++i) {
        o[4 * i] *= alpha0;
        o[4 * i + 1] *= alpha0;
        o[4 * i + 2] *= alpha1;
        o[4 * i + 3] *= alpha1;
      }
    }
    {
      const int sp = (nkt - 1) % ST;
      mbar_wait(v_full + sp, ((nkt - 1) / ST) & 1);
      my_turn();
      wgmma_fence();
      pv(o, pa, sp);
      hand_over();
      wgmma_wait<0>();
      fence_regs(o);
      release(v_empty + sp);
    }

    // epilogue: normalise, lse, and out through this warpgroup's Q rows
    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    l0 = fmaxf(l0, 1e-30f);
    l1 = fmaxf(l1, 1e-30f);
    if (t == 0) {
      const size_t stat = ((size_t)b * H + h) * S;
      constexpr float kLn2 = 0.6931471805599453f;
      if (qp0 < S) lse[stat + qp0] = (m0 + log2f(l0)) * kLn2;
      if (qp1 < S) lse[stat + qp1] = (m1 + log2f(l1)) * kLn2;
    }
    const float inv0 = 1.f / l0, inv1 = 1.f / l1;
    const int rr = warp * 16 + g;                // row within the warpgroup's 64
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      bf16* atom = Qw + (i / 8) * kAtom;
      const int chunk = i % 8;
      *reinterpret_cast<uint32_t*>(atom + rr * 64 + ((chunk ^ (rr & 7)) * 8) + 2 * t) =
          pack_bf16(o[4 * i] * inv0, o[4 * i + 1] * inv0);
      *reinterpret_cast<uint32_t*>(atom + (rr + 8) * 64 +
                                   ((chunk ^ ((rr + 8) & 7)) * 8) + 2 * t) =
          pack_bf16(o[4 * i + 2] * inv1, o[4 * i + 3] * inv1);
    }
    fence_proxy_async();
    named_sync(1 + cw, 128);
    if (tid == 0) {
#pragma unroll
      for (int a = 0; a < NA; ++a)
        tma_store_4d(&tm_o, Qw + a * kAtom, a * 64, h, q0 + cw * 64, b);
      tma_store_wait();
    }
  }
}

// ---------------------------------------------------------------------------
// backward, dq: grid (q tiles, H, B)
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, bf16* __restrict__ dq,
                    int S, int H, int causal, float sm_scale) {
  constexpr int LD = D + kPad;
  constexpr int NF = D / 16;
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = lane >> 1, hf = lane & 1;
  const int q0 = qt * kT;
  const size_t rs = (size_t)H * D;
  const size_t base = ((size_t)b * S * H + h) * D;

  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* dOs = Qs + kT * LD;
  bf16* Ks = dOs + kT * LD;
  bf16* Vs = Ks + kT * LD;
  float* Sf = reinterpret_cast<float*>(smem + 4 * tile_bytes<D>()) + warp * 16 * kSLD;
  float* dPf = reinterpret_cast<float*>(smem + 4 * tile_bytes<D>() + kScoreBytes) +
               warp * 16 * kSLD;
  bf16* dSb = reinterpret_cast<bf16*>(smem + 4 * tile_bytes<D>() + 2 * kScoreBytes) +
              warp * 16 * kPLD;

  load_tile<D>(Qs, q + base, q0, S, rs);
  load_tile<D>(dOs, dout + base, q0, S, rs);

  const int qpos = q0 + warp * 16 + r;
  const size_t stat = ((size_t)b * H + h) * S;
  const float lse_r = qpos < S ? lse[stat + qpos] : 0.f;
  const float delta_r = qpos < S ? delta[stat + qpos] : 0.f;

  FragC acc[NF];
#pragma unroll
  for (int f = 0; f < NF; ++f) wmma::fill_fragment(acc[f], 0.f);
  const int nkt = causal ? qt + 1 : (S + kT - 1) / kT;

  for (int kt = 0; kt < nkt; ++kt) {
    const int k0 = kt * kT;
    __syncthreads();
    load_tile<D>(Ks, k + base, k0, S, rs);
    load_tile<D>(Vs, v + base, k0, S, rs);
    __syncthreads();

    {
      FragC sc[4];
      mma_abt<D>(sc, Qs + warp * 16 * LD, Ks);
      store_scores(Sf, sc);
      mma_abt<D>(sc, dOs + warp * 16 * LD, Vs);
      store_scores(dPf, sc);
    }
    __syncwarp();
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int c = hf + 2 * j;
      const int kpos = k0 + c;
      const bool ok = kpos < S && (!causal || kpos <= qpos);
      const float p = ok ? expf(Sf[r * kSLD + c] * sm_scale - lse_r) : 0.f;
      const float ds = p * (dPf[r * kSLD + c] - delta_r) * sm_scale;
      dSb[r * kPLD + c] = __float2bfloat16(ds);
    }
    __syncwarp();
    mma_pb<D>(acc, dSb, Ks);
  }

  __syncthreads();   // every warp is done with Ks / Vs: reuse them as scratch
  float* stage = reinterpret_cast<float*>(Ks) + warp * 16 * (D + 4);
  store_rows<D>(acc, stage, dq + base, q0 + warp * 16, S, rs, lane);
}

// ---------------------------------------------------------------------------
// backward, dk and dv: grid (k tiles, H, B)
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, bf16* __restrict__ dk,
                     bf16* __restrict__ dv, int S, int H, int causal,
                     float sm_scale) {
  constexpr int LD = D + kPad;
  constexpr int NF = D / 16;
  const int kt = blockIdx.x;   // early k tiles see the most q tiles when causal
  const int h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = lane >> 1, hf = lane & 1;
  const int k0 = kt * kT;
  const size_t rs = (size_t)H * D;
  const size_t base = ((size_t)b * S * H + h) * D;
  const size_t stat = ((size_t)b * H + h) * S;

  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + kT * LD;
  bf16* Qs = Vs + kT * LD;
  bf16* dOs = Qs + kT * LD;
  unsigned char* rest = smem + 4 * tile_bytes<D>();
  float* Sf = reinterpret_cast<float*>(rest) + warp * 16 * kSLD;
  float* dPf = reinterpret_cast<float*>(rest + kScoreBytes) + warp * 16 * kSLD;
  bf16* Pb = reinterpret_cast<bf16*>(rest + 2 * kScoreBytes) + warp * 16 * kPLD;
  bf16* dSb = reinterpret_cast<bf16*>(rest + 2 * kScoreBytes + kProbBytes) +
              warp * 16 * kPLD;
  float* lse_s = reinterpret_cast<float*>(rest + 2 * kScoreBytes + 2 * kProbBytes);
  float* delta_s = lse_s + kT;

  load_tile<D>(Ks, k + base, k0, S, rs);
  load_tile<D>(Vs, v + base, k0, S, rs);

  FragC dkf[NF], dvf[NF];
#pragma unroll
  for (int f = 0; f < NF; ++f) {
    wmma::fill_fragment(dkf[f], 0.f);
    wmma::fill_fragment(dvf[f], 0.f);
  }
  const int kpos = k0 + warp * 16 + r;
  const int nqt = (S + kT - 1) / kT;

  for (int qt = causal ? kt : 0; qt < nqt; ++qt) {
    const int q0 = qt * kT;
    __syncthreads();
    load_tile<D>(Qs, q + base, q0, S, rs);
    load_tile<D>(dOs, dout + base, q0, S, rs);
    if (threadIdx.x < kT) {
      const int qp = q0 + threadIdx.x;
      lse_s[threadIdx.x] = qp < S ? lse[stat + qp] : 0.f;
      delta_s[threadIdx.x] = qp < S ? delta[stat + qp] : 0.f;
    }
    __syncthreads();

    {
      // transposed scores: this warp's 16 keys against the tile's 64 q rows
      FragC sc[4];
      mma_abt<D>(sc, Ks + warp * 16 * LD, Qs);
      store_scores(Sf, sc);
      mma_abt<D>(sc, Vs + warp * 16 * LD, dOs);
      store_scores(dPf, sc);
    }
    __syncwarp();
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int c = hf + 2 * j;
      const int qpos = q0 + c;
      const bool ok = qpos < S && kpos < S && (!causal || kpos <= qpos);
      const float p = ok ? expf(Sf[r * kSLD + c] * sm_scale - lse_s[c]) : 0.f;
      const float ds = p * (dPf[r * kSLD + c] - delta_s[c]) * sm_scale;
      Pb[r * kPLD + c] = __float2bfloat16(p);
      dSb[r * kPLD + c] = __float2bfloat16(ds);
    }
    __syncwarp();
    mma_pb<D>(dvf, Pb, dOs);
    mma_pb<D>(dkf, dSb, Qs);
  }

  __syncthreads();   // every warp is done with Qs / dOs: reuse them as scratch
  float* stage = reinterpret_cast<float*>(Qs) + warp * 16 * (D + 4);
  store_rows<D>(dvf, stage, dv + base, k0 + warp * 16, S, rs, lane);
  store_rows<D>(dkf, stage, dk + base, k0 + warp * 16, S, rs, lane);
}

template <int D>
int launch_fwd(const void* q, const void* k, const void* v, void* out,
               void* lse, int B, int S, int H, int causal, float sm_scale,
               cudaStream_t stream) {
  // [B, S, H, d] as 4-D maps, innermost first; a box is 64 columns of d
  // (one swizzle atom) by 128 rows (Q, K, V) or 64 rows (a consumer's out)
  const uint64_t dims[4] = {(uint64_t)D, (uint64_t)H, (uint64_t)S, (uint64_t)B};
  const uint64_t strides[3] = {(uint64_t)D * 2, (uint64_t)H * D * 2,
                               (uint64_t)S * H * D * 2};
  const uint32_t box_in[4] = {64, 1, fwd::kBN, 1};
  const uint32_t box_out[4] = {64, 1, 64, 1};
  CUtensorMap mq, mk, mv, mo;
  const CUtensorMapDataType t = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  cudaError_t err;
  if ((err = hopper::make_map(&mq, t, 4, q, dims, strides, box_in, true)) ||
      (err = hopper::make_map(&mk, t, 4, k, dims, strides, box_in, true)) ||
      (err = hopper::make_map(&mv, t, 4, v, dims, strides, box_in, true)) ||
      (err = hopper::make_map(&mo, t, 4, out, dims, strides, box_out, true)))
    return (int)err;
  static bool raised[hopper::kMaxDevices] = {};
  err = hopper::raise_smem(flash_fwd_kernel<D>, fwd::smem_bytes<D>(), raised);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((S + fwd::kBM - 1) / fwd::kBM, H, B);
  flash_fwd_kernel<D><<<grid, fwd::kThreads, fwd::smem_bytes<D>(), stream>>>(
      mq, mk, mv, mo, (float*)lse, S, H, causal,
      sm_scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, void* dq, int B, int S,
              int H, int causal, float sm_scale, cudaStream_t stream) {
  static bool raised[hopper::kMaxDevices] = {};
  cudaError_t err = hopper::raise_smem(flash_bwd_dq_kernel<D>, dq_smem<D>(), raised);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((S + kT - 1) / kT, H, B);
  flash_bwd_dq_kernel<D><<<grid, kThreads, dq_smem<D>(), stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout,
      (const float*)lse, (const float*)delta, (bf16*)dq, S, H, causal,
      sm_scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, void* dk, void* dv, int B,
               int S, int H, int causal, float sm_scale, cudaStream_t stream) {
  static bool raised[hopper::kMaxDevices] = {};
  cudaError_t err = hopper::raise_smem(flash_bwd_dkv_kernel<D>, dkv_smem<D>(), raised);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((S + kT - 1) / kT, H, B);
  flash_bwd_dkv_kernel<D><<<grid, kThreads, dkv_smem<D>(), stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout,
      (const float*)lse, (const float*)delta, (bf16*)dk, (bf16*)dv, S, H,
      causal, sm_scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v, out, dout, dq, dk, dv [B, S, H, d] bf16; lse, delta [B, H, S]
// f32.  All contiguous and on 16-byte boundaries; d is 64 or 128; H and B at
// most 65535 (the wrapper checks).  Each returns the launch's cudaError_t (0
// on success).
extern "C" int flash_attention_fwd_bf16(
    const void* q, const void* k, const void* v, void* out, void* lse, int B,
    int S, int H, int d, int causal, float sm_scale, void* stream) {
  if (B == 0 || S == 0 || H == 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  if (d == 128) return launch_fwd<128>(q, k, v, out, lse, B, S, H, causal, sm_scale, s);
  if (d == 64) return launch_fwd<64>(q, k, v, out, lse, B, S, H, causal, sm_scale, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int flash_attention_bwd_dq_bf16(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, int B, int S, int H, int d,
    int causal, float sm_scale, void* stream) {
  if (B == 0 || S == 0 || H == 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  if (d == 128)
    return launch_dq<128>(q, k, v, dout, lse, delta, dq, B, S, H, causal, sm_scale, s);
  if (d == 64)
    return launch_dq<64>(q, k, v, dout, lse, delta, dq, B, S, H, causal, sm_scale, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int flash_attention_bwd_dkv_bf16(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, int B, int S,
    int H, int d, int causal, float sm_scale, void* stream) {
  if (B == 0 || S == 0 || H == 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  if (d == 128)
    return launch_dkv<128>(q, k, v, dout, lse, delta, dk, dv, B, S, H, causal, sm_scale, s);
  if (d == 64)
    return launch_dkv<64>(q, k, v, dout, lse, delta, dk, dv, B, S, H, causal, sm_scale, s);
  return (int)cudaErrorInvalidValue;
}
