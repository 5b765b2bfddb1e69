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
// bf16 tensor-core rate is the limit, not the memory.  Every pass is built
// to keep the tensor cores fed (hopper_sm90.cuh holds the TMA, mbarrier and
// wgmma pieces): a block of 384 threads is one producer warpgroup, whose
// one thread streams tiles into a ring of shared-memory stages by TMA (4-D
// tensor maps over [B, S, H, d], so nothing is gathered; each stage a full
// and an empty mbarrier), and two consumer warpgroups of 64 rows each that
// run wgmma products on the stages as they arrive; setmaxnreg moves the
// producer's registers to the consumers.  Tiles are rows of 64 bf16 in the
// 128-byte swizzle the maps write, read by wgmma K-major for A B^T and
// MN-major for A B, so no tile is ever transposed.  Scores, p and ds live
// in the accumulator registers only, re-packed in bf16 as the A fragments
// of the second products.
//
// The forward is csrc/flash_fwd_sm90.cuh's flash_fwd_kernel<D, false>,
// the template it shares with the segmented forward (K2): a 128-row q tile
// a block, K and V streamed in 128-key tiles from the diagonal down, S by
// wgmma from shared memory, the online softmax in base 2 on the
// accumulators, O += P V with P re-packed as register A fragments, the two
// consumers in ping-pong; only the first tile visited (the diagonal, or
// the one holding keys past a ragged S) is masked; heavy (late) q tiles
// first.
//
// The backward is two passes, one per pallas_call, so each output is
// written once: no atomics, and dq, dk and dv do not change from run to
// run.  The price is 7 products per visible pair where a fused pass
// (dq summed across blocks by atomics) runs 5.  p = exp2(s * scale * log2 e
// - lse * log2 e) is recomputed from the forward's lse in both.
// * dq pass, grid (128-row q tiles, H, B), heavy (late) tiles first: the
//   producer loads Q and dO once and streams K and V tiles (64 keys at
//   d = 128, 128 at d = 64) from the diagonal down to 0, so only the
//   diagonal tile (and the one past a ragged S) is masked.  Each consumer:
//   S = Q K^T and dP = dO V^T as wgmma with both operands in shared memory,
//   ds = p (dp - delta) scale on the registers (lse and delta of its two
//   rows per thread held in registers), then dq += ds K with ds packed as
//   A and the same K stage as the MN-major B operand.
// * dk / dv pass, grid (128-key tiles, H, B), heavy (early) tiles first:
//   the producer loads K and V once and streams Q and dO in 64-row tiles
//   from the diagonal to the end; a second producer warp copies each
//   tile's lse and delta into the stage with plain loads and arrives on
//   its full barrier (at odd S no TMA reaches them).  Each consumer owns
//   64 keys and works on transposed scores, S^T = K Q^T and dP^T = V dO^T
//   (m64n64k16, both operands in shared memory), so that p^T and ds^T come
//   out of the accumulators as the A fragments of dv += p^T dO and
//   dk += ds^T Q, with the Q and dO stages as MN-major B operands.
// * Overlap: the dq pass issues tile j's S and dP beside tile j - 1's dq
//   product, as the forward does; the dk / dv pass cannot (dk, dv, S^T and
//   dP^T fill the registers at d = 128).  In both the two consumers take
//   turns to issue (ping-pong), so one's exp / ds work runs under the
//   other's products.  Masks run in a loop of their own, on the diagonal
//   and ragged tiles only.
// * Both write their results through the consumer's own rows of a tile it
//   no longer reads and a TMA store.

#include <cuda_bf16.h>

#include "flash_fwd_sm90.cuh"
#include "hopper_sm90.cuh"

namespace {

using flash_fwd::bshd_map;

typedef __nv_bfloat16 bf16;

// ---------------------------------------------------------------------------
// backward: grid (128-row tiles, H, B), 384 threads like the forward
// ---------------------------------------------------------------------------
namespace bwd {
constexpr int kBM = 128;        // rows a block owns: q rows (dq), keys (dk / dv)
constexpr int kBQ = 64;         // q rows of a dk / dv stage
constexpr int kThreads = 384;   // producer warpgroup + two consumers
constexpr float kLog2e = 1.4426950408889634f;
// dq pass: keys of a K / V stage, and the ring's depth
template <int D> __host__ __device__ constexpr int dq_bn() { return D == 128 ? 64 : 128; }
template <int D> __host__ __device__ constexpr int dq_stages() { return D == 128 ? 4 : 3; }
// Q and dO (kBM rows), the stages' K and V, the barriers, 1 KB to align
template <int D> __host__ __device__ constexpr int dq_smem() {
  return (2 * kBM + 2 * dq_stages<D>() * dq_bn<D>()) * D * 2 + 512 + 1024;
}
template <int D> __host__ __device__ constexpr int dkv_stages() { return D == 128 ? 3 : 4; }
// K and V (kBM rows), the stages' Q and dO and their rows' lse and delta,
// the barriers, 1 KB to align
template <int D> __host__ __device__ constexpr int dkv_smem() {
  return (2 * kBM + 2 * dkv_stages<D>() * kBQ) * D * 2 +
         dkv_stages<D>() * 2 * kBQ * 4 + 512 + 1024;
}

// c = A B^T over d (issued, not committed): A is this warpgroup's 64 rows
// and B the N rows of a K-major tile; a_atom / b_atom are the elements of
// one 64-column atom of each tile
template <int D, int N>
__device__ __forceinline__ void ss_product(float (&c)[N / 2], const bf16* A,
                                           int a_atom, const bf16* B,
                                           int b_atom) {
  using namespace hopper;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint64_t da = desc_sw128(A + (kk / 4) * a_atom + (kk % 4) * 16, 0, 1024);
    const uint64_t db = desc_sw128(B + (kk / 4) * b_atom + (kk % 4) * 16, 0, 1024);
    if constexpr (N == 128)
      wgmma_m64n128k16_ss<0>(c, da, db, kk > 0);
    else
      wgmma_m64n64k16_ss<0>(c, da, db, kk > 0);
  }
}

// c += a B (issued, not committed): a in registers, KS steps of 16 rows of
// B, an MN-major tile of D columns whose atoms hold b_atom elements
template <int D, int KS>
__device__ __forceinline__ void rs_product(float (&c)[D / 2],
                                           const uint32_t (&a)[KS][4],
                                           const bf16* B, int b_atom) {
  using namespace hopper;
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    const uint64_t db = desc_sw128(B + kk * 16 * 64, b_atom * 2, 1024);
    if constexpr (D == 128)
      wgmma_m64n128k16_rs<1>(c, a[kk], db, 1);
    else
      wgmma_m64n64k16_rs<1>(c, a[kk], db, 1);
  }
}

// an accumulator in bf16 as the A fragments of 16-column steps
template <int KS>
__device__ __forceinline__ void pack_a(uint32_t (&a)[KS][4],
                                       const float (&c)[KS * 8]) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      a[kk][j] = hopper::pack_bf16(c[8 * kk + 2 * j], c[8 * kk + 2 * j + 1]);
}

// an accumulator of 64 rows x D in bf16 into the warpgroup's rows of a
// swizzled tile (rows: its first row in atom 0; atom: elements of an atom)
template <int D>
__device__ __forceinline__ void stage_rows(const float (&c)[D / 2], bf16* rows,
                                           int atom, int tid) {
  const int t = tid % 4;
  const int rr = (tid / 32) * 16 + (tid % 32) / 4;
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    bf16* at = rows + (i / 8) * atom;
    const int chunk = i % 8;
    *reinterpret_cast<uint32_t*>(at + rr * 64 + ((chunk ^ (rr & 7)) * 8) + 2 * t) =
        hopper::pack_bf16(c[4 * i], c[4 * i + 1]);
    *reinterpret_cast<uint32_t*>(at + (rr + 8) * 64 +
                                 ((chunk ^ ((rr + 8) & 7)) * 8) + 2 * t) =
        hopper::pack_bf16(c[4 * i + 2], c[4 * i + 3]);
  }
}
}  // namespace bwd

// ---------------------------------------------------------------------------
// backward, dq: a block owns 128 q rows and streams K / V tiles
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(bwd::kThreads, 1)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v,
                    const __grid_constant__ CUtensorMap tm_do,
                    const __grid_constant__ CUtensorMap tm_dq,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, int S, int H,
                    int causal, float sm_scale) {
  using namespace hopper;
  constexpr int BN = bwd::dq_bn<D>();
  constexpr int ST = bwd::dq_stages<D>();
  constexpr int NA = D / 64;
  constexpr int kQAtom = bwd::kBM * 64, kKAtom = BN * 64;
  constexpr int kQTile = bwd::kBM * D, kKTile = BN * D;
  const int qt = gridDim.x - 1 - blockIdx.x;     // late (heavy) tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = qt * bwd::kBM;
  const int kend = causal ? min(q0 + bwd::kBM, S) : S;
  const int nkt = (kend + BN - 1) / BN;

  extern __shared__ unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(align_1k(smem_raw));
  bf16* dOs = Qs + kQTile;
  bf16* Ks = dOs + kQTile;
  bf16* Vs = Ks + ST * kKTile;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(Vs + ST * kKTile);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + ST;

  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 8);   // one arrival per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer: Q and dO once, then K and V tiles from the diagonal
    // (or the last) down to 0
    setmaxnreg_dec<24>();   // 128 x (168 - 24) = 256 x (240 - 168)
    if (tid == 0) {
      mbar_expect_tx(q_full, 2 * kQTile * 2);
#pragma unroll
      for (int a = 0; a < NA; ++a) {
        tma_load_4d(Qs + a * kQAtom, &tm_q, q_full, a * 64, h, q0, b);
        tma_load_4d(dOs + a * kQAtom, &tm_do, q_full, a * 64, h, q0, b);
      }
      for (int it = 0; it < nkt; ++it) {
        const int s = it % ST;
        const int k0 = (nkt - 1 - it) * BN;
        mbar_wait(empty + s, ((it / ST) & 1) ^ 1);
        mbar_expect_tx(full + s, 2 * kKTile * 2);
#pragma unroll
        for (int a = 0; a < NA; ++a) {
          tma_load_4d(Ks + s * kKTile + a * kKAtom, &tm_k, full + s, a * 64, h, k0, b);
          tma_load_4d(Vs + s * kKTile + a * kKAtom, &tm_v, full + s, a * 64, h, k0, b);
        }
      }
    }
  } else {
    // ---- consumers: warpgroup cw owns q rows 64 cw .. 64 cw + 63
    setmaxnreg_inc<240>();
    const int cw = wg - 1;
    const int lane = tid % 32;
    const int t = lane % 4;
    const int qw0 = q0 + cw * 64;
    const int qp0 = qw0 + (tid / 32) * 16 + lane / 4, qp1 = qp0 + 8;
    const size_t stat = ((size_t)b * H + h) * S;
    // this thread's rows' lse (in base 2) and delta; 0 past S, whose rows
    // are not stored
    const float lse0 = qp0 < S ? lse[stat + qp0] * bwd::kLog2e : 0.f;
    const float lse1 = qp1 < S ? lse[stat + qp1] * bwd::kLog2e : 0.f;
    const float dl0 = qp0 < S ? delta[stat + qp0] : 0.f;
    const float dl1 = qp1 < S ? delta[stat + qp1] : 0.f;
    const float scale_log2 = sm_scale * bwd::kLog2e;
    bf16* Qw = Qs + cw * 64 * 64;
    const bf16* dOw = dOs + cw * 64 * 64;

    // S and dP of the tile in stage s (issued, not waited for)
    auto first = [&](float (&sc)[BN / 2], float (&dp)[BN / 2], int s) {
      bwd::ss_product<D, BN>(sc, Qw, kQAtom, Ks + s * kKTile, kKAtom);
      bwd::ss_product<D, BN>(dp, dOw, kQAtom, Vs + s * kKTile, kKAtom);
      wgmma_commit();
    };
    // dq += ds K of the tile in stage s (issued, not waited for)
    uint32_t da[BN / 16][4];
    float dq[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;
    auto second = [&](int s) {
      bwd::rs_product<D, BN / 16>(dq, da, Ks + s * kKTile, kKAtom);
      wgmma_commit();
    };
    // p = exp(s scale - lse) in base 2 and ds = p (dp - delta) scale, in
    // dp, of tile it; only a tile that reaches past S or the diagonal is
    // masked
    auto grads = [&](float (&sc)[BN / 2], float (&dp)[BN / 2], int it) {
      const int k0 = (nkt - 1 - it) * BN;
      if (k0 + BN > S || (causal && k0 + BN - 1 > qw0)) {
#pragma unroll
        for (int i = 0; i < BN / 8; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int kpos = k0 + 8 * i + 2 * t + (e & 1);
            const int qp = e < 2 ? qp0 : qp1;
            if (!(kpos < S && (!causal || kpos <= qp))) sc[4 * i + e] = -INFINITY;
          }
      }
#pragma unroll
      for (int i = 0; i < BN / 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = exp2_ftz(fmaf(sc[4 * i + e], scale_log2,
                                        -(e < 2 ? lse0 : lse1)));
          dp[4 * i + e] = p * (dp[4 * i + e] - (e < 2 ? dl0 : dl1)) * sm_scale;
        }
    };
    auto release = [&](int s) {
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + s);
    };

    // Each iteration issues S, dP of tile it and dq += ds K of tile it - 1
    // together and computes tile it's ds while the latter runs.  The two
    // warpgroups take turns to issue (named barriers 3 and 4), so one's ds
    // work runs while the other's products hold the tensor cores; each has
    // nkt + 1 issue points, and warpgroup 1 opens the first turn for
    // warpgroup 0 and skips its last hand-over.
    const int n_issue = nkt + 1;
    int issued = 0;
    auto my_turn = [&]() { named_sync(3 + cw, 256); };
    auto hand_over = [&]() {
      if (++issued < n_issue || cw == 0) named_arrive(3 + (1 - cw), 256);
    };
    if (cw == 1) named_arrive(3, 256);

    mbar_wait(q_full, 0);
    {
      float sc[BN / 2], dp[BN / 2];
      mbar_wait(full, 0);
      my_turn();
      wgmma_fence();
      first(sc, dp, 0);
      hand_over();
      wgmma_wait<0>();
      fence_regs(sc);
      fence_regs(dp);
      grads(sc, dp, 0);
      bwd::pack_a(da, dp);
    }
    for (int it = 1; it < nkt; ++it) {
      const int s = it % ST, sp = (it - 1) % ST;
      float sc[BN / 2], dp[BN / 2];
      mbar_wait(full + s, (it / ST) & 1);
      my_turn();
      wgmma_fence();
      first(sc, dp, s);
      second(sp);
      hand_over();
      wgmma_wait<1>();                           // S, dP done; dq in flight
      fence_regs(sc);
      fence_regs(dp);
      grads(sc, dp, it);
      wgmma_wait<0>();
      fence_regs(dq);
      release(sp);
      bwd::pack_a(da, dp);
    }
    {
      const int sp = (nkt - 1) % ST;
      my_turn();
      wgmma_fence();
      second(sp);
      hand_over();
      wgmma_wait<0>();
      fence_regs(dq);
      release(sp);
    }

    // epilogue: dq through this warpgroup's Q rows and a TMA store
    bwd::stage_rows<D>(dq, Qw, kQAtom, tid);
    fence_proxy_async();
    named_sync(1 + cw, 128);
    if (tid == 0) {
#pragma unroll
      for (int a = 0; a < NA; ++a)
        tma_store_4d(&tm_dq, Qw + a * kQAtom, a * 64, h, qw0, b);
      tma_store_wait();
    }
  }
}

// ---------------------------------------------------------------------------
// backward, dk and dv: a block owns 128 keys and streams Q / dO tiles
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(bwd::kThreads, 1)
flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v,
                     const __grid_constant__ CUtensorMap tm_do,
                     const __grid_constant__ CUtensorMap tm_dk,
                     const __grid_constant__ CUtensorMap tm_dv,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, int S, int H,
                     int causal, float sm_scale) {
  using namespace hopper;
  constexpr int BQ = bwd::kBQ;
  constexpr int ST = bwd::dkv_stages<D>();
  constexpr int NA = D / 64;
  constexpr int kKAtom = bwd::kBM * 64, kQAtom = BQ * 64;
  constexpr int kKTile = bwd::kBM * D, kQTile = BQ * D;
  const int h = blockIdx.y, b = blockIdx.z;
  const int k0 = blockIdx.x * bwd::kBM;   // early k tiles see the most q tiles
  const int qt0 = causal ? k0 / BQ : 0;
  const int nq = (S + BQ - 1) / BQ - qt0;

  extern __shared__ unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(align_1k(smem_raw));
  bf16* Vs = Ks + kKTile;
  bf16* Qs = Vs + kKTile;
  bf16* dOs = Qs + ST * kQTile;
  float* stats = reinterpret_cast<float*>(dOs + ST * kQTile);   // lse, delta
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(stats + ST * 2 * BQ);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + ST;

  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(full + s, 1 + 32);   // the TMA thread and the stats warp
      mbar_init(empty + s, 8);       // one arrival per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer: K and V once, then Q and dO tiles from the diagonal
    // (or 0) to the end by TMA; warp 1 copies the tiles' lse (base 2) and
    // delta, which no TMA map can reach at every S (a row of [B H, S] f32
    // is 16-byte aligned only when S is a multiple of 4)
    setmaxnreg_dec<24>();   // 128 x (168 - 24) = 256 x (240 - 168)
    if (tid == 0) {
      mbar_expect_tx(kv_full, 2 * kKTile * 2);
#pragma unroll
      for (int a = 0; a < NA; ++a) {
        tma_load_4d(Ks + a * kKAtom, &tm_k, kv_full, a * 64, h, k0, b);
        tma_load_4d(Vs + a * kKAtom, &tm_v, kv_full, a * 64, h, k0, b);
      }
      for (int it = 0; it < nq; ++it) {
        const int s = it % ST;
        const int q0 = (qt0 + it) * BQ;
        mbar_wait(empty + s, ((it / ST) & 1) ^ 1);
        mbar_expect_tx(full + s, 2 * kQTile * 2);
#pragma unroll
        for (int a = 0; a < NA; ++a) {
          tma_load_4d(Qs + s * kQTile + a * kQAtom, &tm_q, full + s, a * 64, h, q0, b);
          tma_load_4d(dOs + s * kQTile + a * kQAtom, &tm_do, full + s, a * 64, h, q0, b);
        }
      }
    } else if (tid / 32 == 1) {
      // two rows a lane, kept in pointers and a count of rows left so
      // that the loop fits the producer's 24 registers
      static_assert(BQ == 64, "the stats warp copies two rows a lane");
      const int lane = tid % 32;
      const size_t row = ((size_t)b * H + h) * S + qt0 * BQ + lane;
      const float* lp = lse + row;
      const float* dp = delta + row;
      int left = S - qt0 * BQ - lane;
      for (int it = 0; it < nq; ++it, lp += BQ, dp += BQ, left -= BQ) {
        const int s = it % ST;
        float* st = stats + s * 2 * BQ + lane;
        mbar_wait(empty + s, ((it / ST) & 1) ^ 1);
        st[0] = left > 0 ? lp[0] * bwd::kLog2e : 0.f;
        st[32] = left > 32 ? lp[32] * bwd::kLog2e : 0.f;
        st[BQ] = left > 0 ? dp[0] : 0.f;
        st[BQ + 32] = left > 32 ? dp[32] : 0.f;
        mbar_arrive(full + s);
      }
    }
  } else {
    // ---- consumers: warpgroup cw owns keys 64 cw .. 64 cw + 63 and works
    // on transposed scores (keys x q rows), so that p and ds come out of
    // the accumulators as the A operands of dv += p^T do and dk += ds^T q
    setmaxnreg_inc<240>();
    const int cw = wg - 1;
    const int lane = tid % 32;
    const int t = lane % 4;
    const int kw0 = k0 + cw * 64;
    const int kp0 = kw0 + (tid / 32) * 16 + lane / 4, kp1 = kp0 + 8;
    const float scale_log2 = sm_scale * bwd::kLog2e;
    bf16* Kw = Ks + cw * 64 * 64;
    bf16* Vw = Vs + cw * 64 * 64;

    // S^T and dP^T of the tile in stage s (issued, not waited for)
    auto first = [&](float (&sc)[BQ / 2], float (&dp)[BQ / 2], int s) {
      bwd::ss_product<D, BQ>(sc, Kw, kKAtom, Qs + s * kQTile, kQAtom);
      bwd::ss_product<D, BQ>(dp, Vw, kKAtom, dOs + s * kQTile, kQAtom);
      wgmma_commit();
    };
    // dv += p^T dO and dk += ds^T Q of the tile in stage s (issued, not
    // waited for)
    uint32_t pa[BQ / 16][4], da[BQ / 16][4];
    float dk[D / 2], dv[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;
    auto second = [&](int s) {
      bwd::rs_product<D, BQ / 16>(dv, pa, dOs + s * kQTile, kQAtom);
      bwd::rs_product<D, BQ / 16>(dk, da, Qs + s * kQTile, kQAtom);
      wgmma_commit();
    };
    // p^T and ds^T of tile it in sc and dp; only a tile that reaches past
    // S or crosses the diagonal is masked (on the first, the second
    // warpgroup's keys all lie above it: p is 0 there)
    auto grads = [&](float (&sc)[BQ / 2], float (&dp)[BQ / 2], int it) {
      const int q0 = (qt0 + it) * BQ;
      const float* st = stats + (it % ST) * 2 * BQ;
      if (q0 + BQ > S || (causal && q0 < kw0 + 64)) {
#pragma unroll
        for (int i = 0; i < BQ / 8; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int qpos = q0 + 8 * i + 2 * t + (e & 1);
            const int kpos = e < 2 ? kp0 : kp1;
            if (!(qpos < S && (!causal || kpos <= qpos))) sc[4 * i + e] = -INFINITY;
          }
      }
#pragma unroll
      for (int i = 0; i < BQ / 8; ++i) {
        const float2 l = *reinterpret_cast<const float2*>(st + 8 * i + 2 * t);
        const float2 dl = *reinterpret_cast<const float2*>(st + BQ + 8 * i + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = exp2_ftz(fmaf(sc[4 * i + e], scale_log2,
                                        -((e & 1) ? l.y : l.x)));
          sc[4 * i + e] = p;
          dp[4 * i + e] = p * (dp[4 * i + e] - ((e & 1) ? dl.y : dl.x)) * sm_scale;
        }
      }
    };
    auto release = [&](int s) {
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + s);
    };

    // Each tile: S^T and dP^T, then p and ds on the registers, then the dv
    // and dk products.  (Issuing a tile's first products beside the
    // previous tile's second, as the dq pass does, needs registers for both
    // and spills at d = 128.)  The two warpgroups take turns to issue
    // (named barriers 3 and 4), so one's p and ds work runs while the
    // other's products hold the tensor cores; each has two issue points a
    // tile, and warpgroup 1 opens the first turn for warpgroup 0 and skips
    // its last hand-over.
    const int n_issue = 2 * nq;
    int issued = 0;
    auto my_turn = [&]() { named_sync(3 + cw, 256); };
    auto hand_over = [&]() {
      if (++issued < n_issue || cw == 0) named_arrive(3 + (1 - cw), 256);
    };
    if (cw == 1) named_arrive(3, 256);
    mbar_wait(kv_full, 0);
    for (int it = 0; it < nq; ++it) {
      const int s = it % ST;
      float sc[BQ / 2], dp[BQ / 2];
      mbar_wait(full + s, (it / ST) & 1);
      my_turn();
      wgmma_fence();
      first(sc, dp, s);
      hand_over();
      wgmma_wait<0>();
      fence_regs(sc);
      fence_regs(dp);
      grads(sc, dp, it);
      bwd::pack_a(pa, sc);
      bwd::pack_a(da, dp);
      my_turn();
      wgmma_fence();
      second(s);
      hand_over();
      wgmma_wait<0>();
      fence_regs(dv);
      fence_regs(dk);
      release(s);
    }

    // epilogue: dk and dv through this warpgroup's rows of K and V (no
    // longer read) and TMA stores, which write no row past S
    bwd::stage_rows<D>(dk, Kw, kKAtom, tid);
    bwd::stage_rows<D>(dv, Vw, kKAtom, tid);
    fence_proxy_async();
    named_sync(1 + cw, 128);
    if (tid == 0) {
#pragma unroll
      for (int a = 0; a < NA; ++a) {
        tma_store_4d(&tm_dk, Kw + a * kKAtom, a * 64, h, kw0, b);
        tma_store_4d(&tm_dv, Vw + a * kKAtom, a * 64, h, kw0, b);
      }
      tma_store_wait();
    }
  }
}

template <int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, void* dq, int B, int S,
              int H, int causal, float sm_scale, cudaStream_t stream) {
  constexpr int BN = bwd::dq_bn<D>();
  CUtensorMap mq, mk, mv, mdo, mdq;
  cudaError_t err;
  if ((err = bshd_map(&mq, q, B, S, H, D, bwd::kBM)) ||
      (err = bshd_map(&mdo, dout, B, S, H, D, bwd::kBM)) ||
      (err = bshd_map(&mk, k, B, S, H, D, BN)) ||
      (err = bshd_map(&mv, v, B, S, H, D, BN)) ||
      (err = bshd_map(&mdq, dq, B, S, H, D, 64)))
    return (int)err;
  static bool raised[hopper::kMaxDevices] = {};
  err = hopper::raise_smem(flash_bwd_dq_kernel<D>, bwd::dq_smem<D>(), raised);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((S + bwd::kBM - 1) / bwd::kBM, H, B);
  flash_bwd_dq_kernel<D><<<grid, bwd::kThreads, bwd::dq_smem<D>(), stream>>>(
      mq, mk, mv, mdo, mdq, (const float*)lse, (const float*)delta, S, H,
      causal, sm_scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, void* dk, void* dv, int B,
               int S, int H, int causal, float sm_scale, cudaStream_t stream) {
  CUtensorMap mq, mk, mv, mdo, mdk, mdv;
  cudaError_t err;
  if ((err = bshd_map(&mq, q, B, S, H, D, bwd::kBQ)) ||
      (err = bshd_map(&mdo, dout, B, S, H, D, bwd::kBQ)) ||
      (err = bshd_map(&mk, k, B, S, H, D, bwd::kBM)) ||
      (err = bshd_map(&mv, v, B, S, H, D, bwd::kBM)) ||
      (err = bshd_map(&mdk, dk, B, S, H, D, 64)) ||
      (err = bshd_map(&mdv, dv, B, S, H, D, 64)))
    return (int)err;
  static bool raised[hopper::kMaxDevices] = {};
  err = hopper::raise_smem(flash_bwd_dkv_kernel<D>, bwd::dkv_smem<D>(), raised);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((S + bwd::kBM - 1) / bwd::kBM, H, B);
  flash_bwd_dkv_kernel<D><<<grid, bwd::kThreads, bwd::dkv_smem<D>(), stream>>>(
      mq, mk, mv, mdo, mdk, mdv, (const float*)lse, (const float*)delta, S, H,
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
  const flash_fwd::SegArgs none = {};
  if (d == 128)
    return flash_fwd::launch<128, false>(q, k, v, out, lse, none, B, S, H, H, causal, sm_scale, s);
  if (d == 64)
    return flash_fwd::launch<64, false>(q, k, v, out, lse, none, B, S, H, H, causal, sm_scale, s);
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
