// The FlashAttention backward for Hopper (sm_90a) that the dense kernels
// (K6b, K6c, csrc/flash_attention.cu) and the segmented ones (K7a, K7b,
// csrc/flash_varlen_bwd.cu) share: two kernel templates,
// flash_bwd_dq_kernel<D, Seg> and flash_bwd_dkv_kernel<D, Seg>.
//
// Computes, for q, dout [B, S, H, d] and k, v [B, S, Hkv, d] (H = G * Hkv:
// q head h reads kv head h / G), from the forward's lse [B, H, S] and the
// caller's delta = sum(dout * out) [B, H, S]:
//   dq pass:  p = exp(q k^T / sqrt(d) - lse), dp = dout v^T,
//             ds = p * (dp - delta) / sqrt(d), dq = ds k
//   dkv pass: dv[j] = sum over the q heads h of j's group of p^T dout,
//             dk[j] = the same sum of ds^T q
// over the visible (q, k) pairs.  Dense (Seg false): G = 1, the mask is
// causal or none.  Segmented (Seg true): a key is visible to a row only
// when both carry the same segment id (contiguous runs, seg [B, S] int32)
// and, when causal, it is not after the row.  p and ds are rounded to bf16
// before their second product, as in the TPU kernels.
//
// Two passes, one per pallas_call, so each output is written once: no
// atomics, and dq, dk and dv do not change from run to run.  The price is
// 7 products per visible pair where a fused pass (dq summed across blocks
// by atomics) runs 5.  p = exp2(s * scale * log2 e - lse * log2 e) is
// recomputed from the forward's lse in both.  A block is 384 threads: one
// producer warpgroup, whose thread 0 streams tiles by TMA (4-D tensor maps
// over [B, S, heads, d], so GQA reads the kv head's rows in place) into a
// ring of shared-memory stages (a full and an empty mbarrier each), and two
// consumer warpgroups that run wgmma on the stages as they arrive;
// setmaxnreg moves the producer's registers to the consumers.  Tiles are
// rows of 64 bf16 in the 128-byte swizzle the maps write, read by wgmma
// K-major for A B^T and MN-major for A B, so no tile is ever transposed.
// Scores, p and ds live in the accumulator registers only, re-packed in
// bf16 as the A fragments of the second products.
//
// * dq pass, a block per 128 q rows of one q head, heavy (late) tiles
//   first: the producer loads Q and dO once and streams K and V stages (64
//   keys at d = 128, 128 at d = 64) from the top of the block's key range
//   down.  Dense: from the diagonal (or the last key) to 0.  Segmented:
//   over [kmin, min(kmax, the tile's last row when causal, S - 1)], kmin /
//   kmax the per-128-row-tile range of the forward, so a block visits only
//   the keys of the segments its rows lie in; every head's tile of one
//   index comes before the next (a GQA group's heads neighbours, their K
//   and V stages read while in L2).  Each consumer owns 64 rows: S = Q K^T
//   and dP = dO V^T as wgmma with both operands in shared memory, ds =
//   p (dp - delta) scale on the registers (lse and delta of its two rows
//   per thread in registers), then dq += ds K with ds packed as A and the
//   same K stage as the MN-major B operand.  It issues stage j's S and dP
//   beside stage j - 1's dq product.
// * dk / dv pass, a block per 128 keys of one kv head, heavy (early) tiles
//   first: the producer loads K and V once and streams Q and dO in 64-row
//   stages.  Dense: from the diagonal (or 0) to the end.  Segmented: for
//   each q head of the kv head's group in turn, over [max(qmin, k0 when
//   causal), min(qmax, S - 1)], qmin / qmax the same per-128-row-tile
//   ranges read for the key tile; the producer's loop and the consumers'
//   run over one flattened count (group x stages), which the mbarrier
//   parities and the ping-pong follow.  A second producer warp copies each
//   stage's rows' lse and delta into the stage with plain loads and
//   arrives on its full barrier (at odd S no TMA reaches them);
//   segmented, a third copies their ids, and the producer warpgroup keeps
//   40 registers a thread for these loops (the consumers 232, dense 24 and
//   240).  Each consumer owns 64 keys and works on transposed
//   scores, S^T = K Q^T and dP^T = V dO^T (m64n64k16, both operands in
//   shared memory), so that p^T and ds^T come out of the accumulators as
//   the A fragments of dv += p^T dO and dk += ds^T Q, with the Q and dO
//   stages as MN-major B operands.  dk and dv accumulate in f32 registers
//   across the whole group and are rounded once, as JAX's group sum is.
// * Overlap: the two consumers take turns to issue (ping-pong, named
//   barriers 3 and 4), so one's exp / ds work runs under the other's
//   products; the dk / dv pass cannot also overlap its own two products
//   (dk, dv, S^T and dP^T fill the registers at d = 128).
// * Masks run in a loop of their own, on the tiles that need one, never
//   per element in the exp loop (that cost 20-25%).  Dense: a tile that
//   crosses the consumer's diagonal or holds rows / keys past S.
//   Segmented, also: every tile unless the whole 128-row tile of the
//   block (q rows for dq, keys for dk / dv) lies in one segment and the
//   stage lies in that segment's [first, last] row.  A masked segmented
//   tile compares ids: the dq pass's key ids come into the stage (a second
//   producer warp, plain loads, arriving on the stage's full barrier) and
//   its rows' ids sit in registers beside lse and delta; the
//   dk / dv pass's keys' ids sit in registers and its rows' ids come into
//   the stage beside their lse.  Rows and keys at or past S are masked by
//   position, since a TMA zero fill would read as id 0, a real segment.
// * Both write their results through the consumer's own rows of a tile it
//   no longer reads and a TMA store, which writes no row past S.  A dk / dv
//   block whose range is empty still writes zeros, and its hand-overs
//   balance.

#pragma once

#include <cuda_bf16.h>

#include "flash_fwd_sm90.cuh"
#include "hopper_sm90.cuh"

namespace flash_bwd {

using flash_fwd::SegArgs;
using flash_fwd::bshd_map;

typedef __nv_bfloat16 bf16;

constexpr int kBM = 128;        // rows a block owns: q rows (dq), keys (dk / dv)
constexpr int kBQ = 64;         // q rows of a dk / dv stage
constexpr int kThreads = 384;   // producer warpgroup + two consumers
constexpr float kLog2e = 1.4426950408889634f;
// dq pass: keys of a K / V stage, and the ring's depth
template <int D> __host__ __device__ constexpr int dq_bn() { return D == 128 ? 64 : 128; }
template <int D> __host__ __device__ constexpr int dq_stages() { return D == 128 ? 4 : 3; }
// Q and dO (kBM rows), the stages' K and V, the segmented kernel's key-id
// stages, the barriers, 1 KB to align
template <int D, bool Seg> __host__ __device__ constexpr int dq_smem() {
  return (2 * kBM + 2 * dq_stages<D>() * dq_bn<D>()) * D * 2 +
         (Seg ? dq_stages<D>() * dq_bn<D>() * 4 : 0) + 512 + 1024;
}
template <int D> __host__ __device__ constexpr int dkv_stages() { return D == 128 ? 3 : 4; }
// floats a dk / dv stage carries per q row: lse and delta (and the id)
template <bool Seg> __host__ __device__ constexpr int dkv_stats() { return Seg ? 3 : 2; }
// K and V (kBM rows), the stages' Q and dO and their rows' stats, the
// barriers, 1 KB to align
template <int D, bool Seg> __host__ __device__ constexpr int dkv_smem() {
  return (2 * kBM + 2 * dkv_stages<D>() * kBQ) * D * 2 +
         dkv_stages<D>() * dkv_stats<Seg>() * kBQ * 4 + 512 + 1024;
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

// ---------------------------------------------------------------------------
// dq: a block owns 128 q rows and streams K / V stages.  Grid (ceil(S /
// kBM), H, B) dense, (ceil(S / kBM) * H, 1, B) segmented; kThreads threads,
// dq_smem<D, Seg>()
// ---------------------------------------------------------------------------
template <int D, bool Seg>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v,
                    const __grid_constant__ CUtensorMap tm_do,
                    const __grid_constant__ CUtensorMap tm_dq,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, const SegArgs sa, int S,
                    int H, int G, int causal, float sm_scale) {
  using namespace hopper;
  constexpr int BN = dq_bn<D>();
  constexpr int ST = dq_stages<D>();
  constexpr int NA = D / 64;
  constexpr int kQAtom = kBM * 64, kKAtom = BN * 64;
  constexpr int kQTile = kBM * D, kKTile = BN * D;
  const int nqt = (S + kBM - 1) / kBM;
  // late (heavy) q tiles first: dense, a head's tiles are neighbours;
  // segmented, every head's tile of one index is (a GQA group's heads
  // next to each other)
  const int qt = nqt - 1 - (int)blockIdx.x / (Seg ? H : 1);
  const int h = Seg ? (int)blockIdx.x % H : blockIdx.y;
  const int hk = Seg ? h / G : h;
  const int b = blockIdx.z;
  const int q0 = qt * kBM;

  // key stages kt_hi down to kt_lo; segmented: free_lo .. free_hi lie in
  // the one segment of the whole q tile (a diagonal or a stage past S is
  // masked all the same)
  int kt_lo = 0, kt_hi, free_lo = 1, free_hi = 0;
  const int* segb = nullptr;
  if constexpr (Seg) {
    segb = sa.seg + (size_t)b * S;
    const int i = b * nqt + qt;
    const int lo = sa.kmin[i], top = sa.kmax[i];
    int hi = causal ? min(top, q0 + kBM - 1) : top;
    hi = min(hi, S - 1);
    kt_lo = lo / BN;
    kt_hi = hi / BN;
    if (q0 + kBM <= S && segb[q0] == segb[q0 + kBM - 1]) {
      free_lo = (lo + BN - 1) / BN;
      free_hi = (top + 1) / BN - 1;
    }
  } else {
    const int kend = causal ? min(q0 + kBM, S) : S;
    kt_hi = (kend + BN - 1) / BN - 1;
  }
  const int nkt = kt_hi - kt_lo + 1;

  extern __shared__ unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(align_1k(smem_raw));
  bf16* dOs = Qs + kQTile;
  bf16* Ks = dOs + kQTile;
  bf16* Vs = Ks + ST * kKTile;
  int* Ids = reinterpret_cast<int*>(Vs + ST * kKTile);   // segmented only
  uint64_t* q_full = reinterpret_cast<uint64_t*>(Ids + (Seg ? ST * BN : 0));
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + ST;

  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(full + s, Seg ? 1 + 32 : 1);   // the TMA thread (and the id warp)
      mbar_init(empty + s, 8);                 // one arrival per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer: Q and dO once, then K and V stages from the top of
    // the key range down; segmented, warp 1 copies each stage's key ids
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
        const int k0 = (kt_hi - it) * BN;
        mbar_wait(empty + s, ((it / ST) & 1) ^ 1);
        mbar_expect_tx(full + s, 2 * kKTile * 2);
#pragma unroll
        for (int a = 0; a < NA; ++a) {
          tma_load_4d(Ks + s * kKTile + a * kKAtom, &tm_k, full + s, a * 64, hk, k0, b);
          tma_load_4d(Vs + s * kKTile + a * kKAtom, &tm_v, full + s, a * 64, hk, k0, b);
        }
      }
    } else if (Seg && tid / 32 == 1) {
      // the stages' key ids, BN / 32 a lane (ids past S are never read:
      // those keys are masked by position)
      const int lane = tid % 32;
      for (int it = 0; it < nkt; ++it) {
        const int s = it % ST;
        const int k0 = (kt_hi - it) * BN + lane;
        mbar_wait(empty + s, ((it / ST) & 1) ^ 1);
#pragma unroll
        for (int j = 0; j < BN; j += 32)
          Ids[s * BN + lane + j] = k0 + j < S ? segb[k0 + j] : -1;
        mbar_arrive(full + s);
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
    const float lse0 = qp0 < S ? lse[stat + qp0] * kLog2e : 0.f;
    const float lse1 = qp1 < S ? lse[stat + qp1] * kLog2e : 0.f;
    const float dl0 = qp0 < S ? delta[stat + qp0] : 0.f;
    const float dl1 = qp1 < S ? delta[stat + qp1] : 0.f;
    int sq0 = 0, sq1 = 0;                        // and their segment ids
    if constexpr (Seg) {
      sq0 = qp0 < S ? segb[qp0] : 0;
      sq1 = qp1 < S ? segb[qp1] : 0;
    }
    const float scale_log2 = sm_scale * kLog2e;
    bf16* Qw = Qs + cw * 64 * 64;
    const bf16* dOw = dOs + cw * 64 * 64;

    // S and dP of the stage s (issued, not waited for)
    auto first = [&](float (&sc)[BN / 2], float (&dp)[BN / 2], int s) {
      ss_product<D, BN>(sc, Qw, kQAtom, Ks + s * kKTile, kKAtom);
      ss_product<D, BN>(dp, dOw, kQAtom, Vs + s * kKTile, kKAtom);
      wgmma_commit();
    };
    // dq += ds K of the stage s (issued, not waited for)
    uint32_t da[BN / 16][4];
    float dq[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;
    auto second = [&](int s) {
      rs_product<D, BN / 16>(dq, da, Ks + s * kKTile, kKAtom);
      wgmma_commit();
    };
    // p = exp(s scale - lse) in base 2 and ds = p (dp - delta) scale, in
    // dp, of stage it; only a stage that reaches past S or the diagonal
    // (segmented: or out of the q tile's one segment) is masked
    auto grads = [&](float (&sc)[BN / 2], float (&dp)[BN / 2], int it) {
      const int kt = kt_hi - it;
      const int k0 = kt * BN;
      bool masked = k0 + BN > S || (causal && k0 + BN - 1 > qw0);
      if constexpr (Seg) masked = masked || kt < free_lo || kt > free_hi;
      if (masked) {
        if constexpr (Seg) {
          const int* ids = Ids + (it % ST) * BN;
#pragma unroll
          for (int i = 0; i < BN / 8; ++i) {
            const int2 kid = *reinterpret_cast<const int2*>(ids + 8 * i + 2 * t);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int kpos = k0 + 8 * i + 2 * t + (e & 1);
              const int qp = e < 2 ? qp0 : qp1;
              const bool vis = kpos < S &&
                               ((e & 1) ? kid.y : kid.x) == (e < 2 ? sq0 : sq1) &&
                               (!causal || kpos <= qp);
              if (!vis) sc[4 * i + e] = -INFINITY;
            }
          }
        } else {
#pragma unroll
          for (int i = 0; i < BN / 8; ++i)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int kpos = k0 + 8 * i + 2 * t + (e & 1);
              const int qp = e < 2 ? qp0 : qp1;
              if (!(kpos < S && (!causal || kpos <= qp))) sc[4 * i + e] = -INFINITY;
            }
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

    // Each iteration issues S, dP of stage it and dq += ds K of stage
    // it - 1 together and computes stage it's ds while the latter runs.
    // The two warpgroups take turns to issue (named barriers 3 and 4), so
    // one's ds work runs while the other's products hold the tensor cores;
    // each has nkt + 1 issue points, and warpgroup 1 opens the first turn
    // for warpgroup 0 and skips its last hand-over.
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
      pack_a(da, dp);
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
      pack_a(da, dp);
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
    stage_rows<D>(dq, Qw, kQAtom, tid);
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
// dk and dv: a block owns 128 keys of one kv head and streams Q / dO
// stages (segmented: of each q head of its group in turn).  Grid (ceil(S /
// kBM), H, B) dense, (Hkv * B, ceil(S / kBM), 1) segmented; kThreads
// threads, dkv_smem<D, Seg>()
// ---------------------------------------------------------------------------
template <int D, bool Seg>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v,
                     const __grid_constant__ CUtensorMap tm_do,
                     const __grid_constant__ CUtensorMap tm_dk,
                     const __grid_constant__ CUtensorMap tm_dv,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, const SegArgs sa, int S,
                     int H, int G, int causal, float sm_scale) {
  using namespace hopper;
  constexpr int BQ = kBQ;
  constexpr int ST = dkv_stages<D>();
  constexpr int NS = dkv_stats<Seg>() * BQ;      // stats floats a stage
  // registers a producer / consumer thread keeps: 128 x (168 - 24) =
  // 256 x (240 - 168); segmented, the producer's loops over the group need
  // more than 24, and 128 x (168 - 40) = 256 x (232 - 168)
  constexpr int kProducerRegs = Seg ? 40 : 24, kConsumerRegs = Seg ? 232 : 240;
  constexpr int NA = D / 64;
  constexpr int kKAtom = kBM * 64, kQAtom = BQ * 64;
  constexpr int kKTile = kBM * D, kQTile = BQ * D;
  // early (heavy) key tiles first.  Dense: a head's tiles are neighbours.
  // Segmented: every row's and kv head's tile of one index comes before
  // the next, so that the last blocks to start are the late, light tiles
  // (a tile's q range ends at its segment's end, at most S)
  const int nkv = Seg ? H / G : H;
  const int kt = Seg ? (int)blockIdx.y : (int)blockIdx.x;
  const int hk = Seg ? (int)blockIdx.x % nkv : (int)blockIdx.y;
  const int b = Seg ? (int)blockIdx.x / nkv : (int)blockIdx.z;
  const int k0 = kt * kBM;

  // q stages qs_lo .. qs_lo + nq - 1 of each head; segmented, those inside
  // [qmin, qmax] lie in the one segment of the whole key tile (when it has
  // one: a diagonal or a stage past S is masked all the same)
  int qs_lo, nq, qmin = 0, qmax = -1;
  const int* segb = nullptr;
  if constexpr (Seg) {
    segb = sa.seg + (size_t)b * S;
    const int i = b * (int)gridDim.y + kt;
    const int lo = causal ? max(sa.kmin[i], k0) : sa.kmin[i];
    const int hi = min(sa.kmax[i], S - 1);
    qs_lo = lo / BQ;
    nq = hi >= lo ? hi / BQ - qs_lo + 1 : 0;
    if (k0 + kBM <= S && segb[k0] == segb[k0 + kBM - 1]) {
      qmin = sa.kmin[i];
      qmax = sa.kmax[i];
    }
  } else {
    qs_lo = causal ? k0 / BQ : 0;
    nq = (S + BQ - 1) / BQ - qs_lo;
  }
  const int ntot = Seg ? G * nq : nq;   // stages over the group's heads

  extern __shared__ unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(align_1k(smem_raw));
  bf16* Vs = Ks + kKTile;
  bf16* Qs = Vs + kKTile;
  bf16* dOs = Qs + ST * kQTile;
  float* stats = reinterpret_cast<float*>(dOs + ST * kQTile);   // lse, delta (, ids)
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(stats + ST * NS);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + ST;

  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < ST; ++s) {
      // the TMA thread and the stats warp (segmented: and the id warp)
      mbar_init(full + s, Seg ? 1 + 64 : 1 + 32);
      mbar_init(empty + s, 8);       // one arrival per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer: K and V once, then Q and dO stages by TMA; warp 1
    // copies the stages' lse (base 2) and delta (segmented: warp 2 the
    // rows' ids), which no TMA map can reach at every S (a row of [B H, S]
    // f32 is 16-byte aligned only when S is a multiple of 4)
    setmaxnreg_dec<kProducerRegs>();
    if (tid == 0) {
      mbar_expect_tx(kv_full, 2 * kKTile * 2);
#pragma unroll
      for (int a = 0; a < NA; ++a) {
        tma_load_4d(Ks + a * kKAtom, &tm_k, kv_full, a * 64, hk, k0, b);
        tma_load_4d(Vs + a * kKAtom, &tm_v, kv_full, a * 64, hk, k0, b);
      }
      int h = hk, j = 0;   // segmented: stage j of q head h
      if constexpr (Seg) h = hk * G;
      for (int it = 0; it < ntot; ++it) {
        const int s = it % ST;
        const int q0 = (qs_lo + (Seg ? j : it)) * BQ;
        mbar_wait(empty + s, ((it / ST) & 1) ^ 1);
        mbar_expect_tx(full + s, 2 * kQTile * 2);
#pragma unroll
        for (int a = 0; a < NA; ++a) {
          tma_load_4d(Qs + s * kQTile + a * kQAtom, &tm_q, full + s, a * 64, h, q0, b);
          tma_load_4d(dOs + s * kQTile + a * kQAtom, &tm_do, full + s, a * 64, h, q0, b);
        }
        if (Seg && ++j == nq) {
          j = 0;
          ++h;
        }
      }
    } else if (tid / 32 == 1) {
      // two rows a lane, kept in pointers and a count of rows left so
      // that the loop fits the producer's 24 registers
      static_assert(BQ == 64, "the stats warp copies two rows a lane");
      const int lane = tid % 32;
      if constexpr (Seg) {
        // the dense loop once per head of the group, over one count
        for (int g = 0, it = 0; g < G; ++g) {
          const size_t row = ((size_t)b * H + hk * G + g) * S + qs_lo * BQ + lane;
          const float* lp = lse + row;
          const float* dp = delta + row;
          int left = S - qs_lo * BQ - lane;
          for (int j = 0; j < nq; ++j, ++it, lp += BQ, dp += BQ, left -= BQ) {
            const int s = it % ST;
            float* st = stats + s * NS + lane;
            mbar_wait(empty + s, ((it / ST) & 1) ^ 1);
            st[0] = left > 0 ? lp[0] * kLog2e : 0.f;
            st[32] = left > 32 ? lp[32] * kLog2e : 0.f;
            st[BQ] = left > 0 ? dp[0] : 0.f;
            st[BQ + 32] = left > 32 ? dp[32] : 0.f;
            mbar_arrive(full + s);
          }
        }
      } else {
        const size_t row = ((size_t)b * H + hk) * S + qs_lo * BQ + lane;
        const float* lp = lse + row;
        const float* dp = delta + row;
        int left = S - qs_lo * BQ - lane;
        for (int it = 0; it < nq; ++it, lp += BQ, dp += BQ, left -= BQ) {
          const int s = it % ST;
          float* st = stats + s * NS + lane;
          mbar_wait(empty + s, ((it / ST) & 1) ^ 1);
          st[0] = left > 0 ? lp[0] * kLog2e : 0.f;
          st[32] = left > 32 ? lp[32] * kLog2e : 0.f;
          st[BQ] = left > 0 ? dp[0] : 0.f;
          st[BQ + 32] = left > 32 ? dp[32] : 0.f;
          mbar_arrive(full + s);
        }
      }
    } else if (Seg && tid / 32 == 2) {
      // segmented: warp 2 copies the stages' rows' ids, the same for each
      // head of the group (ids past S are never read: those rows are
      // masked by position)
      const int lane = tid % 32;
      for (int g = 0, it = 0; g < G; ++g) {
        const int* ip = segb + qs_lo * BQ + lane;
        int left = S - qs_lo * BQ - lane;
        for (int j = 0; j < nq; ++j, ++it, ip += BQ, left -= BQ) {
          const int s = it % ST;
          int* sid = reinterpret_cast<int*>(stats + s * NS + 2 * BQ) + lane;
          mbar_wait(empty + s, ((it / ST) & 1) ^ 1);
          sid[0] = left > 0 ? ip[0] : -1;
          sid[32] = left > 32 ? ip[32] : -1;
          mbar_arrive(full + s);
        }
      }
    }
  } else {
    // ---- consumers: warpgroup cw owns keys 64 cw .. 64 cw + 63 and works
    // on transposed scores (keys x q rows), so that p and ds come out of
    // the accumulators as the A operands of dv += p^T do and dk += ds^T q
    setmaxnreg_inc<kConsumerRegs>();
    const int cw = wg - 1;
    const int lane = tid % 32;
    const int t = lane % 4;
    const int kw0 = k0 + cw * 64;
    const int kp0 = kw0 + (tid / 32) * 16 + lane / 4, kp1 = kp0 + 8;
    int sk0 = 0, sk1 = 0;                        // the keys' segment ids
    if constexpr (Seg) {
      sk0 = kp0 < S ? segb[kp0] : 0;
      sk1 = kp1 < S ? segb[kp1] : 0;
    }
    const float scale_log2 = sm_scale * kLog2e;
    bf16* Kw = Ks + cw * 64 * 64;
    bf16* Vw = Vs + cw * 64 * 64;

    // S^T and dP^T of the stage s (issued, not waited for)
    auto first = [&](float (&sc)[BQ / 2], float (&dp)[BQ / 2], int s) {
      ss_product<D, BQ>(sc, Kw, kKAtom, Qs + s * kQTile, kQAtom);
      ss_product<D, BQ>(dp, Vw, kKAtom, dOs + s * kQTile, kQAtom);
      wgmma_commit();
    };
    // dv += p^T dO and dk += ds^T Q of the stage s (issued, not waited
    // for)
    uint32_t pa[BQ / 16][4], da[BQ / 16][4];
    float dk[D / 2], dv[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;
    auto second = [&](int s) {
      rs_product<D, BQ / 16>(dv, pa, dOs + s * kQTile, kQAtom);
      rs_product<D, BQ / 16>(dk, da, Qs + s * kQTile, kQAtom);
      wgmma_commit();
    };
    // p^T and ds^T of stage it in sc and dp; only a stage that reaches past
    // S or crosses the diagonal (segmented: or leaves the key tile's one
    // segment) is masked (on the diagonal, the second warpgroup's keys all
    // lie above it: p is 0 there)
    auto grads = [&](float (&sc)[BQ / 2], float (&dp)[BQ / 2], int it,
                     int q0) {
      const float* st = stats + (it % ST) * NS;
      bool masked = q0 + BQ > S || (causal && q0 < kw0 + 64);
      if constexpr (Seg) masked = masked || q0 < qmin || q0 + BQ - 1 > qmax;
      if (masked) {
        if constexpr (Seg) {
          const int* ids = reinterpret_cast<const int*>(st + 2 * BQ);
#pragma unroll
          for (int i = 0; i < BQ / 8; ++i) {
            const int2 qid = *reinterpret_cast<const int2*>(ids + 8 * i + 2 * t);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int qpos = q0 + 8 * i + 2 * t + (e & 1);
              const int kpos = e < 2 ? kp0 : kp1;
              const bool vis = qpos < S &&
                               ((e & 1) ? qid.y : qid.x) == (e < 2 ? sk0 : sk1) &&
                               (!causal || kpos <= qpos);
              if (!vis) sc[4 * i + e] = -INFINITY;
            }
          }
        } else {
#pragma unroll
          for (int i = 0; i < BQ / 8; ++i)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int qpos = q0 + 8 * i + 2 * t + (e & 1);
              const int kpos = e < 2 ? kp0 : kp1;
              if (!(qpos < S && (!causal || kpos <= qpos))) sc[4 * i + e] = -INFINITY;
            }
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

    // Each stage: S^T and dP^T, then p and ds on the registers, then the dv
    // and dk products.  (Issuing a stage's first products beside the
    // previous stage's second, as the dq pass does, needs registers for
    // both and spills at d = 128.)  The two warpgroups take turns to issue
    // (named barriers 3 and 4), so one's p and ds work runs while the
    // other's products hold the tensor cores; each has two issue points a
    // stage, and warpgroup 1 opens the first turn for warpgroup 0 (when
    // there is one) and skips its last hand-over.
    const int n_issue = 2 * ntot;
    int issued = 0;
    auto my_turn = [&]() { named_sync(3 + cw, 256); };
    auto hand_over = [&]() {
      if (++issued < n_issue || cw == 0) named_arrive(3 + (1 - cw), 256);
    };
    if (cw == 1 && (!Seg || n_issue > 0)) named_arrive(3, 256);
    mbar_wait(kv_full, 0);
    int j = 0;   // segmented: the stage's index within its head
    for (int it = 0; it < ntot; ++it) {
      const int s = it % ST;
      const int q0 = (qs_lo + (Seg ? j : it)) * BQ;
      if (Seg && ++j == nq) j = 0;
      float sc[BQ / 2], dp[BQ / 2];
      mbar_wait(full + s, (it / ST) & 1);
      my_turn();
      wgmma_fence();
      first(sc, dp, s);
      hand_over();
      wgmma_wait<0>();
      fence_regs(sc);
      fence_regs(dp);
      grads(sc, dp, it, q0);
      pack_a(pa, sc);
      pack_a(da, dp);
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
    stage_rows<D>(dk, Kw, kKAtom, tid);
    stage_rows<D>(dv, Vw, kKAtom, tid);
    fence_proxy_async();
    named_sync(1 + cw, 128);
    if (tid == 0) {
#pragma unroll
      for (int a = 0; a < NA; ++a) {
        tma_store_4d(&tm_dk, Kw + a * kKAtom, a * 64, hk, kw0, b);
        tma_store_4d(&tm_dv, Vw + a * kKAtom, a * 64, hk, kw0, b);
      }
      tma_store_wait();
    }
  }
}

// q, dout, dq [B, S, H, d], k, v [B, S, Hkv, d] bf16, lse, delta [B, H, S]
// f32 (all contiguous, 16-byte aligned; H a multiple of Hkv; d 64 or 128);
// sa: the segmented kernel's ids and per-128-row-tile key ranges.  Each
// returns the launch's cudaError_t.  Static: its flag of raised devices
// stays the library's own (a template's local static is one object per
// process otherwise, shared with another tree's library loaded beside it).
template <int D, bool Seg>
static int launch_dq(const void* q, const void* k, const void* v,
                     const void* dout, const void* lse, const void* delta,
                     void* dq, SegArgs sa, int B, int S, int H, int Hkv,
                     int causal, float sm_scale, cudaStream_t stream) {
  constexpr int BN = dq_bn<D>();
  CUtensorMap mq, mk, mv, mdo, mdq;
  cudaError_t err;
  if ((err = bshd_map(&mq, q, B, S, H, D, kBM)) ||
      (err = bshd_map(&mdo, dout, B, S, H, D, kBM)) ||
      (err = bshd_map(&mk, k, B, S, Hkv, D, BN)) ||
      (err = bshd_map(&mv, v, B, S, Hkv, D, BN)) ||
      (err = bshd_map(&mdq, dq, B, S, H, D, 64)))
    return (int)err;
  static bool raised[hopper::kMaxDevices] = {};
  err = hopper::raise_smem(flash_bwd_dq_kernel<D, Seg>, dq_smem<D, Seg>(), raised);
  if (err != cudaSuccess) return (int)err;
  const int nqt = (S + kBM - 1) / kBM;
  const dim3 grid(Seg ? nqt * H : nqt, Seg ? 1 : H, B);
  flash_bwd_dq_kernel<D, Seg><<<grid, kThreads, dq_smem<D, Seg>(), stream>>>(
      mq, mk, mv, mdo, mdq, (const float*)lse, (const float*)delta, sa, S, H,
      H / Hkv, causal, sm_scale);
  return (int)cudaGetLastError();
}

template <int D, bool Seg>
static int launch_dkv(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* delta,
                      void* dk, void* dv, SegArgs sa, int B, int S, int H,
                      int Hkv, int causal, float sm_scale,
                      cudaStream_t stream) {
  CUtensorMap mq, mk, mv, mdo, mdk, mdv;
  cudaError_t err;
  if ((err = bshd_map(&mq, q, B, S, H, D, kBQ)) ||
      (err = bshd_map(&mdo, dout, B, S, H, D, kBQ)) ||
      (err = bshd_map(&mk, k, B, S, Hkv, D, kBM)) ||
      (err = bshd_map(&mv, v, B, S, Hkv, D, kBM)) ||
      (err = bshd_map(&mdk, dk, B, S, Hkv, D, 64)) ||
      (err = bshd_map(&mdv, dv, B, S, Hkv, D, 64)))
    return (int)err;
  static bool raised[hopper::kMaxDevices] = {};
  err = hopper::raise_smem(flash_bwd_dkv_kernel<D, Seg>, dkv_smem<D, Seg>(), raised);
  if (err != cudaSuccess) return (int)err;
  const int nkt = (S + kBM - 1) / kBM;
  const dim3 grid(Seg ? Hkv * B : nkt, Seg ? nkt : Hkv, Seg ? 1 : B);
  flash_bwd_dkv_kernel<D, Seg><<<grid, kThreads, dkv_smem<D, Seg>(), stream>>>(
      mq, mk, mv, mdo, mdk, mdv, (const float*)lse, (const float*)delta, sa, S,
      H, H / Hkv, causal, sm_scale);
  return (int)cudaGetLastError();
}

}  // namespace flash_bwd
