// The FlashAttention forward for Hopper (sm_90a) that the dense kernel (K6a,
// csrc/flash_attention.cu) and the segmented one (K2, csrc/flash_varlen.cu)
// share: one kernel template, flash_fwd_kernel<D, Seg>.
//
// Computes, for q [B, S, H, d] and k, v [B, S, Hkv, d] (H = G * Hkv: q head
// h reads kv head h / G), out = softmax(q k^T / sqrt(d) + mask) v and the
// natural-log lse[b, h, i] of each row's softmax sum.  Dense (Seg false):
// G = 1, the mask is causal or none.  Segmented (Seg true): a key is
// visible to a row only when both carry the same segment id (contiguous
// runs, seg [B, S] int32) and, when causal, it is not after the row.
//
// A block of 384 threads owns a 128-row q tile of one (batch row, q head):
// * The producer warpgroup's thread 0 loads Q once and streams K and V in
//   128-key tiles by TMA (4-D tensor maps over [B, S, H, d], so GQA reads
//   the kv head's rows in place) into a ring (2 stages at d = 128, 3 at
//   d = 64); K and V have their own full and empty mbarriers, so a K stage
//   is refilled once S is computed and a V stage once P V is.
// * Two consumer warpgroups own 64 q rows each.  S = Q K^T is wgmma
//   m64n128k16 with both operands in shared memory; the online softmax runs
//   on the accumulator registers in base 2; P is rounded to bf16 and
//   re-packed in registers as the A fragments of O += P V (V the MN-major
//   B operand).  Each consumer issues S of tile j beside P V of tile j - 1
//   and does tile j's softmax while P V runs; the two take turns to issue
//   (named barriers, "ping-pong").
// * Key tiles are visited from the top (the diagonal, or the last) down.
//   Masks run in a loop of their own on the tiles that need one, so the
//   others' exp loop carries no test.  Dense: only the first tile visited
//   (the diagonal, or the one holding keys past a ragged S).  Segmented:
//   the block visits the key tiles from the first row of the first segment
//   its q tile touches to min(the end of its last segment, its last row)
//   (kmin / kmax, per 128-row q tile, from the wrapper); a tile needs no
//   mask when the whole q tile lies in one segment (its first and last rows
//   carry one id inside S), the key tile lies in that segment, and, when
//   causal, wholly below the diagonal.  A second producer warp copies each
//   key tile's ids into a ring of its own (plain loads; its full barrier
//   takes the warp's 32 arrivals); a masked tile compares them with the
//   row's id and masks keys at or past S by position, since TMA's zero
//   fill would read as id 0, a real segment.
// * Masked scores are -inf, and the row maximum is taken as 0 while it is
//   -inf, so exp2(s - m) of a masked key and the rescale exp2(m_old - m)
//   of a row with no visible key yet are exactly 0, never -inf - (-inf):
//   the same result as JAX's finite NEG_INF with p zeroed on the mask.
//   The epilogue keeps l_safe = max(l, 1e-30).
// * Grid order: late (heavy) q tiles first.  The dense kernel keeps a
//   head's q tiles together, so its K and V stay in L2; the segmented one
//   (a stream's K and V are a few MB) takes every head's q tile of one
//   index before the next, so the heaviest blocks start first and the
//   grid's tail is short.  GQA: q head h reads kv head h / G, and a
//   group's q heads are neighbours in the grid, so their shared K / V
//   tiles are loaded while still in L2.
// * out goes back through each consumer's own rows of the Q tile and a TMA
//   store, which writes no row past S; lse is written for rows < S only.

#pragma once

#include <cuda_bf16.h>

#include "hopper_sm90.cuh"

namespace flash_fwd {

typedef __nv_bfloat16 bf16;

constexpr int kBM = 128;        // q rows of a block, 64 per consumer
constexpr int kBN = 128;        // keys of a tile
constexpr int kThreads = 384;   // producer warpgroup + two consumers
template <int D> __host__ __device__ constexpr int stages() { return D == 128 ? 2 : 3; }
// Q, the stages' K and V tiles (kBM == kBN rows of d), the segmented
// kernel's key-id stages, the barriers, and 1 KB to align the start
template <int D, bool Seg> __host__ __device__ constexpr int smem_bytes() {
  return (1 + 2 * stages<D>()) * kBN * D * 2 + (Seg ? stages<D>() * kBN * 4 : 0) +
         512 + 1024;
}

// The segmented kernel's segment ids [B, S] and its per-q-tile key range
// kmin / kmax [B, ceil(S / kBM)] (inclusive rows); unused by the dense one.
struct SegArgs {
  const int* seg;
  const int* kmin;
  const int* kmax;
};

// grid (ceil(S / kBM), H, B) dense, (ceil(S / kBM) * H, 1, B) segmented;
// kThreads threads, smem_bytes<D, Seg>()
template <int D, bool Seg>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap tm_q,
                 const __grid_constant__ CUtensorMap tm_k,
                 const __grid_constant__ CUtensorMap tm_v,
                 const __grid_constant__ CUtensorMap tm_o,
                 float* __restrict__ lse, const SegArgs sa, int S, int H,
                 int G, int causal, float scale_log2) {
  using namespace hopper;
  constexpr int ST = stages<D>();
  constexpr int kAtom = kBN * 64;                // one 64-column atom of a tile
  constexpr int kTile = kBN * D;                 // elements of a tile
  constexpr uint32_t kTileBytes = kTile * 2;
  constexpr int NA = D / 64;
  const int nqt = (S + kBM - 1) / kBM;
  // late (heavy) q tiles first: dense, a head's tiles are neighbours;
  // segmented, every head's tile of one index is (a GQA group's heads
  // next to each other)
  const int qt = nqt - 1 - (int)blockIdx.x / (Seg ? H : 1);
  const int h = Seg ? (int)blockIdx.x % H : blockIdx.y;
  const int hk = h / G;
  const int b = blockIdx.z;
  const int q0 = qt * kBM;

  // key tiles kt_hi down to kt_lo; segmented: free_lo .. free_hi need no mask
  int kt_lo = 0, kt_hi, free_lo = 1, free_hi = 0;
  const int* segb = nullptr;
  if constexpr (Seg) {
    segb = sa.seg + (size_t)b * S;
    const int i = b * nqt + qt;
    const int lo = sa.kmin[i];
    int hi = sa.kmax[i];
    if (causal) hi = min(hi, q0 + kBM - 1);
    hi = min(hi, S - 1);
    kt_lo = lo / kBN;
    kt_hi = hi / kBN;
    if (q0 + kBM <= S && segb[q0] == segb[q0 + kBM - 1]) {
      // one segment, [kmin, kmax], holds the whole q tile
      free_lo = (lo + kBN - 1) / kBN;
      free_hi = causal ? qt - 1 : (sa.kmax[i] + 1) / kBN - 1;
    }
  } else {
    kt_hi = causal ? qt : (S + kBN - 1) / kBN - 1;
  }
  const int nkt = kt_hi - kt_lo + 1;

  extern __shared__ unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(align_1k(smem_raw));
  bf16* Ks = Qs + kTile;
  bf16* Vs = Ks + ST * kTile;
  int* Ids = reinterpret_cast<int*>(Vs + ST * kTile);   // segmented only
  uint64_t* q_full = reinterpret_cast<uint64_t*>(Ids + (Seg ? ST * kBN : 0));
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + ST;
  uint64_t* k_empty = v_full + ST;
  uint64_t* v_empty = k_empty + ST;
  uint64_t* id_full = v_empty + ST;               // segmented only
  uint64_t* id_empty = id_full + ST;

  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(k_full + s, 1);
      mbar_init(v_full + s, 1);
      mbar_init(k_empty + s, 8);   // one arrival per consumer warp
      mbar_init(v_empty + s, 8);
      if (Seg) {
        mbar_init(id_full + s, 32);  // each lane of the id warp
        mbar_init(id_empty + s, 8);
      }
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer: one thread issues every load, key tiles from the top
    // down.  K and V have their own barriers: a K stage frees when S is
    // computed, a V stage when P V is.
    setmaxnreg_dec<24>();   // 128 x (168 - 24) = 256 x (240 - 168)
    if (tid == 0) {
      mbar_expect_tx(q_full, kTileBytes);
#pragma unroll
      for (int a = 0; a < NA; ++a)
        tma_load_4d(Qs + a * kAtom, &tm_q, q_full, a * 64, h, q0, b);
      for (int it = 0; it < nkt; ++it) {
        const int s = it % ST;
        const uint32_t ph = ((it / ST) & 1) ^ 1;
        const int k0 = (kt_hi - it) * kBN;
        mbar_wait(k_empty + s, ph);
        mbar_expect_tx(k_full + s, kTileBytes);
#pragma unroll
        for (int a = 0; a < NA; ++a)
          tma_load_4d(Ks + s * kTile + a * kAtom, &tm_k, k_full + s, a * 64,
                      hk, k0, b);
        mbar_wait(v_empty + s, ph);
        mbar_expect_tx(v_full + s, kTileBytes);
#pragma unroll
        for (int a = 0; a < NA; ++a)
          tma_load_4d(Vs + s * kTile + a * kAtom, &tm_v, v_full + s, a * 64,
                      hk, k0, b);
      }
    } else if (Seg && tid / 32 == 1) {
      // the key tiles' segment ids, four a lane (ids past S are never read:
      // those keys are masked by position)
      const int lane = tid % 32;
      for (int it = 0; it < nkt; ++it) {
        const int s = it % ST;
        const int k0 = (kt_hi - it) * kBN + lane;
        mbar_wait(id_empty + s, ((it / ST) & 1) ^ 1);
#pragma unroll
        for (int j = 0; j < kBN; j += 32)
          Ids[s * kBN + lane + j] = k0 + j < S ? segb[k0 + j] : -1;
        mbar_arrive(id_full + s);
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
    int sq0 = 0, sq1 = 0;                        // their segment ids
    if constexpr (Seg) {
      sq0 = qp0 < S ? segb[qp0] : 0;
      sq1 = qp1 < S ? segb[qp1] : 0;
    }
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
    // e >= 2) in base 2: updates m, l and alpha, leaves P in sc
    auto softmax = [&](float (&sc)[64], int it) {
      const int kt = kt_hi - it;
      const int k0 = kt * kBN;
      if constexpr (Seg) {
        const int s = it % ST;
        mbar_wait(id_full + s, (it / ST) & 1);
        if (kt < free_lo || kt > free_hi) {
          const int* ids = Ids + s * kBN;
#pragma unroll
          for (int i = 0; i < 16; ++i) {
            const int2 kid = *reinterpret_cast<const int2*>(ids + 8 * i + 2 * t);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int kpos = k0 + 8 * i + 2 * t + (e & 1);
              const int qp = e < 2 ? qp0 : qp1;
              const bool vis = kpos < S && ((e & 1) ? kid.y : kid.x) == (e < 2 ? sq0 : sq1) &&
                               (!causal || kpos <= qp);
              if (!vis) sc[4 * i + e] = -INFINITY;
            }
          }
        }
        release(id_empty + s);
      } else if (it == 0) {
        // the first tile visited is the only one that can hold keys past S
        // or above the diagonal
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

// [B, S, H, d] bf16 as a 4-D tensor map, innermost first, in boxes of 64
// columns of d (one swizzle atom) by `rows` rows
inline cudaError_t bshd_map(CUtensorMap* map, const void* base, int B, int S,
                            int H, int D, int rows) {
  const uint64_t dims[4] = {(uint64_t)D, (uint64_t)H, (uint64_t)S, (uint64_t)B};
  const uint64_t strides[3] = {(uint64_t)D * 2, (uint64_t)H * D * 2,
                               (uint64_t)S * H * D * 2};
  const uint32_t box[4] = {64, 1, (uint32_t)rows, 1};
  return hopper::make_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, base, dims,
                          strides, box, true);
}

// q, out [B, S, H, d], k, v [B, S, Hkv, d] bf16, lse [B, H, S] f32 (all
// contiguous, 16-byte aligned; H a multiple of Hkv; d 64 or 128).  Returns
// the launch's cudaError_t.  Static: its flag of raised devices stays the
// library's own (a template's local static is one object per process
// otherwise, shared with another tree's library loaded beside it).
template <int D, bool Seg>
static int launch(const void* q, const void* k, const void* v, void* out, void* lse,
           SegArgs sa, int B, int S, int H, int Hkv, int causal,
           float sm_scale, cudaStream_t stream) {
  // boxes of 128 rows for Q, K and V, 64 for a consumer's out
  CUtensorMap mq, mk, mv, mo;
  cudaError_t err;
  if ((err = bshd_map(&mq, q, B, S, H, D, kBN)) ||
      (err = bshd_map(&mk, k, B, S, Hkv, D, kBN)) ||
      (err = bshd_map(&mv, v, B, S, Hkv, D, kBN)) ||
      (err = bshd_map(&mo, out, B, S, H, D, 64)))
    return (int)err;
  static bool raised[hopper::kMaxDevices] = {};
  err = hopper::raise_smem(flash_fwd_kernel<D, Seg>, smem_bytes<D, Seg>(), raised);
  if (err != cudaSuccess) return (int)err;
  const int G = H / Hkv;
  const int nqt = (S + kBM - 1) / kBM;
  const dim3 grid(Seg ? nqt * H : nqt, Seg ? 1 : H, B);
  flash_fwd_kernel<D, Seg><<<grid, kThreads, smem_bytes<D, Seg>(), stream>>>(
      mq, mk, mv, mo, (float*)lse, sa, S, H, G, causal,
      sm_scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

}  // namespace flash_fwd
