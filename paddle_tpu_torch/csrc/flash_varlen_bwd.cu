// Segmented (packed varlen) flash attention backward for Hopper (sm_90a):
// bf16 in and out, f32 probabilities and accumulation, causal or not, GQA
// native (n q heads over nkv kv heads, n % nkv == 0).
//
// Replaces: paddle_tpu/ops/pallas/flash_varlen.py, the backward of
// flash_attention_segmented (`_seg_bwd_vjp`): the dq pass at line 399
// (kernel body `_bwd_dq_kernel`, K7a) and the dk / dv pass at line 438
// (`_bwd_dkv_kernel`, K7b).
//
// Computes, for one packed stream per batch row, q head i and its kv head
// j = i / (n / nkv), over the (q, k) pairs with seg[q] == seg[k] (and
// k <= q when causal), from the forward's lse [B, n, T] and the caller's
// delta = sum(do * out) [B, n, T]:
//   p  = exp(q k^T / sqrt(d) - lse),  dp = do v^T,
//   ds = p * (dp - delta) / sqrt(d)
//   dq pass:   dq[i] = ds k
//   dkv pass:  dv[j] = sum over the q heads i of j's group of p^T do,
//              dk[j] = sum over the same heads of ds^T q
// p and ds are rounded to bf16 before their second product, as in the TPU
// kernels and in K6b / K6c.
//
// What bounds it on the card depends on the segment lengths, as for the
// forward (csrc/flash_varlen.cu): a visible pair costs 6 * d FLOPs a q head
// in the dq pass and 8 * d in the dkv pass, against q, k, v, do and the
// outputs moved once.  Above segments of a few hundred tokens (pretraining
// documents) the bf16 tensor-core rate bounds it, below that the bytes.
//
// What the design does about it:
// * K6b / K6c's tiles and tensor-core steps (csrc/flash_tiles.cuh): 64-row
//   bf16 tiles in shared memory, every product on wmma with f32
//   accumulators, four warps of 16 rows.  The dkv pass computes transposed
//   scores (k q^T), so p^T do and ds^T q contract over the q rows without a
//   transposed copy.
// * Block skipping as in the forward: a q tile visits only the k tiles from
//   the first row of the first segment it touches to min(last row of its
//   last segment, the tile's last row when causal); a k tile visits the q
//   tiles from max(first row of its first segment, its own first row when
//   causal) to the last row of its last segment.  Both ranges come from
//   _segment_block_ranges at 64 rows, computed by the wrapper.
// * GQA without a sequential grid: the TPU accumulates a group's q heads
//   into the shared dk / dv block across consecutive steps of its grid.  Here
//   one block owns (k tile, kv head, batch row) and loops over the group's q
//   heads, and for each over its q tiles, into one pair of f32 accumulators;
//   each output is written once, in bf16, after the whole group.  No
//   atomics: the result does not change from run to run.
// * A visited tile can hold pairs of other segments: their p is zeroed
//   explicitly, not left to exp(-inf - lse).  Rows and keys past T (a ragged
//   last tile) are zero-filled and masked, so any T runs the kernel.
// This first version loads each tile synchronously and uses wmma; a
// cp.async / TMA ring and wgmma are what a later PR adds.

#include "flash_tiles.cuh"

namespace {

template <int D> __host__ __device__ constexpr int seg_dq_smem() {
  return 4 * tile_bytes<D>() + 2 * kScoreBytes + kProbBytes + 2 * kT * 4;
}
template <int D> __host__ __device__ constexpr int seg_dkv_smem() {
  return 4 * tile_bytes<D>() + 2 * kScoreBytes + 2 * kProbBytes + 4 * kT * 4;
}

// ---------------------------------------------------------------------------
// dq: grid (q tiles, n, B)
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(kThreads)
seg_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, const bf16* __restrict__ dout,
                  const int* __restrict__ seg, const int* __restrict__ kmin,
                  const int* __restrict__ kmax, const float* __restrict__ lse,
                  const float* __restrict__ delta, bf16* __restrict__ dq,
                  int T, int n, int nkv, int causal, float sm_scale) {
  constexpr int LD = D + kPad;
  constexpr int NF = D / 16;
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int nqt = gridDim.x;
  const int kvh = h / (n / nkv);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = lane >> 1, hf = lane & 1;
  const int q0 = qt * kT;
  const size_t qrs = (size_t)n * D, krs = (size_t)nkv * D;
  const size_t qbase = ((size_t)b * T * n + h) * D;
  const size_t kbase = ((size_t)b * T * nkv + kvh) * D;
  const int* segb = seg + (size_t)b * T;

  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* dOs = Qs + kT * LD;
  bf16* Ks = dOs + kT * LD;
  bf16* Vs = Ks + kT * LD;
  unsigned char* rest = smem + 4 * tile_bytes<D>();
  float* Sf = reinterpret_cast<float*>(rest) + warp * 16 * kSLD;
  float* dPf = reinterpret_cast<float*>(rest + kScoreBytes) + warp * 16 * kSLD;
  bf16* dSb = reinterpret_cast<bf16*>(rest + 2 * kScoreBytes) + warp * 16 * kPLD;
  int* segq = reinterpret_cast<int*>(rest + 2 * kScoreBytes + kProbBytes);
  int* segk = segq + kT;

  load_tile<D>(Qs, q + qbase, q0, T, qrs);
  load_tile<D>(dOs, dout + qbase, q0, T, qrs);
  if (threadIdx.x < kT) {
    const int qp = q0 + threadIdx.x;
    segq[threadIdx.x] = qp < T ? segb[qp] : -1;
  }

  const int qpos = q0 + warp * 16 + r;
  const size_t stat = ((size_t)b * n + h) * T;
  const float lse_r = qpos < T ? lse[stat + qpos] : 0.f;
  const float delta_r = qpos < T ? delta[stat + qpos] : 0.f;

  int hi = kmax[(size_t)b * nqt + qt];
  if (causal) hi = min(hi, q0 + kT - 1);
  hi = min(hi, T - 1);
  const int lo_blk = kmin[(size_t)b * nqt + qt] / kT;
  const int hi_blk = hi / kT + 1;

  FragC acc[NF];
#pragma unroll
  for (int f = 0; f < NF; ++f) wmma::fill_fragment(acc[f], 0.f);

  for (int kt = lo_blk; kt < hi_blk; ++kt) {
    const int k0 = kt * kT;
    __syncthreads();   // the previous tile's readers are done
    load_tile<D>(Ks, k + kbase, k0, T, krs);
    load_tile<D>(Vs, v + kbase, k0, T, krs);
    if (threadIdx.x < kT) {
      const int kp = k0 + threadIdx.x;
      segk[threadIdx.x] = kp < T ? segb[kp] : -2;
    }
    __syncthreads();

    {
      FragC sc[4];
      mma_abt<D>(sc, Qs + warp * 16 * LD, Ks);
      store_scores(Sf, sc);
      mma_abt<D>(sc, dOs + warp * 16 * LD, Vs);
      store_scores(dPf, sc);
    }
    __syncwarp();
    const int sq = segq[warp * 16 + r];
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int c = hf + 2 * j;
      const int kpos = k0 + c;
      const bool ok = qpos < T && kpos < T && segk[c] == sq &&
                      (!causal || kpos <= qpos);
      const float p = ok ? expf(Sf[r * kSLD + c] * sm_scale - lse_r) : 0.f;
      const float ds = p * (dPf[r * kSLD + c] - delta_r) * sm_scale;
      dSb[r * kPLD + c] = __float2bfloat16(ds);
    }
    __syncwarp();
    mma_pb<D>(acc, dSb, Ks);
  }

  __syncthreads();   // every warp is done with Ks / Vs: reuse them as scratch
  float* stage = reinterpret_cast<float*>(Ks) + warp * 16 * (D + 4);
  store_rows<D>(acc, stage, dq + qbase, q0 + warp * 16, T, qrs, lane);
}

// ---------------------------------------------------------------------------
// dk and dv: grid (k tiles, nkv, B); the group's q heads in a loop
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(kThreads)
seg_bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const bf16* __restrict__ dout,
                   const int* __restrict__ seg, const int* __restrict__ qmin,
                   const int* __restrict__ qmax, const float* __restrict__ lse,
                   const float* __restrict__ delta, bf16* __restrict__ dk,
                   bf16* __restrict__ dv, int T, int n, int nkv, int causal,
                   float sm_scale) {
  constexpr int LD = D + kPad;
  constexpr int NF = D / 16;
  const int kt = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int nkt = gridDim.x;
  const int group = n / nkv;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = lane >> 1, hf = lane & 1;
  const int k0 = kt * kT;
  const size_t qrs = (size_t)n * D, krs = (size_t)nkv * D;
  const size_t kbase = ((size_t)b * T * nkv + kvh) * D;
  const int* segb = seg + (size_t)b * T;

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
  int* segq = reinterpret_cast<int*>(delta_s + kT);
  int* segk = segq + kT;

  load_tile<D>(Ks, k + kbase, k0, T, krs);
  load_tile<D>(Vs, v + kbase, k0, T, krs);
  if (threadIdx.x < kT) {
    const int kp = k0 + threadIdx.x;
    segk[threadIdx.x] = kp < T ? segb[kp] : -2;
  }

  int lo = qmin[(size_t)b * nkt + kt];
  if (causal) lo = max(lo, k0);
  const int lo_blk = lo / kT;
  const int hi_blk = min(qmax[(size_t)b * nkt + kt], T - 1) / kT + 1;
  const int kpos = k0 + warp * 16 + r;

  FragC dkf[NF], dvf[NF];
#pragma unroll
  for (int f = 0; f < NF; ++f) {
    wmma::fill_fragment(dkf[f], 0.f);
    wmma::fill_fragment(dvf[f], 0.f);
  }

  for (int g = 0; g < group; ++g) {
    const int h = kvh * group + g;
    const size_t qbase = ((size_t)b * T * n + h) * D;
    const size_t stat = ((size_t)b * n + h) * T;
    for (int qt = lo_blk; qt < hi_blk; ++qt) {
      const int q0 = qt * kT;
      __syncthreads();   // the previous tile's readers are done
      load_tile<D>(Qs, q + qbase, q0, T, qrs);
      load_tile<D>(dOs, dout + qbase, q0, T, qrs);
      if (threadIdx.x < kT) {
        const int qp = q0 + threadIdx.x;
        lse_s[threadIdx.x] = qp < T ? lse[stat + qp] : 0.f;
        delta_s[threadIdx.x] = qp < T ? delta[stat + qp] : 0.f;
        segq[threadIdx.x] = qp < T ? segb[qp] : -1;
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
      const int sk = segk[warp * 16 + r];
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const int c = hf + 2 * j;
        const int qpos = q0 + c;
        const bool ok = qpos < T && kpos < T && segq[c] == sk &&
                        (!causal || kpos <= qpos);
        const float p = ok ? expf(Sf[r * kSLD + c] * sm_scale - lse_s[c]) : 0.f;
        const float ds = p * (dPf[r * kSLD + c] - delta_s[c]) * sm_scale;
        Pb[r * kPLD + c] = __float2bfloat16(p);
        dSb[r * kPLD + c] = __float2bfloat16(ds);
      }
      __syncwarp();
      mma_pb<D>(dvf, Pb, dOs);
      mma_pb<D>(dkf, dSb, Qs);
    }
  }

  __syncthreads();   // every warp is done with Qs / dOs: reuse them as scratch
  float* stage = reinterpret_cast<float*>(Qs) + warp * 16 * (D + 4);
  store_rows<D>(dvf, stage, dv + kbase, k0 + warp * 16, T, krs, lane);
  store_rows<D>(dkf, stage, dk + kbase, k0 + warp * 16, T, krs, lane);
}

template <int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* seg, const void* kmin, const void* kmax,
              const void* lse, const void* delta, void* dq, int B, int T,
              int n, int nkv, int causal, float sm_scale, cudaStream_t stream) {
  static bool raised[hopper::kMaxDevices] = {};
  cudaError_t err =
      hopper::raise_smem(seg_bwd_dq_kernel<D>, seg_dq_smem<D>(), raised);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((T + kT - 1) / kT, n, B);
  seg_bwd_dq_kernel<D><<<grid, kThreads, seg_dq_smem<D>(), stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout,
      (const int*)seg, (const int*)kmin, (const int*)kmax, (const float*)lse,
      (const float*)delta, (bf16*)dq, T, n, nkv, causal, sm_scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const void* seg, const void* qmin, const void* qmax,
               const void* lse, const void* delta, void* dk, void* dv, int B,
               int T, int n, int nkv, int causal, float sm_scale,
               cudaStream_t stream) {
  static bool raised[hopper::kMaxDevices] = {};
  cudaError_t err =
      hopper::raise_smem(seg_bwd_dkv_kernel<D>, seg_dkv_smem<D>(), raised);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((T + kT - 1) / kT, nkv, B);
  seg_bwd_dkv_kernel<D><<<grid, kThreads, seg_dkv_smem<D>(), stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout,
      (const int*)seg, (const int*)qmin, (const int*)qmax, (const float*)lse,
      (const float*)delta, (bf16*)dk, (bf16*)dv, T, n, nkv, causal, sm_scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q, dout, dq [B, T, n, d] and k, v, dk, dv [B, T, nkv, d] bf16; seg [B, T]
// int32; kmin / kmax (qmin / qmax) [B, ceil(T / 64)] int32, the inclusive
// first / last row of the segments each 64-row tile touches; lse, delta
// [B, n, T] f32.  All contiguous and on 16-byte boundaries; d is 64 or 128,
// n % nkv == 0, n and B at most 65535 (the wrapper checks).  Each returns
// the launch's cudaError_t (0 on success).
extern "C" int flash_segmented_bwd_dq_bf16(
    const void* q, const void* k, const void* v, const void* dout,
    const void* seg, const void* kmin, const void* kmax, const void* lse,
    const void* delta, void* dq, int B, int T, int n, int nkv, int d,
    int causal, float sm_scale, void* stream) {
  if (B == 0 || T == 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  if (d == 128)
    return launch_dq<128>(q, k, v, dout, seg, kmin, kmax, lse, delta, dq, B, T,
                          n, nkv, causal, sm_scale, s);
  if (d == 64)
    return launch_dq<64>(q, k, v, dout, seg, kmin, kmax, lse, delta, dq, B, T,
                         n, nkv, causal, sm_scale, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int flash_segmented_bwd_dkv_bf16(
    const void* q, const void* k, const void* v, const void* dout,
    const void* seg, const void* qmin, const void* qmax, const void* lse,
    const void* delta, void* dk, void* dv, int B, int T, int n, int nkv, int d,
    int causal, float sm_scale, void* stream) {
  if (B == 0 || T == 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  if (d == 128)
    return launch_dkv<128>(q, k, v, dout, seg, qmin, qmax, lse, delta, dk, dv,
                           B, T, n, nkv, causal, sm_scale, s);
  if (d == 64)
    return launch_dkv<64>(q, k, v, dout, seg, qmin, qmax, lse, delta, dk, dv,
                          B, T, n, nkv, causal, sm_scale, s);
  return (int)cudaErrorInvalidValue;
}
