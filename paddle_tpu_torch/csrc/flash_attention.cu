// FlashAttention-2 forward and backward for Hopper (sm_90a): bf16 in and
// out, f32 softmax and accumulation, causal or not, equal head counts.
//
// Replaces: paddle_tpu/ops/pallas/flash_attention.py, the three pallas_calls
// of `flash_attention`: the forward at line 285 (`_fwd_kernel`), the dq pass
// at line 319 (`_bwd_dq_kernel`) and the dk / dv pass at line 336
// (`_bwd_dkv_kernel`).
//
// Computes, for q, k, v [B, S, H, d] (one stream per batch row and head):
//   forward:  out = softmax(q k^T / sqrt(d) [+ causal mask]) v, and
//             lse[b, h, i] = log sum_j exp(score[i, j])
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
// What the design does about it:
// * Every product runs on the tensor cores (nvcuda::wmma 16x16x16, bf16
//   operands, f32 accumulators) from 64-row tiles in shared memory; the TPU
//   kernel keeps a head's whole K and V resident in its fast memory, which a
//   227 KB Hopper block cannot, so K and V (or Q and dO) stream through in
//   64-row tiles and a loop in the block replaces the sequential grid.
// * One block of four warps per 64-row tile; each warp owns 16 rows, keeps
//   their running maximum, normalizer and output accumulators in registers
//   and needs the other warps only to load the shared tiles.  Accumulator
//   fragments are rescaled row-wise by multiplying them with a fragment
//   loaded from a 16x16 tile that holds the row's factor in every column, so
//   no assumption is made on the fragment's register layout.
// * Causal: the loop bound skips the tiles above the diagonal and the heavy
//   (late) q tiles are scheduled first.  A ragged last tile is zero-filled
//   and masked, so every S runs the kernel.
// * The backward keeps the TPU kernels' split: the dq pass owns a q tile and
//   loops over k tiles, the dkv pass owns a k tile and loops over q tiles
//   (transposed scores k q^T, so its two products contract over the q rows
//   without a transposed copy).  Each output is written once: no atomics, and
//   the result does not change from run to run.
// This first version loads each tile synchronously (no cp.async / TMA ring)
// and uses wmma rather than wgmma; those are what a later PR adds.

#include "flash_tiles.cuh"

namespace {

constexpr int kFactorBytes = kWarps * 16 * 16 * 4;

template <int D> __host__ __device__ constexpr int fwd_smem() {
  return 3 * tile_bytes<D>() + kScoreBytes + kProbBytes + kFactorBytes;
}
template <int D> __host__ __device__ constexpr int dq_smem() {
  return 4 * tile_bytes<D>() + 2 * kScoreBytes + kProbBytes;
}
template <int D> __host__ __device__ constexpr int dkv_smem() {
  return 4 * tile_bytes<D>() + 2 * kScoreBytes + 2 * kProbBytes + 2 * kT * 4;
}

// ---------------------------------------------------------------------------
// forward: grid (q tiles, H, B)
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ out,
                 float* __restrict__ lse, int S, int H, int causal,
                 float sm_scale) {
  constexpr int LD = D + kPad;
  constexpr int NF = D / 16;
  const int qt = gridDim.x - 1 - blockIdx.x;   // late (heavy) tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = lane >> 1, hf = lane & 1;      // row of the warp, column parity
  const int q0 = qt * kT;
  const size_t rs = (size_t)H * D;
  const size_t base = ((size_t)b * S * H + h) * D;

  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + kT * LD;
  bf16* Vs = Ks + kT * LD;
  float* Sf = reinterpret_cast<float*>(smem + 3 * tile_bytes<D>()) + warp * 16 * kSLD;
  bf16* Pb = reinterpret_cast<bf16*>(smem + 3 * tile_bytes<D>() + kScoreBytes) +
             warp * 16 * kPLD;
  float* Ff = reinterpret_cast<float*>(smem + 3 * tile_bytes<D>() + kScoreBytes +
                                       kProbBytes) + warp * 256;

  load_tile<D>(Qs, q + base, q0, S, rs);

  FragC o[NF];
#pragma unroll
  for (int f = 0; f < NF; ++f) wmma::fill_fragment(o[f], 0.f);
  float m_i = kNegInf, l_i = 0.f;
  const int qpos = q0 + warp * 16 + r;
  const int nkt = causal ? qt + 1 : (S + kT - 1) / kT;

  for (int kt = 0; kt < nkt; ++kt) {
    const int k0 = kt * kT;
    __syncthreads();   // the previous tile's readers are done
    load_tile<D>(Ks, k + base, k0, S, rs);
    load_tile<D>(Vs, v + base, k0, S, rs);
    __syncthreads();

    {
      FragC sc[4];
      mma_abt<D>(sc, Qs + warp * 16 * LD, Ks);
      store_scores(Sf, sc);
    }
    __syncwarp();

    // online softmax of row r; this lane holds columns hf, hf + 2, ...
    float sv[32];
    unsigned vis = 0;
    float mx = kNegInf;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int c = hf + 2 * j;
      const int kpos = k0 + c;
      const bool ok = kpos < S && (!causal || kpos <= qpos);
      const float s = ok ? Sf[r * kSLD + c] * sm_scale : kNegInf;
      sv[j] = s;
      vis |= (unsigned)ok << j;
      mx = fmaxf(mx, s);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_new = fmaxf(m_i, mx);
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const float p = (vis >> j) & 1u ? expf(sv[j] - m_new) : 0.f;
      Pb[r * kPLD + hf + 2 * j] = __float2bfloat16(p);
      sum += p;
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    const float alpha = expf(m_i - m_new);
    l_i = alpha * l_i + sum;
    m_i = m_new;
#pragma unroll
    for (int e = 0; e < 8; ++e) Ff[r * 16 + hf * 8 + e] = alpha;
    __syncwarp();

    scale_rows<NF>(o, Ff);
    mma_pb<D>(o, Pb, Vs);
  }

  const float l_safe = fmaxf(l_i, 1e-30f);
  const float inv = 1.f / l_safe;
  __syncwarp();
#pragma unroll
  for (int e = 0; e < 8; ++e) Ff[r * 16 + hf * 8 + e] = inv;
  __syncwarp();
  scale_rows<NF>(o, Ff);
  __syncthreads();   // every warp is done with Ks / Vs: reuse them as scratch
  float* stage = reinterpret_cast<float*>(Ks) + warp * 16 * (D + 4);
  store_rows<D>(o, stage, out + base, q0 + warp * 16, S, rs, lane);
  if (hf == 0 && qpos < S)
    lse[((size_t)b * H + h) * S + qpos] = m_i + logf(l_safe);
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
  static bool raised[kMaxDevices] = {};
  cudaError_t err = raise_smem(flash_fwd_kernel<D>, fwd_smem<D>(), raised, kMaxDevices);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((S + kT - 1) / kT, H, B);
  flash_fwd_kernel<D><<<grid, kThreads, fwd_smem<D>(), stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)out, (float*)lse,
      S, H, causal, sm_scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, void* dq, int B, int S,
              int H, int causal, float sm_scale, cudaStream_t stream) {
  static bool raised[kMaxDevices] = {};
  cudaError_t err = raise_smem(flash_bwd_dq_kernel<D>, dq_smem<D>(), raised, kMaxDevices);
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
  static bool raised[kMaxDevices] = {};
  cudaError_t err = raise_smem(flash_bwd_dkv_kernel<D>, dkv_smem<D>(), raised, kMaxDevices);
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
