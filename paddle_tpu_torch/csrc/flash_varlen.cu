// Segmented (packed varlen) flash attention forward for Hopper (sm_90a),
// bf16 in and out, fp32 softmax and accumulation.
//
// Replaces: paddle_tpu/ops/pallas/flash_varlen.py, the forward of
// flash_attention_segmented (`_seg_fwd`, the pallas_call at line 342, kernel
// body `_fwd_kernel`).
//
// Computes, for one packed stream per batch row:
//   out[b, i, h] = softmax_j(q[b, i, h] . k[b, j, h / g] / sqrt(d)) . v[b, j, h / g]
// over the keys j with seg[b, j] == seg[b, i] (and j <= i when causal), plus
// lse[b, h, i] = log sum_j exp(score).  Segments are contiguous runs of equal
// ids; the serving engine's bucket padding carries a sentinel id of its own
// and so only attends to itself.  g = n / nkv: a GQA group's q heads read
// their shared kv head directly, no K/V is repeated.
//
// What bounds it on the card depends on the segment lengths.  A visible
// (q, k) pair costs 4*d FLOPs per head, and q, k, v and out are each moved
// once, so the FLOPs per byte are about n / (n + nkv) times the mean
// segment length / 2.  With MHA (nkv = n) the bytes over 3.35 TB/s bound it
// below segments of about 1,200 tokens (the serving waves of short and
// mid-length prompts) and the FLOPs over 989 TFLOP/s above.
//
// What the design does about it:
// * Block skipping: one block per (64-row q tile, q head, batch row) visits
//   only the 64-row k tiles from the first row of the first segment the q
//   tile touches up to min(last row of its last segment, the tile's last row)
//   -- the per-tile [lo, hi] ranges of _segment_block_ranges, computed on the
//   device by the wrapper.  A packed wave of short prompts costs
//   O(sum_i L_i * 64), not O(T^2).
// * Masked probabilities are zeroed explicitly: a visited tile can hold no
//   visible key for some rows, where exp(NEG_INF - NEG_INF) would be 1.
// * Rows and keys past T (a ragged last tile) are masked and their K/V rows
//   zero-filled, so any T works; no block size has to divide it.
// * The q tile is staged once in shared memory as fp32 with the softmax scale
//   folded in; K rows are padded by 8 bf16 so the 16-byte row reads of the
//   score loop are free of bank conflicts.
// This first version computes QK^T and PV on the CUDA cores in fp32; the
// tensor cores (mma.sync / wgmma) with a TMA-fed ring of K/V tiles are what
// a later PR adds to approach the bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;              // q rows per block
constexpr int kBK = 64;              // keys per k tile
constexpr int kThreads = 128;        // 8 row groups x 16 column lanes
constexpr int kRows = 8;             // q rows per thread
constexpr int kCols = kBK / 16;      // score columns per thread
constexpr int kKPad = 8;             // bf16 padding of a staged K row
constexpr int kPPad = 2;             // fp32 padding of a probability row
constexpr float kNegInf = -1e30f;    // NEG_INF of the JAX kernels

template <int D>
size_t smem_bytes() {
  return (size_t)kBQ * D * 4                  // q tile, fp32, pre-scaled
       + (size_t)kBK * (D + kKPad) * 2        // k tile
       + (size_t)kBK * D * 2                  // v tile
       + (size_t)kBQ * (kBK + kPPad) * 4      // probabilities
       + (size_t)(kBQ + kBK) * 4;             // segment ids
}

template <int D>
__global__ void __launch_bounds__(kThreads)
seg_fwd_kernel(const __nv_bfloat16* __restrict__ q,
               const __nv_bfloat16* __restrict__ k,
               const __nv_bfloat16* __restrict__ v,
               const int* __restrict__ seg,
               const int* __restrict__ kmin,
               const int* __restrict__ kmax,
               __nv_bfloat16* __restrict__ out,
               float* __restrict__ lse,
               int T, int n, int nkv, int causal, float sm_scale) {
  constexpr int kChunks = D / 8;     // 16-byte chunks of a row
  constexpr int kDCols = D / 16;     // output columns per thread
  constexpr int kKStride = D + kKPad;
  constexpr int kPStride = kBK + kPPad;
  const int qt = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (n / nkv);
  const int nqt = gridDim.x;
  const int tid = threadIdx.x;
  const int ty = tid >> 4;           // row group: rows ty*8 .. ty*8+7
  const int tx = tid & 15;           // column lane
  const int q0 = qt * kBQ;

  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(qs + kBQ * D);
  __nv_bfloat16* vs = ks + kBK * kKStride;
  float* ps = reinterpret_cast<float*>(vs + kBK * D);
  int* segq = reinterpret_cast<int*>(ps + kBQ * kPStride);
  int* segk = segq + kBQ;

  const int* segb = seg + (size_t)b * T;
  for (int i = tid; i < kBQ * kChunks; i += kThreads) {
    const int r = i / kChunks, c = i - r * kChunks;
    float* dst = qs + r * D + c * 8;
    if (q0 + r < T) {
      const uint4 qq = reinterpret_cast<const uint4*>(
          q + (((size_t)b * T + q0 + r) * n + h) * D)[c];
      const __nv_bfloat162* q2 = reinterpret_cast<const __nv_bfloat162*>(&qq);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = __bfloat1622float2(q2[e]);
        dst[2 * e] = f.x * sm_scale;
        dst[2 * e + 1] = f.y * sm_scale;
      }
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) dst[e] = 0.f;
    }
  }
  for (int r = tid; r < kBQ; r += kThreads) segq[r] = q0 + r < T ? segb[q0 + r] : -1;

  int lo = kmin[(size_t)b * nqt + qt];
  int hi = kmax[(size_t)b * nqt + qt];
  if (causal) hi = min(hi, q0 + kBQ - 1);
  hi = min(hi, T - 1);
  const int lo_blk = lo / kBK;
  const int hi_blk = hi / kBK + 1;

  float m[kRows], l[kRows], acc[kRows][kDCols];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kDCols; ++c) acc[i][c] = 0.f;
  }

  for (int kt = lo_blk; kt < hi_blk; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // the previous tile's readers are done
    for (int i = tid; i < kBK * kChunks; i += kThreads) {
      const int r = i / kChunks, c = i - r * kChunks;
      uint4 kk = make_uint4(0, 0, 0, 0), vv = make_uint4(0, 0, 0, 0);
      if (k0 + r < T) {
        const size_t off = (((size_t)b * T + k0 + r) * nkv + kvh) * D;
        kk = reinterpret_cast<const uint4*>(k + off)[c];
        vv = reinterpret_cast<const uint4*>(v + off)[c];
      }
      *reinterpret_cast<uint4*>(ks + r * kKStride + c * 8) = kk;
      *reinterpret_cast<uint4*>(vs + r * D + c * 8) = vv;
    }
    for (int r = tid; r < kBK; r += kThreads) segk[r] = k0 + r < T ? segb[k0 + r] : -2;
    __syncthreads();

    // scores for rows ty*8+i, keys tx + 16*j
    float s[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = 0.f;
    for (int c = 0; c < kChunks; ++c) {
      float kf[kCols][8];
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const uint4 kk = reinterpret_cast<const uint4*>(
            ks + (tx + 16 * j) * kKStride)[c];
        const __nv_bfloat162* k2 = reinterpret_cast<const __nv_bfloat162*>(&kk);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 f = __bfloat1622float2(k2[e]);
          kf[j][2 * e] = f.x;
          kf[j][2 * e + 1] = f.y;
        }
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const float4* qr = reinterpret_cast<const float4*>(
            qs + (ty * kRows + i) * D + c * 8);
        const float4 qa = qr[0], qb = qr[1];
        const float qv[8] = {qa.x, qa.y, qa.z, qa.w, qb.x, qb.y, qb.z, qb.w};
#pragma unroll
        for (int j = 0; j < kCols; ++j)
#pragma unroll
          for (int e = 0; e < 8; ++e) s[i][j] = fmaf(qv[e], kf[j][e], s[i][j]);
      }
    }

    // mask, online softmax per row (a row's keys live on 16 lanes)
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int r = ty * kRows + i;
      const int qpos = q0 + r;
      bool vis[kCols];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int kc = tx + 16 * j;
        const int kpos = k0 + kc;
        vis[j] = qpos < T && kpos < T && segq[r] == segk[kc] &&
                 (!causal || qpos >= kpos);
        if (!vis[j]) s[i][j] = kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[i], mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float p = vis[j] ? expf(s[i][j] - m_new) : 0.f;
        ps[r * kPStride + tx + 16 * j] = p;
        sum += p;
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      const float alpha = expf(m[i] - m_new);
      l[i] = alpha * l[i] + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kDCols; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

    // P . V for rows ty*8+i, columns tx*kDCols ..
    for (int t = 0; t < kBK; ++t) {
      float vf[kDCols];
      const __nv_bfloat162* v2 =
          reinterpret_cast<const __nv_bfloat162*>(vs + t * D + tx * kDCols);
#pragma unroll
      for (int e = 0; e < kDCols / 2; ++e) {
        const float2 f = __bfloat1622float2(v2[e]);
        vf[2 * e] = f.x;
        vf[2 * e + 1] = f.y;
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const float p = ps[(ty * kRows + i) * kPStride + t];
#pragma unroll
        for (int c = 0; c < kDCols; ++c) acc[i][c] = fmaf(p, vf[c], acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int qpos = q0 + ty * kRows + i;
    if (qpos >= T) continue;
    const float l_safe = fmaxf(l[i], 1e-30f);
    __nv_bfloat162 o2[kDCols / 2];
#pragma unroll
    for (int e = 0; e < kDCols / 2; ++e)
      o2[e] = __floats2bfloat162_rn(acc[i][2 * e] / l_safe, acc[i][2 * e + 1] / l_safe);
    __nv_bfloat162* dst = reinterpret_cast<__nv_bfloat162*>(
        out + (((size_t)b * T + qpos) * n + h) * D + tx * kDCols);
#pragma unroll
    for (int e = 0; e < kDCols / 2; ++e) dst[e] = o2[e];
    if (tx == 0) lse[((size_t)b * n + h) * T + qpos] = m[i] + logf(l_safe);
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* seg,
           const void* kmin, const void* kmax, void* out, void* lse, int B,
           int T, int n, int nkv, int causal, float sm_scale,
           cudaStream_t stream) {
  const size_t smem = smem_bytes<D>();
  // the cap is raised once per device; the call costs about a launch
  constexpr int kMaxDevices = 64;
  static bool raised[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices || !raised[dev]) {
    err = cudaFuncSetAttribute(seg_fwd_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    if (dev < kMaxDevices) raised[dev] = true;
  }
  dim3 grid((T + kBQ - 1) / kBQ, n, B);
  seg_fwd_kernel<D><<<grid, kThreads, smem, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (const int*)seg, (const int*)kmin,
      (const int*)kmax, (__nv_bfloat16*)out, (float*)lse, T, n, nkv, causal,
      sm_scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q [B, T, n, d], k / v [B, T, nkv, d] bf16, seg [B, T] int32, kmin / kmax
// [B, ceil(T / 64)] int32 (inclusive first / last row of the segments each
// 64-row tile touches) -> out [B, T, n, d] bf16, lse [B, n, T] fp32.  All
// contiguous.  d is 64 or 128 and n % nkv == 0 (the wrapper checks).
// Returns the launch's cudaError_t (0 on success).
extern "C" int flash_segmented_fwd_bf16(
    const void* q, const void* k, const void* v, const void* seg,
    const void* kmin, const void* kmax, void* out, void* lse, int B, int T,
    int n, int nkv, int d, int causal, float sm_scale, void* stream) {
  if (B == 0 || T == 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  if (d == 128)
    return launch<128>(q, k, v, seg, kmin, kmax, out, lse, B, T, n, nkv,
                       causal, sm_scale, s);
  if (d == 64)
    return launch<64>(q, k, v, seg, kmin, kmax, out, lse, B, T, n, nkv,
                      causal, sm_scale, s);
  return (int)cudaErrorInvalidValue;
}
