// Paged-KV decode attention for Hopper (sm_90a), bf16 or int8 pages, fp32
// math.
//
// Replaces: paddle_tpu/ops/pallas/paged_attention.py,
// * paged_decode_attention (the Pallas `_kernel`, launched by the
//   pallas_call at line 215): bf16 pages, paged_decode_attention_bf16 below;
// * paged_decode_attention_q8 (the Pallas `_kernel_q8`, launched by the
//   pallas_call at line 296): int8 pages with one f32 scale per (page, kv
//   head, slot) for K and for V, paged_decode_attention_q8 below.
// Both are one template, paged_decode_kernel<T>, on the page element type.
//
// Computes, per batch row b and query head h:
//   out[b, h] = softmax(q[b, h] . K_b^T * sm_scale) . V_b
// where K_b / V_b are the first lens[b] slots of the row's pages, looked up
// through tables[b, :] in a shared pool [num_pages, nkv, page, d].  Table
// entries past ceil(lens[b] / page) point at the junk page 0; they are never
// read.  A row with lens[b] == 0 writes zeros.  With int8 pages K_b and V_b
// are codes times their slot's scale; as in the TPU kernel the scales are
// folded into the logits (q . (k * ks) = (q . k) * ks) and into the
// probabilities (sum p * (v * vs) = sum (p * vs) * v), so no d-wide dequant
// is done.
//
// What bounds it on the card: bytes.  One decode token does 4*d FLOPs per
// (head, key) pair against 4*d bytes of bf16 K and V (2*d of int8, plus 8
// bytes of scales) per (kv head, key): about g = n/nkv FLOPs per byte (2g for
// int8), far below the ~295 FLOPs/byte where an H100's bf16 tensor cores
// would be the limit.  The floor is reading every used K/V byte of the pool
// once at 3.35 TB/s; int8 pages halve it.
//
// What the design does about it:
// * One block per (row, kv head).  The g query heads of a GQA group share the
//   block, so each K/V page is read from device memory once for the whole
//   group (the point of the TPU kernel's one-step-per-(row, page) grid).
// * Only the row's used pages are visited (the loop runs ceil(len/page)
//   times), and only the valid slots of the last page are loaded, so traffic
//   scales with the row's real length, not with pages_max.
// * Each page is staged in shared memory with 16-byte coalesced loads (8 bf16
//   or 16 int8 values a load) and stays in its stored type there; the K rows
//   are padded by 16 bytes so the per-key 16-byte row reads of the score loop
//   are free of bank conflicts.  int8 pages move half the bytes of bf16 ones.
// * The softmax is online (running max / sum per head in fp32), so a row of
//   any length needs one pass.
// This first version computes the dot products on the CUDA cores and does not
// overlap a page's load with the previous page's math; tensor cores (mma) and
// a cp.async / TMA double buffer are later work.  Both forms inherit the
// per-page latency chain that keeps K1 far from its bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxGroup = 16;        // q heads per kv head
constexpr int kMaxDimPerThread = 2;  // head_dim <= 2 * kThreads
constexpr int kKPadBytes = 16;       // padding of a staged K row
constexpr float kNegInf = -1e30f;    // NEG_INF of the JAX kernels

__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_float(int8_t v) { return (float)v; }

template <typename T>
__host__ __device__ constexpr bool is_q8() { return sizeof(T) == 1; }

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T>
size_t smem_bytes(int g, int d, int page) {
  const int kpad = kKPadBytes / (int)sizeof(T);
  return (size_t)page * (d + kpad) * sizeof(T)      // K page
       + (size_t)page * d * sizeof(T)               // V page
       + (size_t)g * d * 4                          // q of the group, fp32
       + (size_t)g * page * 4                       // scores / probabilities
       + (size_t)3 * g * 4                          // running max, sum, rescale
       + (is_q8<T>() ? (size_t)2 * page * 4 : 0);   // the page's K / V scales
}

// kscale / vscale: [num_pages, nkv, page] f32 for int8 pages, unused (null)
// for bf16 ones.
template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const __nv_bfloat16* __restrict__ q,
                    const T* __restrict__ kpool,
                    const T* __restrict__ vpool,
                    const float* __restrict__ kscale,
                    const float* __restrict__ vscale,
                    const int* __restrict__ tables,
                    const int* __restrict__ lens,
                    __nv_bfloat16* __restrict__ out,
                    int n, int nkv, int d, int page, int pages_max,
                    float sm_scale) {
  constexpr bool kQ8 = is_q8<T>();
  constexpr int kChunk = 16 / (int)sizeof(T);   // elements per 16-byte load
  const int b = blockIdx.x;
  const int kvh = blockIdx.y;
  const int g = n / nkv;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int kstride = d + kKPadBytes / (int)sizeof(T);
  const int chunks = d / kChunk;     // 16-byte chunks of a row

  extern __shared__ __align__(16) unsigned char smem[];
  T* ks = reinterpret_cast<T*>(smem);
  T* vs = ks + (size_t)page * kstride;
  float* qs = reinterpret_cast<float*>(vs + (size_t)page * d);
  float* ps = qs + g * d;
  float* m_s = ps + g * page;
  float* l_s = m_s + g;
  float* a_s = l_s + g;
  float* ksc = a_s + g;              // int8 pages only
  float* vsc = ksc + page;

  const __nv_bfloat16* qg = q + ((size_t)b * n + (size_t)kvh * g) * d;
  for (int i = tid; i < g * d; i += kThreads) qs[i] = __bfloat162float(qg[i]);
  if (tid < g) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }

  float acc[kMaxGroup][kMaxDimPerThread];
#pragma unroll
  for (int h = 0; h < kMaxGroup; ++h)
#pragma unroll
    for (int i = 0; i < kMaxDimPerThread; ++i) acc[h][i] = 0.f;

  const int len = lens[b];
  const int used = (len + page - 1) / page;
  for (int j = 0; j < used; ++j) {
    const int pid = tables[(size_t)b * pages_max + j];
    const int nvalid = min(page, len - j * page);
    const size_t head = (size_t)pid * nkv + kvh;
    const size_t base = head * (size_t)page * d;
    __syncthreads();  // the previous page's readers are done with ks/vs/ps
    for (int i = tid; i < nvalid * chunks; i += kThreads) {
      const int r = i / chunks, c = i - r * chunks;
      const uint4 kk = reinterpret_cast<const uint4*>(kpool + base + (size_t)r * d)[c];
      const uint4 vv = reinterpret_cast<const uint4*>(vpool + base + (size_t)r * d)[c];
      *reinterpret_cast<uint4*>(ks + r * kstride + c * kChunk) = kk;
      *reinterpret_cast<uint4*>(vs + r * d + c * kChunk) = vv;
    }
    if (kQ8) {
      for (int t = tid; t < nvalid; t += kThreads) {
        ksc[t] = kscale[head * page + t];
        vsc[t] = vscale[head * page + t];
      }
    }
    __syncthreads();

    // scores: one (head, slot) pair per thread and step
    for (int i = tid; i < g * page; i += kThreads) {
      const int h = i / page, t = i - h * page;
      float s = kNegInf;
      if (t < nvalid) {
        const uint4* kr = reinterpret_cast<const uint4*>(ks + t * kstride);
        const float* qr = qs + h * d;
        float dot = 0.f;
        for (int c = 0; c < chunks; ++c) {
          const uint4 kk = kr[c];
          const T* kv = reinterpret_cast<const T*>(&kk);
#pragma unroll
          for (int e = 0; e < kChunk; ++e)
            dot = fmaf(qr[c * kChunk + e], to_float(kv[e]), dot);
        }
        s = dot * sm_scale;
        if (kQ8) s *= ksc[t];
      }
      ps[i] = s;
    }
    __syncthreads();

    // online softmax update: one warp per head.  The normaliser sums the
    // probabilities; with int8 pages the V scale then folds into each
    // probability the P . V sum reads.
    for (int h = warp; h < g; h += kThreads / 32) {
      float mx = kNegInf;
      for (int t = lane; t < nvalid; t += 32) mx = fmaxf(mx, ps[h * page + t]);
      mx = warp_max(mx);
      const float m_old = m_s[h];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int t = lane; t < page; t += 32) {
        const float p = t < nvalid ? expf(ps[h * page + t] - m_new) : 0.f;
        ps[h * page + t] = (kQ8 && t < nvalid) ? p * vsc[t] : p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        a_s[h] = alpha;
        l_s[h] = alpha * l_s[h] + sum;
        m_s[h] = m_new;
      }
    }
    __syncthreads();

    // P . V: each thread owns head_dim columns tid, tid + kThreads
#pragma unroll
    for (int i = 0; i < kMaxDimPerThread; ++i) {
      const int dd = tid + i * kThreads;
      if (dd >= d) continue;
#pragma unroll
      for (int h = 0; h < kMaxGroup; ++h)
        if (h < g) acc[h][i] *= a_s[h];
      for (int t = 0; t < nvalid; ++t) {
        const float vf = to_float(vs[t * d + dd]);
#pragma unroll
        for (int h = 0; h < kMaxGroup; ++h)
          if (h < g) acc[h][i] = fmaf(ps[h * page + t], vf, acc[h][i]);
      }
    }
  }
  __syncthreads();

  __nv_bfloat16* og = out + ((size_t)b * n + (size_t)kvh * g) * d;
#pragma unroll
  for (int i = 0; i < kMaxDimPerThread; ++i) {
    const int dd = tid + i * kThreads;
    if (dd >= d) continue;
#pragma unroll
    for (int h = 0; h < kMaxGroup; ++h) {
      if (h >= g) continue;
      // l == 0 only for an empty row (len 0): acc is 0 there, so 0 out
      const float l = fmaxf(l_s[h], 1e-30f);
      og[(size_t)h * d + dd] = __float2bfloat16(acc[h][i] / l);
    }
  }
}

// Lift the kernel's dynamic shared-memory cap to `smem` on the current
// device, calling the runtime only when a larger size than before is asked
// for there (the call costs about as much as a launch).  One cache per
// kernel instantiation.
template <typename T>
cudaError_t raise_smem_cap(size_t smem) {
  constexpr int kMaxDevices = 64;
  static size_t cap[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && smem <= cap[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute((const void*)paged_decode_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err == cudaSuccess && dev < kMaxDevices) cap[dev] = smem;
  return err;
}

template <typename T>
int launch(const void* q, const void* kpool, const void* vpool,
           const void* kscale, const void* vscale, const void* tables,
           const void* lens, void* out, int B, int n, int nkv, int d,
           int page, int pages_max, float sm_scale, void* stream) {
  if (B == 0) return (int)cudaSuccess;
  const size_t smem = smem_bytes<T>(n / nkv, d, page);
  cudaError_t err = raise_smem_cap<T>(smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(B, nkv);
  paged_decode_kernel<T><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, (const T*)kpool, (const T*)vpool,
      (const float*)kscale, (const float*)vscale, (const int*)tables,
      (const int*)lens, (__nv_bfloat16*)out, n, nkv, d, page, pages_max,
      sm_scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q [B, n, d], kpool / vpool [num_pages, nkv, page, d] bf16, tables
// [B, pages_max] int32, lens [B] int32 -> out [B, n, d] bf16.  All
// contiguous.  The caller checks n % nkv == 0, n / nkv <= 16, d % 8 == 0 and
// d <= 256.  Returns the launch's cudaError_t (0 on success).
extern "C" int paged_decode_attention_bf16(
    const void* q, const void* kpool, const void* vpool, const void* tables,
    const void* lens, void* out, int B, int n, int nkv, int d, int page,
    int pages_max, float sm_scale, void* stream) {
  return launch<__nv_bfloat16>(q, kpool, vpool, nullptr, nullptr, tables,
                               lens, out, B, n, nkv, d, page, pages_max,
                               sm_scale, stream);
}

// As paged_decode_attention_bf16 over int8 pools, with kscale / vscale
// [num_pages, nkv, page] f32.  The caller checks d % 16 == 0 as well.
extern "C" int paged_decode_attention_q8(
    const void* q, const void* kpool, const void* vpool, const void* kscale,
    const void* vscale, const void* tables, const void* lens, void* out,
    int B, int n, int nkv, int d, int page, int pages_max, float sm_scale,
    void* stream) {
  return launch<int8_t>(q, kpool, vpool, kscale, vscale, tables, lens, out,
                        B, n, nkv, d, page, pages_max, sm_scale, stream);
}

// Dynamic shared memory one launch needs (int8 pages when q8 != 0); the
// wrapper rejects shapes above the card's 227 KB per block.
extern "C" long long paged_decode_attention_smem_bytes(int n, int nkv, int d,
                                                       int page, int q8) {
  return (long long)(q8 ? smem_bytes<int8_t>(n / nkv, d, page)
                        : smem_bytes<__nv_bfloat16>(n / nkv, d, page));
}
