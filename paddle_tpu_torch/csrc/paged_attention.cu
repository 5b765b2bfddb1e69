// Paged-KV decode attention for Hopper (sm_90a), bf16 pages, fp32 math.
//
// Replaces: paddle_tpu/ops/pallas/paged_attention.py, paged_decode_attention
// (the Pallas `_kernel`, launched by the pallas_call at line 215).
//
// Computes, per batch row b and query head h:
//   out[b, h] = softmax(q[b, h] . K_b^T * sm_scale) . V_b
// where K_b / V_b are the first lens[b] slots of the row's pages, looked up
// through tables[b, :] in a shared pool [num_pages, nkv, page, d].  Table
// entries past ceil(lens[b] / page) point at the junk page 0; they are never
// read.  A row with lens[b] == 0 writes zeros.
//
// What bounds it on the card: bytes.  One decode token does 4*d FLOPs per
// (head, key) pair against 4*d bytes of K and V per (kv head, key): about
// g = n/nkv FLOPs per byte, far below the ~295 FLOPs/byte where an H100's
// bf16 tensor cores would be the limit.  The floor is reading every used K/V
// byte of the pool once at 3.35 TB/s.
//
// What the design does about it:
// * One block per (row, kv head).  The g query heads of a GQA group share the
//   block, so each K/V page is read from device memory once for the whole
//   group (the point of the TPU kernel's one-step-per-(row, page) grid).
// * Only the row's used pages are visited (the loop runs ceil(len/page)
//   times), and only the valid slots of the last page are loaded, so traffic
//   scales with the row's real length, not with pages_max.
// * Each page is staged in shared memory with 16-byte coalesced loads; the K
//   rows are padded by 8 bf16 so the per-key 16-byte row reads of the score
//   loop are free of bank conflicts.
// * The softmax is online (running max / sum per head in fp32), so a row of
//   any length needs one pass.
// This first version computes the dot products on the CUDA cores and does not
// overlap a page's load with the previous page's math; tensor cores (mma) and
// a cp.async / TMA double buffer are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxGroup = 16;        // q heads per kv head
constexpr int kMaxDimPerThread = 2;  // head_dim <= 2 * kThreads
constexpr int kKPad = 8;             // bf16 padding of a staged K row
constexpr float kNegInf = -1e30f;    // NEG_INF of the JAX kernels

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

size_t smem_bytes(int g, int d, int page) {
  return (size_t)page * (d + kKPad) * 2   // K page
       + (size_t)page * d * 2             // V page
       + (size_t)g * d * 4                // q of the group, fp32
       + (size_t)g * page * 4             // scores / probabilities
       + (size_t)3 * g * 4;               // running max, sum, rescale
}

__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ kpool,
                    const __nv_bfloat16* __restrict__ vpool,
                    const int* __restrict__ tables,
                    const int* __restrict__ lens,
                    __nv_bfloat16* __restrict__ out,
                    int n, int nkv, int d, int page, int pages_max,
                    float sm_scale) {
  const int b = blockIdx.x;
  const int kvh = blockIdx.y;
  const int g = n / nkv;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int kstride = d + kKPad;
  const int chunks = d / 8;          // 16-byte chunks of a row

  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* vs = ks + (size_t)page * kstride;
  float* qs = reinterpret_cast<float*>(vs + (size_t)page * d);
  float* ps = qs + g * d;
  float* m_s = ps + g * page;
  float* l_s = m_s + g;
  float* a_s = l_s + g;

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
    const size_t base = ((size_t)pid * nkv + kvh) * (size_t)page * d;
    __syncthreads();  // the previous page's readers are done with ks/vs/ps
    for (int i = tid; i < nvalid * chunks; i += kThreads) {
      const int r = i / chunks, c = i - r * chunks;
      const uint4 kk = reinterpret_cast<const uint4*>(kpool + base + (size_t)r * d)[c];
      const uint4 vv = reinterpret_cast<const uint4*>(vpool + base + (size_t)r * d)[c];
      *reinterpret_cast<uint4*>(ks + r * kstride + c * 8) = kk;
      *reinterpret_cast<uint4*>(vs + r * d + c * 8) = vv;
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
          const __nv_bfloat162* k2 = reinterpret_cast<const __nv_bfloat162*>(&kk);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float2 kf = __bfloat1622float2(k2[e]);
            dot = fmaf(qr[c * 8 + 2 * e], kf.x, dot);
            dot = fmaf(qr[c * 8 + 2 * e + 1], kf.y, dot);
          }
        }
        s = dot * sm_scale;
      }
      ps[i] = s;
    }
    __syncthreads();

    // online softmax update: one warp per head
    for (int h = warp; h < g; h += kThreads / 32) {
      float mx = kNegInf;
      for (int t = lane; t < nvalid; t += 32) mx = fmaxf(mx, ps[h * page + t]);
      mx = warp_max(mx);
      const float m_old = m_s[h];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int t = lane; t < page; t += 32) {
        const float p = t < nvalid ? expf(ps[h * page + t] - m_new) : 0.f;
        ps[h * page + t] = p;
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
        const float vf = __bfloat162float(vs[t * d + dd]);
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
// for there (the call costs about as much as a launch).
cudaError_t raise_smem_cap(const void* kernel, size_t smem) {
  constexpr int kMaxDevices = 64;
  static size_t cap[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && smem <= cap[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err == cudaSuccess && dev < kMaxDevices) cap[dev] = smem;
  return err;
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
  const int g = n / nkv;
  if (B == 0) return (int)cudaSuccess;
  const size_t smem = smem_bytes(g, d, page);
  cudaError_t err = raise_smem_cap((const void*)paged_decode_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(B, nkv);
  paged_decode_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)kpool,
      (const __nv_bfloat16*)vpool, (const int*)tables, (const int*)lens,
      (__nv_bfloat16*)out, n, nkv, d, page, pages_max, sm_scale);
  return (int)cudaGetLastError();
}

// Dynamic shared memory one launch needs; the wrapper rejects shapes above
// the card's 227 KB per block.
extern "C" long long paged_decode_attention_smem_bytes(int n, int nkv, int d,
                                                       int page) {
  return (long long)smem_bytes(n / nkv, d, page);
}
