// Fused AdamW step for Hopper (sm_90a): f32 parameters and moments, f32 or
// bf16 gradients, f32 math, updated in place.
//
// Replaces: paddle_tpu/ops/pallas/fused_adamw.py, fused_adamw (the Pallas
// `_kernel`, launched by the pallas_call at line 82).
//
// Computes, element by element, in the TPU kernel's order:
//   m' = b1 * m + (1 - b1) * g
//   v' = b2 * v + (1 - b2) * g * g
//   p' = p * (1 - lr * wd) - lr * (m' / c1) / (sqrt(v' / c2) + eps)
// with the bias corrections c1 = 1 - b1^t and c2 = 1 - b2^t computed by the
// caller.  p, m and v are overwritten.
//
// What bounds it on the card: bytes.  p, g, m and v are read once and p, m
// and v written once, 28 bytes a parameter with f32 gradients, against about
// a dozen FLOPs.
//
// What the design does about it:
// * One pass: both moments and the parameter are updated from registers, so
//   nothing goes to device memory between the three updates.
// * Every access is a 16-byte vector (8 bytes for bf16 gradients), four
//   elements a thread; the last, partial group falls back to scalar
//   accesses, so any element count runs without a padded copy (the TPU
//   kernel's [rows, 128] zero padding is a tiling matter of that machine).
// * The compiler may contract a multiply and an add into one fused
//   multiply-add, which rounds once where the plain version rounds twice:
//   the two agree to a few units in the last place, not bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

struct Hyper {
  float lr, b1, b2, omb1, omb2, eps, wd, c1, c2;
};

__device__ __forceinline__ void update(float& p, float g, float& m, float& v,
                                       const Hyper& h) {
  const float m_new = h.b1 * m + h.omb1 * g;
  const float v_new = h.b2 * v + h.omb2 * g * g;
  const float mhat = m_new / h.c1;
  const float vhat = v_new / h.c2;
  p = p * (1.f - h.lr * h.wd) - h.lr * mhat / (sqrtf(vhat) + h.eps);
  m = m_new;
  v = v_new;
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ void load4(const float* g, float* f) {
  const float4 v = *reinterpret_cast<const float4*>(g);
  f[0] = v.x; f[1] = v.y; f[2] = v.z; f[3] = v.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* g, float* f) {
  const uint2 raw = *reinterpret_cast<const uint2*>(g);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
  const float2 a = __bfloat1622float2(h[0]), b = __bfloat1622float2(h[1]);
  f[0] = a.x; f[1] = a.y; f[2] = b.x; f[3] = b.y;
}

// one thread per group of four consecutive elements
template <typename G>
__global__ void __launch_bounds__(kThreads)
adamw_kernel(float* __restrict__ p, const G* __restrict__ g,
             float* __restrict__ m, float* __restrict__ v, long long n,
             Hyper h) {
  const long long i = ((long long)blockIdx.x * kThreads + threadIdx.x) * 4;
  if (i >= n) return;
  if (i + 4 <= n) {
    float4 pp = *reinterpret_cast<const float4*>(p + i);
    float4 mm = *reinterpret_cast<const float4*>(m + i);
    float4 vv = *reinterpret_cast<const float4*>(v + i);
    float gg[4];
    load4(g + i, gg);
    update(pp.x, gg[0], mm.x, vv.x, h);
    update(pp.y, gg[1], mm.y, vv.y, h);
    update(pp.z, gg[2], mm.z, vv.z, h);
    update(pp.w, gg[3], mm.w, vv.w, h);
    *reinterpret_cast<float4*>(p + i) = pp;
    *reinterpret_cast<float4*>(m + i) = mm;
    *reinterpret_cast<float4*>(v + i) = vv;
  } else {
    for (long long j = i; j < n; ++j) {
      float pp = p[j], mm = m[j], vv = v[j];
      update(pp, to_float(g[j]), mm, vv, h);
      p[j] = pp;
      m[j] = mm;
      v[j] = vv;
    }
  }
}

}  // namespace

// p, m, v [n] f32, g [n] f32 or bf16 (g_is_bf16), contiguous; p, m, v and an
// f32 g on 16-byte boundaries, a bf16 g on an 8-byte boundary (the wrapper
// checks).  omb1 = 1 - b1 and omb2 = 1 - b2, rounded from double by the
// caller as the TPU kernel's constants are.  Returns the launch's
// cudaError_t.
extern "C" int fused_adamw_step(void* p, const void* g, void* m, void* v,
                                long long n, int g_is_bf16, float lr,
                                float b1, float b2, float omb1, float omb2,
                                float eps, float wd, float c1, float c2,
                                void* stream) {
  if (n == 0) return (int)cudaSuccess;
  const long long groups = (n + 3) / 4;
  const long long blocks = (groups + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const Hyper h{lr, b1, b2, omb1, omb2, eps, wd, c1, c2};
  cudaStream_t st = (cudaStream_t)stream;
  if (g_is_bf16)
    adamw_kernel<__nv_bfloat16><<<(unsigned)blocks, kThreads, 0, st>>>(
        (float*)p, (const __nv_bfloat16*)g, (float*)m, (float*)v, n, h);
  else
    adamw_kernel<float><<<(unsigned)blocks, kThreads, 0, st>>>(
        (float*)p, (const float*)g, (float*)m, (float*)v, n, h);
  return (int)cudaGetLastError();
}
