// SwiGLU forward and backward for Hopper (sm_90a): bf16 or f32 in and out,
// f32 math, one rounding on each store.
//
// Replaces: paddle_tpu/ops/pallas/swiglu.py, `swiglu` -- the forward
// pallas_call at line 72 (kernel body `_fwd_kernel`) and the backward one
// at line 96 (`_bwd_kernel`).
//
// Computes, element by element, with s = sigmoid(g) = 1 / (1 + exp(-g)):
//   forward   out = (g * s) * u
//   backward  dg  = do * u * s * (1 + g * (1 - s)),   du = do * (g * s)
// for gate g, up u and the output's gradient do of one shape.
//
// What bounds it on the card: bytes.  The forward reads two tensors and
// writes one, the backward reads three and writes two, against a dozen
// FLOPs an element: far below the ~295 FLOPs a byte where the arithmetic
// would be the limit.
//
// What the design does about it:
// * One pass, one thread per 16-byte vector (8 bf16 or 4 f32 elements) of
//   every operand; the backward writes dg and du in the same pass, so g, u
//   and do are read once.  The last, partial vector is done in scalars, so
//   any element count runs without a padded copy.
// * A tensor that does not start on a 16-byte boundary (a view) takes the
//   same kernel with scalar accesses; the launcher picks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "vec_io.cuh"

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float sigmoid(float g) {
  return 1.f / (1.f + expf(-g));
}

template <int V, typename T>
__global__ void __launch_bounds__(kThreads)
swiglu_fwd_kernel(const T* __restrict__ g, const T* __restrict__ u,
                  T* __restrict__ out, long long n) {
  const long long i = ((long long)blockIdx.x * kThreads + threadIdx.x) * V;
  if (i >= n) return;
  if (i + V <= n) {
    float gf[V], uf[V], of[V];
    vec_io::load<V>(g + i, gf);
    vec_io::load<V>(u + i, uf);
#pragma unroll
    for (int e = 0; e < V; ++e) of[e] = gf[e] * sigmoid(gf[e]) * uf[e];
    vec_io::store<V>(out + i, of);
  } else {
    for (long long j = i; j < n; ++j) {
      const float gj = vec_io::to_f(g[j]);
      vec_io::put(out + j, gj * sigmoid(gj) * vec_io::to_f(u[j]));
    }
  }
}

__device__ __forceinline__ void swiglu_grad(float g, float u, float d,
                                            float* dg, float* du) {
  const float s = sigmoid(g);
  *dg = d * u * s * (1.f + g * (1.f - s));
  *du = d * (g * s);
}

template <int V, typename T>
__global__ void __launch_bounds__(kThreads)
swiglu_bwd_kernel(const T* __restrict__ g, const T* __restrict__ u,
                  const T* __restrict__ dout, T* __restrict__ dg,
                  T* __restrict__ du, long long n) {
  const long long i = ((long long)blockIdx.x * kThreads + threadIdx.x) * V;
  if (i >= n) return;
  if (i + V <= n) {
    float gf[V], uf[V], df[V], a[V], b[V];
    vec_io::load<V>(g + i, gf);
    vec_io::load<V>(u + i, uf);
    vec_io::load<V>(dout + i, df);
#pragma unroll
    for (int e = 0; e < V; ++e) swiglu_grad(gf[e], uf[e], df[e], &a[e], &b[e]);
    vec_io::store<V>(dg + i, a);
    vec_io::store<V>(du + i, b);
  } else {
    for (long long j = i; j < n; ++j) {
      float a, b;
      swiglu_grad(vec_io::to_f(g[j]), vec_io::to_f(u[j]),
                  vec_io::to_f(dout[j]), &a, &b);
      vec_io::put(dg + j, a);
      vec_io::put(du + j, b);
    }
  }
}

template <int V>
long long blocks_for(long long n) {
  return ((n + V - 1) / V + kThreads - 1) / kThreads;
}

template <typename T>
int fwd(const void* g, const void* u, void* out, long long n,
        cudaStream_t st) {
  constexpr int V = 16 / sizeof(T);
  if (vec_io::aligned16(g, u, out)) {
    const long long blocks = blocks_for<V>(n);
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    swiglu_fwd_kernel<V, T><<<(unsigned)blocks, kThreads, 0, st>>>(
        (const T*)g, (const T*)u, (T*)out, n);
  } else {
    const long long blocks = blocks_for<1>(n);
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    swiglu_fwd_kernel<1, T><<<(unsigned)blocks, kThreads, 0, st>>>(
        (const T*)g, (const T*)u, (T*)out, n);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int bwd(const void* g, const void* u, const void* dout, void* dg, void* du,
        long long n, cudaStream_t st) {
  constexpr int V = 16 / sizeof(T);
  if (vec_io::aligned16(g, u, dout, dg, du)) {
    const long long blocks = blocks_for<V>(n);
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    swiglu_bwd_kernel<V, T><<<(unsigned)blocks, kThreads, 0, st>>>(
        (const T*)g, (const T*)u, (const T*)dout, (T*)dg, (T*)du, n);
  } else {
    const long long blocks = blocks_for<1>(n);
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    swiglu_bwd_kernel<1, T><<<(unsigned)blocks, kThreads, 0, st>>>(
        (const T*)g, (const T*)u, (const T*)dout, (T*)dg, (T*)du, n);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// g, u, out: n contiguous elements each, bf16 when is_bf16 else f32 (the
// wrapper checks).  Returns the launch's cudaError_t.
extern "C" int swiglu_fwd(const void* g, const void* u, void* out,
                          long long n, int is_bf16, void* stream) {
  if (n == 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  return is_bf16 ? fwd<__nv_bfloat16>(g, u, out, n, st)
                 : fwd<float>(g, u, out, n, st);
}

// g, u, dout -> dg, du: n contiguous elements each, one type as above.
extern "C" int swiglu_bwd(const void* g, const void* u, const void* dout,
                          void* dg, void* du, long long n, int is_bf16,
                          void* stream) {
  if (n == 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  return is_bf16 ? bwd<__nv_bfloat16>(g, u, dout, dg, du, n, st)
                 : bwd<float>(g, u, dout, dg, du, n, st);
}
