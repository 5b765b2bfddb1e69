// Rotate-half rotary position embedding for Hopper (sm_90a), bf16 or f32 in
// and out, f32 math.
//
// Replaces: paddle_tpu/ops/pallas/rope.py, `_apply` (the pallas_call at line
// 107, kernel body `_rope_kernel`); forward and backward of `fused_rope`.
//
// Computes, for x [B, S, N, d] and tables cos / sin [S, d/2] (f32):
//   out[..., :d/2] = x1 * cos - x2 * sin
//   out[..., d/2:] = x2 * cos + x1 * sin      (x1, x2 the halves of x)
// and with neg_sin the inverse rotation (sin -> -sin), which is the vjp.
//
// What bounds it on the card: bytes.  x is read once and out written once
// (4 bytes a bf16 element against 6 FLOPs); the tables are S * d * 4 bytes,
// a fraction of a percent of x at the training shape.
//
// What the design does about it:
// * One thread owns 16 bytes of x1 and the matching 16 bytes of x2 of one
//   (batch, position), loads its cos / sin values once and walks the heads
//   with them, so the tables are read once per position and every access to
//   x and out is a 16-byte vector.
// * The products and sums are separate f32 roundings (no fused multiply-add),
//   the plain version's arithmetic, so the two agree bit for bit.
// * Any S, N and any d with d/2 a multiple of the 16-byte vector: the grid
//   is cut over (batch * position, chunk) and the last block masks its tail,
//   so there is no shape the kernel hands back to a composite.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <typename T>
struct Vec;   // 16 bytes of T as floats

template <>
struct Vec<float> {
  static constexpr int kN = 4;
  static __device__ __forceinline__ void load(const float* p, float* f) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    f[0] = v.x; f[1] = v.y; f[2] = v.z; f[3] = v.w;
  }
  static __device__ __forceinline__ void store(float* p, const float* f) {
    *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
  }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int kN = 8;
  static __device__ __forceinline__ void load(const __nv_bfloat16* p, float* f) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 v = __bfloat1622float2(h[e]);
      f[2 * e] = v.x;
      f[2 * e + 1] = v.y;
    }
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, const float* f) {
    __nv_bfloat162 h[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) h[e] = __floats2bfloat162_rn(f[2 * e], f[2 * e + 1]);
    *reinterpret_cast<uint4*>(p) = *reinterpret_cast<const uint4*>(h);
  }
};

// rows = B * S; one thread per (row, 16-byte chunk of a half), all N heads.
template <typename T>
__global__ void __launch_bounds__(kThreads)
rope_kernel(const T* __restrict__ x, const float* __restrict__ cos_t,
            const float* __restrict__ sin_t, T* __restrict__ out,
            long long rows, int S, int N, int d, float sign) {
  constexpr int V = Vec<T>::kN;
  const int half = d / 2;
  const int chunks = half / V;
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= rows * chunks) return;
  const int c = (int)(i % chunks);
  const long long row = i / chunks;
  const int s = (int)(row % S);

  float cs[V], sn[V];
#pragma unroll
  for (int e = 0; e < V; e += 4) {
    const float4 a = *reinterpret_cast<const float4*>(
        cos_t + (size_t)s * half + c * V + e);
    const float4 b = *reinterpret_cast<const float4*>(
        sin_t + (size_t)s * half + c * V + e);
    cs[e] = a.x; cs[e + 1] = a.y; cs[e + 2] = a.z; cs[e + 3] = a.w;
    sn[e] = b.x * sign; sn[e + 1] = b.y * sign;
    sn[e + 2] = b.z * sign; sn[e + 3] = b.w * sign;
  }

  const size_t base = (size_t)row * N * d + (size_t)c * V;
#pragma unroll 4
  for (int n = 0; n < N; ++n) {
    const size_t at = base + (size_t)n * d;
    float x1[V], x2[V], lo[V], hi[V];
    Vec<T>::load(x + at, x1);
    Vec<T>::load(x + at + half, x2);
#pragma unroll
    for (int e = 0; e < V; ++e) {
      lo[e] = __fsub_rn(__fmul_rn(x1[e], cs[e]), __fmul_rn(x2[e], sn[e]));
      hi[e] = __fadd_rn(__fmul_rn(x2[e], cs[e]), __fmul_rn(x1[e], sn[e]));
    }
    Vec<T>::store(out + at, lo);
    Vec<T>::store(out + at + half, hi);
  }
}

template <typename T>
int launch(const void* x, const void* cos_t, const void* sin_t, void* out,
           int B, int S, int N, int d, int neg_sin, cudaStream_t stream) {
  const long long rows = (long long)B * S;
  const long long threads = rows * (d / 2 / Vec<T>::kN);
  const long long blocks = (threads + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  rope_kernel<T><<<(unsigned)blocks, kThreads, 0, stream>>>(
      (const T*)x, (const float*)cos_t, (const float*)sin_t, (T*)out, rows, S,
      N, d, neg_sin ? -1.f : 1.f);
  return (int)cudaGetLastError();
}

}  // namespace

// x, out [B, S, N, d] (bf16 when is_bf16 else f32), cos / sin [S, d/2] f32,
// all contiguous and on 16-byte boundaries; d/2 a multiple of 8 (bf16) or 4
// (f32) -- the wrapper checks.  Returns the launch's cudaError_t.
extern "C" int fused_rope_apply(const void* x, const void* cos_t,
                                const void* sin_t, void* out, int B, int S,
                                int N, int d, int neg_sin, int is_bf16,
                                void* stream) {
  if (B == 0 || S == 0 || N == 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  if (is_bf16)
    return launch<__nv_bfloat16>(x, cos_t, sin_t, out, B, S, N, d, neg_sin, st);
  return launch<float>(x, cos_t, sin_t, out, B, S, N, d, neg_sin, st);
}
