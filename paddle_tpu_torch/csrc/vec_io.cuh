// Loads and stores of V consecutive elements as f32, shared by the
// elementwise and row kernels (swiglu.cu, rms_norm.cu).
//
// V == 1 is one scalar access.  Otherwise the V elements are 16 bytes of
// bf16 (V == 8) or a multiple of 16 bytes of f32 (V == 4 or 8), read and
// written as uint4 / float4 vectors: the caller guarantees the 16-byte
// alignment.  Stores round once to the element type (round to nearest
// even for bf16).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <type_traits>

namespace vec_io {

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void put(float* p, float x) { *p = x; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

template <int V, typename T>
__device__ __forceinline__ void load(const T* p, float* f) {
  if constexpr (V == 1) {
    f[0] = to_f(p[0]);
  } else if constexpr (std::is_same<T, float>::value) {
    static_assert(V % 4 == 0, "f32 vectors hold 4 elements");
#pragma unroll
    for (int e = 0; e < V; e += 4) {
      const float4 v = *reinterpret_cast<const float4*>(p + e);
      f[e] = v.x; f[e + 1] = v.y; f[e + 2] = v.z; f[e + 3] = v.w;
    }
  } else {
    static_assert(V == 8, "bf16 vectors hold 8 elements");
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 v = __bfloat1622float2(h[e]);
      f[2 * e] = v.x;
      f[2 * e + 1] = v.y;
    }
  }
}

template <int V, typename T>
__device__ __forceinline__ void store(T* p, const float* f) {
  if constexpr (V == 1) {
    put(p, f[0]);
  } else if constexpr (std::is_same<T, float>::value) {
    static_assert(V % 4 == 0, "f32 vectors hold 4 elements");
#pragma unroll
    for (int e = 0; e < V; e += 4)
      *reinterpret_cast<float4*>(p + e) =
          make_float4(f[e], f[e + 1], f[e + 2], f[e + 3]);
  } else {
    static_assert(V == 8, "bf16 vectors hold 8 elements");
    __nv_bfloat162 h[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      h[e] = __floats2bfloat162_rn(f[2 * e], f[2 * e + 1]);
    *reinterpret_cast<uint4*>(p) = *reinterpret_cast<const uint4*>(h);
  }
}

// whether every pointer given starts on a 16-byte boundary
__host__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<unsigned long long>(p) & 15ULL) == 0;
}
template <typename... P>
__host__ __forceinline__ bool aligned16(const void* p, P... rest) {
  return aligned16(p) && aligned16(rest...);
}

}  // namespace vec_io
