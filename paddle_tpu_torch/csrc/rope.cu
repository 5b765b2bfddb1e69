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
// * A thread owns one 16-byte chunk of x1 and the matching chunk of x2 for
//   a group of G heads of one (batch, position) row: heads g, g + ng, ...,
//   g + (G - 1) * ng, with ng = ceil(N / G) groups a row.  It issues all
//   2 * G loads before its first store, so each thread keeps 32 * G bytes
//   in flight, and loads its cos / sin values once for the G heads.
// * The host picks G per shape: the largest of 4, 2 (no more than N) whose
//   grid still gives every SM kMinCtasPerSm blocks, else 1.  The trainer's
//   [8, 2048, 16, 128] takes G = 4 (2,048 blocks), the serving wave
//   [8, 256, 32, 128] G = 2 (1,024) and a one-request wave G = 1 (256 for
//   256 tokens), where the first design, one thread walking all N heads,
//   left most SMs idle (64 blocks, and 8 for a single 256-token request).
//   G = 8 (126 registers in bf16, two blocks an SM) read 2% slower than
//   G = 4 at the trainer's shape on the H100, so 4 is the largest group.
// * The threads of one row sit next to each other in a block (chunk
//   fastest, then head group), so a row's cos / sin slice comes from DRAM
//   once and from L1 for the other groups, and a warp's accesses to x and
//   out are whole 128-byte lines of 16-byte vectors.
// * The products and sums are separate f32 roundings (no fused multiply-add),
//   the plain version's arithmetic, so the two agree bit for bit.
// * Any S, N and any d with d/2 a multiple of the 16-byte vector: the head
//   tail (N no multiple of G) and the grid's tail are masked in the kernel,
//   so there is no shape the kernel hands back to a composite.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
// blocks of kThreads an SM that a head group may not take the grid below
constexpr int kMinCtasPerSm = 4;
constexpr int kMaxDevices = 64;

template <typename T>
struct Vec;   // 16 bytes of T, unpacked to and packed from floats

template <>
struct Vec<float> {
  static constexpr int kN = 4;
  static __device__ __forceinline__ void unpack(const uint4& raw, float* f) {
    f[0] = __uint_as_float(raw.x); f[1] = __uint_as_float(raw.y);
    f[2] = __uint_as_float(raw.z); f[3] = __uint_as_float(raw.w);
  }
  static __device__ __forceinline__ uint4 pack(const float* f) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                      __float_as_uint(f[2]), __float_as_uint(f[3]));
  }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int kN = 8;
  static __device__ __forceinline__ void unpack(const uint4& raw, float* f) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 v = __bfloat1622float2(h[e]);
      f[2 * e] = v.x;
      f[2 * e + 1] = v.y;
    }
  }
  static __device__ __forceinline__ uint4 pack(const float* f) {
    uint4 raw;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
    for (int e = 0; e < 4; ++e) h[e] = __floats2bfloat162_rn(f[2 * e], f[2 * e + 1]);
    return raw;
  }
};

// One thread per (row, head group, 16-byte chunk of a half); rows = B * S,
// total = rows * ng * chunks threads.
template <typename T, int G>
__global__ void __launch_bounds__(kThreads)
rope_kernel(const T* __restrict__ x, const float* __restrict__ cos_t,
            const float* __restrict__ sin_t, T* __restrict__ out,
            unsigned total, int S, int N, int ng, int chunks, int d,
            float sign) {
  constexpr int V = Vec<T>::kN;
  const unsigned i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= total) return;
  const int c = (int)(i % (unsigned)chunks);
  const unsigned t = i / (unsigned)chunks;
  const int g = (int)(t % (unsigned)ng);
  const unsigned row = t / (unsigned)ng;
  const int s = (int)(row % (unsigned)S);
  const int half = d / 2;
  const T* xr = x + (size_t)row * N * d + (size_t)c * V;
  T* outr = out + (size_t)row * N * d + (size_t)c * V;

  // every load of the group first: x1 and x2 of each of its heads
  uint4 raw1[G], raw2[G];
#pragma unroll
  for (int k = 0; k < G; ++k) {
    const int h = g + k * ng;
    if (h < N) {
      raw1[k] = *reinterpret_cast<const uint4*>(xr + (size_t)h * d);
      raw2[k] = *reinterpret_cast<const uint4*>(xr + (size_t)h * d + half);
    }
  }
  float cs[V], sn[V];
  const float* ct = cos_t + (size_t)s * half + c * V;
  const float* st = sin_t + (size_t)s * half + c * V;
#pragma unroll
  for (int e = 0; e < V; e += 4) {
    const float4 a = *reinterpret_cast<const float4*>(ct + e);
    const float4 b = *reinterpret_cast<const float4*>(st + e);
    cs[e] = a.x; cs[e + 1] = a.y; cs[e + 2] = a.z; cs[e + 3] = a.w;
    sn[e] = b.x * sign; sn[e + 1] = b.y * sign;
    sn[e + 2] = b.z * sign; sn[e + 3] = b.w * sign;
  }

#pragma unroll
  for (int k = 0; k < G; ++k) {
    const int h = g + k * ng;
    if (h < N) {
      float x1[V], x2[V], lo[V], hi[V];
      Vec<T>::unpack(raw1[k], x1);
      Vec<T>::unpack(raw2[k], x2);
#pragma unroll
      for (int e = 0; e < V; ++e) {
        lo[e] = __fsub_rn(__fmul_rn(x1[e], cs[e]), __fmul_rn(x2[e], sn[e]));
        hi[e] = __fadd_rn(__fmul_rn(x2[e], cs[e]), __fmul_rn(x1[e], sn[e]));
      }
      *reinterpret_cast<uint4*>(outr + (size_t)h * d) = Vec<T>::pack(lo);
      *reinterpret_cast<uint4*>(outr + (size_t)h * d + half) =
          Vec<T>::pack(hi);
    }
  }
}

// The current device's SM count, read once per device.
int sm_count(int* sms_out) {
  static int sms[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < kMaxDevices && sms[dev]) {
    *sms_out = sms[dev];
    return (int)cudaSuccess;
  }
  err = cudaDeviceGetAttribute(sms_out, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess && dev < kMaxDevices) sms[dev] = *sms_out;
  return (int)err;
}

struct Plan {
  int group, ng, chunks;
  long long threads, blocks;
};

Plan plan_of(long long rows, int N, int chunks, int sms) {
  Plan p{1, N, chunks, 0, 0};
  for (int G = 4; G >= 1; G /= 2) {
    if (G > N && G > 1) continue;
    p.group = G;
    p.ng = (N + G - 1) / G;
    p.threads = rows * p.ng * chunks;
    p.blocks = (p.threads + kThreads - 1) / kThreads;
    if (p.blocks >= (long long)kMinCtasPerSm * sms) break;
  }
  return p;
}

template <typename T, int G>
void launch_group(const Plan& p, const void* x, const void* cos_t,
                  const void* sin_t, void* out, int S, int N, int d,
                  float sign, cudaStream_t stream) {
  rope_kernel<T, G><<<(unsigned)p.blocks, kThreads, 0, stream>>>(
      (const T*)x, (const float*)cos_t, (const float*)sin_t, (T*)out,
      (unsigned)p.threads, S, N, p.ng, p.chunks, d, sign);
}

template <typename T>
int launch(const void* x, const void* cos_t, const void* sin_t, void* out,
           int B, int S, int N, int d, int neg_sin, cudaStream_t stream) {
  int sms = 0;
  const int err = sm_count(&sms);
  if (err) return err;
  const Plan p = plan_of((long long)B * S, N, d / 2 / Vec<T>::kN, sms);
  if (p.threads > 0xffffffffLL) return (int)cudaErrorInvalidValue;
  const float sign = neg_sin ? -1.f : 1.f;
  switch (p.group) {
    case 4: launch_group<T, 4>(p, x, cos_t, sin_t, out, S, N, d, sign, stream); break;
    case 2: launch_group<T, 2>(p, x, cos_t, sin_t, out, S, N, d, sign, stream); break;
    default: launch_group<T, 1>(p, x, cos_t, sin_t, out, S, N, d, sign, stream);
  }
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

// The head group G and the grid (blocks of 256 threads) that
// fused_rope_apply launches for these arguments on the current device.
// Returns the SM-count query's cudaError_t.
extern "C" int fused_rope_plan(int B, int S, int N, int d, int is_bf16,
                               int* group, long long* blocks) {
  int sms = 0;
  const int err = sm_count(&sms);
  if (err) return err;
  const Plan p = plan_of((long long)B * S, N, d / 2 / (is_bf16 ? 8 : 4), sms);
  *group = p.group;
  *blocks = p.blocks;
  return (int)cudaSuccess;
}
