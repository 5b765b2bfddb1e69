// RMSNorm forward and backward for Hopper (sm_90a): x bf16 or f32, weight
// bf16 or f32, f32 math, one rounding on each store.
//
// Replaces: paddle_tpu/ops/pallas/rms_norm.py, `rms_norm` -- the forward
// pallas_call at line 91 (kernel body `_fwd_kernel`) and the backward one
// at line 114 (`_bwd_kernel`).
//
// Computes, for rows x [n, h] and the weight w [h]:
//   forward   rstd = rsqrt(mean(x * x) + eps)            (f32, saved [n])
//             out  = (x * rstd) * w    in promote(x, w)
//   backward  xhat = x * rstd,  wdo = w * do,  c = mean(xhat * wdo)
//             dx   = (wdo - xhat * c) * rstd    in x's type
//             dw   = sum over rows of xhat * do (f32)
//
// What bounds it on the card: bytes.  The forward reads x and writes out
// (4 bytes a bf16 element against 4 FLOPs), the backward reads x and do and
// writes dx.
//
// What the design does about it:
// * Forward: each row is read from device memory once, into registers.  A
//   row of h = 8 * NV * 32 * WPR elements at most is held by WPR warps,
//   NV vectors of 8 elements a lane, NV <= 4 (h = 1024: one warp; 2048:
//   two; 4096: four; 8192: eight), with a compile-time trip count, so
//   every load of the row is issued before the sum of squares; the WPR
//   warps of a row add their sums through shared memory.  x is loaded past
//   L1 (no L1 allocation: nothing reads it twice) and out stored
//   evict-first.  The weight's vectors stay in registers while a block
//   walks its rows (grid sized to the resident blocks of the SMs, each
//   block the same number of row groups).  A row no multiple of 8, a
//   tensor off a 16-byte boundary or h beyond 8192 takes the generic
//   kernel: one warp per row, a loop over the row for the sum and another
//   for the store (scalar accesses when not aligned).
// * Backward: the TPU kernel carries dw in one grid-resident (8, h) f32
//   block across a sequential grid.  Hopper's blocks run in no order, so
//   each block owns a contiguous run of rows and sums their xhat * do into
//   an f32 row of shared memory, one column per thread and no atomics, and
//   writes it as its row of a [blocks, h] partials tensor; the wrapper sums
//   the partials with one reduction, as JAX sums its slab outside the
//   kernel.  The mapping of rows to blocks depends only on the shapes, so
//   the result is bit-identical from run to run.  Each row's mean(xhat *
//   wdo) is a block reduction; the block reads the row's x and do twice,
//   the second time from the caches.
// * A row length that is no multiple of 8, or a tensor off a 16-byte
//   boundary, takes the same kernels with scalar accesses.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "vec_io.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSmem = 227 * 1024;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// eight elements of T, as they are in memory, in registers
template <typename T> struct Raw8 { uint4 u[sizeof(T) / 2]; };

template <typename T>
__device__ __forceinline__ void load_stream(Raw8<T>& r, const T* p) {
#pragma unroll
  for (int i = 0; i < (int)sizeof(T) / 2; ++i)
    asm("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];\n"
        : "=r"(r.u[i].x), "=r"(r.u[i].y), "=r"(r.u[i].z), "=r"(r.u[i].w)
        : "l"(reinterpret_cast<const uint4*>(p) + i));
}
template <typename T>
__device__ __forceinline__ void load_cached(Raw8<T>& r, const T* p) {
#pragma unroll
  for (int i = 0; i < (int)sizeof(T) / 2; ++i)
    r.u[i] = __ldg(reinterpret_cast<const uint4*>(p) + i);
}
template <typename T>
__device__ __forceinline__ void zero(Raw8<T>& r) {
#pragma unroll
  for (int i = 0; i < (int)sizeof(T) / 2; ++i) r.u[i] = make_uint4(0, 0, 0, 0);
}

// the eight elements as f32
__device__ __forceinline__ void to_f32(const Raw8<__nv_bfloat16>& r, float* f) {
  const uint32_t w[4] = {r.u[0].x, r.u[0].y, r.u[0].z, r.u[0].w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ void to_f32(const Raw8<float>& r, float* f) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    f[4 * i] = __uint_as_float(r.u[i].x);
    f[4 * i + 1] = __uint_as_float(r.u[i].y);
    f[4 * i + 2] = __uint_as_float(r.u[i].z);
    f[4 * i + 3] = __uint_as_float(r.u[i].w);
  }
}

// eight f32 rounded once to T and stored evict-first
__device__ __forceinline__ void store_stream(__nv_bfloat16* p, const float* f) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
    w[i] = *reinterpret_cast<const uint32_t*>(&v);
  }
  __stcs(reinterpret_cast<uint4*>(p), make_uint4(w[0], w[1], w[2], w[3]));
}
__device__ __forceinline__ void store_stream(float* p, const float* f) {
  __stcs(reinterpret_cast<float4*>(p), make_float4(f[0], f[1], f[2], f[3]));
  __stcs(reinterpret_cast<float4*>(p) + 1,
         make_float4(f[4], f[5], f[6], f[7]));
}

// Rows held in registers: WPR warps a row, NV vectors of 8 elements a lane
// (vector c of the row at lane c % (32 WPR) of the row's warps, slot
// c / (32 WPR)), kThreads / (32 WPR) rows a block pass; the block walks row
// groups blockIdx.x, + gridDim.x, ...  h % 8 == 0, every tensor on a
// 16-byte boundary, h <= 8 * NV * 32 * WPR.
template <int NV, int WPR, typename TX, typename TW, typename TO>
__global__ void __launch_bounds__(kThreads)
rms_fwd_rows_kernel(const TX* __restrict__ x, const TW* __restrict__ w,
                    TO* __restrict__ out, float* __restrict__ rstd,
                    long long n, int h, float eps) {
  constexpr int kTPR = 32 * WPR;            // threads a row
  constexpr int kRows = kThreads / kTPR;    // rows a block pass
  __shared__ float red[2][kWarps];          // the row's warp sums, by parity
  const int rt = threadIdx.x % kTPR, rr = threadIdx.x / kTPR;
  const int chunks = h / 8;
  Raw8<TW> wv[NV];
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int c = rt + j * kTPR;
    if (c < chunks) load_cached(wv[j], w + c * 8);
    else zero(wv[j]);
  }
  const long long groups = (n + kRows - 1) / kRows;
  int parity = 0;
  for (long long gi = blockIdx.x; gi < groups; gi += gridDim.x) {
    const long long row = gi * kRows + rr;
    const bool live = row < n;
    const TX* xr = x + row * h;
    Raw8<TX> xv[NV];
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int c = rt + j * kTPR;
      if (live && c < chunks) load_stream(xv[j], xr + c * 8);
      else zero(xv[j]);
    }
    float ss = 0.f;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      float f[8];
      to_f32(xv[j], f);
#pragma unroll
      for (int e = 0; e < 8; ++e) ss += f[e] * f[e];
    }
    ss = warp_sum(ss);
    if constexpr (WPR > 1) {
      // one barrier a pass: a warp writes this pass's half only after
      // every warp has read the other half in the pass before
      if (threadIdx.x % 32 == 0) red[parity][threadIdx.x / 32] = ss;
      __syncthreads();
      ss = 0.f;
#pragma unroll
      for (int i = 0; i < WPR; ++i) ss += red[parity][rr * WPR + i];
      parity ^= 1;
    }
    const float r = rsqrtf(ss / (float)h + eps);
    if (live) {
      TO* orow = out + row * h;
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        const int c = rt + j * kTPR;
        if (c >= chunks) continue;
        float xf[8], wf[8], of[8];
        to_f32(xv[j], xf);
        to_f32(wv[j], wf);
#pragma unroll
        for (int e = 0; e < 8; ++e) of[e] = xf[e] * r * wf[e];
        store_stream(orow + c * 8, of);
      }
      if (rt == 0) rstd[row] = r;
    }
  }
}

// generic: one warp per row, a loop over the row for the sum and another
// for the scaled store (V elements an access: 8, or 1 when unaligned)
template <int V, typename TX, typename TW, typename TO>
__global__ void __launch_bounds__(kThreads)
rms_fwd_kernel(const TX* __restrict__ x, const TW* __restrict__ w,
               TO* __restrict__ out, float* __restrict__ rstd, long long n,
               int h, float eps) {
  const long long row = (long long)blockIdx.x * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= n) return;
  const TX* xr = x + row * h;
  TO* orow = out + row * h;
  const int chunks = h / V;
  float ss = 0.f;
  for (int c = lane; c < chunks; c += 32) {
    float xf[V];
    vec_io::load<V>(xr + c * V, xf);
#pragma unroll
    for (int e = 0; e < V; ++e) ss += xf[e] * xf[e];
  }
  ss = warp_sum(ss);
  const float r = rsqrtf(ss / (float)h + eps);
  for (int c = lane; c < chunks; c += 32) {
    float xf[V], wf[V], of[V];
    vec_io::load<V>(xr + c * V, xf);
    vec_io::load<V>(w + c * V, wf);
#pragma unroll
    for (int e = 0; e < V; ++e) of[e] = xf[e] * r * wf[e];
    vec_io::store<V>(orow + c * V, of);
  }
  if (lane == 0) rstd[row] = r;
}

// sum of v over the block, returned to every thread; red holds kWarps f32
__device__ __forceinline__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  __syncthreads();                      // red is free from the last use
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float total = 0.f;
#pragma unroll
  for (int i = 0; i < kWarps; ++i) total += red[i];
  return total;
}

// block b owns rows [b * rows_per_block, min(n, (b + 1) * rows_per_block))
// and writes partials[b, :]; dynamic shared memory holds h f32
template <int V, typename TX, typename TW, typename TO>
__global__ void __launch_bounds__(kThreads)
rms_bwd_kernel(const TX* __restrict__ x, const TW* __restrict__ w,
               const float* __restrict__ rstd, const TO* __restrict__ dout,
               TX* __restrict__ dx, float* __restrict__ partials,
               long long n, int h, int rows_per_block) {
  extern __shared__ float dw[];
  __shared__ float red[kWarps];
  const int chunks = h / V;
  for (int c = threadIdx.x; c < chunks; c += kThreads)
#pragma unroll
    for (int e = 0; e < V; ++e) dw[c * V + e] = 0.f;
  const long long r0 = (long long)blockIdx.x * rows_per_block;
  const long long r1 = min(n, r0 + rows_per_block);
  for (long long row = r0; row < r1; ++row) {
    const TX* xr = x + row * h;
    const TO* dr = dout + row * h;
    const float r = rstd[row];
    float part = 0.f;
    for (int c = threadIdx.x; c < chunks; c += kThreads) {
      float xf[V], wf[V], df[V];
      vec_io::load<V>(xr + c * V, xf);
      vec_io::load<V>(w + c * V, wf);
      vec_io::load<V>(dr + c * V, df);
#pragma unroll
      for (int e = 0; e < V; ++e) part += (xf[e] * r) * (wf[e] * df[e]);
    }
    const float cmean = block_sum(part, red) / (float)h;
    for (int c = threadIdx.x; c < chunks; c += kThreads) {
      float xf[V], wf[V], df[V], of[V];
      vec_io::load<V>(xr + c * V, xf);
      vec_io::load<V>(w + c * V, wf);
      vec_io::load<V>(dr + c * V, df);
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const float xhat = xf[e] * r;
        of[e] = (wf[e] * df[e] - xhat * cmean) * r;
        dw[c * V + e] += xhat * df[e];
      }
      vec_io::store<V>(dx + row * h + c * V, of);
    }
  }
  // each thread wrote only its own columns of dw: no barrier needed here
  float* prow = partials + (long long)blockIdx.x * h;
  for (int c = threadIdx.x; c < chunks; c += kThreads)
#pragma unroll
    for (int e = 0; e < V; ++e) prow[c * V + e] = dw[c * V + e];
}

// the SMs of the current device, looked up once per device
int sm_count() {
  static int sms[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (dev >= 64) {
    int v = 0;
    cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, dev);
    return v;
  }
  if (sms[dev] == 0)
    cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
  return sms[dev];
}

template <int NV, int WPR, typename TX, typename TW, typename TO>
int fwd_rows(const void* x, const void* w, void* out, void* rstd,
             long long n, int h, float eps, cudaStream_t st) {
  auto kernel = rms_fwd_rows_kernel<NV, WPR, TX, TW, TO>;
  static int per_sm = 0;    // resident blocks an SM, asked once
  if (per_sm == 0) {
    const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel, kThreads, 0);
    if (e != cudaSuccess) return (int)e;
    if (per_sm < 1) per_sm = 1;
  }
  constexpr int kRows = kThreads / (32 * WPR);
  const long long groups = (n + kRows - 1) / kRows;
  // as many blocks as the SMs hold, each walking the same number of row
  // groups (the last block fewer)
  const long long most = (long long)per_sm * (sm_count() > 0 ? sm_count() : 1);
  const long long passes = (groups + most - 1) / most;
  const long long blocks = (groups + passes - 1) / passes;
  kernel<<<(unsigned)blocks, kThreads, 0, st>>>(
      (const TX*)x, (const TW*)w, (TO*)out, (float*)rstd, n, h, eps);
  return (int)cudaGetLastError();
}

template <typename TX, typename TW, typename TO>
int fwd(const void* x, const void* w, void* out, void* rstd, long long n,
        int h, float eps, cudaStream_t st) {
  if (h % 8 == 0 && vec_io::aligned16(x, w, out)) {
    // the register-held instances: at most 4 vectors a lane, more warps a
    // row beyond (8 a lane ran 2-6% slower at [16384, 2048], [2048, 4096]
    // and [8, 4096] in bf16: fewer resident warps)
    const int chunks = h / 8;
#define ROWS(NV, WPR) \
  return fwd_rows<NV, WPR, TX, TW, TO>(x, w, out, rstd, n, h, eps, st)
    if (chunks <= 32) ROWS(1, 1);
    if (chunks <= 64) ROWS(2, 1);
    if (chunks <= 128) ROWS(4, 1);
    if (chunks <= 256) ROWS(4, 2);
    if (chunks <= 512) ROWS(4, 4);
    if (chunks <= 1024) ROWS(4, 8);
#undef ROWS
  }
  const long long blocks = (n + kWarps - 1) / kWarps;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (h % 8 == 0 && vec_io::aligned16(x, w, out))
    rms_fwd_kernel<8, TX, TW, TO><<<(unsigned)blocks, kThreads, 0, st>>>(
        (const TX*)x, (const TW*)w, (TO*)out, (float*)rstd, n, h, eps);
  else
    rms_fwd_kernel<1, TX, TW, TO><<<(unsigned)blocks, kThreads, 0, st>>>(
        (const TX*)x, (const TW*)w, (TO*)out, (float*)rstd, n, h, eps);
  return (int)cudaGetLastError();
}

template <int V, typename TX, typename TW, typename TO>
int bwd_launch(const void* x, const void* w, const void* rstd,
               const void* dout, void* dx, void* partials, long long n,
               int h, int rows_per_block, cudaStream_t st) {
  const size_t smem = (size_t)h * sizeof(float);
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  auto kernel = rms_bwd_kernel<V, TX, TW, TO>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const long long blocks = (n + rows_per_block - 1) / rows_per_block;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, kThreads, smem, st>>>(
      (const TX*)x, (const TW*)w, (const float*)rstd, (const TO*)dout,
      (TX*)dx, (float*)partials, n, h, rows_per_block);
  return (int)cudaGetLastError();
}

template <typename TX, typename TW, typename TO>
int bwd(const void* x, const void* w, const void* rstd, const void* dout,
        void* dx, void* partials, long long n, int h, int rows_per_block,
        cudaStream_t st) {
  if (h % 8 == 0 && vec_io::aligned16(x, w, dout, dx))
    return bwd_launch<8, TX, TW, TO>(x, w, rstd, dout, dx, partials, n, h,
                                     rows_per_block, st);
  return bwd_launch<1, TX, TW, TO>(x, w, rstd, dout, dx, partials, n, h,
                                   rows_per_block, st);
}

}  // namespace

using bf16 = __nv_bfloat16;

// x [n, h] (bf16 when x_bf16 else f32), w [h] (bf16 when w_bf16 else f32)
// -> out [n, h] in promote(x, w) (bf16 only when both are), rstd [n] f32.
// All contiguous (the wrapper checks).  Returns the launch's cudaError_t.
extern "C" int rms_norm_fwd(const void* x, const void* w, void* out,
                            void* rstd, long long n, int h, float eps,
                            int x_bf16, int w_bf16, void* stream) {
  if (n == 0 || h == 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  if (x_bf16 && w_bf16) return fwd<bf16, bf16, bf16>(x, w, out, rstd, n, h, eps, st);
  if (x_bf16) return fwd<bf16, float, float>(x, w, out, rstd, n, h, eps, st);
  if (w_bf16) return fwd<float, bf16, float>(x, w, out, rstd, n, h, eps, st);
  return fwd<float, float, float>(x, w, out, rstd, n, h, eps, st);
}

// x [n, h], w [h], rstd [n] f32 (from rms_norm_fwd), dout [n, h] in
// promote(x, w) -> dx [n, h] in x's type and partials
// [ceil(n / rows_per_block), h] f32, whose sum over rows is dw.
extern "C" int rms_norm_bwd(const void* x, const void* w, const void* rstd,
                            const void* dout, void* dx, void* partials,
                            long long n, int h, int rows_per_block,
                            int x_bf16, int w_bf16, void* stream) {
  if (n == 0 || h == 0) return (int)cudaSuccess;
  if (rows_per_block < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (x_bf16 && w_bf16)
    return bwd<bf16, bf16, bf16>(x, w, rstd, dout, dx, partials, n, h,
                                 rows_per_block, st);
  if (x_bf16)
    return bwd<bf16, float, float>(x, w, rstd, dout, dx, partials, n, h,
                                   rows_per_block, st);
  if (w_bf16)
    return bwd<float, bf16, float>(x, w, rstd, dout, dx, partials, n, h,
                                   rows_per_block, st);
  return bwd<float, float, float>(x, w, rstd, dout, dx, partials, n, h,
                                  rows_per_block, st);
}
