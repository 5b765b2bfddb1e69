// Tiles and tensor-core steps shared by the flash attention backward
// kernels (csrc/flash_attention.cu, K6b-c) and the segmented backward
// (csrc/flash_varlen_bwd.cu, K7a-b): 64-row bf16 tiles staged in shared
// memory with padded rows, nvcuda::wmma 16x16x16 products with f32
// accumulators, four warps of 16 rows a block.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include "hopper_sm90.cuh"   // hopper::raise_smem

namespace {

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

constexpr int kT = 64;          // rows of a q tile, keys of a k tile
constexpr int kThreads = 128;   // 4 warps, 16 rows each
constexpr int kWarps = kThreads / 32;
constexpr int kPad = 8;         // bf16 padding of a staged row
constexpr int kSLD = kT + 4;    // f32 row stride of a warp's score tile
constexpr int kPLD = kT + 8;    // bf16 row stride of a warp's probability tile
constexpr float kNegInf = -1e30f;   // NEG_INF of the JAX kernels

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
using FragBRow = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>;
using FragBCol = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

// bytes of shared memory, each region a multiple of 32 bytes (wmma's
// pointers must be 32-byte aligned)
template <int D> __host__ __device__ constexpr int tile_bytes() { return kT * (D + kPad) * 2; }
constexpr int kScoreBytes = kWarps * 16 * kSLD * 4;
constexpr int kProbBytes = kWarps * 16 * kPLD * 2;

// Rows [r0, r0 + 64) of one (batch row, head) stream into a padded tile;
// rows past S are zero-filled.  src points at the stream's row 0.
template <int D>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, int r0,
                                          int S, size_t row_stride) {
  constexpr int kChunks = D / 8;
  constexpr int LD = D + kPad;
  for (int i = threadIdx.x; i < kT * kChunks; i += kThreads) {
    const int r = i / kChunks, c = i - r * kChunks;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (r0 + r < S)
      val = *reinterpret_cast<const uint4*>(src + (size_t)(r0 + r) * row_stride + c * 8);
    *reinterpret_cast<uint4*>(dst + r * LD + c * 8) = val;
  }
}

// acc[j] = a[16 x D] . b[64 x D]^T for the four 16-column groups j; both
// row-major with stride D + kPad.
template <int D>
__device__ __forceinline__ void mma_abt(FragC (&acc)[4], const bf16* a, const bf16* b) {
  constexpr int LD = D + kPad;
#pragma unroll
  for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[j], 0.f);
#pragma unroll
  for (int kk = 0; kk < D; kk += 16) {
    FragA fa;
    wmma::load_matrix_sync(fa, a + kk, LD);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      FragBCol fb;
      wmma::load_matrix_sync(fb, b + j * 16 * LD + kk, LD);
      wmma::mma_sync(acc[j], fa, fb, acc[j]);
    }
  }
}

__device__ __forceinline__ void store_scores(float* dst, FragC (&acc)[4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
    wmma::store_matrix_sync(dst + j * 16, acc[j], kSLD, wmma::mem_row_major);
}

// acc[f] += p[16 x 64] . b[64 x D] for the D / 16 column groups f; p
// row-major with stride kPLD, b row-major with stride D + kPad.
template <int D>
__device__ __forceinline__ void mma_pb(FragC (&acc)[D / 16], const bf16* p, const bf16* b) {
  constexpr int LD = D + kPad;
#pragma unroll
  for (int kk = 0; kk < kT; kk += 16) {
    FragA fa;
    wmma::load_matrix_sync(fa, p + kk, kPLD);
#pragma unroll
    for (int f = 0; f < D / 16; ++f) {
      FragBRow fb;
      wmma::load_matrix_sync(fb, b + kk * LD + f * 16, LD);
      wmma::mma_sync(acc[f], fa, fb, acc[f]);
    }
  }
}

// A warp's 16 x D accumulators, rounded to bf16, to rows row0.. of dst (the
// stream's row 0); `stage` is the warp's [16][D + 4] f32 scratch.
template <int D>
__device__ __forceinline__ void store_rows(FragC (&acc)[D / 16], float* stage,
                                           bf16* dst, int row0, int S,
                                           size_t row_stride, int lane) {
  constexpr int OLD = D + 4;
  constexpr int kChunks = D / 8;
  __syncwarp();
#pragma unroll
  for (int f = 0; f < D / 16; ++f)
    wmma::store_matrix_sync(stage + f * 16, acc[f], OLD, wmma::mem_row_major);
  __syncwarp();
  for (int i = lane; i < 16 * kChunks; i += 32) {
    const int r = i / kChunks, c = i - r * kChunks;
    if (row0 + r >= S) continue;
    const float* s = stage + r * OLD + c * 8;
    __nv_bfloat162 o[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) o[e] = __floats2bfloat162_rn(s[2 * e], s[2 * e + 1]);
    *reinterpret_cast<uint4*>(dst + (size_t)(row0 + r) * row_stride + c * 8) =
        *reinterpret_cast<const uint4*>(o);
  }
}

}  // namespace
