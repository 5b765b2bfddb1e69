// Segmented (packed varlen) flash attention forward for Hopper (sm_90a),
// bf16 in and out, f32 softmax and accumulation.
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
// What the design does about it: the kernel is the dense forward's (K6a)
// TMA ring and wgmma, csrc/flash_fwd_sm90.cuh's flash_fwd_kernel<D, true>,
// so Q K^T and P V run on the tensor cores and K / V stream in by TMA at
// their nkv heads.  What the segments add:
// * Block skipping: a block (a 128-row q tile of one q head) visits only
//   the 128-key tiles from the first row of the first segment its q tile
//   touches to min(the end of its last segment, its last row): the
//   per-tile [kmin, kmax] of _segment_block_ranges at 128 rows, computed
//   on the device by the wrapper.  A packed wave of short prompts costs
//   O(sum_i L_i * 128), not O(T^2).
// * The mask runs only where it is needed: a key tile needs none when the
//   q tile lies wholly in one segment, the key tile in that segment and,
//   when causal, wholly below the diagonal.  The other visited tiles
//   compare the ids of the key tile (copied into a ring by a producer
//   warp) with each row's, and mask keys at or past T by position.
// * Rows with no visible key in a visited tile give p = 0 exactly (scores
//   at -inf, the running maximum taken as 0 while it is -inf), as JAX's
//   explicit zeroing does; l_safe = max(l, 1e-30) as in JAX.
// * Any T works: TMA zero-fills rows and keys past T, the out store writes
//   no row past T and lse is written for rows < T only.
//
// The per-tile ranges come from seg_tile_ranges_kernel, one launch (the
// plain version's dozen PyTorch scans and copies cost more host time than
// the attention itself); the backward (K7a, K7b) takes them at 64 rows.

#include <limits.h>

#include "flash_fwd_sm90.cuh"

namespace {

// One block a batch row: kmin[b, t] / kmax[b, t] of each `rows`-row tile t
// of the stream padded to whole tiles (the pad a run of its own): the
// first row of the run holding the tile's first row, the last row of the
// run holding its last row.  Pass 1 marks each tile's last run start and
// first run end; pass 2 carries them across the tiles, a thread a
// direction.
__global__ void __launch_bounds__(1024)
seg_tile_ranges_kernel(const int* __restrict__ seg, int T, int rows,
                       int* __restrict__ kmin, int* __restrict__ kmax) {
  extern __shared__ int sh[];
  const int nt = (T + rows - 1) / rows, Tp = nt * rows;
  const int* s = seg + (size_t)blockIdx.x * T;
  int* last_start = sh;
  int* first_end = sh + nt;
  for (int t = threadIdx.x; t < nt; t += blockDim.x) {
    last_start[t] = -1;
    first_end[t] = INT_MAX;
  }
  __syncthreads();
  for (int p = threadIdx.x; p < Tp; p += blockDim.x) {
    const bool start = p == 0 || p == T || (p < T && s[p] != s[p - 1]);
    const bool end = p == Tp - 1 || p == T - 1 || (p < T - 1 && s[p] != s[p + 1]);
    if (start) atomicMax(&last_start[p / rows], p);
    if (end) atomicMin(&first_end[p / rows], p);
  }
  __syncthreads();
  int* lo = kmin + (size_t)blockIdx.x * nt;
  int* hi = kmax + (size_t)blockIdx.x * nt;
  if (threadIdx.x == 0) {
    int run = 0;   // the last run start before the tile
    for (int t = 0; t < nt; ++t) {
      const int f = t * rows;
      const bool start = f == 0 || f == T || (f < T && s[f] != s[f - 1]);
      lo[t] = start ? f : run;
      if (last_start[t] >= 0) run = last_start[t];
    }
  } else if (threadIdx.x == 32) {
    int run = Tp - 1;   // the first run end after the tile
    for (int t = nt - 1; t >= 0; --t) {
      const int l = (t + 1) * rows - 1;
      const bool end = l == Tp - 1 || l == T - 1 || (l < T - 1 && s[l] != s[l + 1]);
      hi[t] = end ? l : run;
      if (first_end[t] != INT_MAX) run = first_end[t];
    }
  }
}

}  // namespace

// seg [B, T] int32 (contiguous) -> kmin, kmax [B, ceil(T / rows)] int32:
// _segment_block_ranges at `rows` over the stream padded to whole tiles.
// Returns the launch's cudaError_t (0 on success).
extern "C" int flash_segmented_tile_ranges(const void* seg, void* kmin,
                                           void* kmax, int B, int T, int rows,
                                           void* stream) {
  if (B == 0 || T == 0) return (int)cudaSuccess;
  if (rows <= 0) return (int)cudaErrorInvalidValue;
  const int nt = (T + rows - 1) / rows;
  const size_t smem = (size_t)nt * 2 * sizeof(int);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  seg_tile_ranges_kernel<<<B, 1024, smem, (cudaStream_t)stream>>>(
      (const int*)seg, T, rows, (int*)kmin, (int*)kmax);
  return (int)cudaGetLastError();
}

// q [B, T, n, d], k / v [B, T, nkv, d] bf16, seg [B, T] int32, kmin / kmax
// [B, ceil(T / 128)] int32 (inclusive first / last row of the segments each
// 128-row tile touches) -> out [B, T, n, d] bf16, lse [B, n, T] fp32.  All
// contiguous, the bf16 tensors on 16-byte boundaries.  d is 64 or 128, n %
// nkv == 0, nkv and B at most 65535 (the wrapper checks).  Returns the
// launch's cudaError_t (0 on success).
extern "C" int flash_segmented_fwd_bf16(
    const void* q, const void* k, const void* v, const void* seg,
    const void* kmin, const void* kmax, void* out, void* lse, int B, int T,
    int n, int nkv, int d, int causal, float sm_scale, void* stream) {
  if (B == 0 || T == 0) return (int)cudaSuccess;
  if (nkv <= 0 || n % nkv) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const flash_fwd::SegArgs sa = {(const int*)seg, (const int*)kmin,
                                 (const int*)kmax};
  if (d == 128)
    return flash_fwd::launch<128, true>(q, k, v, out, lse, sa, B, T, n, nkv,
                                        causal, sm_scale, s);
  if (d == 64)
    return flash_fwd::launch<64, true>(q, k, v, out, lse, sa, B, T, n, nkv,
                                       causal, sm_scale, s);
  return (int)cudaErrorInvalidValue;
}
