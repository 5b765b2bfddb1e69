// Segmented (packed varlen) flash attention backward for Hopper (sm_90a):
// bf16 in and out, f32 probabilities and accumulation, causal or not, GQA
// native (n q heads over nkv kv heads, n % nkv == 0).
//
// Replaces: paddle_tpu/ops/pallas/flash_varlen.py, the backward of
// flash_attention_segmented (`_seg_bwd_vjp`): the dq pass at line 399
// (kernel body `_bwd_dq_kernel`, K7a) and the dk / dv pass at line 438
// (`_bwd_dkv_kernel`, K7b).
//
// Computes, for one packed stream per batch row, q head i and its kv head
// j = i / (n / nkv), over the (q, k) pairs with seg[q] == seg[k] (and
// k <= q when causal), from the forward's lse [B, n, T] and the caller's
// delta = sum(do * out) [B, n, T]:
//   p  = exp(q k^T / sqrt(d) - lse),  dp = do v^T,
//   ds = p * (dp - delta) / sqrt(d)
//   dq pass:   dq[i] = ds k
//   dkv pass:  dv[j] = sum over the q heads i of j's group of p^T do,
//              dk[j] = sum over the same heads of ds^T q
// p and ds are rounded to bf16 before their second product, as in the TPU
// kernels and in K6b / K6c; dk and dv are summed over the group in f32 and
// rounded once, as JAX's group sum is.
//
// What bounds it on the card depends on the segment lengths, as for the
// forward (csrc/flash_varlen.cu): a visible pair costs 6 * d FLOPs a q head
// in the dq pass and 8 * d in the dkv pass, against q, k, v, do and the
// outputs moved once.  On pretraining rows (documents of a few hundred to
// a few thousand tokens) the two floors lie close: at chip_smoke's packed
// trainer shape the bytes' is the higher, and the visible pairs' FLOPs at
// the bf16 tensor-core rate come to 83% (dq) and 93% (dk / dv) of it.
//
// What the design does about it: the kernels are the dense backward's (K6b,
// K6c) TMA ring and wgmma, csrc/flash_bwd_sm90.cuh's
// flash_bwd_dq_kernel<D, true> and flash_bwd_dkv_kernel<D, true>, so every
// product runs on the tensor cores and q, k, v and do stream in by TMA at
// their own head counts.  What the segments add:
// * Block skipping: a dq block (128 q rows of one q head) visits only the
//   key stages from the first row of the first segment its rows touch to
//   min(the end of its last segment, its last row when causal, T - 1); a
//   dk / dv block (128 keys of one kv head) only the 64-row q stages from
//   max(the first row of its first segment, its own first row when
//   causal) to the end of its last segment.  Both ranges are the forward's
//   per-128-row-tile [kmin, kmax] (_segment_block_ranges at 128 rows),
//   which the wrapper keeps from the forward: the backward launches no
//   range kernel of its own.
// * GQA without atomics: a dk / dv block loops over its group's q heads,
//   and for each over its q stages, in one flattened count; dk and dv stay
//   in f32 registers across the group and are written once.  The result
//   does not change from run to run.
// * Masks only where they are needed: a stage needs none when the whole
//   128-row tile of the block lies in one segment, the stage lies in that
//   segment and, when causal, wholly on the visible side of the diagonal.
//   The other stages compare ids (the dq pass's key ids and the dk / dv
//   pass's q-row ids come into each stage, copied by a producer warp of
//   their own) and mask rows and keys at or past T by position.
// * Any T works: TMA zero-fills rows and keys past T, and the stores write
//   no row past T.

#include "flash_bwd_sm90.cuh"

// q, dout, dq [B, T, n, d] and k, v, dk, dv [B, T, nkv, d] bf16; seg [B, T]
// int32; kmin / kmax (qmin / qmax) [B, ceil(T / 128)] int32, the inclusive
// first / last row of the segments each 128-row tile touches (the
// forward's); lse, delta [B, n, T] f32.  All contiguous and on 16-byte
// boundaries; d is 64 or 128, n % nkv == 0, n and B at most 65535 (the
// wrapper checks).  Each returns the launch's cudaError_t (0 on success).
extern "C" int flash_segmented_bwd_dq_bf16(
    const void* q, const void* k, const void* v, const void* dout,
    const void* seg, const void* kmin, const void* kmax, const void* lse,
    const void* delta, void* dq, int B, int T, int n, int nkv, int d,
    int causal, float sm_scale, void* stream) {
  if (B == 0 || T == 0 || n == 0) return (int)cudaSuccess;
  if (nkv <= 0 || n % nkv) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const flash_fwd::SegArgs sa = {(const int*)seg, (const int*)kmin,
                                 (const int*)kmax};
  if (d == 128)
    return flash_bwd::launch_dq<128, true>(q, k, v, dout, lse, delta, dq, sa,
                                           B, T, n, nkv, causal, sm_scale, s);
  if (d == 64)
    return flash_bwd::launch_dq<64, true>(q, k, v, dout, lse, delta, dq, sa,
                                          B, T, n, nkv, causal, sm_scale, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int flash_segmented_bwd_dkv_bf16(
    const void* q, const void* k, const void* v, const void* dout,
    const void* seg, const void* qmin, const void* qmax, const void* lse,
    const void* delta, void* dk, void* dv, int B, int T, int n, int nkv, int d,
    int causal, float sm_scale, void* stream) {
  if (B == 0 || T == 0 || n == 0) return (int)cudaSuccess;
  if (nkv <= 0 || n % nkv) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const flash_fwd::SegArgs sa = {(const int*)seg, (const int*)qmin,
                                 (const int*)qmax};
  if (d == 128)
    return flash_bwd::launch_dkv<128, true>(q, k, v, dout, lse, delta, dk, dv,
                                            sa, B, T, n, nkv, causal, sm_scale,
                                            s);
  if (d == 64)
    return flash_bwd::launch_dkv<64, true>(q, k, v, dout, lse, delta, dk, dv,
                                           sa, B, T, n, nkv, causal, sm_scale,
                                           s);
  return (int)cudaErrorInvalidValue;
}
