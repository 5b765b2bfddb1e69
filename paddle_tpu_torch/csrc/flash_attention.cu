// FlashAttention forward and backward for Hopper (sm_90a): bf16 in and
// out, f32 softmax and accumulation, causal or not, equal head counts.
//
// Replaces: paddle_tpu/ops/pallas/flash_attention.py, the three pallas_calls
// of `flash_attention`: the forward at line 285 (`_fwd_kernel`, line 34),
// the dq pass at line 319 (`_bwd_dq_kernel`) and the dk / dv pass at line
// 336 (`_bwd_dkv_kernel`).
//
// Computes, for q, k, v [B, S, H, d] (one stream per batch row and head):
//   forward:  out = softmax(q k^T / sqrt(d) [+ causal mask]) v, and
//             lse[b, h, i] = log sum_j exp(score[i, j])   (natural log)
//   dq pass:  p = exp(score - lse), dp = do v^T,
//             ds = p * (dp - delta) / sqrt(d), dq = ds k
//   dkv pass: dv = p^T do, dk = ds^T q
// with delta[b, h, i] = sum(do * out) computed by the caller.  p and ds are
// rounded to bf16 before their second product, as in the TPU kernels.
//
// What bounds it on the card: operations.  A visible (q, k) pair costs 4 * d
// FLOPs forward (6 * d in the dq pass, 8 * d in the dkv pass) per head
// against bytes that grow with S only, so from a few hundred tokens on the
// bf16 tensor-core rate is the limit, not the memory.  Every pass is built
// to keep the tensor cores fed (hopper_sm90.cuh holds the TMA, mbarrier and
// wgmma pieces): a block of 384 threads is one producer warpgroup, whose
// one thread streams tiles into a ring of shared-memory stages by TMA (4-D
// tensor maps over [B, S, H, d], so nothing is gathered; each stage a full
// and an empty mbarrier), and two consumer warpgroups of 64 rows each that
// run wgmma products on the stages as they arrive; setmaxnreg moves the
// producer's registers to the consumers.  Tiles are rows of 64 bf16 in the
// 128-byte swizzle the maps write, read by wgmma K-major for A B^T and
// MN-major for A B, so no tile is ever transposed.  Scores, p and ds live
// in the accumulator registers only, re-packed in bf16 as the A fragments
// of the second products.
//
// The forward is csrc/flash_fwd_sm90.cuh's flash_fwd_kernel<D, false>,
// the template it shares with the segmented forward (K2): a 128-row q tile
// a block, K and V streamed in 128-key tiles from the diagonal down, S by
// wgmma from shared memory, the online softmax in base 2 on the
// accumulators, O += P V with P re-packed as register A fragments, the two
// consumers in ping-pong; only the first tile visited (the diagonal, or
// the one holding keys past a ragged S) is masked; heavy (late) q tiles
// first.
//
// The backward is csrc/flash_bwd_sm90.cuh's flash_bwd_dq_kernel<D, false>
// and flash_bwd_dkv_kernel<D, false>, the templates it shares with the
// segmented backward (K7a, K7b): two passes, one per pallas_call, so each
// output is written once (no atomics; dq, dk and dv do not change from run
// to run).  The dq pass takes a 128-row q tile a block and streams K and V
// stages (64 keys at d = 128, 128 at d = 64) from the diagonal down; the
// dk / dv pass takes 128 keys a block and streams 64-row Q and dO stages
// from the diagonal to the end, on transposed scores so that p^T and ds^T
// come out of the accumulators as the A fragments of dv += p^T dO and
// dk += ds^T Q.  The two consumers take turns to issue (ping-pong); masks
// run in a loop of their own, on the diagonal and ragged stages only.

#include <cuda_bf16.h>

#include "flash_bwd_sm90.cuh"
#include "flash_fwd_sm90.cuh"

// q, k, v, out, dout, dq, dk, dv [B, S, H, d] bf16; lse, delta [B, H, S]
// f32.  All contiguous and on 16-byte boundaries; d is 64 or 128; H and B at
// most 65535 (the wrapper checks).  Each returns the launch's cudaError_t (0
// on success).
extern "C" int flash_attention_fwd_bf16(
    const void* q, const void* k, const void* v, void* out, void* lse, int B,
    int S, int H, int d, int causal, float sm_scale, void* stream) {
  if (B == 0 || S == 0 || H == 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  const flash_fwd::SegArgs none = {};
  if (d == 128)
    return flash_fwd::launch<128, false>(q, k, v, out, lse, none, B, S, H, H, causal, sm_scale, s);
  if (d == 64)
    return flash_fwd::launch<64, false>(q, k, v, out, lse, none, B, S, H, H, causal, sm_scale, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int flash_attention_bwd_dq_bf16(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, int B, int S, int H, int d,
    int causal, float sm_scale, void* stream) {
  if (B == 0 || S == 0 || H == 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  const flash_fwd::SegArgs none = {};
  if (d == 128)
    return flash_bwd::launch_dq<128, false>(q, k, v, dout, lse, delta, dq, none, B, S,
                                            H, H, causal, sm_scale, s);
  if (d == 64)
    return flash_bwd::launch_dq<64, false>(q, k, v, dout, lse, delta, dq, none, B, S,
                                           H, H, causal, sm_scale, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int flash_attention_bwd_dkv_bf16(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, int B, int S,
    int H, int d, int causal, float sm_scale, void* stream) {
  if (B == 0 || S == 0 || H == 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  const flash_fwd::SegArgs none = {};
  if (d == 128)
    return flash_bwd::launch_dkv<128, false>(q, k, v, dout, lse, delta, dk, dv, none,
                                             B, S, H, H, causal, sm_scale, s);
  if (d == 64)
    return flash_bwd::launch_dkv<64, false>(q, k, v, dout, lse, delta, dk, dv, none,
                                            B, S, H, H, causal, sm_scale, s);
  return (int)cudaErrorInvalidValue;
}
