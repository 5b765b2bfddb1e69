#!/usr/bin/env python3
"""Drive the PyTorch port (paddle_tpu_torch) on one CUDA card.

Run from the repository root:  python3 chip_smoke.py

Phases, one JSON line each on stdout:

1. device  - the card's name and power limit (nvidia-smi), TF32 off.
2. build   - nvcc builds every kernel of the serving and training paths,
             in parallel; then a `ptxas` line maps each kernel function
             (name<template args>) to its registers, spill stores and
             loads, stack and static shared memory in bytes (the same,
             one line a function, and ptxas's warnings go to stderr);
             K7a's and K7b's four instances, K3's decode instances and
             K9a's register-held instances must spill nothing.
3. k1..k4  - each kernel against its plain PyTorch version on the card, at
             the main paths' shapes (k1, k2, k4: nkv = 32 as LLaMA-7B and
             nkv = 8 for GQA, and k2's per-tile range kernel against its
             plain version, bit for bit, at K2's 128-row tiles; k3:
             decode w_gate, w_down, lm_head and wq at batch 8 and w_gate
             at batch 1 on the decode path, w_gate at a 2,048- and a
             256-row prefill wave
             and a ragged M and N on the wave path): max abs error,
             kernel / plain / library-call
             times (CUDA events, median of 25 runs after warm-up, L2
             flushed before each) and the least time the card could take.
             k1 and k4 also print the paged kernel's split plan (S splits
             of P_s pages a row), check that two calls give the same bits
             and hold one 2,048-token row among short ones in a 128-page
             table (most splits empty) against the plain version.
   k5, k6a, k6b, k6c, k8 - the training kernels the same way, at the
             trainer's shapes ([8, 2048, 16, 128] bf16, causal; the w_gate
             leaf [24, 2048, 5504]) and at a ragged length, head_dim 64
             and a leaf size no vector divides; k6c also prints delta_ms
             (the wrapper's sum of dout * out) and bwd_total_ms (K6b +
             K6c + delta), the whole backward beside SDPA's.
   k7      - the segmented backward, dq (K7a) and dk / dv (K7b), from K2's
             lse and ranges, at the packed trainer's shape ([8, 2048, 16,
             128], rows packed by pack_documents), GQA (32 q heads over 8),
             T = 2000, head_dim 64, non-causal, many 1-token segments
             before a -1 pad tail and one document a row (the range kernel
             at the kernels' 128-row blocks, bit for bit); autograd through
             flash_attention_segmented against autograd through its plain
             version; the timed cases also print the tiles each pass
             visits and masks (ops.flash_varlen._bwd_tile_walk), and one
             document a row K6b's and K6c's times on the same inputs.
   k9, k10, k11 - the trunk's flagged kernels the same way: rms_norm
             forward and backward (K9a-b; K9b run twice for bit-identical
             results) at the trainer's [16384, 2048], decode's [8, 4096],
             the serving wave's [2048, 4096] (timed with the trainer's), a
             ragged row count and an f32 weight; swiglu forward and backward
             (K10a-b) at [16384, 5504], [8, 11008] and a ragged row count;
             rmsnorm_matmul (K11) at the trainer's gate / up and q products,
             decode's [8, 4096] x [4096, 11008] and a ragged M and N.
4. serve   - LLaMA-7B at full width and depth with random weights from a
             seed behind the port's GenerationServer: concurrent /generate
             requests and one /generate_stream; every reply complete, each
             kernel launched during the serve, no page left owned.  Then
             each served sequence, teacher-forced, through the port's own
             prefill and decode step (the kernels) and through a plain
             dense forward (no kernel): their logits within LOGIT_LIMIT,
             a planted fault beyond it, and every served token within
             2 * LOGIT_LIMIT of the plain forward's top logit.
5. serve_int8 - the same model and requests served with int8 weights
             (quantize_params_int8 of the same seeded weights) over int8
             KV pages: every reply complete, K2 (and its range kernel), K3
             (both paths) and K4 launched, no
             page left owned.  Each served sequence, teacher-forced,
             through the int8 path twice, with the kernels and with every
             kernel replaced by its plain version: logits within
             INT8_LOGIT_LIMIT, a planted fault beyond it; the int8 path's
             distance from the bf16 path is printed, not gated.
6. train   - the 1.345 B-parameter LLaMA of the JAX package's training
             bench (vocab 32000, hidden 2048, FFN 5504, 24 layers, 16 heads
             of 128; bf16 compute over f32 masters, remat full, chunked
             loss) with random weights from the seed: four AdamW steps of
             make_train_step on one batch of 8 x 2049 tokens.  Every loss
             finite, the first within 1.0 of ln 32000, the fourth below the
             first, and K5, K6a, K6b, K6c, K8 launched as often as the code
             predicts.
7. train_grads - the same model cut to 2 layers and batch 2: forward_loss
             and its gradients through the kernels and with every kernel of
             the slice replaced by its plain version; the largest gradient
             difference of any leaf within GRAD_LIMIT of that leaf's largest
             gradient, a planted fault (the RoPE backward rotating with
             +sin) beyond it.
8. train_packed - the same trainer on packed rows: four AdamW steps of
             forward_loss(params, tokens, segment_ids), torch.autograd.grad
             and adamw_update on one batch of 8 x 2049 tokens whose rows
             pack_documents (paddle_tpu_torch/models/packing.py) fills
             with documents of 32-2049 tokens, an unsourced placeholder mix
             (the plain loss head, as JAX takes with segment ids).  Loss checks
             as in train; K2, K7a, K7b, their range kernel, K5 and K8
             launched as often as the code predicts, K6a-c never.
9. train_packed_grads - 2 layers, batch 2, packed: the gradients through
             the kernels against their plain versions' within GRAD_LIMIT,
             also at 4 kv heads (group 4), where a planted fault (K7b
             summing only the first q head of each group) lands beyond it;
             and each target's loss in the packed rows against its loss in
             its document run alone: their mean absolute difference within
             PACKED_TOKEN_LIMIT, a planted fault (K2 given one segment for
             the whole row) beyond it; the packed mean loss against the
             documents' token-weighted mean is printed.
10. train_fused - the train phase's four AdamW steps with the trunk's
             kernel flags on (paddle_tpu_torch/flags.py), once per flag
             set: A = FLAGS_pallas_rms_norm + FLAGS_pallas_swiglu (K9, K10),
             B = A + FLAGS_pallas_rmsnorm_matmul (K11; its branch bypasses K9
             at ln1 / ln2 and K10).  Loss checks as in train; every kernel
             launched as often as the code predicts; the flags are put back
             afterwards.  train, train_packed and the serves launch K9-K11
             never (the flags are off by default).
11. train_fused_grads - train_grads under each set (one line a set), with
             K9-K11 also replaced by their plain versions in the plain pass
             and a planted fault per set beyond the limit (A: K9b's dx
             without its xhat * c term; B: K11's epilogue without rstd).
12. kernels - one JSON object with an entry per ported kernel (16, and
             K3's wave path beside its decode path and the segmented
             kernels' per-tile range kernel: 18).

The last line is {"ok": true, "device": {...}}.  Any failed check exits
non-zero before that line.  Without a CUDA device, or without the package
beside this script, it exits non-zero and prints no result.
"""

import argparse
import contextlib
import json
import math
import statistics
import subprocess
import sys
import threading
import time

import numpy as np

from paddle_tpu_torch.models.packing import (
    documents, pack_documents, packed_step, segment_runs)

# H100 SXM data-sheet peaks (dense): the bound of every kernel line
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12
TOL = dict(atol=2e-2, rtol=2e-2)   # one bf16 rounding + another sum order
# Teacher-forced check of the serve.  The served sequences run through the
# port's prefill + decode step (kernels) and through a plain dense forward;
# both compute in bf16 and round differently, so their logits differ by the
# model's bf16 noise.  LOGIT_LIMIT bounds the largest absolute difference:
# set above the sound runs' largest and below a planted fault's (attention
# over lens instead of lens + 1 in every decode layer), which the run also
# measures and must exceed the limit.  If each path is within LOGIT_LIMIT of
# the plain logits, a served greedy token's plain logit is within
# 2 * LOGIT_LIMIT of the plain top logit.  The argmax agreement wherever the
# plain top-2 margin exceeds REPORT_MARGIN is printed as well.  On an H100
# at seeds 0, 1 and 2 the sound difference was 0.164, 0.172 and 0.180 and
# the planted fault's 4.52, 3.97 and 4.29.
LOGIT_LIMIT = 0.3
REPORT_MARGIN = 0.05
# The int8 serve's check.  Both teacher-forced passes share the quantized
# weights and pages; one runs the kernels (K2, K3, K4) and one their plain
# versions, so the difference is the kernels' error alone.  Set above the
# sound runs' largest and below the planted fault's (K4 over lens instead
# of lens + 1 in every decode layer), which the run also measures.  On an
# H100 at seeds 0, 1 and 2 the sound difference was 0.234, 0.222 and 0.219
# and the planted fault's 4.33, 4.26 and 4.67.
INT8_LOGIT_LIMIT = 0.4

# The training slice's gradient check.  One forward_loss + backward through
# the kernels (K5, K6a-c) and one with each replaced by its plain version,
# from the same f32 params and tokens, both computing in bf16.  The measure
# is the largest difference of any gradient leaf over that leaf's largest
# magnitude.  Set above the sound runs' largest and below a planted
# fault's (the RoPE backward rotating with +sin instead of -sin), which the
# run also measures.  On an H100 at seeds 0, 1 and 2 the sound difference
# was 0.0143, 0.0169 and 0.0141 and the planted fault's 1.436, 1.354 and
# 1.466.  The same limit holds train_fused_grads, the check under the
# trunk's flag sets with K9-K11 also replaced by their plain versions: on
# an H100 at seeds 0, 1 and 2 the sound difference was 0.0154, 0.0142 and
# 0.0147 under set A (planted fault, K9b's dx without its xhat * c term:
# 2.57, 2.27, 2.31) and 0.0129, 0.0136 and 0.0144 under set B (K11's
# epilogue without rstd: 593, 814, 671).
GRAD_LIMIT = 0.1
PEAK_F32_FLOPS = 67e12             # CUDA cores, for the elementwise kernels
# one bf16 rounding of the result; the RoPE kernel is expected bit for bit
K5_TOL = dict(atol=2 ** -7, rtol=2 ** -7)
# a few units in the last place of f32: the compiler may fuse a multiply
# and an add where the plain version rounds twice
K8_TOL = dict(atol=1e-6, rtol=1e-5)
# the trainer of the JAX package's training bench, whole
TRAIN_CFG = dict(vocab_size=32000, hidden_size=2048, intermediate_size=5504,
                 num_hidden_layers=24, num_attention_heads=16,
                 max_seq_len=2048, remat=True, remat_policy="full",
                 loss_chunks=4)
TRAIN_BATCH, TRAIN_TOKENS, TRAIN_STEPS = 8, 2049, 4
# (B, S, H, d) of K5 and K6: the trainer's shape, a ragged length, head_dim 64
TRAIN_SHAPES = [(8, 2048, 16, 128), (2, 2047, 16, 128), (2, 2048, 16, 64)]
K8_SIZES = [24 * 2048 * 5504, 1_000_003]      # w_gate; no multiple of 4

K1_LENS = [1, 64, 65, 2048, 300, 1000, 1500, 777]
# one long row among short ones in a table of 128 pages: most of the
# kernel's splits start past their row's end and exit at once
K1_SPARSE_LENS, K1_SPARSE_PAGES = [2048, 1, 3, 64, 65, 100, 7, 200], 128
# (M, K, N): decode w_gate, w_down and lm_head at batch 8, wq / wk / wv /
# wo at batch 8 and w_gate at batch 1 (the decode path), then the wave path:
# w_gate at a 2,048-row prefill wave, a 256-row wave (split over K) and a
# ragged M and N (N % 16 != 0: the plain-load instance)
K3_SHAPES = [(8, 4096, 11008), (8, 11008, 4096), (8, 4096, 32000),
             (8, 4096, 4096), (1, 4096, 11008),
             (2048, 4096, 11008), (256, 4096, 4096), (1000, 4096, 1000)]
K2_SEGMENTS = [700, 64, 1, 900, 300]   # + sentinel padding up to T
K2_T = 2048
# K7 cases (name, B, T, q heads, kv heads, head_dim, causal, layout): the
# packed trainer's attention, GQA, a ragged length, head_dim 64, non-causal,
# 1,000 one-token segments + a 600-token document + a -1 pad tail, and one
# document a row at the trainer's shape, where K7a and K7b do K6b's and
# K6c's work.  K7_TIMED are timed.
K7_CASES = [("trainer", 8, 2048, 16, 16, 128, True, "packed"),
            ("gqa", 2, 2048, 32, 8, 128, True, "packed"),
            ("ragged", 2, 2000, 16, 16, 128, True, "packed"),
            ("d64", 2, 2048, 16, 16, 64, True, "packed"),
            ("noncausal", 2, 2048, 16, 16, 128, False, "packed"),
            ("ones_pad", 2, 2048, 16, 16, 128, True, "ones_pad"),
            ("onedoc", 8, 2048, 16, 16, 128, True, "onedoc")]
K7_TIMED = ("trainer", "gqa", "onedoc")
# Kernel functions that must spill nothing, by label prefix, with the
# number of functions the build must report under each: K7a and K7b, the
# segmented instances of csrc/flash_bwd_sm90.cuh's templates; K3's decode
# path (int8_decode_kernel<MT, kTmaW>: 8 or 16 rows, TMA or plain-load
# weight); K9a's register-held rows (rms_fwd_rows_kernel<NV, WPR, types>)
SPILL_FREE = {
    **{f"flash_varlen_bwd.cu:flash_bwd_{p}_kernel<{d}, 1>": 1
       for p in ("dq", "dkv") for d in (128, 64)},
    "int8_matmul.cu:int8_decode_kernel<": 4,
    "rms_norm.cu:rms_fwd_rows_kernel<": 24}
# JAX's packed-pretraining invariant: each target's loss in the packed rows
# equals its loss in its document run alone, so the packed loss is the
# token-weighted mean of the documents' losses.  Both sides compute in bf16
# through other kernels (K2 on the packed rows, K6a on a document alone) and
# other matmul shapes.  PACKED_TOKEN_LIMIT bounds the mean absolute
# difference of the targets' losses: set above the sound runs' largest and
# below a planted fault's (K2 given one segment for the whole row, so
# attention crosses every document boundary), which the run also measures.
# On an H100 at seeds 0, 1 and 2 the sound difference was 0.00940, 0.00944
# and 0.00953 and the planted fault's 0.758, 0.940 and 0.917.  The
# difference of the two mean losses is printed, not gated: the fault moves
# each target's loss up or down, so the mean's shift rests on how the signs
# fall (sound 2.7e-4, 1.0e-4, 1.9e-4; fault 0.0120, 0.0132, 0.0063).
PACKED_TOKEN_LIMIT = 0.05
# The trunk's flagged kernels.  K9 (rms_norm): the trainer's [16384, 2048]
# bf16 (timed), decode's [8, 4096], the serving admission wave's [2048,
# 4096] (timed), a ragged row count, and bf16 x with an f32 weight (the
# output promotes to f32).  K10 (swiglu): the trainer's FFN
# [16384, 5504] (timed), decode's [8, 11008], a ragged row count.  K11
# (rmsnorm_matmul): the trainer's gate / up and q products over the f32 ln
# master (timed), decode's [8, 4096] x [4096, 11008] over a bf16 ln, and a
# ragged M and N.  Tolerance TOL: one bf16 rounding of the result and
# another summation order.
K9_CASES = [("trainer", 16384, 2048, "bfloat16"),
            ("decode", 8, 4096, "bfloat16"),
            ("wave", 2048, 4096, "bfloat16"),
            ("ragged", 4095, 2048, "bfloat16"),
            ("promote", 4095, 2048, "float32")]
K9_TIMED = ("trainer", "wave")
K10_SHAPES = [(16384, 5504), (8, 11008), (4095, 5504)]
K11_CASES = [("gate_up", 16384, 2048, 5504, "float32"),
             ("q", 16384, 2048, 2048, "float32"),
             ("decode", 8, 4096, 11008, "bfloat16"),
             ("ragged", 1000, 2048, 1000, "float32")]
# the flag sets of train_fused: A takes K9 and K10; B adds rmsnorm_matmul,
# whose branch bypasses K9 at ln1 / ln2 and K10 altogether
TRUNK_FLAGS = ("FLAGS_pallas_rms_norm", "FLAGS_pallas_swiglu",
               "FLAGS_pallas_rmsnorm_matmul")
FLAG_SETS = {"A": TRUNK_FLAGS[:2], "B": TRUNK_FLAGS}


def emit(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def time_ms(torch, fn, flush, reps=25):
    """Median CUDA-event time of ``fn`` over ``reps`` runs after a
    warm-up, with the L2 cache overwritten before each run."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(bytes_moved, flops, peak_flops=PEAK_BF16_FLOPS):
    t_bytes = bytes_moved / PEAK_BYTES * 1e3
    t_ops = flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def k6a_work(shape):
    """(bytes, FLOPs) of K6a at ``shape`` (B, S, H, d), causal: q, k, v read
    and out written once, lse written; 4 d FLOPs per visible pair."""
    B, S, H, d = shape
    pairs = B * H * S * (S + 1) // 2
    return 4 * B * S * H * d * 2 + B * H * S * 4, pairs * 2 * 2 * d


def k6_bwd_work(shape):
    """((bytes, FLOPs) of K6b, (bytes, FLOPs) of K6c) at ``shape`` (B, S,
    H, d), causal.  K6b reads q, k, v, dout, lse and delta and writes dq;
    K6c reads the same and writes dk and dv.  Per visible pair K6b runs 3
    products of 2 d FLOPs (s, dp, dq), K6c 4 (s, dp, dv, dk)."""
    B, S, H, d = shape
    pairs = B * H * S * (S + 1) // 2
    io = B * S * H * d * 2                  # one [B, S, H, d] bf16 tensor
    stat = B * H * S * 4                    # lse or delta
    return ((5 * io + 2 * stat, pairs * 3 * 2 * d),
            (6 * io + 2 * stat, pairs * 4 * 2 * d))


def k11_work(M, H, N, wl_bytes):
    """(bytes, FLOPs) of K11: x, W and wl read, out written once."""
    return (M * H + H * N + M * N) * 2 + H * wl_bytes, 2 * M * H * N


def k2_work(T, n, nkv, d, runs):
    """(bytes, FLOPs) of causal K2 on one stream of T tokens whose segments
    are ``runs`` (lengths, in order): q, k, v read and out written once,
    lse written, the segment ids read; 4 d FLOPs per visible pair and q
    head."""
    pairs = sum(L * (L + 1) // 2 for L in runs)
    return ((2 * T * n * d + 2 * T * nkv * d) * 2 + n * T * 4 + T * 4,
            pairs * n * 4 * d)


def k3_work(M, K, N):
    """(bytes, FLOPs) of K3: x, the int8 codes and their f32 scales read,
    the bf16 output written once; 2 FLOPs per multiply-add."""
    return M * K * 2 + K * N + 4 * N + M * N * 2, 2 * M * K * N


def k9_work(n, h, x_bytes, w_bytes, out_bytes):
    """((bytes, FLOPs) of K9a, (bytes, FLOPs) of K9b) on rows [n, h].  K9a
    reads x and w and writes out and rstd; K9b reads x, w, rstd and dout and
    writes dx and its f32 dw partials' row (one row counted).  4 and 9
    FLOPs an element."""
    return ((n * h * (x_bytes + out_bytes) + h * w_bytes + n * 4, 4 * n * h),
            (n * h * (2 * x_bytes + out_bytes) + h * (w_bytes + 4) + n * 4,
             9 * n * h))


def k7_work(seg_np, n, nkv, d, causal):
    """((bytes, FLOPs) of K7a, (bytes, FLOPs) of K7b) on the packed rows
    ``seg_np`` [B, T] with n q heads over nkv kv heads.  K7a reads q, dout,
    k, v, lse, delta and the ids and writes dq; K7b reads the same and
    writes dk and dv.  Per visible pair and q head K7a runs 3 products of
    2 d FLOPs (s, dp, dq), K7b 4 (s, dp, dv, dk)."""
    B, T = seg_np.shape
    runs = segment_runs(seg_np)
    pairs = int(sum(L * (L + 1) // 2 if causal else L * L for L in runs))
    io_q, io_k = B * T * n * d * 2, B * T * nkv * d * 2
    rest = 2 * B * n * T * 4 + B * T * 4           # lse, delta; seg
    return ((3 * io_q + 2 * io_k + rest, pairs * n * 6 * d),
            (2 * io_q + 4 * io_k + rest, pairs * n * 8 * d))


def k2_segments():
    """chip_smoke's K2 stream: the runs ``K2_SEGMENTS``, then a sentinel id
    up to ``K2_T`` -> (seg [K2_T] int32, run lengths)."""
    seg = np.full((K2_T,), len(K2_SEGMENTS), np.int32)
    at = 0
    for i, L in enumerate(K2_SEGMENTS):
        seg[at:at + L] = i
        at += L
    return seg, K2_SEGMENTS + [K2_T - at]


def check_close(name, got, ref, tol=None):
    torch = sys.modules["torch"]
    tol = tol or TOL
    err = float((got.float() - ref.float()).abs().max())
    if not torch.isfinite(got.float()).all():
        fail(f"{name}: non-finite output")
    if not torch.allclose(got.float(), ref.float(), **tol):
        fail(f"{name}: max abs err {err} beyond atol/rtol {tol}")
    return err


K1_SHAPE = dict(B=8, n=32, d=128, page=64, pages_max=32)


def check_ranges(torch, fv, name, seg, rows):
    """The per-tile range kernel on ``seg`` (CUDA) against its plain
    version on the CPU: equal, or the run fails.  -> max abs error (0)."""
    got = fv._tile_ranges(seg, rows)
    want = fv._tile_ranges_plain(seg.cpu(), rows)
    torch.cuda.synchronize()
    err = max(int((g.cpu() - w).abs().max()) if g.numel() else 0
              for g, w in zip(got, want))
    if err:
        fail(f"{name}: the range kernel's (kmin, kmax) at {rows}-row tiles "
             f"differ from the plain version's by up to {err} rows")
    return float(err)


def ranges_work(B, T, rows):
    """(bytes, operations) of the range kernel: the ids read once, kmin and
    kmax written once; compares and atomics only (0 counted)."""
    return B * T * 4 + 2 * B * (-(-T // rows)) * 4, 0


def paged_case(torch, nkv, gen, lens=K1_LENS,
               pages_max=K1_SHAPE["pages_max"]):
    """Random bf16 pools, q, tables and lens at K1's shapes: each row's
    pages at distinct random ids, unused table slots on junk page 0."""
    B, n, d, page = (K1_SHAPE[k] for k in ("B", "n", "d", "page"))
    dev = "cuda"
    used = [-(-L // page) for L in lens]
    P = 1 + sum(used) + 16
    kp = torch.randn((P, nkv, page, d), generator=gen, device=dev,
                     dtype=torch.bfloat16)
    vp = torch.randn((P, nkv, page, d), generator=gen, device=dev,
                     dtype=torch.bfloat16)
    q = torch.randn((B, n, d), generator=gen, device=dev,
                    dtype=torch.bfloat16)
    perm = torch.randperm(P - 1, generator=gen, device=dev) + 1
    tables = torch.zeros((B, pages_max), dtype=torch.int32, device=dev)
    at = 0
    for b, u in enumerate(used):          # unused slots stay on junk page 0
        tables[b, :u] = perm[at:at + u]
        at += u
    lens = torch.tensor(lens, dtype=torch.int32, device=dev)
    return q, kp, vp, tables, lens


def paged_work(nkv, q8):
    """(bytes, FLOPs) of K1, or K4 with q8, at K1's shapes: each used K / V
    slot read once (int8 codes and their two f32 scales for K4), q, the
    output, the tables and lens once."""
    B, n, d, pages_max = (K1_SHAPE[k] for k in ("B", "n", "d", "pages_max"))
    tok = sum(K1_LENS)
    kv = tok * nkv * d * 2 + tok * nkv * 2 * 4 if q8 else tok * nkv * d * 2 * 2
    return (kv + 2 * B * n * d * 2 + B * (pages_max + 1) * 4,
            tok * n * 4 * d)


def split_of(torch, pa, nkv, pages_max):
    """The kernel's split plan at K1's shapes on this card: (S, P_s)."""
    return pa.split_plan(K1_SHAPE["B"], nkv, K1_SHAPE["n"] // nkv, pages_max,
                         K1_SHAPE["page"],
                         torch.cuda.get_device_properties(0)
                         .multi_processor_count)


def check_paged_kernel(torch, pa, name, nkv, gen, q8):
    """K1 (or K4 over pools quantized from the same bf16 K/V) beyond the
    table shape: two calls give the same bits, and a long row among short
    ones in a 128-page table (most splits empty) matches the plain version.
    -> the max abs error of the second case."""
    def run(q, kp, vp, tables, lens):
        if not q8:
            return (pa.paged_decode_attention(q, kp, vp, tables, lens),
                    lambda: pa.paged_decode_attention_plain(
                        q.float(), kp.float(), vp.float(), tables, lens))
        kq, ks = pa.quantize_kv_token(kp)
        vq, vs = pa.quantize_kv_token(vp)
        return (pa.paged_decode_attention_q8(q, kq, vq, ks, vs, tables, lens),
                lambda: pa.paged_decode_attention_q8_plain(
                    q.float(), kq, vq, ks, vs, tables, lens))

    case = paged_case(torch, nkv, gen)
    first, _ = run(*case)
    again, _ = run(*case)
    torch.cuda.synchronize()
    if not torch.equal(first, again):
        fail(f"{name} nkv={nkv}: two calls on the same inputs differ")
    out, plain = run(*paged_case(torch, nkv, gen, K1_SPARSE_LENS,
                                 K1_SPARSE_PAGES))
    torch.cuda.synchronize()
    return check_close(f"{name} nkv={nkv} pages_max={K1_SPARSE_PAGES}", out,
                       plain())


def gathered(torch, pool, tables):
    """[P, nkv, page, d] pages of each row gathered into [B, nkv, S, d]."""
    B, pm = tables.shape
    _, nkv, page, d = pool.shape
    return pool[tables.long()].permute(0, 2, 1, 3, 4).reshape(
        B, nkv, pm * page, d).contiguous()


def phase_k1(torch, pa, nkv, gen, flush):
    B, n, d, page, pages_max = (K1_SHAPE[k] for k in
                                ("B", "n", "d", "page", "pages_max"))
    dev = "cuda"
    q, kp, vp, tables, lens = paged_case(torch, nkv, gen)
    out = pa.paged_decode_attention(q, kp, vp, tables, lens)
    ref = pa.paged_decode_attention_plain(q.float(), kp.float(), vp.float(),
                                          tables, lens)
    torch.cuda.synchronize()
    err = check_close(f"K1 nkv={nkv}", out, ref)
    # an empty row writes zeros, not NaN
    lens0 = lens.clone()
    lens0[0] = 0
    out0 = pa.paged_decode_attention(q, kp, vp, tables, lens0)
    if not (torch.isfinite(out0.float()).all() and (out0[0] == 0).all()):
        fail(f"K1 nkv={nkv}: a len-0 row did not write zeros")
    err = max(err, check_paged_kernel(torch, pa, "K1", nkv, gen, q8=False))
    ms = time_ms(torch, lambda: pa.paged_decode_attention(
        q, kp, vp, tables, lens), flush)
    plain_ms = time_ms(torch, lambda: pa.paged_decode_attention_plain(
        q, kp, vp, tables, lens), flush)
    # yardstick only: SDPA over K/V gathered beforehand into [B, nkv, S, d]
    S = pages_max * page
    mask = (torch.arange(S, device=dev)[None] < lens[:, None])[:, None, None]
    lib_ms = library_ms(torch, flush, q[:, :, None], gathered(torch, kp, tables),
                        gathered(torch, vp, tables), mask, nkv != n)
    b_ms, b_by = bound(*paged_work(nkv, q8=False))
    S, ps = split_of(torch, pa, nkv, pages_max)
    res = dict(nkv=nkv, max_abs_err=err, ms=ms, plain_ms=plain_ms,
               library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by,
               split=dict(S=S, P_s=ps, sparse_table=split_of(
                   torch, pa, nkv, K1_SPARSE_PAGES)),
               shapes=dict(B=B, n=n, d=d, page=page, pages_max=pages_max,
                           lens=K1_LENS))
    emit("k1", **res)
    return res


def phase_k4(torch, pa, nkv, gen, flush):
    """K4 at K1's shapes over int8 pages quantized from random bf16 K/V."""
    B, n, d, page, pages_max = (K1_SHAPE[k] for k in
                                ("B", "n", "d", "page", "pages_max"))
    dev = "cuda"
    q, kp, vp, tables, lens = paged_case(torch, nkv, gen)
    kq, ks = pa.quantize_kv_token(kp)
    vq, vs = pa.quantize_kv_token(vp)
    del kp, vp
    args = (kq, vq, ks, vs, tables)
    out = pa.paged_decode_attention_q8(q, *args, lens)
    ref = pa.paged_decode_attention_q8_plain(q.float(), *args, lens)
    torch.cuda.synchronize()
    err = check_close(f"K4 nkv={nkv}", out, ref)
    lens0 = lens.clone()
    lens0[0] = 0
    out0 = pa.paged_decode_attention_q8(q, *args, lens0)
    if not (torch.isfinite(out0.float()).all() and (out0[0] == 0).all()):
        fail(f"K4 nkv={nkv}: a len-0 row did not write zeros")
    err = max(err, check_paged_kernel(torch, pa, "K4", nkv, gen, q8=True))
    ms = time_ms(torch, lambda: pa.paged_decode_attention_q8(
        q, *args, lens), flush)
    plain_ms = time_ms(torch, lambda: pa.paged_decode_attention_q8_plain(
        q, *args, lens), flush)
    # yardstick only: SDPA over K/V dequantized and gathered beforehand
    S = pages_max * page
    mask = (torch.arange(S, device=dev)[None] < lens[:, None])[:, None, None]
    kd = (kq.float() * ks[..., None]).to(torch.bfloat16)
    vd = (vq.float() * vs[..., None]).to(torch.bfloat16)
    lib_ms = library_ms(torch, flush, q[:, :, None], gathered(torch, kd, tables),
                        gathered(torch, vd, tables), mask, nkv != n)
    b_ms, b_by = bound(*paged_work(nkv, q8=True))
    S, ps = split_of(torch, pa, nkv, pages_max)
    res = dict(nkv=nkv, max_abs_err=err, ms=ms, plain_ms=plain_ms,
               library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by,
               split=dict(S=S, P_s=ps, sparse_table=split_of(
                   torch, pa, nkv, K1_SPARSE_PAGES)),
               shapes=dict(K1_SHAPE, lens=K1_LENS))
    emit("k4", **res)
    return res


def phase_k3(torch, im, shape, gen, flush):
    """K3 against its plain version on the same bf16 x and int8 q."""
    M, K, N = shape
    dev = "cuda"
    x = torch.randn((M, K), generator=gen, device=dev, dtype=torch.bfloat16)
    w = torch.randn((K, N), generator=gen, device=dev) * K ** -0.5
    qd = im.quantize_int8(w)
    del w
    q, s = qd["q"], qd["s"]
    out = im.int8_matmul(x, q, s)
    ref = im.int8_matmul_plain(x, q, s, torch.float32)
    torch.cuda.synchronize()
    err = check_close(f"K3 {shape}", out, ref)
    del ref
    ms = time_ms(torch, lambda: im.int8_matmul(x, q, s), flush)
    plain_ms = time_ms(torch, lambda: im.int8_matmul_plain(x, q, s), flush)
    # yardstick only: a bf16 matmul on the weight dequantized beforehand
    wd = (q.float() * s).to(torch.bfloat16)
    lib_ms = time_ms(torch, lambda: torch.matmul(x, wd), flush)
    del wd
    b_ms, b_by = bound(*k3_work(M, K, N))
    res = dict(M=M, K=K, N=N, path="wave" if M > im.WAVE_MIN_M else "decode",
               max_abs_err=err, ms=ms, plain_ms=plain_ms,
               library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by)
    emit("k3", **res)
    return res


def phase_k5(torch, rp, shape, gen, flush, timed):
    """K5 forward and backward (the same kernel with -sin) against the
    plain rotate-half on the same bf16 x."""
    B, S, N, d = shape
    x = torch.randn(shape, generator=gen, device="cuda", dtype=torch.bfloat16)
    cos, sin = rp.rope_tables(S, d)
    err = 0.0
    for neg in (False, True):
        out = rp._apply(x, cos, sin, neg)
        ref = rp._composite(x, cos, sin, neg)
        torch.cuda.synchronize()
        err = max(err, check_close(f"K5 {shape} neg_sin={neg}", out, ref,
                                   K5_TOL))
    res = dict(shape=list(shape), max_abs_err=err)
    if timed:
        nbytes = 2 * x.numel() * 2 + 2 * cos.numel() * 4
        b_ms, b_by = bound(nbytes, 3 * x.numel(), PEAK_F32_FLOPS)
        res.update(
            ms=time_ms(torch, lambda: rp._apply(x, cos, sin, False), flush),
            plain_ms=time_ms(torch, lambda: rp._composite(x, cos, sin, False),
                             flush),
            library_ms=None, library="no single call", bound_ms=b_ms,
            bound_by=b_by)
    emit("k5", **res)
    return res


def phase_k6(torch, fa, shape, gen, flush, timed):
    """K6a, K6b and K6c against their plain versions on the same bf16
    q, k, v and dout, causal.  The backward kernels and their plain versions
    both start from the forward kernel's out and lse.  -> three results."""
    import torch.nn.functional as F
    B, S, H, d = shape
    q, k, v, do = (torch.randn(shape, generator=gen, device="cuda",
                               dtype=torch.bfloat16) for _ in range(4))
    out, lse = fa._fwd_kernel(q, k, v, True)
    ref, ref_lse = fa._fwd_plain(q.float(), k.float(), v.float(), True)
    torch.cuda.synchronize()
    err_a = check_close(f"K6a {shape}", out, ref)
    lse_err = check_close(f"K6a lse {shape}", lse, ref_lse)
    del ref, ref_lse
    delta = fa._delta(do, out)
    dq = fa._bwd_dq_kernel(q, k, v, do, lse, delta, True)
    dk, dv = fa._bwd_dkv_kernel(q, k, v, do, lse, delta, True)
    f32 = (q.float(), k.float(), v.float(), do.float(), lse, delta, True)
    ref_dq = fa._bwd_dq_plain(*f32)
    torch.cuda.synchronize()
    err_b = check_close(f"K6b {shape}", dq, ref_dq)
    del ref_dq
    ref_dk, ref_dv = fa._bwd_dkv_plain(*f32)
    torch.cuda.synchronize()
    err_c = max(check_close(f"K6c dk {shape}", dk, ref_dk),
                check_close(f"K6c dv {shape}", dv, ref_dv))
    del ref_dk, ref_dv, f32
    res = [dict(shape=list(shape), max_abs_err=err_a, lse_max_abs_err=lse_err),
           dict(shape=list(shape), max_abs_err=err_b),
           dict(shape=list(shape), max_abs_err=err_c)]
    if timed:
        args = (q, k, v, do, lse, delta, True)
        # yardsticks only: SDPA's forward, and its whole autograd backward
        # (dq, dk and dv in one call, so K6b and K6c share the reading)
        qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_(True)
                      for t in (q, k, v))
        lib_out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
        lib_fwd = time_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True), flush)
        dot = do.transpose(1, 2)
        lib_bwd = time_ms(torch, lambda: torch.autograd.grad(
            lib_out, (qt, kt, vt), dot, retain_graph=True), flush)
        del lib_out
        work_b, work_c = k6_bwd_work(shape)
        for r, ms, plain, lib, work in (
                (res[0], time_ms(torch, lambda: fa._fwd_kernel(q, k, v, True),
                                 flush),
                 time_ms(torch, lambda: fa._fwd_plain(q, k, v, True), flush,
                         reps=5), lib_fwd, k6a_work(shape)),
                (res[1], time_ms(torch, lambda: fa._bwd_dq_kernel(*args),
                                 flush),
                 time_ms(torch, lambda: fa._bwd_dq_plain(*args), flush,
                         reps=5), lib_bwd, work_b),
                (res[2], time_ms(torch, lambda: fa._bwd_dkv_kernel(*args),
                                 flush),
                 time_ms(torch, lambda: fa._bwd_dkv_plain(*args), flush,
                         reps=5), lib_bwd, work_c)):
            b_ms, b_by = bound(*work)
            r.update(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=b_ms,
                     bound_by=b_by, visible_pairs=B * H * S * (S + 1) // 2)
        # the whole backward beside SDPA's: delta (the wrapper's sum of
        # dout * out), K6b and K6c
        delta_ms = time_ms(torch, lambda: fa._delta(do, out), flush)
        res[2].update(delta_ms=delta_ms,
                      bwd_total_ms=res[1]["ms"] + res[2]["ms"] + delta_ms)
        res[1]["library"] = res[2]["library"] = (
            "SDPA's whole backward: dq, dk and dv in one call")
    for phase, r in zip(("k6a", "k6b", "k6c"), res):
        emit(phase, **r)
    return res


def k7_segments(layout, B, T, seed):
    """Segment ids [B, T] of a K7 case: the trunk's ids of packed rows
    (``pack_documents`` over T + 1 tokens, the last column dropped as
    forward_loss drops it), one document a row, or 1,000 one-token
    segments, a 600-token document and a -1 pad tail."""
    if layout == "packed":
        return pack_documents(seed, B, T + 1)[:, :-1].copy()
    if layout == "onedoc":
        return np.zeros((B, T), np.int32)
    seg = np.full((B, T), -1, np.int32)
    seg[:, :1000] = np.arange(1000, dtype=np.int32)
    seg[:, 1000:1600] = 1000
    return seg


def phase_k7(torch, fv, fa, case, seed, gen, flush, timed):
    """K7a and K7b against their plain versions on the same bf16 q, k, v,
    dout and K2's lse and ranges; for the GQA case also autograd through
    flash_attention_segmented against autograd through its plain version.
    -> (dq result, dk / dv result)."""
    import torch.nn.functional as F
    name, B, T, n, nkv, d, causal, layout = case
    seg_np = k7_segments(layout, B, T, seed)
    seg = torch.from_numpy(seg_np).cuda()
    q, do = (torch.randn((B, T, n, d), generator=gen, device="cuda",
                         dtype=torch.bfloat16) for _ in range(2))
    k, v = (torch.randn((B, T, nkv, d), generator=gen, device="cuda",
                        dtype=torch.bfloat16) for _ in range(2))
    ranges = fv._tile_ranges(seg)
    out, lse = fv._seg_fwd(q, k, v, seg, causal, ranges)
    delta = fa._delta(do, out)
    ranges_err = check_ranges(torch, fv, f"K7 {name}", seg, fv.BLOCK_ROWS)
    args = (q, k, v, seg, do, lse, delta, ranges, causal)
    dq = fv._seg_bwd_dq_kernel(*args)
    dk, dv = fv._seg_bwd_dkv_kernel(*args)
    plain = (q, k, v, seg, do, lse, delta, causal)
    f32 = (q.float(), k.float(), v.float(), seg, do.float(), lse, delta,
           causal)
    ref_dq = fv._seg_bwd_dq_plain(*f32)
    torch.cuda.synchronize()
    err_a = check_close(f"K7a {name}", dq, ref_dq)
    del ref_dq
    ref_dk, ref_dv = fv._seg_bwd_dkv_plain(*f32)
    torch.cuda.synchronize()
    err_b = max(check_close(f"K7b dk {name}", dk, ref_dk),
                check_close(f"K7b dv {name}", dv, ref_dv))
    del ref_dk, ref_dv, f32
    shape = dict(B=B, T=T, n=n, nkv=nkv, d=d, causal=causal, layout=layout)
    res = [dict(case=name, max_abs_err=err_a, **shape,
                ranges=dict(rows=fv.BLOCK_ROWS, max_abs_err=ranges_err)),
           dict(case=name, max_abs_err=err_b, **shape)]
    if name == "gqa":
        # the autograd path end to end: K2, then K7a and K7b
        leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
        fv.flash_attention_segmented(*leaves, seg, causal).backward(do)
        ref = [x.float().requires_grad_(True) for x in (q, k, v)]
        fv.segmented_sdpa_plain(*ref, seg, causal).backward(do.float())
        torch.cuda.synchronize()
        res[0]["autograd_max_abs_err"] = max(
            check_close(f"K7 autograd d{w} {name}", a.grad, b.grad)
            for w, a, b in zip("qkv", leaves, ref))
        del leaves, ref
    if timed:
        # yardstick only: the whole autograd backward (dq, dk and dv in one
        # call) of SDPA with the block-diagonal boolean mask
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(True)
                      for x in (q, k, v))
        lib_out = F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=fv._seg_vis(seg, causal),
            enable_gqa=nkv != n)
        lib_bwd = time_ms(torch, lambda: torch.autograd.grad(
            lib_out, (qt, kt, vt), do.transpose(1, 2), retain_graph=True),
            flush)
        del lib_out, qt, kt, vt
        runs = segment_runs(seg_np)
        pairs = int(sum(L * (L + 1) // 2 if causal else L * L for L in runs))
        # one document a row: K6b and K6c on the same inputs (K2's lse is
        # the dense forward's there)
        dense = (fa._bwd_dq_kernel, fa._bwd_dkv_kernel) \
            if layout == "onedoc" else (None, None)
        works = k7_work(seg_np, n, nkv, d, causal)
        for r, fn, pfn, work, dfn, dkv in (
                (res[0], fv._seg_bwd_dq_kernel, fv._seg_bwd_dq_plain,
                 works[0], dense[0], False),
                (res[1], fv._seg_bwd_dkv_kernel, fv._seg_bwd_dkv_plain,
                 works[1], dense[1], True)):
            b_ms, b_by = bound(*work)
            tiles = fv._bwd_tile_walk(seg, causal, d, dkv)
            r.update(ms=time_ms(torch, lambda: fn(*args), flush),
                     plain_ms=time_ms(torch, lambda: pfn(*plain), flush,
                                      reps=5),
                     library_ms=lib_bwd, bound_ms=b_ms, bound_by=b_by,
                     visible_pairs=pairs, documents=documents(seg_np),
                     library="SDPA's whole backward: dq, dk, dv in one call",
                     tiles_visited=len(tiles) * n,
                     tiles_masked=sum(t[-1] for t in tiles) * n)
            if dfn is not None:
                r["dense_ms"] = time_ms(torch, lambda: dfn(
                    q, k, v, do, lse, delta, causal), flush)
    emit("k7", dq=res[0], dkv=res[1])
    return res


def phase_k8(torch, aw, n, gen, flush, timed):
    """K8 on one leaf of ``n`` elements against its plain version; f32 and
    bf16 gradients."""
    hyper = dict(lr=3e-4, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1)
    p = torch.randn(n, generator=gen, device="cuda")
    g = torch.randn(n, generator=gen, device="cuda")
    m = 0.1 * torch.randn(n, generator=gen, device="cuda")
    v = 0.01 * torch.rand(n, generator=gen, device="cuda")
    err = 0.0
    for t, grad in ((1, g), (7, g.to(torch.bfloat16))):
        want = aw.fused_adamw_plain(p, grad, m, v, t, **hyper)
        got = (p.clone(), m.clone(), v.clone())
        aw.fused_adamw(got[0], grad, got[1], got[2], t, **hyper)
        torch.cuda.synchronize()
        for name, a, b in zip("pmv", got, want):
            err = max(err, check_close(f"K8 n={n} t={t} {name}", a, b,
                                       K8_TOL))
        del want, got
    res = dict(n=n, max_abs_err=err)
    if timed:
        # yardstick only: the library's fused AdamW step on one tensor
        lp = p.clone().requires_grad_(True)
        lp.grad = g
        opt = torch.optim.AdamW([lp], lr=hyper["lr"], betas=(0.9, 0.95),
                                eps=1e-8, weight_decay=0.1, fused=True)
        lib_ms = time_ms(torch, opt.step, flush)
        del opt, lp
        b_ms, b_by = bound(28 * n, 12 * n, PEAK_F32_FLOPS)
        res.update(
            ms=time_ms(torch, lambda: aw.fused_adamw(p, g, m, v, 3, **hyper),
                       flush),
            plain_ms=time_ms(torch, lambda: aw.fused_adamw_plain(
                p, g, m, v, 3, **hyper), flush, reps=5),
            library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by)
    emit("k8", **res)
    return res


def phase_k9(torch, rn, case, eps, gen, flush, timed):
    """K9a and K9b against their plain versions on the same bf16 x, weight
    and dout; K9b twice for bit-identical results.  -> (fwd, bwd)."""
    import torch.nn.functional as F
    name, n, h, wdt = case
    x = torch.randn((n, h), generator=gen, device="cuda",
                    dtype=torch.bfloat16)
    w = (1 + 0.1 * torch.randn(h, generator=gen, device="cuda")).to(
        getattr(torch, wdt))
    odt = torch.promote_types(x.dtype, w.dtype)
    do = torch.randn((n, h), generator=gen, device="cuda").to(odt)
    out, rstd = rn._fwd(x, w, eps)
    dx, dw = rn._bwd(x, w, rstd, do)
    dx2, dw2 = rn._bwd(x, w, rstd, do)
    want, want_rstd = rn.rms_norm_plain(x.float(), w.float(), eps)
    want_dx, want_dw = rn.rms_norm_bwd_plain(x.float(), w.float(), want_rstd,
                                             do.float())
    torch.cuda.synchronize()
    if out.dtype != odt or dx.dtype != x.dtype:
        fail(f"K9 {name}: types out {out.dtype}, dx {dx.dtype}")
    identical = bool(torch.equal(dx, dx2) and torch.equal(dw, dw2))
    if not identical:
        fail(f"K9b {name}: two runs on the same inputs differ")
    err_a = max(check_close(f"K9a {name}", out, want),
                check_close(f"K9a rstd {name}", rstd, want_rstd))
    err_b = max(check_close(f"K9b dx {name}", dx, want_dx),
                check_close(f"K9b dw {name}", dw, want_dw))
    del want, want_dx, want_dw, dx2, dw2
    shape = dict(case=name, rows=n, h=h, x="bfloat16", w=wdt)
    res = [dict(max_abs_err=err_a, tolerance=TOL, **shape),
           dict(max_abs_err=err_b, tolerance=TOL, bit_identical=identical,
                **shape)]
    if timed:
        xs, ws, os_ = x.element_size(), w.element_size(), out.element_size()
        # yardsticks only: the library's rms_norm and its autograd backward
        lib_fwd = time_ms(torch, lambda: F.rms_norm(x, (h,), w, eps), flush)
        xr, wr = (t.detach().requires_grad_(True) for t in (x, w))
        lib_out = F.rms_norm(xr, (h,), wr, eps)
        lib_bwd = time_ms(torch, lambda: torch.autograd.grad(
            lib_out, (xr, wr), do, retain_graph=True), flush)
        del lib_out
        for r, ms, plain, lib, work in zip(
                res,
                (time_ms(torch, lambda: rn._fwd(x, w, eps), flush),
                 time_ms(torch, lambda: rn._bwd(x, w, rstd, do), flush)),
                (time_ms(torch, lambda: rn.rms_norm_plain(x, w, eps), flush),
                 time_ms(torch, lambda: rn.rms_norm_bwd_plain(x, w, rstd, do),
                         flush)),
                (lib_fwd, lib_bwd), k9_work(n, h, xs, ws, os_)):
            b_ms, b_by = bound(*work, PEAK_F32_FLOPS)
            r.update(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=b_ms,
                     bound_by=b_by)
        res[0]["library"] = "torch.nn.functional.rms_norm"
        res[1]["library"] = "autograd backward of F.rms_norm"
        res[1]["note"] = "ms includes the torch sum of the dw partials"
    emit("k9", fwd=res[0], bwd=res[1])
    return res


def phase_k10(torch, sw, shape, gen, flush, timed):
    """K10a and K10b against their plain versions on the same bf16 gate, up
    and dout.  -> (fwd, bwd)."""
    g, u, do = (2 * torch.randn(shape, generator=gen, device="cuda")
                for _ in range(3))
    g, u, do = (t.to(torch.bfloat16) for t in (g, u, do))
    out = sw._fwd(g, u)
    dg, du = sw._bwd(g, u, do)
    want = sw.swiglu_plain(g.float(), u.float())
    want_dg, want_du = sw.swiglu_bwd_plain(g.float(), u.float(), do.float())
    torch.cuda.synchronize()
    err_a = check_close(f"K10a {shape}", out, want)
    err_b = max(check_close(f"K10b dg {shape}", dg, want_dg),
                check_close(f"K10b du {shape}", du, want_du))
    del want, want_dg, want_du
    res = [dict(shape=list(shape), max_abs_err=err_a, tolerance=TOL),
           dict(shape=list(shape), max_abs_err=err_b, tolerance=TOL)]
    if timed:
        nel = g.numel()
        for r, ms, plain, nbytes, flops in (
                (res[0], time_ms(torch, lambda: sw._fwd(g, u), flush),
                 time_ms(torch, lambda: sw.swiglu_plain(g, u), flush),
                 3 * nel * 2, 6 * nel),
                (res[1], time_ms(torch, lambda: sw._bwd(g, u, do), flush),
                 time_ms(torch, lambda: sw.swiglu_bwd_plain(g, u, do), flush),
                 5 * nel * 2, 12 * nel)):
            b_ms, b_by = bound(nbytes, flops, PEAK_F32_FLOPS)
            r.update(ms=ms, plain_ms=plain, library_ms=None,
                     library="no single call", bound_ms=b_ms, bound_by=b_by)
    emit("k10", fwd=res[0], bwd=res[1])
    return res


def phase_k11(torch, rmm, case, eps, gen, flush):
    """K11 against its plain version on the same bf16 x and W and the
    norm weight; the trainer's products timed."""
    name, M, H, N, wldt = case
    x = torch.randn((M, H), generator=gen, device="cuda",
                    dtype=torch.bfloat16)
    wl = (1 + 0.1 * torch.randn(H, generator=gen, device="cuda")).to(
        getattr(torch, wldt))
    w = (torch.randn((H, N), generator=gen, device="cuda") * H ** -0.5).to(
        torch.bfloat16)
    out = rmm._fwd(x, wl, w, eps)
    want = rmm.rmsnorm_matmul_plain(x, wl, w, eps)
    torch.cuda.synchronize()
    err = check_close(f"K11 {name}", out, want)
    del want
    res = dict(case=name, M=M, H=H, N=N, wl=wldt, max_abs_err=err,
               tolerance=TOL)
    if M >= 16384:
        # yardstick only: cuBLAS on the activation normalised beforehand
        xf = x.float()
        y = (xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
             * wl.float()).to(torch.bfloat16)
        del xf
        lib_ms = time_ms(torch, lambda: torch.matmul(y, w), flush)
        del y
        b_ms, b_by = bound(*k11_work(M, H, N, wl.element_size()))
        res.update(ms=time_ms(torch, lambda: rmm._fwd(x, wl, w, eps), flush),
                   plain_ms=time_ms(torch, lambda: rmm.rmsnorm_matmul_plain(
                       x, wl, w, eps), flush, reps=5),
                   library_ms=lib_ms,
                   library="cuBLAS matmul on the pre-normalised activation",
                   bound_ms=b_ms, bound_by=b_by)
    emit("k11", **res)
    return res


def library_ms(torch, flush, q, k, v, mask, gqa):
    import torch.nn.functional as F
    return time_ms(torch, lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=mask, enable_gqa=gqa), flush)


def phase_k2(torch, fv, nkv, gen, flush):
    n, d, T = 32, 128, K2_T
    dev = "cuda"
    seg_np, runs = k2_segments()                           # sentinel tail
    seg = torch.from_numpy(seg_np)[None].to(dev)
    q = torch.randn((1, T, n, d), generator=gen, device=dev,
                    dtype=torch.bfloat16)
    k = torch.randn((1, T, nkv, d), generator=gen, device=dev,
                    dtype=torch.bfloat16)
    v = torch.randn((1, T, nkv, d), generator=gen, device=dev,
                    dtype=torch.bfloat16)
    out, lse = fv._seg_fwd(q, k, v, seg, True)
    ref = fv.segmented_sdpa_plain(q.float(), k.float(), v.float(), seg, True)
    # reference lse from the same masked fp32 scores
    pos = torch.arange(T, device=dev)
    vis = (seg[0][:, None] == seg[0][None]) & (pos[:, None] >= pos[None])
    kr = k.float().repeat_interleave(n // nkv, dim=2)
    sc = torch.einsum("qhd,khd->hqk", q[0].float(), kr[0]) / math.sqrt(d)
    ref_lse = torch.logsumexp(sc.masked_fill(~vis, -1e30), dim=-1)
    del sc, kr
    torch.cuda.synchronize()
    err = check_close(f"K2 nkv={nkv}", out, ref)
    lse_err = check_close(f"K2 lse nkv={nkv}", lse[0], ref_lse)
    # a ragged stream (no 128-row tile divides it) runs the same kernel
    Tr = 2000
    out_r = fv.flash_attention_segmented(
        q[:, :Tr].contiguous(), k[:, :Tr].contiguous(),
        v[:, :Tr].contiguous(), seg[:, :Tr].contiguous(), causal=True)
    ref_r = fv.segmented_sdpa_plain(q[:, :Tr].float(), k[:, :Tr].float(),
                                    v[:, :Tr].float(), seg[:, :Tr], True)
    err_r = check_close(f"K2 ragged T={Tr} nkv={nkv}", out_r, ref_r)
    # the range kernel K2 launches first, at its 128-row tiles
    rows = fv.BLOCK_ROWS
    r_err = max(check_ranges(torch, fv, f"K2 T={T}", seg, rows),
                check_ranges(torch, fv, f"K2 ragged T={Tr}",
                             seg[:, :Tr].contiguous(), rows))
    r_ms, r_by = bound(*ranges_work(1, T, rows))
    ranges = dict(rows=rows, T=T, max_abs_err=r_err,
                  ms=time_ms(torch, lambda: fv._tile_ranges(seg, rows),
                             flush),
                  plain_ms=time_ms(torch, lambda: fv._tile_ranges_plain(
                      seg, rows), flush),
                  library_ms=None, bound_ms=r_ms, bound_by=r_by)
    ms = time_ms(torch, lambda: fv._seg_fwd(q, k, v, seg, True), flush)
    plain_ms = time_ms(torch, lambda: fv.segmented_sdpa_plain(
        q, k, v, seg, True), flush)
    lib_ms = library_ms(torch, flush, q.transpose(1, 2).contiguous(),
                        k.transpose(1, 2).contiguous(),
                        v.transpose(1, 2).contiguous(), vis, nkv != n)
    pairs = int(sum(L * (L + 1) // 2 for L in runs))
    b_ms, b_by = bound(*k2_work(T, n, nkv, d, runs))
    res = dict(nkv=nkv, max_abs_err=max(err, err_r), lse_max_abs_err=lse_err,
               ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
               bound_by=b_by, visible_pairs=pairs,
               shapes=dict(T=T, n=n, d=d, segments=K2_SEGMENTS),
               ranges=ranges)
    emit("k2", **res)
    return res


def plain_logits(torch, cfg, params, tokens, dev):
    """Teacher-forced logits [S, V] of one sequence through the plain
    segmented attention (no kernel), computed in ``cfg.dtype``."""
    from paddle_tpu_torch.models.llama_pretrain import (
        _block_post_attn, _mm, _rms_norm, layer_params)
    from paddle_tpu_torch.models.paged_decode import _rope_at
    from paddle_tpu_torch.ops.flash_varlen import segmented_sdpa_plain
    dt = cfg.dtype
    n, nkv, d = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    toks = torch.tensor(tokens, device=dev)[None]
    S = toks.shape[1]
    pos = torch.arange(S, device=dev)
    seg = torch.zeros((1, S), dtype=torch.int32, device=dev)
    x = params["embed"][toks].to(dt)
    for layer in range(cfg.num_hidden_layers):
        bp = layer_params(params, layer)
        y = _rms_norm(x, bp["ln1"], cfg.rms_norm_eps)
        q = _rope_at(_mm(y, bp["wq"], dt).reshape(1, S, n, d),
                     cfg.rope_theta, pos)
        k = _rope_at(_mm(y, bp["wk"], dt).reshape(1, S, nkv, d),
                     cfg.rope_theta, pos)
        v = _mm(y, bp["wv"], dt).reshape(1, S, nkv, d)
        x = _block_post_attn(bp, x, segmented_sdpa_plain(q, k, v, seg, True),
                             cfg)
    h = _rms_norm(x[0], params["final_norm"], cfg.rms_norm_eps)
    return _mm(h, params["lm_head"], dt).float()


def port_logits(torch, cfg, params, cache, prompts, gens, dev):
    """Teacher-forced logits of each served sequence through the port's
    serving path: prompt i prefilled by ``_packed_prefill_body`` (K2) into
    row i of ``cache``, then the served tokens fed back one decode step at
    a time through ``make_paged_decode_step(with_logits=True)`` (K1, or K4
    over an int8 cache; K3 on every matmul of int8 params).
    -> one ``[len(gens[i]), V]`` fp32 tensor per request; the rows are
    released afterwards."""
    from paddle_tpu_torch.models.llama_pretrain import _mm, _rms_norm
    from paddle_tpu_torch.models.paged_decode import (
        _packed_prefill_body, make_paged_decode_step)
    page = cache.page
    pools = (cache.kpool, cache.vpool) + (
        (cache.kscale, cache.vscale) if cache.kv_quant == "int8" else ())
    prefill = _packed_prefill_body(cfg)
    step = make_paged_decode_step(cfg, kv_quant=cache.kv_quant,
                                  with_logits=True)
    out = []
    for i, p in enumerate(prompts):
        S = len(p)
        Wp = -(-S // page) * page            # page-padded, as the engine
        toks = torch.zeros((1, Wp), dtype=torch.long, device=dev)
        toks[0, :S] = torch.tensor(p, device=dev)
        seg = torch.zeros((1, Wp), dtype=torch.int32, device=dev)
        pos = torch.arange(Wp, dtype=torch.int32, device=dev)[None]
        x, ks, vs = prefill(params, toks, seg, pos)
        cache.alloc_row(i, S)
        cache.write_pages_batch([(i, ks, vs, S, 0)])
        h = _rms_norm(x[0, S - 1:S], params["final_norm"], cfg.rms_norm_eps)
        out.append([_mm(h, params["lm_head"], cfg.dtype).float()])
    B = cache.tables.shape[0]
    for j in range(max(len(g) for g in gens) - 1):
        rows = [i for i, g in enumerate(gens) if j + 1 < len(g)]
        cache.ensure_capacity_batch([(i, 1) for i in rows])
        tok = np.zeros(B, np.int64)
        for i in rows:
            tok[i] = gens[i][j]
        tables = torch.from_numpy(cache.tables.copy()).to(dev)
        lens = torch.from_numpy(cache.lens.copy()).to(dev)
        *_, logits = step(params, *pools, tables, lens,
                          torch.from_numpy(tok).to(dev))
        for i in rows:
            out[i].append(logits[i:i + 1])
            cache.lens[i] += 1
    for i in range(len(prompts)):
        cache.release_row(i)
    return [torch.cat(o) for o in out]


@contextlib.contextmanager
def patched(*seams):
    """Replace ``(module, name, value)`` attributes for the block."""
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in seams]
    for mod, name, value in seams:
        setattr(mod, name, value)
    try:
        yield
    finally:
        for mod, name, value in saved:
            setattr(mod, name, value)


# the launch count of each kernel: (name in the kernels line, module key,
# counter attribute)
COUNTERS = [("paged_decode_attention", "pa", "launches"),
            ("flash_attention_segmented", "fv", "launches"),
            ("segment_tile_ranges", "fv", "launches_ranges"),
            ("int8_matmul", "im", "launches"),
            ("int8_matmul_wave", "im", "launches_wave"),
            ("paged_decode_attention_q8", "pa", "launches_q8"),
            ("fused_rope", "rp", "launches"),
            ("flash_attention_fwd", "fa", "launches"),
            ("flash_attention_bwd_dq", "fa", "launches_dq"),
            ("flash_attention_bwd_dkv", "fa", "launches_dkv"),
            ("fused_adamw", "aw", "launches"),
            ("flash_attention_segmented_bwd_dq", "fv", "launches_bwd_dq"),
            ("flash_attention_segmented_bwd_dkv", "fv", "launches_bwd_dkv"),
            ("rms_norm_fwd", "rn", "launches"),
            ("rms_norm_bwd", "rn", "launches_bwd"),
            ("swiglu_fwd", "sw", "launches"),
            ("swiglu_bwd", "sw", "launches_bwd"),
            ("rmsnorm_matmul", "rmm", "launches")]
# the kernels only the trunk's flags reach (all off by default)
FLAGGED = ("rms_norm_fwd", "rms_norm_bwd", "swiglu_fwd", "swiglu_bwd",
           "rmsnorm_matmul")


def zero_counts(mods):
    for _, key, attr in COUNTERS:
        setattr(mods[key], attr, 0)


def read_counts(mods):
    return {name: getattr(mods[key], attr) for name, key, attr in COUNTERS}


SERVE_LENS = [1, 64, 65, 300, 700, 1000, 129]
SERVE_NEWS = [32, 16, 24, 20, 32, 17, 24]


def serve_prompts(cfg, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, L).tolist() for L in SERVE_LENS]


def drive(torch, cfg, params, cache, prompts, news, mods):
    """Serve ``prompts`` concurrently through a GenerationServer (the last
    one streamed), the launch counts set to 0 just before and read just
    after.  Fails on any error, short reply, unlaunched kernel of the
    cache's path or owned page.  -> (tokens per request, stats)."""
    from paddle_tpu_torch.inference.serving import (
        GenerationServer, generate_http, generate_http_stream)
    srv = GenerationServer(cfg, params, cache)
    port = srv.start()
    url = f"http://127.0.0.1:{port}"
    results, errors = {}, []
    ttft = {}

    def client(i):
        try:
            t = time.perf_counter()
            if i == len(prompts) - 1:
                toks = []
                for tok in generate_http_stream(url, prompts[i], news[i],
                                                timeout=600):
                    if not toks:
                        ttft[i] = time.perf_counter() - t
                    toks.append(tok)
            else:
                toks = generate_http(url, prompts[i], news[i], timeout=600)
            results[i] = (toks, time.perf_counter() - t)
        except Exception as e:           # reported below, fails the run
            errors.append(f"request {i}: {type(e).__name__}: {e}")

    zero_counts(mods)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    # daemon threads: a client stuck past its join timeout must not keep
    # the failed run from exiting
    threads = [threading.Thread(target=client, args=(i,), daemon=True)
               for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    wall = time.perf_counter() - t0
    launches = read_counts(mods)
    eng = srv.engine
    health = srv.health_snapshot()
    srv.stop()
    peak = torch.cuda.max_memory_allocated()
    phase = "serve_int8" if cache.kv_quant == "int8" else "serve"
    if errors or len(results) != len(prompts):
        fail(f"{phase}: {errors or 'a request did not return'}")
    for i in range(len(prompts)):
        toks = results[i][0]
        if len(toks) != news[i]:
            fail(f"{phase}: request {i} got {len(toks)} of {news[i]} tokens")
    if cache.kv_quant == "int8":
        path = ["flash_attention_segmented", "paged_decode_attention_q8"]
    else:
        path = ["flash_attention_segmented", "paged_decode_attention"]
    path.append("segment_tile_ranges")
    if isinstance(params["lm_head"], dict):
        path += ["int8_matmul", "int8_matmul_wave"]
    for name in path:
        if launches[name] <= 0:
            fail(f"{phase}: kernel {name} was not launched")
    for name in FLAGGED:
        if launches[name]:
            fail(f"{phase}: kernel {name} was launched with its flag off")
    if cache.audit()["owned"]:
        fail(f"{phase}: pages still owned after every request finished")
    stats = dict(
        wall_s=wall, stream_ttft_s=ttft.get(len(prompts) - 1),
        request_s=[results[i][1] for i in range(len(prompts))],
        decode_tok_s=(eng.tokens_generated / eng.decode_wall_s
                      if eng.decode_wall_s else None),
        decode_steps=health["decode_steps"],
        prefill_waves=health["prefill_calls"], peak_mem_gb=peak / 2**30,
        launches=launches)
    return [results[i][0] for i in range(len(prompts))], stats


def max_diff(a, b):
    return max(float((x - y).abs().max()) for x, y in zip(a, b))


def phase_serve(torch, cfg, seed, mods, dev="cuda"):
    import paddle_tpu_torch.models.paged_decode as pd
    from paddle_tpu_torch.models.llama_pretrain import init_params
    from paddle_tpu_torch.models.paged_decode import PagedKVCache

    t0 = time.perf_counter()
    params = init_params(cfg, seed=seed, device=dev)
    cache = PagedKVCache(cfg, num_pages=256, pages_max=32, batch=8, page=64,
                         device=dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    lens, news = SERVE_LENS, SERVE_NEWS
    prompts = serve_prompts(cfg, seed)
    gens, stats = drive(torch, cfg, params, cache, prompts, news, mods)
    plain = [plain_logits(torch, cfg, params, prompts[i] + gens[i][:-1],
                          dev)[len(prompts[i]) - 1:]
             for i in range(len(prompts))]

    sound = port_logits(torch, cfg, params, cache, prompts, gens, dev)
    logit_diff = max_diff(sound, plain)
    del sound
    # planted fault: every decode layer attends over lens slots instead of
    # lens + 1, missing the token written this step
    real = pd.paged_decode_attention
    with patched((pd, "paged_decode_attention",
                  lambda q, kp, vp, tables, lens:
                  real(q, kp, vp, tables, lens - 1))):
        fault = port_logits(torch, cfg, params, cache, prompts, gens, dev)
    fault_diff = max_diff(fault, plain)
    del fault
    checked = agree = 0
    max_gap = 0.0
    for toks, logits in zip(gens, plain):
        top2 = torch.topk(logits, 2, dim=-1)
        margin = (top2.values[:, 0] - top2.values[:, 1]).tolist()
        gap = (top2.values[:, 0]
               - logits[torch.arange(len(toks)), torch.tensor(toks)]).tolist()
        for j in range(len(toks)):
            max_gap = max(max_gap, gap[j])
            if margin[j] > REPORT_MARGIN:
                checked += 1
                agree += gap[j] == 0.0
    emit("serve", model="LLaMA-7B (LlamaPretrainConfig defaults)",
         layers=cfg.num_hidden_layers, requests=len(prompts),
         prompt_lens=lens, new_tokens=news, setup_s=setup_s, **stats,
         logit_max_abs_diff=logit_diff, logit_limit=LOGIT_LIMIT,
         planted_fault_max_abs_diff=fault_diff,
         served_token_max_gap=max_gap, gap_limit=2 * LOGIT_LIMIT,
         argmax_agree_above_margin=[agree, checked, REPORT_MARGIN])
    if logit_diff > LOGIT_LIMIT:
        fail(f"serve: the port's teacher-forced logits differ from the "
             f"plain forward's by {logit_diff} (limit {LOGIT_LIMIT})")
    if fault_diff <= LOGIT_LIMIT:
        fail(f"serve: the planted fault moved the logits by only "
             f"{fault_diff}, within the limit {LOGIT_LIMIT}: the logit "
             f"check cannot see it")
    if max_gap > 2 * LOGIT_LIMIT:
        fail(f"serve: a greedy token sits {max_gap} below the plain "
             f"teacher-forced top logit (limit {2 * LOGIT_LIMIT})")
    return stats["launches"], params


def phase_serve_int8(torch, cfg, seed, params, mods, dev="cuda"):
    """The serve with int8 weights over int8 KV pages; ``params`` are the
    bf16 serve's weights, quantized here and kept for the bf16 path."""
    import paddle_tpu_torch.models.llama_pretrain as tlp
    import paddle_tpu_torch.models.paged_decode as pd
    from paddle_tpu_torch.models.decode import quantize_params_int8
    from paddle_tpu_torch.models.paged_decode import PagedKVCache
    pa, fv, im = mods["pa"], mods["fv"], mods["im"]

    t0 = time.perf_counter()
    qparams = quantize_params_int8(params)
    cache = PagedKVCache(cfg, num_pages=256, pages_max=32, batch=8, page=64,
                         kv_quant="int8", device=dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    prompts = serve_prompts(cfg, seed)
    gens, stats = drive(torch, cfg, qparams, cache, prompts, SERVE_NEWS,
                        mods)

    def teacher_forced():
        return port_logits(torch, cfg, qparams, cache, prompts, gens, dev)

    t0 = time.perf_counter()
    sound = teacher_forced()
    with patched((tlp, "int8_matmul", im.int8_matmul_plain),
                 (pd, "paged_decode_attention_q8",
                  pa.paged_decode_attention_q8_plain),
                 (pd, "flash_attention_segmented",
                  lambda q, k, v, seg, causal=False:
                  fv.segmented_sdpa_plain(q, k, v, seg, causal))):
        plain = teacher_forced()
    logit_diff = max_diff(sound, plain)
    # planted fault: every decode layer attends over lens slots instead of
    # lens + 1, missing the token written this step
    real = pd.paged_decode_attention_q8
    with patched((pd, "paged_decode_attention_q8",
                  lambda q, kp, vp, ks, vs, tables, lens:
                  real(q, kp, vp, ks, vs, tables, lens - 1))):
        fault = teacher_forced()
    fault_diff = max_diff(fault, plain)
    del fault, plain
    check_s = time.perf_counter() - t0
    # not gated: the int8 path's distance from the bf16 path on the same
    # sequences, as a share of the bf16 logits' spread (JAX's int8-KV
    # acceptance measure)
    share = 0.0
    for i, p in enumerate(prompts):
        ref = plain_logits(torch, cfg, params, p + gens[i][:-1],
                           dev)[len(p) - 1:]
        spread = float(ref.max() - ref.min())
        share = max(share, float((sound[i] - ref).abs().max()) / spread)
    del sound
    emit("serve_int8", model="LLaMA-7B (LlamaPretrainConfig defaults)",
         weights="int8 (quantize_params_int8)", kv_pages="int8",
         layers=cfg.num_hidden_layers, requests=len(prompts),
         prompt_lens=SERVE_LENS, new_tokens=SERVE_NEWS, setup_s=setup_s,
         **stats, logit_check_s=check_s, logit_max_abs_diff=logit_diff,
         logit_limit=INT8_LOGIT_LIMIT, planted_fault_max_abs_diff=fault_diff,
         int8_vs_bf16_share_of_spread=share)
    if logit_diff > INT8_LOGIT_LIMIT:
        fail(f"serve_int8: the kernels' teacher-forced logits differ from "
             f"their plain versions' by {logit_diff} (limit "
             f"{INT8_LOGIT_LIMIT})")
    if fault_diff <= INT8_LOGIT_LIMIT:
        fail(f"serve_int8: the planted fault moved the logits by only "
             f"{fault_diff}, within the limit {INT8_LOGIT_LIMIT}: the logit "
             f"check cannot see it")
    return stats["launches"]


def train_launches_per_step(cfg, flag_set=None):
    """What the code launches in one AdamW step under remat full: K8 once
    per leaf (9 stacked block leaves, embed, final_norm, lm_head); K6a in
    every layer's forward and again in its recompute; K6b and K6c once per
    layer; K5 on q and k in the forward, the recompute and the backward.
    With the flags off, none of K9-K11.  Flag set A: K9a on ln1 and ln2 in
    the forward and the recompute and on the final norm, K9b on each once;
    K10a in the forward and the recompute, K10b once a layer.  Set B: K11
    for q, k, v, gate and up in the forward and the recompute, and K9 on the
    final norm alone (the fused branch bypasses K9 at ln1 / ln2 and K10)."""
    L = cfg.num_hidden_layers
    want = {"fused_adamw": 12, "flash_attention_fwd": 2 * L,
            "flash_attention_bwd_dq": L, "flash_attention_bwd_dkv": L,
            "fused_rope": 2 * L * 3, **{name: 0 for name in FLAGGED}}
    if flag_set == "A":
        want.update(rms_norm_fwd=4 * L + 1, rms_norm_bwd=2 * L + 1,
                    swiglu_fwd=2 * L, swiglu_bwd=L)
    elif flag_set == "B":
        want.update(rms_norm_fwd=1, rms_norm_bwd=1, rmsnorm_matmul=10 * L)
    return want


@contextlib.contextmanager
def trunk_flags(flag_set):
    """The trunk's kernel flags of ``flag_set`` on (the others off) for the
    block, put back as they were afterwards, on failure too."""
    from paddle_tpu_torch.flags import get_flags, set_flags
    saved = get_flags(list(TRUNK_FLAGS))
    set_flags({n: n in FLAG_SETS.get(flag_set, ()) for n in TRUNK_FLAGS})
    try:
        yield
    finally:
        set_flags(saved)


def phase_train(torch, cfg, seed, mods, card, dev="cuda", flag_set=None):
    """Four AdamW steps of the whole trainer on one seeded batch; ``card``
    (the card's name and power limit) goes on the line beside the times.
    With ``flag_set`` ("A" or "B", phase train_fused) the trunk's kernel
    flags of that set are on for the steps."""
    from paddle_tpu_torch.models.llama_pretrain import (
        init_adamw_state, init_params, make_train_step)
    phase = "train" if flag_set is None else "train_fused"
    t0 = time.perf_counter()
    params = init_params(cfg, seed=seed, device=dev, dtype=cfg.param_dtype)
    state = init_adamw_state(params, device=dev)
    step = make_train_step(cfg, device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    tokens = torch.randint(0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_TOKENS),
                           generator=gen, device=dev)
    n_params = sum(p.numel() for p in params["blocks"].values()) + sum(
        params[k].numel() for k in ("embed", "final_norm", "lm_head"))
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    events, losses = [], []
    with trunk_flags(flag_set):
        zero_counts(mods)
        torch.cuda.reset_peak_memory_stats()
        for _ in range(TRAIN_STEPS):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            params, state, loss = step(params, state, tokens)
            end.record()
            events.append((start, end))
            losses.append(loss)
        torch.cuda.synchronize()
        launches = read_counts(mods)
    peak = torch.cuda.max_memory_allocated()
    losses = [float(x) for x in losses]
    step_ms = [a.elapsed_time(b) for a, b in events]
    steady = statistics.median(step_ms[1:])
    want = {k: n * TRAIN_STEPS
            for k, n in train_launches_per_step(cfg, flag_set).items()}
    flags_on = list(FLAG_SETS[flag_set]) if flag_set else []
    emit(phase, model="LLaMA 1.345B (the JAX package's training bench)",
         flag_set=flag_set, flags=flags_on,
         card=card, params=n_params, layers=cfg.num_hidden_layers, batch=TRAIN_BATCH,
         seq=TRAIN_TOKENS - 1, optimizer="adamw", remat="full",
         loss_chunks=cfg.loss_chunks, steps=TRAIN_STEPS, setup_s=setup_s,
         losses=losses, step_ms=step_ms, steady_step_ms=steady,
         tokens_per_s=TRAIN_BATCH * (TRAIN_TOKENS - 1) / steady * 1e3,
         peak_mem_gb=peak / 2**30, launches=launches,
         launches_predicted=want)
    phase = f"{phase} {flag_set}" if flag_set else phase
    if not all(math.isfinite(x) for x in losses):
        fail(f"{phase}: a loss is not finite: {losses}")
    if abs(losses[0] - math.log(cfg.vocab_size)) > 1.0:
        fail(f"{phase}: the first loss {losses[0]} is not within 1.0 of "
             f"ln {cfg.vocab_size} = {math.log(cfg.vocab_size)}")
    if not losses[-1] < losses[0]:
        fail(f"{phase}: the loss did not fall over {TRAIN_STEPS} steps on "
             f"one batch: {losses}")
    if state["t"] != TRAIN_STEPS:
        fail(f"{phase}: the optimizer counts {state['t']} steps")
    for name, n in want.items():
        if launches[name] != n:
            fail(f"{phase}: kernel {name} was launched {launches[name]} "
                 f"times, the code predicts {n}")
    return launches


def train_packed_launches_per_step(cfg):
    """What the code launches in one packed AdamW step under remat full:
    K2 in every layer's forward and its recompute, K7a and K7b once per
    layer, the range kernel before each K2 (the backward takes the
    recompute's ranges), K5 and K8 as in the unpacked step, and none of
    K6a-c (the packed path never takes the unsegmented attention)."""
    L = cfg.num_hidden_layers
    return {"fused_adamw": 12, "flash_attention_segmented": 2 * L,
            "segment_tile_ranges": 2 * L,
            "flash_attention_segmented_bwd_dq": L,
            "flash_attention_segmented_bwd_dkv": L, "fused_rope": 2 * L * 3,
            "flash_attention_fwd": 0, "flash_attention_bwd_dq": 0,
            "flash_attention_bwd_dkv": 0, **{name: 0 for name in FLAGGED}}


def phase_train_packed(torch, cfg, seed, mods, card, dev="cuda"):
    """Four AdamW steps of the whole trainer on one seeded packed batch."""
    import warnings
    from paddle_tpu_torch.models.llama_pretrain import (
        _packed_targets, init_adamw_state, init_params, make_forward)
    t0 = time.perf_counter()
    params = init_params(cfg, seed=seed, device=dev, dtype=cfg.param_dtype)
    state = init_adamw_state(params, device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    tokens = torch.randint(0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_TOKENS),
                           generator=gen, device=dev)
    seg_np = pack_documents(seed, TRAIN_BATCH, TRAIN_TOKENS)
    seg = torch.from_numpy(seg_np).to(dev)
    valid = int(_packed_targets(seg)[1].sum())
    step = packed_step(make_forward(cfg), tokens, seg)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    zero_counts(mods)
    torch.cuda.reset_peak_memory_stats()
    events, losses = [], []
    with warnings.catch_warnings(record=True) as warned:
        warnings.simplefilter("always")
        for _ in range(TRAIN_STEPS):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            params, state, loss = step(params, state)
            end.record()
            events.append((start, end))
            losses.append(loss)
        torch.cuda.synchronize()
    launches = read_counts(mods)
    peak = torch.cuda.max_memory_allocated()
    losses = [float(x) for x in losses]
    step_ms = [a.elapsed_time(b) for a, b in events]
    steady = statistics.median(step_ms[1:])
    want = {k: n * TRAIN_STEPS
            for k, n in train_packed_launches_per_step(cfg).items()}
    emit("train_packed",
         model="LLaMA 1.345B (the JAX package's training bench), packed",
         card=card, layers=cfg.num_hidden_layers, batch=TRAIN_BATCH,
         seq=TRAIN_TOKENS - 1, documents=documents(seg_np),
         pad_tokens=int((seg_np < 0).sum()), valid_targets=valid,
         optimizer="adamw", remat="full", loss_head="plain (segment ids)",
         plain_head_warnings=sum("unchunked loss head" in str(w.message)
                                 for w in warned),
         steps=TRAIN_STEPS, setup_s=setup_s, losses=losses, step_ms=step_ms,
         steady_step_ms=steady,
         tokens_per_s=TRAIN_BATCH * (TRAIN_TOKENS - 1) / steady * 1e3,
         valid_tokens_per_s=valid / steady * 1e3,
         peak_mem_gb=peak / 2**30, launches=launches,
         launches_predicted=want)
    if not all(math.isfinite(x) for x in losses):
        fail(f"train_packed: a loss is not finite: {losses}")
    if abs(losses[0] - math.log(cfg.vocab_size)) > 1.0:
        fail(f"train_packed: the first loss {losses[0]} is not within 1.0 "
             f"of ln {cfg.vocab_size} = {math.log(cfg.vocab_size)}")
    if not losses[-1] < losses[0]:
        fail(f"train_packed: the loss did not fall over {TRAIN_STEPS} steps "
             f"on one batch: {losses}")
    if state["t"] != TRAIN_STEPS:
        fail(f"train_packed: the optimizer counts {state['t']} steps")
    for name, n in want.items():
        if launches[name] != n:
            fail(f"train_packed: kernel {name} was launched {launches[name]} "
                 f"times, the code predicts {n}")
    return launches


def phase_train_packed_grads(torch, cfg, seed, mods, dev="cuda"):
    """The packed forward_loss and its gradients at 2 layers and batch 2
    through the kernels and through their plain versions (also at 4 kv
    heads, with a planted K7b fault there), and the packed loss against the
    documents run alone."""
    import warnings
    import paddle_tpu_torch.models.llama_pretrain as tlp
    rp, fv = mods["rp"], mods["fv"]
    seg_np = pack_documents(seed + 1, 2, TRAIN_TOKENS)
    seg = torch.from_numpy(seg_np).to(dev)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    tokens = torch.randint(0, cfg.vocab_size, (2, TRAIN_TOKENS),
                           generator=gen, device=dev)
    plain = ((tlp, "fused_rope",
              lambda x, cos, sin: rp._composite(x, cos, sin, False)),
             (tlp, "flash_attention_segmented",
              lambda q, k, v, seg, causal=False: fv.segmented_sdpa_plain(
                  q, k, v, seg, causal)))
    real = fv._seg_bwd_dkv_kernel

    def first_member_only(q, k, v, seg, dout, lse, delta, ranges, causal):
        # planted fault: each kv head's dk / dv from its group's first q
        # head alone
        g = q.shape[2] // k.shape[2]
        return real(q[:, :, ::g].contiguous(), k, v, seg,
                    dout[:, :, ::g].contiguous(), lse[:, ::g].contiguous(),
                    delta[:, ::g].contiguous(), ranges, causal)

    def worst(a, b):
        return max(float((x - y).abs().max() / y.abs().max())
                   for x, y in zip(a, b))

    t0 = time.perf_counter()
    res = {}
    for name, nkv in (("mha", cfg.num_key_value_heads), ("gqa", 4)):
        small = type(cfg)(**dict(TRAIN_CFG, num_hidden_layers=2,
                                 num_key_value_heads=nkv))
        params = tlp.init_params(small, seed=seed, device=dev,
                                 dtype=small.param_dtype)
        fwd = tlp.make_forward(small)

        def loss_and_grads():
            live = tlp._map_params(
                lambda p: p.detach().requires_grad_(True), params)
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")    # the plain loss head
                loss = fwd(live, tokens, seg)
            grads = torch.autograd.grad(loss, tlp._leaves(live))
            return float(loss.detach()), grads

        zero_counts(mods)
        loss_k, grads_k = loss_and_grads()
        used = read_counts(mods)
        with patched(*plain):
            zero_counts(mods)
            loss_p, grads_p = loss_and_grads()
            if any(read_counts(mods).values()):
                fail("train_packed_grads: the plain pass launched a kernel")
        for kernel in ("flash_attention_segmented",
                       "flash_attention_segmented_bwd_dq",
                       "flash_attention_segmented_bwd_dkv", "fused_rope"):
            if used[kernel] <= 0:
                fail(f"train_packed_grads: kernel {kernel} was not launched")
        if not all(torch.isfinite(g).all() for g in grads_k):
            fail("train_packed_grads: a gradient is not finite")
        res[name] = dict(kv_heads=nkv, loss_kernels=loss_k,
                         loss_plain=loss_p,
                         grad_max_rel_diff=worst(grads_k, grads_p))
        if name == "gqa":
            with patched((fv, "_seg_bwd_dkv_kernel", first_member_only)):
                _, grads_f = loss_and_grads()
            res[name]["planted_fault_max_rel_diff"] = worst(grads_f, grads_p)
        else:
            mha_params, mha_fwd = params, fwd
        del grads_k, grads_p
    torch.cuda.synchronize()

    # JAX's invariant: each target's loss in the packed rows is its loss in
    # its document run alone (here through the unsegmented kernels), and the
    # packed loss the documents' token-weighted mean.  The planted fault
    # gives K2 one segment for the whole row.
    alone = tlp.make_forward(type(cfg)(**dict(TRAIN_CFG, num_hidden_layers=2,
                                              loss_chunks=0)))
    head = tlp._plain_loss

    def target_losses(fwd, toks, *seg_arg):
        """forward_loss, and each target's loss [B, S - 1] f32 from the
        loss head's input."""
        seen = []

        def spy(x, lm_head, targets, dt, valid=None):
            logits = tlp._mm(x, lm_head, dt).float()
            seen.append(-torch.log_softmax(logits, -1).gather(
                -1, targets[..., None])[..., 0])
            return head(x, lm_head, targets, dt, valid)

        with torch.no_grad(), patched((tlp, "_plain_loss", spy)), \
                warnings.catch_warnings():
            warnings.simplefilter("ignore")        # the plain loss head
            loss = fwd(mha_params, toks, *seg_arg)
        return float(loss), seen[0]

    def one_segment(q, k, v, seg, causal=False):
        return fv.flash_attention_segmented(q, k, v, torch.zeros_like(seg),
                                            causal)

    packed_loss, packed = target_losses(mha_fwd, tokens, seg)
    with patched((tlp, "flash_attention_segmented", one_segment)):
        fault_loss, fault = target_losses(mha_fwd, tokens, seg)
    separate = torch.zeros_like(packed)
    total = weight = 0.0
    for row in range(seg_np.shape[0]):
        for doc in np.unique(seg_np[row][seg_np[row] >= 0]):
            cols = np.flatnonzero(seg_np[row] == doc)
            if len(cols) < 2:
                continue                   # a document of one token: no target
            loss, per_target = target_losses(
                alone, tokens[row, cols[0]:cols[-1] + 1][None])
            separate[row, cols[0]:cols[-1]] = per_target[0]
            total += loss * (len(cols) - 1)
            weight += len(cols) - 1
    separate_loss = total / weight
    valid = tlp._packed_targets(seg)[1].bool()
    token_diff = float((packed - separate)[valid].abs().mean())
    fault_token_diff = float((fault - separate)[valid].abs().mean())
    emit("train_packed_grads", layers=2, batch=2, seq=TRAIN_TOKENS - 1,
         documents=documents(seg_np), **res, grad_limit=GRAD_LIMIT,
         packed_loss=packed_loss, documents_alone_loss=separate_loss,
         loss_diff=abs(packed_loss - separate_loss),
         planted_fault_loss_diff=abs(fault_loss - separate_loss),
         target_loss_mean_abs_diff=token_diff,
         planted_fault_target_loss_mean_abs_diff=fault_token_diff,
         packed_token_limit=PACKED_TOKEN_LIMIT,
         check_s=time.perf_counter() - t0)
    for name, r in res.items():
        if r["grad_max_rel_diff"] > GRAD_LIMIT:
            fail(f"train_packed_grads ({name}): the kernels' gradients differ "
                 f"from their plain versions' by {r['grad_max_rel_diff']} of "
                 f"a leaf's largest (limit {GRAD_LIMIT})")
    if res["gqa"]["planted_fault_max_rel_diff"] <= GRAD_LIMIT:
        fail(f"train_packed_grads: the planted K7b fault moved the gradients "
             f"by only {res['gqa']['planted_fault_max_rel_diff']}, within the "
             f"limit {GRAD_LIMIT}: the check cannot see it")
    if token_diff > PACKED_TOKEN_LIMIT:
        fail(f"train_packed_grads: the targets' losses in the packed rows "
             f"differ from the documents' run alone by {token_diff} on "
             f"average (limit {PACKED_TOKEN_LIMIT})")
    if fault_token_diff <= PACKED_TOKEN_LIMIT:
        fail(f"train_packed_grads: attention across documents moved the "
             f"targets' losses by only {fault_token_diff} on average, within "
             f"the limit {PACKED_TOKEN_LIMIT}: the check cannot see it")


def phase_train_grads(torch, cfg, seed, mods, dev="cuda", flag_set=None):
    """forward_loss and its gradients at 2 layers and batch 2 through the
    kernels, through their plain versions, and through the kernels with a
    planted fault.  With ``flag_set`` ("A" or "B", phase train_fused_grads)
    the trunk's kernel flags of that set are on, and the planted fault is
    the set's: A, K9b's dx without its xhat * c term; B, K11's epilogue
    without the row's rstd."""
    import paddle_tpu_torch.models.llama_pretrain as tlp
    rp, fa, rn, sw, rmm = (mods[k] for k in ("rp", "fa", "rn", "sw", "rmm"))
    phase = "train_grads" if flag_set is None else "train_fused_grads"
    small = type(cfg)(**dict(TRAIN_CFG, num_hidden_layers=2))
    params = tlp.init_params(small, seed=seed, device=dev,
                             dtype=small.param_dtype)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    tokens = torch.randint(0, small.vocab_size, (2, TRAIN_TOKENS),
                           generator=gen, device=dev)
    fwd = tlp.make_forward(small)

    def loss_and_grads():
        live = tlp._map_params(lambda p: p.detach().requires_grad_(True),
                               params)
        loss = fwd(live, tokens)
        grads = torch.autograd.grad(loss, tlp._leaves(live))
        return float(loss.detach()), grads

    def worst(a, b):
        """Largest difference of any leaf over that leaf's largest
        magnitude in ``b``."""
        return max(float((x - y).abs().max() / y.abs().max())
                   for x, y in zip(a, b))

    plain = ((tlp, "fused_rope",
              lambda x, cos, sin: rp._composite(x, cos, sin, False)),
             (tlp, "flash_attention",
              lambda q, k, v, causal=False: fa.sdpa_plain(q, k, v, causal)),
             (rn, "_fwd", rn.rms_norm_plain),
             (rn, "_bwd", rn.rms_norm_bwd_plain),
             (sw, "_fwd", sw.swiglu_plain),
             (sw, "_bwd", sw.swiglu_bwd_plain),
             (rmm, "_fwd", rmm.rmsnorm_matmul_plain))
    real_rope, real_k9b, real_k11 = rp._apply, rn._bwd, rmm._fwd

    def rope_plus_sin(x, cos, sin, neg_sin):
        return real_rope(x, cos, sin, False)

    def k9b_without_c(x, w, rstd, dout):
        _, dw = real_k9b(x, w, rstd, dout)
        return (w.float() * dout.float() * rstd[:, None]).to(x.dtype), dw

    def k11_without_rstd(x, wl, w, eps):
        xf = x.float()
        rstd = torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
        return (real_k11(x, wl, w, eps).float() / rstd).to(x.dtype)

    fault_name, fault = {
        None: ("the RoPE backward rotating with +sin instead of -sin",
               (rp, "_apply", rope_plus_sin)),
        "A": ("K9b's dx without its xhat * c term",
              (rn, "_bwd", k9b_without_c)),
        "B": ("K11's epilogue without the row's rstd",
              (rmm, "_fwd", k11_without_rstd))}[flag_set]
    t0 = time.perf_counter()
    with trunk_flags(flag_set):
        zero_counts(mods)
        loss_k, grads_k = loss_and_grads()
        used = read_counts(mods)
        with patched(*plain):
            zero_counts(mods)
            loss_p, grads_p = loss_and_grads()
            if any(read_counts(mods).values()):
                fail(f"{phase}: the plain pass launched a kernel")
        with patched(fault):
            _, grads_f = loss_and_grads()
    torch.cuda.synchronize()
    diff, fault_diff = worst(grads_k, grads_p), worst(grads_f, grads_p)
    emit(phase, flag_set=flag_set,
         flags=list(FLAG_SETS[flag_set]) if flag_set else [], layers=2,
         batch=2, seq=TRAIN_TOKENS - 1, loss_kernels=loss_k,
         loss_plain=loss_p, grad_max_rel_diff=diff, grad_limit=GRAD_LIMIT,
         planted_fault=fault_name, planted_fault_max_rel_diff=fault_diff,
         launches=used, check_s=time.perf_counter() - t0)
    phase = f"{phase} {flag_set}" if flag_set else phase
    for name, n in train_launches_per_step(small, flag_set).items():
        if name != "fused_adamw" and (used[name] > 0) != (n > 0):
            fail(f"{phase}: kernel {name} was launched {used[name]} times, "
                 f"the code predicts {'some' if n else 'none'}")
    if not all(torch.isfinite(g).all() for g in grads_k):
        fail(f"{phase}: a gradient is not finite")
    if diff > GRAD_LIMIT:
        fail(f"{phase}: the kernels' gradients differ from their plain "
             f"versions' by {diff} of a leaf's largest (limit {GRAD_LIMIT})")
    if fault_diff <= GRAD_LIMIT:
        fail(f"{phase}: the planted fault ({fault_name}) moved the gradients "
             f"by only {fault_diff}, within the limit {GRAD_LIMIT}: the "
             f"check cannot see it")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device (this script measures the port on a card)")
    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import flash_varlen as fv
    from paddle_tpu_torch.ops import fused_adamw as aw
    from paddle_tpu_torch.ops import int8_matmul as im
    from paddle_tpu_torch.ops import paged_attention as pa
    from paddle_tpu_torch.ops import rms_norm as rn
    from paddle_tpu_torch.ops import rmsnorm_matmul as rmm
    from paddle_tpu_torch.ops import rope as rp
    from paddle_tpu_torch.ops import swiglu as sw
    mods = {"pa": pa, "fv": fv, "im": im, "rp": rp, "fa": fa, "aw": aw,
            "rn": rn, "sw": sw, "rmm": rmm}

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else ""
    if not card:
        fail(f"nvidia-smi gave no card: {smi.stderr.strip()}")
    print(card, flush=True)
    kind = torch.cuda.get_device_name(0)
    emit("device", name=kind, nvidia_smi=card,
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda)

    names = ["paged_attention", "flash_varlen", "int8_matmul", "rope",
             "flash_attention", "fused_adamw", "flash_varlen_bwd", "rms_norm",
             "swiglu", "rmsnorm_matmul"]
    t0 = time.perf_counter()
    secs = _build.build(names)
    emit("build", seconds=time.perf_counter() - t0, per_source=secs)
    ptxas = {}
    for name in names:
        log = _build.build_logs.get(name, "")
        for line in log.splitlines():
            if "warning" in line.lower():
                print(f"ptxas {name}.cu: {line.strip()}", file=sys.stderr)
        for label, r in _build.ptxas_report(log).items():
            print(f"ptxas {name}.cu {label}: {r['registers']} registers, "
                  f"{r['spill_stores']} / {r['spill_loads']} bytes spill "
                  f"stores / loads, {r['stack']} stack, {r['smem']} static "
                  f"smem", file=sys.stderr)
            ptxas[f"{name}.cu:{label}"] = r
    print(json.dumps({"ptxas": ptxas}), flush=True)
    for prefix, least in SPILL_FREE.items():
        found = [k for k in ptxas if k.startswith(prefix)]
        if len(found) < least:
            fail(f"ptxas reported {len(found)} functions {prefix}..., want "
                 f"{least}")
        for label in found:
            r = ptxas[label]
            if r["spill_stores"] or r["spill_loads"]:
                fail(f"{label} spills {r['spill_stores']} / "
                     f"{r['spill_loads']} bytes (stores / loads)")

    from paddle_tpu_torch.models.llama_pretrain import LlamaPretrainConfig
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    flush = torch.empty(64 * 2**20, dtype=torch.int32, device="cuda")
    k1 = [phase_k1(torch, pa, nkv, gen, flush) for nkv in (32, 8)]
    k2 = [phase_k2(torch, fv, nkv, gen, flush) for nkv in (32, 8)]
    k3 = [phase_k3(torch, im, shape, gen, flush) for shape in K3_SHAPES]
    k4 = [phase_k4(torch, pa, nkv, gen, flush) for nkv in (32, 8)]
    k5 = [phase_k5(torch, rp, shape, gen, flush, timed=i == 0)
          for i, shape in enumerate(TRAIN_SHAPES)]
    k6 = [phase_k6(torch, fa, shape, gen, flush, timed=i == 0)
          for i, shape in enumerate(TRAIN_SHAPES)]
    k8 = [phase_k8(torch, aw, n, gen, flush, timed=i == 0)
          for i, n in enumerate(K8_SIZES)]
    k7 = [phase_k7(torch, fv, fa, case, args.seed, gen, flush,
                   timed=case[0] in K7_TIMED) for case in K7_CASES]
    eps = LlamaPretrainConfig.rms_norm_eps
    k9 = [phase_k9(torch, rn, case, eps, gen, flush,
                   timed=case[0] in K9_TIMED) for case in K9_CASES]
    k10 = [phase_k10(torch, sw, shape, gen, flush, timed=i == 0)
           for i, shape in enumerate(K10_SHAPES)]
    k11 = [phase_k11(torch, rmm, case, eps, gen, flush) for case in K11_CASES]
    del flush
    torch.cuda.empty_cache()
    cfg = LlamaPretrainConfig()
    launches, params = phase_serve(torch, cfg, args.seed, mods)
    torch.cuda.empty_cache()             # the bf16 serve's cache is gone
    launches_int8 = phase_serve_int8(torch, cfg, args.seed, params, mods)
    del params
    torch.cuda.empty_cache()             # the serves' weights are gone
    train_cfg = LlamaPretrainConfig(**TRAIN_CFG)
    launches_train = phase_train(torch, train_cfg, args.seed, mods, card)
    torch.cuda.empty_cache()
    phase_train_grads(torch, train_cfg, args.seed, mods)
    torch.cuda.empty_cache()
    launches_packed = phase_train_packed(torch, train_cfg, args.seed, mods,
                                         card)
    torch.cuda.empty_cache()
    phase_train_packed_grads(torch, train_cfg, args.seed, mods)
    torch.cuda.empty_cache()
    launches_fused = [phase_train(torch, train_cfg, args.seed, mods, card,
                                  flag_set=flag_set) for flag_set in "AB"]
    torch.cuda.empty_cache()
    for flag_set in "AB":
        phase_train_grads(torch, train_cfg, args.seed, mods, flag_set=flag_set)
    # each kernel's launches in the serve, train, train_packed and
    # train_fused phases
    runs = [launches, launches_int8, launches_train, launches_packed,
            *launches_fused]
    launches = {k: sum(r[k] for r in runs) for k in launches}

    def entry(name, source, replaces, runs):
        # nkv = 32 (LLaMA-7B); K3: decode w_gate, its wave path w_gate at a
        # 2,048-row wave; K5-K8: the trainer's shape,
        # K7 the packed trainer's; K9-K11 the trainer's (K11: gate / up)
        main_shape = runs[0]
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches[name],
                "max_abs_err": max(r["max_abs_err"] for r in runs),
                "ms": main_shape["ms"], "plain_ms": main_shape["plain_ms"],
                "bound_ms": main_shape["bound_ms"],
                "bound_by": main_shape["bound_by"],
                "library_ms": main_shape["library_ms"]}

    print(json.dumps({"kernels": [
        entry("paged_decode_attention",
              "paddle_tpu_torch/csrc/paged_attention.cu",
              "paddle_tpu/ops/pallas/paged_attention.py:215", k1),
        entry("flash_attention_segmented",
              "paddle_tpu_torch/csrc/flash_varlen.cu",
              "paddle_tpu/ops/pallas/flash_varlen.py:342", k2),
        # timed at K2's stream; checked there and at every K7 case
        entry("segment_tile_ranges", "paddle_tpu_torch/csrc/flash_varlen.cu",
              "paddle_tpu/ops/pallas/flash_varlen.py:66",
              [r["ranges"] for r in k2] + [r[0]["ranges"] for r in k7]),
        entry("int8_matmul", "paddle_tpu_torch/csrc/int8_matmul.cu",
              "paddle_tpu/ops/pallas/int8_matmul.py:102",
              [r for r in k3 if r["path"] == "decode"]),
        entry("int8_matmul_wave", "paddle_tpu_torch/csrc/int8_matmul.cu",
              "paddle_tpu/ops/pallas/int8_matmul.py:102",
              [r for r in k3 if r["path"] == "wave"]),
        entry("paged_decode_attention_q8",
              "paddle_tpu_torch/csrc/paged_attention.cu",
              "paddle_tpu/ops/pallas/paged_attention.py:296", k4),
        entry("fused_rope", "paddle_tpu_torch/csrc/rope.cu",
              "paddle_tpu/ops/pallas/rope.py:107", k5),
        entry("flash_attention_fwd",
              "paddle_tpu_torch/csrc/flash_attention.cu",
              "paddle_tpu/ops/pallas/flash_attention.py:285",
              [r[0] for r in k6]),
        entry("flash_attention_bwd_dq",
              "paddle_tpu_torch/csrc/flash_attention.cu",
              "paddle_tpu/ops/pallas/flash_attention.py:319",
              [r[1] for r in k6]),
        entry("flash_attention_bwd_dkv",
              "paddle_tpu_torch/csrc/flash_attention.cu",
              "paddle_tpu/ops/pallas/flash_attention.py:336",
              [r[2] for r in k6]),
        entry("fused_adamw", "paddle_tpu_torch/csrc/fused_adamw.cu",
              "paddle_tpu/ops/pallas/fused_adamw.py:82", k8),
        entry("flash_attention_segmented_bwd_dq",
              "paddle_tpu_torch/csrc/flash_varlen_bwd.cu",
              "paddle_tpu/ops/pallas/flash_varlen.py:399",
              [r[0] for r in k7]),
        entry("flash_attention_segmented_bwd_dkv",
              "paddle_tpu_torch/csrc/flash_varlen_bwd.cu",
              "paddle_tpu/ops/pallas/flash_varlen.py:438",
              [r[1] for r in k7]),
        entry("rms_norm_fwd", "paddle_tpu_torch/csrc/rms_norm.cu",
              "paddle_tpu/ops/pallas/rms_norm.py:91", [r[0] for r in k9]),
        entry("rms_norm_bwd", "paddle_tpu_torch/csrc/rms_norm.cu",
              "paddle_tpu/ops/pallas/rms_norm.py:114", [r[1] for r in k9]),
        entry("swiglu_fwd", "paddle_tpu_torch/csrc/swiglu.cu",
              "paddle_tpu/ops/pallas/swiglu.py:72", [r[0] for r in k10]),
        entry("swiglu_bwd", "paddle_tpu_torch/csrc/swiglu.cu",
              "paddle_tpu/ops/pallas/swiglu.py:96", [r[1] for r in k10]),
        entry("rmsnorm_matmul", "paddle_tpu_torch/csrc/rmsnorm_matmul.cu",
              "paddle_tpu/ops/pallas/rmsnorm_matmul.py:93", k11),
    ], "card": card}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
