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
             K7a's and K7b's four instances, K3's decode instances,
             K9a's register-held instances and K5's instances must spill
             nothing.
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
             and a leaf size no vector divides; k5 also at the serving
             shape [8, 256, 32, 128] (serve_dense's batched lane, timed)
             and one request's [1, 256 | 512, 32, 128] (a spec-on
             admission's draft prefill, 256 timed), forward and backward
             equal to the plain version bit for bit, with the head group
             and grid the kernel launched; k6c also prints delta_ms
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
4b. serve_overlap - the same weights and requests (one admission wave,
             256 pages of 64, batch 8, greedy) through four engine lanes on
             one cache: the eager synchronous lane (the reference),
             overlap=True (lookahead 1), decode_horizon=4 and overlap=True
             with decode_horizon=4, each run twice (the second under a
             CUDA-only torch.profiler): a line a lane with tokens/s, host
             and device ms per token (a micro-step of the batch), the busy
             share (the profiled device time over the unprofiled host
             time), host_syncs, pipeline_flushes, horizon_trimmed_tokens,
             graph replays and the launches each replay makes.  Every
             graph lane must serve the synchronous lane's tokens, token for
             token (else the first diverging request and position and the
             plain forward's logits of both tokens are printed), and must
             launch K1 from graph replays; then the last lane once more
             behind GenerationServer, the requests queued in order into
             one wave, the same tokens.  Launch counts there: the
             wrappers' counts, less the launches they recorded into a graph
             at capture, plus launches per replay x replays.
4c. serve_prefix - prefix caching (enable_prefix_caching=True, the packed
             lane): 8 requests behind one 448-token system prompt (7 pages
             of 64) with tails of 16-200 tokens, in two waves of four: wave
             1 shares the prefix within the wave (history from the stream),
             wave 2 hits the pool (history from the pages); the prefix hits
             by wave (21, 28) and fewer fresh tokens in the pool-hit wave.
             Each wave's admission ms, dispatches, stream slots, hit pages
             and fresh tokens, and the same waves with prefix caching off
             and on the packed lane and on the chunked lane (packed=False,
             prefill_chunk 256, where a hit skips the shared pages' work).
             The served sequences teacher-forced through the prefix lane's
             own admission (the waves again, their prefill's hidden states
             captured): logits within LOGIT_LIMIT of the plain forward's, a
             planted fault (pool history read from the next page) beyond
             it, every served token within 2 * LOGIT_LIMIT of the plain top
             logit.
4d. serve_dense - the packed=False lanes: 8 prompts of 242-256 tokens as
             one batched dense dispatch ([8, 256]: K5 on q and k of every
             layer, 64 launches from serving, counted against the code's),
             then a 1,000-token prompt through the chunked lane (4 chunks of
             256 over the row's cached pages); each wave's admission ms
             and the RoPE tables it built (at most once, for the bucket);
             a fresh batched wave's ms with the tables' memo and without
             it, in turns; the served sequences teacher-forced through
             each lane's own
             admission within LOGIT_LIMIT of the plain forward's, a planted
             fault (K5 rotating by -sin) beyond it.
4e. serve_faults - fault containment (paddle_tpu_torch/testing/faults.py):
             the serve's 7 requests through an engine of batch 4 (waves of
             4 and 3) with a fault injected at the 3rd decode dispatch on
             the sync, overlap and overlap + horizon-4 lanes and at the
             1st prefill dispatch on the packed, batched and chunked
             lanes: exactly the poisoned wave ends "error" with the text,
             step_faults 1 and requests_faulted 4 (engine and registry),
             nothing in flight after the quarantine, the pool clean, the
             graph captured before the fault replayed after it, the
             survivors' teacher-forced logits within LOGIT_LIMIT.  Then
             EngineSupervisor over a factory reusing params and cache: the
             queue moves over with its rids, three restarts capture
             nothing and hold memory_allocated within 256 MB, the fourth
             escalation is EngineDeadError; GenerationServer(
             engine_factory=...): 500 with the text to the faulted wave,
             200 to the rest, /health and /metrics counts, a stream_write
             disconnect cancelling its request, 503 after the supervisor
             died; a planted fault (the quarantine skipping one row's
             release) caught.
4f. serve_mixed - the mixed prefill + decode tick (mixed=True,
             mixed_token_budget 128) against the sequential packed lane, on
             the sync and overlap lanes, under bench.py's
             _serving_mixed_line TPU traffic (a resident batch decoding
             while waves of five prompts of 192-448 tokens and one of 16 or
             32 arrive every 6 ticks, 48 new tokens + 3 a place in the
             wave; batch 8, pages of 64): a line an arm with the decode-step
             host wall p50 / p99 during admission and when quiet (printed,
             not gated), mixed ticks, piggybacked tokens, budget
             utilization, K2 launches (once a layer in every mixed tick),
             fresh tokens a tick (at most the budget), the pool clean; the
             device ms of one mixed tick and each lane's busy share; the
             first two waves served on the sync mixed lane with every
             token's logits recorded where the engine computes it, within
             LOGIT_LIMIT of the plain forward, a planted fault (fresh stream
             K/V one slot late) beyond it; the share of tokens equal to the
             sequential lane's (printed).  The earlier serves build their
             engines with mixed=False and read as before.
4g. serve_spec - speculative decoding (spec=SpecConfig(...)) under
             bench.py's _spec_ab_line workload: stems from
             np.random.RandomState(7), each extended with the target's own
             greedy continuation up to its cycle (the scan served batched
             through the plain engine; without two early cycles the random
             stems serve, and the line says which ran); 8 requests of 64
             tokens, batch 8, pages of 64, through five arms in one
             process: the plain synchronous lane (h1), the target drafting
             for itself at gamma 4 on the synchronous lane and on the
             overlap lane (each round replayed from a CUDA graph, the
             steady state under set_sync_debug_mode("error")), a 2-layer
             draft at LLaMA-7B's widths (seed 1, acceptance near 0: the
             partial accept and catch-up paths) and prompt lookup at gamma
             7.  A line an arm (printed, not gated): decode tok/s, TTFT and
             TPOT p50 / p99, dispatches a token, acceptance, host ms a
             round, device ms of one round and the busy share.  Checks: the
             overlap arm serves the synchronous spec arm's tokens, K1
             (gamma + 1) x draft layers a synchronous round, K5 2 x draft
             layers a spec-on admission, one graph capture (one gamma) and
             none after warm-up, both caches clean; the verify's logits of
             the served sequences, teacher-forced, within LOGIT_LIMIT of
             the plain forward and a planted fault (fresh K/V scattered one
             slot late) beyond it.
4h. serve_swap - the two-tier KV cache (PagedKVCache(host_pages=64), the
             host tier pinned, its copies on a side stream) under bench.py's
             _preemption_line TPU recipe (bench.py:680-690): 6 requests of
             256 prompt tokens from np.random.RandomState(seed) (bench.py's
             RandomState(0) at seed 0), 192 new tokens, greedy, batch 4,
             18 pages of 64 (7 a request at its end: preemption is forced),
             pages_max 8, each arm after a warm-up of 5 requests of 72 new
             tokens (bench.py warms 192, for its jit; the port compiles
             nothing at run time).  Arms, in one process: (a) no host tier
             (recompute resumes), (b) the host tier with the swap forced
             (offload_swap_gbps 1e9) on the synchronous lane, (c) as (b) on
             the overlap lane (every step after the first under
             set_sync_debug_mode("error") outside the flush points:
             _fetch, the admission wave, the pipeline flush), all three on
             the batched packed=False lane (K5 in the dense prefill);
             (e) promotion: serve_prefix's 448-token prompt registered, its
             seven pages demoted by filler traffic (17 pages) and hit again
             on the packed lane; then swap_out, swap_in and host_pool_full
             faults on the overlap lane.  Printed: resume ms per arm and
             their ratio (bench.py's value), swap-out staging and swap-in
             walls, pinned D2H / H2D and pageable D2H GB/s for one
             victim's 6 pages, the device busy share while a victim
             stages under decode-graph replays, decode tok/s and K1 / K2 /
             K5 launches per arm, the pinned bytes and what _preempt_mode
             picks at its defaults (10 GB/s, 989 TFLOP/s).  Checks: every
             swapped page bit for bit after its restore against a snapshot
             taken before the swap-out; the promoted prefix pages against
             theirs; resumes_swapped > 0, prefill_tokens_avoided > 0 and
             no prefill dispatch (and no K2 / K5 launch) in a swap resume;
             (c) serves (b)'s tokens, no capture after its warm-up; each
             fault degrades to recompute with every request served; after
             every arm audit() clean, the host tier empty and the device
             pool back to num_pages - 1 (the promotion arm: its cached
             prefixes aside); the resumed rows' logits, teacher-forced
             (the first 72 served tokens forced into a swapping run on the
             synchronous lane), within LOGIT_LIMIT of the plain forward,
             a planted fault (the pages restored one slot late) beyond it.
4i. serve_swap_int8 - serve_swap's recipe on int8 weights over int8 pages
             (the host tier int8 with its scale planes), the swap forced
             on the overlap lane (d): the scales round-trip bit for bit
             too, K2, K3 (both paths) and K4 launched, the resumed rows'
             logits within INT8_LOGIT_LIMIT of the plain forward over the
             same quantized K / V (every token's K and V through
             quantize_kv_token), the planted fault beyond it.
5. serve_int8 - the same model and requests served with int8 weights
             (quantize_params_int8 of the same seeded weights) over int8
             KV pages: every reply complete, K2 (and its range kernel), K3
             (both paths) and K4 launched, no
             page left owned.  Each served sequence, teacher-forced,
             through the int8 path twice, with the kernels and with every
             kernel replaced by its plain version: logits within
             INT8_LOGIT_LIMIT, a planted fault beyond it; the int8 path's
             distance from the bf16 path is printed, not gated.
5b. serve_int8_overlap - serve_overlap on the int8 weights over int8
             pages: K4 and K3's decode path launched from graph replays.
5c. serve_prefix_int8 - serve_prefix on the int8 weights over int8 pages
             (pool history dequantized by its scales): logits within
             INT8_LOGIT_LIMIT of the same lane with every kernel replaced
             by its plain version, the planted fault beyond it.
5d. serve_mixed_int8 - serve_mixed on the int8 weights over int8 pages
             (K4 in the decode half, K3 on both paths): the recorded logits
             within INT8_LOGIT_LIMIT of the same run replayed teacher-forced
             with every kernel replaced by its plain version.
5e. serve_spec_int8 - serve_spec on the int8 weights over int8 target and
             draft pages (K4 and K3's decode path in the draft's
             micro-steps, K3's wave path in the verify at M = 40): the
             recorded logits within INT8_LOGIT_LIMIT of the same run
             replayed teacher-forced with every kernel replaced by its plain
             version, the planted fault beyond it.
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
import dataclasses
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
# K5 also at the serving shape: the dense batched lane's q / k at 8 prompts
# of a 256-token bucket, LLaMA-7B's 32 heads of 128; and at one request's,
# a spec-on admission's draft prefill or a one-request dense wave (1 prompt
# of 256 or 512).  K5_TIMED are timed.
K5_SHAPES = TRAIN_SHAPES + [(8, 256, 32, 128), (1, 256, 32, 128),
                            (1, 512, 32, 128)]
K5_TIMED = ((8, 2048, 16, 128), (8, 256, 32, 128), (1, 256, 32, 128))
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
# weight); K9a's register-held rows (rms_fwd_rows_kernel<NV, WPR, types>);
# K5's head groups (rope_kernel<T, G>: bf16 and f32, G 1, 2, 4)
SPILL_FREE = {
    **{f"flash_varlen_bwd.cu:flash_bwd_{p}_kernel<{d}, 1>": 1
       for p in ("dq", "dkv") for d in (128, 64)},
    "int8_matmul.cu:int8_decode_kernel<": 4,
    "rms_norm.cu:rms_fwd_rows_kernel<": 24,
    "rope.cu:rope_kernel<": 6}
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
    plain rotate-half on the same bf16 x: equal bit for bit."""
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
        if not torch.equal(out, ref):
            fail(f"K5 {shape} neg_sin={neg}: not bit for bit with the plain "
                 f"version (max abs err {err})")
    group, blocks = rp.launch_plan(shape)
    res = dict(shape=list(shape), max_abs_err=err, group=group,
               blocks=blocks)
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


def plain_logits(torch, cfg, params, tokens, dev, kv_q8=False):
    """Teacher-forced logits [S, V] of one sequence through the plain
    segmented attention (no kernel), computed in ``cfg.dtype``.  With
    ``kv_q8`` every token's K and V go through int8 pages' per-(token,
    head) quantization and back first, as the paged cache holds them."""
    from paddle_tpu_torch.models.llama_pretrain import (
        _block_post_attn, _mm, _rms_norm, layer_params)
    from paddle_tpu_torch.models.paged_decode import _rope_at
    from paddle_tpu_torch.ops.flash_varlen import segmented_sdpa_plain
    from paddle_tpu_torch.ops.paged_attention import quantize_kv_token

    def q8(t):
        if not kv_q8:
            return t
        q, s = quantize_kv_token(t)
        return (q.float() * s[..., None]).to(t.dtype)

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
        k = q8(_rope_at(_mm(y, bp["wk"], dt).reshape(1, S, nkv, d),
                        cfg.rope_theta, pos))
        v = q8(_mm(y, bp["wv"], dt).reshape(1, S, nkv, d))
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


def graph_state():
    """Every decode graph's (graph, replays, captured) by id."""
    from paddle_tpu_torch.models import graphed_step as gs
    return {id(g): (g, g.replays, g.graph is not None) for g in gs.graphs()}


def graph_launches(before):
    """Kernel launches the decode graphs ran since ``before`` (a
    graph_state()): each replay launches its capture's kernels again
    without passing through the wrappers; a capture made since then
    recorded launches (counted by the wrappers) that ran only at replay.
    -> ({kernel: launches replayed}, {kernel: launches captured})."""
    replayed, captured = {}, {}
    for key, (g, n, was) in graph_state().items():
        n0, was0 = (before[key][1], before[key][2]) if key in before \
            else (0, False)
        for name, c in g.capture_launches.items():
            replayed[name] = replayed.get(name, 0) + (n - n0) * c
            if was and not was0:
                captured[name] = captured.get(name, 0) + c
    return replayed, captured


def ran_launches(wrapper, before):
    """The launches that ran: the wrappers' counts, less the launches they
    recorded into a graph at capture, plus every replay's."""
    replayed, captured = graph_launches(before)
    return {k: v - captured.get(k, 0) + replayed.get(k, 0)
            for k, v in wrapper.items()}


def drive(torch, cfg, params, cache, prompts, news, mods, in_order=False,
          observe=None, **engine_kw):
    """Serve ``prompts`` concurrently through a GenerationServer (the last
    one streamed), the launch counts set to 0 just before and read just
    after (with the launches of decode graph replays).  With ``in_order``
    the requests queue in their order and the engine holds its first step
    until all are queued, so they admit in one wave laid out as a direct
    submit lays it out.  ``observe(srv, url)``, when given, runs after
    every reply is in and before the server stops; its result is
    ``stats["observed"]``.  Fails on any error, short reply, unlaunched
    kernel of the cache's path or owned page.  -> (tokens per request,
    stats)."""
    from paddle_tpu_torch.inference.serving import (
        GenerationServer, generate_http, generate_http_stream)
    srv = GenerationServer(cfg, params, cache, **engine_kw)
    if in_order:
        eng, has_work = srv.engine, srv.engine.has_work

        def gated():
            if len(eng._queue) < len(prompts):
                return False
            eng.has_work = has_work
            return has_work()

        eng.has_work = gated
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

    graphs0 = graph_state()
    zero_counts(mods)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    # daemon threads: a client stuck past its join timeout must not keep
    # the failed run from exiting
    threads = [threading.Thread(target=client, args=(i,), daemon=True)
               for i in range(len(prompts))]
    for i, t in enumerate(threads):
        t.start()
        while in_order and srv.engine._next_rid <= i and not errors \
                and time.perf_counter() - t0 < 600:
            time.sleep(0.001)
    for t in threads:
        t.join(timeout=600)
    wall = time.perf_counter() - t0
    launches = ran_launches(read_counts(mods), graphs0)
    eng = srv.engine
    health = srv.health_snapshot()
    observed = observe(srv, url) if observe and not errors else None
    srv.stop()
    peak = torch.cuda.max_memory_allocated()
    phase = "serve_int8" if cache.kv_quant == "int8" else "serve"
    if engine_kw:
        phase += "_overlap"
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
        launches=launches, health=health, observed=observed)
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
    return stats["launches"], qparams


# the serve_overlap lanes: the eager synchronous lane (the reference) and
# the three graph lanes, each of which must serve its tokens
OVERLAP_LANES = [("sync", {}),
                 ("overlap", {"overlap": True, "lookahead": 1}),
                 ("horizon4", {"decode_horizon": 4}),
                 ("overlap_horizon4", {"overlap": True, "decode_horizon": 4})]


def run_lane(torch, cfg, params, cache, prompts, news, mods, engine_kw,
             profiled):
    """Serve ``prompts`` on an engine of ``engine_kw`` over ``cache``:
    the first step (the admission wave and the first dispatch, its capture
    if new) untimed, the rest (pure decode: every request fits the first
    wave) timed on the host clock to a synchronize; with ``profiled`` the
    same window under a CUDA-only torch.profiler.  -> (tokens per request,
    the window's numbers)."""
    from paddle_tpu_torch.models.serving_engine import (
        ContinuousBatchingEngine)
    eng = ContinuousBatchingEngine(cfg, params, cache, **engine_kw)
    rids = [eng.submit(p, max_new_tokens=n) for p, n in zip(prompts, news)]
    graphs0 = graph_state()
    zero_counts(mods)
    eng.step()
    torch.cuda.synchronize()
    if eng.prefill_calls != 1:
        fail(f"serve_overlap: the requests took {eng.prefill_calls} waves")
    tok0, steps0 = eng.tokens_generated, eng.decode_steps
    prof = (torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CUDA]) if profiled
        else contextlib.nullcontext())
    with prof:
        t0 = time.perf_counter()
        while eng.has_work():
            eng.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = ran_launches(read_counts(mods), graphs0)
    replayed, _ = graph_launches(graphs0)
    done = {r.rid: r for r in eng.finished()}
    if sorted(done) != rids or eng._inflight:
        fail(f"serve_overlap: {engine_kw} left requests or dispatches")
    if cache.audit()["owned"]:
        fail(f"serve_overlap: {engine_kw} left pages owned")
    H = eng.decode_horizon
    micro = (eng.decode_steps - steps0) * H
    now = graph_state()
    used = [g for key, (g, n, _) in now.items()
            if n > (graphs0[key][1] if key in graphs0 else 0)]
    stats = dict(
        tokens=eng.tokens_generated - tok0, window_s=wall,
        micro_steps=micro,
        tokens_per_s=(eng.tokens_generated - tok0) / wall,
        host_ms_per_token=wall * 1e3 / micro, host_syncs=eng.host_syncs,
        pipeline_flushes=eng.pipeline_flushes,
        horizon_trimmed_tokens=eng.horizon_trimmed_tokens,
        decode_steps=eng.decode_steps,
        replays=sum(now[id(g)][1] - (graphs0[id(g)][1]
                                     if id(g) in graphs0 else 0)
                    for g in used),
        launches_per_replay=[g.capture_launches for g in used],
        launches=launches, launches_from_replays=replayed)
    if profiled:
        busy_us = sum(e.time_range.elapsed_us() for e in prof.events()
                      if e.device_type == torch.autograd.DeviceType.CUDA)
        stats["device_ms_per_token"] = busy_us / 1e3 / micro
    return [done[r].generated for r in rids], stats


def phase_serve_overlap(torch, cfg, seed, params, mods, kv_quant=None,
                        dev="cuda"):
    """The serve's requests through the four OVERLAP_LANES on one cache
    (so the lanes that share a step key share its graph): every graph lane
    token for token equal to the eager synchronous lane, K1 (K4) and, with
    int8 weights, K3's decode path launched from graph replays; then the
    overlap + horizon lane once more through GenerationServer.  Each lane
    runs twice, unprofiled for its host times and under a CUDA-only
    profiler for its device time; the busy share is the second's device
    time over the first's host time."""
    from paddle_tpu_torch.models import graphed_step as gs
    from paddle_tpu_torch.models.paged_decode import PagedKVCache
    phase = "serve_int8_overlap" if kv_quant else "serve_overlap"
    cache = PagedKVCache(cfg, num_pages=256, pages_max=32, batch=8, page=64,
                         kv_quant=kv_quant, device=dev)
    prompts = serve_prompts(cfg, seed)
    attn = ("paged_decode_attention_q8" if kv_quant
            else "paged_decode_attention")
    path = [attn] + (["int8_matmul"] if isinstance(params["lm_head"], dict)
                     else [])
    total = {}
    ref = None
    for lane, kw in OVERLAP_LANES:
        gens, st = run_lane(torch, cfg, params, cache, prompts, SERVE_NEWS,
                            mods, kw, profiled=False)
        again, st_p = run_lane(torch, cfg, params, cache, prompts,
                               SERVE_NEWS, mods, kw, profiled=True)
        st["device_ms_per_token"] = st_p["device_ms_per_token"]
        st["busy_share"] = st_p["device_ms_per_token"] / \
            st["host_ms_per_token"]
        for k, v in st["launches"].items():
            total[k] = total.get(k, 0) + v + st_p["launches"][k]
        emit(phase, lane=lane, engine_kw=kw, **st,
             launches_note="the wrappers' counts less what they recorded "
             "into a graph at capture, plus each replay's launches "
             "(launches_per_replay x replays)")
        if again != gens:
            fail(f"{phase}: lane {lane} served other tokens on its rerun")
        if ref is None:
            ref = gens
            continue
        for name in path:
            if st["launches_from_replays"].get(name, 0) <= 0:
                fail(f"{phase}: lane {lane} launched {name} from no graph "
                     f"replay")
        if gens != ref:
            i = next(i for i in range(len(ref)) if gens[i] != ref[i])
            j = next(j for j in range(min(len(ref[i]), len(gens[i])))
                     if gens[i][j] != ref[i][j])
            logits = plain_logits(torch, cfg, params,
                                  prompts[i] + ref[i][:j], dev)[-1]
            emit(phase, lane=lane, first_divergence=[i, j],
                 sync_token=ref[i][j], lane_token=gens[i][j],
                 plain_logit_sync=float(logits[ref[i][j]]),
                 plain_logit_lane=float(logits[gens[i][j]]))
            fail(f"{phase}: lane {lane} diverged from the synchronous lane "
                 f"at request {i}, token {j}")
    # the same lane behind the HTTP front, the requests queued in order
    # into one wave as above (a wave of another layout tiles K2's stream
    # differently: other bits, and other tokens at near-ties)
    kw = dict(OVERLAP_LANES[-1][1])
    gens, stats = drive(torch, cfg, params, cache, prompts, SERVE_NEWS, mods,
                        in_order=True, **kw)
    for k, v in stats["launches"].items():
        total[k] = total.get(k, 0) + v
    emit(phase, lane="http_" + OVERLAP_LANES[-1][0], engine_kw=kw,
         health=stats["health"], launches=stats["launches"])
    if gens != ref:
        fail(f"{phase}: GenerationServer(overlap=True, decode_horizon=4) "
             f"served other tokens than the synchronous lane")
    for name in path:
        if stats["launches"][name] <= 0:
            fail(f"{phase}: the HTTP lane did not launch {name}")
    del cache
    gs.clear()
    return total


# serve_observe: the serve's requests behind GenerationServer(overlap=True)
# with the observability the server turns on by default (the engine's own
# registry, the tracer); the names it reads are docs/OBSERVABILITY.md's
OBS_COUNTERS = {
    "paddle_tpu_engine_decode_steps_total": "decode_steps",
    "paddle_tpu_engine_tokens_generated_total": "tokens_generated",
    "paddle_tpu_engine_prefill_dispatches_total": "prefill_calls",
    "paddle_tpu_engine_requests_finished_total": "requests_finished"}
# the spans every served request's trace must hold
OBS_SPANS = ("request", "http_ingress", "queued", "prefill",
             "decode_active", "stream")
OBS_PHASES = ("queued", "prefill", "decode_active", "preempted", "stream")
OBS_TIMED_RUNS = 3


def prom_samples(text):
    """Prometheus text exposition -> {sample name with labels: value}."""
    out = {}
    for line in text.splitlines():
        if line and not line.startswith("#"):
            name, value = line.rsplit(" ", 1)
            out[name] = float(value)
    return out


def hist_quantile(h, q):
    """Prometheus histogram_quantile over a /stats histogram: linear
    inside the bucket that holds the rank (seconds)."""
    n = h["count"]
    if not n:
        return None
    rank, lo, below = q * n, 0.0, 0
    for le, c in h["buckets"].items():
        hi = math.inf if le == "+Inf" else float(le)
        if c >= rank:
            if math.isinf(hi):
                return lo
            return lo + (hi - lo) * (rank - below) / max(c - below, 1)
        lo, below = hi, c
    return lo


def engine_counts(srv, url=None):
    """The served engine's own bookkeeping (idle: every reply is in)."""
    return {attr: getattr(srv.engine, attr) for attr in
            list(OBS_COUNTERS.values()) + ["preemptions", "host_syncs",
                                           "pipeline_flushes"]}


def scrape_observability(srv, url):
    """Everything the observability endpoints serve, and the engine's own
    bookkeeping beside it."""
    import urllib.request

    def get(path):
        with urllib.request.urlopen(url + path, timeout=60) as r:
            return r.read()

    index = json.loads(get("/traces?limit=100"))["traces"]
    return {
        "metrics": get("/metrics").decode(),
        "stats": json.loads(get("/stats")),
        "events": json.loads(get("/events?n=4096"))["events"],
        "traces": index,
        "docs": {t["trace_id"]: json.loads(get(f"/trace/{t['trace_id']}"))
                 for t in index},
        "perfetto": {t["trace_id"]: get(
            f"/trace/{t['trace_id']}?format=perfetto") for t in index},
        "engine": engine_counts(srv)}


def observe_problems(obs, gens):
    """The serve_observe checks -> a list of problems (empty when sound).
    Counters against the engine's bookkeeping, histogram counts, /stats
    against /metrics with trace-id exemplars, each request's trace (phase
    spans gapless, summing to its wall, the boundary spans, a Perfetto
    export with the ring's submissions) and the ring's events."""
    bad = []
    n = len(gens)
    m = prom_samples(obs["metrics"])
    eng = obs["engine"]
    snap = obs["stats"]["metrics"]

    def expect(what, got, want):
        if got != want:
            bad.append(f"{what}: {got} != {want}")

    expect("requests submitted",
           m.get("paddle_tpu_engine_requests_submitted_total"), n)
    expect("requests finished",
           m.get("paddle_tpu_engine_requests_finished_total"), n)
    for name, attr in OBS_COUNTERS.items():
        expect(name, m.get(name), eng[attr])
    # the first token of each request comes from its admission wave and,
    # as in JAX, is not counted in tokens_generated
    expect("tokens_generated_total against the replies",
           m.get("paddle_tpu_engine_tokens_generated_total"),
           sum(len(g) for g in gens) - n)
    expect("preemptions", eng["preemptions"], 0)
    hist = {"paddle_tpu_request_ttft_seconds": n,
            "paddle_tpu_request_queue_wait_seconds": n,
            "paddle_tpu_request_tpot_seconds":
                sum(len(g) > 1 for g in gens),
            "paddle_tpu_engine_decode_step_seconds": eng["decode_steps"]}
    rids = {str(i) for i in range(n)}
    for name, want in hist.items():
        expect(f"{name}_count", m.get(f"{name}_count"), want)
        h = snap.get(name, {})
        expect(f"/stats {name} count", h.get("count"), want)
    for name in list(hist)[:3]:
        ex = snap.get(name, {}).get("exemplars", {})
        for k in ("max", "last"):
            if ex.get(k, {}).get("trace_id") not in rids:
                bad.append(f"{name} exemplar {k} names no served trace: "
                           f"{ex.get(k)}")
    for name in OBS_COUNTERS:
        expect(f"/stats {name}", snap.get(name, {}).get("value"),
               m.get(name))
    ids = sorted(t["trace_id"] for t in obs["traces"])
    expect("/traces ids", ids, sorted(rids))
    for rid, doc in obs["docs"].items():
        names = [s["name"] for s in doc["spans"]]
        for must in OBS_SPANS:
            if must not in names:
                bad.append(f"trace {rid} lacks a {must} span: {names}")
        if doc["status"] != "ok":
            bad.append(f"trace {rid} status {doc['status']}")
        phases = sorted((s for s in doc["spans"] if s["name"] in OBS_PHASES),
                        key=lambda s: s["t0"])
        if not phases:
            continue
        wall = phases[-1]["t0"] + phases[-1]["dur_s"] - phases[0]["t0"]
        total = sum(s["dur_s"] for s in phases)
        if abs(total - wall) > 1e-6 * wall:
            bad.append(f"trace {rid}: phase spans sum to {total} s, wall "
                       f"{wall} s")
        for a, b in zip(phases, phases[1:]):
            if abs(a["t0"] + a["dur_s"] - b["t0"]) > 1e-6 * wall:
                bad.append(f"trace {rid}: gap between {a['name']} and "
                           f"{b['name']}")
        try:
            perf = json.loads(obs["perfetto"][rid])
            if "request_submitted" not in {e["name"]
                                           for e in perf["traceEvents"]}:
                bad.append(f"trace {rid}: the Perfetto export holds no "
                           f"request_submitted")
        except (ValueError, KeyError) as e:
            bad.append(f"trace {rid}: the Perfetto export does not parse: "
                       f"{e}")
    evs = [e["name"] for e in obs["events"]]
    expect("request_submitted events", evs.count("request_submitted"), n)
    expect("request_finished events", evs.count("request_finished"), n)
    return bad


def phase_serve_observe(torch, cfg, seed, params, mods, dev="cuda"):
    """The serve's 7 requests (one streamed) through GenerationServer(
    overlap=True) with metrics_registry=False and tracer=False first (it
    captures the decode graph of this cache, so the runs after it are
    warm); then the same requests with the default registry and tracer
    (all traces kept, so each is checked): observe_problems must find
    nothing, and the tokens, host_syncs and pipeline_flushes must equal
    the uninstrumented run's.  Then a planted fault, the overlap drain's
    tokens_generated hook skipped once, which the counter check must
    catch.  Last, the overlap lane's host ms per token with the
    instrumentation on and off (the least of OBS_TIMED_RUNS runs each,
    taken in turns), and TTFT and TPOT p50 / p99 from the histograms
    beside the client's TTFT."""
    from paddle_tpu_torch.models import graphed_step as gs
    from paddle_tpu_torch.models.paged_decode import PagedKVCache
    from paddle_tpu_torch.models.serving_engine import (
        ContinuousBatchingEngine)
    from paddle_tpu_torch.observability import Tracer
    phase = "serve_observe"
    cache = PagedKVCache(cfg, num_pages=256, pages_max=32, batch=8, page=64,
                         device=dev)
    prompts = serve_prompts(cfg, seed)
    total = {}

    def add(launches):
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v

    def server(observe=scrape_observability, **kw):
        return drive(torch, cfg, params, cache, prompts, SERVE_NEWS, mods,
                     in_order=True, observe=observe, overlap=True, **kw)

    # the server's default tracer, made to keep every trace (its store
    # samples fast ok traces 1 in 10), so that each request is checked
    from paddle_tpu_torch.inference import serving as srv_mod
    real_server_init = srv_mod.GenerationServer.__init__

    def init_keep_all(self, *a, **kw):
        real_server_init(self, *a, **kw)
        if self.tracer is not None:
            self.tracer.store.keep_slower_than_ms = 0.0

    ogens, ost = server(observe=engine_counts, metrics_registry=False,
                        tracer=False)
    add(ost["launches"])
    off = ost["observed"]
    with patched((srv_mod.GenerationServer, "__init__", init_keep_all)):
        gens, st = server()
        obs = st["observed"]
        problems = observe_problems(obs, gens)
        add(st["launches"])

        # planted fault: the overlap drain records its tokens once too few
        real_drain = ContinuousBatchingEngine._drain_one
        skipped = []

        class Null:
            def inc(self, amount=1.0):
                pass

        def drain_skipping_once(self):
            if skipped or self.metrics is None:
                return real_drain(self)
            skipped.append(1)
            counter = self.metrics.tokens_generated
            self.metrics.tokens_generated = Null()
            try:
                return real_drain(self)
            finally:
                self.metrics.tokens_generated = counter

        with patched((ContinuousBatchingEngine, "_drain_one",
                      drain_skipping_once)):
            fgens, fst = server()
        add(fst["launches"])
        fault = observe_problems(fst["observed"], fgens)
    on = obs["engine"]
    # the overlap lane's host time a token, instrumentation on and off
    timed = {"on": [], "off": []}
    for _ in range(OBS_TIMED_RUNS):
        for mode in ("off", "on"):
            kw = ({"overlap": True, "tracer": Tracer()} if mode == "on"
                  else {"overlap": True, "metrics_registry": False})
            tgens, tst = run_lane(torch, cfg, params, cache, prompts,
                                  SERVE_NEWS, mods, kw, profiled=False)
            add(tst["launches"])
            timed[mode].append(tst["host_ms_per_token"])
            if tgens != gens:
                fail(f"{phase}: the direct overlap lane ({mode}) served "
                     f"other tokens than the HTTP run")
    ms_on, ms_off = min(timed["on"]), min(timed["off"])
    snap = obs["stats"]["metrics"]
    ttft = snap["paddle_tpu_request_ttft_seconds"]
    tpot = snap["paddle_tpu_request_tpot_seconds"]
    m = prom_samples(obs["metrics"])
    emit(phase, model="LLaMA-7B (LlamaPretrainConfig defaults)",
         layers=cfg.num_hidden_layers, requests=len(prompts),
         prompt_lens=SERVE_LENS, new_tokens=SERVE_NEWS,
         engine=obs["engine"],
         counters={k: m.get(k) for k in OBS_COUNTERS},
         histogram_counts={k: snap[k]["count"] for k in (
             "paddle_tpu_request_ttft_seconds",
             "paddle_tpu_request_queue_wait_seconds",
             "paddle_tpu_request_tpot_seconds",
             "paddle_tpu_engine_decode_step_seconds")},
         traces=len(obs["docs"]), events=len(obs["events"]),
         problems=problems, planted_fault_problems=fault,
         ttft_mean_s=ttft["sum"] / ttft["count"],
         ttft_p50_s=hist_quantile(ttft, 0.5),
         ttft_p99_s=hist_quantile(ttft, 0.99),
         ttft_max_s=ttft["exemplars"]["max"]["value"],
         tpot_mean_s=tpot["sum"] / tpot["count"],
         tpot_p50_s=hist_quantile(tpot, 0.5),
         tpot_p99_s=hist_quantile(tpot, 0.99),
         tpot_max_s=tpot["exemplars"]["max"]["value"],
         client_stream_ttft_s=st["stream_ttft_s"],
         quantile_note="Prometheus histogram_quantile over the buckets "
         "(linear inside a bucket); mean = sum / count; max from the max "
         "exemplar; a warm run (the graph captured by the run before)",
         host_syncs=[on["host_syncs"], off["host_syncs"]],
         pipeline_flushes=[on["pipeline_flushes"],
                           off["pipeline_flushes"]],
         host_ms_per_token_on=ms_on, host_ms_per_token_off=ms_off,
         host_ms_ratio=ms_on / ms_off, host_ms_runs=timed,
         launches=total)
    if problems:
        fail(f"{phase}: {problems}")
    if not skipped or not any("tokens_generated_total" in p for p in fault):
        fail(f"{phase}: the planted fault (one overlap drain's "
             f"tokens_generated hook skipped) was not caught: {fault}")
    if ogens != gens:
        fail(f"{phase}: instrumentation off served other tokens")
    if (on["host_syncs"], on["pipeline_flushes"]) != \
            (off["host_syncs"], off["pipeline_flushes"]):
        fail(f"{phase}: host_syncs / pipeline_flushes on {on} vs off {off}")
    for name in ("flash_attention_segmented", "paged_decode_attention",
                 "segment_tile_ranges"):
        if st["launches"][name] <= 0:
            fail(f"{phase}: kernel {name} was not launched")
    del cache
    gs.clear()
    return total


# serve_prefix: 8 requests behind one shared system prompt of PREFIX_LEN
# tokens (7 pages of 64) with tails of 16-200 tokens, admitted in two waves
# of four: wave 1 shares the prefix within the wave (the stream), wave 2
# hits the pool
PREFIX_LEN = 448
PREFIX_TAILS = [16, 200, 64, 130, 40, 180, 100, 150]
PREFIX_WAVES = [[0, 1, 2, 3], [4, 5, 6, 7]]
PREFIX_NEW = 16
# serve_dense (packed=False): the batched lane takes 8 prompts of 242-256
# tokens as one dense [8, 256] dispatch (prefill_bucket 256: K5 at
# [8, 256, 32, 128], 2 launches a layer); the chunked lane one prompt of
# 1,000 tokens at prefill_chunk 256 (4 chunk dispatches)
DENSE_LENS = [256, 250, 243, 255, 242, 248, 253, 246]
DENSE_BUCKET = 256
DENSE_NEW = 16
CHUNK_LEN, CHUNK = 1000, 256


def timed_waves(torch, eng):
    """Time every admission wave of ``eng`` on the host clock between two
    synchronizes (the wave's prefill dispatches, page write and first
    tokens), with its dispatches, stream slots, prefix-hit pages, context
    tokens and fresh tokens (context tokens less the reused pages' tokens).
    -> the list each wave appends to."""
    waves = []
    real = eng._admit_wave

    def wave():
        ctx = [len(eng._ctx_of(r)) for r in eng._queue]
        c0 = (eng.prefill_calls, eng.prefill_token_slots,
              eng.cache.prefix_hits)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        real()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        n = len(ctx) - len(eng._queue)
        if n:
            hits = eng.cache.prefix_hits - c0[2]
            waves.append(dict(
                requests=n, ms=ms, dispatches=eng.prefill_calls - c0[0],
                stream_slots=eng.prefill_token_slots - c0[1],
                prefix_hit_pages=hits, context_tokens=sum(ctx[:n]),
                fresh_tokens=sum(ctx[:n]) - eng.cache.page * hits))

    eng._admit_wave = wave
    return waves


def lane_hidden(torch, cfg, params, cache, seqs, waves, wrap=None,
                **engine_kw):
    """Teacher-forced hidden states of ``seqs`` through an engine's own
    admission lane: each wave (a list of indices) is submitted with
    max_new_tokens 1, so it admits as one wave and retires at once; every
    prefill call's hidden states are captured and placed by sequence and
    position (packed: by segment id and position; dense: by row; chunked:
    by the chunk's offset, the requests in order).  ``wrap`` rewrites the
    packed prefill's arguments (a planted fault).  -> one [len, H] tensor
    per sequence (rows of reused prefix pages are not computed)."""
    from paddle_tpu_torch.models.serving_engine import (
        ContinuousBatchingEngine)
    eng = ContinuousBatchingEngine(cfg, params, cache, **engine_kw)
    calls = []
    for name in ("_prefill_packed", "_prefill_dense", "_prefill_chunked"):
        def rec(params, toks, *args, _real=getattr(eng, name), _name=name):
            if wrap is not None and _name == "_prefill_packed" and args[2:]:
                args = wrap(args)
            out = _real(params, toks, *args)
            calls.append((_name, out[0], args))
            return out

        setattr(eng, name, rec)
    hidden = [None] * len(seqs)
    for wave in waves:
        calls.clear()
        for i in wave:
            eng.submit(seqs[i], max_new_tokens=1)
            hidden[i] = torch.zeros((len(seqs[i]), cfg.hidden_size),
                                    dtype=cfg.dtype, device=cache.device)
        eng.step()
        eng.finished()
        if eng.has_work():
            fail(f"lane_hidden: wave {wave} did not admit whole")
        k = 0
        for name, x, args in calls:
            if name == "_prefill_packed":
                seg, pos = args[0][0], args[1][0]
                for j, i in enumerate(wave):
                    idx = (seg == j).nonzero()[:, 0]
                    p = pos[idx].long()
                    ok = p < len(seqs[i])
                    hidden[i][p[ok]] = x[0, idx[ok]]
            elif name == "_prefill_dense":
                for j, i in enumerate(wave):
                    hidden[i] = x[j, :len(seqs[i])]
            else:
                i = wave[k]
                at = int(args[-1])
                n = min(x.shape[1], len(seqs[i]) - at)
                hidden[i][at:at + n] = x[0, :n]
                k += at + n >= len(seqs[i])
    if cache.audit()["owned"]:
        fail("lane_hidden: pages left owned")
    return hidden


def head_logits(cfg, params, h):
    from paddle_tpu_torch.models.llama_pretrain import _mm, _rms_norm
    return _mm(_rms_norm(h, params["final_norm"], cfg.rms_norm_eps),
               params["lm_head"], cfg.dtype).float()


def served_gap(torch, gens, plain):
    """The largest distance of a served token's plain logit below the
    plain top logit."""
    gap = 0.0
    for toks, logits in zip(gens, plain):
        top = logits.max(dim=-1).values
        got = logits[torch.arange(len(toks)), torch.tensor(toks)]
        gap = max(gap, float((top - got).max()))
    return gap


def phase_serve_prefix(torch, cfg, seed, params, mods, kv_quant=None,
                       dev="cuda"):
    """Prefix caching on LLaMA-7B: 8 requests share a PREFIX_LEN-token
    system prompt (7 pages) with tails of 16-200 tokens, served in two
    waves of four on the packed lane with ``enable_prefix_caching``:
    wave 1 shares the prefix within the wave (history from the stream),
    wave 2 hits the pool.  Then each lane's admission time with and
    without prefix caching (the packed lane; the chunked lane, packed=False
    at prefill_chunk 256, where a hit skips computing the shared pages),
    and the served sequences teacher-forced through the prefix lane's own
    admission: their logits within LOGIT_LIMIT of the plain forward's (bf16
    pages), or within INT8_LOGIT_LIMIT of the same lane with every kernel
    replaced by its plain version (int8 weights over int8 pages), and a
    planted fault (pool history read from the next page) beyond it."""
    import paddle_tpu_torch.models.llama_pretrain as tlp
    import paddle_tpu_torch.models.paged_decode as pd
    from paddle_tpu_torch.models.paged_decode import PagedKVCache
    from paddle_tpu_torch.models.serving_engine import (
        ContinuousBatchingEngine)
    fv, im = mods["fv"], mods["im"]
    phase = "serve_prefix_int8" if kv_quant else "serve_prefix"
    int8w = isinstance(params["lm_head"], dict)
    limit = INT8_LOGIT_LIMIT if kv_quant else LOGIT_LIMIT
    rng = np.random.default_rng(seed + 7)
    prefix = rng.integers(0, cfg.vocab_size, PREFIX_LEN).tolist()
    prompts = [prefix + rng.integers(0, cfg.vocab_size, n).tolist()
               for n in PREFIX_TAILS]
    page = 64
    shared = PREFIX_LEN // page

    def new_cache():
        return PagedKVCache(cfg, num_pages=256, pages_max=32, batch=8,
                            page=page, kv_quant=kv_quant, device=dev)

    cache = new_cache()
    eng = ContinuousBatchingEngine(cfg, params, cache,
                                   enable_prefix_caching=True)
    served_waves = timed_waves(torch, eng)
    gens = [None] * len(prompts)
    zero_counts(mods)
    t0 = time.perf_counter()
    for wave in PREFIX_WAVES:
        rids = {eng.submit(prompts[i], max_new_tokens=PREFIX_NEW): i
                for i in wave}
        for r in eng.run_to_completion():
            gens[rids[r.rid]] = r.generated
        cache.audit()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts(mods)
    attn = ("paged_decode_attention_q8" if kv_quant
            else "paged_decode_attention")
    path = ["flash_attention_segmented", "segment_tile_ranges", attn]
    if int8w:
        path += ["int8_matmul", "int8_matmul_wave"]
    for name in path:
        if launches[name] <= 0:
            fail(f"{phase}: kernel {name} was not launched")
    for name in FLAGGED:
        if launches[name]:
            fail(f"{phase}: kernel {name} was launched with its flag off")
    stats = cache.audit()
    if stats["owned"]:
        fail(f"{phase}: pages still owned after every request finished")
    if any(len(g) != PREFIX_NEW for g in gens):
        fail(f"{phase}: a request got other than {PREFIX_NEW} tokens")
    want_hits = [shared * (len(w) - 1) for w in PREFIX_WAVES[:1]] + [
        shared * len(w) for w in PREFIX_WAVES[1:]]
    got_hits = [w["prefix_hit_pages"] for w in served_waves]
    if got_hits != want_hits:
        fail(f"{phase}: prefix hits by wave {got_hits}, want {want_hits}")
    if not served_waves[1]["fresh_tokens"] < served_waves[0]["fresh_tokens"]:
        fail(f"{phase}: the pool-hit wave prefilled "
             f"{served_waves[1]['fresh_tokens']} fresh tokens, the first "
             f"{served_waves[0]['fresh_tokens']}")
    del eng, cache
    torch.cuda.empty_cache()

    # each lane's admission with and without prefix caching (max_new 1:
    # admission only); wave 2 is the pool-hit wave
    lanes = {}
    for lane, kw in (("packed", {}),
                     ("chunked", {"packed": False, "prefill_chunk": 256})):
        for on in (False, True):
            cache = new_cache()
            e = ContinuousBatchingEngine(cfg, params, cache,
                                         enable_prefix_caching=on, **kw)
            tw = timed_waves(torch, e)
            for wave in PREFIX_WAVES:
                for i in wave:
                    e.submit(prompts[i], max_new_tokens=1)
                e.run_to_completion()
            lanes[f"{lane}_{'prefix' if on else 'no_prefix'}"] = tw
            del e, cache
            torch.cuda.empty_cache()
    if not lanes["chunked_prefix"][1]["stream_slots"] < \
            lanes["chunked_no_prefix"][1]["stream_slots"]:
        fail(f"{phase}: the chunked lane's pool-hit wave dispatched no "
             f"fewer token slots with prefix caching")

    seqs = [p + g[:-1] for p, g in zip(prompts, gens)]

    def teacher_forced(wrap=None):
        cache = new_cache()
        hid = lane_hidden(torch, cfg, params, cache, seqs, PREFIX_WAVES,
                          wrap=wrap, enable_prefix_caching=True)
        out = [head_logits(cfg, params, h[len(p) - 1:])
               for h, p in zip(hid, prompts)]
        if cache.prefix_hits != sum(want_hits):
            fail(f"{phase}: the teacher-forced waves hit "
                 f"{cache.prefix_hits} pages, want {sum(want_hits)}")
        del cache, hid
        torch.cuda.empty_cache()
        return out

    def wrong_page(args):
        # pool history read from the next page id
        args = list(args)
        hp, pool_hist = args[6], args[8]
        args[6] = torch.where(pool_hist, (hp + 1) % args[2].shape[1], hp)
        return tuple(args)

    t0 = time.perf_counter()
    sound = teacher_forced()
    if kv_quant:
        with patched((tlp, "int8_matmul", im.int8_matmul_plain),
                     (pd, "flash_attention_segmented",
                      lambda q, k, v, seg, causal=False:
                      fv.segmented_sdpa_plain(q, k, v, seg, causal))):
            plain = teacher_forced()
    else:
        plain = [plain_logits(torch, cfg, params, s, dev)[len(p) - 1:]
                 for s, p in zip(seqs, prompts)]
    logit_diff = max_diff(sound, plain)
    fault = teacher_forced(wrap=wrong_page)
    fault_diff = max_diff(fault, plain)
    gap = None if kv_quant else served_gap(torch, gens, plain)
    check_s = time.perf_counter() - t0
    del sound, fault, plain
    emit(phase, model="LLaMA-7B (LlamaPretrainConfig defaults)",
         weights="int8 (quantize_params_int8)" if int8w else "bf16",
         kv_pages=kv_quant or "bf16", prefix_tokens=PREFIX_LEN,
         tails=PREFIX_TAILS, waves=PREFIX_WAVES, new_tokens=PREFIX_NEW,
         wall_s=wall, served_waves=served_waves, prefix_hits=got_hits,
         lanes=lanes, launches=launches, logit_check_s=check_s,
         logit_max_abs_diff=logit_diff, logit_limit=limit,
         logit_reference=("the same lane, plain kernels" if kv_quant
                          else "plain forward"),
         planted_fault="pool history read from the next page",
         planted_fault_max_abs_diff=fault_diff, served_token_max_gap=gap)
    if logit_diff > limit:
        fail(f"{phase}: the prefix lane's teacher-forced logits differ by "
             f"{logit_diff} (limit {limit})")
    if fault_diff <= limit:
        fail(f"{phase}: the planted fault moved the logits by only "
             f"{fault_diff}, within the limit {limit}")
    if gap is not None and gap > 2 * limit:
        fail(f"{phase}: a greedy token sits {gap} below the plain "
             f"teacher-forced top logit (limit {2 * limit})")
    return launches


def phase_serve_dense(torch, cfg, seed, params, mods, dev="cuda"):
    """The packed=False lanes on LLaMA-7B: 8 prompts of 242-256 tokens in
    one batched wave (one dense [8, 256] dispatch of ``_prefill``, K5 on q
    and k in every layer), then one prompt of CHUNK_LEN tokens through the
    chunked lane (prefill_chunk CHUNK).  K5's launches from serving counted
    against the code's (2 a layer a batched dispatch); the served sequences
    teacher-forced through each lane's own admission within LOGIT_LIMIT of
    the plain forward's logits, and a planted fault (K5 rotating by -sin in
    the batched lane) beyond it."""
    import paddle_tpu_torch.models.llama_pretrain as tlp
    from paddle_tpu_torch.models.paged_decode import PagedKVCache
    from paddle_tpu_torch.models.serving_engine import (
        ContinuousBatchingEngine)
    rp = mods["rp"]
    rng = np.random.default_rng(seed + 11)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in DENSE_LENS]
    prompts.append(rng.integers(0, cfg.vocab_size, CHUNK_LEN).tolist())
    batched, chunked = list(range(len(DENSE_LENS))), [len(DENSE_LENS)]

    def new_cache():
        return PagedKVCache(cfg, num_pages=256, pages_max=32, batch=8,
                            page=64, device=dev)

    cache = new_cache()
    eng = ContinuousBatchingEngine(cfg, params, cache, packed=False,
                                   prefill_bucket=DENSE_BUCKET,
                                   prefill_chunk=CHUNK)
    waves = timed_waves(torch, eng)
    gens = [None] * len(prompts)
    builds = rp.table_builds
    zero_counts(mods)
    t0 = time.perf_counter()
    for wave in (batched, chunked):
        rids = {eng.submit(prompts[i], max_new_tokens=DENSE_NEW): i
                for i in wave}
        for r in eng.run_to_completion():
            gens[rids[r.rid]] = r.generated
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts(mods)
    table_builds = rp.table_builds - builds
    stats = cache.audit()
    del eng, cache
    torch.cuda.empty_cache()
    want_rope = 2 * cfg.num_hidden_layers          # one batched dispatch
    if launches["fused_rope"] != want_rope:
        fail(f"serve_dense: K5 was launched {launches['fused_rope']} times "
             f"from serving, the code predicts {want_rope}")
    if table_builds > 1:
        fail(f"serve_dense: the waves built the RoPE tables {table_builds} "
             f"times; the memo builds them once for the bucket")

    def batched_wave_ms(memo):
        # one batched wave on a fresh engine; without the memo every
        # layer's _rope builds its tables, as before the memo
        cache = new_cache()
        eng = ContinuousBatchingEngine(cfg, params, cache, packed=False,
                                       prefill_bucket=DENSE_BUCKET)
        timed = timed_waves(torch, eng)
        for i in batched:
            eng.submit(prompts[i], max_new_tokens=1)
        build = (rp.cached_tables if memo else
                 lambda s, d, theta, device=None: rp.rope_tables(
                     s, d, theta, device=device))
        with patched((tlp, "cached_tables", build)):
            eng._admit_wave()
        del eng, cache
        torch.cuda.empty_cache()
        return timed[0]["ms"]

    memo_ab = [batched_wave_ms(memo) for memo in (True, False, False, True)]
    if launches["paged_decode_attention"] <= 0:
        fail("serve_dense: kernel paged_decode_attention was not launched")
    for name in ("flash_attention_segmented", "segment_tile_ranges",
                 *FLAGGED):
        if launches[name]:
            fail(f"serve_dense: kernel {name} ran on the dense lanes")
    if stats["owned"] or any(len(g) != DENSE_NEW for g in gens):
        fail(f"serve_dense: pages left owned ({stats}) or a short reply")
    if [w["dispatches"] for w in waves] != [1, -(-CHUNK_LEN // CHUNK)]:
        fail(f"serve_dense: admission dispatches "
             f"{[w['dispatches'] for w in waves]}")

    seqs = [p + g[:-1] for p, g in zip(prompts, gens)]

    def teacher_forced():
        out = [None] * len(seqs)
        for wave, kw in ((batched, dict(prefill_bucket=DENSE_BUCKET)),
                         (chunked, dict(prefill_chunk=CHUNK))):
            cache = new_cache()
            hid = lane_hidden(torch, cfg, params, cache, seqs, [wave],
                              packed=False, **kw)
            for i in wave:
                out[i] = head_logits(cfg, params,
                                     hid[i][len(prompts[i]) - 1:])
            del cache, hid
            torch.cuda.empty_cache()
        return out

    t0 = time.perf_counter()
    sound = teacher_forced()
    plain = [plain_logits(torch, cfg, params, s, dev)[len(p) - 1:]
             for s, p in zip(seqs, prompts)]
    logit_diff = max_diff(sound, plain)
    with patched((tlp, "fused_rope",
                  lambda x, cos, sin: rp._apply(x.contiguous(), cos, sin,
                                                True))):
        fault = teacher_forced()
    fault_diff = max_diff(fault, plain)
    gap = served_gap(torch, gens, plain)
    check_s = time.perf_counter() - t0
    del sound, fault, plain
    emit("serve_dense", model="LLaMA-7B (LlamaPretrainConfig defaults)",
         packed=False, prefill_bucket=DENSE_BUCKET, prefill_chunk=CHUNK,
         batched_prompt_lens=DENSE_LENS, chunked_prompt_len=CHUNK_LEN,
         new_tokens=DENSE_NEW, wall_s=wall, waves=waves,
         rope_table_builds=table_builds,
         batched_wave_ms_memo=[memo_ab[0], memo_ab[3]],
         batched_wave_ms_no_memo=memo_ab[1:3],
         k5_launches_from_serving=launches["fused_rope"],
         k5_launches_predicted=want_rope, launches=launches,
         logit_check_s=check_s, logit_max_abs_diff=logit_diff,
         logit_limit=LOGIT_LIMIT,
         planted_fault="K5 rotating by -sin in the batched lane",
         planted_fault_max_abs_diff=fault_diff, served_token_max_gap=gap)
    if logit_diff > LOGIT_LIMIT:
        fail(f"serve_dense: the dense lanes' teacher-forced logits differ "
             f"from the plain forward's by {logit_diff} (limit "
             f"{LOGIT_LIMIT})")
    if fault_diff <= LOGIT_LIMIT:
        fail(f"serve_dense: the planted fault moved the logits by only "
             f"{fault_diff}, within the limit {LOGIT_LIMIT}")
    if gap > 2 * LOGIT_LIMIT:
        fail(f"serve_dense: a greedy token sits {gap} below the plain "
             f"teacher-forced top logit (limit {2 * LOGIT_LIMIT})")
    return launches


# serve_faults: the serve's 7 requests through an engine of batch 4 (two
# admission waves, 4 + 3) under faults the port's plane injects
# (paddle_tpu_torch/testing/faults.py); FAULT_FILLER requests keep a
# persistent fault fed where a supervisor must escalate
FAULT_BATCH = 4
FAULT_TEXT = "injected fault"
FAULT_FILLER = (16, 4)              # prompt tokens, new tokens
FAULT_MEM_LIMIT = 256 * 2**20       # bytes, across three restarts


def fault_cache(cfg, dev):
    from paddle_tpu_torch.models.paged_decode import PagedKVCache
    return PagedKVCache(cfg, num_pages=256, pages_max=32, batch=FAULT_BATCH,
                        page=64, device=dev)


def quarantine_problems(eng):
    """What a quarantine must leave, read right after the faulting step:
    nothing in flight, no device loop state, nothing mid-admission, and no
    free slot holding a page."""
    bad = []
    if eng._inflight or eng._dev is not None:
        bad.append(f"in flight {len(eng._inflight)}, device state "
                   f"{eng._dev is not None} after the quarantine")
    if eng._admitting:
        bad.append(f"{len(eng._admitting)} requests left mid-admission")
    held = [s for s in eng._free_slots if eng.cache._owned[s]]
    if held:
        bad.append(f"free slots {held} still own pages")
    return bad


def drain_problems(eng, cache):
    """The pool after every request finished: audit clean, every page but
    the reserved one free, every slot free."""
    bad = []
    try:
        stats = cache.audit()
    except AssertionError as e:
        return [f"audit: {e}"]
    if stats["owned"] or cache.free_pages() != cache.num_pages - 1:
        bad.append(f"pages not back: {stats}, free {cache.free_pages()}")
    if len(eng._free_slots) != eng.B:
        bad.append(f"{eng.B - len(eng._free_slots)} slots not free")
    return bad


def fault_drive(eng, prompts, news, on_fault=None):
    """Submit ``prompts`` and step ``eng`` until idle, calling
    ``on_fault(eng)`` right after each step that quarantined.
    -> (the requests by submission index, on_fault's results)."""
    rids = [eng.submit(p, max_new_tokens=n) for p, n in zip(prompts, news)]
    seen = []
    while eng.has_work():
        f0 = eng.step_faults
        eng.step()
        if eng.step_faults > f0 and on_fault is not None:
            seen.append(on_fault(eng))
    done = {r.rid: r for r in eng.finished()}
    return [done.get(r) for r in rids], seen


def outcome_problems(reqs, news, faulted, text=FAULT_TEXT):
    """Every request has a record; the ``faulted`` indices ended "error"
    with the injected text, the rest "ok" with their whole budget."""
    bad = []
    for i, r in enumerate(reqs):
        if r is None:
            bad.append(f"request {i} has no finished record")
        elif i in faulted:
            if r.status != "error" or text not in (r.error or ""):
                bad.append(f"request {i}: {r.status} {r.error!r}, want "
                           f"error with {text!r}")
        elif r.status != "ok" or len(r.generated) != news[i]:
            bad.append(f"request {i}: {r.status}, {len(r.generated)} of "
                       f"{news[i]} tokens")
    return bad


def counter_problems(eng, step_faults, faulted):
    bad = []
    want = (step_faults, faulted)
    for where, got in (("engine", (eng.step_faults, eng.requests_faulted)),
                       ("registry", (eng.step_faults,
                                     int(eng.metrics.requests_faulted.value)
                                     if eng.metrics else faulted))):
        if got != want:
            bad.append(f"{where}: step_faults, requests_faulted {got}, "
                       f"want {want}")
    return bad


def phase_serve_faults(torch, cfg, seed, params, mods, dev="cuda"):
    """Fault containment on LLaMA-7B (bf16, the serve's weights): the
    serve's 7 requests through an engine of batch 4, so they admit in two
    waves (4 + 3), under faults injected by the port's plane.

    1. sync lane, the 3rd step_dispatch raises: exactly the first wave
       ends "error" with the text, step_faults 1 and requests_faulted 4 in
       the engine and the registry, the other 3 "ok", the pool clean;
    2. overlap and overlap + decode_horizon 4, the 3rd dispatch raises with
       a dispatch in flight: the same, nothing in flight and no device
       state after the quarantine, and the graph captured before the fault
       replays after it (no new capture; K1 from replays after it);
    3. the 1st prefill_dispatch raises on the packed, batched and chunked
       lanes: every request has a record, the popped wave ends "error",
       the rest serve (K2 on the packed lane, K5 on the others);
    4. EngineSupervisor over a factory reusing params and cache
       (overlap, max_consecutive_faults 2) and a fault on every dispatch:
       a restart moves the queue over with its rids, which serve once the
       rule is cleared; three restarts capture nothing new and hold
       memory_allocated within FAULT_MEM_LIMIT; the fourth escalation is
       EngineDeadError;
    5. GenerationServer(engine_factory=..., overlap=True): the faulted
       wave's clients get 500 with the text, the rest 200; /health
       step_faults 1, /metrics requests_faulted 4; an armed stream_write
       cancels its stream (requests_cancelled + 1, the pages back); a
       DEAD supervisor makes a new submit 503;
    6. a planted defect (the quarantine skipping one row's release) must be
       caught.

    The survivors of 1-5 are teacher-forced through the port's path
    (port_logits) against the plain forward: within LOGIT_LIMIT, each
    served token within 2 * LOGIT_LIMIT of the plain top logit.
    -> the launches of the serving runs."""
    import gc
    import urllib.error
    import urllib.request

    from paddle_tpu_torch.inference.serving import (
        GenerationServer, generate_http, generate_http_stream)
    from paddle_tpu_torch.models import graphed_step as gs
    from paddle_tpu_torch.models.serving_engine import (
        ContinuousBatchingEngine, EngineDeadError, EngineSupervisor,
        _release_engine_claims)
    from paddle_tpu_torch.observability import MetricsRegistry
    from paddle_tpu_torch.testing import faults
    phase = "serve_faults"
    t_phase = time.perf_counter()
    cache = fault_cache(cfg, dev)
    prompts, news = serve_prompts(cfg, seed), SERVE_NEWS
    wave1 = set(range(FAULT_BATCH))
    rng = np.random.default_rng(seed + 13)
    filler = [rng.integers(0, cfg.vocab_size, FAULT_FILLER[0]).tolist()
              for _ in range(16)]
    problems = {}
    total = {}
    checked = {}

    def count(fn):
        """Run ``fn`` with the launch counts from 0; its launches (graph
        replays included) join the phase's."""
        graphs0 = graph_state()
        zero_counts(mods)
        out = fn()
        torch.cuda.synchronize()
        ran = ran_launches(read_counts(mods), graphs0)
        for k, v in ran.items():
            total[k] = total.get(k, 0) + v
        return out, ran

    def survivors(idx, gens):
        """The logit bar on served sequences, once per distinct set."""
        key = tuple((i, tuple(g)) for i, g in zip(idx, gens))
        if key not in checked:
            ps = [prompts[i] for i in idx]
            sound = port_logits(torch, cfg, params, cache, ps, gens, dev)
            plain = [plain_logits(torch, cfg, params, p + g[:-1],
                                  dev)[len(p) - 1:]
                     for p, g in zip(ps, gens)]
            checked[key] = (max_diff(sound, plain),
                            served_gap(torch, gens, plain))
            del sound, plain
        diff, gap = checked[key]
        bad = []
        if diff > LOGIT_LIMIT:
            bad.append(f"survivors' logits {diff} from the plain forward "
                       f"(limit {LOGIT_LIMIT})")
        if gap > 2 * LOGIT_LIMIT:
            bad.append(f"a survivor's token {gap} below the plain top "
                       f"logit (limit {2 * LOGIT_LIMIT})")
        return bad, diff, gap

    def lane_run(name, engine_kw, site, nth, faulted, path):
        eng = ContinuousBatchingEngine(cfg, params, cache, **engine_kw)
        at_fault = {}

        def on_fault(e):
            at_fault["graphs"] = graph_state()
            return quarantine_problems(e)

        with faults.plane() as fp:
            fp.inject(site, RuntimeError(FAULT_TEXT), nth=nth)
            (reqs, seen), ran = count(
                lambda: fault_drive(eng, prompts, news, on_fault))
        bad = [p for s in seen for p in s]
        bad += outcome_problems(reqs, news, faulted)
        bad += counter_problems(eng, 1, len(faulted))
        bad += drain_problems(eng, cache)
        for k in path:
            if ran.get(k, 0) <= 0:
                bad.append(f"kernel {k} was not launched")
        res = {"engine_kw": engine_kw, "site": site, "nth": nth,
               "statuses": [r.status if r else None for r in reqs],
               "step_faults": eng.step_faults,
               "requests_faulted": eng.requests_faulted,
               "requests_faulted_registry":
                   eng.metrics.requests_faulted.value,
               "launches": {k: v for k, v in ran.items() if v}}
        if "graphs" in at_fault:
            before = at_fault["graphs"]
            now = graph_state()
            new_captures = sum(c and not (key in before and before[key][2])
                               for key, (_, _, c) in now.items())
            replayed, _ = graph_launches(before)
            res.update(captures_after_fault=new_captures,
                       k1_from_replays_after_fault=replayed.get(
                           "paged_decode_attention", 0))
            if engine_kw.get("overlap") or \
                    engine_kw.get("decode_horizon", 1) > 1:
                if new_captures:
                    bad.append(f"{new_captures} graphs captured after the "
                               f"fault")
                if replayed.get("paged_decode_attention", 0) <= 0:
                    bad.append("K1 launched from no replay after the fault")
        idx = [i for i in range(len(prompts)) if i not in faulted]
        if not bad:
            more, res["logit_max_abs_diff"], res["served_token_max_gap"] = \
                survivors(idx, [reqs[i].generated for i in idx])
            bad += more
        emit(phase, sub=name, **res, problems=bad)
        problems[name] = bad
        return eng

    # 1-3: one engine a lane over one cache
    lane_run("sync", {}, "step_dispatch", 3, wave1,
             ["paged_decode_attention", "flash_attention_segmented"])
    for name, kw in (("overlap", {"overlap": True}),
                     ("overlap_horizon4", {"overlap": True,
                                           "decode_horizon": 4})):
        lane_run(name, kw, "step_dispatch", 3, wave1,
                 ["paged_decode_attention"])
    for name, kw, path in (
            ("admit_packed", {}, ["flash_attention_segmented"]),
            ("admit_batched", {"packed": False}, ["fused_rope"]),
            ("admit_chunked", {"packed": False, "prefill_chunk": 256},
             ["fused_rope"])):
        lane_run(name, kw, "prefill_dispatch", 1, wave1,
                 path + ["paged_decode_attention"])

    # 4: the supervisor, over the same params and cache
    reg = MetricsRegistry()

    def factory():
        return ContinuousBatchingEngine(cfg, params, cache, overlap=True,
                                        max_consecutive_faults=2,
                                        metrics_registry=reg)

    sup = EngineSupervisor(factory, max_restarts=3, window_s=3600.0,
                           backoff_s=0.0)
    bad = []
    fill_new = [FAULT_FILLER[1]] * len(filler)

    def until_restart(subs, new):
        """Arm a fault on every dispatch, submit, step until the next
        restart (or the budget's end) -> (rids, the EngineDeadError)."""
        r0 = sup.restarts
        with faults.plane() as fp:
            fp.inject("step_dispatch", RuntimeError(FAULT_TEXT))
            rids = [sup.submit(p, max_new_tokens=n)
                    for p, n in zip(subs, new)]
            for _ in range(3 * (sup.engine.max_consecutive_faults + 1)):
                try:
                    sup.step()
                except EngineDeadError as e:
                    return rids, e
                if sup.restarts > r0:
                    return rids, None
        bad.append(f"no restart after {len(subs)} submissions")
        return rids, None

    sup.submit(filler[0], max_new_tokens=FAULT_FILLER[1])
    count(sup.run_to_completion)
    gc.collect()
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    g0 = {k: (n, c) for k, (_, n, c) in graph_state().items()}
    sup_res = {}
    # restart 1: 8 fillers feed two quarantines, the serve's first wave the
    # escalation; its last 3 requests are still queued
    rids, _ = until_restart(filler[:8] + prompts, fill_new[:8] + news)
    serve_rids = rids[8:]
    moved = [r.rid for r in sup.engine._queue]
    sup_res["transplanted_rids"] = moved
    if sup.restarts != 1 or moved != serve_rids[FAULT_BATCH:]:
        bad.append(f"restart 1: restarts {sup.restarts}, queue {moved}, "
                   f"want {serve_rids[FAULT_BATCH:]}")
    done, _ = count(sup.run_to_completion)
    by = {r.rid: r for r in done}
    reqs = [by.get(r) for r in serve_rids]
    bad += outcome_problems(reqs, news, wave1)
    bad += [f"filler {i}: {by[r].status}" for i, r in enumerate(rids[:8])
            if r not in by or by[r].status != "error"]
    for k in (2, 3):
        until_restart(filler[:12], fill_new[:12])
        sup.submit(filler[12], max_new_tokens=FAULT_FILLER[1])
        done, _ = count(sup.run_to_completion)
        if sup.restarts != k or done[-1].status != "ok":
            bad.append(f"restart {k}: restarts {sup.restarts}, the next "
                       f"request {done[-1].status}")
    gc.collect()
    torch.cuda.synchronize()
    mem1 = torch.cuda.memory_allocated()
    g1 = {k: (n, c) for k, (_, n, c) in graph_state().items()}
    captures = sum(c and not g0.get(k, (0, False))[1]
                   for k, (_, c) in g1.items())
    replays = sum(n - g0.get(k, (0, False))[0] for k, (n, _) in g1.items())
    bad += drain_problems(sup.engine, cache)
    _, dead = until_restart(filler[:12], fill_new[:12])
    sup_res.update(restarts=sup.restarts, state=sup.state,
                   engine_restarts_registry=sup.engine.metrics
                   .engine_restarts.value,
                   memory_allocated_before=mem0, memory_allocated_after=mem1,
                   memory_delta=mem1 - mem0, captures_over_restarts=captures,
                   replays_over_restarts=replays,
                   dead_error=str(dead) if dead else None)
    if abs(mem1 - mem0) > FAULT_MEM_LIMIT:
        bad.append(f"memory_allocated moved {mem1 - mem0} bytes over three "
                   f"restarts (limit {FAULT_MEM_LIMIT})")
    if captures or replays <= 0:
        bad.append(f"restarts captured {captures} graphs, replayed "
                   f"{replays}")
    if dead is None or sup.state != "DEAD" or FAULT_TEXT not in str(dead):
        bad.append(f"the budget's end gave {dead!r}, state {sup.state}")
    if sup_res["engine_restarts_registry"] != 3:
        bad.append(f"registry restarts {sup_res['engine_restarts_registry']}")
    _release_engine_claims(sup.engine)
    if not bad:
        more, sup_res["logit_max_abs_diff"], \
            sup_res["served_token_max_gap"] = survivors(
                list(range(FAULT_BATCH, len(prompts))),
                [r.generated for r in reqs[FAULT_BATCH:]])
        bad += more
    emit(phase, sub="supervisor", **sup_res, problems=bad)
    problems["supervisor"] = bad
    del sup

    # 5: the HTTP front over a supervisor
    bad = []
    reg = MetricsRegistry()

    def http_factory():
        return ContinuousBatchingEngine(cfg, params, cache, overlap=True,
                                        max_consecutive_faults=1,
                                        metrics_registry=reg)

    srv = GenerationServer(engine_factory=http_factory, max_restarts=1,
                           restart_backoff_s=0.0)
    eng, has_work = srv.engine, srv.engine.has_work

    def gated():                     # the first wave is the first 4
        if len(eng._queue) < len(prompts):
            return False
        eng.has_work = has_work
        return has_work()

    eng.has_work = gated
    url = f"http://127.0.0.1:{srv.start()}"
    replies = {}

    def client(i):
        try:
            replies[i] = (200, generate_http(url, prompts[i], news[i],
                                             timeout=600))
        except urllib.error.HTTPError as e:
            replies[i] = (e.code, e.read().decode())
        except Exception as e:
            replies[i] = (None, f"{type(e).__name__}: {e}")

    def get(path):
        with urllib.request.urlopen(url + path, timeout=60) as r:
            return r.read()

    def post(prompt, new):
        try:
            generate_http(url, prompt, new, timeout=60)
            return 200, ""
        except urllib.error.HTTPError as e:
            return e.code, e.read().decode()

    http_res = {}
    try:
        with faults.plane() as fp:
            fp.inject("step_dispatch", RuntimeError(FAULT_TEXT), nth=3)

            def serve_all():
                threads = []
                for i in range(len(prompts)):
                    t = threading.Thread(target=client, args=(i,),
                                         daemon=True)
                    t.start()
                    threads.append(t)
                    t0 = time.perf_counter()
                    while srv.engine._next_rid <= i and \
                            time.perf_counter() - t0 < 60:
                        time.sleep(0.001)
                for t in threads:
                    t.join(timeout=600)

            count(serve_all)
        health = json.loads(get("/health"))
        m = prom_samples(get("/metrics").decode())
        codes = [replies.get(i, (None,))[0] for i in range(len(prompts))]
        http_res.update(codes=codes, health_step_faults=health["step_faults"],
                        metrics_requests_faulted=m.get(
                            "paddle_tpu_engine_requests_faulted_total"),
                        engine_requests_faulted=srv.engine.requests_faulted)
        want = [500] * FAULT_BATCH + [200] * (len(prompts) - FAULT_BATCH)
        if codes != want:
            bad.append(f"codes {codes}, want {want}")
        for i in range(FAULT_BATCH):
            if FAULT_TEXT not in str(replies.get(i, (0, ""))[1]):
                bad.append(f"reply {i} lacks the fault's text: "
                           f"{replies.get(i)}")
        if health["step_faults"] != 1 or \
                http_res["metrics_requests_faulted"] != \
                srv.engine.requests_faulted or \
                srv.engine.requests_faulted != FAULT_BATCH:
            bad.append(f"health / metrics: {http_res}")
        # an armed stream_write: the client vanishes mid-stream
        c0 = srv.engine.requests_cancelled
        with faults.plane() as fp:
            fp.inject("stream_write", BrokenPipeError(FAULT_TEXT), nth=3)
            try:
                got = list(generate_http_stream(url, prompts[0], 128,
                                                timeout=120))
                if len(got) >= 128:
                    bad.append("the cut stream delivered every token")
            except Exception:
                pass                       # a cut on the client side
            t0 = time.perf_counter()
            while srv.engine.requests_cancelled < c0 + 1 and \
                    time.perf_counter() - t0 < 60:
                time.sleep(0.01)
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < 60:
            with srv._lock:
                if not srv.engine.has_work():
                    break
            time.sleep(0.01)
        with srv._lock:
            http_res["cancelled"] = srv.engine.requests_cancelled - c0
            http_res["free_pages_after_cancel"] = cache.free_pages()
            if http_res["cancelled"] != 1:
                bad.append(f"stream_write cancelled "
                           f"{http_res['cancelled']} requests")
            bad += drain_problems(srv.engine, cache)
        # a fault on every dispatch: quarantine, restart, quarantine, dead
        with faults.plane() as fp:
            fp.inject("step_dispatch", RuntimeError(FAULT_TEXT))
            queues = [srv.submit(p, FAULT_FILLER[1])[1] for p in filler]
            outs = []
            for q in queues:
                while True:
                    kind, payload = q.get(timeout=120)
                    if kind != "tok":
                        outs.append((kind, payload))
                        break
            t0 = time.perf_counter()
            while srv._fatal is None and time.perf_counter() - t0 < 60:
                time.sleep(0.01)
        late = post(prompts[0], 4)
        http_res.update(fillers=sorted({str(o) for o in outs})[:3],
                        restarts=srv.restarts, fatal=srv._fatal,
                        late_submit=list(late))
        if not all(k == "err" and p[0] == 500 and FAULT_TEXT in p[1]
                   for k, p in outs):
            bad.append(f"fillers: {outs[:3]}")
        if srv.restarts != 1 or srv._fatal is None or late[0] != 503 or \
                FAULT_TEXT not in late[1]:
            bad.append(f"dead supervisor: restarts {srv.restarts}, fatal "
                       f"{srv._fatal!r}, late submit {late}")
    finally:
        srv.stop()
    _release_engine_claims(srv.engine)
    if not bad:
        idx = list(range(FAULT_BATCH, len(prompts)))
        more, http_res["logit_max_abs_diff"], \
            http_res["served_token_max_gap"] = survivors(
                idx, [replies[i][1] for i in idx])
        bad += more
    emit(phase, sub="http", **http_res, problems=bad)
    problems["http"] = bad

    # 6: the planted defect, a quarantine that skips one row's release
    real_quarantine = ContinuousBatchingEngine._quarantine
    skipped = []

    def leaky_quarantine(self, exc):
        release = self.cache.release_row

        def skip_once(b):
            if skipped:
                return release(b)
            skipped.append(b)

        self.cache.release_row = skip_once
        try:
            return real_quarantine(self, exc)
        finally:
            del self.cache.release_row

    eng = ContinuousBatchingEngine(cfg, params, cache)
    with patched((ContinuousBatchingEngine, "_quarantine", leaky_quarantine)):
        with faults.plane() as fp:
            fp.inject("step_dispatch", RuntimeError(FAULT_TEXT), nth=1)
            reqs, seen = fault_drive(eng, prompts[:FAULT_BATCH],
                                     [4] * FAULT_BATCH, quarantine_problems)
    planted = [p for s in seen for p in s] + drain_problems(eng, cache)
    for b in skipped:
        cache.release_row(b)
    emit(phase, sub="planted_fault",
         planted_fault="the quarantine skips one row's release",
         skipped_rows=skipped, planted_fault_problems=planted)
    del eng, cache
    gs.clear()
    failed = {k: v for k, v in problems.items() if v}
    emit(phase, model="LLaMA-7B (LlamaPretrainConfig defaults)",
         layers=cfg.num_hidden_layers, batch=FAULT_BATCH,
         requests=len(prompts), prompt_lens=SERVE_LENS, new_tokens=news,
         wall_s=time.perf_counter() - t_phase, launches=total,
         failed=sorted(failed))
    if failed:
        fail(f"{phase}: {failed}")
    if not skipped or not planted:
        fail(f"{phase}: the planted fault (a quarantine that skips one "
             f"row's release) was not caught: {planted}")
    print(f"{phase}: the planted fault was caught: {planted[0]}",
          flush=True)
    for name in ("paged_decode_attention", "flash_attention_segmented",
                 "fused_rope"):
        if total.get(name, 0) <= 0:
            fail(f"{phase}: kernel {name} was not launched")
    return total


# serve_mixed: the mixed prefill + decode tick (mixed=True) on LLaMA-7B,
# under the TPU traffic of bench.py's _serving_mixed_line (:1945-1957): a
# resident batch decodes while a wave of MIXED_PER_WAVE prompts arrives
# every MIXED_WAVE_GAP ticks (five long ones cycling through MIXED_LONG and
# one of MIXED_SHORT), MIXED_NEW new tokens plus MIXED_STAGGER for each
# place in the wave; batch 8, pages of 64, 160 pages of which a row holds 8,
# a budget of two pages.  The prompts come from np.random.RandomState(seed)
# as in bench.py (its warm-up twin from seed + 1).
MIXED_LONG, MIXED_SHORT = (192, 256, 320, 448), (16, 32)
MIXED_WAVES, MIXED_PER_WAVE, MIXED_WAVE_GAP = 4, 6, 6
MIXED_NEW, MIXED_STAGGER, MIXED_BUDGET = 48, 3, 128
MIXED_CACHE = dict(num_pages=160, pages_max=8, batch=8, page=64)
# the warm-up: two waves of the twin schedule with 8 new tokens (the second
# arrives while the first decodes, so the mixed arms tick before the timing)
MIXED_WARM_WAVES, MIXED_WARM_NEW = 2, 8
# the teacher-forced check serves the first two waves of the schedule
MIXED_CHECK_WAVES = 2
MIXED_DEVICE_REPS = 5


def mixed_schedule(cfg, seed, waves=MIXED_WAVES):
    """bench.py's make_sched: each wave MIXED_PER_WAVE - 1 long prompts,
    cycling through MIXED_LONG, then one short one."""
    r = np.random.RandomState(seed)
    out = []
    for w in range(waves):
        ps = [r.randint(1, cfg.vocab_size, (
            MIXED_LONG[(w * MIXED_PER_WAVE + j) % len(MIXED_LONG)],)).tolist()
            for j in range(MIXED_PER_WAVE - 1)]
        ps.append(r.randint(1, cfg.vocab_size,
                            (MIXED_SHORT[w % len(MIXED_SHORT)],)).tolist())
        out.append(ps)
    return out


def mixed_news(sched):
    return [MIXED_NEW + MIXED_STAGGER * j for wave in sched
            for j in range(len(wave))]


def mixed_drive(eng, sched, new=MIXED_NEW):
    """bench.py's _ab_drive: the waves submitted on schedule, one step a
    tick, each tick's host wall filed under admission (a sequential wave
    ran, or a mixed tick took fresh tokens) or quiet.  -> (admission ms,
    quiet ms, the finished requests in submission order, fresh tokens of
    each mixed tick)."""
    adm, quiet, fresh = [], [], []
    pend = list(enumerate(sched))
    rids, done = [], {}
    tick = 0
    while pend or eng.has_work():
        if pend and tick >= pend[0][0] * MIXED_WAVE_GAP:
            for j, p in enumerate(pend.pop(0)[1]):
                rids.append(eng.submit(p, max_new_tokens=new
                                       + MIXED_STAGGER * j))
        pf, mx, mt = (eng.prefill_calls, eng.mixed_prefill_tokens,
                      eng.mixed_ticks)
        t0 = time.perf_counter()
        eng.step()
        ms = (time.perf_counter() - t0) * 1e3
        if eng.mixed_ticks > mt:
            fresh.append(eng.mixed_prefill_tokens - mx)
        hit = eng.prefill_calls > pf or eng.mixed_prefill_tokens > mx
        (adm if hit else quiet).append(ms)
        done.update((r.rid, r) for r in eng.finished())
        tick += 1
        if tick > 5000:
            fail("serve_mixed: the traffic did not drain")
    return adm, quiet, [done[r] for r in rids], fresh


def pctl(xs, q):
    return float(np.percentile(xs, q)) if xs else None


def mixed_arm(torch, cfg, params, cache, mods, sched, warm, lane, mixed):
    """One arm of the A/B: an engine of ``lane`` with (``mixed``) or
    without the mixed lane over ``cache``, warmed on ``warm``, then timed
    on ``sched`` with the launch counts set to 0 just before.  On the mixed
    arm every mixed tick's host wall and K2 launches are taken, and the
    arguments of one tick of the most frequent stream bucket kept for the
    device timing.  -> (tokens per request, stats, kept arguments)."""
    from paddle_tpu_torch.models.serving_engine import (
        ContinuousBatchingEngine)
    kw = {"overlap": lane == "overlap"}
    if mixed:
        kw.update(mixed=True, mixed_token_budget=MIXED_BUDGET)
    eng = ContinuousBatchingEngine(cfg, params, cache, **kw)
    mixed_drive(eng, warm, new=MIXED_WARM_NEW)
    torch.cuda.synchronize()
    k2, tick_ms, kept = [], [], {}
    if mixed:
        step, tick = eng._step_mixed, eng._decode_mixed
        fv = mods["fv"]

        def counted(*a):
            n = fv.launches
            out = step(*a)
            k2.append(fv.launches - n)
            Tb = a[-14].shape[1]                 # p_toks [1, Tb]
            if Tb not in kept:
                kept[Tb] = [t.clone() if torch.is_tensor(t)
                            and t.numel() < 2**20 else t for t in a]
            kept.setdefault("count", {}).setdefault(Tb, 0)
            kept["count"][Tb] += 1
            return out

        def timed():
            t = time.perf_counter()
            tick()
            tick_ms.append((time.perf_counter() - t) * 1e3)

        eng._step_mixed, eng._decode_mixed = counted, timed
    c0 = dict(ticks=eng.mixed_ticks, tokens=eng.mixed_prefill_tokens,
              degraded=eng.mixed_degraded, prefill=eng.prefill_calls,
              steps=eng.decode_steps, syncs=eng.host_syncs,
              gen=eng.tokens_generated)
    graphs0 = graph_state()
    zero_counts(mods)
    t0 = time.perf_counter()
    adm, quiet, done, fresh = mixed_drive(eng, sched)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ran_launches(read_counts(mods), graphs0)
    news = mixed_news(sched)
    name = f"{lane}_{'mixed' if mixed else 'sequential'}"
    for r, n in zip(done, news):
        if r.status != "ok" or len(r.generated) != n:
            fail(f"serve_mixed: {name} request {r.rid} ended {r.status} "
                 f"with {len(r.generated)} of {n} tokens")
    if eng._inflight or eng._mixed_pref or cache.audit()["owned"]:
        fail(f"serve_mixed: {name} left dispatches, parked rows or pages")
    ticks = eng.mixed_ticks - c0["ticks"]
    piggy = eng.mixed_prefill_tokens - c0["tokens"]
    stats = dict(
        wall_s=wall, tokens=eng.tokens_generated - c0["gen"],
        decode_steps=eng.decode_steps - c0["steps"],
        host_syncs=eng.host_syncs - c0["syncs"],
        prefill_waves=eng.prefill_calls - c0["prefill"],
        admission_ticks=len(adm), quiet_ticks=len(quiet),
        decode_step_p50_during_admission_ms=pctl(adm, 50),
        decode_step_p99_during_admission_ms=pctl(adm, 99),
        decode_step_p50_quiet_ms=pctl(quiet, 50),
        decode_step_p99_quiet_ms=pctl(quiet, 99),
        launches=launches)
    if mixed:
        stats.update(
            mixed_ticks=ticks, piggybacked_prefill_tokens=piggy,
            mixed_token_budget=eng.mixed_token_budget,
            budget_utilization=round(piggy / max(ticks * MIXED_BUDGET, 1),
                                     4),
            max_fresh_tokens_a_tick=max(fresh) if fresh else 0,
            mixed_degraded_waves=eng.mixed_degraded - c0["degraded"],
            k2_launches_in_mixed_ticks=sum(k2),
            host_ms_a_mixed_tick=statistics.mean(tick_ms) if tick_ms
            else None,
            stream_buckets=kept.get("count", {}))
        if ticks <= 0 or not tick_ms:
            fail(f"serve_mixed: {name} ran no mixed tick")
        if max(fresh) > MIXED_BUDGET:
            fail(f"serve_mixed: {name} took {max(fresh)} fresh tokens in "
                 f"a tick, over the budget {MIXED_BUDGET}")
        if k2 != [cfg.num_hidden_layers] * len(k2):
            fail(f"serve_mixed: {name} launched K2 {sorted(set(k2))} times "
                 f"a mixed tick, not once a layer")
    return [r.generated for r in done], stats, kept


def mixed_tick_device_ms(torch, kept, step):
    """The device time of one mixed tick: the kept arguments of the most
    frequent stream bucket replayed MIXED_DEVICE_REPS times under a
    CUDA-only profiler (the kernels' summed durations, every kind)."""
    counts = kept.pop("count")
    Tb = max(counts, key=counts.get)
    args = kept[Tb]
    step(*args)
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(MIXED_DEVICE_REPS):
            step(*args)
        torch.cuda.synchronize()
    busy_us = sum(e.time_range.elapsed_us() for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA)
    return Tb, busy_us / 1e3 / MIXED_DEVICE_REPS


def mixed_recorded(torch, cfg, params, cache, sched, forced=None, wrap=None):
    """Serve ``sched`` on the synchronous mixed lane and record the logits
    of every token where the engine computes it: the cold waves' first
    tokens, each decode step's (the mixed ticks' decode half included) and
    each mixed tick's first tokens.  ``forced`` ({rid: tokens}) makes the
    engine emit those tokens instead of its picks: with eos None the
    schedule depends on lengths alone, so this replays the same ticks over
    the same inputs (teacher forcing).  ``wrap`` rewrites the mixed step's
    arguments (a planted fault).  -> (tokens per request, logits per
    request, [tokens, V] fp32)."""
    import paddle_tpu_torch.models.paged_decode as pd
    import paddle_tpu_torch.models.serving_engine as se
    eng = se.ContinuousBatchingEngine(cfg, params, cache, mixed=True,
                                      mixed_token_budget=MIXED_BUDGET)
    rec, ctx = {}, {"first": None, "wave": None}

    def pick(logits, temperature, generator=None, top_k=0, top_p=1.0):
        tok = torch.argmax(logits, dim=-1)
        if ctx["first"] is not None and ctx["calls"] == 1:
            rows = ctx["first"]          # the mixed tick's first tokens
        else:
            rows = [(s, r, len(r.generated)) for s, r in eng._active.items()]
        if ctx["first"] is not None:
            ctx["calls"] += 1
        for s, r, j in rows:
            rec.setdefault(r.rid, {})[j] = logits[s].float().clone()
            if forced is not None:
                tok[s] = forced[r.rid][j]
        return tok

    def pick_wave(logits, *a, **k):
        ctx["wave"] = logits.float().clone()
        return torch.argmax(logits, dim=-1)

    step, emit_first = eng._step_mixed, eng._emit_first

    def stepper(*a):
        a = list(a)
        if wrap is not None:
            a = wrap(a)
        slots = a[-3].nonzero()[:, 0].tolist()          # p_sample
        ctx["first"] = [(s, eng._mixed_pref[s]["req"], 0) for s in slots]
        ctx["calls"] = 0
        try:
            return step(*a)
        finally:
            ctx["first"] = None

    def emit(reqs, slots, toks):
        for i, r in enumerate(reqs):
            if not r.generated:
                rec.setdefault(r.rid, {})[0] = ctx["wave"][i]
                if forced is not None:
                    toks[i] = forced[r.rid][0]
        return emit_first(reqs, slots, toks)

    eng._step_mixed, eng._emit_first = stepper, emit
    with patched((pd, "_pick_token", pick), (se, "_pick_token", pick_wave)):
        _, _, done, _ = mixed_drive(eng, sched)
    if cache.audit()["owned"]:
        fail("serve_mixed: the recorded run left pages owned")
    gens = [r.generated for r in done]
    logits = [torch.stack([rec[r.rid][j] for j in range(len(r.generated))])
              for r in done]
    return gens, logits


def phase_serve_mixed(torch, cfg, seed, params, mods, kv_quant=None,
                      dev="cuda"):
    """The mixed lane against the sequential packed lane on LLaMA-7B, on the
    synchronous and overlap lanes (bf16, or int8 weights over int8 pages:
    ``params`` are then the quantized ones), under the traffic above:

    1. four timed arms over one cache, each warmed first: the decode-step
       host wall p50 / p99 while the waves arrive and when quiet (the stall
       the mixed lane exists to remove: printed, not gated), the mixed
       ticks, piggybacked tokens, budget utilization, fresh tokens a tick
       (at most the budget), K2 once a layer in every mixed tick, host ms a
       mixed tick, every request complete, the pool clean, the path's
       kernels launched;
    2. the device ms of one mixed tick (its most frequent stream bucket)
       and each lane's busy share over its mixed ticks;
    3. the first MIXED_CHECK_WAVES waves served on the synchronous mixed
       lane with every token's logits recorded where the engine computes
       it, against a plain forward of the served sequences (bf16: the
       plain dense forward, LOGIT_LIMIT, each served token within
       2 * LOGIT_LIMIT of its top logit) or against the same run replayed
       teacher-forced with every kernel replaced by its plain version
       (int8: INT8_LOGIT_LIMIT), and a planted fault (every fresh stream
       token written one slot late) beyond the limit;
    4. the share of tokens each lane serves equal to the synchronous
       sequential lane's (printed, not gated: another stream layout tiles
       K2 otherwise, so bf16 near-ties may fall the other way).
    -> the launches of the timed arms."""
    import paddle_tpu_torch.models.llama_pretrain as tlp
    import paddle_tpu_torch.models.paged_decode as pd
    from paddle_tpu_torch.models import graphed_step as gs
    from paddle_tpu_torch.models.paged_decode import PagedKVCache
    pa, fv, im = mods["pa"], mods["fv"], mods["im"]
    phase = "serve_mixed_int8" if kv_quant else "serve_mixed"
    t_phase = time.perf_counter()
    cache = PagedKVCache(cfg, kv_quant=kv_quant, device=dev, **MIXED_CACHE)
    sched = mixed_schedule(cfg, seed)
    warm = mixed_schedule(cfg, seed + 1, MIXED_WARM_WAVES)
    attn = ("paged_decode_attention_q8" if kv_quant
            else "paged_decode_attention")
    path = [attn, "flash_attention_segmented", "segment_tile_ranges"] + (
        ["int8_matmul", "int8_matmul_wave"]
        if isinstance(params["lm_head"], dict) else [])
    total, gens, arms, kept = {}, {}, {}, None
    for lane in ("sync", "overlap"):
        for mixed in (False, True):
            name = f"{lane}_{'mixed' if mixed else 'sequential'}"
            gens[name], st, k = mixed_arm(torch, cfg, params, cache, mods,
                                          sched, warm, lane, mixed)
            if mixed and kept is None:
                kept = k                  # the synchronous lane's ticks
            for key, v in st["launches"].items():
                total[key] = total.get(key, 0) + v
            for kname in path:
                if st["launches"][kname] <= 0:
                    fail(f"{phase}: {name} did not launch {kname}")
            for kname in FLAGGED:
                if st["launches"][kname]:
                    fail(f"{phase}: {name} launched {kname} with its flag "
                         f"off")
            emit(phase, arm=name, **st)
            arms[name] = st
    Tb, device_ms = mixed_tick_device_ms(
        torch, kept, pd.make_mixed_step(cfg, kv_quant=kv_quant))
    del kept
    host_ms = {lane: arms[f"{lane}_mixed"]["host_ms_a_mixed_tick"]
               for lane in ("sync", "overlap")}
    busy = {lane: device_ms / ms for lane, ms in host_ms.items()}

    check = sched[:MIXED_CHECK_WAVES]
    prompts = [p for wave in check for p in wave]
    t0 = time.perf_counter()
    served, sound = mixed_recorded(torch, cfg, params, cache, check)
    forced = dict(enumerate(served))

    def late(a):                 # fresh stream K/V written one slot late
        a[-7] = (a[-7] + 1) % cache.page
        return a

    if kv_quant is None:
        limit = LOGIT_LIMIT
        plain = [plain_logits(torch, cfg, params, p + g[:-1], dev)[
            len(p) - 1:] for p, g in zip(prompts, served)]
        gap = served_gap(torch, served, plain)
    else:
        limit = INT8_LOGIT_LIMIT
        with patched((tlp, "int8_matmul", im.int8_matmul_plain),
                     (pd, "paged_decode_attention_q8",
                      pa.paged_decode_attention_q8_plain),
                     (pd, "flash_attention_segmented",
                      lambda q, k, v, seg, causal=False:
                      fv.segmented_sdpa_plain(q, k, v, seg, causal))):
            _, plain = mixed_recorded(torch, cfg, params, cache, check,
                                      forced=forced)
        gap = None
    _, fault = mixed_recorded(torch, cfg, params, cache, check,
                              forced=forced, wrap=late)
    logit_diff = max_diff(sound, plain)
    fault_diff = max_diff(fault, plain)
    del sound, plain, fault
    check_s = time.perf_counter() - t0

    ref = gens["sync_sequential"]
    n_tok = sum(len(g) for g in ref)
    agree = {name: sum(a == b for g, r in zip(got, ref)
                       for a, b in zip(g, r)) / n_tok
             for name, got in gens.items() if name != "sync_sequential"}
    same = {name: sum(g == r for g, r in zip(got, ref))
            for name, got in gens.items() if name != "sync_sequential"}
    emit(phase, model="LLaMA-7B (LlamaPretrainConfig defaults)",
         weights="int8 (quantize_params_int8)" if kv_quant else "bf16",
         kv_pages=kv_quant or "bf16", requests=len(ref),
         traffic=dict(waves=MIXED_WAVES, per_wave=MIXED_PER_WAVE,
                      wave_gap_ticks=MIXED_WAVE_GAP, long=MIXED_LONG,
                      short=MIXED_SHORT, new=MIXED_NEW,
                      stagger=MIXED_STAGGER),
         mixed_token_budget=MIXED_BUDGET, cache=MIXED_CACHE,
         mixed_tick=dict(stream_bucket=Tb, device_ms=device_ms,
                         host_ms=host_ms, busy_share=busy),
         stall_p99_ms={name: arms[name][
             "decode_step_p99_during_admission_ms"] for name in arms},
         token_share_equal_to_sync_sequential=agree,
         requests_equal_to_sync_sequential=same,
         checked_requests=len(prompts), logit_check_s=check_s,
         logit_max_abs_diff=logit_diff, logit_limit=limit,
         planted_fault_max_abs_diff=fault_diff,
         served_token_max_gap=gap,
         phase_s=time.perf_counter() - t_phase)
    if logit_diff > limit:
        fail(f"{phase}: the mixed lane's logits differ from the reference's "
             f"by {logit_diff} (limit {limit})")
    if fault_diff <= limit:
        fail(f"{phase}: the planted fault moved the logits by only "
             f"{fault_diff}, within the limit {limit}: the check cannot "
             f"see it")
    if gap is not None and gap > 2 * LOGIT_LIMIT:
        fail(f"{phase}: a served token sits {gap} below the plain top "
             f"logit (limit {2 * LOGIT_LIMIT})")
    del cache
    gs.clear()
    return total


# The speculative phases (serve_spec, serve_spec_int8): bench.py's
# _spec_ab_line recipe on LLaMA-7B at full width and depth.  Stems of
# SPEC_STEM tokens from np.random.RandomState(7); each is extended with the
# target's own greedy continuation up to where it enters a cycle (a period
# of at most 24 tokens seen three times at the end of SPEC_SCAN_NEW tokens,
# entered by position SPEC_MAX_START), so the timed decode repeats itself:
# prompt lookup's design case.  Without SPEC_MIN_CYCLES such stems the
# random stems serve instead, as bench.py falls back.  SPEC_REQUESTS
# requests (the prompts in turn) of SPEC_NEW tokens in one wave of batch 8,
# pages of 64.  The verify's logits are held to LOGIT_LIMIT (int8:
# INT8_LOGIT_LIMIT): on an H100 at seeds 0, 1 and 2 the sound difference
# was 0.240, 0.234 and 0.227 (int8 0.197, 0.180, 0.176) and the planted
# fault's 4.71, 4.04 and 4.03 (int8 3.93, 4.30, 4.50).
SPEC_BANK, SPEC_STEM, SPEC_SCAN_NEW, SPEC_MAX_START = 16, 12, 150, 70
SPEC_MAX_PROMPTS, SPEC_MIN_CYCLES = 5, 2
SPEC_REQUESTS, SPEC_NEW, SPEC_WARM_NEW = 8, 64, 8
SPEC_GAMMA, SPEC_LOOKUP_GAMMA = 4, 7
SPEC_DRAFT_LAYERS, SPEC_DRAFT_SEED = 2, 1
SPEC_CACHE = dict(num_pages=72, pages_max=8, batch=8, page=64)
SPEC_SCAN_CACHE = dict(num_pages=48, pages_max=3, batch=8, page=64)
SPEC_DEVICE_REPS = 5


def spec_workload(cfg, params, dev):
    """bench.py's repetitive-continuation prompts: the stem bank's greedy
    continuations, served batched through the plain engine on the overlap
    lane.  -> (prompts, cycle periods, whether the random stems serve)."""
    from paddle_tpu_torch.models.paged_decode import PagedKVCache
    from paddle_tpu_torch.models.serving_engine import (
        ContinuousBatchingEngine)
    rng = np.random.RandomState(7)
    bank = [rng.randint(1, cfg.vocab_size, (SPEC_STEM,))
            for _ in range(SPEC_BANK)]
    cache = PagedKVCache(cfg, device=dev, **SPEC_SCAN_CACHE)
    eng = ContinuousBatchingEngine(cfg, params, cache, overlap=True)
    rids = [eng.submit(s, max_new_tokens=SPEC_SCAN_NEW) for s in bank]
    outs = {r.rid: [int(t) for t in r.generated]
            for r in eng.run_to_completion()}
    prompts, periods = [], []
    for rid, stem in zip(rids, bank):
        out = outs[rid]
        per = next((T for T in range(1, 25)
                    if out[-3 * T:-2 * T] == out[-2 * T:-T] == out[-T:]),
                   None)
        if per is None:
            continue
        s = len(out) - per
        while s > 0 and out[s - 1] == out[s - 1 + per]:
            s -= 1
        if s > SPEC_MAX_START:
            continue                     # the cycle starts too late
        prompts.append(np.concatenate([stem, np.asarray(
            out[:s + 2 * per], np.int64)]))
        periods.append(per)
        if len(prompts) >= SPEC_MAX_PROMPTS:
            break
    degenerate = len(prompts) < SPEC_MIN_CYCLES
    if degenerate:
        prompts = bank[:SPEC_MAX_PROMPTS]
    return [p.tolist() for p in prompts], periods, degenerate


def spec_serve(torch, eng, reqs, new, spec_on, no_sync=False):
    """Submit ``reqs`` and step to the end (with ``no_sync``, every step
    after the first, the admission's, under set_sync_debug_mode("error"),
    ``_fetch`` excepted) -> the finished requests in submission order."""
    rids = [eng.submit(p, max_new_tokens=new, spec=True if spec_on else None)
            for p in reqs]
    done = {}
    eng.step()
    done.update((r.rid, r) for r in eng.finished())
    fetch = eng._fetch
    if no_sync:
        def fetch_allowed(*a):          # the one sanctioned sync point
            torch.cuda.set_sync_debug_mode(0)
            try:
                return fetch(*a)
            finally:
                torch.cuda.set_sync_debug_mode("error")
        eng._fetch = fetch_allowed
        torch.cuda.set_sync_debug_mode("error")
    try:
        steps = 0
        while eng.has_work():
            eng.step()
            done.update((r.rid, r) for r in eng.finished())
            steps += 1
            if steps > 10_000:
                fail("serve_spec: the requests did not drain")
    finally:
        if no_sync:
            torch.cuda.set_sync_debug_mode(0)
            eng._fetch = fetch
    return [done[r] for r in rids]


def spec_arm(torch, cfg, params, cache, mods, reqs, name, spec=None,
             overlap=False):
    """One timed arm: an engine over ``cache`` (``spec`` None: the plain
    synchronous lane), warmed on the same requests at SPEC_WARM_NEW tokens,
    then timed on SPEC_NEW with the launch counts set to 0 just before.
    The rounds' host walls are taken; on the synchronous spec lane each
    round's K1 / K4 launches and each spec-on admission's K5 launches too,
    and one steady round's arguments are kept for the device timing.
    -> (tokens per request, stats, kept arguments)."""
    from paddle_tpu_torch.models.serving_engine import (
        ContinuousBatchingEngine)
    pa, rp = mods["pa"], mods["rp"]
    eng = ContinuousBatchingEngine(cfg, params, cache, spec=spec,
                                   overlap=overlap)
    spec_on = spec is not None
    spec_serve(torch, eng, reqs, SPEC_WARM_NEW, spec_on)
    torch.cuda.synchronize()
    attr = "launches_q8" if cache.kv_quant else "launches"
    round_ms, k1, k5, kept = [], [], [], []
    decode = eng._decode_once

    def timed():
        t = time.perf_counter()
        decode()
        round_ms.append((time.perf_counter() - t) * 1e3)

    eng._decode_once = timed
    if spec_on and not overlap:          # gamma is fixed: one step fn
        step, admit = eng._spec_fused(), eng._spec_admit

        def counted(*a):
            n = getattr(pa, attr)
            out = step(*a)
            k1.append(getattr(pa, attr) - n)
            if len(k1) == 3:           # a steady round, for the device
                kept.extend(t.clone() if torch.is_tensor(t)
                            and t.numel() < 2**20 else t for t in a)
            return out

        def admit_counted(*a):
            n = rp.launches
            admit(*a)
            k5.append(rp.launches - n)

        eng._spec_fused = lambda: counted
        eng._spec_admit = admit_counted
    c0 = dict(steps=eng.decode_steps, syncs=eng.host_syncs,
              flushes=eng.pipeline_flushes,
              rounds=getattr(eng, "spec_rounds", 0),
              drafted=getattr(eng, "spec_drafted", 0),
              accepted=getattr(eng, "spec_accepted", 0))
    graphs0 = graph_state()
    zero_counts(mods)
    t0 = time.perf_counter()
    done = spec_serve(torch, eng, reqs, SPEC_NEW, spec_on,
                      no_sync=overlap)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ran_launches(read_counts(mods), graphs0)
    captured = sum(1 for key, (g, _, was) in graph_state().items()
                   if g.graph is not None and not (key in graphs0
                                                   and graphs0[key][2]))
    for r in done:
        if r.status != "ok" or len(r.generated) != SPEC_NEW:
            fail(f"serve_spec: {name} request {r.rid} ended {r.status} with "
                 f"{len(r.generated)} of {SPEC_NEW} tokens")
    if eng._inflight:
        fail(f"serve_spec: {name} left dispatches in flight")
    steps = eng.decode_steps - c0["steps"]
    dec = sum(len(r.generated) - 1 for r in done)
    ttft = [(r.t_first_token - r.t_submit) * 1e3 for r in done]
    tpot = [(r.t_finish - r.t_first_token) * 1e3 / (len(r.generated) - 1)
            for r in done]
    stats = dict(
        lane="overlap" if overlap else "sync", wall_s=wall,
        decode_tok_per_s=sum(len(r.generated) for r in done) / wall,
        ttft_p50_ms=pctl(ttft, 50), ttft_p99_ms=pctl(ttft, 99),
        tpot_p50_ms=pctl(tpot, 50), tpot_p99_ms=pctl(tpot, 99),
        decode_dispatches=steps, dispatches_per_token=steps / max(dec, 1),
        host_syncs=eng.host_syncs - c0["syncs"],
        pipeline_flushes=eng.pipeline_flushes - c0["flushes"],
        host_ms_a_round=statistics.mean(round_ms),
        host_ms_a_round_p50=pctl(round_ms, 50), launches=launches,
        captures_in_timed_run=captured)
    if spec_on:
        drafted = eng.spec_drafted - c0["drafted"]
        accepted = eng.spec_accepted - c0["accepted"]
        stats.update(gamma=eng.gamma,
                     spec_rounds=eng.spec_rounds - c0["rounds"],
                     drafted_tokens=drafted, accepted_tokens=accepted,
                     acceptance_rate=accepted / max(drafted, 1),
                     tokens_a_round_a_request=dec / max(steps * len(done),
                                                        1))
    if k1:
        stats.update(k1_launches_a_round=sorted(set(k1)),
                     k5_launches_an_admission=sorted(set(k5)))
    return [r.generated for r in done], stats, kept, eng


def spec_recorded(torch, cfg, params, cache, dcache, reqs, forced=None,
                  late=False):
    """Serve ``reqs`` on the synchronous spec lane (draft == target, gamma
    SPEC_GAMMA) and record the verify's logits of every committed token
    where the round computes them: a row's candidate j predicts its
    generated token len + j, and the round that commits a token writes its
    entry last.  ``forced`` ({rid: tokens}) makes the verify pick those
    tokens instead of its argmax (the accept fold then commits them): with
    eos None the served sequences replay over the same contexts (teacher
    forcing).  ``late`` scatters every fresh K/V one slot late (a planted
    fault).  -> (tokens per request, [len - 1, V] fp32 logits per request
    of its tokens 1.., recorded)."""
    import paddle_tpu_torch.models.paged_decode as pd
    from paddle_tpu_torch.models.serving_engine import (
        ContinuousBatchingEngine, SpecConfig)
    spec = SpecConfig(gamma=SPEC_GAMMA, draft_cfg=cfg, draft_params=params,
                      draft_cache=dcache)
    eng = ContinuousBatchingEngine(cfg, params, cache, spec=spec)
    real_pick, real_dest = pd._pick_token, pd._spec_dest
    rec = {}
    first_of = eng._emit_first

    def pick(logits, temperature, generator=None, top_k=0, top_p=1.0):
        tok = real_pick(logits, temperature, generator, top_k, top_p)
        if logits.dim() != 3:            # a draft micro-step
            return tok
        for s, r in eng._active.items():
            n = len(r.generated)
            for j in range(logits.shape[1]):
                if n + j < SPEC_NEW:
                    rec.setdefault(r.rid, {})[n + j] = logits[s, j].clone()
                    if forced is not None:
                        tok[s, j] = forced[r.rid][n + j]
        return tok

    def emit_first(rs, slots, toks):
        if forced is not None:
            for i, r in enumerate(rs):
                toks[i] = forced[r.rid][0]
        return first_of(rs, slots, toks)

    def dest(*a):
        page, slot = real_dest(*a)
        return page, (slot + 1) % a[-1]

    eng._emit_first = emit_first
    seams = [(pd, "_pick_token", pick)] + ([(pd, "_spec_dest", dest)]
                                           if late else [])
    with patched(*seams):
        done = spec_serve(torch, eng, reqs, SPEC_NEW, True)
    if cache.audit()["owned"] or dcache.audit()["owned"]:
        fail("serve_spec: the recorded run left pages owned")
    gens = [r.generated for r in done]
    logits = [torch.stack([rec[r.rid][j] for j in range(1, SPEC_NEW)])
              for r in done]
    return gens, logits


def spec_round_device_ms(torch, launch):
    """The device time of one round: ``launch()`` run SPEC_DEVICE_REPS
    times under a CUDA-only profiler (the kernels' summed durations, every
    kind)."""
    launch()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(SPEC_DEVICE_REPS):
            launch()
        torch.cuda.synchronize()
    busy_us = sum(e.time_range.elapsed_us() for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA)
    return busy_us / 1e3 / SPEC_DEVICE_REPS


def phase_serve_spec(torch, cfg, seed, params, mods, kv_quant=None,
                     dev="cuda"):
    """Speculative decoding (``spec=SpecConfig(...)``) on LLaMA-7B against
    the plain synchronous lane (H = 1), bf16, or int8 weights over int8
    target and draft pages (``params`` are then the quantized ones), on
    bench.py's repetitive-continuation workload above, five arms over the
    same requests in one process:

    1. ``h1``: the plain synchronous lane;
    2. ``spec_same_sync``: the target drafting for itself (acceptance near
       1: the ceiling), gamma SPEC_GAMMA, synchronous (eager rounds);
    3. ``spec_same_overlap``: the same on the overlap lane (rounds replayed
       from a CUDA graph), its steady state under
       set_sync_debug_mode("error") (``_fetch`` excepted);
    4. ``spec_draft2_sync``: a SPEC_DRAFT_LAYERS-layer draft at LLaMA-7B's
       widths from seed SPEC_DRAFT_SEED (acceptance near 0: the partial
       accept and catch-up paths), synchronous;
    5. ``spec_lookup_sync``: prompt lookup, gamma SPEC_LOOKUP_GAMMA.

    A line an arm (printed, not gated): decode tok/s, TTFT and TPOT p50 /
    p99, dispatches a token, acceptance, host ms a round, and on the spec
    arms the device ms of one round and the busy share.  Checks: every
    request complete, the overlap arm's tokens equal to the synchronous
    spec arm's, K1 (K4) (gamma + 1) x draft layers a synchronous round and
    K5 2 x draft layers a spec-on admission, one capture in the phase (one
    gamma) and none in a timed run, both caches clean; then the verify's
    logits recorded along the served schedule, teacher-forced (bf16:
    within LOGIT_LIMIT of the plain dense forward, every served token
    within 2 * LOGIT_LIMIT of its top logit; int8: within INT8_LOGIT_LIMIT
    of the same run with every kernel replaced by its plain version), and
    a planted fault (every fresh K/V scattered one slot late) beyond the
    limit.  -> the launches of the timed arms."""
    import paddle_tpu_torch.models.llama_pretrain as tlp
    import paddle_tpu_torch.models.paged_decode as pd
    from paddle_tpu_torch.models import graphed_step as gs
    from paddle_tpu_torch.models.decode import quantize_params_int8
    from paddle_tpu_torch.models.llama_pretrain import init_params
    from paddle_tpu_torch.models.paged_decode import PagedKVCache
    from paddle_tpu_torch.models.serving_engine import SpecConfig
    pa, fv, im = mods["pa"], mods["fv"], mods["im"]
    phase = "serve_spec_int8" if kv_quant else "serve_spec"
    t_phase = time.perf_counter()
    prompts, periods, degenerate = spec_workload(cfg, params, dev)
    reqs = [prompts[i % len(prompts)] for i in range(SPEC_REQUESTS)]
    emit(phase, workload=("random stems (no early greedy cycle: bench.py's "
                          "fallback)" if degenerate else
                          f"repetitive continuation x{len(prompts)}"),
         cycle_periods=periods, prompt_lens=[len(p) for p in prompts],
         scan_s=time.perf_counter() - t_phase)
    gs.clear()
    cache = PagedKVCache(cfg, kv_quant=kv_quant, device=dev, **SPEC_CACHE)
    dcache = PagedKVCache(cfg, kv_quant=kv_quant, device=dev, **SPEC_CACHE)
    dcfg = dataclasses.replace(cfg, num_hidden_layers=SPEC_DRAFT_LAYERS)
    dparams = init_params(dcfg, SPEC_DRAFT_SEED, dev)
    if kv_quant:
        dparams = quantize_params_int8(dparams)
    dcache2 = PagedKVCache(dcfg, kv_quant=kv_quant, device=dev, **SPEC_CACHE)
    same = SpecConfig(gamma=SPEC_GAMMA, draft_cfg=cfg, draft_params=params,
                      draft_cache=dcache)
    arms_cfg = [
        ("h1", None, False, None),
        ("spec_same_sync", same, False, cfg),
        ("spec_same_overlap", same, True, cfg),
        ("spec_draft2_sync", SpecConfig(
            gamma=SPEC_GAMMA, draft_cfg=dcfg, draft_params=dparams,
            draft_cache=dcache2), False, dcfg),
        ("spec_lookup_sync", SpecConfig(gamma=SPEC_LOOKUP_GAMMA,
                                        source="prompt_lookup"), False,
         None)]
    attn = ("paged_decode_attention_q8" if kv_quant
            else "paged_decode_attention")
    path = {"h1": [attn], "spec_draft2_sync": [attn, "fused_rope"],
            "spec_same_sync": [attn, "fused_rope"],
            "spec_same_overlap": [attn, "fused_rope"],
            "spec_lookup_sync": []}
    if isinstance(params["lm_head"], dict):
        for k in path:
            path[k] += ["int8_matmul", "int8_matmul_wave"]
    total, gens, arms, kept = {}, {}, {}, {}
    for name, spec, overlap, draft_cfg in arms_cfg:
        gens[name], st, kept[name], eng = spec_arm(
            torch, cfg, params, cache, mods, reqs, name, spec, overlap)
        for key, v in st["launches"].items():
            total[key] = total.get(key, 0) + v
        for kname in path[name]:
            if st["launches"][kname] <= 0:
                fail(f"{phase}: {name} did not launch {kname}")
        for kname in FLAGGED:
            if st["launches"][kname]:
                fail(f"{phase}: {name} launched {kname} with its flag off")
        if st["captures_in_timed_run"]:
            fail(f"{phase}: {name} captured {st['captures_in_timed_run']} "
                 f"graphs after its warm-up")
        if draft_cfg is not None and not overlap:
            L = draft_cfg.num_hidden_layers
            if st["k1_launches_a_round"] != [(SPEC_GAMMA + 1) * L]:
                fail(f"{phase}: {name} launched {attn} "
                     f"{st['k1_launches_a_round']} times a round, not "
                     f"(gamma + 1) x {L}")
            if st["k5_launches_an_admission"] != [2 * L]:
                fail(f"{phase}: {name} launched fused_rope "
                     f"{st['k5_launches_an_admission']} times a spec-on "
                     f"admission, not 2 x {L}")
        if spec is not None and not overlap:
            fused = eng._spec_fused()
            args = kept[name]
            st["device_ms_a_round"] = spec_round_device_ms(
                torch, lambda: fused(*args))
            st["busy_share"] = st["device_ms_a_round"] / st[
                "host_ms_a_round"]
        if name == "spec_same_overlap":
            # the captured round replayed from the synchronous arm's kept
            # state (chained from there)
            g = eng._spec_graph()
            names = ("tables", "dtables", "lens", "tok", "prev", "active",
                     "remaining", "spec_on", "eos")
            for nm, t in zip(names, kept["spec_same_sync"][-9:]):
                getattr(g.state, nm).copy_(t)
            st["device_ms_a_round"] = spec_round_device_ms(
                torch, lambda: g(eng.params, eng._spec_dparams, eng._pools(),
                                 eng._dpools()))
            st["busy_share"] = st["device_ms_a_round"] / st[
                "host_ms_a_round"]
            st["captured_gammas"] = sorted(
                g.gamma for g in gs.graphs()
                if isinstance(g, gs.SpecGraph) and g.graph is not None)
        st.pop("launches")
        emit(phase, arm=name, **st)
        arms[name] = st
    for c in (cache, dcache, dcache2):
        if c.audit()["owned"]:
            fail(f"{phase}: an arm left pages owned")
    captured = arms["spec_same_overlap"]["captured_gammas"]
    if captured != [SPEC_GAMMA]:
        fail(f"{phase}: the overlap arm captured gammas {captured}, not one "
             f"graph for gamma {SPEC_GAMMA}")
    if gens["spec_same_overlap"] != gens["spec_same_sync"]:
        i = next(i for i, (a, b) in enumerate(zip(
            gens["spec_same_overlap"], gens["spec_same_sync"])) if a != b)
        fail(f"{phase}: the overlap spec lane served request {i} "
             f"differently from the synchronous spec lane")
    kept.clear()

    t0 = time.perf_counter()
    served, sound = spec_recorded(torch, cfg, params, cache, dcache, reqs)
    forced = dict(enumerate(served))
    if kv_quant is None:
        limit = LOGIT_LIMIT
        plain = [plain_logits(torch, cfg, params, p + g[:-1], dev)[len(p):]
                 for p, g in zip(reqs, served)]
        gap = served_gap(torch, [g[1:] for g in served], plain)
    else:
        limit = INT8_LOGIT_LIMIT
        with patched((tlp, "int8_matmul", im.int8_matmul_plain),
                     (pd, "paged_decode_attention_q8",
                      pa.paged_decode_attention_q8_plain),
                     (pd, "flash_attention_segmented",
                      lambda q, k, v, seg, causal=False:
                      fv.segmented_sdpa_plain(q, k, v, seg, causal))):
            _, plain = spec_recorded(torch, cfg, params, cache, dcache, reqs,
                                     forced=forced)
        gap = None
    _, fault = spec_recorded(torch, cfg, params, cache, dcache, reqs,
                             forced=forced, late=True)
    logit_diff = max_diff(sound, plain)
    fault_diff = max_diff(fault, plain)
    del sound, plain, fault
    check_s = time.perf_counter() - t0

    ref = gens["h1"]
    n_tok = sum(len(g) for g in ref)
    agree = {name: sum(a == b for g, r in zip(got, ref)
                       for a, b in zip(g, r)) / n_tok
             for name, got in gens.items() if name != "h1"}
    emit(phase, model="LLaMA-7B (LlamaPretrainConfig defaults)",
         weights="int8 (quantize_params_int8)" if kv_quant else "bf16",
         kv_pages=kv_quant or "bf16", requests=len(reqs), new=SPEC_NEW,
         gamma=SPEC_GAMMA, lookup_gamma=SPEC_LOOKUP_GAMMA,
         draft2=dict(layers=SPEC_DRAFT_LAYERS, seed=SPEC_DRAFT_SEED),
         cache=SPEC_CACHE,
         token_share_equal_to_h1=agree,
         overlap_equal_to_sync_spec=True,
         logit_check_s=check_s, logit_max_abs_diff=logit_diff,
         logit_limit=limit, planted_fault_max_abs_diff=fault_diff,
         served_token_max_gap=gap, phase_s=time.perf_counter() - t_phase)
    if logit_diff > limit:
        fail(f"{phase}: the verify's logits differ from the reference's by "
             f"{logit_diff} (limit {limit})")
    if fault_diff <= limit:
        fail(f"{phase}: the planted fault moved the logits by only "
             f"{fault_diff}, within the limit {limit}: the check cannot see "
             f"it")
    if gap is not None and gap > 2 * LOGIT_LIMIT:
        fail(f"{phase}: a served token sits {gap} below the plain top logit "
             f"(limit {2 * LOGIT_LIMIT})")
    del cache, dcache, dcache2, dparams
    gs.clear()
    return total


# serve_swap: bench.py's _preemption_line TPU recipe (bench.py:680-690) at
# LLaMA-7B: 6 requests of 256 prompt tokens, 192 new, batch 4, 18 pages of
# 64 (a request ends at 7 pages: the pool holds two at their end),
# pages_max 8, a host tier of 64 pages
SWAP_REQUESTS, SWAP_PROMPT, SWAP_NEW = 6, 256, 192
SWAP_CACHE = dict(num_pages=18, pages_max=8, batch=4, page=64)
SWAP_HOST_PAGES = 64
# the warm-up (5 requests) and the teacher-forced check runs: 72 new tokens
# still preempt at the first page of growth and resume swapped rows with
# tokens left to decode
SWAP_SHORT_NEW = 72
# the promotion arm: the filler's (prompt, new) requests, one wave of 17
# pages that never grows, so the whole 7-page prefix demotes at its
# admission
SWAP_FILLER = [(300, 20), (300, 20), (300, 20), (100, 20)]
SWAP_PREFIX_TAILS = (16, 40)
SWAP_VICTIM_PAGES = 6               # the micro measurements' victim
SWAP_BUSY_REPLAYS = 8
SWAP_KERNELS = ("paged_decode_attention", "paged_decode_attention_q8",
                "flash_attention_segmented", "fused_rope", "int8_matmul",
                "int8_matmul_wave")


def bits(torch, t):
    """``t`` as integers of its width, for bit-for-bit comparisons."""
    return t.view({torch.bfloat16: torch.int16, torch.float16: torch.int16,
                   torch.float32: torch.int32}.get(t.dtype, t.dtype))


def page_blocks(torch, cache, pids):
    """The pool tensors' pages ``pids``, page-major (K, V and, on int8
    pools, their scales), gathered with no host sync (the overlap arm
    snapshots its victims under set_sync_debug_mode("error"))."""
    idx = cache._ids(pids)
    return [p.transpose(0, 1).index_select(0, idx)
            for p in (cache.kpool, cache.vpool, cache.kscale, cache.vscale)
            if p is not None]


def swap_watch(torch, eng, cache, mods):
    """Wrap ``cache``'s swap_out_row / swap_in_row and ``eng``'s
    _admit_swapped: each swap-out snapshots the victim's private pages
    before it runs; each swap-in compares the restored pages with the
    snapshot, bit for bit, on the device (no host sync: the flags are read
    at the end); each swapped resume must dispatch no prefill and launch
    no K2 or K5.  -> the state the checks read."""
    st = {"equal": [], "pages": 0, "snap": {}, "prefill": [], "refused": []}
    out_row, in_row, admit = (cache.swap_out_row, cache.swap_in_row,
                              eng._admit_swapped)

    def swap_out_row(b):
        npg = -(-int(cache.lens[b]) // cache.page)
        private = [pid for pid in cache._owned[b][:npg]
                   if cache.refs[pid] == 1]
        try:
            snap = page_blocks(torch, cache, private) if private else []
            handle = out_row(b)
        except RuntimeError as e:
            # the engine degrades a refused swap-out to recompute; with the
            # swap forced and the tier roomy, a refusal is a fault
            st["refused"].append(f"{type(e).__name__}: {e}")
            raise
        st["snap"][handle] = snap
        return handle

    def swap_in_row(b, handle):
        rec = cache._swapped[handle]["entries"]
        n = in_row(b, handle)
        snap = st["snap"].pop(handle)
        js = [j for j, (kind, _) in enumerate(rec) if kind == "host"]
        if js:
            got = page_blocks(torch, cache,
                              [int(cache.tables[b, j]) for j in js])
            for a, g in zip(snap, got):
                st["equal"].append((bits(torch, a) == bits(torch, g)).all())
            st["pages"] += len(js)
        return n

    def admit_swapped(req):
        c = (eng.prefill_calls, eng.prefill_token_slots,
             mods["fv"].launches, mods["rp"].launches)
        ok = admit(req)
        if ok and c != (eng.prefill_calls, eng.prefill_token_slots,
                        mods["fv"].launches, mods["rp"].launches):
            st["prefill"].append(req.rid)
        return ok

    cache.swap_out_row, cache.swap_in_row = swap_out_row, swap_in_row
    eng._admit_swapped = admit_swapped
    return st


def swap_clean(phase, arm, cache, indexed_ok=False):
    """After an arm: audit() clean, no swap record, the host tier empty
    (but for demoted prefixes with ``indexed_ok``), the device pool back to
    num_pages - 1 (but for cached prefix pages)."""
    stats = cache.audit()
    if stats["owned"] or stats.get("swap_records"):
        fail(f"{phase}: {arm} left {stats['owned']} pages owned and "
             f"{stats.get('swap_records')} swap records")
    cached = stats["indexed"] if indexed_ok else 0
    if cache.free_pages() != cache.num_pages - 1 - cached:
        fail(f"{phase}: {arm} left {cache.free_pages()} pages free of "
             f"{cache.num_pages - 1} ({cached} cached)")
    if cache.host is not None:
        held = cache.host.used_pages()
        if held != (stats["host_indexed"] if indexed_ok else 0):
            fail(f"{phase}: {arm} left {held} host pages in use")


def swap_arm(torch, cfg, params, mods, prompts, phase, arm, kv_quant, dev,
             host=True, overlap=False, lane_kw=None, no_sync=False):
    """One timed arm: an engine (its own registry) over a fresh cache,
    warmed on the first batch + 1 prompts at SWAP_SHORT_NEW tokens, then
    timed on every prompt at SWAP_NEW with the launch counts set to 0 just
    before.  -> (tokens per request, stats, launches, engine, cache, the
    swap watch)."""
    from paddle_tpu_torch.models.paged_decode import PagedKVCache
    from paddle_tpu_torch.models.serving_engine import (
        ContinuousBatchingEngine)
    from paddle_tpu_torch.observability import MetricsRegistry
    cache = PagedKVCache(cfg, kv_quant=kv_quant, device=dev,
                         host_pages=SWAP_HOST_PAGES if host else 0,
                         **SWAP_CACHE)
    eng = ContinuousBatchingEngine(cfg, params, cache, overlap=overlap,
                                   metrics_registry=MetricsRegistry(),
                                   **(lane_kw or {}))
    if host:
        eng.offload_swap_gbps = 1e9          # the swap always wins
    watch = swap_watch(torch, eng, cache, mods)
    warm = swap_serve(torch, eng, prompts[:cache.tables.shape[0] + 1],
                      SWAP_SHORT_NEW)
    swap_clean(phase, f"{arm} (warm-up)", cache)
    torch.cuda.synchronize()
    m = eng.metrics
    base = dict(pre=eng.preemptions, rec=eng.resumes_recompute,
                swp=eng.resumes_swapped, wall=eng.resume_wall_s,
                ev=eng.resume_events, avoided=eng.prefill_tokens_avoided,
                out=cache.swap_out_pages, inn=cache.swap_in_pages,
                byt=cache.swap_bytes, slots=eng.prefill_token_slots,
                calls=eng.prefill_calls, stage_s=m.swap_seconds.sum,
                stage_n=m.swap_seconds.count, steps=eng.decode_steps)
    graphs0 = graph_state()
    zero_counts(mods)
    t0 = time.perf_counter()
    done = swap_serve(torch, eng, prompts, SWAP_NEW, no_sync=no_sync)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ran_launches(read_counts(mods), graphs0)
    captured = sum(1 for key, (g, _, was) in graph_state().items()
                   if g.graph is not None and not (key in graphs0
                                                   and graphs0[key][2]))
    for r in done + warm:
        want = SWAP_NEW if r in done else SWAP_SHORT_NEW
        if r.status != "ok" or len(r.generated) != want:
            fail(f"{phase}: {arm} request {r.rid} ended {r.status} "
                 f"({r.error}) with {len(r.generated)} of {want} tokens")
    swap_clean(phase, arm, cache)
    # the timed run's preemptions and swapped resumes: (request index,
    # tokens generated, mode)
    index = {r.rid: i for i, r in enumerate(done)}
    log = [(index[e["rid"]], e.get("generated", e.get("tokens")),
            e.get("mode", "swap-in"))
           for e in m.ring.recent()
           if e["name"] in ("preemption", "swap_resume")
           and e.get("rid") in index]
    events = eng.resume_events - base["ev"]
    stage_n = m.swap_seconds.count - base["stage_n"]
    swapped = eng.resumes_swapped - base["swp"]
    stats = dict(
        lane="overlap" if overlap else "sync",
        admission="batched (packed=False)" if lane_kw else "packed",
        host_pages=SWAP_HOST_PAGES if host else 0, wall_s=wall,
        decode_tok_per_s=sum(len(r.generated) for r in done) / wall,
        decode_steps=eng.decode_steps - base["steps"],
        preemptions=eng.preemptions - base["pre"],
        resumes_recompute=eng.resumes_recompute - base["rec"],
        resumes_swapped=swapped,
        resume_ms_mean=(eng.resume_wall_s - base["wall"])
        / max(events, 1) * 1e3,
        swap_in_ms_mean=((eng.resume_wall_s - base["wall"]) / swapped * 1e3
                         if swapped and events == swapped else None),
        swap_out_staging_ms_mean=(
            (m.swap_seconds.sum - base["stage_s"]) / stage_n * 1e3
            if stage_n else None),
        prefill_tokens_avoided=eng.prefill_tokens_avoided
        - base["avoided"],
        swap_out_pages=cache.swap_out_pages - base["out"],
        swap_in_pages=cache.swap_in_pages - base["inn"],
        swap_bytes=cache.swap_bytes - base["byt"],
        prefill_token_slots=eng.prefill_token_slots - base["slots"],
        prefill_dispatches=eng.prefill_calls - base["calls"],
        captures_in_timed_run=captured, preemption_log=log,
        launches={k: launches[k] for k in SWAP_KERNELS})
    return [r.generated for r in done], stats, launches, eng, cache, watch


def swap_serve(torch, eng, prompts, new, no_sync=False):
    """Submit ``prompts`` and step to the end (with ``no_sync``, every step
    after the first under set_sync_debug_mode("error"), the flush points
    excepted: ``_fetch``, the admission wave, the pipeline flush).
    -> the finished requests in submission order."""
    rids = [eng.submit(p, max_new_tokens=new) for p in prompts]
    done = {}
    eng.step()
    done.update((r.rid, r) for r in eng.finished())
    saved, depth = {}, [0]
    if no_sync:
        for name in ("_fetch", "_admit_wave", "_pipeline_flush"):
            def allowed(*a, _real=getattr(eng, name)):
                # flush points nest (an admission flushes the pipeline):
                # only the outermost one turns the check back on
                depth[0] += 1
                torch.cuda.set_sync_debug_mode(0)
                try:
                    return _real(*a)
                finally:
                    depth[0] -= 1
                    if not depth[0]:
                        torch.cuda.set_sync_debug_mode("error")
            saved[name] = getattr(eng, name)
            setattr(eng, name, allowed)
        torch.cuda.set_sync_debug_mode("error")
    try:
        steps = 0
        while eng.has_work():
            eng.step()
            done.update((r.rid, r) for r in eng.finished())
            steps += 1
            if steps > 100_000:
                fail("swap_serve: the requests did not drain")
    finally:
        if no_sync:
            torch.cuda.set_sync_debug_mode(0)
            for name, real in saved.items():
                setattr(eng, name, real)
    return [done[r] for r in rids]


def swap_forced(torch, cfg, params, mods, prompts, forced, phase, kv_quant,
                dev, lane_kw, late=False):
    """A teacher-forced swapping run on the synchronous lane: ``prompts``
    at SWAP_SHORT_NEW tokens with the swap forced, every emitted token
    forced to ``forced`` ({index: tokens}), and the decode logits of every
    resumed row (a request preempted before) recorded; the round trips
    watched.  ``late`` restores every page one slot late (a planted
    fault).  -> ({index: {position: logits}}, the watch state, stats)."""
    import paddle_tpu_torch.models.paged_decode as pd
    from paddle_tpu_torch.models.paged_decode import PagedKVCache
    from paddle_tpu_torch.models.serving_engine import (
        ContinuousBatchingEngine)
    cache = PagedKVCache(cfg, kv_quant=kv_quant, device=dev,
                         host_pages=SWAP_HOST_PAGES, **SWAP_CACHE)
    eng = ContinuousBatchingEngine(cfg, params, cache, **lane_kw)
    eng.offload_swap_gbps = 1e9
    watch = swap_watch(torch, eng, cache, mods)
    rec = {}
    first = eng._next_rid            # the rids of ``prompts``, in order
    real_pick, emit_first = pd._pick_token, eng._emit_first

    def pick(logits, temperature, generator=None, top_k=0, top_p=1.0):
        tok = real_pick(logits, temperature, generator, top_k, top_p)
        for s, r in eng._active.items():
            n = len(r.generated)
            if r.preempted:
                rec.setdefault(r.rid - first, {})[n] = \
                    logits[s].float().clone()
            tok[s] = forced[r.rid - first][n]
        return tok

    def emit(reqs, slots, toks):
        for i, r in enumerate(reqs):
            if not r.generated:
                toks[i] = forced[r.rid - first][0]
        return emit_first(reqs, slots, toks)

    eng._emit_first = emit
    restore = cache._restore_pages

    def restore_late(pids, k, v, ks, vs):
        k, v = k.roll(1, dims=3), v.roll(1, dims=3)
        if ks is not None:
            ks, vs = ks.roll(1, dims=3), vs.roll(1, dims=3)
        return restore(pids, k, v, ks, vs)

    if late:
        cache._restore_pages = restore_late
    with patched((pd, "_pick_token", pick)):
        swap_serve(torch, eng, prompts, SWAP_SHORT_NEW)
    swap_clean(phase, "the forced run", cache)
    stats = dict(preemptions=eng.preemptions,
                 resumes_swapped=eng.resumes_swapped,
                 resumes_recompute=eng.resumes_recompute)
    return rec, watch, stats


def swap_logit_diff(torch, cfg, params, prompts, forced, rec, dev, kv_q8):
    """The largest distance of the recorded logits from the plain forward
    over the same forced sequences (int8 weights through their plain
    matmul)."""
    import paddle_tpu_torch.models.llama_pretrain as tlp
    from paddle_tpu_torch.ops import int8_matmul as im
    diff = 0.0
    with patched((tlp, "int8_matmul", im.int8_matmul_plain)):
        for i, rows in rec.items():
            seq = list(prompts[i]) + list(forced[i][:SWAP_SHORT_NEW - 1])
            plain = plain_logits(torch, cfg, params, seq, dev, kv_q8=kv_q8)
            off = len(prompts[i]) - 1
            for n, lg in rows.items():
                diff = max(diff, float((lg - plain[off + n]).abs().max()))
    return diff


def swap_promotion(torch, cfg, seed, params, mods, phase, dev):
    """Arm (e): serve_prefix's PREFIX_LEN-token system prompt registered by
    one request, its pages demoted to the host tier by filler traffic that
    needs the whole pool, then hit again by a request sharing it: the
    promoted pages equal the originals bit for bit.  -> (stats,
    launches)."""
    from paddle_tpu_torch.models.paged_decode import PagedKVCache
    from paddle_tpu_torch.models.serving_engine import (
        ContinuousBatchingEngine)
    rng = np.random.default_rng(seed + 7)
    prefix = rng.integers(0, cfg.vocab_size, PREFIX_LEN).tolist()
    tails = [rng.integers(0, cfg.vocab_size, n).tolist()
             for n in SWAP_PREFIX_TAILS]
    filler = np.random.RandomState(seed + 11)
    page = SWAP_CACHE["page"]
    shared = PREFIX_LEN // page
    cache = PagedKVCache(cfg, device=dev, host_pages=SWAP_HOST_PAGES,
                         **SWAP_CACHE)
    eng = ContinuousBatchingEngine(cfg, params, cache,
                                   enable_prefix_caching=True)
    zero_counts(mods)
    t0 = time.perf_counter()
    eng.submit(prefix + tails[0], max_new_tokens=PREFIX_NEW)
    eng.run_to_completion()
    keys = cache._chain_keys(np.asarray(prefix + tails[0]), page)[:shared]
    if any(k not in cache._prefix_index for k in keys):
        fail(f"{phase}: the prefix did not register its {shared} pages")
    snap = page_blocks(torch, cache, [cache._prefix_index[k] for k in keys])
    for n, new in SWAP_FILLER:
        eng.submit(filler.randint(1, cfg.vocab_size, (n,)),
                   max_new_tokens=new)
    eng.run_to_completion()
    demoted = sum(k in cache._host_prefix_index for k in keys)
    if demoted != shared:
        fail(f"{phase}: the filler demoted {demoted} of the prefix's "
             f"{shared} pages")
    promos, hits, ins = (cache.prefix_promotions, cache.prefix_hits,
                         cache.swap_in_pages)
    rid = eng.submit(prefix + tails[1], max_new_tokens=PREFIX_NEW)
    eng.step()
    slot = next(s for s, r in eng._active.items() if r.rid == rid)
    got = page_blocks(torch, cache,
                      [int(cache.tables[slot, j]) for j in range(shared)])
    equal = all(torch.equal(bits(torch, a), bits(torch, b))
                for a, b in zip(snap, got))
    done = eng.run_to_completion()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts(mods)
    if not equal:
        fail(f"{phase}: the promoted prefix pages differ from the pages "
             f"demoted")
    if cache.prefix_promotions - promos != shared or \
            cache.prefix_hits - hits != shared:
        fail(f"{phase}: the hit promoted "
             f"{cache.prefix_promotions - promos} and hit "
             f"{cache.prefix_hits - hits} pages, want {shared}")
    if any(r.status != "ok" or len(r.generated) != PREFIX_NEW for r in done):
        fail(f"{phase}: the promotion arm's request did not finish whole")
    swap_clean(phase, "the promotion arm", cache, indexed_ok=True)
    stats = dict(prefix_pages=shared, demoted=demoted,
                 promoted=cache.prefix_promotions - promos,
                 promoted_bit_for_bit=equal,
                 swap_out_pages=cache.swap_out_pages,
                 swap_in_pages=cache.swap_in_pages - ins,
                 host_indexed_after=len(cache._host_prefix_index),
                 wall_s=wall,
                 launches={k: launches[k] for k in SWAP_KERNELS})
    return stats, launches


def swap_faults(torch, cfg, params, mods, prompts, phase, cache, lane_kw):
    """Each swap fault site armed for a whole run on the overlap lane over
    ``cache`` (its decode graph captured already): preemption degrades to
    recompute, every request is served.  -> (stats by site, launches)."""
    from paddle_tpu_torch.models.serving_engine import (
        ContinuousBatchingEngine)
    from paddle_tpu_torch.testing import faults
    out, total = {}, {}
    for site in ("swap_out", "swap_in", "host_pool_full"):
        eng = ContinuousBatchingEngine(cfg, params, cache, overlap=True,
                                       **lane_kw)
        eng.offload_swap_gbps = 1e9
        zero_counts(mods)
        graphs0 = graph_state()
        with faults.plane() as fp:
            fp.inject(site, None if site == "host_pool_full"
                      else RuntimeError(f"injected {site}"))
            done = swap_serve(torch, eng, prompts, SWAP_SHORT_NEW)
        launches = ran_launches(read_counts(mods), graphs0)
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        for r in done:
            if r.status != "ok" or len(r.generated) != SWAP_SHORT_NEW:
                fail(f"{phase}: request {r.rid} ended {r.status} "
                     f"({r.error}) with {len(r.generated)} tokens under "
                     f"{site}")
        if eng.resumes_swapped or not eng.resumes_recompute:
            fail(f"{phase}: {site} resumed {eng.resumes_swapped} swapped "
                 f"and {eng.resumes_recompute} recomputed")
        swap_clean(phase, f"the {site} fault run", cache)
        out[site] = dict(preemptions=eng.preemptions,
                         resumes_recompute=eng.resumes_recompute,
                         fired=fp.fired.get(site, 0),
                         consulted=fp.counts.get(site, 0))
        if not out[site]["consulted"]:
            fail(f"{phase}: the {site} site was never consulted")
    return out, total


def swap_micro(torch, eng, cache):
    """One victim's SWAP_VICTIM_PAGES pages through the host tier of
    ``cache``: the pinned D2H wall (gather, side-stream copy, flush) and
    H2D wall (gather from the pinned buffer), each between synchronizes,
    the median of 5; a pageable D2H of the same block for contrast; and the
    device busy share while the victim stages under SWAP_BUSY_REPLAYS
    replays of ``eng``'s decode graph (the kernels' summed time over the
    window's wall, CUDA-only profiler)."""
    n = SWAP_VICTIM_PAGES
    cache.alloc_row(0, n * cache.page)
    pids = cache._owned[0][:n]
    hids = [cache.host.alloc() for _ in range(n)]
    nbytes = n * cache.page_bytes

    def wall(fn):
        ts = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ts.append(time.perf_counter() - t0)
        return statistics.median(ts)

    def d2h():
        cache._stage_swap_out(pids, hids)
        cache.host.flush()

    d2h_s = wall(d2h)
    h2d_s = wall(lambda: cache.host.gather(hids))
    blk = page_blocks(torch, cache, pids)
    pageable_s = wall(lambda: [b.to("cpu") for b in blk])
    del blk
    graph = eng._graph()
    replay = lambda: graph(eng.params, eng._pools(), eng._gen)  # noqa: E731
    replay()
    torch.cuda.synchronize()
    t_alone = wall(lambda: [replay() for _ in range(SWAP_BUSY_REPLAYS)])
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cache._stage_swap_out(pids, hids)
        for _ in range(SWAP_BUSY_REPLAYS):
            replay()
        cache.host.flush()
        torch.cuda.synchronize()
        window = time.perf_counter() - t0
    kern_us = copy_us = 0.0
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        if "memcpy" in e.name.lower():
            copy_us += e.time_range.elapsed_us()
        else:
            kern_us += e.time_range.elapsed_us()
    for h in hids:
        cache.host.free(h)
    cache.release_row(0)
    return dict(victim_pages=n, victim_bytes=nbytes,
                pinned_d2h_gb_per_s=nbytes / d2h_s / 1e9,
                pinned_h2d_gb_per_s=nbytes / h2d_s / 1e9,
                pageable_d2h_gb_per_s=nbytes / pageable_s / 1e9,
                d2h_ms=d2h_s * 1e3, h2d_ms=h2d_s * 1e3,
                staging_window_ms=window * 1e3,
                replays_alone_ms=t_alone * 1e3,
                device_busy_share_while_staging=kern_us / 1e3
                / (window * 1e3),
                copy_ms_in_window=copy_us / 1e3)


def swap_default_choice(eng, cache):
    """What ``_preempt_mode`` picks at its defaults (10 GB/s, the card's
    989 TFLOP/s) for a victim of SWAP_PROMPT + 1 tokens, with the two
    priced times."""
    from paddle_tpu_torch.models.serving_engine import (
        _chip_flops_default, _count_params)
    L = SWAP_PROMPT + 1
    private = -(-L // cache.page)
    swap_s = 2.0 * private * cache.page_bytes / (10.0 * 1e9)
    recompute_s = 2.0 * _count_params(eng.params) * L \
        / _chip_flops_default(cache.device)
    return dict(victim_tokens=L, private_pages=private,
                swap_ms=swap_s * 1e3, recompute_ms=recompute_s * 1e3,
                choice="swap" if swap_s < recompute_s else "recompute")


def phase_serve_swap(torch, cfg, seed, params, mods, kv_quant=None,
                     dev="cuda"):
    """The two-tier KV cache on LLaMA-7B (see 4h / 4i in this file's
    docstring).  -> the launches of the timed arms, the promotion arm and
    the fault runs."""
    phase = "serve_swap_int8" if kv_quant else "serve_swap"
    limit = INT8_LOGIT_LIMIT if kv_quant else LOGIT_LIMIT
    rng = np.random.RandomState(seed)
    prompts = [rng.randint(1, cfg.vocab_size, (SWAP_PROMPT,)).tolist()
               for _ in range(SWAP_REQUESTS)]
    # int8: the packed lane (K2, K3 both paths); bf16: the batched lane,
    # whose dense prefill runs K5
    lane_kw = {} if kv_quant else {"packed": False}
    t_phase = time.perf_counter()
    arms, total = {}, {}

    def add(launches):
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v

    def watched(name, watch):
        if watch["refused"]:
            fail(f"{phase}: {name}: swap-outs refused: {watch['refused']}")
        if watch["prefill"]:
            fail(f"{phase}: {name}: swapped resumes of {watch['prefill']} "
                 f"dispatched a prefill or launched K2 / K5")
        bad = sum(1 for e in watch["equal"] if not bool(e))
        if bad:
            fail(f"{phase}: {name}: {bad} restored page blocks differ from "
                 f"their snapshot")
        return watch["pages"]

    if kv_quant:
        served, stats, launches, eng, cache, watch = swap_arm(
            torch, cfg, params, mods, prompts, phase, "(d) int8 swap",
            kv_quant, dev, overlap=True)
        arms["d_int8_swap_overlap"] = stats
        stats["round_trip_pages"] = watched("(d)", watch)
        stats["pinned_bytes"] = cache.host.nbytes
        add(launches)
        need = ["paged_decode_attention_q8", "flash_attention_segmented",
                "int8_matmul", "int8_matmul_wave"]
        default_choice = swap_default_choice(eng, cache)
        del eng, cache
    else:
        _, a, launches, _, _, _ = swap_arm(
            torch, cfg, params, mods, prompts, phase, "(a) recompute", None,
            dev, host=False, lane_kw=lane_kw)
        arms["a_recompute_sync"] = a
        add(launches)
        served, b, launches, eng, cache, watch = swap_arm(
            torch, cfg, params, mods, prompts, phase, "(b) swap sync", None,
            dev, lane_kw=lane_kw)
        b["round_trip_pages"] = watched("(b)", watch)
        b["pinned_bytes"] = cache.host.nbytes
        arms["b_swap_sync"] = b
        add(launches)
        default_choice = swap_default_choice(eng, cache)
        del eng, cache
        torch.cuda.empty_cache()
        over, c, launches, eng_c, cache_c, watch = swap_arm(
            torch, cfg, params, mods, prompts, phase, "(c) swap overlap",
            None, dev, overlap=True, lane_kw=lane_kw, no_sync=True)
        c["round_trip_pages"] = watched("(c)", watch)
        arms["c_swap_overlap"] = c
        add(launches)
        if over != served:
            # the first diverging token, with the plain forward's logits of
            # both picks over the synchronous arm's context
            i = next(i for i in range(len(served)) if over[i] != served[i])
            j = next(j for j in range(len(served[i]))
                     if over[i][j] != served[i][j])
            lg = plain_logits(torch, cfg, params,
                              prompts[i] + list(served[i][:j]), dev)[-1]
            top = lg.topk(2)
            emit(f"{phase}_divergence", request=i, token=j,
                 sync_token=served[i][j], overlap_token=over[i][j],
                 plain_logit_sync=float(lg[served[i][j]]),
                 plain_logit_overlap=float(lg[over[i][j]]),
                 plain_top2=[float(v) for v in top.values],
                 diverged=[k for k in range(len(served))
                           if over[k] != served[k]],
                 log_sync=b["preemption_log"], log_overlap=c[
                     "preemption_log"])
            fail(f"{phase}: the overlap arm's request {i} differs from the "
                 f"synchronous arm's at token {j}")
        if c["captures_in_timed_run"]:
            fail(f"{phase}: the overlap arm captured "
                 f"{c['captures_in_timed_run']} graphs after its warm-up")
        if a["resumes_recompute"] <= 0 or a["resumes_swapped"]:
            fail(f"{phase}: the recompute arm resumed "
                 f"{a['resumes_recompute']} recomputed, "
                 f"{a['resumes_swapped']} swapped")
        fault_stats, launches = swap_faults(torch, cfg, params, mods,
                                            prompts, phase, cache_c, lane_kw)
        add(launches)
        micro = swap_micro(torch, eng_c, cache_c)
        del eng_c, cache_c
        torch.cuda.empty_cache()
        promotion, launches = swap_promotion(torch, cfg, seed, params, mods,
                                             phase, dev)
        add(launches)
        need = ["paged_decode_attention", "flash_attention_segmented",
                "fused_rope"]
    for name in need:
        if total.get(name, 0) <= 0:
            fail(f"{phase}: kernel {name} was not launched")
    for name in FLAGGED:
        if total.get(name):
            fail(f"{phase}: kernel {name} was launched with its flag off")
    for arm, st in arms.items():
        if arm.startswith("a_"):
            continue
        if st["resumes_swapped"] <= 0 or st["prefill_tokens_avoided"] <= 0 \
                or st["resumes_recompute"]:
            fail(f"{phase}: {arm} resumed {st['resumes_swapped']} swapped "
                 f"and {st['resumes_recompute']} recomputed with the swap "
                 f"forced, avoided {st['prefill_tokens_avoided']} prefill "
                 f"tokens")
        if not st["round_trip_pages"]:
            fail(f"{phase}: {arm} round-tripped no page")
    t_check = time.perf_counter()
    forced = [list(g[:SWAP_SHORT_NEW]) for g in served]
    rec, watch, forced_stats = swap_forced(torch, cfg, params, mods, prompts,
                                           forced, phase, kv_quant, dev,
                                           lane_kw)
    forced_pages = watched("the forced run", watch)
    if not rec:
        fail(f"{phase}: the forced run resumed no row with tokens left")
    diff = swap_logit_diff(torch, cfg, params, prompts, forced, rec, dev,
                           kv_q8=bool(kv_quant))
    rec_f, _, _ = swap_forced(torch, cfg, params, mods, prompts, forced,
                              phase, kv_quant, dev, lane_kw, late=True)
    fault_diff = swap_logit_diff(torch, cfg, params, prompts, forced,
                                 rec_f, dev, kv_q8=bool(kv_quant))
    del rec, rec_f
    check_s = time.perf_counter() - t_check
    fields = dict(model="LLaMA-7B (LlamaPretrainConfig defaults)",
                  weights="int8 (quantize_params_int8)" if kv_quant
                  else "bf16", kv_pages=kv_quant or "bf16",
                  source="bench.py:654 _preemption_line, TPU recipe "
                  "(bench.py:680-690)",
                  requests=SWAP_REQUESTS, prompt_tokens=SWAP_PROMPT,
                  new_tokens=SWAP_NEW, cache=SWAP_CACHE,
                  host_pages=SWAP_HOST_PAGES, arms=arms,
                  preempt_mode_at_defaults=default_choice,
                  forced_run=dict(forced_stats,
                                  round_trip_pages=forced_pages),
                  logit_check_s=check_s, logit_max_abs_diff=diff,
                  logit_limit=limit,
                  logit_reference=("plain forward, int8 weights through "
                                   "their plain matmul, K / V through "
                                   "quantize_kv_token" if kv_quant
                                   else "plain forward"),
                  planted_fault="pages restored one slot late",
                  planted_fault_max_abs_diff=fault_diff,
                  launches={k: total.get(k, 0) for k in SWAP_KERNELS},
                  phase_s=time.perf_counter() - t_phase)
    if not kv_quant:
        a_ms = arms["a_recompute_sync"]["resume_ms_mean"]
        b_ms = arms["b_swap_sync"]["resume_ms_mean"]
        fields.update(resume_ms_ratio_recompute_over_swap=a_ms / b_ms,
                      faults=fault_stats, transfer=micro,
                      promotion=promotion)
    emit(phase, **fields)
    if diff > limit:
        fail(f"{phase}: the resumed rows' teacher-forced logits differ from "
             f"the plain forward's by {diff} (limit {limit})")
    if fault_diff <= limit:
        fail(f"{phase}: the planted fault moved the logits by only "
             f"{fault_diff}, within the limit {limit}")
    from paddle_tpu_torch.models import graphed_step
    graphed_step.clear()                 # the arms' caches are gone
    return total


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
    k5 = [phase_k5(torch, rp, shape, gen, flush, timed=shape in K5_TIMED)
          for shape in K5_SHAPES]
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
    launches_overlap = phase_serve_overlap(torch, cfg, args.seed, params,
                                           mods)
    torch.cuda.empty_cache()
    launches_observe = phase_serve_observe(torch, cfg, args.seed, params,
                                           mods)
    torch.cuda.empty_cache()
    launches_prefix = phase_serve_prefix(torch, cfg, args.seed, params, mods)
    torch.cuda.empty_cache()
    launches_dense = phase_serve_dense(torch, cfg, args.seed, params, mods)
    torch.cuda.empty_cache()
    launches_faults = phase_serve_faults(torch, cfg, args.seed, params, mods)
    torch.cuda.empty_cache()
    launches_mixed = phase_serve_mixed(torch, cfg, args.seed, params, mods)
    torch.cuda.empty_cache()
    launches_spec = phase_serve_spec(torch, cfg, args.seed, params, mods)
    torch.cuda.empty_cache()
    launches_swap = phase_serve_swap(torch, cfg, args.seed, params, mods)
    torch.cuda.empty_cache()
    launches_int8, qparams = phase_serve_int8(torch, cfg, args.seed, params,
                                              mods)
    del params
    torch.cuda.empty_cache()
    launches_int8_overlap = phase_serve_overlap(
        torch, cfg, args.seed, qparams, mods, kv_quant="int8")
    torch.cuda.empty_cache()
    launches_prefix_int8 = phase_serve_prefix(torch, cfg, args.seed, qparams,
                                              mods, kv_quant="int8")
    torch.cuda.empty_cache()
    launches_mixed_int8 = phase_serve_mixed(torch, cfg, args.seed, qparams,
                                            mods, kv_quant="int8")
    torch.cuda.empty_cache()
    launches_spec_int8 = phase_serve_spec(torch, cfg, args.seed, qparams,
                                          mods, kv_quant="int8")
    torch.cuda.empty_cache()
    launches_swap_int8 = phase_serve_swap(torch, cfg, args.seed, qparams,
                                          mods, kv_quant="int8")
    del qparams
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
    runs = [launches, launches_overlap, launches_observe, launches_prefix,
            launches_dense, launches_faults, launches_mixed, launches_spec,
            launches_swap, launches_int8, launches_int8_overlap,
            launches_prefix_int8, launches_mixed_int8, launches_spec_int8,
            launches_swap_int8,
            launches_train, launches_packed, *launches_fused]
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
