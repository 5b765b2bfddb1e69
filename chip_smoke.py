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
             first two waves served (24 new tokens and the stagger) on the
             sync mixed lane with every token's logits recorded where the
             engine computes it, within
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
             the served sequences (the 8 requests served again to 32
             tokens), teacher-forced, within LOGIT_LIMIT of
             the plain forward and a planted fault (fresh K/V scattered one
             slot late) beyond it.
4h. serve_swap - the two-tier KV cache (PagedKVCache(host_pages=64), the
             host tier pinned, its copies on a side stream) under bench.py's
             _preemption_line TPU recipe (bench.py:680-690): 6 requests of
             256 prompt tokens from np.random.RandomState(seed) (bench.py's
             RandomState(0) at seed 0), 96 new tokens (the recipe's 192
             halved for the time limit), greedy, batch 4, 18 pages of 64
             (6 a request at its end: preemption is forced),
             pages_max 8, the graph arms after a warm-up of 5 requests of
             72 new tokens (bench.py warms 192, for its jit; the port
             compiles nothing at run time, and the synchronous arms capture
             nothing, so they run cold).  Arms, in one process: (a) no host
             tier (recompute resumes), (b) the host tier with the swap forced
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
4j. serve_qos - QoS and the in-process fleet (paddle_tpu_torch/fleet) at
             LLaMA-7B, bf16, pages of 64, greedy.  (a) One engine: a quota
             check (tenant "t", 100 tokens/s, burst 600, the clock pinned:
             the third 252-token charge refused with its bucket's
             retry_after, admitted after that refill) and a burst of 24
             requests in the class mix 1 high : 2 normal : 2 low against a
             queue of 8, nothing stepped: the verdicts (admitted, degraded,
             rejected per class) equal to the port's CPU engine's on the
             same submissions; then priority preemption: 8 lows fill the
             batch, two highs arrive, each evicting the youngest low, on the
             synchronous lane, the overlap lane (graph replays; the same
             tokens as the synchronous arm) and with a host tier (the
             victims swapped out and restored bit for bit), and on int8
             weights over int8 pages (K3, K4): every request finishes, no
             high is churned, each served schedule's decode logits within
             LOGIT_LIMIT (int8: INT8_LOGIT_LIMIT) of the plain forward and a
             planted fault (attention over lens, not lens + 1) beyond it.
             (b) bench.py's _serving_qos_line TPU recipe (bench.py:1168-1177)
             through FleetRouter: a fixed 1-replica fleet, the same under
             FleetAutoscaler, and that with replica_death injected
             mid-ramp, every replica over the one weight set: tok/s, TTFT
             p99 by class, rejections by class, degraded, the replica
             trajectory, deaths, replacements, scale-ups and -downs, and
             memory allocated / reserved at the start, at the peak replica
             count and after the walk back to one replica.  Fails on a
             request neither finished nor rejected, a live replica's audit
             not clean, the kill arm without exactly one death and one
             replacement, the walk back ending more than 64 MiB above the
             fixed arm's allocated memory, or a peak above the memory
             before the first replica plus 3 pools plus 4 GiB.  (c)
             FleetServer over two replicas on HTTP: priority and tenant in
             the body, a quota 429 with its Retry-After, degraded
             completions flagged in /generate and in the stream, /health's
             fleet state and the fleet instruments in /metrics, and a
             replica death mid-stream: the stream ends with the error while
             a request queued behind it fails over and completes.
4k. serve_disagg - the in-process disaggregated pair
             (paddle_tpu_torch/models/disagg.py: PrefillEngine, DecodeEngine,
             DisaggCoordinator) at LLaMA-7B, bf16, both engines over the one
             weight set with a cache each (128 pages of 64, a host tier of
             96), the route forced through the hand-off, under serve_mixed's
             schedule (bench.py's _disagg_line recipe).  The unified engine
             and the pair timed on it: TTFT and TPOT p50 / p99, the decode
             step's p99 during admission ticks, hand-off ms a request and
             its GB/s (printed, not gated); the flip link speed at the
             schedule's lengths and the default handoff_gbps's verdict;
             K1 and K2 launched.  Gates: (a) every hand-off's restored pages
             equal to its export's bit for bit; (b) no prefill on the decode
             side, prefill_tokens_avoided the handed-off context, the
             routing counters adding up; (c) the served logits within
             LOGIT_LIMIT of the plain forward (a served token within
             2 * LOGIT_LIMIT of the plain top), a planted fault (every
             shipped page adopted one slot late) beyond it; (d) a
             kv_handoff fault at the ship half and at the restore half each
             degrading one request to a colocated re-prefill, none lost,
             the pools clean; (e) FleetRouter(roles=["prefill", "decode"]):
             a replica_death of the prefill replica with untaken records
             reclaims their staging pages and fails the requests over.
4l. serve_remote - the sockets fleet (paddle_tpu_torch/fleet/transport.py,
             fleet/remote.py) at LLaMA-7B, bf16, pages of 64: agents spawned
             in OS processes of their own (spawn start method) from
             testing/agent_factory.py:make_llama7b_engine with the parent's
             seed (the same weights, drawn in the child; 128 pages of 64),
             loading the kernel libraries the parent built; their K1 / K2
             launch counts come back through a file.  (a) a FleetServer over
             one agent and one in-process replica answers serve's prompts
             over HTTP, the even ones pinned to the agent: every reply
             complete, every served token's plain teacher-forced logit
             within 2 * LOGIT_LIMIT of the plain top (a planted fault, the
             prompt's last token lost, beyond it), every
             paddle_tpu_transport_* instrument in /metrics with frames and
             bytes above 0, K1 and K2 launched in the agent; exact token
             agreement with an in-process engine, spawn-to-ready seconds and
             RTT p50 / p99 printed.  (c) on the same router, two requests
             decoding on the agent and two submitted behind them, then
             SIGKILL: the two that streamed end with an error, the two that
             did not complete on the survivor with their fleet rid and
             absolute deadline, the survivor's cache audits clean, and
             auto_replace's respawned agent serves one more request
             (failover ms printed).  (b) FleetRouter(roles=["prefill",
             "decode"]) over a spawned prefill agent and an in-process
             DecodeEngine with a host tier: four 256-token records (128 MiB
             each) cross the wire; every restored page equal bit for bit to
             the blocks that arrived, no prefill on the decode side,
             prefill_tokens_avoided the handed-off context; hand-off ms and
             GB/s printed.  (d) an agent whose engine
             (chip_smoke:sticky_llama7b_engine) indexes out of bounds on the
             card after REMOTE_STICKY_AFTER decode steps, a device-side
             assert: the agent reports DEAD (its rebuild fails in the
             poisoned context), the router counts one death and fails the
             requests over as in (c), and the parent's context then runs K1
             against its plain version and serves a request on the survivor.
4m. api_llama - the Paddle API's Layer LlamaForCausalLM (models/llama.py)
             at LLaMA-7B, full depth, built over the serve's bf16 weights
             (models/weights.py:causal_lm_from_params: every parameter a
             view, nothing copied), batch 2 x 128-token prompts from
             np.random.RandomState(seed): (a) the forward's logits within
             LOGIT_LIMIT of the plain forward's, teacher-forced, a planted
             fault (the flash forward non-causal) beyond it, and K5 2 x 32,
             K6a 32, K9a 2 x 32 + 1 launched and nothing else; (b) the
             eager generate (8 new tokens over the concatenated cache) and
             (c) generate_compiled (the dense decode, f32 compute as JAX
             pins it) greedy and with int8 weights (K3 (7 x 32 + 1) x 8
             times): each generated token within 2 * LOGIT_LIMIT (int8: 2 *
             INT8_LOGIT_LIMIT) of the plain top logit on its own sequence,
             the dense decode's teacher-forced logits within the limits;
             (d) make_generate_beam with 4 beams: each best beam's score
             against the plain forward's summed log-probabilities; (e)
             generate_auto over the serve's tree, a uniform batch on the
             dense decode and a ragged one (128 and 100 tokens) on the paged
             path (K1).
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
             at half its depth (MIXED_INT8_WAVES of its waves, both
             checked; K4 in the decode half, K3 on both paths): the
             recorded logits within INT8_LOGIT_LIMIT of the same run
             replayed teacher-forced with every kernel replaced by its
             plain version.
5e. serve_spec_int8 - serve_spec's first three arms (SPEC_INT8_ARMS: h1
             and the target drafting for itself, sync and overlap) on the
             int8 weights over int8 target and draft pages (K4 and K3's
             decode path in the draft's micro-steps, K3's wave path in the
             verify at M = 40): the
             recorded logits within INT8_LOGIT_LIMIT of the same run
             replayed teacher-forced with every kernel replaced by its plain
             version, the planted fault beyond it.
5f. serve_disagg_int8 - serve_disagg's (a), (b) and (c) on the int8
             weights over int8 pages (scale planes shipped bit for bit; K2,
             K3 and K4 launched): logits within INT8_LOGIT_LIMIT of the
             plain forward over the int8 weights and quantized K / V.
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
11b. api_train - the Layer LlamaForCausalLM at LLaMA-7B's width and
             API_TRAIN_LAYERS layers, bf16 parameters drawn by the API's
             initializers from paddle.seed, AdamW(multi_precision=True)
             (f32 masters): one step's gradients (loss.backward()) within
             GRAD_LIMIT of autograd through the kernels' plain versions
             (the API's op table re-registered), a planted fault (the RoPE
             backward with +sin) beyond it, K5 4 x L, K6a-c L, K9a-b 2 x L
             + 1 a step; then API_TRAIN_STEPS steps of model(x, labels=y),
             loss.backward(), opt.step(), opt.clear_grad() on one [2, 2048]
             batch: the loss falls; step ms and tokens/s printed.
11c. api_bert - BERT-base SQuAD fine-tune (bench.py:354-386, BASELINE
             config 3) through incubate.jit_train_step: BertConfig()
             defaults with dropout 0.1, AdamW(5e-5), AMP O1 bf16, batch 32
             x 384 drawn as bench.py draws them, the padding mask all
             ones.  Checks first: one step's gradients of the mask-free
             arm (attn_mask=None: K6a-c, non-causal, head_dim 64) within
             GRAD_LIMIT of the plain versions' (the same dropout masks:
             the framework's generator reseeded before each pass), a
             planted fault (the kernels told the wrong causality) beyond
             it; a dropout-0 lane whose replayed losses stay within
             JIT_LOSS_LIMIT of an eager loop's over API_BERT_CHECK_STEPS
             steps; a dropout-0.1 lane at lr 0 whose replayed losses
             differ step to step and repeat after the same paddle.seed.
             Then the recipe's capture and API_BERT_STEPS timed replays,
             the same model's eager loop for API_BERT_STEPS steps, and
             the mask-free arm's capture and replays: step ms and
             samples/s of each, K6a-c 12 a replay mask-free and 0 masked
             (the graphs' recorded launches), sdpa_plain never reached;
             one replay of each arm and one eager step under a CUDA-only
             profiler: host ms, device ms, busy share, device ms by kind.
11d. api_gpt - GPT-3 XL (gpt3_1p3b_config: 24 x 2048, 16 heads of 128,
             vocab 50304) pretraining on one card through jit_train_step:
             batch 2 x 2048 from a seed, AMP O1 bf16, AdamW(beta2 0.95,
             weight decay 0.1, lr 2e-4) with ClipGradByGlobalNorm(1.0)
             (GPT-3's Table 2.1 / Appendix B), GPTPretrainingCriterion.
             One O1 step's gradients through K6a-c (causal, head_dim 128)
             within GRAD_LIMIT of the plain versions', a planted fault
             (non-causal kernels) beyond it; then API_GPT_EAGER_STEPS
             eager steps and the capture plus API_GPT_STEPS timed replays:
             the loss falls over the replays, K6a-c 24 a replay, step ms
             eager and replayed, tokens/s, the GB allocated when the
             phase began and its peak since;
             one eager step and one replay profiled as in api_bert.
11e. api_fit - BASELINE config 1: Model(LeNet()).fit on the synthetic
             MNIST (2,048 samples, Normalize(0.5, 0.5)), Adam(1e-3),
             CrossEntropyLoss, Accuracy, batch 64, 2 epochs, two DataLoader
             workers over shared memory (persistent: spawned once for
             both epochs); then evaluate and predict on
             MNIST(mode="test").  Gates: one CUDA graph
             replayed once a step, every batch counted through shared
             memory, accuracy >= API_FIT_ACC, save -> load into a fresh
             Model giving evaluate and predict outputs equal bit for bit,
             the loss falling by more than API_FIT_FLAT over the run and a
             planted fault (the optimizer's rule returns the parameter)
             leaving it within API_FIT_FLAT.  Prints fit s, samples/s and
             a step's median wall ms.
11f. api_resnet - _resnet_line's TPU recipe (bench.py:302-330, BASELINE
             config 2, its data parallelism cut to one card):
             resnet50(num_classes=1000), batch 256 x 3 x 224 x 224 from
             np.random.RandomState(0), Momentum(0.1, 0.9), jit_train_step
             at O1 bf16.  At full width and batch 32, 3 replays against the
             eager O1 loop from the same weights: losses within
             RESNET_LOSS_LIMIT, every BatchNorm's _mean / _variance within
             RESNET_STAT_LIMIT, a planted fault (torch's momentum
             convention) beyond it.  Then at 256: 3 eager steps (their
             pool freed), the capture, 1 warm-up and 5 timed replays on two
             alternating batches (the loss falls over the replays: the last
             pair's mean below the first pair's; no NaN),
             one replay profiled (device ms by kind: conv, batchnorm,
             elementwise, matmul, other); replayed and eager ms, images/s,
             capture s, peak GB.
11g. api_ops - every function the tensor-op slice added (the tensor
             modules, paddle.linalg, nn.functional's activations, the _
             forms as Tensor methods; paddle_tpu_torch/testing/op_sweep.py)
             on CUDA tensors against the same call on CPU tensors from the
             same numpy inputs: elementwise ops and reductions at [2048,
             4096] f32, sorts and searches over 4096-wide rows, linear
             algebra batched at [8, 256, 256], TF32 off; each family's
             largest error against its bound (op_sweep.BOUNDS), gradients
             of the differentiable ops too; the CUDA-specific cases (ties,
             duplicate indices in several runs, cummax / cummin tie
             indices, a rank-deficient lstsq, a logical shift of negative
             ints, an even-count median, the decompositions' invariants);
             the bf16 lane of tests/test_ops_dtype_lanes.py's ops; each
             random op's seeds and law (2^20 draws); two planted faults
             (torch.median's lower middle, scatter keeping the first
             duplicate) caught; the host us of a Paddle call over torch's.
11h. api_vision - MobileNetV3-Large (Howard et al. 2019, scale 1.0, 1000
             classes) on api_resnet's recipe and gates at 256 x 224 (its
             parity models' dropout at 0), then one eager f32 forward of
             each other family's smallest member at 4 x 224 (299 for
             InceptionV3) against the CPU's from the same weights.
11i. api_transformer - Transformer-base (Vaswani et al. 2017, Table 3
             base) through nn.Transformer(), composed as a user script
             composes it (a shared, tied embedding over 37,000 tokens,
             sinusoidal positions, label smoothing 0.1 through one_hot,
             label_smooth and a soft-label cross_entropy), Adam(0.9, 0.98,
             1e-9) under NoamDecay(512, 4000), 13 pairs x 256 tokens a side
             (lengths 236-256, tensor2tensor's last length bucket: about
             3,200 target tokens, the paper's 25,000 over 8 GPUs; padding
             and causal masks), jit_train_step at O1: one O1 step's
             gradients within XF_GRAD_LIMIT of the f32 step's (L2 a
             leaf), a planted fault (the causal mask one wider) beyond it;
             32 greedy steps through gen_cache / cache= whose logits stay
             within DECODE_LIMIT of the full causal forward's (the same
             fault beyond it); a dropout-0 lane's replays against its
             eager loop; then the recipe's eager steps, capture and
             replays: step ms, target tokens/s, capture s, peak GB, one
             replay's device ms by kind.  Every attention there has a mask
             or q_len != kv_len: no hand-written kernel runs (checked).
11j. api_varlen - packed attention through the Paddle API at LLaMA-7B's
             attention width (32 heads of 128, bf16, 16,384 packed tokens,
             document lengths from the seed): flash_attn_unpadded at 32 /
             32 and 32 / 8 heads (37 tokens short: JAX's -1 padding),
             flash_attn_varlen_qkvpacked and flash_attn_qkvpacked [8, 2048,
             3, 32, 128], forward and backward: outputs within TOL and
             gradients within VARLEN_GRAD_LIMIT of the plain versions (each
             document alone, f32 math), K2 / ranges / K7a / K7b once a
             varlen call and K6a-c once for the dense one; an f32 call
             over the whole stream takes the plain route (a document at a
             time) and launches nothing; cu_seqlens shifted by one lands
             beyond TOL, K7a / K7b told the other causality beyond
             VARLEN_GRAD_LIMIT.
11k. api_nn - nn's families on the card against the CPU
             (op_sweep.nn_cases: losses over [1024, 32000] logits, norms,
             pads, resampling, pools with masks and unpools, transposed
             convolutions, fold / unfold, shuffles, the long tail), the
             dropouts' laws and a planted reflect-pad fault; the LSTM LM of
             Zaremba et al. 2014 (large: 2 x 1500, vocab 10,000, 35 steps,
             batch 20, dropout 0.65, SGD lr 1, clip 10) in f32 through
             jit_train_step (replays against eager losses, step ms,
             tokens/s); beam search (4 beams, 8 prompts, 32 steps) over its
             first LSTMCell through dynamic_decode, each beam's score held
             against its teacher-forced rescoring (the ids without the
             backtrace as a planted fault).
11l. api_infer - the deployment path at BERT-base's full width
             (BertForQuestionAnswering, BertConfig() defaults, seed 55,
             bf16) on api_bert's recipe shape, 32 x 384, mask-free: (1)
             jit.to_static against the eager and the plain versions'
             forward (K6a a layer from the replayed graph, sdpa_plain not
             reached, capture s, replayed and eager ms, samples/s); (2)
             Model.save(training=False) -> jit.load, the same logits; (3)
             inference.convert_to_export, loaded and replayed by a
             Predictor in a child process that imports no model code
             (its logits, K6a a replay, replay ms, samples/s); (4)
             InferenceServer over a DevicePool on the card, 4 client
             threads x 8 predict_http requests of distinct inputs, each
             answer equal to its solo run bit for bit, /health and
             /metrics counting them, a malformed body a 400 (requests/s,
             latency p50 / p99); (5) LlamaForCausalLM at LLaMA-7B's width,
             2 layers, bf16, a 512-token prompt, through the same export
             (K5, K6a, K9a a replay as the code predicts, logits within
             LOGIT_LIMIT of the plain forward's); (6) planted faults: K6a
             told causal=True inside the exported program, and two
             requests copied into the graph before the first's answer is
             copied out (the lock's reach).
12. kernels - one JSON object with an entry per ported kernel (16, and
             K3's wave path beside its decode path and the segmented
             kernels' per-tile range kernel: 18).
13. timing - each phase's seconds and the whole run's.

Cuts for the 1,200 s limit: serve_mixed_int8 runs 2 of its 4 waves,
serve_spec and serve_spec_int8 32 new tokens a request where the recipe has
64 (serve_spec_int8 its first 3 arms), serve_mixed, serve_mixed_int8 and
serve_disagg 32 where it has 48, serve_int8_overlap its reference and
last lane, serve_swap 72 new tokens a request where the recipe has 192,
api_ops its elementwise ops and reductions over 1,024 rows of 4,096 where
the serving wave has 2,048,
serve_qos 6 new tokens a fleet request where the recipe has 32 (and its
preemption arms' lows 6-13 and highs 6, where they were 20-34 and 24).

The last line is {"ok": true, "device": {...}}.  Any failed check exits
non-zero before that line.  Without a CUDA device, or without the package
beside this script, it exits non-zero and prints no result.
"""

import argparse
import contextlib
import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

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
# serve_int8_overlap runs the reference and the last lane only, which
# drives the int8 horizon graph and the pipeline; the int8 async graph
# (H = 1) is driven by serve_swap_int8's overlap arm (a cut for the run's
# time limit)
INT8_OVERLAP_LANES = [OVERLAP_LANES[0], OVERLAP_LANES[-1]]


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
                        dev="cuda", lanes=OVERLAP_LANES):
    """The serve's requests through ``lanes`` on one cache
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
    for lane, kw in lanes:
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
    kw = dict(lanes[-1][1])
    gens, stats = drive(torch, cfg, params, cache, prompts, SERVE_NEWS, mods,
                        in_order=True, **kw)
    for k, v in stats["launches"].items():
        total[k] = total.get(k, 0) + v
    emit(phase, lane="http_" + lanes[-1][0], engine_kw=kw,
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
# bench.py's recipe takes 48 new tokens a request; the script takes 32 (its
# cut for the 1,200 s limit: the last wave still arrives, at tick 18, while
# the batch decodes; tools/chip_phases.py serve_mixed_before runs 48 in the
# same process)
MIXED_NEW, MIXED_STAGGER, MIXED_BUDGET = 32, 3, 128
MIXED_CACHE = dict(num_pages=160, pages_max=8, batch=8, page=64)
# the warm-up: two waves of the twin schedule with 8 new tokens (the second
# arrives while the first decodes, so the mixed arms tick before the timing)
MIXED_WARM_WAVES, MIXED_WARM_NEW = 2, 8
# the teacher-forced check serves the first two waves of the schedule at
# MIXED_CHECK_NEW new tokens (the second wave still arrives while the first
# decodes, so the check covers mixed ticks)
MIXED_CHECK_WAVES, MIXED_CHECK_NEW = 2, 24
# serve_mixed_int8 re-runs the recipe on int8 weights and pages at half its
# depth (2 of its 4 waves, both checked as in serve_mixed: the second's
# admission is the one that rides mixed ticks), so the whole script keeps room under its time
# limit on a slow host
MIXED_INT8_WAVES = 2
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


def mixed_drive(eng, sched, new=None):
    """bench.py's _ab_drive: the waves submitted on schedule, one step a
    tick, each tick's host wall filed under admission (a sequential wave
    ran, or a mixed tick took fresh tokens) or quiet.  -> (admission ms,
    quiet ms, the finished requests in submission order, fresh tokens of
    each mixed tick)."""
    new = MIXED_NEW if new is None else new
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
    arguments (a planted fault).  Each request takes MIXED_CHECK_NEW
    tokens.  -> (tokens per request, logits per request, [tokens, V]
    fp32)."""
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
        _, _, done, _ = mixed_drive(eng, sched, new=MIXED_CHECK_NEW)
    if cache.audit()["owned"]:
        fail("serve_mixed: the recorded run left pages owned")
    gens = [r.generated for r in done]
    logits = [torch.stack([rec[r.rid][j] for j in range(len(r.generated))])
              for r in done]
    return gens, logits


def phase_serve_mixed(torch, cfg, seed, params, mods, kv_quant=None,
                      dev="cuda", waves=MIXED_WAVES):
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
    sched = mixed_schedule(cfg, seed, waves)
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
         traffic=dict(waves=waves, per_wave=MIXED_PER_WAVE,
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
# bench.py's recipe serves 64 new tokens a request; the script serves 32
# (its cut for the 1,200 s limit, the logit check and the profiled rounds
# cut with it: 32 -> 16 and 5 -> 3; tools/chip_phases.py serve_spec_before
# runs the depth the script had before, in one process)
SPEC_REQUESTS, SPEC_NEW, SPEC_WARM_NEW = 8, 32, 8
# the logit check serves the same requests to half their length (the
# chip_smoke wall: each spec arm keeps SPEC_NEW)
SPEC_CHECK_NEW = 16
SPEC_GAMMA, SPEC_LOOKUP_GAMMA = 4, 7
SPEC_DRAFT_LAYERS, SPEC_DRAFT_SEED = 2, 1
SPEC_CACHE = dict(num_pages=72, pages_max=8, batch=8, page=64)
SPEC_SCAN_CACHE = dict(num_pages=48, pages_max=3, batch=8, page=64)
SPEC_DEVICE_REPS = 3
SPEC_ARMS = ("h1", "spec_same_sync", "spec_same_overlap", "spec_draft2_sync",
             "spec_lookup_sync")
# serve_spec_int8 runs the first three: the two-layer draft's and prompt
# lookup's paths are the bf16 phase's, so the whole script keeps room under
# its time limit on a slow host
SPEC_INT8_ARMS = SPEC_ARMS[:3]


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
    fault).  Each request takes SPEC_CHECK_NEW tokens.  -> (tokens per
    request, [SPEC_CHECK_NEW - 1, V] fp32 logits per request of its tokens
    1.., recorded)."""
    import paddle_tpu_torch.models.paged_decode as pd
    from paddle_tpu_torch.models.serving_engine import (
        ContinuousBatchingEngine, SpecConfig)
    new = SPEC_CHECK_NEW
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
                if n + j < new:
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
        done = spec_serve(torch, eng, reqs, new, True)
    if cache.audit()["owned"] or dcache.audit()["owned"]:
        fail("serve_spec: the recorded run left pages owned")
    gens = [r.generated for r in done]
    logits = [torch.stack([rec[r.rid][j] for j in range(1, new)])
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
                     dev="cuda", arms=SPEC_ARMS):
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
    limit.  ``arms`` names the arms to run (the first three are needed).
    -> the launches of the timed arms."""
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
    dparams = dcache2 = None
    if "spec_draft2_sync" in arms:
        dparams = init_params(dcfg, SPEC_DRAFT_SEED, dev)
        if kv_quant:
            dparams = quantize_params_int8(dparams)
        dcache2 = PagedKVCache(dcfg, kv_quant=kv_quant, device=dev,
                               **SPEC_CACHE)
    same = SpecConfig(gamma=SPEC_GAMMA, draft_cfg=cfg, draft_params=params,
                      draft_cache=dcache)
    arms_cfg = [
        ("h1", None, False, None),
        ("spec_same_sync", same, False, cfg),
        ("spec_same_overlap", same, True, cfg)]
    if "spec_draft2_sync" in arms:
        arms_cfg.append(("spec_draft2_sync", SpecConfig(
            gamma=SPEC_GAMMA, draft_cfg=dcfg, draft_params=dparams,
            draft_cache=dcache2), False, dcfg))
    if "spec_lookup_sync" in arms:
        arms_cfg.append(("spec_lookup_sync", SpecConfig(
            gamma=SPEC_LOOKUP_GAMMA, source="prompt_lookup"), False, None))
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
        if c is not None and c.audit()["owned"]:
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
         arms=list(arms), gamma=SPEC_GAMMA, lookup_gamma=SPEC_LOOKUP_GAMMA,
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
# LLaMA-7B: 6 requests of 256 prompt tokens, batch 4, 18 pages of 64,
# pages_max 8, a host tier of 64 pages; 72 new tokens where the recipe has
# 192 (a cut for the run's time limit: 72 decodes three eighths of the
# steps, and a request still ends at 6 pages (256 + 72 > 5 x 64), so the
# pool holds three at their end and every admission wave still preempts at
# its rows' first page of growth)
SWAP_REQUESTS, SWAP_PROMPT, SWAP_NEW = 6, 256, 72
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
             host=True, overlap=False, lane_kw=None, no_sync=False,
             warm=True):
    """One timed arm: an engine (its own registry) over a fresh cache,
    warmed (``warm``; the stats say whether) on the first batch + 1 prompts
    at SWAP_SHORT_NEW tokens, then timed on every prompt at SWAP_NEW with the launch counts
    set to 0 just before.  -> (tokens per request, stats, launches, engine,
    cache, the swap watch)."""
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
    warmed = swap_serve(torch, eng, prompts[:cache.tables.shape[0] + 1],
                        SWAP_SHORT_NEW) if warm else []
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
    for r in done + warmed:
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
        warm=warm,
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
            dev, host=False, lane_kw=lane_kw, warm=False)
        arms["a_recompute_sync"] = a
        add(launches)
        served, b, launches, eng, cache, watch = swap_arm(
            torch, cfg, params, mods, prompts, phase, "(b) swap sync", None,
            dev, lane_kw=lane_kw, warm=False)
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
                      resume_ms_ratio_warm=(arms["a_recompute_sync"]["warm"]
                                            and arms["b_swap_sync"]["warm"]),
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


# serve_qos: QoS (priority classes, class-aware shedding, tenant quotas,
# priority preemption) and the in-process fleet at LLaMA-7B.  The fleet
# recipe is bench.py's _serving_qos_line TPU settings (bench.py:1168-1177):
# batch 8, pages of 64, 96 pages, pages_max 8, 32 new tokens, a queue of 8
# a replica, at most 3 replicas, waves of (4, 6, 8, 10, 10, 8) requests 3
# router steps apart, prompts of 48 / 96 / 160 / 220 tokens in the class
# mix 1 high : 2 normal : 2 low, the autoscaler's band 512 / 64 queued
# tokens a replica.  (a)'s preemption arms use the same cache: a full batch
# of lows of the recipe's lengths, each with a budget of its own (20-34
# tokens, the port's choice: no two retire at one step, so the resume waves
# are the same on every lane), then two highs of 96 and 160 tokens.
QOS_CACHE = dict(num_pages=96, pages_max=8, batch=8, page=64)
QOS_QUEUE_CAP, QOS_MAX_REPLICAS = 8, 3
QOS_WAVES = (4, 6, 8, 10, 10, 8)
QOS_STEPS_PER_WAVE = 3
QOS_PROMPT_LENS = (48, 96, 160, 220)
QOS_CLASSES = ("high", "normal", "normal", "low", "low")
# the recipe's 32 new tokens a request, cut to 6 in the fleet for the
# script's time limit (and the preemption arms' lows to 6-13 and highs to
# 6); the shedding burst, which steps nothing, keeps 32, and every gate
# stands
QOS_NEW, QOS_SHED_NEW = 6, 32
QOS_HIGH_QT, QOS_LOW_QT = 512.0, 64.0
QOS_LOW_NEWS = (6, 7, 8, 9, 10, 11, 12, 13)
QOS_HIGH_LENS, QOS_HIGH_NEW = (96, 160), 6
# a retired replica gives back its pool, graphs and workspaces: the walk
# back to one replica ends within QOS_MEM_SLACK of the fixed arm's
# allocated memory; no replica copies the weights: an arm's peak stays
# within 3 pools and QOS_PEAK_SLACK of the memory before its first replica
QOS_MEM_SLACK = 64 * 2**20
QOS_PEAK_SLACK = 4 * 2**30
# (a)'s shedding burst (nothing stepped): a quota check on tenant "t" (rate
# 100 tokens/s, burst 600, the clock pinned), then 24 requests in the
# recipe's class mix and lengths against the queue of 8
QOS_BURST = 24
QOS_QUOTA = dict(rate_tokens_per_s=100.0, burst_tokens=600.0)
# a failed-over request's tokens are held against the plain forward over
# its own sequence: each served token's plain logit within twice the serve's
# logit bar of the plain argmax (served logits lie within LOGIT_LIMIT of the
# plain ones, so a greedy pick of the served logits lies within 2 x of the
# plain argmax; a token equality with one engine would also compare batch
# compositions, which bf16 GEMMs do not keep bit for bit).  (b) checks this
# many of the kill arm's failed-over requests, (c) its queued one; a planted
# fault (the prompt's last token lost in the move) must land beyond the bar.
QOS_FAILOVER_SAMPLE = 4


def qos_shed_burst(se, eng, prompts):
    """The quota check and the shedding burst on ``eng`` (the clock pinned,
    nothing stepped) -> (each submission's verdict, counts per class)."""
    eng.quotas = se.TenantQuotas(**QOS_QUOTA)
    clock = [1000.0]
    eng._now = lambda: clock[0]
    out = []
    per = {c: {"admitted": 0, "degraded": 0, "rejected": 0}
           for c in se.PRIORITIES}

    def submit(p, cls, tenant=None):
        try:
            rid = eng.submit(p, max_new_tokens=QOS_SHED_NEW, priority=cls,
                             tenant=tenant)
        except se.QuotaExceededError as e:
            out.append(("quota", e.tenant, round(e.retry_after, 6)))
            return
        except se.QueueFullError as e:
            out.append(("rejected", cls, "hard bound" in str(e)))
            per[cls]["rejected"] += 1
            return
        kind = "degraded" if eng._queue[-1].degraded else "admitted"
        assert eng._queue[-1].rid == rid
        out.append((kind, cls))
        per[cls][kind] += 1

    big = prompts[QOS_PROMPT_LENS.index(220)]       # cost 220 + 32 = 252
    for _ in range(3):
        submit(big, "normal", "t")
    clock[0] += out[-1][2] + 1e-6                    # the hinted refill
    submit(big, "normal", "t")
    for i in range(QOS_BURST):
        submit(prompts[i % len(prompts)], QOS_CLASSES[i % 5])
    return out, per


def qos_shedding(torch, cfg, params, dev):
    """(a)'s burst on a card engine at LLaMA-7B and on the port's CPU
    engine (a 2-layer model on the same cache geometry: the verdicts read
    the queue, the lengths and the classes only) -> the line's fields."""
    import paddle_tpu_torch.models.serving_engine as se
    from paddle_tpu_torch.models.llama_pretrain import (
        LlamaPretrainConfig, init_params)
    from paddle_tpu_torch.models.paged_decode import PagedKVCache
    rng = np.random.RandomState(3)
    prompts = [rng.randint(1, cfg.vocab_size, (L,)) for L in QOS_PROMPT_LENS]
    eng = se.ContinuousBatchingEngine(
        cfg, params, PagedKVCache(cfg, device=dev, **QOS_CACHE),
        max_queue_len=QOS_QUEUE_CAP, metrics_registry=False)
    card, per = qos_shed_burst(se, eng, prompts)
    tiny = LlamaPretrainConfig(vocab_size=128, hidden_size=64,
                               intermediate_size=128, num_hidden_layers=2,
                               num_attention_heads=4, num_key_value_heads=2,
                               dtype=torch.float32)
    ceng = se.ContinuousBatchingEngine(
        tiny, init_params(tiny, 0, "cpu", dtype=torch.float32),
        PagedKVCache(tiny, device="cpu", **QOS_CACHE),
        max_queue_len=QOS_QUEUE_CAP, metrics_registry=False)
    cpu, cpu_per = qos_shed_burst(se, ceng, [p % 128 for p in prompts])
    # nothing was stepped: cancel the burst, one step retires it unserved
    for r in list(eng._queue):
        eng.cancel(r.rid)
    eng.step()
    cancelled = sum(r.status == "cancelled" for r in eng.finished())
    if card != cpu or per != cpu_per:
        fail(f"serve_qos: the shedding verdicts on the card {per} differ "
             f"from the CPU engine's {cpu_per}")
    quota = [v for v in card if v[0] == "quota"]
    want_hint = (252 - (600 - 2 * 252)) / QOS_QUOTA["rate_tokens_per_s"]
    if len(quota) != 1 or quota[0][1] != "t" or \
            abs(quota[0][2] - want_hint) > 1e-9 or card[3][0] != "admitted":
        fail(f"serve_qos: the quota check gave {card[:4]}, want the third "
             f"charge refused with retry_after {want_hint} and the fourth "
             f"admitted after the refill")
    if not per["low"]["rejected"] or per["high"]["rejected"] > \
            per["low"]["rejected"] or not per["normal"]["degraded"]:
        fail(f"serve_qos: the burst shed {per}: want lows rejected, "
             f"normals degraded")
    queued = sum(v[0] in ("admitted", "degraded") for v in card)
    if eng.cache.audit()["owned"] or cancelled != queued:
        fail(f"serve_qos: the cancelled burst left {eng.cache.audit()} "
             f"({cancelled} cancelled)")
    return dict(verdicts_per_class=per, equal_to_cpu_engine=True,
                quota_retry_after_s=quota[0][2])


def qos_preempt_run(torch, cfg, params, mods, dev, kv_quant=None,
                    lane_kw=None, host_pages=0, record=False, forced=None,
                    fault=False):
    """One priority-preemption arm: a full batch of lows (QOS_LOW_NEWS),
    two steps, then two highs, stepped to the end, the launch counts set
    to 0 just before and read just after (graph replays included).
    ``record`` keeps every decode step's logits by (request, position),
    and on the mixed lane each tick's first tokens' too; ``forced``
    ({index: tokens}) forces every token; ``fault`` plants attention over
    lens instead of lens + 1 in every decode layer.  -> (tokens by index,
    stats, logits, launches, prompts)."""
    import paddle_tpu_torch.models.paged_decode as pd
    from paddle_tpu_torch.models.paged_decode import PagedKVCache
    from paddle_tpu_torch.models.serving_engine import (
        ContinuousBatchingEngine)
    from paddle_tpu_torch.observability import MetricsRegistry
    rng = np.random.RandomState(1)
    prompts = [rng.randint(1, cfg.vocab_size, (QOS_PROMPT_LENS[i % 4],))
               for i in range(len(QOS_LOW_NEWS))]
    prompts += [rng.randint(1, cfg.vocab_size, (L,)) for L in QOS_HIGH_LENS]
    news = list(QOS_LOW_NEWS) + [QOS_HIGH_NEW] * len(QOS_HIGH_LENS)
    cache = PagedKVCache(cfg, kv_quant=kv_quant, host_pages=host_pages,
                         device=dev, **QOS_CACHE)
    eng = ContinuousBatchingEngine(cfg, params, cache,
                                   metrics_registry=MetricsRegistry(),
                                   **(lane_kw or {}))
    if host_pages:
        eng.offload_swap_gbps = 1e9            # the swap always wins
    watch = swap_watch(torch, eng, cache, mods) if host_pages else None
    rec, index = {}, {}
    real_pick, emit_first = pd._pick_token, eng._emit_first
    # a mixed tick picks twice, by slot: its decode rows, then the first
    # tokens of the rows whose prefill ends in it (p_sample)
    tick = {"first": None, "calls": 0}

    def pick(logits, temperature, generator=None, top_k=0, top_p=1.0):
        tok = real_pick(logits, temperature, generator, top_k, top_p)
        if tick["first"] is not None and tick["calls"] == 1:
            rows = tick["first"]
        else:
            rows = [(s, r, len(r.generated)) for s, r in eng._active.items()]
        tick["calls"] += 1
        for s, r, n in rows:
            i = index[r.rid]
            if record:
                rec.setdefault(i, {})[n] = logits[s].float().clone()
            if forced is not None:
                tok[s] = forced[i][n]
        return tok

    step_mixed = eng._step_mixed

    def stepper(*a):
        tick["first"] = [(s, eng._mixed_pref[s]["req"], 0)
                         for s in a[-3].nonzero()[:, 0].tolist()]
        tick["calls"] = 0
        try:
            return step_mixed(*a)
        finally:
            tick["first"] = None

    def emit(reqs, slots, toks):
        for k, r in enumerate(reqs):
            if not r.generated:
                toks[k] = forced[index[r.rid]][0]
        return emit_first(reqs, slots, toks)

    seams = [(pd, "_pick_token", pick)] if record or forced else []
    if forced is not None:
        eng._emit_first = emit
    if seams and step_mixed is not None:
        eng._step_mixed = stepper
    if fault:
        name = ("paged_decode_attention_q8" if kv_quant
                else "paged_decode_attention")
        real = getattr(pd, name)
        seams.append((pd, name, lambda *a: real(*a[:-1], a[-1] - 1)))
    graphs0 = graph_state()
    zero_counts(mods)
    t0 = time.perf_counter()
    with patched(*seams):
        low = len(QOS_LOW_NEWS)
        for i in range(low):
            index[eng.submit(prompts[i], max_new_tokens=news[i],
                             priority="low")] = i
        eng.step()
        eng.step()
        for i in range(low, len(prompts)):
            index[eng.submit(prompts[i], max_new_tokens=news[i],
                             priority="high")] = i
        done = {r.rid: r for r in eng.run_to_completion()}
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ran_launches(read_counts(mods), graphs0)
    replayed, _ = graph_launches(graphs0)
    arm = f"preemption arm {lane_kw or 'sync'}, host_pages {host_pages}"
    gens = [None] * len(prompts)
    for rid, i in index.items():
        r = done.get(rid)
        if r is None or r.status != "ok" or len(r.generated) != news[i]:
            fail(f"serve_qos: {arm}: request {i} ended "
                 f"{None if r is None else (r.status, len(r.generated))}")
        gens[i] = list(r.generated)
    victims = [(index[e["rid"]], e["mode"])
               for e in eng.metrics.ring.recent()
               if e["name"] == "preemption"]
    preempted = {index[rid]: r.preempted for rid, r in done.items()}
    swap_clean("serve_qos", arm, cache)
    stats = dict(wall_s=wall, decode_tok_s=sum(map(len, gens)) / wall,
                 preemptions=eng.preemptions,
                 resumes_recompute=eng.resumes_recompute,
                 resumes_swapped=eng.resumes_swapped,
                 pipeline_flushes=eng.pipeline_flushes, victims=victims,
                 preempted_highs=[i for i in range(low, len(prompts))
                                  if preempted[i]],
                 k1_from_replays=replayed.get("paged_decode_attention", 0))
    if watch is not None:
        stats.update(round_trip_pages=watch["pages"],
                     round_trip_unequal=sum(1 for e in watch["equal"]
                                            if not bool(e)),
                     swap_out_refused=watch["refused"],
                     swapped_resumes_with_prefill=watch["prefill"])
    return gens, stats, rec, launches, prompts


def qos_logit_diff(torch, cfg, params, prompts, gens, rec, dev, kv_q8):
    """The recorded decode logits against the plain forward over the same
    sequences (int8 weights through their plain matmul)."""
    import paddle_tpu_torch.models.llama_pretrain as tlp
    from paddle_tpu_torch.ops import int8_matmul as im
    diff = 0.0
    with patched((tlp, "int8_matmul", im.int8_matmul_plain)):
        for i, rows in rec.items():
            plain = plain_logits(torch, cfg, params,
                                 list(prompts[i]) + gens[i][:-1], dev,
                                 kv_q8=kv_q8)
            off = len(prompts[i]) - 1
            for n, lg in rows.items():
                diff = max(diff, float((lg - plain[off + n]).abs().max()))
    return diff


def qos_preemption(torch, cfg, params, mods, dev):
    """(a)'s priority preemption: the sync, overlap, host-tier (swap) and
    mixed arms in bf16 and a sync arm on int8 weights over int8 pages, each
    served schedule's decode logits (the mixed ticks' first tokens too)
    against the plain forward and a planted fault's beyond the bar.  The
    mixed arm preempts at the carve, the port's departure from JAX's
    carve, which waits for a seat.  -> (line fields, launches)."""
    from paddle_tpu_torch.models import graphed_step
    from paddle_tpu_torch.models.decode import quantize_params_int8
    total, arms, checks = {}, {}, {}

    def add(launches):
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v

    def checked(name, params, kv_quant, **kw):
        gens, st, rec, launches, prompts = qos_preempt_run(
            torch, cfg, params, mods, dev, kv_quant=kv_quant, record=True,
            **kw)
        add(launches)
        q8 = kv_quant == "int8"
        diff = qos_logit_diff(torch, cfg, params, prompts, gens, rec, dev, q8)
        positions = sum(map(len, rec.values()))
        del rec
        _, _, rec, _, _ = qos_preempt_run(
            torch, cfg, params, mods, dev, kv_quant=kv_quant, record=True,
            forced=gens, fault=True, **kw)
        fault = qos_logit_diff(torch, cfg, params, prompts, gens, rec, dev,
                               q8)
        del rec
        limit = INT8_LOGIT_LIMIT if q8 else LOGIT_LIMIT
        arms[name] = st
        checks[name] = dict(positions=positions, logit_max_abs_diff=diff,
                            logit_limit=limit,
                            planted_fault_max_abs_diff=fault)
        if diff > limit:
            fail(f"serve_qos: {name}: the served schedule's teacher-forced "
                 f"logits differ from the plain forward's by {diff} (limit "
                 f"{limit})")
        if fault <= limit:
            fail(f"serve_qos: {name}: the planted fault moved the logits by "
                 f"only {fault}, within the limit {limit}")
        return gens, launches

    sync, _ = checked("sync", params, None)
    over, st, _, launches, _ = qos_preempt_run(
        torch, cfg, params, mods, dev, lane_kw={"overlap": True})
    arms["overlap"] = st
    add(launches)
    if over != sync:
        i = next(i for i in range(len(sync)) if over[i] != sync[i])
        fail(f"serve_qos: the overlap arm's request {i} differs from the "
             f"synchronous arm's ({over[i]} against {sync[i]})")
    if st["k1_from_replays"] <= 0:
        fail("serve_qos: the overlap arm launched K1 from no graph replay")
    graphed_step.clear()
    checked("host_tier", params, None, host_pages=64)
    checked("mixed", params, None, lane_kw={"mixed": True})
    qparams = quantize_params_int8(params)
    _, launches = checked("int8", qparams, "int8")
    for name in ("paged_decode_attention_q8", "flash_attention_segmented",
                 "int8_matmul", "int8_matmul_wave"):
        if launches.get(name, 0) <= 0:
            fail(f"serve_qos: the int8 arm did not launch {name}")
    del qparams
    low = len(QOS_LOW_NEWS)
    for name, st in arms.items():
        # two highs, each evicting the youngest low: 7, then 6
        if [v for v, _ in st["victims"]] != [low - 1, low - 2] or \
                st["preempted_highs"]:
            fail(f"serve_qos: {name}: victims {st['victims']}, churned highs "
                 f"{st['preempted_highs']}: want the lows {low - 1} then "
                 f"{low - 2}, no high")
        want = "swap" if name == "host_tier" else "recompute"
        if any(m != want for _, m in st["victims"]):
            fail(f"serve_qos: {name}: victims {st['victims']}, want {want}")
        resumed = st["resumes_swapped" if want == "swap"
                     else "resumes_recompute"]
        if resumed != 2:
            fail(f"serve_qos: {name}: {resumed} victims resumed by {want}")
    host = arms["host_tier"]
    if host["round_trip_unequal"] or not host["round_trip_pages"] or \
            host["swap_out_refused"] or host["swapped_resumes_with_prefill"]:
        fail(f"serve_qos: the host-tier arm's round trip: {host}")
    for name in ("paged_decode_attention", "flash_attention_segmented",
                 "segment_tile_ranges"):
        if total.get(name, 0) <= 0:
            fail(f"serve_qos: the bf16 arms did not launch {name}")
    return dict(arms=arms, checks=checks, overlap_equals_sync=True), total


def qos_greedy_gap(torch, cfg, params, prompt, gen, dev, lost=False):
    """The plain forward over ``prompt`` + ``gen``: the largest margin by
    which its argmax stands above a served token's logit.  ``lost`` drops
    the prompt's last token (the planted fault)."""
    ctx = [int(t) for t in prompt][:-1 if lost else None]
    gen = [int(t) for t in gen]
    plain = plain_logits(torch, cfg, params, ctx + gen[:-1], dev).float()
    rows = plain[len(ctx) - 1:]
    picked = rows.gather(1, torch.tensor(gen, device=rows.device)[:, None])
    return float((rows.max(-1).values - picked[:, 0]).max())


def qos_failover_tokens(torch, cfg, params, dev, part, seqs):
    """Hold the failed-over ``seqs`` ((prompt, tokens) pairs) against the
    plain forward, and a planted fault beyond the bar -> line fields."""
    limit = 2 * LOGIT_LIMIT
    if not seqs:
        fail(f"serve_qos: {part}: no failed-over request to check")
        return {}
    gaps = [qos_greedy_gap(torch, cfg, params, p, g, dev) for p, g in seqs]
    fault = max(qos_greedy_gap(torch, cfg, params, p, g, dev, lost=True)
                for p, g in seqs)
    if max(gaps) > limit:
        fail(f"serve_qos: {part}: a failed-over request's tokens stand "
             f"{max(gaps)} below the plain forward's argmax (limit {limit})")
    if fault <= limit:
        fail(f"serve_qos: {part}: the planted fault moved the margin by "
             f"only {fault}, within the limit {limit}")
    return dict(requests=len(seqs), tokens=sum(len(g) for _, g in seqs),
                greedy_margin_max=max(gaps), limit=limit,
                planted_fault="the prompt's last token lost",
                planted_fault_margin=fault)


def qos_fleet_arm(torch, cfg, params, mods, dev, load, warm, autoscale,
                  kill_wave=None):
    """One arm of bench.py's _serving_qos_line at LLaMA-7B: the ramped
    mixed-class load through a 1-replica FleetRouter, under a
    FleetAutoscaler when ``autoscale``, with replica_death injected after
    wave ``kill_wave``; every replica factory closes over ``params``.
    -> (the arm's fields, launches)."""
    import gc
    from paddle_tpu_torch.fleet import FleetAutoscaler, FleetRouter
    from paddle_tpu_torch.models.paged_decode import PagedKVCache
    from paddle_tpu_torch.models.serving_engine import (
        ContinuousBatchingEngine, QueueFullError)
    from paddle_tpu_torch.testing import faults

    def factory():
        return ContinuousBatchingEngine(
            cfg, params, PagedKVCache(cfg, device=dev, **QOS_CACHE),
            max_queue_len=QOS_QUEUE_CAP, metrics_registry=False)

    def live(router):
        return sum(1 for h in router._replicas
                   if h.state in ("READY", "DEGRADED") and not h.retiring)

    def mem():
        gc.collect()
        torch.cuda.synchronize()
        return dict(allocated=torch.cuda.memory_allocated(),
                    reserved=torch.cuda.memory_reserved())

    base = mem()
    torch.cuda.reset_peak_memory_stats()
    router = FleetRouter([factory], metrics_registry=False)
    c0 = router._replicas[0].engine.cache
    pool = sum(t.numel() * t.element_size() for t in (c0.kpool, c0.vpool))
    del c0
    for p in warm:
        router.submit(p, max_new_tokens=2)
    router.run_to_completion()
    start = mem()
    asc = FleetAutoscaler(
        router, factory, min_replicas=1, max_replicas=QOS_MAX_REPLICAS,
        high_queued_tokens=QOS_HIGH_QT, low_queued_tokens=QOS_LOW_QT,
        up_consecutive=1, down_consecutive=2,
        cooldown_s=0.0) if autoscale else None
    cls_of, rejected, traj, done = {}, {}, [], []
    prompt_of, moved_rids = {}, set()
    top, at_top = 1, start
    fp = faults.install() if kill_wave is not None else None
    zero_counts(mods)
    t0 = time.perf_counter()
    try:
        for w, wave in enumerate(load):
            for p, c in wave:
                try:
                    rid = router.submit(p, max_new_tokens=QOS_NEW,
                                        priority=c)
                    cls_of[rid], prompt_of[rid] = c, p
                except QueueFullError:
                    rejected[c] = rejected.get(c, 0) + 1
            if w == kill_wave:
                # nth counts the site's consults: the next replica step dies
                fp.inject("replica_death", RuntimeError("mid-ramp kill"),
                          nth=fp.counts.get("replica_death", 0) + 1)
            for _ in range(QOS_STEPS_PER_WAVE):
                router.step()
                moved_rids.update(rid for rid, f in router._requests.items()
                                  if f.failovers)
            if asc:
                asc.tick()
            traj.append(live(router))
            if traj[-1] > top:
                top = traj[-1]
                at_top = dict(allocated=torch.cuda.memory_allocated(),
                              reserved=torch.cuda.memory_reserved())
            done.extend(router.finished())
        done.extend(router.run_to_completion())
    finally:
        if fp is not None:
            faults.uninstall()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts(mods)
    if asc:                               # drained: walk back to one
        for _ in range(8):
            asc.tick()
            router.step()
            traj.append(live(router))
            if traj[-1] == 1 and all(h.state != "DRAINING"
                                     for h in router._replicas):
                break
    owned = [h.engine.cache.audit()["owned"] for h in router._replicas
             if h.state not in ("DEAD", "RETIRED")]
    # one live replica now (the walk back, or the fixed arm's own)
    end = mem()
    ok = [r for r in done if r.status == "ok"]
    finished = {r.rid for r in done}
    ttft = {c: [(r.t_first_token - r.t_submit) * 1000 for r in ok
                if cls_of.get(r.rid) == c and r.t_first_token]
            for c in ("high", "normal", "low")}
    out = dict(
        requests_offered=sum(len(w) for w in load), accepted=len(cls_of),
        ok=len(ok), errored=sum(r.status == "error" for r in done),
        rejected_by_class=rejected,
        degraded=sum(1 for r in done if r.degraded),
        tok_per_s=sum(len(r.generated) for r in ok) / wall, wall_s=wall,
        ttft_p99_ms_by_class={c: pctl(v, 99) for c, v in ttft.items()},
        replica_trajectory=traj, deaths=router.deaths,
        replaces=router.replaces, failovers=router.failovers,
        live_replicas_at_end=live(router),
        memory_before_replicas=base, memory_start=start,
        memory_at_peak_replicas=dict(at_top, replicas=top),
        memory_end=end, peak_allocated=torch.cuda.max_memory_allocated())
    if asc:
        out.update(scale_ups=asc.scale_ups, scale_downs=asc.scale_downs,
                   skipped_settling=asc.skipped_settling)
    drops = sorted(set(cls_of) - finished)
    moved = [(prompt_of[r.rid], list(r.generated)) for r in ok
             if r.rid in moved_rids]
    out["failed_over_ok"] = len(moved)
    # the plane's exception holds the router's frames: drop it too
    del router, asc, done, ok, fp
    out["memory_router_gone"] = mem()
    return out, launches, drops, owned, pool, moved


def qos_fleet(torch, cfg, params, mods, dev):
    """(b): the three arms of bench.py's _serving_qos_line at LLaMA-7B and
    their gates.  -> (line fields, launches)."""
    rng = np.random.RandomState(0)
    load = [[(rng.randint(1, cfg.vocab_size,
                          (QOS_PROMPT_LENS[j % len(QOS_PROMPT_LENS)],)),
              QOS_CLASSES[j % len(QOS_CLASSES)]) for j in range(nw)]
            for nw in QOS_WAVES]
    warm = [rng.randint(1, cfg.vocab_size, (L,)) for L in QOS_PROMPT_LENS]
    total, arms, moved_by = {}, {}, {}
    for name, kw in (("fixed_1_replica", dict(autoscale=False)),
                     ("autoscaled", dict(autoscale=True)),
                     ("autoscaled_midramp_kill",
                      dict(autoscale=True, kill_wave=len(QOS_WAVES) // 2))):
        arm, launches, drops, owned, pool, moved = qos_fleet_arm(
            torch, cfg, params, mods, dev, load, warm, **kw)
        arms[name], moved_by[name] = arm, moved
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        if drops:
            fail(f"serve_qos: {name}: requests {drops} neither finished nor "
                 f"rejected")
        if any(owned):
            fail(f"serve_qos: {name}: a live replica's audit is not clean "
                 f"({owned} pages owned)")
        limit = arm["memory_before_replicas"]["allocated"] \
            + QOS_MAX_REPLICAS * pool + QOS_PEAK_SLACK
        arm["peak_limit"] = limit
        if arm["peak_allocated"] > limit:
            fail(f"serve_qos: {name}: peak allocated {arm['peak_allocated']} "
                 f"above one weight set + {QOS_MAX_REPLICAS} pools + 4 GiB "
                 f"({limit})")
        for k in ("paged_decode_attention", "flash_attention_segmented"):
            if launches.get(k, 0) <= 0:
                fail(f"serve_qos: {name} did not launch {k}")
    fixed = arms["fixed_1_replica"]["memory_end"]["allocated"]
    for name in ("autoscaled", "autoscaled_midramp_kill"):
        arm = arms[name]
        if max(arm["replica_trajectory"]) < 2 or \
                arm["live_replicas_at_end"] != 1:
            fail(f"serve_qos: {name} walked {arm['replica_trajectory']}: "
                 f"want a scale-up and the walk back to one replica")
        if arm["memory_end"]["allocated"] - fixed > QOS_MEM_SLACK:
            fail(f"serve_qos: {name}: {arm['memory_end']['allocated']} "
                 f"bytes allocated after the walk back to one replica, "
                 f"more than 64 MiB above the fixed arm's {fixed}")
    kill = arms["autoscaled_midramp_kill"]
    if kill["deaths"] != 1 or kill["replaces"] != 1:
        fail(f"serve_qos: the kill arm saw {kill['deaths']} deaths and "
             f"{kill['replaces']} replacements, want one each")
    kill["failover_tokens"] = qos_failover_tokens(
        torch, cfg, params, dev, "(b) the kill arm",
        moved_by["autoscaled_midramp_kill"][:QOS_FAILOVER_SAMPLE])
    return dict(arms=arms, source="bench.py:1141 _serving_qos_line, TPU "
                "recipe (bench.py:1168-1177)"), total


def qos_http_call(url, payload=None, timeout=600):
    """POST ``payload`` (or GET) -> (code, body, headers)."""
    import urllib.error
    import urllib.request
    data = None if payload is None else json.dumps(payload).encode()
    try:
        with urllib.request.urlopen(urllib.request.Request(url, data=data),
                                    timeout=timeout) as r:
            return r.status, r.read(), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, e.read(), dict(e.headers)


def qos_stream(url, payload, lines, timeout=600):
    """POST ``payload`` to /generate_stream, appending each line's JSON to
    ``lines`` as it arrives."""
    import urllib.request
    req = urllib.request.Request(url + "/generate_stream",
                                 data=json.dumps(payload).encode())
    with urllib.request.urlopen(req, timeout=timeout) as r:
        for line in r:
            if line.strip():
                lines.append(json.loads(line))


def qos_http(torch, cfg, params, mods, dev):
    """(c): FleetServer over two replicas on the card: priority and tenant
    in the body, a quota 429 with its Retry-After, degraded completions
    flagged in /generate and in the stream, /health's fleet state and the
    fleet instruments in /metrics, then a replica death mid-stream: the
    streamed request ends with an error line while a request queued behind
    it on the same replica (its prefix's owner) fails over and completes.
    The drive loop is gated, so each submission lands where the check
    expects.  -> (line fields, launches)."""
    from paddle_tpu_torch.fleet import FleetRouter, FleetServer
    from paddle_tpu_torch.models.paged_decode import PagedKVCache
    from paddle_tpu_torch.models.serving_engine import (
        ContinuousBatchingEngine, TenantQuotas)
    from paddle_tpu_torch.testing import faults

    def factory():
        return ContinuousBatchingEngine(
            cfg, params, PagedKVCache(cfg, device=dev, **QOS_CACHE),
            max_queue_len=2, metrics_registry=False)

    rng = np.random.RandomState(4)
    prompt = {L: [int(t) for t in rng.randint(1, cfg.vocab_size, (L,))]
              for L in QOS_PROMPT_LENS}
    # tenant "q": 10 tokens/s, burst 150; a 96-token request of 16 costs 112
    router = FleetRouter([factory] * 2, tenant_quotas=TenantQuotas(
        rate_tokens_per_s=10.0, burst_tokens=150.0))
    router._now = lambda: 1000.0          # pinned: the bucket never refills
    allow = [0]                           # steps the drive loop may take
    has_work = router.has_work

    def gated():
        if allow[0] == 0:
            return False
        if allow[0] > 0:
            allow[0] -= 1
        return has_work()

    router.has_work = gated
    srv = FleetServer(router)
    url = f"http://127.0.0.1:{srv.start()}"
    res, threads, problems = {}, [], []

    def start(key, payload, stream=False):
        n = router._next_rid

        def run():
            try:
                if stream:
                    res[key] = []
                    qos_stream(url, payload, res[key])
                else:
                    res[key] = qos_http_call(url + "/generate", payload)
            except Exception as e:
                res.setdefault(key + "_error", f"{type(e).__name__}: {e}")
        th = threading.Thread(target=run, daemon=True)
        th.start()
        threads.append(th)
        t0 = time.perf_counter()
        while router._next_rid == n and not (key in res and not stream) \
                and key + "_error" not in res:
            if time.perf_counter() - t0 > 60:
                fail(f"serve_qos: HTTP request {key} was never placed")
            time.sleep(0.001)
        return router._next_rid - 1

    def body(L, new, **kw):
        return {"prompt": prompt[L], "max_new_tokens": new, **kw}

    zero_counts(mods)
    t0 = time.perf_counter()
    try:
        start("q1", body(96, 16, tenant="q"))
        start("q2", body(96, 16, tenant="q"))
        for k, cls in (("f0", "high"), ("f1", "low"), ("f2", "high")):
            start(k, body(48, 16, priority=cls))
        queues = [len(h.engine._queue) for h in router._replicas]
        start("d_gen", body(160, 16))
        start("d_stream", body(220, 16), stream=True)
        allow[0] = -1
        for th in threads:
            th.join(timeout=600)
        code, health, _ = qos_http_call(url + "/health")
        _, metrics, _ = qos_http_call(url + "/metrics")
        health = json.loads(health)
        metrics = metrics.decode()
        # the death: S streams from one replica, Q (S's first two pages)
        # queues behind it there; that replica's next step dies
        while has_work():
            time.sleep(0.01)
        allow[0] = 0
        threads.clear()
        base = prompt[220][:128]
        s_rid = start("s", {"prompt": base + prompt[48][:16],
                            "max_new_tokens": 48}, stream=True)
        s_rep = router._requests[s_rid].replica
        allow[0] = 1
        t1 = time.perf_counter()
        while not res.get("s") and time.perf_counter() - t1 < 60:
            time.sleep(0.001)
        q_rid = start("q", {"prompt": base + prompt[48][16:40],
                            "max_new_tokens": 16})
        q_rep, q_streamed = (router._requests[q_rid].replica,
                             router._requests[q_rid].streamed)
        fp = faults.install()
        fp.inject("replica_death", RuntimeError("killed mid-stream"),
                  nth=fp.counts.get("replica_death", 0) + 1)
        allow[0] = -1
        for th in threads:
            th.join(timeout=600)
        t1 = time.perf_counter()
        while router.replaces < 1 and time.perf_counter() - t1 < 60:
            time.sleep(0.01)
    finally:
        faults.uninstall()
        srv.stop()
    wall = time.perf_counter() - t0
    launches = read_counts(mods)
    snap = router.fleet_snapshot()
    owned = [h.engine.cache.audit()["owned"] for h in router._replicas
             if h.state == "READY"]
    errors = {k: v for k, v in res.items() if k.endswith("_error")}
    # the checks
    q1, q2 = res.get("q1"), res.get("q2")
    if not q1 or q1[0] != 200 or not q2 or q2[0] != 429 or \
            b"quota" not in q2[1] or q2[2].get("Retry-After") != "8":
        got = q2 and (q2[0], q2[1][:80], q2[2].get("Retry-After"))
        problems.append(f"quota: {q1 and q1[0]}, {got}, want 200 then 429 "
                        f"quota with Retry-After 8")
    for k in ("f0", "f1", "f2"):
        if not res.get(k) or res[k][0] != 200 or \
                len(json.loads(res[k][1])["tokens"]) != 16:
            problems.append(f"{k}: {res.get(k) and res[k][0]}")
    if queues != [2, 2]:
        problems.append(f"the replicas' queues before the normals: {queues}")
    d = res.get("d_gen")
    doc = json.loads(d[1]) if d and d[0] == 200 else {}
    if doc.get("degraded") is not True or len(doc.get("tokens", ())) != 8:
        problems.append(f"/generate degraded: {d and d[0]} {doc}")
    last = (res.get("d_stream") or [{}])[-1]
    if last.get("degraded") is not True or len(last.get("tokens", ())) != 8:
        problems.append(f"/generate_stream's last line: {last}")
    if health.get("fleet", {}).get("states", {}).get("READY") != 2 or \
            not health.get("ready"):
        problems.append(f"/health: {health}")
    for name in ("paddle_tpu_fleet_replicas_ready_count 2",
                 "paddle_tpu_fleet_quota_rejected_total 1",
                 "paddle_tpu_fleet_routed_least_loaded_total"):
        if name not in metrics:
            problems.append(f"/metrics lacks {name!r}")
    s_last = (res.get("s") or [{}])[-1]
    if "died" not in str(s_last.get("error", "")) or len(res["s"]) < 2:
        problems.append(f"the stream through the death: {res.get('s')}")
    qd = res.get("q")
    q_toks = json.loads(qd[1])["tokens"] if qd and qd[0] == 200 else []
    if q_rep != s_rep or q_streamed or len(q_toks) != 16:
        problems.append(f"the queued request: replica {q_rep} (S on "
                        f"{s_rep}), reply {qd and qd[0]}")
    if (snap["deaths"], snap["failovers"], snap["replaces"]) != (1, 1, 1):
        problems.append(f"deaths / failovers / replaces: {snap['deaths']}, "
                        f"{snap['failovers']}, {snap['replaces']}")
    if errors or any(owned):
        problems.append(f"client errors {errors}, owned pages {owned}")
    for k in ("paged_decode_attention", "flash_attention_segmented"):
        if launches.get(k, 0) <= 0:
            problems.append(f"{k} was not launched")
    if problems:
        fail(f"serve_qos: (c) FleetServer: {problems}")
    moved = qos_failover_tokens(
        torch, cfg, params, dev, "(c) the queued request",
        [(base + prompt[48][16:40], q_toks)] if q_toks else [])
    return dict(wall_s=wall, fleet=snap, retry_after=q2[2]["Retry-After"],
                degraded_generate=doc, degraded_stream_last=last,
                stream_error=s_last.get("error"),
                failover_tokens=moved), launches


def phase_serve_qos(torch, cfg, seed, params, mods, dev="cuda"):
    """(a) QoS on one engine, (b) bench.py's _serving_qos_line recipe
    through the fleet, (c) FleetServer over HTTP, at LLaMA-7B; ``params``
    the bf16 serve's weights (the int8 arm quantizes its own).  -> the
    launches of every part."""
    total, secs = {}, {}

    def add(launches):
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v

    t = time.perf_counter()
    shed = qos_shedding(torch, cfg, params, dev)
    secs["a_shedding"] = time.perf_counter() - t
    t = time.perf_counter()
    pre, launches = qos_preemption(torch, cfg, params, mods, dev)
    add(launches)
    secs["a_preemption"] = time.perf_counter() - t
    torch.cuda.empty_cache()
    t = time.perf_counter()
    fleet, launches = qos_fleet(torch, cfg, params, mods, dev)
    add(launches)
    secs["b_fleet"] = time.perf_counter() - t
    t = time.perf_counter()
    http, launches = qos_http(torch, cfg, params, mods, dev)
    add(launches)
    secs["c_http"] = time.perf_counter() - t
    for name in FLAGGED:
        if total.get(name):
            fail(f"serve_qos: kernel {name} was launched with its flag off")
    emit("serve_qos", model="LLaMA-7B (LlamaPretrainConfig defaults)",
         cache=QOS_CACHE, shedding=shed, preemption=pre, fleet=fleet,
         http=http, part_s=secs, launches=total)
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


# serve_disagg (and serve_disagg_int8): the in-process 1P+1D disaggregated
# pair (paddle_tpu_torch/models/disagg.py) on LLaMA-7B at full width and
# depth, under bench.py's _disagg_line TPU recipe (bench.py:1810-1817):
# batch 8, pages of 64, 128 pages of which a row holds 8, a host tier of 96
# pages on each engine's cache, serve_mixed's four waves of six prompts
# (MIXED_LONG / MIXED_SHORT, one wave every MIXED_WAVE_GAP ticks) with
# MIXED_NEW new tokens plus MIXED_STAGGER for each place in the wave, so the
# unified arm is serve_mixed's synchronous sequential arm on the same
# schedule.  Both engines close over the one weight set; each has its own
# cache.  The route is forced through the hand-off (force_route="prefill"):
# at the CUDA defaults the cost model keeps every LLaMA-7B request colocated
# (the phase prints the flip and the default's verdict).
DISAGG_CACHE = dict(num_pages=128, pages_max=8, batch=8, page=64)
DISAGG_HOST_PAGES = 96
DISAGG_CHECK_WAVES, DISAGG_CHECK_NEW = 2, 24
DISAGG_FAULT_NEW = 8
# (e): a 1 prefill + 1 decode fleet on smaller pools (a functional check)
DISAGG_ROUTER_CACHE = dict(num_pages=48, pages_max=8, batch=4, page=64)
DISAGG_ROUTER_HOST_PAGES = 32


def disagg_caches(cfg, kv_quant, dev):
    from paddle_tpu_torch.models.paged_decode import PagedKVCache
    return [PagedKVCache(cfg, kv_quant=kv_quant, device=dev,
                         host_pages=DISAGG_HOST_PAGES, **DISAGG_CACHE)
            for _ in range(2)]


def disagg_pair(cfg, params, caches, **co_kw):
    from paddle_tpu_torch.models.disagg import (
        DecodeEngine, DisaggCoordinator, PrefillEngine)
    pe = PrefillEngine(cfg, params, caches[0],
                       max_inflight_handoffs=2 * DISAGG_CACHE["batch"])
    de = DecodeEngine(cfg, params, caches[1])
    co = DisaggCoordinator(pe, de, force_route="prefill", **co_kw)
    return pe, de, co


def disagg_drive(drv, sched, new, admitted):
    """bench.py's _ab_drive with serve_mixed's stagger: the waves submitted
    on schedule, one step a tick, the decode step's host wall (the whole
    step on a unified engine, ``last_decode_step_s`` on a coordinator)
    filed under admission when ``admitted()`` says the tick admitted.
    -> (admission ms, quiet ms, the finished requests in submission
    order)."""
    adm, quiet = [], []
    pend = list(enumerate(sched))
    rids, done = [], {}
    tick = 0
    while pend or drv.has_work():
        if pend and tick >= pend[0][0] * MIXED_WAVE_GAP:
            for j, p in enumerate(pend.pop(0)[1]):
                rids.append(drv.submit(p, max_new_tokens=new
                                       + MIXED_STAGGER * j))
        t0 = time.perf_counter()
        drv.step()
        wall = (time.perf_counter() - t0) * 1e3
        ms = wall if not hasattr(drv, "last_decode_step_s") \
            else drv.last_decode_step_s * 1e3
        hit = admitted()
        if ms > 0:
            (adm if hit else quiet).append(ms)
        done.update((r.rid, r) for r in drv.finished())
        tick += 1
        if tick > 5000:
            fail("serve_disagg: the traffic did not drain")
    return adm, quiet, [done[r] for r in rids]


def latency_stats(done):
    """TTFT / TPOT p50 / p99 in ms (bench.py's _ab_lat_stats)."""
    ttft = [(r.t_first_token - r.t_submit) * 1e3 for r in done
            if r.t_first_token]
    tpot = [(r.t_finish - r.t_first_token) * 1e3 / (len(r.generated) - 1)
            for r in done if r.t_first_token and len(r.generated) > 1]
    return dict(ttft_p50_ms=pctl(ttft, 50), ttft_p99_ms=pctl(ttft, 99),
                tpot_p50_ms=pctl(tpot, 50), tpot_p99_ms=pctl(tpot, 99))


def disagg_clean(phase, what, *caches):
    for c in caches:
        a = c.audit()
        if a["owned"] or a.get("swap_records") or \
                a.get("host_free", 0) + a.get("host_indexed", 0) \
                != (c.host.num_pages if c.host is not None else 0):
            fail(f"{phase}: {what} left the pools unclean: {a}")


def disagg_arm(torch, cfg, params, caches, mods, sched, warm, disagg, phase):
    """One timed arm on ``sched`` after a warm-up on ``warm``: the unified
    engine over ``caches[0]`` or the forced 1P+1D pair over both, the
    launch counts set to 0 just before the timed drive.  -> its stats."""
    from paddle_tpu_torch.models.serving_engine import (
        ContinuousBatchingEngine)
    if disagg:
        pe, de, drv = disagg_pair(cfg, params, caches)
        last = {"pf": 0, "sw": 0}

        def admitted():
            # the prefill engine ran a wave or the decode engine restored
            # shipped pages (the pair's admission cost lives in restores)
            hit = (pe.prefill_calls > last["pf"]
                   or de.resumes_swapped > last["sw"])
            last["pf"], last["sw"] = pe.prefill_calls, de.resumes_swapped
            return hit
    else:
        drv = ContinuousBatchingEngine(cfg, params, caches[0])
        last = {"pf": 0}

        def admitted():
            hit = drv.prefill_calls > last["pf"]
            last["pf"] = drv.prefill_calls
            return hit
    disagg_drive(drv, warm, MIXED_WARM_NEW, admitted)
    torch.cuda.synchronize()
    if disagg:
        c0 = dict(routed=dict(drv.routed), shipped=drv.handoffs_shipped,
                  pages=drv.handoff_pages, bytes=drv.handoff_bytes,
                  wall=drv.handoff_wall_s, fallbacks=drv.colocated_fallbacks,
                  de_prefill=de.prefill_calls,
                  avoided=de.prefill_tokens_avoided,
                  pe_steps=pe.decode_steps)
    graphs0 = graph_state()
    zero_counts(mods)
    t0 = time.perf_counter()
    adm, quiet, done = disagg_drive(drv, sched, MIXED_NEW, admitted)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ran_launches(read_counts(mods), graphs0)
    name = "disagg" if disagg else "unified"
    news = mixed_news(sched)
    for r, n in zip(done, news):
        if r.status != "ok" or len(r.generated) != n:
            fail(f"{phase}: the {name} arm's request {r.rid} ended "
                 f"{r.status} with {len(r.generated)} of {n} tokens")
    disagg_clean(phase, f"the {name} arm", *(caches if disagg
                                             else caches[:1]))
    stats = dict(wall_s=wall, requests=len(done),
                 tokens=sum(len(r.generated) for r in done),
                 admission_ticks=len(adm), quiet_ticks=len(quiet),
                 decode_step_p50_during_admission_ms=pctl(adm, 50),
                 decode_step_p99_during_admission_ms=pctl(adm, 99),
                 decode_step_p99_quiet_ms=pctl(quiet, 99),
                 launches=launches, **latency_stats(done))
    if disagg:
        n = len(done)
        routed = {k: drv.routed[k] - c0["routed"][k] for k in drv.routed}
        shipped = drv.handoffs_shipped - c0["shipped"]
        hbytes = drv.handoff_bytes - c0["bytes"]
        hwall = drv.handoff_wall_s - c0["wall"]
        stats.update(
            routed=routed, handoffs_shipped=shipped,
            handoff_pages=drv.handoff_pages - c0["pages"],
            handoff_bytes=hbytes,
            handoff_ms_per_request=1e3 * hwall / max(shipped, 1),
            handoff_gb_per_s=hbytes / hwall / 1e9 if hwall else None,
            colocated_fallbacks=drv.colocated_fallbacks - c0["fallbacks"],
            decode_prefill_calls=de.prefill_calls - c0["de_prefill"],
            prefill_tokens_avoided=(de.prefill_tokens_avoided
                                    - c0["avoided"]),
            prefill_decode_steps=pe.decode_steps - c0["pe_steps"])
        ctx = sum(len(p) for wave in sched for p in wave)
        # (b): no prefill on the decode side, every context token handed
        # off, and the routing counters adding up to the requests
        if stats["decode_prefill_calls"] or stats["prefill_decode_steps"]:
            fail(f"{phase}: the decode engine prefilled "
                 f"({stats['decode_prefill_calls']} waves) or the prefill "
                 f"engine decoded under force_route='prefill'")
        if stats["prefill_tokens_avoided"] != ctx or shipped != n:
            fail(f"{phase}: prefill_tokens_avoided "
                 f"{stats['prefill_tokens_avoided']} (want {ctx}) and "
                 f"{shipped} hand-offs (want {n})")
        if sum(routed.values()) != n or routed["prefill"] != n:
            fail(f"{phase}: the routing counters {routed} do not add up "
                 f"to the {n} requests")
    return stats


def handoff_bits_watch(torch, pe, de):
    """(a): snapshot each row's pages as ``export_row`` sees them and hold
    them against the pages the decode cache restores for that hand-off,
    bit for bit (int8 scale planes included).  -> the watch state."""
    state = {"checked": 0, "bad": []}
    snaps, export_of = {}, {}
    export_row, admit = pe.cache.export_row, de.admit_handoff
    swap_in = de.cache.swap_in_row

    def pages(cache, b, L):
        npg = -(-L // cache.page)
        return page_blocks(torch, cache, cache._owned[b][:npg])

    def export(b):
        snap = [bits(torch, t)
                for t in pages(pe.cache, b, int(pe.cache.lens[b]))]
        st = export_row(b)
        snaps[st["id"]] = snap
        return st

    def adopt(rec):
        local = admit(rec)
        export_of[de._swap_handles[local]] = rec.export["id"]
        return local

    def restore(b, handle):
        eid = export_of.pop(handle, None)
        L = swap_in(b, handle)
        if eid is not None:
            got = [bits(torch, t) for t in pages(de.cache, b, L)]
            if not all(torch.equal(a, g)
                       for a, g in zip(snaps.pop(eid), got)):
                state["bad"].append(eid)
            state["checked"] += 1
        return L

    pe.cache.export_row, de.admit_handoff = export, adopt
    de.cache.swap_in_row = restore
    return state


def disagg_recorded(torch, cfg, params, caches, sched, forced=None,
                    corrupt=False, watch=False):
    """Serve ``sched`` (DISAGG_CHECK_NEW tokens plus the stagger) through
    the forced pair and record every token's logits where an engine
    computes it: each first token in the prefill engine's wave, every
    later one in the decode engine's steps.  ``forced`` ({coordinator rid:
    tokens}) makes the engines emit those tokens (teacher forcing: the
    schedule depends on lengths alone); ``corrupt`` adopts every shipped
    page one slot late (a planted fault of the hand-off); ``watch`` holds
    each hand-off's restored pages against its export bit for bit.  -> (the
    served tokens, logits per request, the watch state, counters)."""
    import paddle_tpu_torch.models.paged_decode as pd
    import paddle_tpu_torch.models.serving_engine as se
    pe, de, co = disagg_pair(cfg, params, caches)
    rec, ctx = {}, {"wave": None}
    real_pick, emit_first = pd._pick_token, pe._emit_first

    def pick(logits, temperature, generator=None, top_k=0, top_p=1.0):
        tok = real_pick(logits, temperature, generator, top_k, top_p)
        for s, r in de._active.items():
            cid, j = co._decode_rids[r.rid], len(r.generated)
            rec.setdefault(cid, {})[j] = logits[s].float().clone()
            if forced is not None:
                tok[s] = forced[cid][j]
        return tok

    def pick_wave(logits, *a, **k):
        ctx["wave"] = logits.float().clone()
        return torch.argmax(logits, dim=-1)

    def emit(reqs, slots, toks):
        for i, r in enumerate(reqs):
            if not r.generated:
                cid = co._prefill_rids[r.rid]
                rec.setdefault(cid, {})[0] = ctx["wave"][i]
                if forced is not None:
                    toks[i] = forced[cid][0]
        return emit_first(reqs, slots, toks)

    pe._emit_first = emit
    if corrupt:
        adopt = de.cache.adopt_swap

        def adopt_late(k, v, ks, vs, L):
            k, v = k.roll(1, dims=3), v.roll(1, dims=3)
            if ks is not None:
                ks, vs = ks.roll(1, dims=3), vs.roll(1, dims=3)
            return adopt(k, v, ks, vs, L)

        de.cache.adopt_swap = adopt_late
    state = handoff_bits_watch(torch, pe, de) if watch else None
    with patched((pd, "_pick_token", pick), (se, "_pick_token", pick_wave)):
        _, _, done = disagg_drive(co, sched, DISAGG_CHECK_NEW, lambda: False)
    for c in caches:                     # the instance seams go with it
        for name in ("export_row", "adopt_swap", "swap_in_row"):
            c.__dict__.pop(name, None)
    disagg_clean("serve_disagg", "the recorded run", *caches)
    gens = [r.generated for r in done]
    logits = [torch.stack([rec[i][j] for j in range(len(g))])
              for i, g in enumerate(gens)]
    counts = dict(handoffs=co.handoffs_shipped,
                  decode_prefill_calls=de.prefill_calls,
                  prefill_tokens_avoided=de.prefill_tokens_avoided)
    return gens, logits, state, counts


def disagg_logit_check(torch, cfg, params, caches, sched, kv_quant, dev,
                       phase):
    """(a) and (c): the recorded run with the bit watch on, its logits
    against the plain forward over the served sequences (int8: the int8
    weights through their plain matmul, K / V through int8 pages'
    quantization), a served token's plain logit within 2 * LOGIT_LIMIT of
    the plain top (bf16), and the same tokens forced with every shipped page
    one slot late (a planted fault) beyond the limit."""
    import paddle_tpu_torch.models.llama_pretrain as tlp
    from paddle_tpu_torch.ops import int8_matmul as im
    prompts = [p for wave in sched for p in wave]
    t0 = time.perf_counter()
    served, sound, watch, counts = disagg_recorded(
        torch, cfg, params, caches, sched, watch=True)
    forced = dict(enumerate(served))
    _, fault, _, _ = disagg_recorded(torch, cfg, params, caches, sched,
                                     forced=forced, corrupt=True)
    q8 = kv_quant == "int8"
    with patched((tlp, "int8_matmul", im.int8_matmul_plain)):
        plain = [plain_logits(torch, cfg, params, p + g[:-1], dev,
                              kv_q8=q8)[len(p) - 1:]
                 for p, g in zip(prompts, served)]
    limit = INT8_LOGIT_LIMIT if q8 else LOGIT_LIMIT
    out = dict(checked_requests=len(prompts),
               handoffs_bit_checked=watch["checked"],
               handoffs_bit_mismatched=len(watch["bad"]),
               logit_max_abs_diff=max_diff(sound, plain), logit_limit=limit,
               planted_fault_max_abs_diff=max_diff(fault, plain),
               served_token_max_gap=None if q8
               else served_gap(torch, served, plain),
               check_counts=counts, logit_check_s=time.perf_counter() - t0)
    del sound, fault, plain
    if watch["bad"] or watch["checked"] != len(prompts):
        fail(f"{phase}: {len(watch['bad'])} of {watch['checked']} hand-offs "
             f"restored other bits than their export (want "
             f"{len(prompts)} checked)")
    if counts["decode_prefill_calls"] or counts["handoffs"] != len(prompts):
        fail(f"{phase}: the recorded run prefilled on the decode side or "
             f"shipped {counts['handoffs']} of {len(prompts)} hand-offs")
    if out["logit_max_abs_diff"] > limit:
        fail(f"{phase}: the served logits differ from the plain forward's "
             f"by {out['logit_max_abs_diff']} (limit {limit})")
    if out["planted_fault_max_abs_diff"] <= limit:
        fail(f"{phase}: the planted hand-off fault moved the logits by only "
             f"{out['planted_fault_max_abs_diff']}, within the limit "
             f"{limit}: the check cannot see it")
    if out["served_token_max_gap"] is not None and \
            out["served_token_max_gap"] > 2 * LOGIT_LIMIT:
        fail(f"{phase}: a served token sits {out['served_token_max_gap']} "
             f"below the plain top logit (limit {2 * LOGIT_LIMIT})")
    return out


def disagg_faults(torch, cfg, params, caches, sched, phase):
    """(d): a kv_handoff fault at the ship half (the first consult) and at
    the restore half (the second) each degrade one request to a colocated
    re-prefill on the decode engine; every request still finishes with all
    its tokens and both caches audit clean."""
    from paddle_tpu_torch.testing import faults
    out = {}
    for half, nth in (("ship", 1), ("restore", 2)):
        pe, de, co = disagg_pair(cfg, params, caches)
        with faults.plane() as fp:
            fp.inject("kv_handoff", RuntimeError(f"{half} fault"), nth=nth,
                      times=1)
            _, _, done = disagg_drive(co, sched, DISAGG_FAULT_NEW,
                                      lambda: False)
            fired = fp.fired.get("kv_handoff", 0)
        news = [DISAGG_FAULT_NEW + MIXED_STAGGER * j for wave in sched
                for j in range(len(wave))]
        lost = [r.rid for r, n in zip(done, news)
                if r.status != "ok" or len(r.generated) != n]
        out[half] = dict(fired=fired, fallbacks=co.colocated_fallbacks,
                         decode_fallbacks=de.colocated_fallbacks,
                         decode_prefill_calls=de.prefill_calls,
                         lost=lost)
        disagg_clean(phase, f"the {half} fault", *caches)
        if fired != 1 or co.colocated_fallbacks != 1 or \
                de.colocated_fallbacks != 1 or lost or \
                de.prefill_calls < 1:
            fail(f"{phase}: a kv_handoff fault at the {half} half did not "
                 f"degrade one request to a colocated re-prefill: "
                 f"{out[half]}")
    return out


def disagg_router(torch, cfg, params, sched, dev, phase):
    """(e): FleetRouter(roles=["prefill", "decode"]) over the one weight set:
    one wave exported by the prefill replica and left untaken, then a
    replica_death of the prefill replica: its records' staging pages come
    back (its cache audits clean), the requests fail over to the decode
    replica and finish with all their tokens."""
    from paddle_tpu_torch.fleet import FleetRouter
    from paddle_tpu_torch.models.disagg import DecodeEngine, PrefillEngine
    from paddle_tpu_torch.models.paged_decode import PagedKVCache
    from paddle_tpu_torch.testing import faults

    def mk(cls):
        def factory():
            return cls(cfg, params, PagedKVCache(
                cfg, device=dev, host_pages=DISAGG_ROUTER_HOST_PAGES,
                **DISAGG_ROUTER_CACHE), metrics_registry=False)
        return factory

    router = FleetRouter([mk(PrefillEngine), mk(DecodeEngine)],
                         roles=["prefill", "decode"],
                         metrics_registry=False, handoff_gbps=1e9)
    prompts = sched[0][:DISAGG_ROUTER_CACHE["batch"]]
    rids = [router.submit(p, max_new_tokens=DISAGG_FAULT_NEW)
            for p in prompts]
    pe = router._replicas[0].engine
    pe.step()                    # the wave exports outside a router tick
    untaken = len(pe._handoff_ready)
    staged = pe.cache.host.used_pages()
    with faults.plane() as fp:
        fp.inject("replica_death", RuntimeError("prefill replica died"),
                  nth=1, times=1)
        done = {r.rid: r for r in router.run_to_completion()}
    out = dict(untaken_records=untaken, staged_pages=staged,
               staged_after=pe.cache.host.used_pages(),
               deaths=router.deaths, failovers=router.failovers,
               routed=dict(router.routed),
               statuses=[done[r].status for r in rids],
               tokens=[len(done[r].generated) for r in rids])
    disagg_clean(phase, "the dead prefill replica", pe.cache)
    for h in router._replicas:
        disagg_clean(phase, f"replica {h.idx}", h.engine.cache)
    if untaken != len(prompts) or not staged or out["staged_after"] or \
            router.deaths != 1 or router.failovers != len(prompts) or \
            out["statuses"] != ["ok"] * len(prompts) or \
            out["tokens"] != [DISAGG_FAULT_NEW] * len(prompts):
        fail(f"{phase}: the prefill replica's death mid-hand-off did not "
             f"reclaim its records and fail over: {out}")
    return out


def phase_serve_disagg(torch, cfg, seed, params, mods, kv_quant=None,
                       dev="cuda"):
    """The 1P+1D pair on LLaMA-7B.  bf16 (``kv_quant`` None): the unified
    arm and the disaggregated arm timed on serve_mixed's schedule (TTFT /
    TPOT p50 / p99, the decode step's p99 during admission ticks, hand-off
    ms a request and the GB/s it reached, printed, not gated) with (b)'s
    counter gates; the flip link speed at the schedule's lengths and the
    default ``handoff_gbps``'s verdict; (a) and (c) on the first
    DISAGG_CHECK_WAVES waves; (d) the kv_handoff faults; (e) the router's
    roles.  int8 (``params`` the quantized weights): (a) and (c) over int8
    pages.  -> the launches of the timed arms (bf16) or of the checked
    run (int8)."""
    from paddle_tpu_torch.models import graphed_step as gs
    from paddle_tpu_torch.models.disagg import (handoff_flip_gbps,
                                                handoff_wins)
    phase = "serve_disagg_int8" if kv_quant else "serve_disagg"
    t_phase = time.perf_counter()
    secs = {}
    sched = mixed_schedule(cfg, seed)
    warm = mixed_schedule(cfg, seed + 1, MIXED_WARM_WAVES)
    check = sched[:DISAGG_CHECK_WAVES]
    attn = ("paged_decode_attention_q8" if kv_quant
            else "paged_decode_attention")
    path = [attn, "flash_attention_segmented", "segment_tile_ranges"] + (
        ["int8_matmul", "int8_matmul_wave"]
        if isinstance(params["lm_head"], dict) else [])
    caches = disagg_caches(cfg, kv_quant, dev)
    arms, total = {}, {}
    if kv_quant is None:
        for disagg in (False, True):
            name = "disagg" if disagg else "unified"
            t = time.perf_counter()
            arms[name] = disagg_arm(torch, cfg, params, caches, mods, sched,
                                    warm, disagg, phase)
            secs[name] = time.perf_counter() - t
            for k, v in arms[name]["launches"].items():
                total[k] = total.get(k, 0) + v
            for kname in path:
                if arms[name]["launches"][kname] <= 0:
                    fail(f"{phase}: the {name} arm did not launch {kname}")
            for kname in FLAGGED:
                if arms[name]["launches"][kname]:
                    fail(f"{phase}: the {name} arm launched {kname} with "
                         f"its flag off")
            emit(phase, arm=name, **arms[name])
    t = time.perf_counter()
    graphs0 = graph_state()
    zero_counts(mods)
    check_out = disagg_logit_check(torch, cfg, params, caches, check,
                                   kv_quant, dev, phase)
    if kv_quant:
        total = ran_launches(read_counts(mods), graphs0)
        for kname in path:
            if total[kname] <= 0:
                fail(f"{phase}: the checked runs did not launch {kname}")
    secs["check"] = time.perf_counter() - t
    de_probe = disagg_pair(cfg, params, caches)[1]
    lens = sorted(set(MIXED_LONG + MIXED_SHORT))
    flip = {L: handoff_flip_gbps(L, de_probe) for L in lens}
    verdict = {L: handoff_wins(L, de_probe, 10.0) for L in lens}
    del de_probe
    extra = {}
    if kv_quant is None:
        t = time.perf_counter()
        extra["faults"] = disagg_faults(torch, cfg, params, caches,
                                        check[:1], phase)
        secs["faults"] = time.perf_counter() - t
        del caches
        torch.cuda.empty_cache()
        t = time.perf_counter()
        extra["router"] = disagg_router(torch, cfg, params, sched, dev,
                                        phase)
        secs["router"] = time.perf_counter() - t
    else:
        del caches
    emit(phase, model="LLaMA-7B (LlamaPretrainConfig defaults)",
         weights="int8 (quantize_params_int8)" if kv_quant else "bf16",
         kv_pages=kv_quant or "bf16", cache=DISAGG_CACHE,
         host_pages=DISAGG_HOST_PAGES,
         traffic=dict(waves=MIXED_WAVES, per_wave=MIXED_PER_WAVE,
                      wave_gap_ticks=MIXED_WAVE_GAP, long=MIXED_LONG,
                      short=MIXED_SHORT, new=MIXED_NEW,
                      stagger=MIXED_STAGGER),
         unified_vs_disagg={key: {arm: arms[arm][key] for arm in arms}
                            for key in ("ttft_p50_ms", "ttft_p99_ms",
                                        "tpot_p50_ms", "tpot_p99_ms",
                                        "decode_step_p99_during_admission_ms")
                            } if arms else None,
         handoff_ms_per_request=arms["disagg"]["handoff_ms_per_request"]
         if arms else None,
         handoff_gb_per_s=arms["disagg"]["handoff_gb_per_s"]
         if arms else None,
         flip_gbps=flip, default_handoff_gbps=10.0,
         default_disaggregates=verdict,
         k1_launches=total.get(attn), k2_launches=total.get(
             "flash_attention_segmented"), launches=total,
         **check_out, **extra, secs=secs,
         phase_s=time.perf_counter() - t_phase)
    gs.clear()
    return total


# serve_remote: the sockets fleet (paddle_tpu_torch/fleet/transport.py,
# fleet/remote.py) with a LLaMA-7B replica in an OS process of its own,
# spawned from AGENT_FACTORY with the parent's seed (the same weights,
# drawn in the child), bf16, 128 pages of 64 (4 GiB of pages), beside an
# in-process replica over the parent's weights.  The child loads the kernel
# libraries the parent built; its K1 / K2 launch counts come back through a
# file (REMOTE counts), the wire stays JAX's.
AGENT_FACTORY = "paddle_tpu_torch.testing.agent_factory:make_llama7b_engine"
REMOTE_CACHE = dict(num_pages=128, pages_max=32, batch=8, page=64)
REMOTE_HOST_PAGES = 48
REMOTE_LEASE_S, REMOTE_RPC_S = 1.5, 0.5
# (b): prompts of 256 tokens (a bf16 record is 0.5 MiB a token)
REMOTE_HANDOFF_LEN, REMOTE_HANDOFF_N, REMOTE_HANDOFF_NEW = 256, 4, 8
# (c) and (d): two requests decoding when the agent dies, two behind them
REMOTE_KILL_NEW = 48
REMOTE_STICKY_AFTER = 24            # (d): decode steps before the assert
REMOTE_STICKY_BATCH = 2             # (d): the two late requests queue
REMOTE_TIMEOUT_S = 300.0


_STICKY = {"poisoned": False}


def sticky_llama7b_engine(fault_after=REMOTE_STICKY_AFTER, **kw):
    """(d)'s agent engine: make_llama7b_engine's, whose step, once the engine
    has run ``fault_after`` decode steps, indexes a tensor on its device out
    of bounds and waits for it.  On a card that is a device-side assert, a
    sticky error: every later CUDA call of the process fails, the
    supervisor's rebuild included.  On the CPU (a rehearsal) the index
    raises at once and nothing sticks, so a flag stands in for the poisoned
    context and refuses the rebuild.  Spawned agents import it by path
    (``chip_smoke:sticky_llama7b_engine``)."""
    import torch
    from paddle_tpu_torch.testing.agent_factory import make_llama7b_engine
    if _STICKY["poisoned"]:
        raise RuntimeError("the CPU stand-in for a sticky device error")
    eng = make_llama7b_engine(**kw)
    step = eng.step

    def faulting_step():
        out = step()
        if eng.decode_steps >= fault_after:
            _STICKY["poisoned"] = eng.device.type != "cuda"
            x = torch.zeros(4, device=eng.device)
            idx = torch.full((1,), 1 << 20, device=eng.device)
            x[idx].sum().item()
        return out

    eng.step = faulting_step
    return eng


def remote_spec(cfg, seed, dev, factory=AGENT_FACTORY, role=None, **kw):
    """A RemoteSpec(spawn=...) of one agent over ``factory`` with the
    parent's seed and config."""
    from paddle_tpu_torch.fleet import RemoteSpec
    fkw = dict(REMOTE_CACHE, device=dev, seed=seed,
               config={f.name: getattr(cfg, f.name)
                       for f in dataclasses.fields(cfg) if f.init})
    fkw.update(kw)
    return RemoteSpec(
        spawn={"factory": factory, "factory_kwargs": fkw,
               "agent_kwargs": {"lease_s": REMOTE_LEASE_S,
                                "role": role or "unified"}},
        role=role, lease_s=REMOTE_LEASE_S, rpc_timeout_s=REMOTE_RPC_S,
        max_retries=2)


def remote_pin(router, pins):
    """Route by prompt length: ``pins[len(prompt)]`` names the replica a
    first placement tries first; a failed-over request tries the
    in-process replica (index 1) first."""
    real = router._candidates_locked

    def pinned(freq, lane="serve"):
        cands, hit, key = real(freq, lane)
        want = 1 if freq.failovers else pins.get(len(freq.prompt))
        if want is not None:
            cands = sorted(cands, key=lambda h: h.idx != want)
        return cands, hit, key

    router._candidates_locked = pinned


def remote_teardown(router):
    """Stop every agent the router started and reap its process."""
    import os
    import signal
    for h in router._replicas:
        if not getattr(h, "remote", False):
            continue
        if h._agent is not None:
            h._agent.die()
        if h._proc is not None:
            if h._proc.is_alive():
                os.kill(h._proc.pid, signal.SIGKILL)
            h._proc.join(30)


def remote_counts(path):
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return {}


def remote_drive(router, rids, phase, what):
    """Step ``router`` until every rid finished -> {rid: request}."""
    done = {}
    t0 = time.perf_counter()
    while not set(rids) <= set(done):
        router.step()
        done.update((r.rid, r) for r in router.finished())
        if time.perf_counter() - t0 > REMOTE_TIMEOUT_S:
            fail(f"{phase}: {what}: {len(set(rids) - set(done))} requests "
                 f"unfinished after {REMOTE_TIMEOUT_S} s")
    return done


def remote_gaps(torch, cfg, params, seqs, dev, phase, what):
    """Every served token's plain teacher-forced logit within
    2 * LOGIT_LIMIT of the plain top, and a planted fault beyond it."""
    limit = 2 * LOGIT_LIMIT
    gaps = [qos_greedy_gap(torch, cfg, params, p, g, dev) for p, g in seqs]
    fault = max(qos_greedy_gap(torch, cfg, params, p, g, dev, lost=True)
                for p, g in seqs if len(p) > 1)
    if max(gaps) > limit:
        fail(f"{phase}: {what}: a served token stands {max(gaps)} below the "
             f"plain forward's argmax (limit {limit})")
    if fault <= limit:
        fail(f"{phase}: {what}: the planted fault moved the margin by only "
             f"{fault}, within the limit {limit}")
    return dict(greedy_margin_max=max(gaps), limit=limit,
                planted_fault="the prompt's last token lost",
                planted_fault_margin=fault)


def remote_serve(torch, cfg, seed, params, dev, tmp, phase):
    """(a) HTTP through a FleetServer over a spawned agent and an in-process
    replica, then (c) a SIGKILL of the agent mid-decode on the same router.
    -> (fields of a, fields of c, the agent's launch counts)."""
    import os
    import signal
    import urllib.request
    from paddle_tpu_torch.fleet import FleetRouter, FleetServer
    from paddle_tpu_torch.inference.serving import generate_http
    from paddle_tpu_torch.models.paged_decode import PagedKVCache
    from paddle_tpu_torch.models.serving_engine import (
        ContinuousBatchingEngine)
    from paddle_tpu_torch.observability import MetricsRegistry
    counts = os.path.join(tmp, "agent_serve.json")
    reg = MetricsRegistry()

    def local():
        return ContinuousBatchingEngine(
            cfg, params, PagedKVCache(cfg, device=dev, **REMOTE_CACHE),
            metrics_registry=reg)

    t = time.perf_counter()
    router = FleetRouter([remote_spec(cfg, seed, dev, counts_path=counts),
                          local], metrics_registry=reg)
    spawn_s = time.perf_counter() - t
    try:
        prompts, news = serve_prompts(cfg, seed), SERVE_NEWS
        pins = {len(p): (0 if i % 2 == 0 else 1)
                for i, p in enumerate(prompts)}
        remote_pin(router, pins)
        # a submit waits on the agent's engine lock (a step holds it)
        submit_ms = []
        sub = router._replicas[0].supervisor.submit

        def timed_submit(*args, **kw):
            t = time.perf_counter()
            out = sub(*args, **kw)
            submit_ms.append(1e3 * (time.perf_counter() - t))
            return out

        router._replicas[0].supervisor.submit = timed_submit
        srv = FleetServer(router)
        url = f"http://127.0.0.1:{srv.start()}"
        results, errors = {}, []

        def client(i):
            try:
                results[i] = generate_http(url, prompts[i], news[i],
                                           timeout=REMOTE_TIMEOUT_S)
            except Exception as e:
                errors.append(f"request {i}: {type(e).__name__}: {e}")

        t = time.perf_counter()
        threads = [threading.Thread(target=client, args=(i,), daemon=True)
                   for i in range(len(prompts))]
        for th in threads:
            th.start()
        for th in threads:
            th.join(REMOTE_TIMEOUT_S)
        wall = time.perf_counter() - t
        with urllib.request.urlopen(url + "/metrics", timeout=60) as r:
            samples = prom_samples(r.read().decode())
        routed = dict(router.routed)
        srv.stop()
        if errors or len(results) != len(prompts):
            fail(f"{phase}: (a): {errors or 'a request did not return'}")
        short = [i for i in range(len(prompts))
                 if len(results[i]) != news[i]]
        if short:
            fail(f"{phase}: (a): requests {short} came back short")
        on_agent = sum(1 for i in range(len(prompts)) if i % 2 == 0)
        names = ["paddle_tpu_transport_reconnects_total",
                 "paddle_tpu_transport_retries_total",
                 "paddle_tpu_transport_heartbeat_misses_total",
                 "paddle_tpu_transport_frames_total",
                 "paddle_tpu_transport_bytes_total",
                 "paddle_tpu_transport_rtt_seconds_count"]
        missing = [n for n in names if n not in samples]
        if missing or not samples.get(names[3]) or \
                not samples.get(names[4]):
            fail(f"{phase}: (a): /metrics lacks the transport instruments "
                 f"{missing} or moved no frames / bytes")
        rtt = reg.snapshot()["paddle_tpu_transport_rtt_seconds"]
        a_counts = remote_counts(counts)
        for k in ("paged_decode_attention", "flash_attention_segmented"):
            if a_counts.get(k, 0) <= 0:
                fail(f"{phase}: (a): the agent process did not launch {k} "
                     f"({a_counts})")
        gens = [results[i] for i in range(len(prompts))]
        gap = remote_gaps(torch, cfg, params, list(zip(prompts, gens)), dev,
                          phase, "(a)")
        ref = ContinuousBatchingEngine(
            cfg, params, PagedKVCache(cfg, device=dev, **REMOTE_CACHE),
            metrics_registry=False)
        rrids = [ref.submit(p, max_new_tokens=n)
                 for p, n in zip(prompts, news)]
        rdone = {r.rid: r for r in ref.run_to_completion()}
        agree = [i for i in range(len(prompts))
                 if [int(t) for t in rdone[rrids[i]].generated] == gens[i]]
        del ref, rdone
        a = dict(spawn_to_ready_s=spawn_s, requests=len(prompts),
                 on_agent=on_agent, routed=routed, wall_s=wall,
                 transport={n: samples[n] for n in names},
                 rtt_p50_ms=1e3 * hist_quantile(rtt, 0.5),
                 rtt_p99_ms=1e3 * hist_quantile(rtt, 0.99),
                 rtt_over_1s=rtt["count"] - rtt["buckets"]["1"],
                 agent_submit_ms=list(submit_ms),
                 agent_launches=a_counts,
                 exact_agreement_with_in_process=[len(agree), len(prompts)],
                 **gap)

        # (c): two requests decoding on the agent, two submitted behind
        # them and never synced, then SIGKILL
        h, surv = router._replicas
        spawn = h._spawn_and_connect
        respawn = {}

        def timed_spawn():
            t = time.perf_counter()
            spawn()
            respawn["s"] = time.perf_counter() - t

        h._spawn_and_connect = timed_spawn
        late_p = [prompts[3], prompts[4]]
        early_p = [prompts[1], prompts[2]]
        pins.clear()
        pins.update({len(p): 0 for p in early_p + late_p})
        early = [router.submit(p, max_new_tokens=REMOTE_KILL_NEW,
                               deadline_s=REMOTE_TIMEOUT_S)
                 for p in early_p]
        t0 = time.perf_counter()
        while min(router._requests[r].streamed for r in early) < 2:
            router.step()
            if time.perf_counter() - t0 > REMOTE_TIMEOUT_S:
                fail(f"{phase}: (c): the agent never streamed")
        late = [router.submit(p, max_new_tokens=REMOTE_KILL_NEW,
                              deadline_s=REMOTE_TIMEOUT_S) for p in late_p]
        deadlines = {r: router._requests[r].deadline for r in late}
        streamed = {r: router._requests[r].streamed for r in early + late}
        surv_done0 = surv.engine.requests_finished
        pid = h._proc.pid
        # the respawned agent writes the same file from 0
        killed_counts = remote_counts(counts)
        t_kill = time.perf_counter()
        os.kill(pid, signal.SIGKILL)
        done, t_death = {}, None
        while not set(early + late) <= set(done):
            router.step()
            if t_death is None and router.deaths:
                t_death = time.perf_counter()
            done.update((r.rid, r) for r in router.finished())
            if time.perf_counter() - t_kill > REMOTE_TIMEOUT_S:
                fail(f"{phase}: (c): requests lost after the SIGKILL")
        t_done = time.perf_counter()
        bad = [r for r in early if done[r].status != "error"] + \
            [r for r in late if done[r].status != "ok"
             or len(done[r].generated) != REMOTE_KILL_NEW
             or abs(done[r].deadline - deadlines[r]) > 1.0]
        audit = surv.engine.cache.audit()
        served_by_survivor = surv.engine.requests_finished - surv_done0
        if bad or router.deaths != 1 or audit["owned"] or \
                served_by_survivor != len(late):
            fail(f"{phase}: (c): after the SIGKILL: statuses "
                 f"{[(r, done[r].status, len(done[r].generated)) for r in done]}"
                 f", deaths {router.deaths}, survivor finished "
                 f"{served_by_survivor}, audit {audit}")
        gap_c = remote_gaps(torch, cfg, params,
                            [(p, [int(t) for t in done[r].generated])
                             for p, r in zip(late_p, late)], dev, phase,
                            "(c) failed over")
        # auto_replace respawned the agent: it serves one more request
        pins.clear()
        pins[len(prompts[5])] = 0
        t = time.perf_counter()
        while h.state != "READY" or h.replaces < 1:
            router.step()
            if time.perf_counter() - t > REMOTE_TIMEOUT_S:
                fail(f"{phase}: (c): the agent was not replaced")
        rid = router.submit(prompts[5], max_new_tokens=news[5])
        more = remote_drive(router, [rid], phase, "(c) after the respawn")
        if more[rid].status != "ok" or len(more[rid].generated) != news[5] \
                or h._proc is None or h._proc.pid == pid:
            fail(f"{phase}: (c): the respawned agent did not serve: "
                 f"{more[rid].status} {len(more[rid].generated)}")
        agent_counts = dict(killed_counts)
        for k, v in remote_counts(counts).items():
            agent_counts[k] = agent_counts.get(k, 0) + v
        c = dict(streamed_at_kill=list(streamed.values()),
                 statuses={"decoding": [done[r].status for r in early],
                           "queued": [done[r].status for r in late]},
                 errors=[done[r].error for r in early],
                 deaths=router.deaths, failovers=router.failovers,
                 replaces=router.replaces,
                 failover_detect_ms=1e3 * (t_death - t_kill),
                 failover_complete_ms=1e3 * (t_done - t_kill),
                 survivor_audit=audit, respawned_pid_differs=True,
                 respawn_to_ready_s=respawn.get("s"), **gap_c)
        return a, c, agent_counts
    finally:
        remote_teardown(router)


def remote_handoff(torch, cfg, seed, params, dev, tmp, phase):
    """(b) FleetRouter(roles=["prefill", "decode"]): a spawned prefill agent,
    an in-process DecodeEngine with a host tier; the records cross the
    wire.  -> (fields, the agent's launch counts)."""
    import os
    from paddle_tpu_torch.fleet import FleetRouter
    from paddle_tpu_torch.models.disagg import DecodeEngine
    from paddle_tpu_torch.models.paged_decode import PagedKVCache
    counts = os.path.join(tmp, "agent_prefill.json")
    import paddle_tpu_torch.fleet.remote as tremote
    watch = {"adopted": {}, "checked": 0, "bad": [], "ctx": [], "bytes": 0,
             "take_s": 0.0, "adopt_s": 0.0, "unpack_s": 0.0}
    holder = {}

    def decode():
        de = DecodeEngine(cfg, params, PagedKVCache(
            cfg, device=dev, host_pages=REMOTE_HOST_PAGES, **REMOTE_CACHE),
            metrics_registry=False)
        admit, swap_in = de.admit_handoff, de.cache.swap_in_row

        def adopt(rec):
            k, v, ks, vs, L = rec.materialize()
            arrived = [bits(torch, t).clone() for t in (k, v, ks, vs)
                       if t is not None]
            t = time.perf_counter()
            local = admit(rec)
            watch["adopt_s"] += time.perf_counter() - t
            watch["adopted"][de._swap_handles[local]] = (arrived, int(L))
            watch["ctx"].append(int(L))
            watch["bytes"] += rec.nbytes
            return local

        def restore(b, handle):
            ent = watch["adopted"].pop(handle, None)
            L = swap_in(b, handle)
            if ent is not None:
                npg = -(-L // de.cache.page)
                got = [bits(torch, t).cpu() for t in
                       page_blocks(torch, de.cache, de.cache._owned[b][:npg])]
                if L != ent[1] or not all(
                        torch.equal(a, g) for a, g in zip(ent[0], got)):
                    watch["bad"].append(handle)
                watch["checked"] += 1
            return L

        de.admit_handoff, de.cache.swap_in_row = adopt, restore
        holder["de"] = de
        return de

    t = time.perf_counter()
    router = FleetRouter(
        [remote_spec(cfg, seed, dev, role="prefill", engine="prefill",
                     host_pages=REMOTE_HOST_PAGES, counts_path=counts),
         decode], roles=["prefill", "decode"], handoff_gbps=1e9,
        metrics_registry=False)
    spawn_s = time.perf_counter() - t
    try:
        pe = router._replicas[0].engine
        take = pe.take_handoffs

        def timed_take():
            t = time.perf_counter()
            out = take()
            watch["take_s"] += time.perf_counter() - t
            return out

        pe.take_handoffs = timed_take
        unpack = tremote._unpack_record

        def timed_unpack(metas, blobs):
            t = time.perf_counter()
            out = unpack(metas, blobs)
            watch["unpack_s"] += time.perf_counter() - t
            return out

        rng = np.random.default_rng(seed + 7)
        prompts = [rng.integers(0, cfg.vocab_size, REMOTE_HANDOFF_LEN).tolist()
                   for _ in range(REMOTE_HANDOFF_N)]
        rids = [router.submit(p, max_new_tokens=REMOTE_HANDOFF_NEW)
                for p in prompts]
        with patched((tremote, "_unpack_record", timed_unpack)):
            done = remote_drive(router, rids, phase, "(b)")
        de = holder["de"]
        out = dict(spawn_to_ready_s=spawn_s, requests=len(rids),
                   prompt_len=REMOTE_HANDOFF_LEN,
                   routed=dict(router.routed),
                   handoffs_shipped=router.handoffs_shipped,
                   colocated_fallbacks=router.colocated_fallbacks,
                   pages_checked_bitwise=watch["checked"],
                   pages_differing=watch["bad"],
                   decode_prefill_calls=de.prefill_calls,
                   prefill_tokens_avoided=de.prefill_tokens_avoided,
                   handed_off_context=sum(watch["ctx"]),
                   record_mib=watch["bytes"] / len(rids) / 2**20,
                   handoff_ms_per_request=1e3 * (watch["take_s"]
                                                 + watch["adopt_s"])
                   / len(rids),
                   wire_ms_per_request=1e3 * watch["take_s"] / len(rids),
                   router_unpack_ms_per_request=1e3 * watch["unpack_s"]
                   / len(rids),
                   handoff_gb_per_s=watch["bytes"] / 1e9
                   / max(watch["take_s"] + watch["adopt_s"], 1e-9),
                   statuses=[done[r].status for r in rids],
                   tokens=[len(done[r].generated) for r in rids],
                   agent_launches=remote_counts(counts))
        if out["statuses"] != ["ok"] * len(rids) or \
                out["tokens"] != [REMOTE_HANDOFF_NEW] * len(rids) or \
                router.handoffs_shipped != len(rids) or \
                watch["checked"] != len(rids) or watch["bad"] or \
                de.prefill_calls or \
                de.prefill_tokens_avoided != sum(watch["ctx"]) or \
                watch["ctx"] != [REMOTE_HANDOFF_LEN] * len(rids):
            fail(f"{phase}: (b): the hand-off over the wire: {out}")
        return out, out["agent_launches"]
    finally:
        remote_teardown(router)


def remote_sticky(torch, cfg, seed, params, dev, phase):
    """(d) a device-side assert in a spawned agent: the agent reports DEAD,
    the router counts one death and fails the queued requests over.
    -> fields."""
    from paddle_tpu_torch.fleet import FleetRouter
    from paddle_tpu_torch.models.paged_decode import PagedKVCache
    from paddle_tpu_torch.models.serving_engine import (
        ContinuousBatchingEngine)

    def local():
        return ContinuousBatchingEngine(
            cfg, params, PagedKVCache(cfg, device=dev, **REMOTE_CACHE),
            metrics_registry=False)

    spec = remote_spec(cfg, seed, dev,
                       factory="chip_smoke:sticky_llama7b_engine",
                       batch=REMOTE_STICKY_BATCH)
    router = FleetRouter([spec, local], auto_replace=False,
                         metrics_registry=False)
    try:
        h, surv = router._replicas
        fatal = {}
        apply = h.apply_sync

        def watch(resp):
            apply(resp)
            if resp["snap"].get("fatal"):
                fatal.update(resp["snap"])

        h.apply_sync = watch
        streamed = {}
        on_death = router._on_death_locked

        def death(dead, exc):
            streamed.update((rid, router._requests[rid].streamed)
                            for rid in dead.local_rids.values())
            on_death(dead, exc)

        router._on_death_locked = death
        prompts = serve_prompts(cfg, seed)
        # the first two take the agent's two slots, the last two queue
        sel = [prompts[1], prompts[2], prompts[6], prompts[3]]
        remote_pin(router, {len(p): 0 for p in sel})
        rids = [router.submit(p, max_new_tokens=REMOTE_KILL_NEW)
                for p in sel]
        done = remote_drive(router, rids, phase, "(d)")
        st = [done[r].status for r in rids]
        want = ["error" if streamed.get(r) else "ok" for r in rids]
        h._proc.join(30)
        out = dict(agent_state=fatal.get("state"),
                   agent_fatal=fatal.get("fatal"),
                   agent_restarts=fatal.get("restarts"),
                   deaths=router.deaths, failovers=router.failovers,
                   streamed_at_death=[streamed.get(r) for r in rids],
                   statuses=st, replica_error=h.error,
                   agent_exitcode=h._proc.exitcode if h._proc else None)
        if fatal.get("state") != "DEAD" or not fatal.get("fatal") or \
                router.deaths != 1 or st != want or want[2:] != ["ok"] * 2 \
                or router.failovers != want.count("ok") or \
                any(len(done[r].generated) != REMOTE_KILL_NEW
                    for r, w in zip(rids, want) if w == "ok"):
            fail(f"{phase}: (d): the agent's sticky error was not one "
                 f"replica's death: {out}")
        return out, router
    except BaseException:
        remote_teardown(router)
        raise


def phase_serve_remote(torch, cfg, seed, params, mods, dev="cuda",
                       card=None):
    """The sockets fleet at LLaMA-7B bf16 (serve_remote): (a) a FleetServer
    over a spawned agent and an in-process replica, (c) a SIGKILL of the
    agent mid-decode with auto_replace, (b) a prefill agent's hand-offs
    over the wire to an in-process DecodeEngine, (d) a device-side assert in
    an agent.  -> the launches of the phase's serving: the parent's counts
    (the K1 check after (d) left out) and the agents' from their files."""
    import tempfile
    phase = "serve_remote"
    t_phase = time.perf_counter()
    secs, fields = {}, {}
    zero_counts(mods)
    with tempfile.TemporaryDirectory() as tmp:
        t = time.perf_counter()
        fields["serve"], fields["sigkill"], counts_a = remote_serve(
            torch, cfg, seed, params, dev, tmp, phase)
        secs["serve_and_sigkill"] = time.perf_counter() - t
        torch.cuda.empty_cache()
        t = time.perf_counter()
        fields["handoff"], counts_b = remote_handoff(
            torch, cfg, seed, params, dev, tmp, phase)
        secs["handoff"] = time.perf_counter() - t
    torch.cuda.empty_cache()
    t = time.perf_counter()
    fields["sticky"], router = remote_sticky(torch, cfg, seed, params, dev,
                                             phase)
    total = read_counts(mods)
    try:
        if dev == "cuda":
            gen = torch.Generator(device="cuda").manual_seed(seed)
            fields["sticky"]["parent_k1_max_abs_err"] = check_paged_kernel(
                torch, mods["pa"], f"{phase}: K1 after the agent's sticky "
                f"error", 32, gen, False)
        zero_counts(mods)
        p = serve_prompts(cfg, seed)[5]
        rid = router.submit(p, max_new_tokens=SERVE_NEWS[5])
        after = remote_drive(router, [rid], phase, "(d) after")
        if after[rid].status != "ok" or \
                len(after[rid].generated) != SERVE_NEWS[5]:
            fail(f"{phase}: (d): the survivor did not serve after the "
                 f"agent's sticky error")
        fields["sticky"]["survivor_served_after"] = True
    finally:
        remote_teardown(router)
    secs["sticky"] = time.perf_counter() - t
    for k, v in read_counts(mods).items():
        total[k] += v
    agents = {}
    for c in (counts_a, counts_b):
        for k, v in c.items():
            agents[k] = agents.get(k, 0) + v
            if k in total:
                total[k] += v
    for k in ("paged_decode_attention", "flash_attention_segmented",
              "segment_tile_ranges"):
        if total.get(k, 0) <= 0:
            fail(f"{phase}: {k} was not launched")
    emit(phase, model="LLaMA-7B (LlamaPretrainConfig defaults)", card=card,
         weights="bf16", cache=REMOTE_CACHE, lease_s=REMOTE_LEASE_S,
         rpc_timeout_s=REMOTE_RPC_S, **fields,
         agent_launches=agents, launches=total, secs=secs,
         phase_s=time.perf_counter() - t_phase)
    return total


# api_llama / api_train: the Paddle API's core (paddle_tpu_torch's Tensor,
# nn.Layer, autograd, optimizer) and its Layer-API LlamaForCausalLM
# (models/llama.py).  api_llama builds LLaMA-7B in full over the serve's
# bf16 weights (models/weights.py:causal_lm_from_params: every parameter a
# view of the stacked params, nothing copied) and drives its forward, the
# eager generate, generate_compiled (greedy and int8; f32 compute, as JAX
# pins it), the dense decode's beam search and generate_auto on both
# routes.  api_train takes AdamW(multi_precision=True) steps of LLaMA-7B's
# width at API_TRAIN_LAYERS layers, bf16 parameters, through
# loss.backward(), opt.step() and opt.clear_grad().
API_BATCH, API_PROMPT, API_NEW, API_BEAMS = 2, 128, 8, 4
API_RAGGED = (128, 100)                  # generate_auto's paged route
API_TRAIN_LAYERS, API_TRAIN_SEQ, API_TRAIN_STEPS = 4, 2048, 3
API_TRAIN_LR = 3e-4


def api_plain_impls(torch, mods):
    """Op-table entries (ops/dispatch.py) that send the API's kernel routes
    to the kernels' plain versions, differentiable by autograd."""
    rp, fa, rn = mods["rp"], mods["fa"], mods["rn"]

    def rms(x, w, eps):
        out, _ = rn.rms_norm_plain(x.reshape(-1, x.shape[-1]), w, eps)
        return out.reshape(x.shape)

    return {"rms_norm": rms,
            "flash_attention": lambda q, k, v, causal=False:
                fa.sdpa_plain(q, k, v, causal),
            "fused_rope": lambda x, cos, sin: rp._composite(x, cos, sin,
                                                            False)}


@contextlib.contextmanager
def op_impls(impls):
    """Register ``impls`` in the API's op table for the block."""
    from paddle_tpu_torch.ops import dispatch
    saved = {k: dispatch.get_op_impl(k, None) for k in impls}
    for k, fn in impls.items():
        dispatch.register_op_impl(k, fn)
    try:
        yield
    finally:
        for k, fn in saved.items():
            dispatch.register_op_impl(k, fn)


def api_forward_launches(layers):
    """The kernels one full Layer forward launches (no cache): K5 on q and
    k of every layer, K6a once a layer, K9a on both norms of every layer
    and the final one."""
    return {"fused_rope": 2 * layers, "flash_attention_fwd": layers,
            "rms_norm_fwd": 2 * layers + 1}


def api_token_gap(torch, seqs, plain, P):
    """The largest distance of a generated token's plain teacher-forced
    logit below the plain top logit; ``seqs`` [B, P + new] tokens,
    ``plain`` one [P + new - 1, V] logits tensor a row."""
    return served_gap(torch, [s[P:].tolist() for s in seqs],
                      [p[P - 1:] for p in plain])


def phase_api_llama(torch, cfg, seed, params, mods, dev="cuda"):
    """The Layer-API LLaMA over ``params`` (the serve's weights)."""
    import paddle_tpu_torch as paddle
    import paddle_tpu_torch.models.llama_pretrain as tlp
    from paddle_tpu_torch.models import LlamaConfig
    from paddle_tpu_torch.models.decode import (make_generate_beam,
                                                quantize_params_int8)
    from paddle_tpu_torch.models.paged_decode import generate_auto
    from paddle_tpu_torch.models.weights import causal_lm_from_params
    from paddle_tpu_torch.ops import dispatch
    im = mods["im"]
    t_all = time.perf_counter()
    L = cfg.num_hidden_layers
    lcfg = LlamaConfig(
        vocab_size=cfg.vocab_size, hidden_size=cfg.hidden_size,
        intermediate_size=cfg.intermediate_size, num_hidden_layers=L,
        num_attention_heads=cfg.num_attention_heads,
        num_key_value_heads=cfg.num_key_value_heads,
        rms_norm_eps=cfg.rms_norm_eps, rope_theta=cfg.rope_theta)
    paddle.set_device("cpu" if dev == "cpu" else "gpu")
    model = causal_lm_from_params(params, lcfg)
    model.eval()
    prompts = np.random.RandomState(seed).randint(
        0, cfg.vocab_size, (API_BATCH, API_PROMPT))
    ids = paddle.to_tensor(prompts)
    f32 = dataclasses.replace(cfg, dtype=torch.float32)
    out = {}
    problems = []
    launches = {name: 0 for name, _, _ in COUNTERS}

    def arm(fn):
        """``fn()`` with the counts zeroed first -> (its result, the kernels
        it launched), added to the phase's launches."""
        zero_counts(mods)
        res = fn()
        used = read_counts(mods)
        for k, v in used.items():
            launches[k] += v
        return res, used

    def plain(c, seqs, p=params):
        return [plain_logits(torch, c, p, list(map(int, s)), dev)
                for s in seqs]

    # (a) the full forward, teacher-forced on the prompts
    t0 = time.perf_counter()
    with paddle.no_grad():
        logits, used = arm(lambda: model(ids)._data.float())
    ref = plain(cfg, prompts)
    out["forward_logit_max_abs_diff"] = max_diff(list(logits), ref)
    # planted fault: the flash forward attending to the whole sequence
    real_fa = dispatch.get_op_impl("flash_attention", None)
    with op_impls({"flash_attention": lambda q, k, v, causal=False:
                   real_fa(q, k, v, causal=False)}):
        with paddle.no_grad():
            fault = model(ids)._data.float()
    out["forward_planted_fault_max_abs_diff"] = max_diff(list(fault), ref)
    del logits, fault
    out["forward_launches"] = {k: v for k, v in used.items() if v}
    out["forward_s"] = time.perf_counter() - t0
    want = api_forward_launches(L)
    for name, n in used.items():
        if n != want.get(name, 0):
            problems.append(f"the Layer forward launched {name} {n} times, "
                            f"the code predicts {want.get(name, 0)}")
    if out["forward_logit_max_abs_diff"] > LOGIT_LIMIT:
        problems.append("the Layer forward's logits differ from the plain "
                        f"forward's by {out['forward_logit_max_abs_diff']}")
    if out["forward_planted_fault_max_abs_diff"] <= LOGIT_LIMIT:
        problems.append("the planted fault (non-causal flash forward) moved "
                        "the logits by only "
                        f"{out['forward_planted_fault_max_abs_diff']}")

    # (b) the eager generate over the concatenated cache, greedy
    t0 = time.perf_counter()
    eager, used = arm(lambda: model.generate(ids,
                                             max_new_tokens=API_NEW)._data)
    out["eager_launches"] = {k: v for k, v in used.items() if v}
    out["eager_s"] = time.perf_counter() - t0
    out["eager_token_max_gap"] = api_token_gap(
        torch, eager, plain(cfg, eager[:, :-1]), API_PROMPT)
    want = {"fused_rope": 2 * L, "flash_attention_fwd": L,
            "rms_norm_fwd": (2 * L + 1) * (API_NEW + 1)}
    for name, n in used.items():
        if n != want.get(name, 0):
            problems.append(f"generate launched {name} {n} times, the code "
                            f"predicts {want.get(name, 0)}")

    # (c) generate_compiled: the dense decode in f32, greedy and int8
    pcfg = model._pretrain_config()
    t0 = time.perf_counter()
    dense, used = arm(lambda: model.generate_compiled(
        ids, max_new_tokens=API_NEW)._data)
    out["compiled_launches"] = {k: v for k, v in used.items() if v}
    out["compiled_s"] = time.perf_counter() - t0
    stacked = model._cached_pretrain_params()
    dense_plain = plain(f32, dense[:, :-1])
    out["compiled_logit_max_abs_diff"] = max_diff(
        [api_dense_logits(torch, pcfg, stacked, s) for s in dense[:, :-1]],
        dense_plain)
    out["compiled_token_max_gap"] = api_token_gap(torch, dense, dense_plain,
                                                  API_PROMPT)
    out["compiled_equal_eager"] = bool(torch.equal(dense, eager))
    if {k: v for k, v in used.items() if v} != {"fused_rope": 2 * L}:
        problems.append(f"generate_compiled launched {used}, the code "
                        f"predicts K5 {2 * L} times and nothing else")
    t0 = time.perf_counter()
    q8, used = arm(lambda: model.generate_compiled(
        ids, max_new_tokens=API_NEW, quantize_int8=True)._data)
    out["int8_launches"] = {k: v for k, v in used.items() if v}
    out["int8_s"] = time.perf_counter() - t0
    qparams = model._cached_pretrain_params(True)
    with patched((tlp, "int8_matmul", im.int8_matmul_plain)):
        q8_plain = plain(f32, q8[:, :-1], qparams)
    out["int8_logit_max_abs_diff"] = max_diff(
        [api_dense_logits(torch, pcfg, qparams, s) for s in q8[:, :-1]],
        q8_plain)
    out["int8_token_max_gap"] = api_token_gap(torch, q8, q8_plain,
                                              API_PROMPT)
    want_k3 = (7 * L + 1) * API_NEW
    if used["int8_matmul"] + used["int8_matmul_wave"] != want_k3:
        problems.append(f"the int8 arm launched K3 {used['int8_matmul']} + "
                        f"{used['int8_matmul_wave']} times, want {want_k3}")
    del qparams, q8_plain
    model.__dict__.pop("_gen_params", None)     # the int8 tree

    # (d) beam search on the dense decode, K beams
    t0 = time.perf_counter()
    stacked = model._cached_pretrain_params()
    (toks, scores), used = arm(lambda: make_generate_beam(
        pcfg, API_PROMPT, API_NEW, API_BEAMS)(
            stacked, torch.as_tensor(prompts, device=dev)))
    out["beam_launches"] = {k: v for k, v in used.items() if v}
    out["beam_s"] = time.perf_counter() - t0
    seqs = torch.cat([torch.as_tensor(prompts, device=dev), toks], 1)
    lp = [torch.log_softmax(x, -1) for x in plain(f32, seqs[:, :-1])]
    ref_scores = torch.stack([
        x[API_PROMPT - 1:].gather(-1, t[:, None]).sum()
        for x, t in zip(lp, toks)])
    out["beam_scores"] = scores.tolist()
    out["beam_score_max_abs_diff"] = float(
        (scores - ref_scores).abs().max())
    if out["beam_score_max_abs_diff"] > API_NEW * LOGIT_LIMIT:
        problems.append("the beams' summed log-probabilities differ from "
                        "the plain forward's by "
                        f"{out['beam_score_max_abs_diff']}")
    del stacked
    model.__dict__.pop("_gen_params", None)

    # (e) generate_auto over the serve's tree: uniform -> dense, ragged ->
    # paged (K1)
    t0 = time.perf_counter()
    uni, used_uni = arm(lambda: generate_auto(
        cfg, params, [list(r) for r in prompts], API_NEW))
    rows = [list(prompts[i, :n]) for i, n in enumerate(API_RAGGED)]
    rag, used_rag = arm(lambda: generate_auto(cfg, params, rows, API_NEW))
    out["auto_s"] = time.perf_counter() - t0
    out["auto_launches"] = {"uniform": {k: v for k, v in used_uni.items()
                                        if v},
                            "ragged": {k: v for k, v in used_rag.items()
                                       if v}}
    gaps = []
    for r, toks_ in zip(rows + [list(p) for p in prompts],
                        list(rag) + list(uni)):
        seq = torch.as_tensor(r + toks_.tolist(), device=dev)
        gaps.append(api_token_gap(torch, seq[None], plain(cfg, [seq[:-1]]),
                                  len(r)))
    out["auto_token_max_gap"] = max(gaps)
    if used_uni["paged_decode_attention"] or not used_uni["fused_rope"]:
        problems.append("generate_auto's uniform batch left the dense "
                        f"decode: {used_uni}")
    if not used_rag["paged_decode_attention"]:
        problems.append("generate_auto's ragged batch launched no K1")
    for key in ("eager", "compiled", "auto"):
        if out[f"{key}_token_max_gap"] > 2 * LOGIT_LIMIT:
            problems.append(f"a {key} token sits {out[key + '_token_max_gap']}"
                            f" below the plain top logit")
    if out["compiled_logit_max_abs_diff"] > LOGIT_LIMIT:
        problems.append("generate_compiled's logits differ from the plain "
                        f"forward's by {out['compiled_logit_max_abs_diff']}")
    if out["int8_logit_max_abs_diff"] > INT8_LOGIT_LIMIT:
        problems.append("the int8 arm's logits differ from the plain int8 "
                        f"forward's by {out['int8_logit_max_abs_diff']}")
    if out["int8_token_max_gap"] > 2 * INT8_LOGIT_LIMIT:
        problems.append(f"an int8 token sits {out['int8_token_max_gap']} "
                        "below the plain int8 top logit")
    del model
    emit("api_llama", model="LLaMA-7B (LlamaConfig defaults), the serve's "
         "bf16 weights as views", layers=L, batch=API_BATCH,
         prompt=API_PROMPT, new_tokens=API_NEW, beams=API_BEAMS,
         ragged=list(API_RAGGED), logit_limit=LOGIT_LIMIT,
         int8_logit_limit=INT8_LOGIT_LIMIT, gap_limit=2 * LOGIT_LIMIT,
         launches={k: v for k, v in launches.items() if v},
         phase_s=time.perf_counter() - t_all, **out)
    for p in problems:
        fail(f"api_llama: {p}")
    return launches


def api_dense_logits(torch, pcfg, params, seq):
    """Teacher-forced logits [S, V] of one sequence through the dense
    decode's own prefill (models/decode.py: K5, K3 on int8 weights)."""
    from paddle_tpu_torch.models import decode as tdec
    with torch.no_grad():
        x, _, _ = tdec._prefill(pcfg, params, seq[None])
        return head_logits(pcfg, params, x[0])


def phase_api_train(torch, seed, mods, dev="cuda", cfg_kw=None,
                    seq=API_TRAIN_SEQ):
    """AdamW(multi_precision=True) steps of the Layer LLaMA at LLaMA-7B's
    width (``cfg_kw`` overrides the config, for a rehearsal)."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    rp = mods["rp"]
    t_all = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    paddle.set_device("cpu" if dev == "cpu" else "gpu")
    paddle.seed(seed)
    lcfg = LlamaConfig(**dict(num_hidden_layers=API_TRAIN_LAYERS,
                              **(cfg_kw or {})))
    L, S = lcfg.num_hidden_layers, seq
    model = LlamaForCausalLM(lcfg).bfloat16()
    n_params = sum(p.size for p in model.parameters())
    opt = paddle.optimizer.AdamW(API_TRAIN_LR, parameters=model.parameters(),
                                 multi_precision=True)
    toks = np.random.RandomState(seed).randint(0, lcfg.vocab_size,
                                               (API_BATCH, S + 1))
    x, y = paddle.to_tensor(toks[:, :-1]), paddle.to_tensor(toks[:, 1:])
    problems = []

    def grads():
        loss = model(x, labels=y)
        loss.backward()
        g = [p.grad._data.clone() for p in model.parameters()]
        model.clear_gradients()
        return float(loss), g

    def worst(a, b):
        return max(float((u.float() - v.float()).abs().max()
                         / v.float().abs().max()) for u, v in zip(a, b))

    # one step's gradients: kernels, plain versions, a planted fault
    t0 = time.perf_counter()
    zero_counts(mods)
    loss_k, g_k = grads()
    per_step = {k: v for k, v in read_counts(mods).items() if v}
    with op_impls(api_plain_impls(torch, mods)):
        zero_counts(mods)
        loss_p, g_p = grads()
        if any(read_counts(mods).values()):
            problems.append("the plain pass launched a kernel")
    real_rope = rp._apply
    with patched((rp, "_apply", lambda x, cos, sin, neg_sin:
                  real_rope(x, cos, sin, False))):
        _, g_f = grads()
    diff, fault_diff = worst(g_k, g_p), worst(g_f, g_p)
    del g_p, g_f
    finite = all(bool(torch.isfinite(g).all()) for g in g_k)
    del g_k
    check_s = time.perf_counter() - t0
    want = {"fused_rope": 4 * L, "flash_attention_fwd": L,
            "flash_attention_bwd_dq": L, "flash_attention_bwd_dkv": L,
            "rms_norm_fwd": 2 * L + 1, "rms_norm_bwd": 2 * L + 1}
    if per_step != want:
        problems.append(f"a step launched {per_step}, the code predicts "
                        f"{want}")
    # the steps
    zero_counts(mods)
    losses, step_ms = [], []
    torch.cuda.synchronize()
    for _ in range(API_TRAIN_STEPS):
        t = time.perf_counter()
        loss = model(x, labels=y)
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t) * 1e3)
    launches = read_counts(mods)
    emit("api_train", model="LlamaForCausalLM at LLaMA-7B width, bf16 "
         "parameters, AdamW(multi_precision=True)", layers=L,
         params=n_params, batch=API_BATCH, seq=S, lr=API_TRAIN_LR,
         losses=losses, step_ms=step_ms,
         tokens_per_s=[API_BATCH * S / (t / 1e3) for t in step_ms],
         launches_per_step=per_step, loss_kernels=loss_k,
         loss_plain=loss_p, grad_max_rel_diff=diff, grad_limit=GRAD_LIMIT,
         planted_fault="the RoPE backward rotating with +sin instead of "
         "-sin", planted_fault_max_rel_diff=fault_diff, check_s=check_s,
         peak_gb=torch.cuda.max_memory_allocated() / 2**30,
         phase_s=time.perf_counter() - t_all)
    if not finite:
        problems.append("a gradient is not finite")
    if diff > GRAD_LIMIT:
        problems.append(f"the kernels' gradients differ from their plain "
                        f"versions' by {diff} of a leaf's largest")
    if fault_diff <= GRAD_LIMIT:
        problems.append(f"the planted fault moved the gradients by only "
                        f"{fault_diff}, within the limit")
    if not losses[-1] < losses[0]:
        problems.append(f"the loss did not fall: {losses}")
    for p in problems:
        fail(f"api_train: {p}")
    return launches


# api_bert / api_gpt: the BERT and GPT Layer models (models/bert.py,
# models/gpt.py) trained through incubate.jit_train_step, one CUDA graph a
# step, under AMP O1 (f32 parameters, bf16 products).  api_bert is
# bench.py's _bert_line TPU recipe (bench.py:354-386: BASELINE config 3,
# Devlin et al. 2019's SQuAD fine-tune); api_gpt is gpt3_1p3b_config with
# GPT-3's optimizer settings (Brown et al. 2020, Table 2.1 and Appendix B)
# at batch 2 x 2048 on one card (BASELINE config 4 shards it; that waits
# for a mesh).  JIT_LOSS_LIMIT bounds a replayed loss against the eager
# loop's, relative: the same kernels, the eager optimizer's Python-float
# beta powers rounding apart from the graph's device scalars.
API_BERT_BATCH, API_BERT_SEQ, API_BERT_LR = 32, 384, 5e-5
API_BERT_STEPS, API_BERT_CHECK_STEPS = 5, 3
API_GPT_BATCH, API_GPT_SEQ, API_GPT_LR = 2, 2048, 2e-4
API_GPT_STEPS, API_GPT_EAGER_STEPS = 5, 3
JIT_LOSS_LIMIT = 2e-3
K6_NAMES = ("flash_attention_fwd", "flash_attention_bwd_dq",
            "flash_attention_bwd_dkv")


def jit_grads(torch, paddle, model, loss_of, seed):
    """One O1 forward and backward of ``loss_of()`` after
    ``paddle.seed(seed)`` (the same dropout masks every call) -> (loss,
    {name: gradient in bf16} over the leaves the loss reaches)."""
    named = list(model.named_parameters())
    paddle.seed(seed)
    with paddle.amp.auto_cast(level="O1"):
        loss = loss_of()
    grads = torch.autograd.grad(loss._data, [p._data for _, p in named],
                                allow_unused=True)
    return float(loss), {name: g.to(torch.bfloat16)
                         for (name, _), g in zip(named, grads)
                         if g is not None}


# grad_gap's yardstick for a leaf: its own largest |gradient|, or this
# share of the model's largest where that is more.  Some leaves' gradients
# are zero in exact arithmetic, so their largest element is rounding noise
# and no yardstick: the attention's key bias (softmax ignores a shift of a
# row's scores) and, under the QA loss (a softmax over positions), the
# last LayerNorm's bias.
GRAD_FLOOR = 1e-2


def grad_gap(got, ref):
    """(the largest |got - ref| over its leaf's yardstick, that leaf)."""
    top = max(float(r.float().abs().max()) for r in ref.values())
    return max((float((got[n].float() - r.float()).abs().max())
                / max(float(r.float().abs().max()), GRAD_FLOOR * top), n)
               for n, r in ref.items())


def k6_grad_check(torch, paddle, mods, model, loss_of, seed):
    """Kernels, plain versions (the op table's ``flash_attention`` entry
    sent to ``sdpa_plain``) and a planted fault (the kernels told the
    other causality) -> (loss kernels, loss plain, (gap, leaf), (fault
    gap, leaf), the kernels' launches in the kernels' pass, the plain
    pass's, every gradient finite)."""
    fa = mods["fa"]
    zero_counts(mods)
    loss_k, g_k = jit_grads(torch, paddle, model, loss_of, seed)
    launched = {k: v for k, v in read_counts(mods).items() if v}
    with op_impls(api_plain_impls(torch, mods)):
        zero_counts(mods)
        loss_p, g_p = jit_grads(torch, paddle, model, loss_of, seed)
        plain_launched = {k: v for k, v in read_counts(mods).items() if v}
    real_tail = fa._launch_tail
    with patched((fa, "_launch_tail",
                  lambda q, causal: real_tail(q, not causal))):
        _, g_f = jit_grads(torch, paddle, model, loss_of, seed)
    finite = all(bool(torch.isfinite(g).all()) for g in g_k.values())
    return (loss_k, loss_p, grad_gap(g_k, g_p), grad_gap(g_f, g_p),
            launched, plain_launched, finite)


def timed_calls(torch, fn, n):
    """``n`` calls of ``fn() -> loss``, each timed to its loss on the host
    -> (losses, ms)."""
    losses, ms = [], []
    for _ in range(n):
        torch.cuda.synchronize()
        t = time.perf_counter()
        losses.append(float(fn()))
        ms.append((time.perf_counter() - t) * 1e3)
    return losses, ms


def device_kind(name):
    """A CUDA kernel's kind, by its name, for the api phases' profiles."""
    low = name.lower()
    for tag, kind in (("flash_fwd_kernel", "K6a"), ("flash_bwd_dq", "K6b"),
                      ("flash_bwd_dkv", "K6c"), ("layer_norm", "layer_norm"),
                      ("softmax", "softmax"), ("reduce", "reduce")):
        if tag in low:
            return kind
    if any(t in low for t in ("gemm", "gemv", "nvjet", "cutlass", "cublas",
                              "xmma")):
        return "matmul (cuBLAS)"
    if "elementwise" in low or "vectorized" in low:
        return "elementwise"
    return "other"


def profiled_call(torch, fn, kind_of=None):
    """``fn()`` once under a CUDA-only profiler -> {host ms to its end,
    device ms, busy share, device ms by kind (``kind_of(kernel name)``,
    ``device_kind`` by default)}."""
    kind_of = kind_of or device_kind
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CUDA])
    with prof:
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        host = (time.perf_counter() - t) * 1e3
    kinds = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            k = kind_of(e.name)
            kinds[k] = kinds.get(k, 0.0) + e.time_range.elapsed_us() / 1e3
    device = sum(kinds.values())
    return {"host_ms": host, "device_ms": device,
            "busy_share": device / host,
            "device_ms_by_kind": dict(sorted(kinds.items(),
                                             key=lambda kv: -kv[1]))}


def eager_o1_step(paddle, model, loss_fn, opt, x, y):
    with paddle.amp.auto_cast(level="O1"):
        loss = loss_fn(model(*x), y)
    loss.backward()
    opt.step()
    opt.clear_grad()
    return loss


def step_launches(step):
    """The K6 launches each replay of each of ``step``'s graphs makes."""
    return [{k: g.capture_launches.get(k, 0) for k in K6_NAMES}
            for g in step.graphs()]


def steps_ran_launches(wrapper, steps):
    """The launches that ran since the counters were zeroed, while
    ``steps`` (jit_train_step functions) were made and driven: the
    wrappers' counts, less what they recorded into each step's graphs at
    capture, plus every replay's."""
    out = dict(wrapper)
    for step in steps:
        for g in step.graphs():
            for k, c in g.capture_launches.items():
                out[k] = out.get(k, 0) + (g.replays - 1) * c
    return out


def phase_api_bert(torch, seed, mods, card, dev="cuda", cfg_kw=None,
                   batch=API_BERT_BATCH, seq=API_BERT_SEQ):
    """BERT-base SQuAD fine-tune through jit_train_step (``cfg_kw`` and
    the batch shape override the recipe, for a rehearsal)."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.incubate import jit_train_step
    from paddle_tpu_torch.models import BertConfig, BertForQuestionAnswering
    fa = mods["fa"]
    t_all = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    start_gb = torch.cuda.memory_allocated() / 2**30
    paddle.set_device("cpu" if dev == "cpu" else "gpu")
    problems = []

    def config(dropout):
        return BertConfig(**dict(dict(cfg_kw or {}), dropout_prob=dropout))

    cfg = config(0.1)
    L = cfg.num_hidden_layers
    rng = np.random.RandomState(0)               # bench.py:372-378
    ids = paddle.to_tensor(rng.randint(0, cfg.vocab_size, (batch, seq)))
    tt = paddle.to_tensor(np.zeros((batch, seq), np.int64))
    mask = paddle.to_tensor(np.ones((batch, seq), np.float32))
    start = paddle.to_tensor(rng.randint(0, seq, (batch,)))
    end = paddle.to_tensor(rng.randint(0, seq, (batch,)))
    x_masked, x_free, ys = (ids, tt, mask), (ids, tt), (start, end)
    ce = paddle.nn.CrossEntropyLoss()

    def qa_loss(out, y):
        return (ce(out[0], y[0]) + ce(out[1], y[1])) * 0.5

    def adamw(net, lr=API_BERT_LR):
        return paddle.optimizer.AdamW(learning_rate=lr,
                                      parameters=net.parameters())

    def model(dropout):
        paddle.seed(55)
        net = BertForQuestionAnswering(config(dropout))
        net.train()
        return net

    # (1) the mask-free arm's gradients: kernels, plain versions, a fault
    t0 = time.perf_counter()
    net = model(0.1)
    lk, lp, (gap, gap_leaf), (fault_gap, _), launched, plain_launched, \
        finite = k6_grad_check(torch, paddle, mods, net,
                               lambda: qa_loss(net(*x_free), ys), seed)
    want = {k: L for k in K6_NAMES}
    if {k: launched.get(k, 0) for k in K6_NAMES} != want:
        problems.append(f"the mask-free step launched {launched}, the code "
                        f"predicts {want}")
    if plain_launched:
        problems.append(f"the plain pass launched {plain_launched}")
    # (2) dropout 0: replays against the eager loop
    nets0 = [model(0.0), model(0.0)]
    step0 = jit_train_step(nets0[0], qa_loss, adamw(nets0[0]),
                           amp_level="O1")
    opt_e = adamw(nets0[1])
    replayed0 = [float(step0(x_masked, ys))
                 for _ in range(API_BERT_CHECK_STEPS)]
    eager0 = [float(eager_o1_step(paddle, nets0[1], qa_loss, opt_e,
                                  x_masked, ys))
              for _ in range(API_BERT_CHECK_STEPS)]
    gap0 = max(abs(a - b) / abs(b) for a, b in zip(replayed0, eager0))
    del nets0, step0, opt_e
    # (3) dropout 0.1 at lr 0: fresh masks every replay, the same masks in
    # a second lane built after the same seed
    drop_runs = []
    for _ in range(2):
        net_d = model(0.1)
        step_d = jit_train_step(net_d, qa_loss, adamw(net_d, lr=0.0),
                                amp_level="O1")
        paddle.seed(seed + 1)
        drop_runs.append([float(step_d(x_masked, ys))
                          for _ in range(API_BERT_CHECK_STEPS)])
        del net_d, step_d
    torch.cuda.empty_cache()
    check_s = time.perf_counter() - t0

    # (4) the main path: the recipe's replays, the eager loop, the
    # mask-free arm's replays
    plain_calls = []
    real_plain = fa.sdpa_plain
    opt = adamw(net)
    step = jit_train_step(net, qa_loss, opt, amp_level="O1")
    zero_counts(mods)
    with patched((fa, "sdpa_plain", lambda *a, **k: plain_calls.append(1)
                  or real_plain(*a, **k))):
        t = time.perf_counter()
        first = float(step(x_masked, ys))
        capture_s = time.perf_counter() - t
        losses, step_ms = timed_calls(torch, lambda: step(x_masked, ys),
                                      API_BERT_STEPS)
        eager_losses, eager_ms = timed_calls(
            torch, lambda: eager_o1_step(paddle, net, qa_loss, opt,
                                         x_masked, ys), API_BERT_STEPS)
        t = time.perf_counter()
        first_free = float(step(x_free, ys))
        capture_free_s = time.perf_counter() - t
        free_losses, free_ms = timed_calls(torch, lambda: step(x_free, ys),
                                           API_BERT_STEPS)
        profiles = {
            "replay_masked": profiled_call(torch,
                                           lambda: step(x_masked, ys)),
            "replay_mask_free": profiled_call(torch,
                                              lambda: step(x_free, ys)),
            "eager_masked": profiled_call(
                torch, lambda: eager_o1_step(paddle, net, qa_loss, opt,
                                             x_masked, ys))}
    launches = steps_ran_launches(read_counts(mods), [step])
    per_replay = step_launches(step)
    emit("api_bert", model="BertForQuestionAnswering, BertConfig() "
         "defaults (12 x 768, 12 heads of 64, FFN 3072, vocab 30522)",
         source="bench.py:354-386 _bert_line TPU recipe (BASELINE config "
         "3; Devlin et al. 2019 SQuAD fine-tune)", dropout=0.1,
         batch=batch, seq=seq, lr=API_BERT_LR, amp="O1 bf16",
         params=sum(p.size for p in net.parameters()),
         capture_s=capture_s, first_loss=first, losses=losses,
         step_ms=step_ms,
         samples_per_s=[batch / (t / 1e3) for t in step_ms],
         eager_losses=eager_losses, eager_step_ms=eager_ms,
         eager_samples_per_s=[batch / (t / 1e3) for t in eager_ms],
         mask_free=dict(capture_s=capture_free_s, first_loss=first_free,
                        losses=free_losses, step_ms=free_ms,
                        samples_per_s=[batch / (t / 1e3) for t in free_ms],
                        grad_loss_kernels=lk, grad_loss_plain=lp,
                        grad_max_rel_diff=gap, grad_worst_leaf=gap_leaf,
                        grad_limit=GRAD_LIMIT,
                        planted_fault="K6a-c told causal=True",
                        planted_fault_max_rel_diff=fault_gap),
         k6_per_replay_masked_then_mask_free=per_replay,
         dropout0_replayed=replayed0, dropout0_eager=eager0,
         dropout0_max_rel_gap=gap0, jit_loss_limit=JIT_LOSS_LIMIT,
         dropout01_lr0_runs=drop_runs, sdpa_plain_calls=len(plain_calls),
         profiles=profiles,
         check_s=check_s, start_gb=start_gb,
         peak_gb=torch.cuda.max_memory_allocated() / 2**30,
         phase_s=time.perf_counter() - t_all, card=card)
    if not finite:
        problems.append("a gradient is not finite")
    if gap > GRAD_LIMIT:
        problems.append(f"the mask-free arm's gradients differ from the "
                        f"plain versions' by {gap} of a leaf's largest")
    if fault_gap <= GRAD_LIMIT:
        problems.append(f"the planted fault moved the gradients by only "
                        f"{fault_gap}, within the limit")
    if gap0 > JIT_LOSS_LIMIT:
        problems.append(f"the replayed losses {replayed0} differ from the "
                        f"eager loop's {eager0} by {gap0}")
    if len(set(drop_runs[0])) != len(drop_runs[0]):
        problems.append(f"dropout drew a mask twice: {drop_runs[0]}")
    if drop_runs[0] != drop_runs[1]:
        problems.append(f"the seeded dropout runs differ: {drop_runs}")
    if per_replay != [{k: 0 for k in K6_NAMES}, want]:
        problems.append(f"the graphs launch {per_replay} a replay (masked, "
                        f"mask-free), the code predicts 0 and {want}")
    if plain_calls:
        problems.append(f"{len(plain_calls)} attentions reached sdpa_plain")
    if not all(math.isfinite(v) for v in losses + eager_losses +
               free_losses):
        problems.append("a loss is not finite")
    for p in problems:
        fail(f"api_bert: {p}")
    del step, net, opt
    torch.cuda.empty_cache()
    return launches


def phase_api_gpt(torch, seed, mods, card, dev="cuda", cfg_kw=None,
                  batch=API_GPT_BATCH, seq=API_GPT_SEQ):
    """GPT-3 XL pretraining steps through jit_train_step (``cfg_kw`` and
    the batch shape override the recipe, for a rehearsal)."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.incubate import jit_train_step
    from paddle_tpu_torch.models import (GPTForCausalLM,
                                         GPTPretrainingCriterion,
                                         gpt3_1p3b_config)
    fa = mods["fa"]
    t_all = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    start_gb = torch.cuda.memory_allocated() / 2**30
    paddle.set_device("cpu" if dev == "cpu" else "gpu")
    problems = []
    cfg = gpt3_1p3b_config(**(cfg_kw or {}))
    L = cfg.num_hidden_layers
    paddle.seed(seed)
    net = GPTForCausalLM(cfg)
    crit = GPTPretrainingCriterion()
    ids = paddle.to_tensor(np.random.RandomState(seed).randint(
        0, cfg.vocab_size, (batch, seq)))
    t0 = time.perf_counter()
    lk, lp, (gap, gap_leaf), (fault_gap, _), launched, plain_launched, \
        finite = k6_grad_check(torch, paddle, mods, net,
                               lambda: crit(net(ids), ids), seed)
    want = {k: L for k in K6_NAMES}
    if {k: launched.get(k, 0) for k in K6_NAMES} != want:
        problems.append(f"the step launched {launched}, the code predicts "
                        f"{want}")
    if plain_launched:
        problems.append(f"the plain pass launched {plain_launched}")
    torch.cuda.empty_cache()
    check_s = time.perf_counter() - t0
    opt = paddle.optimizer.AdamW(
        learning_rate=API_GPT_LR, beta1=0.9, beta2=0.95, weight_decay=0.1,
        parameters=net.parameters(),
        grad_clip=paddle.nn.ClipGradByGlobalNorm(1.0))
    plain_calls = []
    real_plain = fa.sdpa_plain
    zero_counts(mods)
    with patched((fa, "sdpa_plain", lambda *a, **k: plain_calls.append(1)
                  or real_plain(*a, **k))):
        eager_losses, eager_ms = timed_calls(
            torch, lambda: eager_o1_step(paddle, net, crit, opt, (ids,),
                                         ids), API_GPT_EAGER_STEPS)
        profiles = {"eager": profiled_call(
            torch, lambda: eager_o1_step(paddle, net, crit, opt, (ids,),
                                         ids))}
        torch.cuda.empty_cache()
        step = jit_train_step(net, crit, opt, amp_level="O1")
        t = time.perf_counter()
        first = float(step(ids, ids))
        capture_s = time.perf_counter() - t
        losses, step_ms = timed_calls(torch, lambda: step(ids, ids),
                                      API_GPT_STEPS)
        profiles["replay"] = profiled_call(torch, lambda: step(ids, ids))
    launches = steps_ran_launches(read_counts(mods), [step])
    per_replay = step_launches(step)
    tokens = batch * seq
    emit("api_gpt", model="GPTForCausalLM, gpt3_1p3b_config (GPT-3 XL: 24 "
         "x 2048, 16 heads of 128, vocab 50304, 2048 positions)",
         source="gpt3_1p3b_config (paddle_tpu/models/gpt.py:47); GPT-3 "
         "Table 2.1 / Appendix B optimizer (Brown et al. 2020)",
         layers=L, batch=batch, seq=seq, lr=API_GPT_LR, amp="O1 bf16",
         clip="ClipGradByGlobalNorm(1.0)",
         params=sum(p.size for p in net.parameters()),
         grad_loss_kernels=lk, grad_loss_plain=lp, grad_max_rel_diff=gap,
         grad_worst_leaf=gap_leaf, grad_limit=GRAD_LIMIT,
         planted_fault="K6a-c told causal=False",
         planted_fault_max_rel_diff=fault_gap, check_s=check_s,
         eager_losses=eager_losses, eager_step_ms=eager_ms,
         eager_tokens_per_s=[tokens / (t / 1e3) for t in eager_ms],
         capture_s=capture_s, first_loss=first, losses=losses,
         step_ms=step_ms, tokens_per_s=[tokens / (t / 1e3) for t in step_ms],
         k6_per_replay=per_replay, profiles=profiles,
         sdpa_plain_calls=len(plain_calls), start_gb=start_gb,
         peak_gb=torch.cuda.max_memory_allocated() / 2**30,
         phase_s=time.perf_counter() - t_all, card=card)
    if not finite:
        problems.append("a gradient is not finite")
    if gap > GRAD_LIMIT:
        problems.append(f"the kernels' gradients differ from the plain "
                        f"versions' by {gap} of a leaf's largest")
    if fault_gap <= GRAD_LIMIT:
        problems.append(f"the planted fault moved the gradients by only "
                        f"{fault_gap}, within the limit")
    if per_replay != [want]:
        problems.append(f"the graph launches {per_replay} a replay, the "
                        f"code predicts {want}")
    if plain_calls:
        problems.append(f"{len(plain_calls)} attentions reached sdpa_plain")
    if not losses[-1] < losses[0]:
        problems.append(f"the loss did not fall over the replays: {losses}")
    if not all(math.isfinite(v) for v in losses + eager_losses):
        problems.append("a loss is not finite")
    for p in problems:
        fail(f"api_gpt: {p}")
    del step, net, opt
    torch.cuda.empty_cache()
    return launches


# api_fit: BASELINE config 1 (BASELINE.md, "Benchmark configurations"):
# LeNet through Model.fit on the synthetic MNIST, Adam(1e-3), batch 64,
# 2 epochs, two DataLoader workers over shared memory
API_FIT_BATCH, API_FIT_EPOCHS, API_FIT_WORKERS, API_FIT_LR = 64, 2, 2, 1e-3
API_FIT_ACC = 0.9          # JAX's Model.fit reaches 1.0 on the CPU
# the loss over a run's last 8 batches against its first 8: the recipe's
# falls by more than this share, the planted fault's (a replay that skips
# the optimizer) moves by less
API_FIT_FLAT = 0.05


class _LossLog:
    """A Model.fit callback: each train batch's loss and wall ms."""

    def __init__(self):
        from paddle_tpu_torch.callbacks import Callback

        class Log(Callback):
            def on_train_batch_begin(cb, step, logs=None):
                cb.t = time.perf_counter()

            def on_train_batch_end(cb, step, logs=None):
                cb.ms.append((time.perf_counter() - cb.t) * 1e3)
                cb.losses.append(float(np.asarray(logs["loss"]).ravel()[0]))

        self.cb = Log()
        self.cb.losses, self.cb.ms = [], []


def fit_trend(losses):
    """The mean loss of the last 8 batches over the first 8's, less 1."""
    return float(np.mean(losses[-8:]) / np.mean(losses[:8]) - 1.0)


def phase_api_fit(torch, seed, card, dev="cuda"):
    """BASELINE config 1: Model(LeNet()).fit over DataLoader workers."""
    import os
    import shutil
    import tempfile
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.io import worker as tworker
    from paddle_tpu_torch.vision import transforms as T
    from paddle_tpu_torch.vision.datasets import MNIST
    from paddle_tpu_torch.vision.models import LeNet
    t_all = time.perf_counter()
    paddle.set_device("cpu" if dev == "cpu" else "gpu")
    problems = []
    norm = T.Normalize(mean=[0.5], std=[0.5])
    train = MNIST(mode="train", transform=norm)
    test = MNIST(mode="test", transform=norm)

    def build(s):
        paddle.seed(s)
        net = LeNet()
        model = paddle.Model(net)
        model.prepare(paddle.optimizer.Adam(API_FIT_LR,
                                            parameters=net.parameters()),
                      paddle.nn.CrossEntropyLoss(), paddle.metric.Accuracy())
        return model

    model = build(seed)
    log = _LossLog()
    shm0 = tworker.shm_batches
    np.random.seed(seed)
    t = time.perf_counter()
    # the workers start once (a spawned worker imports torch) and serve
    # both epochs
    loader = paddle.io.DataLoader(
        train, batch_size=API_FIT_BATCH, shuffle=True,
        num_workers=API_FIT_WORKERS, use_shared_memory=True,
        persistent_workers=True)
    model.fit(loader, epochs=API_FIT_EPOCHS, verbose=0, callbacks=[log.cb])
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t
    shm = tworker.shm_batches - shm0
    loader._workers.shutdown()
    steps = len(log.cb.losses)
    graphs = model._adapter._jit_step.graphs()
    t = time.perf_counter()
    ev = model.evaluate(test, batch_size=API_FIT_BATCH, verbose=0)
    eval_s = time.perf_counter() - t
    t = time.perf_counter()
    pred = model.predict(test, batch_size=API_FIT_BATCH, stack_outputs=True,
                         verbose=0)[0]
    predict_s = time.perf_counter() - t
    tmp = tempfile.mkdtemp(prefix="api_fit_")
    try:
        model.save(os.path.join(tmp, "lenet"))
        fresh = build(seed + 1)
        fresh.load(os.path.join(tmp, "lenet"))
        ev2 = fresh.evaluate(test, batch_size=API_FIT_BATCH, verbose=0)
        pred2 = fresh.predict(test, batch_size=API_FIT_BATCH,
                              stack_outputs=True, verbose=0)[0]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    # the planted fault: the optimizer's rule returns the parameter as it
    # was, so every replay leaves the weights where they were
    faulted = build(seed)
    faulted._optimizer._update = lambda param, grad, state, lr: (param, {})
    flog = _LossLog()
    np.random.seed(seed)
    faulted.fit(train, batch_size=API_FIT_BATCH, epochs=1, verbose=0,
                callbacks=[flog.cb])
    fgraphs = faulted._adapter._jit_step.graphs()
    trend, fault_trend = fit_trend(log.cb.losses), fit_trend(flog.cb.losses)
    emit("api_fit", model="LeNet (vision/models/lenet.py), 61,610 "
         "parameters", source="BASELINE.md config 1 (LeNet MNIST via "
         "Model.fit); synthetic MNIST (vision/datasets.py, 2,048 train / "
         "512 test)", transform="Normalize(0.5, 0.5)",
         optimizer=f"Adam({API_FIT_LR})", batch=API_FIT_BATCH,
         epochs=API_FIT_EPOCHS, num_workers=API_FIT_WORKERS,
         use_shared_memory=True, persistent_workers=True, steps=steps,
         captures=len(graphs), replays=[g.replays for g in graphs],
         shm_batches=shm, fit_s=fit_s,
         samples_per_s=steps * API_FIT_BATCH / fit_s,
         step_ms_median=float(np.median(log.cb.ms)) if log.cb.ms else None,
         first_losses=log.cb.losses[:4], last_losses=log.cb.losses[-4:],
         loss_trend=trend, eval=ev, eval_s=eval_s, predict_s=predict_s,
         predict_shape=list(pred.shape),
         reloaded_eval_equal=ev2 == ev,
         reloaded_predict_equal=bool(np.array_equal(pred, pred2)),
         planted_fault="the optimizer's rule returns the parameter unchanged",
         planted_fault_trend=fault_trend, flat_bar=API_FIT_FLAT,
         planted_fault_replays=[g.replays for g in fgraphs],
         phase_s=time.perf_counter() - t_all, card=card)
    want_steps = API_FIT_EPOCHS * len(train) // API_FIT_BATCH
    if steps != want_steps:
        problems.append(f"{steps} train batches, want {want_steps}")
    if [g.replays for g in graphs] != [steps]:
        problems.append(f"fit's graphs replayed {[g.replays for g in graphs]}"
                        f", want one graph replayed {steps} times")
    if shm != steps:
        problems.append(f"{shm} batches came through shared memory, want "
                        f"fit's {steps}")
    if not ev["acc"] >= API_FIT_ACC:
        problems.append(f"accuracy {ev['acc']} below {API_FIT_ACC}")
    if ev2 != ev or not np.array_equal(pred, pred2):
        problems.append(f"the reloaded Model evaluates {ev2}, the trained "
                        f"one {ev}")
    if not np.isfinite(pred).all() or list(pred.shape) != [len(test), 10]:
        problems.append(f"predict gave {list(pred.shape)} or a non-finite "
                        f"value")
    if not trend < -API_FIT_FLAT:
        problems.append(f"the loss moved by {trend} over the run")
    if abs(fault_trend) > API_FIT_FLAT or \
            [g.replays for g in fgraphs] != [len(flog.cb.losses)]:
        problems.append(f"the planted fault moved the loss by {fault_trend}"
                        f" (replays {[g.replays for g in fgraphs]})")
    for p in problems:
        fail(f"api_fit: {p}")
    del model, fresh, faulted
    torch.cuda.empty_cache()


# api_resnet: _resnet_line's TPU recipe (bench.py:302-330, BASELINE
# config 2) on one card: resnet50(num_classes=1000), batch 256 x 3 x 224 x
# 224 from np.random.RandomState(0), Momentum(0.1, 0.9), jit_train_step at
# O1 bf16, 2 warm-up replays then 5 timed on two alternating batches.
# BASELINE config 2's data parallelism is cut to one card (ROADMAP.md
# queue 1 item 9(a)).
RESNET_BATCH, RESNET_HW, RESNET_CLASSES = 256, 224, 1000
RESNET_WARM, RESNET_TIMED, RESNET_EAGER = 2, 5, 3
# the parity gate, at full width and a smaller batch: RESNET_CHECK_STEPS
# replays against the eager O1 loop from the same weights on the same
# batches; each loss within RESNET_LOSS_LIMIT (relative), every
# BatchNorm's _mean / _variance within RESNET_STAT_LIMIT of the buffer's
# largest |value| (cuDNN's backward sums in no fixed order, and two
# momentum steps carry that on); the planted fault (torch's convention,
# Paddle's momentum 0.9 taken as the new statistic's share) must land
# beyond the stat bar
RESNET_CHECK_BATCH, RESNET_CHECK_STEPS = 32, 3
RESNET_LOSS_LIMIT, RESNET_STAT_LIMIT = 2e-3, 1e-2


def resnet_kind(name):
    """A CUDA kernel's kind for api_resnet's profile."""
    low = name.lower()
    if any(t in low for t in ("batch_norm", "batchnorm", "bn_fw", "bn_bw",
                              "bn_")):
        return "batchnorm"
    if any(t in low for t in ("conv", "fprop", "dgrad", "wgrad", "implicit",
                              "winograd", "nchwtonhwc", "nhwctonchw",
                              "cudnn")):
        return "conv"
    if any(t in low for t in ("gemm", "gemv", "nvjet", "cutlass", "cublas",
                              "xmma")):
        return "matmul"
    if "elementwise" in low or "vectorized" in low:
        return "elementwise"
    return "other"


class _TorchMomentum:
    """torch.nn.functional with batch_norm given Paddle's momentum as
    torch's (the new statistic's share): api_resnet's planted fault."""

    def __getattr__(self, name):
        import torch.nn.functional as TF
        return getattr(TF, name)

    @staticmethod
    def batch_norm(a, m, v, w=None, b=None, training=False, momentum=0.1,
                   eps=1e-5):
        import torch.nn.functional as TF
        return TF.batch_norm(a, m, v, w, b, training,
                             1.0 - momentum if training else momentum, eps)


def bn_stat_gap(a, b):
    """The largest gap between two models' BatchNorm buffers, each over its
    buffer's largest |value| in ``b``."""
    return max(float((x._data - y._data).abs().max()) /
               max(float(y._data.abs().max()), 1e-12)
               for x, y in zip(a.buffers(), b.buffers()))


def phase_api_resnet(torch, seed, card, dev="cuda", arch="resnet50",
                     batch=RESNET_BATCH, hw=RESNET_HW,
                     classes=RESNET_CLASSES, check_batch=RESNET_CHECK_BATCH,
                     phase="api_resnet", source=None):
    """_resnet_line's recipe on one card (``arch``, the batch and the
    image size override it, for a rehearsal; api_vision runs it for
    MobileNetV3-Large as ``phase``, with its ``source``).  The parity
    check's models drop nothing (each Dropout's p set to 0: a replay draws
    its masks afresh, the eager loop others), the timed recipe keeps
    the model's dropout."""
    import paddle_tpu_torch as paddle
    import paddle_tpu_torch.nn.functional as pF
    from paddle_tpu_torch.incubate import jit_train_step
    from paddle_tpu_torch.vision import models as vm
    t_all = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    start_gb = torch.cuda.memory_allocated() / 2**30
    paddle.set_device("cpu" if dev == "cpu" else "gpu")
    problems = []
    rng = np.random.RandomState(0)                  # bench.py:318-322
    xs_np = [rng.randn(batch, 3, hw, hw).astype(np.float32)
             for _ in range(2)]
    ys_np = [rng.randint(0, classes, (batch,)).astype(np.int64)
             for _ in range(2)]
    ce = paddle.nn.CrossEntropyLoss()

    def build(like=None, dropout0=False):
        paddle.seed(seed)
        net = getattr(vm, arch)(num_classes=classes)
        if like is not None:
            net.set_state_dict(like.state_dict())
        if dropout0:
            for layer in net.sublayers():
                if isinstance(layer, paddle.nn.Dropout):
                    layer.p = 0.0
        net.train()
        return net, paddle.optimizer.Momentum(
            learning_rate=0.1, momentum=0.9, parameters=net.parameters())

    # (1) parity at full width, batch check_batch
    t0 = time.perf_counter()
    cx = [paddle.to_tensor(x[:check_batch]) for x in xs_np]
    cy = [paddle.to_tensor(y[:check_batch]) for y in ys_np]
    net_g, opt_g = build(dropout0=True)
    net_e, opt_e = build(net_g, dropout0=True)
    net_f, opt_f = build(net_g, dropout0=True)
    step_g = jit_train_step(net_g, ce, opt_g, amp_level="O1")
    replayed, eager, loss_gap, stat_gaps = [], [], 0.0, []
    for i in range(RESNET_CHECK_STEPS):
        x, y = cx[i % 2], cy[i % 2]
        replayed.append(float(step_g(x, y)))
        eager.append(float(eager_o1_step(paddle, net_e, ce, opt_e, (x,), y)))
        with patched((pF, "TF", _TorchMomentum())):
            eager_o1_step(paddle, net_f, ce, opt_f, (x,), y)
        loss_gap = max(loss_gap, abs(replayed[-1] - eager[-1]) /
                       abs(eager[-1]))
        stat_gaps.append(bn_stat_gap(net_g, net_e))
    fault_gap = bn_stat_gap(net_f, net_e)
    check_replays = [g.replays for g in step_g.graphs()]
    del step_g, net_g, net_e, net_f, opt_g, opt_e, opt_f, cx, cy
    torch.cuda.empty_cache()
    check_s = time.perf_counter() - t0

    # (2) the recipe at batch: the eager loop first, its pool freed, then
    # the capture and the replays
    xs = [paddle.to_tensor(x) for x in xs_np]
    ys = [paddle.to_tensor(y) for y in ys_np]
    del xs_np, ys_np
    net, opt = build()
    turn = [0]

    def alternate(fn):
        def call():
            i = turn[0]
            turn[0] += 1
            return fn(xs[i % 2], ys[i % 2])
        return call

    eager_losses, eager_ms = timed_calls(torch, alternate(
        lambda x, y: eager_o1_step(paddle, net, ce, opt, (x,), y)),
        RESNET_EAGER)
    eager_peak_gb = torch.cuda.max_memory_allocated() / 2**30
    torch.cuda.empty_cache()
    step = jit_train_step(net, ce, opt, amp_level="O1")
    turn[0] = 0
    t = time.perf_counter()
    first = float(step(xs[0], ys[0]))
    capture_s = time.perf_counter() - t
    turn[0] = 1
    warm_losses, warm_ms = timed_calls(torch, alternate(step),
                                       RESNET_WARM - 1)
    losses, step_ms = timed_calls(torch, alternate(step), RESNET_TIMED)
    profile = profiled_call(torch, lambda: step(xs[0], ys[0]), resnet_kind)
    replays = [g.replays for g in step.graphs()]
    replay_losses = [first] + warm_losses + losses
    # the replays alternate the two batches: the loss falls when the last
    # pair (one replay on each batch) averages below the first pair
    pairs = (float(np.mean(replay_losses[:2])),
             float(np.mean(replay_losses[-2:])))
    emit(phase, model=f"{arch}(num_classes={classes}) (vision/models/"
         f"{vm_file(vm, arch)})", source=source or "bench.py:302-330 "
         "_resnet_line TPU recipe (BASELINE config 2: ResNet-50 "
         "ImageNet-shape training)",
         cut="BASELINE config 2's data parallelism cut to one card "
             "(ROADMAP.md queue 1 item 9(a))",
         batch=batch, image=[3, hw, hw], amp="O1 bf16",
         optimizer="Momentum(0.1, 0.9)",
         params=sum(p.size for p in net.parameters()),
         check=dict(batch=check_batch, steps=RESNET_CHECK_STEPS,
                    replayed=replayed, eager=eager, loss_max_rel_gap=loss_gap,
                    loss_limit=RESNET_LOSS_LIMIT, bn_stat_gaps=stat_gaps,
                    stat_limit=RESNET_STAT_LIMIT,
                    planted_fault="batch_norm given Paddle's momentum as "
                                  "torch's (0.9 the new share)",
                    planted_fault_stat_gap=fault_gap, replays=check_replays,
                    check_s=check_s),
         eager_losses=eager_losses, eager_step_ms=eager_ms,
         eager_images_per_s=[batch / (m / 1e3) for m in eager_ms],
         eager_peak_gb=eager_peak_gb, capture_s=capture_s, first_loss=first,
         warm_losses=warm_losses, warm_ms=warm_ms, losses=losses,
         step_ms=step_ms, images_per_s=[batch / (m / 1e3) for m in step_ms],
         first_and_last_pair_mean_loss=pairs, replays=replays,
         profile_replay=profile, start_gb=start_gb,
         peak_gb=torch.cuda.max_memory_allocated() / 2**30,
         phase_s=time.perf_counter() - t_all, card=card)
    if loss_gap > RESNET_LOSS_LIMIT:
        problems.append(f"the replayed losses {replayed} differ from the "
                        f"eager loop's {eager} by {loss_gap}")
    if max(stat_gaps) > RESNET_STAT_LIMIT:
        problems.append(f"the BatchNorm buffers after the replays differ "
                        f"from the eager loop's by {stat_gaps}")
    if fault_gap <= RESNET_STAT_LIMIT:
        problems.append(f"the planted fault moved the BatchNorm buffers by "
                        f"only {fault_gap}, within the bar")
    if check_replays != [RESNET_CHECK_STEPS] or \
            replays != [1 + RESNET_WARM - 1 + RESNET_TIMED + 1]:
        problems.append(f"graph replays {check_replays} and {replays}")
    if not pairs[1] < pairs[0]:
        problems.append(f"the loss did not fall over the replays: "
                        f"{replay_losses}")
    if not all(math.isfinite(v) for v in replay_losses + eager_losses +
               replayed + eager):
        problems.append("a loss is not finite")
    for p in problems:
        fail(f"{phase}: {p}")
    del step, net, opt, xs, ys
    torch.cuda.empty_cache()


def vm_file(vm, arch):
    """The vision.models file that defines ``arch``."""
    return getattr(vm, arch).__module__.rsplit(".", 1)[-1] + ".py"


# api_ops: the tensor-op surface (paddle_tpu_torch/testing/op_sweep.py)
# on the card against the same calls on the CPU from the same numpy
# inputs: elementwise ops and reductions at [1024, 4096] f32 (LLaMA-7B's
# hidden width over 1,024 rows: a cut of the serving wave's 2,048 for the
# run's time limit), sorts and searches over 4096-wide
# rows, linear algebra batched at [8, 256, 256]; TF32 off.  Each family's
# bound is op_sweep.BOUNDS (the largest error over the CPU output's
# largest |value|; integer and bool outputs equal).
OPS_SIZES = dict(rows=1024, cols=4096, mat=256, batch=8, small=64)
OPS_DUP_RUNS = 4           # runs of each duplicate-index write


def ops_lower_middle(rows, avg, nan):
    """torch.median's lower middle in place of the mean of the two
    middles: api_ops' planted median fault."""
    import torch
    return torch.median(rows, dim=-1).values


def ops_first_duplicate(a, idx, vals, accumulate=False):
    """_put_last keeping the FIRST of duplicate indices: api_ops' planted
    scatter fault."""
    import torch
    idx = tuple(i.long() for i in idx)
    n = idx[0].numel()
    lin = idx[0].reshape(-1)
    first = torch.full((a.shape[0],), n, dtype=torch.long,
                       device=a.device).scatter_reduce(
        0, lin, torch.arange(n, device=a.device), "amin")
    vals = vals.to(a.dtype).expand((n,) + a.shape[1:])
    return a.index_put((lin,), vals[first[lin]])


def phase_api_ops(torch, seed, card, dev="cuda", sizes=None):
    """Every function the tensor-op slice added, on the card against the
    CPU (op_sweep.sweep), the CUDA-specific cases (op_sweep.extra_checks),
    the bf16 lane, the random ops' laws and seeds, two planted faults and
    the host cost of a Paddle call over torch's own."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.tensor import manipulation as tmanip
    from paddle_tpu_torch.tensor import stat as tstat
    from paddle_tpu_torch.testing import op_sweep as ow
    t_all = time.perf_counter()
    paddle.set_device("cpu" if dev == "cpu" else "gpu")
    sz = dict(OPS_SIZES, **(sizes or {}))
    ins = ow.make_inputs(seed=seed, **sz)
    problems = []
    missing = ow.coverage()
    if missing:
        problems.append(f"names the sweep does not call: {missing}")
    t0 = time.perf_counter()
    case_s = {}
    swept, raised = ow.sweep(paddle, ins, dev, timings=case_s)
    sweep_s = time.perf_counter() - t0
    for name, msg in raised.items():
        problems.append(f"{name} raised {msg}")
    extra = ow.extra_checks(paddle, ins, dev, runs=OPS_DUP_RUNS)
    bf16 = ow.bf16_lane(paddle, dev, rows=sz["rows"], cols=sz["cols"])
    rng = ow.rng_checks(paddle)
    # planted faults: each must land beyond its check's bound
    with patched((tstat, "_middle", ops_lower_middle)):
        planted_median = ow.extra_checks(paddle, ins, dev, runs=1)[
            "median_even_count"][0]
    with patched((tmanip, "_put_last", ops_first_duplicate)):
        planted_scatter = ow.extra_checks(paddle, ins, dev, runs=1)[
            "scatter_duplicates_later_row"][0]
    cost = ow.dispatch_cost(paddle, dev)
    families = {}
    for name, (fam, err, bound) in swept.items():
        f = families.setdefault(fam, {"max_err": 0.0, "bound": bound,
                                      "worst": None, "cases": 0})
        f["cases"] += 1
        if err >= f["max_err"]:
            f["max_err"], f["worst"] = err, name
        if not err <= bound:
            problems.append(f"{name} ({fam}): error {err} > {bound}")
    for group, res in (("extra", extra), ("bf16", bf16), ("rng", rng)):
        for name, (err, bound) in res.items():
            if not err <= bound:
                problems.append(f"{group} {name}: {err} > {bound}")
    if not planted_median > ow.BOUNDS["elementwise"]:
        problems.append(f"the planted median fault (torch.median's lower "
                        f"middle) was not caught: {planted_median}")
    if not planted_scatter > 0:
        problems.append("the planted scatter fault (the first duplicate "
                        "kept) was not caught")
    names = {c.split(".")[-1] for c in swept}
    emit("api_ops", names_swept=len(names), cases=len(swept),
         sizes=sz, sweep_s=sweep_s, families=families,
         slowest_cases_s=dict(sorted(case_s.items(),
                                     key=lambda kv: -kv[1])[:12]),
         extra={k: v[0] for k, v in extra.items()},
         bf16_max_err=max(v[0] for v in bf16.values()),
         bf16_bound=ow.BF16_BOUND, bf16_ops=len(bf16),
         rng_draws=ow.N_DRAWS, rng_problems={k: v[0] for k, v in rng.items()
                                             if v[0]},
         rng_ops=len(rng),
         planted=dict(median_lower_middle_err=planted_median,
                      scatter_first_duplicate_mismatches=planted_scatter),
         dispatch_us={k: {"paddle": a, "torch": b, "over": a - b}
                      for k, (a, b) in cost.items()},
         phase_s=time.perf_counter() - t_all, card=card)
    for p in problems:
        fail(f"api_ops: {p}")
    del ins
    torch.cuda.empty_cache()


# api_vision: MobileNetV3-Large at its published width (Howard et al.
# 2019, "Searching for MobileNetV3", the Large config at 224 x 224,
# scale 1.0, 1000 classes) on _resnet_line's recipe (bench.py:302-330):
# api_resnet's body and gates.  Then one eager f32 forward (TF32 off) of
# each other family's smallest member at VISION_FWD_BATCH x 224 (299 for
# InceptionV3) on the card against the same weights on the CPU: logits
# within VISION_FWD_LIMIT of their largest |value| (cuDNN's and the CPU's
# convolution algorithms sum in other orders, through tens of layers).
VISION_ARCH = "mobilenet_v3_large"
VISION_FAMILIES = (("vgg11", 224), ("mobilenet_v1", 224),
                   ("mobilenet_v2", 224), ("mobilenet_v3_small", 224),
                   ("alexnet", 224), ("squeezenet1_1", 224),
                   ("densenet121", 224), ("googlenet", 224),
                   ("inception_v3", 299), ("shufflenet_v2_x0_25", 224))
VISION_FWD_BATCH = 4
VISION_FWD_LIMIT = 1e-3


def phase_api_vision(torch, seed, card, dev="cuda", batch=RESNET_BATCH,
                     hw=RESNET_HW, check_batch=RESNET_CHECK_BATCH,
                     families=VISION_FAMILIES, fwd_batch=VISION_FWD_BATCH):
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.models.weights import layer_state_from_jax
    from paddle_tpu_torch.vision import models as vm
    t_all = time.perf_counter()
    phase_api_resnet(torch, seed, card, dev=dev, arch=VISION_ARCH,
                     batch=batch, hw=hw, check_batch=check_batch,
                     phase="api_vision",
                     source="Howard et al. 2019 (Searching for MobileNetV3)"
                     " Large, 224 x 224, scale 1.0, on bench.py:302-330 "
                     "_resnet_line's recipe")
    recipe_s = time.perf_counter() - t_all
    rng = np.random.RandomState(seed)
    fwd, problems = {}, []
    for arch, size in families:
        t = time.perf_counter()
        x = rng.randn(fwd_batch, 3, size, size).astype(np.float32)
        paddle.set_device("cpu" if dev == "cpu" else "gpu")
        paddle.seed(seed)
        net = getattr(vm, arch)(num_classes=1000)
        net.eval()
        out = net(paddle.to_tensor(x))
        outs = out if isinstance(out, (list, tuple)) else [out]
        got = [o.numpy() for o in outs]
        paddle.set_device("cpu")
        ref_net = getattr(vm, arch)(num_classes=1000)
        layer_state_from_jax(ref_net, net.state_dict())
        ref_net.eval()
        ref = ref_net(paddle.to_tensor(x))
        refs = ref if isinstance(ref, (list, tuple)) else [ref]
        err = max(float(np.abs(a - b.numpy()).max()) /
                  max(float(np.abs(b.numpy()).max()), 1e-30)
                  for a, b in zip(got, refs))
        finite = all(np.isfinite(a).all() for a in got)
        fwd[arch] = {"input": [fwd_batch, 3, size, size],
                     "outputs": [list(a.shape) for a in got],
                     "max_rel_err": err, "finite": finite,
                     "s": time.perf_counter() - t}
        if not err <= VISION_FWD_LIMIT or not finite:
            problems.append(f"{arch}: logits {err} from the CPU's "
                            f"(limit {VISION_FWD_LIMIT}), finite {finite}")
        del net, ref_net, out, ref
        torch.cuda.empty_cache()
    paddle.set_device("cpu" if dev == "cpu" else "gpu")
    emit("api_vision_forwards", families=fwd, limit=VISION_FWD_LIMIT,
         tf32=False, recipe_s=recipe_s,
         phase_s=time.perf_counter() - t_all, card=card)
    for p in problems:
        fail(f"api_vision: {p}")


# api_transformer: Transformer-base (Vaswani et al. 2017, "Attention Is
# All You Need", Table 3 row "base": N = 6 + 6, d_model 512, d_ff 2048,
# h 8, P_drop 0.1, eps_ls 0.1) composed as a user script composes it: a
# shared nn.Embedding over the 37,000-token BPE vocabulary of WMT14 en-de
# (scaled by sqrt(d_model)), sinusoidal positions, nn.Transformer() (its
# defaults are this configuration) and an output projection tied to the
# embedding; the loss label-smoothed through F.one_hot, F.label_smooth and
# F.cross_entropy(soft_label=True) over the non-pad targets; Adam(0.9,
# 0.98, 1e-9) under NoamDecay(512, 4000), through jit_train_step at O1.
# A batch is 13 pairs x 256 tokens a side, lengths drawn in [236, 256] and
# padded (id 0): the paper batches pairs by length, and [236, 256] is
# tensor2tensor's last length bucket at 256 (its boundaries grow by 1.1x);
# about 3,200 target tokens a card, the paper's 25,000 over 8 GPUs.
# XF_GRAD_LIMIT holds one O1 step's gradients against the f32 step's (same
# weights, dropout off) leaf by leaf in L2 norm (grad_l2_gap); a planted
# fault (the causal mask one position too wide: each target sees the next
# token) must land beyond it.  On an H100 the sound gap read 0.0564 and
# 0.0660, the fault 0.458 and 0.517 (the limit 1.5x the one, 4.6x under
# the other); grad_gap's largest element read 0.167 sound and 0.253
# faulty, too close to part them.
# DECODE_LIMIT bounds, at every one of DECODE_STEPS greedy steps through
# gen_cache / cache=, the largest |logit gap| between the cached step and
# the full causal forward over the same tokens (f32, TF32 off), over the
# full forward's largest |logit|; the same fault lands beyond it.  XF_CFG
# overrides nn.Transformer()'s defaults (empty: the paper's base).
XF_VOCAB, XF_BATCH, XF_SEQ, XF_MIN_LEN = 37000, 13, 256, 236
XF_CFG = {}
XF_GRAD_LIMIT = 0.1
XF_STEPS, XF_EAGER_STEPS, XF_CHECK_STEPS = 5, 3, 3
XF_WARMUP, XF_BETAS, XF_EPS, XF_SMOOTH = 4000, (0.9, 0.98), 1e-9, 0.1
DECODE_STEPS, DECODE_ROWS, DECODE_LIMIT = 32, 2, 1e-3


def sinusoid(n, d):
    pos = np.arange(n)[:, None]
    i = np.arange(d)[None, :]
    ang = pos / np.power(10000.0, (2 * (i // 2)) / d)
    return np.where(i % 2 == 0, np.sin(ang), np.cos(ang)).astype(np.float32)


def transformer_base(paddle, vocab, dropout, cfg=None):
    """Transformer-base as a user composes it (shared, tied embedding)."""
    nn, F = paddle.nn, paddle.nn.functional
    kw = dict(cfg or {})
    d_model = kw.get("d_model", 512)

    class Seq2Seq(nn.Layer):
        def __init__(self):
            super().__init__()
            # N(0, d_model^-0.5), the paper's (tensor2tensor's) draw: the
            # embedding times sqrt(d_model) is then of unit scale
            self.emb = nn.Embedding(
                vocab, d_model, weight_attr=paddle.ParamAttr(
                    initializer=nn.initializer.Normal(0.0, d_model ** -0.5)))
            self.transformer = nn.Transformer(dropout=dropout, **kw)
            self.register_buffer("pos", paddle.to_tensor(
                sinusoid(1024, d_model)), persistable=False)
            self.drop = dropout

        def embed(self, ids):
            x = self.emb(ids) * math.sqrt(d_model) + \
                self.pos[:ids.shape[1]]
            return F.dropout(x, self.drop, training=self.training)

        def project(self, h):
            return paddle.matmul(h, self.emb.weight, transpose_y=True)

        def forward(self, src, tgt, src_mask, tgt_mask):
            out = self.transformer(self.embed(src), self.embed(tgt),
                                   src_mask, tgt_mask, src_mask)
            return self.project(out)

    return Seq2Seq()


def smoothed_loss(paddle, vocab):
    F = paddle.nn.functional

    def loss_fn(logits, y):
        labels, keep = y
        soft = F.label_smooth(F.one_hot(labels, vocab), epsilon=XF_SMOOTH)
        ce = F.cross_entropy(logits, soft, soft_label=True, reduction="none")
        ce = paddle.reshape(ce, keep.shape)
        return paddle.sum(ce * keep) / paddle.sum(keep)

    return loss_fn


def xf_batch(paddle, seed, vocab, batch, seq, shift=0):
    """(src, tgt_in, src_mask, tgt_mask), (labels, keep): lengths drawn in
    [XF_MIN_LEN, seq], id 0 the padding; ``shift`` widens the causal mask
    (a planted fault)."""
    rng = np.random.RandomState(seed)
    lo = min(XF_MIN_LEN, seq)
    src_len = rng.randint(lo, seq + 1, batch)
    tgt_len = rng.randint(lo, seq + 1, batch)
    src = rng.randint(1, vocab, (batch, seq))
    tgt = rng.randint(1, vocab, (batch, seq + 1))
    pos = np.arange(seq)
    src[pos[None] >= src_len[:, None]] = 0
    keep = (pos[None] < tgt_len[:, None]).astype(np.float32)
    tgt_in, labels = tgt[:, :-1] * (keep > 0), tgt[:, 1:] * (keep > 0)
    src_mask = np.where(src[:, None, None, :] == 0, -1e9, 0.0).astype(
        np.float32)
    tgt_mask = np.triu(np.full((seq, seq), -1e9, np.float32), 1 + shift)
    t = paddle.to_tensor
    return ((t(src), t(tgt_in), t(src_mask), t(tgt_mask)),
            (t(labels), t(keep)))


def xf_kind(name):
    low = name.lower()
    if any(t in low for t in ("gemm", "gemv", "nvjet", "cutlass", "cublas",
                              "xmma")):
        return "matmul (cuBLAS)"
    for tag, kind in (("softmax", "softmax"), ("layer_norm", "layer_norm"),
                      ("reduce", "reduce"), ("adam", "optimizer"),
                      ("index", "gather / scatter"),
                      ("elementwise", "elementwise"),
                      ("vectorized", "elementwise")):
        if tag in low:
            return kind
    return "other"


def grad_l2_gap(got, ref):
    """(the largest ||got - ref|| over its leaf's yardstick, that leaf):
    grad_gap's rule with L2 norms in place of the largest elements (a bf16
    step against an f32 one differs by rounding in every element; the
    norm weighs it against the whole leaf)."""
    norms = {n: float(r.float().norm()) for n, r in ref.items()}
    top = max(norms.values())
    return max((float((got[n].float() - r.float()).norm())
                / max(norms[n], GRAD_FLOOR * top), n)
               for n, r in ref.items())


def grads_of(torch, paddle, model, loss_fn, x, y, amp):
    named = list(model.named_parameters())
    if amp:
        with paddle.amp.auto_cast(level="O1"):
            loss = loss_fn(model(*x), y)
    else:
        loss = loss_fn(model(*x), y)
    grads = torch.autograd.grad(loss._data, [p._data for _, p in named],
                                allow_unused=True)
    return float(loss), {n: g.float() for (n, _), g in zip(named, grads)
                         if g is not None}


def xf_decode_gap(torch, paddle, net, x, rows, steps, shift=0):
    """Greedy decoding through gen_cache / cache= against the full causal
    forward over the same tokens -> (largest |logit gap| over the full
    forward's largest |logit|, the tokens)."""
    src, _, src_mask, _ = x
    src, src_mask = src[:rows], src_mask[:rows]
    tf = net.transformer
    with torch.no_grad():
        memory = tf.encoder(net.embed(src), src_mask=src_mask)
        cache = tf.decoder.gen_cache(memory)
        tok = paddle.to_tensor(np.ones((rows, 1), np.int64))
        toks, logits = [tok], []
        for t in range(steps):
            step = net.emb(tok) * math.sqrt(tf.d_model) + net.pos[t:t + 1]
            out, cache = tf.decoder(step, memory, memory_mask=src_mask,
                                    cache=cache)
            lg = net.project(out)
            logits.append(lg._data[:, 0])
            tok = paddle.argmax(lg, axis=-1)
            toks.append(tok)
        seq = paddle.concat(toks[:-1], axis=1)
        mask = paddle.to_tensor(np.triu(np.full((steps, steps), -1e9,
                                                np.float32), 1 + shift))
        full = net.project(tf.decoder(net.embed(seq), memory, mask,
                                      src_mask))._data
        cached = torch.stack(logits, 1)
        gap = float((cached - full).abs().max() / full.abs().max())
    return gap, seq


def phase_api_transformer(torch, seed, mods, card, dev="cuda"):
    """Transformer-base training steps through jit_train_step."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.incubate import jit_train_step
    t_all = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    start_gb = torch.cuda.memory_allocated() / 2**30
    paddle.set_device("cpu" if dev == "cpu" else "gpu")
    problems = []
    vocab, batch, seq, cfg = XF_VOCAB, XF_BATCH, XF_SEQ, XF_CFG
    decode_steps = DECODE_STEPS
    loss_fn = smoothed_loss(paddle, vocab)
    x, y = xf_batch(paddle, seed, vocab, batch, seq)
    x_fault, _ = xf_batch(paddle, seed, vocab, batch, seq, shift=1)
    d_model = cfg.get("d_model", 512)

    def model(dropout):
        paddle.seed(55)
        net = transformer_base(paddle, vocab, dropout, cfg)
        net.train()
        return net

    def adam(net):
        sched = paddle.optimizer.lr.NoamDecay(d_model, XF_WARMUP)
        return paddle.optimizer.Adam(
            learning_rate=sched, beta1=XF_BETAS[0], beta2=XF_BETAS[1],
            epsilon=XF_EPS, parameters=net.parameters()), sched

    # (1) one step's gradients: O1 against f32, dropout off; the fault
    t0 = time.perf_counter()
    net = model(0.0)
    loss_o1, g_o1 = grads_of(torch, paddle, net, loss_fn, x, y, True)
    loss_f32, g_f32 = grads_of(torch, paddle, net, loss_fn, x, y, False)
    _, g_fault = grads_of(torch, paddle, net, loss_fn, x_fault, y, False)
    gap, gap_leaf = grad_l2_gap(g_o1, g_f32)
    fault_gap, _ = grad_l2_gap(g_fault, g_f32)
    finite = all(bool(torch.isfinite(g).all()) for g in g_o1.values())
    del g_o1, g_f32, g_fault
    # (2) greedy decoding with the cache against the full forward, f32
    net.eval()
    dec_gap, dec_tokens = xf_decode_gap(torch, paddle, net, x, DECODE_ROWS,
                                        decode_steps)
    dec_fault, _ = xf_decode_gap(torch, paddle, net, x, DECODE_ROWS,
                                 decode_steps, shift=1)
    # (3) dropout 0: replays against the eager loop, the same weights
    nets0 = [model(0.0), model(0.0)]
    opt0, sched0 = adam(nets0[0])
    step0 = jit_train_step(nets0[0], loss_fn, opt0, amp_level="O1")
    replayed0 = []
    for _ in range(XF_CHECK_STEPS):
        replayed0.append(float(step0(x, y)))
        sched0.step()
    opt_e, sched_e = adam(nets0[1])
    eager0 = []
    for _ in range(XF_CHECK_STEPS):
        eager0.append(float(eager_o1_step(paddle, nets0[1], loss_fn, opt_e,
                                          x, y)))
        sched_e.step()
    gap0 = max(abs(a - b) / abs(b) for a, b in zip(replayed0, eager0))
    del nets0, step0, opt0, opt_e
    torch.cuda.empty_cache()
    check_s = time.perf_counter() - t0

    # (4) the recipe: dropout 0.1, eager steps, the capture, replays
    net = model(0.1)
    opt, sched = adam(net)

    def eager():
        loss = eager_o1_step(paddle, net, loss_fn, opt, x, y)
        sched.step()
        return loss

    zero_counts(mods)
    eager_losses, eager_ms = timed_calls(torch, eager, XF_EAGER_STEPS)
    step = jit_train_step(net, loss_fn, opt, amp_level="O1")

    def replay():
        loss = step(x, y)
        sched.step()
        return loss

    t = time.perf_counter()
    first = float(replay())
    capture_s = time.perf_counter() - t
    losses, step_ms = timed_calls(torch, replay, XF_STEPS)
    profile = profiled_call(torch, replay, xf_kind)
    launches = steps_ran_launches(read_counts(mods), [step])
    tokens = float(np.asarray(y[1].numpy()).sum())
    emit("api_transformer", model="Transformer-base (Vaswani et al. 2017 "
         "Table 3 'base': 6 + 6 layers, d_model 512, d_ff 2048, 8 heads, "
         "dropout 0.1, label smoothing 0.1) through nn.Transformer(), a "
         f"shared tied embedding over {vocab} tokens",
         source="Vaswani et al. 2017 (Attention Is All You Need), Table 3 "
         "base; WMT14 en-de shared BPE vocabulary 37,000; Adam(0.9, 0.98, "
         "1e-9) with NoamDecay(512, 4000)",
         batch=batch, seq=seq, target_tokens=tokens, amp="O1 bf16",
         params=sum(p.size for p in net.parameters()),
         grad_loss_o1=loss_o1, grad_loss_f32=loss_f32,
         grad_max_rel_l2_diff=gap, grad_worst_leaf=gap_leaf,
         grad_limit=XF_GRAD_LIMIT, planted_fault="causal mask one wider",
         planted_fault_max_rel_l2_diff=fault_gap,
         decode_steps=decode_steps, decode_rows=DECODE_ROWS,
         decode_max_rel_gap=dec_gap, decode_limit=DECODE_LIMIT,
         decode_fault_max_rel_gap=dec_fault,
         decode_first_tokens=np.asarray(dec_tokens.numpy())[:, :8].tolist(),
         dropout0_replayed=replayed0, dropout0_eager=eager0,
         dropout0_max_rel_gap=gap0, jit_loss_limit=JIT_LOSS_LIMIT,
         eager_losses=eager_losses, eager_step_ms=eager_ms,
         eager_tokens_per_s=[tokens / (m / 1e3) for m in eager_ms],
         capture_s=capture_s, first_loss=first, losses=losses,
         step_ms=step_ms, tokens_per_s=[tokens / (m / 1e3) for m in step_ms],
         replay_profile=profile, kernel_launches={
             k: v for k, v in launches.items() if v},
         check_s=check_s, start_gb=start_gb,
         peak_gb=torch.cuda.max_memory_allocated() / 2**30,
         phase_s=time.perf_counter() - t_all, card=card)
    if not finite:
        problems.append("an O1 gradient is not finite")
    if gap > XF_GRAD_LIMIT:
        problems.append(f"the O1 gradients differ from the f32 step's by "
                        f"{gap} of a leaf's norm ({gap_leaf})")
    if fault_gap <= XF_GRAD_LIMIT:
        problems.append(f"the planted mask fault moved the gradients by only "
                        f"{fault_gap}, within the limit")
    if dec_gap > DECODE_LIMIT:
        problems.append(f"cached decoding's logits differ from the full "
                        f"forward's by {dec_gap}")
    if dec_fault <= DECODE_LIMIT:
        problems.append(f"the planted mask fault moved the decode check by "
                        f"only {dec_fault}")
    if gap0 > JIT_LOSS_LIMIT:
        problems.append(f"the replayed losses {replayed0} differ from the "
                        f"eager loop's {eager0} by {gap0}")
    if any(launches.values()):
        problems.append(f"Transformer-base launched hand-written kernels "
                        f"{launches}: every attention has a mask or a "
                        f"q_len / kv_len JAX sends to its composite")
    if len(step.graphs()) != 1:
        problems.append(f"{len(step.graphs())} graphs for one signature")
    if not all(math.isfinite(v) for v in losses + eager_losses):
        problems.append("a loss is not finite")
    for p in problems:
        fail(f"api_transformer: {p}")
    del step, net, opt
    torch.cuda.empty_cache()
    return launches


# api_varlen: packed (varlen) attention through the Paddle API at
# LLaMA-7B's attention width (32 heads of 128, bf16), 16,384 packed tokens
# of documents whose lengths are drawn from the seed in [VARLEN_MIN,
# VARLEN_MAX] (no published document mix: a smoke phase, as
# pack_documents is), each forward and backward through loss.backward():
# F.flash_attn_unpadded (causal) at 32 / 32 heads and at 32 q / 8 kv heads
# (LLaMA-3-8B's ratio) over 37 fewer tokens (JAX's -1 padding to the next
# 128 rows), F.flash_attn_varlen_qkvpacked on [T, 3, 32, 128] and
# F.flash_attn_qkvpacked on [8, 2048, 3, 32, 128].  Each output within TOL
# of the plain version (ops.flash_varlen.segmented_sdpa_docs: each
# document alone, f32 math; sdpa_plain for the dense call), each gradient
# within VARLEN_GRAD_LIMIT (of the largest element, as TOL); the launches
# against the code's count (K2, the range kernel, K7a and K7b once a varlen
# call, K6a-c once for the dense one); an f32 call over the 32 / 8 head
# stream takes the plain route and launches nothing.  Two planted faults:
# cu_seqlens shifted by one lands beyond TOL; K7a and K7b told the other
# causality (the forward sound) land beyond VARLEN_GRAD_LIMIT.  On an H100
# the sound gradients read 4.9e-3-6.0e-3 and the backward fault 3,786.
VARLEN_T, VARLEN_HEADS, VARLEN_KV, VARLEN_D = 16384, 32, 8, 128
VARLEN_MIN, VARLEN_MAX, VARLEN_PAD_CUT = 64, 4096, 37
VARLEN_GRAD_LIMIT = TOL["rtol"]
VARLEN_DENSE = (8, 2048)
VARLEN_KERNELS = ("flash_attention_segmented", "segment_tile_ranges",
                  "flash_attention_segmented_bwd_dq",
                  "flash_attention_segmented_bwd_dkv")


def varlen_docs(seed, total, lo, hi):
    rng = np.random.RandomState(seed + 17)
    lens = []
    while sum(lens) < total:
        lens.append(int(min(rng.randint(lo, hi + 1), total - sum(lens))))
    return np.cumsum([0] + lens)


def fwd_bwd(torch, paddle, fn, arrays, cot):
    """fn(*tensors) forward and loss.backward() -> (out, grads)."""
    ts = [paddle.to_tensor(a, stop_gradient=False) for a in arrays]
    out = fn(*ts)
    (out * paddle.to_tensor(cot)).sum().backward()
    return out._data.detach(), [t.grad._data for t in ts]


def rel_gap(torch, got, ref):
    got, ref = got.detach().float(), ref.detach().float()
    return float((got - ref).abs().max() / ref.abs().max().clamp(min=1e-30))


def phase_api_varlen(torch, seed, mods, card, dev="cuda"):
    import paddle_tpu_torch as paddle
    F = paddle.nn.functional
    fv, fa = mods["fv"], mods["fa"]
    total, heads, kv, d = VARLEN_T, VARLEN_HEADS, VARLEN_KV, VARLEN_D
    dense, lo, hi = VARLEN_DENSE, VARLEN_MIN, VARLEN_MAX
    t_all = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    paddle.set_device("cpu" if dev == "cpu" else "gpu")
    problems = []
    g = torch.Generator(device=dev).manual_seed(seed)

    def rand(*shape):
        return torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)

    cu = varlen_docs(seed, total, lo, hi)
    cu_cut = cu.copy()
    cu_cut[-1] -= VARLEN_PAD_CUT
    T2 = int(cu_cut[-1])
    arms = {
        "unpadded_mha": (lambda q, k, v: F.flash_attn_unpadded(
            q, k, v, cu, cu, causal=True),
            [rand(total, heads, d), rand(total, heads, d),
             rand(total, heads, d)], cu),
        "unpadded_gqa": (lambda q, k, v: F.flash_attn_unpadded(
            q, k, v, cu_cut, cu_cut, causal=True),
            [rand(T2, heads, d), rand(T2, kv, d), rand(T2, kv, d)], cu_cut),
        "varlen_qkvpacked": (lambda p: F.flash_attn_varlen_qkvpacked(
            p, cu, cu, hi, hi, causal=True), [rand(total, 3, heads, d)],
            cu),
        "qkvpacked_dense": (lambda p: F.flash_attn_qkvpacked(p, causal=True),
                            [rand(*dense, 3, heads, d)], None),
    }
    def cot_of(arrays, cuts):
        return rand(*(arrays[0].shape[:1] + (heads, d)) if cuts is not None
                    else dense + (heads, d))

    # one call of each first: the libraries load and the allocator warms
    # before the timed, counted calls
    for fn, arrays, cuts in arms.values():
        fwd_bwd(torch, paddle, fn, arrays, cot_of(arrays, cuts))
    torch.cuda.synchronize()
    res, launched, kept = {}, {}, None
    zero_counts(mods)
    for name, (fn, arrays, cuts) in arms.items():
        before = read_counts(mods)
        cot = cot_of(arrays, cuts)
        torch.cuda.synchronize()
        t = time.perf_counter()
        out, grads = fwd_bwd(torch, paddle, fn, arrays, cot)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3
        launched[name] = {k: v - before[k] for k, v in
                          read_counts(mods).items() if v - before[k]}
        # the plain versions: autograd through f32 math
        leaves = [a.detach().clone().requires_grad_(True) for a in arrays]
        if cuts is None:
            p = leaves[0]
            ref = fa.sdpa_plain(p[:, :, 0], p[:, :, 1], p[:, :, 2], True)
        elif name == "varlen_qkvpacked":
            p = leaves[0]
            ref = fv.segmented_sdpa_docs(p[:, 0], p[:, 1], p[:, 2], cuts,
                                         True)
        else:
            ref = fv.segmented_sdpa_docs(*leaves, cuts, True)
        ref_grads = torch.autograd.grad(ref, leaves, cot)
        if name == "unpadded_mha":
            kept = cot, ref_grads
        err = rel_gap(torch, out, ref)
        gerr = max(rel_gap(torch, a, b) for a, b in zip(grads, ref_grads))
        res[name] = {"shape": list(arrays[0].shape), "fwd_bwd_ms": ms,
                     "out_max_rel_err": err, "grad_max_rel_err": gerr,
                     "launches": launched[name]}
        if err > TOL["rtol"] or gerr > VARLEN_GRAD_LIMIT:
            problems.append(f"{name}: output {err} (limit {TOL['rtol']}), "
                            f"gradients {gerr} (limit {VARLEN_GRAD_LIMIT}) "
                            f"from the plain versions'")
        del out, grads, ref, ref_grads, leaves
    launches = read_counts(mods)
    want_var = {k: 1 for k in VARLEN_KERNELS}
    want_dense = {k: 1 for k in K6_NAMES}
    for name in ("unpadded_mha", "unpadded_gqa", "varlen_qkvpacked"):
        if launched[name] != want_var:
            problems.append(f"{name} launched {launched[name]}, the code "
                            f"predicts {want_var}")
    if launched["qkvpacked_dense"] != want_dense:
        problems.append(f"qkvpacked_dense launched "
                        f"{launched['qkvpacked_dense']}, the code predicts "
                        f"{want_dense}")
    # an f32 call on the card over the whole 32 / 8 head stream: the plain
    # route, a document at a time, no kernel
    q32 = [a.float() for a in arms["unpadded_gqa"][1]]
    route = F.varlen_route(q32[0])
    before = read_counts(mods)
    t = time.perf_counter()
    out32, _ = fwd_bwd(torch, paddle, lambda q, k, v: F.flash_attn_unpadded(
        q, k, v, cu_cut, cu_cut, causal=True), q32,
        torch.ones(q32[0].shape, device=dev))
    torch.cuda.synchronize()
    f32_ms = (time.perf_counter() - t) * 1e3
    f32_launched = {k: v - before[k] for k, v in read_counts(mods).items()
                    if v - before[k]}
    with torch.no_grad():
        f32_gap = rel_gap(torch, out32,
                          fv.segmented_sdpa_docs(*q32, cu_cut, True))
    if route != "plain" or f32_launched or f32_gap > 1e-5:
        problems.append(f"the f32 call took {route}, launched "
                        f"{f32_launched}, {f32_gap} from the plain version")
    del q32, out32
    # the planted faults: cu_seqlens shifted by one; the backward kernels
    # told the other causality after a sound forward
    shifted = cu.copy()
    shifted[1:-1] += 1
    fn, qkv, _ = arms["unpadded_mha"]
    with torch.no_grad():
        good = fv.segmented_sdpa_docs(*qkv, cu, True)
        bad = F.flash_attn_unpadded(*[paddle.to_tensor(a) for a in qkv],
                                    shifted, shifted, causal=True)._data
    fault_err = rel_gap(torch, bad, good)
    if fault_err <= TOL["rtol"]:
        problems.append(f"cu_seqlens shifted by one moved the output by only "
                        f"{fault_err}")
    del good, bad
    cot, ref_grads = kept
    real_bwd = fv._seg_bwd
    with patched((fv, "_seg_bwd", lambda *a: real_bwd(
            *a[:7], not a[7], a[8]))):
        _, bad_grads = fwd_bwd(torch, paddle, fn, qkv, cot)
    bwd_fault = max(rel_gap(torch, a, b)
                    for a, b in zip(bad_grads, ref_grads))
    if bwd_fault <= VARLEN_GRAD_LIMIT:
        problems.append(f"K7a / K7b told the other causality moved the "
                        f"gradients by only {bwd_fault}")
    del bad_grads, ref_grads, kept
    emit("api_varlen", source="LLaMA-7B attention width (32 heads of 128, "
         "bf16) and LLaMA-3-8B's GQA ratio (32 q / 8 kv); document lengths "
         f"drawn in [{lo}, {hi}] from the seed (no published mix: a smoke "
         "phase)", tokens=total, documents=len(cu) - 1,
         doc_lens=np.diff(cu).tolist(), arms=res,
         f32_tokens=T2, f32_route=route, f32_launches=f32_launched,
         f32_max_rel_err=f32_gap, f32_fwd_bwd_ms=f32_ms,
         planted_fault="cu_seqlens shifted by one",
         planted_fault_max_rel_err=fault_err, tol=TOL["rtol"],
         planted_bwd_fault="K7a / K7b told the other causality",
         planted_bwd_fault_grad_max_rel_err=bwd_fault,
         grad_limit=VARLEN_GRAD_LIMIT,
         peak_gb=torch.cuda.max_memory_allocated() / 2**30,
         phase_s=time.perf_counter() - t_all, card=card)
    for p in problems:
        fail(f"api_varlen: {p}")
    del arms, qkv
    torch.cuda.empty_cache()
    return launches


# api_nn: nn's families on the card against the CPU
# (paddle_tpu_torch/testing/op_sweep.py:nn_cases, one realistic shape a
# family: the losses over a [1024, 32000] logit batch, the norms, pads,
# resampling, pools with masks and unpools over a ResNet stage's [2, 256,
# 56, 56] map and its stem's [2, 64, 112, 112], a segmentation decoder's
# transposed convolution [2, 256, 56, 56] -> [2, 128, 112, 112], ...: the
# NN_SWEEP cut of op_sweep.NN_SIZES),
# each family's largest error against op_sweep.BOUNDS, gradients too; the
# dropouts by their laws; a planted fault (reflect padding that repeats
# the edge) beyond its bound.  Then the LSTM language model of Zaremba et
# al. 2014 ("Recurrent Neural Network Regularization", the large model: 2
# layers of 1,500 units, vocabulary 10,000 (Penn Treebank), 35 unrolled
# steps, batch 20, dropout 0.65, uniform init in [-0.04, 0.04], SGD at lr 1
# with the gradients' global norm clipped at 10), trained in f32 through
# jit_train_step: replayed against eager losses (dropout 0), step ms and
# tokens/s (dropout 0.65).  Each batch starts from zero states (the paper
# carries them across batches: left out).  Then beam search
# (BeamSearchDecoder over the LM's first LSTMCell with its embedding and
# projection, BEAM beams, BEAM_PROMPTS prompts of 10 tokens, BEAM_STEPS
# steps, dynamic_decode): each beam's score within BEAM_LIMIT of the
# teacher-forced rescoring of its tokens by the same cell; the ids without
# the backtrace (JAX's) as a planted fault beyond it.
# the nn sweep's sizes over op_sweep.NN_SIZES, cut for the time limit: the
# losses' logits at 1,024 rows of the 32,000 vocabulary (NN_SIZES: 4,096)
# and the feature maps at batch 2 (NN_SIZES: 8); tools/chip_phases.py
# api_nn_before runs the sweep at NN_SIZES in the same process
NN_SWEEP = dict(rows=1024, batch=2)
LSTM_CFG = dict(vocab=10000, hidden=1500, layers=2, steps=35, batch=20,
                dropout=0.65, init=0.04, lr=1.0, clip=10.0)
LSTM_STEPS, LSTM_EAGER_STEPS, LSTM_CHECK_STEPS = 5, 3, 3
BEAM, BEAM_PROMPTS, BEAM_STEPS, BEAM_PROMPT_LEN = 4, 8, 32, 10
BEAM_LIMIT = 1e-2          # nats, on summed log-probabilities near -300
BEAM_END = 2


def lstm_lm(paddle, c, dropout):
    nn, F = paddle.nn, paddle.nn.functional
    init = nn.initializer.Uniform(-c["init"], c["init"])

    class LM(nn.Layer):
        def __init__(self):
            super().__init__()
            nn.initializer.set_global_initializer(init, init)
            try:
                self.emb = nn.Embedding(c["vocab"], c["hidden"])
                self.rnn = nn.LSTM(c["hidden"], c["hidden"], c["layers"],
                                   dropout=dropout)
                self.proj = nn.Linear(c["hidden"], c["vocab"])
            finally:
                nn.initializer.set_global_initializer(None, None)
            self.p = dropout

        def forward(self, ids):
            x = F.dropout(self.emb(ids), self.p, training=self.training)
            h, _ = self.rnn(x)
            h = F.dropout(h, self.p, training=self.training)
            return self.proj(h)

    return LM()


def lm_loss(paddle):
    F = paddle.nn.functional

    def loss_fn(logits, y):
        return F.cross_entropy(paddle.reshape(logits, [-1, logits.shape[-1]]),
                               paddle.reshape(y, [-1]))

    return loss_fn


def beam_rescore(torch, paddle, lm, states, ids):
    """Each beam's tokens teacher-forced through the cell from its prompt's
    states -> summed log-probs [batch, beam] (0 cost after the end)."""
    cell = lm.rnn.cell_fw_0
    b, k, n = ids.shape
    h, c = (s._data.repeat_interleave(k, 0) for s in states)
    toks = torch.as_tensor(ids.reshape(b * k, n), device=h.device)
    prev = torch.full((b * k,), 1, dtype=torch.int64, device=h.device)
    total = torch.zeros(b * k, dtype=torch.float64, device=h.device)
    done = torch.zeros(b * k, dtype=torch.bool, device=h.device)
    with torch.no_grad():
        st = (paddle.to_tensor(h), paddle.to_tensor(c))
        for t in range(n):
            out, st = cell(lm.emb(paddle.to_tensor(prev)), st)
            lp = torch.log_softmax(lm.proj(out)._data, -1)
            pick = lp.gather(1, toks[:, t:t + 1])[:, 0].double()
            total += torch.where(done, torch.zeros_like(pick), pick)
            done |= toks[:, t] == BEAM_END
            prev = toks[:, t]
    return total.reshape(b, k).cpu().numpy()


def phase_api_nn(torch, seed, card, dev="cuda"):
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.incubate import jit_train_step
    from paddle_tpu_torch.nn.functional import common as fcommon
    from paddle_tpu_torch.testing import op_sweep as ow
    t_all = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    paddle.set_device("cpu" if dev == "cpu" else "gpu")
    problems = []
    # (1) the nn sweep
    sz = dict(ow.NN_SIZES, **NN_SWEEP)
    missing = ow.nn_coverage()
    if missing:
        problems.append(f"nn names the sweep does not call: {missing}")
    t0 = time.perf_counter()
    ins = ow.nn_inputs(seed, **sz)
    case_list = ow.nn_cases(sz)
    case_s = {}
    swept, raised = ow.sweep(paddle, ins, dev, case_list=case_list,
                             timings=case_s)
    for name, msg in raised.items():
        problems.append(f"{name} raised {msg}")
    families = {}
    for name, (fam, err, bound) in swept.items():
        f = families.setdefault(fam, {"max_err": 0.0, "bound": bound,
                                      "worst": None, "cases": 0})
        f["cases"] += 1
        if err >= f["max_err"]:
            f["max_err"], f["worst"] = err, name
        if not err <= bound:
            problems.append(f"{name} ({fam}): error {err} > {bound}")
    laws = ow.nn_laws(paddle, dev)
    for name, (err, bound) in laws.items():
        if not err <= bound:
            problems.append(f"law {name}: {err} > {bound}")

    # the planted fault on the swept device alone, against the CPU's sound
    # result
    real_index = fcommon._pad_index
    pad_case = next(c for c in case_list if c.name == "F.pad.reflect")
    with patched((fcommon, "_pad_index", lambda n, lo, hi, mode, device: (
            torch.arange(-lo, n + hi, device=device).clamp(0, n - 1)
            if mode == "reflect" else real_index(n, lo, hi, mode, device)))):
        bad = ow.run_case(paddle, pad_case, ins, dev)
    fault_err = ow.compare(bad, ow.run_case(paddle, pad_case, ins, "cpu"),
                           "pad")
    if not fault_err > ow.BOUNDS["pad"]:
        problems.append(f"the planted reflect-pad fault was not caught: "
                        f"{fault_err}")
    sweep_s = time.perf_counter() - t0
    del ins
    torch.cuda.empty_cache()

    # (2) the LSTM language model through jit_train_step, f32
    c = LSTM_CFG
    rng = np.random.RandomState(seed)
    ids = paddle.to_tensor(rng.randint(0, c["vocab"],
                                       (c["batch"], c["steps"] + 1)))
    x, y = ids[:, :-1], ids[:, 1:]
    loss_fn = lm_loss(paddle)

    def lm(dropout):
        paddle.seed(66)
        net = lstm_lm(paddle, c, dropout)
        net.train()
        return net

    def sgd(net):
        return paddle.optimizer.SGD(
            learning_rate=c["lr"], parameters=net.parameters(),
            grad_clip=paddle.nn.ClipGradByGlobalNorm(c["clip"]))

    def eager_f32(net, opt):
        loss = loss_fn(net(x), y)
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss

    t1 = time.perf_counter()
    nets0 = [lm(0.0), lm(0.0)]
    opt0 = sgd(nets0[0])
    step0 = jit_train_step(nets0[0], loss_fn, opt0)
    replayed0 = [float(step0(x, y)) for _ in range(LSTM_CHECK_STEPS)]
    opt_e = sgd(nets0[1])
    eager0 = [float(eager_f32(nets0[1], opt_e))
              for _ in range(LSTM_CHECK_STEPS)]
    gap0 = max(abs(a - b) / abs(b) for a, b in zip(replayed0, eager0))
    del nets0, step0, opt0, opt_e
    net = lm(c["dropout"])
    opt = sgd(net)
    eager_losses, eager_ms = timed_calls(torch, lambda: eager_f32(net, opt),
                                         LSTM_EAGER_STEPS)
    step = jit_train_step(net, loss_fn, opt)
    t = time.perf_counter()
    first = float(step(x, y))
    capture_s = time.perf_counter() - t
    losses, step_ms = timed_calls(torch, lambda: step(x, y), LSTM_STEPS)
    tokens = c["batch"] * c["steps"]
    lstm_s = time.perf_counter() - t1

    # (3) beam search over the LM's first cell
    t2 = time.perf_counter()
    beam_steps, beam_prompts = BEAM_STEPS, BEAM_PROMPTS
    net.eval()
    prompts = paddle.to_tensor(rng.randint(3, c["vocab"], (
        beam_prompts, BEAM_PROMPT_LEN)))
    with torch.no_grad():
        _, states = paddle.nn.RNN(net.rnn.cell_fw_0)(net.emb(prompts))

    def decode():
        dec = paddle.nn.BeamSearchDecoder(
            net.rnn.cell_fw_0, 1, BEAM_END, BEAM, embedding_fn=net.emb,
            output_fn=net.proj)
        ids_, lp_ = paddle.nn.dynamic_decode(dec, states,
                                             max_step_num=beam_steps)
        return np.asarray(ids_.numpy()), np.asarray(lp_.numpy())

    torch.cuda.synchronize()
    t = time.perf_counter()
    beam_ids, beam_lp = decode()
    beam_ms = (time.perf_counter() - t) * 1e3
    rescored = beam_rescore(torch, paddle, net, states, beam_ids)
    beam_gap = float(np.abs(rescored - beam_lp).max())
    with patched((paddle.nn.functional, "gather_tree",
                  lambda ids_, parents: ids_)):
        raw_ids, _ = decode()
    raw_gap = float(np.abs(beam_rescore(torch, paddle, net, states,
                                        raw_ids) - beam_lp).max())
    beam_s = time.perf_counter() - t2
    emit("api_nn", cases=len(swept), sizes=sz, families=families,
         slowest_cases_s=dict(sorted(case_s.items(),
                                     key=lambda kv: -kv[1])[:10]),
         laws={k: v[0] for k, v in laws.items()},
         planted_fault="reflect padding repeating the edge",
         planted_fault_err=fault_err, sweep_s=sweep_s,
         lstm=dict(model="Zaremba et al. 2014 large LSTM LM (2 x 1500, "
                   "vocab 10000, 35 steps, batch 20, dropout 0.65, init "
                   "+-0.04, SGD lr 1, clip 10), f32",
                   source="Zaremba, Sutskever, Vinyals 2014 (Recurrent "
                   "Neural Network Regularization), section 4.1 large",
                   params=sum(p.size for p in net.parameters()),
                   dropout0_replayed=replayed0, dropout0_eager=eager0,
                   dropout0_max_rel_gap=gap0, eager_losses=eager_losses,
                   eager_step_ms=eager_ms, capture_s=capture_s,
                   first_loss=first, losses=losses, step_ms=step_ms,
                   tokens_per_s=[tokens / (m / 1e3) for m in step_ms],
                   eager_tokens_per_s=[tokens / (m / 1e3)
                                       for m in eager_ms], phase_s=lstm_s),
         beam=dict(beam=BEAM, prompts=beam_prompts, steps=beam_steps,
                   ids_shape=list(beam_ids.shape), decode_ms=beam_ms,
                   max_score_gap=beam_gap, limit=BEAM_LIMIT,
                   planted_fault="ids without the backtrace (JAX's)",
                   planted_fault_gap=raw_gap,
                   best_scores=beam_lp[:, 0].tolist(), phase_s=beam_s),
         peak_gb=torch.cuda.max_memory_allocated() / 2**30,
         phase_s=time.perf_counter() - t_all, card=card)
    if gap0 > JIT_LOSS_LIMIT:
        problems.append(f"the LSTM's replayed losses {replayed0} differ from "
                        f"the eager loop's {eager0} by {gap0}")
    if not all(math.isfinite(v) for v in losses + eager_losses):
        problems.append("an LSTM loss is not finite")
    if beam_gap > BEAM_LIMIT:
        problems.append(f"a beam's score differs from its rescoring by "
                        f"{beam_gap}")
    if raw_gap <= BEAM_LIMIT:
        problems.append(f"the ids without the backtrace rescore within the "
                        f"limit ({raw_gap})")
    for p in problems:
        fail(f"api_nn: {p}")
    del step, net, opt
    torch.cuda.empty_cache()


# api_infer: the deployment path (paddle.jit, paddle.static's inference
# model, paddle.inference and inference.serving's InferenceServer) at
# BERT-base's full width: BertForQuestionAnswering at BertConfig() defaults
# (seed 55, Layer.bfloat16()) on api_bert's recipe shape (bench.py:354-386,
# 32 x 384), mask-free (ids and token types), so K6a runs in every layer;
# then LlamaForCausalLM at LLaMA-7B's width (4096, 32 heads of 128, FFN
# 11008, vocab 32000) cut to 2 layers, bf16, one prompt of 512 tokens,
# through the same export (K5, K6a, K9a).  The logits gate: the largest
# gap to the plain versions' forward within INFER_REL_LIMIT of the plain
# logits' largest magnitude (bf16 activations through 12 layers: a few
# roundings of 2^-8 of the largest value, the plain attention in f32),
# LLaMA's within LOGIT_LIMIT (the serve's bar on LLaMA-7B's logits of std
# 1).  Every planted fault must land beyond its bar.
INFER_REL_LIMIT = 0.05
INFER_CALLS = 5                    # timed replays
INFER_CLIENTS, INFER_REQUESTS = 4, 8
INFER_BERT = {}                    # BertConfig() defaults: BERT-base
INFER_LLAMA = dict(vocab_size=32000, hidden_size=4096,
                   intermediate_size=11008, num_hidden_layers=2,
                   num_attention_heads=32, tensor_parallel=False)
INFER_LLAMA_PROMPT = 512
# the child process that serves the export: it imports the port's
# inference package (never its models), loads the artifact, replays it
# INFER_CALLS times and prints one JSON line
INFER_CHILD = r"""
import json, sys, time
import numpy as np, torch
import paddle_tpu_torch as paddle
from paddle_tpu_torch.inference import Config, create_predictor
art, inp, outp, runs, dev = sys.argv[1:4] + [int(sys.argv[4]), sys.argv[5]]
paddle.set_device("gpu" if dev == "cuda" else "cpu")
sync = torch.cuda.synchronize if dev == "cuda" else (lambda: None)
z = np.load(inp)
xs = [z[k] for k in sorted(z.files, key=lambda n: int(n.split("_")[1]))]
t = time.perf_counter()
pred = create_predictor(Config(art))
load_s = time.perf_counter() - t
t = time.perf_counter()
outs = pred.run(xs)
capture_s = time.perf_counter() - t
call, = pred._calls.values()
run_ms, replay_ms = [], []
for _ in range(runs):
    sync()
    t = time.perf_counter()
    outs = pred.run(xs)
    run_ms.append((time.perf_counter() - t) * 1e3)
for _ in range(runs):
    if dev == "cuda":
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        call.replay()
        ev[1].record()
        sync()
        replay_ms.append(ev[0].elapsed_time(ev[1]))
    else:
        t = time.perf_counter()
        call.replay()
        replay_ms.append((time.perf_counter() - t) * 1e3)
bad = sorted(m for m in sys.modules if m.startswith(
    "paddle_tpu_torch.models") or m.split(".")[0] in ("jax", "paddle_tpu"))
np.savez(outp, *outs)
print(json.dumps({"load_s": load_s, "capture_s": capture_s,
                  "run_ms": run_ms, "replay_ms": replay_ms,
                  "replays": call.replays,
                  "per_replay": call.capture_launches,
                  "forbidden_modules": bad}), flush=True)
"""


def calls_ran(wrapper, calls):
    """The launches that ran since the counters were zeroed, while
    ``calls`` (jit.capture calls made in that time) were captured and
    replayed: the wrappers' counts, less what each capture recorded, plus
    every replay's."""
    out = dict(wrapper)
    for c in calls:
        for k, n in c.capture_launches.items():
            out[k] = out.get(k, 0) + (c.replays - 1) * n
    return out


def logit_stack(torch, outs):
    """A model's outputs (Tensors or arrays) as one f32 torch tensor."""
    outs = outs if isinstance(outs, (list, tuple)) else [outs]
    return torch.stack([torch.as_tensor(np.asarray(o)) if not hasattr(
        o, "_data") else o._data.float().cpu() for o in outs])


def phase_api_infer(torch, seed, mods, card, dev="cuda"):
    """The deployment path on the card: (1) to_static against the eager and
    the plain forward; (2) Model.save(training=False) -> jit.load; (3)
    convert_to_export, served by a Predictor in a child process that loads
    no model code; (4) InferenceServer over a DevicePool on the card, 4
    clients x 8 requests; (5) the Layer LLaMA through the same export; (6)
    planted faults: K6a told causal=True inside the exported program, and
    the graph's lock held short (two requests' copies in before the first's
    copy out).  The model and input sizes are module constants
    (``INFER_BERT``, ``API_BERT_BATCH`` / ``API_BERT_SEQ``, ``INFER_LLAMA``
    / ``INFER_LLAMA_PROMPT``), which a rehearsal patches; ``dev="cpu"``
    runs it on the CPU.  -> the main path's launches."""
    import tempfile
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import inference
    from paddle_tpu_torch.inference import serving
    from paddle_tpu_torch.models import (BertConfig, BertForQuestionAnswering,
                                         LlamaConfig, LlamaForCausalLM)
    fa = mods["fa"]
    t_all = time.perf_counter()
    cuda = dev == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    paddle.set_device("gpu" if cuda else "cpu")
    llama_cfg, llama_prompt = INFER_LLAMA, INFER_LLAMA_PROMPT
    problems, launches = [], {}

    def add(ran):
        for k, v in ran.items():
            launches[k] = launches.get(k, 0) + v

    cfg = BertConfig(**INFER_BERT)
    L, B, S = cfg.num_hidden_layers, API_BERT_BATCH, API_BERT_SEQ
    paddle.seed(55)
    net = BertForQuestionAnswering(cfg)
    net.bfloat16()
    net.eval()
    rng = np.random.RandomState(0)               # bench.py:372-378
    ids = rng.randint(0, cfg.vocab_size, (B, S)).astype(np.int64)
    tt = np.zeros((B, S), np.int64)
    x = (paddle.to_tensor(ids), paddle.to_tensor(tt))
    plain_calls = []
    real_plain = fa.sdpa_plain

    def wall_ms(fn, n):
        ms = []
        for _ in range(n):
            sync()
            t = time.perf_counter()
            fn()
            sync()
            ms.append((time.perf_counter() - t) * 1e3)
        return ms

    # (1) to_static against the eager forward and the plain versions'
    with paddle.no_grad():
        with op_impls(api_plain_impls(torch, mods)):
            plain = logit_stack(torch, net(*x))
        eager = logit_stack(torch, net(*x))
        eager_ms = wall_ms(lambda: net(*x), INFER_CALLS)
        static = paddle.jit.to_static(net)
        zero_counts(mods)
        with patched((fa, "sdpa_plain", lambda *a, **k: plain_calls.append(1)
                      or real_plain(*a, **k))):
            t = time.perf_counter()
            static(*x)
            sync()
            capture_s = time.perf_counter() - t
            static_ms = wall_ms(lambda: static(*x), INFER_CALLS)
            got = logit_stack(torch, static(*x))
    scalls = list(static._static_fn.program_cache.values())
    add(calls_ran(read_counts(mods), scalls))
    scale = float(plain.abs().max())
    bar = INFER_REL_LIMIT * scale
    gap = float((got - plain).abs().max())
    static_eager_gap = float((got - eager).abs().max())
    per_call = scalls[0].capture_launches if scalls else {}
    if len(scalls) != 1 or per_call.get("flash_attention_fwd") != L:
        problems.append(f"to_static made {len(scalls)} programs, a replay "
                        f"launching {per_call}; the code predicts one, {L} "
                        f"of flash_attention_fwd")
    if plain_calls:
        problems.append(f"{len(plain_calls)} attentions reached sdpa_plain")
    if not gap <= bar:
        problems.append(f"the to_static logits differ from the plain "
                        f"versions' by {gap} (limit {bar})")

    with tempfile.TemporaryDirectory() as tmp:
        # (2) Model.save(training=False) -> jit.load
        t = time.perf_counter()
        paddle.Model(net).save(f"{tmp}/bert", training=False)
        loaded = paddle.jit.load(f"{tmp}/bert")
        with paddle.no_grad():
            loaded_gap = float((logit_stack(torch, loaded(*x)) - eager)
                               .abs().max())
        save_load_s = time.perf_counter() - t
        del loaded
        if loaded_gap != 0.0:
            problems.append(f"the TranslatedLayer's logits differ from the "
                            f"saved Layer's by {loaded_gap}")

        # (3) the export, served in a child process
        t = time.perf_counter()
        art = inference.convert_to_export(net, [((B, S), "int64")] * 2,
                                          f"{tmp}/bert_export")
        export_s = time.perf_counter() - t
        np.savez(f"{tmp}/in.npz", ids, tt)
        root = os.path.dirname(os.path.abspath(__file__))
        t = time.perf_counter()
        child = subprocess.run(
            [sys.executable, "-c", INFER_CHILD, art, f"{tmp}/in.npz",
             f"{tmp}/out.npz", str(INFER_CALLS), dev], cwd=root,
            env=dict(os.environ, PYTHONPATH=root), capture_output=True,
            text=True, timeout=600)
        child_s = time.perf_counter() - t
        rep = {}
        if child.returncode != 0:
            problems.append(f"the serving child failed: "
                            f"{child.stderr.strip()[-2000:]}")
        else:
            rep = json.loads(child.stdout.strip().splitlines()[-1])
            z = np.load(f"{tmp}/out.npz")
            child_logits = logit_stack(torch, [z[k] for k in sorted(
                z.files, key=lambda n: int(n.split("_")[1]))])
            rep["gap_to_eager"] = float((child_logits - eager).abs().max())
            rep["gap_to_plain"] = float((child_logits - plain).abs().max())
            k6 = rep["per_replay"].get("flash_attention_fwd")
            if k6 != L:
                problems.append(f"the child's replay launches "
                                f"{rep['per_replay']}, the code predicts "
                                f"{L} of flash_attention_fwd")
            if rep["forbidden_modules"]:
                problems.append(f"the child imported "
                                f"{rep['forbidden_modules']}")
            if not rep["gap_to_eager"] <= bar:
                problems.append(f"the child's logits differ from the eager "
                                f"ones by {rep['gap_to_eager']} (limit "
                                f"{bar})")
            add({k: v * rep["replays"] for k, v in
                 rep["per_replay"].items()})
            rep["samples_per_s"] = [B / (m / 1e3) for m in rep["replay_ms"]]

        # (4) InferenceServer over a DevicePool on the card
        zero_counts(mods)
        srv = serving.InferenceServer(inference.Config(art),
                                      devices=["cuda:0" if cuda else "cpu"])
        port = srv.start()
        url = f"http://127.0.0.1:{port}"
        n_req = INFER_CLIENTS * INFER_REQUESTS
        reqs = [[rng.randint(0, cfg.vocab_size, (B, S)).astype(np.int64),
                 tt] for _ in range(n_req)]
        try:
            replica = srv.pool._replicas[0]
            solo = [replica.run(r) for r in reqs]
            scall2, = replica._calls.values()
            answers, lat, errs = {}, [], []

            def client(c):
                try:
                    for i in range(c, n_req, INFER_CLIENTS):
                        t0 = time.perf_counter()
                        answers[i] = serving.predict_http(url, reqs[i],
                                                          timeout=120)
                        lat.append((time.perf_counter() - t0) * 1e3)
                except Exception as e:
                    errs.append(repr(e))

            threads = [threading.Thread(target=client, args=(c,))
                       for c in range(INFER_CLIENTS)]
            t = time.perf_counter()
            for th in threads:
                th.start()
            for th in threads:
                th.join()
            serve_s = time.perf_counter() - t
            wrong = [i for i in range(n_req) if i not in answers or not all(
                np.array_equal(a, b) for a, b in zip(answers[i], solo[i]))]
            with urllib.request.urlopen(url + "/health", timeout=30) as r:
                health = json.loads(r.read())
            with urllib.request.urlopen(url + "/metrics", timeout=30) as r:
                prom = prom_samples(r.read().decode())
            counted = prom.get("paddle_tpu_http_predict_requests_total")
            bad_req = urllib.request.Request(
                url + "/predict", data=b"not an npz",
                headers={"Content-Type": "application/octet-stream"})
            try:
                urllib.request.urlopen(bad_req, timeout=30)
                malformed = 200
            except urllib.error.HTTPError as e:
                malformed = e.code
            after = serving.predict_http(url, reqs[0], timeout=120)
            still = all(np.array_equal(a, b) for a, b in zip(after, solo[0]))
            # the planted fault: the lock's reach, by hand, without a race
            xa, xb = replica._inputs_of(reqs[0]), replica._inputs_of(reqs[1])
            with scall2.lock:
                scall2.load(xa)
                scall2.replay()
                scall2.load(xb)
                scall2.replay()
                short = [o.float().cpu() for o in scall2.fetch()]
            short = torch.stack(short)
            lock_fault = float((short - logit_stack(torch, solo[0]))
                               .abs().max())
            lock_is_b = bool(torch.equal(short, logit_stack(torch, solo[1])))
        finally:
            srv.stop()
        add(calls_ran(read_counts(mods), [scall2]))
        if errs:
            problems.append(f"clients failed: {errs[:3]}")
        if wrong:
            problems.append(f"answers {wrong} differ from their solo runs")
        if health.get("requests") != n_req:
            problems.append(f"/health counts {health.get('requests')} "
                            f"requests, {n_req} were served")
        if counted != n_req:
            problems.append(f"/metrics counts {counted} predicts, {n_req} "
                            f"were served")
        if malformed != 400 or not still:
            problems.append(f"a malformed body got {malformed}, and the "
                            f"server answered after it: {still}")
        if not (lock_is_b and lock_fault > bar):
            problems.append(f"the short lock's answer is B's: {lock_is_b}, "
                            f"{lock_fault} from A's (limit {bar})")

        # (6a) K6a told causal=True inside the exported program: the
        # server's loaded program, captured anew under the fault
        real_tail = fa._launch_tail
        faulty = inference.Predictor(inference.Config(art),
                                     _shared_from=replica)
        faulty._calls = {}
        with patched((fa, "_launch_tail",
                      lambda q, causal: real_tail(q, not causal))):
            bad = faulty.run([ids, tt])
        del faulty
        causal_fault = float((logit_stack(torch, bad) - plain).abs().max())
        if not causal_fault > bar:
            problems.append(f"K6a told causal=True moved the logits by only "
                            f"{causal_fault} (limit {bar})")
        del bad
    if cuda:
        torch.cuda.empty_cache()

    # (5) the Layer LLaMA through the same export: K5, K6a, K9a
    lcfg = LlamaConfig(**llama_cfg)
    paddle.seed(seed)
    lm = LlamaForCausalLM(lcfg)
    lm.bfloat16()
    lm.eval()
    prompt = np.random.RandomState(seed).randint(
        0, lcfg.vocab_size, (1, llama_prompt)).astype(np.int64)
    with paddle.no_grad(), op_impls(api_plain_impls(torch, mods)):
        lplain = lm(paddle.to_tensor(prompt))._data.float()
    with tempfile.TemporaryDirectory() as tmp:
        t = time.perf_counter()
        lart = inference.convert_to_export(
            lm, [(prompt.shape, "int64")], f"{tmp}/llama")
        lexport_s = time.perf_counter() - t
        zero_counts(mods)
        lpred = inference.create_predictor(inference.Config(lart))
        lout = lpred.run([prompt])[0]
        lms = wall_ms(lambda: lpred.run([prompt]), INFER_CALLS)
        lcall, = lpred._calls.values()
        add(calls_ran(read_counts(mods), [lcall]))
    lgap = float((torch.as_tensor(lout) - lplain.cpu()).abs().max())
    lwant = api_forward_launches(lcfg.num_hidden_layers)
    lper = {k: lcall.capture_launches.get(k, 0) for k in lwant}
    if lper != lwant:
        problems.append(f"the LLaMA replay launches {lcall.capture_launches},"
                        f" the code predicts {lwant}")
    if not lgap <= LOGIT_LIMIT:
        problems.append(f"the LLaMA export's logits differ from the plain "
                        f"forward's by {lgap} (limit {LOGIT_LIMIT})")
    del lm, lpred, lplain
    emit("api_infer", model="BertForQuestionAnswering, BertConfig() "
         "defaults (12 x 768, 12 heads of 64, FFN 3072, vocab 30522), bf16, "
         "seed 55", source="bench.py:354-386 _bert_line recipe shape "
         "(32 x 384), served mask-free", batch=B, seq=S,
         to_static=dict(capture_s=capture_s, replay_ms=static_ms,
                        eager_ms=eager_ms,
                        samples_per_s=[B / (m / 1e3) for m in static_ms],
                        per_replay=per_call, gap_to_plain=gap,
                        gap_to_eager=static_eager_gap, limit=bar,
                        plain_logit_scale=scale,
                        sdpa_plain_calls=len(plain_calls)),
         save_load=dict(seconds=save_load_s, gap=loaded_gap),
         export=dict(seconds=export_s, child_s=child_s, child=rep),
         serving=dict(clients=INFER_CLIENTS, requests=n_req,
                      seconds=serve_s, requests_per_s=n_req / serve_s,
                      latency_ms_p50=pctl(lat, 50),
                      latency_ms_p99=pctl(lat, 99), health=health,
                      metrics_predicts=counted, malformed_code=malformed,
                      replays=scall2.replays,
                      per_replay=scall2.capture_launches),
         llama=dict(config=llama_cfg, prompt=llama_prompt,
                    export_s=lexport_s, run_ms=lms, per_replay=lper,
                    gap_to_plain=lgap, limit=LOGIT_LIMIT),
         planted_faults=dict(k6a_causal=causal_fault,
                             short_lock_gap=lock_fault,
                             short_lock_answer_is_b=lock_is_b),
         launches=launches,
         peak_gb=torch.cuda.max_memory_allocated() / 2**30 if cuda else None,
         phase_s=time.perf_counter() - t_all, card=card)
    for p in problems:
        fail(f"api_infer: {p}")
    del net, static
    if cuda:
        torch.cuda.empty_cache()
    return launches


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    t_start = time.perf_counter()
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
    phase_s = {"build": time.perf_counter() - t0}

    def timed(name, fn, *a, **kw):
        t = time.perf_counter()
        out = fn(*a, **kw)
        phase_s[name] = phase_s.get(name, 0.0) + time.perf_counter() - t
        return out

    k1 = timed("k1", lambda: [phase_k1(torch, pa, nkv, gen, flush)
                              for nkv in (32, 8)])
    k2 = timed("k2", lambda: [phase_k2(torch, fv, nkv, gen, flush)
                              for nkv in (32, 8)])
    k3 = timed("k3", lambda: [phase_k3(torch, im, shape, gen, flush)
                              for shape in K3_SHAPES])
    k4 = timed("k4", lambda: [phase_k4(torch, pa, nkv, gen, flush)
                              for nkv in (32, 8)])
    k5 = timed("k5", lambda: [
        phase_k5(torch, rp, shape, gen, flush, timed=shape in K5_TIMED)
        for shape in K5_SHAPES])
    k6 = timed("k6", lambda: [
        phase_k6(torch, fa, shape, gen, flush, timed=i == 0)
        for i, shape in enumerate(TRAIN_SHAPES)])
    k8 = timed("k8", lambda: [phase_k8(torch, aw, n, gen, flush, timed=i == 0)
                              for i, n in enumerate(K8_SIZES)])
    k7 = timed("k7", lambda: [
        phase_k7(torch, fv, fa, case, args.seed, gen, flush,
                 timed=case[0] in K7_TIMED) for case in K7_CASES])
    eps = LlamaPretrainConfig.rms_norm_eps
    k9 = timed("k9", lambda: [
        phase_k9(torch, rn, case, eps, gen, flush, timed=case[0] in K9_TIMED)
        for case in K9_CASES])
    k10 = timed("k10", lambda: [
        phase_k10(torch, sw, shape, gen, flush, timed=i == 0)
        for i, shape in enumerate(K10_SHAPES)])
    k11 = timed("k11", lambda: [phase_k11(torch, rmm, case, eps, gen, flush)
                                for case in K11_CASES])
    del flush
    torch.cuda.empty_cache()
    cfg = LlamaPretrainConfig()
    s = args.seed
    launches, params = timed("serve", phase_serve, torch, cfg, s, mods)
    torch.cuda.empty_cache()             # the bf16 serve's cache is gone
    launches_overlap = timed("serve_overlap", phase_serve_overlap, torch,
                             cfg, s, params, mods)
    torch.cuda.empty_cache()
    launches_observe = timed("serve_observe", phase_serve_observe, torch,
                             cfg, s, params, mods)
    torch.cuda.empty_cache()
    launches_prefix = timed("serve_prefix", phase_serve_prefix, torch, cfg,
                            s, params, mods)
    torch.cuda.empty_cache()
    launches_dense = timed("serve_dense", phase_serve_dense, torch, cfg, s,
                           params, mods)
    torch.cuda.empty_cache()
    launches_faults = timed("serve_faults", phase_serve_faults, torch, cfg,
                            s, params, mods)
    torch.cuda.empty_cache()
    launches_mixed = timed("serve_mixed", phase_serve_mixed, torch, cfg, s,
                           params, mods)
    torch.cuda.empty_cache()
    launches_spec = timed("serve_spec", phase_serve_spec, torch, cfg, s,
                          params, mods)
    torch.cuda.empty_cache()
    launches_swap = timed("serve_swap", phase_serve_swap, torch, cfg, s,
                          params, mods)
    torch.cuda.empty_cache()
    launches_qos = timed("serve_qos", phase_serve_qos, torch, cfg, s, params,
                         mods)
    torch.cuda.empty_cache()
    launches_disagg = timed("serve_disagg", phase_serve_disagg, torch, cfg,
                            s, params, mods)
    torch.cuda.empty_cache()
    launches_remote = timed("serve_remote", phase_serve_remote, torch, cfg,
                            s, params, mods, card=card)
    torch.cuda.empty_cache()
    launches_api = timed("api_llama", phase_api_llama, torch, cfg, s, params,
                         mods)
    torch.cuda.empty_cache()
    launches_int8, qparams = timed("serve_int8", phase_serve_int8, torch,
                                   cfg, s, params, mods)
    del params
    torch.cuda.empty_cache()
    launches_int8_overlap = timed(
        "serve_int8_overlap", phase_serve_overlap, torch, cfg, s, qparams,
        mods, kv_quant="int8", lanes=INT8_OVERLAP_LANES)
    torch.cuda.empty_cache()
    launches_prefix_int8 = timed(
        "serve_prefix_int8", phase_serve_prefix, torch, cfg, s, qparams,
        mods, kv_quant="int8")
    torch.cuda.empty_cache()
    launches_mixed_int8 = timed(
        "serve_mixed_int8", phase_serve_mixed, torch, cfg, s, qparams, mods,
        kv_quant="int8", waves=MIXED_INT8_WAVES)
    torch.cuda.empty_cache()
    launches_spec_int8 = timed(
        "serve_spec_int8", phase_serve_spec, torch, cfg, s, qparams, mods,
        kv_quant="int8", arms=SPEC_INT8_ARMS)
    torch.cuda.empty_cache()
    launches_swap_int8 = timed(
        "serve_swap_int8", phase_serve_swap, torch, cfg, s, qparams, mods,
        kv_quant="int8")
    torch.cuda.empty_cache()
    launches_disagg_int8 = timed(
        "serve_disagg_int8", phase_serve_disagg, torch, cfg, s, qparams,
        mods, kv_quant="int8")
    del qparams
    torch.cuda.empty_cache()             # the serves' weights are gone
    train_cfg = LlamaPretrainConfig(**TRAIN_CFG)
    launches_train = timed("train", phase_train, torch, train_cfg, s, mods,
                           card)
    torch.cuda.empty_cache()
    timed("train_grads", phase_train_grads, torch, train_cfg, s, mods)
    torch.cuda.empty_cache()
    launches_packed = timed("train_packed", phase_train_packed, torch,
                            train_cfg, s, mods, card)
    torch.cuda.empty_cache()
    timed("train_packed_grads", phase_train_packed_grads, torch, train_cfg,
          s, mods)
    torch.cuda.empty_cache()
    launches_fused = [timed("train_fused", phase_train, torch, train_cfg, s,
                            mods, card, flag_set=flag_set)
                      for flag_set in "AB"]
    torch.cuda.empty_cache()
    for flag_set in "AB":
        timed("train_fused_grads", phase_train_grads, torch, train_cfg, s,
              mods, flag_set=flag_set)
    torch.cuda.empty_cache()
    launches_api_train = timed("api_train", phase_api_train, torch, s, mods)
    torch.cuda.empty_cache()
    launches_api_bert = timed("api_bert", phase_api_bert, torch, s, mods,
                              card)
    torch.cuda.empty_cache()
    launches_api_gpt = timed("api_gpt", phase_api_gpt, torch, s, mods, card)
    torch.cuda.empty_cache()
    timed("api_fit", phase_api_fit, torch, s, card)
    torch.cuda.empty_cache()
    timed("api_resnet", phase_api_resnet, torch, s, card)
    torch.cuda.empty_cache()
    timed("api_ops", phase_api_ops, torch, s, card)
    torch.cuda.empty_cache()
    timed("api_vision", phase_api_vision, torch, s, card)
    torch.cuda.empty_cache()
    launches_api_xf = timed("api_transformer", phase_api_transformer, torch,
                            s, mods, card)
    torch.cuda.empty_cache()
    launches_api_varlen = timed("api_varlen", phase_api_varlen, torch, s,
                                mods, card)
    torch.cuda.empty_cache()
    timed("api_nn", phase_api_nn, torch, s, card)
    torch.cuda.empty_cache()
    launches_api_infer = timed("api_infer", phase_api_infer, torch, s, mods,
                               card)
    # each kernel's launches in the serve, train, train_packed,
    # train_fused and api phases (the api_bert / api_gpt / api_transformer
    # graphs' replays counted in; api_varlen's four main-path calls;
    # api_infer's replays, its child's included)
    runs = [launches, launches_overlap, launches_observe, launches_prefix,
            launches_dense, launches_faults, launches_mixed, launches_spec,
            launches_swap, launches_qos, launches_disagg, launches_remote,
            launches_int8,
            launches_int8_overlap, launches_prefix_int8, launches_mixed_int8,
            launches_spec_int8, launches_swap_int8, launches_disagg_int8,
            launches_train, launches_packed, *launches_fused, launches_api,
            launches_api_train, launches_api_bert, launches_api_gpt,
            launches_api_xf, launches_api_varlen, launches_api_infer]
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
    emit("timing", phase_s=phase_s,
         total_s=time.perf_counter() - t_start, card=card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
