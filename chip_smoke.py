#!/usr/bin/env python3
"""Drive the PyTorch port (paddle_tpu_torch) on one CUDA card.

Run from the repository root:  python3 chip_smoke.py

Phases, one JSON line each on stdout:

1. device  - the card's name and power limit (nvidia-smi), TF32 off.
2. build   - nvcc builds every kernel of the serving path, in parallel.
3. k1 / k2 - each kernel against its plain PyTorch version on the card, at
             the main path's shapes, for nkv = 32 (LLaMA-7B) and nkv = 8
             (GQA): max abs error, kernel / plain / library-call times
             (CUDA events, median of 25 runs after warm-up, L2 flushed
             before each) and the least time the card could take.
4. serve   - LLaMA-7B at full width and depth with random weights from a
             seed behind the port's GenerationServer: concurrent /generate
             requests and one /generate_stream; every reply complete, each
             kernel launched during the serve, no page left owned.  Then
             each served sequence, teacher-forced, through the port's own
             prefill and decode step (the kernels) and through a plain
             dense forward (no kernel): their logits within LOGIT_LIMIT,
             a planted fault beyond it, and every served token within
             2 * LOGIT_LIMIT of the plain forward's top logit.
5. kernels - one JSON object with an entry per ported kernel.

The last line is {"ok": true, "device": {...}}.  Any failed check exits
non-zero before that line.  Without a CUDA device, or without the package
beside this script, it exits non-zero and prints no result.
"""

import argparse
import json
import math
import statistics
import subprocess
import sys
import threading
import time

import numpy as np

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

K1_LENS = [1, 64, 65, 2048, 300, 1000, 1500, 777]
K2_SEGMENTS = [700, 64, 1, 900, 300]   # + sentinel padding up to T
K2_T = 2048


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


def bound(bytes_moved, flops):
    t_bytes = bytes_moved / PEAK_BYTES * 1e3
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_close(name, got, ref):
    torch = sys.modules["torch"]
    err = float((got.float() - ref.float()).abs().max())
    if not torch.isfinite(got.float()).all():
        fail(f"{name}: non-finite output")
    if not torch.allclose(got.float(), ref.float(), **TOL):
        fail(f"{name}: max abs err {err} beyond atol/rtol 2e-2")
    return err


def phase_k1(torch, pa, nkv, gen, flush):
    B, n, d, page, pages_max = 8, 32, 128, 64, 32
    dev = "cuda"
    used = [-(-L // page) for L in K1_LENS]
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
    lens = torch.tensor(K1_LENS, dtype=torch.int32, device=dev)
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
    ms = time_ms(torch, lambda: pa.paged_decode_attention(
        q, kp, vp, tables, lens), flush)
    plain_ms = time_ms(torch, lambda: pa.paged_decode_attention_plain(
        q, kp, vp, tables, lens), flush)
    # yardstick only: SDPA over K/V gathered beforehand into [B, nkv, S, d]
    S = pages_max * page
    kg = kp[tables.long()].permute(0, 2, 1, 3, 4).reshape(B, nkv, S, d)
    vg = vp[tables.long()].permute(0, 2, 1, 3, 4).reshape(B, nkv, S, d)
    mask = (torch.arange(S, device=dev)[None] < lens[:, None])[:, None, None]
    lib_ms = library_ms(torch, flush, q[:, :, None], kg.contiguous(),
                        vg.contiguous(), mask, nkv != n)
    tok = sum(K1_LENS)
    nbytes = tok * nkv * d * 2 * 2 + 2 * q.numel() * 2 + B * (pages_max + 1) * 4
    flops = tok * n * 4 * d
    b_ms, b_by = bound(nbytes, flops)
    res = dict(nkv=nkv, max_abs_err=err, ms=ms, plain_ms=plain_ms,
               library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by,
               shapes=dict(B=B, n=n, d=d, page=page, pages_max=pages_max,
                           lens=K1_LENS))
    emit("k1", **res)
    return res


def library_ms(torch, flush, q, k, v, mask, gqa):
    import torch.nn.functional as F
    return time_ms(torch, lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=mask, enable_gqa=gqa), flush)


def phase_k2(torch, fv, nkv, gen, flush):
    n, d, T = 32, 128, K2_T
    dev = "cuda"
    seg_np = np.full((T,), len(K2_SEGMENTS), np.int32)     # sentinel tail
    at = 0
    for i, L in enumerate(K2_SEGMENTS):
        seg_np[at:at + L] = i
        at += L
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
    # a ragged stream (no 64-row tile divides it) runs the same kernel
    Tr = 2000
    out_r = fv.flash_attention_segmented(
        q[:, :Tr].contiguous(), k[:, :Tr].contiguous(),
        v[:, :Tr].contiguous(), seg[:, :Tr].contiguous(), causal=True)
    ref_r = fv.segmented_sdpa_plain(q[:, :Tr].float(), k[:, :Tr].float(),
                                    v[:, :Tr].float(), seg[:, :Tr], True)
    err_r = check_close(f"K2 ragged T={Tr} nkv={nkv}", out_r, ref_r)
    ms = time_ms(torch, lambda: fv._seg_fwd(q, k, v, seg, True), flush)
    plain_ms = time_ms(torch, lambda: fv.segmented_sdpa_plain(
        q, k, v, seg, True), flush)
    lib_ms = library_ms(torch, flush, q.transpose(1, 2).contiguous(),
                        k.transpose(1, 2).contiguous(),
                        v.transpose(1, 2).contiguous(), vis, nkv != n)
    runs = np.diff(np.flatnonzero(np.r_[1, np.diff(seg_np) != 0, 1]))
    pairs = int(sum(L * (L + 1) // 2 for L in runs))
    nbytes = (2 * q.numel() + 2 * k.numel()) * 2 + n * T * 4 + T * 4
    flops = pairs * n * 4 * d
    b_ms, b_by = bound(nbytes, flops)
    res = dict(nkv=nkv, max_abs_err=max(err, err_r), lse_max_abs_err=lse_err,
               ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
               bound_by=b_by, visible_pairs=pairs,
               shapes=dict(T=T, n=n, d=d, segments=K2_SEGMENTS))
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
    a time through ``make_paged_decode_step(with_logits=True)`` (K1).
    -> one ``[len(gens[i]), V]`` fp32 tensor per request; the rows are
    released afterwards."""
    from paddle_tpu_torch.models.llama_pretrain import _mm, _rms_norm
    from paddle_tpu_torch.models.paged_decode import (
        _packed_prefill_body, make_paged_decode_step)
    page = cache.page
    prefill = _packed_prefill_body(cfg)
    step = make_paged_decode_step(cfg, with_logits=True)
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
        _, _, _, logits = step(params, cache.kpool, cache.vpool, tables,
                               lens, torch.from_numpy(tok).to(dev))
        for i in rows:
            out[i].append(logits[i:i + 1])
            cache.lens[i] += 1
    for i in range(len(prompts)):
        cache.release_row(i)
    return [torch.cat(o) for o in out]


def phase_serve(torch, cfg, seed, pa, fv, dev="cuda"):
    import paddle_tpu_torch.models.paged_decode as pd
    from paddle_tpu_torch.inference.serving import (
        GenerationServer, generate_http, generate_http_stream)
    from paddle_tpu_torch.models.llama_pretrain import init_params
    from paddle_tpu_torch.models.paged_decode import PagedKVCache

    t0 = time.perf_counter()
    params = init_params(cfg, seed=seed, device=dev)
    cache = PagedKVCache(cfg, num_pages=256, pages_max=32, batch=8, page=64,
                         device=dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    rng = np.random.default_rng(seed)
    lens = [1, 64, 65, 300, 700, 1000, 129]
    news = [32, 16, 24, 20, 32, 17, 24]
    prompts = [rng.integers(0, cfg.vocab_size, L).tolist() for L in lens]
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

    pa.launches = 0
    fv.launches = 0
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
    launches = {"paged_decode_attention": pa.launches,
                "flash_attention_segmented": fv.launches}
    eng = srv.engine
    health = srv.health_snapshot()
    srv.stop()
    peak = torch.cuda.max_memory_allocated()
    if errors or len(results) != len(prompts):
        fail(f"serve: {errors or 'a request did not return'}")
    for i in range(len(prompts)):
        toks = results[i][0]
        if len(toks) != news[i]:
            fail(f"serve: request {i} got {len(toks)} of {news[i]} tokens")
    for name, c in launches.items():
        if c <= 0:
            fail(f"serve: kernel {name} was not launched")
    if cache.audit()["owned"]:
        fail("serve: pages still owned after every request finished")
    gens = [results[i][0] for i in range(len(prompts))]
    plain = [plain_logits(torch, cfg, params, prompts[i] + gens[i][:-1],
                          dev)[len(prompts[i]) - 1:]
             for i in range(len(prompts))]

    def max_diff(logits):
        return max(float((a - b).abs().max()) for a, b in zip(logits, plain))

    sound = port_logits(torch, cfg, params, cache, prompts, gens, dev)
    logit_diff = max_diff(sound)
    del sound
    # planted fault: every decode layer attends over lens slots instead of
    # lens + 1, missing the token written this step
    real = pd.paged_decode_attention
    pd.paged_decode_attention = (
        lambda q, kp, vp, tables, lens: real(q, kp, vp, tables, lens - 1))
    try:
        fault = port_logits(torch, cfg, params, cache, prompts, gens, dev)
    finally:
        pd.paged_decode_attention = real
    fault_diff = max_diff(fault)
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
         prompt_lens=lens, new_tokens=news, setup_s=setup_s, wall_s=wall,
         stream_ttft_s=ttft.get(len(prompts) - 1),
         request_s=[results[i][1] for i in range(len(prompts))],
         decode_tok_s=(eng.tokens_generated / eng.decode_wall_s
                       if eng.decode_wall_s else None),
         decode_steps=health["decode_steps"],
         prefill_waves=health["prefill_calls"],
         peak_mem_gb=peak / 2**30, launches=launches,
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
    return launches


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device (this script measures the port on a card)")
    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.ops import flash_varlen as fv
    from paddle_tpu_torch.ops import paged_attention as pa

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

    names = ["paged_attention", "flash_varlen"]
    t0 = time.perf_counter()
    secs = _build.build(names)
    for name in names:
        for line in _build.build_logs.get(name, "").splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas {name}: {line.strip()}", file=sys.stderr)
    emit("build", seconds=time.perf_counter() - t0, per_source=secs)

    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    flush = torch.empty(64 * 2**20, dtype=torch.int32, device="cuda")
    k1 = [phase_k1(torch, pa, nkv, gen, flush) for nkv in (32, 8)]
    k2 = [phase_k2(torch, fv, nkv, gen, flush) for nkv in (32, 8)]
    del flush
    from paddle_tpu_torch.models.llama_pretrain import LlamaPretrainConfig
    launches = phase_serve(torch, LlamaPretrainConfig(), args.seed, pa, fv)

    def entry(name, source, replaces, runs):
        main_shape = runs[0]             # nkv = 32, the LLaMA-7B shape
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
    ], "card": card}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
