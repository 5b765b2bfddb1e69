#!/usr/bin/env python3
"""Where an admission wave and a decode step of the PyTorch port's LLaMA-7B
serving path spend their time on one CUDA card.

Run from the repository root:

    python3 tools/profile_torch_decode.py [--batch 8] [--ctx 1024] [--steps 8]
        [--int8] [--lane sync|overlap] [--horizon H] [--tree DIR]

Builds LLaMA-7B (full width and depth, random weights from ``--seed``) and
the port's engine (with ``--int8``: int8 weights from
``quantize_params_int8`` over int8 KV pages), then:

* the admission wave: ``WAVE_PROMPTS`` prompts of ``WAVE_LEN`` tokens
  (one 2,048-token packed stream) admitted by a fresh engine in one
  packed wave (the packed prefill, the page write, the first tokens'
  logits): one wave to warm up, then ``WAVES`` timed on the host clock,
  each ending in ``torch.cuda.synchronize()`` (the wave's share of TTFT),
  and one more profiled with ``torch.profiler``: its device time by kernel
  kind (K2, K3, the library matrix products, the rest);
* the decode step: ``--batch`` prompts of ``--ctx`` tokens admitted in one
  wave on an engine of the chosen lane (``--lane sync``: the eager step
  and a blocking fetch a token; ``--lane overlap``: the dispatch-ahead
  pipeline; ``--horizon H``: H tokens a dispatch, on either lane; every
  step but the eager one replays from a CUDA graph), two steps to warm up
  (the admission wave, the capture), ``--steps`` engine steps timed on the
  host clock to a synchronize and ``--steps`` more profiled: the device
  time of every CUDA kernel by name and kind.  Every time is also given
  per token (per micro-step of the batch: an engine step is H of them).

``--tree DIR`` imports ``paddle_tpu_torch`` from another checkout of the
repository (an earlier tree unpacked into a gitignored directory), so one
command can profile the parent's kernels and this tree's in turn.

Prints one JSON line: the card (nvidia-smi name and power limit), the wave
and step times, host and device ms per token, the device busy share
(kernel time over host time), the kernel breakdowns (per step and per
token), the device activities a step and the device's idle time a token
between them (gaps under ``GAP_US`` and longer ones) and K3's kernels by
name (device ms and launches a decode step).
Exits non-zero without a CUDA device.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from tools.torch_profile_common import card_line, device_time  # noqa: E402

# the admission wave: prompts, their length, timed waves
WAVE_PROMPTS, WAVE_LEN, WAVES = 8, 256, 3
# a gap between two device activities shorter than this (µs) is counted
# as launch latency, a longer one as the device waiting for work
GAP_US = 20.0


def _kind(name: str) -> str:
    # the split pass (paged_decode_split_kernel) and its combine
    # (paged_decode_combine_kernel)
    if "paged_decode_" in name:
        # the int8-page instantiations' template argument is int8_t
        if "char" in name:
            return "paged_decode_attention_q8 (K4)"
        return "paged_decode_attention (K1)"
    # K2: seg_fwd_kernel before the Hopper redesign, then the shared
    # forward's segmented instance, flash_fwd_kernel<d, true>, and the
    # per-tile range kernel its wrapper launches first
    if ("seg_fwd_kernel" in name or "seg_tile_ranges_kernel" in name
            or ("flash_fwd_kernel" in name and "true" in name)):
        return "flash_attention_segmented (K2)"
    # K3: int8_matmul_kernel (the decode path before its redesign; before
    # the wave path's also the wave), int8_decode_kernel, int8_wave_kernel
    # and the split's int8_matmul_reduce
    if "int8_matmul" in name or "int8_wave" in name or "int8_decode" in name:
        return "int8_matmul (K3)"
    low = name.lower()
    if any(t in low for t in ("gemm", "gemv", "nvjet", "cutlass", "cublas",
                              "xmma")):
        return "matmul (cuBLAS)"
    return "other"


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--ctx", type=int, default=1024)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--int8", action="store_true",
                    help="int8 weights over int8 KV pages")
    ap.add_argument("--lane", choices=("sync", "overlap"), default="sync")
    ap.add_argument("--horizon", type=int, default=1,
                    help="decode_horizon: tokens a dispatch")
    ap.add_argument("--tree", type=os.path.abspath,
                    help="import paddle_tpu_torch from this checkout")
    args = ap.parse_args()
    if args.tree:
        sys.path.insert(0, args.tree)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        sys.exit(1)
    import paddle_tpu_torch
    from paddle_tpu_torch.models.decode import quantize_params_int8
    from paddle_tpu_torch.models.llama_pretrain import (LlamaPretrainConfig,
                                                        init_params)
    from paddle_tpu_torch.models.paged_decode import PagedKVCache
    from paddle_tpu_torch.models.serving_engine import (
        ContinuousBatchingEngine)

    card = card_line()
    cfg = LlamaPretrainConfig()
    page = 64
    H = args.horizon
    new = (2 * args.steps + 4) * H
    lane_kw = {}
    if args.lane == "overlap":
        lane_kw["overlap"] = True
    if H > 1:
        lane_kw["decode_horizon"] = H
    kv_quant = "int8" if args.int8 else None
    params = init_params(cfg, seed=args.seed)
    if args.int8:
        params = quantize_params_int8(params)
    rng = np.random.default_rng(args.seed)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]

    def engine(batch, ctx, **kw):
        """A fresh engine whose queue holds ``batch`` prompts of ``ctx``
        tokens, every page they need free."""
        pages_max = -(-(ctx + new) // page)
        cache = PagedKVCache(cfg, num_pages=1 + batch * pages_max,
                             pages_max=pages_max, batch=batch, page=page,
                             kv_quant=kv_quant)
        eng = ContinuousBatchingEngine(cfg, params, cache, **kw)
        for _ in range(batch):
            eng.submit(rng.integers(0, cfg.vocab_size, ctx),
                       max_new_tokens=new)
        return eng

    # the admission wave alone: warm-up, timed waves, one profiled
    wave_ms = []
    for i in range(WAVES + 2):
        eng = engine(WAVE_PROMPTS, WAVE_LEN)
        torch.cuda.synchronize()
        if i == WAVES + 1:
            with torch.profiler.profile(activities=acts) as prof:
                eng._admit_wave()
                torch.cuda.synchronize()
        else:
            t0 = time.perf_counter()
            eng._admit_wave()
            torch.cuda.synchronize()
            if i:
                wave_ms.append((time.perf_counter() - t0) * 1e3)
        tokens = eng.prefill_token_slots
        del eng
    wave_busy, wave_kinds, wave_top = device_time(torch, prof, _kind, 1, 12)
    wave_host = min(wave_ms)
    torch.cuda.empty_cache()

    eng = engine(args.batch, args.ctx, **lane_kw)
    eng.step()                       # admission wave + first decode step
    eng.step()                       # warm-up (the graph's capture)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(args.steps):
        eng.step()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / args.steps * 1e3
    if getattr(eng, "pipeline_flushes", 0) or eng.prefill_calls != 1:
        print("the timed steps flushed or admitted", file=sys.stderr)
        sys.exit(1)

    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(args.steps):
            eng.step()
        torch.cuda.synchronize()
    busy_ms, by_kind, top = device_time(torch, prof, _kind, args.steps, 12)
    # the device's idle time between consecutive device activities of the
    # profiled steps: gaps under GAP_US (one activity queued right behind
    # another) and longer ones (the device waiting on the host)
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    gaps = [b - a_end for (_, a_end), (b, _) in zip(spans, spans[1:])
            if b > a_end]
    short_ms = sum(g for g in gaps if g < GAP_US) / 1e3 / args.steps
    long_ms = sum(g for g in gaps if g >= GAP_US) / 1e3 / args.steps
    # K3's kernels by name: its paths and the wave path's reduce pass
    k3 = {}
    for evt in prof.events():
        if (evt.device_type == torch.autograd.DeviceType.CUDA
                and _kind(evt.name) == "int8_matmul (K3)"):
            ms, n = k3.get(evt.name[:120], (0.0, 0))
            k3[evt.name[:120]] = (ms + evt.time_range.elapsed_us() / 1e3, n + 1)
    print(json.dumps({
        "card": card, "model": "LLaMA-7B (LlamaPretrainConfig defaults)",
        "tree": os.path.dirname(os.path.dirname(
            os.path.abspath(paddle_tpu_torch.__file__))),
        "weights_and_pages": "int8" if args.int8 else "bf16",
        "wave": {"prompts": WAVE_PROMPTS, "len": WAVE_LEN,
                 "stream_tokens": tokens, "host_ms": wave_ms,
                 "host_ms_min": wave_host, "device_busy_ms": wave_busy,
                 "device_busy_share": wave_busy / wave_host,
                 "ms_by_kind": wave_kinds, "top_kernels": wave_top},
        "batch": args.batch, "ctx": args.ctx, "steps": args.steps,
        "lane": args.lane, "horizon": H,
        "step_ms": step_ms, "device_busy_ms_per_step": busy_ms,
        "host_ms_per_token": step_ms / H,
        "device_ms_per_token": busy_ms / H,
        "device_busy_share": busy_ms / step_ms if step_ms else None,
        "host_syncs": getattr(eng, "host_syncs", None),
        "decode_steps": eng.decode_steps,
        "per_step_ms_by_kind": by_kind,
        "per_token_ms_by_kind": {k: v / H for k, v in by_kind.items()},
        "device_activities_per_step": len(spans) / args.steps,
        "idle_ms_per_token_short_gaps": short_ms / H,
        "idle_ms_per_token_long_gaps": long_ms / H, "gap_us": GAP_US,
        "k3_kernels_per_step": {
            name: {"ms": ms / args.steps, "launches": n / args.steps}
            for name, (ms, n) in k3.items()},
        "top_kernels": top,
    }), flush=True)


if __name__ == "__main__":
    main()
