#!/usr/bin/env python3
"""Where an admission wave of the PyTorch port's LLaMA-7B serving path spends
its time on one CUDA card, lane by lane, with and without prefix caching.

Run from the repository root:

    python3 tools/profile_torch_admission.py [--int8] [--seed 0]

Builds LLaMA-7B (full width and depth, random weights from ``--seed``; with
``--int8`` int8 weights over int8 KV pages) and, on 8 slots and 256 pages of
64, admits:

* the prefix layout (chip_smoke's ``serve_prefix``): a first wave of 4
  requests behind one 448-token prompt (7 pages) with tails of 16-200
  tokens, untimed, then the measured wave: 4 more requests behind the same
  prompt.  With prefix caching the measured wave hits the pool (28 pages);
  without it every token is computed.  On the packed lane (the default)
  and on the chunked lane (``packed=False``, ``prefill_chunk`` 256);
* the batched dense lane (``packed=False``, ``prefill_bucket`` 256): one
  wave of 8 prompts of 242-256 tokens, one [8, 256] dense dispatch; once
  with the RoPE tables' memo (``ops.rope.cached_tables``) and once with
  every layer building its tables (``rope_tables``), as before the memo.

Each case runs ``WAVES`` + 1 times on fresh engines (the first a warm-up):
the measured wave timed on the host clock between two synchronizes (its
prefill dispatches, page write and first tokens), then once more under
``torch.profiler``: device time by kernel kind (K2 with its range kernel,
K3, K5, the library matrix products, the rest), the busy share (device
time over the least host time), the device activities and the RoPE table
builds of the profiled wave.  Prints one JSON line per case with the
card's name and power limit.  Exits non-zero
without a CUDA device.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from tools.profile_torch_decode import _kind as _decode_kind  # noqa: E402
from tools.torch_profile_common import card_line, device_time  # noqa: E402

PREFIX_LEN = 448
TAILS = [[16, 200, 64, 130], [40, 180, 100, 150]]
DENSE_LENS = [256, 250, 243, 255, 242, 248, 253, 246]
WAVES = 3
# (lane, prefix caching, engine keywords, the RoPE tables' memo)
CASES = [("packed", True, {}, True), ("packed", False, {}, True),
         ("chunked", True, {"packed": False, "prefill_chunk": 256}, True),
         ("chunked", False, {"packed": False, "prefill_chunk": 256}, True),
         ("batched", False, {"packed": False, "prefill_bucket": 256}, True),
         ("batched", False, {"packed": False, "prefill_bucket": 256}, False)]


def _kind(name: str) -> str:
    if "rope_kernel" in name:
        return "fused_rope (K5)"
    return _decode_kind(name)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--int8", action="store_true",
                    help="int8 weights over int8 KV pages")
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        sys.exit(1)
    import paddle_tpu_torch.models.llama_pretrain as tlp
    from paddle_tpu_torch.models.decode import quantize_params_int8
    from paddle_tpu_torch.models.llama_pretrain import (LlamaPretrainConfig,
                                                        init_params)
    from paddle_tpu_torch.models.paged_decode import PagedKVCache
    from paddle_tpu_torch.models.serving_engine import (
        ContinuousBatchingEngine)
    from paddle_tpu_torch.ops import rope as rp

    card = card_line()
    cfg = LlamaPretrainConfig()
    kv_quant = "int8" if args.int8 else None
    params = init_params(cfg, seed=args.seed)
    if args.int8:
        params = quantize_params_int8(params)
    rng = np.random.default_rng(args.seed)
    prefix = rng.integers(0, cfg.vocab_size, PREFIX_LEN)
    waves = [[np.concatenate([prefix, rng.integers(0, cfg.vocab_size, n)])
              for n in tails] for tails in TAILS]
    dense = [rng.integers(0, cfg.vocab_size, n) for n in DENSE_LENS]
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]

    def ready(lane, prefix_on, kw):
        """A fresh engine with the measured wave queued (the prefix
        layout's first wave already admitted and finished)."""
        cache = PagedKVCache(cfg, num_pages=256, pages_max=32, batch=8,
                             page=64, kv_quant=kv_quant)
        eng = ContinuousBatchingEngine(cfg, params, cache,
                                       enable_prefix_caching=prefix_on, **kw)
        if lane == "batched":
            measured = dense
        else:
            for p in waves[0]:
                eng.submit(p, max_new_tokens=1)
            eng.run_to_completion()
            measured = waves[1]
        for p in measured:
            eng.submit(p, max_new_tokens=1)
        torch.cuda.synchronize()
        return eng, cache

    builds = [0]

    def no_memo(s, d, theta, device=None):
        builds[0] += 1
        return rp.rope_tables(s, d, theta, device=device)

    for lane, prefix_on, kw, memo in CASES:
        tlp.cached_tables = rp.cached_tables if memo else no_memo
        host_ms = []
        for i in range(WAVES + 2):
            eng, cache = ready(lane, prefix_on, kw)
            c0 = (eng.prefill_calls, eng.prefill_token_slots,
                  cache.prefix_hits, rp.table_builds + builds[0])
            if i == WAVES + 1:
                with torch.profiler.profile(activities=acts) as prof:
                    eng._admit_wave()
                    torch.cuda.synchronize()
            else:
                t0 = time.perf_counter()
                eng._admit_wave()
                torch.cuda.synchronize()
                if i:
                    host_ms.append((time.perf_counter() - t0) * 1e3)
            wave = {"dispatches": eng.prefill_calls - c0[0],
                    "stream_slots": eng.prefill_token_slots - c0[1],
                    "prefix_hit_pages": cache.prefix_hits - c0[2],
                    "rope_table_builds": rp.table_builds + builds[0] - c0[3]}
            del eng, cache
            torch.cuda.empty_cache()
        busy, kinds, top = device_time(torch, prof, _kind, 1, 8)
        spans = [e for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        print(json.dumps({
            "card": card, "model": "LLaMA-7B (LlamaPretrainConfig defaults)",
            "weights_and_pages": "int8" if args.int8 else "bf16",
            "lane": lane, "prefix_caching": prefix_on, "engine_kw": kw,
            "rope_tables_memo": memo,
            **wave, "host_ms": host_ms, "host_ms_min": min(host_ms),
            "device_busy_ms": busy, "device_busy_share": busy / min(host_ms),
            "device_activities": len(spans), "ms_by_kind": kinds,
            "top_kernels": top}), flush=True)


if __name__ == "__main__":
    main()
