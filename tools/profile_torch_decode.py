#!/usr/bin/env python3
"""Where a decode step of the PyTorch port's LLaMA-7B serving path spends
its time on one CUDA card.

Run from the repository root:

    python3 tools/profile_torch_decode.py [--batch 8] [--ctx 1024] [--steps 8]

Builds LLaMA-7B (full width and depth, random weights from ``--seed``) and
the port's engine, admits ``--batch`` prompts of ``--ctx`` tokens in one
packed wave, then:

* times ``--steps`` decode steps on the host clock, each ending in the
  engine's own blocking fetch (the step time a client sees per token);
* profiles ``--steps`` more with ``torch.profiler`` and sums the device
  time of every CUDA kernel by name: the two ported kernels, the matrix
  products, and the rest.

Prints one JSON line: the card (nvidia-smi name and power limit), the step
time, the device busy share (kernel time over step time) and the kernel
breakdown.  Exits non-zero without a CUDA device.
"""

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _kind(name: str) -> str:
    if "paged_decode_kernel" in name:
        return "paged_decode_attention (K1)"
    if "seg_fwd_kernel" in name:
        return "flash_attention_segmented (K2)"
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
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        sys.exit(1)
    from paddle_tpu_torch.models.llama_pretrain import (LlamaPretrainConfig,
                                                        init_params)
    from paddle_tpu_torch.models.paged_decode import PagedKVCache
    from paddle_tpu_torch.models.serving_engine import (
        ContinuousBatchingEngine)

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    cfg = LlamaPretrainConfig()
    page = 64
    new = 2 * args.steps + 4
    pages_max = -(-(args.ctx + new) // page)
    cache = PagedKVCache(cfg, num_pages=1 + args.batch * pages_max,
                         pages_max=pages_max, batch=args.batch, page=page)
    params = init_params(cfg, seed=args.seed)
    eng = ContinuousBatchingEngine(cfg, params, cache)
    rng = np.random.default_rng(args.seed)
    for _ in range(args.batch):
        eng.submit(rng.integers(0, cfg.vocab_size, args.ctx),
                   max_new_tokens=new)
    eng.step()                       # admission wave + first decode step
    eng.step()                       # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(args.steps):
        eng.step()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / args.steps * 1e3

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(args.steps):
            eng.step()
        torch.cuda.synchronize()
    per_name, per_kind = {}, {}
    for evt in prof.events():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = evt.time_range.elapsed_us()
        n, c = per_name.get(evt.name, (0.0, 0))
        per_name[evt.name] = (n + us, c + 1)
        k = _kind(evt.name)
        per_kind[k] = per_kind.get(k, 0.0) + us
    busy_ms = sum(per_kind.values()) / 1e3 / args.steps
    top = sorted(per_name.items(), key=lambda kv: -kv[1][0])[:12]
    print(json.dumps({
        "card": card, "model": "LLaMA-7B (LlamaPretrainConfig defaults)",
        "batch": args.batch, "ctx": args.ctx, "steps": args.steps,
        "step_ms": step_ms, "device_busy_ms_per_step": busy_ms,
        "device_busy_share": busy_ms / step_ms if step_ms else None,
        "per_step_ms_by_kind": {k: v / 1e3 / args.steps
                                for k, v in sorted(per_kind.items(),
                                                   key=lambda kv: -kv[1])},
        "top_kernels": [{"name": name[:120],
                         "ms_per_step": t / 1e3 / args.steps,
                         "launches_per_step": c / args.steps}
                        for name, (t, c) in top],
    }), flush=True)


if __name__ == "__main__":
    main()
