#!/usr/bin/env python3
"""Where a pretraining step of the PyTorch port's LLaMA trainer spends its
time on one CUDA card.

Run from the repository root:

    python3 tools/profile_torch_train.py [--layers 24] [--batch 8]
                                         [--seq 2049] [--steps 3]
                                         [--remat-policy full] [--packed]
                                         [--flags A|B]

Builds the 1.345 B-parameter LLaMA of the JAX package's training bench
(vocab 32000, hidden 2048, FFN 5504, 24 layers, 16 heads of 128, bf16
compute over f32 master params, chunked loss head, random weights from
``--seed``), its AdamW state and ``make_train_step``, takes two warm-up steps
on one seeded batch, then:

* times ``--steps`` steps on the host clock, ending in a synchronize;
* profiles ``--steps`` more with ``torch.profiler`` and sums the device
  time of every CUDA kernel by name: the ported kernels (fused RoPE, flash
  attention forward / dq / dkv, segmented attention forward / dq / dkv,
  fused AdamW), the library matrix products, and the rest;
* times the loss head alone (forward and backward at the step's shape, CUDA
  events), whose kernels the breakdown above counts among the matrix
  products and the rest.

``--packed`` trains on packed rows instead: ``pack_documents``
(``paddle_tpu_torch/models/packing.py``, as chip_smoke) fills each row with
documents of 32-2049 tokens, and each step is
``forward_loss(params, tokens, segment_ids)``, its gradients and
``adamw_update`` (``packed_step``), through the segmented
attention kernels and the plain (masked) loss head, which is then the head
timed alone.

``--flags A`` turns on the trunk's ``FLAGS_pallas_rms_norm`` and
``FLAGS_pallas_swiglu`` (``paddle_tpu_torch/flags.py``: the rms_norm and
swiglu kernels, K9 and K10); ``--flags B`` adds
``FLAGS_pallas_rmsnorm_matmul`` (K11 for q / k / v and gate / up, with its
f32 backward in library products; that branch bypasses K9 at ln1 / ln2 and
K10), the sets of chip_smoke's ``train_fused``.

Prints one JSON line: the card (nvidia-smi name and power limit), the step
time, tokens per second, peak memory, the device busy share (kernel time
over step time) and the kernel breakdown.  Exits non-zero without a CUDA
device.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from tools.torch_profile_common import card_line, device_time  # noqa: E402


# chip_smoke's train_fused sets: A = K9 + K10, B = A + K11
FLAG_SETS = {"A": ("FLAGS_pallas_rms_norm", "FLAGS_pallas_swiglu"),
             "B": ("FLAGS_pallas_rms_norm", "FLAGS_pallas_swiglu",
                   "FLAGS_pallas_rmsnorm_matmul")}


def _kind(name: str) -> str:
    if "rope_kernel" in name:
        return "fused_rope (K5)"
    # K2: seg_fwd_kernel before the Hopper redesign, then the forward
    # template's segmented instance, flash_fwd_kernel<d, true>
    if "seg_fwd_kernel" in name or ("flash_fwd_kernel" in name
                                    and "true" in name):
        return "flash_attention_segmented fwd (K2)"
    # the per-tile range kernel, launched before K2 (and, in trees whose
    # backward kept ranges of its own height, before each layer's K7a /
    # K7b pair: one kernel name for both)
    if "seg_tile_ranges_kernel" in name:
        return "flash_attention_segmented tile ranges (K2, K7)"
    # K7a / K7b: seg_bwd_*_kernel before the Hopper redesign, then the
    # backward templates' segmented instances, flash_bwd_*_kernel<d, true>
    if "seg_bwd_dq_kernel" in name or ("flash_bwd_dq_kernel" in name
                                       and "true" in name):
        return "flash_attention_segmented bwd dq (K7a)"
    if "seg_bwd_dkv_kernel" in name or ("flash_bwd_dkv_kernel" in name
                                        and "true" in name):
        return "flash_attention_segmented bwd dk/dv (K7b)"
    if "flash_fwd_kernel" in name:
        return "flash_attention fwd (K6a)"
    if "flash_bwd_dq_kernel" in name:
        return "flash_attention bwd dq (K6b)"
    if "flash_bwd_dkv_kernel" in name:
        return "flash_attention bwd dk/dv (K6c)"
    if "adamw_kernel" in name:
        return "fused_adamw (K8)"
    if "rms_fwd_kernel" in name:
        return "rms_norm fwd (K9a)"
    if "rms_bwd_kernel" in name:
        return "rms_norm bwd (K9b)"
    if "swiglu_fwd_kernel" in name:
        return "swiglu fwd (K10a)"
    if "swiglu_bwd_kernel" in name:
        return "swiglu bwd (K10b)"
    if "rmsnorm_matmul_kernel" in name:
        return "rmsnorm_matmul (K11)"
    low = name.lower()
    if any(t in low for t in ("gemm", "gemv", "nvjet", "cutlass", "cublas",
                              "xmma")):
        return "matmul (cuBLAS)"
    return "other"


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layers", type=int, default=24)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=2049)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--remat-policy", default="full",
                    choices=["full", "flash"])
    ap.add_argument("--packed", action="store_true",
                    help="rows packed with documents, through segment ids")
    ap.add_argument("--flags", choices=sorted(FLAG_SETS),
                    help="turn the trunk's kernel flags of this set on")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        sys.exit(1)
    from paddle_tpu_torch.flags import set_flags
    from paddle_tpu_torch.models.llama_pretrain import (
        LlamaPretrainConfig, _packed_targets, _plain_loss, init_adamw_state,
        init_params, make_forward, make_train_step)
    from paddle_tpu_torch.models.packing import (
        documents, pack_documents, packed_step)
    from paddle_tpu_torch.ops.chunked_loss import (
        chunked_softmax_cross_entropy)

    card = card_line()
    set_flags({name: True for name in FLAG_SETS.get(args.flags, ())})
    cfg = LlamaPretrainConfig(
        vocab_size=32000, hidden_size=2048, intermediate_size=5504,
        num_hidden_layers=args.layers, num_attention_heads=16,
        max_seq_len=args.seq - 1, loss_chunks=4, remat=True,
        remat_policy=args.remat_policy)
    params = init_params(cfg, seed=args.seed, dtype=cfg.param_dtype)
    state = init_adamw_state(params)
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    tokens = torch.randint(0, cfg.vocab_size, (args.batch, args.seq),
                           generator=gen, device="cuda")
    packing = {}
    if args.packed:
        seg_np = pack_documents(args.seed, args.batch, args.seq)
        seg = torch.from_numpy(seg_np).cuda()
        valid = _packed_targets(seg)[1]
        packed = packed_step(make_forward(cfg), tokens, seg)
        packing = dict(documents=documents(seg_np),
                       valid_targets=int(valid.sum()))

        def step(params, state, tokens):
            return packed(params, state)
    else:
        step = make_train_step(cfg)
    for _ in range(2):                                   # warm-up, builds
        params, state, loss = step(params, state, tokens)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(args.steps):
        params, state, loss = step(params, state, tokens)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / args.steps * 1e3
    peak = torch.cuda.max_memory_allocated()

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(args.steps):
            params, state, loss = step(params, state, tokens)
        torch.cuda.synchronize()
    busy_ms, by_kind, top = device_time(torch, prof, _kind, args.steps, 14)

    x = torch.randn((args.batch, args.seq - 1, cfg.hidden_size),
                    generator=gen, device="cuda",
                    dtype=cfg.dtype).requires_grad_(True)
    w = params["lm_head"].detach().requires_grad_(True)
    head_ms = []
    for _ in range(args.steps + 1):                      # the first warms up
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        if args.packed:
            head = _plain_loss(x, w, tokens[:, 1:], cfg.dtype, valid)
        else:
            head = chunked_softmax_cross_entropy(x, w, tokens[:, 1:],
                                                 cfg.loss_chunks, cfg.dtype)
        torch.autograd.grad(head, (x, w))
        end.record()
        end.synchronize()
        head_ms.append(start.elapsed_time(end))
    print(json.dumps({
        "card": card,
        "model": f"LLaMA 1.345B bench config, {args.layers} layers",
        "batch": args.batch, "seq": args.seq, "steps": args.steps,
        "remat_policy": args.remat_policy, "packed": args.packed,
        "flags": list(FLAG_SETS.get(args.flags, ())),
        **packing, "loss": float(loss),
        "step_ms": step_ms,
        "tokens_per_s": args.batch * (args.seq - 1) / step_ms * 1e3,
        **({"valid_tokens_per_s": packing["valid_targets"] / step_ms * 1e3}
           if args.packed else {}),
        "peak_mem_gb": peak / 2**30,
        "device_busy_ms_per_step": busy_ms,
        "device_busy_share": busy_ms / step_ms if step_ms else None,
        "loss_head": "plain, masked" if args.packed else "chunked",
        "loss_head_fwd_bwd_ms": sorted(head_ms[1:])[len(head_ms[1:]) // 2],
        "per_step_ms_by_kind": by_kind,
        "top_kernels": top,
    }), flush=True)


if __name__ == "__main__":
    main()
