#!/usr/bin/env python3
"""Run chosen ``chip_smoke.py`` phases alone on one CUDA card, each timed.

Run from the repository root:

    python3 tools/chip_phases.py [serve_qos] [serve_qos_recipe]
                                 [serve_spec] [serve_spec_before]
                                 [serve_spec_int8] [serve_spec_int8_before]
                                 [serve_mixed] [serve_mixed_before]
                                 [serve_mixed_int8]
                                 [serve_mixed_int8_before] [serve_disagg]
                                 [serve_disagg_before] [api_fit]
                                 [api_resnet] [api_ops] [api_vision]
                                 [api_transformer] [api_varlen] [api_nn]
                                 [api_nn_before] [api_infer]
                                 [api_ops_before] [serve_swap]
                                 [serve_swap_before] [serve_remote]

Each phase prints its JSON line as in the whole script; a failed gate is
printed and the next phase still runs.  ``serve_qos`` runs at LLaMA-7B
(random weights from seed 0, the serving kernels built first) with the
script's depth; ``serve_qos_recipe`` runs it again with the recipe's
depth (32 new tokens a fleet request, the preemption arms' lows 20-34 and
highs 24), so the two times compare the cut in one process.
``serve_spec`` / ``serve_spec_int8`` (int8 weights over int8 pages) run at
the script's depth and ``..._before`` at the depth the script had before
its spec cut (SPEC_BEFORE: 64 new tokens a request, 32 in the logit
check, 5 profiled rounds), in one process; ``serve_mixed`` /
``serve_mixed_int8`` / ``serve_disagg`` likewise with MIXED_BEFORE (48 new
tokens a request where the script takes 32); ``serve_swap`` with
SWAP_BEFORE (96 new tokens a request where the script takes 72) and
``api_ops_before`` with OPS_BEFORE (2,048 rows where the script takes
1,024), ``api_nn_before`` with the nn sweep at op_sweep.NN_SIZES (4,096
rows and batch 8 where the script takes 1,024 and 2).  ``serve_remote``
builds every kernel the whole script builds first (its spawned agents
load the libraries the parent built), so that its time is the phase's.  The last line
is ``{"phase_s": {...}, "fails": [...], "card": ...}``; the exit code is 1
when a gate failed.  With no argument it runs serve_qos, serve_qos_recipe,
api_fit and api_resnet in that order (the serving phases first, so that
the card's libraries are up before the api phases are timed, as they are
in the whole script).
"""

import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke as cs  # noqa: E402

QOS_RECIPE = dict(QOS_NEW=32, QOS_LOW_NEWS=(20, 22, 24, 26, 28, 30, 32, 34),
                  QOS_HIGH_NEW=24)
SPEC_BEFORE = dict(SPEC_NEW=64, SPEC_CHECK_NEW=32, SPEC_DEVICE_REPS=5)
MIXED_BEFORE = dict(MIXED_NEW=48)
SWAP_BEFORE = dict(SWAP_NEW=96)
OPS_BEFORE = dict(rows=2048)
# the sources chip_smoke.main builds
ALL_SOURCES = ("paged_attention", "flash_varlen", "int8_matmul", "rope",
               "flash_attention", "fused_adamw", "flash_varlen_bwd",
               "rms_norm", "swiglu", "rmsnorm_matmul")


def main():
    import torch
    fails = []

    def record(msg):
        print("chip_smoke: FAILED:", msg, file=sys.stderr, flush=True)
        fails.append(msg)

    cs.fail = record
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card, flush=True)
    which = sys.argv[1:] or ["serve_qos", "serve_qos_recipe", "api_fit",
                             "api_resnet"]
    secs, qos, qparams = {}, None, None
    for name in which:
        t = time.perf_counter()
        if name == "api_fit":
            cs.phase_api_fit(torch, 0, card)
        elif name == "api_resnet":
            cs.phase_api_resnet(torch, 0, card)
        elif name == "api_ops":
            cs.phase_api_ops(torch, 0, card)
        elif name == "api_ops_before":
            cs.phase_api_ops(torch, 0, card, sizes=OPS_BEFORE)
        elif name == "api_vision":
            cs.phase_api_vision(torch, 0, card)
        elif name in ("api_transformer", "api_varlen", "api_nn",
                      "api_nn_before", "api_infer"):
            mods = api_kernels()
            t = time.perf_counter()
            if name == "api_transformer":
                cs.phase_api_transformer(torch, 0, mods, card)
            elif name == "api_varlen":
                cs.phase_api_varlen(torch, 0, mods, card)
            elif name == "api_infer":
                cs.phase_api_infer(torch, 0, mods, card)
            else:
                saved = cs.NN_SWEEP
                if name.endswith("_before"):
                    cs.NN_SWEEP = {}
                try:
                    cs.phase_api_nn(torch, 0, card)
                finally:
                    cs.NN_SWEEP = saved
        elif name.startswith(("serve_mixed", "serve_disagg")):
            if qos is None:
                qos = qos_setup(torch)
            cfg, seed, params, mods = qos
            kw = {}
            if "int8" in name:
                if qparams is None:
                    from paddle_tpu_torch.models.decode import \
                        quantize_params_int8
                    qparams = quantize_params_int8(params)
                params = qparams
                kw = dict(kv_quant="int8")
                if name.startswith("serve_mixed"):
                    kw["waves"] = cs.MIXED_INT8_WAVES
            run = cs.phase_serve_mixed if name.startswith("serve_mixed") \
                else cs.phase_serve_disagg
            saved = {k: getattr(cs, k) for k in MIXED_BEFORE}
            if name.endswith("_before"):
                for k, v in MIXED_BEFORE.items():
                    setattr(cs, k, v)
            torch.cuda.empty_cache()
            t = time.perf_counter()
            try:
                run(torch, cfg, seed, params, mods, **kw)
            finally:
                for k, v in saved.items():
                    setattr(cs, k, v)
        elif name in ("serve_swap", "serve_swap_before"):
            if qos is None:
                qos = qos_setup(torch)
            cfg, seed, params, mods = qos
            saved = {k: getattr(cs, k) for k in SWAP_BEFORE}
            if name.endswith("_before"):
                for k, v in SWAP_BEFORE.items():
                    setattr(cs, k, v)
            torch.cuda.empty_cache()
            t = time.perf_counter()
            try:
                cs.phase_serve_swap(torch, cfg, seed, params, mods)
            finally:
                for k, v in saved.items():
                    setattr(cs, k, v)
        elif name == "serve_remote":
            if qos is None:
                qos = qos_setup(torch)
            from paddle_tpu_torch.ops import _build
            _build.build(ALL_SOURCES)
            torch.cuda.empty_cache()
            t = time.perf_counter()
            cs.phase_serve_remote(torch, *qos, card=card)
        elif name.startswith("serve_spec"):
            if qos is None:
                qos = qos_setup(torch)
            cfg, seed, params, mods = qos
            kw = {}
            if "int8" in name:
                if qparams is None:
                    from paddle_tpu_torch.models.decode import \
                        quantize_params_int8
                    qparams = quantize_params_int8(params)
                params = qparams
                kw = dict(kv_quant="int8", arms=cs.SPEC_INT8_ARMS)
            saved = {k: getattr(cs, k) for k in SPEC_BEFORE}
            if name.endswith("_before"):
                for k, v in SPEC_BEFORE.items():
                    setattr(cs, k, v)
            torch.cuda.empty_cache()
            t = time.perf_counter()
            try:
                cs.phase_serve_spec(torch, cfg, seed, params, mods, **kw)
            finally:
                for k, v in saved.items():
                    setattr(cs, k, v)
        elif name in ("serve_qos", "serve_qos_recipe"):
            if qos is None:
                qos = qos_setup(torch)
            saved = {k: getattr(cs, k) for k in QOS_RECIPE}
            if name == "serve_qos_recipe":
                for k, v in QOS_RECIPE.items():
                    setattr(cs, k, v)
            torch.cuda.empty_cache()
            t = time.perf_counter()
            try:
                cs.phase_serve_qos(torch, *qos)
            finally:
                for k, v in saved.items():
                    setattr(cs, k, v)
        else:
            sys.exit(f"unknown phase {name}")
        secs[name] = time.perf_counter() - t
    print(json.dumps({"phase_s": secs, "fails": fails, "card": card}),
          flush=True)
    sys.exit(1 if fails else 0)


def _mods():
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import flash_varlen as fv
    from paddle_tpu_torch.ops import fused_adamw as aw
    from paddle_tpu_torch.ops import int8_matmul as im
    from paddle_tpu_torch.ops import paged_attention as pa
    from paddle_tpu_torch.ops import rms_norm as rn
    from paddle_tpu_torch.ops import rmsnorm_matmul as rmm
    from paddle_tpu_torch.ops import rope as rp
    from paddle_tpu_torch.ops import swiglu as sw
    return {"pa": pa, "fv": fv, "im": im, "rp": rp, "fa": fa, "aw": aw,
            "rn": rn, "sw": sw, "rmm": rmm}


def api_kernels():
    """The attention kernels the api phases reach, built (once a process:
    the build is skipped when the libraries exist) -> chip_smoke's mods."""
    from paddle_tpu_torch.ops import _build
    _build.build(["flash_varlen", "flash_varlen_bwd", "flash_attention"])
    return _mods()


def qos_setup(torch):
    """The serving kernels built and LLaMA-7B's weights -> serve_qos's
    (cfg, seed, params, mods)."""
    from paddle_tpu_torch.models.llama_pretrain import (LlamaPretrainConfig,
                                                        init_params)
    from paddle_tpu_torch.ops import _build
    _build.build(["paged_attention", "flash_varlen", "int8_matmul", "rope"])
    mods = _mods()
    cfg = LlamaPretrainConfig()
    return cfg, 0, init_params(cfg, seed=0, device="cuda"), mods


if __name__ == "__main__":
    main()
