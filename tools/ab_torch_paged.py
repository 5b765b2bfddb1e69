#!/usr/bin/env python3
"""Time the port's paged decode kernels (K1 bf16 pages, K4 int8 pages)
against an earlier checkout's, in turns, in one process on one CUDA card.

Run from the repository root:

    python3 tools/ab_torch_paged.py --parent DIR [--reps 50]

DIR holds an earlier tree of the repository (``git archive <commit>``
unpacked into a directory that ``.gitignore`` lists, such as
``_checkout/parent``).  Its ``paddle_tpu_torch`` package is loaded under
another name, so its own wrappers build its own kernel into DIR's
``_build`` directory and both trees are called the way a user calls them.
At ``chip_smoke.py``'s table shape (B 8, 32 q heads over nkv 32 and 8,
d 128, page 64, lens ``K1_LENS``) each wrapper is timed parent, new, new,
parent under two timers:

- ``chip_smoke.time_ms`` as it is (CUDA events, median of ``--reps`` runs
  after a warm-up, L2 overwritten before each run).  The events also take
  in the wrapper's host time, and the timed run writes back the dirty L2
  lines the flush leaves;
- the card alone: the flush buffer read instead of written and a spin
  kernel queued before each run, so the card is still busy while the host
  queues the timed call.

The new call is also timed replayed from a CUDA graph (no host work between
the events), and each wrapper's host time per call is the mean of
``--reps`` calls queued back to back.  The two outputs are held against
each other at chip_smoke's tolerance.  Prints the card and one JSON line
per kernel and nkv; exits non-zero without a CUDA device.
"""

import argparse
import importlib.util
import json
import os
import statistics
import sys
import time
from pathlib import Path

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from tools.torch_profile_common import card_line  # noqa: E402

# cycles of the spin kernel queued before a run of the card-alone timer
# (about half a millisecond, longer than the wrapper's host time)
SPIN_CYCLES = 1_000_000


def parent_ops(root: Path):
    """The parent tree's ``paddle_tpu_torch.ops.paged_attention``, loaded
    as ``parent_paddle_tpu_torch`` so that it does not shadow this tree's."""
    pkg = root / "paddle_tpu_torch"
    spec = importlib.util.spec_from_file_location(
        "parent_paddle_tpu_torch", pkg / "__init__.py",
        submodule_search_locations=[str(pkg)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return importlib.import_module("parent_paddle_tpu_torch.ops."
                                   "paged_attention")


def card_alone_ms(torch, fn, flush, reps):
    """Median CUDA-event time of ``fn`` with ``flush`` read and a spin
    kernel queued before each run: the card's time, not the host's."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        flush.sum()
        torch.cuda._sleep(SPIN_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def host_us(torch, fn, reps):
    """Mean host time of one call of ``fn``, ``reps`` calls queued back to
    back."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / reps * 1e6


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True, type=Path)
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        sys.exit(1)
    import chip_smoke as cs
    from paddle_tpu_torch.ops import paged_attention as pa

    card = card_line()
    print(card, flush=True)
    old_pa = parent_ops(args.parent)
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    flush = torch.empty(64 * 2**20, dtype=torch.int32, device="cuda")
    reps = args.reps
    for q8 in (False, True):
        for nkv in (32, 8):
            q, kp, vp, tables, lens = cs.paged_case(torch, nkv, gen)
            if q8:
                kq, ks = pa.quantize_kv_token(kp)
                vq, vs = pa.quantize_kv_token(vp)
                pools = (kq, vq, ks, vs)
            else:
                pools = (kp, vp)

            def call(mod):
                fn = (mod.paged_decode_attention_q8 if q8
                      else mod.paged_decode_attention)
                return lambda: fn(q, *pools, tables, lens)

            old, new = call(old_pa), call(pa)
            out_old, out_new = old(), new()
            torch.cuda.synchronize()
            err = cs.check_close(f"{'K4' if q8 else 'K1'} new vs parent",
                                 out_new, out_old)
            order = (old, new, new, old)
            smoke = [cs.time_ms(torch, f, flush, reps) for f in order]
            alone = [card_alone_ms(torch, f, flush, reps) for f in order]
            host = [host_us(torch, f, reps) for f in order]
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                new()
            graph_ms = cs.time_ms(torch, graph.replay, flush, reps)
            b_ms, b_by = cs.bound(*cs.paged_work(nkv, q8))
            new_ms, old_ms = min(smoke[1:3]), min(smoke[0], smoke[3])
            new_alone = min(alone[1:3])
            print(json.dumps({
                "kernel": "K4" if q8 else "K1", "nkv": nkv, "card": card,
                "split": cs.split_of(torch, pa, nkv,
                                     cs.K1_SHAPE["pages_max"]),
                "parent_ms": [smoke[0], smoke[3]],
                "new_ms": [smoke[1], smoke[2]],
                "parent_card_alone_ms": [alone[0], alone[3]],
                "new_card_alone_ms": [alone[1], alone[2]],
                "parent_host_us": [host[0], host[3]],
                "new_host_us": [host[1], host[2]],
                "new_graph_ms": graph_ms,
                "speedup": old_ms / new_ms,
                "speedup_card_alone": min(alone[0], alone[3]) / new_alone,
                "bound_ms": b_ms, "bound_by": b_by,
                "share_of_bound": b_ms / new_ms,
                "share_of_bound_card_alone": b_ms / new_alone,
                "new_vs_parent_max_abs": err}), flush=True)


if __name__ == "__main__":
    main()
