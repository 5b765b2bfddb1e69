#!/usr/bin/env python3
"""Time the port's redesigned kernels against an earlier checkout's, in
turns, in one process on one CUDA card: the paged decode kernels (K1 bf16
pages, K4 int8 pages), the flash-attention forward (K6a) and the fused
RMSNorm -> matmul (K11).

Run from the repository root:

    python3 tools/ab_torch_kernels.py --parent DIR [--reps 50]
                                      [--kernels K1,K4,K6a,K11]

DIR holds an earlier tree of the repository (``git archive <commit>``
unpacked into a directory that ``.gitignore`` lists, such as
``_checkout/parent``).  Its ``paddle_tpu_torch`` package is loaded under
another name, so its own wrappers build its own kernels into DIR's
``_build`` directory and both trees are called the way a user calls them.
Shapes are ``chip_smoke.py``'s: K1 / K4 at its table (B 8, 32 q heads over
nkv 32 and 8, d 128, page 64, lens ``K1_LENS``); K6a at ``TRAIN_SHAPES[0]``
causal; K11 at the gate / up, q and decode cases of ``K11_CASES``.  Each
wrapper is timed parent, new, new, parent under two timers:

- ``chip_smoke.time_ms`` as it is (CUDA events, median of ``--reps`` runs
  after a warm-up, L2 overwritten before each run).  The events also take
  in the wrapper's host time, and the timed run writes back the dirty L2
  lines the flush leaves;
- the card alone: the flush buffer read instead of written and a spin
  kernel queued before each run, so the card is still busy while the host
  queues the timed call.

The new call is also timed replayed from a CUDA graph (no host work between
the events), and each wrapper's host time per call is the mean of
``--reps`` calls queued back to back.  K6a and K11 also time their
yardstick under both timers, as ``chip_smoke.py`` names it (SDPA's
forward; cuBLAS on the normalised activation).  The two outputs (K6a:
out and lse) are held against each other at chip_smoke's tolerance.  Prints the card
and one JSON line per kernel and case; exits non-zero without a CUDA
device.
"""

import argparse
import functools
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


def parent_ops(root: Path, name: str):
    """The parent tree's ``paddle_tpu_torch.ops.<name>``, its package loaded
    as ``parent_paddle_tpu_torch`` so that it does not shadow this tree's."""
    if "parent_paddle_tpu_torch" not in sys.modules:
        pkg = root / "paddle_tpu_torch"
        spec = importlib.util.spec_from_file_location(
            "parent_paddle_tpu_torch", pkg / "__init__.py",
            submodule_search_locations=[str(pkg)])
        mod = importlib.util.module_from_spec(spec)
        sys.modules[spec.name] = mod
        spec.loader.exec_module(mod)
    return importlib.import_module(f"parent_paddle_tpu_torch.ops.{name}")


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


def compare(torch, cs, flush, reps, card, label, old, new, work, check,
            library=None, **fields):
    """Time ``old`` and ``new`` (calls of no arguments) in turns under both
    timers, ``check(out_new, out_old)`` their outputs, print one line.
    ``library``: one PyTorch call for the same function, timed after them
    under both timers as the yardstick."""
    out_old, out_new = old(), new()
    torch.cuda.synchronize()
    err = check(out_new, out_old)
    del out_old, out_new
    order = (old, new, new, old)
    smoke = [cs.time_ms(torch, f, flush, reps) for f in order]
    alone = [card_alone_ms(torch, f, flush, reps) for f in order]
    host = [host_us(torch, f, reps) for f in order]
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        new()
    graph_ms = cs.time_ms(torch, graph.replay, flush, reps)
    del graph
    lib = {}
    if library is not None:
        lib = {"library_ms": cs.time_ms(torch, library, flush, reps),
               "library_card_alone_ms": card_alone_ms(torch, library, flush,
                                                      reps)}
    b_ms, b_by = cs.bound(*work)
    new_ms, old_ms = min(smoke[1:3]), min(smoke[0], smoke[3])
    new_alone = min(alone[1:3])
    print(json.dumps({
        "kernel": label, **fields, "card": card,
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
        "new_vs_parent_max_abs": err, **lib}), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True, type=Path)
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--kernels", default="K1,K4,K6a,K11")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        sys.exit(1)
    import torch.nn.functional as F

    import chip_smoke as cs
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import paged_attention as pa
    from paddle_tpu_torch.ops import rmsnorm_matmul as rmm

    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line()
    print(card, flush=True)
    kernels = args.kernels.split(",")
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    flush = torch.empty(64 * 2**20, dtype=torch.int32, device="cuda")
    run = functools.partial(compare, torch, cs, flush, args.reps, card)
    for q8 in (False, True):
        if ("K4" if q8 else "K1") not in kernels:
            continue
        old_pa = parent_ops(args.parent, "paged_attention")
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

            name = "K4" if q8 else "K1"
            run(name, call(old_pa), call(pa), cs.paged_work(nkv, q8),
                lambda a, b: cs.check_close(f"{name} new vs parent", a, b),
                nkv=nkv, split=cs.split_of(torch, pa, nkv,
                                           cs.K1_SHAPE["pages_max"]))
            del q, kp, vp, pools
    if "K6a" in kernels:
        old_fa = parent_ops(args.parent, "flash_attention")
        shape = cs.TRAIN_SHAPES[0]
        q, k, v = (torch.randn(shape, generator=gen, device="cuda",
                               dtype=torch.bfloat16) for _ in range(3))
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        sdpa = functools.partial(F.scaled_dot_product_attention, qt, kt, vt,
                                 is_causal=True)
        run("K6a", lambda: old_fa._fwd_kernel(q, k, v, True),
            lambda: fa._fwd_kernel(q, k, v, True), cs.k6a_work(shape),
            lambda a, b: max(cs.check_close("K6a out new vs parent", a[0],
                                            b[0]),
                             cs.check_close("K6a lse new vs parent", a[1],
                                            b[1])),
            library=sdpa, shape=list(shape), causal=True)
        del q, k, v, qt, kt, vt, sdpa
    if "K11" in kernels:
        old_rmm = parent_ops(args.parent, "rmsnorm_matmul")
        eps = 1e-6
        for name, M, H, N, wldt in cs.K11_CASES:
            if name == "ragged":
                continue
            x = torch.randn((M, H), generator=gen, device="cuda",
                            dtype=torch.bfloat16)
            wl = (1 + 0.1 * torch.randn(H, generator=gen, device="cuda")).to(
                getattr(torch, wldt))
            w = (torch.randn((H, N), generator=gen, device="cuda")
                 * H ** -0.5).to(torch.bfloat16)
            xf = x.float()
            y = (xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
                 * wl.float()).to(torch.bfloat16)
            del xf
            run("K11", lambda: old_rmm._fwd(x, wl, w, eps),
                lambda: rmm._fwd(x, wl, w, eps),
                cs.k11_work(M, H, N, wl.element_size()),
                lambda a, b: cs.check_close(f"K11 {name} new vs parent", a,
                                            b),
                library=functools.partial(torch.matmul, y, w),
                case=name, M=M, H=H, N=N, wl=wldt)
            del x, wl, w, y


if __name__ == "__main__":
    main()
