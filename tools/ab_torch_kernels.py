#!/usr/bin/env python3
"""Time the port's redesigned kernels against an earlier checkout's, in
turns, in one process on one CUDA card: the paged decode kernels (K1 bf16
pages, K4 int8 pages), the segmented flash forward (K2), the int8 matmul
(K3) at a prefill wave and at decode, its decode path at every decode
shape of LLaMA-7B (K3dec), the flash-attention forward (K6a)
and backward (K6b dq, K6c dk / dv), the segmented backward (K7a dq, K7b dk /
dv), the RMSNorm forward and backward (K9a, K9b) and the fused RMSNorm ->
matmul (K11);
and, for this tree alone, K3's two paths (decode and wave) at the row
counts where one takes over from the other (K3route).

Run from the repository root:

    python3 tools/ab_torch_kernels.py --parent DIR [--reps 50]
        [--kernels K1,K4,K2,K3,K3dec,K3route,K6a,K6b,K6c,K7a,K7b,K9a,K9b,K11]

DIR holds an earlier tree of the repository (``git archive <commit>``
unpacked into a directory that ``.gitignore`` lists, such as
``_checkout/parent``).  Its ``paddle_tpu_torch`` package is loaded under
another name, so its own wrappers build its own kernels into DIR's
``_build`` directory and both trees are called the way a user calls them.
Shapes are ``chip_smoke.py``'s: K1 / K4 at its table (B 8, 32 q heads over
nkv 32 and 8, d 128, page 64, lens ``K1_LENS``); K2 at its packed stream
(T 2048, 32 q heads over nkv 32 and 8, d 128, causal, runs
``K2_SEGMENTS`` and a sentinel tail); K3 at w_gate (K 4096, N 11008) on a
2,048-row wave and at decode (M 8), and at chip_smoke's ragged wave
(1000, 4096, 1000: N % 16 != 0), K3dec at ``K3DEC_SHAPES`` (batch 8:
wq / wk / wv / wo, w_gate / w_up, w_down, lm_head; w_gate at batch 1 and
16), K3route at M 16, 32, 64 and 128 of the
same weight; K6a-c at
``TRAIN_SHAPES[0]`` causal (K6b and K6c both from this tree's forward
kernel's out and lse); K7a / K7b at ``K7_TIMED`` of ``K7_CASES`` (the
packed trainer's rows, GQA 32 over 8, one document a row), from this tree's
K2 out, lse and ranges, each tree's kernels on the per-tile ranges of its
own block height; K9a / K9b at ``K9_SHAPES`` bf16 (the trainer's rows, the
serving admission wave's and a decode step's); K11 at the gate / up, q and
decode cases of ``K11_CASES``.  Each
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
``--reps`` calls queued back to back.  K6a-c and K11 also time their
yardstick under both timers, as ``chip_smoke.py`` names it (SDPA's
forward; SDPA's whole backward, dq, dk and dv in one call, for K6b and
K6c alike, and with the block-diagonal mask for K7a and K7b; cuBLAS on the
normalised activation); one document a row, K7a and K7b also time K6b and
K6c on the same inputs under both timers; so do K2 (SDPA with the
block-diagonal mask), K3 and K3dec (cuBLAS on the weight dequantized
beforehand), K9a (``F.rms_norm``) and K9b (the autograd backward of
``F.rms_norm``).  The two outputs (K2, K6a: out and lse; K6c: dk and dv;
K9a: out and rstd; K9b: dx and dw) are held against each other at
chip_smoke's tolerance.  Prints the card, the floor of both timers (one
one-element fill), and one JSON line per kernel and case; exits non-zero
without a CUDA device.
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
# (M, K, N) of K3dec: LLaMA-7B's decode projections at batch 8 (wq / wk /
# wv / wo, w_gate / w_up, w_down, lm_head), then w_gate at batch 1 and 16
K3DEC_SHAPES = [(8, 4096, 4096), (8, 4096, 11008), (8, 11008, 4096),
                (8, 4096, 32000), (1, 4096, 11008), (16, 4096, 11008)]
# [n, h] of K9a / K9b: the trainer's rows, the serving admission wave's
# (8 prompts of 256 at LLaMA-7B's width) and a decode step's at batch 8
K9_SHAPES = [(16384, 2048), (2048, 4096), (8, 4096)]


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


def on_path(im, x, q8, s8, wave):
    """K3 on its wave path (``wave``) or its decode path, whatever M is: the
    crossover ``WAVE_MIN_M`` moved for the call and put back after it."""
    saved = im.WAVE_MIN_M
    im.WAVE_MIN_M = 0 if wave else x.shape[0]
    try:
        return im._kernel(x, q8, s8)
    finally:
        im.WAVE_MIN_M = saved


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
    ap.add_argument(
        "--kernels",
        default="K1,K4,K2,K3,K3dec,K3route,K6a,K6b,K6c,K7a,K7b,K9a,K9b,K11")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        sys.exit(1)
    import torch.nn.functional as F

    import chip_smoke as cs
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import flash_varlen as fv
    from paddle_tpu_torch.ops import int8_matmul as im
    from paddle_tpu_torch.ops import paged_attention as pa
    from paddle_tpu_torch.ops import rms_norm as rn
    from paddle_tpu_torch.ops import rmsnorm_matmul as rmm

    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line()
    print(card, flush=True)
    # what either timer reads for a kernel that does next to nothing: the
    # floor under every small call's time
    flush = torch.empty(64 * 2**20, dtype=torch.int32, device="cuda")
    tiny = torch.empty(1, device="cuda")
    print(json.dumps({"timer_floor": {
        "ms": cs.time_ms(torch, tiny.zero_, flush, args.reps),
        "card_alone_ms": card_alone_ms(torch, tiny.zero_, flush, args.reps),
        "card": card}}), flush=True)
    del tiny
    kernels = args.kernels.split(",")
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
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
    if "K2" in kernels:
        old_fv = parent_ops(args.parent, "flash_varlen")
        n, d, T = 32, 128, cs.K2_T
        seg_np, runs = cs.k2_segments()
        seg = torch.from_numpy(seg_np)[None].cuda()
        pos = torch.arange(T, device="cuda")
        vis = ((seg[0][:, None] == seg[0][None])
               & (pos[:, None] >= pos[None]))
        for nkv in (32, 8):
            q = torch.randn((1, T, n, d), generator=gen, device="cuda",
                            dtype=torch.bfloat16)
            k, v = (torch.randn((1, T, nkv, d), generator=gen, device="cuda",
                                dtype=torch.bfloat16) for _ in range(2))
            qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
            sdpa = functools.partial(F.scaled_dot_product_attention, qt, kt,
                                     vt, attn_mask=vis, enable_gqa=nkv != n)
            run("K2", lambda: old_fv._seg_fwd(q, k, v, seg, True),
                lambda: fv._seg_fwd(q, k, v, seg, True),
                cs.k2_work(T, n, nkv, d, runs),
                lambda a, b: max(cs.check_close("K2 out new vs parent", a[0],
                                                b[0]),
                                 cs.check_close("K2 lse new vs parent", a[1],
                                                b[1])),
                library=sdpa, T=T, n=n, nkv=nkv, d=d, segments=runs)
            del q, k, v, qt, kt, vt, sdpa
    if {"K3", "K3dec", "K3route"} & set(kernels):
        old_im = parent_ops(args.parent, "int8_matmul")
        K = 4096
        weights = {}

        def weight(N, K=K):
            # the int8 codes, their scales and cuBLAS's dequantized copy
            if (K, N) not in weights:
                w = torch.randn((K, N), generator=gen,
                                device="cuda") * K ** -0.5
                qd = im.quantize_int8(w)
                weights[K, N] = (qd["q"], qd["s"], (qd["q"].float()
                                                    * qd["s"]).to(
                                                        torch.bfloat16))
            return weights[K, N]

        for M, N in (((2048, 11008), (8, 11008), (1000, 1000))
                     if "K3" in kernels else ()):
            q8, s8, wd = weight(N)
            x = torch.randn((M, K), generator=gen, device="cuda",
                            dtype=torch.bfloat16)
            run("K3", lambda: old_im.int8_matmul(x, q8, s8),
                lambda: im.int8_matmul(x, q8, s8), cs.k3_work(M, K, N),
                lambda a, b: cs.check_close(f"K3 M={M} N={N} new vs parent",
                                            a, b),
                library=functools.partial(torch.matmul, x, wd),
                M=M, K=K, N=N, path="wave" if M > im.WAVE_MIN_M else "decode")
        for M, Kd, N in (K3DEC_SHAPES if "K3dec" in kernels else ()):
            q8, s8, wd = weight(N, Kd)
            x = torch.randn((M, Kd), generator=gen, device="cuda",
                            dtype=torch.bfloat16)
            run("K3dec", lambda: old_im.int8_matmul(x, q8, s8),
                lambda: im.int8_matmul(x, q8, s8), cs.k3_work(M, Kd, N),
                lambda a, b: cs.check_close(
                    f"K3dec M={M} K={Kd} N={N} new vs parent", a, b),
                library=functools.partial(torch.matmul, x, wd),
                M=M, K=Kd, N=N, splits=im._splits(
                    M, N, Kd, torch.cuda.get_device_properties(
                        0).multi_processor_count, False))
        for M in ((16, 32, 64, 128) if "K3route" in kernels else ()):
            # this tree's decode path against its wave path, in turns, each
            # forced by moving the crossover for the call
            q8, s8, wd = weight(11008)
            x = torch.randn((M, K), generator=gen, device="cuda",
                            dtype=torch.bfloat16)
            run("K3route", functools.partial(on_path, im, x, q8, s8, False),
                functools.partial(on_path, im, x, q8, s8, True),
                cs.k3_work(M, K, 11008),
                lambda a, b: cs.check_close(f"K3 M={M} wave vs decode", a, b),
                library=functools.partial(torch.matmul, x, wd),
                M=M, K=K, N=11008, parent_is="the decode path",
                new_is="the wave path", routed_to="wave"
                if M > im.WAVE_MIN_M else "decode")
        del weights
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
    if "K6b" in kernels or "K6c" in kernels:
        old_fa = parent_ops(args.parent, "flash_attention")
        shape = cs.TRAIN_SHAPES[0]
        q, k, v, do = (torch.randn(shape, generator=gen, device="cuda",
                                   dtype=torch.bfloat16) for _ in range(4))
        out, lse = fa._fwd_kernel(q, k, v, True)
        delta = fa._delta(do, out)
        bwd_args = (q, k, v, do, lse, delta, True)
        qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_(True)
                      for t in (q, k, v))
        lib_out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
        sdpa_bwd = functools.partial(torch.autograd.grad, lib_out,
                                     (qt, kt, vt), do.transpose(1, 2),
                                     retain_graph=True)
        work_b, work_c = cs.k6_bwd_work(shape)
        if "K6b" in kernels:
            run("K6b", lambda: old_fa._bwd_dq_kernel(*bwd_args),
                lambda: fa._bwd_dq_kernel(*bwd_args), work_b,
                lambda a, b: cs.check_close("K6b dq new vs parent", a, b),
                library=sdpa_bwd, shape=list(shape), causal=True)
        if "K6c" in kernels:
            run("K6c", lambda: old_fa._bwd_dkv_kernel(*bwd_args),
                lambda: fa._bwd_dkv_kernel(*bwd_args), work_c,
                lambda a, b: max(cs.check_close("K6c dk new vs parent", a[0],
                                                b[0]),
                                 cs.check_close("K6c dv new vs parent", a[1],
                                                b[1])),
                library=sdpa_bwd, shape=list(shape), causal=True)
        del q, k, v, do, out, lse, delta, bwd_args, qt, kt, vt, lib_out
        del sdpa_bwd
    if "K7a" in kernels or "K7b" in kernels:
        old_fv = parent_ops(args.parent, "flash_varlen")
        for name, B, T, n, nkv, d, causal, layout in cs.K7_CASES:
            if name not in cs.K7_TIMED:
                continue
            seg_np = cs.k7_segments(layout, B, T, args.seed)
            seg = torch.from_numpy(seg_np).cuda()
            q, do = (torch.randn((B, T, n, d), generator=gen, device="cuda",
                                 dtype=torch.bfloat16) for _ in range(2))
            k, v = (torch.randn((B, T, nkv, d), generator=gen, device="cuda",
                                dtype=torch.bfloat16) for _ in range(2))
            ranges = fv._tile_ranges(seg)
            out, lse = fv._seg_fwd(q, k, v, seg, causal, ranges)
            delta = fa._delta(do, out)
            new_args = (q, k, v, seg, do, lse, delta, ranges, causal)
            old_args = (q, k, v, seg, do, lse, delta,
                        old_fv._tile_ranges(seg), causal)
            qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_(True)
                          for t in (q, k, v))
            lib_out = F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=fv._seg_vis(seg, causal),
                enable_gqa=nkv != n)
            sdpa_bwd = functools.partial(torch.autograd.grad, lib_out,
                                         (qt, kt, vt), do.transpose(1, 2),
                                         retain_graph=True)
            works = cs.k7_work(seg_np, n, nkv, d, causal)
            shape = dict(case=name, B=B, T=T, n=n, nkv=nkv, d=d,
                         causal=causal, layout=layout)
            for label, old, new, dense, work, check in (
                    ("K7a", old_fv._seg_bwd_dq_kernel, fv._seg_bwd_dq_kernel,
                     fa._bwd_dq_kernel, works[0],
                     lambda a, b: cs.check_close("K7a dq new vs parent", a,
                                                 b)),
                    ("K7b", old_fv._seg_bwd_dkv_kernel,
                     fv._seg_bwd_dkv_kernel, fa._bwd_dkv_kernel, works[1],
                     lambda a, b: max(
                         cs.check_close("K7b dk new vs parent", a[0], b[0]),
                         cs.check_close("K7b dv new vs parent", a[1],
                                        b[1])))):
                if label not in kernels:
                    continue
                extra = {}
                if layout == "onedoc":
                    # K6b / K6c on the same inputs: the same work, dense
                    call = functools.partial(dense, q, k, v, do, lse, delta,
                                             causal)
                    extra = {"dense_ms": cs.time_ms(torch, call, flush,
                                                    args.reps),
                             "dense_card_alone_ms": card_alone_ms(
                                 torch, call, flush, args.reps)}
                run(label, functools.partial(old, *old_args),
                    functools.partial(new, *new_args), work, check,
                    library=sdpa_bwd, **shape, **extra)
            del q, k, v, do, out, lse, delta, qt, kt, vt, lib_out, sdpa_bwd
            del new_args, old_args, ranges
    if "K9a" in kernels or "K9b" in kernels:
        old_rn = parent_ops(args.parent, "rms_norm")
        eps = 1e-6
        for n, h in K9_SHAPES:
            x, do = (torch.randn((n, h), generator=gen, device="cuda",
                                 dtype=torch.bfloat16) for _ in range(2))
            w = (1 + 0.1 * torch.randn(h, generator=gen, device="cuda")).to(
                torch.bfloat16)
            rstd = rn._fwd(x, w, eps)[1]
            work_a, work_b = cs.k9_work(n, h, 2, 2, 2)
            if "K9a" in kernels:
                run("K9a", lambda: old_rn._fwd(x, w, eps),
                    lambda: rn._fwd(x, w, eps),
                    (*work_a, cs.PEAK_F32_FLOPS),
                    lambda a, b: max(
                        cs.check_close(f"K9a [{n}, {h}] new vs parent", a[0],
                                       b[0]),
                        cs.check_close(f"K9a rstd [{n}, {h}] new vs parent",
                                       a[1], b[1])),
                    library=functools.partial(F.rms_norm, x, (h,), w, eps),
                    rows=n, h=h)
            if "K9b" in kernels:
                xr, wr = (t.detach().requires_grad_(True) for t in (x, w))
                lib_out = F.rms_norm(xr, (h,), wr, eps)
                run("K9b", lambda: old_rn._bwd(x, w, rstd, do),
                    lambda: rn._bwd(x, w, rstd, do),
                    (*work_b, cs.PEAK_F32_FLOPS),
                    lambda a, b: max(
                        cs.check_close(f"K9b dx [{n}, {h}] new vs parent",
                                       a[0], b[0]),
                        cs.check_close(f"K9b dw [{n}, {h}] new vs parent",
                                       a[1], b[1])),
                    library=functools.partial(
                        torch.autograd.grad, lib_out, (xr, wr), do,
                        retain_graph=True), rows=n, h=h)
                del xr, wr, lib_out
            del x, do, w, rstd
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
