"""Paged-KV decode attention: the CUDA kernel's wrapper and its plain version.

Counterpart of ``paddle_tpu/ops/pallas/paged_attention.py``:
:func:`paged_decode_attention` (bf16 pages) and
:func:`paged_decode_attention_q8` (int8 pages with per-slot f32 scales)
replace the two Pallas kernels with the hand-written Hopper kernel in
``csrc/paged_attention.cu``; :func:`paged_decode_attention_plain` and
:func:`paged_decode_attention_q8_plain` mirror ``paged_decode_attention_xla``
and ``paged_decode_attention_q8_xla``; :func:`quantize_kv_token` is a copy
of the JAX function of that name.  :func:`split_plan` is the kernel's split
of each row's pages over blocks, from the shapes alone, and
:func:`paged_decode_attention_split_plain` the kernel's two-pass arithmetic
(per-split softmax partials, then their log-sum-exp merge) in plain PyTorch,
so the CPU tests reach both; the wrappers never call the mirror.

A tensor on the CPU goes to the plain version; a CUDA tensor goes to the
kernel, or the wrapper raises.  There is no quiet fallback from one to the
other.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from ..models.decode import _grouped_attn
from . import _build

__all__ = ["paged_decode_attention", "paged_decode_attention_plain",
           "paged_decode_attention_q8", "paged_decode_attention_q8_plain",
           "paged_decode_attention_split_plain", "split_plan",
           "quantize_kv_token", "launches", "launches_q8"]

# calls of paged_decode_attention and of paged_decode_attention_q8 that
# launched the kernel (its split pass, and its combine where the plan has
# more than one split): one per attention, so a run can show that its main
# path went through the kernels
launches = 0
launches_q8 = 0

_MAX_GROUP = 16            # q heads per kv head the kernel holds
_NEG = -1e30               # the kernel's masked logit (NEG_INF in JAX)
_MAX_SMEM = 227 * 1024     # dynamic shared memory a Hopper block may use


def paged_decode_attention_plain(q, kpool, vpool, block_tables,
                                 context_lens, sm_scale=None):
    """Gather each row's pages and run masked attention in fp32.

    q [B, n, d]; kpool / vpool [num_pages, nkv, page, d]; block_tables
    [B, pages_max] int; context_lens [B] int -> [B, n, d] in q's dtype.
    Counterpart of ``paged_decode_attention_xla``; like it, a row with
    ``len == 0`` averages its (junk) pages instead of writing zeros."""
    B, n, d = q.shape
    num_pages, nkv, page, _ = kpool.shape
    pages_max = block_tables.shape[1]
    S = pages_max * page
    tables = block_tables.long()
    # [B, pages_max, nkv, page, d] -> [B, S, nkv, d]
    kg = kpool[tables].permute(0, 1, 3, 2, 4).reshape(B, S, nkv, d)
    vg = vpool[tables].permute(0, 1, 3, 2, 4).reshape(B, S, nkv, d)
    valid = (torch.arange(S, device=q.device)[None]
             < context_lens.to(q.device).long()[:, None])
    mask = valid[:, None, None, None, :]          # [B, 1, 1, 1, S]
    qf = q.float()[:, None]
    if sm_scale is not None:
        # _grouped_attn scales by 1/sqrt(d); fold the ratio into q
        qf = qf * (sm_scale * math.sqrt(d))
    out = _grouped_attn(qf, kg.float(), vg.float(), mask)
    return out[:, 0].to(q.dtype)


def quantize_kv_token(k):
    """Per-(row, head) symmetric int8 quantization of K or V ``[..., d]``
    -> (int8 ``[..., d]``, f32 scale ``[...]``): absmax / 127 over d, a
    zero vector gets scale 1, round half to even, clip to ±127."""
    kf = k.float()
    s = kf.abs().amax(dim=-1) / 127.0
    s = torch.where(s == 0, torch.ones_like(s), s)
    q = torch.clamp(torch.round(kf / s[..., None]), -127, 127)
    return q.to(torch.int8), s


def paged_decode_attention_q8_plain(q, kpool, vpool, kscale, vscale,
                                    block_tables, context_lens,
                                    sm_scale=None):
    """Dequantize each row's gathered int8 pages to q's dtype and run
    :func:`paged_decode_attention_plain` over them.  kpool / vpool
    [num_pages, nkv, page, d] int8, kscale / vscale [num_pages, nkv, page]
    f32.  Counterpart of ``paged_decode_attention_q8_xla``."""
    tables = block_tables.long()
    kg = (kpool[tables].float() * kscale[tables][..., None]).to(q.dtype)
    vg = (vpool[tables].float() * vscale[tables][..., None]).to(q.dtype)
    B, pm, nkv, page, d = kg.shape
    # re-pack as pools indexed by identity tables
    ident = torch.arange(B * pm, dtype=torch.int32,
                         device=q.device).reshape(B, pm)
    return paged_decode_attention_plain(
        q, kg.reshape(B * pm, nkv, page, d), vg.reshape(B * pm, nkv, page, d),
        ident, context_lens, sm_scale)


def split_plan(B, nkv, g, pages_max, page, sm_count):
    """The kernel's split of a row's pages over blocks -> ``(S, P_s)``:
    ``S`` blocks a (row, kv head), each over ``P_s`` pages, with
    ``S * P_s >= pages_max > (S - 1) * P_s``.

    ``P_s`` is the whole pages of 256 tokens, or of 128 when a kv head
    serves ``g > 1`` query heads (a block's work per token grows with its
    group: on an H100 the table shape of ``chip_smoke.py`` ran fastest at
    these sizes), halved while the grid would hold fewer than two blocks
    an SM.  Shapes and the SM count only: a row's length
    lives on the card, so reading it would be a sync and would keep the
    call out of a CUDA graph.  ``S == 1`` when one split covers the
    table."""
    pages_max = max(int(pages_max), 1)
    tokens = 256 if g <= 1 else 128
    ps = min(max(1, tokens // page), pages_max)
    while ps > 1 and B * nkv * -(-pages_max // ps) < 2 * sm_count:
        ps = -(-ps // 2)
    return -(-pages_max // ps), ps


def paged_decode_attention_split_plain(q, kpool, vpool, block_tables,
                                       context_lens, sm_scale=None,
                                       split_pages=1, kscale=None,
                                       vscale=None):
    """The kernel's two passes in fp32 plain PyTorch.

    Each run of ``split_pages`` pages of a row gives its softmax partials
    ``m`` (max logit), ``l`` (sum of exp) and ``acc`` (exp-weighted V sum);
    the splits that hold a key merge by the log-sum-exp rule, in split
    order.  Arguments as :func:`paged_decode_attention`; with ``kscale`` /
    ``vscale`` [num_pages, nkv, page] the pools are int8 codes and the
    scales fold into the logits and the probabilities as the kernel's do.
    A row with ``len == 0`` writes zeros, as the kernel's does."""
    B, n, d = q.shape
    _, nkv, page, _ = kpool.shape
    pages_max = block_tables.shape[1]
    g = n // nkv
    scale = sm_scale or (1.0 / math.sqrt(d))
    span = split_pages * page
    S = -(-pages_max // split_pages)
    T = S * span
    tables = block_tables.long()
    pad = S * split_pages - pages_max
    if pad:                      # pages past the table: masked, never used
        tables = torch.cat([tables, tables.new_zeros(B, pad)], 1)

    def gather(pool):            # -> [B, nkv, T, ...]
        x = pool[tables].float()                  # [B, S*P_s, nkv, page, ..]
        x = x.transpose(1, 2)                     # [B, nkv, S*P_s, page, ..]
        return x.reshape(B, nkv, T, *pool.shape[3:])

    kg, vg = gather(kpool), gather(vpool)
    qg = q.float().reshape(B, nkv, g, d)
    s = torch.einsum("bkgd,bktd->bkgt", qg, kg) * scale
    if kscale is not None:
        s = s * gather(kscale)[:, :, None]
    lens = context_lens.to(q.device).long().clamp(0, pages_max * page)
    valid = (torch.arange(T, device=q.device)[None] < lens[:, None])
    valid = valid[:, None, None].expand_as(s)
    # per split: m, l, acc; masked logits at the kernel's -1e30, so a split
    # with no key gets m = -1e30 and weighs nothing in the merge
    s = torch.where(valid, s, _NEG).reshape(B, nkv, g, S, span)
    m = s.amax(-1)
    p = torch.where(valid.reshape(s.shape), torch.exp(s - m[..., None]), 0.)
    l = p.sum(-1)
    if vscale is not None:
        p = p * gather(vscale).reshape(B, nkv, 1, S, span)
    acc = torch.einsum("bkgst,bkstd->bkgsd", p,
                       vg.reshape(B, nkv, S, span, d))
    # merge: weights 2^(m_s - max m) in the kernel, e^ here
    w = torch.exp(m - m.amax(-1, keepdim=True))
    L = (l * w).sum(-1, keepdim=True)
    o = (acc * w[..., None]).sum(-2)
    o = torch.where(L > 0, o / L.clamp_min(1e-30), 0.)   # len 0: zeros
    return o.reshape(B, n, d).to(q.dtype)


@functools.lru_cache(maxsize=None)
def _kernel_fn(q8: bool = False):
    """The launcher, looked up and typed once per process."""
    lib = _build.library("paged_attention")
    if q8:
        fn = lib.paged_decode_attention_q8
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 8 + [
            ctypes.c_float, ctypes.c_void_p]
    else:
        fn = lib.paged_decode_attention_bf16
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8 + [
            ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _sm_count(index) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=None)
def _plan(B, nkv, g, pages_max, page, index):
    return split_plan(B, nkv, g, pages_max, page, _sm_count(index))


def _launch(q8, q, pools, block_tables, context_lens, sm_scale):
    """Run the kernel on ``pools`` (kpool, vpool[, kscale, vscale]) on the
    current stream -> out.  The split partials go to a workspace taken
    with ``torch.empty`` where the plan has more than one split."""
    B, n, d = q.shape
    _, nkv, page, _ = pools[0].shape
    pages_max = block_tables.shape[1]
    S, ps = _plan(B, nkv, n // nkv, pages_max, page, q.device.index)
    if _smem_bytes(n, nkv, d, ps, q8) > _MAX_SMEM:
        raise ValueError(f"d {d} with a group of {n // nkv} needs more "
                         f"shared memory than a block has")
    scale = sm_scale or (1.0 / math.sqrt(d))
    out = torch.empty_like(q)
    # held until the launch is queued, so no allocation can take it first
    part = (torch.empty(B * n * S * (d + 2), dtype=torch.float32,
                        device=q.device) if S > 1 else None)
    err = _kernel_fn(q8)(
        q.data_ptr(), *(t.data_ptr() for t in pools),
        block_tables.data_ptr(), context_lens.data_ptr(), out.data_ptr(),
        None if part is None else part.data_ptr(), B, n, nkv, d, page,
        pages_max, S, ps, scale,
        torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        name = "paged_decode_attention_q8" if q8 else "paged_decode_attention"
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")
    return out


@functools.lru_cache(maxsize=None)
def _smem_bytes(n, nkv, d, split_pages, q8) -> int:
    fn = _build.library("paged_attention").paged_decode_attention_smem_bytes
    fn.argtypes = [ctypes.c_int] * 5
    fn.restype = ctypes.c_longlong
    return int(fn(n, nkv, d, split_pages, int(q8)))


def _check(q, kpool, vpool, block_tables, context_lens, scales=None):
    """Shapes, types, devices and contiguity the kernel takes; ``scales``
    is ``(kscale, vscale)`` for int8 pages."""
    q8 = scales is not None
    if q.dim() != 3 or kpool.dim() != 4 or kpool.shape != vpool.shape:
        raise ValueError(
            f"want q [B, n, d] and pools [P, nkv, page, d], got "
            f"{tuple(q.shape)}, {tuple(kpool.shape)}, {tuple(vpool.shape)}")
    B, n, d = q.shape
    P, nkv, page, dk = kpool.shape
    align = 16 if q8 else 8           # elements of one 16-byte load
    if dk != d or n % nkv or n // nkv > _MAX_GROUP or d % align or d > 256:
        raise ValueError(
            f"kernel takes n % nkv == 0, n / nkv <= {_MAX_GROUP}, "
            f"d % {align} == 0 and d <= 256; got n={n} nkv={nkv} d={d} "
            f"(pool d={dk})")
    if block_tables.shape[0] != B or context_lens.shape != (B,):
        raise ValueError("block_tables [B, pages_max] / context_lens [B] "
                         "do not match q's batch")
    pool_dt = torch.int8 if q8 else torch.bfloat16
    named = [("q", q, torch.bfloat16), ("kpool", kpool, pool_dt),
             ("vpool", vpool, pool_dt),
             ("block_tables", block_tables, torch.int32),
             ("context_lens", context_lens, torch.int32)]
    if q8:
        for name, t in zip(("kscale", "vscale"), scales):
            if t.shape != (P, nkv, page):
                raise ValueError(f"{name} {tuple(t.shape)} != pool's "
                                 f"[P, nkv, page] {(P, nkv, page)}")
            named.append((name, t, torch.float32))
    for name, t, dt in named:
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype != dt:
            raise TypeError(f"{name} must be {dt}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def paged_decode_attention(q, kpool, vpool, block_tables, context_lens,
                           sm_scale=None):
    """One decode step of attention against a paged KV cache.

    q:             [B, n, d]        (single new token per row)
    kpool/vpool:   [num_pages, nkv, page, d]
    block_tables:  [B, pages_max] int32 (entries past the row's length
                   point at the junk page 0 and are skipped)
    context_lens:  [B] int32 (valid kv entries per row, including the
                   current token, whose k/v must already be written)
    -> [B, n, d]
    """
    if q.device.type == "cpu":
        return paged_decode_attention_plain(q, kpool, vpool, block_tables,
                                            context_lens, sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"no paged decode attention for {q.device}")
    _check(q, kpool, vpool, block_tables, context_lens)
    global launches
    out = _launch(False, q, (kpool, vpool), block_tables, context_lens,
                  sm_scale)
    launches += 1
    return out


def paged_decode_attention_q8(q, kpool, vpool, kscale, vscale, block_tables,
                              context_lens, sm_scale=None):
    """:func:`paged_decode_attention` over int8 pages.

    kpool/vpool:    [num_pages, nkv, page, d] int8
    kscale/vscale:  [num_pages, nkv, page] f32 (one scale per head x slot)
    Other arguments and the result as :func:`paged_decode_attention`; on
    the card d must be a multiple of 16 as well.
    """
    if q.device.type == "cpu":
        return paged_decode_attention_q8_plain(
            q, kpool, vpool, kscale, vscale, block_tables, context_lens,
            sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"no paged decode attention for {q.device}")
    _check(q, kpool, vpool, block_tables, context_lens, (kscale, vscale))
    global launches_q8
    out = _launch(True, q, (kpool, vpool, kscale, vscale), block_tables,
                  context_lens, sm_scale)
    launches_q8 += 1
    return out
