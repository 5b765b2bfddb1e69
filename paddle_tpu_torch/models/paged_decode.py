"""Paged-KV-cache decoding: the page allocator, the per-token decode step and
the packed varlen prefill.

Counterpart of ``paddle_tpu/models/paged_decode.py`` for the serving lane
on one device, with bf16 / fp32 pages or int8 pages (``kv_quant="int8"``):
:class:`PagedKVCache` (free list, row alloc / growth / release, the batched
page write, ``audit``), :func:`_rope_rows`, :func:`_rope_at`,
:func:`_pick_token`, :func:`_decode_layer`, :func:`make_paged_decode_step`
(``step`` and ``step_q8``, optionally returning the logits) and
:func:`_packed_prefill_body` (fp and ``q8`` forms, without history).

PyTorch runs eagerly, so the JAX jit wrappers and their memo caches have no
counterpart, and the pools update in place instead of being donated.  The
prefix index, the host page tier, swap and export and TP meshes are later
slices; asking for them raises ``NotImplementedError``.
"""

from __future__ import annotations

import math
from collections import Counter
from typing import Optional

import numpy as np
import torch

from .._device import resolve_device
from ..ops.flash_varlen import flash_attention_segmented
from ..ops.paged_attention import (paged_decode_attention,
                                   paged_decode_attention_q8,
                                   quantize_kv_token)
from .llama_pretrain import (LlamaPretrainConfig, _block_post_attn, _mm,
                             _rms_norm, layer_params)

__all__ = ["PagedKVCache", "make_paged_decode_step"]


class PagedKVCache:
    """Free-list page allocator + device page pools for all layers.

    Pools: ``[L, num_pages, nkv, page, d]`` tensors on ``device`` (CUDA
    unless asked otherwise).  With ``kv_quant="int8"`` the pools are int8
    and ``kscale`` / ``vscale`` ``[L, num_pages, nkv, page]`` f32 hold one
    scale per (page, head, slot); otherwise both are ``None``.  Page 0 is
    reserved as the junk page unused table slots point at; the kernels
    never read it."""

    def __init__(self, cfg: LlamaPretrainConfig, num_pages: int,
                 pages_max: int, batch: int, page: int = 64,
                 dtype=None, kv_quant: Optional[str] = None,
                 mesh=None, host_pages: int = 0, device=None):
        if kv_quant not in (None, "int8"):
            raise ValueError("kv_quant must be None or 'int8'")
        if mesh is not None:
            raise NotImplementedError(
                "kv-head-sharded pools (TP meshes) are not ported yet")
        if host_pages:
            raise NotImplementedError(
                "the host page tier (swap, prefix demotion) is not "
                "ported yet")
        self.cfg = cfg
        self.page = page
        self.pages_max = pages_max
        self.num_pages = num_pages
        self.kv_quant = kv_quant
        self.device = resolve_device(device)
        dt = torch.int8 if kv_quant == "int8" else (dtype or cfg.dtype)
        L = cfg.num_hidden_layers
        nkv, d = cfg.num_key_value_heads, cfg.head_dim
        shape = (L, num_pages, nkv, page, d)
        self.kpool = torch.zeros(shape, dtype=dt, device=self.device)
        self.vpool = torch.zeros(shape, dtype=dt, device=self.device)
        self.kscale = self.vscale = None
        if kv_quant == "int8":
            self.kscale = torch.ones(shape[:-1], dtype=torch.float32,
                                     device=self.device)
            self.vscale = torch.ones(shape[:-1], dtype=torch.float32,
                                     device=self.device)
        self._free = list(range(num_pages - 1, 0, -1))   # page 0 reserved
        self.tables = np.zeros((batch, pages_max), np.int32)
        self.lens = np.zeros((batch,), np.int32)
        self._owned = [[] for _ in range(batch)]
        self.refs = np.zeros(num_pages, np.int64)
        self.scatter_dispatches = 0       # page writes, one per wave

    def free_pages(self) -> int:
        return len(self._free)

    def available_pages(self) -> int:
        """Pages an admission may claim.  Equal to :meth:`free_pages`
        until the prefix index (whose evictable pages count here too) is
        ported."""
        return len(self._free)

    def _page_alloc(self) -> int:
        if not self._free:
            raise RuntimeError("KV page pool exhausted")
        return self._free.pop()

    def alloc_row(self, b: int, length: int) -> None:
        """Claim pages for ``length`` tokens on row ``b`` (prefill).  On
        pool exhaustion the partial claim rolls back, the row is left
        empty and ``RuntimeError`` propagates."""
        need = (length + self.page - 1) // self.page
        if need > self.pages_max:
            raise ValueError(f"length {length} exceeds pages_max")
        self.release_row(b)
        try:
            for j in range(need):
                pid = self._page_alloc()
                self.refs[pid] += 1
                self._owned[b].append(pid)
                self.tables[b, j] = pid
        except RuntimeError:
            self.release_row(b)
            raise
        self.lens[b] = length

    def ensure_capacity(self, b: int, new_tokens: int = 1) -> None:
        """Grow row ``b`` so the next ``new_tokens`` writes have pages."""
        self.ensure_capacity_batch([(b, new_tokens)])

    def ensure_capacity_batch(self, needs) -> None:
        """Grow every ``(row, new_tokens)`` in ``needs`` as one claim.  On
        pool exhaustion the rows already grown keep their pages and
        ``RuntimeError`` propagates (the engine preempts and retries)."""
        for b, new_tokens in needs:
            need = (int(self.lens[b]) + new_tokens - 1) // self.page + 1
            if need > self.pages_max:
                raise ValueError(
                    f"row {b}: {int(self.lens[b])} + {new_tokens} tokens "
                    f"needs {need} pages > pages_max {self.pages_max}")
            while len(self._owned[b]) < need:
                pid = self._page_alloc()
                self.refs[pid] += 1
                self.tables[b, len(self._owned[b])] = pid
                self._owned[b].append(pid)

    def write_pages_batch(self, entries) -> None:
        """Write a whole admission wave: every entry's
        ``(slot, ks [Lyr, S >= L, nkv, d], vs, L, first_page)`` K/V lands
        in the row's pages through one indexed copy per pool tensor.  With
        int8 pages each token is quantized per (layer, slot, head) and its
        scales land in the scale pools at the same page ids."""
        page = self.page
        ids_all, kss, vss = [], [], []
        for slot, ks, vs, L, first_page in entries:
            npg = (L + page - 1) // page
            Wp = npg * page
            if ks.shape[1] < Wp:
                raise ValueError(
                    f"prefill output covers {ks.shape[1]} slots but the "
                    f"row needs {Wp} (pad the prefill to a page multiple)")
            kss.append(ks[:, :Wp])
            vss.append(vs[:, :Wp])
            ids_all.append(
                self.tables[slot, first_page:first_page + npg].copy())
        ks = kss[0] if len(kss) == 1 else torch.cat(kss, dim=1)
        vs = vss[0] if len(vss) == 1 else torch.cat(vss, dim=1)
        ids = np.concatenate(ids_all)
        npg = ids.shape[0]
        Lyr, nkv, d = ks.shape[0], ks.shape[2], ks.shape[3]
        ks_s = vs_s = None
        if self.kv_quant == "int8":
            ks, ks_s = quantize_kv_token(ks)
            vs, vs_s = quantize_kv_token(vs)
            ks_s = ks_s.reshape(Lyr, npg, page, nkv).permute(0, 1, 3, 2)
            vs_s = vs_s.reshape(Lyr, npg, page, nkv).permute(0, 1, 3, 2)
        kb = ks.reshape(Lyr, npg, page, nkv, d).permute(0, 1, 3, 2, 4)
        vb = vs.reshape(Lyr, npg, page, nkv, d).permute(0, 1, 3, 2, 4)
        self._scatter_pages(ids, kb, vb, ks_s, vs_s)

    def _scatter_pages(self, ids, kb, vb, ks_s=None, vs_s=None) -> None:
        """The page-write device seam (one call per admission wave)."""
        idx = torch.as_tensor(ids, dtype=torch.long, device=self.device)
        self.kpool[:, idx] = kb.to(self.kpool.dtype)
        self.vpool[:, idx] = vb.to(self.vpool.dtype)
        if self.kv_quant == "int8":
            self.kscale[:, idx] = ks_s
            self.vscale[:, idx] = vs_s
        self.scatter_dispatches += 1

    def release_row(self, b: int) -> None:
        for pid in self._owned[b]:
            self.refs[pid] -= 1
            if self.refs[pid] == 0:
                self._free.append(pid)
        self._owned[b] = []
        self.tables[b] = 0
        self.lens[b] = 0

    def audit(self) -> dict:
        """Check every page-accounting invariant and return pool stats;
        raises ``AssertionError`` on the first violation:

        * ``refs[pid]`` equals the number of rows owning the page;
        * the free list is duplicate-free, never holds page 0 and holds
          no owned page;
        * no page is owned twice (sharing needs the prefix index);
        * ``tables[b]`` mirrors ``_owned[b]`` positionally;
        * free + owned pages cover the pool except page 0.
        """
        free = self._free
        assert len(set(free)) == len(free), "free list has duplicates"
        assert 0 not in set(free), "reserved page 0 on the free list"
        owned: Counter = Counter()
        for b, row in enumerate(self._owned):
            assert len(set(row)) == len(row), f"row {b} owns a page twice"
            for j, pid in enumerate(row):
                assert int(self.tables[b, j]) == pid, \
                    f"tables[{b},{j}]={self.tables[b, j]} != owned {pid}"
            owned.update(row)
        free_set = set(free)
        for pid in range(self.num_pages):
            assert int(self.refs[pid]) == owned[pid], \
                f"page {pid}: refs {int(self.refs[pid])} != owned {owned[pid]}"
            assert owned[pid] <= 1, f"page {pid} owned by {owned[pid]} rows"
            assert not (pid in free_set and owned[pid]), \
                f"page {pid} free while owned"
        assert len(free) + sum(owned.values()) == self.num_pages - 1, \
            "pages leaked"
        return {"free": len(free), "owned": sum(owned.values())}


def _rope_rows(x, theta, pos):
    """RoPE for one token per row at per-row positions ``pos [B]``;
    x [B, 1, n, d]."""
    d = x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                        device=x.device) / d))
    freqs = pos.to(torch.float32)[:, None] * inv[None]          # [B, d/2]
    cos = torch.cos(freqs)[:, None, None, :]
    sin = torch.sin(freqs)[:, None, None, :]
    x1, x2 = torch.chunk(x, 2, dim=-1)
    x1f, x2f = x1.float(), x2.float()
    return torch.cat([x1f * cos - x2f * sin,
                      x2f * cos + x1f * sin], -1).to(x.dtype)


def _rope_at(x, theta, pos):
    """RoPE at explicit positions ``pos [S]`` or per-row ``[B, S]``;
    x [B, S, n, d].  Same split-half convention as the decode step's
    :func:`_rope_rows` (the cached pages were written by it)."""
    d = x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                        device=x.device) / d))
    freqs = pos.to(torch.float32)[..., None] * inv       # [(B,) S, d/2]
    if freqs.dim() == 2:
        freqs = freqs[None]                              # [1, S, d/2]
    cos = torch.cos(freqs)[:, :, None, :]
    sin = torch.sin(freqs)[:, :, None, :]
    x1, x2 = torch.chunk(x, 2, dim=-1)
    x1f, x2f = x1.float(), x2.float()
    return torch.cat([x1f * cos - x2f * sin,
                      x2f * cos + x1f * sin], -1).to(x.dtype)


def _pick_token(logits, temperature, generator=None, top_k: int = 0,
                top_p: float = 1.0):
    """Greedy / temperature / top-k / nucleus sampling over ``logits
    [B, V]``.  Greedy is the first maximal index, as in JAX; sampling
    draws from ``generator`` (a ``torch.Generator`` on the logits'
    device), so it matches JAX in distribution, not bit for bit."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    logits = logits / temperature
    if top_k and top_k > 0:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = logits.masked_fill(logits < kth, -math.inf)
    if top_p < 1.0:
        sorted_l = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sorted_l, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        # keep the smallest prefix with cumulative mass >= top_p (the
        # first token is always kept: cum shifted right by one)
        keep = torch.cat([torch.zeros_like(cum[..., :1]), cum[..., :-1]],
                         -1) < top_p
        cutoff = torch.where(keep, sorted_l,
                             torch.full_like(sorted_l, math.inf))
        cutoff = cutoff.min(dim=-1, keepdim=True).values
        logits = logits.masked_fill(logits < cutoff, -math.inf)
    probs = torch.softmax(logits.float(), dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


def _decode_layer(cfg, bp, kp, vp, xc, tables, lens, page_ids, slots,
                  ks=None, vs=None):
    """One transformer layer of a paged decode step: write this token's
    K/V into the layer's pool pages (in place), then paged attention over
    ``lens + 1`` slots and the block FFN.  With ``ks`` / ``vs`` (the
    layer's scale pools) the pages are int8: the token's K and V are
    quantized per (row, head) and their scales written beside them."""
    n, d = cfg.num_attention_heads, cfg.head_dim
    nkv = cfg.num_key_value_heads
    dt = cfg.dtype
    B = xc.shape[0]
    y = _rms_norm(xc, bp["ln1"], cfg.rms_norm_eps)
    q = _mm(y, bp["wq"], dt).reshape(B, 1, n, d)
    k = _mm(y, bp["wk"], dt).reshape(B, 1, nkv, d)
    v = _mm(y, bp["wv"], dt).reshape(B, 1, nkv, d)
    q = _rope_rows(q, cfg.rope_theta, lens)
    k = _rope_rows(k, cfg.rope_theta, lens)
    if ks is not None:
        kq, kss = quantize_kv_token(k[:, 0])
        vq, vss = quantize_kv_token(v[:, 0])
        kp[page_ids, :, slots] = kq
        vp[page_ids, :, slots] = vq
        ks[page_ids, :, slots] = kss
        vs[page_ids, :, slots] = vss
        attn = paged_decode_attention_q8(q[:, 0].contiguous(), kp, vp, ks,
                                         vs, tables, lens + 1)
    else:
        kp[page_ids, :, slots] = k[:, 0].to(kp.dtype)
        vp[page_ids, :, slots] = v[:, 0].to(vp.dtype)
        attn = paged_decode_attention(q[:, 0].contiguous(), kp, vp, tables,
                                      lens + 1)
    return _block_post_attn(bp, xc, attn[:, None], cfg)


def _build_step_fns(cfg: LlamaPretrainConfig, temperature: float,
                    with_logits: bool, top_k: int, top_p: float):
    """The per-token step bodies ``(step, step_q8)`` of the JAX factory:
    fp pages, and int8 pages with their scale pools."""
    dt = cfg.dtype

    def run(params, kpool, vpool, kscale, vscale, tables, lens, tok,
            generator):
        B = tok.shape[0]
        page = kpool.shape[3]
        x = params["embed"][tok[:, None].long()].to(dt)
        rows = torch.arange(B, device=tok.device)
        page_ids = tables[rows, (lens // page).long()].long()    # [B]
        slots = (lens % page).long()                             # [B]
        # the JAX step scans the layers with the pools as scan xs/ys; here
        # a Python loop writes each layer's pool slice in place
        for layer in range(cfg.num_hidden_layers):
            scales = (() if kscale is None
                      else (kscale[layer], vscale[layer]))
            x = _decode_layer(cfg, layer_params(params, layer), kpool[layer],
                              vpool[layer], x, tables, lens, page_ids, slots,
                              *scales)
        h = _rms_norm(x[:, 0], params["final_norm"], cfg.rms_norm_eps)
        logits = _mm(h, params["lm_head"], dt).float()
        nxt = _pick_token(logits, temperature, generator, top_k, top_p)
        return (nxt, logits) if with_logits else (nxt,)

    def step(params, kpool, vpool, tables, lens, tok, generator=None):
        out = run(params, kpool, vpool, None, None, tables, lens, tok,
                  generator)
        return (kpool, vpool) + out

    def step_q8(params, kpool, vpool, kscale, vscale, tables, lens, tok,
                generator=None):
        out = run(params, kpool, vpool, kscale, vscale, tables, lens, tok,
                  generator)
        return (kpool, vpool, kscale, vscale) + out

    return step, step_q8


def make_paged_decode_step(cfg: LlamaPretrainConfig,
                           temperature: float = 0.0,
                           kv_quant: Optional[str] = None,
                           with_logits: bool = False,
                           top_k: int = 0, top_p: float = 1.0):
    """``step(params, kpool, vpool, tables, lens, tok, generator=None)
    -> (kpool, vpool, next_tok)`` -- or, with ``kv_quant="int8"``,
    ``step(params, kpool, vpool, kscale, vscale, tables, lens, tok,
    generator=None) -> (kpool, vpool, kscale, vscale, next_tok)`` -- plus
    the fp32 ``[B, V]`` logits with ``with_logits=True``.

    ``lens [B]`` int32 = cached context per row BEFORE this token;
    ``tok [B]`` = this step's input token; ``tables [B, pages_max]``
    int32.  The new K/V land at per-row slot ``lens[b]`` of the pools,
    which are updated in place and returned; callers bump ``lens`` and
    the page tables on the host (:class:`PagedKVCache`)."""
    if kv_quant not in (None, "int8"):
        raise ValueError("kv_quant must be None or 'int8'")
    step, step_q8 = _build_step_fns(cfg, temperature, with_logits, top_k,
                                    top_p)
    return step_q8 if kv_quant == "int8" else step


def _packed_prefill_body(cfg: LlamaPretrainConfig, q8: bool = False,
                         with_hist: bool = False):
    """Packed varlen prefill: ``run(params, toks [1, T], seg [1, T],
    pos [1, T]) -> (x [1, T, H], ks, vs [Lyr, T, nkv, d])``.

    Every waiting context packs into one token stream with segment ids
    (bucket-tail padding rides a sentinel id and attends only itself);
    ``pos`` holds within-segment RoPE positions; attention is the
    segment-masked causal kernel (its plain version on the CPU).

    ``q8`` (int8 pools): without history the JAX form only threads the
    scale pools through its scan, and the stream attends over its own
    unquantized K/V; the port's form is the same ``run``, and the pages
    are quantized when :meth:`PagedKVCache.write_pages_batch` writes them.
    The prefix-cache history form (``with_hist``) is a later slice."""
    if with_hist:
        raise NotImplementedError(
            "the packed prefill's prefix-history form is not ported yet")
    n, d = cfg.num_attention_heads, cfg.head_dim
    nkv = cfg.num_key_value_heads
    dt = cfg.dtype

    def run(params, toks, seg, pos):
        B, T = toks.shape                      # B == 1
        x = params["embed"][toks.long()].to(dt)
        seg = seg.to(torch.int32).contiguous()
        L = cfg.num_hidden_layers
        ks = torch.empty((L, T, nkv, d), dtype=dt, device=x.device)
        vs = torch.empty((L, T, nkv, d), dtype=dt, device=x.device)
        for layer in range(L):
            bp = layer_params(params, layer)
            y = _rms_norm(x, bp["ln1"], cfg.rms_norm_eps)
            q = _mm(y, bp["wq"], dt).reshape(B, T, n, d)
            k = _mm(y, bp["wk"], dt).reshape(B, T, nkv, d)
            v = _mm(y, bp["wv"], dt).reshape(B, T, nkv, d)
            q = _rope_at(q, cfg.rope_theta, pos)
            k = _rope_at(k, cfg.rope_theta, pos)
            attn = flash_attention_segmented(q, k, v, seg, causal=True)
            x = _block_post_attn(bp, x, attn, cfg)
            ks[layer] = k[0]
            vs[layer] = v[0]
        return x, ks, vs

    return run
