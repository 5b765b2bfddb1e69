"""Paged-KV-cache decoding: the page allocator with its prefix index, the
per-token decode step, the admission prefills and paged generation.

Counterpart of ``paddle_tpu/models/paged_decode.py`` for the serving lane
on one device, with bf16 / fp32 pages or int8 pages (``kv_quant="int8"``):
:class:`PagedKVCache` (free list, row alloc / growth / release, the prefix
index of the device tier -- chain keys, leaf-first eviction,
``alloc_row_prefix``, ``register_prefix`` --, the batched page write,
``audit``), :func:`_rope_rows`, :func:`_rope_at`, :func:`_pick_token`,
:func:`_decode_layer`, :func:`make_paged_decode_step` (``step`` and
``step_q8``, optionally returning the logits), :func:`_advance_loop_state`,
:func:`make_paged_decode_step_async` (the dispatch-ahead step),
:func:`make_paged_decode_step_multi` (the decode horizon), the admission
bodies :func:`_prefill` (dense, causal; RoPE through ``_rope``, the fused
RoPE kernel at ``head_dim % 128 == 0``), :func:`_prefill_chunk` (a chunk
over the row's cached pages) and :func:`_packed_prefill_body` (fp and
``q8`` forms, with or without prefix history), the mixed prefill +
decode tick :func:`make_mixed_step`, the speculative round
:func:`make_spec_step` with its batched verify (:func:`_spec_verify_body`,
:func:`_prefill_chunk_batched`), and
:func:`make_paged_generate_fused` / :func:`generate_paged`.

PyTorch runs eagerly and the pools update in place instead of being
donated.  The counterpart of JAX's jit of the async and horizon steps, with
its ``_step_async_cache`` / ``_step_multi_cache``, is a CUDA graph captured
once per key (``models/graphed_step.py``), as is the speculative round on
the overlap lane; the other bodies, the mixed tick's included, stay eager.

``PagedKVCache(host_pages=N)`` backs the device pool with a host page tier
(:class:`~paddle_tpu_torch.models.kv_offload.HostPagePool`, pinned on a
CUDA cache): ``swap_out_row`` / ``swap_in_row`` park a preempted row's
private pages there and restore them with zero prefill tokens, and evicted
cached-prefix pages demote there and promote back on a later lookup.
Restores and promotions write the pools in place, so the decode graphs
captured over them stay valid.  The same tier carries the disaggregation
hand-off: ``export_row`` stages a finished row for another cache,
``export_fetch`` / ``export_discard`` end the export, and ``adopt_swap``
parks a shipped context as a swap record of the receiving cache.  Still
raising ``NotImplementedError``: TP meshes (``mesh=``, ROADMAP.md queue 1
item 7).  :func:`generate_auto` routes a uniform batch to the dense decode
(``models/decode.py:make_generate``) and a ragged one to
:func:`generate_paged`.
"""

from __future__ import annotations

import dataclasses
import hashlib
import math
from collections import Counter, OrderedDict
from typing import Optional

import numpy as np
import torch

from .._device import resolve_device
from ..testing import faults
from ..ops.flash_varlen import flash_attention_segmented
from ..ops.paged_attention import (paged_decode_attention,
                                   paged_decode_attention_q8,
                                   quantize_kv_token)
from .decode import _grouped_attn
from .llama_pretrain import (LlamaPretrainConfig, _block_post_attn, _mm,
                             _rms_norm, _rope, layer_params)

__all__ = ["PagedKVCache", "make_paged_decode_step",
           "make_paged_decode_step_async", "make_paged_decode_step_multi",
           "make_mixed_step", "make_spec_step", "generate_paged",
           "generate_auto"]


class PagedKVCache:
    """Free-list page allocator + device page pools for all layers.

    Pools: ``[L, num_pages, nkv, page, d]`` tensors on ``device`` (CUDA
    unless asked otherwise).  With ``kv_quant="int8"`` the pools are int8
    and ``kscale`` / ``vscale`` ``[L, num_pages, nkv, page]`` f32 hold one
    scale per (page, head, slot); otherwise both are ``None``.  Page 0 is
    reserved as the junk page unused table slots point at; the kernels
    never read it.

    With ``host_pages`` > 0 a host page tier (``self.host``, a
    :class:`~paddle_tpu_torch.models.kv_offload.HostPagePool` of the pool's
    dtype, pinned on a CUDA cache) backs the pool: preempted rows swap out
    instead of releasing (``swap_out_row`` / ``swap_in_row``, zero prefill
    tokens on resume) and evicted cached-prefix pages demote to it and
    promote back on lookup."""

    def __init__(self, cfg: LlamaPretrainConfig, num_pages: int,
                 pages_max: int, batch: int, page: int = 64,
                 dtype=None, kv_quant: Optional[str] = None,
                 mesh=None, host_pages: int = 0, device=None):
        if kv_quant not in (None, "int8"):
            raise ValueError("kv_quant must be None or 'int8'")
        if mesh is not None:
            raise NotImplementedError(
                "kv-head-sharded pools (TP meshes) are not ported yet "
                "(ROADMAP.md queue 1 item 7)")
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
        # bumped on every host-side ``tables`` mutation, so the
        # dispatch-ahead loop's device copy re-uploads only when the block
        # tables changed
        self.tables_version = 0
        # prefix caching: refcounted pages and an LRU index from a full
        # page's chain key to its page id.  Only full pages are shared, so
        # shared pages are never written again (decode writes land past
        # them, in private pages).  The index holds one ref per cached
        # page; every row holding it adds its own.
        self.refs = np.zeros(num_pages, np.int64)
        self._prefix_index: "OrderedDict[bytes, int]" = OrderedDict()
        # the chain structure, for leaf-first eviction: a key's parent
        # and its live children
        self._prefix_parent: dict = {}
        self._prefix_children: dict = {}
        self.prefix_hits = 0              # pages reused through the index
        # -- the host tier: preempted rows swap out to host RAM and evicted
        # prefix pages demote there instead of dying.  A key lives in one
        # tier at a time (_prefix_index or _host_prefix_index); the chain
        # structure spans both.
        self.host = None
        if host_pages:
            from .kv_offload import HostPagePool
            self.host = HostPagePool(cfg, host_pages, page, dt,
                                     kv_quant=kv_quant, device=self.device)
        self._host_prefix_index: "OrderedDict[bytes, int]" = OrderedDict()
        self._host_pinned: set = set()    # hids mid-promotion
        self._demote_pending: list = []   # (pid, hid) gathers to stage
        self._swapped: dict = {}          # handle -> swapped-row record
        self._next_swap = 0
        # live cross-cache hand-off exports (export id -> export state):
        # their staging host pages are held until fetched or discarded
        self._exports: dict = {}
        self._next_export = 0
        self.prefix_promotions = 0        # host -> device page promotions
        self.swap_out_pages = 0
        self.swap_in_pages = 0
        self.swap_bytes = 0
        self.scatter_dispatches = 0       # page writes, one per wave
        self.restore_dispatches = 0       # swap-in / promotion restores
        # the engine's EngineMetrics (the engine sets it; None records
        # nothing)
        self.metrics = None

    @property
    def page_bytes(self) -> int:
        """Bytes one page costs across all layers, K + V (+ the int8 scale
        planes): the unit of the swap cost model."""
        per = (self.cfg.num_hidden_layers * self.cfg.num_key_value_heads
               * self.page * self.cfg.head_dim)
        b = 2 * per * self.kpool.element_size()
        if self.kv_quant == "int8":
            b += 2 * (per // self.cfg.head_dim) * 4
        return b

    def free_pages(self) -> int:
        return len(self._free)

    def available_pages(self) -> int:
        """Free pages plus evictable cached-prefix pages (``refs == 1``:
        held by the index alone).  Admission budgets against this:
        registered prompt pages leave the free list for good, and a gate
        on the free list alone livelocks once the index holds enough of
        the pool."""
        evictable = sum(1 for pid in self._prefix_index.values()
                        if self.refs[pid] == 1)
        return len(self._free) + evictable

    # -- prefix caching ---------------------------------------------------
    @staticmethod
    def _chain_keys(ctx: np.ndarray, page: int):
        """One key per full page: key i is the sha1 of tokens
        ``[0, (i + 1) * page)``, so a key names its whole prefix and its
        position."""
        keys = []
        h = hashlib.sha1()
        for i in range(len(ctx) // page):
            h.update(np.ascontiguousarray(
                ctx[i * page:(i + 1) * page]).tobytes())
            keys.append(h.digest())
        return keys

    def _link_chain(self, key, parent) -> None:
        """(Re)link ``key`` under ``parent`` (``None`` for a chain's head).
        Idempotent: a parent evicted and registered again starts with an
        empty children set and must learn its surviving children, or
        leaf-first eviction would take it from under them."""
        self._prefix_parent[key] = parent
        self._prefix_children.setdefault(key, set())
        if parent is not None:
            self._prefix_children.setdefault(parent, set()).add(key)

    def _drop_chain_entry(self, key) -> None:
        """Take ``key`` out of the chain structure (it left the index)."""
        parent = self._prefix_parent.pop(key, None)
        if parent is not None and parent in self._prefix_children:
            self._prefix_children[parent].discard(key)
        self._prefix_children.pop(key, None)

    def _ids(self, pids):
        """Page ids as a long tensor on the pools' device, sent without a
        host sync (the copy may be issued under in-flight steps)."""
        return torch.from_numpy(np.asarray(pids, np.int64)).to(
            self.device, non_blocking=True)

    def _host_free(self, hid: int) -> None:
        """Free a host page, dropping any deferred demotion gather aimed at
        it (its content is discarded; a late gather would clobber the
        page's next tenant)."""
        if self._demote_pending:
            self._demote_pending = [
                (p, h) for p, h in self._demote_pending if h != hid]
        self.host.free(hid)

    def _host_evict_one(self) -> bool:
        """Free the oldest host-tier prefix page with no live child (hids
        pinned mid-promotion are skipped): leaf first, as on the device.
        -> whether a page was freed."""
        for key in list(self._host_prefix_index):
            hid = self._host_prefix_index[key]
            if hid in self._host_pinned:
                continue
            if self._prefix_children.get(key):
                continue                      # has live children
            del self._host_prefix_index[key]
            self._drop_chain_entry(key)
            self._host_free(hid)
            return True
        return False

    def _host_alloc(self) -> int:
        """Pop a host page, evicting host-tier cached prefixes (oldest leaf
        first) when the host free list is empty."""
        while not self.host._free:
            if not self._host_evict_one():
                break
        return self.host.alloc()

    def host_available(self) -> int:
        """Host pages obtainable now: free plus evictable host-tier prefix
        pages.  0 without a host tier, and while a ``host_pool_full``
        condition rule is armed (the cost model and the swap-out
        precondition then degrade to recompute)."""
        if self.host is None:
            return 0
        if faults.active("host_pool_full"):
            return 0
        return (self.host.free_pages() + len(self._host_prefix_index)
                - len(self._host_pinned))

    def _evict_one_prefix(self) -> bool:
        """Take the oldest leaf cached-prefix page held by the index alone
        (``refs == 1``, no child in the device index) off the device: it
        demotes to the host tier when one is attached and has room (a later
        lookup promotes it back), else it is dropped.  Leaf first keeps
        every chain usable for lookup: evicting a head would orphan its
        tail.  The demotion's gather is deferred to
        :meth:`_flush_demotions`, so one allocator call's demotions move as
        one batch.  -> whether a page was freed."""
        for key in list(self._prefix_index):
            pid = self._prefix_index[key]
            if self.refs[pid] != 1:
                continue
            if any(c in self._prefix_index
                   for c in self._prefix_children.get(key, ())):
                continue
            del self._prefix_index[key]
            if self.host is not None and self.host_available() > 0:
                hid = self._host_alloc()
                self._demote_pending.append((pid, hid))
                self._host_prefix_index[key] = hid   # the chain entry stays
            else:
                self._drop_chain_entry(key)
            self.refs[pid] = 0
            self._free.append(pid)
            # the traffic is counted when the gather is staged: a deferred
            # demotion dropped before then moved no bytes
            return True
        return False

    def _count_swap(self, n: int, out: bool) -> None:
        """The one bookkeeping site of swap traffic (the plain counters
        and the registry's stay in lockstep)."""
        nbytes = n * self.page_bytes
        if out:
            self.swap_out_pages += n
        else:
            self.swap_in_pages += n
        self.swap_bytes += nbytes
        if self.metrics is not None:
            (self.metrics.swap_out_pages if out
             else self.metrics.swap_in_pages).inc(n)
            self.metrics.swap_bytes.inc(nbytes)

    def _flush_demotions(self) -> None:
        """Stage every demotion :meth:`_evict_one_prefix` deferred as one
        batched gather.  Runs before any pool write (a demoted page may
        already be handed out: the write must come after the gather in the
        stream's order), and on the exit of every allocator entry point."""
        if not self._demote_pending:
            return
        pending, self._demote_pending = self._demote_pending, []
        self._stage_swap_out([p for p, _ in pending],
                             [h for _, h in pending])
        self._count_swap(len(pending), out=True)

    def _stage_swap_out(self, pids, hids) -> None:
        """One batched gather of device pages ``pids`` (page-major, on the
        compute stream, so it reads every write enqueued before it) staged
        into host pages ``hids``; the copy rides under the next steps."""
        idx = self._ids(pids)

        def take(pool):
            return pool.transpose(0, 1).index_select(0, idx)

        if self.kv_quant == "int8":
            self.host.stage(hids, take(self.kpool), take(self.vpool),
                            take(self.kscale), take(self.vscale))
        else:
            self.host.stage(hids, take(self.kpool), take(self.vpool))

    def _restore_pages(self, pids, k, v, ks, vs) -> None:
        """One batched restore of page-major host blocks into device pages
        ``pids``, in place (the decode graphs captured the pools'
        addresses; a rebound pool would leave them reading a stale one).
        Pending demotion gathers are staged first: they must precede any
        pool write."""
        self._flush_demotions()
        idx = self._ids(pids)
        self.kpool[:, idx] = k.transpose(0, 1)
        self.vpool[:, idx] = v.transpose(0, 1)
        if self.kv_quant == "int8":
            self.kscale[:, idx] = ks.transpose(0, 1)
            self.vscale[:, idx] = vs.transpose(0, 1)
        self.restore_dispatches += 1

    def _page_alloc(self) -> int:
        """Pop a free page, evicting a cached prefix page (oldest leaf
        first) when the free list is empty."""
        if not self._free:
            self._evict_one_prefix()
        if not self._free:
            raise RuntimeError("KV page pool exhausted")
        return self._free.pop()

    def alloc_row_prefix(self, b: int, ctx: np.ndarray) -> int:
        """:meth:`alloc_row` that shares cached prefix pages: the longest
        run of ``ctx``'s chain keys found in the index is shared (a ref
        each), fresh pages take the rest.  A key that misses on the device
        but hits the host tier is promoted: a fresh device page is
        claimed, restored from host RAM (one batched restore for the row)
        and the key moves back into the device index.  A whole context that
        is cached and page-aligned keeps its last page private (the engine
        computes that page's K/V for the next-token logits).  On pool
        exhaustion the claim rolls back, the row is left empty and
        ``RuntimeError`` propagates.  ``prefix_hits`` counts only a
        committed claim.  -> the tokens reused (a page multiple); the
        caller prefills from there."""
        page = self.page
        L = len(ctx)
        need = (L + page - 1) // page
        if need > self.pages_max:
            raise ValueError(f"length {L} exceeds pages_max")
        self.release_row(b)
        keys = self._chain_keys(ctx, page)
        plan = []                # chain order: ("share"|"promote", key, id)
        for key in keys:
            pid = self._prefix_index.get(key)
            if pid is not None:
                self._prefix_index.move_to_end(key)          # LRU touch
                plan.append(("share", key, pid))
                continue
            hid = self._host_prefix_index.get(key)
            if hid is not None:
                self._host_prefix_index.move_to_end(key)
                plan.append(("promote", key, hid))
                continue
            break
        if L % page == 0 and len(plan) == len(keys) and plan:
            plan.pop()
        promos = [(j, key, hid) for j, (kind, key, hid) in enumerate(plan)
                  if kind == "promote"]
        # pin the promotions' host pages: the allocations below may demote
        # other pages, and host eviction must not take the pages about to
        # be read
        self._host_pinned.update(h for _, _, h in promos)
        row = [None] * need
        try:
            # the shared pages first: their ref lifts them above eviction
            for j, (kind, key, val) in enumerate(plan):
                if kind == "share":
                    self.refs[val] += 1
                    row[j] = val
            # promotions: claim device pages, one batched restore, then the
            # index entries move host -> device
            promo_pids = []
            try:
                for _ in promos:
                    promo_pids.append(self._page_alloc())
            except RuntimeError:
                self._free.extend(promo_pids)
                for j, (kind, key, val) in enumerate(plan):
                    if kind == "share":
                        self.refs[val] -= 1     # the index ref remains
                raise
            if promos:
                k, v, ks, vs = self.host.gather([h for _, _, h in promos])
                self._restore_pages(promo_pids, k, v, ks, vs)
                for (j, key, hid), pid in zip(promos, promo_pids):
                    del self._host_prefix_index[key]
                    self._host_free(hid)
                    self._prefix_index[key] = pid
                    self._link_chain(key, keys[j - 1] if j else None)
                    self.refs[pid] = 2          # the index's and the row's
                    row[j] = pid
                self.prefix_promotions += len(promos)
                self._count_swap(len(promos), out=False)
            # fresh pages for the rest
            try:
                for j in range(len(plan), need):
                    pid = self._page_alloc()
                    self.refs[pid] += 1
                    row[j] = pid
            except RuntimeError:
                # promoted pages keep their index ref: valid cached pages
                for pid in row:
                    if pid is None:
                        continue
                    self.refs[pid] -= 1
                    if self.refs[pid] == 0:
                        self._free.append(pid)
                raise
        finally:
            self._host_pinned.difference_update(h for _, _, h in promos)
            self._flush_demotions()
        self._owned[b] = row
        for j, pid in enumerate(row):
            self.tables[b, j] = pid
        self.tables_version += 1
        self.lens[b] = L
        self.prefix_hits += len(plan)
        if self.metrics is not None:
            self.metrics.prefix_hit_pages.inc(len(plan))
            self.metrics.prefix_miss_pages.inc(need - len(plan))
        return len(plan) * page

    def register_prefix(self, b: int, ctx: np.ndarray) -> None:
        """Enter row ``b``'s full pages of ``ctx`` into the prefix index,
        one index ref each, so later admissions sharing the prefix reuse
        them.  Keys already cached keep their page; a key demoted to the
        host tier is refreshed (its host copy is dropped for the identical
        device page just written: a key lives in one tier)."""
        keys = self._chain_keys(ctx, self.page)
        for j, key in enumerate(keys):
            if key in self._prefix_index:
                continue
            pid = int(self.tables[b, j])
            hid = self._host_prefix_index.pop(key, None)
            if hid is not None:
                self._host_free(hid)
            self._prefix_index[key] = pid
            self._link_chain(key, keys[j - 1] if j else None)
            self.refs[pid] += 1

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
        finally:
            self._flush_demotions()
        self.tables_version += 1
        self.lens[b] = length

    def ensure_capacity(self, b: int, new_tokens: int = 1) -> None:
        """Grow row ``b`` so the next ``new_tokens`` writes have pages."""
        self.ensure_capacity_batch([(b, new_tokens)])

    def ensure_capacity_batch(self, needs) -> None:
        """Grow every ``(row, new_tokens)`` in ``needs`` as one claim:
        however many rows grow, ``tables_version`` bumps at most once.  On
        pool exhaustion the rows already grown keep their pages and
        ``RuntimeError`` propagates (the engine preempts and retries); the
        version still bumps for the partial growth."""
        grew = False
        try:
            for b, new_tokens in needs:
                need = (int(self.lens[b]) + new_tokens - 1) // self.page + 1
                if need > self.pages_max:
                    raise ValueError(
                        f"row {b}: {int(self.lens[b])} + {new_tokens} "
                        f"tokens needs {need} pages > pages_max "
                        f"{self.pages_max}")
                while len(self._owned[b]) < need:
                    pid = self._page_alloc()
                    self.refs[pid] += 1
                    self.tables[b, len(self._owned[b])] = pid
                    self._owned[b].append(pid)
                    grew = True
        finally:
            self._flush_demotions()
            if grew:
                self.tables_version += 1

    def write_row_pages(self, slot: int, ks, vs, L: int,
                        first_page: int = 0) -> None:
        """Write one row's ``ks`` / ``vs [Lyr, S >= L, nkv, d]`` into its
        pages from table position ``first_page`` on (a chunk c of the
        chunked lane starts at page ``c * chunk / page``): one entry of
        :meth:`write_pages_batch`."""
        self.write_pages_batch([(slot, ks, vs, L, first_page)])

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
        """The page-write device seam (one call per admission wave).
        Pending demotion gathers are staged first: they must precede any
        pool write."""
        self._flush_demotions()
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
            if self.refs[pid] == 0:     # cached / shared pages stay put
                self._free.append(pid)
        self._owned[b] = []
        self.tables[b] = 0
        self.lens[b] = 0
        self.tables_version += 1

    # -- the host tier's row swap (preemption without recompute) ----------
    def private_pages(self, b: int) -> int:
        """Pages of row ``b``'s written context that only the row holds
        (``refs == 1``): what :meth:`swap_out_row` moves to the host tier.
        The engine's cost model and the swap precondition both read it."""
        npg = (int(self.lens[b]) + self.page - 1) // self.page
        return sum(1 for pid in self._owned[b][:npg] if self.refs[pid] == 1)

    def swap_out_row(self, b: int) -> int:
        """Park row ``b``'s cached context in the host tier: its private
        pages go in one batched gather staged to host pages, its shared
        (prefix) pages stay on the device with the row's ref carried by the
        swap record.  The row is released.  -> a handle for
        :meth:`swap_in_row`.  Raises ``RuntimeError`` before changing
        anything when there is no host tier or it cannot hold the private
        pages (and at an armed ``swap_out`` fault site)."""
        if self.host is None:
            raise RuntimeError("no host page tier attached")
        faults.fire("swap_out")
        L = int(self.lens[b])
        npg = (L + self.page - 1) // self.page
        private = self.private_pages(b)
        if self.host_available() < private:
            raise RuntimeError(
                f"host tier full: {private} pages to swap, "
                f"{self.host_available()} available")
        entries, dev_ids, host_ids = [], [], []
        for pid in self._owned[b][:npg]:
            if self.refs[pid] > 1:
                entries.append(("dev", pid))      # carries the row's ref
            else:
                hid = self._host_alloc()
                entries.append(("host", hid))
                dev_ids.append(pid)
                host_ids.append(hid)
        if dev_ids:
            self._stage_swap_out(dev_ids, host_ids)
            for pid in dev_ids:
                self.refs[pid] = 0
                self._free.append(pid)
            self._count_swap(len(dev_ids), out=True)
        for pid in self._owned[b][npg:]:          # unwritten growth
            self.refs[pid] -= 1
            if self.refs[pid] == 0:
                self._free.append(pid)
        self._owned[b] = []
        self.tables[b] = 0
        self.lens[b] = 0
        self.tables_version += 1
        handle = self._next_swap
        self._next_swap += 1
        self._swapped[handle] = {"entries": entries, "lens": L}
        return handle

    def swap_pages_needed(self, handle: int) -> int:
        """Device pages a :meth:`swap_in_row` of this record claims (its
        on-device entries hold theirs already)."""
        return sum(1 for kind, _ in self._swapped[handle]["entries"]
                   if kind == "host")

    def swap_ctx_len(self, handle: int) -> int:
        return int(self._swapped[handle]["lens"])

    def swap_in_row(self, b: int, handle: int) -> int:
        """Rebuild row ``b`` from a swap record: fresh device pages for the
        host entries, restored by one batched in-place copy; the on-device
        entries slot their held pages back into the table.  Zero prefill
        tokens.  -> the restored context length.  On device-pool exhaustion
        the record is left intact and ``RuntimeError`` propagates (the
        caller falls back to recompute)."""
        faults.fire("swap_in")
        rec = self._swapped[handle]
        entries = rec["entries"]
        self.release_row(b)
        fresh = []
        try:
            for _ in range(sum(1 for kind, _ in entries if kind == "host")):
                fresh.append(self._page_alloc())
        except RuntimeError:
            self._free.extend(fresh)
            raise
        finally:
            self._flush_demotions()
        del self._swapped[handle]
        it = iter(fresh)
        restore_ids, hids = [], []
        for j, (kind, val) in enumerate(entries):
            if kind == "host":
                pid = next(it)
                self.refs[pid] += 1
                restore_ids.append(pid)
                hids.append(val)
            else:
                pid = val              # the record's ref becomes the row's
            self.tables[b, j] = pid
            self._owned[b].append(pid)
        if restore_ids:
            k, v, ks, vs = self.host.gather(hids)
            self._restore_pages(restore_ids, k, v, ks, vs)
            for hid in hids:
                self._host_free(hid)
            self._count_swap(len(restore_ids), out=False)
        self.lens[b] = rec["lens"]
        self.tables_version += 1
        return int(rec["lens"])

    def discard_swap(self, handle: int) -> None:
        """Drop a swap record without restoring it (its request falls back
        to recompute): its host pages free, its held device refs
        release."""
        rec = self._swapped.pop(handle)
        for kind, val in rec["entries"]:
            if kind == "dev":
                self.refs[val] -= 1
                if self.refs[val] == 0:
                    self._free.append(val)
            else:
                self._host_free(val)

    # -- the cross-cache KV hand-off (disaggregated prefill / decode) -----
    def export_row(self, b: int) -> dict:
        """Stage row ``b``'s whole written context (shared prefix pages
        included: another cache holds none of this one's pages) for a hand-off
        to another cache, and release the row.  Unlike
        :meth:`swap_out_row` the result is portable.

        The gather stages through the host tier (one batched gather on the
        compute stream, the device -> host copy on the side stream, riding
        under the next dispatches) when the tier has room, else it is a
        synchronous copy to the host.  Either way the gather is ordered
        before any later write to the freed pages.  -> an export state for
        :meth:`export_fetch` / :meth:`export_discard`; live exports are
        tracked so :meth:`audit` accounts their host pages."""
        page = self.page
        L = int(self.lens[b])
        npg = (L + page - 1) // page
        pids = self._owned[b][:npg]
        state = {"id": self._next_export, "lens": L, "pages": npg}
        self._next_export += 1
        if npg and self.host is not None \
                and self.host_available() >= npg:
            hids = [self._host_alloc() for _ in range(npg)]
            self._stage_swap_out(pids, hids)
            state["hids"] = hids
        elif npg:
            idx = self._ids(pids)

            def take(pool):
                return pool.transpose(0, 1).index_select(0, idx).cpu()

            state["k"] = take(self.kpool)
            state["v"] = take(self.vpool)
            if self.kv_quant == "int8":
                state["ks"] = take(self.kscale)
                state["vs"] = take(self.vscale)
        self.release_row(b)
        self._exports[state["id"]] = state
        return state

    def export_fetch(self, state: dict):
        """Materialise an export as host blocks ``(k, v, kscale, vscale,
        ctx_len)``: page-major CPU tensors of the pool's dtype (scales
        ``None`` for a non-int8 pool), and free the staging host pages.  The
        hand-off's one blocking point: the host tier's flush commits the
        copies that have ridden under the dispatches since
        :meth:`export_row`."""
        self._exports.pop(state["id"], None)
        if "hids" in state:
            k, v, ks, vs = self.host.read(state["hids"])
            for hid in state["hids"]:
                self._host_free(hid)
            return k, v, ks, vs, state["lens"]
        return (state.get("k"), state.get("v"), state.get("ks"),
                state.get("vs"), state["lens"])

    def export_discard(self, state: dict) -> None:
        """Drop an export that was not shipped (its request degraded to a
        colocated re-prefill, or its engine died): its staging host pages
        free.  Idempotent."""
        if self._exports.pop(state["id"], None) is None:
            return                     # already fetched or discarded
        for hid in state.get("hids", ()):
            self._host_free(hid)

    def adopt_swap(self, k, v, kscale, vscale, length: int) -> int:
        """Take a shipped context into this cache's host tier as a swap
        record of host entries only: the receiving half of a hand-off.  The
        owning engine maps the handle to its request and admits it through
        the ordinary ``_admit_swapped`` path: one batched restore, zero
        prefill tokens.  Raises before changing anything: ``RuntimeError``
        without a host tier or with too little room in it (the caller
        degrades the request to a colocated re-prefill), ``ValueError`` on
        a dtype or ``kv_quant`` mismatch (a bitwise restore needs both
        caches alike)."""
        if self.host is None:
            raise RuntimeError(
                "adopt_swap needs a host page tier on the receiving cache "
                "(PagedKVCache(host_pages=N)): hand-off records park there "
                "until their batched restore")
        npg = (int(length) + self.page - 1) // self.page
        if self.host_available() < npg:
            raise RuntimeError(
                f"host tier full: {npg} pages to adopt, "
                f"{self.host_available()} available")
        if k.dtype != self.host.kbuf.dtype:
            raise ValueError(
                f"handoff dtype {k.dtype} != pool dtype "
                f"{self.host.kbuf.dtype} (source and destination caches "
                f"must share dtype / kv_quant for a bitwise restore)")
        if (kscale is None) == (self.kv_quant == "int8"):
            raise ValueError(
                "handoff kv_quant mismatch: int8 records need their scale "
                "planes and fp records must not carry them")
        hids = [self._host_alloc() for _ in range(npg)]
        self.host.write(hids, k, v, kscale, vscale)
        handle = self._next_swap
        self._next_swap += 1
        self._swapped[handle] = {"entries": [("host", h) for h in hids],
                                 "lens": int(length)}
        return handle

    def audit(self) -> dict:
        """Check every page-accounting invariant and return pool stats;
        raises ``AssertionError`` on the first violation:

        * ``refs[pid]`` equals the rows owning the page plus its index
          entries plus the swap records holding it on the device;
        * the free list is duplicate-free, never holds page 0 and holds
          no referenced page;
        * a page owned by two rows is an index page (sharing goes through
          the index only);
        * ``tables[b]`` mirrors ``_owned[b]`` positionally;
        * free + referenced pages cover the pool except page 0;
        * every live key (either tier) whose parent is live sits in its
          parent's children set (else leaf-first eviction could take the
          parent);
        * host tier: its free list and the pages of the host index, of
          the swap records and of the live hand-off exports partition it
          exactly.

        With a host tier the stats also hold ``swap_records``, ``host_free``
        and ``host_indexed`` (a cache without one holds no swap record)."""
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
        index: Counter = Counter(self._prefix_index.values())
        swap: Counter = Counter(pid for rec in self._swapped.values()
                                for kind, pid in rec["entries"]
                                if kind == "dev")
        free_set = set(free)
        for pid in range(self.num_pages):
            want = owned[pid] + index[pid] + swap[pid]
            assert int(self.refs[pid]) == want, \
                (f"page {pid}: refs {int(self.refs[pid])} != owned "
                 f"{owned[pid]} + index {index[pid]} + swapped {swap[pid]}")
            if pid in free_set:
                assert want == 0, f"page {pid} free while referenced"
        for pid, c in owned.items():
            if c > 1:
                assert index[pid] > 0, \
                    (f"page {pid} owned by {c} rows but not a prefix-index "
                     f"page (sharing goes through the index only)")
        held = set(owned) | set(index) | set(swap)
        assert len(free) + len(held) == self.num_pages - 1, "pages leaked"
        live = set(self._prefix_index) | set(self._host_prefix_index)
        for key in live:
            parent = self._prefix_parent.get(key)
            if parent is not None and parent in live:
                assert key in self._prefix_children.get(parent, ()), \
                    "prefix chain edge missing (parent unaware of live child)"
        stats = {"free": len(free), "owned": sum(owned.values()),
                 "indexed": len(self._prefix_index)}
        if self.host is not None:
            hfree = self.host._free
            assert len(set(hfree)) == len(hfree), \
                "host free list has duplicates"
            used = list(self._host_prefix_index.values()) + [
                hid for rec in self._swapped.values()
                for kind, hid in rec["entries"] if kind == "host"] + [
                hid for st in self._exports.values()
                for hid in st.get("hids", ())]
            assert len(set(used)) == len(used), "host page held twice"
            assert not (set(hfree) & set(used)), \
                "host page free while in use"
            assert len(hfree) + len(used) == self.host.num_pages, \
                "host pages leaked"
            stats.update(swap_records=len(self._swapped),
                         host_free=len(hfree),
                         host_indexed=len(self._host_prefix_index))
        return stats


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
        # JAX's gather clamps an index past the table; a CUDA index would
        # assert instead, so clamp as it does
        col = (lens // page).long().clamp(max=tables.shape[1] - 1)
        page_ids = tables[rows, col].long()                      # [B]
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


def _advance_loop_state(nxt, tok, lens, active, remaining, eos):
    """The on-device serving-loop state advance, shared by the async and
    horizon steps: inactive rows keep their token, ``lens`` / ``remaining``
    move only under ``active``, and ``done`` marks rows that just hit
    ``eos`` (-1 for none) or exhausted their budget.  Plain tensor code:
    no host read."""
    nxt = torch.where(active, nxt, tok)
    lens2 = lens + active.to(lens.dtype)
    rem2 = remaining - active.to(remaining.dtype)
    done = active & ((nxt == eos) | (rem2 <= 0))
    return nxt, lens2, rem2, active & ~done, done


def _loop_base(cfg, temperature, kv_quant, top_k, top_p, mesh):
    if kv_quant not in (None, "int8"):
        raise ValueError("kv_quant must be None or 'int8'")
    if mesh is not None:
        raise NotImplementedError(
            "the TP decode step (mp > 1 meshes) is not ported yet")
    step, step_q8 = _build_step_fns(cfg, temperature, False, top_k, top_p)
    return step_q8 if kv_quant == "int8" else step


def make_paged_decode_step_async(cfg: LlamaPretrainConfig,
                                 temperature: float = 0.0,
                                 kv_quant: Optional[str] = None,
                                 top_k: int = 0, top_p: float = 1.0,
                                 mesh=None, tp_allreduce: str = "fp32"):
    """The dispatch-ahead decode step: the per-token step plus the
    functional advance of the serving-loop state, so step k's outputs on
    the device feed step k+1 with no host round-trip.

    ``step(params, kpool, vpool, [kscale, vscale,] tables, lens, tok,
    active, remaining, eos, generator=None) -> (kpool, vpool, [kscale,
    vscale,] nxt, lens', remaining', active', done)``

    Rows advance only under ``active`` (bool [B]); ``done`` marks active
    rows that just hit ``eos`` or their budget, and ``active' = active &
    ~done`` feeds the next dispatch.  The pools are written in place.
    Multi-token stop sequences stay on the host (the engine flushes its
    pipeline when one fires).  The engine replays this body from a CUDA
    graph on the card (``models/graphed_step.py``)."""
    base = _loop_base(cfg, temperature, kv_quant, top_k, top_p, mesh)
    npools = 4 if kv_quant == "int8" else 2

    def step(params, *args, generator=None):
        if len(args) == npools + 7:           # the generator by position
            *args, generator = args
        pools = args[:npools]
        tables, lens, tok, active, remaining, eos = args[npools:]
        *pools, nxt = base(params, *pools, tables, lens, tok, generator)
        return (*pools, *_advance_loop_state(nxt, tok, lens, active,
                                             remaining, eos))

    return step


def make_paged_decode_step_multi(cfg: LlamaPretrainConfig, horizon: int,
                                 temperature: float = 0.0,
                                 kv_quant: Optional[str] = None,
                                 top_k: int = 0, top_p: float = 1.0,
                                 mesh=None, tp_allreduce: str = "fp32"):
    """The decode horizon: ``horizon`` micro-steps of the async body over
    constant block tables (the engine pre-claims the pages), the done mask
    folded on the device each micro-step, one generator draw per
    micro-step when sampling.

    ``step(params, kpool, vpool, [kscale, vscale,] tables, lens, tok,
    active, remaining, eos, generator=None) -> (kpool, vpool, [kscale,
    vscale,] toks [H, B], dones [H, B], tok', lens', remaining', active')``

    ``toks[h]`` is micro-step h's next token and ``dones[h]`` the rows that
    stopped there (at most once a row; after it the row repeats its last
    token); the trailing four are the chained loop state after the block.
    JAX scans the micro-steps; here a Python loop runs them, and the
    engine captures the whole block in one CUDA graph on the card."""
    H = int(horizon)
    if H < 1:
        raise ValueError(f"horizon must be >= 1, got {horizon}")
    base = _loop_base(cfg, temperature, kv_quant, top_k, top_p, mesh)
    npools = 4 if kv_quant == "int8" else 2

    def step(params, *args, generator=None):
        if len(args) == npools + 7:           # the generator by position
            *args, generator = args
        pools = list(args[:npools])
        tables, lens, tok, active, remaining, eos = args[npools:]
        toks, dones = [], []
        for _ in range(H):
            *pools, nxt = base(params, *pools, tables, lens, tok, generator)
            tok, lens, remaining, active, done = _advance_loop_state(
                nxt, tok, lens, active, remaining, eos)
            toks.append(tok)
            dones.append(done)
        return (*pools, torch.stack(toks), torch.stack(dones), tok, lens,
                remaining, active)

    return step


def make_paged_generate_fused(cfg: LlamaPretrainConfig,
                              max_new_tokens: int,
                              temperature: float = 0.0,
                              kv_quant: Optional[str] = None,
                              top_k: int = 0, top_p: float = 1.0):
    """The whole paged generation tail as one call with no host read:
    ``generate(params, kpool, vpool, kscale, vscale, tables, lens0, tok0,
    generator=None) -> (kpool, vpool, kscale, vscale, toks
    [max_new_tokens, B])``.

    The caller pre-claims pages for ``lens0 + max_new_tokens`` tokens, so
    the tables stay constant and every row advances at its own position.
    ``toks[0]`` is ``tok0``; each later row is one decode step's pick.
    JAX scans the steps in one jitted program; here a loop of the eager
    step runs them on the device and the host reads nothing until the
    caller reads ``toks``.  ``kscale`` / ``vscale`` are ignored (and
    returned) for fp pages."""
    if kv_quant not in (None, "int8"):
        raise ValueError("kv_quant must be None or 'int8'")
    step, step_q8 = _build_step_fns(cfg, temperature, False, top_k, top_p)
    q8 = kv_quant == "int8"

    def generate(params, kpool, vpool, kscale, vscale, tables, lens0, tok0,
                 generator=None):
        lens = lens0.to(torch.int32)
        tok = tok0
        out = [tok0]
        for _ in range(max_new_tokens - 1):
            if q8:
                kpool, vpool, kscale, vscale, tok = step_q8(
                    params, kpool, vpool, kscale, vscale, tables, lens, tok,
                    generator)
            else:
                kpool, vpool, tok = step(params, kpool, vpool, tables, lens,
                                         tok, generator)
            lens = lens + 1
            out.append(tok)
        return kpool, vpool, kscale, vscale, torch.stack(out)

    return generate


def _prefill(cfg: LlamaPretrainConfig):
    """The dense causal prefill: ``prefill(params, prompt [B, S]) ->
    (x [B, S, H], ks, vs [Lyr, B, S, nkv, d])``.

    RoPE goes through the training trunk's ``_rope`` (the fused RoPE
    kernel at ``head_dim % 128 == 0``, else the inline rotate-half), as
    JAX's does; attention is the plain ``_grouped_attn`` under a causal
    mask (JAX computes it in XLA, outside any Pallas kernel)."""
    n, d = cfg.num_attention_heads, cfg.head_dim
    nkv = cfg.num_key_value_heads
    dt = cfg.dtype

    def prefill(params, prompt):
        B, S = prompt.shape
        x = params["embed"][prompt.long()].to(dt)
        causal = torch.tril(torch.ones((S, S), dtype=torch.bool,
                                       device=x.device))
        L = cfg.num_hidden_layers
        ks = torch.empty((L, B, S, nkv, d), dtype=dt, device=x.device)
        vs = torch.empty((L, B, S, nkv, d), dtype=dt, device=x.device)
        for layer in range(L):
            bp = layer_params(params, layer)
            y = _rms_norm(x, bp["ln1"], cfg.rms_norm_eps)
            q = _mm(y, bp["wq"], dt).reshape(B, S, n, d)
            k = _mm(y, bp["wk"], dt).reshape(B, S, nkv, d)
            v = _mm(y, bp["wv"], dt).reshape(B, S, nkv, d)
            q, k = _rope(q, k, cfg.rope_theta)
            attn = _grouped_attn(q, k, v, causal[None, None, None])
            x = _block_post_attn(bp, x, attn, cfg)
            ks[layer] = k
            vs[layer] = v
        return x, ks, vs

    return prefill


def _prefill_chunk(cfg: LlamaPretrainConfig, q8: bool):
    """Chunked prefill with history: advance one row's prefill by a chunk,
    attending over the row's cached pages and causally within the chunk.

    ``run(params, toks [1, C], kpool, vpool, kscale, vscale,
    table [pages_max], ctx_len) -> (x [1, C, H], ks, vs [Lyr, C, nkv, d])``

    The row's pages are gathered (and, with ``q8``, dequantized by their
    scales) into a ``[1, pages_max * page, nkv, d]`` context; slots at or
    past ``ctx_len`` are masked.  Chunk tokens sit at ``ctx_len +
    arange(C)`` (inline RoPE, the form the decode step writes).  The
    chunk's K/V come back unquantized; the page write quantizes.
    ``kscale`` / ``vscale`` are ignored for fp pages."""
    n, d = cfg.num_attention_heads, cfg.head_dim
    nkv = cfg.num_key_value_heads
    dt = cfg.dtype

    def run(params, toks, kpool, vpool, kscale, vscale, table, ctx_len):
        B, C = toks.shape                      # B == 1
        P = table.shape[0]
        page = kpool.shape[3]
        S_ctx = P * page
        dev = kpool.device
        x = params["embed"][toks.long()].to(dt)
        ctx_len = torch.as_tensor(ctx_len, dtype=torch.int32, device=dev)
        pos = ctx_len + torch.arange(C, dtype=torch.int32, device=dev)
        # visibility: cached slots below ctx_len, then causal in the chunk
        ctx_vis = torch.arange(S_ctx, dtype=torch.int32, device=dev) < ctx_len
        mask = torch.cat(
            [ctx_vis[None].expand(C, S_ctx),
             torch.tril(torch.ones((C, C), dtype=torch.bool, device=dev))],
            dim=1)[None, None, None]           # [1, 1, 1, C, S_ctx + C]
        tbl = table.long()

        def gather_ctx(pool, scale):
            pages = pool[tbl]                  # [P, nkv, page, d]
            if q8:
                pages = pages.float() * scale[tbl][..., None]
            return pages.permute(0, 2, 1, 3).reshape(
                1, S_ctx, nkv, d).to(dt)

        L = cfg.num_hidden_layers
        ks = torch.empty((L, C, nkv, d), dtype=dt, device=dev)
        vs = torch.empty((L, C, nkv, d), dtype=dt, device=dev)
        for layer in range(L):
            bp = layer_params(params, layer)
            y = _rms_norm(x, bp["ln1"], cfg.rms_norm_eps)
            q = _mm(y, bp["wq"], dt).reshape(B, C, n, d)
            k = _mm(y, bp["wk"], dt).reshape(B, C, nkv, d)
            v = _mm(y, bp["wv"], dt).reshape(B, C, nkv, d)
            q = _rope_at(q, cfg.rope_theta, pos)
            k = _rope_at(k, cfg.rope_theta, pos)
            ksl = kscale[layer] if q8 else None
            vsl = vscale[layer] if q8 else None
            ck = torch.cat([gather_ctx(kpool[layer], ksl), k], dim=1)
            cv = torch.cat([gather_ctx(vpool[layer], vsl), v], dim=1)
            attn = _grouped_attn(q, ck, cv, mask)
            x = _block_post_attn(bp, x, attn, cfg)
            ks[layer] = k[0]
            vs[layer] = v[0]
        return x, ks, vs

    return run


def _packed_prefill_body(cfg: LlamaPretrainConfig, q8: bool = False,
                         with_hist: bool = False):
    """Packed varlen prefill: ``run(params, toks [1, T], seg [1, T],
    pos [1, T], kpool, vpool, kscale, vscale, hist_page [T],
    hist_slot [T], pool_hist [T], stream_src [T], stream_hist [T]) ->
    (x [1, T, H], ks, vs [Lyr, T, nkv, d])``.

    Every waiting context packs into one token stream with segment ids
    (bucket-tail padding rides a sentinel id and attends only itself);
    ``pos`` holds within-segment RoPE positions (a prefix-cache suffix
    starts at its reused offset); attention is the segment-masked causal
    kernel (its plain version on the CPU).

    Without ``with_hist`` the nine arguments after ``pos`` are ignored and
    may be left out, and ``q8`` changes nothing: JAX's q8 form only
    threads the scale pools through its scan, the stream attends over its
    own unquantized K/V, and the page write quantizes.

    ``with_hist`` is the prefix-cache form: ``pool_hist`` slots take their
    K/V from the cached pages ``kpool[:, hist_page, :, hist_slot]``
    (already rotated when written; with ``q8`` dequantized by the gathered
    scales), ``stream_hist`` slots from the stream itself at
    ``stream_src`` (a page an earlier segment of the same wave writes,
    whose pool copy lands only after this call).  History slots give K/V
    only; their q rows are dead weight nobody reads.  Then the segmented
    kernel runs over the whole stream, as without history."""
    n, d = cfg.num_attention_heads, cfg.head_dim
    nkv = cfg.num_key_value_heads
    dt = cfg.dtype

    def run(params, toks, seg, pos, kpool=None, vpool=None, kscale=None,
            vscale=None, hist_page=None, hist_slot=None, pool_hist=None,
            stream_src=None, stream_hist=None):
        B, T = toks.shape                      # B == 1
        x = params["embed"][toks.long()].to(dt)
        seg = seg.to(torch.int32).contiguous()
        L = cfg.num_hidden_layers
        ks = torch.empty((L, T, nkv, d), dtype=dt, device=x.device)
        vs = torch.empty((L, T, nkv, d), dtype=dt, device=x.device)
        if with_hist:
            hp, hs = hist_page.long(), hist_slot.long()
            sel = pool_hist.to(torch.bool)[None, :, None, None]
            sel2 = stream_hist.to(torch.bool)[None, :, None, None]
            src = stream_src.long()
        for layer in range(L):
            bp = layer_params(params, layer)
            y = _rms_norm(x, bp["ln1"], cfg.rms_norm_eps)
            q = _mm(y, bp["wq"], dt).reshape(B, T, n, d)
            k = _mm(y, bp["wk"], dt).reshape(B, T, nkv, d)
            v = _mm(y, bp["wv"], dt).reshape(B, T, nkv, d)
            q = _rope_at(q, cfg.rope_theta, pos)
            k = _rope_at(k, cfg.rope_theta, pos)
            if with_hist:
                kh = kpool[layer][hp, :, hs]             # [T, nkv, d]
                vh = vpool[layer][hp, :, hs]
                if q8:
                    kh = kh.float() * kscale[layer][hp, :, hs][..., None]
                    vh = vh.float() * vscale[layer][hp, :, hs][..., None]
                k = torch.where(sel, kh.to(dt)[None], k)
                v = torch.where(sel, vh.to(dt)[None], v)
                k = torch.where(sel2, k[:, src], k)
                v = torch.where(sel2, v[:, src], v)
            attn = flash_attention_segmented(q, k, v, seg, causal=True)
            x = _block_post_attn(bp, x, attn, cfg)
            ks[layer] = k[0]
            vs[layer] = v[0]
        return x, ks, vs

    return run


_mixed_step_cache: dict = {}


def make_mixed_step(cfg: LlamaPretrainConfig, temperature: float = 0.0,
                    kv_quant: Optional[str] = None, top_k: int = 0,
                    top_p: float = 1.0, mesh=None,
                    tp_allreduce: str = "fp32", with_hist: bool = True):
    """One call per mixed serving tick (Sarathi-style chunked-prefill
    piggybacking): advance every active decode row exactly as
    :func:`make_paged_decode_step_async` does AND prefill a budget of
    packed varlen stream tokens in the same call, so a colocated engine
    never stops decoding to admit.

    ``fn(params, kpool, vpool, [kscale, vscale,] tables, lens, tok,
    active, remaining, eos, generator, p_toks [1, T], p_seg [1, T],
    p_pos [1, T], hist_page [T], hist_slot [T], pool_hist [T],
    dest_page [T], dest_slot [T], sample_idx [B], activate [B],
    p_first [B], p_sample [B], p_len [B], p_rem [B]) -> (kpool, vpool,
    [kscale, vscale,] nxt, lens', remaining', active', done, ftok)``

    * prefill half: :func:`_packed_prefill_body` (K2 over the stream) with
      history gathered from the pool (``pool_hist`` slots; the stream never
      shares with itself: the engine registers a prefix page only after
      the tick that wrote it); each stream token's K/V then lands at
      ``dest_page`` / ``dest_slot`` (quantized per token with int8
      pages); history and padding slots land on junk page 0;
    * decode half: the per-token step over ``tables`` masked by
      ``active`` (inactive rows, parked ones included, write page 0), then
      :func:`_advance_loop_state`;
    * first tokens: each completing segment's last real position
      (``sample_idx``) through the shared logits tail; ``p_sample`` rows
      take the sampled token, the others ``p_first`` (a resume's saved
      next input); ``activate`` rows enter the chained state with
      ``lens = p_len`` and ``remaining = p_rem``.

    The pools update in place.  When sampling, the decode half draws from
    ``generator`` first, then the first tokens (JAX splits its key into
    ``k_dec`` and ``k_smp`` in that order).  Memoised per key, as JAX's
    ``_mixed_step_cache``; TP meshes raise ``NotImplementedError``."""
    if kv_quant not in (None, "int8"):
        raise ValueError("kv_quant must be None or 'int8'")
    if mesh is not None:
        raise NotImplementedError(
            "the TP mixed step (mp > 1 meshes) is not ported yet")
    q8 = kv_quant == "int8"
    ckey = (dataclasses.astuple(cfg), temperature, kv_quant, top_k, top_p,
            with_hist)
    hit = _mixed_step_cache.get(ckey)
    if hit is not None:
        return hit
    dt = cfg.dtype
    step, step_q8 = _build_step_fns(cfg, temperature, False, top_k, top_p)
    pre_body = _packed_prefill_body(cfg, q8, with_hist)

    def scatter(kpool, vpool, kscale, vscale, ks, vs, dest_page, dest_slot):
        # [L, T, nkv, d] -> [T, L, nkv, d]: the advanced indices at dims 1
        # and 3 of the pool put T first, as in JAX
        if q8:
            ks, ksc = quantize_kv_token(ks)
            vs, vsc = quantize_kv_token(vs)
            kscale[:, dest_page, :, dest_slot] = ksc.permute(1, 0, 2)
            vscale[:, dest_page, :, dest_slot] = vsc.permute(1, 0, 2)
        kpool[:, dest_page, :, dest_slot] = ks.permute(1, 0, 2, 3).to(
            kpool.dtype)
        vpool[:, dest_page, :, dest_slot] = vs.permute(1, 0, 2, 3).to(
            vpool.dtype)

    npools = 4 if q8 else 2

    def fn(params, *args):
        pools = args[:npools]
        (tables, lens, tok, active, remaining, eos, generator, p_toks, p_seg,
         p_pos, hist_page, hist_slot, pool_hist, dest_page, dest_slot,
         sample_idx, activate, p_first, p_sample, p_len,
         p_rem) = args[npools:]
        kpool, vpool = pools[:2]
        kscale, vscale = pools[2:] if q8 else (None, None)
        T = p_toks.shape[1]
        dev = p_toks.device
        x, ks, vs = pre_body(
            params, p_toks, p_seg, p_pos, kpool, vpool, kscale, vscale,
            hist_page, hist_slot, pool_hist,
            torch.zeros((T,), dtype=torch.int32, device=dev),
            torch.zeros((T,), dtype=torch.bool, device=dev))
        scatter(kpool, vpool, kscale, vscale, ks, vs, dest_page.long(),
                dest_slot.long())
        del ks, vs
        active = active.to(torch.bool)
        activate = activate.to(torch.bool)
        tables_d = torch.where(active[:, None], tables,
                               torch.zeros_like(tables))
        if q8:
            *_, nxt = step_q8(params, kpool, vpool, kscale, vscale, tables_d,
                              lens, tok, generator)
        else:
            *_, nxt = step(params, kpool, vpool, tables_d, lens, tok,
                           generator)
        nxt, lens2, rem2, act2, done = _advance_loop_state(
            nxt, tok, lens, active, remaining, eos)
        # the first tokens, drawn after the decode half's
        h = _rms_norm(x[0, sample_idx.long()], params["final_norm"],
                      cfg.rms_norm_eps)
        logits = _mm(h, params["lm_head"], dt).float()
        sampled = _pick_token(logits, temperature, generator, top_k, top_p)
        ftok = torch.where(p_sample.to(torch.bool),
                           sampled.to(p_first.dtype), p_first)
        nxt = torch.where(activate, ftok.to(nxt.dtype), nxt)
        lens2 = torch.where(activate, p_len.to(lens2.dtype), lens2)
        rem2 = torch.where(activate, p_rem.to(rem2.dtype), rem2)
        act2 = act2 | activate
        return (*pools, nxt, lens2, rem2, act2, done, ftok)

    _mixed_step_cache[ckey] = fn
    return fn


_spec_verify_cache: dict = {}


def _spec_verify_body(cfg: LlamaPretrainConfig, q8: bool):
    """The batched verify-with-history body of a speculative round:
    ``run(params, toks [B, C], kpool, vpool, kscale, vscale, tables
    [B, P], ctx_len [B]) -> (x [B, C, H], ks, vs [Lyr, B, C, nkv, d])``.

    Every row scores its C candidates at its own offset over its own
    cached pages: the row's pages are gathered (with ``q8`` dequantized by
    the scale planes gathered through the same tables) into a ``[B, P *
    page, nkv, d]`` context, slots at or past the row's ``ctx_len`` are
    masked, and the candidates attend causally among themselves at
    positions ``ctx_len + arange(C)`` (inline RoPE, the form the decode
    step writes).  With ``q8`` the fresh K/V the candidates attend to are
    round-tripped through ``quantize_kv_token`` first, as the per-token q8
    step reads its own token back from the pool (without it a multi-token
    round drifts off that step); the returned ``ks`` / ``vs`` stay
    unquantized (the scatter quantizes).  ``kscale`` / ``vscale`` are
    ignored for fp pages.  Attention is the plain ``_grouped_attn`` (JAX
    computes it in XLA, outside any Pallas kernel).  Memoised per (cfg,
    q8)."""
    ckey = (dataclasses.astuple(cfg), q8)
    hit = _spec_verify_cache.get(ckey)
    if hit is not None:
        return hit
    n, d = cfg.num_attention_heads, cfg.head_dim
    nkv = cfg.num_key_value_heads
    dt = cfg.dtype

    def qdq(t):
        tq, sc = quantize_kv_token(t)
        return (tq.float() * sc[..., None]).to(dt)

    def run(params, toks, kpool, vpool, kscale, vscale, tables, ctx_len):
        B, C = toks.shape
        P = tables.shape[1]
        page = kpool.shape[3]
        S_ctx = P * page
        dev = kpool.device
        x = params["embed"][toks.long()].to(dt)
        ctx_len = ctx_len.to(torch.int32)
        pos = ctx_len[:, None] + torch.arange(C, dtype=torch.int32,
                                              device=dev)       # [B, C]
        ctx_vis = (torch.arange(S_ctx, dtype=torch.int32, device=dev)[None]
                   < ctx_len[:, None])                           # [B, S_ctx]
        tri = torch.tril(torch.ones((C, C), dtype=torch.bool, device=dev))
        mask = torch.cat([ctx_vis[:, None].expand(B, C, S_ctx),
                          tri[None].expand(B, C, C)], dim=2)
        mask = mask[:, None, None]               # [B, 1, 1, C, S_ctx + C]
        tbl = tables.long()

        def gather_ctx(pool, scale):
            pages = pool[tbl]                    # [B, P, nkv, page, d]
            if q8:
                pages = pages.float() * scale[tbl][..., None]
            return pages.permute(0, 1, 3, 2, 4).reshape(
                B, S_ctx, nkv, d).to(dt)

        L = cfg.num_hidden_layers
        ks = torch.empty((L, B, C, nkv, d), dtype=dt, device=dev)
        vs = torch.empty((L, B, C, nkv, d), dtype=dt, device=dev)
        for layer in range(L):
            bp = layer_params(params, layer)
            y = _rms_norm(x, bp["ln1"], cfg.rms_norm_eps)
            q = _mm(y, bp["wq"], dt).reshape(B, C, n, d)
            k = _mm(y, bp["wk"], dt).reshape(B, C, nkv, d)
            v = _mm(y, bp["wv"], dt).reshape(B, C, nkv, d)
            q = _rope_at(q, cfg.rope_theta, pos)
            k = _rope_at(k, cfg.rope_theta, pos)
            ku, vu = (qdq(k), qdq(v)) if q8 else (k, v)
            ksl = kscale[layer] if q8 else None
            vsl = vscale[layer] if q8 else None
            ck = torch.cat([gather_ctx(kpool[layer], ksl), ku], dim=1)
            cv = torch.cat([gather_ctx(vpool[layer], vsl), vu], dim=1)
            attn = _grouped_attn(q, ck, cv, mask)
            x = _block_post_attn(bp, x, attn, cfg)
            ks[layer] = k
            vs[layer] = v
        return x, ks, vs

    _spec_verify_cache[ckey] = run
    return run


def _prefill_chunk_batched(cfg: LlamaPretrainConfig):
    """The batched prefill-with-history: advance every row's context by a
    chunk at its own offset, ``run(params, toks [B, C], kpool, vpool,
    tables [B, P], ctx_len [B]) -> (x [B, C, H], ks, vs [Lyr, B, C, nkv,
    d])``, over fp pages.  It is :func:`_spec_verify_body` without the
    scale planes: one target forward scores all rows' candidate blocks
    (per-row tables, positions and visibility)."""
    body = _spec_verify_body(cfg, False)

    def run(params, toks, kpool, vpool, tables, ctx_len):
        return body(params, toks, kpool, vpool, None, None, tables, ctx_len)

    return run


def _spec_dest(tables, lens, active, C: int, page: int):
    """Where a round's C fresh K/V per row land: ``(dest_page, dest_slot)``
    ``[B * C]`` long, row-major.  Position ``lens + j`` goes to its table
    page and slot; inactive rows and positions at or past the table's
    capacity go to junk page 0."""
    S_ctx = tables.shape[1] * page
    pos = lens[:, None].long() + torch.arange(C, device=lens.device)
    ok = active[:, None] & (pos < S_ctx)
    pidx = torch.where(ok, pos // page, torch.zeros_like(pos))
    dest = torch.where(ok, torch.gather(tables.long(), 1, pidx),
                       torch.zeros_like(pos))
    return dest.reshape(-1), (pos % page).reshape(-1)


_spec_step_cache: dict = {}


def make_spec_step(cfg: LlamaPretrainConfig, gamma: int,
                   draft_cfg: Optional[LlamaPretrainConfig] = None,
                   kv_quant: Optional[str] = None,
                   draft_kv_quant: Optional[str] = None,
                   mesh=None, tp_allreduce: str = "fp32"):
    """One call per speculative serving round: the draft (a draft model's
    gamma + 1 decode micro-steps, or proposals from the host), the batched
    target verify over the cached pages, the scatter of the fresh K/V into
    the target pages and the accept fold, with no host read between them.
    The engine pays one dispatch and one fetch a round of up to gamma + 1
    committed tokens a row, and the chained loop state feeds the next round.
    Greedy only: the round commits the longest prefix of drafts that match
    the target's argmax, then the target's own token, so the output is the
    target's plain greedy sequence token for token.

    With ``draft_cfg`` (draft-model drafting), ``C = gamma + 1``:

    ``fn(params, dparams, kpool, vpool, [kscale, vscale,] dkpool, dvpool,
    [dkscale, dvscale,] tables, dtables, lens, tok, prev, active,
    remaining, spec_on, eos) -> (pools..., dpools..., toks [C, B], dones
    [C, B], emits [C, B], accepts [B], tok', prev', lens', remaining',
    active')``

    * draft: C micro-steps of the draft's decode body.  Micro-step 0 feeds
      ``prev`` (the second-to-last committed token) at draft position
      ``lens - 1``: a rewrite of the same value when the draft cache is
      caught up, and the write that realigns it after a full accept left
      it one position behind; micro-steps 1..gamma feed ``tok``, d1, ...
      and produce the drafts.  Inactive and spec-off rows write draft page
      0 through a masked view of ``dtables``;
    * verify: every candidate ``[tok, d1..dgamma]`` scored at its row's
      offset (:func:`_spec_verify_body`), greedy ``argmax`` of the logits,
      and the C fresh K/V scattered into the target pages
      (:func:`_spec_dest`: inactive rows and positions past the table go
      to junk page 0; int8 pools quantize on the way in).  The engine
      claims gamma + 1 tokens of pages a row, so real writes land in
      claimed pages; K/V past the committed length are masked stale until
      a later round writes them again;
    * accept fold: C steps mirroring :func:`_advance_loop_state` under the
      window ``j < accepts + 1``: ``toks[j]`` / ``dones[j]`` / ``emits[j]``
      are step j's committed token, just-retired rows and validity.
      Spec-off rows commit exactly their plain greedy token (their window
      is 1), so per-request on / off mixes in one round;
    * ``accepts`` is the raw accepted-draft count a row (before eos and
      budget truncation), for the acceptance counters.

    Without ``draft_cfg`` (prompt lookup, or any host draft source) the
    draft half, the draft pools, ``dtables`` and ``prev`` drop out and the
    candidates arrive as ``drafts [B, gamma]``:

    ``fn(params, kpool, vpool, [kscale, vscale,] tables, lens, tok,
    drafts, active, remaining, spec_on, eos) -> (pools..., toks, dones,
    emits, accepts, tok', lens', remaining', active')``

    The outputs keep JAX's layout.  JAX's trailing PRNG key has no
    counterpart (the round is greedy).  The pools update in place and are
    returned; ``kv_quant`` / ``draft_kv_quant`` select the int8 pool forms
    of each cache.  Memoised per (cfg, draft cfg, gamma, kv_quant,
    draft_kv_quant), as JAX's ``_spec_step_cache``.  TP meshes raise
    ``NotImplementedError`` (ROADMAP.md queue 1 item 7)."""
    G = int(gamma)
    if G < 1:
        raise ValueError(f"gamma must be >= 1, got {gamma}")
    if kv_quant not in (None, "int8") or draft_kv_quant not in (None, "int8"):
        raise ValueError("kv_quant must be None or 'int8'")
    if mesh is not None:
        raise NotImplementedError(
            "the TP speculative round (mp > 1 meshes) is not ported yet "
            "(ROADMAP.md queue 1 item 7)")
    C = G + 1
    q8 = kv_quant == "int8"
    dq8 = draft_kv_quant == "int8"
    draft = draft_cfg is not None
    ckey = (dataclasses.astuple(cfg),
            dataclasses.astuple(draft_cfg) if draft else None, G, kv_quant,
            draft_kv_quant if draft else None)
    hit = _spec_step_cache.get(ckey)
    if hit is not None:
        return hit
    dt = cfg.dtype
    verify = _spec_verify_body(cfg, q8)
    dbase = None
    if draft:
        dstep, dstep_q8 = _build_step_fns(draft_cfg, 0.0, False, 0, 1.0)
        dbase = dstep_q8 if dq8 else dstep

    def core(params, dparams, kpool, vpool, kscale, vscale, dpools, tables,
             dtables, lens, tok, prev, drafts_in, active, remaining, spec_on,
             eos):
        page = kpool.shape[3]
        active = active.to(torch.bool)
        spec_on = spec_on.to(torch.bool)
        if draft:
            # the draft half: C chained micro-steps (catch-up, tok, then the
            # drafts feeding themselves); inactive / spec-off rows write
            # draft page 0
            dtab = torch.where((active & spec_on)[:, None], dtables,
                               torch.zeros_like(dtables))
            feed = prev
            outs = []
            for i in range(C):
                f = prev if i == 0 else (tok if i == 1 else feed)
                dl = torch.clamp(lens - 1 + i, min=0)
                *_, out = dbase(dparams, *dpools, dtab, dl, f)
                feed = out.to(tok.dtype)
                outs.append(feed)
            d = torch.stack(outs[1:], dim=1)                     # [B, G]
        else:
            d = drafts_in.to(tok.dtype)

        # the verify half: every candidate at its row's offset, then the
        # shared logits tail (greedy)
        cand = torch.cat([tok[:, None], d], dim=1)               # [B, C]
        x, ks, vs = verify(params, cand, kpool, vpool, kscale, vscale,
                           tables, lens)
        h = _rms_norm(x, params["final_norm"], cfg.rms_norm_eps)
        logits = _mm(h, params["lm_head"], dt).float()           # [B, C, V]
        g = _pick_token(logits, 0.0).to(tok.dtype)               # [B, C]
        del x, h, logits

        # the C fresh K/V a row into the target pages: [Lyr, B, C, nkv, d]
        # -> [B * C, Lyr, nkv, d] (the advanced indices at dims 1 and 3 of
        # the pool put B * C first)
        dp, ds = _spec_dest(tables, lens, active, C, page)
        Lyr = ks.shape[0]
        ksf = ks.reshape(Lyr, -1, *ks.shape[3:])
        vsf = vs.reshape(Lyr, -1, *vs.shape[3:])
        if q8:
            ksf, ksc = quantize_kv_token(ksf)
            vsf, vsc = quantize_kv_token(vsf)
            kscale[:, dp, :, ds] = ksc.permute(1, 0, 2)
            vscale[:, dp, :, ds] = vsc.permute(1, 0, 2)
        kpool[:, dp, :, ds] = ksf.permute(1, 0, 2, 3).to(kpool.dtype)
        vpool[:, dp, :, ds] = vsf.permute(1, 0, 2, 3).to(vpool.dtype)
        del ks, vs, ksf, vsf

        # the accept fold: the longest matching prefix plus the correction
        # token commits g[:, :k + 1]; spec-off rows collapse to 1 token
        match = (d == g[:, :G]) & spec_on[:, None] & active[:, None]
        k_acc = torch.cumprod(match.to(torch.int32), dim=1).sum(dim=1)
        n_acc = k_acc + 1
        tok_c, prev_c, lens_c, rem_c, alive = tok, prev, lens, remaining, \
            active
        toks, dones, emits = [], [], []
        for j in range(C):
            em = alive & (j < n_acc)
            nxt = torch.where(em, g[:, j], tok_c)
            prev_c = torch.where(em, tok_c, prev_c)
            lens_c = lens_c + em.to(lens_c.dtype)
            rem_c = rem_c - em.to(rem_c.dtype)
            done = em & ((nxt == eos) | (rem_c <= 0))
            alive = alive & ~done
            tok_c = nxt
            toks.append(nxt)
            dones.append(done)
            emits.append(em)
        return (torch.stack(toks), torch.stack(dones), torch.stack(emits),
                k_acc, tok_c, prev_c, lens_c, rem_c, alive)

    npools = 4 if q8 else 2
    ndpools = (4 if dq8 else 2) if draft else 0

    def fn(*args):
        it = iter(args)
        params = next(it)
        dparams = next(it) if draft else None
        pools = [next(it) for _ in range(npools)]
        dpools = [next(it) for _ in range(ndpools)]
        tables = next(it)
        dtables = next(it) if draft else None
        lens, tok = next(it), next(it)
        prev = next(it) if draft else tok
        drafts_in = None if draft else next(it)
        active, remaining, spec_on, eos = next(it), next(it), next(it), \
            next(it)
        kscale, vscale = pools[2:] if q8 else (None, None)
        (toks, dones, emits, k_acc, tok_f, prev_f, lens_f, rem_f,
         act_f) = core(params, dparams, pools[0], pools[1], kscale, vscale,
                       dpools, tables, dtables, lens, tok, prev, drafts_in,
                       active, remaining, spec_on, eos)
        chain = ((tok_f, prev_f) if draft else (tok_f,)) + (lens_f, rem_f,
                                                            act_f)
        return (*pools, *dpools, toks, dones, emits, k_acc, *chain)

    _spec_step_cache[ckey] = fn
    return fn


def generate_paged(cfg: LlamaPretrainConfig, params, prompt,
                   max_new_tokens: int, cache: PagedKVCache,
                   temperature: float = 0.0, seed: int = 0,
                   fused: bool = True, top_k: int = 0, top_p: float = 1.0):
    """Generate with the paged cache: the dense prefill (:func:`_prefill`)
    of ``prompt [B, S]``, each row's K/V written into the pages the caller
    claimed (``cache.alloc_row(b, len_b)``; rows keep their own lengths,
    the prompt is right-padded), then the paged decode tail.
    ``fused=True`` pre-claims every page the tail touches and runs it
    through :func:`make_paged_generate_fused` with no host read until the
    end; ``fused=False`` drives the per-token step from the host (the
    serving loop's form).  Sampling draws from a generator seeded with
    ``seed`` (JAX draws from ``PRNGKey(seed)``: equal in distribution, not
    bit for bit).  -> ``[B, max_new_tokens]`` int64 tokens."""
    dev = cache.device
    dt = cfg.dtype
    prompt = torch.as_tensor(np.asarray(prompt) if not torch.is_tensor(
        prompt) else prompt).to(dev)
    B, S = prompt.shape
    page = cache.page
    lens_np = cache.lens.copy()      # the caller claimed via alloc_row
    x, ks, vs = _prefill(cfg)(params, prompt)
    S_pad = -(-S // page) * page
    if S_pad > S:
        pad = (0, 0, 0, 0, 0, S_pad - S)       # the slots past the prompt
        ks = torch.nn.functional.pad(ks, pad)
        vs = torch.nn.functional.pad(vs, pad)
    cache.write_pages_batch([(b, ks[:, b], vs[:, b], int(lens_np[b]), 0)
                             for b in range(B)])
    del ks, vs
    q8 = cache.kv_quant == "int8"
    gen = torch.Generator(device=dev).manual_seed(seed)
    last = torch.as_tensor(lens_np - 1, dtype=torch.long, device=dev)
    h = _rms_norm(x[torch.arange(B, device=dev), last],
                  params["final_norm"], cfg.rms_norm_eps)
    logits = _mm(h, params["lm_head"], dt).float()
    tok = _pick_token(logits, temperature, gen, top_k, top_p)
    pools = ((cache.kpool, cache.vpool, cache.kscale, cache.vscale) if q8
             else (cache.kpool, cache.vpool))
    if fused:
        saved_lens = cache.lens.copy()
        cache.ensure_capacity_batch([(b, max_new_tokens) for b in range(B)])
        run = make_paged_generate_fused(cfg, max_new_tokens, temperature,
                                        kv_quant=cache.kv_quant,
                                        top_k=top_k, top_p=top_p)
        scales = pools[2:] if q8 else (None, None)
        *_, toks = run(params, cache.kpool, cache.vpool, *scales,
                       torch.from_numpy(cache.tables.copy()).to(dev),
                       torch.from_numpy(saved_lens).to(dev), tok, gen)
        cache.lens = saved_lens + max_new_tokens - 1
        return toks.t()
    step = make_paged_decode_step(cfg, temperature, kv_quant=cache.kv_quant,
                                  top_k=top_k, top_p=top_p)
    out = [tok]
    for _ in range(max_new_tokens - 1):
        cache.ensure_capacity_batch([(b, 1) for b in range(B)])
        tables = torch.from_numpy(cache.tables.copy()).to(dev)
        lens = torch.from_numpy(cache.lens.copy()).to(dev)
        *_, tok = step(params, *pools, tables, lens, tok, gen)
        cache.lens = cache.lens + 1
        out.append(tok)
    return torch.stack(out, dim=1)


def generate_auto(cfg: LlamaPretrainConfig, params, prompts,
                  max_new_tokens: int, temperature: float = 0.0,
                  seed: int = 0, page: int = 64,
                  cache: Optional[PagedKVCache] = None):
    """JAX's adaptive router between the two decode paths:

    * equal-length prompts and no caller cache -> the dense cache of
      :func:`~paddle_tpu_torch.models.decode.make_generate`;
    * ragged lengths (or a caller's cache) -> the paged path: each row
      claims its pages (``cache.alloc_row``) and :func:`generate_paged`
      decodes them (on a cache of its own made on the params' device when
      none is given).

    ``prompts``: a list of 1-D token sequences (possibly ragged) or a ``[B,
    S]`` array / tensor.  Sampling at ``temperature > 0`` draws from a
    generator seeded with ``seed``.  -> ``[B, max_new_tokens]`` int64."""
    from .decode import make_generate
    if isinstance(prompts, (list, tuple)):
        rows = [np.asarray(p) for p in prompts]
    else:
        arr = prompts.cpu().numpy() if torch.is_tensor(prompts) else \
            np.asarray(prompts)
        rows = list(arr)
    lens = [len(r) for r in rows]
    dev = params["embed"].device
    if cache is None and len(set(lens)) == 1:
        gen = make_generate(cfg, prompt_len=int(lens[0]),
                            max_new_tokens=max_new_tokens,
                            temperature=temperature)
        return gen(params, torch.as_tensor(np.stack(rows), device=dev),
                   seed)
    B, S = len(lens), max(lens)
    padded = np.zeros((B, S), np.int64)
    for b, r in enumerate(rows):
        padded[b, :lens[b]] = r
    if cache is None:
        pages_max = (S + max_new_tokens + page - 1) // page
        total = sum((n + max_new_tokens + page - 1) // page
                    for n in lens) + 1
        cache = PagedKVCache(cfg, num_pages=total, pages_max=pages_max,
                             batch=B, page=page, device=dev)
    for b, n in enumerate(lens):
        cache.alloc_row(b, n)
    return generate_paged(cfg, params, padded, max_new_tokens, cache,
                          temperature=temperature, seed=seed)
