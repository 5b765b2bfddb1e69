"""Host-RAM page tier of the paged KV cache (the two-tier cache).

Counterpart of ``paddle_tpu/models/kv_offload.py``.  A preempted row's
pages are gathered off the device pools in one batched dispatch and parked
here instead of being thrown away, and restored with one batched indexed
copy when the request comes back: zero prefill tokens on resume.  The same
tier backs the prefix cache: evicted cached prefix pages demote here and a
later lookup promotes them back, so the prefix cache's depth scales with
host RAM rather than with the device pool.

Layout: page-major buffers ``[host_pages, L, nkv, page, d]`` of the device
pool's dtype (int8 pools also carry their ``[host_pages, L, nkv, page]``
f32 scale planes), so a round trip is bitwise and every page's block is one
contiguous run of host memory.

Transfers.  On a CUDA cache the buffers are pinned and the device -> host
leg runs on a side stream: :meth:`stage` records an event on the compute
stream after the caller's gather, the side stream waits on it, each run of
consecutive host pages is one ``non_blocking`` copy into the pinned buffer,
and an event recorded behind the copies marks them done.  The gathered
device blocks stay referenced by the pending entry (and are recorded on the
side stream) until that event has been waited on, so the caching allocator
cannot hand their memory to the next decode step.  :meth:`flush` (the
engine's scheduler-mutation points) and :meth:`gather` (before any read)
wait on the events; :meth:`free` waits only on the batches that write the
freed page.  The host -> device leg (:meth:`gather`) copies each run from
the pinned buffer on the compute stream, ahead of the caller's restore.  A
later stage into a recycled host page waits on a compute-stream event
recorded after that read, so it cannot overwrite a page still being read.
On a CPU cache (``device="cpu"``) the buffers are ordinary CPU tensors and
every copy is synchronous.

The tensor-parallel form (per-shard staging of a kv-head-sharded pool) is
not ported: ``PagedKVCache(mesh=...)`` raises (ROADMAP.md queue 1 item 7).
"""

from __future__ import annotations

from typing import List, Optional

import torch

from ..testing import faults

__all__ = ["HostPagePool"]

# staged copies are waited on once this many batches accumulate: bounds the
# device blocks a lazy reader keeps alive
_MAX_PENDING = 16


def _runs(hids):
    """``(i, h0, r)`` for each run of consecutive host pages in ``hids``:
    blocks ``i .. i + r`` of a gathered batch map to pages ``h0 .. h0 + r``."""
    out = []
    i = 0
    while i < len(hids):
        r = 1
        while i + r < len(hids) and hids[i + r] == hids[i] + r:
            r += 1
        out.append((i, int(hids[i]), r))
        i += r
    return out


class HostPagePool:
    """Free-list allocator over host page buffers that mirror the device
    pool's pages.  Host page ids ("hids") are a namespace of their own."""

    def __init__(self, cfg, host_pages: int, page: int, dtype,
                 kv_quant: Optional[str] = None, device=None):
        if host_pages < 1:
            raise ValueError("host_pages must be >= 1")
        L = cfg.num_hidden_layers
        nkv, d = cfg.num_key_value_heads, cfg.head_dim
        self.num_pages = int(host_pages)
        self.page = page
        self.kv_quant = kv_quant
        self.device = torch.device("cpu" if device is None else device)
        pin = self.device.type == "cuda"

        def buf(shape, dt):
            t = torch.zeros(shape, dtype=dt, pin_memory=pin)
            if pin and not t.is_pinned():
                raise RuntimeError(
                    "the host page tier of a CUDA cache needs pinned memory "
                    "and could not pin its buffer")
            return t

        shape = (self.num_pages, L, nkv, page, d)
        self.kbuf = buf(shape, dtype)
        self.vbuf = buf(shape, dtype)
        self.kscale = self.vscale = None
        if kv_quant == "int8":
            self.kscale = buf(shape[:-1], torch.float32)
            self.vscale = buf(shape[:-1], torch.float32)
        self._free: List[int] = list(range(self.num_pages - 1, -1, -1))
        # staged device -> host copies: (hids, device blocks, event after
        # the copies; None on the CPU, where the copy is already done)
        self._pending: List = []
        # host -> device reads still in flight: (hids, event after the
        # copies); a host-side write into one of those pages waits on it
        self._reads: List = []
        self._side = (torch.cuda.Stream(device=self.device) if pin
                      else None)

    @property
    def nbytes(self) -> int:
        """Host bytes the tier holds (pinned on a CUDA cache)."""
        return sum(b.numel() * b.element_size() for b in self._bufs()
                   if b is not None)

    def _bufs(self):
        return (self.kbuf, self.vbuf, self.kscale, self.vscale)

    # -- allocator --------------------------------------------------------
    def free_pages(self) -> int:
        return len(self._free)

    def used_pages(self) -> int:
        return self.num_pages - len(self._free)

    def alloc(self) -> int:
        # fault seam: an exception rule on "host_pool_full" fails the
        # allocator itself (a condition rule zeroes
        # PagedKVCache.host_available, so the cost model degrades first)
        faults.fire("host_pool_full")
        if not self._free:
            raise RuntimeError("host KV page pool exhausted")
        return self._free.pop()

    def free(self, hid: int) -> None:
        # a staged write to this page must land before the page is reused;
        # only the batches that write it are waited on
        hit = [e for e in self._pending if hid in e[0]]
        if hit:
            self._pending = [e for e in self._pending if hid not in e[0]]
            self._wait(hit)
        self._free.append(hid)

    # -- device -> host ---------------------------------------------------
    def stage(self, hids: List[int], k, v, ks=None, vs=None) -> None:
        """Copy a gathered batch of pages (``k`` / ``v``: ``[len(hids), L,
        nkv, page, d]`` on the cache's device, page-major; ``ks`` / ``vs``
        their scale planes on an int8 pool) into host pages ``hids``.  On
        a CUDA cache the copies run on the side stream behind the compute
        stream's gather and overlap whatever the device runs next."""
        hids = [int(h) for h in hids]
        pairs = [(self.kbuf, k), (self.vbuf, v)]
        if self.kscale is not None:
            pairs += [(self.kscale, ks), (self.vscale, vs)]
        runs = _runs(hids)
        event = None
        if self._side is not None:
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(self.device))
            self._side.wait_event(ready)
            with torch.cuda.stream(self._side):
                for buf, blk in pairs:
                    blk.record_stream(self._side)
                    for i, h0, r in runs:
                        buf[h0:h0 + r].copy_(blk[i:i + r], non_blocking=True)
                event = torch.cuda.Event()
                event.record(self._side)
        else:
            for buf, blk in pairs:
                for i, h0, r in runs:
                    buf[h0:h0 + r].copy_(blk[i:i + r])
        self._pending.append((hids, [blk for _, blk in pairs], event))
        if len(self._pending) >= _MAX_PENDING:
            self.flush()

    def flush(self) -> None:
        """Wait for every staged copy (the swap-out path's one blocking
        point) and drop the device blocks they read."""
        pending, self._pending = self._pending, []
        self._wait(pending)

    @staticmethod
    def _wait(entries) -> None:
        for _, _, event in entries:
            if event is not None:
                event.synchronize()

    # -- host -> device (the caller restores) ------------------------------
    def gather(self, hids: List[int]):
        """Page blocks of ``hids`` on the cache's device for a batched
        restore, after every pending write has landed.  -> ``(k, v, kscale,
        vscale)``, page-major (scales ``None`` for a non-int8 pool).  On a
        CUDA cache each run is one ``non_blocking`` copy from the pinned
        buffer on the compute stream."""
        self.flush()
        hids = [int(h) for h in hids]
        out = []
        for buf in self._bufs():
            if buf is None:
                out.append(None)
            elif self._side is None:
                out.append(buf[torch.as_tensor(hids, dtype=torch.long)])
            else:
                dst = torch.empty((len(hids),) + tuple(buf.shape[1:]),
                                  dtype=buf.dtype, device=self.device)
                for i, h0, r in _runs(hids):
                    dst[i:i + r].copy_(buf[h0:h0 + r], non_blocking=True)
                out.append(dst)
        if self._side is not None:
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(self.device))
            self._reads = [e for e in self._reads if not e[1].query()]
            self._reads.append((set(hids), event))
        return tuple(out)

    # -- host-side access (the cross-cache KV hand-off) --------------------
    def read(self, hids: List[int]):
        """Host copies of pages ``hids`` after every pending write has
        landed: ``(k, v, kscale, vscale)`` as CPU tensors, page-major
        (scales ``None`` for a non-int8 pool)."""
        self.flush()
        idx = torch.as_tensor([int(h) for h in hids], dtype=torch.long)
        return tuple(None if buf is None else buf.index_select(0, idx)
                     for buf in self._bufs())

    def write(self, hids: List[int], k, v, ks=None, vs=None) -> None:
        """Fill host pages ``hids`` from host blocks (page-major, the pool's
        layout).  Waits first for any device read of those pages still in
        flight (a page freed after a :meth:`gather` may be recycled here
        before the device has copied it) and for staged writes to them."""
        hids = [int(h) for h in hids]
        want = set(hids)
        hit = [e for e in self._pending if want & set(e[0])]
        if hit:
            self._pending = [e for e in self._pending
                             if not want & set(e[0])]
            self._wait(hit)
        for seen, event in self._reads:
            if want & seen:
                event.synchronize()
        pairs = [(self.kbuf, k), (self.vbuf, v)]
        if self.kscale is not None:
            pairs += [(self.kscale, ks), (self.vscale, vs)]
        for buf, blk in pairs:
            for i, h0, r in _runs(hids):
                buf[h0:h0 + r].copy_(blk[i:i + r])
