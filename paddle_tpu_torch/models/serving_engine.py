"""Continuous-batching LLM serving engine over the paged KV cache.

Counterpart of ``paddle_tpu/models/serving_engine.py``, synchronous lane
with packed admission (the JAX engine's defaults: ``packed=True``,
``overlap=False``, ``mixed=False``, ``decode_horizon=1``): ``submit``,
``cancel`` (and deadlines), ``step``, ``finished``, ``drain_stream``,
``run_to_completion``; admission waves pack every waiting context into one
segmented-attention prefill; decode ticks run one paged decode step for the
whole fixed-size batch; on pool exhaustion the youngest request is
preempted recompute-style and resumes through the packed lane.  Weights may
be int8 (``quantize_params_int8``) and the cache's pages int8
(``PagedKVCache(kv_quant="int8")``), each independently of the other.

Not ported yet, and refused at construction when asked for: the overlap,
mixed, horizon and speculative lanes, TP meshes, prefix caching, scheduler
policies and tenant quotas.  The fault plane and wave quarantine (a step
exception propagates to the caller), metrics and tracing also wait for
later slices.
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from .llama_pretrain import LlamaPretrainConfig, _mm, _rms_norm
from .paged_decode import (PagedKVCache, _packed_prefill_body, _pick_token,
                           make_paged_decode_step)

__all__ = ["ContinuousBatchingEngine", "QueueFullError", "Request"]


class QueueFullError(RuntimeError):
    """``submit()`` refused by the bounded admission queue
    (``max_queue_len`` / ``max_queued_tokens``).  Carries a finite
    ``retry_after`` hint (seconds) priced off the engine's observed
    throughput; the HTTP front maps it to ``429`` + ``Retry-After``."""

    def __init__(self, why: str, retry_after: float = 1.0):
        super().__init__(why)
        self.retry_after = float(retry_after)


@dataclass
class Request:
    rid: int
    prompt: np.ndarray                    # [len] int64
    max_new_tokens: int
    generated: List[int] = field(default_factory=list)
    slot: Optional[int] = None
    done: bool = False
    stop_sequences: Optional[List[List[int]]] = None
    admit_seq: int = -1                   # admission order (preemption)
    preempted: int = 0                    # times evicted + requeued
    # lifecycle timestamps (time.monotonic; 0.0 = not reached);
    # t_admit / t_first_token survive preemption
    t_submit: float = 0.0
    t_admit: float = 0.0
    t_first_token: float = 0.0
    t_finish: float = 0.0
    # absolute monotonic deadline (0.0 = none) and how the request ended:
    # "ok" (eos / stop / budget), "cancelled" or "expired"
    deadline: float = 0.0
    status: str = "ok"


class ContinuousBatchingEngine:
    """``submit()`` requests, call ``step()`` in a loop; finished requests
    appear in ``finished()``, per-token ``(rid, token)`` pairs in
    ``drain_stream()``.

    ``eos_id``: generation stops at this token (or at the request's
    ``max_new_tokens``).  The decode batch is the cache's batch size;
    packed admission streams are padded to a power-of-two number of
    ``prefill_bucket`` tokens.  Runs on the cache's device."""

    def __init__(self, cfg: LlamaPretrainConfig, params,
                 cache: PagedKVCache, eos_id: Optional[int] = None,
                 temperature: float = 0.0, seed: int = 0,
                 prefill_bucket: int = 64, mesh=None, top_k: int = 0,
                 top_p: float = 1.0, enable_prefix_caching: bool = False,
                 overlap: bool = False, packed: bool = True,
                 max_queue_len: Optional[int] = None,
                 max_queued_tokens: Optional[int] = None,
                 tp_allreduce: str = "fp32", mixed: bool = False,
                 decode_horizon: int = 1, spec=None, policy=None,
                 tenant_quotas=None):
        later = {"overlap": overlap, "mixed": mixed,
                 "decode_horizon": decode_horizon != 1,
                 "spec": spec is not None, "mesh": mesh is not None,
                 "enable_prefix_caching": enable_prefix_caching,
                 "tp_allreduce": tp_allreduce != "fp32",
                 "policy": policy is not None,
                 "tenant_quotas": tenant_quotas is not None,
                 "packed": not packed}
        asked = [k for k, on in later.items() if on]
        if asked:
            raise NotImplementedError(
                f"not ported yet: {', '.join(asked)} (this engine is the "
                f"synchronous lane with packed admission; see ROADMAP.md)")
        self.cfg = cfg
        self.params = params
        self.cache = cache
        self.device = cache.device
        self.eos_id = eos_id
        self.temperature = temperature
        self.top_k, self.top_p = top_k, top_p
        # page-aligned buckets, so the page write sees whole pages
        page = cache.page
        self.prefill_bucket = ((max(prefill_bucket, page) + page - 1)
                               // page) * page
        self.prefill_calls = 0            # admission waves dispatched
        self.prefill_token_slots = 0
        self.prefill_padded_tokens = 0
        self.decode_steps = 0
        self.tokens_generated = 0
        self.preemptions = 0
        self.requests_finished = 0
        self.requests_cancelled = 0
        self.requests_expired = 0
        self.requests_rejected = 0
        self.decode_wall_s = 0.0
        self.max_queue_len = max_queue_len
        self.max_queued_tokens = max_queued_tokens
        self._cancelled: set = set()
        self._has_deadlines = False
        self._now = time.monotonic        # seam: tests pin the clock
        self.B = cache.tables.shape[0]
        self._free_slots = list(range(self.B))
        self._queue: deque = deque()
        self._active: Dict[int, Request] = {}       # slot -> request
        self._finished: List[Request] = []
        self._next_rid = 0
        self._admit_seq = 0
        self._stream: List = []     # (rid, token) in emission order
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        self._step = make_paged_decode_step(cfg, temperature,
                                            kv_quant=cache.kv_quant,
                                            top_k=top_k, top_p=top_p)
        # int8 pages need no other prefill: write_pages_batch quantizes
        self._prefill = _packed_prefill_body(cfg)
        self._next_tok = np.zeros((self.B,), np.int64)
        self._remaining = np.zeros((self.B,), np.int64)
        self._active_mask = np.zeros((self.B,), np.int32)

    # -- client side ------------------------------------------------------
    def submit(self, prompt, max_new_tokens: int = 64,
               stop_sequences=None,
               deadline_s: Optional[float] = None) -> int:
        """Queue a request.  An empty or oversized request fails HERE
        with ``ValueError`` (never mid ``step()``); a full admission
        queue fails with :class:`QueueFullError`.

        ``stop_sequences``: token-id lists; generation retires as soon as
        the generated tail equals one of them.  ``deadline_s``: seconds
        from now after which the request is retired (queued or active)
        with ``status == "expired"``."""
        prompt = np.asarray(prompt, np.int64)
        if prompt.size == 0:
            raise ValueError(
                "prompt must contain at least one token (empty prompts "
                "cannot be admitted)")
        # bound by BOTH the row's table width and the whole pool (page 0
        # is reserved): a request the pool cannot hold even alone would
        # wedge the engine
        row_cap = min(self.cache.pages_max,
                      self.cache.num_pages - 1) * self.cache.page
        worst = len(prompt) + max_new_tokens
        if worst > row_cap:
            raise ValueError(
                f"request needs up to {worst} cache slots (prompt "
                f"{len(prompt)} + max_new_tokens {max_new_tokens}) > row "
                f"capacity {row_cap} (min(pages_max "
                f"{self.cache.pages_max}, usable pages "
                f"{self.cache.num_pages - 1}) x page {self.cache.page})")
        stops = None
        if stop_sequences is not None:
            if not isinstance(stop_sequences, (list, tuple)):
                raise ValueError(
                    "stop_sequences must be a list of token-id "
                    f"sequences, got {type(stop_sequences).__name__}")
            stops = []
            for q in stop_sequences:
                if not isinstance(q, (list, tuple, np.ndarray)) \
                        or len(q) == 0:
                    raise ValueError(
                        "each stop sequence must be a NON-EMPTY list of "
                        f"token ids, got {q!r}")
                stops.append([int(t) for t in q])
        why = self.queue_capacity_reason(len(prompt))
        if why is not None:
            self.requests_rejected += 1
            raise QueueFullError(why, retry_after=self.retry_after_s())
        deadline = 0.0
        if deadline_s is not None:
            deadline = self._now() + float(deadline_s)
            self._has_deadlines = True
        rid = self._next_rid
        self._next_rid += 1
        self._queue.append(Request(rid, prompt, max_new_tokens,
                                   stop_sequences=stops,
                                   t_submit=time.monotonic(),
                                   deadline=deadline))
        return rid

    def cancel(self, rid: int) -> bool:
        """Mark a queued or active request for cancellation; it retires at
        the start of the next ``step()`` with ``status == "cancelled"``.
        Returns False when the rid is unknown or already finished."""
        if any(r.rid == rid for r in self._queue) or \
                any(r.rid == rid for r in self._active.values()):
            self._cancelled.add(rid)
            return True
        return False

    def queued_tokens(self) -> int:
        """Context tokens of queued prefill work (a preempted request
        counts its regenerated context too)."""
        return sum(len(r.prompt) + len(r.generated)
                   for r in tuple(self._queue))

    def queue_capacity_reason(self, prompt_len: int = 0) -> Optional[str]:
        """Why the bounded admission queue would refuse a submission now,
        or ``None`` while capacity remains: the one predicate behind
        ``submit()``'s backpressure and the server's ``/health/ready``."""
        if self.max_queue_len is not None and \
                len(self._queue) >= self.max_queue_len:
            return (f"admission queue full: {len(self._queue)} waiting >= "
                    f"max_queue_len {self.max_queue_len}")
        if self.max_queued_tokens is not None:
            waiting = self.queued_tokens()
            need = max(int(prompt_len), 1)
            if waiting + need > self.max_queued_tokens:
                return (f"queued tokens {waiting} + prompt {need} > "
                        f"max_queued_tokens {self.max_queued_tokens}")
        return None

    def retry_after_s(self) -> float:
        """Back-off hint for a rejected client: queued tokens priced at
        the observed decode throughput, clamped to [0.1, 60] s (1 s while
        nothing has been measured)."""
        if self.decode_wall_s > 0 and self.tokens_generated > 0:
            rate = self.tokens_generated / self.decode_wall_s
            est = self.queued_tokens() / max(rate, 1e-6)
        else:
            est = 1.0
        return float(min(max(est, 0.1), 60.0))

    def finished(self) -> List[Request]:
        out, self._finished = self._finished, []
        return out

    def drain_stream(self) -> List:
        """All ``(rid, token)`` pairs emitted since the last drain, in
        emission order."""
        out, self._stream = self._stream, []
        return out

    def has_work(self) -> bool:
        return bool(self._queue or self._active)

    def run_to_completion(self, max_steps: int = 10_000):
        """Drive until the queue drains; returns all finished requests
        in completion order."""
        out = []
        for _ in range(max_steps):
            if not self.has_work():
                return out
            self.step()
            out.extend(self.finished())
        if self.has_work():
            raise RuntimeError("serving loop exceeded max_steps")
        return out

    # -- engine side ------------------------------------------------------
    @staticmethod
    def _ctx_of(req: Request) -> np.ndarray:
        """The tokens a (re-)prefill must cache: the prompt, plus, for a
        preempted request, everything generated except the last token
        (generated[-1] is the not-yet-fed next input)."""
        if req.generated:
            return np.concatenate(
                [req.prompt, np.asarray(req.generated[:-1], np.int64)])
        return req.prompt

    def _hit_stop(self, req: Request, t: int) -> bool:
        """eos or a completed stop sequence at the generated tail."""
        if self.eos_id is not None and t == self.eos_id:
            return True
        for seq in req.stop_sequences or ():
            if len(req.generated) >= len(seq) and \
                    req.generated[-len(seq):] == seq:
                return True
        return False

    def _finish_admit(self, req: Request, slot: int, tok: int) -> None:
        """Shared bookkeeping tail of an admission."""
        now = time.monotonic()
        if req.t_admit == 0.0:
            req.t_admit = now
        if req.t_first_token == 0.0:
            req.t_first_token = now
        req.slot = slot
        req.admit_seq = self._admit_seq
        self._admit_seq += 1
        self._active[slot] = req
        self._next_tok[slot] = tok
        self._remaining[slot] = req.max_new_tokens - len(req.generated)
        self._active_mask[slot] = 1
        if self._hit_stop(req, tok) or self._remaining[slot] <= 0:
            self._retire(slot)

    def _free_slot(self, slot: int) -> None:
        self.cache.release_row(slot)
        self._free_slots.append(slot)
        self._remaining[slot] = 0
        self._active_mask[slot] = 0

    def _retire(self, slot: int, status: str = "ok") -> None:
        req = self._active.pop(slot)
        req.done = True
        req.status = status
        req.t_finish = time.monotonic()
        self._free_slot(slot)
        if status == "ok":
            self.requests_finished += 1
        self._finished.append(req)

    def _finish_queued(self, req: Request, status: str) -> None:
        req.done = True
        req.status = status
        req.t_finish = time.monotonic()
        self._finished.append(req)

    def _count_abnormal(self, status: str) -> None:
        if status == "cancelled":
            self.requests_cancelled += 1
        else:
            self.requests_expired += 1

    def _sweep_cancelled_expired(self) -> None:
        """Retire cancelled / deadline-expired requests, queued or
        active, at the start of a step."""
        if not self._cancelled and not self._has_deadlines:
            return
        now = self._now()

        def _hit(req: Request) -> Optional[str]:
            if req.rid in self._cancelled:
                return "cancelled"
            if req.deadline and now >= req.deadline:
                return "expired"
            return None

        keep: deque = deque()
        for req in self._queue:
            status = _hit(req)
            if status is None:
                keep.append(req)
            else:
                self._count_abnormal(status)
                self._finish_queued(req, status)
        self._queue = keep
        for slot, req in list(self._active.items()):
            status = _hit(req)
            if status is not None:
                self._count_abnormal(status)
                self._retire(slot, status)
        self._cancelled.clear()

    def step(self) -> int:
        """Admit + one decode token for every active slot.  Returns the
        number of active requests after the step."""
        self._sweep_cancelled_expired()
        self._admit_wave()
        if not self._active:
            return 0
        t0 = time.perf_counter()
        self._decode_sync()
        self.decode_wall_s += time.perf_counter() - t0
        return len(self._active)

    def _collect_admissions(self):
        """Pop every queued request that fits (slots + pool pages),
        head-of-line FIFO: stop at the first that does not fit."""
        admits: List = []                    # (request, context) pairs
        reserved = 0
        while self._queue and len(self._free_slots) > len(admits):
            head = self._queue[0]
            ctx = self._ctx_of(head)
            need = (len(ctx) + self.cache.page - 1) // self.cache.page
            if reserved + need > self.cache.available_pages():
                break
            reserved += need
            admits.append((self._queue.popleft(), ctx))
        return admits

    def _admit_wave(self) -> None:
        admits = self._collect_admissions()
        if admits:
            self._admit_packed(admits)

    def _packed_bucket(self, T: int) -> int:
        """Round a packed-stream length up to a power-of-two number of
        prefill buckets."""
        n = -(-T // self.prefill_bucket)
        return self.prefill_bucket * (1 << (n - 1).bit_length())

    def _admit_packed(self, group: List) -> None:
        """Packed varlen admission: every context of the wave (fresh
        prompts and preemption resumes) packs into one ``[T_bucket]``
        token stream with segment ids and prefills as one pass; each
        segment's K/V lands in its row's pages through one batched page
        write, and each fresh segment's last real position feeds one
        shared logits tail for its first token."""
        page = self.cache.page
        dev = self.device
        K = len(group)
        plan = []                  # (req, slot, s_real, Wp, off)
        T = 0
        for req, ctx in group:
            slot = self._free_slots.pop()
            s_real = len(ctx)
            self.cache.alloc_row(slot, s_real)
            Wp = -(-s_real // page) * page   # page-pad the segment
            plan.append((req, ctx, slot, s_real, Wp, T))
            T += Wp
        Tb = self._packed_bucket(T)
        toks = np.zeros((1, Tb), np.int64)
        seg = np.full((1, Tb), K, np.int32)      # sentinel tail id
        pos = np.zeros((1, Tb), np.int32)
        for i, (req, ctx, slot, s_real, Wp, off) in enumerate(plan):
            seg[0, off:off + Wp] = i
            pos[0, off:off + Wp] = np.arange(Wp)
            toks[0, off:off + s_real] = ctx
        x, ks, vs = self._prefill(
            self.params, torch.from_numpy(toks).to(dev),
            torch.from_numpy(seg).to(dev), torch.from_numpy(pos).to(dev))
        self.prefill_calls += 1
        self.prefill_token_slots += Tb
        self.prefill_padded_tokens += Tb - sum(p[3] for p in plan)
        self.cache.write_pages_batch(
            [(slot, ks[:, off:off + Wp], vs[:, off:off + Wp], s_real, 0)
             for _, _, slot, s_real, Wp, off in plan])
        toks_out = None
        if any(not p[0].generated for p in plan):
            # first tokens from each segment's LAST real position
            # (skipped for an all-resume wave: their tokens are saved)
            last = torch.tensor([off + s_real - 1
                                 for _, _, _, s_real, _, off in plan],
                                device=dev)
            h = _rms_norm(x[0, last], self.params["final_norm"],
                          self.cfg.rms_norm_eps)
            logits = _mm(h, self.params["lm_head"], self.cfg.dtype).float()
            toks_out = _pick_token(logits, self.temperature, self._gen,
                                   self.top_k, self.top_p).cpu().numpy()
        for i, (req, ctx, slot, s_real, Wp, off) in enumerate(plan):
            if req.generated:                    # resume after preempt
                tok = req.generated[-1]
            else:
                tok = int(toks_out[i])
                req.generated.append(tok)
                self._stream.append((req.rid, tok))
            self._finish_admit(req, slot, tok)

    def _preempt(self, keep: Optional[int]) -> bool:
        """Evict the most recently admitted active request (except slot
        ``keep``) and requeue it at the FRONT of the queue, its pages
        released (recompute-style: the resume re-prefills prompt +
        generated).  Returns False when there is no other request."""
        victims = [s for s in self._active if s != keep]
        if not victims:
            return False
        slot = max(victims, key=lambda s: self._active[s].admit_seq)
        req = self._active.pop(slot)
        req.slot = None
        req.preempted += 1
        self.preemptions += 1
        self._free_slot(slot)
        self._queue.appendleft(req)
        return True

    def _ensure_or_preempt(self) -> None:
        """Grow every active row by one token of pages, preempting the
        youngest other request on pool exhaustion."""
        needs = [(slot, 1) for slot in self._active]
        try:
            self.cache.ensure_capacity_batch(needs)
            return
        except RuntimeError:
            pass                   # pool pressure: per-slot fallback
        for slot in list(self._active):
            if slot not in self._active:     # evicted by an earlier turn
                continue
            while True:
                try:
                    self.cache.ensure_capacity(slot, 1)
                    break
                except RuntimeError:
                    if not self._preempt(keep=slot):
                        raise RuntimeError(
                            "KV page pool exhausted and no preemption "
                            "victim remains; the pool is too small for a "
                            "single request of this length")

    def _decode_sync(self) -> None:
        """One decode step for the whole batch + a blocking fetch."""
        cache = self.cache
        dev = self.device
        self._ensure_or_preempt()
        tables = torch.from_numpy(cache.tables.copy()).to(dev)
        lens = torch.from_numpy(cache.lens.copy()).to(dev)
        tok = torch.from_numpy(self._next_tok.copy()).to(dev)
        if cache.kv_quant == "int8":
            (cache.kpool, cache.vpool, cache.kscale, cache.vscale,
             nxt) = self._step(self.params, cache.kpool, cache.vpool,
                               cache.kscale, cache.vscale, tables, lens, tok,
                               self._gen)
        else:
            cache.kpool, cache.vpool, nxt = self._step(
                self.params, cache.kpool, cache.vpool, tables, lens, tok,
                self._gen)
        cache.lens = cache.lens + self._active_mask
        self.decode_steps += 1
        nxt = nxt.cpu().numpy()
        for slot, req in list(self._active.items()):
            t = int(nxt[slot])
            req.generated.append(t)
            self.tokens_generated += 1
            self._stream.append((req.rid, t))
            self._next_tok[slot] = t
            self._remaining[slot] -= 1
            if self._hit_stop(req, t) or self._remaining[slot] <= 0:
                self._retire(slot)
