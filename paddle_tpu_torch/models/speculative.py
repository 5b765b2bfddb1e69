"""Draft-model speculative decoding over the paged KV cache.

Counterpart of ``paddle_tpu/models/speculative.py``: a small draft model
proposes ``gamma`` tokens, the target scores them all in one forward, and
the longest prefix matching the target's greedy picks is accepted plus the
target's own next token.  With exact (greedy) verification the output is
the target's plain greedy sequence for any draft: the draft buys speed,
never content.

* :func:`generate_speculative` runs one sequence: the dense prefill
  (:func:`_prefill`) of both models, drafting through the per-token paged
  decode step on the draft's cache, and the verify through the
  prefill-with-history chunk (:func:`_prefill_chunk`) over the target's
  pages, the candidate block realigned to a page boundary.  Rejected
  drafts' K/V stay past ``lens`` and are written over by the next round.
* :class:`SpeculativeEngine` is the constructor adapter over the engine's
  speculative lane (``ContinuousBatchingEngine(spec=SpecConfig(...))``),
  keeping the old positional signature and the ``dcfg`` / ``dparams`` /
  ``dcache`` attributes.

Greedy (temperature 0) only.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from .._device import resolve_device
from .llama_pretrain import LlamaPretrainConfig, _mm, _rms_norm
from .paged_decode import (PagedKVCache, _prefill, _prefill_chunk,
                           make_paged_decode_step)
from .serving_engine import ContinuousBatchingEngine, SpecConfig

__all__ = ["generate_speculative", "SpeculativeEngine"]


def _last_logits(cfg, params, x_last):
    h = _rms_norm(x_last, params["final_norm"], cfg.rms_norm_eps)
    return _mm(h, params["lm_head"], cfg.dtype).float()


def _prefill_into(cfg, params, cache: PagedKVCache, prompt: np.ndarray):
    """Dense prefill of ``prompt`` into row 0 (``lens = len(prompt)``) ->
    the greedy next token."""
    L = len(prompt)
    cache.alloc_row(0, L)
    page = cache.page
    Lp = ((L + page - 1) // page) * page
    padded = np.zeros((1, Lp), np.int64)
    padded[0, :L] = prompt
    x, ks, vs = _prefill(cfg)(params, torch.from_numpy(padded).to(
        cache.device))
    cache.write_row_pages(0, ks[:, 0], vs[:, 0], L)
    return int(torch.argmax(_last_logits(cfg, params, x[0, L - 1])))


def generate_speculative(cfg: LlamaPretrainConfig, params,
                         draft_cfg: LlamaPretrainConfig, draft_params,
                         prompt, max_new_tokens: int, gamma: int = 4,
                         page: int = 64, device=None
                         ) -> Tuple[np.ndarray, Dict[str, float]]:
    """Greedy speculative decoding of one sequence on ``device`` (CUDA
    unless asked otherwise) -> ``(tokens [max_new_tokens], stats)``, stats
    holding the rounds and the histogram of accepted drafts a round.  The
    tokens equal the target's plain greedy decode for any draft."""
    prompt = np.asarray(prompt, np.int64).reshape(-1)
    if gamma < 1:
        raise ValueError("gamma must be >= 1")
    if gamma >= page:
        raise ValueError(f"gamma {gamma} must stay below page {page} "
                         "(the verify chunk is 2 pages)")
    dev = resolve_device(device)
    S = len(prompt)
    cap_pages = (S + max_new_tokens + gamma + 2 * page) // page + 2
    tcache = PagedKVCache(cfg, num_pages=cap_pages + 1, pages_max=cap_pages,
                          batch=1, page=page, device=dev)
    dcache = PagedKVCache(draft_cfg, num_pages=cap_pages + 1,
                          pages_max=cap_pages, batch=1, page=page,
                          device=dev)

    # both models prefill; the target's first greedy token is output 1
    t0 = _prefill_into(cfg, params, tcache, prompt)
    _prefill_into(draft_cfg, draft_params, dcache, prompt)

    seq = list(prompt) + [t0]       # committed: the target's greedy tokens
    d_len = S                       # tokens the draft cache holds validly
    dstep = make_paged_decode_step(draft_cfg, temperature=0.0)
    verify = _prefill_chunk(cfg, q8=False)
    Cp = 2 * page                   # a chunk: < page realigned + gamma + 1

    rounds = 0
    accept_hist = [0] * (gamma + 1)
    while len(seq) - S - 1 < max_new_tokens:
        rounds += 1
        # draft: catch the draft cache up with the committed sequence (one
        # token a round in the steady state), then draft gamma ahead
        dcache.ensure_capacity(0, new_tokens=gamma + len(seq) - d_len)
        drafts = []
        tables = torch.from_numpy(dcache.tables.copy()).to(dev)
        for pos in range(d_len, len(seq) + gamma - 1):
            feed = seq[pos] if pos < len(seq) else drafts[-1]
            _, _, tok = dstep(
                draft_params, dcache.kpool, dcache.vpool, tables,
                torch.tensor([pos], dtype=torch.int32, device=dev),
                torch.tensor([feed], dtype=torch.int64, device=dev))
            if pos >= len(seq) - 1:
                drafts.append(int(tok[0]))
        # drafts = [d_1 .. d_gamma]; the draft cached d_1 .. d_{gamma-1}

        # verify: one target forward over the candidate block, realigned to
        # the last page boundary (the < page recomputed tokens give the
        # same K/V)
        t_ctx = len(seq) - 1                     # target-cached tokens
        start = (t_ctx // page) * page
        block = seq[start:] + drafts
        Lb = len(block)
        tcache.ensure_capacity(
            0, new_tokens=len(seq) + gamma - int(tcache.lens[0]))
        toks = np.zeros((1, Cp), np.int64)
        toks[0, :Lb] = block
        x, ks, vs = verify(
            params, torch.from_numpy(toks).to(dev), tcache.kpool,
            tcache.vpool, None, None,
            torch.from_numpy(tcache.tables[0].copy()).to(dev), start)
        tcache.write_row_pages(0, ks, vs, Lb, first_page=start // page)
        # the target's greedy pick after each candidate position
        off = (len(seq) - 1) - start
        greedy = torch.argmax(_last_logits(cfg, params,
                                           x[0, off:off + gamma + 1]),
                              dim=-1).cpu().numpy()

        k = 0
        while k < gamma and drafts[k] == int(greedy[k]):
            k += 1
        accept_hist[k] += 1
        N = len(seq)                             # before the extension
        seq.extend(drafts[:k])
        seq.append(int(greedy[k]))               # the target's own token
        # commit by bookkeeping only: stale K/V past lens are dead and the
        # next round writes over them
        tcache.lens[0] = len(seq) - 1
        # the draft validly holds seq[:N] plus the accepted drafts it wrote
        # while drafting (d_1 .. d_{gamma-1}, the first k committed)
        d_len = N + min(k, gamma - 1)
        dcache.lens[0] = d_len

    out = seq[S:S + max_new_tokens]
    total = sum(accept_hist)
    stats = {
        "rounds": rounds,
        "accept_hist": accept_hist,
        "mean_accepted": (sum(i * c for i, c in enumerate(accept_hist))
                          / max(total, 1)),
        "tokens_per_round": len(out) / max(rounds, 1),
    }
    return np.asarray(out, np.int64), stats


class SpeculativeEngine(ContinuousBatchingEngine):
    """The engine's speculative lane behind the old positional signature:
    ``SpeculativeEngine(cfg, params, cache, draft_cfg, draft_params,
    draft_cache, gamma=4, adaptive_gamma=False, max_gamma=8, **kw)`` is
    ``ContinuousBatchingEngine(cfg, params, cache, spec=SpecConfig(gamma,
    source="draft", ...), **kw)``, with ``dcfg`` / ``dparams`` / ``dcache``
    naming the draft triple."""

    def __init__(self, cfg, params, cache, draft_cfg, draft_params,
                 draft_cache, gamma: int = 4, adaptive_gamma: bool = False,
                 max_gamma: int = 8, **kw):
        spec = SpecConfig(gamma=gamma, source="draft", draft_cfg=draft_cfg,
                          draft_params=draft_params,
                          draft_cache=draft_cache,
                          adaptive_gamma=adaptive_gamma, max_gamma=max_gamma)
        super().__init__(cfg, params, cache, spec=spec, **kw)

    @property
    def dcfg(self):
        return self._spec_dcfg

    @property
    def dparams(self):
        return self._spec_dparams

    @property
    def dcache(self):
        return self._spec_dcache
