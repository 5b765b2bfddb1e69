"""The async and horizon decode steps, replayed from CUDA graphs.

JAX jits :func:`make_paged_decode_step_async` and
:func:`make_paged_decode_step_multi` and memoises the programs in
``_step_async_cache`` / ``_step_multi_cache``.  The port's counterpart is a
:class:`DecodeGraph` per key, kept in the caches of the same names here.

A :class:`DecodeGraph` owns the chained serving-loop state as static device
buffers (``tables``, ``lens``, ``tok``, ``active``, ``remaining``, ``eos``)
and one output buffer ``out [2, H, B]`` int64 (the tokens, then the done
flags, of each micro-step).  Its body runs the functional step and writes
the new state back into the same buffers in place, so replay k+1 reads
replay k's outputs with no host step between.  On a CUDA device the body is
captured into a ``torch.cuda.CUDAGraph`` at the first call and every later
call replays it; on the CPU (no graphs) the same body runs eagerly.  A
capture or a replay that fails raises: there is no eager fallback on the
card.

The key holds what the captured launches depend on: the config, H, the
sampling knobs, ``kv_quant``, the batch and table width, every params and
pool tensor's address, dtype and shape, the port's flags (read at each
call, as the model code reads them, so a flag flip captures anew; JAX fixes
its flags when it traces) and, when sampling, the generator the graph
registered.  :func:`clear` drops every graph (and the device memory of
their private pools), :func:`forget` the graphs of one params and pools
(an engine rebuilt over another cache).

The speculative round of the overlap lane (:func:`make_spec_step`, JAX's
``_spec_step_cache``) replays the same way from a :class:`SpecGraph`, one
per gamma.  Its chained state (:class:`SpecState`: ``tables``, ``dtables``,
``lens``, ``tok``, ``prev``, ``active``, ``remaining``, ``spec_on``,
``eos``) is keyed without gamma, so the graphs of every gamma an adaptive
engine tries read and write the same buffers and a retune needs no new
seeding; each graph writes ``out [3, C, B]`` (tokens, done flags, emit
flags) and ``accepts [B]``.  The round is greedy: no generator is
registered and nothing draws from the default CUDA generator.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from .. import flags
from ..jit.capture import capture as _capture
from .paged_decode import (make_paged_decode_step_async,
                           make_paged_decode_step_multi, make_spec_step)

__all__ = ["DecodeGraph", "SpecGraph", "SpecState", "decode_graph",
           "spec_graph", "graphs", "clear", "forget"]

_step_async_cache: Dict[tuple, "DecodeGraph"] = {}
_step_multi_cache: Dict[tuple, "DecodeGraph"] = {}
_spec_state_cache: Dict[tuple, "SpecState"] = {}
_spec_graph_cache: Dict[tuple, "SpecGraph"] = {}


def _tensors_key(tree) -> tuple:
    """(address, dtype, shape) of every tensor in a params tree or pool
    tuple, in a fixed order."""
    if isinstance(tree, dict):
        return tuple(_tensors_key(tree[k]) for k in sorted(tree))
    if isinstance(tree, (tuple, list)):
        return tuple(_tensors_key(t) for t in tree)
    return (tree.data_ptr(), tree.dtype, tuple(tree.shape))


class DecodeGraph:
    """One async (``multi=False``, H = 1) or horizon step over static
    state buffers; see the module docstring.

    ``replays`` counts the replays, and ``capture_launches`` the kernel
    launches each wrapper recorded into the graph at capture (every replay
    launches them again without passing through the wrappers)."""

    def __init__(self, fn, horizon: int, multi: bool, B: int,
                 pages_max: int, device, sampling: bool):
        self.fn = fn
        self.multi = multi
        self.device = device
        self.sampling = sampling
        z = dict(device=device)
        self.tables = torch.zeros((B, pages_max), dtype=torch.int32, **z)
        self.lens = torch.zeros((B,), dtype=torch.int32, **z)
        self.tok = torch.zeros((B,), dtype=torch.int64, **z)
        self.active = torch.zeros((B,), dtype=torch.bool, **z)
        self.remaining = torch.zeros((B,), dtype=torch.int64, **z)
        self.eos = torch.full((), -1, dtype=torch.int64, **z)
        self.out = torch.zeros((2, horizon, B), dtype=torch.int64, **z)
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.replays = 0
        self.capture_launches: Dict[str, int] = {}

    def _state(self):
        return (self.tables, self.lens, self.tok, self.active,
                self.remaining, self.eos)

    def _body(self, params, pools, generator):
        res = self.fn(params, *pools, *self._state(), generator=generator)
        n = len(pools)
        if self.multi:
            toks, dones, tok, lens, rem, act = res[n:]
        else:
            tok, lens, rem, act, done = res[n:]
            toks, dones = tok[None], done[None]
        self.out[0].copy_(toks)
        self.out[1].copy_(dones)
        self.tok.copy_(tok)
        self.lens.copy_(lens)
        self.remaining.copy_(rem)
        self.active.copy_(act)

    def _capture(self, params, pools, generator):
        # warm-up: the functional step only; the chained state stays as
        # seeded, and the pool slots it writes are written again, with the
        # same values, by the first replay
        self.graph, self.capture_launches = _capture(
            self.device,
            lambda: self.fn(params, *pools, *self._state(),
                            generator=generator),
            lambda: self._body(params, pools, generator),
            generator if self.sampling else None)

    def __call__(self, params, pools, generator=None) -> torch.Tensor:
        """Advance the state one step (H micro-steps) -> ``out``."""
        if self.device.type != "cuda":
            self._body(params, pools, generator)
            return self.out
        if self.graph is None:
            self._capture(params, pools, generator)
        self.graph.replay()
        self.replays += 1
        return self.out


def decode_graph(cfg, horizon: int, multi: bool, temperature: float,
                 kv_quant: Optional[str], top_k: int, top_p: float, params,
                 pools, B: int, pages_max: int, device,
                 generator=None) -> DecodeGraph:
    """The :class:`DecodeGraph` of this key, made at its first use."""
    sampling = temperature > 0.0
    key = (dataclasses.astuple(cfg), horizon, temperature, kv_quant, top_k,
           top_p, B, pages_max, str(device), _tensors_key(params),
           _tensors_key(pools), tuple(sorted(flags.get_flags().items())),
           id(generator) if sampling else None)
    cache = _step_multi_cache if multi else _step_async_cache
    g = cache.get(key)
    if g is None:
        if multi:
            fn = make_paged_decode_step_multi(cfg, horizon, temperature,
                                              kv_quant, top_k, top_p)
        else:
            fn = make_paged_decode_step_async(cfg, temperature, kv_quant,
                                              top_k, top_p)
        g = cache[key] = DecodeGraph(fn, horizon, multi, B, pages_max,
                                     device, sampling)
    return g


class SpecState:
    """The chained state of the speculative overlap lane, shared by the
    :class:`SpecGraph` of every gamma of one key: the target's and the
    draft's block tables, ``lens``, ``tok``, ``prev`` (the draft catch-up
    feed), ``active``, ``remaining``, ``spec_on`` and ``eos``."""

    def __init__(self, B: int, pages_max: int, dpages_max: int, device):
        z = dict(device=device)
        self.device = device
        self.tables = torch.zeros((B, pages_max), dtype=torch.int32, **z)
        self.dtables = torch.zeros((B, dpages_max), dtype=torch.int32, **z)
        self.lens = torch.zeros((B,), dtype=torch.int32, **z)
        self.tok = torch.zeros((B,), dtype=torch.int64, **z)
        self.prev = torch.zeros((B,), dtype=torch.int64, **z)
        self.active = torch.zeros((B,), dtype=torch.bool, **z)
        self.remaining = torch.zeros((B,), dtype=torch.int64, **z)
        self.spec_on = torch.zeros((B,), dtype=torch.bool, **z)
        self.eos = torch.full((), -1, dtype=torch.int64, **z)


class SpecGraph:
    """One draft-model speculative round of one gamma over a
    :class:`SpecState`; see the module docstring.  ``replays`` and
    ``capture_launches`` as on :class:`DecodeGraph`."""

    def __init__(self, fn, gamma: int, state: SpecState):
        self.fn = fn
        self.gamma = gamma
        self.state = state
        self.device = state.device
        B = state.tok.shape[0]
        self.out = torch.zeros((3, gamma + 1, B), dtype=torch.int64,
                               device=self.device)
        self.accepts = torch.zeros((B,), dtype=torch.int64,
                                   device=self.device)
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.replays = 0
        self.capture_launches: Dict[str, int] = {}

    def _run(self, params, dparams, pools, dpools):
        s = self.state
        return self.fn(params, dparams, *pools, *dpools, s.tables, s.dtables,
                       s.lens, s.tok, s.prev, s.active, s.remaining,
                       s.spec_on, s.eos)

    def _body(self, params, dparams, pools, dpools):
        res = self._run(params, dparams, pools, dpools)
        toks, dones, emits, acc, tok, prev, lens, rem, act = \
            res[len(pools) + len(dpools):]
        s = self.state
        self.out[0].copy_(toks)
        self.out[1].copy_(dones)
        self.out[2].copy_(emits)
        self.accepts.copy_(acc)
        s.tok.copy_(tok)
        s.prev.copy_(prev)
        s.lens.copy_(lens)
        s.remaining.copy_(rem)
        s.active.copy_(act)

    def __call__(self, params, dparams, pools, dpools):
        """Advance the state one round -> (``out``, ``accepts``)."""
        if self.device.type != "cuda":
            self._body(params, dparams, pools, dpools)
            return self.out, self.accepts
        if self.graph is None:
            # the warm-up writes the same pool slots the first replay
            # writes again, with the same values
            self.graph, self.capture_launches = _capture(
                self.device,
                lambda: self._run(params, dparams, pools, dpools),
                lambda: self._body(params, dparams, pools, dpools))
        self.graph.replay()
        self.replays += 1
        return self.out, self.accepts


def _spec_key(cfg, draft_cfg, kv_quant, draft_kv_quant, params, dparams,
              pools, dpools, B, pages_max, dpages_max, device) -> tuple:
    return (dataclasses.astuple(cfg), dataclasses.astuple(draft_cfg),
            kv_quant, draft_kv_quant, B, pages_max, dpages_max, str(device),
            _tensors_key(params), _tensors_key(pools), _tensors_key(dparams),
            _tensors_key(dpools), tuple(sorted(flags.get_flags().items())))


def spec_graph(cfg, draft_cfg, gamma: int, kv_quant, draft_kv_quant, params,
               dparams, pools, dpools, B: int, pages_max: int,
               dpages_max: int, device) -> SpecGraph:
    """The :class:`SpecGraph` of this key and gamma, made at its first use
    over the key's :class:`SpecState` (keyed without gamma)."""
    key = _spec_key(cfg, draft_cfg, kv_quant, draft_kv_quant, params,
                    dparams, pools, dpools, B, pages_max, dpages_max, device)
    g = _spec_graph_cache.get(key + (gamma,))
    if g is None:
        st = _spec_state_cache.get(key)
        if st is None:
            st = _spec_state_cache[key] = SpecState(B, pages_max,
                                                    dpages_max, device)
        fn = make_spec_step(cfg, gamma, draft_cfg=draft_cfg,
                            kv_quant=kv_quant, draft_kv_quant=draft_kv_quant)
        g = _spec_graph_cache[key + (gamma,)] = SpecGraph(fn, gamma, st)
    return g


# the positions of the params and pools in a graph's key, and in a spec
# key (the target's; the draft's follow them)
_PARAMS, _POOLS = 9, 10
_SPEC_PARAMS, _SPEC_POOLS = 8, 9


def forget(params, pools) -> int:
    """Drop the graphs keyed by ``params`` and ``pools`` (those of an
    engine whose cache nothing reads again, with their private memory
    pools), the speculative ones and their states included -> how many
    graphs."""
    pk, qk = _tensors_key(params), _tensors_key(pools)
    n = 0
    for cache in (_step_async_cache, _step_multi_cache):
        for key in [k for k in cache if k[_PARAMS] == pk and k[_POOLS] == qk]:
            del cache[key]
            n += 1
    for cache in (_spec_graph_cache, _spec_state_cache):
        for key in [k for k in cache
                    if k[_SPEC_PARAMS] == pk and k[_SPEC_POOLS] == qk]:
            del cache[key]
            n += cache is _spec_graph_cache
    return n


def graphs():
    """Every :class:`DecodeGraph` and :class:`SpecGraph` made so far."""
    return (list(_step_async_cache.values())
            + list(_step_multi_cache.values())
            + list(_spec_graph_cache.values()))


def clear() -> None:
    """Drop every graph and spec state (and, on the card, the device memory
    of each graph's private pool once nothing else holds it)."""
    _step_async_cache.clear()
    _step_multi_cache.clear()
    _spec_graph_cache.clear()
    _spec_state_cache.clear()
