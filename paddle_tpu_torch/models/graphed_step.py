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
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from .. import flags
from ..ops import int8_matmul as _im
from ..ops import paged_attention as _pa
from ..ops import rms_norm as _rn
from ..ops import rmsnorm_matmul as _rmm
from ..ops import swiglu as _sw
from .paged_decode import (make_paged_decode_step_async,
                           make_paged_decode_step_multi)

__all__ = ["DecodeGraph", "decode_graph", "graphs", "clear", "forget"]

_step_async_cache: Dict[tuple, "DecodeGraph"] = {}
_step_multi_cache: Dict[tuple, "DecodeGraph"] = {}
# one warm-up stream per device: cuBLAS keeps a workspace for every stream
# it has run on (32 MiB on Hopper), so a fresh stream per capture would hold
# one more workspace after every capture (an engine rebuilt over a new
# cache captures anew)
_warmup_streams: Dict[str, "torch.cuda.Stream"] = {}

# the launch counters a decode step can bump: (name, module, attribute)
_COUNTERS = (("paged_decode_attention", _pa, "launches"),
             ("paged_decode_attention_q8", _pa, "launches_q8"),
             ("int8_matmul", _im, "launches"),
             ("int8_matmul_wave", _im, "launches_wave"),
             ("rms_norm_fwd", _rn, "launches"),
             ("swiglu_fwd", _sw, "launches"),
             ("rmsnorm_matmul", _rmm, "launches"))


def _counts() -> Dict[str, int]:
    return {name: getattr(mod, attr) for name, mod, attr in _COUNTERS}


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
        cur = torch.cuda.current_stream(self.device)
        side = _warmup_streams.get(str(self.device))
        if side is None:
            side = _warmup_streams[str(self.device)] = torch.cuda.Stream(
                self.device)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            # warm-up: builds the kernels and fills the wrappers' plan
            # caches.  The functional step only: the chained state stays as
            # seeded, and the pool slots it writes are written again, with
            # the same values, by the first replay
            self.fn(params, *pools, *self._state(), generator=generator)
        cur.wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        if self.sampling:
            graph.register_generator_state(generator)
        before = _counts()
        try:
            with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                self._body(params, pools, generator)
        except BaseException:
            # an aborted capture's context exit raises before it restores
            # the caller's stream: put it back, so that the next step (a
            # quarantined engine goes on serving) runs where it should
            torch.cuda.set_stream(cur)
            raise
        after = _counts()
        self.capture_launches = {k: after[k] - before[k] for k in after
                                 if after[k] != before[k]}
        self.graph = graph

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


# the positions of the params and pools in a graph's key
_PARAMS, _POOLS = 9, 10


def forget(params, pools) -> int:
    """Drop the graphs keyed by ``params`` and ``pools`` (those of an
    engine whose cache nothing reads again, with their private memory
    pools) -> how many."""
    pk, qk = _tensors_key(params), _tensors_key(pools)
    n = 0
    for cache in (_step_async_cache, _step_multi_cache):
        for key in [k for k in cache if k[_PARAMS] == pk and k[_POOLS] == qk]:
            del cache[key]
            n += 1
    return n


def graphs():
    """Every :class:`DecodeGraph` made so far."""
    return list(_step_async_cache.values()) + list(_step_multi_cache.values())


def clear() -> None:
    """Drop every :class:`DecodeGraph` (and, on the card, the device
    memory of its graph's private pool once nothing else holds it)."""
    _step_async_cache.clear()
    _step_multi_cache.clear()
