"""Engine factories a spawned :class:`~paddle_tpu_torch.fleet.ReplicaAgent`
can import.

``spawn_agent_process`` resolves its factory by import path, since a
closure over device tensors cannot cross a process boundary.  Point a
``RemoteSpec(spawn={"factory": "paddle_tpu_torch.testing.agent_factory:
make_engine", "factory_kwargs": {...}})`` at one of these; every keyword
is plain data.

* :func:`make_engine`: the 2-layer fp32 config of the transport tests
  (``tests/test_transport.py``), its weights read from an ``.npz`` file
  that :func:`save_weights` wrote (JAX's param tree as
  ``models.weights.params_from_jax`` takes it), so a child serves the
  parent's weights.  CPU unless asked otherwise.
* :func:`make_llama7b_engine`: LLaMA-7B (``LlamaPretrainConfig``
  defaults) with ``init_params(cfg, seed=seed)``'s weights, drawn from one
  seeded generator, so a child draws the same weights as a parent that
  called ``init_params`` with the same seed.  On the card unless asked
  otherwise.  It loads the kernel libraries the parent built and refuses
  to start a build of its own.

Both keep their weights for the life of the process, so the supervisor's
rebuild of a dead engine reuses them.  ``counts_path`` writes the serving
kernels' launch counts (JSON) after every engine step, for a parent that
cannot read the child's counters.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional

import numpy as np
import torch

__all__ = ["make_engine", "make_llama7b_engine", "save_weights",
           "load_weights", "TEST_CONFIG", "launch_counts"]

# the config of the transport tests (tests/test_transport.py)
TEST_CONFIG = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
                   num_hidden_layers=2, num_attention_heads=4,
                   num_key_value_heads=2, max_seq_len=256, remat=False,
                   loss_chunks=1, use_pallas_attention=False)

# (counter name, module, attribute) of the serving path's kernels
_COUNTERS = (("paged_decode_attention", "paged_attention", "launches"),
             ("paged_decode_attention_q8", "paged_attention",
              "launches_q8"),
             ("flash_attention_segmented", "flash_varlen", "launches"),
             ("segment_tile_ranges", "flash_varlen", "launches_ranges"),
             ("int8_matmul", "int8_matmul", "launches"),
             ("int8_matmul_wave", "int8_matmul", "launches_wave"))

# the kernel libraries the serving path loads (K1's, K2's)
_PREBUILT = ("paged_attention", "flash_varlen")

_PARAMS: Dict[tuple, dict] = {}


def save_weights(path: str, tree) -> None:
    """Write a nested dict of arrays (JAX's param tree) to ``path`` as one
    ``.npz``, the nesting kept in ``/``-joined keys."""
    flat = {}

    def walk(prefix, node):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(f"{prefix}{k}/", v)
        else:
            flat[prefix[:-1]] = np.asarray(node)

    walk("", tree)
    np.savez(path, **flat)


def load_weights(path: str) -> dict:
    """Inverse of :func:`save_weights` -> the nested dict of arrays."""
    tree: dict = {}
    with np.load(path) as z:
        for key in z.files:
            node = tree
            *parents, leaf = key.split("/")
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = z[key]
    return tree


def launch_counts() -> Dict[str, int]:
    """The serving kernels' launch counts in this process."""
    import importlib
    return {name: int(getattr(importlib.import_module(
        f"paddle_tpu_torch.ops.{mod}"), attr))
        for name, mod, attr in _COUNTERS}


def _count_writer(engine, path: str):
    """Write :func:`launch_counts` to ``path`` after every step of
    ``engine`` (atomically: a reader sees a whole file)."""
    step = engine.step

    def counted_step():
        try:
            return step()
        finally:
            tmp = f"{path}.tmp{os.getpid()}"
            with open(tmp, "w") as f:
                json.dump(launch_counts(), f)
            os.replace(tmp, path)

    engine.step = counted_step
    return engine


def _engine(cfg, params, cache, engine: str, **kw):
    from ..models.disagg import DecodeEngine, PrefillEngine
    from ..models.serving_engine import ContinuousBatchingEngine
    cls = {"unified": ContinuousBatchingEngine, "prefill": PrefillEngine,
           "decode": DecodeEngine}[engine]
    kw.setdefault("metrics_registry", False)
    return cls(cfg, params, cache, **kw)


def make_engine(device: str = "cpu", weights: Optional[str] = None,
                engine: str = "unified", num_pages: int = 64,
                pages_max: int = 8, batch: int = 2, page: int = 16,
                host_pages: Optional[int] = None,
                kv_quant: Optional[str] = None,
                counts_path: Optional[str] = None, **engine_kw):
    """An engine of the transport tests' 2-layer fp32 config over a fresh
    ``PagedKVCache``; ``weights`` is the ``.npz`` :func:`save_weights`
    wrote (required).  ``engine``: ``"unified"``, ``"prefill"`` or
    ``"decode"``.  The process runs one intra-op thread (a model this small
    gains nothing from more)."""
    from ..models.llama_pretrain import LlamaPretrainConfig
    from ..models.paged_decode import PagedKVCache
    from ..models.weights import params_from_jax
    if weights is None:
        raise ValueError("make_engine needs weights= (an .npz path that "
                         "save_weights wrote)")
    torch.set_num_threads(1)
    cfg = LlamaPretrainConfig(**TEST_CONFIG, dtype=torch.float32)
    key = ("test", os.path.abspath(weights), str(device))
    if key not in _PARAMS:
        _PARAMS[key] = params_from_jax(load_weights(weights),
                                       device=device)
    cache_kw = dict(num_pages=num_pages, pages_max=pages_max, batch=batch,
                    page=page, device=device)
    if host_pages is not None:
        cache_kw["host_pages"] = host_pages
    if kv_quant is not None:
        cache_kw["kv_quant"] = kv_quant
    eng = _engine(cfg, _PARAMS[key], PagedKVCache(cfg, **cache_kw), engine,
                  **engine_kw)
    return _count_writer(eng, counts_path) if counts_path else eng


def make_llama7b_engine(device: str = "cuda", seed: int = 0,
                        engine: str = "unified", num_pages: int = 128,
                        pages_max: int = 8, batch: int = 8, page: int = 64,
                        host_pages: Optional[int] = None,
                        kv_quant: Optional[str] = None,
                        counts_path: Optional[str] = None,
                        config: Optional[dict] = None, **engine_kw):
    """An engine of LLaMA-7B (``LlamaPretrainConfig`` defaults, bf16) with
    ``init_params(cfg, seed=seed)``'s weights over a fresh ``PagedKVCache``
    (128 pages of 64 by default: 4 GiB of bf16 pages).  ``config``
    overrides config fields (a small model, to rehearse on the CPU).  On a
    CUDA device the serving path's kernel libraries must be built already
    (by the parent): a missing one raises instead of starting a build."""
    from ..models.llama_pretrain import LlamaPretrainConfig, init_params
    from ..models.paged_decode import PagedKVCache
    dev = torch.device(device)
    if dev.type == "cuda":
        from ..ops import _build
        missing = [n for n in _PREBUILT if not _build._target(n).exists()]
        if missing:
            raise RuntimeError(
                f"kernel libraries {missing} are not built under "
                f"{_build.BUILD_DIR}: build them in the parent before "
                f"spawning an agent (a child must not start a build)")
    cfg = LlamaPretrainConfig(**(config or {}))
    key = ("llama7b", int(seed), str(dev), repr(cfg))
    if key not in _PARAMS:
        _PARAMS[key] = init_params(cfg, seed=int(seed), device=dev)
    cache_kw = dict(num_pages=num_pages, pages_max=pages_max, batch=batch,
                    page=page, device=dev)
    if host_pages is not None:
        cache_kw["host_pages"] = host_pages
    if kv_quant is not None:
        cache_kw["kv_quant"] = kv_quant
    eng = _engine(cfg, _PARAMS[key], PagedKVCache(cfg, **cache_kw), engine,
                  **engine_kw)
    return _count_writer(eng, counts_path) if counts_path else eng
