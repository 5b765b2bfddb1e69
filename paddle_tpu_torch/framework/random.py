"""The framework's random state: one explicit ``torch.Generator`` a device.

Counterpart of ``paddle_tpu/framework/random.py``.  Every draw of the API
(the initializers, ``randn``, ``randint``, ``top_p_sampling``) takes the
generator of the device it draws on from :func:`generator`; none draws
from torch's global generators, so a CUDA graph capture elsewhere in the
process cannot disturb them.  :func:`seed` reseeds every device's
generator and sets the seed new ones start from.  Dropout draws its masks
from the same generator, so a training step's stream restarts under
``paddle.seed`` and moves on every step; a CUDA graph that draws registers
the generator (``CUDAGraph.register_generator_state``), and each replay
then draws afresh.  :func:`generator_guard` lends a block a generator of
its own (``incubate.jit_eval_step``'s, which must not move the training
stream, as JAX's eval step keeps off its global chain).  The bits differ from
``jax.random``'s for the same seed: tests compare draws by distribution.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Dict

import numpy as np
import torch

__all__ = ["seed", "generator", "generator_guard", "initial_seed",
           "renew_generator", "get_rng_state", "set_rng_state",
           "get_cuda_rng_state", "set_cuda_rng_state"]

_lock = threading.Lock()
_seed = int(np.random.SeedSequence().entropy % (2 ** 31))
_generators: Dict[torch.device, torch.Generator] = {}
_lent = threading.local()


def _key(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def generator(device=None) -> torch.Generator:
    """The framework's generator on ``device`` (the current place when
    ``None``), made from the last :func:`seed` on first use."""
    if device is None:
        from .place import current_torch_device
        device = current_torch_device()
    dev = _key(device)
    lent = getattr(_lent, "gen", None)
    if lent is not None and _key(lent.device) == dev:
        return lent
    with _lock:
        gen = _generators.get(dev)
        if gen is None:
            gen = _generators[dev] = torch.Generator(
                device=dev).manual_seed(_seed)
        return gen


def seed(value: int) -> None:
    """Mirror of ``paddle.seed``: every device's generator restarts from
    ``value`` (and numpy's global state, as in JAX)."""
    global _seed
    np.random.seed(int(value) % (2 ** 32))
    with _lock:
        _seed = int(value)
        for gen in _generators.values():
            gen.manual_seed(_seed)


def initial_seed() -> int:
    """The seed the generators last started from."""
    return _seed


@contextlib.contextmanager
def generator_guard(gen: torch.Generator):
    """Draws on ``gen``'s device take ``gen`` inside the block (this
    thread only)."""
    prev = getattr(_lent, "gen", None)
    _lent.gen = gen
    try:
        yield gen
    finally:
        _lent.gen = prev


def renew_generator(device) -> torch.Generator:
    """Give ``device`` a fresh generator at the state of its old one.  A
    CUDA graph capture that fails after registering the generator leaves
    it marked as capturing, and torch then refuses every draw from it
    outside a capture; the caller of the failed capture renews it."""
    dev = _key(device)
    old = generator(dev)
    gen = torch.Generator(device=dev)
    gen.set_state(old.get_state())
    with _lock:
        _generators[dev] = gen
    return gen


def get_rng_state(device=None):
    """[the state of the framework's generator on ``device``] (the current
    place when ``None``), for :func:`set_rng_state`."""
    return [generator(device).get_state()]


def set_rng_state(state, device=None) -> None:
    if isinstance(state, (list, tuple)):
        state = state[0]
    generator(device).set_state(state)


def get_cuda_rng_state():
    """The state of the framework's generator on each card."""
    return [generator(torch.device("cuda", i)).get_state()
            for i in range(torch.cuda.device_count())]


def set_cuda_rng_state(state_list) -> None:
    if not isinstance(state_list, (list, tuple)):
        state_list = [state_list]
    for i, st in enumerate(state_list):
        generator(torch.device("cuda", i)).set_state(st)
