"""The framework's random state: one explicit ``torch.Generator`` a device.

Counterpart of ``paddle_tpu/framework/random.py``.  Every draw of the API
(the initializers, ``randn``, ``randint``, ``top_p_sampling``) takes the
generator of the device it draws on from :func:`generator`; none draws
from torch's global generators, so a CUDA graph capture elsewhere in the
process cannot disturb them.  :func:`seed` reseeds every device's
generator and sets the seed new ones start from.  The bits differ from
``jax.random``'s for the same seed: tests compare draws by distribution.
"""

from __future__ import annotations

import threading
from typing import Dict

import numpy as np
import torch

__all__ = ["seed", "generator"]

_lock = threading.Lock()
_seed = int(np.random.SeedSequence().entropy % (2 ** 31))
_generators: Dict[torch.device, torch.Generator] = {}


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
