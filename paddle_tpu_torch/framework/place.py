"""Places and the current device.

Counterpart of ``paddle_tpu/framework/place.py``.  The current place is
where :func:`~paddle_tpu_torch.to_tensor`, the creation ops and new
parameters put their tensors.  It is the card (``"gpu:0"``) unless
:func:`set_device` says otherwise, and asking for the card on a host
without one raises, as ``_device.resolve_device`` does: nothing falls back
to the CPU on its own (``paddle.set_device("cpu")`` runs the plain
versions there).
"""

from __future__ import annotations

import threading
from typing import Union

import torch

from .._device import resolve_device

__all__ = ["Place", "CPUPlace", "CUDAPlace", "CUDAPinnedPlace", "XPUPlace",
           "TPUPlace", "CustomPlace", "set_device", "get_device",
           "device_count", "is_compiled_with_cuda", "is_compiled_with_rocm",
           "is_compiled_with_xpu", "is_compiled_with_tpu",
           "is_compiled_with_cinn", "is_compiled_with_distribute",
           "current_torch_device"]


class Place:
    """(device type, device id)."""

    device_type = "undefined"

    def __init__(self, device_id: int = 0) -> None:
        self._device_id = int(device_id)

    def get_device_id(self) -> int:
        return self._device_id

    def __repr__(self) -> str:
        return f"Place({self.device_type}:{self._device_id})"

    def __eq__(self, other) -> bool:
        return (isinstance(other, Place)
                and self.device_type == other.device_type
                and self._device_id == other._device_id)

    def __hash__(self) -> int:
        return hash((self.device_type, self._device_id))

    def torch_device(self) -> torch.device:
        """This place as a ``torch.device``; raises for the card on a host
        without one."""
        return resolve_device(f"cuda:{self._device_id}")


class CPUPlace(Place):
    device_type = "cpu"

    def __init__(self) -> None:
        super().__init__(0)

    def __repr__(self) -> str:
        return "Place(cpu)"

    def torch_device(self) -> torch.device:
        return torch.device("cpu")


class CUDAPlace(Place):
    device_type = "gpu"


class CUDAPinnedPlace(CPUPlace):
    """Page-locked host memory: a CPU place."""


class _NoDevicePlace(Place):
    """A place of JAX's API the port has no device for: it can be named,
    and asking for its device raises."""

    def torch_device(self) -> torch.device:
        raise RuntimeError(f"the port runs on 'cpu' or 'gpu'; it has no "
                           f"{self.device_type} device")


class XPUPlace(_NoDevicePlace):
    device_type = "xpu"


class TPUPlace(_NoDevicePlace):
    device_type = "tpu"


class CustomPlace(_NoDevicePlace):
    def __init__(self, device_type: str, device_id: int = 0) -> None:
        super().__init__(device_id)
        self.device_type = device_type


_lock = threading.Lock()
_current_place: Place = CUDAPlace(0)


def _parse_device(device: Union[str, Place, torch.device]) -> Place:
    if isinstance(device, Place):
        return device
    if isinstance(device, torch.device):
        return CPUPlace() if device.type == "cpu" else \
            CUDAPlace(device.index or 0)
    s = str(device).lower()
    idx = 0
    if ":" in s:
        s, i = s.split(":", 1)
        idx = int(i)
    if s == "cpu":
        return CPUPlace()
    if s in ("gpu", "cuda"):
        return CUDAPlace(idx)
    raise ValueError(f"unknown device {device!r}: the port runs on 'cpu' "
                     f"or 'gpu[:i]'")


def set_device(device: Union[str, Place]) -> Place:
    """Mirror of ``paddle.set_device``; ``"gpu"`` raises on a host without
    a card."""
    global _current_place
    place = _parse_device(device)
    place.torch_device()
    with _lock:
        _current_place = place
    return place


def get_device() -> str:
    p = _current_place
    return "cpu" if isinstance(p, CPUPlace) else \
        f"{p.device_type}:{p.get_device_id()}"


def _get_current_place() -> Place:
    return _current_place


def current_torch_device() -> torch.device:
    """The current place as a ``torch.device`` (raises for the card on a
    host without one)."""
    return _current_place.torch_device()


def device_count() -> int:
    return torch.cuda.device_count()


def is_compiled_with_cuda() -> bool:
    return torch.cuda.is_available()


def is_compiled_with_rocm() -> bool:
    return torch.version.hip is not None


def is_compiled_with_xpu() -> bool:
    return False


def is_compiled_with_tpu() -> bool:
    return False


def is_compiled_with_cinn() -> bool:
    return False


def is_compiled_with_distribute() -> bool:
    return torch.distributed.is_available()
