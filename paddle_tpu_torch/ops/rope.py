"""Rotate-half rotary position embedding: the CUDA kernel's wrapper, its
plain version and the cos / sin tables.

Counterpart of ``paddle_tpu/ops/pallas/rope.py``: :func:`rope_inv_freq` and
:func:`rope_tables` are copies of the JAX functions; :func:`fused_rope`
replaces the Pallas ``fused_rope`` (forward and, with ``-sin``, backward)
with the hand-written Hopper kernel in ``csrc/rope.cu``; :func:`_composite`
is the plain version.  :func:`cached_tables` keeps the tables of the last
few (S, d, theta, device) keys, so a model's layers build them once.

A tensor on the CPU goes to the plain version; a CUDA tensor goes to the
kernel, or the wrapper raises.  One rotation is the ``torch.library`` op
``paddle_tpu_torch::fused_rope`` (CPU: the plain version; CUDA: the
kernel; fake: shapes only), so an exported program names it.  The JAX wrapper's composite fallback for
sequence lengths no 8-aligned block divides has no counterpart: the kernel
masks its own tail, so every length runs it.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import threading

import torch

from .._device import resolve_device
from ..tensor.tensor import host_reads_forbidden
from . import _build

__all__ = ["fused_rope", "rope_tables", "cached_tables", "rope_inv_freq",
           "launch_plan", "launches"]

# kernel launches made by fused_rope, forward and backward together
launches = 0
# tables built by cached_tables (a miss, or a call during a graph capture)
table_builds = 0
# (S, d, theta, device) keys cached_tables keeps, least recently used first
TABLES_MAX = 16
_tables: "collections.OrderedDict[tuple, tuple]" = collections.OrderedDict()
_tables_lock = threading.Lock()


def rope_inv_freq(head_dim: int, theta: float = 10000.0, device=None):
    """RoPE inverse frequencies [d/2], f32, on ``device`` (CUDA unless
    asked otherwise)."""
    dev = resolve_device(device)
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=dev) / head_dim))


def rope_tables(seq_len: int, head_dim: int, theta: float = 10000.0,
                dtype=torch.float32, device=None):
    """cos / sin tables [S, d/2] for :func:`fused_rope`."""
    inv = rope_inv_freq(head_dim, theta, device)
    t = torch.arange(seq_len, dtype=torch.float32, device=inv.device)
    freqs = torch.outer(t, inv)
    return torch.cos(freqs).to(dtype), torch.sin(freqs).to(dtype)


def cached_tables(seq_len: int, head_dim: int, theta: float = 10000.0,
                  device=None):
    """:func:`rope_tables` (f32) for (S, d, theta, device), built once and
    kept among the last ``TABLES_MAX`` keys.  The tensors are shared: a
    caller must not write them.  A call made while a CUDA graph is being
    captured, or inside a trace (host reads forbidden: an export's fake
    tensors), builds the tables fresh and keeps nothing, so no graph's
    memory and no traced tensor enters the cache, and no graph reads a
    tensor the cache may drop."""
    global table_builds
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if host_reads_forbidden() is not None or (
            dev.type == "cuda" and torch.cuda.is_current_stream_capturing()):
        table_builds += 1
        return rope_tables(seq_len, head_dim, theta, device=dev)
    key = (int(seq_len), int(head_dim), float(theta), dev)
    with _tables_lock:
        hit = _tables.get(key)
        if hit is not None:
            _tables.move_to_end(key)
            return hit
    hit = rope_tables(seq_len, head_dim, theta, device=dev)
    with _tables_lock:
        table_builds += 1
        _tables[key] = hit
        while len(_tables) > TABLES_MAX:
            _tables.popitem(last=False)
    return hit


def _composite(x, cos, sin, neg_sin: bool):
    """Plain rotate-half in f32: x [B, S, N, d], cos / sin [S, d/2]."""
    h = x.shape[-1] // 2
    c = cos.float()[None, :, None, :]
    sn = sin.float()[None, :, None, :]
    if neg_sin:
        sn = -sn
    x1 = x[..., :h].float()
    x2 = x[..., h:].float()
    return torch.cat([x1 * c - x2 * sn, x2 * c + x1 * sn], -1).to(x.dtype)


@functools.lru_cache(maxsize=None)
def _kernel_fn():
    """The launcher, looked up and typed once per process."""
    fn = _build.library("rope").fused_rope_apply
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _plan_fn():
    fn = _build.library("rope").fused_rope_plan
    fn.argtypes = [ctypes.c_int] * 5 + [ctypes.POINTER(ctypes.c_int),
                                        ctypes.POINTER(ctypes.c_longlong)]
    fn.restype = ctypes.c_int
    return fn


def launch_plan(shape, dtype=torch.bfloat16):
    """(G, blocks): the head group and the grid of 256-thread blocks the
    kernel launches for x of ``shape`` [B, S, N, d] and ``dtype`` on the
    current CUDA device (the host's pick, from the device's SM count)."""
    b, s, n, d = shape
    group, blocks = ctypes.c_int(), ctypes.c_longlong()
    err = _plan_fn()(b, s, n, d, int(dtype == torch.bfloat16),
                     ctypes.byref(group), ctypes.byref(blocks))
    if err:
        raise RuntimeError(f"fused_rope plan failed: cudaError {err}")
    return group.value, blocks.value


def _check(x, cos, sin):
    if x.dim() != 4:
        raise ValueError(f"want x [B, S, N, d], got {tuple(x.shape)}")
    _, s, _, d = x.shape
    if d % 2 or cos.shape != (s, d // 2) or sin.shape != cos.shape:
        raise ValueError(f"want cos / sin [{s}, {d // 2}] for x "
                         f"{tuple(x.shape)}, got {tuple(cos.shape)}, "
                         f"{tuple(sin.shape)}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"kernel takes bf16 or f32 x, got {x.dtype}")
    vec = 8 if x.dtype == torch.bfloat16 else 4
    if (d // 2) % vec:
        raise ValueError(f"kernel takes d/2 % {vec} == 0 for {x.dtype}, got "
                         f"d={d}")
    for name, t, dt in (("x", x, x.dtype), ("cos", cos, torch.float32),
                        ("sin", sin, torch.float32)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if t.dtype != dt:
            raise TypeError(f"{name} must be {dt}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary")


def _apply(x, cos, sin, neg_sin: bool):
    """One rotation: the plain version for a CPU tensor, the kernel for a
    CUDA tensor."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no fused rope for {x.device}")
    return _rope_op(x, cos, sin, neg_sin)


@torch.library.custom_op("paddle_tpu_torch::fused_rope", mutates_args=(),
                         device_types="cpu")
def _rope_op(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
             neg_sin: bool) -> torch.Tensor:
    """K5 as an op; on the CPU its plain version."""
    return _composite(x, cos, sin, neg_sin)


@_rope_op.register_fake
def _rope_op_fake(x, cos, sin, neg_sin):
    return torch.empty_like(x)


@_rope_op.register_kernel("cuda")
def _rope_kernel(x, cos, sin, neg_sin):
    """K5 on CUDA tensors."""
    _check(x, cos, sin)
    global launches
    b, s, n, d = x.shape
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    err = _kernel_fn()(
        x.data_ptr(), cos.data_ptr(), sin.data_ptr(), out.data_ptr(), b, s, n,
        d, int(neg_sin), int(x.dtype == torch.bfloat16),
        torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"fused_rope kernel launch failed: cudaError "
                           f"{err}")
    launches += 1
    return out


class _FusedRope(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, cos, sin):
        ctx.save_for_backward(cos, sin)
        return _apply(x, cos, sin, False)

    @staticmethod
    def backward(ctx, dout):
        cos, sin = ctx.saved_tensors
        # the rotation is orthonormal: its vjp is the inverse rotation
        return _apply(dout.contiguous(), cos, sin, True), None, None


def fused_rope(x, cos, sin):
    """Rotate-half RoPE on x [B, S, N, d] with [S, d/2] f32 tables (from
    :func:`rope_tables`); differentiable in x."""
    return _FusedRope.apply(x, cos, sin)
