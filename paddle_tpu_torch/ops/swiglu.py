"""SwiGLU, ``silu(gate) * up``: the CUDA kernels' wrapper and their plain
versions.

Counterpart of ``paddle_tpu/ops/pallas/swiglu.py``: :func:`swiglu` replaces
the Pallas ``swiglu`` (forward and backward kernels) with the hand-written
Hopper kernels in ``csrc/swiglu.cu`` behind one ``autograd.Function``;
:func:`swiglu_plain` and :func:`swiglu_bwd_plain` follow the Pallas kernels'
f32 arithmetic, rounded once to the inputs' type.

A tensor on the CPU goes to the plain versions; a CUDA tensor goes to the
kernels, or the wrapper raises.  The forward is the ``torch.library`` op
``paddle_tpu_torch::swiglu_fwd`` (CPU: the plain version; CUDA: K10a;
fake: shapes only), so an exported program names it; the backward
launches K10b through ctypes.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

__all__ = ["swiglu", "swiglu_plain", "swiglu_bwd_plain", "launches",
           "launches_bwd"]

# kernel launches made by swiglu: forward (K10a) and backward (K10b)
launches = 0
launches_bwd = 0


def swiglu_plain(gate, up):
    """``silu(gate) * up`` in f32, rounded once to ``gate``'s type."""
    g = gate.float()
    return (g * torch.sigmoid(g) * up.float()).to(gate.dtype)


def swiglu_bwd_plain(gate, up, dout):
    """The vjp of :func:`swiglu_plain` in the Pallas kernel's f32 order:
    ``(dgate, dup)`` in ``gate``'s and ``up``'s types."""
    g, u, do = gate.float(), up.float(), dout.float()
    sig = torch.sigmoid(g)
    dg = do * u * sig * (1.0 + g * (1.0 - sig))
    du = do * (g * sig)
    return dg.to(gate.dtype), du.to(up.dtype)


@functools.lru_cache(maxsize=None)
def _kernel_fns():
    """The two launchers, looked up and typed once per process."""
    lib = _build.library("swiglu")
    fwd, bwd = lib.swiglu_fwd, lib.swiglu_bwd
    fwd.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int,
                                            ctypes.c_void_p]
    bwd.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_longlong, ctypes.c_int,
                                            ctypes.c_void_p]
    fwd.restype = bwd.restype = ctypes.c_int
    return fwd, bwd


def _check(*named):
    """The tensors share the first one's shape, type and device, are
    contiguous, and are bf16 or f32."""
    first = named[0][1]
    if first.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"kernel takes bf16 or f32, got {first.dtype}")
    for name, t in named:
        if t.device != first.device:
            raise ValueError(f"{name} is on {t.device}, gate on "
                             f"{first.device}")
        if t.shape != first.shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, gate "
                             f"{tuple(first.shape)}")
        if t.dtype != first.dtype:
            raise TypeError(f"{name} is {t.dtype}, gate {first.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _fwd(gate, up):
    """K10a for CUDA tensors, the plain version for CPU ones."""
    if gate.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no swiglu kernel for {gate.device}")
    return _fwd_op(gate, up)


@torch.library.custom_op("paddle_tpu_torch::swiglu_fwd", mutates_args=(),
                         device_types="cpu")
def _fwd_op(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    """K10a as an op; on the CPU its plain version."""
    return swiglu_plain(gate, up)


@_fwd_op.register_fake
def _fwd_op_fake(gate, up):
    return torch.empty_like(gate)


@_fwd_op.register_kernel("cuda")
def _fwd_kernel(gate, up):
    """K10a on CUDA tensors."""
    _check(("gate", gate), ("up", up))
    global launches
    out = torch.empty_like(gate)
    if gate.numel() == 0:
        return out
    err = _kernel_fns()[0](gate.data_ptr(), up.data_ptr(), out.data_ptr(),
                           gate.numel(), int(gate.dtype == torch.bfloat16),
                           _stream(gate))
    if err:
        raise RuntimeError(f"swiglu forward kernel launch failed: cudaError "
                           f"{err}")
    launches += 1
    return out


def _bwd(gate, up, dout):
    """K10b for CUDA tensors, the plain version for CPU ones."""
    if gate.device.type == "cpu":
        return swiglu_bwd_plain(gate, up, dout)
    if gate.device.type != "cuda":
        raise ValueError(f"no swiglu kernel for {gate.device}")
    _check(("gate", gate), ("up", up), ("dout", dout))
    global launches_bwd
    dg, du = torch.empty_like(gate), torch.empty_like(up)
    if gate.numel() == 0:
        return dg, du
    err = _kernel_fns()[1](gate.data_ptr(), up.data_ptr(), dout.data_ptr(),
                           dg.data_ptr(), du.data_ptr(), gate.numel(),
                           int(gate.dtype == torch.bfloat16), _stream(gate))
    if err:
        raise RuntimeError(f"swiglu backward kernel launch failed: "
                           f"cudaError {err}")
    launches_bwd += 1
    return dg, du


class _SwiGLU(torch.autograd.Function):
    @staticmethod
    def forward(ctx, gate, up):
        ctx.save_for_backward(gate, up)
        return _fwd(gate, up)

    @staticmethod
    def backward(ctx, dout):
        gate, up = ctx.saved_tensors
        return _bwd(gate, up, dout.contiguous())


def swiglu(gate, up):
    """``silu(gate) * up`` for gate and up of one shape ``[..., F]`` and one
    type, differentiable in both; f32 inside, rounded once."""
    return _SwiGLU.apply(gate.contiguous(), up.contiguous())
