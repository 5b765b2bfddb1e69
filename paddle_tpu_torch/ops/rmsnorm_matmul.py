"""Fused RMSNorm -> matmul: the CUDA kernel's wrapper, its plain version and
the backward.

Counterpart of ``paddle_tpu/ops/pallas/rmsnorm_matmul.py``:
:func:`rmsnorm_matmul` replaces the Pallas ``rmsnorm_matmul`` forward with
the hand-written Hopper kernel in ``csrc/rmsnorm_matmul.cu``;
:func:`rmsnorm_matmul_plain` is the kernel's formula (``bf16(x * wl) @ W``
accumulated in f32, times the row's rstd, rounded once); the backward is
JAX's ``_bwd_vjp`` in plain PyTorch, in f32 as JAX computes it (its
products go to the library, as JAX leaves them to XLA).

JAX's wrapper sends shapes its TPU tiling cannot cut (``M % 8``,
``N % 128``, ``H % 128``) to ``_xla_ref``, which normalises before the
product; the port's kernel masks its edges, so every shape takes the
kernel's formula (the two agree to f32 rounding).

A tensor on the CPU goes to the plain version; a CUDA tensor goes to the
kernel, or the wrapper raises.  On the card the kernel takes bf16 x and W
and H a positive multiple of 16.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

__all__ = ["rmsnorm_matmul", "rmsnorm_matmul_plain", "launches"]

# kernel launches made by rmsnorm_matmul (K11, forward only)
launches = 0


def rmsnorm_matmul_plain(x, wl, w, eps: float = 1e-6):
    """Rows ``x [M, H]``, ``wl [H]``, ``w [H, N]`` -> ``[M, N]`` in x's
    type: ``(x * wl)`` rounded to x's type, the product in f32, scaled by
    each row's ``rsqrt(mean(x^2) + eps)``, rounded once."""
    xf = x.float()
    rstd = torch.rsqrt(torch.mean(xf * xf, -1, keepdim=True) + eps)
    acc = (xf * wl.float()).to(x.dtype).float() @ w.float()
    return (acc * rstd).to(x.dtype)


def _bwd(x, wl, w, dout, eps):
    """JAX's ``_bwd_vjp``: the cotangents of x, wl and w in f32 math, each
    returned in its input's type."""
    xf = x.float()
    rstd = torch.rsqrt(torch.mean(xf * xf, -1, keepdim=True) + eps)
    xhat = xf * rstd
    wlf = wl.float()
    y = xhat * wlf
    do = dout.float()
    H, N = w.shape
    dw = y.reshape(-1, H).t() @ do.reshape(-1, N)
    dy = do @ w.float().t()
    dwl = torch.sum((xhat * dy).reshape(-1, H), 0)
    wdy = wlf * dy
    c = torch.mean(xhat * wdy, -1, keepdim=True)
    dx = (wdy - xhat * c) * rstd
    return dx.to(x.dtype), dwl.to(wl.dtype), dw.to(w.dtype)


@functools.lru_cache(maxsize=None)
def _kernel_fn():
    """The launcher, looked up and typed once per process."""
    fn = _build.library("rmsnorm_matmul").rmsnorm_matmul_bf16
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(x, wl, w):
    if x.dim() != 2 or wl.dim() != 1 or w.dim() != 2:
        raise ValueError(f"want x [M, H], wl [H] and w [H, N], got "
                         f"{tuple(x.shape)}, {tuple(wl.shape)}, "
                         f"{tuple(w.shape)}")
    H = x.shape[1]
    if wl.shape[0] != H or w.shape[0] != H:
        raise ValueError(f"shapes do not chain: x {tuple(x.shape)}, wl "
                         f"{tuple(wl.shape)}, w {tuple(w.shape)}")
    if H == 0 or H % 16:
        raise ValueError(f"kernel takes H a positive multiple of 16, got "
                         f"H={H}")
    for name, t, dts in (("x", x, (torch.bfloat16,)),
                         ("wl", wl, (torch.bfloat16, torch.float32)),
                         ("w", w, (torch.bfloat16,))):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if t.dtype not in dts:
            raise TypeError(f"kernel takes {name} in {dts}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary")


def _fwd(x, wl, w, eps):
    """K11 for CUDA tensors, the plain version for CPU ones: rows
    ``x [M, H]`` -> ``[M, N]``."""
    if x.device.type == "cpu":
        return rmsnorm_matmul_plain(x, wl, w, eps)
    if x.device.type != "cuda":
        raise ValueError(f"no rmsnorm_matmul kernel for {x.device}")
    _check(x, wl, w)
    global launches
    M, H = x.shape
    N = w.shape[1]
    out = torch.empty((M, N), dtype=torch.bfloat16, device=x.device)
    if M == 0 or N == 0:
        return out
    err = _kernel_fn()(
        x.data_ptr(), wl.data_ptr(), w.data_ptr(), out.data_ptr(), M, N, H,
        eps, int(wl.dtype == torch.bfloat16),
        torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"rmsnorm_matmul kernel launch failed: cudaError "
                           f"{err}")
    launches += 1
    return out


class _RmsNormMatmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, wl, w, eps):
        lead = x.shape[:-1]
        out = _fwd(x.reshape(-1, x.shape[-1]).contiguous(), wl.contiguous(),
                   w.contiguous(), eps)
        ctx.save_for_backward(x, wl, w)
        ctx.eps = eps
        return out.reshape(*lead, w.shape[1])

    @staticmethod
    def backward(ctx, dout):
        x, wl, w = ctx.saved_tensors
        return (*_bwd(x, wl, w, dout, ctx.eps), None)


def rmsnorm_matmul(x, wl, w, eps: float = 1e-6):
    """``rms_norm(x, wl) @ w`` fused: ``x [..., H]``, ``wl [H]``,
    ``w [H, N]`` -> ``[..., N]`` in x's type, differentiable in all three
    (JAX's f32 backward)."""
    return _RmsNormMatmul.apply(x, wl, w, eps)
