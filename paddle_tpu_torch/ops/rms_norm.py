"""RMSNorm: the CUDA kernels' wrapper and their plain versions.

Counterpart of ``paddle_tpu/ops/pallas/rms_norm.py``: :func:`rms_norm`
replaces the Pallas ``rms_norm`` (forward and backward kernels) with the
hand-written Hopper kernels in ``csrc/rms_norm.cu`` behind one
``autograd.Function``; :func:`rms_norm_plain` and :func:`rms_norm_bwd_plain`
follow the Pallas kernels' f32 arithmetic.  That is not the trunk's
composite ``_rms_norm``, which rounds ``x * rstd`` to x's type before the
weight multiplies it: the kernel rounds once.

A tensor on the CPU goes to the plain versions; a CUDA tensor goes to the
kernels, or the wrapper raises.  The forward is the ``torch.library`` op
``paddle_tpu_torch::rms_norm_fwd`` (CPU: the plain version; CUDA: K9a;
fake: shapes only), so an exported program names it; the backward
launches K9b through ctypes.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

__all__ = ["rms_norm", "rms_norm_plain", "rms_norm_bwd_plain", "launches",
           "launches_bwd"]

# kernel launches made by rms_norm: forward (K9a) and backward (K9b)
launches = 0
launches_bwd = 0


def rms_norm_plain(x, w, eps: float = 1e-6):
    """Rows ``x [n, h]`` and ``w [h]`` -> ``(out [n, h], rstd [n] f32)``:
    ``x * rstd * w`` in f32, rounded once to ``promote(x, w)``."""
    xf = x.float()
    rstd = torch.rsqrt(torch.mean(xf * xf, -1) + eps)
    out = xf * rstd[:, None] * w.float()
    return out.to(torch.promote_types(x.dtype, w.dtype)), rstd


def rms_norm_bwd_plain(x, w, rstd, dout):
    """The vjp of :func:`rms_norm_plain` in the Pallas kernel's f32 order:
    ``(dx [n, h] in x's type, dw [h] f32)``."""
    xhat = x.float() * rstd[:, None]
    do = dout.float()
    wdo = w.float() * do
    c = torch.mean(xhat * wdo, -1, keepdim=True)
    dx = (wdo - xhat * c) * rstd[:, None]
    return dx.to(x.dtype), torch.sum(xhat * do, 0)


@functools.lru_cache(maxsize=None)
def _kernel_fns():
    """The two launchers, looked up and typed once per process."""
    lib = _build.library("rms_norm")
    fwd, bwd = lib.rms_norm_fwd, lib.rms_norm_bwd
    fwd.argtypes = [ctypes.c_void_p] * 4 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_float, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p]
    bwd.argtypes = [ctypes.c_void_p] * 6 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p]
    fwd.restype = bwd.restype = ctypes.c_int
    return fwd, bwd


@functools.lru_cache(maxsize=None)
def _sm_count(index) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _rows_per_block(n, sms) -> int:
    """Rows each backward block sums into its dw partial: about four blocks
    per SM, so the partials stay a small fraction of x."""
    return max(1, -(-n // (4 * sms)))


def _check(x, w, extra=()):
    if x.dim() != 2 or w.dim() != 1 or w.shape[0] != x.shape[1]:
        raise ValueError(f"want x [n, h] and w [h], got {tuple(x.shape)}, "
                         f"{tuple(w.shape)}")
    for name, t in (("x", x), ("w", w)) + tuple(extra):
        if t.dtype not in (torch.bfloat16, torch.float32):
            raise TypeError(f"kernel takes bf16 or f32 {name}, got "
                            f"{t.dtype}")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _fwd(x, w, eps):
    """K9a for CUDA tensors, the plain version for CPU ones: rows
    ``x [n, h]`` -> ``(out, rstd)``."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no rms_norm kernel for {x.device}")
    return _fwd_op(x, w, eps)


@torch.library.custom_op("paddle_tpu_torch::rms_norm_fwd", mutates_args=(),
                         device_types="cpu")
def _fwd_op(x: torch.Tensor, w: torch.Tensor,
            eps: float) -> tuple[torch.Tensor, torch.Tensor]:
    """K9a as an op -> (out, rstd); on the CPU its plain version."""
    return rms_norm_plain(x, w, eps)


@_fwd_op.register_fake
def _fwd_op_fake(x, w, eps):
    return (x.new_empty(x.shape, dtype=torch.promote_types(x.dtype,
                                                           w.dtype)),
            x.new_empty((x.shape[0],), dtype=torch.float32))


@_fwd_op.register_kernel("cuda")
def _fwd_kernel(x, w, eps):
    """K9a on CUDA rows ``x [n, h]``."""
    _check(x, w)
    global launches
    n, h = x.shape
    out = torch.empty((n, h), dtype=torch.promote_types(x.dtype, w.dtype),
                      device=x.device)
    rstd = torch.empty((n,), dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return out, rstd
    err = _kernel_fns()[0](
        x.data_ptr(), w.data_ptr(), out.data_ptr(), rstd.data_ptr(), n, h,
        eps, int(x.dtype == torch.bfloat16), int(w.dtype == torch.bfloat16),
        _stream(x))
    if err:
        raise RuntimeError(f"rms_norm forward kernel launch failed: "
                           f"cudaError {err}")
    launches += 1
    return out, rstd


def _bwd(x, w, rstd, dout):
    """K9b for CUDA tensors, the plain version for CPU ones: ``(dx [n, h]
    in x's type, dw [h] f32)``; dw is the kernel's per-block partials
    summed by one reduction."""
    if x.device.type == "cpu":
        return rms_norm_bwd_plain(x, w, rstd, dout)
    if x.device.type != "cuda":
        raise ValueError(f"no rms_norm kernel for {x.device}")
    _check(x, w, (("dout", dout),))
    out_dtype = torch.promote_types(x.dtype, w.dtype)
    if dout.shape != x.shape or dout.dtype != out_dtype:
        raise ValueError(f"want dout {tuple(x.shape)} {out_dtype}, got "
                         f"{tuple(dout.shape)} {dout.dtype}")
    if rstd.shape != (x.shape[0],) or rstd.dtype != torch.float32 or \
            not rstd.is_contiguous():
        raise ValueError("want rstd [n] f32 contiguous from the forward")
    global launches_bwd
    n, h = x.shape
    dx = torch.empty_like(x)
    if x.numel() == 0:
        return dx, torch.zeros((h,), dtype=torch.float32, device=x.device)
    rpb = _rows_per_block(n, _sm_count(x.device.index or 0))
    partials = torch.empty((-(-n // rpb), h), dtype=torch.float32,
                           device=x.device)
    err = _kernel_fns()[1](
        x.data_ptr(), w.data_ptr(), rstd.data_ptr(), dout.data_ptr(),
        dx.data_ptr(), partials.data_ptr(), n, h, rpb,
        int(x.dtype == torch.bfloat16), int(w.dtype == torch.bfloat16),
        _stream(x))
    if err:
        raise RuntimeError(f"rms_norm backward kernel launch failed: "
                           f"cudaError {err}")
    launches_bwd += 1
    return dx, partials.sum(0)


class _RmsNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, eps):
        shape = x.shape
        xr = x.reshape(-1, shape[-1]).contiguous()
        w = w.contiguous()
        out, rstd = _fwd(xr, w, eps)
        ctx.save_for_backward(xr, w, rstd)
        ctx.shape = shape
        return out.reshape(shape)

    @staticmethod
    def backward(ctx, dout):
        xr, w, rstd = ctx.saved_tensors
        dx, dw = _bwd(xr, w, rstd, dout.reshape(xr.shape).contiguous())
        return dx.reshape(ctx.shape), dw.to(w.dtype), None


def rms_norm(x, w, eps: float = 1e-6):
    """RMSNorm of ``x [..., h]`` by ``w [h]``, differentiable in both: f32
    inside, the output in ``promote(x, w)``, dx in x's type and dw in w's."""
    return _RmsNorm.apply(x, w, eps)
