"""Fused AdamW step: the CUDA kernel's wrapper and its plain version.

Counterpart of ``paddle_tpu/ops/pallas/fused_adamw.py``:
:func:`fused_adamw` replaces the Pallas ``fused_adamw`` with the
hand-written Hopper kernel in ``csrc/fused_adamw.cu``;
:func:`fused_adamw_plain` follows the Pallas kernel's f32 arithmetic in its
order.

Where JAX returns new arrays (and donates the old ones), the port updates
``p``, ``m`` and ``v`` in place and returns them, on both routes.  A tensor
on the CPU goes to the plain version; a CUDA tensor goes to the kernel, or
the wrapper raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

__all__ = ["fused_adamw", "fused_adamw_plain", "bias_corrections",
           "launches"]

# kernel launches made by fused_adamw
launches = 0


def bias_corrections(t, b1: float, b2: float):
    """``(1 - b1**t, 1 - b2**t)`` as the JAX wrapper computes them: the
    power and the difference in f32, outside the kernel."""
    tf = torch.tensor(float(t), dtype=torch.float32)
    c1 = 1.0 - torch.tensor(b1, dtype=torch.float32) ** tf
    c2 = 1.0 - torch.tensor(b2, dtype=torch.float32) ** tf
    return float(c1), float(c2)


def fused_adamw_plain(p, g, m, v, t, lr, b1=0.9, b2=0.95, eps=1e-8,
                      weight_decay=0.1):
    """One AdamW step in plain f32 PyTorch, in the kernel's order.
    -> ``(new_p, new_m, new_v)``, new tensors."""
    c1, c2 = bias_corrections(t, b1, b2)
    f32 = torch.float32

    def scalar(x):
        return torch.tensor(x, dtype=f32, device=p.device)

    g = g.to(f32)
    m_new = scalar(b1) * m + scalar(1.0 - b1) * g
    v_new = scalar(b2) * v + scalar(1.0 - b2) * g * g
    mhat = m_new / scalar(c1)
    vhat = v_new / scalar(c2)
    lr_t = scalar(lr)
    p_new = (p.to(f32) * (scalar(1.0) - lr_t * scalar(weight_decay))
             - lr_t * mhat / (torch.sqrt(vhat) + scalar(eps)))
    return p_new.to(p.dtype), m_new, v_new


@functools.lru_cache(maxsize=None)
def _kernel_fn():
    """The launcher, looked up and typed once per process."""
    fn = _build.library("fused_adamw").fused_adamw_step
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_int]
                   + [ctypes.c_float] * 9 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _check(p, g, m, v):
    if not (p.shape == g.shape == m.shape == v.shape):
        raise ValueError(f"p, g, m, v must share a shape, got "
                         f"{tuple(p.shape)}, {tuple(g.shape)}, "
                         f"{tuple(m.shape)}, {tuple(v.shape)}")
    if g.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"kernel takes f32 or bf16 gradients, got {g.dtype}")
    for name, t, dt, align in (("p", p, torch.float32, 16),
                               ("g", g, g.dtype, 4 * g.element_size()),
                               ("m", m, torch.float32, 16),
                               ("v", v, torch.float32, 16)):
        if t.device != p.device:
            raise ValueError(f"{name} is on {t.device}, p on {p.device}")
        if t.dtype != dt:
            raise TypeError(f"{name} must be {dt}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % align:
            raise ValueError(f"{name} must start on a {align}-byte boundary")


def fused_adamw(p, g, m, v, t, lr, b1=0.9, b2=0.95, eps=1e-8,
                weight_decay=0.1):
    """One AdamW step with decoupled weight decay on one parameter leaf of
    any shape: f32 ``p``, ``m``, ``v`` (overwritten), f32 or bf16 ``g``,
    ``t`` the step count starting at 1.  Returns ``(p, {"m": m, "v": v})``,
    the slot-in for ``adamw_update``'s rule."""
    if p.device.type == "cpu":
        new_p, new_m, new_v = fused_adamw_plain(p, g, m, v, t, lr, b1, b2,
                                                eps, weight_decay)
        p.copy_(new_p)
        m.copy_(new_m)
        v.copy_(new_v)
        return p, {"m": m, "v": v}
    if p.device.type != "cuda":
        raise ValueError(f"no fused adamw for {p.device}")
    _check(p, g, m, v)
    global launches
    if p.numel() == 0:
        return p, {"m": m, "v": v}
    c1, c2 = bias_corrections(t, b1, b2)
    err = _kernel_fn()(
        p.data_ptr(), g.data_ptr(), m.data_ptr(), v.data_ptr(), p.numel(),
        int(g.dtype == torch.bfloat16), lr, b1, b2, 1.0 - b1, 1.0 - b2, eps,
        weight_decay, c1, c2, torch.cuda.current_stream(p.device).cuda_stream)
    if err:
        raise RuntimeError(f"fused_adamw kernel launch failed: cudaError "
                           f"{err}")
    launches += 1
    return p, {"m": m, "v": v}
