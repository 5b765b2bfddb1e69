"""Flash attention, forward and backward: the CUDA kernels' wrapper and
their plain versions.

Counterpart of ``paddle_tpu/ops/pallas/flash_attention.py``:
:func:`flash_attention` replaces the Pallas forward (``_flash_fwd``) and its
two backward passes (dq; dk and dv) with the hand-written Hopper kernels in
``csrc/flash_attention.cu`` behind one ``torch.autograd.Function``;
:func:`causal_mask` and :func:`sdpa_plain` mirror ``causal_mask`` and
``_xla_sdpa``; :func:`_fwd_plain`, :func:`_bwd_dq_plain` and
:func:`_bwd_dkv_plain` are the kernels' arithmetic in plain f32 PyTorch
(scores scaled after the product, p from the saved log-sum-exp,
``ds = p * (dp - delta) * scale``).

A tensor on the CPU goes to the plain versions; a CUDA tensor goes to the
kernels, or the wrapper raises.  The forward is the ``torch.library``
op ``paddle_tpu_torch::flash_attention_fwd`` (its CPU implementation the
plain version, its CUDA one the kernel, its fake one shapes only), so an
exported program (``torch.export``) names it and runs the kernel on the
card; the backward passes launch through ctypes, as a program that is
exported for inference never differentiates.  The JAX wrapper sends lengths no
power-of-two block divides to its XLA composite; the kernels mask a ragged
last tile, so on the card every length with ``q_len == kv_len`` runs them
and there is no such branch.  ``q_len != kv_len`` (decode shapes) is not on
the training path: the CPU route takes :func:`sdpa_plain` for it as JAX
does, the CUDA route raises.

The kernels round p and ds to bf16 before their second product, as the TPU
kernels do; the plain versions keep them in f32.  Against f32 plain math on
the same bf16 inputs that adds a relative 2**-9 to each of the S summands
of an output element, which averages out below one bf16 rounding of the
result, the tolerance the comparisons state.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from . import _build

__all__ = ["flash_attention", "causal_mask", "sdpa_plain", "kernel_takes",
           "KERNEL_HEAD_DIMS", "launches", "launches_dq", "launches_dkv"]

NEG_INF = -1e30

# the head sizes the attention kernels take (K6a-c here, K2 and K7a-b in
# flash_varlen), each in bf16
KERNEL_HEAD_DIMS = (64, 128)

# kernel launches made by flash_attention: forward, backward dq, backward
# dk / dv
launches = 0
launches_dq = 0
launches_dkv = 0


def kernel_takes(q, dtype=None) -> bool:
    """Whether the card's attention kernels (K6a-c, K2, K7a-b) take q
    ``[..., d]`` run in ``dtype`` (q's own when None): bf16 at a head_dim
    in ``KERNEL_HEAD_DIMS``.  The API's routes ask it before anything
    launches; the wrappers' checks raise on the same rule."""
    dtype = q.dtype if dtype is None else dtype
    return dtype == torch.bfloat16 and q.shape[-1] in KERNEL_HEAD_DIMS


def causal_mask(q_len: int, k_len: int, device=None):
    """Boolean [q_len, k_len] causal mask with the diagonal aligned to the
    END of the kv sequence.  Raises when ``q_len > k_len``: end-aligned
    causal would fully mask the leading rows."""
    if q_len > k_len:
        raise ValueError(
            f"causal attention requires q_len <= kv_len, got "
            f"q_len={q_len} kv_len={k_len}")
    q_pos = torch.arange(q_len, device=device)[:, None] + (k_len - q_len)
    k_pos = torch.arange(k_len, device=device)[None, :]
    return q_pos >= k_pos


def sdpa_plain(q, k, v, causal):
    """Dense attention in f32, q / k / v [b, s, h, d] -> [b, s, h, d] in
    ``q``'s type; differentiable by autograd.  Counterpart of
    ``_xla_sdpa``."""
    d = q.shape[-1]
    qf = q.float() / math.sqrt(d)
    s = torch.einsum("bqhd,bkhd->bhqk", qf, k.float())
    if causal:
        mask = causal_mask(q.shape[1], k.shape[1], q.device)
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return out.to(q.dtype)


def _scores(q, k, causal):
    """Scaled, masked f32 scores [b, h, q, k] in the kernels' order."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    s = s * (1.0 / math.sqrt(q.shape[-1]))
    if causal:
        mask = causal_mask(q.shape[1], k.shape[1], q.device)
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    return s


def _fwd_plain(q, k, v, causal):
    """-> (out [b, s, h, d] in q's type, lse [b, h, s] f32)."""
    s = _scores(q, k, causal)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None])
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return out.to(q.dtype), lse


def _p_ds_plain(q, k, v, dout, lse, delta, causal):
    """p and ds [b, h, q, k] f32, recomputed from the saved log-sum-exp as
    both backward kernels do."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    p = torch.exp(_scores(q, k, causal) - lse[..., None])
    dp = torch.einsum("bqhd,bkhd->bhqk", dout.float(), v.float())
    return p, p * (dp - delta[..., None]) * scale


def _bwd_dq_plain(q, k, v, dout, lse, delta, causal):
    """The dq kernel's plain version."""
    _, ds = _p_ds_plain(q, k, v, dout, lse, delta, causal)
    return torch.einsum("bhqk,bkhd->bqhd", ds, k.float()).to(q.dtype)


def _bwd_dkv_plain(q, k, v, dout, lse, delta, causal):
    """The dk / dv kernel's plain version -> (dk, dv)."""
    p, ds = _p_ds_plain(q, k, v, dout, lse, delta, causal)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float())
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dout.float())
    return dk.to(k.dtype), dv.to(v.dtype)


@functools.lru_cache(maxsize=None)
def _kernel_fns():
    """The three launchers, looked up and typed once per process."""
    lib = _build.library("flash_attention")
    tail = [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p]
    fwd = lib.flash_attention_fwd_bf16
    fwd.argtypes = [ctypes.c_void_p] * 5 + tail
    dq = lib.flash_attention_bwd_dq_bf16
    dq.argtypes = [ctypes.c_void_p] * 7 + tail
    dkv = lib.flash_attention_bwd_dkv_bf16
    dkv.argtypes = [ctypes.c_void_p] * 8 + tail
    for fn in (fwd, dq, dkv):
        fn.restype = ctypes.c_int
    return fwd, dq, dkv


def _check(named):
    """``named``: (name, tensor) pairs, the first q.  Every tensor bf16
    [b, s, h, d], of q's shape and device, contiguous, 16-byte aligned."""
    q = named[0][1]
    if q.dim() != 4:
        raise ValueError(f"want q [b, s, h, d], got {tuple(q.shape)}")
    b, s, h, d = q.shape
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"kernel takes head_dim {KERNEL_HEAD_DIMS}, got "
                         f"{d}")
    if h > 65535 or b > 65535:
        raise ValueError(f"kernel takes at most 65535 heads and batch rows, "
                         f"got {h} and {b}")
    for name, t in named:
        if t.shape != q.shape:
            if t.dim() == 4 and t.shape[1] != s:
                raise ValueError(
                    f"the kernel takes q_len == kv_len only (the training "
                    f"shapes), got q {tuple(q.shape)} and {name} "
                    f"{tuple(t.shape)}")
            raise ValueError(
                f"{name} {tuple(t.shape)} differs from q {tuple(q.shape)}: "
                f"the kernel takes equal lengths and head counts (repeat "
                f"K/V to the q heads first)")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{name} must be bf16, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary")


def _launch_tail(q, causal):
    b, s, h, d = q.shape
    return (b, s, h, d, int(bool(causal)), 1.0 / math.sqrt(d),
            torch.cuda.current_stream(q.device).cuda_stream)


def _fwd_kernel(q, k, v, causal):
    """K6a on CUDA tensors -> (out, lse [b, h, s] f32)."""
    _check([("q", q), ("k", k), ("v", v)])
    global launches
    b, s, h, _ = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    if q.numel() == 0:
        return out, lse
    err = _kernel_fns()[0](q.data_ptr(), k.data_ptr(), v.data_ptr(),
                           out.data_ptr(), lse.data_ptr(),
                           *_launch_tail(q, causal))
    if err:
        raise RuntimeError(f"flash_attention forward kernel launch failed: "
                           f"cudaError {err}")
    launches += 1
    return out, lse


def _bwd_dq_kernel(q, k, v, dout, lse, delta, causal):
    """K6b on CUDA tensors -> dq."""
    _check([("q", q), ("k", k), ("v", v), ("dout", dout)])
    global launches_dq
    dq = torch.empty_like(q)
    if q.numel() == 0:
        return dq
    err = _kernel_fns()[1](q.data_ptr(), k.data_ptr(), v.data_ptr(),
                           dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                           dq.data_ptr(), *_launch_tail(q, causal))
    if err:
        raise RuntimeError(f"flash_attention dq kernel launch failed: "
                           f"cudaError {err}")
    launches_dq += 1
    return dq


def _bwd_dkv_kernel(q, k, v, dout, lse, delta, causal):
    """K6c on CUDA tensors -> (dk, dv)."""
    _check([("q", q), ("k", k), ("v", v), ("dout", dout)])
    global launches_dkv
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if q.numel() == 0:
        return dk, dv
    err = _kernel_fns()[2](q.data_ptr(), k.data_ptr(), v.data_ptr(),
                           dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                           dk.data_ptr(), dv.data_ptr(),
                           *_launch_tail(q, causal))
    if err:
        raise RuntimeError(f"flash_attention dk/dv kernel launch failed: "
                           f"cudaError {err}")
    launches_dkv += 1
    return dk, dv


def _delta(dout, out):
    """``sum(do * out, -1)`` in f32 as [b, h, s], outside the kernels as in
    the JAX backward."""
    return (dout.float() * out.float()).sum(-1).permute(0, 2, 1).contiguous()


def _route(q):
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no flash attention for {q.device}")
    return q.device.type


@torch.library.custom_op("paddle_tpu_torch::flash_attention_fwd",
                         mutates_args=(), device_types="cpu")
def _fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            causal: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """K6a as an op -> (out, lse); on the CPU its plain version."""
    return _fwd_plain(q, k, v, causal)


@_fwd_op.register_kernel("cuda")
def _fwd_op_cuda(q, k, v, causal):
    return _fwd_kernel(q, k, v, causal)


@_fwd_op.register_fake
def _fwd_op_fake(q, k, v, causal):
    b, s, h, _ = q.shape
    return torch.empty_like(q), q.new_empty((b, h, s), dtype=torch.float32)


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal):
        _route(q)
        out, lse = _fwd_op(q, k, v, causal)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dout = dout.contiguous()
        delta = _delta(dout, out)
        if _route(q) == "cpu":
            dq_fn, dkv_fn = _bwd_dq_plain, _bwd_dkv_plain
        else:
            dq_fn, dkv_fn = _bwd_dq_kernel, _bwd_dkv_kernel
        dq = dq_fn(q, k, v, dout, lse, delta, ctx.causal)
        dk, dv = dkv_fn(q, k, v, dout, lse, delta, ctx.causal)
        return dq, dk, dv, None


def flash_attention(q, k, v, causal: bool = False):
    """q / k / v [b, s, h, d] (equal head counts) -> out [b, s, h, d],
    differentiable in q, k and v.  On the card: bf16, head_dim 64 or 128,
    ``q_len == kv_len``, any length."""
    if q.shape[1] != k.shape[1]:
        if causal:
            causal_mask(q.shape[1], k.shape[1])    # raises if q_len > kv_len
        if _route(q) == "cpu":
            return sdpa_plain(q, k, v, causal)
        raise ValueError(
            f"the kernel takes q_len == kv_len only (the training shapes), "
            f"got q_len={q.shape[1]} kv_len={k.shape[1]}")
    return _FlashAttention.apply(q, k, v, causal)
