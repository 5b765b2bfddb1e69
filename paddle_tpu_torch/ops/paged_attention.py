"""Paged-KV decode attention: the CUDA kernel's wrapper and its plain version.

Counterpart of ``paddle_tpu/ops/pallas/paged_attention.py``:
:func:`paged_decode_attention` replaces the Pallas ``paged_decode_attention``
with the hand-written Hopper kernel in ``csrc/paged_attention.cu``, and
:func:`paged_decode_attention_plain` mirrors ``paged_decode_attention_xla``.

A tensor on the CPU goes to the plain version; a CUDA tensor goes to the
kernel, or the wrapper raises.  There is no quiet fallback from one to the
other.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from ..models.decode import _grouped_attn
from . import _build

__all__ = ["paged_decode_attention", "paged_decode_attention_plain",
           "launches"]

# kernel launches made by paged_decode_attention (a run can show that its
# main path went through the kernel)
launches = 0

_MAX_GROUP = 16            # q heads per kv head the kernel holds
_MAX_SMEM = 227 * 1024     # dynamic shared memory a Hopper block may use


def paged_decode_attention_plain(q, kpool, vpool, block_tables,
                                 context_lens, sm_scale=None):
    """Gather each row's pages and run masked attention in fp32.

    q [B, n, d]; kpool / vpool [num_pages, nkv, page, d]; block_tables
    [B, pages_max] int; context_lens [B] int -> [B, n, d] in q's dtype.
    Counterpart of ``paged_decode_attention_xla``; like it, a row with
    ``len == 0`` averages its (junk) pages instead of writing zeros."""
    B, n, d = q.shape
    num_pages, nkv, page, _ = kpool.shape
    pages_max = block_tables.shape[1]
    S = pages_max * page
    tables = block_tables.long()
    # [B, pages_max, nkv, page, d] -> [B, S, nkv, d]
    kg = kpool[tables].permute(0, 1, 3, 2, 4).reshape(B, S, nkv, d)
    vg = vpool[tables].permute(0, 1, 3, 2, 4).reshape(B, S, nkv, d)
    valid = (torch.arange(S, device=q.device)[None]
             < context_lens.to(q.device).long()[:, None])
    mask = valid[:, None, None, None, :]          # [B, 1, 1, 1, S]
    qf = q.float()[:, None]
    if sm_scale is not None:
        # _grouped_attn scales by 1/sqrt(d); fold the ratio into q
        qf = qf * (sm_scale * math.sqrt(d))
    out = _grouped_attn(qf, kg.float(), vg.float(), mask)
    return out[:, 0].to(q.dtype)


@functools.lru_cache(maxsize=None)
def _kernel_fn():
    """The launcher, looked up and typed once per process."""
    fn = _build.library("paged_attention").paged_decode_attention_bf16
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [
        ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _smem_bytes(n, nkv, d, page) -> int:
    fn = _build.library("paged_attention").paged_decode_attention_smem_bytes
    fn.argtypes = [ctypes.c_int] * 4
    fn.restype = ctypes.c_longlong
    return int(fn(n, nkv, d, page))


def _check(q, kpool, vpool, block_tables, context_lens):
    if q.dim() != 3 or kpool.dim() != 4 or kpool.shape != vpool.shape:
        raise ValueError(
            f"want q [B, n, d] and pools [P, nkv, page, d], got "
            f"{tuple(q.shape)}, {tuple(kpool.shape)}, {tuple(vpool.shape)}")
    B, n, d = q.shape
    _, nkv, page, dk = kpool.shape
    if dk != d or n % nkv or n // nkv > _MAX_GROUP or d % 8 or d > 256:
        raise ValueError(
            f"kernel takes n % nkv == 0, n / nkv <= {_MAX_GROUP}, d % 8 == 0 "
            f"and d <= 256; got n={n} nkv={nkv} d={d} (pool d={dk})")
    if block_tables.shape[0] != B or context_lens.shape != (B,):
        raise ValueError("block_tables [B, pages_max] / context_lens [B] "
                         "do not match q's batch")
    for name, t, dt in (("q", q, torch.bfloat16),
                        ("kpool", kpool, torch.bfloat16),
                        ("vpool", vpool, torch.bfloat16),
                        ("block_tables", block_tables, torch.int32),
                        ("context_lens", context_lens, torch.int32)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype != dt:
            raise TypeError(f"{name} must be {dt}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if _smem_bytes(n, nkv, d, page) > _MAX_SMEM:
        raise ValueError(f"page {page} x d {d} needs more shared memory "
                         f"than a block has")


def paged_decode_attention(q, kpool, vpool, block_tables, context_lens,
                           sm_scale=None):
    """One decode step of attention against a paged KV cache.

    q:             [B, n, d]        (single new token per row)
    kpool/vpool:   [num_pages, nkv, page, d]
    block_tables:  [B, pages_max] int32 (entries past the row's length
                   point at the junk page 0 and are skipped)
    context_lens:  [B] int32 (valid kv entries per row, including the
                   current token, whose k/v must already be written)
    -> [B, n, d]
    """
    if q.device.type == "cpu":
        return paged_decode_attention_plain(q, kpool, vpool, block_tables,
                                            context_lens, sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"no paged decode attention for {q.device}")
    _check(q, kpool, vpool, block_tables, context_lens)
    global launches
    B, n, d = q.shape
    _, nkv, page, _ = kpool.shape
    scale = sm_scale or (1.0 / math.sqrt(d))
    out = torch.empty_like(q)
    err = _kernel_fn()(
        q.data_ptr(), kpool.data_ptr(), vpool.data_ptr(),
        block_tables.data_ptr(), context_lens.data_ptr(), out.data_ptr(),
        B, n, nkv, d, page, block_tables.shape[1], scale,
        torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"paged_decode_attention kernel launch failed: "
                           f"cudaError {err}")
    launches += 1
    return out
