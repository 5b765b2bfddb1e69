"""Segmented (packed varlen) causal attention: the CUDA kernel's wrapper, its
plain version and the per-tile block ranges.

Counterpart of ``paddle_tpu/ops/pallas/flash_varlen.py``, forward only:
:func:`flash_attention_segmented` replaces the Pallas forward (``_seg_fwd``)
with the hand-written Hopper kernel in ``csrc/flash_varlen.cu``;
:func:`segmented_sdpa_plain` mirrors ``xla_segmented_sdpa``;
:func:`_segment_block_ranges` is a copy of the JAX function of that name.

A tensor on the CPU goes to the plain version; a CUDA tensor goes to the
kernel, or the wrapper raises.  The JAX wrapper's dense fallback for
lengths no block divides has no counterpart: the kernel masks a ragged last
tile itself, so every length runs the block-skipping kernel.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from ..models.decode import _grouped_attn
from . import _build

__all__ = ["flash_attention_segmented", "segmented_sdpa_plain",
           "_segment_block_ranges", "_seg_fwd", "launches", "BLOCK_ROWS"]

# q rows (and keys) per tile of the kernel; its per-tile ranges are
# computed at this height
BLOCK_ROWS = 64

# kernel launches made by flash_attention_segmented / _seg_fwd
launches = 0


def _segment_block_ranges(seg, block):
    """Per-block [first, last] row index of the segments the block
    touches.  seg: [B, S] int32 (contiguous runs), S % block == 0.
    Returns (lo [B, nb], hi [B, nb]) int32, both inclusive row indices."""
    B, S = seg.shape
    idx = torch.arange(S, dtype=torch.int32, device=seg.device)[None]
    edge = torch.full((B, 1), -1_000_000, dtype=seg.dtype, device=seg.device)
    prev = torch.cat([edge, seg[:, :-1]], dim=1)
    start_of = torch.cummax(torch.where(seg != prev, idx, 0), dim=1).values
    nxt = torch.cat([seg[:, 1:], edge], dim=1)
    end_of = torch.where(seg != nxt, idx, S - 1).flip(1)
    end_of = torch.cummin(end_of, dim=1).values.flip(1)
    nb = S // block
    lo = start_of.reshape(B, nb, block)[:, :, 0]
    hi = end_of.reshape(B, nb, block)[:, :, -1]
    return lo.to(torch.int32), hi.to(torch.int32)


def segmented_sdpa_plain(q, k, v, seg, causal):
    """Dense-mask attention within segments, fp32 math.  q [b, s, h, d],
    k/v [b, s, nkv, d] with nkv dividing h, seg [b, s] int.  Counterpart of
    ``xla_segmented_sdpa``."""
    s = q.shape[1]
    seg = seg.to(q.device)
    m = seg[:, :, None] == seg[:, None, :]                 # [b, q, k]
    if causal:
        pos = torch.arange(s, device=q.device)
        m = m & (pos[:, None] >= pos[None, :])
    out = _grouped_attn(q.float(), k.float(), v.float(), m[:, None, None])
    return out.to(q.dtype)


@functools.lru_cache(maxsize=None)
def _kernel_fn():
    """The launcher, looked up and typed once per process."""
    fn = _build.library("flash_varlen").flash_segmented_fwd_bf16
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [
        ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(q, k, v, seg):
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"want q [b, s, h, d] and k/v [b, s, nkv, d], got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, s, h, d = q.shape
    if k.shape[0] != b or k.shape[1] != s or k.shape[3] != d:
        raise ValueError("k/v batch, length or head_dim differ from q's")
    if h % k.shape[2]:
        raise ValueError(f"q heads {h} must be a multiple of kv heads "
                         f"{k.shape[2]}")
    if d not in (64, 128):
        raise ValueError(f"kernel takes head_dim 64 or 128, got {d}")
    if seg.shape != (b, s):
        raise ValueError(f"segment ids {tuple(seg.shape)} != [{b}, {s}]")
    for name, t, dt in (("q", q, torch.bfloat16), ("k", k, torch.bfloat16),
                        ("v", v, torch.bfloat16), ("seg", seg, torch.int32)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype != dt:
            raise TypeError(f"{name} must be {dt}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _tile_ranges(seg):
    """The kernel's per-tile key ranges: :func:`_segment_block_ranges` at
    ``BLOCK_ROWS`` over the stream padded to whole tiles.  The pad is a
    run of its own (an id differing from the last row's), and the kernel
    masks every row and key past the real length.  -> (kmin, kmax)
    [b, ceil(s / BLOCK_ROWS)] int32, contiguous."""
    b, s = seg.shape
    pad = -s % BLOCK_ROWS
    if pad:
        seg = torch.cat([seg, (seg[:, -1:] + 1).expand(b, pad)], dim=1)
    kmin, kmax = _segment_block_ranges(seg, BLOCK_ROWS)
    return kmin.contiguous(), kmax.contiguous()


def _seg_fwd(q, k, v, seg, causal):
    """Kernel forward on CUDA tensors -> (out [b, s, h, d], lse [b, h, s]
    fp32)."""
    _check(q, k, v, seg)
    global launches
    b, s, h, d = q.shape
    kmin, kmax = _tile_ranges(seg)
    out = torch.empty_like(q)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    err = _kernel_fn()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), seg.data_ptr(),
        kmin.data_ptr(), kmax.data_ptr(), out.data_ptr(), lse.data_ptr(),
        b, s, h, k.shape[2], d, int(bool(causal)), 1.0 / math.sqrt(d),
        torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"flash_attention_segmented kernel launch "
                           f"failed: cudaError {err}")
    launches += 1
    return out, lse


def flash_attention_segmented(q, k, v, segment_ids, causal=False):
    """Ragged/varlen attention: q [b, s, h, d] PACKED along s, k/v
    [b, s, nkv, d] with nkv dividing h (GQA-native), segment_ids [b, s]
    (or [s]) int32 contiguous runs; attention stays within a segment."""
    seg = segment_ids
    if seg.dim() == 1:
        seg = seg[None]
    if q.shape[2] % k.shape[2] != 0:
        raise ValueError(
            f"q heads {q.shape[2]} must be a multiple of kv heads "
            f"{k.shape[2]}")
    if q.device.type == "cpu":
        return segmented_sdpa_plain(q, k, v, seg, causal)
    if q.device.type != "cuda":
        raise ValueError(f"no segmented attention for {q.device}")
    return _seg_fwd(q, k, v, seg.to(torch.int32).contiguous(), causal)[0]
