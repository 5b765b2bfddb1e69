"""Segmented (packed varlen) causal attention, forward and backward: the
CUDA kernels' wrappers, their plain versions and the per-tile block ranges.

Counterpart of ``paddle_tpu/ops/pallas/flash_varlen.py``:
:func:`flash_attention_segmented` replaces the Pallas forward (``_seg_fwd``,
K2, in ``csrc/flash_varlen.cu``) and its two backward passes (dq, K7a; dk and
dv, K7b, in ``csrc/flash_varlen_bwd.cu``) with hand-written Hopper kernels
behind one ``torch.autograd.Function``, as ``_flash_seg``'s custom_vjp does;
:func:`segmented_sdpa_plain` mirrors ``xla_segmented_sdpa``;
:func:`_segment_block_ranges` and :func:`segment_ids_from_cu_seqlens` are
copies of the JAX functions of those names; :func:`_seg_bwd_dq_plain` and
:func:`_seg_bwd_dkv_plain` are the backward kernels' arithmetic in plain f32
PyTorch (dense masks; dk and dv summed over each GQA group's q heads).

A tensor on the CPU goes to the plain version, which autograd
differentiates; a CUDA tensor goes to the kernels, or the wrapper raises.
The JAX wrapper's dense fallback for lengths no block divides has no
counterpart: the kernels mask a ragged last tile themselves, so every length
runs the block-skipping kernels.  The backward kernels round p and ds to
bf16 before their second product, as the TPU kernels do; the plain versions
keep them in f32.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from ..models.decode import _grouped_attn
from . import _build
from .flash_attention import _delta

__all__ = ["flash_attention_segmented", "segmented_sdpa_plain",
           "segment_ids_from_cu_seqlens", "_segment_block_ranges",
           "_seg_fwd", "_seg_bwd", "launches", "launches_bwd_dq",
           "launches_bwd_dkv", "launches_ranges", "BLOCK_ROWS",
           "FWD_BLOCK_ROWS"]

# q rows (and keys) per tile of the backward kernels (K7a, K7b): their
# per-tile ranges are computed at this height
BLOCK_ROWS = 64
# q rows per tile of the forward kernel (K2), and keys per tile it visits
FWD_BLOCK_ROWS = 128

# kernel launches made by flash_attention_segmented: the forward (K2), the
# backward's dq pass (K7a) and its dk / dv pass (K7b); and by
# _tile_ranges, the per-tile range kernel each of K2 and the backward
# launches first
launches = 0
launches_bwd_dq = 0
launches_bwd_dkv = 0
launches_ranges = 0


def segment_ids_from_cu_seqlens(cu, total):
    """cu_seqlens [n+1] (monotone, cu[0] = 0, cu[-1] = total) -> int32
    [total] segment ids 0..n-1."""
    cu = torch.as_tensor(cu)
    pos = torch.arange(total, dtype=torch.int32, device=cu.device)
    return torch.searchsorted(cu[1:].to(torch.int32), pos,
                              right=True).to(torch.int32)


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


def _seg_vis(seg, causal):
    """[b, 1, q, k] bool: the pairs in one segment (and k <= q when
    causal)."""
    s = seg.shape[1]
    m = seg[:, :, None] == seg[:, None, :]
    if causal:
        pos = torch.arange(s, device=seg.device)
        m = m & (pos[:, None] >= pos[None, :])
    return m[:, None]


def segmented_sdpa_plain(q, k, v, seg, causal):
    """Dense-mask attention within segments, fp32 math.  q [b, s, h, d],
    k/v [b, s, nkv, d] with nkv dividing h, seg [b, s] int.  Counterpart of
    ``xla_segmented_sdpa``."""
    m = _seg_vis(seg.to(q.device), causal)                 # [b, 1, q, k]
    out = _grouped_attn(q.float(), k.float(), v.float(), m[:, None])
    return out.to(q.dtype)


def _full_heads(x, h):
    """k or v [b, s, nkv, d] repeated up to the ``h`` q heads, f32."""
    return x.float().repeat_interleave(h // x.shape[2], dim=2)


def _seg_scores(q, k, seg, causal):
    """Scaled f32 scores [b, h, q, k] in the kernels' order, and the
    visible pairs [b, 1, q, k]."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), _full_heads(k, q.shape[2]))
    return s * (1.0 / math.sqrt(q.shape[-1])), _seg_vis(seg.to(q.device),
                                                         causal)


def _seg_p_ds_plain(q, k, v, seg, dout, lse, delta, causal):
    """p and ds [b, h, q, k] f32 from the saved log-sum-exp, zero off the
    visible pairs, as both backward kernels compute them."""
    s, vis = _seg_scores(q, k, seg, causal)
    p = torch.where(vis, torch.exp(s - lse[..., None]), 0.0)
    dp = torch.einsum("bqhd,bkhd->bhqk", dout.float(),
                      _full_heads(v, q.shape[2]))
    return p, p * (dp - delta[..., None]) * (1.0 / math.sqrt(q.shape[-1]))


def _seg_bwd_dq_plain(q, k, v, seg, dout, lse, delta, causal):
    """The dq kernel's (K7a's) plain version -> dq in q's type."""
    _, ds = _seg_p_ds_plain(q, k, v, seg, dout, lse, delta, causal)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, _full_heads(k, q.shape[2]))
    return dq.to(q.dtype)


def _group_sum(x, nkv):
    """[b, s, h, d] per q head -> [b, s, nkv, d], each kv head's group of
    q heads summed."""
    b, s, h, d = x.shape
    return x.reshape(b, s, nkv, h // nkv, d).sum(3)


def _seg_bwd_dkv_plain(q, k, v, seg, dout, lse, delta, causal):
    """The dk / dv kernel's (K7b's) plain version -> (dk, dv) at k's kv
    heads and types."""
    p, ds = _seg_p_ds_plain(q, k, v, seg, dout, lse, delta, causal)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float())
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dout.float())
    nkv = k.shape[2]
    return _group_sum(dk, nkv).to(k.dtype), _group_sum(dv, nkv).to(v.dtype)


@functools.lru_cache(maxsize=None)
def _fwd_fn():
    """The forward's launcher, looked up and typed once per process."""
    fn = _build.library("flash_varlen").flash_segmented_fwd_bf16
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [
        ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _bwd_fns():
    """The two backward launchers (dq, dk / dv), from their own library, so
    the forward alone (serving) never builds it."""
    lib = _build.library("flash_varlen_bwd")
    tail = [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_void_p]
    dq = lib.flash_segmented_bwd_dq_bf16
    dq.argtypes = [ctypes.c_void_p] * 10 + tail
    dkv = lib.flash_segmented_bwd_dkv_bf16
    dkv.argtypes = [ctypes.c_void_p] * 11 + tail
    for fn in (dq, dkv):
        fn.restype = ctypes.c_int
    return dq, dkv


def _check(q, k, v, seg, dout=None):
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
    if h > 65535 or b > 65535:
        raise ValueError(f"kernel takes at most 65535 heads and batch rows, "
                         f"got {h} and {b}")
    named = [("q", q, torch.bfloat16), ("k", k, torch.bfloat16),
             ("v", v, torch.bfloat16), ("seg", seg, torch.int32)]
    if dout is not None:
        if dout.shape != q.shape:
            raise ValueError(f"dout {tuple(dout.shape)} differs from q "
                             f"{tuple(q.shape)}")
        named.append(("dout", dout, torch.bfloat16))
    for name, t, dt in named:
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype != dt:
            raise TypeError(f"{name} must be {dt}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if dt == torch.bfloat16 and t.data_ptr() % 16:   # 16-byte row reads
            raise ValueError(f"{name} must start on a 16-byte boundary")


def _tile_ranges_plain(seg, rows=BLOCK_ROWS):
    """The kernels' per-tile ranges in plain PyTorch:
    :func:`_segment_block_ranges` at tiles of ``rows`` (``BLOCK_ROWS`` for
    the backward, ``FWD_BLOCK_ROWS`` for the forward) over the stream
    padded to whole tiles.  The pad is a run of its own (an id differing
    from the last row's), and the kernels mask every row and key past the
    real length.  -> (kmin, kmax) [b, ceil(s / rows)] int32, contiguous."""
    b, s = seg.shape
    pad = -s % rows
    if pad:
        seg = torch.cat([seg, (seg[:, -1:] + 1).expand(b, pad)], dim=1)
    kmin, kmax = _segment_block_ranges(seg, rows)
    return kmin.contiguous(), kmax.contiguous()


@functools.lru_cache(maxsize=None)
def _ranges_fn():
    fn = _build.library("flash_varlen").flash_segmented_tile_ranges
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _tile_ranges(seg, rows=BLOCK_ROWS):
    """:func:`_tile_ranges_plain`'s (kmin, kmax); on a CUDA tensor one
    launch of the forward library's range kernel computes them."""
    if seg.device.type != "cuda":
        return _tile_ranges_plain(seg, rows)
    if seg.dtype != torch.int32 or not seg.is_contiguous():
        raise ValueError("segment ids must be contiguous int32")
    global launches_ranges
    b, s = seg.shape
    nt = -(-s // rows)
    kmin = torch.empty((b, nt), dtype=torch.int32, device=seg.device)
    kmax = torch.empty_like(kmin)
    err = _ranges_fn()(seg.data_ptr(), kmin.data_ptr(), kmax.data_ptr(), b,
                       s, rows, torch.cuda.current_stream(
                           seg.device).cuda_stream)
    if err:
        raise RuntimeError(f"segment tile-range kernel launch failed: "
                           f"cudaError {err}")
    launches_ranges += 1
    return kmin, kmax


def _seg_fwd(q, k, v, seg, causal):
    """K2 on CUDA tensors -> (out [b, s, h, d], lse [b, h, s] fp32)."""
    _check(q, k, v, seg)
    global launches
    b, s, h, d = q.shape
    kmin, kmax = _tile_ranges(seg, FWD_BLOCK_ROWS)
    out = torch.empty_like(q)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    err = _fwd_fn()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), seg.data_ptr(),
        kmin.data_ptr(), kmax.data_ptr(), out.data_ptr(), lse.data_ptr(),
        b, s, h, k.shape[2], d, int(bool(causal)), 1.0 / math.sqrt(d),
        torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"flash_attention_segmented kernel launch "
                           f"failed: cudaError {err}")
    launches += 1
    return out, lse


def _check_stats(q, lse, delta):
    want = (q.shape[0], q.shape[2], q.shape[1])
    for name, t in (("lse", lse), ("delta", delta)):
        if (t.shape != want or t.dtype != torch.float32
                or t.device != q.device or not t.is_contiguous()):
            raise ValueError(f"{name} must be contiguous f32 {list(want)} "
                             f"on {q.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")


def _bwd_tail(q, k, causal):
    b, s, h, d = q.shape
    return (b, s, h, k.shape[2], d, int(bool(causal)), 1.0 / math.sqrt(d),
            torch.cuda.current_stream(q.device).cuda_stream)


def _seg_bwd_dq_kernel(q, k, v, seg, dout, lse, delta, ranges, causal):
    """K7a on CUDA tensors -> dq.  ``ranges``: :func:`_tile_ranges` of
    ``seg``, the k range of each q tile."""
    _check(q, k, v, seg, dout)
    _check_stats(q, lse, delta)
    global launches_bwd_dq
    kmin, kmax = ranges
    dq = torch.empty_like(q)
    err = _bwd_fns()[0](
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
        seg.data_ptr(), kmin.data_ptr(), kmax.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dq.data_ptr(), *_bwd_tail(q, k, causal))
    if err:
        raise RuntimeError(f"flash_attention_segmented dq kernel launch "
                           f"failed: cudaError {err}")
    launches_bwd_dq += 1
    return dq


def _seg_bwd_dkv_kernel(q, k, v, seg, dout, lse, delta, ranges, causal):
    """K7b on CUDA tensors -> (dk, dv) at k's kv heads.  ``ranges``:
    :func:`_tile_ranges` of ``seg``, the q range of each k tile (the same
    function as the dq pass's k ranges: both tiles are 64 rows)."""
    _check(q, k, v, seg, dout)
    _check_stats(q, lse, delta)
    global launches_bwd_dkv
    qmin, qmax = ranges
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    err = _bwd_fns()[1](
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
        seg.data_ptr(), qmin.data_ptr(), qmax.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        *_bwd_tail(q, k, causal))
    if err:
        raise RuntimeError(f"flash_attention_segmented dk/dv kernel launch "
                           f"failed: cudaError {err}")
    launches_bwd_dkv += 1
    return dk, dv


def _seg_bwd(q, k, v, seg, out, lse, dout, causal):
    """The backward on CUDA tensors (``_seg_bwd_vjp``): delta, the per-tile
    ranges, K7a and K7b -> (dq, dk, dv).  The dk / dv kernel sums a GQA
    group's q heads in f32 and rounds to k's and v's type once."""
    delta = _delta(dout, out)
    ranges = _tile_ranges(seg)
    dq = _seg_bwd_dq_kernel(q, k, v, seg, dout, lse, delta, ranges, causal)
    dk, dv = _seg_bwd_dkv_kernel(q, k, v, seg, dout, lse, delta, ranges,
                                 causal)
    return dq, dk, dv


class _FlashSeg(torch.autograd.Function):
    """K2 forward, K7a / K7b backward (``_flash_seg``'s custom_vjp)."""

    @staticmethod
    def forward(ctx, q, k, v, seg, causal):
        out, lse = _seg_fwd(q, k, v, seg, causal)
        ctx.save_for_backward(q, k, v, seg, out, lse)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, seg, out, lse = ctx.saved_tensors
        dq, dk, dv = _seg_bwd(q, k, v, seg, out, lse, dout.contiguous(),
                              ctx.causal)
        return dq, dk, dv, None, None


def flash_attention_segmented(q, k, v, segment_ids, causal=False):
    """Ragged/varlen attention: q [b, s, h, d] PACKED along s, k/v
    [b, s, nkv, d] with nkv dividing h (GQA-native), segment_ids [b, s]
    (or [s]) int32 contiguous runs; attention stays within a segment.
    Differentiable in q, k and v; dk and dv come back at nkv heads."""
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
    return _FlashSeg.apply(q, k, v, seg.to(torch.int32).contiguous(), causal)
