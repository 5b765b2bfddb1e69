"""Weight-only int8 matmul: the CUDA kernel's wrapper, its plain version and
the quantizer.

Counterpart of ``paddle_tpu/ops/pallas/int8_matmul.py``:
:func:`quantize_int8` is a copy of the JAX quantizer (per output channel,
absmax / 127, a zero column gets scale 1, round half to even, clip to
±127); :func:`int8_matmul` replaces the Pallas ``int8_matmul`` with the
hand-written Hopper kernel in ``csrc/int8_matmul.cu``; and
:func:`int8_matmul_plain` follows the Pallas kernel's numerics: f32
accumulation, the per-column scale applied to the f32 accumulator, one
rounding to the output type.

A tensor on the CPU goes to the plain version; a CUDA tensor goes to the
kernel, or the wrapper raises.  There is no quiet fallback from one to the
other.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

__all__ = ["int8_matmul", "int8_matmul_plain", "quantize_int8", "launches",
           "launches_wave", "WAVE_MIN_M", "decode_splits", "decode_tiles"]

# kernel launches made by int8_matmul, by the decode path and by the wave
# path (a run can show that its main path went through each kernel)
launches = 0
launches_wave = 0

# The kernel's two paths: up to WAVE_MIN_M rows the decode path (the
# transposed product on 128-column tiles, a TMA ring of int8 weight boxes
# feeding mma.sync, bytes-bound), above it the wave path (the same product
# on 128 x 256 tiles feeding wgmma).  The crossover, measured with
# tools/ab_torch_kernels.py's K3route at w_gate (K 4096, N 11008) on an H100
# SXM at 700 W before the decode path's redesign: decode / wave 0.040 /
# 0.046 ms at 16 rows, 0.072 / 0.047 at 32, 0.099 / 0.048 at 64, 0.175 /
# 0.054 at 128.
WAVE_MIN_M = 16

# The decode path's tiles: 128 output columns a block, K in 64-deep steps;
# at most 16 splits of K (the kernel's kMaxSplits)
DECODE_BN, DECODE_BK, MAX_SPLITS = 128, 64, 16


def decode_tiles(M, N) -> int:
    """The decode path's output tiles: 128 columns by a block of x's rows
    (8 at M <= 8, else 16; more than one block only where a caller forces
    the path above ``WAVE_MIN_M``)."""
    return -(-N // DECODE_BN) * (1 if M <= 8 else -(-M // 16))


def decode_splits(M, N, K, sms) -> int:
    """How many slices of K the decode path splits the product into: as
    many as keep the output tiles times the splits within two blocks an SM
    (one wave of resident blocks), at most ``MAX_SPLITS`` and one K step a
    slice, with no empty slice (split z takes the steps ``[z * per, (z + 1)
    * per)`` of ``ceil(K / DECODE_BK)``, ``per = ceil(steps / splits)``)."""
    tiles = decode_tiles(M, N)
    steps = -(-K // DECODE_BK)
    s = max(1, min(2 * sms // tiles, steps, MAX_SPLITS))
    per = -(-steps // s)
    return -(-steps // per)


def quantize_int8(w):
    """Per-output-channel symmetric int8 quantization of ``w [..., K, N]``
    -> ``{"q": int8 [..., K, N], "s": f32 [..., N]}``.  Leading dims are
    quantized independently, as ``jax.vmap(quantize_int8)`` does."""
    wf = w.float()
    s = wf.abs().amax(dim=-2) / 127.0
    s = torch.where(s == 0, torch.ones_like(s), s)
    q = torch.clamp(torch.round(wf / s[..., None, :]), -127, 127)
    return {"q": q.to(torch.int8), "s": s}


def int8_matmul_plain(x, q, s, out_dtype=None):
    """``x [M, K] @ (q [K, N] int8) * s [N]`` in f32, rounded once to
    ``out_dtype`` (``x``'s type by default)."""
    out = (x.float() @ q.float()) * s.float()
    return out.to(out_dtype or x.dtype)


@functools.lru_cache(maxsize=None)
def _kernel_fn():
    """The launcher, looked up and typed once per process."""
    fn = _build.library("int8_matmul").int8_matmul_bf16
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _splits(M, N, K, sms, wave) -> int:
    """How many slices of K the kernel's path (``wave`` or decode) splits
    the product into (1 when the output tiles alone fill the card)."""
    if not wave:
        return decode_splits(M, N, K, sms)
    fn = _build.library("int8_matmul").int8_matmul_splits
    fn.argtypes = [ctypes.c_int] * 4
    fn.restype = ctypes.c_int
    return int(fn(M, N, K, sms))


# The decode path's arrival counts, one uint32 per output tile, by
# (device, stream).  A launch that splits K leaves them at 0, so they are
# zeroed once, when made.  Each stream has its own: two launches in flight
# at once on one set of counts (two streams) would each count the other's
# blocks and close tiles whose partials are not all written.  Counts first
# needed while a stream is captured into a CUDA graph are made by a fill
# that the graph records (it runs at each replay, never at capture), so
# they belong to that capture alone: their key also holds the capture's id.
_arrivals = {}


@functools.lru_cache(maxsize=None)
def _capture_id_fn():
    fn = _build.library("int8_matmul").int8_matmul_capture_id
    fn.argtypes = [ctypes.c_void_p]
    fn.restype = ctypes.c_ulonglong
    return fn


def _arrival_counts(device, stream, tiles):
    key = (device.index, stream)
    if torch.cuda.is_current_stream_capturing():
        key += (int(_capture_id_fn()(stream)),)
        for old in [k for k in _arrivals if len(k) == 3 and k != key]:
            del _arrivals[old]         # an ended capture's: its graph keeps them
    counts = _arrivals.get(key)
    if counts is None or counts.numel() < tiles:
        counts = _arrivals[key] = torch.zeros(
            (max(tiles, 1024),), dtype=torch.int32, device=device)
    return counts


@functools.lru_cache(maxsize=None)
def _sm_count(index) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check(x, q, s, out_dtype):
    if x.dim() != 2 or q.dim() != 2 or s.dim() != 1:
        raise ValueError(f"want x [M, K], q [K, N] and s [N], got "
                         f"{tuple(x.shape)}, {tuple(q.shape)}, "
                         f"{tuple(s.shape)}")
    M, K = x.shape
    if q.shape[0] != K or s.shape[0] != q.shape[1]:
        raise ValueError(f"shapes do not chain: x {tuple(x.shape)}, q "
                         f"{tuple(q.shape)}, s {tuple(s.shape)}")
    if K % 16:
        raise ValueError(f"kernel takes K % 16 == 0, got K={K}")
    if out_dtype != torch.bfloat16:
        raise TypeError(f"kernel writes bf16, asked for {out_dtype}")
    for name, t, dt in (("x", x, torch.bfloat16), ("q", q, torch.int8),
                        ("s", s, torch.float32)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if t.dtype != dt:
            raise TypeError(f"{name} must be {dt}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary")


def int8_matmul(x, q, s, out_dtype=None):
    """``x [M, K] @ dequant(q [K, N] int8, s [N] f32) -> [M, N]``.

    On the card ``x`` is bf16, K a multiple of 16 and the output bf16; M
    and N may be anything.  The bf16 copy of the weight never exists in
    device memory: the kernel widens each int8 tile in registers."""
    out_dtype = out_dtype or x.dtype
    if x.device.type == "cpu":
        return int8_matmul_plain(x, q, s, out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"no int8 matmul for {x.device}")
    return _kernel(x, q, s, out_dtype)


def _kernel(x, q, s, out_dtype=torch.bfloat16):
    """The kernel on CUDA tensors: its wave path above ``WAVE_MIN_M`` rows,
    its decode path up to it."""
    _check(x, q, s, out_dtype)
    global launches, launches_wave
    M, K = x.shape
    N = q.shape[1]
    wave = M > WAVE_MIN_M
    out = torch.empty((M, N), dtype=torch.bfloat16, device=x.device)
    if M == 0 or N == 0:
        return out
    splits = _splits(M, N, K, _sm_count(x.device.index or 0), wave)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    # f32 partial sums of each K slice, added, scaled and rounded once by
    # the wave path's second pass or by the decode path's last block of
    # each column tile, counted in the stream's arrival counts
    ws = arrivals = None
    if splits > 1:
        ws = torch.empty((splits, M, N), dtype=torch.float32, device=x.device)
        if not wave:
            arrivals = _arrival_counts(x.device, stream,
                                       decode_tiles(M, N)).data_ptr()
    err = _kernel_fn()(
        x.data_ptr(), q.data_ptr(), s.data_ptr(), out.data_ptr(),
        None if ws is None else ws.data_ptr(), arrivals, M, N, K, splits,
        int(wave), stream)
    if err:
        raise RuntimeError(f"int8_matmul kernel launch failed: cudaError "
                           f"{err}")
    if wave:
        launches_wave += 1
    else:
        launches += 1
    return out
