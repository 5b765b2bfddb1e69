"""LLaMA configuration, parameter init and the block math of the serving path.

Counterpart of ``paddle_tpu/models/llama_pretrain.py``, for what the serving
main path runs: :class:`LlamaPretrainConfig`, :func:`init_params` (same
shapes and scale, a seeded ``torch.Generator`` on the device, no mesh),
:func:`_rms_norm` (composite branch), :func:`_mm` (plain weights, and
weight-only int8 ``{"q", "s"}`` dicts through the int8 matmul kernel) and
:func:`_block_post_attn` (composite FFN branch).  Training (the train step,
remat, the mesh) is not ported yet.

Params are a plain dict in the JAX tree's layout: ``embed [V, h]``,
``blocks`` (each entry stacked ``[L, ...]``), ``final_norm [h]``,
``lm_head [h, V]``.  The JAX code casts fp32 params to ``cfg.dtype`` at
every matmul; the port may store them in ``cfg.dtype`` (as
:func:`init_params` does), which gives the same numbers.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from .._device import resolve_device
from ..ops.int8_matmul import int8_matmul

__all__ = ["LlamaPretrainConfig", "init_params", "layer_params"]


@dataclasses.dataclass
class LlamaPretrainConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: Optional[int] = None
    max_seq_len: int = 2048
    rope_theta: float = 10000.0
    rms_norm_eps: float = 1e-6
    dtype: Any = torch.bfloat16

    def __post_init__(self):
        if self.num_key_value_heads is None:
            self.num_key_value_heads = self.num_attention_heads

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads


def _block_shapes(cfg: LlamaPretrainConfig) -> Dict[str, tuple]:
    h, f = cfg.hidden_size, cfg.intermediate_size
    kvh = cfg.num_key_value_heads * cfg.head_dim
    return {
        "ln1": (h,), "ln2": (h,),
        "wq": (h, h), "wk": (h, kvh), "wv": (h, kvh), "wo": (h, h),
        "w_gate": (h, f), "w_up": (h, f), "w_down": (f, h),
    }


def init_params(cfg: LlamaPretrainConfig, seed: int = 0,
                device=None) -> Dict[str, Any]:
    """Random params with the JAX ``init_params`` shapes and scale:
    norms are ones, every matrix is N(0, 1) / sqrt(hidden).  Drawn on
    ``device`` (CUDA unless asked otherwise) from a ``torch.Generator``
    seeded with ``seed``, stored in ``cfg.dtype``.  The values differ
    from JAX's for the same seed; tests that compare the two frameworks
    share weights through ``models.weights``."""
    dev = resolve_device(device)
    dt = cfg.dtype
    gen = torch.Generator(device=dev).manual_seed(seed)
    std = 1.0 / math.sqrt(cfg.hidden_size)
    L = cfg.num_hidden_layers

    def normal(shape):
        w = torch.randn(shape, generator=gen, device=dev, dtype=dt)
        return w.mul_(std)

    blocks = {}
    for name, shape in _block_shapes(cfg).items():
        if name.startswith("ln"):
            blocks[name] = torch.ones((L,) + shape, device=dev, dtype=dt)
        else:
            blocks[name] = normal((L,) + shape)
    return {
        "embed": normal((cfg.vocab_size, cfg.hidden_size)),
        "blocks": blocks,
        "final_norm": torch.ones((cfg.hidden_size,), device=dev, dtype=dt),
        "lm_head": normal((cfg.hidden_size, cfg.vocab_size)),
    }


def layer_params(params: Dict[str, Any], layer: int) -> Dict[str, Any]:
    """Layer ``layer``'s block params: views into the stacked tensors (of
    both tensors of an int8 ``{"q", "s"}`` dict)."""
    return {k: ({n: t[layer] for n, t in w.items()} if isinstance(w, dict)
                else w[layer])
            for k, w in params["blocks"].items()}


def _rms_norm(x, w, eps):
    var = torch.mean(torch.square(x.float()), -1, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    return (x.float() * rstd).to(x.dtype) * w.to(x.dtype)


def _mm(x, w, dt):
    """Matmul against a plain weight, or against a weight-only int8 dict
    ``{"q": int8 [K, N], "s": f32 [N]}`` from ``quantize_params_int8``.
    The dict goes to :func:`int8_matmul` for any K and N (the JAX code
    takes its Pallas kernel only for lane-aligned dims and an XLA
    dequant-then-matmul otherwise; the port's kernel masks ragged edges,
    so it has one branch)."""
    if isinstance(w, dict):
        K = w["q"].shape[0]
        x2 = x.reshape(-1, K).to(dt).contiguous()
        out = int8_matmul(x2, w["q"], w["s"], out_dtype=dt)
        return out.reshape(*x.shape[:-1], out.shape[-1])
    return x @ w.to(dt)


def _block_post_attn(bp: Dict[str, Any], x, attn,
                     cfg: LlamaPretrainConfig):
    """Output projection + residual + SwiGLU FFN."""
    b, s, h = x.shape
    dt = cfg.dtype
    attn = attn.reshape(b, s, h)
    x = x + _mm(attn, bp["wo"], dt)
    res = x
    y = _rms_norm(x, bp["ln2"], cfg.rms_norm_eps)
    gate = F.silu(_mm(y, bp["w_gate"], dt))
    up = _mm(y, bp["w_up"], dt)
    return res + _mm(gate * up, bp["w_down"], dt)
