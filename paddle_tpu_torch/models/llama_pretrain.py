"""LLaMA configuration, parameter init, block math and the single-device
pretraining step.

Counterpart of ``paddle_tpu/models/llama_pretrain.py``.  For serving:
:class:`LlamaPretrainConfig`, :func:`init_params` (same shapes and scale, a
seeded ``torch.Generator`` on the device, no mesh), :func:`_rms_norm`,
:func:`_mm` (plain weights, and weight-only int8 ``{"q", "s"}`` dicts
through the int8 matmul kernel) and :func:`_block_post_attn`.  For
training, on one device: :func:`_rope` (the fused RoPE kernel),
:func:`_attention` (the flash attention kernels, or the composite), the
block forward under the ``full`` / ``flash`` rematerialisation policies,
:func:`make_forward` (``forward_loss`` with the plain or the chunked loss
head, and packed pretraining: ``segment_ids`` keep attention within each
document through the segmented flash attention kernels and mask the
boundary and padding targets of the loss), :func:`adamw_update` (the fused
AdamW kernel for f32 moments), :func:`adafactor_update` and
:func:`make_train_step`.  Not ported yet (each raises
``NotImplementedError`` where asked for): the mesh and its parallel forms,
context parallelism and JAX's ``dots`` / ``names`` / ``cheap`` checkpoint
policies.

The port's flags (``paddle_tpu_torch/flags.py``, all off by default as in
JAX) route the trunk through three more kernels, read at call time so that
a checkpoint's recompute takes the forward's branch:

* ``FLAGS_pallas_rms_norm``: :func:`_rms_norm` through the rms_norm kernel
  (``x`` rounded once, not twice) when the hidden size is a multiple of 128
  and the weight is not an int8 dict.
* ``FLAGS_pallas_rmsnorm_matmul``: :func:`_block_pre_attn` computes q, k and
  v as three rmsnorm_matmul calls on the uncast ln1, and
  :func:`_block_post_attn` gate and up as two on ln2 (then ``silu(gate) *
  up`` in plain ops, as JAX does), for weights that are not int8 dicts.
* ``FLAGS_pallas_swiglu``: otherwise, the FFN's ``silu(gate) * up`` through
  the swiglu kernel.

The serving lanes (``models/paged_decode.py``: the decode step's
``_decode_layer`` and the packed prefill) call :func:`_rms_norm` and
:func:`_block_post_attn`, so they take these kernels where JAX's lanes take
its own: the rms_norm kernel on ln1, ln2 and the final norm, and the FFN
branch of the other two flags; their q / k / v stay plain products, as in
JAX.

Params are a plain dict in the JAX tree's layout: ``embed [V, h]``,
``blocks`` (each entry stacked ``[L, ...]``), ``final_norm [h]``,
``lm_head [h, V]``.  The JAX code casts f32 params to ``cfg.dtype`` at
every matmul; serving stores them in ``cfg.dtype`` (the default of
:func:`init_params`), which gives the same numbers, and the trainer stores
f32 masters (``init_params(..., dtype=cfg.param_dtype)``).
"""

from __future__ import annotations

import dataclasses
import math
import warnings
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from torch.utils.checkpoint import checkpoint

from .._device import resolve_device
from ..flags import flags
from ..ops.chunked_loss import chunked_softmax_cross_entropy
from ..ops.flash_attention import flash_attention
from ..ops.flash_varlen import flash_attention_segmented, segmented_sdpa_plain
from ..ops.fused_adamw import fused_adamw
from ..ops.int8_matmul import int8_matmul
from ..ops.rms_norm import rms_norm
from ..ops.rmsnorm_matmul import rmsnorm_matmul
from ..ops.rope import cached_tables, fused_rope
from ..ops.swiglu import swiglu

__all__ = ["LlamaPretrainConfig", "init_params", "layer_params",
           "make_forward", "make_train_step", "init_adamw_state",
           "adamw_update", "init_adafactor_state", "adafactor_update"]


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
    param_dtype: Any = torch.float32
    remat: bool = True
    # remat_policy: 'full' recomputes the whole block in the backward;
    # 'flash' keeps the flash-attention residuals and recomputes only the
    # projections and the FFN.  'dots' / 'names' / 'cheap' are JAX
    # checkpoint policies the port does not have yet.
    remat_policy: str = "full"
    # kept for the signature: sequence parallelism needs the mesh
    sequence_parallel: bool = True
    use_pallas_attention: bool = True
    # None, 'ring' or 'ulysses'; anything but None needs the mesh
    context_parallel: Optional[str] = None
    # loss head: > 1 = chunked softmax cross-entropy (never materialises
    # f32 [B, S, V] logits); 0 / 1 = plain log_softmax head.  The flattened
    # token count batch * (seq - 1) must be divisible by the chunk count.
    loss_chunks: int = 0

    def __post_init__(self):
        if self.num_key_value_heads is None:
            self.num_key_value_heads = self.num_attention_heads
        if self.remat_policy not in ("full", "flash", "dots", "names",
                                     "cheap"):
            raise ValueError(
                f"remat_policy must be one of full/flash/dots/names/"
                f"cheap, got {self.remat_policy!r}")
        if self.context_parallel not in (None, "ring", "ulysses"):
            raise ValueError(
                f"context_parallel must be None, 'ring' or 'ulysses', "
                f"got {self.context_parallel!r}")

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
                device=None, dtype=None) -> Dict[str, Any]:
    """Random params with the JAX ``init_params`` shapes and scale:
    norms are ones, every matrix is N(0, 1) / sqrt(hidden).  Drawn on
    ``device`` (CUDA unless asked otherwise) from a ``torch.Generator``
    seeded with ``seed``, drawn and stored in ``dtype``: ``cfg.dtype``
    unless given (what serving stores); the trainer passes
    ``cfg.param_dtype`` for f32 masters, as JAX's ``init_params`` stores.
    The values differ from JAX's for the same seed; tests that compare the
    two frameworks share weights through ``models.weights``."""
    dev = resolve_device(device)
    dt = cfg.dtype if dtype is None else dtype
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
    """RMSNorm in ``x``'s type: the rms_norm kernel under
    ``FLAGS_pallas_rms_norm`` (JAX's conditions), else the composite, which
    rounds ``x * rstd`` to x's type before the weight multiplies it."""
    if flags.FLAGS_pallas_rms_norm and x.shape[-1] % 128 == 0 and \
            not isinstance(w, dict):
        return rms_norm(x, w.to(x.dtype), eps)
    var = torch.mean(torch.square(x.float()), -1, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    return (x.float() * rstd).to(x.dtype) * w.to(x.dtype)


def _mm(x, w, dt):
    """Matmul against a plain weight, or against a weight-only int8 dict
    ``{"q": int8 [K, N], "s": f32 [N]}`` from ``quantize_params_int8``.
    The dict goes to :func:`int8_matmul` for any K and N (the JAX code
    takes its Pallas kernel only for lane-aligned dims and an XLA
    dequant-then-matmul otherwise; the port's kernel masks ragged edges,
    so it has one branch).  The kernel takes bf16 activations and writes
    bf16: an f32 compute type on a CUDA tensor (the Layer model's
    ``generate_compiled``, which pins f32 as JAX does) rounds x to bf16
    at the kernel and widens its output back, decided here before the
    launch (ROADMAP.md queue 3); on the CPU the plain version keeps f32."""
    if isinstance(w, dict):
        K = w["q"].shape[0]
        x2 = x.reshape(-1, K).to(dt).contiguous()
        if x2.device.type == "cuda" and dt != torch.bfloat16:
            out = int8_matmul(x2.to(torch.bfloat16), w["q"], w["s"],
                              out_dtype=torch.bfloat16).to(dt)
        else:
            out = int8_matmul(x2, w["q"], w["s"], out_dtype=dt)
        return out.reshape(*x.shape[:-1], out.shape[-1])
    return x @ w.to(dt)


def _block_post_attn(bp: Dict[str, Any], x, attn,
                     cfg: LlamaPretrainConfig):
    """Output projection + residual + SwiGLU FFN.  Under
    ``FLAGS_pallas_rmsnorm_matmul`` ln2 fuses into the gate and up products
    (weights that are not int8 dicts); otherwise ``FLAGS_pallas_swiglu``
    sends ``silu(gate) * up`` to the swiglu kernel."""
    b, s, h = x.shape
    dt = cfg.dtype
    eps = cfg.rms_norm_eps
    attn = attn.reshape(b, s, h)
    x = x + _mm(attn, bp["wo"], dt)
    res = x
    if flags.FLAGS_pallas_rmsnorm_matmul and \
            not isinstance(bp["w_gate"], dict):
        gate = F.silu(rmsnorm_matmul(x, bp["ln2"], bp["w_gate"].to(dt), eps))
        up = rmsnorm_matmul(x, bp["ln2"], bp["w_up"].to(dt), eps)
        return res + _mm(gate * up, bp["w_down"], dt)
    y = _rms_norm(x, bp["ln2"], eps)
    if flags.FLAGS_pallas_swiglu:
        act = swiglu(_mm(y, bp["w_gate"], dt), _mm(y, bp["w_up"], dt))
        return res + _mm(act, bp["w_down"], dt)
    gate = F.silu(_mm(y, bp["w_gate"], dt))
    up = _mm(y, bp["w_up"], dt)
    return res + _mm(gate * up, bp["w_down"], dt)


# ---------------------------------------------------------------------------
# training forward (single device)
# ---------------------------------------------------------------------------
def _rope(q, k, theta):
    """Rotate q and k [b, s, n, d] by position.  The fused RoPE kernel when
    ``d % 128 == 0`` (JAX's condition), else the inline rotate-half.  The
    tables come from ``cached_tables``: built once for every layer."""
    d = q.shape[-1]
    s = q.shape[1]
    cos_t, sin_t = cached_tables(s, d, theta, device=q.device)  # [s, d/2]
    if d % 128 == 0:
        return (fused_rope(q.contiguous(), cos_t, sin_t),
                fused_rope(k.contiguous(), cos_t, sin_t))
    cos = cos_t[None, :, None, :]
    sin = sin_t[None, :, None, :]

    def rot(x):
        x1, x2 = torch.chunk(x, 2, dim=-1)
        xc = x1.float() * cos - x2.float() * sin
        xs = x2.float() * cos + x1.float() * sin
        return torch.cat([xc, xs], -1).to(x.dtype)

    return rot(q), rot(k)


def _attention(q, k, v, cfg: LlamaPretrainConfig, seg=None):
    """Causal attention [b, s, n, d]: the flash attention kernels, or the
    composite when ``cfg.use_pallas_attention`` is off.  Both take full
    heads, so K and V are repeated up to the q heads first, as JAX does on
    these branches.  ``seg`` [b, s] int32 (packed pretraining): attention
    within each segment through the segmented kernels, or their plain
    version when ``cfg.use_pallas_attention`` is off; both take K and V at
    their kv heads (GQA-native, nothing repeated)."""
    if seg is not None:
        if cfg.use_pallas_attention:
            return flash_attention_segmented(
                q.contiguous(), k.contiguous(), v.contiguous(), seg,
                causal=True)
        return segmented_sdpa_plain(q, k, v, seg, True)
    if k.shape[2] != q.shape[2]:
        rep = q.shape[2] // k.shape[2]
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    if cfg.use_pallas_attention:
        return flash_attention(q.contiguous(), k.contiguous(),
                               v.contiguous(), causal=True)
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("bqnd,bknd->bnqk", q, k) * scale
    s = logits.shape[-1]
    mask = torch.tril(torch.ones((s, s), dtype=torch.bool, device=q.device))
    logits = logits.masked_fill(~mask, -1e30)
    probs = torch.softmax(logits.float(), -1).to(v.dtype)
    return torch.einsum("bnqk,bknd->bqnd", probs, v)


def _block_pre_attn(bp: Dict[str, Any], x, cfg: LlamaPretrainConfig):
    """ln1 + QKV projections + rope -> q, k, v (K and V un-repeated).
    Under ``FLAGS_pallas_rmsnorm_matmul`` (a ``wq`` that is not an int8
    dict) ln1 fuses into each of the three products."""
    b, s, _ = x.shape
    n, d = cfg.num_attention_heads, cfg.head_dim
    nkv = cfg.num_key_value_heads
    dt = cfg.dtype
    eps = cfg.rms_norm_eps
    if flags.FLAGS_pallas_rmsnorm_matmul and not isinstance(bp["wq"], dict):
        q = rmsnorm_matmul(x, bp["ln1"], bp["wq"].to(dt), eps)
        k = rmsnorm_matmul(x, bp["ln1"], bp["wk"].to(dt), eps)
        v = rmsnorm_matmul(x, bp["ln1"], bp["wv"].to(dt), eps)
    else:
        y = _rms_norm(x, bp["ln1"], eps)
        q = _mm(y, bp["wq"], dt)
        k = _mm(y, bp["wk"], dt)
        v = _mm(y, bp["wv"], dt)
    q = q.reshape(b, s, n, d)
    k = k.reshape(b, s, nkv, d)
    v = v.reshape(b, s, nkv, d)
    q, k = _rope(q, k, cfg.rope_theta)
    return q, k, v


def _block_forward(bp: Dict[str, Any], x, cfg: LlamaPretrainConfig,
                   seg=None):
    """One transformer block; x [b, s, h] in the compute type, ``seg`` the
    packed rows' segment ids or None."""
    q, k, v = _block_pre_attn(bp, x, cfg)
    attn = _attention(q, k, v, cfg, seg)
    return _block_post_attn(bp, x, attn, cfg)


# the blocks draw no random numbers, so no generator state is kept
_CKPT = dict(use_reentrant=False, preserve_rng_state=False)


def _block_forward_flash_saved(bp: Dict[str, Any], x,
                               cfg: LlamaPretrainConfig, seg=None):
    """Block forward where only the projections and the FFN are
    rematerialised: the attention call sits outside the two checkpoint
    regions, so its saved q / k / v / out / lse stay for the backward
    instead of the forward kernel running again."""
    q, k, v = checkpoint(_block_pre_attn, bp, x, cfg, **_CKPT)
    attn = _attention(q, k, v, cfg, seg)
    return checkpoint(_block_post_attn, bp, x, attn, cfg, **_CKPT)


def _remat_wrap(fwd, cfg: LlamaPretrainConfig):
    """Apply the configured rematerialisation policy to a block forward."""
    if not cfg.remat:
        return fwd
    if cfg.remat_policy == "flash":
        return _block_forward_flash_saved
    if cfg.remat_policy != "full":
        raise NotImplementedError(
            f"remat_policy {cfg.remat_policy!r} is a JAX checkpoint policy "
            f"the port does not have yet; use 'full' or 'flash'")

    def full(bp, x, cfg, seg=None):
        return checkpoint(fwd, bp, x, cfg, seg, **_CKPT)

    return full


def _trunk_scan(blocks, x, cfg: LlamaPretrainConfig, seg=None):
    """The layer loop over the stacked block params, with remat.  Each
    stacked leaf is unbound once, so its gradient is one stack of the
    layers' gradients."""
    fwd = _remat_wrap(_block_forward, cfg)
    per_layer = {name: w.unbind(0) for name, w in blocks.items()}
    for layer in range(cfg.num_hidden_layers):
        x = fwd({name: ws[layer] for name, ws in per_layer.items()}, x, cfg,
                seg)
    return x


def make_forward(cfg: LlamaPretrainConfig):
    """Returns ``forward_loss(params, tokens [B, S], segment_ids=None) ->
    loss``: next-token mean NLL of ``tokens[:, 1:]`` given
    ``tokens[:, :-1]``.

    ``segment_ids`` [B, S] (packed pretraining: documents concatenated
    along each row, contiguous runs of equal ids, padding -1): attention
    stays within a document, and the mean runs over the targets of the same
    document as their input that are not padding, so the last token of a
    document is not trained to predict the next one's first.  With
    ``loss_chunks > 1`` it warns and uses the plain head, as JAX does (no
    masked chunked head exists)."""
    if cfg.context_parallel is not None:
        raise NotImplementedError(
            "context parallelism needs the mesh, which is not ported yet")
    _remat_wrap(_block_forward, cfg)         # an unported policy raises here

    def forward_loss(params, tokens, segment_ids=None):
        dt = cfg.dtype
        inputs = tokens[:, :-1]
        targets = tokens[:, 1:]
        seg_in = valid = None
        if segment_ids is not None:
            seg_in, valid = _packed_targets(
                torch.as_tensor(segment_ids, device=tokens.device))
        x = F.embedding(inputs, params["embed"]).to(dt)
        x = _trunk_scan(params["blocks"], x, cfg, seg_in)
        x = _rms_norm(x, params["final_norm"], cfg.rms_norm_eps)
        if cfg.loss_chunks > 1 and seg_in is not None:
            warnings.warn(
                "packed segment pretraining uses the unchunked loss head "
                "(masked chunked CE not implemented); at large vocab this "
                "materialises full [B,S,V] logits", stacklevel=2)
        if cfg.loss_chunks > 1 and seg_in is None:
            return chunked_softmax_cross_entropy(
                x, params["lm_head"], targets, cfg.loss_chunks, dt)
        return _plain_loss(x, params["lm_head"], targets, dt, valid)

    return forward_loss


def _packed_targets(segment_ids):
    """Packed rows' segment ids [B, S] -> (the trunk's ids
    ``segment_ids[:, :-1]`` as contiguous int32, the float mask [B, S-1]
    of the targets that train: in the same document as their input, and
    not padding (a negative id))."""
    seg = segment_ids.to(torch.int32)
    seg_in, seg_tg = seg[:, :-1].contiguous(), seg[:, 1:]
    return seg_in, ((seg_in == seg_tg) & (seg_tg >= 0)).float()


def _plain_loss(x, lm_head, targets, dt, valid=None):
    """The unchunked loss head: the mean NLL of ``targets`` under the f32
    log-softmax of ``x @ lm_head``, over the targets where the float mask
    ``valid`` is 1 when it is given (divided by at least 1)."""
    logits = _mm(x, lm_head, dt).float()
    ll = torch.log_softmax(logits, -1).gather(-1, targets[..., None])[..., 0]
    if valid is None:
        return -ll.mean()
    return -(ll * valid).sum() / torch.clamp(valid.sum(), min=1.0)


# ---------------------------------------------------------------------------
# optimizers.  State: {"t": int, "moments": the params' tree of slots}.
# JAX returns new trees and donates the old; the port updates params and
# moments in place and returns them.
# ---------------------------------------------------------------------------
def _leaves(tree):
    """The leaves (tensors, or slot dicts) of a params-shaped tree, the
    blocks by name: a tree that came through JAX has its keys sorted."""
    blocks = tree["blocks"]
    return [tree["embed"], *(blocks[k] for k in sorted(blocks)),
            tree["final_norm"], tree["lm_head"]]


def _map_params(fn, params):
    """``fn`` over every param leaf in :func:`_leaves`' order, into the
    params' nesting."""
    blocks = params["blocks"]
    return {"embed": fn(params["embed"]),
            "blocks": {k: fn(blocks[k]) for k in sorted(blocks)},
            "final_norm": fn(params["final_norm"]),
            "lm_head": fn(params["lm_head"])}


def init_adamw_state(params, moment_dtype: Any = None, device=None):
    """AdamW state on ``device`` (CUDA unless asked otherwise).
    ``moment_dtype`` (e.g. ``torch.bfloat16``) stores the moments in fewer
    bits; the update still computes in f32."""
    dev = resolve_device(device)

    def make(p):
        dt = moment_dtype or p.dtype
        return {"m": torch.zeros(p.shape, dtype=dt, device=dev),
                "v": torch.zeros(p.shape, dtype=dt, device=dev)}

    return {"t": 0, "moments": _map_params(make, params)}


@torch.no_grad()
def adamw_update(params, grads, state, lr=3e-4, b1=0.9, b2=0.95,
                 eps=1e-8, weight_decay=0.1):
    """One AdamW step over every leaf: the fused AdamW kernel for f32
    moments, plain f32 math for moments stored in another type."""
    t = state["t"] + 1

    def upd(p, g, mo):
        g = g.float()
        mdt = mo["m"].dtype
        if mdt == torch.float32:
            fused_adamw(p, g.contiguous(), mo["m"], mo["v"], t, lr, b1, b2,
                        eps, weight_decay)
            return
        tf = torch.tensor(float(t), dtype=torch.float32, device=p.device)
        m = b1 * mo["m"].float() + (1 - b1) * g
        v = b2 * mo["v"].float() + (1 - b2) * g * g
        mhat = m / (1 - b1 ** tf)
        vhat = v / (1 - b2 ** tf)
        new_p = p * (1 - lr * weight_decay) - lr * mhat / (
            torch.sqrt(vhat) + eps)
        p.copy_(new_p)
        mo["m"].copy_(m)
        mo["v"].copy_(v)

    for p, g, mo in zip(_leaves(params), _leaves(grads),
                        _leaves(state["moments"])):
        upd(p, g, mo)
    return params, {"t": t, "moments": state["moments"]}


def _factored(p) -> bool:
    return p.dim() >= 2 and p.shape[-1] >= 128 and p.shape[-2] >= 128


def init_adafactor_state(params, beta1: float = 0.0,
                         moment_dtype: Any = torch.bfloat16, device=None):
    """Adafactor state on ``device`` (CUDA unless asked otherwise):
    factored second moment for matrices, a full vector for small params;
    an optional first moment (``beta1 > 0``) stored in ``moment_dtype``."""
    dev = resolve_device(device)

    def make(p):
        st = {}
        if _factored(p):
            st["vr"] = torch.zeros(p.shape[:-1], dtype=torch.float32,
                                   device=dev)
            st["vc"] = torch.zeros(p.shape[:-2] + p.shape[-1:],
                                   dtype=torch.float32, device=dev)
        else:
            st["v"] = torch.zeros(p.shape, dtype=torch.float32, device=dev)
        if beta1 > 0.0:
            st["m"] = torch.zeros(p.shape, dtype=moment_dtype, device=dev)
        return st

    return {"t": 0, "moments": _map_params(make, params)}


def _rms(x):
    return torch.sqrt(torch.mean(torch.square(x)) + 1e-30)


@torch.no_grad()
def adafactor_update(params, grads, state, lr=1e-2, weight_decay=0.0,
                     beta1: float = 0.0, clip_threshold=1.0, eps1=1e-30,
                     eps2=1e-3, decay_pow=0.8):
    """One Adafactor step.  ``lr`` is the relative step size: the update
    is ``lr * max(eps2, rms(p)) * u_clipped``, with
    ``beta2_t = 1 - t**-decay_pow``.  ``beta1`` must match the
    ``init_adafactor_state`` value."""
    t = state["t"] + 1

    def upd(p, g, st):
        if ("m" in st) != (beta1 > 0.0):
            raise ValueError(
                f"beta1={beta1} disagrees with the optimizer state "
                f"({'has' if 'm' in st else 'no'} momentum slot): pass "
                f"the same beta1 to init_adafactor_state and "
                f"adafactor_update/make_train_step")
        tf = torch.tensor(float(t), dtype=torch.float32, device=p.device)
        beta2 = 1.0 - tf ** (-decay_pow)
        g = g.float()
        g2 = g * g + eps1
        if "vr" in st:
            vr = beta2 * st["vr"] + (1 - beta2) * g2.mean(-1)
            vc = beta2 * st["vc"] + (1 - beta2) * g2.mean(-2)
            st["vr"].copy_(vr)
            st["vc"].copy_(vc)
            # vhat = outer(vr, vc) / mean(vr): the rank-1 reconstruction
            r = vr / vr.mean(-1, keepdim=True)
            u = g * torch.rsqrt(r[..., :, None] * vc[..., None, :])
        else:
            v = beta2 * st["v"] + (1 - beta2) * g2
            st["v"].copy_(v)
            u = g * torch.rsqrt(v)
        u = u / torch.clamp(_rms(u) / clip_threshold, min=1.0)
        alpha = lr * torch.clamp(_rms(p.float()), min=eps2)
        step_ = alpha * u
        if "m" in st:
            m = beta1 * st["m"].float() + (1 - beta1) * step_
            st["m"].copy_(m)
            step_ = m
        p.copy_(p.float() * (1 - alpha * weight_decay) - step_)

    for p, g, st in zip(_leaves(params), _leaves(grads),
                        _leaves(state["moments"])):
        upd(p, g, st)
    return params, {"t": t, "moments": state["moments"]}


def make_train_step(cfg: LlamaPretrainConfig, lr: float = 3e-4,
                    weight_decay: float = 0.1, accum_steps: int = 1,
                    optimizer: str = "adamw", beta1: float = 0.0,
                    device=None):
    """Returns ``step(params, opt_state, tokens) -> (params, opt_state,
    loss)``: forward, backward and optimizer on ``device`` (CUDA unless
    asked otherwise).  ``params`` and the state's moments are updated in
    place and returned; ``loss`` is a 0-d f32 tensor on the device.

    ``optimizer``: "adamw" (state from :func:`init_adamw_state`) or
    "adafactor" (:func:`init_adafactor_state`; ``lr`` becomes the relative
    step size and ``beta1`` the optional momentum).  ``accum_steps > 1``
    splits the batch into that many microbatches and averages their
    gradients in f32 before one optimizer step."""
    dev = resolve_device(device)
    fwd = make_forward(cfg)
    if optimizer not in ("adamw", "adafactor"):
        raise ValueError(f"optimizer must be adamw/adafactor, "
                         f"got {optimizer!r}")

    def value_and_grad(params, tokens):
        live = _map_params(lambda p: p.detach().requires_grad_(True), params)
        with torch.enable_grad():
            loss = fwd(live, tokens)
        grads = torch.autograd.grad(loss, _leaves(live))
        return loss.detach(), grads

    def step(params, opt_state, tokens):
        tokens = tokens.to(dev)
        if accum_steps == 1:
            loss, grads = value_and_grad(params, tokens)
        else:
            tb = tokens.reshape(accum_steps, -1, tokens.shape[-1])
            acc = [torch.zeros(p.shape, dtype=torch.float32, device=dev)
                   for p in _leaves(params)]
            losses = []
            for tok in tb:
                mb_loss, g = value_and_grad(params, tok)
                for a, b in zip(acc, g):
                    a += b.to(a.dtype)
                losses.append(mb_loss)
            grads = [a / accum_steps for a in acc]
            loss = torch.stack(losses).mean()
        it = iter(grads)
        grads = _map_params(lambda _: next(it), params)
        if optimizer == "adafactor":
            params, opt_state = adafactor_update(
                params, grads, opt_state, lr=lr, weight_decay=weight_decay,
                beta1=beta1)
        else:
            params, opt_state = adamw_update(
                params, grads, opt_state, lr=lr, weight_decay=weight_decay)
        return params, opt_state, loss

    return step
