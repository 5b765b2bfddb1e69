"""The Paddle API's kernel routes on a CUDA card.

* ``F.rms_norm`` (``nn.RMSNorm``) runs K9a forward and K9b backward on bf16
  ``[b, s, h]`` and matches autograd through the plain version;
* ``fused_rotary_position_embedding`` runs K5 on q and k (forward and the
  ``-sin`` backward) at head_dim 128 and matches the composite; with
  ``position_ids`` it stays composite (no launch);
* ``scaled_dot_product_attention`` runs K6a / K6b / K6c on bf16 full
  sequences and matches autograd through ``sdpa_plain``; its route rule
  sends f32, decode shapes and lengths no block of 8 divides to the plain
  attention and a mask to the composite, each without a launch;
* a narrow Layer LLaMA (2 layers, hidden 256, head_dim 128, bf16) launches
  K5 2 x L, K6a L and K9a 2 x L + 1 in a forward and K6b / K6c L, K9b 2 x L
  + 1 in its backward; ``generate_compiled(quantize_int8=True)`` launches
  K3.

Each backward runs from one fixed random cotangent on both sides.
Tolerances: 2e-2 abs + rel (one bf16 rounding, sums in another order), as
the kernels' own card tests.
Every test needs a card and skips without one; random inputs come from
explicit generators (no default CUDA generator).  The card machine has no
JAX, so run this file there without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_api_cuda.py -q
"""

import pytest

torch = pytest.importorskip("torch")

import paddle_tpu_torch as paddle  # noqa: E402
from paddle_tpu_torch.framework import place as tplace  # noqa: E402
from paddle_tpu_torch.incubate.nn import functional as IF  # noqa: E402
from paddle_tpu_torch.nn import functional as F  # noqa: E402
from paddle_tpu_torch.ops import flash_attention as fa  # noqa: E402
from paddle_tpu_torch.ops import int8_matmul as im  # noqa: E402
from paddle_tpu_torch.ops import rms_norm as rn  # noqa: E402
from paddle_tpu_torch.ops import rope as rp  # noqa: E402
from paddle_tpu_torch.ops.dispatch import (  # noqa: E402
    get_op_impl, register_op_impl)

pytestmark = pytest.mark.cuda

TOL = dict(atol=2e-2, rtol=2e-2)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    prev = tplace._current_place
    paddle.set_device("gpu")
    yield torch.Generator(device="cuda").manual_seed(0)
    tplace._current_place = prev


def _t(gen, shape, dtype=torch.bfloat16, grad=False):
    x = torch.randn(shape, generator=gen, device="cuda", dtype=dtype)
    return paddle.to_tensor(x, stop_gradient=not grad)


def _counts():
    return (rn.launches, rn.launches_bwd, rp.launches, fa.launches,
            fa.launches_dq, fa.launches_dkv, im.launches + im.launches_wave)


def _delta(before):
    return tuple(a - b for a, b in zip(_counts(), before))


def _backward(out, ct):
    """Backward from the fixed cotangent ``ct`` (f32, out's shape)."""
    (out.astype("float32") * paddle.to_tensor(ct)).sum().backward()


def _plain_grads(fn, ct, *ts):
    """``fn`` with the API's kernel entries swapped for their plain
    versions, backward from ``ct`` -> (out, grads of ts)."""
    plain = {"rms_norm": lambda x, w, eps: rn.rms_norm_plain(
                 x.reshape(-1, x.shape[-1]), w, eps)[0].reshape(x.shape),
             "flash_attention": lambda q, k, v, causal=False:
                 fa.sdpa_plain(q, k, v, causal),
             "fused_rope": lambda x, c, s: rp._composite(x, c, s, False)}
    saved = {k: get_op_impl(k, None) for k in plain}
    try:
        for k, f in plain.items():
            register_op_impl(k, f)
        ref = [paddle.to_tensor(t._data.clone(), stop_gradient=False)
               for t in ts]
        before = _counts()
        out = fn(*ref)
        _backward(out, ct)
        assert _delta(before) == (0,) * 7
        return out, [r.grad for r in ref]
    finally:
        for k, f in saved.items():
            register_op_impl(k, f)


def _close(a, b):
    torch.testing.assert_close(a._data.float(), b._data.float(), **TOL)


def test_rms_norm_runs_k9a_and_k9b(card):
    x, w = _t(card, (2, 64, 4096), grad=True), _t(card, (4096,), grad=True)

    def fn(x, w):
        return F.rms_norm(x, w, epsilon=1e-6)
    ct = torch.randn((2, 64, 4096), generator=card, device="cuda")
    before = _counts()
    out = fn(x, w)
    _backward(out, ct)
    assert _delta(before)[:2] == (1, 1)
    ref, (gx, gw) = _plain_grads(fn, ct, x, w)
    _close(out, ref)
    _close(x.grad, gx)
    # dw sums 128 rows of unit-scale products: bf16 rounding of the sum
    torch.testing.assert_close(w.grad._data.float(), gw._data.float(),
                               atol=0.5, rtol=2e-2)


@pytest.mark.parametrize("ids", [False, True])
def test_fused_rope_runs_k5_without_position_ids(card, ids):
    q, k = _t(card, (2, 256, 4, 128), grad=True), \
        _t(card, (2, 256, 2, 128), grad=True)

    def fn(q, k):
        oq, ok, _ = IF.fused_rotary_position_embedding(
            q, k, position_ids=torch.arange(3, 259) if ids else None)
        return paddle.concat([oq, ok], axis=2)
    ct = torch.randn((2, 256, 6, 128), generator=card, device="cuda")
    before = _counts()
    out = fn(q, k)
    _backward(out, ct)
    assert _delta(before)[2] == (0 if ids else 4)
    ref, (gq, gk) = _plain_grads(fn, ct, q, k)
    _close(out, ref)
    _close(q.grad, gq)
    _close(k.grad, gk)


@pytest.mark.parametrize("causal", [True, False])
def test_sdpa_runs_k6_on_bf16_full_sequences(card, causal):
    q, k, v = (_t(card, (2, 256, 4, 128), grad=True) for _ in range(3))

    def fn(q, k, v):
        return F.scaled_dot_product_attention(q, k, v, is_causal=causal)
    ct = torch.randn((2, 256, 4, 128), generator=card, device="cuda")
    before = _counts()
    out = fn(q, k, v)
    _backward(out, ct)
    assert _delta(before)[3:6] == (1, 1, 1)
    ref, grads = _plain_grads(fn, ct, q, k, v)
    _close(out, ref)
    for t, g in zip((q, k, v), grads):
        _close(t.grad, g)


@pytest.mark.parametrize("case, route", [
    ("f32", "plain"), ("decode", "plain"), ("len100", "plain"),
    ("mask", "composite"), ("d64", "flash")])
def test_sdpa_route_rule_on_the_card(card, case, route):
    shape = {"len100": (1, 100, 2, 128), "d64": (1, 128, 2, 64)}.get(
        case, (1, 128, 2, 128))
    dt = torch.float32 if case == "f32" else torch.bfloat16
    q, k, v = (_t(card, shape, dt) for _ in range(3))
    if case == "decode":
        q = q[:, -1:]
    mask = paddle.to_tensor(torch.ones((128, 128), dtype=torch.bool,
                                       device="cuda")) if case == "mask" \
        else None
    assert F.sdpa_route(q._data, k._data, mask) == route
    before = _counts()
    out = F.scaled_dot_product_attention(q, k, v, attn_mask=mask)
    assert _delta(before)[3] == (1 if route == "flash" else 0)
    ref = fa.sdpa_plain(q._data, k._data, v._data, False)
    torch.testing.assert_close(out._data.float(), ref.float(), **TOL)


def test_layer_llama_launch_counts_and_int8_decode(card):
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    L = 2
    paddle.seed(0)
    cfg = LlamaConfig(vocab_size=512, hidden_size=256, intermediate_size=512,
                      num_hidden_layers=L, num_attention_heads=2,
                      num_key_value_heads=1, tensor_parallel=False)
    model = LlamaForCausalLM(cfg).bfloat16()
    ids = paddle.randint(0, 512, [2, 64])
    before = _counts()
    loss = model(ids, labels=ids)
    fwd = _delta(before)
    assert fwd == (2 * L + 1, 0, 2 * L, L, 0, 0, 0)
    loss.backward()
    assert _delta(before) == (2 * L + 1, 2 * L + 1, 4 * L, L, L, L, 0)
    assert all(p.grad is not None for p in model.parameters())
    before = _counts()
    out = model.generate_compiled(ids[:, :16], max_new_tokens=4,
                                  quantize_int8=True)
    assert out.shape == [2, 20]
    assert _delta(before)[6] == (7 * L + 1) * 4
    assert ((out.numpy() >= 0) & (out.numpy() < 512)).all()
