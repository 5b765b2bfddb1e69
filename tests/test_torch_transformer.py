"""nn.Transformer and its parts on the port, held against paddle_tpu's on
the CPU at 2 + 2 layers, d_model 64, 4 heads, d_ff 128.

The port's layers take JAX's ``state_dict()`` (``MultiHeadAttention``'s
``q_proj`` / ``k_proj`` / ``v_proj`` / ``out_proj``, the norms, the
feed-forward pair); outputs and the gradients of ``sum(out * g)`` by the
inputs and every parameter agree within ``TOL`` (1e-5 relative and
absolute, in eval mode: dropout off), post-norm and ``normalize_before``,
with a padding ``src_mask`` and the causal ``tgt_mask``.  Incremental
decoding with ``gen_cache`` / ``cache=`` gives, step for step, the logits
of the full causal forward over the same tokens (teacher-forced) within
``TOL``, in both packages.  The routes each attention takes are read off
``F.sdpa_route``: the composite wherever a mask is given, the plain
attention for a cached step (q_len 1 against the cache), as JAX's
conditions give.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import paddle_tpu as jp  # noqa: E402
import paddle_tpu_torch as tp  # noqa: E402
import paddle_tpu_torch.nn.functional as TF  # noqa: E402
from paddle_tpu_torch.framework import place as tplace  # noqa: E402
from paddle_tpu_torch.models.weights import layer_state_from_jax  # noqa
from test_torch_nn_parity import TOL, _np, _r, both_layers  # noqa: E402

D, NHEAD, FF, B, S, T = 64, 4, 128, 2, 7, 5


@pytest.fixture(scope="module", autouse=True)
def _cpu():
    prev = tplace._current_place
    tp.set_device("cpu")
    yield
    tplace._current_place = prev


@pytest.fixture
def routes(monkeypatch):
    seen = []
    real = TF.sdpa_route

    def spy(*a, **k):
        r = real(*a, **k)
        seen.append(r)
        return r

    monkeypatch.setattr(TF, "sdpa_route", spy)
    return seen


def _masks():
    pad = np.zeros((B, 1, 1, S), np.float32)
    pad[1, ..., 5:] = -1e9                  # the second source is 5 long
    causal = np.triu(np.full((T, T), -np.inf, np.float32), 1)
    return pad, causal


def _model(nn, normalize_before=False):
    net = nn.Transformer(D, NHEAD, 2, 2, FF, dropout=0.1,
                         normalize_before=normalize_before)
    net.eval()
    return net


@pytest.mark.parametrize("normalize_before", [False, True])
def test_transformer_matches_jax(normalize_before, routes):
    pad, causal = _masks()
    src, tgt = _r(B, S, D), _r(B, T, D, seed=1)
    out = both_layers(lambda nn: _model(nn, normalize_before),
                      [src, tgt, pad, causal])
    assert out[0].shape == (B, T, D)
    # the 2 encoder and 2 decoder self-attentions, under a mask, take the
    # composite; the 2 cross-attentions, mask-free with q_len T != kv_len
    # S, the plain attention
    assert routes.count("composite") == 4 and routes.count("plain") == 2


def test_stacks_deep_copy_their_first_layer():
    net = _model(tp.nn)
    a = net.encoder.layers[0].linear1.weight
    b = net.encoder.layers[1].linear1.weight
    assert a is not b
    np.testing.assert_array_equal(_np(a), _np(b))
    assert {k for k, _ in net.named_parameters()} == \
        {k for k, _ in _model(jp.nn).named_parameters()}


def test_multi_head_attention_with_kdim_vdim_matches_jax():
    q, k, v = _r(B, T, D), _r(B, S, 32, seed=1), _r(B, S, 48, seed=2)
    both_layers(lambda nn: nn.MultiHeadAttention(D, NHEAD, kdim=32,
                                                 vdim=48), [q, k, v])


def test_encoder_layer_relu_and_gelu_match_jax():
    for act in ("relu", "gelu"):
        def make(nn):
            layer = nn.TransformerEncoderLayer(D, NHEAD, FF, activation=act,
                                               normalize_before=True)
            layer.eval()
            return layer
        both_layers(make, [_r(B, S, D)])


def _incremental(pkg, net, memory, tgt):
    """Decode teacher-forced one token at a time through the cache."""
    cache = net.decoder.gen_cache(memory)
    outs = []
    for t in range(tgt.shape[1]):
        step = pkg.to_tensor(tgt[:, t:t + 1])
        out, cache = net.decoder(step, memory, cache=cache)
        outs.append(_np(out))
    return np.concatenate(outs, 1)


def test_cached_decoding_equals_the_causal_forward(routes):
    src, tgt = _r(B, S, D), _r(B, T, D, seed=1)
    _, causal = _masks()
    jnet = _model(jp.nn)
    tnet = _model(tp.nn)
    layer_state_from_jax(tnet, jnet.state_dict())
    for pkg, net in ((jp, jnet), (tp, tnet)):
        memory = net.encoder(pkg.to_tensor(src))
        full = _np(net.decoder(pkg.to_tensor(tgt), memory,
                               tgt_mask=pkg.to_tensor(causal)))
        n_full = len(routes)
        np.testing.assert_allclose(_incremental(pkg, net, memory, tgt),
                                   full, **TOL)
    # the port's cached steps: every self-attention plain (q_len 1 over the
    # cache) and every cross-attention plain (1 query over S keys)
    assert routes[n_full:] == ["plain"] * (T * 2 * 2)
    # and the two packages' cached steps agree
    jmem, tmem = jnet.encoder(jp.to_tensor(src)), tnet.encoder(
        tp.to_tensor(src))
    np.testing.assert_allclose(_incremental(tp, tnet, tmem, tgt),
                               _incremental(jp, jnet, jmem, tgt), **TOL)


def test_square_subsequent_mask_equals_jax():
    np.testing.assert_array_equal(
        _np(tp.nn.Transformer.generate_square_subsequent_mask(5)),
        _np(jp.nn.Transformer.generate_square_subsequent_mask(5)))


def test_cache_shapes_follow_jax():
    mha = tp.nn.MultiHeadAttention(D, NHEAD)
    k, v = mha.gen_cache(tp.to_tensor(_r(B, S, D)))
    assert k.shape == v.shape == [B, 0, NHEAD, D // NHEAD]
    out, (k2, v2) = mha(tp.to_tensor(_r(B, 1, D)), cache=(k, v))
    assert out.shape == [B, 1, D] and k2.shape == [B, 1, NHEAD, D // NHEAD]
