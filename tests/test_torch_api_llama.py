"""The port's Layer-API LLaMA held against paddle_tpu's on the same
weights: logits, loss, every parameter's gradient, three AdamW steps, the
eager ``generate``, ``generate_compiled`` (untied and tied, greedy, int8),
the dense decode's beam search and ``generate_auto`` on both routes.

The config is JAX's tiny one (tests/test_llama_flagship.py: vocab 64,
hidden 32, 2 layers, 4 heads), with 2 KV heads (GQA) unless a case says
otherwise, in f32.  JAX draws the weights; the port loads its
``state_dict()`` (``models.weights.layer_state_from_jax``).  Tolerances:
1e-5 relative on logits and losses, 1e-4 on gradients and on parameters
after the optimizer steps (f32 through two layers, summed in another
order; JAX's attention is its Pallas flash kernel in interpret mode).
Free-running token sequences are compared position by position: a token
may differ from JAX's only where JAX's own top-2 logit margin at that
position, teacher-forced on the port's tokens, is below 1e-4 (a near-tie
of a tiny random model).  Sampling is compared by distribution.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import paddle_tpu as jp  # noqa: E402
import paddle_tpu_torch as tp  # noqa: E402
from paddle_tpu.models import LlamaConfig as JConfig  # noqa: E402
from paddle_tpu.models import LlamaForCausalLM as JLM  # noqa: E402
from paddle_tpu.models import decode as jdec  # noqa: E402
from paddle_tpu.models import paged_decode as jpd  # noqa: E402
from paddle_tpu_torch.framework import place as tplace  # noqa: E402
from paddle_tpu_torch.models import LlamaConfig as TConfig  # noqa: E402
from paddle_tpu_torch.models import LlamaForCausalLM as TLM  # noqa: E402
from paddle_tpu_torch.models import _layers as tlayers  # noqa: E402
from paddle_tpu_torch.models import decode as tdec  # noqa: E402
from paddle_tpu_torch.models import paged_decode as tpd  # noqa: E402
from paddle_tpu_torch.models.weights import (  # noqa: E402
    causal_lm_from_params, layer_state_from_jax, params_from_jax)

LOGIT_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)
TIE = 1e-4
BASE = dict(vocab_size=64, hidden_size=32, intermediate_size=96,
            num_hidden_layers=2, num_attention_heads=4,
            max_position_embeddings=32, tensor_parallel=False)
IDS = np.random.RandomState(0).randint(0, 64, (2, 16))


@pytest.fixture(scope="module", autouse=True)
def _cpu():
    prev = tplace._current_place
    tp.set_device("cpu")
    yield
    tplace._current_place = prev


def _pair(kvh=2, tie=False, seed=0):
    kw = dict(BASE, num_key_value_heads=kvh, tie_word_embeddings=tie)
    jp.seed(seed)
    jm = JLM(JConfig(**kw))
    tm = TLM(TConfig(**kw))
    layer_state_from_jax(tm, jm.state_dict())
    return jm, tm


@pytest.fixture(scope="module")
def gqa():
    return _pair()


def _np(t):
    return np.asarray(t.numpy())


def _jax_logits(jm, toks):
    return _np(jm(jp.to_tensor(np.asarray(toks))))


def _jax_pcfg(jm):
    """The f32 ``LlamaPretrainConfig`` JAX's ``generate_compiled`` builds
    for ``jm``."""
    import jax.numpy as jnp
    from paddle_tpu.models.llama_pretrain import LlamaPretrainConfig
    c = jm.cfg
    return LlamaPretrainConfig(
        vocab_size=c.vocab_size, hidden_size=c.hidden_size,
        intermediate_size=c.intermediate_size,
        num_hidden_layers=c.num_hidden_layers,
        num_attention_heads=c.num_attention_heads,
        num_key_value_heads=c.num_key_value_heads,
        max_seq_len=c.max_position_embeddings, rope_theta=c.rope_theta,
        rms_norm_eps=c.rms_norm_eps, use_pallas_attention=False,
        sequence_parallel=False, remat=False, dtype=jnp.float32,
        param_dtype=jnp.float32)


def _check_tokens(jm, prompt, jtoks, ttoks):
    """``ttoks`` equal to ``jtoks`` wherever JAX's teacher-forced margin on
    the port's sequence exceeds ``TIE``; both [B, new]."""
    jtoks, ttoks = np.asarray(jtoks), np.asarray(ttoks)
    assert jtoks.shape == ttoks.shape
    P = prompt.shape[1]
    seq = np.concatenate([prompt, ttoks], 1)
    logits = _jax_logits(jm, seq[:, :-1])[:, P - 1:]
    top2 = np.sort(logits, -1)[..., -2:]
    margin = top2[..., 1] - top2[..., 0]
    for b in range(ttoks.shape[0]):
        for i in range(ttoks.shape[1]):
            if ttoks[b, i] != jtoks[b, i]:
                assert margin[b, i] < TIE, (b, i, margin[b, i])
                break           # the sequences fork here; stop comparing
            if margin[b, i] >= TIE:
                assert ttoks[b, i] == logits[b, i].argmax(), (b, i)


@pytest.mark.parametrize("kvh, tie", [(2, False), (None, False), (2, True)],
                         ids=["gqa", "mha", "tied"])
def test_logits_loss_and_grads_match_jax(kvh, tie):
    jm, tm = _pair(kvh, tie)
    assert list(tm.state_dict()) == list(jm.state_dict())
    np.testing.assert_allclose(_np(tm(tp.to_tensor(IDS))),
                               _jax_logits(jm, IDS), **LOGIT_TOL)
    jl = jm(jp.to_tensor(IDS), labels=jp.to_tensor(IDS))
    tl = tm(tp.to_tensor(IDS), labels=tp.to_tensor(IDS))
    np.testing.assert_allclose(float(tl), float(jl), **LOGIT_TOL)
    jl.backward()
    tl.backward()
    jg = {n: _np(p.grad) for n, p in jm.named_parameters()}
    tg = {n: _np(p.grad) for n, p in tm.named_parameters()}
    assert jg.keys() == tg.keys() and len(tg) == len(tm.parameters())
    for n in jg:
        np.testing.assert_allclose(tg[n], jg[n], err_msg=n, **GRAD_TOL)


def test_three_adamw_steps_match_jax():
    jm, tm = _pair()
    jo = jp.optimizer.AdamW(1e-2, parameters=jm.parameters(),
                            weight_decay=0.1)
    to = tp.optimizer.AdamW(1e-2, parameters=tm.parameters(),
                            weight_decay=0.1)
    for step in range(3):
        jl = jm(jp.to_tensor(IDS), labels=jp.to_tensor(IDS))
        tl = tm(tp.to_tensor(IDS), labels=tp.to_tensor(IDS))
        np.testing.assert_allclose(float(tl), float(jl), err_msg=str(step),
                                   **LOGIT_TOL)
        for m, loss, opt in ((jm, jl, jo), (tm, tl, to)):
            loss.backward()
            opt.step()
            opt.clear_grad()
    for (n, jw), (_, tw) in zip(jm.named_parameters(),
                                tm.named_parameters()):
        np.testing.assert_allclose(_np(tw), _np(jw), err_msg=n, **GRAD_TOL)


def test_eager_generate_matches_jax(gqa):
    jm, tm = gqa
    prompt = IDS[:, :5]
    jt = _np(jm.generate(jp.to_tensor(prompt), max_new_tokens=6))
    tt = _np(tm.generate(tp.to_tensor(prompt), max_new_tokens=6))
    assert tt.shape == (2, 11) and (tt[:, :5] == prompt).all()
    _check_tokens(jm, prompt, jt[:, 5:], tt[:, 5:])
    # inside the port: each token is the argmax of the plain full forward
    full = _np(tm(tp.to_tensor(tt[:, :-1])))[:, 4:]
    np.testing.assert_array_equal(full.argmax(-1), tt[:, 5:])
    # top-p at a vanishing mass keeps only the top token: greedy again
    tp_ = _np(tm.generate(tp.to_tensor(prompt), max_new_tokens=6,
                          temperature=1.0, top_p=1e-9))
    np.testing.assert_array_equal(tp_, tt)


@pytest.mark.parametrize("tie", [False, True], ids=["untied", "tied"])
def test_generate_compiled_matches_jax(tie):
    jm, tm = _pair(tie=tie)
    prompt = IDS[:, :6]
    jt = _np(jm.generate_compiled(jp.to_tensor(prompt), max_new_tokens=5))
    tt = _np(tm.generate_compiled(tp.to_tensor(prompt), max_new_tokens=5))
    assert tt.shape == (2, 11) and (tt[:, :6] == prompt).all()
    _check_tokens(jm, prompt, jt[:, 6:], tt[:, 6:])
    # the eager loop and the dense decode agree inside the port
    np.testing.assert_array_equal(
        _np(tm.generate(tp.to_tensor(prompt), max_new_tokens=5)), tt)
    # int8 weights: JAX's own int8 decode is the reference
    jq = _np(jm.generate_compiled(jp.to_tensor(prompt), max_new_tokens=5,
                                  quantize_int8=True))
    tq = _np(tm.generate_compiled(tp.to_tensor(prompt), max_new_tokens=5,
                                  quantize_int8=True))
    pj = jdec.quantize_params_int8(jm._pretrain_params())
    np.testing.assert_array_equal(
        np.asarray(pj["lm_head"]["q"]),
        tm._cached_pretrain_params(True)["lm_head"]["q"].numpy())
    np.testing.assert_array_equal(tq, jq)


def test_generate_compiled_params_follow_the_parameters(gqa):
    _, tm = _pair()
    p0 = tm._cached_pretrain_params()
    assert tm._cached_pretrain_params() is p0          # kept
    opt = tp.optimizer.SGD(0.1, parameters=tm.parameters())
    tm(tp.to_tensor(IDS), labels=tp.to_tensor(IDS)).backward()
    opt.step()                                         # in-place update
    p1 = tm._cached_pretrain_params()
    assert p1 is not p0
    np.testing.assert_array_equal(
        p1["blocks"]["wq"][0].numpy(),
        _np(tm.llama.layers[0].self_attn.q_proj.weight))
    tm.llama.norm.weight.set_value(np.full(32, 2.0, np.float32))  # rebound
    assert tm._cached_pretrain_params() is not p1
    assert tm._cached_pretrain_params(True) is not None


def test_sampled_generate_compiled_follows_the_softmax(gqa):
    """temperature 1: the first new token's frequencies over 20,000 rows
    against the softmax of the teacher-forced logits (total variation)."""
    _, tm = gqa
    prompt = np.repeat(IDS[:1, :4], 20000, axis=0)
    out = _np(tm.generate_compiled(tp.to_tensor(prompt), max_new_tokens=1,
                                   temperature=1.0, seed=3))[:, 4]
    logits = _np(tm(tp.to_tensor(IDS[:1, :4])))[0, -1]
    p = np.exp(logits - logits.max())
    p /= p.sum()
    freq = np.bincount(out, minlength=64) / len(out)
    assert 0.5 * np.abs(freq - p).sum() < 0.05


@pytest.mark.parametrize("k", [1, 3])
def test_beam_search_matches_jax(gqa, k):
    jm, tm = gqa
    prompt = IDS[:, :6]
    import jax.numpy as jnp
    jt, js = jdec.make_generate_beam(_jax_pcfg(jm), 6, 5, k)(
        jm._pretrain_params(), jnp.asarray(prompt))
    tparams = tm._cached_pretrain_params()
    tt, ts = tdec.make_generate_beam(tm._pretrain_config(), 6, 5, k)(
        tparams, torch.as_tensor(prompt))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), **LOGIT_TOL)
    if k == 1:
        greedy = tdec.make_generate(tm._pretrain_config(), 6, 5)(
            tparams, torch.as_tensor(prompt))
        np.testing.assert_array_equal(tt.numpy(), greedy.numpy())
    with pytest.raises(ValueError, match="num_beams"):
        tdec.make_generate_beam(tm._pretrain_config(), 6, 5, 0)
    with pytest.raises(ValueError, match="max_len"):
        tdec.make_generate(tm._pretrain_config(), 6, 5, max_len=8)


@pytest.mark.parametrize("ragged", [False, True], ids=["uniform", "ragged"])
def test_generate_auto_routes_and_matches_jax(gqa, ragged, monkeypatch):
    jm, tm = gqa
    prompts = [list(IDS[0, :7]), list(IDS[1, :5 if ragged else 7])]
    jt = np.asarray(jpd.generate_auto(_jax_pcfg(jm), jm._pretrain_params(),
                                      prompts, 4, page=8))
    routes = []
    for mod, name in ((tdec, "make_generate"), (tpd, "generate_paged")):
        real = getattr(mod, name)

        def spy(*a, _real=real, _name=name, **kw):
            routes.append(_name)
            return _real(*a, **kw)
        monkeypatch.setattr(mod, name, spy)
    tcfg = tm._pretrain_config()
    tt = tpd.generate_auto(tcfg, tm._cached_pretrain_params(), prompts, 4,
                           page=8).numpy()
    assert routes == (["generate_paged"] if ragged else ["make_generate"])
    for b, pr in enumerate(prompts):
        _check_tokens(jm, np.asarray([pr]), jt[b:b + 1], tt[b:b + 1])


def test_causal_lm_from_params_views_the_functional_tree():
    from paddle_tpu_torch.models import llama_pretrain as tlp
    pc = tlp.LlamaPretrainConfig(vocab_size=64, hidden_size=32,
                                 intermediate_size=96, num_hidden_layers=2,
                                 num_attention_heads=4, num_key_value_heads=2,
                                 dtype=torch.float32)
    params = tlp.init_params(pc, seed=1, device="cpu")
    cfg = TConfig(**dict(BASE, num_key_value_heads=2))
    m = causal_lm_from_params(params, cfg)
    w = m.llama.layers[1].mlp.down_proj.weight
    assert w._data.data_ptr() == params["blocks"]["w_down"][1].data_ptr()
    assert not w.stop_gradient and w.is_leaf
    toks = torch.as_tensor(IDS)
    loss = m(tp.to_tensor(IDS[:, :-1]), labels=tp.to_tensor(IDS[:, 1:]))
    ref = tlp.make_forward(pc)(params, toks)
    np.testing.assert_allclose(float(loss), float(ref), **LOGIT_TOL)
    with pytest.raises(ValueError, match="untied"):
        causal_lm_from_params(params, TConfig(**dict(
            BASE, tie_word_embeddings=True)))
    # loading from a JAX npz-style dict of numpy arrays, by name
    jp.seed(4)
    jm = JLM(JConfig(**dict(BASE, num_key_value_heads=2)))
    arrays = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    layer_state_from_jax(m, arrays)
    np.testing.assert_allclose(_np(m(tp.to_tensor(IDS))),
                               _jax_logits(jm, IDS), **LOGIT_TOL)
    with pytest.raises(KeyError):
        layer_state_from_jax(m, dict(arrays, extra=np.zeros(1)))


def test_tensor_parallel_without_a_group_is_plain(monkeypatch):
    m = TLM(TConfig(**dict(BASE, tensor_parallel=True)))
    assert isinstance(m.llama.layers[0].self_attn.q_proj, tp.nn.Linear)
    monkeypatch.setattr(tlayers.dist, "is_initialized", lambda: True)
    monkeypatch.setattr(tlayers.dist, "get_world_size", lambda: 2)
    with pytest.raises(NotImplementedError, match="item 7"):
        TLM(TConfig(**dict(BASE, tensor_parallel=True)))
    TLM(TConfig(**BASE))                       # tensor_parallel=False


def test_weights_from_jax_tree_drive_the_port_layer_model():
    """The functional JAX tree (``_pretrain_params``) through
    ``params_from_jax`` equals the port's own stacking of the same
    Layer weights."""
    jm, tm = _pair()
    tree = params_from_jax(jm._pretrain_params(), device="cpu")
    mine = tm._pretrain_params()
    for k in ("embed", "final_norm", "lm_head"):
        np.testing.assert_array_equal(tree[k].numpy(), mine[k].numpy())
    for k in tree["blocks"]:
        np.testing.assert_array_equal(tree["blocks"][k].numpy(),
                                      mine["blocks"][k].numpy())
