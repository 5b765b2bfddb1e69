"""The port's BERT and GPT Layer models, and the layers they are built of,
held against paddle_tpu's on the same weights.

Every non-slow case of tests/test_gpt_bert_models.py runs through both
packages at its tiny sizes (GPT: vocab 128, hidden 64, 2 layers, 4 heads;
BERT: hidden 64, 2 layers, 4 heads, FFN 128), as do its two slow lanes
(the GPT pretraining steps; the BERT QA steps under O2 and a GradScaler)
at the same sizes.  JAX draws the weights; the port loads its
``state_dict()`` (``models.weights.layer_state_from_jax``).  Tolerances:
f32 logits within 1e-5 (relative and absolute), losses and every
gradient within 1e-4 (f32 through two layers, summed in another order);
parameters after 8 AdamW steps within 1e-4 (but the key bias, whose
gradient is rounding noise).  The O2 lane runs in bf16:
its losses agree within 2e-2 (a bf16 rounding a step, in both packages).
Every model runs on batches of 2 x 16 tokens (JAX compiles each op once a
shape), and JAX's attention takes its einsum composite
(``FLAGS_pallas_flash_attention`` off for this file): the port's CPU route
is the flash kernels' plain version, the same function.
``LayerNorm``, ``GELU`` (exact and tanh), ``Tanh`` and ``Dropout`` where
it is deterministic (p = 0, eval, ``downscale_in_infer``) match JAX
within 1e-6 (GELU 1e-5 absolute: the two tanh forms round differently
near their zeros).  Dropout in training draws other bits than ``jax.random``:
it is held by its statistics (the keep share within 0.01 of 1 - p over
200,000 draws, the kept values exactly x / (1 - p), one mask a slice
along ``axis``).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import paddle_tpu as jp  # noqa: E402
import paddle_tpu_torch as tp  # noqa: E402
from paddle_tpu import models as jmodels  # noqa: E402
from paddle_tpu_torch import models as tmodels  # noqa: E402
from paddle_tpu_torch.framework import place as tplace  # noqa: E402
from paddle_tpu_torch.models.weights import layer_state_from_jax  # noqa

LOGIT_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)
EXACT_TOL = dict(rtol=1e-6, atol=1e-6)
GELU_TOL = dict(rtol=1e-6, atol=1e-5)
GPT = dict(vocab_size=128, hidden_size=64, num_hidden_layers=2,
           num_attention_heads=4, max_position_embeddings=32,
           tensor_parallel=False)
BERT = dict(vocab_size=128, hidden_size=64, num_hidden_layers=2,
            num_attention_heads=4, intermediate_size=128,
            max_position_embeddings=32)


B, L = 2, 16


@pytest.fixture(scope="module", autouse=True)
def _cpu():
    prev = tplace._current_place
    prev_flag = jp.get_flags("FLAGS_pallas_flash_attention")
    tp.set_device("cpu")
    jp.set_flags({"FLAGS_pallas_flash_attention": False})
    yield
    jp.set_flags(prev_flag)
    tplace._current_place = prev


def _np(t):
    return np.asarray(t.numpy())


def _ids(B, L, V=128, seed=0):
    return np.random.RandomState(seed).randint(0, V, (B, L)).astype("int64")


def _pair(kind, seed, **over):
    """The JAX model drawn after ``jp.seed(seed)`` and the port's with its
    weights."""
    jp.seed(seed)
    if kind == "gpt":
        jm = jmodels.GPTForCausalLM(jmodels.GPTConfig(**dict(GPT, **over)))
        tm = tmodels.GPTForCausalLM(tmodels.GPTConfig(**dict(GPT, **over)))
    elif kind == "bert_cls":
        ncls = over.pop("num_classes", 2)
        jm = jmodels.BertForSequenceClassification(
            jmodels.BertConfig(**dict(BERT, **over)), num_classes=ncls)
        tm = tmodels.BertForSequenceClassification(
            tmodels.BertConfig(**dict(BERT, **over)), num_classes=ncls)
    else:
        jm = jmodels.BertForQuestionAnswering(
            jmodels.BertConfig(**dict(BERT, **over)))
        tm = tmodels.BertForQuestionAnswering(
            tmodels.BertConfig(**dict(BERT, **over)))
    layer_state_from_jax(tm, jm.state_dict())
    return jm, tm


def _both(jm, tm, *arrays, **kw):
    """Run both models on the same numpy inputs -> their outputs."""
    jo = jm(*[jp.to_tensor(a) for a in arrays],
            **{k: jp.to_tensor(v) for k, v in kw.items()})
    to = tm(*[tp.to_tensor(a) for a in arrays],
            **{k: tp.to_tensor(v) for k, v in kw.items()})
    return jo, to


def _grads(model):
    """Every parameter's gradient (None where the loss does not reach it,
    as the QA head leaves the pooler)."""
    return {n: None if p.grad is None else _np(p.grad)
            for n, p in model.named_parameters()}


def _close_grads(jm, tm):
    jg, tg = _grads(jm), _grads(tm)
    assert jg.keys() == tg.keys()
    assert sum(g is not None for g in tg.values()) > len(tg) // 2
    for n in jg:
        assert (tg[n] is None) == (jg[n] is None), n
        if jg[n] is not None:
            np.testing.assert_allclose(tg[n], jg[n], err_msg=n,
                                       **GRAD_TOL)


# -- tests/test_gpt_bert_models.py, case by case --------------------------

def test_gpt3_1p3b_config_matches_jax():
    jc, tc = jmodels.gpt3_1p3b_config(), tmodels.gpt3_1p3b_config()
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    assert tc.hidden_size == 2048 and tc.num_hidden_layers == 24
    assert tc.head_dim == 128 and tc.intermediate_size == 8192
    assert dataclasses.asdict(tmodels.BertConfig()) == \
        dataclasses.asdict(jmodels.BertConfig())


def test_gpt_forward_and_causality_match_jax():
    jm, tm = _pair("gpt", 50)
    jm.eval()
    tm.eval()
    ids = _ids(B, L)
    jo, to = _both(jm, tm, ids)
    assert to.shape == [B, L, 128] and to.dtype == tp.float32
    np.testing.assert_allclose(_np(to), _np(jo), **LOGIT_TOL)
    ids2 = ids.copy()
    ids2[:, 10:] = (ids2[:, 10:] + 1) % 128
    jo2, to2 = _both(jm, tm, ids2)
    np.testing.assert_allclose(_np(to2), _np(jo2), **LOGIT_TOL)
    np.testing.assert_allclose(_np(to2)[:, :10], _np(to)[:, :10],
                               rtol=1e-4, atol=1e-5)
    assert not np.allclose(_np(to2)[:, 10:], _np(to)[:, 10:])


def test_gpt_loss_and_every_gradient_match_jax():
    jm, tm = _pair("gpt", 51)
    ids = _ids(B, L, seed=1)
    jl = jmodels.GPTPretrainingCriterion()(jm(jp.to_tensor(ids)),
                                            jp.to_tensor(ids))
    tl = tmodels.GPTPretrainingCriterion()(tm(tp.to_tensor(ids)),
                                            tp.to_tensor(ids))
    np.testing.assert_allclose(float(tl), float(jl), **GRAD_TOL)
    jl.backward()
    tl.backward()
    _close_grads(jm, tm)


def test_gpt_padding_mask_keeps_causality_and_matches_jax():
    jm, tm = _pair("gpt", 56)
    jm.eval()
    tm.eval()
    ids = _ids(B, L)
    pad = np.ones((B, L), dtype="int64")
    jo, to = _both(jm, tm, ids, attn_mask=pad)
    np.testing.assert_allclose(_np(to), _np(jo), **LOGIT_TOL)
    ids2 = ids.copy()
    ids2[:, 8:] = (ids2[:, 8:] + 1) % 128
    _, to2 = _both(jm, tm, ids2, attn_mask=pad)
    np.testing.assert_allclose(_np(to2)[:, :8], _np(to)[:, :8],
                               rtol=1e-4, atol=1e-5)


def test_bert_padding_mask_blocks_pad_tokens_and_matches_jax():
    jm, tm = _pair("bert_cls", 57)
    jm.eval()
    tm.eval()
    ids = _ids(B, L)
    mask = np.ones((B, L), dtype="int64")
    mask[:, 7:] = 0
    jo, to = _both(jm, tm, ids, attn_mask=mask)
    np.testing.assert_allclose(_np(to), _np(jo), **LOGIT_TOL)
    ids[:, 7:] = (ids[:, 7:] + 5) % 128
    _, to2 = _both(jm, tm, ids, attn_mask=mask)
    np.testing.assert_allclose(_np(to2), _np(to), rtol=1e-4, atol=1e-5)


def test_position_overflow_raises():
    tm = tmodels.GPTForCausalLM(tmodels.GPTConfig(**GPT))
    with pytest.raises(ValueError, match="max_position"):
        tm(tp.to_tensor(_ids(1, 40)))
    bert = tmodels.BertForSequenceClassification(
        tmodels.BertConfig(**BERT))
    with pytest.raises(ValueError, match="max_position"):
        bert(tp.to_tensor(_ids(1, 40)))


def test_bert_forward_shapes_and_logits_match_jax():
    jm, tm = _pair("bert_cls", 53, num_classes=3)
    jm.eval()
    tm.eval()
    ids = _ids(B, L)
    jo, to = _both(jm, tm, ids)
    assert to.shape == [B, 3]
    np.testing.assert_allclose(_np(to), _np(jo), **LOGIT_TOL)
    jq, tq = _pair("bert_qa", 53)
    jq.eval()
    tq.eval()
    (js, je), (ts, te) = _both(jq, tq, ids)
    assert ts.shape == [B, L] and te.shape == [B, L]
    np.testing.assert_allclose(_np(ts), _np(js), **LOGIT_TOL)
    np.testing.assert_allclose(_np(te), _np(je), **LOGIT_TOL)


def test_bert_token_type_changes_output_as_in_jax():
    jm, tm = _pair("bert_cls", 54)
    jm.eval()
    tm.eval()
    ids = _ids(B, L)
    tt = np.ones((B, L), dtype="int64")
    _, a = _both(jm, tm, ids)
    jb, b = _both(jm, tm, ids, token_type_ids=tt)
    np.testing.assert_allclose(_np(b), _np(jb), **LOGIT_TOL)
    assert not np.allclose(_np(a), _np(b))


@pytest.mark.parametrize("masked", [False, True])
def test_bert_qa_loss_and_every_gradient_match_jax(masked):
    jm, tm = _pair("bert_qa", 58)
    ids = _ids(B, L, seed=2)
    rng = np.random.RandomState(3)
    s, e = rng.randint(0, L, (B,)), rng.randint(0, L, (B,))
    kw = {}
    if masked:
        mask = np.ones((B, L), dtype="int64")
        mask[0, 9:] = 0
        kw["attn_mask"] = mask

    def loss(pkg, model):
        st, en = model(pkg.to_tensor(ids),
                       **{k: pkg.to_tensor(v) for k, v in kw.items()})
        F = pkg.nn.functional
        return (F.cross_entropy(st, pkg.to_tensor(s))
                + F.cross_entropy(en, pkg.to_tensor(e))) / 2

    jl, tl = loss(jp, jm), loss(tp, tm)
    np.testing.assert_allclose(float(tl), float(jl), **GRAD_TOL)
    jl.backward()
    tl.backward()
    _close_grads(jm, tm)


# -- the slow lanes, at the same tiny size -------------------------------

def test_gpt_pretrain_steps_match_jax():
    """tests/test_gpt_bert_models.py:58: 8 AdamW steps on one batch."""
    jm, tm = _pair("gpt", 51)
    ids = _ids(B, L, seed=1)
    jopt = jp.optimizer.AdamW(learning_rate=3e-3,
                              parameters=jm.parameters())
    topt = tp.optimizer.AdamW(learning_rate=3e-3,
                              parameters=tm.parameters())
    jl, tl = [], []
    for pkg, m, opt, out in ((jp, jm, jopt, jl), (tp, tm, topt, tl)):
        crit = (jmodels if pkg is jp else tmodels).GPTPretrainingCriterion()
        x = pkg.to_tensor(ids)
        for _ in range(8):
            loss = crit(m(x), x)
            loss.backward()
            opt.step()
            opt.clear_grad()
            out.append(float(loss))
    np.testing.assert_allclose(tl, jl, **GRAD_TOL)
    assert tl[-1] < tl[0] * 0.7, tl
    H = GPT["hidden_size"]
    for (n, jpar), (_, tpar) in zip(jm.named_parameters(),
                                    tm.named_parameters()):
        j, t = _np(jpar), _np(tpar)
        if n.endswith("qkv_proj.bias"):
            # the key bias gets a zero gradient up to rounding (softmax
            # ignores a shift of every score of a row), which Adam's
            # m / sqrt(v) turns into steps of either sign
            j, t = np.delete(j, np.s_[H:2 * H]), np.delete(t, np.s_[H:2 * H])
        np.testing.assert_allclose(t, j, err_msg=n, **GRAD_TOL)


def test_bert_squad_o2_gradscaler_steps_match_jax():
    """tests/test_gpt_bert_models.py:178: QA steps under auto_cast O2 with
    a GradScaler, bf16 parameters from ``amp.decorate``."""
    jm, tm = _pair("bert_qa", 55)
    ids = _ids(B, L, seed=3)
    rng = np.random.RandomState(4)
    s, e = rng.randint(0, L, (B,)), rng.randint(0, L, (B,))
    out = {}
    for pkg, m in ((jp, jm), (tp, tm)):
        opt = pkg.optimizer.AdamW(learning_rate=3e-3,
                                  parameters=m.parameters(),
                                  multi_precision=True)
        m, opt = pkg.amp.decorate(m, opt, level="O2")
        scaler = pkg.amp.GradScaler(init_loss_scaling=2.0 ** 10)
        F = pkg.nn.functional
        x, ys, ye = (pkg.to_tensor(a) for a in (ids, s, e))
        losses = []
        for _ in range(6):
            with pkg.amp.auto_cast(level="O2"):
                sl, el = m(x)
                loss = (F.cross_entropy(sl, ys) + F.cross_entropy(el, ye)) / 2
            scaler.scale(loss).backward()
            scaler.step(opt)
            scaler.update()
            opt.clear_grad()
            losses.append(float(loss))
        out[pkg.__name__] = losses
        for p in m.parameters():
            assert np.isfinite(_np(p)).all()
        if pkg is tp:
            ln = m.bert.embeddings.layer_norm.weight
            assert ln.dtype == tp.float32
            assert m.qa_outputs.weight.dtype == tp.bfloat16
    tl, jl = out["paddle_tpu_torch"], out["paddle_tpu"]
    np.testing.assert_allclose(tl, jl, rtol=2e-2, atol=2e-2)
    assert tl[-1] < tl[0], tl


# -- the layers ------------------------------------------------------------

def _layer_pair(name, *args, **kw):
    return getattr(jp.nn, name)(*args, **kw), getattr(tp.nn, name)(*args,
                                                                    **kw)


@pytest.mark.parametrize("wb", ["both", "no_weight", "no_bias", "none"])
def test_layer_norm_matches_jax(wb):
    kw = {}
    if wb in ("no_weight", "none"):
        kw["weight_attr"] = False
    if wb in ("no_bias", "none"):
        kw["bias_attr"] = False
    jl, tl = _layer_pair("LayerNorm", 24, epsilon=1e-5, **kw)
    rng = np.random.RandomState(0)
    if tl.weight is not None:
        w = rng.randn(24).astype(np.float32)
        jl.weight.set_value(w)
        tl.weight.set_value(w)
    if tl.bias is not None:
        b = rng.randn(24).astype(np.float32)
        jl.bias.set_value(b)
        tl.bias.set_value(b)
    assert (tl.weight is None) == (jl.weight is None)
    assert (tl.bias is None) == (jl.bias is None)
    x = (rng.randn(3, 5, 24) * 3 + 1).astype(np.float32)
    jx = jp.to_tensor(x, stop_gradient=False)
    tx = tp.to_tensor(x, stop_gradient=False)
    jo, to = jl(jx), tl(tx)
    np.testing.assert_allclose(_np(to), _np(jo), **EXACT_TOL)
    g = rng.randn(3, 5, 24).astype(np.float32)
    (jo * jp.to_tensor(g)).sum().backward()
    (to * tp.to_tensor(g)).sum().backward()
    np.testing.assert_allclose(_np(tx.grad), _np(jx.grad), rtol=1e-5,
                               atol=1e-5)


def test_functional_layer_norm_over_two_axes_and_mixed_types():
    x = np.random.RandomState(1).randn(2, 3, 4, 5).astype(np.float32)
    w = np.random.RandomState(2).randn(4, 5).astype(np.float32)
    jo = jp.nn.functional.layer_norm(jp.to_tensor(x), [4, 5],
                                     weight=jp.to_tensor(w))
    to = tp.nn.functional.layer_norm(tp.to_tensor(x), [4, 5],
                                     weight=tp.to_tensor(w))
    np.testing.assert_allclose(_np(to), _np(jo), **EXACT_TOL)
    # a bf16 x with f32 weights promotes to f32, as in JAX
    xb = tp.to_tensor(x).astype("bfloat16")
    out = tp.nn.functional.layer_norm(xb, [4, 5], weight=tp.to_tensor(w))
    jout = jp.nn.functional.layer_norm(jp.to_tensor(x).astype("bfloat16"),
                                       [4, 5], weight=jp.to_tensor(w))
    assert out.dtype == tp.float32 and jout.dtype == jp.float32


@pytest.mark.parametrize("approximate", [False, True])
def test_gelu_matches_jax(approximate):
    x = np.linspace(-6, 6, 241).astype(np.float32)
    jl, tl = _layer_pair("GELU", approximate=approximate)
    jx = jp.to_tensor(x, stop_gradient=False)
    tx = tp.to_tensor(x, stop_gradient=False)
    jo, to = jl(jx), tl(tx)
    np.testing.assert_allclose(_np(to), _np(jo), **GELU_TOL)
    jo.sum().backward()
    to.sum().backward()
    np.testing.assert_allclose(_np(tx.grad), _np(jx.grad), **GELU_TOL)


def test_tanh_matches_jax():
    x = np.linspace(-4, 4, 81).astype(np.float32)
    jl, tl = _layer_pair("Tanh")
    np.testing.assert_allclose(_np(tl(tp.to_tensor(x))),
                               _np(jl(jp.to_tensor(x))), **EXACT_TOL)
    np.testing.assert_allclose(_np(tp.nn.functional.tanh(tp.to_tensor(x))),
                               np.tanh(x), **EXACT_TOL)


@pytest.mark.parametrize("case", ["p0_train", "eval_upscale",
                                  "eval_downscale", "p0_downscale"])
def test_dropout_deterministic_cases_match_jax(case):
    p = 0.0 if case.startswith("p0") else 0.3
    mode = "downscale_in_infer" if "downscale" in case else \
        "upscale_in_train"
    jl, tl = _layer_pair("Dropout", p, mode=mode)
    if case.startswith("eval"):
        jl.eval()
        tl.eval()
    x = np.random.RandomState(3).randn(4, 7).astype(np.float32)
    np.testing.assert_allclose(_np(tl(tp.to_tensor(x))),
                               _np(jl(jp.to_tensor(x))), **EXACT_TOL)


@pytest.mark.parametrize("p", [0.1, 0.5])
@pytest.mark.parametrize("mode", ["upscale_in_train", "downscale_in_infer"])
def test_dropout_in_training_by_statistics(p, mode):
    tp.seed(5)
    x = np.full((400, 500), 2.0, dtype=np.float32)
    out = _np(tp.nn.functional.dropout(tp.to_tensor(x), p=p, mode=mode))
    kept = out != 0
    assert abs(kept.mean() - (1 - p)) < 0.01
    want = 2.0 / (1 - p) if mode == "upscale_in_train" else 2.0
    np.testing.assert_array_equal(out[kept], np.float32(want))
    # a fresh mask each call, the same after the same seed
    again = _np(tp.nn.functional.dropout(tp.to_tensor(x), p=p, mode=mode))
    assert (again != out).any()
    tp.seed(5)
    np.testing.assert_array_equal(
        _np(tp.nn.functional.dropout(tp.to_tensor(x), p=p, mode=mode)), out)


@pytest.mark.parametrize("axis", [0, 1, [0, 2]])
def test_dropout_axis_masks_whole_slices(axis):
    tp.seed(6)
    x = np.ones((64, 32, 8), dtype=np.float32)
    out = _np(tp.nn.functional.dropout(tp.to_tensor(x), p=0.5, axis=axis))
    ax = [axis] if isinstance(axis, int) else axis
    other = tuple(i for i in range(3) if i not in ax)
    # the mask has size 1 along every axis not in ``axis``
    assert (out.min(axis=other) == out.max(axis=other)).all()
    share = (out != 0).mean()
    assert 0.3 < share < 0.7
    assert set(np.unique(out)) <= {0.0, 2.0}


def test_dropout_gradient_follows_its_mask():
    tp.seed(7)
    x = tp.to_tensor(np.ones((50, 40), np.float32), stop_gradient=False)
    out = tp.nn.functional.dropout(x, p=0.25)
    out.sum().backward()
    np.testing.assert_array_equal(_np(x.grad), _np(out))


def test_sdpa_dropout_drops_the_output_as_jax_does():
    """JAX applies dropout to the attention's output, not to the
    probabilities: at p = 0.5 every output element is 0 or twice the
    dropout-free output."""
    rng = np.random.RandomState(8)
    q, k, v = (tp.to_tensor(rng.randn(2, 16, 2, 8).astype(np.float32))
               for _ in range(3))
    F = tp.nn.functional
    ref = _np(F.scaled_dot_product_attention(q, k, v))
    jref = _np(jp.nn.functional.scaled_dot_product_attention(
        *(jp.to_tensor(_np(t)) for t in (q, k, v))))
    np.testing.assert_allclose(ref, jref, **LOGIT_TOL)
    tp.seed(9)
    out = _np(F.scaled_dot_product_attention(q, k, v, dropout_p=0.5))
    kept = out != 0
    assert 0.4 < kept.mean() < 0.6
    np.testing.assert_allclose(out[kept], 2 * ref[kept], rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(
        _np(F.scaled_dot_product_attention(q, k, v, dropout_p=0.5,
                                           training=False)), ref,
        **LOGIT_TOL)


def test_normalize_attn_mask_matches_jax():
    from paddle_tpu.models import _layers as jlayers
    from paddle_tpu_torch.models import _layers as tlayers
    pad = np.array([[1, 1, 0], [1, 0, 0]], dtype=np.int64)
    j = _np(jlayers.normalize_attn_mask(jp.to_tensor(pad)))
    t = tlayers.normalize_attn_mask(tp.to_tensor(pad))
    assert t.shape == [2, 1, 1, 3] and t.dtype == tp.float32
    np.testing.assert_array_equal(_np(t), j)
    m3 = np.tril(np.ones((2, 3, 3), dtype=bool))
    assert tlayers.normalize_attn_mask(tp.to_tensor(m3)).shape == \
        [2, 1, 3, 3]
    m4 = tp.to_tensor(np.zeros((2, 1, 3, 3), np.float32))
    assert tlayers.normalize_attn_mask(m4) is m4
    assert tlayers.normalize_attn_mask(None) is None
