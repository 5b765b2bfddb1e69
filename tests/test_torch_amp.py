"""The port's AMP held against paddle_tpu's: the types its dispatch hook
gives each op's inputs, op by op, under O1 and O2, with custom lists and
per thread; ``decorate``; ``GradScaler``'s scale, unscale, inf skip and
update trajectory; and the attention route the O1 cast decides.

Both packages' hooks are wrapped to record ``(op name, the input types
after the hook)`` for every op dispatched; the records must be equal (the
same ops in the same order with the same types), and the outputs agree
within 2e-2 (one bf16 rounding, in another order of summation).  The
GradScaler runs the same inputs through both packages (a gradient made
inf on chosen steps) and must give the same scale, good / bad step counts
and parameters (1e-6) after every update.
"""

import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import paddle_tpu as jp  # noqa: E402
import paddle_tpu_torch as tp  # noqa: E402
from paddle_tpu import models as jmodels  # noqa: E402
from paddle_tpu.ops import dispatch as jdispatch  # noqa: E402
from paddle_tpu_torch import models as tmodels  # noqa: E402
from paddle_tpu_torch.framework import place as tplace  # noqa: E402
from paddle_tpu_torch.models.weights import layer_state_from_jax  # noqa
from paddle_tpu_torch.ops import dispatch as tdispatch  # noqa: E402

BF16_TOL = dict(rtol=2e-2, atol=2e-2)
B, L = 2, 16


@pytest.fixture(scope="module", autouse=True)
def _cpu():
    prev = tplace._current_place
    tp.set_device("cpu")
    yield
    tplace._current_place = prev


def _np(t):
    return np.asarray(t.numpy())


def _name(dt):
    return str(dt).replace("torch.", "").replace("paddle.", "")


class _Recorder:
    """Wrap a package's installed AMP hook; ``log`` gets (op, types).
    The port's route probe (``ops.dispatch.amp_cast_dtype``: one empty
    tensor, no op runs) is left out."""

    def __init__(self, mod):
        self.mod, self.log = mod, []

    def __enter__(self):
        self.inner = self.mod._amp_hook

        def hook(name, arrays):
            out = self.inner(name, arrays)
            if len(arrays) == 1 and arrays[0].shape == (0,):
                return out
            self.log.append((name, tuple(_name(a.dtype) for a in out)))
            return out

        self.mod._amp_hook = hook
        return self

    def __exit__(self, *exc):
        self.mod._amp_hook = self.inner


def _run_both(fn, *arrays, **cast_kw):
    """``fn(pkg, *tensors)`` in both packages under ``auto_cast(**cast_kw)``
    -> (jax out, port out, jax record, port record)."""
    outs, logs = [], []
    for pkg, mod in ((jp, jdispatch), (tp, tdispatch)):
        ts = [pkg.to_tensor(a) for a in arrays]
        with _Recorder(mod) as rec, pkg.amp.auto_cast(**cast_kw):
            out = fn(pkg, *ts)
        outs.append(out)
        logs.append(rec.log)
    return outs[0], outs[1], logs[0], logs[1]


_rng = np.random.RandomState(0)
X = _rng.randn(4, 8).astype(np.float32)
W = _rng.randn(8, 8).astype(np.float32) * 0.3
BIAS = _rng.randn(8).astype(np.float32)
LAB = _rng.randint(0, 8, (4,)).astype(np.int64)
Q = _rng.randn(2, 8, 2, 8).astype(np.float32)
MASK = np.where(_rng.rand(2, 1, 8, 8) > 0.2, 0.0, -1e9).astype(np.float32)

OPS = {
    "linear": (lambda pkg, x, w, b: pkg.nn.functional.linear(x, w, b),
               (X, W, BIAS)),
    "matmul": (lambda pkg, x, w: pkg.matmul(x, w), (X, W)),
    "softmax_of_bf16": (lambda pkg, x: pkg.nn.functional.softmax(
        x.astype("bfloat16")), (X,)),
    "layer_norm_of_bf16": (lambda pkg, x, w, b: pkg.nn.functional.layer_norm(
        x.astype("bfloat16"), 8, w, b), (X, BIAS, BIAS)),
    "cross_entropy": (lambda pkg, x, y: pkg.nn.functional.cross_entropy(
        pkg.nn.functional.linear(x, pkg.to_tensor(W)), y), (X, LAB)),
    "gelu_of_linear": (lambda pkg, x, w: pkg.nn.functional.gelu(
        pkg.nn.functional.linear(x, w), approximate=True), (X, W)),
    "residual_add": (lambda pkg, x, w: x + pkg.nn.functional.linear(x, w),
                     (X, W)),
    "tanh_exp_mean": (lambda pkg, x: pkg.exp(pkg.nn.functional.tanh(
        x.astype("bfloat16"))).mean(), (X,)),
    "sdpa_masked": (lambda pkg, q, m: pkg.nn.functional.
                    scaled_dot_product_attention(q, q, q, attn_mask=m),
                    (Q, MASK)),
    "dropout_eval": (lambda pkg, x, w: pkg.nn.functional.dropout(
        pkg.nn.functional.linear(x, w), 0.1, training=False), (X, W)),
    # the tensor ops' white list: bmm, mv, addmm, mm (matmul) and einsum
    "white_products": (lambda pkg, x, w: pkg.bmm(
        pkg.unsqueeze(x, 0), pkg.unsqueeze(w, 0))[0] + pkg.addmm(
        x, x, w, 0.5, 2.0) + pkg.mm(x, w) + pkg.einsum("ij,jk->ik", x, w)
        + pkg.unsqueeze(pkg.mv(x, w[0]), 1), (X, W)),
    # and its black list: the logs and special functions, ...
    "black_logs": (lambda pkg, x: pkg.log2(pkg.abs(x) + 1) + pkg.log10(
        pkg.abs(x) + 1) + pkg.log1p(pkg.abs(x)) + pkg.erf(x) + pkg.erfinv(
        pkg.tanh(x) * 0.5), (X,)),
    # ... and the reductions
    "black_reductions": (lambda pkg, x: pkg.logsumexp(x, axis=1) + pkg.sum(
        pkg.cumsum(x, axis=1), axis=1) + pkg.sum(pkg.cumprod(
            pkg.tanh(x), dim=1), axis=1) + pkg.var(x, axis=1) + pkg.std(
        x, axis=1) + pkg.linalg.norm(x, axis=1), (X,)),
    # the nn slice: a transposed convolution (white) between the f32 norms
    "tconv_norms": (lambda pkg, x, w: pkg.nn.functional.group_norm(
        pkg.nn.functional.conv2d_transpose(pkg.nn.functional.instance_norm(
            pkg.reshape(x, [1, 2, 4, 4])), pkg.reshape(w, [2, 4, 2, 4]),
            stride=2), 2), (X, W)),
    # and its losses on the black list, over a white product
    "losses": (lambda pkg, x, w: pkg.nn.functional.mse_loss(
        pkg.nn.functional.linear(x, w), x) + pkg.nn.functional.l1_loss(
        x, w[:4]) + pkg.nn.functional.binary_cross_entropy_with_logits(
        pkg.nn.functional.linear(x, w), pkg.nn.functional.sigmoid(x))
        + pkg.nn.functional.kl_div(pkg.nn.functional.log_softmax(x),
                                   pkg.nn.functional.softmax(x))
        + pkg.nn.functional.sigmoid_focal_loss(x, pkg.nn.functional.sigmoid(
            x)), (X, W)),
}
LEVELS = [dict(level="O1"), dict(level="O2"),
          dict(level="O1", custom_white_list={"gelu"},
               custom_black_list={"linear"}),
          dict(level="O2", custom_black_list={"matmul", "add"}),
          dict(level="O1", dtype="float16"),
          dict(level="O1", enable=False), dict(level="O0")]


@pytest.mark.parametrize("cast", LEVELS, ids=lambda c: "-".join(
    f"{k}={sorted(v) if isinstance(v, set) else v}" for k, v in c.items()))
@pytest.mark.parametrize("op", sorted(OPS))
def test_op_types_match_jax_hook(op, cast):
    fn, arrays = OPS[op]
    jo, to, jlog, tlog = _run_both(fn, *arrays, **cast)
    assert tlog == jlog
    assert _name(to._data.dtype) == _name(jo.dtype)
    tol = BF16_TOL if cast.get("dtype") != "float16" else \
        dict(rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(_np(to).astype(np.float32),
                               np.asarray(_np(jo), np.float32), **tol)


def _model_pair(kind):
    jp.seed(3)
    if kind == "bert":
        kw = dict(vocab_size=128, hidden_size=64, num_hidden_layers=2,
                  num_attention_heads=4, intermediate_size=128,
                  max_position_embeddings=32)
        jm = jmodels.BertForQuestionAnswering(jmodels.BertConfig(**kw))
        tm = tmodels.BertForQuestionAnswering(tmodels.BertConfig(**kw))
    else:
        kw = dict(vocab_size=128, hidden_size=64, num_hidden_layers=2,
                  num_attention_heads=4, max_position_embeddings=32,
                  tensor_parallel=False)
        jm = jmodels.GPTForCausalLM(jmodels.GPTConfig(**kw))
        tm = tmodels.GPTForCausalLM(tmodels.GPTConfig(**kw))
    layer_state_from_jax(tm, jm.state_dict())
    jm.eval()
    tm.eval()
    return jm, tm


@pytest.mark.parametrize("kind", ["bert", "gpt"])
@pytest.mark.parametrize("level", ["O1", "O2"])
def test_model_forward_types_match_jax_op_by_op(kind, level):
    """A whole BERT (with its padding mask) or GPT forward under auto_cast:
    every dispatched op gets the same input types in both packages (the
    residual stream turns f32 after each LayerNorm, as JAX's does)."""
    jm, tm = _model_pair(kind)
    ids = np.random.RandomState(1).randint(0, 128, (B, L))
    mask = np.ones((B, L), np.int64)
    mask[1, 12:] = 0
    outs, logs = [], []
    for pkg, mod, m in ((jp, jdispatch, jm), (tp, tdispatch, tm)):
        args = [pkg.to_tensor(ids)]
        kw = {"attn_mask": pkg.to_tensor(mask)} if kind == "bert" else {}
        with _Recorder(mod) as rec, pkg.amp.auto_cast(level=level):
            out = m(*args, **kw)
        outs.append(out[0] if isinstance(out, tuple) else out)
        logs.append(rec.log)
    names = {n for n, _ in logs[0]}
    assert {"linear", "layer_norm", "gelu"} <= names
    assert logs[1] == logs[0]
    assert _name(outs[1]._data.dtype) == _name(outs[0].dtype)
    np.testing.assert_allclose(_np(outs[1]).astype(np.float32),
                               np.asarray(_np(outs[0]), np.float32),
                               rtol=5e-2, atol=5e-2)


def test_auto_cast_state_is_per_thread():
    seen = {}

    def other():
        x = tp.to_tensor(X)
        seen["enabled"] = tp.amp.is_auto_cast_enabled()
        seen["dtype"] = tp.nn.functional.linear(x, tp.to_tensor(W)).dtype

    with tp.amp.auto_cast(level="O1"):
        assert tp.amp.is_auto_cast_enabled()
        th = threading.Thread(target=other)
        th.start()
        th.join()
        inside = tp.nn.functional.linear(tp.to_tensor(X), tp.to_tensor(W))
    assert seen == {"enabled": False, "dtype": tp.float32}
    assert inside.dtype == tp.bfloat16
    assert not tp.amp.is_auto_cast_enabled()
    with pytest.raises(ValueError):
        tp.amp.auto_cast(level="O3")
    with pytest.raises(ValueError):
        tp.amp.auto_cast(dtype="int8")
    assert tp.amp.white_list()["bfloat16"] == jp.amp.white_list()["bfloat16"]
    assert tp.amp.black_list()["float16"] == jp.amp.black_list()["float16"]


def test_the_o1_cast_sends_f32_attention_to_the_flash_route():
    """F.sdpa_route decides on the type the hook will give q: under O1 an
    f32 q is bf16 by the time ``flash_attention`` runs, so a CUDA q takes
    the flash kernels, not ``sdpa_plain``."""
    F = tp.nn.functional
    q = torch.zeros((2, 64, 2, 64))
    assert F.sdpa_route(q, q) == "flash"

    class _Q:              # what the route reads of an f32 CUDA q
        shape, device, dtype = q.shape, torch.device("cuda"), torch.float32

    assert F.sdpa_route(_Q, _Q) == "plain"
    with tp.amp.auto_cast(level="O1"):
        dt = tdispatch.amp_cast_dtype("flash_attention", torch.float32)
        assert dt == torch.bfloat16
        assert F.sdpa_route(_Q, _Q, dtype=dt) == "flash"
    with tp.amp.auto_cast(level="O1", custom_black_list={"flash_attention"}):
        assert tdispatch.amp_cast_dtype("flash_attention",
                                        torch.float32) == torch.float32
    assert tdispatch.amp_cast_dtype("flash_attention",
                                    torch.float32) == torch.float32


def test_decorate_o2_matches_jax():
    jm, tm = _model_pair("bert")
    for pkg, m in ((jp, jm), (tp, tm)):
        opt = pkg.optimizer.AdamW(parameters=m.parameters())
        excl = m.qa_outputs
        m2, opt2 = pkg.amp.decorate(m, opt, level="O2",
                                    excluded_layers=[excl])
        assert m2 is m and opt2 is opt and opt._multi_precision
    jt = {n: _name(p.dtype) for n, p in jm.named_parameters()}
    tt = {n: _name(p.dtype) for n, p in tm.named_parameters()}
    assert tt == jt
    assert tt["bert.embeddings.layer_norm.weight"] == "float32"
    assert tt["qa_outputs.weight"] == "float32"
    assert tt["bert.encoder.0.fc1.weight"] == "bfloat16"
    for p in tm.parameters():
        assert not p.stop_gradient and p._data.is_leaf
    # O1 decorates nothing
    jm1, tm1 = _model_pair("gpt")
    assert tp.amp.decorate(tm1, level="O1") is tm1
    assert all(p.dtype == tp.float32 for p in tm1.parameters())


def test_grad_scaler_trajectory_matches_jax():
    """Scale, unscale, inf skip and update against JAX step by step, with
    ``incr_every_n_steps=2`` and infs on steps 2 and 5."""
    w0 = np.random.RandomState(2).randn(5).astype(np.float32)
    x = np.random.RandomState(3).randn(5).astype(np.float32)
    hist = {}
    for pkg in (jp, tp):
        w = pkg.to_tensor(w0, stop_gradient=False)
        opt = pkg.optimizer.SGD(learning_rate=0.1, parameters=[w])
        sc = pkg.amp.GradScaler(init_loss_scaling=2.0 ** 4,
                                incr_every_n_steps=2,
                                decr_every_n_nan_or_inf=1)
        rows = []
        for i in range(7):
            xi = x.copy()
            if i in (2, 5):
                xi[1] = np.inf
            loss = (w * pkg.to_tensor(xi)).sum()
            scaled = sc.scale(loss)
            scaled.backward()
            sc.unscale_(opt)
            found = sc._found_inf
            sc.step(opt)
            sc.update()
            opt.clear_grad()
            st = sc.state_dict()
            rows.append((found, st["scale"], st["good_steps"],
                         st["bad_steps"], _np(w).copy()))
        hist[pkg.__name__] = rows
    for (jf, js, jg, jb, jw), (tf, ts, tg, tb, tw) in zip(
            hist["paddle_tpu"], hist["paddle_tpu_torch"]):
        assert (tf, ts, tg, tb) == (jf, js, jg, jb)
        np.testing.assert_allclose(tw, jw, rtol=1e-6, atol=1e-6)
    assert [r[0] for r in hist["paddle_tpu_torch"]] == \
        [False, False, True, False, False, True, False]
    sc = tp.amp.GradScaler(init_loss_scaling=8.0)
    sc.load_state_dict({"scale": 32.0, "good_steps": 1})
    assert sc.get_loss_scaling().item() == 32.0
    assert not tp.amp.GradScaler(enable=False).is_enable()


def test_grad_scaler_unscale_reads_the_host_once(monkeypatch):
    """One host read however many parameters (JAX's fused check)."""
    ws = [tp.to_tensor(np.ones(3, np.float32), stop_gradient=False)
          for _ in range(5)]
    opt = tp.optimizer.SGD(learning_rate=0.1, parameters=ws)
    sc = tp.amp.GradScaler(init_loss_scaling=4.0)
    sum(w.sum() for w in ws).backward()
    reads = []
    real = torch.Tensor.__bool__
    monkeypatch.setattr(torch.Tensor, "__bool__",
                        lambda t: reads.append(1) or real(t))
    sc.unscale_(opt)
    monkeypatch.undo()
    assert len(reads) == 1 and not sc._found_inf
    np.testing.assert_array_equal(_np(ws[0].grad), np.full(3, 0.25))


def test_support_queries():
    assert tp.amp.is_bfloat16_supported("cpu")
    assert tp.amp.is_float16_supported()
