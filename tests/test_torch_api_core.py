"""The port's Paddle dygraph core held against paddle_tpu: tensors and the
tensor ops, autograd, the initializers, ``nn.Layer``, the functional ops
and the optimizers.

Each case runs the same code against both packages (``import paddle_tpu``
and ``import paddle_tpu_torch``) on the same numpy inputs and compares the
numbers: exactly for creation, shapes, indices and autograd on small
integers; 1e-6 relative (f32, the same arithmetic in another order) for
the elementwise and reduction ops, the functional ops and three optimizer
steps; 1e-5 for attention (the JAX side runs its Pallas flash kernel in
interpret mode, a blockwise softmax).  Random draws differ between the
frameworks by construction, so the initializers are held by their
statistics.  The port runs on the CPU here (``set_device("cpu")``): its
kernel wrappers take their plain versions.
"""

import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import paddle_tpu as jp  # noqa: E402
import paddle_tpu_torch as tp  # noqa: E402
from paddle_tpu_torch.framework import place as tplace  # noqa: E402
from paddle_tpu_torch.nn import functional as TF  # noqa: E402

TOL = dict(rtol=1e-6, atol=1e-6)
PKGS = [jp, tp]


@pytest.fixture(autouse=True)
def _cpu():
    prev = tplace._current_place
    tp.set_device("cpu")
    yield
    tplace._current_place = prev


def _np(t):
    return np.asarray(t.numpy())


def _both(fn):
    """``fn(pkg)`` for both packages, as numpy (or tuples of numpy)."""
    def conv(x):
        if isinstance(x, (list, tuple)):
            return [conv(v) for v in x]
        return _np(x) if hasattr(x, "numpy") else x
    return conv(fn(jp)), conv(fn(tp))


def _close(a, b, **tol):
    if isinstance(a, list):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _close(x, y, **tol)
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    np.testing.assert_allclose(b, a, **(tol or TOL))


# ---------------------------------------------------------------------------
# tensors, creation and the tensor ops
# ---------------------------------------------------------------------------
def test_default_place_is_the_card_and_raises_without_one(monkeypatch):
    monkeypatch.setattr(tplace, "_current_place", tplace.CUDAPlace(0))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tp.to_tensor([1.0])
        with pytest.raises(RuntimeError):
            tp.set_device("gpu")
    assert tp.get_device() == "gpu:0"


@pytest.mark.parametrize("data, dtype", [
    ([1.0, 2.0], None), ([1, 2], None), (3, None), (2.5, None),
    (True, None), (np.arange(4.0), None), ([[1, 2], [3, 4]], "float32"),
    (np.arange(6, dtype=np.int32).reshape(2, 3), None)])
def test_to_tensor_dtype_rules(data, dtype):
    j = jp.to_tensor(data, dtype=dtype)
    t = tp.to_tensor(data, dtype=dtype)
    assert t.dtype.name == j.dtype.name and t.shape == j.shape
    np.testing.assert_array_equal(_np(t), _np(j))
    assert t.stop_gradient and t.place == tp.CPUPlace()


def test_as_tensor_rules_match_jax():
    from paddle_tpu.ops.dispatch import as_tensor as jas
    from paddle_tpu_torch.ops.dispatch import as_tensor as tas
    for x in (np.arange(3.0), 2, 1.5, True, np.arange(3, dtype=np.int32)):
        assert tas(x).dtype.name == jas(x).dtype.name
        np.testing.assert_array_equal(_np(tas(x)), _np(jas(x)))


@pytest.mark.parametrize("case", [
    lambda p: p.zeros([2, 3]), lambda p: p.ones([3], dtype="int32"),
    lambda p: p.full([2, 2], 7), lambda p: p.full([2], True),
    lambda p: p.arange(5), lambda p: p.arange(1.0, 2.0, 0.25),
    lambda p: p.arange(2, 11, 3, dtype="int32"),
    lambda p: p.zeros_like(p.ones([2, 2]), dtype="float32")],
    ids=["zeros", "ones", "full", "full_bool", "arange", "arange_f",
         "arange_i32", "zeros_like"])
def test_creation_values(case):
    j, t = case(jp), case(tp)
    assert t.dtype.name == j.dtype.name
    np.testing.assert_array_equal(_np(t), _np(j))


X = np.random.RandomState(0).randn(2, 3, 4).astype(np.float32)


@pytest.mark.parametrize("case", [
    lambda p, x: p.reshape(x, [4, 6]),
    lambda p, x: p.reshape(x, [-1, 4]),
    lambda p, x: p.transpose(x, [2, 0, 1]),
    lambda p, x: x.T,
    lambda p, x: p.concat([x, x * 2], axis=1),
    lambda p, x: p.split(x, 2, axis=2),
    lambda p, x: p.split(x, [1, -1], axis=1),
    lambda p, x: p.unsqueeze(x, [0, 2]),
    lambda p, x: p.squeeze(p.unsqueeze(x, 1), axis=1),
    lambda p, x: p.repeat_interleave(x, 2, axis=1),
    lambda p, x: p.flatten(x, 1),
    lambda p, x: x[1],
    lambda p, x: x[:, 1:, ::2],
    lambda p, x: x[..., -1],
    lambda p, x: x[x > 0],
    lambda p, x: x.astype("int32"),
], ids=["reshape", "reshape_m1", "transpose", "T", "concat", "split",
        "split_m1", "unsqueeze", "squeeze", "repeat_interleave", "flatten",
        "index", "slices", "ellipsis", "bool_mask", "astype"])
def test_manipulation_values(case):
    j, t = _both(lambda p: case(p, p.to_tensor(X)))
    _close(j, t, rtol=0, atol=0)


def test_out_of_range_index_raises():
    with pytest.raises(IndexError):
        tp.to_tensor(X)[5]


@pytest.mark.parametrize("case", [
    lambda p, x, y: x + y, lambda p, x, y: x - 1.5, lambda p, x, y: 2 - x,
    lambda p, x, y: x * y, lambda p, x, y: 3 * x, lambda p, x, y: x / y,
    lambda p, x, y: 1 / y, lambda p, x, y: x ** 2, lambda p, x, y: -x,
    lambda p, x, y: p.pow(y, 3), lambda p, x, y: p.exp(x),
    lambda p, x, y: p.log(y), lambda p, x, y: p.sqrt(y),
    lambda p, x, y: p.sum(x), lambda p, x, y: p.sum(x, axis=[0, 2]),
    lambda p, x, y: x.sum(axis=1, keepdim=True),
    lambda p, x, y: p.mean(x), lambda p, x, y: p.mean(x, axis=-1),
    lambda p, x, y: p.max(x, axis=1), lambda p, x, y: p.maximum(x, y),
    lambda p, x, y: p.matmul(x, p.transpose(y, [0, 2, 1])),
    lambda p, x, y: p.matmul(x, y, transpose_y=True),
    lambda p, x, y: p.matmul(x, y, transpose_x=True),
    lambda p, x, y: x @ p.transpose(y, [0, 2, 1]),
    lambda p, x, y: p.argmax(x, axis=-1), lambda p, x, y: p.argmax(x),
    lambda p, x, y: p.topk(x, 2, axis=-1),
    lambda p, x, y: (x > y, x == x, x <= 0),
], ids=["add", "sub_scalar", "rsub", "mul", "rmul", "div", "rdiv", "pow2",
        "neg", "pow3", "exp", "log", "sqrt", "sum", "sum_axes",
        "sum_keepdim", "mean", "mean_axis", "max", "maximum", "matmul",
        "matmul_ty", "matmul_tx", "matmul_op", "argmax_axis", "argmax",
        "topk", "compare"])
def test_math_values(case):
    y = np.abs(np.random.RandomState(1).randn(2, 3, 4)).astype(np.float32) \
        + 0.5

    def run(p):
        out = case(p, p.to_tensor(X), p.to_tensor(y))
        return list(out) if isinstance(out, tuple) else out
    j, t = _both(run)
    _close(j, t)


def test_top_p_sampling_keeps_the_nucleus():
    logits = np.log(np.array([[0.5, 0.3, 0.15, 0.05]] * 4000, np.float32))
    scores, ids = tp.top_p_sampling(tp.to_tensor(logits),
                                    tp.full([4000], 0.7))
    ids = _np(ids)[:, 0]
    assert ids.shape == (4000,) and set(ids.tolist()) <= {0, 1}
    # within the nucleus {0, 1} the picks follow 0.5 : 0.3
    assert abs((ids == 0).mean() - 0.625) < 0.03
    np.testing.assert_allclose(_np(scores)[:, 0],
                               np.where(ids == 0, 0.625, 0.375), rtol=1e-5)


# ---------------------------------------------------------------------------
# autograd (the cases of tests/test_autograd.py:10-83, and the probes)
# ---------------------------------------------------------------------------
def _grad_cases(p):
    out = {}
    x = p.to_tensor([1.0, 2.0, 3.0], stop_gradient=False)
    (x * x).sum().backward()
    out["simple"] = x.grad
    x = p.to_tensor(2.0, stop_gradient=False)
    a = x * 3
    (a + a * a).backward()
    out["fanout"] = x.grad
    x = p.to_tensor(1.0, stop_gradient=False)
    (x * 2).backward()
    (x * 3).backward()
    out["accumulate"] = x.grad
    x.clear_grad()
    out["cleared"] = x.grad is None
    x = p.to_tensor([1.0], stop_gradient=False)
    y = p.to_tensor([2.0], stop_gradient=True)
    (x * y).sum().backward()
    out["stop"] = (x.grad, y.grad is None)
    x = p.to_tensor([3.0], stop_gradient=False)
    d = (x * 2).detach()
    (d * x).sum().backward()
    out["detach"] = (x.grad, d.stop_gradient)
    x = p.to_tensor([1.0], stop_gradient=False)
    with p.no_grad():
        y = x * 5
    out["no_grad"] = (y.stop_gradient, y._grad_node is None)
    x = p.to_tensor(2.0, stop_gradient=False)
    y = x * x
    y.backward(retain_graph=True)
    y.backward()
    out["retain"] = x.grad
    x = p.to_tensor([1.0, 2.0], stop_gradient=False)
    (x * 3).backward(p.to_tensor([1.0, 10.0]))
    out["grad_tensor"] = x.grad
    x = p.to_tensor([1.0, 2.0], stop_gradient=False)
    (g,) = p.grad((x ** 3).sum(), x)
    out["paddle_grad"] = (g, x.grad is None)
    x = p.to_tensor([1.0], stop_gradient=False)
    h = x.register_hook(lambda g: g * 2)
    (x * 3).sum().backward()
    out["hook"] = x.grad
    h.remove()
    x.clear_grad()
    (x * 3).sum().backward()
    out["hook_removed"] = x.grad
    with p.set_grad_enabled(False):
        out["grad_disabled"] = not p.is_grad_enabled()
    x = p.to_tensor([0.5, 1.5], stop_gradient=False)
    with p.no_grad():
        with p.enable_grad():
            z = (p.exp(x) * p.log(x + 1)).mean()
    z.backward()
    out["enable_grad"] = x.grad
    return out


def test_autograd_cases_match_jax():
    j, t = _grad_cases(jp), _grad_cases(tp)
    assert j.keys() == t.keys()
    for k in j:
        a = j[k] if isinstance(j[k], tuple) else (j[k],)
        b = t[k] if isinstance(t[k], tuple) else (t[k],)
        for u, v in zip(a, b):
            if isinstance(u, bool):
                assert u == v, k
            else:
                np.testing.assert_allclose(_np(v), _np(u), err_msg=k, **TOL)


@pytest.mark.parametrize("pkg", PKGS, ids=["jax", "torch"])
@pytest.mark.parametrize("graph", [
    lambda p, x: x * x, lambda p, x: x + 1, lambda p, x: (x * 2).sum(),
    lambda p, x: p.mean(p.exp(x))], ids=["mul", "add", "scale", "exp"])
def test_second_backward_without_retain_graph_raises(pkg, graph):
    x = pkg.to_tensor(2.0, stop_gradient=False)
    y = graph(pkg, x)
    y.backward()
    with pytest.raises(RuntimeError):
        y.backward()
    with pytest.raises(RuntimeError):
        pkg.grad(y, x)


@pytest.mark.parametrize("pkg", PKGS, ids=["jax", "torch"])
def test_autograd_probes(pkg):
    x = pkg.to_tensor([1.0, 2.0], stop_gradient=False)
    with pytest.raises(RuntimeError):
        (x * 3).backward()
    u = pkg.to_tensor([1.0], stop_gradient=False)
    y = (x * x).sum()
    with pytest.raises(RuntimeError):
        pkg.grad(y, [x, u], retain_graph=True)
    g, none = pkg.grad(y, [x, u], allow_unused=True)
    assert none is None
    np.testing.assert_allclose(_np(g), [2.0, 4.0])
    assert x.grad is None


@pytest.mark.parametrize("level, raises", [(0, True), (1, False)])
def test_check_nan_inf(level, raises):
    for p in PKGS:
        p.set_flags({"FLAGS_check_nan_inf": True,
                     "FLAGS_check_nan_inf_level": level})
        try:
            if raises:
                with pytest.raises(FloatingPointError):
                    p.log(p.to_tensor(-1.0))
            else:
                with pytest.warns(UserWarning, match="NaN/Inf"):
                    p.log(p.to_tensor(-1.0))
        finally:
            p.set_flags({"FLAGS_check_nan_inf": False,
                         "FLAGS_check_nan_inf_level": 0})


def test_double_grad_is_not_ported_yet():
    x = tp.to_tensor(3.0, stop_gradient=False)
    with pytest.raises(NotImplementedError, match="item 10"):
        tp.grad(x ** 4, x, create_graph=True)


def test_verify_drive_converges():
    """The verify recipe's least-squares loop, on the port."""
    rs = np.random.RandomState(0)
    X = tp.to_tensor(rs.randn(64, 3).astype("float32"))
    y = tp.matmul(X, tp.to_tensor([[1.5], [-2.], [.7]]))
    w = tp.zeros([3, 1])
    w.stop_gradient = False
    for _ in range(200):
        loss = ((tp.matmul(X, w) - y) ** 2).mean()
        loss.backward()
        with tp.no_grad():
            w._data = (w - 0.1 * w.grad)._data
        w.clear_grad()
        w.detach_()
        w.stop_gradient = False
    assert float(loss) < 1e-3


# ---------------------------------------------------------------------------
# initializers (by statistics) and Layer
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_initializers_by_statistics(dtype):
    from paddle_tpu_torch.nn import initializer as I
    tp.seed(3)
    dev = torch.device("cpu")
    fi, fo = 256, 512
    lim = np.sqrt(6.0 / (fi + fo))
    w = I.XavierUniform()([fi, fo], dtype, dev).float().numpy()
    assert w.dtype == np.float32 and np.abs(w).max() <= lim * 1.01
    assert abs(w.std() - lim / np.sqrt(3)) < 0.02 * lim
    assert abs(w.mean()) < 0.01 * lim
    n = I.Normal(0.5, 2.0)([200, 200], dtype, dev).float().numpy()
    assert abs(n.mean() - 0.5) < 0.05 and abs(n.std() - 2.0) < 0.05
    xn = I.XavierNormal()([fi, fo], dtype, dev).float().numpy()
    assert abs(xn.std() - np.sqrt(2.0 / (fi + fo))) < 0.03 * xn.std()
    u = I.Uniform(-3.0, 1.0)([100, 100], dtype, dev).float().numpy()
    assert u.min() >= -3.0 and u.max() <= 1.0 and abs(u.mean() + 1) < 0.05
    c = I.Constant(0.25)([3, 4], dtype, dev).float().numpy()
    assert (c == 0.25).all()
    # the framework's generator: paddle.seed makes the draws repeat
    tp.seed(3)
    again = I.XavierUniform()([fi, fo], dtype, dev).float().numpy()
    np.testing.assert_array_equal(again, w)


def _small_model(p):
    class Net(p.nn.Layer):
        def __init__(self):
            super().__init__()
            self.fc = p.nn.Linear(4, 8)
            self.blocks = p.nn.LayerList(
                [p.nn.Linear(8, 8, bias_attr=False) for _ in range(2)])
            self.norm = p.nn.RMSNorm(8)
            self.emb = p.nn.Embedding(10, 4, padding_idx=0)
            self.act = p.nn.Silu()
            self.extra = p.nn.ParameterList(
                [self.create_parameter([3], is_bias=True)])

        def forward(self, ids):
            x = self.act(self.fc(self.emb(ids)))
            for b in self.blocks:
                x = x + b(x)
            return self.norm(x)
    return Net()


def test_layer_state_dict_names_and_loading_from_jax():
    from paddle_tpu_torch.models.weights import layer_state_from_jax
    jp.seed(0)
    jm, tm = _small_model(jp), _small_model(tp)
    assert list(tm.state_dict()) == list(jm.state_dict())
    assert [p.shape for p in tm.parameters()] == \
        [p.shape for p in jm.parameters()]
    assert all(not p.stop_gradient for p in tm.parameters())
    layer_state_from_jax(tm, jm.state_dict())
    ids = np.array([[0, 3, 9], [1, 2, 0]])
    _close(_np(jm(jp.to_tensor(ids))), _np(tm(tp.to_tensor(ids))))
    # the padding row is zero on both sides
    assert (_np(tm.emb.weight)[0] == 0).all()
    # round trip through the port's own state_dict, and bf16
    tm2 = _small_model(tp)
    missing, unexpected = tm2.set_state_dict(tm.state_dict())
    assert not missing and not unexpected
    _close(_np(tm2(tp.to_tensor(ids))), _np(tm(tp.to_tensor(ids))))
    tm2.bfloat16()
    assert all(p.dtype == tp.bfloat16 and not p.stop_gradient and p.is_leaf
               for p in tm2.parameters())
    with pytest.raises(ValueError, match="shape mismatch"):
        tm2.set_state_dict({"fc.weight": np.zeros((2, 2), np.float32)})


def test_layer_modes_hooks_and_clear_gradients():
    m = _small_model(tp)
    assert m.training and all(s.training for s in m.sublayers())
    m.eval()
    assert not m.training and not any(s.training for s in m.sublayers())
    m.train()
    seen = []
    h1 = m.fc.register_forward_pre_hook(lambda layer, inp: seen.append("pre"))
    h2 = m.fc.register_forward_post_hook(
        lambda layer, inp, out: out * 0.0)
    out = m(tp.to_tensor(np.array([[1, 2]])))
    assert seen == ["pre"]
    h1.remove()
    h2.remove()
    out.sum().backward()
    assert all(p.grad is not None for p in m.fc.parameters())
    m.clear_gradients()
    assert all(p.grad is None for p in m.parameters())
    assert len(m.blocks) == 2 and len(m.extra) == 1
    assert isinstance(m.blocks[-1], tp.nn.Linear)
    seq = tp.nn.Sequential(tp.nn.Linear(2, 3), tp.nn.Silu())
    assert list(seq.state_dict()) == ["0.weight", "0.bias"]
    assert seq(tp.ones([1, 2])).shape == [1, 3]


# ---------------------------------------------------------------------------
# functional ops
# ---------------------------------------------------------------------------
R = np.random.RandomState(2)
LOGITS = R.randn(6, 5).astype(np.float32)
LABELS = np.array([0, 4, -100, 2, 2, 1])
ATT = [R.randn(2, 16, 4, 8).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("case", [
    lambda p, F: F.linear(p.to_tensor(LOGITS), p.to_tensor(LOGITS.T),
                          p.to_tensor(LOGITS[:, 0])),
    lambda p, F: F.embedding(p.to_tensor(np.array([[1, 0], [5, 2]])),
                             p.to_tensor(LOGITS), padding_idx=0),
    lambda p, F: F.silu(p.to_tensor(LOGITS)),
    lambda p, F: F.softmax(p.to_tensor(LOGITS), axis=0),
    lambda p, F: F.log_softmax(p.to_tensor(LOGITS)),
    lambda p, F: F.cross_entropy(p.to_tensor(LOGITS), p.to_tensor(LABELS)),
    lambda p, F: F.cross_entropy(p.to_tensor(LOGITS),
                                 p.to_tensor(LABELS[:, None]),
                                 reduction="none"),
    lambda p, F: F.cross_entropy(p.to_tensor(LOGITS),
                                 p.to_tensor(np.abs(LABELS) % 5),
                                 weight=p.to_tensor(np.arange(1, 6.0))),
    lambda p, F: F.cross_entropy(p.to_tensor(LOGITS), p.to_tensor(LABELS),
                                 label_smoothing=0.1, reduction="sum"),
    lambda p, F: F.cross_entropy(p.to_tensor(LOGITS),
                                 F.softmax(p.to_tensor(LOGITS * 2)),
                                 soft_label=True),
    lambda p, F: p.nn.CrossEntropyLoss()(p.to_tensor(LOGITS),
                                         p.to_tensor(LABELS)),
    lambda p, F: F.rms_norm(p.to_tensor(ATT[0]), p.to_tensor(ATT[1][0, 0, 0]),
                            epsilon=1e-5),
    lambda p, F: F.rms_norm(p.to_tensor(ATT[0])),
], ids=["linear", "embedding", "silu", "softmax", "log_softmax", "ce",
        "ce_none", "ce_weight", "ce_smooth", "ce_soft", "ce_layer",
        "rms_norm", "rms_norm_no_w"])
def test_functional_values(case):
    from paddle_tpu.nn import functional as JF
    j, t = case(jp, JF), case(tp, TF)
    _close(_np(j), _np(t))


def test_weighted_cross_entropy_skips_ignored_labels():
    """JAX's ``jnp.take`` of the class weights at ``ignore_index`` reads
    out of range and gives NaN; the port masks the ignored rows out of
    the weighted sum and of its weight total."""
    w = np.arange(1, 6.0)
    got = float(TF.cross_entropy(tp.to_tensor(LOGITS), tp.to_tensor(LABELS),
                                 weight=tp.to_tensor(w)))
    logp = LOGITS - np.log(np.exp(LOGITS).sum(-1, keepdims=True))
    keep = LABELS != -100
    lab = LABELS[keep]
    want = -(w[lab] * logp[keep, lab]).sum() / w[lab].sum()
    np.testing.assert_allclose(got, want, rtol=1e-6)


def _sdpa(p, F, causal, kv_len=16, mask=False, grad=False):
    q = p.to_tensor(ATT[0], stop_gradient=not grad)
    k = p.to_tensor(ATT[1][:, :kv_len], stop_gradient=not grad)
    v = p.to_tensor(ATT[2][:, :kv_len], stop_gradient=not grad)
    if kv_len != 16:
        q = q[:, -1:]
    m = p.to_tensor(np.tril(np.ones((16, 16), bool))) if mask else None
    out = F.scaled_dot_product_attention(q, k, v, attn_mask=m,
                                         is_causal=causal)
    if not grad:
        return [out]
    (out * out).sum().backward()
    return [out, q.grad, k.grad, v.grad]


@pytest.mark.parametrize("kw", [
    dict(causal=True), dict(causal=False), dict(causal=False, kv_len=9),
    dict(causal=True, kv_len=12), dict(causal=False, mask=True),
    dict(causal=True, grad=True)],
    ids=["causal", "full", "decode", "decode_causal", "mask", "grads"])
def test_sdpa_matches_jax(kw):
    from paddle_tpu.nn import functional as JF
    j, t = _sdpa(jp, JF, **kw), _sdpa(tp, TF, **kw)
    _close([_np(x) for x in j], [_np(x) for x in t], rtol=1e-5, atol=1e-5)


def test_sdpa_route_rules():
    def fake(shape, dtype=torch.bfloat16, dev="cuda"):
        return types.SimpleNamespace(shape=shape, dtype=dtype,
                                     device=torch.device(dev))
    q = fake((2, 256, 8, 128))
    assert TF.sdpa_route(q, q) == "flash"
    assert TF.sdpa_route(fake((2, 256, 8, 64)), fake((2, 256, 8, 64))) == \
        "flash"
    # f32 / head_dim 80 on the card: the kernels take neither
    assert TF.sdpa_route(fake((2, 256, 8, 128), torch.float32), q) == "plain"
    assert TF.sdpa_route(fake((2, 256, 8, 80)), fake((2, 256, 8, 80))) == \
        "plain"
    # JAX's shape rule: decode shapes, lengths no block >= 8 divides
    assert TF.sdpa_route(fake((2, 1, 8, 128)), q) == "plain"
    assert TF.sdpa_route(fake((2, 100, 8, 128)), fake((2, 100, 8, 128))) \
        == "plain"
    # JAX's conditions for the composite
    assert TF.sdpa_route(q, q, attn_mask=object()) == "composite"
    assert TF.sdpa_route(q, q, dropout_p=0.1) == "composite"
    cpu = fake((2, 16, 4, 8), torch.float32, "cpu")
    assert TF.sdpa_route(cpu, cpu) == "flash"
    tp.set_flags({"FLAGS_pallas_flash_attention": False})
    try:
        assert TF.sdpa_route(q, q) == "composite"
    finally:
        tp.set_flags({"FLAGS_pallas_flash_attention": True})
    # attention dropout (ported since): the composite, then the output
    # dropped as JAX drops it, each element 0 or 1 / (1 - p) of the
    # dropout-free output
    args = [tp.to_tensor(a) for a in ATT[:3]]
    ref = TF.scaled_dot_product_attention(*args).numpy()
    out = TF.scaled_dot_product_attention(*args, dropout_p=0.5).numpy()
    kept = out != 0
    assert kept.any() and not kept.all()
    np.testing.assert_allclose(out[kept], 2 * ref[kept], rtol=1e-5,
                               atol=1e-6)


@pytest.fixture
def flags_restored():
    names = ["FLAGS_pallas_rope", "FLAGS_pallas_swiglu"]
    saved = (jp.get_flags(names), tp.get_flags(names))
    yield
    jp.set_flags(saved[0])
    tp.set_flags(saved[1])


@pytest.mark.parametrize("d, pos, flag", [
    (8, None, True), (128, None, True), (128, None, False),
    (128, "ids", True), (8, "ids", True)],
    ids=["d8", "d128_kernel", "d128_flag_off", "d128_position_ids",
         "d8_position_ids"])
def test_fused_rope_matches_jax(d, pos, flag, flags_restored):
    from paddle_tpu.incubate.nn import functional as JI
    from paddle_tpu_torch.incubate.nn import functional as TI
    rs = np.random.RandomState(d)
    q = rs.randn(2, 6, 2, d).astype(np.float32)
    k = rs.randn(2, 6, 1, d).astype(np.float32)
    ids = np.arange(5, 11) if pos else None

    def run(p, I):
        p.set_flags({"FLAGS_pallas_rope": flag})
        qt = p.to_tensor(q, stop_gradient=False)
        kt = p.to_tensor(k, stop_gradient=False)
        oq, ok, ov = I.fused_rotary_position_embedding(
            qt, kt, position_ids=ids, rotary_emb_base=10000)
        assert ov is None
        ((oq * oq).sum() + (ok * 3.0).sum()).backward()
        return [_np(oq), _np(ok), _np(qt.grad), _np(kt.grad)]
    _close(run(jp, JI), run(tp, TI), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("flag", [False, True])
@pytest.mark.parametrize("split", [False, True])
def test_swiglu_and_fused_rms_norm_match_jax(flag, split, flags_restored):
    from paddle_tpu.incubate.nn import functional as JI
    from paddle_tpu_torch.incubate.nn import functional as TI
    a = np.random.RandomState(5).randn(3, 8).astype(np.float32)

    def run(p, I):
        p.set_flags({"FLAGS_pallas_swiglu": flag})
        x = p.to_tensor(a, stop_gradient=False)
        out = I.swiglu(x) if split else I.swiglu(x[:, :4], x[:, 4:])
        (out * out).sum().backward()
        (nrm,) = I.fused_rms_norm(x, p.to_tensor(a[0]), p.to_tensor(a[1]))
        return [_np(out), _np(x.grad), _np(nrm)]
    _close(run(jp, JI), run(tp, TI), rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# optimizers
# ---------------------------------------------------------------------------
OPTS = {
    "sgd": lambda p, ps, mp: p.optimizer.SGD(0.1, parameters=ps,
                                             weight_decay=0.01,
                                             multi_precision=mp),
    "momentum": lambda p, ps, mp: p.optimizer.Momentum(
        0.05, 0.9, parameters=ps, use_nesterov=True, multi_precision=mp),
    "adam": lambda p, ps, mp: p.optimizer.Adam(0.01, parameters=ps,
                                               multi_precision=mp),
    "adamw": lambda p, ps, mp: p.optimizer.AdamW(
        0.01, parameters=ps, weight_decay=0.1, multi_precision=mp,
        apply_decay_param_fun=lambda n: not n.endswith("b")),
}


def _opt_run(p, kind, mp):
    rs = np.random.RandomState(7)
    dt = "bfloat16" if mp else "float32"
    w = p.Parameter(rs.randn(4, 3).astype(np.float32), dtype=dt, name="w")
    b = p.Parameter(rs.randn(3).astype(np.float32), dtype=dt, name="b")
    opt = OPTS[kind](p, [w, b], mp)
    losses = []
    x = p.to_tensor(rs.randn(5, 4).astype(np.float32)).astype(dt)
    for _ in range(3):
        loss = ((p.matmul(x, w) + b) ** 2).astype("float32").mean()
        loss.backward()
        losses.append(float(loss))
        opt.step()
        opt.clear_grad()
        assert w.grad is None
    out = [w, b, np.array(losses)]
    for prm in (w, b):
        st = opt._states[id(prm)]
        out += [st[k] for k in sorted(st)]
    return out


@pytest.mark.parametrize("kind", sorted(OPTS))
@pytest.mark.parametrize("mp", [False, True], ids=["f32", "bf16_master"])
def test_optimizer_steps_match_jax(kind, mp):
    def conv(x):
        if hasattr(x, "_data"):
            return np.asarray(x.numpy(), dtype=np.float32)
        if isinstance(x, torch.Tensor):
            return x.float().numpy()
        return np.asarray(x, np.float32)
    j = [conv(x) for x in _opt_run(jp, kind, mp)]
    t = [conv(x) for x in _opt_run(tp, kind, mp)]
    # bf16 params round the f32 master once a step: one bf16 ulp apart at
    # most where the masters straddle a rounding boundary
    tol = dict(rtol=2 ** -7, atol=1e-6) if mp else dict(rtol=1e-5,
                                                         atol=1e-6)
    _close(j, t, **tol)


def test_unported_optimizer_options_raise():
    w = tp.Parameter(np.ones(3, np.float32))
    with pytest.raises(NotImplementedError, match="item 10"):
        tp.optimizer.AdamW(object(), parameters=[w])
    # gradient clipping is ported since: the optimizer takes it
    opt = tp.optimizer.SGD(1.0, parameters=[w],
                           grad_clip=tp.nn.ClipGradByValue(0.5))
    (w * tp.to_tensor(np.array([3.0, -3.0, 0.1], np.float32))).sum() \
        .backward()
    opt.step()
    np.testing.assert_allclose(w.numpy(), [0.5, 1.5, 0.9], rtol=1e-6)
