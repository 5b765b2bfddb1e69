"""nn's activations on the port, functional and layer, held against
paddle_tpu's on the CPU.

Each deterministic activation runs on the same seeded input in both
packages: the values and the gradient of ``sum(out * g)`` within 1e-6
relative and absolute (f32 ``TOL``; the same formulas).  ``PReLU``'s
weight is carried across from JAX's ``state_dict()`` under its name.
``rrelu`` in training and ``gumbel_softmax`` draw from each package's own
generator, so they are held by their laws: rrelu's slopes lie in
[lower, upper] with the mean of the uniform law, gumbel_softmax's rows
are distributions (one-hot with ``hard``) whose argmax frequencies follow
softmax(x).  The ``_`` forms rebind the handle as the tensor ops' do.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import paddle_tpu as jp  # noqa: E402
import paddle_tpu_torch as tp  # noqa: E402
from paddle_tpu_torch.framework import place as tplace  # noqa: E402
from paddle_tpu_torch.models.weights import layer_state_from_jax  # noqa

TOL = dict(rtol=1e-6, atol=1e-6)
R = np.random.RandomState(5)
X = (R.randn(2, 6, 3, 3) * 3).astype(np.float32)


@pytest.fixture(autouse=True)
def _cpu():
    prev = tplace._current_place
    tp.set_device("cpu")
    yield
    tplace._current_place = prev


def _both(fn):
    out = []
    for pkg in (jp, tp):
        x = pkg.to_tensor(X, stop_gradient=False)
        y = fn(pkg, x)
        g = np.random.RandomState(9).randn(*y.shape).astype(np.float32)
        (y * pkg.to_tensor(g)).sum().backward()
        out.append((y.numpy(), y.dtype.name, x.grad.numpy()))
    (jy, jd, jg), (ty, td, tg) = out
    assert td == jd and ty.shape == jy.shape
    np.testing.assert_allclose(ty, jy, **TOL)
    np.testing.assert_allclose(tg, jg, **TOL)


FUNCTIONAL = {
    "relu6": lambda F, x: F.relu6(x),
    "leaky_relu": lambda F, x: F.leaky_relu(x, 0.2),
    "elu": lambda F, x: F.elu(x, 0.7),
    "selu": lambda F, x: F.selu(x),
    "celu": lambda F, x: F.celu(x, 1.3),
    "swish": lambda F, x: F.swish(x),
    "mish": lambda F, x: F.mish(x),
    "hardshrink": lambda F, x: F.hardshrink(x, 0.8),
    "hardsigmoid": lambda F, x: F.hardsigmoid(x),
    "hardswish": lambda F, x: F.hardswish(x),
    "hardtanh": lambda F, x: F.hardtanh(x, -2.0, 1.5),
    "softshrink": lambda F, x: F.softshrink(x, 0.4),
    "softsign": lambda F, x: F.softsign(x),
    "tanhshrink": lambda F, x: F.tanhshrink(x),
    "thresholded_relu": lambda F, x: F.thresholded_relu(x, 0.5, -1.0),
    "log_sigmoid": lambda F, x: F.log_sigmoid(x),
    "maxout": lambda F, x: F.maxout(x, 3, axis=1),
    "softplus": lambda F, x: F.softplus(x, beta=2.0, threshold=5.0),
    "sigmoid": lambda F, x: F.sigmoid(x),
    "glu": lambda F, x: F.glu(x, axis=1),
    "rrelu_eval": lambda F, x: F.rrelu(x, 0.1, 0.3, training=False),
    "relu": lambda F, x: F.relu(x),
    "silu": lambda F, x: F.silu(x),
    "gelu": lambda F, x: F.gelu(x),
    "tanh": lambda F, x: F.tanh(x),
    "softmax": lambda F, x: F.softmax(x, axis=1),
    "log_softmax": lambda F, x: F.log_softmax(x, axis=-1),
    "prelu_channel": lambda F, x: F.prelu(x, x[0, :, 0, 0] * 0 + 0.1 *
                                          np.arange(1, 7, dtype=np.float32)
                                          [0]),
}


@pytest.mark.parametrize("name", sorted(FUNCTIONAL))
def test_functional_activation_matches_jax(name):
    _both(lambda pkg, x: FUNCTIONAL[name](pkg.nn.functional, x))


def test_prelu_per_channel_and_channel_last_match_jax():
    w = np.linspace(0.05, 0.3, 6).astype(np.float32)
    for fmt, x_in in (("NCHW", X), ("NHWC", np.moveaxis(X, 1, -1))):
        res = []
        for pkg in (jp, tp):
            out = pkg.nn.functional.prelu(pkg.to_tensor(x_in),
                                          pkg.to_tensor(w), data_format=fmt)
            res.append(out.numpy())
        np.testing.assert_allclose(res[1], res[0], **TOL)


LAYERS = {
    "ReLU6": ((), {}), "Hardswish": ((), {}), "Hardsigmoid": ((), {}),
    "Swish": ((), {}), "ELU": ((0.5,), {}), "CELU": ((2.0,), {}),
    "SELU": ((), {}), "GLU": ((1,), {}), "Hardshrink": ((0.3,), {}),
    "Hardtanh": ((-0.5, 0.5), {}), "LeakyReLU": ((0.05,), {}),
    "LogSigmoid": ((), {}), "LogSoftmax": ((1,), {}),
    "Softmax": ((-1,), {}), "Maxout": ((2,), {"axis": 1}), "Mish": ((), {}),
    "PReLU": ((6, 0.1), {}), "RReLU": ((0.1, 0.3), {}),
    "Sigmoid": ((), {}), "Softplus": ((1.5, 10.0), {}),
    "Softshrink": ((0.2,), {}), "Softsign": ((), {}),
    "Tanhshrink": ((), {}), "ThresholdedReLU": ((0.3,), {}),
    "ReLU": ((), {}), "Silu": ((), {}), "GELU": ((), {}), "Tanh": ((), {}),
}


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_activation_layer_matches_jax(name):
    args, kw = LAYERS[name]
    jl = getattr(jp.nn, name)(*args, **kw)
    tl = getattr(tp.nn, name)(*args, **kw)
    state = jl.state_dict()
    assert list(tl.state_dict()) == list(state)
    if state:
        layer_state_from_jax(tl, state)
    jl.eval()
    tl.eval()
    layers = {jp: jl, tp: tl}
    _both(lambda pkg, x: layers[pkg](x))


def test_the_jax_activation_layers_are_all_ported():
    from paddle_tpu.nn.layer import activation as ja
    from paddle_tpu_torch.nn.layer import activation as ta
    assert ta.__all__ == ja.__all__
    assert all(hasattr(tp.nn, n) for n in ja.__all__)


def test_rrelu_training_draws_slopes_in_range_by_the_law():
    tp.seed(2)
    x = tp.to_tensor(-np.ones(200000, np.float32))
    slopes = -tp.nn.functional.rrelu(x, 0.1, 0.3, training=True).numpy()
    assert slopes.min() >= 0.1 and slopes.max() <= 0.3
    se = (0.2 / np.sqrt(12)) / np.sqrt(slopes.size)
    assert abs(slopes.mean() - 0.2) <= 5 * se
    pos = tp.nn.functional.rrelu(tp.to_tensor(np.ones(8, np.float32)))
    np.testing.assert_array_equal(pos.numpy(), np.ones(8))
    layer = tp.nn.RReLU(0.1, 0.3)
    layer.eval()
    np.testing.assert_allclose(layer(tp.to_tensor(-np.ones(4, np.float32)))
                               .numpy(), -0.2, rtol=1e-6)


@pytest.mark.parametrize("hard", [False, True])
def test_gumbel_softmax_by_its_law(hard):
    tp.seed(3)
    logits = np.log(np.array([0.1, 0.2, 0.7], np.float32))
    x = tp.to_tensor(np.tile(logits, (20000, 1)), stop_gradient=False)
    y = tp.nn.functional.gumbel_softmax(x, temperature=0.5, hard=hard)
    yn = y.numpy()
    np.testing.assert_allclose(yn.sum(-1), 1.0, rtol=1e-5)
    if hard:
        assert set(np.unique(yn)) <= {0.0, 1.0}
    freq = np.bincount(yn.argmax(-1), minlength=3) / yn.shape[0]
    np.testing.assert_allclose(freq, [0.1, 0.2, 0.7], atol=0.015)
    (y * tp.to_tensor(np.arange(3, dtype=np.float32))).sum().backward()
    assert x.grad is not None and np.isfinite(x.grad.numpy()).all()
    jy = jp.nn.functional.gumbel_softmax(jp.to_tensor(np.tile(logits, (4, 1))),
                                         hard=hard)
    assert jy.dtype.name == y.dtype.name


@pytest.mark.parametrize("op, args", [
    ("relu_", ()), ("elu_", (0.5,)), ("hardtanh_", (-0.5, 0.5)),
    ("leaky_relu_", (0.1,)), ("softmax_", (1,)), ("tanh_", ()),
    ("thresholded_relu_", (0.2,))])
def test_functional_inplace_forms_match_jax(op, args):
    res = []
    for pkg in (jp, tp):
        x = pkg.to_tensor(X)
        assert getattr(pkg.nn.functional, op)(x, *args) is x
        res.append(x.numpy())
    np.testing.assert_allclose(res[1], res[0], **TOL)
