"""The port's random ops held against paddle_tpu's on the CPU.

``jax.random`` and the port's torch generators cannot give the same bits,
so each op is held by what both must share: the shape and dtype of JAX's
result for the same call, the law (the mean and variance of many draws
within 5 standard errors of the law's, or an exact structural fact:
``randperm`` is a permutation, ``multinomial`` without replacement draws
distinct indices, ``randint`` stays in range), and the port's seeded
reproducibility (``paddle.seed`` twice gives the same draws, and
``get_rng_state`` / ``set_rng_state`` replay them).
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import paddle_tpu as jp  # noqa: E402
import paddle_tpu_torch as tp  # noqa: E402
from paddle_tpu_torch.framework import place as tplace  # noqa: E402

N = 40000
X = np.full((N,), 0.3, np.float32)


@pytest.fixture(autouse=True)
def _cpu():
    prev = tplace._current_place
    tp.set_device("cpu")
    yield
    tplace._current_place = prev


def _moments(a, mean, var, what):
    a = np.asarray(a, np.float64).reshape(-1)
    n = a.size
    se = math.sqrt(var / n)
    assert abs(a.mean() - mean) <= 5 * se, (what, a.mean(), mean)
    # the sample variance's standard error, from a normal law's fourth
    # moment (a loose bar for the skewed laws)
    se_v = var * math.sqrt(2.0 / (n - 1)) * 3
    assert abs(a.var(ddof=1) - var) <= 5 * se_v, (what, a.var(), var)


# (id, call, the law's (mean, variance) or None)
LAWS = [
    ("rand", lambda p: p.rand([N]), (0.5, 1 / 12)),
    ("randn", lambda p: p.randn([N]), (0.0, 1.0)),
    ("standard_normal", lambda p: p.standard_normal([N], "float64"),
     (0.0, 1.0)),
    ("uniform", lambda p: p.uniform([N], min=-2.0, max=4.0), (1.0, 3.0)),
    ("normal", lambda p: p.normal(2.0, 3.0, [N]), (2.0, 9.0)),
    ("normal_tensor", lambda p: p.normal(p.to_tensor(X), p.to_tensor(X)),
     (0.3, 0.09)),
    ("log_normal", lambda p: p.log_normal(0.0, 0.5, [N]),
     (math.exp(0.125), (math.exp(0.25) - 1) * math.exp(0.25))),
    ("randint", lambda p: p.randint(-3, 5, [N]), (0.5, (64 - 1) / 12)),
    ("randint_like", lambda p: p.randint_like(p.to_tensor(
        X.astype(np.int32)), 0, 10), (4.5, 99 / 12)),
    ("randn_like", lambda p: p.randn_like(p.to_tensor(X)), (0.0, 1.0)),
    ("rand_like", lambda p: p.rand_like(p.to_tensor(X)), (0.5, 1 / 12)),
    ("bernoulli", lambda p: p.bernoulli(p.to_tensor(X)), (0.3, 0.21)),
    ("poisson", lambda p: p.poisson(p.to_tensor(X * 10)), (3.0, 3.0)),
    ("binomial", lambda p: p.binomial(
        p.to_tensor(np.full((N,), 10, np.int64)), p.to_tensor(X)),
     (3.0, 2.1)),
    ("standard_gamma_large", lambda p: p.standard_gamma(
        p.to_tensor(X * 10)), (3.0, 3.0)),
    ("standard_gamma_small", lambda p: p.standard_gamma(p.to_tensor(X)),
     (0.3, 0.3)),
    ("multinomial_replacement", lambda p: p.multinomial(p.to_tensor(
        np.array([0.1, 0.2, 0.7], np.float32)), 20000, replacement=True),
     (1.6, 0.44)),
    ("randperm", lambda p: p.randperm(1000), None),
    ("multinomial_distinct", lambda p: p.multinomial(p.to_tensor(
        np.full((4, 50), 0.02, np.float32)), 30), None),
]


@pytest.mark.parametrize("call, law", [pytest.param(c, m, id=i)
                                       for i, c, m in LAWS])
def test_draws_have_jax_shape_dtype_and_the_law(call, law):
    j, t = call(jp), call(tp)
    assert t.dtype.name == j.dtype.name and t.shape == j.shape
    a = t.numpy()
    if law is not None:
        _moments(a, *law, what=t.dtype.name)


def test_randint_range_and_randperm_is_a_permutation():
    tp.seed(5)
    a = tp.randint(-3, 5, [5000]).numpy()
    assert a.min() == -3 and a.max() == 4
    perm = tp.randperm(4096).numpy()
    np.testing.assert_array_equal(np.sort(perm), np.arange(4096))


def test_multinomial_without_replacement_draws_distinct_indices():
    tp.seed(6)
    out = tp.multinomial(tp.to_tensor(np.random.RandomState(0).rand(
        8, 64).astype(np.float32)), 64).numpy()
    for row in out:
        np.testing.assert_array_equal(np.sort(row), np.arange(64))


@pytest.mark.parametrize("op", ["uniform_", "normal_", "exponential_",
                                "bernoulli_", "geometric_", "log_normal_",
                                "cauchy_"])
def test_inplace_draws_keep_the_handle_and_its_dtype(op):
    args = {"uniform_": dict(min=0.0, max=2.0), "normal_": dict(mean=1.0),
            "exponential_": dict(lam=2.0), "bernoulli_": dict(p=0.25),
            "geometric_": dict(probs=0.5), "log_normal_": dict(mean=0.0,
                                                               std=0.25),
            "cauchy_": dict(loc=1.0)}[op]
    law = {"uniform_": (1.0, 1 / 3), "normal_": (1.0, 1.0),
           "exponential_": (0.5, 0.25), "bernoulli_": (0.25, 0.1875),
           "geometric_": (2.0, 2.0),
           "log_normal_": (math.exp(1 / 32),
                           (math.exp(1 / 16) - 1) * math.exp(1 / 16))}
    for pkg in (jp, tp):
        x = pkg.zeros([N])
        out = getattr(x, op)(**args)
        assert out is x and x.dtype.name == "float32" and x.shape == [N]
    if op in law:
        _moments(x.numpy(), *law[op], what=op)
    else:                      # Cauchy: the median and quartiles
        q = np.quantile(x.numpy(), [0.25, 0.5, 0.75])
        np.testing.assert_allclose(q, [0.0, 1.0, 2.0], atol=0.05)


def test_a_parameter_filled_in_place_keeps_its_gradient():
    w = tp.create_parameter([3, 3], "float32")
    data = w._data
    w.uniform_()
    assert not w.stop_gradient and w.is_leaf and w._data is data
    with tp.no_grad():
        w.normal_()
    assert not w.stop_gradient and w.is_leaf


@pytest.mark.parametrize("call", [
    lambda: tp.randn([64]), lambda: tp.rand([64]),
    lambda: tp.randint(0, 100, [64]), lambda: tp.randperm(64),
    lambda: tp.uniform([64]), lambda: tp.normal(0.0, 1.0, [64]),
    lambda: tp.multinomial(tp.to_tensor(np.full((64,), 1 / 64, np.float32)),
                           8),
    lambda: tp.bernoulli(tp.to_tensor(X[:64])),
    lambda: tp.poisson(tp.to_tensor(X[:64])),
    lambda: tp.standard_gamma(tp.to_tensor(X[:64])),
    lambda: tp.zeros([64]).exponential_(),
    lambda: tp.nn.functional.rrelu(tp.to_tensor(-X[:64])),
    lambda: tp.nn.functional.gumbel_softmax(tp.to_tensor(X[:64])),
], ids=["randn", "rand", "randint", "randperm", "uniform", "normal",
        "multinomial", "bernoulli", "poisson", "standard_gamma",
        "exponential_", "rrelu", "gumbel_softmax"])
def test_same_seed_same_draws(call):
    tp.seed(1234)
    a = call().numpy()
    tp.seed(1234)
    b = call().numpy()
    np.testing.assert_array_equal(a, b)
    c = call().numpy()
    assert not np.array_equal(a, c)


def test_rng_state_replays_the_draws():
    tp.seed(3)
    state = tp.get_rng_state()
    a = tp.randn([16]).numpy()
    tp.set_rng_state(state)
    np.testing.assert_array_equal(tp.randn([16]).numpy(), a)
    assert isinstance(tp.get_cuda_rng_state(), list)
    tp.set_cuda_rng_state(tp.get_cuda_rng_state())


def test_uniform_seed_argument_is_its_own_stream():
    a = tp.uniform([8], seed=11).numpy()
    tp.randn([4])
    np.testing.assert_array_equal(tp.uniform([8], seed=11).numpy(), a)
