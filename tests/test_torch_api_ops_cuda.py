"""The tensor-op surface on a CUDA card, against the same calls on the CPU
(paddle_tpu_torch/testing/op_sweep.py at a small size).

* every case of the sweep (the functions, the ``_`` forms as Tensor
  methods and nn.functional's activations) on the card within its
  family's bound of the CPU's result, gradients included;
* what CUDA does its own way: ``argsort(stable=True)``, ``unique`` and
  ``mode`` on ties, ``cummax`` / ``cummin`` indices on ties,
  ``scatter(overwrite=True)`` and ``index_put`` with duplicate indices
  (the later row wins, the same bits in every run), ``lstsq`` on a
  rank-deficient matrix (JAX's int32 rank and minimum-norm solution),
  ``bitwise_right_shift(is_arithmetic=False)`` on negative ints, an
  even-count ``median``, and the decompositions by their invariants;
* the bf16 lane, and the random ops: the same ``paddle.seed`` gives the
  same draws on the card, the moments follow the law, ``randperm`` is a
  permutation.

Every test needs a card and skips without one.  The card machine has no
JAX, so run this file there without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_api_ops_cuda.py -q
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import paddle_tpu_torch as paddle  # noqa: E402
from paddle_tpu_torch.framework import place as tplace  # noqa: E402
from paddle_tpu_torch.testing import op_sweep as ow  # noqa: E402

pytestmark = pytest.mark.cuda

SIZES = dict(rows=256, cols=512, mat=64, batch=4, small=16)
FAMILIES = ["elementwise", "special", "exact", "reduction", "scan",
            "product", "linalg", "activation"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    prev = tplace._current_place
    paddle.set_device("gpu")
    yield
    tplace._current_place = prev


@pytest.fixture(scope="module")
def inputs():
    return ow.make_inputs(seed=3, **SIZES)


@pytest.mark.parametrize("family", FAMILIES)
def test_sweep_family_on_the_card_matches_the_cpu(card, inputs, family):
    rows, cols = inputs["x"].shape
    chosen = [c for c in ow.cases(rows, cols) + ow.inplace_cases() +
              ow.f_inplace_cases() if c.family == family]
    res, raised = ow.sweep(paddle, inputs, "cuda", chosen)
    assert not raised, raised
    bad = {k: v for k, v in res.items() if not v[1] <= v[2]}
    assert not bad, bad


def test_the_sweep_calls_every_name(card):
    assert ow.coverage() == []


def test_cuda_specific_cases(card, inputs):
    res = ow.extra_checks(paddle, inputs, "cuda", runs=5)
    bad = {k: v for k, v in res.items() if not v[0] <= v[1]}
    assert not bad, bad


def test_duplicate_index_writes_are_the_same_bits_every_run(card):
    r = np.random.RandomState(0)
    x = paddle.to_tensor(r.randn(64, 128).astype(np.float32))
    idx = paddle.to_tensor(np.array([5, 3, 5, 5, 0, 3, 63] * 40, np.int64))
    upd = paddle.to_tensor(r.randn(280, 128).astype(np.float32))
    outs = [paddle.scatter(x, idx, upd).numpy() for _ in range(8)]
    for o in outs[1:]:
        np.testing.assert_array_equal(o, outs[0])
    want = x.numpy().copy()
    for k, i in enumerate(idx.numpy()):
        want[i] = upd.numpy()[k]
    np.testing.assert_array_equal(outs[0], want)


def test_bf16_lane(card):
    res = ow.bf16_lane(paddle, "cuda", rows=128, cols=256)
    bad = {k: v for k, v in res.items() if not v[0] <= v[1]}
    assert not bad, bad


def test_random_ops_by_seed_and_law(card):
    res = ow.rng_checks(paddle)
    bad = {k: v for k, v in res.items() if v[0]}
    assert not bad, bad


def test_a_parameter_updated_in_place_on_the_card_keeps_its_storage(card):
    lin = paddle.nn.Linear(8, 8)
    w = lin.weight
    ptr = w._data.data_ptr()
    with paddle.no_grad():
        w.clip_(-0.01, 0.01)
        w.uniform_(-0.1, 0.1)
    assert w._data.data_ptr() == ptr and not w.stop_gradient and w.is_leaf
    lin(paddle.randn([4, 8])).sum().backward()
    assert w.grad is not None
