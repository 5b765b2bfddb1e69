"""The in-place ``_`` forms on the port held against paddle_tpu's on the
CPU, and JAX's in-place semantics.

Each ``op_`` is called as a Tensor method on both packages with the same
seeded inputs: it must return the same handle, and that handle must then
hold JAX's values (1e-6 relative and absolute for f32; special functions
2e-5), shape and dtype.  JAX computes an ``op_`` out of place and rebinds
the handle (paddle_tpu/tensor/tensor.py:221), so an op that read the
tensor earlier keeps the old value and its gradient; the port does the
same, and a parameter changed in place under ``no_grad`` stays a leaf
that requires grad.  The random ``_`` forms are held in
test_torch_random.py, the activations' in test_torch_activations.py.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import paddle_tpu as jp  # noqa: E402
import paddle_tpu_torch as tp  # noqa: E402
from paddle_tpu_torch.framework import place as tplace  # noqa: E402

TOL = dict(rtol=1e-6, atol=1e-6)
SPECIAL = dict(rtol=2e-5, atol=2e-6)
R = np.random.RandomState(2)
IN = {
    "x": R.randn(3, 4).astype(np.float32),
    "y": R.randn(3, 4).astype(np.float32),
    "p": (R.rand(3, 4) + 0.5).astype(np.float32),
    "o": R.uniform(0.05, 0.95, (3, 4)).astype(np.float32),
    "u": R.uniform(-0.9, 0.9, (3, 4)).astype(np.float32),
    "g": R.uniform(1.1, 3.0, (3, 4)).astype(np.float32),
    "i": R.randint(-6, 7, (3, 4)).astype(np.int32),
    "j": R.randint(1, 6, (3, 4)).astype(np.int32),
    "s": R.randint(0, 4, (3, 4)).astype(np.int32),
    "b": R.rand(3, 4) > 0.5,
    "c": R.rand(3, 4) > 0.5,
    "m": R.randn(4, 4).astype(np.float32),
    "n": np.array([[1.0, np.nan, -np.inf], [np.inf, 2.0, np.nan]],
                  np.float32),
    "idx": np.array([2, 0], np.int64),
    "row": R.randn(2, 4).astype(np.float32),
}

# op -> (the tensor it runs on, the other inputs by name, extra args)
CASES = {
    "abs_": ("x", [], ()), "acos_": ("u", [], ()), "atan_": ("x", [], ()),
    "ceil_": ("x", [], ()), "cos_": ("x", [], ()), "exp_": ("x", [], ()),
    "expm1_": ("x", [], ()), "floor_": ("x", [], ()), "neg_": ("x", [], ()),
    "reciprocal_": ("p", [], ()), "round_": ("x", [], ()),
    "rsqrt_": ("p", [], ()), "sigmoid_": ("x", [], ()),
    "sin_": ("x", [], ()), "sinh_": ("x", [], ()), "sqrt_": ("p", [], ()),
    "square_": ("x", [], ()), "tan_": ("u", [], ()), "tanh_": ("x", [], ()),
    "erf_": ("x", [], ()), "log_": ("p", [], ()), "log2_": ("p", [], ()),
    "log10_": ("p", [], ()), "trunc_": ("x", [], ()), "frac_": ("x", [], ()),
    "digamma_": ("p", [], ()), "lgamma_": ("p", [], ()),
    "gammaln_": ("p", [], ()), "i0_": ("x", [], ()), "logit_": ("o", [], ()),
    "sinc_": ("x", [], ()), "nan_to_num_": ("n", [], ()),
    "add_": ("x", ["y"], ()), "subtract_": ("x", ["y"], ()),
    "multiply_": ("x", ["y"], ()), "divide_": ("x", ["p"], ()),
    "remainder_": ("x", ["p"], ()), "mod_": ("x", ["p"], ()),
    "pow_": ("p", ["y"], ()), "hypot_": ("x", ["y"], ()),
    "copysign_": ("x", ["y"], ()), "floor_divide_": ("i", ["j"], ()),
    "floor_mod_": ("i", ["j"], ()), "gcd_": ("i", ["j"], ()),
    "lcm_": ("i", ["j"], ()), "ldexp_": ("x", ["s"], ()),
    "lerp_": ("x", ["y"], (0.25,)), "logical_and_": ("b", ["c"], ()),
    "logical_or_": ("b", ["c"], ()), "logical_xor_": ("b", ["c"], ()),
    "logical_not_": ("b", [], ()), "bitwise_and_": ("i", ["j"], ()),
    "bitwise_or_": ("i", ["j"], ()), "bitwise_xor_": ("i", ["j"], ()),
    "bitwise_not_": ("i", [], ()), "bitwise_left_shift_": ("i", ["s"], ()),
    "bitwise_right_shift_": ("i", ["s"], ()), "equal_": ("i", ["j"], ()),
    "less_than_": ("x", ["y"], ()), "less_equal_": ("i", ["j"], ()),
    "greater_than_": ("x", ["y"], ()), "greater_equal_": ("i", ["j"], ()),
    "tril_": ("m", [], (-1,)), "triu_": ("m", [], (1,)), "t_": ("x", [], ()),
    "transpose_": ("x", [], ([1, 0],)),
    "index_fill_": ("x", ["idx"], (1, -2.0)),
    "masked_fill_": ("x", ["b"], (0.5,)),
    "masked_scatter_": ("x", ["b", "y"], ()),
    "renorm_": ("x", [], (2.0, 0, 1.0)), "gammainc_": ("p", ["g"], ()),
    "gammaincc_": ("p", ["g"], ()), "multigammaln_": ("g", [], (2,)),
    "polygamma_": ("p", [], (1,)), "addmm_": ("m", ["m", "m"], ()),
    "cumsum_": ("x", [], (1,)), "cumprod_": ("p", [], (0,)),
    "clip_": ("x", [], (-0.5, 0.5)), "scale_": ("x", [], (2.0, 1.0)),
    "reshape_": ("x", [], ([4, 3],)), "flatten_": ("x", [], ()),
    "squeeze_": ("x", [], ()), "unsqueeze_": ("x", [], (1,)),
    "cast_": ("x", [], ("float64",)), "flip_": ("x", [], ([0],)),
    "scatter_": ("x", ["idx", "row"], ()), "fill_": ("x", [], (1.5,)),
    "zero_": ("x", [], ()), "fill_diagonal_": ("m", [], (3.0,)),
}
SPECIALS = {"digamma_", "lgamma_", "gammaln_", "i0_", "gammainc_",
            "gammaincc_", "multigammaln_", "polygamma_"}
# the ones whose arguments come in another order
FUNCTIONAL = {
    "index_add_": lambda p, x, i, v: x.index_add_(i, 0, v),
    "index_put_": lambda p, x, i, v: p.index_put_(x, (i,), v),
    "where_": lambda p, c, x, y: p.where_(c, x, y),
}
FUNCTIONAL_INPUTS = {"index_add_": ["x", "idx", "row"],
                     "index_put_": ["x", "idx", "row"],
                     "where_": ["b", "x", "y"]}
# the random ones (test_torch_random.py) and two aliases of functions
NOT_HERE = {"uniform_", "normal_", "exponential_", "bernoulli_",
            "geometric_", "log_normal_", "cauchy_", "as_tensor_",
            "ones_like_", "bool_"}


@pytest.fixture(autouse=True)
def _cpu():
    prev = tplace._current_place
    tp.set_device("cpu")
    yield
    tplace._current_place = prev


@pytest.mark.parametrize("op", sorted(CASES))
def test_inplace_method_matches_jax(op):
    src, others, extra = CASES[op]
    res = []
    for pkg in (jp, tp):
        x = pkg.to_tensor(IN[src])
        args = [pkg.to_tensor(IN[n]) for n in others] + list(extra)
        out = getattr(x, op)(*args)
        assert out is x
        res.append((x.numpy(), x.dtype.name, x.shape))
    (jv, jd, js), (tv, td, ts) = res
    assert (td, ts) == (jd, js)
    if jv.dtype.kind == "f":
        np.testing.assert_allclose(tv, jv, **(SPECIAL if op in SPECIALS
                                              else TOL))
    else:
        np.testing.assert_array_equal(tv, jv)


@pytest.mark.parametrize("op", sorted(FUNCTIONAL))
def test_inplace_functional_matches_jax(op):
    res = []
    for pkg in (jp, tp):
        ts = [pkg.to_tensor(IN[n]) for n in FUNCTIONAL_INPUTS[op]]
        target = ts[1] if op == "where_" else ts[0]
        out = FUNCTIONAL[op](pkg, *ts)
        assert out is target
        res.append(target.numpy())
    np.testing.assert_allclose(res[1], res[0], **TOL)


def test_every_top_level_inplace_form_has_a_case():
    names = {n for n in dir(jp) if n.endswith("_") and not n.startswith("_")}
    missing = names - set(CASES) - set(FUNCTIONAL) - NOT_HERE
    assert not missing, sorted(missing)
    assert all(hasattr(tp, n) and hasattr(tp.Tensor, n) or n in (
        "where_", "as_tensor_", "bool_") for n in names)


def _read_then_mutate(pkg):
    """z reads a (a non-leaf view of x) before a.add_(y): z keeps a's old
    value and the gradient through it."""
    x = pkg.to_tensor(IN["x"], stop_gradient=False)
    y = pkg.to_tensor(IN["y"], stop_gradient=False)
    a = x * 1.0
    z = a * a
    a.add_(y)
    (z.sum() + (a * 3.0).sum()).backward()
    return z.numpy(), a.numpy(), x.grad.numpy(), y.grad.numpy()


def test_an_op_that_read_x_keeps_its_value_and_gradient_as_jax():
    j, t = _read_then_mutate(jp), _read_then_mutate(tp)
    for a, b in zip(t, j):
        np.testing.assert_allclose(a, b, **TOL)
    np.testing.assert_allclose(t[0], IN["x"] ** 2, **TOL)
    np.testing.assert_allclose(t[2], 2 * IN["x"] + 3.0, **TOL)


def test_a_leaf_mutated_in_place_keeps_its_old_gradient_as_jax():
    out = []
    for pkg in (jp, tp):
        x = pkg.to_tensor(IN["x"], stop_gradient=False)
        z = (x * x).sum()
        x.clip_(-0.5, 0.5)
        (z + x.sum()).backward()
        out.append((x.numpy(), x.grad.numpy()))
    np.testing.assert_allclose(out[1][0], out[0][0], **TOL)
    np.testing.assert_allclose(out[1][1], out[0][1], **TOL)


def test_a_parameter_clipped_under_no_grad_keeps_requiring_grad():
    for pkg in (jp, tp):
        pkg.seed(0)
        lin = pkg.nn.Linear(4, 3)
        w = lin.weight
        data = w._data
        with pkg.no_grad():
            w.clip_(-0.1, 0.1)
            w.scale_(2.0)
        assert not w.stop_gradient
        assert float(w.abs().max()) <= 0.2 + 1e-7
        if pkg is tp:
            # the same storage, still a leaf: the optimizer's and a CUDA
            # graph's references see the new values
            assert w._data is data and w.is_leaf
        lin(pkg.to_tensor(IN["x"])).sum().backward()
        assert w.grad is not None and w.grad.shape == [4, 3]


def test_setitem_rebinds_and_keeps_the_old_gradient_as_jax():
    out = []
    for pkg in (jp, tp):
        x = pkg.to_tensor(IN["x"], stop_gradient=False)
        v = pkg.to_tensor(IN["row"][0, :2], stop_gradient=False)
        y = x * 2.0
        y[1, 1:3] = v
        y.sum().backward()
        out.append((y.numpy(), x.grad.numpy(), v.grad.numpy()))
    for a, b in zip(out[1], out[0]):
        np.testing.assert_allclose(a, b, **TOL)


def test_copy_and_tensor_methods():
    x = tp.to_tensor(IN["x"])
    y = tp.zeros([3, 4], dtype="float64")
    assert y.copy_(x) is y and y.dtype.name == "float64"
    np.testing.assert_allclose(y.numpy(), IN["x"].astype(np.float64))
    assert x.contiguous().is_contiguous() and x.get_tensor() is x
    (d,), aux = x.tree_flatten()
    assert tp.Tensor.tree_unflatten(aux, (d,)).stop_gradient
    assert x.element_size() == 4 and x.nelement() == 12
    assert x.ndimension() == 2 and x.mT.shape == [4, 3]
    with pytest.raises(NotImplementedError):
        x.tpu()
