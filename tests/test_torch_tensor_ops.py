"""The port's tensor-op surface held against paddle_tpu's on the CPU: math,
manipulation, logic / search, stat, creation, einsum and extras.

Each case is one op (its id), run with the same seeded numpy inputs
through both packages (``paddle_tpu`` and ``paddle_tpu_torch``, the
``PKGS`` pattern of tests/test_torch_api_core.py).  Every output is held
for its shape, its dtype and its values: exactly for integer and bool
results, within 1e-6 relative and absolute for f32 (``TOL``: the same
arithmetic in another order) unless the case states a wider bar with its
reason.  Where the op is differentiable the gradients of
``sum(out * g)`` by each float input (``g`` a seeded cotangent) are held
at the same bar; an input the output does not depend on has no gradient
in torch and a zero one in JAX's tape, and the two compare equal.  ``test_every_op_has_a_case`` checks that each public
name of the JAX modules has a case here (or names the file that holds
it).  linalg, random and the in-place forms have files of their own.
"""

import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import paddle_tpu as jp  # noqa: E402
import paddle_tpu_torch as tp  # noqa: E402
from paddle_tpu_torch.framework import place as tplace  # noqa: E402

TOL = dict(rtol=1e-6, atol=1e-6)
# special functions evaluated by other series (torch's against XLA's)
SPECIAL = dict(rtol=2e-5, atol=2e-6)
# reductions and products over tens of terms, in another order
SUMS = dict(rtol=1e-5, atol=1e-5)
PKGS = [jp, tp]

R = np.random.RandomState(0)
IN = {
    "x": R.randn(3, 4).astype(np.float32),
    "y": R.randn(3, 4).astype(np.float32),
    "p": (R.rand(3, 4) + 0.5).astype(np.float32),
    "q": (R.rand(3, 4) + 0.5).astype(np.float32),
    "u": R.uniform(-0.9, 0.9, (3, 4)).astype(np.float32),
    "g": R.uniform(1.1, 3.0, (3, 4)).astype(np.float32),
    "i": R.randint(-6, 7, (3, 4)).astype(np.int32),
    "j": R.randint(1, 6, (3, 4)).astype(np.int32),
    "k": R.randint(0, 8, (3, 4)).astype(np.int64),
    "s": R.randint(0, 4, (3, 4)).astype(np.int32),
    "b": R.rand(3, 4) > 0.5,
    "c": R.rand(3, 4) > 0.5,
    "v": R.randn(4).astype(np.float32),
    "w": R.randn(3).astype(np.float32),
    "m": R.randn(4, 4).astype(np.float32),
    "m34": R.randn(3, 4).astype(np.float32),
    "m45": R.randn(4, 5).astype(np.float32),
    "t": R.randn(2, 3, 4).astype(np.float32),
    "t2": R.randn(2, 4, 5).astype(np.float32),
    "n": np.array([[1.0, np.nan, -np.inf], [np.inf, 2.0, np.nan]],
                  np.float32),
    "n2": np.array([[0.5, 3.0, np.nan], [-1.0, np.nan, np.nan]],
                   np.float32),
    "o": R.uniform(0.05, 0.95, (3, 4)).astype(np.float32),
    "ties": np.array([[3.0, 1.0, 3.0, 2.0, 1.0, 3.0],
                      [2.0, 2.0, 5.0, 5.0, 0.0, 5.0]], np.float32),
    "row": np.sort(R.randn(6)).astype(np.float32),
    "idx": np.array([2, 0, 1, 0], np.int64),
    "idx3": np.array([2, 0, 2], np.int64),
    "pos": R.randint(0, 3, (3, 4)).astype(np.int64),
    "nd": np.array([[0, 1], [2, 3], [1, 0]], np.int64),
    "z": np.array([[0.0, 1.5, 0.0, -2.0], [3.0, 0.0, 0.0, 1.0],
                   [0.0, 0.0, 4.0, 0.0]], np.float32),
    "even": R.randn(4, 6).astype(np.float32),
    "cplx": R.randn(3, 4, 2).astype(np.float32),
}


def C(op_id, fn, ins, grad=True, tol=None):
    return pytest.param(fn, ins, grad, tol, id=op_id)


def _tensor(pkg, name, grad):
    a = IN[name]
    return pkg.to_tensor(a, stop_gradient=not (grad and a.dtype.kind == "f"))


def _run(pkg, fn, ins, grad):
    ts = [_tensor(pkg, n, grad) for n in ins]
    out = fn(pkg, *ts)
    outs = list(out) if isinstance(out, (list, tuple)) else [out]
    res = []
    for o in outs:
        if isinstance(o, (bool, int, float)):
            res.append((o, type(o).__name__, None))
        else:
            res.append((np.asarray(o.numpy()), o.dtype.name, list(o.shape)))
    grads = []
    if grad:
        floats = [o for o in outs if hasattr(o, "dtype") and
                  o.dtype.name in ("float32", "float64") and
                  not o.stop_gradient]
        if floats:
            loss = None
            for k, o in enumerate(floats):
                g = np.asarray(np.random.RandomState(100 + k).randn(
                    *o.shape), dtype=o.dtype.name)
                term = (o * pkg.to_tensor(g)).sum()
                loss = term if loss is None else loss + term
            loss.backward()
            for t in ts:
                grads.append(None if t.grad is None else
                             np.asarray(t.grad.numpy()))
    return res, grads


def _compare(j, t, tol):
    (jres, jgrads), (tres, tgrads) = j, t
    assert len(tres) == len(jres)
    for (jv, jd, js), (tv, td, ts) in zip(jres, tres):
        assert td == jd, (td, jd)
        assert ts == js, (ts, js)
        if js is None:
            assert tv == jv
        elif jv.dtype.kind in "fc":
            np.testing.assert_allclose(tv, jv, **tol)
        else:
            np.testing.assert_array_equal(tv, jv)
    assert len(tgrads) == len(jgrads)
    for jg, tg in zip(jgrads, tgrads):
        if jg is None and tg is None:
            continue
        if tg is None:
            tg = np.zeros_like(jg)
        if jg is None:
            jg = np.zeros_like(tg)
        np.testing.assert_allclose(tg, jg, **tol)


@pytest.fixture(autouse=True)
def _cpu():
    prev = tplace._current_place
    tp.set_device("cpu")
    yield
    tplace._current_place = prev


def _check(fn, ins, grad, tol):
    j = _run(jp, fn, ins, grad)
    t = _run(tp, fn, ins, grad)
    _compare(j, t, tol or TOL)


# ---------------------------------------------------------------------------
# math
# ---------------------------------------------------------------------------
UNARY = [  # (op, input, tolerance)
    ("exp", "x", None), ("expm1", "x", None), ("log", "p", None),
    ("log2", "p", None), ("log10", "p", None), ("log1p", "p", None),
    ("sqrt", "p", None), ("rsqrt", "p", None), ("square", "x", None),
    ("abs", "x", None), ("ceil", "x", None), ("floor", "x", None),
    ("round", "x", None), ("trunc", "x", None), ("sin", "x", None),
    ("cos", "x", None), ("tan", "u", None), ("asin", "u", None),
    ("acos", "u", None), ("atan", "x", None), ("sinh", "x", None),
    ("cosh", "x", None), ("tanh", "x", None), ("asinh", "x", None),
    ("acosh", "g", None), ("atanh", "u", None), ("erf", "x", None),
    ("erfinv", "u", SPECIAL), ("reciprocal", "p", None), ("sign", "x", None),
    ("sgn", "x", None), ("neg", "x", None), ("negative", "x", None),
    ("conj", "x", None), ("angle", "x", None), ("real", "x", None),
    ("imag", "x", None), ("deg2rad", "x", None), ("rad2deg", "x", None),
    ("frac", "x", None), ("digamma", "p", SPECIAL),
    ("lgamma", "p", SPECIAL), ("gammaln", "p", SPECIAL),
    ("sigmoid", "x", None), ("logit", "o", None), ("i0", "x", SPECIAL),
    ("i0e", "x", SPECIAL), ("i1", "x", SPECIAL), ("i1e", "x", SPECIAL),
    ("isnan", "n", None), ("isinf", "n", None), ("isfinite", "n", None),
    ("isneginf", "n", None), ("isposinf", "n", None), ("isreal", "x", None),
    ("bitwise_not", "i", None), ("logical_not", "b", None),
]
BINARY = [  # (op, x, y, tolerance)
    ("add", "x", "y", None), ("subtract", "x", "y", None),
    ("multiply", "x", "y", None), ("divide", "x", "p", None),
    ("floor_divide", "i", "j", None), ("mod", "i", "j", None),
    ("remainder", "x", "p", None), ("floor_mod", "i", "j", None),
    ("fmod", "x", "p", None), ("pow", "p", "y", None),
    ("maximum", "x", "y", None), ("minimum", "x", "y", None),
    ("fmax", "n", "n2", None), ("fmin", "n", "n2", None),
    ("atan2", "x", "y", None), ("hypot", "x", "y", None),
    ("heaviside", "z", "y", None), ("gcd", "i", "j", None),
    ("lcm", "i", "j", None), ("copysign", "x", "y", None),
    ("ldexp", "x", "s", None),
    ("logaddexp", "x", "y", None), ("bitwise_and", "i", "j", None),
    ("bitwise_or", "i", "j", None), ("bitwise_xor", "i", "j", None),
    ("logical_and", "b", "c", None), ("logical_or", "b", "c", None),
    ("logical_xor", "b", "c", None), ("left_shift", "i", "s", None),
    ("right_shift", "i", "s", None), ("divide_no_nan", "x", "z", None),
]
MATH = [C(op, (lambda o: lambda p, a: getattr(p, o)(a))(op), [x], True, tol)
        for op, x, tol in UNARY]
MATH += [C(op, (lambda o: lambda p, a, b: getattr(p, o)(a, b))(op), [x, y],
           True, tol) for op, x, y, tol in BINARY]
MATH += [
    C("nextafter", lambda p, a, b: p.nextafter(a, b), ["x", "y"], False),
    C("add_scalar", lambda p, a: p.add(a, 2.5), ["x"]),
    C("pow_scalar", lambda p, a: a ** 2, ["x"]),
    C("rsub_scalar", lambda p, a: 1.0 - a, ["x"]),
    C("maximum_scalar", lambda p, a: p.maximum(a, 0.25), ["x"]),
    C("divide_int_int", lambda p, a, b: p.divide(a, b), ["i", "j"]),
    C("sin_of_int32", lambda p, a: p.sin(a), ["i"]),
    C("sqrt_of_int64", lambda p, a: p.sqrt(a), ["k"]),
    C("scale", lambda p, a: p.scale(a, 2.0, 0.5), ["x"]),
    C("scale_bias_first", lambda p, a: p.scale(
        a, 2.0, 0.5, bias_after_scale=False), ["x"]),
    C("clip", lambda p, a: p.clip(a, -0.5, 0.7), ["x"]),
    C("clip_min_only", lambda p, a: p.clip(a, min=0.1), ["x"]),
    C("lerp", lambda p, a, b: p.lerp(a, b, 0.3), ["x", "y"]),
    C("lerp_tensor_weight", lambda p, a, b, w: p.lerp(a, b, w),
      ["x", "y", "q"]),
    C("stanh", lambda p, a: p.stanh(a), ["x"]),
    C("nan_to_num", lambda p, a: p.nan_to_num(a, nan=1.5, posinf=9.0),
      ["n"], False),
    C("add_n", lambda p, a, b, c: p.add_n([a, b, c]), ["x", "y", "q"]),
    C("count_nonzero", lambda p, a: p.count_nonzero(a, axis=1), ["z"]),
    C("sum", lambda p, a: p.sum(a, axis=1, keepdim=True), ["x"], True,
      SUMS),
    C("sum_of_int32", lambda p, a: p.sum(a), ["i"]),
    C("prod", lambda p, a: p.prod(a, axis=0), ["p"], True, SUMS),
    C("max", lambda p, a: p.max(a, axis=1), ["x"]),
    C("min", lambda p, a: p.min(a), ["x"]),
    C("amax", lambda p, a: p.amax(a, axis=[0, 1]), ["x"]),
    C("amin", lambda p, a: p.amin(a, axis=0, keepdim=True), ["x"]),
    C("all", lambda p, a: p.all(a, axis=1), ["b"]),
    C("any", lambda p, a: p.any(a), ["b"]),
    C("nansum", lambda p, a: p.nansum(a, axis=1), ["z"], True, SUMS),
    C("nanmean", lambda p, a: p.nanmean(a, axis=0), ["z"], True, SUMS),
    C("mean", lambda p, a: p.mean(a, axis=[0, 1]), ["x"], True, SUMS),
    C("mean_of_int32", lambda p, a: p.mean(a), ["i"], False, SUMS),
    C("logsumexp", lambda p, a: p.logsumexp(a, axis=1), ["x"], True, SUMS),
    C("log_normalize", lambda p, a: p.log_normalize(a), ["x"], True, SUMS),
    C("cumsum", lambda p, a: p.cumsum(a, axis=1), ["x"], True, SUMS),
    C("cumsum_flat_int32", lambda p, a: p.cumsum(a), ["i"]),
    C("cumprod", lambda p, a: p.cumprod(a, dim=0), ["p"], True, SUMS),
    C("cummax", lambda p, a: p.cummax(a, axis=1), ["ties"], False),
    C("cummin", lambda p, a: p.cummin(a, axis=1), ["ties"], False),
    C("cummax_flat", lambda p, a: p.cummax(a), ["x"], False),
    C("diff", lambda p, a: p.diff(a, axis=1), ["x"]),
    C("diff_n2_prepend", lambda p, a, b: p.diff(a, n=2, axis=0, prepend=b),
      ["x", "y"]),
    C("addmm", lambda p, i, a, b: p.addmm(i, a, b, beta=0.5, alpha=2.0),
      ["m", "m", "m"], True, SUMS),
    C("inner", lambda p, a, b: p.inner(a, b), ["x", "y"], True, SUMS),
    C("outer", lambda p, a, b: p.outer(a, b), ["v", "w"]),
    C("kron", lambda p, a, b: p.kron(a, b), ["x", "m"]),
    C("trace", lambda p, a: p.trace(a, offset=1), ["m"]),
    C("diagonal", lambda p, a: p.diagonal(a, offset=-1, axis1=1, axis2=2),
      ["t"]),
    C("multiplex", lambda p, a, b: p.multiplex(
        [a, b], p.to_tensor([[1], [0], [1]])), ["x", "y"]),
]

# ---------------------------------------------------------------------------
# manipulation
# ---------------------------------------------------------------------------
MANIP = [
    C("reshape", lambda p, a: p.reshape(a, [4, -1]), ["t"]),
    C("flatten", lambda p, a: p.flatten(a, 1, 2), ["t"]),
    C("transpose", lambda p, a: p.transpose(a, [2, 0, 1]), ["t"]),
    C("permute", lambda p, a: p.permute(a, [1, 2, 0]), ["t"]),
    C("squeeze", lambda p, a: p.squeeze(p.unsqueeze(a, 0), 0), ["x"]),
    C("unsqueeze", lambda p, a: p.unsqueeze(a, [0, 3]), ["x"]),
    C("concat", lambda p, a, b: p.concat([a, b], axis=1), ["x", "y"]),
    C("stack", lambda p, a, b: p.stack([a, b], axis=2), ["x", "y"]),
    C("split", lambda p, a: p.split(a, [1, -1], axis=1), ["x"]),
    C("tensor_split", lambda p, a: p.tensor_split(a, 3, axis=1), ["x"]),
    C("vsplit", lambda p, a: p.vsplit(a, [1]), ["x"]),
    C("hsplit", lambda p, a: p.hsplit(a, 2), ["x"]),
    C("dsplit", lambda p, a: p.dsplit(a, [1, 3]), ["t"]),
    C("chunk", lambda p, a: p.chunk(a, 2, axis=1), ["x"]),
    C("unstack", lambda p, a: p.unstack(a, axis=1), ["x"]),
    C("unbind", lambda p, a: p.unbind(a, 0), ["t"]),
    C("tile", lambda p, a: p.tile(a, [2, 1, 2]), ["x"]),
    C("expand", lambda p, a: p.expand(a, [2, -1, 4]), ["x"]),
    C("expand_as", lambda p, a, b: p.expand_as(a, b), ["v", "x"]),
    C("broadcast_to", lambda p, a: p.broadcast_to(a, [2, 3, 4]), ["x"]),
    C("broadcast_tensors", lambda p, a, b: p.broadcast_tensors(
        [a, p.reshape(b, [1, 4])]), ["x", "v"]),
    C("broadcast_shape", lambda p: p.broadcast_shape([3, 1], [1, 4]), [],
      False),
    C("gather", lambda p, a, i: p.gather(a, i, axis=1), ["x", "idx"]),
    C("gather_negative_index", lambda p, a: p.gather(
        a, p.to_tensor([-1, 0]), axis=0), ["x"]),
    C("gather_nd", lambda p, a, i: p.gather_nd(a, i), ["x", "nd"]),
    # JAX splits the gradient among duplicate indices: the values of a
    # duplicate write are held, the gradients on unique indices
    C("scatter_overwrite_dup", lambda p, a, b, i: p.scatter(
        a, i, b, overwrite=True), ["x", "y", "idx3"], False),
    C("scatter_overwrite", lambda p, a, b: p.scatter(
        a, p.to_tensor([2, 0, 1]), b, overwrite=True), ["x", "y"]),
    C("scatter_add", lambda p, a, b, i: p.scatter(
        a, i[:3], b, overwrite=False), ["x", "y", "idx3"]),
    C("scatter_nd", lambda p, i, b: p.scatter_nd(i, b, [4, 4]),
      ["nd", "w"]),
    C("scatter_nd_add", lambda p, a, i, b: p.scatter_nd_add(a, i, b),
      ["m34", "nd", "w"]),
    C("index_select", lambda p, a, i: p.index_select(a, i, axis=1),
      ["x", "idx"]),
    C("index_sample", lambda p, a, i: p.index_sample(a, i), ["x", "pos"]),
    C("index_add", lambda p, a, i, b: p.index_add(a, i, 0, b),
      ["x", "idx3", "y"]),
    C("index_put_dup", lambda p, a, i, b: p.index_put(
        a, (i, p.to_tensor([1, 1, 1])), b), ["x", "idx3", "w"], False),
    C("index_put", lambda p, a, b: p.index_put(
        a, (p.to_tensor([2, 0, 1]), p.to_tensor([1, 3, 1])), b),
      ["x", "w"]),
    C("index_put_accumulate", lambda p, a, i, b: p.index_put(
        a, (i,), b, accumulate=True), ["x", "idx3", "y"]),
    C("masked_select", lambda p, a, m: p.masked_select(a, m), ["x", "b"]),
    C("masked_fill", lambda p, a, m: p.masked_fill(a, m, -2.0), ["x", "b"]),
    C("masked_scatter", lambda p, a, m, b: p.masked_scatter(a, m, b),
      ["x", "b", "y"]),
    C("roll", lambda p, a: p.roll(a, [1, -1], [0, 1]), ["x"]),
    C("roll_flat", lambda p, a: p.roll(a, 5), ["x"]),
    C("flip", lambda p, a: p.flip(a, [0, 2]), ["t"]),
    C("reverse", lambda p, a: p.reverse(a, 1), ["x"]),
    C("rot90", lambda p, a: p.rot90(a, k=3, axes=[1, 2]), ["t"]),
    C("unique", lambda p, a: p.unique(a, return_index=True,
                                      return_inverse=True,
                                      return_counts=True), ["i"], False),
    C("unique_axis", lambda p, a: p.unique(a, return_inverse=True, axis=1),
      ["ties"], False),
    C("unique_consecutive", lambda p, a: p.unique_consecutive(
        a, return_inverse=True, return_counts=True), ["ties"], False),
    C("repeat_interleave", lambda p, a: p.repeat_interleave(a, 2, axis=1),
      ["x"]),
    C("repeat_interleave_tensor", lambda p, a: p.repeat_interleave(
        a, p.to_tensor([1, 0, 2]), axis=0), ["x"], False),
    C("take_along_axis", lambda p, a, i: p.take_along_axis(a, i, 1),
      ["x", "pos"]),
    C("put_along_axis", lambda p, a, i, b: p.put_along_axis(a, i, b, 1),
      ["x", "pos", "y"], False),
    C("put_along_axis_add", lambda p, a, i, b: p.put_along_axis(
        a, i, b, 1, reduce="add"), ["x", "pos", "y"]),
    C("put_along_axis_mul", lambda p, a, i, b: p.put_along_axis(
        a, i, b, 1, reduce="multiply"), ["x", "pos", "y"], False),
    C("put_along_axis_amax", lambda p, a, i: p.put_along_axis(
        a, i, 0.5, 1, reduce="amax"), ["x", "pos"], False),
    C("slice", lambda p, a: p.slice(a, [0, 2], [1, 0], [3, 3]), ["t"]),
    C("strided_slice", lambda p, a: p.strided_slice(
        a, [1, 2], [0, 3], [3, 0], [2, -1]), ["t"]),
    C("moveaxis", lambda p, a: p.moveaxis(a, 0, 2), ["t"]),
    C("swapaxes", lambda p, a: p.swapaxes(a, 0, 2), ["t"]),
    C("as_real_of_complex", lambda p, a: p.as_real(p.as_complex(a)),
      ["cplx"]),
    C("as_complex", lambda p, a: p.real(p.as_complex(a)) * 2.0, ["cplx"]),
    C("cast", lambda p, a: p.cast(a, "int32"), ["x"], False),
    C("astype", lambda p, a: a.astype("float64"), ["x"]),
    C("crop", lambda p, a: p.crop(a, [2, -1, 2], [0, 1, 1]), ["t"]),
    C("t", lambda p, a: p.t(a), ["x"]),
    C("tolist", lambda p, a: p.to_tensor(p.tolist(a)), ["i"], False),
    C("atleast_1d", lambda p, a: p.atleast_1d(p.sum(a)), ["x"]),
    C("atleast_2d", lambda p, a: p.atleast_2d(a), ["v"]),
    C("atleast_3d", lambda p, a, b: p.atleast_3d(a, b), ["v", "x"]),
    C("view", lambda p, a: p.view(a, [2, 6]), ["x"]),
    C("view_dtype", lambda p, a: p.view(a, "float64"), ["x"]),
    C("view_as", lambda p, a, b: p.view_as(a, b), ["m34", "x"]),
    C("as_strided", lambda p, a: p.as_strided(a, [2, 3], [4, 1], 1), ["x"]),
    C("tensordot", lambda p, a, b: p.tensordot(a, b, axes=[[2], [0]]),
      ["t", "m45"], True, SUMS),
    C("rank", lambda p, a: p.rank(a), ["t"], False),
    C("shard_index", lambda p, a: p.shard_index(a, 8, 2, 1), ["k"], False),
    C("getitem", lambda p, a: a[1:, ::2], ["x"]),
    C("getitem_mask", lambda p, a, m: a[m], ["x", "b"]),
    C("setitem", lambda p, a, b: (a.__setitem__((0, slice(1, 3)), b[0, :2]),
                                  a * 1.0)[1], ["y", "x"]),
    C("select_scatter", lambda p, a, b: p.select_scatter(a, b, 1, 2),
      ["x", "w"]),

    C("column_stack", lambda p, a, b: p.column_stack([a, b]), ["w", "x"]),
    C("row_stack", lambda p, a, b: p.row_stack([a, b]), ["x", "y"]),
    C("hstack", lambda p, a, b: p.hstack([a, b]), ["x", "y"]),
    C("vstack", lambda p, a, b: p.vstack([a, b]), ["x", "y"]),
    C("dstack", lambda p, a, b: p.dstack([a, b]), ["x", "y"]),
    C("pad_sequences", lambda p: p.pad_sequences([[1, 2, 3], [4]], 9), [],
      False),
]

# ---------------------------------------------------------------------------
# logic / search
# ---------------------------------------------------------------------------
LOGIC = [
    C("equal", lambda p, a, b: p.equal(a, b), ["i", "j"]),
    C("not_equal", lambda p, a: p.not_equal(a, 2), ["i"]),
    C("less_than", lambda p, a, b: p.less_than(a, b), ["x", "y"]),
    C("less_equal", lambda p, a, b: p.less_equal(a, b), ["i", "j"]),
    C("greater_than", lambda p, a: p.greater_than(a, 0.0), ["x"]),
    C("greater_equal", lambda p, a, b: p.greater_equal(a, b), ["i", "j"]),
    C("equal_all", lambda p, a: p.equal_all(a, a * 1), ["i"]),
    C("allclose", lambda p, a, b: p.allclose(a, b), ["x", "y"]),
    C("isclose", lambda p, a: p.isclose(a, a + 1e-6), ["x"]),
    C("is_empty", lambda p, a: p.is_empty(a), ["x"]),
    C("where", lambda p, m, a, b: p.where(m, a, b), ["b", "x", "y"]),
    C("where_scalar", lambda p, m, a: p.where(m, a, 0.5), ["b", "x"]),
    C("where_nonzero", lambda p, m: p.where(m), ["b"]),
    C("is_tensor", lambda p, a: p.is_tensor(a), ["x"], False),
    C("argmax", lambda p, a: p.argmax(a, axis=1), ["ties"]),
    C("argmin", lambda p, a: p.argmin(a, axis=1, keepdim=True), ["ties"]),
    C("argmin_flat", lambda p, a: p.argmin(a), ["x"]),
    C("argsort_stable_ties", lambda p, a: p.argsort(a, axis=1, stable=True),
      ["ties"]),
    C("argsort_descending_ties", lambda p, a: p.argsort(
        a, descending=True), ["ties"]),
    C("sort", lambda p, a: p.sort(a, axis=0, descending=True), ["x"]),
    C("topk", lambda p, a: p.topk(a, 2, axis=1), ["x"]),
    C("topk_smallest", lambda p, a: p.topk(a, 3, largest=False), ["x"]),
    C("nonzero", lambda p, a: p.nonzero(a), ["z"]),
    C("nonzero_tuple", lambda p, a: p.nonzero(a, as_tuple=True), ["z"]),
    C("kthvalue", lambda p, a: p.kthvalue(a, 2, axis=1), ["ties"]),
    C("kthvalue_keepdim", lambda p, a: p.kthvalue(a, 3, axis=0,
                                                  keepdim=True), ["x"]),
    C("mode", lambda p, a: p.mode(a, axis=1), ["ties"], False),
    C("mode_int", lambda p, a: p.mode(a, axis=0), ["s"], False),
    C("searchsorted", lambda p, s, v: p.searchsorted(s, v), ["row", "x"]),
    C("searchsorted_right_int32", lambda p, s, v: p.searchsorted(
        s, v, out_int32=True, right=True), ["row", "x"]),
    C("bucketize", lambda p, a, s: p.bucketize(a, s, right=True),
      ["x", "row"]),
]

# ---------------------------------------------------------------------------
# stat
# ---------------------------------------------------------------------------
STAT = [
    C("std", lambda p, a: p.std(a, axis=1), ["x"], True, SUMS),
    C("std_biased_all", lambda p, a: p.std(a, unbiased=False), ["x"], True,
      SUMS),
    C("var", lambda p, a: p.var(a, axis=[0, 1], keepdim=True), ["x"], True,
      SUMS),
    C("median_even_avg", lambda p, a: p.median(a, axis=1), ["even"]),
    C("median_all", lambda p, a: p.median(a), ["even"]),
    C("median_min_mode", lambda p, a: p.median(a, axis=0, mode="min"),
      ["even"]),
    C("median_keepdim", lambda p, a: p.median(a, axis=0, keepdim=True),
      ["x"]),
    C("nanmedian", lambda p, a: p.nanmedian(a, axis=1), ["n"], False),
    C("quantile", lambda p, a: p.quantile(a, [0.1, 0.5, 0.95], axis=1),
      ["x"]),
    C("quantile_methods", lambda p, a: [p.quantile(
        a, 0.3, axis=0, interpolation=m) for m in
        ("lower", "higher", "midpoint", "nearest")], ["x"]),
    C("quantile_all_keepdim", lambda p, a: p.quantile(a, 0.25, keepdim=True),
      ["x"]),
    C("nanquantile", lambda p, a: p.nanquantile(a, 0.5, axis=1), ["n"],
      False),
    C("histogram", lambda p, a: p.histogram(a, bins=5), ["x"], False),
    C("histogram_range_weight_density", lambda p, a, w: p.histogram(
        a, bins=4, min=-1, max=1, weight=w, density=True), ["x", "q"],
      False),
    C("histogramdd", lambda p, a: (lambda h, e: [h] + list(e))(
        *p.histogramdd(a, bins=3)), ["x"], False),
    C("bincount", lambda p, a: p.bincount(p.reshape(a, [-1]), minlength=10),
      ["k"], False),
    C("bincount_weights", lambda p, a, w: p.bincount(
        p.reshape(a, [-1]), weights=p.reshape(w, [-1])), ["k", "p"], False),
    C("numel", lambda p, a: p.numel(a), ["t"], False),
]

# ---------------------------------------------------------------------------
# creation
# ---------------------------------------------------------------------------
CREATION = [
    C("to_tensor", lambda p, a: p.to_tensor(a), ["x"], False),
    C("zeros", lambda p: p.zeros([2, 3], "int32"), [], False),
    C("ones", lambda p: p.ones([2]), [], False),
    C("full", lambda p: p.full([2, 2], 3), [], False),
    C("zeros_like", lambda p, a: p.zeros_like(a), ["i"], False),
    C("ones_like", lambda p, a: p.ones_like(a, dtype="float64"), ["x"],
      False),
    C("full_like", lambda p, a: p.full_like(a, 2), ["i"], False),
    C("empty", lambda p: p.empty([3]), [], False),
    C("empty_like", lambda p, a: p.empty_like(a), ["x"], False),
    C("arange", lambda p: p.arange(0.0, 1.0, 0.3), [], False),
    C("linspace", lambda p: p.linspace(-1.0, 2.0, 7), [], False),
    C("logspace", lambda p: p.logspace(0.0, 2.0, 5, base=3.0), [], False),
    C("eye", lambda p: p.eye(3, 4), [], False),
    C("diag", lambda p, a: p.diag(a, offset=1), ["v"]),
    C("diag_padding", lambda p, a: p.diag(a, padding_value=7.0), ["v"],
      False),
    C("diag_of_matrix", lambda p, a: p.diag(a, offset=-1), ["m"]),
    C("diagflat", lambda p, a: p.diagflat(a, offset=1), ["x"]),
    C("tril", lambda p, a: p.tril(a, -1), ["m"]),
    C("triu", lambda p, a: p.triu(a, 1), ["x"]),
    C("tril_indices", lambda p: p.tril_indices(4, 3, 1), [], False),
    C("triu_indices", lambda p: p.triu_indices(3, 5, -1), [], False),
    C("meshgrid", lambda p, a, b: p.meshgrid(a, b), ["v", "w"]),
    C("assign", lambda p, a: p.assign(a), ["x"]),
    C("assign_list", lambda p: p.assign([[1.0, 2.0]]), [], False),
    C("clone", lambda p, a: p.clone(a), ["x"]),
    C("complex", lambda p, a, b: p.abs(p.complex(a, b)), ["x", "y"]),
    C("polar", lambda p, a, b: p.real(p.polar(a, b)), ["p", "y"]),
    C("diag_embed", lambda p, a: p.diag_embed(a, offset=1, dim1=0, dim2=2),
      ["x"]),
    C("vander", lambda p, a: p.vander(a, 3, increasing=True), ["v"]),
    C("create_parameter", lambda p: p.create_parameter(
        [2, 3], "float32", default_initializer=p.nn.initializer.Constant(
            0.5)), [], False),
]

# ---------------------------------------------------------------------------
# einsum and extras
# ---------------------------------------------------------------------------
EXTRAS = [
    C("einsum", lambda p, a, b: p.einsum("bij,bjk->bik", a, b), ["t", "t2"],
      True, SUMS),
    C("einsum_trace", lambda p, a: p.einsum("ii", a), ["m"]),
    C("block_diag", lambda p, a, b, c: p.block_diag([a, b, c]),
      ["x", "m", "v"]),
    C("logcumsumexp", lambda p, a: p.logcumsumexp(a, axis=1), ["x"], True,
      SUMS),
    C("is_complex", lambda p, a: p.is_complex(a), ["x"], False),
    C("is_integer", lambda p, a: p.is_integer(a), ["i"], False),
    C("is_floating_point", lambda p, a: p.is_floating_point(a), ["x"],
      False),
    C("isin", lambda p, a, b: p.isin(a, b), ["i", "j"]),
    C("mm", lambda p, a, b: p.mm(a, b), ["x", "m"], True, SUMS),
    C("shape", lambda p, a: p.shape(a), ["t"], False),
    C("cdist", lambda p, a, b: p.cdist(a, b), ["x", "y"], True, SUMS),
    C("cdist_p1", lambda p, a, b: p.cdist(a, b, p=1.0), ["x", "y"], True,
      SUMS),
    C("pdist", lambda p, a: p.pdist(a, p=3.0), ["x"], True, SUMS),
    C("sinc", lambda p, a: p.sinc(a), ["x"]),
    C("gammainc", lambda p, a, b: p.gammainc(a, b), ["p", "g"], False,
      SPECIAL),
    C("gammaincc", lambda p, a, b: p.gammaincc(a, b), ["p", "g"], False,
      SPECIAL),
    C("reduce_as", lambda p, a, b: p.reduce_as(a, b), ["t", "v"]),
    C("increment", lambda p, a: p.increment(a * 1.0, 2.0), ["x"]),
    C("set_printoptions", lambda p, a: (p.set_printoptions(precision=8),
                                        a)[1], ["x"], False),
    C("disable_signal_handler", lambda p, a: (p.disable_signal_handler(),
                                              a)[1], ["x"], False),
    C("check_shape", lambda p, a: p.check_shape(a, [3, 4]), ["x"]),
    C("renorm", lambda p, a: p.renorm(a, 2.0, 0, 1.0), ["x"]),
    C("multigammaln", lambda p, a: p.multigammaln(a, 2), ["g"], True,
      SPECIAL),
    C("take", lambda p, a, i: p.take(a, p.to_tensor([[-1, 3], [11, 0]])),
      ["x", "k"]),
    C("take_wrap", lambda p, a: p.take(a, p.to_tensor([13, -14]),
                                       mode="wrap"), ["x"]),
    C("take_clip", lambda p, a: p.take(a, p.to_tensor([13, -2]),
                                       mode="clip"), ["x"]),
    C("frexp", lambda p, a: p.frexp(a), ["x"], False),
    C("trapezoid", lambda p, a: p.trapezoid(a, dx=0.5, axis=1), ["x"]),
    C("trapezoid_x", lambda p, a, b: p.trapezoid(a, b, axis=0), ["x", "y"]),
    C("cumulative_trapezoid", lambda p, a: p.cumulative_trapezoid(
        a, dx=2.0, axis=1), ["x"]),
    C("unflatten", lambda p, a: p.unflatten(a, 1, [2, -1]), ["x"]),
    C("unfold", lambda p, a: p.unfold(a, 2, 2, 1), ["t"]),
    C("polygamma", lambda p, a: p.polygamma(a, 1), ["p"], True, SPECIAL),
    C("bitwise_left_shift", lambda p, a, b: p.bitwise_left_shift(a, b),
      ["i", "s"]),
    C("bitwise_right_shift_logical", lambda p, a, b: p.bitwise_right_shift(
        a, b, is_arithmetic=False), ["i", "s"]),
    C("bitwise_right_shift_arith", lambda p, a, b: p.bitwise_right_shift(
        a, b), ["i", "s"]),
    C("index_fill", lambda p, a, i: p.index_fill(a, i, 1, -3.0),
      ["x", "idx"]),
    C("diagonal_scatter", lambda p, a, b: p.diagonal_scatter(a, b[:3], 1),
      ["x", "v"]),
    C("combinations", lambda p, a: p.combinations(a, 2), ["v"]),
    C("combinations_replacement", lambda p, a: p.combinations(
        a, 3, with_replacement=True), ["w"]),
    C("signbit", lambda p, a: p.signbit(a), ["x"]),
    C("flops", lambda p: p.flops(p.nn.Sequential(
        p.nn.Conv2D(3, 4, 3), p.nn.ReLU()), [1, 3, 8, 8]), [], False),
    C("LazyGuard", lambda p, a: (p.LazyGuard().__enter__(), a)[1], ["x"],
      False),
    C("batch", lambda p: [p.to_tensor(b) for b in p.batch(
        lambda: iter(range(5)), 2)()], [], False),
]


@pytest.mark.parametrize("fn, ins, grad, tol", MATH)
def test_math(fn, ins, grad, tol):
    _check(fn, ins, grad, tol)


@pytest.mark.parametrize("fn, ins, grad, tol", MANIP)
def test_manipulation(fn, ins, grad, tol):
    _check(fn, ins, grad, tol)


@pytest.mark.parametrize("fn, ins, grad, tol", LOGIC)
def test_logic_and_search(fn, ins, grad, tol):
    _check(fn, ins, grad, tol)


@pytest.mark.parametrize("fn, ins, grad, tol", STAT)
def test_stat(fn, ins, grad, tol):
    _check(fn, ins, grad, tol)


@pytest.mark.parametrize("fn, ins, grad, tol", CREATION)
def test_creation(fn, ins, grad, tol):
    _check(fn, ins, grad, tol)


@pytest.mark.parametrize("fn, ins, grad, tol", EXTRAS)
def test_einsum_and_extras(fn, ins, grad, tol):
    _check(fn, ins, grad, tol)


# names held in another file: linalg's in test_torch_linalg.py, random's in
# test_torch_random.py; and the ones whose cases above carry another id
ELSEWHERE = {"slice_scatter", "index_select", "masked_select", "top_p_sampling", "mean",
             "numel", "logical_and", "logical_or", "logical_not",
             "logical_xor", "reverse"}


def test_every_op_has_a_case():
    ids = set()
    for group in (MATH, MANIP, LOGIC, STAT, CREATION, EXTRAS):
        ids |= {p.id for p in group}
    missing = []
    for mod in ("math", "manipulation", "logic", "search", "stat",
                "creation", "extras"):
        m = importlib.import_module(f"paddle_tpu.tensor.{mod}")
        for name in m.__all__:
            if name.endswith("_") or name in ELSEWHERE:
                continue
            if not any(i == name or i.startswith(name + "_") for i in ids):
                missing.append(f"{mod}.{name}")
    assert not missing, missing


def test_slice_scatter_against_numpy():
    """JAX's ``slice_scatter`` raises (its module's ``slice`` function
    shadows the builtin at paddle_tpu/tensor/manipulation.py:546), so the
    port is held against numpy's assignment, with its gradients."""
    x = tp.to_tensor(IN["x"], stop_gradient=False)
    v = tp.to_tensor(IN["y"][:, :2], stop_gradient=False)
    out = tp.slice_scatter(x, v, [1], [0], [4], [2])
    want = IN["x"].copy()
    want[:, 0:4:2] = IN["y"][:, :2]
    np.testing.assert_array_equal(out.numpy(), want)
    out.sum().backward()
    gx = np.ones_like(IN["x"])
    gx[:, 0:4:2] = 0
    np.testing.assert_array_equal(x.grad.numpy(), gx)
    np.testing.assert_array_equal(v.grad.numpy(), np.ones((3, 2)))
    with pytest.raises(TypeError):
        jp.slice_scatter(jp.to_tensor(IN["x"]), jp.to_tensor(IN["y"][:, :2]),
                         [1], [0], [4], [2])
