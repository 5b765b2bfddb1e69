"""The tensor-op sweep: every public function of the tensor surface, the
linalg namespace and nn's activations, called on one device and held
against the same call on the CPU from the same numpy inputs; and the nn
families of the nn slice (``nn_cases``: losses, norms, pads, resampling,
pools with masks and unpools, transposed convolutions, fold / unfold,
shuffles and the long tail), one realistic shape a family, with the
dropouts held by their laws (``nn_laws``).

``chip_smoke.py``'s ``api_ops`` phase runs it on the card at the serving
widths (elementwise ops and reductions at [2048, 4096] f32, sorts and
searches over 4096-wide rows, linear algebra batched at [8, 256, 256]),
and ``tests/test_torch_api_ops_cuda.py`` at a small size.  Each case is
``(name, family, fn(paddle, *tensors), inputs, grad)``; a family has one
bound on the largest error over the largest |value| of the CPU's output
(``BOUNDS``), and integer and bool outputs must be equal.  Where ``grad``
is set the gradients of ``sum(out * g)`` by each float input are held to
the same bound.  ``EXTRA_CHECKS`` hold what CUDA is known to do its own
way (ties, duplicate indices, a rank-deficient ``lstsq``, a logical shift
of negative ints, an even-count median, the random ops' laws and seeds).
"""

from __future__ import annotations

import math
import time
from typing import Callable, Dict, List, NamedTuple, Sequence

import numpy as np
import torch

__all__ = ["Case", "BOUNDS", "make_inputs", "cases", "run_case",
           "compare", "sweep", "extra_checks", "bf16_lane", "rng_checks",
           "dispatch_cost", "required_names", "NN_SIZES", "nn_inputs",
           "nn_cases", "nn_coverage", "nn_laws"]

# the largest error over the largest |value| of the CPU's result, by
# family (TF32 off): elementwise ops are a few ulp apart between CUDA's
# and the CPU's libm; sums, scans and products order their terms
# differently; the special functions use other series; the f32
# factorizations of 256 x 256 matrices agree to their condition number
BOUNDS = {"exact": 0.0, "elementwise": 1e-5, "special": 1e-4,
          "reduction": 1e-4, "scan": 1e-4, "product": 1e-4,
          "linalg": 2e-3, "activation": 1e-5,
          # the nn families: the losses' reductions over a [4096, 32000]
          # batch and the norms' statistics over a feature map order their
          # sums differently; the resampling matrices and the transposed
          # convolutions sum hundreds of products (TF32 off); the pools,
          # pads, fold / unfold and the long tail's gathers are copies or
          # short sums
          "loss": 1e-4, "norm": 1e-4, "resample": 1e-4, "conv": 1e-4,
          "pool": 1e-5, "pad": 1e-5, "nn_misc": 1e-4,
          # CTC's and RNN-T's forward recursions: hundreds of log-sum-exp
          # steps in sequence (RNN-T's 100 x 21 lattice), each rounding
          "recursion": 1e-3}


class Case(NamedTuple):
    name: str
    family: str
    fn: Callable
    inputs: Sequence[str]
    grad: bool


class _Draws:
    """numpy's RandomState methods the inputs use, drawn by a seeded torch
    CPU generator (numpy's own takes seconds for the [2048, 4096] ones)."""

    def __init__(self, seed):
        self.g = torch.Generator().manual_seed(seed)

    def randn(self, *shape):
        return torch.randn(shape, generator=self.g,
                           dtype=torch.float64).numpy()

    def rand(self, *shape):
        return torch.rand(shape, generator=self.g,
                          dtype=torch.float64).numpy()

    def uniform(self, lo, hi, shape):
        return lo + (hi - lo) * self.rand(*shape)

    def randint(self, lo, hi, shape):
        shape = (shape,) if isinstance(shape, int) else tuple(shape)
        return torch.randint(lo, hi, shape, generator=self.g).numpy()


def make_inputs(rows=2048, cols=4096, mat=256, batch=8, small=64, seed=0):
    """The sweep's inputs, numpy arrays drawn from ``seed``: [rows, cols]
    elementwise operands of each domain, 4096-wide rows with ties, [batch,
    mat, mat] matrices (general, SPD, symmetric), small ones for the ops
    whose cost grows with the square of their size."""
    r = _Draws(seed)
    f = np.float32
    big = (rows, cols)
    a = (r.randn(batch, mat, mat) / np.sqrt(mat)).astype(f)
    spd = (a @ np.swapaxes(a, -1, -2) + np.eye(mat, dtype=f)).astype(f)
    tall = r.randn(2 * mat, mat).astype(f)
    half = mat // 2
    # reflectors and scales of a real QR (LAPACK's geqrf layout), so that
    # householder_product and ormqr multiply by an orthogonal Q
    hh, hh_tau = torch.geqrf(torch.from_numpy(tall.astype(np.float64)))
    ins = {
        "x": r.randn(*big).astype(f), "y": r.randn(*big).astype(f),
        "p": (r.rand(*big) + 0.5).astype(f),
        "o": r.uniform(0.05, 0.95, big).astype(f),
        "u": r.uniform(-0.9, 0.9, big).astype(f),
        "g": r.uniform(1.1, 3.0, big).astype(f),
        "i": r.randint(-60, 61, big).astype(np.int32),
        "j": r.randint(1, 16, big).astype(np.int32),
        "s": r.randint(0, 8, big).astype(np.int32),
        "k": r.randint(0, 8, big).astype(np.int64),
        "b": r.rand(*big) > 0.5, "c": r.rand(*big) > 0.5,
        "ties": r.randint(0, 8, big).astype(f),
        "z": np.where(r.rand(*big) > 0.7, r.randn(*big), 0).astype(f),
        "n": np.where(r.rand(*big) > 0.9, np.nan, r.randn(*big)).astype(f),
        "v": r.randn(cols).astype(f), "w": r.randn(rows).astype(f),
        "row": np.sort(r.randn(cols)).astype(f),
        "idx": r.randint(0, rows, 1024).astype(np.int64),
        "cidx": r.randint(0, cols, 256).astype(np.int64),
        "upd": r.randn(1024, cols).astype(f),
        "pos": r.randint(0, cols, big).astype(np.int64),
        "nd": np.stack([r.randint(0, rows, 512), r.randint(0, cols, 512)],
                       -1).astype(np.int64),
        "w512": r.randn(512).astype(f),
        "sm": r.randn(small, small).astype(f),
        "sm2": r.randn(small, small).astype(f),
        "sv": r.randn(small).astype(f), "sv2": r.randn(small).astype(f),
        "m": a, "spd": spd, "sym": (a + np.swapaxes(a, -1, -2)).astype(f),
        "mb": r.randn(batch, mat, 16).astype(f), "tall": tall,
        "tall_b": r.randn(2 * mat, 8).astype(f),
        "def": np.concatenate([tall[:, :half], tall[:, :half] * 2.0], 1),
        "tau": r.rand(mat).astype(f),
        "hh": hh.numpy().astype(f), "hh_tau": hh_tau.numpy().astype(f),
        "cplx": r.randn(rows, cols, 2).astype(f),
        "t3": r.randn(batch, mat, small).astype(f),
    }
    return ins


def _c(name, family, fn, inputs, grad=True):
    return Case(name, family, fn, tuple(inputs), grad)


_UNARY = [  # (name, input, family)
    ("exp", "x", "elementwise"), ("expm1", "x", "elementwise"),
    ("log", "p", "elementwise"), ("log2", "p", "elementwise"),
    ("log10", "p", "elementwise"), ("log1p", "p", "elementwise"),
    ("sqrt", "p", "elementwise"), ("rsqrt", "p", "elementwise"),
    ("square", "x", "elementwise"), ("abs", "x", "elementwise"),
    ("ceil", "x", "elementwise"), ("floor", "x", "elementwise"),
    ("round", "x", "elementwise"), ("trunc", "x", "elementwise"),
    ("sin", "x", "elementwise"), ("cos", "x", "elementwise"),
    ("tan", "u", "elementwise"), ("asin", "u", "elementwise"),
    ("acos", "u", "elementwise"), ("atan", "x", "elementwise"),
    ("sinh", "x", "elementwise"), ("cosh", "x", "elementwise"),
    ("tanh", "x", "elementwise"), ("asinh", "x", "elementwise"),
    ("acosh", "g", "elementwise"), ("atanh", "u", "elementwise"),
    ("erf", "x", "elementwise"), ("erfinv", "u", "special"),
    ("reciprocal", "p", "elementwise"), ("sign", "x", "elementwise"),
    ("sgn", "x", "elementwise"), ("neg", "x", "elementwise"),
    ("negative", "x", "elementwise"), ("conj", "x", "elementwise"),
    ("angle", "x", "elementwise"), ("real", "x", "elementwise"),
    ("imag", "x", "elementwise"), ("deg2rad", "x", "elementwise"),
    ("rad2deg", "x", "elementwise"), ("frac", "x", "elementwise"),
    ("digamma", "p", "special"), ("lgamma", "p", "special"),
    ("gammaln", "p", "special"), ("sigmoid", "x", "elementwise"),
    ("logit", "o", "elementwise"), ("i0", "x", "special"),
    ("i0e", "x", "special"), ("i1", "x", "special"), ("i1e", "x", "special"),
    ("isnan", "n", "exact"), ("isinf", "n", "exact"),
    ("isfinite", "n", "exact"), ("isneginf", "n", "exact"),
    ("isposinf", "n", "exact"), ("isreal", "x", "exact"),
    ("bitwise_not", "i", "exact"), ("logical_not", "b", "exact"),
    # sinc's gradient cancels near 0 in f32 (the quotient rule, JAX's
    # too): CUDA's and the CPU's sin / cos ulps become 1e-4 of its largest
    # value there, so the sweep holds it on [0.5, 1.5)
    ("sinc", "p", "elementwise"), ("signbit", "x", "exact"),
]
_BINARY = [  # (name, x, y, family)
    ("add", "x", "y", "elementwise"), ("subtract", "x", "y", "elementwise"),
    ("multiply", "x", "y", "elementwise"), ("divide", "x", "p", "elementwise"),
    ("floor_divide", "i", "j", "exact"), ("mod", "i", "j", "exact"),
    ("remainder", "x", "p", "elementwise"), ("floor_mod", "i", "j", "exact"),
    ("fmod", "x", "p", "elementwise"), ("pow", "p", "y", "elementwise"),
    ("maximum", "x", "y", "elementwise"), ("minimum", "x", "y", "elementwise"),
    ("fmax", "n", "x", "elementwise"), ("fmin", "n", "x", "elementwise"),
    ("atan2", "x", "y", "elementwise"), ("hypot", "x", "y", "elementwise"),
    ("heaviside", "z", "y", "elementwise"), ("gcd", "i", "j", "exact"),
    ("lcm", "i", "j", "exact"), ("copysign", "x", "y", "elementwise"),
    ("ldexp", "x", "s", "elementwise"),
    ("logaddexp", "x", "y", "elementwise"),
    ("bitwise_and", "i", "j", "exact"), ("bitwise_or", "i", "j", "exact"),
    ("bitwise_xor", "i", "j", "exact"), ("logical_and", "b", "c", "exact"),
    ("logical_or", "b", "c", "exact"), ("logical_xor", "b", "c", "exact"),
    ("left_shift", "i", "s", "exact"), ("right_shift", "i", "s", "exact"),
    ("divide_no_nan", "x", "z", "elementwise"),
    ("equal", "i", "j", "exact"), ("not_equal", "i", "j", "exact"),
    ("less_than", "x", "y", "exact"), ("less_equal", "i", "j", "exact"),
    ("greater_than", "x", "y", "exact"), ("greater_equal", "i", "j", "exact"),
    ("isclose", "x", "y", "exact"), ("isin", "s", "j", "exact"),
    ("gammainc", "p", "g", "special"), ("gammaincc", "p", "g", "special"),
    ("bitwise_left_shift", "i", "s", "exact"),
]
_NO_GRAD = {"nextafter", "gammainc", "gammaincc"}


def _unary(name):
    return lambda p, a: getattr(p, name)(a)


def _binary(name):
    return lambda p, a, b: getattr(p, name)(a, b)


def _sweep_table(R, C) -> List[Case]:
    """The cases for [R, C] elementwise operands."""
    out = [_c(n, fam, _unary(n), [x], fam != "exact")
           for n, x, fam in _UNARY]
    out += [_c(n, fam, _binary(n), [x, y], fam != "exact" and
               n not in _NO_GRAD) for n, x, y, fam in _BINARY]
    E, RD, SC, X = "elementwise", "reduction", "scan", "exact"
    PR, LA, SP = "product", "linalg", "special"
    out += [
        _c("nextafter", E, _binary("nextafter"), ["x", "y"], False),
        _c("scale", E, lambda p, a: p.scale(a, 2.0, 0.5), ["x"]),
        _c("clip", E, lambda p, a: p.clip(a, -0.5, 0.7), ["x"]),
        _c("lerp", E, lambda p, a, b: p.lerp(a, b, 0.3), ["x", "y"]),
        _c("stanh", E, lambda p, a: p.stanh(a), ["x"]),
        _c("nan_to_num", E, lambda p, a: p.nan_to_num(a, 1.5), ["n"], False),
        _c("add_n", E, lambda p, a, b, c: p.add_n([a, b, c]),
           ["x", "y", "p"]),
        _c("count_nonzero", X, lambda p, a: p.count_nonzero(a, axis=1),
           ["z"]),
        _c("sum", RD, lambda p, a: p.sum(a, axis=1), ["x"]),
        _c("prod", RD, lambda p, a: p.prod(a[:, :64], axis=1), ["p"]),
        _c("max", X, lambda p, a: p.max(a, axis=1), ["x"]),
        _c("min", X, lambda p, a: p.min(a, axis=0), ["x"]),
        _c("amax", X, lambda p, a: p.amax(a, axis=[0, 1]), ["x"]),
        _c("amin", X, lambda p, a: p.amin(a, axis=1, keepdim=True), ["x"]),
        _c("all", X, lambda p, a: p.all(a, axis=1), ["b"]),
        _c("any", X, lambda p, a: p.any(a, axis=0), ["b"]),
        _c("nansum", RD, lambda p, a: p.nansum(a, axis=1), ["n"], False),
        _c("nanmean", RD, lambda p, a: p.nanmean(a, axis=1), ["n"], False),
        _c("mean", RD, lambda p, a: p.mean(a, axis=1), ["x"]),
        _c("logsumexp", RD, lambda p, a: p.logsumexp(a, axis=1), ["x"]),
        _c("log_normalize", RD, lambda p, a: p.log_normalize(a), ["x"]),
        _c("cumsum", SC, lambda p, a: p.cumsum(a, axis=1), ["x"]),
        _c("cumprod", SC, lambda p, a: p.cumprod(a[:, :64], dim=1), ["p"]),
        _c("cummax", X, lambda p, a: p.cummax(a, axis=1), ["ties"], False),
        _c("cummin", X, lambda p, a: p.cummin(a, axis=1), ["ties"], False),
        _c("logcumsumexp", SC, lambda p, a: p.logcumsumexp(a, axis=1),
           ["x"]),
        _c("diff", E, lambda p, a: p.diff(a, axis=1), ["x"]),
        _c("addmm", PR, lambda p, i, a, b: p.addmm(i, a, b, 0.5, 2.0),
           ["sm", "sm", "sm2"]),
        _c("inner", PR, lambda p, a, b: p.inner(a, b), ["sm", "sm2"]),
        _c("outer", E, lambda p, a, b: p.outer(a, b), ["v", "w"]),
        _c("kron", E, lambda p, a, b: p.kron(a, b), ["sm", "sm2"]),
        _c("trace", RD, lambda p, a: p.trace(a), ["x"]),
        _c("diagonal", E, lambda p, a: p.diagonal(a, 1), ["x"]),
        _c("multiplex", E, lambda p, a, b: p.multiplex(
            [a, b], p.to_tensor(np.arange(a.shape[0]).reshape(-1, 1) % 2,
                                place=a.place)), ["x", "y"]),
        # manipulation
        _c("reshape", E, lambda p, a: p.reshape(a, [-1, C // 4]), ["x"]),
        _c("flatten", E, lambda p, a: p.flatten(a), ["t3"]),
        _c("transpose", E, lambda p, a: p.transpose(a, [1, 0]), ["x"]),
        _c("permute", E, lambda p, a: p.permute(a, [2, 0, 1]), ["t3"]),
        _c("squeeze", E, lambda p, a: p.squeeze(p.unsqueeze(a, 0)), ["x"]),
        _c("unsqueeze", E, lambda p, a: p.unsqueeze(a, [0, 2]), ["x"]),
        _c("concat", E, lambda p, a, b: p.concat([a, b], 1), ["x", "y"]),
        _c("stack", E, lambda p, a, b: p.stack([a, b], 0), ["x", "y"]),
        _c("split", E, lambda p, a: p.split(a, [C // 4, -1], 1), ["x"]),
        _c("tensor_split", E, lambda p, a: p.tensor_split(a, 3, 1), ["x"]),
        _c("vsplit", E, lambda p, a: p.vsplit(a, 2), ["x"]),
        _c("hsplit", E, lambda p, a: p.hsplit(a, 4), ["x"]),
        _c("dsplit", E, lambda p, a: p.dsplit(a, 2), ["t3"]),
        _c("chunk", E, lambda p, a: p.chunk(a, 4, 0), ["x"]),
        _c("unstack", E, lambda p, a: p.unstack(a, 0), ["m"]),
        _c("unbind", E, lambda p, a: p.unbind(a, 2), ["mb"]),
        _c("tile", E, lambda p, a: p.tile(a, [2, 1]), ["x"]),
        _c("expand", E, lambda p, a: p.expand(a, [R, -1]), ["v"]),
        _c("expand_as", E, lambda p, a, b: p.expand_as(a, b), ["v", "x"]),
        _c("broadcast_to", E, lambda p, a: p.broadcast_to(a, [2, R, C]),
           ["x"]),
        _c("broadcast_tensors", E, lambda p, a, b: p.broadcast_tensors(
            [a, p.reshape(b, [1, -1])]), ["x", "v"]),
        _c("gather", E, lambda p, a, i: p.gather(a, i, 0), ["x", "idx"]),
        _c("gather_nd", E, lambda p, a, i: p.gather_nd(a, i), ["x", "nd"]),
        _c("scatter", E, lambda p, a, i, u: p.scatter(a, i, u),
           ["x", "idx", "upd"]),
        _c("scatter_add", E, lambda p, a, i, u: p.scatter(
            a, i, u, overwrite=False), ["x", "idx", "upd"], False),
        _c("scatter_nd", E, lambda p, i, u: p.scatter_nd(i, u, [R, C]),
           ["nd", "w512"], False),
        _c("scatter_nd_add", E, lambda p, a, i, u: p.scatter_nd_add(a, i, u),
           ["x", "nd", "w512"], False),
        _c("index_select", E, lambda p, a, i: p.index_select(a, i, 1),
           ["x", "cidx"]),
        _c("index_sample", E, lambda p, a, i: p.index_sample(a, i),
           ["x", "pos"]),
        _c("index_add", E, lambda p, a, i, u: p.index_add(a, i, 0, u),
           ["x", "idx", "upd"], False),
        _c("index_put", E, lambda p, a, i, u: p.index_put(a, (i,), u),
           ["x", "idx", "upd"]),
        _c("masked_select", E, lambda p, a, m: p.masked_select(a, m),
           ["x", "b"]),
        _c("masked_fill", E, lambda p, a, m: p.masked_fill(a, m, 2.0),
           ["x", "b"]),
        _c("masked_scatter", E, lambda p, a, m, b: p.masked_scatter(a, m, b),
           ["x", "b", "y"]),
        _c("roll", E, lambda p, a: p.roll(a, [3, -7], [0, 1]), ["x"]),
        _c("flip", E, lambda p, a: p.flip(a, [1]), ["x"]),
        _c("reverse", E, lambda p, a: p.reverse(a, 0), ["x"]),
        _c("rot90", E, lambda p, a: p.rot90(a), ["x"]),
        _c("unique", X, lambda p, a: p.unique(a, return_index=True,
                                              return_inverse=True,
                                              return_counts=True), ["ties"],
           False),
        _c("unique_consecutive", X, lambda p, a: p.unique_consecutive(
            a, return_inverse=True, return_counts=True), ["ties"], False),
        _c("repeat_interleave", E, lambda p, a: p.repeat_interleave(a, 2, 0),
           ["x"]),
        _c("take_along_axis", E, lambda p, a, i: p.take_along_axis(a, i, 1),
           ["x", "pos"]),
        _c("put_along_axis", E, lambda p, a, i, b: p.put_along_axis(
            a, i, b, 1), ["x", "pos", "y"], False),
        _c("put_along_axis_add", E, lambda p, a, i, b: p.put_along_axis(
            a, i, b, 1, reduce="add"), ["x", "pos", "y"], False),
        _c("slice", E, lambda p, a: p.slice(a, [0, 1], [5, 7], [R // 2, C - 9]),
           ["x"]),
        _c("strided_slice", E, lambda p, a: p.strided_slice(
            a, [0, 1], [0, C - 7], [R, 0], [3, -5]), ["x"]),
        _c("moveaxis", E, lambda p, a: p.moveaxis(a, 0, 2), ["t3"]),
        _c("swapaxes", E, lambda p, a: p.swapaxes(a, 0, 1), ["x"]),
        _c("as_real", E, lambda p, a: p.as_real(p.as_complex(a)), ["cplx"]),
        _c("as_complex", E, lambda p, a: p.imag(p.as_complex(a)), ["cplx"]),
        _c("cast", X, lambda p, a: p.cast(a, "int32"), ["x"], False),
        _c("astype", E, lambda p, a: a.astype("float64"), ["x"]),
        _c("crop", E, lambda p, a: p.crop(a, [R // 4, -1], [5, 0]), ["x"]),
        _c("t", E, lambda p, a: p.t(a), ["x"]),
        _c("atleast_1d", E, lambda p, a: p.atleast_1d(p.sum(a)), ["sm"]),
        _c("atleast_2d", E, lambda p, a: p.atleast_2d(a), ["v"]),
        _c("atleast_3d", E, lambda p, a: p.atleast_3d(a), ["x"]),
        _c("view", E, lambda p, a: p.view(a, [C, R]), ["x"]),
        _c("view_as", E, lambda p, a, b: p.view_as(a, b), ["x", "y"]),
        _c("as_strided", E, lambda p, a: p.as_strided(a, [R // 4, 64], [64, 1],
                                                      3), ["x"]),
        _c("tensordot", PR, lambda p, a, b: p.tensordot(a, b, [[1], [0]]),
           ["sm", "sm2"]),
        _c("rank", X, lambda p, a: p.rank(a), ["x"], False),
        _c("shard_index", X, lambda p, a: p.shard_index(a, 8, 2, 1), ["k"],
           False),
        _c("getitem", E, lambda p, a: a[5:R // 2:3, ::2], ["x"]),
        _c("select_scatter", E, lambda p, a, b: p.select_scatter(a, b, 1, 5),
           ["x", "w"]),
        _c("slice_scatter", E, lambda p, a, b: p.slice_scatter(
            a, b[:, :C // 2], [1], [0], [C], [2]), ["x", "y"]),
        _c("diagonal_scatter", E, lambda p, a, b: p.diagonal_scatter(
            a, b[:min(R, C - 1)], 1), ["x", "v"]),
        _c("column_stack", E, lambda p, a, b: p.column_stack([a, b]),
           ["w", "x"]),
        _c("row_stack", E, lambda p, a, b: p.row_stack([a, b]), ["x", "y"]),
        _c("hstack", E, lambda p, a, b: p.hstack([a, b]), ["x", "y"]),
        _c("vstack", E, lambda p, a, b: p.vstack([a, b]), ["x", "y"]),
        _c("dstack", E, lambda p, a, b: p.dstack([a, b]), ["x", "y"]),
        _c("unflatten", E, lambda p, a: p.unflatten(a, 1, [64, -1]), ["x"]),
        _c("unfold", E, lambda p, a: p.unfold(a, 1, 8, 4), ["x"]),
        _c("take", E, lambda p, a, i: p.take(a, i), ["x", "idx"]),
        _c("block_diag", E, lambda p, a, b: p.block_diag([a, b]),
           ["sm", "sm2"]),
        _c("combinations", E, lambda p, a: p.combinations(a, 2), ["sv"]),
        _c("index_fill", E, lambda p, a, i: p.index_fill(a, i, 1, -2.0),
           ["x", "cidx"]),
        _c("reduce_as", RD, lambda p, a, b: p.reduce_as(a, b), ["x", "v"]),
        _c("renorm", RD, lambda p, a: p.renorm(a, 2.0, 0, 10.0), ["x"]),
        _c("multigammaln", SP, lambda p, a: p.multigammaln(a, 2), ["g"]),
        _c("polygamma", SP, lambda p, a: p.polygamma(a, 1), ["p"]),
        _c("frexp", X, lambda p, a: p.frexp(a), ["x"], False),
        _c("trapezoid", RD, lambda p, a: p.trapezoid(a, dx=0.5), ["x"]),
        _c("cumulative_trapezoid", SC, lambda p, a:
           p.cumulative_trapezoid(a), ["x"]),
        _c("bitwise_right_shift", X, lambda p, a, b: p.bitwise_right_shift(
            a, b, is_arithmetic=False), ["i", "s"]),
        _c("increment", E, lambda p, a: p.increment(a * 1.0, 2.0), ["x"]),
        _c("cdist", PR, lambda p, a, b: p.cdist(a, b), ["x", "y"], False),
        _c("cdist_p1", PR, lambda p, a, b: p.cdist(a, b, p=1.0),
           ["sm", "sm2"]),
        _c("pdist", PR, lambda p, a: p.pdist(a, p=3.0), ["sm"]),
        _c("mm", PR, lambda p, a, b: p.mm(a, p.transpose(b, [1, 0])),
           ["x", "y"], False),
        _c("matmul", PR, lambda p, a, b: p.matmul(a, b), ["m", "mb"]),
        _c("dot", PR, lambda p, a, b: p.dot(a, b), ["x", "y"]),
        _c("bmm", PR, lambda p, a, b: p.bmm(a, b), ["m", "mb"]),
        _c("mv", PR, lambda p, a, b: p.mv(a, b), ["x", "v"]),
        _c("einsum", PR, lambda p, a, b: p.einsum("bij,bjk->bik", a, b),
           ["m", "mb"]),
        # logic / search
        _c("equal_all", X, lambda p, a: p.equal_all(a, a * 1), ["i"]),
        _c("allclose", X, lambda p, a, b: p.allclose(a, b), ["x", "y"]),
        _c("is_empty", X, lambda p, a: p.is_empty(a), ["x"]),
        _c("where", E, lambda p, m, a, b: p.where(m, a, b), ["b", "x", "y"]),
        _c("argmax", X, lambda p, a: p.argmax(a, axis=1), ["ties"]),
        _c("argmin", X, lambda p, a: p.argmin(a, axis=0), ["ties"]),
        _c("argsort", X, lambda p, a: p.argsort(a, axis=1, stable=True),
           ["ties"]),
        _c("argsort_descending", X, lambda p, a: p.argsort(
            a, axis=1, descending=True), ["ties"]),
        _c("sort", E, lambda p, a: p.sort(a, axis=1), ["x"]),
        _c("topk", E, lambda p, a: p.topk(a, 16, axis=1), ["x"]),
        _c("nonzero", X, lambda p, a: p.nonzero(a), ["z"]),
        _c("kthvalue", E, lambda p, a: p.kthvalue(a, 100, axis=1), ["x"]),
        _c("kthvalue_ties", X, lambda p, a: p.kthvalue(a, C // 2, axis=1),
           ["ties"], False),
        _c("mode", X, lambda p, a: p.mode(a, axis=1), ["ties"], False),
        _c("searchsorted", X, lambda p, s, v: p.searchsorted(s, v),
           ["row", "x"]),
        _c("bucketize", X, lambda p, a, s: p.bucketize(a, s, right=True),
           ["x", "row"]),
        # stat
        _c("std", RD, lambda p, a: p.std(a, axis=1), ["x"]),
        _c("var", RD, lambda p, a: p.var(a, axis=0), ["x"]),
        _c("median", E, lambda p, a: p.median(a, axis=1), ["x"]),
        _c("median_ties", X, lambda p, a: p.median(a, axis=1), ["ties"],
           False),
        _c("nanmedian", E, lambda p, a: p.nanmedian(a, axis=1), ["n"],
           False),
        _c("quantile", E, lambda p, a: p.quantile(a, [0.1, 0.5, 0.9], axis=1),
           ["x"]),
        _c("nanquantile", E, lambda p, a: p.nanquantile(a, 0.3, axis=1),
           ["n"], False),
        _c("histogram", X, lambda p, a: p.histogram(a, bins=64), ["x"],
           False),
        _c("histogramdd", E, lambda p, a: list(p.histogramdd(
            a[:, :2], bins=8)[1]) + [p.histogramdd(a[:, :2], bins=8)[0]],
           ["x"], False),
        _c("bincount", X, lambda p, a: p.bincount(p.reshape(a, [-1])),
           ["k"], False),
        _c("numel", X, lambda p, a: p.numel(a), ["x"], False),
        # creation
        _c("zeros_like", X, lambda p, a: p.zeros_like(a), ["x"], False),
        _c("ones_like", X, lambda p, a: p.ones_like(a), ["x"], False),
        _c("full_like", X, lambda p, a: p.full_like(a, 3), ["i"], False),
        _c("empty_like", X, lambda p, a: p.empty_like(a), ["x"], False),
        _c("zeros", X, lambda p: p.zeros([R, C]), [], False),
        _c("ones", X, lambda p: p.ones([R, C], "int32"), [], False),
        _c("full", X, lambda p: p.full([R, C], 7), [], False),
        _c("empty", X, lambda p: p.empty([R, C]), [], False),
        _c("arange", X, lambda p: p.arange(0, R * C), [], False),
        _c("linspace", E, lambda p: p.linspace(-3.0, 5.0, C), [], False),
        _c("logspace", E, lambda p: p.logspace(0.0, 3.0, C), [], False),
        _c("eye", X, lambda p: p.eye(R, C), [], False),
        _c("diag", E, lambda p, a: p.diag(a, 1), ["v"]),
        _c("diagflat", E, lambda p, a: p.diagflat(a), ["sm"]),
        _c("diag_embed", E, lambda p, a: p.diag_embed(a), ["sm"]),
        _c("tril", E, lambda p, a: p.tril(a, -3), ["x"]),
        _c("triu", E, lambda p, a: p.triu(a, 5), ["x"]),
        _c("tril_indices", X, lambda p: p.tril_indices(512, 256, 2), [],
           False),
        _c("triu_indices", X, lambda p: p.triu_indices(256, 512, -2), [],
           False),
        _c("meshgrid", E, lambda p, a, b: p.meshgrid(a, b), ["v", "w"]),
        _c("assign", E, lambda p, a: p.assign(a), ["x"]),
        _c("clone", E, lambda p, a: p.clone(a), ["x"]),
        _c("complex", E, lambda p, a, b: p.abs(p.complex(a, b)), ["x", "y"]),
        _c("polar", E, lambda p, a, b: p.real(p.polar(a, b)), ["p", "y"]),
        _c("vander", E, lambda p, a: p.vander(a, 6), ["sv"]),
        _c("to_tensor", X, lambda p, a: p.to_tensor(a, place=a.place),
           ["x"], False),
        _c("tolist", X, lambda p, a: p.to_tensor(p.tolist(a[:8, :8]),
                                                 place=a.place), ["i"],
           False),
        _c("shape", X, lambda p, a: p.shape(a), ["x"], False),
        _c("create_parameter", X, lambda p: p.create_parameter(
            [256, 256], "float32",
            default_initializer=p.nn.initializer.Constant(0.5)), [], False),
        # linalg: unique results
        _c("norm", RD, lambda p, a: p.linalg.norm(a), ["x"]),
        _c("norm_axis", RD, lambda p, a: p.linalg.norm(a, p=1, axis=1),
           ["x"]),
        _c("vector_norm", RD, lambda p, a: p.linalg.vector_norm(
            a, p=3.0, axis=0), ["x"]),
        _c("matrix_norm", LA, lambda p, a: p.linalg.matrix_norm(a, p="nuc"),
           ["m"], False),
        _c("dist", RD, lambda p, a, b: p.linalg.dist(a, b), ["x", "y"]),
        _c("cross", E, lambda p, a, b: p.linalg.cross(a[:, :3], b[:, :3]),
           ["x", "y"]),
        _c("cholesky", LA, lambda p, a: p.linalg.cholesky(a), ["spd"]),
        _c("cholesky_solve", LA, lambda p, b, a: p.linalg.cholesky_solve(
            b, p.linalg.cholesky(a)), ["mb", "spd"]),
        _c("inv", LA, lambda p, a: p.linalg.inv(a), ["spd"]),
        _c("inverse", LA, lambda p, a: p.inverse(a), ["spd"], False),
        _c("det", LA, lambda p, a: p.linalg.det(a), ["spd"]),
        _c("slogdet", LA, lambda p, a: p.linalg.slogdet(a), ["m"]),
        _c("solve", LA, lambda p, a, b: p.linalg.solve(a, b), ["spd", "mb"]),
        _c("triangular_solve", LA, lambda p, a, b: p.linalg.triangular_solve(
            p.triu(a) + p.eye(a.shape[-1]).to(a.place) * 2.0, b),
           ["m", "mb"]),
        _c("pinv", LA, lambda p, a: p.linalg.pinv(a), ["tall"], False),
        _c("matrix_power", LA, lambda p, a: p.linalg.matrix_power(a, 3),
           ["m"]),
        _c("matrix_rank", X, lambda p, a: p.linalg.matrix_rank(a), ["def"],
           False),
        _c("cond", LA, lambda p, a: p.linalg.cond(a), ["spd"], False),
        _c("lu", LA, lambda p, a: p.linalg.lu(a)[0], ["spd"], False),
        _c("lu_pivots", X, lambda p, a: p.linalg.lu(a, get_infos=True)[1:],
           ["spd"], False),
        _c("lu_unpack", LA, lambda p, a: p.linalg.lu_unpack(
            *p.linalg.lu(a)), ["spd"], False),
        _c("corrcoef", LA, lambda p, a: p.linalg.corrcoef(a), ["tall"]),
        _c("cov", LA, lambda p, a: p.linalg.cov(a), ["tall"]),
        _c("householder_product", LA, lambda p, a, t:
           p.linalg.householder_product(a, t), ["hh", "hh_tau"], False),
        _c("ormqr", LA, lambda p, a, t, b: p.linalg.ormqr(a, t, b),
           ["hh", "hh_tau", "tall_b"], False),
        _c("multi_dot", PR, lambda p, a, b, c: p.linalg.multi_dot(
            [a, b, c]), ["sm", "sm2", "sm"]),
        _c("matrix_exp", LA, lambda p, a: p.linalg.matrix_exp(a), ["m"],
           False),
        _c("cholesky_inverse", LA, lambda p, a: p.linalg.cholesky_inverse(
            p.linalg.cholesky(a)), ["spd"], False),
        _c("eigvalsh", LA, lambda p, a: p.linalg.eigvalsh(a), ["sym"]),
        _c("lstsq", LA, lambda p, a, b: p.linalg.lstsq(a, b), ["tall",
                                                           "tall_b"],
           False),
        _c("lstsq_rank_deficient", LA, lambda p, a, b: p.linalg.lstsq(a, b),
           ["def", "tall_b"], False),
        _c("svd_values", LA, lambda p, a: p.linalg.svd(a)[1], ["m"], False),
        _c("svd_lowrank", LA, lambda p, a: p.linalg.svd_lowrank(a, 4)[1],
           ["tall"], False),
        _c("pca_lowrank", LA, lambda p, a: p.linalg.pca_lowrank(a, 4)[1],
           ["tall"], False),
    ]
    # nn.functional's activations
    A = "activation"
    acts = {
        "relu6": (), "leaky_relu": (0.2,), "elu": (0.7,), "selu": (),
        "celu": (1.3,), "swish": (), "mish": (), "hardshrink": (0.8,),
        "hardsigmoid": (), "hardswish": (), "hardtanh": (-2.0, 1.5),
        "softshrink": (0.4,), "softsign": (), "tanhshrink": (),
        "thresholded_relu": (0.5, -1.0), "log_sigmoid": (),
        "softplus": (2.0, 5.0), "sigmoid": (), "glu": (1,),
    }
    for name, args in acts.items():
        out.append(_c(f"F.{name}", A, (lambda n, a_: lambda p, x: getattr(
            p.nn.functional, n)(x, *a_))(name, args), ["x"]))
    out += [
        _c("F.maxout", A, lambda p, x: p.nn.functional.maxout(
            p.reshape(x, [R, 8, C // 8]), 4, axis=1), ["x"]),
        _c("F.prelu", A, lambda p, x: p.nn.functional.prelu(
            x, p.to_tensor(np.linspace(0.05, 0.3, C).astype(np.float32),
                           place=x.place), data_format="NHWC"), ["x"]),
        _c("F.rrelu", A, lambda p, x: p.nn.functional.rrelu(
            x, training=False), ["x"]),
    ]
    return out


def cases(rows=2048, cols=4096) -> List[Case]:
    return _sweep_table(rows, cols)


def _inplace_table():
    """(method, the tensor it runs on, other inputs, extra args): every
    ``_`` form, called as a Tensor method."""
    un = {n: ("x", [], ()) for n in (
        "abs_", "ceil_", "cos_", "exp_", "expm1_", "floor_", "neg_",
        "round_", "sigmoid_", "sin_", "sinh_", "square_", "tanh_", "atan_",
        "erf_", "trunc_", "frac_", "i0_", "sinc_", "flatten_", "squeeze_",
        "t_", "zero_")}
    un.update({n: ("p", [], ()) for n in (
        "reciprocal_", "rsqrt_", "sqrt_", "log_", "log2_", "log10_",
        "digamma_", "lgamma_", "gammaln_")})
    un.update({"acos_": ("u", [], ()), "tan_": ("u", [], ()),
               "logit_": ("o", [], ()), "nan_to_num_": ("n", [], ())})
    bi = {n: ("x", ["y"], ()) for n in (
        "add_", "subtract_", "multiply_", "hypot_", "copysign_",
        "less_than_", "greater_than_")}
    bi.update({n: ("x", ["p"], ()) for n in ("divide_", "remainder_",
                                             "mod_")})
    bi.update({n: ("i", ["j"], ()) for n in (
        "floor_divide_", "floor_mod_", "gcd_", "lcm_", "bitwise_and_",
        "bitwise_or_", "bitwise_xor_", "equal_", "less_equal_",
        "greater_equal_")})
    bi.update({n: ("b", ["c"], ()) for n in (
        "logical_and_", "logical_or_", "logical_xor_")})
    other = {
        "pow_": ("p", ["y"], ()), "ldexp_": ("x", ["s"], ()),
        "lerp_": ("x", ["y"], (0.25,)), "logical_not_": ("b", [], ()),
        "bitwise_not_": ("i", [], ()),
        "bitwise_left_shift_": ("i", ["s"], ()),
        "bitwise_right_shift_": ("i", ["s"], ()),
        "tril_": ("x", [], (-1,)), "triu_": ("x", [], (1,)),
        "transpose_": ("x", [], ([1, 0],)),
        "index_fill_": ("x", ["cidx"], (1, -2.0)),
        "masked_fill_": ("x", ["b"], (0.5,)),
        "masked_scatter_": ("x", ["b", "y"], ()),
        "renorm_": ("x", [], (2.0, 0, 10.0)), "gammainc_": ("p", ["g"], ()),
        "gammaincc_": ("p", ["g"], ()), "multigammaln_": ("g", [], (2,)),
        "polygamma_": ("p", [], (1,)), "addmm_": ("sm", ["sm", "sm2"], ()),
        "cumsum_": ("x", [], (1,)), "cumprod_": ("p", [], (0,)),
        "clip_": ("x", [], (-0.5, 0.5)), "scale_": ("x", [], (2.0, 1.0)),
        "reshape_": ("x", [], ([-1, 2],)),
        "unsqueeze_": ("x", [], (1,)), "cast_": ("x", [], ("float64",)),
        "flip_": ("x", [], ([0],)), "scatter_": ("x", ["idx", "upd"], ()),
        "fill_": ("x", [], (1.5,)), "fill_diagonal_": ("sm", [], (3.0,)),
        "index_add_": ("x", ["idx", "upd"], ()),
        "index_put_": ("x", ["idx", "upd"], ()),
        "where_": ("x", ["b", "y"], ()),
    }
    return {**un, **bi, **other}


_INPLACE_CALL = {
    "index_add_": lambda p, t, i, u: t.index_add_(i, 0, u),
    "index_put_": lambda p, t, i, u: t.index_put_((i,), u),
    "where_": lambda p, t, c, y: p.where_(c, t, y),
}
_INPLACE_SPECIAL = {"digamma_", "lgamma_", "gammaln_", "i0_", "gammainc_",
                    "gammaincc_", "multigammaln_", "polygamma_"}


def inplace_cases() -> List[Case]:
    out = []
    for name, (src, others, extra) in sorted(_inplace_table().items()):
        call = _INPLACE_CALL.get(name)

        def fn(p, t, *ts, _n=name, _e=extra, _c=call):
            if _c is not None:
                assert _c(p, t, *ts) is t
            else:
                assert getattr(t, _n)(*ts, *_e) is t
            return t
        fam = "special" if name in _INPLACE_SPECIAL else "elementwise"
        out.append(Case(f"Tensor.{name}", fam, fn, (src,) + tuple(others),
                        False))
    return out


_F_INPLACE = {"relu_": (), "elu_": (0.5,), "hardtanh_": (-0.5, 0.5),
              "leaky_relu_": (0.1,), "softmax_": (1,), "tanh_": (),
              "thresholded_relu_": (0.2,)}


def f_inplace_cases() -> List[Case]:
    out = []
    for name, args in _F_INPLACE.items():
        def fn(p, t, _n=name, _a=args):
            assert getattr(p.nn.functional, _n)(t, *_a) is t
            return t
        out.append(Case(f"F.{name}", "activation", fn, ("x",), False))
    return out


def required_names() -> Dict[str, List[str]]:
    """The names the sweep must call: the tensor modules' functions (the
    random ones are held by ``rng_checks``), ``paddle.linalg`` and
    nn.functional's activations."""
    import importlib
    req = {}
    for mod in ("math", "manipulation", "logic", "search", "stat",
                "creation", "extras", "linalg", "inplace"):
        m = importlib.import_module(f"paddle_tpu_torch.tensor.{mod}")
        req[mod] = list(m.__all__)
    from paddle_tpu_torch.nn.functional import activation
    req["nn.functional"] = list(activation.__all__)
    return req


# names the sweep reaches through another case: in-place forms through
# their method, the creation / utility functions of no device work, and
# the decompositions whose factors ``extra_checks`` holds by invariants
COVERED_ELSEWHERE = {
    "qr", "svd", "eig", "eigh", "eigvals", "lstsq", "top_p_sampling",
    "broadcast_shape", "pad_sequences", "set_printoptions",
    "disable_signal_handler", "check_shape", "flops", "LazyGuard", "batch",
    "is_complex", "is_integer", "is_floating_point", "is_tensor",
    "as_tensor_", "ones_like_", "cauchy_", "setitem", "gumbel_softmax",
}


def coverage() -> List[str]:
    """The required names no case calls."""
    called = {c.name.split(".")[-1] for c in cases() + inplace_cases() +
              f_inplace_cases()}
    called |= {n.rsplit("_", 1)[0] for n in called if "_" in n}
    missing = []
    for mod, names in required_names().items():
        for n in names:
            if n in called or n in COVERED_ELSEWHERE:
                continue
            if any(c.startswith(n + "_") or c == n for c in called):
                continue
            missing.append(f"{mod}.{n}")
    return missing


class _Bases:
    """The inputs as torch tensors, made once a device; each case gets
    clones (an in-place case must not write a base)."""

    def __init__(self, ins):
        self.ins, self.cache = ins, {}

    def tensor(self, paddle, name, device, grad):
        from ..tensor.tensor import wrap_array
        key = (name, device)
        if key not in self.cache:
            a = self.ins[name]
            self.cache[key] = torch.from_numpy(np.ascontiguousarray(a)).to(
                "cpu" if device == "cpu" else "cuda")
        base = self.cache[key]
        return wrap_array(base.clone(), stop_gradient=not (
            grad and base.is_floating_point()))


_COT: Dict[tuple, torch.Tensor] = {}


def _cotangent(shape, seed):
    """A seeded standard normal of ``shape`` (float32, on the CPU), made
    once a shape."""
    key = (tuple(shape), seed)
    if key not in _COT:
        g = torch.Generator().manual_seed(seed)
        _COT[key] = torch.randn(tuple(shape), generator=g)
    return _COT[key]


def _place(paddle, device):
    """A block in which ``device`` is the current place (the creation ops
    make their tensors there)."""
    import contextlib
    from ..framework import place as places

    @contextlib.contextmanager
    def guard():
        prev = places._current_place
        paddle.set_device("cpu" if device == "cpu" else "gpu")
        try:
            yield
        finally:
            places._current_place = prev
    return guard()


def _numpy(o):
    if isinstance(o, (bool, int, float)):
        return np.asarray(o)
    d = o._data.detach()
    if d.dtype == torch.bfloat16:
        d = d.float()
    return d.cpu().numpy()


def _data(o):
    if isinstance(o, (bool, int, float)):
        return torch.tensor(o)
    return o._data.detach()


def run_case(paddle, case: Case, ins, device, cot_seed=7, bases=None):
    """``case`` on ``device`` (the current place too) from the numpy
    ``ins`` -> (outputs as detached torch tensors on ``device``, their
    dtype names, the gradients or None)."""
    bases = bases or _Bases(ins)
    with _place(paddle, device):
        ts = [bases.tensor(paddle, n, device, case.grad)
              for n in case.inputs]
        out = case.fn(paddle, *ts)
        outs = list(out) if isinstance(out, (list, tuple)) else [out]
        vals = [_data(o) for o in outs]
        names = [getattr(getattr(o, "dtype", None), "name",
                         type(o).__name__) for o in outs]
        grads = None
        if case.grad:
            floats = [o for o in outs if hasattr(o, "_data") and
                      o._data.is_floating_point() and o._data.requires_grad]
            if floats:
                loss = None
                for k, o in enumerate(floats):
                    g = _cotangent(o.shape, cot_seed + k).to(
                        o._data.device, o._data.dtype)
                    term = (o._data * g).sum()
                    loss = term if loss is None else loss + term
                loss.backward()
                grads = [None if t.grad is None else t.grad._data.detach()
                         for t in ts]
    return vals, names, grads


def _rel(a, b):
    """max |a - b| over max |b| on the finite elements (inf where the
    shapes or the non-finite elements differ), computed in float64 on
    ``a``'s device."""
    a = torch.as_tensor(a)
    b = torch.as_tensor(b).to(a.device)
    if a.shape != b.shape:
        return float("inf")
    if a.numel() == 0:
        return 0.0
    if a.is_complex() or b.is_complex():
        a, b = torch.view_as_real(a.to(torch.complex128)), \
            torch.view_as_real(b.to(torch.complex128))
    a, b = a.double(), b.double()
    fa, fb = torch.isfinite(a), torch.isfinite(b)
    if not bool(torch.equal(fa, fb)):
        return float("inf")
    nf = ~fb
    if bool(nf.any()):
        same = (a[nf] == b[nf]) | (torch.isnan(a[nf]) & torch.isnan(b[nf]))
        if not bool(same.all()):
            return float("inf")
    if not bool(fb.any()):
        return 0.0
    scale = max(float(b[fb].abs().max()), 1e-30)
    return float((a[fb] - b[fb]).abs().max()) / scale


def _mismatches(a, b):
    b = b.to(a.device)
    if a.shape != b.shape:
        return float("inf")
    if a.is_floating_point() or a.is_complex():
        same = (a == b) | (torch.isnan(a) & torch.isnan(b))
    else:
        same = a == b
    return float((~same).sum())


def compare(got, ref, family):
    """The largest error of ``got`` against ``ref`` (both ``run_case``
    results) in its family's measure: relative to the largest |value| for
    floats, the count of unequal elements for the rest; inf when a dtype
    or a shape differs."""
    (gv, gn, gg), (rv, rn, rg) = got, ref
    if gn != rn or len(gv) != len(rv):
        return float("inf")
    err = 0.0
    for a, b in zip(gv, rv):
        if tuple(a.shape) != tuple(b.shape):
            return float("inf")
        if (b.is_floating_point() or b.is_complex()) and family != "exact":
            err = max(err, _rel(a, b))
        else:
            err = max(err, _mismatches(a, b))
    if (gg is None) != (rg is None):
        return float("inf")
    for a, b in zip(gg or [], rg or []):
        if (a is None) != (b is None):
            if not bool((a if a is not None else b).any()):
                continue
            return float("inf")
        if a is not None:
            err = max(err, _rel(a, b))
    return err


def sweep(paddle, ins, device, case_list=None, timings=None):
    """Every case on ``device`` against the CPU -> ({case name: (family,
    error, bound)}, {case name: the exception a call raised}); each case's
    seconds into ``timings`` when given."""
    res, raised = {}, {}
    bases = _Bases(ins)
    if case_list is None:
        rows, cols = ins["x"].shape
        case_list = cases(rows, cols) + inplace_cases() + f_inplace_cases()
    for case in case_list:
        t = time.perf_counter()
        try:
            got = run_case(paddle, case, ins, device, bases=bases)
            ref = run_case(paddle, case, ins, "cpu", bases=bases)
            err = compare(got, ref, case.family)
        except Exception as e:  # noqa: BLE001 (reported as the case's)
            raised[case.name] = f"{type(e).__name__}: {e}"[:300]
            err = float("inf")
        res[case.name] = (case.family, err, BOUNDS[case.family])
        if timings is not None:
            timings[case.name] = time.perf_counter() - t
    return res, raised


def _invariants(paddle, ins, device):
    """The decompositions whose factors are not unique, held by their
    invariants on ``device`` -> {name: largest error over the matrix's
    largest |value|}."""
    out = {}
    dev = "cpu" if device == "cpu" else "gpu"
    m = paddle.to_tensor(ins["m"], place=dev)
    tall = paddle.to_tensor(ins["tall"], place=dev)
    sym = paddle.to_tensor(ins["sym"], place=dev)
    q, r = paddle.linalg.qr(m)
    mm = ins["m"]
    scale = float(np.abs(mm).max())
    out["qr"] = float((q @ r - m).abs().max()) / scale
    eye = paddle.eye(mm.shape[-1]).to(m.place)
    out["qr_orthonormal"] = float((paddle.matmul(q, q, transpose_x=True) -
                                   eye).abs().max())
    u, s, vh = paddle.linalg.svd(tall)
    out["svd"] = float((u * s.unsqueeze(0) @ vh - tall).abs().max()) / \
        float(np.abs(ins["tall"]).max())
    w, v = paddle.linalg.eigh(sym)
    out["eigh"] = float((sym @ v - v * w.unsqueeze(-2)).abs().max()) / \
        float(np.abs(ins["sym"]).max())
    a0 = paddle.to_tensor(ins["m"][0], place=dev)
    ew, ev = paddle.linalg.eig(a0)
    lhs = a0.astype("complex64") @ ev if ew.dtype.name.startswith(
        "complex") else a0 @ ev
    out["eig"] = float((lhs - ev * ew.unsqueeze(0)).abs().max()) / \
        float(np.abs(ins["m"][0]).max())
    ew2 = paddle.linalg.eigvals(a0)
    out["eigvals"] = float(np.abs(np.sort_complex(_numpy(ew2)) -
                                  np.sort_complex(_numpy(ew))).max())
    return out


def extra_checks(paddle, ins, device, runs=4):
    """What CUDA is known to do its own way, each as {name: (error, bound)}:
    ties, duplicate indices (the later row wins in every one of ``runs``
    runs), cummax / cummin indices on ties, a rank-deficient lstsq, a
    logical right shift of negative ints, an even-count median, and the
    decompositions by their invariants."""
    dev = "cpu" if device == "cpu" else "gpu"
    res = {}
    x = paddle.to_tensor(ins["x"], place=dev)
    ties = paddle.to_tensor(ins["ties"], place=dev)
    # duplicate indices: idx holds repeats; the later row must win, the
    # same bits every run, as the CPU's serial write gives
    idx = paddle.to_tensor(ins["idx"], place=dev)
    upd = paddle.to_tensor(ins["upd"], place=dev)
    ref = ins["x"].copy()
    for k, i in enumerate(ins["idx"]):
        ref[i] = ins["upd"][k]
    runs_s = [_numpy(paddle.scatter(x, idx, upd)) for _ in range(runs)]
    runs_p = [_numpy(paddle.index_put(x, (idx,), upd)) for _ in range(runs)]
    res["scatter_duplicates_later_row"] = (max(
        float((r != ref).sum()) for r in runs_s + runs_p), 0.0)
    # cummax / cummin on ties: the first index of the running extreme
    for name, fn in (("cummax", np.maximum), ("cummin", np.minimum)):
        _, got = getattr(paddle, name)(ties, axis=1)
        t = ins["ties"]
        run = fn.accumulate(t, axis=1)
        prev = np.concatenate([run[:, :1], run[:, :-1]], 1)
        new = (t > prev) if name == "cummax" else (t < prev)
        new[:, 0] = True
        want = np.maximum.accumulate(np.where(new, np.arange(t.shape[1]),
                                              0), axis=1)
        res[f"{name}_tie_indices"] = (float((_numpy(got) != want).sum()),
                                      0.0)
    # argsort(stable=True), unique and mode on ties against numpy
    got = _numpy(paddle.argsort(ties, axis=1, stable=True))
    want = np.argsort(ins["ties"], axis=1, kind="stable")
    res["argsort_stable_ties"] = (float((got != want).sum()), 0.0)
    u, inv, cnt = paddle.unique(ties, return_inverse=True,
                                return_counts=True)
    wu, winv, wcnt = np.unique(ins["ties"], return_inverse=True,
                               return_counts=True)
    res["unique_ties"] = (float((_numpy(u) != wu).sum() +
                                (_numpy(inv).reshape(-1) !=
                                 winv.reshape(-1)).sum() +
                                (_numpy(cnt) != wcnt).sum()), 0.0)
    mv, mi = paddle.mode(ties, axis=1)
    t = ins["ties"]
    want_v, want_i = [], []
    for row in t:
        vals, counts = np.unique(row, return_counts=True)
        v = vals[counts == counts.max()].max()
        want_v.append(v)
        want_i.append(np.nonzero(row == v)[0][-1])
    res["mode_ties"] = (float((_numpy(mv) != np.asarray(want_v)).sum() +
                              (_numpy(mi) != np.asarray(want_i)).sum()), 0.0)
    # a rank-deficient lstsq: JAX's rank and the minimum-norm solution
    a = ins["def"].astype(np.float64)
    b = ins["tall_b"].astype(np.float64)
    sol, resid, rank, sv = paddle.linalg.lstsq(
        paddle.to_tensor(ins["def"], place=dev),
        paddle.to_tensor(ins["tall_b"], place=dev))
    want_sol = np.linalg.pinv(a, rcond=1e-5) @ b
    res["lstsq_rank_deficient_rank"] = (abs(int(_numpy(rank)) -
                                            a.shape[1] // 2), 0.0)
    res["lstsq_rank_deficient_solution"] = (_rel(_numpy(sol), want_sol),
                                            BOUNDS["linalg"])
    res["lstsq_rank_is_int32"] = (0.0 if rank.dtype.name == "int32" else
                                  1.0, 0.0)
    # a logical right shift of negative ints: zeros come in at the top
    i = ins["i"]
    s = ins["s"]
    got = _numpy(paddle.bitwise_right_shift(
        paddle.to_tensor(i, place=dev), paddle.to_tensor(s, place=dev),
        is_arithmetic=False))
    want = (i.astype(np.int64) & 0xFFFFFFFF) >> s
    want = want.astype(np.uint32).view(np.int32)
    res["bitwise_right_shift_logical_negative"] = (
        float((got != want).sum()), 0.0)
    # median of an even count: the mean of the two middles
    got = _numpy(paddle.median(x, axis=1))
    srt = np.sort(ins["x"], axis=1)
    n = srt.shape[1]
    want = (srt[:, n // 2 - 1] + srt[:, n // 2]) / 2
    res["median_even_count"] = (_rel(got, want), 1e-6)
    try:
        inv = _invariants(paddle, ins, device)
    except Exception as e:  # noqa: BLE001 (reported as a failed check)
        inv = {f"raised {type(e).__name__}: {e}"[:200]: float("inf")}
    for k, v in inv.items():
        res[f"{k}_invariant"] = (v, BOUNDS["linalg"])
    return res


# tests/test_ops_dtype_lanes.py's bf16 lane: (op, input domain)
BF16_OPS = [("exp", (-1, 1)), ("log", (0.1, 2)), ("sqrt", (0.1, 2)),
            ("rsqrt", (0.5, 2)), ("abs", (-2, 2)), ("sin", (-2, 2)),
            ("cos", (-2, 2)), ("tanh", (-2, 2)), ("sigmoid", (-2, 2)),
            ("square", (-2, 2)), ("floor", (-2, 2)), ("ceil", (-2, 2)),
            ("reciprocal", (0.5, 2)), ("log1p", (0.0, 2)),
            ("expm1", (-1, 1)), ("sign", (-2, 2))]
BF16_BINARY = ["add", "subtract", "multiply", "divide", "maximum",
               "minimum", "pow", "atan2"]
BF16_REDUCTIONS = ["sum", "mean", "max", "min", "prod"]
BF16_NN = ["relu", "gelu", "silu", "softmax", "log_softmax", "elu",
           "leaky_relu", "softplus", "hardswish", "mish"]
# one bf16 rounding of the result (2^-8 relative), the sums of a row in
# another order taken into account
BF16_BOUND = 2e-2


def bf16_lane(paddle, device, rows=2048, cols=4096, seed=1):
    """The bf16 lane's ops on bf16 tensors on ``device`` against the same
    ops in f32 on the CPU from the same (bf16-rounded) inputs -> {op:
    (error, bound)} (values and, for the ops JAX's lane differentiates,
    gradients): one bf16 rounding of the result apart, as JAX's lane
    holds bf16 against an f32 reference."""
    r = np.random.RandomState(seed)
    dev = "cpu" if device == "cpu" else "gpu"
    res = {}

    def both(name, fn, arrays, grad):
        outs = []
        for d, dt in ((dev, "bfloat16"), ("cpu", "float32")):
            ts = [paddle.to_tensor(paddle.to_tensor(
                a, place="cpu", dtype="bfloat16").astype(dt)._data.to(
                "cpu" if d == "cpu" else "cuda"), stop_gradient=not grad)
                for a in arrays]
            with _place(paddle, d):
                y = fn(*ts)
                gs = None
                if grad:
                    g = _cotangent(y.shape, 11).to(y._data.device)
                    (y._data.float() * g).sum().backward()
                    gs = [_data(t.grad).float() for t in ts]
            outs.append((_data(y).float(), gs))
        (a, ga), (b, gb) = outs
        err = _rel(a, b)
        for x1, x2 in zip(ga or [], gb or []):
            err = max(err, _rel(x1, x2))
        res[name] = (err, BF16_BOUND)

    grad_un = {"exp", "log", "sqrt", "tanh", "sigmoid", "square", "sin",
               "cos", "reciprocal"}
    for name, (lo, hi) in BF16_OPS:
        x = r.uniform(lo, hi, (rows, cols)).astype(np.float32)
        both(name, getattr(paddle, name), [x], name in grad_un)
    for name in BF16_BINARY:
        x = r.uniform(0.5, 2, (rows, cols)).astype(np.float32)
        y = r.uniform(0.5, 2, (rows, cols)).astype(np.float32)
        both(name, getattr(paddle, name), [x, y],
             name in ("add", "subtract", "multiply", "divide"))
    for name in BF16_REDUCTIONS:
        x = r.uniform(0.5, 1.5, (rows, 64 if name == "prod" else cols)
                      ).astype(np.float32)
        both(name, (lambda n: lambda t: getattr(paddle, n)(t, axis=-1))(
            name), [x], False)
    x = r.uniform(-1, 1, (rows, 512)).astype(np.float32)
    w = r.uniform(-1, 1, (512, 512)).astype(np.float32)
    both("matmul", paddle.matmul, [x, w], True)
    for name in BF16_NN:
        x = r.uniform(-2, 2, (rows, cols)).astype(np.float32)
        both(f"F.{name}", getattr(paddle.nn.functional, name), [x],
             name in ("relu", "gelu", "silu", "softmax", "log_softmax"))
    return res


# the random ops on the card: (name, draw, the law's mean and variance)
N_DRAWS = 2 ** 20


def _rng_draws(paddle):
    n = N_DRAWS
    half = np.full((n,), 0.3, np.float32)
    return [
        ("rand", lambda: paddle.rand([n]), (0.5, 1 / 12)),
        ("randn", lambda: paddle.randn([n]), (0.0, 1.0)),
        ("standard_normal", lambda: paddle.standard_normal([n]), (0.0, 1.0)),
        ("uniform", lambda: paddle.uniform([n], min=-2.0, max=4.0),
         (1.0, 3.0)),
        ("normal", lambda: paddle.normal(2.0, 3.0, [n]), (2.0, 9.0)),
        ("log_normal", lambda: paddle.log_normal(0.0, 0.5, [n]),
         (math.exp(0.125), (math.exp(0.25) - 1) * math.exp(0.25))),
        ("randint", lambda: paddle.randint(-3, 5, [n]), (0.5, 63 / 12)),
        ("randint_like", lambda: paddle.randint_like(paddle.zeros(
            [n], "int32"), 0, 10), (4.5, 99 / 12)),
        ("randn_like", lambda: paddle.randn_like(paddle.zeros([n])),
         (0.0, 1.0)),
        ("rand_like", lambda: paddle.rand_like(paddle.zeros([n])),
         (0.5, 1 / 12)),
        ("bernoulli", lambda: paddle.bernoulli(paddle.to_tensor(half)),
         (0.3, 0.21)),
        ("poisson", lambda: paddle.poisson(paddle.to_tensor(half * 10)),
         (3.0, 3.0)),
        ("binomial", lambda: paddle.binomial(paddle.full(
            [n], 10, "int64"), paddle.to_tensor(half)), (3.0, 2.1)),
        ("standard_gamma", lambda: paddle.standard_gamma(
            paddle.to_tensor(half * 10)), (3.0, 3.0)),
        ("multinomial", lambda: paddle.multinomial(paddle.to_tensor(
            np.array([0.1, 0.2, 0.7], np.float32)), n, replacement=True),
         (1.6, 0.44)),
        ("exponential_", lambda: paddle.zeros([n]).exponential_(2.0),
         (0.5, 0.25)),
        ("uniform_", lambda: paddle.zeros([n]).uniform_(0.0, 2.0),
         (1.0, 1 / 3)),
        ("normal_", lambda: paddle.zeros([n]).normal_(1.0, 2.0),
         (1.0, 4.0)),
        ("bernoulli_", lambda: paddle.zeros([n]).bernoulli_(0.25),
         (0.25, 0.1875)),
        ("geometric_", lambda: paddle.zeros([n]).geometric_(0.5),
         (2.0, 2.0)),
        ("log_normal_", lambda: paddle.zeros([n]).log_normal_(0.0, 0.25),
         (math.exp(1 / 32), (math.exp(1 / 16) - 1) * math.exp(1 / 16))),
        ("cauchy_", lambda: paddle.zeros([n]).cauchy_(1.0), None),
        ("randperm", lambda: paddle.randperm(n), None),
        ("multinomial_distinct", lambda: paddle.multinomial(
            paddle.to_tensor(np.full((64, 4096), 1.0, np.float32)), 4096),
         None),
        ("rrelu", lambda: -paddle.nn.functional.rrelu(
            paddle.to_tensor(-np.ones(n, np.float32)), 0.1, 0.3),
         (0.2, 0.04 / 12)),
        ("gumbel_softmax", lambda: paddle.nn.functional.gumbel_softmax(
            paddle.to_tensor(np.tile(np.log(np.array(
                [0.1, 0.2, 0.7], np.float32)), (n // 4, 1))),
            hard=True).argmax(-1), (1.6, 0.44)),
    ]


def rng_checks(paddle, seed=1234):
    """Each random op on the current place: the same ``paddle.seed`` twice
    gives the same draws, the draws differ from the next ones, and the
    moments of 2^20 draws are within 5 standard errors of the law's (the
    variance's bar from a normal law's fourth moment, three times wider
    for the skewed laws); ``randperm`` is a permutation,
    ``multinomial`` without replacement draws distinct indices, Cauchy's
    quartiles are loc -1, loc, loc + 1 -> {name: (problems, 0)}."""
    res = {}
    for name, draw, law in _rng_draws(paddle):
        paddle.seed(seed)
        a = _numpy(draw())
        paddle.seed(seed)
        b = _numpy(draw())
        c = _numpy(draw())
        bad = 0
        if not np.array_equal(a, b) or np.array_equal(a, c):
            bad += 1
        if law is not None:
            mean, var = law
            x = a.astype(np.float64).reshape(-1)
            se = math.sqrt(var / x.size)
            se_v = var * math.sqrt(2.0 / (x.size - 1)) * 3
            bad += int(abs(x.mean() - mean) > 5 * se)
            bad += int(abs(x.var(ddof=1) - var) > 5 * se_v)
        elif name == "randperm":
            bad += int(not np.array_equal(np.sort(a), np.arange(a.size)))
        elif name == "multinomial_distinct":
            bad += int(not all(np.array_equal(np.sort(r), np.arange(r.size))
                               for r in a))
        else:
            q = np.quantile(a, [0.25, 0.5, 0.75])
            bad += int(np.abs(q - [0.0, 1.0, 2.0]).max() > 0.02)
        res[name] = (float(bad), 0.0)
    return res


def dispatch_cost(paddle, device, n=2000):
    """Host µs a call of the Paddle API against torch's own call, for a
    few ops at [8, 8] on ``device`` (no sync inside the loop; one at the
    end) -> {op: (paddle µs, torch µs)}."""
    dev = "cpu" if device == "cpu" else "gpu"
    x = paddle.to_tensor(np.ones((8, 8), np.float32), place=dev)
    y = paddle.to_tensor(np.ones((8, 8), np.float32), place=dev)
    idx = paddle.to_tensor(np.arange(4), place=dev)
    a, b, i = x._data, y._data, idx._data
    pairs = {
        "add": (lambda: paddle.add(x, y), lambda: torch.add(a, b)),
        "exp": (lambda: paddle.exp(x), lambda: torch.exp(a)),
        "sum": (lambda: paddle.sum(x, axis=1), lambda: a.sum(1)),
        "matmul": (lambda: paddle.matmul(x, y), lambda: a @ b),
        "clip": (lambda: paddle.clip(x, 0.0, 1.0),
                 lambda: torch.clamp(a, 0.0, 1.0)),
        "gather": (lambda: paddle.gather(x, idx),
                   lambda: torch.index_select(a, 0, i)),
        "add_": (lambda: x.add_(y), lambda: a.add_(b)),
    }
    sync = torch.cuda.synchronize if a.is_cuda else (lambda: None)
    out = {}
    for name, (pf, tf) in pairs.items():
        times = []
        for fn in (pf, tf):
            for _ in range(50):
                fn()
            sync()
            t = time.perf_counter()
            for _ in range(n):
                fn()
            sync()
            times.append((time.perf_counter() - t) / n * 1e6)
        out[name] = tuple(times)
    return out


# ---------------------------------------------------------------------------
# the nn families
# ---------------------------------------------------------------------------
# one realistic shape a family: a language model's [4096, 32000] logit
# batch (``logits`` rows x ``vocab``), a regression head's [4096, 1024], a
# ResNet stage's [8, 256, 56, 56] feature map and its stem's [8, 64, 112,
# 112], a segmentation decoder's transposed convolution [8, 256, 56, 56]
# -> [8, 128, 112, 112], [4096, 512] embeddings, a CTC head's [400 frames,
# 16, 29 characters]
NN_SIZES = dict(rows=4096, vocab=32000, width=1024, emb=512, batch=8,
                ch=256, hw=56, stem_ch=64, frames=400, ctc_batch=16,
                chars=29, seq=1024, heads=8)


def nn_inputs(seed=0, **sizes):
    """The nn sweep's numpy inputs, drawn from ``seed``."""
    z = dict(NN_SIZES, **sizes)
    r = _Draws(seed)
    f = np.float32
    N, V, W, E = z["rows"], z["vocab"], z["width"], z["emb"]
    B, C, HW = z["batch"], z["ch"], z["hw"]
    lg = r.randn(N, V).astype(f)
    soft = np.exp(lg[:, :64] - lg[:, :64].max(1, keepdims=True))
    T, NB, K = z["frames"], z["ctc_batch"], z["chars"]
    lab_len = r.randint(T // 8, T // 4, NB)
    S, Hh = z["seq"], z["heads"]
    return {
        "logits": lg, "idx": r.randint(0, V, N), "t01": (
            r.rand(N, V) > 0.5).astype(f),
        "soft64": (soft / soft.sum(1, keepdims=True)).astype(f),
        "lp64": r.randn(N, 64).astype(f),
        "reg": r.randn(N, W).astype(f), "reg2": r.randn(N, W).astype(f),
        "pos": (r.rand(N, W) + 0.1).astype(f),
        "sign": np.where(r.rand(N) > 0.5, 1.0, -1.0).astype(f),
        "e1": r.randn(N, E).astype(f), "e2": r.randn(N, E).astype(f),
        "e3": r.randn(N, E).astype(f),
        "fmap": r.randn(B, C, HW, HW).astype(f),
        "stem": r.randn(B, z["stem_ch"], 2 * HW, 2 * HW).astype(f),
        "vid": r.randn(2, 32, 8, HW, HW).astype(f),
        "seq1d": r.randn(B, C, 4 * HW).astype(f),
        "gn_w": (1 + 0.1 * r.randn(C)).astype(f),
        "gn_b": (0.1 * r.randn(C)).astype(f),
        "tconv_w": (r.randn(C, C // 2, 2, 2) / np.sqrt(4 * C)).astype(f),
        "tconv_b": (0.1 * r.randn(C // 2)).astype(f),
        "tconv1_w": (r.randn(C, C // 2, 4) / np.sqrt(4 * C)).astype(f),
        "tconv3_w": (r.randn(32, 16, 2, 2, 2) / np.sqrt(256)).astype(f),
        "theta": (np.eye(2, 3)[None] + 0.1 * r.randn(B, 2, 3)).astype(f),
        "ctc_lp": r.randn(T, NB, K).astype(f),
        "ctc_lab": r.randint(1, K, (NB, T // 4)),
        "ctc_il": r.randint(T - T // 4, T + 1, NB), "ctc_ll": lab_len,
        "q": r.randn(2, Hh, S, 64).astype(f),
        "k": r.randn(2, Hh, S, 64).astype(f),
        "v": r.randn(2, Hh, S, 64).astype(f),
        "starts": r.randint(S // 2, S + 1, (2, Hh, 1, S)),
        "seg_probs": r.rand(B, HW * HW, 21).astype(f),
        "seg_lab": r.randint(0, 21, (B, HW * HW, 1)),
        "hs_w": (r.randn(1023, E) / np.sqrt(E)).astype(f),
        "hs_idx": r.randint(0, 1024, N),
        "bil_a": r.randn(1024, 128).astype(f),
        "bil_b": r.randn(1024, 128).astype(f),
        "bil_w": (r.randn(64, 128, 128) / 128).astype(f),
        "lens": r.randint(1, 64, N),
        "as_head": (r.randn(E, 66) / np.sqrt(E)).astype(f),
        "as_proj": (r.randn(E, 64) / np.sqrt(E)).astype(f),
        "as_out": (r.randn(64, 300) / 8).astype(f),
        "gt_ids": r.randint(0, V, (63, 16, 4)),
        "gt_par": r.randint(0, 4, (63, 16, 4)),
        "rnnt_x": r.randn(4, 100, 21, 64).astype(f),
        "rnnt_y": r.randint(1, 64, (4, 20)),
    }


def _nn(name):
    def f(paddle, *a, **kw):
        return getattr(paddle.nn.functional, name)(*a, **kw)
    return f


def nn_cases(sizes=None) -> List[Case]:
    """The nn families' cases over ``nn_inputs``."""
    z = dict(NN_SIZES, **(sizes or {}))
    F = _nn
    HW = z["hw"]
    cs = [
        # losses over the logit batch
        _c("F.cross_entropy", "loss",
           lambda p, x, i: F("cross_entropy")(p, x, i), ["logits", "idx"]),
        _c("F.cross_entropy.label_smoothing", "loss",
           lambda p, x, i: F("cross_entropy")(p, x, i, label_smoothing=0.1),
           ["logits", "idx"]),
        _c("F.softmax_with_cross_entropy", "loss",
           lambda p, x, i: F("softmax_with_cross_entropy")(
               p, x, p.unsqueeze(i, -1)), ["logits", "idx"]),
        _c("F.nll_loss", "loss", lambda p, x, i: F("nll_loss")(
            p, p.nn.functional.log_softmax(x), i), ["logits", "idx"]),
        _c("F.one_hot.label_smooth", "loss",
           lambda p, x, i: F("cross_entropy")(p, x, F("label_smooth")(
               p, F("one_hot")(p, i, x.shape[-1])), soft_label=True),
           ["logits", "idx"]),
        _c("F.binary_cross_entropy_with_logits", "loss",
           lambda p, x, t: F("binary_cross_entropy_with_logits")(p, x, t),
           ["logits", "t01"]),
        _c("F.sigmoid_focal_loss", "loss",
           lambda p, x, t: F("sigmoid_focal_loss")(p, x, t), ["logits",
                                                              "t01"]),
        _c("F.multi_label_soft_margin_loss", "loss",
           lambda p, x, t: F("multi_label_soft_margin_loss")(p, x, t),
           ["logits", "t01"]),
        _c("F.margin_cross_entropy", "loss",
           lambda p, x, i: F("margin_cross_entropy")(p, p.tanh(x) * 0.9,
                                                     i),
           ["logits", "idx"]),
        _c("F.multi_margin_loss", "loss",
           lambda p, x, i: F("multi_margin_loss")(p, x, i),
           ["logits", "idx"]),
        _c("F.kl_div", "loss", lambda p, x, t: F("kl_div")(
            p, p.nn.functional.log_softmax(x), t, reduction="batchmean"),
            ["lp64", "soft64"]),
        # losses of a regression head
        _c("F.mse_loss", "loss", lambda p, a, b: F("mse_loss")(p, a, b),
           ["reg", "reg2"]),
        _c("F.l1_loss", "loss", lambda p, a, b: F("l1_loss")(p, a, b),
           ["reg", "reg2"]),
        _c("F.smooth_l1_loss", "loss",
           lambda p, a, b: F("smooth_l1_loss")(p, a, b, delta=0.5),
           ["reg", "reg2"]),
        _c("F.square_error_cost", "loss",
           lambda p, a, b: F("square_error_cost")(p, a, b), ["reg", "reg2"]),
        _c("F.binary_cross_entropy", "loss",
           lambda p, a, b: F("binary_cross_entropy")(
               p, p.nn.functional.sigmoid(a), p.nn.functional.sigmoid(b)),
           ["reg", "reg2"]),
        _c("F.log_loss", "loss", lambda p, a, b: F("log_loss")(
            p, p.nn.functional.sigmoid(a), p.nn.functional.sigmoid(b)),
            ["reg", "reg2"]),
        _c("F.poisson_nll_loss", "loss",
           lambda p, a, t: F("poisson_nll_loss")(p, a, t, full=True),
           ["reg", "pos"]),
        _c("F.gaussian_nll_loss", "loss",
           lambda p, a, b, v: F("gaussian_nll_loss")(p, a, b, v),
           ["reg", "reg2", "pos"]),
        _c("F.soft_margin_loss", "loss",
           lambda p, a, y: F("soft_margin_loss")(p, a[:, 0], y),
           ["reg", "sign"]),
        # losses over embeddings
        _c("F.margin_ranking_loss", "loss",
           lambda p, a, b, y: F("margin_ranking_loss")(p, a[:, 0], b[:, 0],
                                                       y, margin=0.1),
           ["e1", "e2", "sign"]),
        _c("F.hinge_embedding_loss", "loss",
           lambda p, a, y: F("hinge_embedding_loss")(p, a[:, 0], y),
           ["e1", "sign"]),
        _c("F.cosine_embedding_loss", "loss",
           lambda p, a, b, y: F("cosine_embedding_loss")(p, a, b, y),
           ["e1", "e2", "sign"]),
        _c("F.triplet_margin_loss", "loss",
           lambda p, a, b, c: F("triplet_margin_loss")(p, a, b, c,
                                                       swap=True),
           ["e1", "e2", "e3"]),
        _c("F.triplet_margin_with_distance_loss", "loss",
           lambda p, a, b, c: F("triplet_margin_with_distance_loss")(
               p, a, b, c), ["e1", "e2", "e3"]),
        _c("F.npair_loss", "loss",
           lambda p, a, b, y: F("npair_loss")(p, a, b, p.cast(
               y, "float32")), ["e1", "e2", "lens"]),
        _c("F.hsigmoid_loss", "loss",
           lambda p, a, w, y: F("hsigmoid_loss")(p, a, y, 1024, w),
           ["e1", "hs_w", "hs_idx"]),
        _c("F.adaptive_log_softmax_with_loss", "loss",
           lambda p, a, h, pr, o, i: F("adaptive_log_softmax_with_loss")(
               p, a, i, h, [[pr, o]], [64]),
           ["e1", "as_head", "as_proj", "as_out", "lens"]),
        _c("F.dice_loss", "loss", lambda p, x, y: F("dice_loss")(p, x, y),
           ["seg_probs", "seg_lab"]),
        _c("F.ctc_loss", "recursion",
           lambda p, lp, y, il, ll: F("ctc_loss")(p, lp, y, il, ll),
           ["ctc_lp", "ctc_lab", "ctc_il", "ctc_ll"]),
        # norms over the feature map
        _c("F.group_norm", "norm", lambda p, x, w, b: F("group_norm")(
            p, x, 32, weight=w, bias=b), ["fmap", "gn_w", "gn_b"]),
        _c("F.instance_norm", "norm", lambda p, x, w, b: F("instance_norm")(
            p, x, weight=w, bias=b), ["fmap", "gn_w", "gn_b"]),
        _c("F.local_response_norm", "norm",
           lambda p, x: F("local_response_norm")(p, x, 5), ["fmap"]),
        _c("F.normalize", "norm", lambda p, x: F("normalize")(p, x),
           ["fmap"]),
        _c("F.cosine_similarity", "norm",
           lambda p, a, b: F("cosine_similarity")(p, a, b), ["e1", "e2"]),
        _c("F.pairwise_distance", "norm",
           lambda p, a, b: F("pairwise_distance")(p, a, b), ["e1", "e2"]),
        # pads
        *[_c(f"F.pad.{m}", "pad", (lambda m: lambda p, x: F("pad")(
            p, x, [1, 1, 2, 1], mode=m, value=0.5))(m), ["fmap"])
          for m in ("constant", "reflect", "replicate", "circular")],
        _c("F.zeropad2d", "pad", lambda p, x: F("zeropad2d")(
            p, x, [1, 2, 0, 1]), ["fmap"]),
        # resampling
        *[_c(f"F.interpolate.{m}", "resample", (lambda m: lambda p, x: F(
            "interpolate")(p, x, scale_factor=2, mode=m))(m), ["fmap"])
          for m in ("nearest", "bilinear", "bicubic")],
        _c("F.interpolate.bilinear_down", "resample",
           lambda p, x: F("interpolate")(p, x, size=[HW // 2 + 3, HW // 2],
                                         mode="bilinear"), ["fmap"]),
        _c("F.upsample.trilinear", "resample",
           lambda p, x: F("upsample")(p, x, scale_factor=2,
                                      mode="trilinear"), ["vid"]),
        _c("F.affine_grid", "resample", lambda p, t: F("affine_grid")(
            p, t, [z["batch"], 1, HW, HW], align_corners=False), ["theta"]),
        *[_c(f"F.grid_sample.{m}", "resample", (lambda m: lambda p, x, t: F(
            "grid_sample")(p, x, F("affine_grid")(
                p, t, [z["batch"], 1, HW, HW]) * 1.1, mode=m))(m),
            ["fmap", "theta"]) for m in ("bilinear", "nearest")],
        # pools with masks, unpools
        _c("F.max_pool2d.mask", "pool", lambda p, x: F("max_pool2d")(
            p, x, 3, 2, 1, return_mask=True), ["stem"]),
        _c("F.max_unpool2d", "pool", lambda p, x: F("max_unpool2d")(
            p, *F("max_pool2d")(p, x, 2, 2, return_mask=True), 2, 2),
            ["stem"]),
        _c("F.max_pool2d_with_index", "pool",
           lambda p, x: F("max_pool2d_with_index")(p, x, 2, 2, 1),
           ["fmap"]),
        _c("F.max_pool1d.mask", "pool", lambda p, x: F("max_pool1d")(
            p, x, 3, 2, 1, return_mask=True), ["seq1d"]),
        _c("F.max_unpool1d", "pool", lambda p, x: F("max_unpool1d")(
            p, *F("max_pool1d")(p, x, 2, return_mask=True), 2), ["seq1d"]),
        _c("F.max_pool3d.mask", "pool", lambda p, x: F("max_pool3d")(
            p, x, 2, 2, return_mask=True), ["vid"]),
        _c("F.max_unpool3d", "pool", lambda p, x: F("max_unpool3d")(
            p, *F("max_pool3d")(p, x, 2, return_mask=True), 2), ["vid"]),
        *[_c(f"F.adaptive_max_pool{n}d", "pool", (lambda n, inp: lambda p, x:
              F(f"adaptive_max_pool{n}d")(p, x, 7, return_mask=True))(n, i),
             [i]) for n, i in ((1, "seq1d"), (2, "fmap"), (3, "vid"))],
        _c("F.lp_pool2d", "pool", lambda p, x: F("lp_pool2d")(
            p, p.abs(x), 2.0, 3, 2), ["fmap"]),
        _c("F.lp_pool1d", "pool", lambda p, x: F("lp_pool1d")(
            p, p.abs(x), 3.0, 2), ["seq1d"]),
        _c("F.fractional_max_pool2d", "pool",
           lambda p, x: F("fractional_max_pool2d")(
               p, x[:, :64], [HW // 2, HW // 2], random_u=0.3), ["fmap"]),
        _c("F.fractional_max_pool3d", "pool",
           lambda p, x: F("fractional_max_pool3d")(
               p, x[:, :8], [4, HW // 4, HW // 4], random_u=0.6), ["vid"]),
        # transposed convolutions
        _c("F.conv2d_transpose", "conv",
           lambda p, x, w, b: F("conv2d_transpose")(p, x, w, b, stride=2),
           ["fmap", "tconv_w", "tconv_b"]),
        _c("F.conv1d_transpose", "conv",
           lambda p, x, w: F("conv1d_transpose")(p, x, w, stride=2,
                                                 padding=1), ["seq1d",
                                                              "tconv1_w"]),
        _c("F.conv3d_transpose", "conv",
           lambda p, x, w: F("conv3d_transpose")(p, x, w, stride=2),
           ["vid", "tconv3_w"]),
        # fold / unfold, shuffles, the long tail
        _c("F.unfold", "pad", lambda p, x: F("unfold")(p, x[:, :64], 3,
                                                       paddings=1),
           ["fmap"]),
        _c("F.fold", "pad", lambda p, x: F("fold")(
            p, F("unfold")(p, x[:, :64], 2, 2), [HW, HW], 2, 2), ["fmap"]),
        _c("F.pixel_shuffle", "exact", lambda p, x: F("pixel_shuffle")(
            p, x, 2), ["fmap"]),
        _c("F.pixel_unshuffle", "exact", lambda p, x: F("pixel_unshuffle")(
            p, x, 2), ["fmap"]),
        _c("F.channel_shuffle", "exact", lambda p, x: F("channel_shuffle")(
            p, x, 8), ["fmap"]),
        _c("F.temporal_shift", "exact", lambda p, x: F("temporal_shift")(
            p, x, 2), ["fmap"]),
        _c("F.bilinear", "nn_misc", lambda p, a, b, w: F("bilinear")(
            p, a, b, w), ["bil_a", "bil_b", "bil_w"]),
        _c("F.sequence_mask", "exact", lambda p, n: F("sequence_mask")(
            p, n, maxlen=64), ["lens"], grad=False),
        _c("F.sparse_attention", "nn_misc",
           lambda p, q, k, v: F("sparse_attention")(
               p, q, k, v, *_csr_band(p, q.shape[0], q.shape[1],
                                      q.shape[2], 64)), ["q", "k", "v"]),
        _c("F.flash_attention_with_sparse_mask", "nn_misc",
           lambda p, q, k, v, st: F("flash_attention_with_sparse_mask")(
               p, p.transpose(q, [0, 2, 1, 3]), p.transpose(k, [0, 2, 1, 3]),
               p.transpose(v, [0, 2, 1, 3]),
               attn_mask_start_row_indices=st), ["q", "k", "v", "starts"]),
        _c("F.gather_tree", "exact", lambda p, i, q: F("gather_tree")(
            p, i, q), ["gt_ids", "gt_par"], grad=False),
        _c("F.rnnt_loss", "recursion", lambda p, x, y: F("rnnt_loss")(
            p, x, y, p.full([4], 100, "int64"), p.full([4], 20, "int64")),
           ["rnnt_x", "rnnt_y"]),
    ]
    return cs


def _csr_band(paddle, B, H, S, w):
    """A banded CSR layout (each row sees the ``w`` keys up to itself), the
    offsets and columns on the current place."""
    rows = np.arange(S)
    lo = np.maximum(rows - w + 1, 0)
    counts = rows - lo + 1
    off = np.concatenate([[0], np.cumsum(counts)])
    cols = np.concatenate([np.arange(a, r + 1) for a, r in zip(lo, rows)])
    off = np.broadcast_to(off, (B, H, S + 1)).copy()
    cols = np.broadcast_to(cols, (B, H, cols.size)).copy()
    return paddle.to_tensor(off), paddle.to_tensor(cols)


# nn.functional names the nn sweep reaches another way: the flash entry
# points (chip_smoke's api_varlen, against their plain versions), the
# dropouts (nn_laws) and the host-side sampler (its own check below)
NN_COVERED_ELSEWHERE = {
    "flash_attn_qkvpacked", "flash_attn_varlen_qkvpacked",
    "flash_attn_unpadded", "varlen_route", "dropout2d", "dropout3d",
    "alpha_dropout", "class_center_sample", "linear_interp",
}


def nn_coverage() -> List[str]:
    """The nn slice's functional names no nn case calls."""
    from ..nn.functional import common, extras, loss, norm
    req = list(common.__all__) + list(norm.__all__) + list(loss.__all__) + \
        list(extras.__all__) + ["conv1d_transpose", "conv2d_transpose",
                                "conv3d_transpose", "adaptive_max_pool1d",
                                "adaptive_max_pool2d"]
    called = set()
    for c in nn_cases():
        called |= set(c.name[2:].split("."))
    return [n for n in req if n not in called and
            n not in NN_COVERED_ELSEWHERE]


def nn_laws(paddle, device, seed=3):
    """The dropouts on ``device`` by their laws, and class_center_sample's
    invariants -> {name: (problems, 0)}."""
    res = {}
    paddle.seed(seed)
    F = paddle.nn.functional
    with _place(paddle, device):
        x = paddle.ones([64, 256, 8, 8])
        y = _numpy(F.dropout2d(x, p=0.3)).reshape(64, 256, -1)
        whole = bool(((y == 0).all(-1) | (y == y[..., :1]).all(-1)).all())
        frac = float((y[..., 0] == 0).mean())
        res["dropout2d_whole_channels"] = (0.0 if whole else 1.0, 0.0)
        res["dropout2d_rate"] = (float(abs(frac - 0.3) > 0.02), 0.0)
        y3 = _numpy(F.dropout3d(paddle.ones([16, 256, 2, 4, 4]), p=0.5))
        res["dropout3d_whole_channels"] = (
            0.0 if (y3.reshape(16, 256, -1).std(-1) == 0).all() else 1.0,
            0.0)
        g = paddle.randn([1024, 1024])
        a = _numpy(F.alpha_dropout(g, p=0.2))
        res["alpha_dropout_moments"] = (
            float(abs(a.mean()) > 0.01 or abs(a.std() - 1) > 0.01), 0.0)
        lab = paddle.to_tensor(np.array([3, 7, 3, 19, 0]))
        remapped, sampled = F.class_center_sample(lab, 20, 8)
        s, r = _numpy(sampled), _numpy(remapped)
        ok = len(s) == 8 and {0, 3, 7, 19} <= set(s.tolist()) and \
            np.array_equal(s[r], np.array([3, 7, 3, 19, 0]))
        res["class_center_sample_positives"] = (0.0 if ok else 1.0, 0.0)
    return res
