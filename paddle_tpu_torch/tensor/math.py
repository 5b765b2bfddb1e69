"""Elementwise math, reductions, cumulative ops and the products that live
in ``paddle.tensor.math``.

Counterpart of ``paddle_tpu/tensor/math.py``: every op runs through
``ops.dispatch.apply`` under JAX's op name, so the AMP lists reach the same
ops.  A Python scalar operand is closed over and takes the tensor's type,
as JAX's weak types do.  Types follow JAX's (x64 on): a float op on an
int32 tensor gives float32, on an int64 one float64; ``mean`` of int32
is float32; ``cumsum`` keeps int32.  ``cummax`` / ``cummin`` return the
first index of a tie, as JAX's scan does (torch's own may return another).
"""

from __future__ import annotations

import builtins
import functools

import torch

from ..framework import dtype as dtypes
from ..ops.dispatch import apply, as_tensor
from .tensor import Tensor

__all__ = []


def _export(fn):
    __all__.append(fn.__name__)
    return fn


def _normalize_axis(axis):
    if axis is None:
        return None
    if isinstance(axis, Tensor):
        axis = axis.tolist()
    if isinstance(axis, (list, tuple)):
        return tuple(int(a.item()) if isinstance(a, Tensor) else int(a)
                     for a in axis)
    return int(axis)


def _scalar(v):
    return v._data if isinstance(v, Tensor) else v


def _inexact(a):
    """``a`` in the float type JAX computes a float op of it in: int64 as
    float64, other ints and bool as float32."""
    if a.is_floating_point() or a.is_complex():
        return a
    return a.to(torch.float64 if a.dtype == torch.int64 else torch.float32)


def _float_op(tfn):
    return lambda a: tfn(_inexact(a))


# ---------------------------------------------------------------------------
# unary elementwise
# ---------------------------------------------------------------------------
def _make_unary(name, tfn):
    def op(x, name=None):
        return apply(op.__name__, tfn, as_tensor(x))
    op.__name__ = op.__qualname__ = name
    op.__doc__ = f"Elementwise {name}."
    __all__.append(name)
    return op


def _real_or_zero(part):
    def fn(a):
        if a.is_complex():
            return part(a)
        # the imaginary part of a real tensor: zeros that keep the graph
        # (a zero gradient, as JAX's)
        return a.clone() if part is torch.real else a * 0
    return fn


def _sign(a):
    return torch.sgn(a) if a.is_complex() else torch.sign(a)


def _angle(a):
    return torch.angle(_inexact(a))


exp = _make_unary("exp", _float_op(torch.exp))
expm1 = _make_unary("expm1", _float_op(torch.expm1))
log = _make_unary("log", _float_op(torch.log))
log2 = _make_unary("log2", _float_op(torch.log2))
log10 = _make_unary("log10", _float_op(torch.log10))
log1p = _make_unary("log1p", _float_op(torch.log1p))
sqrt = _make_unary("sqrt", _float_op(torch.sqrt))
rsqrt = _make_unary("rsqrt", _float_op(torch.rsqrt))
square = _make_unary("square", torch.square)
abs = _make_unary("abs", torch.abs)
ceil = _make_unary("ceil", torch.ceil)
floor = _make_unary("floor", torch.floor)
round = _make_unary("round", torch.round)
trunc = _make_unary("trunc", torch.trunc)
sin = _make_unary("sin", _float_op(torch.sin))
cos = _make_unary("cos", _float_op(torch.cos))
tan = _make_unary("tan", _float_op(torch.tan))
asin = _make_unary("asin", _float_op(torch.asin))
acos = _make_unary("acos", _float_op(torch.acos))
atan = _make_unary("atan", _float_op(torch.atan))
sinh = _make_unary("sinh", _float_op(torch.sinh))
cosh = _make_unary("cosh", _float_op(torch.cosh))
tanh = _make_unary("tanh", _float_op(torch.tanh))
asinh = _make_unary("asinh", _float_op(torch.asinh))
acosh = _make_unary("acosh", _float_op(torch.acosh))
atanh = _make_unary("atanh", _float_op(torch.atanh))
erf = _make_unary("erf", _float_op(torch.erf))
erfinv = _make_unary("erfinv", _float_op(torch.erfinv))
reciprocal = _make_unary("reciprocal", lambda a: 1.0 / a)
sign = _make_unary("sign", _sign)
sgn = _make_unary("sgn", _sign)
neg = _make_unary("neg", torch.neg)
negative = _make_unary("negative", torch.neg)
conj = _make_unary("conj", torch.conj_physical)
angle = _make_unary("angle", _angle)
real = _make_unary("real", _real_or_zero(torch.real))
imag = _make_unary("imag", _real_or_zero(torch.imag))
deg2rad = _make_unary("deg2rad", _float_op(torch.deg2rad))
rad2deg = _make_unary("rad2deg", _float_op(torch.rad2deg))
frac = _make_unary("frac", lambda a: a - torch.trunc(a))
digamma = _make_unary("digamma", _float_op(torch.digamma))
lgamma = _make_unary("lgamma", _float_op(torch.lgamma))
gammaln = _make_unary("gammaln", _float_op(torch.lgamma))
sigmoid = _make_unary("sigmoid", _float_op(torch.sigmoid))
logit = _make_unary("logit", _float_op(torch.logit))
i0 = _make_unary("i0", _float_op(torch.special.i0))
i0e = _make_unary("i0e", _float_op(torch.special.i0e))
i1 = _make_unary("i1", _float_op(torch.special.i1))
i1e = _make_unary("i1e", _float_op(torch.special.i1e))
isnan = _make_unary("isnan", torch.isnan)
isinf = _make_unary("isinf", torch.isinf)
isfinite = _make_unary("isfinite", torch.isfinite)
isneginf = _make_unary("isneginf", torch.isneginf)
isposinf = _make_unary("isposinf", torch.isposinf)
isreal = _make_unary("isreal", torch.isreal)
bitwise_not = _make_unary("bitwise_not", torch.bitwise_not)
logical_not = _make_unary("logical_not", torch.logical_not)


# ---------------------------------------------------------------------------
# binary elementwise (broadcasting; scalar operands closed over)
# ---------------------------------------------------------------------------
def _weak(v, like):
    """A Python scalar as a 0-d tensor beside ``like`` (a fill, so a CUDA
    graph can capture it): in ``like``'s type unless a float meets an int
    or bool tensor, then float64 (JAX's x64 lattice)."""
    if isinstance(v, float) and not (like.is_floating_point() or
                                     like.is_complex()):
        dt = torch.float64
    else:
        dt = like.dtype
    return torch.full((), v, dtype=dt, device=like.device)


def _make_binary(name, tfn, exports=None, scalar_ok=True):
    """``tfn(a, b)`` broadcast; a Python scalar ``y`` goes to ``tfn`` as it
    is where torch takes one (``scalar_ok``), else as :func:`_weak`."""
    def op(x, y, name=None):
        scalar = (builtins.bool, int, float)
        if isinstance(x, Tensor) and isinstance(y, scalar):
            if scalar_ok:
                return apply(op.__name__, lambda a: tfn(a, y), x)
            return apply(op.__name__, lambda a: tfn(a, _weak(y, a)), x)
        if isinstance(y, Tensor) and isinstance(x, scalar):
            # torch ops take no Python scalar first; a 0-d tensor takes
            # the other operand's type as the scalar would
            return apply(op.__name__,
                         lambda b: tfn(torch.as_tensor(x, device=b.device)
                                       if scalar_ok else _weak(x, b), b), y)
        return apply(op.__name__, tfn, as_tensor(x), as_tensor(y))
    op.__name__ = op.__qualname__ = name
    (__all__ if exports is None else exports).append(name)
    return op


def _is_float(v):
    return isinstance(v, float) or (isinstance(v, torch.Tensor) and (
        v.is_floating_point() or v.is_complex()))


def _true_divide(a, b):
    if not (_is_float(a) or _is_float(b)):
        a = _inexact(a)
    return torch.true_divide(a, b)


def _float2(tfn):
    def fn(a, b):
        if not (_is_float(a) or _is_float(b)):
            a = _inexact(a)
        return tfn(a, b)
    return fn


def _heaviside(a, b):
    # JAX's where form: the gradient reaches b where a is 0
    zero, one = torch.zeros((), dtype=a.dtype, device=a.device), \
        torch.ones((), dtype=a.dtype, device=a.device)
    return torch.where(a < 0, zero, torch.where(a > 0, one, b.to(a.dtype)))


def _ldexp(a, b):
    if a.is_floating_point():
        return a * torch.pow(2.0, b.to(a.dtype))
    return torch.ldexp(a, b)


add = _make_binary("add", torch.add)
subtract = _make_binary("subtract", torch.sub)
multiply = _make_binary("multiply", torch.mul)
divide = _make_binary("divide", _true_divide)
floor_divide = _make_binary("floor_divide", torch.floor_divide)
mod = _make_binary("mod", torch.remainder)
remainder = _make_binary("remainder", torch.remainder)
floor_mod = _make_binary("floor_mod", torch.remainder)
fmod = _make_binary("fmod", torch.fmod)
pow = _make_binary("pow", torch.pow)
maximum = _make_binary("maximum", torch.maximum, scalar_ok=False)
minimum = _make_binary("minimum", torch.minimum, scalar_ok=False)
fmax = _make_binary("fmax", torch.fmax, scalar_ok=False)
fmin = _make_binary("fmin", torch.fmin, scalar_ok=False)
atan2 = _make_binary("atan2", _float2(torch.atan2), scalar_ok=False)
hypot = _make_binary("hypot", _float2(torch.hypot), scalar_ok=False)
heaviside = _make_binary("heaviside", _heaviside, scalar_ok=False)
gcd = _make_binary("gcd", torch.gcd, scalar_ok=False)
lcm = _make_binary("lcm", torch.lcm, scalar_ok=False)
copysign = _make_binary("copysign", _float2(torch.copysign),
                        scalar_ok=False)
nextafter = _make_binary("nextafter", torch.nextafter, scalar_ok=False)
ldexp = _make_binary("ldexp", _ldexp, scalar_ok=False)
logaddexp = _make_binary("logaddexp", _float2(torch.logaddexp),
                         scalar_ok=False)
bitwise_and = _make_binary("bitwise_and", torch.bitwise_and)
bitwise_or = _make_binary("bitwise_or", torch.bitwise_or)
bitwise_xor = _make_binary("bitwise_xor", torch.bitwise_xor)
logical_and = _make_binary("logical_and", torch.logical_and,
                           scalar_ok=False)
logical_or = _make_binary("logical_or", torch.logical_or, scalar_ok=False)
logical_xor = _make_binary("logical_xor", torch.logical_xor,
                           scalar_ok=False)
left_shift = _make_binary("left_shift", torch.bitwise_left_shift)
right_shift = _make_binary("right_shift", torch.bitwise_right_shift)


@_export
def divide_no_nan(x, y, name=None):
    def fn(a, b):
        zero = b == 0
        return torch.where(zero, torch.zeros((), dtype=a.dtype,
                                             device=a.device),
                           a / torch.where(zero, torch.ones_like(b), b))
    return apply("divide_no_nan", fn, as_tensor(x), as_tensor(y))


@_export
def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None,
          name=None):
    x = as_tensor(x)
    s, b = _scalar(scale), _scalar(bias)
    if bias_after_scale:
        out = apply("scale", lambda a: a * s + b, x)
    else:
        out = apply("scale", lambda a: (a + b) * s, x)
    if act is not None:
        from ..nn import functional as F
        out = getattr(F, act)(out)
    return out


@_export
def clip(x, min=None, max=None, name=None):
    lo, hi = _scalar(min), _scalar(max)
    return apply("clip", lambda a: torch.clamp(a, lo, hi), as_tensor(x))


@_export
def lerp(x, y, weight, name=None):
    if isinstance(weight, (int, float)):
        w = weight
        return apply("lerp", lambda a, b: a + w * (b - a),
                     as_tensor(x), as_tensor(y))
    return apply("lerp", lambda a, b, w: a + w * (b - a),
                 as_tensor(x), as_tensor(y), as_tensor(weight))


@_export
def stanh(x, scale_a=0.67, scale_b=1.7159, name=None):
    return apply("stanh", lambda a: scale_b * torch.tanh(scale_a * a),
                 as_tensor(x))


@_export
def multiply_(x, y, name=None):
    return x._inplace_assign(multiply(x, y))


@_export
def nan_to_num(x, nan=0.0, posinf=None, neginf=None, name=None):
    return apply("nan_to_num", lambda a: torch.nan_to_num(
        a, nan=nan, posinf=posinf, neginf=neginf), as_tensor(x))


@_export
def add_n(inputs, name=None):
    if isinstance(inputs, Tensor):
        return inputs
    ts = [as_tensor(t) for t in inputs]
    return apply("add_n", lambda *arrs: functools.reduce(torch.add, arrs),
                 *ts)


def _dims(ax, nd):
    if ax is None:
        return tuple(range(nd))
    return ax if isinstance(ax, tuple) else (ax,)


def _keep_all(out, a, keepdim):
    return out.reshape([1] * a.dim()) if keepdim else out


@_export
def count_nonzero(x, axis=None, keepdim=False, name=None):
    ax = _normalize_axis(axis)
    return apply("count_nonzero", lambda a: (a != 0).sum(
        dim=_dims(ax, a.dim()), keepdim=keepdim).to(torch.int64),
        as_tensor(x))


# ---------------------------------------------------------------------------
# reductions
# ---------------------------------------------------------------------------
def _sum_type(a, tdt):
    if tdt is not None:
        return a.to(tdt)
    if a.dtype == torch.bool or (not a.is_floating_point() and
                                 not a.is_complex()):
        return a.to(torch.int64)
    return a


def _make_reduce(name, tfn, has_dtype=False):
    if has_dtype:
        def op(x, axis=None, dtype=None, keepdim=False, name=None):
            ax = _normalize_axis(axis)
            tdt = dtypes.to_torch_dtype(dtype)

            def fn(a):
                a = _sum_type(a, tdt)
                if ax is None:
                    return _keep_all(tfn(a), a, keepdim)
                return tfn(a, ax, keepdim)

            return apply(op.__name__, fn, as_tensor(x))
    else:
        def op(x, axis=None, keepdim=False, name=None):
            ax = _normalize_axis(axis)

            def fn(a):
                if ax is None:
                    return _keep_all(tfn(a), a, keepdim)
                return tfn(a, ax, keepdim)

            return apply(op.__name__, fn, as_tensor(x))
    op.__name__ = op.__qualname__ = name
    __all__.append(name)
    return op


def _over(tfn):
    """``tfn(a, dims, keepdim)`` over one axis or a tuple of them, or every
    axis (``tfn(a)``)."""
    def fn(a, ax=None, keepdim=False):
        dims = _dims(ax, a.dim())
        return tfn(a, dims, keepdim)
    return fn


def _prod(a, dims, keepdim):
    for d in sorted((d % a.dim() for d in dims), reverse=True):
        a = torch.prod(a, dim=d, keepdim=keepdim)
    return a


def _all(a, dims, keepdim):
    return torch.all(a.bool(), dim=dims, keepdim=keepdim) if dims else \
        a.bool()


def _any(a, dims, keepdim):
    return torch.any(a.bool(), dim=dims, keepdim=keepdim) if dims else \
        a.bool()


def _amax(a, dims, keepdim):
    return torch.amax(a, dim=dims, keepdim=keepdim)


def _amin(a, dims, keepdim):
    return torch.amin(a, dim=dims, keepdim=keepdim)


def _nansum(a, dims, keepdim):
    if a.is_floating_point():
        return torch.nansum(a, dim=dims, keepdim=keepdim)
    return torch.sum(a, dim=dims, keepdim=keepdim)


def _nanmean(a, dims, keepdim):
    return torch.nanmean(_inexact(a), dim=dims, keepdim=keepdim)


sum = _make_reduce("sum", _over(lambda a, d, k: torch.sum(a, dim=d,
                                                          keepdim=k)),
                   has_dtype=True)
prod = _make_reduce("prod", _over(_prod), has_dtype=True)
max = _make_reduce("max", _over(_amax))
min = _make_reduce("min", _over(_amin))
amax = _make_reduce("amax", _over(_amax))
amin = _make_reduce("amin", _over(_amin))
all = _make_reduce("all", _over(_all))
any = _make_reduce("any", _over(_any))
nansum = _make_reduce("nansum", _over(_nansum), has_dtype=True)
nanmean = _make_reduce("nanmean", _over(_nanmean))


@_export
def mean(x, axis=None, keepdim=False, name=None):
    ax = _normalize_axis(axis)

    def fn(a):
        a = _inexact(a)
        if ax is None:
            return _keep_all(torch.mean(a), a, keepdim)
        return torch.mean(a, dim=ax, keepdim=keepdim)

    return apply("mean", fn, as_tensor(x))


@_export
def logsumexp(x, axis=None, keepdim=False, name=None):
    ax = _normalize_axis(axis)
    return apply("logsumexp", lambda a: torch.logsumexp(
        _inexact(a), dim=_dims(ax, a.dim()), keepdim=keepdim),
        as_tensor(x))


@_export
def log_normalize(x, axis=-1):
    ax = _normalize_axis(axis)
    return apply("log_normalize", lambda a: a - torch.logsumexp(
        a, dim=_dims(ax, a.dim()), keepdim=True), as_tensor(x))


# ---------------------------------------------------------------------------
# cumulative
# ---------------------------------------------------------------------------
def _cum_type(a, tdt):
    if tdt is not None:
        return tdt
    return torch.int64 if a.dtype == torch.bool else a.dtype


@_export
def cumsum(x, axis=None, dtype=None, name=None):
    tdt = dtypes.to_torch_dtype(dtype)
    ax = None if axis is None else int(axis)

    def fn(a):
        if ax is None:
            a = a.reshape(-1)
        return torch.cumsum(a, dim=0 if ax is None else ax,
                            dtype=_cum_type(a, tdt))

    return apply("cumsum", fn, as_tensor(x))


@_export
def cumprod(x, dim=None, dtype=None, name=None):
    tdt = dtypes.to_torch_dtype(dtype)
    ax = None if dim is None else int(dim)

    def fn(a):
        if ax is None:
            a = a.reshape(-1)
        return torch.cumprod(a, dim=0 if ax is None else ax,
                             dtype=_cum_type(a, tdt))

    return apply("cumprod", fn, as_tensor(x))


def _flatten_for_cum(x):
    from .manipulation import reshape
    return reshape(x, [-1])


def _cum_extreme(name, tfn, newer):
    def op(x, axis=None, dtype="int64", name=None):
        x = as_tensor(x)
        ax = -1 if axis is None else int(axis)
        xin = x if axis is not None else _flatten_for_cum(x)
        vals = apply(op.__name__, lambda a: tfn(a, dim=ax).values, xin)
        return vals, _cum_arg(xin, ax, tfn, newer,
                              dtypes.to_torch_dtype(dtype))
    op.__name__ = op.__qualname__ = name
    __all__.append(name)
    return op


def _cum_arg(x, ax, tfn, newer, idx_dt):
    """The running extreme's index, the first of a tie: a position takes
    its own index only when it beats every earlier value strictly."""
    def fn(a):
        a = a.detach()
        run = tfn(a, dim=ax).values
        n = a.shape[ax]
        prev = torch.cat([run.narrow(ax, 0, 1), run.narrow(ax, 0, n - 1)],
                         dim=ax)
        new = newer(a, prev)
        new.narrow(ax, 0, 1).fill_(True)
        shape = [1] * a.dim()
        shape[ax] = n
        idx = torch.arange(n, device=a.device).reshape(shape)
        own = torch.where(new, idx, torch.zeros((), dtype=idx.dtype,
                                                device=a.device))
        return torch.cummax(own, dim=ax).values.to(idx_dt)
    return apply("cum_arg", fn, x)


cummax = _cum_extreme("cummax", torch.cummax, torch.gt)
cummin = _cum_extreme("cummin", torch.cummin, torch.lt)


@_export
def diff(x, n=1, axis=-1, prepend=None, append=None, name=None):
    x = as_tensor(x)
    extra = [as_tensor(v) for v in (prepend, append) if v is not None]
    has_pre, has_app = prepend is not None, append is not None

    def edge(v, a):
        if v.dim() == 0:
            shape = list(a.shape)
            shape[axis] = 1
            return v.to(a.dtype).expand(shape)
        return v

    def fn(a, *vs):
        it = iter(vs)
        pre = edge(next(it), a) if has_pre else None
        app = edge(next(it), a) if has_app else None
        return torch.diff(a, n=n, dim=axis, prepend=pre, append=app)

    return apply("diff", fn, x, *extra)


# ---------------------------------------------------------------------------
# matrix-ish math living in paddle.tensor.math
# ---------------------------------------------------------------------------
@_export
def addmm(input, x, y, beta=1.0, alpha=1.0, name=None):
    return apply("addmm", lambda i, a, b: beta * i + alpha * (a @ b),
                 as_tensor(input), as_tensor(x), as_tensor(y))


@_export
def inner(x, y, name=None):
    return apply("inner", torch.inner, as_tensor(x), as_tensor(y))


@_export
def outer(x, y, name=None):
    return apply("outer", lambda a, b: torch.outer(a.reshape(-1),
                                                   b.reshape(-1)),
                 as_tensor(x), as_tensor(y))


@_export
def kron(x, y, name=None):
    return apply("kron", torch.kron, as_tensor(x), as_tensor(y))


@_export
def trace(x, offset=0, axis1=0, axis2=1, name=None):
    return apply("trace", lambda a: _sum_type(torch.diagonal(
        a, offset=offset, dim1=axis1, dim2=axis2), None).sum(-1),
        as_tensor(x))


@_export
def diagonal(x, offset=0, axis1=0, axis2=1, name=None):
    return apply("diagonal", lambda a: torch.diagonal(
        a, offset=offset, dim1=axis1, dim2=axis2), as_tensor(x))


@_export
def multiplex(inputs, index, name=None):
    if not isinstance(inputs, (list, tuple)):
        raise TypeError("multiplex expects a list/tuple of tensors, got "
                        f"{type(inputs).__name__}")
    if len(inputs) < 2:
        raise ValueError("multiplex needs at least 2 input tensors")
    ts = [as_tensor(t) for t in inputs]
    idx = as_tensor(index)
    if idx._data.is_floating_point() or idx._data.is_complex() or \
            idx._data.dtype == torch.bool:
        raise TypeError(f"multiplex index must be integer, got {idx.dtype}")

    def fn(i, *arrs):
        stacked = torch.stack(arrs, dim=0)
        rows = torch.arange(arrs[0].shape[0], device=i.device)
        return stacked[i.reshape(-1).long(), rows]

    return apply("multiplex", fn, idx, *ts)


# ---------------------------------------------------------------------------
# in-place variants (computed out of place; the handle is rebound)
# ---------------------------------------------------------------------------
def _make_inplace(name, outofplace):
    def op(x, *args, **kwargs):
        return x._inplace_assign(outofplace(x, *args, **kwargs))
    op.__name__ = op.__qualname__ = name
    op.__doc__ = f"In-place variant of :func:`{outofplace.__name__}`."
    __all__.append(name)
    return op


add_ = _make_inplace("add_", add)
subtract_ = _make_inplace("subtract_", subtract)
clip_ = _make_inplace("clip_", clip)
scale_ = _make_inplace("scale_", scale)
exp_ = _make_inplace("exp_", exp)
sqrt_ = _make_inplace("sqrt_", sqrt)
rsqrt_ = _make_inplace("rsqrt_", rsqrt)
reciprocal_ = _make_inplace("reciprocal_", reciprocal)
floor_ = _make_inplace("floor_", floor)
ceil_ = _make_inplace("ceil_", ceil)
round_ = _make_inplace("round_", round)
abs_ = _make_inplace("abs_", abs)
sin_ = _make_inplace("sin_", sin)
cos_ = _make_inplace("cos_", cos)
tanh_ = _make_inplace("tanh_", tanh)
sigmoid_ = _make_inplace("sigmoid_", sigmoid)
neg_ = _make_inplace("neg_", neg)
lerp_ = _make_inplace("lerp_", lerp)
divide_ = _make_inplace("divide_", divide)
remainder_ = _make_inplace("remainder_", remainder)
mod_ = _make_inplace("mod_", mod)
pow_ = _make_inplace("pow_", pow)
