"""The long tail of the tensor surface (counterpart of
``paddle_tpu/tensor/extras.py``).

Where JAX's function is a formula (``cdist``'s matmul expansion at p = 2,
``pdist``, ``renorm``, ``take``, ``cumulative_trapezoid``), the port
evaluates the same formula, so the rounding is JAX's too.
``bitwise_right_shift(is_arithmetic=False)`` is a logical shift: the
sign bit shifts in zeros (torch's ``>>`` on a signed type is
arithmetic).  ``flops`` counts a Layer's forward FLOPs with hooks, as
JAX's does.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

from ..ops.dispatch import apply, as_tensor
from .tensor import Tensor, wrap_array

__all__ = [
    "block_diag", "logcumsumexp", "is_complex", "is_integer",
    "is_floating_point", "isin", "mm", "shape", "cdist", "pdist", "sinc",
    "gammainc", "gammaincc", "reduce_as", "increment", "set_printoptions",
    "disable_signal_handler", "reverse", "check_shape", "renorm",
    "multigammaln", "take", "frexp", "trapezoid", "cumulative_trapezoid",
    "unflatten", "unfold", "polygamma", "bitwise_left_shift",
    "bitwise_right_shift", "index_fill", "diagonal_scatter", "combinations",
    "signbit", "flops", "LazyGuard", "batch",
]


def block_diag(inputs, name=None):
    ts = [as_tensor(t) for t in inputs]
    return apply("block_diag", lambda *mats: torch.block_diag(
        *[m if m.dim() == 2 else m.reshape(1, -1) for m in mats]), *ts)


def logcumsumexp(x, axis=None, dtype=None, name=None):
    def fn(a):
        if axis is None:
            return torch.logcumsumexp(a.reshape(-1), 0)
        return torch.logcumsumexp(a, int(axis))
    return apply("logcumsumexp", fn, as_tensor(x))


def is_complex(x):
    return as_tensor(x)._data.is_complex()


def is_integer(x):
    d = as_tensor(x)._data
    return not (d.is_floating_point() or d.is_complex() or
                d.dtype == torch.bool)


def is_floating_point(x):
    return as_tensor(x)._data.is_floating_point()


def isin(x, test_x, assume_unique=False, invert=False, name=None):
    return apply("isin", lambda a, b: torch.isin(a, b, invert=invert),
                 as_tensor(x), as_tensor(test_x))


def mm(input, mat2, name=None):
    from .linalg import matmul
    return matmul(input, mat2)


def shape(input):
    """The shape as an int32 tensor."""
    x = as_tensor(input)
    return wrap_array(torch.tensor(x.shape, dtype=torch.int32,
                                   device=x._data.device))


def cdist(x, y, p=2.0, compute_mode="use_mm_for_euclid_dist_if_necessary",
          name=None):
    """p-distances between the rows of [..., P, M] and [..., R, M]; at
    p = 2 by the matmul expansion, as JAX's."""
    def fn(a, b):
        if p == 2.0 and compute_mode in (
                "use_mm_for_euclid_dist_if_necessary",
                "use_mm_for_euclid_dist"):
            a2 = torch.sum(a * a, -1, keepdim=True)
            b2 = torch.sum(b * b, -1, keepdim=True)
            sq = a2 + b2.transpose(-1, -2) - 2 * (a @ b.transpose(-1, -2))
            return torch.sqrt(torch.clamp(sq, min=0.0))
        d = (a[..., :, None, :] - b[..., None, :, :]).abs()
        if p == 0:
            return (d != 0).sum(-1).to(a.dtype)
        if p == float("inf"):
            return d.amax(-1)
        return torch.sum(d ** p, -1) ** (1.0 / p)
    return apply("cdist", fn, as_tensor(x), as_tensor(y))


def pdist(x, p=2.0, name=None):
    """The condensed (upper-triangle) p-distances of the rows of [N, M]."""
    x = as_tensor(x)
    n = x.shape[0]
    iu = np.triu_indices(n, k=1)

    def fn(a):
        d = (a[:, None, :] - a[None, :, :]).abs()
        if p == float("inf"):
            full = d.amax(-1)
        elif p == 0:
            full = (d != 0).sum(-1).to(a.dtype)
        else:
            full = torch.sum(d ** p, -1) ** (1.0 / p)
        return full[torch.from_numpy(iu[0]).to(a.device),
                    torch.from_numpy(iu[1]).to(a.device)]

    return apply("pdist", fn, x)


def sinc(x, name=None):
    return apply("sinc", torch.sinc, as_tensor(x))


def gammainc(x, y, name=None):
    """The regularised lower incomplete gamma P(x, y)."""
    return apply("gammainc", torch.special.gammainc, as_tensor(x),
                 as_tensor(y))


def gammaincc(x, y, name=None):
    return apply("gammaincc", torch.special.gammaincc, as_tensor(x),
                 as_tensor(y))


def reduce_as(x, target, name=None):
    """``x`` summed down to ``target``'s shape."""
    tshape = tuple(as_tensor(target).shape)

    def fn(a, t):
        extra = a.dim() - len(tshape)
        axes = list(range(extra)) + [extra + i for i, s in enumerate(tshape)
                                     if a.shape[extra + i] != s]
        out = torch.sum(a, dim=tuple(axes)) if axes else a
        return out.reshape(tshape)

    return apply("reduce_as", fn, as_tensor(x), as_tensor(target))


def increment(x, value=1.0, name=None):
    out = apply("increment", lambda a: a + value, as_tensor(x))
    if isinstance(x, Tensor):
        return x._inplace_assign(out)
    return out


def set_printoptions(precision=None, threshold=None, edgeitems=None,
                     sci_mode=None, linewidth=None):
    """Tensor printing goes through numpy: its print options."""
    kw = {}
    if precision is not None:
        kw["precision"] = precision
    if threshold is not None:
        kw["threshold"] = threshold
    if edgeitems is not None:
        kw["edgeitems"] = edgeitems
    if linewidth is not None:
        kw["linewidth"] = linewidth
    if sci_mode is not None:
        kw["suppress"] = not sci_mode
    np.set_printoptions(**kw)


def disable_signal_handler():
    """Nothing to do: the port installs no signal handlers."""


def reverse(x, axis, name=None):
    from .manipulation import flip
    return flip(x, axis)


def check_shape(x, shape=None):
    if shape is not None and tuple(as_tensor(x).shape) != tuple(shape):
        raise ValueError(
            f"shape mismatch: got {tuple(as_tensor(x).shape)}, "
            f"expected {tuple(shape)}")
    return x


def renorm(x, p, axis, max_norm, name=None):
    """Each slice along ``axis`` scaled to a p-norm of at most
    ``max_norm``."""
    x = as_tensor(x)
    ax = axis % x.ndim

    def fn(a):
        red = tuple(i for i in range(a.dim()) if i != ax)
        norms = torch.sum(a.abs() ** p, dim=red, keepdim=True) ** (1.0 / p)
        scale = torch.where(norms > max_norm, max_norm / (norms + 1e-7),
                            torch.ones_like(norms))
        return a * scale

    return apply("renorm", fn, x)


def multigammaln(x, p, name=None):
    return apply("multigammaln", lambda a: torch.special.multigammaln(a, p),
                 as_tensor(x))


def take(x, index, mode="raise", name=None):
    """A gather from the flattened ``x``: negative indices wrap, "wrap"
    takes them modulo the size, "clip" clamps into [0, n - 1]."""
    def fn(a, i):
        flat = a.reshape(-1)
        n = flat.shape[0]
        i = i.long()
        if mode == "wrap":
            i = torch.remainder(i, n)
        elif mode == "clip":
            i = i.clamp(0, n - 1)
        else:
            i = torch.where(i < 0, i + n, i)
        return flat[i]
    return apply("take", fn, as_tensor(x), as_tensor(index))


def frexp(x, name=None):
    """(mantissa, int32 exponent) with x = mantissa * 2 ** exponent."""
    return apply("frexp", lambda a: tuple(torch.frexp(a)), as_tensor(x))


def trapezoid(y, x=None, dx=None, axis=-1, name=None):
    y = as_tensor(y)
    if x is not None:
        return apply("trapezoid", lambda a, b: torch.trapezoid(a, b,
                                                               dim=axis),
                     y, as_tensor(x))
    return apply("trapezoid", lambda a: torch.trapezoid(
        a, dx=dx or 1.0, dim=axis), y)


def cumulative_trapezoid(y, x=None, dx=None, axis=-1, name=None):
    y = as_tensor(y)

    def core(a, xs=None):
        n = a.shape[axis]
        a1, a0 = a.narrow(axis, 1, n - 1), a.narrow(axis, 0, n - 1)
        if xs is not None:
            m = xs.shape[axis]
            d = xs.narrow(axis, 1, m - 1) - xs.narrow(axis, 0, m - 1)
        else:
            d = dx or 1.0
        return torch.cumsum((a0 + a1) * d / 2.0, dim=axis)

    if x is not None:
        return apply("cumulative_trapezoid", core, y, as_tensor(x))
    return apply("cumulative_trapezoid", core, y)


def unflatten(x, axis, shape, name=None):
    from .manipulation import reshape
    x = as_tensor(x)
    ax = axis % x.ndim
    shape = tuple(int(s) for s in shape)
    if -1 in shape:
        known = int(np.prod([s for s in shape if s != -1]))
        shape = tuple(x.shape[ax] // known if s == -1 else s for s in shape)
    return reshape(x, tuple(x.shape[:ax]) + shape + tuple(x.shape[ax + 1:]))


def unfold(x, axis, size, step, name=None):
    """Sliding windows along ``axis``: the windows take its place and each
    window's elements form a new last axis."""
    x = as_tensor(x)
    ax = axis % x.ndim
    return apply("unfold", lambda a: a.unfold(ax, size, step), x)


def polygamma(x, n, name=None):
    return apply("polygamma", lambda a: torch.special.polygamma(n, a),
                 as_tensor(x))


def bitwise_left_shift(x, y, is_arithmetic=True, name=None):
    return apply("bitwise_left_shift", lambda a, b: torch.bitwise_left_shift(
        a, b.to(a.dtype)), as_tensor(x), as_tensor(y))


def _shift_right_logical(a, b):
    b = b.to(a.dtype)
    width = a.element_size() * 8
    shifted = torch.bitwise_right_shift(a, b)
    zero = torch.zeros((), dtype=a.dtype, device=a.device)
    if a.dtype == torch.uint8:
        return torch.where(b >= width, zero, shifted)
    # the arithmetic shift with the copies of the sign bit masked off
    one = torch.ones((), dtype=a.dtype, device=a.device)
    mask = torch.bitwise_left_shift(one, (width - b).clamp(1, width - 1)) - 1
    out = torch.where(b > 0, shifted & mask, a)
    return torch.where(b >= width, zero, out)


def bitwise_right_shift(x, y, is_arithmetic=True, name=None):
    fn = (lambda a, b: torch.bitwise_right_shift(a, b.to(a.dtype))) \
        if is_arithmetic else _shift_right_logical
    return apply("bitwise_right_shift", fn, as_tensor(x), as_tensor(y))


def index_fill(x, index, axis, value, name=None):
    x = as_tensor(x)
    ax = axis % x.ndim

    def fn(a, i):
        i = i.long().reshape(-1)
        i = torch.where(i < 0, i + a.shape[ax], i)
        return torch.index_fill(a, ax, i, value)

    return apply("index_fill", fn, x, as_tensor(index))


def diagonal_scatter(x, y, offset=0, axis1=0, axis2=1, name=None):
    """``x`` with ``y`` written onto the diagonal selected as
    ``diagonal(x, offset, axis1, axis2)`` selects it."""
    return apply("diagonal_scatter", lambda a, b: torch.diagonal_scatter(
        a, b.to(a.dtype), offset, axis1, axis2), as_tensor(x), as_tensor(y))


def combinations(x, r=2, with_replacement=False, name=None):
    x = as_tensor(x)
    n = x.shape[0]
    maker = itertools.combinations_with_replacement if with_replacement \
        else itertools.combinations
    idx = np.asarray(list(maker(range(n), r)), np.int64).reshape(-1, r)
    return apply("combinations", lambda a: a[torch.from_numpy(idx).to(
        a.device)], x)


def signbit(x, name=None):
    return apply("signbit", torch.signbit, as_tensor(x))


# ---------------------------------------------------------------------------
# utilities
# ---------------------------------------------------------------------------
def flops(net, input_size, custom_ops=None, print_detail=False):
    """A Layer's forward FLOPs for one zero input of ``input_size``,
    counted by hooks on its Conv / Linear sublayers."""
    from .creation import zeros
    counts = {"flops": 0}
    details = []

    def conv_flops(layer, x, out):
        kh_kw = int(np.prod(layer._kernel_size)) if hasattr(
            layer, "_kernel_size") else 1
        cin = getattr(layer, "_in_channels", 1)
        groups = getattr(layer, "_groups", 1)
        return int(np.prod(out.shape)) * cin // groups * kh_kw * 2

    def linear_flops(layer, x, out):
        return 2 * int(np.prod(x.shape)) * layer.weight.shape[-1]

    handlers = {"Conv2D": conv_flops, "Conv1D": conv_flops,
                "Conv3D": conv_flops, "Linear": linear_flops}
    if custom_ops:
        handlers.update({k.__name__ if isinstance(k, type) else k: v
                         for k, v in custom_ops.items()})

    def hook(lyr, inputs, outputs):
        h = handlers.get(type(lyr).__name__)
        if h is not None:
            f = int(h(lyr, inputs[0], outputs))
            counts["flops"] += f
            details.append((type(lyr).__name__, f))

    hooks = [sub.register_forward_post_hook(hook)
             for sub in net.sublayers(include_self=True)]
    try:
        was_training = net.training
        net.eval()
        net(zeros(list(input_size)))
        if was_training:
            net.train()
    finally:
        for h in hooks:
            h.remove()
    if print_detail:
        for name, f in details:
            print(f"{name:>12}: {f:,} FLOPs")
        print(f"Total FLOPs: {counts['flops']:,}")
    return counts["flops"]


class LazyGuard:
    """A scope for deferred parameter creation; layers built inside
    behave as outside (parameters are made when the layer is)."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def batch(reader, batch_size, drop_last=False):
    """A sample reader wrapped into a reader of lists of
    ``batch_size``."""
    def batched():
        buf = []
        for item in reader():
            buf.append(item)
            if len(buf) == batch_size:
                yield buf
                buf = []
        if buf and not drop_last:
            yield buf
    return batched

