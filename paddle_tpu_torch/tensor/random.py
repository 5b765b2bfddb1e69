"""Random sampling ops (counterpart of ``paddle_tpu/tensor/random.py``).

Every draw comes from the framework's generator of the device it lands on
(``framework/random.py``): new tensors on the current place, draws shaped
like an input on the input's device.  ``paddle.seed`` restarts every
device's generator, so the same seed gives the same draws on the card.
The bits differ from ``jax.random``'s; the laws, shapes and types are
JAX's (``standard_gamma`` is float64, as JAX's x64 default gives).
``standard_gamma`` is Marsaglia and Tsang's rejection sampler on the
generator (torch's own gamma takes no generator).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..framework import dtype as dtypes
from ..framework import place as places
from ..framework import random as framework_random
from ..ops.dispatch import apply, as_tensor
from .tensor import Tensor, wrap_array

__all__ = [
    "rand", "randn", "randint", "randint_like", "randperm", "uniform",
    "uniform_", "normal", "normal_", "standard_normal", "standard_gamma",
    "multinomial", "bernoulli", "bernoulli_", "poisson", "binomial",
    "exponential_", "randn_like", "rand_like", "log_normal",
    "log_normal_", "geometric_",
]


def _shape_list(shape):
    if isinstance(shape, Tensor):
        return tuple(int(s) for s in shape.tolist())
    if isinstance(shape, (int, np.integer)):
        return (int(shape),)
    return tuple(int(s.item()) if isinstance(s, Tensor) else int(s)
                 for s in shape)


def _dt(dtype, default="float32"):
    return dtypes.to_torch_dtype(dtype if dtype is not None else default)


def _gen(device):
    return framework_random.generator(device)


def _dev():
    return places.current_torch_device()


def rand(shape, dtype=None, name=None) -> Tensor:
    return uniform(shape, dtype=dtype, min=0.0, max=1.0)


def randn(shape, dtype=None, name=None) -> Tensor:
    return standard_normal(shape, dtype=dtype)


def standard_normal(shape, dtype=None, name=None) -> Tensor:
    dev = _dev()
    return wrap_array(torch.randn(_shape_list(shape), generator=_gen(dev),
                                  dtype=_dt(dtype), device=dev))


def _uniform_on(shape, tdt, lo, hi, dev, seed=0):
    gen = torch.Generator(device=dev).manual_seed(int(seed)) if seed else \
        _gen(dev)
    u = torch.rand(shape, generator=gen, dtype=tdt, device=dev)
    return u * (float(hi) - float(lo)) + float(lo)


def uniform(shape, dtype=None, min=-1.0, max=1.0, seed=0, name=None):
    return wrap_array(_uniform_on(_shape_list(shape), _dt(dtype), min, max,
                                  _dev(), seed))


def uniform_(x, min=-1.0, max=1.0, seed=0, name=None):
    d = x._data
    with torch.no_grad():
        return x._inplace_assign(wrap_array(_uniform_on(
            tuple(d.shape), d.dtype, min, max, d.device, seed)))


def _randn_on(shape, tdt, dev):
    return torch.randn(shape, generator=_gen(dev), dtype=tdt, device=dev)


def normal(mean=0.0, std=1.0, shape=None, name=None):
    if isinstance(mean, Tensor) or isinstance(std, Tensor):
        m, s = as_tensor(mean), as_tensor(std)
        sh = tuple(np.broadcast_shapes(tuple(m.shape), tuple(s.shape)))

        def fn(mm, ss):
            dt = mm.dtype if mm.is_floating_point() else torch.float32
            return mm + ss * _randn_on(sh, dt, mm.device)

        return apply("normal", fn, m, s)
    sh = _shape_list(shape if shape is not None else [1])
    return wrap_array(float(mean) + float(std) * _randn_on(
        sh, _dt(None), _dev()))


def normal_(x, mean=0.0, std=1.0, name=None):
    d = x._data
    with torch.no_grad():
        vals = float(mean) + float(std) * _randn_on(
            tuple(d.shape), torch.float32, d.device)
        return x._inplace_assign(wrap_array(vals.to(d.dtype)))


def log_normal(mean=1.0, std=2.0, shape=None, name=None):
    from .math import exp
    return exp(normal(mean, std, shape))


def log_normal_(x, mean=1.0, std=2.0, name=None):
    return x._inplace_assign(log_normal(mean, std, list(x.shape)))


def randint(low=0, high=None, shape=(1,), dtype=None, name=None) -> Tensor:
    if high is None:
        low, high = 0, low
    dev = _dev()
    return wrap_array(torch.randint(int(low), int(high), _shape_list(shape),
                                    generator=_gen(dev),
                                    dtype=_dt(dtype, "int64"), device=dev))


def randint_like(x, low=0, high=None, dtype=None, name=None) -> Tensor:
    x = as_tensor(x)
    return randint(low, high, shape=x.shape,
                   dtype=dtype if dtype is not None else x.dtype)


def randn_like(x, dtype=None, name=None):
    x = as_tensor(x)
    return standard_normal(x.shape,
                           dtype=dtype if dtype is not None else x.dtype)


def rand_like(x, dtype=None, name=None):
    x = as_tensor(x)
    return rand(x.shape, dtype=dtype if dtype is not None else x.dtype)


def randperm(n, dtype="int64", name=None) -> Tensor:
    dev = _dev()
    return wrap_array(torch.randperm(int(n), generator=_gen(dev),
                                     device=dev).to(_dt(dtype, "int64")))


def multinomial(x, num_samples=1, replacement=False, name=None) -> Tensor:
    """``num_samples`` int64 category indices a row of ``x``'s weights;
    without ``replacement`` they are distinct."""
    return apply("multinomial", lambda p: torch.multinomial(
        p.float(), num_samples, replacement=replacement,
        generator=_gen(p.device)).to(torch.int64), as_tensor(x))


def bernoulli(x, name=None) -> Tensor:
    return apply("bernoulli", lambda p: torch.bernoulli(
        p.detach(), generator=_gen(p.device)), as_tensor(x))


def bernoulli_(x, p=0.5, name=None):
    d = x._data
    with torch.no_grad():
        u = torch.rand(tuple(d.shape), generator=_gen(d.device),
                       device=d.device)
        return x._inplace_assign(wrap_array((u < p).to(d.dtype)))


def poisson(x, name=None) -> Tensor:
    return apply("poisson", lambda lam: torch.poisson(
        lam.detach(), generator=_gen(lam.device)), as_tensor(x))


def binomial(count, prob, name=None) -> Tensor:
    return apply("binomial", lambda n, p: torch.binomial(
        n.detach().float(), p.detach().float(),
        generator=_gen(n.device)).to(torch.int64),
        as_tensor(count), as_tensor(prob))


def exponential_(x, lam=1.0, name=None):
    d = x._data
    with torch.no_grad():
        vals = torch.empty(tuple(d.shape), dtype=torch.float32,
                           device=d.device).exponential_(
            1.0, generator=_gen(d.device)) / lam
        return x._inplace_assign(wrap_array(vals.to(d.dtype)))


def _gamma(alpha, gen):
    """Gamma(alpha, 1) draws (float64) by Marsaglia and Tsang's method:
    alpha < 1 draws Gamma(alpha + 1) and scales by U^(1/alpha)."""
    a = alpha.double()
    boost = a < 1
    a1 = torch.where(boost, a + 1, a)
    d = a1 - 1.0 / 3.0
    c = 1.0 / torch.sqrt(9.0 * d)
    out = torch.zeros_like(a1)
    todo = torch.ones_like(a1, dtype=torch.bool)
    while bool(todo.any()):
        z = torch.randn(a1.shape, generator=gen, dtype=torch.float64,
                        device=a1.device)
        u = torch.rand(a1.shape, generator=gen, dtype=torch.float64,
                       device=a1.device)
        v = (1 + c * z) ** 3
        ok = (v > 0) & (torch.log(u) < 0.5 * z * z + d - d * v +
                        d * torch.log(torch.where(v > 0, v,
                                                  torch.ones_like(v))))
        take = todo & ok
        out = torch.where(take, d * v, out)
        todo = todo & ~ok
    u = torch.rand(a1.shape, generator=gen, dtype=torch.float64,
                   device=a1.device)
    return torch.where(boost, out * u ** (1.0 / a), out)


def standard_gamma(x, name=None) -> Tensor:
    a = as_tensor(x)._data.detach()
    return wrap_array(_gamma(a, _gen(a.device)))


def geometric_(x, probs=0.5, name=None):
    """Fill ``x`` with Geometric(probs) draws (trials until the first
    success)."""
    def fn(a):
        u = torch.rand(a.shape, generator=_gen(a.device),
                       dtype=torch.float32, device=a.device)
        u = u * (1.0 - 1e-7) + 1e-7
        g = torch.ceil(torch.log(u) / math.log1p(-float(probs)))
        return g.to(a.dtype)
    return x._inplace_assign(apply("geometric_", fn, x))
