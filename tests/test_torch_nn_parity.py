"""Parity helpers for the nn layer tests: a Layer of paddle_tpu and the
port's counterpart, the port's loaded from JAX's ``state_dict()``, run on
the same inputs; JAX's forward under ``jax.jit`` through
``_functional_call`` with the gradient of ``sum(out * g)`` (seeded
cotangents) by every input and parameter, the port's through torch's
autograd.  A helper module of the nn test files: it holds no test.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import paddle_tpu as jp  # noqa: E402
from paddle_tpu.tensor.tensor import wrap_array  # noqa: E402
import paddle_tpu_torch as tp  # noqa: E402
from paddle_tpu_torch.models.weights import layer_state_from_jax  # noqa

TOL = dict(rtol=1e-5, atol=1e-5)


def _np(t):
    return np.asarray(t.numpy())


def _r(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _cot(shape, dtype, i):
    return np.asarray(np.random.RandomState(7 + i).randn(*shape)).astype(
        dtype)


def _flat(outs):
    if isinstance(outs, (tuple, list)):
        return [o for x in outs for o in _flat(x)]
    return [outs]


def _is_float(dtype):
    return np.issubdtype(np.dtype(dtype), np.floating)


def _jax_layer(layer, arrays, ints):
    """JAX's layer under jax.jit -> (outputs, input grads, param grads)."""
    params = {n: p._data for n, p in layer.named_parameters()}
    bufs = {n: b._data for n, b in layer.named_buffers()}
    n = len(arrays)

    def f(pv, *arrs):
        outs = layer._functional_call(pv, *[wrap_array(a) for a in arrs],
                                      buffers=bufs)
        outs = [o._data for o in _flat(outs)]
        total = sum(jnp.sum(o * _cot(o.shape, o.dtype, i)) for i, o in
                    enumerate(o for o in outs if _is_float(o.dtype)))
        return total, outs

    (_, outs), grads = jax.jit(jax.value_and_grad(
        f, argnums=tuple(range(n + 1)), has_aux=True))(params, *arrays,
                                                         *ints)
    return ([np.asarray(o) for o in outs],
            [np.asarray(g) for g in grads[1:]],
            {k: np.asarray(v) for k, v in grads[0].items()})


def _torch_layer(layer, arrays, ints):
    ts = [tp.to_tensor(a, stop_gradient=False) for a in arrays]
    outs = _flat(layer(*ts, *[tp.to_tensor(a) for a in ints]))
    total = sum((o * tp.to_tensor(_cot(o.shape, _np(o).dtype, i))).sum()
                for i, o in enumerate(o for o in outs
                                      if o._data.is_floating_point()))
    total.backward()
    zeros = [np.zeros(a.shape, np.float32) for a in arrays]
    return ([_np(o) for o in outs],
            [z if t.grad is None else _np(t.grad) for t, z in zip(ts, zeros)],
            {k: (np.zeros(p.shape, np.float32) if p.grad is None
                 else _np(p.grad)) for k, p in layer.named_parameters()})


def both_layers(make, arrays, ints=(), tol=TOL):
    """make(nn) -> a layer of either package; the port's takes JAX's
    state_dict().  -> the port's outputs."""
    jp.seed(1)
    jl = make(jp.nn)
    tl = make(tp.nn)
    layer_state_from_jax(tl, jl.state_dict())
    jo, jg, jpg = _jax_layer(jl, arrays, ints)
    to, tg, tpg = _torch_layer(tl, arrays, ints)
    assert len(jo) == len(to)
    for a, b in zip(to, jo):
        assert a.shape == b.shape, (a.shape, b.shape)
        if _is_float(b.dtype):
            np.testing.assert_allclose(a, b, **tol)
        else:
            np.testing.assert_array_equal(a, b)
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(a, b, **tol)
    assert set(tpg) == set(jpg)
    for k in jpg:
        np.testing.assert_allclose(tpg[k], jpg[k], err_msg=k, **tol)
    return to
