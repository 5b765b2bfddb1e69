"""The port's rms_norm (CPU route: the kernels' plain versions behind the
autograd.Function) held against paddle_tpu's Pallas ``rms_norm`` in
interpret mode: forward and vjp, on inputs made with numpy from a seed.

Tolerances: 1e-5 in f32 (one f32 sum of squares in another order).  With
bf16 x and an f32 weight (the promote case) both sides compute in f32 from
the same bf16 values and write f32, so the output keeps 1e-5; dx is rounded
to bf16 on both sides, so it is held to one bf16 step (2**-7 relative).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from paddle_tpu.flags import set_flags  # noqa: E402
from paddle_tpu.ops.pallas.rms_norm import rms_norm as j_rms_norm  # noqa: E402
from paddle_tpu_torch.ops import rms_norm as trn  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)
BF16_TOL = dict(atol=2 ** -7, rtol=2 ** -7)


@pytest.fixture(autouse=True)
def _interpret_mode():
    set_flags({"FLAGS_pallas_interpret": True})
    yield
    set_flags({"FLAGS_pallas_interpret": False})


def _case(shape, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    w = (1.0 + 0.1 * rng.standard_normal(shape[-1])).astype(np.float32)
    ct = rng.standard_normal(shape).astype(np.float32)
    return x, w, ct


def _jax(x, w, ct, eps=1e-6):
    out, vjp = jax.vjp(lambda a, b: j_rms_norm(a, b, eps), x, w)
    dx, dw = vjp(ct)
    return np.asarray(out, np.float32), np.asarray(dx, np.float32), \
        np.asarray(dw, np.float32)


def _port(x, w, ct, eps=1e-6):
    tx, tw = x.requires_grad_(True), w.requires_grad_(True)
    out = trn.rms_norm(tx, tw, eps)
    out.backward(ct)
    return out, tx.grad, tw.grad


# [4, 16, 256]: JAX's own test shape; [5, 3, 128]: 15 rows, which no block
# of the TPU kernel's choice above one divides; [7, 96]: a row length no
# multiple of 128 (the trunk never routes it, the op takes it)
@pytest.mark.parametrize("shape,eps", [((4, 16, 256), 1e-6),
                                       ((5, 3, 128), 1e-5),
                                       ((7, 96), 1e-6)])
def test_rms_norm_forward_and_vjp_match_jax(shape, eps):
    x, w, ct = _case(shape, sum(shape))
    ref, ref_dx, ref_dw = _jax(jnp.asarray(x), jnp.asarray(w),
                               jnp.asarray(ct), eps)
    out, dx, dw = _port(torch.from_numpy(x), torch.from_numpy(w),
                        torch.from_numpy(ct), eps)
    assert out.dtype == torch.float32 and out.shape == shape
    np.testing.assert_allclose(out.detach().numpy(), ref, **TOL)
    np.testing.assert_allclose(dx.numpy(), ref_dx, **TOL)
    # dw sums n rows of f32 products in another order
    np.testing.assert_allclose(dw.numpy(), ref_dw, atol=1e-4, rtol=1e-5)


def test_rms_norm_promotes_bf16_x_with_an_f32_weight():
    """Out is promote(x, w) = f32; dx comes back in x's type and dw in
    w's, on both sides."""
    x, w, ct = _case((6, 128), 3)
    xb = x.astype(jnp.bfloat16)
    ref, ref_dx, ref_dw = _jax(jnp.asarray(xb), jnp.asarray(w),
                               jnp.asarray(ct))
    tx = torch.from_numpy(np.asarray(xb, np.float32)).to(torch.bfloat16)
    out, dx, dw = _port(tx, torch.from_numpy(w), torch.from_numpy(ct))
    assert out.dtype == torch.float32
    assert dx.dtype == torch.bfloat16 and dw.dtype == torch.float32
    np.testing.assert_allclose(out.detach().numpy(), ref, **TOL)
    np.testing.assert_allclose(dx.float().numpy(), ref_dx, **BF16_TOL)
    np.testing.assert_allclose(dw.numpy(), ref_dw, atol=1e-4, rtol=1e-5)


def test_plain_rms_norm_rounds_once_where_the_composite_rounds_twice():
    """The kernel's formula is not the trunk's composite: in bf16 the
    composite rounds x * rstd before the weight multiplies it."""
    from paddle_tpu_torch.models.llama_pretrain import _rms_norm
    x, w, _ = _case((64, 128), 4)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    wb = torch.from_numpy(w).to(torch.bfloat16)
    once, rstd = trn.rms_norm_plain(xb, wb)
    exact = (xb.float() * rstd[:, None] * wb.float())
    assert torch.equal(once, exact.to(torch.bfloat16))
    assert not torch.equal(once, _rms_norm(xb, wb, 1e-6))


def test_rms_norm_on_the_cpu_launches_no_kernel():
    before = (trn.launches, trn.launches_bwd)
    x = torch.ones((2, 128), requires_grad=True)
    trn.rms_norm(x, torch.ones(128)).sum().backward()
    assert (trn.launches, trn.launches_bwd) == before
