"""The port's RoPE tables and fused_rope (CPU route: the kernel's plain
version behind the autograd.Function) held against paddle_tpu's: the Pallas
kernel in interpret mode and its ``_composite``.

Inputs are made with numpy from a seed, fp32 on both sides.  Tolerance 1e-5:
fp32 ``theta ** x`` differs by an ulp between XLA and torch, times the
position.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from paddle_tpu.flags import set_flags  # noqa: E402
from paddle_tpu.ops.pallas import rope as jrope  # noqa: E402
from paddle_tpu_torch.ops import rope as trope  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(autouse=True)
def _interpret_mode():
    set_flags({"FLAGS_pallas_interpret": True})
    yield
    set_flags({"FLAGS_pallas_interpret": False})


@pytest.mark.parametrize("s,d", [(16, 128), (7, 32), (33, 128)])
def test_rope_tables_match_jax(s, d):
    jc, js = jrope.rope_tables(s, d, 10000.0)
    tc, ts = trope.rope_tables(s, d, 10000.0, device="cpu")
    assert tc.dtype == torch.float32 and tuple(tc.shape) == (s, d // 2)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), **TOL)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), **TOL)
    inv = trope.rope_inv_freq(d, 500000.0, device="cpu")
    np.testing.assert_allclose(
        inv.numpy(), np.asarray(jrope.rope_inv_freq(d, 500000.0)), rtol=1e-6)


# (16, 128): the Pallas kernel proper; (7, 32) and (33, 128): odd lengths,
# where the JAX wrapper's block choice differs and the port has one branch
@pytest.mark.parametrize("b,s,n,d", [(2, 16, 4, 128), (1, 7, 2, 32),
                                     (2, 33, 3, 128)])
def test_fused_rope_forward_and_vjp_match_jax(b, s, n, d):
    rng = np.random.default_rng(s * d)
    x = rng.standard_normal((b, s, n, d)).astype(np.float32)
    ct = rng.standard_normal((b, s, n, d)).astype(np.float32)
    cos, sin = jrope.rope_tables(s, d, 10000.0)
    cos_n, sin_n = np.array(cos), np.array(sin)

    ref, vjp = jax.vjp(lambda a: jrope.fused_rope(a, cos, sin),
                       jnp.asarray(x))
    (ref_dx,) = vjp(jnp.asarray(ct))
    comp = jrope._composite(jnp.asarray(x), cos, sin, False)

    tx = torch.from_numpy(x).requires_grad_(True)
    out = trope.fused_rope(tx, torch.from_numpy(cos_n),
                           torch.from_numpy(sin_n))
    out.backward(torch.from_numpy(ct))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), **TOL)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(comp), **TOL)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(ref_dx), **TOL)


def test_fused_rope_vjp_is_the_inverse_rotation():
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((1, 9, 2, 32)).astype(np.float32))
    cos, sin = trope.rope_tables(9, 32, device="cpu")
    back = trope._composite(trope._composite(x, cos, sin, False), cos, sin,
                            True)
    np.testing.assert_allclose(back.numpy(), x.numpy(), **TOL)


def test_fused_rope_on_the_cpu_launches_no_kernel():
    before = trope.launches
    cos, sin = trope.rope_tables(4, 16, device="cpu")
    trope.fused_rope(torch.zeros(1, 4, 1, 16), cos, sin)
    assert trope.launches == before
