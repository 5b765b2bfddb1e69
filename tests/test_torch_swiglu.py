"""The port's swiglu (CPU route: the kernels' plain versions behind the
autograd.Function) held against paddle_tpu's Pallas ``swiglu`` in interpret
mode: forward and vjp, on inputs made with numpy from a seed.

Tolerance 1e-5 in f32 (XLA's and torch's f32 sigmoid differ by an ulp); in
bf16 both sides compute in f32 from the same values and round once, so a
result may sit one bf16 step (2**-7 relative) apart where the f32 value
lies near a rounding boundary.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from paddle_tpu.flags import set_flags  # noqa: E402
from paddle_tpu.ops.pallas.swiglu import swiglu as j_swiglu  # noqa: E402
from paddle_tpu_torch.ops import swiglu as tsw  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)
BF16_TOL = dict(atol=2 ** -7, rtol=2 ** -7)


@pytest.fixture(autouse=True)
def _interpret_mode():
    set_flags({"FLAGS_pallas_interpret": True})
    yield
    set_flags({"FLAGS_pallas_interpret": False})


# [6, 256]: JAX's own test shape; [3, 5, 7]: 15 rows of 7, no vector width
# divides; [2, 16, 128]: the trunk's FFN shape at the test models' size
@pytest.mark.parametrize("shape", [(6, 256), (3, 5, 7), (2, 16, 128)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_swiglu_forward_and_vjp_match_jax(shape, dtype):
    rng = np.random.default_rng(sum(shape))
    g, u, ct = (rng.standard_normal(shape).astype(np.float32) * 2
                for _ in range(3))
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = getattr(torch, dtype)
    jg, ju, jct = (jnp.asarray(a).astype(jdt) for a in (g, u, ct))
    ref, vjp = jax.vjp(j_swiglu, jg, ju)
    ref_dg, ref_du = vjp(jct)
    tg, tu, tct = (torch.from_numpy(np.array(a, np.float32)).to(tdt)
                   for a in (jg, ju, jct))
    tg.requires_grad_(True)
    tu.requires_grad_(True)
    out = tsw.swiglu(tg, tu)
    out.backward(tct)
    assert out.dtype == tdt and tuple(out.shape) == shape
    assert tg.grad.dtype == tdt and tu.grad.dtype == tdt
    tol = TOL if dtype == "float32" else BF16_TOL
    for got, want in ((out.detach(), ref), (tg.grad, ref_dg),
                      (tu.grad, ref_du)):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32), **tol)


def test_swiglu_plain_is_f32_rounded_once():
    rng = np.random.default_rng(1)
    g, u = (torch.from_numpy(rng.standard_normal((8, 64)).astype(np.float32))
            .to(torch.bfloat16) for _ in range(2))
    want = (torch.nn.functional.silu(g.float()) * u.float()).to(torch.bfloat16)
    torch.testing.assert_close(tsw.swiglu_plain(g, u), want, atol=0, rtol=0)


def test_swiglu_on_the_cpu_launches_no_kernel():
    before = (tsw.launches, tsw.launches_bwd)
    g = torch.ones((2, 8), requires_grad=True)
    tsw.swiglu(g, torch.ones((2, 8))).sum().backward()
    assert (tsw.launches, tsw.launches_bwd) == before
