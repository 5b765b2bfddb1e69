"""The port's rmsnorm_matmul (CPU route: the kernel's plain version behind
the autograd.Function, whose backward is JAX's ``_bwd_vjp`` in PyTorch)
held against paddle_tpu's: the Pallas kernel in interpret mode where its
TPU tiling takes the shape, and ``_xla_ref`` where it does not.

Tolerance 2e-5 in f32, as JAX's own test (tests/test_pallas_kernels.py
:104, :116): the kernel applies the row's rstd after the product, ``_xla_ref``
before it, and the sums run in another order.  Gradients: 2e-5 of the
largest magnitude of each.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from paddle_tpu.flags import set_flags  # noqa: E402
from paddle_tpu.ops.pallas.rmsnorm_matmul import rmsnorm_matmul as j_rmsnorm_matmul  # noqa: E402
from paddle_tpu_torch.ops import rmsnorm_matmul as trm  # noqa: E402


@pytest.fixture(autouse=True)
def _interpret_mode():
    set_flags({"FLAGS_pallas_interpret": True})
    yield
    set_flags({"FLAGS_pallas_interpret": False})


def _close(got, want, rel=2e-5):
    want = np.asarray(want, np.float32)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got.detach().float().numpy(), want,
                               atol=rel * scale, rtol=0)


# (2, 16, 256) x 128: the Pallas kernel (JAX's own test shape);
# (4, 100) x 64: H and N no multiple of 128, JAX's _xla_ref;
# (5, 3, 128) x 256: M = 15 rows, no multiple of 8, _xla_ref again
@pytest.mark.parametrize("xshape,N", [((2, 16, 256), 128), ((4, 100), 64),
                                      ((5, 3, 128), 256)])
def test_rmsnorm_matmul_forward_and_vjp_match_jax(xshape, N):
    H = xshape[-1]
    rng = np.random.default_rng(H + N)
    x = rng.standard_normal(xshape).astype(np.float32)
    wl = (1.0 + 0.1 * rng.standard_normal(H)).astype(np.float32)
    w = (0.05 * rng.standard_normal((H, N))).astype(np.float32)
    ct = rng.standard_normal(xshape[:-1] + (N,)).astype(np.float32)
    ref, vjp = jax.vjp(lambda a, b, c: j_rmsnorm_matmul(a, b, c, 1e-6),
                       *(jnp.asarray(a) for a in (x, wl, w)))
    ref_grads = vjp(jnp.asarray(ct))
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (x, wl, w)]
    out = trm.rmsnorm_matmul(*leaves, 1e-6)
    out.backward(torch.from_numpy(ct))
    assert out.shape == xshape[:-1] + (N,)
    _close(out, ref)
    for leaf, want in zip(leaves, ref_grads):
        assert leaf.grad.dtype == leaf.dtype
        _close(leaf.grad, want)


def test_rmsnorm_matmul_plain_is_the_kernels_formula():
    """bf16 x: x * wl rounded to bf16, the product in f32, the row's rstd
    applied to the f32 product, one rounding; JAX's serving-path call with
    a bf16 norm weight gives the same types."""
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal((8, 64)).astype(np.float32))
    xb = x.to(torch.bfloat16)
    wl = torch.from_numpy((1 + 0.1 * rng.standard_normal(64)).astype(
        np.float32))
    w = torch.from_numpy(rng.standard_normal((64, 32)).astype(
        np.float32)).to(torch.bfloat16)
    rstd = torch.rsqrt((xb.float() ** 2).mean(-1, keepdim=True) + 1e-6)
    acc = (xb.float() * wl).to(torch.bfloat16).float() @ w.float()
    got = trm.rmsnorm_matmul_plain(xb, wl, w)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, (acc * rstd).to(torch.bfloat16))
    jref = j_rmsnorm_matmul(jnp.asarray(xb.float().numpy(), jnp.bfloat16),
                              jnp.asarray(wl.to(torch.bfloat16).float()
                                          .numpy(), jnp.bfloat16),
                              jnp.asarray(w.float().numpy(), jnp.bfloat16))
    assert jref.dtype == jnp.bfloat16


def test_rmsnorm_matmul_on_the_cpu_launches_no_kernel():
    before = trm.launches
    x = torch.ones((2, 32), requires_grad=True)
    trm.rmsnorm_matmul(x, torch.ones(32), torch.ones((32, 8))).sum().backward()
    assert trm.launches == before
