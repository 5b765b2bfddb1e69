"""The port's flash attention on its CPU route (the kernels' plain forward
and backward behind the autograd.Function) held against paddle_tpu's: the
Pallas kernels in interpret mode and the XLA composite ``_xla_sdpa``.

Inputs are made with numpy from a seed, fp32 on both sides.  Tolerance 2e-5
on the output and 2e-4 on the gradients, the bounds the JAX package's own
Pallas parity test states for fp32 (another summation order, and the
online softmax against a one-pass one).
"""

import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from paddle_tpu.flags import set_flags  # noqa: E402
from paddle_tpu_torch.ops import flash_attention as tfa  # noqa: E402

# the package re-exports a function of the module's name, so ask for the
# module itself
jfa = importlib.import_module("paddle_tpu.ops.pallas.flash_attention")

OUT_TOL = dict(atol=2e-5, rtol=2e-5)
GRAD_TOL = dict(atol=2e-4, rtol=2e-4)


@pytest.fixture(autouse=True)
def _interpret_mode():
    set_flags({"FLAGS_pallas_interpret": True})
    yield
    set_flags({"FLAGS_pallas_interpret": False})


def _qkv(shape, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(4)]


def _torch_run(q, k, v, ct, causal):
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    out = tfa.flash_attention(tq, tk, tv, causal)
    out.backward(torch.from_numpy(ct))
    return (out.detach().numpy(), tq.grad.numpy(), tk.grad.numpy(),
            tv.grad.numpy())


def _jax_run(fn, q, k, v, ct, causal):
    out, vjp = jax.vjp(lambda a, b, c: fn(a, b, c, causal), jnp.asarray(q),
                       jnp.asarray(k), jnp.asarray(v))
    return (np.asarray(out), *(np.asarray(g) for g in vjp(jnp.asarray(ct))))


# (2, 64, 2, 32) runs JAX's Pallas kernels (interpret mode); 37 is a ragged
# length no block divides: JAX takes its XLA composite there, the port's one
# route takes every length
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", [(2, 64, 2, 32), (1, 37, 3, 16)])
def test_flash_attention_and_its_gradients_match_jax(shape, causal):
    q, k, v, ct = _qkv(shape, sum(shape) + causal)
    got = _torch_run(q, k, v, ct, causal)
    for fn in (jfa.flash_attention, jfa._xla_sdpa):
        ref = _jax_run(fn, q, k, v, ct, causal)
        np.testing.assert_allclose(got[0], ref[0], **OUT_TOL)
        for a, b in zip(got[1:], ref[1:]):
            np.testing.assert_allclose(a, b, **GRAD_TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_sdpa_plain_matches_xla_sdpa_at_decode_shapes(causal):
    """q_len < kv_len: the end-aligned causal mask; the CPU route takes
    the plain composite as JAX does."""
    rng = np.random.default_rng(3)
    q = rng.standard_normal((2, 3, 2, 16)).astype(np.float32)
    k = rng.standard_normal((2, 11, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, 11, 2, 16)).astype(np.float32)
    ref = np.asarray(jfa.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                         jnp.asarray(v), causal))
    got = tfa.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), causal)
    np.testing.assert_allclose(got.numpy(), ref, **OUT_TOL)
    np.testing.assert_array_equal(
        tfa.causal_mask(3, 11).numpy(), np.asarray(jfa.causal_mask(3, 11)))


def test_causal_with_more_queries_than_keys_raises():
    q = torch.zeros(1, 5, 1, 16)
    k = torch.zeros(1, 4, 1, 16)
    with pytest.raises(ValueError, match="q_len <= kv_len"):
        jfa.causal_mask(5, 4)
    with pytest.raises(ValueError, match="q_len <= kv_len"):
        tfa.causal_mask(5, 4)
    with pytest.raises(ValueError, match="q_len <= kv_len"):
        tfa.flash_attention(q, k, k, causal=True)


def test_saved_lse_is_the_log_sum_exp_of_the_scores():
    q, k, v, _ = _qkv((1, 9, 2, 16), 11)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    out, lse = tfa._fwd_plain(tq, tk, tv, True)
    sc = np.einsum("bqhd,bkhd->bhqk", q, k) / 4.0
    sc = np.where(np.tril(np.ones((9, 9), bool)), sc, -np.inf)
    ref = np.log(np.exp(sc).sum(-1))
    np.testing.assert_allclose(lse.numpy(), ref, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(out.numpy(),
                               tfa.sdpa_plain(tq, tk, tv, True).numpy(),
                               **OUT_TOL)


def test_the_cpu_route_launches_no_kernel():
    before = (tfa.launches, tfa.launches_dq, tfa.launches_dkv)
    q, k, v, ct = _qkv((1, 8, 1, 16), 1)
    _torch_run(q, k, v, ct, True)
    assert (tfa.launches, tfa.launches_dq, tfa.launches_dkv) == before
