"""The port's chunked softmax cross-entropy held against paddle_tpu's:
value, dx and dW, for 1, 2 and 4 chunks.

Inputs are made with numpy from a seed, fp32 on both sides; tolerance 1e-5
(another summation order in the matrix products and the log-sum-exp).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from paddle_tpu.ops.chunked_loss import (  # noqa: E402
    chunked_softmax_cross_entropy as j_ce)
from paddle_tpu_torch.ops.chunked_loss import (  # noqa: E402
    chunked_softmax_cross_entropy as t_ce)

TOL = dict(atol=1e-5, rtol=1e-5)
B, S, H, V = 2, 6, 32, 50


def _case(seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, H)).astype(np.float32)
    w = (rng.standard_normal((H, V)) * H ** -0.5).astype(np.float32)
    t = rng.integers(0, V, (B, S))
    return x, w, t


@pytest.mark.parametrize("chunks", [1, 2, 4])
def test_value_and_gradients_match_jax(chunks):
    x, w, t = _case(chunks)
    ref, (ref_dx, ref_dw) = jax.value_and_grad(
        lambda a, b: j_ce(a, b, jnp.asarray(t), chunks, jnp.float32),
        argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    tx = torch.from_numpy(x).requires_grad_(True)
    tw = torch.from_numpy(w).requires_grad_(True)
    loss = t_ce(tx, tw, torch.from_numpy(t), chunks, torch.float32)
    (3.0 * loss).backward()              # a cotangent other than 1
    np.testing.assert_allclose(float(loss.detach()), float(ref), **TOL)
    np.testing.assert_allclose(tx.grad.numpy(), 3.0 * np.asarray(ref_dx),
                               **TOL)
    np.testing.assert_allclose(tw.grad.numpy(), 3.0 * np.asarray(ref_dw),
                               **TOL)


def test_value_matches_the_plain_log_softmax_head():
    x, w, t = _case(9)
    tx, tw, tt = torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(t)
    logp = torch.log_softmax(tx @ tw, -1)
    ref = -logp.gather(-1, tt[..., None]).mean()
    np.testing.assert_allclose(float(t_ce(tx, tw, tt, 3, torch.float32)),
                               float(ref), **TOL)


def test_bf16_compute_keeps_f32_logits():
    """Operands rounded to bf16, sums and logits in f32, as JAX's
    ``preferred_element_type=float32`` product."""
    x, w, t = _case(4)
    ref = j_ce(jnp.asarray(x), jnp.asarray(w), jnp.asarray(t), 2,
               jnp.bfloat16)
    got = t_ce(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(t),
               2, torch.bfloat16)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(ref), atol=1e-4, rtol=1e-4)


def test_a_token_count_the_chunks_do_not_divide_raises():
    x, w, t = _case(0)
    with pytest.raises(ValueError, match="not divisible"):
        t_ce(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(t), 5,
             torch.float32)
    with pytest.raises(ValueError, match="not divisible"):
        j_ce(jnp.asarray(x), jnp.asarray(w), jnp.asarray(t), 5, jnp.float32)
