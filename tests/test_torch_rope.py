"""The port's RoPE tables and fused_rope (CPU route: the kernel's plain
version behind the autograd.Function) held against paddle_tpu's: the Pallas
kernel in interpret mode and its ``_composite``; the tables' memo
(``cached_tables``) against ``rope_tables`` and JAX's tables, and the
trainer's ``_rope``, which reads the memo, against JAX's ``_rope``.

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
from paddle_tpu.models import llama_pretrain as jlp  # noqa: E402
from paddle_tpu.ops.pallas import rope as jrope  # noqa: E402
from paddle_tpu_torch.models import llama_pretrain as tlp  # noqa: E402
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


# (S, d, theta): the trainer's and the serving bucket's lengths, odd
# lengths, head_dim 32 / 64 / 128, LLaMA-2's and LLaMA-3's theta
MEMO_KEYS = [(2048, 128, 10000.0), (256, 128, 10000.0), (7, 32, 500000.0),
             (33, 64, 10000.0), (1, 128, 1000000.0)]


@pytest.mark.parametrize("s,d,theta", MEMO_KEYS)
def test_cached_tables_are_rope_tables_and_match_jax(s, d, theta):
    cos, sin = trope.cached_tables(s, d, theta, device="cpu")
    ref_cos, ref_sin = trope.rope_tables(s, d, theta, device="cpu")
    assert torch.equal(cos, ref_cos) and torch.equal(sin, ref_sin)
    jc, js = jrope.rope_tables(s, d, theta)
    np.testing.assert_allclose(cos.numpy(), np.asarray(jc), **TOL)
    np.testing.assert_allclose(sin.numpy(), np.asarray(js), **TOL)
    builds = trope.table_builds
    again = trope.cached_tables(s, d, theta, device="cpu")
    assert again[0] is cos and again[1] is sin
    assert trope.table_builds == builds


def test_cached_tables_keep_one_entry_per_key():
    # keys that differ in one field each: S, d, theta, the device
    keys = [(9, 32, 10000.0, "cpu"), (10, 32, 10000.0, "cpu"),
            (9, 64, 10000.0, "cpu"), (9, 32, 500000.0, "cpu"),
            (9, 32, 10000.0, "meta")]
    got = [trope.cached_tables(s, d, theta, device=dev)
           for s, d, theta, dev in keys]
    assert len({id(t) for pair in got for t in pair}) == 2 * len(keys)
    for (s, d, theta, dev), (cos, sin) in zip(keys, got):
        assert cos.device.type == dev and tuple(cos.shape) == (s, d // 2)
        if dev == "cpu":
            ref_cos, ref_sin = trope.rope_tables(s, d, theta, device=dev)
            assert torch.equal(cos, ref_cos) and torch.equal(sin, ref_sin)
    # the memo is bounded: the oldest keys go first
    for s in range(100, 100 + trope.TABLES_MAX + 3):
        trope.cached_tables(s, 16, device="cpu")
    assert len(trope._tables) == trope.TABLES_MAX
    assert (100, 16, 10000.0, torch.device("cpu")) not in trope._tables
    last = (99 + trope.TABLES_MAX + 3, 16, 10000.0, torch.device("cpu"))
    assert last in trope._tables


def test_trainer_rope_matches_jax_and_reads_the_memo():
    """The port's ``_rope`` against JAX's at head_dim 128 (the fused path
    on both sides), f32, 4 q heads over 2 kv heads; called twice, so the
    second call takes its tables from the memo."""
    rng = np.random.default_rng(19)
    b, s, d, theta = 2, 24, 128, 10000.0
    q = rng.standard_normal((b, s, 4, d)).astype(np.float32)
    k = rng.standard_normal((b, s, 2, d)).astype(np.float32)
    ref_q, ref_k = jlp._rope(jnp.asarray(q), jnp.asarray(k), theta)
    for call in range(2):
        builds = trope.table_builds
        got_q, got_k = tlp._rope(torch.from_numpy(q), torch.from_numpy(k),
                                 theta)
        if call:
            assert trope.table_builds == builds
        np.testing.assert_allclose(got_q.numpy(), np.asarray(ref_q), **TOL)
        np.testing.assert_allclose(got_k.numpy(), np.asarray(ref_k), **TOL)
