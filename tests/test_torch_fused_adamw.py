"""The port's fused AdamW (CPU route: the kernel's plain version, in place)
held against paddle_tpu's Pallas kernel in interpret mode and against the
composite branch of ``adamw_update``.

Inputs are made with numpy from a seed, fp32 on both sides; tolerance 1e-6
(the f32 power ``b ** t`` differs by an ulp between XLA and torch).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from paddle_tpu.flags import set_flags  # noqa: E402
from paddle_tpu.models import llama_pretrain as jlp  # noqa: E402
from paddle_tpu.ops.pallas.fused_adamw import fused_adamw as j_fused  # noqa: E402
from paddle_tpu_torch.ops import fused_adamw as tfa  # noqa: E402

TOL = dict(atol=1e-6, rtol=1e-6)
HYPER = dict(lr=3e-3, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1)


@pytest.fixture(autouse=True)
def _interpret_mode():
    set_flags({"FLAGS_pallas_interpret": True})
    yield
    set_flags({"FLAGS_pallas_interpret": False})


def _case(shape, seed):
    rng = np.random.default_rng(seed)
    p = rng.standard_normal(shape).astype(np.float32)
    g = rng.standard_normal(shape).astype(np.float32)
    m = (0.1 * rng.standard_normal(shape)).astype(np.float32)
    v = (0.01 * rng.random(shape)).astype(np.float32)
    return p, g, m, v


@pytest.mark.parametrize("t", [1, 100])
@pytest.mark.parametrize("shape", [(8, 256), (2048,), (3, 43), (1,), (129,)])
def test_fused_adamw_matches_the_pallas_kernel(shape, t):
    p, g, m, v = _case(shape, t + len(shape))
    ref_p, ref_mo = j_fused(jnp.asarray(p), jnp.asarray(g), jnp.asarray(m),
                            jnp.asarray(v), jnp.float32(t), **HYPER)
    tp, tg, tm, tv = (torch.from_numpy(a.copy()) for a in (p, g, m, v))
    before = tfa.launches
    out_p, out_mo = tfa.fused_adamw(tp, tg, tm, tv, t, **HYPER)
    assert tfa.launches == before            # the CPU route runs no kernel
    # in place: the returned tensors are the ones handed in
    assert out_p is tp and out_mo["m"] is tm and out_mo["v"] is tv
    np.testing.assert_allclose(tp.numpy(), np.asarray(ref_p), **TOL)
    np.testing.assert_allclose(tm.numpy(), np.asarray(ref_mo["m"]), **TOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(ref_mo["v"]), **TOL)


@pytest.mark.parametrize("t", [1, 100])
def test_fused_adamw_plain_matches_adamw_updates_composite(t):
    """bf16 moments send JAX's ``adamw_update`` down its composite branch;
    with moments that bf16 holds exactly its f32 math is the plain
    version's."""
    p, g, _, _ = _case((5, 24), 7)
    m = np.zeros_like(p)
    v = np.zeros_like(p)
    tree = lambda a: {"w": jnp.asarray(a)}  # noqa: E731
    state = {"t": jnp.asarray(t - 1, jnp.int32),
             "moments": {"w": {"m": jnp.asarray(m, jnp.bfloat16),
                               "v": jnp.asarray(v, jnp.bfloat16)}}}
    ref_p, _ = jlp.adamw_update(tree(p), tree(g), state, lr=HYPER["lr"],
                                weight_decay=HYPER["weight_decay"])
    new_p, new_m, new_v = tfa.fused_adamw_plain(
        *(torch.from_numpy(a) for a in (p, g, m, v)), t, **HYPER)
    np.testing.assert_allclose(new_p.numpy(), np.asarray(ref_p["w"]), **TOL)
    np.testing.assert_allclose(new_m.numpy(), 0.1 * g, **TOL)
    np.testing.assert_allclose(new_v.numpy(), 0.05 * g * g, rtol=1e-5)


def test_bf16_gradients_are_widened_first():
    p, g, m, v = _case((4, 32), 3)
    g16 = torch.from_numpy(g).to(torch.bfloat16)
    a = tfa.fused_adamw_plain(torch.from_numpy(p), g16, torch.from_numpy(m),
                              torch.from_numpy(v), 3, **HYPER)
    b = tfa.fused_adamw_plain(torch.from_numpy(p), g16.float(),
                              torch.from_numpy(m), torch.from_numpy(v), 3,
                              **HYPER)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
