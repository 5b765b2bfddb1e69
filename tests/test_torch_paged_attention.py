"""The port's paged decode attention (plain version, the CPU path of the
kernel wrapper) held against paddle_tpu's ``paged_decode_attention_xla``.

Inputs are made with numpy from a seed and given to both frameworks in
fp32; tolerance 1e-5 (the same fp32 math, summed in another order).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from paddle_tpu.ops.pallas.paged_attention import (  # noqa: E402
    paged_decode_attention_xla)
from paddle_tpu_torch.ops import paged_attention as pa  # noqa: E402

N, D, PAGE, PAGES_MAX = 4, 16, 8, 4
TOL = dict(atol=1e-5, rtol=1e-5)


def _case(nkv, lens, seed=0, junk=0.0):
    """Pools with every row's pages at distinct random ids; unused table
    slots point at page 0, whose content is ``junk``."""
    rng = np.random.default_rng(seed)
    B = len(lens)
    P = 1 + B * PAGES_MAX
    kp = rng.standard_normal((P, nkv, PAGE, D)).astype(np.float32)
    vp = rng.standard_normal((P, nkv, PAGE, D)).astype(np.float32)
    kp[0] = vp[0] = junk
    q = rng.standard_normal((B, N, D)).astype(np.float32)
    ids = rng.permutation(P - 1) + 1
    tables = np.zeros((B, PAGES_MAX), np.int32)
    at = 0
    for b, L in enumerate(lens):
        used = -(-L // PAGE)
        tables[b, :used] = ids[at:at + used]
        at += used
    return q, kp, vp, tables, np.asarray(lens, np.int32)


def _jax(q, kp, vp, tables, lens, sm_scale=None):
    return np.asarray(paged_decode_attention_xla(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(tables, jnp.int32), jnp.asarray(lens, jnp.int32),
        sm_scale))


def _port(q, kp, vp, tables, lens, sm_scale=None):
    return pa.paged_decode_attention(
        torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(vp),
        torch.from_numpy(tables), torch.from_numpy(lens), sm_scale).numpy()


@pytest.mark.parametrize("nkv", [4, 2, 1], ids=["mha", "gqa2", "mqa"])
def test_plain_matches_jax_ragged_lens(nkv):
    # 1 token, a page edge, one past it, a full table
    args = _case(nkv, [1, PAGE, PAGE + 1, PAGES_MAX * PAGE], seed=nkv)
    np.testing.assert_allclose(_port(*args), _jax(*args), **TOL)


def test_plain_matches_jax_with_sm_scale():
    args = _case(2, [3, 17, 32], seed=7)
    np.testing.assert_allclose(_port(*args, sm_scale=0.3),
                               _jax(*args, sm_scale=0.3), **TOL)


def test_junk_page_content_is_never_seen():
    lens = [5, PAGE, 2 * PAGE + 3]
    clean = _case(2, lens, seed=3, junk=0.0)
    dirty = _case(2, lens, seed=3, junk=1e4)
    np.testing.assert_array_equal(_port(*clean), _port(*dirty))


def test_cpu_tensors_take_the_plain_version_without_a_launch():
    args = _case(2, [9, 1], seed=1)
    before = pa.launches
    got = _port(*args)
    ref = pa.paged_decode_attention_plain(
        *(torch.from_numpy(a) for a in args)).numpy()
    np.testing.assert_array_equal(got, ref)
    assert pa.launches == before


def test_bf16_output_dtype_follows_q():
    q, kp, vp, tables, lens = (torch.from_numpy(a)
                               for a in _case(2, [4, 12], seed=2))
    out = pa.paged_decode_attention(q.bfloat16(), kp.bfloat16(),
                                    vp.bfloat16(), tables, lens)
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
