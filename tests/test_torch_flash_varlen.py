"""The port's segmented attention (plain version) and block ranges held
against paddle_tpu's ``xla_segmented_sdpa`` and ``_segment_block_ranges``.

Inputs are made with numpy from a seed and given to both frameworks in
fp32; tolerance 1e-5 for the attention, exact equality for the ranges.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from paddle_tpu.ops.pallas.flash_varlen import (  # noqa: E402
    _segment_block_ranges as jax_ranges, xla_segmented_sdpa)
from paddle_tpu_torch.ops import flash_varlen as fv  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)


def _seg(lengths, total, batch=1):
    """Contiguous runs of ids 0.. for ``lengths``, then a sentinel id
    (len(lengths)) up to ``total``, as the serving engine packs."""
    seg = np.full((batch, total), len(lengths), np.int32)
    at = 0
    for i, L in enumerate(lengths):
        seg[:, at:at + L] = i
        at += L
    return seg


SEGS = [
    ([5, 1, 10], 16),              # a length-1 segment + sentinel tail
    ([16], 16),                    # one segment, no padding
    ([3, 3, 3, 3, 3], 32),         # many short runs + a long sentinel
    ([1] * 8, 8),                  # all length 1
    ([20, 7, 1, 2], 40),
]


@pytest.mark.parametrize("lengths,total", SEGS)
@pytest.mark.parametrize("block", [4, 8])
def test_segment_block_ranges_equal_jax(lengths, total, block):
    seg = _seg(lengths, total, batch=2)
    seg[1] = seg[1][::-1]          # a second row with other boundaries
    lo_j, hi_j = jax_ranges(jnp.asarray(seg, jnp.int32), block)
    lo_p, hi_p = fv._segment_block_ranges(torch.from_numpy(seg), block)
    np.testing.assert_array_equal(lo_p.numpy(), np.asarray(lo_j))
    np.testing.assert_array_equal(hi_p.numpy(), np.asarray(hi_j))
    assert lo_p.dtype == torch.int32 and hi_p.dtype == torch.int32


@pytest.mark.parametrize("nkv", [4, 2], ids=["mha", "gqa"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("lengths,total", [([5, 1, 10], 24),
                                           ([7, 9], 16)])
def test_plain_matches_jax(nkv, causal, lengths, total):
    rng = np.random.default_rng(total + nkv)
    n, d = 4, 16
    q = rng.standard_normal((1, total, n, d)).astype(np.float32)
    k = rng.standard_normal((1, total, nkv, d)).astype(np.float32)
    v = rng.standard_normal((1, total, nkv, d)).astype(np.float32)
    seg = _seg(lengths, total)
    ref = np.asarray(xla_segmented_sdpa(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(seg, jnp.int32), causal))
    before = fv.launches
    got = fv.flash_attention_segmented(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(seg), causal=causal).numpy()
    np.testing.assert_allclose(got, ref, **TOL)
    assert fv.launches == before       # CPU tensors: no kernel launch


def test_one_dimensional_segment_ids():
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.standard_normal((1, 12, 2, 8)).astype(np.float32))
    seg = torch.from_numpy(_seg([4, 8], 12))
    a = fv.flash_attention_segmented(q, q, q, seg, causal=True)
    b = fv.flash_attention_segmented(q, q, q, seg[0], causal=True)
    np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_heads_must_divide():
    q = torch.zeros((1, 8, 4, 8))
    k = torch.zeros((1, 8, 3, 8))
    with pytest.raises(ValueError, match="multiple"):
        fv.flash_attention_segmented(q, k, k, torch.zeros((1, 8)))


@pytest.mark.parametrize("lengths,total", [([70, 1, 40], 130),
                                           ([64, 64], 128),
                                           ([200], 201)])
def test_tile_ranges_cover_every_visible_key(lengths, total):
    """The kernel's per-tile ranges over a stream no tile height divides:
    every key a row of the tile may see lies in [lo, min(hi, tile end)],
    and the range holds no tile that is wholly invisible to the tile."""
    seg = _seg(lengths, total)
    kmin, kmax = fv._tile_ranges(torch.from_numpy(seg))
    bq = fv.BLOCK_ROWS
    assert kmin.shape == (1, -(-total // bq))
    s = seg[0]
    for t in range(kmin.shape[1]):
        rows = np.arange(t * bq, min((t + 1) * bq, total))
        lo = int(kmin[0, t])
        hi = min(int(kmax[0, t]), (t + 1) * bq - 1, total - 1)
        seen = [j for r in rows for j in range(r + 1) if s[j] == s[r]]
        assert lo <= min(seen) and max(seen) <= hi
        for kt in range(lo // bq, hi // bq + 1):
            keys = range(kt * bq, min((kt + 1) * bq, total))
            assert any(s[j] == s[r] and j <= r for r in rows for j in keys)
