"""The port's segmented attention held against paddle_tpu's on the CPU:
the plain forward against ``xla_segmented_sdpa``; the plain backward passes
(dq; dk and dv at the kv heads) and autograd through
``flash_attention_segmented`` against ``jax.vjp`` of the JAX
``flash_attention_segmented`` (its Pallas kernels in interpret mode) and of
``xla_segmented_sdpa``; ``_segment_block_ranges`` and
``segment_ids_from_cu_seqlens`` against their JAX originals.

Inputs are made with numpy from a seed and given to both frameworks in
fp32.  Tolerances: 1e-5 for the forward; 1e-4 abs + 1e-4 rel for the
gradients against the Pallas kernels (fp32 sums in another order over up to
128 keys), 5e-4 abs against ``xla_segmented_sdpa`` (the bound the JAX tests
hold their own kernels to); exact equality for ids and ranges.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from paddle_tpu.ops.pallas import flash_varlen as jfv  # noqa: E402
from paddle_tpu.ops.pallas.flash_varlen import (  # noqa: E402
    _segment_block_ranges as jax_ranges, xla_segmented_sdpa)
from paddle_tpu_torch.ops import flash_attention as fa  # noqa: E402
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


TILE_ROWS = [64, fv.BLOCK_ROWS]     # any height; the kernels' blocks


@pytest.mark.parametrize("rows", TILE_ROWS)
@pytest.mark.parametrize("lengths,total", [([70, 1, 40], 130),
                                           ([64, 64], 128),
                                           ([200], 201)])
def test_tile_ranges_cover_every_visible_key(lengths, total, rows):
    """The kernels' per-tile ranges over a stream no tile height divides:
    every key a row of the tile may see lies in [lo, min(hi, tile end)],
    and the range holds no tile that is wholly invisible to the tile."""
    seg = _seg(lengths, total)
    kmin, kmax = fv._tile_ranges(torch.from_numpy(seg), rows)
    bq = rows
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


@pytest.mark.parametrize("lengths,total", [([40, 24, 8, 56], 128),
                                           ([100, 28], 128),
                                           ([8] * 16, 128),
                                           ([1, 1, 5], 7)])
def test_segment_ids_from_cu_seqlens_match_jax(lengths, total):
    cu = np.cumsum([0] + lengths).astype(np.int32)
    ref = np.asarray(jfv.segment_ids_from_cu_seqlens(jnp.asarray(cu), total))
    got = fv.segment_ids_from_cu_seqlens(torch.from_numpy(cu), total)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)


def _packed_rows(lengths, total=128):
    """Two rows of ids: ``lengths`` (a JAX test layout), and a second
    layout of other boundaries ending in a -1 pad run."""
    seg = np.full((2, total), -1, np.int32)
    for row, lens in enumerate((lengths, [30, 50, 1, 12])):
        cu = np.cumsum([0] + lens)
        for i in range(len(lens)):
            seg[row, cu[i]:cu[i + 1]] = i
    return seg


def _bwd_case(seed, nkv, seg, n=4, d=16):
    rng = np.random.default_rng(seed)
    b, s = seg.shape
    return [rng.standard_normal(shape).astype(np.float32) for shape in
            ((b, s, n, d), (b, s, nkv, d), (b, s, nkv, d), (b, s, n, d))]


def _jax_vjp(fn, q, k, v, do):
    out, vjp = jax.vjp(fn, *(jnp.asarray(x) for x in (q, k, v)))
    return [np.asarray(x) for x in (out, *vjp(jnp.asarray(do)))]


def _port_autograd(q, k, v, do, seg, causal):
    leaves = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    out = fv.flash_attention_segmented(*leaves, torch.from_numpy(seg),
                                       causal=causal)
    grads = torch.autograd.grad(out, leaves, torch.from_numpy(do))
    return [x.detach().numpy() for x in (out, *grads)]


GRAD_TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("lengths,causal,nkv", [
    ([40, 24, 8, 56], True, 1), ([40, 24, 8, 56], False, 2),
    ([100, 28], True, 2), ([100, 28], False, 1),
    ([8] * 16, True, 1), ([8] * 16, False, 2)])
def test_plain_backward_matches_jax_kernels(lengths, causal, nkv):
    """dq (K7a's plain version), dk / dv (K7b's, at the kv heads) and
    autograd through flash_attention_segmented on the CPU against the
    Pallas kernels' vjp, 4 q heads over ``nkv`` kv heads, two rows of
    different layouts (the second ending in a -1 pad run)."""
    seg = _packed_rows(lengths)
    q, k, v, do = _bwd_case(len(lengths) + nkv, nkv, seg)
    ref = _jax_vjp(lambda *a: jfv.flash_attention_segmented(
        *a, jnp.asarray(seg), causal=causal), q, k, v, do)

    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    tseg = torch.from_numpy(seg)
    out = fv.segmented_sdpa_plain(tq, tk, tv, tseg, causal)
    scores, vis = fv._seg_scores(tq, tk, tseg, causal)
    lse = torch.logsumexp(scores.masked_fill(~vis, -1e30), dim=-1)
    delta = fa._delta(tdo, out)
    dq = fv._seg_bwd_dq_plain(tq, tk, tv, tseg, tdo, lse, delta, causal)
    dk, dv = fv._seg_bwd_dkv_plain(tq, tk, tv, tseg, tdo, lse, delta, causal)
    assert dk.shape == tk.shape and dv.shape == tv.shape
    for name, got, want in zip(("out", "dq", "dk", "dv"),
                               (out, dq, dk, dv), ref):
        np.testing.assert_allclose(got.numpy(), want, **GRAD_TOL,
                                   err_msg=f"plain {name}")
    counts = lambda: (fv.launches, fv.launches_bwd_dq,  # noqa: E731
                      fv.launches_bwd_dkv, fv.launches_ranges)
    before = counts()
    for name, got, want in zip(("out", "dq", "dk", "dv"),
                               _port_autograd(q, k, v, do, seg, causal), ref):
        np.testing.assert_allclose(got, want, **GRAD_TOL,
                                   err_msg=f"autograd {name}")
    # CPU tensors: no kernel launch, the range kernel's included
    assert counts() == before


@pytest.mark.parametrize("nkv", [1, 2])
@pytest.mark.parametrize("causal", [True, False])
def test_backward_matches_xla_segmented_sdpa(causal, nkv):
    seg = _packed_rows([40, 24, 8, 56])
    q, k, v, do = _bwd_case(7 + nkv, nkv, seg)
    ref = _jax_vjp(lambda *a: xla_segmented_sdpa(
        *a, jnp.asarray(seg), causal), q, k, v, do)
    for name, got, want in zip(("out", "dq", "dk", "dv"),
                               _port_autograd(q, k, v, do, seg, causal), ref):
        np.testing.assert_allclose(got, want, atol=5e-4, err_msg=name)


@pytest.mark.parametrize("rows", TILE_ROWS)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("lengths,total", [([70, 1, 40], 130),
                                           ([64, 64], 128),
                                           ([3] * 50, 150)])
def test_tile_ranges_cover_every_query_of_a_key_tile(lengths, total, causal,
                                                     rows):
    """The dk / dv kernel's q range of each k tile, from the same ranges:
    [max(lo, tile start if causal), min(hi, T - 1)] holds every q row that
    sees a key of the tile, and no q tile wholly blind to it."""
    seg = _seg(lengths, total)
    qmin, qmax = fv._tile_ranges(torch.from_numpy(seg), rows)
    bk = rows
    s = seg[0]
    for t in range(qmin.shape[1]):
        keys = np.arange(t * bk, min((t + 1) * bk, total))
        lo = int(qmin[0, t])
        if causal:
            lo = max(lo, t * bk)
        hi = min(int(qmax[0, t]), total - 1)
        seen = [r for j in keys for r in range(total)
                if s[r] == s[j] and (not causal or j <= r)]
        assert lo <= min(seen) and max(seen) <= hi
        for qt in range(lo // bk, hi // bk + 1):
            rows = range(qt * bk, min((qt + 1) * bk, total))
            assert any(s[r] == s[j] and (not causal or j <= r)
                       for r in rows for j in keys)


@pytest.mark.parametrize("rows", TILE_ROWS)
@pytest.mark.parametrize("lengths,total", [([70, 1, 40], 130),
                                           ([5, 1, 10], 16),
                                           ([300, 2, 1, 400], 1000),
                                           ([128, 128], 256)])
def test_tile_ranges_equal_jax_on_the_padded_stream(lengths, total, rows):
    """``_tile_ranges(seg, rows)`` is JAX's ``_segment_block_ranges`` at
    ``rows`` over the stream padded to whole tiles with an id of its own,
    the padding JAX's wrapper leaves to its dense fallback."""
    seg = _seg(lengths, total, batch=2)
    seg[1] = seg[1][::-1]
    pad = -total % rows
    padded = np.concatenate([seg, np.repeat(seg[:, -1:] + 1, pad, axis=1)],
                            axis=1)
    lo_j, hi_j = jax_ranges(jnp.asarray(padded, jnp.int32), rows)
    lo_p, hi_p = fv._tile_ranges(torch.from_numpy(seg), rows)
    np.testing.assert_array_equal(lo_p.numpy(), np.asarray(lo_j))
    np.testing.assert_array_equal(hi_p.numpy(), np.asarray(hi_j))


def _random_rows(seed, batch=2):
    """Packed rows of random layouts: documents of 1 to 400 tokens (some
    of one token; the first row opens with one of 400, which spans four
    128-row blocks), an optional -1 pad tail, a length no block divides."""
    rng = np.random.default_rng(seed)
    total = int(rng.integers(500, 900))
    seg = np.full((batch, total), -1, np.int32)
    for row in range(batch):
        at, i = (400, 1) if row == 0 else (0, 0)
        seg[row, :at] = 0
        end = total - int(rng.integers(0, 100)) * int(rng.integers(0, 2))
        while at < end:
            L = int(rng.choice([1, rng.integers(2, 64), rng.integers(64, 400)]))
            seg[row, at:min(at + L, end)] = i
            at, i = at + L, i + 1
    return seg


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("dkv", [False, True], ids=["dq", "dkv"])
def test_backward_tile_walk_covers_the_visible_pairs(seed, causal, d, dkv):
    """The mirror of the backward kernels' walk: every visible pair lies in
    a tile the pass visits, and every tile it leaves unmasked is visible
    throughout (so the kernels' mask-free exp loop sees no pair of another
    segment, of the wrong side of the diagonal or past the stream)."""
    seg = _random_rows(seed)
    s = seg.shape[1]
    vis = fv._seg_vis(torch.from_numpy(seg), causal)[:, 0].numpy()
    covered = np.zeros_like(vis)
    tiles = fv._bwd_tile_walk(torch.from_numpy(seg), causal, d, dkv)
    free = 0
    for r, q0, q1, k0, k1, masked in tiles:
        assert q1 - q0 == 64 and k1 - k0 == (64 if dkv or d == 128 else 128)
        covered[r, q0:q1, k0:k1] = True
        if not masked:
            free += 1
            assert q1 <= s and k1 <= s
            assert vis[r, q0:q1, k0:k1].all(), (r, q0, k0)
    assert not (vis & ~covered).any()
    assert len(set(tiles)) == len(tiles)       # no tile visited twice
    assert 0 < free < len(tiles)
