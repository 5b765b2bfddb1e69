"""The paged decode kernel's split-KV arithmetic, on the CPU.

``split_plan`` (how the kernel spreads a row's pages over blocks) and
``paged_decode_attention_split_plain`` (its two passes: per-split softmax
partials, then their log-sum-exp merge) in ``paddle_tpu_torch``, held
against paddle_tpu's ``paged_decode_attention_xla`` and, over int8 pages,
``paged_decode_attention_q8_xla``.  Inputs are made with numpy from a seed
and given to both frameworks in fp32; tolerance 1e-5 (the same fp32 math,
summed in another order).
"""

import inspect

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from paddle_tpu.ops.pallas.paged_attention import (  # noqa: E402
    paged_decode_attention_q8_xla, paged_decode_attention_xla,
    quantize_kv_token)
from paddle_tpu_torch.ops import paged_attention as pa  # noqa: E402

N, D, PAGE, PAGES_MAX = 4, 16, 8, 6
TOL = dict(atol=1e-5, rtol=1e-5)
# one token (every later split empty), a page edge, one past it, a split
# edge at two pages, the whole table
LENS = [1, PAGE, PAGE + 1, 2 * PAGE, 2 * PAGE + 1, PAGES_MAX * PAGE]
SPLITS = [1, 2, PAGES_MAX]
GROUPS = {"g1": 4, "g2": 2, "g4": 1}          # id -> nkv at N = 4


def _case(nkv, lens, seed):
    rng = np.random.default_rng(seed)
    B = len(lens)
    P = 1 + B * PAGES_MAX
    kp = rng.standard_normal((P, nkv, PAGE, D)).astype(np.float32)
    vp = rng.standard_normal((P, nkv, PAGE, D)).astype(np.float32)
    q = rng.standard_normal((B, N, D)).astype(np.float32)
    ids = rng.permutation(P - 1) + 1
    tables = np.zeros((B, PAGES_MAX), np.int32)
    at = 0
    for b, L in enumerate(lens):
        used = -(-L // PAGE)
        tables[b, :used] = ids[at:at + used]
        at += used
    return q, kp, vp, tables, np.asarray(lens, np.int32)


def _quantized(kp, vp):
    kp = kp.copy()
    kp[1, 0, 2] = 0.0                 # an all-zero slot gets scale 1
    out = []
    for p in (kp, vp):
        codes, scale = quantize_kv_token(jnp.asarray(p))
        out += [np.asarray(codes), np.asarray(scale)]
    return out                        # kq, ks, vq, vs


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


@pytest.mark.parametrize("split_pages", SPLITS)
@pytest.mark.parametrize("group", list(GROUPS))
def test_split_mirror_matches_jax(group, split_pages):
    q, kp, vp, tables, lens = _case(GROUPS[group], LENS, seed=split_pages)
    ref = np.asarray(paged_decode_attention_xla(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(tables), jnp.asarray(lens), 0.3))
    got = pa.paged_decode_attention_split_plain(
        *_t(q, kp, vp, tables, lens), 0.3, split_pages=split_pages)
    np.testing.assert_allclose(got.numpy(), ref, **TOL)


@pytest.mark.parametrize("split_pages", SPLITS)
@pytest.mark.parametrize("group", list(GROUPS))
def test_split_mirror_q8_matches_jax(group, split_pages):
    q, kp, vp, tables, lens = _case(GROUPS[group], LENS, seed=10 + split_pages)
    kq, ks, vq, vs = _quantized(kp, vp)
    ref = np.asarray(paged_decode_attention_q8_xla(
        jnp.asarray(q), jnp.asarray(kq), jnp.asarray(vq), jnp.asarray(ks),
        jnp.asarray(vs), jnp.asarray(tables), jnp.asarray(lens)))
    qt, kqt, vqt, kst, vst, tt, lt = _t(q, kq, vq, ks, vs, tables, lens)
    got = pa.paged_decode_attention_split_plain(
        qt, kqt, vqt, tt, lt, split_pages=split_pages, kscale=kst,
        vscale=vst)
    np.testing.assert_allclose(got.numpy(), ref, **TOL)


@pytest.mark.parametrize("q8", [False, True], ids=["bf16", "int8"])
def test_split_mirror_empty_row_writes_zeros_and_junk_is_never_seen(q8):
    lens = [0, 3, 2 * PAGE + 5]
    q, kp, vp, tables, lens_a = _case(2, lens, seed=5)
    dirty_k, dirty_v = kp.copy(), vp.copy()
    dirty_k[0] = dirty_v[0] = 1e4        # the junk page unused slots name
    outs = []
    for k, v in ((kp, vp), (dirty_k, dirty_v)):
        if q8:
            kq, ks, vq, vs = _quantized(k, v)
            qt, kqt, vqt, kst, vst, tt, lt = _t(q, kq, vq, ks, vs, tables,
                                                lens_a)
            outs.append(pa.paged_decode_attention_split_plain(
                qt, kqt, vqt, tt, lt, split_pages=2, kscale=kst,
                vscale=vst))
        else:
            outs.append(pa.paged_decode_attention_split_plain(
                *_t(q, k, v, tables, lens_a), split_pages=2))
    assert (outs[0][0] == 0).all()
    np.testing.assert_array_equal(outs[0].numpy(), outs[1].numpy())


def test_split_mirror_equals_the_plain_version_at_every_split():
    q, kp, vp, tables, lens = _t(*_case(2, LENS, seed=3))
    ref = pa.paged_decode_attention_plain(q, kp, vp, tables, lens)
    for split_pages in range(1, PAGES_MAX + 1):
        got = pa.paged_decode_attention_split_plain(
            q, kp, vp, tables, lens, split_pages=split_pages)
        torch.testing.assert_close(got, ref, **TOL)


SHAPES = [(B, nkv, g, pm, page) for B in (1, 3, 8, 64) for nkv in (1, 8, 32)
          for g in (1, 4) for pm in (1, 2, 17, 32, 128, 1000)
          for page in (8, 16, 64, 256)]


@pytest.mark.parametrize("sm_count", [1, 132])
def test_split_plan_covers_the_table_in_whole_splits(sm_count):
    for B, nkv, g, pm, page in SHAPES:
        S, ps = pa.split_plan(B, nkv, g, pm, page, sm_count)
        assert ps >= 1 and S >= 1, (B, nkv, g, pm, page)
        assert S * ps >= pm > (S - 1) * ps, (B, nkv, g, pm, page, S, ps)
        # at most 256 tokens a split (128 at g > 1), unless a page alone
        # is longer
        tokens = 256 if g == 1 else 128
        assert ps * page <= max(tokens, page)
        # a grid of fewer than two blocks an SM splits down to one page
        assert B * nkv * S >= 2 * sm_count or ps == 1 or S * ps == pm == 1


def test_split_plan_reads_shapes_only():
    # no length among its arguments: the wrapper can plan without reading
    # the card, and a captured call replays with other lengths
    assert list(inspect.signature(pa.split_plan).parameters) == [
        "B", "nkv", "g", "pages_max", "page", "sm_count"]
    # chip_smoke's table at nkv 32 and 8
    assert pa.split_plan(8, 32, 1, 32, 64, 132) == (8, 4)
    assert pa.split_plan(8, 8, 4, 32, 64, 132) == (16, 2)
    assert pa.split_plan(8, 32, 1, 17, 64, 132) == (5, 4)  # decode profile
    # one split covers a short table of a full grid: no combine pass
    assert pa.split_plan(64, 32, 1, 4, 64, 132) == (1, 4)
    # a small grid splits finer
    assert pa.split_plan(1, 32, 1, 32, 64, 132) == (16, 2)


def test_split_mirror_at_the_plan_of_each_shape_matches_jax():
    # the split the kernel would take, at shapes whose plan differs
    plans = []
    for B, nkv, sm_count in ((2, 4, 1), (2, 2, 4), (2, 1, 64)):
        S, ps = pa.split_plan(B, nkv, N // nkv, PAGES_MAX, PAGE, sm_count)
        plans.append((S, ps))
        lens = [1, PAGES_MAX * PAGE][:B]
        q, kp, vp, tables, lens_a = _case(nkv, lens, seed=S)
        ref = np.asarray(paged_decode_attention_xla(
            jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
            jnp.asarray(tables), jnp.asarray(lens_a)))
        got = pa.paged_decode_attention_split_plain(
            *_t(q, kp, vp, tables, lens_a), split_pages=ps)
        np.testing.assert_allclose(got.numpy(), ref, **TOL)
    assert plans == [(1, PAGES_MAX), (2, 3), (PAGES_MAX, 1)]
