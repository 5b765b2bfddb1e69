"""The port's CUDA kernels against their plain versions on a CUDA card, at
shapes ``chip_smoke.py`` does not reach: other page sizes and head dims, the
largest GQA group the paged kernels hold, empty rows, int8 pages with a
slot quantized from an all-zero token, ragged and batched packed streams,
non-causal attention, the int8 matmul at ragged M, N and K, and the
wrappers' refusals.

Every test needs a card and skips without one.  The card machine has no JAX,
so run this file there without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_kernels_cuda.py -q

Tolerance 2e-2 abs / 2e-2 rel against the plain version computed in fp32
from the same bf16 inputs: one bf16 rounding of the output plus another
summation order.
"""

import math

import pytest

torch = pytest.importorskip("torch")

from paddle_tpu_torch.ops import flash_varlen as fv  # noqa: E402
from paddle_tpu_torch.ops import int8_matmul as im  # noqa: E402
from paddle_tpu_torch.ops import paged_attention as pa  # noqa: E402

pytestmark = pytest.mark.cuda
TOL = dict(atol=2e-2, rtol=2e-2)


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _randn(gen, *shape):
    return torch.randn(shape, generator=gen, device="cuda",
                       dtype=torch.bfloat16)


def _paged_case(gen, n, nkv, d, page, lens, pages_max):
    B = len(lens)
    used = [-(-L // page) for L in lens]
    P = 1 + sum(used) + 3
    kp, vp = _randn(gen, P, nkv, page, d), _randn(gen, P, nkv, page, d)
    q = _randn(gen, B, n, d)
    perm = torch.randperm(P - 1, generator=gen, device="cuda") + 1
    tables = torch.zeros((B, pages_max), dtype=torch.int32, device="cuda")
    at = 0
    for b, u in enumerate(used):
        tables[b, :u] = perm[at:at + u]
        at += u
    lens_t = torch.tensor(lens, dtype=torch.int32, device="cuda")
    return q, kp, vp, tables, lens_t


PAGED_CASES = [
    (32, 2, 64, 16, [0, 1, 15, 16, 17, 100], 8),     # group of 16, empty row
    (8, 8, 128, 32, [33, 64, 1], 3),
    (16, 4, 256, 8, [9, 40], 5),                     # the widest head_dim
]


@pytest.mark.parametrize("n,nkv,d,page,lens,pages_max", PAGED_CASES)
def test_paged_decode_kernel_matches_plain(gen, n, nkv, d, page, lens,
                                           pages_max):
    q, kp, vp, tables, lens_t = _paged_case(gen, n, nkv, d, page, lens,
                                            pages_max)
    before = pa.launches
    out = pa.paged_decode_attention(q, kp, vp, tables, lens_t)
    torch.cuda.synchronize()
    assert pa.launches == before + 1
    assert out.dtype == torch.bfloat16 and torch.isfinite(out.float()).all()
    ref = pa.paged_decode_attention_plain(q.float(), kp.float(), vp.float(),
                                          tables, lens_t)
    for b, L in enumerate(lens):
        if L == 0:
            assert (out[b] == 0).all()          # an empty row writes zeros
        else:
            torch.testing.assert_close(out[b].float(), ref[b], **TOL)


def test_paged_decode_kernel_refuses_what_it_cannot_take(gen):
    q, kp, vp, tables, lens = _paged_case(gen, 32, 1, 64, 16, [5], 2)
    with pytest.raises(ValueError, match="n / nkv"):
        pa.paged_decode_attention(q, kp, vp, tables, lens)   # group of 32
    q, kp, vp, tables, lens = _paged_case(gen, 4, 2, 64, 16, [5], 2)
    with pytest.raises(TypeError):
        pa.paged_decode_attention(q.float(), kp, vp, tables, lens)
    with pytest.raises(TypeError):
        pa.paged_decode_attention(q, kp, vp, tables.long(), lens)
    with pytest.raises(ValueError, match="contiguous"):
        pa.paged_decode_attention(q.transpose(1, 2).contiguous()
                                  .transpose(1, 2), kp, vp, tables, lens)


@pytest.mark.parametrize("n,nkv,d,page,lens,pages_max", PAGED_CASES)
def test_paged_decode_q8_kernel_matches_plain(gen, n, nkv, d, page, lens,
                                              pages_max):
    q, kp, vp, tables, lens_t = _paged_case(gen, n, nkv, d, page, lens,
                                            pages_max)
    kp[int(tables[1, 0]), 0, 0] = 0      # a slot from an all-zero token
    kq, ks = pa.quantize_kv_token(kp)
    vq, vs = pa.quantize_kv_token(vp)
    assert float(ks[int(tables[1, 0]), 0, 0]) == 1.0
    before = pa.launches_q8
    out = pa.paged_decode_attention_q8(q, kq, vq, ks, vs, tables, lens_t)
    torch.cuda.synchronize()
    assert pa.launches_q8 == before + 1
    assert out.dtype == torch.bfloat16 and torch.isfinite(out.float()).all()
    ref = pa.paged_decode_attention_q8_plain(q.float(), kq, vq, ks, vs,
                                             tables, lens_t)
    for b, L in enumerate(lens):
        if L == 0:
            assert (out[b] == 0).all()          # an empty row writes zeros
        else:
            torch.testing.assert_close(out[b].float(), ref[b], **TOL)


def test_paged_decode_q8_kernel_refuses_what_it_cannot_take(gen):
    q, kp, vp, tables, lens = _paged_case(gen, 4, 2, 72, 16, [5], 2)
    kq, ks = pa.quantize_kv_token(kp)
    with pytest.raises(ValueError, match="d % 16"):      # 72 % 16 != 0
        pa.paged_decode_attention_q8(q, kq, kq, ks, ks, tables, lens)
    q, kp, vp, tables, lens = _paged_case(gen, 4, 2, 64, 16, [5], 2)
    kq, ks = pa.quantize_kv_token(kp)
    with pytest.raises(TypeError):                       # bf16 pages
        pa.paged_decode_attention_q8(q, kp, vp, ks, ks, tables, lens)
    with pytest.raises(ValueError, match="kscale"):
        pa.paged_decode_attention_q8(q, kq, kq, ks[:, :, :8].contiguous(),
                                     ks, tables, lens)


@pytest.mark.parametrize("M,K,N", [
    (1, 256, 384),
    (5, 11008, 200),        # ragged N, the widest K of LLaMA-7B
    (8, 4096, 4096),        # decode: split over K
    (200, 512, 1000),       # several 64-row tiles, ragged M and N
    (8, 48, 64),            # K shorter than one 64-deep tile
])
def test_int8_matmul_kernel_matches_plain(gen, M, K, N):
    x = _randn(gen, M, K)
    w = torch.randn((K, N), generator=gen, device="cuda") * K ** -0.5
    qd = im.quantize_int8(w)
    before = im.launches
    out = im.int8_matmul(x, qd["q"], qd["s"])
    torch.cuda.synchronize()
    assert im.launches == before + 1
    assert out.dtype == torch.bfloat16 and out.shape == (M, N)
    ref = im.int8_matmul_plain(x, qd["q"], qd["s"], torch.float32)
    torch.testing.assert_close(out.float(), ref, **TOL)


def test_int8_matmul_kernel_refuses_what_it_cannot_take(gen):
    x = _randn(gen, 4, 64)
    qd = im.quantize_int8(torch.randn((64, 32), generator=gen,
                                      device="cuda"))
    with pytest.raises(TypeError):                      # fp32 activations
        im.int8_matmul(x.float(), qd["q"], qd["s"])
    with pytest.raises(TypeError):                      # the kernel writes bf16
        im.int8_matmul(x, qd["q"], qd["s"], out_dtype=torch.float32)
    with pytest.raises(ValueError, match="K % 16"):
        im.int8_matmul(x[:, :40].contiguous(), qd["q"][:40].contiguous(),
                       qd["s"])
    with pytest.raises(ValueError, match="contiguous"):
        im.int8_matmul(x, qd["q"].t().contiguous().t(), qd["s"])


def _segments(rows, T):
    seg = torch.empty((len(rows), T), dtype=torch.int32)
    for b, lengths in enumerate(rows):
        seg[b] = len(lengths)                 # sentinel tail
        at = 0
        for i, L in enumerate(lengths):
            seg[b, at:at + L] = i
            at += L
    return seg.cuda()


def _ref_lse(q, k, seg, causal):
    B, T, n, d = q.shape
    kr = k.float().repeat_interleave(n // k.shape[2], dim=2)
    sc = torch.einsum("bqhd,bkhd->bhqk", q.float(), kr) / math.sqrt(d)
    vis = seg[:, :, None] == seg[:, None, :]
    if causal:
        pos = torch.arange(T, device=q.device)
        vis = vis & (pos[:, None] >= pos[None])
    return torch.logsumexp(sc.masked_fill(~vis[:, None], -1e30), dim=-1)


@pytest.mark.parametrize("T,n,nkv,d,rows,causal", [
    (200, 8, 2, 64, [[50, 1, 149], [200]], True),    # ragged, 2 rows, GQA
    (130, 4, 4, 128, [[64, 66]], False),              # non-causal
    (64, 4, 1, 128, [[1] * 64], True),                # all length-1 segments
    (300, 4, 2, 128, [[10, 20]], True),               # long sentinel tail
])
def test_segmented_kernel_matches_plain(gen, T, n, nkv, d, rows, causal):
    B = len(rows)
    q, k, v = _randn(gen, B, T, n, d), _randn(gen, B, T, nkv, d), \
        _randn(gen, B, T, nkv, d)
    seg = _segments(rows, T)
    before = fv.launches
    out, lse = fv._seg_fwd(q, k, v, seg, causal)
    torch.cuda.synchronize()
    assert fv.launches == before + 1
    assert torch.isfinite(out.float()).all()
    ref = fv.segmented_sdpa_plain(q.float(), k.float(), v.float(), seg,
                                  causal)
    torch.testing.assert_close(out.float(), ref, **TOL)
    torch.testing.assert_close(lse, _ref_lse(q, k, seg, causal), **TOL)


def test_segmented_kernel_refuses_what_it_cannot_take(gen):
    q, k = _randn(gen, 1, 64, 4, 96), _randn(gen, 1, 64, 4, 96)
    seg = _segments([[64]], 64)
    with pytest.raises(ValueError, match="head_dim"):
        fv.flash_attention_segmented(q, k, k, seg, causal=True)
    q, k = _randn(gen, 1, 64, 4, 64), _randn(gen, 1, 64, 4, 64)
    with pytest.raises(TypeError):
        fv._seg_fwd(q, k, k, seg.long(), True)
    with pytest.raises(ValueError, match="contiguous"):
        fv._seg_fwd(q, k.transpose(1, 2).contiguous().transpose(1, 2), k,
                    seg, True)
