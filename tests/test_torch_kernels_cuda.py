"""The port's CUDA kernels against their plain versions on a CUDA card, at
shapes ``chip_smoke.py`` does not reach: other page sizes and head dims, the
largest GQA group the paged kernels hold (also at head_dim 256), empty rows,
int8 pages with a slot quantized from an all-zero token, chip_smoke's table
at nkv 32 and 8, rows that end on either side of a split of the kernel's
plan, a table far longer than its rows (most splits empty), plans of one
split (no combine pass), two calls for bit-identical results and one call
captured in a CUDA graph and replayed with other lengths, ragged and
batched packed streams, non-causal attention, the int8 matmul at ragged M, N and K, its decode
path at 1 to 16 rows over LLaMA-7B's decode projections (bit-identical at
every split, replayed from a CUDA graph with new x), the training
kernels (fused RoPE, flash attention forward and backward, fused AdamW) at
one row, one token, ragged lengths, head_dim 64, non-causal and leaves of 1
and 129 elements, the flash forward on either side of its 128-row tiles,
at 4,096 tokens, with out and lse views at the head of sentinel-filled
buffers (nothing past S written) and run twice for bit-identical results,
the flash backward (dq; dk and dv) on either side of its 64- and 128-row
tiles, at 2,047 and 4,096 tokens, d 64 / 128, causal or not, from the
forward kernel's own out and lse, with dq, dk and dv views at the head of
sentinel-filled buffers and run twice for bit-identical results, the
segmented backward (dq; dk and dv) at one token,
lengths on either side of its 64-row stages and 128-row blocks, segment
boundaries inside a stage and on its edge, a document spanning three blocks
(stages that need no mask), one segment filling a row, all 1-token
segments, GQA groups of 4 and 8 over several q tiles, head_dim 64 causal or
not, key tiles wholly in a -1 pad tail, run twice for bit-identical
results, the trunk's flagged kernels (rms_norm
forward and backward, swiglu forward and backward, rmsnorm_matmul) at one
row, the rms_norm forward's instances at h 64 to 8192, rows no multiple of 8 or 128, f32 and mixed types, tensors off a
16-byte boundary, ragged N, H no multiple of 128, rmsnorm_matmul across its
128 x 256 tiles (odd N, H of one ragged stage to 64 stages), K9b and
rmsnorm_matmul run twice for bit-identical results, and the wrappers'
refusals.

Every test needs a card and skips without one.  The card machine has no JAX,
so run this file there without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_kernels_cuda.py -q

Tolerance 2e-2 abs / 2e-2 rel against the plain version computed in fp32
from the same bf16 inputs: one bf16 rounding of the output plus another
summation order.
"""

import functools
import math

import pytest

torch = pytest.importorskip("torch")

from paddle_tpu_torch.ops import flash_attention as fa  # noqa: E402
from paddle_tpu_torch.ops import flash_varlen as fv  # noqa: E402
from paddle_tpu_torch.ops import fused_adamw as aw  # noqa: E402
from paddle_tpu_torch.ops import int8_matmul as im  # noqa: E402
from paddle_tpu_torch.ops import rope  # noqa: E402
from paddle_tpu_torch.ops import paged_attention as pa  # noqa: E402
from paddle_tpu_torch.ops import rms_norm as rn  # noqa: E402
from paddle_tpu_torch.ops import rmsnorm_matmul as rmm  # noqa: E402
from paddle_tpu_torch.ops import swiglu as sw  # noqa: E402

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


K1_LENS = [1, 64, 65, 2048, 300, 1000, 1500, 777]     # chip_smoke's rows
PAGED_CASES = [
    (32, 2, 64, 16, [0, 1, 15, 16, 17, 100], 8),     # group of 16, empty row
    (8, 8, 128, 32, [33, 64, 1], 3),
    (16, 4, 256, 8, [9, 40], 5),                     # the widest head_dim
    (32, 32, 128, 64, K1_LENS, 32),                  # chip_smoke's table
    (32, 8, 128, 64, K1_LENS, 32),                   # ... at nkv 8
    (8, 8, 128, 16, [1, 5, 40, 0], 256),             # most splits empty
    (32, 2, 256, 16, [0, 7, 100, 300], 20),          # g = 16 at d = 256
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


def _run_paged(q8, q, kp, vp, tables, lens_t):
    """K1, or K4 over pools quantized from ``kp`` / ``vp``, and its plain
    version in fp32."""
    if not q8:
        return (pa.paged_decode_attention(q, kp, vp, tables, lens_t),
                pa.paged_decode_attention_plain(q.float(), kp.float(),
                                                vp.float(), tables, lens_t))
    kq, ks = pa.quantize_kv_token(kp)
    vq, vs = pa.quantize_kv_token(vp)
    return (pa.paged_decode_attention_q8(q, kq, vq, ks, vs, tables, lens_t),
            pa.paged_decode_attention_q8_plain(q.float(), kq, vq, ks, vs,
                                               tables, lens_t))


@pytest.mark.parametrize("q8", [False, True], ids=["k1", "k4"])
def test_paged_decode_kernel_rows_on_split_edges(gen, q8):
    # the card's own plan: rows that end on a split's last slot, one slot
    # past it, one slot short of it, and in a later split's first page
    n, nkv, d, page, pages_max = 16, 8, 128, 16, 64
    S, ps = pa.split_plan(4, nkv, n // nkv, pages_max, page,
                          torch.cuda.get_device_properties(0)
                          .multi_processor_count)
    assert S > 1
    span = ps * page
    lens = [span, span + 1, span - 1, 2 * span + 3]
    q, kp, vp, tables, lens_t = _paged_case(gen, n, nkv, d, page, lens,
                                            pages_max)
    out, ref = _run_paged(q8, q, kp, vp, tables, lens_t)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), ref, **TOL)


# (n, nkv, d, page, lens, pages_max) whose plan on an H100 is one split, so
# the split pass writes the output and no combine runs: a one-page table
# with an empty row, and a full grid of short rows (a larger batch over
# short contexts)
ONE_SPLIT_CASES = [
    (8, 2, 128, 64, [0, 1, 64, 30], 1),
    (32, 32, 128, 64, [0, 1, 63, 64, 65, 128, 200, 255, 256, 3, 17, 99,
                       150, 190, 230, 256], 4),
]


@pytest.mark.parametrize("q8", [False, True], ids=["k1", "k4"])
@pytest.mark.parametrize("n,nkv,d,page,lens,pages_max", ONE_SPLIT_CASES)
def test_paged_decode_kernel_with_one_split(gen, n, nkv, d, page, lens,
                                            pages_max, q8):
    assert pa.split_plan(len(lens), nkv, n // nkv, pages_max, page,
                         torch.cuda.get_device_properties(0)
                         .multi_processor_count)[0] == 1
    q, kp, vp, tables, lens_t = _paged_case(gen, n, nkv, d, page, lens,
                                            pages_max)
    out, ref = _run_paged(q8, q, kp, vp, tables, lens_t)
    torch.cuda.synchronize()
    assert torch.isfinite(out.float()).all()
    for b, L in enumerate(lens):
        if L == 0:
            assert (out[b] == 0).all()          # an empty row writes zeros
        else:
            torch.testing.assert_close(out[b].float(), ref[b], **TOL)


@pytest.mark.parametrize("q8", [False, True], ids=["k1", "k4"])
def test_paged_decode_kernel_is_bit_identical_run_to_run(gen, q8):
    for nkv in (32, 8):
        q, kp, vp, tables, lens_t = _paged_case(gen, 32, nkv, 128, 64,
                                                K1_LENS, 32)
        first, _ = _run_paged(q8, q, kp, vp, tables, lens_t)
        again, _ = _run_paged(q8, q, kp, vp, tables, lens_t)
        torch.cuda.synchronize()
        assert torch.equal(first, again)


@pytest.mark.parametrize("q8", [False, True], ids=["k1", "k4"])
def test_paged_decode_kernel_replays_in_a_cuda_graph_with_new_lengths(gen,
                                                                      q8):
    # the split plan reads shapes only, so a captured call stays right when
    # the lengths change on the card between replays
    q, kp, vp, tables, lens_t = _paged_case(gen, 32, 8, 128, 64, K1_LENS, 32)
    args = (q, kp, vp)
    if q8:
        kq, ks = pa.quantize_kv_token(kp)
        vq, vs = pa.quantize_kv_token(vp)
        args = (q, kq, vq, ks, vs)
    fn = pa.paged_decode_attention_q8 if q8 else pa.paged_decode_attention
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn(*args, tables, lens_t)                       # warm-up, built
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn(*args, tables, lens_t)
    # shorter rows within each row's pages, one row emptied
    new_lens = [max(0, L - 37) for L in K1_LENS]
    new_lens[2] = 0
    lens_t.copy_(torch.tensor(new_lens, dtype=torch.int32, device="cuda"))
    graph.replay()
    eager = fn(*args, tables, lens_t)
    torch.cuda.synchronize()
    assert torch.equal(out, eager)
    assert (out[2] == 0).all()


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
    (300, 4096, 1001),      # the wave path at an odd N: byte loads
])
def test_int8_matmul_kernel_matches_plain(gen, M, K, N):
    x = _randn(gen, M, K)
    w = torch.randn((K, N), generator=gen, device="cuda") * K ** -0.5
    qd = im.quantize_int8(w)
    before = im.launches + im.launches_wave
    out = im.int8_matmul(x, qd["q"], qd["s"])
    torch.cuda.synchronize()
    assert im.launches + im.launches_wave == before + 1
    assert out.dtype == torch.bfloat16 and out.shape == (M, N)
    ref = im.int8_matmul_plain(x, qd["q"], qd["s"], torch.float32)
    torch.testing.assert_close(out.float(), ref, **TOL)


def _int8_case(gen, M, K, N):
    x = _randn(gen, M, K)
    qd = im.quantize_int8(torch.randn((K, N), generator=gen, device="cuda")
                          * K ** -0.5)
    return x, qd["q"], qd["s"]


@pytest.mark.parametrize("K", [48, 4096, 11008])
@pytest.mark.parametrize("N", [1000, 4096, 11008])
@pytest.mark.parametrize("M", [17, 64, 128, 200, 2048])
def test_int8_matmul_wave_path_matches_plain(gen, M, K, N):
    """The wave path (above WAVE_MIN_M rows) across its 128 x 256 tiles:
    ragged M, N no multiple of 16 (the plain-load instance), K shorter than
    one 64-deep stage or no multiple of it, splits over K (small M) and
    none (M = 2048)."""
    x, q, s = _int8_case(gen, M, K, N)
    before = (im.launches, im.launches_wave)
    out = im.int8_matmul(x, q, s)
    torch.cuda.synchronize()
    assert (im.launches, im.launches_wave) == (before[0], before[1] + 1)
    assert out.dtype == torch.bfloat16 and out.shape == (M, N)
    ref = im.int8_matmul_plain(x, q, s, torch.float32)
    torch.testing.assert_close(out.float(), ref, **TOL)


@pytest.mark.parametrize("M", [16, 32, 64, 128])
@pytest.mark.parametrize("wave", [False, True], ids=["decode", "wave"])
def test_int8_matmul_paths_agree_at_the_crossover(gen, M, wave,
                                                 monkeypatch):
    """Either path at the Ms where one takes over from the other, at
    decode w_gate's K and N (the crossover moved to force the path)."""
    x, q, s = _int8_case(gen, M, 4096, 11008)
    monkeypatch.setattr(im, "WAVE_MIN_M", 0 if wave else M)
    before = (im.launches, im.launches_wave)
    out = im._kernel(x, q, s)
    assert (im.launches, im.launches_wave) == (before[0] + (not wave),
                                               before[1] + wave)
    torch.cuda.synchronize()
    ref = im.int8_matmul_plain(x, q, s, torch.float32)
    torch.testing.assert_close(out.float(), ref, **TOL)


@pytest.mark.parametrize("M,K,N", [(2048, 4096, 11008), (128, 11008, 4096),
                                   (200, 512, 1000)])
def test_int8_matmul_wave_path_is_bit_identical_run_to_run(gen, M, K, N):
    """No atomics: the wave path (without and with a split over K, and its
    plain-load instance) gives the same bits twice."""
    x, q, s = _int8_case(gen, M, K, N)
    a, b = im.int8_matmul(x, q, s), im.int8_matmul(x, q, s)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


# (K, N) of the decode path's cases: K shorter than one 64-deep stage,
# wq / wk / wv / wo, w_gate / w_up, w_down (each split over K), and ragged N
# (1000: plain 8-byte loads; 200 at the widest K: a plain-load instance
# split over K)
DECODE_KN = [(48, 64), (4096, 4096), (4096, 11008), (11008, 4096),
             (4096, 1000), (11008, 200)]


@functools.lru_cache(maxsize=None)
def _decode_weight(K, N):
    """The int8 codes and scales of a seeded [K, N] weight, made once."""
    g = torch.Generator(device="cuda").manual_seed(K * 100003 + N)
    qd = im.quantize_int8(torch.randn((K, N), generator=g, device="cuda")
                          * K ** -0.5)
    return qd["q"], qd["s"]


@pytest.mark.parametrize("K,N", DECODE_KN)
@pytest.mark.parametrize("M", [1, 2, 7, 8, 9, 15, 16])
def test_int8_matmul_decode_path_matches_plain(gen, M, K, N):
    """The decode path (up to WAVE_MIN_M rows) on either side of its 8-row
    product (MT 8 and 16), at every decode projection of LLaMA-7B and
    ragged N, one launch a call."""
    q, s = _decode_weight(K, N)
    x = _randn(gen, M, K)
    before = (im.launches, im.launches_wave)
    out = im.int8_matmul(x, q, s)
    torch.cuda.synchronize()
    assert (im.launches, im.launches_wave) == (before[0] + 1, before[1])
    assert out.dtype == torch.bfloat16 and out.shape == (M, N)
    ref = im.int8_matmul_plain(x, q, s, torch.float32)
    torch.testing.assert_close(out.float(), ref, **TOL)


@pytest.mark.parametrize("K,N", DECODE_KN)
@pytest.mark.parametrize("M", [8, 16])
def test_int8_matmul_decode_path_is_bit_identical_run_to_run(gen, M, K, N):
    """Only the arrival counts are atomic: the last block of a tile adds the
    splits in split order, so every split shape gives the same bits."""
    q, s = _decode_weight(K, N)
    x = _randn(gen, M, K)
    a, b, c = (im.int8_matmul(x, q, s) for _ in range(3))
    torch.cuda.synchronize()
    assert torch.equal(a, b) and torch.equal(a, c)


@pytest.mark.parametrize("K,N", [(4096, 4096), (11008, 4096), (4096, 1000)])
def test_int8_matmul_decode_path_replays_in_a_cuda_graph_with_new_x(gen, K,
                                                                    N):
    """A decode-path call captured in a CUDA graph (its arrival counts made
    inside the capture) and replayed with new x gives the eager call's bits,
    replay after replay and after eager calls on the stream."""
    q, s = _decode_weight(K, N)
    static_x = _randn(gen, 8, K)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        im.int8_matmul(static_x, q, s)          # build and warm up
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        static_out = im.int8_matmul(static_x, q, s)
    for _ in range(3):
        x = _randn(gen, 8, K)
        static_x.copy_(x)
        graph.replay()
        eager = im.int8_matmul(x, q, s)
        torch.cuda.synchronize()
        assert torch.equal(static_out, eager)
    ref = im.int8_matmul_plain(static_x, q, s, torch.float32)
    torch.testing.assert_close(static_out.float(), ref, **TOL)


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


def _segments(rows, T, pad=None):
    """Runs of ids 0.. per row, then ``pad`` (default: a sentinel id of
    the row's own) up to T."""
    seg = torch.empty((len(rows), T), dtype=torch.int32)
    for b, lengths in enumerate(rows):
        seg[b] = len(lengths) if pad is None else pad
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


SEG_FWD_CASES = [
    (64, 4, 4, 128, [[20, 30]], True, None),             # T less than a tile
    (300, 4, 4, 128, [[100, 10, 190]], True, None),      # tile 0 spans 3 runs
    (256, 8, 2, 128, [[128, 128]], True, None),          # GQA g = 4, free tiles
    (384, 16, 2, 128, [[130, 126, 128]], True, None),    # GQA g = 8
    (520, 8, 8, 64, [[300, 220]], True, None),           # d = 64
    (400, 4, 2, 128, [[200, 55, 145]], False, None),     # non-causal
    (260, 4, 4, 128, [[1] * 130], True, -1),             # 1-token runs, -1 pad
]


@pytest.mark.parametrize("T,n,nkv,d,rows,causal,pad", SEG_FWD_CASES)
def test_segmented_forward_kernel_across_its_tiles(gen, T, n, nkv, d, rows,
                                                   causal, pad):
    """K2 on either side of its 128-row tiles: tiles that need no mask
    (one segment, below the diagonal) beside masked ones, GQA, d 64,
    non-causal and a -1 pad tail that attends only to itself."""
    B = len(rows)
    q, k, v = _randn(gen, B, T, n, d), _randn(gen, B, T, nkv, d), \
        _randn(gen, B, T, nkv, d)
    seg = _segments(rows, T, pad)
    out, lse = fv._seg_fwd(q, k, v, seg, causal)
    torch.cuda.synchronize()
    assert torch.isfinite(out.float()).all() and torch.isfinite(lse).all()
    ref = fv.segmented_sdpa_plain(q.float(), k.float(), v.float(), seg,
                                  causal)
    torch.testing.assert_close(out.float(), ref, **TOL)
    torch.testing.assert_close(lse, _ref_lse(q, k, seg, causal), **TOL)


@pytest.mark.parametrize("rows", [64, fv.BLOCK_ROWS])
@pytest.mark.parametrize("T,layout,pad", [
    (1, [[1]], None), (64, [[20, 30]], None), (300, [[100, 10, 190]], None),
    (2048, [[700, 64, 1, 900, 300]], None), (256, [[128, 128]], None),
    (260, [[1] * 130, [259]], -1), (4097, [[4097], [1] * 4000], None)])
def test_tile_range_kernel_matches_plain(gen, T, layout, pad, rows):
    """The range kernel (one launch) against the plain version's scans on
    the padded stream, rows on either side of a tile, 1-token runs, a -1
    pad tail and a row whose run reversed."""
    seg = _segments(layout, T, pad)
    if len(layout) > 1:
        seg[1] = seg[1].flip(0)
    kmin, kmax = fv._tile_ranges(seg, rows)
    want = fv._tile_ranges_plain(seg.cpu(), rows)
    torch.cuda.synchronize()
    assert torch.equal(kmin.cpu(), want[0]) and torch.equal(kmax.cpu(),
                                                            want[1])


def test_segmented_forward_kernel_is_bit_identical_run_to_run(gen):
    q, k, v = _randn(gen, 2, 700, 16, 128), _randn(gen, 2, 700, 4, 128), \
        _randn(gen, 2, 700, 4, 128)
    seg = _segments([[300, 1, 399], [64, 636]], 700)
    a, b = fv._seg_fwd(q, k, v, seg, True), fv._seg_fwd(q, k, v, seg, True)
    torch.cuda.synchronize()
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


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


# K5 across its head groups (the host's pick on a 132-SM H100 in the
# comment: G = 1, 2 or 4), head tails (N no multiple of G) and grid tails,
# one token (B * S = 1), S 1 / 7 / 2047, N 1 / 3 / 32, d 16 / 64 / 128,
# bf16 and f32
ROPE_CASES = [
    (1, 1, 1, 128, torch.bfloat16),       # G 1, one token
    (2, 65, 3, 64, torch.bfloat16),       # G 1, ragged length, head_dim 64
    (1, 7, 2, 16, torch.bfloat16),        # G 1, the narrowest bf16 head
    (2, 33, 2, 128, torch.float32),       # G 1
    (1, 2047, 1, 128, torch.bfloat16),    # G 1, one head, grid tail
    (1, 7, 3, 128, torch.float32),        # G 1, three heads
    (5, 2047, 3, 128, torch.bfloat16),    # G 2, head tail, grid tail
    (4, 2047, 3, 128, torch.float32),     # G 2, f32, head tail, grid tail
    (2, 2047, 16, 128, torch.bfloat16),   # G 2, the ragged trainer shape
    (3, 2047, 32, 64, torch.bfloat16),    # G 4, head_dim 64, grid tail
    (6, 2047, 5, 64, torch.float32),      # G 4, f32 d 64, head tail
    (3, 700, 32, 128, torch.float32),     # G 4, f32
    (8, 2047, 7, 128, torch.bfloat16),    # G 4, head tail, grid tail
    (4, 2047, 5, 128, torch.float32),     # G 4, f32, head tail, grid tail
]


@pytest.mark.parametrize("b,s,n,d,dtype", ROPE_CASES)
def test_fused_rope_kernel_matches_plain_bit_for_bit(gen, b, s, n, d, dtype):
    """Forward and backward: the kernel rounds each product and sum on
    its own, as the plain version does."""
    x = torch.randn((b, s, n, d), generator=gen, device="cuda",
                    dtype=torch.float32).to(dtype).requires_grad_(True)
    ct = torch.randn((b, s, n, d), generator=gen, device="cuda",
                     dtype=torch.float32).to(dtype)
    cos, sin = rope.rope_tables(s, d)
    before = rope.launches
    out = rope.fused_rope(x, cos, sin)
    out.backward(ct)
    torch.cuda.synchronize()
    assert rope.launches == before + 2
    assert torch.equal(out, rope._composite(x.detach(), cos, sin, False))
    assert torch.equal(x.grad, rope._composite(ct, cos, sin, True))


def test_fused_rope_plan_fills_the_card(gen):
    """The host's head group: the largest of 4, 2 (at most N) whose grid
    of 256-thread blocks gives every SM 4, else 1; ROPE_CASES reach every
    group."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def blocks(b, s, n, d, dtype, g):
        chunks = d // 2 // (8 if dtype == torch.bfloat16 else 4)
        return -(-(b * s * -(-n // g) * chunks) // 256)

    seen = set()
    for b, s, n, d, dtype in ROPE_CASES + [(8, 256, 32, 128, torch.bfloat16),
                                           (1, 256, 32, 128, torch.bfloat16)]:
        g, grid = rope.launch_plan((b, s, n, d), dtype)
        seen.add(g)
        assert grid == blocks(b, s, n, d, dtype, g)
        assert g == 1 or grid >= 4 * sms
        for bigger in (2 * g, 4 * g):
            if bigger <= min(4, n):
                assert blocks(b, s, n, d, dtype, bigger) < 4 * sms
    if sms == 132:
        assert seen == {1, 2, 4}


def test_rope_tables_made_in_a_graph_capture_are_not_kept(gen):
    """``_rope`` inside a CUDA-graph capture builds its tables in the
    graph's memory and keeps none in the memo; a later eager call (which
    keeps them) gives the replay's tensors."""
    from paddle_tpu_torch.models import llama_pretrain as tlp
    s, d, theta = 37, 128, 12345.0          # a key no other test uses
    key = (s, d, theta, torch.device("cuda", torch.cuda.current_device()))
    q = torch.randn((2, s, 4, d), generator=gen, device="cuda",
                    dtype=torch.bfloat16)
    k = torch.randn((2, s, 2, d), generator=gen, device="cuda",
                    dtype=torch.bfloat16)
    tlp._rope(q[:, :5], k[:, :5], theta)    # builds and loads the kernel
    torch.cuda.synchronize()
    builds = rope.table_builds
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got_q, got_k = tlp._rope(q, k, theta)
    assert key not in rope._tables
    assert rope.table_builds == builds + 1
    graph.replay()
    want_q, want_k = tlp._rope(q, k, theta)
    torch.cuda.synchronize()
    assert key in rope._tables
    assert torch.equal(got_q, want_q) and torch.equal(got_k, want_k)
    del graph


def test_fused_rope_kernel_refuses_what_it_cannot_take(gen):
    cos, sin = rope.rope_tables(4, 24)
    with pytest.raises(ValueError, match="d/2"):         # 12 % 8 != 0
        rope.fused_rope(_randn(gen, 1, 4, 2, 24), cos, sin)
    cos, sin = rope.rope_tables(4, 64)
    with pytest.raises(TypeError):
        rope.fused_rope(_randn(gen, 1, 4, 2, 64).half(), cos, sin)
    with pytest.raises(ValueError, match="cos / sin"):
        rope.fused_rope(_randn(gen, 1, 5, 2, 64), cos, sin)
    with pytest.raises(ValueError, match="contiguous"):
        rope.fused_rope(_randn(gen, 1, 2, 4, 64).transpose(1, 2), cos, sin)


@pytest.mark.parametrize("b,s,h,d,causal", [
    (1, 1, 1, 128, True),                 # one token
    (1, 65, 2, 128, True),                # one row past a tile
    (2, 200, 3, 64, True),                # ragged, head_dim 64
    (2, 130, 2, 128, False),              # non-causal, ragged
    (1, 128, 4, 64, False),
])
def test_flash_attention_kernels_match_plain(gen, b, s, h, d, causal):
    q, k, v, ct = (_randn(gen, b, s, h, d) for _ in range(4))
    before = (fa.launches, fa.launches_dq, fa.launches_dkv)
    qg, kg, vg = (t.clone().requires_grad_(True) for t in (q, k, v))
    out = fa.flash_attention(qg, kg, vg, causal)
    out.backward(ct)
    torch.cuda.synchronize()
    assert (fa.launches, fa.launches_dq, fa.launches_dkv) == tuple(
        c + 1 for c in before)
    ref, lse = fa._fwd_plain(q.float(), k.float(), v.float(), causal)
    torch.testing.assert_close(out.float(), ref, **TOL)
    _, lse_k = fa._fwd_kernel(q, k, v, causal)
    torch.testing.assert_close(lse_k, lse, **TOL)
    # the plain backward from the kernel's own saved forward
    args = (q.float(), k.float(), v.float(), ct.float(), lse_k,
            fa._delta(ct, out), causal)
    dq = fa._bwd_dq_plain(*args)
    dk, dv = fa._bwd_dkv_plain(*args)
    for name, got, want in (("dq", qg.grad, dq), ("dk", kg.grad, dk),
                            ("dv", vg.grad, dv)):
        assert torch.isfinite(got.float()).all(), name
        torch.testing.assert_close(got.float(), want, **TOL, msg=name)


# K6a's forward alone at lengths on either side of its 128-row q tiles and
# 128-key tiles, and one long row; b * h gives more q tiles than one wave
# of blocks on 132 SMs at S = 4096 (and 2 * 3 * 2 = 12 blocks below)
@pytest.mark.parametrize("s", [127, 128, 129, 255, 257, 4096])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_forward_kernel_across_its_tiles(gen, s, d, causal):
    b, h = (1, 8) if s == 4096 else (2, 3)
    q, k, v = (_randn(gen, b, s, h, d) for _ in range(3))
    before = fa.launches
    out, lse = fa._fwd_kernel(q, k, v, causal)
    torch.cuda.synchronize()
    assert fa.launches == before + 1
    ref, ref_lse = fa._fwd_plain(q.float(), k.float(), v.float(), causal)
    torch.testing.assert_close(out.float(), ref, **TOL)
    torch.testing.assert_close(lse, ref_lse, **TOL)


@pytest.mark.parametrize("s,d", [(129, 128), (200, 64), (1, 128)])
def test_flash_forward_kernel_writes_nothing_past_s(gen, s, d):
    """out and lse handed to the launcher as views at the head of larger
    buffers filled with a sentinel: rows of the last (b, h) past S lie in
    the tail, which must keep the sentinel."""
    b, h = 2, 2
    q, k, v = (_randn(gen, b, s, h, d) for _ in range(3))
    n_out, n_lse = b * s * h * d, b * h * s
    out_buf = torch.full((n_out + 256 * h * d,), 7.0, device="cuda",
                         dtype=torch.bfloat16)
    lse_buf = torch.full((n_lse + 256,), 7.0, device="cuda")
    out, lse = out_buf[:n_out].view(b, s, h, d), lse_buf[:n_lse].view(b, h, s)
    err = fa._kernel_fns()[0](q.data_ptr(), k.data_ptr(), v.data_ptr(),
                              out.data_ptr(), lse.data_ptr(),
                              *fa._launch_tail(q, True))
    torch.cuda.synchronize()
    assert err == 0
    assert bool((out_buf[n_out:] == 7.0).all())
    assert bool((lse_buf[n_lse:] == 7.0).all())
    ref, ref_lse = fa._fwd_plain(q.float(), k.float(), v.float(), True)
    torch.testing.assert_close(out.float(), ref, **TOL)
    torch.testing.assert_close(lse, ref_lse, **TOL)


@pytest.mark.parametrize("d", [64, 128])
def test_flash_forward_kernel_is_bit_identical_run_to_run(gen, d):
    q, k, v = (_randn(gen, 2, 1000, 4, d) for _ in range(3))
    out_a, lse_a = fa._fwd_kernel(q, k, v, True)
    out_b, lse_b = fa._fwd_kernel(q, k, v, True)
    torch.cuda.synchronize()
    assert torch.equal(out_a, out_b) and torch.equal(lse_a, lse_b)


def _bwd_case(gen, b, s, h, d, causal):
    """q, k, v, dout and the forward kernel's own out, lse and delta."""
    q, k, v, do = (_randn(gen, b, s, h, d) for _ in range(4))
    out, lse = fa._fwd_kernel(q, k, v, causal)
    return q, k, v, do, lse, fa._delta(do, out)


# K6b and K6c alone at lengths on either side of their 64- and 128-row
# tiles, 2047 (chip_smoke's ragged length) and one long row
@pytest.mark.parametrize("s", [1, 63, 64, 65, 127, 128, 129, 255, 257, 2047,
                               4096])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_backward_kernels_across_their_tiles(gen, s, d, causal):
    b, h = (1, 8) if s == 4096 else (2, 3)
    q, k, v, do, lse, delta = _bwd_case(gen, b, s, h, d, causal)
    before = (fa.launches_dq, fa.launches_dkv)
    dq = fa._bwd_dq_kernel(q, k, v, do, lse, delta, causal)
    dk, dv = fa._bwd_dkv_kernel(q, k, v, do, lse, delta, causal)
    torch.cuda.synchronize()
    assert (fa.launches_dq, fa.launches_dkv) == (before[0] + 1, before[1] + 1)
    args = (q.float(), k.float(), v.float(), do.float(), lse, delta, causal)
    ref_dq = fa._bwd_dq_plain(*args)
    ref_dk, ref_dv = fa._bwd_dkv_plain(*args)
    for name, got, want in (("dq", dq, ref_dq), ("dk", dk, ref_dk),
                            ("dv", dv, ref_dv)):
        assert torch.isfinite(got.float()).all(), name
        torch.testing.assert_close(got.float(), want.float(), **TOL, msg=name)


@pytest.mark.parametrize("s,d", [(129, 128), (200, 64), (1, 128)])
def test_flash_backward_kernels_write_nothing_past_s(gen, s, d):
    """dq, dk and dv handed to the launchers as views at the head of larger
    buffers filled with a sentinel: rows of the last (b, h) past S lie in
    the tail, which must keep the sentinel."""
    b, h = 2, 2
    q, k, v, do, lse, delta = _bwd_case(gen, b, s, h, d, True)
    n = b * s * h * d
    bufs = [torch.full((n + 256 * h * d,), 7.0, device="cuda",
                       dtype=torch.bfloat16) for _ in range(3)]
    dq, dk, dv = (buf[:n].view(b, s, h, d) for buf in bufs)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr())
    tail = fa._launch_tail(q, True)
    assert fa._kernel_fns()[1](*ptrs, dq.data_ptr(), *tail) == 0
    assert fa._kernel_fns()[2](*ptrs, dk.data_ptr(), dv.data_ptr(),
                               *tail) == 0
    torch.cuda.synchronize()
    for buf in bufs:
        assert bool((buf[n:] == 7.0).all())
    args = (q.float(), k.float(), v.float(), do.float(), lse, delta, True)
    ref_dk, ref_dv = fa._bwd_dkv_plain(*args)
    for name, got, want in (("dq", dq, fa._bwd_dq_plain(*args)),
                            ("dk", dk, ref_dk), ("dv", dv, ref_dv)):
        torch.testing.assert_close(got.float(), want.float(), **TOL, msg=name)


@pytest.mark.parametrize("d", [64, 128])
def test_flash_backward_kernels_are_bit_identical_run_to_run(gen, d):
    args = _bwd_case(gen, 2, 1000, 4, d, True) + (True,)
    dq_a = fa._bwd_dq_kernel(*args)
    dk_a, dv_a = fa._bwd_dkv_kernel(*args)
    dq_b = fa._bwd_dq_kernel(*args)
    dk_b, dv_b = fa._bwd_dkv_kernel(*args)
    torch.cuda.synchronize()
    assert torch.equal(dq_a, dq_b)
    assert torch.equal(dk_a, dk_b) and torch.equal(dv_a, dv_b)


def test_flash_attention_kernel_refuses_what_it_cannot_take(gen):
    q, k = _randn(gen, 1, 8, 2, 128), _randn(gen, 1, 16, 2, 128)
    with pytest.raises(ValueError, match="q_len == kv_len"):
        fa.flash_attention(q, k, k, causal=True)
    with pytest.raises(ValueError, match="q_len <= kv_len"):
        fa.flash_attention(k, q, q, causal=True)
    q96 = _randn(gen, 1, 8, 2, 96)
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_attention(q96, q96, q96)
    with pytest.raises(ValueError, match="head counts"):
        fa.flash_attention(q, _randn(gen, 1, 8, 1, 128),
                           _randn(gen, 1, 8, 1, 128))
    with pytest.raises(TypeError):
        fa.flash_attention(q.float(), q.float(), q.float())


@pytest.mark.parametrize("n", [1, 129, 4096 + 3])
@pytest.mark.parametrize("g_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t", [1, 100])
def test_fused_adamw_kernel_matches_plain(gen, n, g_dtype, t):
    """A few units in the last place: the compiler may fuse a multiply
    and an add where the plain version rounds twice."""
    p = torch.randn(n, generator=gen, device="cuda")
    g = torch.randn(n, generator=gen, device="cuda").to(g_dtype)
    m = 0.1 * torch.randn(n, generator=gen, device="cuda")
    v = 0.01 * torch.rand(n, generator=gen, device="cuda")
    hyper = dict(lr=3e-3, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1)
    want = aw.fused_adamw_plain(p, g, m, v, t, **hyper)
    before = aw.launches
    out_p, out_mo = aw.fused_adamw(p, g, m, v, t, **hyper)
    torch.cuda.synchronize()
    assert aw.launches == before + 1
    assert out_p is p and out_mo["m"] is m and out_mo["v"] is v
    for got, ref in zip((p, m, v), want):
        torch.testing.assert_close(got, ref, atol=1e-6, rtol=1e-5)


def test_fused_adamw_kernel_refuses_what_it_cannot_take(gen):
    p = torch.zeros(8, device="cuda")
    with pytest.raises(ValueError, match="share a shape"):
        aw.fused_adamw(p, torch.zeros(4, device="cuda"), p.clone(),
                       p.clone(), 1, 1e-3)
    with pytest.raises(TypeError):
        aw.fused_adamw(p.bfloat16(), p.clone(), p.clone(), p.clone(), 1, 1e-3)
    with pytest.raises(ValueError, match="boundary"):
        big = torch.zeros(9, device="cuda")
        aw.fused_adamw(big[1:], p.clone(), p.clone(), p.clone(), 1, 1e-3)


def _seg_bwd_case(gen, T, n, nkv, d, rows, causal, pad=None):
    B = len(rows)
    q, do = _randn(gen, B, T, n, d), _randn(gen, B, T, n, d)
    k, v = _randn(gen, B, T, nkv, d), _randn(gen, B, T, nkv, d)
    seg = _segments(rows, T, pad)
    out, lse = fv._seg_fwd(q, k, v, seg, causal)
    return q, k, v, do, seg, lse, fa._delta(do, out)


SEG_BWD_CASES = [
    (1, 2, 2, 128, [[1]], True, None),                   # one token
    (63, 4, 2, 128, [[20, 43]], True, None),             # one short tile
    (65, 4, 4, 128, [[64, 1]], True, None),              # one row past a tile
    (130, 4, 4, 128, [[130], [100]], True, None),        # a row-filling segment
    (96, 2, 1, 128, [[1] * 96], True, None),             # all 1-token segments
    (200, 16, 2, 128, [[50, 1, 149], [77, 60]], True, None),   # group of 8
    (150, 4, 2, 64, [[40, 60, 50]], False, None),        # d=64, non-causal
    (160, 4, 2, 128, [[30, 50], [1] * 40], True, -1),    # -1 pad tails
    # around the 128-row blocks
    (127, 4, 2, 128, [[60, 67]], True, None),
    (128, 4, 4, 128, [[128]], True, None),
    (129, 4, 4, 128, [[100, 29]], True, None),
    (257, 8, 2, 128, [[257]], True, None),
    (256, 4, 4, 128, [[100, 156]], True, None),          # boundary in a stage
    (256, 4, 4, 128, [[64, 192]], True, None),           # on a stage edge
    (400, 4, 2, 128, [[10, 384, 6]], True, None),        # spans 3 blocks:
    (400, 4, 2, 128, [[10, 384, 6]], False, None),       # mask-free tiles
    (512, 16, 4, 128, [[300, 212], [130, 382]], True, None),   # group of 4
    (512, 16, 2, 128, [[130, 382]], True, None),         # group of 8
    (384, 4, 2, 64, [[200, 184]], True, None),           # 128-key stages
    (384, 4, 2, 64, [[200, 1, 183]], False, None),
    (384, 4, 2, 128, [[100, 20]], True, -1),             # key tiles in a pad
    (384, 4, 4, 128, [[50]], False, -1),
]


@pytest.mark.parametrize("T,n,nkv,d,rows,causal,pad", SEG_BWD_CASES)
def test_segmented_backward_kernels_match_plain(gen, T, n, nkv, d, rows,
                                                causal, pad):
    q, k, v, do, seg, lse, delta = _seg_bwd_case(gen, T, n, nkv, d, rows,
                                                 causal, pad)
    ranges = fv._tile_ranges(seg)
    before = (fv.launches_bwd_dq, fv.launches_bwd_dkv)
    dq = fv._seg_bwd_dq_kernel(q, k, v, seg, do, lse, delta, ranges, causal)
    dk, dv = fv._seg_bwd_dkv_kernel(q, k, v, seg, do, lse, delta, ranges,
                                    causal)
    torch.cuda.synchronize()
    assert (fv.launches_bwd_dq, fv.launches_bwd_dkv) == (before[0] + 1,
                                                         before[1] + 1)
    assert dk.shape == k.shape and dv.shape == v.shape
    args = (q.float(), k.float(), v.float(), seg, do.float(), lse, delta,
            causal)
    want_dk, want_dv = fv._seg_bwd_dkv_plain(*args)
    for name, got, want in (("dq", dq, fv._seg_bwd_dq_plain(*args)),
                            ("dk", dk, want_dk), ("dv", dv, want_dv)):
        assert torch.isfinite(got.float()).all(), name
        torch.testing.assert_close(got.float(), want, **TOL, msg=name)


def test_segmented_attention_autograd_matches_plain_autograd(gen):
    """flash_attention_segmented(...).backward launches K2, K7a and K7b
    once each and agrees with autograd through the plain version."""
    T, n, nkv, d = 190, 8, 2, 128
    q, do = _randn(gen, 2, T, n, d), _randn(gen, 2, T, n, d)
    k, v = _randn(gen, 2, T, nkv, d), _randn(gen, 2, T, nkv, d)
    seg = _segments([[70, 1, 100], [33, 33]], T, pad=-1)
    before = (fv.launches, fv.launches_bwd_dq, fv.launches_bwd_dkv)
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    fv.flash_attention_segmented(*leaves, seg, causal=True).backward(do)
    torch.cuda.synchronize()
    assert (fv.launches, fv.launches_bwd_dq, fv.launches_bwd_dkv) == tuple(
        c + 1 for c in before)
    ref = [x.float().requires_grad_(True) for x in (q, k, v)]
    fv.segmented_sdpa_plain(*ref, seg, True).backward(do.float())
    for name, got, want in zip(("dq", "dk", "dv"), leaves, ref):
        assert got.grad.dtype == torch.bfloat16, name
        torch.testing.assert_close(got.grad.float(), want.grad, **TOL,
                                   msg=name)


def test_segmented_backward_kernels_are_deterministic(gen):
    """No atomics: two runs give the same bits (a GQA group of 4)."""
    q, k, v, do, seg, lse, delta = _seg_bwd_case(
        gen, 300, 8, 2, 128, [[100, 7, 150], [300]], True)
    ranges = fv._tile_ranges(seg)
    runs = [(fv._seg_bwd_dq_kernel(q, k, v, seg, do, lse, delta, ranges,
                                   True),
             *fv._seg_bwd_dkv_kernel(q, k, v, seg, do, lse, delta, ranges,
                                     True)) for _ in range(2)]
    torch.cuda.synchronize()
    for name, a, b in zip(("dq", "dk", "dv"), *runs):
        assert torch.equal(a, b), name


def test_segmented_backward_kernels_refuse_what_they_cannot_take(gen):
    q, k, v, do, seg, lse, delta = _seg_bwd_case(gen, 64, 4, 2, 64, [[64]],
                                                 True)
    ranges = fv._tile_ranges(seg)
    for fn in (fv._seg_bwd_dq_kernel, fv._seg_bwd_dkv_kernel):
        with pytest.raises(TypeError):
            fn(q, k, v, seg, do.float(), lse, delta, ranges, True)
        with pytest.raises(ValueError, match="contiguous"):
            fn(q, k, v, seg, do.transpose(1, 2).contiguous().transpose(1, 2),
               lse, delta, ranges, True)
        with pytest.raises(ValueError, match="lse"):
            fn(q, k, v, seg, do, lse.bfloat16(), delta, ranges, True)
        with pytest.raises(ValueError, match="delta"):
            fn(q, k, v, seg, do, lse, delta[:, :, :-1], ranges, True)


def _misaligned(t):
    """A contiguous copy of ``t`` whose data starts one element past a
    16-byte boundary."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


# (rows, h, x type, w type): one row, decode's [8, 4096], a ragged row
# count with the promote case, h no multiple of 8 (scalar accesses), h no
# multiple of 128, f32 x with a bf16 weight
RMS_CASES = [(1, 2048, "bfloat16", "bfloat16"),
             (8, 4096, "bfloat16", "bfloat16"),
             (4095, 2048, "bfloat16", "float32"),
             (37, 200, "float32", "float32"),
             (3, 136, "bfloat16", "bfloat16"),
             (5, 64, "float32", "bfloat16")]


@pytest.mark.parametrize("n,h,xdt,wdt", RMS_CASES)
def test_rms_norm_kernels_match_plain(gen, n, h, xdt, wdt):
    x = torch.randn((n, h), generator=gen, device="cuda").to(
        getattr(torch, xdt))
    w = (1 + 0.1 * torch.randn(h, generator=gen, device="cuda")).to(
        getattr(torch, wdt))
    do = torch.randn((n, h), generator=gen, device="cuda").to(
        torch.promote_types(x.dtype, w.dtype))
    before = (rn.launches, rn.launches_bwd)
    out, rstd = rn._fwd(x, w, 1e-6)
    dx, dw = rn._bwd(x, w, rstd, do)
    torch.cuda.synchronize()
    assert (rn.launches, rn.launches_bwd) == (before[0] + 1, before[1] + 1)
    assert out.dtype == do.dtype and dx.dtype == x.dtype
    assert dw.dtype == torch.float32
    want, want_rstd = rn.rms_norm_plain(x.float(), w.float(), 1e-6)
    want_dx, want_dw = rn.rms_norm_bwd_plain(x.float(), w.float(), want_rstd,
                                             do.float())
    torch.testing.assert_close(rstd, want_rstd, atol=1e-5, rtol=1e-5)
    for name, got, ref in (("out", out, want), ("dx", dx, want_dx),
                           ("dw", dw, want_dw)):
        torch.testing.assert_close(got.float(), ref, **TOL, msg=name)


@pytest.mark.parametrize("xdt,wdt", [("bfloat16", "bfloat16"),
                                     ("bfloat16", "float32"),
                                     ("float32", "bfloat16"),
                                     ("float32", "float32")])
@pytest.mark.parametrize("n", [1, 7, 4095])
@pytest.mark.parametrize("h", [64, 100, 136, 200, 2048, 4096, 8192])
def test_rms_norm_forward_instances_match_plain(gen, h, n, xdt, wdt):
    """K9a's register-held instances for each type pair: one vector a lane
    at h 64, 136 and 200 (8, 17 and 25 of a warp's lanes), four vectors a
    lane over two, four and eight warps a row at h 2048, 4096 and 8192;
    h 100 (no multiple of 8) takes the generic kernel's scalar accesses.
    Row counts under, at and far over a block pass."""
    x = torch.randn((n, h), generator=gen, device="cuda").to(
        getattr(torch, xdt))
    w = (1 + 0.1 * torch.randn(h, generator=gen, device="cuda")).to(
        getattr(torch, wdt))
    before = rn.launches
    out, rstd = rn._fwd(x, w, 1e-6)
    torch.cuda.synchronize()
    assert rn.launches == before + 1
    assert out.dtype == torch.promote_types(x.dtype, w.dtype)
    want, want_rstd = rn.rms_norm_plain(x.float(), w.float(), 1e-6)
    torch.testing.assert_close(rstd, want_rstd, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(out.float(), want, **TOL)


def test_rms_norm_kernels_take_misaligned_views_and_are_deterministic(gen):
    x = _randn(gen, 300, 256)
    w = _randn(gen, 256)
    do = _randn(gen, 300, 256)
    out, rstd = rn._fwd(x, w, 1e-6)
    runs = [rn._bwd(x, w, rstd, do) for _ in range(2)]
    out_m, rstd_m = rn._fwd(_misaligned(x), _misaligned(w), 1e-6)
    dx_m, dw_m = rn._bwd(_misaligned(x), _misaligned(w), rstd,
                         _misaligned(do))
    torch.cuda.synchronize()
    for name, a, b in (("dx", *(r[0] for r in runs)),
                       ("dw", *(r[1] for r in runs))):
        assert torch.equal(a, b), f"{name} differs between two runs"
    torch.testing.assert_close(out_m.float(), out.float(), **TOL)
    torch.testing.assert_close(dx_m.float(), runs[0][0].float(), **TOL)
    torch.testing.assert_close(dw_m, runs[0][1], **TOL)


def test_rms_norm_autograd_returns_each_input_type(gen):
    x = _randn(gen, 2, 9, 128).requires_grad_(True)
    w = torch.ones(128, device="cuda", requires_grad=True)
    wb = w.to(torch.bfloat16)
    before = (rn.launches, rn.launches_bwd)
    rn.rms_norm(x, wb).float().sum().backward()
    torch.cuda.synchronize()
    assert (rn.launches, rn.launches_bwd) == (before[0] + 1, before[1] + 1)
    assert x.grad.dtype == torch.bfloat16 and w.grad.dtype == torch.float32


def test_rms_norm_kernels_refuse_what_they_cannot_take(gen):
    x = _randn(gen, 4, 128)
    with pytest.raises(ValueError, match="want x"):
        rn._fwd(x, _randn(gen, 64), 1e-6)
    with pytest.raises(TypeError):
        rn._fwd(x.half(), x[0], 1e-6)
    with pytest.raises(ValueError, match="contiguous"):
        rn._fwd(x.t(), _randn(gen, 4), 1e-6)
    out, rstd = rn._fwd(x, x[0].contiguous(), 1e-6)
    with pytest.raises(ValueError, match="dout"):
        rn._bwd(x, x[0].contiguous(), rstd, x.float())
    with pytest.raises(ValueError, match="rstd"):
        rn._bwd(x, x[0].contiguous(), rstd[:-1], x)


@pytest.mark.parametrize("shape", [(1,), (7,), (8, 11008), (3, 5, 7),
                                   (4095, 136)])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_swiglu_kernels_match_plain(gen, shape, dtype):
    dt = getattr(torch, dtype)
    g, u, do = (2 * torch.randn(shape, generator=gen, device="cuda")
                for _ in range(3))
    g, u, do = g.to(dt), u.to(dt), do.to(dt)
    before = (sw.launches, sw.launches_bwd)
    out = sw._fwd(g, u)
    dg, du = sw._bwd(g, u, do)
    torch.cuda.synchronize()
    assert (sw.launches, sw.launches_bwd) == (before[0] + 1, before[1] + 1)
    want = sw.swiglu_plain(g.float(), u.float())
    want_dg, want_du = sw.swiglu_bwd_plain(g.float(), u.float(), do.float())
    tol = TOL if dtype == "bfloat16" else dict(atol=1e-5, rtol=1e-5)
    for name, got, ref in (("out", out, want), ("dg", dg, want_dg),
                           ("du", du, want_du)):
        assert got.dtype == dt, name
        torch.testing.assert_close(got.float(), ref, **tol, msg=name)


def test_swiglu_kernels_take_misaligned_views(gen):
    g, u, do = (_randn(gen, 33, 64) for _ in range(3))
    out = sw._fwd(g, u)
    dg, du = sw._bwd(g, u, do)
    out_m = sw._fwd(_misaligned(g), _misaligned(u))
    dg_m, du_m = sw._bwd(_misaligned(g), _misaligned(u), _misaligned(do))
    torch.cuda.synchronize()
    for a, b in ((out, out_m), (dg, dg_m), (du, du_m)):
        torch.testing.assert_close(a.float(), b.float(), **TOL)


def test_swiglu_kernels_refuse_what_they_cannot_take(gen):
    g = _randn(gen, 4, 8)
    with pytest.raises(TypeError):
        sw._fwd(g, g.float())
    with pytest.raises(ValueError, match="shape"):
        sw._fwd(g, g[:2].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        sw._bwd(g, g, _randn(gen, 8, 4).t())
    with pytest.raises(TypeError):
        sw._fwd(g.half(), g.half())


# (M, H, N, wl type): one row, the trainer's q shape cut to 300 rows,
# decode's [8, 4096] x [4096, 11008], ragged M and N with H no multiple of
# 128, N below one tile, a bf16 norm weight (the serving path)
RMM_CASES = [(1, 2048, 2048, "float32"),
             (300, 2048, 2048, "float32"),
             (8, 4096, 11008, "bfloat16"),
             (100, 48, 70, "float32"),
             (130, 272, 129, "bfloat16"),
             (65, 64, 8, "float32")]
# and across the kernel's 128 x 256 tiles and 64-deep stages: N = 1001 (W
# by plain loads: no tensor map takes an odd row stride) and 5504 (the
# trainer's gate / up, by TMA), M from one row to 32 row tiles, H from
# one ragged stage (16, 48) to 64 of them
RMM_CASES += [(m, (16, 48, 272, 4096)[i % 4], n, "float32")
              for i, (m, n) in enumerate((m, n) for m in (1, 8, 127, 129, 4096)
                                         for n in (1001, 5504))]


@pytest.mark.parametrize("M,H,N,wldt", RMM_CASES)
def test_rmsnorm_matmul_kernel_matches_plain(gen, M, H, N, wldt):
    x = _randn(gen, M, H)
    wl = (1 + 0.1 * torch.randn(H, generator=gen, device="cuda")).to(
        getattr(torch, wldt))
    w = _randn(gen, H, N) * H ** -0.5
    before = rmm.launches
    out = rmm._fwd(x, wl, w, 1e-6)
    torch.cuda.synchronize()
    assert rmm.launches == before + 1
    assert out.dtype == torch.bfloat16 and out.shape == (M, N)
    torch.testing.assert_close(out.float(), rmm.rmsnorm_matmul_plain(
        x, wl, w, 1e-6).float(), **TOL)


@pytest.mark.parametrize("N", [1001, 5504])
def test_rmsnorm_matmul_kernel_is_bit_identical_run_to_run(gen, N):
    x = _randn(gen, 300, 2048)
    wl = 1 + 0.1 * torch.randn(2048, generator=gen, device="cuda")
    w = _randn(gen, 2048, N) * 2048 ** -0.5
    a, b = rmm._fwd(x, wl, w, 1e-6), rmm._fwd(x, wl, w, 1e-6)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


def test_rmsnorm_matmul_autograd_runs_the_kernel_and_the_f32_backward(gen):
    x = _randn(gen, 2, 40, 256).requires_grad_(True)
    wl = torch.ones(256, device="cuda", requires_grad=True)
    w = (_randn(gen, 256, 96) * 0.05).requires_grad_(True)
    before = rmm.launches
    rmm.rmsnorm_matmul(x, wl, w).float().sum().backward()
    torch.cuda.synchronize()
    assert rmm.launches == before + 1
    assert (x.grad.dtype, wl.grad.dtype, w.grad.dtype) == (
        torch.bfloat16, torch.float32, torch.bfloat16)
    want = rmm._bwd(x.detach(), wl.detach(), w.detach(),
                    torch.ones((2, 40, 96), device="cuda",
                               dtype=torch.bfloat16), 1e-6)
    for name, got, ref in zip(("dx", "dwl", "dw"), (x, wl, w), want):
        assert torch.equal(got.grad, ref), name


def test_rmsnorm_matmul_kernel_refuses_what_it_cannot_take(gen):
    x = _randn(gen, 4, 64)
    wl = torch.ones(64, device="cuda")
    w = _randn(gen, 64, 32)
    with pytest.raises(ValueError, match="multiple of 16"):
        rmm._fwd(x[:, :40].contiguous(), wl[:40], w[:40].contiguous(), 1e-6)
    with pytest.raises(TypeError):
        rmm._fwd(x.float(), wl, w, 1e-6)
    with pytest.raises(TypeError):
        rmm._fwd(x, wl, w.float(), 1e-6)
    with pytest.raises(ValueError, match="chain"):
        rmm._fwd(x, wl, w[:32].contiguous(), 1e-6)
    with pytest.raises(ValueError, match="boundary"):
        rmm._fwd(x, _misaligned(wl), w, 1e-6)
