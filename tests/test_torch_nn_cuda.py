"""The nn slice on a CUDA card.

* ``F.varlen_route``'s choice on real CUDA tensors: bf16 at head_dim 64
  and 128 takes the kernels, f32 or another head size the plain route, and
  the op then launches exactly what the route says (nothing for the plain
  route);
* the plain route's memory over a long f32 stream grows with its
  documents' lengths, not with the stream's;
* one ``F.flash_attn_unpadded`` forward and backward launches K2, the
  range kernel, K7a and K7b once each (the counters), and its output and
  gradients agree with the plain route's within the K2 / K7 tolerance;
* ``return_mask`` indices of the max pools and a transposed convolution
  on the card against the same calls on the CPU;
* the nn families of ``op_sweep.nn_cases`` at a small size on the card
  within their bounds of the CPU's.

Every test needs a card and skips without one.  The card machine has no
JAX, so run this file there without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_nn_cuda.py -q
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import paddle_tpu_torch as paddle  # noqa: E402
from paddle_tpu_torch.framework import place as tplace  # noqa: E402
from paddle_tpu_torch.testing import op_sweep as ow  # noqa: E402

pytestmark = pytest.mark.cuda

F = paddle.nn.functional
TOL = dict(atol=2e-2, rtol=2e-2)    # one bf16 rounding + another sum order
SMALL = dict(rows=256, vocab=1000, width=64, emb=32, batch=2, ch=32, hw=16,
             stem_ch=8, frames=60, ctc_batch=4, chars=8, seq=128, heads=2)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    prev = tplace._current_place
    paddle.set_device("gpu")
    yield
    tplace._current_place = prev


class _cpu_place:
    def __enter__(self):
        self.prev = tplace._current_place
        paddle.set_device("cpu")

    def __exit__(self, *exc):
        tplace._current_place = self.prev


def _counts():
    from paddle_tpu_torch.ops import flash_varlen as fv
    return (fv.launches, fv.launches_ranges, fv.launches_bwd_dq,
            fv.launches_bwd_dkv)


def _qkv(T, n, nkv, d, dtype, seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn((T, h, d), generator=g, device="cuda").to(dtype)
            for h in (n, nkv, nkv)]


CU = np.array([0, 100, 101, 400, 517])


@pytest.mark.parametrize("dtype, d, route", [
    (torch.bfloat16, 128, "kernel"), (torch.bfloat16, 64, "kernel"),
    (torch.float32, 128, "plain"), (torch.bfloat16, 96, "plain"),
    (torch.float16, 64, "plain")])
def test_varlen_route_and_what_it_launches(card, dtype, d, route):
    q, k, v = _qkv(517, 4, 2, d, dtype)
    assert F.varlen_route(q) == route
    before = _counts()
    out = F.flash_attn_unpadded(paddle.to_tensor(q), paddle.to_tensor(k),
                                paddle.to_tensor(v), CU, CU, causal=True)
    torch.cuda.synchronize()
    launched = [a - b for a, b in zip(_counts(), before)]
    assert launched == ([1, 1, 0, 0] if route == "kernel" else [0] * 4)
    assert out.shape == [517, 4, d] and out.dtype == paddle.to_tensor(
        q).dtype


def test_unpadded_forward_backward_launches_and_matches_plain(card):
    from paddle_tpu_torch.ops import flash_varlen as fv
    q, k, v = _qkv(517, 8, 2, 128, torch.bfloat16, seed=1)
    cot = torch.randn((517, 8, 128), device="cuda").to(torch.bfloat16)
    before = _counts()
    ts = [paddle.to_tensor(a, stop_gradient=False) for a in (q, k, v)]
    out = F.flash_attn_unpadded(*ts, CU, CU, causal=True)
    (out * paddle.to_tensor(cot)).sum().backward()
    torch.cuda.synchronize()
    assert [a - b for a, b in zip(_counts(), before)] == [1, 1, 1, 1]
    leaves = [a.clone().requires_grad_(True) for a in (q, k, v)]
    ref = fv.segmented_sdpa_docs(*leaves, CU, True)
    grads = torch.autograd.grad(ref, leaves, cot)
    torch.testing.assert_close(out._data.float(), ref.float(), **TOL)
    for t, g in zip(ts, grads):
        torch.testing.assert_close(t.grad._data.float(), g.float(), **TOL)


def test_plain_route_memory_grows_with_the_documents_not_the_stream(card):
    """f32 over 8,192 packed rows of 32 heads in 16 documents of 512: the
    plain route runs a document at a time, so forward and backward stay
    under 2 GiB of memory, where one dense [T, T] f32 score tensor alone
    is 8 GiB."""
    cu = np.arange(0, 8193, 512)
    q, k, v = _qkv(8192, 32, 8, 128, torch.float32, seed=2)
    assert F.varlen_route(q) == "plain"
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    ts = [paddle.to_tensor(a, stop_gradient=False) for a in (q, k, v)]
    out = F.flash_attn_unpadded(*ts, cu, cu, causal=True)
    out.sum().backward()
    torch.cuda.synchronize()
    assert torch.cuda.max_memory_allocated() - base < 2 * 2**30
    assert all(bool(torch.isfinite(t.grad._data).all()) for t in ts)


@pytest.mark.parametrize("nd, kw", [(2, dict(kernel_size=3, stride=2,
                                             padding=1)),
                                    (2, dict(kernel_size=2, stride=1,
                                             padding=1)),
                                    (1, dict(kernel_size=3, stride=2)),
                                    (3, dict(kernel_size=2, stride=2))])
def test_return_mask_indices_match_the_cpu(card, nd, kw):
    x = np.random.RandomState(nd).randn(2, 4, *([9] * nd)).astype(np.float32)
    fn = getattr(F, f"max_pool{nd}d")
    out, idx = fn(paddle.to_tensor(x), return_mask=True, **kw)
    with _cpu_place():
        cout, cidx = fn(paddle.to_tensor(x), return_mask=True, **kw)
    np.testing.assert_array_equal(out.numpy(), cout.numpy())
    np.testing.assert_array_equal(idx.numpy(), cidx.numpy())
    assert idx.dtype.name == "int32"


def test_transposed_conv_matches_the_cpu(card):
    rs = np.random.RandomState(0)
    x = rs.randn(2, 16, 14, 14).astype(np.float32)
    w = (rs.randn(16, 8, 2, 2) / 8).astype(np.float32)
    b = rs.randn(8).astype(np.float32)
    out = F.conv2d_transpose(paddle.to_tensor(x), paddle.to_tensor(w),
                             paddle.to_tensor(b), stride=2).numpy()
    with _cpu_place():
        ref = F.conv2d_transpose(paddle.to_tensor(x), paddle.to_tensor(w),
                                 paddle.to_tensor(b), stride=2).numpy()
    assert out.shape == (2, 8, 28, 28)
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("family", ["loss", "norm", "pad", "resample",
                                    "pool", "conv", "exact", "nn_misc",
                                    "recursion"])
def test_nn_family_on_the_card_matches_the_cpu(card, family):
    ins = ow.nn_inputs(seed=4, **SMALL)
    cases = [c for c in ow.nn_cases(SMALL) if c.family == family]
    res, raised = ow.sweep(paddle, ins, "cuda", case_list=cases)
    assert not raised, raised
    bad = {k: v for k, v in res.items() if not v[1] <= v[2]}
    assert not bad, bad


def test_dropout_laws_on_the_card(card):
    res = ow.nn_laws(paddle, "cuda")
    assert all(v[0] == 0 for v in res.values()), res
