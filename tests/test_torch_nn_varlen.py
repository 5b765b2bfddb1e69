"""The varlen flash-attention entry points of nn.functional on the port,
held against paddle_tpu's on the CPU.

``F.flash_attn_unpadded`` runs JAX's segment-aware Pallas program in
interpret mode (``ops/pallas/flash_varlen.py``), so it is held against the
port's in one tiny case (152 packed tokens, 2 heads of 64, causal): the
outputs and the gradients of ``sum(out * g)`` by q, k and v within
``KTOL`` (2e-5 relative and absolute: an online softmax against the
port's dense f32 math on the CPU).  The other cases run on the same
packing against JAX's ``xla_segmented_sdpa`` (under ``jax.jit``, with its
vjp), within ``TOL`` (1e-5): GQA (4 q heads over 2 kv heads, K and V
never repeated in the port), a caller's ``scale``, packed lengths below and
above one 128-row block (the -1 padding JAX adds, sliced off),
``flash_attn_varlen_qkvpacked``, and padding rows whose gradients come
back zero.  ``cu_seqlens_q != cu_seqlens_k`` and ``dropout > 0`` take
JAX's per-sequence loop; the first is held against a per-sequence dense
reference, the second by its law (kept elements equal the attention over
``1 - p``).  ``F.varlen_route`` is held on stand-ins of CUDA tensors:
bf16 at head_dim 64 / 128 takes the kernels, f32 or another head size the
plain route, which runs a document at a time (held against the oracle
with the route forced on the CPU).
"""

import math
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import paddle_tpu as jp  # noqa: E402
from paddle_tpu.ops.pallas.flash_varlen import (  # noqa: E402
    segment_ids_from_cu_seqlens, xla_segmented_sdpa)
import paddle_tpu_torch as tp  # noqa: E402
import paddle_tpu_torch.nn.functional as TF  # noqa: E402
from paddle_tpu_torch.framework import place as tplace  # noqa: E402
from paddle_tpu_torch.nn.functional import extras as tx  # noqa: E402
from paddle_tpu_torch.ops import flash_varlen as fv  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
KTOL = dict(rtol=2e-5, atol=2e-5)


@pytest.fixture(scope="module", autouse=True)
def _cpu():
    prev = tplace._current_place
    tp.set_device("cpu")
    yield
    tplace._current_place = prev


def _r(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _np(t):
    return np.asarray(t.numpy())


def _cot(shape):
    return np.random.RandomState(7).randn(*shape).astype(np.float32)


def _port(fn, arrays):
    ts = [tp.to_tensor(a, stop_gradient=False) for a in arrays]
    out = fn(*ts)
    (out * tp.to_tensor(_cot(out.shape))).sum().backward()
    return _np(out), [_np(t.grad) for t in ts]


def _oracle(cu, causal, scale=None):
    """xla_segmented_sdpa over the packed rows (no padding), with a
    caller's scale as JAX's entry points apply it -> fn(q, k, v)."""
    cu = np.asarray(cu)
    seg = segment_ids_from_cu_seqlens(jnp.asarray(cu, jnp.int32),
                                      int(cu[-1]))[None]

    def fn(q, k, v):
        if scale is not None:
            q = q * (scale * math.sqrt(q.shape[-1]))
        return xla_segmented_sdpa(q[None], k[None], v[None], seg, causal)[0]

    return fn


def _jax_ref(fn, arrays):
    def loss(*a):
        out = fn(*a)
        return jnp.sum(out * _cot(out.shape)), out

    (_, out), grads = jax.jit(jax.value_and_grad(
        loss, argnums=tuple(range(len(arrays))), has_aux=True))(*arrays)
    return np.asarray(out), [np.asarray(g) for g in grads]


def _close(port, ref, tol):
    np.testing.assert_allclose(port[0], ref[0], **tol)
    for a, b in zip(port[1], ref[1]):
        np.testing.assert_allclose(a, b, **tol)


def test_unpadded_matches_jax_pallas_program():
    cu = np.array([0, 40, 41, 100, 152])
    q, k, v = (_r(152, 2, 64, seed=s) for s in range(3))
    tout = _port(lambda a, b, c: TF.flash_attn_unpadded(
        a, b, c, cu, cu, causal=True), [q, k, v])
    jts = [jp.to_tensor(a, stop_gradient=False) for a in (q, k, v)]
    jout = jp.nn.functional.flash_attn_unpadded(*jts, jp.to_tensor(cu),
                                                jp.to_tensor(cu),
                                                causal=True)
    (jout * jp.to_tensor(_cot(jout.shape))).sum().backward()
    _close(tout, (_np(jout), [_np(t.grad) for t in jts]), KTOL)


VARLEN_CASES = {
    # name: (cu_seqlens, q heads, kv heads, causal, scale)
    "gqa_causal_over_a_block": ([0, 100, 130, 131, 300], 4, 2, True, None),
    "short_padded_to_128": ([0, 30, 31, 90], 2, 2, False, None),
    "scale": ([0, 70, 200], 2, 1, True, 0.3),
    "exact_block": ([0, 64, 128], 2, 2, True, None),
}


@pytest.mark.parametrize("name", sorted(VARLEN_CASES))
def test_unpadded_matches_the_xla_oracle(name):
    cu, n, nkv, causal, scale = VARLEN_CASES[name]
    T = cu[-1]
    q, k, v = _r(T, n, 64), _r(T, nkv, 64, seed=1), _r(T, nkv, 64, seed=2)
    tout = _port(lambda a, b, c: TF.flash_attn_unpadded(
        a, b, c, np.array(cu), np.array(cu), scale=scale, causal=causal),
        [q, k, v])
    _close(tout, _jax_ref(_oracle(cu, causal, scale), [q, k, v]), TOL)


def test_varlen_qkvpacked_matches_the_xla_oracle():
    cu = np.array([0, 50, 51, 170])
    qkv = _r(170, 3, 2, 64)
    tout = _port(lambda p: TF.flash_attn_varlen_qkvpacked(
        p, cu, cu, 119, 119, causal=True), [qkv])
    ref = _jax_ref(lambda p: _oracle(cu, True)(p[:, 0], p[:, 1], p[:, 2]),
                   [qkv])
    _close(tout, ref, TOL)
    with pytest.raises(ValueError, match="cu_seqlens_q == cu_seqlens_k"):
        TF.flash_attn_varlen_qkvpacked(tp.to_tensor(qkv), cu, cu + 0 * cu +
                                       np.array([0, 1, 1, 0]), 1, 1)


PLAIN_ROUTE_CALLS = {
    "unpadded": lambda q, k, v, cu: TF.flash_attn_unpadded(
        q, k, v, cu, cu, scale=0.3, causal=True),
    "qkvpacked": lambda q, k, v, cu: TF.flash_attn_varlen_qkvpacked(
        tp.stack([q, k, v], axis=1), cu, cu, 169, 169, scale=0.3,
        causal=True),
}


@pytest.mark.parametrize("name", sorted(PLAIN_ROUTE_CALLS))
def test_plain_route_runs_a_document_at_a_time(name, monkeypatch):
    """The route the card takes for inputs its kernels do not take (f32,
    other head sizes) runs each document alone: no attention sees more
    rows than the longest document (a dense mask over the whole stream
    grows with T squared), and the values and gradients are JAX's."""
    seen = []
    real = fv.segmented_sdpa_plain
    monkeypatch.setattr(fv, "segmented_sdpa_plain", lambda q, *a: (
        seen.append(q.shape[1]), real(q, *a))[1])
    monkeypatch.setattr(tx, "varlen_route", lambda q, dtype=None: "plain")
    cu = np.array([0, 100, 130, 131, 300])
    q, k, v = (_r(300, 2, 64, seed=s) for s in range(3))
    tout = _port(lambda a, b, c: PLAIN_ROUTE_CALLS[name](a, b, c, cu),
                 [q, k, v])
    _close(tout, _jax_ref(_oracle(cu, True, 0.3), [q, k, v]), TOL)
    assert sorted(seen) == sorted(np.diff(cu).tolist())


def test_padding_rows_get_zero_gradients():
    cu = np.array([0, 90])
    total, pad, seg = tx._packed_segments(cu, torch.device("cpu"))
    assert (total, pad) == (90, 38) and (seg[0, 90:] == -1).all()
    qkv = [torch.tensor(_r(1, 128, 2, 64, seed=s), requires_grad=True)
           for s in range(3)]
    out = fv.flash_attention_segmented(*qkv, seg, causal=True)
    dout = torch.tensor(_cot(out.shape))
    dout[:, total:] = 0              # the sliced-off rows carry no cotangent
    grads = torch.autograd.grad(out, qkv, dout)
    for g in grads:
        assert (g[:, total:] == 0).all()
        assert (g[:, :total] != 0).any()


def test_mismatched_cu_seqlens_take_the_dense_loop():
    cu_q, cu_k = np.array([0, 3, 8]), np.array([0, 6, 9])
    q, k, v = _r(8, 2, 64), _r(9, 2, 64, seed=1), _r(9, 2, 64, seed=2)

    def ref(qq, kk, vv):
        outs = []
        for i in range(2):
            a = qq[cu_q[i]:cu_q[i + 1]] / math.sqrt(64)
            b = kk[cu_k[i]:cu_k[i + 1]]
            c = vv[cu_k[i]:cu_k[i + 1]]
            p = jax.nn.softmax(jnp.einsum("qhd,khd->hqk", a, b), -1)
            outs.append(jnp.einsum("hqk,khd->qhd", p, c))
        return jnp.concatenate(outs)

    tout = _port(lambda a, b, c: TF.flash_attn_unpadded(a, b, c, cu_q, cu_k),
                 [q, k, v])
    _close(tout, _jax_ref(ref, [q, k, v]), TOL)


def test_dropout_takes_the_dense_loop_by_its_law(monkeypatch):
    calls = []
    real = tx.scaled_dot_product_attention
    monkeypatch.setattr(tx, "scaled_dot_product_attention",
                        lambda *a, **k: calls.append(k) or real(*a, **k))
    cu = np.array([0, 200, 400])
    q, k, v = (tp.to_tensor(_r(400, 2, 64, seed=s)) for s in range(3))
    tp.seed(1)
    out = _np(TF.flash_attn_unpadded(q, k, v, cu, cu, dropout=0.25))
    assert len(calls) == 2 and calls[0]["dropout_p"] == 0.25
    full = _np(TF.flash_attn_unpadded(q, k, v, cu, cu))
    kept = out != 0
    assert abs(1 - kept.mean() - 0.25) < 0.01
    np.testing.assert_allclose(out[kept], full[kept] / 0.75, **TOL)


def test_varlen_route_decides_by_type_and_head_size():
    def cuda(dtype, d):
        return SimpleNamespace(device=SimpleNamespace(type="cuda"),
                               dtype=dtype, shape=(10, 4, d))

    assert TF.varlen_route(cuda(torch.bfloat16, 128)) == "kernel"
    assert TF.varlen_route(cuda(torch.bfloat16, 64)) == "kernel"
    assert TF.varlen_route(cuda(torch.float32, 128)) == "plain"
    assert TF.varlen_route(cuda(torch.bfloat16, 96)) == "plain"
    # the type the op will run in decides, not the input's
    assert TF.varlen_route(cuda(torch.float32, 128),
                           torch.bfloat16) == "kernel"
    cpu = torch.zeros(10, 4, 32)
    assert TF.varlen_route(cpu) == "kernel"      # the plain version there
