"""``chip_smoke.py``'s work counts give the bounds PERF.md's table states:
the flash-attention kernels at the trainer's shape ([8, 2048, 16, 128]
bf16, causal): K6a 0.1390 ms, K6b 0.2086, K6c 0.2781, each bound by the
bf16 tensor-core rate; K7a 0.1008 ms and K7b 0.1208 at the packed
trainer's seed-0 rows, bound by the bytes; K2 at chip_smoke's packed stream
(T 2048, 32 heads of 128, nkv 32) 0.0201 ms, bound by the bytes; K3 at a
2,048-row prefill
wave of w_gate (2048, 4096, 11008) 0.1867 ms, bound by the operations, and
at decode w_gate (8, 4096, 11008) 0.0135 and wq (8, 4096, 4096) 0.0051,
bound by the bytes; K9a at the trainer's rows [16384, 2048] bf16 0.0401 ms
and the serving wave's [2048, 4096] 0.0100, K9b at the trainer's 0.0601,
bound by the bytes.  Pure arithmetic on shapes: no card, no kernel.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def cs():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _work(cs, name, shape):
    if name == "K6a":
        return cs.k6a_work(shape)
    dq, dkv = cs.k6_bwd_work(shape)
    return dq if name == "K6b" else dkv


@pytest.mark.parametrize("name,bound_ms", [("K6a", 0.1390), ("K6b", 0.2086),
                                           ("K6c", 0.2781)])
def test_work_counts_give_perf_md_bounds_at_the_trainer_shape(cs, name,
                                                              bound_ms):
    ms, by = cs.bound(*_work(cs, name, cs.TRAIN_SHAPES[0]))
    assert by == "operations"
    assert round(ms, 4) == bound_ms


@pytest.mark.parametrize("shape_index", [0, 1, 2])
def test_backward_work_counts_products_and_tensors(cs, shape_index):
    """K6b: 3 products of 2 d FLOPs a visible causal pair, five [B, S, H,
    d] bf16 tensors and two [B, H, S] f32 rows; K6c: 4 products, six
    tensors and the same rows; K6a: 2 products, four tensors and lse."""
    B, S, H, d = shape = cs.TRAIN_SHAPES[shape_index]
    pairs = B * H * S * (S + 1) // 2
    io, stat = B * S * H * d * 2, B * H * S * 4
    assert cs.k6a_work(shape) == (4 * io + stat, pairs * 2 * 2 * d)
    assert cs.k6_bwd_work(shape) == ((5 * io + 2 * stat, pairs * 3 * 2 * d),
                                     (6 * io + 2 * stat, pairs * 4 * 2 * d))


@pytest.mark.parametrize("index,bound_ms", [(0, 0.1008), (1, 0.1208)],
                         ids=["K7a", "K7b"])
def test_k7_work_gives_perf_md_bounds_at_the_trainer_rows(cs, index,
                                                          bound_ms):
    name, B, T, n, nkv, d, causal, layout = cs.K7_CASES[0]
    assert name == "trainer"
    seg = cs.k7_segments(layout, B, T, 0)
    ms, by = cs.bound(*cs.k7_work(seg, n, nkv, d, causal)[index])
    assert by == "bytes"
    assert round(ms, 4) == bound_ms


@pytest.mark.parametrize("causal", [True, False])
def test_k7_work_counts_visible_pairs_and_tensors(cs, causal):
    """Per visible pair and q head K7a counts 3 products of 2 d FLOPs, K7b
    4; K7a moves q, dout, dq at n heads and k, v at nkv, K7b q, dout at n
    and k, v, dk, dv at nkv, both the lse and delta rows and the ids."""
    seg = np.array([[0, 0, 0, 1, 2, 2], [5, 5, 5, 5, -1, -1]], np.int32)
    n, nkv, d = 4, 2, 8
    pairs = (6 + 1 + 3 + 10 + 3) if causal else (9 + 1 + 4 + 16 + 4)
    io_q, io_k = 2 * 6 * n * d * 2, 2 * 6 * nkv * d * 2
    rest = 2 * 2 * n * 6 * 4 + 2 * 6 * 4
    assert cs.k7_work(seg, n, nkv, d, causal) == (
        (3 * io_q + 2 * io_k + rest, pairs * n * 6 * d),
        (2 * io_q + 4 * io_k + rest, pairs * n * 8 * d))


def test_k7_work_on_one_document_a_row_counts_k6b_and_k6c_operations(cs):
    name, B, T, n, nkv, d, causal, layout = cs.K7_CASES[-1]
    assert name == "onedoc" and causal and n == nkv
    seg = cs.k7_segments(layout, B, T, 0)
    k7 = cs.k7_work(seg, n, nkv, d, causal)
    k6 = cs.k6_bwd_work((B, T, n, d))
    assert [w[1] for w in k7] == [w[1] for w in k6]


def test_k2_work_gives_perf_md_bound_at_chip_smoke_shape(cs):
    seg, runs = cs.k2_segments()
    assert sum(runs) == cs.K2_T == len(seg)
    ms, by = cs.bound(*cs.k2_work(cs.K2_T, 32, 32, 128, runs))
    assert by == "bytes"
    assert round(ms, 4) == 0.0201


def test_k2_work_counts_visible_pairs_and_tensors(cs):
    """4 d FLOPs a visible pair and q head (causal within each run); q, out
    at n heads, k, v at nkv, the lse row of each q head and the segment
    ids."""
    T, n, nkv, d, runs = 10, 4, 2, 8, [3, 1, 6]
    io = (2 * T * n * d + 2 * T * nkv * d) * 2 + n * T * 4 + T * 4
    assert cs.k2_work(T, n, nkv, d, runs) == (io, (6 + 1 + 21) * n * 4 * d)


@pytest.mark.parametrize("rows", [64, 128])
def test_ranges_work_counts_ids_read_and_ranges_written(cs, rows):
    """The range kernel reads each id once and writes kmin and kmax of each
    tile of the padded stream once; no operation is counted, so its bound
    is the bytes'."""
    B, T = 2, 300
    tiles = -(-T // rows)
    assert cs.ranges_work(B, T, rows) == (B * T * 4 + 2 * B * tiles * 4, 0)
    assert cs.bound(*cs.ranges_work(B, T, rows))[1] == "bytes"


@pytest.mark.parametrize("shape,bound_ms,by", [
    ((2048, 4096, 11008), 0.1867, "operations"),
    ((8, 4096, 11008), 0.0135, "bytes"),
    ((8, 4096, 4096), 0.0051, "bytes")])
def test_k3_work_gives_perf_md_bounds(cs, shape, bound_ms, by):
    assert shape in cs.K3_SHAPES
    ms, got = cs.bound(*cs.k3_work(*shape))
    assert got == by
    assert round(ms, 4) == bound_ms


@pytest.mark.parametrize("name,n,h,index,bound_ms", [
    ("trainer", 16384, 2048, 0, 0.0401), ("wave", 2048, 4096, 0, 0.0100),
    ("trainer", 16384, 2048, 1, 0.0601)], ids=["K9a-trainer", "K9a-wave",
                                             "K9b-trainer"])
def test_k9_work_gives_perf_md_bounds(cs, name, n, h, index, bound_ms):
    assert (name, n, h, "bfloat16") in cs.K9_CASES and name in cs.K9_TIMED
    ms, by = cs.bound(*cs.k9_work(n, h, 2, 2, 2)[index], cs.PEAK_F32_FLOPS)
    assert by == "bytes"
    assert round(ms, 4) == bound_ms


def test_k9_work_counts_each_tensor_once(cs):
    """K9a: x read and out written (promote(x, w) bytes), w read, the f32
    rstd row written; K9b: x and dout read, dx written, w, rstd and one f32
    dw row."""
    n, h = 3, 16
    assert cs.k9_work(n, h, 2, 4, 4) == (
        (n * h * (2 + 4) + h * 4 + n * 4, 4 * n * h),
        (n * h * (2 * 2 + 4) + h * (4 + 4) + n * 4, 9 * n * h))
