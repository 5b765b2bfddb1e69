"""``chip_smoke.py``'s work counts of the flash-attention kernels give the
bounds PERF.md's table states at the trainer's shape ([8, 2048, 16, 128]
bf16, causal): K6a 0.1390 ms, K6b 0.2086, K6c 0.2781, each bound by the
bf16 tensor-core rate.  Pure arithmetic on shapes: no card, no kernel.
"""

import importlib.util
from pathlib import Path

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
