"""The int8 matmul's decode-path plan (``ops/int8_matmul.py``:
``decode_tiles``, ``decode_splits``), as the kernel walks it: a block per
128-column tile, block of x's rows and split of K, split z taking the
64-deep K steps ``[z * per, min(steps, (z + 1) * per))`` with ``per =
ceil(steps / splits)``.  Every (tile, K step) is covered by exactly one
block, no block is empty, and the blocks fit one wave of two a SM unless
the tiles alone need more.  Pure arithmetic on shapes: no card, no kernel.
"""

import pytest

from paddle_tpu_torch.ops import int8_matmul as im

# (M, K, N): LLaMA-7B's decode projections at batch 8 (wq / wk / wv / wo,
# w_gate / w_up, w_down, lm_head), w_gate at batch 1 and 16, K shorter than
# one step, ragged N and K, and rows past WAVE_MIN_M (the path forced)
SHAPES = [(8, 4096, 4096), (8, 4096, 11008), (8, 11008, 4096),
          (8, 4096, 32000), (1, 4096, 11008), (16, 4096, 11008),
          (8, 48, 64), (5, 11008, 200), (9, 4096, 1000), (3, 80, 129),
          (128, 4096, 11008)]


def _blocks(M, N, K, sms):
    """(tile, split, first step, end step) of every block of the grid."""
    steps = -(-K // im.DECODE_BK)
    splits = im.decode_splits(M, N, K, sms)
    per = -(-steps // splits)
    return [(t, z, z * per, min(steps, (z + 1) * per))
            for t in range(im.decode_tiles(M, N)) for z in range(splits)]


@pytest.mark.parametrize("sms", [132, 114, 78, 8, 1])
@pytest.mark.parametrize("M,K,N", SHAPES)
def test_decode_plan_covers_every_tile_and_k_step_once(M, K, N, sms):
    steps = -(-K // im.DECODE_BK)
    blocks = _blocks(M, N, K, sms)
    splits = im.decode_splits(M, N, K, sms)
    assert 1 <= splits <= im.MAX_SPLITS
    seen = {}
    for t, z, k0, k1 in blocks:
        assert k0 < k1, f"block ({t}, {z}) has no K step"
        for k in range(k0, k1):
            seen[t, k] = seen.get((t, k), 0) + 1
    tiles = im.decode_tiles(M, N)
    assert seen == {(t, k): 1 for t in range(tiles) for k in range(steps)}
    assert len(blocks) <= max(2 * sms, tiles)


@pytest.mark.parametrize("M,K,N,splits", [
    (8, 4096, 4096, 8), (8, 4096, 11008, 3), (8, 11008, 4096, 8),
    (8, 4096, 32000, 1), (1, 4096, 11008, 3), (16, 4096, 11008, 3)])
def test_decode_plan_at_llama_7b_on_132_sms(M, K, N, splits):
    """The splits PERF.md states for the H100's 132 SMs."""
    assert im.decode_splits(M, N, K, 132) == splits


@pytest.mark.parametrize("M,tiles", [(1, 86), (8, 86), (9, 86), (16, 86),
                                     (17, 172), (128, 688)])
def test_decode_tiles_count_column_tiles_by_row_blocks(M, tiles):
    """8 rows of x a block up to 8 rows, 16 above: one block of rows up to
    WAVE_MIN_M, more only where a caller forces the path."""
    assert im.decode_tiles(M, 11008) == tiles
