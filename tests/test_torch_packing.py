"""The packer and the packed training step that chip_smoke.py and the
training profile tool drive (``paddle_tpu_torch/models/packing.py``), on the
CPU: the segment ids it makes keep the layout ``forward_loss`` and the
segmented kernels require (contiguous runs, ids from 0 in each row, -1
padding only at the last row's end), are fixed by the seed, and train under
``packed_step``.  JAX has no packer; the packed step's parity with JAX is
``test_packed_adamw_step_matches_jax`` in ``test_torch_train_slice.py``."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from paddle_tpu_torch.models import llama_pretrain as tlp  # noqa: E402
from paddle_tpu_torch.models import packing  # noqa: E402


@pytest.mark.parametrize("seed,batch,length", [(0, 8, 2049), (1, 2, 2049),
                                               (2, 3, 4097), (3, 1, 300)])
def test_packed_rows_keep_the_segment_layout(seed, batch, length):
    seg = packing.pack_documents(seed, batch, length)
    assert seg.shape == (batch, length) and seg.dtype == np.int32
    np.testing.assert_array_equal(
        seg, packing.pack_documents(seed, batch, length))
    assert not np.array_equal(seg, packing.pack_documents(seed + 10, batch,
                                                          length))
    runs = 0
    for i, row in enumerate(seg):
        ids = row[row >= 0]
        # ids 0, 1, ... in contiguous runs; padding only after them
        assert ids[0] == 0 and set(np.diff(ids).tolist()) <= {0, 1}
        assert (row[len(ids):] == -1).all()
        lens = np.bincount(ids)
        runs += len(lens) + (len(ids) < length)
        # each document but one cut at the row's end is a drawn length
        assert (lens[:-1] >= packing.PACK_MIN).all()
        assert (lens <= packing.PACK_MAX).all()
        if i < batch - 1:
            assert len(ids) == length       # full rows: no padding
    last = seg[-1]
    pad = int((last < 0).sum())
    assert 0 < pad <= packing.PACK_MIN or len(last[last >= 0]) == 0
    if pad < length:                   # the last row's documents are whole
        assert np.bincount(last[last >= 0]).min() >= packing.PACK_MIN
    assert packing.documents(seg) == sum(
        len(np.unique(r[r >= 0])) for r in seg)
    assert sum(packing.segment_runs(seg)) == batch * length
    assert len(packing.segment_runs(seg)) == runs


def test_segment_runs_and_documents_count_runs_and_ids():
    seg = np.array([[0, 0, 1, 1, 1, -1], [0, 1, 2, 2, 2, 2]], np.int32)
    assert packing.segment_runs(seg) == [2, 3, 1, 1, 1, 4]
    assert packing.documents(seg) == 5


def test_packed_step_trains_on_packed_rows(monkeypatch):
    """Three packed_step steps on one batch of packer rows at a tiny size:
    finite losses that fall, the step count carried, params moved."""
    monkeypatch.setattr(packing, "PACK_MIN", 3)
    monkeypatch.setattr(packing, "PACK_MAX", 12)
    cfg = tlp.LlamaPretrainConfig(
        vocab_size=64, hidden_size=32, intermediate_size=64,
        num_hidden_layers=2, num_attention_heads=4, max_seq_len=32,
        dtype=torch.float32, loss_chunks=1)
    params = tlp.init_params(cfg, 0, "cpu", dtype=cfg.param_dtype)
    before = params["lm_head"].clone()
    state = tlp.init_adamw_state(params, device="cpu")
    seg = torch.from_numpy(packing.pack_documents(0, 3, 33))
    tokens = torch.from_numpy(
        np.random.default_rng(0).integers(0, 64, (3, 33)))
    step = packing.packed_step(tlp.make_forward(cfg), tokens, seg)
    losses = []
    for _ in range(3):
        params, state, loss = step(params, state)
        losses.append(float(loss))
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    assert state["t"] == 3
    assert not torch.equal(params["lm_head"], before)
