"""Rows packed with documents, and one packed pretraining step.

:func:`pack_documents` makes the segment ids that ``forward_loss(params,
tokens, segment_ids)`` takes; :func:`packed_step` is one step as a JAX user
of ``segment_ids`` writes it (``value_and_grad`` of the packed
``forward_loss``, then ``adamw_update``), since ``make_train_step`` takes no
segment ids in JAX or here.  ``chip_smoke.py`` and
``tools/profile_torch_train.py --packed`` drive the packed path with both.

The document lengths are a smoke placeholder: log-uniform on
[``PACK_MIN``, ``PACK_MAX``] tokens, with no published corpus statistic
behind the range or the shape.  They put short and long documents in one
row, so every tile-range case of the segmented kernels runs, but timings
taken on this mix say nothing about a real corpus's.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .llama_pretrain import _leaves, _map_params, adamw_update

__all__ = ["PACK_MIN", "PACK_MAX", "pack_documents", "segment_runs",
           "documents", "packed_step"]

# the range of document lengths, in tokens (an unsourced placeholder)
PACK_MIN, PACK_MAX = 32, 2049


def pack_documents(seed, batch, length):
    """Segment ids [batch, length] int32 of rows packed with documents
    whose lengths are drawn log-uniform on [PACK_MIN, PACK_MAX] by a numpy
    generator seeded with ``seed``.  Each row is filled greedily and a
    document that would overflow it is cut at the row's end; the last row
    takes only documents that leave room after them and ends in a -1
    padding run.  Each row numbers its documents 0, 1, ..."""
    rng = np.random.default_rng(seed)
    seg = np.full((batch, length), -1, np.int32)
    lo, hi = math.log(PACK_MIN), math.log(PACK_MAX)
    for row in range(batch):
        at = doc = 0
        while at < length:
            n = int(math.exp(rng.uniform(lo, hi)))
            if row == batch - 1 and at + n >= length:
                if length - at <= PACK_MIN:
                    break                  # no document fits: pad the rest
                continue
            seg[row, at:at + n] = doc
            at += n
            doc += 1
    return seg


def segment_runs(seg_np):
    """Lengths of the runs of equal ids in each row of ``seg_np``."""
    runs = []
    for row in seg_np:
        edges = np.flatnonzero(np.r_[1, np.diff(row) != 0, 1])
        runs.extend(np.diff(edges).tolist())
    return runs


def documents(seg_np):
    """The number of documents (runs of ids >= 0) in ``seg_np``."""
    return int(sum(len(np.unique(row[row >= 0])) for row in seg_np))


def packed_step(fwd, tokens, seg):
    """``fwd``: a packed ``forward_loss``.  -> step(params, state) ->
    (params, state, loss): the gradients of ``fwd(params, tokens, seg)``,
    then one AdamW update of params and moments in place."""

    def step(params, state):
        live = _map_params(lambda p: p.detach().requires_grad_(True), params)
        loss = fwd(live, tokens, seg)
        grads = iter(torch.autograd.grad(loss, _leaves(live)))
        params, state = adamw_update(
            params, _map_params(lambda _: next(grads), params), state)
        return params, state, loss.detach()

    return step
