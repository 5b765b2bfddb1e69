"""Long-tail nn layers (counterpart of ``paddle_tpu/nn/layer/extras.py``):
``PairwiseDistance``, ``Softmax2D``, ``Unflatten``, ``LayerDict``,
``ZeroPad1D`` / ``3D``, the pool layers (``AdaptiveMaxPool3D``,
``MaxUnPool*``, ``LPPool*``, ``FractionalMaxPool*``), the long-tail loss
layers, ``AdaptiveLogSoftmaxWithLoss``, ``BeamSearchDecoder`` and
``dynamic_decode``.

``dynamic_decode`` keeps JAX's search: each step extends every beam by
every token (a finished beam only by ``end_token``, at no cost), keeps the
``beam_size`` best of ``beam * V`` by their summed log-probabilities,
reorders the cell states by the kept beams' sources and stops when every
beam has finished or at ``max_step_num`` steps; the log-probabilities it
returns are JAX's.  It departs from JAX in the ids: JAX stacks each
step's top-k tokens in top-k order, so a row of its ids mixes tokens of
different beams once the search reorders them; here the ids are
backtraced through each step's source beam (``F.gather_tree``), so
``ids[b, k]`` is the token sequence that scored ``log_probs[b, k]``
(ROADMAP.md queue 3).  The search runs without autograd.
"""

from __future__ import annotations

import torch
import torch.nn.functional as TF

from ...ops.dispatch import apply, as_tensor
from ...tensor.manipulation import concat, reshape
from ...tensor.search import argmax
from ...tensor.tensor import wrap_array
from .. import functional as F
from .common import Linear
from .layers import Layer

__all__ = [
    "PairwiseDistance", "Softmax2D", "Unflatten", "LayerDict",
    "ZeroPad1D", "ZeroPad3D",
    "AdaptiveMaxPool3D", "MaxUnPool1D", "MaxUnPool2D", "MaxUnPool3D",
    "LPPool1D", "LPPool2D", "FractionalMaxPool2D", "FractionalMaxPool3D",
    "PoissonNLLLoss", "HSigmoidLoss", "MultiLabelSoftMarginLoss",
    "MultiMarginLoss", "TripletMarginWithDistanceLoss", "GaussianNLLLoss",
    "RNNTLoss", "AdaptiveLogSoftmaxWithLoss",
    "BeamSearchDecoder", "dynamic_decode",
]


# ---------------------------------------------------------------------------
# small wrappers
# ---------------------------------------------------------------------------
class PairwiseDistance(Layer):
    def __init__(self, p=2.0, epsilon=1e-6, keepdim=False, name=None):
        super().__init__()
        self.p, self.epsilon, self.keepdim = p, epsilon, keepdim

    def forward(self, x, y):
        return F.pairwise_distance(x, y, self.p, self.epsilon, self.keepdim)


class Softmax2D(Layer):
    """Softmax over the channel axis of [C, H, W] or [N, C, H, W] input."""

    def __init__(self, name=None):
        super().__init__()

    def forward(self, x):
        if x.ndim not in (3, 4):
            raise ValueError(
                f"Softmax2D requires a 3D or 4D tensor, got rank {x.ndim}")
        return F.softmax(x, axis=-3)


class Unflatten(Layer):
    def __init__(self, axis, shape, name=None):
        super().__init__()
        self.axis, self.shape = axis, tuple(shape)

    def forward(self, x):
        ax = self.axis % x.ndim
        return reshape(x, tuple(x.shape[:ax]) + self.shape +
                       tuple(x.shape[ax + 1:]))


class LayerDict(Layer):
    """An ordered dict of sublayers."""

    def __init__(self, sublayers=None):
        super().__init__()
        if sublayers is not None:
            self.update(sublayers)

    def __getitem__(self, key):
        return getattr(self, key)

    def __setitem__(self, key, layer):
        setattr(self, key, layer)

    def __delitem__(self, key):
        delattr(self, key)
        self._sub_layers.pop(key, None)

    def __len__(self):
        return len(self._sub_layers)

    def __iter__(self):
        return iter(self._sub_layers)

    def __contains__(self, key):
        return key in self._sub_layers

    def clear(self):
        for k in list(self._sub_layers):
            del self[k]

    def pop(self, key):
        layer = self[key]
        del self[key]
        return layer

    def keys(self):
        return self._sub_layers.keys()

    def values(self):
        return self._sub_layers.values()

    def items(self):
        return self._sub_layers.items()

    def update(self, sublayers):
        items = sublayers.items() if hasattr(sublayers, "items") \
            else sublayers
        for k, v in items:
            self[k] = v
        return self


class ZeroPad1D(Layer):
    def __init__(self, padding, data_format="NCL", name=None):
        super().__init__()
        p = padding if isinstance(padding, (list, tuple)) \
            else (padding, padding)
        self.padding = tuple(int(i) for i in p)

    def forward(self, x):
        return apply("zeropad1d", lambda a: TF.pad(a, list(self.padding)),
                     as_tensor(x))


class ZeroPad3D(Layer):
    def __init__(self, padding, data_format="NCDHW", name=None):
        super().__init__()
        p = (padding,) * 6 if isinstance(padding, int) else tuple(padding)
        self.padding = tuple(int(i) for i in p)   # l, r, t, b, front, back

    def forward(self, x):
        return apply("zeropad3d", lambda a: TF.pad(a, list(self.padding)),
                     as_tensor(x))


# ---------------------------------------------------------------------------
# pooling layers
# ---------------------------------------------------------------------------
class AdaptiveMaxPool3D(Layer):
    def __init__(self, output_size, return_mask=False, name=None):
        super().__init__()
        self.output_size, self.return_mask = output_size, return_mask

    def forward(self, x):
        return F.adaptive_max_pool3d(x, self.output_size, self.return_mask)


class _UnpoolBase(Layer):
    _fn = None

    def __init__(self, kernel_size, stride=None, padding=0,
                 data_format=None, output_size=None, name=None):
        super().__init__()
        self.kernel_size, self.stride = kernel_size, stride
        self.padding, self.output_size = padding, output_size

    def forward(self, x, indices):
        return getattr(F, self._fn)(x, indices, self.kernel_size,
                                    self.stride, self.padding,
                                    self.output_size)


class MaxUnPool1D(_UnpoolBase):
    _fn = "max_unpool1d"


class MaxUnPool2D(_UnpoolBase):
    _fn = "max_unpool2d"


class MaxUnPool3D(_UnpoolBase):
    _fn = "max_unpool3d"


class LPPool1D(Layer):
    def __init__(self, norm_type, kernel_size, stride=None, padding=0,
                 ceil_mode=False, data_format="NCL", name=None):
        super().__init__()
        self.args = (norm_type, kernel_size, stride, padding, ceil_mode)

    def forward(self, x):
        return F.lp_pool1d(x, *self.args)


class LPPool2D(Layer):
    def __init__(self, norm_type, kernel_size, stride=None, padding=0,
                 ceil_mode=False, data_format="NCHW", name=None):
        super().__init__()
        self.args = (norm_type, kernel_size, stride, padding, ceil_mode)

    def forward(self, x):
        return F.lp_pool2d(x, *self.args)


class FractionalMaxPool2D(Layer):
    def __init__(self, output_size, kernel_size=None, random_u=None,
                 return_mask=False, name=None):
        super().__init__()
        self.args = (output_size, kernel_size, random_u, return_mask)

    def forward(self, x):
        return F.fractional_max_pool2d(x, *self.args)


class FractionalMaxPool3D(Layer):
    def __init__(self, output_size, kernel_size=None, random_u=None,
                 return_mask=False, name=None):
        super().__init__()
        self.args = (output_size, kernel_size, random_u, return_mask)

    def forward(self, x):
        return F.fractional_max_pool3d(x, *self.args)


# ---------------------------------------------------------------------------
# loss layers
# ---------------------------------------------------------------------------
class PoissonNLLLoss(Layer):
    def __init__(self, log_input=True, full=False, epsilon=1e-8,
                 reduction="mean", name=None):
        super().__init__()
        self.args = (log_input, full, epsilon, reduction)

    def forward(self, input, label):
        return F.poisson_nll_loss(input, label, *self.args)


class HSigmoidLoss(Layer):
    """Weight ``[C - 1, feature_size]`` and bias ``[C - 1, 1]``, f32, as
    JAX's."""

    def __init__(self, feature_size, num_classes, weight_attr=None,
                 bias_attr=None, is_custom=False, is_sparse=False,
                 name=None):
        super().__init__()
        if is_custom:
            raise NotImplementedError("custom-tree hsigmoid not supported")
        self.num_classes = num_classes
        n_nodes = max(1, num_classes - 1)
        self.weight = self.create_parameter(
            [n_nodes, feature_size], attr=weight_attr, dtype="float32")
        self.bias = self.create_parameter(
            [n_nodes, 1], attr=bias_attr, dtype="float32", is_bias=True)

    def forward(self, input, label):
        return F.hsigmoid_loss(input, label, self.num_classes, self.weight,
                               self.bias)


class MultiLabelSoftMarginLoss(Layer):
    def __init__(self, weight=None, reduction="mean", name=None):
        super().__init__()
        self.weight, self.reduction = weight, reduction

    def forward(self, input, label):
        return F.multi_label_soft_margin_loss(input, label, self.weight,
                                              self.reduction)


class MultiMarginLoss(Layer):
    def __init__(self, p=1, margin=1.0, weight=None, reduction="mean",
                 name=None):
        super().__init__()
        self.args = (p, margin, weight, reduction)

    def forward(self, input, label):
        return F.multi_margin_loss(input, label, *self.args)


class TripletMarginWithDistanceLoss(Layer):
    def __init__(self, distance_function=None, margin=1.0, swap=False,
                 reduction="mean", name=None):
        super().__init__()
        self.args = (distance_function, margin, swap, reduction)

    def forward(self, input, positive, negative):
        return F.triplet_margin_with_distance_loss(input, positive,
                                                   negative, *self.args)


class GaussianNLLLoss(Layer):
    def __init__(self, full=False, epsilon=1e-6, reduction="mean",
                 name=None):
        super().__init__()
        self.args = (full, epsilon, reduction)

    def forward(self, input, label, variance):
        return F.gaussian_nll_loss(input, label, variance, *self.args)


class RNNTLoss(Layer):
    def __init__(self, blank=0, fastemit_lambda=0.0, reduction="mean",
                 name=None):
        super().__init__()
        self.blank, self.reduction = blank, reduction

    def forward(self, logits, labels, logit_lengths, label_lengths):
        return F.rnnt_loss(logits, labels, logit_lengths, label_lengths,
                           self.blank, reduction=self.reduction)


class AdaptiveLogSoftmaxWithLoss(Layer):
    """Clustered softmax for large vocabularies: the frequent classes and
    one logit a cluster in the head, each cluster's classes behind a
    down-projection (``in_features / div_value ** (i + 1)`` wide)."""

    def __init__(self, in_features, n_classes, cutoffs, div_value=4.0,
                 head_bias=False, name=None):
        super().__init__()
        cutoffs = list(cutoffs)
        if (cutoffs != sorted(cutoffs) or min(cutoffs) <= 0
                or max(cutoffs) > n_classes - 1
                or len(set(cutoffs)) != len(cutoffs)):
            raise ValueError(
                "cutoffs should be a sequence of unique, positive, "
                "increasing integers < n_classes")
        self.in_features = in_features
        self.n_classes = n_classes
        self.cutoffs = cutoffs + [n_classes]
        self.div_value = div_value
        self.shortlist_size = cutoffs[0]
        self.n_clusters = len(self.cutoffs) - 1
        self.head_size = self.shortlist_size + self.n_clusters
        self.head = Linear(in_features, self.head_size,
                           bias_attr=None if head_bias else False)
        self.tail = []
        for i in range(self.n_clusters):
            hsz = max(1, int(in_features // (div_value ** (i + 1))))
            osz = self.cutoffs[i + 1] - self.cutoffs[i]
            proj = Linear(in_features, hsz, bias_attr=False)
            out = Linear(hsz, osz, bias_attr=False)
            setattr(self, f"tail_proj_{i}", proj)
            setattr(self, f"tail_out_{i}", out)
            self.tail.append((proj, out))

    def _full_log_prob(self, input):
        head_lp = F.log_softmax(self.head(input), axis=-1)
        parts = [head_lp[..., :self.shortlist_size]]
        for i, (proj, out) in enumerate(self.tail):
            tail_lp = F.log_softmax(out(proj(input)), axis=-1)
            cluster_lp = head_lp[..., self.shortlist_size + i]
            parts.append(tail_lp + cluster_lp.unsqueeze(-1))
        return concat(parts, axis=-1)

    def forward(self, input, label):
        def fn(lp, t):
            out = lp.gather(-1, t.long()[:, None])[:, 0]
            return out, -out.mean()

        return apply("adaptive_log_softmax", fn,
                     self._full_log_prob(input), as_tensor(label))

    def log_prob(self, input):
        return self._full_log_prob(input)

    def predict(self, input):
        return argmax(self._full_log_prob(input), axis=-1)


# ---------------------------------------------------------------------------
# decoding
# ---------------------------------------------------------------------------
class BeamSearchDecoder:
    """Beam search over an RNN cell, driven by :func:`dynamic_decode`:
    ``embedding_fn(ids) -> inputs`` (one-hot of the cell's ``input_size``
    when None), ``output_fn(cell_out) -> logits`` (the cell's output when
    None)."""

    def __init__(self, cell, start_token, end_token, beam_size,
                 embedding_fn=None, output_fn=None):
        self.cell = cell
        self.start_token = start_token
        self.end_token = end_token
        self.beam_size = beam_size
        self.embedding_fn = embedding_fn
        self.output_fn = output_fn

    def initialize(self, initial_cell_states):
        """-> ((ids, log_probs, finished) [batch, beam] each, states)."""
        states = initial_cell_states
        first = states[0] if isinstance(states, (list, tuple)) else states
        batch, dev = first.shape[0], first._data.device
        ids = torch.full((batch, self.beam_size), self.start_token,
                         dtype=torch.int64, device=dev)
        log_probs = torch.tensor([0.0] + [-1e9] * (self.beam_size - 1),
                                 device=dev).repeat(batch, 1)
        finished = torch.zeros((batch, self.beam_size), dtype=torch.bool,
                               device=dev)
        return (wrap_array(ids), wrap_array(log_probs),
                wrap_array(finished)), states

    def step(self, time, inputs, states):
        raise NotImplementedError(
            "BeamSearchDecoder.step is driven by dynamic_decode")


def _map_states(fn, states):
    if isinstance(states, (list, tuple)):
        return type(states)(_map_states(fn, s) for s in states)
    return fn(states)


def dynamic_decode(decoder, inits=None, max_step_num=100, **kwargs):
    """Beam search, eagerly -> (ids [batch, beam, T] int64, each beam's
    summed log-probability [batch, beam])."""
    with torch.no_grad():
        (ids_t, logp_t, fin_t), states = decoder.initialize(inits)
        batch, beam = ids_t.shape
        log_probs, finished = logp_t._data, fin_t._data
        dev = log_probs.device

        def tile(s):
            a = as_tensor(s)._data
            if a.dim() >= 2 and a.shape[0] == batch:
                a = a.repeat_interleave(beam, dim=0)
            return wrap_array(a)

        def reorder(src):
            def re(s):
                a = as_tensor(s)._data
                if a.dim() >= 2 and a.shape[0] == batch * beam:
                    a = a.reshape(batch, beam, *a.shape[1:])
                    idx = src.reshape(batch, beam, *([1] * (a.dim() - 2)))
                    a = a.gather(1, idx.expand_as(a)).reshape(
                        batch * beam, *a.shape[2:])
                return wrap_array(a)
            return re

        states = _map_states(tile, states)
        last = ids_t._data
        all_ids, all_src = [], []
        for _ in range(max_step_num):
            tok = last.reshape(batch * beam)
            if decoder.embedding_fn is not None:
                inp = decoder.embedding_fn(wrap_array(tok))
            else:
                width = getattr(decoder.cell, "input_size", None)
                inp = wrap_array(TF.one_hot(tok, width).float())
            out, states = decoder.cell(inp, states)
            logits = decoder.output_fn(out) if decoder.output_fn is not None \
                else out
            step_lp = torch.log_softmax(logits._data, -1)
            V = step_lp.shape[-1]
            step_lp = step_lp.reshape(batch, beam, V)
            end_only = torch.where(torch.arange(V, device=dev) ==
                                   decoder.end_token, 0.0, -1e9).to(
                step_lp.dtype)
            step_lp = torch.where(finished[..., None], end_only, step_lp)
            cand = (log_probs[..., None] + step_lp).reshape(batch, beam * V)
            log_probs, top = torch.topk(cand, beam, dim=-1)
            src, tok_ids = top // V, top % V
            finished = finished.gather(1, src) | (tok_ids ==
                                                  decoder.end_token)
            states = _map_states(reorder(src), states)
            all_ids.append(tok_ids)
            all_src.append(src)
            last = tok_ids
            if bool(finished.all()):
                break
        seq = F.gather_tree(wrap_array(torch.stack(all_ids)),
                            wrap_array(torch.stack(all_src)))
        return (wrap_array(seq._data.permute(1, 2, 0).contiguous()),
                wrap_array(log_probs))
