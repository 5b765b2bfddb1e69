"""The recurrent layers and beam search on the port, held against
paddle_tpu's on the CPU.

Every case builds the layer in both packages, loads JAX's ``state_dict()``
into the port's (``weight_ih`` / ``weight_hh`` / ``bias_ih`` / ``bias_hh``
a cell and direction, ``cell_fw_{i}`` / ``cell_bw_{i}`` a layer) and holds
the outputs, the final states and the gradient of ``sum(out * g)`` by the
input and every parameter within ``TOL`` (1e-5 relative and absolute: the
same gate formulas, the input products batched over time here).  The
cases cover ``sequence_length`` (rows that end early hold their state and
output zeros), the reverse direction over each row's valid region,
``direction="bidirect"``, ``time_major``, two layers with dropout between
them (in eval mode), given initial states, and each cell alone.

``dynamic_decode`` over an ``LSTMCell`` with an embedding and an output
projection: the beams' log-probabilities equal JAX's within ``TOL``, and a
reference search in the test shows every step's top-k choice stood clear
of the numerical error (the margin between the k-th and the (k+1)-th
candidate exceeds 100 times the largest logit gap between the packages),
so the comparison is not an accident of ties.  Each returned beam's ids,
rescored teacher-forced by the same cell, give its log-probability; JAX's
ids (each step's top-k tokens in top-k order, not backtraced) fail that
check wherever the search reordered its beams, which the test shows too.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import paddle_tpu as jp  # noqa: E402
import paddle_tpu_torch as tp  # noqa: E402
from paddle_tpu_torch.framework import place as tplace  # noqa: E402
from paddle_tpu_torch.models.weights import layer_state_from_jax  # noqa
from test_torch_nn_parity import TOL, _np, _r, both_layers  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _cpu():
    prev = tplace._current_place
    tp.set_device("cpu")
    yield
    tplace._current_place = prev


def _wrap(nn, inner, with_len=False, with_init=None):
    """A Layer that calls ``inner(x, init, lens)`` so the lengths ride as
    an input; ``with_init`` makes the initial states inputs too."""
    class Call(nn.Layer):
        def __init__(self):
            super().__init__()
            self.inner = inner

        def forward(self, x, *rest):
            rest = list(rest)
            init = None
            if with_init == "lstm":
                init = (rest.pop(0), rest.pop(0))
            elif with_init:
                init = rest.pop(0)
            lens = rest.pop(0) if with_len else None
            return self.inner(x, init, lens)

    return Call()


X = _r(3, 6, 5)
LENS = np.array([6, 2, 4])

CASES = {
    "simple_tanh": (lambda nn: nn.SimpleRNN(5, 4), [X], []),
    "simple_relu_2layer": (lambda nn: nn.SimpleRNN(
        5, 4, num_layers=2, activation="relu"), [X], []),
    "lstm_lens": (lambda nn: _wrap(nn, nn.LSTM(5, 4), with_len=True), [X],
                  [LENS]),
    "lstm_bidirect_2layer_lens": (lambda nn: _wrap(nn, nn.LSTM(
        5, 4, num_layers=2, direction="bidirect", dropout=0.3),
        with_len=True), [X], [LENS]),
    "gru_time_major_2layer": (lambda nn: nn.GRU(
        5, 4, num_layers=2, time_major=True), [X.transpose(1, 0, 2).copy()],
        []),
    "gru_bidirect_lens": (lambda nn: _wrap(nn, nn.GRU(
        5, 3, direction="bidirectional"), with_len=True), [X], [LENS]),
    "lstm_initial_states": (lambda nn: _wrap(nn, nn.LSTM(
        5, 4, num_layers=2), with_init="lstm"),
        [X, _r(2, 3, 4, seed=1), _r(2, 3, 4, seed=2)], []),
    "gru_initial_states_lens": (lambda nn: _wrap(nn, nn.GRU(5, 4),
                                                 with_len=True,
                                                 with_init=True),
                                [X, _r(1, 3, 4, seed=1)], [LENS]),
    "rnn_reverse_lstm_cell_lens": (lambda nn: _wrap(nn, nn.RNN(
        nn.LSTMCell(5, 4), is_reverse=True), with_len=True), [X], [LENS]),
    "rnn_time_major_simple_cell": (lambda nn: nn.RNN(
        nn.SimpleRNNCell(5, 4), time_major=True),
        [X.transpose(1, 0, 2).copy()], []),
    "birnn_gru_cells_lens": (lambda nn: _wrap(nn, nn.BiRNN(
        nn.GRUCell(5, 3), nn.GRUCell(5, 3)), with_len=True), [X], [LENS]),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_recurrent_layer_matches_jax(name):
    make, floats, ints = CASES[name]

    def build(nn):
        layer = make(nn)
        layer.eval()
        return layer

    outs = both_layers(build, floats, ints)
    if "lens" in name:
        # a row past its length outputs zeros
        assert (outs[0][1, 2:] == 0).all()


@pytest.mark.parametrize("cell", ["SimpleRNNCell", "LSTMCell", "GRUCell"])
def test_cells_alone_match_jax(cell):
    x, h = _r(3, 5), _r(3, 4, seed=1)
    if cell == "LSTMCell":
        c = _r(3, 4, seed=2)

        def make(nn):
            inner = nn.LSTMCell(5, 4)

            class Call(nn.Layer):
                def __init__(self):
                    super().__init__()
                    self.cell = inner

                def forward(self, a, hh, cc):
                    return self.cell(a, (hh, cc))
            return Call()

        both_layers(make, [x, h, c])
    else:
        both_layers(lambda nn: getattr(nn, cell)(5, 4), [x, h])


def test_parameter_names_and_shapes_are_jaxs():
    jl = jp.nn.LSTM(5, 4, num_layers=2, direction="bidirect")
    tl = tp.nn.LSTM(5, 4, num_layers=2, direction="bidirect")
    js = {k: tuple(v.shape) for k, v in jl.state_dict().items()}
    ts = {k: tuple(v.shape) for k, v in tl.state_dict().items()}
    assert js == ts
    assert ts["cell_bw_1.weight_ih"] == (16, 8)


def test_dropout_between_layers_draws_in_training():
    tp.seed(0)
    net = tp.nn.GRU(5, 4, num_layers=2, dropout=0.5)
    x = tp.to_tensor(X)
    net.eval()
    a, b = _np(net(x)[0]), _np(net(x)[0])
    np.testing.assert_array_equal(a, b)
    net.train()
    assert not np.array_equal(_np(net(x)[0]), _np(net(x)[0]))


# ---------------------------------------------------------------------------
# beam search
# ---------------------------------------------------------------------------
V, H, E, BEAM, START, END = 11, 8, 6, 3, 1, 0


def _decoder(pkg):
    pkg.seed(3)
    emb = pkg.nn.Embedding(V, E)
    cell = pkg.nn.LSTMCell(E, H)
    proj = pkg.nn.Linear(H, V)
    return emb, cell, proj


def _pair():
    jparts = _decoder(jp)
    tparts = _decoder(tp)
    for j, t in zip(jparts, tparts):
        layer_state_from_jax(t, j.state_dict())
    return jparts, tparts


def _init_states(pkg, batch):
    h = pkg.to_tensor(_r(batch, H, seed=5) * 0.5)
    c = pkg.to_tensor(_r(batch, H, seed=6) * 0.5)
    return (h, c)


def _decode(pkg, parts, batch, steps):
    emb, cell, proj = parts
    dec = pkg.nn.BeamSearchDecoder(cell, START, END, BEAM, embedding_fn=emb,
                                   output_fn=proj)
    ids, lp = pkg.nn.dynamic_decode(dec, _init_states(pkg, batch),
                                    max_step_num=steps)
    return _np(ids), _np(lp)


def _rescore(parts, batch, ids):
    """Each beam's tokens fed back teacher-forced -> summed log-probs."""
    emb, cell, proj = parts
    h, c = (s._data for s in _init_states(tp, batch))
    out = np.zeros((batch, BEAM))
    for b in range(batch):
        for k in range(BEAM):
            st = (tp.to_tensor(h[b:b + 1]), tp.to_tensor(c[b:b + 1]))
            prev, total, done = START, 0.0, False
            for tok in ids[b, k]:
                o, st = cell(emb(tp.to_tensor(np.array([prev]))), st)
                lp = torch.log_softmax(proj(o)._data, -1)[0].detach()
                if not done:
                    total += float(lp[tok])
                done = done or tok == END
                prev = tok
            out[b, k] = total
    return out


def _margins(parts, batch, steps):
    """The reference search (the port's cell and float64 scores): each
    step's gap between the k-th and the (k+1)-th candidate."""
    emb, cell, proj = parts
    h, c = (s._data.repeat_interleave(BEAM, 0) for s in
            _init_states(tp, batch))
    lp = torch.tensor([0.0] + [-1e9] * (BEAM - 1),
                      dtype=torch.float64).repeat(batch, 1)
    last = torch.full((batch * BEAM,), START)
    fin = torch.zeros((batch, BEAM), dtype=torch.bool)
    gaps = []
    with torch.no_grad():
        for _ in range(steps):
            o, (hh, cc) = cell(emb(tp.to_tensor(last)), (tp.to_tensor(h),
                                                         tp.to_tensor(c)))
            step = torch.log_softmax(proj(o)._data.double(), -1).reshape(
                batch, BEAM, V)
            end_only = torch.where(torch.arange(V) == END, 0.0, -1e9)
            step = torch.where(fin[..., None], end_only.double(), step)
            cand = (lp[..., None] + step).reshape(batch, -1)
            srt = cand.sort(-1, descending=True).values
            gaps.append(float((srt[:, BEAM - 1] - srt[:, BEAM]).min()))
            lp, top = srt[:, :BEAM], cand.topk(BEAM, -1).indices
            src, tok = top // V, top % V
            fin = fin.gather(1, src) | (tok == END)
            idx = (src + torch.arange(batch)[:, None] * BEAM).reshape(-1)
            h, c = hh._data[idx], cc._data[idx]
            last = tok.reshape(-1)
            if bool(fin.all()):
                break
    return min(gaps)


def test_dynamic_decode_matches_jax_and_its_beams_rescore():
    batch, steps = 4, 7
    jparts, tparts = _pair()
    jids, jlp = _decode(jp, jparts, batch, steps)
    tids, tlp = _decode(tp, tparts, batch, steps)
    assert tids.shape == jids.shape == (batch, BEAM, steps)
    np.testing.assert_allclose(tlp, jlp, **TOL)
    # the last step's tokens are the same top-k in both
    np.testing.assert_array_equal(tids[..., -1], jids[..., -1])
    # the logits' gap between the packages, against the search's margins
    x = _r(5, H, seed=9)
    gap = float(np.abs(_np(tparts[2](tp.to_tensor(x))) -
                       _np(jparts[2](jp.to_tensor(x)))).max())
    margin = _margins(tparts, batch, steps)
    assert margin > 100 * max(gap, 1e-7), (margin, gap)
    # each returned beam is the sequence that scored it
    np.testing.assert_allclose(_rescore(tparts, batch, tids), tlp,
                               rtol=1e-5, atol=1e-4)
    # JAX's ids are per-step top-k tokens: where beams were reordered they
    # do not rescore to their log-probabilities
    jgap = np.abs(_rescore(tparts, batch, jids) - jlp).max()
    assert jgap > 1e-2, jgap


def test_gather_tree_is_the_backtrace():
    ids = tp.to_tensor(np.array([[[2, 5]], [[3, 4]], [[7, 8]]]))
    parents = tp.to_tensor(np.array([[[0, 0]], [[1, 0]], [[1, 1]]]))
    out = _np(tp.nn.functional.gather_tree(ids, parents))
    # beam 0 ends on 7, whose parent is beam 1 at t = 1 (4), whose
    # parent is beam 0 at t = 0 (2)
    np.testing.assert_array_equal(out[:, 0, 0], [2, 4, 7])
    np.testing.assert_array_equal(out[:, 0, 1], [2, 4, 8])
