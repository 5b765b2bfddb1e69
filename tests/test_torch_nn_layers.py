"""nn's layers of this slice on the port, held against paddle_tpu's on the
CPU: the common layers, every loss layer, the norms, the transposed
convolutions, the adaptive max pools, the long tail of ``extras.py`` and
the initializers.

Each layer is built in both packages, the port's loaded from JAX's
``state_dict()`` through ``models/weights.py:layer_state_from_jax`` (the
same names and shapes: the norms' weights, ``SpectralNorm``'s
``weight_u`` / ``weight_v``, the transposed convolutions' ``[in, out /
groups, *k]`` weights, ``AdaptiveLogSoftmaxWithLoss``'s head and tails).
JAX's forward runs once under ``jax.jit`` through ``_functional_call``
with the gradient of ``sum(out * g)`` by every input and parameter; the
port's through torch's autograd.  Tolerance ``TOL``: 1e-5 relative and
absolute (the same formulas, sums in another order); ``LOOSE`` (1e-4) for
the transposed convolutions.  The initializers draw from each package's
own generator and are held by their laws (the mean and spread of 20,000
draws within 3 % of the law's), except the deterministic ones
(``Assign``, ``Bilinear``, ``calculate_gain``), held equal to JAX's.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import paddle_tpu as jp  # noqa: E402
from paddle_tpu.nn import initializer as JI  # noqa: E402
import paddle_tpu_torch as tp  # noqa: E402
from paddle_tpu_torch.framework import place as tplace  # noqa: E402
from paddle_tpu_torch.models.weights import layer_state_from_jax  # noqa
from paddle_tpu_torch.nn import initializer as TI  # noqa: E402
from test_torch_nn_parity import TOL, _np, _r, both_layers  # noqa: E402

LOOSE = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module", autouse=True)
def _cpu():
    prev = tplace._current_place
    tp.set_device("cpu")
    yield
    tplace._current_place = prev


X4 = _r(2, 4, 6, 5)
LAYER_CASES = {
    "Identity": (lambda nn: nn.Identity(3, k=1), [X4]),
    "Flatten": (lambda nn: nn.Flatten(1, 2), [X4]),
    "Bilinear": (lambda nn: nn.Bilinear(3, 5, 2),
                 [_r(4, 3), _r(4, 5, seed=1)]),
    "Pad1D": (lambda nn: nn.Pad1D([1, 2], mode="replicate"), [X4[:, :, 0]]),
    "Pad2D": (lambda nn: nn.Pad2D([1, 0, 2, 1], mode="reflect"), [X4]),
    "Pad3D": (lambda nn: nn.Pad3D(1, mode="circular"), [X4[None]]),
    "ZeroPad2D": (lambda nn: nn.ZeroPad2D([1, 2, 0, 1]), [X4]),
    "ZeroPad1D": (lambda nn: nn.ZeroPad1D([2, 1]), [X4[:, :, 0]]),
    "ZeroPad3D": (lambda nn: nn.ZeroPad3D([1, 0, 0, 2, 1, 1]), [X4[None]]),
    "Upsample": (lambda nn: nn.Upsample(scale_factor=2, mode="bilinear"),
                 [X4]),
    "UpsamplingBilinear2D": (lambda nn: nn.UpsamplingBilinear2D(
        size=[4, 3]), [X4]),
    "UpsamplingNearest2D": (lambda nn: nn.UpsamplingNearest2D(
        scale_factor=2), [X4]),
    "CosineSimilarity": (lambda nn: nn.CosineSimilarity(axis=-1),
                         [X4, _r(2, 4, 6, 5, seed=1)]),
    "PixelShuffle": (lambda nn: nn.PixelShuffle(2), [X4]),
    "PixelUnshuffle": (lambda nn: nn.PixelUnshuffle(2), [_r(2, 3, 6, 4)]),
    "ChannelShuffle": (lambda nn: nn.ChannelShuffle(2), [X4]),
    "Unfold": (lambda nn: nn.Unfold([2, 3], strides=1, paddings=1), [X4]),
    "Fold": (lambda nn: nn.Fold([4, 5], 2), [_r(2, 12, 12)]),
    "InstanceNorm1D": (lambda nn: nn.InstanceNorm1D(4), [X4[..., 0]]),
    "InstanceNorm2D": (lambda nn: nn.InstanceNorm2D(4, bias_attr=False),
                       [X4]),
    "InstanceNorm3D": (lambda nn: nn.InstanceNorm3D(2), [_r(2, 2, 3, 3, 2)]),
    "GroupNorm": (lambda nn: nn.GroupNorm(2, 4), [X4]),
    "LocalResponseNorm": (lambda nn: nn.LocalResponseNorm(3), [X4]),
    "SpectralNorm": (lambda nn: nn.SpectralNorm([4, 3, 2], dim=1,
                                                power_iters=3),
                     [_r(4, 3, 2)]),
    "AdaptiveMaxPool1D": (lambda nn: nn.AdaptiveMaxPool1D(4), [X4[:, :, 0]]),
    "AdaptiveMaxPool2D": (lambda nn: nn.AdaptiveMaxPool2D([4, 3]), [X4]),
    "AdaptiveMaxPool3D": (lambda nn: nn.AdaptiveMaxPool3D(2), [X4[None]]),
    "PairwiseDistance": (lambda nn: nn.PairwiseDistance(p=1.0),
                         [_r(4, 3), _r(4, 3, seed=1)]),
    "Softmax2D": (lambda nn: nn.Softmax2D(), [X4]),
    "Unflatten": (lambda nn: nn.Unflatten(1, [2, 2]), [X4]),
    "LPPool1D": (lambda nn: nn.LPPool1D(2, 2), [np.abs(X4[:, :, 0])]),
    "LPPool2D": (lambda nn: nn.LPPool2D(3, 2, stride=1),
                 [np.abs(X4) + 0.1]),
    "FractionalMaxPool2D": (lambda nn: nn.FractionalMaxPool2D(
        [3, 2], random_u=0.4), [X4]),
}


@pytest.mark.parametrize("name", sorted(LAYER_CASES))
def test_layer_matches_jax(name):
    make, arrays = LAYER_CASES[name]
    if name == "FractionalMaxPool2D":       # JAX draws a key: no trace
        jl, tl = make(jp.nn), make(tp.nn)
        np.testing.assert_array_equal(_np(tl(tp.to_tensor(arrays[0]))),
                                      _np(jl(jp.to_tensor(arrays[0]))))
        return
    both_layers(make, arrays)


TCONV_LAYERS = {
    "Conv1DTranspose": (lambda nn: nn.Conv1DTranspose(
        3, 4, 3, stride=2, padding=1, output_padding=1), _r(2, 3, 5)),
    "Conv2DTranspose": (lambda nn: nn.Conv2DTranspose(
        4, 6, [3, 2], stride=2, padding=1, groups=1), X4),
    "Conv3DTranspose": (lambda nn: nn.Conv3DTranspose(
        2, 3, 2, stride=2), _r(1, 2, 3, 3, 2)),
}


@pytest.mark.parametrize("name", sorted(TCONV_LAYERS))
def test_transposed_conv_layer_matches_jax(name):
    make, x = TCONV_LAYERS[name]
    both_layers(make, [x], tol=LOOSE)


def _lab(n, c, seed=0):
    return np.random.RandomState(seed).randint(0, c, n).astype(np.int64)


def _probs(*shape, seed=0):
    return (1 / (1 + np.exp(-_r(*shape, seed=seed)))).astype(np.float32)


SIGNS = np.array([1, -1, 1, -1], np.float32)
LOSS_LAYERS = {
    "MSELoss": (lambda nn: nn.MSELoss(), [_r(4, 3), _r(4, 3, seed=1)], []),
    "L1Loss": (lambda nn: nn.L1Loss("sum"), [_r(4, 3), _r(4, 3, seed=1)], []),
    "NLLLoss": (lambda nn: nn.NLLLoss(ignore_index=1),
                [np.log(_probs(4, 3))], [_lab(4, 3)]),
    "BCELoss": (lambda nn: nn.BCELoss(), [_probs(4, 3), _probs(4, 3, seed=1)],
                []),
    "BCEWithLogitsLoss": (lambda nn: nn.BCEWithLogitsLoss(),
                          [_r(4, 3), _probs(4, 3, seed=1)], []),
    "KLDivLoss": (lambda nn: nn.KLDivLoss("batchmean"),
                  [np.log(_probs(4, 3)), _probs(4, 3, seed=1)], []),
    "SmoothL1Loss": (lambda nn: nn.SmoothL1Loss(delta=0.5),
                     [_r(4, 3), _r(4, 3, seed=1)], []),
    "MarginRankingLoss": (lambda nn: nn.MarginRankingLoss(0.2),
                          [_r(4), _r(4, seed=1), SIGNS], []),
    "HingeEmbeddingLoss": (lambda nn: nn.HingeEmbeddingLoss(),
                           [_r(4), SIGNS], []),
    "CosineEmbeddingLoss": (lambda nn: nn.CosineEmbeddingLoss(0.1),
                            [_r(4, 3), _r(4, 3, seed=1), SIGNS], []),
    "TripletMarginLoss": (lambda nn: nn.TripletMarginLoss(swap=True),
                          [_r(4, 3), _r(4, 3, seed=1), _r(4, 3, seed=2)], []),
    "SoftMarginLoss": (lambda nn: nn.SoftMarginLoss(), [_r(4), SIGNS], []),
    "SigmoidFocalLoss": (lambda nn: nn.SigmoidFocalLoss(),
                         [_r(4, 3), (_probs(4, 3, seed=1) > .5).astype(
                             np.float32)], []),
    "PoissonNLLLoss": (lambda nn: nn.PoissonNLLLoss(),
                       [_r(4, 3), np.abs(_r(4, 3, seed=1))], []),
    "MultiLabelSoftMarginLoss": (lambda nn: nn.MultiLabelSoftMarginLoss(),
                                 [_r(4, 3), _probs(4, 3, seed=1)], []),
    "MultiMarginLoss": (lambda nn: nn.MultiMarginLoss(), [_r(4, 3)],
                        [_lab(4, 3)]),
    "TripletMarginWithDistanceLoss": (
        lambda nn: nn.TripletMarginWithDistanceLoss(margin=0.5),
        [_r(4, 3), _r(4, 3, seed=1), _r(4, 3, seed=2)], []),
    "GaussianNLLLoss": (lambda nn: nn.GaussianNLLLoss(),
                        [_r(4, 3), _r(4, 3, seed=1), _probs(4, 3, seed=2)], []),
    "HSigmoidLoss": (lambda nn: nn.HSigmoidLoss(3, 5), [_r(4, 3)],
                     [_lab(4, 5)]),
    "CrossEntropyLoss": (lambda nn: nn.CrossEntropyLoss(
        label_smoothing=0.1), [_r(4, 5)], [_lab(4, 5)]),
}


@pytest.mark.parametrize("name", sorted(LOSS_LAYERS))
def test_loss_layer_matches_jax(name):
    make, floats, ints = LOSS_LAYERS[name]
    both_layers(make, floats, ints)


def test_ctc_and_rnnt_loss_layers_match_jax():
    lp = np.log(_probs(8, 2, 4))
    labels = np.array([[1, 2, 3], [2, 2, 0]])
    jl, tl = jp.nn.CTCLoss(), tp.nn.CTCLoss()
    args = (labels, np.array([8, 6]), np.array([3, 2]))
    np.testing.assert_allclose(
        _np(tl(tp.to_tensor(lp), *map(tp.to_tensor, args))),
        _np(jl(jp.to_tensor(lp), *map(jp.to_tensor, args))), **LOOSE)
    x = _r(2, 4, 3, 5)
    rargs = (np.array([[1, 2], [3, 1]]), np.array([4, 3]), np.array([2, 1]))
    np.testing.assert_allclose(
        _np(tp.nn.RNNTLoss()(tp.to_tensor(x), *map(tp.to_tensor, rargs))),
        _np(jp.nn.RNNTLoss()(jp.to_tensor(x), *map(jp.to_tensor, rargs))),
        **LOOSE)


def test_adaptive_log_softmax_layer_matches_jax():
    out = both_layers(lambda nn: nn.AdaptiveLogSoftmaxWithLoss(
        8, 12, [4, 7], div_value=2.0, head_bias=True), [_r(5, 8)],
        [np.array([0, 5, 11, 3, 8])])
    assert out[0].shape == (5,)
    jp.seed(1)
    jl = jp.nn.AdaptiveLogSoftmaxWithLoss(8, 12, [4, 7])
    tl = tp.nn.AdaptiveLogSoftmaxWithLoss(8, 12, [4, 7])
    layer_state_from_jax(tl, jl.state_dict())
    x = _r(5, 8, seed=3)
    np.testing.assert_allclose(_np(tl.log_prob(tp.to_tensor(x))),
                               _np(jl.log_prob(jp.to_tensor(x))), **TOL)
    np.testing.assert_array_equal(_np(tl.predict(tp.to_tensor(x))),
                                  _np(jl.predict(jp.to_tensor(x))))


def test_unpool_layers_invert_the_masked_pools():
    x = _r(2, 3, 6, 8)
    out, idx = tp.nn.MaxPool2D(2, return_mask=True)(tp.to_tensor(x))
    jout, jidx = jp.nn.functional.max_pool2d(jp.to_tensor(x), 2,
                                             return_mask=True)
    np.testing.assert_array_equal(_np(idx), _np(jidx))
    up = _np(tp.nn.MaxUnPool2D(2)(out, idx))
    jup = _np(jp.nn.MaxUnPool2D(2)(jout, jidx))
    np.testing.assert_array_equal(up, jup)
    for nd in (1, 3):
        xs = _r(2, 3, *([4] * nd))
        pool = getattr(tp.nn, f"MaxPool{nd}D")(2, return_mask=True)
        o, i = pool(tp.to_tensor(xs))
        u = _np(getattr(tp.nn, f"MaxUnPool{nd}D")(2)(o, i))
        kept = u != 0
        np.testing.assert_array_equal(u[kept], xs[kept])
        assert kept.sum() == _np(o).size


def test_layer_dict_and_dropout_layers():
    d = tp.nn.LayerDict({"a": tp.nn.Linear(2, 3)})
    d["b"] = tp.nn.Identity()
    assert list(d.keys()) == ["a", "b"] and "a" in d and len(d) == 2
    assert {k for k, _ in d.named_parameters()} == {"a.weight", "a.bias"}
    d.pop("a")
    assert len(d) == 1 and not list(d.parameters())
    x = tp.ones([8, 16, 3, 3])
    for layer in (tp.nn.Dropout2D(0.5), tp.nn.Dropout3D(0.5),
                  tp.nn.AlphaDropout(0.5)):
        layer.eval()
        arg = x if not isinstance(layer, tp.nn.Dropout3D) else \
            tp.ones([4, 8, 2, 3, 3])
        np.testing.assert_array_equal(_np(layer(arg)), _np(arg))


# ---------------------------------------------------------------------------
# initializers
# ---------------------------------------------------------------------------
N_DRAW = (100, 200)
INIT_LAWS = {
    # name: (port initializer, the law's mean, the law's std)
    "TruncatedNormal": (TI.TruncatedNormal(0.5, 2.0), 0.5,
                        2.0 * math.sqrt(1 - 2 * 2 * math.exp(-2) /
                                        math.sqrt(2 * math.pi) /
                                        math.erf(2 / math.sqrt(2)))),
    "KaimingNormal": (TI.KaimingNormal(), 0.0, math.sqrt(2.0 / 100)),
    "KaimingUniform": (TI.KaimingUniform(nonlinearity="tanh"), 0.0,
                       5 / 3 * math.sqrt(3 / 100) / math.sqrt(3)),
    "KaimingNormal_leaky": (TI.KaimingNormal(negative_slope=0.2,
                                             nonlinearity="leaky_relu"),
                            0.0, math.sqrt(2 / 1.04) / 10),
}


@pytest.mark.parametrize("name", sorted(INIT_LAWS))
def test_initializer_follows_its_law(name):
    init, mean, std = INIT_LAWS[name]
    tp.seed(2)
    v = init(N_DRAW, "float32", "cpu").numpy()
    assert v.shape == N_DRAW and v.dtype == np.float32
    assert abs(v.mean() - mean) < 0.03 * max(std, 1e-3) * 3
    assert abs(v.std() - std) < 0.03 * std
    if name == "TruncatedNormal":
        assert v.min() >= 0.5 - 4.0 - 1e-5 and v.max() <= 0.5 + 4.0 + 1e-5


def test_deterministic_initializers_equal_jax():
    for nl in ("sigmoid", "tanh", "relu", "selu", "conv2d"):
        assert TI.calculate_gain(nl) == JI.calculate_gain(nl)
    assert TI.calculate_gain("leaky_relu", 0.3) == \
        JI.calculate_gain("leaky_relu", 0.3)
    for shape in ([3, 2, 4, 4], [2, 1, 3, 5]):
        np.testing.assert_allclose(
            TI.Bilinear()(shape, "float32", "cpu").numpy(),
            np.asarray(JI.Bilinear()(shape, "float32")), rtol=0, atol=1e-7)
    val = np.arange(6, dtype=np.float32)
    np.testing.assert_array_equal(
        TI.Assign(val)([2, 3], "float32", "cpu").numpy(),
        np.asarray(JI.Assign(val)([2, 3], "float32")))


def test_orthogonal_and_dirac_have_jax_structure():
    tp.seed(4)
    q = TI.Orthogonal(gain=2.0)([6, 4], "float32", "cpu").numpy()
    np.testing.assert_allclose(q.T @ q, 4 * np.eye(4), atol=1e-5)
    w = TI.Orthogonal()([3, 8], "float32", "cpu").numpy()
    np.testing.assert_allclose(w @ w.T, np.eye(3), atol=1e-5)
    d = TI.Dirac()([3, 3, 4, 6], "float32", "cpu").numpy()
    jd = np.asarray(JI.Dirac()([3, 3, 4, 6], "float32"))
    assert (d != 0).sum(axis=(2, 3)).tolist() == \
        (jd != 0).sum(axis=(2, 3)).tolist()
    c = d[1, 1]
    np.testing.assert_allclose(c @ c.T, np.eye(4), atol=1e-5)
    np.testing.assert_array_equal(TI.Dirac()([3, 5], "float32",
                                             "cpu").numpy(), np.eye(3, 5))


def test_set_global_initializer_reaches_every_create_parameter():
    try:
        TI.set_global_initializer(TI.Constant(0.25), TI.Constant(-1.0))
        lin = tp.nn.Linear(3, 2)
        assert (_np(lin.weight) == 0.25).all() and (_np(lin.bias) == -1).all()
        cell = tp.nn.LSTMCell(2, 3)
        assert (_np(cell.weight_hh) == 0.25).all()
        assert (_np(cell.bias_ih) == -1).all()
        p = tp.create_parameter([2, 2], "float32")
        assert (_np(p) == 0.25).all()
        # a ParamAttr's own initializer comes first, as in JAX
        lin2 = tp.nn.Linear(2, 2, weight_attr=tp.ParamAttr(
            initializer=TI.Constant(3.0)))
        assert (_np(lin2.weight) == 3.0).all()
        # and JAX's layer takes the same values
        JI.set_global_initializer(JI.Constant(0.25), JI.Constant(-1.0))
        jl = jp.nn.Linear(3, 2)
        np.testing.assert_array_equal(_np(lin.weight), _np(jl.weight))
    finally:
        TI.set_global_initializer(None, None)
        JI.set_global_initializer(None, None)
    assert not (_np(tp.nn.Linear(3, 2).weight) == 0.25).all()
