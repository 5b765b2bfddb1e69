"""nn.functional's ops beyond the activations, convolutions and pools of
earlier slices, on the port, held against paddle_tpu's on the CPU: the
transposed convolutions, the pools' masks and the adaptive max pools, the
norms, padding and resampling, the shuffles, fold / unfold, the grid
ops, every loss and the long tail of ``extras.py``.

The same seeded numpy inputs go through both packages in f32, and the
gradient of ``sum(out * g)`` for a seeded cotangent ``g`` by each float
input.  Tolerance ``TOL``: 1e-5 relative and absolute (the same formulas,
sums in other orders); ``LOOSE`` (1e-4) for the ops whose sums run over a
few hundred terms in another association (the transposed convolutions,
``interpolate``'s resampling matrices, CTC's and RNN-T's recursions).
Integer outputs are equal.  Where JAX returns no mask (the 1-D and 3-D max
pools, the adaptive max pools) the port's indices are held against a
numpy argmax.  The random ops (the dropouts, the fractional pools without
``random_u``, ``class_center_sample``) draw from each package's own
generator and are held by their laws.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import paddle_tpu as jp  # noqa: E402
import paddle_tpu.nn.functional as JF  # noqa: E402
import paddle_tpu_torch as tp  # noqa: E402
import paddle_tpu_torch.nn.functional as TF  # noqa: E402
from paddle_tpu.tensor.tensor import wrap_array  # noqa: E402
from paddle_tpu_torch.framework import place as tplace  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
LOOSE = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module", autouse=True)
def _cpu():
    prev = tplace._current_place
    tp.set_device("cpu")
    yield
    tplace._current_place = prev


def _np(t):
    return np.asarray(t.numpy())


def _cot(shape, dtype, i):
    return np.asarray(np.random.RandomState(7 + i).randn(*shape)).astype(
        dtype)


def _floats(outs):
    return [o for o in outs if o is not None and
            np.issubdtype(np.dtype(o.dtype), np.floating)]


def _run_torch(fn, arrays, ints, grad):
    ts = [tp.to_tensor(a, stop_gradient=not grad) for a in arrays]
    outs = fn(tp, TF, *ts, *[tp.to_tensor(a) for a in ints])
    outs = list(outs) if isinstance(outs, (tuple, list)) else [outs]
    floats = [o for o in outs if o is not None and o._data.is_floating_point()]
    grads = []
    if grad and floats:
        total = sum((o * tp.to_tensor(_cot(o.shape, _np(o).dtype, i))).sum()
                    for i, o in enumerate(floats))
        total.backward()
        # a float input the outputs do not reach: JAX gives zeros, torch
        # no gradient
        grads = [np.zeros(t.shape, np.float32) if t.grad is None
                 else _np(t.grad) for t in ts]
    return [None if o is None else _np(o) for o in outs], grads


def _run_jax(fn, arrays, ints, grad):
    """JAX's function traced once under jax.jit (its value and the
    gradient of the same sum(out * g)): one XLA program a case in place of
    one compile a primitive."""
    n = len(arrays)

    def f(*arrs):
        outs = fn(jp, JF, *[wrap_array(a) for a in arrs])
        outs = list(outs) if isinstance(outs, (tuple, list)) else [outs]
        outs = [None if o is None else o._data for o in outs]
        total = sum(jnp.sum(o * _cot(o.shape, o.dtype, i))
                    for i, o in enumerate(_floats(outs)))
        return total, outs

    args = [*arrays, *ints]
    if grad and n:
        (_, outs), grads = jax.jit(jax.value_and_grad(
            f, argnums=tuple(range(n)), has_aux=True))(*args)
        grads = [np.asarray(g) for g in grads]
    else:
        outs, grads = jax.jit(lambda *a: f(*a)[1])(*args), []
    return [None if o is None else np.asarray(o) for o in outs], grads


def _run_jax_eager(fn, arrays, ints, grad):
    """For the functions that read a value on the host or draw a key
    (no trace): JAX's eager ops and its tape."""
    ts = [jp.to_tensor(a, stop_gradient=not grad) for a in arrays]
    outs = fn(jp, JF, *ts, *[jp.to_tensor(a) for a in ints])
    outs = list(outs) if isinstance(outs, (tuple, list)) else [outs]
    grads = []
    floats = [o for o in outs if o is not None and
              np.issubdtype(_np(o).dtype, np.floating)]
    if grad and floats:
        total = sum((o * jp.to_tensor(_cot(o.shape, _np(o).dtype, i))).sum()
                    for i, o in enumerate(floats))
        total.backward()
        grads = [_np(t.grad) for t in ts]
    return [None if o is None else _np(o) for o in outs], grads


def _both(fn, arrays, ints=(), tol=TOL, grad=True, jit=True):
    """fn(pkg, F, *float tensors, *int tensors) on both packages."""
    jo, jg = (_run_jax if jit else _run_jax_eager)(fn, arrays, ints, grad)
    to, tg = _run_torch(fn, arrays, ints, grad)
    assert len(jo) == len(to)
    for a, b in zip(to, jo):
        if b is None:
            continue
        assert a.shape == b.shape, (a.shape, b.shape)
        if np.issubdtype(b.dtype, np.floating):
            np.testing.assert_allclose(a, b, **tol)
        else:
            np.testing.assert_array_equal(a, b)
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(a, b, **tol)
    return to


def _r(*shape, seed=0, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


# ---------------------------------------------------------------------------
# transposed convolutions
# ---------------------------------------------------------------------------
TCONV_CASES = [
    dict(stride=1, padding=0),
    dict(stride=2, padding=1),
    dict(stride=2, padding=1, output_padding=1),
    dict(stride=2, padding=0, dilation=2),
    dict(stride=3, padding=2, output_padding=2),
    dict(stride=2, padding=[1, 0, 0, 2]),
    dict(stride=(2, 1), padding=(1, 0), data_format="NHWC"),
]


@pytest.mark.parametrize("kw", TCONV_CASES, ids=str)
def test_conv2d_transpose_matches_jax(kw):
    x = _r(2, 4, 5, 6)
    if kw.get("data_format") == "NHWC":
        x = x.transpose(0, 2, 3, 1).copy()
    w, b = _r(4, 3, 3, 3, seed=1), _r(3, seed=2)
    _both(lambda pkg, F, a, ww, bb: F.conv2d_transpose(a, ww, bb, **kw),
          [x, w, b], tol=LOOSE)


@pytest.mark.parametrize("mode, explicit", [("SAME", [0, 1, 1, 1]),
                                            ("VALID", 0)])
def test_conv2d_transpose_string_padding_is_paddles(mode, explicit):
    # JAX's lax call refuses string padding for a transposed convolution;
    # the port takes Paddle's rule ("SAME": in * stride outputs), held
    # against JAX with the explicit padding that rule picks
    x = _r(2, 4, 5, 6)
    w, b = _r(4, 3, 3, 4, seed=1), _r(3, seed=2)
    out = _both(lambda pkg, F, a, ww, bb: F.conv2d_transpose(
        a, ww, bb, stride=2, padding=mode if pkg is tp else explicit),
        [x, w, b], tol=LOOSE)[0]
    if mode == "SAME":
        assert out.shape == (2, 3, 10, 12)


@pytest.mark.parametrize("nd", [1, 3])
def test_conv1d_and_conv3d_transpose_match_jax(nd):
    x = _r(2, 3, *([4] * nd))
    w, b = _r(3, 2, *([3] * nd), seed=1), _r(2, seed=2)
    name = f"conv{nd}d_transpose"
    _both(lambda pkg, F, a, ww, bb: getattr(F, name)(
        a, ww, bb, stride=2, padding=1, output_padding=1), [x, w, b],
        tol=LOOSE)


# ---------------------------------------------------------------------------
# pools with masks, adaptive max pools
# ---------------------------------------------------------------------------
def _mask_ref(x, out, idx):
    """Each index points at its output's value in its sample's plane."""
    n, c = x.shape[:2]
    flat = x.reshape(n, c, -1)
    picked = np.take_along_axis(flat, idx.reshape(n, c, -1).astype(np.int64),
                                -1)
    np.testing.assert_array_equal(picked.reshape(out.shape), out)


@pytest.mark.parametrize("kw", [dict(kernel_size=2), dict(
    kernel_size=3, stride=2, padding=1), dict(kernel_size=2, stride=1,
                                              padding=1)], ids=str)
def test_max_pool2d_mask_matches_jax(kw):
    x = _r(2, 3, 7, 6)
    out, idx = _both(lambda pkg, F, a: F.max_pool2d(a, return_mask=True,
                                                    **kw), [x])
    assert idx.dtype == np.int32
    _mask_ref(x, out, idx)


@pytest.mark.parametrize("nd", [1, 3])
def test_max_pool1d_3d_masks_point_at_their_maxima(nd):
    # JAX returns (out, None): the values are held against JAX's, the
    # port's mask against its own values
    x = _r(2, 3, *([6] * nd))
    name = f"max_pool{nd}d"
    out, idx = _both(lambda pkg, F, a: getattr(F, name)(
        a, 2, stride=2, padding=1, return_mask=True), [x])
    _mask_ref(x, out, idx)
    up = getattr(TF, f"max_unpool{nd}d")(tp.to_tensor(out),
                                         tp.to_tensor(idx), 2, 2, 1,
                                         output_size=x.shape)
    assert np.isin(_np(up)[_np(up) != 0], x).all()


@pytest.mark.parametrize("nd, size", [(1, 3), (2, (3, 2)), (3, 2)])
def test_adaptive_max_pools_match_jax(nd, size):
    x = _r(2, 3, *([7] * nd))
    name = f"adaptive_max_pool{nd}d"
    _both(lambda pkg, F, a: getattr(F, name)(a, size), [x])
    out, idx = getattr(TF, name)(tp.to_tensor(x), size, return_mask=True)
    _mask_ref(x, _np(out), _np(idx))


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------
NORM_CASES = {
    "instance_norm": (lambda pkg, F, a, w, b: F.instance_norm(
        a, weight=w, bias=b, eps=1e-4), (2, 4, 5, 3)),
    "group_norm": (lambda pkg, F, a, w, b: F.group_norm(
        a, 2, epsilon=1e-4, weight=w, bias=b), (2, 4, 5, 3)),
    "instance_norm_1d": (lambda pkg, F, a, w, b: F.instance_norm(
        a, weight=w, bias=b), (2, 4, 9)),
}


@pytest.mark.parametrize("name", sorted(NORM_CASES))
def test_affine_norms_match_jax(name):
    fn, shape = NORM_CASES[name]
    _both(fn, [_r(*shape), _r(4, seed=1), _r(4, seed=2)])


def test_local_response_norm_and_normalize_match_jax():
    x = _r(2, 6, 3, 3)
    _both(lambda pkg, F, a: F.local_response_norm(a, 3, alpha=0.1, k=2.0),
          [x])
    _both(lambda pkg, F, a: F.local_response_norm(a, 4), [x])
    _both(lambda pkg, F, a: F.normalize(a, p=3, axis=1), [x])
    _both(lambda pkg, F, a: F.normalize(a, axis=-1), [x])


# ---------------------------------------------------------------------------
# padding, resampling, shuffles, fold / unfold, grids
# ---------------------------------------------------------------------------
PAD_CASES = [
    (2, "constant"), ([1, 2, 0, 1], "constant"), ([1, 2, 0, 1], "reflect"),
    ([3, 1, 2, 0], "replicate"), ([1, 4, 2, 1], "circular"),
    ([0, 0, 0, 0, 1, 1, 2, 0], "reflect"),
    ([5, 0, 0, 0], "reflect"),
]


@pytest.mark.parametrize("pad, mode", PAD_CASES, ids=str)
def test_pad_matches_jax(pad, mode):
    _both(lambda pkg, F, a: F.pad(a, pad, mode=mode, value=0.5),
          [_r(2, 3, 4, 5)])


def test_pad_channel_last_matches_jax():
    _both(lambda pkg, F, a: F.pad(a, [1, 2, 0, 1], mode="reflect",
                                  data_format="NHWC"), [_r(2, 4, 5, 3)])


INTERP_CASES = [
    ("nearest", [9, 7]), ("nearest", [3, 2]), ("bilinear", [9, 11]),
    ("bilinear", [3, 2]), ("bicubic", [8, 10]), ("bicubic", [2, 3]),
    ("area", [3, 3]),
]


@pytest.mark.parametrize("mode, size", INTERP_CASES, ids=str)
def test_interpolate_matches_jax(mode, size):
    _both(lambda pkg, F, a: F.interpolate(a, size=size, mode=mode),
          [_r(2, 3, 5, 6)], tol=LOOSE)


def test_trilinear_and_scale_factor_match_jax():
    _both(lambda pkg, F, a: F.interpolate(a, scale_factor=2,
                                          mode="trilinear"),
          [_r(1, 2, 3, 4, 2)], tol=LOOSE)
    _both(lambda pkg, F, a: F.upsample(a, scale_factor=[1.5, 0.5],
                                       mode="bilinear"),
          [_r(1, 2, 4, 6)], tol=LOOSE)


def test_shuffles_match_jax():
    x = _r(2, 8, 4, 6)
    _both(lambda pkg, F, a: F.pixel_shuffle(a, 2), [x])
    _both(lambda pkg, F, a: F.pixel_unshuffle(a, 2), [x])
    _both(lambda pkg, F, a: F.channel_shuffle(a, 4), [x])


@pytest.mark.parametrize("kw", [dict(kernel_sizes=2), dict(
    kernel_sizes=[3, 2], strides=2, paddings=1, dilations=[1, 2])], ids=str)
def test_unfold_and_fold_match_jax(kw):
    x = _r(2, 3, 7, 8)
    cols = _both(lambda pkg, F, a: F.unfold(a, **kw), [x])[0]
    _both(lambda pkg, F, a: F.fold(a, [7, 8], **kw), [cols])


@pytest.mark.parametrize("align", [True, False])
def test_affine_grid_and_grid_sample_match_jax(align):
    theta = np.array([[[0.9, 0.2, 0.1], [-0.1, 1.1, -0.2]],
                      [[1.2, -0.3, 0.0], [0.2, 0.8, 0.3]]], np.float32)
    grid = _both(lambda pkg, F, t: F.affine_grid(t, [2, 3, 5, 4],
                                                 align_corners=align),
                 [theta])[0].astype(np.float32)
    x = _r(2, 3, 6, 5)
    for mode in ("bilinear", "nearest"):
        _both(lambda pkg, F, a, g: F.grid_sample(a, g, mode=mode,
                                                 align_corners=align),
              [x, grid * 1.2])


def test_bilinear_one_hot_cosine_and_sequence_mask_match_jax():
    _both(lambda pkg, F, a, b, w, bb: F.bilinear(a, b, w, bb),
          [_r(4, 3), _r(4, 5, seed=1), _r(2, 3, 5, seed=2), _r(2, seed=3)])
    _both(lambda pkg, F, y: F.one_hot(y, 6), [],
          [np.array([[0, 5, 2], [1, 1, 3]])], grad=False)
    _both(lambda pkg, F, a, b: F.cosine_similarity(a, b, axis=1),
          [_r(4, 6), _r(4, 6, seed=1)])
    _both(lambda pkg, F, n: F.sequence_mask(n), [],
          [np.array([3, 0, 5, 2])], grad=False, jit=False)
    _both(lambda pkg, F, n: F.sequence_mask(n, maxlen=7, dtype="float32"),
          [], [np.array([[3, 1], [6, 2]])], grad=False)


def test_dropouts_follow_their_laws():
    tp.seed(3)
    x = tp.ones([64, 32, 4, 4])
    y = _np(TF.dropout2d(x, p=0.25))
    per_ch = y.reshape(64, 32, -1)
    assert ((per_ch == 0).all(-1) | (per_ch == per_ch[..., :1]).all(-1)).all()
    assert abs((per_ch[..., 0] == 0).mean() - 0.25) < 0.03
    np.testing.assert_allclose(np.unique(y), [0.0, 1 / 0.75], rtol=1e-6)
    y3 = _np(TF.dropout3d(tp.ones([16, 32, 2, 3, 3]), p=0.5))
    assert (y3.reshape(16, 32, -1).std(-1) == 0).all()
    z = _np(TF.alpha_dropout(tp.to_tensor(_r(256, 256)), p=0.2))
    assert abs(z.mean()) < 0.02 and abs(z.std() - 1.0) < 0.02
    assert np.array_equal(_np(TF.alpha_dropout(tp.ones([3]), training=False)),
                          np.ones(3, np.float32))


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------
def _probs(*shape, seed=0):
    return (1 / (1 + np.exp(-_r(*shape, seed=seed)))).astype(np.float32)


def _labels(n, c, seed=0):
    return np.random.RandomState(seed).randint(0, c, n).astype(np.int64)


SIGNS = np.array([1, -1, 1, 1, -1, -1], np.float32)
LOSS_CASES = {
    "bce": (lambda pkg, F, p, y, w: F.binary_cross_entropy(p, y, w),
            [_probs(6, 3), _probs(6, 3, seed=1), _r(6, 3, seed=2)], []),
    "bce_sum": (lambda pkg, F, p, y: F.binary_cross_entropy(
        p, y, reduction="sum"), [_probs(6, 3), _probs(6, 3, seed=1)], []),
    "bce_logits": (lambda pkg, F, z, y, w, pw:
                   F.binary_cross_entropy_with_logits(
                       z, y, w, pos_weight=pw, reduction="none"),
                   [_r(6, 3), _probs(6, 3, seed=1), _r(3, seed=2),
                    _probs(3, seed=3)], []),
    "mse": (lambda pkg, F, a, b: F.mse_loss(a, b), [_r(5, 4),
                                                   _r(5, 4, seed=1)], []),
    "square_error_cost": (lambda pkg, F, a, b: F.square_error_cost(a, b),
                          [_r(5, 4), _r(5, 4, seed=1)], []),
    "l1": (lambda pkg, F, a, b: F.l1_loss(a, b, reduction="sum"),
           [_r(5, 4), _r(5, 4, seed=1)], []),
    "smooth_l1": (lambda pkg, F, a, b: F.smooth_l1_loss(a, b, delta=0.7),
                  [_r(5, 4), _r(5, 4, seed=1)], []),
    "nll": (lambda pkg, F, lp, y: F.nll_loss(lp, y),
            [np.log(_probs(6, 5))], [_labels(6, 5)]),
    "nll_ignore": (lambda pkg, F, lp, y: F.nll_loss(lp, y, ignore_index=2,
                                                    reduction="sum"),
                   [np.log(_probs(6, 5))], [_labels(6, 5)]),
    "nll_weight": (lambda pkg, F, lp, w, y: F.nll_loss(lp, y, weight=w),
                   [np.log(_probs(6, 5)), _probs(5, seed=4)],
                   [_labels(6, 5)]),
    "nll_spatial": (lambda pkg, F, lp, y: F.nll_loss(lp, y,
                                                     reduction="none"),
                    [np.log(_probs(2, 5, 3))],
                    [np.random.RandomState(1).randint(0, 5, (2, 3))]),
    "kl_div": (lambda pkg, F, lp, t: F.kl_div(lp, t),
               [np.log(_probs(4, 5)), _probs(4, 5, seed=1)], []),
    "kl_div_batchmean_log": (lambda pkg, F, lp, t: F.kl_div(
        lp, t, reduction="batchmean", log_target=True),
        [np.log(_probs(4, 5)), np.log(_probs(4, 5, seed=1))], []),
    "margin_ranking": (lambda pkg, F, a, b, y: F.margin_ranking_loss(
        a, b, y, margin=0.3), [_r(6), _r(6, seed=1), SIGNS], []),
    "hinge_embedding": (lambda pkg, F, a, y: F.hinge_embedding_loss(
        a, y, margin=0.5), [_r(6), SIGNS], []),
    "cosine_embedding": (lambda pkg, F, a, b, y: F.cosine_embedding_loss(
        a, b, y, margin=0.1), [_r(6, 4), _r(6, 4, seed=1), SIGNS], []),
    "soft_margin": (lambda pkg, F, a, y: F.soft_margin_loss(a, y),
                    [_r(6), SIGNS], []),
    "triplet": (lambda pkg, F, a, p, n: F.triplet_margin_loss(
        a, p, n, swap=True, p=1.5), [_r(5, 4), _r(5, 4, seed=1),
                                     _r(5, 4, seed=2)], []),
    "sigmoid_focal": (lambda pkg, F, z, y, n: F.sigmoid_focal_loss(
        z, y, normalizer=n), [_r(6, 3), (_probs(6, 3, seed=1) > 0.5).astype(
            np.float32), np.array([2.5], np.float32)], []),
    "log_loss": (lambda pkg, F, p, y: F.log_loss(p, y),
                 [_probs(6, 1), (_probs(6, 1, seed=1) > 0.5).astype(
                     np.float32)], []),
    "softmax_with_ce": (lambda pkg, F, z, y: F.softmax_with_cross_entropy(
        z, y, return_softmax=True), [_r(5, 7)], [_labels(5, 7)[:, None]]),
    "pairwise_distance": (lambda pkg, F, a, b: F.pairwise_distance(
        a, b, p=3.0, keepdim=True), [_r(5, 4), _r(5, 4, seed=1)], []),
    "label_smooth": (lambda pkg, F, lab, d: F.label_smooth(
        lab, prior_dist=d, epsilon=0.2), [_probs(3, 5), _probs(5, seed=1)],
        []),
    "label_smooth_uniform": (lambda pkg, F, lab: F.label_smooth(lab),
                             [_probs(3, 5)], []),
    "dice": (lambda pkg, F, p: F.dice_loss(p, pkg.to_tensor(
        np.array([[[1], [0]], [[2], [1]]]))), [_probs(2, 2, 3)], []),
    "poisson_nll": (lambda pkg, F, x, t: F.poisson_nll_loss(x, t, full=True),
                    [_r(6), np.abs(_r(6, seed=1)) * 3], []),
    "poisson_nll_lin": (lambda pkg, F, x, t: F.poisson_nll_loss(
        x, t, log_input=False), [_probs(6), np.abs(_r(6, seed=1))], []),
    "npair": (lambda pkg, F, a, p, y: F.npair_loss(a, p, y),
              [_r(4, 3), _r(4, 3, seed=1), np.array([0, 1, 0, 2],
                                                    np.float32)], []),
    "multi_label_soft_margin": (
        lambda pkg, F, x, t, w: F.multi_label_soft_margin_loss(x, t, w),
        [_r(4, 5), (_probs(4, 5, seed=1) > 0.5).astype(np.float32),
         _probs(5, seed=2)], []),
    "multi_margin": (lambda pkg, F, x, w, y: F.multi_margin_loss(
        x, y, p=2, margin=0.8, weight=w), [_r(5, 4), _probs(4, seed=1)],
        [_labels(5, 4)]),
    "triplet_with_distance": (
        lambda pkg, F, a, p, n: F.triplet_margin_with_distance_loss(
            a, p, n, swap=True), [_r(5, 4), _r(5, 4, seed=1),
                                  _r(5, 4, seed=2)], []),
    "gaussian_nll": (lambda pkg, F, m, t, v: F.gaussian_nll_loss(
        m, t, v, full=True), [_r(6), _r(6, seed=1), _probs(6, seed=2)], []),
    "hsigmoid": (lambda pkg, F, x, w, b, y: F.hsigmoid_loss(x, y, 6, w, b),
                 [_r(5, 4), _r(5, 4, seed=1), _r(5, 1, seed=2)],
                 [_labels(5, 6)]),
    "margin_ce": (lambda pkg, F, x, y: F.margin_cross_entropy(
        x, y, return_softmax=True, scale=8.0),
        [np.tanh(_r(5, 6))], [_labels(5, 6)]),
}


@pytest.mark.parametrize("name", sorted(LOSS_CASES))
def test_loss_matches_jax(name):
    fn, floats, ints = LOSS_CASES[name]
    _both(fn, floats, ints)


def test_ctc_loss_matches_jax():
    T, B, C, L = 12, 3, 5, 4
    lp = _r(T, B, C)
    labels = np.random.RandomState(1).randint(1, C, (B, L))
    il, ll = np.array([12, 10, 9]), np.array([4, 2, 3])
    for red in ("mean", "none"):
        _both(lambda pkg, F, a, y, i, n: F.ctc_loss(a, y, i, n,
                                                    reduction=red),
              [lp], [labels, il, ll], tol=LOOSE)


def test_rnnt_loss_matches_jax():
    B, T, U, V = 2, 5, 3, 6
    x = _r(B, T, U + 1, V)
    y = np.random.RandomState(1).randint(1, V, (B, U))
    _both(lambda pkg, F, a, yy, tl, ul: F.rnnt_loss(a, yy, tl, ul,
                                                    reduction="none"),
          [x], [y, np.array([5, 3]), np.array([3, 2])], tol=LOOSE)


# ---------------------------------------------------------------------------
# pool variants and the rest of extras.py
# ---------------------------------------------------------------------------
def test_zeropad_lp_pool_and_unpool_match_jax():
    x = np.abs(_r(2, 3, 6, 7)) + 0.1
    _both(lambda pkg, F, a: F.zeropad2d(a, [1, 0, 2, 1]), [x])
    _both(lambda pkg, F, a: F.lp_pool2d(a, 2.0, 3, stride=2, ceil_mode=True),
          [x])
    _both(lambda pkg, F, a: F.lp_pool1d(a, 3.0, 2, padding=1), [x[:, :, 0]])
    out, idx = _both(lambda pkg, F, a: F.max_pool2d_with_index(
        a, 2, stride=2, padding=1), [x])
    for osize in (None, [7, 8]):
        _both(lambda pkg, F, a: F.max_unpool2d(
            a, pkg.to_tensor(idx), 2, 2, 1, output_size=osize), [out])


@pytest.mark.parametrize("nd, kernel", [(2, None), (2, 2), (3, None)])
def test_fractional_max_pools_with_random_u_match_jax(nd, kernel):
    # JAX draws a key even with random_u: its eager path
    shape = (2, 3, 7, 9) if nd == 2 else (1, 2, 5, 4, 5)
    out = [3, 4] if nd == 2 else 2
    name = f"fractional_max_pool{nd}d"
    _both(lambda pkg, F, a: getattr(F, name)(
        a, out, kernel_size=kernel, random_u=0.37), [_r(*shape)], jit=False)


def test_fractional_max_pool_draws_cover_the_input():
    tp.seed(11)
    x = tp.to_tensor(np.arange(81, dtype=np.float32).reshape(1, 1, 9, 9))
    outs = {tuple(_np(TF.fractional_max_pool2d(x, 4)).ravel())
            for _ in range(20)}
    assert len(outs) > 1
    assert all(o[-1] == 80.0 for o in outs)


def test_gather_tree_temporal_shift_and_sparse_masks_match_jax():
    T, B, K = 5, 2, 3
    rs = np.random.RandomState(2)
    ids, par = rs.randint(0, 9, (T, B, K)), rs.randint(0, K, (T, B, K))
    _both(lambda pkg, F, i, p: F.gather_tree(i, p), [], [ids, par],
          grad=False)
    _both(lambda pkg, F, a: F.temporal_shift(a, 3, 0.25), [_r(6, 8, 2, 2)])
    _both(lambda pkg, F, a: F.temporal_shift(a, 2, 0.2, data_format="NHWC"),
          [_r(4, 2, 2, 10)])
    q, k, v = (_r(2, 2, 6, 4, seed=s) for s in range(3))
    off = np.array([[[0, 2, 3, 5, 7, 8, 10], [0, 1, 2, 3, 4, 5, 6]]] * 2)
    cols = np.array([[[0, 1, 1, 0, 2, 2, 3, 4, 4, 5],
                      [0, 1, 2, 3, 4, 5, 0, 0, 0, 0]]] * 2)
    kp = (rs.rand(2, 6) > 0.2).astype(np.float32)
    _both(lambda pkg, F, a, b, c, m, o, cc: F.sparse_attention(
        a, b, c, o, cc, key_padding_mask=m), [q, k, v, kp], [off, cols])
    starts = np.random.RandomState(3).randint(1, 7, (2, 2, 1, 6))
    _both(lambda pkg, F, a, b, c, st: F.flash_attention_with_sparse_mask(
        a, b, c, attn_mask_start_row_indices=st),
        [_r(2, 6, 2, 4, seed=s) for s in range(3)], [starts])


def test_adaptive_log_softmax_and_qkvpacked_match_jax():
    x, hw = _r(6, 8), _r(8, 5, seed=1)
    tails = [[_r(8, 4, seed=2), _r(4, 3, seed=3)],
             [_r(8, 2, seed=4), _r(2, 6, seed=5)]]
    y = np.array([0, 3, 5, 9, 11, 7])
    _both(lambda pkg, F, a, h, p0, o0, p1, o1, t:
          F.adaptive_log_softmax_with_loss(a, t, h, [[p0, o0], [p1, o1]],
                                           [3, 6]),
          [x, hw] + tails[0] + tails[1], [y])
    qkv = _r(2, 16, 3, 2, 8)
    for causal in (False, True):
        _both(lambda pkg, F, a: F.flash_attn_qkvpacked(a, causal=causal),
              [qkv])


def test_class_center_sample_keeps_every_positive():
    tp.seed(5)
    lab = np.array([3, 7, 3, 19, 0])
    remapped, sampled = TF.class_center_sample(tp.to_tensor(lab), 20, 8)
    s, r = _np(sampled), _np(remapped)
    assert len(s) == 8 and set(lab) <= set(s) and (np.diff(s) > 0).all()
    np.testing.assert_array_equal(s[r], lab)
    _, all_pos = TF.class_center_sample(tp.to_tensor(lab), 20, 2)
    np.testing.assert_array_equal(_np(all_pos), [0, 3, 7, 19])
