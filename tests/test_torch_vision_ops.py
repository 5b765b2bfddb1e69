"""The port's convolutions, pools, batch norm and vision models held against
paddle_tpu's on the CPU.

The same numpy inputs (seeded) and the same weights (JAX's
``state_dict()`` loaded into the port) go through both packages in f32;
the gradients are each package's ``backward`` of ``sum(out * g)`` for a
seeded cotangent ``g``.  Tolerances: a single op within 1e-5 (relative and
absolute: the same sums in another order); a whole model's logits and
gradients within 1e-4 of the largest element of each (tens of layers of
such rounding, and BatchNorm's division by a batch's spread).  The
running buffers are held at 1e-6.  ``resnet18`` at 32 x 32, batch 2 runs
in f64 and is held at 1e-9: its last stage's BatchNorm takes each
channel's statistics over two values (1 x 1 maps), which turns f32
rounding into gaps of 1e-3 of the logits; in f64 the two packages agree
to 4e-12.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import paddle_tpu as jp  # noqa: E402
import paddle_tpu.nn.functional as JF  # noqa: E402
import paddle_tpu_torch as tp  # noqa: E402
import paddle_tpu_torch.nn.functional as TF  # noqa: E402
from paddle_tpu.vision.models import resnet as jresnet  # noqa: E402
from paddle_tpu.vision import models as jm  # noqa: E402
from paddle_tpu_torch.framework import place as tplace  # noqa: E402
from paddle_tpu_torch.models.weights import layer_state_from_jax  # noqa
from paddle_tpu_torch.vision import models as tm  # noqa: E402

OP_TOL = dict(rtol=1e-5, atol=1e-5)
MODEL_REL = 1e-4
F64_REL = 1e-9
STAT_TOL = dict(rtol=1e-6, atol=1e-6)
PKG = {"jax": (jp, JF), "torch": (tp, TF)}


@pytest.fixture(scope="module", autouse=True)
def _cpu():
    prev = tplace._current_place
    tp.set_device("cpu")
    yield
    tplace._current_place = prev


def _np(t):
    return np.asarray(t.numpy())


def _grads(side, fn, arrays, cot_seed=0):
    """``fn(pkg, F, *tensors)`` on both packages' tensors of ``arrays``
    -> (out, the gradient of sum(out * g) by each array)."""
    pkg, F = PKG[side]
    ts = [pkg.to_tensor(a, stop_gradient=False) for a in arrays]
    out = fn(pkg, F, *ts)
    g = np.random.RandomState(cot_seed).randn(*out.shape).astype(np.float32)
    (out * pkg.to_tensor(g)).sum().backward()
    return _np(out), [_np(t.grad) for t in ts]


def _both(fn, arrays, tol=OP_TOL):
    jo, jg = _grads("jax", fn, arrays)
    to, tg = _grads("torch", fn, arrays)
    assert jo.shape == to.shape
    np.testing.assert_allclose(to, jo, **tol)
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(a, b, **tol)


CONV_CASES = [
    dict(stride=1, padding=0),
    dict(stride=2, padding=1),
    dict(stride=1, padding="SAME", dilation=2),
    dict(stride=2, padding="SAME"),
    dict(stride=2, padding="VALID"),
    dict(stride=1, padding=[1, 2, 0, 1]),
    dict(stride=(2, 1), padding=(1, 0), groups=2),
    dict(stride=1, padding=1, groups=4, dilation=(1, 2)),
]


@pytest.mark.parametrize("kw", CONV_CASES, ids=str)
@pytest.mark.parametrize("bias", [True, False])
def test_conv2d_forward_and_gradients_match_jax(kw, bias):
    rng = np.random.RandomState(3)
    groups = kw.get("groups", 1)
    x = rng.randn(2, 4, 9, 8).astype(np.float32)
    w = rng.randn(6 if groups != 4 else 8, 4 // groups, 3, 2).astype(
        np.float32)
    arrays = [x, w] + ([rng.randn(w.shape[0]).astype(np.float32)]
                       if bias else [])
    _both(lambda pkg, F, a, ww, *b: F.conv2d(a, ww, b[0] if b else None,
                                             **kw), arrays)


@pytest.mark.parametrize("nd", [1, 3])
def test_conv1d_and_conv3d_match_jax(nd):
    rng = np.random.RandomState(4)
    x = rng.randn(2, 3, *([7] * nd)).astype(np.float32)
    w = rng.randn(5, 3, *([3] * nd)).astype(np.float32)
    b = rng.randn(5).astype(np.float32)
    name = f"conv{nd}d"
    _both(lambda pkg, F, a, ww, bb: getattr(F, name)(
        a, ww, bb, stride=2, padding=1), [x, w, b])


def test_conv2d_channel_last_matches_jax():
    rng = np.random.RandomState(5)
    x = rng.randn(2, 6, 5, 4).astype(np.float32)
    w = rng.randn(3, 4, 3, 3).astype(np.float32)
    _both(lambda pkg, F, a, ww: F.conv2d(a, ww, padding="SAME",
                                         data_format="NHWC"), [x, w])


POOL_CASES = [
    # (kernel, stride, padding, ceil_mode): torch's own pool where 2p <= k,
    # the rule written out where 2p > k
    (2, 2, 0, False), (3, 2, 1, False), (3, 2, 0, True), (2, 2, 1, True),
    (3, 1, 1, True), ((3, 2), (2, 1), (1, 0), True), (2, 1, 2, False),
    (3, 2, 2, True),
]


@pytest.mark.parametrize("case", POOL_CASES, ids=str)
@pytest.mark.parametrize("kind", ["max", "avg_exclusive", "avg_inclusive"])
def test_pool2d_matches_jax(case, kind):
    k, s, p, ceil = case
    x = np.random.RandomState(6).randn(2, 3, 9, 10).astype(np.float32)
    if kind == "max":
        fn = lambda pkg, F, a: F.max_pool2d(a, k, s, p, ceil_mode=ceil)  # noqa
    else:
        fn = lambda pkg, F, a: F.avg_pool2d(  # noqa: E731
            a, k, s, p, ceil_mode=ceil,
            exclusive=kind == "avg_exclusive")
    _both(fn, [x])


@pytest.mark.parametrize("nd", [1, 3])
def test_pool1d_and_pool3d_match_jax(nd):
    x = np.random.RandomState(7).randn(2, 2, *([7] * nd)).astype(np.float32)
    for kind in ("max", "avg"):
        name = f"{kind}_pool{nd}d"
        _both(lambda pkg, F, a: getattr(F, name)(a, 3, 2, 1, ceil_mode=True),
              [x])


def test_pool_ceil_mode_drops_a_window_wholly_in_padding():
    # tests/test_vision_models_extended.py:105: k 2, s 2, p 1 on 5 gives 3
    x = np.random.RandomState(2).randn(1, 1, 5, 5).astype(np.float32)
    out = TF.max_pool2d(tp.to_tensor(x), 2, stride=2, padding=1,
                        ceil_mode=True)
    assert out.shape == [1, 1, 3, 3] and np.isfinite(_np(out)).all()
    ones = TF.avg_pool2d(tp.to_tensor(np.ones((1, 1, 5, 5), np.float32)), 2,
                         stride=2, ceil_mode=True)
    np.testing.assert_allclose(_np(ones), np.ones((1, 1, 3, 3)), rtol=1e-6)


@pytest.mark.parametrize("size,out", [((8, 8), (4, 2)), ((7, 9), (3, 4)),
                                      ((5, 6), 1), ((6, 5), (6, 5))])
def test_adaptive_avg_pool2d_matches_jax(size, out):
    x = np.random.RandomState(8).randn(2, 3, *size).astype(np.float32)
    _both(lambda pkg, F, a: F.adaptive_avg_pool2d(a, out), [x])


def _bn_inputs(seed=9, shape=(4, 3, 5, 6)):
    rng = np.random.RandomState(seed)
    C = shape[1]
    return (rng.randn(*shape).astype(np.float32) * 2 + 1,
            rng.randn(C).astype(np.float32),
            rng.rand(C).astype(np.float32) + 0.5,
            rng.randn(C).astype(np.float32),
            rng.randn(C).astype(np.float32))


@pytest.mark.parametrize("training,ugs", [(True, None), (False, None),
                                          (True, True), (False, False)])
def test_batch_norm_matches_jax(training, ugs):
    x, m, v, w, b = _bn_inputs()
    stats = {}

    def fn(pkg, F, a, ww, bb):
        rm, rv = pkg.to_tensor(m), pkg.to_tensor(v)
        out = F.batch_norm(a, rm, rv, ww, bb, training=training,
                           momentum=0.8, epsilon=1e-4,
                           use_global_stats=ugs)
        stats[pkg.__name__] = (_np(rm), _np(rv))
        return out

    _both(fn, [x, w, b])
    jm_, jv = stats["paddle_tpu"]
    tm_, tv = stats["paddle_tpu_torch"]
    np.testing.assert_allclose(tm_, jm_, **STAT_TOL)
    np.testing.assert_allclose(tv, jv, **STAT_TOL)
    if not training:
        np.testing.assert_array_equal(tm_, m)


def test_batch_norm_layer_running_buffers_after_three_steps_match_jax():
    layers = {}
    for name, (pkg, _) in PKG.items():
        pkg.seed(11)
        layers[name] = pkg.nn.Sequential(pkg.nn.Conv2D(3, 4, 3, padding=1),
                                         pkg.nn.BatchNorm2D(4, momentum=0.7),
                                         pkg.nn.ReLU())
    layer_state_from_jax(layers["torch"], layers["jax"].state_dict())
    rng = np.random.RandomState(12)
    for _ in range(3):
        x = rng.randn(4, 3, 6, 6).astype(np.float32) * 3 - 1
        outs = [_np(layers[n](PKG[n][0].to_tensor(x))) for n in PKG]
        np.testing.assert_allclose(outs[1], outs[0], **OP_TOL)
    js, ts = layers["jax"].state_dict(), layers["torch"].state_dict()
    assert set(js) == set(ts) and "1._mean" in ts and "1._variance" in ts
    for k in ("1._mean", "1._variance"):
        np.testing.assert_allclose(_np(ts[k]), _np(js[k]), **STAT_TOL)
        assert not np.allclose(_np(ts[k]), 0.0 if "mean" in k else 1.0)
    for n in PKG:
        layers[n].eval()
    x = rng.randn(2, 3, 6, 6).astype(np.float32)
    np.testing.assert_allclose(
        _np(layers["torch"](tp.to_tensor(x))),
        _np(layers["jax"](jp.to_tensor(x))), **OP_TOL)


def _close_rel(got, ref, what, rel):
    scale = max(float(np.abs(ref).max()), 1e-12)
    gap = float(np.abs(got - ref).max()) / scale
    assert gap <= rel, f"{what}: {gap} of the largest element"


def _model_case(make, shape, seed, n_cls, dtype="float32", rel=MODEL_REL):
    nets = {}
    for name, (pkg, _) in PKG.items():
        pkg.seed(seed)
        nets[name] = make(name)
        if dtype != "float32":
            nets[name].to(dtype=dtype)
    layer_state_from_jax(nets["torch"], nets["jax"].state_dict())
    rng = np.random.RandomState(seed)
    x = rng.rand(*shape).astype(dtype)
    g = rng.randn(shape[0], n_cls).astype(dtype) if n_cls else None
    outs, grads = {}, {}
    for name, (pkg, _) in PKG.items():
        net = nets[name]
        net.train()
        out = net(pkg.to_tensor(x))
        cot = g if g is not None else rng.randn(*out.shape).astype(dtype)
        if g is None:
            g = cot
        (out * pkg.to_tensor(cot)).sum().backward()
        outs[name] = _np(out)
        grads[name] = {k: _np(p.grad) for k, p in net.named_parameters()}
        grads[name].update({k: _np(b) for k, b in net.named_buffers()})
    _close_rel(outs["torch"], outs["jax"], "output", rel)
    assert set(grads["torch"]) == set(grads["jax"])
    for k in grads["jax"]:
        _close_rel(grads["torch"][k], grads["jax"][k], k, rel)


def test_lenet_logits_and_gradients_match_jax():
    _model_case(lambda n: (jm if n == "jax" else tm).LeNet(), (3, 1, 28, 28),
                21, 10)


def test_bottleneck_block_matches_jax():
    def make(n):
        mods, pkg = (jresnet, jp) if n == "jax" else (tm, tp)
        down = pkg.nn.Sequential(pkg.nn.Conv2D(8, 16, 1, stride=2,
                                               bias_attr=False),
                                 pkg.nn.BatchNorm2D(16))
        return mods.BottleneckBlock(8, 4, stride=2, downsample=down)
    _model_case(make, (2, 8, 9, 9), 22, None)


def test_resnet18_at_32_logits_and_gradients_match_jax():
    _model_case(lambda n: (jm if n == "jax" else tm).resnet18(num_classes=10),
                (2, 3, 32, 32), 23, 10, dtype="float64", rel=F64_REL)


def test_resnet_sizes_and_pretrained_raises():
    # ResNet-50's 25,557,032 parameters (He et al. 2016; torchvision's and
    # Paddle's count) and 53 BatchNorm pairs of running buffers
    net = tm.resnet50()
    assert sum(p.size for p in net.parameters()) == 25557032
    assert len(net.buffers()) == 2 * 53
    # JAX's widths: groups x int(planes * width / 64) in a bottleneck
    for fn, width in (("resnext50_32x4d", 128), ("wide_resnet50_2", 128),
                      ("resnext101_32x8d", 256)):
        shape = getattr(tm, fn)().state_dict()["layer1.0.conv2.weight"].shape
        assert shape[0] == width, (fn, shape)
    with pytest.raises(RuntimeError, match="pretrained"):
        tm.resnet18(pretrained=True)


def test_sync_batch_norm_is_batch_norm_in_one_process(monkeypatch):
    x = np.random.RandomState(24).randn(4, 3, 5, 5).astype(np.float32)
    outs = []
    for cls in (tp.nn.BatchNorm2D, tp.nn.SyncBatchNorm):
        tp.seed(0)
        outs.append(_np(cls(3)(tp.to_tensor(x))))
    np.testing.assert_array_equal(outs[1], outs[0])
    conv = tp.nn.SyncBatchNorm.convert_sync_batchnorm(
        tp.nn.Sequential(tp.nn.Conv2D(3, 3, 1), tp.nn.BatchNorm2D(3)))
    assert isinstance(conv[1], tp.nn.SyncBatchNorm)
    # across processes its statistics would need an all-reduce
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda: 2)
    with pytest.raises(NotImplementedError, match="9\\(a\\)"):
        conv(tp.to_tensor(x))


def test_unported_pool_and_conv_options_raise():
    x = tp.to_tensor(np.arange(16, dtype=np.float32).reshape(1, 1, 4, 4))
    # return_mask is ported: the maxima and their flat indices
    out, mask = TF.max_pool2d(x, 2, return_mask=True)
    np.testing.assert_array_equal(_np(mask).ravel(), [5, 7, 13, 15])
    with pytest.raises(NotImplementedError):
        tp.nn.Conv2D(1, 1, 3, padding_mode="reflect")
