"""The port's ``paddle.static`` held against paddle_tpu's on the CPU.

The counterpart of every case of tests/test_static_program_executor.py and
tests/test_static_inference_model.py, run through both packages on the
same feeds (numpy, from a seed) and the same weights (JAX's
``state_dict()`` carried by ``models.weights.layer_state_from_jax``), and
``serialize_program`` / ``deserialize_program`` and the persistables pair.
Tolerances: 1e-5 absolute against the numpy formula (JAX's own bar), 1e-6
between the packages (the same f32 ops summed in another order); errors
and feeds' checks exactly.  The port's program is a ``torch.export``
program where JAX's is StableHLO; the card's replay (a CUDA graph per
feed signature) is held in tests/test_torch_inference_cuda.py.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import paddle_tpu as jp  # noqa: E402
import paddle_tpu_torch as tp  # noqa: E402
from paddle_tpu_torch.framework import place as tplace  # noqa: E402
from paddle_tpu_torch.models.weights import layer_state_from_jax  # noqa

PKGS = {"jax": jp, "torch": tp}
ATOL = 1e-6


@pytest.fixture(scope="module", autouse=True)
def _cpu():
    prev = tplace._current_place
    tp.set_device("cpu")
    yield
    tplace._current_place = prev


def _build(pkg, seed=3):
    static = pkg.static
    main, startup = static.Program(), static.Program()
    with static.program_guard(main, startup):
        x = static.data("x", [None, 4], "float32")
        pkg.seed(seed)
        lin = pkg.nn.Linear(4, 3)
        y = pkg.tanh(lin(x)) * 2.0
    return main, lin, y


def _pair():
    """Both packages' programs, the port's Linear carrying JAX's weights."""
    jm, jlin, jy = _build(jp)
    tm, tlin, ty = _build(tp)
    layer_state_from_jax(tlin, jlin.state_dict())
    return {"jax": (jm, jlin, jy), "torch": (tm, tlin, ty)}


def test_run_twice_with_different_feeds():
    f1 = np.ones((2, 4), np.float32)
    f2 = np.full((5, 4), 0.5, np.float32)     # a new batch and values
    outs = {}
    for side, (main, lin, y) in _pair().items():
        exe = PKGS[side].static.Executor()
        out1, = exe.run(main, feed={"x": f1}, fetch_list=[y])
        out2, = exe.run(main, feed={"x": f2}, fetch_list=[y])
        W, b = lin.weight.numpy(), lin.bias.numpy()
        np.testing.assert_allclose(out1, np.tanh(f1 @ W + b) * 2, atol=1e-5)
        np.testing.assert_allclose(out2, np.tanh(f2 @ W + b) * 2, atol=1e-5)
        outs[side] = (out1, out2)
    for a, b in zip(outs["torch"], outs["jax"]):
        np.testing.assert_allclose(a, b, rtol=0, atol=ATOL)


def test_parameter_updates_visible_between_runs():
    f = np.ones((2, 4), np.float32)
    outs = {}
    for side, (main, lin, y) in _pair().items():
        pkg = PKGS[side]
        exe = pkg.static.Executor()
        out_a, = exe.run(main, feed={"x": f}, fetch_list=[y])
        lin.weight.set_value(pkg.to_tensor(lin.weight.numpy() * 2))
        out_b, = exe.run(main, feed={"x": f}, fetch_list=[y])
        W, b = lin.weight.numpy(), lin.bias.numpy()
        np.testing.assert_allclose(out_b, np.tanh(f @ W + b) * 2, atol=1e-5)
        assert not np.allclose(out_a, out_b)
        outs[side] = out_b
    np.testing.assert_allclose(outs["torch"], outs["jax"], rtol=0,
                               atol=ATOL)


@pytest.mark.parametrize("side", ["jax", "torch"])
def test_multiple_fetches_and_missing_feed(side):
    static = PKGS[side].static
    main, startup = static.Program(), static.Program()
    with static.program_guard(main, startup):
        x = static.data("x", [None, 3], "float32")
        a = x * 2.0
        b = a + 1.0
    exe = static.Executor()
    f = np.arange(6, dtype=np.float32).reshape(2, 3)
    oa, ob = exe.run(main, feed={"x": f}, fetch_list=[a, b])
    np.testing.assert_array_equal(oa, f * 2)
    np.testing.assert_array_equal(ob, f * 2 + 1)
    with pytest.raises(KeyError):
        exe.run(main, feed={}, fetch_list=[a])


@pytest.mark.parametrize("side", ["jax", "torch"])
def test_uncaptured_fetch_raises_clearly(side):
    pkg = PKGS[side]
    static = pkg.static
    main, startup = static.Program(), static.Program()
    with static.program_guard(main, startup):
        x = static.data("x", [2, 2], "float32")
        _ = x + 1.0
    stray = pkg.to_tensor(np.zeros((2, 2), np.float32)) * 3.0
    exe = static.Executor()
    # eager tensors not built from placeholders fetch their eager value
    out, = exe.run(main, feed={"x": np.ones((2, 2), np.float32)},
                   fetch_list=[stray])
    np.testing.assert_array_equal(out, np.zeros((2, 2)))


@pytest.mark.parametrize("side", ["jax", "torch"])
def test_executor_rejects_unknown_feed_names(side):
    pkg = PKGS[side]
    static = pkg.static
    pkg.enable_static()
    try:
        assert not pkg.in_dynamic_mode()
        main, startup = static.Program(), static.Program()
        with static.program_guard(main, startup):
            x = static.data("x", [2, 3], "float32")
            y = (x * 2.0).sum()
        exe = static.Executor()
        feed_ok = {"x": np.ones((2, 3), np.float32)}
        np.testing.assert_allclose(exe.run(main, feed=feed_ok,
                                           fetch_list=[y])[0], 12.0)
        with pytest.raises(KeyError):
            exe.run(main, feed={"x": feed_ok["x"],
                                "x_typo": feed_ok["x"]}, fetch_list=[y])
    finally:
        pkg.disable_static()
    assert pkg.in_dynamic_mode()


def _seq(pkg):
    nn = pkg.nn
    return nn.Sequential(nn.Linear(4, 8), nn.ReLU(), nn.Linear(8, 2))


def _carried_seq():
    jp.seed(5)
    jnet = _seq(jp)
    tnet = _seq(tp)
    layer_state_from_jax(tnet, jnet.state_dict())
    jnet.eval()
    tnet.eval()
    return {"jax": jnet, "torch": tnet}


def test_save_load_round_trip(tmp_path):
    xin = np.random.RandomState(0).randn(1, 4).astype("float32")
    outs = {}
    for side, net in _carried_seq().items():
        pkg = PKGS[side]
        static = pkg.static
        x = static.data("x", [1, 4], "float32")
        prefix = os.path.join(str(tmp_path), side, "model")
        exe = static.Executor()
        path = static.save_inference_model(prefix, [x], [net], exe)
        assert os.path.exists(path)
        assert path.endswith(".pt2" if side == "torch" else ".stablehlo")
        prog, feeds, fetches = static.load_inference_model(prefix, exe)
        out = exe.run(prog, feed={feeds[0]: xin}, fetch_list=fetches)
        ref = net(pkg.to_tensor(xin)).numpy()
        np.testing.assert_allclose(out[0], ref, rtol=1e-5, atol=1e-6)
        outs[side] = out[0]
    np.testing.assert_allclose(outs["torch"], outs["jax"], rtol=0,
                               atol=ATOL)


@pytest.mark.parametrize("side", ["jax", "torch"])
def test_save_requires_callable(side, tmp_path):
    static = PKGS[side].static
    exe = static.Executor()
    x = static.data("x2", [1, 4], "float32")
    with pytest.raises(TypeError):
        static.save_inference_model(str(tmp_path / "nope"), [x], [x], exe)


def test_serialize_and_deserialize_program():
    """The program's bytes run again in the other call, the persistables
    restore a fresh Layer: the same outputs in both packages."""
    xin = np.random.RandomState(1).randn(1, 4).astype("float32")
    outs = {}
    for side, net in _carried_seq().items():
        pkg = PKGS[side]
        static = pkg.static
        x = static.data("x3", [1, 4], "float32")
        blob = static.serialize_program([x], [net])
        assert isinstance(blob, bytes) and blob
        run = static.deserialize_program(blob)
        if side == "jax":
            # JAX's program takes the weights first; the port's carries
            # them
            st = {"params": {k: np.asarray(v.numpy())
                             for k, v in net.named_parameters()},
                  "buffers": {k: np.asarray(v.numpy())
                              for k, v in net.named_buffers()}}
            got = np.asarray(run(st, xin)[0])
        else:
            got = run(xin)[0].numpy()
        ref = net(pkg.to_tensor(xin)).numpy()
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
        state = static.serialize_persistables([x], [net])
        fresh = _seq(pkg)
        static.deserialize_persistables(fresh, state)
        fresh.eval()
        np.testing.assert_array_equal(fresh(pkg.to_tensor(xin)).numpy(),
                                      ref)
        outs[side] = got
    np.testing.assert_allclose(outs["torch"], outs["jax"], rtol=0,
                               atol=ATOL)
    with pytest.raises(TypeError):
        tp.static.serialize_program([], [tp.to_tensor([1.0])])


def test_static_helpers_match_jax():
    """gradients, the EMA's apply / restore and create_parameter's
    shapes, against JAX's on the same values (1e-6)."""
    res = {}
    for side, pkg in PKGS.items():
        static = pkg.static
        x = pkg.to_tensor(np.array([1.0, 2.0, 3.0], np.float32),
                          stop_gradient=False)
        g, = static.gradients((x * x).sum(), [x])
        w = pkg.to_tensor(np.array([1.0, -1.0], np.float32),
                          stop_gradient=False)
        ema = static.ExponentialMovingAverage(decay=0.5)
        ema.update([w])
        w.set_value(pkg.to_tensor(np.array([3.0, 1.0], np.float32)))
        ema.update()
        with ema.apply():
            applied = w.numpy().copy()
        restored = w.numpy().copy()
        p = static.create_parameter([2, 3], "float32", is_bias=True)
        res[side] = (g.numpy(), applied, restored, p.numpy())
    for a, b in zip(res["torch"], res["jax"]):
        np.testing.assert_allclose(a, b, rtol=0, atol=ATOL)
    assert tp.static.cpu_places() == [tp.CPUPlace()]
