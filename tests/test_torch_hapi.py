"""The port's ``hapi.Model``, callbacks, ``optimizer.lr``, ``metric`` and
``save`` / ``load`` held against paddle_tpu's on the CPU.

Mirrors tests/test_hapi_compiled_fit.py.  LeNet (on JAX's synthetic
MNIST) and a small MLP get ``Model.fit`` on both packages with the same
weights (JAX's ``state_dict()`` loaded into the port), the same unshuffled
data and Adam / Momentum under a ``PiecewiseDecay`` schedule.  JAX's fit
runs its compiled step; the port's fit runs ``incubate.jit_train_step``,
eager on the CPU (its CUDA graph is the card's:
tests/test_torch_vision_cuda.py).  Tolerances: losses, parameters and
evaluate / predict outputs within 1e-5 relative and absolute (f32, the
same ops summed in another order, a dozen steps), but parameters trained
by Adam within 1e-4 absolute (its m / sqrt(v) turns the rounding of a
near-zero gradient into a step of either sign: 2 of LeNet's 61,610
weights land 4e-5 apart); BatchNorm's running buffers within 1e-5; the learning rates, the metric values (the same
counts of the same argmaxes), the schedules and the callbacks' order are
held exactly.
"""

import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import paddle_tpu as jp  # noqa: E402
import paddle_tpu_torch as tp  # noqa: E402
from paddle_tpu.io import Dataset as JDataset  # noqa: E402
from paddle_tpu.io import Subset as JSubset  # noqa: E402
from paddle_tpu.vision.datasets import MNIST as JMNIST  # noqa: E402
from paddle_tpu.vision.models import LeNet as JLeNet  # noqa: E402
from paddle_tpu_torch.framework import place as tplace  # noqa: E402
from paddle_tpu_torch.io import Subset as TSubset  # noqa: E402
from paddle_tpu_torch.io import worker as tworker  # noqa: E402
from paddle_tpu_torch.models.weights import layer_state_from_jax  # noqa
from paddle_tpu_torch.vision.datasets import MNIST as TMNIST  # noqa: E402
from paddle_tpu_torch.vision.models import LeNet as TLeNet  # noqa: E402
from torch_io_datasets import ToyDS  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
ADAM_PARAM_TOL = dict(rtol=1e-5, atol=1e-4)
PKGS = {"jax": jp, "torch": tp}


@pytest.fixture(scope="module", autouse=True)
def _cpu():
    prev = tplace._current_place
    tp.set_device("cpu")
    yield
    tplace._current_place = prev


def _np(t):
    return np.asarray(t.numpy())


class JToy(JDataset):
    def __init__(self, n=32):
        self._ds = ToyDS(n)

    def __len__(self):
        return len(self._ds)

    def __getitem__(self, i):
        return self._ds[i]


def _toy(side, n=32):
    return JToy(n) if side == "jax" else ToyDS(n)


def _mnist(side, n=48):
    mods = (JMNIST, JSubset) if side == "jax" else (TMNIST, TSubset)
    return mods[1](mods[0](mode="test"), list(range(n)))


def _mlp(pkg, bn=False):
    nn = pkg.nn
    layers = [nn.Linear(8, 16)]
    if bn:
        layers.append(nn.BatchNorm1D(16))
    return nn.Sequential(*layers, nn.ReLU(), nn.Linear(16, 2))


def _nets(make, seed=3):
    nets = {}
    for side, pkg in PKGS.items():
        pkg.seed(seed)
        nets[side] = make(side, pkg)
    layer_state_from_jax(nets["torch"], nets["jax"].state_dict())
    return nets


class Recorder:
    """Every callback hook called, in order, with the batch logs and the
    learning rate each train batch began with."""

    def __init__(self, pkg):
        outer = self

        class Rec(pkg.callbacks.Callback):
            pass

        self.events, self.logs, self.lrs = [], [], []
        names = [n for n in dir(pkg.callbacks.Callback) if n.startswith("on_")]
        for n in names:
            def hook(_self, *args, _n=n, **kw):
                outer.events.append(_n)
                if _n == "on_train_batch_begin":
                    outer.lrs.append(outer.cb.model._optimizer.get_lr())
                if _n == "on_train_batch_end":
                    logs = args[1] if len(args) > 1 else kw.get("logs")
                    outer.logs.append({k: v for k, v in logs.items()
                                       if k not in ("ips", "batch_size")})
            setattr(Rec, n, hook)
        self.cb = Rec()


def _opt(pkg, kind, net):
    if kind == "adam":
        sched = pkg.optimizer.lr.PiecewiseDecay([3, 6], [0.01, 0.005, 0.002])
        return pkg.optimizer.Adam(learning_rate=sched,
                                  parameters=net.parameters())
    sched = pkg.optimizer.lr.PiecewiseDecay([3, 6], [0.1, 0.05, 0.01])
    return pkg.optimizer.Momentum(learning_rate=sched, momentum=0.9,
                                  parameters=net.parameters())


def _fit_both(nets, data, kind, epochs=2, batch_size=8, **fit_kw):
    runs = {}
    for side, pkg in PKGS.items():
        net = nets[side]
        model = pkg.Model(net)
        model.prepare(_opt(pkg, kind, net), pkg.nn.CrossEntropyLoss(),
                      pkg.metric.Accuracy(topk=(1, 2)))
        rec = Recorder(pkg)
        model.fit(data(side), eval_data=data(side), batch_size=batch_size,
                  epochs=epochs, verbose=0, shuffle=False,
                  callbacks=[rec.cb], **fit_kw)
        runs[side] = (model, rec)
    return runs


def _same_logs(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert set(x) == set(y)
        for k in x:
            np.testing.assert_allclose(np.asarray(y[k], np.float64),
                                       np.asarray(x[k], np.float64), **TOL)


@pytest.mark.parametrize("case", ["lenet-adam", "mlp-momentum"])
def test_fit_evaluate_predict_match_jax(case):
    if case == "lenet-adam":
        nets = _nets(lambda side, pkg: (JLeNet if side == "jax"
                                        else TLeNet)(), seed=4)
        data, kind = _mnist, "adam"
    else:
        nets = _nets(lambda side, pkg: _mlp(pkg), seed=5)
        data, kind = _toy, "momentum"
    runs = _fit_both(nets, data, kind)
    (jm, jr), (tm, tr) = runs["jax"], runs["torch"]
    assert tm._adapter._jit_step is not None
    assert tr.lrs == jr.lrs and len(set(tr.lrs)) == 3
    _same_logs(jr.logs, tr.logs)
    assert tr.events == jr.events
    for (kj, pj), (kt, pt) in zip(nets["jax"].named_parameters(),
                                  nets["torch"].named_parameters()):
        assert kj == kt
        np.testing.assert_allclose(_np(pt), _np(pj), **(
            ADAM_PARAM_TOL if kind == "adam" else TOL))
    je = jm.evaluate(data("jax"), batch_size=16, verbose=0)
    te = tm.evaluate(data("torch"), batch_size=16, verbose=0)
    _same_logs([je], [te])
    jpred = jm.predict(data("jax"), batch_size=16, stack_outputs=True,
                       verbose=0)
    tpred = tm.predict(data("torch"), batch_size=16, stack_outputs=True,
                       verbose=0)
    np.testing.assert_allclose(tpred[0], jpred[0], **TOL)


def test_fit_on_a_batchnorm_model_leaves_jax_running_stats():
    nets = _nets(lambda side, pkg: _mlp(pkg, bn=True), seed=6)
    runs = _fit_both(nets, _toy, "momentum", epochs=1)
    _same_logs(runs["jax"][1].logs, runs["torch"][1].logs)
    jbn, tbn = nets["jax"][1], nets["torch"][1]
    for k in ("_mean", "_variance"):
        j, t = _np(getattr(jbn, k)), _np(getattr(tbn, k))
        np.testing.assert_allclose(t, j, **TOL)
        assert not np.allclose(t, 0.0 if k == "_mean" else 1.0)


@pytest.mark.parametrize("config", ["fp16_scaler", "clip_by_value"])
def test_ineligible_configurations_warn_as_jax_does(config):
    nets = _nets(lambda side, pkg: _mlp(pkg), seed=7)
    got = {}
    for side, pkg in PKGS.items():
        net = nets[side]
        clip = pkg.nn.ClipGradByValue(0.05) if config == "clip_by_value" \
            else None
        model = pkg.Model(net)
        model.prepare(pkg.optimizer.SGD(0.05, parameters=net.parameters(),
                                        grad_clip=clip),
                      pkg.nn.CrossEntropyLoss(),
                      amp_configs={"level": "O1", "dtype": "float16"}
                      if config == "fp16_scaler" else None)
        rec = Recorder(pkg)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            model.fit(_toy(side, 8), batch_size=4, epochs=1, verbose=0,
                      shuffle=False, callbacks=[rec.cb])
        msgs = [str(w.message) for w in caught
                if "compiled training is not available" in str(w.message)]
        assert model._adapter._jit_step is None
        got[side] = (len(msgs), rec.logs)
    assert got["torch"][0] == got["jax"][0] == 1
    if config == "clip_by_value":
        _same_logs(got["jax"][1], got["torch"][1])


def test_grad_accumulation_stays_eager_and_matches_jax():
    nets = _nets(lambda side, pkg: _mlp(pkg), seed=8)
    logs = {}
    for side, pkg in PKGS.items():
        model = pkg.Model(nets[side])
        model.prepare(pkg.optimizer.SGD(0.05,
                                        parameters=nets[side].parameters()),
                      pkg.nn.CrossEntropyLoss())
        rec = Recorder(pkg)
        with pytest.warns(UserWarning, match="gradient accumulation"):
            model.fit(_toy(side, 16), batch_size=4, epochs=1, verbose=0,
                      shuffle=False, accumulate_grad_batches=2,
                      callbacks=[rec.cb])
        assert model._adapter._jit_step is None
        logs[side] = rec.logs
    _same_logs(logs["jax"], logs["torch"])
    for pj, pt in zip(nets["jax"].parameters(), nets["torch"].parameters()):
        np.testing.assert_allclose(_np(pt), _np(pj), **TOL)


def test_early_stopping_and_checkpoints_fire_in_jax_order(tmp_path):
    nets = _nets(lambda side, pkg: _mlp(pkg), seed=9)
    out = {}
    for side, pkg in PKGS.items():
        model = pkg.Model(nets[side])
        model.prepare(pkg.optimizer.SGD(0.0,
                                        parameters=nets[side].parameters()),
                      pkg.nn.CrossEntropyLoss(), pkg.metric.Accuracy())
        rec = Recorder(pkg)
        stop = pkg.callbacks.EarlyStopping(monitor="acc", mode="max",
                                           patience=1, verbose=0)
        d = tmp_path / side
        model.fit(_toy(side), eval_data=_toy(side), batch_size=8, epochs=6,
                  verbose=0, shuffle=False, save_dir=str(d), save_freq=2,
                  callbacks=[rec.cb, stop])
        out[side] = (rec.events, sorted(p.name for p in d.iterdir()),
                     stop.wait, stop.best)
    assert out["torch"][0] == out["jax"][0]
    assert out["torch"][1] == out["jax"][1]
    assert "final.pdparams" in out["torch"][1]
    assert out["torch"][0].count("on_epoch_end") == 2     # stopped early
    assert out["torch"][2:] == out["jax"][2:]


def test_checkpoints_load_across_packages(tmp_path):
    nets = _nets(lambda side, pkg: _mlp(pkg, bn=True), seed=10)
    x = ToyDS(8).x
    # JAX saves, the port loads
    jp.seed(11)
    jnet = _mlp(jp, bn=True)
    jnet[1]._mean.set_value(np.arange(16, dtype=np.float32))
    jp.save(jnet.state_dict(), str(tmp_path / "j.pdparams"))
    state = tp.load(str(tmp_path / "j.pdparams"))
    assert isinstance(state["1._mean"], tp.Tensor)
    tnet = nets["torch"]
    tnet.set_state_dict(state)
    jnet.eval()
    tnet.eval()
    np.testing.assert_allclose(_np(tnet(tp.to_tensor(x))),
                               _np(jnet(jp.to_tensor(x))), **TOL)
    # the port's Model saves weights and optimizer state, JAX's Model loads
    tmodel = tp.Model(tnet)
    topt = tp.optimizer.Adam(0.01, parameters=tnet.parameters())
    tmodel.prepare(topt, tp.nn.CrossEntropyLoss())
    tnet.train()
    tmodel.train_batch([x], [ToyDS(8).y])
    tmodel.save(str(tmp_path / "ck" / "t"))
    jmodel = jp.Model(nets["jax"])
    jmodel.prepare(jp.optimizer.Adam(0.01,
                                     parameters=nets["jax"].parameters()),
                   jp.nn.CrossEntropyLoss())
    jmodel.load(str(tmp_path / "ck" / "t"))
    for (k, pt), pj in zip(tnet.state_dict().items(),
                           [nets["jax"].state_dict()[k]
                            for k in tnet.state_dict()]):
        np.testing.assert_array_equal(_np(pj), _np(pt))
    tstate = topt.state_dict()
    jstate = jmodel._optimizer.state_dict()
    assert jstate["@step"] == tstate["@step"] == 1
    moments = [k for k in tstate if k.endswith("moment1")]
    assert moments
    # a fresh port Model loads its own checkpoint, optimizer state too
    tp.seed(12)
    fresh = _mlp(tp, bn=True)
    fmodel = tp.Model(fresh)
    fopt = tp.optimizer.Adam(0.01, parameters=fresh.parameters())
    fmodel.prepare(fopt, tp.nn.CrossEntropyLoss())
    fmodel.load(str(tmp_path / "ck" / "t"))
    for (k, a), b in zip(fresh.state_dict().items(),
                         tnet.state_dict().values()):
        np.testing.assert_array_equal(_np(a), _np(b))
    assert fopt._step_count == 1


def test_unported_save_and_jit_raise(tmp_path):
    """``save(training=False)`` writes the jit.save bundle and
    ``prepare(jit=True)`` wraps the network with to_static."""
    net = _mlp(tp)
    model = tp.Model(net)
    model.save(str(tmp_path / "m"), training=False)
    x = tp.to_tensor(np.random.RandomState(0).randn(4, 8).astype(
        np.float32))
    loaded = tp.jit.load(str(tmp_path / "m"))
    np.testing.assert_array_equal(_np(loaded(x)), _np(net(x)))
    model.prepare(jit=True)
    assert isinstance(model.network.forward_static, tp.jit.StaticFunction)
    np.testing.assert_array_equal(_np(model.network(x)), _np(net(x)))


def test_fit_with_shared_memory_workers_equals_in_process():
    nets = {}
    for k in ("workers", "inline"):
        tp.seed(13)
        nets[k] = _mlp(tp)
    logs = {}
    before = tworker.shm_batches
    for k, workers in (("workers", 2), ("inline", 0)):
        model = tp.Model(nets[k])
        model.prepare(tp.optimizer.Adam(0.01,
                                        parameters=nets[k].parameters()),
                      tp.nn.CrossEntropyLoss(), tp.metric.Accuracy())
        rec = Recorder(tp)
        model.fit(ToyDS(), batch_size=8, epochs=1, verbose=0, shuffle=False,
                  num_workers=workers, callbacks=[rec.cb])
        logs[k] = rec.logs
    assert tworker.shm_batches - before == 4
    _same_logs(logs["inline"], logs["workers"])


SCHEDULES = [
    ("NoamDecay", (64, 5), {}), ("PiecewiseDecay", ([2, 5], [1., .5, .1]), {}),
    ("NaturalExpDecay", (0.5, 0.3), {}), ("InverseTimeDecay", (0.5, 0.3), {}),
    ("PolynomialDecay", (0.5, 6), dict(cycle=True)),
    ("LinearWarmup", (0.5, 4, 0.0, 0.5), {}), ("ExponentialDecay", (1., .9), {}),
    ("MultiStepDecay", (1., [3, 7]), {}), ("StepDecay", (1., 3), {}),
    ("LambdaDecay", (1., lambda e: 0.9 ** e), {}),
    ("MultiplicativeDecay", (1., lambda e: 0.95), {}),
    ("CosineAnnealingDecay", (1., 5), {}),
    ("CosineAnnealingWarmRestarts", (1., 3), dict(T_mult=2)),
    ("OneCycleLR", (1., 10), {}), ("CyclicLR", (0.1, 1.0, 3), {}),
    ("LinearLR", (1., 6), {}), ("ConstantLR", (1.,), {}),
]


@pytest.mark.parametrize("case", SCHEDULES, ids=lambda c: c[0])
def test_lr_schedules_equal_jax(case):
    name, args, kw = case
    vals = {}
    for side, pkg in PKGS.items():
        s = getattr(pkg.optimizer.lr, name)(*args, **kw)
        seq = []
        for _ in range(12):
            seq.append(s())
            s.step()
        vals[side] = (seq, s.state_dict())
    assert vals["torch"] == vals["jax"]


def test_reduce_on_plateau_and_optimizer_state_dict_carry_the_schedule():
    for side, pkg in PKGS.items():
        r = pkg.optimizer.lr.ReduceOnPlateau(1.0, patience=1, factor=0.5)
        for m in (3.0, 3.0, 3.0, 3.0, 1.0):
            r.step(m)
        assert r() == 0.5, side
    w = tp.Parameter(np.ones(3, np.float32))
    sched = tp.optimizer.lr.StepDecay(1.0, 2)
    opt = tp.optimizer.SGD(sched, parameters=[w])
    for _ in range(3):
        sched.step()
    assert opt.get_lr() == 0.1
    with pytest.raises(RuntimeError, match="scheduler"):
        opt.set_lr(0.3)
    sd = opt.state_dict()
    sched2 = tp.optimizer.lr.StepDecay(1.0, 2)
    opt2 = tp.optimizer.SGD(sched2, parameters=[w])
    opt2.set_state_dict(sd)
    assert opt2.get_lr() == 0.1 and sched2.last_epoch == 3


def test_metrics_equal_jax():
    rng = np.random.RandomState(14)
    pred = rng.rand(20, 5).astype(np.float32)
    label = rng.randint(0, 5, (20, 1)).astype(np.int64)
    prob = rng.rand(20).astype(np.float32)
    binary = rng.randint(0, 2, 20).astype(np.int64)
    res = {}
    for side, pkg in PKGS.items():
        acc = pkg.metric.Accuracy(topk=(1, 3))
        for lo in (0, 10):
            acc.update(acc.compute(pkg.to_tensor(pred[lo:lo + 10]),
                                   pkg.to_tensor(label[lo:lo + 10])))
        p, r = pkg.metric.Precision(), pkg.metric.Recall()
        auc = pkg.metric.Auc()
        for m in (p, r):
            m.update(prob, binary)
        auc.update(np.stack([1 - prob, prob], 1), binary)
        top2 = float(pkg.metric.accuracy(pkg.to_tensor(pred),
                                         pkg.to_tensor(label), k=2))
        res[side] = (acc.accumulate(), acc.name(), p.accumulate(),
                     r.accumulate(), auc.accumulate(), top2)
    assert res["torch"] == res["jax"]


def test_summary_counts_equal_jax(capsys):
    nets = _nets(lambda side, pkg: (JLeNet if side == "jax"
                                    else TLeNet)(), seed=15)
    got = {side: PKGS[side].summary(nets[side]) for side in PKGS}
    assert got["torch"] == got["jax"]
    assert got["torch"]["total_params"] == 61610
    assert "Total params: 61,610" in capsys.readouterr().out
