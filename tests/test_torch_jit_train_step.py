"""The port's ``incubate.jit_train_step`` / ``jit_eval_step`` and gradient
clips held against paddle_tpu's.

Each case of tests/test_jit_train_step.py runs through both packages: the
same network (JAX draws it, the port loads its ``state_dict()``), the same
batches, the step built from each package's own optimizer.  On the CPU the
port's step runs eagerly (the captured CUDA graph is the card's; its tests
are in tests/test_torch_jit_train_cuda.py).  Tolerances: losses and
parameters within 1e-5 of JAX's compiled step and of the port's eager loop
(f32, a few ops summed in another order; the clip lanes 1e-4, JAX's own
bound between its compiled and eager clip formulas); AMP O1 within 2e-2
of JAX's O1 (bf16 products).  Dropout's bits differ from ``jax.random``'s:
its cases hold the port to JAX's properties (a fresh mask every step, the
same masks after the same seed).  The BERT QA lane (tests/
test_jit_train_step.py:251) runs at its tiny size with dropout 0 against
JAX's compiled loss trajectory.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import paddle_tpu as jp  # noqa: E402
import paddle_tpu_torch as tp  # noqa: E402
from paddle_tpu.incubate.jit_train import jit_eval_step as j_eval  # noqa
from paddle_tpu.incubate.jit_train import jit_train_step as j_step  # noqa
from paddle_tpu_torch.framework import place as tplace  # noqa: E402
from paddle_tpu_torch.incubate import jit_eval_step as t_eval  # noqa: E402
from paddle_tpu_torch.incubate import jit_train_step as t_step  # noqa
from paddle_tpu_torch.models.weights import layer_state_from_jax  # noqa

TOL = dict(rtol=1e-5, atol=1e-5)
CLIP_TOL = dict(rtol=1e-4, atol=1e-4)
PKGS = {"jax": jp, "torch": tp}


@pytest.fixture(scope="module", autouse=True)
def _cpu():
    prev = tplace._current_place
    prev_flag = jp.get_flags("FLAGS_pallas_flash_attention")
    tp.set_device("cpu")
    jp.set_flags({"FLAGS_pallas_flash_attention": False})
    yield
    jp.set_flags(prev_flag)
    tplace._current_place = prev


def _np(t):
    return np.asarray(t.numpy())


def _net(pkg, seed=7, hidden=16):
    pkg.seed(seed)
    nn = pkg.nn
    return nn.Sequential(nn.Linear(6, hidden), nn.Tanh(),
                         nn.Linear(hidden, 3))


def _nets(seed=7, hidden=16):
    """JAX's network and the port's with its weights."""
    jn = _net(jp, seed, hidden)
    tn = _net(tp, seed, hidden)
    layer_state_from_jax(tn, jn.state_dict())
    return {"jax": jn, "torch": tn}


def _data(seed, n=16):
    rng = np.random.RandomState(seed)
    return (rng.randn(n, 6).astype(np.float32),
            rng.randint(0, 3, (n,)).astype(np.int64))


def _t(pkg, *arrays):
    return [pkg.to_tensor(a) for a in arrays]


def _params(net):
    return [_np(p) for p in net.parameters()]


def _close_params(a, b, tol=TOL):
    for x, y in zip(_params(a), _params(b)):
        np.testing.assert_allclose(x, y, **tol)


@pytest.mark.parametrize("opt_name,kw", [("SGD", {}),
                                         ("Momentum", {"momentum": 0.9}),
                                         ("AdamW", {})])
def test_jit_step_matches_jax_and_the_eager_loop(opt_name, kw):
    xa, ya = _data(0)
    nets, eager = _nets(), _nets()["torch"]
    losses = {}
    for k, pkg in PKGS.items():
        opt = getattr(pkg.optimizer, opt_name)(
            learning_rate=0.05, parameters=nets[k].parameters(), **kw)
        step = (j_step if k == "jax" else t_step)(
            nets[k], pkg.nn.CrossEntropyLoss(), opt)
        x, y = _t(pkg, xa, ya)
        losses[k] = [float(step(x, y)) for _ in range(5)]
    opt_e = getattr(tp.optimizer, opt_name)(
        learning_rate=0.05, parameters=eager.parameters(), **kw)
    x, y = _t(tp, xa, ya)
    le = []
    for _ in range(5):
        loss = tp.nn.CrossEntropyLoss()(eager(x), y)
        le.append(float(loss))
        loss.backward()
        opt_e.step()
        opt_e.clear_grad()
    np.testing.assert_allclose(losses["torch"], losses["jax"], **TOL)
    np.testing.assert_allclose(losses["torch"], le, **TOL)
    _close_params(nets["torch"], nets["jax"])
    _close_params(nets["torch"], eager)


def test_global_norm_clip_matches_jax_compiled_and_eager():
    xa, ya = _data(1, 8)
    jit_nets, eager_nets = _nets(), _nets()
    for k, pkg in PKGS.items():
        x, y = _t(pkg, xa, ya)
        ce = pkg.nn.CrossEntropyLoss()
        opt_j = pkg.optimizer.SGD(
            learning_rate=0.5, parameters=jit_nets[k].parameters(),
            grad_clip=pkg.nn.ClipGradByGlobalNorm(0.1))
        opt_e = pkg.optimizer.SGD(
            learning_rate=0.5, parameters=eager_nets[k].parameters(),
            grad_clip=pkg.nn.ClipGradByGlobalNorm(0.1))
        step = (j_step if k == "jax" else t_step)(jit_nets[k], ce, opt_j)
        for _ in range(4):
            step(x, y)
            loss = ce(eager_nets[k](x), y)
            loss.backward()
            opt_e.step()
            opt_e.clear_grad()
    _close_params(jit_nets["torch"], jit_nets["jax"], TOL)
    _close_params(eager_nets["torch"], eager_nets["jax"], TOL)
    _close_params(jit_nets["torch"], eager_nets["torch"], CLIP_TOL)


@pytest.mark.parametrize("clip", ["value", "norm"])
def test_jit_step_rejects_other_clips(clip):
    net = _net(tp)
    c = tp.nn.ClipGradByValue(0.1) if clip == "value" else \
        tp.nn.ClipGradByNorm(0.1)
    opt = tp.optimizer.SGD(learning_rate=0.1, parameters=net.parameters(),
                           grad_clip=c)
    with pytest.raises(NotImplementedError):
        t_step(net, tp.nn.CrossEntropyLoss(), opt)


@pytest.mark.parametrize("clip", ["value", "norm", "global_norm"])
def test_each_eager_clip_matches_jax(clip):
    """Each clip class in the eager optimizer step, with one parameter's
    ``need_clip`` off, against JAX's eager clip."""
    xa, ya = _data(2, 8)
    nets = _nets()
    for k, pkg in PKGS.items():
        nn = pkg.nn
        c = {"value": lambda: nn.ClipGradByValue(0.05, min=-0.02),
             "norm": lambda: nn.ClipGradByNorm(0.05),
             "global_norm": lambda: nn.ClipGradByGlobalNorm(0.05)}[clip]()
        params = nets[k].parameters()
        params[1].need_clip = False
        opt = pkg.optimizer.SGD(learning_rate=0.5, parameters=params,
                                grad_clip=c)
        x, y = _t(pkg, xa, ya)
        for _ in range(3):
            loss = nn.CrossEntropyLoss()(nets[k](x), y)
            loss.backward()
            opt.step()
            opt.clear_grad()
    _close_params(nets["torch"], nets["jax"])


def test_clip_grad_norm_and_value_functions_match_jax():
    xa, ya = _data(3, 8)
    nets = _nets()
    out = {}
    from paddle_tpu.nn import clip as jclip
    for k, pkg in PKGS.items():
        clip = jclip if k == "jax" else pkg.nn
        x, y = _t(pkg, xa, ya)
        pkg.nn.CrossEntropyLoss()(nets[k](x), y).backward()
        params = nets[k].parameters()
        total = clip.clip_grad_norm_(params[:2], max_norm=0.05)
        inf_total = clip.clip_grad_norm_(params[2:], max_norm=0.01,
                                         norm_type=float("inf"))
        clip.clip_grad_value_(params[2:], 0.003)
        out[k] = (float(total), float(inf_total),
                  [_np(p.grad) for p in params])
    np.testing.assert_allclose(out["torch"][0], out["jax"][0], **TOL)
    np.testing.assert_allclose(out["torch"][1], out["jax"][1], **TOL)
    for a, b in zip(out["torch"][2], out["jax"][2]):
        np.testing.assert_allclose(a, b, **TOL)


def test_jit_step_syncs_the_optimizer_state_dict():
    xa, ya = _data(2, 8)
    nets = _nets()
    sds = {}
    for k, pkg in PKGS.items():
        opt = pkg.optimizer.AdamW(learning_rate=0.01,
                                  parameters=nets[k].parameters())
        step = (j_step if k == "jax" else t_step)(
            nets[k], pkg.nn.CrossEntropyLoss(), opt)
        x, y = _t(pkg, xa, ya)
        for _ in range(3):
            step(x, y)
        sds[k] = (opt.state_dict(), [p.name for p in nets[k].parameters()])
    tsd, tnames = sds["torch"]
    jsd, jnames = sds["jax"]
    assert tsd["@step"] == 3 == jsd["@step"]
    keys = ("moment1", "moment2", "beta1_pow", "beta2_pow")
    for tn, jn in zip(tnames, jnames):
        for key in keys:
            t, j = tsd[f"{tn}.{key}"], jsd[f"{jn}.{key}"]
            np.testing.assert_allclose(_np(t), np.asarray(_np(j)), **TOL)
    assert float(np.abs(_np(tsd[f"{tnames[0]}.moment1"])).sum()) > 0


def test_amp_o1_trains_and_matches_jax_o1():
    xa, ya = _data(3)
    out = {}
    for k, pkg in PKGS.items():
        build = j_step if k == "jax" else t_step
        net_a, net_f = _net(pkg), _net(pkg)
        if k == "torch":
            layer_state_from_jax(net_a, _net(jp).state_dict())
            layer_state_from_jax(net_f, _net(jp).state_dict())
        ce = pkg.nn.CrossEntropyLoss()
        step_a = build(net_a, ce, pkg.optimizer.SGD(
            learning_rate=0.05, parameters=net_a.parameters()),
            amp_level="O1")
        step_f = build(net_f, ce, pkg.optimizer.SGD(
            learning_rate=0.05, parameters=net_f.parameters()))
        x, y = _t(pkg, xa, ya)
        la = [float(step_a(x, y)) for _ in range(10)]
        lf = [float(step_f(x, y)) for _ in range(10)]
        out[k] = (la, lf)
    la, lf = out["torch"]
    assert abs(la[-1] - lf[-1]) < 0.05, (la, lf)
    assert la[-1] < 1.2
    np.testing.assert_allclose(la, out["jax"][0], rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(lf, out["jax"][1], **TOL)


@pytest.mark.parametrize("level,dtype", [("O2", "bfloat16"),
                                         ("O1", "float16")])
def test_jit_step_rejects_o2_and_float16(level, dtype):
    net = _net(tp)
    opt = tp.optimizer.SGD(learning_rate=0.1, parameters=net.parameters())
    with pytest.raises(NotImplementedError):
        t_step(net, tp.nn.CrossEntropyLoss(), opt, amp_level=level,
               amp_dtype=dtype)


def test_jit_step_updates_only_the_optimizers_parameters():
    xa, ya = _data(4, 8)
    nets = _nets()
    res = {}
    for k, pkg in PKGS.items():
        net = nets[k]
        backbone, head = net[0], net[2]
        opt = pkg.optimizer.AdamW(learning_rate=0.05,
                                  parameters=head.parameters())
        step = (j_step if k == "jax" else t_step)(
            net, pkg.nn.CrossEntropyLoss(), opt)
        w_b, w_h = _np(backbone.weight).copy(), _np(head.weight).copy()
        x, y = _t(pkg, xa, ya)
        for _ in range(3):
            step(x, y)
        np.testing.assert_array_equal(_np(backbone.weight), w_b)
        assert not np.allclose(_np(head.weight), w_h)
        res[k] = _np(head.weight)
    np.testing.assert_allclose(res["torch"], res["jax"], **TOL)


def test_an_unreached_parameter_gets_a_zero_gradient_and_is_decayed():
    """JAX's rule: every parameter of the model that the optimizer holds
    moves each step; one the loss never reaches has a zero gradient, and
    AdamW decays it."""
    xa, ya = _data(5, 8)
    models = {}
    for k, pkg in PKGS.items():
        class WithSpare(pkg.nn.Layer):
            def __init__(self):
                super().__init__()
                self.net = _net(pkg)
                self.spare = pkg.nn.Linear(4, 4)

            def forward(self, x):
                return self.net(x)

        models[k] = WithSpare()
    layer_state_from_jax(models["torch"], models["jax"].state_dict())
    res = {}
    for k, pkg in PKGS.items():
        m = models[k]
        opt = pkg.optimizer.AdamW(learning_rate=0.1, weight_decay=0.5,
                                  parameters=m.parameters())
        w0 = _np(m.spare.weight).copy()
        step = (j_step if k == "jax" else t_step)(
            m, pkg.nn.CrossEntropyLoss(), opt)
        x, y = _t(pkg, xa, ya)
        step(x, y)
        np.testing.assert_allclose(_np(m.spare.weight),
                                   w0 * (1 - 0.1 * 0.5), rtol=1e-6)
        res[k] = _np(m.spare.weight)
    np.testing.assert_allclose(res["torch"], res["jax"], **TOL)
    _close_params(models["torch"], models["jax"])


def _dropout_net(pkg, hidden):
    nn = pkg.nn
    return nn.Sequential(nn.Linear(6, hidden), nn.Dropout(0.5),
                         nn.Linear(hidden, 3))


def test_dropout_resamples_every_step():
    tp.seed(21)
    net = _dropout_net(tp, 64)
    net.train()
    opt = tp.optimizer.SGD(learning_rate=0.0, parameters=net.parameters())
    step = t_step(net, tp.nn.CrossEntropyLoss(), opt)
    x, y = _t(tp, *_data(5))
    losses = [float(step(x, y)) for _ in range(4)]
    assert len({round(v, 8) for v in losses}) > 1, losses


def test_dropout_is_seed_deterministic():
    x, y = _t(tp, *_data(6, 8))

    def run():
        tp.seed(99)
        net = _dropout_net(tp, 32)
        net.train()
        opt = tp.optimizer.SGD(learning_rate=0.0,
                               parameters=net.parameters())
        step = t_step(net, tp.nn.CrossEntropyLoss(), opt)
        return [float(step(x, y)) for _ in range(3)]

    first = run()
    assert first == run()
    assert len(set(first)) > 1


def test_tuple_inputs_and_labels_match_jax():
    rng = np.random.RandomState(7)
    a, b = rng.randn(8, 6).astype(np.float32), rng.randn(8, 6).astype(
        np.float32)
    y1, y2 = rng.randn(8, 4).astype(np.float32), rng.randn(8, 4).astype(
        np.float32)
    out, nets = {}, {}
    for k, pkg in PKGS.items():
        class TwoIn(pkg.nn.Layer):
            def __init__(self):
                super().__init__()
                self.fc = pkg.nn.Linear(6, 4)

            def forward(self, u, v):
                return self.fc(u) + self.fc(v)

        pkg.seed(31)
        nets[k] = TwoIn()
    layer_state_from_jax(nets["torch"], nets["jax"].state_dict())
    for k, pkg in PKGS.items():
        net = nets[k]
        opt = pkg.optimizer.SGD(learning_rate=0.05,
                                parameters=net.parameters())

        def loss_fn(o, ys):
            return ((o - ys[0]) ** 2).mean() + ((o - ys[1]) ** 2).mean()

        step = (j_step if k == "jax" else t_step)(net, loss_fn, opt,
                                                  return_outputs=True)
        ta, tb, t1, t2 = _t(pkg, a, b, y1, y2)
        res = [step((ta, tb), (t1, t2)) for _ in range(11)]
        out[k] = (None, [float(r[0]) for r in res], _np(res[-1][1]))
    lt = out["torch"][1]
    assert lt[-1] < lt[0]
    np.testing.assert_allclose(lt, out["jax"][1], **TOL)
    np.testing.assert_allclose(out["torch"][2], out["jax"][2], **TOL)


def test_a_rebound_buffer_is_written_back():
    """A forward that rebinds a buffer (a running mean) leaves the new
    value in the buffer after the step, as the eager loop does."""
    class Running(tp.nn.Layer):
        def __init__(self):
            super().__init__()
            self.fc = tp.nn.Linear(6, 3)
            self.register_buffer("mean", tp.zeros([6]))

        def forward(self, x):
            self.mean = self.mean * 0.5 + x.mean(axis=0) * 0.5
            return self.fc(x - self.mean)

    net, eager = Running(), Running()
    eager.set_state_dict(net.state_dict())
    opt = tp.optimizer.SGD(learning_rate=0.1, parameters=net.parameters())
    opt_e = tp.optimizer.SGD(learning_rate=0.1,
                             parameters=eager.parameters())
    storage = net.mean._data
    step = t_step(net, tp.nn.CrossEntropyLoss(), opt)
    x, y = _t(tp, *_data(8, 8))
    for _ in range(3):
        step(x, y)
        loss = tp.nn.CrossEntropyLoss()(eager(x), y)
        loss.backward()
        opt_e.step()
        opt_e.clear_grad()
    assert net.mean._data is storage
    np.testing.assert_allclose(_np(net.mean), _np(eager.mean), **TOL)
    _close_params(net, eager)


def test_an_lr_change_between_steps_takes_effect():
    xa, ya = _data(9, 8)
    nets = _nets()
    for k, pkg in PKGS.items():
        opt = pkg.optimizer.AdamW(learning_rate=0.01,
                                  parameters=nets[k].parameters())
        step = (j_step if k == "jax" else t_step)(
            nets[k], pkg.nn.CrossEntropyLoss(), opt)
        x, y = _t(pkg, xa, ya)
        step(x, y)
        opt.set_lr(0.0)
        before = _params(nets[k])
        step(x, y)
        for a, b in zip(before, _params(nets[k])):
            np.testing.assert_array_equal(a, b)
        opt.set_lr(0.03)
        step(x, y)
    _close_params(nets["torch"], nets["jax"])


def test_jit_eval_step_matches_jax_and_raises_on_a_mode_flip():
    nets = _nets()
    xa, _ = _data(10, 8)
    outs = {}
    for k, pkg in PKGS.items():
        nets[k].eval()
        fwd = (j_eval if k == "jax" else t_eval)(nets[k])
        outs[k] = _np(fwd(pkg.to_tensor(xa)))
        nets[k].train()
        with pytest.raises(RuntimeError, match="mode"):
            fwd(pkg.to_tensor(xa))
    np.testing.assert_allclose(outs["torch"], outs["jax"], **TOL)


def test_jit_eval_step_leaves_the_training_stream_alone():
    x = tp.to_tensor(_data(11, 8)[0])
    tp.seed(5)
    net = _dropout_net(tp, 32)
    net.train()
    fwd = t_eval(net)
    a = _np(fwd(x))
    assert (a != _np(fwd(x))).any()          # its own stream moves on
    tp.seed(5)
    ref = _np(tp.nn.functional.dropout(tp.ones([64, 64]), 0.5))
    tp.seed(5)
    fwd(x)
    np.testing.assert_array_equal(
        _np(tp.nn.functional.dropout(tp.ones([64, 64]), 0.5)), ref)


def test_bert_qa_lane_matches_jax_compiled_losses():
    """tests/test_jit_train_step.py:251 at its size, dropout 0: SGD steps
    of the compiled QA fine-tune in both packages, each against its own
    eager loop; then O1 AdamW steps against JAX's O1."""
    from paddle_tpu.models.bert import BertConfig as JC
    from paddle_tpu.models.bert import BertForQuestionAnswering as JQA
    from paddle_tpu_torch.models.bert import BertConfig as TC
    from paddle_tpu_torch.models.bert import BertForQuestionAnswering as TQA
    kw = dict(vocab_size=128, hidden_size=32, num_hidden_layers=2,
              num_attention_heads=2, intermediate_size=64,
              max_position_embeddings=64, dropout_prob=0.0)
    rng = np.random.RandomState(8)
    ids = rng.randint(0, 128, (4, 16)).astype(np.int64)
    tt = np.zeros((4, 16), np.int64)
    mask = np.ones((4, 16), np.float32)
    start = rng.randint(0, 16, (4,)).astype(np.int64)
    end = rng.randint(0, 16, (4,)).astype(np.int64)
    jp.seed(56)
    jnet = JQA(JC(**kw))
    out = {}
    for amp in ("O0", "O1"):
        for k, pkg in PKGS.items():
            if k == "jax":
                net = JQA(JC(**kw))
            else:
                net = TQA(TC(**kw))
            layer_state_from_jax(net, jnet.state_dict()) if k == "torch" \
                else net.set_state_dict(jnet.state_dict())
            ce = pkg.nn.CrossEntropyLoss()

            def qa_loss(o, ys, ce=ce):
                return (ce(o[0], ys[0]) + ce(o[1], ys[1])) * 0.5

            opt = pkg.optimizer.SGD(learning_rate=0.05,
                                    parameters=net.parameters()) \
                if amp == "O0" else pkg.optimizer.AdamW(
                    learning_rate=5e-3, parameters=net.parameters())
            step = (j_step if k == "jax" else t_step)(net, qa_loss, opt,
                                                      amp_level=amp)
            xs = tuple(_t(pkg, ids, tt, mask))
            ys = tuple(_t(pkg, start, end))
            out[(amp, k)] = [float(step(xs, ys)) for _ in range(3)]
    np.testing.assert_allclose(out[("O0", "torch")], out[("O0", "jax")],
                               **TOL)
    np.testing.assert_allclose(out[("O1", "torch")], out[("O1", "jax")],
                               rtol=2e-2, atol=2e-2)
    assert out[("O1", "torch")][-1] < out[("O1", "torch")][0]


def test_a_renewed_generator_keeps_its_stream():
    """``framework.random.renew_generator`` (what a failed capture calls)
    replaces the device's generator by one at the same state."""
    from paddle_tpu_torch.framework import random as trandom
    tp.seed(13)
    a = trandom.generator("cpu")
    first = torch.rand(4, generator=a)
    want = torch.rand(4, generator=a)
    tp.seed(13)
    torch.rand(4, generator=trandom.generator("cpu"))
    b = trandom.renew_generator("cpu")
    assert b is not a and b is trandom.generator("cpu")
    assert torch.equal(torch.rand(4, generator=b), want)
    assert not torch.equal(first, want)
