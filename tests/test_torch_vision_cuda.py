"""The vision path and the high-level API on a CUDA card.

* ``jit_train_step`` over a model with BatchNorm: after each of 3 replays
  the running ``_mean`` / ``_variance`` (and the loss and parameters)
  equal an eager loop's from the same weights (f32; the same cuDNN
  kernels, so within 1e-5 relative), and the warm-up run before the
  capture leaves them as they were;
* the same at O1 bf16 (BatchNorm on AMP's f32 list), within 1e-3;
* ``Model.fit`` on the card runs one CUDA graph per input signature
  (replays equal to the steps), and a capture that fails inside
  ``Model.fit`` raises rather than dropping to the eager loop;
* DataLoader workers never initialise CUDA, even when the parent has, and
  the batches arrive on the card with the values of the in-process path;
* an f32 convolution computes in f32 whatever the global TF32 switch says
  (``nn/functional/conv.py``): its forward and gradients equal the CPU's
  within 1e-5 relative.

Every test needs a card and skips without one.  The card machine has no
JAX, so run this file there without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_vision_cuda.py -q
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import paddle_tpu_torch as paddle  # noqa: E402
from paddle_tpu_torch.framework import place as tplace  # noqa: E402
from paddle_tpu_torch.incubate import jit_train_step  # noqa: E402
from paddle_tpu_torch.io import worker as tworker  # noqa: E402
from torch_io_datasets import InfoDS, RangeDS, ToyDS  # noqa: E402

pytestmark = pytest.mark.cuda

F32_REL = 1e-5
O1_REL = 1e-3


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    prev = tplace._current_place
    paddle.set_device("gpu")
    yield
    tplace._current_place = prev


def _net(seed=0):
    paddle.seed(seed)
    nn = paddle.nn
    return nn.Sequential(nn.Conv2D(3, 8, 3, padding=1), nn.BatchNorm2D(8),
                         nn.ReLU(), nn.MaxPool2D(2, 2),
                         nn.Conv2D(8, 8, 3, padding=1, bias_attr=False),
                         nn.BatchNorm2D(8), nn.ReLU(),
                         nn.AdaptiveAvgPool2D(1), _Flat(), nn.Linear(8, 5))


class _Flat(paddle.nn.Layer):
    def forward(self, x):
        return paddle.flatten(x, 1)


def _pair():
    a, b = _net(), _net()
    b.set_state_dict({k: v.numpy() for k, v in a.state_dict().items()})
    return a, b


def _batch(seed):
    rng = np.random.RandomState(seed)
    return (paddle.to_tensor(rng.randn(6, 3, 12, 12).astype(np.float32)),
            paddle.to_tensor(rng.randint(0, 5, (6,)).astype(np.int64)))


def _stats(net):
    return [b.numpy().copy() for b in net.buffers()]


def _rel(a, b):
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-12))


@pytest.mark.parametrize("amp", ["O0", "O1"])
def test_batchnorm_buffers_after_replays_equal_the_eager_loop(card, amp):
    graphed, eager = _pair()
    ce = paddle.nn.CrossEntropyLoss()
    opt_g = paddle.optimizer.Momentum(0.05, parameters=graphed.parameters())
    opt_e = paddle.optimizer.Momentum(0.05, parameters=eager.parameters())
    step = jit_train_step(graphed, ce, opt_g, amp_level=amp)
    bound = F32_REL if amp == "O0" else O1_REL
    for i in range(3):
        x, y = _batch(i)
        loss_g = float(step(x, y))
        with paddle.amp.auto_cast(enable=amp == "O1", level="O1"):
            loss_e = ce(eager(x), y)
        loss_e.backward()
        opt_e.step()
        opt_e.clear_grad()
        assert abs(loss_g - float(loss_e)) <= bound * abs(float(loss_e))
        for g, e in zip(_stats(graphed), _stats(eager)):
            assert _rel(g, e) <= bound, (i, _rel(g, e))
    assert [g.replays for g in step.graphs()] == [3]
    for pg, pe in zip(graphed.parameters(), eager.parameters()):
        assert _rel(pg.numpy(), pe.numpy()) <= bound


def test_a_rebound_buffer_is_read_by_the_next_replay(card):
    net, _ = _pair()
    ce = paddle.nn.CrossEntropyLoss()
    step = jit_train_step(net, ce, paddle.optimizer.SGD(
        0.0, parameters=net.parameters()))
    x, y = _batch(0)
    step(x, y)
    bn = net[1]
    bn._mean = paddle.to_tensor(np.full(8, 5.0, np.float32))   # rebinds
    step(x, y)
    stats = bn._mean.numpy()
    # 0.9 of the value set between the steps, 0.1 of the batch's mean
    assert np.all(stats > 4.0), stats
    assert [g.replays for g in step.graphs()] == [2]


def test_model_fit_on_the_card_replays_one_graph(card):
    net = _net(1)
    model = paddle.Model(net)
    model.prepare(paddle.optimizer.Adam(1e-2, parameters=net.parameters()),
                  paddle.nn.CrossEntropyLoss(), paddle.metric.Accuracy())

    class Imgs(paddle.io.Dataset):
        def __len__(self):
            return 24

        def __getitem__(self, i):
            rng = np.random.RandomState(i)
            return (rng.randn(3, 12, 12).astype(np.float32),
                    np.int64(i % 5))

    model.fit(Imgs(), batch_size=6, epochs=2, verbose=0, shuffle=False)
    graphs = model._adapter._jit_step.graphs()
    assert [g.replays for g in graphs] == [8]
    res = model.evaluate(Imgs(), batch_size=6, verbose=0)
    assert np.isfinite(res["loss"][0])


def test_a_failed_capture_inside_fit_raises(card):
    class HostRead(paddle.nn.Layer):
        def __init__(self):
            super().__init__()
            self.fc = paddle.nn.Linear(8, 2)

        def forward(self, x):
            out = self.fc(x)
            float(out.sum())            # a host read: illegal in a capture
            return out

    net = HostRead()
    model = paddle.Model(net)
    opt = paddle.optimizer.SGD(0.1, parameters=net.parameters())
    model.prepare(opt, paddle.nn.CrossEntropyLoss())
    before = [p.numpy().copy() for p in net.parameters()]
    with pytest.raises(Exception):
        model.fit(ToyDS(), batch_size=8, epochs=1, verbose=0)
    assert model._adapter._jit_step is not None
    assert opt._step_count == 0
    for p, b in zip(net.parameters(), before):
        np.testing.assert_array_equal(p.numpy(), b)
    # the framework's generator still draws after the failed capture
    paddle.seed(0)
    paddle.randn([2])


def test_workers_never_initialise_cuda_and_batches_reach_the_card(card):
    torch.zeros(1, device="cuda")       # the parent's context is up
    assert torch.cuda.is_initialized()
    before = tworker.shm_batches
    got = list(paddle.io.DataLoader(InfoDS(24), batch_size=8, num_workers=2))
    assert tworker.shm_batches - before == 3
    info = np.concatenate([b[2].numpy() for b in got])
    assert not info[:, 2].any(), "a worker initialised CUDA"
    single = list(paddle.io.DataLoader(RangeDS(24), batch_size=8))
    for (x, y, _), (x1, y1) in zip(got, single):
        assert x._data.is_cuda and y._data.is_cuda
        np.testing.assert_array_equal(x.numpy(), x1.numpy())
        np.testing.assert_array_equal(y.numpy(), y1.numpy())


def test_f32_conv_is_f32_whatever_the_tf32_switch(card):
    rng = np.random.RandomState(3)
    x = rng.randn(4, 16, 20, 20).astype(np.float32)
    w = rng.randn(32, 16, 3, 3).astype(np.float32)
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        outs = {}
        for dev in ("cpu", "gpu"):
            paddle.set_device(dev)
            xt = paddle.to_tensor(x, stop_gradient=False)
            wt = paddle.to_tensor(w, stop_gradient=False)
            out = paddle.nn.functional.conv2d(xt, wt, padding=1)
            (out * out).sum().backward()
            outs[dev] = (out.numpy(), xt.grad.numpy(), wt.grad.numpy())
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    for a, b in zip(outs["gpu"], outs["cpu"]):
        assert _rel(a, b) <= F32_REL, _rel(a, b)
