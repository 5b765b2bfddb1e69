"""vision's nine other model families on the port, held against
paddle_tpu's on the CPU.

For each family's smallest member, JAX's model is built and its
``state_dict()`` carried across unchanged into the port's model
(``layer_state_from_jax``: the same parameter and buffer names and
shapes); the eval-mode logits of both on the same seeded input then agree
within 1e-4 of their largest element (tens of f32 layers of sums taken in
another order).  The input is the smallest the architecture takes
(GoogLeNet's aux heads need a 13 x 13 map at inception 4a, so 192 px;
the rest run at 32 to 75 px).

JAX compiles each eager op per shape, which made a model's build and
first forward take 10 to 55 s here.  So JAX's model is built under
``set_global_initializer`` with a numpy draw (He-normal weights, BatchNorm
scales near 1: JAX's own hook, and any weights serve since both packages
get the same ones), and JAX's forward runs through its own
``incubate.jit_eval_step`` (one XLA program).  ``pretrained=True`` raises
as JAX's does.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import paddle_tpu as jp  # noqa: E402
import paddle_tpu_torch as tp  # noqa: E402
from paddle_tpu.vision import models as jm  # noqa: E402
from paddle_tpu_torch.framework import place as tplace  # noqa: E402
from paddle_tpu_torch.models.weights import layer_state_from_jax  # noqa
from paddle_tpu_torch.vision import models as tm  # noqa: E402

REL = 1e-4

# (constructor, kwargs, input size): each family's smallest member
FAMILIES = {
    "vgg": ("vgg11", dict(num_classes=10), 32),
    "mobilenet_v1": ("mobilenet_v1", dict(num_classes=10, scale=0.25), 32),
    "mobilenet_v2": ("mobilenet_v2", dict(num_classes=10, scale=0.25), 32),
    "mobilenet_v3": ("mobilenet_v3_small", dict(num_classes=10), 32),
    "alexnet": ("alexnet", dict(num_classes=10), 64),
    "squeezenet": ("squeezenet1_1", dict(num_classes=10), 48),
    "densenet": ("densenet121", dict(num_classes=10), 32),
    "googlenet": ("googlenet", dict(num_classes=10), 192),
    "inceptionv3": ("inception_v3", dict(num_classes=10), 75),
    "shufflenetv2": ("shufflenet_v2_x0_25", dict(num_classes=10), 32),
}


@pytest.fixture(scope="module", autouse=True)
def _cpu():
    prev = tplace._current_place
    tp.set_device("cpu")
    yield
    tplace._current_place = prev


class _NumpyInit:
    """He-normal draws from a seeded numpy stream (1-D weights near 1,
    biases near 0), for JAX's ``set_global_initializer``."""

    def __init__(self, rng, bias):
        self.rng, self.bias = rng, bias

    def __call__(self, shape, dtype):
        shape = tuple(int(s) for s in shape)
        if self.bias:
            v = 0.1 * self.rng.randn(*shape)
        elif len(shape) == 1:
            v = 1.0 + 0.1 * self.rng.randn(*shape)
        else:
            fan_in = shape[0] if len(shape) == 2 else \
                int(np.prod(shape[1:]))
            v = self.rng.randn(*shape) * np.sqrt(2.0 / fan_in)
        return v.astype(np.float32)


@pytest.fixture
def jax_numpy_init():
    from paddle_tpu.nn import initializer as JI
    rng = np.random.RandomState(7)
    JI.set_global_initializer(_NumpyInit(rng, False), _NumpyInit(rng, True))
    yield
    JI.set_global_initializer(None, None)


def _jax_eval(net, x):
    from paddle_tpu.incubate.jit_train import jit_eval_step
    return jit_eval_step(net)(jp.to_tensor(x))


def _close_rel(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    scale = max(float(np.abs(b).max()), 1e-12)
    gap = float(np.abs(a - b).max()) / scale
    assert gap <= REL, f"{what}: {gap} > {REL}"


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_family_logits_match_jax_with_jax_weights(family, jax_numpy_init):
    ctor, kw, hw = FAMILIES[family]
    jnet = getattr(jm, ctor)(**kw)
    tnet = getattr(tm, ctor)(**kw)
    jstate = jnet.state_dict()
    assert list(tnet.state_dict()) == list(jstate)
    layer_state_from_jax(tnet, jstate)
    jnet.eval()
    tnet.eval()
    x = np.random.RandomState(3).randn(2, 3, hw, hw).astype(np.float32)
    jout, tout = _jax_eval(jnet, x), tnet(tp.to_tensor(x))
    jouts = jout if isinstance(jout, (list, tuple)) else [jout]
    touts = tout if isinstance(tout, (list, tuple)) else [tout]
    assert len(jouts) == len(touts)
    for i, (a, b) in enumerate(zip(touts, jouts)):
        assert a.dtype.name == b.dtype.name
        _close_rel(a.numpy(), b.numpy(), f"{family} output {i}")


@pytest.mark.parametrize("ctor", ["mobilenet_v3_large", "vgg16",
                                  "densenet121", "googlenet",
                                  "inception_v3", "shufflenet_v2_x1_0",
                                  "squeezenet1_0", "alexnet",
                                  "mobilenet_v1", "mobilenet_v2"])
def test_pretrained_raises_as_jax(ctor):
    errors = []
    for mods in (jm, tm):
        with pytest.raises(Exception) as e:
            getattr(mods, ctor)(pretrained=True)
        errors.append(type(e.value))
    assert errors[1] is errors[0]


def test_models_all_is_jax_all():
    assert tm.__all__ == jm.__all__


def test_channel_shuffle_interleaves_like_jax():
    from paddle_tpu.vision.models.shufflenetv2 import channel_shuffle as jcs
    from paddle_tpu_torch.vision.models.shufflenetv2 import \
        channel_shuffle as tcs
    x = np.arange(2 * 12 * 2 * 2, dtype=np.float32).reshape(2, 12, 2, 2)
    for g in (2, 3, 4):
        np.testing.assert_array_equal(tcs(tp.to_tensor(x), g).numpy(),
                                      jcs(jp.to_tensor(x), g).numpy())

