"""The port's public surface against paddle_tpu's, for the namespaces the
tensor-op slice completes: the top level, ``paddle.linalg``, Tensor's
methods, nn's activation layers, nn.functional's activations and
``vision.models``; and for those the nn slice completes: ``nn``,
``nn.functional`` and ``nn.initializer``, whole.

JAX's public names (``dir()``, submodules left out) minus the port's must
be exactly a named remainder, and each remaining name maps to the
ROADMAP.md queue 1 item that holds it: the top level keeps
``DataParallel`` (item 9(a)), present in the port as a function that
raises ``NotImplementedError`` naming its item (``enable_static`` /
``disable_static`` set JAX's mode flag).  The
port's names that JAX lacks are named too (the port's own helpers).
``jit``, ``static`` and ``inference`` carry JAX's ``__all__`` exactly.
"""

import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import paddle_tpu as jp  # noqa: E402
import paddle_tpu.nn.functional as JF  # noqa: E402
import paddle_tpu_torch as tp  # noqa: E402
import paddle_tpu_torch.nn.functional as TF  # noqa: E402
from paddle_tpu.nn.layer import activation as jact  # noqa: E402
from paddle_tpu_torch.framework import place as tplace  # noqa: E402
from paddle_tpu.tensor import linalg as jlinalg  # noqa: E402


@pytest.fixture(autouse=True)
def _cpu():
    prev = tplace._current_place
    tp.set_device("cpu")
    yield
    tplace._current_place = prev


def _public(mod):
    return {n for n in dir(mod) if not n.startswith("_") and
            not isinstance(getattr(mod, n), types.ModuleType)}


# name -> the ROADMAP.md queue 1 item that holds it
TOP_REMAINDER = {"DataParallel": "9(a)"}
# JAX's nn.functional activation block and its in-place aliases
JAX_F_ACTIVATIONS = JF.__all__[:JF.__all__.index("linear")] + [
    "elu_", "hardtanh_", "leaky_relu_", "softmax_", "tanh_",
    "thresholded_relu_"]
# JAX's public names that are its modules' imports leaking through dir(),
# not API: the port's modules do not import them at the top
LEAKED = {
    "nn.functional": {"Optional": "typing import", "Sequence":
                      "typing import", "Union": "typing import",
                      "Tensor": "the Tensor class imported for isinstance",
                      "wrap_array": "the array wrapper imported for ops"},
    "nn.initializer": {"Optional": "typing import",
                       "Tensor": "the Tensor class imported for Assign"},
}
# the port's own names beyond JAX's in the namespaces held here
PORT_ONLY = {
    "top": set(),
    "Tensor": set(),
    "vision.models": {"BasicBlock", "BottleneckBlock"},
}


def test_top_level_misses_only_the_named_remainder():
    # the port's ``flags`` is its flags module, which reads and sets the
    # flags as attributes as JAX's ``flags`` view does
    missing = {n for n in _public(jp) if not hasattr(tp, n)}
    assert missing == set(), sorted(missing)
    assert _public(tp) - set(dir(jp)) == PORT_ONLY["top"]
    tp.flags.FLAGS_check_nan_inf_level = 1
    assert tp.get_flags("FLAGS_check_nan_inf_level") == {
        "FLAGS_check_nan_inf_level": 1}
    tp.flags.FLAGS_check_nan_inf_level = 0
    for name, item in TOP_REMAINDER.items():
        with pytest.raises(NotImplementedError, match=item.replace(
                "(", r"\(").replace(")", r"\)")):
            getattr(tp, name)(tp.nn.Linear(2, 2))
    # the static mode flag, as JAX's
    for pkg in (jp, tp):
        assert pkg.in_dynamic_mode()
        pkg.enable_static()
        assert not pkg.in_dynamic_mode()
        pkg.disable_static()
        assert pkg.in_dynamic_mode()


@pytest.mark.parametrize("ns", ["jit", "static", "inference"])
def test_deployment_namespaces_carry_jax_all(ns):
    import importlib
    jmod = importlib.import_module(f"paddle_tpu.{ns}")
    tmod = getattr(tp, ns)
    assert tmod.__all__ == jmod.__all__
    missing = [n for n in jmod.__all__ if not hasattr(tmod, n)]
    assert not missing, missing


def test_linalg_is_whole():
    missing = set(jlinalg.__all__) - set(dir(tp.linalg))
    assert not missing, sorted(missing)


def test_tensor_methods_are_whole():
    missing = _public(jp.Tensor) - _public(tp.Tensor)
    assert missing == set(), sorted(missing)
    assert _public(tp.Tensor) - _public(jp.Tensor) == PORT_ONLY["Tensor"]


def test_nn_activation_layers_are_whole():
    missing = set(jact.__all__) - _public(tp.nn)
    assert not missing, sorted(missing)


def test_functional_activations_are_whole():
    missing = set(JAX_F_ACTIVATIONS) - _public(TF)
    assert not missing, sorted(missing)
    assert {"relu6", "hardswish", "gumbel_softmax", "rrelu"} <= set(
        JAX_F_ACTIVATIONS)


@pytest.mark.parametrize("ns", ["nn", "nn.functional", "nn.initializer"])
def test_nn_namespaces_are_whole(ns):
    jmod, tmod = jp, tp
    for part in ns.split("."):
        jmod, tmod = getattr(jmod, part), getattr(tmod, part)
    missing = _public(jmod) - _public(tmod)
    assert missing == set(LEAKED.get(ns, {})), sorted(missing)
    # none of them is in the API JAX's module declares
    assert not set(LEAKED.get(ns, {})) & set(getattr(jmod, "__all__", ()))


def test_vision_models_are_whole():
    from paddle_tpu.vision import models as jm
    from paddle_tpu_torch.vision import models as tm
    assert _public(jm) - _public(tm) == set()
    assert _public(tm) - _public(jm) == PORT_ONLY["vision.models"]
    assert tm.__all__ == jm.__all__


def test_places_info_and_version_match_jax():
    for name in ("float32", "bfloat16", "float16", "float64"):
        jf, tf = jp.finfo(name), tp.finfo(name)
        for k in ("min", "max", "eps", "tiny", "resolution", "bits",
                  "dtype"):
            assert getattr(tf, k) == getattr(jf, k), (name, k)
    for name in ("int8", "int32", "int64", "uint8"):
        assert vars(tp.iinfo(name)) == vars(jp.iinfo(name))
    assert tp.CUDAPinnedPlace() == tp.CPUPlace()
    assert tp.XPUPlace(1).get_device_id() == 1
    assert tp.CustomPlace("npu", 2).device_type == "npu"
    with pytest.raises(RuntimeError):
        tp.TPUPlace(0).torch_device()
    assert tp.in_dynamic_mode() and not tp.is_compiled_with_tpu()
    assert tp.version.full_version == jp.version.full_version
    assert tp.flags.FLAGS_check_nan_inf is False
    assert np.isfinite(tp.finfo("float32").eps)
