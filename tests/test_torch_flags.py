"""The port's flag mirror (``paddle_tpu_torch/flags.py``): the three trunk
flags off by default, the Paddle API's five at JAX's defaults, set and read
at call time, initialised from the environment, and restored after each
test that sets them."""

import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from paddle_tpu_torch import flags as tfl  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
TRUNK = ("FLAGS_pallas_rms_norm", "FLAGS_pallas_swiglu",
         "FLAGS_pallas_rmsnorm_matmul")
# read by nn.functional / incubate.nn.functional / ops.dispatch; set by
# jit.set_code_level / set_verbosity (FLAGS_log_level, JAX's default)
API = {"FLAGS_pallas_flash_attention": True, "FLAGS_pallas_rope": True,
       "FLAGS_check_nan_inf": False, "FLAGS_check_nan_inf_level": 0,
       "FLAGS_log_level": 0}


@pytest.fixture
def restore_flags():
    saved = tfl.get_flags()
    yield
    tfl.set_flags(saved)


def test_the_trunk_flags_exist_and_are_off_by_default():
    code = ("from paddle_tpu_torch.flags import get_flags\n"
            "print(sorted(get_flags().items()))\n")
    env = {k: v for k, v in os.environ.items() if not k.startswith("FLAGS_")}
    env["PYTHONPATH"] = str(ROOT)
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=60)
    assert r.returncode == 0, r.stderr
    want = dict(API, **{f: False for f in TRUNK})
    assert r.stdout.strip() == str(sorted(want.items()))


def test_the_environment_sets_a_flag_at_import():
    code = ("from paddle_tpu_torch.flags import flags\n"
            "print(flags.FLAGS_pallas_swiglu, flags.FLAGS_pallas_rms_norm, "
            "flags.FLAGS_pallas_rmsnorm_matmul)\n")
    env = {k: v for k, v in os.environ.items() if not k.startswith("FLAGS_")}
    env.update(PYTHONPATH=str(ROOT), FLAGS_pallas_swiglu="1",
               FLAGS_pallas_rms_norm="on",
               FLAGS_pallas_rmsnorm_matmul="not-a-bool")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=60)
    assert r.returncode == 0, r.stderr
    # a value that does not parse leaves the default, as in JAX
    assert r.stdout.split() == ["True", "True", "False"]


def test_set_get_and_attribute_access(restore_flags):
    tfl.set_flags({"FLAGS_pallas_swiglu": "yes"})
    assert tfl.flags.FLAGS_pallas_swiglu is True
    assert tfl.get_flags("FLAGS_pallas_swiglu") == {
        "FLAGS_pallas_swiglu": True}
    tfl.flags.FLAGS_pallas_swiglu = 0
    assert tfl.get_flags(["FLAGS_pallas_swiglu"])["FLAGS_pallas_swiglu"] \
        is False
    with pytest.raises(ValueError, match="unknown flag"):
        tfl.set_flags({"FLAGS_pallas_int8_matmul": True})
    with pytest.raises(ValueError, match="parse"):
        tfl.set_flags({"FLAGS_pallas_rms_norm": "maybe"})
    with pytest.raises(AttributeError):
        tfl.flags.FLAGS_not_a_flag


def test_a_defined_flag_reads_the_environment_once(monkeypatch):
    reg = tfl._FlagRegistry()
    monkeypatch.setenv("FLAGS_probe", "1")
    reg.define("FLAGS_probe", False)
    reg.define("FLAGS_probe", False)          # a second define is a no-op
    assert reg.get("FLAGS_probe") is True
    monkeypatch.setenv("FLAGS_count", "12")
    reg.define("FLAGS_count", 3)
    assert reg.get("FLAGS_count") == 12


def test_the_trunk_reads_the_flags_at_call_time(restore_flags):
    """A flag set between two calls of one forward changes the second."""
    from paddle_tpu_torch.models import llama_pretrain as tlp
    from paddle_tpu_torch.ops import rms_norm as trn
    seen = []
    real = trn._fwd

    def spy(*a):
        seen.append(1)
        return real(*a)

    x = torch.randn(2, 3, 128)
    w = torch.ones(128)
    trn._fwd = spy
    try:
        tlp._rms_norm(x, w, 1e-6)
        assert not seen
        tfl.set_flags({"FLAGS_pallas_rms_norm": True})
        tlp._rms_norm(x, w, 1e-6)
        assert seen
        seen.clear()
        tlp._rms_norm(torch.randn(2, 64), torch.ones(64), 1e-6)
        assert not seen                       # h % 128 != 0: the composite
    finally:
        trn._fwd = real
