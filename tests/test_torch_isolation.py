"""The port stands alone: ``paddle_tpu_torch`` and ``chip_smoke.py`` import
neither ``jax`` nor ``paddle_tpu``, and its entry points never fall back to
the CPU on their own."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from paddle_tpu_torch.models import llama_pretrain as tlp  # noqa: E402
from paddle_tpu_torch.models.paged_decode import PagedKVCache  # noqa: E402
from paddle_tpu_torch.models.speculative import (  # noqa: E402
    generate_speculative)
from paddle_tpu_torch.models.weights import (  # noqa: E402
    opt_state_from_jax, params_from_jax)
from paddle_tpu_torch.ops.rope import rope_tables  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "paddle_tpu")


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def test_importing_the_port_loads_neither_jax_nor_paddle_tpu():
    code = (
        "import sys\n"
        "import paddle_tpu_torch\n"
        "import paddle_tpu_torch.inference.serving\n"
        "import paddle_tpu_torch.models.serving_engine\n"
        "import paddle_tpu_torch.models.paged_decode\n"
        "import paddle_tpu_torch.models.kv_offload\n"
        "import paddle_tpu_torch.models.graphed_step\n"
        "import paddle_tpu_torch.models.speculative\n"
        "import paddle_tpu_torch.models.disagg\n"
        "import paddle_tpu_torch.observability.engine_metrics\n"
        "import paddle_tpu_torch.observability.disagg_metrics\n"
        "import paddle_tpu_torch.models.weights\n"
        "import paddle_tpu_torch.models.packing\n"
        "import paddle_tpu_torch.ops.int8_matmul\n"
        "import paddle_tpu_torch.ops.rope\n"
        "import paddle_tpu_torch.ops.flash_attention\n"
        "import paddle_tpu_torch.ops.fused_adamw\n"
        "import paddle_tpu_torch.ops.chunked_loss\n"
        "import paddle_tpu_torch.ops.rms_norm\n"
        "import paddle_tpu_torch.ops.swiglu\n"
        "import paddle_tpu_torch.ops.rmsnorm_matmul\n"
        "import paddle_tpu_torch.flags\n"
        "import paddle_tpu_torch.observability\n"
        "import paddle_tpu_torch.testing.faults\n"
        "import paddle_tpu_torch.fleet\n"
        "import paddle_tpu_torch.fleet.transport\n"
        "import paddle_tpu_torch.fleet.remote\n"
        "import paddle_tpu_torch.observability.transport_metrics\n"
        "import paddle_tpu_torch.testing.agent_factory\n"
        "import paddle_tpu_torch.framework.dtype\n"
        "import paddle_tpu_torch.framework.place\n"
        "import paddle_tpu_torch.framework.random\n"
        "import paddle_tpu_torch.framework.param\n"
        "import paddle_tpu_torch.tensor\n"
        "import paddle_tpu_torch.tensor.creation\n"
        "import paddle_tpu_torch.tensor.manipulation\n"
        "import paddle_tpu_torch.tensor.math\n"
        "import paddle_tpu_torch.tensor.logic\n"
        "import paddle_tpu_torch.tensor.linalg\n"
        "import paddle_tpu_torch.tensor.search\n"
        "import paddle_tpu_torch.ops.dispatch\n"
        "import paddle_tpu_torch.autograd\n"
        "import paddle_tpu_torch.autograd.tape\n"
        "import paddle_tpu_torch.nn\n"
        "import paddle_tpu_torch.nn.functional\n"
        "import paddle_tpu_torch.nn.initializer\n"
        "import paddle_tpu_torch.nn.layer.layers\n"
        "import paddle_tpu_torch.nn.layer.common\n"
        "import paddle_tpu_torch.nn.layer.norm\n"
        "import paddle_tpu_torch.nn.layer.activation\n"
        "import paddle_tpu_torch.nn.layer.loss\n"
        "import paddle_tpu_torch.incubate.nn.functional\n"
        "import paddle_tpu_torch.optimizer\n"
        "import paddle_tpu_torch.models.llama\n"
        "import paddle_tpu_torch.models._layers\n"
        "import paddle_tpu_torch.models.decode\n"
        "import paddle_tpu_torch.models.bert\n"
        "import paddle_tpu_torch.models.gpt\n"
        "import paddle_tpu_torch.amp\n"
        "import paddle_tpu_torch.nn.clip\n"
        "import paddle_tpu_torch.incubate.jit_train\n"
        "import paddle_tpu_torch.io\n"
        "import paddle_tpu_torch.io.worker\n"
        "import paddle_tpu_torch.metric\n"
        "import paddle_tpu_torch.hapi\n"
        "import paddle_tpu_torch.hapi.model\n"
        "import paddle_tpu_torch.hapi.callbacks\n"
        "import paddle_tpu_torch.callbacks\n"
        "import paddle_tpu_torch.vision\n"
        "import paddle_tpu_torch.vision.models\n"
        "import paddle_tpu_torch.vision.datasets\n"
        "import paddle_tpu_torch.vision.transforms\n"
        "import paddle_tpu_torch.optimizer.lr\n"
        "import paddle_tpu_torch.framework.io\n"
        "import paddle_tpu_torch.nn.functional.conv\n"
        "import paddle_tpu_torch.nn.functional.pooling\n"
        "import paddle_tpu_torch.nn.layer.conv\n"
        "import paddle_tpu_torch.nn.layer.pooling\n"
        "import paddle_tpu_torch.tensor.stat\n"
        "import paddle_tpu_torch.tensor.einsum\n"
        "import paddle_tpu_torch.tensor.random\n"
        "import paddle_tpu_torch.tensor.extras\n"
        "import paddle_tpu_torch.tensor.inplace\n"
        "import paddle_tpu_torch.nn.functional.activation\n"
        "import paddle_tpu_torch.vision.models.vgg\n"
        "import paddle_tpu_torch.vision.models.mobilenet\n"
        "import paddle_tpu_torch.vision.models.mobilenetv3\n"
        "import paddle_tpu_torch.vision.models.alexnet\n"
        "import paddle_tpu_torch.vision.models.squeezenet\n"
        "import paddle_tpu_torch.vision.models.densenet\n"
        "import paddle_tpu_torch.vision.models.googlenet\n"
        "import paddle_tpu_torch.vision.models.inceptionv3\n"
        "import paddle_tpu_torch.vision.models.shufflenetv2\n"
        "import paddle_tpu_torch.nn.functional.common\n"
        "import paddle_tpu_torch.nn.functional.norm\n"
        "import paddle_tpu_torch.nn.functional.loss\n"
        "import paddle_tpu_torch.nn.functional.extras\n"
        "import paddle_tpu_torch.nn.layer.rnn\n"
        "import paddle_tpu_torch.nn.layer.transformer\n"
        "import paddle_tpu_torch.nn.layer.extras\n"
        "import paddle_tpu_torch.jit\n"
        "import paddle_tpu_torch.jit.dy2static\n"
        "import paddle_tpu_torch.jit.capture\n"
        "import paddle_tpu_torch.static\n"
        "import paddle_tpu_torch.inference\n"
        "import chip_smoke\n"
        "import tools.profile_torch_decode\n"
        "import tools.ab_torch_kernels\n"
        "import tools.profile_torch_train\n"
        "import tools.profile_torch_admission\n"
        "import tools.chip_phases\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'paddle_tpu'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


NEW_SUBPACKAGES = ("io", "io.worker", "metric", "hapi", "hapi.model",
                   "hapi.callbacks", "callbacks", "vision", "vision.models",
                   "vision.datasets", "vision.transforms", "optimizer.lr",
                   "framework.io", "nn.functional.conv",
                   "nn.functional.pooling", "nn.layer.conv",
                   "nn.layer.pooling", "tensor.stat", "tensor.einsum",
                   "tensor.random", "tensor.extras", "tensor.inplace",
                   "nn.functional.activation", "vision.models.mobilenetv3",
                   "vision.models.densenet", "vision.models.inceptionv3",
                   "nn.functional.common", "nn.functional.norm",
                   "nn.functional.loss", "nn.functional.extras",
                   "nn.layer.rnn", "nn.layer.transformer",
                   "nn.layer.extras", "jit", "jit.dy2static", "jit.capture",
                   "static", "inference", "inference.serving")


def test_importing_the_port_makes_no_cuda_call():
    """Spawned DataLoader workers import the port: the import must not
    touch CUDA.  Every entry into torch's CUDA runtime raises here, and
    the whole package (the new subpackages included) still imports."""
    mods = "".join(f"import paddle_tpu_torch.{m}\n" for m in NEW_SUBPACKAGES)
    code = (
        "import torch, torch.cuda\n"
        "def boom(*a, **k):\n"
        "    raise AssertionError('a CUDA call at import')\n"
        "for name in ('is_available', 'device_count', 'init', '_lazy_init',\n"
        "             'current_device', 'get_device_name', 'synchronize'):\n"
        "    setattr(torch.cuda, name, boom)\n"
        "torch._C._cuda_getDeviceCount = boom\n"
        "import paddle_tpu_torch\n" + mods +
        "import chip_smoke\n"
        "assert not torch.cuda.is_initialized()\n"
        "bad = sorted(m for m in __import__('sys').modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'paddle_tpu'))\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_varlen_entry_point_runs_in_a_fresh_process():
    """nn.functional's varlen entry points reach ops.flash_varlen before
    anything has imported ``models``: that import must not be circular
    (it was, while ops.flash_varlen imported models.decode at import)."""
    code = (
        "import numpy as np\n"
        "import paddle_tpu_torch as paddle\n"
        "paddle.set_device('cpu')\n"
        "F = paddle.nn.functional\n"
        "q = paddle.to_tensor(np.ones((6, 2, 64), np.float32))\n"
        "cu = np.array([0, 2, 6])\n"
        "out = F.flash_attn_unpadded(q, q, q, cu, cu, causal=True)\n"
        "assert out.shape == [6, 2, 64]\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_serving_an_export_imports_neither_the_models_nor_jax():
    """A process that serves an exported program imports
    ``paddle_tpu_torch.inference`` (jit and static with it) and neither
    the model package nor JAX."""
    code = (
        "import sys\n"
        "import paddle_tpu_torch.inference\n"
        "import paddle_tpu_torch.jit\n"
        "import paddle_tpu_torch.static\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'paddle_tpu') or\n"
        "             m.startswith('paddle_tpu_torch.models'))\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def _sources():
    yield ROOT / "chip_smoke.py"
    yield ROOT / "tools" / "profile_torch_decode.py"
    yield ROOT / "tools" / "ab_torch_kernels.py"
    yield ROOT / "tools" / "profile_torch_train.py"
    yield ROOT / "tools" / "profile_torch_admission.py"
    yield ROOT / "tools" / "torch_profile_common.py"
    yield ROOT / "tools" / "chip_phases.py"
    yield from sorted((ROOT / "paddle_tpu_torch").rglob("*.py"))


def test_no_source_of_the_port_imports_jax_or_paddle_tpu():
    files = list(_sources())
    assert len(files) > 10
    for path in files:
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            bad = [n for n in names if _forbidden(n)]
            assert not bad, f"{path}:{node.lineno} imports {bad}"


def test_entry_points_without_a_device_and_without_cuda_raise(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tlp.LlamaPretrainConfig(
        vocab_size=16, hidden_size=16, intermediate_size=32,
        num_hidden_layers=1, num_attention_heads=2, dtype=torch.float32)
    with pytest.raises(RuntimeError, match="CUDA"):
        PagedKVCache(cfg, num_pages=4, pages_max=2, batch=1, page=8)
    with pytest.raises(RuntimeError, match="CUDA"):
        tlp.init_params(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        params_from_jax({"w": [1.0]})
    with pytest.raises(RuntimeError, match="CUDA"):
        opt_state_from_jax({"t": 0, "moments": {"w": [1.0]}})
    params = tlp.init_params(cfg, device="cpu", dtype=torch.float32)
    with pytest.raises(RuntimeError, match="CUDA"):
        tlp.init_adamw_state(params)
    with pytest.raises(RuntimeError, match="CUDA"):
        tlp.init_adafactor_state(params)
    with pytest.raises(RuntimeError, match="CUDA"):
        tlp.make_train_step(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        rope_tables(4, 8)
    # the Paddle API's default place is the card
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.framework import place as tplace
    monkeypatch.setattr(tplace, "_current_place", tplace.CUDAPlace(0))
    with pytest.raises(RuntimeError, match="CUDA"):
        paddle.to_tensor([1.0])
    with pytest.raises(RuntimeError, match="CUDA"):
        paddle.set_device("gpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        generate_speculative(cfg, params, cfg, params, [1, 2], 2, gamma=1,
                             page=8)
    state = tlp.init_adamw_state(params, device="cpu")
    assert state["moments"]["embed"]["m"].device.type == "cpu"
    step = tlp.make_train_step(cfg, device="cpu")
    _, _, loss = step(params, state, torch.zeros((2, 5), dtype=torch.long))
    assert loss.device.type == "cpu" and torch.isfinite(loss)
    # the deployment entry points: a Predictor and a DevicePool run on
    # the card unless asked for the CPU
    from paddle_tpu_torch.inference import Config, Predictor
    from paddle_tpu_torch.inference.serving import DevicePool
    with pytest.raises(RuntimeError, match="CUDA"):
        Config().device()
    icfg = Config()
    icfg.disable_gpu()
    assert icfg.device().type == "cpu"
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="CUDA"):
        DevicePool(Config("unused.pt2"))
    with pytest.raises(RuntimeError, match="CUDA"):
        Predictor(Config("unused.pt2"))
    # asking for the CPU explicitly is the one way to get it
    cache = PagedKVCache(cfg, num_pages=4, pages_max=2, batch=1, page=8,
                         device="cpu")
    assert cache.kpool.device.type == "cpu"
