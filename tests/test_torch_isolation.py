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
from paddle_tpu_torch.models.weights import params_from_jax  # noqa: E402

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
        "import paddle_tpu_torch.models.weights\n"
        "import paddle_tpu_torch.ops.int8_matmul\n"
        "import chip_smoke\n"
        "import tools.profile_torch_decode\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'paddle_tpu'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def _sources():
    yield ROOT / "chip_smoke.py"
    yield ROOT / "tools" / "profile_torch_decode.py"
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
    # asking for the CPU explicitly is the one way to get it
    cache = PagedKVCache(cfg, num_pages=4, pages_max=2, batch=1, page=8,
                         device="cpu")
    assert cache.kpool.device.type == "cpu"
