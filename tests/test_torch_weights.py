"""``params_from_jax`` loads paddle_tpu's LLaMA param tree into the port
bit for bit: same nesting, shapes, dtypes and values."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

from paddle_tpu.models.llama_pretrain import (  # noqa: E402
    LlamaPretrainConfig, init_params)
from paddle_tpu_torch.models.weights import params_from_jax  # noqa: E402


def _jax_tree():
    cfg = LlamaPretrainConfig(
        vocab_size=128, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        dtype=jnp.float32, param_dtype=jnp.float32)
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1, 1, 1, 1),
                ("dp", "pp", "sharding", "sep", "mp"))
    params = init_params(cfg, jax.random.PRNGKey(0), mesh)
    return jax.tree_util.tree_map(np.asarray, params)


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def test_params_from_jax_round_trips_bitwise():
    tree = _jax_tree()
    port = params_from_jax(tree, device="cpu")
    a, b = list(_leaves(tree)), list(_leaves(port))
    assert [k for k, _ in a] == [k for k, _ in b]
    for (key, x), (_, t) in zip(a, b):
        assert isinstance(t, torch.Tensor) and t.device.type == "cpu", key
        back = t.numpy()
        assert back.dtype == x.dtype and back.shape == x.shape, key
        assert back.tobytes() == np.ascontiguousarray(x).tobytes(), key


def test_params_from_jax_copies():
    tree = {"w": np.ones((2, 2), np.float32)}
    port = params_from_jax(tree, device="cpu")
    tree["w"][0, 0] = 5.0
    assert float(port["w"][0, 0]) == 1.0


def test_params_from_jax_keeps_int8_weight_dicts():
    tree = {"wq": {"q": np.ones((4, 4), np.int8),
                   "s": np.full((4,), 0.5, np.float32)}}
    port = params_from_jax(tree, device="cpu")
    assert port["wq"]["q"].dtype == torch.int8
    assert port["wq"]["s"].dtype == torch.float32
