"""The port's weight-only int8 path held against paddle_tpu's: the quantizer
(per matrix and over a whole checkpoint) bit for bit, and the int8 matmul's
plain version (the CPU path of the kernel wrapper) against the Pallas kernel
run in interpret mode.

Inputs are made with numpy from a seed.  The Pallas kernel casts ``x`` to
bf16, so ``x`` is rounded to bf16 before both sides see it; the output is
fp32 on both, tolerance 1e-5 relative (the same f32 sum in another order).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

from paddle_tpu.flags import set_flags  # noqa: E402
from paddle_tpu.models import decode as jdec  # noqa: E402
from paddle_tpu.models import llama_pretrain as jlp  # noqa: E402
from paddle_tpu.ops.pallas.int8_matmul import (  # noqa: E402
    int8_matmul as jax_int8_matmul, quantize_int8 as jax_quantize_int8)
from paddle_tpu_torch.models import decode as tdec  # noqa: E402
from paddle_tpu_torch.models import llama_pretrain as tlp  # noqa: E402
from paddle_tpu_torch.models.weights import params_from_jax  # noqa: E402
from paddle_tpu_torch.ops import int8_matmul as tim  # noqa: E402

KW = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
          num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2)


@pytest.fixture
def _interpret_mode():
    set_flags({"FLAGS_pallas_interpret": True})
    yield
    set_flags({"FLAGS_pallas_interpret": False})


def _bf16_round(a):
    return np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


def _assert_same_codes(port, ref):
    """Codes and scales equal bit for bit."""
    np.testing.assert_array_equal(port["q"].numpy(), np.asarray(ref["q"]))
    assert port["s"].numpy().tobytes() == np.asarray(ref["s"]).tobytes()


@pytest.mark.parametrize("shape", [(256, 384), (33, 7)])
def test_quantize_int8_matches_jax_bitwise(shape):
    rng = np.random.default_rng(0)
    w = (rng.standard_normal(shape) * 0.1).astype(np.float32)
    w[:, 3] = 0.0                  # a zero column gets scale 1
    w[:, 2] = 0.0                  # scale exactly 1: codes at .5 ties
    w[:4, 2] = [127.0, 63.5, -2.5, 0.5]
    _assert_same_codes(tim.quantize_int8(torch.from_numpy(w)),
                       jax_quantize_int8(jnp.asarray(w)))
    qd = tim.quantize_int8(torch.from_numpy(w))
    assert qd["q"].dtype == torch.int8 and qd["s"].dtype == torch.float32
    assert float(qd["s"][3]) == 1.0 and int(qd["q"].abs().max()) == 127
    # round half to even, as jnp.round
    assert qd["q"][:4, 2].tolist() == [127, 64, -2, 0]


def test_quantize_params_int8_matches_jax_bitwise():
    cfg = jlp.LlamaPretrainConfig(**KW, dtype=jnp.float32,
                                  param_dtype=jnp.float32)
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1, 1, 1, 1),
                ("dp", "pp", "sharding", "sep", "mp"))
    jparams = jax.tree_util.tree_map(
        np.asarray, jlp.init_params(cfg, jax.random.PRNGKey(0), mesh))
    jq = jdec.quantize_params_int8(jparams)
    tq = tdec.quantize_params_int8(params_from_jax(jparams, device="cpu"))
    for name, w in jq["blocks"].items():
        if name.startswith("ln"):
            assert torch.equal(tq["blocks"][name], torch.tensor(w))
        else:
            _assert_same_codes(tq["blocks"][name], w)
    _assert_same_codes(tq["lm_head"], jq["lm_head"])
    assert torch.equal(tq["embed"], torch.tensor(jparams["embed"]))
    # both routes to int8 weights give the same port params
    carried = params_from_jax(jax.tree_util.tree_map(np.asarray, jq),
                              device="cpu")
    _assert_same_codes(carried["blocks"]["w_down"],
                       jq["blocks"]["w_down"])
    assert torch.equal(carried["blocks"]["wq"]["q"], tq["blocks"]["wq"]["q"])


def test_plain_matches_pallas_interpret(_interpret_mode):
    rng = np.random.default_rng(7)
    x = _bf16_round(rng.standard_normal((5, 256)).astype(np.float32))
    w = (rng.standard_normal((256, 384)) * 0.1).astype(np.float32)
    qd = jax_quantize_int8(jnp.asarray(w))
    ref = np.asarray(jax_int8_matmul(jnp.asarray(x), qd["q"], qd["s"],
                                     out_dtype=jnp.float32))
    got = tim.int8_matmul_plain(torch.from_numpy(x), torch.tensor(qd["q"]),
                                torch.tensor(qd["s"]))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5,
                               atol=1e-5 * np.abs(ref).max())


def test_cpu_tensors_take_the_plain_version_without_a_launch():
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((3, 32)).astype(np.float32))
    qd = tim.quantize_int8(torch.from_numpy(
        rng.standard_normal((32, 24)).astype(np.float32)))
    before = (tim.launches, tim.launches_wave)
    got = tim.int8_matmul(x, qd["q"], qd["s"])
    assert torch.equal(got, tim.int8_matmul_plain(x, qd["q"], qd["s"]))
    assert (tim.launches, tim.launches_wave) == before
    # out_dtype rounds once, at the end
    bf = tim.int8_matmul(x, qd["q"], qd["s"], out_dtype=torch.bfloat16)
    assert bf.dtype == torch.bfloat16 and torch.equal(bf, got.bfloat16())


def test_cpu_tensors_at_a_wave_take_the_plain_version_without_a_launch():
    """Above WAVE_MIN_M rows (the kernel's wave path on the card) a CPU
    tensor launches neither path either."""
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal(
        (tim.WAVE_MIN_M + 1, 32)).astype(np.float32))
    qd = tim.quantize_int8(torch.from_numpy(
        rng.standard_normal((32, 24)).astype(np.float32)))
    before = (tim.launches, tim.launches_wave)
    got = tim.int8_matmul(x, qd["q"], qd["s"])
    assert torch.equal(got, tim.int8_matmul_plain(x, qd["q"], qd["s"]))
    assert (tim.launches, tim.launches_wave) == before
