"""The port's LLaMA block math held against paddle_tpu's: RMS norm, the
post-attention block (wo, residual, SwiGLU FFN), grouped attention and the
two inline RoPE forms of the serving lanes.

Inputs are made with numpy from a seed, fp32 on both sides; tolerance 1e-5.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from paddle_tpu.models import decode as jdec  # noqa: E402
from paddle_tpu.models import llama_pretrain as jlp  # noqa: E402
from paddle_tpu.models import paged_decode as jpd  # noqa: E402
from paddle_tpu_torch.models import decode as tdec  # noqa: E402
from paddle_tpu_torch.models import llama_pretrain as tlp  # noqa: E402
from paddle_tpu_torch.models import paged_decode as tpd  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)
H, F, N, NKV = 64, 128, 4, 2


def _cfgs():
    kw = dict(vocab_size=128, hidden_size=H, intermediate_size=F,
              num_hidden_layers=2, num_attention_heads=N,
              num_key_value_heads=NKV)
    return (jlp.LlamaPretrainConfig(**kw, dtype=jnp.float32),
            tlp.LlamaPretrainConfig(**kw, dtype=torch.float32))


def _rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def test_rms_norm_matches_jax():
    rng = np.random.default_rng(0)
    x, w = _rand(rng, 3, 5, H), _rand(rng, H)
    ref = np.asarray(jlp._rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-6))
    got = tlp._rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-6)
    np.testing.assert_allclose(got.numpy(), ref, **TOL)


def test_block_post_attn_matches_jax():
    jcfg, tcfg = _cfgs()
    rng = np.random.default_rng(1)
    bp = {"ln2": 1.0 + _rand(rng, H, scale=0.1),
          "wo": _rand(rng, H, H, scale=H ** -0.5),
          "w_gate": _rand(rng, H, F, scale=H ** -0.5),
          "w_up": _rand(rng, H, F, scale=H ** -0.5),
          "w_down": _rand(rng, F, H, scale=F ** -0.5)}
    x, attn = _rand(rng, 2, 7, H), _rand(rng, 2, 7, N, H // N)
    ref = np.asarray(jlp._block_post_attn(
        {k: jnp.asarray(v) for k, v in bp.items()}, jnp.asarray(x),
        jnp.asarray(attn), jcfg))
    got = tlp._block_post_attn(
        {k: torch.from_numpy(v) for k, v in bp.items()}, torch.from_numpy(x),
        torch.from_numpy(attn), tcfg)
    np.testing.assert_allclose(got.numpy(), ref, **TOL)


def test_mm_refuses_int8_weight_dicts():
    x = torch.zeros((2, 4))
    with pytest.raises(NotImplementedError, match="int8"):
        tlp._mm(x, {"q": torch.zeros((4, 4), dtype=torch.int8),
                    "s": torch.ones(4)}, torch.float32)


def test_rope_rows_matches_jax():
    rng = np.random.default_rng(2)
    x = _rand(rng, 5, 1, N, 16)
    pos = np.array([0, 1, 17, 300, 2047], np.int32)
    ref = np.asarray(jpd._rope_rows(jnp.asarray(x), 10000.0,
                                    jnp.asarray(pos, jnp.int32)))
    got = tpd._rope_rows(torch.from_numpy(x), 10000.0, torch.from_numpy(pos))
    np.testing.assert_allclose(got.numpy(), ref, **TOL)


@pytest.mark.parametrize("per_row", [False, True])
def test_rope_at_matches_jax(per_row):
    rng = np.random.default_rng(3)
    x = _rand(rng, 2, 9, NKV, 16)
    pos = np.arange(9, dtype=np.int32) + 40
    if per_row:
        pos = np.stack([pos, pos[::-1] * 3])
    ref = np.asarray(jpd._rope_at(jnp.asarray(x), 10000.0,
                                  jnp.asarray(pos, jnp.int32)))
    got = tpd._rope_at(torch.from_numpy(x), 10000.0, torch.from_numpy(pos))
    np.testing.assert_allclose(got.numpy(), ref, **TOL)


def test_rope_rows_equals_rope_at_for_one_token():
    """Decode writes pages with _rope_rows, prefill with _rope_at: the
    two must agree at the same position."""
    rng = np.random.default_rng(4)
    x = torch.from_numpy(_rand(rng, 3, 1, N, 16))
    pos = torch.tensor([5, 64, 999])
    a = tpd._rope_rows(x, 10000.0, pos)
    b = torch.cat([tpd._rope_at(x[i:i + 1], 10000.0, pos[i:i + 1])
                   for i in range(3)])
    np.testing.assert_allclose(a.numpy(), b.numpy(), **TOL)


def test_grouped_attn_matches_jax():
    rng = np.random.default_rng(5)
    q, k, v = _rand(rng, 2, 6, N, 16), _rand(rng, 2, 10, NKV, 16), \
        _rand(rng, 2, 10, NKV, 16)
    mask = rng.random((2, 1, 1, 6, 10)) > 0.3
    mask[..., 0] = True
    ref = np.asarray(jdec._grouped_attn(jnp.asarray(q), jnp.asarray(k),
                                        jnp.asarray(v), jnp.asarray(mask)))
    got = tdec._grouped_attn(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(v), torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), ref, **TOL)


def test_init_params_shapes_and_scale_match_jax():
    jcfg, tcfg = _cfgs()
    p = tlp.init_params(tcfg, seed=0, device="cpu")
    want = jlp._block_shapes(jcfg)
    for name, shape in want.items():
        assert tuple(p["blocks"][name].shape) == (2,) + shape
    assert tuple(p["embed"].shape) == (128, H)
    assert tuple(p["lm_head"].shape) == (H, 128)
    assert torch.equal(p["final_norm"], torch.ones(H))
    assert torch.equal(p["blocks"]["ln1"], torch.ones((2, H)))
    std = float(p["blocks"]["w_gate"].std())
    assert abs(std - H ** -0.5) < 0.1 * H ** -0.5
    # seeded: the same seed gives the same weights
    again = tlp.init_params(tcfg, seed=0, device="cpu")
    assert torch.equal(p["lm_head"], again["lm_head"])


def test_pick_token_greedy_matches_jax_and_sampling_filters():
    rng = np.random.default_rng(6)
    logits = _rand(rng, 6, 50)
    logits[0, [3, 7]] = 9.0                  # a tie: the first index wins
    ref = np.asarray(jpd._pick_token(jnp.asarray(logits), 0.0, None))
    got = tpd._pick_token(torch.from_numpy(logits), 0.0)
    np.testing.assert_array_equal(got.numpy(), ref)
    gen = torch.Generator().manual_seed(0)
    lt = torch.from_numpy(logits[1:])        # no ties: one argmax a row
    # top-k 1 and a tiny nucleus keep only the argmax
    np.testing.assert_array_equal(
        tpd._pick_token(lt, 0.8, gen, top_k=1).numpy(), ref[1:])
    np.testing.assert_array_equal(
        tpd._pick_token(lt, 0.8, gen, top_p=1e-6).numpy(), ref[1:])
    # temperature sampling follows softmax(logits / T) in distribution
    three = torch.tensor([[0.0, 1.0, 2.0]]).repeat(4000, 1)
    draws = tpd._pick_token(three, 1.0, gen).numpy()
    freq = np.bincount(draws, minlength=3) / len(draws)
    want = np.exp([0.0, 1.0, 2.0]) / np.exp([0.0, 1.0, 2.0]).sum()
    np.testing.assert_allclose(freq, want, atol=0.03)
    # top-k 2 never draws the smallest of three
    assert 0 not in set(tpd._pick_token(three, 1.0, gen, top_k=2).tolist())
