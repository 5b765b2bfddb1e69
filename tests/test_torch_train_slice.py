"""The port's training slice held against paddle_tpu's on the CPU:
``forward_loss`` and its gradients per leaf, the rematerialisation policies
among themselves, and three ``make_train_step`` steps under AdamW (f32 and
bf16 moments) and Adafactor from a state carried across by
``opt_state_from_jax``.  Packed pretraining (``segment_ids``): the loss and
every gradient against JAX's under each loss head and remat policy, the
packed loss against the documents run alone, and one AdamW step.  The
trunk's kernel flags (``FLAGS_pallas_rms_norm``, ``_swiglu``,
``_rmsnorm_matmul``), set on both sides as set A (rms_norm + swiglu) or set
B (all three): the loss and every gradient, packed under set B, and one
AdamW step under set B; the port's routes counted against the code's
prediction.

Two small models, fp32 on both sides, weights and tokens made with numpy
from a seed: ``gqa`` (hidden 64, 4 heads of 16 over 2 kv heads: the inline
RoPE) and ``d128`` (hidden 256, 2 heads of 128: the fused RoPE, on the JAX
side the Pallas kernel in interpret mode).  Attention on the JAX side is the
Pallas flash kernel in interpret mode; the port's CPU route is its kernels'
plain version.  Tolerances: loss 1e-5; gradients 2e-5 of the leaf's largest
magnitude; params after three steps 1e-5 of the leaf's largest magnitude,
plus 10% of one step under AdamW (fp32 sums in another order; AdamW's
m / sqrt(v) passes a near-zero gradient's relative noise on to the step).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: these cases run small ops, and the default pool (one
# thread a core in each of the suite's xdist workers) oversubscribes the
# cores about tenfold
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from paddle_tpu.flags import get_flags, set_flags  # noqa: E402
from paddle_tpu.models import llama_pretrain as jlp  # noqa: E402
from paddle_tpu_torch import flags as tflags  # noqa: E402
from paddle_tpu_torch.models import llama_pretrain as tlp  # noqa: E402
from paddle_tpu_torch.models.packing import packed_step  # noqa: E402
from paddle_tpu_torch.models.weights import (  # noqa: E402
    opt_state_from_jax, params_from_jax)

MODELS = {
    "gqa": dict(vocab_size=96, hidden_size=64, intermediate_size=128,
                num_hidden_layers=2, num_attention_heads=4,
                num_key_value_heads=2),
    "d128": dict(vocab_size=96, hidden_size=256, intermediate_size=128,
                 num_hidden_layers=2, num_attention_heads=2,
                 num_key_value_heads=1),
}
BATCH, SEQ = 4, 17


@pytest.fixture(autouse=True)
def _interpret_mode():
    set_flags({"FLAGS_pallas_interpret": True})
    yield
    set_flags({"FLAGS_pallas_interpret": False})


def _cfgs(model, **kw):
    base = dict(MODELS[model], **kw)
    return (jlp.LlamaPretrainConfig(**base, dtype=jnp.float32),
            tlp.LlamaPretrainConfig(**base, dtype=torch.float32))


def _weights(model, seed=0):
    """The JAX param tree as numpy, fp32."""
    m = MODELS[model]
    h, L, V = m["hidden_size"], m["num_hidden_layers"], m["vocab_size"]
    rng = np.random.default_rng(seed)
    shapes = jlp._block_shapes(jlp.LlamaPretrainConfig(**m))

    def normal(shape):
        return (rng.standard_normal(shape) * h ** -0.5).astype(np.float32)

    blocks = {name: (1.0 + 0.1 * normal((L,) + s)) if name.startswith("ln")
              else normal((L,) + s) for name, s in shapes.items()}
    return {"embed": normal((V, h)), "blocks": blocks,
            "final_norm": (1.0 + 0.1 * normal((h,))).astype(np.float32),
            "lm_head": normal((h, V))}


def _tokens(seed, vocab=96):
    return np.random.default_rng(seed).integers(0, vocab, (BATCH, SEQ))


def _to_jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}.")
        else:
            yield prefix + k, v


def _assert_tree_close(got, ref, rel, what, extra_abs=0.0):
    """Every leaf within ``rel`` of the reference leaf's largest
    magnitude (plus ``extra_abs``)."""
    ref = dict(_flat(ref))
    for name, g in _flat(got):
        r = np.asarray(ref[name], dtype=np.float32)
        g = g.detach().float().numpy()
        scale = max(float(np.abs(r).max()), 1e-30)
        err = float(np.abs(g - r).max())
        assert err <= rel * scale + extra_abs, (
            f"{what} {name}: max abs diff {err} against magnitude {scale}")


def _torch_loss_and_grads(tcfg, weights, tokens):
    params = params_from_jax(weights, device="cpu")
    live = tlp._map_params(lambda p: p.requires_grad_(True), params)
    loss = tlp.make_forward(tcfg)(live, torch.from_numpy(tokens))
    grads = torch.autograd.grad(loss, tlp._leaves(live))
    it = iter(grads)
    return float(loss.detach()), tlp._map_params(lambda _: next(it), params)


@pytest.mark.parametrize("loss_chunks", [0, 4])
@pytest.mark.parametrize("model", ["gqa", "d128"])
def test_forward_loss_and_gradients_match_jax(model, loss_chunks):
    jcfg, tcfg = _cfgs(model, loss_chunks=loss_chunks)
    weights, tokens = _weights(model), _tokens(1)
    ref, ref_g = jax.value_and_grad(jlp.make_forward(jcfg))(
        _to_jax(weights), jnp.asarray(tokens))
    got, got_g = _torch_loss_and_grads(tcfg, weights, tokens)
    np.testing.assert_allclose(got, float(ref), atol=1e-5, rtol=1e-5)
    _assert_tree_close(got_g, ref_g, 2e-5, "gradient of")


def test_composite_attention_matches_jax():
    jcfg, tcfg = _cfgs("gqa", use_pallas_attention=False, remat=False)
    weights, tokens = _weights("gqa", 2), _tokens(2)
    ref, ref_g = jax.value_and_grad(jlp.make_forward(jcfg))(
        _to_jax(weights), jnp.asarray(tokens))
    got, got_g = _torch_loss_and_grads(tcfg, weights, tokens)
    np.testing.assert_allclose(got, float(ref), atol=1e-5, rtol=1e-5)
    _assert_tree_close(got_g, ref_g, 2e-5, "gradient of")


@pytest.mark.parametrize("model", ["gqa", "d128"])
def test_remat_policies_give_the_same_loss_and_gradients(model):
    weights, tokens = _weights(model, 3), _tokens(3)
    runs = {}
    for name, kw in (("off", dict(remat=False)),
                     ("full", dict(remat=True, remat_policy="full")),
                     ("flash", dict(remat=True, remat_policy="flash"))):
        _, tcfg = _cfgs(model, loss_chunks=2, **kw)
        runs[name] = _torch_loss_and_grads(tcfg, weights, tokens)
    for name in ("full", "flash"):
        assert runs[name][0] == runs["off"][0]
        for (leaf, a), (_, b) in zip(_flat(runs[name][1]),
                                     _flat(runs["off"][1])):
            assert torch.equal(a, b), f"{name}: gradient of {leaf} differs"


def _three_steps(model, optimizer, moment_dtype=None, beta1=0.0,
                 accum_steps=1):
    jcfg, tcfg = _cfgs(model, loss_chunks=2)
    weights = _weights(model, 4)
    # each optimizer at its documented step size
    kw = dict(lr=3e-4 if optimizer == "adamw" else 1e-2, weight_decay=0.1,
              accum_steps=accum_steps, optimizer=optimizer, beta1=beta1)
    jparams = _to_jax(weights)
    if optimizer == "adamw":
        jstate = jlp.init_adamw_state(
            jparams, None,
            moment_dtype=None if moment_dtype is None else jnp.bfloat16)
    else:
        jstate = jlp.init_adafactor_state(jparams, None, beta1=beta1)
    tparams = params_from_jax(weights, device="cpu")
    tstate = opt_state_from_jax(jax.tree_util.tree_map(np.asarray, jstate),
                                device="cpu")
    jstep = jlp.make_train_step(jcfg, None, **kw)
    tstep = tlp.make_train_step(tcfg, device="cpu", **kw)
    for i in range(3):
        tokens = _tokens(10 + i)
        jparams, jstate, jloss = jstep(jparams, jstate, jnp.asarray(tokens))
        tparams, tstate, tloss = tstep(tparams, tstate,
                                       torch.from_numpy(tokens))
        np.testing.assert_allclose(float(tloss), float(jloss), atol=1e-5,
                                   rtol=1e-5, err_msg=f"loss of step {i}")
    assert tstate["t"] == int(jstate["t"]) == 3
    return tparams, tstate, jparams, jstate


@pytest.mark.parametrize("model,optimizer,moment_dtype,beta1,accum", [
    ("d128", "adamw", None, 0.0, 1),
    ("gqa", "adamw", None, 0.0, 2),
    ("gqa", "adamw", "bf16", 0.0, 1),
    ("d128", "adafactor", None, 0.0, 1),
    ("gqa", "adafactor", None, 0.9, 2),
])
def test_three_train_steps_match_jax(model, optimizer, moment_dtype, beta1,
                                     accum):
    tparams, tstate, jparams, jstate = _three_steps(
        model, optimizer, moment_dtype, beta1, accum)
    # bf16 slots move by one rounding step (2**-8 relative) when the f32
    # value in front of the rounding differs in its last bits
    stored_bf16 = moment_dtype == "bf16" or (optimizer == "adafactor"
                                             and beta1 > 0)
    # AdamW steps by lr * m / sqrt(v): where a gradient is near zero its
    # rounding noise reaches the step undamped, so allow 10% of one step
    # (the rule itself is held to 1e-6 in test_torch_fused_adamw.py)
    _assert_tree_close(tparams, jparams, 1e-5, "param",
                       extra_abs=0.1 * 3e-4 if optimizer == "adamw" else 0.0)
    # the JAX state after step 3, carried across, is the port's state
    carried = opt_state_from_jax(jax.tree_util.tree_map(np.asarray, jstate),
                                 device="cpu")
    for (name, a), (_, b) in zip(_flat(tstate["moments"]),
                                 _flat(carried["moments"])):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        scale = max(float(b.float().abs().max()), 1e-30)
        err = float((a.float() - b.float()).abs().max())
        assert err <= (2 ** -7 if stored_bf16 else 1e-4) * scale, (
            f"moment {name}: {err} against {scale}")


def test_a_beta1_that_disagrees_with_the_state_raises():
    _, tcfg = _cfgs("gqa")
    params = params_from_jax(_weights("gqa"), device="cpu")
    state = tlp.init_adafactor_state(params, beta1=0.0, device="cpu")
    step = tlp.make_train_step(tcfg, optimizer="adafactor", beta1=0.9,
                               device="cpu")
    with pytest.raises(ValueError, match="beta1"):
        step(params, state, torch.from_numpy(_tokens(0)))
    with pytest.raises(ValueError, match="adamw/adafactor"):
        tlp.make_train_step(tcfg, optimizer="sgd", device="cpu")


@pytest.mark.parametrize("policy", ["dots", "names", "cheap"])
def test_jax_checkpoint_policies_are_not_ported(policy):
    _, tcfg = _cfgs("gqa", remat_policy=policy)
    with pytest.raises(NotImplementedError, match=policy):
        tlp.make_forward(tcfg)
    with pytest.raises(ValueError, match="remat_policy"):
        tlp.LlamaPretrainConfig(remat_policy="everything")


def test_context_parallel_is_not_ported():
    _, cp = _cfgs("gqa", context_parallel="ring")
    with pytest.raises(NotImplementedError, match="mesh"):
        tlp.make_forward(cp)
    with pytest.raises(ValueError, match="context_parallel"):
        tlp.LlamaPretrainConfig(context_parallel="tree")


def test_init_params_stores_f32_masters_for_the_trainer():
    tcfg = tlp.LlamaPretrainConfig(**MODELS["gqa"])          # bf16 compute
    served = tlp.init_params(tcfg, seed=0, device="cpu")
    masters = tlp.init_params(tcfg, seed=0, device="cpu",
                              dtype=tcfg.param_dtype)
    assert served["lm_head"].dtype == torch.bfloat16
    for _, p in _flat(masters):
        assert p.dtype == torch.float32
    state = tlp.init_adamw_state(masters, device="cpu")
    assert state["t"] == 0
    slots = dict(_flat(state["moments"]))
    for name, p in _flat(masters):
        for slot in (slots[name + ".m"], slots[name + ".v"]):
            assert slot.shape == p.shape and slot.dtype == torch.float32, name
    half = tlp.init_adamw_state(masters, moment_dtype=torch.bfloat16,
                                device="cpu")
    assert half["moments"]["embed"]["v"].dtype == torch.bfloat16


def _packed_ids():
    """Segment ids [BATCH, SEQ] of packed rows: documents of other lengths
    in each row, a document cut at a row's end, and -1 padding runs."""
    layouts = [[5, 12], [17], [3, 1, 6, 4], [9, 4]]
    seg = np.full((BATCH, SEQ), -1, np.int32)
    for row, lens in enumerate(layouts):
        at = 0
        for i, L in enumerate(lens):
            seg[row, at:at + L] = i
            at += L
    return seg


def _jax_packed(jcfg, weights, tokens, seg):
    return jax.value_and_grad(jlp.make_forward(jcfg))(
        _to_jax(weights), jnp.asarray(tokens), jnp.asarray(seg))


def _torch_packed(tcfg, weights, tokens, seg):
    params = params_from_jax(weights, device="cpu")
    live = tlp._map_params(lambda p: p.requires_grad_(True), params)
    loss = tlp.make_forward(tcfg)(live, torch.from_numpy(tokens),
                                  torch.from_numpy(seg))
    grads = torch.autograd.grad(loss, tlp._leaves(live))
    it = iter(grads)
    return float(loss.detach()), tlp._map_params(lambda _: next(it), params)


@pytest.mark.parametrize("loss_chunks", [1, 4])
@pytest.mark.parametrize("model", ["gqa", "d128"])
def test_packed_forward_loss_and_gradients_match_jax(model, loss_chunks):
    """With segment ids, both sides take the masked plain loss head; with
    loss_chunks > 1 both warn that they do."""
    jcfg, tcfg = _cfgs(model, loss_chunks=loss_chunks)
    weights, tokens, seg = _weights(model, 5), _tokens(5), _packed_ids()
    if loss_chunks > 1:
        with pytest.warns(UserWarning, match="unchunked loss head"):
            ref, ref_g = _jax_packed(jcfg, weights, tokens, seg)
        with pytest.warns(UserWarning, match="unchunked loss head"):
            got, got_g = _torch_packed(tcfg, weights, tokens, seg)
    else:
        ref, ref_g = _jax_packed(jcfg, weights, tokens, seg)
        got, got_g = _torch_packed(tcfg, weights, tokens, seg)
    np.testing.assert_allclose(got, float(ref), atol=1e-5, rtol=1e-5)
    _assert_tree_close(got_g, ref_g, 2e-5, "gradient of")


def test_packed_composite_attention_matches_jax():
    jcfg, tcfg = _cfgs("gqa", use_pallas_attention=False, remat=False)
    weights, tokens, seg = _weights("gqa", 6), _tokens(6), _packed_ids()
    ref, ref_g = _jax_packed(jcfg, weights, tokens, seg)
    got, got_g = _torch_packed(tcfg, weights, tokens, seg)
    np.testing.assert_allclose(got, float(ref), atol=1e-5, rtol=1e-5)
    _assert_tree_close(got_g, ref_g, 2e-5, "gradient of")


@pytest.mark.parametrize("model", ["gqa", "d128"])
def test_packed_remat_policies_give_the_same_loss_and_gradients(model):
    weights, tokens, seg = _weights(model, 7), _tokens(7), _packed_ids()
    runs = {}
    for name, kw in (("off", dict(remat=False)),
                     ("full", dict(remat=True, remat_policy="full")),
                     ("flash", dict(remat=True, remat_policy="flash"))):
        _, tcfg = _cfgs(model, loss_chunks=1, **kw)
        runs[name] = _torch_packed(tcfg, weights, tokens, seg)
    for name in ("full", "flash"):
        assert runs[name][0] == runs["off"][0]
        for (leaf, a), (_, b) in zip(_flat(runs[name][1]),
                                     _flat(runs["off"][1])):
            assert torch.equal(a, b), f"{name}: gradient of {leaf} differs"


@pytest.mark.parametrize("model,la,lb,S", [("gqa", 50, 70, 128),
                                           ("d128", 20, 35, 64)])
def test_packed_loss_equals_the_documents_run_alone(model, la, lb, S):
    """JAX's packed-pretraining invariant (tests/test_flash_varlen.py):
    one packed row of two documents and -1 padding gives the
    token-weighted mean of the two documents' losses run alone."""
    _, tcfg = _cfgs(model, remat=False, loss_chunks=1)
    params = params_from_jax(_weights(model, 8), device="cpu")
    fwd = tlp.make_forward(tcfg)
    rng = np.random.default_rng(11)
    doc_a = rng.integers(0, 96, la + 1)
    doc_b = rng.integers(0, 96, lb + 1)
    packed = np.zeros((1, S + 1), np.int64)
    packed[0, :la + 1] = doc_a
    packed[0, la + 1:la + lb + 2] = doc_b
    seg = np.full((1, S + 1), -1, np.int32)
    seg[0, :la + 1] = 0
    seg[0, la + 1:la + lb + 2] = 1
    with torch.no_grad():
        loss = float(fwd(params, torch.from_numpy(packed),
                         torch.from_numpy(seg)))
        loss_a = float(fwd(params, torch.from_numpy(doc_a[None])))
        loss_b = float(fwd(params, torch.from_numpy(doc_b[None])))
    np.testing.assert_allclose(loss, (loss_a * la + loss_b * lb) / (la + lb),
                               rtol=2e-5)


def test_packed_adamw_step_matches_jax():
    """One AdamW step after the packed backward (the port's packed_step:
    autograd, then adamw_update) against JAX's adamw_update after
    jax.value_and_grad of the packed forward."""
    jcfg, tcfg = _cfgs("d128", loss_chunks=1)
    weights, tokens, seg = _weights("d128", 9), _tokens(9), _packed_ids()
    jloss, jgrads = _jax_packed(jcfg, weights, tokens, seg)
    jparams = _to_jax(weights)
    jparams, jstate = jlp.adamw_update(
        jparams, jgrads, jlp.init_adamw_state(jparams, None))

    params = params_from_jax(weights, device="cpu")
    step = packed_step(tlp.make_forward(tcfg), torch.from_numpy(tokens),
                       torch.from_numpy(seg))
    params, state, loss = step(params,
                               tlp.init_adamw_state(params, device="cpu"))
    np.testing.assert_allclose(float(loss), float(jloss),
                               atol=1e-5, rtol=1e-5)
    assert state["t"] == int(jstate["t"]) == 1
    # 10% of one step: see test_three_train_steps_match_jax
    _assert_tree_close(params, jparams, 1e-5, "param", extra_abs=0.1 * 3e-4)


TRUNK_FLAGS = ("FLAGS_pallas_rms_norm", "FLAGS_pallas_swiglu",
               "FLAGS_pallas_rmsnorm_matmul")
FLAG_SETS = {"A": TRUNK_FLAGS[:2], "B": TRUNK_FLAGS}


@pytest.fixture
def flag_set(request):
    """Turn a flag set on in both packages (JAX reads its flags when it
    traces, so every JAX function is built inside the test); restore both
    afterwards: the flags are process-global on both sides."""
    saved_jax = get_flags(list(TRUNK_FLAGS))
    saved_port = tflags.get_flags(list(TRUNK_FLAGS))
    on = {name: name in FLAG_SETS[request.param] for name in TRUNK_FLAGS}
    set_flags(on)
    tflags.set_flags(on)
    yield request.param
    set_flags(saved_jax)
    tflags.set_flags(saved_port)


@pytest.fixture
def routes(monkeypatch):
    """Calls of the three kernels' forward and backward routes (on the CPU
    each is the plain version a CUDA tensor's kernel stands in for)."""
    from paddle_tpu_torch.ops import rms_norm as trn
    from paddle_tpu_torch.ops import rmsnorm_matmul as trm
    from paddle_tpu_torch.ops import swiglu as tsw
    calls = {}
    for mod, attr, name in ((trn, "_fwd", "rms_norm_fwd"),
                            (trn, "_bwd", "rms_norm_bwd"),
                            (tsw, "_fwd", "swiglu_fwd"),
                            (tsw, "_bwd", "swiglu_bwd"),
                            (trm, "_fwd", "rmsnorm_matmul")):
        calls[name] = 0

        def spy(*a, _real=getattr(mod, attr), _name=name):
            calls[_name] += 1
            return _real(*a)

        monkeypatch.setattr(mod, attr, spy)
    return calls


def _predicted_routes(flag_set, L, h):
    """The kernel calls of one forward + backward under remat full, as
    chip_smoke's train_fused predicts them for the card: K9 only where
    h % 128 == 0; set B bypasses K9 at ln1 / ln2 and K10 altogether."""
    k9 = h % 128 == 0
    if flag_set == "A":
        return {"rms_norm_fwd": (4 * L + 1) * k9, "rms_norm_bwd": (2 * L + 1) * k9,
                "swiglu_fwd": 2 * L, "swiglu_bwd": L, "rmsnorm_matmul": 0}
    return {"rms_norm_fwd": k9, "rms_norm_bwd": k9, "swiglu_fwd": 0,
            "swiglu_bwd": 0, "rmsnorm_matmul": 10 * L}


@pytest.mark.parametrize("flag_set", ["A", "B"], indirect=True)
@pytest.mark.parametrize("model", ["gqa", "d128"])
def test_flagged_forward_loss_and_gradients_match_jax(model, flag_set,
                                                      routes):
    """gqa (hidden 64) takes no K9, and JAX sends its K11 calls to
    ``_xla_ref``; d128 (hidden 256) takes all three Pallas kernels."""
    jcfg, tcfg = _cfgs(model, loss_chunks=2)
    weights, tokens = _weights(model, 12), _tokens(12)
    ref, ref_g = jax.value_and_grad(jlp.make_forward(jcfg))(
        _to_jax(weights), jnp.asarray(tokens))
    got, got_g = _torch_loss_and_grads(tcfg, weights, tokens)
    np.testing.assert_allclose(got, float(ref), atol=1e-5, rtol=1e-5)
    _assert_tree_close(got_g, ref_g, 2e-5, "gradient of")
    assert routes == _predicted_routes(flag_set, tcfg.num_hidden_layers,
                                       tcfg.hidden_size)


@pytest.mark.parametrize("flag_set", ["B"], indirect=True)
def test_flagged_packed_forward_loss_and_gradients_match_jax(flag_set,
                                                             routes):
    jcfg, tcfg = _cfgs("d128", loss_chunks=1)
    weights, tokens, seg = _weights("d128", 13), _tokens(13), _packed_ids()
    ref, ref_g = _jax_packed(jcfg, weights, tokens, seg)
    got, got_g = _torch_packed(tcfg, weights, tokens, seg)
    np.testing.assert_allclose(got, float(ref), atol=1e-5, rtol=1e-5)
    _assert_tree_close(got_g, ref_g, 2e-5, "gradient of")
    assert routes["rmsnorm_matmul"] == 10 * tcfg.num_hidden_layers


@pytest.mark.parametrize("flag_set", ["B"], indirect=True)
def test_flagged_adamw_train_step_matches_jax(flag_set, routes):
    """One make_train_step under AdamW with every trunk kernel flag on,
    against JAX's adamw_update after jax.value_and_grad of its forward.
    The first AdamW step moves a param by ``lr * g / (|g| + 1e-8)``: where
    a gradient lies within f32 noise of zero (|g| < 1e-6, the forward
    test's 2e-5 of a leaf's largest) the two sides may move it anywhere in
    (-lr, lr), so one whole step is allowed there and 10% elsewhere."""
    jcfg, tcfg = _cfgs("d128", loss_chunks=2)
    weights, tokens = _weights("d128", 14), _tokens(14)
    jloss, jgrads = jax.value_and_grad(jlp.make_forward(jcfg))(
        _to_jax(weights), jnp.asarray(tokens))
    jparams = _to_jax(weights)
    jparams, jstate = jlp.adamw_update(
        jparams, jgrads, jlp.init_adamw_state(jparams, None), lr=3e-4)
    tparams = params_from_jax(weights, device="cpu")
    tstate = tlp.init_adamw_state(tparams, device="cpu")
    tparams, tstate, tloss = tlp.make_train_step(tcfg, lr=3e-4,
                                                 device="cpu")(
        tparams, tstate, torch.from_numpy(tokens))
    np.testing.assert_allclose(float(tloss), float(jloss), atol=1e-5,
                               rtol=1e-5)
    assert tstate["t"] == int(jstate["t"]) == 1
    ref, grads = dict(_flat(jparams)), dict(_flat(jgrads))
    for name, p in _flat(tparams):
        r = np.asarray(ref[name], np.float32)
        noise = np.abs(np.asarray(grads[name], np.float32)) < 1e-6
        allowed = (1e-5 * np.abs(r).max()
                   + np.where(noise, 1.0, 0.1) * 3e-4)
        assert (np.abs(p.numpy() - r) <= allowed).all(), name
    assert routes == _predicted_routes("B", tcfg.num_hidden_layers,
                                       tcfg.hidden_size)
