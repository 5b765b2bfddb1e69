"""``incubate.jit_train_step`` on a CUDA card: one CUDA graph a step.

* the replayed step equals the eager loop (``auto_cast`` O1, ``backward``,
  ``step``) with dropout 0, for small O1 BERT (masked and mask-free) and
  GPT models (GPT with ``ClipGradByGlobalNorm``);
* dropout draws a fresh mask on every replay, and the same masks after
  the same ``paddle.seed``;
* AdamW's bias correction advances across 5 replays (the state's
  ``beta*_pow`` are device scalars the graph updates);
* a learning-rate change between replays takes effect;
* a capture that fails raises, with no eager fallback: the parameters and
  the optimizer's step count stay as they were, and the framework's
  generator still draws;
* under O1, every attention of a mask-free BERT (non-causal, head_dim 64)
  and of GPT (causal, head_dim 128) launches K6a / K6b / K6c, once a layer
  each a replay, and none reaches ``sdpa_plain``.

Bounds: a replayed loss within 2e-3 (relative) of the eager loop's (the
same kernels; the eager optimizer's Python-float ``beta*_pow`` round
differently from the graph's device scalars, and bf16 products carry the
difference on), the model's update over the 3 steps (every parameter the
eager loop moved, concatenated) within 5% (L2, relative) of the eager
loop's: Adam's m / sqrt(v) turns a near-zero gradient's rounding into a
step of either sign, so single elements, and small leaves such as a
LayerNorm bias, may differ by up to 2 lr.  The parameters the loss does
not reach (BERT's pooler) are left out: the eager loop skips them, the
compiled step decays them (JAX's rule).
Every test needs a card and skips without one; inputs come from numpy's
seeded generators and the models from ``paddle.seed`` (nothing draws from
torch's default CUDA generator).  The card machine has no JAX, so run this
file there without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_jit_train_cuda.py -q
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import paddle_tpu_torch as paddle  # noqa: E402
from paddle_tpu_torch.framework import place as tplace  # noqa: E402
from paddle_tpu_torch.incubate import jit_train_step  # noqa: E402
from paddle_tpu_torch.models import (  # noqa: E402
    BertConfig, BertForQuestionAnswering, GPTConfig, GPTForCausalLM,
    GPTPretrainingCriterion)
from paddle_tpu_torch.ops import flash_attention as fa  # noqa: E402

pytestmark = pytest.mark.cuda

LOSS_REL = 2e-3
UPDATE_REL = 0.05
BERT_KW = dict(vocab_size=512, hidden_size=128, num_hidden_layers=2,
               num_attention_heads=2, intermediate_size=256,
               max_position_embeddings=128)
GPT_KW = dict(vocab_size=512, hidden_size=256, num_hidden_layers=2,
              num_attention_heads=2, max_position_embeddings=128)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    prev = tplace._current_place
    paddle.set_device("gpu")
    yield
    tplace._current_place = prev


def _bert_batch(seed, B=4, S=64, V=512, masked=True):
    rng = np.random.RandomState(seed)
    x = [paddle.to_tensor(rng.randint(0, V, (B, S))),
         paddle.to_tensor(np.zeros((B, S), np.int64))]
    if masked:
        x.append(paddle.to_tensor(np.ones((B, S), np.float32)))
    y = (paddle.to_tensor(rng.randint(0, S, (B,))),
         paddle.to_tensor(rng.randint(0, S, (B,))))
    return tuple(x), y


def _qa_loss():
    ce = paddle.nn.CrossEntropyLoss()
    return lambda out, ys: (ce(out[0], ys[0]) + ce(out[1], ys[1])) * 0.5


def _bert(seed, dropout=0.0):
    paddle.seed(seed)
    net = BertForQuestionAnswering(BertConfig(dropout_prob=dropout,
                                              **BERT_KW))
    net.train()
    return net


def _gpt(seed):
    paddle.seed(seed)
    return GPTForCausalLM(GPTConfig(**GPT_KW))


def _eager_steps(net, loss_fn, opt, x, y, n):
    out = []
    for _ in range(n):
        with paddle.amp.auto_cast(level="O1"):
            loss = loss_fn(net(*x), y)
        loss.backward()
        opt.step()
        opt.clear_grad()
        out.append(float(loss))
    return out


@pytest.mark.parametrize("case", ["bert_masked", "bert_mask_free",
                                  "gpt_clipped"])
def test_replay_equals_the_eager_loop(card, case):
    if case.startswith("bert"):
        nets = [_bert(3), _bert(3)]
        x, y = _bert_batch(0, masked=case == "bert_masked")
        loss_fn = _qa_loss()
        make = lambda n: paddle.optimizer.AdamW(  # noqa: E731
            learning_rate=1e-3, parameters=n.parameters())
    else:
        nets = [_gpt(4), _gpt(4)]
        ids = paddle.to_tensor(np.random.RandomState(1).randint(
            0, 512, (2, 128)))
        x, y = (ids,), ids
        loss_fn = GPTPretrainingCriterion()
        make = lambda n: paddle.optimizer.AdamW(  # noqa: E731
            learning_rate=1e-3, beta2=0.95, weight_decay=0.1,
            parameters=n.parameters(),
            grad_clip=paddle.nn.ClipGradByGlobalNorm(1.0))
    init = [p.numpy() for p in nets[0].parameters()]
    step = jit_train_step(nets[0], loss_fn, make(nets[0]), amp_level="O1")
    replayed = [float(step(x, y)) for _ in range(3)]
    eager = _eager_steps(nets[1], loss_fn, make(nets[1]), x, y, 3)
    np.testing.assert_allclose(replayed, eager, rtol=LOSS_REL)
    assert replayed[-1] < replayed[0]
    (g,) = step.graphs()
    assert g.replays == 3
    diff = ref = 0.0
    for a, b, p0 in zip(nets[0].parameters(), nets[1].parameters(), init):
        da, db = a.numpy() - p0, b.numpy() - p0
        if np.any(db):
            diff += float(np.sum((da - db) ** 2))
            ref += float(np.sum(db ** 2))
    assert ref > 0 and (diff / ref) ** 0.5 < UPDATE_REL, (diff / ref) ** 0.5


def test_dropout_draws_fresh_masks_that_repeat_under_the_seed(card):
    x, y = _bert_batch(2)

    def run():
        net = _bert(5, dropout=0.1)
        opt = paddle.optimizer.SGD(learning_rate=0.0,
                                   parameters=net.parameters())
        step = jit_train_step(net, _qa_loss(), opt, amp_level="O1")
        return [float(step(x, y)) for _ in range(4)]

    first = run()
    assert len(set(first)) == 4, first
    assert run() == first


def test_adamw_bias_correction_advances_across_replays(card):
    paddle.seed(6)
    nn = paddle.nn
    nets = [nn.Sequential(nn.Linear(32, 64), nn.GELU(), nn.Linear(64, 8))
            for _ in range(2)]
    nets[1].set_state_dict(nets[0].state_dict())
    rng = np.random.RandomState(7)
    x = paddle.to_tensor(rng.randn(16, 32).astype(np.float32))
    y = paddle.to_tensor(rng.randint(0, 8, (16,)))
    opts = [paddle.optimizer.AdamW(learning_rate=1e-2,
                                   parameters=n.parameters()) for n in nets]
    ce = nn.CrossEntropyLoss()
    step = jit_train_step(nets[0], ce, opts[0])
    for _ in range(5):
        lj = float(step(x, y))
        loss = ce(nets[1](x), y)
        le = float(loss)
        loss.backward()
        opts[1].step()
        opts[1].clear_grad()
        np.testing.assert_allclose(lj, le, rtol=1e-5)
    sd = opts[0].state_dict()
    name = nets[0].parameters()[0].name
    assert abs(float(sd[f"{name}.beta1_pow"]) - 0.9 ** 5) < 1e-12
    assert abs(float(sd[f"{name}.beta2_pow"]) - 0.999 ** 5) < 1e-12
    assert sd["@step"] == 5
    for a, b in zip(nets[0].parameters(), nets[1].parameters()):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-6)


def test_an_lr_change_between_replays_takes_effect(card):
    net = _bert(8)
    opt = paddle.optimizer.AdamW(learning_rate=1e-3,
                                 parameters=net.parameters())
    step = jit_train_step(net, _qa_loss(), opt, amp_level="O1")
    x, y = _bert_batch(3)
    step(x, y)
    opt.set_lr(0.0)
    before = [p.numpy() for p in net.parameters()]
    step(x, y)
    after = [p.numpy() for p in net.parameters()]
    for a, b in zip(before, after):
        np.testing.assert_array_equal(a, b)
    opt.set_lr(1e-3)
    step(x, y)
    assert any(not np.array_equal(a, p.numpy())
               for a, p in zip(after, net.parameters()))
    assert step.graphs()[0].replays == 3


def test_a_capture_failure_raises_with_no_eager_fallback(card):
    net = _bert(9)
    opt = paddle.optimizer.AdamW(learning_rate=1e-3,
                                 parameters=net.parameters())
    inner = _qa_loss()

    def syncing_loss(out, ys):
        loss = inner(out, ys)
        float(loss)                  # a host read: illegal in a capture
        return loss

    step = jit_train_step(net, syncing_loss, opt, amp_level="O1")
    x, y = _bert_batch(4)
    before = [p.numpy() for p in net.parameters()]
    for _ in range(2):
        with pytest.raises(Exception):
            step(x, y)
    assert opt._step_count == 0
    for a, p in zip(before, net.parameters()):
        np.testing.assert_array_equal(a, p.numpy())
    assert not step.graphs()
    torch.cuda.synchronize()
    assert paddle.randn([4, 4]).shape == [4, 4]


@pytest.mark.parametrize("case", ["bert_mask_free", "gpt"])
def test_o1_attention_launches_k6_in_every_replay(card, case, monkeypatch):
    plain = []
    real = fa.sdpa_plain
    monkeypatch.setattr(fa, "sdpa_plain",
                        lambda *a, **k: plain.append(1) or real(*a, **k))
    if case == "gpt":
        net, loss_fn = _gpt(10), GPTPretrainingCriterion()
        ids = paddle.to_tensor(np.random.RandomState(2).randint(
            0, 512, (2, 128)))
        x, y = (ids,), ids
    else:
        net, loss_fn = _bert(10), _qa_loss()
        x, y = _bert_batch(5, masked=False)
    opt = paddle.optimizer.AdamW(learning_rate=1e-3,
                                 parameters=net.parameters())
    step = jit_train_step(net, loss_fn, opt, amp_level="O1")
    for _ in range(2):
        step(x, y)
    (g,) = step.graphs()
    L = 2
    assert {k: g.capture_launches.get(k, 0) for k in (
        "flash_attention_fwd", "flash_attention_bwd_dq",
        "flash_attention_bwd_dkv")} == {
        "flash_attention_fwd": L, "flash_attention_bwd_dq": L,
        "flash_attention_bwd_dkv": L}
    assert not plain
