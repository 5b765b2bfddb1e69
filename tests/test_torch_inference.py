"""The port's ``paddle.inference`` (``convert_to_export``, ``Predictor``,
``PredictorPool``) and ``inference.serving``'s ``DevicePool`` /
``InferenceServer`` / ``predict_http`` held against paddle_tpu's on the
CPU.

The counterpart of every case of tests/test_inference.py and of the
non-generation cases of tests/test_inference_serving.py (the device pool,
the HTTP round trip, concurrent requests, ``/metrics``), each run through
both packages on the same inputs (numpy, from a seed) and the same
weights (JAX's ``state_dict()`` carried by
``models.weights.layer_state_from_jax``), the port's Predictor output held
against JAX's Predictor output.  The port's artifact is a
``torch.export`` program (``.pt2``) where JAX's is StableHLO; the port's
pool replicas are named devices (the CPU four times here, where JAX's
suite has eight virtual CPU devices).

Beyond JAX's cases: a 2-layer BERT QA and a 2-layer Layer LLaMA exported
by both packages agree; the port's exported graph names the
``paddle_tpu_torch`` ops of K6a, K5, K9a, K10a (under its flag) and K2 with
its range kernel; an export that meets a host read (``F.flash_attn_unpadded``
reads its cu_seqlens) raises naming it; a child process serves the
artifact without importing the model package; a JAX ``.stablehlo`` given
to the port raises; a shape mismatch raises ``ValueError``.

Tolerances: the port's Predictor against its own eager forward exactly
(the same ops, the same order); against JAX's Predictor 1e-5 relative and
absolute for the small nets (JAX's own bar against its eager forward), 1e-4
for the 2-layer BERT and LLaMA logits (f32 through two layers, softmax and
norms summed in another order).
"""

import json
import os
import subprocess
import sys
import threading
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import paddle_tpu as jp  # noqa: E402
import paddle_tpu_torch as tp  # noqa: E402
from paddle_tpu import inference as jinf  # noqa: E402
from paddle_tpu_torch import inference as tinf  # noqa: E402
from paddle_tpu_torch.framework import place as tplace  # noqa: E402
from paddle_tpu_torch.inference import serving as tserv  # noqa: E402
from paddle_tpu_torch.models.weights import layer_state_from_jax  # noqa
from paddle_tpu_torch.tensor.tensor import HostReadError  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
TOL = dict(rtol=1e-5, atol=1e-5)
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)
PKGS = {"jax": jp, "torch": tp}
INF = {"jax": jinf, "torch": tinf}


@pytest.fixture(scope="module", autouse=True)
def _cpu():
    prev = tplace._current_place
    tp.set_device("cpu")
    yield
    tplace._current_place = prev


def _net(pkg):
    return pkg.nn.Sequential(pkg.nn.Linear(8, 16), pkg.nn.ReLU(),
                             pkg.nn.Linear(16, 3))


def _nets():
    """JAX's net after ``jp.seed(7)`` and the port's with its weights."""
    jp.seed(7)
    jnet = _net(jp)
    tnet = _net(tp)
    layer_state_from_jax(tnet, jnet.state_dict())
    return {"jax": jnet, "torch": tnet}


def _x(seed, shape=(4, 8)):
    return np.random.RandomState(seed).randn(*shape).astype("float32")


def _export_both(tmp_path, name, shape=(4, 8)):
    """Each package's net exported -> {side: (net, artifact path)}."""
    out = {}
    for side, net in _nets().items():
        path = INF[side].convert_to_export(
            net, [(shape, "float32")], str(tmp_path / side / name))
        out[side] = (net, path)
    return out


# -- tests/test_inference.py, case by case ------------------------------------
def test_export_and_predict(tmp_path):
    x = _x(0)
    outs = {}
    for side, (net, artifact) in _export_both(tmp_path, "model").items():
        pkg = PKGS[side]
        y_ref = net(pkg.to_tensor(x)).numpy()
        assert artifact.endswith(".pt2" if side == "torch"
                                 else ".stablehlo")
        pred = INF[side].create_predictor(INF[side].Config(
            prog_file=artifact))
        outs[side] = pred.run([x])
        np.testing.assert_allclose(outs[side][0], y_ref, **TOL)
    np.testing.assert_allclose(outs["torch"][0], outs["jax"][0], **TOL)


def test_export_loads_without_model_class(tmp_path):
    x = _x(1, (2, 8))
    outs = {}
    for side, net in _nets().items():
        y_ref = net(PKGS[side].to_tensor(x)).numpy()
        path = str(tmp_path / side / "m2")
        INF[side].convert_to_export(net, [((2, 8), "float32")], path)
        del net
        suffix = ".pt2" if side == "torch" else ".stablehlo"
        pred = INF[side].Predictor(INF[side].Config(prog_file=path + suffix))
        outs[side] = pred.run([x])[0]
        np.testing.assert_allclose(outs[side], y_ref, **TOL)
    np.testing.assert_allclose(outs["torch"], outs["jax"], **TOL)


def test_handle_api(tmp_path):
    x = _x(2)
    outs = {}
    for side, (net, artifact) in _export_both(tmp_path, "m3").items():
        pred = INF[side].Predictor(INF[side].Config(prog_file=artifact))
        names = pred.get_input_names()
        assert names == ["x0"]
        h = pred.get_input_handle(names[0])
        h.copy_from_cpu(x)
        assert pred.run() is None
        outs[side] = pred.get_output_handle(
            pred.get_output_names()[0]).copy_to_cpu()
        np.testing.assert_allclose(
            outs[side], net(PKGS[side].to_tensor(x)).numpy(), **TOL)
    np.testing.assert_allclose(outs["torch"], outs["jax"], **TOL)


def test_plain_function_export(tmp_path):
    a = np.ones((2, 3), "float32")
    b = np.ones((3, 4), "float32")
    for side in ("jax", "torch"):
        def f(u, v):
            return u @ v

        path = str(tmp_path / side / "fn")
        art = INF[side].convert_to_export(
            f, [((2, 3), "float32"), ((3, 4), "float32")], path)
        outs = INF[side].Predictor(INF[side].Config(prog_file=art)).run(
            [a, b])
        np.testing.assert_allclose(outs[0], a @ b)


def test_jit_save_fallback(tmp_path):
    x = _x(3)
    outs = {}
    for side, net in _nets().items():
        pkg = PKGS[side]
        y_ref = net(pkg.to_tensor(x)).numpy()
        base = str(tmp_path / side / "jitmodel")
        pkg.jit.save(net, base)
        pred = INF[side].Predictor(INF[side].Config(
            prog_file=base + ".pdmodel"))
        outs[side] = pred.run([x])[0]
        np.testing.assert_allclose(outs[side], y_ref, **TOL)
    np.testing.assert_allclose(outs["torch"], outs["jax"], **TOL)


def test_predictor_pool_and_config_summary(tmp_path):
    x = np.zeros((4, 8), "float32")
    outs = {}
    for side, (net, artifact) in _export_both(tmp_path, "m4").items():
        cfg = INF[side].Config(prog_file=artifact)
        cfg.enable_memory_optim()
        cfg.switch_ir_optim(True)
        pool = INF[side].PredictorPool(cfg, size=2)
        o0 = pool.retrieve(0).run([x])[0]
        o1 = pool.retrieve(1).run([x])[0]
        np.testing.assert_array_equal(o0, o1)
        assert "ir_optim" in cfg.summary()
        assert INF[side].get_version()
        outs[side] = o0
    np.testing.assert_allclose(outs["torch"], outs["jax"], **TOL)
    assert tinf.get_version() == jinf.get_version()


@pytest.mark.parametrize("side", ["jax", "torch"])
def test_export_does_not_corrupt_layer(side, tmp_path):
    pkg = PKGS[side]
    net = _nets()[side]
    x = pkg.to_tensor(np.ones((4, 8), "float32"))
    before = net(x).numpy()
    INF[side].convert_to_export(net, [((4, 8), "float32")],
                                str(tmp_path / "m5"))
    np.testing.assert_array_equal(before, net(x).numpy())


@pytest.mark.parametrize("side", ["jax", "torch"])
def test_functional_run_after_handle_creation(side, tmp_path):
    net = _nets()[side]
    path = str(tmp_path / "m6")
    art = INF[side].convert_to_export(net, [((4, 8), "float32")], path)
    pred = INF[side].Predictor(INF[side].Config(prog_file=art))
    pred.get_input_handle("x0")          # inspect-only
    outs = pred.run([_x(4)])             # the functional form still returns
    assert outs is not None and outs[0].shape == (4, 3)


@pytest.mark.parametrize("side", ["jax", "torch"])
def test_output_names_before_run(side, tmp_path):
    net = _nets()[side]
    art = INF[side].convert_to_export(net, [((4, 8), "float32")],
                                      str(tmp_path / "m7"))
    pred = INF[side].Predictor(INF[side].Config(prog_file=art))
    assert pred.get_output_names() == ["out0"]   # known pre-run from meta


@pytest.mark.parametrize("side", ["jax", "torch"])
def test_wrong_arity_raises(side, tmp_path):
    net = _nets()[side]
    art = INF[side].convert_to_export(net, [((4, 8), "float32")],
                                      str(tmp_path / "m8"))
    pred = INF[side].Predictor(INF[side].Config(prog_file=art))
    with pytest.raises(ValueError, match="expects 1 inputs"):
        pred.run([np.zeros((4, 8), "float32"), np.zeros((4, 8), "float32")])


@pytest.mark.parametrize("side", ["jax", "torch"])
def test_export_restores_training_mode(side, tmp_path):
    net = _nets()[side]
    net.train()
    INF[side].convert_to_export(net, [((4, 8), "float32")],
                                str(tmp_path / "m9"))
    assert net.training


def test_wrong_shape_raises(tmp_path):
    art = tinf.convert_to_export(_nets()["torch"], [((4, 8), "float32")],
                                 str(tmp_path / "m10"))
    pred = tinf.Predictor(tinf.Config(prog_file=art))
    with pytest.raises(ValueError, match=r"shape \[5, 8\]"):
        pred.run([np.zeros((5, 8), "float32")])


def test_jax_stablehlo_is_refused(tmp_path):
    art = jinf.convert_to_export(_nets()["jax"], [((4, 8), "float32")],
                                 str(tmp_path / "jx"))
    with pytest.raises(ValueError, match="JAX's StableHLO"):
        tinf.Predictor(tinf.Config(prog_file=art))


# -- tests/test_inference_serving.py's non-generation cases -------------------
@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    """Both packages' artifacts of the carried net, an input and each
    package's eager output."""
    d = tmp_path_factory.mktemp("srv")
    x = _x(0)
    out = {}
    for side, net in _nets().items():
        y = net(PKGS[side].to_tensor(x)).numpy()
        art = INF[side].convert_to_export(net, [((4, 8), "float32")],
                                          str(d / side / "model"))
        out[side] = (art, y)
    np.testing.assert_allclose(out["torch"][1], out["jax"][1], **TOL)
    return out, x


def test_device_pool_spreads_replicas(artifacts):
    arts, x = artifacts
    prog, y = arts["torch"]
    pool = tserv.DevicePool(tinf.Config(prog_file=prog),
                            devices=["cpu"] * 4)
    assert len(pool.device_names) == 4
    for i in range(4):
        np.testing.assert_array_equal(pool.run_on(i, [x])[0], y)
    for _ in range(4):
        np.testing.assert_array_equal(pool.run([x])[0], y)
    np.testing.assert_allclose(pool.run([x])[0], arts["jax"][1], **TOL)


def test_device_pool_without_a_card_names_its_devices(artifacts,
                                                      monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="devices"):
        tserv.DevicePool(tinf.Config(prog_file=artifacts[0]["torch"][0]))


def _get(url):
    with urllib.request.urlopen(url, timeout=10) as r:
        return r.read()


def test_http_server_round_trip(artifacts):
    arts, x = artifacts
    prog, y = arts["torch"]
    srv = tserv.InferenceServer(tinf.Config(prog_file=prog),
                                devices=["cpu", "cpu"])
    port = srv.start()
    try:
        url = f"http://127.0.0.1:{port}"
        meta = json.loads(_get(url + "/health"))
        assert meta["status"] == "ok" and len(meta["devices"]) == 2
        for _ in range(2):
            np.testing.assert_array_equal(tserv.predict_http(url, [x])[0], y)
        assert json.loads(_get(url + "/health"))["requests"] == 2
        # a malformed payload is a clean 400, not a dead server
        req = urllib.request.Request(
            url + "/predict", data=b"not an npz",
            headers={"Content-Type": "application/octet-stream"})
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(req, timeout=10)
        assert ei.value.code == 400
        # a shape the program does not take is the caller's fault too
        with pytest.raises(urllib.error.HTTPError) as ei:
            tserv.predict_http(url, [np.zeros((5, 8), np.float32)])
        assert ei.value.code == 400
        np.testing.assert_array_equal(tserv.predict_http(url, [x])[0], y)
        np.testing.assert_allclose(tserv.predict_http(url, [x])[0],
                                   arts["jax"][1], **TOL)
    finally:
        srv.stop()


def test_concurrent_requests_no_cross_leak(artifacts):
    """Concurrent callers on one replica each get their own outputs."""
    arts, x = artifacts
    pool = tserv.DevicePool(tinf.Config(prog_file=arts["torch"][0]),
                            devices=["cpu"])
    errs = []

    def worker(i):
        xi = (x + i).astype(np.float32)
        want = pool.run_on(0, [xi])[0]          # sequential reference
        for _ in range(10):
            if not np.array_equal(pool.run([xi])[0], want):
                errs.append(i)

    ts = [threading.Thread(target=worker, args=(i,)) for i in range(4)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert not errs, f"cross-request leaks from threads {errs}"


def test_inference_server_metrics_endpoint(artifacts):
    arts, x = artifacts
    srv = tserv.InferenceServer(tinf.Config(prog_file=arts["torch"][0]),
                                devices=["cpu"])
    port = srv.start()
    url = f"http://127.0.0.1:{port}"
    try:
        for _ in range(3):
            tserv.predict_http(url, [x])
        text = _get(url + "/metrics").decode()
        assert "paddle_tpu_http_predict_requests_total 3" in text
        stats = json.loads(_get(url + "/stats"))
        assert stats["metrics"][
            "paddle_tpu_http_predict_requests_total"]["value"] == 3
    finally:
        srv.stop()


# -- whole models, the kernels' ops, a child process ---------------------------
BERT = dict(vocab_size=128, hidden_size=128, num_hidden_layers=2,
            num_attention_heads=2, intermediate_size=256,
            max_position_embeddings=64)
LLAMA = dict(vocab_size=128, hidden_size=256, intermediate_size=512,
             num_hidden_layers=2, num_attention_heads=2,
             max_position_embeddings=64, tensor_parallel=False)


def _model_pair(kind):
    from paddle_tpu import models as jm
    from paddle_tpu_torch import models as tm
    jp.seed(55)
    if kind == "bert":
        j = jm.BertForQuestionAnswering(jm.BertConfig(**BERT))
        t = tm.BertForQuestionAnswering(tm.BertConfig(**BERT))
        ids = np.random.RandomState(0).randint(0, 128, (2, 32))
        inputs = [ids, np.zeros_like(ids)]
    else:
        j = jm.LlamaForCausalLM(jm.LlamaConfig(**LLAMA))
        t = tm.LlamaForCausalLM(tm.LlamaConfig(**LLAMA))
        inputs = [np.random.RandomState(1).randint(0, 128, (1, 32))]
    layer_state_from_jax(t, j.state_dict())
    j.eval()
    t.eval()
    return j, t, [a.astype(np.int64) for a in inputs]


def _graph_ops(path):
    ep = torch.export.load(path)
    return sorted({str(n.target).split(".")[1] for n in ep.graph.nodes
                   if str(n.target).startswith("paddle_tpu_torch.")})


@pytest.mark.parametrize("kind", ["bert", "llama"])
def test_whole_models_exported_by_both_packages_agree(kind, tmp_path):
    j, t, inputs = _model_pair(kind)
    specs = [(a.shape, "int64") for a in inputs]
    outs = {}
    for side, net in (("jax", j), ("torch", t)):
        art = INF[side].convert_to_export(net, specs,
                                          str(tmp_path / side / kind))
        outs[side] = INF[side].Predictor(INF[side].Config(
            prog_file=art)).run(inputs)
        if side == "torch":
            eager = t(*[tp.to_tensor(a) for a in inputs])
            eager = eager if isinstance(eager, (list, tuple)) else [eager]
            for got, want in zip(outs[side], eager):
                np.testing.assert_array_equal(got, want.numpy())
            ops = _graph_ops(art)
    assert len(outs["torch"]) == len(outs["jax"])
    for a, b in zip(outs["torch"], outs["jax"]):
        np.testing.assert_allclose(a, b, **MODEL_TOL)
    want = {"bert": ["flash_attention_fwd"],
            "llama": ["flash_attention_fwd", "fused_rope", "rms_norm_fwd"]}
    assert ops == want[kind]


def test_exported_graph_names_swiglu_and_segmented_ops(tmp_path):
    """K10a under FLAGS_pallas_swiglu, and K2 with its range kernel in a
    Layer that calls the segmented attention on segment ids it takes."""
    from paddle_tpu_torch.ops import flash_varlen as fv
    from paddle_tpu_torch.ops.dispatch import apply

    class Seg(tp.nn.Layer):
        def forward(self, q, seg):
            return apply("flash_attention_segmented",
                         lambda a, s: fv.flash_attention_segmented(
                             a, a, a, s, causal=True), q, seg)

    seg = np.repeat(np.arange(4, dtype=np.int32), 64)[None]
    q = np.random.RandomState(2).randn(1, 256, 2, 64).astype(np.float32)
    art = tinf.convert_to_export(Seg(), [q, seg], str(tmp_path / "seg"))
    assert _graph_ops(art) == ["flash_segmented_fwd", "segment_tile_ranges"]
    got = tinf.Predictor(tinf.Config(prog_file=art)).run([q, seg])[0]
    want = fv.segmented_sdpa_plain(*(torch.from_numpy(q),) * 3,
                                   torch.from_numpy(seg), True)
    np.testing.assert_array_equal(got, want.numpy())

    tp.set_flags({"FLAGS_pallas_swiglu": True})
    try:
        _, t, inputs = _model_pair("llama")
        art = tinf.convert_to_export(t, [(inputs[0].shape, "int64")],
                                     str(tmp_path / "sw"))
    finally:
        tp.set_flags({"FLAGS_pallas_swiglu": False})
    assert "swiglu_fwd" in _graph_ops(art)


def test_export_through_a_host_read_raises_and_names_it(tmp_path):
    """``F.flash_attn_unpadded`` reads its cu_seqlens on the host: an
    export of it raises at that read and names it (no fallback)."""
    F = tp.nn.functional

    def varlen(q, cu):
        return F.flash_attn_unpadded(q, q, q, cu, cu, 64, 64,
                                     causal=True)[0]

    with pytest.raises(HostReadError, match=r"Tensor\.numpy\(\).*"
                                            r"convert_to_export"):
        tinf.convert_to_export(varlen, [((128, 2, 64), "float32"),
                                        ((3,), "int32")],
                               str(tmp_path / "varlen"))


def test_a_child_process_serves_the_artifact_without_the_model(tmp_path):
    j, t, inputs = _model_pair("bert")
    art = tinf.convert_to_export(t, [(a.shape, "int64") for a in inputs],
                                 str(tmp_path / "bert"))
    np.savez(tmp_path / "in.npz", *inputs)
    code = (
        "import sys, numpy as np\n"
        "import paddle_tpu_torch as paddle\n"
        "paddle.set_device('cpu')\n"
        "from paddle_tpu_torch.inference import Config, create_predictor\n"
        f"z = np.load({str(tmp_path / 'in.npz')!r})\n"
        "xs = [z[k] for k in sorted(z.files)]\n"
        f"outs = create_predictor(Config({art!r})).run(xs)\n"
        "bad = sorted(m for m in sys.modules if m.startswith(\n"
        "    'paddle_tpu_torch.models') or m.split('.')[0] in\n"
        "    ('jax', 'paddle_tpu'))\n"
        "assert not bad, bad\n"
        f"np.savez({str(tmp_path / 'out.npz')!r}, *outs)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    r = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    z = np.load(tmp_path / "out.npz")
    eager = t(*[tp.to_tensor(a) for a in inputs])
    for k, want in zip(sorted(z.files), eager):
        np.testing.assert_array_equal(z[k], want.numpy())
