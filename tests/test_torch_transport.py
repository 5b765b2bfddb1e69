"""The port's sockets fleet (``paddle_tpu_torch/fleet/transport.py``,
``fleet/remote.py``, ``observability/transport_metrics.py`` and the fault
sites ``conn_drop``, ``frame_truncate``, ``net_delay``, ``agent_kill``)
held against ``paddle_tpu.fleet`` on the 2-layer fp32 config of
``tests/test_transport.py`` with the same weights (``params_from_jax``).

Each of ``tests/test_transport.py``'s 20 cases runs through JAX's stack and
the port's (each side with its own engines, agents, fault plane and
server), and the port is held to JAX's outcome: tokens, statuses, error
texts and the ``routed`` / ``failovers`` / ``deaths`` / ``replaces``
counters.  Where a case's counts depend on timing (leases expiring under
load, a probabilistic ``net_delay``), both sides are held to the
invariants JAX's case states and their tokens to the same reference.  The
SIGKILL case spawns a port agent only (``agent_factory.make_engine`` over
JAX's weights in an ``.npz``) and holds it to JAX's reference tokens.

Then the port's own: ``send_frame`` bytes equal to JAX's for the same
header and arrays (bf16 as ``'<V2'``, int8 pages with their scale planes),
an exported record's blocks packed in JAX's ``[L, pages, ...]`` layout, a
port router driving a JAX agent and a JAX router driving a port agent (a
hand-off between the two included), ``RemoteSpec`` through ``connect=``,
``add_replica`` and the autoscaler, the trace of a remote request
(``tests/test_tracing.py::test_remote_replica_trace_rides_the_wire``) and
the ``TransportMetrics`` catalogue (``tests/test_observability.py``).
"""

import importlib
import json
import os
import signal
import socket
import struct
import sys
import time
import types
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

import paddle_tpu.fleet as jfleet  # noqa: E402
import paddle_tpu.fleet.remote as jremote  # noqa: E402
import paddle_tpu.fleet.transport as jtransport  # noqa: E402
import paddle_tpu.inference.serving as jsrv  # noqa: E402
import paddle_tpu.models.disagg as jdg  # noqa: E402
import paddle_tpu.observability as jobs  # noqa: E402
import paddle_tpu_torch.fleet as tfleet  # noqa: E402
import paddle_tpu_torch.fleet.remote as tremote  # noqa: E402
import paddle_tpu_torch.fleet.transport as ttransport  # noqa: E402
import paddle_tpu_torch.inference.serving as tsrv  # noqa: E402
import paddle_tpu_torch.models.disagg as tdg  # noqa: E402
import paddle_tpu_torch.observability as tobs  # noqa: E402
from paddle_tpu.models import llama_pretrain as jlp  # noqa: E402
from paddle_tpu.models import paged_decode as jpd  # noqa: E402
from paddle_tpu.models import serving_engine as jse  # noqa: E402
from paddle_tpu.testing import faults as jfaults  # noqa: E402
from paddle_tpu_torch.models import llama_pretrain as tlp  # noqa: E402
from paddle_tpu_torch.models import paged_decode as tpd  # noqa: E402
from paddle_tpu_torch.models import serving_engine as tse  # noqa: E402
from paddle_tpu_torch.models.weights import params_from_jax  # noqa: E402
from paddle_tpu_torch.testing import agent_factory  # noqa: E402
from paddle_tpu_torch.testing import faults as tfaults  # noqa: E402

CACHE = dict(num_pages=64, pages_max=8, batch=2, page=16)
_RNG = np.random.RandomState(7)
PROMPTS = [_RNG.randint(1, 128, (L,)) for L in (10, 21, 8, 17)]
SOAK = [_RNG.randint(1, 128, (L,))
        for L in (10, 21, 8, 17, 12, 25, 9, 14, 19, 7, 23, 11)]
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def sides():
    """Per side: the engine, cache, disagg, fleet, transport, remote, fault,
    server and observability modules, and the config and weights."""
    jcfg = jlp.LlamaPretrainConfig(**agent_factory.TEST_CONFIG,
                                   dtype=jnp.float32,
                                   param_dtype=jnp.float32)
    tcfg = tlp.LlamaPretrainConfig(**agent_factory.TEST_CONFIG,
                                   dtype=torch.float32)
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1, 1, 1, 1),
                ("dp", "pp", "sharding", "sep", "mp"))
    jparams = jlp.init_params(jcfg, jax.random.PRNGKey(0), mesh)
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    return {
        "jax": types.SimpleNamespace(
            name="jax", se=jse, pd=jpd, dg=jdg, fleet=jfleet,
            transport=jtransport, remote=jremote, faults=jfaults,
            srv=jsrv, obs=jobs, cfg=jcfg, params=jparams, tree=tree,
            dev={}),
        "port": types.SimpleNamespace(
            name="port", se=tse, pd=tpd, dg=tdg, fleet=tfleet,
            transport=ttransport, remote=tremote, faults=tfaults,
            srv=tsrv, obs=tobs, cfg=tcfg,
            params=params_from_jax(tree, device="cpu"), tree=tree,
            dev={"device": "cpu"})}


def engine_cls(S, engine="unified"):
    return {"unified": S.se.ContinuousBatchingEngine,
            "prefill": S.dg.PrefillEngine,
            "decode": S.dg.DecodeEngine}[engine]


def factory(S, engine="unified", **kw):
    """One engine factory of side ``S`` (cache keywords split off)."""
    def mk():
        ck = dict(CACHE)
        for k in ("num_pages", "pages_max", "batch", "page", "host_pages",
                  "kv_quant"):
            if k in kw:
                ck[k] = kw[k]
        ek = {k: v for k, v in kw.items() if k not in ck}
        cache = S.pd.PagedKVCache(S.cfg, **ck, **S.dev)
        return engine_cls(S, engine)(S.cfg, S.params, cache,
                                     metrics_registry=False, **ek)
    return mk


def spec(S, *, lease=2.0, timeout=5.0, retries=3, backoff=0.01,
         role="unified", engine="unified", seed=0, **ekw):
    """An in-thread RemoteSpec of side ``S`` (tests/test_transport.py's
    ``_spec``)."""
    mk = factory(S, engine, **ekw)
    return S.fleet.RemoteSpec(
        agent=lambda: S.fleet.ReplicaAgent(mk, role=role, lease_s=lease),
        role=role, lease_s=lease, rpc_timeout_s=timeout,
        max_retries=retries, backoff_s=backoff, jitter_seed=seed)


def both(sides, scenario):
    """Run ``scenario(S)`` on each side -> (jax result, port result)."""
    return scenario(sides["jax"]), scenario(sides["port"])


_REF = {}


def ref(S, prompts, new=6, kv_quant=None):
    """The unloaded greedy outputs of one in-process engine of ``S``."""
    key = (S.name, new, kv_quant,
           tuple(bytes(np.asarray(p)) for p in prompts))
    if key not in _REF:
        kw = {"kv_quant": kv_quant} if kv_quant else {}
        eng = factory(S, **kw)()
        rids = [eng.submit(p, max_new_tokens=new) for p in prompts]
        done = {r.rid: [int(t) for t in r.generated]
                for r in eng.run_to_completion()}
        _REF[key] = [done[r] for r in rids]
    return _REF[key]


def outcome(done):
    """fleet rid -> (status, error, tokens)."""
    return {r.rid: (r.status, r.error, [int(t) for t in r.generated])
            for r in done}


def counters(router):
    return {"routed": dict(router.routed), "failovers": router.failovers,
            "deaths": router.deaths, "replaces": router.replaces,
            "rejected": router.rejected,
            "states": [h.state for h in router._replicas]}


def teardown(router):
    for h in router._replicas:
        if getattr(h, "_agent", None) is not None:
            h._agent.die()
        if getattr(h, "_proc", None) is not None and h._proc.is_alive():
            h._proc.terminate()
            h._proc.join(10)


def audit_all(router):
    for h in router._replicas:
        if h.state in ("READY", "DEGRADED", "DRAINING"):
            h.engine.cache.audit()


def run_all(router, prompts, new=6, **kw):
    rids = [router.submit(p, max_new_tokens=new, **kw) for p in prompts]
    done = {r.rid: r for r in router.run_to_completion(max_steps=1_000_000)}
    return rids, done


def raw_frame(S, header, blobs):
    """The bytes side ``S``'s send_frame writes for one frame."""
    a, b = socket.socketpair()
    try:
        n = S.transport.send_frame(a, header, blobs)
        got = bytearray()
        while len(got) < n:
            got += b.recv(n - len(got))
        return bytes(got), n
    finally:
        a.close()
        b.close()


# ---------------------------------------------------------------------------
# frame layer: bitwise blobs, loud protocol failures
# ---------------------------------------------------------------------------
def jax_pack(a):
    """JAX's ``pack_array``; for an ``ml_dtypes.bfloat16`` array, which
    numpy's buffer protocol refuses to export (JAX's ``a.data`` raises), the
    meta it writes (``a.dtype.str``, ``'<V2'``) and the array's bytes."""
    if a is not None and a.dtype == ml_dtypes.bfloat16:
        with pytest.raises(ValueError, match="buffer"):
            jtransport.pack_array(a)
        a = np.ascontiguousarray(a)
        return {"dtype": a.dtype.str, "shape": list(a.shape)}, a.tobytes()
    return jtransport.pack_array(a)


def test_pack_unpack_bitwise_all_dtypes():
    """Numpy arrays pack to JAX's meta and bytes; CPU tensors of the same
    values pack to the same; the port unpacks to tensors of those bytes
    (bf16 as ``'<V2'`` both ways)."""
    rng = np.random.RandomState(0)
    arrays = [
        rng.standard_normal((2, 3, 4)).astype(np.float32),
        rng.standard_normal((5,)).astype(np.float16),
        rng.randint(-128, 127, (3, 7), dtype=np.int8),
        rng.randint(0, 1 << 40, (4,), dtype=np.int64),
        np.asfortranarray(rng.standard_normal((6, 6))),  # non-contiguous
        rng.standard_normal((3, 5)).astype(ml_dtypes.bfloat16),
        None,                       # an fp pool's absent scale plane
    ]
    for a in arrays:
        jm, jb = jax_pack(a)
        tm, tb = ttransport.pack_array(a)
        assert tm == jm and bytes(tb) == bytes(jb)
        if a is None:
            assert ttransport.unpack_array(tm, tb) is None
            continue
        c = np.ascontiguousarray(a)
        if a.dtype == ml_dtypes.bfloat16:
            assert tm["dtype"] == "<V2"
            t = torch.from_numpy(c.view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(c)
        # the same values as a CPU tensor (a transposed view too)
        for tt in (t, t.flip(0).contiguous().flip(0),
                   t.transpose(0, -1).contiguous().transpose(0, -1)):
            m2, b2 = ttransport.pack_array(tt)
            assert m2 == jm and bytes(b2) == bytes(jb)
        back = ttransport.unpack_array(tm, tb)
        assert torch.is_tensor(back) and list(back.shape) == list(a.shape)
        assert back.dtype == t.dtype
        assert back.contiguous().numpy().tobytes() == c.tobytes() \
            if back.dtype != torch.bfloat16 else \
            back.view(torch.int16).numpy().tobytes() == c.tobytes()
    with pytest.raises(ValueError, match="host arrays"):
        ttransport.pack_array(torch.zeros(2, device="meta"))


def test_send_frame_bytes_equal_jax_over_socketpair():
    """One frame of a hand-off's header and blobs (an int64 prompt, bf16
    pages, int8 pages with their f32 scale planes, raw bytes): the port's
    send_frame writes JAX's bytes, and each side reads the other's frame
    (tests/test_transport.py::test_frame_roundtrip_over_socketpair)."""
    rng = np.random.RandomState(3)
    prompt = np.arange(17, dtype=np.int64)
    kb = rng.standard_normal((2, 3, 2, 16, 16)).astype(ml_dtypes.bfloat16)
    k8 = rng.randint(-127, 128, (2, 3, 2, 16, 16)).astype(np.int8)
    ks = rng.random_sample((2, 3, 2, 16)).astype(np.float32)
    jarrs = [prompt, kb, k8, ks]
    tarrs = [torch.from_numpy(prompt),
             torch.from_numpy(kb.view(np.int16)).view(torch.bfloat16),
             torch.from_numpy(k8), torch.from_numpy(ks)]

    def frame(pack, arrs):
        metas, blobs = zip(*(pack(a) for a in arrs))
        header = {"op": "probe", "seq": 3, "nested": {"k": [1, 2]},
                  "metas": list(metas)}
        return header, list(blobs) + [b"xyz"]

    jh, jbl = frame(jax_pack, jarrs)
    th, tbl = frame(ttransport.pack_array, tarrs)
    assert th == jh and [m["dtype"] for m in th["metas"]] == \
        ["<i8", "<V2", "|i1", "<f4"]
    jraw, jn = raw_frame(sides_stub("jax"), jh, jbl)
    traw, tn = raw_frame(sides_stub("port"), th, tbl)
    assert traw == jraw and tn == jn
    assert traw[:4] == b"PTF1"
    # each side reads the other's frame
    for reader, raw in ((ttransport, jraw), (jtransport, traw)):
        a, b = socket.socketpair()
        try:
            a.sendall(raw)
            got, rblobs, read = reader.recv_frame(b)
        finally:
            a.close()
            b.close()
        assert got == jh and read == len(raw)
        assert [bytes(x) for x in rblobs] == [bytes(x) for x in jbl]
    back = [ttransport.unpack_array(m, b)
            for m, b in zip(th["metas"], tbl)]
    assert torch.equal(back[1].view(torch.int16), tarrs[1].view(torch.int16))
    assert torch.equal(back[2], tarrs[2]) and torch.equal(back[3], tarrs[3])
    assert np.array_equal(
        ttransport.unpack_array({"dtype": "<f4", "shape": [2]},
                                np.float32([1.5, -2.25]).data).numpy(),
        np.float32([1.5, -2.25]))


def sides_stub(name):
    return types.SimpleNamespace(
        transport=jtransport if name == "jax" else ttransport)


def test_frame_bad_magic_and_truncation_raise_protocol_error(sides):
    def run(S):
        out = []
        a, b = socket.socketpair()
        try:
            a.sendall(b"JUNKxxxxxxxxxxxx")
            a.close()
            with pytest.raises(S.transport.ProtocolError) as e:
                S.transport.recv_frame(b)
            out.append(str(e.value))
        finally:
            b.close()
        a, b = socket.socketpair()
        try:
            S.transport.send_frame(a, {"op": "x"}, [b"0123456789"])
            hdr = json.dumps({"op": "y"}).encode()
            pre = struct.pack("<4sII", b"PTF1", len(hdr), 1) + \
                struct.pack("<Q", 100) + hdr
            a.sendall(pre + b"short")
            a.close()
            out.append(S.transport.recv_frame(b)[0])     # frame 1 intact
            with pytest.raises(S.transport.ProtocolError) as e:
                S.transport.recv_frame(b)
            out.append(str(e.value))
        finally:
            b.close()
        return out

    j, t = both(sides, run)
    assert t == j
    assert "magic" in t[0] and "mid-frame" in t[2]


def test_wire_request_shifts_clocks_preserves_structure(sides):
    """Both sides' wire dicts carry the same keys and values for the same
    request, and a JAX wire dict reads back on the port."""
    def make(S):
        req = S.se.Request(5, np.arange(4, dtype=np.int64), 8,
                           t_submit=time.monotonic() - 3.0,
                           deadline=time.monotonic() + 7.0)
        req.generated = [1, 2, 3]
        req.status = "ok"
        req.phase_log = [("queued", time.monotonic() - 3.0,
                          time.monotonic() - 2.0)]
        return req

    def strip(d):
        return {k: v for k, v in d.items()
                if k not in ("now", "deadline", "t_submit", "phase_log")}

    jd = jremote.wire_request(make(sides["jax"]))
    td = tremote.wire_request(make(sides["port"]))
    assert set(td) == set(jd) and strip(td) == strip(jd)
    for d in (jd, td):
        d = json.loads(json.dumps(d))
        back = tremote.request_from_wire(d, torch.arange(4))
        assert back.rid == 5 and back.generated == [1, 2, 3]
        assert back.status == "ok" and back.prompt.dtype == np.int64
        now = time.monotonic()
        assert abs((back.deadline - now) - 7.0) < 0.5
        (p, t0, t1), = back.phase_log
        assert p == "queued" and abs((t1 - t0) - 1.0) < 0.05


# ---------------------------------------------------------------------------
# one agent, one connection: RPC semantics
# ---------------------------------------------------------------------------
def test_agent_rpc_end_to_end_cursor_delivery(sides):
    def run(S):
        agent = S.fleet.ReplicaAgent(factory(S), lease_s=5.0)
        port = agent.start()
        conn = S.transport.open_connection(("127.0.0.1", port))
        try:
            hello, _ = conn.call("hello", idempotent=True)
            assert hello["pid"] == os.getpid()
            prompt = np.ascontiguousarray(PROMPTS[0].astype(np.int64))
            resp, _ = conn.call("submit",
                                {"max_new_tokens": 6, "key": "c:0"},
                                [prompt.data], idempotent=True)
            rid = resp["rid"]
            toks, fin, ack, t0 = [], None, -1, time.monotonic()
            while fin is None:
                assert time.monotonic() - t0 < 60.0
                resp, _ = conn.call("sync", {"ack": ack}, idempotent=True)
                for ev in resp["events"]:
                    ack = ev[0]
                    if ev[1] == "tok":
                        assert ev[2] == rid
                        toks.append(ev[3])
                    else:
                        fin = ev[2]
                time.sleep(0.005)
            # an unacked re-sync serves the buffered events again
            again, _ = conn.call("sync", {"ack": -1}, idempotent=True)
            audit, _ = conn.call("audit", idempotent=True)
            hello = {k: v for k, v in hello.items()
                     if k not in ("pid", "now", "device")}
            return (hello, rid, toks, fin["rid"], fin["status"],
                    fin["generated"],
                    [ev[2]["generated"] for ev in again["events"]
                     if ev[1] == "fin"],
                    audit["audit"].get("leaked_pages", 0))
        finally:
            conn.close()
            agent.die()

    j, t = both(sides, run)
    assert t == j
    assert t[0]["role"] == "unified" and t[0]["page"] == 16
    assert t[0]["B"] == 2 and t[0]["n_params"] > 0
    assert t[2] == t[5] == ref(sides["port"], PROMPTS[:1])[0]
    assert t[6] == [t[5]]


def test_ambiguous_timeout_retry_never_double_generates(sides):
    """A submit frame that landed but whose reply was lost, retried with
    the same key: the agent answers with the original rid, and one
    generation runs."""
    def run(S):
        agent = S.fleet.ReplicaAgent(factory(S), lease_s=5.0)
        addr = ("127.0.0.1", agent.start())
        prompt = np.ascontiguousarray(PROMPTS[0].astype(np.int64))
        raw = socket.create_connection(addr)
        S.transport.send_frame(raw, {"op": "submit", "seq": 1,
                                     "max_new_tokens": 6,
                                     "key": "cli:r1"}, [prompt.data])
        raw.close()
        t0 = time.monotonic()
        while "cli:r1" not in agent._by_key:
            assert time.monotonic() - t0 < 30.0
            time.sleep(0.005)
        first = agent._by_key["cli:r1"]
        conn = S.transport.open_connection(addr)
        try:
            r1, _ = conn.call("submit", {"max_new_tokens": 6,
                                         "key": "cli:r1"},
                              [prompt.data], idempotent=True)
            t0 = time.monotonic()
            while True:
                assert time.monotonic() - t0 < 60.0
                s, _ = conn.call("sync", {"ack": -1}, idempotent=True)
                fins = [ev for ev in s["events"] if ev[1] == "fin"]
                if fins:
                    break
                time.sleep(0.005)
            r2, _ = conn.call("submit", {"max_new_tokens": 6,
                                         "key": "cli:r1"},
                              [prompt.data], idempotent=True)
            return (first, r1["rid"], r1.get("dedup"), len(fins),
                    s["snap"]["requests_finished"], r2["rid"],
                    r2.get("dedup"))
        finally:
            conn.close()
            agent.die()

    j, t = both(sides, run)
    assert t == j
    assert t[1] == t[0] == t[5] and t[2] and t[6]
    assert t[3] == 1 and t[4] == 1


def test_agent_survives_garbage_frames(sides):
    """A client speaking garbage loses its connection; the agent keeps
    serving the others."""
    def run(S):
        agent = S.fleet.ReplicaAgent(factory(S), lease_s=5.0)
        addr = ("127.0.0.1", agent.start())
        bad = socket.create_connection(addr)
        bad.sendall(b"NOT A FRAME AT ALL" * 3)
        conn = S.transport.open_connection(addr)
        try:
            resp, _ = conn.call("ping", idempotent=True)
            bad.settimeout(5.0)
            try:
                dropped = bad.recv(1) == b""
            except ConnectionResetError:
                dropped = True
            return resp["state"], dropped
        finally:
            bad.close()
            conn.close()
            agent.die()

    j, t = both(sides, run)
    assert t == j == ("READY", True)


def test_graceful_shutdown_finishes_inflight_streams(sides):
    """shutdown(graceful) refuses new submissions, finishes the streams in
    flight and exits after the last ack.  The port's agent also wakes its
    blocked threads (shutdown before close), so every one of them has
    exited when it stops; the wait here polls the stop flag on both sides
    (JAX's join waits out its timeout on a thread blocked in recv)."""
    def run(S):
        agent = S.fleet.ReplicaAgent(factory(S), lease_s=5.0)
        conn = S.transport.open_connection(("127.0.0.1", agent.start()))
        try:
            rids = []
            for i, p in enumerate(PROMPTS[:2]):
                prompt = np.ascontiguousarray(p.astype(np.int64))
                r, _ = conn.call("submit", {"max_new_tokens": 6,
                                            "key": f"g:{i}"},
                                 [prompt.data], idempotent=True)
                rids.append(r["rid"])
            conn.call("shutdown", {"graceful": True}, idempotent=True)
            with pytest.raises(RuntimeError, match="shutting down") as e:
                conn.call("submit", {"max_new_tokens": 2, "key": "g:x"},
                          [np.int64([1, 2]).data])
            fins, ack, t0 = {}, -1, time.monotonic()
            while len(fins) < 2:
                assert time.monotonic() - t0 < 60.0
                resp, _ = conn.call("sync", {"ack": ack}, idempotent=True)
                for ev in resp["events"]:
                    ack = ev[0]
                    if ev[1] == "fin":
                        fins[ev[2]["rid"]] = ev[2]
                time.sleep(0.005)
            try:
                # the last ack lets the agent drain and exit, which may
                # close the socket before this reply goes out
                conn.call("sync", {"ack": ack}, idempotent=True)
            except S.transport.TransportError:
                pass
            t0 = time.monotonic()
            while not agent._stop:
                assert time.monotonic() - t0 < 30.0
                time.sleep(0.005)
            if S.name == "port":
                agent.join(timeout=5.0)
                assert not any(th.is_alive() for th in agent._threads)
            return ([fins[r]["generated"] for r in rids],
                    [fins[r]["status"] for r in rids], str(e.value))
        finally:
            conn.close()
            agent.die()

    t0 = time.monotonic()
    t = run(sides["port"])
    port_s = time.monotonic() - t0
    j = run(sides["jax"])
    assert t == j
    assert t[0] == ref(sides["port"], PROMPTS[:2]) and t[1] == ["ok"] * 2
    assert port_s < 15.0


def test_arm_fault_spec_local_plane(sides):
    """A JSON-able spec arms this process's plane (agents run it at
    start), each package's into its own plane."""
    def run(S):
        with S.faults.plane():
            S.remote.arm_fault_spec([
                {"site": "conn_drop", "exc": "ConnectionError:boom",
                 "nth": 1},
                {"site": "net_delay", "every": 2, "times": 1}])
            with pytest.raises(ConnectionError, match="boom"):
                S.faults.fire("conn_drop")
            S.faults.fire("conn_drop")
            seen = [S.faults.active("net_delay") for _ in range(3)]
        return seen, S.faults.get()

    j, t = both(sides, run)
    assert t == j == ([False, True, False], None)


# ---------------------------------------------------------------------------
# the oracle: socket fleet == in-process fleet
# ---------------------------------------------------------------------------
def test_remote_fleet_token_exact_vs_in_process(sides):
    def run(S):
        inproc = S.fleet.FleetRouter([factory(S)] * 2,
                                     metrics_registry=False)
        rids, via = run_all(inproc, PROMPTS)
        router = S.fleet.FleetRouter([spec(S), spec(S)])
        try:
            rrids, done = run_all(router, PROMPTS)
            audit_all(router)
            snap = router.fleet_snapshot()
            return ([list(via[r].generated) for r in rids],
                    [outcome([done[r]])[r] for r in rrids],
                    counters(router), sorted(snap["transport"]),
                    snap["transport"]["frames"] > 0,
                    [rep["transport"]["mode"] for rep in snap["replicas"]],
                    sorted(snap["replicas"][0]["transport"]))
        finally:
            teardown(router)

    j, t = both(sides, run)
    assert t == j
    want = ref(sides["port"], PROMPTS)
    assert t[0] == want and [g for _, _, g in t[1]] == want
    assert t[4] and t[5] == ["thread", "thread"]


def test_remote_disagg_handoff_round_trips_the_wire(sides):
    """Remote prefill -> remote decode over int8 pages: the blocks (pools
    and scale planes) cross the wire and the decode agent adopts them
    without a prefill, token-exact against the unified engine."""
    def run(S):
        router = S.fleet.FleetRouter(
            [spec(S, role="prefill", engine="prefill", kv_quant="int8",
                  host_pages=32),
             spec(S, role="decode", engine="decode", kv_quant="int8",
                  host_pages=32)],
            handoff_gbps=1e9)
        try:
            rids, done = run_all(router, PROMPTS)
            de = router._replicas[1]._agent._sup.engine
            audit_all(router)
            snap = router.fleet_snapshot()
            return ([outcome([done[r]])[r] for r in rids], counters(router),
                    router.handoffs_shipped, de.prefill_calls,
                    de.cache.kv_quant, snap["roles"],
                    snap["transport"]["bytes"] > sum(p.size for p in PROMPTS)
                    * 8)
        finally:
            teardown(router)

    j, t = both(sides, run)
    assert t == j
    assert [g for _, _, g in t[0]] == ref(sides["port"], PROMPTS,
                                          kv_quant="int8")
    assert t[1]["routed"]["disagg"] == t[2] == len(PROMPTS)
    assert t[3] == 0 and t[4] == "int8" and t[6]
    assert t[5] == {"unified": 0, "prefill": 1, "decode": 1}


def test_remote_fleet_server_http_and_metrics(sides):
    def run(S):
        reg = S.obs.MetricsRegistry()
        router = S.fleet.FleetRouter([spec(S), spec(S)],
                                     metrics_registry=reg)
        srv = S.fleet.FleetServer(router)
        url = f"http://127.0.0.1:{srv.start()}"
        try:
            toks = S.srv.generate_http(url, [int(x) for x in PROMPTS[0]],
                                       max_new_tokens=6)
            with urllib.request.urlopen(url + "/fleet", timeout=10) as r:
                doc = json.loads(r.read())
            with urllib.request.urlopen(url + "/metrics", timeout=10) as r:
                text = r.read().decode()
            names = sorted({line.split(" ")[0].split("{")[0]
                            for line in text.splitlines()
                            if line.startswith("paddle_tpu_transport_")})
            return (toks, doc["transport"]["frames"] > 0,
                    all("transport" in rep for rep in doc["replicas"]),
                    names,
                    reg.get("paddle_tpu_transport_frames_total").value > 0)
        finally:
            srv.stop()
            teardown(router)

    j, t = both(sides, run)
    assert t == j
    assert t[0] == ref(sides["port"], PROMPTS[:1])[0]
    assert t[1] and t[2] and t[4]
    assert "paddle_tpu_transport_rtt_seconds_bucket" in t[3]


# ---------------------------------------------------------------------------
# chaos: each transport fault site, seeded; no request lost
# ---------------------------------------------------------------------------
def test_chaos_conn_drop_retries_token_exact(sides):
    def run(S):
        with S.faults.plane() as fp:
            fp.inject("conn_drop", ConnectionResetError("injected"),
                      every=5)
            router = S.fleet.FleetRouter([spec(S), spec(S, seed=1)])
            try:
                rids, done = run_all(router, PROMPTS)
                snap = router.fleet_snapshot()
                audit_all(router)
                c = counters(router)
                return ([outcome([done[r]])[r] for r in rids], c["routed"],
                        c["failovers"], c["deaths"], c["replaces"],
                        snap["transport"]["retries"] > 0,
                        snap["transport"]["reconnects"] > 0,
                        fp.fired.get("conn_drop", 0) > 0)
            finally:
                teardown(router)

    j, t = both(sides, run)
    assert t == j
    assert [g for _, _, g in t[0]] == ref(sides["port"], PROMPTS)
    assert all(s == "ok" for s, _, _ in t[0]) and all(t[5:])


def test_chaos_frame_truncate_peer_recovers(sides):
    """A cut frame reaches the agent, which drops that connection and keeps
    serving; the client dials again and the run stays token-exact."""
    def run(S):
        with S.faults.plane() as fp:
            fp.inject("frame_truncate", nth=3, times=2)
            router = S.fleet.FleetRouter([spec(S)])
            try:
                rids, done = run_all(router, PROMPTS)
                audit_all(router)
                c = counters(router)
                return ([outcome([done[r]])[r] for r in rids], c["routed"],
                        c["failovers"], c["deaths"],
                        router.fleet_snapshot()["transport"]["reconnects"],
                        fp.fired.get("frame_truncate"))
            finally:
                teardown(router)

    j, t = both(sides, run)
    assert t == j
    assert [g for _, _, g in t[0]] == ref(sides["port"], PROMPTS)
    assert t[4] > 0 and t[5] == 1          # nth=3 matches once


def test_chaos_net_delay_degrades_then_recovers(sides):
    """A stalled link trips the tight RPC timeout: the replica turns
    DEGRADED (a heartbeat miss, the lease still live) and READY again when
    the delay clears; no death, no failover, nothing dropped."""
    def run(S):
        with S.faults.plane() as fp:
            fp.inject("net_delay", every=3, times=4)
            router = S.fleet.FleetRouter(
                [spec(S, lease=30.0, timeout=0.02, retries=0),
                 spec(S, lease=30.0, timeout=0.02, retries=0, seed=1)])
            try:
                rids = [router.submit(p, max_new_tokens=6) for p in PROMPTS]
                saw, done, t0 = False, {}, time.monotonic()
                while router.has_work():
                    assert time.monotonic() - t0 < 120.0
                    router.step()
                    saw |= any(h.state == "DEGRADED"
                               for h in router._replicas)
                    done.update((r.rid, r) for r in router.finished())
                snap = router.fleet_snapshot()
                audit_all(router)
                c = counters(router)
                return ([outcome([done[r]])[r] for r in rids], saw,
                        c["failovers"], c["deaths"],
                        all(h.state in ("READY", "DEGRADED")
                            for h in router._replicas),
                        snap["transport"]["heartbeat_misses"] > 0,
                        fp.fired.get("net_delay"))
            finally:
                teardown(router)

    j, t = both(sides, run)
    assert t == j
    assert [g for _, _, g in t[0]] == ref(sides["port"], PROMPTS)
    assert t[1] and t[2] == t[3] == 0 and t[4] and t[5] and t[6] == 4


def test_chaos_agent_kill_lease_death_failover_token_exact(sides):
    """``agent_kill`` tears an agent down before its first sync: the lease
    expires, the death triage fails its requests (none streamed) over
    token-exact with rid and absolute deadline, auto_replace rebuilds.
    The lease is 0.4 s, so a loaded host can expire a survivor's too: both
    sides are held to JAX's case's invariants (every request ends ok or
    error, ok ones token-exact with their deadline, a death, a replace,
    no replica left DEAD)."""
    def run(S):
        with S.faults.plane() as fp:
            fp.inject("agent_kill", RuntimeError("chaos"), nth=1, times=1)
            router = S.fleet.FleetRouter(
                [spec(S, lease=0.4, timeout=0.3, retries=2),
                 spec(S, lease=0.4, timeout=0.3, retries=2, seed=1)])
            try:
                rids, deadlines = [], {}
                for p in PROMPTS:
                    rid = router.submit(p, max_new_tokens=6,
                                        deadline_s=300.0)
                    rids.append(rid)
                    deadlines[rid] = router._requests[rid].deadline
                done = {r.rid: r for r in
                        router.run_to_completion(max_steps=1_000_000)}
                want = ref(S, PROMPTS)
                ok = [done[r].status == "ok" for r in rids]
                held = all(done[r].status in ("ok", "error") for r in rids)
                exact = all(list(done[r].generated) == want[i]
                            and abs(done[r].deadline - deadlines[r]) < 1.0
                            for i, r in enumerate(rids) if ok[i])
                snap = router.fleet_snapshot()
                audit_all(router)
                return (set(done) == set(rids), held, exact,
                        snap["deaths"] >= 1, snap["replaces"] >= 1,
                        snap["failovers"] >= 2, snap["states"]["DEAD"],
                        snap["states"]["READY"] >= 1,
                        fp.fired.get("agent_kill"))
            finally:
                teardown(router)

    j, t = both(sides, run)
    assert t == j == (True, True, True, True, True, True, 0, True, 1)


def test_chaos_mixed_schedule_soak_no_silent_drops(sides):
    """All four transport sites armed at once under 12 requests: every
    request ends ok / cancelled / expired / error, ok means token-exact,
    the surviving replicas audit clean."""
    def run(S):
        with S.faults.plane() as fp:
            fp.inject("conn_drop", ConnectionResetError("injected"),
                      every=11)
            fp.inject("frame_truncate", nth=20, times=1)
            fp.inject("net_delay", p=0.03, seed=5)
            fp.inject("agent_kill", RuntimeError("chaos"), nth=7, times=1)
            router = S.fleet.FleetRouter(
                [spec(S, lease=0.4, timeout=0.3, retries=2),
                 spec(S, lease=0.4, timeout=0.3, retries=2, seed=1),
                 spec(S, lease=0.4, timeout=0.3, retries=2, seed=2)])
            try:
                rids, done = run_all(router, SOAK)
                audit_all(router)
                want = ref(S, SOAK)
                ok = all(done[r].status in ("ok", "cancelled", "expired",
                                            "error") for r in rids)
                exact = all(list(done[r].generated) == want[i]
                            for i, r in enumerate(rids)
                            if done[r].status == "ok")
                # every site consulted (whether the 7th agent_kill consult
                # comes depends on how many ticks the run takes)
                return (set(done) == set(rids), ok, exact,
                        router.fleet_snapshot()["states"]["READY"] >= 2,
                        all(fp.counts.get(site, 0) > 0 for site in
                            ("conn_drop", "frame_truncate", "net_delay",
                             "agent_kill")))
            finally:
                teardown(router)

    j, t = both(sides, run)
    assert t == j == (True, True, True, True, True)


def test_sigkill_process_agent_mid_decode(sides, tmp_path):
    """A port agent in its own OS process (``agent_factory.make_engine``
    over JAX's weights, spawned) is SIGKILLed mid-decode: the lease
    expires, requests that streamed nothing fail over token-exact (JAX's
    reference tokens) onto the in-thread survivor, the others end with an
    error, none is lost."""
    S = sides["port"]
    weights = str(tmp_path / "w.npz")
    agent_factory.save_weights(weights, S.tree)
    spawn = S.fleet.RemoteSpec(
        spawn={"factory": "paddle_tpu_torch.testing.agent_factory:"
                          "make_engine",
               "factory_kwargs": {"weights": weights},
               "agent_kwargs": {"lease_s": 0.6}},
        lease_s=0.6, rpc_timeout_s=0.5, max_retries=1, backoff_s=0.01)
    t0 = time.monotonic()
    router = S.fleet.FleetRouter([spawn, spec(S)], auto_replace=False)
    try:
        h = router._replicas[0]
        assert h._proc is not None and h._proc.is_alive()
        assert h._proc.pid != os.getpid()
        assert h.transport_snapshot()["mode"] == "process"
        router._replicas[1].state = "DRAINING"
        rids = [router.submit(p, max_new_tokens=6) for p in PROMPTS]
        router._replicas[1].state = "READY"
        t1 = time.monotonic()
        while h.snap.get("decode_steps", 0) == 0:
            assert time.monotonic() - t1 < 60.0, "agent never decoded"
            router.step()
            time.sleep(0.01)
        streamed = {rid: router._requests[rid].streamed for rid in rids
                    if rid in router._requests}
        os.kill(h._proc.pid, signal.SIGKILL)
        done = {r.rid: r for r in
                router.run_to_completion(max_steps=1_000_000)}
        want = ref(sides["jax"], PROMPTS)
        assert set(done) == set(rids), "SIGKILL lost a request"
        for i, rid in enumerate(rids):
            assert done[rid].status in ("ok", "error")
            if streamed.get(rid, 0) == 0:
                assert done[rid].status == "ok"
                assert list(done[rid].generated) == want[i]
            if done[rid].status == "error":
                assert "died" in done[rid].error
        assert router.deaths == 1
        h._proc.join(10)
        assert h._proc.exitcode == -signal.SIGKILL
        router._replicas[1].engine.cache.audit()
        assert time.monotonic() - t0 < 30.0
    finally:
        teardown(router)


def test_remote_drain_and_replace_lifecycle(sides):
    """drain() over the wire: the agent finishes its work, reports drained
    through the sync, and the router replaces it with a fresh agent that
    serves."""
    def run(S):
        router = S.fleet.FleetRouter([spec(S)])
        try:
            first = router._replicas[0]._agent
            rids = [router.submit(p, max_new_tokens=6) for p in PROMPTS[:2]]
            router.drain(0)
            done = {r.rid: r for r in router.run_to_completion(100000)}
            h = router._replicas[0]
            t0 = time.monotonic()
            while h.state != "READY" or h.replaces < 1:
                assert time.monotonic() - t0 < 60.0
                router.step()
                time.sleep(0.005)
            fresh = h._agent is not first
            rid = router.submit(PROMPTS[2], max_new_tokens=6)
            more = {r.rid: r for r in router.run_to_completion(100000)}
            audit_all(router)
            return ([outcome([done[r]])[r] for r in rids], fresh,
                    outcome([more[rid]])[rid], counters(router))
        finally:
            teardown(router)

    j, t = both(sides, run)
    assert t == j
    assert [g for _, _, g in t[0]] == ref(sides["port"], PROMPTS[:2])
    assert t[1] and t[2][0] == "ok"


def test_metrics_dump_renders_transport(sides):
    """``tools/metrics_dump.py``'s transport view reads the port's
    ``fleet_snapshot()`` and registry as JAX's."""
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    try:
        md = importlib.import_module("metrics_dump")
    finally:
        sys.path.pop(0)
    S = sides["port"]
    reg = tobs.MetricsRegistry()
    router = S.fleet.FleetRouter([spec(S)], metrics_registry=reg)
    try:
        router.submit(PROMPTS[0], max_new_tokens=4)
        router.run_to_completion(max_steps=1_000_000)
        text = md._render_transport(router.fleet_snapshot(),
                                    reg.snapshot())
        for must in ("transport:", "frames=", "thread", "127.0.0.1",
                     "paddle_tpu_transport_rtt_seconds", "rtt ms/rpc"):
            assert must in text, must
        inproc = S.fleet.FleetRouter([factory(S)], metrics_registry=False)
        assert "no transport section" in md._render_transport(
            inproc.fleet_snapshot())
        assert "transport" not in inproc.fleet_snapshot()
        assert router.fleet_snapshot()["transport"]["frames"] > 0
    finally:
        teardown(router)


# ---------------------------------------------------------------------------
# the port's own: layouts, interop, the RemoteSpec modes, tracing, metrics
# ---------------------------------------------------------------------------
def export_record(S, kv_quant=None):
    """One prefill engine of side ``S`` exports PROMPTS[1]'s context ->
    (prompt, k, v, kscale, vscale, ctx_len)."""
    eng = factory(S, "prefill", host_pages=16,
                  **({"kv_quant": kv_quant} if kv_quant else {}))()
    eng.submit(PROMPTS[1], max_new_tokens=6)
    t0 = time.monotonic()
    recs = []
    while not recs:
        assert time.monotonic() - t0 < 60.0
        eng.step()
        recs = eng.take_handoffs()
    (rec,) = recs
    return (rec.request.prompt,) + tuple(rec.materialize())


@pytest.mark.parametrize("kv_quant", [None, "int8"])
def test_exported_record_packs_in_jax_layout(sides, kv_quant):
    """A port record's blocks go on the wire as JAX's ``[L, pages, ...]``
    blocks: the same metas as JAX's record of the same prompt, values
    within 1e-5 (int8 codes within one step), and JAX's ``unpack_array``
    reads the port's bytes back into the port's page-major blocks
    transposed, bit for bit."""
    jrec = export_record(sides["jax"], kv_quant)
    trec = export_record(sides["port"], kv_quant)
    assert trec[5] == jrec[5] == len(PROMPTS[1])
    tmetas, tblobs = tremote._pack_record(trec[0], trec[1:5])
    jmetas = [jtransport.pack_array(a)[0] for a in jrec[:5]]
    assert tmetas == jmetas
    for i, (m, b) in enumerate(zip(tmetas, tblobs)):
        back = jtransport.unpack_array(m, b)
        if back is None:
            assert jrec[i] is None
            continue
        want = trec[i] if i == 0 else trec[i].transpose(0, 1)
        assert back.tobytes() == np.ascontiguousarray(
            np.asarray(want)).tobytes()
        if back.dtype == np.int8:
            assert np.abs(back.astype(np.int32)
                          - jrec[i].astype(np.int32)).max() <= 1
        else:
            np.testing.assert_allclose(back, jrec[i], atol=1e-5, rtol=1e-5)
    # and the port reads it back page-major
    again = tremote._unpack_record(tmetas, tblobs)
    for a, b in zip(again[1:], trec[1:5]):
        assert (a is None and b is None) or torch.equal(a, b)


def test_port_router_drives_a_jax_agent_and_back(sides):
    """A port FleetRouter over a JAX in-thread ReplicaAgent serves JAX's
    engine's tokens, and a JAX FleetRouter over a port agent the port's:
    the frames, ops and snapshots are the same protocol."""
    J, T = sides["jax"], sides["port"]
    jagent = jfleet.RemoteSpec(
        agent=lambda: jfleet.ReplicaAgent(factory(J), lease_s=5.0))
    port_router = tfleet.FleetRouter([tfleet.RemoteSpec(
        agent=jagent.agent, lease_s=5.0)])
    try:
        rids, done = run_all(port_router, PROMPTS)
        assert [list(done[r].generated) for r in rids] == ref(J, PROMPTS)
        assert all(done[r].status == "ok" for r in rids)
        assert isinstance(port_router._replicas[0]._agent,
                          jfleet.ReplicaAgent)
        assert port_router._replicas[0].engine.device == "cpu"
        audit_all(port_router)
    finally:
        teardown(port_router)
    jax_router = jfleet.FleetRouter([jfleet.RemoteSpec(
        agent=lambda: tfleet.ReplicaAgent(factory(T), lease_s=5.0),
        lease_s=5.0)])
    try:
        rids, done = run_all(jax_router, PROMPTS)
        assert [list(done[r].generated) for r in rids] == ref(T, PROMPTS)
        assert isinstance(jax_router._replicas[0]._agent,
                          tfleet.ReplicaAgent)
        audit_all(jax_router)
    finally:
        teardown(jax_router)


@pytest.mark.parametrize("direction", ["jax_prefill_port_decode",
                                       "port_prefill_jax_decode"])
def test_handoff_crosses_between_the_packages(sides, direction):
    """A hand-off over int8 pages from one package's prefill agent to the
    other's decode agent, under a port router: the blocks cross in JAX's
    layout and the decode side adopts them without a prefill; the tokens
    equal the unified engine's."""
    J, T = sides["jax"], sides["port"]
    pre, dec = (J, T) if direction.startswith("jax") else (T, J)
    router = tfleet.FleetRouter(
        [tfleet.RemoteSpec(agent=spec(pre, role="prefill", engine="prefill",
                                      kv_quant="int8", host_pages=32).agent,
                           role="prefill"),
         tfleet.RemoteSpec(agent=spec(dec, role="decode", engine="decode",
                                      kv_quant="int8", host_pages=32).agent,
                           role="decode")],
        roles=["prefill", "decode"], handoff_gbps=1e9)
    try:
        rids, done = run_all(router, PROMPTS)
        want = ref(T, PROMPTS, kv_quant="int8")
        assert want == ref(J, PROMPTS, kv_quant="int8")
        assert [list(done[r].generated) for r in rids] == want
        assert router.handoffs_shipped == len(PROMPTS)
        assert router._replicas[1]._agent._sup.engine.prefill_calls == 0
        audit_all(router)
    finally:
        teardown(router)


def test_remote_spec_modes_add_replica_and_autoscaler(sides):
    """``RemoteSpec`` through ``connect=`` (an agent the caller runs),
    ``add_replica`` and the autoscaler's scale-up serve as JAX's do; the
    spec refuses zero or two targets."""
    def run(S):
        agent = S.fleet.ReplicaAgent(factory(S), lease_s=5.0)
        addr = ("127.0.0.1", agent.start())
        router = S.fleet.FleetRouter([S.fleet.RemoteSpec(connect=addr)])
        try:
            idx = router.add_replica(spec(S))
            # a band below zero: every settled tick is hot (the agents'
            # queues show in their snapshots a drive-loop iteration late,
            # so a real queue is too brief a trigger for a test)
            scaler = S.fleet.FleetAutoscaler(
                router, spec(S), max_replicas=3, high_queued_tokens=-1,
                low_queued_tokens=-2, up_consecutive=1, cooldown_s=0.0)
            rids = [router.submit(p, max_new_tokens=6) for p in SOAK]
            ups, done, t0 = [], {}, time.monotonic()
            while not set(rids) <= set(done):
                assert time.monotonic() - t0 < 60.0
                ups.append(scaler.tick())
                router.step()
                done.update((r.rid, r) for r in router.finished())
            snap = router.fleet_snapshot()
            modes = [rep["transport"]["mode"] for rep in snap["replicas"]]
            ev = [e["remote"] for e in router.metrics.ring.recent()
                  if e["name"] == "fleet_scale_up"]
            return ([outcome([done[r]])[r] for r in rids], idx,
                    router.scale_ups, modes, [u for u in ups if u], ev,
                    router.transport_metrics is not None)
        finally:
            teardown(router)
            agent.die()

    j, t = both(sides, run)
    assert t == j
    assert [g for _, _, g in t[0]] == ref(sides["port"], SOAK)
    assert t[1:] == (1, 2, ["connect", "thread", "thread"], ["up:2"],
                     [True, True], True)
    with pytest.raises(ValueError, match="exactly one"):
        tfleet.RemoteSpec()
    with pytest.raises(ValueError, match="exactly one"):
        tfleet.RemoteSpec(connect=("127.0.0.1", 1), spawn={})


def test_spawn_failure_surfaces_the_factory_error(tmp_path, monkeypatch):
    """No fallback hides a failure: an agent whose factory raises fails to
    spawn with that error, and the 7B factory refuses to start a kernel
    build of its own on a card."""
    bad = tfleet.RemoteSpec(spawn={
        "factory": "paddle_tpu_torch.testing.agent_factory:make_engine",
        "factory_kwargs": {"weights": str(tmp_path / "missing.npz")}})
    with pytest.raises(RuntimeError, match="failed to start: .*missing"):
        tfleet.FleetRouter([bad])
    from paddle_tpu_torch.ops import _build
    monkeypatch.setattr(_build, "_target",
                        lambda name: tmp_path / f"{name}.so")
    with pytest.raises(RuntimeError, match="not built"):
        agent_factory.make_llama7b_engine(device="cuda")


def test_remote_replica_trace_rides_the_wire(sides):
    """A request served by a remote replica yields one span tree: ingress,
    the route, the replica's phase spans (tagged ``remote=True``, built in
    the router from the returned wire Request's clocks) and the stream,
    as JAX's (tests/test_tracing.py::
    test_remote_replica_trace_rides_the_wire)."""
    def run(S):
        tr = S.obs.Tracer(S.obs.TraceStore(keep_slower_than_ms=0.0))
        sp = S.fleet.RemoteSpec(
            agent=lambda: S.fleet.ReplicaAgent(factory(S), lease_s=5.0))
        router = S.fleet.FleetRouter([sp], tracer=tr,
                                     metrics_registry=False)
        srv = S.fleet.FleetServer(router)
        url = f"http://127.0.0.1:{srv.start()}"
        try:
            toks = S.srv.generate_http(url, [int(x) for x in PROMPTS[0]],
                                       max_new_tokens=6)
            idx = json.loads(urllib.request.urlopen(
                url + "/traces").read())["traces"]
            rid = idx[0]["trace_id"]
            doc = json.loads(urllib.request.urlopen(
                url + f"/trace/{rid}").read())
            phases = [s for s in doc["spans"] if s["name"] in S.obs.PHASES]
            remote = [s for s in phases if s["attrs"].get("remote")]
            covered = sum(s["dur_s"] for s in remote)
            route = [s for s in doc["spans"] if s["name"] == "route"]
            return (toks, idx[0]["status"],
                    sorted({s["name"] for s in doc["spans"]}),
                    sorted({s["name"] for s in remote}),
                    all(s["attrs"].get("replica") == 0 for s in remote),
                    route[0]["attrs"]["reason"],
                    covered <= doc["duration_ms"] / 1000.0 + 0.05)
        finally:
            srv.stop()
            teardown(router)

    j, t = both(sides, run)
    assert t == j
    assert t[1] == "ok" and len(t[0]) == 6
    for must in ("request", "http_ingress", "queued", "prefill",
                 "decode_active", "stream"):
        assert must in t[2], must
    assert {"queued", "prefill", "decode_active"} <= set(t[3])
    assert t[4] and t[6]


def test_transport_metrics_catalogue_equals_jax():
    """``TransportMetrics`` registers JAX's names, kinds, help texts and
    buckets, and the untouched catalogue renders JAX's bytes
    (tests/test_observability.py's registration of the bundle)."""
    jr, tr = jobs.MetricsRegistry(), tobs.MetricsRegistry()
    jobs.TransportMetrics(jr)
    tobs.TransportMetrics(tr)
    assert tr.names() == jr.names() and len(tr.names()) == 6
    for n in tr.names():
        assert tr.get(n).kind == jr.get(n).kind
        assert tr.get(n).help == jr.get(n).help
        if tr.get(n).kind == "histogram":
            assert tr.get(n).buckets == jr.get(n).buckets
    assert tr.render_prometheus() == jr.render_prometheus()
