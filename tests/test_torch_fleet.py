"""The port's in-process fleet (``paddle_tpu_torch/fleet``: ``FleetRouter``,
``FleetAutoscaler``, ``FleetServer``, ``FleetMetrics``) held against
``paddle_tpu.fleet`` on the 2-layer fp32 config of ``tests/test_fleet.py``
with the same weights (``params_from_jax``).

Each case runs one scenario through JAX's router and through the port's
(each side with its own engine, fault plane and server modules; the same
fault rules armed on both planes) and holds the port to JAX's outcome:
every fleet rid's status, error text and tokens, ``routed``,
``failovers``, ``deaths``, ``replaces``, ``rejected``, ``quota_rejected``,
``scale_ups`` / ``scale_downs``, ``route_errors``, the replica states, the
autoscaler's decisions and trajectory, and the HTTP codes and
``Retry-After``.  The cases are ``tests/test_fleet.py``'s 24, the fleet
and autoscaler cases of ``tests/test_serving_qos.py``,
``tests/test_tracing.py::test_fleet_plain_failover_latency_breakdown`` and
``tests/test_serving_spec.py::test_spec_fleet_pass_through``; then the
port's own: the prefill / decode roles and a caller's hand-off transport
serve as JAX's do (``tests/test_torch_disagg.py`` holds the rest of the
role lanes), and a replaced or retired replica's pool is freed
(``tests/test_torch_transport.py`` holds the remote replicas).
"""

import importlib
import json
import math
import sys
import threading
import time
import types
import urllib.error
import urllib.request
import weakref

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

import paddle_tpu.fleet as jfleet  # noqa: E402
import paddle_tpu.models.disagg as jdg  # noqa: E402
import paddle_tpu.inference.serving as jsrv  # noqa: E402
import paddle_tpu.observability as jobs  # noqa: E402
import paddle_tpu_torch.fleet as tfleet  # noqa: E402
import paddle_tpu_torch.models.disagg as tdg  # noqa: E402
import paddle_tpu_torch.inference.serving as tsrv  # noqa: E402
import paddle_tpu_torch.observability as tobs  # noqa: E402
from paddle_tpu.models import llama_pretrain as jlp  # noqa: E402
from paddle_tpu.models import paged_decode as jpd  # noqa: E402
from paddle_tpu.models import serving_engine as jse  # noqa: E402
from paddle_tpu.testing import faults as jfaults  # noqa: E402
from paddle_tpu_torch.models import llama_pretrain as tlp  # noqa: E402
from paddle_tpu_torch.models import paged_decode as tpd  # noqa: E402
from paddle_tpu_torch.models import serving_engine as tse  # noqa: E402
from paddle_tpu_torch.models.weights import params_from_jax  # noqa: E402
from paddle_tpu_torch.testing import faults as tfaults  # noqa: E402

KW = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
          num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
          max_seq_len=256, remat=False, loss_chunks=1,
          use_pallas_attention=False)
CACHE = dict(num_pages=64, pages_max=8, batch=2, page=16)
PROMPTS = [np.random.RandomState(77).randint(1, 128, (L,))
           for L in (10, 21, 33, 8, 17, 26, 12, 19)]


@pytest.fixture(scope="module")
def sides():
    """Per side: the engine, cache, fleet, fault, server and observability
    modules, and the config and weights."""
    jcfg = jlp.LlamaPretrainConfig(**KW, dtype=jnp.float32,
                                   param_dtype=jnp.float32)
    tcfg = tlp.LlamaPretrainConfig(**KW, dtype=torch.float32)
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1, 1, 1, 1),
                ("dp", "pp", "sharding", "sep", "mp"))
    jparams = jlp.init_params(jcfg, jax.random.PRNGKey(0), mesh)
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                              device="cpu")
    return {
        "jax": types.SimpleNamespace(
            name="jax", se=jse, pd=jpd, dg=jdg, fleet=jfleet,
            faults=jfaults,
            srv=jsrv, obs=jobs, cfg=jcfg, params=jparams, dev={}),
        "port": types.SimpleNamespace(
            name="port", se=tse, pd=tpd, dg=tdg, fleet=tfleet,
            faults=tfaults,
            srv=tsrv, obs=tobs, cfg=tcfg, params=tparams,
            dev={"device": "cpu"})}


def factory(S, registry=False, **kw):
    """One replica factory of side ``S`` (cache keywords split off)."""
    def mk():
        ck = dict(CACHE)
        for k in ("num_pages", "pages_max", "batch", "page", "host_pages"):
            if k in kw:
                ck[k] = kw[k]
        ek = {k: v for k, v in kw.items() if k not in ck}
        cache = S.pd.PagedKVCache(S.cfg, **ck, **S.dev)
        return S.se.ContinuousBatchingEngine(
            S.cfg, S.params, cache, metrics_registry=registry, **ek)
    return mk


def both(sides, scenario):
    """Run ``scenario(S)`` on each side -> (jax result, port result)."""
    return scenario(sides["jax"]), scenario(sides["port"])


def outcome(done):
    """fleet rid -> (status, error, tokens, degraded)."""
    return {r.rid: (r.status, r.error, [int(t) for t in r.generated],
                    bool(getattr(r, "degraded", False))) for r in done}


def counters(router):
    return {"routed": dict(router.routed), "failovers": router.failovers,
            "rejected": router.rejected,
            "quota_rejected": router.quota_rejected,
            "deaths": router.deaths, "replaces": router.replaces,
            "scale_ups": router.scale_ups,
            "scale_downs": router.scale_downs,
            "route_errors": router.route_errors,
            "states": [h.state for h in router._replicas],
            "pending": len(router._pending)}


def audit_all(router):
    """Every live replica's cache audits clean (a retired replica has no
    engine on the port); -> the audits, for the sides to compare."""
    out = []
    for h in router._replicas:
        if h.state == "RETIRED":
            continue
        a = dict(h.engine.cache.audit())
        a.pop("swap_records", None)
        a.pop("host_free", None)
        a.pop("host_indexed", None)
        out.append(a)
    return out


_REF = {}


def ref_outputs(S, prompts, new=8):
    """The unloaded greedy outputs of one engine (per side, by content)."""
    key = (S.name, new, tuple(bytes(np.asarray(p)) for p in prompts))
    if key not in _REF:
        eng = factory(S)()
        rids = [eng.submit(p, max_new_tokens=new) for p in prompts]
        done = {r.rid: [int(t) for t in r.generated]
                for r in eng.run_to_completion()}
        _REF[key] = [done[rid] for rid in rids]
    return _REF[key]


def http(url, data=None, timeout=30):
    try:
        req = urllib.request.Request(url, data=data)
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, r.read(), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, e.read(), dict(e.headers)


def poll(predicate, timeout_s=30.0):
    t0 = time.monotonic()
    while not predicate():
        assert time.monotonic() - t0 < timeout_s, "condition timeout"
        time.sleep(0.01)


def body(prompt, new=4, **extra):
    return json.dumps({"prompt": [int(t) for t in prompt],
                       "max_new_tokens": new, **extra}).encode()


# ---------------------------------------------------------------------------
# routing: tokens, prefix affinity, least-loaded, steering
# ---------------------------------------------------------------------------
def test_fleet_token_exact_vs_single_engine(sides):
    def run(S):
        router = S.fleet.FleetRouter([factory(S)] * 3,
                                     metrics_registry=False)
        rids = [router.submit(p, max_new_tokens=8) for p in PROMPTS]
        done = outcome(router.run_to_completion())
        spread = sum(1 for h in router._replicas
                     if h.engine.requests_finished)
        return rids, done, counters(router), spread, audit_all(router)

    j, t = both(sides, run)
    assert t == j
    rids, done, _, spread, _ = t
    ref = ref_outputs(sides["port"], PROMPTS)
    assert [done[r][2] for r in rids] == ref
    assert ref == ref_outputs(sides["jax"], PROMPTS)
    assert spread >= 2


def _prefix_group(seed, n=4, prefix_len=32):
    rng = np.random.RandomState(seed)
    prefix = rng.randint(1, 128, (prefix_len,))
    return [np.concatenate([prefix, rng.randint(1, 128, (3 + i,))])
            for i in range(n)]


@pytest.mark.parametrize("prefix_routing", [True, False])
def test_prefix_affinity_routes_to_owner(sides, prefix_routing):
    group = _prefix_group(5)

    def run(S):
        reg = S.obs.MetricsRegistry()
        mk = factory(S, enable_prefix_caching=True)
        router = S.fleet.FleetRouter([mk] * (3 if prefix_routing else 2),
                                     prefix_routing=prefix_routing,
                                     metrics_registry=reg)
        for p in group:
            router.submit(p, max_new_tokens=4)
        done = outcome(router.run_to_completion())
        owners = [h.idx for h in router._replicas
                  if h.engine.requests_finished]
        hits = [h.engine.cache.prefix_hits for h in router._replicas]
        return (done, counters(router), owners, hits,
                reg.get("paddle_tpu_fleet_routed_prefix_total").value,
                audit_all(router))

    j, t = both(sides, run)
    assert t == j
    done, c, owners, hits, prom, _ = t
    assert all(v[0] == "ok" for v in done.values())
    if prefix_routing:
        assert c["routed"]["prefix"] == 3 and prom == 3
        assert c["routed"]["least_loaded"] == 1
        assert len(owners) == 1 and hits[owners[0]] > 0
    else:
        assert c["routed"]["prefix"] == 0
        assert c["routed"]["least_loaded"] == 4 and len(owners) == 2


def test_routing_steers_around_draining_replica(sides):
    def run(S):
        router = S.fleet.FleetRouter([factory(S)] * 2,
                                     metrics_registry=False)
        router.drain(0)
        draining = router._replicas[0].state
        for p in PROMPTS[:3]:
            router.submit(p, max_new_tokens=4)
        done = outcome(router.run_to_completion())
        return (draining, done, counters(router),
                [h.engine.requests_finished for h in router._replicas],
                router._replicas[0].replaces)

    j, t = both(sides, run)
    assert t == j
    assert t[0] == "DRAINING" and t[3] == [0, 3] and t[4] == 1
    assert t[2]["states"] == ["READY", "READY"]


def test_drain_finishes_inflight_then_replaces(sides):
    def run(S):
        router = S.fleet.FleetRouter([factory(S)], metrics_registry=False)
        router.submit(PROMPTS[0], max_new_tokens=8)
        router.step()
        router.drain(0)
        sup_state = router._replicas[0].supervisor.state
        with pytest.raises((RuntimeError, S.se.QueueFullError)):
            router.submit(PROMPTS[1], max_new_tokens=4)
        done = outcome(router.run_to_completion())
        return sup_state, done, counters(router), audit_all(router)

    j, t = both(sides, run)
    assert t == j
    assert t[0] == "DRAINING" and t[2]["replaces"] == 1
    assert list(t[1].values())[0][2] == \
        ref_outputs(sides["port"], PROMPTS)[0]


# ---------------------------------------------------------------------------
# fleet-wide admission / backpressure
# ---------------------------------------------------------------------------
def test_single_saturated_replica_does_not_reject_fleet(sides):
    rng = np.random.RandomState(11)
    prefix = rng.randint(1, 128, (32,))
    same = [np.concatenate([prefix, rng.randint(1, 128, (4,))])
            for _ in range(8)]

    def run(S):
        reg = S.obs.MetricsRegistry()
        router = S.fleet.FleetRouter([factory(S, max_queue_len=2)] * 2,
                                     metrics_registry=reg)
        for p in same[:4]:
            router.submit(p, max_new_tokens=4)
        queues = [len(h.engine._queue) for h in router._replicas]
        with pytest.raises(S.se.QueueFullError) as ei:
            router.submit(same[4], max_new_tokens=4)
        agg = min(h.engine.retry_after_s() for h in router._replicas)
        out = (queues, str(ei.value), ei.value.retry_after, agg,
               counters(router),
               reg.get("paddle_tpu_fleet_rejected_total").value,
               [h.engine.requests_rejected for h in router._replicas])
        router.run_to_completion()
        return out

    j, t = both(sides, run)
    assert t == j
    queues, _, hint, agg, c, prom, eng_rejected = t
    assert queues == [2, 2] and c["rejected"] == 1 and prom == 1
    assert hint == pytest.approx(agg) and eng_rejected == [0, 0]


def test_fleet_http_429_carries_aggregate_retry_after(sides):
    def run(S):
        router = S.fleet.FleetRouter([factory(S, max_queue_len=1)] * 2,
                                     metrics_registry=False)
        srv = S.fleet.FleetServer(router)
        srv._drive = srv._stop.wait      # park the loop: queues only grow
        url = f"http://127.0.0.1:{srv.start()}"
        try:
            srv.submit([int(t) for t in PROMPTS[0]], 4)
            ready1 = http(url + "/health/ready")[0]
            srv.submit([int(t) for t in PROMPTS[1]], 4)
            ready2 = http(url + "/health/ready")[0]
            code, text, headers = http(url + "/generate", body(PROMPTS[2]))
            return (ready1, ready2, code, b"fleet saturated" in text,
                    headers.get("Retry-After"))
        finally:
            srv.stop()

    j, t = both(sides, run)
    assert t == j == (200, 503, 429, True, "1")


# ---------------------------------------------------------------------------
# replica death: failover, explicit errors, auto-replace
# ---------------------------------------------------------------------------
def test_replica_death_fails_over_queued_requests(sides):
    def run(S):
        reg = S.obs.MetricsRegistry()
        router = S.fleet.FleetRouter([factory(S)] * 2, metrics_registry=reg)
        rids = [router.submit(p, max_new_tokens=8) for p in PROMPTS]
        with S.faults.plane() as fp:
            fp.inject("replica_death", RuntimeError("killed"), nth=1)
            done = outcome(router.run_to_completion())
        return (rids, done, counters(router),
                reg.get("paddle_tpu_fleet_failovers_total").value,
                audit_all(router))

    j, t = both(sides, run)
    assert t == j
    rids, done, c, prom, _ = t
    ref = ref_outputs(sides["port"], PROMPTS)
    assert c["deaths"] == 1 and c["failovers"] > 0 and c["replaces"] == 1
    assert c["routed"]["failover"] == c["failovers"] == prom
    for i, rid in enumerate(rids):
        status, err, toks, _ = done[rid]
        if status == "ok":
            assert toks == ref[i]
        else:
            assert status == "error" and "died" in err
    assert c["states"] == ["READY", "READY"]


def test_replica_death_without_auto_replace_keeps_fleet_serving(sides):
    def run(S):
        router = S.fleet.FleetRouter([factory(S)] * 2, auto_replace=False,
                                     metrics_registry=False)
        for p in PROMPTS[:6]:
            router.submit(p, max_new_tokens=6)
        with S.faults.plane() as fp:
            fp.inject("replica_death", RuntimeError("killed"), nth=1)
            done = outcome(router.run_to_completion())
        before = counters(router)
        dead = next(h.idx for h in router._replicas if h.state == "DEAD")
        router.replace(dead)
        r2 = router.submit(PROMPTS[0], max_new_tokens=4)
        after = outcome(router.run_to_completion())
        return done, before, router.fleet_snapshot()["states"], \
            after[r2][0], counters(router)

    j, t = both(sides, run)
    assert t == j
    _, before, _, status, after = t
    assert "DEAD" in before["states"] and before["replaces"] == 0
    assert status == "ok" and after["replaces"] == 1


def test_failover_preserves_deadline(sides):
    def run(S):
        router = S.fleet.FleetRouter([factory(S)] * 2, auto_replace=False,
                                     metrics_registry=False)
        clock = [1000.0]
        router._now = lambda: clock[0]
        for p in PROMPTS[:6]:
            router.submit(p, max_new_tokens=8, deadline_s=5.0)
        with S.faults.plane() as fp:
            fp.inject("replica_death", RuntimeError("killed"), nth=1)
            router.step()
        clock[0] += 10.0
        done = outcome(router.run_to_completion())
        return done, counters(router), audit_all(router)

    j, t = both(sides, run)
    assert t == j
    statuses = {v[0] for v in t[0].values()}
    assert statuses <= {"ok", "error", "expired"} and "expired" in statuses


def test_cancel_of_pending_orphan_delivers_terminal_message(sides):
    def run(S):
        router = S.fleet.FleetRouter([factory(S, max_queue_len=2)],
                                     auto_replace=False,
                                     metrics_registry=False)
        for p in PROMPTS[:2]:
            router.submit(p, max_new_tokens=4)
        with S.faults.plane() as fp:
            fp.inject("replica_death", RuntimeError("killed"), nth=1)
            router.step()
        pending = router._pending[0].rid
        cancelled = router.cancel(pending)
        had_work = router.has_work()
        done = outcome(router.run_to_completion())
        return (pending, cancelled, had_work, done, router.has_work(),
                counters(router))

    j, t = both(sides, run)
    assert t == j
    pending, cancelled, had_work, done, left, c = t
    assert cancelled and had_work and not left and c["rejected"] == 0
    assert done[pending][0] == "cancelled"


def test_replaced_replica_loses_prefix_ownership(sides):
    rng = np.random.RandomState(12)
    prefix = rng.randint(1, 128, (32,))
    p1 = np.concatenate([prefix, rng.randint(1, 128, (4,))])
    p2 = np.concatenate([prefix, rng.randint(1, 128, (5,))])

    def run(S):
        router = S.fleet.FleetRouter(
            [factory(S, enable_prefix_caching=True)] * 2,
            metrics_registry=False)
        router.submit(p1, max_new_tokens=4)
        router.run_to_completion()
        owner = next(h.idx for h in router._replicas
                     if h.engine.requests_finished)
        owners = set(router._prefix_owner.values())
        router.replace(owner)
        after = set(router._prefix_owner.values())
        router.submit(p2, max_new_tokens=4)
        done = outcome(router.run_to_completion())
        return owner, owners, after, done, counters(router)

    j, t = both(sides, run)
    assert t == j
    owner, owners, after, _, c = t
    assert owners == {owner} and owner not in after
    assert c["routed"]["prefix"] == 0 and c["routed"]["least_loaded"] == 2


def test_cancelled_request_is_not_revived_by_failover(sides):
    def run(S):
        router = S.fleet.FleetRouter([factory(S)] * 2,
                                     metrics_registry=False)
        rids = [router.submit(p, max_new_tokens=8) for p in PROMPTS[:6]]
        assert router.cancel(rids[-1]) is True
        with S.faults.plane() as fp:
            fp.inject("replica_death", RuntimeError("killed"), nth=1)
            done = outcome(router.run_to_completion())
        return rids, done, counters(router), audit_all(router)

    j, t = both(sides, run)
    assert t == j
    rids, done = t[0], t[1]
    assert done[rids[-1]][:3] == ("cancelled", None, [])


def test_fleet_state_does_not_stall_behind_held_lock(sides):
    def run(S):
        router = S.fleet.FleetRouter([factory(S)] * 2,
                                     metrics_registry=False)
        srv = S.fleet.FleetServer(router)
        srv.start()
        try:
            doc = srv.fleet_state()
            with srv._lock:
                t0 = time.monotonic()
                stale = srv.fleet_state()
                waited = time.monotonic() - t0
            return (doc["states"]["READY"], stale["states"]["READY"],
                    "stale_s" in stale, waited < 1.0)
        finally:
            srv.stop()

    j, t = both(sides, run)
    assert t == j == (2, 2, True, True)


def test_route_dispatch_fault_steers_to_next_candidate(sides):
    def run(S):
        router = S.fleet.FleetRouter([factory(S)] * 2,
                                     metrics_registry=False)
        with S.faults.plane() as fp:
            fp.inject("route_dispatch", RuntimeError("route boom"), nth=1)
            rid = router.submit(PROMPTS[0], max_new_tokens=4)
        errors = router.route_errors
        done = outcome(router.run_to_completion())
        with S.faults.plane() as fp:
            fp.inject("route_dispatch", RuntimeError("route boom"), times=2)
            with pytest.raises(RuntimeError, match="route boom"):
                router.submit(PROMPTS[1], max_new_tokens=4)
        return rid, errors, done, counters(router)

    j, t = both(sides, run)
    assert t == j
    rid, errors, done, c = t
    assert errors == 1 and done[rid][0] == "ok" and c["route_errors"] == 3


def test_replica_slow_degrades_and_recovers(sides):
    def run(S):
        router = S.fleet.FleetRouter([factory(S)] * 2,
                                     metrics_registry=False)
        rids = [router.submit(p, max_new_tokens=8) for p in PROMPTS[:2]]
        with S.faults.plane() as fp:
            fp.inject("replica_slow", nth=1)
            router.step()
            mid = (router._replicas[0].state,
                   router._replicas[0].slow_ticks,
                   router.fleet_snapshot()["states"]["DEGRADED"])
        done = outcome(router.run_to_completion())
        return rids, mid, done, counters(router)

    j, t = both(sides, run)
    assert t == j
    rids, mid, done, c = t
    assert mid == ("DEGRADED", 1, 1) and c["states"][0] == "READY"
    ref = ref_outputs(sides["port"], PROMPTS)
    assert [done[r][2] for r in rids] == ref[:2]


# ---------------------------------------------------------------------------
# chaos: seeded deaths and stalls under load
# ---------------------------------------------------------------------------
def test_chaos_seeded_deaths_and_stalls_no_silent_drops(sides):
    def run(S):
        router = S.fleet.FleetRouter([factory(S)] * 3,
                                     metrics_registry=False)
        with S.faults.plane() as fp:
            fp.inject("replica_death", RuntimeError("chaos kill"), every=9)
            fp.inject("replica_slow", p=0.15, seed=3)
            rids = [router.submit(p, max_new_tokens=8) for p in PROMPTS]
            done = outcome(router.run_to_completion(max_steps=5000))
        audits = audit_all(router)
        rid = router.submit(PROMPTS[0], max_new_tokens=8)
        final = outcome(router.run_to_completion())
        return rids, done, counters(router), audits, final[rid]

    j, t = both(sides, run)
    assert t == j
    rids, done, c, _, final = t
    ref = ref_outputs(sides["port"], PROMPTS)
    assert set(done) == set(rids) and c["deaths"] >= 1
    ok = [i for i, r in enumerate(rids) if done[r][0] == "ok"]
    assert ok and all(done[rids[i]][2] == ref[i] for i in ok)
    assert all(done[r][0] == "error" and done[r][1] for r in rids
               if done[r][0] != "ok")
    assert final[0] == "ok" and final[2] == ref[0]


def test_chaos_cancel_and_deadline_under_deaths(sides):
    def run(S):
        router = S.fleet.FleetRouter([factory(S)] * 3,
                                     metrics_registry=False)
        with S.faults.plane() as fp:
            fp.inject("replica_death", RuntimeError("chaos kill"), every=6)
            rids = [router.submit(p, max_new_tokens=16) for p in PROMPTS]
            router.cancel(rids[0])
            router.cancel(rids[5])
            expired = router.submit(PROMPTS[1], max_new_tokens=16,
                                    deadline_s=0.0)
            done = outcome(router.run_to_completion(max_steps=5000))
        return rids, expired, done, counters(router), audit_all(router)

    j, t = both(sides, run)
    assert t == j
    rids, expired, done = t[:3]
    assert set(done) == set(rids) | {expired}
    assert done[expired][0] in ("expired", "error")
    assert {done[rids[0]][0], done[rids[5]][0]} <= {"cancelled", "error"}


# ---------------------------------------------------------------------------
# supervisor lifecycle verbs (drain / state / resume)
# ---------------------------------------------------------------------------
def test_supervisor_drain_state_resume(sides):
    def run(S):
        sup = S.se.EngineSupervisor(factory(S), backoff_s=0.0)
        states = [sup.state]
        rid = sup.submit(PROMPTS[0], max_new_tokens=6)
        sup.drain()
        states.append(sup.state)
        drained = sup.drained
        with pytest.raises(RuntimeError, match="draining"):
            sup.submit(PROMPTS[1], max_new_tokens=4)
        done = outcome(sup.run_to_completion())
        states.append(sup.drained)
        sup.resume()
        states.append(sup.state)
        return rid, drained, done, states, sup.submit(PROMPTS[1], 4)

    j, t = both(sides, run)
    assert t == j
    assert t[3] == ["READY", "DRAINING", True, "READY"] and t[4] == t[0] + 1


def test_supervisor_dead_state_after_budget(sides):
    def run(S):
        sup = S.se.EngineSupervisor(factory(S, quarantine_faults=False),
                                    max_restarts=0, backoff_s=0.0)
        sup.submit(PROMPTS[0], max_new_tokens=4)
        with S.faults.plane() as fp:
            fp.inject("step_dispatch", RuntimeError("boom"), nth=1)
            with pytest.raises(S.se.EngineDeadError) as ei:
                sup.step()
        with pytest.raises(S.se.EngineDeadError):
            sup.submit(PROMPTS[1], max_new_tokens=4)
        return sup.state, str(ei.value)

    j, t = both(sides, run)
    assert t == j and t[0] == "DEAD"


def test_http_ready_false_while_draining(sides):
    def run(S):
        srv = S.srv.GenerationServer(engine_factory=factory(S),
                                     restart_backoff_s=0.0)
        url = f"http://127.0.0.1:{srv.start()}"
        try:
            poll(srv.is_ready)
            codes = [http(url + "/health/ready")[0]]
            srv._supervisor.drain()
            poll(lambda: not srv.is_ready())
            codes += [http(url + "/health/ready")[0],
                      http(url + "/health/live")[0]]
            srv._supervisor.resume()
            poll(srv.is_ready)
            codes.append(http(url + "/health/ready")[0])
            return codes
        finally:
            srv.stop()

    j, t = both(sides, run)
    assert t == j == [200, 503, 200, 200]


# ---------------------------------------------------------------------------
# FleetServer: HTTP front, /fleet, aggregated metrics
# ---------------------------------------------------------------------------
def test_fleet_server_end_to_end_token_exact(sides):
    def run(S):
        reg = S.obs.MetricsRegistry()
        mk = factory(S)

        def mk_metrics():
            eng = mk()
            eng.metrics = S.obs.EngineMetrics(reg)
            return eng

        router = S.fleet.FleetRouter([mk_metrics] * 2, metrics_registry=reg)
        srv = S.fleet.FleetServer(router)
        url = f"http://127.0.0.1:{srv.start()}"
        try:
            toks = S.srv.generate_http(url, [int(t) for t in PROMPTS[0]],
                                       max_new_tokens=8)
            streamed = list(S.srv.generate_http_stream(
                url, [int(t) for t in PROMPTS[1]], max_new_tokens=8))
            doc = json.loads(http(url + "/fleet")[1])
            health = json.loads(http(url + "/health")[1])
            text = http(url + "/metrics")[1].decode()
            return (toks, streamed, len(doc["replicas"]), doc["states"],
                    sum(doc["routed"].values()),
                    {r["state"] for r in doc["replicas"]},
                    health["ready"], "fleet" in health,
                    "paddle_tpu_fleet_replicas_ready_count 2" in text,
                    "paddle_tpu_fleet_routed_least_loaded_total" in text,
                    reg.get("paddle_tpu_engine_requests_finished_total")
                    .value)
        finally:
            srv.stop()

    j, t = both(sides, run)
    assert t == j
    ref = ref_outputs(sides["port"], PROMPTS)
    assert t[0] == ref[0] and t[1] == ref[1]
    assert t[2:] == (2, t[3], 2, {"READY"}, True, True, True, True, 2)
    assert t[3]["READY"] == 2


def test_fleet_server_replica_death_mid_stream_surfaces_500(sides):
    def run(S):
        router = S.fleet.FleetRouter([factory(S)] * 2,
                                     metrics_registry=False)
        srv = S.fleet.FleetServer(router)
        url = f"http://127.0.0.1:{srv.start()}"
        try:
            fp = S.faults.install()
            fp.inject("replica_death", RuntimeError("killed"), nth=2)
            with pytest.raises(RuntimeError, match="died"):
                list(S.srv.generate_http_stream(
                    url, [int(t) for t in PROMPTS[0]], max_new_tokens=64,
                    timeout=30))
            poll(lambda: router.deaths >= 1)
        finally:
            S.faults.uninstall()
            srv.stop()
        return router.deaths, router.failovers

    j, t = both(sides, run)
    assert t == j == (1, 0)


def test_metrics_dump_renders_fleet_snapshot(sides):
    sys.path.insert(0, "tools")
    try:
        md = importlib.import_module("metrics_dump")
    finally:
        sys.path.pop(0)

    def run(S):
        router = S.fleet.FleetRouter([factory(S)] * 2,
                                     metrics_registry=False)
        router.submit(PROMPTS[0], max_new_tokens=4)
        router.run_to_completion()
        return md._render_fleet(router.fleet_snapshot())

    j, t = both(sides, run)
    assert "ready=2" in t and "least_loaded=1" in t
    assert "idx" in t and "state" in t and t.count("READY") == 2
    # the same table, the per-replica retry hints aside (engine clocks)
    assert t.splitlines()[:4] == j.splitlines()[:4]


# ---------------------------------------------------------------------------
# QoS at the fleet (tests/test_serving_qos.py's fleet cases)
# ---------------------------------------------------------------------------
QOS_PROMPTS = [np.random.RandomState(20).randint(1, 128, (L,))
               for L in (10, 21, 33, 8, 17, 26, 12, 19)]


def test_fleet_429_finite_retry_after_with_zero_ready(sides):
    def run(S):
        router = S.fleet.FleetRouter([factory(S, max_queue_len=1)] * 2,
                                     metrics_registry=False)
        for p in QOS_PROMPTS[:2]:
            router.submit(p, max_new_tokens=4)
        for h in router._replicas:
            h.state = "DEGRADED"
        with pytest.raises(S.se.QueueFullError) as ei:
            router.submit(QOS_PROMPTS[2], max_new_tokens=4)
        out = (str(ei.value), ei.value.retry_after, router.rejected)
        router.run_to_completion()
        return out

    j, t = both(sides, run)
    assert t == j
    assert "fleet saturated" in t[0] and math.isfinite(t[1]) and t[1] > 0
    assert t[2] == 1


def test_fleet_routes_by_class_and_charges_quota_once(sides):
    def run(S):
        router = S.fleet.FleetRouter(
            [factory(S, max_queue_len=1)] * 2, metrics_registry=False,
            tenant_quotas=S.se.TenantQuotas(rate_tokens_per_s=10.0,
                                            burst_tokens=30.0))
        router._now = lambda: 1000.0
        p = QOS_PROMPTS[0]
        router.submit(p, max_new_tokens=4, tenant="a")
        router.submit(p, max_new_tokens=4, tenant="a")
        with pytest.raises(S.se.QuotaExceededError) as qe:
            router.submit(p, max_new_tokens=4, tenant="a")
        billed = [h.engine.quota_rejected for h in router._replicas]
        with pytest.raises(S.se.QueueFullError,
                           match=r"rejected class 'low'") as fe:
            router.submit(p, max_new_tokens=4, priority="low", tenant="b")
        done = outcome(router.run_to_completion())
        return (qe.value.retry_after, qe.value.tenant, billed,
                str(fe.value), done, counters(router))

    j, t = both(sides, run)
    assert t == j
    hint, tenant, billed, _, done, c = t
    assert hint == pytest.approx(1.2) and tenant == "a"
    assert billed == [0, 0] and c["quota_rejected"] == 1
    assert c["rejected"] == 1 and all(v[0] == "ok" for v in done.values())


def _burst(router, prompts, classes, QueueFullError, new=8):
    accepted, rejected = {}, []
    for i, (p, c) in enumerate(zip(prompts, classes)):
        try:
            accepted[router.submit(p, max_new_tokens=new, priority=c)] = \
                (i, c)
        except QueueFullError:
            rejected.append((i, c))
    return accepted, rejected


def _burst_load(seed):
    rng = np.random.RandomState(seed)
    classes = ["high"] * 2 + ["normal"] * 2 + ["low"] * 8
    rng.shuffle(classes)
    prompts = [rng.randint(1, 128, (int(rng.randint(6, 20)),))
               for _ in classes]
    return prompts, classes


@pytest.mark.parametrize("chaos", [False, True])
def test_overload_burst_protects_high_sheds_low(sides, chaos):
    prompts, classes = _burst_load(11 if chaos else 7)

    def run(S):
        router = S.fleet.FleetRouter([factory(S, max_queue_len=2)] * 2,
                                     metrics_registry=False)
        accepted, rejected = _burst(router, prompts, classes,
                                    S.se.QueueFullError)
        with S.faults.plane() as fp:
            if chaos:
                fp.inject("replica_death", RuntimeError("chaos kill"),
                          every=13, times=2)
                fp.inject("replica_slow", p=0.10, seed=11)
            done = outcome(router.run_to_completion())
        return accepted, rejected, done, counters(router), audit_all(router)

    j, t = both(sides, run)
    assert t == j
    accepted, rejected, done, c, _ = t
    ref = ref_outputs(sides["port"], prompts)
    assert not any(cl == "high" for _, cl in rejected)
    assert any(cl == "low" for _, cl in rejected)
    assert set(done) == set(accepted)
    for rid, (i, cl) in accepted.items():
        status, _, toks, degraded = done[rid]
        if status != "ok":
            assert chaos and status == "error"
        elif cl == "high":
            assert not degraded and toks == ref[i]
        else:
            assert toks == ref[i][:len(toks)]
    assert c["deaths"] >= 1 if chaos else c["deaths"] == 0


def test_autoscaler_validates_band(sides):
    for S in sides.values():
        mk = factory(S)
        router = S.fleet.FleetRouter([mk], metrics_registry=False)
        with pytest.raises(ValueError, match="min_replicas"):
            S.fleet.FleetAutoscaler(router, mk, min_replicas=0)
        with pytest.raises(ValueError, match="max_replicas"):
            S.fleet.FleetAutoscaler(router, mk, min_replicas=3,
                                    max_replicas=2)
        with pytest.raises(ValueError, match="hysteresis"):
            S.fleet.FleetAutoscaler(router, mk, low_queued_tokens=64,
                                    high_queued_tokens=64)


def test_autoscaler_closed_loop_up_then_down(sides):
    def run(S):
        mk = factory(S, max_queue_len=16)
        router = S.fleet.FleetRouter([mk], metrics_registry=False)
        asc = S.fleet.FleetAutoscaler(
            router, mk, min_replicas=1, max_replicas=2,
            high_queued_tokens=20.0, low_queued_tokens=4.0,
            up_consecutive=2, down_consecutive=2, cooldown_s=5.0)
        clock = [0.0]
        asc._now = lambda: clock[0]
        for p in QOS_PROMPTS[:6]:
            router.submit(p, max_new_tokens=6)
        ticks = [asc.tick(), asc.tick()]
        grown = router._replicas[1].state
        ticks.append(asc.tick())
        cooled = asc.skipped_cooldown
        done = outcome(router.run_to_completion())
        clock[0] += 10.0
        ticks += [asc.tick(), asc.tick()]
        victim = int(ticks[-1].split(":")[1])
        retiring = router._replicas[victim].retiring
        router.step()
        retired = router._replicas[victim].state
        snap = router.fleet_snapshot()
        clock[0] += 10.0
        ticks += [asc.tick(), asc.tick()]
        rid = router.submit(QOS_PROMPTS[0], max_new_tokens=4)
        after = outcome(router.run_to_completion())
        with pytest.raises(ValueError, match="RETIRED"):
            router.replace(victim)
        return (ticks, grown, cooled, done, retiring, retired,
                snap["states"], snap["replicas"][victim]["retiring"],
                asc.snapshot(), after[rid][0], counters(router))

    j, t = both(sides, run)
    assert t == j
    ticks, grown, cooled, done, retiring, retired, states = t[:7]
    assert ticks[:4] == [None, "up:1", None, None]
    assert ticks[4].startswith("down:") and ticks[5:] == [None, None]
    assert grown == "READY" and cooled == 1 and retiring
    assert retired == "RETIRED" and states["RETIRED"] == 1
    assert t[8]["scale_downs"] == 1 and t[9] == "ok"
    assert len(done) == 6 and all(v[0] == "ok" for v in done.values())


def test_autoscaler_midramp_death_exactly_one_replacement(sides):
    def run(S):
        mk = factory(S, max_queue_len=16)
        router = S.fleet.FleetRouter([mk], metrics_registry=False)
        asc = S.fleet.FleetAutoscaler(
            router, mk, min_replicas=1, max_replicas=3,
            high_queued_tokens=8.0, low_queued_tokens=1.0,
            up_consecutive=2, down_consecutive=4, cooldown_s=0.0)
        clock = [0.0]
        asc._now = lambda: clock[0]
        rids = [router.submit(p, max_new_tokens=6) for p in QOS_PROMPTS[:6]]
        ticks = [asc.tick(), asc.tick()]
        with S.faults.plane() as fp:
            fp.inject("replica_death", RuntimeError("mid-ramp kill"), nth=1)
            router.step()
        dead = [h.idx for h in router._replicas if h.state == "DEAD"]
        clock[0] += 1.0
        ticks.append(asc.tick())
        settling = asc.skipped_settling
        router.step()
        mid = counters(router)
        done = outcome(router.run_to_completion())
        return rids, ticks, dead, settling, mid, done, counters(router), \
            audit_all(router)

    j, t = both(sides, run)
    assert t == j
    rids, ticks, dead, settling, mid, done, c, _ = t
    assert ticks == [None, "up:1", None] and len(dead) == 1
    assert settling >= 1 and mid["replaces"] == 1
    assert mid["states"].count("READY") == 2
    assert set(done) == set(rids) and c["replaces"] == 1
    assert c["scale_ups"] == 1


def test_fleet_http_surfaces_qos_counters(sides):
    def run(S):
        mk = factory(S)
        router = S.fleet.FleetRouter([mk] * 2, metrics_registry=False)
        srv = S.fleet.FleetServer(router)
        url = f"http://127.0.0.1:{srv.start()}"
        try:
            router.add_replica(mk)
            router.retire_replica(2)
            router.step()
            code, text, _ = http(url + "/fleet")
        finally:
            srv.stop()
        doc = json.loads(text)
        return (code, doc["scale_ups"], doc["scale_downs"],
                doc["quota_rejected"], doc["states"]["RETIRED"],
                [r["retiring"] for r in doc["replicas"]])

    j, t = both(sides, run)
    assert t == j == (200, 1, 1, 0, 1, [False, False, False])


# ---------------------------------------------------------------------------
# tracing across a failover; the speculative toggle through the router
# ---------------------------------------------------------------------------
def test_fleet_plain_failover_latency_breakdown(sides):
    prompts = [np.random.RandomState(13).randint(1, 128, (L,))
               for L in (10, 21, 33, 8)]

    def run(S):
        tr = S.obs.Tracer(S.obs.TraceStore(keep_slower_than_ms=0.0))
        router = S.fleet.FleetRouter([factory(S)] * 2,
                                     metrics_registry=False, tracer=tr)
        rids = [router.submit(p, max_new_tokens=8) for p in prompts]
        with S.faults.plane() as fp:
            fp.inject("replica_death", RuntimeError("killed"), nth=1)
            done = outcome(router.run_to_completion())
        traces = {}
        for rid in rids:
            doc = tr.get(str(rid))
            traces[rid] = (doc["status"], doc["attrs"].get("failovers"),
                           "failover_gap" in [s["name"]
                                              for s in doc["spans"]])
        return rids, done, traces, tr.index(status="live"), \
            counters(router)

    j, t = both(sides, run)
    assert t == j
    rids, done, traces, live, c = t
    ref = ref_outputs(sides["port"], prompts)
    assert c["failovers"] > 0 and live == []
    for i, rid in enumerate(rids):
        assert traces[rid][0] == done[rid][0]
        if done[rid][0] == "ok":
            assert done[rid][2] == ref[i]
    gaps = [rid for rid in rids if traces[rid][1]]
    assert gaps and all(traces[rid][2] for rid in gaps)


def test_spec_fleet_pass_through(sides):
    rng = np.random.RandomState(21)
    specs = [(rng.randint(1, 128, (L,)), 6) for L in (8, 15, 11, 19)]

    def run(S):
        mk = factory(S, spec=S.se.SpecConfig(gamma=3,
                                             source="prompt_lookup"))
        router = S.fleet.FleetRouter([mk, mk])
        rids = [router.submit(p, max_new_tokens=n, spec=True)
                for p, n in specs]
        done = outcome(router.run_to_completion())
        drafted = sum(h.engine.spec_drafted for h in router._replicas)
        return [done[r][2] for r in rids], drafted, audit_all(router)

    j, t = both(sides, run)
    assert t == j
    S = sides["port"]
    assert t[0] == [ref_outputs(S, [p], new=n)[0] for p, n in specs]
    assert t[1] > 0


# ---------------------------------------------------------------------------
# the port's own: the lanes that once refused serve; replaced and retired
# replicas give their pools back
# ---------------------------------------------------------------------------
def role_factory(S, role):
    """A prefill or decode replica factory of side ``S`` (host tier on)."""
    engine = {"prefill": S.dg.PrefillEngine, "decode": S.dg.DecodeEngine}

    def mk():
        cache = S.pd.PagedKVCache(S.cfg, **CACHE, host_pages=32, **S.dev)
        return engine[role](S.cfg, S.params, cache, metrics_registry=False)
    return mk


@pytest.mark.parametrize("what", ["roles", "handoff_transport"])
def test_unported_fleet_lanes_raise(sides, what):
    """The lanes this case once refused: ``roles`` (prefill and decode
    replicas, one grown through ``add_replica(role=...)``) and a caller's
    ``handoff_transport`` now serve, equal to JAX's router (tokens, the
    routing and hand-off counters, the transport's calls, clean audits).
    ``RemoteSpec`` replicas serve too (``tests/test_torch_transport.py``)."""
    def run(S):
        shipped = []
        kw = dict(metrics_registry=False, handoff_gbps=1e9)
        if what == "handoff_transport":
            def transport(rec, h):
                shipped.append((h.idx, rec.pages))
                rec.materialize()
                return h.engine.admit_handoff(rec)
            kw["handoff_transport"] = transport
            router = S.fleet.FleetRouter(
                [role_factory(S, "prefill"), role_factory(S, "decode")],
                roles=["prefill", "decode"], **kw)
        else:
            router = S.fleet.FleetRouter([role_factory(S, "decode")],
                                         roles=["decode"], **kw)
            router.add_replica(role_factory(S, "prefill"), role="prefill")
        rids = [router.submit(p, max_new_tokens=6) for p in PROMPTS[:3]]
        done = outcome(router.run_to_completion())
        snap = router.fleet_snapshot()
        return ([done[r] for r in rids], counters(router), snap["roles"],
                snap["disagg"], shipped, audit_all(router))

    j, t = both(sides, run)
    assert t == j
    S = sides["port"]
    assert [g for _, _, g, _ in t[0]] == ref_outputs(S, PROMPTS[:3], new=6)
    assert t[1]["routed"]["disagg"] == t[3]["handoffs_shipped"] == 3
    assert t[2] == {"unified": 0, "prefill": 1, "decode": 1}
    if what == "handoff_transport":
        assert [idx for idx, _ in t[4]] == [1, 1, 1]


def test_replaced_and_retired_replicas_free_their_pools(sides):
    """The dead engine's cache is unreachable once its replacement is
    built, and a retired replica keeps no engine: nothing holds their KV
    pools (no garbage-collector pass needed)."""
    S = sides["port"]
    router = S.fleet.FleetRouter([factory(S)] * 2, metrics_registry=False)
    for p in PROMPTS[:4]:
        router.submit(p, max_new_tokens=4)
    first = weakref.ref(router._replicas[0].engine.cache)
    with S.faults.plane() as fp:
        fp.inject("replica_death", RuntimeError("killed"), nth=1)
        router.step()
    router.step()                      # the auto-replace
    assert router.replaces == 1 and first() is None
    second = weakref.ref(router._replicas[1].engine.cache)
    router.retire_replica(1)
    router.run_to_completion()
    assert router._replicas[1].state == "RETIRED"
    assert router._replicas[1].engine is None and second() is None
    row = router.fleet_snapshot()["replicas"][1]
    assert row["state"] == "RETIRED" and row["active"] == 0
    assert row["requests_finished"] >= 1
