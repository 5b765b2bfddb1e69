"""QoS in the port's engine and HTTP front (``SchedulerPolicy``,
``TenantQuotas``, class-aware shedding, priority preemption) held against
``paddle_tpu``'s on the 2-layer fp32 config of
``tests/test_serving_qos.py`` with the same weights (``params_from_jax``).

Each case runs the same submissions through JAX's engine and the port's,
each with a registry and event ring of its own, and holds the port to
JAX's: every rid's status, tokens and ``degraded`` flag, which rids hold a
seat after a step, each submission's verdict (admitted, or the error's
type, text and ``retry_after``), ``requests_rejected``,
``requests_degraded``, ``quota_rejected``, ``preemptions``, the registry's
counters and per-class queue gauges, every ring event but its clocks, and
over HTTP the codes, bodies and ``Retry-After``.  The cases are the engine
cases of ``tests/test_serving_qos.py``; then priority preemption on the
overlap, horizon, spec and host-tier lanes (tokens, victims and counters
equal to JAX's engine on the same lane) and on the mixed lane, where the
port preempts for a higher class at the carve too (JAX's carve waits for a
free seat): the tokens equal JAX's and the unloaded run's.
"""

import json
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_fleet import (factory, http, poll,  # noqa: E402
                              sides)  # noqa: F401  (a fixture)

QOS_PROMPTS = [np.random.RandomState(20).randint(1, 128, (L,))
               for L in (10, 21, 33, 8, 17, 26, 12, 19)]
CLOCK_FIELDS = ("ts", "wall", "tid", "dur_s")


def engine(S, **kw):
    """An engine of side ``S`` on a registry and ring of its own."""
    return factory(S, registry=S.obs.MetricsRegistry(),
                   metrics_ring=S.obs.EventRing(), **kw)()


def events(eng):
    return [{k: v for k, v in e.items() if k not in CLOCK_FIELDS}
            for e in eng.metrics.ring.recent(n=10_000)]


def outcome(done):
    return {r.rid: (r.status, [int(t) for t in r.generated], r.degraded,
                    r.preempted) for r in done}


def verdict(fn):
    """Call ``fn`` -> its result, or the error's type, text and hint."""
    try:
        return ("ok", fn())
    except Exception as e:
        return (type(e).__name__, str(e), getattr(e, "retry_after", None),
                getattr(e, "tenant", None))


def counts(eng):
    m = eng.metrics
    return {"rejected": eng.requests_rejected,
            "degraded": eng.requests_degraded,
            "quota_rejected": eng.quota_rejected,
            "preemptions": eng.preemptions,
            "m_rejected": m.requests_rejected.value,
            "m_degraded": m.requests_degraded.value,
            "m_quota": m.quota_rejected.value,
            "by_class": eng.queued_by_class(),
            "gauges": [m.queued_high.value, m.queued_normal.value,
                       m.queued_low.value]}


def both(sides, run):
    return run(sides["jax"]), run(sides["port"])


_REF = {}


def unloaded(S, prompts, new=8):
    key = (S.name, new, tuple(bytes(np.asarray(p)) for p in prompts))
    if key not in _REF:
        eng = factory(S)()
        rids = [eng.submit(p, max_new_tokens=new) for p in prompts]
        done = {r.rid: [int(t) for t in r.generated]
                for r in eng.run_to_completion()}
        _REF[key] = [done[r] for r in rids]
    return _REF[key]


# ---------------------------------------------------------------------------
# priority classes: validation, admission order, preemption
# ---------------------------------------------------------------------------
def test_priority_validates_and_orders_admission(sides):
    def run(S):
        eng = engine(S)
        bad = verdict(lambda: eng.submit(QOS_PROMPTS[0], max_new_tokens=4,
                                         priority="urgent"))
        rids = [eng.submit(QOS_PROMPTS[0], 4, priority="low"),
                eng.submit(QOS_PROMPTS[1], 4, priority="low"),
                eng.submit(QOS_PROMPTS[2], 4, priority="high"),
                eng.submit(QOS_PROMPTS[3], 4)]
        queued = counts(eng)
        eng.step()
        seated = sorted(r.rid for r in eng._active.values())
        done = outcome(eng.run_to_completion())
        return (bad, rids, queued, seated, done, events(eng),
                eng.cache.audit()["owned"])

    j, t = both(sides, run)
    assert t == j
    bad, rids, queued, seated, done = t[:5]
    assert bad[0] == "ValueError" and "priority" in bad[1]
    assert queued["by_class"] == {"high": 1, "normal": 1, "low": 2}
    assert queued["gauges"] == [1.0, 1.0, 2.0]
    assert seated == [rids[2], rids[3]]
    ref = unloaded(sides["port"], QOS_PROMPTS[:4], new=4)
    assert [done[r][1] for r in rids] == ref
    sub = [(e["priority"], e["tenant"]) for e in t[5]
           if e["name"] == "request_submitted"]
    assert sub == [("low", None), ("low", None), ("high", None),
                   ("normal", None)]


SPEC = object()          # marks the lane whose SpecConfig is built per side
LANES = {
    "sync": {},
    "overlap": {"overlap": True},
    "horizon": {"decode_horizon": 2},
    "overlap_horizon": {"overlap": True, "decode_horizon": 4},
    "spec": {"spec": SPEC},
    "host_tier": {"host_pages": 32},
    "mixed": {"mixed": True, "mixed_token_budget": 16},
}


def _lane_kw(S, lane):
    kw = dict(LANES[lane])
    if kw.get("spec") is SPEC:
        kw["spec"] = S.se.SpecConfig(gamma=3, source="prompt_lookup")
    return kw


@pytest.mark.parametrize("lane", list(LANES))
def test_priority_preemption_on_every_lane(sides, lane):
    """Two lows hold both seats; a high arrives.  It takes a low's seat
    (the youngest low, swapped to the host tier on that lane), the victim
    resumes, and every request ends with the unloaded run's tokens and
    JAX's engine's on the same lane."""
    def run(S):
        eng = engine(S, **_lane_kw(S, lane))
        if lane == "host_tier":
            eng.offload_swap_gbps = 1e9       # price the swap under recompute
        lows = [eng.submit(p, max_new_tokens=8, priority="low")
                for p in QOS_PROMPTS[:2]]
        eng.step()
        h = eng.submit(QOS_PROMPTS[2], max_new_tokens=8, priority="high")
        eng.step()
        seated = h in {r.rid for r in eng._active.values()} or h in {
            e["req"].rid for e in eng._mixed_pref.values()}
        preempted = [(e["rid"], e["mode"]) for e in events(eng)
                     if e["name"] == "preemption"]
        done = outcome(eng.run_to_completion())
        extra = {"resumes_swapped": eng.resumes_swapped,
                 "resumes_recompute": eng.resumes_recompute,
                 "owned": eng.cache.audit()["owned"]}
        return lows, h, seated, preempted, done, counts(eng), extra, \
            events(eng)

    j, t = both(sides, run)
    lows, h, seated, preempted, done, c, extra, _ = t
    ref = unloaded(sides["port"], QOS_PROMPTS[:3])
    assert [done[r][1] for r in lows + [h]] == ref
    assert {r: v[1] for r, v in done.items()} == \
        {r: v[1] for r, v in j[4].items()}
    assert all(v[0] == "ok" for v in done.values())
    assert seated and done[h][3] == 0, "the high class was churned"
    # the victim is the younger low
    assert preempted[0][0] == lows[1]
    assert extra["owned"] == 0
    if lane == "host_tier":
        assert preempted[0][1] == "swap" and extra["resumes_swapped"] >= 1
    if lane != "mixed":
        assert t == j
    else:
        # JAX's mixed carve waits for a free seat: no priority preemption.
        # The port's evicts the younger low once, resumed by recompute;
        # every other counter, gauge and submission event equals JAX's
        assert not j[2] and j[3] == [] and j[6]["resumes_recompute"] == 0
        assert preempted == [(lows[1], "recompute")]
        assert c["preemptions"] == 1 and extra["resumes_recompute"] == 1
        assert {k: v for k, v in c.items() if k != "preemptions"} == \
            {k: v for k, v in j[5].items() if k != "preemptions"}
        assert [e for e in t[7] if e["name"] == "request_submitted"] == \
            [e for e in j[7] if e["name"] == "request_submitted"]


def test_priority_preemption_victims_lowest_class_lifo(sides):
    """Four seats held by normal, low, normal, low (in that admission
    order) and two highs arrive: the victims are the lows, youngest first,
    and the normals keep their seats."""
    def run(S):
        eng = engine(S, batch=4)
        rids = [eng.submit(p, max_new_tokens=8, priority=c)
                for p, c in zip(QOS_PROMPTS[:4],
                                ("normal", "low", "normal", "low"))]
        eng.step()
        highs = [eng.submit(p, max_new_tokens=8, priority="high")
                 for p in QOS_PROMPTS[4:6]]
        eng.step()
        done = outcome(eng.run_to_completion())
        victims = [e["rid"] for e in events(eng)
                   if e["name"] == "preemption"]
        return rids, highs, victims, done, counts(eng)

    j, t = both(sides, run)
    assert t == j
    rids, highs, victims, done, _ = t
    assert victims == [rids[3], rids[1]]
    ref = unloaded(sides["port"], QOS_PROMPTS[:6])
    assert [done[r][1] for r in rids + highs] == ref


# ---------------------------------------------------------------------------
# class-aware overload shedding
# ---------------------------------------------------------------------------
def test_shed_low_rejects_normal_degrades_high_admits(sides):
    def run(S):
        eng = engine(S, max_queue_len=3)
        base = [eng.submit(p, max_new_tokens=8) for p in QOS_PROMPTS[:3]]
        v = [verdict(lambda: eng.submit(QOS_PROMPTS[3], 8, priority="low")),
             verdict(lambda: eng.submit(QOS_PROMPTS[3], 8,
                                        priority="high")),
             verdict(lambda: eng.submit(QOS_PROMPTS[4], 8)),
             verdict(lambda: eng.submit(QOS_PROMPTS[5], 8)),
             verdict(lambda: eng.submit(QOS_PROMPTS[6], 8,
                                        priority="high"))]
        before = counts(eng)
        done = outcome(eng.run_to_completion())
        return base, v, before, done, events(eng), counts(eng)

    j, t = both(sides, run)
    assert t == j
    base, v, before, done, ev, _ = t
    assert v[0][0] == "QueueFullError" and v[0][2] > 0
    assert [x[0] for x in v[1:4]] == ["ok"] * 3
    assert v[4][0] == "QueueFullError" and "hard bound" in v[4][1]
    assert before["rejected"] == 2 and before["degraded"] == 2
    assert before["m_degraded"] == 2
    ref = unloaded(sides["port"], QOS_PROMPTS)
    h, n1, n2 = v[1][1], v[2][1], v[3][1]
    assert done[h][1] == ref[3] and not done[h][2]
    for i, rid in ((4, n1), (5, n2)):
        assert done[rid][2] and done[rid][1] == ref[i][:4]
    deg = [e for e in ev if e["name"] == "request_degraded"]
    assert [(e["priority"], e["max_new_tokens"]) for e in deg] == \
        [("normal", 4), ("normal", 4)]


def test_default_class_workload_keeps_legacy_429(sides):
    def run(S):
        eng = engine(S, max_queue_len=2)
        for p in QOS_PROMPTS[:2]:
            eng.submit(p, max_new_tokens=4)
        v = verdict(lambda: eng.submit(QOS_PROMPTS[2], max_new_tokens=4))
        done = outcome(eng.run_to_completion())
        return v, done, counts(eng), events(eng)

    j, t = both(sides, run)
    assert t == j
    v, done, c, _ = t
    assert v[0] == "QueueFullError" and "hard bound" not in v[1]
    assert c["degraded"] == 0 and c["rejected"] == 1
    assert not any(d[2] for d in done.values())


def test_capacity_probe_is_class_aware(sides):
    """``queue_capacity_reason(priority=)`` answers what ``submit()``
    would do for that class, without charging a counter."""
    def run(S):
        eng = engine(S, max_queue_len=2, max_queued_tokens=60)
        out = []
        for p, c in zip(QOS_PROMPTS[:5], ("high", "low", "normal", "high",
                                           "normal")):
            out.append([eng.queue_capacity_reason(len(p), priority=k)
                        for k in ("high", "normal", "low", None)])
            out.append(verdict(lambda: eng.submit(p, 4, priority=c)))
        return out, counts(eng)

    j, t = both(sides, run)
    assert t == j


# ---------------------------------------------------------------------------
# tenant quotas
# ---------------------------------------------------------------------------
def test_tenant_quota_isolates_and_refills(sides):
    def run(S):
        eng = engine(S)
        eng.quotas = S.se.TenantQuotas(rate_tokens_per_s=10.0,
                                       burst_tokens=40.0)
        clock = [1000.0]
        eng._now = lambda: clock[0]
        p = QOS_PROMPTS[0]                     # cost 10 + 8 = 18
        v = [verdict(lambda: eng.submit(p, 8, tenant="a")),
             verdict(lambda: eng.submit(p, 8, tenant="a")),
             verdict(lambda: eng.submit(p, 8, tenant="a")),
             verdict(lambda: eng.submit(p, 8, tenant="b")),
             verdict(lambda: eng.submit(p, 8))]
        clock[0] += 1.41
        v.append(verdict(lambda: eng.submit(p, 8, tenant="a")))
        done = outcome(eng.run_to_completion())
        return v, done, counts(eng), events(eng)

    j, t = both(sides, run)
    assert t == j
    v, done, c, ev = t
    assert v[2][0] == "QuotaExceededError" and v[2][3] == "a"
    assert v[2][2] == pytest.approx(1.4)
    assert [x[0] for x in v[3:]] == ["ok"] * 3
    assert c["quota_rejected"] == 1 == c["m_quota"]
    assert len(done) == 5 and all(d[0] == "ok" for d in done.values())
    assert [e for e in ev if e["name"] == "quota_rejected"] == [
        {"name": "quota_rejected", "seq": next(
            e["seq"] for e in ev if e["name"] == "quota_rejected"),
         "tenant": "a", "priority": "normal"}]


def test_quota_charges_after_the_shed_verdict(sides):
    """A request the shed path rejects costs its tenant nothing; a
    degraded one is charged its halved budget."""
    def run(S):
        eng = engine(S, max_queue_len=1)
        eng.quotas = S.se.TenantQuotas(rate_tokens_per_s=1.0,
                                       burst_tokens=60.0)
        eng._now = lambda: 1000.0
        p = QOS_PROMPTS[3]                    # 8 tokens
        v = [verdict(lambda: eng.submit(p, 8, priority="high",
                                        tenant="a")),
             verdict(lambda: eng.submit(p, 20, priority="low", tenant="a")),
             verdict(lambda: eng.submit(p, 20, tenant="a")),
             verdict(lambda: eng.submit(p, 20, tenant="a"))]
        level = eng.quotas._buckets["a"][0]
        done = outcome(eng.run_to_completion())
        return v, level, done, counts(eng)

    j, t = both(sides, run)
    assert t == j
    v, level = t[:2]
    assert v[1][0] == "QueueFullError" and v[2][0] == "ok"
    assert level == 60 - 16 - 18 and v[3][0] == "QueueFullError"


# ---------------------------------------------------------------------------
# the HTTP front
# ---------------------------------------------------------------------------
def test_quota_http_429_carries_bucket_retry_after(sides):
    def run(S):
        eng = factory(S, tenant_quotas=S.se.TenantQuotas(
            rate_tokens_per_s=1.0, burst_tokens=20.0))()
        eng._now = lambda: 1000.0             # the bucket does not refill
        srv = S.srv.GenerationServer(engine=eng)
        url = f"http://127.0.0.1:{srv.start()}"
        try:
            def post(ten):
                code, text, headers = http(url + "/generate", json.dumps(
                    {"prompt": [int(x) for x in QOS_PROMPTS[0]],
                     "max_new_tokens": 4, "tenant": ten}).encode())
                return code, b"quota" in text, headers.get("Retry-After")
            return [post("a"), post("a"), post("b")]
        finally:
            srv.stop()

    j, t = both(sides, run)
    assert t == j
    assert [c[0] for c in t] == [200, 429, 200]
    # the deficit (14 - 6) / 1 token a second
    assert t[1][1] and t[1][2] == "8"


def _gated(eng):
    """Hold the drive loop until ``gate`` is set, so every submission
    lands before the first step."""
    gate, real = threading.Event(), eng.has_work
    eng.has_work = lambda: gate.is_set() and real()
    return gate


def _stream(url, payload):
    """Every line of a ``/generate_stream`` reply."""
    import urllib.request
    req = urllib.request.Request(url + "/generate_stream",
                                 data=json.dumps(payload).encode())
    with urllib.request.urlopen(req, timeout=60) as r:
        return [json.loads(line) for line in r if line.strip()]


def test_http_degraded_completion_is_flagged(sides):
    """Two requests of named classes fill the soft bound (2); a normal
    ``/generate`` and a normal ``/generate_stream`` then admit degraded:
    half their budget, and ``"degraded": true`` in the reply and in the
    stream's last line.  An unknown class is a 400."""
    def run(S):
        eng = engine(S, max_queue_len=2)
        srv = S.srv.GenerationServer(engine=eng)
        gate = _gated(eng)
        url = f"http://127.0.0.1:{srv.start()}"
        out, threads = {}, []
        try:
            bad = http(url + "/generate", json.dumps(
                {"prompt": [1, 2], "priority": "urgent"}).encode())[0]
            for i, cls in ((0, "high"), (1, "low")):
                srv.submit([int(x) for x in QOS_PROMPTS[i]], 8,
                           priority=cls)

            def gen():
                code, text, _ = http(url + "/generate", json.dumps(
                    {"prompt": [int(x) for x in QOS_PROMPTS[2]],
                     "max_new_tokens": 8}).encode())
                out["generate"] = (code, json.loads(text))

            def stream():
                out["stream"] = _stream(url, {
                    "prompt": [int(x) for x in QOS_PROMPTS[3]],
                    "max_new_tokens": 8})

            for target in (gen, stream):
                threads.append(threading.Thread(target=target, daemon=True))
                threads[-1].start()
                poll(lambda: eng._next_rid == len(threads) + 2)
            gate.set()
            for th in threads:
                th.join(timeout=60)
        finally:
            srv.stop()
        return bad, out, eng.requests_degraded

    j, t = both(sides, run)
    assert t == j
    bad, out, degraded = t
    assert bad == 400 and degraded == 2
    code, doc = out["generate"]
    assert code == 200 and doc["degraded"] is True
    assert doc["tokens"] == unloaded(sides["port"], [QOS_PROMPTS[2]])[0][:4]
    last = out["stream"][-1]
    assert last["done"] and last["degraded"] is True
    assert [m["token"] for m in out["stream"][:-1]] == last["tokens"] == \
        unloaded(sides["port"], [QOS_PROMPTS[3]])[0][:4]


# ---------------------------------------------------------------------------
# eager pruning of expired queued requests; the supervisor keeps classes
# ---------------------------------------------------------------------------
def test_expired_queued_request_never_spends_a_prefill(sides):
    def run(S):
        eng = engine(S)
        clock = [1000.0]
        eng._now = lambda: clock[0]
        doomed = eng.submit(QOS_PROMPTS[0], 4, deadline_s=5.0)
        live = eng.submit(QOS_PROMPTS[1], 4)
        clock[0] += 10.0
        done = outcome(eng.run_to_completion())
        return doomed, live, done, eng.prefill_calls, \
            eng.cache.audit()["owned"]

    j, t = both(sides, run)
    assert t == j
    doomed, live, done, calls, _ = t
    assert done[doomed][0] == "expired" and done[doomed][1] == []
    assert done[live][0] == "ok" and calls == 1


def test_supervisor_rebuild_keeps_the_class_order(sides):
    """A rebuild carries the queue over with its classes: a low request
    queued when the engine died still ranks below a normal one submitted
    to the rebuilt engine."""
    def run(S):
        sup = S.se.EngineSupervisor(
            factory(S, quarantine_faults=False, batch=1), backoff_s=0.0)
        first = sup.submit(QOS_PROMPTS[0], 4, priority="high")
        sup.step()
        low = sup.submit(QOS_PROMPTS[1], 4, priority="low")
        with S.faults.plane() as fp:
            fp.inject("step_dispatch", RuntimeError("boom"), nth=1)
            sup.step()
        normal = sup.submit(QOS_PROMPTS[2], 4)
        has = sup.engine._has_priorities
        sup.step()
        seated = [r.rid for r in sup.engine._active.values()]
        done = outcome(sup.run_to_completion())
        return first, low, normal, has, seated, done, sup.restarts

    j, t = both(sides, run)
    assert t == j
    first, low, normal, has, seated, done, restarts = t
    assert restarts == 1 and has and seated == [normal]
    assert done[first][0] == "error" and done[low][0] == "ok"
