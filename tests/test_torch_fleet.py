"""The port's serving fleet (``dist_svgd_torch/serving/fleet.py``) against
JAX's (``dist_svgd_tpu/serving/fleet.py``), on the CPU.

Every scenario is one function of a *side* — a package's fleet module,
metrics registry, backoff and fleet faults — and runs once on each side
with the same injected clock steps, fault schedules and request
sequences; the records must be equal: ring points and placements, the
breaker transition logs, ``RouteResult`` statuses / replicas / attempt
counts / outcomes / headers / bodies under the four fleet faults and the
429, 503 and 504 paths, the federated registry's dump across a counter
reset, and the keys of ``/fleet`` and ``/usage``.  A ``LoopbackReplica``
over a CPU ``PredictiveEngine`` serves through the router bitwise equal to
the engine, and within the serving tests' tolerance of JAX's engine;
``HttpTransport`` routes over in-process port ``PredictionServer``s on
real sockets, with a partition and its heal.  Its keep-alive pool (a
deviation from JAX's connection a request; the route outcomes above stay
equal) is held on real sockets too: sequential requests ride one accepted
connection, 32 concurrent ones keep at most ``POOL_IDLE_MAX`` idle, a
connection the replica's idle timeout ended is retried once with no
breaker failure, a replica shut down or killed under the pool gives one
``ConnectError`` and one recorded failure a forward, partitions, restarts
on a new port and timeouts close what they concern; the replica server
and the front door read a body they do not route, write each reply once
on a ``TCP_NODELAY`` socket and end idle connections at shutdown, the
drain's 503 first."""

import json
import sys
import threading
import time
import types
import urllib.error
import urllib.request

import numpy as np
import pytest

from dist_svgd_torch import resilience as tres
from dist_svgd_torch.serving import PredictionServer, PredictiveEngine
from dist_svgd_torch.serving import fleet as tfleet
from dist_svgd_torch.telemetry import metrics as tmetrics
from dist_svgd_torch.telemetry import trace as ttrace

from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

#: float32 outputs of the two engines agree within this, relative (the
#: serving tests' tolerance).
F32_RTOL = 1e-6


def _side(pkg):
    if pkg == "port":
        fleet, metrics, res, trace = tfleet, tmetrics, tres, ttrace
    else:
        from dist_svgd_tpu import resilience as res
        from dist_svgd_tpu.serving import fleet
        from dist_svgd_tpu.telemetry import metrics, trace
    return types.SimpleNamespace(
        name=pkg, fleet=fleet, Registry=metrics.MetricsRegistry, trace=trace,
        Backoff=res.Backoff, Kill=res.ReplicaKillAt, Hang=res.ReplicaHangAt,
        Partition=res.PartitionAt, Slow=res.SlowReplicaAt)


PORT = _side("port")


@pytest.fixture(scope="module")
def jax_side():
    return _side("jax")


class ManualClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def advance(self, s):
        self.t += s


def _body(tenant="t0", rows=1):
    return json.dumps({"inputs": [[0.1, 0.2]] * rows,
                       "tenant": tenant}).encode()


def make_fleet(side, n=3, *, clock=None, faults=(), predict=None,
               tenants=(), fail_threshold=2, passive_fail_threshold=3,
               open_cooldown_s=2.0, slo_max_age_s=None, **router_kw):
    """``n`` loopback replicas + fake transport + a clock-injected router
    (JAX's ``tests/test_fleet.py:make_fleet``).  Returns (router, replicas
    dict, transport, clock, sleeps list)."""
    clock = clock or ManualClock()
    reg = side.Registry()
    replicas = {f"r{i}": side.fleet.LoopbackReplica(
        f"r{i}", predict_fn=predict, tenants=tenants, clock=clock)
        for i in range(n)}
    transport = side.fleet.FakeTransport(replicas, faults=faults,
                                         advance=clock.advance)
    rs = side.fleet.ReplicaSet(
        list(replicas), transport, fail_threshold=fail_threshold,
        passive_fail_threshold=passive_fail_threshold,
        open_cooldown_s=open_cooldown_s, probe_interval_s=0.05,
        slo_max_age_s=slo_max_age_s, clock=clock, registry=reg)
    sleeps = []

    def fake_sleep(s):
        sleeps.append(s)
        clock.advance(s)

    router_kw.setdefault("backoff", side.Backoff(base_s=0.01, factor=2.0,
                                                 max_s=0.1, jitter_frac=0.0))
    router = side.fleet.FleetRouter(
        list(replicas), transport=transport, replica_set=rs,
        clock=clock, sleep=fake_sleep, registry=reg, **router_kw)
    return router, replicas, transport, clock, sleeps


def _result(res):
    return (res.status, res.replica, res.attempts, res.outcome, res.hedged,
            dict(res.headers), res.json())


def _counters(reg, names):
    out = {}
    for name in names:
        metric = reg.get(name)
        if metric is None:
            continue
        out[name] = sorted((tuple(sorted(ls.items())), metric.value(**ls))
                           for ls in metric.label_sets())
    return out


FLEET_COUNTERS = ("svgd_fleet_requests_total", "svgd_fleet_retries_total",
                  "svgd_fleet_hedges_total", "svgd_fleet_failovers_total",
                  "svgd_fleet_ejections_total", "svgd_fleet_readmissions_total",
                  "svgd_fleet_misroutes_total")


def _home(side, tenant, replicas=("r0", "r1", "r2")):
    return side.fleet._HashRing(list(replicas), vnodes=32).order(tenant)[0]


# --------------------------------------------------------------------- #
# the API surface


def test_all_and_constants_equal_jax(jax_side):
    assert tfleet.__all__ == jax_side.fleet.__all__
    for name in ("CLOSED", "OPEN", "HALF_OPEN", "DEADLINE_HEADER", "ATTEMPT_HEADER",
                 "TRACE_HEADER", "_STATE_GAUGE"):
        assert getattr(tfleet, name) == getattr(jax_side.fleet, name)
    for name in tfleet.__all__:
        obj = getattr(tfleet, name)
        if not isinstance(obj, str):
            assert obj.__module__ == "dist_svgd_torch.serving.fleet"


def test_server_takes_the_one_retry_after_formatter_and_backlog():
    from dist_svgd_torch.serving import server

    assert server.format_retry_after is tfleet.format_retry_after
    assert server.LISTEN_BACKLOG == tfleet.LISTEN_BACKLOG == 1024
    assert server._HTTPServer is tfleet._HTTPServer
    assert tfleet._HTTPServer.request_queue_size == 1024


# --------------------------------------------------------------------- #
# consistent hashing


KEYS = ["", "t0", "tenant-42", "r0#0", "r2#31", "ünïcode", "a" * 300]


def test_hash_point_equals_jax(jax_side):
    for key in KEYS + [f"t{i}" for i in range(100)]:
        assert tfleet._hash_point(key) == jax_side.fleet._hash_point(key)


@pytest.mark.parametrize("replicas", [("r0", "r1", "r2"), ("a", "b"),
                                      tuple(f"replica-{i}" for i in range(7))])
@pytest.mark.parametrize("vnodes", [1, 4, 32, 64])
def test_ring_placement_equals_jax(jax_side, replicas, vnodes):
    ours = tfleet._HashRing(replicas, vnodes=vnodes)
    theirs = jax_side.fleet._HashRing(replicas, vnodes=vnodes)
    assert ours._points == theirs._points and ours._owners == theirs._owners
    for tenant in KEYS + [f"t{i}" for i in range(64)]:
        order = ours.order(tenant)
        assert order == theirs.order(tenant)
        assert sorted(order) == sorted(replicas)


def _bounded_load(side):
    """Admissions under the bounded-load rule, then the router's pick
    passes piling in-flight requests on one tenant's ring order."""
    reg = side.Registry()
    reps = {r: side.fleet.LoopbackReplica(r) for r in ("a", "b", "c")}
    rs = side.fleet.ReplicaSet(list(reps), side.fleet.FakeTransport(reps),
                               clock=ManualClock(), registry=reg)
    admits = [rs.begin_request("a") for _ in range(4)]
    admits += [rs.begin_request(r, load_factor=lf)
               for lf in (1.0, 1.5, 2.0, None) for r in ("a", "b", "c")]
    router = side.fleet.FleetRouter(list(reps), transport=rs.transport,
                                    replica_set=rs, registry=reg,
                                    load_factor=1.0)
    picks = [router._pick(router.order_for("t-busy"), set())
             for _ in range(12)]
    return admits, picks, rs.stats()


def test_bounded_load_overflow_equals_jax(jax_side):
    ours, theirs = _bounded_load(PORT), _bounded_load(jax_side)
    assert ours == theirs
    admits, picks, _ = ours
    assert admits[4] is False  # a past its fair share at load_factor 1.0
    assert len(set(picks)) == 3  # the overflow spread past the home


# --------------------------------------------------------------------- #
# SLO classification and the Retry-After header


SLO_DOCS = [
    ({"status": "ok", "ts": 10.0}, None, None),
    ({"status": "breach"}, None, None),
    ({"status": "no_data"}, None, None),
    ({}, None, None),
    (None, None, None),
    ("not a dict", None, None),
    ([{"status": "ok"}], None, None),
    ({"status": "ok", "ts": 100.0}, 105.0, 30.0),
    ({"status": "ok", "ts": 100.0}, 200.0, 30.0),
    ({"status": "ok"}, 200.0, 30.0),
    ({"status": "ok", "ts": "100"}, 105.0, 30.0),
    ({"status": "breach", "ts": 0.0}, 100.0, 10.0),
    ({"status": "breach", "ts": 95.0}, 100.0, 10.0),
    ({"status": "ok", "ts": 100.0}, 130.0, 30.0),
    ({"status": "ok", "ts": 100.0}, None, 30.0),
]


@pytest.mark.parametrize("doc,now_s,max_age_s", SLO_DOCS)
def test_classify_slo_equals_jax(jax_side, doc, now_s, max_age_s):
    ours = tfleet.classify_slo(doc, now_s=now_s, max_age_s=max_age_s)
    assert ours == jax_side.fleet.classify_slo(doc, now_s=now_s, max_age_s=max_age_s)
    if not (isinstance(doc, dict) and doc.get("status") == "ok"):
        assert ours != "healthy"  # unknown, never healthy


def test_format_retry_after_equals_jax(jax_side):
    for s in (0.0, 1e-9, 0.2, 0.999, 1.0, 1.0001, 2.5, 7.0, 59.99, 3600.0, -3.0):
        assert tfleet.format_retry_after(s) == jax_side.fleet.format_retry_after(s)
    assert tfleet.format_retry_after(0.2) == "1"


def test_reply_parsing_equals_jax(jax_side):
    for headers, body in (({"Retry-After": "7"}, b'{"a": 1}'),
                          ({"retry-after": "0.07"}, b"null"),
                          ({"Retry-After": "soon"}, b"not json"),
                          ({"Retry-After": "-2"}, "text"),
                          ({}, b"")):
        ours = tfleet.Reply(200, headers, body)
        theirs = jax_side.fleet.Reply(200, headers, body)
        assert (ours.headers, ours.body, ours.json(), ours.retry_after_s()) == (
            theirs.headers, theirs.body, theirs.json(), theirs.retry_after_s())


# --------------------------------------------------------------------- #
# circuit breaker: the transition logs


def _probe_failures(side):
    router, reps, tr, clock, _ = make_fleet(side, fail_threshold=2)
    rs = router.replica_set
    tr.kill("r1")
    states = [rs.probe_once()]
    clock.advance(0.05)
    states.append(rs.probe_once())
    return states, rs


def _passive_failures(side):
    router, reps, tr, clock, _ = make_fleet(side, passive_fail_threshold=2,
                                            max_retries=2)
    tenant = next(t for t in (f"t{i}" for i in range(50))
                  if router.order_for(t)[0] == "r0")
    tr.kill("r0")
    out = []
    for _ in range(3):
        out.append(_result(router.route(tenant, _body(tenant))))
        clock.advance(0.1)
    return out, router.replica_set


def _draining(side):
    router, reps, tr, clock, _ = make_fleet(side, fail_threshold=3)
    reps["r0"].draining = True
    out = [router.replica_set.probe_once()]
    out.append(_result(router.route("t0", _body("t0"))))
    out.append(reps["r0"].handle("POST", "/predict", _body("t0"), {}).status)
    return out, router.replica_set


def _slo_breach(side):
    router, reps, tr, clock, _ = make_fleet(side)
    reps["r2"].slo_status = "breach"
    reps["r1"].slo_status = "no_data"
    out = [router.replica_set.probe_once()]
    clock.advance(3.0)
    reps["r2"].slo_status = "ok"
    out.append(router.replica_set.probe_once())
    return out, router.replica_set


def _stale_slo(side):
    """A stale ``ok`` neither ejects nor re-admits; a fresh breach ejects."""
    router, reps, tr, clock, _ = make_fleet(side, slo_max_age_s=5.0)
    for rep in reps.values():
        rep._clock = lambda: 0.0  # every replica stamps its verdict at 0
    clock.advance(10.0)
    reps["r1"].slo_status = "breach"  # stale: unknown, not burning
    out = [router.replica_set.probe_once()]
    reps["r1"]._clock = clock
    out.append(router.replica_set.probe_once())
    return out, router.replica_set


def _half_open_trial(side):
    router, reps, tr, clock, _ = make_fleet(side, fail_threshold=1,
                                            open_cooldown_s=2.0)
    rs = router.replica_set
    tr.kill("r1")
    out = [rs.probe_once()]
    clock.advance(1.0)
    out.append(rs.probe_once())
    clock.advance(1.5)
    out.append(rs.probe_once())  # half-open trial fails: re-opens
    tr.restore("r1")
    clock.advance(2.5)
    out.append(rs.probe_once())  # the trial re-admits
    return out, rs


def _readmission_by_request(side):
    """A half-open circuit re-admits on a trial REQUEST, one at a time;
    a failing trial request re-opens it."""
    router, reps, tr, clock, _ = make_fleet(side, fail_threshold=1,
                                            open_cooldown_s=1.0)
    rs = router.replica_set
    tenant = next(t for t in (f"t{i}" for i in range(50))
                  if router.order_for(t)[0] == "r2")
    tr.kill("r2")
    out = [rs.probe_once()]
    clock.advance(1.5)
    out.append(_result(router.route(tenant, _body(tenant))))  # trial fails
    tr.restore("r2")
    clock.advance(1.5)
    out.append(rs.state("r2"))
    out.append(rs.begin_request("r2"))
    out.append(rs.begin_request("r2"))  # one trial at a time
    rs.record_success("r2")
    out.append(_result(router.route(tenant, _body(tenant))))
    return out, rs


def _shed_trial(side):
    router, reps, tr, clock, _ = make_fleet(side, fail_threshold=1,
                                            open_cooldown_s=1.0)
    rs = router.replica_set
    tr.kill("r0")
    out = [rs.probe_once()]
    tr.restore("r0")
    clock.advance(1.5)
    out.append(rs.begin_request("r0"))
    rs.record_shed("r0", retry_after_s=3.0)
    out.append((rs.state("r0"), rs.backpressured("r0")))
    clock.advance(3.5)
    out.append(rs.backpressured("r0"))
    return out, rs


def _probe_tenant_paths(side):
    clock = ManualClock()
    reps = {"a": side.fleet.LoopbackReplica("a", tenants=("t0",)),
            "b": side.fleet.LoopbackReplica("b", tenants=("t0", "t1"))}
    rs = side.fleet.ReplicaSet(list(reps), side.fleet.FakeTransport(reps),
                               fail_threshold=1, probe_tenants=("t1",),
                               clock=clock, registry=side.Registry())
    return [rs.probe_once()], rs


BREAKER_SCENARIOS = {
    "probe_failures": _probe_failures,
    "passive_failures": _passive_failures,
    "draining": _draining,
    "slo_breach": _slo_breach,
    "stale_slo": _stale_slo,
    "half_open_trial": _half_open_trial,
    "readmission_by_request": _readmission_by_request,
    "shed_trial": _shed_trial,
}


def _run_breaker(side, name):
    out, rs = BREAKER_SCENARIOS[name](side)
    return (out, list(rs.state_changes), rs.stats(),
            _counters(rs.registry, FLEET_COUNTERS),
            _counters(rs.registry, ("svgd_fleet_replica_state",)))


@pytest.mark.parametrize("name", sorted(BREAKER_SCENARIOS))
def test_breaker_transition_log_equals_jax(jax_side, name):
    ours = _run_breaker(PORT, name)
    theirs = _run_breaker(jax_side, name)
    assert ours == theirs
    assert ours[1], "the scenario moved no circuit"


def test_breaker_reasons_are_jax_reasons():
    """The logs name each rule the module docstring lists."""
    reasons = set()
    for name in BREAKER_SCENARIOS:
        reasons |= {r[4] for r in _run_breaker(PORT, name)[1]}
    assert {"probe_failures", "request_failures:connect", "draining", "slo_burn",
            "cooldown_elapsed", "trial_probe_failed", "trial_probe_ok",
            "trial_failed:connect", "trial_request_ok",
            "trial_shed_alive"} <= reasons


def test_probe_tenant_paths_equal_jax(jax_side):
    (ours, rs_o), (theirs, rs_t) = _probe_tenant_paths(PORT), _probe_tenant_paths(jax_side)
    assert ours == theirs == [{"a": "open", "b": "closed"}]
    assert list(rs_o.state_changes) == list(rs_t.state_changes)


# --------------------------------------------------------------------- #
# routing under the fleet faults, and the 429 / 503 / 504 paths


def _faulted_routes(side, kind):
    tenant = "t-fault"
    home = _home(side, tenant)
    fault = {"kill": side.Kill(3, home, until=14),
             "hang": side.Hang(3, home, until=14),
             "partition": side.Partition(3, home, until=14)}[kind]
    router, reps, tr, clock, sleeps = make_fleet(
        side, faults=[fault], per_try_timeout_s=1.0, default_deadline_s=3.0)
    out = []
    for i in range(10):
        out.append(_result(router.route(tenant, _body(tenant))))
        if i % 3 == 2:
            out.append(router.replica_set.probe_once())
        clock.advance(0.5)
    return (out, sleeps, tr.ordinal, list(router.replica_set.state_changes),
            _counters(router.registry, FLEET_COUNTERS),
            {r: rep.flight_trips for r, rep in reps.items()})


@pytest.mark.parametrize("kind", ["kill", "hang", "partition"])
def test_routes_under_fleet_faults_equal_jax(jax_side, kind):
    ours, theirs = _faulted_routes(PORT, kind), _faulted_routes(jax_side, kind)
    assert ours == theirs
    results = [r for r in ours[0] if isinstance(r, tuple)]
    assert all(r[0] == 200 for r in results)  # retries absorbed every fault
    assert any(r[2] > 1 for r in results)     # ... and some took a retry
    assert sum(ours[5].values()) == 0         # no replica crashed


def _slow_routes(side, hedge):
    """``SlowReplicaAt`` on the home replica: without hedging the home
    answers late; with hedging the backup answers first.  Real (small)
    waits — hedging is genuinely concurrent."""
    tenant = "t-slow"
    reg = side.Registry()
    reps = {f"r{i}": side.fleet.LoopbackReplica(f"r{i}") for i in range(3)}
    home = _home(side, tenant)
    tr = side.fleet.FakeTransport(
        reps, faults=[side.Slow(1, home, seconds=0.3)])
    rs = side.fleet.ReplicaSet(list(reps), tr, registry=reg)
    router = side.fleet.FleetRouter(
        list(reps), transport=tr, replica_set=rs, registry=reg, hedge=hedge,
        hedge_delay_s=0.02, per_try_timeout_s=5.0)
    try:
        res = router.route(tenant, _body(tenant))
    finally:
        router.shutdown()
    backup = router.order_for(tenant)[1]
    return (res.status, res.replica == (backup if hedge else home), res.attempts,
            res.hedged, res.outcome, _counters(reg, ("svgd_fleet_hedges_total",)))


@pytest.mark.parametrize("hedge", [False, True])
def test_slow_replica_and_hedging_equal_jax(jax_side, hedge):
    ours, theirs = _slow_routes(PORT, hedge), _slow_routes(jax_side, hedge)
    assert ours == theirs
    assert ours[:4] == (200, True, 1, hedge)


def _shed_passthrough(side):
    def predict(inputs, tenant, headers):
        raise side.fleet.Shed("queue full", retry_after_s=7.0)

    router, reps, tr, clock, sleeps = make_fleet(side, predict=predict)
    out = [_result(router.route("t0", _body("t0")))]
    # the shedding home is deprioritised for its Retry-After window
    tenant = "t-bp"
    home = router.order_for(tenant)[0]
    for rep in reps.values():
        rep._predict = lambda i, t, h: {"mean": [0.0] * len(i)}
    reps[home]._predict = predict
    out.append(_result(router.route(tenant, _body(tenant))))
    out.append(_result(router.route(tenant, _body(tenant))))
    clock.advance(8.0)
    reps[home]._predict = lambda i, t, h: {"mean": [1.0] * len(i)}
    out.append(_result(router.route(tenant, _body(tenant))))
    return out, sleeps, _counters(router.registry, FLEET_COUNTERS)


def test_429_shed_never_retried_equals_jax(jax_side):
    ours, theirs = _shed_passthrough(PORT), _shed_passthrough(jax_side)
    assert ours == theirs
    first = ours[0][0]
    assert first[0] == 429 and first[2] == 1 and first[3] == "shed"
    assert first[5]["Retry-After"] == "7" and first[6]["retry_after_s"] == 7.0
    assert ours[1] == []  # a shed burns no backoff sleep


def _deadline_paths(side):
    router, reps, tr, clock, sleeps = make_fleet(
        side, n=1, per_try_timeout_s=1.0, default_deadline_s=1.5)
    out = [_result(router.route("t0", _body("t0"), deadline_s=0.8))]
    hdrs = dict(reps["r0"].last_headers)
    assert len(hdrs.pop("x-fleet-trace")) == 16  # minted: random on each side
    out.append(hdrs)
    tr.hang("r0")
    out.append(_result(router.route("t0", _body("t0"))))
    out.append(_result(router.route("t0", _body("t0"), deadline_s=0.0)))
    return out, sleeps, _counters(router.registry, FLEET_COUNTERS)


def test_expired_deadline_504_equals_jax(jax_side):
    ours, theirs = _deadline_paths(PORT), _deadline_paths(jax_side)
    # the propagated budget is formatted from the clock: equal clocks, equal text
    assert ours == theirs
    out = ours[0]
    assert out[1]["x-fleet-deadline-s"] == "0.800" and out[1]["x-fleet-attempt"] == "0"
    assert out[2][0] == 504 and out[2][3] == "deadline"
    assert out[3][0] == 504 and out[3][2] == 0


def _downstream_504_and_5xx(side):
    class Deadline504:
        def handle(self, method, path, body, headers):
            if path == "/predict":
                return side.fleet.Reply(504, {}, b'{"error": "deadline"}')
            return side.fleet.Reply(200, {}, b'{"status": "ok"}')

    class Hinting503:
        def handle(self, method, path, body, headers):
            if path == "/predict":
                return side.fleet.Reply(503, {"Retry-After": "0.07"},
                                        b'{"error": "warming up"}')
            return side.fleet.Reply(200, {}, b'{"status": "ok"}')

    out = []
    for reps in ({"a": Deadline504(), "b": Deadline504()}, {"a": Hinting503()}):
        clock = ManualClock()
        sleeps = []

        def fake_sleep(s, sleeps=sleeps, clock=clock):
            sleeps.append(s)
            clock.advance(s)

        reg = side.Registry()
        tr = side.fleet.FakeTransport(reps, advance=clock.advance)
        rs = side.fleet.ReplicaSet(list(reps), tr, passive_fail_threshold=1,
                                   clock=clock, registry=reg)
        router = side.fleet.FleetRouter(
            list(reps), transport=tr, replica_set=rs, max_retries=2,
            backoff=side.Backoff(base_s=1.0, factor=2.0, max_s=10.0, jitter_frac=0.0),
            clock=clock, sleep=fake_sleep, registry=reg)
        out.append((_result(router.route("t0", _body("t0"))), sleeps,
                    list(rs.state_changes), _counters(reg, FLEET_COUNTERS)))
    # a crashing handler is a 500 that retries to the next replica
    calls = []

    def predict(inputs, tenant, headers):
        calls.append(tenant)
        if len(calls) == 1:
            raise RuntimeError("boom")
        return {"mean": [0.0] * len(inputs)}

    router, reps, tr, clock, sleeps = make_fleet(side, predict=predict)
    out.append((_result(router.route("t0", _body("t0"))), sleeps,
                {r: rep.flight_trips for r, rep in reps.items()}))
    return out


def test_downstream_504_and_5xx_retries_equal_jax(jax_side):
    ours, theirs = _downstream_504_and_5xx(PORT), _downstream_504_and_5xx(jax_side)
    assert ours == theirs
    assert ours[0][0][0] == 504 and ours[0][0][2] == 1 and ours[0][2] == []
    # one 503 opens the circuit (threshold 1): one hinted sleep, then no one
    assert ours[1][0][0] == 503 and ours[1][1] == [pytest.approx(0.07)]
    assert ours[2][0][0] == 200 and ours[2][0][2] == 2


def _all_out(side):
    router, reps, tr, clock, sleeps = make_fleet(side, fail_threshold=1)
    rs = router.replica_set
    out = [rs.probe_once()]  # every replica sighted healthy at t=0
    clock.advance(10.0)
    for r in reps:
        tr.kill(r)
    out.append(rs.probe_once())
    out.append(_result(router.route("t0", _body("t0"))))
    clock.advance(1.25)
    out.append(_result(router.route("t1", _body("t1"))))
    out.append(router.health())
    return out, sleeps, _counters(router.registry, FLEET_COUNTERS)


def test_all_candidates_out_503_equals_jax(jax_side):
    ours, theirs = _all_out(PORT), _all_out(jax_side)
    assert ours == theirs
    res = ours[0][2]
    assert res[0] == 503 and res[3] == "unroutable" and res[5]["Retry-After"] == "2"
    assert res[6]["last_known_healthy"]["age_s"] == 10.0
    assert ours[0][4]["status"] == "degraded"


def _acceptance(side):
    """JAX's kill-one acceptance: 3 replicas under steady load, kill one,
    nothing lost, detection within 2 sweeps, readmission after restart."""
    router, reps, tr, clock, _ = make_fleet(
        side, fail_threshold=2, passive_fail_threshold=3, open_cooldown_s=1.0)
    rs = router.replica_set
    tenants = [f"t{i}" for i in range(12)]
    results = []

    def burst():
        for t in tenants:
            results.append(_result(router.route(t, _body(t))))

    burst()
    victim = router.order_for(tenants[0])[0]
    tr.kill(victim)
    burst()
    for _ in range(2):
        clock.advance(0.05)
        rs.probe_once()
    burst()
    tr.restore(victim)
    clock.advance(rs.open_cooldown_s + 0.01)
    rs.probe_once()
    burst()
    results.append(_result(router.route(tenants[0], _body(tenants[0]))))
    return results, list(rs.state_changes), _counters(router.registry, FLEET_COUNTERS)


def test_kill_one_acceptance_equals_jax(jax_side):
    ours, theirs = _acceptance(PORT), _acceptance(jax_side)
    assert ours == theirs
    results, changes, counters = ours
    assert all(r[0] == 200 for r in results)
    assert results[-1][1] == changes[0][1]  # the tenant's home serves again
    assert dict(counters["svgd_fleet_misroutes_total"]) == {} or all(
        v == 0 for _, v in counters["svgd_fleet_misroutes_total"])


def test_scheduled_fleet_faults_drive_the_port_transport():
    """The ordinal-keyed fault windows of ``resilience/faults.py``."""
    clock = ManualClock()
    reps = {"a": tfleet.LoopbackReplica("a")}
    tr = tfleet.FakeTransport(
        reps, faults=[tres.ReplicaKillAt(2, "a", until=4),
                      tres.SlowReplicaAt(5, "a", seconds=0.5)],
        advance=clock.advance)
    assert tr.request("a", "GET", "/healthz").status == 200
    for _ in range(2):
        with pytest.raises(tfleet.ConnectError):
            tr.request("a", "GET", "/healthz")
    assert tr.request("a", "GET", "/healthz").status == 200
    assert tr.request("a", "GET", "/healthz").status == 200 and clock.t == 0.5
    with pytest.raises(tfleet.RequestTimeout):
        tfleet.FakeTransport(reps, faults=[tres.ReplicaHangAt(1, "a")],
                             advance=clock.advance).request("a", "GET", "/healthz",
                                                            timeout_s=2.0)


def test_validation_errors_match_jax(jax_side):
    for side in (PORT, jax_side):
        f = side.fleet
        with pytest.raises(ValueError, match="at least one replica"):
            f.ReplicaSet([], f.FakeTransport({}), registry=side.Registry())
        with pytest.raises(ValueError, match="thresholds"):
            f.ReplicaSet(["a"], f.FakeTransport({}), fail_threshold=0,
                         registry=side.Registry())
        with pytest.raises(ValueError, match="transport"):
            f.FleetRouter(["a"])
        with pytest.raises(ValueError, match="vnodes"):
            f._HashRing(["a"], vnodes=0)
        with pytest.raises(f.ConnectError, match="unknown replica"):
            f.FakeTransport({}).request("ghost", "GET", "/healthz")


# --------------------------------------------------------------------- #
# tracing: the route lane tree and the trace header


def _route_tree(side):
    router, reps, tr, clock, _ = make_fleet(side)
    tenant = "t-trace"
    tr.kill(router.order_for(tenant)[0])  # one retry into the tree
    tracer = side.trace.enable()
    try:
        router.route(tenant, _body(tenant), trace="feed0000deadbeef")
        events = [e for e in tracer.chrome_events() if e.get("ph") == "X"]
    finally:
        side.trace.disable()
    served_by = next(r for r in reps.values() if r.requests)
    return ([(e["name"], e["args"]) for e in events],
            served_by.last_headers.get("x-fleet-trace"))


def test_route_lane_tree_equals_jax(jax_side):
    ours, theirs = _route_tree(PORT), _route_tree(jax_side)
    assert ours == theirs
    names = [n for n, _ in ours[0]]
    assert names.count("fleet.attempt") == 2 and "fleet.route" in names
    assert ours[1] == "feed0000deadbeef"


def test_minted_trace_ids_propagate_per_request():
    router, reps, tr, clock, _ = make_fleet(PORT)
    tenant = "t-hdr"
    home = router.order_for(tenant)[0]
    router.route(tenant, _body(tenant))
    minted = reps[home].last_headers["x-fleet-trace"]
    router.route(tenant, _body(tenant))
    assert len(minted) == 16 and reps[home].last_headers["x-fleet-trace"] != minted


def test_loopback_replica_traces_its_serve_tree():
    tracer = ttrace.Tracer(registry=tmetrics.MetricsRegistry())
    rep = tfleet.LoopbackReplica("r0", tracer=tracer)
    reply = rep.handle("POST", "/predict", _body("t0", rows=3),
                       {"X-Fleet-Trace": "abc", "X-Fleet-Attempt": "1"})
    assert reply.status == 200 and reply.json()["replica"] == "r0"
    events = [e for e in tracer.chrome_events() if e.get("ph") == "X"]
    req = next(e for e in events if e["name"] == "serve.request")
    assert req["args"] == {"rows": 3, "replica": "r0", "tenant": "t0",
                           "trace": "abc", "attempt": "1"}
    assert tracer.process_meta()["role"] == "replica"


# --------------------------------------------------------------------- #
# metrics federation


def _load(side, reg, n, latency_s, tenant):
    c = reg.counter("svgd_serve_requests_total", "requests fully resolved")
    h = reg.histogram("svgd_serve_request_latency_seconds",
                      "request end-to-end latency (enqueue to resolve)")
    g = reg.gauge("svgd_serve_queue_depth_rows", "depth")
    u = reg.counter("svgd_usage_rows_total", "rows served")
    d = reg.counter("svgd_usage_device_seconds_total", "device seconds")
    s = reg.counter("svgd_slo_breaches_total", "replica-local verdicts")
    for _ in range(n):
        c.inc(tenant=tenant)
        h.observe(latency_s, tenant=tenant)
        u.inc(4, tenant=tenant)
        d.inc(latency_s, tenant=tenant)
    g.set(n, batcher="b0")
    s.inc(slo="latency")


def _federation(side):
    regs = {"r0": side.Registry(), "r1": side.Registry()}
    reps = {r: side.fleet.LoopbackReplica(r, registry=reg) for r, reg in regs.items()}
    tr = side.fleet.FakeTransport(reps)
    clock = ManualClock()
    rs = side.fleet.ReplicaSet(list(reps), tr, clock=clock, registry=side.Registry())
    fed = side.fleet.MetricsFederation(rs, tr, registry=rs.registry, clock=clock)
    dumps, sweeps = [], []

    def sweep():
        out = fed.scrape_once()
        sweeps.append((out["scraped"], out["skipped"], sorted(out["errors"])))
        dumps.append(fed.fleet_registry.dump())

    _load(side, regs["r0"], 9, 0.004, "t0")
    _load(side, regs["r1"], 5, 0.030, "t1")
    sweep()
    _load(side, regs["r0"], 3, 0.2, "t1")
    sweep()
    # r1 restarts: a fresh registry with fewer requests — the reset clamps
    regs["r1"] = side.Registry()
    _load(side, regs["r1"], 2, 0.004, "t1")
    tr.set_replica("r1", side.fleet.LoopbackReplica("r1", registry=regs["r1"]))
    sweep()
    _load(side, regs["r1"], 4, 0.004, "t1")
    sweep()
    # an unreachable replica still believed healthy: its scrape fails,
    # counted, and its prior contribution stands
    tr.kill("r0")
    sweep()
    stats = fed.stats()
    stats.pop("last_scrape_ms")
    return dumps, sweeps, fed.monotone, stats


def test_federated_registry_equals_jax(jax_side):
    ours, theirs = _federation(PORT), _federation(jax_side)
    assert ours == theirs
    dumps, sweeps, monotone, stats = ours
    assert monotone and stats["scrape_errors"] == {"r0": 1}
    assert sweeps[-1] == (["r1"], [], ["r0"])
    series = dumps[-1]["metrics"]["svgd_serve_requests_total"]["series"]
    rollup = {s["labels"].get("tenant"): s["value"] for s in series
              if "replica" not in s["labels"]}
    # 9 + 3 from r0, 5 + 4 from r1's two lifetimes (the reset clamps to 0)
    assert rollup == {"t0": 9, "t1": 3 + 5 + 4}
    slo_series = dumps[-1]["metrics"]["svgd_slo_breaches_total"]["series"]
    assert all("replica" in s["labels"] for s in slo_series)


def test_a_rejected_dump_leaves_the_window_unconsumed(jax_side):
    def run(side):
        reg = side.Registry()
        _load(side, reg, 5, 0.004, "t0")

        class Flaky:
            poison = False

            def handle(self, method, path, body, headers):
                if path == "/metrics.dump" and self.poison:
                    return side.fleet._json_reply(200, {"metrics": {
                        "svgd_serve_requests_total": {"kind": "zebra",
                                                      "series": []}}})
                if path == "/metrics.dump":
                    return side.fleet._json_reply(200, reg.dump())
                return side.fleet._json_reply(200, {"status": "ok"})

        rep = Flaky()
        tr = side.fleet.FakeTransport({"r0": rep})
        rs = side.fleet.ReplicaSet(["r0"], tr, registry=side.Registry())
        fed = side.fleet.MetricsFederation(rs, tr, registry=rs.registry)
        c = fed.fleet_registry.counter("svgd_serve_requests_total")
        fed.scrape_once()
        vals = [c.value(tenant="t0")]
        reg.counter("svgd_serve_requests_total").inc(3, tenant="t0")
        rep.poison = True
        vals.append(sorted(fed.scrape_once()["errors"]))
        vals.append(c.value(tenant="t0"))
        rep.poison = False
        fed.scrape_once()
        vals.append(c.value(tenant="t0"))
        return vals, fed.monotone

    assert run(PORT) == run(jax_side) == ([5, ["r0"], 5, 8], True)


def _keys(doc):
    """The nested key structure of a JSON document (values dropped)."""
    if isinstance(doc, dict):
        return {k: _keys(v) for k, v in doc.items()}
    if isinstance(doc, list):
        return [_keys(v) for v in doc[:1]]
    return type(doc).__name__ if doc is None else None


def _status_docs(side):
    regs = {f"r{i}": side.Registry() for i in range(3)}
    for i, reg in enumerate(regs.values()):
        _load(side, reg, 3 + i, 0.004 * (i + 1), f"t{i % 2}")
    reps = {r: side.fleet.LoopbackReplica(r, registry=reg) for r, reg in regs.items()}
    tr = side.fleet.FakeTransport(reps)
    reg = side.Registry()
    rs = side.fleet.ReplicaSet(list(reps), tr, registry=reg)
    router = side.fleet.FleetRouter(list(reps), transport=tr, replica_set=rs,
                                    registry=reg, probe_interval_s=5.0, port=0)
    router.start()
    try:
        router.route("t0", _body("t0"))
        docs = {}
        for path in ("/fleet", "/usage", "/healthz", "/replicas", "/slo"):
            with urllib.request.urlopen(router.url + path, timeout=10) as r:
                docs[path] = json.loads(r.read())
        with urllib.request.urlopen(router.url + "/metrics", timeout=10) as r:
            text = r.read().decode()
    finally:
        router.shutdown()
    return docs, text


def test_fleet_and_usage_documents_keys_equal_jax(jax_side):
    (ours, text_o), (theirs, text_t) = _status_docs(PORT), _status_docs(jax_side)
    for path in ours:
        assert _keys(ours[path]) == _keys(theirs[path]), path
    assert set(ours["/fleet"]["tenants"]) == {"t0", "t1"}
    assert ours["/fleet"]["replicas_closed"] == 3
    assert ours["/usage"]["metering"] is True
    for doc in (ours, theirs):
        assert doc["/fleet"]["tenants"]["t1"]["usage_rows_total"] == 4 * (4 + 0)
    assert "svgd_fleet_requests_total" in text_o and "svgd_fleet_requests_total" in text_t
    assert 'replica="r0"' in text_o


# --------------------------------------------------------------------- #
# serving a real ensemble through the router


def _engines(rng):
    from dist_svgd_tpu.serving import PredictiveEngine as JEngine

    parts = rng.normal(size=(32, 5)).astype(np.float32)
    ours = PredictiveEngine("logreg", parts, device="cpu", min_bucket=4, max_bucket=64)
    theirs = JEngine("logreg", parts, min_bucket=4, max_bucket=64)
    return ours, theirs


def _engine_predict(engine):
    def predict(inputs, tenant, headers):
        out = engine.predict(np.asarray(inputs, dtype=np.float32))
        return {k: np.asarray(v).tolist() for k, v in out.items()}

    return predict


def test_loopback_engine_serves_through_the_router_bitwise():
    rng = np.random.default_rng(11)
    ours, theirs = _engines(rng)
    x = rng.normal(size=(9, 4)).astype(np.float32)
    reg = tmetrics.MetricsRegistry()
    reps = {f"r{i}": tfleet.LoopbackReplica(f"r{i}", predict_fn=_engine_predict(ours),
                                            registry=tmetrics.MetricsRegistry())
            for i in range(3)}
    tr = tfleet.FakeTransport(reps)
    router = tfleet.FleetRouter(list(reps), transport=tr,
                                replica_set=tfleet.ReplicaSet(list(reps), tr, registry=reg),
                                registry=reg)
    served = {}
    for tenant in ("a", "b", "c", "d"):
        res = router.route(tenant, json.dumps({"inputs": x.tolist(),
                                               "tenant": tenant}).encode())
        assert res.status == 200
        served[res.replica] = res.json()["outputs"]
    direct = ours.predict(x)
    want = theirs.predict(x)
    for outputs in served.values():
        assert set(outputs) == set(direct)
        for k, v in outputs.items():
            got = np.asarray(v, dtype=np.float32)
            np.testing.assert_array_equal(got, np.asarray(direct[k]))
            ref = np.asarray(want[k])
            np.testing.assert_allclose(got, ref, rtol=F32_RTOL,
                                       atol=F32_RTOL * float(np.max(np.abs(ref))))


def test_http_transport_over_port_servers_partition_and_heal():
    rng = np.random.default_rng(12)
    engine, _ = _engines(rng)
    x = rng.normal(size=(5, 4)).astype(np.float32)
    servers = {f"r{i}": PredictionServer(engine, port=0, max_wait_ms=0.5).start()
               for i in range(3)}
    try:
        addresses = {}
        for rid, srv in servers.items():
            host, port = srv.url.rsplit("/", 1)[-1].split(":")
            addresses[rid] = (host, int(port))
        tr = tfleet.HttpTransport(addresses)
        reg = tmetrics.MetricsRegistry()
        rs = tfleet.ReplicaSet(list(servers), tr, fail_threshold=1,
                               open_cooldown_s=0.05, registry=reg)
        router = tfleet.FleetRouter(list(servers), transport=tr, replica_set=rs,
                                    registry=reg,
                                    backoff=tres.Backoff(base_s=0.001, max_s=0.002))
        body = json.dumps({"inputs": x.tolist()}).encode()
        tenant = "t-http"
        home = router.order_for(tenant)[0]
        res = router.route(tenant, body)
        assert res.status == 200 and res.replica == home
        np.testing.assert_array_equal(
            np.asarray(res.json()["outputs"]["mean"], dtype=np.float32),
            engine.predict(x)["mean"])
        # the router-side cut: the home is unreachable through the router,
        # alive on a direct probe, ejected by one sweep, and failed over
        tr.partition(home)
        with pytest.raises(tfleet.ConnectError, match="partitioned"):
            tr.request(home, "GET", "/healthz")
        assert tfleet.HttpTransport(addresses).request(home, "GET", "/healthz").status == 200
        assert rs.probe_once()[home] == "open"
        res = router.route(tenant, body)
        assert res.status == 200 and res.replica != home and res.attempts == 1
        tr.heal(home)
        time.sleep(0.06)
        assert rs.probe_once()[home] == "closed"
        assert router.route(tenant, body).replica == home
        # the replicas' own /metrics.dump federates over the sockets
        sweep = router.federation.scrape_once()
        assert sweep["scraped"] == sorted(servers) and not sweep["errors"]
        fed = router.federation.fleet_registry
        assert fed.get("svgd_http_requests_total") is not None
        with pytest.raises(tfleet.ConnectError, match="unknown replica"):
            tr.request("ghost", "GET", "/healthz")
    finally:
        for srv in servers.values():
            srv.shutdown()
    # a stopped replica refuses connections: a ConnectError, retryable
    with pytest.raises(tfleet.ConnectError):
        tr.request(home, "GET", "/healthz", timeout_s=1.0)


def test_draining_port_server_is_ejected_in_one_sweep():
    rng = np.random.default_rng(13)
    engine, _ = _engines(rng)
    srv = PredictionServer(engine, port=0).start()
    try:
        host, port = srv.url.rsplit("/", 1)[-1].split(":")
        tr = tfleet.HttpTransport({"r0": (host, int(port))})
        rs = tfleet.ReplicaSet(["r0"], tr, fail_threshold=3,
                               registry=tmetrics.MetricsRegistry())
        assert rs.probe_once() == {"r0": "closed"}
        srv.begin_drain()
        assert rs.probe_once() == {"r0": "open"}
        assert list(rs.state_changes)[-1][4] == "draining"
    finally:
        srv.shutdown()


# --------------------------------------------------------------------- #
# the HTTP front door (real sockets, fake backend)


def _get(url, path):
    with urllib.request.urlopen(url + path, timeout=10) as r:
        return json.loads(r.read()), r.status


def test_router_http_front_door():
    reg = tmetrics.MetricsRegistry()
    reps = {f"r{i}": tfleet.LoopbackReplica(f"r{i}") for i in range(3)}
    tr = tfleet.FakeTransport(reps)
    rs = tfleet.ReplicaSet(list(reps), tr, probe_interval_s=0.05, registry=reg)
    with tfleet.FleetRouter(list(reps), transport=tr, replica_set=rs,
                            registry=reg, port=0) as router:
        assert router._httpd.request_queue_size == 1024
        req = urllib.request.Request(
            router.url + "/predict", _body("web-tenant"),
            {"Content-Type": "application/json", "X-Fleet-Trace": "0123456789abcdef"})
        with urllib.request.urlopen(req, timeout=10) as r:
            doc = json.loads(r.read())
        assert r.status == 200 and "outputs" in doc
        assert reps[doc["replica"]].last_headers["x-fleet-trace"] == "0123456789abcdef"
        health, code = _get(router.url, "/healthz")
        assert code == 200 and health["replicas_closed"] == 3
        assert health["role"] == "fleet-router"
        stats, _ = _get(router.url, "/replicas")
        assert set(stats) == set(reps)
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(router.url + "/nope", timeout=10)
        assert ei.value.code == 404


def test_router_http_failover_and_shed_passthrough():
    reg = tmetrics.MetricsRegistry()
    reps = {f"r{i}": tfleet.LoopbackReplica(f"r{i}") for i in range(2)}
    tr = tfleet.FakeTransport(reps)
    rs = tfleet.ReplicaSet(list(reps), tr, registry=reg)
    with tfleet.FleetRouter(list(reps), transport=tr, replica_set=rs, registry=reg,
                            backoff=tres.Backoff(base_s=0.001, max_s=0.002),
                            port=0) as router:
        tenant = "shedder"
        home = router.order_for(tenant)[0]
        tr.kill(home)
        req = urllib.request.Request(router.url + "/predict", _body(tenant),
                                     {"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=10) as r:
            assert r.status == 200
        tr.restore(home)

        def shed(i, t, h):
            raise tfleet.Shed("full", retry_after_s=3.0)

        reps[home]._predict = shed
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(urllib.request.Request(
                router.url + "/predict", _body(tenant),
                {"Content-Type": "application/json"}), timeout=10)
        assert ei.value.code == 429
        assert int(ei.value.headers["Retry-After"]) == 3


def test_front_door_holds_a_burst_of_concurrent_connections():
    """64 clients at once: the front door's backlog of 1024 accepts them
    all (the standard library's 5 resets connections under such a burst)."""
    reg = tmetrics.MetricsRegistry()
    reps = {f"r{i}": tfleet.LoopbackReplica(f"r{i}") for i in range(2)}
    tr = tfleet.FakeTransport(reps)
    rs = tfleet.ReplicaSet(list(reps), tr, registry=reg)
    statuses = []
    lock = threading.Lock()
    with tfleet.FleetRouter(list(reps), transport=tr, replica_set=rs, registry=reg,
                            port=0) as router:
        def client(i):
            req = urllib.request.Request(router.url + "/predict", _body(f"t{i % 8}"),
                                         {"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=20) as r:
                with lock:
                    statuses.append(r.status)

        threads = [threading.Thread(target=client, args=(i,)) for i in range(64)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
    assert statuses == [200] * 64


# --------------------------------------------------------------------- #
# persistent connections: HttpTransport's pool over port PredictionServers
# (and the front door), on real sockets

#: A keep-alive stdlib server in a process of its own, killed under the
#: pool (stdlib only, so it starts in milliseconds): prints its port.
_KILLABLE_SERVER = """
import http.server
class H(http.server.BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    def do_GET(self):
        body = b'{"status": "ok"}'
        self.send_response(200)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)
    def log_message(self, *args):
        pass
srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), H)
print(srv.server_address[1], flush=True)
srv.serve_forever()
"""


def _port_engine(seed=14):
    rng = np.random.default_rng(seed)
    parts = rng.normal(size=(32, 5)).astype(np.float32)
    x = rng.normal(size=(5, 4)).astype(np.float32)
    engine = PredictiveEngine("logreg", parts, device="cpu", min_bucket=4, max_bucket=256)
    return engine, x, json.dumps({"inputs": x.tolist()}).encode()


def _address(srv):
    host, port = srv.address[:2]
    return host, int(port)


def _count_accepts(httpd):
    """One entry for each connection ``httpd`` accepts from now on."""
    accepted = []
    inner = httpd.process_request

    def process_request(request, client_address):
        accepted.append(client_address)
        inner(request, client_address)

    httpd.process_request = process_request
    return accepted


@pytest.fixture
def replicas():
    """``start(engine, gate=None)`` serves ``engine`` from a port
    ``PredictionServer`` (``gate()`` called first in every POST handler);
    returns it and its accepted-connection list.  Whatever a test left
    running is shut down after it."""
    made = []

    def start(engine, gate=None):
        srv = PredictionServer(engine, port=0, max_wait_ms=0.5)
        accepted = _count_accepts(srv._httpd)
        if gate is not None:
            base = srv._httpd.RequestHandlerClass

            class Gated(base):
                def do_POST(self):
                    gate()
                    super().do_POST()

            srv._httpd.RequestHandlerClass = Gated
        made.append(srv)
        return srv.start(), accepted

    yield start
    for srv in made:
        if srv._serve_thread is not None:
            srv.shutdown()


@pytest.fixture
def transports():
    """``make(addresses)`` builds an ``HttpTransport``; each is closed
    after the test."""
    made = []

    def make(addresses):
        made.append(tfleet.HttpTransport(addresses))
        return made[-1]

    yield make
    for tr in made:
        tr.close()


def _run_threads(target, n, timeout=30):
    threads = [threading.Thread(target=target, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=timeout)
    assert not any(t.is_alive() for t in threads)


def _mean(reply):
    return np.asarray(reply.json()["outputs"]["mean"], dtype=np.float32)


def test_http_transport_sequential_requests_ride_one_connection(replicas, transports):
    engine, x, body = _port_engine()
    srv, accepted = replicas(engine)
    tr = transports({"r0": _address(srv)})
    for _ in range(8):
        reply = tr.request("r0", "POST", "/predict", body=body)
        assert reply.status == 200
        np.testing.assert_array_equal(_mean(reply), engine.predict(x)["mean"])
    assert tr.request("r0", "GET", "/healthz").status == 200
    assert len(accepted) == 1
    assert tr.connections_opened == 1 and tr.requests == 9
    assert tr.idle_connections() == {"r0": 1}
    tr.close()
    assert tr.idle_connections() == {}


def test_http_transport_32_concurrent_requests_keep_at_most_the_idle_cap(replicas, transports):
    """All 32 sit in a server handler at once (a barrier), so each rides a
    connection of its own; the pool then keeps POOL_IDLE_MAX of them and
    the next requests reuse those.  The transport's counters and pool stay
    exact under a short switch interval."""
    engine, x, body = _port_engine()
    barrier = threading.Barrier(32)
    srv, accepted = replicas(engine, gate=lambda: barrier.wait(timeout=20))
    tr = transports({"r0": _address(srv)})
    means = [None] * 32

    def client(i):
        reply = tr.request("r0", "POST", "/predict", body=body, timeout_s=30)
        means[i] = _mean(reply) if reply.status == 200 else None

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)  # threads switch often: a lost pool update would show
    try:
        _run_threads(client, 32)
    finally:
        sys.setswitchinterval(interval)
    for m in means:
        np.testing.assert_array_equal(m, engine.predict(x)["mean"])
    assert tr.connections_opened == len(accepted) == 32
    assert tr.idle_connections() == {"r0": tfleet.POOL_IDLE_MAX}
    barrier = threading.Barrier(1)  # noqa: F841 (the gate's closure reads it)
    for _ in range(4):
        assert tr.request("r0", "POST", "/predict", body=body).status == 200
    assert tr.connections_opened == len(accepted) == 32


def test_pooled_connection_ended_by_the_idle_timeout_is_retried_once(replicas, monkeypatch, transports):
    """The replica ends an idle connection after its handler's timeout; the
    next forward finds it dead before any response byte, retries once on a
    fresh connection inside the transport and serves: the breaker (opened
    by one failure here) records none."""
    monkeypatch.setattr(tfleet._KeepAliveHandler, "timeout", 0.2)
    engine, x, body = _port_engine()
    srv, accepted = replicas(engine)
    tr = transports({"r0": _address(srv)})
    rs = tfleet.ReplicaSet(["r0"], tr, passive_fail_threshold=1,
                           registry=tmetrics.MetricsRegistry())
    router = tfleet.FleetRouter(["r0"], transport=tr, replica_set=rs,
                                registry=tmetrics.MetricsRegistry())
    assert router.route("t", body).status == 200
    assert tr.idle_connections() == {"r0": 1}
    time.sleep(0.6)  # three idle timeouts: the replica has closed it
    res = router.route("t", body)
    assert res.status == 200 and res.attempts == 1
    np.testing.assert_array_equal(
        np.asarray(res.json()["outputs"]["mean"], dtype=np.float32), engine.predict(x)["mean"])
    st = rs.stats()["r0"]
    assert st["state"] == "closed" and st["request_failures"] == 0
    assert tr.connections_opened == len(accepted) == 2 and tr.requests == 2


def _one_failure_a_forward(router, rs, rid, method, path, body=None):
    for k in (1, 2):
        assert rs.begin_request(rid)
        with pytest.raises(tfleet.ConnectError):
            router._forward(rid, method, path, body, {}, 1.0)
        st = rs.stats()[rid]
        assert st["request_failures"] == k and st["inflight"] == 0


def test_replica_shut_down_under_the_pool_gives_connect_error(replicas, transports):
    engine, _, body = _port_engine()
    srv, _ = replicas(engine)
    tr = transports({"r0": _address(srv)})
    rs = tfleet.ReplicaSet(["r0"], tr, passive_fail_threshold=10,
                           registry=tmetrics.MetricsRegistry())
    router = tfleet.FleetRouter(["r0"], transport=tr, replica_set=rs,
                                registry=tmetrics.MetricsRegistry())
    assert router.route("t", body).status == 200
    assert tr.idle_connections() == {"r0": 1}
    srv.shutdown()
    _one_failure_a_forward(router, rs, "r0", "POST", "/predict", body)


def test_replica_killed_under_the_pool_gives_connect_error(transports):
    import subprocess

    proc = subprocess.Popen([sys.executable, "-I", "-S", "-c", _KILLABLE_SERVER],
                            stdout=subprocess.PIPE, text=True)
    try:
        port = int(proc.stdout.readline())
        tr = transports({"r0": ("127.0.0.1", port)})
        rs = tfleet.ReplicaSet(["r0"], tr, passive_fail_threshold=10,
                               registry=tmetrics.MetricsRegistry())
        router = tfleet.FleetRouter(["r0"], transport=tr, replica_set=rs,
                                    registry=tmetrics.MetricsRegistry())
        for _ in range(3):
            assert tr.request("r0", "GET", "/healthz").status == 200
        assert tr.connections_opened == 1 and tr.idle_connections() == {"r0": 1}
    finally:
        proc.kill()
        proc.wait(timeout=10)
        proc.stdout.close()
    _one_failure_a_forward(router, rs, "r0", "GET", "/healthz")


def test_partition_and_heal_with_pooled_connections_open(replicas, transports):
    """A partition closes the replica's idle connections and bars it before
    the pool; a connection in flight across the cut is closed after its
    reply, not pooled; the heal reconnects."""
    engine, _, body = _port_engine()
    held = {"on": False}
    entered, release = threading.Event(), threading.Event()

    def gate():
        if held["on"]:
            entered.set()
            release.wait(timeout=10)

    srv, accepted = replicas(engine, gate=gate)
    tr = transports({"r0": _address(srv)})
    for _ in range(2):
        assert tr.request("r0", "POST", "/predict", body=body).status == 200
    assert tr.idle_connections() == {"r0": 1}
    tr.partition("r0")
    assert tr.idle_connections() == {}
    with pytest.raises(tfleet.ConnectError, match="partitioned"):
        tr.request("r0", "POST", "/predict", body=body)
    tr.heal("r0")
    held["on"] = True
    statuses = []
    t = threading.Thread(target=lambda: statuses.append(
        tr.request("r0", "POST", "/predict", body=body, timeout_s=20).status))
    t.start()
    assert entered.wait(timeout=10)
    tr.partition("r0")
    release.set()
    t.join(timeout=20)
    assert statuses == [200] and tr.idle_connections() == {}
    held["on"] = False
    tr.heal("r0")
    assert tr.request("r0", "POST", "/predict", body=body).status == 200
    assert tr.connections_opened == len(accepted) == 3


def test_set_address_after_a_restart_never_reaches_the_old_process(replicas, transports):
    """A replica restarted on a new port: the old address's pool is dropped,
    and a request in flight to the old process when the address moves
    closes its connection after the reply."""
    engine, x, body = _port_engine()
    held = {"on": False}
    entered, release = threading.Event(), threading.Event()

    def gate():
        if held["on"]:
            entered.set()
            release.wait(timeout=10)

    old, old_accepted = replicas(engine, gate=gate)
    new, new_accepted = replicas(engine)
    tr = transports({"r0": _address(old)})
    assert tr.request("r0", "POST", "/predict", body=body).status == 200
    held["on"] = True
    replies = []
    t = threading.Thread(target=lambda: replies.append(
        tr.request("r0", "POST", "/predict", body=body, timeout_s=20)))
    t.start()
    assert entered.wait(timeout=10)
    tr.set_address("r0", *_address(new))
    release.set()
    t.join(timeout=20)
    assert replies[0].status == 200 and tr.idle_connections() == {}
    for _ in range(5):
        reply = tr.request("r0", "POST", "/predict", body=body)
        assert reply.status == 200
        np.testing.assert_array_equal(_mean(reply), engine.predict(x)["mean"])
    assert old.metrics()["http_requests"] == 2 and len(old_accepted) == 1
    assert new.metrics()["http_requests"] == 5 and len(new_accepted) == 1


def test_request_timeout_on_a_reused_connection_closes_it(replicas, transports):
    engine, _, body = _port_engine()
    slow = {"on": False}
    srv, accepted = replicas(engine, gate=lambda: time.sleep(1.0) if slow["on"] else None)
    tr = transports({"r0": _address(srv)})
    assert tr.request("r0", "POST", "/predict", body=body).status == 200
    slow["on"] = True
    with pytest.raises(tfleet.RequestTimeout):
        tr.request("r0", "POST", "/predict", body=body, timeout_s=0.2)
    assert tr.idle_connections() == {}
    slow["on"] = False
    assert tr.request("r0", "POST", "/predict", body=body).status == 200
    assert tr.connections_opened == len(accepted) == 2


def _front_door(door, replicas):
    """``(host, port, accepted, want_mean, close)`` of a replica server or
    a router front door over loopback replicas."""
    if door == "replica":
        engine, x, body = _port_engine()
        srv, accepted = replicas(engine)
        return (*_address(srv), accepted, body, engine.predict(x)["mean"], srv.shutdown)
    reps = {f"r{i}": tfleet.LoopbackReplica(f"r{i}") for i in range(2)}
    tr = tfleet.FakeTransport(reps)
    reg = tmetrics.MetricsRegistry()
    router = tfleet.FleetRouter(list(reps), transport=tr,
                                replica_set=tfleet.ReplicaSet(list(reps), tr, registry=reg),
                                registry=reg, port=0)
    accepted = _count_accepts(router._httpd)
    router.start()
    host, port = router._httpd.server_address[:2]
    return host, port, accepted, _body("web", rows=3), np.zeros(3, np.float32), router.shutdown


@pytest.mark.parametrize("door", ["replica", "router"])
def test_unknown_path_post_then_predict_on_one_connection(door, replicas):
    """The 404 for another path reads the body it does not use, so the
    next request on the connection parses from its own first byte."""
    import http.client

    host, port, accepted, body, want, close = _front_door(door, replicas)
    try:
        conn = http.client.HTTPConnection(host, port, timeout=10)
        headers = {"Content-Type": "application/json"}
        conn.request("POST", "/nope", body=body, headers=headers)
        resp = conn.getresponse()
        assert resp.status == 404 and "no route" in json.loads(resp.read())["error"]
        conn.request("POST", "/predict", body=body, headers=headers)
        resp = conn.getresponse()
        assert resp.status == 200
        mean = np.asarray(json.loads(resp.read())["outputs"]["mean"], dtype=np.float32)
        np.testing.assert_array_equal(mean, want)
        conn.close()
        assert len(accepted) == 1
    finally:
        close()


@pytest.mark.parametrize("door", ["replica", "router"])
def test_each_reply_is_one_write_on_a_nodelay_socket(door, replicas, monkeypatch):
    import http.client
    import socket
    import socketserver

    writes = []
    write = socketserver._SocketWriter.write

    def counted(self, data):
        writes.append(self._sock.getsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY))
        return write(self, data)

    monkeypatch.setattr(socketserver._SocketWriter, "write", counted)
    host, port, accepted, body, _, close = _front_door(door, replicas)
    try:
        conn = http.client.HTTPConnection(host, port, timeout=10)
        for method, path, data in (("GET", "/healthz", None), ("POST", "/predict", body),
                                   ("GET", "/metrics", None), ("GET", "/nope", None)):
            conn.request(method, path, body=data)
            resp = conn.getresponse()
            resp.read()
            assert not resp.will_close
        conn.close()
    finally:
        close()
    assert len(writes) == 4 and all(writes) and len(accepted) == 1


def test_shutdown_with_idle_pooled_connections_is_bounded_and_drains_first(replicas, transports):
    """Four idle pooled connections do not hold shutdown() to the idle
    timeout; /healthz, asked over a pooled connection after the drain flag
    and before the socket closes, reads 503 "draining" and closes that
    connection."""
    engine, _, body = _port_engine()
    barrier = threading.Barrier(4)
    srv, accepted = replicas(engine, gate=lambda: barrier.wait(timeout=20))
    tr = transports({"r0": _address(srv)})
    _run_threads(lambda i: tr.request("r0", "POST", "/predict", body=body, timeout_s=20), 4)
    assert tr.idle_connections() == {"r0": 4} and len(accepted) == 4
    seen = {}
    inner = srv._httpd.shutdown

    def spy():
        seen["reply"] = tr.request("r0", "GET", "/healthz", timeout_s=10)
        inner()

    srv._httpd.shutdown = spy
    t0 = time.monotonic()
    srv.shutdown()
    wall = time.monotonic() - t0
    reply = seen["reply"]
    assert reply.status == 503 and reply.json()["status"] == "draining"
    assert reply.headers["connection"] == "close"
    assert tr.idle_connections() == {"r0": 3} and len(accepted) == 4
    assert wall < tfleet.IDLE_TIMEOUT_S / 2


def test_router_shutdown_ends_idle_front_door_connections():
    import http.client

    reps = {f"r{i}": tfleet.LoopbackReplica(f"r{i}") for i in range(2)}
    tr = tfleet.FakeTransport(reps)
    reg = tmetrics.MetricsRegistry()
    router = tfleet.FleetRouter(list(reps), transport=tr,
                                replica_set=tfleet.ReplicaSet(list(reps), tr, registry=reg),
                                registry=reg, port=0).start()
    host, port = router._httpd.server_address[:2]
    conns = [http.client.HTTPConnection(host, port, timeout=10) for _ in range(3)]
    for conn in conns:
        conn.request("GET", "/healthz")
        resp = conn.getresponse()
        assert resp.status == 200 and not resp.will_close
        resp.read()
    t0 = time.monotonic()
    router.shutdown()
    assert time.monotonic() - t0 < tfleet.IDLE_TIMEOUT_S / 2
    for conn in conns:
        conn.close()
