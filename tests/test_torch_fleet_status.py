"""The port's fleet status tool (``dist_svgd_torch/tools/fleet_status.py``)
against JAX's (``tools/fleet_status.py``, loaded by path), on the CPU.

The same ``/fleet`` and ``/usage`` documents — written by hand to reach
every branch (no second poll, a bounced replica, a breaching SLO, no
usage metering, generations, scrape errors) and served live by a port
``FleetRouter`` — give equal ``derive_rates``, ``derive_replica_rates``,
``build_report`` and ``render`` outputs; the CLI reads a live port router
and exits 2 on an unreachable one, as JAX's does."""

import copy
import importlib.util
import json
import os

import pytest

from dist_svgd_torch.serving import fleet as tfleet
from dist_svgd_torch.telemetry.metrics import MetricsRegistry
from dist_svgd_torch.tools import fleet_status as tfs

from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def jfs():
    spec = importlib.util.spec_from_file_location(
        "jax_fleet_status", os.path.join(ROOT, "tools", "fleet_status.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _fleet_doc(requests, device_s, rows, *, closed=3, slo="ok", generation=None,
               errors=None, usage=True):
    replicas = {}
    for i in range(3):
        state = "closed" if i < closed else "open"
        replicas[f"r{i}"] = {
            "state": state, "reason": "" if state == "closed" else "probe_failures",
            "inflight": 0, "ejections": 0 if state == "closed" else 1,
            "probe_failures": 0, "request_failures": 0,
            "generation": generation, "last_healthy_age_s": 0.25 * i}
    tenants = {}
    for name, n in requests.items():
        row = {"requests": n, "p50_ms": 1.5 + n / 100, "p99_ms": 9.25 + n / 10,
               "requests_total": float(n)}
        if usage:
            row.update(device_seconds_total=device_s[name], usage_rows_total=rows[name])
        tenants[name] = row
    return {
        "status": "ok" if closed else "degraded", "role": "fleet-router",
        "replicas": replicas, "replicas_closed": closed, "replicas_total": 3,
        "ts": 1700000000.5,
        "federation": {"scrapes": 7, "skipped": 1, "last_scrape_ms": 1.234,
                       "monotone": True, "scrape_errors": errors or {}},
        "tenants": tenants,
        "slo": {"status": slo, "objectives": {
            "availability": {"status": slo, "burn_rate": 0.5},
            "latency_p99": {"status": "ok", "burn_rate": None}}},
    }


def _usage_doc(scale, replicas=("r0", "r1")):
    return {"metering": True, "tenants": {}, "totals": {},
            "replicas": {rid: {"t0": {"device_seconds": scale * (i + 1),
                                      "rows": int(100 * scale) * (i + 1)},
                               "t1": {"device_seconds": 0.5 * scale, "rows": 7}}
                         for i, rid in enumerate(replicas)}}


FIRST = _fleet_doc({"t0": 10, "t1": 4}, {"t0": 0.5, "t1": 0.1}, {"t0": 40, "t1": 4})
SECOND = _fleet_doc({"t0": 30, "t1": 4, "t2": 2}, {"t0": 1.25, "t1": 0.1, "t2": 0.01},
                    {"t0": 120, "t1": 4, "t2": 2}, generation=3)
#: a replica bounced between polls: its counters read lower the second time
BOUNCED = _fleet_doc({"t0": 8, "t1": 4}, {"t0": 0.25, "t1": 0.1}, {"t0": 20, "t1": 4},
                     closed=2, errors={"r2": 3.0})
BREACH = _fleet_doc({"t0": 12}, {"t0": 0.6}, {"t0": 48}, slo="breach")
NO_USAGE = _fleet_doc({"t0": 12}, {}, {}, usage=False)
DOWN = _fleet_doc({}, {}, {}, closed=0)

CASES = {
    "two_polls": (FIRST, SECOND, 2.0, _usage_doc(1.0), _usage_doc(2.5)),
    "single_poll": (FIRST, None, 0.0, _usage_doc(1.0), None),
    "bounced": (FIRST, BOUNCED, 1.0, _usage_doc(2.0), _usage_doc(1.0, ("r0", "r1", "r2"))),
    "breach": (FIRST, BREACH, 0.5, None, None),
    "no_usage": (NO_USAGE, NO_USAGE, 1.0, None, _usage_doc(1.0)),
    "all_out": (DOWN, DOWN, 1.0, {"metering": True, "replicas": {}}, {}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_derived_rates_equal_jax(jfs, case):
    first, second, interval, u1, u2 = copy.deepcopy(CASES[case])
    if second is not None:
        assert tfs.derive_rates(first, second, interval) == jfs.derive_rates(
            first, second, interval)
    assert tfs.derive_replica_rates(u1, u2, interval) == jfs.derive_replica_rates(
        u1, u2, interval)


@pytest.mark.parametrize("case", sorted(CASES))
def test_report_and_render_equal_jax(jfs, case):
    first, second, interval, u1, u2 = copy.deepcopy(CASES[case])
    ours = tfs.build_report(first, second, interval, usage_first=u1, usage_second=u2)
    theirs = jfs.build_report(first, second, interval, usage_first=u1, usage_second=u2)
    assert ours == theirs
    assert tfs.render(ours) == jfs.render(theirs)
    assert ours["metric"] == "fleet_status"


def test_verdicts_and_clamped_rates():
    rates = tfs.derive_rates(FIRST, BOUNCED, 1.0)
    assert rates["t0"]["rps"] == 0.0  # a reset clamps, never negative
    assert tfs.derive_rates(FIRST, SECOND, 2.0)["t0"]["rps"] == 10.0
    assert tfs.build_report(FIRST, SECOND, 2.0)["healthy"] is True
    assert tfs.build_report(FIRST, BREACH, 1.0)["healthy"] is False
    assert tfs.build_report(DOWN, None, 0.0)["healthy"] is False


def _http_router():
    regs = {f"r{i}": MetricsRegistry() for i in range(3)}
    reps = {r: tfleet.LoopbackReplica(r, registry=reg) for r, reg in regs.items()}
    tr = tfleet.FakeTransport(reps)
    reg = MetricsRegistry()
    rs = tfleet.ReplicaSet(list(reps), tr, registry=reg)
    router = tfleet.FleetRouter(list(reps), transport=tr, replica_set=rs, registry=reg,
                                probe_interval_s=5.0, port=0)
    return router.start()


def test_live_router_documents_report_like_jax(jfs):
    router = _http_router()
    try:
        for i in range(6):
            router.route(f"t{i % 2}", json.dumps(
                {"inputs": [[0.1, 0.2]], "tenant": f"t{i % 2}"}).encode())
        first, second, u1, u2 = tfs.collect(router.url, 0.05)
    finally:
        router.shutdown()
    ours = tfs.build_report(first, second, 0.05, usage_first=u1, usage_second=u2)
    theirs = jfs.build_report(first, second, 0.05, usage_first=u1, usage_second=u2)
    assert ours == theirs and tfs.render(ours) == jfs.render(theirs)
    assert ours["healthy"] is True
    assert set(ours["replicas"]) == {"r0", "r1", "r2"}
    assert {n: t["requests"] for n, t in ours["tenants"].items()} == {"t0": 3, "t1": 3}


def test_cli_against_a_live_port_router(capsys):
    router = _http_router()
    try:
        for _ in range(5):
            router.route("t0", json.dumps({"inputs": [[0.1, 0.2]], "tenant": "t0"}).encode())
        assert tfs.main(["--url", router.url, "--interval-s", "0.05", "--json"]) == 0
        out = json.loads(capsys.readouterr().out)
        assert out["healthy"] is True and out["metric"] == "fleet_status"
        assert out["replicas"]["r0"]["state"] == "closed"
        assert out["tenants"]["t0"]["requests"] == 5
        assert out["tenants"]["t0"]["rps"] is not None
        assert tfs.main(["--url", router.url, "--interval-s", "0"]) == 0
        assert "replicas closed" in capsys.readouterr().out
    finally:
        router.shutdown()


def test_cli_unreachable_exits_2_like_jax(jfs, capsys):
    argv = ["--url", "http://127.0.0.1:9", "--interval-s", "0", "--timeout-s", "0.2"]
    assert tfs.main(argv) == 2
    ours = capsys.readouterr().err
    assert jfs.main(argv) == 2
    assert ours == capsys.readouterr().err
    assert ours.count("\n") == 1 and "fleet_status:" in ours
