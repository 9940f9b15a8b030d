"""The trace core of the port's workload replay
(``dist_svgd_torch/tools/workload_replay.py``) against JAX's
``tools/workload_replay.py``, case for case with
``tests/test_workload_replay.py:35-143``, on the CPU.

The same config draws the same trace in both packages, event for event
(arrival times, sizes, tenants, pool picks); the replayer classifies the
same futures the same way; the window aggregates equal JAX's on the same
records; ``serve_bench.request_pool_by_size`` builds JAX's arrays.

The ``serve_storm`` half: ``storm_ok``, ``default_lanes_max``, the
two-tenant check and ``main --mode trace`` equal JAX's; with the capacity
probe patched to the same anchors, ``replay`` swapped for a recorder and
the settle pauses at 0, ``run_storm`` builds JAX's event list and row; the
port's tiny storm of ``tests/test_workload_replay.py:180-187`` runs end to
end.  The fleet transports: a flash crowd replayed through the port's
``FleetRouter`` sheds and loses nothing, as JAX's does; fleet statuses book
as JAX books them; ``main --mode replay --fleet N`` runs."""

import importlib.util
import json
import os
import sys
import time
from concurrent.futures import Future

import numpy as np
import pytest

from dist_svgd_torch.serving.batcher import Overloaded
from dist_svgd_torch.tools import serve_bench
from dist_svgd_torch.tools import workload_replay as wr

from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_tool(name):
    tools = os.path.join(ROOT, "tools")
    if tools not in sys.path:
        sys.path.insert(0, tools)
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", os.path.join(tools, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jwr():
    return _jax_tool("workload_replay")


CFG = dict(duration_s=5.0, base_rps=120.0, seed=3, bursts=((2.0, 1.0, 2.5),),
           tenants=("a", "b", "c"), flash_crowds=((2.0, 1.0, 2, 0.7),))


def _events(mod, **kw):
    return mod.generate_trace(mod.TraceConfig(**{**CFG, **kw}))


def _same(ours, theirs):
    return len(ours) == len(theirs) and all(
        (a.t, a.rows, a.tenant, a.pick) == (b.t, b.rows, b.tenant, b.pick)
        for a, b in zip(ours, theirs))


# --------------------------------------------------------------------- #
# trace model


@pytest.mark.parametrize("kw", [{}, {"seed": 4}, {"arrival": "regular"},
                                {"duration_s": 6.0, "base_rps": 200.0},
                                {"tenants": (), "flash_crowds": (), "diurnal_amp": 0.0}])
def test_trace_determinism_and_seed_sensitivity(jwr, kw):
    """Same config ⇒ the same trace as JAX's, event for event, and as
    itself on a second draw; a different seed ⇒ a different trace."""
    ours = _events(wr, **kw)
    assert _same(ours, _events(jwr, **kw))
    assert _same(ours, _events(wr, **kw))
    other = _events(wr, **{**kw, "seed": kw.get("seed", 3) + 10})
    assert not _same(ours, other)
    assert wr.TraceConfig(**{**CFG, **kw}).to_dict() == jwr.TraceConfig(
        **{**CFG, **kw}).to_dict()


def test_trace_shape_burst_flash_and_heavy_tail():
    events = _events(wr, duration_s=6.0, base_rps=200.0)
    pre = sum(1 for e in events if e.t < 2.0) / 2.0
    burst = sum(1 for e in events if 2.0 <= e.t < 3.0)
    assert burst > 1.6 * pre  # the 2.5x burst window is denser
    crowd = [e.tenant for e in events if 2.0 <= e.t < 3.0]
    assert crowd.count("c") / len(crowd) > 0.5  # flash mass shifted to c
    outside = [e.tenant for e in events if e.t < 2.0]
    assert outside.count("a") > outside.count("c")  # zipf rank order
    sizes = [e.rows for e in events]
    assert sizes.count(1) > sizes.count(32)  # power-law tail


def test_trace_regular_arrivals_and_rate_envelope(jwr):
    kw = dict(CFG, arrival="regular", tenants=(), flash_crowds=(), diurnal_amp=0.0)
    cfg, jcfg = wr.TraceConfig(**kw), jwr.TraceConfig(**kw)
    events = wr.generate_trace(cfg)
    assert abs(sum(1 for e in events if e.t < 2.0) - 240) <= 2
    for t in np.linspace(0.0, 5.0, 41):
        assert cfg.rate_at(t) == jcfg.rate_at(t)
    assert cfg.rate_at(2.5) == pytest.approx(300.0)
    assert cfg.rate_at(4.0) == pytest.approx(120.0)
    assert cfg.peak_rate() == jcfg.peak_rate() == pytest.approx(300.0)
    diurnal = dict(CFG, diurnal_amp=0.4, diurnal_period_s=2.0)
    assert [wr.TraceConfig(**diurnal).rate_at(t) for t in (0.3, 1.7, 2.4)] == [
        jwr.TraceConfig(**diurnal).rate_at(t) for t in (0.3, 1.7, 2.4)]


@pytest.mark.parametrize("kw", [
    {"duration_s": 0}, {"base_rps": -1.0}, {"arrival": "bursty"}, {"diurnal_amp": 1.0},
    {"rows_sizes": ()}, {"bursts": ((0.0, -1.0, 2.0),)},
    {"flash_crowds": ((0.0, 1.0, 0, 0.5),)},  # no tenants
    {"tenants": ("a",), "flash_crowds": ((0.0, 1.0, 3, 0.5),)},  # bad index
])
def test_trace_config_validation(jwr, kw):
    """The port refuses what JAX refuses, with JAX's message."""
    with pytest.raises(ValueError) as ours:
        wr.TraceConfig(**kw)
    with pytest.raises(ValueError) as theirs:
        jwr.TraceConfig(**kw)
    assert str(ours.value) == str(theirs.value)


# --------------------------------------------------------------------- #
# replay mechanics


def test_replay_classifies_ok_shed_error_lost(jwr):
    """Each package's replayer over its own ``Overloaded``: ok, shed,
    error and lost land where JAX's land."""
    from dist_svgd_tpu.serving.batcher import Overloaded as JOverloaded

    def statuses(mod, overloaded):
        events = [mod.ReplayEvent(0.001 * i, 1, None, i) for i in range(4)]

        def submit(ev):
            fut = Future()
            if ev.pick == 0:
                fut.set_result({"y": np.zeros((1, 1))})
            elif ev.pick == 1:
                raise overloaded("full")
            elif ev.pick == 2:
                fut.set_exception(RuntimeError("boom"))
            return fut  # pick == 3: never resolves -> lost

        return mod.replay(events, submit, drain_timeout_s=0.2)

    records = statuses(wr, Overloaded)
    theirs = statuses(jwr, JOverloaded)
    assert [r["status"] for r in records] == [r["status"] for r in theirs] == [
        "ok", "shed", "error", "lost"]
    assert records[0]["lat_ms"] >= 0.0
    assert records[1]["lat_ms"] is None
    assert records[2]["error"] == theirs[2]["error"] and "boom" in records[2]["error"]


def test_window_metrics_and_breach_and_recover(jwr):
    records = [
        {"t": 0.2, "rows": 1, "tenant": None, "status": "ok", "lat_ms": 5.0},
        {"t": 0.7, "rows": 1, "tenant": None, "status": "ok", "lat_ms": 8.0},
        {"t": 1.2, "rows": 1, "tenant": None, "status": "ok", "lat_ms": 90.0},
        {"t": 1.5, "rows": 2, "tenant": None, "status": "shed", "lat_ms": None},
        {"t": 2.5, "rows": 1, "tenant": None, "status": "shed", "lat_ms": None},
        {"t": 3.4, "rows": 1, "tenant": None, "status": "ok", "lat_ms": 6.0},
        {"t": 0.5, "rows": 1, "tenant": None, "status": "mirror", "lat_ms": 1.0},
    ]
    rng = np.random.default_rng(12)
    noisy = [{"t": float(t), "rows": 1, "tenant": None,
              "status": str(rng.choice(["ok", "ok", "ok", "shed", "error", "lost"])),
              "lat_ms": float(rng.exponential(20.0))} for t in rng.uniform(0, 6, 200)]
    for recs in (records, noisy):
        for t0, t1 in ((0.0, 4.0), (1.0, 3.0), (0.0, 6.0)):
            assert wr.window_metrics(recs, t0, t1, 25.0) == jwr.window_metrics(
                recs, t0, t1, 25.0)
        assert wr.p99_breach_seconds(recs, 25.0, 6.0) == jwr.p99_breach_seconds(
            recs, 25.0, 6.0)
        assert wr.time_to_recover(recs, 1.0, 25.0, 6.0) == jwr.time_to_recover(
            recs, 1.0, 25.0, 6.0)
    m = wr.window_metrics(records, 0.0, 4.0, good_ms=25.0)
    assert m["offered"] == 6 and m["completed"] == 4 and m["mirrors"] == 1
    assert m["good"] == 3 and m["shed"] == 2
    assert m["goodput_rps"] == pytest.approx(0.8)
    assert wr.p99_breach_seconds(records, 25.0, 4.0) == 2
    assert wr.time_to_recover(records, 1.0, 25.0, 4.0) == pytest.approx(2.0)
    bad = [dict(r, lat_ms=500.0) for r in records if r["status"] == "ok"]
    assert wr.time_to_recover(bad, 1.0, 25.0, 4.0) == pytest.approx(3.0)


# --------------------------------------------------------------------- #
# the request pools


def test_request_pool_by_size_equals_jax():
    jsb = _jax_tool("serve_bench")
    ours = serve_bench.request_pool_by_size(5, (4, 1, 4, 16), per_size=3, seed=7)
    theirs = jsb.request_pool_by_size(5, (4, 1, 4, 16), per_size=3, seed=7)
    assert list(ours) == list(theirs) == [1, 4, 16]
    for r in ours:
        for a, b in zip(ours[r], theirs[r]):
            np.testing.assert_array_equal(a, b)
            assert a.dtype == np.float32 and a.shape == (r, 5)


# --------------------------------------------------------------------- #
# the serve_storm half


# --------------------------------------------------------------------- #
# the fleet transports


def test_fleet_replay_flash_crowd_sheds_without_losses():
    """``tests/test_workload_replay.py``'s flash crowd through the port's
    ``FleetRouter`` (fake transport, bounded per-replica row budgets): the
    overload surfaces as fleet-level 429s booked ``shed`` — never lost or
    errored."""
    router, close = wr.build_fake_fleet(2, max_replica_rows=8, tenants=("t0", "t1"))
    cfg = wr.TraceConfig(duration_s=1.2, base_rps=150.0, seed=3,
                         bursts=((0.2, 0.6, 8.0),), rows_sizes=(4, 8),
                         tenants=("t0", "t1"))
    events = wr.generate_trace(cfg)
    pools = {r: [np.zeros((r, 4), dtype=np.float32)] for r in (4, 8)}
    transport = wr.make_router_submit(router)
    try:
        records = wr.replay(events, transport(pools))
    finally:
        transport.shutdown(wait=False)
        close()
    m = wr.window_metrics(records, 0.0, cfg.duration_s, good_ms=1000.0)
    assert m["offered"] > 50
    assert m["shed"] > 0
    assert m["lost"] == 0 and m["errors"] == 0
    assert m["completed"] + m["shed"] == m["offered"]


def test_router_submit_books_statuses_like_jax(jwr):
    """A fleet 429 books ``shed``, any other non-200 an error, a 200 its
    outputs — in both packages, over a router stub answering by pick."""
    from dist_svgd_tpu.serving.fleet import RouteResult as JRouteResult

    from dist_svgd_torch.serving.fleet import RouteResult

    def run(mod, result_cls):
        class Stub:
            def route(self, tenant, body):
                pick = json.loads(body)["inputs"][0][0]
                status = {0: 200, 1: 429, 2: 503, 3: 504}[int(pick)]
                payload = {"outputs": {"mean": [pick]}} if status == 200 else {}
                return result_cls(status, {}, json.dumps(payload).encode(),
                                  outcome="served" if status == 200 else "x")

        make = mod.make_router_submit(Stub(), max_workers=2)
        pools = {1: [np.full((1, 2), float(i), dtype=np.float32) for i in range(4)]}
        events = [mod.ReplayEvent(0.001 * i, 1, "t0", i) for i in range(4)]
        try:
            return mod.replay(events, make(pools), drain_timeout_s=5.0)
        finally:
            make.shutdown(wait=True)

    ours, theirs = run(wr, RouteResult), run(jwr, JRouteResult)
    assert [r["status"] for r in ours] == [r["status"] for r in theirs] == [
        "ok", "shed", "error", "error"]
    assert [r.get("error") for r in ours] == [r.get("error") for r in theirs]


def test_main_replay_through_a_fleet(capsys):
    assert wr.main(["--mode", "replay", "--fleet", "3", "--duration-s", "0.6",
                    "--base-rps", "80", "--n-features", "3", "--tenants", "4"]) == 0
    doc = json.loads(capsys.readouterr().out)
    assert doc["metric"] == "workload_replay"
    whole = doc["whole"]
    assert whole["offered"] > 0 and whole["lost"] == whole["errors"] == 0
    assert whole["completed"] + whole["shed"] == whole["offered"]


def _row(**kw):
    phases = {name: {"offered": 10, "completed": 7, "shed": 2, "errors": 1, "lost": 0}
              for name in ("steady", "burst_polite", "recover")}
    row = {"lost_requests": 0, "recompiles": 0, "sentry_compiles": 0,
           "arms": {"adaptive": {"phases": phases}}}
    row.update(kw)
    return row


LEAKY = {"adaptive": {"phases": {"steady": {"offered": 10, "completed": 7, "shed": 2,
                                            "errors": 0, "lost": 0}}}}


@pytest.mark.parametrize("row", [
    _row(), _row(sentry_compiles=None), _row(lost_requests=2), _row(recompiles=1),
    _row(sentry_compiles=3), _row(arms=LEAKY),
    _row(lost_requests=1, recompiles=2, sentry_compiles=4, arms=LEAKY), {},
], ids=["good", "unsupported_sentry", "lossy", "recompiling", "sentry", "leaking",
        "everything", "empty"])
def test_storm_ok_equals_jax(jwr, row):
    """The same verdict and reasons as JAX's; the sentry's reason names
    what the port's sentry counts (captures and kernel builds)."""
    ok, why = wr.storm_ok(row)
    jok, jwhy = jwr.storm_ok(row)
    assert ok == jok and len(why) == len(jwhy)
    for ours, theirs in zip(why, jwhy):
        if "sentried replay windows" in theirs:
            assert ours.split()[0] == theirs.split()[0]
            assert ours.endswith("inside the sentried replay windows")
            assert "capture" in ours and "kernel build" in ours
        else:
            assert ours == theirs


@pytest.mark.parametrize("cpus", [1, 2, 4, 8, 16, None])
def test_default_lanes_max_equals_jax(jwr, monkeypatch, cpus):
    monkeypatch.setattr(os, "cpu_count", lambda: cpus)
    assert wr.default_lanes_max() == jwr.default_lanes_max()
    assert 1 <= wr.default_lanes_max() <= 4


def test_run_storm_requires_two_tenants(jwr):
    with pytest.raises(ValueError) as ours:
        wr.run_storm(tenants=1, device="cpu")
    with pytest.raises(ValueError) as theirs:
        jwr.run_storm(tenants=1)
    assert str(ours.value) == str(theirs.value)


@pytest.mark.parametrize("argv", [
    ["--mode", "trace"],
    ["--mode", "trace", "--tenants", "5", "--seed", "3", "--duration-s", "6",
     "--base-rps", "80", "--rows", "1,4,16", "--rows-alpha", "0.8", "--burst-mult", "3"],
])
def test_main_trace_prints_jax_json(jwr, monkeypatch, capsys, argv):
    assert wr.main(argv) == 0
    ours = capsys.readouterr().out
    monkeypatch.setattr(sys, "argv", ["workload_replay.py", *argv])
    jwr.main()
    assert json.loads(ours) == json.loads(capsys.readouterr().out)


def test_main_replay_in_process(capsys):
    assert wr.main(["--mode", "replay", "--device", "cpu", "--duration-s", "0.6",
                    "--base-rps", "60", "--n-particles", "32", "--n-features", "3",
                    "--max-batch", "16", "--tenants", "0"]) == 0
    doc = json.loads(capsys.readouterr().out)
    assert doc["metric"] == "workload_replay"
    whole = doc["whole"]
    assert whole["offered"] > 0 and whole["lost"] == whole["errors"] == 0
    assert whole["completed"] + whole["shed"] == whole["offered"]


SETTLES = ("WARM_SETTLE_S", "PROBE_GAP_S", "PROBE_SETTLE_S", "ARM_SETTLE_S")
#: the tiny storm of tests/test_workload_replay.py:180-187
STORM_KW = dict(n_particles=256, n_features=8, seed=5, steady_s=1.2, burst_s=1.2,
                recover_s=1.2, max_batch=32, max_queue_rows=128, rows_sizes=(1, 2, 4),
                flash_rows_sizes=(8, 16), tenants=2, calib_requests=90, interval_s=0.1)


def _synthetic_records(events):
    """Records a replay could return, a pure function of the events: every
    status, latencies on both sides of the objective."""
    out = []
    for i, ev in enumerate(events):
        status = ("ok", "ok", "shed", "ok", "error", "ok", "lost")[i % 7]
        out.append({"t": ev.t, "rows": ev.rows, "tenant": ev.tenant, "status": status,
                    "lat_ms": float(i % 53) if status == "ok" else None})
    return out


@pytest.fixture(scope="module")
def storm_pair(jwr):
    """``run_storm`` of each package with the capacity probe patched to the
    same two anchors, ``replay`` swapped for a recorder returning the same
    synthetic records, and the settle sleeps made no-ops; returns each
    package's (row, events)."""
    import types

    mp = pytest.MonkeyPatch()
    out = {}
    try:
        for name, mod in (("port", wr), ("jax", jwr)):
            anchors = iter([1500.0, 9000.0])
            mp.setattr(mod, "_saturated_rows_capacity",
                       lambda *a, _it=anchors, **k: next(_it))
            seen = []

            def recorder(events, submit, _seen=seen, **kw):
                _seen.append([(e.t, e.rows, e.tenant, e.pick) for e in events])
                return _synthetic_records(events)

            mp.setattr(mod, "replay", recorder)
            if mod is wr:
                for k in SETTLES:
                    mp.setattr(wr, k, 0.0)
                row = wr.run_storm(device="cpu", **{**STORM_KW, "tenants": 3})
            else:
                mp.setattr(jwr, "time", types.SimpleNamespace(
                    sleep=lambda s: None, monotonic=time.monotonic,
                    perf_counter=time.perf_counter))
                row = jwr.run_storm(**{**STORM_KW, "tenants": 3})
            out[name] = (row, seen)
    finally:
        mp.undo()
    return out


def test_run_storm_events_and_row_equal_jax(storm_pair):
    """Both packages build the same merged steady + flash event list, arm
    for arm, and the same row bar the platform, the sentry's count (XLA
    compiles against captures and builds) and the controller block."""
    (row, seen), (jrow, jseen) = storm_pair["port"], storm_pair["jax"]
    assert len(seen) == len(jseen) == 3  # static_base, static_burst, adaptive
    assert seen == jseen
    assert all(arm == seen[0] for arm in seen)
    flash = [e for e in seen[0] if e[1] in (8, 16)]  # the steady sizes are 1, 2, 4
    assert flash and all(e[2] == "hog" and 1.2 <= e[0] < 2.4 for e in flash)
    assert row["platform"] == "cpu" and row["sentry_compiles"] == 0
    assert jrow["sentry_compiles"] in (0, None)

    def strip(r):
        r = {k: v for k, v in r.items() if k not in ("platform", "sentry_compiles")}
        r["arms"] = {name: {k: v for k, v in arm.items() if k != "controller"}
                     for name, arm in r["arms"].items()}
        return r

    assert strip(row) == strip(jrow)
    assert set(row["arms"]["adaptive"]["controller"]) == set(
        jrow["arms"]["adaptive"]["controller"])


def test_mini_storm_adaptive_arm_schema_and_gates(storm_pair, monkeypatch):
    """JAX's tiny adaptive-only storm on the port, end to end on the CPU
    with the settle pauses at 0 and the replay's pacing real: every
    admitted request resolves, no capture or build under the sentry, JAX's
    row schema (~4 s, inside the per-test wall budget)."""
    for k in SETTLES:
        monkeypatch.setattr(wr, k, 0.0)
    row = wr.run_storm(include_static=False, device="cpu", **STORM_KW)
    ok, why = wr.storm_ok(row)
    assert ok, why
    assert row["lost_requests"] == 0 and row["recompiles"] == 0
    assert row["sentry_compiles"] == 0
    assert row["ab"] is None
    jrow = storm_pair["jax"][0]
    assert set(row) == set(jrow)
    assert set(row["trace"]) == set(jrow["trace"])
    arm = row["arms"]["adaptive"]
    assert set(arm) == set(jrow["arms"]["adaptive"])
    assert set(arm["phases"]) == {"steady", "burst_polite", "recover"}
    assert set(arm["phases"]["steady"]) == set(jrow["arms"]["adaptive"]["phases"]["steady"])
    assert arm["adaptive"] is True and arm["controller"]["steps"] >= 1
    assert sum(p["offered"] for p in arm["phases"].values()) > 0
    assert row["trace"]["hog_burst_rps"] > 0
