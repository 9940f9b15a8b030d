"""The port's dispatch profiler (``telemetry/profile.py``), usage meter
(``telemetry/usage.py``) and the trace report's ``--programs`` view against
JAX's, case for case with ``tests/test_cost_attribution.py:60-405, 633``,
on the CPU: attribution of every ``Plan`` program's fenced dispatch, the
switchboards, the zero-alloc no-op, the fence-exactly-once contract with
``StepTimer.mark``, the usage ledger's partition identity (summaries equal
JAX's on the same records), the serving integration with both instruments
on and the capture sentry at 0, ``/usage``, and the top-programs table off
a metrics dump."""

import json
import urllib.request

import numpy as np
import pytest
import torch

from dist_svgd_torch.parallel.plan import Plan, capture_sentry
from dist_svgd_torch.telemetry import profile as profile_mod
from dist_svgd_torch.telemetry import trace as trace_mod
from dist_svgd_torch.telemetry import usage as usage_mod
from dist_svgd_torch.telemetry.metrics import MetricsRegistry
from dist_svgd_torch.tools import trace_report
from dist_svgd_torch.utils.metrics import StepTimer

from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)


@pytest.fixture
def rng():
    return np.random.default_rng(11)


@pytest.fixture(autouse=True)
def _switchboards_off():
    """Every test starts and ends with both switchboards (the port's and
    JAX's) disabled."""
    from dist_svgd_tpu.telemetry import profile as jprofile
    from dist_svgd_tpu.telemetry import usage as jusage

    for mod in (profile_mod, jprofile):
        mod.disable_profiler()
    for mod in (usage_mod, jusage):
        mod.disable_usage()
    yield
    for mod in (profile_mod, jprofile):
        mod.disable_profiler()
    for mod in (usage_mod, jusage):
        mod.disable_usage()


def _compiled_double(label="costtest.double"):
    return Plan(device="cpu").compile(lambda x: x * 2.0, label=label)


# --------------------------------------------------------------------- #
# dispatch profiler


def test_profiler_attributes_plan_dispatch(rng):
    reg = MetricsRegistry()
    fn = _compiled_double("costtest.attr")
    x = torch.from_numpy(rng.normal(size=(8, 3)).astype(np.float32))
    fn(x)
    profile_mod.enable_profiler(registry=reg)
    try:
        out = fn(x)
        assert profile_mod.fence(out) is out
    finally:
        profile_mod.disable_profiler()
    row = profile_mod.summary(reg)["costtest.attr"]
    assert row["dispatches"] == 1 and row["rows"] == 8 and row["bytes"] == 8 * 3 * 4
    assert row["seconds"] > 0.0
    assert profile_mod.attributed_seconds(reg, "costtest.") == pytest.approx(row["seconds"])
    assert profile_mod.attributed_seconds(reg, "other.") == 0.0


def test_profiler_sizes_and_summary_equal_jax(rng):
    """The same dispatches (f64 rows of two shapes, first-call sizing)
    through both profilers: rows, bytes, dispatches and the summary keys
    agree; both registries' metric names are JAX's."""
    import jax.numpy as jnp

    from dist_svgd_tpu.parallel.plan import Plan as JPlan
    from dist_svgd_tpu.telemetry import profile as jprofile
    from dist_svgd_tpu.telemetry.metrics import MetricsRegistry as JMetrics

    ours, theirs = MetricsRegistry(), JMetrics()
    fn = Plan(device="cpu").compile(lambda x: x.sum(1), label="cmp.sum")
    jfn = JPlan(None).compile(lambda x: x.sum(1), label="cmp.sum")
    xs = [rng.normal(size=(n, 5)) for n in (6, 6, 9)]
    profile_mod.enable_profiler(registry=ours)
    jprofile.enable_profiler(registry=theirs)
    try:
        for x in xs:
            fn(torch.from_numpy(x))
            jfn(jnp.asarray(x))
    finally:
        profile_mod.disable_profiler()
        jprofile.disable_profiler()
    a, b = profile_mod.summary(ours), jprofile.summary(theirs)
    assert set(a) == set(b) == {"cmp.sum"}
    assert set(a["cmp.sum"]) == set(b["cmp.sum"])
    for key in ("dispatches", "rows", "bytes"):
        assert a["cmp.sum"][key] == b["cmp.sum"][key], key
    assert set(ours.dump()["metrics"]) == set(theirs.dump()["metrics"]) >= {
        profile_mod.DISPATCH_SECONDS, profile_mod.DISPATCHES_TOTAL}
    assert profile_mod.__all__ == jprofile.__all__
    for name in ("DISPATCH_SECONDS", "DISPATCHES_TOTAL", "DISPATCH_ROWS_TOTAL",
                 "DISPATCH_BYTES_TOTAL"):
        assert getattr(profile_mod, name) == getattr(jprofile, name)


def test_profiler_disabled_is_passthrough():
    assert profile_mod.get_profiler() is None and not profile_mod.profiler_enabled()
    fn = _compiled_double("costtest.off")
    np.testing.assert_allclose(fn(torch.ones(4, 2)).numpy(), 2.0)
    reg = MetricsRegistry()
    profile_mod.enable_profiler(registry=reg)
    profile_mod.disable_profiler()
    assert "costtest.off" not in profile_mod.summary(reg)


def test_profiler_switchboard_idempotent():
    reg = MetricsRegistry()
    p1 = profile_mod.enable_profiler(registry=reg)
    assert profile_mod.enable_profiler() is p1 and profile_mod.profiler_enabled()
    assert profile_mod.disable_profiler() is p1
    assert profile_mod.disable_profiler() is None
    assert not profile_mod.profiler_enabled()


def test_profiler_epoch_rebinds_entry_cache():
    fn = _compiled_double("costtest.epoch")
    x = torch.ones(2, 2)
    reg1, reg2 = MetricsRegistry(), MetricsRegistry()
    profile_mod.enable_profiler(registry=reg1)
    fn(x)
    profile_mod.disable_profiler()
    profile_mod.enable_profiler(registry=reg2)
    fn(x)
    fn(x)
    profile_mod.disable_profiler()
    assert profile_mod.summary(reg1)["costtest.epoch"]["dispatches"] == 1
    assert profile_mod.summary(reg2)["costtest.epoch"]["dispatches"] == 2


def test_noop_measure_is_shared_and_zero_alloc():
    import tracemalloc

    assert profile_mod.measure("a") is profile_mod.measure("b")
    assert profile_mod.fence(None) is None

    def loop():
        for _ in range(200):
            with profile_mod.measure("hot"):
                pass
            profile_mod.fence(None)

    loop()
    tracemalloc.start()
    try:
        filters = [tracemalloc.Filter(True, profile_mod.__file__)]
        before = tracemalloc.take_snapshot().filter_traces(filters)
        loop()
        after = tracemalloc.take_snapshot().filter_traces(filters)
    finally:
        tracemalloc.stop()
    grown = sum(max(s.size_diff, 0) for s in after.compare_to(before, "lineno"))
    assert grown == 0, f"disabled profiler path allocated {grown} bytes"


def test_measure_context_records_host_span():
    reg = MetricsRegistry()
    profile_mod.enable_profiler(registry=reg)
    try:
        with profile_mod.measure("host.section"):
            pass
    finally:
        profile_mod.disable_profiler()
    assert profile_mod.summary(reg)["host.section"]["dispatches"] == 1


def test_fence_exactly_once_with_steptimer(rng, monkeypatch):
    """A spy on ``telemetry.trace.fence``: the profiler fences the dispatch,
    ``StepTimer.mark`` on the same value consumes the note (no second
    fence); without the profiler the timer fences itself."""
    calls = []
    real = trace_mod.fence
    monkeypatch.setattr(trace_mod, "fence", lambda v: calls.append(1) or real(v))
    fn = _compiled_double("costtest.fence")
    x = torch.from_numpy(rng.normal(size=(4, 2)).astype(np.float32))
    fn(x)
    profile_mod.enable_profiler(registry=MetricsRegistry())
    try:
        calls.clear()
        out = fn(x)
        assert len(calls) == 1  # the profiler's fence
        StepTimer().mark(out)
        assert len(calls) == 1  # note consumed: no second fence
        StepTimer().mark(out)
        assert len(calls) == 2  # the note was one-shot
    finally:
        profile_mod.disable_profiler()
    calls.clear()
    out = fn(x)
    assert calls == []  # disabled profiler: dispatch not fenced
    StepTimer().mark(out)
    assert len(calls) == 1  # the timer's own fence still happens


# --------------------------------------------------------------------- #
# usage meter


def _record_sequence(meter):
    meter.record_batch(tenant="acme", generation=None, rows=10, device_s=0.5,
                       queue_s=0.1, requests=2)
    meter.record_batch(tenant="acme", generation="gen-2", rows=6, device_s=0.25,
                       queue_s=0.0, requests=1)
    meter.record_batch(tenant="globex", generation=None, rows=4, device_s=0.125,
                       queue_s=0.05, requests=1)
    meter.record_batch(tenant=None, generation=None, rows=3, device_s=0.0625,
                       queue_s=0.0, requests=1)
    meter.record_compile(tenant="acme")


def test_usage_meter_partitions_totals():
    reg = MetricsRegistry()
    _record_sequence(usage_mod.UsageMeter(registry=reg))
    s = usage_mod.usage_summary(reg)
    acme = s["tenants"]["acme"]
    assert acme["device_seconds"] == pytest.approx(0.75)
    assert (acme["rows"], acme["requests"], acme["compiles"]) == (16, 3, 1)
    assert acme["generations"]["gen-2"]["rows"] == 6
    assert s["tenants"]["globex"]["device_seconds"] == pytest.approx(0.125)
    assert s["tenants"][usage_mod.DEFAULT_TENANT]["rows"] == 3
    total = sum(t["device_seconds"] for t in s["tenants"].values())
    assert total == pytest.approx(s["totals"]["device_seconds"])
    assert s["totals"]["device_seconds"] == pytest.approx(0.9375)
    assert s["replicas"] == {}


def test_usage_summary_equals_jax():
    """The same record sequence into both meters, plus replica-labelled
    series: the summaries are equal, and the module surfaces match."""
    from dist_svgd_tpu.telemetry import usage as jusage
    from dist_svgd_tpu.telemetry.metrics import MetricsRegistry as JMetrics

    ours, theirs = MetricsRegistry(), JMetrics()
    _record_sequence(usage_mod.UsageMeter(registry=ours))
    _record_sequence(jusage.UsageMeter(registry=theirs))
    for reg in (ours, theirs):
        ctr = reg.counter(usage_mod.DEVICE_SECONDS_TOTAL, "test")
        ctr.inc(0.75, tenant="acme", replica="r0")
        ctr.inc(0.25, tenant="acme", replica="r1")
    assert usage_mod.usage_summary(ours) == jusage.usage_summary(theirs)
    assert usage_mod.__all__ == jusage.__all__
    assert usage_mod.DEFAULT_TENANT == jusage.DEFAULT_TENANT


def test_usage_summary_replica_breakdown():
    reg = MetricsRegistry()
    ctr = reg.counter(usage_mod.DEVICE_SECONDS_TOTAL, "test")
    ctr.inc(1.0, tenant="acme")
    ctr.inc(0.75, tenant="acme", replica="r0")
    ctr.inc(0.25, tenant="acme", replica="r1")
    s = usage_mod.usage_summary(reg)
    assert s["totals"]["device_seconds"] == pytest.approx(1.0)
    assert s["replicas"]["r0"]["acme"]["device_seconds"] == pytest.approx(0.75)
    assert s["replicas"]["r1"]["acme"]["device_seconds"] == pytest.approx(0.25)


def test_usage_switchboard():
    reg = MetricsRegistry()
    assert usage_mod.get_meter() is None
    m1 = usage_mod.enable_usage(registry=reg)
    assert usage_mod.enable_usage() is m1 and usage_mod.usage_enabled()
    assert usage_mod.disable_usage() is m1
    assert usage_mod.get_meter() is None


# --------------------------------------------------------------------- #
# serving integration


def _tiny_serving(rng, registry, tenants=("acme", "globex")):
    from dist_svgd_torch.serving.batcher import MicroBatcher
    from dist_svgd_torch.serving.engine import PredictiveEngine

    engines = {t: PredictiveEngine("logreg", rng.normal(size=(32, 5)).astype(np.float32),
                                   min_bucket=8, max_bucket=8, registry=registry, tenant=t,
                                   device="cpu")
               for t in tenants}
    batcher = MicroBatcher(lambda x, tenant=None: engines[tenant].predict(x),
                           max_batch=8, max_wait_ms=0.5, registry=registry)
    return engines, batcher


def test_serving_meters_tenants_and_stays_compile_free(rng):
    reg = MetricsRegistry()
    engines, batcher = _tiny_serving(rng, reg)
    try:
        for eng in engines.values():
            eng.warmup()
        x = rng.normal(size=(4, 4)).astype(np.float32)
        batcher.submit(x, tenant="acme").result(timeout=10)
        usage_before = usage_mod.usage_summary(reg)
        profile_mod.enable_profiler(registry=reg)
        usage_mod.enable_usage(registry=reg)
        try:
            with capture_sentry("cost test window") as sentry:
                futs = [batcher.submit(x, tenant=t)
                        for _ in range(6) for t in ("acme", "globex")]
                for f in futs:
                    f.result(timeout=10)
        finally:
            profile_mod.disable_profiler()
            usage_mod.disable_usage()
        s = usage_mod.usage_summary(reg)
        for t in ("acme", "globex"):
            before = usage_before["tenants"].get(t, {})
            assert s["tenants"][t]["requests"] - before.get("requests", 0) == 6
            assert s["tenants"][t]["rows"] - before.get("rows", 0) == 24
            assert s["tenants"][t]["device_seconds"] > 0.0
            assert s["tenants"][t]["compiles"] == before.get("compiles", 0)
        prog = profile_mod.summary(reg, "serve.")
        assert sum(r["dispatches"] for r in prog.values()) > 0
        assert sum(r["rows"] for r in prog.values()) > 0
        assert sentry.compiles == 0
    finally:
        batcher.close()


def test_profiler_overhead_row_holds_each_round_and_the_gate():
    """serve_bench's profiler A/B on a small CPU engine: one rps per round
    and arm, JAX's best-of overhead and its spread, the instruments' added
    time a batch times the closed loop's batch rate, JAX's 3% gate applied
    to that, and both instruments switched off after."""
    from dist_svgd_torch.tools import serve_bench

    row = serve_bench.measure_profiler_overhead(
        rounds=2, dispatch_calls=20, requests=24, clients=2, n_particles=64,
        n_features=4, max_batch=16, device="cpu")
    assert row["metric"] == "profiler_overhead" and row["rounds"] == 2
    off, on = row["rps_disabled_rounds"], row["rps_enabled_rounds"]
    assert len(off) == len(on) == 2 and min(off + on) > 0
    assert (row["rps_disabled"], row["rps_enabled"]) == (max(off), max(on))
    assert row["overhead_frac"] == round(1 - max(on) / max(off), 4)
    assert 0 <= row["round_spread_frac"] < 1
    assert row["batches_per_s"] > 0
    frac = row["instrument_us_per_batch"] * 1e-6 * row["batches_per_s"]
    assert row["dispatch_overhead_frac"] == pytest.approx(frac, abs=1e-3)
    assert row["gate"] == 0.03
    assert row["within_gate"] == (row["dispatch_overhead_frac"] <= 0.03)
    assert row["usage_totals"]["requests"] == 24
    assert sum(p["dispatches"] for p in row["programs"].values()) > 0
    assert profile_mod._PROFILER is None and not usage_mod.usage_enabled()


def test_instrument_cost_times_both_instruments_on_the_dispatch_path(monkeypatch):
    """The direct half of the A/B: each round's 'on' block runs with the
    profiler and the meter enabled and the 'off' block with neither; the
    result is the median of the per-batch differences."""
    from dist_svgd_torch.tools import serve_bench

    seen = []
    real = serve_bench.MicroBatcher.submit

    def spy(self, x, *a, **kw):
        seen.append((profile_mod._PROFILER is not None, usage_mod.usage_enabled()))
        return real(self, x, *a, **kw)

    monkeypatch.setattr(serve_bench.MicroBatcher, "submit", spy)
    engine = serve_bench.build_engine(n_particles=32, n_features=3, max_bucket=8,
                                      device="cpu")
    cost = serve_bench._instrument_cost_s(engine, rounds=3, calls=4, rows=8)
    assert isinstance(cost, float)
    # a warm-up block, then three (off, on) pairs of four batches each
    assert seen == [(False, False)] * 4 + ([(False, False)] * 4 + [(True, True)] * 4) * 3
    assert profile_mod._PROFILER is None and not usage_mod.usage_enabled()


def test_engine_compile_miss_lands_in_ledger(rng):
    from dist_svgd_torch.serving.engine import PredictiveEngine

    reg = MetricsRegistry()
    eng = PredictiveEngine("logreg", rng.normal(size=(16, 4)).astype(np.float32),
                           min_bucket=4, max_bucket=4, registry=reg, tenant="cold",
                           device="cpu")
    usage_mod.enable_usage(registry=reg)
    try:
        eng.predict(rng.normal(size=(2, 3)).astype(np.float32))
        eng.stage_candidate(rng.normal(size=(16, 4)))
        eng.predict(rng.normal(size=(2, 3)).astype(np.float32), generation="candidate")
    finally:
        usage_mod.disable_usage()
    s = usage_mod.usage_summary(reg)["tenants"]["cold"]
    assert s["compiles"] >= 1
    assert s["generations"] == {}  # the staged candidate built at staging: no miss


def test_server_usage_route(rng):
    from dist_svgd_torch.serving import PredictionServer
    from dist_svgd_torch.serving.engine import PredictiveEngine

    eng = PredictiveEngine("logreg", rng.normal(size=(16, 4)).astype(np.float32),
                           min_bucket=4, max_bucket=8, tenant="acme", device="cpu")
    with PredictionServer(eng, port=0, max_batch=8, max_wait_ms=1.0) as srv:
        usage_mod.enable_usage(registry=srv.registry)
        try:
            body = json.dumps({"inputs": rng.normal(size=(2, 3)).tolist()}).encode()
            req = urllib.request.Request(f"{srv.url}/predict", data=body,
                                         headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=10) as resp:
                assert resp.status == 200
            with urllib.request.urlopen(f"{srv.url}/usage", timeout=10) as resp:
                doc = json.loads(resp.read())
        finally:
            usage_mod.disable_usage()
    assert doc["metering"] is True
    row = doc["tenants"][usage_mod.DEFAULT_TENANT]
    assert row["requests"] >= 1 and row["rows"] >= 2 and row["device_seconds"] > 0.0
    assert doc["tenants"]["acme"]["compiles"] >= 1


def test_model_registry_usage_reads_meter_registry():
    from dist_svgd_torch.serving.registry import ModelRegistry

    reg = MetricsRegistry()
    mr = ModelRegistry(metrics=MetricsRegistry())
    meter = usage_mod.enable_usage(registry=reg)
    try:
        meter.record_batch(tenant="acme", generation=None, rows=2, device_s=0.01,
                           queue_s=0.0, requests=1)
        doc = mr.usage()
        assert doc["metering"] is True and doc["tenants"]["acme"]["rows"] == 2
    finally:
        usage_mod.disable_usage()
    doc = mr.usage()
    assert doc["metering"] is False and doc["tenants"] == {}
    mr.close()


# --------------------------------------------------------------------- #
# the trace report's --programs view


def test_trace_report_programs_view(rng, tmp_path, capsys):
    """``--programs`` renders the top-programs table off a saved registry
    dump (and off a history directory's summed windows), with JAX's tool's
    rows for the same input."""
    import importlib.util
    import os

    reg = MetricsRegistry()
    fn = _compiled_double("serve.tiny")
    x = torch.from_numpy(rng.normal(size=(4, 3)).astype(np.float32))
    fn(x)
    profile_mod.enable_profiler(registry=reg)
    try:
        fn(x)
        fn(x)
    finally:
        profile_mod.disable_profiler()
    dump_path = str(tmp_path / "dump.json")
    with open(dump_path, "w") as fh:
        json.dump(reg.dump(), fh)
    report = trace_report.program_rows(trace_report.load_program_dumps(dump_path))
    (prog,) = report["programs"]
    assert prog["label"] == "serve.tiny" and prog["dispatches"] == 2 and prog["rows"] == 8
    assert prog["share"] == pytest.approx(1.0) and report["total_seconds"] > 0.0

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "jax_trace_report_programs", os.path.join(root, "tools", "trace_report.py"))
    jtr = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jtr)
    assert report == jtr.program_rows(jtr.load_program_dumps(dump_path))
    assert trace_report.render_programs(report) == jtr.render_programs(report)

    assert trace_report.main(["--programs", dump_path]) == 0
    assert "serve.tiny" in capsys.readouterr().out
    assert trace_report.main(["--programs", dump_path, "--json", "--top", "1"]) == 0
    assert json.loads(capsys.readouterr().out)["programs"][0]["label"] == "serve.tiny"
    not_dump = tmp_path / "t.json"
    not_dump.write_text('{"traceEvents": []}')
    assert trace_report.main(["--programs", str(not_dump)]) == 2
    assert trace_report.main(["--programs", str(tmp_path / "missing.json")]) == 2
    assert "ROADMAP A9" not in capsys.readouterr().err

    # history-directory input: the windows sum, as JAX's do
    from dist_svgd_torch.telemetry.history import HistoryRecorder

    hist_dir = str(tmp_path / "hist")
    HistoryRecorder(reg, hist_dir, clock=lambda: 0.0).record_once()
    report = trace_report.program_rows(trace_report.load_program_dumps(hist_dir))
    assert report["programs"][0]["dispatches"] == 2
    assert report == jtr.program_rows(jtr.load_program_dumps(hist_dir))
