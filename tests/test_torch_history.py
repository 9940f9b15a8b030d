"""The port's telemetry history (``dist_svgd_torch/telemetry/history.py``),
anomaly report (``tools/anomaly_report.py``) and cost drill
(``tools/cost_drill.py``) against JAX's, case for case with the history,
anomaly and cost-drill cases of ``tests/test_cost_attribution.py:408-600``,
on the CPU.

Rings are read across packages: a ring JAX's recorder writes is read by
the port's reader record for record (JSON-equal), and the reverse.  The
same call sequence on both registries writes JSON-equal records.  The
anomaly detector's verdicts and the CLI's exit codes equal JAX's on the
same fixture rings; the cost drill's row carries JAX's keys plus the port's
overhead gate, and ``row_ok`` gives JAX's verdicts on JAX's synthetic
rows."""

import importlib.util
import json
import os
import sys

import numpy as np
import pytest

from dist_svgd_torch.telemetry import profile as profile_mod
from dist_svgd_torch.telemetry import usage as usage_mod
from dist_svgd_torch.telemetry.history import (
    HISTORY_FORMAT,
    HistoryRecorder,
    TelemetryHistory,
    list_series,
    series_values,
)
from dist_svgd_torch.telemetry.metrics import MetricsRegistry
from dist_svgd_torch.tools import anomaly_report, cost_drill

from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_tool(name):
    """JAX's ``tools/<name>.py``, imported from its file (its siblings on
    the path, as the tool itself arranges)."""
    tools = os.path.join(ROOT, "tools")
    if tools not in sys.path:
        sys.path.insert(0, tools)
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", os.path.join(tools, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jhist():
    from dist_svgd_tpu.telemetry import history

    return history


@pytest.fixture(scope="module")
def janomaly():
    return _jax_tool("anomaly_report")


@pytest.fixture(autouse=True)
def _switchboards_off():
    """Both packages' profiler and usage meter off around every test."""
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


def _jax_registry():
    from dist_svgd_tpu.telemetry.metrics import MetricsRegistry as JRegistry

    return JRegistry()


# --------------------------------------------------------------------- #
# telemetry history ring


def test_history_ring_prunes_and_resumes_seq(tmp_path, jhist):
    """The ring prunes past capacity and re-seats after its survivors, as
    JAX's does; each package reads the other's ring, record for record."""
    root = str(tmp_path / "hist")
    hist = TelemetryHistory(root, capacity=3)
    for _ in range(5):
        hist.append({"format": HISTORY_FORMAT, "window": {}})
    assert HISTORY_FORMAT == jhist.HISTORY_FORMAT == "svgd-telemetry-history-1"
    assert len(hist) == 3
    seqs = [int(os.path.basename(p)[10:18]) for p in hist.paths()]
    assert seqs == [2, 3, 4]  # oldest pruned, numbering monotone
    hist2 = TelemetryHistory(root, capacity=3)
    path = hist2.append({"window": {}})
    assert os.path.basename(path) == "telemetry_00000005.json"
    assert [r["seq"] for r in hist2.records()] == [3, 4, 5]
    # cross-package: JAX reads the port's ring, and its append re-seats
    # after the port's survivors; the port then reads JAX's record
    jring = jhist.TelemetryHistory(root, capacity=3)
    assert jring.records() == hist2.records() and jring.paths() == hist2.paths()
    jring.append({"format": HISTORY_FORMAT, "window": {"x": 1}})
    back = TelemetryHistory(root, capacity=3).records()
    assert back == jring.records() and back[-1] == {
        "format": HISTORY_FORMAT, "window": {"x": 1}, "seq": 6}


def test_recorder_windows_and_reset_clamp(tmp_path, jhist):
    """record_once writes window DELTAS (first record cumulative with
    interval 0), inheriting dump_delta's counter reset-clamp; the same call
    sequence on both packages writes JSON-equal records, and each package's
    reader reads the other's ring equally."""
    docs = []
    for ours, (reg, Recorder) in enumerate(((_jax_registry(), jhist.HistoryRecorder),
                                            (MetricsRegistry(), HistoryRecorder))):
        ctr = reg.counter("svgd_test_total", "t")
        hist = reg.histogram("svgd_test_seconds", "t")
        gauge = reg.gauge("svgd_test_gauge", "t")
        clock = iter([100.0, 160.0, 220.0]).__next__
        root = str(tmp_path / f"h{ours}")
        rec = Recorder(reg, root, interval_s=60.0, clock=clock)
        ctr.inc(5, tenant="a")
        hist.observe(0.02)
        gauge.set(1.5)
        r0 = rec.record_once()
        assert r0["interval_s"] == 0.0
        ctr.inc(3, tenant="a")
        hist.observe(0.04)
        r1 = rec.record_once()
        assert r1["interval_s"] == pytest.approx(60.0)
        vals = series_values(rec.history.records(), "svgd_test_total",
                             labels={"tenant": "a"})
        assert vals == [5.0, 3.0]  # cumulative first, then the window delta
        reg._metrics["svgd_test_total"]._series.clear()  # a restart
        ctr.inc(1, tenant="a")
        r2 = rec.record_once()
        vals = series_values(rec.history.records(), "svgd_test_total",
                             labels={"tenant": "a"})
        assert vals[-1] == 0.0  # clamped to a zero window, never negative
        assert r2["interval_s"] == pytest.approx(60.0)
        docs.append((root, rec.history.records()))
    (jroot, jrecs), (troot, trecs) = docs
    assert json.loads(json.dumps(trecs)) == json.loads(json.dumps(jrecs))
    assert TelemetryHistory(jroot).records() == jrecs
    assert jhist.TelemetryHistory(troot).records() == trecs


def test_recorder_maybe_record_honours_interval(tmp_path, jhist):
    for Recorder in (HistoryRecorder, jhist.HistoryRecorder):
        reg = MetricsRegistry()
        rec = Recorder(reg, str(tmp_path / Recorder.__module__), interval_s=30.0,
                       clock=lambda: 0.0)
        assert [rec.maybe_record(now=t) is not None for t in (0.0, 10.0, 31.0, 40.0, 61.5)
                ] == [True, False, True, False, True]
        assert len(rec.history) == 3


def test_series_values_histogram_stats(tmp_path, jhist):
    """Per-window histogram stats (count, sum, mean, quantiles from the raw
    bucket counts) and the series listing equal JAX's on the same ring."""
    reg = MetricsRegistry()
    hist = reg.histogram("svgd_test_seconds", "t")
    rec = HistoryRecorder(reg, str(tmp_path / "h"), clock=lambda: 0.0)
    rng = np.random.default_rng(4)
    for window in range(3):
        for v in rng.exponential(0.02, size=5 + 3 * window):
            hist.observe(float(v), tenant="a")
        rec.record_once()
    records = rec.history.records()
    assert list_series(records) == jhist.list_series(records) == [
        ("svgd_test_seconds", "histogram", {"tenant": "a"})]
    for stat in ("count", "sum", "mean", "p50", "p95", "p99"):
        ours = series_values(records, "svgd_test_seconds", {"tenant": "a"}, stat=stat)
        theirs = jhist.series_values(records, "svgd_test_seconds", {"tenant": "a"},
                                     stat=stat)
        np.testing.assert_allclose(ours, theirs, rtol=1e-12, atol=0)
    # the first window is cumulative: its p99 is the live quantile then
    one = MetricsRegistry()
    h1 = one.histogram("svgd_test_seconds", "t")
    for v in (0.01, 0.01, 0.02, 0.04):
        h1.observe(v)
    rec1 = HistoryRecorder(one, str(tmp_path / "h1"), clock=lambda: 0.0)
    rec1.record_once()
    (p99,) = series_values(rec1.history.records(), "svgd_test_seconds", stat="p99")
    assert p99 == pytest.approx(h1.quantile(0.99))
    with pytest.raises(ValueError, match="unknown histogram stat"):
        series_values(records, "svgd_test_seconds", {"tenant": "a"}, stat="median")
    assert series_values(records, "svgd_missing") == [None] * 3


# --------------------------------------------------------------------- #
# anomaly report: deterministic fixture verdicts + CLI exit codes


def _write_fixture_history(root, gauge_values, jhist=None):
    """A history whose svgd_test_gauge traces gauge_values, one record per
    window, with a constant co-recorded counter — written by the port's
    recorder, or by JAX's when ``jhist`` is given."""
    if jhist is None:
        reg, Recorder = MetricsRegistry(), HistoryRecorder
    else:
        reg, Recorder = _jax_registry(), jhist.HistoryRecorder
    g = reg.gauge("svgd_test_gauge", "t")
    c = reg.counter("svgd_test_total", "t")
    clock = iter(float(60 * i) for i in range(len(gauge_values))).__next__
    rec = Recorder(reg, root, interval_s=60.0, clock=clock)
    for v in gauge_values:
        g.set(v)
        c.inc(100)
        rec.record_once()
    return rec.history


CLEAN = [10.0, 10.2, 9.9, 10.1, 10.0, 9.8, 10.1, 10.0, 9.9, 10.2]
STEPPED = CLEAN[:5] + [v + 20.0 for v in CLEAN[5:]]


def test_detect_step_change_fixture_verdicts(janomaly):
    rng = np.random.default_rng(9)
    noisy = list(rng.normal(10.0, 0.3, size=24))
    drift = noisy[:12] + [v + 3.0 for v in noisy[12:]]
    for values in (CLEAN, STEPPED, noisy, drift, [1.0] * 8, [0.0] * 8):
        for kw in ({}, {"k": 3.0, "min_segment": 2}, {"abs_floor": 5.0}):
            assert (anomaly_report.detect_step_change(values, **kw)
                    == janomaly.detect_step_change(values, **kw)), (values, kw)
    assert anomaly_report.detect_step_change(CLEAN) is None
    hit = anomaly_report.detect_step_change(STEPPED)
    assert hit["split_index"] == 5
    assert hit["shift"] == pytest.approx(20.0, rel=0.05)


def test_analyze_records_flags_injected_step_only(tmp_path, jhist, janomaly):
    """Rings written by either package: the port's and JAX's reports are
    equal, flag the injected step only, and stay silent on the clean ring
    and on the flat counter under ``rate``."""
    for writer in (None, jhist):
        tag = "port" if writer is None else "jax"
        clean = _write_fixture_history(str(tmp_path / f"clean_{tag}"), CLEAN,
                                       writer).records()
        stepped = _write_fixture_history(str(tmp_path / f"step_{tag}"), STEPPED,
                                         writer).records()
        for records in (clean, stepped):
            for kw in ({}, {"rate": True}, {"metric": "svgd_test_total"}):
                assert (anomaly_report.analyze_records(records, **kw)
                        == janomaly.analyze_records(records, **kw))
        assert anomaly_report.analyze_records(clean)["anomalies"] == []
        report = anomaly_report.analyze_records(stepped)
        assert [a["metric"] for a in report["anomalies"]] == ["svgd_test_gauge"]
        assert report["anomalies"][0]["split_index"] == 5
        report = anomaly_report.analyze_records(stepped, rate=True)
        assert [a["metric"] for a in report["anomalies"]] == ["svgd_test_gauge"]
        assert anomaly_report.render(report) == janomaly.render(report)


def test_anomaly_report_cli_exit_codes(tmp_path, capsys, janomaly):
    clean_dir = str(tmp_path / "clean")
    step_dir = str(tmp_path / "step")
    _write_fixture_history(clean_dir, CLEAN)
    _write_fixture_history(step_dir, STEPPED)
    cases = [[clean_dir], [step_dir], [step_dir, "--json"],
             [step_dir, "--rate", "--k", "8"], [str(tmp_path / "missing")],
             [str(tmp_path)]]  # a directory without records
    want = [0, 1, 1, 1, 2, 2]
    for argv, code in zip(cases, want):
        assert anomaly_report.main(argv) == code, argv
        ours = capsys.readouterr()
        assert janomaly.main(argv) == code, argv
        theirs = capsys.readouterr()
        assert ours.out == theirs.out
        assert bool(ours.err) == bool(theirs.err) == (code == 2)
    assert anomaly_report.main([step_dir, "--json"]) == 1
    doc = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert doc["anomalies"][0]["metric"] == "svgd_test_gauge"


# --------------------------------------------------------------------- #
# cost drill at test size + row gates

DRILL_KW = dict(tenants=(("a", 256), ("b", 128)), n_features=8, max_batch=8,
                requests=24, clients=2, ab_rounds=0, history_windows=2)


def test_cost_drill_row_and_accounting(tmp_path):
    """The drill at test size: JAX's row keys plus the port's overhead
    gate's three, the accounting identity, zero in-window captures, and
    the kept history ring's per-program sums equal to the final dump's."""
    jcost = _jax_tool("cost_drill")
    ring = str(tmp_path / "ring")
    row = cost_drill.run_drill(device="cpu", history_dir=ring, **DRILL_KW)
    want = jcost.run_drill(**DRILL_KW)
    assert set(row) == set(want) | set(cost_drill.PORT_OVERHEAD_KEYS)
    for key in ("metric", "unit", "requests", "history_records", "tenants",
                "clients", "max_batch", "n_features", "ab_rounds",
                "profiler_overhead_frac", "recompiles", "platform"):
        assert row[key] == want[key], key
    assert row["tenant_sum_err_frac"] < 0.01
    assert 0.0 < row["coverage"] <= 1.0
    assert row["sentry_supported"] and row["sentry_compiles"] == 0
    assert set(row["tenant_device_s"]) == {"a", "b"}
    assert row["tenant_device_s"]["a"] > 0.0
    assert row["history_records"] == 3  # baseline + one per segment
    assert row["dispatch_overhead_frac"] == 0.0  # ab_rounds=0
    assert any(p["label"].startswith("serve.") for p in row["top_programs"])
    from dist_svgd_torch.tools import trace_report

    summed = trace_report.program_rows(trace_report.load_program_dumps(ring))
    final = trace_report.program_rows([cost_drill._LAST_REGISTRY[0].dump()])
    assert [(p["label"], p["dispatches"], p["rows"], p["bytes"]) for p in summed["programs"]
            ] == [(p["label"], p["dispatches"], p["rows"], p["bytes"])
                  for p in final["programs"]]
    assert summed["total_seconds"] == pytest.approx(final["total_seconds"], rel=1e-9)


def test_cost_drill_default_tenants_by_device():
    """Given no tenants the drill serves JAX's on the CPU and the same 4:2:1
    tenants at 256× the particles on the card (compute-dominant there, as
    JAX's are on its host)."""
    import torch

    jcost = _jax_tool("cost_drill")
    assert cost_drill.DEFAULT_TENANTS == jcost.DEFAULT_TENANTS
    assert cost_drill.default_tenants(torch.device("cpu")) == jcost.DEFAULT_TENANTS
    card = cost_drill.default_tenants(torch.device("cuda"))
    assert card == cost_drill.CARD_TENANTS
    assert [name for name, _ in card] == [name for name, _ in jcost.DEFAULT_TENANTS]
    assert [n for _, n in card] == [256 * n for _, n in jcost.DEFAULT_TENANTS]


def test_cost_drill_row_ok_gates():
    """JAX's synthetic rows get JAX's verdicts; the port's overhead gate
    fails a row only where the row carries it."""
    jcost = _jax_tool("cost_drill")
    good = {"coverage": 0.97, "tenant_sum_err_frac": 0.002,
            "recompiles": 0, "sentry_compiles": 0, "sentry_supported": True}
    cases = [good, {**good, "coverage": 0.90}, {**good, "tenant_sum_err_frac": 0.05},
             {**good, "recompiles": 2}, {**good, "sentry_compiles": 1},
             {**good, "sentry_supported": False, "sentry_compiles": 3},
             {**good, "coverage": 0.5, "recompiles": 1}]
    for row in cases:
        ok, why = cost_drill.row_ok(row)
        jok, jwhy = jcost.row_ok(row)
        assert ok == jok and len(why) == len(jwhy), row
    for bad, frag in (({**good, "coverage": 0.90}, "coverage"),
                      ({**good, "tenant_sum_err_frac": 0.05}, "sum"),
                      ({**good, "recompiles": 2}, "recompile"),
                      ({**good, "sentry_compiles": 1}, "sentry")):
        assert any(frag in w for w in cost_drill.row_ok(bad)[1])
    assert cost_drill.row_ok({**good, "dispatch_overhead_frac": 0.02})[0]
    ok, why = cost_drill.row_ok({**good, "dispatch_overhead_frac": 0.04})
    assert not ok and any("dispatch path" in w for w in why)
