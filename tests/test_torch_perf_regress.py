"""The port's regression gate (``dist_svgd_torch/tools/perf_regress.py``)
on the CPU: JAX's helper tests (``tests/test_perf_regress.py``) on the
port, each helper against JAX's ``tools/perf_regress.py`` on a grid of
windows, the constants against JAX's, ``--list-missing`` and the no-card
exit, every row family on canned drill rows (PASS on a green row once its
history holds it, NO_INCUMBENT with no history, FAIL on each breakage the
gate reads), ``serve_sharded`` at one and two devices, and the chained rows
built at shrunk sizes.  The measuring half needs the card; ``chip_smoke.py``
section 27 and the tool itself run it there."""

import argparse
import copy
import json
import os
import sys

import pytest

from dist_svgd_torch.tools import perf_regress as pr

from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def jpr():
    """JAX's gate (tools/ is a script directory)."""
    path = os.path.join(REPO, "tools")
    if path not in sys.path:
        sys.path.insert(0, path)
    import perf_regress

    return perf_regress


ARGS = argparse.Namespace(tol=0.35, rounds=1)


# --------------------------------------------------------------------- #
# JAX's helper tests, on the port


def test_median_and_mad():
    assert pr._median([3.0, 1.0, 2.0]) == 2.0
    assert pr._median([1.0, 2.0, 3.0, 4.0]) == 2.5
    assert pr._mad([1.0, 2.0, 3.0]) == 1.0
    assert pr._mad([5.0]) == 0.0


def test_incumbent_history_legacy_scalar_seeds_window():
    incumbents = {"north_star_ups": 100.0}
    assert pr.incumbent_history(incumbents, "north_star_ups") == [100.0]
    assert pr.incumbent_history(incumbents, "missing") == []


def test_incumbent_history_prefers_window():
    incumbents = {"k": 100.0, "_history": {"k": [90.0, 110.0, 100.0]}}
    assert pr.incumbent_history(incumbents, "k") == [90.0, 110.0, 100.0]


def test_judge_row_tight_window_uses_tol():
    hist = [100.0, 100.0, 100.0]
    assert pr.judge_row(100.0, hist, 0.35, True)[0] == "PASS"
    assert pr.judge_row(70.0, hist, 0.35, True)[0] == "WARN"
    assert pr.judge_row(60.0, hist, 0.35, True)[0] == "FAIL"
    assert pr.judge_row(160.0, hist, 0.35, False)[0] == "FAIL"
    assert pr.judge_row(100.0, hist, 0.35, False)[0] == "PASS"


def test_judge_row_noisy_window_widens_band():
    hist = [60.0, 100.0, 140.0, 80.0, 120.0]
    status, info = pr.judge_row(45.0, hist, 0.35, True)
    assert status != "FAIL"
    assert info["band"] == pytest.approx(0.6)
    assert pr.judge_row(35.0, hist, 0.35, True)[0] == "FAIL"


def test_record_result_window_and_median():
    incumbents = {"k": 100.0}
    for v in (90.0, 110.0, 120.0):
        pr.record_result(incumbents, "k", v, window=3)
    assert incumbents["_history"]["k"] == [90.0, 110.0, 120.0]
    assert incumbents["k"] == 110.0


def test_record_result_rejects_bad_window():
    with pytest.raises(ValueError, match="window"):
        pr.record_result({}, "k", 1.0, window=0)


def test_missing_rows_respects_history_and_legacy_scalars():
    assert pr.missing_rows({}) == list(pr.WINDOWED_ROWS)
    inc = {"_history": {"north_star_ups": [100.0]}, "config1_ups": 5.0}
    missing = pr.missing_rows(inc)
    assert "north_star_ups" not in missing and "config1_ups" not in missing
    assert "multihost_updates_per_s" in missing
    assert missing == [k for k in pr.WINDOWED_ROWS if k in set(missing)]


# --------------------------------------------------------------------- #
# each helper against JAX's, on a grid of windows

WINDOWS = {
    "empty": ({}, "k"),
    "legacy scalar": ({"k": 100.0}, "k"),
    "legacy and history": ({"k": 100.0, "_history": {"k": [90.0, 95.0]}}, "k"),
    "tight": ({"_history": {"k": [100.0, 100.0, 100.0]}}, "k"),
    "noisy": ({"_history": {"k": [60.0, 100.0, 140.0, 80.0, 120.0]}}, "k"),
    "capped": ({"_history": {"k": [1.0, 100.0, 1000.0]}}, "k"),
    "zero median": ({"_history": {"k": [0.0, 0.0, 1.0]}}, "k"),
    "even window": ({"_history": {"k": [10.0, 12.0, 14.0, 30.0]}}, "k"),
}
VALUES = [0.5, 35.0, 45.0, 60.0, 70.0, 100.0, 160.0, 1e4]


@pytest.mark.parametrize("window", list(WINDOWS))
@pytest.mark.parametrize("higher", [True, False], ids=["higher", "lower"])
def test_judging_matches_jax(jpr, window, higher):
    incumbents, key = WINDOWS[window]
    hist = pr.incumbent_history(incumbents, key)
    assert hist == jpr.incumbent_history(incumbents, key)
    assert pr.missing_rows(incumbents, (key, "other")) == \
        jpr.missing_rows(incumbents, (key, "other"))
    if hist:
        assert pr._mad(hist) == jpr._mad(hist)
    for value in VALUES:
        for tol in (0.1, 0.35, 0.7):
            assert pr.judge_row(value, hist, tol, higher) == \
                jpr.judge_row(value, hist, tol, higher), (value, tol)


@pytest.mark.parametrize("window", list(WINDOWS))
def test_record_result_matches_jax(jpr, window):
    incumbents, key = WINDOWS[window]
    mine, theirs = copy.deepcopy(incumbents), copy.deepcopy(incumbents)
    for value in (5.0, 7.0, 3.0, 11.0):
        pr.record_result(mine, key, value, window=3)
        jpr.record_result(theirs, key, value, window=3)
        assert mine == theirs


def test_constants_equal_jaxs(jpr):
    for name in ("TOL_FACTOR", "WINDOWED_ROWS", "UNCONDITIONAL_ROW_KEYS",
                 "TELEMETRY_OVERHEAD_MAX", "PROFILER_OVERHEAD_MAX",
                 "DIAGNOSTICS_OVERHEAD_MAX", "SERVE_BENCH_KW", "SERVE_SHARDED_LANES",
                 "LARGE_N_APPROX_KW", "MULTITENANT_KW", "MAD_SCALE"):
        assert getattr(pr, name) == getattr(jpr, name), name
    assert len(pr.WINDOWED_ROWS) == len(set(pr.WINDOWED_ROWS))


def test_gate_flags_are_jaxs_plus_commit():
    port = {o for a in pr.build_parser()._actions for o in a.option_strings}
    assert port == {"-h", "--help", "--rounds", "--tol", "--target-s", "--record",
                    "--window", "--force", "--list-missing", "--commit"}


def test_list_missing_runs_on_the_cpu_with_jaxs_keys(jpr, monkeypatch, capsys):
    """``--list-missing`` needs no card; its report has JAX's keys, and
    reads the port's own incumbents and program-card baseline."""
    monkeypatch.setattr(sys, "argv", ["perf_regress.py", "--list-missing"])
    monkeypatch.syspath_prepend(REPO)
    with pytest.raises(SystemExit) as e:
        jpr.main()
    assert e.value.code == 0
    jax_report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert pr.main(["--list-missing"]) == 0
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert list(report) == list(jax_report)
    assert report["windowed_rows"] == len(pr.WINDOWED_ROWS)
    assert report["missing"] == pr.missing_rows(pr.load_incumbents())
    assert report["program_audit_missing"] == []


def test_main_without_a_card_exits_2_with_a_json_error(monkeypatch, capsys):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert pr.main(["--rounds", "1"]) == 2
    out = json.loads(capsys.readouterr().out.strip())
    assert "card" in out["error"] and out["platform"] == "cpu"


def test_committed_incumbents_are_the_ports():
    inc = pr.load_incumbents()
    assert isinstance(inc.get("recorded"), str)
    assert os.path.dirname(pr.INCUMBENTS_PATH).endswith(os.path.join("dist_svgd_torch", "tools"))
    for key, hist in inc.get("_history", {}).items():
        assert key in pr.WINDOWED_ROWS and hist and inc[key] == pr._median(hist)


# --------------------------------------------------------------------- #
# the row families on canned drill rows


def _statuses(rows):
    return {r["bench"]: r["status"] for r in rows}


def _recorded(results):
    inc = {}
    for key, value in results.items():
        if key == "north_star_roofline_fraction":
            inc[key] = value
        else:
            pr.record_result(inc, key, value, 8)
    return inc


def _breakable(green):
    return lambda path, value: _set(copy.deepcopy(green), path, value)


def _set(row, path, value):
    node = row
    for key in path[:-1]:
        node = node[key]
    node[path[-1]] = value
    return row


SERVE_ROW = {"value": 4000.0, "p50_ms": 3.0, "p99_ms": 8.0, "batch_occupancy_mean": 0.5,
             "recompiles": 0, "sentry_compiles": 0, "slo_status": "ok",
             "serve_latency_p99": 9.0, "devices": 1, "lanes": 1,
             "lane_fairness": {"requests": [10]}}
MT_ROW = {"value": 3000.0, "tenants": 10, "tenant_fairness": 0.9, "p99_worst_tenant_ms": 12.0,
          "evictions": 1, "quota_sheds": 2, "recompiles": 0, "sentry_compiles": 0}
ELASTIC_ROW = {"shards_from": 8, "shards_to": 4, "steps_lost": 4,
               "post_reshard_recompiles": 0, "sentry_supported": True,
               "elastic_final_max_dev": 1e-7, "ksd_delta_frac": 0.01, "grow_ok": True,
               "fallback_ok": True, "serve_ok": True, "resumed_within_tolerance": True,
               "hyperparams_bitwise": True, "reshard_wall_s": 0.5, "recovery_wall_s": 1.5}
APPROX_ROW = {"updates_per_sec": 2e7, "n": 2_000_000, "method": "rff", "dial": 4096,
              "approx_rel_err": 0.01, "error_budget": 0.05, "within_budget": True,
              "recompiles": 0, "sentry_supported": True, "exact_est_wall_per_step_s": 90.0,
              "est_speedup_vs_exact": 900.0, "wall_per_step_s": 0.1,
              "kernel_approx_active": True}
STORM_ROW = {"storm_goodput_2x": 700.0, "unit": "polite good requests/sec",
             "capacity_rows_per_s": 5e4, "storm_p99_breach_s": 2.0, "storm_recover_s": 1.0,
             "lost_requests": 0, "shed_requests": 5, "recompiles": 0, "sentry_compiles": 0,
             "ab": {"adaptive_wins": True},
             "arms": {"adaptive": {"phases": {"steady": {"offered": 3, "completed": 2,
                                                         "shed": 1, "errors": 0,
                                                         "lost": 0}}}}}
FLEET_REAL = {"value": 450.0, "unit": "req/s", "mode": "real", "replicas": 3, "requests": 300,
              "lost_requests": 0, "shed_requests": 0, "misroutes": 0,
              "detect_probe_intervals": 2, "p99_partition_ms": 30.0,
              "partition_replica_alive": True, "partition_flight_trips": 0,
              "detect_s": 0.2, "readmit_s": 9.0, "readmissions": 1,
              "federation_scrape_ms": 12.0, "federation_monotone": True}
FLEET_FAKE = dict(FLEET_REAL, mode="fake", trace_stitch_coverage=1.0, stitch_served_routes=100,
                  stitch_retry_trees=2, stitch_orphans=0)
MH_ROW = {"mode": "fake", "status": "ok", "processes": 4, "shards": 8, "shards_after_loss": 6,
          "dcn_crossings_per_hop": 1, "resume_bitwise": True, "rng_layout_free": True,
          "manifest_stamped": True, "single_block_rejected": True, "variants_ok": True,
          "steps_lost": 4, "expected_steps_lost": 4, "sentry_supported": True,
          "post_restart_recompiles": 0, "killone_within_tol": True, "killone_max_dev": 1e-7,
          "federation_restarts": 0, "ring_hop_wall_ms": 3.0, "updates_per_s_gather": 5e4}
FRESH_ROW = {"freshness_p50_s": 0.25, "freshness_p99_s": 0.35,
             "resumed_bitwise_identical": True, "drift_detected": True,
             "drift_retrained": True, "drift_detect_segments": 2, "refits": 4, "reloads": 20,
             "reload_rejections": 0, "dropped_total": 0, "steady_state_recompiles": 0,
             "slo_status": "ok"}
ROLLOUT_ROW = {
    "good": {"promoted": True, "stages": [0.02, 0.1, 0.5, 1.0]},
    "bad": {"rolled_back": True, "peak_fraction": 0.0, "max_exposure": 0.10,
            "checkpoint_reloads": 0, "incumbent_bitwise": True,
            "serving_generation_unchanged": True, "at_stage": 0.02},
    "client": {"offered": 10, "completed": 10, "shed": 0, "errors": 0, "lost": 0},
    "steady_state_recompiles": 0, "rollout_promote_s": 3.0,
    "shadow_overhead_frac": 0.001, "shadow_overhead_max": 0.05,
    "mirrors_total": 40, "mirror_dropped": 0}
COST_ROW = {"coverage": 0.99, "attributed_s": 0.99, "measured_device_s": 1.0,
            "tenant_device_s": {"a": 0.5, "b": 0.5}, "tenant_sum_err_frac": 0.001,
            "recompiles": 0, "sentry_supported": True, "sentry_compiles": 0,
            "history_records": 4, "history_anomalies": 0, "profiler_overhead_frac": 0.01,
            "rps_disabled": 100.0, "rps_enabled": 99.0, "rps": 99.0}


def _patch_drills(monkeypatch, rows):
    """Every drill the families call returns its canned row."""
    from dist_svgd_torch.tools import (cost_drill, elastic_drill, fault_drill, fleet_drill,
                                       freshness_drill, large_n, multihost_train,
                                       rollout_drill, serve_bench, workload_replay)

    monkeypatch.setattr(serve_bench, "run_bench", lambda **kw: copy.deepcopy(rows["serve"]))
    monkeypatch.setattr(serve_bench, "run_multitenant_bench",
                        lambda **kw: copy.deepcopy(rows["mt"]))
    monkeypatch.setattr(serve_bench, "measure_telemetry_overhead",
                        lambda rounds, **kw: {"overhead_frac": rows["tel"], "rps_disabled": 100.0,
                                              "rps_enabled": 99.0})
    monkeypatch.setattr(fault_drill, "measure_diagnostics_overhead",
                        lambda rounds, **kw: {"overhead_frac": rows["diag"], "wall_off_s": 1.0,
                                              "wall_on_s": 1.01})
    monkeypatch.setattr(elastic_drill, "run_drill", lambda **kw: copy.deepcopy(rows["elastic"]))
    monkeypatch.setattr(large_n, "run_approx_row", lambda **kw: copy.deepcopy(rows["approx"]))
    monkeypatch.setattr(workload_replay, "run_storm", lambda **kw: copy.deepcopy(rows["storm"]))
    monkeypatch.setattr(fleet_drill, "run_drill",
                        lambda mode, **kw: copy.deepcopy(rows["fleet_" + mode]))
    monkeypatch.setattr(multihost_train, "run_drill", lambda **kw: copy.deepcopy(rows["mh"]))
    monkeypatch.setattr(freshness_drill, "run_drill", lambda **kw: copy.deepcopy(rows["fresh"]))
    monkeypatch.setattr(rollout_drill, "run_drill", lambda **kw: copy.deepcopy(rows["rollout"]))
    monkeypatch.setattr(cost_drill, "run_drill", lambda **kw: copy.deepcopy(rows["cost"]))


GREEN = {"serve": SERVE_ROW, "mt": MT_ROW, "tel": 0.01, "diag": 0.01, "elastic": ELASTIC_ROW,
         "approx": APPROX_ROW, "storm": STORM_ROW, "fleet_real": FLEET_REAL,
         "fleet_fake": FLEET_FAKE, "mh": MH_ROW, "fresh": FRESH_ROW, "rollout": ROLLOUT_ROW,
         "cost": COST_ROW}


def _serve(inc, args):
    return pr.serve_rows(inc, args, "cpu")[:3]


#: family → (function, the rows it prints when green)
FAMILIES = {
    "serve": (_serve, ["serve_throughput", "serve_latency_p99"]),
    "multitenant": (pr.multitenant_rows, ["serve_multitenant", "serve_multitenant_p99"]),
    "overheads": (pr.overhead_rows, ["telemetry_overhead", "diagnostics_overhead"]),
    "elastic": (pr.elastic_rows, ["elastic_resume", "elastic_reshard_wall_s",
                                  "elastic_recovery_wall_s"]),
    "large_n": (pr.large_n_rows, ["large_n_approx"]),
    "storm": (pr.storm_rows, ["serve_storm", "storm_recover_s"]),
    "fleet": (pr.fleet_rows, ["fleet_failover", "fleet_detect_s", "fleet_readmit_s",
                              "fleet_federation_scrape_ms", "fleet_trace_stitch"]),
    "multihost": (pr.multihost_rows, ["multihost_train", "multihost_ring_hop_wall_ms",
                                      "multihost_updates_per_s"]),
    "freshness": (pr.freshness_rows, ["freshness", "freshness_p99_s"]),
    "rollout": (pr.rollout_rows, ["canary_rollout", "rollout_promote_s",
                                  "shadow_overhead_frac"]),
    "cost": (pr.cost_rows, ["cost_attribution", "profiler_overhead", "cost_attr_rps"]),
}


@pytest.mark.parametrize("family", list(FAMILIES))
def test_family_green_rows(monkeypatch, family):
    """A green drill row: the correctness rows PASS, the windowed rows read
    NO_INCUMBENT with no history, and PASS once their values are recorded."""
    fn, names = FAMILIES[family]
    _patch_drills(monkeypatch, GREEN)
    rows, failures, results = fn({}, ARGS)
    assert [r["bench"] for r in rows] == names and failures == 0
    windowed = set(pr.WINDOWED_ROWS) | {"serve_storm"}
    for r in rows:
        assert r["status"] == ("NO_INCUMBENT" if r["bench"] in windowed else "PASS"), r
    assert set(results) <= set(pr.WINDOWED_ROWS)
    assert {r["bench"] for r in rows} & set(pr.WINDOWED_ROWS) <= set(results) | {"serve_storm"}
    rows, failures, _ = fn(_recorded(results), ARGS)
    assert failures == 0 and set(_statuses(rows).values()) == {"PASS"}


#: family → [(what breaks, {canned key: broken row}, the row that FAILs)]
BREAKAGES = {
    "serve": [
        ("bucket miss", {"serve": _breakable(SERVE_ROW)(("recompiles",), 1)},
         "serve_throughput"),
        ("capture", {"serve": _breakable(SERVE_ROW)(("sentry_compiles",), 2)},
         "serve_throughput"),
        ("slo breach", {"serve": _breakable(SERVE_ROW)(("slo_status",), "breach")},
         "serve_throughput"),
        ("empty histogram", {"serve": _breakable(SERVE_ROW)(("serve_latency_p99",), None)},
         "serve_latency_p99"),
    ],
    "multitenant": [
        ("recompile", {"mt": _breakable(MT_ROW)(("recompiles",), 1)}, "serve_multitenant"),
        ("no eviction", {"mt": _breakable(MT_ROW)(("evictions",), 0)}, "serve_multitenant"),
        ("no quota shed", {"mt": _breakable(MT_ROW)(("quota_sheds",), 0)},
         "serve_multitenant"),
        ("no p99", {"mt": _breakable(MT_ROW)(("p99_worst_tenant_ms",), None)},
         "serve_multitenant_p99"),
    ],
    "overheads": [
        ("tracer", {"tel": 0.05}, "telemetry_overhead"),
        ("diagnostics", {"diag": 0.031}, "diagnostics_overhead"),
    ],
    "elastic": [
        ("no grow-back", {"elastic": _breakable(ELASTIC_ROW)(("grow_ok",), False)},
         "elastic_resume"),
        ("recompile", {"elastic": _breakable(ELASTIC_ROW)(("post_reshard_recompiles",), 1)},
         "elastic_resume"),
        ("no wall", {"elastic": _breakable(ELASTIC_ROW)(("reshard_wall_s",), None)},
         "elastic_reshard_wall_s"),
    ],
    "large_n": [
        ("over budget", {"approx": _breakable(APPROX_ROW)(("within_budget",), False)},
         "large_n_approx"),
        ("recompile", {"approx": _breakable(APPROX_ROW)(("recompiles",), 1)},
         "large_n_approx"),
    ],
    "storm": [
        ("lost", {"storm": _breakable(STORM_ROW)(("lost_requests",), 1)}, "serve_storm"),
        ("capture", {"storm": _breakable(STORM_ROW)(("sentry_compiles",), 1)}, "serve_storm"),
    ],
    "fleet": [
        ("lost", {"fleet_real": _breakable(FLEET_REAL)(("lost_requests",), 1)},
         "fleet_failover"),
        ("never ejected", {"fleet_real": _breakable(FLEET_REAL)(("detect_s",), None)},
         "fleet_failover"),
        ("stitch", {"fleet_fake": _breakable(FLEET_FAKE)(("trace_stitch_coverage",), 0.9)},
         "fleet_trace_stitch"),
        ("clamp", {"fleet_fake": _breakable(FLEET_FAKE)(("federation_monotone",), False)},
         "fleet_trace_stitch"),
    ],
    "multihost": [
        ("not bitwise", {"mh": _breakable(MH_ROW)(("resume_bitwise",), False)},
         "multihost_train"),
        ("no hop wall", {"mh": _breakable(MH_ROW)(("ring_hop_wall_ms",), None)},
         "multihost_ring_hop_wall_ms"),
    ],
    "freshness": [
        ("dropped", {"fresh": _breakable(FRESH_ROW)(("dropped_total",), 1)}, "freshness"),
        ("slo", {"fresh": _breakable(FRESH_ROW)(("slo_status",), "breach")}, "freshness"),
    ],
    "rollout": [
        ("not promoted", {"rollout": _breakable(ROLLOUT_ROW)(("good", "promoted"), False)},
         "canary_rollout"),
        ("lost", {"rollout": _breakable(ROLLOUT_ROW)(("client", "lost"), 1)},
         "canary_rollout"),
    ],
    "cost": [
        ("coverage", {"cost": _breakable(COST_ROW)(("coverage",), 0.5)}, "cost_attribution"),
        ("profiler", {"cost": _breakable(COST_ROW)(("profiler_overhead_frac",), 0.05)},
         "profiler_overhead"),
        ("no profiler A/B", {"cost": _breakable(COST_ROW)(("profiler_overhead_frac",), None)},
         "profiler_overhead"),
    ],
}
BREAK_CASES = [(fam, what, broken, row) for fam, cases in BREAKAGES.items()
               for what, broken, row in cases]


@pytest.mark.parametrize("family,what,broken,row", BREAK_CASES,
                         ids=[f"{c[0]}-{c[1]}" for c in BREAK_CASES])
def test_family_fails_on_each_breakage(monkeypatch, family, what, broken, row):
    fn, _ = FAMILIES[family]
    _patch_drills(monkeypatch, dict(GREEN, **broken))
    rows, failures, _ = fn({}, ARGS)
    assert failures >= 1 and _statuses(rows)[row] == "FAIL", rows


def test_family_regression_fails_against_history(monkeypatch):
    """A windowed value 3× worse than its recorded window FAILs."""
    _patch_drills(monkeypatch, GREEN)
    _, _, results = pr.storm_rows({}, ARGS)
    inc = _recorded(results)
    slow = _breakable(STORM_ROW)(("storm_goodput_2x",), 200.0)
    _patch_drills(monkeypatch, dict(GREEN, storm=slow))
    rows, failures, _ = pr.storm_rows(inc, ARGS)
    assert _statuses(rows)["serve_storm"] == "FAIL" and failures == 1


def test_multihost_refusal_is_unsupported(monkeypatch):
    refused = {"mode": "real", "status": "unsupported", "unsupported_reason": "no group"}
    _patch_drills(monkeypatch, dict(GREEN, mh=refused))
    rows, failures, results = pr.multihost_rows({}, ARGS)
    assert _statuses(rows) == {"multihost_train": "UNSUPPORTED"} and failures == 0
    assert rows[0]["reason"] == "no group" and results == {}


def test_serve_sharded_no_mesh_at_one_device():
    rows, failures, results = pr.serve_sharded_rows({}, ARGS, SERVE_ROW, "cpu")
    assert rows == [{"bench": "serve_sharded", "status": "NO_MESH", "devices": 1}]
    assert failures == 0 and results == {}


def test_serve_sharded_at_two_devices_raises_a10_2(monkeypatch):
    """Where two devices exist the sharded bench runs over
    ``make_plan(2)``'s mesh at :data:`SERVE_SHARDED_LANES` lanes (the load
    shrunk for the CPU): a row with ``devices`` 2 and ``vs_single_device``
    against the serve row.  (The test's name is from when it raised.)"""
    from dist_svgd_torch.parallel import plan

    monkeypatch.setattr(plan, "visible_devices", lambda device=None: 2)
    monkeypatch.setattr(pr, "SERVE_BENCH_KW", dict(pr.SERVE_BENCH_KW, n_particles=64,
                                                   n_features=4, clients=4, requests=40))
    rows, _, results = pr.serve_sharded_rows({}, ARGS, SERVE_ROW, "cpu")
    row = rows[0]
    assert row["bench"] == "serve_sharded" and row.get("status") != "NO_MESH"
    assert row["devices"] == 2 and row["lanes"] == pr.SERVE_SHARDED_LANES
    assert row["recompiles"] == row["sentry_compiles"] == 0
    assert row["vs_single_device"] == round(row["value"] / SERVE_ROW["value"], 3)
    assert set(row["lane_fairness"]) == {f"l{i}" for i in range(pr.SERVE_SHARDED_LANES)}
    assert results["serve_sharded"] == row["value"]
    assert [r["bench"] for r in rows] == ["serve_sharded", "serve_sharded_p99"]


# --------------------------------------------------------------------- #
# the chained rows


class _Sentry:
    def __init__(self, compiles, supported=True):
        self.compiles, self.supported = compiles, supported


def _canned_benches():
    run = lambda: None  # noqa: E731
    return {"north_star_ups": (run, lambda w: 100.0 / w, "updates/sec", True),
            "w2_warm_ms_per_step": (run, lambda w: w * 1e3, "ms/step", False),
            "phi_kernel_pairs_per_sec": (run, lambda w: 1e6 / w, "pairs/sec", True)}


def test_chained_rows_green_regressed_and_recompiled():
    benches = _canned_benches()
    best = {k: 0.01 for k in benches}
    reps = {k: 4 for k in benches}
    rows, failures, results = pr.chained_rows(benches, best, reps, _Sentry(0), {}, ARGS)
    assert _statuses(rows) == {"steady_state_recompiles": "PASS",
                               **{k: "NO_INCUMBENT" for k in benches}}
    inc = _recorded(results)
    rows, failures, _ = pr.chained_rows(benches, best, reps, _Sentry(0), inc, ARGS)
    assert failures == 0 and set(_statuses(rows).values()) == {"PASS"}
    slow = dict(best, w2_warm_ms_per_step=0.03)
    rows, failures, _ = pr.chained_rows(benches, slow, reps, _Sentry(0), inc, ARGS)
    assert _statuses(rows)["w2_warm_ms_per_step"] == "FAIL" and failures == 1
    rows, failures, _ = pr.chained_rows(benches, best, reps, _Sentry(3), inc, ARGS)
    assert _statuses(rows)["steady_state_recompiles"] == "FAIL" and failures == 1
    rows, _, _ = pr.chained_rows(benches, best, reps, _Sentry(3, supported=False), inc, ARGS)
    assert _statuses(rows)["steady_state_recompiles"] == "NO_SENTRY"


def test_roofline_row():
    results = {"north_star_ups": 1e4, "phi_kernel_pairs_per_sec": 1e9}
    rows, failures, out = pr.roofline_rows(results, {}, n=1000)
    assert out == {"north_star_roofline_fraction": 0.01}
    assert rows[0]["status"] == "NO_INCUMBENT" and failures == 0
    rows, failures, _ = pr.roofline_rows(results, {"north_star_roofline_fraction": 0.0105},
                                         n=1000)
    assert rows[0]["status"] == "PASS"
    rows, failures, _ = pr.roofline_rows(results, {"north_star_roofline_fraction": 0.02},
                                         n=1000)
    assert rows[0]["status"] == "FAIL" and failures == 1
    assert pr.roofline_rows({}, {}) == ([], 0, {})


def test_build_benches_and_a_round_on_the_cpu():
    """The six chained rows on the port's samplers at shrunk sizes: one
    warm-up and sizing pass and one round, every value finite and positive,
    no capture or build in the round."""
    benches = pr.build_benches(
        "cpu", n=16, w2_streaming_n=32, covertype_rows=2048, config1_n=8,
        steps=dict(north_star=2, w2_warm=2, covertype=2, w2_streaming=1, config1=2,
                   phi_sweeps=2))
    assert list(benches) == list(pr.WINDOWED_ROWS[:6])
    best, reps, sentry = pr.measure_chained(benches, 1, 0.005)
    rows, failures, results = pr.chained_rows(benches, best, reps, sentry, {}, ARGS)
    assert failures == 0 and sentry.compiles == 0
    assert all(v > 0 and v == v and v != float("inf") for v in results.values())
    assert [r["bench"] for r in rows] == ["steady_state_recompiles"] + list(benches)


def test_drill_families_are_in_jaxs_print_order():
    order = [r for fam in ("serve", "multitenant", "overheads", "elastic", "large_n",
                           "storm", "fleet", "multihost", "freshness", "rollout", "cost")
             for r in FAMILIES[fam][1]]
    windowed = [r for r in order if r in pr.WINDOWED_ROWS]
    assert windowed == [r for r in pr.WINDOWED_ROWS[6:] if r not in
                        ("serve_sharded", "serve_sharded_p99", "storm_goodput_2x")]
    assert [f.__name__ for f in pr.DRILL_FAMILIES] == [
        "multitenant_rows", "overhead_rows", "elastic_rows", "large_n_rows", "storm_rows",
        "fleet_rows", "multihost_rows", "freshness_rows", "rollout_rows", "cost_rows"]
