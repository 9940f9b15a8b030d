"""The port's fleet drill (``dist_svgd_torch/tools/fleet_drill.py``)
against JAX's (``tools/fleet_drill.py``, loaded by path), on the CPU.

Each package runs its fake-mode drill once, at JAX's test sizes: the two
``fleet_failover`` rows carry the same keys, and the port's passes every
gate of ``row_ok`` — nothing lost, no misroute, stitch coverage 1.0 with
the kill's retries as sibling trees, a monotone federation.  Both
``row_ok`` give the same verdicts and reasons on the same doctored rows;
``main`` exits 0 on a clean drill.  The real mode spawns three
``python -m dist_svgd_torch.serving.server`` replicas with ``--device
cpu`` and is marked slow, as JAX's real drill is."""

import importlib.util
import json
import os
import sys

import pytest

from dist_svgd_torch.tools import fleet_drill as tfd

from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: JAX's test sizes (tests/test_fleet_drill.py)
DRILL_KW = dict(rate_hz=150.0, steady_s=0.4, kill_s=0.6, partition_s=0.5)


@pytest.fixture(scope="module")
def jfd():
    tools = os.path.join(ROOT, "tools")
    if tools not in sys.path:
        sys.path.insert(0, tools)
    spec = importlib.util.spec_from_file_location(
        "jax_fleet_drill", os.path.join(tools, "fleet_drill.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def rows(jfd):
    return tfd.run_drill("fake", **DRILL_KW), jfd.run_drill("fake", **DRILL_KW)


def test_fake_row_keys_equal_jax(rows):
    ours, theirs = rows
    assert list(ours) == list(theirs)
    assert ours["metric"] == "fleet_failover" and ours["mode"] == "fake"
    assert ours["replicas"] == theirs["replicas"] == 3
    for key in ("rate_hz", "probe_interval_s", "open_cooldown_s"):
        assert ours[key] == theirs[key], key


def test_fake_drill_acceptance(rows):
    """Killing one of three replicas under open-loop load loses nothing,
    detection lands within 2 probe intervals, the partitioned replica stays
    alive and flight-clean, and the restart re-admits through half-open."""
    row = rows[0]
    ok, why = tfd.row_ok(row)
    assert ok, why
    assert row["value"] == 1.0 and row["requests"] > 0
    assert row["lost_requests"] == 0 and row["misroutes"] == 0
    assert row["detect_probe_intervals"] <= 2.0
    assert row["readmit_s"] > 0 and row["readmissions"] >= 1
    assert row["retries"] >= 1
    assert row["partition_replica_alive"] is True
    assert row["partition_flight_trips"] == 0


def test_fake_drill_stitch_and_federation(rows):
    """Every served request stitches into one router→replica tree through
    the port's ``trace_report.stitch_files`` (the kill's retries as
    sibling attempts); the federation scraped through the kill and stayed
    monotone across the restarted replica's counter reset."""
    row = rows[0]
    assert row["trace_stitch_coverage"] == 1.0
    assert row["stitch_served_routes"] > 0 and row["stitch_orphans"] == 0
    assert row["stitch_retry_trees"] >= 1
    assert row["federation_scrapes"] >= 4
    assert row["federation_scrape_errors"] + row["federation_scrapes_skipped"] >= 1
    assert row["federation_monotone"] is True
    assert row["federation_scrape_ms"] > 0 and row["federated_requests_total"] > 0


GOOD = {"lost_requests": 0, "misroutes": 0, "detect_s": 0.1, "readmit_s": 0.2,
        "readmissions": 1, "partition_replica_alive": True,
        "partition_flight_trips": 0, "mode": "fake",
        "trace_stitch_coverage": 1.0, "federation_monotone": True}


@pytest.mark.parametrize("change", [
    {}, {"lost_requests": 3}, {"misroutes": 1}, {"detect_s": None},
    {"readmit_s": None}, {"readmissions": 0}, {"partition_replica_alive": False},
    {"partition_replica_alive": None}, {"partition_flight_trips": 2},
    {"partition_flight_trips": None}, {"trace_stitch_coverage": 0.97},
    {"trace_stitch_coverage": None}, {"federation_monotone": False},
    {"mode": "real", "trace_stitch_coverage": None},
    {"mode": "real", "trace_stitch_coverage": None, "federation_monotone": False},
    {"lost_requests": 1, "misroutes": 2, "readmit_s": None, "mode": "real"},
])
def test_row_ok_verdicts_equal_jax(jfd, change):
    row = dict(GOOD, **change)
    ours = tfd.row_ok(dict(row))
    assert ours == jfd.row_ok(dict(row))
    assert ours[0] == (not ours[1])


def test_row_ok_reads_a_drill_row_like_jax(rows, jfd):
    for row in rows:
        assert tfd.row_ok(dict(row)) == jfd.row_ok(dict(row))


def test_main_exits_clean_and_prints_the_row(capsys):
    assert tfd.main(["--mode", "fake", "--rate", "120"]) == 0
    row = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert row["ok"] is True and "failures" not in row
    assert row["metric"] == "fleet_failover" and row["lost_requests"] == 0


def test_run_drill_rejects_an_unknown_mode():
    with pytest.raises(ValueError, match="fake|real"):
        tfd.run_drill("mock")


@pytest.mark.slow
def test_real_subprocess_drill():
    """Real sockets, a real SIGKILL and restart: three port
    ``PredictionServer`` subprocesses on the CPU behind the router, the
    partition cut router-side so the replica process stays untouched."""
    row = tfd.run_drill(mode="real", rate_hz=80.0, device="cpu")
    ok, why = tfd.row_ok(row)
    assert ok, (why, row)
    assert row["lost_requests"] == 0
    assert row["partition_replica_alive"] is True
    assert len(row["replica_spawn_s"]) == 4  # three spawns and the restart
