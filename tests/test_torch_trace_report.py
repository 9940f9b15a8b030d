"""The port's trace report (``dist_svgd_torch/tools/trace_report.py``)
against JAX's (``tools/trace_report.py``, plain Python, imported here), on
the CPU.

A supervised port run with a NaN rollback, a retry and a preempt is traced
by the port's tracer (Chrome export and JSONL) while a flight recorder
runs; both tools' span summaries of the two files, and both tools'
postmortem views of the guard trip's bundle, are equal.  The port buckets
its ``kernel_build`` instants where JAX buckets ``xla_compile``; the CLI's
exit codes and ``--programs`` over a telemetry history directory (rings of
both packages, summed as JAX sums them) are checked too.

``--stitch``: a two-replica loopback fleet routes under a global tracer
and every process's trace is exported — all by the port, all by JAX, or the
port's router over JAX's replicas — and both tools' stitch reports of the
same files are equal: the golden tree with retry siblings, duplicate
client trace ids, an orphan replica trace, the exit 2 of a missing anchor
or a missing router export, and the CLI's JSON and table."""

import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest

from dist_svgd_torch import telemetry
from dist_svgd_torch.distsampler import DistSampler
from dist_svgd_torch.models.gmm import gmm_logp
from dist_svgd_torch.resilience import (
    FaultPlan,
    GuardConfig,
    InjectNaNAt,
    PreemptAt,
    RaiseAt,
    RunSupervisor,
)
from dist_svgd_torch.tools import trace_report as ttr
from dist_svgd_torch.utils.metrics import JsonlLogger

from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def jtr():
    spec = importlib.util.spec_from_file_location("jax_trace_report",
                                                  ROOT / "tools" / "trace_report.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def traced_run(tmp_path_factory):
    """One supervised run under the tracer (Chrome + JSONL) and a flight
    recorder: a NaN rollback at 2, a retry at 6, a preempt at 9; a
    ``kernel_build`` instant inside the first segment."""
    root = tmp_path_factory.mktemp("traced")
    parts = np.random.default_rng(2).normal(size=(32, 2))
    reg = telemetry.MetricsRegistry()
    rec = telemetry.FlightRecorder(capacity=512, dump_dir=str(root / "pm"), registry=reg)
    logger = JsonlLogger(path=str(root / "trace.jsonl"))
    tracer = telemetry.enable(jsonl=logger, registry=reg)
    telemetry.install_flight_recorder(rec)
    try:
        ds = DistSampler(4, lambda th, _=None: gmm_logp(th), None, parts,
                         exchange_scores=False, include_wasserstein=False, device="cpu")
        real = ds.run_steps
        built = []

        def first_builds(*a, **kw):
            if not built:  # as ops/_build.py records a build inside the live span
                built.append(1)
                telemetry.instant("kernel_build", {"kernel": "phi_small_d", "seconds": 1.0})
            return real(*a, **kw)

        ds.run_steps = first_builds
        report = RunSupervisor(ds, 12, 0.05, checkpoint_dir=str(root / "ck"),
                               checkpoint_every=4, segment_steps=2, sleep=lambda s: None,
                               registry=reg, guard=GuardConfig(),
                               faults=FaultPlan(InjectNaNAt(2), RaiseAt(6),
                                                PreemptAt(9))).run()
    finally:
        telemetry.uninstall_flight_recorder()
        telemetry.disable()
        logger.close()
    tracer.export_chrome(str(root / "trace.json"))
    bundles = sorted((root / "pm").iterdir())
    return root, report, bundles


def test_span_summaries_equal_jax_on_both_exports(traced_run, jtr):
    root, report, _ = traced_run
    assert report["status"] == "preempted" and report["restarts"] == 2
    for name in ("trace.json", "trace.jsonl"):
        path = str(root / name)
        spans, instants = ttr.load_events(path)
        ours = ttr.summarize(spans, instants, top=5)
        jspans, jinst = jtr.load_events(path)
        theirs = jtr.summarize(jspans, jinst, top=5)
        assert (spans, instants) == (jspans, jinst)
        assert ours["spans"] == theirs["spans"] and ours["top_self"] == theirs["top_self"]
        assert ours["n_spans"] == theirs["n_spans"] > 0
        assert ours["n_instants"] == theirs["n_instants"] > 0
        assert {"train.segment", "train.checkpoint"} <= set(ours["spans"])
        # the port's build instant, bucketed where JAX buckets its compiles
        assert ours["compiles"] == 1 and ours["compile_spans"] == {"train.segment": 1}
        renamed = [dict(i, name="xla_compile") if i["name"] == "kernel_build" else i
                   for i in instants]
        jax_view = jtr.summarize(jspans, renamed, top=5)
        assert (ours["compiles"], ours["compile_spans"]) == \
            (jax_view["compiles"], jax_view["compile_spans"])
        assert ttr.render(ours).replace("kernel builds", "xla compiles") == \
            jtr.render(jax_view)


def test_postmortem_of_a_guard_trip_equals_jax(traced_run, jtr, capsys):
    _, _, bundles = traced_run
    assert [b.name for b in bundles] == ["postmortem_001_guard_violation.jsonl"]
    path = str(bundles[0])
    ours = ttr.load_postmortem(path)
    assert ours == jtr.load_postmortem(path)
    header = ours[0]
    assert header["reason"] == "guard_violation"
    assert header["context"]["guard_reason"] == "non-finite particle state"
    assert ttr.render_postmortem(*ours, top=8) == jtr.render_postmortem(*ours, top=8)
    assert ttr.main([path, "--postmortem"]) == 0
    text = capsys.readouterr().out
    assert text.startswith("postmortem: guard_violation")
    assert "context.guard_reason = non-finite particle state" in text
    assert ttr.main([path, "--postmortem", "--json"]) == 0
    doc = json.loads(capsys.readouterr().out)
    assert doc["header"] == header and doc["events"] == ours[3]


def test_cli_rows_equal_jax(traced_run, jtr, capsys):
    root, _, _ = traced_run
    path = str(root / "trace.jsonl")
    assert ttr.main([path, "--json", "--top", "3"]) == 0
    ours = json.loads(capsys.readouterr().out)
    assert jtr.main([path, "--json", "--top", "3"]) == 0
    theirs = json.loads(capsys.readouterr().out)
    assert ours["spans"] == theirs["spans"] and ours["top_self"] == theirs["top_self"]


# --------------------------------------------------------------------- #
# --stitch: exports of a fleet, written by either package's tracer


def _stitch_side(pkg):
    if pkg == "port":
        from dist_svgd_torch.serving import fleet
        from dist_svgd_torch.telemetry import metrics, trace
    else:
        from dist_svgd_tpu.serving import fleet
        from dist_svgd_tpu.telemetry import metrics, trace
    return fleet, trace, metrics.MetricsRegistry


#: Who writes the router's export and who the replicas': one package each
#: side, or the port's router over JAX's replicas.
WRITERS = {"port": ("port", "port"), "jax": ("jax", "jax"), "mixed": ("port", "jax")}


def _run_fleet_and_export(tmp_path, writer, n_requests=6, kill_one=True, trace=None):
    """Route through a 2-replica loopback fleet under the router side's
    global tracer (JAX's ``tests/test_trace_stitch.py`` fleet), export the
    router's and each replica's trace; returns (paths, served routes)."""
    rfleet, rtrace, rreg = _stitch_side(WRITERS[writer][0])
    pfleet, ptrace, preg = _stitch_side(WRITERS[writer][1])
    tracer = rtrace.enable()
    tracer.set_process("router", "router")
    rep_tracers = {r: ptrace.Tracer(registry=preg()) for r in ("ra", "rb")}
    reps = {r: pfleet.LoopbackReplica(r, tenants=["t0"], tracer=rep_tracers[r])
            for r in ("ra", "rb")}
    transport = rfleet.FakeTransport(reps)
    router = rfleet.FleetRouter(list(reps), transport=transport, registry=rreg(),
                                probe_interval_s=10.0)
    body = json.dumps({"inputs": [[0.1, 0.2]], "tenant": "t0"}).encode()
    served = 0
    try:
        for _ in range(n_requests):
            served += router.route("t0", body, trace=trace).status == 200
        if kill_one:
            victim = router.route("t0", body).replica
            served += 1
            transport.kill(victim)
            res = router.route("t0", body)  # retries to the survivor
            assert res.status == 200 and res.attempts > 1
            served += 1
    finally:
        router.shutdown()
        tracer = rtrace.disable()
    paths = [str(tmp_path / "router.json")]
    tracer.export_chrome(paths[0])
    for r, rt in rep_tracers.items():
        paths.append(str(tmp_path / f"{r}.json"))
        rt.export_chrome(paths[-1])
    return paths, served


def _stitched(tool, argv, capsys):
    rc = tool.main(argv)
    out = capsys.readouterr()
    return rc, out.out, out.err


@pytest.mark.parametrize("writer", sorted(WRITERS))
def test_stitch_golden_tree_with_retry_siblings_equals_jax(tmp_path, jtr, writer):
    paths, served = _run_fleet_and_export(tmp_path, writer)
    report = ttr.stitch_files(paths)
    assert report == jtr.stitch_files(paths)
    assert report["served_routes"] == served and report["coverage"] == 1.0
    assert report["orphan_replica_traces"] == 0
    retry = [t for t in report["trees"] if len(t["attempts"]) > 1]
    assert report["retry_trees"] >= 1 and retry
    attempts = retry[0]["attempts"]
    assert any("error" in a for a in attempts)
    serving = [a for a in attempts if "serve" in a]
    assert serving and serving[0]["serve"]["wire_gap_ms"] >= 0.0
    for hop in ("fleet.route", "fleet.attempt", "fleet.wire", "serve.request",
                "serve.dispatch"):
        assert report["hops"][hop]["count"] >= 1, hop
    assert ttr.render_stitch(report, top=3) == jtr.render_stitch(report, top=3)


@pytest.mark.parametrize("writer", sorted(WRITERS))
def test_stitch_duplicate_client_trace_ids_equal_jax(tmp_path, jtr, writer):
    """A client replaying one ``X-Fleet-Trace`` id yields one tree a route,
    never a merged pseudo-retry tree."""
    paths, _ = _run_fleet_and_export(tmp_path, writer, n_requests=3, kill_one=False,
                                     trace="5717CKed00000bad")
    report = ttr.stitch_files(paths)
    assert report == jtr.stitch_files(paths)
    assert report["router_routes"] == report["served_routes"] == 3
    assert report["coverage"] == 1.0 and report["retry_trees"] == 0
    assert all(len(t["attempts"]) == 1 for t in report["trees"])


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_stitch_orphan_replica_spans_equal_jax(tmp_path, jtr, writer):
    paths, _ = _run_fleet_and_export(tmp_path, writer, kill_one=False)
    _, trace, registry = _stitch_side(writer)
    stray = trace.Tracer(registry=registry())
    stray.set_process("replica", "stray")
    stray.lane_tree("serve.request", 0.0, 0.001,
                    {"trace": "dead000000000009", "replica": "stray"})
    paths.append(str(tmp_path / "stray.json"))
    stray.export_chrome(paths[-1])
    report = ttr.stitch_files(paths)
    assert report == jtr.stitch_files(paths)
    assert report["coverage"] == 1.0 and report["orphan_replica_traces"] == 1


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_stitch_missing_anchor_exits_2_like_jax(tmp_path, jtr, capsys, writer):
    paths, _ = _run_fleet_and_export(tmp_path, writer, kill_one=False)
    legacy = tmp_path / "legacy.json"
    doc = json.loads(Path(paths[1]).read_text())
    del doc["otherData"]
    legacy.write_text(json.dumps(doc))
    doc = json.loads(Path(paths[1]).read_text())
    del doc["otherData"]["process"]["anchor_unix_s"]
    no_anchor = tmp_path / "no_anchor.json"
    no_anchor.write_text(json.dumps(doc))
    for bad, says in ((legacy, "process-identity header"), (no_anchor, "clock anchor")):
        argv = ["--stitch", paths[0], str(bad)]
        ours, theirs = _stitched(ttr, argv, capsys), _stitched(jtr, argv, capsys)
        assert ours == theirs
        rc, _, err = ours
        assert rc == 2 and err.count("\n") == 1 and says in err


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_stitch_without_a_router_export_exits_2_like_jax(tmp_path, jtr, capsys, writer):
    paths, _ = _run_fleet_and_export(tmp_path, writer, kill_one=False)
    for argv in (["--stitch", paths[1], paths[2]],
                 ["--stitch", paths[0], str(tmp_path / "missing.json")]):
        ours, theirs = _stitched(ttr, argv, capsys), _stitched(jtr, argv, capsys)
        assert ours == theirs
        assert ours[0] == 2 and ours[2].count("\n") == 1
    assert "router" in _stitched(ttr, ["--stitch", paths[1], paths[2]], capsys)[2]


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_stitch_cli_json_and_human_equal_jax(tmp_path, jtr, capsys, writer):
    paths, _ = _run_fleet_and_export(tmp_path, writer)
    for argv in (["--stitch"] + paths + ["--json", "--top", "2"], ["--stitch"] + paths):
        ours, theirs = _stitched(ttr, argv, capsys), _stitched(jtr, argv, capsys)
        assert ours == theirs and ours[0] == 0
    doc = json.loads(_stitched(ttr, ["--stitch"] + paths + ["--json", "--top", "2"],
                               capsys)[1])
    assert doc["coverage"] == 1.0 and len(doc["trees"]) <= 2
    out = _stitched(ttr, ["--stitch"] + paths, capsys)[1]
    assert "coverage 1.0000" in out and "fleet.wire" in out
    # a router export still summarises as one trace file
    rc, out, _ = _stitched(ttr, [paths[0], "--json"], capsys)
    assert rc == 0 and "fleet.route" in json.loads(out)["spans"]


def test_stitch_excludes_the_other_modes(tmp_path, capsys):
    path = tmp_path / "t.json"
    path.write_text('{"traceEvents": []}')
    for argv in (["--stitch", "--postmortem", str(path)],
                 ["--stitch", "--programs", str(path)]):
        with pytest.raises(SystemExit) as ei:
            ttr.main(argv)
        assert ei.value.code == 2
        assert "mutually exclusive" in capsys.readouterr().err


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_programs_over_a_history_dir_equals_jax(tmp_path, jtr, capsys, writer):
    """``--programs DIR`` sums a telemetry history ring's window deltas:
    rings the port's and JAX's recorders write from the same dispatch
    sequence give both tools the same rows, the sums equal the final dump's,
    and an empty directory exits 2 like JAX's."""
    if writer == "port":
        from dist_svgd_torch.telemetry.history import HistoryRecorder
        from dist_svgd_torch.telemetry.metrics import MetricsRegistry
    else:
        from dist_svgd_tpu.telemetry.history import HistoryRecorder
        from dist_svgd_tpu.telemetry.metrics import MetricsRegistry
    reg = MetricsRegistry()
    secs = reg.histogram("svgd_prog_dispatch_seconds", "t")
    rows = reg.counter("svgd_prog_dispatch_rows_total", "t")
    nbytes = reg.counter("svgd_prog_dispatch_bytes_total", "t")
    rec = HistoryRecorder(reg, str(tmp_path / "ring"), clock=lambda: 0.0)
    rng = np.random.default_rng(5)
    for window in range(3):
        for label in ("serve.logreg", "serve.bnn")[: window + 1]:
            secs.observe(float(rng.uniform(1e-4, 1e-3)), label=label)
            rows.inc(8, label=label)
            nbytes.inc(256, label=label)
        rec.record_once()
    ring = str(tmp_path / "ring")
    ours = ttr.program_rows(ttr.load_program_dumps(ring))
    assert ours == jtr.program_rows(jtr.load_program_dumps(ring))
    assert ours["windows"] == 3
    final = ttr.program_rows([reg.dump()])
    for got, want in zip(ours["programs"], final["programs"]):
        assert got["label"] == want["label"]
        assert (got["dispatches"], got["rows"], got["bytes"]) == (
            want["dispatches"], want["rows"], want["bytes"])
        assert got["seconds"] == pytest.approx(want["seconds"], rel=1e-12)
    for tool in (ttr, jtr):
        assert tool.main(["--programs", ring, "--json"]) == 0
    doc_ours, doc_theirs = (json.loads(line) for line in
                            capsys.readouterr().out.strip().splitlines())
    assert doc_ours == doc_theirs
    (tmp_path / "empty").mkdir()
    for tool in (ttr, jtr):
        assert tool.main(["--programs", str(tmp_path / "empty")]) == 2
        err = capsys.readouterr().err.strip()
        assert len(err.splitlines()) == 1 and "no telemetry history records" in err


def test_bad_inputs_exit_like_jax(tmp_path, jtr, capsys):
    empty = tmp_path / "empty.json"
    empty.write_text('{"traceEvents": []}')
    corrupt = tmp_path / "corrupt.jsonl"
    corrupt.write_text('{"kind": "span", "name": "x", "ts": 1.0, "dur": 0.5}\n{oops\n')
    not_pm = tmp_path / "notpm.jsonl"
    not_pm.write_text('{"kind": "span"}\n')
    cases = [[str(tmp_path / "missing.json")], [str(empty)], [str(corrupt)],
             [str(not_pm), "--postmortem"], [str(empty), str(empty)]]
    for argv in cases:
        codes = []
        for tool in (ttr, jtr):
            try:
                codes.append(tool.main(argv))
            except SystemExit as e:  # argparse's usage error
                codes.append(e.code)
            err = capsys.readouterr().err.strip()
            assert err and "Traceback" not in err, argv
        assert codes[0] == codes[1] and codes[0] in (1, 2), argv
