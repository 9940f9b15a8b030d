"""The port's telemetry core (``dist_svgd_torch/telemetry/metrics.py``,
``trace.py``) against the JAX package's (``tests/test_telemetry.py``), on
the CPU.

The same call sequences, with injected clocks, go to both packages'
registries, tracers and flight recorders: the Prometheus exposition, the
``dump`` / ``ingest`` / ``dump_delta`` / ``snapshot`` dicts, histogram
quantiles and the Chrome trace events are equal (the process header, whose
pid and wall anchor differ by construction, aside).  The disabled paths are
pinned allocation-free with ``tracemalloc``; ``StepTimer(span_name=)`` and
the samplers' ``train.step_chunk`` / ``train.dispatch`` spans are counted
against the dispatches of JAX's planner; the kernel builder's
``kernel_build`` instant is checked with a stand-in compiler."""

import json
import os
import threading
import tracemalloc
import warnings

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import dist_svgd_tpu as jdt
from dist_svgd_tpu import telemetry as jtel
from dist_svgd_tpu.models.gmm import gmm_logp as jgmm_logp
from dist_svgd_tpu.telemetry import metrics as jmetrics
from dist_svgd_tpu.telemetry import trace as jtrace

import dist_svgd_torch as tdt
from dist_svgd_torch import telemetry as ttel
from dist_svgd_torch.models.gmm import gmm_logp
from dist_svgd_torch.ops import _build
from dist_svgd_torch.telemetry import metrics as tmetrics
from dist_svgd_torch.telemetry import trace as ttrace
from dist_svgd_torch.utils.metrics import JsonlLogger, StepTimer

from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)


class ManualClock:
    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t

    def advance(self, s):
        self.t += s


def registry_script(mod, max_label_sets=None):
    """One call sequence on a fresh registry of ``mod`` (JAX's or the
    port's metrics module); returns the registry."""
    reg = mod.MetricsRegistry() if max_label_sets is None else mod.MetricsRegistry(
        max_label_sets=max_label_sets)
    c = reg.counter("svgd_req_total", "requests served")
    c.inc()
    c.inc(4, route="/predict", status=200)
    c.inc(2.5, route="/predict", status=503)
    g = reg.gauge("svgd_queue_depth", "queued rows")
    g.set(7)
    g.set(3.25, tenant='a"b\\c\nd')
    h = reg.histogram("svgd_latency_seconds", "request latency")
    for i, v in enumerate((0.00005, 0.0002, 0.003, 0.003, 0.05, 0.7, 12.0, 99.0)):
        h.observe(v, route="/p" if i % 2 else "/q")
    h2 = reg.histogram("svgd_small_seconds", "custom buckets", buckets=(0.1, 1.0, 10.0))
    for v in (0.05, 0.5, 5.0, 50.0):
        h2.observe(v)
    return reg


@pytest.fixture
def both():
    return registry_script(jmetrics), registry_script(tmetrics)


# --------------------------------------------------------------------- #
# the registry against JAX's


def test_exposition_dump_snapshot_equal_jax(both):
    jreg, treg = both
    assert treg.exposition() == jreg.exposition()
    assert treg.dump() == jreg.dump()
    assert treg.snapshot() == jreg.snapshot()


@pytest.mark.parametrize("q", [0.0, 0.25, 0.5, 0.9, 0.99, 1.0])
def test_histogram_quantiles_and_summary_equal_jax(both, q):
    jreg, treg = both
    jh, th = jreg.histogram("svgd_latency_seconds"), treg.histogram("svgd_latency_seconds")
    for labels in ({"route": "/p"}, {"route": "/q"}, {"route": "/none"}):
        assert th.quantile(q, **labels) == jh.quantile(q, **labels)
        assert th.summary(**labels) == jh.summary(**labels)
    assert tmetrics.LATENCY_BUCKETS_S == jmetrics.LATENCY_BUCKETS_S


def test_dump_delta_and_ingest_equal_jax(both):
    jreg, treg = both
    jprev, tprev = jreg.dump(), treg.dump()
    for reg in (jreg, treg):
        reg.counter("svgd_req_total").inc(3, route="/predict", status=200)
        reg.histogram("svgd_latency_seconds").observe(0.004, route="/p")
        reg.gauge("svgd_queue_depth").set(11)
    assert tmetrics.dump_delta(tprev, treg.dump()) == jmetrics.dump_delta(jprev, jreg.dump())
    assert tmetrics.dump_delta(None, treg.dump()) == jmetrics.dump_delta(None, jreg.dump())
    # a reset (a restarted process) clamps to a zero window, never negative
    fresh_t, fresh_j = tmetrics.MetricsRegistry(), jmetrics.MetricsRegistry()
    fresh_t.counter("svgd_req_total").inc(1)
    fresh_j.counter("svgd_req_total").inc(1)
    assert (tmetrics.dump_delta(treg.dump(), fresh_t.dump())
            == jmetrics.dump_delta(jreg.dump(), fresh_j.dump()))
    # ingest: the port reads JAX's dump (the wire format) and vice versa
    jin, tin = jmetrics.MetricsRegistry(), tmetrics.MetricsRegistry()
    tin.ingest(jreg.dump(), labels={"replica": "r0"})
    jin.ingest(treg.dump(), labels={"replica": "r0"})
    tin.ingest(jreg.dump(), labels={"replica": "r1"}, skip_gauges=True)
    jin.ingest(treg.dump(), labels={"replica": "r1"}, skip_gauges=True)
    assert tin.exposition() == jin.exposition() and tin.dump() == jin.dump()


def test_combined_exposition_and_merge_series_equal_jax(both):
    jreg, treg = both
    jother, tother = jmetrics.MetricsRegistry(), tmetrics.MetricsRegistry()
    for reg in (jother, tother):
        reg.counter("svgd_req_total", "requests served").inc(9, replica="r2")
        reg.gauge("svgd_queue_depth", "queued rows").set(1)
        reg.counter("svgd_only_here_total").inc()
    assert tmetrics.combined_exposition(treg, tother) == jmetrics.combined_exposition(
        jreg, jother)
    jh, th = jreg.histogram("svgd_latency_seconds"), treg.histogram("svgd_latency_seconds")
    for h in (jh, th):
        h.merge_series([1] * (len(tmetrics.LATENCY_BUCKETS_S) + 1), 3.5, 19, route="/all")
    assert treg.exposition() == jreg.exposition()


def test_label_cardinality_cap_and_warning_equal_jax():
    outs = []
    for mod in (jmetrics, tmetrics):
        reg = mod.MetricsRegistry(max_label_sets=3)
        c = reg.counter("svgd_tenant_total")
        h = reg.histogram("svgd_tenant_seconds", max_label_sets=2)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            for i in range(6):
                c.inc(i + 1, tenant=f"t{i}")
                h.observe(0.01 * (i + 1), tenant=f"t{i}")
        outs.append((reg.exposition(), reg.dump(),
                     sorted(str(w.message) for w in caught)))
    assert outs[0] == outs[1]
    assert any("other" in line for line in outs[1][0].splitlines())


def test_registry_type_conflicts_and_errors_equal_jax():
    for mod in (jmetrics, tmetrics):
        reg = mod.MetricsRegistry()
        reg.counter("x_total")
        with pytest.raises(ValueError):
            reg.gauge("x_total")
        with pytest.raises(ValueError, match="decrease"):
            reg.counter("x_total").inc(-1)
        with pytest.raises(ValueError):
            reg.histogram("bad_seconds", buckets=(1.0, 0.5))


def test_default_registry_is_one_process_wide_instance():
    assert tmetrics.default_registry() is tmetrics.default_registry()
    assert ttel.default_registry is tmetrics.default_registry


def test_registry_thread_safety_exact_counts():
    reg = tmetrics.MetricsRegistry()
    c, h = reg.counter("t_total"), reg.histogram("t_seconds")

    def work():
        for _ in range(500):
            c.inc(route="/p")
            h.observe(0.001)

    threads = [threading.Thread(target=work) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert c.value(route="/p") == 4000 and h.summary()["count"] == 4000


# --------------------------------------------------------------------- #
# the tracer against JAX's


def tracer_script(mod, jsonl=None, max_events=1_000_000):
    """Spans, instants, a failing span, ``complete``, lane trees and drops
    on a tracer of ``mod`` with an injected clock."""
    clock = ManualClock(100.0)
    tracer = mod.Tracer(clock=clock, max_events=max_events, jsonl=jsonl,
                        registry=(jmetrics if mod is jtrace else tmetrics).MetricsRegistry())
    with tracer.span("train.outer", {"k": 1}) as sp:
        clock.advance(0.25)
        tracer.instant("mark", {"x": 2})
        with tracer.span("train.inner"):
            clock.advance(0.5)
        sp.tag(extra="yes")
    with pytest.raises(RuntimeError):
        with tracer.span("boom"):
            clock.advance(0.125)
            raise RuntimeError("x")
    tracer.complete("train.step", 0.0, 0.75, {"steps": 3})
    tracer.lane_tree("req.a", 1.0, 2.0, {"tenant": "a"}, [("queue", 1.0, 1.5),
                                                         ("device", 1.5, 2.5, {"b": 1})])
    tracer.lane_tree("req.b", 1.5, 3.0)
    tracer.lane_tree("req.c", 2.25, 2.0)
    for i in range(3):
        clock.advance(0.001)
        tracer.instant(f"tail{i}")
    return tracer


def test_chrome_events_and_counts_equal_jax():
    jt, tt = tracer_script(jtrace), tracer_script(ttrace)
    assert tt.chrome_events() == jt.chrome_events()
    assert tt.counts() == jt.counts()
    assert tt.dropped_events == jt.dropped_events == 0


def test_max_events_drops_and_counts_equal_jax():
    jt, tt = tracer_script(jtrace, max_events=5), tracer_script(ttrace, max_events=5)
    assert tt.chrome_events() == jt.chrome_events()
    assert tt.dropped_events == jt.dropped_events > 0
    with pytest.raises(ValueError, match="max_events"):
        ttrace.Tracer(max_events=0)


def test_export_chrome_parses_and_equals_jax_but_the_process_header(tmp_path):
    jt, tt = tracer_script(jtrace), tracer_script(ttrace)
    docs = []
    for tracer, name in ((jt, "j.json"), (tt, "t.json")):
        path = str(tmp_path / name)
        n = tracer.export_chrome(path)
        with open(path) as fh:
            doc = json.load(fh)
        assert len(doc["traceEvents"]) == n
        docs.append(doc)
    jproc, tproc = (d["otherData"].pop("process") for d in docs)
    assert docs[0] == docs[1]
    assert set(tproc) == set(jproc) and tproc["pid"] == os.getpid()
    ts = [e["ts"] for e in docs[1]["traceEvents"] if e["ph"] in ("X", "i")]
    assert ts == sorted(ts)


def test_jsonl_mirrors_events_as_jax_does(tmp_path):
    recs = []
    for mod, name in ((jtrace, "j.jsonl"), (ttrace, "t.jsonl")):
        path = str(tmp_path / name)
        with JsonlLogger(path=path) as logger:
            tracer_script(mod, jsonl=logger)
        lines = [json.loads(x) for x in open(path)]
        assert lines[0]["kind"] == "process" and lines[0]["anchor_trace_s"] == 0.0
        recs.append([{k: v for k, v in r.items() if k not in ("ts", "tid")}
                     for r in lines if r["kind"] != "process"])
    assert recs[0] == recs[1]


def test_process_identity_and_trace_context():
    tracer = ttrace.Tracer()
    assert tracer.process_meta()["role"] == "process"
    tracer.set_process(role="router", name="r0")
    assert tracer.set_process(role="replica", only_if_default=True)["role"] == "router"
    assert ttrace.TRACE_HEADER == jtrace.TRACE_HEADER
    a, b = ttrace.mint_trace_id(), ttrace.mint_trace_id()
    assert a != b and len(a) == 16
    prev = ttrace.set_trace_context(a)
    assert ttrace.get_trace_context() == a
    ttrace.set_trace_context(prev)


def test_flight_recorder_bundle_equals_jax(tmp_path):
    bundles = []
    for mod, mmod, sub in ((jtrace, jmetrics, "j"), (ttrace, tmetrics, "t")):
        reg = registry_script(mmod)
        rec = mod.FlightRecorder(capacity=4, dump_dir=str(tmp_path / sub), registry=reg,
                                 clock=ManualClock(5.0))
        assert mod.install_flight_recorder(rec) is rec
        assert mod.install_flight_recorder() is rec  # idempotent while installed
        try:
            tracer = tracer_script(mod)
            mod.record_flight("guard", trip="nan", step=4)
            mod.record_flight("diagnostics", ksd=0.5, step=4)
            path = rec.dump("guard trip: nan!", context={"step": 4})
        finally:
            assert mod.uninstall_flight_recorder() is rec
        assert mod.flight_recorder() is None
        mod.record_flight("ignored")  # no recorder: a no-op
        assert os.path.basename(path) == "postmortem_001_guard_trip_nan_.jsonl"
        assert rec.last_diagnostics["ksd"] == 0.5 and rec.dumps == 1
        assert tracer.counts()
        bundles.append([json.loads(x) for x in open(path)])
    assert bundles[0] == bundles[1]
    with pytest.raises(ValueError, match="capacity"):
        ttrace.FlightRecorder(capacity=0)


def test_enable_disable_idempotent_and_global_span():
    try:
        t1 = ttel.enable()
        assert ttel.enable() is t1 and ttel.enabled() and ttel.get_tracer() is t1
        with ttel.span("g.outer", {"k": 1}):
            ttel.instant("g.mark")
        assert t1.counts() == {"g.outer": 1, "g.mark": 1}
    finally:
        out = ttel.disable()
    assert out is t1 and ttel.disable() is None and not ttel.enabled()


def test_disabled_paths_are_shared_noops_and_allocation_free():
    """Module-level span()/instant()/record_flight(), the diagnostics
    singleton and an untraced StepTimer mark allocate nothing in their
    modules while telemetry is off."""
    from dist_svgd_torch.telemetry import diagnostics

    assert not ttrace.enabled() and ttrace.flight_recorder() is None
    assert ttrace.span("x") is ttrace.span("y")
    sp = ttrace.span("x")
    assert sp.fence(42) == 42 and sp.tag(a=1) is sp
    timer = StepTimer(span_name="lap")

    def loop():
        for t in range(200):
            with ttrace.span("hot"):
                pass
            ttrace.instant("mark")
            ttrace.record_flight("k")
            diagnostics.DISABLED.should_run(t)
            diagnostics.DISABLED.compute(None)

    loop()
    tracemalloc.start()
    try:
        filters = [tracemalloc.Filter(True, ttrace.__file__),
                   tracemalloc.Filter(True, diagnostics.__file__)]
        before = tracemalloc.take_snapshot().filter_traces(filters)
        loop()
        after = tracemalloc.take_snapshot().filter_traces(filters)
    finally:
        tracemalloc.stop()
    grown = sum(max(s.size_diff, 0) for s in after.compare_to(before, "lineno"))
    assert grown == 0, f"disabled telemetry path allocated {grown} bytes"
    timer.mark()
    assert len(timer.laps) == 1


def test_fence_waits_only_for_cuda_tensors(monkeypatch):
    calls = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda dev=None: calls.append(dev))
    assert ttrace.fence(torch.ones(3)) is False
    assert ttrace.fence({"a": [torch.ones(2), (torch.zeros(1),)]}) is False
    assert ttrace.fence(None) is False and calls == []
    tracer = ttrace.Tracer()
    with tracer.span("s") as sp:
        out = sp.fence(torch.ones(2) * 2)
    assert float(out[0]) == 2.0 and tracer.counts() == {"s": 1} and calls == []


def test_package_surface_matches_jax():
    assert ttel.__all__ == jtel.__all__
    for name in ("DiagnosticsConfig", "PosteriorDiagnostics", "ReloadPolicy",
                 "ensemble_health", "SloEngine", "GaugeCeiling", "DispatchProfiler",
                 "enable_profiler", "disable_profiler", "get_profiler", "profiler_enabled",
                 "UsageMeter", "usage_summary", "TelemetryHistory", "HistoryRecorder"):
        assert getattr(ttel, name).__module__.startswith("dist_svgd_torch.telemetry.")
    for name in ("TelemetryHistory", "HistoryRecorder"):
        ours, theirs = getattr(ttel, name), getattr(jtel, name)
        assert ours.__module__ == theirs.__module__.replace("dist_svgd_tpu", "dist_svgd_torch")
        assert [m for m in vars(ours) if not m.startswith("__")] == [
            m for m in vars(theirs) if not m.startswith("__")]
    with pytest.raises(AttributeError):
        ttel.no_such_name  # noqa: B018


def test_kernel_build_records_an_instant_inside_the_active_span(tmp_path, monkeypatch):
    """A stand-in compiler that writes its ``-o`` target: each real build
    is a ``kernel_build`` instant in the enclosing span; a cached build is
    none."""
    fake = tmp_path / "nvcc"
    fake.write_text('#!/bin/sh\nwhile [ "$1" != "-o" ]; do shift; done\ntouch "$2"\n')
    fake.chmod(0o755)
    monkeypatch.setattr(_build, "find_nvcc", lambda: str(fake))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    tracer = ttel.enable()
    try:
        with ttel.span("train.step"):
            _build.build(["phi_small_d", "ot_kexp"])
        _build.build(["phi_small_d"])  # cached: no instant
    finally:
        ttel.disable()
    instants = [e for e in tracer.chrome_events() if e["ph"] == "i"]
    assert sorted(e["args"]["kernel"] for e in instants) == ["ot_kexp", "phi_small_d"]
    assert all(e["name"] == "kernel_build" and e["args"]["in_span"] == "train.step"
               for e in instants)


# --------------------------------------------------------------------- #
# the samplers' spans against JAX's planner


def dist_logp(theta, _data=None):
    return gmm_logp(theta)


def jdist_logp(theta, _data=None):
    return jgmm_logp(theta)


SPAN_NAMES = ("train.step_chunk", "train.dispatch")


@pytest.mark.parametrize("impl,kw", [
    ("gather", dict(dispatch_budget=1.0, pairs_per_sec=2 * 64 * 64)),   # scan_chunks
    ("ring", dict(hops_per_dispatch=1)),                                 # intra_step
    ("ring", dict(hops_per_dispatch=3)),
    ("gather", dict(dispatch_budget=1e9)),                               # monolithic
    ("gather", dict()),
])
def test_distsampler_span_counts_equal_jax_dispatches(impl, kw):
    p0 = np.random.default_rng(0).normal(size=(64, 2))
    common = dict(exchange_particles=True, exchange_scores=False, include_wasserstein=False,
                  exchange_impl=impl)
    jd = jdt.DistSampler(4, jdist_logp, None, jnp.asarray(p0), mesh=None, phi_impl="xla",
                         **common)
    td = tdt.DistSampler(4, dist_logp, None, p0, phi_impl="torch", device="cpu", **common)
    counts = []
    for tel, sampler in ((jtel, jd), (ttel, td)):
        tracer = tel.enable()
        try:
            sampler.run_steps(4, 0.05, **kw)
        finally:
            tel.disable()
        counts.append({k: v for k, v in tracer.counts().items() if k in SPAN_NAMES})
    assert counts[1] == counts[0]
    assert sum(counts[1].values()) == td.last_run_stats["num_dispatches"] \
        or td.last_run_stats["execution"] == "eager"


@pytest.mark.parametrize("kw", [dict(dispatch_budget=1.0, pairs_per_sec=3 * 32 * 32),
                                dict(dispatch_budget=1e9)])
def test_sampler_span_counts_equal_jax_dispatches(kw):
    counts = []
    for tel, sampler in ((jtel, jdt.Sampler(2, jgmm_logp)),
                         (ttel, tdt.Sampler(2, gmm_logp, device="cpu"))):
        tracer = tel.enable()
        try:
            sampler.run(32, 7, 0.05, record=False, **kw)
        finally:
            tel.disable()
        counts.append(tracer.counts().get("train.step_chunk"))
        assert counts[-1] == sampler.last_run_stats["num_dispatches"]
    assert counts[0] == counts[1]


def test_dispatch_spans_carry_fenced_tags():
    p0 = np.random.default_rng(1).normal(size=(32, 2))
    td = tdt.DistSampler(4, dist_logp, None, p0, exchange_impl="ring", phi_impl="torch",
                         include_wasserstein=False, exchange_scores=False, device="cpu")
    for timed in (False, True):
        tracer = ttel.enable()
        try:
            td.run_steps(1, 0.05, hops_per_dispatch=2, time_dispatches=timed)
        finally:
            ttel.disable()
        spans = [e for e in tracer.chrome_events() if e.get("name") == "train.dispatch"]
        assert len(spans) == td.last_run_stats["num_dispatches"] == 3
        assert all(e["args"]["fenced"] is timed and e["args"]["fn"] for e in spans)


def test_steptimer_span_bridge():
    tracer = ttel.enable()
    try:
        timer = StepTimer(span_name="bench.lap")
        timer.mark()
        timer.mark(torch.ones(3))
    finally:
        ttel.disable()
    assert tracer.counts() == {"bench.lap": 2}
