"""The tracer's compact recording on the serving path, against the eager
construction it replaces.

The port's tracer keeps events as tuples and the batcher's lane trees as
one compact record a request, expanded only when the trace is read
(``Tracer.lane_trees``).  JAX's tracer (``dist_svgd_tpu/telemetry/
trace.py``, jax-free) builds the same events eagerly, one dict and one
locked append each.  Here a traced ``MicroBatcher`` run records through a
spy of the port's tracer, which logs every append and every batch of lane
trees as it happens; the log is replayed into JAX's tracer (events as the
dicts the port used to build, trees through ``lane_tree``), and the two
traces must be the same: the Chrome events (names, ``ts``, ``dur``, lanes,
tags), the counts, the drops past ``max_events`` and the drop counter, the
lane gauge, the flight recorder's ring and bundle, the exported file and
``trace_report --stitch`` / ``--postmortem`` on it."""

import json
import threading

import numpy as np
import pytest

from dist_svgd_torch.serving import MicroBatcher, PredictiveEngine
from dist_svgd_torch.serving import engine as tengine
from dist_svgd_torch.telemetry import metrics as tmetrics
from dist_svgd_torch.telemetry import trace as ttrace
from dist_svgd_torch.tools import trace_report as ttr
from dist_svgd_tpu.telemetry import metrics as jmetrics
from dist_svgd_tpu.telemetry import trace as jtrace

from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

#: Client threads × requests each: enough to coalesce multi-request batches
#: on one lane and to cross a small ``max_events``.
CLIENTS, PER_CLIENT = 4, 12


class SpyTracer(ttrace.Tracer):
    """The port's tracer, logging each recording call in order."""

    def __init__(self, **kw):
        super().__init__(**kw)
        self.log = []
        self._log_lock = threading.Lock()

    def _append(self, event):
        with self._log_lock:
            self.log.append(("event", event))
            super()._append(event)

    def lane_trees(self, expand, records, size):
        with self._log_lock:
            self.log.append(("trees", [(t0, t1, expand(*p)) for t0, t1, p in records]))
            super().lane_trees(expand, records, size)

    def spans(self, expand, payload, size):
        with self._log_lock:
            events = expand(threading.get_ident(), *payload)
            assert len(events) == size
            self.log.extend(("event", e) for e in events)
            super().spans(expand, payload, size)


def _replay(spy, max_events, recorder=None):
    """The spy's log through JAX's eager tracer: each event as the dict the
    port's tracer used to append, each tree through ``lane_tree``."""
    jt = jtrace.Tracer(max_events=max_events, registry=jmetrics.MetricsRegistry())
    jt._thread_names.update(spy._thread_names)
    jt._anchor_unix = spy._anchor_unix
    jt._process = dict(spy._process)
    if recorder is not None:
        jtrace.install_flight_recorder(recorder)
    try:
        for kind, item in spy.log:
            if kind == "event":
                # (ph, name, ts, dur, tid, k1, v1, ...): the tags flattened
                ph, name, ts, dur, tid = item[:5]
                args = dict(zip(item[5::2], item[6::2])) or None
                ev = {"ph": ph, "name": name, "ts": ts, "tid": tid, "args": args}
                if ph == "X":
                    ev = {"ph": ph, "name": name, "ts": ts, "dur": dur, "tid": tid,
                          "args": args}
                jt._append(ev)
            else:
                for t0, t1, (name, tags, children) in item:
                    jt.lane_tree(name, t0, t1, tags, children)
    finally:
        if recorder is not None:
            jtrace.uninstall_flight_recorder()
    return jt


def _traced_run(max_events, recorder=None, trace_ids=True):
    """A traced 1-lane batcher over a CPU logreg engine, CLIENTS threads
    submitting mixed 1/3/8/40-row requests (40 rows split into chunks),
    some with a router's trace id; returns the spy tracer and its
    registry."""
    rng = np.random.default_rng(3)
    parts = rng.normal(size=(64, 6)).astype(np.float32)
    engine = PredictiveEngine("logreg", parts, min_bucket=4, max_bucket=32, device="cpu")
    engine.warmup()
    reg = tmetrics.MetricsRegistry()
    spy = SpyTracer(max_events=max_events, registry=reg)
    spy.set_process("replica", "r0")
    batcher = MicroBatcher(engine.predict, max_batch=32, max_wait_ms=2.0,
                           registry=tmetrics.MetricsRegistry())
    xs = [rng.normal(size=(r, 5)).astype(np.float32) for r in (1, 3, 8, 40)]

    def client(c):
        for j in range(PER_CLIENT):
            trace = f"feed{c:04x}{j:08x}" if trace_ids and j % 2 else None
            batcher.submit(xs[(c + j) % len(xs)], tenant=None, trace=trace).result()

    if recorder is not None:
        ttrace.install_flight_recorder(recorder)
    ttrace._TRACER = spy
    try:
        threads = [threading.Thread(target=client, args=(c,)) for c in range(CLIENTS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    finally:
        ttrace._TRACER = None
        batcher.close()
        if recorder is not None:
            ttrace.uninstall_flight_recorder()
    return spy, reg


@pytest.mark.parametrize("max_events", [1_000_000, 37])
def test_traced_batcher_events_equal_the_eager_construction(max_events):
    spy, reg = _traced_run(max_events)
    jt = _replay(spy, max_events)
    assert sum(1 for kind, _ in spy.log if kind == "trees") > 1
    assert spy.chrome_events() == jt.chrome_events()
    assert spy.counts() == jt.counts()
    assert spy.dropped_events == jt.dropped_events
    assert reg.counter("svgd_trace_dropped_total").value() == spy.dropped_events
    assert reg.gauge("svgd_trace_lanes").value() == len(jt._lanes) == len(spy._lanes)
    if max_events < 1000:
        assert spy.dropped_events > 0
        assert sum(spy.counts().values()) == max_events
    else:
        assert spy.dropped_events == 0
        assert spy.counts()["serve.request"] == CLIENTS * PER_CLIENT


def test_flight_recorder_ring_and_postmortem_equal_the_eager_construction(tmp_path):
    rec = ttrace.FlightRecorder(capacity=50, dump_dir=str(tmp_path / "t"),
                                registry=tmetrics.MetricsRegistry(), clock=lambda: 7.0)
    spy, _ = _traced_run(40, recorder=rec)
    jrec = jtrace.FlightRecorder(capacity=50, dump_dir=str(tmp_path / "j"),
                                 registry=jmetrics.MetricsRegistry(), clock=lambda: 7.0)
    _replay(spy, 40, recorder=jrec)
    # the ring keeps the newest 50 events, past the tracer's cap of 40
    assert rec.events() == jrec.events() and len(rec.events()) == 50
    paths = [r.dump("drill", context={"step": 1}) for r in (rec, jrec)]
    bundles = [[json.loads(x) for x in open(p)] for p in paths]
    for b in bundles:
        b[1]["snapshot"] = None  # the two registries hold different series
    assert bundles[0] == bundles[1]
    out = [ttr.render_postmortem(*ttr.load_postmortem(p)) for p in paths]
    assert out[0] == out[1] and "serve.request" in out[0]


def test_export_and_stitch_equal_the_eager_construction(tmp_path):
    spy, _ = _traced_run(1_000_000)
    jt = _replay(spy, 1_000_000)
    paths = {}
    for name, tr in (("port", spy), ("eager", jt)):
        paths[name] = str(tmp_path / f"{name}.json")
        tr.export_chrome(paths[name])
    docs = [json.loads(open(paths[k]).read()) for k in ("port", "eager")]
    assert docs[0] == docs[1]
    # a router export routing each traced request, on the same clock
    router = jtrace.Tracer(registry=jmetrics.MetricsRegistry())
    router.set_process("router", "router")
    router._anchor_unix = spy._anchor_unix
    traced = [e for e in docs[0]["traceEvents"]
              if e.get("name") == "serve.request" and "trace" in e.get("args", {})]
    assert traced
    for e in traced:
        t0, t1 = e["ts"] / 1e6 - 1e-4, (e["ts"] + e["dur"]) / 1e6 + 1e-4
        tid = e["args"]["trace"]
        router.lane_tree("fleet.route", t0, t1,
                         {"tenant": "t0", "status": 200, "attempts": 1,
                          "outcome": "served", "replica": "r0", "trace": tid},
                         children=[("fleet.attempt", t0, t1,
                                    {"n": 0, "replica": "r0", "status": 200,
                                     "hedged": False, "trace": tid}),
                                   ("fleet.forward", t0, t1, {"replica": "r0"})])
    router_path = str(tmp_path / "router.json")
    router.export_chrome(router_path)
    reports = [ttr.stitch_files([router_path, paths[k]]) for k in ("port", "eager")]
    for r in reports:
        assert [f["name"] for f in r.pop("files")] == ["router", "r0"]
    assert reports[0] == reports[1]
    assert reports[0]["coverage"] == 1.0 and reports[0]["served_routes"] == len(traced)


def test_kept_records_are_flat_and_untracked_by_the_collector():
    """Every record the tracer keeps is one flat tuple of numbers, strings
    and None, which CPython's collector stops tracking: a long trace adds
    nothing to the process's full collections."""
    import gc

    spy, _ = _traced_run(1_000_000)
    gc.collect()
    assert spy._events and not any(gc.is_tracked(r) for r in spy._events)
    assert all(type(v) in (str, int, float, type(None)) for r in spy._events for v in r)


def _engine_events(engine_mod, trace_mod, metrics_mod, parts, calls):
    """(name, args) of every event a traced engine of ``engine_mod``
    records over ``calls`` (each ``fn(engine)``; a raise is recorded and
    swallowed), in recording order."""
    engine = engine_mod.PredictiveEngine("logreg", parts, min_bucket=4, max_bucket=16,
                                         **({"device": "cpu"} if engine_mod is tengine else {}))
    engine.warmup()
    tracer = trace_mod.Tracer(registry=metrics_mod.MetricsRegistry())
    trace_mod._TRACER = tracer
    try:
        for fn in calls:
            try:
                fn(engine, trace_mod)
            except (RuntimeError, ValueError) as e:
                assert "boom" in str(e) or "candidate" in str(e)
    finally:
        trace_mod._TRACER = None
    return [(e["name"], e.get("args")) for e in tracer.chrome_events() if e["ph"] != "M"]


def test_engine_spans_equal_jax_spans_with_pads_errors_and_instants():
    """The engine's compact span record against JAX's three nested spans:
    padded and unpadded batches, a trace context, a missing candidate, a
    program that raises, and an instant inside the dispatch."""
    from dist_svgd_tpu.serving import engine as jengine

    parts = np.random.default_rng(5).normal(size=(32, 6)).astype(np.float32)
    x3, x8 = (np.random.default_rng(6).normal(size=(r, 5)).astype(np.float32) for r in (3, 8))

    def boom(engine, trace_mod):
        fn, _ = engine._kernel_for(8, "serving")

        def raising(*a):
            trace_mod.instant("kernel_build", {"name": "probe"})
            raise RuntimeError("boom")

        engine._kernels[8] = raising
        try:
            engine.predict(x8)
        finally:
            engine._kernels[8] = fn

    def traced(engine, trace_mod):
        prev = trace_mod.set_trace_context("00ff00ff00ff00ff")
        try:
            engine.predict(x3)
        finally:
            trace_mod.set_trace_context(prev)

    calls = [lambda e, t: e.predict(x3), lambda e, t: e.predict(x8), traced,
             lambda e, t: e.predict(x8, generation="candidate"), boom]
    ours = _engine_events(tengine, ttrace, tmetrics, parts, calls)
    theirs = _engine_events(jengine, jtrace, jmetrics, parts, calls)
    assert ours == theirs
    names = [n for n, _ in ours]
    assert names.count("engine.pad") == 2 and ("kernel_build", {
        "name": "probe", "in_span": "engine.dispatch"}) in ours
    assert ("engine.dispatch", {"bucket": 8, "error": "RuntimeError"}) in ours
