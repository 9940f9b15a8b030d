"""Serving load generator: closed- and open-loop traffic against the
micro-batched predictive engine, one BENCH-style JSON row out.

Counterpart of ``tools/serve_bench.py`` (its rows' keys).  Two loops,
because they answer different questions:

- **closed loop** (``--clients`` threads, each issuing its next request
  only after the previous resolves) measures sustainable throughput and
  the latency the system settles into at its own pace;
- **open loop** (requests issued on a fixed-rate schedule regardless of
  completions, latency measured from the *scheduled* arrival) is the honest
  latency probe at a target arrival rate, and shows shed-on-overflow doing
  its job when the rate exceeds capacity.

The timed window excludes engine warm-up (every padding bucket built — one
CUDA graph each on the card), so ``recompiles`` reports steady-state
bucket-cache misses — the engine's contract is that this is 0.  The window
additionally runs under ``parallel/plan.py:capture_sentry``:
``sentry_compiles`` counts every new program shape (a graph capture on the
card) and every hand-kernel build inside it, not just bucket-cache misses —
the counter that catches a per-request-shape pad or slice the bucket
counter is blind to.  Both must be 0.

In-process by default (engine + batcher, no network noise); ``--url``
points the closed loop at a live ``serving.server`` instead.

``--lanes N`` runs N batcher worker lanes over the shared engine;
``--dtype bfloat16`` serves the low-precision programs and stamps the
same-session ``dtype_speedup`` against an f32 reference loop.
``--devices N`` (N > 1) shards across devices: ROADMAP A10.2, not ported
(``NotImplementedError``).

Multi-tenant registry: ``--tenants N`` hosts N heterogeneous tenants (mixed
logreg/BNN/GMM shapes, cycled) behind ONE ``serving.registry.
ModelRegistry`` and emits the ``serve_multitenant`` row: per-tenant
rps/p50/p99, ``tenant_fairness``, sentry-verified zero steady-state
captures in the timed window, and two off-window drills: an **eviction
probe** (a cold tenant added past the LRU bucket bound must evict the
least-recently-used bucket — ``evictions`` ≥ 1) and a **quota probe** (a
hog tenant over its inflight-rows quota must shed before a polite tenant
when the bounded queue fills — ``quota_sheds`` ≥ 1).

``--ab-telemetry N`` emits the ``telemetry_overhead`` row instead
(interleaved tracer-off/on rounds), ``--ab-profiler N`` the
``profiler_overhead`` row (the dispatch profiler and the usage meter off
and on, interleaved closed-loop rounds, and their added seconds a batch
on the dispatch path; JAX's gate is 3%).  ``--trace PATH`` enables the span
tracer for the window and exports a Chrome trace.

Runs on the card unless ``--device cpu``::

    python -m dist_svgd_torch.tools.serve_bench                       # the card
    python -m dist_svgd_torch.tools.serve_bench --device cpu --n-particles 512 \
        --requests 200
"""

import argparse
import json
import threading
import time

import numpy as np

from dist_svgd_torch import telemetry
from dist_svgd_torch.models.bnn import num_params
from dist_svgd_torch.parallel.plan import capture_sentry
from dist_svgd_torch.serving import MicroBatcher, ModelRegistry, PredictiveEngine
from dist_svgd_torch.serving.batcher import Overloaded, _percentile
from dist_svgd_torch.serving.engine import bucket_for
from dist_svgd_torch.telemetry import profile as _profile
from dist_svgd_torch.telemetry import usage as _usage
from dist_svgd_torch.telemetry.diagnostics import ensemble_health
from dist_svgd_torch.telemetry.slo import default_serving_slos


def _platform(engine) -> str:
    """JAX's platform word for the device the engine serves on."""
    return "gpu" if engine.device.type == "cuda" else "cpu"


def _check_devices(devices):
    if devices and devices > 1:
        raise NotImplementedError(
            f"--devices {devices}: serving across more than one device is not "
            "ported to PyTorch yet (ROADMAP A10.2)")


def build_engine(model="logreg", n_particles=10_000, n_features=54,
                 checkpoint=None, seed=0, max_bucket=256, registry=None,
                 devices=1, dtype=None, device=None):
    """Checkpointed ensemble when given, else a seeded synthetic one —
    serving throughput depends on shapes, not on convergence.  ``dtype``
    opts into the low-precision serve programs; ``devices > 1`` raises
    (ROADMAP A10.2)."""
    _check_devices(devices)
    kw = dict(max_bucket=max_bucket, registry=registry, dtype=dtype, device=device)
    if checkpoint:
        source = checkpoint if len(checkpoint) > 1 else checkpoint[0]
        return PredictiveEngine.from_checkpoint(
            source, model, n_features=n_features if model == "bnn" else None, **kw)
    rng = np.random.default_rng(seed)
    if model == "logreg":
        parts = rng.normal(size=(n_particles, 1 + n_features))
    elif model == "bnn":
        parts = rng.normal(size=(n_particles, num_params(n_features)))
    else:  # gmm
        parts = rng.normal(size=(n_particles, n_features))
    return PredictiveEngine(
        model, parts.astype(np.float32),
        n_features=n_features if model == "bnn" else None, **kw)


def _request_pool(feature_dim, rows_cycle, pool=256, seed=1):
    """Pre-generated request arrays (generation cost must not be timed)."""
    rng = np.random.default_rng(seed)
    return [
        rng.normal(size=(rows_cycle[i % len(rows_cycle)], feature_dim))
        .astype(np.float32)
        for i in range(pool)
    ]


def request_pool_by_size(feature_dim, sizes, per_size=32, seed=1):
    """Pre-generated request arrays keyed by row count — the shared
    request-pool plumbing: ``tools/workload_replay.py`` draws heavy-tailed
    per-event sizes from a trace and picks a pre-built array of exactly
    that size here, so request generation is never on the replay's timed
    path (the same discipline ``_request_pool`` gives the fixed-cycle
    loops).  The same arrays as JAX's on the same arguments."""
    rng = np.random.default_rng(seed)
    return {int(r): [rng.normal(size=(int(r), feature_dim))
                     .astype(np.float32) for _ in range(per_size)]
            for r in sorted({int(r) for r in sizes})}


def closed_loop(submit, pool, clients, requests):
    """`clients` threads, next request only after the last resolved."""
    lock = threading.Lock()
    issued = [0]
    lats, shed = [], [0]

    def worker():
        while True:
            with lock:
                if issued[0] >= requests:
                    return
                i = issued[0]
                issued[0] += 1
            t0 = time.perf_counter()
            try:
                submit(pool[i % len(pool)]).result(timeout=60)
            except Overloaded:
                with lock:
                    shed[0] += 1
                continue
            lat = (time.perf_counter() - t0) * 1e3
            with lock:
                lats.append(lat)

    threads = [threading.Thread(target=worker) for _ in range(clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    lats.sort()
    return {
        "wall_s": wall,
        "completed": len(lats),
        "shed": shed[0],
        "rps": len(lats) / wall if wall > 0 else 0.0,
        "p50_ms": _percentile(lats, 0.50),
        "p99_ms": _percentile(lats, 0.99),
    }


def open_loop(submit, pool, rate_rps, requests):
    """Fixed-rate arrivals; latency from the scheduled arrival time, so a
    backed-up queue is charged to the system, not hidden by the generator
    (no coordinated omission)."""
    lock = threading.Lock()
    lats, shed = [], [0]
    done = threading.Semaphore(0)
    interval = 1.0 / rate_rps
    start = time.perf_counter()

    def on_done(scheduled, fut):
        lat = (time.perf_counter() - scheduled) * 1e3
        with lock:
            if fut.exception() is None:
                lats.append(lat)
        done.release()

    for i in range(requests):
        scheduled = start + i * interval
        now = time.perf_counter()
        if scheduled > now:
            time.sleep(scheduled - now)
        try:
            fut = submit(pool[i % len(pool)])
        except Overloaded:
            with lock:
                shed[0] += 1
            done.release()
            continue
        fut.add_done_callback(
            lambda f, s=max(scheduled, now): on_done(s, f)
        )
    for _ in range(requests):
        done.acquire(timeout=60)
    wall = time.perf_counter() - start
    lats.sort()
    return {
        "rate_rps": rate_rps,
        "achieved_rps": len(lats) / wall if wall > 0 else 0.0,
        "completed": len(lats),
        "shed": shed[0],
        "p50_ms": _percentile(lats, 0.50),
        "p99_ms": _percentile(lats, 0.99),
    }


def _http_submit(url):
    """Closed-loop transport for --url: one blocking HTTP round trip per
    request, dressed as a resolved future."""
    import urllib.request
    from concurrent.futures import Future

    def submit(x):
        req = urllib.request.Request(
            url.rstrip("/") + "/predict",
            json.dumps({"inputs": x.tolist()}).encode(),
            {"Content-Type": "application/json"},
        )
        body = json.loads(urllib.request.urlopen(req, timeout=60).read())
        fut = Future()
        if "outputs" in body:
            fut.set_result(body["outputs"])
        else:
            fut.set_exception(RuntimeError(body.get("error", "bad reply")))
        return fut

    return submit


def run_bench(model="logreg", n_particles=10_000, n_features=54,
              clients=16, requests=2000, rows=(1, 4, 16), max_batch=256,
              max_wait_ms=2.0, max_queue_rows=8192, open_rate=0.0,
              open_requests=500, checkpoint=None, seed=0, url=None,
              engine=None, trace=None, slo_p99_ms=100.0,
              devices=1, lanes=1, dtype=None, device=None):
    """Measure and return the ``serve_throughput`` JSON row (JAX's keys).

    ``lanes`` runs that many batcher worker lanes over the shared engine.
    ``dtype='bfloat16'`` serves the low-precision programs and also
    measures an f32 reference loop on the same shapes, stamping ``f32_rps``
    and ``dtype_speedup`` into the row.  ``trace``: a path enables the span
    tracer for the timed window and exports a Chrome trace there (``True``
    traces without exporting).  ``engine``: reuse a pre-built engine.

    Each call uses a fresh ``MetricsRegistry``, so the histogram-derived
    fields (``serve_latency_p99``, ``latency_hist_ms``) aggregate exactly
    this call's timed window.  ``ess``/``ess_frac`` are the served
    ensemble's score-free kernel ESS (``ksd`` is ``None``: no ∇log p at
    serve time); ``slo_status`` the serving SLOs over the window;
    ``diagnostics_overhead`` the health evaluation's wall as a fraction of
    the window.
    """
    _check_devices(devices)
    if url:
        # url mode measures a REMOTE server: the local engine only supplies
        # feature_dim/request shapes, so local topology flags must not
        # label the row
        devices, lanes, dtype = 1, 1, None
    registry = telemetry.MetricsRegistry()
    prebuilt_engine = engine is not None
    if engine is None:
        engine = build_engine(model, n_particles, n_features, checkpoint,
                              seed, max_bucket=max_batch, registry=registry,
                              devices=devices, dtype=dtype, device=device)
    pool = _request_pool(engine.feature_dim, list(rows))
    plan_info = engine.stats()["plan"]
    row = {
        "metric": "serve_throughput",
        "unit": "requests/sec",
        "platform": _platform(engine),
        "model": engine.model,
        "n_particles": engine.n_particles,
        "feature_dim": engine.feature_dim,
        "devices": plan_info["num_shards"],
        "lanes": lanes,
        "dtype": engine.stats()["dtype"],
        "clients": clients,
        "requests": requests,
        "rows_per_request": list(rows),
        "max_batch": max_batch,
        "max_wait_ms": max_wait_ms,
    }
    if url:
        closed = closed_loop(_http_submit(url), pool, clients, requests)
        row.update(transport="http", url=url, value=round(closed["rps"], 1),
                   p50_ms=round(closed["p50_ms"], 3),
                   p99_ms=round(closed["p99_ms"], 3), shed=closed["shed"])
        return row

    engine.warmup()  # steady-state measurement: no captures in the window
    misses_before = engine.stats()["bucket_misses"]
    batcher = MicroBatcher(
        engine.predict, max_batch=max_batch, lanes=lanes,
        max_wait_ms=max_wait_ms, max_queue_rows=max_queue_rows,
        registry=registry,
    )
    # tracing covers exactly the timed window; idempotent enable so an
    # outer tracer is reused, not replaced
    tracer = None
    own_tracer = False
    if trace:
        own_tracer = telemetry.get_tracer() is None
        tracer = telemetry.enable()
    try:
        with capture_sentry("serve_bench timed window") as sentry:
            closed = closed_loop(batcher.submit, pool, clients, requests)
            open_row = None
            if open_rate > 0:
                open_row = open_loop(batcher.submit, pool, open_rate,
                                     open_requests)
    finally:
        batcher.close(drain=True)
        if tracer is not None and own_tracer:
            telemetry.disable()
    bstats = batcher.stats()
    estats = engine.stats()
    lookups = estats["bucket_hits"] + estats["bucket_misses"] - misses_before
    mean_rows = sum(rows) / len(rows)
    row.update(
        transport="inprocess",
        value=round(closed["rps"], 1),
        rows_per_sec=round(closed["rps"] * mean_rows, 1),
        wall_s=round(closed["wall_s"], 3),
        p50_ms=round(closed["p50_ms"], 3),
        p99_ms=round(closed["p99_ms"], 3),
        queue_wait_p50_ms=round(bstats["queue_wait_p50_ms"], 3),
        queue_wait_p99_ms=round(bstats["queue_wait_p99_ms"], 3),
        device_p50_ms=round(bstats["device_p50_ms"], 3),
        device_p99_ms=round(bstats["device_p99_ms"], 3),
        batch_occupancy_mean=round(bstats["batch_occupancy_mean"], 2),
        requests_per_batch_mean=round(bstats["requests_per_batch_mean"], 2),
        recompiles=estats["bucket_misses"] - misses_before,
        # independent counter: every graph capture and hand-kernel build in
        # the window (bucket misses only see program-cache traffic)
        sentry_compiles=sentry.compiles,
        bucket_hit_rate=round(estats["bucket_hits"] / lookups, 4)
        if lookups else 1.0,
        # closed_loop's own count (the batcher's also holds open-loop sheds)
        shed=closed["shed"],
    )
    # registry-histogram percentiles: the request latency distribution
    # over the window from the registry's log-spaced buckets — what a
    # Prometheus scrape of a production server would show
    lat_hist = registry.histogram("svgd_serve_request_latency_seconds")
    hist_ms = lat_hist.summary(scale=1e3)
    row.update(
        serve_latency_p99=hist_ms["p99"],
        latency_hist_ms=hist_ms,
        telemetry={"tracing": bool(trace),
                   "trace_propagation": bool(trace),
                   "queue_depth_last": registry.gauge(
                       "svgd_serve_queue_depth_rows").value(
                           batcher=batcher.metrics_instance),
                   "shed_total": registry.counter(
                       "svgd_serve_shed_total").value()},
        lane_fairness={
            "lanes": lanes,
            "requests": bstats["lane_requests"],
            "batches": bstats["lane_batches"],
            "inflight_rows_last": {
                f"l{i}": registry.gauge(
                    "svgd_serve_lane_inflight_rows").value(
                        batcher=batcher.metrics_instance, lane=f"l{i}")
                for i in range(lanes)
            },
        },
    )
    if dtype is not None and not prebuilt_engine and engine.stats()["dtype"] != "float32":
        # low-precision satellite: an f32 reference loop on the same
        # shapes (its own registries), so the speedup is a same-session A/B
        ref_engine = build_engine(model, n_particles, n_features,
                                  checkpoint, seed, max_bucket=max_batch,
                                  registry=telemetry.MetricsRegistry(),
                                  devices=devices, dtype=None, device=device)
        ref_engine.warmup()
        ref_batcher = MicroBatcher(
            ref_engine.predict, max_batch=max_batch, lanes=lanes,
            max_wait_ms=max_wait_ms, max_queue_rows=max_queue_rows,
            registry=telemetry.MetricsRegistry(),
        )
        try:
            ref = closed_loop(ref_batcher.submit, pool, clients, requests)
        finally:
            ref_batcher.close(drain=True)
        row.update(
            f32_rps=round(ref["rps"], 1),
            dtype_speedup=round(closed["rps"] / ref["rps"], 3)
            if ref["rps"] > 0 else None,
        )
    if tracer is not None:
        if isinstance(trace, str):
            n_events = tracer.export_chrome(trace)
            row["trace"] = {"path": trace, "events": n_events,
                            "dropped": tracer.dropped_events}
        else:
            row["trace"] = {"events": len(tracer.chrome_events()),
                            "dropped": tracer.dropped_events}
    if open_row is not None:
        row["open_loop"] = {k: round(v, 3) if isinstance(v, float) else v
                            for k, v in open_row.items()}

    # posterior-health + SLO stamp: score-free ensemble diagnostics, off the
    # request path; the first call is warmed untimed
    ensemble_health(engine.particles, max_points=1024)
    t_diag0 = time.perf_counter()
    health = ensemble_health(engine.particles, max_points=1024)
    diag_wall = time.perf_counter() - t_diag0
    slo_doc = default_serving_slos(registry, p99_ms=slo_p99_ms).evaluate()
    row.update(
        ksd=None,  # no score function at serve time
        ess=round(health["ess"], 2),
        ess_frac=round(health["ess_frac"], 4),
        slo_status=slo_doc["status"],
        slo={name: {"status": o["status"], "burn_rate": o["burn_rate"]}
             for name, o in slo_doc["objectives"].items()},
        diagnostics_overhead=round(
            diag_wall / max(closed["wall_s"] + diag_wall, 1e-9), 4),
    )
    return row


def _ab_engine(kw):
    kw.pop("engine", None)
    kw.pop("trace", None)
    engine = build_engine(
        kw.get("model", "logreg"), kw.get("n_particles", 10_000),
        kw.get("n_features", 54), kw.get("checkpoint"), kw.get("seed", 0),
        max_bucket=kw.get("max_batch", 256),
        devices=kw.get("devices", 1), dtype=kw.get("dtype"), device=kw.get("device"),
    )
    engine.warmup()
    return engine


def measure_telemetry_overhead(rounds=3, **kw):
    """A/B the span tracer's cost on the closed-loop bench: interleaved
    disabled/enabled rounds over ONE warmed engine, best-of each arm.
    Returns the ``telemetry_overhead`` row."""
    engine = _ab_engine(kw)
    best = {"off": 0.0, "on": 0.0}
    for _ in range(rounds):
        off = run_bench(engine=engine, trace=None, **kw)
        on = run_bench(engine=engine, trace=True, **kw)
        best["off"] = max(best["off"], off["value"])
        best["on"] = max(best["on"], on["value"])
    overhead = (1.0 - best["on"] / best["off"]) if best["off"] > 0 else 0.0
    return {
        "metric": "telemetry_overhead",
        "rounds": rounds,
        "rps_disabled": round(best["off"], 1),
        "rps_enabled": round(best["on"], 1),
        "overhead_frac": round(overhead, 4),
    }


#: JAX's ceiling on the profiler's and the usage meter's serve cost.
PROFILER_OVERHEAD_GATE = 0.03


def _instruments(on, reg=None):
    """Switch the dispatch profiler and the usage meter on (into ``reg``)
    or off together."""
    if on:
        _profile.enable_profiler(registry=reg)
        _usage.enable_usage(registry=reg)
    else:
        _profile.disable_profiler()
        _usage.disable_usage()


def _instrument_cost_s(engine, rounds, calls, rows=16, seed=0):
    """What the two instruments add to one batch on the batcher's dispatch
    path: one client submits ``calls`` requests of ``rows`` rows back to
    back (no coalescing window, so each is one batch), instruments off,
    then on; the median over ``rounds`` such pairs of the per-batch
    difference, in seconds."""
    x = np.random.default_rng(seed).normal(
        size=(rows, engine.feature_dim)).astype(np.float32)
    batcher = MicroBatcher(engine.predict, max_batch=rows, max_wait_ms=0.0,
                           registry=telemetry.MetricsRegistry())

    def per_batch():
        t0 = time.perf_counter()
        for _ in range(calls):
            batcher.submit(x).result()
        return (time.perf_counter() - t0) / calls

    deltas = []
    try:
        per_batch()  # warm the batcher's thread and the bucket
        for _ in range(rounds):
            off = per_batch()
            _instruments(True, telemetry.MetricsRegistry())
            try:
                on = per_batch()
            finally:
                _instruments(False)
            deltas.append(on - off)
    finally:
        batcher.close()
    return float(np.median(deltas))


def measure_profiler_overhead(rounds=3, dispatch_calls=500, **kw):
    """A/B the dispatch profiler's and the usage meter's cost on the
    serve path over ONE warmed engine, two ways.

    JAX's: interleaved off/on closed-loop rounds, best-of each arm
    (``overhead_frac``, with each round's rps and the widest arm's spread
    between rounds).  On a shared host that spread (7–18% between rounds
    of one call on an H100 machine) is wider than the 3% it should resolve, so the gate reads a second,
    direct measurement: the instruments' added seconds a batch on the
    batcher's dispatch path (:func:`_instrument_cost_s`, ``rounds`` pairs of
    ``dispatch_calls`` batches) times the closed loop's batches a second
    (its best off round) — the share of the serial dispatch thread's time
    they take (``dispatch_overhead_frac``, held to
    :data:`PROFILER_OVERHEAD_GATE`).  Returns the ``profiler_overhead`` row
    with the programs' attribution from the last 'on' closed-loop round."""
    engine = _ab_engine(kw)
    laps = {"off": [], "on": []}
    batch_rate = 0.0
    reg = None
    for _ in range(rounds):
        off = run_bench(engine=engine, trace=None, **kw)
        laps["off"].append(off["value"])
        if off["value"] >= max(laps["off"]):
            batch_rate = off["value"] / max(off["requests_per_batch_mean"], 1e-9)
        reg = telemetry.MetricsRegistry()
        _instruments(True, reg)
        try:
            laps["on"].append(run_bench(engine=engine, trace=None, **kw)["value"])
        finally:
            _instruments(False)
    best = {arm: max(v, default=0.0) for arm, v in laps.items()}
    overhead = (1.0 - best["on"] / best["off"]) if best["off"] > 0 else 0.0
    spread = max(((max(v) - min(v)) / max(v) for v in laps.values() if v and max(v) > 0),
                 default=0.0)
    cost_s = _instrument_cost_s(engine, rounds, dispatch_calls)
    dispatch_overhead = cost_s * batch_rate
    return {
        "metric": "profiler_overhead",
        "rounds": rounds,
        "rps_disabled": round(best["off"], 1),
        "rps_enabled": round(best["on"], 1),
        "overhead_frac": round(overhead, 4),
        "rps_disabled_rounds": [round(v, 1) for v in laps["off"]],
        "rps_enabled_rounds": [round(v, 1) for v in laps["on"]],
        "round_spread_frac": round(spread, 4),
        "instrument_us_per_batch": round(1e6 * cost_s, 3),
        "batches_per_s": round(batch_rate, 1),
        "dispatch_overhead_frac": round(dispatch_overhead, 4),
        "gate": PROFILER_OVERHEAD_GATE,
        "within_gate": dispatch_overhead <= PROFILER_OVERHEAD_GATE,
        "programs": _profile.summary(reg, "serve."),
        "usage_totals": _usage.usage_summary(reg)["totals"],
    }


def _tenant_specs(n_tenants):
    """Mixed-shape tenant cycle for --tenants N: model kind, ensemble size
    and feature width all vary, so no two neighbouring tenants share a
    program shape."""
    specs = []
    for i in range(n_tenants):
        kind = ("logreg", "bnn", "gmm")[i % 3]
        if kind == "logreg":
            nf = (54, 24, 96)[(i // 3) % 3]
            specs.append(dict(name=f"logreg-{i}", model="logreg",
                              n_particles=2048 + 512 * ((i // 3) % 3),
                              d=1 + nf, feature_dim=nf))
        elif kind == "bnn":
            nf = (8, 16)[(i // 3) % 2]
            specs.append(dict(name=f"bnn-{i}", model="bnn",
                              n_particles=192 + 64 * ((i // 3) % 2),
                              d=num_params(nf), feature_dim=nf,
                              engine_kw=dict(n_features=nf)))
        else:
            dim = (8, 16, 32)[(i // 3) % 3]
            specs.append(dict(name=f"gmm-{i}", model="gmm",
                              n_particles=1024 + 256 * ((i // 3) % 3),
                              d=dim, feature_dim=dim))
    return specs


def _quota_probe(seed=3, device=None):
    """Deterministic drill of the quota shed-priority path on a paused
    registry batcher: a hog tenant fills the bounded queue past its
    inflight-rows quota, then a polite tenant's arrival must shed the
    hog's newest queued request (not the polite one).  Untimed, own
    metrics registry."""
    rng = np.random.default_rng(seed)
    probe = ModelRegistry(
        metrics=telemetry.MetricsRegistry(), max_total_buckets=4,
        max_batch=8, max_queue_rows=32, batcher_autostart=False,
    )
    nf = 4
    parts = rng.normal(size=(32, 1 + nf)).astype(np.float32)
    probe.add_tenant("hog", "logreg", particles=parts, min_bucket=8,
                     max_bucket=8, quota_rows=8, device=device)
    probe.add_tenant("polite", "logreg", particles=parts.copy(),
                     min_bucket=8, max_bucket=8, device=device)
    x = rng.normal(size=(8, nf)).astype(np.float32)
    hog_futs = [probe.batcher.submit(x, tenant="hog") for _ in range(4)]
    polite_fut = probe.batcher.submit(x, tenant="polite")
    stats = probe.batcher.stats()
    probe.batcher.start()
    polite_ok = polite_fut.result(timeout=30) is not None
    hog_shed = sum(1 for f in hog_futs
                   if f.done() and f.exception() is not None)
    probe.close(drain=True)
    return {
        "quota_sheds": int(sum(stats["quota_sheds"].values())),
        "per_tenant": stats["quota_sheds"],
        "hog_requests_shed": hog_shed,
        "polite_served": polite_ok,
    }


def run_multitenant_bench(tenants=10, clients=16, requests=2000,
                          rows=(1, 4, 16), max_batch=256, max_wait_ms=2.0,
                          max_queue_rows=8192, lanes=1, seed=0,
                          max_total_buckets=None, device=None):
    """Measure the multi-tenant registry and return the
    ``serve_multitenant`` JSON row (JAX's keys).

    ``max_total_buckets`` defaults to EXACTLY the working set (tenants ×
    buckets the request sizes touch): the timed window then runs with a
    full-but-not-overflowing LRU — zero steady-state captures — and the
    post-window eviction probe (one cold tenant added past the bound)
    deterministically observes the first eviction.
    """
    rows = tuple(rows)
    min_bucket = 8
    working_buckets = len({bucket_for(r, min_bucket) for r in rows})
    cap = (max_total_buckets if max_total_buckets is not None
           else tenants * working_buckets)
    metrics = telemetry.MetricsRegistry()
    rng = np.random.default_rng(seed)
    reg = ModelRegistry(
        metrics=metrics, max_total_buckets=cap, max_batch=max_batch,
        lanes=lanes, max_wait_ms=max_wait_ms, max_queue_rows=max_queue_rows,
    )
    specs = _tenant_specs(tenants)
    pools = {}
    for spec in specs:
        parts = rng.normal(size=(spec["n_particles"], spec["d"]))
        reg.add_tenant(
            spec["name"], spec["model"],
            particles=parts.astype(np.float32),
            min_bucket=min_bucket, max_bucket=max_batch, device=device,
            **spec.get("engine_kw", {}),
        )
        pools[spec["name"]] = _request_pool(
            spec["feature_dim"], list(rows), pool=64,
            seed=seed + 1 + len(pools))
    names = [s["name"] for s in specs]
    reg.warm(rows)  # steady state: every reachable bucket built
    misses_before = {
        n: reg.tenant(n).engine.stats()["bucket_misses"] for n in names}

    # closed loop, tenants round-robin: every tenant sees the same offered
    # load, so per-tenant completion rates measure fairness
    lock = threading.Lock()
    issued = [0]
    lats = {n: [] for n in names}
    shed = [0]

    def worker():
        while True:
            with lock:
                if issued[0] >= requests:
                    return
                i = issued[0]
                issued[0] += 1
            name = names[i % len(names)]
            pool = pools[name]
            t0 = time.perf_counter()
            try:
                reg.submit(name, pool[i % len(pool)]).result(timeout=60)
            except Overloaded:
                with lock:
                    shed[0] += 1
                continue
            lat = (time.perf_counter() - t0) * 1e3
            with lock:
                lats[name].append(lat)

    threads = [threading.Thread(target=worker) for _ in range(clients)]
    with capture_sentry("serve_multitenant timed window") as sentry:
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wall = time.perf_counter() - t0

    recompiles = sum(
        reg.tenant(n).engine.stats()["bucket_misses"] - misses_before[n]
        for n in names)
    lat_hist = metrics.histogram("svgd_serve_request_latency_seconds")
    per_tenant = {}
    tenant_rps = {}
    for spec in specs:
        n = spec["name"]
        tl = sorted(lats[n])
        hist = lat_hist.summary(scale=1e3, tenant=n)
        rps = len(tl) / wall if wall > 0 else 0.0
        tenant_rps[n] = rps
        per_tenant[n] = {
            "model": spec["model"],
            "n_particles": spec["n_particles"],
            "feature_dim": spec["feature_dim"],
            "requests": len(tl),
            "rps": round(rps, 1),
            "p50_ms": round(_percentile(tl, 0.50), 3),
            "p99_ms": round(_percentile(tl, 0.99), 3),
            "hist_p99_ms": hist["p99"],
        }
    all_lats = sorted(v for ls in lats.values() for v in ls)
    completed = len(all_lats)
    fairness = (min(tenant_rps.values()) / max(tenant_rps.values())
                if tenant_rps and max(tenant_rps.values()) > 0 else 0.0)
    platform = _platform(reg.tenant(names[0]).engine)

    # --- eviction probe (off-window): one cold tenant past the LRU bound
    # must evict exactly one least-recently-used bucket
    evictions_before = reg.kernel_cache.stats()["evictions"]
    probe_parts = rng.normal(size=(64, 9)).astype(np.float32)
    reg.add_tenant("evict-probe", "logreg", particles=probe_parts,
                   min_bucket=min_bucket, max_bucket=max_batch, device=device)
    reg.predict("evict-probe", rng.normal(size=(1, 8)).astype(np.float32))
    cache_stats = reg.kernel_cache.stats()
    eviction_probe = {
        "evictions_before": evictions_before,
        "evictions_after": cache_stats["evictions"],
        "cache_size": cache_stats["size"],
    }
    reg.close(drain=True)

    quota_probe = _quota_probe(seed=seed + 7, device=device)

    return {
        "metric": "serve_multitenant",
        "unit": "requests/sec",
        "platform": platform,
        "tenants": tenants,
        "clients": clients,
        "requests": requests,
        "rows_per_request": list(rows),
        "max_batch": max_batch,
        "max_wait_ms": max_wait_ms,
        "lanes": lanes,
        "value": round(completed / wall, 1) if wall > 0 else 0.0,
        "wall_s": round(wall, 3),
        "completed": completed,
        "shed": shed[0],
        "p50_ms": round(_percentile(all_lats, 0.50), 3),
        "p99_ms": round(_percentile(all_lats, 0.99), 3),
        "p99_worst_tenant_ms": max(
            (pt["p99_ms"] for pt in per_tenant.values()), default=0.0),
        "tenant_fairness": round(fairness, 4),
        "per_tenant": per_tenant,
        "recompiles": recompiles,
        "sentry_compiles": sentry.compiles,
        "kernel_cache": cache_stats,
        "evictions": cache_stats["evictions"],
        "eviction_probe": eviction_probe,
        "quota_sheds": quota_probe["quota_sheds"],
        "quota_probe": quota_probe,
    }


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m dist_svgd_torch.tools.serve_bench",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--model", choices=("logreg", "bnn", "gmm"), default="logreg")
    ap.add_argument("--n-particles", type=int, default=10_000)
    ap.add_argument("--n-features", type=int, default=54,
                    help="feature width (logreg/bnn inputs; gmm particle dim)")
    ap.add_argument("--checkpoint", action="append", default=None,
                    help="serve a real ensemble (repeatable for one "
                         "multi-host save); default is a seeded synthetic one")
    ap.add_argument("--devices", type=int, default=1,
                    help="shard the served ensemble across this many devices: "
                         "more than one is not ported (ROADMAP A10.2)")
    ap.add_argument("--tenants", type=int, default=0,
                    help="host this many mixed-shape tenants behind one "
                         "ModelRegistry and emit the serve_multitenant "
                         "row instead (ignores --model/--n-particles/"
                         "--devices/--dtype)")
    ap.add_argument("--max-total-buckets", type=int, default=None,
                    help="multi-tenant LRU bound on built buckets across "
                         "tenants (default: exactly the working set, so the "
                         "eviction probe evicts deterministically)")
    ap.add_argument("--lanes", type=int, default=1,
                    help="batcher dispatch worker lanes over the shared engine")
    ap.add_argument("--dtype", choices=("float32", "bfloat16"), default=None,
                    help="serve-program compute dtype; bfloat16 also "
                         "measures the f32 reference loop and stamps "
                         "dtype_speedup into the row")
    ap.add_argument("--clients", type=int, default=16)
    ap.add_argument("--requests", type=int, default=2000)
    ap.add_argument("--rows", default="1,4,16",
                    help="comma-separated request sizes, cycled")
    ap.add_argument("--max-batch", type=int, default=256)
    ap.add_argument("--max-wait-ms", type=float, default=2.0)
    ap.add_argument("--max-queue-rows", type=int, default=8192)
    ap.add_argument("--open-rate", type=float, default=0.0,
                    help="also run an open loop at this requests/sec (0 = off)")
    ap.add_argument("--open-requests", type=int, default=500)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--url", default=None,
                    help="closed-loop against a live serving.server "
                         "instead of in-process")
    ap.add_argument("--slo-p99-ms", type=float, default=100.0,
                    help="serve-p99 SLO threshold stamped into the row's "
                         "slo_status")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="enable the span tracer for the timed window and "
                         "export a Chrome trace here")
    ap.add_argument("--ab-telemetry", type=int, default=0, metavar="ROUNDS",
                    help="instead of one bench row, A/B the tracer's "
                         "overhead over this many interleaved rounds")
    ap.add_argument("--ab-profiler", type=int, default=0, metavar="ROUNDS",
                    help="instead of one bench row, A/B the dispatch profiler's "
                         "and usage meter's overhead over this many rounds")
    ap.add_argument("--device", choices=("cuda", "cpu"), default=None,
                    help="default: the card (fails without CUDA)")
    args = ap.parse_args(argv)
    _check_devices(args.devices)

    rows = tuple(int(r) for r in args.rows.split(","))
    kw = dict(
        model=args.model, n_particles=args.n_particles,
        n_features=args.n_features, clients=args.clients,
        requests=args.requests, rows=rows, max_batch=args.max_batch,
        max_wait_ms=args.max_wait_ms, max_queue_rows=args.max_queue_rows,
        open_rate=args.open_rate, open_requests=args.open_requests,
        checkpoint=args.checkpoint, seed=args.seed,
        devices=args.devices, lanes=args.lanes, dtype=args.dtype,
        device=args.device,
    )
    if args.tenants:
        out = run_multitenant_bench(
            tenants=args.tenants, clients=args.clients,
            requests=args.requests, rows=rows, max_batch=args.max_batch,
            max_wait_ms=args.max_wait_ms, max_queue_rows=args.max_queue_rows,
            lanes=args.lanes, seed=args.seed,
            max_total_buckets=args.max_total_buckets, device=args.device,
        )
    elif args.ab_telemetry:
        out = measure_telemetry_overhead(rounds=args.ab_telemetry, **kw)
    elif args.ab_profiler:
        out = measure_profiler_overhead(rounds=args.ab_profiler, **kw)
    else:
        out = run_bench(url=args.url, trace=args.trace,
                        slo_p99_ms=args.slo_p99_ms, **kw)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
