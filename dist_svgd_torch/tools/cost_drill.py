"""Cost-attribution drill: does the runtime cost ledger add up?

Counterpart of ``tools/cost_drill.py`` (the same window, the same row keys
and gates, and the port's overhead gate beside JAX's A/B).  One
multi-tenant serve window with the dispatch profiler
(``telemetry/profile.py``) and the usage meter (``telemetry/usage.py``)
both enabled, judged on three accounting identities plus an overhead
bound — the ``cost_attribution`` row:

- **attribution coverage** — fenced per-program dispatch wall attributed
  to ``serve.*`` plan labels must be >= 95% of the measured dispatch
  wall (the batcher's own ``svgd_serve_device_time_seconds`` window over
  the same batches).  The gap is un-attributed host work inside the
  dispatch window (padding, placement, fetch); a profiler that loses
  sight of where device time goes fails here.
- **tenant sum** — per-tenant ``svgd_usage_device_seconds_total`` must
  sum to the total measured device wall within 1%.  Both sides derive
  from the same per-batch measurement, so this is an accounting
  identity: a mismatch means a batch was metered twice, dropped, or
  mislabelled — not noise.
- **zero in-window captures** — warmed steady state must stay
  capture-free with both instruments on (bucket-cache miss counters, the
  usage ledger's compile counter, and ``parallel/plan.py:capture_sentry``
  all at zero over the window).
- **profiler overhead** — JAX's number is interleaved off/on closed-loop
  rounds over the same warmed serving stack, best-of each arm
  (``profiler_overhead_frac``, printed).  On a shared host that loop
  spreads wider than the 3% it should resolve, so the port gates the
  instruments' added seconds a batch on the batcher's dispatch path
  (``serve_bench._instrument_cost_s``) times the measured window's
  batches a second (``dispatch_overhead_frac``) — the deviation
  ``tools/serve_bench.py``'s ``profiler_overhead`` row makes too.

The window also exercises the telemetry-history loop end to end: a
clock-driven :class:`~dist_svgd_torch.telemetry.history.HistoryRecorder`
snapshots the drill registry between window segments and
``tools/anomaly_report.py``'s detector runs over the recorded series
(report-only — a short drill window is too noisy to gate on; the
deterministic anomaly gates live in the fixture tests).  The ring is
written to a temporary directory and removed, or kept under
``history_dir`` when :func:`run_drill` is given one (``trace_report
--programs`` reads it).

Tenants are sized differently on purpose (distinct ensemble sizes) so
per-tenant device-seconds are visibly unequal — a cost report in which
every tenant costs the same catches nothing.  Their sizes make the
dispatch compute-dominant, as JAX's were chosen to (its notes: coverage
is compute-dominance, not profiler quality; JAX's sizes give ~25 ms a
dispatch on its CPU host).  On the CPU the defaults are JAX's
(:data:`DEFAULT_TENANTS`).  On an H100 those sizes run in ~0.07 ms, under
the ~0.1–0.2 ms of Python the batcher and the engine spend around each
fenced program call, so coverage would read the host's Python speed
(0.65–0.79 on the card); the card's defaults are the same 4:2:1 tenants
at 256× the particles (:data:`CARD_TENANTS`, ~2–10 ms a dispatch).  The
instruments' per-batch cost is host work whatever the tenant, so it is
timed on the smallest tenant; its demanding form, at serving batch
rates, is ``serve_bench``'s ``profiler_overhead`` row.

Runs on the card unless ``--device cpu``::

    python -m dist_svgd_torch.tools.cost_drill                 # human row + verdict
    python -m dist_svgd_torch.tools.cost_drill --json
    python -m dist_svgd_torch.tools.cost_drill --requests 600 --ab-rounds 3
    python -m dist_svgd_torch.tools.cost_drill --dump-metrics /tmp/dump.json   # then:
    python -m dist_svgd_torch.tools.trace_report --programs /tmp/dump.json

Exit code: 0 when every gate above holds, 1 otherwise.
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
import tempfile

import numpy as np

from dist_svgd_torch.parallel.plan import capture_sentry
from dist_svgd_torch.serving.batcher import MicroBatcher
from dist_svgd_torch.serving.engine import PredictiveEngine
from dist_svgd_torch.telemetry import metrics as _metrics
from dist_svgd_torch.telemetry import profile as _profile
from dist_svgd_torch.telemetry import usage as _usage
from dist_svgd_torch.telemetry.history import HistoryRecorder
from dist_svgd_torch.tools import serve_bench
from dist_svgd_torch.tools.anomaly_report import analyze_records
from dist_svgd_torch.utils.platform import resolve_device

#: Fixed gates (see module docstring).
COVERAGE_MIN = 0.95
TENANT_SUM_TOL = 0.01
PROFILER_OVERHEAD_MAX = 0.03

#: Batches a round of the instruments' timed cost (serve_bench's
#: ``measure_profiler_overhead`` default).
INSTRUMENT_CALLS = 500

#: Tenant ensembles: distinct sizes so the cost report has something to
#: distinguish.  (name, n_particles) — features are shared.  JAX's, the
#: defaults on the CPU.
DEFAULT_TENANTS = (("alpha", 65536), ("bravo", 32768), ("charlie", 16384))
#: The card's defaults: JAX's tenants at 256× the particles, so that a
#: dispatch is compute-dominant there too (module docstring).
CARD_TENANTS = tuple((name, 256 * n) for name, n in DEFAULT_TENANTS)


def default_tenants(device):
    """The tenants :func:`run_drill` serves when given none: JAX's on the
    CPU, :data:`CARD_TENANTS` on the card."""
    return CARD_TENANTS if device.type == "cuda" else DEFAULT_TENANTS


def build_serving(tenants=DEFAULT_TENANTS, n_features=32, max_batch=64,
                  registry=None, seed=0, device=None):
    """Per-tenant engines behind ONE micro-batcher (the registry path's
    shape, without its scanner machinery): single shared queue, tenant-
    routed dispatch, one padding bucket per engine (min=max) so warmup
    covers the whole steady state.  The same ensembles as JAX's on the
    same arguments."""
    registry = registry if registry is not None else _metrics.MetricsRegistry()
    rng = np.random.default_rng(seed)
    engines = {}
    for name, n_particles in tenants:
        parts = rng.normal(size=(n_particles, 1 + n_features)).astype(
            np.float32)
        engines[name] = PredictiveEngine(
            "logreg", parts, min_bucket=max_batch, max_bucket=max_batch,
            registry=registry, tenant=name, device=device)

    def dispatch(x, tenant=None):
        return engines[tenant].predict(x)

    batcher = MicroBatcher(dispatch, max_batch=max_batch, max_wait_ms=0.5,
                           registry=registry)
    return engines, batcher, registry


def _measured_device_seconds(registry):
    """The batcher's dispatch wall: sum of the
    ``svgd_serve_device_time_seconds`` histogram over every label set."""
    hist = registry.get("svgd_serve_device_time_seconds")
    if hist is None:
        return 0.0
    # microsecond scale: Histogram.summary rounds to 4 decimals
    return float(sum(hist.summary(scale=1e6, **ls)["sum"]
                     for ls in hist.label_sets())) / 1e6


def _bucket_misses(registry):
    ctr = registry.get("svgd_engine_bucket_misses_total")
    if ctr is None:
        return 0
    return int(sum(ctr.value(**ls) for ls in ctr.label_sets()))


def run_drill(tenants=None, n_features=32, max_batch=64,
              requests=240, clients=2, ab_rounds=3, ab_requests=120,
              history_windows=4, seed=0, device=None, history_dir=None):
    """The drill.  Returns the ``cost_attribution`` row (see
    :func:`row_ok` for its gates).  The engines serve on the card unless
    ``device='cpu'``; ``tenants`` defaults to :func:`default_tenants` of
    that device; ``history_dir`` keeps the window's history ring there
    instead of in a removed temporary directory."""
    dev = resolve_device(device)
    if tenants is None:
        tenants = default_tenants(dev)
    engines, batcher, registry = build_serving(
        tenants=tenants, n_features=n_features, max_batch=max_batch,
        seed=seed, device=dev)
    _LAST_REGISTRY[0] = registry  # CLI --dump-metrics reads it back
    tenant_names = [name for name, _ in tenants]
    try:
        for eng in engines.values():
            eng.warmup()

        # fixed-size requests (= the single bucket) routed round-robin
        # across tenants: every dispatch is warm by construction
        pool_x = serve_bench._request_pool(
            n_features, rows_cycle=(max_batch,), pool=128, seed=seed + 1)
        pool = [(tenant_names[i % len(tenant_names)], x)
                for i, x in enumerate(pool_x)]

        def submit(item):
            tenant, x = item
            return batcher.submit(x, tenant=tenant)

        def run_window(nreq):
            return serve_bench.closed_loop(submit, pool, clients, nreq)

        run_window(max(2 * len(tenant_names), clients))  # settle the path

        # ---- JAX's A/B overhead: interleaved off/on rounds, best-of each arm
        best = {"off": 0.0, "on": 0.0}
        for _ in range(ab_rounds):
            off = run_window(ab_requests)
            _profile.enable_profiler(registry=registry)
            _usage.enable_usage(registry=registry)
            try:
                on = run_window(ab_requests)
            finally:
                _profile.disable_profiler()
                _usage.disable_usage()
            best["off"] = max(best["off"], off["rps"])
            best["on"] = max(best["on"], on["rps"])
        overhead = ((1.0 - best["on"] / best["off"])
                    if best["off"] > 0 else 0.0)

        # ---- the measured window: profiler + usage + sentry + history
        device_before = _measured_device_seconds(registry)
        attr_before = _profile.attributed_seconds(registry, "serve.")
        usage_before = _usage.usage_summary(registry)
        misses_before = _bucket_misses(registry)
        batches_before = batcher.stats()["batches"]

        keep = history_dir is not None
        hist_dir = (history_dir if keep
                    else tempfile.mkdtemp(prefix="cost_drill_hist_"))
        recorder = HistoryRecorder(registry, hist_dir, interval_s=0.0)
        _profile.enable_profiler(registry=registry)
        _usage.enable_usage(registry=registry)
        try:
            recorder.record_once()
            per_seg = max(requests // max(history_windows, 1), 1)
            segments = []
            with capture_sentry("cost_drill.window") as sentry:
                for _ in range(max(history_windows, 1)):
                    segments.append(run_window(per_seg))
                    recorder.record_once()
        finally:
            _profile.disable_profiler()
            _usage.disable_usage()
        batches = batcher.stats()["batches"] - batches_before

        device_s = _measured_device_seconds(registry) - device_before
        attributed_s = (_profile.attributed_seconds(registry, "serve.")
                        - attr_before)
        coverage = attributed_s / device_s if device_s > 0 else 0.0

        usage_after = _usage.usage_summary(registry)
        tenant_device = {}
        compiles = 0
        for name, row in usage_after["tenants"].items():
            before = usage_before["tenants"].get(name, {})
            tenant_device[name] = (row["device_seconds"]
                                   - before.get("device_seconds", 0.0))
            compiles += row["compiles"] - before.get("compiles", 0)
        tenant_sum = sum(tenant_device.values())
        sum_err = (abs(tenant_sum - device_s) / device_s
                   if device_s > 0 else 1.0)

        history_records = recorder.history.records()
        anomalies = analyze_records(history_records, rate=True,
                                    min_segment=2)
        if not keep:
            shutil.rmtree(hist_dir, ignore_errors=True)

        completed = sum(s["completed"] for s in segments)
        wall = sum(s["wall_s"] for s in segments)
        # the port's gate: what the instruments add to one batch on the
        # dispatch path, times this window's batches a second (off the
        # drill registry: the switchboards point at a scratch one)
        batch_rate = batches / wall if wall > 0 else 0.0
        smallest = min(tenants, key=lambda t: t[1])[0]
        cost_s = (serve_bench._instrument_cost_s(
            engines[smallest], ab_rounds, INSTRUMENT_CALLS, rows=max_batch,
            seed=seed) if ab_rounds > 0 else 0.0)
        top = sorted(_profile.summary(registry, "serve.").items(),
                     key=lambda kv: -kv[1]["seconds"])[:5]
        return {
            "metric": "cost_attribution",
            "unit": "fraction of measured dispatch wall attributed",
            "value": round(coverage, 4),
            "coverage": round(coverage, 4),
            "attributed_s": round(attributed_s, 4),
            "measured_device_s": round(device_s, 4),
            "tenant_device_s": {k: round(v, 4)
                                for k, v in sorted(tenant_device.items())},
            "tenant_sum_err_frac": round(sum_err, 6),
            "recompiles": int(compiles
                              + (_bucket_misses(registry) - misses_before)),
            "sentry_compiles": sentry.compiles,
            "sentry_supported": sentry.supported,
            "profiler_overhead_frac": round(overhead, 4),
            "instrument_us_per_batch": round(1e6 * cost_s, 3),
            "batches_per_s": round(batch_rate, 1),
            "dispatch_overhead_frac": round(cost_s * batch_rate, 4),
            "rps_disabled": round(best["off"], 1),
            "rps_enabled": round(best["on"], 1),
            "ab_rounds": ab_rounds,
            "requests": completed,
            "rps": round(completed / wall, 1) if wall > 0 else 0.0,
            "history_records": len(history_records),
            "history_anomalies": len(anomalies["anomalies"]),
            "top_programs": [
                {"label": label, **{k: round(v, 4) if isinstance(v, float)
                                    else v for k, v in row.items()}}
                for label, row in top],
            "tenants": len(tenant_names),
            "clients": clients,
            "max_batch": max_batch,
            "n_features": n_features,
            "platform": serve_bench._platform(engines[tenant_names[0]]),
        }
    finally:
        batcher.close()


#: The keys the port's row adds to JAX's: the overhead gate's inputs.
PORT_OVERHEAD_KEYS = ("instrument_us_per_batch", "batches_per_s",
                      "dispatch_overhead_frac")


def row_ok(row):
    """JAX's unconditional gates on the row, plus the port's overhead gate
    where the row carries it (``dispatch_overhead_frac`` over
    :data:`PROFILER_OVERHEAD_MAX`; JAX gates its A/B as its own row)."""
    why = []
    if row["coverage"] < COVERAGE_MIN:
        why.append(f"attribution coverage {row['coverage']:.3f} < "
                   f"{COVERAGE_MIN} of measured dispatch wall")
    if row["tenant_sum_err_frac"] > TENANT_SUM_TOL:
        why.append(f"per-tenant device-seconds sum off by "
                   f"{row['tenant_sum_err_frac']:.4f} > {TENANT_SUM_TOL} "
                   f"of total")
    if row["recompiles"] > 0:
        why.append(f"{row['recompiles']} in-window recompile(s) "
                   f"(kernel-cache misses / usage compile counts)")
    if row["sentry_supported"] and row["sentry_compiles"] > 0:
        why.append(f"capture sentry counted {row['sentry_compiles']} "
                   f"graph capture(s) or kernel build(s) in the "
                   f"steady-state window")
    overhead = row.get("dispatch_overhead_frac")
    if overhead is not None and overhead > PROFILER_OVERHEAD_MAX:
        why.append(f"profiler + usage meter add {overhead:.4f} of the "
                   f"dispatch path's time > {PROFILER_OVERHEAD_MAX}")
    return (not why, why)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m dist_svgd_torch.tools.cost_drill",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--requests", type=int, default=240)
    ap.add_argument("--clients", type=int, default=2)
    ap.add_argument("--ab-rounds", type=int, default=3)
    ap.add_argument("--ab-requests", type=int, default=120)
    ap.add_argument("--max-batch", type=int, default=64)
    ap.add_argument("--json", action="store_true")
    ap.add_argument("--dump-metrics", default=None, metavar="PATH",
                    help="also save the drill registry's dump here "
                         "(feed it to trace_report --programs)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default=None,
                    help="serve on the card (default) or the CPU")
    args = ap.parse_args(argv)

    row = run_drill(requests=args.requests, clients=args.clients,
                    ab_rounds=args.ab_rounds, ab_requests=args.ab_requests,
                    max_batch=args.max_batch, device=args.device)
    ok, why = row_ok(row)
    if args.dump_metrics and _LAST_REGISTRY[0] is not None:
        with open(args.dump_metrics, "w") as fh:
            json.dump(_LAST_REGISTRY[0].dump(), fh)
    if args.json:
        print(json.dumps({**row, "ok": ok, "why": why}))
    else:
        print(json.dumps(row, indent=2))
        if ok:
            print(f"cost_attribution OK: coverage {row['coverage']:.3f}, "
                  f"tenant-sum err {row['tenant_sum_err_frac']:.4f}, "
                  f"{row['recompiles']} recompiles, overhead "
                  f"{row['dispatch_overhead_frac']:.4f} (JAX's A/B "
                  f"{row['profiler_overhead_frac']:.4f})")
        else:
            print("cost_attribution FAIL: " + "; ".join(why))
    return 0 if ok else 1


#: The last drill's registry (CLI --dump-metrics); run_drill stores it.
_LAST_REGISTRY = [None]


if __name__ == "__main__":
    sys.exit(main())
