"""Direct costs of two instruments, measured off the closed loop: what the
span tracer adds to one served request, and what one posterior-diagnostics
compute takes.

- ``tracer_us_per_request``: one client submits blocks of ``calls``
  back-to-back requests of ``rows`` rows to a ``MicroBatcher`` over a
  warmed engine (no coalescing window, so each request is one batch),
  tracer off and on in alternating order; the median over ``pairs`` block
  pairs of the per-request difference
  (``tools/serve_bench.py:_instrument_cost_s``'s protocol for the dispatch
  profiler, its blocks shorter and interleaved), and the same A/B of the
  median wall of a batch on the batcher's dispatch thread
  (``dispatch_thread_us_per_request``), which leaves out the client's
  wake-ups.  The engine is ``tools/perf_regress.py``'s serve row's:
  logreg over a seeded 10,000 × 55 ensemble.
- ``closed_loop``: the serve bench's closed loop, tracer off and on in
  alternating order over ``--closed-loop-rounds`` rounds
  (:func:`closed_loop_ab`; 0 skips it).
- ``diagnostics``: the median wall of ``calls``
  ``PosteriorDiagnostics.compute`` calls after ``warmup`` untimed ones, at
  ``tools/fault_drill.py:measure_diagnostics_overhead``'s shape (the GMM
  drill's n = 2048 particles in 4 shards, ``max_points`` and ``row_chunk``
  512, the drill's GMM score).

The script reads only names that every version of the port since the
serving and fault-drill slices exports, so it can time another checkout:
run it by path with that checkout first on ``PYTHONPATH``::

    env PYTHONPATH=. python dist_svgd_torch/tools/overhead_probe.py
    env PYTHONPATH=path/to/other/checkout python dist_svgd_torch/tools/overhead_probe.py

It prints one JSON line.  The card unless ``--device cpu``.
"""

import argparse
import json
import statistics
import sys
import time

import numpy as np


def tracer_us_per_request(engine, pairs=40, calls=250, rows=4, seed=0):
    """Median over ``pairs`` off/on block pairs of the tracer's added µs a
    request on the dispatch path (module docstring): each block is
    ``calls`` back-to-back requests, the pairs alternate which arm goes
    first, and each on-block has a fresh tracer — so a host's drift
    between blocks cancels."""
    from dist_svgd_torch import telemetry
    from dist_svgd_torch.serving import MicroBatcher

    class TimedBatcher(MicroBatcher):
        """The batcher with each batch's wall on its dispatch thread kept."""

        walls: list = []

        def _run_batch(self, batch, lane=0):
            t0 = time.perf_counter()
            try:
                return super()._run_batch(batch, lane)
            finally:
                self.walls.append(time.perf_counter() - t0)

    x = np.random.default_rng(seed).normal(
        size=(rows, engine.feature_dim)).astype(np.float32)
    batcher = TimedBatcher(engine.predict, max_batch=rows, max_wait_ms=0.0,
                           registry=telemetry.MetricsRegistry())

    def block(traced):
        if traced:
            telemetry.enable()
        try:
            del batcher.walls[:]
            t0 = time.perf_counter()
            for _ in range(calls):
                batcher.submit(x).result()
            wall = (time.perf_counter() - t0) / calls
            return wall, statistics.median(batcher.walls)
        finally:
            if traced:
                telemetry.disable()

    offs, ons = [], []
    try:
        block(False)  # warm the batcher's thread and the bucket
        for i in range(pairs):
            first = bool(i % 2)
            a = block(first)
            b = block(not first)
            offs.append(b if first else a)
            ons.append(a if first else b)
    finally:
        batcher.close()
    deltas = [on[0] - off[0] for off, on in zip(offs, ons)]
    batch_deltas = [on[1] - off[1] for off, on in zip(offs, ons)]
    return {"tracer_us_per_request": statistics.median(deltas) * 1e6,
            "request_us_off": statistics.median(o[0] for o in offs) * 1e6,
            "request_us_on": statistics.median(o[0] for o in ons) * 1e6,
            "delta_us_quartiles": [q * 1e6 for q in statistics.quantiles(deltas, n=4)],
            # the same A/B on the dispatch thread alone: the median wall of
            # a batch (one request) there, off and on
            "dispatch_thread_us_per_request": statistics.median(batch_deltas) * 1e6,
            "batch_us_off": statistics.median(o[1] for o in offs) * 1e6,
            "batch_us_on": statistics.median(o[1] for o in ons) * 1e6,
            "pairs": pairs, "calls": calls, "rows": rows}


def closed_loop_ab(engine, rounds=8, **kw):
    """``tools/serve_bench.py``'s closed loop (``perf_regress``'s serve row
    settings, ``kw`` overriding them) over one warmed engine, tracer off
    and on, the order alternating each round: each arm's best and median
    rps and its median p50, queue-wait p50, dispatch p50 and requests a
    batch, and the best-of overhead read with each arm first.  It shows
    what ``measure_telemetry_overhead`` (off first every round) reads, and
    where the traced arm's time goes."""
    from dist_svgd_torch.tools import perf_regress, serve_bench

    cfg = dict(perf_regress.SERVE_BENCH_KW, **kw)
    cfg.pop("model", None)
    runs = {"off": [], "on": []}
    for i in range(rounds):
        for arm in (("off", "on") if i % 2 == 0 else ("on", "off")):
            row = serve_bench.run_bench(engine=engine, trace=True if arm == "on" else None,
                                        **cfg)
            runs[arm].append((i % 2 == (arm == "on"), row["value"], row["p50_ms"],
                              row["queue_wait_p50_ms"], row["device_p50_ms"],
                              row["requests_per_batch_mean"]))
    out = {}
    for arm, rows in runs.items():
        out[arm] = {"rps_best": max(r[1] for r in rows),
                    "rps_median": statistics.median(r[1] for r in rows),
                    "p50_ms": statistics.median(r[2] for r in rows),
                    "queue_wait_p50_ms": statistics.median(r[3] for r in rows),
                    "dispatch_p50_ms": statistics.median(r[4] for r in rows),
                    "requests_per_batch": statistics.median(r[5] for r in rows)}
    for first in ("off", "on"):
        # best of the rounds where ``first`` ran first, each arm
        sel = {arm: max(r[1] for r in runs[arm] if r[0] == (arm != first))
               for arm in runs}
        out[f"overhead_{first}_first"] = 1.0 - sel["on"] / sel["off"]
    out["overhead_median"] = 1.0 - out["on"]["rps_median"] / out["off"]["rps_median"]
    return out


def diagnostics_ms_per_compute(device, calls=50, warmup=3, n=2048, num_shards=4,
                               seed=0):
    """Median wall (ms) of one diagnostics compute at the fault drill's
    shape (module docstring), and the last report."""
    from dist_svgd_torch.telemetry import MetricsRegistry
    from dist_svgd_torch.telemetry.diagnostics import DiagnosticsConfig, PosteriorDiagnostics
    from dist_svgd_torch.tools.fault_drill import gmm_score_fn
    from dist_svgd_torch.utils.rng import init_particles_per_shard

    parts = init_particles_per_shard(seed, n, 2, num_shards, device=device)
    diag = PosteriorDiagnostics(
        DiagnosticsConfig(every_steps=16, score_fn=gmm_score_fn(),
                          row_chunk=512, max_points=512),
        registry=MetricsRegistry())
    for _ in range(warmup):
        diag.compute(parts, num_shards=num_shards, step=16)
    walls = []
    for _ in range(calls):
        t0 = time.perf_counter()
        report = diag.compute(parts, num_shards=num_shards, step=16)
        walls.append(time.perf_counter() - t0)
    return {"diagnostics_ms_per_compute": statistics.median(walls) * 1e3,
            "min_ms": min(walls) * 1e3, "max_ms": max(walls) * 1e3,
            "calls": calls, "n": n, "num_shards": num_shards,
            "report": {k: report[k] for k in ("ksd", "ess", "min_pairwise_dist",
                                               "median_pairwise_dist", "shard_mean_div")}}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--pairs", type=int, default=40)
    ap.add_argument("--calls", type=int, default=250,
                    help="requests a block of a tracer pair")
    ap.add_argument("--diag-calls", type=int, default=50)
    ap.add_argument("--n-particles", type=int, default=10_000)
    ap.add_argument("--closed-loop-rounds", type=int, default=8)
    args = ap.parse_args(argv)

    import dist_svgd_torch
    from dist_svgd_torch.tools import serve_bench

    engine = serve_bench.build_engine("logreg", args.n_particles, 54, max_bucket=256,
                                      device=args.device)
    engine.warmup()
    row = {"row": "overhead_probe", "package": dist_svgd_torch.__file__,
           "device": args.device}
    row.update(tracer_us_per_request(engine, pairs=args.pairs, calls=args.calls))
    if args.closed_loop_rounds:
        row["closed_loop"] = closed_loop_ab(engine, rounds=args.closed_loop_rounds,
                                            device=args.device)
    row["diagnostics"] = diagnostics_ms_per_compute(args.device, calls=args.diag_calls)
    print(json.dumps(row))
    return 0


if __name__ == "__main__":
    sys.exit(main())
