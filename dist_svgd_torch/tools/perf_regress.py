"""Perf regression gate: re-measure the headline rows on the card against
recorded incumbents.

Counterpart of ``tools/perf_regress.py``, with its row names, constants and
verdicts, over the port's samplers, drills and hand kernels.  One command
re-measures the chained headline rows (the north star, the warm W2 step,
Covertype's bf16x3 tier, the 100,000-particle streaming W2 step, config 1
and the bare φ kernel) and every drill's row, and red-flags a regression at
a noise-aware threshold:

- **chained fenced samples** — every chained timing is the mean wall of a
  chain of state-chained calls under one trailing fence
  (``tools/step_timing.py``): a fence's fixed cost is paid once a sample,
  and the chain is sized from that cost as the card measures it;
- **interleaved rounds** — one sample of *every* bench a round, rounds
  repeated, the least kept a bench: a slow stretch of the host hits every
  bench of that round alike instead of biasing whichever was measured last;
- **noise-aware threshold** — a row FAILs only when it lands more than
  ``--tol`` (35%) below its incumbent, and warns from half that;
- **windowed incumbents** — each ``--record`` appends to a row's history
  window (``_history`` in the incumbents file, the newest ``--window``
  runs); the gate compares with the window's **median** and widens the band
  to ``MAD_SCALE × MAD/median`` where the window is noisier than ``--tol``.

The drill rows (serving, telemetry and diagnostics overheads, the elastic
drill, the sub-quadratic φ, the storm, the fleet, multi-process training,
streaming freshness, the canary rollout, cost attribution) carry
unconditional correctness gates besides their windowed walls: each drill's
``row_ok`` / ``drill_ok``, and zero CUDA-graph captures or hand-kernel
builds inside any steady-state window
(``parallel/plan.py:capture_sentry``, in JAX's retrace sentry's place).
The static sibling of this gate is ``tools/program_audit.py``;
``--list-missing`` reports both files' gaps.

Usage (on the card)::

    python -m dist_svgd_torch.tools.perf_regress            # compare
    python -m dist_svgd_torch.tools.perf_regress --record   # append this run
    python -m dist_svgd_torch.tools.perf_regress --rounds 5 --tol 0.25
    python -m dist_svgd_torch.tools.perf_regress --list-missing   # any host

Prints one JSON line a row plus a summary line; exit code 1 if any row
FAILs, 2 without a card.  The incumbents are this package's own,
``perf_incumbents.json`` beside this file (card numbers; JAX's file holds
TPU numbers and is not read).
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from typing import Dict, Optional

import torch

from dist_svgd_torch.tools.step_timing import (
    N_PARTICLES,
    NUM_SHARDS,
    chain_reps,
    fence,
    fence_cost_s,
    make_phi_kernel_bench,
    make_sharded,
)

INCUMBENTS_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                               "perf_incumbents.json")

#: Per-row widening of ``--tol``.  Config 1's "step" is a few µs of card
#: work under ~2.5 ms of host dispatch (PERF.md §5), so host scheduling
#: swings it far outside the compute rows' band; the wider band still
#: catches a real floor regression (a 2× slower dispatch path fails).
TOL_FACTOR = {"config1_ups": 2.0, "covertype_bf16x3_ups": 1.5,
              # the serving rows measure host thread scheduling and the
              # batcher's wait window as much as the card — wider band
              "serve_throughput": 2.0, "serve_latency_p99": 2.0,
              "serve_sharded": 2.0, "serve_sharded_p99": 2.0,
              "serve_multitenant": 2.0, "serve_multitenant_p99": 2.0,
              # the elastic walls are host checkpoint I/O and one-off
              # rebuilds — as scheduling-noisy as the serve rows
              "elastic_reshard_wall_s": 2.0, "elastic_recovery_wall_s": 2.0,
              # the fleet walls measure probe scheduling and a replica
              # process's restart (readmit includes a cold torch import)
              "fleet_detect_s": 2.0, "fleet_readmit_s": 2.0,
              # the federation sweep is N sequential HTTP scrapes and a
              # dump merge
              "fleet_federation_scrape_ms": 2.0,
              # one big chained run like the compute rows, plus the exact
              # probe's leg — modest widening
              "large_n_approx": 1.5,
              # open-loop scheduling and the controller's real-time
              # reactions — the most host-noisy rows in the suite
              "storm_goodput_2x": 2.0, "storm_recover_s": 2.0,
              # cross-process hops staged through the host and checkpoint
              # I/O
              "multihost_ring_hop_wall_ms": 2.0,
              "multihost_updates_per_s": 2.0,
              # train wall, checkpoint I/O and reload under a real clock
              "freshness_p99_s": 2.0,
              # real-clock stage holds and open-loop replay; the overhead
              # is a p99-over-p99 ratio — the host-noisiest kind of row
              "rollout_promote_s": 2.0, "shadow_overhead_frac": 2.0,
              # closed-loop serving like the serve rows
              "cost_attr_rps": 2.0}

#: Every row key judged against a median+MAD incumbent window — the
#: ``--list-missing`` contract: a key listed here with no history in the
#: incumbents file is a gate that silently cannot fire.  In print order.
WINDOWED_ROWS = (
    "north_star_ups", "w2_warm_ms_per_step", "covertype_bf16x3_ups",
    "w2_streaming_100k_ms_per_step", "config1_ups",
    "phi_kernel_pairs_per_sec",
    "serve_throughput", "serve_latency_p99",
    "serve_sharded", "serve_sharded_p99",
    "serve_multitenant", "serve_multitenant_p99",
    "elastic_reshard_wall_s", "elastic_recovery_wall_s",
    "large_n_approx",
    "storm_goodput_2x", "storm_recover_s",
    "fleet_detect_s", "fleet_readmit_s", "fleet_federation_scrape_ms",
    "multihost_ring_hop_wall_ms", "multihost_updates_per_s",
    "freshness_p99_s",
    "rollout_promote_s", "shadow_overhead_frac",
    "cost_attr_rps",
)

#: Windowed rows whose drill also carries unconditional ``row_ok`` gates —
#: those fire with or without history, so ``--list-missing`` annotates
#: them: an empty window means the row's *regression* gate cannot fire,
#: not that the drill cannot gate at all.
UNCONDITIONAL_ROW_KEYS = frozenset({
    "large_n_approx",
    "storm_goodput_2x", "storm_recover_s",
    "fleet_detect_s", "fleet_readmit_s", "fleet_federation_scrape_ms",
    "multihost_ring_hop_wall_ms", "multihost_updates_per_s",
    "freshness_p99_s",
    "rollout_promote_s", "shadow_overhead_frac",
    "cost_attr_rps",
})

#: Hard ceiling on the span tracer's measured serve cost: the interleaved
#: tracer-off/on A/B (``serve_bench.measure_telemetry_overhead``) FAILs
#: above this fraction regardless of incumbents.
TELEMETRY_OVERHEAD_MAX = 0.03

#: The same ceiling for the dispatch profiler and the usage meter
#: (``cost_drill``'s interleaved off/on A/B).
PROFILER_OVERHEAD_MAX = 0.03

#: The same ceiling for the posterior diagnostics
#: (``fault_drill.measure_diagnostics_overhead``).
DIAGNOSTICS_OVERHEAD_MAX = 0.03

#: serve_throughput row config: logreg d = 55, a 10k-particle ensemble, 16
#: closed-loop clients, mixed 1/4/16-row requests.
SERVE_BENCH_KW = dict(model="logreg", n_particles=10_000, n_features=54,
                      clients=16, requests=1500, rows=(1, 4, 16),
                      max_batch=256, max_wait_ms=2.0)

#: serve_sharded row config: the same load shape as serve_throughput with
#: the ensemble sharded across every card and this many batcher lanes.
SERVE_SHARDED_LANES = 4

#: large_n_approx row config: the RFF φ at a particle count whose exact
#: O(n²) step (extrapolated from the same run's exact probe) is off any
#: dispatch budget.
LARGE_N_APPROX_KW = dict(n=2_000_000, method="rff", num_features=4096,
                         steps=3, samples=2, exact_probe_n=131_072)

#: serve_multitenant row config: 10 heterogeneous tenants behind one
#: registry, serve_throughput's load shape split round-robin.
MULTITENANT_KW = dict(tenants=10, clients=16, requests=1500,
                      rows=(1, 4, 16), max_batch=256, max_wait_ms=2.0)

#: Band widening factor: a row's shortfall tolerance is ``max(tol,
#: MAD_SCALE · MAD/median)`` over its window (3×MAD ≈ 2σ for a normal
#: spread), capped at 0.9.
MAD_SCALE = 3.0

#: The roofline fraction FAILs below this share of its incumbent (a fixed
#: 15%: a ratio of two same-run measurements, so host noise cancels).
ROOFLINE_FLOOR = 0.85

#: The chained rows' default step counts a run (JAX's).
BENCH_STEPS = dict(north_star=500, w2_warm=100, covertype=100, w2_streaming=5,
                   config1=100, phi_sweeps=200)


# --------------------------------------------------------------------- #
# noise-aware judging (pure helpers)


def _median(vals):
    return statistics.median(vals)


def _mad(vals, med=None):
    """Median absolute deviation — the robust spread estimate (a single
    outlier session moves it far less than a stddev)."""
    med = _median(vals) if med is None else med
    return _median([abs(v - med) for v in vals])


def incumbent_history(incumbents: dict, key: str):
    """The row's incumbent window: ``_history[key]`` when recorded, else a
    1-point window seeded from a scalar entry."""
    hist = incumbents.get("_history", {}).get(key)
    if hist:
        return list(hist)
    legacy = incumbents.get(key)
    return [legacy] if isinstance(legacy, (int, float)) else []


def missing_rows(incumbents: dict, expected=WINDOWED_ROWS):
    """Windowed row keys with no incumbent history (neither a ``_history``
    window nor a scalar): their gates return NO_INCUMBENT every run."""
    return [k for k in expected if not incumbent_history(incumbents, k)]


def judge_row(value, history, tol, higher_better, mad_scale=MAD_SCALE):
    """Noise-aware verdict of ``value`` against a window of prior rows.

    The incumbent is the window **median**; the shortfall band is ``tol``
    widened to ``mad_scale × MAD/median`` when the window's own relative
    spread exceeds it (both capped at 0.9).  Returns ``(status, info)`` with
    ``status`` in ``PASS``/``WARN``/``FAIL``/``NO_INCUMBENT``."""
    if not history:
        return "NO_INCUMBENT", {"incumbent": None}
    med = _median(history)
    if med <= 0:
        return "NO_INCUMBENT", {"incumbent": med}
    band = min(max(tol, mad_scale * _mad(history, med) / med), 0.9)
    # regression ratio, oriented so >1 means better than incumbent
    ratio = value / med if higher_better else med / value
    info = {
        "incumbent": med,
        "window": len(history),
        "window_rel_mad": round(_mad(history, med) / med, 4),
        "band": round(band, 3),
        "vs_incumbent": round(ratio, 3),
    }
    if ratio < 1 - band:
        return "FAIL", info
    if ratio < 1 - band / 2:
        return "WARN", info
    return "PASS", info


def record_result(incumbents: dict, key: str, value, window: int) -> None:
    """Append ``value`` to the row's history window (seeding it from a
    scalar incumbent first) and refresh the scalar entry to the window
    median."""
    if window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    hist = incumbents.setdefault("_history", {}).setdefault(key, [])
    legacy = incumbents.get(key)
    if not hist and isinstance(legacy, (int, float)):
        hist.append(legacy)
    hist.append(value)
    del hist[:-window]
    incumbents[key] = _median(hist)


def load_incumbents(path: str = INCUMBENTS_PATH) -> dict:
    with open(path) as fh:
        return json.load(fh)


def _judge_into(row, key, value, incumbents, args, higher, offset=0.0) -> int:
    """Judge ``value`` against ``key``'s window at ``args.tol`` widened by
    :data:`TOL_FACTOR`, write the verdict into ``row``; 1 if it FAILed.
    ``offset`` is added to the value and the window alike (a metric whose
    healthy value is 0)."""
    tol = min(args.tol * TOL_FACTOR.get(key, 1.0), 0.9)
    hist = [h + offset for h in incumbent_history(incumbents, key)]
    status, info = judge_row(value + offset, hist, tol, higher)
    row.update(info)
    row["status"] = status
    return int(status == "FAIL")


# --------------------------------------------------------------------- #
# the chained rows


def build_benches(device=None, n=N_PARTICLES, w2_streaming_n=100_000,
                  covertype_rows=50_000, config1_n=100, steps=None):
    """The chained headline rows, on the port's samplers.  Each entry:
    ``key -> (run, to_value, unit, higher_better)``, where ``run()``
    advances real sampler state (chained calls cannot be elided) and
    ``to_value(wall_per_run)`` turns one run's seconds into the metric.
    The sizes default to JAX's (``steps``: :data:`BENCH_STEPS`); smaller
    ones rehearse the rows on the CPU."""
    from dist_svgd_torch.distsampler import DistSampler
    from dist_svgd_torch.models.logreg import logreg_likelihood, logreg_logp, logreg_prior
    from dist_svgd_torch.sampler import Sampler
    from dist_svgd_torch.utils.datasets import load_benchmark, load_covertype
    from dist_svgd_torch.utils.platform import resolve_device
    from dist_svgd_torch.utils.rng import init_particles_per_shard

    dev = resolve_device(device)
    st = dict(BENCH_STEPS, **(steps or {}))
    fold = load_benchmark("banana", 42)
    d = 1 + fold.x_train.shape[1]
    benches = {}

    # 1. the north-star sharded step (the bench.py headline)
    ns = make_sharded(fold, n=n, device=dev)
    k1 = st["north_star"]
    benches["north_star_ups"] = (
        lambda: ns.run_steps(k1, 3e-3), lambda w: n * k1 / w, "updates/sec", True,
    )

    # 2. warm-started Sinkhorn W2 (the duals carried between steps)
    w2 = make_sharded(fold, wasserstein=True, n=n, device=dev)
    k2 = st["w2_warm"]
    benches["w2_warm_ms_per_step"] = (
        lambda: w2.run_steps(k2, 3e-3, h=10.0), lambda w: w / k2 * 1e3, "ms/step", False,
    )

    # 3. Covertype in the bf16x3 tier (big-d, minibatched: the tier's home)
    cx, ct = load_covertype(covertype_rows)
    ct_d = 1 + cx.shape[1]
    cov = DistSampler(
        NUM_SHARDS, logreg_likelihood, None,
        init_particles_per_shard(0, n, ct_d, NUM_SHARDS), data=(cx, ct),
        exchange_particles=True, exchange_scores=False,
        include_wasserstein=False, shard_data=True, batch_size=256,
        log_prior=logreg_prior, phi_impl="cuda_bf16", device=dev,
    )
    k3 = st["covertype"]
    benches["covertype_bf16x3_ups"] = (
        lambda: cov.run_steps(k3, 1e-4), lambda w: n * k3 / w, "updates/sec", True,
    )

    # 4. streaming W2 at 100k particles (the streaming route, warm duals,
    # the harsh 3e-3 / h = 10 point)
    w2s = make_sharded(fold, wasserstein=True, n=w2_streaming_n, device=dev)
    k4 = st["w2_streaming"]
    benches["w2_streaming_100k_ms_per_step"] = (
        lambda: w2s.run_steps(k4, 3e-3, h=10.0), lambda w: w / k4 * 1e3, "ms/step", False,
    )

    # 5. config 1's floor (100-particle single sampler — a dispatch-bound
    # row); the data rides the sampler, cast to the particles' dtype
    c1 = Sampler(d, logreg_logp, data=(fold.x_train, fold.t_train.reshape(-1)), device=dev)
    c1_state = {"out": None}
    k5 = st["config1"]

    def c1_run():
        c1_state["out"] = c1.run(
            config1_n, k5, 3e-3, seed=0, record=False,
            initial_particles=c1_state["out"],
        )[0]
        return c1_state["out"]

    benches["config1_ups"] = (
        c1_run, lambda w: config1_n * k5 / w, "updates/sec", True,
    )

    # 6. the bare φ kernel on the north-star shapes — the same-run roofline
    # of the utilisation-fraction row
    phi_run, phi_pairs = make_phi_kernel_bench(d, device=dev, n=n, sweeps=st["phi_sweeps"])
    benches["phi_kernel_pairs_per_sec"] = (
        phi_run, lambda w: phi_pairs / w, "pairs/sec", True,
    )
    return benches


def measure_chained(benches, rounds, target_s, label="perf_regress measurement rounds"):
    """Warm each bench up, size its chain once from a fenced call (the
    fence's own cost taken off, ``step_timing.chain_reps``), then run
    ``rounds`` interleaved rounds — one fenced chained sample of every bench
    a round — under ``capture_sentry``: everything was built in the warm-up,
    so a capture or a kernel build inside a round is a steady-state fault.
    Returns ``(best seconds a run, reps, sentry)``."""
    from dist_svgd_torch.parallel.plan import capture_sentry

    reps = {}
    for key, (run, _, _, _) in benches.items():
        fence(run())
        t0 = time.perf_counter()
        out = run()
        fence(out)
        est = time.perf_counter() - t0
        reps[key] = chain_reps(est, fence_cost_s(out), target_s)
    best = {key: float("inf") for key in benches}
    with capture_sentry(label) as sentry:
        for _ in range(rounds):
            for key, (run, _, _, _) in benches.items():
                t0 = time.perf_counter()
                out = None
                for _ in range(reps[key]):
                    out = run()
                fence(out)
                best[key] = min(best[key], (time.perf_counter() - t0) / reps[key])
    return best, reps, sentry


def chained_rows(benches, best, reps, sentry, incumbents, args):
    """The ``steady_state_recompiles`` row and one judged row a bench."""
    rows, failures, results = [], 0, {}
    row = {"bench": "steady_state_recompiles", "value": sentry.compiles,
           "unit": "CUDA-graph captures and kernel builds in the timed rounds",
           "supported": sentry.supported}
    if sentry.supported and sentry.compiles:
        row["status"] = "FAIL"
        failures += 1
    else:
        row["status"] = "PASS" if sentry.supported else "NO_SENTRY"
    rows.append(row)
    for key, (_, to_value, unit, higher) in benches.items():
        value = to_value(best[key])
        row = {"bench": key, "value": round(value, 2), "unit": unit, "reps": reps[key]}
        failures += _judge_into(row, key, value, incumbents, args, higher)
        results[key] = value
        rows.append(row)
    return rows, failures, results


def roofline_rows(results, incumbents, n=N_PARTICLES):
    """The north-star step's pair rate (updates/s × n: each update is one
    row of n pair interactions) over the same run's bare-φ pair rate, gated
    at a fixed :data:`ROOFLINE_FLOOR` of the incumbent fraction."""
    rows, failures, out = [], 0, {}
    frac_key = "north_star_roofline_fraction"
    if "north_star_ups" in results and "phi_kernel_pairs_per_sec" in results:
        fraction = results["north_star_ups"] * n / results["phi_kernel_pairs_per_sec"]
        inc_frac = incumbents.get(frac_key)
        row = {"bench": frac_key, "value": round(fraction, 4),
               "unit": "step pairs/s over same-session bare-φ pairs/s",
               "incumbent": inc_frac}
        if inc_frac:
            ratio = fraction / inc_frac
            row["vs_incumbent"] = round(ratio, 3)
            if ratio < ROOFLINE_FLOOR:
                row["status"] = "FAIL"
                failures += 1
            else:
                row["status"] = "PASS"
        else:
            row["status"] = "NO_INCUMBENT"
        out[frac_key] = round(fraction, 4)
        rows.append(row)
    return rows, failures, out


# --------------------------------------------------------------------- #
# the serving rows


def _serve_rounds(args, bench, **kw):
    """``args.rounds`` runs of ``bench``: the best row and the recompile
    counters summed over every round (an intermittent capture in a
    discarded round still broke the steady-state contract)."""
    best, recompiles, sentry_compiles, supported = None, 0, 0, True
    for _ in range(args.rounds):
        srow = bench(**kw)
        recompiles += srow["recompiles"]
        sc = srow.get("sentry_compiles")
        if sc is None:
            supported = False
        else:
            sentry_compiles += sc
        if best is None or srow["value"] > best["value"]:
            best = srow
    return best, recompiles, (sentry_compiles if supported else None)


def _latency_row(key, value, incumbents, args, what):
    row = {"bench": key, "value": value, "unit": "ms"}
    if not value:
        # an empty histogram over a non-empty window: the telemetry
        # plumbing broke — FAIL instead of running without the gate
        row["status"] = "FAIL"
        row["error"] = f"empty {what} histogram: the row carried no telemetry percentiles"
        return row, 1, {}
    return row, _judge_into(row, key, value, incumbents, args, False), {key: value}


def serve_rows(incumbents, args, device=None):
    """serve_throughput (best of ``args.rounds`` closed-loop runs; any
    in-window bucket miss or capture, or a breached SLO, FAILs) and
    serve_latency_p99 (the telemetry histogram's tail, lower is better).
    Returns ``(rows, failures, results, best_serve_row)``."""
    from dist_svgd_torch.tools import serve_bench

    key = "serve_throughput"
    best, recompiles, sentry_compiles = _serve_rounds(
        args, serve_bench.run_bench, device=device, **SERVE_BENCH_KW)
    row = {"bench": key, "value": best["value"], "unit": "requests/sec",
           "p50_ms": best["p50_ms"], "p99_ms": best["p99_ms"],
           "batch_occupancy_mean": best["batch_occupancy_mean"],
           "recompiles": recompiles, "sentry_compiles": sentry_compiles,
           "slo_status": best.get("slo_status")}
    failures = 0
    if recompiles or sentry_compiles:
        row["status"] = "FAIL"
        failures += 1
    elif best.get("slo_status") == "breach":
        row["status"] = "FAIL"
        row["slo"] = best.get("slo")
        failures += 1
    else:
        failures += _judge_into(row, key, best["value"], incumbents, args, True)
    results = {key: best["value"]}
    lat_row, lat_fail, lat_res = _latency_row(
        "serve_latency_p99", best.get("serve_latency_p99"), incumbents, args, "serve-latency")
    results.update(lat_res)
    return [row, lat_row], failures + lat_fail, results, best


def serve_sharded_rows(incumbents, args, serve_best, device=None):
    """serve_sharded and serve_sharded_p99: the serve load with the
    ensemble sharded across every card and :data:`SERVE_SHARDED_LANES`
    lanes.  With fewer than two cards no mesh can exist: one ``NO_MESH``
    row.  With two or more, ``serve_bench.run_bench(devices=n)`` serves
    over ``make_plan(n)``'s mesh and the row carries ``vs_single_device``
    against the single-device serve row."""
    from dist_svgd_torch.parallel import plan
    from dist_svgd_torch.tools import serve_bench
    from dist_svgd_torch.utils.platform import resolve_device

    n_dev = plan.visible_devices(resolve_device(device))
    key = "serve_sharded"
    if n_dev < 2:
        return [{"bench": key, "status": "NO_MESH", "devices": n_dev}], 0, {}
    best, recompiles, sentry_compiles = _serve_rounds(
        args, serve_bench.run_bench, devices=n_dev, lanes=SERVE_SHARDED_LANES,
        device=device, **SERVE_BENCH_KW)
    row = {"bench": key, "value": best["value"], "unit": "requests/sec",
           "devices": best["devices"], "lanes": best["lanes"],
           "p50_ms": best["p50_ms"], "p99_ms": best["p99_ms"],
           "lane_fairness": best["lane_fairness"]["requests"],
           "vs_single_device": (round(best["value"] / serve_best["value"], 3)
                                if serve_best["value"] else None),
           "recompiles": recompiles, "sentry_compiles": sentry_compiles,
           "slo_status": best.get("slo_status")}
    rows, failures, results = [row], 0, {}
    if best["devices"] < 2:
        row["status"] = "NO_MESH"
        return rows, 0, {}
    if recompiles or sentry_compiles:
        row["status"] = "FAIL"
        failures += 1
    elif best.get("slo_status") == "breach":
        row["status"] = "FAIL"
        row["slo"] = best.get("slo")
        failures += 1
    else:
        failures += _judge_into(row, key, best["value"], incumbents, args, True)
    results[key] = best["value"]
    lat_row, lat_fail, lat_res = _latency_row(
        "serve_sharded_p99", best.get("serve_latency_p99"), incumbents, args,
        "sharded serve-latency")
    results.update(lat_res)
    rows.append(lat_row)
    return rows, failures + lat_fail, results


def multitenant_rows(incumbents, args, device=None):
    """serve_multitenant (10 tenants behind one registry; any in-window
    recompile, or a protective probe that saw nothing, FAILs) and
    serve_multitenant_p99 (the worst tenant's p99)."""
    from dist_svgd_torch.tools import serve_bench

    key = "serve_multitenant"
    best, recompiles, sentry_compiles = _serve_rounds(
        args, serve_bench.run_multitenant_bench, device=device, **MULTITENANT_KW)
    row = {"bench": key, "value": best["value"], "unit": "requests/sec",
           "tenants": best["tenants"], "tenant_fairness": best["tenant_fairness"],
           "p99_worst_tenant_ms": best["p99_worst_tenant_ms"],
           "evictions": best["evictions"], "quota_sheds": best["quota_sheds"],
           "recompiles": recompiles, "sentry_compiles": sentry_compiles}
    failures, results = 0, {}
    if recompiles or sentry_compiles:
        row["status"] = "FAIL"
        failures += 1
    elif best["evictions"] < 1 or best["quota_sheds"] < 1:
        row["status"] = "FAIL"
        row["error"] = ("protective machinery unobserved: eviction probe "
                        f"saw {best['evictions']} evictions, quota "
                        f"probe {best['quota_sheds']} priority sheds")
        failures += 1
    else:
        failures += _judge_into(row, key, best["value"], incumbents, args, True)
        results[key] = best["value"]
    lat_key = "serve_multitenant_p99"
    lat = best.get("p99_worst_tenant_ms")
    lat_row = {"bench": lat_key, "value": lat, "unit": "ms (worst tenant)"}
    if not lat:
        lat_row["status"] = "FAIL"
        lat_row["error"] = ("empty multi-tenant latency distribution: the "
                            "serve_multitenant row carried no per-tenant p99")
        failures += 1
    else:
        failures += _judge_into(lat_row, lat_key, lat, incumbents, args, False)
        results[lat_key] = lat
    return [row, lat_row], failures, results


def overhead_rows(incumbents, args, device=None):
    """telemetry_overhead (tracer off/on over the serve bench) and
    diagnostics_overhead (the supervised run with and without the
    posterior diagnostics), each against its fixed ceiling; never
    recorded."""
    from dist_svgd_torch.tools import fault_drill, serve_bench

    rows, failures = [], 0
    ov = serve_bench.measure_telemetry_overhead(rounds=args.rounds, device=device,
                                                **SERVE_BENCH_KW)
    row = {"bench": "telemetry_overhead", "value": ov["overhead_frac"],
           "unit": "fraction of serve rps lost with tracing enabled",
           "rps_disabled": ov["rps_disabled"], "rps_enabled": ov["rps_enabled"],
           "ceiling": TELEMETRY_OVERHEAD_MAX}
    row["status"] = "FAIL" if ov["overhead_frac"] > TELEMETRY_OVERHEAD_MAX else "PASS"
    failures += row["status"] == "FAIL"
    rows.append(row)
    dov = fault_drill.measure_diagnostics_overhead(rounds=args.rounds, device=device)
    row = {"bench": "diagnostics_overhead", "value": dov["overhead_frac"],
           "unit": "fraction of supervised-run wall added by diagnostics",
           "wall_off_s": dov["wall_off_s"], "wall_on_s": dov["wall_on_s"],
           "ceiling": DIAGNOSTICS_OVERHEAD_MAX}
    row["status"] = "FAIL" if dov["overhead_frac"] > DIAGNOSTICS_OVERHEAD_MAX else "PASS"
    failures += row["status"] == "FAIL"
    rows.append(row)
    return rows, int(failures), {}


# --------------------------------------------------------------------- #
# the drill rows


def elastic_rows(incumbents, args, device=None):
    """elastic_resume (``elastic_drill.drill_ok``: resumed within tolerance,
    grow-back, fallback, serve, no capture after the reshard) and, when it
    passes, its reshard and recovery walls (lower is better)."""
    from dist_svgd_torch.tools import elastic_drill

    erow = elastic_drill.run_drill(device=device)
    correct = elastic_drill.drill_ok(erow)
    row = {"bench": "elastic_resume",
           "shards": f"{erow['shards_from']}->{erow['shards_to']}",
           "steps_lost": erow["steps_lost"],
           "post_reshard_recompiles": erow["post_reshard_recompiles"],
           "sentry_supported": erow["sentry_supported"],
           "elastic_final_max_dev": erow["elastic_final_max_dev"],
           "ksd_delta_frac": erow["ksd_delta_frac"],
           "grow_ok": erow["grow_ok"], "fallback_ok": erow["fallback_ok"],
           "serve_ok": erow["serve_ok"],
           "status": "PASS" if correct else "FAIL"}
    rows, failures, results = [row], int(not correct), {}
    if correct:
        for key, field in (("elastic_reshard_wall_s", "reshard_wall_s"),
                           ("elastic_recovery_wall_s", "recovery_wall_s")):
            value = erow[field]
            wrow = {"bench": key, "value": value, "unit": "s"}
            if value is None:
                wrow["status"] = "FAIL"
                wrow["error"] = f"drill row carried no {field}"
                failures += 1
            else:
                failures += _judge_into(wrow, key, value, incumbents, args, False)
                results[key] = value
            rows.append(wrow)
    return rows, failures, results


def large_n_rows(incumbents, args, device=None):
    """large_n_approx: the RFF φ at 2,000,000 particles; FAILs outside its
    error budget or on an in-window capture, else judged on updates/s."""
    from dist_svgd_torch.tools import large_n

    arow = large_n.run_approx_row(device=device, **LARGE_N_APPROX_KW)
    a_ok, a_why = large_n.approx_row_ok(arow)
    key = "large_n_approx"
    row = {"bench": key, "value": arow["updates_per_sec"],
           "unit": "updates/sec", "n": arow["n"], "method": arow["method"],
           "dial": arow["dial"], "approx_rel_err": arow["approx_rel_err"],
           "error_budget": arow["error_budget"],
           "within_budget": arow["within_budget"],
           "recompiles": arow["recompiles"],
           "exact_est_wall_per_step_s": arow["exact_est_wall_per_step_s"],
           "est_speedup_vs_exact": arow["est_speedup_vs_exact"]}
    if not a_ok:
        row["status"] = "FAIL"
        row["error"] = "; ".join(a_why)
        return [row], 1, {}
    failures = _judge_into(row, key, arow["updates_per_sec"], incumbents, args, True)
    return [row], failures, {key: arow["updates_per_sec"]}


def storm_rows(incumbents, args, device=None):
    """serve_storm (``workload_replay.storm_ok``: no lost request, no
    in-window capture) judged on the adaptive arm's polite goodput, and
    storm_recover_s (judged on a +1 s offset: an instant recovery is 0)."""
    from dist_svgd_torch.tools import workload_replay

    wrow = workload_replay.run_storm(device=device)
    w_ok, w_why = workload_replay.storm_ok(wrow)
    key = "storm_goodput_2x"
    row = {"bench": "serve_storm", "value": wrow[key], "unit": wrow["unit"],
           "capacity_rows_per_s": wrow["capacity_rows_per_s"],
           "p99_breach_s": wrow["storm_p99_breach_s"],
           "recover_s": wrow["storm_recover_s"],
           "lost_requests": wrow["lost_requests"],
           "shed_requests": wrow["shed_requests"],
           "recompiles": wrow["recompiles"],
           "sentry_compiles": wrow["sentry_compiles"], "ab": wrow["ab"]}
    if not w_ok:
        row["status"] = "FAIL"
        row["error"] = "; ".join(w_why)
        return [row], 1, {}
    failures = _judge_into(row, key, wrow[key], incumbents, args, True)
    results = {key: wrow[key]}
    rec_key = "storm_recover_s"
    rec = wrow["storm_recover_s"]
    rrow = {"bench": rec_key, "value": rec, "unit": "s"}
    failures += _judge_into(rrow, rec_key, rec, incumbents, args, False, offset=1.0)
    results[rec_key] = rec
    return [row, rrow], failures, results


def fleet_rows(incumbents, args, device=None):
    """fleet_failover (the real drill: three replica processes, one killed,
    one partitioned; ``fleet_drill.row_ok``), its detect / readmit /
    federation-scrape walls, and fleet_trace_stitch (the fake drill's
    stitch coverage must be 1.0 and the federated counters monotone)."""
    from dist_svgd_torch.tools import fleet_drill

    frow = fleet_drill.run_drill(mode="real", device=device)
    fleet_ok, fleet_why = fleet_drill.row_ok(frow)
    row = {"bench": "fleet_failover", "value": frow["value"],
           "unit": frow["unit"], "mode": frow["mode"],
           "replicas": frow["replicas"], "requests": frow["requests"],
           "lost_requests": frow["lost_requests"],
           "shed_requests": frow["shed_requests"],
           "misroutes": frow["misroutes"],
           "detect_probe_intervals": frow["detect_probe_intervals"],
           "p99_partition_ms": frow["p99_partition_ms"],
           "partition_replica_alive": frow["partition_replica_alive"],
           "partition_flight_trips": frow["partition_flight_trips"]}
    rows, failures, results = [row], 0, {}
    if not fleet_ok:
        row["status"] = "FAIL"
        row["error"] = "; ".join(fleet_why)
        failures += 1
    else:
        row["status"] = "PASS"
        for key, field in (("fleet_detect_s", "detect_s"),
                           ("fleet_readmit_s", "readmit_s"),
                           ("fleet_federation_scrape_ms", "federation_scrape_ms")):
            value = frow[field]
            wrow = {"bench": key, "value": value,
                    "unit": "ms" if key.endswith("_ms") else "s"}
            failures += _judge_into(wrow, key, value, incumbents, args, False)
            results[key] = value
            rows.append(wrow)
    fake = fleet_drill.run_drill(mode="fake")
    cov = fake.get("trace_stitch_coverage")
    srow = {"bench": "fleet_trace_stitch", "value": cov,
            "unit": "fraction of served routes stitched to a replica tree",
            "served_routes": fake.get("stitch_served_routes"),
            "retry_trees": fake.get("stitch_retry_trees"),
            "orphans": fake.get("stitch_orphans"),
            "federation_monotone": fake.get("federation_monotone")}
    if cov is None or cov < 1.0:
        srow["status"] = "FAIL"
        srow["error"] = (f"stitch coverage {cov} < 1.0 — a served request's router "
                         "and replica spans no longer join on the trace id")
        failures += 1
    elif fake.get("federation_monotone") is False:
        srow["status"] = "FAIL"
        srow["error"] = ("a federated counter rollup decreased across scrapes — "
                         "the restart clamp broke")
        failures += 1
    else:
        srow["status"] = "PASS"
    rows.append(srow)
    return rows, failures, results


def multihost_rows(incumbents, args, device=None):
    """multihost_train (``multihost_train.row_ok``; an up-front refusal is
    UNSUPPORTED, not a FAIL) and, when it passes, the ring hop wall and the
    gather arm's updates/s."""
    from dist_svgd_torch.tools import multihost_train

    mh = multihost_train.run_drill(mode="auto", device=device)
    mh_ok, mh_why = multihost_train.row_ok(mh)
    row = {"bench": "multihost_train", "mode": mh.get("mode"),
           "status_detail": mh.get("status")}
    if mh.get("status") == "unsupported":
        row["status"] = "UNSUPPORTED"
        row["reason"] = mh.get("unsupported_reason")
        return [row], 0, {}
    row.update({
        "processes": mh.get("processes"),
        "shards": f"{mh.get('shards')}->{mh.get('shards_after_loss')}",
        "dcn_crossings_per_hop": mh.get("dcn_crossings_per_hop"),
        "resume_bitwise": mh.get("resume_bitwise"),
        "rng_layout_free": mh.get("rng_layout_free"),
        "steps_lost": mh.get("steps_lost"),
        "killone_max_dev": mh.get("killone_max_dev"),
        "post_restart_recompiles": mh.get("post_restart_recompiles"),
        "federation_restarts": mh.get("federation_restarts"),
    })
    rows, failures, results = [row], 0, {}
    if not mh_ok:
        row["status"] = "FAIL"
        row["error"] = "; ".join(mh_why)
        return rows, 1, {}
    row["status"] = "PASS"
    for key, field, higher in (("multihost_ring_hop_wall_ms", "ring_hop_wall_ms", False),
                               ("multihost_updates_per_s", "updates_per_s_gather", True)):
        value = mh.get(field)
        wrow = {"bench": key, "value": value,
                "unit": "ms" if key.endswith("_ms") else "updates/sec"}
        if value is None:
            wrow["status"] = "FAIL"
            wrow["error"] = f"drill row carried no {field}"
            failures += 1
        else:
            failures += _judge_into(wrow, key, value, incumbents, args, higher)
            results[key] = value
        rows.append(wrow)
    return rows, failures, results


def freshness_rows(incumbents, args, device=None):
    """freshness (``freshness_drill.row_ok``) and, when it passes,
    freshness_p99_s (event time → first serve, lower is better)."""
    from dist_svgd_torch.tools import freshness_drill

    fr = freshness_drill.run_drill(device=device)
    fr_ok, fr_why = freshness_drill.row_ok(fr)
    row = {"bench": "freshness",
           "freshness_p50_s": fr.get("freshness_p50_s"),
           "freshness_p99_s": fr.get("freshness_p99_s"),
           "resumed_bitwise_identical": fr.get("resumed_bitwise_identical"),
           "drift_detect_segments": fr.get("drift_detect_segments"),
           "refits": fr.get("refits"), "reloads": fr.get("reloads"),
           "reload_rejections": fr.get("reload_rejections"),
           "dropped_total": fr.get("dropped_total"),
           "steady_state_recompiles": fr.get("steady_state_recompiles"),
           "slo_status": fr.get("slo_status")}
    if not fr_ok:
        row["status"] = "FAIL"
        row["error"] = "; ".join(fr_why)
        return [row], 1, {}
    row["status"] = "PASS"
    key = "freshness_p99_s"
    value = fr.get(key)
    wrow = {"bench": key, "value": value, "unit": "s"}
    failures = _judge_into(wrow, key, value, incumbents, args, False)
    return [row, wrow], failures, {key: value}


def rollout_rows(incumbents, args, device=None):
    """canary_rollout (``rollout_drill.row_ok``) and, when it passes,
    rollout_promote_s and shadow_overhead_frac (judged on a +1 offset:
    the healthy overhead is 0)."""
    from dist_svgd_torch.tools import rollout_drill

    ro = rollout_drill.run_drill(device=device)
    ro_ok, ro_why = rollout_drill.row_ok(ro)
    good, bad = ro.get("good") or {}, ro.get("bad") or {}
    row = {"bench": "canary_rollout",
           "rollout_promote_s": ro.get("rollout_promote_s"),
           "shadow_overhead_frac": ro.get("shadow_overhead_frac"),
           "good_stages": good.get("stages"),
           "bad_at_stage": bad.get("at_stage"),
           "bad_peak_fraction": bad.get("peak_fraction"),
           "checkpoint_reloads_on_rollback": bad.get("checkpoint_reloads"),
           "client": ro.get("client"),
           "mirrors_total": ro.get("mirrors_total"),
           "mirror_dropped": ro.get("mirror_dropped"),
           "steady_state_recompiles": ro.get("steady_state_recompiles")}
    if not ro_ok:
        row["status"] = "FAIL"
        row["error"] = "; ".join(ro_why)
        return [row], 1, {}
    row["status"] = "PASS"
    rows, failures, results = [row], 0, {}
    for key, unit, offset in (("rollout_promote_s", "s", 0.0),
                              ("shadow_overhead_frac", "frac", 1.0)):
        value = ro.get(key)
        wrow = {"bench": key, "value": value, "unit": unit}
        failures += _judge_into(wrow, key, value, incumbents, args, False, offset=offset)
        results[key] = value
        rows.append(wrow)
    return rows, failures, results


def cost_rows(incumbents, args, device=None):
    """cost_attribution (``cost_drill.row_ok``: coverage, the tenant sum,
    no in-window recompile), profiler_overhead against its fixed ceiling,
    and, when the drill passes, cost_attr_rps."""
    from dist_svgd_torch.tools import cost_drill

    ca = cost_drill.run_drill(device=device)
    ca_ok, ca_why = cost_drill.row_ok(ca)
    row = {"bench": "cost_attribution",
           "coverage": ca.get("coverage"),
           "attributed_s": ca.get("attributed_s"),
           "measured_device_s": ca.get("measured_device_s"),
           "tenant_device_s": ca.get("tenant_device_s"),
           "tenant_sum_err_frac": ca.get("tenant_sum_err_frac"),
           "recompiles": ca.get("recompiles"),
           "sentry_compiles": ca.get("sentry_compiles"),
           "history_records": ca.get("history_records"),
           "history_anomalies": ca.get("history_anomalies")}
    failures, results = 0, {}
    if not ca_ok:
        row["status"] = "FAIL"
        row["error"] = "; ".join(ca_why)
        failures += 1
    else:
        row["status"] = "PASS"
    ov = ca.get("profiler_overhead_frac")
    orow = {"bench": "profiler_overhead", "value": ov,
            "unit": "fraction of serve rps lost with profiler+metering on",
            "rps_disabled": ca.get("rps_disabled"),
            "rps_enabled": ca.get("rps_enabled"),
            "ceiling": PROFILER_OVERHEAD_MAX}
    if ov is None or ov > PROFILER_OVERHEAD_MAX:
        orow["status"] = "FAIL"
        failures += 1
    else:
        orow["status"] = "PASS"
    rows = [row, orow]
    if ca_ok:
        key = "cost_attr_rps"
        value = ca.get("rps")
        wrow = {"bench": key, "value": value, "unit": "req/s"}
        failures += _judge_into(wrow, key, value, incumbents, args, True)
        results[key] = value
        rows.append(wrow)
    return rows, failures, results


#: The drill row families after the serving rows, in JAX's print order.
DRILL_FAMILIES = (multitenant_rows, overhead_rows, elastic_rows, large_n_rows,
                  storm_rows, fleet_rows, multihost_rows, freshness_rows,
                  rollout_rows, cost_rows)


# --------------------------------------------------------------------- #


def _git_commit() -> str:
    """The checkout's commit, or ``'unknown'`` where it is no git
    repository (a copy of the tree)."""
    try:
        return subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"], capture_output=True, text=True,
            check=True, timeout=30,
            cwd=os.path.dirname(os.path.abspath(__file__))).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def _card() -> str:
    """``nvidia-smi``'s name and power limit of the card."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=30).stdout
        return out.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return torch.cuda.get_device_name(0)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=3,
                    help="interleaved measurement rounds (min kept)")
    ap.add_argument("--tol", type=float, default=0.35,
                    help="FAIL when a row lands this fraction below its "
                         "incumbent (warn from tol/2)")
    ap.add_argument("--target-s", type=float, default=1.0,
                    help="device work per fenced sample (chain sizing)")
    ap.add_argument("--record", action="store_true",
                    help="append this run to the incumbent history windows "
                         "(refused when any row FAILs — see --force)")
    ap.add_argument("--window", type=int, default=8,
                    help="incumbent history window per row (median + MAD "
                         "band judged over the newest N recorded runs)")
    ap.add_argument("--force", action="store_true",
                    help="allow --record even when rows FAIL (deliberately "
                         "lowering the bar, e.g. after a hardware change)")
    ap.add_argument("--list-missing", action="store_true",
                    help="print the windowed rows with no incumbent history "
                         "and exit (works without a card: it only reads the "
                         "incumbents file)")
    ap.add_argument("--commit", default=None,
                    help="the measured tree's commit for --record's note "
                         "(default: git rev-parse of the checkout)")
    return ap


def list_missing() -> dict:
    """The ``--list-missing`` report: windowed rows without history, the
    kind of gate each leaves dormant, and the program audit's builders
    without a baseline card (the static sibling, audited in the same
    breath)."""
    from dist_svgd_torch.tools import program_audit

    missing = missing_rows(load_incumbents())
    return {
        "windowed_rows": len(WINDOWED_ROWS),
        "missing": missing,
        # every missing row's windowed gate is dormant; the annotated ones
        # still FAIL on their drill's row_ok checks with an empty history
        "gates": {k: ("windowed+unconditional" if k in UNCONDITIONAL_ROW_KEYS
                      else "windowed") for k in missing},
        "program_audit_missing": program_audit.missing_builders(
            program_audit.load_baseline()),
    }


def _emit(rows) -> None:
    for row in rows:
        print(json.dumps(row), flush=True)


def main(argv: Optional[list] = None) -> int:
    args = build_parser().parse_args(argv)
    if args.list_missing:
        # before the card check on purpose: auditing the file needs no card
        print(json.dumps(list_missing()))
        return 0
    if not torch.cuda.is_available():
        print(json.dumps({"error": "perf_regress needs a CUDA card (the "
                          "incumbents are the card's numbers)", "platform": "cpu"}))
        return 2
    device = "cuda"
    incumbents = load_incumbents()
    failures = 0
    results: Dict[str, float] = {}

    def take(out):
        nonlocal failures
        rows, fails, res = out[:3]
        _emit(rows)
        failures += fails
        results.update(res)

    benches = build_benches(device)
    best, reps, sentry = measure_chained(benches, args.rounds, args.target_s)
    take(chained_rows(benches, best, reps, sentry, incumbents, args))
    take(roofline_rows(results, incumbents))
    out = serve_rows(incumbents, args, device)
    take(out)
    take(serve_sharded_rows(incumbents, args, out[3], device))
    for family in DRILL_FAMILIES:
        take(family(incumbents, args, device))

    print(json.dumps({"summary": "FAIL" if failures else "PASS", "failures": failures,
                      "rounds": args.rounds, "tol": args.tol}))
    if args.record and failures and not args.force:
        # never silently ratchet the bar down: recording a FAILing run would
        # launder the regression into the baseline every future gate passes
        print(json.dumps({"record_refused": f"{failures} row(s) FAILed; pass --force to "
                                            "deliberately lower the incumbents"}))
        return 1
    if args.record:
        # the roofline fraction keeps its fixed-threshold scalar (it is a
        # same-run ratio already)
        for key, value in results.items():
            if key == "north_star_roofline_fraction":
                incumbents[key] = value
            else:
                record_result(incumbents, key, value, args.window)
        incumbents["recorded"] = (
            f"perf_regress --record (rounds={args.rounds}, window={args.window}) on "
            f"{_card()}, commit {args.commit or _git_commit()}")
        with open(INCUMBENTS_PATH, "w") as fh:
            json.dump(incumbents, fh, indent=2)
            fh.write("\n")
        print(json.dumps({"recorded_to": INCUMBENTS_PATH}))
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
