"""Rollout drill: measure progressive delivery end to end and emit ONE
``canary_rollout`` JSON row.

Counterpart of ``tools/rollout_drill.py`` (the same legs, JAX's row keys
plus the shadow-overhead gate's three, JAX's ``row_ok`` gates but that
one).  Three legs over one warmed
single-tenant :class:`ModelRegistry` (logreg posterior, one pinned
padding bucket so the steady windows capture no graph by construction):

1. **shadow overhead, paired A/B** — arm a rollout whose plan can
   never leave the shadow stage (infinite hold), offer a near-identical
   candidate, then alternate ``--overhead-pairs`` (baseline, shadow)
   segment pairs: each pair replays the *identical* Poisson sub-trace
   twice back to back, first with the batcher's rollout hook disarmed
   (pure incumbent serving) and then re-armed LIVE (mirrors flowing).
   ``shadow_overhead_frac`` is the **median per-pair p99 ratio** — a
   one-sided phase comparison on a shared host mis-attributes host
   stalls worth ~50 % of a millisecond-scale p99 to whichever phase they
   land on, in either direction; a transient hits one pair and the
   median shrugs it off, while a real critical-path cost shows up in
   every pair.  JAX gates that number at ``--shadow-overhead-max``
   (default 5 %).  On a shared host the pairs of one run spread further
   than the 5 % they should resolve (a segment's p99 is an extreme order
   statistic of ~128 requests), so the port prints it and gates a direct
   measurement instead, as ``serve_bench``'s profiler row does: the
   seconds a mirrored request adds to the client's critical path (the
   batcher's ``should_mirror`` hash and the dispatch thread's ``mirror``
   copy-and-enqueue, median of ``MIRROR_CALLS``, the thread idle between
   calls as at the offered rate) times the offered rate
   (``mirror_dispatch_frac``), held to the same bound.  The same hand-off
   timed on a thread kept busy between calls, as at serving rates, is
   printed beside it (``mirror_us_per_request_busy``).
2. **good candidate** — offer a slightly-perturbed (in-divergence-
   budget) candidate under a fast staged plan and let the controller's
   own cadence walk it shadow → 2 % → 10 % → 50 % → 100 % → promotion,
   with live replay traffic feeding the generation-labelled SLO windows.
   The whole window runs under ``parallel/plan.py:capture_sentry`` with
   **zero** expected captures or kernel builds: the candidate's bucket
   graphs are captured at ``offer`` (off the request path, before the
   sentry opens), so any capture in the window is a bug.
   ``rollout_promote_s`` is the measured offer → promotion wall.
3. **bad candidate** — the same plan, but the offered ensemble passes
   through :class:`~dist_svgd_torch.resilience.BadGenerationAt`
   (``saturate``: finite, admission-passing, prediction-garbage).  The
   shadow divergence window breaches and the controller rolls back by
   swapping to the still-resident incumbent: the drill pins **zero**
   checkpoint I/O (a counting wrapper over ``engine.reload`` — the only
   checkpoint-consuming seam in this stack), bitwise-unchanged incumbent
   predictions (the same bucket's program before and after), and peak
   candidate exposure within ``--max-exposure`` (default 0.10: the bad
   generation must die before its canary split ever exceeds one
   configured stage).

Shadow-mirrored dispatches are classified separately throughout
(``workload_replay.mirror_counts``): they never count as client
ok/shed/error/lost, and the client accounting identity ``offered ==
completed + shed + errors + lost`` is checked per phase.

Unconditional FAILs (``row_ok``): the good candidate not reaching full
exposure and promotion, any lost or errored client request in any
phase, any steady-state capture inside the sentried windows, the bad
candidate not rolling back (or exceeding the configured exposure
stage), any checkpoint read on the rollback path, a non-bitwise
incumbent after rollback, or the mirror's share of the client path at
or over the bound (JAX's shadow p99 overhead where a row lacks it).

Runs on the card unless ``--device cpu``::

    python -m dist_svgd_torch.tools.rollout_drill                 # the card
    python -m dist_svgd_torch.tools.rollout_drill --n 10000 --dim 54
    python -m dist_svgd_torch.tools.rollout_drill --device cpu --base-rps 120 \\
        --duration 10
"""

import argparse
import json
import sys
import time

import numpy as np

from dist_svgd_torch.parallel.plan import capture_sentry
from dist_svgd_torch.resilience import BadGenerationAt
from dist_svgd_torch.rollout import RolloutPlan
from dist_svgd_torch.serving import ModelRegistry
from dist_svgd_torch.serving.batcher import _percentile
from dist_svgd_torch.telemetry import MetricsRegistry
from dist_svgd_torch.tools import serve_bench
from dist_svgd_torch.tools.workload_replay import (
    TraceConfig,
    generate_trace,
    make_submit,
    mirror_counts,
    replay,
    window_metrics,
)
from dist_svgd_torch.utils.platform import resolve_device


#: The keys the port's row adds to JAX's: the shadow-overhead gate's
#: inputs, and the hand-off's cost on a busy dispatch thread (module
#: docstring).
PORT_OVERHEAD_KEYS = ("mirror_us_per_request", "requests_per_s", "mirror_dispatch_frac",
                      "mirror_us_per_request_busy")
#: Timed mirror hand-offs behind ``mirror_us_per_request``.
MIRROR_CALLS = 100


def _percentile_ms(records):
    lats = sorted(r["lat_ms"] for r in records if r["status"] == "ok")
    return (round(_percentile(lats, 0.50), 3),
            round(_percentile(lats, 0.99), 3))


def _median(vals):
    s = sorted(vals)
    mid = len(s) // 2
    return s[mid] if len(s) % 2 else 0.5 * (s[mid - 1] + s[mid])


def _client_counts(*wholes):
    """Sum the client-facing accounting over phase windows (mirrors are
    already excluded by ``window_metrics`` — they are batcher-internal
    work, not client traffic)."""
    out = {k: 0 for k in ("offered", "completed", "shed", "errors", "lost")}
    for w in wholes:
        for k in out:
            out[k] += w[k]
    return out


def _drive_until(reg, tenant, pool, predicate, *, timeout_s=30.0,
                 interval_s=0.02):
    """Keep a trickle of live requests flowing until ``predicate()`` is
    true (the controller's hold/min-request gates need traffic to judge)
    — returns ``(records, met)`` in replay-record shape."""
    records = []
    deadline = time.perf_counter() + timeout_s
    i = 0
    while not predicate():
        if time.perf_counter() > deadline:
            return records, False
        t0 = time.perf_counter()
        rec = {"t": 0.0, "rows": int(pool[i % len(pool)].shape[0]),
               "tenant": tenant}
        try:
            reg.submit(tenant, pool[i % len(pool)]).result(timeout=10.0)
            rec.update(status="ok",
                       lat_ms=(time.perf_counter() - t0) * 1e3)
        except Exception as e:  # surfaced as a client error in the row
            rec.update(status="error", lat_ms=None,
                       error=f"{type(e).__name__}: {e}")
        records.append(rec)
        i += 1
        time.sleep(interval_s)
    return records, True


def _mirror_cost_s(ro, x, out, calls=MIRROR_CALLS, settle_s=0.004, busy=False):
    """Median seconds one shadow-mirrored request adds to the client's
    critical path: the batcher's ``should_mirror`` hash at submit plus the
    dispatch thread's ``mirror`` hand-off (copy and enqueue), each call
    after the previous mirror's candidate replay has drained (so the timed
    call takes the enqueue path, not the drop).  The thread sleeps through
    that wait, as a dispatch thread idles between requests at the drill's
    rate, or with ``busy`` spins through it, as one does that is never
    idle at serving rates (a thread woken from sleep runs the same Python
    several times slower)."""
    laps = []
    for i in range(calls):
        if busy:
            t_end = time.perf_counter() + settle_s
            while time.perf_counter() < t_end:
                pass
        else:
            time.sleep(settle_s)
        t0 = time.perf_counter()
        ro.should_mirror(i)
        ro.mirror(x, out)
        laps.append(time.perf_counter() - t0)
    return float(np.median(laps))


def run_drill(n_particles=256, dim=8, rows=8, base_rps=64.0, duration_s=8.0,
              good_duration_s=14.0, bad_duration_s=6.0, seed=0,
              shadow_fraction=0.25, max_divergence=0.05, p99_ms=150.0,
              max_exposure=0.10, shadow_overhead_max=0.05,
              control_interval_s=0.15, overhead_pairs=4, device=None):
    """Run the three legs; returns the ``canary_rollout`` row.  The
    engine serves on the card unless ``device='cpu'``."""
    dev = resolve_device(device)
    tenant = "prod"
    metrics = MetricsRegistry()
    # ONE padding bucket (min == max == the fixed request size, batcher
    # max_batch == rows so coalescing can never grow a batch past it):
    # every batch of every generation lands in a bucket whose program the
    # staging already built — the structural zero-capture precondition
    reg = ModelRegistry(metrics=metrics, max_total_buckets=8,
                        max_batch=rows, lanes=1, max_wait_ms=2.0,
                        max_queue_rows=4096)
    rng = np.random.default_rng(seed)
    parts = (0.05 * rng.normal(size=(n_particles, 1 + dim))
             ).astype(np.float32)
    reg.add_tenant(tenant, "logreg", particles=parts,
                   min_bucket=rows, max_bucket=rows, device=dev)
    reg.warm()
    time.sleep(1.0)  # settle the warm's capture burst (shared host)

    eng = reg.tenant(tenant).engine
    pools = serve_bench.request_pool_by_size(dim, (rows,), per_size=32,
                                             seed=seed + 1)
    pool = pools[rows]
    submit = make_submit(reg.batcher, pools, model_registry=reg)
    # the fast staged plan both live phases run under
    plan = RolloutPlan(shadow_fraction=shadow_fraction,
                       shadow_min_mirrors=8, shadow_hold_s=0.5,
                       canary_stages=(0.02, 0.10, 0.50, 1.0),
                       stage_hold_s=0.4, stage_min_requests=4,
                       max_divergence=max_divergence, p99_ms=p99_ms,
                       breach_streak=2, seed=seed + 3)

    # -- leg 1: shadow overhead, paired A/B segments -------------------- #
    # A single baseline-then-shadow comparison is dominated by host drift
    # on the shared box (~ms-scale p99s, stalls worth 50% of one): so
    # alternate (baseline, shadow) segment pairs on the identical
    # sub-trace — the batcher's set_rollout(None/ro) live toggle is the
    # seam — and take the MEDIAN per-pair p99 ratio.  The candidate's
    # bucket program is built once at offer, outside every timed segment.
    hold_plan = RolloutPlan(shadow_fraction=shadow_fraction,
                            shadow_min_mirrors=10 ** 9,
                            shadow_hold_s=86400.0,
                            max_divergence=max_divergence, p99_ms=p99_ms,
                            seed=seed + 3)
    near = parts + np.float32(1e-3)
    ro = reg.begin_rollout(tenant, plan=hold_plan)
    ro.offer(near, tag="shadow_probe")
    pairs = max(2, int(overhead_pairs))
    seg_s = duration_s / pairs
    seg_wholes, pair_overheads = [], []
    base_p50s, base_p99s, shadow_p50s, shadow_p99s = [], [], [], []
    for i in range(pairs):
        seg_cfg = TraceConfig(duration_s=seg_s, base_rps=base_rps,
                              seed=seed + 2 + 31 * i, diurnal_amp=0.0,
                              rows_sizes=(rows,), rows_alpha=0.0,
                              tenants=(tenant,))
        events = generate_trace(seg_cfg)
        reg.batcher.set_rollout(None)   # disarm LIVE: pure incumbent
        rec_b = replay(events, submit)
        reg.batcher.set_rollout(ro)     # re-arm LIVE: mirrors flowing
        rec_s = replay(events, submit)
        seg_wholes.append(window_metrics(rec_b, 0.0, seg_s, p99_ms))
        seg_wholes.append(window_metrics(rec_s, 0.0, seg_s, p99_ms))
        b50, b99 = _percentile_ms(rec_b)
        s50, s99 = _percentile_ms(rec_s)
        base_p50s.append(b50)
        base_p99s.append(b99)
        shadow_p50s.append(s50)
        shadow_p99s.append(s99)
        if b99:
            pair_overheads.append(max(s99 / b99 - 1.0, 0.0))
    base_p50, base_p99 = _median(base_p50s), _median(base_p99s)
    shadow_p50, shadow_p99 = _median(shadow_p50s), _median(shadow_p99s)
    overhead = (round(_median(pair_overheads), 4)
                if pair_overheads else None)
    mirror_s = _mirror_cost_s(ro, pool[0], eng.predict(pool[0]))
    mirror_busy_s = _mirror_cost_s(ro, pool[0], eng.predict(pool[0]), busy=True)
    reg.end_rollout(tenant)  # drops the probe candidate, flushes mirrors
    shadow_mirrors = mirror_counts(metrics, tenant)

    # -- leg 2: good candidate — staged promote under the sentry -------- #
    gen_before = eng.stats()["generation_id"]
    cand_counter = metrics.counter("svgd_serve_requests_total",
                                   "requests fully resolved")
    cand_before = cand_counter.value(tenant=tenant, generation="candidate")
    good_cand = parts + (1e-3 * rng.normal(size=parts.shape)
                         ).astype(np.float32)
    ro = reg.begin_rollout(tenant, plan=plan)
    ro.offer(good_cand, tag="good", watermark=time.time())
    good_cfg = TraceConfig(duration_s=good_duration_s, base_rps=base_rps,
                           seed=seed + 4, diurnal_amp=0.0,
                           rows_sizes=(rows,), rows_alpha=0.0,
                           tenants=(tenant,))
    t_offer = time.perf_counter()
    with capture_sentry("rollout good-candidate steady state") as sentry_g:
        ro.start(control_interval_s)
        records_good = replay(generate_trace(good_cfg), submit)
        tail_good, _ = _drive_until(reg, tenant, pool,
                                    lambda: not ro.active, timeout_s=30.0)
        ro.stop()
    good_wall = time.perf_counter() - t_offer
    st = ro.status()
    promote_rec = next((r for r in ro.log if r["event"] == "promote"), None)
    good_stages = [r["fraction"] for r in ro.log if r["event"] == "advance"]
    whole_good = window_metrics(records_good + tail_good, 0.0,
                                good_duration_s, p99_ms)
    good = {
        "promoted": bool(st["promotions"] == 1 and st["state"] == "idle"),
        "promote_s": (promote_rec or {}).get("promote_s"),
        "wall_s": round(good_wall, 3),
        "stages": good_stages,
        "candidate_requests": int(
            cand_counter.value(tenant=tenant, generation="candidate")
            - cand_before),
        "generation_before": gen_before,
        "generation_after": eng.stats()["generation_id"],
    }
    reg.end_rollout(tenant)

    # -- leg 3: bad candidate — breach, roll back, stay resident -------- #
    gen_serving = eng.stats()["generation_id"]
    probe = pool[0]
    inc_before = {k: np.array(v, copy=True)
                  for k, v in eng.predict(probe).items()}
    reload_calls = {"n": 0}
    orig_reload = eng.reload

    def counting_reload(*a, **k):  # the only checkpoint-consuming seam
        reload_calls["n"] += 1
        return orig_reload(*a, **k)

    eng.reload = counting_reload
    # saturate (huge finite weights) rather than scramble: this drill's
    # incumbent is a weakly-informative posterior, where sign-flipping
    # still predicts ~0.5 — saturation breaks the predictive variance no
    # matter how diffuse the incumbent is (measured divergence ~0.14)
    fault = BadGenerationAt(0, kind="saturate")
    bad_cand = fault.apply(parts) if fault.active(0) else parts
    ro = reg.begin_rollout(tenant, plan=plan)
    ro.offer(bad_cand, tag="bad")
    bad_cfg = TraceConfig(duration_s=bad_duration_s, base_rps=base_rps,
                          seed=seed + 5, diurnal_amp=0.0,
                          rows_sizes=(rows,), rows_alpha=0.0,
                          tenants=(tenant,))
    with capture_sentry("rollout bad-candidate rollback") as sentry_b:
        ro.start(control_interval_s)
        records_bad = replay(generate_trace(bad_cfg), submit)
        tail_bad, _ = _drive_until(reg, tenant, pool,
                                   lambda: not ro.active, timeout_s=20.0)
        ro.stop()
    st2 = ro.status()
    rollback_rec = next((r for r in ro.log if r["event"] == "rollback"),
                        None)
    peak_fraction = max([r["fraction"] for r in ro.log
                         if r["event"] == "advance"], default=0.0)
    whole_bad = window_metrics(records_bad + tail_bad, 0.0,
                               bad_duration_s, p99_ms)
    inc_after = eng.predict(probe)
    del eng.reload  # restore the class method
    bitwise = (sorted(inc_before) == sorted(inc_after)
               and all(np.array_equal(inc_before[k], inc_after[k])
                       for k in inc_before))
    bad = {
        "rolled_back": bool(st2["rollbacks"] == 1 and st2["state"] == "idle"),
        "at_stage": (rollback_rec or {}).get("at_stage"),
        "objectives": (rollback_rec or {}).get("objectives"),
        "peak_fraction": peak_fraction,
        "max_exposure": max_exposure,
        "checkpoint_reloads": reload_calls["n"],
        "incumbent_bitwise": bool(bitwise),
        "serving_generation_unchanged": bool(
            eng.stats()["generation_id"] == gen_serving),
    }
    reg.end_rollout(tenant)
    mirrors_total = mirror_counts(metrics, tenant)
    client = _client_counts(*seg_wholes, whole_good, whole_bad)
    reg.close(drain=True)

    compiles = ((sentry_g.compiles + sentry_b.compiles)
                if sentry_g.supported else None)
    return {
        "metric": "canary_rollout",
        "unit": "seconds from candidate offer to full promotion",
        "platform": serve_bench._platform(eng),
        "n": n_particles, "dim": dim, "rows": rows,
        "base_rps": base_rps, "duration_s": duration_s,
        "good_duration_s": good_duration_s,
        "bad_duration_s": bad_duration_s,
        "plan": plan.describe(),
        "value": good["promote_s"],
        "rollout_promote_s": good["promote_s"],
        "shadow_overhead_frac": overhead,
        "shadow_overhead_max": shadow_overhead_max,
        "mirror_us_per_request": round(1e6 * mirror_s, 3),
        "requests_per_s": base_rps,
        "mirror_dispatch_frac": round(mirror_s * base_rps, 6),
        "mirror_us_per_request_busy": round(1e6 * mirror_busy_s, 3),
        "overhead_pairs": [round(o, 4) for o in pair_overheads],
        "baseline_p50_ms": base_p50, "baseline_p99_ms": base_p99,
        "shadow_p50_ms": shadow_p50, "shadow_p99_ms": shadow_p99,
        "shadow_mirrors": shadow_mirrors["mirrors"],
        "mirrors_total": mirrors_total["mirrors"],
        "mirror_dropped": mirrors_total["mirror_dropped"],
        "mirror_errors": mirrors_total["mirror_errors"],
        "good": good,
        "bad": bad,
        "client": client,
        "sentry_supported": sentry_g.supported,
        "sentry_compiles": compiles,
        "steady_state_recompiles": compiles,
    }


def row_ok(row):
    """The unconditional ``canary_rollout`` gates; returns ``(ok, why)``
    — every entry in ``why`` is a FAIL."""
    why = []
    good = row.get("good") or {}
    bad = row.get("bad") or {}
    client = row.get("client") or {}
    if not good.get("promoted"):
        why.append("good candidate never reached full exposure and "
                   f"promotion (stages seen: {good.get('stages')})")
    if client.get("lost"):
        why.append(f"{client['lost']} client request(s) lost — every "
                   "admitted request must resolve through offer, canary "
                   "and rollback")
    if client.get("errors"):
        why.append(f"{client['errors']} client request(s) errored during "
                   "the rollout phases")
    if row.get("steady_state_recompiles"):
        why.append(f"{row['steady_state_recompiles']} steady-state "
                   "capture(s) or kernel build(s) inside the sentried "
                   "rollout windows — staging is the only documented "
                   "capture and it runs before the window opens")
    if not bad.get("rolled_back"):
        why.append("bad candidate was never rolled back")
    if bad.get("peak_fraction", 0.0) > bad.get("max_exposure", 0.0):
        why.append(f"bad candidate reached {bad.get('peak_fraction')} "
                   f"exposure (> configured {bad.get('max_exposure')})")
    if bad.get("checkpoint_reloads"):
        why.append(f"rollback touched the checkpoint path "
                   f"({bad['checkpoint_reloads']} reload call(s)) — it "
                   "must swap to the resident incumbent in O(1)")
    if not bad.get("incumbent_bitwise"):
        why.append("incumbent predictions changed across the bad "
                   "candidate's lifecycle — rollback must be bitwise")
    if not bad.get("serving_generation_unchanged"):
        why.append("serving generation moved during the bad rollout — "
                   "the candidate must never be promoted")
    bound = row.get("shadow_overhead_max", 0.05)
    if "mirror_dispatch_frac" in row:  # the port's gate (module docstring)
        if row["mirror_dispatch_frac"] >= bound:
            why.append(f"shadow mirroring takes {row['mirror_dispatch_frac']:.2%} "
                       f"of the client path's time (bound {bound:.0%}) — "
                       "mirrors must stay off the critical path")
        return (not why), why
    overhead = row.get("shadow_overhead_frac")
    if overhead is not None and overhead >= bound:
        why.append(f"shadow mirroring added {overhead:.1%} to client p99 "
                   f"(bound {bound:.0%}) — "
                   "mirrors must stay off the critical path")
    return (not why), why


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m dist_svgd_torch.tools.rollout_drill",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=256, help="particles")
    ap.add_argument("--dim", type=int, default=8, help="feature dim")
    ap.add_argument("--rows", type=int, default=8,
                    help="rows per request (= the single padding bucket)")
    ap.add_argument("--base-rps", type=float, default=64.0)
    ap.add_argument("--duration", type=float, default=8.0,
                    help="total trace seconds per side of the paired "
                         "baseline/shadow overhead phase")
    ap.add_argument("--overhead-pairs", type=int, default=4,
                    help="interleaved (baseline, shadow) segment pairs; "
                         "shadow_overhead_frac is the median pair ratio")
    ap.add_argument("--good-duration", type=float, default=14.0,
                    help="good-candidate phase trace seconds")
    ap.add_argument("--bad-duration", type=float, default=6.0,
                    help="bad-candidate phase trace seconds")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--shadow-fraction", type=float, default=0.25)
    ap.add_argument("--max-divergence", type=float, default=0.05)
    ap.add_argument("--p99-ms", type=float, default=150.0,
                    help="candidate latency SLO the canary is judged on")
    ap.add_argument("--max-exposure", type=float, default=0.10,
                    help="the bad candidate must roll back before its "
                         "split exceeds this configured stage")
    ap.add_argument("--shadow-overhead-max", type=float, default=0.05,
                    help="allowed client-p99 inflation while mirroring")
    ap.add_argument("--device", choices=("cuda", "cpu"), default=None,
                    help="serve on the card (default) or the CPU")
    args = ap.parse_args(argv)

    row = run_drill(
        n_particles=args.n, dim=args.dim, rows=args.rows,
        base_rps=args.base_rps, duration_s=args.duration,
        good_duration_s=args.good_duration,
        bad_duration_s=args.bad_duration, seed=args.seed,
        shadow_fraction=args.shadow_fraction,
        max_divergence=args.max_divergence, p99_ms=args.p99_ms,
        max_exposure=args.max_exposure,
        shadow_overhead_max=args.shadow_overhead_max,
        overhead_pairs=args.overhead_pairs, device=args.device,
    )
    print(json.dumps(row), flush=True)
    ok, why = row_ok(row)
    if not ok:
        print(json.dumps({"metric": "canary_rollout", "ok": False,
                          "why": why}), file=sys.stderr, flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
