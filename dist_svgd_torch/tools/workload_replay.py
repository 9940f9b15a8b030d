"""Trace-driven workload replay: production-shaped traffic against the
serving stack.

Counterpart of ``tools/workload_replay.py``: the seeded workload model,
the open-loop replayer and the window metrics (the rollout drill,
``dist_svgd_torch/tools/rollout_drill.py``, replays its phases with them),
and the ``serve_storm`` row.  ``tools/serve_bench.py``'s closed/open loops
answer "how fast is the request path" at a FIXED rate and request shape.
Millions of users do not offer fixed-rate traffic: rates swing
diurnally, bursts arrive in Poisson clumps, request sizes are
heavy-tailed, and tenant demand is skewed with occasional flash crowds.  This module generates that shape as a **fully
seeded, deterministic trace** (the same events as JAX's on the same
config: the draws are numpy's) and replays it open-loop (latency charged
from the *scheduled* arrival — no coordinated omission) against an
in-process ``MicroBatcher``+engine / ``ModelRegistry``, a live
``serving.server`` URL, or a ``FleetRouter`` front door:

- :class:`TraceConfig` / :func:`generate_trace` — the workload model:
  a sinusoidal diurnal envelope × scheduled burst multipliers drives a
  non-homogeneous Poisson arrival process (thinning, so the schedule is
  an exact draw, not a discretisation); request row counts follow a
  bounded power law (``p ∝ rows^-alpha``); tenant identity follows a
  Zipf-skewed mix with flash-crowd windows that shift mass onto one
  tenant.  Same seed ⇒ identical arrival schedule, sizes, and per-tenant
  mix, replay after replay;
- :func:`replay` — issues the trace in real time and records one row per
  event: resolved / shed (``Overloaded`` → the 429 path) / error / lost,
  with latency measured from the scheduled arrival;
- :func:`window_metrics`, :func:`p99_breach_seconds`,
  :func:`time_to_recover`, :func:`mirror_counts` — the aggregates;
- :func:`make_submit` / :func:`make_http_submit` /
  :func:`make_router_submit` — the in-process, HTTP and fleet transports
  (:func:`build_fake_fleet` puts a ``FleetRouter`` over loopback
  replicas);
- :func:`run_storm` / :func:`storm_ok` — the ``serve_storm`` row: one
  seeded steady → flash-crowd → recovery trace replayed against two static
  batcher configurations and against the autoscale controller
  (``serving/autoscale.py``), under ``parallel/plan.py:capture_sentry``;
- :func:`main` — the ``storm`` / ``trace`` / ``replay`` CLI.

Usage (the card unless ``--device cpu``)::

    python -m dist_svgd_torch.tools.workload_replay              # the storm row
    python -m dist_svgd_torch.tools.workload_replay --mode trace --tenants 3
    python -m dist_svgd_torch.tools.workload_replay --mode replay [--url URL | --fleet N]
"""

import argparse
import functools
import json
import math
import os
import sys
import threading
import time

import numpy as np

from dist_svgd_torch import telemetry
from dist_svgd_torch.parallel.plan import capture_sentry
from dist_svgd_torch.serving import (
    AutoscaleController,
    AutoscalePolicy,
    MicroBatcher,
    ModelRegistry,
)
from dist_svgd_torch.serving import fleet as fleet_mod
from dist_svgd_torch.serving.batcher import Overloaded, _percentile
from dist_svgd_torch.tools import serve_bench
from dist_svgd_torch.utils.platform import resolve_device

#: The storm's settle pauses, JAX's values: after the warm (the warm's
#: sustained burn must not bill a throttled host into the capacity anchor),
#: between the capacity probe's samples, after the probes, and before each
#: arm (the previous arm's drain must not land in this arm's steady phase).
#: The replay's own pacing is separate and never shortened.
WARM_SETTLE_S = 4.0
PROBE_GAP_S = 0.75
PROBE_SETTLE_S = 2.0
ARM_SETTLE_S = 1.0

#: The card's capacity probe (:func:`_steady_rows_capacity`): each sample
#: counts completions over this many seconds once every client runs, and a
#: client whose request is shed waits this long before its next one (a
#: refused closed-loop client would otherwise spin on the interpreter lock
#: the serving threads need).
CARD_PROBE_WINDOW_S = 1.0
PROBE_SHED_BACKOFF_S = 0.001


# --------------------------------------------------------------------- #
# trace model


class TraceConfig:
    """Seeded description of a production-shaped workload.

    Args:
        duration_s: trace length (virtual seconds == replay seconds).
        base_rps: baseline request rate the envelopes modulate.
        seed: the ONE seed every draw derives from (arrivals, sizes,
            tenant mix) — the determinism contract.
        arrival: ``'poisson'`` (non-homogeneous Poisson via thinning) or
            ``'regular'`` (deterministic spacing at the instantaneous
            rate — a noise-free A/B baseline).
        diurnal_period_s / diurnal_amp: sinusoidal rate envelope
            ``1 + amp·sin(2π·t/period)`` (period defaults to the trace
            length — one "day" per trace).
        bursts: ``((start_s, duration_s, multiplier), ...)`` — flash
            load windows multiplying the instantaneous rate.
        rows_sizes / rows_alpha: request row counts and the power-law
            exponent (``p ∝ rows^-alpha`` — most requests small, the
            heavy tail real request streams have).
        tenants: tenant names (empty = single-tenant trace).
        tenant_skew: Zipf exponent over the tenant list (rank 1 hottest).
        flash_crowds: ``((start_s, duration_s, tenant_index, mass), ...)``
            — within the window, ``mass`` of the tenant mix shifts onto
            that tenant (the rest keep their relative shares).
    """

    def __init__(self, duration_s=24.0, base_rps=200.0, seed=0,
                 arrival="poisson", diurnal_period_s=None, diurnal_amp=0.15,
                 bursts=(), rows_sizes=(1, 2, 4, 8, 16, 32), rows_alpha=1.3,
                 tenants=(), tenant_skew=1.2, flash_crowds=()):
        if duration_s <= 0:
            raise ValueError(f"duration_s must be positive, got {duration_s}")
        if base_rps <= 0:
            raise ValueError(f"base_rps must be positive, got {base_rps}")
        if arrival not in ("poisson", "regular"):
            raise ValueError(f"unknown arrival {arrival!r}")
        if not 0.0 <= diurnal_amp < 1.0:
            raise ValueError(f"diurnal_amp must be in [0, 1), got {diurnal_amp}")
        if not rows_sizes:
            raise ValueError("rows_sizes must be non-empty")
        for b in bursts:
            if len(b) != 3 or b[1] <= 0 or b[2] <= 0:
                raise ValueError(f"bad burst spec {b!r}")
        for fc in flash_crowds:
            if (len(fc) != 4 or not tenants
                    or not 0 <= fc[2] < len(tenants)
                    or not 0.0 < fc[3] <= 1.0):
                raise ValueError(f"bad flash_crowd spec {fc!r}")
        self.duration_s = float(duration_s)
        self.base_rps = float(base_rps)
        self.seed = int(seed)
        self.arrival = arrival
        self.diurnal_period_s = float(diurnal_period_s
                                      if diurnal_period_s is not None
                                      else duration_s)
        self.diurnal_amp = float(diurnal_amp)
        self.bursts = tuple((float(s), float(d), float(m))
                            for s, d, m in bursts)
        self.rows_sizes = tuple(int(r) for r in rows_sizes)
        self.rows_alpha = float(rows_alpha)
        self.tenants = tuple(tenants)
        self.tenant_skew = float(tenant_skew)
        self.flash_crowds = tuple((float(s), float(d), int(i), float(m))
                                  for s, d, i, m in flash_crowds)

    def rate_at(self, t: float) -> float:
        """Instantaneous offered rate: base × diurnal × burst windows."""
        r = self.base_rps * (1.0 + self.diurnal_amp * math.sin(
            2.0 * math.pi * t / self.diurnal_period_s))
        for start, dur, mult in self.bursts:
            if start <= t < start + dur:
                r *= mult
        return max(r, 0.0)

    def peak_rate(self) -> float:
        """An upper bound on :meth:`rate_at` (the thinning envelope)."""
        peak_mult = 1.0
        for _, _, mult in self.bursts:
            peak_mult = max(peak_mult, mult)
        return self.base_rps * (1.0 + self.diurnal_amp) * peak_mult

    def _size_probs(self):
        w = [r ** -self.rows_alpha for r in self.rows_sizes]
        z = sum(w)
        return [x / z for x in w]

    def _tenant_probs(self, t: float):
        if not self.tenants:
            return None
        w = [(i + 1) ** -self.tenant_skew for i in range(len(self.tenants))]
        z = sum(w)
        probs = [x / z for x in w]
        for start, dur, idx, mass in self.flash_crowds:
            if start <= t < start + dur:
                rest = 1.0 - mass
                probs = [p * rest for p in probs]
                probs[idx] += mass
        return probs

    def to_dict(self) -> dict:
        return {
            "duration_s": self.duration_s, "base_rps": self.base_rps,
            "seed": self.seed, "arrival": self.arrival,
            "diurnal_period_s": self.diurnal_period_s,
            "diurnal_amp": self.diurnal_amp, "bursts": list(self.bursts),
            "rows_sizes": list(self.rows_sizes),
            "rows_alpha": self.rows_alpha, "tenants": list(self.tenants),
            "tenant_skew": self.tenant_skew,
            "flash_crowds": list(self.flash_crowds),
        }


class ReplayEvent:
    """One scheduled request: arrival time, row count, tenant (or None),
    and a pool pick so the replayer reuses pre-generated arrays."""

    __slots__ = ("t", "rows", "tenant", "pick")

    def __init__(self, t, rows, tenant, pick):
        self.t = t
        self.rows = rows
        self.tenant = tenant
        self.pick = pick


def generate_trace(cfg: TraceConfig):
    """Draw the full event schedule from ``cfg`` — pure function of the
    config (same config ⇒ identical schedule, sizes, tenant mix; the
    determinism test pins it).  Poisson arrivals use thinning against the
    peak-rate envelope, so the schedule is an exact non-homogeneous
    Poisson draw."""
    rng = np.random.default_rng(cfg.seed)
    size_probs = cfg._size_probs()
    size_idx = np.arange(len(cfg.rows_sizes))
    events = []
    t = 0.0
    if cfg.arrival == "poisson":
        lam = cfg.peak_rate()
        while True:
            t += float(rng.exponential(1.0 / lam))
            if t >= cfg.duration_s:
                break
            if float(rng.random()) > cfg.rate_at(t) / lam:
                continue  # thinned
            events.append(_draw_event(cfg, rng, t, size_idx, size_probs))
    else:  # regular: deterministic spacing at the instantaneous rate
        while True:
            rate = cfg.rate_at(t)
            t += 1.0 / max(rate, 1e-9)
            if t >= cfg.duration_s:
                break
            events.append(_draw_event(cfg, rng, t, size_idx, size_probs))
    return events


def _draw_event(cfg, rng, t, size_idx, size_probs):
    rows = cfg.rows_sizes[int(rng.choice(size_idx, p=size_probs))]
    tenant = None
    if cfg.tenants:
        tp = cfg._tenant_probs(t)
        tenant = cfg.tenants[int(rng.choice(len(cfg.tenants), p=tp))]
    return ReplayEvent(t, rows, tenant, int(rng.integers(0, 1 << 30)))


# --------------------------------------------------------------------- #
# replay


def replay(events, submit, *, clock=time.perf_counter, sleep=time.sleep,
           drain_timeout_s=30.0):
    """Issue ``events`` on their schedule (open loop: a backed-up system
    delays completions, never arrivals) and return one record per event:
    ``{"t", "rows", "tenant", "status", "lat_ms"}`` with ``status`` in
    ``ok`` / ``shed`` (``Overloaded`` — the bounded queue did its job) /
    ``error`` (any other failure) / ``lost`` (never resolved — always a
    bug; the drills gate it unconditionally).

    Rollout drivers may append extra ``status="mirror"`` records for
    shadow-mirrored candidate dispatches (batcher-internal duplicates of
    client requests during a :class:`RolloutController` shadow phase).
    ``window_metrics`` classifies those separately: they are never
    counted as client ``ok``/``shed``/``error``/``lost``, never enter
    the goodput or latency numbers, and never appear in ``offered`` —
    mirrored work is capacity spent, not traffic served.

    ``submit(event) -> Future`` raises ``Overloaded`` to shed.  Latency is
    charged from the *scheduled* arrival, so queue backlog shows up in the
    numbers instead of hiding in the generator (no coordinated omission).
    """
    lock = threading.Lock()
    records = [None] * len(events)
    pending = []
    start = clock()

    def on_done(i, scheduled, fut):
        lat_ms = (clock() - scheduled) * 1e3
        ev = events[i]
        err = fut.exception()
        rec = {"t": ev.t, "rows": ev.rows, "tenant": ev.tenant}
        if err is None:
            rec.update(status="ok", lat_ms=lat_ms)
        elif isinstance(err, Overloaded):
            rec.update(status="shed", lat_ms=None)
        else:
            rec.update(status="error", lat_ms=None,
                       error=f"{type(err).__name__}: {err}")
        with lock:
            # first writer wins: once the drain loop has classified a
            # straggler 'lost', its late completion must not rewrite the
            # record the caller is already aggregating
            if records[i] is None:
                records[i] = rec

    for i, ev in enumerate(events):
        target = start + ev.t
        now = clock()
        if target > now:
            sleep(target - now)
            now = clock()
        scheduled = max(target, start)
        try:
            fut = submit(ev)
        except Overloaded:
            with lock:
                records[i] = {"t": ev.t, "rows": ev.rows,
                              "tenant": ev.tenant, "status": "shed",
                              "lat_ms": None}
            continue
        except Exception as e:
            with lock:
                records[i] = {"t": ev.t, "rows": ev.rows,
                              "tenant": ev.tenant, "status": "error",
                              "lat_ms": None,
                              "error": f"{type(e).__name__}: {e}"}
            continue
        pending.append(fut)
        fut.add_done_callback(
            lambda f, i=i, s=scheduled: on_done(i, s, f))
    deadline = clock() + drain_timeout_s
    for fut in pending:
        remaining = deadline - clock()
        try:
            fut.result(timeout=max(remaining, 0.001))
        except Exception:
            pass  # classification happened in the callback
    with lock:
        for i, ev in enumerate(events):
            if records[i] is None:
                records[i] = {"t": ev.t, "rows": ev.rows,
                              "tenant": ev.tenant, "status": "lost",
                              "lat_ms": None}
    return records


def window_metrics(records, t0, t1, good_ms):
    """Aggregate one ``[t0, t1)`` window of replay records.  ``goodput``
    counts completions within ``good_ms`` of their scheduled arrival —
    work the user actually experienced as served (a completion past the
    objective is capacity spent on a lost cause).

    ``status="mirror"`` records (shadow-mirrored rollout dispatches) are
    counted in their own ``mirrors`` field and excluded from every
    client-facing number — ``offered``, completions, sheds, errors,
    losses, goodput, and the latency percentiles all describe real
    client traffic only."""
    win = [r for r in records if t0 <= r["t"] < t1]
    mirrors = sum(1 for r in win if r["status"] == "mirror")
    sel = [r for r in win if r["status"] != "mirror"]
    lats = sorted(r["lat_ms"] for r in sel if r["status"] == "ok")
    good = sum(1 for r in sel
               if r["status"] == "ok" and r["lat_ms"] <= good_ms)
    span = max(t1 - t0, 1e-9)
    return {
        "offered": len(sel),
        "offered_rps": round(len(sel) / span, 1),
        "completed": len(lats),
        "shed": sum(1 for r in sel if r["status"] == "shed"),
        "errors": sum(1 for r in sel if r["status"] == "error"),
        "lost": sum(1 for r in sel if r["status"] == "lost"),
        "mirrors": mirrors,
        "good": good,
        "goodput_rps": round(good / span, 1),
        "p50_ms": round(_percentile(lats, 0.50), 3),
        "p99_ms": round(_percentile(lats, 0.99), 3),
    }


def p99_breach_seconds(records, target_ms, duration_s):
    """Seconds (1-second buckets over the trace) whose completion p99
    exceeded ``target_ms`` — plus starvation buckets (offered traffic,
    zero completions), which are the worst breach of all.  The
    ``storm_p99_breach_s`` metric: how long the tail was out of
    objective, not just whether it ever was."""
    breaches = 0
    for b in range(int(math.ceil(duration_s))):
        sel = [r for r in records if b <= r["t"] < b + 1]
        if not sel:
            continue
        lats = sorted(r["lat_ms"] for r in sel if r["status"] == "ok")
        if not lats:
            breaches += 1  # offered but nothing completed: starvation
        elif _percentile(lats, 0.99) > target_ms:
            breaches += 1
    return breaches


def time_to_recover(records, burst_end_s, target_ms, duration_s):
    """Seconds from the burst's end until the first full second that is
    healthy again (completions present, p99 at/under target, no sheds).
    Never recovering reads as the full remaining window — a pessimistic,
    gateable number instead of a silent None."""
    for b in range(int(math.ceil(burst_end_s)), int(math.ceil(duration_s))):
        sel = [r for r in records if b <= r["t"] < b + 1]
        if not sel:
            continue
        lats = sorted(r["lat_ms"] for r in sel if r["status"] == "ok")
        shed = sum(1 for r in sel if r["status"] != "ok")
        if lats and not shed and _percentile(lats, 0.99) <= target_ms:
            return round(max(b - burst_end_s, 0.0), 3)
    return round(duration_s - burst_end_s, 3)


def mirror_counts(metrics, tenant=None):
    """Batcher-internal shadow-mirror accounting from a
    ``MetricsRegistry``.  Mirrored candidate dispatches during a rollout
    shadow phase ride off the client's critical path — no replay future
    ever resolves for them — so the rollout counters are the only place
    they are visible.  Returns ``{"mirrors", "mirror_dropped",
    "mirror_errors"}``, reported *alongside* (never inside) the client
    ok/shed/error/lost numbers."""
    labels = {} if tenant is None else {"tenant": tenant}
    out = {}
    for field, name in (
            ("mirrors", "svgd_rollout_mirrors_total"),
            ("mirror_dropped", "svgd_rollout_mirror_dropped_total"),
            ("mirror_errors", "svgd_rollout_mirror_errors_total")):
        metric = metrics.get(name)
        out[field] = int(metric.value(**labels)) if metric is not None else 0
    return out


def make_submit(batcher, pools, model_registry=None):
    """The in-process ``submit(event)`` adapter: picks a pre-generated
    array of the event's size (``serve_bench.request_pool_by_size`` — the
    shared request-pool plumbing) and routes tenant events through the
    registry."""
    def submit(ev):
        pool = pools[ev.rows]
        x = pool[ev.pick % len(pool)]
        if ev.tenant is not None and model_registry is not None:
            return model_registry.submit(ev.tenant, x)
        return batcher.submit(x, tenant=ev.tenant)

    return submit


def make_http_submit(url, max_workers=32):
    """Open-loop HTTP transport for ``--url`` replay: each event posts on
    a pool thread so a slow server delays completions, not arrivals."""
    import urllib.error
    import urllib.request
    from concurrent.futures import ThreadPoolExecutor

    pool = ThreadPoolExecutor(max_workers=max_workers)

    def post(ev, x):
        doc = {"inputs": x.tolist()}
        if ev.tenant is not None:
            doc["tenant"] = ev.tenant
        req = urllib.request.Request(
            url.rstrip("/") + "/predict", json.dumps(doc).encode(),
            {"Content-Type": "application/json"},
        )
        try:
            body = json.loads(urllib.request.urlopen(req, timeout=30).read())
        except urllib.error.HTTPError as e:
            if e.code == 429:
                raise Overloaded("shed by server (429)")
            raise
        return body.get("outputs")

    def make(pools):
        def submit(ev):
            p = pools[ev.rows]
            return pool.submit(post, ev, p[ev.pick % len(p)])

        return submit

    make.shutdown = pool.shutdown
    return make


# --------------------------------------------------------------------- #
# the fleet transports


def make_router_submit(router, max_workers=16):
    """Fleet transport for replay: each event goes through the
    ``FleetRouter`` front door (health-gated failover, retries, bounded
    load) on a pool thread.  ``route`` never raises — a fleet-level 429
    (every admitted replica shedding) re-raises as ``Overloaded`` so
    ``replay`` books it shed, any other non-200 raises so it books an
    error; an admitted request must resolve."""
    from concurrent.futures import ThreadPoolExecutor

    pool = ThreadPoolExecutor(max_workers=max_workers)

    def post(ev, x):
        doc = {"inputs": x.tolist()}
        if ev.tenant is not None:
            doc["tenant"] = ev.tenant
        res = router.route(ev.tenant or "default",
                           json.dumps(doc).encode())
        if res.status == 429:
            raise Overloaded("shed by fleet (429)")
        if res.status != 200:
            raise RuntimeError(
                f"fleet answered {res.status} ({res.outcome})")
        body = res.json()
        return body.get("outputs") if isinstance(body, dict) else None

    def make(pools):
        def submit(ev):
            p = pools[ev.rows]
            return pool.submit(post, ev, p[ev.pick % len(p)])

        return submit

    make.shutdown = pool.shutdown
    return make


def build_fake_fleet(replicas=3, *, max_replica_rows=64, tenants=(),
                     probe_interval_s=0.2, registry=None):
    """A ``FleetRouter`` over in-process ``LoopbackReplica`` stand-ins
    with a bounded per-replica row budget — the CPU-test seam for
    replaying a trace through the fleet front door with no sockets or
    subprocesses (the same fake-transport split
    ``dist_svgd_torch/tools/fleet_drill.py`` uses).  Each replica sheds
    (429) past ``max_replica_rows`` concurrently in-flight rows, so a flash
    crowd produces real fleet-level sheds while every admitted request
    still resolves.  Returns ``(router, close)``."""
    names = [f"r{i}" for i in range(int(replicas))]
    transport = fleet_mod.FakeTransport({})
    lock = threading.Lock()
    inflight = {n: 0 for n in names}

    def make_predict(name):
        def predict(inputs, tenant, headers):
            rows = len(inputs)
            with lock:
                if inflight[name] + rows > max_replica_rows:
                    raise fleet_mod.Shed("replica row budget full",
                                         retry_after_s=0.05)
                inflight[name] += rows
            try:
                time.sleep(0.0005)  # a realistic (tiny) dispatch floor
                return {"mean": [0.0] * rows}
            finally:
                with lock:
                    inflight[name] -= rows

        return predict

    for n in names:
        transport.set_replica(n, fleet_mod.LoopbackReplica(
            n, predict_fn=make_predict(n), tenants=list(tenants),
            registry=telemetry.MetricsRegistry()))
    reg = registry if registry is not None else telemetry.MetricsRegistry()
    replica_set = fleet_mod.ReplicaSet(
        names, transport, probe_interval_s=probe_interval_s,
        probe_timeout_s=0.2, fail_threshold=2, passive_fail_threshold=3,
        open_cooldown_s=0.5, registry=reg)
    router = fleet_mod.FleetRouter(
        names, transport=transport, replica_set=replica_set,
        max_retries=1, per_try_timeout_s=0.5, default_deadline_s=5.0,
        registry=reg)
    router.start()
    return router, router.shutdown


# --------------------------------------------------------------------- #
# the serve_storm row


def _rows_of(item):
    """Rows of a probe pool's item: an array, or a ``(tenant, array)`` pair."""
    arr = item[1] if isinstance(item, tuple) else item
    return arr.shape[0]


def _saturated_rows_capacity(submit, pool, *, sustainable_frac=0.55,
                             clients=24, requests=360):
    """Throughput-anchored capacity probe: a saturated closed loop over
    the STEADY request mix measures the pipeline's ROW ceiling (total
    rows served over wall — a count, so host latency jitter cancels out
    of it), and ``sustainable_frac`` of that ceiling is the anchor every
    storm rate derives from.  Latency-bounded ramp probes read far apart
    run to run on a shared host (the p99 jitter floor sits where a health
    bound has to), and a big-request-only probe over-reads the mixed
    ceiling (big batches amortise the per-REQUEST host cost that binds
    the steady mix), so the probe replays the real mix."""
    mean_rows = sum(_rows_of(it) for it in pool) / len(pool)
    # the median of five spaced samples: a host's speed swings on a
    # seconds timescale, and one sample would anchor a whole storm to
    # whichever extreme it landed on
    samples = []
    for i in range(5):
        closed = serve_bench.closed_loop(submit, pool, clients,
                                         max(requests // 3, 60))
        samples.append(closed["rps"])
        if i < 4:
            time.sleep(PROBE_GAP_S)
    samples.sort()
    return sustainable_frac * samples[2] * mean_rows


def _steady_window(starts, finishes, completions):
    """A closed loop's rows a second over its steady window: from the last
    client's start to the first client's finish, counting the rows of the
    completions (``(time, rows)`` pairs) inside it; thread start-up and the
    ragged end fall outside.  Returns ``(rows_per_s, window_s, rows)``."""
    t0, t1 = max(starts), min(finishes)
    rows = sum(r for t, r in completions if t0 <= t <= t1)
    return (rows / (t1 - t0) if t1 > t0 else 0.0), t1 - t0, rows


def _steady_sample(submit, pool, clients, window_s, clock=time.perf_counter):
    """One closed-loop sample: ``clients`` threads each submit ``pool``'s
    requests back to back (the next once the last resolved; a shed one
    skipped after :data:`PROBE_SHED_BACKOFF_S`), all released together once
    every one has started, until told to stop ``window_s`` later.  Returns the
    :func:`_steady_window` reading (``rows_per_s``, ``window_s``, ``rows``)
    with the sample's whole wall, its completions and sheds, and its rows
    over the whole wall (``whole_rows_per_s``: start-up included, as a
    fixed-count sample reads it)."""
    started = threading.Barrier(clients + 1)
    stop = threading.Event()
    starts, finishes = [0.0] * clients, [0.0] * clients
    done = [[] for _ in range(clients)]
    shed = [0] * clients

    def worker(k):
        starts[k] = clock()
        started.wait()
        i = k
        while not stop.is_set():
            item = pool[i % len(pool)]
            i += clients
            try:
                submit(item).result(timeout=60)
            except Overloaded:
                shed[k] += 1
                time.sleep(PROBE_SHED_BACKOFF_S)
                continue
            done[k].append((clock(), _rows_of(item)))
        finishes[k] = clock()

    threads = [threading.Thread(target=worker, args=(k,)) for k in range(clients)]
    t_start = clock()
    for t in threads:
        t.start()
    started.wait()
    time.sleep(window_s)
    stop.set()
    for t in threads:
        t.join()
    wall = clock() - t_start
    completions = [c for d in done for c in d]
    rate, window, rows = _steady_window(starts, finishes, completions)
    return {"rows_per_s": rate, "window_s": window, "rows": rows, "wall_s": wall,
            "completed": len(completions), "shed": sum(shed),
            "whole_rows_per_s": sum(r for _, r in completions) / wall if wall > 0 else 0.0}


def _steady_rows_capacity(submit, pool, *, sustainable_frac=0.55, clients=24,
                          window_s=None, samples=5, log=None):
    """The card's capacity probe: :func:`_saturated_rows_capacity`'s anchor
    (``sustainable_frac`` of the median of five spaced samples of a
    saturated closed loop over the mix) with each sample counted over its
    steady window (:func:`_steady_sample`, :data:`CARD_PROBE_WINDOW_S`
    long), where a sample of a fixed few requests a client is mostly its
    threads' start and join on the card.  ``log``, a list, gets the
    samples and the anchor."""
    window_s = CARD_PROBE_WINDOW_S if window_s is None else window_s
    readings = []
    for i in range(samples):
        readings.append(_steady_sample(submit, pool, clients, window_s))
        if i < samples - 1:
            time.sleep(PROBE_GAP_S)
    anchor = sustainable_frac * float(np.median([r["rows_per_s"] for r in readings]))
    if log is not None:
        log.append({"samples": readings, "anchor_rows_per_s": anchor})
    return anchor


def default_capacity_probe(device, requests):
    """The probe :func:`run_storm` anchors on: JAX's
    :func:`_saturated_rows_capacity` (samples of ``requests // 3``
    requests) on the CPU, :func:`_steady_rows_capacity` on the card."""
    if device.type == "cuda":
        return _steady_rows_capacity
    return functools.partial(_saturated_rows_capacity, requests=requests)


def default_lanes_max() -> int:
    """Host-derived lane ceiling for the storm's adaptive arm: extra
    dispatch lanes only help when there are host cores for their threads
    (each lane is a Python thread that copies in, launches and fetches),
    so the bound follows the host: half its cores, at most 4."""
    return max(1, min(4, (os.cpu_count() or 2) // 2))


def run_storm(model="logreg", n_particles=4000, n_features=54, seed=0,
              steady_s=5.0, burst_s=5.0, recover_s=5.0, burst_mult=2.0,
              util=0.45, p99_target_ms=25.0, max_batch=256,
              max_queue_rows=512, base_lanes=1, base_wait_ms=2.0,
              lanes_max=None, wait_max_ms=16.0, interval_s=0.25,
              rows_sizes=(1, 2, 4, 8, 16, 32), rows_alpha=1.3,
              flash_rows_sizes=(16, 32, 64), tenants=3,
              calib_requests=400, include_static=True, device=None):
    """Measure the ``serve_storm`` row: a multi-tenant registry (serving
    on ``device``: the card unless ``'cpu'``) under the identical seeded
    steady → flash-crowd-burst → recovery trace, replayed against static
    configurations and against the autoscale controller — one set of
    warmed engines, every timed arm under ``capture_sentry``.

    The burst is a **flash crowd**: one tenant (``hog``) floods the
    shared queue with heavy requests (``flash_rows_sizes``) at an offered
    ROW rate of ``burst_mult ×`` its measured capacity, while the polite
    tenants keep their steady demand.  A static configuration admits the
    flood FIFO, so every tenant's queue delay grows to the full bound
    (``max_queue_rows`` rows of backlog ahead of each arrival); the
    controller tightens quotas into admission-enforced mode, keeping the
    hog's queue occupancy — and so everyone's delay — bounded, and sheds
    the flood at arrival instead of after it has queued.

    Arms: ``static_base`` (server defaults), ``static_burst`` (the
    controller's upper window/lane bounds held always — pays the
    coalescing floor at steady), ``adaptive``.  ``value`` /
    ``storm_goodput_2x`` is the adaptive arm's whole-trace POLITE
    goodput (non-hog completions within ``p99_target_ms`` per second);
    ``storm_p99_breach_s`` / ``storm_recover_s`` are judged over the
    polite completions too.  The A/B block compares against the best
    static arm per metric.
    """
    if tenants < 2:
        raise ValueError(
            "run_storm needs >= 2 tenants (a hog and at least one polite "
            f"tenant), got {tenants}; use --mode replay for single-tenant "
            "experiments"
        )
    dev = resolve_device(device)
    if lanes_max is None:
        lanes_max = default_lanes_max()
    lanes_max = max(lanes_max, base_lanes)
    duration = steady_s + burst_s + recover_s
    hog = "hog"
    polite_names = [f"svc-{i}" for i in range(tenants - 1)]
    names = polite_names + [hog]

    metrics = telemetry.MetricsRegistry()
    reg = ModelRegistry(
        metrics=metrics, max_total_buckets=8 * tenants,
        max_batch=max_batch, lanes=base_lanes, max_wait_ms=base_wait_ms,
        max_queue_rows=max_queue_rows)
    rng = np.random.default_rng(seed)
    feature_dim = n_features
    for name in names:
        parts = rng.normal(size=(n_particles, 1 + feature_dim))
        reg.add_tenant(name, model, particles=parts.astype(np.float32),
                       min_bucket=8, max_bucket=max_batch,
                       quota_rows=max_queue_rows, device=dev)
    reg.warm()  # every reachable bucket captured, all tenants
    time.sleep(WARM_SETTLE_S)
    all_sizes = tuple(sorted(set(rows_sizes) | set(flash_rows_sizes)))
    pools = serve_bench.request_pool_by_size(
        feature_dim, all_sizes, per_size=32, seed=seed + 1)

    # TWO anchors, both probed THROUGH the registry, because the two
    # phases they size are bound by different constraints:
    # - the STEADY anchor replays the steady reality — tenant-interleaved
    #   heavy-tailed small requests, whose single-tenant coalescing gives
    #   run-length-one batches; the steady rate must be sustainable under
    #   exactly that penalty;
    # - the HOG anchor is one tenant's flash-size stream — long same-
    #   tenant runs coalesce into full batches, so 2× THIS ceiling is a
    #   genuine overload even for the best-batching flood imaginable.
    size_probs = TraceConfig(rows_sizes=rows_sizes,
                             rows_alpha=rows_alpha)._size_probs()
    prng = np.random.default_rng(seed + 7)
    probe_sizes = [rows_sizes[int(prng.choice(len(rows_sizes),
                                              p=size_probs))]
                   for _ in range(96)]
    steady_pool = [(names[i % len(names)], pools[r][i % len(pools[r])])
                   for i, r in enumerate(probe_sizes)]
    probe = default_capacity_probe(dev, max(min(calib_requests, 240), 120))
    capacity_rows = probe(lambda item: reg.submit(item[0], item[1]), steady_pool)
    big = max(flash_rows_sizes)
    hog_pool = [(hog, pools[big][i % len(pools[big])]) for i in range(48)]
    hog_capacity_rows = probe(lambda item: reg.submit(item[0], item[1]), hog_pool)
    time.sleep(PROBE_SETTLE_S)
    mean_rows = sum(r * p for r, p in zip(rows_sizes, size_probs))
    capacity_rps = capacity_rows / mean_rows
    mean_flash_rows = sum(flash_rows_sizes) / len(flash_rows_sizes)
    hog_burst_rps = burst_mult * hog_capacity_rows / mean_flash_rows

    base_rps = util * capacity_rps
    cfg = TraceConfig(
        duration_s=duration, base_rps=base_rps, seed=seed,
        diurnal_amp=0.1, rows_sizes=rows_sizes, rows_alpha=rows_alpha,
        tenants=tuple(names), tenant_skew=0.5,
    )
    # the flash crowd rides a second seeded trace merged in: the hog
    # offers burst_mult × capacity in ROWS (heavy requests, uniform over
    # flash_rows_sizes) for exactly the burst window
    flash_cfg = TraceConfig(
        duration_s=burst_s, base_rps=hog_burst_rps, seed=seed + 101,
        diurnal_amp=0.0, rows_sizes=flash_rows_sizes, rows_alpha=0.0,
        tenants=(hog,),
    )
    events = generate_trace(cfg)
    for ev in generate_trace(flash_cfg):
        ev.t += steady_s
        events.append(ev)
    events.sort(key=lambda e: e.t)
    submit = make_submit(reg.batcher, pools, model_registry=reg)

    arms = {}
    if include_static:
        arms["static_base"] = dict(lanes=base_lanes, wait=base_wait_ms,
                                   adaptive=False)
        arms["static_burst"] = dict(lanes=lanes_max, wait=wait_max_ms,
                                    adaptive=False)
    arms["adaptive"] = dict(lanes=base_lanes, wait=base_wait_ms,
                            adaptive=True)

    def lat_stats(records):
        lats = sorted(r["lat_ms"] for r in records if r["status"] == "ok")
        return (round(_percentile(lats, 0.50), 3),
                round(_percentile(lats, 0.99), 3))

    results = {}
    misses_before = sum(reg.tenant(n).engine.stats()["bucket_misses"]
                        for n in names)
    with capture_sentry("serve_storm timed replays") as sentry:
        for arm_name, arm in arms.items():
            # ONE registry across arms (fresh engines would capture inside
            # the sentried window): retune the live knobs between arms
            # through the same seams the controller uses
            reg.batcher.set_lanes(arm["lanes"])
            reg.batcher.set_max_wait_ms(arm["wait"])
            reg.batcher.set_quota_mode("overflow")
            for n in names:
                reg.set_quota(n, max_queue_rows)
            time.sleep(ARM_SETTLE_S)
            controller = None
            if arm["adaptive"]:
                controller = AutoscaleController(
                    reg.batcher, metrics=metrics, model_registry=reg,
                    policy=AutoscalePolicy(
                        lanes_max=lanes_max, max_wait_ms_max=wait_max_ms,
                        p99_target_ms=p99_target_ms,
                        # the tightened per-tenant bound: a hog holds at
                        # most this share of the queue while overloaded
                        quota_tighten_frac=0.125,
                        # fast ramp (a burst eats its phase while a slow
                        # controller deliberates) but TWO consecutive
                        # overload windows to act — a single host-stall
                        # spike in one window must not flap the knobs
                        cooldown_s=interval_s,
                        up_consecutive=2,
                        down_consecutive=max(2, int(0.75 / interval_s)),
                    ))
                controller.start(interval_s)
            try:
                records = replay(events, submit)
            finally:
                if controller is not None:
                    controller.stop()
            # drain between arms: the next arm's records must not queue
            # behind this one's tail
            deadline = time.monotonic() + 30.0
            while (reg.batcher.queued_rows() > 0
                   and time.monotonic() < deadline):
                time.sleep(0.01)
            polite = [r for r in records if r["tenant"] != hog]
            hog_recs = [r for r in records if r["tenant"] == hog]
            whole = window_metrics(records, 0.0, duration, p99_target_ms)
            p_burst = window_metrics(polite, steady_s, steady_s + burst_s,
                                     p99_target_ms)
            p_burst["p50_ms"], p_burst["p99_ms"] = lat_stats(
                [r for r in polite if steady_s <= r["t"] < steady_s + burst_s])
            results[arm_name] = {
                "lanes": arm["lanes"], "max_wait_ms": arm["wait"],
                "adaptive": arm["adaptive"],
                "goodput_rps": whole["goodput_rps"],
                "polite_goodput_rps": window_metrics(
                    polite, 0.0, duration, p99_target_ms)["goodput_rps"],
                "p99_breach_s": p99_breach_seconds(
                    polite, p99_target_ms, duration),
                "recover_s": time_to_recover(
                    polite, steady_s + burst_s, p99_target_ms, duration),
                "shed": whole["shed"],
                "errors": whole["errors"],
                "lost": whole["lost"],
                "hog": {"offered": len(hog_recs),
                        "completed": sum(1 for r in hog_recs
                                         if r["status"] == "ok"),
                        "shed": sum(1 for r in hog_recs
                                    if r["status"] == "shed")},
                "phases": {
                    "steady": window_metrics(polite, 0.0, steady_s,
                                             p99_target_ms),
                    "burst_polite": p_burst,
                    "recover": window_metrics(polite, steady_s + burst_s,
                                              duration, p99_target_ms),
                },
            }
            if controller is not None:
                st = controller.status()
                results[arm_name]["controller"] = {
                    "steps": st["steps"], "actions": st["actions"],
                    "final_lanes": st["lanes"],
                    "final_max_wait_ms": st["max_wait_ms"],
                    "final_quota_scale": st["quota_scale"],
                }
    recompiles = sum(reg.tenant(n).engine.stats()["bucket_misses"]
                     for n in names) - misses_before
    reg.close(drain=True)

    adaptive = results["adaptive"]
    ab = None
    if include_static:
        # the A/B is judged on the POLITE tenants — the traffic the SLO
        # protects while a hog floods.  Total goodput is reported per arm
        # but not judged: a static arm fast enough to absorb the flood
        # "wins" total goodput by serving hostile excess the controller
        # deliberately refuses at admission.
        statics = {k: v for k, v in results.items() if not v["adaptive"]}
        best_goodput = max(v["polite_goodput_rps"] for v in statics.values())
        best_breach = min(v["p99_breach_s"] for v in statics.values())
        best_recover = min(v["recover_s"] for v in statics.values())
        ab = {
            "best_static_polite_goodput_rps": best_goodput,
            "best_static_p99_breach_s": best_breach,
            "best_static_recover_s": best_recover,
            "goodput_ratio": round(
                adaptive["polite_goodput_rps"] / best_goodput, 3)
            if best_goodput else None,
            "breach_delta_s": round(
                best_breach - adaptive["p99_breach_s"], 3),
            "adaptive_wins": bool(
                adaptive["polite_goodput_rps"] > best_goodput
                and adaptive["p99_breach_s"] < best_breach),
        }

    return {
        "metric": "serve_storm",
        "unit": "good polite requests/sec over the storm",
        "platform": "gpu" if dev.type == "cuda" else "cpu",
        "model": model,
        "n_particles": n_particles,
        "tenants": tenants,
        "trace": {"events": len(events), "seed": seed,
                  "duration_s": duration, "steady_s": steady_s,
                  "burst_s": burst_s, "recover_s": recover_s,
                  "burst_mult": burst_mult, "util": util,
                  "base_rps": round(base_rps, 1),
                  "hog_burst_rps": round(hog_burst_rps, 1),
                  "rows_sizes": list(rows_sizes),
                  "flash_rows_sizes": list(flash_rows_sizes),
                  "rows_alpha": rows_alpha},
        "capacity_rps": round(capacity_rps, 1),
        "capacity_rows_per_s": round(capacity_rows, 1),
        "hog_capacity_rows_per_s": round(hog_capacity_rows, 1),
        "p99_target_ms": p99_target_ms,
        "max_batch": max_batch, "max_queue_rows": max_queue_rows,
        "bounds": {"lanes": [base_lanes, lanes_max],
                   "max_wait_ms": [base_wait_ms, wait_max_ms]},
        "value": adaptive["polite_goodput_rps"],
        "storm_goodput_2x": adaptive["polite_goodput_rps"],
        "storm_total_goodput_rps": adaptive["goodput_rps"],
        "storm_p99_breach_s": adaptive["p99_breach_s"],
        "storm_recover_s": adaptive["recover_s"],
        "arms": results,
        "ab": ab,
        "lost_requests": sum(v["lost"] + v["errors"]
                             for v in results.values()),
        "shed_requests": sum(v["shed"] for v in results.values()),
        "recompiles": recompiles,
        # the port's sentry counts CUDA-graph captures and hand-kernel
        # builds, JAX's counts XLA compiles; both are "new programs"
        "sentry_compiles": sentry.compiles if sentry.supported else None,
    }


def storm_ok(row):
    """The unconditional ``serve_storm`` correctness gates — reasons a
    row FAILs regardless of its throughput numbers.  Returns
    ``(ok, [why...])``."""
    why = []
    if row.get("lost_requests"):
        why.append(f"{row['lost_requests']} non-shed request(s) lost or "
                   "errored — every admitted request must resolve")
    if row.get("recompiles"):
        why.append(f"{row['recompiles']} steady-state bucket recompile(s) "
                   "in the replay windows")
    if row.get("sentry_compiles"):
        why.append(f"{row['sentry_compiles']} CUDA-graph capture(s) or "
                   "kernel build(s) inside the sentried replay windows")
    for name, arm in row.get("arms", {}).items():
        phases = arm["phases"]
        total = sum(p["offered"] for p in phases.values())
        accounted = sum(p["completed"] + p["shed"] + p["errors"] + p["lost"]
                        for p in phases.values())
        if total != accounted:
            why.append(f"arm {name}: {total} offered but {accounted} "
                       "accounted — records leaked")
    return (not why), why


# --------------------------------------------------------------------- #


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m dist_svgd_torch.tools.workload_replay",
        description=__doc__.splitlines()[0])
    ap.add_argument("--mode", choices=("storm", "trace", "replay"),
                    default="storm")
    ap.add_argument("--model", choices=("logreg", "bnn", "gmm"),
                    default="logreg")
    ap.add_argument("--n-particles", type=int, default=4000)
    ap.add_argument("--n-features", type=int, default=54)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--steady-s", type=float, default=5.0)
    ap.add_argument("--burst-s", type=float, default=5.0)
    ap.add_argument("--recover-s", type=float, default=5.0)
    ap.add_argument("--burst-mult", type=float, default=2.0,
                    help="burst offered rate as a multiple of the "
                         "measured base-config capacity")
    ap.add_argument("--util", type=float, default=0.45,
                    help="steady offered rate as a fraction of capacity")
    ap.add_argument("--p99-target-ms", type=float, default=25.0)
    ap.add_argument("--max-batch", type=int, default=256)
    ap.add_argument("--max-queue-rows", type=int, default=512)
    ap.add_argument("--lanes-max", type=int, default=None,
                    help="adaptive lane ceiling (default: host-derived)")
    ap.add_argument("--wait-max-ms", type=float, default=16.0)
    ap.add_argument("--interval-s", type=float, default=0.25,
                    help="adaptive controller cadence")
    ap.add_argument("--rows", default="1,2,4,8,16,32",
                    help="request-size support of the heavy-tailed draw")
    ap.add_argument("--rows-alpha", type=float, default=1.3)
    ap.add_argument("--base-rps", type=float, default=200.0,
                    help="trace/replay modes: baseline rate (storm mode "
                         "calibrates its own)")
    ap.add_argument("--duration-s", type=float, default=24.0,
                    help="trace/replay modes: trace length")
    ap.add_argument("--tenants", type=int, default=3,
                    help="storm mode: tenant count (one hog + N-1 polite); "
                         "trace mode: tenant count for the skewed mix")
    ap.add_argument("--flash-rows", default="16,32,64",
                    help="storm mode: the flash crowd's heavy request "
                         "sizes")
    ap.add_argument("--url", default=None,
                    help="replay mode: live serving.server base URL "
                         "(default replays in-process)")
    ap.add_argument("--fleet", type=int, default=0,
                    help="replay mode: route through an N-replica "
                         "in-process fake fleet (FleetRouter front door) "
                         "instead of one batcher")
    ap.add_argument("--device", choices=("cuda", "cpu"), default=None,
                    help="default: the card (fails without CUDA)")
    args = ap.parse_args(argv)

    rows = tuple(int(r) for r in args.rows.split(","))
    if args.mode == "storm":
        out = run_storm(
            model=args.model, n_particles=args.n_particles,
            n_features=args.n_features, seed=args.seed,
            steady_s=args.steady_s, burst_s=args.burst_s,
            recover_s=args.recover_s, burst_mult=args.burst_mult,
            util=args.util, p99_target_ms=args.p99_target_ms,
            max_batch=args.max_batch, max_queue_rows=args.max_queue_rows,
            lanes_max=args.lanes_max, wait_max_ms=args.wait_max_ms,
            interval_s=args.interval_s, rows_sizes=rows,
            rows_alpha=args.rows_alpha, tenants=args.tenants,
            flash_rows_sizes=tuple(
                int(r) for r in args.flash_rows.split(",")),
            device=args.device)
        ok, why = storm_ok(out)
        out["gates_ok"] = ok
        if not ok:
            out["gates_why"] = why
        print(json.dumps(out), flush=True)
        return 0 if ok else 1
    cfg = TraceConfig(
        duration_s=args.duration_s, base_rps=args.base_rps, seed=args.seed,
        bursts=((args.steady_s, args.burst_s, args.burst_mult),),
        rows_sizes=rows, rows_alpha=args.rows_alpha,
        tenants=tuple(f"t{i}" for i in range(args.tenants)))
    events = generate_trace(cfg)
    if args.mode == "trace":
        print(json.dumps({"config": cfg.to_dict(), "events": len(events),
                          "head": [{"t": round(e.t, 4), "rows": e.rows,
                                    "tenant": e.tenant}
                                   for e in events[:20]]}), flush=True)
        return 0
    # replay mode
    if args.url:
        pools = serve_bench.request_pool_by_size(
            args.n_features, rows, per_size=32, seed=args.seed + 1)
        transport = make_http_submit(args.url)
        records = replay(events, transport(pools))
        transport.shutdown(wait=False)
    elif args.fleet:
        pools = serve_bench.request_pool_by_size(
            args.n_features, rows, per_size=32, seed=args.seed + 1)
        router, close_fleet = build_fake_fleet(
            args.fleet, tenants=tuple(f"t{i}" for i in range(args.tenants)))
        transport = make_router_submit(router)
        try:
            records = replay(events, transport(pools))
        finally:
            transport.shutdown(wait=False)
            close_fleet()
    else:
        engine = serve_bench.build_engine(
            args.model, args.n_particles, args.n_features, None, args.seed,
            max_bucket=args.max_batch,
            registry=telemetry.MetricsRegistry(), device=args.device)
        engine.warmup()
        pools = serve_bench.request_pool_by_size(
            engine.feature_dim, rows, per_size=32, seed=args.seed + 1)
        bat = MicroBatcher(engine.predict, max_batch=args.max_batch,
                           max_queue_rows=args.max_queue_rows,
                           registry=telemetry.MetricsRegistry())
        try:
            records = replay(events, make_submit(bat, pools))
        finally:
            bat.close(drain=True)
    print(json.dumps({
        "metric": "workload_replay",
        "config": cfg.to_dict(),
        "whole": window_metrics(records, 0.0, cfg.duration_s,
                                args.p99_target_ms),
        "p99_breach_s": p99_breach_seconds(records, args.p99_target_ms,
                                           cfg.duration_s),
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
