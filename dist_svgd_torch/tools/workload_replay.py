"""Trace-driven workload replay: production-shaped traffic against the
serving stack — the trace core.

Counterpart of ``tools/workload_replay.py:71-466``: the seeded workload
model, the open-loop replayer and the window metrics, which the rollout
drill (``dist_svgd_torch/tools/rollout_drill.py``) replays its phases
with.  ``tools/serve_bench.py``'s closed/open loops answer "how fast is the
request path" at a FIXED rate and request shape.  Millions of users do not
offer fixed-rate traffic: rates swing diurnally, bursts arrive in Poisson
clumps, request sizes are heavy-tailed, and tenant demand is skewed with
occasional flash crowds.  This module generates that shape as a **fully
seeded, deterministic trace** (the same events as JAX's on the same
config: the draws are numpy's) and replays it open-loop (latency charged
from the *scheduled* arrival — no coordinated omission) against an
in-process ``MicroBatcher``+engine / ``ModelRegistry``, or a live
``serving.server`` URL:

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
- :func:`make_submit` / :func:`make_http_submit` — the in-process and
  HTTP transports.

The ``serve_storm`` half — :func:`run_storm` (the autoscale controller's
A/B against static configurations), :func:`storm_ok`,
:func:`default_lanes_max`, the fleet transports
(:func:`build_fake_fleet`, :func:`make_router_submit`) and the CLI
(:func:`main`) — needs the autoscale controller and the fleet, not ported
yet: each raises ``NotImplementedError`` naming ROADMAP A9.
"""

import json
import math
import threading
import time

from dist_svgd_torch.serving.batcher import _percentile


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
    import numpy as np

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
    from dist_svgd_torch.serving.batcher import Overloaded

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

    from dist_svgd_torch.serving.batcher import Overloaded

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
# the serve_storm half: the autoscale controller and the fleet


def _storm_unported(name):
    raise NotImplementedError(
        f"workload_replay.{name} belongs to the serve_storm A/B, which needs the "
        "autoscale controller (serving/autoscale.py) and the serving fleet "
        "(serving/fleet.py), not ported to PyTorch yet (ROADMAP A9)")


def make_router_submit(router, max_workers=16):
    """Fleet transport (a ``FleetRouter`` front door): ROADMAP A9."""
    _storm_unported("make_router_submit")


def build_fake_fleet(replicas=3, *, max_replica_rows=64, tenants=(),
                     probe_interval_s=0.2, registry=None):
    """A ``FleetRouter`` over loopback replicas: ROADMAP A9."""
    _storm_unported("build_fake_fleet")


def default_lanes_max() -> int:
    """The storm's adaptive-arm lane ceiling: ROADMAP A9."""
    _storm_unported("default_lanes_max")


def run_storm(*args, **kwargs):
    """The ``serve_storm`` row (static arms against the autoscale
    controller): ROADMAP A9."""
    _storm_unported("run_storm")


def storm_ok(row):
    """The ``serve_storm`` row's gates: ROADMAP A9."""
    _storm_unported("storm_ok")


def main(argv=None):
    """The storm / trace / replay CLI: ROADMAP A9."""
    _storm_unported("main")
