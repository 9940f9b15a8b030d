"""Progressive delivery of posterior generations: shadow → canary → promote.

Counterpart of ``dist_svgd_tpu/rollout/controller.py``, kept whole: the
same plan validation, the same crc32 hash split (:func:`_hash_unit` is
plain ``zlib``, so both packages route every request key to the same
generation), the same divergence buckets, decision log and ``status()``
document on the same clock and observations.  Everything here is host
code; the candidate's programs are the engine's (one CUDA graph a bucket
on the card, captured when :meth:`RolloutController.offer` stages it).

Without a rollout a new generation goes from checkpoint to 100% of
traffic in one atomic ``PredictiveEngine.reload`` swap; the only safety
net is the pre-serve ``ReloadPolicy`` health check, so a generation that
passes the KSD/ESS floors but degrades *live predictions* hits every user
at once.
:class:`RolloutController` replaces the cutover with staged exposure
judged on live SLO windows — the production model-rollout discipline:

1. **shadow** — the batcher mirrors a deterministic sampled fraction of
   live requests to the staged candidate *off the client's critical path*
   (a bounded background worker; an over-full mirror queue DROPS, it never
   queues client latency), recording per-request prediction divergence vs
   the incumbent into the ``svgd_rollout_divergence`` histogram.  The
   client answer always comes from the incumbent.
2. **canary stages** — deterministic per-request hash splits send a
   growing fraction (default 1% → 10% → 50% → 100%) of real traffic to the
   candidate.  The split is a pure function of the request key and the
   fraction is a nested threshold, so a request routed to the candidate at
   1% stays on the candidate at every later stage — users never flap
   between generations.  Candidate-served requests carry a
   ``generation="candidate"`` label on every serve metric, so the SLO
   engine judges candidate and incumbent as separate label sets.
3. **promote / rollback** — a stage advances when its windows stay green
   for the hold period with enough data; the candidate promotes to
   incumbent (``engine.promote_candidate`` — the same O(1) pointer
   exchange as a reload's admitted swap, with the outgoing incumbent kept
   resident for ``engine.rollback``).  A breach streak rolls back: the
   candidate is dropped and the split zeroed — the incumbent never stopped
   being resident, so rollback is O(1) and **never touches a checkpoint**.

Control discipline is JAX's ``serving/autoscale.py`` controller's: an
injectable clock, the controller's OWN
``SloEngine(mirror_metrics=False)`` and windows (its cadence must not
starve the ``/slo`` endpoint's objective windows), every window primed at
:meth:`~RolloutController.offer` so the first control step judges the
delta since the rollout began, ``step()`` as the whole control iteration
under one lock, a bounded decision log, and ``start()/stop()`` for a
background cadence (drills and tier-1 tests drive ``step(now=...)``
manually and deterministically).

``dist_svgd_torch/tools/rollout_drill.py`` measures the loop end to end
and emits the gated ``canary_rollout`` row;
``resilience.faults.BadGenerationAt`` manufactures the
deterministic-garbage candidate its rollback phase uses.
"""

from __future__ import annotations

import threading
import time
import zlib
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, Optional, Sequence

import numpy as np

from dist_svgd_torch.telemetry import metrics as _metrics
from dist_svgd_torch.telemetry.slo import HistogramWindow, default_rollout_slos

__all__ = ["RolloutPlan", "RolloutController", "DIVERGENCE_BUCKETS"]

#: Bucket lattice for the per-request divergence histogram: powers of two
#: from 1e-6 up to ~1.0 — prediction-space distances, not latencies (a
#: garbage candidate lands in the overflow bucket, which every finite
#: threshold counts as over).
DIVERGENCE_BUCKETS = tuple(1e-6 * 2.0 ** i for i in range(21))

IDLE = "idle"
SHADOW = "shadow"
CANARY = "canary"


def _hash_unit(seed: int, salt: str, key) -> float:
    """Deterministic uniform-ish in [0, 1) from ``(seed, salt, key)`` —
    crc32, NOT Python ``hash()`` (randomized per process, which would make
    replayed traffic split differently every run)."""
    h = zlib.crc32(f"{seed}:{salt}:{key}".encode("utf-8")) & 0xFFFFFFFF
    return h / 4294967296.0


class RolloutPlan:
    """Declarative stage plan + judgement thresholds for one rollout.

    Args:
        shadow_fraction: fraction of live requests mirrored to the
            candidate (shadow stage and onward — the divergence signal
            keeps flowing through the canary stages).
        shadow_min_mirrors: mirrored predictions required before the
            shadow stage may go green (no promotion on an empty window).
        shadow_hold_s: how long shadow must stay green before the first
            canary stage.
        canary_stages: strictly-increasing candidate traffic fractions in
            ``(0, 1]``; the last must be ``1.0`` (full exposure precedes
            promotion).
        stage_hold_s: green hold per canary stage.
        stage_min_requests: candidate-served requests required per canary
            stage before it may advance.
        max_divergence: per-request divergence threshold (mean |candidate
            − incumbent| over the shared output fields).
        divergence_budget: allowed fraction of mirrored requests over
            ``max_divergence`` (the divergence objective's error budget).
        p99_ms / error_budget: candidate-side serve SLOs — p99 latency
            threshold and dispatch-error budget per batch, judged on the
            ``generation="candidate"`` label set only.
        breach_streak: consecutive breaching control steps before
            rollback (1 = roll back the moment a window breaches).
        mirror_inflight_limit: bound on queued+running shadow mirrors;
            beyond it mirrors DROP (counted) — mirroring must never grow
            an unbounded backlog behind a slow candidate.
        on_active: what :meth:`RolloutController.offer` does while a
            rollout is in flight — ``'supersede'`` (drop the current
            candidate, start over with the new one: freshest data wins,
            the streaming cadence) or ``'defer'`` (refuse the offer).
        seed: hash-split seed (one seed per rollout keeps the user→side
            assignment stable for its whole lifetime).
    """

    def __init__(
        self,
        *,
        shadow_fraction: float = 0.25,
        shadow_min_mirrors: int = 32,
        shadow_hold_s: float = 5.0,
        canary_stages: Sequence[float] = (0.01, 0.10, 0.50, 1.0),
        stage_hold_s: float = 5.0,
        stage_min_requests: int = 16,
        max_divergence: float = 0.05,
        divergence_budget: float = 0.01,
        p99_ms: float = 100.0,
        error_budget: float = 0.01,
        breach_streak: int = 1,
        mirror_inflight_limit: int = 4,
        on_active: str = "supersede",
        seed: int = 0x5F6D,
    ):
        if not 0.0 < shadow_fraction <= 1.0:
            raise ValueError(
                f"shadow_fraction must be in (0, 1], got {shadow_fraction}")
        if shadow_min_mirrors < 1:
            raise ValueError(
                f"shadow_min_mirrors must be >= 1, got {shadow_min_mirrors}")
        if shadow_hold_s < 0:
            raise ValueError(
                f"shadow_hold_s must be >= 0, got {shadow_hold_s}")
        stages = tuple(float(f) for f in canary_stages)
        if not stages or any(not 0.0 < f <= 1.0 for f in stages):
            raise ValueError(
                f"canary_stages must be fractions in (0, 1], got {stages}")
        if any(b <= a for a, b in zip(stages, stages[1:])):
            raise ValueError(
                f"canary_stages must be strictly increasing, got {stages}")
        if stages[-1] != 1.0:
            raise ValueError(
                f"the last canary stage must be 1.0 (full exposure "
                f"precedes promotion), got {stages}")
        if stage_hold_s < 0:
            raise ValueError(f"stage_hold_s must be >= 0, got {stage_hold_s}")
        if stage_min_requests < 1:
            raise ValueError(
                f"stage_min_requests must be >= 1, got {stage_min_requests}")
        if max_divergence <= 0:
            raise ValueError(
                f"max_divergence must be positive, got {max_divergence}")
        if not 0.0 < divergence_budget < 1.0:
            raise ValueError(
                f"divergence_budget must be in (0, 1), got {divergence_budget}")
        if p99_ms <= 0:
            raise ValueError(f"p99_ms must be positive, got {p99_ms}")
        if not 0.0 <= error_budget < 1.0:
            raise ValueError(
                f"error_budget must be in [0, 1), got {error_budget}")
        if breach_streak < 1:
            raise ValueError(
                f"breach_streak must be >= 1, got {breach_streak}")
        if mirror_inflight_limit < 1:
            raise ValueError(
                f"mirror_inflight_limit must be >= 1, "
                f"got {mirror_inflight_limit}")
        if on_active not in ("supersede", "defer"):
            raise ValueError(
                f"on_active must be 'supersede' or 'defer', got {on_active!r}")
        self.shadow_fraction = float(shadow_fraction)
        self.shadow_min_mirrors = int(shadow_min_mirrors)
        self.shadow_hold_s = float(shadow_hold_s)
        self.canary_stages = stages
        self.stage_hold_s = float(stage_hold_s)
        self.stage_min_requests = int(stage_min_requests)
        self.max_divergence = float(max_divergence)
        self.divergence_budget = float(divergence_budget)
        self.p99_ms = float(p99_ms)
        self.error_budget = float(error_budget)
        self.breach_streak = int(breach_streak)
        self.mirror_inflight_limit = int(mirror_inflight_limit)
        self.on_active = on_active
        self.seed = int(seed)

    def describe(self) -> Dict[str, Any]:
        return {
            "shadow_fraction": self.shadow_fraction,
            "shadow_min_mirrors": self.shadow_min_mirrors,
            "shadow_hold_s": self.shadow_hold_s,
            "canary_stages": list(self.canary_stages),
            "stage_hold_s": self.stage_hold_s,
            "stage_min_requests": self.stage_min_requests,
            "max_divergence": self.max_divergence,
            "divergence_budget": self.divergence_budget,
            "p99_ms": self.p99_ms,
            "error_budget": self.error_budget,
            "breach_streak": self.breach_streak,
            "mirror_inflight_limit": self.mirror_inflight_limit,
            "on_active": self.on_active,
            "seed": self.seed,
        }


def prediction_divergence(candidate: Dict[str, np.ndarray],
                          incumbent: Dict[str, np.ndarray]) -> float:
    """Mean absolute difference between two prediction dicts over their
    shared output fields (mean over rows and fields).  NaNs propagate —
    a candidate predicting NaN lands in the histogram's overflow bucket,
    which every finite divergence threshold counts as over."""
    keys = sorted(set(candidate) & set(incumbent))
    if not keys:
        return float("nan")
    total = 0.0
    for k in keys:
        total += float(np.mean(np.abs(np.asarray(candidate[k], np.float64)
                                      - np.asarray(incumbent[k], np.float64))))
    return total / len(keys)


class RolloutController:
    """Drives one candidate generation through the stage plan.

    Args:
        engine: the tenant's :class:`~dist_svgd_torch.serving.engine.
            PredictiveEngine` (candidates stage into its candidate slot).
        plan: the :class:`RolloutPlan` (default knobs otherwise).
        metrics: registry the serve/rollout series live in (default: the
            engine's — pass the batcher's registry when they differ).
        clock: injectable monotonic time source — every hold/streak
            decision reads it, so drills and tests drive the controller
            deterministically (``step(now=...)`` works too).
        logger: optional ``JsonlLogger`` — one record per decision.

    The batcher-facing seams — :meth:`assign` (hash split),
    :meth:`should_mirror`, :meth:`dispatch_candidate`, :meth:`mirror` —
    are cheap reads designed to be called per request/batch; the control
    loop itself lives entirely in :meth:`step`.
    """

    def __init__(self, engine, *, plan: Optional[RolloutPlan] = None,
                 metrics: Optional[_metrics.MetricsRegistry] = None,
                 clock: Callable[[], float] = time.monotonic,
                 logger=None):
        self.engine = engine
        self.plan = plan if plan is not None else RolloutPlan()
        self.metrics = metrics if metrics is not None else engine.registry
        self._clock = clock
        self._logger = logger
        self._lock = threading.Lock()
        self._tlabels = dict(engine._tlabels)

        reg = self.metrics
        self._m_div = reg.histogram(
            "svgd_rollout_divergence",
            "per-mirrored-request prediction divergence, candidate vs "
            "incumbent (mean |Δ| over shared output fields)",
            buckets=DIVERGENCE_BUCKETS)
        self._m_shadow_wall = reg.histogram(
            "svgd_rollout_shadow_wall_s",
            "candidate dispatch wall per shadow mirror (off the client's "
            "critical path)")
        self._m_promote_wall = reg.histogram(
            "svgd_rollout_promote_seconds",
            "offer -> promotion wall per promoted generation")
        self._m_mirrors = reg.counter(
            "svgd_rollout_mirrors_total", "shadow mirrors completed")
        self._m_mirror_dropped = reg.counter(
            "svgd_rollout_mirror_dropped_total",
            "shadow mirrors dropped by the inflight bound (never queued "
            "behind a slow candidate)")
        self._m_mirror_errors = reg.counter(
            "svgd_rollout_mirror_errors_total",
            "shadow mirrors that raised in the candidate dispatch")
        self._m_promotions = reg.counter(
            "svgd_rollout_promotions_total", "candidates promoted to serving")
        self._m_rollbacks = reg.counter(
            "svgd_rollout_rollbacks_total",
            "candidates rolled back by a breaching window")
        self._m_supersedes = reg.counter(
            "svgd_rollout_supersedes_total",
            "in-flight candidates superseded by a newer offer")
        self._m_fraction = reg.gauge(
            "svgd_rollout_fraction",
            "live candidate traffic fraction (hash-split threshold)")
        self._m_stage = reg.gauge(
            "svgd_rollout_stage",
            "rollout stage index (-1 idle, 0 shadow, 1.. canary stages)")

        # the controller's OWN objective windows (mirror_metrics=False:
        # its cadence must not clobber the /slo endpoint's verdict series)
        self._slo = default_rollout_slos(
            reg, p99_ms=self.plan.p99_ms, error_budget=self.plan.error_budget,
            max_divergence=self.plan.max_divergence,
            divergence_budget=self.plan.divergence_budget,
            labels=self._tlabels, mirror_metrics=False,
            clock=lambda: self._clock())
        self._div_window = HistogramWindow(reg, "svgd_rollout_divergence",
                                           labels=self._tlabels)

        # rollout state — all guarded by _lock (assign/should_mirror read
        # the two floats below lock-free: single attribute reads of
        # immutable values, refreshed only inside step()/offer())
        self._state = IDLE
        self._stage_index = -1          # -1 idle/shadow, >=0 canary
        self._split_fraction = 0.0
        self._mirror_fraction = 0.0
        self._tag: Optional[str] = None
        self._generation: Optional[int] = None
        self._watermark: Optional[float] = None
        self._offered_at: Optional[float] = None
        self._stage_entered: Optional[float] = None
        self._breaches = 0
        self._stage_counts: Dict[str, float] = {}
        self._promotions = 0
        self._rollbacks = 0
        self._supersedes = 0
        self._last_rows: Dict[str, Any] = {}
        #: Bounded decision log (stage transitions, promote, rollback).
        self.log: deque = deque(maxlen=64)

        self._mirror_slots = threading.BoundedSemaphore(
            self.plan.mirror_inflight_limit)
        self._executor: Optional[ThreadPoolExecutor] = None
        self._stop_evt = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._m_fraction.set(0.0, **self._tlabels)
        self._m_stage.set(-1, **self._tlabels)

    # ------------------------------------------------------------------ #
    # identity / cheap request-path reads

    @property
    def tenant(self) -> Optional[str]:
        """The tenant this rollout targets (the batcher gates its split
        hook on it — other tenants' traffic never participates)."""
        return self.engine.tenant

    @property
    def state(self) -> str:
        return self._state

    @property
    def active(self) -> bool:
        return self._state != IDLE

    def assign(self, key) -> Optional[str]:
        """Which generation serves the request with this key:
        ``'candidate'`` or ``None`` (incumbent).  A pure deterministic
        hash against the live stage fraction; the threshold is nested, so
        an assignment never flaps backwards as stages widen."""
        f = self._split_fraction
        if f <= 0.0:
            return None
        if f >= 1.0:
            return "candidate"
        return ("candidate"
                if _hash_unit(self.plan.seed, "split", key) < f else None)

    def should_mirror(self, key) -> bool:
        """Whether this (incumbent-served) request's prediction should be
        shadow-mirrored to the candidate."""
        f = self._mirror_fraction
        if f <= 0.0:
            return False
        return _hash_unit(self.plan.seed, "mirror", key) < f

    def dispatch_candidate(self, x, tenant: Optional[str] = None
                           ) -> Dict[str, np.ndarray]:
        """Candidate-side dispatch for a split batch.  Falls back to the
        incumbent when the candidate is gone (a rollback raced a batch
        already queued as candidate) — the client must get an answer
        either way."""
        try:
            return self.engine.predict(x, generation="candidate")
        except RuntimeError:
            return self.engine.predict(x)

    # ------------------------------------------------------------------ #
    # shadow mirroring (off the client's critical path)

    def mirror(self, x, incumbent_out: Dict[str, np.ndarray]) -> bool:
        """Hand one incumbent-served request to the shadow worker: the
        candidate re-predicts it in the background and the divergence
        lands in ``svgd_rollout_divergence``.  Never blocks: an over-full
        mirror queue drops (counted) — the pinned client-latency budget
        is protected by construction, not by luck.  Returns whether the
        mirror was enqueued."""
        if self._state == IDLE:
            return False
        if not self._mirror_slots.acquire(blocking=False):
            self._m_mirror_dropped.inc(**self._tlabels)
            return False
        ex = self._executor
        if ex is None:
            self._mirror_slots.release()
            return False
        # copy: the arrays are slices of the batcher's batch buffer; the
        # mirror outlives the dispatch that produced them
        x = np.array(x, copy=True)
        out = {k: np.array(v, copy=True) for k, v in incumbent_out.items()}
        try:
            ex.submit(self._mirror_task, x, out)
        except RuntimeError:            # executor shut down under us
            self._mirror_slots.release()
            return False
        return True

    def _mirror_task(self, x, incumbent_out) -> None:
        try:
            t0 = time.perf_counter()
            try:
                cand = self.engine.predict(x, generation="candidate")
            except RuntimeError:
                return  # candidate resolved (promoted/dropped) mid-flight
            wall = time.perf_counter() - t0
            div = prediction_divergence(cand, incumbent_out)
            self._m_div.observe(div, **self._tlabels)
            self._m_shadow_wall.observe(wall, **self._tlabels)
            self._m_mirrors.inc(**self._tlabels)
        except Exception:
            self._m_mirror_errors.inc(**self._tlabels)
        finally:
            self._mirror_slots.release()

    # ------------------------------------------------------------------ #
    # lifecycle

    def offer(self, particles, *, tag: Optional[str] = None,
              watermark: Optional[float] = None) -> bool:
        """Stage ``particles`` as a candidate and enter the shadow stage.

        While a rollout is in flight, ``plan.on_active`` decides:
        ``'supersede'`` drops the current candidate and starts over with
        the new one (the streaming supervisor's freshest-data-wins
        default); ``'defer'`` refuses (returns False) — the supervisor
        re-offers on a later segment.  Staging compiles the candidate's
        bucket kernels (off the request path); the first control step
        after ``offer`` judges the window since NOW — every objective
        window is primed here.
        """
        with self._lock:
            now = self._clock()
            if self._state != IDLE:
                if self.plan.on_active == "defer":
                    return False
                self._supersedes += 1
                self._m_supersedes.inc(**self._tlabels)
                self._record("supersede", now, superseded_tag=self._tag)
                self.engine.drop_candidate()
            info = self.engine.stage_candidate(particles, tag=tag)
            self._tag = tag
            self._generation = info["generation_id"]
            self._watermark = watermark
            self._offered_at = now
            self._stage_entered = now
            self._state = SHADOW
            self._stage_index = -1
            self._breaches = 0
            self._stage_counts = {}
            self._set_fractions(0.0, self.plan.shadow_fraction)
            if self._executor is None:
                self._executor = ThreadPoolExecutor(
                    max_workers=1, thread_name_prefix="rollout-shadow")
            # prime every window: the first step judges the delta from NOW
            self._slo.evaluate()
            self._div_window.poll()
            self._record("offer", now, tag=tag,
                         generation=self._generation)
        return True

    def _set_fractions(self, split: float, mirror: float) -> None:
        self._split_fraction = float(split)
        self._mirror_fraction = float(mirror)
        self._m_fraction.set(float(split), **self._tlabels)
        self._m_stage.set(
            -1 if self._state == IDLE
            else (0 if self._state == SHADOW else self._stage_index + 1),
            **self._tlabels)

    def _record(self, event: str, now: float, **fields) -> None:
        rec = {"t": round(now, 3), "event": event, "state": self._state,
               "stage": self._stage_name(), **fields}
        self.log.append(rec)
        if self._logger is not None:
            try:
                self._logger.log(event=f"rollout_{event}", **rec)
            except Exception:
                pass

    def _stage_name(self) -> str:
        if self._state == IDLE:
            return "idle"
        if self._state == SHADOW:
            return "shadow"
        return f"canary:{self.plan.canary_stages[self._stage_index]:g}"

    # ------------------------------------------------------------------ #
    # the control loop

    def step(self, now: Optional[float] = None) -> Dict[str, Any]:
        """One full control iteration: advance the objective windows,
        judge the current stage, and promote / advance / roll back.
        Returns a decision document (also appended to :attr:`log` when a
        transition happened)."""
        with self._lock:
            now = self._clock() if now is None else now
            if self._state == IDLE:
                return {"state": IDLE, "action": "none"}
            doc = self._slo.evaluate()
            rows = doc["objectives"]
            self._last_rows = {
                name: {k: row.get(k) for k in
                       ("status", "burn_rate", "window_count")}
                for name, row in rows.items()
            }
            for name, row in rows.items():
                self._stage_counts[name] = (self._stage_counts.get(name, 0)
                                            + (row.get("window_count") or 0))
            breached = [name for name, row in rows.items()
                        if row["status"] == "breach"]
            if breached:
                self._breaches += 1
                if self._breaches >= self.plan.breach_streak:
                    return self._rollback(now, breached)
                self._record("breach", now, objectives=breached,
                             streak=self._breaches)
                return {"state": self._state, "action": "breach",
                        "objectives": breached, "streak": self._breaches}
            self._breaches = 0
            held = now - self._stage_entered
            if self._state == SHADOW:
                mirrors = self._stage_counts.get("shadow_divergence", 0)
                if (held >= self.plan.shadow_hold_s
                        and mirrors >= self.plan.shadow_min_mirrors):
                    return self._advance(now)
                return {"state": SHADOW, "action": "hold",
                        "held_s": round(held, 3), "mirrors": mirrors}
            served = self._stage_counts.get("candidate_p99", 0)
            if (held >= self.plan.stage_hold_s
                    and served >= self.plan.stage_min_requests):
                return self._advance(now)
            return {"state": self._state, "action": "hold",
                    "stage": self._stage_name(),
                    "held_s": round(held, 3), "candidate_requests": served}

    def _advance(self, now: float) -> Dict[str, Any]:
        """Green hold satisfied: enter the next stage (or promote).
        Called only from :meth:`step`, which holds ``self._lock``."""
        if self._state == CANARY and (self._stage_index
                                      == len(self.plan.canary_stages) - 1):
            return self._promote(now)
        self._stage_index += 1
        self._state = CANARY
        self._stage_entered = now
        self._stage_counts = {}
        self._set_fractions(self.plan.canary_stages[self._stage_index],
                            self.plan.shadow_fraction)
        self._record("advance", now,
                     fraction=self.plan.canary_stages[self._stage_index])
        return {"state": CANARY, "action": "advance",
                "stage": self._stage_name(),
                "fraction": self._split_fraction}

    def _promote(self, now: float) -> Dict[str, Any]:
        info = self.engine.promote_candidate()
        wall = now - self._offered_at
        self._m_promote_wall.observe(max(wall, 0.0), **self._tlabels)
        self._m_promotions.inc(**self._tlabels)
        self._promotions += 1
        if self._watermark is not None:
            # promotion = this generation now answers ALL traffic: stamp
            # the freshness pair's serving half (tenant series — exact
            # label match for FreshnessObjective — plus the
            # generation-labelled identity series)
            gauge = self.metrics.gauge(
                "svgd_serving_watermark",
                "event-time data watermark of the served ensemble")
            gauge.set(self._watermark, **self._tlabels)
            gauge.set(self._watermark,
                      generation=str(info["generation_id"]), **self._tlabels)
        # resets under step()'s lock (the only caller)
        tag = self._tag
        watermark = self._watermark
        self._state = IDLE
        self._stage_index = -1
        self._tag = None
        self._generation = None
        self._watermark = None
        self._set_fractions(0.0, 0.0)
        self._record("promote", now, tag=tag,
                     generation=info["generation_id"],
                     promote_s=round(wall, 3))
        return {"state": IDLE, "action": "promote", "tag": tag,
                "generation": info["generation_id"],
                "watermark": watermark,
                "promote_s": round(wall, 3)}

    def _rollback(self, now: float, reasons) -> Dict[str, Any]:
        """Breach streak: drop the candidate and zero the split — the
        still-resident incumbent keeps serving.  O(1); no checkpoint is
        ever read on this path (regression-pinned)."""
        self.engine.drop_candidate()
        self._m_rollbacks.inc(**self._tlabels)
        self._rollbacks += 1
        # resets under step()'s lock (the only caller)
        tag = self._tag
        stage = self._stage_name()
        self._state = IDLE
        self._stage_index = -1
        self._tag = None
        self._generation = None
        self._watermark = None
        self._breaches = 0
        self._set_fractions(0.0, 0.0)
        self._record("rollback", now, tag=tag, at_stage=stage,
                     objectives=list(reasons))
        return {"state": IDLE, "action": "rollback", "tag": tag,
                "at_stage": stage, "objectives": list(reasons)}

    # ------------------------------------------------------------------ #
    # background cadence / teardown

    def start(self, interval_s: float = 0.25) -> "RolloutController":
        """Run :meth:`step` on a background cadence (drills/tests drive
        ``step()`` manually instead)."""
        if self._thread is None:
            self._stop_evt.clear()
            self._thread = threading.Thread(
                target=self._loop, args=(float(interval_s),),
                name="rollout-controller", daemon=True)
            self._thread.start()
        return self

    def _loop(self, interval_s: float) -> None:
        while not self._stop_evt.is_set():
            try:
                self.step()
            except Exception:
                # one bad control step must not kill the cadence — the
                # rollout stays in its current stage until the next step
                pass
            self._stop_evt.wait(interval_s)

    def stop(self) -> None:
        self._stop_evt.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None

    def close(self) -> None:
        """Stop the cadence and the shadow worker (any in-flight mirror
        finishes; an idle rollout stays idle)."""
        self.stop()
        ex, self._executor = self._executor, None
        if ex is not None:
            ex.shutdown(wait=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # ------------------------------------------------------------------ #

    def status(self) -> Dict[str, Any]:
        """JSON-friendly controller document (the ``/rollout``-style
        introspection surface)."""
        with self._lock:
            return {
                "state": self._state,
                "stage": self._stage_name(),
                "fraction": self._split_fraction,
                "mirror_fraction": self._mirror_fraction,
                "tag": self._tag,
                "candidate_generation": self._generation,
                "serving_generation": self.engine.stats()["generation_id"],
                "breach_streak": self._breaches,
                "stage_counts": dict(self._stage_counts),
                "last_objectives": dict(self._last_rows),
                "promotions": self._promotions,
                "rollbacks": self._rollbacks,
                "supersedes": self._supersedes,
                "plan": self.plan.describe(),
                "recent": list(self.log)[-8:],
            }
