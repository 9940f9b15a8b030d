"""Declarative SLO engine over the metrics registry.

Counterpart of ``dist_svgd_tpu/telemetry/slo.py``, kept as the port's own
copy.  The registry answers "what are the numbers"; this layer answers
**"are we meeting the objectives"** — burn rate against an error budget,
evaluated directly on the registry's histogram buckets and counters:

- :class:`LatencyObjective` — "fraction of requests over ``threshold_s``
  stays within ``1 − target``" on a latency histogram's **window delta**
  (the observations since the previous evaluation; cumulative-since-start
  on the first).  ``burn_rate`` = observed-error-fraction / error-budget —
  1.0 is the edge of the budget.
- :class:`RatioObjective` — bad-event counter over a base counter (or a
  histogram's observation count) across the same window.
- :class:`GaugeCeiling` — an instantaneous statistic must stay at or
  under a ceiling: the KSD ceiling on ``svgd_diag_ksd`` is the posterior
  convergence SLO.
- :class:`StalenessObjective` — a unix-timestamp gauge must be newer than
  ``max_age_s`` (diagnostics recency, last hot reload).

:class:`SloEngine` owns the objective list and the per-objective window
state, returns one JSON-friendly evaluation document, and writes its own
verdicts back into the registry (``svgd_slo_burn_rate{slo=...}`` gauges,
``svgd_slo_breaches_total{slo=...}`` counters).  Clocks are injected.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Sequence

from dist_svgd_torch.telemetry import metrics as _metrics
from dist_svgd_torch.telemetry.metrics import Counter, Histogram, MetricsRegistry

__all__ = [
    "LatencyObjective",
    "RatioObjective",
    "GaugeCeiling",
    "StalenessObjective",
    "FreshnessObjective",
    "SloEngine",
    "HistogramWindow",
    "CounterWindow",
    "bucket_frac_over",
    "bucket_quantile",
    "default_serving_slos",
    "default_training_slos",
    "default_streaming_slos",
    "default_rollout_slos",
]

OK = "ok"
BREACH = "breach"
NO_DATA = "no_data"


class _Objective:
    """Shared name plumbing; subclasses implement ``evaluate(registry,
    now_s)`` returning a row dict with at least ``status`` and
    ``burn_rate``.  Objectives are stateful (window snapshots) and belong
    to one engine."""

    def __init__(self, name: str):
        if not name:
            raise ValueError("objective needs a non-empty name")
        self.name = name

    def evaluate(self, registry: MetricsRegistry, now_s: float) -> Dict:
        raise NotImplementedError


#: Label keys an aggregate-mode objective skips: a federated registry
#: carries every series twice (``replica=``-labelled + rollup), and
#: summing both would double-count the fleet.
AGGREGATE_EXCLUDE_KEYS = ("replica",)


def _aggregate_label_sets(metric) -> list:
    return [ls for ls in metric.label_sets()
            if not any(k in ls for k in AGGREGATE_EXCLUDE_KEYS)]


def _count_delta(registry: MetricsRegistry, name: str, labels: dict,
                 prev: Dict, key: str,
                 aggregate: bool = False) -> Optional[float]:
    """Windowed total of a Counter (value) or Histogram (observation
    count) since the previous evaluation; ``None`` when the metric was
    never registered.  ``aggregate=True`` sums across every label set
    (minus :data:`AGGREGATE_EXCLUDE_KEYS`) instead of reading one — the
    fleet-SLO mode, where traffic lives in tenant-labelled rollups."""
    metric = registry._metrics.get(name)  # read-only peek, same package
    if metric is None:
        return None
    if isinstance(metric, Counter):
        if aggregate:
            now = float(sum(metric.value(**ls)
                            for ls in _aggregate_label_sets(metric)))
        else:
            now = metric.value(**labels)
    elif isinstance(metric, Histogram):
        if aggregate:
            now = 0.0
            for ls in _aggregate_label_sets(metric):
                series = metric._snapshot(ls)
                if series is not None:
                    now += series.count
        else:
            series = metric._snapshot(labels)
            now = float(series.count) if series is not None else 0.0
    else:
        raise ValueError(f"metric {name!r} is not a counter or histogram")
    before = prev.get(key, 0.0)
    prev[key] = now
    return max(now - before, 0.0)


def bucket_frac_over(bounds, counts, threshold: float) -> float:
    """Fraction of a bucketed distribution's observations OVER ``threshold``:
    whole buckets below it count as under, plus a linear share of the
    bucket the threshold lands in (the same within-bucket interpolation
    ``Histogram.quantile`` uses); the overflow bucket is entirely over any
    finite threshold.  ``counts`` has ``len(bounds) + 1`` entries."""
    total = sum(counts)
    if not total:
        return 0.0
    under = 0.0
    lo = 0.0
    for i, hi in enumerate(bounds):
        c = counts[i]
        if hi <= threshold:
            under += c
        elif lo < threshold:
            under += c * (threshold - lo) / (hi - lo)
        lo = hi
    return max(0.0, 1.0 - under / total)


def bucket_quantile(bounds, counts, q: float) -> float:
    """Interpolated ``q``-quantile of a bucketed distribution (the
    windowed-counts counterpart of ``Histogram.quantile``, which only
    reads cumulative series).  Overflow-bucket hits clamp to the last
    finite bound."""
    total = sum(counts)
    if not total:
        return 0.0
    target = q * total
    seen = 0.0
    lo = 0.0
    for i, hi in enumerate(bounds):
        c = counts[i]
        if seen + c >= target and c > 0:
            return lo + (hi - lo) * (target - seen) / c
        seen += c
        lo = hi
    return lo  # landed in the overflow bucket


class HistogramWindow:
    """Stateful windowed accessor over one histogram series —
    an autoscale controller's view of the
    latency/queue-wait distributions *since its previous control step*,
    with the same delta discipline the SLO objectives use but **its own
    window state**: a controller polling at its own cadence must not
    advance (and thereby starve) the ``/slo`` endpoint's objective
    windows.

    :meth:`poll` returns ``{count, frac_over(threshold_s), p99_s, ...}``
    for the observations since the previous poll (cumulative on the
    first); a reset (fresh registry, restarted process) clamps to an
    empty window instead of going negative — the ``dump_delta``
    discipline."""

    def __init__(self, registry: MetricsRegistry, name: str,
                 labels: Optional[dict] = None, aggregate: bool = False):
        self.registry = registry
        self.name = name
        self.labels = dict(labels or {})
        self.aggregate = bool(aggregate)
        self._prev: Optional[List[int]] = None

    def _current(self) -> Optional[List[int]]:
        metric = self.registry._metrics.get(self.name)
        if not isinstance(metric, Histogram):
            return None
        if not self.aggregate:
            series = metric._snapshot(self.labels)
            return list(series.counts) if series is not None else None
        totals: Optional[List[int]] = None
        for ls in _aggregate_label_sets(metric):
            series = metric._snapshot(ls)
            if series is None:
                continue
            if totals is None:
                totals = list(series.counts)
            else:
                totals = [a + b for a, b in zip(totals, series.counts)]
        return totals

    def poll(self, threshold_s: Optional[float] = None) -> Dict:
        metric = self.registry._metrics.get(self.name)
        counts = self._current()
        prev, self._prev = self._prev, counts
        if counts is None or not isinstance(metric, Histogram):
            return {"count": 0, "frac_over": 0.0, "p50_s": 0.0, "p99_s": 0.0}
        if prev is not None and len(prev) == len(counts):
            window = [max(c - p, 0) for c, p in zip(counts, prev)]
        else:
            window = counts
        bounds = metric.buckets
        out = {
            "count": sum(window),
            "p50_s": bucket_quantile(bounds, window, 0.50),
            "p99_s": bucket_quantile(bounds, window, 0.99),
            "frac_over": (bucket_frac_over(bounds, window, threshold_s)
                          if threshold_s is not None else 0.0),
        }
        return out


class CounterWindow:
    """Stateful windowed delta of one counter series (sums across label
    sets with ``aggregate=True`` — minus the federation ``replica``
    identity); resets clamp to zero like every other window here."""

    def __init__(self, registry: MetricsRegistry, name: str,
                 labels: Optional[dict] = None, aggregate: bool = False):
        self.registry = registry
        self.name = name
        self.labels = dict(labels or {})
        self.aggregate = bool(aggregate)
        self._prev: Dict[str, float] = {}

    def poll(self) -> float:
        delta = _count_delta(self.registry, self.name, self.labels,
                             self._prev, "v", aggregate=self.aggregate)
        return float(delta) if delta is not None else 0.0


class LatencyObjective(_Objective):
    """``target`` fraction of observations must land at or under
    ``threshold_s``, judged per evaluation window.

    ``aggregate=True`` sums bucket counts across every label set of the
    histogram (minus :data:`AGGREGATE_EXCLUDE_KEYS`) before windowing —
    the **fleet-SLO mode**: a federated registry holds per-tenant rollup
    series, and the fleet-wide p99 is judged over their exact bucket sum
    (same lattice, so the sum is itself a valid histogram)."""

    def __init__(self, name: str, histogram: str, threshold_s: float,
                 target: float = 0.99, labels: Optional[dict] = None,
                 aggregate: bool = False):
        super().__init__(name)
        if not 0.0 < target < 1.0:
            raise ValueError(f"target must be in (0, 1), got {target}")
        if threshold_s <= 0:
            raise ValueError(f"threshold_s must be positive, got {threshold_s}")
        self.histogram = histogram
        self.threshold_s = float(threshold_s)
        self.target = float(target)
        self.labels = dict(labels or {})
        self.aggregate = bool(aggregate)
        self._prev_counts: Optional[List[int]] = None

    def _current_counts(self, hist: Histogram) -> Optional[List[int]]:
        if not self.aggregate:
            series = hist._snapshot(self.labels)
            return list(series.counts) if series is not None else None
        totals: Optional[List[int]] = None
        for ls in _aggregate_label_sets(hist):
            series = hist._snapshot(ls)
            if series is None:
                continue
            if totals is None:
                totals = list(series.counts)
            else:
                totals = [a + b for a, b in zip(totals, series.counts)]
        return totals

    def _window_counts(self, hist: Histogram) -> Optional[List[int]]:
        counts = self._current_counts(hist)
        if counts is None:
            return None
        prev = self._prev_counts
        self._prev_counts = counts
        if prev is None or len(prev) != len(counts):
            return counts
        return [max(c - p, 0) for c, p in zip(counts, prev)]

    def evaluate(self, registry: MetricsRegistry, now_s: float) -> Dict:
        metric = registry._metrics.get(self.histogram)
        row = {"objective": "latency", "histogram": self.histogram,
               "threshold_ms": round(self.threshold_s * 1e3, 4),
               "target": self.target}
        if not isinstance(metric, Histogram):
            row.update(status=NO_DATA, burn_rate=0.0, window_count=0)
            return row
        counts = self._window_counts(metric)
        total = sum(counts) if counts else 0
        if not total:
            row.update(status=NO_DATA, burn_rate=0.0, window_count=0)
            return row
        # observations at or under the threshold: whole buckets below it
        # plus a linear share of the bucket the threshold lands in
        # (bucket_frac_over — shared with the autoscale HistogramWindow)
        frac_over = bucket_frac_over(metric.buckets, counts,
                                     self.threshold_s)
        budget = 1.0 - self.target
        burn = frac_over / budget
        row.update(
            status=BREACH if burn > 1.0 else OK,
            burn_rate=round(burn, 4),
            frac_over=round(frac_over, 6),
            window_count=total,
        )
        return row


class RatioObjective(_Objective):
    """Windowed ``numerator / denominator`` must stay at or under
    ``max_ratio``.  Either name may be a counter or a histogram (a
    histogram contributes its observation count)."""

    def __init__(self, name: str, numerator: str, denominator: str,
                 max_ratio: float, labels: Optional[dict] = None,
                 aggregate: bool = False):
        super().__init__(name)
        if max_ratio < 0:
            raise ValueError(f"max_ratio must be >= 0, got {max_ratio}")
        self.numerator = numerator
        self.denominator = denominator
        self.max_ratio = float(max_ratio)
        self.labels = dict(labels or {})
        self.aggregate = bool(aggregate)
        self._prev: Dict[str, float] = {}

    def evaluate(self, registry: MetricsRegistry, now_s: float) -> Dict:
        num = _count_delta(registry, self.numerator, self.labels,
                           self._prev, "num", aggregate=self.aggregate)
        den = _count_delta(registry, self.denominator, self.labels,
                           self._prev, "den", aggregate=self.aggregate)
        row = {"objective": "ratio", "numerator": self.numerator,
               "denominator": self.denominator, "max_ratio": self.max_ratio}
        if (num or 0.0) > 0 and not den:
            # bad events with ZERO base events is the outage shape (every
            # request shed → none resolved): an infinite ratio, a breach —
            # never no_data (burn_rate None: unbounded, not a number)
            row.update(status=BREACH, burn_rate=None, ratio=None,
                       window_num=num, window_den=den or 0)
            return row
        if den is None or not den:
            row.update(status=NO_DATA, burn_rate=0.0, window_den=den or 0)
            return row
        ratio = (num or 0.0) / den
        burn = (ratio / self.max_ratio) if self.max_ratio > 0 else (
            0.0 if ratio == 0 else None)  # None: unbounded, not a number
        row.update(
            status=BREACH if ratio > self.max_ratio else OK,
            burn_rate=round(burn, 4) if burn is not None else None,
            ratio=round(ratio, 6),
            window_num=num or 0.0,
            window_den=den,
        )
        return row


class GaugeCeiling(_Objective):
    """The gauge's current value must stay at or under ``ceiling`` —
    instantaneous, not windowed (a gauge is already last-write-wins).
    A gauge that was never written is ``no_data``, not a breach."""

    def __init__(self, name: str, gauge: str, ceiling: float,
                 labels: Optional[dict] = None):
        super().__init__(name)
        if ceiling <= 0:
            raise ValueError(f"ceiling must be positive, got {ceiling}")
        self.gauge = gauge
        self.ceiling = float(ceiling)
        self.labels = dict(labels or {})

    def evaluate(self, registry: MetricsRegistry, now_s: float) -> Dict:
        metric = registry._metrics.get(self.gauge)
        row = {"objective": "gauge_ceiling", "gauge": self.gauge,
               "ceiling": self.ceiling}
        if metric is None or not metric.has(**self.labels):
            row.update(status=NO_DATA, burn_rate=0.0)
            return row
        value = metric.value(**self.labels)
        burn = value / self.ceiling
        # `not <=` so a NaN statistic reads as a breach, never as ok
        row.update(
            status=OK if value <= self.ceiling else BREACH,
            burn_rate=round(burn, 4),
            value=value,
        )
        return row


class StalenessObjective(_Objective):
    """A unix-timestamp gauge must be at most ``max_age_s`` old."""

    def __init__(self, name: str, gauge: str, max_age_s: float,
                 labels: Optional[dict] = None):
        super().__init__(name)
        if max_age_s <= 0:
            raise ValueError(f"max_age_s must be positive, got {max_age_s}")
        self.gauge = gauge
        self.max_age_s = float(max_age_s)
        self.labels = dict(labels or {})

    def evaluate(self, registry: MetricsRegistry, now_s: float) -> Dict:
        metric = registry._metrics.get(self.gauge)
        row = {"objective": "staleness", "gauge": self.gauge,
               "max_age_s": self.max_age_s}
        if metric is None or not metric.has(**self.labels):
            row.update(status=NO_DATA, burn_rate=0.0)
            return row
        age = max(now_s - metric.value(**self.labels), 0.0)
        burn = age / self.max_age_s
        row.update(
            status=BREACH if age > self.max_age_s else OK,
            burn_rate=round(burn, 4),
            age_s=round(age, 3),
        )
        return row


class FreshnessObjective(_Objective):
    """Served predictions must not lag ingested data by more than
    ``max_lag_s`` of **event time** — the streaming pipeline's end-to-end
    SLO.

    Reads a watermark gauge *pair*: ``ingest_gauge`` (event time of the
    newest ingested batch — ``svgd_stream_watermark``) and
    ``served_gauge`` (event-time watermark of the generation actually
    serving — ``svgd_serving_watermark``, stamped by the hot reloader).
    The lag is ``max(ingest − served, 0)``: a served watermark at or
    ahead of ingest (a replayed stream, an idle source) is perfectly
    fresh, exactly like :class:`StalenessObjective`'s backwards-clock
    clamp.  Either gauge never set → ``no_data`` (a pipeline that has not
    published yet is not breaching)."""

    def __init__(self, name: str, max_lag_s: float, *,
                 ingest_gauge: str = "svgd_stream_watermark",
                 served_gauge: str = "svgd_serving_watermark",
                 labels: Optional[dict] = None):
        super().__init__(name)
        if max_lag_s <= 0:
            raise ValueError(f"max_lag_s must be positive, got {max_lag_s}")
        self.max_lag_s = float(max_lag_s)
        self.ingest_gauge = ingest_gauge
        self.served_gauge = served_gauge
        self.labels = dict(labels or {})

    def evaluate(self, registry: MetricsRegistry, now_s: float) -> Dict:
        ingest = registry._metrics.get(self.ingest_gauge)
        served = registry._metrics.get(self.served_gauge)
        row = {"objective": "freshness", "ingest_gauge": self.ingest_gauge,
               "served_gauge": self.served_gauge,
               "max_lag_s": self.max_lag_s}
        # the served watermark may carry tenant labels while the ingest
        # side is unlabelled (single trainer, many tenants) — each gauge
        # is judged under its own label set
        if (ingest is None or not ingest.has()
                or served is None or not served.has(**self.labels)):
            row.update(status=NO_DATA, burn_rate=0.0)
            return row
        lag = max(ingest.value() - served.value(**self.labels), 0.0)
        burn = lag / self.max_lag_s
        row.update(
            status=BREACH if lag > self.max_lag_s else OK,
            burn_rate=round(burn, 4),
            lag_s=round(lag, 3),
        )
        return row


class SloEngine:
    """Evaluates a fixed objective list against one registry.

    Each :meth:`evaluate` call advances every objective's window (the
    delta since the previous call; cumulative on the first) and returns::

        {"status": "ok"|"breach", "ts": <unix>,
         "objectives": {name: {status, burn_rate, ...}, ...}}

    ``no_data`` objectives never breach the overall status (a fresh server
    with zero traffic is healthy, not failing).  Verdicts are mirrored
    into the registry: ``svgd_slo_burn_rate{slo=name}`` gauges and
    ``svgd_slo_breaches_total{slo=name}`` counters.

    ``mirror_metrics=False`` evaluates without writing the
    verdict series — for a SECOND engine over the same registry (the
    autoscale controller runs its own objective windows at its own
    cadence) whose verdicts must not clobber the ``/slo`` endpoint's
    gauges or double-count its breach counters.  :attr:`last` keeps the
    most recent evaluation document and :meth:`burn_rates` exposes its
    per-objective burn numbers — the controller-facing accessors.
    """

    def __init__(self, registry: Optional[MetricsRegistry] = None,
                 objectives: Sequence[_Objective] = (),
                 clock: Callable[[], float] = time.time,
                 mirror_metrics: bool = True):
        import threading

        self.registry = (registry if registry is not None
                         else _metrics.default_registry())
        self.objectives = list(objectives)
        names = [o.name for o in self.objectives]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate objective names: {names}")
        self._clock = clock
        self.mirror_metrics = bool(mirror_metrics)
        #: The most recent :meth:`evaluate` document (None before the
        #: first) — readable without advancing any objective window.
        self.last: Optional[Dict] = None
        # the objectives' window snapshots are stateful: concurrent
        # evaluations (two scrapers on /slo — ThreadingHTTPServer runs one
        # thread per request) would double-judge one window and starve the
        # next; one engine lock serialises them
        self._lock = threading.Lock()
        if self.mirror_metrics:
            self._m_burn = self.registry.gauge(
                "svgd_slo_burn_rate", "error-budget burn rate per objective")
            self._m_breaches = self.registry.counter(
                "svgd_slo_breaches_total", "SLO evaluations that breached")

    def evaluate(self) -> Dict:
        with self._lock:
            now = self._clock()
            rows = {}
            worst = OK
            for obj in self.objectives:
                row = obj.evaluate(self.registry, now)
                rows[obj.name] = row
                burn = row.get("burn_rate", 0.0)
                if (self.mirror_metrics
                        and isinstance(burn, (int, float))
                        and burn != float("inf")):
                    self._m_burn.set(burn, slo=obj.name)
                if row["status"] == BREACH:
                    worst = BREACH
                    if self.mirror_metrics:
                        self._m_breaches.inc(slo=obj.name)
            doc = {"status": worst, "ts": round(now, 3), "objectives": rows}
            self.last = doc
        return doc

    def burn_rates(self) -> Dict[str, Optional[float]]:
        """Per-objective burn rates of the most recent evaluation (empty
        before the first) — ``None`` marks an unbounded ratio (bad events
        over a zero base), which callers must treat as the worst case,
        not as zero."""
        if self.last is None:
            return {}
        return {name: row.get("burn_rate")
                for name, row in self.last["objectives"].items()}


def default_serving_slos(registry: MetricsRegistry, *,
                         p99_ms: float = 100.0,
                         shed_budget: float = 0.01,
                         error_budget: float = 0.01,
                         aggregate: bool = False,
                         mirror_metrics: bool = True,
                         clock: Callable[[], float] = time.time) -> SloEngine:
    """The serving server's standard objective set: request p99 under
    ``p99_ms``, sheds under ``shed_budget`` per resolved request, and
    dispatch errors under ``error_budget`` per batch.

    ``aggregate=True`` judges every objective over the **sum across label
    sets** (minus the ``replica`` federation identity) — how the fleet
    router evaluates the same objectives over its federated window, where
    all traffic lives in tenant-labelled rollup series."""
    return SloEngine(registry, [
        LatencyObjective("serve_p99", "svgd_serve_request_latency_seconds",
                         p99_ms / 1e3, target=0.99, aggregate=aggregate),
        RatioObjective("shed_rate", "svgd_serve_shed_total",
                       "svgd_serve_requests_total", shed_budget,
                       aggregate=aggregate),
        RatioObjective("dispatch_errors", "svgd_serve_dispatch_errors_total",
                       "svgd_serve_batches_total", error_budget,
                       aggregate=aggregate),
    ], clock=clock, mirror_metrics=mirror_metrics)


def default_training_slos(registry: MetricsRegistry, *,
                          max_ksd: Optional[float] = None,
                          guard_trip_budget: float = 0.1,
                          diag_max_age_s: Optional[float] = None,
                          clock: Callable[[], float] = time.time) -> SloEngine:
    """The supervised-training objective set: guard trips under
    ``guard_trip_budget`` per segment, optionally a KSD ceiling (the
    posterior-convergence SLO) and a diagnostics-freshness bound."""
    objectives: List[_Objective] = [
        RatioObjective("guard_trip_rate", "svgd_train_guard_trips_total",
                       "svgd_train_segment_seconds", guard_trip_budget),
    ]
    if max_ksd is not None:
        objectives.append(GaugeCeiling("ksd_ceiling", "svgd_diag_ksd", max_ksd))
    if diag_max_age_s is not None:
        objectives.append(StalenessObjective(
            "diag_freshness", "svgd_diag_last_update_ts", diag_max_age_s))
    return SloEngine(registry, objectives, clock=clock)


def default_streaming_slos(registry: MetricsRegistry, *,
                           max_lag_s: float = 60.0,
                           drop_budget: float = 0.0,
                           labels: Optional[dict] = None,
                           mirror_metrics: bool = True,
                           clock: Callable[[], float] = time.time) -> SloEngine:
    """The streaming pipeline's objective set: served predictions within
    ``max_lag_s`` of ingested event time (:class:`FreshnessObjective` over
    the watermark gauge pair), and stream drops within ``drop_budget`` per
    pulled batch (the default budget is ZERO — a dropped batch is lost
    data, the freshness gate's unconditional-FAIL condition)."""
    return SloEngine(registry, [
        FreshnessObjective("freshness", max_lag_s, labels=labels),
        RatioObjective("stream_drop_rate", "svgd_stream_dropped_total",
                       "svgd_stream_batches_total", drop_budget),
    ], clock=clock, mirror_metrics=mirror_metrics)


def default_rollout_slos(registry: MetricsRegistry, *,
                         p99_ms: float = 100.0,
                         error_budget: float = 0.01,
                         max_divergence: float = 0.05,
                         divergence_budget: float = 0.01,
                         labels: Optional[dict] = None,
                         mirror_metrics: bool = True,
                         clock: Callable[[], float] = time.time) -> SloEngine:
    """The progressive-delivery judge: the candidate generation's OWN
    serve windows plus the shadow-divergence window.

    The candidate objectives read the ``generation="candidate"`` label
    set of the standard serve series — the batcher stamps candidate-split
    batches with that label, so the incumbent's traffic never dilutes the
    candidate's verdict (and vice versa).  Divergence reuses
    :class:`LatencyObjective` verbatim: ``svgd_rollout_divergence`` is a
    histogram over prediction-space distances instead of seconds, and
    "``target`` fraction of observations at or under ``threshold``" is
    exactly the divergence-budget judgement (a NaN-predicting candidate
    lands in the overflow bucket, over every finite threshold).  All
    three objectives are ``no_data``-safe: an empty window holds the
    rollout in its current stage rather than promoting or rolling back.
    """
    base = dict(labels or {})
    cand = {**base, "generation": "candidate"}
    return SloEngine(registry, [
        LatencyObjective("candidate_p99", "svgd_serve_request_latency_seconds",
                         p99_ms / 1e3, target=0.99, labels=cand),
        RatioObjective("candidate_errors", "svgd_serve_dispatch_errors_total",
                       "svgd_serve_batches_total", error_budget, labels=cand),
        LatencyObjective("shadow_divergence", "svgd_rollout_divergence",
                         max_divergence, target=1.0 - divergence_budget,
                         labels=base),
    ], clock=clock, mirror_metrics=mirror_metrics)
