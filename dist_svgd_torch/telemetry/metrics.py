"""Thread-safe metrics registry: counters, gauges, histograms.

Counterpart of ``dist_svgd_tpu/telemetry/metrics.py``, kept as the port's
own copy (that module imports no JAX, but the port imports nothing of the
JAX package): the same classes, the same Prometheus text and the same
dump / ingest / delta documents on the same call sequence.

- **Counter** — monotonically increasing totals (steps, restarts, probes);
- **Gauge** — last-write-wins instantaneous values (the ``svgd_diag_*``
  posterior-health statistics, queue depth);
- **Histogram** — fixed **log-spaced** latency buckets (powers of two from
  0.1 ms to ~26 s — :data:`LATENCY_BUCKETS_S`), cumulative-bucket semantics,
  with quantile estimates by linear interpolation inside the crossing bucket
  (the standard Prometheus ``histogram_quantile`` estimate);

all label-aware (``counter.inc(route="/predict", status=200)``), all guarded
by ONE registry lock; the exposition path snapshots under the lock and
formats outside it.

**Label-cardinality guard**: every metric bounds its distinct label sets
(``max_label_sets``, default :data:`DEFAULT_MAX_LABEL_SETS`, configurable
per registry and per metric); once the bound is reached, *new* label sets
aggregate into a reserved rollup series whose label values are all
:data:`OTHER_LABEL_VALUE` (``{tenant="other"}``) with a one-time
``RuntimeWarning`` per metric.  Already-admitted series keep updating —
the guard caps growth, it never drops data.

Exposition is Prometheus text format 0.0.4 (:meth:`MetricsRegistry.
exposition`) plus a JSON-friendly :meth:`~MetricsRegistry.snapshot`.  A
process-wide default registry (:func:`default_registry`) is what
instrumented components write to when not handed an explicit one; tests
that need isolation construct their own ``MetricsRegistry()``.
"""

from __future__ import annotations

import math
import re
import threading
import warnings
from typing import Dict, Iterable, Optional, Tuple

__all__ = [
    "DEFAULT_MAX_LABEL_SETS",
    "DUMP_FORMAT",
    "LATENCY_BUCKETS_S",
    "OTHER_LABEL_VALUE",
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "combined_exposition",
    "default_registry",
    "dump_delta",
]

#: Wire-format tag of :meth:`MetricsRegistry.dump` (the full-fidelity
#: snapshot the fleet federation scrapes at ``/metrics.dump``).
DUMP_FORMAT = "svgd-metrics-dump-1"

#: Default per-metric bound on distinct label sets — generous for the
#: repo's own labels (tenants × lanes × routes stay well under it) while
#: capping a genuine cardinality leak at a fixed exposition size.
DEFAULT_MAX_LABEL_SETS = 128

#: Reserved label value the overflow rollup series carries for every label
#: name of the set that overflowed (``{tenant="other"}``).
OTHER_LABEL_VALUE = "other"

#: Fixed log-spaced latency buckets (seconds): powers of two from 0.1 ms up
#: to ~26 s, 19 buckets.  One shared lattice for every latency histogram so
#: cross-metric quantiles are comparable and exposition size is bounded.
LATENCY_BUCKETS_S: Tuple[float, ...] = tuple(
    1e-4 * 2.0 ** i for i in range(19)
)

_LabelKey = Tuple[Tuple[str, str], ...]


def _label_key(labels: dict) -> _LabelKey:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


def _escape_label(value: str) -> str:
    """Label-value escaping per the text exposition format 0.0.4:
    backslash, double-quote, and line feed — in that order, so an
    already-escaped sequence is never double-mangled."""
    return value.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _escape_help(value: str) -> str:
    """HELP-text escaping: only backslash and line feed — the format
    leaves double quotes literal in HELP lines (they are not quoted), so
    escaping them there corrupts the docstring a scraper shows."""
    return value.replace("\\", "\\\\").replace("\n", "\\n")


def _format_labels(key: _LabelKey, extra: Tuple[Tuple[str, str], ...] = ()) -> str:
    items = key + extra
    if not items:
        return ""
    body = ",".join(f'{k}="{_escape_label(v)}"' for k, v in items)
    return "{" + body + "}"


def _format_value(v: float) -> str:
    if v == math.inf:
        return "+Inf"
    if v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


class _Metric:
    """Shared name/help/lock plumbing.  Subclasses store per-label-set state
    in ``_series`` and render themselves into exposition lines."""

    kind = "untyped"

    def __init__(self, name: str, help: str, lock: threading.Lock,
                 max_label_sets: int = DEFAULT_MAX_LABEL_SETS):
        if max_label_sets < 1:
            raise ValueError(
                f"metric {name!r} needs max_label_sets >= 1, "
                f"got {max_label_sets}"
            )
        self.name = name
        self.help = help
        self.max_label_sets = int(max_label_sets)
        self._lock = lock
        self._series: Dict[_LabelKey, object] = {}
        self._overflowed = False

    def _admit(self, key: _LabelKey) -> Tuple[_LabelKey, bool]:
        """Cardinality guard (call under the lock): an already-known label
        set or one under the bound is admitted as-is; a NEW set past the
        bound maps to the reserved rollup key (same label names, every
        value :data:`OTHER_LABEL_VALUE`).  Returns ``(key, warn)`` where
        ``warn`` is True exactly once per metric — the caller emits the
        warning after releasing the lock."""
        if key in self._series or len(self._series) < self.max_label_sets:
            return key, False
        rollup = tuple((k, OTHER_LABEL_VALUE) for k, _ in key)
        warn = not self._overflowed
        self._overflowed = True
        return rollup, warn

    def _warn_overflow(self) -> None:
        warnings.warn(
            f"metric {self.name!r} exceeded max_label_sets="
            f"{self.max_label_sets}: further new label sets aggregate into "
            f'the reserved {{...="{OTHER_LABEL_VALUE}"}} rollup series',
            RuntimeWarning,
            stacklevel=3,
        )

    def _header(self) -> list:
        lines = []
        if self.help:
            lines.append(f"# HELP {self.name} {_escape_help(self.help)}")
        lines.append(f"# TYPE {self.name} {self.kind}")
        return lines

    def has(self, **labels) -> bool:
        """True once this label set has been written (distinguishes a
        never-set gauge from one legitimately at 0 — the SLO engine's
        ``no_data`` vs ``ok``)."""
        with self._lock:
            return _label_key(labels) in self._series

    def label_sets(self) -> list:
        """Every written label set, as dicts — the introspection surface
        federation/status tooling enumerates series with (pair it with
        ``value(**labels)`` / ``summary(**labels)``)."""
        with self._lock:
            return [dict(k) for k in self._series]


class Counter(_Metric):
    """Monotonic total.  ``inc(amount=1, **labels)``."""

    kind = "counter"

    def inc(self, amount: float = 1, **labels) -> None:
        if amount < 0:
            raise ValueError(f"counter {self.name} cannot decrease ({amount})")
        with self._lock:
            key, warn = self._admit(_label_key(labels))
            self._series[key] = self._series.get(key, 0) + amount
        if warn:
            self._warn_overflow()

    def value(self, **labels) -> float:
        with self._lock:
            return float(self._series.get(_label_key(labels), 0))

    def _render(self) -> list:
        with self._lock:
            series = dict(self._series)
        lines = self._header()
        for key in sorted(series):
            lines.append(
                f"{self.name}{_format_labels(key)} {_format_value(series[key])}"
            )
        if not series:
            lines.append(f"{self.name} 0")
        return lines


class Gauge(_Metric):
    """Instantaneous value.  ``set(v, **labels)`` / ``inc`` / ``dec``."""

    kind = "gauge"

    def set(self, value: float, **labels) -> None:
        with self._lock:
            key, warn = self._admit(_label_key(labels))
            self._series[key] = float(value)
        if warn:
            self._warn_overflow()

    def inc(self, amount: float = 1, **labels) -> None:
        with self._lock:
            key, warn = self._admit(_label_key(labels))
            self._series[key] = self._series.get(key, 0.0) + amount
        if warn:
            self._warn_overflow()

    def dec(self, amount: float = 1, **labels) -> None:
        self.inc(-amount, **labels)

    def value(self, **labels) -> float:
        with self._lock:
            return float(self._series.get(_label_key(labels), 0.0))

    def _render(self) -> list:
        with self._lock:
            series = dict(self._series)
        lines = self._header()
        for key in sorted(series):
            lines.append(
                f"{self.name}{_format_labels(key)} {_format_value(series[key])}"
            )
        if not series:
            lines.append(f"{self.name} 0")
        return lines


class _HistSeries:
    __slots__ = ("counts", "sum", "count")

    def __init__(self, n_buckets: int):
        self.counts = [0] * n_buckets  # per-bucket (non-cumulative) counts
        self.sum = 0.0
        self.count = 0


class Histogram(_Metric):
    """Fixed-bucket histogram.  ``observe(value, **labels)``; quantiles by
    interpolation inside the crossing bucket (:meth:`quantile`)."""

    kind = "histogram"

    def __init__(self, name: str, help: str, lock: threading.Lock,
                 buckets: Optional[Iterable[float]] = None,
                 max_label_sets: int = DEFAULT_MAX_LABEL_SETS):
        super().__init__(name, help, lock, max_label_sets=max_label_sets)
        bounds = tuple(buckets) if buckets is not None else LATENCY_BUCKETS_S
        if not bounds or any(b <= a for a, b in zip(bounds, bounds[1:])):
            raise ValueError(
                f"histogram {name} needs strictly increasing buckets, "
                f"got {bounds}"
            )
        self.buckets = bounds  # upper bounds; +Inf is implicit

    def observe(self, value: float, **labels) -> None:
        with self._lock:
            key, warn = self._admit(_label_key(labels))
            series = self._series.get(key)
            if series is None:
                series = self._series[key] = _HistSeries(len(self.buckets) + 1)
            i = 0
            for i, bound in enumerate(self.buckets):
                if value <= bound:
                    break
            else:
                i = len(self.buckets)  # overflow (+Inf) bucket
            series.counts[i] += 1
            series.sum += value
            series.count += 1
        if warn:
            self._warn_overflow()

    def merge_series(self, counts: Iterable[int], sum: float, count: int,
                     **labels) -> None:
        """Add one dumped series (raw per-bucket counts + sum + count) into
        this histogram — **exact** because every registry shares the same
        fixed bucket lattice; a mismatched bucket count raises (the
        federation surfaces it as a scrape error, never a silent skew)."""
        counts = list(counts)
        if len(counts) != len(self.buckets) + 1:
            raise ValueError(
                f"histogram {self.name}: cannot merge {len(counts)} bucket "
                f"counts into {len(self.buckets) + 1} buckets"
            )
        with self._lock:
            key, warn = self._admit(_label_key(labels))
            series = self._series.get(key)
            if series is None:
                series = self._series[key] = _HistSeries(len(self.buckets) + 1)
            for i, c in enumerate(counts):
                series.counts[i] += c
            series.sum += sum
            series.count += count
        if warn:
            self._warn_overflow()

    def _snapshot(self, labels: dict) -> Optional[_HistSeries]:
        with self._lock:
            series = self._series.get(_label_key(labels))
            if series is None:
                return None
            out = _HistSeries(len(series.counts))
            out.counts = list(series.counts)
            out.sum = series.sum
            out.count = series.count
            return out

    def quantile(self, q: float, **labels) -> float:
        """Estimated ``q``-quantile (seconds for latency histograms): find
        the bucket where the cumulative count crosses ``q·total``, linearly
        interpolate inside it.  0.0 with no observations; the last finite
        bound when the crossing lands in the overflow bucket."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile must be in [0, 1], got {q}")
        series = self._snapshot(labels)
        if series is None or series.count == 0:
            return 0.0
        rank = q * series.count
        cum = 0
        for i, c in enumerate(series.counts):
            prev_cum = cum
            cum += c
            if cum >= rank and c > 0:
                if i >= len(self.buckets):  # overflow bucket: no upper bound
                    return self.buckets[-1]
                lo = self.buckets[i - 1] if i > 0 else 0.0
                hi = self.buckets[i]
                frac = (rank - prev_cum) / c
                return lo + (hi - lo) * min(max(frac, 0.0), 1.0)
        return self.buckets[-1]

    def summary(self, scale: float = 1.0, **labels) -> dict:
        """``{count, sum, p50, p95, p99}`` (values × ``scale`` — pass 1e3
        for milliseconds) for one label set — the BENCH-row form."""
        series = self._snapshot(labels)
        count = series.count if series else 0
        return {
            "count": count,
            "sum": round((series.sum if series else 0.0) * scale, 4),
            "p50": round(self.quantile(0.50, **labels) * scale, 4),
            "p95": round(self.quantile(0.95, **labels) * scale, 4),
            "p99": round(self.quantile(0.99, **labels) * scale, 4),
        }

    def _render(self) -> list:
        with self._lock:
            series = {k: (list(s.counts), s.sum, s.count)
                      for k, s in self._series.items()}
        lines = self._header()
        for key in sorted(series):
            counts, total, count = series[key]
            cum = 0
            for bound, c in zip(self.buckets, counts):
                cum += c
                lines.append(
                    f"{self.name}_bucket"
                    f"{_format_labels(key, (('le', _format_value(bound)),))}"
                    f" {cum}"
                )
            lines.append(
                f"{self.name}_bucket{_format_labels(key, (('le', '+Inf'),))}"
                f" {count}"
            )
            lines.append(
                f"{self.name}_sum{_format_labels(key)} {_format_value(total)}"
            )
            lines.append(f"{self.name}_count{_format_labels(key)} {count}")
        if not series:
            lines.append(f"{self.name}_count 0")
        return lines


_NAME_OK = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")


class MetricsRegistry:
    """Get-or-create registry of named metrics with one shared lock.

    Re-requesting a name returns the existing metric (instrumented classes
    can be constructed many times per process — a second ``MicroBatcher``
    aggregates into the same counters, the Prometheus convention); asking
    for the same name as a different metric kind raises.

    ``max_label_sets`` is the registry-wide default cardinality bound per
    metric (see the module docstring); the per-metric ``max_label_sets=``
    on :meth:`counter`/:meth:`gauge`/:meth:`histogram` overrides it **at
    creation** — a later get-or-create of the same name returns the
    existing metric with its original bound.
    """

    def __init__(self, max_label_sets: int = DEFAULT_MAX_LABEL_SETS):
        if max_label_sets < 1:
            raise ValueError(
                f"max_label_sets must be >= 1, got {max_label_sets}"
            )
        self.max_label_sets = int(max_label_sets)
        self._lock = threading.Lock()
        self._metrics: Dict[str, _Metric] = {}

    def _get_or_create(self, cls, name: str, help: str,
                       max_label_sets: Optional[int] = None,
                       **kwargs) -> _Metric:
        if not _NAME_OK.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        bound = (self.max_label_sets if max_label_sets is None
                 else max_label_sets)
        with self._lock:
            metric = self._metrics.get(name)
            if metric is None:
                metric = self._metrics[name] = cls(name, help, self._lock,
                                                   max_label_sets=bound,
                                                   **kwargs)
            elif type(metric) is not cls:
                raise ValueError(
                    f"metric {name!r} already registered as "
                    f"{type(metric).__name__}, requested {cls.__name__}"
                )
            return metric

    def counter(self, name: str, help: str = "",
                max_label_sets: Optional[int] = None) -> Counter:
        return self._get_or_create(Counter, name, help,
                                   max_label_sets=max_label_sets)

    def gauge(self, name: str, help: str = "",
              max_label_sets: Optional[int] = None) -> Gauge:
        return self._get_or_create(Gauge, name, help,
                                   max_label_sets=max_label_sets)

    def histogram(self, name: str, help: str = "",
                  buckets: Optional[Iterable[float]] = None,
                  max_label_sets: Optional[int] = None) -> Histogram:
        return self._get_or_create(Histogram, name, help, buckets=buckets,
                                   max_label_sets=max_label_sets)

    def exposition(self) -> str:
        """Prometheus text format 0.0.4; one block per metric, names sorted
        (deterministic output — the golden test relies on it)."""
        with self._lock:
            metrics = [self._metrics[k] for k in sorted(self._metrics)]
        lines = []
        for metric in metrics:
            lines.extend(metric._render())
        return "\n".join(lines) + ("\n" if lines else "")

    def get(self, name: str) -> Optional[_Metric]:
        """The metric registered under ``name`` (None when absent) — the
        read-only peek the SLO engine and the fleet federation use."""
        with self._lock:
            return self._metrics.get(name)

    def dump(self) -> dict:
        """Full-fidelity JSON-safe snapshot — unlike :meth:`snapshot`,
        histograms keep their **raw per-bucket counts**, so two dumps from
        registries sharing the fixed bucket lattice merge *exactly*
        (:meth:`ingest`).  This is the fleet federation's wire format
        (served at ``/metrics.dump``)."""
        with self._lock:
            metrics = [self._metrics[k] for k in sorted(self._metrics)]
        out: dict = {"format": DUMP_FORMAT, "metrics": {}}
        for metric in metrics:
            entry: dict = {"kind": metric.kind, "help": metric.help}
            with metric._lock:
                if isinstance(metric, Histogram):
                    entry["buckets"] = list(metric.buckets)
                    entry["series"] = [
                        {"labels": dict(k), "counts": list(s.counts),
                         "sum": s.sum, "count": s.count}
                        for k, s in metric._series.items()
                    ]
                else:
                    entry["series"] = [{"labels": dict(k), "value": v}
                                       for k, v in metric._series.items()]
            out["metrics"][metric.name] = entry
        return out

    def ingest(self, dump: dict, labels: Optional[dict] = None,
               skip_gauges: bool = False) -> None:
        """Merge a :meth:`dump` document into this registry.

        Counters and histogram series **add** (repeated ingests accumulate
        — pass per-scrape *deltas* from :func:`dump_delta` for federation
        semantics); gauges **set** (last write wins — instantaneous values
        do not sum meaningfully, so a federation rollup passes
        ``skip_gauges=True`` on its unlabelled pass).  ``labels`` adds
        extra label pairs to every ingested series (the federation's
        ``replica=`` identity); they route through the cardinality guard
        like any other label set."""
        extra = dict(labels or {})
        for name, entry in dump.get("metrics", {}).items():
            kind = entry.get("kind")
            help_ = entry.get("help", "")
            series = entry.get("series", [])
            if kind == "counter":
                m = self.counter(name, help_)
                for s in series:
                    m.inc(s.get("value", 0) or 0,
                          **{**(s.get("labels") or {}), **extra})
            elif kind == "gauge":
                if skip_gauges:
                    continue
                m = self.gauge(name, help_)
                for s in series:
                    m.set(s.get("value", 0.0) or 0.0,
                          **{**(s.get("labels") or {}), **extra})
            elif kind == "histogram":
                m = self.histogram(name, help_, buckets=entry.get("buckets"))
                dumped = entry.get("buckets")
                if dumped is not None and tuple(dumped) != tuple(m.buckets):
                    # get-or-create returned an EXISTING histogram whose
                    # lattice the buckets= argument cannot change: merging
                    # same-length-but-different-boundary lattices would
                    # silently skew every quantile — refuse instead (the
                    # federation surfaces it as a scrape error)
                    raise ValueError(
                        f"histogram {name!r}: dump buckets {dumped} do not "
                        f"match this registry's lattice {list(m.buckets)}")
                for s in series:
                    m.merge_series(s.get("counts", []),
                                   s.get("sum", 0.0) or 0.0,
                                   s.get("count", 0) or 0,
                                   **{**(s.get("labels") or {}), **extra})
            else:
                raise ValueError(
                    f"dump entry {name!r} has unknown kind {kind!r}")

    def snapshot(self) -> dict:
        """JSON-friendly dump: counters/gauges as scalars (labelled series
        keyed ``name{k="v"}``), histograms as their ms-scaled summaries."""
        with self._lock:
            metrics = dict(self._metrics)
        out = {}
        for name, metric in sorted(metrics.items()):
            if isinstance(metric, Histogram):
                with metric._lock:
                    keys = list(metric._series)
                for key in keys:
                    label = name + _format_labels(key)
                    out[label] = metric.summary(scale=1e3, **dict(key))
            else:
                with metric._lock:
                    series = dict(metric._series)
                for key, value in series.items():
                    out[name + _format_labels(key)] = value
        return out


def _series_by_labels(entry: dict) -> Dict[_LabelKey, dict]:
    return {_label_key(s.get("labels") or {}): s
            for s in entry.get("series", [])}


def dump_delta(prev: Optional[dict], cur: dict) -> dict:
    """The per-series window delta between two :meth:`MetricsRegistry.dump`
    documents of ONE source registry — what a federation ingests per
    scrape.

    Counters and histograms yield **non-negative deltas**: a series whose
    total went *down* means the source process restarted (counters reset
    to zero), and the delta **clamps to zero** — the same window-reset
    discipline ``telemetry/slo.py`` applies (``max(now - before, 0)``), so
    federated rates dip to zero across a restart instead of going
    negative.  Gauges pass through current values unchanged (last write
    wins at ingest).  ``prev=None`` (the first scrape) yields ``cur``
    whole — cumulative-since-start, the first-window convention."""
    if prev is None:
        return cur
    out: dict = {"format": cur.get("format", DUMP_FORMAT), "metrics": {}}
    prev_metrics = prev.get("metrics", {})
    for name, entry in cur.get("metrics", {}).items():
        kind = entry.get("kind")
        pentry = prev_metrics.get(name)
        if kind == "gauge" or pentry is None or pentry.get("kind") != kind:
            out["metrics"][name] = entry
            continue
        prev_series = _series_by_labels(pentry)
        new_series = []
        for s in entry.get("series", []):
            p = prev_series.get(_label_key(s.get("labels") or {}))
            if kind == "counter":
                base = (p.get("value", 0) or 0) if p else 0
                delta = max((s.get("value", 0) or 0) - base, 0)
                new_series.append({"labels": s.get("labels") or {},
                                   "value": delta})
            else:  # histogram
                cur_counts = list(s.get("counts", []))
                cur_count = s.get("count", 0) or 0
                if p is None:
                    new_series.append(dict(s))
                    continue
                prev_counts = list(p.get("counts", []))
                if len(prev_counts) != len(cur_counts):
                    new_series.append(dict(s))
                    continue
                if (cur_count < (p.get("count", 0) or 0)
                        or any(c < q for c, q in zip(cur_counts,
                                                     prev_counts))):
                    # whole-series reset: ANY decrease — total count OR a
                    # single bucket — clamps the entire window to zero.
                    # (A restart masked by growth can keep the total count
                    # rising while individual buckets shrink; per-bucket
                    # clamping there would emit a delta whose bucket sum
                    # disagrees with its count — an inconsistent
                    # histogram skewing every federated quantile.)
                    new_series.append({"labels": s.get("labels") or {},
                                       "counts": [0] * len(cur_counts),
                                       "sum": 0.0, "count": 0})
                    continue
                new_series.append({
                    "labels": s.get("labels") or {},
                    "counts": [c - q
                               for c, q in zip(cur_counts, prev_counts)],
                    "sum": max((s.get("sum", 0.0) or 0.0)
                               - (p.get("sum", 0.0) or 0.0), 0.0),
                    "count": cur_count - (p.get("count", 0) or 0),
                })
        delta_entry = {"kind": kind, "help": entry.get("help", ""),
                       "series": new_series}
        if kind == "histogram" and "buckets" in entry:
            delta_entry["buckets"] = entry["buckets"]
        out["metrics"][name] = delta_entry
    return out


def combined_exposition(*registries: MetricsRegistry) -> str:
    """One Prometheus text document over several registries (the fleet
    router's ``/metrics``: its own series + the federated fleet view).

    A metric name appearing in several registries renders as ONE block
    (two blocks under one name would be a malformed exposition): the
    earlier registry contributes its header and samples, later registries
    **append the series the block doesn't already carry** — so a name both
    processes emit (a router that traces has its own
    ``svgd_trace_dropped_total`` while the federation holds the replicas'
    ``{replica=...}`` series of the same name) keeps every distinct
    series visible instead of dropping the federated view wholesale.  On
    an identical series identity the earlier registry wins (the router's
    unlabelled series means *this process*; a same-name unlabelled rollup
    from elsewhere is ambiguous and defers).  A later registry whose
    metric has a different *kind* under the name is skipped entirely."""
    blocks: Dict[str, dict] = {}
    order: list = []
    for reg in registries:
        with reg._lock:
            metrics = [reg._metrics[k] for k in sorted(reg._metrics)]
        for metric in metrics:
            rendered = metric._render()
            headers = [ln for ln in rendered if ln.startswith("# ")]
            samples = [ln for ln in rendered if not ln.startswith("# ")]
            block = blocks.get(metric.name)
            if block is None:
                blocks[metric.name] = {
                    "kind": metric.kind, "headers": headers,
                    "samples": list(samples),
                    "series": {ln.rsplit(" ", 1)[0] for ln in samples},
                }
                order.append(metric.name)
                continue
            if block["kind"] != metric.kind:
                continue
            for ln in samples:
                sid = ln.rsplit(" ", 1)[0]
                if sid not in block["series"]:
                    block["series"].add(sid)
                    block["samples"].append(ln)
    lines: list = []
    for name in order:
        block = blocks[name]
        lines.extend(block["headers"])
        lines.extend(block["samples"])
    return "\n".join(lines) + ("\n" if lines else "")


_DEFAULT = MetricsRegistry()


def default_registry() -> MetricsRegistry:
    """The process-wide registry instrumented components default to."""
    return _DEFAULT
