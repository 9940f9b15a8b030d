"""Telemetry history: a bounded on-disk ring of metrics snapshots.

Counterpart of ``dist_svgd_tpu/telemetry/history.py``, kept as the port's
own copy: the same record format string, so a ring either package writes
is read by the other, record for record.

In-process metrics answer "what is happening now"; drill rows answer
"what did a hand-run drill measure".  Nothing answered "when did this
series start drifting?" — the history layer does.  A
:class:`HistoryRecorder` periodically dumps a
:class:`~dist_svgd_torch.telemetry.metrics.MetricsRegistry` and writes
**window deltas** (via :func:`~dist_svgd_torch.telemetry.metrics.
dump_delta`, inheriting its counter reset-clamp: a restarted process
yields a zero window, never a negative one) into a
:class:`TelemetryHistory` — a directory ring of
``telemetry_<seq>.json`` records, oldest pruned past ``capacity`` so a
long-running server cannot grow the directory without bound.

Each record is self-describing::

    {"format": "svgd-telemetry-history-1", "seq": 42, "ts": <clock>,
     "interval_s": <seconds since previous record, 0.0 for the first>,
     "window": <dump_delta document>}

The first record's window is cumulative-since-start (``dump_delta``'s
``prev=None`` convention) with ``interval_s == 0.0`` — rate consumers
skip it.

The recorder is clock-injectable and has **no background thread**:
callers own the cadence (a serving loop calls :meth:`HistoryRecorder.
maybe_record` wherever it already ticks; drills and tests call
:meth:`~HistoryRecorder.record_once` at exact simulated times), which
is what keeps ``tools/anomaly_report.py``'s verdicts deterministic on
fixture histories.
"""

from __future__ import annotations

import json
import os
import re
import time
from typing import Callable, Dict, List, Optional, Tuple

__all__ = [
    "HISTORY_FORMAT",
    "TelemetryHistory",
    "HistoryRecorder",
    "series_values",
    "list_series",
]

HISTORY_FORMAT = "svgd-telemetry-history-1"

_RECORD_RE = re.compile(r"^telemetry_(\d{8})\.json$")


class TelemetryHistory:
    """The directory ring.  ``capacity`` bounds the number of records on
    disk; sequence numbers keep increasing across prunes (and across
    process restarts — the ring re-seats itself on the existing files)."""

    def __init__(self, root: str, capacity: int = 512):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.root = root
        self.capacity = capacity
        os.makedirs(root, exist_ok=True)
        seqs = self._seqs()
        self._next_seq = (seqs[-1] + 1) if seqs else 0

    # ------------------------------------------------------------ #

    def _seqs(self) -> List[int]:
        out = []
        for name in os.listdir(self.root):
            m = _RECORD_RE.match(name)
            if m:
                out.append(int(m.group(1)))
        return sorted(out)

    def _path(self, seq: int) -> str:
        return os.path.join(self.root, f"telemetry_{seq:08d}.json")

    def append(self, record: dict) -> str:
        """Write one record (assigning it the next sequence number) and
        prune the oldest past capacity.  Returns the written path."""
        seq = self._next_seq
        self._next_seq += 1
        record = {**record, "seq": seq}
        path = self._path(seq)
        tmp = path + ".tmp"
        with open(tmp, "w") as fh:
            json.dump(record, fh)
        os.replace(tmp, path)  # readers never see a torn record
        seqs = self._seqs()
        for old in seqs[: max(0, len(seqs) - self.capacity)]:
            try:
                os.remove(self._path(old))
            except OSError:
                pass
        return path

    def paths(self) -> List[str]:
        return [self._path(s) for s in self._seqs()]

    def records(self) -> List[dict]:
        """All records, oldest first (unreadable files skipped)."""
        out = []
        for path in self.paths():
            try:
                with open(path) as fh:
                    out.append(json.load(fh))
            except (OSError, ValueError):
                continue
        return out

    def __len__(self) -> int:
        return len(self._seqs())


class HistoryRecorder:
    """Periodic window snapshots of one registry into one history ring.

    Args:
        registry: the :class:`MetricsRegistry` to snapshot.
        history: the :class:`TelemetryHistory` (or a directory path).
        interval_s: cadence honoured by :meth:`maybe_record`.
        clock: injectable wall clock (records carry its timestamps).
    """

    def __init__(self, registry, history, interval_s: float = 60.0,
                 clock: Callable[[], float] = time.time):
        if isinstance(history, str):
            history = TelemetryHistory(history)
        self.registry = registry
        self.history = history
        self.interval_s = float(interval_s)
        self._clock = clock
        self._prev: Optional[dict] = None
        self._last_ts: Optional[float] = None

    def record_once(self, now: Optional[float] = None) -> dict:
        """Snapshot unconditionally: dump, delta against the previous
        dump (reset-clamped), append to the ring."""
        from dist_svgd_torch.telemetry.metrics import dump_delta

        now = self._clock() if now is None else now
        cur = self.registry.dump()
        window = dump_delta(self._prev, cur)
        interval = (now - self._last_ts) if self._last_ts is not None else 0.0
        self._prev = cur
        self._last_ts = now
        record = {
            "format": HISTORY_FORMAT,
            "ts": now,
            "interval_s": max(float(interval), 0.0),
            "window": window,
        }
        self.history.append(record)
        return record

    def maybe_record(self, now: Optional[float] = None) -> Optional[dict]:
        """Snapshot iff a full interval elapsed since the last record —
        the call a serving loop drops wherever it already ticks."""
        now = self._clock() if now is None else now
        if self._last_ts is not None and (now - self._last_ts) < self.interval_s:
            return None
        return self.record_once(now=now)


# ------------------------------------------------------------------ #
# series extraction (the anomaly report's read path)
# ------------------------------------------------------------------ #


def _match(series: List[dict], labels: Optional[dict]) -> Optional[dict]:
    want = dict(labels or {})
    for s in series:
        if dict(s.get("labels") or {}) == want:
            return s
    return None


def list_series(records: List[dict]) -> List[Tuple[str, str, Dict[str, str]]]:
    """Every ``(metric, kind, labels)`` series appearing anywhere in the
    history, deterministically ordered — the anomaly report's scan set."""
    seen = {}
    for rec in records:
        for name, entry in (rec.get("window", {}).get("metrics", {})).items():
            kind = entry.get("kind", "")
            for s in entry.get("series", []):
                labels = dict(s.get("labels") or {})
                key = (name, kind, tuple(sorted(labels.items())))
                seen.setdefault(key, (name, kind, labels))
    return [seen[k] for k in sorted(seen, key=lambda k: (k[0], k[1], k[2]))]


def series_values(records: List[dict], metric: str,
                  labels: Optional[dict] = None,
                  stat: Optional[str] = None) -> List[Optional[float]]:
    """One value per record for ``metric`` / ``labels`` (``None`` where
    the record lacks the series).

    stat: for counters/gauges only ``"value"`` (the window delta /
    instantaneous value).  For histograms: ``"count"``, ``"sum"``,
    ``"mean"``, or a quantile ``"p50"``/``"p95"``/``"p99"`` computed from
    the window's raw bucket counts via a scratch registry (the exact
    interpolation live quantiles use).
    """
    out: List[Optional[float]] = []
    for rec in records:
        entry = rec.get("window", {}).get("metrics", {}).get(metric)
        if entry is None:
            out.append(None)
            continue
        kind = entry.get("kind")
        s = _match(entry.get("series", []), labels)
        if s is None:
            out.append(None)
            continue
        if kind in ("counter", "gauge"):
            out.append(float(s.get("value", 0.0) or 0.0))
            continue
        # histogram window
        want = stat or "mean"
        count = int(s.get("count", 0) or 0)
        total = float(s.get("sum", 0.0) or 0.0)
        if want == "count":
            out.append(float(count))
        elif want == "sum":
            out.append(total)
        elif want == "mean":
            out.append(total / count if count else None)
        elif want.startswith("p"):
            if not count:
                out.append(None)
                continue
            from dist_svgd_torch.telemetry import metrics as _metrics

            scratch = _metrics.MetricsRegistry()
            h = scratch.histogram(metric, entry.get("help", ""),
                                  buckets=entry.get("buckets"))
            h.merge_series(s.get("counts", []), total, count)
            out.append(float(h.quantile(float(want[1:]) / 100.0)))
        else:
            raise ValueError(f"unknown histogram stat {want!r}")
    return out
