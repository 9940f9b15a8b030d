"""Change-point anomaly report over a telemetry history ring.

Counterpart of ``tools/anomaly_report.py`` (the same detector, the same
report keys and the same exit codes), over the port's
:mod:`~dist_svgd_torch.telemetry.history` reader — which reads a ring
either package wrote.

Reads the ``telemetry_<seq>.json`` records a
:class:`~dist_svgd_torch.telemetry.history.HistoryRecorder` wrote (window
deltas of one metrics registry) and scans every recorded series for a
**step change**, using a robust noise model: median + MAD (median absolute
deviation), not mean + stddev, so a single outlier window neither
triggers nor masks a verdict.

Detection, per series: for every candidate split point ``t`` (leaving at
least ``--min-segment`` windows on each side), compare the medians of
the left and right segments.  A split is anomalous when::

    |median_right - median_left| > max(k * MAD_left,
                                       rel_floor * |median_left|,
                                       abs_floor)

i.e. the level shift must clear both the observed noise of the
*baseline* segment (``k`` MADs, default 6: an unattended report should
page on step changes, not tail noise) and a relative floor (a perfectly
quiet series has MAD 0; without the floor any epsilon would flag).  The
reported split is the one with the highest ratio of shift to threshold.
Everything is rank/median arithmetic on recorded values — **verdicts on
a fixed history are deterministic**, which is what lets the fixture
tests pin "flags the injected step, silent on clean".

Series values per window: counters and gauges use the recorded value
(counters are window deltas — pass ``--rate`` to normalise by each
record's ``interval_s``, skipping the first cumulative record);
histograms use the per-window mean by default (``--stat p99`` etc. for
quantiles reconstructed from the raw bucket counts).  Plain Python: it
runs the same on the CPU and on the card's host.

Usage::

    python -m dist_svgd_torch.tools.anomaly_report DIR              # scan everything
    python -m dist_svgd_torch.tools.anomaly_report DIR --json
    python -m dist_svgd_torch.tools.anomaly_report DIR \\
        --metric svgd_serve_request_latency_seconds --stat p99
    python -m dist_svgd_torch.tools.anomaly_report DIR --rate --k 8

Exit codes: 0 clean, 1 anomalies found, 2 unreadable input — shell-
gateable like the other tools.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Any, Dict, List, Optional

from dist_svgd_torch.telemetry.history import (
    TelemetryHistory,
    list_series,
    series_values,
)

#: Baseline-noise multiplier (MADs) a level shift must clear.
DEFAULT_K = 6.0
#: Relative floor: shifts under this fraction of the baseline median
#: never flag (guards the MAD=0 quiet-series case).
DEFAULT_REL_FLOOR = 0.25
#: Minimum windows on each side of a candidate split.
DEFAULT_MIN_SEGMENT = 4


def _median(vals: List[float]) -> float:
    s = sorted(vals)
    n = len(s)
    mid = n // 2
    return s[mid] if n % 2 else 0.5 * (s[mid - 1] + s[mid])


def _mad(vals: List[float], med: Optional[float] = None) -> float:
    if med is None:
        med = _median(vals)
    return _median([abs(v - med) for v in vals])


def detect_step_change(values: List[float], *, k: float = DEFAULT_K,
                       min_segment: int = DEFAULT_MIN_SEGMENT,
                       rel_floor: float = DEFAULT_REL_FLOOR,
                       abs_floor: float = 0.0) -> Optional[Dict[str, Any]]:
    """Scan one series for its strongest step change; ``None`` when no
    split clears the threshold.  Deterministic in ``values``."""
    n = len(values)
    if n < 2 * min_segment:
        return None
    best: Optional[Dict[str, Any]] = None
    for t in range(min_segment, n - min_segment + 1):
        left, right = values[:t], values[t:]
        ml, mr = _median(left), _median(right)
        threshold = max(k * _mad(left, ml), rel_floor * abs(ml), abs_floor)
        if threshold <= 0.0:
            continue
        shift = abs(mr - ml)
        score = shift / threshold
        if score > 1.0 and (best is None or score > best["score"]):
            best = {
                "split_index": t,
                "median_before": ml,
                "median_after": mr,
                "shift": mr - ml,
                "threshold": threshold,
                "score": round(score, 3),
            }
    return best


def analyze_records(records: List[dict], *, metric: Optional[str] = None,
                    stat: Optional[str] = None, rate: bool = False,
                    k: float = DEFAULT_K,
                    min_segment: int = DEFAULT_MIN_SEGMENT,
                    rel_floor: float = DEFAULT_REL_FLOOR,
                    abs_floor: float = 0.0) -> Dict[str, Any]:
    """Run detection over every (or one ``metric``'s) recorded series.
    Returns ``{"windows": n, "series_scanned": n, "anomalies": [...]}``
    with anomalies sorted strongest first."""
    anomalies: List[Dict[str, Any]] = []
    scanned = 0
    for name, kind, labels in list_series(records):
        if metric is not None and name != metric:
            continue
        use_stat = stat if kind == "histogram" else None
        vals = series_values(records, name, labels=labels, stat=use_stat)
        series: List[float] = []
        for rec, v in zip(records, vals):
            if v is None:
                continue
            if rate and kind == "counter":
                interval = float(rec.get("interval_s", 0.0) or 0.0)
                if interval <= 0.0:
                    continue  # the first cumulative record has no window
                v = v / interval
            series.append(float(v))
        if len(series) < 2 * min_segment:
            continue
        scanned += 1
        hit = detect_step_change(series, k=k, min_segment=min_segment,
                                 rel_floor=rel_floor, abs_floor=abs_floor)
        if hit is not None:
            anomalies.append({
                "metric": name, "kind": kind, "labels": labels,
                "stat": use_stat or ("rate" if rate and kind == "counter"
                                     else "value"),
                "windows": len(series), **hit,
            })
    anomalies.sort(key=lambda a: -a["score"])
    return {"windows": len(records), "series_scanned": scanned,
            "anomalies": anomalies}


def render(report: Dict[str, Any]) -> str:
    out = [f"anomaly report: {report['windows']} windows, "
           f"{report['series_scanned']} series scanned, "
           f"{len(report['anomalies'])} anomalies"]
    for a in report["anomalies"]:
        labels = ",".join(f"{k}={v}" for k, v in sorted(a["labels"].items()))
        name = a["metric"] + (f"{{{labels}}}" if labels else "")
        out.append(
            f"  {name} [{a['stat']}] window {a['split_index']}: "
            f"{a['median_before']:.6g} -> {a['median_after']:.6g} "
            f"(shift {a['shift']:+.6g}, {a['score']}x threshold)")
    return "\n".join(out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m dist_svgd_torch.tools.anomaly_report",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("history", help="telemetry history directory "
                                    "(telemetry_<seq>.json records)")
    ap.add_argument("--metric", default=None,
                    help="scan only this metric (default: every series)")
    ap.add_argument("--stat", default=None,
                    help="histogram statistic: count, sum, mean (default), "
                         "p50/p95/p99")
    ap.add_argument("--rate", action="store_true",
                    help="normalise counter windows by interval_s "
                         "(skips the first cumulative record)")
    ap.add_argument("--k", type=float, default=DEFAULT_K,
                    help="MADs of baseline noise a shift must clear")
    ap.add_argument("--min-segment", type=int, default=DEFAULT_MIN_SEGMENT,
                    help="minimum windows on each side of a split")
    ap.add_argument("--rel-floor", type=float, default=DEFAULT_REL_FLOOR,
                    help="minimum shift as a fraction of baseline median")
    ap.add_argument("--abs-floor", type=float, default=0.0,
                    help="minimum absolute shift")
    ap.add_argument("--json", action="store_true")
    args = ap.parse_args(argv)
    if not os.path.isdir(args.history):
        print(f"anomaly_report: not a directory: {args.history}",
              file=sys.stderr)
        return 2
    records = TelemetryHistory(args.history).records()
    if not records:
        print(f"anomaly_report: no telemetry records under {args.history}",
              file=sys.stderr)
        return 2
    report = analyze_records(
        records, metric=args.metric, stat=args.stat, rate=args.rate,
        k=args.k, min_segment=args.min_segment, rel_floor=args.rel_floor,
        abs_floor=args.abs_floor)
    print(json.dumps(report) if args.json else render(report))
    return 1 if report["anomalies"] else 0


if __name__ == "__main__":
    sys.exit(main())
