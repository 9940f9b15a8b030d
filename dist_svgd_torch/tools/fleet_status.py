"""Fleet status plane: one-shot fleet view from a running FleetRouter.

Counterpart of ``tools/fleet_status.py`` (pure stdlib; the port keeps its
own copy).  Polls the router's ``/fleet`` route (``FleetRouter.fleet_status()``: one
federation sweep over the live replicas, then breaker states, per-tenant
fleet-wide counters/percentiles from the **merged** histograms, and the
SLO verdicts over the federated window) and renders a human table or one
JSON document.

Per-tenant **rps** needs a window, which a one-shot CLI doesn't have — so
the tool polls ``/fleet`` twice, ``--interval-s`` apart, and derives each
tenant's fleet-wide rate from the federated request-counter delta (the
counters are restart-clamped upstream, so a replica bouncing between the
two polls can only under-count, never go negative).  ``--interval-s 0``
skips the second poll (rates report ``null``).

The same two-poll delta drives the **cost columns**: per
tenant, fleet-wide device-seconds/s (the fraction of one device the
tenant is burning) and rows/s from the federated ``svgd_usage_*``
counters riding the ``/fleet`` tenants rows; and per replica, the same
two rates from the router's ``/usage`` per-replica breakdown (polled at
the same two instants).  Replicas without usage metering contribute
nothing and the columns print ``-``.

Usage::

    python -m dist_svgd_torch.tools.fleet_status --url http://127.0.0.1:8100
    python -m dist_svgd_torch.tools.fleet_status --url http://127.0.0.1:8100 --json
    python -m dist_svgd_torch.tools.fleet_status --url ... --interval-s 2.0

Exit codes: 0 healthy (some replica closed, SLO not breaching), 1 when
the fleet is degraded or an SLO is burning, 2 when the router is
unreachable or answers garbage — so the CLI slots into shell health
checks as-is.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
import urllib.error
import urllib.request
from typing import Any, Dict, Optional, Tuple


def fetch_fleet(url: str, timeout_s: float = 5.0) -> Dict[str, Any]:
    """GET ``<url>/fleet`` and return the parsed status document."""
    req = urllib.request.Request(url.rstrip("/") + "/fleet")
    with urllib.request.urlopen(req, timeout=timeout_s) as resp:
        doc = json.loads(resp.read())
    if not isinstance(doc, dict) or "replicas" not in doc:
        raise ValueError("reply is not a fleet status document")
    return doc


def fetch_usage(url: str, timeout_s: float = 5.0
                ) -> Optional[Dict[str, Any]]:
    """GET ``<url>/usage`` (the router's federated cost summary), or
    ``None`` against a router without the route."""
    req = urllib.request.Request(url.rstrip("/") + "/usage")
    try:
        with urllib.request.urlopen(req, timeout=timeout_s) as resp:
            doc = json.loads(resp.read())
    except urllib.error.HTTPError:
        return None
    return doc if isinstance(doc, dict) else None


def _rate(cur: Optional[float], prev: Optional[float],
          interval_s: float) -> Optional[float]:
    if cur is None or prev is None or interval_s <= 0:
        return None
    return max(float(cur) - float(prev), 0.0) / interval_s


def derive_rates(first: Dict[str, Any], second: Dict[str, Any],
                 interval_s: float) -> Dict[str, Dict[str, Optional[float]]]:
    """Per-tenant fleet rates from the two polls' federated counters
    (non-negative by construction — the federation clamps restarts):
    ``{tenant: {rps, device_s_per_s, rows_per_s}}``."""
    rates: Dict[str, Dict[str, Optional[float]]] = {}
    t0 = first.get("tenants", {})
    for name, row in second.get("tenants", {}).items():
        prev = t0.get(name) or {}
        rates[name] = {
            "rps": _rate(row.get("requests_total"),
                         prev.get("requests_total"), interval_s),
            "device_s_per_s": _rate(row.get("device_seconds_total"),
                                    prev.get("device_seconds_total"),
                                    interval_s),
            "rows_per_s": _rate(row.get("usage_rows_total"),
                                prev.get("usage_rows_total"), interval_s),
        }
    return rates


def derive_replica_rates(first: Optional[Dict[str, Any]],
                         second: Optional[Dict[str, Any]],
                         interval_s: float
                         ) -> Dict[str, Dict[str, Optional[float]]]:
    """Per-replica cost rates from two ``/usage`` polls' per-replica
    breakdowns, summed over tenants: ``{replica: {device_s_per_s,
    rows_per_s}}``."""
    if not first or not second:
        return {}

    def _totals(doc):
        out: Dict[str, Dict[str, float]] = {}
        for rid, tenants in (doc.get("replicas") or {}).items():
            agg = {"device_seconds": 0.0, "rows": 0.0}
            for row in tenants.values():
                agg["device_seconds"] += float(row.get("device_seconds", 0.0))
                agg["rows"] += float(row.get("rows", 0))
            out[rid] = agg
        return out

    prev, cur = _totals(first), _totals(second)
    return {
        rid: {
            "device_s_per_s": _rate(agg["device_seconds"],
                                    (prev.get(rid) or {}).get(
                                        "device_seconds"), interval_s),
            "rows_per_s": _rate(agg["rows"],
                                (prev.get(rid) or {}).get("rows"),
                                interval_s),
        }
        for rid, agg in cur.items()
    }


def build_report(first: Dict[str, Any], second: Optional[Dict[str, Any]],
                 interval_s: float,
                 usage_first: Optional[Dict[str, Any]] = None,
                 usage_second: Optional[Dict[str, Any]] = None
                 ) -> Dict[str, Any]:
    """The tool's JSON document: the latest status doc plus derived
    per-tenant rates (requests + cost) and a one-word health verdict."""
    doc = second if second is not None else first
    rates = (derive_rates(first, second, interval_s)
             if second is not None else {})
    replica_rates = derive_replica_rates(usage_first, usage_second,
                                         interval_s)
    slo_status = (doc.get("slo") or {}).get("status")
    healthy = bool(doc.get("replicas_closed")) and slo_status != "breach"

    def _round(v, nd):
        return None if v is None else round(v, nd)

    tenants = {}
    for name, row in doc.get("tenants", {}).items():
        r = rates.get(name) or {}
        tenants[name] = {
            **row,
            "rps": _round(r.get("rps"), 2),
            "device_s_per_s": _round(r.get("device_s_per_s"), 4),
            "rows_per_s": _round(r.get("rows_per_s"), 1),
        }
    return {
        "metric": "fleet_status",
        "healthy": healthy,
        "status": doc.get("status"),
        "slo_status": slo_status,
        "replicas_closed": doc.get("replicas_closed"),
        "replicas_total": doc.get("replicas_total"),
        "replicas": {rid: {"state": st.get("state"),
                           "reason": st.get("reason"),
                           "ejections": st.get("ejections"),
                           "generation": st.get("generation"),
                           "last_healthy_age_s": st.get(
                               "last_healthy_age_s"),
                           "device_s_per_s": _round(
                               (replica_rates.get(rid) or {}).get(
                                   "device_s_per_s"), 4),
                           "rows_per_s": _round(
                               (replica_rates.get(rid) or {}).get(
                                   "rows_per_s"), 1)}
                     for rid, st in (doc.get("replicas") or {}).items()},
        "federation": doc.get("federation"),
        "tenants": tenants,
        "slo": doc.get("slo"),
        "interval_s": interval_s if second is not None else 0.0,
        "ts": doc.get("ts"),
    }


def render(report: Dict[str, Any]) -> str:
    out = [f"fleet: {report['status']}  "
           f"({report['replicas_closed']}/{report['replicas_total']} "
           f"replicas closed; slo {report['slo_status']})"]
    out.append("replicas:")
    for rid in sorted(report["replicas"]):
        st = report["replicas"][rid]
        line = f"  {rid:12s} {st['state']:9s}"
        if st.get("generation") is not None:
            # per-replica serving generation: a mid-rollout fleet shows
            # which replicas already flipped to the new posterior
            line += f" gen={st['generation']}"
        if st.get("reason"):
            line += f" reason={st['reason']}"
        if st.get("ejections"):
            line += f" ejections={st['ejections']}"
        if st.get("last_healthy_age_s") is not None:
            line += f" last_healthy={st['last_healthy_age_s']}s ago"
        if st.get("device_s_per_s") is not None:
            line += f" dev_s/s={st['device_s_per_s']:.4f}"
        if st.get("rows_per_s") is not None:
            line += f" rows/s={st['rows_per_s']:.1f}"
        out.append(line)
    fed = report.get("federation") or {}
    line = (f"federation: {fed.get('scrapes', 0)} sweeps, last "
            f"{fed.get('last_scrape_ms')} ms, monotone="
            f"{fed.get('monotone')}")
    if fed.get("scrape_errors"):
        line += f", errors={fed['scrape_errors']}"
    out.append(line)
    tenants = report.get("tenants") or {}
    if tenants:
        name_w = max([len(n) for n in tenants] + [6])
        out.append(f"{'tenant':{name_w}s} {'requests':>9s} {'rps':>8s} "
                   f"{'p50ms':>9s} {'p99ms':>9s} {'dev_s/s':>9s} "
                   f"{'rows/s':>9s}")
        for name in sorted(tenants):
            t = tenants[name]
            rps = "-" if t.get("rps") is None else f"{t['rps']:.1f}"
            dev = ("-" if t.get("device_s_per_s") is None
                   else f"{t['device_s_per_s']:.4f}")
            rows = ("-" if t.get("rows_per_s") is None
                    else f"{t['rows_per_s']:.1f}")
            out.append(
                f"{name:{name_w}s} {t.get('requests', 0):9d} {rps:>8s} "
                f"{t.get('p50_ms', 0.0):9.3f} {t.get('p99_ms', 0.0):9.3f} "
                f"{dev:>9s} {rows:>9s}")
    slo = (report.get("slo") or {}).get("objectives") or {}
    if slo:
        out.append("slo objectives:")
        for name in sorted(slo):
            o = slo[name]
            out.append(f"  {name:18s} {o.get('status', '?'):8s} "
                       f"burn={o.get('burn_rate')}")
    return "\n".join(out)


def collect(url: str, interval_s: float, timeout_s: float = 5.0
            ) -> Tuple[Dict[str, Any], Optional[Dict[str, Any]],
                       Optional[Dict[str, Any]], Optional[Dict[str, Any]]]:
    """Both polls, each pairing ``/fleet`` with ``/usage`` (the latter
    tolerated missing) so status and per-replica cost share a window."""
    first = fetch_fleet(url, timeout_s=timeout_s)
    usage_first = fetch_usage(url, timeout_s=timeout_s)
    second = usage_second = None
    if interval_s > 0:
        time.sleep(interval_s)
        second = fetch_fleet(url, timeout_s=timeout_s)
        usage_second = fetch_usage(url, timeout_s=timeout_s)
    return first, second, usage_first, usage_second


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m dist_svgd_torch.tools.fleet_status",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--url", required=True,
                    help="the FleetRouter's base URL (its /fleet route)")
    ap.add_argument("--interval-s", type=float, default=1.0,
                    help="window between the two /fleet polls that the "
                         "per-tenant rps derives from (0 = single poll, "
                         "no rates)")
    ap.add_argument("--timeout-s", type=float, default=5.0)
    ap.add_argument("--json", action="store_true",
                    help="emit the report as one JSON document")
    args = ap.parse_args(argv)
    try:
        first, second, usage_first, usage_second = collect(
            args.url, args.interval_s, timeout_s=args.timeout_s)
    except (urllib.error.URLError, OSError, ValueError,
            json.JSONDecodeError) as e:
        print(f"fleet_status: cannot read {args.url}/fleet: {e}",
              file=sys.stderr)
        return 2
    report = build_report(first, second, args.interval_s,
                          usage_first=usage_first,
                          usage_second=usage_second)
    if args.json:
        print(json.dumps(report))
    else:
        print(render(report))
    return 0 if report["healthy"] else 1


if __name__ == "__main__":
    sys.exit(main())
