"""Summarise a telemetry trace file: per-span percentiles, self-time,
kernel builds — or render a flight-recorder postmortem bundle.

Counterpart of ``tools/trace_report.py`` (plain Python; the port keeps its
own copy).  Reads either exporter format the port's tracer writes
(``dist_svgd_torch/telemetry/trace.py``):

- **Chrome trace JSON** (``Tracer.export_chrome`` — the Perfetto-loadable
  ``{"traceEvents": [...]}`` document, µs timestamps), or
- **JSONL** (one record per completed span/instant through ``JsonlLogger``,
  second timestamps, ``kind`` field).

and prints, per span name: count, p50/p95/p99/max duration, total wall, and
total **self-time** (duration minus time covered by child spans on the same
track — the "where did the time actually go" number a nested trace hides);
plus the top-N self-time ranking and every ``kernel_build`` instant (the
port's compile event: one ``nvcc`` build of a hand kernel; JAX buckets its
``xla_compile`` instants here) bucketed by the span it fired inside (a
build inside ``train.segment`` after the first is a rebuild bug).  The
report dict keeps JAX's keys (``compiles``, ``compile_spans``).

``--postmortem`` instead renders a **flight-recorder bundle**
(``telemetry.FlightRecorder.dump`` — written when a guard trips, a fault
fires or the restart budget exhausts): the header's reason and context,
the last posterior-diagnostics report, the metric snapshot, and the ring of
events leading up to the dump.

``--programs`` renders the **per-program cost attribution** instead: the
top programs by fenced dispatch wall (``svgd_prog_dispatch_*``, written by
``telemetry/profile.py``) from a ``MetricsRegistry.dump()`` JSON file —
dispatches, total and mean wall, share, rows and bytes — or from a
telemetry history directory (``telemetry/history.py``'s ring), whose
records' window deltas it sums.

``--stitch router.json replica*.json`` joins **multiple per-process
exports into one tree per request**: every export carries a
process-identity header (role/name/pid) plus a wall↔monotonic clock
anchor, and every routed request carries one trace id across the
``X-Fleet-Trace`` hop — so the fleet router's ``fleet.route ⊃
fleet.attempt`` lane trees and each replica's ``serve.request ⊃ …`` trees
reassemble as ``fleet.route ⊃ fleet.attempt ⊃ [fleet.wire gap] ⊃
serve.request ⊃ …``, with retries/hedges as sibling attempts and the
derived network/queue gap surfaced as the synthetic ``fleet.wire`` span.
The report carries per-hop p50/p95/p99, the **stitch coverage** fraction
(served routes that found their replica tree — the fleet drill gates this
at 1.0 in fake mode), and the orphan count (replica traces whose router
export is missing — reported, never crashing).  It reads exports written
by the port's tracer and by JAX's alike (the same header and span names).

A missing, empty, or corrupt input — including a stitch export without a
process header or clock anchor — exits with one line on stderr and a
nonzero status (2) — no tracebacks from the CLI.

Usage::

    python -m dist_svgd_torch.tools.trace_report trace.json           # human table
    python -m dist_svgd_torch.tools.trace_report trace.json --json    # machine row
    python -m dist_svgd_torch.tools.trace_report trace.jsonl --top 5
    python -m dist_svgd_torch.tools.trace_report \
        postmortem_001_guard_violation.jsonl --postmortem
    python -m dist_svgd_torch.tools.trace_report --stitch router.json r0.json r1.json
    python -m dist_svgd_torch.tools.trace_report --programs metrics_dump.json
    python -m dist_svgd_torch.tools.trace_report --programs history_dir/
"""

import argparse
import json
import os
import sys

#: The instant the port records for each hand-kernel build
#: (``ops/_build.py``), bucketed where JAX buckets ``xla_compile``.
COMPILE_INSTANT = "kernel_build"

#: The dispatch profiler's metric names (telemetry/profile.py), read from
#: dump documents here.
_PROG_SECONDS = "svgd_prog_dispatch_seconds"
_PROG_ROWS = "svgd_prog_dispatch_rows_total"
_PROG_BYTES = "svgd_prog_dispatch_bytes_total"


def _percentile(sorted_vals, q):
    if not sorted_vals:
        return 0.0
    idx = min(len(sorted_vals) - 1, int(round(q * (len(sorted_vals) - 1))))
    return sorted_vals[idx]


def load_export(path):
    """Normalise either trace format to ``(process, spans, instants)``:
    ``process`` is the export's process-identity header (role/name/pid +
    clock anchor; ``None`` when the export has none), spans are
    ``{name, ts_us, dur_us, tid, args}`` and instants
    ``{name, ts_us, tid, args}``."""
    process = None
    with open(path) as fh:
        first = fh.readline()
        fh.seek(0)
        # both formats start with "{": a Chrome doc is ONE object with
        # "traceEvents" (export_chrome writes it on one line; other
        # producers pretty-print, making the first line unparseable alone),
        # a JSONL file is one flat record per line
        try:
            doc0 = json.loads(first)
            is_chrome = isinstance(doc0, dict) and "traceEvents" in doc0
        except json.JSONDecodeError:
            is_chrome = True
        if is_chrome:
            doc = json.load(fh)
            raw = doc.get("traceEvents", [])
            other = doc.get("otherData")
            if isinstance(other, dict) and isinstance(
                    other.get("process"), dict):
                process = other["process"]
        else:  # JSONL: one span/instant record per line
            raw = []
            for line in fh:
                line = line.strip()
                if not line:
                    continue
                rec = json.loads(line)
                kind = rec.get("kind")
                if kind == "process":
                    process = rec  # last wins (set_process rewrites it)
                    continue
                if kind not in ("span", "instant"):
                    continue
                ev = {"name": rec["name"], "ph": "X" if kind == "span" else "i",
                      "ts": rec["ts"] * 1e6, "tid": rec.get("tid", 0),
                      "args": rec.get("args")}
                if kind == "span":
                    ev["dur"] = rec.get("dur", 0.0) * 1e6
                raw.append(ev)
    spans, instants = [], []
    for ev in raw:
        ph = ev.get("ph")
        if ph == "X":
            spans.append({"name": ev["name"], "ts_us": float(ev["ts"]),
                          "dur_us": float(ev.get("dur", 0.0)),
                          "tid": ev.get("tid", 0),
                          "args": ev.get("args") or {}})
        elif ph == "i":
            instants.append({"name": ev["name"], "ts_us": float(ev["ts"]),
                             "tid": ev.get("tid", 0),
                             "args": ev.get("args") or {}})
    return process, spans, instants


def load_events(path):
    """Back-compat single-file loader: ``(spans, instants)``."""
    _, spans, instants = load_export(path)
    return spans, instants


def _self_times(spans):
    """Per-span self-time: duration minus the duration of child spans on the
    same track (direct children only — grandchildren are already subtracted
    from their own parent).  Containment nesting per tid, the trace-viewer
    convention."""
    self_us = [s["dur_us"] for s in spans]
    by_tid = {}
    for i, s in enumerate(spans):
        by_tid.setdefault(s["tid"], []).append(i)
    # ts and dur are rounded independently at export (0.001 µs), so an
    # adjacent sibling can appear to start marginally before the previous
    # span's computed end — the epsilon keeps it a sibling, not a child
    # (a genuine child overlaps by far more than 10 ns)
    eps = 0.01
    for indices in by_tid.values():
        # start ascending; ties: longest first so the outer span parents
        indices.sort(key=lambda i: (spans[i]["ts_us"], -spans[i]["dur_us"]))
        stack = []  # indices of currently-open spans
        for i in indices:
            ts = spans[i]["ts_us"]
            while stack and (spans[stack[-1]]["ts_us"]
                             + spans[stack[-1]]["dur_us"]) <= ts + eps:
                stack.pop()
            if stack:
                self_us[stack[-1]] -= spans[i]["dur_us"]
            stack.append(i)
    return self_us


def _enclosing(spans_by_tid, instant):
    """Name of the innermost span containing the instant on its track (the
    exporter also tags instants with ``in_span`` at record time — preferred
    when present, since thread-stack context beats timestamp containment)."""
    arg = instant["args"].get("in_span")
    if arg:
        return arg
    best, best_dur = None, None
    for s in spans_by_tid.get(instant["tid"], ()):
        if s["ts_us"] <= instant["ts_us"] <= s["ts_us"] + s["dur_us"]:
            if best_dur is None or s["dur_us"] < best_dur:
                best, best_dur = s["name"], s["dur_us"]
    return best or "(no span)"


def summarize(spans, instants, top=10):
    """The report dict (``main`` renders it; tests consume it directly)."""
    self_us = _self_times(spans)
    by_name = {}
    for i, s in enumerate(spans):
        entry = by_name.setdefault(s["name"], {"durs": [], "self_us": 0.0})
        entry["durs"].append(s["dur_us"])
        entry["self_us"] += self_us[i]
    rows = {}
    for name, entry in by_name.items():
        durs = sorted(entry["durs"])
        rows[name] = {
            "count": len(durs),
            "p50_ms": round(_percentile(durs, 0.50) / 1e3, 4),
            "p95_ms": round(_percentile(durs, 0.95) / 1e3, 4),
            "p99_ms": round(_percentile(durs, 0.99) / 1e3, 4),
            "max_ms": round(durs[-1] / 1e3, 4),
            "total_ms": round(sum(durs) / 1e3, 3),
            "self_ms": round(entry["self_us"] / 1e3, 3),
        }
    top_self = sorted(rows, key=lambda n: -rows[n]["self_ms"])[:top]
    spans_by_tid = {}
    for s in spans:
        spans_by_tid.setdefault(s["tid"], []).append(s)
    compiles = [i for i in instants if i["name"] == COMPILE_INSTANT]
    compile_spans = {}
    for inst in compiles:
        where = _enclosing(spans_by_tid, inst)
        compile_spans[where] = compile_spans.get(where, 0) + 1
    return {
        "spans": rows,
        "top_self": top_self,
        "n_spans": len(spans),
        "n_instants": len(instants),
        "compiles": len(compiles),
        "compile_spans": compile_spans,
    }


def render(report):
    rows = report["spans"]
    name_w = max([len(n) for n in rows] + [4])
    out = [f"{'span':{name_w}s} {'count':>7s} {'p50ms':>9s} {'p95ms':>9s} "
           f"{'p99ms':>9s} {'max ms':>9s} {'total ms':>10s} {'self ms':>10s}"]
    for name in sorted(rows, key=lambda n: -rows[n]["total_ms"]):
        r = rows[name]
        out.append(
            f"{name:{name_w}s} {r['count']:7d} {r['p50_ms']:9.3f} "
            f"{r['p95_ms']:9.3f} {r['p99_ms']:9.3f} {r['max_ms']:9.3f} "
            f"{r['total_ms']:10.2f} {r['self_ms']:10.2f}"
        )
    out.append("")
    out.append("top self-time: " + ", ".join(
        f"{n} ({rows[n]['self_ms']:.2f} ms)" for n in report["top_self"]))
    out.append(f"kernel builds: {report['compiles']}")
    for where, n in sorted(report["compile_spans"].items(), key=lambda kv: -kv[1]):
        out.append(f"  {n:4d} in {where}")
    return "\n".join(out)


# --------------------------------------------------------------------- #
# cross-process stitching


def _require_anchor(path, process):
    """The stitch contract: every export must self-identify and carry the
    wall↔monotonic anchor — without it cross-process timestamps cannot be
    aligned, and guessing would silently mis-attribute the wire gap."""
    if not isinstance(process, dict):
        raise ValueError(
            f"{path} carries no process-identity header — re-export it "
            "with the current tracer (Chrome otherData.process / JSONL "
            "kind=\"process\" record)")
    for field in ("anchor_unix_s", "anchor_trace_s"):
        if not isinstance(process.get(field), (int, float)):
            raise ValueError(
                f"{path} has no clock anchor ({field}) in its process "
                "header — cross-process timestamps cannot be aligned")


def stitch_files(paths, wire_span="fleet.wire"):
    """Join router + replica trace exports into one tree per request.

    ``paths``: one or more router exports (process role ``"router"``) plus
    any number of replica exports, in any order — files self-identify via
    their process headers.  Returns the stitch report dict (``main``
    renders it; ``fleet_drill`` reads ``coverage`` off it):

    - ``coverage`` — fraction of *served* router routes whose serving
      attempt matched a replica ``serve.request`` tree on the trace id
      (the fleet drill's fake-mode gate is exactly 1.0);
    - ``orphan_replica_traces`` — replica-side traces with no router
      route (a missing/rotated router export): reported, never fatal;
    - ``hops`` — per-hop duration percentiles across all stitched trees,
      including the synthetic ``fleet.wire`` span (the attempt wall not
      covered by the replica's serve span, on the anchor-aligned wall
      clock: network + replica HTTP queueing);
    - ``trees`` — one record per served route, retries/hedges as sibling
      attempts.
    """
    exports = []
    for path in paths:
        process, spans, _instants = load_export(path)
        _require_anchor(path, process)
        exports.append({"path": path, "process": process, "spans": spans})
    routers = [e for e in exports if e["process"].get("role") == "router"]
    replicas = [e for e in exports if e["process"].get("role") != "router"]
    if not routers:
        raise ValueError(
            "no export identifies as the router (process role "
            "\"router\") — pass the router's trace alongside the replicas'")

    def wall_us(export, ts_us):
        p = export["process"]
        return (p["anchor_unix_s"] - p["anchor_trace_s"]) * 1e6 + ts_us

    # routes keyed trace -> LIST: a client may replay one X-Fleet-Trace
    # id across requests (the front door passes it through verbatim), and
    # collapsing those onto one tree would corrupt attempt/coverage
    # accounting — each fleet.route span stays its own tree, and its
    # attempts bind to it by time containment within the route interval
    routes = {}
    attempts = {}
    for e in routers:
        for s in e["spans"]:
            trace = s["args"].get("trace")
            if not trace:
                continue
            if s["name"] == "fleet.route":
                routes.setdefault(trace, []).append(
                    {"span": s, "export": e})
            elif s["name"] == "fleet.attempt":
                attempts.setdefault(trace, []).append(
                    {"span": s, "export": e})
    serves = {}
    for e in replicas:
        by_tid = {}
        for s in e["spans"]:
            by_tid.setdefault(s["tid"], []).append(s)
        for s in e["spans"]:
            if s["name"] != "serve.request":
                continue
            trace = s["args"].get("trace")
            if not trace:
                continue
            # the tree's children share the lane track and nest inside
            # the parent interval (lane allocation guarantees no overlap
            # between trees; the 1 µs epsilon absorbs export rounding)
            children = [c for c in by_tid[s["tid"]]
                        if c is not s
                        and c["ts_us"] >= s["ts_us"] - 1.0
                        and (c["ts_us"] + c["dur_us"]
                             <= s["ts_us"] + s["dur_us"] + 1.0)]
            serves.setdefault(trace, []).append({
                "span": s, "export": e, "children": children,
                "replica": (s["args"].get("replica")
                            or e["process"].get("name"))})

    hop_durs = {}

    def add_hop(name, dur_us):
        hop_durs.setdefault(name, []).append(dur_us)

    trees = []
    eligible = 0
    stitched = 0
    retry_trees = 0
    hedged_trees = 0
    n_routes = sum(len(lst) for lst in routes.values())
    route_records = sorted(
        ((trace, r) for trace, lst in routes.items() for r in lst),
        key=lambda tr: tr[1]["span"]["ts_us"])
    serve_used: dict = {}
    for trace, route in route_records:
        rspan = route["span"]
        rargs = rspan["args"]
        if rargs.get("outcome") != "served":
            continue  # sheds / unroutables / deadlines owe no replica tree
        eligible += 1
        add_hop("fleet.route", rspan["dur_us"])
        rt0 = rspan["ts_us"]
        rt1 = rt0 + rspan["dur_us"]
        atts = sorted((a for a in attempts.get(trace, [])
                       if rt0 - 1.0 <= a["span"]["ts_us"]
                       and (a["span"]["ts_us"] + a["span"]["dur_us"]
                            <= rt1 + 1.0)),
                      key=lambda a: a["span"]["ts_us"])
        serve_list = sorted(serves.get(trace, []),
                            key=lambda s: s["span"]["ts_us"])
        # one consumed-serve-span pool per trace, shared across any
        # duplicate-id routes, so a serve tree matches exactly one attempt
        used = serve_used.setdefault(trace, set())
        tree_attempts = []
        matched_any = False
        for a in atts:
            aspan = a["span"]
            aargs = aspan["args"]
            add_hop("fleet.attempt", aspan["dur_us"])
            rec = {"n": aargs.get("n"), "replica": aargs.get("replica"),
                   "dur_ms": round(aspan["dur_us"] / 1e3, 4)}
            if aargs.get("hedged"):
                rec["hedged"] = True
            if "error" in aargs:
                rec["error"] = aargs["error"]
                tree_attempts.append(rec)
                continue
            rec["status"] = aargs.get("status")
            match = None
            for i, sv in enumerate(serve_list):
                if i not in used and sv["replica"] == aargs.get("replica"):
                    match = (i, sv)
                    break
            if match is None:
                tree_attempts.append(rec)
                continue
            i, sv = match
            used.add(i)
            matched_any = True
            sspan = sv["span"]
            add_hop("serve.request", sspan["dur_us"])
            for c in sv["children"]:
                add_hop(c["name"], c["dur_us"])
            a_start = wall_us(a["export"], aspan["ts_us"])
            a_end = a_start + aspan["dur_us"]
            s_start = wall_us(sv["export"], sspan["ts_us"])
            s_end = s_start + sspan["dur_us"]
            gap_us = max(s_start - a_start, 0.0) + max(a_end - s_end, 0.0)
            add_hop(wire_span, gap_us)
            rec["serve"] = {"replica": sv["replica"],
                            "dur_ms": round(sspan["dur_us"] / 1e3, 4),
                            "wire_gap_ms": round(gap_us / 1e3, 4)}
            tree_attempts.append(rec)
        if matched_any:
            stitched += 1
            if len(atts) > 1:
                retry_trees += 1
            if any(t.get("hedged") for t in tree_attempts):
                hedged_trees += 1
        trees.append({"trace": trace, "tenant": rargs.get("tenant"),
                      "status": rargs.get("status"),
                      "replica": rargs.get("replica"),
                      "stitched": matched_any,
                      "attempts": tree_attempts})
    orphans = sorted(t for t in serves if t not in routes)
    hops = {}
    for name, durs in hop_durs.items():
        durs = sorted(durs)
        hops[name] = {
            "count": len(durs),
            "p50_ms": round(_percentile(durs, 0.50) / 1e3, 4),
            "p95_ms": round(_percentile(durs, 0.95) / 1e3, 4),
            "p99_ms": round(_percentile(durs, 0.99) / 1e3, 4),
            "max_ms": round(durs[-1] / 1e3, 4) if durs else 0.0,
        }
    return {
        "files": [{"path": e["path"],
                   "role": e["process"].get("role"),
                   "name": e["process"].get("name")} for e in exports],
        "router_routes": n_routes,
        "served_routes": eligible,
        "stitched": stitched,
        "coverage": round(stitched / eligible, 6) if eligible else 1.0,
        "orphan_replica_traces": len(orphans),
        "retry_trees": retry_trees,
        "hedged_trees": hedged_trees,
        "hops": hops,
        "trees": trees,
    }


def render_stitch(report, top=10):
    out = [f"stitched {report['stitched']}/{report['served_routes']} served "
           f"routes (coverage {report['coverage']:.4f}) across "
           f"{len(report['files'])} exports; "
           f"{report['orphan_replica_traces']} orphan replica trace(s); "
           f"{report['retry_trees']} tree(s) with retries, "
           f"{report['hedged_trees']} hedged"]
    hops = report["hops"]
    if hops:
        name_w = max([len(n) for n in hops] + [4])
        out.append(f"{'hop':{name_w}s} {'count':>7s} {'p50ms':>9s} "
                   f"{'p95ms':>9s} {'p99ms':>9s} {'max ms':>9s}")
        order = ["fleet.route", "fleet.attempt", "fleet.wire",
                 "serve.request"]
        names = [n for n in order if n in hops] + sorted(
            n for n in hops if n not in order)
        for name in names:
            h = hops[name]
            out.append(f"{name:{name_w}s} {h['count']:7d} {h['p50_ms']:9.3f} "
                       f"{h['p95_ms']:9.3f} {h['p99_ms']:9.3f} "
                       f"{h['max_ms']:9.3f}")
    shown = [t for t in report["trees"] if t["stitched"]][:top]
    for t in shown:
        out.append(f"trace {t['trace']} tenant={t['tenant']} "
                   f"status={t['status']}:")
        for a in t["attempts"]:
            leg = (f"  attempt {a['n']} -> {a['replica']} "
                   f"({a['dur_ms']:.3f} ms)")
            if "error" in a:
                leg += f" {a['error']}"
            elif "serve" in a:
                leg += (f" = {a['status']}; serve.request "
                        f"{a['serve']['dur_ms']:.3f} ms, wire gap "
                        f"{a['serve']['wire_gap_ms']:.3f} ms")
            else:
                leg += f" = {a.get('status')}"
            if a.get("hedged"):
                leg += " [hedged]"
            out.append(leg)
    return "\n".join(out)


def load_postmortem(path):
    """Parse a flight-recorder bundle (JSONL): returns
    ``(header, metrics_snapshot, diagnostics, events)``.  Raises
    ``ValueError`` when the file is not a postmortem bundle."""
    header = None
    snapshot = None
    diagnostics = None
    events = []
    with open(path) as fh:
        for lineno, line in enumerate(fh, 1):
            line = line.strip()
            if not line:
                continue
            rec = json.loads(line)
            if not isinstance(rec, dict):
                raise ValueError(f"line {lineno} is not a JSON object")
            kind = rec.get("kind")
            if lineno == 1:
                if kind != "postmortem":
                    raise ValueError(
                        "first record is not a postmortem header "
                        f"(kind={kind!r}) — is this a flight-recorder "
                        "bundle?")
                header = rec
            elif kind == "metrics":
                snapshot = rec.get("snapshot")
            elif kind == "diagnostics":
                diagnostics = rec
            else:
                events.append(rec)
    if header is None:
        raise ValueError("empty file")
    return header, snapshot, diagnostics, events


def render_postmortem(header, snapshot, diagnostics, events, top=10):
    out = [f"postmortem: {header.get('reason', '?')}",
           f"  dumped at unix {header.get('ts')}; "
           f"{len(events)} ring events"]
    ctx = header.get("context") or {}
    for k in sorted(ctx):
        out.append(f"  context.{k} = {ctx[k]}")
    if diagnostics is not None:
        out.append("last diagnostics:")
        for k in sorted(diagnostics):
            if k not in ("kind", "ts"):
                out.append(f"  {k} = {diagnostics[k]}")
    if snapshot:
        out.append(f"metrics snapshot ({len(snapshot)} series):")
        for k in sorted(snapshot):
            out.append(f"  {k} = {snapshot[k]}")
    if events:
        out.append(f"ring (oldest first, last {min(len(events), top)} shown):")
        for rec in events[-top:]:
            kind = rec.get("kind", "?")
            name = rec.get("name") or rec.get("reason") or ""
            extra = {k: v for k, v in rec.items()
                     if k not in ("kind", "name", "ts")}
            out.append(f"  [{rec.get('ts', 0):>12.6f}] {kind:11s} {name} "
                       f"{extra if extra else ''}".rstrip())
    return "\n".join(out)


def load_program_dumps(path):
    """The dump documents behind one ``--programs`` input: a metrics
    dump JSON file → ``[dump]``; a telemetry history directory → every
    record's window delta (summed downstream)."""
    if os.path.isdir(path):
        from dist_svgd_torch.telemetry.history import TelemetryHistory

        records = TelemetryHistory(path).records()
        if not records:
            raise ValueError("no telemetry history records in directory")
        return [rec.get("window", {}) for rec in records]
    with open(path) as fh:
        doc = json.load(fh)
    if not isinstance(doc, dict) or "metrics" not in doc:
        raise ValueError("not a MetricsRegistry.dump() document")
    return [doc]


def program_rows(dumps):
    """Per-label attribution rows summed over ``dumps``, sorted by total
    dispatch seconds (descending).  Federated ``replica``-labelled
    series are skipped — the rollup series already carry the total."""
    agg = {}
    for dump in dumps:
        metrics = dump.get("metrics", {})
        for name, key in ((_PROG_SECONDS, None), (_PROG_ROWS, "rows"),
                          (_PROG_BYTES, "bytes")):
            for s in (metrics.get(name) or {}).get("series", []):
                labels = s.get("labels") or {}
                if "replica" in labels:
                    continue
                label = labels.get("label", "")
                row = agg.setdefault(label, {
                    "label": label, "dispatches": 0, "seconds": 0.0,
                    "rows": 0, "bytes": 0,
                })
                if key is None:  # the histogram: sum + count
                    row["seconds"] += float(s.get("sum", 0.0) or 0.0)
                    row["dispatches"] += int(s.get("count", 0) or 0)
                else:
                    row[key] += int(s.get("value", 0) or 0)
    rows = sorted(agg.values(), key=lambda r: -r["seconds"])
    total = sum(r["seconds"] for r in rows)
    for r in rows:
        r["mean_ms"] = (1e3 * r["seconds"] / r["dispatches"]
                        if r["dispatches"] else 0.0)
        r["share"] = (r["seconds"] / total) if total > 0 else 0.0
    return {"metric": "program_attribution", "windows": len(dumps),
            "total_seconds": total, "programs": rows}


def render_programs(report, top=10):
    rows = report["programs"][:top]
    out = [f"program attribution: {len(report['programs'])} programs, "
           f"{report['total_seconds']:.4f} s attributed over "
           f"{report['windows']} window(s)"]
    if not rows:
        return (out[0] + " (no svgd_prog_* series — was the dispatch "
                "profiler enabled?)")
    label_w = max([len(r["label"]) for r in rows] + [7])
    out.append(f"{'program':{label_w}s} {'disp':>8s} {'total_s':>10s} "
               f"{'mean_ms':>9s} {'share':>7s} {'rows':>12s} {'MB':>10s}")
    for r in rows:
        out.append(
            f"{r['label']:{label_w}s} {r['dispatches']:8d} "
            f"{r['seconds']:10.4f} {r['mean_ms']:9.3f} "
            f"{100 * r['share']:6.1f}% {r['rows']:12d} "
            f"{r['bytes'] / 1e6:10.2f}")
    return "\n".join(out)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m dist_svgd_torch.tools.trace_report",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("trace", nargs="+",
                    help="Chrome trace JSON (Tracer.export_chrome), tracer JSONL "
                         "file, (with --postmortem) a flight-recorder bundle, or "
                         "(with --stitch) the router export plus every replica "
                         "export")
    ap.add_argument("--top", type=int, default=10,
                    help="entries in the self-time ranking (or postmortem ring "
                         "events / stitched trees shown)")
    ap.add_argument("--json", action="store_true",
                    help="emit the report as one JSON document")
    ap.add_argument("--postmortem", action="store_true",
                    help="render a flight-recorder postmortem bundle instead of a "
                         "span summary")
    ap.add_argument("--stitch", action="store_true",
                    help="join router + replica exports into one tree per "
                         "request on the X-Fleet-Trace ids (files "
                         "self-identify via their process headers)")
    ap.add_argument("--programs", action="store_true",
                    help="render the dispatch profiler's per-program cost "
                         "attribution (input: a metrics dump JSON or a telemetry "
                         "history directory) instead of a span summary")
    args = ap.parse_args(argv)
    if sum((args.stitch, args.postmortem, args.programs)) > 1:
        ap.error("--stitch, --postmortem and --programs are mutually "
                 "exclusive")
    if not args.stitch and len(args.trace) != 1:
        ap.error("exactly one trace file expected (pass --stitch to join "
                 "several exports)")
    trace_path = args.trace[0]

    if args.programs:
        try:
            report = program_rows(load_program_dumps(trace_path))
        except OSError as e:
            print(f"trace_report: cannot read {e.filename or trace_path}: "
                  f"{e.strerror or e}", file=sys.stderr)
            return 2
        except (json.JSONDecodeError, UnicodeDecodeError, ValueError,
                TypeError) as e:
            print(f"trace_report: {trace_path} is not a metrics dump or "
                  f"telemetry history: {e}", file=sys.stderr)
            return 2
        if args.json:
            doc = dict(report)
            doc["programs"] = doc["programs"][:args.top]
            print(json.dumps(doc))
        else:
            print(render_programs(report, top=args.top))
        return 0

    try:
        if args.stitch:
            stitch_report = stitch_files(args.trace)
        elif args.postmortem:
            header, snapshot, diagnostics, events = load_postmortem(trace_path)
        else:
            spans, instants = load_events(trace_path)
    except OSError as e:
        print(f"trace_report: cannot read {e.filename or trace_path}: "
              f"{e.strerror or e}", file=sys.stderr)
        return 2
    except (json.JSONDecodeError, UnicodeDecodeError, KeyError, ValueError,
            TypeError) as e:
        # corrupt/truncated JSON, a non-trace file, a malformed record, a
        # stitch export missing its process/anchor header: one clear line,
        # no traceback
        if args.stitch:
            print(f"trace_report: inputs are not a stitchable export set: {e}",
                  file=sys.stderr)
        else:
            kind = "postmortem bundle" if args.postmortem else "trace file"
            print(f"trace_report: {trace_path} is not a readable {kind}: {e}",
                  file=sys.stderr)
        return 2

    if args.stitch:
        if args.json:
            doc = dict(stitch_report)
            doc["trees"] = doc["trees"][:args.top]
            print(json.dumps(doc))
        else:
            print(render_stitch(stitch_report, top=args.top))
        return 0
    if args.postmortem:
        if args.json:
            print(json.dumps({"header": header, "metrics": snapshot,
                              "diagnostics": diagnostics, "events": events}))
        else:
            print(render_postmortem(header, snapshot, diagnostics, events,
                                    top=args.top))
        return 0
    if not spans and not instants:
        print(f"trace_report: no trace events in {trace_path}", file=sys.stderr)
        return 1
    report = summarize(spans, instants, top=args.top)
    if args.json:
        print(json.dumps(report))
    else:
        print(render(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
