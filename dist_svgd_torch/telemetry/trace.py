"""Span tracer: nestable, thread-aware timing spans with device fencing.

Counterpart of ``dist_svgd_tpu/telemetry/trace.py``.  Where the metrics
registry answers "how many / how fast on aggregate", the tracer answers
**"where did this run spend its time?"**:

- **Thread spans** (:func:`span`) — a context manager pushing onto a
  per-thread stack, so nesting is implicit and free; the span may *fence* a
  device value before stamping its end time (``sp.fence(out)`` →
  ``torch.cuda.synchronize`` when ``out`` holds a CUDA tensor — the card
  runs asynchronously; a CPU tensor needs no fence).  An unfenced span
  around launches measures the host's enqueue time, which is sometimes
  exactly what is wanted.
- **Lane trees** (:meth:`Tracer.lane_tree`) — post-hoc span trees with
  explicit timestamps for work whose lifetime crosses threads.  Each tree
  lands on a synthetic "request lane" track chosen so spans on one lane
  never overlap.
- **Instant events** (:func:`instant`) — point markers.  Eager PyTorch
  compiles nothing but the hand kernels, so while a tracer is enabled the
  kernel builder (``ops/_build.py``) records each ``nvcc`` build as a
  ``kernel_build`` instant *inside whatever span was active on the
  building thread* (JAX's tracer records its XLA compiles there).

**Zero-cost when disabled**: module-level :func:`span`/:func:`instant` check
one global and return a shared no-op singleton — no allocation, no lock, no
clock read (pinned by ``tests/test_torch_telemetry.py`` with
``tracemalloc``).  Enable with :func:`enable`, stop and export with
:func:`disable`.

Exporters: Chrome trace-event JSON (:meth:`Tracer.export_chrome` — load the
file in Perfetto / ``chrome://tracing``) and JSON-lines through
``utils/metrics.py:JsonlLogger`` (pass ``jsonl=`` — one record per
completed span).  The :class:`FlightRecorder` is the bounded black box a
postmortem bundle is dumped from.
"""

from __future__ import annotations

import itertools
import json
import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

__all__ = [
    "Tracer",
    "SpanHandle",
    "fence",
    "FlightRecorder",
    "enable",
    "disable",
    "get_tracer",
    "enabled",
    "span",
    "instant",
    "TRACE_HEADER",
    "mint_trace_id",
    "set_trace_context",
    "get_trace_context",
    "install_flight_recorder",
    "uninstall_flight_recorder",
    "flight_recorder",
    "record_flight",
]


# --------------------------------------------------------------------- #
# cross-process trace context
#
# A trace id is the join key that lets one request's spans be stitched
# back together across process boundaries: the fleet router mints one per
# routed request, sends it downstream as the ``X-Fleet-Trace`` header, and
# every hop tags its lane trees with it (a stitcher joins on it).  Within one process the id travels on a
# thread-local so a component deep in the dispatch path (the engine's
# spans under the batcher's lane thread) can tag without plumbing an
# argument through every signature.


#: The HTTP header a trace id crosses process boundaries in.  Defined
#: here — next to the minting and context plumbing — because BOTH sides
#: of the hop (the fleet router sending, the serving server extracting)
#: must spell it identically; each imports this one constant.
TRACE_HEADER = "X-Fleet-Trace"

_MINT_PREFIX = os.urandom(4).hex()  # 32 random bits per process
_MINT_SEQ = itertools.count(1)


def mint_trace_id() -> str:
    """A fresh 16-hex-char trace id: a per-process random 32-bit prefix +
    a process-local sequence.  Unique within a process by construction,
    collision-safe across a fleet via the prefix, and no syscall per id."""
    return f"{_MINT_PREFIX}{next(_MINT_SEQ) & 0xFFFFFFFF:08x}"


_TRACE_CTX = threading.local()


def set_trace_context(trace_id: Optional[str]) -> Optional[str]:
    """Set the calling thread's active trace id (``None`` clears it);
    returns the previous value so callers can restore it — the batcher
    brackets each single-trace dispatch with set/restore."""
    prev = getattr(_TRACE_CTX, "trace", None)
    _TRACE_CTX.trace = trace_id
    return prev


def get_trace_context() -> Optional[str]:
    """The calling thread's active trace id, or ``None``."""
    return getattr(_TRACE_CTX, "trace", None)


class _NoopSpan:
    """Disabled-path singleton: every operation is a no-op returning fast.

    ``__exit__`` takes the three positional exception args explicitly —
    a ``*args`` signature would allocate a tuple per call, and this object
    sits in hot loops of every instrumented component.
    """

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False

    def tag(self, **tags):
        return self

    def fence(self, value):
        return value


_NOOP = _NoopSpan()


def _cuda_devices(value, out: set) -> set:
    """The CUDA devices of the tensors in ``value`` (a tensor, or a
    tuple / list / dict of them, nested)."""
    if isinstance(value, torch.Tensor):
        if value.device.type == "cuda":
            out.add(value.device)
    elif isinstance(value, (tuple, list)):
        for v in value:
            _cuda_devices(v, out)
    elif isinstance(value, dict):
        for v in value.values():
            _cuda_devices(v, out)
    return out


def fence(value) -> bool:
    """Wait for the card's work behind ``value``: ``torch.cuda.synchronize``
    on each CUDA device whose tensors ``value`` holds; nothing for CPU
    tensors and other values.  Returns whether it fenced."""
    devices = _cuda_devices(value, set())
    for dev in devices:
        torch.cuda.synchronize(dev)
    return bool(devices)


class SpanHandle:
    """One live span (enabled path).  Created by :meth:`Tracer.span`."""

    __slots__ = ("_tracer", "name", "tags", "_t0", "_fence")

    def __init__(self, tracer: "Tracer", name: str, tags: Optional[dict]):
        self._tracer = tracer
        self.name = name
        self.tags = tags
        self._t0 = 0.0
        self._fence = None

    def tag(self, **tags) -> "SpanHandle":
        if self.tags is None:
            self.tags = tags
        else:
            self.tags.update(tags)
        return self

    def fence(self, value):
        """Register ``value`` to be waited for at span exit: a CUDA tensor
        (or a tuple / list / dict holding one) makes the exit call
        ``torch.cuda.synchronize`` on its device, so the end timestamp
        covers the card's execution, not just the launches; a CPU tensor
        needs no fence.  Returns ``value`` for inline use: ``out =
        sp.fence(fn(x))``."""
        self._fence = value
        return value

    def __enter__(self) -> "SpanHandle":
        tr = self._tracer
        tr._stack().append(self)
        self._t0 = tr.now()
        return self

    def __exit__(self, exc_type, exc, tb):
        tr = self._tracer
        try:
            if self._fence is not None:
                value, self._fence = self._fence, None
                fence(value)
        finally:
            # record + pop even when the fence raises (a failed async
            # dispatch surfaces at the fence): the span must not leak on
            # the thread stack, and the trace should show the span that
            # died
            t1 = tr.now()
            stack = tr._stack()
            if stack and stack[-1] is self:
                stack.pop()
            if exc_type is not None:
                self.tag(error=exc_type.__name__)
            tr._complete(self.name, self._t0, t1, self.tags,
                         threading.get_ident())
        return False


class Tracer:
    """Collects span/instant events; thread-safe; bounded.

    Args:
        clock: monotonic seconds source (``time.perf_counter``); injectable
            for deterministic tests.
        max_events: hard cap on retained events — beyond it new events are
            **dropped and counted** (``dropped_events``), never silently
            grown: a day-long traced run must not OOM the host.
        jsonl: optional ``utils/metrics.py:JsonlLogger`` (anything with a
            ``log(**record)`` method) — one line per completed span/instant.
        registry: metrics registry for the tracer's own health series
            (``svgd_trace_dropped_total``, the ``svgd_trace_lanes`` gauge —
            a saturated trace buffer must be observable without polling
            ``dropped_events``); defaults to the process-wide registry.

    **Process identity:** every tracer stamps a process header —
    role / name / pid plus a wall-clock↔monotonic anchor (``time.time()``
    sampled at the tracer's monotonic epoch) — into both exporters (the
    Chrome doc's ``otherData.process``, one ``kind="process"`` JSONL
    record), so a stitcher can align timestamps
    from different processes on one wall clock and label each hop.
    :meth:`set_process` names the role (``"router"``/``"replica"``).
    """

    def __init__(self, clock: Callable[[], float] = time.perf_counter,
                 max_events: int = 1_000_000, jsonl=None, registry=None):
        if max_events < 1:
            raise ValueError(f"max_events must be >= 1, got {max_events}")
        from dist_svgd_torch.telemetry import metrics as _metrics

        self._clock = clock
        # the wall↔monotonic anchor: _anchor_unix is the wall time AT the
        # tracer's monotonic epoch (every event ts is seconds since _t0,
        # so wall(ts) = _anchor_unix + ts at analysis time)
        self._anchor_unix = time.time()
        self._t0 = clock()
        self._max_events = int(max_events)
        self._jsonl = jsonl
        self._lock = threading.Lock()
        self._events: List[dict] = []
        self._dropped = 0
        self._lanes: List[float] = []  # per-lane last span end time
        self._thread_names: Dict[int, str] = {}
        self._tls = threading.local()
        self._process = {"role": "process",
                         "name": f"pid-{os.getpid()}",
                         "pid": os.getpid()}
        self._process_explicit = False
        reg = registry if registry is not None else _metrics.default_registry()
        self._m_dropped = reg.counter(
            "svgd_trace_dropped_total",
            "trace events dropped past the tracer's max_events cap")
        self._m_lanes = reg.gauge(
            "svgd_trace_lanes",
            "request lane tracks allocated by the tracer (lane pressure)")
        if self._jsonl is not None:
            # the process-identity header rides the JSONL stream first, so
            # a stitcher can label the file before reading any span
            try:
                self._jsonl.log(**self.process_meta())
            except ValueError:
                pass

    # ------------------------------------------------------------------ #
    # process identity

    def set_process(self, role: Optional[str] = None,
                    name: Optional[str] = None,
                    only_if_default: bool = False) -> Dict[str, Any]:
        """Stamp this tracer's process identity (role ``"router"`` /
        ``"replica"`` / ..., a human replica name).  ``only_if_default``
        makes the call a no-op once an explicit identity was set — so a
        component's best-effort self-labelling never clobbers what a
        drill or CLI already declared.  Returns the active meta."""
        with self._lock:
            if not (only_if_default and self._process_explicit):
                if role is not None:
                    self._process["role"] = str(role)
                if name is not None:
                    self._process["name"] = str(name)
                self._process_explicit = True
            proc = dict(self._process)
        if self._jsonl is not None:
            try:
                self._jsonl.log(**self.process_meta())
            except ValueError:
                pass
        return proc

    def process_meta(self) -> Dict[str, Any]:
        """The process-identity header record both exporters carry:
        role/name/pid plus the wall↔monotonic anchor (``anchor_unix_s`` is
        the wall time at trace-timestamp 0.0)."""
        with self._lock:
            proc = dict(self._process)
        return {"kind": "process", **proc,
                "anchor_unix_s": self._anchor_unix,
                "anchor_trace_s": 0.0}

    # ------------------------------------------------------------------ #
    # recording

    def now(self) -> float:
        """Seconds since the tracer started (every event timestamp)."""
        return self._clock() - self._t0

    def _stack(self) -> list:
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = self._tls.stack = []
        return stack

    def active_span(self) -> Optional[SpanHandle]:
        stack = self._stack()
        return stack[-1] if stack else None

    def span(self, name: str, tags: Optional[dict] = None) -> SpanHandle:
        return SpanHandle(self, name, dict(tags) if tags else None)

    def instant(self, name: str, tags: Optional[dict] = None) -> None:
        parent = self.active_span()
        if parent is not None:
            tags = dict(tags) if tags else {}
            tags["in_span"] = parent.name
        self._append({
            "ph": "i", "name": name, "ts": self.now(),
            "tid": threading.get_ident(), "args": tags or None,
        })

    def complete(self, name: str, t0: float, t1: float,
                 tags: Optional[dict] = None, tid=None) -> None:
        """Record an already-timed span (timestamps from :meth:`now`) —
        for callers that measured the interval themselves (``StepTimer``)."""
        self._complete(name, t0, t1, tags,
                       tid if tid is not None else threading.get_ident())

    def _complete(self, name: str, t0: float, t1: float,
                  tags: Optional[dict], tid) -> None:
        self._append({
            "ph": "X", "name": name, "ts": t0, "dur": max(t1 - t0, 0.0),
            "tid": tid, "args": tags or None,
        })

    def _append(self, event: dict) -> None:
        rec = _RECORDER
        if rec is not None:
            # the flight recorder's ring keeps the NEWEST events (deque
            # maxlen) while the tracer's buffer keeps the oldest under its
            # drop cap — a crash postmortem wants what happened just
            # before the end, so feed the ring even past the tracer's cap
            rec._record_trace_event(event)
        tid = event["tid"]
        dropped = False
        with self._lock:
            if isinstance(tid, int) and tid not in self._thread_names:
                cur = threading.current_thread()
                self._thread_names[tid] = (
                    cur.name if cur.ident == tid else f"thread-{tid}"
                )
            if len(self._events) >= self._max_events:
                self._dropped += 1
                dropped = True
            else:
                self._events.append(event)
        if dropped:
            # metric write OUTSIDE the tracer lock (registry has its own);
            # a drop is now a scrapeable counter, not a silent property
            self._m_dropped.inc()
            return
        if self._jsonl is not None:
            rec = {k: v for k, v in event.items() if v is not None}
            rec["kind"] = "span" if event["ph"] == "X" else "instant"
            try:
                self._jsonl.log(**rec)
            except ValueError:
                pass  # logger closed mid-run: keep tracing in memory

    def lane_tree(self, name: str, t0: float, t1: float,
                  tags: Optional[dict] = None,
                  children: Sequence[Tuple] = ()) -> None:
        """Record a parent span plus children with **explicit timestamps**
        (from :meth:`now`, captured by the caller as the work progressed)
        on a synthetic lane track.  Lanes are allocated first-fit by
        start time so spans within one lane never overlap — the Chrome
        viewer then nests each tree unambiguously even when many trees
        (concurrent requests) overlap in wall time.

        ``children``: ``(name, t0, t1)`` or ``(name, t0, t1, tags)`` tuples,
        each clamped inside the parent interval.
        """
        if t1 < t0:
            t0, t1 = t1, t0
        with self._lock:
            lane = None
            for i, last_end in enumerate(self._lanes):
                if last_end <= t0:
                    lane = i
                    break
            new_lane = lane is None
            if new_lane:
                lane = len(self._lanes)
                self._lanes.append(0.0)
            self._lanes[lane] = t1
            n_lanes = len(self._lanes)
        if new_lane:
            # gauge write only when lane pressure actually grows — this
            # sits on every traced request's completion path
            self._m_lanes.set(n_lanes)
        tid = f"lane-{lane:03d}"
        self._complete(name, t0, t1, tags, tid)
        for child in children:
            cname, c0, c1 = child[0], child[1], child[2]
            ctags = child[3] if len(child) > 3 else None
            self._complete(cname, max(c0, t0), min(c1, t1), ctags, tid)

    @property
    def dropped_events(self) -> int:
        with self._lock:
            return self._dropped

    # ------------------------------------------------------------------ #
    # export

    def chrome_events(self) -> List[dict]:
        """Chrome trace-event dicts (µs timestamps), ts-sorted, with
        thread/lane name metadata events first."""
        with self._lock:
            events = list(self._events)
            thread_names = dict(self._thread_names)
        out = []
        lanes = sorted({e["tid"] for e in events if isinstance(e["tid"], str)})
        names = dict(thread_names)
        names.update({lane: f"request {lane}" for lane in lanes})
        # stable int tids for chrome: lanes first (they read top-down as
        # request swimlanes), then real threads in first-seen order
        tid_map = {lane: i + 1 for i, lane in enumerate(lanes)}
        base = len(lanes) + 1
        for e in events:
            if e["tid"] not in tid_map:
                tid_map[e["tid"]] = base
                base += 1
        for raw_tid, tid in sorted(tid_map.items(), key=lambda kv: kv[1]):
            out.append({
                "ph": "M", "name": "thread_name", "pid": 1, "tid": tid,
                "args": {"name": str(names.get(raw_tid, raw_tid))},
            })
        for e in sorted(events, key=lambda e: e["ts"]):
            ev = {
                "ph": e["ph"], "name": e["name"], "pid": 1,
                "tid": tid_map[e["tid"]],
                "ts": round(e["ts"] * 1e6, 3),
            }
            if e["ph"] == "X":
                ev["dur"] = round(e["dur"] * 1e6, 3)
            else:
                ev["s"] = "t"
            if e.get("args"):
                ev["args"] = e["args"]
            out.append(ev)
        return out

    def export_chrome(self, path: str) -> int:
        """Write Perfetto-loadable Chrome trace JSON; returns event count.
        ``otherData.process`` carries the process-identity header + clock
        anchor that a stitcher aligns files on."""
        events = self.chrome_events()
        doc = {"traceEvents": events, "displayTimeUnit": "ms",
               "otherData": {"process": self.process_meta()}}
        if self.dropped_events:
            doc["otherData"]["dropped_events"] = self.dropped_events
        with open(path, "w") as fh:
            json.dump(doc, fh)
            fh.write("\n")
        return len(events)

    def counts(self) -> Dict[str, int]:
        """Event counts by name (diagnostics and tests)."""
        with self._lock:
            out: Dict[str, int] = {}
            for e in self._events:
                out[e["name"]] = out.get(e["name"], 0) + 1
            return out


# --------------------------------------------------------------------- #
# flight recorder: bounded black box for crash postmortems

class FlightRecorder:
    """Bounded ring buffer of recent spans, instants, explicit records,
    and the last diagnostics report — the training/serving "black box".

    While installed (:func:`install_flight_recorder`) the tracer feeds
    every completed span/instant into the ring (newest kept — a crash
    wants the moments *before* the end, the opposite retention of the
    tracer's own drop-oldest-never buffer), and components add structured
    records off their hot paths via :func:`record_flight`.  On a guard
    trip, an injected fault, or an exhausted restart budget the caller
    calls :meth:`dump`, which writes one **postmortem bundle** — JSONL:
    a header line, the registry's metric snapshot, the last diagnostics
    report, then the ring oldest→newest (JAX's bundle format).

    Args:
        capacity: max retained events (ring; oldest evicted).
        dump_dir: where :meth:`dump` writes bundles
          (``postmortem_<seq>_<reason>.jsonl``).
        registry: metrics registry snapshotted into each bundle — every
            bundle carries the numbers (default: the process-wide
            registry).
        clock: unix-time source for event/bundle timestamps.
    """

    def __init__(self, capacity: int = 1024, dump_dir: str = ".",
                 registry=None, clock: Callable[[], float] = time.time):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        import collections

        from dist_svgd_torch.telemetry import metrics as _metrics

        self._lock = threading.Lock()
        self._ring = collections.deque(maxlen=int(capacity))
        self._dump_dir = dump_dir
        self._registry = (registry if registry is not None
                          else _metrics.default_registry())
        self._clock = clock
        self._last_diagnostics: Optional[dict] = None
        self._dumps = 0
        self._m_dumps = self._registry.counter(
            "svgd_flight_dumps_total", "postmortem bundles written")

    # ------------------------------------------------------------------ #

    def record(self, kind: str, **fields) -> None:
        """Append one structured record to the ring.  ``kind='diagnostics'``
        additionally becomes the bundle's last-diagnostics block."""
        entry = {"kind": kind, "ts": self._clock(), **fields}
        with self._lock:
            self._ring.append(entry)
            if kind == "diagnostics":
                self._last_diagnostics = entry

    def _record_trace_event(self, event: dict) -> None:
        """Tracer feed: one completed span/instant (tracer-relative
        timestamps, like the trace exports)."""
        entry = {"kind": "span" if event["ph"] == "X" else "instant",
                 "name": event["name"], "ts": event["ts"]}
        if event["ph"] == "X":
            entry["dur"] = event["dur"]
        if event.get("args"):
            entry["args"] = event["args"]
        with self._lock:
            self._ring.append(entry)

    @property
    def last_diagnostics(self) -> Optional[dict]:
        with self._lock:
            return self._last_diagnostics

    def events(self) -> List[dict]:
        """Ring contents oldest→newest (a copy)."""
        with self._lock:
            return list(self._ring)

    @property
    def dumps(self) -> int:
        with self._lock:
            return self._dumps

    # ------------------------------------------------------------------ #

    def dump(self, reason: str, context: Optional[dict] = None,
             path: Optional[str] = None) -> str:
        """Write one postmortem bundle; returns its path.

        The bundle is JSONL so a truncated write (the crash may be a
        dying process) still yields parseable leading lines: header,
        metrics snapshot, last diagnostics, then ring events.
        """
        import os
        import re

        with self._lock:
            self._dumps += 1
            seq = self._dumps
            events = list(self._ring)
            last_diag = self._last_diagnostics
        if path is None:
            slug = re.sub(r"[^a-zA-Z0-9_.-]+", "_", reason)[:48] or "unknown"
            os.makedirs(self._dump_dir, exist_ok=True)
            path = os.path.join(self._dump_dir,
                                f"postmortem_{seq:03d}_{slug}.jsonl")
        lines = [{"kind": "postmortem", "reason": reason,
                  "ts": self._clock(), "events": len(events),
                  "context": context or {}}]
        try:
            lines.append({"kind": "metrics",
                          "snapshot": self._registry.snapshot()})
        except Exception:  # a half-poisoned registry must not block a dump
            lines.append({"kind": "metrics", "snapshot": None})
        if last_diag is not None:
            lines.append(last_diag)
        lines.extend(events)
        with open(path, "w") as fh:
            for rec in lines:
                fh.write(json.dumps(rec, default=str))
                fh.write("\n")
        self._m_dumps.inc()
        return path


_RECORDER: Optional[FlightRecorder] = None


def install_flight_recorder(recorder: Optional[FlightRecorder] = None,
                            **kwargs) -> FlightRecorder:
    """Install (and return) the process flight recorder.  Idempotent while
    installed — a second call returns the live recorder unchanged (nested
    tooling composes, the tracer-enable convention).  ``kwargs`` build a
    fresh :class:`FlightRecorder` when none is passed."""
    global _RECORDER
    with _SWITCH_LOCK:
        if _RECORDER is None:
            _RECORDER = recorder if recorder is not None else FlightRecorder(
                **kwargs)
        return _RECORDER


def uninstall_flight_recorder() -> Optional[FlightRecorder]:
    """Remove and return the installed recorder (``None`` when absent)."""
    global _RECORDER
    with _SWITCH_LOCK:
        recorder, _RECORDER = _RECORDER, None
    return recorder


def flight_recorder() -> Optional[FlightRecorder]:
    return _RECORDER


def record_flight(kind: str, **fields) -> None:
    """Structured record into the installed recorder; no-op when none.
    Hot paths should guard on :func:`flight_recorder` first — the kwargs
    dict is built at the call site either way."""
    rec = _RECORDER
    if rec is not None:
        rec.record(kind, **fields)


# --------------------------------------------------------------------- #
# module-level switchboard: the zero-cost disabled path

_TRACER: Optional[Tracer] = None
_SWITCH_LOCK = threading.Lock()


def enable(clock: Callable[[], float] = time.perf_counter,
           max_events: int = 1_000_000, jsonl=None,
           registry=None) -> Tracer:
    """Install (and return) the global tracer.  Idempotent while enabled —
    a second ``enable`` returns the live tracer unchanged, so nested
    tooling (serve_bench inside perf_regress) composes."""
    global _TRACER
    with _SWITCH_LOCK:
        if _TRACER is None:
            _TRACER = Tracer(clock=clock, max_events=max_events, jsonl=jsonl,
                             registry=registry)
        return _TRACER


def disable() -> Optional[Tracer]:
    """Uninstall and return the global tracer (for export); no-op → None."""
    global _TRACER
    with _SWITCH_LOCK:
        tracer, _TRACER = _TRACER, None
    return tracer


def get_tracer() -> Optional[Tracer]:
    return _TRACER


def enabled() -> bool:
    """True while a global tracer is installed.  Hot paths that must build
    tag dicts or capture timestamps guard on this first."""
    return _TRACER is not None


def span(name: str, tags: Optional[dict] = None):
    """Context manager timing ``name`` on the current thread's span stack.
    The shared no-op singleton when tracing is disabled (no allocation)."""
    tracer = _TRACER
    if tracer is None:
        return _NOOP
    return tracer.span(name, tags)


def instant(name: str, tags: Optional[dict] = None) -> None:
    """Point event inside the current span; no-op when disabled."""
    tracer = _TRACER
    if tracer is not None:
        tracer.instant(name, tags)
