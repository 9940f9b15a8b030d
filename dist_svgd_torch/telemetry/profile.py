"""Per-program dispatch profiling: runtime cost attribution for every
program :class:`~dist_svgd_torch.parallel.plan.Plan` compiles and tracks.

Counterpart of ``dist_svgd_tpu/telemetry/profile.py``, with its metric
names.  While a :class:`DispatchProfiler` is enabled, every dispatch of a
tracked program (``parallel/plan.py:Program``) is fenced and its wall time
observed into a ``svgd_prog_dispatch_seconds{label=...}`` histogram,
alongside dispatch / rows / bytes counters sized from the entry's
first-call shapes and dtypes.  ``python -m dist_svgd_torch.tools.
trace_report --programs`` renders it.

Cost discipline:

- **Disabled is the default and costs one module-global read** per
  dispatch: ``Program.__call__`` reads ``_PROFILER`` and runs the program
  directly when it is ``None``.  :func:`measure` returns a shared
  zero-alloc no-op singleton.
- **Enabled fences every tracked dispatch** (``telemetry.trace.fence``:
  a ``torch.cuda.synchronize`` on each card the output holds).  The serve
  path already fetches its results to the host, so its fence is free.
- **Fence exactly once.**  The profiler leaves a thread-local note
  identifying the output it just fenced; :func:`fence` (used by
  ``utils/metrics.StepTimer.mark``) consumes the note and skips the
  redundant fence when handed that same object.

The profiler has no background thread and takes no locks on the hot path:
per-entry label dicts and rows/bytes sizes are computed once and cached on
the :class:`~dist_svgd_torch.parallel.plan.ProgramEntry` (keyed by
profiler identity), and the metric objects do their own locking.

Usage::

    from dist_svgd_torch.telemetry import profile

    prof = profile.enable_profiler(registry=metrics_registry)
    ...dispatch work...
    profile.disable_profiler()
    print(profile.summary(metrics_registry))   # {label: {seconds, ...}}
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, Optional

import torch

from dist_svgd_torch.telemetry import trace as _trace

__all__ = [
    "DISPATCH_SECONDS",
    "DISPATCHES_TOTAL",
    "DISPATCH_ROWS_TOTAL",
    "DISPATCH_BYTES_TOTAL",
    "DispatchProfiler",
    "enable_profiler",
    "disable_profiler",
    "get_profiler",
    "profiler_enabled",
    "fence",
    "measure",
    "summary",
    "attributed_seconds",
]

#: Metric names (one label: ``label`` = the plan/program label).
DISPATCH_SECONDS = "svgd_prog_dispatch_seconds"
DISPATCHES_TOTAL = "svgd_prog_dispatches_total"
DISPATCH_ROWS_TOTAL = "svgd_prog_dispatch_rows_total"
DISPATCH_BYTES_TOTAL = "svgd_prog_dispatch_bytes_total"

#: The active profiler, or None.  Read (not called) on every tracked
#: dispatch — keep it a plain module global so the disabled path is one
#: attribute load + identity check.
_PROFILER: Optional["DispatchProfiler"] = None
_LOCK = threading.Lock()

#: Thread-local fence bookkeeping: ``(id(out), type(out))`` of the last
#: output this thread's profiler fenced, consumed (cleared) by the first
#: :func:`fence` call handed the same object.  id() alone could collide
#: after garbage collection; pairing with the concrete type and
#: overwriting on every profiled dispatch bounds the window to "the
#: dispatch this thread just timed", which is exactly the double-fence
#: being deduplicated.
_TLS = threading.local()


def _block_until_ready(value: Any) -> Any:
    """Fence ``value`` (read through the module, so a test's spy on
    ``trace.fence`` is honoured) and return it."""
    _trace.fence(value)
    return value


# ------------------------------------------------------------------ #
# sizing helpers: rows / bytes from the entry's first-call avals
# ------------------------------------------------------------------ #


def _entry_sizes(entry) -> tuple:
    """(rows, bytes) for one dispatch of ``entry``, from its first-call
    ``((shape, dtype), ...)`` snapshot.

    rows: leading dim of the first tensor argument (the batch/ensemble
    axis by plan convention).  bytes: total tensor input payload.  (0, 0)
    when the snapshot is missing."""
    avals = entry.avals
    if avals is None:
        return (0, 0)
    rows = 0
    nbytes = 0
    for shape, dtype in avals:
        if not isinstance(dtype, torch.dtype):
            continue  # a non-tensor argument
        if rows == 0 and len(shape) >= 1:
            rows = int(shape[0])
        numel = 1
        for s in shape:
            numel *= int(s)
        nbytes += numel * dtype.itemsize
    return (rows, nbytes)


# ------------------------------------------------------------------ #
# the profiler
# ------------------------------------------------------------------ #


class DispatchProfiler:
    """Fence + attribute every tracked dispatch to its program label.

    Args:
        registry: the :class:`~dist_svgd_torch.telemetry.metrics.
            MetricsRegistry` to write ``svgd_prog_*`` series into
            (default: the process-wide registry, so serving ``/metrics``
            picks the series up with no extra wiring).
        clock: injectable monotonic clock (tests).
    """

    def __init__(self, registry=None, clock: Callable[[], float] = time.perf_counter):
        from dist_svgd_torch.telemetry import metrics as _metrics

        self.registry = registry if registry is not None else _metrics.default_registry()
        self._clock = clock
        self._hist = self.registry.histogram(
            DISPATCH_SECONDS,
            "Fenced wall seconds of one compiled-program dispatch, by plan label.")
        self._dispatches = self.registry.counter(
            DISPATCHES_TOTAL, "Profiled dispatches, by plan label.")
        self._rows = self.registry.counter(
            DISPATCH_ROWS_TOTAL,
            "Leading-axis rows dispatched (first traced arg), by plan label.")
        self._bytes = self.registry.counter(
            DISPATCH_BYTES_TOTAL,
            "Traced input bytes dispatched, by plan label.")

    # hot path ------------------------------------------------------ #

    def call(self, entry, compiled: Callable, args, kwargs):
        """Run one dispatch fenced, attributing its wall to ``entry``.

        ``compiled`` records the call's shapes before it returns, so
        ``entry.avals`` is populated when the sizes below are read on the
        first profiled call.  The per-entry cache (label dict + sizes) is
        keyed by profiler identity — a disable/enable cycle with a new
        registry re-derives it; the benign write race on the cache slot
        is idempotent.
        """
        t0 = self._clock()
        out = compiled(*args, **kwargs)
        _block_until_ready(out)
        wall = self._clock() - t0
        _TLS.fenced = (id(out), type(out))

        cache = entry.prof_cache
        if cache is None or cache[0] is not self:
            rows, nbytes = _entry_sizes(entry)
            cache = (self, {"label": entry.label}, rows, nbytes)
            entry.prof_cache = cache
        _, labels, rows, nbytes = cache
        self._hist.observe(wall, **labels)
        self._dispatches.inc(**labels)
        if rows:
            self._rows.inc(rows, **labels)
        if nbytes:
            self._bytes.inc(nbytes, **labels)
        return out


# ------------------------------------------------------------------ #
# switchboard (the tracer's enable/disable discipline)
# ------------------------------------------------------------------ #


def enable_profiler(registry=None,
                    clock: Callable[[], float] = time.perf_counter,
                    ) -> DispatchProfiler:
    """Install a process-wide profiler (idempotent: an already-active
    profiler is returned unchanged — disable first to re-target)."""
    global _PROFILER
    with _LOCK:
        if _PROFILER is None:
            _PROFILER = DispatchProfiler(registry=registry, clock=clock)
        return _PROFILER


def disable_profiler() -> Optional[DispatchProfiler]:
    """Uninstall and return the active profiler (``None`` if idle).
    Clears this thread's pending fence note so a stale object id cannot
    suppress a later legitimate fence."""
    global _PROFILER
    with _LOCK:
        prof, _PROFILER = _PROFILER, None
    _TLS.fenced = None
    return prof


def get_profiler() -> Optional[DispatchProfiler]:
    return _PROFILER


def profiler_enabled() -> bool:
    return _PROFILER is not None


# ------------------------------------------------------------------ #
# fence-once
# ------------------------------------------------------------------ #


def fence(value: Any) -> Any:
    """``telemetry.trace.fence(value)`` — unless the active profiler
    already fenced this very object on this thread, in which case the
    note is consumed and the redundant device round-trip skipped.

    Drop-in for the fence sites that may wrap a profiled dispatch
    (``StepTimer.mark``): with the profiler off this is exactly the
    tracer's fence; with it on, each dispatch is fenced exactly once.
    """
    if value is None:
        return None
    note = getattr(_TLS, "fenced", None)
    if note is not None and note[0] == id(value) and note[1] is type(value):
        _TLS.fenced = None
        return value
    return _block_until_ready(value)


# ------------------------------------------------------------------ #
# manual attribution spans
# ------------------------------------------------------------------ #


class _NoopMeasure:
    """Shared do-nothing measure — the disabled :func:`measure` path
    allocates nothing (tracemalloc-pinned, like the tracer's no-op
    span)."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False


_NOOP_MEASURE = _NoopMeasure()


class _Measure:
    """Context manager attributing a hand-labelled block's fenced wall
    to the profiler's metrics — for host-side cost that never flows
    through a tracked plan dispatch (tools, custom loops)."""

    __slots__ = ("_prof", "_labels", "_t0")

    def __init__(self, prof: DispatchProfiler, label: str):
        self._prof = prof
        self._labels = {"label": label}
        self._t0 = 0.0

    def __enter__(self):
        self._t0 = self._prof._clock()
        return self

    def __exit__(self, exc_type, exc, tb):
        prof = self._prof
        wall = prof._clock() - self._t0
        prof._hist.observe(wall, **self._labels)
        prof._dispatches.inc(**self._labels)
        return False


def measure(label: str):
    """A with-block whose wall is attributed to ``label`` like a
    dispatch (no fence — the caller decides what readiness means for a
    host-side block).  Zero-alloc shared no-op while disabled."""
    prof = _PROFILER
    if prof is None:
        return _NOOP_MEASURE
    return _Measure(prof, label)


# ------------------------------------------------------------------ #
# read side
# ------------------------------------------------------------------ #


def summary(registry=None, label_prefix: str = "") -> Dict[str, dict]:
    """Per-program attribution read off any registry holding
    ``svgd_prog_*`` series (live, scraped, or federated): ``{label:
    {seconds, dispatches, mean_ms, rows, bytes}}``, restricted to
    ``label_prefix`` when given.  Federated replica-labelled series are
    skipped so fleet totals are not double-counted (the rollup series
    carry the fleet view)."""
    from dist_svgd_torch.telemetry import metrics as _metrics

    reg = registry if registry is not None else _metrics.default_registry()
    hist = reg.get(DISPATCH_SECONDS)
    out: Dict[str, dict] = {}
    if hist is None:
        return out
    for ls in hist.label_sets():
        if "replica" in ls:
            continue
        label = ls.get("label", "")
        if not label.startswith(label_prefix):
            continue
        # read at microsecond scale: Histogram.summary rounds to 4
        # decimals, which truncates a µs-scale dispatch wall at scale 1.0
        s = hist.summary(scale=1e6, **ls)
        if not s["count"]:
            continue
        row = out.setdefault(label, {
            "seconds": 0.0, "dispatches": 0, "mean_ms": 0.0,
            "rows": 0, "bytes": 0,
        })
        row["seconds"] += float(s["sum"]) / 1e6
        row["dispatches"] += int(s["count"])
    for name, key in ((DISPATCH_ROWS_TOTAL, "rows"),
                      (DISPATCH_BYTES_TOTAL, "bytes")):
        ctr = reg.get(name)
        if ctr is None:
            continue
        for ls in ctr.label_sets():
            if "replica" in ls:
                continue
            label = ls.get("label", "")
            if label in out:
                out[label][key] += int(ctr.value(**ls))
    for row in out.values():
        if row["dispatches"]:
            row["mean_ms"] = 1e3 * row["seconds"] / row["dispatches"]
    return out


def attributed_seconds(registry=None, label_prefix: str = "") -> float:
    """Total fenced dispatch wall attributed under ``label_prefix`` —
    the numerator of the ``cost_attribution`` coverage gate."""
    return float(sum(r["seconds"]
                     for r in summary(registry, label_prefix).values()))
