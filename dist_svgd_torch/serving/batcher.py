"""Micro-batching request queue: coalesce concurrent predict requests into
one fused device call, scatter results back per-request.

Counterpart of ``dist_svgd_tpu/serving/batcher.py`` (``MicroBatcher``,
``Overloaded``), whole; it imports nothing of JAX.

Why: a predictive program has a per-dispatch floor (launches, the
host↔card copies, the fetch) that dwarfs the marginal cost of extra rows —
N concurrent 1-row dispatches waste N-1 floors.  The batcher holds the
first request of a batch for at most ``max_wait_ms`` while coalescing
whatever else arrives, up to ``max_batch`` rows, then issues ONE dispatch
over the whole ensemble and slices the result back to each caller's
future.

Backpressure is explicit: the queue is bounded at ``max_queue_rows`` and
``submit`` raises :class:`Overloaded` (with a ``Retry-After`` estimate that
scales with the queue depth) instead of growing without bound.

Oversize requests (> ``max_batch`` rows) split into ``max_batch``-row chunks
that ride separate batches and reassemble before the future resolves — a
request can never deadlock waiting for a batch slot bigger than batches get.

Time is injectable (``clock`` + ``wait``) so tests drive ``max_wait_ms``
expiry deterministically instead of real-sleeping.

Telemetry: every batcher writes process-wide counters, the queue-depth
gauge and latency histograms into the shared ``telemetry.MetricsRegistry``
(``registry=`` for an isolated one), and, while the span tracer is enabled,
one **request lane tree** per completed request — ``serve.request`` with
``serve.queue_wait`` / ``serve.coalesce`` / ``serve.dispatch`` children.
:meth:`stats` keeps per-instance bounded-window percentiles.

Worker lanes: ``lanes=N`` runs N dispatch workers over the one shared
queue, so ``queue_wait`` stops serializing behind a single in-flight device
call.  Each lane is labelled in telemetry (``svgd_serve_lane_batches_total
{lane=...}``, the per-lane in-flight gauge).  :meth:`MicroBatcher.set_lanes`
and :meth:`MicroBatcher.set_max_wait_ms` retune both live.

Multi-tenant requests: ``submit(x, tenant=name)`` queues the request under
a tenant identity.  A batch only ever coalesces chunks of ONE tenant, and
the dispatch callable is invoked as ``dispatch(x, tenant)`` for tenant
requests (``dispatch(x)`` for tenant-less ones).  ``quotas={tenant:
max_inflight_rows}`` (a live mapping the
:class:`~dist_svgd_torch.serving.registry.ModelRegistry` shares) arms
**shed priorities**: when an arriving request would overflow
``max_queue_rows``, tenants over their quota shed FIRST.

The progressive-delivery hook (:meth:`MicroBatcher.set_rollout`): an armed
controller assigns each arriving request of its tenant a generation and
flags incumbent requests for shadow mirroring.  The controller is
:class:`~dist_svgd_torch.rollout.RolloutController`; the hook is this
module's.
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from concurrent.futures import CancelledError, Future, InvalidStateError
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from dist_svgd_torch.telemetry import metrics as _metrics
from dist_svgd_torch.telemetry import trace as _trace
from dist_svgd_torch.telemetry import usage as _usage

#: Batch-occupancy buckets (rows per dispatched batch): powers of two up to
#: the queue bound's usual order of magnitude.
_BATCH_ROW_BUCKETS = tuple(float(1 << i) for i in range(14))

#: Per-process batcher ids for the instance-labelled gauge series.
_INSTANCE_IDS = itertools.count()


class Overloaded(RuntimeError):
    """Raised by :meth:`MicroBatcher.submit` when the bounded queue is full.

    ``retry_after_s`` is the batcher's own estimate of when the
    backlog will have drained enough to admit a retry — derived from the
    coalescing window and the queue depth at shed time (one ``max_batch``
    batch drains per ``max_wait_ms`` window at worst, plus one window for
    the retry itself).  The HTTP layer surfaces it as a 429
    ``Retry-After`` and the fleet router honors it instead of its generic
    backoff — the replica knows its queue better than the caller does."""

    def __init__(self, msg: str, retry_after_s: Optional[float] = None):
        super().__init__(msg)
        self.retry_after_s = retry_after_s


def _default_wait(cond: threading.Condition, timeout: Optional[float]) -> bool:
    return cond.wait(timeout)


class _Request:
    """One client submit(): a future plus chunk-reassembly state.

    ``trace_enq`` is the tracer-clock enqueue timestamp and ``trace_src``
    the tracer it was read from (both None while tracing is disabled) — the
    batcher clock is injectable and test-faked, so the span timeline keeps
    its own honest clock, and a disable()/enable() cycle mid-flight resets
    the epoch, so a timestamp is only meaningful against the same tracer."""

    __slots__ = ("future", "n_chunks", "parts", "enqueued", "trace_enq",
                 "trace_src", "tenant", "trace", "generation", "mirror")

    def __init__(self, n_chunks: int, enqueued: float,
                 trace_enq: Optional[float] = None, trace_src=None,
                 tenant: Optional[str] = None,
                 trace: Optional[str] = None,
                 generation: Optional[str] = None,
                 mirror: bool = False):
        self.future: Future = Future()
        self.n_chunks = n_chunks
        self.parts: List[Optional[Dict[str, np.ndarray]]] = [None] * n_chunks
        self.enqueued = enqueued
        self.trace_enq = trace_enq
        self.trace_src = trace_src
        self.tenant = tenant
        self.trace = trace
        # progressive delivery: which generation serves this
        # request (None = incumbent, "candidate" = the rollout's hash
        # split routed it to the staged candidate), and whether the
        # incumbent answer should be shadow-mirrored to the candidate
        self.generation = generation
        self.mirror = mirror


class _Chunk:
    """A ≤ max_batch slice of one request, as queued."""

    __slots__ = ("x", "req", "index")

    def __init__(self, x: np.ndarray, req: _Request, index: int):
        self.x = x
        self.req = req
        self.index = index


def _percentile(sorted_vals: List[float], q: float) -> float:
    if not sorted_vals:
        return 0.0
    idx = min(len(sorted_vals) - 1, int(round(q * (len(sorted_vals) - 1))))
    return sorted_vals[idx]


class MicroBatcher:
    """Coalescing dispatch queue in front of a ``dispatch(x) -> dict`` callable
    (typically :meth:`PredictiveEngine.predict`).

    Args:
        dispatch: called with one ``(rows, feature_dim)`` array per batch;
            must return a dict of arrays with leading dimension ``rows``.
        max_batch: coalescing ceiling in rows; larger requests split.
        lanes: dispatch worker threads over the shared queue (default 1 —
            the old serialized behavior).  More lanes overlap device
            dispatch with coalescing and with other dispatches; pair with
            a mesh-sharded engine to keep every device busy.
        quotas: live ``{tenant: max_inflight_rows}`` mapping (``None``
            values exempt a tenant) read under the batcher lock on every
            overflow — mutate it to retune quotas without rebuilding the
            batcher.  Quotas only bite when the bounded queue fills: see
            the module docstring's shed-priority contract.
        max_wait_ms: how long the oldest queued request may wait for
            co-travellers before a partial batch is flushed.
        max_queue_rows: bound on queued (not-yet-dispatched) rows; beyond it
            ``submit`` sheds with :class:`Overloaded`.
        clock / wait: injectable time source and condition-wait, for
            deterministic tests.  ``wait(cond, timeout)`` must behave like
            ``cond.wait`` (held lock, returns after notify or timeout).
        logger: optional ``JsonlLogger``; one record per dispatched batch
            (rows, request count, queue-wait vs device-time split).
        registry: ``telemetry.MetricsRegistry`` to write counters / the
            queue-depth gauge / latency histograms into (default: the
            process-wide :func:`~dist_svgd_torch.telemetry.default_registry`).
        autostart: start the worker thread immediately.  Tests that need a
            deterministic pre-filled queue pass False, submit, then
            :meth:`start`.
    """

    def __init__(
        self,
        dispatch: Callable[[np.ndarray], Dict[str, np.ndarray]],
        *,
        max_batch: int = 256,
        lanes: int = 1,
        max_wait_ms: float = 2.0,
        max_queue_rows: int = 8192,
        quotas: Optional[Dict[str, Optional[int]]] = None,
        clock: Callable[[], float] = time.monotonic,
        wait: Callable[[threading.Condition, Optional[float]], bool] = _default_wait,
        logger=None,
        registry: Optional[_metrics.MetricsRegistry] = None,
        autostart: bool = True,
    ):
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        if lanes < 1:
            raise ValueError("lanes must be >= 1")
        if max_wait_ms < 0:
            raise ValueError("max_wait_ms must be >= 0")
        if max_queue_rows < max_batch:
            raise ValueError("max_queue_rows must be >= max_batch")
        self._dispatch = dispatch
        self.max_batch = int(max_batch)
        #: Live lane target: :meth:`set_lanes` retunes it while
        #: the batcher runs — lanes at index >= the target retire after
        #: their in-flight batch; missing lanes spawn.  Read-only outside.
        self.lanes = int(lanes)
        self._max_wait_s = float(max_wait_ms) / 1e3
        self.max_queue_rows = int(max_queue_rows)
        self._clock = clock
        self._wait = wait
        self._logger = logger

        self._cond = threading.Condition()
        self._queue: deque = deque()  # of _Chunk
        self._queued_rows = 0
        self._open = True
        # multi-tenant state: live quota mapping (shared with
        # the ModelRegistry that mutates it), queued rows and quota-shed
        # counts per tenant — all guarded by _cond's lock
        self._quotas = quotas if quotas is not None else {}
        # 'overflow': quotas bite only when the
        # bounded queue fills.  'admission': an over-quota
        # tenant is refused at submit time even with queue room — the
        # autoscale controller flips this on WHILE quotas are tightened
        # under overload, so a flooding tenant's queue occupancy (and
        # therefore everyone's queue delay) stays bounded between
        # overflow events, and flips it back when calm restores quotas.
        self._quota_mode = "overflow"
        # progressive delivery: an armed RolloutController
        # assigns each arriving request a generation (deterministic hash
        # split) and flags incumbent requests for shadow mirroring; the
        # submit ordinal is the hash key (guarded by _cond's lock)
        self._rollout = None
        self._submit_seq = 0
        self._tenant_queued: Dict[str, int] = {}
        # rows collected into a batch but not yet resolved: the drain
        # condition on tenant removal is queued AND inflight == 0 (a
        # tenant popped while its last batch is between _collect and
        # dispatch would KeyError in the router)
        self._tenant_inflight: Dict[str, int] = {}
        self._quota_sheds: Dict[str, int] = {}

        # metrics (guarded by _cond's lock)
        self._n_requests = 0
        self._n_rows = 0
        self._n_batches = 0
        self._n_shed = 0
        self._n_errors = 0
        self._occupancy: deque = deque(maxlen=4096)  # rows per batch
        self._requests_per_batch: deque = deque(maxlen=4096)
        self._queue_wait_ms: deque = deque(maxlen=4096)  # per batch
        self._device_ms: deque = deque(maxlen=4096)  # per batch
        self._latency_ms: deque = deque(maxlen=8192)  # per request, end to end
        # per-lane fairness counters: a stuck/starved lane is
        # visible here and in the lane-labelled registry series instead of
        # being averaged into the aggregate
        self._lane_batches = [0] * self.lanes
        self._lane_requests = [0] * self.lanes
        self._lane_rows = [0] * self.lanes

        # process-wide telemetry (shared registry; get-or-create, so several
        # batchers aggregate into the same counter/histogram series — the
        # Prometheus convention.  The queue-depth GAUGE is last-write-wins
        # and so carries a per-instance label: two batchers on one registry
        # must not overwrite each other's depth)
        reg = registry if registry is not None else _metrics.default_registry()
        self.registry = reg
        #: This batcher's ``batcher=`` label value on per-instance series
        #: (the queue-depth gauge).
        self.metrics_instance = f"b{next(_INSTANCE_IDS)}"
        self._m_requests = reg.counter(
            "svgd_serve_requests_total", "requests fully resolved")
        self._m_rows = reg.counter(
            "svgd_serve_rows_total", "rows dispatched in resolved requests")
        self._m_batches = reg.counter(
            "svgd_serve_batches_total", "coalesced batches dispatched")
        self._m_shed = reg.counter(
            "svgd_serve_shed_total",
            "requests shed with Overloaded (bounded queue full)")
        self._m_errors = reg.counter(
            "svgd_serve_dispatch_errors_total", "batch dispatch exceptions")
        self._m_queue_depth = reg.gauge(
            "svgd_serve_queue_depth_rows", "rows queued, not yet dispatched")
        self._m_latency = reg.histogram(
            "svgd_serve_request_latency_seconds",
            "request end-to-end latency (enqueue to resolve)")
        self._m_queue_wait = reg.histogram(
            "svgd_serve_queue_wait_seconds",
            "oldest-request coalescing wait per batch")
        self._m_device = reg.histogram(
            "svgd_serve_device_time_seconds",
            "dispatch wall (device + fetch) per batch")
        self._m_batch_rows = reg.histogram(
            "svgd_serve_batch_rows", "rows per dispatched batch",
            buckets=_BATCH_ROW_BUCKETS)
        # lane-labelled series (per-instance + per-lane labels): counters
        # for fairness, and an in-flight gauge a stuck lane pins nonzero
        self._m_lane_batches = reg.counter(
            "svgd_serve_lane_batches_total", "batches dispatched per lane")
        self._m_lane_requests = reg.counter(
            "svgd_serve_lane_requests_total", "requests resolved per lane")
        self._m_lane_rows = reg.counter(
            "svgd_serve_lane_rows_total", "rows dispatched per lane")
        self._m_lane_inflight = reg.gauge(
            "svgd_serve_lane_inflight_rows",
            "rows currently inside a lane's dispatch (0 when idle; a lane "
            "stuck in a hung device call stays nonzero)")
        # multi-tenant series
        self._m_quota_shed = reg.counter(
            "svgd_serve_quota_sheds_total",
            "requests shed by quota priority (tenant over its "
            "inflight-rows quota when the bounded queue filled)")
        self._m_tenant_queued = reg.gauge(
            "svgd_serve_tenant_queued_rows",
            "rows queued per tenant, not yet dispatched")
        # live capacity knobs: last-write-wins gauges so the
        # autoscale controller's retunes are scrapeable next to the load
        # they reacted to
        self._m_lanes = reg.gauge(
            "svgd_serve_lanes", "live dispatch-lane target per batcher")
        self._m_max_wait = reg.gauge(
            "svgd_serve_max_wait_ms", "live coalescing window per batcher")
        self._m_lanes.set(self.lanes, batcher=self.metrics_instance)
        self._m_max_wait.set(self._max_wait_s * 1e3,
                             batcher=self.metrics_instance)

        self._threads: List[threading.Thread] = []
        # lane id -> its current worker thread (a retired-then-regrown lane
        # id gets a fresh thread; every thread ever spawned stays in
        # _threads so close() can join them all)
        self._lane_threads: Dict[int, threading.Thread] = {}
        self._started = False
        if autostart:
            self.start()

    # ------------------------------------------------------------------ #
    # client side

    def submit(self, x, tenant: Optional[str] = None,
               trace: Optional[str] = None) -> Future:
        """Enqueue one request; returns a ``Future`` resolving to the dispatch
        output dict sliced back to this request's rows.

        ``tenant`` tags the request with a tenant identity: it rides the
        same bounded queue but only coalesces with its own tenant's chunks,
        dispatches as ``dispatch(x, tenant)``, and participates in the
        quota shed priorities (module docstring).

        ``trace`` is the cross-process trace id this request
        belongs to (the HTTP layer extracts it from ``X-Fleet-Trace``);
        it tags the request's lane tree so ``trace_report --stitch`` can
        join this hop to the router's.  While tracing is enabled, a
        trace-less request **mints its own id** — propagation cost is then
        always inside the telemetry-overhead A/B ceiling, and standalone
        serving traces stay self-joinable.

        Raises :class:`Overloaded` when accepting the request would push the
        queue past ``max_queue_rows`` (all-or-nothing: a request is never
        partially enqueued), and ``RuntimeError`` after :meth:`close`.
        """
        x = np.asarray(x)
        if x.ndim != 2 or x.shape[0] == 0:
            raise ValueError(f"expected a non-empty (rows, features) array, got {x.shape}")
        rows = x.shape[0]
        tracer = _trace.get_tracer()
        if trace is None and tracer is not None:
            trace = _trace.mint_trace_id()
        tl = {} if tenant is None else {"tenant": tenant}
        shed_futures: List[Future] = []
        shed_err: Optional[Overloaded] = None
        try:
            with self._cond:
                if not self._open:
                    raise RuntimeError("batcher is closed")
                if self._quota_mode == "admission" and tenant is not None:
                    quota = self._quota_for(tenant)
                    if (quota is not None
                            and self._tenant_queued.get(tenant, 0) + rows
                            > quota):
                        # admission-time quota: while the
                        # controller holds quotas tightened, an over-quota
                        # tenant is refused BEFORE it occupies queue rows
                        # other tenants will wait behind
                        self._n_shed += 1
                        self._quota_sheds[tenant] = (
                            self._quota_sheds.get(tenant, 0) + 1)
                        self._m_shed.inc(**tl)
                        self._m_quota_shed.inc(tenant=tenant)
                        raise Overloaded(
                            f"tenant {tenant!r} is over its inflight-rows "
                            f"quota ({quota}, admission-enforced); retry "
                            "with backoff",
                            retry_after_s=self._retry_after_s_locked(),
                        )
                if self._queued_rows + rows > self.max_queue_rows:
                    quota = self._quota_for(tenant)
                    if (quota is not None
                            and self._tenant_queued.get(tenant, 0) + rows
                            > quota):
                        # the submitter is itself over quota while the
                        # queue is full: IT is the first shed victim
                        self._n_shed += 1
                        self._quota_sheds[tenant] = (
                            self._quota_sheds.get(tenant, 0) + 1)
                        self._m_shed.inc(**tl)
                        self._m_quota_shed.inc(tenant=tenant)
                        raise Overloaded(
                            f"queue full and tenant {tenant!r} is over its "
                            f"inflight-rows quota ({quota}); retry with "
                            "backoff",
                            retry_after_s=self._retry_after_s_locked(),
                        )
                    shed_futures, shed_err = self._shed_over_quota_locked(
                        self._queued_rows + rows - self.max_queue_rows)
                    if self._queued_rows + rows > self.max_queue_rows:
                        self._n_shed += 1
                        self._m_shed.inc(**tl)
                        raise Overloaded(
                            f"queue full ({self._queued_rows} rows queued, "
                            f"request of {rows} would exceed max_queue_rows="
                            f"{self.max_queue_rows}); retry with backoff",
                            retry_after_s=self._retry_after_s_locked(),
                        )
                # progressive delivery: assign the request a generation via
                # the rollout's deterministic hash split (nested threshold
                # — an assignment never flaps backwards as stages widen),
                # and flag incumbent requests for shadow mirroring.  The
                # submit ordinal is the hash key: pure, replayable, and
                # uniform across tenants' interleaving
                generation = None
                mirror = False
                ro = self._rollout
                if ro is not None and ro.active and tenant == ro.tenant:
                    seq = self._submit_seq
                    self._submit_seq += 1
                    if ro.assign(seq) == "candidate":
                        generation = "candidate"
                    else:
                        mirror = ro.should_mirror(seq)
                n_chunks = -(-rows // self.max_batch)
                req = _Request(n_chunks, self._clock(),
                               tracer.now() if tracer is not None else None,
                               tracer, tenant, trace, generation, mirror)
                for i in range(n_chunks):
                    chunk = x[i * self.max_batch : (i + 1) * self.max_batch]
                    self._queue.append(_Chunk(chunk, req, i))
                self._queued_rows += rows
                if tenant is not None:
                    self._tenant_queued[tenant] = (
                        self._tenant_queued.get(tenant, 0) + rows)
                    self._m_tenant_queued.set(
                        self._tenant_queued[tenant],
                        batcher=self.metrics_instance, tenant=tenant)
                self._m_queue_depth.set(self._queued_rows,
                                        batcher=self.metrics_instance)
                self._cond.notify_all()
                return req.future
        finally:
            # resolve priority-shed victims OUTSIDE the condition lock:
            # their done-callbacks (client retry logic) may re-enter
            # submit(), which would deadlock on the non-reentrant lock
            for fut in shed_futures:
                try:
                    fut.set_exception(shed_err)
                except InvalidStateError:
                    pass

    def _retry_after_s_locked(self) -> float:
        """Estimated seconds until the current backlog admits a retry:
        ``(1 + ceil(ceil(queued_rows / max_batch) / lanes)) · max_wait_s``
        — the queue drains at worst one ``max_batch`` batch *per lane* per
        coalescing window, and the retry itself waits one more window.
        Every term is read LIVE at shed time: after the
        autoscale controller retunes ``max_wait_ms`` or the lane count,
        the next shed's Retry-After describes the batcher as it now runs,
        not as it was built.  Floored at 1 ms so a zero-wait batcher
        still emits a positive hint."""
        batches = -(-self._queued_rows // self.max_batch)
        windows = -(-batches // max(self.lanes, 1))
        return (1 + windows) * max(self._max_wait_s, 1e-3)

    def _quota_for(self, tenant: Optional[str]) -> Optional[int]:
        if tenant is None or not self._quotas:
            return None
        return self._quotas.get(tenant)

    def _shed_over_quota_locked(self, needed: int):
        """Free ≥ ``needed`` queued rows by shedding whole queued requests
        of over-quota tenants, newest first (they waited least), each
        tenant only down to its quota.  Call under the condition lock;
        returns ``(victim futures, the Overloaded to fail them with)`` —
        the caller resolves them after releasing the lock."""
        if needed <= 0 or not self._quotas:
            return [], None
        victims: List[_Request] = []
        victim_ids = set()
        freed = 0
        for chunk in reversed(self._queue):
            if freed >= needed:
                break
            req = chunk.req
            t = req.tenant
            if t is None or id(req) in victim_ids:
                continue
            quota = self._quotas.get(t)
            if quota is None or self._tenant_queued.get(t, 0) <= quota:
                continue
            req_rows = sum(c.x.shape[0] for c in self._queue if c.req is req)
            victim_ids.add(id(req))
            victims.append(req)
            self._tenant_queued[t] = max(
                0, self._tenant_queued.get(t, 0) - req_rows)
            freed += req_rows
        if not victims:
            return [], None
        # _locked contract: submit() holds self._cond for this whole
        # helper (the Condition lock is non-reentrant, so re-taking it
        # here would deadlock)
        self._queue = deque(
            c for c in self._queue if id(c.req) not in victim_ids)
        self._queued_rows -= freed
        for req in victims:
            self._n_shed += 1
            self._quota_sheds[req.tenant] = (
                self._quota_sheds.get(req.tenant, 0) + 1)
            self._m_shed.inc(tenant=req.tenant)
            self._m_quota_shed.inc(tenant=req.tenant)
            self._m_tenant_queued.set(
                self._tenant_queued.get(req.tenant, 0),
                batcher=self.metrics_instance, tenant=req.tenant)
        self._m_queue_depth.set(self._queued_rows,
                                batcher=self.metrics_instance)
        err = Overloaded(
            "shed by quota priority: tenant over its inflight-rows quota "
            "when the bounded queue filled; retry with backoff",
            retry_after_s=self._retry_after_s_locked(),
        )
        return [r.future for r in victims], err

    # ------------------------------------------------------------------ #
    # worker side

    def start(self) -> None:
        with self._cond:
            self._started = True
            target = self.lanes
        self._spawn_lanes(target)

    def _spawn_lanes(self, target: int) -> None:
        """Ensure a live worker thread exists for every lane id below
        ``target`` (idempotent; called outside the condition lock — thread
        starts must not run under it)."""
        for lane in range(target):
            t = self._lane_threads.get(lane)
            if t is None or not t.is_alive():
                t = threading.Thread(
                    target=self._loop, args=(lane,),
                    name=f"microbatcher-l{lane}", daemon=True,
                )
                self._lane_threads[lane] = t
                self._threads.append(t)
                t.start()

    def set_lanes(self, lanes: int) -> int:
        """Retune the dispatch-lane count LIVE.  Growing spawns workers for the missing lane
        ids; shrinking retires the highest lanes — each retiring worker
        finishes its in-flight batch, re-checks the target, and exits
        (never mid-dispatch, never holding queued work: the surviving
        lanes drain the shared queue).  Lock-safe against concurrent
        submits and collects; per-lane metric lists grow monotonically so
        a retired lane's counters stay visible.  Returns the previous
        target."""
        lanes = int(lanes)
        if lanes < 1:
            raise ValueError(f"lanes must be >= 1, got {lanes}")
        with self._cond:
            old = self.lanes
            self.lanes = lanes
            while len(self._lane_batches) < lanes:
                self._lane_batches.append(0)
                self._lane_requests.append(0)
                self._lane_rows.append(0)
            started = self._started
            # wake every parked worker: retiring lanes must notice the
            # shrunken target instead of sleeping in _collect forever
            self._cond.notify_all()
        self._m_lanes.set(lanes, batcher=self.metrics_instance)
        if started:
            self._spawn_lanes(lanes)
        return old

    @property
    def max_wait_ms(self) -> float:
        """The live coalescing window (milliseconds)."""
        return self._max_wait_s * 1e3

    def set_max_wait_ms(self, max_wait_ms: float) -> float:
        """Retune the coalescing window LIVE.  Collectors re-derive their
        flush deadline from the live window on every wakeup, so a retune
        takes effect for batches already coalescing, and
        :class:`Overloaded` drain estimates computed after it are honest
        about the new window.  Returns the previous window (ms)."""
        if max_wait_ms < 0:
            raise ValueError(f"max_wait_ms must be >= 0, got {max_wait_ms}")
        with self._cond:
            old = self._max_wait_s * 1e3
            self._max_wait_s = float(max_wait_ms) / 1e3
            self._cond.notify_all()
        self._m_max_wait.set(float(max_wait_ms),
                             batcher=self.metrics_instance)
        return old

    def queued_rows(self) -> int:
        """Rows queued and not yet collected into a batch (the controller's
        cheap backlog probe — no full :meth:`stats` snapshot)."""
        with self._cond:
            return self._queued_rows

    @property
    def quota_mode(self) -> str:
        """``'overflow'`` (quotas bite only when the queue fills — the
        default) or ``'admission'`` (over-quota tenants refused
        at submit time)."""
        return self._quota_mode

    def set_quota_mode(self, mode: str) -> str:
        """Switch quota enforcement LIVE.  The autoscale
        controller runs ``'admission'`` exactly while quotas are
        tightened under overload — a flooding tenant then cannot occupy
        queue rows that bound every other tenant's delay — and restores
        ``'overflow'`` with the base quotas.  Returns the previous mode."""
        if mode not in ("overflow", "admission"):
            raise ValueError(
                f"quota mode must be 'overflow' or 'admission', got {mode!r}")
        with self._cond:
            old = self._quota_mode
            self._quota_mode = mode
        return old

    @property
    def rollout(self):
        """The armed :class:`~dist_svgd_torch.rollout.RolloutController`
        (None outside a rollout)."""
        return self._rollout

    def set_rollout(self, controller) -> None:
        """Arm (or with ``None`` disarm) the progressive-delivery hook
        LIVE.  While armed, every arriving request of the
        controller's tenant is hash-assigned a generation (candidate
        requests dispatch against the staged candidate and carry
        ``generation="candidate"`` serve labels) and incumbent requests
        may be shadow-mirrored.  Requests already queued keep the
        assignment they got at submit time — disarming mid-flight is
        safe (candidate batches fall back to the incumbent dispatch)."""
        with self._cond:
            self._rollout = controller

    def _collect(self, lane: int = 0) -> Optional[List[_Chunk]]:
        """Block until a batch is ready (max_batch reached, max_wait expired,
        or draining); None once closed and drained — or once this lane's id
        is at or past the live lane target (retirement, ``set_lanes``)."""
        with self._cond:
            while True:
                while (not self._queue and self._open
                       and lane < self.lanes):
                    self._wait(self._cond, None)
                if lane >= self.lanes:
                    # retired by set_lanes (the queue, if any, belongs to
                    # the surviving lanes).  Deregister NOW, under the
                    # lock: a shrink-then-regrow racing this thread's
                    # actual exit would otherwise see it still alive and
                    # skip respawning the lane — a silently dead lane id
                    # below the live target
                    if self._lane_threads.get(lane) is threading.current_thread():
                        del self._lane_threads[lane]
                    return None
                if not self._queue:
                    return None  # closed and drained
                # the deadline reads the LIVE window each pass so a
                # set_max_wait_ms retune applies to batches mid-coalesce
                while self._open and self._queue and self._queued_rows < self.max_batch:
                    remaining = (self._queue[0].req.enqueued
                                 + self._max_wait_s) - self._clock()
                    if remaining <= 0:
                        break
                    self._wait(self._cond, remaining)
                if not self._queue:
                    continue  # drained under us (close(drain=False))
                batch: List[_Chunk] = []
                rows = 0
                # one batch = one (tenant, generation): different tenants
                # hit different engines/shapes, and a candidate-split chunk
                # dispatches against a different resident ensemble than an
                # incumbent one — fusing across either would be wrong, not
                # just slow (a foreign chunk ends the batch; the next
                # _collect — or another lane — picks it up)
                head_tenant = self._queue[0].req.tenant
                head_gen = self._queue[0].req.generation
                while (self._queue
                       and rows + self._queue[0].x.shape[0] <= self.max_batch
                       and self._queue[0].req.tenant == head_tenant
                       and self._queue[0].req.generation == head_gen):
                    chunk = self._queue.popleft()
                    batch.append(chunk)
                    rows += chunk.x.shape[0]
                self._queued_rows -= rows
                if head_tenant is not None:
                    self._tenant_queued[head_tenant] = max(
                        0, self._tenant_queued.get(head_tenant, 0) - rows)
                    self._tenant_inflight[head_tenant] = (
                        self._tenant_inflight.get(head_tenant, 0) + rows)
                    self._m_tenant_queued.set(
                        self._tenant_queued[head_tenant],
                        batcher=self.metrics_instance, tenant=head_tenant)
                self._m_queue_depth.set(self._queued_rows,
                                        batcher=self.metrics_instance)
                return batch

    def _run_batch(self, batch: List[_Chunk], lane: int = 0) -> None:
        rows = sum(c.x.shape[0] for c in batch)
        lane_label = f"l{lane}"
        # _collect guarantees a single-(tenant, generation) batch;
        # tenant-less batches keep the unlabelled metric series
        # (single-tenant deployments are byte-identical).  Candidate-split
        # batches add generation="candidate" to every dispatch-side serve
        # series — the rollout's SLO engine judges that label set alone,
        # so candidate and incumbent never dilute each other's windows
        tenant = batch[0].req.tenant
        generation = batch[0].req.generation
        ro = self._rollout
        tl = {} if tenant is None else {"tenant": tenant}
        gl = tl if generation is None else {**tl, "generation": generation}
        tracer = _trace.get_tracer()
        t0 = self._clock()
        t_pop = tracer.now() if tracer is not None else 0.0
        queue_wait_ms = (t0 - min(c.req.enqueued for c in batch)) * 1e3
        # a one-chunk batch dispatches its chunk as is: the copy would also
        # drop the GIL inside the measured dispatch window, where a client
        # thread's whole submit then runs
        x = (batch[0].x if len(batch) == 1
             else np.concatenate([c.x for c in batch], axis=0))
        self._m_lane_inflight.set(rows, batcher=self.metrics_instance,
                                  lane=lane_label, **gl)
        # thread the trace id through the dispatch via the trace context
        # (the engine's spans tag themselves from it — same mechanics as
        # the tenant label, but per-request): only when the whole batch
        # belongs to ONE trace is the context unambiguous
        batch_traces = {c.req.trace for c in batch}
        ctx_trace = (batch_traces.pop() if len(batch_traces) == 1 else None)
        prev_ctx = (_trace.set_trace_context(ctx_trace)
                    if ctx_trace is not None else None)
        t_disp0 = tracer.now() if tracer is not None else 0.0
        try:
            if generation == "candidate" and ro is not None:
                # candidate-split batch: dispatch against the staged
                # candidate generation (the controller falls back to the
                # incumbent if a rollback raced this batch — the client
                # gets an answer either way)
                out = ro.dispatch_candidate(x, tenant)
            else:
                out = (self._dispatch(x) if tenant is None
                       else self._dispatch(x, tenant))
        except Exception as e:
            with self._cond:
                self._n_errors += 1
                if tenant is not None:
                    self._tenant_inflight[tenant] = max(
                        0, self._tenant_inflight.get(tenant, 0) - rows)
            self._m_errors.inc(**gl)
            self._m_lane_inflight.set(0, batcher=self.metrics_instance,
                                      lane=lane_label, **gl)
            for c in batch:
                try:
                    c.req.future.set_exception(e)
                except InvalidStateError:
                    # another lane resolved a sibling chunk's request (a
                    # split request erroring in two batches at once) —
                    # first resolution wins, and losing must not kill
                    # this lane thread
                    pass
            return
        finally:
            if ctx_trace is not None:
                _trace.set_trace_context(prev_ctx)
        t_disp1 = tracer.now() if tracer is not None else 0.0
        self._m_lane_inflight.set(0, batcher=self.metrics_instance,
                                  lane=lane_label, **gl)
        device_ms = (self._clock() - t0) * 1e3
        now = self._clock()
        with self._cond:
            # chunk reassembly UNDER the lock: with lanes > 1, the chunks
            # of one split request can finish in different lanes at the
            # same moment — the write-then-completeness-check must be
            # atomic so exactly ONE lane observes the final fill (else
            # both count the request and race future.set_result)
            done_requests = []
            mirrors = []
            offset = 0
            for c in batch:
                n = c.x.shape[0]
                c.req.parts[c.index] = {
                    k: v[offset : offset + n] for k, v in out.items()
                }
                if c.req.mirror and ro is not None:
                    # shadow mirror: hand this chunk's input + incumbent
                    # answer to the rollout's background worker AFTER the
                    # lock drops — the controller copies and never blocks,
                    # so the client's critical path is untouched
                    mirrors.append((c.x, c.req.parts[c.index]))
                offset += n
                if all(p is not None for p in c.req.parts):
                    done_requests.append(c.req)
            if tenant is not None:
                self._tenant_inflight[tenant] = max(
                    0, self._tenant_inflight.get(tenant, 0) - rows)
            self._n_batches += 1
            self._occupancy.append(rows)
            self._requests_per_batch.append(len(batch))
            self._queue_wait_ms.append(queue_wait_ms)
            self._device_ms.append(device_ms)
            self._lane_batches[lane] += 1
            self._lane_rows[lane] += rows
            latencies = []
            for req in done_requests:
                self._n_requests += 1
                n_rows = sum(p[next(iter(p))].shape[0] for p in req.parts)
                self._n_rows += n_rows
                lat_ms = (now - req.enqueued) * 1e3
                self._latency_ms.append(lat_ms)
                latencies.append((req, n_rows, lat_ms))
            self._lane_requests[lane] += len(latencies)
        for mx, mout in mirrors:
            ro.mirror(mx, mout)
        self._m_batches.inc(**gl)
        self._m_batch_rows.observe(rows, **gl)
        self._m_queue_wait.observe(queue_wait_ms / 1e3, **gl)
        self._m_device.observe(device_ms / 1e3, **gl)
        self._m_lane_batches.inc(batcher=self.metrics_instance,
                                 lane=lane_label, **gl)
        self._m_lane_rows.inc(rows, batcher=self.metrics_instance,
                              lane=lane_label, **gl)
        if latencies:
            self._m_lane_requests.inc(len(latencies),
                                      batcher=self.metrics_instance,
                                      lane=lane_label, **gl)
        for req, n_rows, lat_ms in latencies:
            self._m_requests.inc(**gl)
            self._m_rows.inc(n_rows, **gl)
            self._m_latency.observe(lat_ms / 1e3, **gl)
        meter = _usage.get_meter()
        if meter is not None:
            # the cost ledger: same measured device window the histogram
            # above observed, so usage and latency accounting agree by
            # construction; queue-seconds are summed over the requests
            # COMPLETED by this batch (their wait ended at this t0)
            meter.record_batch(
                tenant=tenant, generation=generation, rows=rows,
                device_s=device_ms / 1e3,
                queue_s=sum(max(t0 - req.enqueued, 0.0)
                            for req, _, _ in latencies),
                requests=len(latencies))
        if tracer is not None:
            # one lane tree per completed request: the cross-thread
            # enqueue→reply lifetime with the queue-wait / coalesce /
            # dispatch split of its final batch (a split oversize request
            # reports the batch that completed it; n_chunks tags that)
            t_reply = tracer.now()
            for req, n_rows, _lat in latencies:
                # only trust an enqueue stamp from THIS tracer: a request
                # submitted under an earlier (since-disabled) tracer carries
                # another epoch's timestamp
                enq = (req.trace_enq
                       if req.trace_src is tracer and req.trace_enq is not None
                       else t_pop)
                attrs = {"rows": n_rows, "n_chunks": req.n_chunks,
                         "batch_rows": rows, "batch_requests": len(batch),
                         "lane": lane_label}
                if tenant is not None:
                    attrs["tenant"] = tenant
                if generation is not None:
                    attrs["generation"] = generation
                if req.trace is not None:
                    # the cross-process join key: trace_report --stitch
                    # matches this tree to the router's fleet.route on it
                    attrs["trace"] = req.trace
                tracer.lane_tree(
                    "serve.request", enq, t_reply, attrs,
                    children=[
                        ("serve.queue_wait", enq, t_pop, None),
                        ("serve.coalesce", t_pop, t_disp0,
                         {"requests": len(batch), "rows": rows}),
                        ("serve.dispatch", t_disp0, t_disp1,
                         {"rows": rows, "lane": lane_label}),
                    ],
                )
        if self._logger is not None:
            self._logger.log(
                event="batch",
                lane=lane_label,
                rows=rows,
                requests=len(batch),
                queue_wait_ms=round(queue_wait_ms, 3),
                device_ms=round(device_ms, 3),
                **({"tenant": tenant} if tenant is not None else {}),
            )
        for req, _rows, _lat in latencies:
            keys = req.parts[0].keys()
            result = {
                k: np.concatenate([p[k] for p in req.parts], axis=0) for k in keys
            }
            try:
                req.future.set_result(result)
            except InvalidStateError:
                # already failed by a sibling chunk's dispatch error (the
                # completion check above makes this lane the only
                # *resolver*, but an error lane may have beaten it)
                pass

    def _loop(self, lane: int = 0) -> None:
        while True:
            batch = self._collect(lane)
            if batch is None:
                return
            self._run_batch(batch, lane)

    # ------------------------------------------------------------------ #
    # lifecycle / metrics

    def close(self, drain: bool = True, timeout: Optional[float] = 30.0) -> None:
        """Stop accepting requests.  ``drain=True`` (graceful) dispatches
        everything already queued before the worker exits; ``drain=False``
        cancels queued requests with ``CancelledError``."""
        with self._cond:
            self._open = False
            if not drain:
                cancelled = {c.req for c in self._queue}
                self._queue.clear()
                self._queued_rows = 0
                # zero the per-tenant gauges BEFORE dropping the state:
                # a stale nonzero queued-rows series on the shared
                # registry would outlive the batcher
                for t in self._tenant_queued:
                    self._m_tenant_queued.set(
                        0, batcher=self.metrics_instance, tenant=t)
                self._m_queue_depth.set(0, batcher=self.metrics_instance)
                self._tenant_queued.clear()
                for req in cancelled:
                    if not req.future.done():
                        req.future.set_exception(CancelledError("batcher closed"))
            self._cond.notify_all()
        for t in self._threads:
            t.join(timeout=timeout)

    def tenant_queued_rows(self, tenant: str) -> int:
        """Rows of ``tenant`` queued and not yet collected into a batch."""
        with self._cond:
            return self._tenant_queued.get(tenant, 0)

    def tenant_pending_rows(self, tenant: str) -> int:
        """Rows of ``tenant`` still owed a result: queued PLUS collected-
        but-unresolved (the registry's drain condition on tenant removal —
        queued alone goes to zero while the last batch is between
        ``_collect`` and its dispatch, and removing the tenant in that
        window would fail the batch in the router)."""
        with self._cond:
            return (self._tenant_queued.get(tenant, 0)
                    + self._tenant_inflight.get(tenant, 0))

    def cancel_tenant(self, tenant: str) -> int:
        """Drop every queued chunk of ``tenant``; their futures fail with
        ``CancelledError``.  In-flight dispatches finish normally (their
        engine closure stays alive).  Returns the number of requests
        cancelled — the registry's ``remove_tenant(drain=False)`` path."""
        victims: List[_Request] = []
        with self._cond:
            victim_ids = set()
            dropped_rows = 0
            for c in self._queue:
                if c.req.tenant == tenant:
                    if id(c.req) not in victim_ids:
                        victim_ids.add(id(c.req))
                        victims.append(c.req)
                    dropped_rows += c.x.shape[0]
            if victim_ids:
                self._queue = deque(
                    c for c in self._queue if id(c.req) not in victim_ids)
                self._queued_rows -= dropped_rows
            self._tenant_queued.pop(tenant, None)
            self._m_tenant_queued.set(0, batcher=self.metrics_instance,
                                      tenant=tenant)
            self._m_queue_depth.set(self._queued_rows,
                                    batcher=self.metrics_instance)
        for req in victims:
            try:
                req.future.set_exception(
                    CancelledError(f"tenant {tenant!r} removed"))
            except InvalidStateError:
                pass
        return len(victims)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close(drain=True)

    def stats(self) -> Dict[str, Any]:
        """Aggregate serving metrics (bounded windows for the percentiles).

        Only the snapshot happens under the batcher's lock; the sorts run
        after release, so a /metrics poll never stalls submit() or the
        dispatch worker behind an O(window log window) sort."""
        with self._cond:
            lat = list(self._latency_ms)
            qw = list(self._queue_wait_ms)
            dv = list(self._device_ms)
            occ = list(self._occupancy)
            rpb = list(self._requests_per_batch)
            counters = {
                "requests": self._n_requests,
                "rows": self._n_rows,
                "batches": self._n_batches,
                "shed": self._n_shed,
                "dispatch_errors": self._n_errors,
                "queued_rows": self._queued_rows,
                "lanes": self.lanes,
                "lane_batches": {f"l{i}": v
                                 for i, v in enumerate(self._lane_batches)},
                "lane_requests": {f"l{i}": v
                                  for i, v in enumerate(self._lane_requests)},
                "lane_rows": {f"l{i}": v
                              for i, v in enumerate(self._lane_rows)},
                "quota_sheds": dict(self._quota_sheds),
                "tenant_queued": dict(self._tenant_queued),
            }
        lat.sort()
        qw.sort()
        dv.sort()
        return {
            **counters,
            "batch_occupancy_mean": float(np.mean(occ)) if occ else 0.0,
            "batch_occupancy_max": int(max(occ)) if occ else 0,
            "requests_per_batch_mean": float(np.mean(rpb)) if rpb else 0.0,
            "latency_p50_ms": _percentile(lat, 0.50),
            "latency_p99_ms": _percentile(lat, 0.99),
            "queue_wait_p50_ms": _percentile(qw, 0.50),
            "queue_wait_p99_ms": _percentile(qw, 0.99),
            "device_p50_ms": _percentile(dv, 0.50),
            "device_p99_ms": _percentile(dv, 0.99),
        }
