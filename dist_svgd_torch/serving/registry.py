"""Multi-tenant model registry: many posteriors served from one process.

Counterpart of ``dist_svgd_tpu/serving/registry.py`` (``KernelBucketLRU``,
``Tenant``, ``ModelRegistry``).  Heterogeneous checkpoints (logreg / BNN /
GMM, different shapes, steps, dtypes) are hosted as named **tenants**
behind one process:

- each tenant wraps its own :class:`~dist_svgd_torch.serving.engine.
  PredictiveEngine` plus an optional hot-reload watch over its own
  checkpoint root;
- ONE :class:`~dist_svgd_torch.serving.batcher.MicroBatcher` fronts all of
  them — one bounded queue, per-tenant coalescing, per-tenant quotas with
  shed priorities (a hog tenant sheds before polite ones when the queue
  fills);
- ONE scanner thread polls every tenant's checkpoint root in turn
  (:meth:`ModelRegistry.poll_once`) — a corrupt newest step or a
  health-rejected generation in one tenant leaves every other tenant
  serving;
- ONE process-wide :class:`KernelBucketLRU` bounds the built bucket
  programs across all tenants: every bucket use is touched, overflow
  evicts the least-recently-used bucket anywhere in the process
  (``svgd_registry_evictions_total{tenant=...}``) — and with it that
  bucket's CUDA graph and memory pool — so a cold tenant's programs are
  reclaimable while a hot tenant, touched every request, never loses a
  bucket to steady-state traffic.

Every serving metric the tenants write carries a ``tenant=`` label.  The
HTTP front end routes ``/predict`` on a ``tenant`` field and serves
``/tenants`` + per-tenant ``/healthz`` detail (``serving/server.py``); the
load generator is ``python -m dist_svgd_torch.tools.serve_bench --tenants
N``.  Progressive delivery (:meth:`ModelRegistry.begin_rollout`) arms one
tenant's :class:`~dist_svgd_torch.rollout.RolloutController` on the shared
batcher's split/mirror hook.
"""

from __future__ import annotations

import re
import threading
import time
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from dist_svgd_torch.serving.batcher import MicroBatcher
from dist_svgd_torch.serving.engine import (
    CheckpointHotReloader,
    PredictiveEngine,
)
from dist_svgd_torch.telemetry import metrics as _metrics

__all__ = ["KernelBucketLRU", "ModelRegistry", "Tenant"]

#: Tenant names become Prometheus label values and URL path segments —
#: keep them to a sane charset.
_TENANT_NAME_RE = re.compile(r"^[A-Za-z0-9][A-Za-z0-9_.\-]{0,63}$")

#: Default process-wide bound on compiled kernel buckets across tenants.
#: Generous for real fleets (a tenant serving ``rows ≤ max_batch`` traffic
#: touches a handful of buckets); the bench pins it tight to observe
#: eviction deterministically.
DEFAULT_MAX_TOTAL_BUCKETS = 64


class KernelBucketLRU:
    """Process-wide LRU over compiled kernel buckets across engines.

    Engines report every bucket use via :meth:`touch`; when the total
    tracked buckets exceed ``max_buckets``, the least-recently-used
    ``(engine, bucket)`` entry anywhere in the process is evicted — the
    owning engine drops its compiled kernel
    (:meth:`~dist_svgd_torch.serving.engine.PredictiveEngine.
    _evict_bucket`) and the next request on that bucket recompiles.  A
    hot bucket is touched on every request and is therefore never the
    LRU victim: eviction only ever costs a tenant that stopped using the
    bucket (the regression test drives a hot tenant under the capture
    sentry while cold tenants churn evictions around it).

    Lock order is strictly ``cache lock → engine lock`` (touch is called
    by engines OUTSIDE their own lock; the eviction callback takes the
    victim engine's lock after this cache's lock is released), so two
    tenants evicting each other cannot deadlock.
    """

    def __init__(self, max_buckets: int = DEFAULT_MAX_TOTAL_BUCKETS):
        if max_buckets < 1:
            raise ValueError(f"max_buckets must be >= 1, got {max_buckets}")
        self.max_buckets = int(max_buckets)
        self._lock = threading.Lock()
        # (id(engine), bucket) -> engine, in least-recently-used-first order
        self._entries: "OrderedDict[Tuple[int, int], Any]" = OrderedDict()
        self._evictions = 0

    def touch(self, engine, bucket: int) -> None:
        """Record one use of ``(engine, bucket)``; evict LRU overflow.

        Touches are reported after the engine's own lock is released, so
        a use and its touch are not one atomic step: a concurrent
        overflow in that sub-microsecond window can evict a bucket whose
        touch is still in flight (the in-flight call keeps its compiled
        fn reference — correctness is unaffected; the next call
        recompiles once).  Irrelevant in steady state — overflow only
        happens when a NEW bucket compiles, which warmed traffic never
        does — and only entries whose engine actually dropped a kernel
        count as evictions, so a late touch re-inserting an
        already-evicted key can never inflate the counter."""
        victims = []
        with self._lock:
            key = (id(engine), bucket)
            if key in self._entries:
                self._entries.move_to_end(key)
            else:
                self._entries[key] = engine
            while len(self._entries) > self.max_buckets:
                (_, victim_bucket), victim = self._entries.popitem(last=False)
                victims.append((victim, victim_bucket))
        # the callback takes the victim engine's lock — outside ours
        evicted = 0
        for victim, victim_bucket in victims:
            if victim._evict_bucket(victim_bucket):
                evicted += 1
        if evicted:
            with self._lock:
                self._evictions += evicted

    def forget(self, engine) -> int:
        """Drop every entry of ``engine`` without counting evictions —
        tenant removal, not cache pressure.  Returns entries dropped."""
        with self._lock:
            keys = [k for k in self._entries if k[0] == id(engine)]
            for k in keys:
                del self._entries[k]
            return len(keys)

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {"size": len(self._entries),
                    "max_buckets": self.max_buckets,
                    "evictions": self._evictions}


class Tenant:
    """One named model behind the registry: engine + optional reload watch.

    Constructed by :meth:`ModelRegistry.add_tenant`; treat as read-only.
    ``state`` is ``'serving'`` → ``'draining'`` → removed (a draining
    tenant refuses new submits while its queued work flushes).
    """

    def __init__(self, name: str, engine: PredictiveEngine,
                 reloader: Optional[CheckpointHotReloader],
                 quota_rows: Optional[int]):
        self.name = name
        self.engine = engine
        self.reloader = reloader
        self.quota_rows = quota_rows
        self.state = "serving"
        self.added_at = time.time()
        self.reload_errors = 0

    def summary(self) -> Dict[str, Any]:
        """The ``/tenants`` listing row (cheap: no engine lock churn
        beyond one ``stats()`` snapshot)."""
        st = self.engine.stats()
        return {
            "model": st["model"],
            "n_particles": st["n_particles"],
            "feature_dim": st["feature_dim"],
            "dtype": st["dtype"],
            "state": self.state,
            "quota_rows": self.quota_rows,
            "watched": self.reloader is not None,
            "loaded_step": (self.reloader.loaded_step
                            if self.reloader is not None
                            else self.engine.checkpoint_step),
            # generation identity: which generation answers
            # this tenant's traffic, and whether a rollback target /
            # rollout candidate is resident
            "generation_id": st["generation_id"],
            "previous_generation_id": st["previous_generation_id"],
            "candidate_generation_id": st["candidate_generation_id"],
        }


class ModelRegistry:
    """Host many named posteriors behind one batcher, scanner, and LRU.

    Args:
        metrics: ``telemetry.MetricsRegistry`` every component writes to
            (default: the process-wide one).  All serving series carry a
            ``tenant=`` label.
        max_total_buckets: process-wide bound on compiled kernel buckets
            across tenants (:class:`KernelBucketLRU`), or an existing
            ``KernelBucketLRU`` to share.
        max_batch / lanes / max_wait_ms / max_queue_rows: the shared
            :class:`~dist_svgd_torch.serving.batcher.MicroBatcher`'s knobs
            (one bounded queue for ALL tenants).
        scan_interval_s: background scanner cadence over the tenant
            checkpoint roots (:meth:`start_scanner`; :meth:`poll_once`
            drives it explicitly for tests/drivers).
        batcher_autostart: pass ``False`` to leave the batcher's lanes
            unstarted (deterministic queue-pressure tests and the bench's
            quota probe); call ``registry.batcher.start()`` when ready.
        logger: optional ``JsonlLogger`` shared by the tenant reloaders
            (one record per swap/reject).
    """

    def __init__(
        self,
        *,
        metrics: Optional[_metrics.MetricsRegistry] = None,
        max_total_buckets: Union[int, KernelBucketLRU] = (
            DEFAULT_MAX_TOTAL_BUCKETS),
        max_batch: int = 256,
        lanes: int = 1,
        max_wait_ms: float = 2.0,
        max_queue_rows: int = 8192,
        scan_interval_s: float = 5.0,
        batcher_autostart: bool = True,
        logger=None,
    ):
        self.metrics = (metrics if metrics is not None
                        else _metrics.default_registry())
        self.kernel_cache = (max_total_buckets
                             if isinstance(max_total_buckets, KernelBucketLRU)
                             else KernelBucketLRU(max_total_buckets))
        self._lock = threading.Lock()
        self._tenants: Dict[str, Tenant] = {}
        # live quota view the batcher reads under ITS lock on overflow;
        # mutated only via dict item ops (atomic under the GIL)
        self._quotas: Dict[str, Optional[int]] = {}
        self._logger = logger
        self._scan_interval_s = float(scan_interval_s)
        self._scan_stop = threading.Event()
        self._scan_thread: Optional[threading.Thread] = None
        self._closed = False
        self.batcher = MicroBatcher(
            self._route,
            max_batch=max_batch,
            lanes=lanes,
            max_wait_ms=max_wait_ms,
            max_queue_rows=max_queue_rows,
            quotas=self._quotas,
            registry=self.metrics,
            autostart=batcher_autostart,
        )
        self._m_tenants = self.metrics.gauge(
            "svgd_registry_tenants", "tenants currently hosted")
        self._m_reload_errors = self.metrics.counter(
            "svgd_registry_reload_errors_total",
            "scanner polls that raised for one tenant (others unaffected)")
        # progressive delivery: at most ONE rollout at a time
        # rides the shared batcher (its split/mirror hook is a single
        # seam); guarded by _lock
        self._rollout = None
        self._rollout_tenant: Optional[str] = None

    # ------------------------------------------------------------------ #
    # tenant lifecycle

    def add_tenant(
        self,
        name: str,
        model: str,
        *,
        particles=None,
        checkpoint: Union[str, Sequence[str], None] = None,
        quota_rows: Optional[int] = None,
        watch: bool = False,
        warm_buckets: Optional[List[int]] = None,
        **engine_kwargs,
    ) -> Tenant:
        """Register one named model.

        Exactly one of ``particles`` (an ``(n, d)`` ensemble array) or
        ``checkpoint`` (any layout ``PredictiveEngine.from_checkpoint``
        accepts) must be given.  ``quota_rows`` arms the shed-priority
        quota for this tenant; ``watch=True`` (requires a
        ``CheckpointManager``-root checkpoint) registers the tenant with
        the shared scanner so newer steps hot-swap in; ``warm_buckets``
        pre-traces the padding buckets those request sizes land in (off
        the request path — do it before taking traffic).  Remaining
        kwargs go to the engine (``plan=``, ``dtype=``,
        ``reload_policy=``, bucket bounds, model layout...).
        """
        if not _TENANT_NAME_RE.match(name or ""):
            raise ValueError(
                f"invalid tenant name {name!r} (want "
                f"{_TENANT_NAME_RE.pattern})"
            )
        if name == _metrics.OTHER_LABEL_VALUE:
            raise ValueError(
                f"tenant name {name!r} is reserved for the metrics "
                "cardinality-rollup series"
            )
        if (particles is None) == (checkpoint is None):
            raise ValueError("pass exactly one of particles= or checkpoint=")
        with self._lock:
            # cheap pre-checks before the expensive checkpoint load /
            # engine build (re-checked under the lock at insert — another
            # add may race this one)
            if self._closed:
                raise RuntimeError("registry is closed")
            if name in self._tenants:
                raise ValueError(f"tenant {name!r} already registered")
        engine_kwargs.setdefault("registry", self.metrics)
        if checkpoint is not None:
            source = (checkpoint if isinstance(checkpoint, (str, bytes))
                      or hasattr(checkpoint, "__fspath__")
                      else list(checkpoint))
            engine = PredictiveEngine.from_checkpoint(
                source, model, tenant=name,
                kernel_cache=self.kernel_cache, **engine_kwargs)
        else:
            engine = PredictiveEngine(
                model, particles, tenant=name,
                kernel_cache=self.kernel_cache, **engine_kwargs)
        reloader = None
        if watch:
            if checkpoint is None or not isinstance(
                    checkpoint, (str, bytes)) and not hasattr(
                    checkpoint, "__fspath__"):
                raise ValueError(
                    "watch=True needs a single CheckpointManager-root "
                    "checkpoint path"
                )
            reloader = CheckpointHotReloader(
                engine, checkpoint, logger=self._logger)
        tenant = Tenant(name, engine, reloader, quota_rows)
        with self._lock:
            if self._closed:
                raise RuntimeError("registry is closed")
            if name in self._tenants:
                raise ValueError(f"tenant {name!r} already registered")
            self._tenants[name] = tenant
            self._quotas[name] = quota_rows
            n_tenants = len(self._tenants)
        self._m_tenants.set(n_tenants)
        if warm_buckets:
            engine.warmup(list(warm_buckets))
        return tenant

    def remove_tenant(self, name: str, *, drain: bool = True,
                      timeout: float = 30.0) -> None:
        """Deregister ``name``.

        ``drain=True`` stops admission for the tenant, waits for its
        queued rows to flush through the batcher (in-flight dispatches
        always finish — the engine closure outlives the registry entry),
        then drops it.  ``drain=False`` cancels its queued requests with
        ``CancelledError`` immediately.  Either way the shared LRU
        forgets the tenant's buckets (without counting evictions) and
        other tenants never notice.
        """
        with self._lock:
            tenant = self._tenants.get(name)
            if tenant is None:
                raise KeyError(f"unknown tenant {name!r}")
            tenant.state = "draining"
            # quota off during the drain: its remaining queued work must
            # not be priority-shed on the way out
            self._quotas.pop(name, None)
        # a rollout targeting the removed tenant ends with it: disarm the
        # batcher hook BEFORE the drain so no still-arriving request is
        # hash-split to a candidate that is about to disappear (queued
        # candidate batches fall back to the incumbent dispatch)
        rollout = None
        with self._lock:
            if self._rollout_tenant == name:
                rollout = self._rollout
                self._rollout = None
                self._rollout_tenant = None
        if rollout is not None:
            self.batcher.set_rollout(None)
            try:
                rollout.close()
            except Exception:
                pass
        if drain:
            # pending = queued + collected-but-unresolved: the tenant must
            # stay routable until its LAST batch resolved, not just until
            # its queue emptied (a batch between _collect and dispatch
            # would otherwise KeyError in _route)
            deadline = time.monotonic() + timeout
            while self.batcher.tenant_pending_rows(name) > 0:
                if time.monotonic() >= deadline:
                    raise TimeoutError(
                        f"tenant {name!r} still has pending rows after "
                        f"{timeout}s drain"
                    )
                time.sleep(0.002)
        else:
            self.batcher.cancel_tenant(name)
        with self._lock:
            self._tenants.pop(name, None)
            n_tenants = len(self._tenants)
        self.kernel_cache.forget(tenant.engine)
        self._m_tenants.set(n_tenants)

    def set_quota(self, name: str, quota_rows: Optional[int]) -> None:
        """Retune one tenant's inflight-rows quota live."""
        with self._lock:
            tenant = self._tenants.get(name)
            if tenant is None:
                raise KeyError(f"unknown tenant {name!r}")
            tenant.quota_rows = quota_rows
            self._quotas[name] = quota_rows

    def quota_snapshot(self) -> Dict[str, Optional[int]]:
        """The current per-tenant quota mapping (a copy — the live view
        the batcher reads is internal).  The autoscale controller
        snapshots base quotas from here before tightening them."""
        with self._lock:
            return dict(self._quotas)

    def tenant(self, name: str) -> Tenant:
        with self._lock:
            tenant = self._tenants.get(name)
        if tenant is None:
            raise KeyError(f"unknown tenant {name!r}")
        return tenant

    def tenant_names(self) -> List[str]:
        with self._lock:
            return sorted(self._tenants)

    def __len__(self) -> int:
        with self._lock:
            return len(self._tenants)

    def __contains__(self, name: str) -> bool:
        with self._lock:
            return name in self._tenants

    # ------------------------------------------------------------------ #
    # progressive delivery

    def begin_rollout(self, name: str, *, plan=None, clock=None,
                      controller=None):
        """Arm a progressive rollout for tenant ``name`` and return its
        :class:`~dist_svgd_torch.rollout.RolloutController`.

        Builds a controller over the tenant's engine (or takes a
        pre-built ``controller`` — drills that inject clocks/plans), arms
        the shared batcher's split/mirror hook, and leaves offering
        candidates to the caller (``controller.offer(...)`` — typically
        the streaming supervisor's publish leg).  At most one rollout
        rides the batcher at a time; a second ``begin_rollout`` while one
        is armed raises unless it targets the same tenant (idempotent —
        returns the armed controller)."""
        from dist_svgd_torch.rollout import RolloutController

        with self._lock:
            tenant = self._tenants.get(name)
            if tenant is None:
                raise KeyError(f"unknown tenant {name!r}")
            if tenant.state != "serving":
                raise KeyError(f"tenant {name!r} is {tenant.state}")
            if self._rollout is not None:
                if self._rollout_tenant == name:
                    return self._rollout
                raise RuntimeError(
                    f"a rollout is already armed for tenant "
                    f"{self._rollout_tenant!r}; end it first")
            if controller is None:
                kwargs = {"plan": plan, "metrics": self.metrics,
                          "logger": self._logger}
                if clock is not None:
                    kwargs["clock"] = clock
                controller = RolloutController(tenant.engine, **kwargs)
            self._rollout = controller
            self._rollout_tenant = name
        self.batcher.set_rollout(controller)
        return controller

    def end_rollout(self, name: str) -> None:
        """Disarm tenant ``name``'s rollout (idempotent).  An in-flight
        candidate is dropped (the incumbent was serving the split's
        complement all along and takes back 100%)."""
        with self._lock:
            if self._rollout_tenant != name:
                return
            rollout = self._rollout
            self._rollout = None
            self._rollout_tenant = None
        self.batcher.set_rollout(None)
        if rollout is not None:
            try:
                if rollout.active:
                    rollout.engine.drop_candidate()
            finally:
                rollout.close()

    def rollout_status(self) -> Optional[Dict[str, Any]]:
        """The armed rollout's controller document (None when idle)."""
        with self._lock:
            rollout, tenant = self._rollout, self._rollout_tenant
        if rollout is None:
            return None
        return {"tenant": tenant, **rollout.status()}

    # ------------------------------------------------------------------ #
    # request path

    def submit(self, name: str, x, trace: Optional[str] = None):
        """Enqueue one request for tenant ``name``; returns the future.
        ``trace`` is the cross-process trace id (see
        :meth:`MicroBatcher.submit`) — the HTTP layer passes the
        ``X-Fleet-Trace`` header through here."""
        with self._lock:
            tenant = self._tenants.get(name)
        if tenant is None:
            raise KeyError(f"unknown tenant {name!r}")
        if tenant.state != "serving":
            raise KeyError(f"tenant {name!r} is {tenant.state}")
        return self.batcher.submit(x, tenant=name, trace=trace)

    def predict(self, name: str, x, timeout: Optional[float] = 30.0):
        """Blocking convenience: ``submit(...).result(timeout)``."""
        return self.submit(name, x).result(timeout=timeout)

    def _route(self, x: np.ndarray, tenant: str):
        """The shared batcher's dispatch: one single-tenant coalesced
        batch → that tenant's engine.  ``remove_tenant(drain=True)``
        keeps the entry until the tenant's pending rows (queued AND
        in-flight) hit zero, so a drained removal never lands here; a
        ``drain=False`` removal racing a collected batch fails just that
        tenant's futures (KeyError → 503 at the HTTP layer)."""
        with self._lock:
            t = self._tenants.get(tenant)
        if t is None:
            raise KeyError(f"tenant {tenant!r} was removed")
        return t.engine.predict(x)

    def warm(self, batch_sizes: Optional[Sequence[int]] = None
             ) -> Dict[str, List[int]]:
        """Pre-trace every tenant's padding buckets for these request
        sizes (``None`` = each tenant's full bucket range) — the bench's
        steady-state precondition.  Returns the buckets compiled per
        tenant.  Mind the shared LRU: warming more total buckets than
        ``max_total_buckets`` evicts the earliest tenants' kernels."""
        with self._lock:
            tenants = list(self._tenants.values())
        return {t.name: t.engine.warmup(
                    list(batch_sizes) if batch_sizes is not None else None)
                for t in tenants}

    # ------------------------------------------------------------------ #
    # shared checkpoint scanner

    def poll_once(self) -> Dict[str, Optional[int]]:
        """One scan over every watched tenant root (the shared scanner's
        body; also the deterministic test/driver entrypoint).  Per-tenant
        isolation: a poll that raises (unreadable root, missing key) is
        counted and logged for THAT tenant only — every other tenant is
        still polled, and a failing tenant keeps serving its current
        generation.  Returns ``{tenant: newly served step or None}``."""
        with self._lock:
            watched = [t for t in self._tenants.values()
                       if t.reloader is not None and t.state == "serving"]
        out: Dict[str, Optional[int]] = {}
        for t in watched:
            try:
                out[t.name] = t.reloader.poll_once()
            except Exception as e:
                t.reload_errors += 1
                out[t.name] = None
                self._m_reload_errors.inc(tenant=t.name)
                if self._logger is not None:
                    try:
                        self._logger.log(event="tenant_reload_error",
                                         tenant=t.name,
                                         error=f"{type(e).__name__}: {e}")
                    except Exception:
                        pass
        return out

    def start_scanner(self) -> "ModelRegistry":
        """Start the ONE background scanner thread over all tenant roots."""
        if self._scan_thread is None:
            self._scan_stop.clear()
            self._scan_thread = threading.Thread(
                target=self._scan_loop, name="registry-scanner", daemon=True)
            self._scan_thread.start()
        return self

    def _scan_loop(self) -> None:
        while not self._scan_stop.is_set():
            self.poll_once()
            self._scan_stop.wait(self._scan_interval_s)

    def stop_scanner(self) -> None:
        self._scan_stop.set()
        if self._scan_thread is not None:
            self._scan_thread.join(timeout=10)
            self._scan_thread = None

    # ------------------------------------------------------------------ #
    # introspection / lifecycle

    def stats(self) -> Dict[str, Any]:
        """Per-tenant engine stats + shared cache/batcher view (the
        ``/metrics.json`` registry block)."""
        with self._lock:
            tenants = dict(self._tenants)
        # ONE batcher.stats() snapshot for every tenant's queued count —
        # a per-tenant lock round-trip would contend with the submit /
        # collect hot path N times per scrape
        bstats = self.batcher.stats()
        queued = bstats.get("tenant_queued", {})
        return {
            "tenants": {name: {**t.engine.stats(),
                               "state": t.state,
                               "quota_rows": t.quota_rows,
                               "queued_rows": queued.get(name, 0),
                               "reload_errors": t.reload_errors,
                               "loaded_step": (t.reloader.loaded_step
                                               if t.reloader is not None
                                               else t.engine.checkpoint_step)}
                        for name, t in tenants.items()},
            "kernel_cache": self.kernel_cache.stats(),
            "batcher": bstats,
        }

    def usage(self) -> Dict[str, Any]:
        """Per-tenant cost accounting (``telemetry/usage.py``): reads the
        active meter's registry when metering is enabled, else this
        registry's own metrics sink (whose missing ``svgd_usage_*``
        series yield an empty map — enable metering to populate it)."""
        from dist_svgd_torch.telemetry import usage as _usage

        meter = _usage.get_meter()
        reg = meter.registry if meter is not None else self.metrics
        return {"metering": meter is not None, **_usage.usage_summary(reg)}

    def health(self) -> Dict[str, Any]:
        """The ``/healthz`` aggregate: overall status + per-tenant rows."""
        with self._lock:
            tenants = dict(self._tenants)
        return {
            "status": "ok" if tenants else "empty",
            "tenants": {name: t.summary() for name, t in tenants.items()},
            "kernel_cache": self.kernel_cache.stats(),
        }

    def close(self, drain: bool = True) -> None:
        """Stop the scanner, drain (or cancel) the shared batcher, and
        refuse further tenant adds.  Engines stay usable directly."""
        with self._lock:
            self._closed = True
            rollout_tenant = self._rollout_tenant
        if rollout_tenant is not None:
            self.end_rollout(rollout_tenant)
        self.stop_scanner()
        self.batcher.close(drain=drain)

    def __enter__(self) -> "ModelRegistry":
        return self

    def __exit__(self, *exc) -> None:
        self.close(drain=True)
