"""Per-tenant usage metering: the serving path's cost ledger.

Counterpart of ``dist_svgd_tpu/telemetry/usage.py``, with its metric
names and summary layout.

The serving batcher observes per-tenant latency; this module adds the
accounting half: a process-global :class:`UsageMeter` (the tracer's
switchboard discipline — one module-global read when disabled) that the
batcher and the engine feed with **monotonic counters**, labelled per
tenant and, when the request pinned one, per generation:

- ``svgd_usage_device_seconds_total`` — dispatch wall the batch spent
  on the device (the batcher's measured window, the same number its
  ``svgd_serve_device_time_seconds`` histogram observes),
- ``svgd_usage_rows_total`` — rows served,
- ``svgd_usage_queue_seconds_total`` — summed per-request queue wait,
- ``svgd_usage_requests_total`` — requests completed,
- ``svgd_usage_compiles_total`` — program-cache misses (graph captures
  on the card; steady state holds this flat).

Counters mean the registry's plumbing works unchanged: its cardinality
guard caps runaway tenant labels and ``dump_delta`` gives reset-clamped
windows; replica-labelled series (a federated registry) feed the
per-replica breakdown of :func:`usage_summary`.

Each batch writes exactly one label set (``{}``, ``{tenant}``, or
``{tenant, generation}``) — the same convention as the batcher's
latency labels — so summing disjoint label sets partitions the total:
tenants sum to the totals as an accounting identity.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional

__all__ = [
    "DEVICE_SECONDS_TOTAL",
    "ROWS_TOTAL",
    "QUEUE_SECONDS_TOTAL",
    "REQUESTS_TOTAL",
    "COMPILES_TOTAL",
    "DEFAULT_TENANT",
    "UsageMeter",
    "enable_usage",
    "disable_usage",
    "get_meter",
    "usage_enabled",
    "usage_summary",
]

DEVICE_SECONDS_TOTAL = "svgd_usage_device_seconds_total"
ROWS_TOTAL = "svgd_usage_rows_total"
QUEUE_SECONDS_TOTAL = "svgd_usage_queue_seconds_total"
REQUESTS_TOTAL = "svgd_usage_requests_total"
COMPILES_TOTAL = "svgd_usage_compiles_total"

#: Summary key for work not pinned to a tenant (single-model servers) —
#: the JAX package's display convention.
DEFAULT_TENANT = "(default)"

#: Active meter or None; read once per batch by the serving feeds.
_METER: Optional["UsageMeter"] = None
_LOCK = threading.Lock()


class UsageMeter:
    """Monotonic per-tenant cost counters over one metrics registry.

    Pass the registry the serving server exposes (``/metrics.dump``) so
    the series federate; defaults to the process-wide registry.
    """

    def __init__(self, registry=None):
        from dist_svgd_torch.telemetry import metrics as _metrics

        self.registry = registry if registry is not None else _metrics.default_registry()
        self._m_device = self.registry.counter(
            DEVICE_SECONDS_TOTAL,
            "Device dispatch wall seconds consumed, by tenant/generation.")
        self._m_rows = self.registry.counter(
            ROWS_TOTAL, "Rows served, by tenant/generation.")
        self._m_queue = self.registry.counter(
            QUEUE_SECONDS_TOTAL,
            "Summed per-request queue wait seconds, by tenant/generation.")
        self._m_requests = self.registry.counter(
            REQUESTS_TOTAL, "Requests completed, by tenant/generation.")
        self._m_compiles = self.registry.counter(
            COMPILES_TOTAL,
            "Serving kernel-cache misses (compiles), by tenant/generation.")

    # feeds ---------------------------------------------------------- #

    def record_batch(self, *, tenant: Optional[str],
                     generation: Optional[str],
                     rows: int, device_s: float, queue_s: float,
                     requests: int) -> None:
        """One completed batch — called by the batcher with its own
        measured device window (so meter and latency histograms agree by
        construction)."""
        tl = {} if tenant is None else {"tenant": str(tenant)}
        gl = tl if generation is None else {**tl, "generation": str(generation)}
        self._m_device.inc(device_s, **gl)
        if rows:
            self._m_rows.inc(rows, **gl)
        if queue_s > 0.0:
            self._m_queue.inc(queue_s, **gl)
        if requests:
            self._m_requests.inc(requests, **gl)

    def record_compile(self, *, tenant: Optional[str] = None,
                       generation: Optional[str] = None) -> None:
        """One serving kernel compile (cache miss)."""
        tl = {} if tenant is None else {"tenant": str(tenant)}
        gl = tl if generation is None else {**tl, "generation": str(generation)}
        self._m_compiles.inc(**gl)


# ------------------------------------------------------------------ #
# switchboard
# ------------------------------------------------------------------ #


def enable_usage(registry=None) -> UsageMeter:
    """Install a process-wide meter (idempotent — disable first to
    re-target another registry)."""
    global _METER
    with _LOCK:
        if _METER is None:
            _METER = UsageMeter(registry=registry)
        return _METER


def disable_usage() -> Optional[UsageMeter]:
    global _METER
    with _LOCK:
        meter, _METER = _METER, None
    return meter


def get_meter() -> Optional[UsageMeter]:
    return _METER


def usage_enabled() -> bool:
    return _METER is not None


# ------------------------------------------------------------------ #
# read side
# ------------------------------------------------------------------ #

_FIELDS = (
    (DEVICE_SECONDS_TOTAL, "device_seconds", float),
    (ROWS_TOTAL, "rows", int),
    (QUEUE_SECONDS_TOTAL, "queue_seconds", float),
    (REQUESTS_TOTAL, "requests", int),
    (COMPILES_TOTAL, "compiles", int),
)


def _zero_row() -> dict:
    return {key: typ(0) for _, key, typ in _FIELDS}


def usage_summary(registry=None) -> dict:
    """Cost accounting read off any registry carrying ``svgd_usage_*``
    series — the live server registry, a scraped dump ingest, or the
    router's federated registry.

    Returns ``{"tenants": {tenant: {device_seconds, rows, queue_seconds,
    requests, compiles, generations: {gen: {...}}}}, "totals": {...},
    "replicas": {rid: {tenant: {...}}}}``.  Tenants/totals come from the
    rollup (non-``replica``-labelled) series so federated registries are
    not double-counted; the per-replica breakdown uses the
    replica-labelled series and is empty on a single server.
    """
    from dist_svgd_torch.telemetry import metrics as _metrics

    reg = registry if registry is not None else _metrics.default_registry()
    tenants: Dict[str, dict] = {}
    totals = _zero_row()
    replicas: Dict[str, dict] = {}

    for name, key, typ in _FIELDS:
        ctr = reg.get(name)
        if ctr is None:
            continue
        for ls in ctr.label_sets():
            val = typ(ctr.value(**ls))
            if not val:
                continue
            tenant = ls.get("tenant", DEFAULT_TENANT)
            rid = ls.get("replica")
            if rid is not None:
                row = replicas.setdefault(rid, {}).setdefault(
                    tenant, _zero_row())
                row[key] += val
                continue
            trow = tenants.setdefault(
                tenant, {**_zero_row(), "generations": {}})
            trow[key] += val
            totals[key] += val
            gen = ls.get("generation")
            if gen is not None:
                grow = trow["generations"].setdefault(gen, _zero_row())
                grow[key] += val
    return {"tenants": tenants, "totals": totals, "replicas": replicas}
