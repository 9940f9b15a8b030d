"""Posterior-predictive serving over checkpointed SVGD ensembles.

Counterpart of ``dist_svgd_tpu/serving`` with the same ``__all__``:

- :mod:`engine`   — :class:`PredictiveEngine`: loads an ensemble from any
  checkpoint layout and serves per-model predictive programs through a
  shape-bucketed cache (one CUDA graph a bucket on the card, captured
  once), with checkpoint hot reload (:class:`CheckpointHotReloader`),
  reload admission (:class:`EnsembleRejected`), rollback and a staged
  candidate generation;
- :mod:`batcher`  — :class:`MicroBatcher`: coalesces concurrent requests
  into one device call over the whole ensemble, sheds on overflow
  (:class:`Overloaded`), runs ``lanes=N`` dispatch workers;
- :mod:`server`   — :class:`PredictionServer`, a stdlib HTTP front end;
- :mod:`registry` — :class:`ModelRegistry`: many tenants behind one
  process, one batcher, one checkpoint scanner and one
  :class:`KernelBucketLRU`;
- :mod:`autoscale` — :class:`AutoscaleController` /
  :class:`AutoscalePolicy`: the SLO-burn-driven control loop that retunes
  the batcher's lanes, coalescing window and tenant quotas live;
- :mod:`fleet`    — the serving fleet: :class:`FleetRouter` (consistent-hash
  front door with failover, retries, hedging and a 503 degrade) over a
  :class:`ReplicaSet` of circuit breakers, :class:`MetricsFederation`, and
  the transports (:class:`HttpTransport`, :class:`FakeTransport` over
  :class:`LoopbackReplica`).

The fleet drill is ``python -m dist_svgd_torch.tools.fleet_drill``; a live
fleet's status renders with ``python -m dist_svgd_torch.tools.fleet_status``.

The load generator is ``python -m dist_svgd_torch.tools.serve_bench``; the
Covertype train → checkpoint → serve demo is ``python -m
dist_svgd_torch.experiments.serve_covertype``.
"""

from dist_svgd_torch.serving.autoscale import (
    AutoscaleController,
    AutoscalePolicy,
)
from dist_svgd_torch.serving.batcher import MicroBatcher, Overloaded
from dist_svgd_torch.serving.engine import (
    CheckpointHotReloader,
    EnsembleRejected,
    PredictiveEngine,
)
from dist_svgd_torch.serving.fleet import (
    FakeTransport,
    FleetRouter,
    HttpTransport,
    LoopbackReplica,
    MetricsFederation,
    ReplicaSet,
)
from dist_svgd_torch.serving.registry import (
    KernelBucketLRU,
    ModelRegistry,
    Tenant,
)
from dist_svgd_torch.serving.server import PredictionServer

__all__ = [
    "AutoscaleController",
    "AutoscalePolicy",
    "PredictiveEngine",
    "CheckpointHotReloader",
    "EnsembleRejected",
    "KernelBucketLRU",
    "MicroBatcher",
    "ModelRegistry",
    "Overloaded",
    "PredictionServer",
    "Tenant",
    "FleetRouter",
    "MetricsFederation",
    "ReplicaSet",
    "HttpTransport",
    "FakeTransport",
    "LoopbackReplica",
]
