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
  :class:`KernelBucketLRU`.

Not ported yet, and their names raise ``NotImplementedError`` naming
ROADMAP A9: the serving fleet (``FleetRouter``, ``MetricsFederation``,
``ReplicaSet``, ``HttpTransport``, ``FakeTransport``, ``LoopbackReplica``
— JAX's ``serving/fleet.py``) and the autoscale controller
(``AutoscaleController``, ``AutoscalePolicy`` — ``serving/autoscale.py``).

The load generator is ``python -m dist_svgd_torch.tools.serve_bench``; the
Covertype train → checkpoint → serve demo is ``python -m
dist_svgd_torch.experiments.serve_covertype``.
"""

from dist_svgd_torch.serving.batcher import MicroBatcher, Overloaded
from dist_svgd_torch.serving.engine import (
    CheckpointHotReloader,
    EnsembleRejected,
    PredictiveEngine,
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

#: Names of JAX's ``serving`` modules not ported yet, by module.
_UNPORTED = {
    "fleet.py (the serving fleet)": (
        "FleetRouter", "MetricsFederation", "ReplicaSet", "HttpTransport",
        "FakeTransport", "LoopbackReplica"),
    "autoscale.py (the autoscale controller)": ("AutoscaleController", "AutoscalePolicy"),
}


def __getattr__(name):
    """PEP 562: the unported modules' names raise ``NotImplementedError``."""
    for module, names in _UNPORTED.items():
        if name in names:
            raise NotImplementedError(
                f"serving.{name} (serving/{module}) is not ported to PyTorch yet "
                "(ROADMAP A9)")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
