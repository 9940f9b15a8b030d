"""Fault-tolerant training: supervised runs, fault injection, numerical
guards.

Counterpart of ``dist_svgd_tpu/resilience`` with the same ``__all__``.  A
multi-hour run is glass without this package: one preemption, transient
dispatch failure, or NaN blowup loses the whole trajectory.

- :mod:`supervisor` — :class:`RunSupervisor`: bounded segments on an
  absolute step grid, periodic + signal-triggered checkpointing
  (``utils/checkpoint.py`` layouts), bitwise-exact resume-from-latest,
  retry with exponential backoff and a bounded restart budget, elastic
  resharding under :class:`ReshardPolicy`;
- :mod:`guards` — NaN/Inf / norm-explosion / step-divergence checks (one
  pass on the card, one host read) with a rollback + step-size-backoff
  policy, and the posterior-drift guards over the diagnostics' reports;
- :mod:`faults` — deterministic fault injection (raise-on-step-k, NaN into
  the carry, simulated preemption, simulated hard kill, artificial slow
  dispatch, device loss / mesh shrink / mesh grow / worker loss, the
  stream faults the streaming sources consume, and the fleet faults the
  serving fleet consumes once ported, ROADMAP A9) so every recovery path
  runs on the CPU;
- :mod:`federation` — :class:`FederationSupervisor`: the coordinator loop
  for W-process jobs, relaunching at W−1 after a whole-worker loss,
  against an injectable launcher;
- :mod:`backoff` — the one capped-exponential-backoff implementation
  (jitter optional, RNG injectable).

``dist_svgd_torch/experiments/resilient_covertype.py`` demonstrates kill →
resume on Covertype, and ``dist_svgd_torch/tools/fault_drill.py`` measures
recovery wall / steps lost / checkpoint overhead as one JSON row.
"""

from dist_svgd_torch.resilience.backoff import Backoff, capped_delay
from dist_svgd_torch.resilience.federation import (
    FakeWorker,
    FederationDead,
    FederationSupervisor,
    SubprocessWorker,
)
from dist_svgd_torch.resilience.faults import (
    BadGenerationAt,
    DeviceLossAt,
    DriftAt,
    FaultPlan,
    FleetFault,
    HardKillAt,
    InjectNaNAt,
    MeshGrowAt,
    MeshShrinkAt,
    PartitionAt,
    PreemptAt,
    RaiseAt,
    ReplicaHangAt,
    ReplicaKillAt,
    SimulatedHardKill,
    SlowReplicaAt,
    SlowSegmentAt,
    TopologyFault,
    TransientDispatchError,
    WorkerLossAt,
)
from dist_svgd_torch.resilience.guards import GuardConfig, GuardViolation, check_state
from dist_svgd_torch.resilience.supervisor import (
    ReshardPolicy,
    RestartBudgetExhausted,
    RetryPolicy,
    RunSupervisor,
)

__all__ = [
    "RunSupervisor",
    "RetryPolicy",
    "ReshardPolicy",
    "RestartBudgetExhausted",
    "GuardConfig",
    "GuardViolation",
    "check_state",
    "FaultPlan",
    "RaiseAt",
    "InjectNaNAt",
    "PreemptAt",
    "HardKillAt",
    "SlowSegmentAt",
    "DeviceLossAt",
    "MeshShrinkAt",
    "MeshGrowAt",
    "WorkerLossAt",
    "TopologyFault",
    "TransientDispatchError",
    "SimulatedHardKill",
    "Backoff",
    "capped_delay",
    "FederationSupervisor",
    "FederationDead",
    "FakeWorker",
    "SubprocessWorker",
    "FleetFault",
    "BadGenerationAt",
    "DriftAt",
    "ReplicaKillAt",
    "ReplicaHangAt",
    "PartitionAt",
    "SlowReplicaAt",
]
