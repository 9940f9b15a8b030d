"""Deterministic fault injection for supervised runs.

Counterpart of ``dist_svgd_tpu/resilience/faults.py``, copied whole (it is
plain Python; the port imports nothing of the JAX package).

A multi-hour training run meets faults the test suite cannot wait for —
preemptions, transient dispatch failures, NaN blowups, pool slowdowns.  This
module makes every one of them a **scheduled, deterministic event** so each
recovery path in :mod:`~dist_svgd_torch.resilience.supervisor` runs in tier-1
on CPU with no real signals, sleeps, or flaky hardware:

- faults are keyed by **absolute step index** and fire at the first segment
  boundary whose step counter reaches it (the same quantisation a real
  SIGTERM gets: the supervisor finishes the in-flight dispatch first, then
  acts).  Run with ``segment_steps=1`` to pin a fault to an exact step.
- each fault fires **once** — a retried/rolled-back segment replays clean,
  which is exactly how a transient fault behaves.

The injection surface is the supervisor itself (the ``ctx`` argument):
``ctx.t``, ``ctx.corrupt_particles()``, ``ctx.request_stop()``,
``ctx.advance_clock()`` — the same hooks a signal handler or a watchdog
would use, so injected faults and real ones share one recovery code path.
"""

from __future__ import annotations

from typing import Optional, Sequence


class TransientDispatchError(RuntimeError):
    """Stand-in for a transient device/dispatch failure (the retryable kind:
    a pool hiccup, a severed tunnel, a watchdog kill).  The supervisor's
    default retry policy catches it alongside ``torch.AcceleratorError``
    (what an asynchronous CUDA failure surfaces as)."""


class SimulatedHardKill(RuntimeError):
    """Stand-in for SIGKILL / power loss: deliberately **not** in the default
    retryable set, so it unwinds straight through the supervisor without a
    checkpoint — the process is simply gone.  Recovery is a fresh
    ``RunSupervisor(...).run(resume=True)``, which is what
    ``dist_svgd_torch/tools/fault_drill.py`` measures."""


class TopologyFault(RuntimeError):
    """The mesh topology changed under the run — a device dropped out of the
    pool or the scheduler resized the job's share of the cards.  Deliberately outside the default retryable set: replaying the
    same segment on the same (now wrong-sized) sampler cannot help.  A
    supervisor with a :class:`~dist_svgd_torch.resilience.supervisor.
    ReshardPolicy` catches it and reshards the latest checkpoint onto the
    new topology inside the restart budget; without one it propagates like
    any non-recoverable fault.

    Carries either an explicit ``target_shards`` (mesh shrink/grow notice)
    or the ``surviving`` device count (device loss — the policy picks the
    shard count)."""

    def __init__(self, msg: str, *, target_shards: Optional[int] = None,
                 surviving: Optional[int] = None, lost_devices: int = 0):
        super().__init__(msg)
        self.target_shards = target_shards
        self.surviving = surviving
        self.lost_devices = int(lost_devices)


class Fault:
    """One scheduled fault.  Fires once, at the first segment boundary with
    step counter ``>= step``."""

    def __init__(self, step: int):
        self.step = int(step)
        self.fired = False

    def fire(self, ctx) -> None:  # pragma: no cover - abstract
        raise NotImplementedError

    def __repr__(self):
        return f"{type(self).__name__}(step={self.step}, fired={self.fired})"


class RaiseAt(Fault):
    """Raise a transient dispatch failure — exercises retry + exponential
    backoff + rollback-to-last-checkpoint."""

    def __init__(self, step: int, exc: Optional[Exception] = None):
        super().__init__(step)
        self.exc = exc

    def fire(self, ctx) -> None:
        raise self.exc if self.exc is not None else TransientDispatchError(
            f"injected transient dispatch failure at step {ctx.t}"
        )


class InjectNaNAt(Fault):
    """Overwrite one entry of the carried particle state with NaN — the
    minimal numerical blowup the guards must detect and roll back."""

    def fire(self, ctx) -> None:
        ctx.corrupt_particles()


class PreemptAt(Fault):
    """Simulated preemption notice (SIGTERM-shaped): requests a stop, which
    the supervisor honours at the boundary with a final checkpoint and a
    ``'preempted'`` report — resume-exact by construction."""

    def fire(self, ctx) -> None:
        ctx.request_stop(f"injected preemption at step {ctx.t}")


class HardKillAt(Fault):
    """Simulated SIGKILL: raises :class:`SimulatedHardKill`, which the
    supervisor does NOT catch — no checkpoint, no cleanup, state as of the
    last periodic save.  The fault-drill's kill-mid-run event."""

    def fire(self, ctx) -> None:
        raise SimulatedHardKill(f"injected hard kill at step {ctx.t}")


class DeviceLossAt(Fault):
    """Simulated loss of ``lost`` mesh device(s): raises
    :class:`TopologyFault` with the surviving device count, exactly as a
    real pool-shrink surfaces (the in-flight dispatch dies, the next
    attempt sees fewer devices).  The supervisor's :class:`ReshardPolicy`
    picks the new shard count from the survivors."""

    def __init__(self, step: int, lost: int = 1):
        super().__init__(step)
        if lost < 1:
            raise ValueError(f"lost must be >= 1, got {lost}")
        self.lost = int(lost)

    def fire(self, ctx) -> None:
        surviving = max(0, ctx.num_shards - self.lost)
        raise TopologyFault(
            f"injected loss of {self.lost} device(s) at step {ctx.t} "
            f"({ctx.num_shards} -> {surviving} surviving)",
            surviving=surviving, lost_devices=self.lost,
        )


class MeshShrinkAt(Fault):
    """Scheduler-shaped capacity notice: the mesh must shrink to
    ``to_shards`` (an explicit target, unlike :class:`DeviceLossAt`'s
    policy-chosen one)."""

    def __init__(self, step: int, to_shards: int):
        super().__init__(step)
        if to_shards < 1:
            raise ValueError(f"to_shards must be >= 1, got {to_shards}")
        self.to_shards = int(to_shards)

    def fire(self, ctx) -> None:
        raise TopologyFault(
            f"injected mesh shrink to {self.to_shards} shards at step "
            f"{ctx.t} (from {ctx.num_shards})",
            target_shards=self.to_shards,
        )


class MeshGrowAt(Fault):
    """Capacity-returned notice: the mesh may grow to ``to_shards`` — the
    recovery direction after a loss, same reshard path as the shrink."""

    def __init__(self, step: int, to_shards: int):
        super().__init__(step)
        if to_shards < 1:
            raise ValueError(f"to_shards must be >= 1, got {to_shards}")
        self.to_shards = int(to_shards)

    def fire(self, ctx) -> None:
        raise TopologyFault(
            f"injected mesh grow to {self.to_shards} shards at step "
            f"{ctx.t} (from {ctx.num_shards})",
            target_shards=self.to_shards,
        )


class WorkerLossAt(Fault):
    """Loss of whole federation worker process(es) — host SIGKILL, node
    death — on a ``processes``-way multi-host run: every shard of the lost
    process's DCN granule leaves the mesh at once, not one device.  Raises
    :class:`TopologyFault` with the surviving shard count under the equal
    granule layout (``make_particle_mesh``'s contract), so the supervisor's
    :class:`~dist_svgd_torch.resilience.supervisor.ReshardPolicy` resumes the
    run at the W−1 federation's shard count on the same absolute step grid.
    It is the in-process form of the loss that
    ``dist_svgd_torch/tools/multihost_train.py --mode real`` delivers as a
    real SIGKILL to one of its ``torch.distributed`` workers, after which
    :class:`~dist_svgd_torch.resilience.federation.FederationSupervisor`
    relaunches the survivors at W−1 with ``--resume``."""

    def __init__(self, step: int, processes: int, lost: int = 1):
        super().__init__(step)
        if processes < 2:
            raise ValueError(f"processes must be >= 2, got {processes}")
        if not 1 <= lost < processes:
            raise ValueError(
                f"lost must be in [1, {processes - 1}], got {lost}"
            )
        self.processes = int(processes)
        self.lost = int(lost)

    def fire(self, ctx) -> None:
        S = ctx.num_shards
        if S % self.processes:
            raise ValueError(
                f"WorkerLossAt(processes={self.processes}) on a {S}-shard "
                "mesh: the granule layout must be equal per process"
            )
        per_granule = S // self.processes
        surviving_p = self.processes - self.lost
        raise TopologyFault(
            f"injected loss of {self.lost} worker process(es) at step "
            f"{ctx.t} ({self.processes} -> {surviving_p} processes, "
            f"{S} -> {per_granule * surviving_p} shards)",
            surviving=per_granule * surviving_p,
            lost_devices=per_granule * self.lost,
        )


class SlowSegmentAt(Fault):
    """Artificial slow dispatch: advances the supervisor's (injectable)
    clock by ``seconds`` so the next segment wall measures slow — exercises
    the ``slow_segment_warn_s`` watchdog without real waiting."""

    def __init__(self, step: int, seconds: float):
        super().__init__(step)
        self.seconds = float(seconds)

    def fire(self, ctx) -> None:
        ctx.advance_clock(self.seconds)


# --------------------------------------------------------------------- #
# fleet faults: process-level failures of a serving replica, consumed by
# the serving fleet's injectable FakeTransport
# (``dist_svgd_torch/serving/fleet.py``) rather than the supervisor — the
# unit of failure is a whole replica process, and the schedule is keyed by
# the transport's request ordinal (every probe or forward through the fake
# increments it) so failover tests are deterministic without real sockets,
# signals, or sleeps.


class FleetFault:
    """One scheduled replica-level fault window: active for transport
    request ordinals in ``[at, until)`` (``until=None`` → forever, i.e.
    until a runtime override like ``FakeTransport.restore`` lifts it).
    Unlike the training faults above these do not "fire once" — a dead
    process stays dead for every request in the window."""

    kind = "abstract"

    def __init__(self, at: int, replica: str, until: Optional[int] = None):
        if at < 0:
            raise ValueError(f"at must be >= 0, got {at}")
        if until is not None and until <= at:
            raise ValueError(f"until ({until}) must be > at ({at})")
        self.at = int(at)
        self.replica = str(replica)
        self.until = None if until is None else int(until)

    def active(self, ordinal: int) -> bool:
        return self.at <= ordinal and (self.until is None
                                       or ordinal < self.until)

    def __repr__(self):
        return (f"{type(self).__name__}(at={self.at}, "
                f"replica={self.replica!r}, until={self.until})")


class ReplicaKillAt(FleetFault):
    """The replica process is gone (SIGKILL / OOM / node loss): every
    connection from the router is refused — probes and forwards alike.
    ``until=`` models the restart (the process comes back and the router
    must re-admit it through the half-open circuit)."""

    kind = "kill"


class ReplicaHangAt(FleetFault):
    """The replica process accepts connections but never responds (a
    wedged GIL, a stuck device call): the router's request times out after
    its per-try budget.  The fake transport charges the full timeout to
    the injected clock so hang cost is measured, not waited for."""

    kind = "hang"


class PartitionAt(FleetFault):
    """Network partition: the replica is **alive and healthy** — it keeps
    serving anyone who can reach it, its own flight recorder records
    nothing — but the router cannot reach it.  Must trip the same ejection
    path as a crash (from the router's seat they are indistinguishable)
    without any replica-side effect; ``until=`` heals the partition."""

    kind = "partition"


class SlowReplicaAt(FleetFault):
    """Degraded replica: every response is delayed by ``seconds`` (GC
    storms, a noisy neighbor).  The tail-hedging path exists for exactly
    this shape — the request completes, just slowly."""

    kind = "slow"

    def __init__(self, at: int, replica: str, seconds: float,
                 until: Optional[int] = None):
        super().__init__(at, replica, until=until)
        if seconds < 0:
            raise ValueError(f"seconds must be >= 0, got {seconds}")
        self.seconds = float(seconds)


# --------------------------------------------------------------------- #
# stream faults (round 20): deterministic distribution shift injected
# into a streaming data source, consumed by the streaming sources
# (``dist_svgd_torch/streaming/source.py``) rather than the supervisor —
# the unit of failure is the DATA, and the schedule is keyed by the
# source's batch ordinal (like FleetFault's request ordinal) so every
# drift-detection/retrain path runs on the CPU with no real drift to wait
# for.


class DriftAt:
    """One scheduled distribution-shift window: batches with source
    ordinal in ``[step, until)`` (``until=None`` → forever) are transformed
    by a pure, deterministic ``apply`` — so a replayed stream reproduces
    the drift bitwise (the kill→resume invariant extends through the
    fault).  Kinds:

    - ``'mean_shift'``: add ``magnitude`` to every feature column — the
      covariate-shift shape KSD sees as a posterior/data mismatch.
    - ``'label_flip'``: negate the ±1 labels of a deterministic
      ``magnitude`` fraction of each batch's rows (strided, not sampled —
      no RNG, so replay needs no extra state).
    """

    KINDS = ("mean_shift", "label_flip")

    def __init__(self, step: int, kind: str = "mean_shift",
                 magnitude: float = 1.0, until: Optional[int] = None):
        if step < 0:
            raise ValueError(f"step must be >= 0, got {step}")
        if kind not in self.KINDS:
            raise ValueError(f"unknown drift kind {kind!r} "
                             f"(one of {self.KINDS})")
        if until is not None and until <= step:
            raise ValueError(f"until ({until}) must be > step ({step})")
        if kind == "label_flip" and not 0.0 <= magnitude <= 1.0:
            raise ValueError(
                f"label_flip magnitude is a flip fraction in [0, 1], "
                f"got {magnitude}"
            )
        self.step = int(step)
        self.kind = kind
        self.magnitude = float(magnitude)
        self.until = None if until is None else int(until)

    def active(self, ordinal: int) -> bool:
        return self.step <= ordinal and (self.until is None
                                         or ordinal < self.until)

    def apply(self, x, y):
        """Transform one ``(x, y)`` batch (numpy arrays; pure — never
        mutates its inputs)."""
        import numpy as np

        if self.kind == "mean_shift":
            return x + np.asarray(self.magnitude, dtype=x.dtype), y
        # label_flip: deterministic strided rows — round(frac * n) rows,
        # evenly spread, replay-stable with zero extra state
        n = y.shape[0]
        k = int(round(self.magnitude * n))
        if k <= 0:
            return x, y
        idx = np.linspace(0, n - 1, num=k).round().astype(int)
        out = np.array(y)
        out[idx] = -out[idx]
        return x, out

    def __repr__(self):
        return (f"DriftAt(step={self.step}, kind={self.kind!r}, "
                f"magnitude={self.magnitude}, until={self.until})")


class BadGenerationAt:
    """One scheduled bad candidate generation: rollout offers with
    publish ordinal in ``[step, until)`` (``until=None`` → forever) carry
    particles transformed by a pure, deterministic ``apply`` into
    prediction garbage — so the progressive-delivery rollback path runs
    tier-1 on CPU with no real bad training run to wait for (and a
    replayed publish schedule reproduces the bad candidate bitwise).
    Consumed at the offer seam — the rollout driver (a drill, a test, or
    a supervisor shim) transforms the candidate ensemble before
    ``RolloutController.offer``; the controller itself never knows the
    candidate is synthetic, which is the point: detection must come from
    the live divergence/burn windows.  Kinds:

    - ``'saturate'``: scale every parameter by ``magnitude`` (default
      1e6) — predictions saturate/overflow, the divergence histogram's
      overflow bucket fills, the shadow stage breaches immediately.
    - ``'scramble'``: deterministically reverse the parameter axis and
      negate — finite, plausible-looking particles whose *predictions*
      disagree with the incumbent (the subtle shape: passes any
      all-finite check, only the divergence window catches it).
    """

    KINDS = ("saturate", "scramble")

    def __init__(self, step: int, kind: str = "saturate",
                 magnitude: float = 1e6, until: Optional[int] = None):
        if step < 0:
            raise ValueError(f"step must be >= 0, got {step}")
        if kind not in self.KINDS:
            raise ValueError(f"unknown bad-generation kind {kind!r} "
                             f"(one of {self.KINDS})")
        if until is not None and until <= step:
            raise ValueError(f"until ({until}) must be > step ({step})")
        if kind == "saturate" and magnitude <= 1.0:
            raise ValueError(
                f"saturate magnitude must be > 1, got {magnitude}")
        self.step = int(step)
        self.kind = kind
        self.magnitude = float(magnitude)
        self.until = None if until is None else int(until)

    def active(self, ordinal: int) -> bool:
        return self.step <= ordinal and (self.until is None
                                         or ordinal < self.until)

    def apply(self, particles):
        """Transform one ``(n, d)`` candidate ensemble (numpy array;
        pure — never mutates its input)."""
        import numpy as np

        particles = np.asarray(particles)
        if self.kind == "saturate":
            return particles * np.asarray(self.magnitude,
                                          dtype=particles.dtype)
        # scramble: reverse the parameter axis and negate — deterministic,
        # finite, and prediction-breaking for any non-symmetric model
        return -particles[:, ::-1].copy()

    def __repr__(self):
        return (f"BadGenerationAt(step={self.step}, kind={self.kind!r}, "
                f"magnitude={self.magnitude}, until={self.until})")


class FaultPlan:
    """An ordered schedule of faults, consumed by the supervisor at every
    segment boundary.  ``fire_due`` fires every not-yet-fired fault whose
    step has been reached, in step order; a raising fault leaves later ones
    pending for the retried boundary (each still fires exactly once)."""

    def __init__(self, *faults: Fault):
        if len(faults) == 1 and isinstance(faults[0], (list, tuple)):
            faults = tuple(faults[0])
        self.faults: Sequence[Fault] = sorted(faults, key=lambda f: f.step)

    def fire_due(self, ctx) -> None:
        for f in self.faults:
            if not f.fired and f.step <= ctx.t:
                f.fired = True  # before fire(): a raising fault is spent
                f.fire(ctx)

    @property
    def exhausted(self) -> bool:
        return all(f.fired for f in self.faults)

    def __repr__(self):
        return f"FaultPlan({list(self.faults)!r})"
