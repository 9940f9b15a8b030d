"""Supervised, fault-tolerant sampler runs.

Counterpart of ``dist_svgd_torch/resilience/supervisor.py``.
``RunSupervisor`` drives a :class:`~dist_svgd_torch.sampler.Sampler` or
:class:`~dist_svgd_torch.distsampler.DistSampler` in **bounded segments** on
an absolute step grid, adding the recovery behaviours a multi-hour run
needs:

- **periodic + signal-triggered checkpointing** through the
  ``utils/checkpoint.py`` layouts (atomic step dirs, retention, corrupt-
  newest fallback on restore);
- **resume-from-latest** that is *bitwise-identical* to an uninterrupted
  run: segments land on an absolute grid (multiples of ``segment_steps``
  and the checkpoint cadence), so an interrupted run resumed from any
  boundary issues the exact same sequence of ``run``/``run_steps`` calls —
  same kernels, same inputs — as one that never stopped.  Every stream of
  a run is keyed by ``(seed, t)`` and every hand kernel reduces in a fixed
  order with no float atomics, and the carried step counter / minibatch
  offsets make this exact; ``tests/test_torch_resilience.py`` pins it for
  both sampler kinds;
- **retry with exponential backoff** around transient dispatch failures
  (``TransientDispatchError`` and ``torch.AcceleratorError``; bounded
  restart budget; rollback to the last good checkpoint before each retry,
  so a mid-segment failure can never leave half-advanced state).  A build
  failure or a shape error is a ``RuntimeError`` outside that set and
  propagates; a sticky CUDA error fails every retry and its rollback, spends
  the budget and ends in :class:`RestartBudgetExhausted` with a postmortem;
- **numerical guards** (:mod:`~dist_svgd_torch.resilience.guards`) with a
  rollback + step-size-backoff policy on NaN/Inf, norm explosion, or
  per-step divergence, and the posterior-drift guards on the diagnostics'
  cadence;
- **elastic resharding** (:class:`ReshardPolicy`) of the latest checkpoint
  onto a new shard count when a topology fault fires.

Time and signals are injectable (``clock``, ``sleep``, and the fault hooks
in :mod:`~dist_svgd_torch.resilience.faults`), so every recovery path runs
deterministically on the CPU — no real sleeps, no real signals.
Production drivers call :meth:`RunSupervisor.install_signal_handlers` to
map real SIGTERM/SIGINT onto the same checkpoint-at-boundary path the
injected preemption uses.
"""

from __future__ import annotations

import signal as _signal
import time
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from dist_svgd_torch.parallel.exchange import tree_map
from dist_svgd_torch.resilience.backoff import capped_delay
from dist_svgd_torch.resilience.faults import (
    FaultPlan,
    TopologyFault,
    TransientDispatchError,
)
from dist_svgd_torch.resilience.guards import (
    GuardConfig,
    GuardViolation,
    check_diagnostics,
    check_state,
)
from dist_svgd_torch.telemetry import diagnostics as _diagnostics
from dist_svgd_torch.telemetry import metrics as _metrics
from dist_svgd_torch.telemetry import trace as _trace
from dist_svgd_torch.utils.checkpoint import (
    CheckpointManager,
    check_topology,
    read_manifest,
    reshard_state,
    topology_manifest,
)
from dist_svgd_torch.utils.rng import init_particles


class RestartBudgetExhausted(RuntimeError):
    """The bounded restart budget ran out.  ``last_error`` carries the
    final failure (a retryable exception or a :class:`GuardViolation`)."""

    def __init__(self, msg: str, last_error: Optional[BaseException] = None):
        super().__init__(msg)
        self.last_error = last_error


def _default_retryable() -> tuple:
    """The transient failures a retry can cure: the injected
    :class:`TransientDispatchError` and an asynchronous CUDA failure
    (``torch.AcceleratorError``).  Deliberately not ``RuntimeError``: a
    failed kernel build or a shape error must propagate, not be retried."""
    exc = [TransientDispatchError]
    accel = getattr(torch, "AcceleratorError", None)
    if accel is not None:
        exc.append(accel)
    return tuple(exc)


class RetryPolicy:
    """Retry knobs for transient failures (and the shared restart budget
    the guard rollbacks draw from).

    ``backoff_base_s · backoff_factor^(k-1)`` seconds before the k-th
    *consecutive* retry, capped at ``max_backoff_s``; a successful segment
    resets the consecutive counter but not the total budget.  The schedule
    is :func:`resilience.backoff.capped_delay` — the one shared backoff
    implementation (the fleet router jitters the same schedule; the
    supervisor stays jitter-free so recovery tests pin exact delays)."""

    def __init__(
        self,
        max_restarts: int = 3,
        backoff_base_s: float = 1.0,
        backoff_factor: float = 2.0,
        max_backoff_s: float = 60.0,
        retryable: Optional[Sequence[type]] = None,
    ):
        if max_restarts < 0:
            raise ValueError("max_restarts must be >= 0")
        self.max_restarts = int(max_restarts)
        self.backoff_base_s = float(backoff_base_s)
        self.backoff_factor = float(backoff_factor)
        self.max_backoff_s = float(max_backoff_s)
        self.retryable = (tuple(retryable) if retryable is not None
                          else _default_retryable())

    def delay_s(self, consecutive_failures: int) -> float:
        """Backoff before retry number ``consecutive_failures`` (1-based)."""
        return capped_delay(consecutive_failures, self.backoff_base_s,
                            self.backoff_factor, self.max_backoff_s)


class ReshardPolicy:
    """Elastic-capacity policy: how :class:`RunSupervisor` rebuilds the
    training topology when a :class:`~dist_svgd_torch.resilience.faults.
    TopologyFault` fires (device loss, mesh shrink/grow).

    With a policy installed, a topology fault no longer kills the run: the
    supervisor spends one restart from the SAME budget the transient
    retries draw on, reshards the latest checkpoint onto the new shard
    count (``utils/checkpoint.py:reshard_state``), rebuilds the sampler
    through ``sampler_factory``, and continues on the identical absolute
    segment grid — steps since the last checkpoint are replayed, nothing
    else changes.

    Args:
        sampler_factory: ``factory(num_shards) -> DistSampler`` — a FRESH
            sampler at the requested topology, constructed exactly as the
            original was (same model/kernel/options/seed; its initial
            particles are immediately overwritten by the resharded
            checkpoint).  ``chip_smoke.py``'s ``elastic_reshard`` phase
            shows the pattern.
        device_loss_strategy: how :class:`~dist_svgd_torch.resilience.faults.
            DeviceLossAt` (which names no explicit target) picks the new
            shard count from the survivors: ``'largest_divisor'`` (default)
            takes the largest shard count ≤ survivors that divides the
            particle count — keeping every particle sharded; ``'surviving'``
            takes the raw survivor count, accepting the replicate-and-warn
            fallback when it doesn't divide n (applied by
            ``reshard_state``).
    """

    def __init__(self, sampler_factory: Callable[[int], object],
                 device_loss_strategy: str = "largest_divisor"):
        if device_loss_strategy not in ("largest_divisor", "surviving"):
            raise ValueError(
                f"unknown device_loss_strategy {device_loss_strategy!r}"
            )
        self.sampler_factory = sampler_factory
        self.device_loss_strategy = device_loss_strategy

    def target_for_device_loss(self, surviving: int, n_particles: int) -> int:
        """Shard count to run on after a device loss left ``surviving``
        devices (≥ 1 always — the last device serves alone)."""
        surviving = max(1, int(surviving))
        if self.device_loss_strategy == "surviving":
            return surviving
        for s in range(min(surviving, max(int(n_particles), 1)), 0, -1):
            if n_particles % s == 0:
                return s
        return 1

    def build(self, num_shards: int):
        """Construct (and validate) the factory's sampler at the target."""
        sampler = self.sampler_factory(num_shards)
        if not hasattr(sampler, "run_steps"):
            raise TypeError(
                "ReshardPolicy.sampler_factory must build a DistSampler "
                f"(got {type(sampler).__name__}) — elastic resharding is a "
                "mesh concept; a single-device Sampler has no topology"
            )
        built = getattr(sampler, "_num_shards", None)
        if built != num_shards:
            raise ValueError(
                f"sampler_factory({num_shards}) built a sampler at "
                f"{built} shards — the factory must honour its argument"
            )
        return sampler


def _sampler_process_count(sampler) -> int:
    """Process count of a sampler's mesh (1 for a meshless or single-process
    one) — the process dimension the elastic metrics and flight records
    carry so a multi-host transition is distinguishable from a same-host
    shard shrink in the telemetry."""
    mesh = getattr(sampler, "_mesh", None)
    return int(getattr(mesh, "process_count", 1))


# --------------------------------------------------------------------- #
# Sampler harnesses: one segmented-drive surface over both sampler kinds

class _DistHarness:
    """Drives a ``DistSampler`` — resume state is the sampler's own
    ``state_dict`` (particles, W2 snapshots, carried duals, step counter)."""

    kind = "distsampler"

    def __init__(self, sampler, h: float):
        self._s = sampler
        self._h = h

    @property
    def t(self) -> int:
        return self._s._t

    @property
    def particles(self):
        """This process's particle rows (all of them on one process)."""
        return self._s._particles

    @property
    def num_shards(self) -> int:
        return self._s._num_shards

    @property
    def score_fn(self):
        """No per-θ global score closure: the DistSampler's score is
        sharded with its data — KSD diagnostics need an explicit
        ``DiagnosticsConfig.score_fn`` here."""
        return None

    def run_segment(self, k: int, step_size: float) -> None:
        s = self._s
        if s._include_wasserstein and s._wasserstein_solver != "sinkhorn":
            # the host-LP W2 path is make_step-only (run_steps docstring)
            for _ in range(k):
                s.make_step(step_size, h=self._h)
        else:
            s.run_steps(k, step_size, record=False, h=self._h)

    def state_dict(self) -> dict:
        return self._s.state_dict()

    def load_state_dict(self, state: dict) -> None:
        self._s.load_state_dict(state)

    def corrupt_particles(self) -> None:
        # a fresh tensor, not a write into the carried one: on the CPU the
        # last good state's numpy arrays share the carried tensor's memory
        p = self._s._particles.clone()
        p[(0,) * p.dim()] = float("nan")
        self._s._particles = p


class _SamplerHarness:
    """Drives a single-device ``Sampler`` as resumable segments: carried
    state is ``(particles, t)``; ``step_offset=t`` keeps the minibatch
    stream identical to one monolithic run, and a ``kernel='median'``
    bandwidth is frozen from the run-initial particles (and recorded in the
    resume state) so segments never re-resolve it."""

    kind = "sampler"

    def __init__(self, sampler, n: int, seed=0, initial_particles=None,
                 dtype=None):
        self._s = sampler
        self._n = int(n)
        self._seed = seed
        if initial_particles is not None:
            parts = torch.as_tensor(initial_particles, device=sampler._device)
            if dtype is not None:
                parts = parts.to(dtype)
        else:
            # the port's explicit generator stream for (seed,)
            parts = init_particles(int(seed), self._n, sampler._d,
                                   dtype=dtype or torch.float32, device=sampler._device)
        self.particles = parts
        self.t = 0
        self._bandwidth = None
        if getattr(sampler, "_median_kernel", False):
            self._bandwidth = sampler.freeze_median_kernel(parts)

    num_shards = 1

    @property
    def score_fn(self):
        """The sampler's own full-data score closure ``θ ↦ ∇log p(θ)`` —
        exactly what the KSD diagnostic needs (the data are cast to θ's
        dtype)."""
        s = self._s

        def score_on(data):
            def score(theta):
                cast = tree_map(lambda a: a.to(theta.dtype) if a.is_floating_point() else a,
                                data)
                return torch.func.grad(s._full_logp(cast))(theta)

            return score

        # the data are the closure's inputs, so a captured diagnostics pass
        # reads the sampler's data of each compute (set_data swaps them)
        return _diagnostics.data_score(lambda: s._data, score_on)

    def run_segment(self, k: int, step_size: float) -> None:
        final, _ = self._s.run(
            self._n, k, step_size, seed=self._seed, record=False,
            initial_particles=self.particles, step_offset=self.t,
        )
        self.particles = final
        self.t += k

    def state_dict(self) -> dict:
        state = {
            "particles": self.particles.detach().cpu().numpy(),
            "t": np.asarray(self.t, dtype=np.int64),
        }
        state.update(topology_manifest(1, self._n, self._s._d))
        if self._bandwidth is not None:
            state["kernel_bandwidth"] = np.asarray(self._bandwidth)
        return state

    def load_state_dict(self, state: dict) -> None:
        check_topology(state, {"n_particles": self._n, "d": self._s._d},
                       context="checkpoint")
        self.particles = torch.as_tensor(np.array(state["particles"]),
                                         device=self._s._device)
        self.t = int(state["t"])
        bw = state.get("kernel_bandwidth")
        if bw is not None:
            self._bandwidth = float(np.asarray(bw))
            self._s.pin_kernel_bandwidth(self._bandwidth)

    def corrupt_particles(self) -> None:
        p = self.particles.clone()
        p[0, 0] = float("nan")
        self.particles = p


# --------------------------------------------------------------------- #


class RunSupervisor:
    """Fault-tolerant segmented driver for one training run.

    Args:
        sampler: a ``DistSampler`` (resume state via its ``state_dict``) or
            a ``Sampler`` (pass ``n``, and optionally ``seed`` /
            ``initial_particles`` / ``dtype`` — the run-construction
            arguments ``Sampler.run`` would take).
        num_steps: total steps of the supervised run (absolute; a resumed
            run continues to the same total).
        step_size: SVGD ε.  May be reduced in flight by the guard policy;
            the *current* value is recorded in every checkpoint
            (``sup_step_size``) and restored on resume.
        checkpoint_dir / manager / checkpoint_every: periodic checkpointing
            through ``utils/checkpoint.py`` — pass a ``CheckpointManager``,
            or a directory (a manager is built with cadence
            ``checkpoint_every``, default 100).  ``None`` disables
            checkpointing: rollback then targets the in-memory run-start
            snapshot and resume is unavailable.
        segment_steps: max steps per dispatch segment (default: the
            checkpoint cadence, or the whole run when unmanaged).  Segment
            boundaries land on **absolute multiples** — the resume-exactness
            invariant (module docstring) — and are where faults fire, stops
            are honoured, and guards run.
        h: Wasserstein weight forwarded to the distributed step (inert
            without the W2 term).
        guard: :class:`GuardConfig` enabling the numerical guards.
        retry: :class:`RetryPolicy` for transient failures (default: 3
            restarts, 1 s base, ×2 backoff).
        logger: ``utils/metrics.py:JsonlLogger`` — one structured record per
            segment / checkpoint / retry / guard trip / preemption.
        faults: a :class:`~dist_svgd_torch.resilience.faults.FaultPlan`
            (tests and drills; ``None`` in production).
        clock / sleep: injectable time (``time.perf_counter`` /
            ``time.sleep``) so recovery paths test without real waits.
        slow_segment_warn_s: log a ``slow_segment`` warning record when a
            segment's wall exceeds this (the watchdog surface the
            ``SlowSegmentAt`` fault exercises).
        registry: ``telemetry.MetricsRegistry`` for the supervisor's
            restart/guard/checkpoint counters and the segment/checkpoint
            duration histograms (default: the process-wide registry).
            While the span tracer is enabled each segment and checkpoint
            additionally records a ``train.segment`` / ``train.checkpoint``
            span, with retries, guard trips, rollbacks, and preemptions as
            instant events — the training half of the serving path's
            request-span story.
        diagnostics: :class:`~dist_svgd_torch.telemetry.diagnostics.
            PosteriorDiagnostics` — computed on the carried particle array
            at the first segment boundary at or past each
            ``every_steps`` multiple (plus the final boundary), with the
            single-device sampler's own score closure wired in for KSD
            when the config has none.  When the :class:`GuardConfig` sets
            drift/collapse thresholds (``max_ksd``, ``min_ess_frac``,
            ``min_dim_var``, ``max_shard_mean_div``) each report is judged
            by ``guards.check_diagnostics`` and a violation takes the
            SAME rollback + step-size-backoff path as the numerical
            guards.  ``None`` holds the shared no-op (zero cost).
        recorder: :class:`~dist_svgd_torch.telemetry.trace.FlightRecorder`
            for postmortem bundles; default: whatever recorder is
            installed process-wide (``telemetry.install_flight_recorder``)
            at dump time.  A bundle is dumped when a guard trips, a
            non-retryable fault fires, or the restart budget exhausts.
        reshard: :class:`ReshardPolicy` enabling **elastic capacity**: a
            :class:`~dist_svgd_torch.resilience.faults.TopologyFault`
            (device loss, mesh shrink/grow) is handled by resharding the
            latest checkpoint onto the new shard count and continuing —
            one restart spent from the shared budget, a ``train.reshard``
            span, ``svgd_elastic_*`` counters and a flight-recorder
            ``topology_transition`` record per transition.  ``None``
            (default) keeps topology faults non-recoverable.
    """

    def __init__(
        self,
        sampler,
        num_steps: int,
        step_size: float,
        *,
        checkpoint_dir: Optional[str] = None,
        manager: Optional[CheckpointManager] = None,
        checkpoint_every: int = 100,
        segment_steps: Optional[int] = None,
        h: float = 1.0,
        guard: Optional[GuardConfig] = None,
        retry: Optional[RetryPolicy] = None,
        logger=None,
        faults: Optional[FaultPlan] = None,
        clock: Callable[[], float] = time.perf_counter,
        sleep: Callable[[float], None] = time.sleep,
        slow_segment_warn_s: Optional[float] = None,
        registry: Optional[_metrics.MetricsRegistry] = None,
        diagnostics=None,
        recorder=None,
        reshard: Optional[ReshardPolicy] = None,
        n: Optional[int] = None,
        seed=0,
        initial_particles=None,
        dtype=None,
    ):
        if num_steps < 1:
            raise ValueError(f"num_steps must be >= 1, got {num_steps}")
        if manager is not None and checkpoint_dir is not None:
            raise ValueError("pass checkpoint_dir or manager, not both")
        if manager is None and checkpoint_dir is not None:
            # npz backend for the supervisor's own manager (JAX's choice,
            # where the alternative is orbax): a periodic cadence pays the
            # save cost every `every` steps.  Pass an explicit `manager` to
            # choose otherwise.
            manager = CheckpointManager(checkpoint_dir, every=checkpoint_every,
                                        backend="npz")
        self._manager = manager
        if hasattr(sampler, "run_steps"):  # DistSampler
            self._harness = _DistHarness(sampler, h)
        else:
            if n is None:
                raise ValueError(
                    "supervising a single-device Sampler requires n (the "
                    "particle count Sampler.run would take)"
                )
            self._harness = _SamplerHarness(
                sampler, n, seed=seed, initial_particles=initial_particles,
                dtype=dtype,
            )
        self.sampler = sampler
        self.num_steps = int(num_steps)
        self.step_size = float(step_size)
        if segment_steps is not None and segment_steps < 1:
            raise ValueError(f"segment_steps must be >= 1, got {segment_steps}")
        self._segment_steps = segment_steps or (
            manager.every if manager is not None else self.num_steps
        )
        self._guard = guard
        self._retry = retry or RetryPolicy()
        self._logger = logger
        self._faults = faults
        self._clock = clock
        self._sleep = sleep
        self._slow_warn = slow_segment_warn_s
        self._stop_requested = False
        self._stop_reason: Optional[str] = None
        self._restarts = 0
        self._consecutive_failures = 0
        self._last_good: Optional[Tuple[int, dict]] = None
        self._ckpt_wall_s = 0.0
        self._seg_wall_s = 0.0
        self._max_seg_wall_s = 0.0
        self._n_checkpoints = 0
        self._n_segments = 0
        reg = registry if registry is not None else _metrics.default_registry()
        self.registry = reg
        self._m_restarts = reg.counter(
            "svgd_train_restarts_total",
            "restart budget spent, by kind (transient retry / guard trip)")
        self._m_guard_trips = reg.counter(
            "svgd_train_guard_trips_total",
            "numerical guard violations (NaN/Inf, explosion, divergence)")
        self._m_checkpoints = reg.counter(
            "svgd_train_checkpoints_total", "checkpoints written, by tag")
        self._m_ckpt_seconds = reg.histogram(
            "svgd_train_checkpoint_seconds", "wall per checkpoint save")
        self._m_seg_seconds = reg.histogram(
            "svgd_train_segment_seconds", "wall per training segment")
        self._m_steps = reg.counter(
            "svgd_train_steps_total", "SVGD steps completed under supervision")
        self._reshard = reshard
        self._m_reshards = reg.counter(
            "svgd_elastic_reshards_total",
            "elastic topology transitions, by direction (shrink/grow/same)")
        self._m_steps_lost = reg.counter(
            "svgd_elastic_steps_lost_total",
            "steps replayed because a topology transition resumed from the "
            "last checkpoint")
        self._g_shards = reg.gauge(
            "svgd_elastic_shards",
            "current shard count of the supervised run's mesh")
        self._g_shards.set(self._harness.num_shards)
        self._g_processes = reg.gauge(
            "svgd_elastic_processes",
            "current process count of the supervised run's mesh "
            "(1 = single-host)")
        self._g_processes.set(_sampler_process_count(sampler))
        self._reshard_events: list = []
        self._pending_recovery: Optional[dict] = None
        if diagnostics is not None and diagnostics.enabled:
            # a Sampler's own score closure feeds KSD unless the config
            # already names one (DistSampler harnesses contribute none)
            diagnostics.ensure_score_fn(self._harness.score_fn)
        self._diag = diagnostics if diagnostics is not None else _diagnostics.DISABLED
        self._diag_last_t = 0
        self._diag_run_report = None
        self._recorder = recorder
        #: Report of the most recent :meth:`run` call.
        self.report: Optional[dict] = None

    # ------------------------------------------------------------------ #
    # injection / signal surface (the faults' ``ctx``)

    @property
    def t(self) -> int:
        """Current absolute step counter."""
        return self._harness.t

    @property
    def num_shards(self) -> int:
        """Current mesh shard count (1 for a single-device Sampler) — the
        topology the faults' ``ctx`` sees and elastic resharding changes."""
        return self._harness.num_shards

    def request_stop(self, reason: str = "stop requested") -> None:
        """Preemption-shaped stop: honoured at the next segment boundary
        with a final checkpoint.  Signal-handler and fault-plan safe (only
        sets a flag)."""
        self._stop_requested = True
        self._stop_reason = reason

    def install_signal_handlers(self, signals=(getattr(_signal, "SIGTERM", None),
                                               getattr(_signal, "SIGINT", None))):
        """Map real SIGTERM/SIGINT onto :meth:`request_stop` — the
        production preemption path (main thread only, like any
        ``signal.signal`` call).  Returns the previous handlers."""
        previous = {}
        for sig in signals:
            if sig is None:
                continue
            previous[sig] = _signal.signal(
                sig, lambda signum, frame: self.request_stop(
                    f"signal {signum}")
            )
        return previous

    def corrupt_particles(self) -> None:
        """NaN-poison one entry of the carried state (fault-injection
        surface — the guards must catch it)."""
        self._harness.corrupt_particles()

    def advance_clock(self, seconds: float) -> None:
        """Make the in-flight segment appear ``seconds`` slower: advances a
        manual clock when one is injected (tests), else consumes the
        injectable ``sleep``."""
        adv = getattr(self._clock, "advance", None)
        if adv is not None:
            adv(seconds)
        else:  # pragma: no cover - production clocks aren't advanceable
            self._sleep(seconds)

    # ------------------------------------------------------------------ #

    def _log(self, **record) -> None:
        if self._logger is not None:
            self._logger.log(**record)

    def _next_boundary(self, t: int) -> int:
        """First absolute grid point past ``t``: multiples of
        ``segment_steps`` and of the checkpoint cadence, capped at
        ``num_steps``.  Resume re-enters the identical grid from any
        boundary — the bitwise-resume invariant."""
        nxt = min(self.num_steps,
                  (t // self._segment_steps + 1) * self._segment_steps)
        if self._manager is not None:
            e = self._manager.every
            nxt = min(nxt, (t // e + 1) * e)
        return max(nxt, t + 1)

    def _state_with_meta(self) -> dict:
        state = self._harness.state_dict()
        # the supervisor's own resume state: the (possibly backed-off)
        # step size must survive a preemption or the resumed trajectory
        # silently re-runs at the diverging ε
        state["sup_step_size"] = np.asarray(self.step_size, dtype=np.float64)
        return state

    def _apply_resume_state(self, state: dict) -> None:
        """Restore a checkpoint's supervisor-side state: the harness payload
        plus the (possibly backed-off) step size.  Subclasses that stamp
        extra metadata into :meth:`_state_with_meta` extend this — the two
        methods are one serialisation seam."""
        self._harness.load_state_dict(state)
        eps = state.get("sup_step_size")
        if eps is not None:
            self.step_size = float(np.asarray(eps))

    def _checkpoint(self, tag: str = "periodic") -> Optional[str]:
        if self._manager is None:
            return None
        t0 = self._clock()
        with _trace.span("train.checkpoint", {"tag": tag, "t": self._harness.t}):
            state = self._state_with_meta()
            path = self._manager.save(self._harness.t, state)
        wall = self._clock() - t0
        self._ckpt_wall_s += wall
        self._n_checkpoints += 1
        self._m_checkpoints.inc(tag=tag)
        self._m_ckpt_seconds.observe(wall)
        self._last_good = (self._harness.t, state)
        self._log(event="checkpoint", tag=tag, t=self._harness.t,
                  wall_s=round(wall, 4), path=path)
        return path

    def _rollback(self) -> None:
        """Restore the last good state (most recent checkpoint, else the
        run-start snapshot)."""
        t_bad = self._harness.t
        t_good, state = self._last_good
        self._harness.load_state_dict(state)
        # replayed boundaries must re-run diagnostics: a drift guard that
        # tripped here has to be re-judged on the replayed trajectory
        self._diag_last_t = min(self._diag_last_t, t_good)
        _trace.instant("train.rollback", {"from_t": t_bad, "to_t": t_good})
        self._log(event="rollback", from_t=t_bad, to_t=t_good)

    def _diag_due(self, t: int) -> bool:
        """Diagnostics cadence on the boundary grid: fire at the first
        boundary at or past each ``every_steps`` multiple (boundaries need
        not be multiples themselves), plus the final boundary."""
        if not self._diag.enabled:
            return False
        k = self._diag.config.every_steps
        return (t // k > self._diag_last_t // k) or t >= self.num_steps

    def _flight(self, kind: str, **fields) -> None:
        """Ring-buffer record into the effective flight recorder (explicit
        arg, else the process-wide one); no-op when neither exists."""
        rec = (self._recorder if self._recorder is not None
               else _trace.flight_recorder())
        if rec is not None:
            rec.record(kind, **fields)

    def _postmortem(self, reason: str, **context) -> Optional[str]:
        """Dump a flight-recorder bundle (explicit ``recorder`` arg, else
        the process-wide one); ``None`` when no recorder is installed.  A
        failing dump is swallowed — it must never mask the real failure."""
        rec = (self._recorder if self._recorder is not None
               else _trace.flight_recorder())
        if rec is None:
            return None
        try:
            path = rec.dump(reason, {
                "t": self._harness.t, "step_size": self.step_size,
                "restarts": self._restarts, "kind": self._harness.kind,
                **context,
            })
        except Exception:
            return None
        self._log(event="postmortem", reason=reason, path=path)
        return path

    def _spend_restart(self, err: BaseException) -> None:
        self._restarts += 1
        self._consecutive_failures += 1
        if self._restarts > self._retry.max_restarts:
            self._log(event="restart_budget_exhausted", t=self._harness.t,
                      restarts=self._restarts - 1,
                      error=f"{type(err).__name__}: {err}")
            self._flight("restart_budget_exhausted", t=self._harness.t,
                         error=f"{type(err).__name__}: {err}")
            self._postmortem("restart_budget_exhausted",
                             error=f"{type(err).__name__}: {err}")
            raise RestartBudgetExhausted(
                f"restart budget ({self._retry.max_restarts}) exhausted at "
                f"step {self._harness.t}: {type(err).__name__}: {err}",
                last_error=err,
            ) from err

    def _handle_transient(self, err: Exception) -> None:
        while True:
            self._spend_restart(err)
            self._m_restarts.inc(kind="transient")
            delay = self._retry.delay_s(self._consecutive_failures)
            _trace.instant("train.retry", {"t": self._harness.t,
                                           "error": type(err).__name__,
                                           "attempt": self._consecutive_failures})
            self._log(event="retry", t=self._harness.t,
                      error=f"{type(err).__name__}: {err}",
                      attempt=self._consecutive_failures,
                      backoff_s=round(delay, 3))
            self._sleep(delay)
            try:
                self._rollback()
                return
            except self._retry.retryable as e:
                # a sticky device error (an illegal address poisons the CUDA
                # context) fails the rollback's copy to the card as well:
                # that is one more failed attempt, so the budget runs out
                # into RestartBudgetExhausted and its postmortem
                err = e

    def _handle_topology(self, err: TopologyFault) -> None:
        """Elastic reshard: rebuild the sampler at the fault's topology from
        the latest checkpoint and continue on the same absolute grid —
        inside the shared restart budget (:meth:`_spend_restart` raises
        :class:`RestartBudgetExhausted` when it is gone)."""
        self._spend_restart(err)
        self._m_restarts.inc(kind="topology")
        from_shards = self._harness.num_shards
        from_processes = _sampler_process_count(self.sampler)
        n_particles = int(self._harness.particles.shape[0])
        requested = err.target_shards
        if requested is None:
            surviving = (err.surviving if err.surviving is not None
                         else from_shards - err.lost_devices)
            requested = self._reshard.target_for_device_loss(
                surviving, n_particles)
        t_detected = self._harness.t
        clock0 = self._clock()
        with _trace.span("train.reshard",
                         {"t": t_detected, "from_shards": from_shards,
                          "requested_shards": requested}):
            if self._manager is not None:
                t_good, state = self._manager.restore_latest(with_step=True)
                if state is None:
                    t_good, state = self._last_good
            else:
                t_good, state = self._last_good
            new_state = reshard_state(state, requested)
            man = read_manifest(new_state)
            to_shards = man["n_shards"] if man is not None else requested
            sampler = self._reshard.build(to_shards)
            harness = _DistHarness(sampler, self._harness._h)
            harness.load_state_dict(new_state)
            eps = new_state.get("sup_step_size")
            if eps is not None:
                self.step_size = float(np.asarray(eps))
            self.sampler = sampler
            self._harness = harness
            self._last_good = (harness.t, new_state)
            # replayed boundaries re-run diagnostics, like a rollback
            self._diag_last_t = min(self._diag_last_t, harness.t)
        reshard_wall = self._clock() - clock0
        steps_lost = t_detected - harness.t
        to_processes = _sampler_process_count(sampler)
        direction = ("grow" if to_shards > from_shards
                     else "shrink" if to_shards < from_shards else "same")
        self._m_reshards.inc(direction=direction)
        self._m_steps_lost.inc(steps_lost)
        self._g_shards.set(to_shards)
        self._g_processes.set(to_processes)
        event = {
            "t_detected": t_detected,
            "resumed_from": harness.t,
            "from_shards": from_shards,
            "requested_shards": requested,
            "to_shards": to_shards,
            "from_processes": from_processes,
            "to_processes": to_processes,
            "steps_lost": steps_lost,
            "reshard_wall_s": round(reshard_wall, 4),
            # filled when the run regains the detection step (replay done)
            "recovery_wall_s": None,
            "_clock0": clock0,
        }
        if self._pending_recovery is not None:
            # a second transition landed before the first replay regained
            # its detection step: close the superseded window honestly
            # (recovery_wall_s stays None) instead of leaking its clock
            self._pending_recovery.pop("_clock0", None)
        self._reshard_events.append(event)
        self._pending_recovery = event
        self._flight("topology_transition", t=t_detected,
                     from_shards=from_shards, to_shards=to_shards,
                     from_processes=from_processes,
                     to_processes=to_processes,
                     steps_lost=steps_lost, reason=str(err))
        self._log(event="reshard", t=t_detected, resumed_from=harness.t,
                  from_shards=from_shards, to_shards=to_shards,
                  from_processes=from_processes, to_processes=to_processes,
                  steps_lost=steps_lost, reshard_wall_s=round(reshard_wall, 4),
                  error=f"{type(err).__name__}: {err}")
        self._sleep(self._retry.delay_s(self._consecutive_failures))

    def _handle_guard(self, err: GuardViolation) -> None:
        self._spend_restart(err)
        self._m_restarts.inc(kind="guard")
        self._m_guard_trips.inc()
        old_eps = self.step_size
        backoff = self._guard.backoff_factor if self._guard else 0.5
        self.step_size = old_eps * backoff
        _trace.instant("train.guard_violation",
                       {"t": self._harness.t, "reason": err.reason})
        self._log(event="guard_violation", t=self._harness.t,
                  reason=err.reason, **err.report,
                  step_size=old_eps, new_step_size=self.step_size)
        self._flight("guard_violation", t=self._harness.t, reason=err.reason)
        self._postmortem("guard_violation", guard_reason=err.reason)
        self._rollback()

    # ------------------------------------------------------------------ #

    def run(self, resume: bool = False) -> dict:
        """Drive the run to ``num_steps`` (or a requested stop).

        ``resume=True`` restores the newest *loadable* checkpoint under the
        manager first (corrupt/partial newest step dirs are skipped —
        ``CheckpointManager.restore_latest``) and continues the exact
        trajectory; with no restorable checkpoint it starts from scratch.
        ``resume=False`` clears the manager root (a previous run's step
        dirs would poison retention and later resumes — the covertype
        driver's fresh-run hygiene).

        Returns a report dict (also kept as :attr:`report`):
        ``status`` (``'completed'`` | ``'preempted'``), ``t``,
        ``steps_run``, ``restarts``, ``checkpoints``, wall-clock totals and
        the checkpoint-overhead fraction.  Raises
        :class:`RestartBudgetExhausted` when recovery gives out; an
        exception outside the retryable set (e.g. a simulated hard kill)
        propagates unhandled — by design, that is the no-cleanup crash the
        next ``run(resume=True)`` recovers from."""
        wall0 = self._clock()
        # per-run state: a preempted supervisor is commonly re-run
        # (run(resume=True)) — totals must not accumulate across runs, and
        # restarts spent in an earlier run must not deplete this run's
        # retry budget
        self._restarts = 0
        self._consecutive_failures = 0
        self._ckpt_wall_s = 0.0
        self._seg_wall_s = 0.0
        self._max_seg_wall_s = 0.0
        self._n_checkpoints = 0
        self._n_segments = 0
        self._reshard_events = []
        self._pending_recovery = None
        # clear the stop flag BEFORE the (potentially long) resume-restore:
        # a real SIGTERM landing while a large checkpoint loads must be
        # honoured at the first boundary, not silently discarded
        self._stop_requested = False
        self._stop_reason = None
        resumed_from = None
        if resume and self._manager is not None:
            state = self._manager.restore_latest()
            if state is not None:
                self._apply_resume_state(state)
                resumed_from = self._harness.t
                self._log(event="resume", t=resumed_from,
                          step_size=self.step_size)
        elif self._manager is not None:
            self._manager.clear()
        start_t = self._harness.t
        self._diag_last_t = start_t
        # only a report computed during THIS run may land in its report
        # dict: the diagnostics instance is shareable (the fault drill
        # reuses one across phases) and a run preempted before its first
        # cadence boundary must not inherit another run's numbers
        self._diag_run_report = None
        self._last_good = (start_t, self._state_with_meta())
        if self._manager is not None and resumed_from is None:
            # a step-`start` baseline: retry/guard rollback and a very
            # early preemption always have an on-disk target
            self._checkpoint(tag="initial")

        status = "completed"
        while self._harness.t < self.num_steps:
            if self._stop_requested:
                status = "preempted"
                break
            t0 = self._harness.t
            k = self._next_boundary(t0) - t0
            prev = (self._harness.particles
                    if self._guard is not None and self._guard.needs_prev
                    else None)
            seg0 = self._clock()
            try:
                if self._faults is not None:
                    # inside the timed try block deliberately: a RaiseAt is
                    # a failed dispatch of THIS segment (retry path), a
                    # SlowSegmentAt lands in this segment's wall, a
                    # PreemptAt is honoured before the segment runs
                    self._faults.fire_due(self)
                if self._stop_requested:
                    continue  # loop top checkpoints and reports preempted
                with _trace.span("train.segment",
                                 {"t0": t0, "steps": k,
                                  "kind": self._harness.kind}):
                    self._harness.run_segment(k, self.step_size)
                    # fence inside the try (and the span): an asynchronous
                    # CUDA failure must surface here, in the segment that
                    # caused it (as a retryable torch.AcceleratorError), not
                    # at a random later host sync — and the segment wall
                    # must be honest
                    _trace.fence(self._harness.particles)
            except self._retry.retryable as e:
                self._handle_transient(e)
                continue
            except TopologyFault as e:
                if self._reshard is None or self._harness.kind != "distsampler":
                    # no elastic policy (or a single-device run, which has
                    # no topology to reshard): non-recoverable, like any
                    # fault outside the retry set — black box, propagate
                    self._flight("fault", t=self._harness.t,
                                 error=f"{type(e).__name__}: {e}")
                    self._postmortem("fault",
                                     error=f"{type(e).__name__}: {e}")
                    raise
                self._handle_topology(e)
                continue
            except Exception as e:
                # non-retryable fault (a simulated hard kill, a crash
                # outside the retry set): dump the black box, then
                # propagate unhandled — by design this is the no-cleanup
                # crash the next run(resume=True) recovers from
                self._flight("fault", t=self._harness.t,
                             error=f"{type(e).__name__}: {e}")
                self._postmortem("fault",
                                 error=f"{type(e).__name__}: {e}")
                raise
            seg_wall = self._clock() - seg0
            self._seg_wall_s += seg_wall
            self._max_seg_wall_s = max(self._max_seg_wall_s, seg_wall)
            self._n_segments += 1
            # the histogram mirrors _n_segments (a guard-tripped segment
            # still burned this wall); the steps counter must NOT mirror it
            # — rolled-back steps are not progress, so it increments only
            # after the guard admits the segment (below)
            self._m_seg_seconds.observe(seg_wall)
            if self._slow_warn is not None and seg_wall > self._slow_warn:
                self._log(event="slow_segment", t=self._harness.t,
                          wall_s=round(seg_wall, 4),
                          threshold_s=self._slow_warn)
            if self._guard is not None:
                try:
                    check_state(self._harness.particles, prev=prev,
                                steps=k, config=self._guard)
                except GuardViolation as e:
                    self._handle_guard(e)
                    continue
            t_now = self._harness.t
            if self._diag_due(t_now):
                d_report = self._diag.compute(
                    self._harness.particles,
                    num_shards=self._harness.num_shards, step=t_now)
                self._diag_last_t = t_now
                self._diag_run_report = d_report
                if (d_report is not None and self._guard is not None
                        and self._guard.checks_diagnostics):
                    try:
                        check_diagnostics(d_report, self._guard)
                    except GuardViolation as e:
                        self._handle_guard(e)
                        continue
            self._consecutive_failures = 0
            self._m_steps.inc(k)
            if (self._pending_recovery is not None
                    and self._harness.t >= self._pending_recovery["t_detected"]):
                # the replay regained the step the topology fault landed on:
                # close the recovery window (reshard + backoff + replay)
                ev = self._pending_recovery
                ev["recovery_wall_s"] = round(
                    self._clock() - ev.pop("_clock0"), 4)
                self._pending_recovery = None
            self._log(event="segment", t=self._harness.t, steps=k,
                      wall_s=round(seg_wall, 4), step_size=self.step_size)
            if self._manager is not None and (
                    self._harness.t % self._manager.every == 0
                    or self._harness.t >= self.num_steps):
                self._checkpoint()

        if status == "preempted":
            # signal-triggered checkpoint: the whole point of catching the
            # preemption notice is saving right now, not at the cadence
            self._checkpoint(tag="preempt")
            _trace.instant("train.preempt", {"t": self._harness.t,
                                             "reason": self._stop_reason})
            self._log(event="preempted", t=self._harness.t,
                      reason=self._stop_reason)

        if self._pending_recovery is not None:
            # run ended (preempt/complete) before the replay regained the
            # detection step: recovery_wall_s honestly stays None
            self._pending_recovery.pop("_clock0", None)
            self._pending_recovery = None
        wall = self._clock() - wall0
        self.report = {
            "status": status,
            "t": self._harness.t,
            "steps_run": self._harness.t - start_t,
            "resumed_from": resumed_from,
            "num_shards": self._harness.num_shards,
            "reshards": len(self._reshard_events),
            "reshard_events": list(self._reshard_events),
            "restarts": self._restarts,
            "checkpoints": self._n_checkpoints,
            "segments": self._n_segments,
            "step_size": self.step_size,
            "stop_reason": self._stop_reason,
            "wall_s": round(wall, 4),
            "segment_wall_s": round(self._seg_wall_s, 4),
            "max_segment_wall_s": round(self._max_seg_wall_s, 4),
            "checkpoint_wall_s": round(self._ckpt_wall_s, 4),
            "checkpoint_overhead_frac": round(
                self._ckpt_wall_s / self._seg_wall_s, 4
            ) if self._seg_wall_s > 0 else 0.0,
            "last_diagnostics": self._diag_run_report,
        }
        self._log(event=status, **{k: v for k, v in self.report.items()
                                   if k != "status"})
        return self.report

    @property
    def particles(self):
        """The supervised run's current global particle array."""
        return self._harness.particles
