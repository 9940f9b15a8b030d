"""Federation supervision: keep a W-process multi-host training job alive
across whole-worker losses.

Counterpart of ``dist_svgd_tpu/resilience/federation.py`` on the port's
telemetry (the coordinator loop is plain Python).  The real launcher — the
multi-host training tool that spawns ``torch.distributed`` workers and
delivers an actual ``SIGKILL`` — waits for the multi-host backend (ROADMAP
A10); the loop takes an injectable launcher, so it is whole without it.

:class:`~dist_svgd_torch.resilience.supervisor.RunSupervisor` recovers
*in-process* faults; a multi-host federation adds the failure unit nothing
in-process can catch — an entire worker process dying (host SIGKILL, OOM,
node loss).  The surviving coordinator must then tear the rest of the
rendezvous down (a federation with a hole deadlocks at its next collective)
and restart the job at W−1 processes, resuming from the host-sharded
checkpoints every worker wrote (``DistSampler.state_dict`` per-process
blocks → ``utils/checkpoint.py:assemble_full_state`` → ``reshard_state``),
on the same absolute step grid.

:class:`FederationSupervisor` is that coordinator loop, written against an
injectable **launcher** (``launcher(process_count, attempt) -> [worker
handles]``) so the whole recovery path runs on the CPU with
:class:`FakeWorker` scripts — no processes, sockets, or signals — while
real mode passes a launcher that spawns the actual worker subprocesses
(:class:`SubprocessWorker`) and delivers an actual ``SIGKILL``.

A worker handle is anything with ``name``, ``poll() -> Optional[int]``
(None while running, exit code once dead; negative = killed by signal),
``kill()``, and ``wait(timeout_s) -> Optional[int]``.
"""

from __future__ import annotations

import time
from typing import Callable, List, Optional, Sequence

from dist_svgd_torch.telemetry import metrics as _metrics
from dist_svgd_torch.telemetry import trace as _trace


class FederationDead(RuntimeError):
    """The federation cannot make progress: the restart budget is gone or
    fewer than ``min_processes`` workers survive.  ``report`` carries the
    supervisor's transition history for the post-mortem."""

    def __init__(self, msg: str, report: Optional[dict] = None):
        super().__init__(msg)
        self.report = report or {}


class FakeWorker:
    """Deterministic scripted worker for CPU federation tests.

    ``script`` is the sequence of ``poll()`` results the worker plays back
    (``None`` = still running, an int = exit code from then on); an
    exhausted script keeps returning its final entry, and an all-``None``
    script models a worker that runs until :meth:`kill`.  ``kill`` flips
    the handle to exit code ``-9`` (SIGKILL-shaped), as a real killed
    subprocess reports."""

    def __init__(self, name: str, script: Sequence[Optional[int]] = (None,)):
        self.name = str(name)
        self._script = list(script) or [None]
        self._i = 0
        self._forced: Optional[int] = None
        self.killed = False

    def poll(self) -> Optional[int]:
        if self._forced is not None:
            return self._forced
        i = min(self._i, len(self._script) - 1)
        self._i += 1
        rc = self._script[i]
        if rc is not None:
            self._forced = int(rc)
        return rc

    def kill(self) -> None:
        self.killed = True
        self._forced = -9

    def wait(self, timeout_s: float = 0.0) -> Optional[int]:
        return self.poll()


class SubprocessWorker:
    """Real-mode handle over a ``subprocess.Popen`` worker."""

    def __init__(self, name: str, popen):
        self.name = str(name)
        self._p = popen

    @property
    def pid(self) -> int:
        return self._p.pid

    def poll(self) -> Optional[int]:
        return self._p.poll()

    def kill(self) -> None:
        if self._p.poll() is None:
            self._p.kill()

    def wait(self, timeout_s: float = 30.0) -> Optional[int]:
        import subprocess

        try:
            return self._p.wait(timeout=timeout_s)
        except subprocess.TimeoutExpired:
            return None


class FederationSupervisor:
    """Launch → watch → (on worker loss) shrink-and-relaunch loop.

    ``launcher(process_count, attempt)`` starts one federation generation
    and returns its worker handles; generation 0 is the fresh start, later
    attempts are resumed restarts (the launcher passes that fact to its
    workers — typically a ``--resume`` flag pointing at the per-process
    checkpoint directory).  :meth:`run` returns a report dict once a
    generation exits cleanly (every worker rc 0), after recording each
    transition's process dimension in the ``svgd_elastic_*`` metrics and
    the flight recorder (the same channel the in-process elastic reshard
    uses, so fleet dashboards see one topology-transition stream).

    ``min_processes`` is the floor a shrink may reach; losing workers past
    it — or spending the restart budget — raises :class:`FederationDead`.
    Time is injectable (``clock``/``sleep``) so CPU drills never wait.
    """

    def __init__(
        self,
        launcher: Callable[[int, int], Sequence],
        *,
        processes: int,
        min_processes: int = 1,
        restart_budget: int = 2,
        poll_interval_s: float = 0.05,
        shutdown_grace_s: float = 30.0,
        registry=None,
        recorder=None,
        logger: Optional[Callable[..., None]] = None,
        clock: Callable[[], float] = time.monotonic,
        sleep: Callable[[float], None] = time.sleep,
    ):
        if processes < 1:
            raise ValueError(f"processes must be >= 1, got {processes}")
        if not 1 <= min_processes <= processes:
            raise ValueError(
                f"min_processes must be in [1, {processes}], "
                f"got {min_processes}"
            )
        if restart_budget < 0:
            raise ValueError("restart_budget must be >= 0")
        self._launcher = launcher
        self.processes = int(processes)
        self.min_processes = int(min_processes)
        self.restart_budget = int(restart_budget)
        self._poll_interval_s = float(poll_interval_s)
        self._grace_s = float(shutdown_grace_s)
        self._logger = logger
        self._clock = clock
        self._sleep = sleep
        self._recorder = recorder
        reg = registry if registry is not None else _metrics.default_registry()
        self.registry = reg
        self._m_losses = reg.counter(
            "svgd_elastic_worker_losses_total",
            "federation worker processes lost (per transition, by reason)")
        self._m_restarts = reg.counter(
            "svgd_elastic_federation_restarts_total",
            "federation generations relaunched after a worker loss")
        self._g_processes = reg.gauge(
            "svgd_elastic_processes",
            "current process count of the supervised run's mesh "
            "(1 = single-host)")
        self._h_restart_wall = reg.histogram(
            "svgd_elastic_federation_restart_seconds",
            "wall from loss detection to the relaunched generation running")
        self.transitions: List[dict] = []
        #: Report of the most recent :meth:`run` call.
        self.report: Optional[dict] = None

    def _log(self, **record) -> None:
        if self._logger is not None:
            self._logger(**record)

    def _flight(self, kind: str, **fields) -> None:
        rec = (self._recorder if self._recorder is not None
               else _trace.flight_recorder())
        if rec is not None:
            rec.record(kind, **fields)

    def _drain(self, workers, grace_s: float) -> None:
        """Kill-and-reap every still-running worker of a torn generation —
        a federation with a hole deadlocks at its next collective, so
        survivors cannot be left to finish."""
        for w in workers:
            if w.poll() is None:
                w.kill()
        deadline = self._clock() + grace_s
        for w in workers:
            remaining = max(0.0, deadline - self._clock())
            w.wait(remaining)

    def run(self) -> dict:
        t0 = self._clock()
        width = self.processes
        attempt = 0
        restarts_spent = 0
        # (event, detect_clock) of a transition whose relaunch is in flight
        pending: Optional[tuple] = None
        while True:
            workers = list(self._launcher(width, attempt))
            if len(workers) != width:
                raise ValueError(
                    f"launcher({width}, {attempt}) returned "
                    f"{len(workers)} workers"
                )
            if pending is not None:
                event, clock0 = pending
                wall = self._clock() - clock0
                event["restart_wall_s"] = round(wall, 4)
                self._h_restart_wall.observe(wall)
                pending = None
            self._g_processes.set(width)
            self._log(event="federation_up", processes=width,
                      attempt=attempt)
            dead = self._watch(workers)
            if not dead:  # every worker exited 0: clean finish
                self.report = {
                    "status": "ok",
                    "processes": width,
                    "initial_processes": self.processes,
                    "restarts": restarts_spent,
                    "transitions": self.transitions,
                    "wall_s": self._clock() - t0,
                }
                return self.report
            t_detect = self._clock()
            lost = len(dead)
            losses = {w.name: w.poll() for w in dead}
            self._m_losses.inc(lost)
            self._drain(workers, self._grace_s)
            survivors = width - lost
            if survivors < self.min_processes:
                raise FederationDead(
                    f"{lost} worker(s) died ({losses}) leaving {survivors} "
                    f"< min_processes {self.min_processes}",
                    report={"transitions": self.transitions,
                            "losses": losses},
                )
            if restarts_spent >= self.restart_budget:
                raise FederationDead(
                    f"restart budget ({self.restart_budget}) exhausted "
                    f"after worker loss ({losses})",
                    report={"transitions": self.transitions,
                            "losses": losses},
                )
            restarts_spent += 1
            attempt += 1
            self._m_restarts.inc()
            event = {
                "from_processes": width,
                "to_processes": survivors,
                "lost": losses,
                "attempt": attempt,
                "restart_wall_s": None,  # closed below, once relaunched
            }
            self._flight("federation_transition",
                         from_processes=width, to_processes=survivors,
                         lost=sorted(losses), attempt=attempt)
            self._log(event="worker_loss", from_processes=width,
                      to_processes=survivors, lost=losses, attempt=attempt)
            width = survivors
            self.transitions.append(event)
            # loop: relaunch at the shrunk width as a resumed generation;
            # the restart wall closes once the launcher returns up top
            pending = (event, t_detect)

    def _watch(self, workers) -> list:
        """Poll until the generation resolves: returns the list of workers
        that died with a nonzero/killed status (empty = clean finish).  A
        worker exiting 0 early is fine — it simply finished its share."""
        while True:
            codes = [w.poll() for w in workers]
            dead = [w for w, rc in zip(workers, codes)
                    if rc is not None and rc != 0]
            if dead:
                return dead
            if all(rc == 0 for rc in codes):
                return []
            self._sleep(self._poll_interval_s)
