"""Fleet failover drill: availability through replica loss, partition,
and readmission — the ``fleet_failover`` row.

Counterpart of ``tools/fleet_drill.py`` with the same row.  The drill runs
steady open-loop load through a
:class:`~dist_svgd_torch.serving.fleet.FleetRouter` over 3 replicas and
walks the failure story end to end:

1. **steady** — baseline latency with everyone healthy;
2. **kill** — one replica dies mid-load (fake: transport ``kill``; real:
   ``SIGKILL`` on the subprocess).  Every in-flight and subsequent
   request must be absorbed by retries/failover: any **lost (non-shed)
   request fails the row**.  Detection latency = kill → circuit-open,
   read off the replica set's transition log;
3. **partition** — a second replica becomes unreachable *from the router*
   while staying alive (fake: ``partition``; real: the
   :class:`~dist_svgd_torch.serving.fleet.HttpTransport` deny-list — the
   subprocess keeps running untouched).  Same ejection path as a crash,
   zero replica-side effects; the row records p99 during the partition
   window;
4. **restart** — the killed replica comes back and must be re-admitted
   through the half-open circuit; time-to-readmit = restore →
   circuit-closed.

Modes:

- ``--mode fake`` (default) — :class:`LoopbackReplica` +
  :class:`FakeTransport`: no sockets, no model, runs in the CPU tests
  (``tests/test_torch_fleet_drill.py`` pins the row schema against JAX's
  and the zero-lost contract);
- ``--mode real`` — 3 ``python -m dist_svgd_torch.serving.server``
  subprocesses serving a seeded ``(64, 3)`` logreg checkpoint over real
  sockets, kill/partition/restart for real.  The replicas run on the card
  unless ``--device cpu`` (JAX pins its replicas to the CPU; the port's
  serve where a user's would).  The real-mode row adds
  ``replica_spawn_s``: each spawn's wall from ``Popen`` to a healthy
  ``/healthz``, the restart's last.

Cross-process observability: the drill additionally measures the fleet's
**trace stitching** and **metrics federation**.  In fake mode each replica
owns its own tracer + metrics registry (standing in for a separate
process), the router traces its route trees, every export lands in a temp
dir and :func:`dist_svgd_torch.tools.trace_report.stitch_files` joins
them — ``trace_stitch_coverage`` must be **1.0** (every non-shed served
request reassembles into exactly one router→replica tree) and the kill
phase's retries must appear as sibling attempts (``stitch_retry_trees >=
1``).  A restart installs a FRESH replica (registry reset to zero), so the
federation's counter-reset clamping is exercised in-drill:
``federation_monotone`` must stay True.  In real mode the federation runs
over real sockets too (``federation_scrape_ms`` is a real scrape wall),
but ``trace_stitch_coverage`` is ``null`` — a SIGKILLed replica takes its
in-memory trace buffer with it, which is exactly why the streamed-export
fake drill carries the stitch gate.

:func:`row_ok` holds the row's correctness gates: no lost request, no
misroute (a routed request reaching an ejected replica), the kill detected
and the restart re-admitted, the partitioned replica alive, fake-mode
stitch coverage 1.0 and a monotone federated counter.

Usage::

    python -m dist_svgd_torch.tools.fleet_drill                  # fake-mode row
    python -m dist_svgd_torch.tools.fleet_drill --mode real      # card replicas
    python -m dist_svgd_torch.tools.fleet_drill --mode real --device cpu
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Tuple

from dist_svgd_torch import telemetry
from dist_svgd_torch.resilience.backoff import Backoff
from dist_svgd_torch.serving import fleet as fleet_mod
from dist_svgd_torch.telemetry.metrics import MetricsRegistry
from dist_svgd_torch.telemetry.trace import Tracer
from dist_svgd_torch.tools import trace_report

#: The repository root, put on a replica subprocess's ``PYTHONPATH`` so
#: ``-m dist_svgd_torch.serving.server`` resolves from any working
#: directory.
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

REPLICAS = ("r0", "r1", "r2")
TENANTS = tuple(f"t{i}" for i in range(8))


def _p99(vals: List[float]) -> float:
    if not vals:
        return 0.0
    vals = sorted(vals)
    return vals[min(len(vals) - 1, int(round(0.99 * (len(vals) - 1))))]


class _OpenLoopLoad:
    """Open-loop request generator: fires at ``rate_hz`` regardless of
    completions (the arrival process a real fleet sees), tagging each
    record with the drill phase active at submit time."""

    def __init__(self, router, rate_hz: float, workers: int = 32,
                 tenant_in_body: bool = True):
        self._router = router
        self._rate = rate_hz
        self._pool = ThreadPoolExecutor(max_workers=workers,
                                        thread_name_prefix="drill-load")
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.phase = ["warmup"]  # single-slot mutable cell
        self.records: List[Tuple[str, int, float]] = []  # (phase, status, s)
        self._tenant_i = 0
        # the routing key is always the tenant; single-tenant
        # PredictionServer replicas reject a "tenant" body field, so the
        # real drill keeps it out of the payload
        self._tenant_in_body = tenant_in_body

    def _one(self, tenant: str, phase: str) -> None:
        doc = {"inputs": [[0.1, 0.2]]}
        if self._tenant_in_body:
            doc["tenant"] = tenant
        body = json.dumps(doc).encode()
        t0 = time.monotonic()
        res = self._router.route(tenant, body)
        self.records.append((phase, res.status, time.monotonic() - t0))

    def _loop(self) -> None:
        interval = 1.0 / self._rate
        t_next = time.monotonic()
        while not self._stop.is_set():
            tenant = TENANTS[self._tenant_i % len(TENANTS)]
            self._tenant_i += 1
            self._pool.submit(self._one, tenant, self.phase[0])
            t_next += interval
            delay = t_next - time.monotonic()
            if delay > 0:
                time.sleep(delay)

    def start(self) -> "_OpenLoopLoad":
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
        self._pool.shutdown(wait=True)

    def counts(self, phase: str) -> Dict[str, Any]:
        rows = [r for r in self.records if r[0] == phase]
        lost = sum(1 for _, s, _ in rows if s >= 500)
        shed = sum(1 for _, s, _ in rows if s == 429)
        ok = sum(1 for _, s, _ in rows if 200 <= s < 300)
        lat = [w for _, s, w in rows if 200 <= s < 300]
        return {"total": len(rows), "ok": ok, "lost": lost, "shed": shed,
                "p99_ms": round(_p99(lat) * 1e3, 3)}


def _transition_ts(replica_set, rid: str, to_state: str,
                   after_ts: float) -> Optional[float]:
    for ts, r, _frm, to, _reason in list(replica_set.state_changes):
        if r == rid and to == to_state and ts >= after_ts:
            return ts
    return None


# --------------------------------------------------------------------- #
# replica backends


class _FakeFleet:
    """3 LoopbackReplicas on a FakeTransport; faults are transport flips.

    Each replica owns its OWN tracer and metrics registry — the
    in-process stand-in for separate replica processes, so the drill can
    exercise cross-process stitching and federation without sockets.  A
    ``restart`` installs a **fresh** replica (counters back at zero, new
    tracer): exactly the reset the federation must clamp.  Every
    generation's tracer is kept for export — modelling replicas that
    stream their JSONL exports off-process (the reason fake mode can
    stitch through a kill while real mode cannot)."""

    def __init__(self, trace: bool = True):
        self._trace = trace
        self.generations: List[Tuple[str, Tracer]] = []
        self.replicas: Dict[str, fleet_mod.LoopbackReplica] = {}
        self.transport = fleet_mod.FakeTransport({})
        for rid in REPLICAS:
            self.replicas[rid] = self._make_replica(rid)
            self.transport.set_replica(rid, self.replicas[rid])

    def _make_replica(self, rid):
        tracer = None
        if self._trace:
            tracer = Tracer(registry=MetricsRegistry())
            tracer.set_process("replica", rid)
            self.generations.append((rid, tracer))
        return fleet_mod.LoopbackReplica(
            rid, predict_fn=self._predict, tenants=TENANTS,
            registry=MetricsRegistry(), tracer=tracer)

    @staticmethod
    def _predict(inputs, tenant, headers):
        time.sleep(0.001)  # a realistic (tiny) dispatch floor
        return {"mean": [0.0] * len(inputs)}

    def kill(self, rid):
        self.transport.kill(rid)

    def partition(self, rid):
        self.transport.partition(rid)

    def heal(self, rid):
        self.transport.restore(rid)

    def restart(self, rid):
        # a restarted process comes back EMPTY: fresh registry (counter
        # reset → federation clamp) and fresh tracer (new epoch/anchor)
        self.replicas[rid] = self._make_replica(rid)
        self.transport.set_replica(rid, self.replicas[rid])
        self.transport.restore(rid)

    def close(self):
        pass

    def export_traces(self, outdir: str) -> List[str]:
        """One Chrome export per replica generation (r0 may have two:
        pre-kill and post-restart)."""
        paths = []
        counts: Dict[str, int] = {}
        for rid, tracer in self.generations:
            gen = counts.get(rid, 0)
            counts[rid] = gen + 1
            path = os.path.join(outdir, f"{rid}-gen{gen}.json")
            tracer.export_chrome(path)
            paths.append(path)
        return paths

    def assert_partition_clean(self, rid) -> Dict[str, Any]:
        """The partitioned replica must be ALIVE: reachable directly (not
        through the router's cut) and with zero flight-recorder trips."""
        rep = self.replicas[rid]
        reply = rep.handle("GET", "/healthz", None, {})
        return {"alive": reply.status == 200,
                "flight_trips": rep.flight_trips,
                "served_during_partition": rep.requests}


class _RealFleet:
    """3 PredictionServer subprocesses over real sockets, on ``device``
    (``None``: the server's default, the card)."""

    def __init__(self, tmpdir: str, max_batch: int = 16,
                 device: Optional[str] = None):
        import subprocess

        import numpy as np

        from dist_svgd_torch.utils.checkpoint import save_state
        from dist_svgd_torch.utils.ports import listen_port

        self._subprocess = subprocess
        ckpt = os.path.join(tmpdir, "ckpt")
        rng = np.random.default_rng(0)
        save_state(ckpt, {"particles": rng.normal(
            size=(64, 3)).astype(np.float32), "t": 1}, backend="npz")
        self._ckpt = ckpt
        self._tmpdir = tmpdir
        self._max_batch = max_batch
        self._device = device
        #: wall from Popen to a healthy /healthz, one entry a spawn
        self.spawn_s: List[float] = []
        self._spawned_at: Dict[str, float] = {}
        self.addresses: Dict[str, Tuple[str, int]] = {}
        self._procs: Dict[str, Any] = {}
        for rid in REPLICAS:
            # outside the ephemeral range: the router's client sockets cannot
            # take a killed replica's port before its restart rebinds it
            self.addresses[rid] = ("127.0.0.1", listen_port(
                exclude=[port for _, port in self.addresses.values()]))
        self.transport = fleet_mod.HttpTransport(self.addresses)
        for rid in REPLICAS:
            self._spawn(rid)
        for rid in REPLICAS:
            self._wait_healthy(rid)

    def _spawn(self, rid: str) -> None:
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (_ROOT, env.get("PYTHONPATH")) if p)
        host, port = self.addresses[rid]
        cmd = [sys.executable, "-m", "dist_svgd_torch.serving.server",
               "--checkpoint", self._ckpt, "--model", "logreg",
               "--host", host, "--port", str(port),
               "--max-batch", str(self._max_batch), "--max-wait-ms", "1.0"]
        if self._device is not None:
            cmd += ["--device", self._device]
        # the replica's stderr lands in the drill's temp dir, so a replica
        # that never turns healthy says why
        with open(os.path.join(self._tmpdir, f"{rid}.log"), "ab") as log:
            self._procs[rid] = self._subprocess.Popen(
                cmd, env=env, stdout=self._subprocess.DEVNULL, stderr=log)
        self._spawned_at[rid] = time.monotonic()

    def _wait_healthy(self, rid: str, timeout_s: float = 120.0) -> None:
        t0 = time.monotonic()
        while time.monotonic() - t0 < timeout_s:
            try:
                reply = self.transport.request(rid, "GET", "/healthz",
                                               timeout_s=1.0)
                if reply.status == 200:
                    self.spawn_s.append(
                        round(time.monotonic() - self._spawned_at[rid], 4))
                    return
            except fleet_mod.TransportError:
                pass
            if self._procs[rid].poll() is not None:
                break  # the process exited: waiting longer cannot help
            time.sleep(0.2)
        with open(os.path.join(self._tmpdir, f"{rid}.log"), "rb") as fh:
            tail = fh.read()[-2000:].decode(errors="replace")
        raise RuntimeError(f"replica {rid} never became healthy:\n{tail}")

    def kill(self, rid):
        self._procs[rid].kill()
        self._procs[rid].wait(timeout=10)

    def partition(self, rid):
        self.transport.partition(rid)

    def heal(self, rid):
        self.transport.heal(rid)

    def restart(self, rid):
        self._spawn(rid)
        self._wait_healthy(rid)

    def close(self):
        for p in self._procs.values():
            try:
                p.kill()
                p.wait(timeout=10)
            except Exception:
                pass

    def assert_partition_clean(self, rid) -> Dict[str, Any]:
        """Bypass the router-side cut: a direct probe (fresh transport, no
        deny-list) must still see a live, healthy process."""
        direct = fleet_mod.HttpTransport(self.addresses)
        try:
            reply = direct.request(rid, "GET", "/healthz", timeout_s=2.0)
            return {"alive": reply.status == 200, "flight_trips": 0,
                    "served_during_partition": None}
        except fleet_mod.TransportError:
            return {"alive": False, "flight_trips": None,
                    "served_during_partition": None}
        finally:
            direct.close()


# --------------------------------------------------------------------- #


def run_drill(mode: str = "fake", *, rate_hz: float = 200.0,
              steady_s: float = 0.6, kill_s: float = 0.8,
              partition_s: float = 0.8, probe_interval_s: float = 0.05,
              open_cooldown_s: float = 0.25,
              readmit_timeout_s: float = 10.0,
              hedge: bool = False, trace: bool = True,
              device: Optional[str] = None) -> Dict[str, Any]:
    """Run the drill, return the ``fleet_failover`` row dict.

    ``device`` (real mode) is passed to the replicas as ``--device``;
    ``None`` leaves them on their default, the card.

    ``trace`` (fake mode) enables the router-side tracer and the replica
    stand-in tracers, exports every process's trace to a temp dir, and
    stitches them (``trace_report.stitch_files``) into the
    ``trace_stitch_coverage`` / ``stitch_retry_trees`` row fields.  Real
    mode never stitches (a SIGKILL takes the replica's in-memory trace
    buffer with it) — coverage reads ``null`` there."""
    if mode not in ("fake", "real"):
        raise ValueError(f"mode must be fake|real, got {mode!r}")
    registry = MetricsRegistry()
    stitch = mode == "fake" and trace
    router_tracer = None
    own_tracer = False
    trace_t0_us = 0.0
    prev_process = None
    if stitch:
        own_tracer = telemetry.get_tracer() is None
        router_tracer = telemetry.enable(registry=registry)
        # a BORROWED outer tracer (a harness composing tools) gets its
        # identity back afterwards — this process is only "the router"
        # for the drill's duration
        prev_process = (None if own_tracer
                        else router_tracer.process_meta())
        router_tracer.set_process("router", "router")
        # an outer tracer may carry spans from earlier benches: stitch
        # only what THIS drill routes
        trace_t0_us = router_tracer.now() * 1e6
    try:
        return _drill_body(
            mode, stitch=stitch, router_tracer=router_tracer,
            trace_t0_us=trace_t0_us, registry=registry, rate_hz=rate_hz,
            steady_s=steady_s, kill_s=kill_s, partition_s=partition_s,
            probe_interval_s=probe_interval_s,
            open_cooldown_s=open_cooldown_s,
            readmit_timeout_s=readmit_timeout_s, hedge=hedge,
            device=device)
    finally:
        # tracer cleanup on EVERY exit path — a drill aborting mid-phase
        # must not leave the process-global tracer installed (it would
        # silently trace every later bench in this process) or a
        # borrowed one mislabelled as the router
        if stitch:
            if own_tracer:
                telemetry.disable()
            elif prev_process is not None:
                router_tracer.set_process(prev_process["role"],
                                          prev_process["name"])


def _drill_body(mode, *, stitch, router_tracer, trace_t0_us, registry,
                rate_hz, steady_s, kill_s, partition_s, probe_interval_s,
                open_cooldown_s, readmit_timeout_s, hedge, device=None):
    tmpdir = None
    if mode == "real":
        tmpdir = tempfile.TemporaryDirectory(prefix="fleet_drill_")
        try:
            backend = _RealFleet(tmpdir.name, device=device)
        except BaseException:
            tmpdir.cleanup()
            raise
        probe_interval_s = max(probe_interval_s, 0.1)
    else:
        backend = _FakeFleet(trace=stitch)
    t_wall0 = time.monotonic()
    replica_set = fleet_mod.ReplicaSet(
        REPLICAS, backend.transport,
        probe_interval_s=probe_interval_s,
        probe_timeout_s=0.5 if mode == "real" else 0.2,
        fail_threshold=2, passive_fail_threshold=2,
        open_cooldown_s=open_cooldown_s,
        registry=registry,
    )
    router = fleet_mod.FleetRouter(
        list(REPLICAS), transport=backend.transport,
        replica_set=replica_set,
        max_retries=2, per_try_timeout_s=1.0 if mode == "real" else 0.5,
        default_deadline_s=5.0,
        backoff=Backoff(base_s=0.005, factor=2.0, max_s=0.05,
                        jitter_frac=0.2),
        hedge=hedge, registry=registry,
        # real mode shares the host's cores between 3 replicas, the
        # router, and the load generator: a scrape must never stall a
        # sweep for a full second behind one busy replica
        federation_timeout_s=0.5 if mode == "real" else 1.0,
    )
    router.start()
    load = _OpenLoopLoad(router, rate_hz,
                         tenant_in_body=mode == "fake").start()
    partition_clean = None
    federation = router.federation
    try:
        # Federation sweeps run MID-phase, never at a phase boundary: a
        # sweep costs real CPU in the drill process (3 scrapes + dump
        # merge) and on a small host a boundary sweep lands exactly on
        # the kill/partition instant — enough perturbation to tip the
        # (deliberately tight) real-mode fleet into an ejection cascade
        # that the drill would then mis-attribute to the router.

        # phase 1: steady state
        load.phase[0] = "steady"
        time.sleep(steady_s / 2)
        federation.scrape_once()  # everyone alive: the exactness sweep
        time.sleep(steady_s / 2)

        # phase 2: kill r0 under load — retries must absorb every request
        load.phase[0] = "kill"
        t_kill = time.monotonic()
        backend.kill("r0")
        time.sleep(kill_s / 2)
        # the dead replica's scrape FAILS and is counted — federation
        # degrades visibly, the survivors keep federating
        federation.scrape_once()
        time.sleep(kill_s / 2)
        ts_open = _transition_ts(replica_set, "r0", "open", t_kill)
        detect_s = None if ts_open is None else ts_open - t_kill

        # phase 3: partition r1 (alive, unreachable) — same ejection path
        load.phase[0] = "partition"
        t_part = time.monotonic()
        backend.partition("r1")
        time.sleep(partition_s / 2)
        federation.scrape_once()
        time.sleep(partition_s / 2)
        partition_clean = backend.assert_partition_clean("r1")
        backend.heal("r1")

        # phase 4: restart r0 — must come back through half-open
        load.phase[0] = "restart"
        t_restart = time.monotonic()
        backend.restart("r0")
        deadline = time.monotonic() + readmit_timeout_s
        ts_closed = None
        while time.monotonic() < deadline:
            ts_closed = _transition_ts(replica_set, "r0", "closed", t_restart)
            if ts_closed is not None:
                break
            time.sleep(probe_interval_s / 2)
        readmit_s = None if ts_closed is None else ts_closed - t_restart
        load.phase[0] = "cooldown"
        # the restarted replica reports RESET counters: the clamped delta
        # must keep every federated rollup monotone
        federation.scrape_once()
    finally:
        load.stop()
        router.shutdown()
        backend.close()
        if tmpdir is not None:
            tmpdir.cleanup()

    # ---- trace stitch (fake mode): every served route must reassemble
    # into one router→replica tree on its X-Fleet-Trace id
    stitch_report = None
    if stitch:
        with tempfile.TemporaryDirectory(prefix="fleet_stitch_") as sd:
            router_path = os.path.join(sd, "router.json")
            events = [e for e in router_tracer.chrome_events()
                      if e.get("ph") == "M"
                      or e.get("ts", 0.0) >= trace_t0_us - 1.0]
            with open(router_path, "w") as fh:
                json.dump({"traceEvents": events,
                           "displayTimeUnit": "ms",
                           "otherData": {
                               "process": router_tracer.process_meta()}},
                          fh)
            replica_paths = backend.export_traces(sd)
            stitch_report = trace_report.stitch_files(
                [router_path] + replica_paths)

    steady = load.counts("steady")
    kill = load.counts("kill")
    part = load.counts("partition")
    restart = load.counts("restart")
    total = steady["total"] + kill["total"] + part["total"] + restart["total"]
    lost = (steady["lost"] + kill["lost"] + part["lost"] + restart["lost"])
    shed = (steady["shed"] + kill["shed"] + part["shed"] + restart["shed"])
    availability = (1.0 if kill["total"] == 0
                    else kill["ok"] / max(kill["total"] - kill["shed"], 1))

    def _counter_sum(name: str) -> float:
        metric = registry._metrics.get(name)
        if metric is None:
            return 0
        with metric._lock:
            return sum(metric._series.values())

    def _fed_requests_total() -> float:
        """The federated request rollup: every non-replica-labelled
        series summed (the per-tenant rollups partition the total)."""
        metric = federation.fleet_registry.get("svgd_serve_requests_total")
        if metric is None:
            return 0.0
        return float(sum(metric.value(**ls) for ls in metric.label_sets()
                         if "replica" not in ls))

    def _scrape_ms(reg) -> Optional[float]:
        """Median federation sweep wall (ms) off the scrape histogram —
        robust to the one slow sweep a phase transition can catch."""
        hist = reg.get("svgd_fleet_scrape_seconds")
        if hist is None or not hist.summary()["count"]:
            return None
        return round(hist.quantile(0.5) * 1e3, 3)

    row = {
        "metric": "fleet_failover",
        "value": round(availability, 6),
        "unit": "non-shed availability during single-replica loss",
        "mode": mode,
        "replicas": len(REPLICAS),
        "rate_hz": rate_hz,
        "requests": total,
        "lost_requests": lost,
        "shed_requests": shed,
        "detect_s": None if detect_s is None else round(detect_s, 4),
        "detect_probe_intervals": (
            None if detect_s is None
            else round(detect_s / probe_interval_s, 2)),
        "readmit_s": None if readmit_s is None else round(readmit_s, 4),
        "p99_steady_ms": steady["p99_ms"],
        "p99_kill_ms": kill["p99_ms"],
        "p99_partition_ms": part["p99_ms"],
        "retries": int(_counter_sum("svgd_fleet_retries_total")),
        "hedges": int(_counter_sum("svgd_fleet_hedges_total")),
        "failovers": int(_counter_sum("svgd_fleet_failovers_total")),
        "misroutes": int(_counter_sum("svgd_fleet_misroutes_total")),
        "ejections": int(_counter_sum("svgd_fleet_ejections_total")),
        "readmissions": int(_counter_sum("svgd_fleet_readmissions_total")),
        "partition_replica_alive": (
            None if partition_clean is None else partition_clean["alive"]),
        "partition_flight_trips": (
            None if partition_clean is None
            else partition_clean["flight_trips"]),
        "trace_stitch_coverage": (
            None if stitch_report is None else stitch_report["coverage"]),
        "stitch_served_routes": (
            None if stitch_report is None
            else stitch_report["served_routes"]),
        "stitch_retry_trees": (
            None if stitch_report is None
            else stitch_report["retry_trees"]),
        "stitch_orphans": (
            None if stitch_report is None
            else stitch_report["orphan_replica_traces"]),
        "federation_scrape_ms": _scrape_ms(registry),
        "federation_scrapes": federation.scrapes,
        "federation_scrapes_skipped": federation.skips,
        "federation_scrape_errors": int(
            _counter_sum("svgd_fleet_scrape_errors_total")),
        "federation_monotone": federation.monotone,
        "federated_requests_total": _fed_requests_total(),
        "probe_interval_s": probe_interval_s,
        "open_cooldown_s": open_cooldown_s,
        "status_counts": {
            str(s): sum(1 for _, st, _ in load.records if st == s)
            for s in sorted({st for _, st, _ in load.records})},
        "wall_s": round(time.monotonic() - t_wall0, 3),
    }
    if mode == "real":
        row["replica_spawn_s"] = list(backend.spawn_s)
    return row


def row_ok(row: Dict[str, Any]) -> Tuple[bool, List[str]]:
    """The correctness gates of a ``fleet_failover`` row, JAX's: returns
    ``(ok, reasons)``."""
    why = []
    if row["lost_requests"] > 0:
        why.append(f"lost {row['lost_requests']} non-shed request(s) — "
                   "retries failed to absorb a replica loss")
    if row["misroutes"] > 0:
        why.append(f"{row['misroutes']} request(s) routed to an ejected "
                   "replica")
    if row["detect_s"] is None:
        why.append("the killed replica was never ejected")
    if row["readmit_s"] is None:
        why.append("the restarted replica was never re-admitted")
    if row["readmissions"] < 1:
        why.append("no half-open readmission observed")
    if row["partition_replica_alive"] is False:
        why.append("the partitioned replica died — partition must leave "
                   "the process untouched")
    if row["partition_flight_trips"] not in (None, 0):
        why.append("partition tripped the replica's own flight recorder")
    # cross-process observability gates.  Stitch coverage is a
    # fake-mode contract: replica traces there model streamed exports, so
    # EVERY served request must reassemble (real mode reads null — a
    # SIGKILLed process takes its trace buffer with it).
    if row.get("mode") == "fake":
        cov = row.get("trace_stitch_coverage")
        if cov is None or cov < 1.0:
            why.append(f"trace stitch coverage {cov} < 1.0 — some served "
                       "request's router and replica spans no longer join "
                       "on the trace id")
    if row.get("federation_monotone") is False:
        why.append("a federated counter rollup decreased across scrapes — "
                   "the restart clamp broke (negative rates)")
    return (not why), why


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m dist_svgd_torch.tools.fleet_drill",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--mode", choices=("fake", "real"), default="fake")
    ap.add_argument("--rate", type=float, default=200.0,
                    help="open-loop request rate (req/s)")
    ap.add_argument("--hedge", action="store_true",
                    help="enable tail hedging in the router under drill")
    ap.add_argument("--device", choices=("cuda", "cpu"), default=None,
                    help="real mode: the replicas' device (default: the "
                         "card)")
    args = ap.parse_args(argv)
    row = run_drill(mode=args.mode, rate_hz=args.rate, hedge=args.hedge,
                    device=args.device)
    ok, why = row_ok(row)
    row["ok"] = ok
    if why:
        row["failures"] = why
    print(json.dumps(row), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
