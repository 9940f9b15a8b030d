"""Freshness drill: measure streaming SVGD end to end and emit ONE
``freshness`` JSON row.

Counterpart of ``tools/freshness_drill.py`` (same phases, same row keys,
same unconditional gates).  Two phases, each a full ingest → train →
checkpoint → hot-reload loop over the :mod:`dist_svgd_torch.streaming`
stack (logistic-regression posterior on a synthetic drifting stream; on
the card every step launches the small-d φ kernel at d = dim + 1):

1. **bitwise** — a manual-clock replay: run A streams ``2k`` segments
   uninterrupted; run B streams ``k``, dies (every in-memory object
   dropped), and a cold process resumes from the checkpoint root on the
   same clock timeline for ``k`` more.  Final particles AND the stream
   cursor must be **bitwise identical** — the supervisor's resume
   exactness extended to continuously-arriving data.
2. **measured** — a real-clock run: batches become due every
   ``period_s`` on ``time.perf_counter``'s timeline, the drill paces one
   segment per arriving batch, and every segment publishes through
   ``CheckpointHotReloader`` to a live ``PredictiveEngine``.  The
   warm-up segments train to (near) convergence while recording the
   healthy posterior's pre-train check KSD; the drift guard is then
   armed at ``ksd_factor ×`` the recent maximum of that series
   (calibrate-then-arm — a fixed a-priori threshold would be wrong on
   every new model/box pair), a ``DriftAt`` **label-flip** is injected a
   few ordinals ahead (a full concept inversion: a covariate mean shift
   actually makes logreg *easier* — far from the boundary the likelihood
   flattens and the stale posterior looks fine), and the steady-state
   window runs under ``parallel/plan.py:capture_sentry``.  The row's
   ``freshness_p50_s``/``p99_s`` are the measured event-time →
   first-serve latencies; drift must be detected and escalated to a
   re-fit within ``drift_window`` segments of the drifted ordinal's
   ingest.

Capture accounting: the port's sentry counts CUDA-graph captures (new
argument signatures of the engine's programs; on the CPU their first
eager calls) plus hand-kernel builds, where JAX's counts XLA compiles.
Each admitted hot reload builds and warms one program per live bucket
over the new ensemble before its swap — the documented off-request-path
capture (``PredictiveEngine.reload``).  The expected count is what the
engine reports staging: the ``warmed_buckets`` of every admitted reload
the reloader logs.  ``steady_state_recompiles`` is the excess, and the
gate FAILs on any — a bucket first built on the request path, a kernel
build in the training step, the drift diagnostics or the checkpoint path.

Unconditional FAILs (``row_ok``): lost stream batches, a non-bitwise
kill→resume, drift served without retraining, any steady-state
recompile, or a breached streaming SLO.

Usage (the card unless ``--device cpu``)::

    python -m dist_svgd_torch.tools.freshness_drill
    python -m dist_svgd_torch.tools.freshness_drill --device cpu
    python -m dist_svgd_torch.tools.freshness_drill --steady-segments 30 --period 0.05
"""

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

from dist_svgd_torch.models.logreg import make_logreg_split
from dist_svgd_torch.ops.kernels import RBF
from dist_svgd_torch.parallel.plan import capture_sentry
from dist_svgd_torch.resilience import DriftAt, GuardConfig
from dist_svgd_torch.sampler import Sampler
from dist_svgd_torch.serving.engine import CheckpointHotReloader, PredictiveEngine
from dist_svgd_torch.streaming import (
    GrowingCorpusStream,
    RowRing,
    StreamBuffer,
    StreamingSupervisor,
)
from dist_svgd_torch.telemetry import MetricsRegistry
from dist_svgd_torch.telemetry.diagnostics import DiagnosticsConfig, PosteriorDiagnostics
from dist_svgd_torch.telemetry.slo import default_streaming_slos
from dist_svgd_torch.utils.platform import resolve_device
from dist_svgd_torch.utils.rng import init_particles


class ManualClock:
    """Injectable clock for the bitwise phase: time moves only when the
    drill says so, so 'hours' of stream replay in milliseconds."""

    def __init__(self, t: float = 0.0):
        self.t = float(t)

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


class _ReloadLog:
    """The reloader's logger: keeps its records (each admitted swap's
    ``warmed_buckets`` is the engine's own account of what it staged)."""

    def __init__(self):
        self.records = []

    def log(self, **record) -> None:
        self.records.append(record)

    def staged_programs(self) -> int:
        return sum(len(r["warmed_buckets"]) for r in self.records
                   if r.get("event") == "hot_reload")


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def _build_stack(root, clock, registry, *, dim, batch_rows, corpus_rows,
                 batch_size, n_particles, steps_per_segment, refit_steps,
                 step_size, seed, period_s, start_time, device, faults=(),
                 buffer_capacity=64, drift_diag=None, reloader=None):
    """One fresh streaming stack (source → buffer → ring → sampler →
    supervisor) on a shared clock timeline and checkpoint root."""
    source = GrowingCorpusStream(
        batch_rows=batch_rows, dim=dim, seed=seed, period_s=period_s,
        start_time=start_time, faults=faults)
    buffer = StreamBuffer(source, buffer_capacity, registry=registry,
                          clock=clock)
    ring = RowRing(corpus_rows, dim)
    likelihood, prior = make_logreg_split()
    # zero-filled corpus placeholder: segment 1 ingests before it trains,
    # so the sampler never actually steps on this array — it only pins
    # the (capacity, dim) spec every set_data keeps
    sampler = Sampler(
        dim + 1, likelihood, kernel=RBF(1.0),
        data=(np.zeros((corpus_rows, dim), np.float32),
              np.ones((corpus_rows,), np.float64)),
        batch_size=batch_size, log_prior=prior, device=device)
    sup = StreamingSupervisor(
        sampler, step_size, buffer=buffer, ring=ring,
        steps_per_segment=steps_per_segment, refit_steps=refit_steps,
        drift_diagnostics=drift_diag, reloader=reloader,
        checkpoint_dir=root, checkpoint_every=steps_per_segment,
        segment_steps=steps_per_segment, n=n_particles, seed=seed,
        registry=registry, clock=clock, sleep=lambda s: None)
    return source, buffer, ring, sampler, sup


def bitwise_kill_resume(root, *, segments_each_side=2, **cfg):
    """Phase 1: uninterrupted vs killed-and-cold-resumed streaming runs on
    identical manual-clock timelines must end bitwise equal."""
    total = 2 * segments_each_side
    period = cfg["period_s"]

    # -- run A: one process, `total` segments -------------------------- #
    clock_a = ManualClock()
    reg_a = MetricsRegistry()
    _, buf_a, _, _, sup_a = _build_stack(
        os.path.join(root, "bw_a"), clock_a, reg_a, start_time=0.0, **cfg)
    for _ in range(total):
        clock_a.advance(period)
        sup_a.run_segment_once()

    # -- run B: killed after half, cold-resumed on the same timeline ---- #
    clock_b = ManualClock()
    reg_b = MetricsRegistry()
    root_b = os.path.join(root, "bw_b")
    _, _, _, _, sup_b = _build_stack(
        root_b, clock_b, reg_b, start_time=0.0, **cfg)
    for _ in range(segments_each_side):
        clock_b.advance(period)
        sup_b.run_segment_once()
    t_kill = clock_b.t
    del sup_b  # the kill: every in-memory object is gone

    clock_b2 = ManualClock(t_kill)  # wall time keeps flowing
    reg_b2 = MetricsRegistry()
    _, buf_b2, _, _, sup_b2 = _build_stack(
        root_b, clock_b2, reg_b2, start_time=0.0, **cfg)
    for i in range(segments_each_side):
        clock_b2.advance(period)
        sup_b2.run_segment_once(resume=(i == 0))

    bitwise = bool(np.array_equal(_host(sup_a.particles),
                                  _host(sup_b2.particles)))
    return {
        "bitwise": bitwise and sup_a.t == sup_b2.t
        and buf_a.next_ordinal == buf_b2.next_ordinal,
        "segments": total,
        "t": sup_a.t,
        "stream_ordinals": buf_a.next_ordinal,
        "dropped": buf_a.dropped + buf_b2.dropped,
    }


def measured_stream(root, *, steady_segments, warmup_segments, ksd_factor,
                    drift_after, drift_magnitude, drift_window, max_lag_s,
                    probe_rows, **cfg):
    """Phase 2: the real-clock measured run (see module docstring)."""
    registry = MetricsRegistry()
    clock = time.perf_counter
    period = cfg["period_s"]
    dim = cfg["dim"]
    ckpt_root = os.path.join(root, "measured")

    # serving side first: the engine cold-starts on the same initial
    # ensemble the supervisor will draw (same seed through the same
    # init_particles path), one 8-wide padding bucket, warmed now so the
    # steady window's serve path is capture-free
    device = cfg["device"]
    parts0 = init_particles(cfg["seed"], cfg["n_particles"], dim + 1, device=device)
    engine = PredictiveEngine("logreg", parts0, min_bucket=probe_rows,
                              max_bucket=probe_rows, registry=registry,
                              device=device)
    engine.warmup()
    reload_log = _ReloadLog()
    reloader = CheckpointHotReloader(engine, ckpt_root, key="particles",
                                     logger=reload_log)

    diag = PosteriorDiagnostics(
        DiagnosticsConfig(every_steps=1, row_chunk=256, max_points=256),
        registry=registry)

    source, buffer, _, _, sup = _build_stack(
        ckpt_root, clock, registry, start_time=clock() + period,
        drift_diag=diag, reloader=reloader, **cfg)
    x_probe = np.zeros((probe_rows, dim), np.float32)

    def wait_for_batch(timeout_s=30.0):
        deadline = clock() + timeout_s
        while not source.due(buffer.next_ordinal, clock()):
            if clock() > deadline:  # pragma: no cover - pathological box
                raise TimeoutError("stream stalled: no batch became due")
            time.sleep(period / 20)

    # -- warm-up: segment 1 builds the φ kernel; the never-trip guard
    # makes every later segment run the drift check, whose pre-train KSD
    # series is the calibration baseline ------------------------------- #
    sup.drift_guard = GuardConfig(max_ksd=float("inf"))
    g_ksd = registry.gauge("svgd_diag_ksd")
    base_ksds = []
    for _ in range(warmup_segments):
        wait_for_batch()
        sup.run_segment_once()
        engine.predict(x_probe)
        if g_ksd.has():
            base_ksds.append(float(g_ksd.value()))

    # -- calibrate-then-arm: threshold = factor × the recent max of the
    # healthy posterior's own pre-train check KSD (early-training KSD
    # still climbs, so only the tail of the series is trusted) ---------- #
    ksd_baseline = max(base_ksds[-4:]) if base_ksds else float(
        diag.compute(sup.particles, num_shards=1, step=sup.t)["ksd"])
    ksd_threshold = ksd_baseline * ksd_factor
    sup.drift_guard = GuardConfig(max_ksd=ksd_threshold)
    # inject concept drift a few ordinals ahead — every batch from
    # `drift_ordinal` on has `drift_magnitude` of its labels flipped
    # (deterministic per ordinal; mutating faults mid-run only affects
    # ordinals not yet pulled)
    drift_ordinal = buffer.next_ordinal + drift_after
    source.faults = (DriftAt(drift_ordinal, kind="label_flip",
                             magnitude=drift_magnitude),)

    # -- steady-state window under the capture sentry ------------------- #
    staged0 = reload_log.staged_programs()
    segments = []
    reloads = 0
    drift_seg = None
    drift_ingest_seg = None
    drift_detect_s = None
    t_win0 = clock()
    with capture_sentry("freshness steady state") as sentry:
        for i in range(steady_segments):
            wait_for_batch()
            seg = sup.run_segment_once()
            engine.predict(x_probe)  # serve the freshly-reloaded ensemble
            segments.append(seg)
            if seg["reload_step"] is not None:
                reloads += 1
            if drift_ingest_seg is None and buffer.next_ordinal > drift_ordinal:
                drift_ingest_seg = i
            if drift_seg is None and seg["drift"]:
                drift_seg = i
                drift_detect_s = clock() - source.event_time(drift_ordinal)
    wall_s = clock() - t_win0

    # the documented per-generation program rebuild is the ONLY capture
    # the window may contain; anything beyond it is a regression
    expected_compiles = reload_log.staged_programs() - staged0
    recompiles = (sentry.compiles - expected_compiles
                  if sentry.supported else None)

    freshness = [s["freshness_s"] for s in segments
                 if s["freshness_s"] is not None]
    refits = sum(1 for s in segments if s["refit"])
    detect_segments = (None if drift_seg is None or drift_ingest_seg is None
                       else drift_seg - drift_ingest_seg)
    slo_doc = default_streaming_slos(
        registry, max_lag_s=max_lag_s, drop_budget=0.0).evaluate()

    return {
        "platform": "gpu" if device.type == "cuda" else "cpu",
        "segments": len(segments),
        "wall_s": round(wall_s, 3),
        "freshness_p50_s": (round(float(np.percentile(freshness, 50)), 4)
                            if freshness else None),
        "freshness_p99_s": (round(float(np.percentile(freshness, 99)), 4)
                            if freshness else None),
        "freshness_count": len(freshness),
        "reloads": reloads,
        "reload_rejections": sum(1 for s in segments if s["reload_rejected"]),
        "reload_wall_ms_hist": registry.histogram(
            "svgd_engine_reload_wall_s").summary(scale=1e3),
        "drift_ordinal": drift_ordinal,
        "ksd_baseline": round(ksd_baseline, 4),
        "ksd_threshold": round(ksd_threshold, 4),
        "drift_detected": drift_seg is not None,
        "drift_detect_segments": detect_segments,
        "drift_detect_latency_s": (round(drift_detect_s, 3)
                                   if drift_detect_s is not None else None),
        "drift_retrained": bool(refits >= 1 and detect_segments is not None
                                and detect_segments <= drift_window),
        "refits": refits,
        "dropped": buffer.dropped,
        "rows_ingested": int(registry.counter(
            "svgd_stream_rows_total").value()),
        "sentry_supported": sentry.supported,
        "sentry_compiles": sentry.compiles if sentry.supported else None,
        "expected_reload_compiles": expected_compiles,
        "steady_state_recompiles": recompiles,
        "slo_status": slo_doc["status"],
        "slo": {name: {"status": o["status"], "burn_rate": o["burn_rate"]}
                for name, o in slo_doc["objectives"].items()},
    }


def run_drill(n_particles=256, dim=5, batch_rows=128, corpus_rows=512,
              batch_size=64, steps_per_segment=16, refit_factor=4,
              step_size=0.05, seed=0, period_s=0.08, steady_segments=18,
              warmup_segments=8, ksd_factor=2.0, drift_after=3,
              drift_magnitude=1.0, drift_window=6, max_lag_s=30.0,
              root=None, device=None):
    """Run both phases; returns the ``freshness`` row."""
    dev = resolve_device(device)
    if root is None:
        root = tempfile.mkdtemp(prefix="freshness_drill_")
    cfg = dict(dim=dim, batch_rows=batch_rows, corpus_rows=corpus_rows,
               batch_size=batch_size, n_particles=n_particles,
               steps_per_segment=steps_per_segment,
               refit_steps=refit_factor * steps_per_segment,
               step_size=step_size, seed=seed, period_s=period_s, device=dev)

    bw = bitwise_kill_resume(root, segments_each_side=2, **cfg)
    measured = measured_stream(
        root, steady_segments=steady_segments,
        warmup_segments=warmup_segments, ksd_factor=ksd_factor,
        drift_after=drift_after, drift_magnitude=drift_magnitude,
        drift_window=drift_window, max_lag_s=max_lag_s, probe_rows=8,
        **cfg)

    row = {
        "metric": "freshness",
        "n": n_particles,
        "dim": dim,
        "batch_rows": batch_rows,
        "corpus_rows": corpus_rows,
        "batch_size": batch_size,
        "steps_per_segment": steps_per_segment,
        "refit_steps": refit_factor * steps_per_segment,
        "period_s": period_s,
        "resumed_bitwise_identical": bw["bitwise"],
        "bitwise_segments": bw["segments"],
        "dropped_total": bw["dropped"] + measured["dropped"],
    }
    row.update(measured)
    return row


def row_ok(row):
    """The unconditional freshness gates; returns ``(ok, why)`` — every
    entry in ``why`` is a FAIL."""
    why = []
    if row.get("dropped_total", 0):
        why.append(f"lost {row['dropped_total']} stream batch(es) — "
                   "buffer overflow dropped data")
    if not row.get("resumed_bitwise_identical"):
        why.append("mid-stream kill->resume was not bitwise identical")
    if not row.get("drift_detected"):
        why.append("injected drift never tripped the guard")
    elif not row.get("drift_retrained"):
        why.append("drift breach served without a timely re-fit "
                   f"(detected after {row.get('drift_detect_segments')} "
                   "segments)")
    if row.get("steady_state_recompiles"):
        why.append(f"{row['steady_state_recompiles']} steady-state "
                   "recompile(s) beyond the documented reload rebuilds")
    if row.get("slo_status") != "ok":
        why.append(f"streaming SLOs: {row.get('slo_status')} "
                   f"({row.get('slo')})")
    if row.get("freshness_p99_s") is None:
        why.append("no freshness observations — nothing was ever served")
    return (not why), why


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m dist_svgd_torch.tools.freshness_drill",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=256, help="particles")
    ap.add_argument("--dim", type=int, default=5, help="feature dim")
    ap.add_argument("--batch-rows", type=int, default=128)
    ap.add_argument("--corpus-rows", type=int, default=512)
    ap.add_argument("--batch-size", type=int, default=64,
                    help="minibatch rows per SVGD step")
    ap.add_argument("--steps-per-segment", type=int, default=16)
    ap.add_argument("--refit-factor", type=int, default=4,
                    help="re-fit steps as a multiple of steps_per_segment")
    ap.add_argument("--stepsize", type=float, default=0.05)
    ap.add_argument("--period", type=float, default=0.08,
                    help="event-time batch spacing, seconds")
    ap.add_argument("--steady-segments", type=int, default=18)
    ap.add_argument("--warmup-segments", type=int, default=8,
                    help="untimed segments training + calibrating the "
                         "drift baseline before the steady window")
    ap.add_argument("--ksd-factor", type=float, default=2.0,
                    help="drift threshold over the calibrated baseline KSD")
    ap.add_argument("--drift-after", type=int, default=3,
                    help="ordinals between arming and the injected drift")
    ap.add_argument("--drift-magnitude", type=float, default=1.0,
                    help="flipped-label fraction of the injected drift")
    ap.add_argument("--drift-window", type=int, default=6,
                    help="segments within which drift must be detected")
    ap.add_argument("--max-lag-s", type=float, default=30.0,
                    help="freshness SLO threshold for the row's slo_status")
    ap.add_argument("--root", default=None,
                    help="checkpoint scratch root (default: a temp dir)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default=None,
                    help="default: the card (fails without CUDA)")
    args = ap.parse_args(argv)

    row = run_drill(
        n_particles=args.n, dim=args.dim, batch_rows=args.batch_rows,
        corpus_rows=args.corpus_rows, batch_size=args.batch_size,
        steps_per_segment=args.steps_per_segment,
        refit_factor=args.refit_factor, step_size=args.stepsize,
        period_s=args.period, steady_segments=args.steady_segments,
        warmup_segments=args.warmup_segments,
        ksd_factor=args.ksd_factor, drift_after=args.drift_after,
        drift_magnitude=args.drift_magnitude,
        drift_window=args.drift_window, max_lag_s=args.max_lag_s,
        root=args.root, device=args.device,
    )
    print(json.dumps(row), flush=True)
    ok, why = row_ok(row)
    if not ok:
        print(json.dumps({"metric": "freshness", "ok": False, "why": why}),
              file=sys.stderr, flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
