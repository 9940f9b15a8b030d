"""Streaming Covertype: continuous-ingest training with hot-serving, on the
card.

Counterpart of ``experiments/streaming_covertype.py``: the same flags and
defaults, the same JSON line.  The Covertype workload is replayed as a
timestamped stream (``streaming.CovertypeReplayStream``: one
``--batch-rows`` slice per ``--period`` seconds of event time) into a
``StreamingSupervisor`` — each segment ingests due batches into the
fixed-shape ``RowRing`` corpus, drift-checks the posterior against the new
data (after a calibrate-then-arm warm-up), trains incrementally,
checkpoints, and publishes to a live ``PredictiveEngine`` through a
``CheckpointHotReloader``.  An injected ``DriftAt`` label flip
(``--drift-at``) demonstrates the KSD guard escalating a segment to a full
re-fit instead of serving the stale posterior.

Event time runs on an injected manual clock (one segment per period), so
'hours' of stream replay in seconds; freshness lag and the streaming SLOs
are evaluated on that event timeline.  The sampler is JAX's: the
single-device ``Sampler`` on the ring (B rows a step of the corpus), a
separate unscaled prior, ``RBF(1.0)``, the library's φ policy (on the card
the exact big-d kernel at d = 55, one launch a step).  JAX's ``--backend``
is ``--device`` here: the card unless ``--device cpu``.  Run it as

    python -m dist_svgd_torch.experiments.streaming_covertype          # the card
    python -m dist_svgd_torch.experiments.streaming_covertype --device cpu

It prints one JSON line (JAX's keys).
"""

from __future__ import annotations

import argparse
import json
import shutil
import tempfile

import numpy as np

from dist_svgd_torch.models.logreg import make_logreg_split
from dist_svgd_torch.ops.kernels import RBF
from dist_svgd_torch.resilience import DriftAt, GuardConfig
from dist_svgd_torch.sampler import Sampler
from dist_svgd_torch.serving import CheckpointHotReloader, PredictiveEngine
from dist_svgd_torch.streaming import (
    CovertypeReplayStream,
    RowRing,
    StreamBuffer,
    StreamingSupervisor,
)
from dist_svgd_torch.telemetry import MetricsRegistry
from dist_svgd_torch.telemetry.diagnostics import DiagnosticsConfig, PosteriorDiagnostics
from dist_svgd_torch.telemetry.slo import default_streaming_slos
from dist_svgd_torch.utils.datasets import load_covertype
from dist_svgd_torch.utils.platform import resolve_device
from dist_svgd_torch.utils.rng import init_particles


class ManualClock:
    def __init__(self, t=0.0):
        self.t = float(t)

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


def run(nrows=6_000, nparticles=128, batch_rows=256, corpus_rows=1024, batch_size=128,
        period=60.0, steps_per_segment=10, refit_factor=4, segments=12,
        warmup_segments=14, ksd_factor=2.0, stepsize=0.05, drift_at=2, drift_frac=1.0,
        max_lag_s=600.0, seed=0, root=None, device=None) -> dict:
    """The whole replay; returns the JSON line's dict.  ``root`` (default: a
    temporary directory, removed on return) is the checkpoint root the
    engine's reloader watches."""
    dev = resolve_device(device)
    # the test slice is the tail of the SAME seeded load the replay
    # stream performs; the segment loop below caps ordinals so the
    # stream never ingests past it — held out by construction
    n_test = max(nrows // 10, 1)
    x_all, t_all = load_covertype(nrows, seed=seed)
    x_test = np.asarray(x_all[nrows - n_test:], np.float32)
    t_test = np.asarray(t_all[nrows - n_test:])
    max_ordinals = (nrows - n_test) // batch_rows

    registry = MetricsRegistry()
    clock = ManualClock(0.0)
    stream = CovertypeReplayStream(
        n_rows=nrows, batch_rows=batch_rows, seed=seed,
        period_s=period, start_time=period)
    buffer = StreamBuffer(stream, capacity=64, registry=registry, clock=clock)
    ring = RowRing(corpus_rows, stream.dim)
    likelihood, prior = make_logreg_split()
    d = stream.dim + 1
    sampler = Sampler(
        d, likelihood, kernel=RBF(1.0),
        data=(np.zeros((corpus_rows, stream.dim), np.float32),
              np.ones((corpus_rows,), np.float64)),
        batch_size=min(batch_size, corpus_rows), log_prior=prior, device=dev)
    diag = PosteriorDiagnostics(
        DiagnosticsConfig(every_steps=1, row_chunk=512, max_points=512),
        registry=registry)

    cleanup = root is None
    root = root or tempfile.mkdtemp(prefix="streaming_covertype_")
    out = {"nrows": nrows, "nparticles": nparticles,
           "batch_rows": batch_rows, "corpus_rows": corpus_rows,
           "period_s": period, "steps_per_segment": steps_per_segment,
           "root": root}
    try:
        engine = PredictiveEngine(
            "logreg", init_particles(seed, nparticles, d, device=dev),
            max_bucket=max(64, n_test), registry=registry, device=dev)
        reloader = CheckpointHotReloader(engine, root, key="particles")
        sup = StreamingSupervisor(
            sampler, stepsize, buffer=buffer, ring=ring,
            steps_per_segment=steps_per_segment,
            refit_steps=refit_factor * steps_per_segment,
            drift_diagnostics=diag, reloader=reloader,
            checkpoint_dir=root, checkpoint_every=steps_per_segment,
            segment_steps=steps_per_segment, n=nparticles, seed=seed,
            registry=registry, clock=clock, sleep=lambda s: None)

        # warm-up + calibrate-then-arm (tools/freshness_drill.py protocol)
        sup.drift_guard = GuardConfig(max_ksd=float("inf"))
        g_ksd = registry.gauge("svgd_diag_ksd")
        base_ksds = []
        for _ in range(warmup_segments):
            clock.advance(period)
            sup.run_segment_once()
            if g_ksd.has():
                base_ksds.append(float(g_ksd.value()))
        ksd_baseline = max(base_ksds[-4:]) if base_ksds else float("inf")
        sup.drift_guard = GuardConfig(max_ksd=ksd_baseline * ksd_factor)
        if drift_at >= 0:
            stream.faults = (DriftAt(buffer.next_ordinal + drift_at,
                                     kind="label_flip",
                                     magnitude=drift_frac),)
        out["calibration"] = {"ksd_baseline": round(ksd_baseline, 3),
                              "ksd_threshold": round(ksd_baseline * ksd_factor, 3)}

        for _ in range(segments):
            if buffer.next_ordinal >= max_ordinals:
                break  # stop short of the held-out tail
            clock.advance(period)
            sup.run_segment_once()
        served = engine.predict(x_test)["mean"]
        slo_doc = default_streaming_slos(registry, max_lag_s=max_lag_s).evaluate()
        out["stream"] = {
            "segments": int(registry.counter("svgd_stream_segments_total").value()),
            "t": sup.t,
            "ordinals": buffer.next_ordinal,
            "rows_ingested": int(registry.counter("svgd_stream_rows_total").value()),
            "dropped": buffer.dropped,
            "refits": int(registry.counter("svgd_stream_refits_total").value()),
            "watermark": buffer.watermark,
        }
        # after a full label-flip drift the refit tracks the NEW concept,
        # so the served ensemble scores against the flipped labels — both
        # views printed so the adaptation is visible in the evidence line
        pred = np.asarray(served) > 0.5
        out["serve"] = {
            "reloads": engine.stats()["reloads"],
            "ensemble_tag": engine.stats()["ensemble_tag"],
            "served_test_acc": float(np.mean(pred == (t_test > 0))),
            "served_test_acc_flipped_concept": float(np.mean(pred == (t_test < 0))),
        }
        out["slo"] = {name: {"status": o["status"], "burn_rate": o["burn_rate"]}
                      for name, o in slo_doc["objectives"].items()}
        out["slo_status"] = slo_doc["status"]
    finally:
        if cleanup:
            shutil.rmtree(root, ignore_errors=True)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m dist_svgd_torch.experiments.streaming_covertype",
        description="Covertype replayed as a stream into continuous-ingest SVGD, each "
                    "segment hot-reloaded into a live engine; prints one JSON line.")
    p.add_argument("--nrows", type=int, default=6_000)
    p.add_argument("--nparticles", type=int, default=128)
    p.add_argument("--batch-rows", type=int, default=256,
                   help="stream rows per event-time period")
    p.add_argument("--corpus-rows", type=int, default=1024,
                   help="RowRing capacity (the sliding training window)")
    p.add_argument("--batch-size", type=int, default=128,
                   help="minibatch rows per SVGD step")
    p.add_argument("--period", type=float, default=60.0,
                   help="event-time seconds between stream batches")
    p.add_argument("--steps-per-segment", type=int, default=10)
    p.add_argument("--refit-factor", type=int, default=4)
    p.add_argument("--segments", type=int, default=12)
    p.add_argument("--warmup-segments", type=int, default=14,
                   help="segments training + calibrating the drift baseline "
                        "before the guard is armed")
    p.add_argument("--ksd-factor", type=float, default=2.0)
    p.add_argument("--stepsize", type=float, default=0.05)
    p.add_argument("--drift-at", type=int, default=2,
                   help="ordinal (relative to arming) whose labels start "
                        "flipping; -1 disables the injected drift")
    p.add_argument("--drift-frac", type=float, default=1.0)
    p.add_argument("--max-lag-s", type=float, default=600.0,
                   help="freshness SLO threshold on the event timeline")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--root", default=None,
                   help="checkpoint root (default: a temp dir, removed on exit)")
    p.add_argument("--device", choices=("cuda", "cpu"), default=None,
                   help="default: the card (fails without CUDA)")
    a = p.parse_args(argv)
    out = run(a.nrows, a.nparticles, a.batch_rows, a.corpus_rows, a.batch_size, a.period,
              a.steps_per_segment, a.refit_factor, a.segments, a.warmup_segments,
              a.ksd_factor, a.stepsize, a.drift_at, a.drift_frac, a.max_lag_s, a.seed,
              a.root, a.device)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
