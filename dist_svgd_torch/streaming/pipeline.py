"""Streaming-ingest training: the batch trainer turned online.

Counterpart of ``dist_svgd_tpu/streaming/pipeline.py``, kept whole: the
same segment lifecycle, checkpoint keys, metric and span names, segment
records and refusals, over the port's :class:`~dist_svgd_torch.resilience.
supervisor.RunSupervisor`.  On the card each training step launches the
hand φ kernel of the sampler's width (``Sampler``'s ``phi_impl`` policy);
the publish leg captures the engine's bucket graphs over each admitted
generation, off the request path.

:class:`StreamingSupervisor` layers continuous ingest over
:class:`~dist_svgd_torch.resilience.supervisor.RunSupervisor`'s segmented
drive.  Each stream segment is one pass of a fixed lifecycle, traced as one
cross-thread lane tree (``ingest ⊃ train.segment ⊃ ckpt ⊃ reload``) so
``trace_report`` attributes exactly where freshness is spent:

1. **ingest** — poll the :class:`~dist_svgd_torch.streaming.source.
   StreamBuffer` for due batches, fold them into the fixed-capacity
   :class:`~dist_svgd_torch.streaming.source.RowRing` corpus, and swap the
   corpus into the sampler (``Sampler.set_data`` — same spec, new tensors);
2. **drift check** — diagnostics (KSD/ESS) on the current particles
   against the score over a reference corpus (the first full ring's, as
   JAX's program judges: :meth:`StreamingSupervisor._reference_score_fn`);
   a
   :class:`~dist_svgd_torch.resilience.guards.GuardViolation` escalates this
   segment from ``steps_per_segment`` incremental steps to a
   ``refit_steps`` full re-fit (counted in ``svgd_stream_refits_total``) —
   drift is never served without retraining against it;
3. **train + ckpt** — extend the absolute step grid and drive the base
   supervisor; every segment ends checkpointed, with the stream cursor /
   watermark / corpus ring riding ``_state_with_meta`` so a kill at ANY
   point resumes bitwise (the ``step_offset`` discipline extended to
   data);
4. **reload** — ``CheckpointHotReloader.poll_once`` publishes the new
   generation to the serving engine; an
   :class:`~dist_svgd_torch.serving.engine.EnsembleRejected` rolls the
   tenant **back, never forward** (the reloader keeps serving the prior
   generation), and an admitted swap stamps the serving watermark the
   freshness SLO reads.

Freshness (event time → first serve) is observed per segment into
``svgd_freshness_seconds``.  Event times and the supervisor clock must
share one timeline — inject the same (manual or ``time.perf_counter``)
clock into the source's ``start_time``, the buffer, and this supervisor,
as ``dist_svgd_torch/tools/freshness_drill.py`` does.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from dist_svgd_torch.parallel.exchange import tree_map
from dist_svgd_torch.resilience.guards import (
    GuardConfig,
    GuardViolation,
    check_diagnostics,
)
from dist_svgd_torch.resilience.supervisor import RunSupervisor
from dist_svgd_torch.streaming.source import RowRing, StreamBuffer
from dist_svgd_torch.telemetry import diagnostics as _diagnostics
from dist_svgd_torch.telemetry import trace as _trace

__all__ = ["StreamingSupervisor"]


class StreamingSupervisor(RunSupervisor):
    """Continuous-ingest driver over a single-device minibatch ``Sampler``.

    Args:
        sampler: a minibatch-mode :class:`~dist_svgd_torch.sampler.Sampler`
            whose ``data`` spec matches ``ring`` (``(capacity, dim)`` /
            ``(capacity,)``) — construct it from ``ring.data()`` after
            priming, or from zeros before the first ingest.  DistSampler
            streaming needs the sharded-data swap and is not wired yet.
        step_size: SVGD ε (the base supervisor's guard backoff applies).
        buffer: the bounded ingest buffer over the stream source.
        ring: the fixed-capacity corpus the sampler trains on.
        steps_per_segment: incremental steps per stream segment.
        refit_steps: steps of an escalated full re-fit segment after a
            drift trip (default ``10 × steps_per_segment``).
        drift_guard: :class:`~dist_svgd_torch.resilience.guards.GuardConfig`
            whose *diagnostics* thresholds (``max_ksd`` /
            ``min_ess_frac``…) define a drift breach on new data.  Kept
            separate from the base supervisor's in-run ``guard`` on
            purpose: drift means *the world moved* — the answer is more
            training on the new data, not the numerical guards' rollback
            + step-size backoff.
        drift_diagnostics: :class:`~dist_svgd_torch.telemetry.diagnostics.
            PosteriorDiagnostics` used for the pre-train drift check
            (the score closure defaults to the sampler's own over the
            reference corpus of :meth:`_reference_score_fn` — the check
            judges the current posterior against the corpus the drift
            threshold was calibrated on).
        reloader: optional :class:`~dist_svgd_torch.serving.engine.
            CheckpointHotReloader` watching this supervisor's manager root
            — polled once per segment (serve leg of the lifecycle).
        checkpointing is **required** (``checkpoint_dir`` or ``manager``):
            segments resume from checkpoints by construction.
        Remaining keyword args are :class:`RunSupervisor`'s.
    """

    def __init__(self, sampler, step_size: float, *,
                 buffer: StreamBuffer, ring: RowRing,
                 steps_per_segment: int,
                 refit_steps: Optional[int] = None,
                 drift_guard: Optional[GuardConfig] = None,
                 drift_diagnostics=None,
                 reloader=None,
                 **kwargs):
        if hasattr(sampler, "run_steps"):
            raise TypeError(
                "StreamingSupervisor drives a single-device minibatch "
                "Sampler; DistSampler streaming is not wired yet"
            )
        if getattr(sampler, "_batch_size", None) is None:
            raise ValueError(
                "StreamingSupervisor requires a minibatch sampler "
                "(batch_size) — full-data scans bake the dataset into the "
                "compiled program and cannot ingest"
            )
        if steps_per_segment < 1:
            raise ValueError(
                f"steps_per_segment must be >= 1, got {steps_per_segment}"
            )
        super().__init__(sampler, num_steps=steps_per_segment,
                         step_size=step_size, **kwargs)
        if self._manager is None:
            raise ValueError(
                "StreamingSupervisor requires checkpointing (checkpoint_dir "
                "or manager): segments publish through checkpoints"
            )
        self._buffer = buffer
        self._ring = ring
        self._steps_per_segment = int(steps_per_segment)
        self._refit_steps = (int(refit_steps) if refit_steps is not None
                             else 10 * self._steps_per_segment)
        if self._refit_steps < self._steps_per_segment:
            raise ValueError(
                f"refit_steps ({self._refit_steps}) must be >= "
                f"steps_per_segment ({self._steps_per_segment})"
            )
        self._drift_guard = drift_guard
        if drift_diagnostics is not None and drift_diagnostics.enabled:
            drift_diagnostics.ensure_score_fn(self._reference_score_fn())
        self._drift_diag = (drift_diagnostics if drift_diagnostics is not None
                            else _diagnostics.DISABLED)
        self._reloader = reloader
        # stream cursor state — rides _state_with_meta so kill→resume is
        # bitwise (the training-side step_offset discipline, for data)
        self._stream_next = 0
        self._stream_watermark: Optional[float] = None
        self._stream_dropped = 0
        self._stream_segments = 0
        self._stream_refits = 0
        reg = self.registry
        self._m_stream_segments = reg.counter(
            "svgd_stream_segments_total", "stream segments completed")
        self._m_stream_refits = reg.counter(
            "svgd_stream_refits_total",
            "segments escalated to a full re-fit by a drift breach")
        self._m_stream_rows = reg.counter(
            "svgd_stream_rows_total", "stream rows ingested into the corpus")
        self._g_corpus = reg.gauge(
            "svgd_stream_corpus_rows", "rows currently held by the corpus")
        self._m_freshness = reg.histogram(
            "svgd_freshness_seconds",
            "event time -> first-serve latency per published segment")
        #: Report of the most recent :meth:`run_stream` call.
        self.stream_report: Optional[dict] = None

    @property
    def drift_guard(self) -> Optional[GuardConfig]:
        """The drift-breach thresholds.  Settable mid-stream: drills and
        experiments run a few unguarded warm-up segments, measure the
        baseline KSD of the healthy posterior, then arm a guard calibrated
        against it (``dist_svgd_torch/tools/freshness_drill.py``'s
        protocol) — a fixed a-priori threshold would be wrong on every new
        model/box pair."""
        return self._drift_guard

    @drift_guard.setter
    def drift_guard(self, guard: Optional[GuardConfig]) -> None:
        self._drift_guard = guard

    def _reference_score_fn(self):
        """The drift check's score closure ``θ ↦ ∇log p(θ)`` over a
        reference corpus: the sampler's current corpus until the ring is
        full, then the corpus of the first check made with a full ring,
        for good.

        JAX's drift check is the sampler's closure jitted once by its
        ``PosteriorDiagnostics``, which bakes the corpus of the first check
        into the program, so every later check judges the posterior against
        that corpus, not the current one — and the drills' calibrate-then-
        arm protocol depends on it.  Where JAX's first check sees a full
        ring (its first segment compiles while batches queue) the port
        judges exactly as JAX's program does.  A first check on a ring
        still tiling a batch or two would pin a duplicated corpus whose
        posterior every later one misses, and the calibrated threshold
        then sits above the flipped posterior's plateau; so the port pins
        only a full ring (ROADMAP C)."""
        pinned = []

        def reference():
            data = pinned[0] if pinned else self.sampler._data
            if not pinned and self._ring.written >= self._ring.capacity:
                pinned.append(data)
            return data

        def score_on(data):
            def score(theta):
                cast = tree_map(lambda a: a.to(theta.dtype) if a.is_floating_point() else a,
                                data)
                return torch.func.grad(self.sampler._full_logp(cast))(theta)

            return score

        # the reference corpus is the closure's input: a captured drift
        # check copies the corpus of each check into its graph, so the
        # graph never bakes in the first check's (the JAX fault above)
        return _diagnostics.data_score(reference, score_on)

    # ------------------------------------------------------------------ #
    # checkpoint seam: stream cursor + corpus ride every save

    def _state_with_meta(self) -> dict:
        state = super()._state_with_meta()
        state.update(self._ring.state_dict())
        state["stream_next"] = np.asarray(self._stream_next, dtype=np.int64)
        state["stream_watermark"] = np.asarray(
            self._stream_watermark if self._stream_watermark is not None
            else -np.inf, dtype=np.float64)
        state["stream_dropped"] = np.asarray(self._stream_dropped,
                                             dtype=np.int64)
        return state

    def _apply_resume_state(self, state: dict) -> None:
        super()._apply_resume_state(state)
        ckpt_next = int(state.get("stream_next", -1))
        if ckpt_next < 0:
            return  # non-streaming checkpoint (plain RunSupervisor save)
        if ckpt_next <= self._stream_next:
            # warm per-segment resume: the in-memory stream is at or past
            # the checkpoint (this segment's ingest already happened) —
            # restoring the older corpus would TRAIN ON STALE DATA
            return
        # cold resume (fresh process): rebuild the corpus bitwise from the
        # checkpointed ring and fast-forward the pull cursor past every
        # batch the corpus already holds
        self._ring.load_state_dict(state)
        self._stream_next = ckpt_next
        wm = float(np.asarray(state["stream_watermark"]))
        self._stream_watermark = None if np.isinf(wm) and wm < 0 else wm
        self._stream_dropped = int(state.get("stream_dropped", 0))
        self._buffer.seek(ckpt_next)
        if self._ring.written > 0:
            self.sampler.set_data(self._ring.data())
        self._g_corpus.set(min(self._ring.written, self._ring.capacity))

    # ------------------------------------------------------------------ #

    def ingest(self, now: Optional[float] = None) -> dict:
        """One ingest pass: poll due batches, fold into the ring, swap the
        corpus into the sampler.  Returns ``{batches, rows, watermark}``."""
        self._buffer.poll(now)
        batches = self._buffer.take()
        rows = 0
        for b in batches:
            self._ring.extend(b.x, b.y)
            rows += b.rows
        if batches:
            self._stream_watermark = batches[-1].event_time
            self._m_stream_rows.inc(rows)
            self._g_corpus.set(min(self._ring.written, self._ring.capacity))
            self.sampler.set_data(self._ring.data())
        self._stream_next = self._buffer.next_ordinal
        self._stream_dropped = self._buffer.dropped
        return {"batches": len(batches), "rows": rows,
                "watermark": self._stream_watermark}

    def _check_drift(self) -> Optional[str]:
        """Judge the current posterior against the NEW corpus; returns the
        breach reason (→ escalate to re-fit) or ``None``."""
        if (self._drift_guard is None
                or not self._drift_guard.checks_diagnostics
                or not self._drift_diag.enabled):
            return None
        report = self._drift_diag.compute(
            self._harness.particles, num_shards=self._harness.num_shards,
            step=self._harness.t)
        try:
            check_diagnostics(report, self._drift_guard)
        except GuardViolation as e:
            _trace.instant("stream.drift_trip", {"reason": e.reason,
                                                 "t": self._harness.t})
            self._log(event="drift_trip", t=self._harness.t,
                      reason=e.reason)
            return e.reason
        return None

    def run_segment_once(self, *, resume: bool = False) -> dict:
        """One full stream segment: ingest → drift check → train (+ckpt)
        → hot-reload publish.  ``resume=True`` on the FIRST segment of a
        process restores the newest checkpoint (cold resume — the corpus
        ring and stream cursor come back bitwise); later segments always
        continue warm on the same grid."""
        tracer = _trace.get_tracer()
        tnow = tracer.now if tracer is not None else self._clock
        first = self._stream_segments == 0
        if first and resume:
            # cold resume must land BEFORE the first ingest: the restored
            # ring already holds every checkpointed batch, and the restore
            # seeks the buffer past them — polling first would re-pull and
            # double-ingest, breaking bitwise resume
            state = self._manager.restore_latest()
            if state is not None:
                self._apply_resume_state(state)
        seg_t0 = tnow()

        # -- ingest --------------------------------------------------- #
        ing = self.ingest()
        ing_t1 = tnow()

        t_base = self._harness.t
        # -- drift check (old posterior vs new data) ------------------- #
        # an untrained posterior (t=0) makes every diagnostic scream, so
        # the detector arms once any training has happened (including a
        # cold-resumed trajectory)
        drift = None
        if t_base > 0 and ing["batches"]:
            drift = self._check_drift()
        steps = self._refit_steps if drift else self._steps_per_segment
        if drift:
            self._stream_refits += 1
            self._m_stream_refits.inc()

        # -- train + checkpoint ---------------------------------------- #
        self.num_steps = t_base + steps
        report = self.run(resume=(resume if first else True))
        train_t1 = tnow()
        ck_wall = report["checkpoint_wall_s"]

        # -- publish (hot reload; rejected reloads roll BACK) ----------- #
        reload_step = None
        rejected = False
        rollout_decision = None
        rel_t0 = tnow()
        if self._reloader is not None:
            rejects0 = self._reloader.engine.stats()["reload_rejects"]
            reload_step = self._reloader.poll_once()
            rejected = (self._reloader.engine.stats()["reload_rejects"]
                        > rejects0)
            rollout = getattr(self._reloader, "rollout", None)
            if rollout is not None:
                # progressive delivery: the supervisor publishes
                # candidates INTO the rollout (poll_once offered above) and
                # drives one control step per segment — deterministic, on
                # the segment cadence, with the supervisor's own liveness
                # (a separate controller thread would race the injectable
                # clocks the CPU tests rely on).  Promotion/rollback decisions
                # land here, in the segment record.
                rollout_decision = rollout.step()
        rel_t1 = tnow()

        freshness_s = None
        if (reload_step is not None and self._stream_watermark is not None
                and rollout_decision is None):
            # event time of the newest datum this generation was trained
            # on → the moment it started serving (one shared timeline)
            freshness_s = max(self._clock() - self._stream_watermark, 0.0)
            self._m_freshness.observe(freshness_s)
        elif (rollout_decision is not None
              and rollout_decision.get("action") == "promote"
              and rollout_decision.get("watermark") is not None):
            # rollout-published generations count as served at PROMOTION
            # (candidate traffic is not "served" freshness-wise): the
            # freshness observation uses the promoted generation's own
            # offered watermark, which may trail the live ingest cursor
            freshness_s = max(
                self._clock() - rollout_decision["watermark"], 0.0)
            self._m_freshness.observe(freshness_s)

        self._stream_segments += 1
        self._m_stream_segments.inc()
        if tracer is not None:
            tracer.lane_tree(
                "stream.lifetime", seg_t0, rel_t1,
                tags={"segment": self._stream_segments - 1,
                      "batches": ing["batches"], "steps": steps,
                      "drift": bool(drift), "reload_step": reload_step},
                children=[
                    ("ingest", seg_t0, ing_t1),
                    ("train.segment", ing_t1, train_t1 - ck_wall),
                    ("ckpt", train_t1 - ck_wall, train_t1),
                    ("reload", rel_t0, rel_t1),
                ])
        seg = {
            "segment": self._stream_segments - 1,
            "t": self._harness.t,
            "steps": steps,
            "batches": ing["batches"],
            "rows": ing["rows"],
            "drift": drift,
            "refit": bool(drift),
            "watermark": self._stream_watermark,
            "dropped_total": self._stream_dropped,
            "reload_step": reload_step,
            "reload_rejected": rejected,
            "rollout": rollout_decision,
            "freshness_s": freshness_s,
            "resumed_from": report["resumed_from"],
            "train_status": report["status"],
            "wall_s": report["wall_s"],
        }
        self._log(event="stream_segment", **seg)
        return seg

    def run_stream(self, num_segments: int, *, resume: bool = False) -> dict:
        """Drive ``num_segments`` stream segments; returns (and keeps as
        :attr:`stream_report`) the aggregate report."""
        if num_segments < 1:
            raise ValueError(
                f"num_segments must be >= 1, got {num_segments}"
            )
        segments = []
        for _ in range(num_segments):
            segments.append(self.run_segment_once(resume=resume))
        freshness = [s["freshness_s"] for s in segments
                     if s["freshness_s"] is not None]
        self.stream_report = {
            "segments": len(segments),
            "t": self._harness.t,
            "batches": sum(s["batches"] for s in segments),
            "rows": sum(s["rows"] for s in segments),
            "dropped": self._stream_dropped,
            "refits": self._stream_refits,
            "drift_trips": [s["segment"] for s in segments if s["drift"]],
            "reloads": sum(1 for s in segments
                           if s["reload_step"] is not None),
            "reload_rejections": sum(1 for s in segments
                                     if s["reload_rejected"]),
            "promotions": sum(1 for s in segments
                              if (s["rollout"] or {}).get("action")
                              == "promote"),
            "rollout_rollbacks": sum(1 for s in segments
                                     if (s["rollout"] or {}).get("action")
                                     == "rollback"),
            "watermark": self._stream_watermark,
            "freshness_s": freshness,
            "segment_reports": segments,
        }
        return self.stream_report
