"""Streaming data sources: seeded, clock-injectable, event-time-stamped.

Counterpart of ``dist_svgd_tpu/streaming/source.py``, kept as the port's
own copy: plain numpy and the port's metrics registry, so every batch, the
buffer's cursor and the ring's state are bitwise JAX's.

The sampler's minibatch score is an unbiased estimator over *whatever data
exists at step t* (Liu & Wang 2016) — nothing in the math requires a fixed
dataset.  This module supplies the plumbing half of that observation:

- a :class:`StreamSource` base whose batches are a **pure function of
  (seed, ordinal)** — ``batch_at(o)`` replays bitwise, so a killed and
  resumed pipeline reconstructs the exact corpus the uninterrupted one
  held (the training-side ``step_offset`` discipline extended to data);
- **event time** is stamped arithmetically (``start_time + o · period``),
  never read from a wall clock — the injectable clock decides only *when*
  a batch becomes due, so the CPU tests replay hours of stream in
  milliseconds;
- deterministic **drift**: sources take
  :class:`~dist_svgd_torch.resilience.faults.DriftAt` windows (ordinal-keyed
  like the fleet faults) and some generators drift intrinsically — either
  way a replayed ordinal reproduces its shift exactly;
- a bounded :class:`StreamBuffer` whose overflow policy is **explicit
  drop-oldest with accounting** (``svgd_stream_dropped_total``): data loss
  is a counter the freshness gate FAILs on, never a silent slice;
- a fixed-capacity :class:`RowRing` corpus so the data argument of the
  minibatch step (``Sampler.set_data``) keeps one shape forever — the
  spec ``set_data`` checks, and no new shape on the card.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np

from dist_svgd_torch.resilience.faults import DriftAt
from dist_svgd_torch.telemetry import metrics as _metrics

__all__ = [
    "StreamBatch",
    "StreamSource",
    "MeanShiftStream",
    "LabelFlipStream",
    "GrowingCorpusStream",
    "CovertypeReplayStream",
    "StreamBuffer",
    "RowRing",
]


@dataclass(frozen=True)
class StreamBatch:
    """One event-time-stamped batch: ``x`` features ``(rows, dim)``
    float32, ``y`` labels ``(rows,)`` float64 in {-1, +1} (the covertype
    convention every model in :mod:`~dist_svgd_torch.models` speaks)."""

    ordinal: int
    event_time: float
    x: np.ndarray
    y: np.ndarray

    @property
    def rows(self) -> int:
        return int(self.x.shape[0])


class StreamSource:
    """Base class: subclasses implement the pure ``_raw_batch(ordinal)``.

    Args:
        batch_rows / dim: fixed batch geometry (constant shapes are what
            keep the downstream data spec, and the card's shapes, fixed).
        seed: root of every batch's RNG — ``(seed, ordinal)`` seeds a
            fresh generator per batch, so ordinals replay independently.
        period_s: event-time spacing; batch ``o`` carries
            ``event_time = start_time + o · period_s`` and becomes due
            when the (injected) clock reaches it.
        start_time: epoch of ordinal 0 on the caller's clock timeline.
        faults: :class:`~dist_svgd_torch.resilience.faults.DriftAt`
            windows applied (in order) to every batch whose ordinal they
            cover — deterministic injected distribution shift.
        num_batches: ``None`` for unbounded generators; replay adapters
            set the finite count.
    """

    def __init__(self, *, batch_rows: int, dim: int, seed: int = 0,
                 period_s: float = 1.0, start_time: float = 0.0,
                 faults: Sequence[DriftAt] = (),
                 num_batches: Optional[int] = None):
        if batch_rows < 1:
            raise ValueError(f"batch_rows must be >= 1, got {batch_rows}")
        if dim < 1:
            raise ValueError(f"dim must be >= 1, got {dim}")
        if period_s <= 0:
            raise ValueError(f"period_s must be positive, got {period_s}")
        self.batch_rows = int(batch_rows)
        self.dim = int(dim)
        self.seed = int(seed)
        self.period_s = float(period_s)
        self.start_time = float(start_time)
        self.faults = tuple(faults)
        for f in self.faults:
            if not isinstance(f, DriftAt):
                raise TypeError(
                    f"stream faults must be DriftAt, got {type(f).__name__}"
                )
        self.num_batches = None if num_batches is None else int(num_batches)

    # -- pure per-ordinal surface -------------------------------------- #

    def _raw_batch(self, ordinal: int) -> Tuple[np.ndarray, np.ndarray]:
        raise NotImplementedError  # pragma: no cover - abstract

    def _rng(self, ordinal: int) -> np.random.Generator:
        return np.random.default_rng((self.seed, int(ordinal)))

    def event_time(self, ordinal: int) -> float:
        return self.start_time + int(ordinal) * self.period_s

    def due(self, ordinal: int, now: float) -> bool:
        """Whether batch ``ordinal`` has arrived by clock time ``now``."""
        if self.num_batches is not None and ordinal >= self.num_batches:
            return False
        return self.event_time(ordinal) <= now

    def batch_at(self, ordinal: int) -> StreamBatch:
        """The batch at ``ordinal`` — pure: same (seed, ordinal, faults)
        always yields the identical bytes, drift included."""
        ordinal = int(ordinal)
        if ordinal < 0:
            raise ValueError(f"ordinal must be >= 0, got {ordinal}")
        if self.num_batches is not None and ordinal >= self.num_batches:
            raise IndexError(
                f"ordinal {ordinal} past the bounded source's "
                f"{self.num_batches} batches"
            )
        x, y = self._raw_batch(ordinal)
        for f in self.faults:
            if f.active(ordinal):
                x, y = f.apply(x, y)
        x = np.ascontiguousarray(x, dtype=np.float32)
        y = np.ascontiguousarray(y, dtype=np.float64)
        return StreamBatch(ordinal=ordinal,
                           event_time=self.event_time(ordinal), x=x, y=y)


class _LogisticStreamBase(StreamSource):
    """Shared synthetic geometry: features ~ N(mean_o, I); ±1 labels from
    a fixed ground-truth logistic weight vector drawn once from ``seed``
    (so the *posterior target* is stable and only the covariates/labels
    drift as each generator dictates)."""

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        w_rng = np.random.default_rng((self.seed, 0x5eed))
        self._w = w_rng.normal(size=self.dim).astype(np.float64)

    def _mean(self, ordinal: int) -> float:
        return 0.0

    def _flip_frac(self, ordinal: int) -> float:
        return 0.0

    def _raw_batch(self, ordinal):
        rng = self._rng(ordinal)
        x = (rng.normal(size=(self.batch_rows, self.dim))
             + self._mean(ordinal)).astype(np.float32)
        p = 1.0 / (1.0 + np.exp(-(x.astype(np.float64) @ self._w)))
        y = np.where(rng.random(self.batch_rows) < p, 1.0, -1.0)
        frac = self._flip_frac(ordinal)
        if frac > 0.0:
            k = int(round(min(frac, 1.0) * self.batch_rows))
            if k > 0:
                idx = np.linspace(0, self.batch_rows - 1,
                                  num=k).round().astype(int)
                y[idx] = -y[idx]
        return x, y


class MeanShiftStream(_LogisticStreamBase):
    """Covariate drift: the feature mean moves by ``rate`` per ordinal —
    the slow continuous shift the KSD guard must notice as a
    posterior/data mismatch."""

    def __init__(self, *, rate: float = 0.0, **kwargs):
        super().__init__(**kwargs)
        self.rate = float(rate)

    def _mean(self, ordinal):
        return self.rate * ordinal


class LabelFlipStream(_LogisticStreamBase):
    """Concept drift: a deterministic (strided, RNG-free) fraction of each
    batch's labels is negated, growing by ``rate`` per ordinal up to
    ``max_frac`` — the decision boundary itself degrades."""

    def __init__(self, *, rate: float = 0.0, max_frac: float = 0.5,
                 **kwargs):
        super().__init__(**kwargs)
        if not 0.0 <= max_frac <= 1.0:
            raise ValueError(f"max_frac must be in [0, 1], got {max_frac}")
        self.rate = float(rate)
        self.max_frac = float(max_frac)

    def _flip_frac(self, ordinal):
        return min(self.rate * ordinal, self.max_frac)


class GrowingCorpusStream(_LogisticStreamBase):
    """Stationary generator: every ordinal samples the same distribution —
    no drift, the corpus simply grows as batches accumulate (the
    freshness-without-retrain baseline the drill's no-drift phases use)."""


class CovertypeReplayStream(StreamSource):
    """Replay adapter: serves :func:`~dist_svgd_torch.utils.datasets.
    load_covertype` (bitwise JAX's loader) as a bounded timestamped stream — consecutive
    ``batch_rows`` slices in row order, one per period.  The dataset loads
    once; ``batch_at`` is a pure slice of it, so replays are bitwise like
    every other source."""

    def __init__(self, *, n_rows: int = 50_000, batch_rows: int = 512,
                 seed: int = 0, period_s: float = 1.0,
                 start_time: float = 0.0, faults: Sequence[DriftAt] = ()):
        from dist_svgd_torch.utils.datasets import load_covertype

        x, y = load_covertype(n_rows=n_rows, seed=seed)
        self._x = np.ascontiguousarray(np.asarray(x), dtype=np.float32)
        self._y = np.ascontiguousarray(np.asarray(y), dtype=np.float64)
        super().__init__(
            batch_rows=batch_rows, dim=int(self._x.shape[1]), seed=seed,
            period_s=period_s, start_time=start_time, faults=faults,
            num_batches=self._x.shape[0] // int(batch_rows),
        )

    def _raw_batch(self, ordinal):
        lo = ordinal * self.batch_rows
        hi = lo + self.batch_rows
        return self._x[lo:hi].copy(), self._y[lo:hi].copy()


class StreamBuffer:
    """Bounded ingest buffer between a source and the trainer.

    ``poll(now)`` pulls every due, not-yet-pulled batch in ordinal order;
    past ``capacity`` buffered batches the **oldest is dropped**, counted
    in ``svgd_stream_dropped_total`` and :attr:`dropped` — an overloaded
    trainer loses data *loudly* (the freshness gate FAILs on it), never by
    silent truncation.  The ingest watermark (``svgd_stream_watermark``)
    is the newest pulled event time — what the freshness SLO compares the
    serving watermark against.  Thread-safe; the scanner/trainer threads
    and a metrics scrape may interleave freely.
    """

    def __init__(self, source: StreamSource, capacity: int, *,
                 registry: Optional[_metrics.MetricsRegistry] = None,
                 clock=time.time):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.source = source
        self.capacity = int(capacity)
        self._clock = clock
        self._lock = threading.Lock()
        self._buf: deque = deque()
        self.next_ordinal = 0
        self.pulled = 0
        self.dropped = 0
        self.watermark: Optional[float] = None
        reg = registry if registry is not None else _metrics.default_registry()
        self._m_pulled = reg.counter(
            "svgd_stream_batches_total", "batches pulled from the source")
        self._m_dropped = reg.counter(
            "svgd_stream_dropped_total",
            "batches dropped by buffer overflow — stream data LOST")
        self._g_watermark = reg.gauge(
            "svgd_stream_watermark",
            "event time of the newest ingested batch (ingest watermark)")
        self._g_depth = reg.gauge(
            "svgd_stream_buffer_depth", "batches currently buffered")

    def seek(self, ordinal: int) -> None:
        """Fast-forward the pull cursor (cold resume: the checkpointed
        corpus already holds everything before ``ordinal``)."""
        with self._lock:
            self.next_ordinal = max(self.next_ordinal, int(ordinal))

    def poll(self, now: Optional[float] = None) -> int:
        """Pull all due batches; returns how many arrived this poll."""
        now = self._clock() if now is None else now
        pulled = 0
        with self._lock:
            while self.source.due(self.next_ordinal, now):
                batch = self.source.batch_at(self.next_ordinal)
                self.next_ordinal += 1
                self._buf.append(batch)
                pulled += 1
                self.pulled += 1
                self._m_pulled.inc()
                self.watermark = batch.event_time
                self._g_watermark.set(batch.event_time)
                if len(self._buf) > self.capacity:
                    self._buf.popleft()
                    self.dropped += 1
                    self._m_dropped.inc()
            self._g_depth.set(len(self._buf))
        return pulled

    def take(self) -> list:
        """Drain the buffer (ordinal order) — the trainer's ingest step."""
        with self._lock:
            out = list(self._buf)
            self._buf.clear()
            self._g_depth.set(0)
        return out

    def __len__(self) -> int:
        with self._lock:
            return len(self._buf)


class RowRing:
    """Fixed-capacity row corpus: the ``data`` argument of the minibatch
    step must keep ONE shape forever (``Sampler.set_data`` refuses another
    spec, and JAX's compiled scan would retrace per segment), so the corpus
    is a ``(capacity, dim)`` ring — a sliding window once full, cyclically tiled before that.

    The tiling means early minibatches oversample the few rows that exist
    yet (a mild, vanishing duplication bias — the unbiased-minibatch
    estimator is over the *held* corpus either way); once
    ``written >= capacity`` the window is exact.

    Ring state is plain numpy (:meth:`state_dict` /
    :meth:`load_state_dict`), riding the supervisor checkpoint so a
    killed pipeline resumes the corpus bitwise.
    """

    def __init__(self, capacity: int, dim: int):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self.dim = int(dim)
        self._x = np.zeros((self.capacity, self.dim), dtype=np.float32)
        self._y = np.zeros((self.capacity,), dtype=np.float64)
        self._pos = 0
        self.written = 0  # total rows ever written

    def extend(self, x: np.ndarray, y: np.ndarray) -> None:
        x = np.asarray(x, dtype=np.float32)
        y = np.asarray(y, dtype=np.float64)
        if x.ndim != 2 or x.shape[1] != self.dim or x.shape[0] != y.shape[0]:
            raise ValueError(
                f"expected x ({x.shape[0]}, {self.dim}) with matching y, "
                f"got x {x.shape} / y {y.shape}"
            )
        n = x.shape[0]
        if n > self.capacity:
            # only the newest `capacity` rows can survive anyway
            x, y = x[-self.capacity:], y[-self.capacity:]
            self.written += n - self.capacity
            n = self.capacity
        i = self._pos
        first = min(n, self.capacity - i)
        self._x[i:i + first] = x[:first]
        self._y[i:i + first] = y[:first]
        rest = n - first
        if rest:
            self._x[:rest] = x[first:]
            self._y[:rest] = y[first:]
        self._pos = (i + n) % self.capacity
        self.written += n

    def data(self) -> Tuple[np.ndarray, np.ndarray]:
        """The constant-shape ``(x, y)`` corpus view (always
        ``(capacity, dim)`` / ``(capacity,)`` copies)."""
        if self.written == 0:
            raise ValueError("RowRing.data() before any rows were written")
        w = min(self.written, self.capacity)
        if w == self.capacity:
            return self._x.copy(), self._y.copy()
        reps = -(-self.capacity // w)
        x = np.tile(self._x[:w], (reps, 1))[:self.capacity]
        y = np.tile(self._y[:w], reps)[:self.capacity]
        return np.ascontiguousarray(x), np.ascontiguousarray(y)

    def state_dict(self) -> dict:
        return {
            "stream_ring_x": self._x.copy(),
            "stream_ring_y": self._y.copy(),
            "stream_ring_pos": np.asarray(self._pos, dtype=np.int64),
            "stream_ring_written": np.asarray(self.written, dtype=np.int64),
        }

    def load_state_dict(self, state: dict) -> None:
        x = np.asarray(state["stream_ring_x"], dtype=np.float32)
        if x.shape != (self.capacity, self.dim):
            raise ValueError(
                f"ring checkpoint shape {x.shape} != configured "
                f"({self.capacity}, {self.dim})"
            )
        self._x = x.copy()
        self._y = np.asarray(state["stream_ring_y"], dtype=np.float64).copy()
        self._pos = int(state["stream_ring_pos"])
        self.written = int(state["stream_ring_written"])
