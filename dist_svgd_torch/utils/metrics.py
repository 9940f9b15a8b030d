"""Structured metrics, timing and profiling hooks.

Counterpart of ``dist_svgd_tpu/utils/metrics.py``:

- :class:`JsonlLogger` — per-step scalars as JSON lines to a file and/or a
  stream, flushed a line at a time;
- :func:`particle_stats` — the per-step scalars worth logging (mean
  particle norm, its spread, mean value, update magnitudes), one small
  device → host transfer;
- :class:`StepTimer` — wall-clock laps fenced by ``torch.cuda.synchronize``
  on a CUDA tensor (the card runs asynchronously; a CPU tensor needs no
  fence; a value the dispatch profiler just fenced is not fenced again),
  each lap also a completed span of the telemetry tracer while one is
  enabled (``span_name``);
- :func:`profiler_trace` — a ``torch.profiler`` trace of the card and the
  host, written as a Chrome trace into a directory.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from typing import IO, Optional

import numpy as np
import torch

from dist_svgd_torch.telemetry import profile as _profile
from dist_svgd_torch.telemetry import trace as _trace


class JsonlLogger:
    """Append-only JSON-lines metric log (JAX's ``JsonlLogger``).

    Each :meth:`log` call writes one line ``{"ts": <unix>, **record}`` to
    ``path`` and/or ``stream``, flushed at once (``fsync=True`` also forces
    it to disk).  Writers from several threads interleave whole lines,
    :meth:`close` is idempotent, and logging after it raises
    ``ValueError``."""

    def __init__(self, path: Optional[str] = None, stream: Optional[IO] = None,
                 fsync: bool = False):
        self._fh = open(path, "a") if path is not None else None
        self._stream = stream
        self._fsync = bool(fsync)
        self._lock = threading.Lock()
        self._closed = False

    @property
    def closed(self) -> bool:
        return self._closed

    def log(self, **record) -> dict:
        record = {"ts": round(time.time(), 3), **record}
        line = json.dumps(record, default=_json_default)
        with self._lock:
            if self._closed:
                raise ValueError("log() after close(): the record would be silently "
                                 "dropped")
            if self._fh is not None:
                self._fh.write(line + "\n")
                self._fh.flush()
                if self._fsync:
                    os.fsync(self._fh.fileno())
            if self._stream is not None:
                self._stream.write(line + "\n")
        return record

    def flush(self) -> None:
        with self._lock:
            if self._fh is not None:
                self._fh.flush()
                if self._fsync:
                    os.fsync(self._fh.fileno())

    def close(self) -> None:
        with self._lock:
            self._closed = True
            if self._fh is not None:
                self._fh.close()
                self._fh = None
            self._stream = None  # the caller's: dropped, not closed

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _json_default(o):
    """JSON for numpy scalars and arrays and torch tensors: a 0-dim value as
    its Python number, anything else as a (nested) list."""
    if isinstance(o, np.generic):
        return o.item()
    if isinstance(o, torch.Tensor):
        o = o.detach().cpu().numpy()
    if isinstance(o, np.ndarray):
        return o.tolist()
    raise TypeError(f"not JSON serialisable: {type(o)}")


def particle_stats(particles: torch.Tensor, prev: Optional[torch.Tensor] = None) -> dict:
    """Per-step scalar diagnostics as plain floats, JAX's keys:
    ``particle_mean_norm``, ``particle_norm_std`` (population std),
    ``particle_mean``, and with ``prev`` (the pre-step particles)
    ``mean_update`` and ``max_update`` (the row norms of the step)."""
    norms = torch.linalg.vector_norm(particles, dim=1)
    vals = [norms.mean(), norms.std(correction=0), particles.mean(dim=0).mean()]
    if prev is not None and prev is not particles:
        delta = torch.linalg.vector_norm(particles - prev, dim=1)
        vals += [delta.mean(), delta.max()]
    host = torch.stack(vals).tolist()  # one device → host transfer
    out = {"particle_mean_norm": host[0], "particle_norm_std": host[1],
           "particle_mean": host[2]}
    if len(host) > 3:
        out["mean_update"], out["max_update"] = host[3], host[4]
    return out


class StepTimer:
    """Fenced step timing: ``mark(value)`` waits for the card when ``value``
    holds a CUDA tensor and records the wall time since the previous mark.

    ``span_name`` bridges into the telemetry tracer: while
    ``telemetry.enable()`` is active, every lap also records a completed
    span of that name with explicit timestamps (the fence already happened,
    so the span covers the card's wall).  Disabled tracing costs one
    ``None`` check a mark."""

    def __init__(self, span_name: Optional[str] = None):
        self._last = time.perf_counter()
        self._span_name = span_name
        self.laps: list = []

    def mark(self, value=None) -> float:
        if value is not None:
            _profile.fence(value)  # once: not again after the dispatch profiler's
        now = time.perf_counter()
        lap = now - self._last
        self._last = now
        self.laps.append(lap)
        if self._span_name is not None:
            tracer = _trace.get_tracer()
            if tracer is not None:
                end = tracer.now()
                tracer.complete(self._span_name, max(end - lap, 0.0), end)
        return lap

    @property
    def total(self) -> float:
        return sum(self.laps)

    def updates_per_sec(self, updates_per_lap: int) -> float:
        """Throughput over all recorded laps."""
        return len(self.laps) * updates_per_lap / self.total if self.laps else 0.0


@contextlib.contextmanager
def profiler_trace(logdir: Optional[str]):
    """A ``torch.profiler`` trace of the host and, where there is one, the
    card, written to ``logdir/trace.json`` (Chrome's trace format) on exit;
    nothing when ``logdir`` is falsy."""
    if not logdir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
