"""Streaming SVGD: continuous-ingest training with an end-to-end
freshness SLO.

Counterpart of ``dist_svgd_tpu/streaming`` with the same ``__all__``.  The
minibatch score is an unbiased estimator over whatever data exists at
step t (Liu & Wang 2016) — this package supplies the plumbing that lets
data arrive continuously without giving up any standing contract:

- :mod:`source` — seeded, clock-injectable stream sources with
  arithmetic event times (drifting generators + a covertype replay
  adapter), a bounded :class:`StreamBuffer` with explicit drop
  accounting, and the fixed-capacity :class:`RowRing` corpus that keeps
  the sampler's data spec constant (``Sampler.set_data``);
- :mod:`pipeline` — :class:`StreamingSupervisor`: incremental training
  segments against the growing/shifting corpus, bitwise kill→resume (the
  stream cursor and ring ride every checkpoint), the KSD/ESS drift guard
  as the retrain *trigger*, and per-segment publication to a live serving
  engine via ``CheckpointHotReloader`` — rejected generations roll back,
  never forward.

``telemetry/slo.py:FreshnessObjective`` turns the ingest/serving
watermark gauge pair into the ``freshness`` SLO served at ``/slo``;
``dist_svgd_torch/tools/freshness_drill.py`` measures the whole loop as
one gated row, and ``dist_svgd_torch/experiments/streaming_covertype.py``
replays Covertype through it.
"""

from dist_svgd_torch.streaming.pipeline import StreamingSupervisor
from dist_svgd_torch.streaming.source import (
    CovertypeReplayStream,
    GrowingCorpusStream,
    LabelFlipStream,
    MeanShiftStream,
    RowRing,
    StreamBatch,
    StreamBuffer,
    StreamSource,
)

__all__ = [
    "StreamingSupervisor",
    "StreamSource",
    "StreamBatch",
    "StreamBuffer",
    "RowRing",
    "MeanShiftStream",
    "LabelFlipStream",
    "GrowingCorpusStream",
    "CovertypeReplayStream",
]
