"""Particle-history records.

Counterpart of ``dist_svgd_tpu/utils/history.py``.  The reference keeps one
pandas row per (timestep, particle) with the particle value as a numpy
vector, snapshotted *before* each update plus one final post-update
snapshot.  The port's ``Sampler.run(record=True)`` stacks the snapshots as
one ``(T, n, d)`` array and converts to the reference's DataFrame schema
once, at the end.  ``pandas`` is imported inside
:func:`history_to_dataframe` only: nothing on the card's path needs it.
"""

from __future__ import annotations

import numpy as np

#: Upper bound on snapshots held on the device at once, and the device
#: budget that sizes the actual count (:func:`record_chunk_steps`).  A longer
#: recorded run moves each full chunk of snapshots to the host, so the
#: device holds at most one chunk's ``(chunk, n, d)`` stack.
RECORD_CHUNK_MAX = 500
RECORD_HBM_BUDGET_BYTES = 2 << 30  # 2 GiB of device memory for history


def record_chunk_steps(n: int, d: int, itemsize: int = 4) -> int:
    """Snapshots per device-held chunk such that the stack stays within
    :data:`RECORD_HBM_BUDGET_BYTES`: ``n × d × itemsize`` bytes a snapshot
    (the card stores an ``(n, d)`` tensor densely; the JAX package counts
    the TPU's 128-lane padding here), clamped to ``[1, RECORD_CHUNK_MAX]``."""
    bytes_per_step = max(1, n * d * itemsize)
    return max(1, min(RECORD_CHUNK_MAX, RECORD_HBM_BUDGET_BYTES // bytes_per_step))


def history_to_dataframe(history: np.ndarray):
    """Convert a ``(T, n, d)`` history array to the reference DataFrame
    schema: columns ``timestep`` (0..T-1), ``particle`` (0..n-1) and
    ``value`` (a numpy ``(d,)`` vector)."""
    import pandas as pd

    history = np.asarray(history)
    T, n, d = history.shape
    return pd.DataFrame({
        "timestep": np.repeat(np.arange(T), n),
        "particle": np.tile(np.arange(n), T),
        # row (t, i) of the reshape is history[t, i]
        "value": list(history.reshape(T * n, d)),
    })
