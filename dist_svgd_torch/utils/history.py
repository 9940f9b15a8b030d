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

from typing import List, Optional

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


class SnapshotBuffer:
    """A recorded run's ``total`` snapshots, each copied into a ``(k, n, d)``
    device buffer as it is taken: one copy a snapshot, as stacking the held
    snapshots was, and a step that writes its update into its carry
    (``donate_carries``) cannot reach a snapshot already taken.  With
    ``chunk``, a buffer holds at most ``chunk`` snapshots (the last one
    what is left) and each full one moves to the host (:attr:`host`,
    numpy); without, one buffer holds them all."""

    def __init__(self, total: int, chunk: Optional[int] = None):
        self._left, self._chunk = int(total), chunk
        self._buf, self._k = None, 0
        self.host: List[np.ndarray] = []

    def add(self, x, spill: bool = True) -> None:
        """Copy the snapshot ``x`` in; a full chunk moves to the host unless
        ``spill`` is false."""
        if self._buf is None:
            size = self._left if self._chunk is None else min(self._chunk, self._left)
            self._buf = x.new_empty((size, *x.shape))
        self._buf[self._k].copy_(x)
        self._k += 1
        self._left -= 1
        if spill and self._chunk is not None and self._k == len(self._buf):
            self.host.append(self._buf.cpu().numpy())
            self._buf, self._k = None, 0

    def held(self, like):
        """The snapshots still on the device, ``(k, n, d)`` (``like``'s
        dtype and device when there are none)."""
        if self._buf is None:
            return like.new_empty((0, *like.shape))
        return self._buf[: self._k]


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
