"""The cyclic collector's pauses inside a window (``gc.callbacks``): the
host-side stall a timing gate cannot see by itself.

Standard library only, so ``chip_smoke.py`` can load this file by path
beside another checkout's package (``--gate-load --tree``).
"""

from __future__ import annotations

import gc
import time

__all__ = ["CollectorPauses"]


class CollectorPauses:
    """The cyclic collector's pauses while entered: each collection's
    generation and seconds, whichever thread ran it.  Collections never
    overlap (the interpreter runs one at a time), so a start and the next
    stop bracket one pause."""

    def __init__(self, clock=time.perf_counter):
        self._clock = clock
        self._start = None
        self.pauses: list = []  # (generation, seconds)

    def _callback(self, phase, info):
        if phase == "start":
            self._start = self._clock()
        elif self._start is not None:
            self.pauses.append((info["generation"], self._clock() - self._start))
            self._start = None

    def __enter__(self) -> "CollectorPauses":
        gc.callbacks.append(self._callback)
        return self

    def __exit__(self, *exc) -> bool:
        gc.callbacks.remove(self._callback)
        return False

    def summary(self) -> dict:
        """Count, sum and largest pause (ms) and the full (generation 2)
        collections among them."""
        secs = [s for _, s in self.pauses]
        return {"count": len(secs), "sum_ms": 1e3 * sum(secs),
                "max_ms": 1e3 * max(secs, default=0.0),
                "full": sum(1 for g, _ in self.pauses if g == 2)}
