"""One capped-exponential-backoff implementation, shared by every retrier.

Counterpart of ``dist_svgd_tpu/resilience/backoff.py``, copied (the port
imports nothing of the JAX package).  The training
:class:`~dist_svgd_torch.resilience.supervisor.RunSupervisor` (transient
dispatch failures) and the serving
:class:`~dist_svgd_torch.serving.fleet.FleetRouter` (replica failover) take
their delay schedule from here:

- **capped exponential**: ``base_s · factor^(k-1)`` before the k-th
  *consecutive* failure, capped at ``max_s`` (:func:`capped_delay` — the
  pure function, exactly the schedule the supervisor has always used);
- **jitter**: :class:`Backoff` multiplies each delay by a uniform factor
  in ``[1 − jitter_frac, 1 + jitter_frac]`` so N clients backing off from
  the same overload event don't reconverge into synchronized retry waves
  (the classic thundering-herd fix).  ``jitter_frac=0`` disables it — the
  supervisor's deterministic recovery tests rely on exact delays — and the
  RNG is injectable so jittered paths stay reproducible in tests.

Sleeping is the *caller's* job (the supervisor's clock is injectable, the
router clamps delays to the request deadline); this module only computes
durations.
"""

from __future__ import annotations

import random
from typing import Optional

__all__ = ["capped_delay", "Backoff"]


def capped_delay(attempt: int, base_s: float, factor: float,
                 max_s: float) -> float:
    """Delay before retry number ``attempt`` (1-based; values < 1 clamp to
    1): ``base_s · factor^(attempt-1)``, capped at ``max_s``."""
    d = base_s * factor ** max(attempt - 1, 0)
    return min(d, max_s)


class Backoff:
    """Capped exponential backoff with optional multiplicative jitter.

    Args:
        base_s: delay before the first retry.
        factor: growth per consecutive failure.
        max_s: hard cap on any single delay (applied after jitter too —
            the cap is a promise, not an average).
        jitter_frac: half-width of the uniform jitter band; ``0`` yields
            the exact :func:`capped_delay` schedule.
        rng: ``random.Random`` (or anything with ``.random()``) for the
            jitter draw — inject a seeded one for deterministic tests.
    """

    def __init__(self, base_s: float = 1.0, factor: float = 2.0,
                 max_s: float = 60.0, jitter_frac: float = 0.0,
                 rng: Optional[random.Random] = None):
        if base_s < 0:
            raise ValueError(f"base_s must be >= 0, got {base_s}")
        if factor < 1.0:
            raise ValueError(f"factor must be >= 1, got {factor}")
        if max_s < base_s:
            raise ValueError(
                f"max_s ({max_s}) must be >= base_s ({base_s})")
        if not 0.0 <= jitter_frac < 1.0:
            raise ValueError(
                f"jitter_frac must be in [0, 1), got {jitter_frac}")
        self.base_s = float(base_s)
        self.factor = float(factor)
        self.max_s = float(max_s)
        self.jitter_frac = float(jitter_frac)
        self._rng = rng if rng is not None else random.Random()

    def delay_s(self, attempt: int) -> float:
        """Jittered delay before retry number ``attempt`` (1-based)."""
        d = capped_delay(attempt, self.base_s, self.factor, self.max_s)
        if self.jitter_frac:
            d *= 1.0 + self.jitter_frac * (2.0 * self._rng.random() - 1.0)
        return min(d, self.max_s)

    def __repr__(self):
        return (f"Backoff(base_s={self.base_s}, factor={self.factor}, "
                f"max_s={self.max_s}, jitter_frac={self.jitter_frac})")
