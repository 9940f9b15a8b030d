"""Shard emulation, the exchange strategies, and (``parallel.plan``) the
single-device ``Plan`` the serving programs compile under."""

from dist_svgd_torch.parallel.exchange import (
    ALL_PARTICLES,
    ALL_SCORES,
    MODES,
    PARTITIONS,
    make_shard_step,
)

__all__ = ["ALL_PARTICLES", "ALL_SCORES", "MODES", "PARTITIONS", "make_shard_step"]
