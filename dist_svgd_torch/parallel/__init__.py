"""Shard emulation and the exchange strategies."""

from dist_svgd_torch.parallel.exchange import (
    ALL_PARTICLES,
    ALL_SCORES,
    MODES,
    PARTITIONS,
    make_shard_step,
)

__all__ = ["ALL_PARTICLES", "ALL_SCORES", "MODES", "PARTITIONS", "make_shard_step"]
