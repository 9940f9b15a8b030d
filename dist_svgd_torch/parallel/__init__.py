"""The particle mesh (``parallel.mesh``: S shards over one or several
processes), the rendezvous and per-process rows (``parallel.multihost``),
the exchange strategies, and (``parallel.plan``) the ``Plan`` — one device
or a 1-D device mesh — the serving programs compile under."""

from dist_svgd_torch.parallel.exchange import (
    ALL_PARTICLES,
    ALL_SCORES,
    MODES,
    PARTITIONS,
    make_shard_step,
)

__all__ = ["ALL_PARTICLES", "ALL_SCORES", "MODES", "PARTITIONS", "make_shard_step"]
