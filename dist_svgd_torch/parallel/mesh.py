"""Shard emulation on one device.

Counterpart of the ``vmap(axis_name=...)`` backend of
``dist_svgd_tpu/parallel/mesh.py:bind_shard_fn``: the S shards are a
leading batch axis written out.  A global ``(n, ...)`` array splits into
``(S, n/S, ...)`` blocks; the all-gather of the blocks is the global array;
a psum is a sum over the shard axis.  The ``torch.distributed`` backend (one
process per card) is later work (ROADMAP A10).
"""

from __future__ import annotations

import torch


def split(a: torch.Tensor, num_shards: int) -> torch.Tensor:
    """``(n, ...)`` → ``(S, n/S, ...)`` contiguous blocks (a view)."""
    if a.shape[0] % num_shards:
        raise ValueError(f"{a.shape[0]} rows do not split into {num_shards} shards")
    return a.reshape(num_shards, a.shape[0] // num_shards, *a.shape[1:])


def merge(blocks: torch.Tensor) -> torch.Tensor:
    """``(S, b, ...)`` → ``(S·b, ...)``: the inverse of :func:`split`."""
    return blocks.reshape(blocks.shape[0] * blocks.shape[1], *blocks.shape[2:])


def all_gather(blocks: torch.Tensor) -> torch.Tensor:
    """Every shard's view of the gathered set: the global array."""
    return merge(blocks)


def psum(per_shard: torch.Tensor) -> torch.Tensor:
    """Sum over the shard axis."""
    return torch.sum(per_shard, dim=0)
