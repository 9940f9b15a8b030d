"""Initial particles on explicit ``torch.Generator`` streams.

Counterpart of ``dist_svgd_tpu/utils/rng.py:init_particles*``.  JAX's
threefry streams cannot be reproduced in PyTorch, so the two packages draw
different numbers from the same seed; tests that compare them make their
inputs with numpy and hand them to both.

Every draw happens on a CPU generator and is then moved to the device, so a
seed gives the same particles on the CPU and on the card.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch


def _generator(seed: int, *stream: int) -> torch.Generator:
    """A CPU generator for ``(seed, *stream)`` — one independent stream per
    tuple, derived through numpy's ``SeedSequence`` so neighbouring seeds and
    shards never share a state."""
    state = np.random.SeedSequence([int(seed), *map(int, stream)]).generate_state(1, np.uint64)
    return torch.Generator(device="cpu").manual_seed(int(state[0]) & ((1 << 63) - 1))


def init_particles(
    seed: int,
    n: int,
    d: int,
    dtype: torch.dtype = torch.float32,
    device: Optional[Union[str, torch.device]] = None,
) -> torch.Tensor:
    """Standard-normal ``(n, d)`` initial particles (the reference's
    ``Normal(0, 1)`` draw per particle)."""
    out = torch.randn(n, d, generator=_generator(seed), dtype=dtype)
    return out if device is None else out.to(device)


def init_particles_per_shard(
    seed: int,
    n: int,
    d: int,
    num_shards: int,
    dtype: torch.dtype = torch.float32,
    device: Optional[Union[str, torch.device]] = None,
) -> torch.Tensor:
    """Global ``(n, d)`` initial particles where shard ``r``'s block comes from
    its own stream ``(seed, r)`` — the distributional equivalent of the
    reference's per-rank seeding.  ``n`` must be divisible by
    ``num_shards``."""
    if n % num_shards:
        raise ValueError(f"n={n} is not divisible by num_shards={num_shards}")
    block = n // num_shards
    out = torch.cat([
        torch.randn(block, d, generator=_generator(seed, r), dtype=dtype)
        for r in range(num_shards)
    ])
    return out if device is None else out.to(device)
