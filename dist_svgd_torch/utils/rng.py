"""Initial particles and the minibatch stream on explicit
``torch.Generator`` streams.

Counterpart of ``dist_svgd_tpu/utils/rng.py`` (``init_particles*``,
``minibatch_key``, ``draw_minibatch`` and ``approx_bank_key``).  JAX's threefry streams cannot be
reproduced in PyTorch, so the two packages draw different numbers from the
same seed; tests that compare them make their inputs with numpy and hand
them to both (a sampler takes its minibatch indices through a seam).

Initial particles are drawn on a CPU generator and then moved to the
device, so a seed gives the same particles on the CPU and on the card.  The
minibatch stream is drawn on the device it is used on, keyed by
``(seed, t)`` alone, so a run resumed at step ``t`` draws what the
uninterrupted run drew there.  The random-feature bank stream
(:func:`approx_bank_seed`, :func:`approx_bank_generator`) follows the same
rules: one bank a run drawn on the CPU from a fixed fold of the run seed, or
with ``rff_redraw='step'`` one a step keyed by ``(bank seed, t)`` on the
device.
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


#: Fixed stream tag of the minibatch draws (JAX folds the same number into
#: its seed), so they never share a stream with the particle init.
MINIBATCH_STREAM = 7919


def minibatch_indices(seed: int, t: int, num_shards: int, n_rows: int, batch_size: int,
                      device: Union[str, torch.device] = "cpu") -> torch.Tensor:
    """Step ``t``'s minibatch of every shard: an ``(S, B)`` int64 tensor on
    ``device`` whose row ``r`` is ``B`` distinct indices into shard ``r``'s
    ``n_rows`` local rows, drawn uniformly without replacement.

    One batched draw for all S shards (a random key per row, then the ``B``
    smallest keys' positions), from a generator seeded by ``(seed, t)`` on
    ``device`` — no per-shard loop and no host sync.  The importance scale
    that goes with it is ``n_rows / batch_size``."""
    if not 0 < batch_size <= n_rows:
        raise ValueError(f"batch_size {batch_size} not in (0, {n_rows}] local rows")
    device = torch.device(device)
    state = np.random.SeedSequence([int(seed), MINIBATCH_STREAM, int(t)]).generate_state(
        1, np.uint64)
    g = torch.Generator(device=device).manual_seed(int(state[0]) & ((1 << 63) - 1))
    keys = torch.rand((num_shards, n_rows), generator=g, device=device)
    return keys.argsort(dim=-1)[:, :batch_size]


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


#: Fixed stream tag of the random-feature bank (JAX folds the same number
#: into its seed for ``approx_bank_key``), so the bank never shares a stream
#: with the particle init or the minibatch draws.
APPROX_BANK_STREAM = 104729


def approx_bank_seed(seed: int) -> int:
    """The bank stream's seed for run seed ``seed`` (JAX's
    ``approx_bank_key``): a fixed fold of the run seed, a non-negative
    63-bit int.  It, not the bank, rides ``state_dict``
    (``approx_bank_seed``), so a resumed or resharded run re-derives the
    same bank."""
    state = np.random.SeedSequence([int(seed), APPROX_BANK_STREAM]).generate_state(1, np.uint64)
    return int(state[0]) & ((1 << 63) - 1)


def approx_bank_generator(bank_seed: int, t: Optional[int] = None,
                          device: Union[str, torch.device] = "cpu") -> torch.Generator:
    """The generator a bank is drawn from: ``t=None`` is the run's one bank,
    a CPU stream of ``bank_seed`` alone (drawn once and moved to the device,
    so a seed gives the same bank on the CPU and on the card); an int ``t``
    is step ``t``'s bank under ``rff_redraw='step'``, a stream of
    ``(bank_seed, t)`` on ``device`` (as :func:`minibatch_indices` keys its
    draws), so chunked, resumed and resharded runs draw the same banks."""
    if t is None:
        return _generator(bank_seed)
    state = np.random.SeedSequence([int(bank_seed), int(t)]).generate_state(1, np.uint64)
    return torch.Generator(device=torch.device(device)).manual_seed(
        int(state[0]) & ((1 << 63) - 1))
