"""The three particle/score exchange strategies, as one batched step over
the emulated shard axis.

Counterpart of ``dist_svgd_tpu/parallel/exchange.py`` (gather
implementation, Jacobi update).  Reference semantics:

- ``all_particles`` — every shard gathers the full particle set and scores
  all n particles on its **local data slice**, importance-scaled by
  ``N_global / N_local``;
- ``all_scores``    — the per-shard local-data scores of all n particles are
  summed across shards (psum): the exact global score, unscaled;
- ``partitions``    — each shard interacts only within its own block; the
  data assignment rotates, block ``b`` at step ``t`` pairing with data slice
  ``(b + t) mod S`` (the JAX package's SPMD re-derivation of the
  reference's ring migration).

Data is replicated and sliced per shard in contiguous blocks of
``n_local_data`` rows (remainder dropped); :func:`stack_shards` lays the
slices out along the shard axis once, at construction.
"""

from __future__ import annotations

from typing import Callable

import torch

from dist_svgd_torch.ops.cuda_svgd import resolve_phi_fn
from dist_svgd_torch.parallel.mesh import all_gather, psum, split

ALL_PARTICLES = "all_particles"
ALL_SCORES = "all_scores"
PARTITIONS = "partitions"

MODES = (ALL_PARTICLES, ALL_SCORES, PARTITIONS)


def tree_map(fn: Callable, data):
    """Apply ``fn`` to every tensor leaf of ``data`` (``None``, a tensor, or
    a tuple / list / dict of them)."""
    if data is None:
        return None
    if isinstance(data, (tuple, list)):
        return type(data)(tree_map(fn, a) for a in data)
    if isinstance(data, dict):
        return {k: tree_map(fn, v) for k, v in data.items()}
    return fn(data)


def stack_shards(data, num_shards: int, n_local_data: int):
    """Every leaf ``(N, ...)`` → ``(S, n_local_data, ...)``: shard ``r``'s
    contiguous slice ``[r·n_local_data, (r+1)·n_local_data)``, remainder
    rows dropped (the reference's drop policy)."""
    keep = num_shards * n_local_data
    return tree_map(lambda a: split(a[:keep], num_shards), data)


def _shard_data_resolver(mode: str, num_shards: int):
    """``resolve(stacked, t) -> per-shard data``: the identity, except in
    ``partitions`` mode where shard ``r`` takes data slice ``(r + t) mod S``
    — the one place the rotation lives."""
    def resolve(stacked, t: int):
        if mode != PARTITIONS or stacked is None:
            return stacked
        def rotate(a):
            idx = (torch.arange(num_shards, device=a.device) + t) % num_shards
            return a[idx]
        return tree_map(rotate, stacked)

    return resolve


def _builder_prelude(logp, kernel, phi_impl: str, num_shards: int):
    """``(phi_fn, shared_scores, own_scores)``:

    - ``shared_scores(thetas (n, d), data) -> (S, n, d)`` — every shard
      scores the same set on its own slice (the gather modes);
    - ``own_scores(blocks (S, s, d), data) -> (S, s, d)`` — each shard
      scores its own block (``partitions``).

    Data-free targets (``data is None``) score once and broadcast."""
    phi_fn = resolve_phi_fn(kernel, phi_impl)
    score = torch.func.vmap(torch.func.grad(logp), in_dims=(0, None))
    per_shard_shared = torch.func.vmap(score, in_dims=(None, 0))
    per_shard_own = torch.func.vmap(score, in_dims=(0, 0))

    def shared_scores(thetas, data):
        if data is None:
            return score(thetas, None).expand(num_shards, *thetas.shape)
        return per_shard_shared(thetas, data)

    def own_scores(blocks, data):
        if data is None:
            return score(blocks.reshape(-1, blocks.shape[-1]), None).reshape(blocks.shape)
        return per_shard_own(blocks, data)

    return phi_fn, shared_scores, own_scores


def _build_core(logp, kernel, mode: str, num_shards: int, score_scale: float,
                phi_impl: str):
    """``core(blocks, data, t) -> delta``: exchange, scores and φ for all
    shards at once (``blocks`` is ``(S, s, d)``, ``data`` the
    :func:`stack_shards` layout)."""
    if mode not in MODES:
        raise ValueError(f"unknown exchange mode {mode!r}")
    phi_fn, shared_scores, own_scores = _builder_prelude(logp, kernel, phi_impl, num_shards)
    resolve_data = _shard_data_resolver(mode, num_shards)

    def core(blocks, data, t: int):
        data_local = resolve_data(data, t)
        if mode == PARTITIONS:
            scores = score_scale * own_scores(blocks, data_local)
            return phi_fn(blocks, blocks, scores)
        interacting = all_gather(blocks)
        local_scores = shared_scores(interacting, data_local)  # (S, n, d)
        if mode == ALL_SCORES:
            scores = psum(local_scores).expand_as(local_scores)
        else:
            scores = score_scale * local_scores
        return phi_fn(blocks, interacting, scores)

    return core


def make_shard_step(
    logp: Callable,
    kernel,
    mode: str,
    num_shards: int,
    score_scale: float,
    phi_impl: str = "auto",
) -> Callable:
    """Build the batched SVGD step for one exchange strategy.

    Args:
        logp: ``logp(theta, data_local)`` scalar log-density; ``data_local``
            is one shard's data slice (or ``None`` for data-free targets).
        kernel: an :class:`~dist_svgd_torch.ops.kernels.RBF`.
        mode: one of :data:`MODES`.
        num_shards: shard count S.
        score_scale: ``N_global / N_local``, applied to scores that were not
            summed across shards; 1.0 for data-free targets.
        phi_impl: ``'auto'`` / ``'torch'`` / ``'cuda'`` — see
            :func:`dist_svgd_torch.ops.cuda_svgd.resolve_phi_fn`.

    Returns ``step(blocks, data, t, step_size) -> new_blocks``: one Jacobi
    update of all ``(S, s, d)`` blocks (every shard moves its block against
    pre-update values); ``t`` is the 1-based step counter that drives the
    ``partitions`` rotation.
    """
    core = _build_core(logp, kernel, mode, num_shards, score_scale, phi_impl)

    def step(blocks, data, t: int, step_size: float):
        return blocks + step_size * core(blocks, data, t)

    return step
