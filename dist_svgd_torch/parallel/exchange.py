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
slices out along the shard axis once, at construction.  A minibatched step
scores, on each shard, ``B`` rows of that shard's slice drawn for the step
(:func:`~dist_svgd_torch.utils.rng.minibatch_indices`), scaled by
``n_local_data / B``; a separate prior is added once, unscaled.

:func:`make_shard_step_sinkhorn_w2` adds the Wasserstein/JKO term with the
reference's snapshot semantics (``dist_svgd_tpu/parallel/exchange.py``).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from dist_svgd_torch.ops.cuda_svgd import resolve_phi_fn
from dist_svgd_torch.ops.ot import wasserstein_grad_lp, wasserstein_grad_sinkhorn
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


def _shard_data_resolver(mode: str, num_shards: int, shard_data: bool = False):
    """``resolve(stacked, t) -> per-shard data``: the identity, except in
    ``partitions`` mode where shard ``r`` takes data slice ``(r + t) mod S``
    — the one place the rotation lives.

    Under the emulation the stacked per-shard layout already is what
    ``shard_data=True`` means (each shard holds only its own slice), so the
    flag changes nothing here; ``partitions`` refuses it, as in JAX, because
    its rotating data rank needs every slice."""
    if shard_data and mode == PARTITIONS:
        raise ValueError("shard_data is unsupported in partitions mode")

    def resolve(stacked, t: int):
        if mode != PARTITIONS or stacked is None:
            return stacked
        def rotate(a):
            idx = (torch.arange(num_shards, device=a.device) + t) % num_shards
            return a[idx]
        return tree_map(rotate, stacked)

    return resolve


def take_minibatch(data, idx: torch.Tensor):
    """Shard ``r``'s rows ``idx[r]`` of every ``(S, n_local, ...)`` leaf →
    ``(S, B, ...)`` (``draw_minibatch``'s gather, all shards at once)."""
    lanes = torch.arange(idx.shape[0], device=idx.device)[:, None]
    return tree_map(lambda a: a[lanes, idx], data)


def _builder_prelude(logp, kernel, phi_impl: str, num_shards: int, log_prior=None,
                     batch_size: Optional[int] = None, n_local_data: int = 0):
    """``(phi_fn, shared_scores, own_scores, prior_scores)``:

    - ``shared_scores(thetas (n, d), data) -> (S, n, d)`` — every shard
      scores the same set on its own slice (the gather modes);
    - ``own_scores(blocks (S, s, d), data) -> (S, s, d)`` — each shard
      scores its own block (``partitions``);
    - ``prior_scores(thetas)`` — the gradient of ``log_prior`` row by row,
      ``None`` without a separate prior.

    Data-free targets (``data is None``) score once and broadcast.  A
    ``batch_size`` outside ``(0, n_local_data]`` raises ``ValueError``."""
    if batch_size is not None and not 0 < batch_size <= n_local_data:
        raise ValueError(f"batch_size {batch_size} not in (0, {n_local_data}] local rows")
    phi_fn = resolve_phi_fn(kernel, phi_impl)
    score = torch.func.vmap(torch.func.grad(logp), in_dims=(0, None))
    per_shard_shared = torch.func.vmap(score, in_dims=(None, 0))
    per_shard_own = torch.func.vmap(score, in_dims=(0, 0))
    prior_scores = (torch.func.vmap(torch.func.grad(log_prior))
                    if log_prior is not None else None)

    def shared_scores(thetas, data):
        if data is None:
            return score(thetas, None).expand(num_shards, *thetas.shape)
        return per_shard_shared(thetas, data)

    def own_scores(blocks, data):
        if data is None:
            return score(blocks.reshape(-1, blocks.shape[-1]), None).reshape(blocks.shape)
        return per_shard_own(blocks, data)

    return phi_fn, shared_scores, own_scores, prior_scores


def _build_core(logp, kernel, mode: str, num_shards: int, score_scale: float,
                phi_impl: str, shard_data: bool = False, batch_size: Optional[int] = None,
                log_prior=None, n_local_data: int = 0):
    """``core(blocks, data, t, idx) -> delta``: exchange, scores and φ for
    all shards at once (``blocks`` is ``(S, s, d)``, ``data`` the
    :func:`stack_shards` layout, ``idx`` the step's ``(S, B)`` minibatch
    indices or ``None``).

    With a minibatch, each shard scores the rows ``idx[r]`` of its own data
    (after the ``partitions`` rotation — the draw is keyed by the shard, not
    by the data rank) scaled by ``n_local_data / B``; the prior gradient is
    added once, after that scale and after the psum or the importance
    scale, in every mode (JAX ``parallel/exchange.py:_build_core``)."""
    if mode not in MODES:
        raise ValueError(f"unknown exchange mode {mode!r}")
    phi_fn, shared_scores, own_scores, prior_scores = _builder_prelude(
        logp, kernel, phi_impl, num_shards, log_prior, batch_size, n_local_data)
    resolve_data = _shard_data_resolver(mode, num_shards, shard_data)
    mb_scale = n_local_data / batch_size if batch_size is not None else None

    def lik(scores):
        return scores if mb_scale is None else mb_scale * scores

    def with_prior(scores, thetas):
        if prior_scores is None:
            return scores
        return scores + prior_scores(thetas.reshape(-1, thetas.shape[-1])).reshape(thetas.shape)

    def core(blocks, data, t: int, idx: Optional[torch.Tensor] = None):
        data_local = resolve_data(data, t)
        if mb_scale is not None:
            if idx is None:
                raise ValueError("a minibatched step needs the step's (S, B) indices")
            data_local = take_minibatch(data_local, idx)
        if mode == PARTITIONS:
            scores = with_prior(score_scale * lik(own_scores(blocks, data_local)), blocks)
            return phi_fn(blocks, blocks, scores)
        interacting = all_gather(blocks)
        local_scores = lik(shared_scores(interacting, data_local))  # (S, n, d)
        if mode == ALL_SCORES:
            scores = with_prior(psum(local_scores), interacting).expand_as(local_scores)
        else:
            scores = with_prior(score_scale * local_scores, interacting)
        return phi_fn(blocks, interacting, scores)

    return core


def make_shard_step(
    logp: Callable,
    kernel,
    mode: str,
    num_shards: int,
    score_scale: float,
    phi_impl: str = "auto",
    shard_data: bool = False,
    batch_size: Optional[int] = None,
    log_prior: Optional[Callable] = None,
    n_local_data: int = 0,
) -> Callable:
    """Build the batched SVGD step for one exchange strategy.

    Args:
        logp: ``logp(theta, data_local)`` scalar log-density; ``data_local``
            is one shard's data slice (or ``None`` for data-free targets).
            With ``log_prior`` it is the likelihood alone.
        kernel: an :class:`~dist_svgd_torch.ops.kernels.RBF` or an
            :class:`~dist_svgd_torch.ops.kernels.AdaptiveRBF` (the bandwidth
            re-estimated from each lane's interaction set every step).
        mode: one of :data:`MODES`.
        num_shards: shard count S.
        score_scale: ``N_global / N_local``, applied to scores that were not
            summed across shards; 1.0 for data-free targets.
        phi_impl: see :func:`dist_svgd_torch.ops.cuda_svgd.resolve_phi_fn`.
        shard_data: the data is sharded, not replicated (``ValueError`` in
            ``partitions``; the emulated layout is the same either way).
        batch_size: per-step per-shard minibatch size B of the
            ``n_local_data`` local rows, scaled by ``n_local_data / B``.
        log_prior: optional ``log_prior(theta)``, added once and unscaled.
        n_local_data: data rows per shard.

    Returns ``step(blocks, data, t, step_size, idx=None) -> new_blocks``:
    one Jacobi update of all ``(S, s, d)`` blocks (every shard moves its
    block against pre-update values); ``t`` is the 1-based step counter that
    drives the ``partitions`` rotation; ``idx`` the step's ``(S, B)``
    minibatch indices.
    """
    core = _build_core(logp, kernel, mode, num_shards, score_scale, phi_impl,
                       shard_data, batch_size, log_prior, n_local_data)

    def step(blocks, data, t: int, step_size: float, idx=None):
        return blocks + step_size * core(blocks, data, t, idx)

    return step


def w2_block_pairing(mode: str, w2_pairing: str, num_shards: int) -> bool:
    """Whether the W2 term uses block-sized snapshots and the ``(b+1) mod S``
    pairing — ``partitions`` natively, the exchanged modes under
    ``w2_pairing='block'`` — rather than the global mixed snapshots; with
    one shard every pairing is the global one."""
    return (mode == PARTITIONS or w2_pairing == "block") and num_shards > 1


def make_shard_step_sinkhorn_w2(
    logp: Callable,
    kernel,
    mode: str,
    num_shards: int,
    score_scale: float,
    phi_impl: str = "auto",
    sinkhorn_eps: float = 0.05,
    sinkhorn_iters: int = 200,
    sinkhorn_tol: Optional[float] = None,
    sinkhorn_warm_start: bool = True,
    w2_pairing: str = "global",
    wasserstein_solver: str = "sinkhorn",
    sinkhorn_impl: str = "auto",
    shard_data: bool = False,
    batch_size: Optional[int] = None,
    log_prior: Optional[Callable] = None,
    n_local_data: int = 0,
) -> Callable:
    """The batched SVGD step with the Wasserstein/JKO term, solved inside the
    step from carried snapshot state (Jacobi, gather implementation).

    The W2 gradient pairs each shard's **pre-update** block with its
    ``previous`` snapshot, and the update is ``new = block + ε·(δ +
    h·w_grad)`` (reference dsvgd/distsampler.py:103-129,186-205).  The
    snapshot rules (``dist_svgd_tpu/parallel/exchange.py:
    make_shard_step_sinkhorn_w2``):

    - global pairing (exchanged modes): shard ``r``'s next snapshot is the
      pre-update gathered set with only its own block post-update — the
      reference's warty mixed snapshot, ``(S, n, d)``;
    - block pairing (``partitions``, or ``w2_pairing='block'`` in exchanged
      modes; S > 1): the snapshot is the shard's own post-update block,
      ``(S, n/S, d)``, and block ``b`` pairs with the snapshot of block
      ``(b + 1) mod S`` — JAX's ``ppermute``, a roll over the lane axis.

    ``wasserstein_solver='sinkhorn'`` solves all lanes at once
    (:func:`~dist_svgd_torch.ops.ot.wasserstein_grad_sinkhorn`, route
    ``sinkhorn_impl``) and returns the lanes' dual ``g``, which warm-starts
    the next solve when ``sinkhorn_warm_start`` (a missing dual is zeros:
    the soft start from zero potentials).  ``'lp'`` solves each lane with
    the host LP (:func:`~dist_svgd_torch.ops.ot.wasserstein_grad_lp`) and
    carries no dual.  ``shard_data``, ``batch_size``, ``log_prior`` and
    ``n_local_data`` act as in :func:`make_shard_step`, so the W2 term
    composes with minibatches.

    Returns ``step(blocks, prev, g_dual, data, t, step_size, h, idx=None) ->
    (new_blocks, new_prev, new_g)``; ``prev=None`` is a first-ever step,
    which has no W2 term (reference: the term waits for a snapshot) and
    passes ``g_dual`` through.
    """
    if w2_pairing not in ("global", "block"):
        raise ValueError(f"unknown w2_pairing {w2_pairing!r}")
    if wasserstein_solver not in ("lp", "sinkhorn"):
        raise ValueError(f"unknown wasserstein_solver {wasserstein_solver!r}")
    core = _build_core(logp, kernel, mode, num_shards, score_scale, phi_impl,
                       shard_data, batch_size, log_prior, n_local_data)
    block_pair = w2_block_pairing(mode, w2_pairing, num_shards)

    def solve(blocks, prev_for, g_dual):
        if wasserstein_solver == "lp":
            grads = [torch.from_numpy(wasserstein_grad_lp(b, p))
                     for b, p in zip(blocks, prev_for)]
            return torch.stack(grads).to(blocks), g_dual
        g_init = None
        if sinkhorn_warm_start:
            g_init = (g_dual if g_dual is not None
                      else blocks.new_zeros(prev_for.shape[:2]))
        return wasserstein_grad_sinkhorn(
            blocks, prev_for, eps=sinkhorn_eps, iters=sinkhorn_iters,
            tol=sinkhorn_tol, g_init=g_init, return_g=True, impl=sinkhorn_impl)

    def step(blocks, prev, g_dual, data, t: int, step_size: float, h: float, idx=None):
        delta = core(blocks, data, t, idx)
        g_out = g_dual
        if prev is not None:
            prev_for = torch.roll(prev, -1, dims=0) if block_pair else prev
            w_grad, g_out = solve(blocks, prev_for, g_dual)
            delta = delta + h * w_grad
        new = blocks + step_size * delta
        if block_pair:
            return new, new, g_out
        S, s, d = blocks.shape
        new_prev = all_gather(blocks).repeat(S, 1, 1)  # (S, n, d)
        lanes = torch.arange(S, device=blocks.device)
        new_prev.view(S, S, s, d)[lanes, lanes] = new  # own block post-update
        return new, new_prev, g_out

    return step
