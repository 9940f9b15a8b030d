"""The three particle/score exchange strategies, as one batched step over
this process's lanes of the shard axis.

Counterpart of ``dist_svgd_tpu/parallel/exchange.py``: the gather and the
ring implementations of the ``all_*`` exchanges, the Jacobi update, the
reference's literal Gauss–Seidel sweep (:func:`_build_gs_step`), the lagged
exchange (:func:`make_shard_step_lagged`) and the resumable hop pieces of
the chunked executor (:func:`make_chunked_ring_step_fns`).  Reference
semantics:

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

**Ring execution** (``ring=True``, the ``all_*`` modes): instead of
gathering the ``(n, d)`` set, the blocks travel hop by hop around the shards
— JAX's ``ppermute`` from rank ``j`` to ``j + 1``, here the mesh's roll of
the ``(L, s, d)`` block stack (``torch.roll`` on one process, plus a
send/recv pair at each process boundary across several) — and each hop
adds the visiting block's φ contribution to a running ``(L, s, d)``
accumulator: one φ call a hop for all local lanes, each against its own
visiting block.  ``all_particles`` is one pass, each shard scoring the
visiting block on its own data; ``all_scores`` first carries each block
once around the ring summing the shards' likelihood scores (the psum), then
rotates (block, score) pairs for φ.  The same math as the gather, in
another summation order.

**Kernel approximation** (``kernel_approx``, ``ops/approx.py``): every
builder takes it and resolves its φ through
:func:`~dist_svgd_torch.ops.cuda_svgd.resolve_phi_fn`, so the gather, each
ring hop (the visiting block approximated with its own features or
landmarks), the lagged views and the W2 step all use one backend.  A φ that
redraws its bank every step (``rff_redraw='step'``) is bound to the step's
index with :func:`~dist_svgd_torch.ops.approx.bind_phi_step` where the step
knows it — the ``t`` its minibatch is keyed by.

**The mesh** (``parallel/mesh.py:ParticleMesh``): every builder takes one
(``mesh=None`` is the single-process emulation of all S shards).  A step
moves this process's ``L`` lanes — shards ``[first, first + L)`` — and every
exchange goes through the mesh: the gather and the psum, each ring hop's
rotation (:func:`_ring_rotate`), the ring's median-bandwidth subsample, the
lagged gather and the W2 snapshot's gather and block-pairing roll.  The
data slices and the ``partitions`` rotation ``(r + t) mod S`` are keyed by
the global shard index ``r``, so a lane takes its own shard's slice
whichever process holds it.  The Gauss–Seidel sweep and the chunked ring
pieces run on a single process only.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from dist_svgd_torch.ops.approx import bind_phi_step
from dist_svgd_torch.ops.cuda_svgd import resolve_phi_fn
from dist_svgd_torch.ops.kernels import RBF, AdaptiveRBF, median_bandwidth_approx_masked
from dist_svgd_torch.ops.ot import wasserstein_grad_lp, wasserstein_grad_sinkhorn
from dist_svgd_torch.parallel.mesh import ParticleMesh, all_gather, psum, split

ALL_PARTICLES = "all_particles"
ALL_SCORES = "all_scores"
PARTITIONS = "partitions"

MODES = (ALL_PARTICLES, ALL_SCORES, PARTITIONS)

#: The refusal of the Gauss–Seidel sweep under a multi-process mesh.
MULTIPROCESS_GS = ("update_rule='gauss_seidel' under a mesh over several processes is not "
                   "ported to PyTorch yet (ROADMAP A10): the sweep runs on one process")


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


def _local_mesh(mesh: Optional[ParticleMesh], num_shards: int) -> ParticleMesh:
    """``mesh``, or the single-process emulation of ``num_shards`` shards."""
    if mesh is None:
        return ParticleMesh(num_shards)
    if mesh.num_shards != num_shards:
        raise ValueError(f"mesh of {mesh.num_shards} shards for a {num_shards}-shard step")
    return mesh


def _shard_data_resolver(mode: str, num_shards: int, shard_data: bool = False,
                         mesh: Optional[ParticleMesh] = None):
    """``resolve(stacked, t) -> per-lane data``: each local lane's own
    shard's slice of the ``(S, ...)`` stack, except in ``partitions`` mode
    where shard ``r`` takes data slice ``(r + t) mod S`` — the one place the
    rotation lives (``r`` global: the mesh's lanes).

    Under the emulation the stacked per-shard layout already is what
    ``shard_data=True`` means (each shard holds only its own slice), so the
    flag changes nothing here; ``partitions`` refuses it, as in JAX, because
    its rotating data rank needs every slice."""
    if shard_data and mode == PARTITIONS:
        raise ValueError("shard_data is unsupported in partitions mode")
    mesh = _local_mesh(mesh, num_shards)

    def resolve(stacked, t: int):
        if stacked is None:
            return stacked
        if mode != PARTITIONS:
            return tree_map(mesh.local_lanes, stacked)
        def rotate(a):
            idx = (mesh.lanes(a.device) + t) % num_shards
            return a[idx]
        return tree_map(rotate, stacked)

    return resolve


def take_minibatch(data, idx: torch.Tensor):
    """Shard ``r``'s rows ``idx[r]`` of every ``(S, n_local, ...)`` leaf →
    ``(S, B, ...)`` (``draw_minibatch``'s gather, all shards at once)."""
    lanes = torch.arange(idx.shape[0], device=idx.device)[:, None]
    return tree_map(lambda a: a[lanes, idx], data)


def ring_hops_per_step(mode: str, num_shards: int) -> dict:
    """``{'hops': H, 'arrays_per_hop': A}``: how many rotations one ring
    step issues and how many arrays each rotates (JAX's count, the
    terminal hop's elided rotation included): ``all_particles`` S − 1 of 1
    array, ``all_scores`` a score pass of S plus a φ pass of S − 1, 2 arrays
    each; ``partitions`` and S = 1 none."""
    S = int(num_shards)
    if mode == PARTITIONS or S < 2:
        return {"hops": 0, "arrays_per_hop": 0}
    if mode == ALL_PARTICLES:
        return {"hops": S - 1, "arrays_per_hop": 1}
    if mode == ALL_SCORES:
        return {"hops": (S - 1) + S, "arrays_per_hop": 2}
    raise ValueError(f"unknown exchange mode {mode!r}")


def _ring_rotate(stack: torch.Tensor, mesh: ParticleMesh) -> torch.Tensor:
    """One ring hop: shard ``j``'s entry moves to shard ``j + 1`` (JAX's
    ``_ring_perm``, the reference's direction), across processes through the
    mesh."""
    return mesh.roll(stack, 1)


def _ring_local_hops(blocks, carry, score_of, phi_fn, num_hops: int, rotate_last: bool,
                     mesh: ParticleMesh):
    """Advance ``num_hops`` (accumulate, rotate) hops of the single-pass
    (``all_particles``) ring φ from the carry ``(visiting, acc)`` — the
    resumable state of the hop loop, so a pass runs whole or split at any
    hop with the same accumulation order.  Each hop is one φ call of the
    ``(S, s, d)`` blocks against the per-lane visiting blocks.
    ``rotate_last=False`` skips the final hop's rotation (the pass's
    terminal chunk only)."""
    visiting, acc = carry
    for i in range(num_hops):
        acc = acc + phi_fn(blocks, visiting, score_of(visiting))
        if rotate_last or i < num_hops - 1:
            visiting = _ring_rotate(visiting, mesh)
    return visiting, acc


def _ring_phi_local_scores(blocks, score_of, phi_fn, num_shards: int, mesh: ParticleMesh):
    """Single-pass ring φ with ``all_particles`` semantics: each visiting
    block scored by the shard it visits (``score_of``, per lane); each hop's
    φ is normalised by the block size, so the hop sum over S is the global
    mean."""
    _, acc = _ring_local_hops(blocks, (blocks, torch.zeros_like(blocks)), score_of, phi_fn,
                              num_shards, rotate_last=False, mesh=mesh)
    return acc / num_shards


def _ring_exact_score_hops(carry, lik_score_of, num_hops: int, mesh: ParticleMesh):
    """Advance ``num_hops`` hops of the ``all_scores`` score pass from the
    carry ``(visiting, vscores)``: each hop adds the visited shard's
    likelihood score of the visiting block to its travelling sum, then
    rotates both (every hop rotates, so chunks compose freely)."""
    visiting, vscores = carry
    for _ in range(num_hops):
        vscores = vscores + lik_score_of(visiting)
        visiting, vscores = _ring_rotate(visiting, mesh), _ring_rotate(vscores, mesh)
    return visiting, vscores


def _ring_exact_phi_hops(blocks, carry, phi_fn, num_hops: int, rotate_last: bool,
                         mesh: ParticleMesh):
    """Advance ``num_hops`` hops of the ``all_scores`` φ pass from the carry
    ``(visiting, vscores, acc)``: the (block, score) pairs rotate and the
    accumulator grows; ``rotate_last=False`` as in :func:`_ring_local_hops`."""
    visiting, vscores, acc = carry
    for i in range(num_hops):
        acc = acc + phi_fn(blocks, visiting, vscores)
        if rotate_last or i < num_hops - 1:
            visiting, vscores = _ring_rotate(visiting, mesh), _ring_rotate(vscores, mesh)
    return visiting, vscores, acc


def _ring_phi_exact_scores(blocks, lik_score_of, prior_of, phi_fn, num_shards: int,
                           mesh: ParticleMesh):
    """Two-pass ring φ with ``all_scores`` semantics: the score pass brings
    every block home with the shards' summed likelihood score, the prior is
    added once (``prior_of(visiting, vscores)``), then the φ pass."""
    visiting, vscores = _ring_exact_score_hops(
        (blocks, torch.zeros_like(blocks)), lik_score_of, num_shards, mesh)
    vscores = prior_of(visiting, vscores)
    _, _, acc = _ring_exact_phi_hops(blocks, (visiting, vscores, torch.zeros_like(blocks)),
                                     phi_fn, num_shards, rotate_last=False, mesh=mesh)
    return acc / num_shards


def _ring_median_bandwidth(blocks: torch.Tensor, max_points: int,
                           mesh: Optional[ParticleMesh] = None) -> torch.Tensor:
    """The gather path's per-step median bandwidth without the gathered
    set: ``median_bandwidth_approx`` of the global array subsamples rows
    ``global[::stride]``, and shard ``r`` holds those whose global index
    ``r·s + j`` is a stride multiple.  Each shard's ragged slice, padded to
    ``cap`` rows and masked, is gathered through the mesh (``(S·cap, d)``,
    the mask riding as one more column) and the masked median over it
    equals the gather's estimate exactly."""
    L, s, _ = blocks.shape
    mesh = mesh if mesh is not None else ParticleMesh(L)
    S = mesh.num_shards
    n = s * S
    stride = -(-n // max_points) if n > max_points else 1
    p = -(-n // stride)    # the global subsample's size
    cap = -(-s // stride)  # the most rows one shard contributes
    local = torch.arange(L, device=blocks.device)
    off = (-mesh.lanes(blocks.device) * s) % stride  # each shard's first stride-multiple row
    idx = off[:, None] + stride * torch.arange(cap, device=blocks.device)[None]
    valid = idx < s
    rows = blocks[local[:, None], idx.clamp(max=s - 1)]
    rows = torch.where(valid[..., None], rows, torch.zeros_like(rows))
    both = mesh.gather_lanes(torch.cat([rows, valid[..., None].to(rows.dtype)], dim=-1))
    return median_bandwidth_approx_masked(both[..., :-1].reshape(S * cap, -1),
                                          both[..., -1].reshape(-1) > 0, p, n)


def _builder_prelude(logp, kernel, phi_impl: str, num_lanes: int, log_prior=None,
                     batch_size: Optional[int] = None, n_local_data: int = 0,
                     kernel_approx=None):
    """``(phi_fn, shared_scores, own_scores, prior_scores)`` for a step over
    ``num_lanes`` local lanes:

    - ``shared_scores(thetas (n, d), data) -> (L, n, d)`` — every lane
      scores the same set on its own slice (the gather modes);
    - ``own_scores(blocks (L, s, d), data) -> (L, s, d)`` — each lane
      scores its own block (``partitions``);
    - ``prior_scores(thetas)`` — the gradient of ``log_prior`` row by row,
      ``None`` without a separate prior.

    Data-free targets (``data is None``) score once and broadcast.  A
    ``batch_size`` outside ``(0, n_local_data]`` raises ``ValueError``.
    ``phi_fn`` is the ``(phi_impl, kernel_approx)`` backend; it may need the
    step index (:func:`~dist_svgd_torch.ops.approx.bind_phi_step`)."""
    if batch_size is not None and not 0 < batch_size <= n_local_data:
        raise ValueError(f"batch_size {batch_size} not in (0, {n_local_data}] local rows")
    phi_fn = resolve_phi_fn(kernel, phi_impl, kernel_approx=kernel_approx)
    score = torch.func.vmap(torch.func.grad(logp), in_dims=(0, None))
    per_shard_shared = torch.func.vmap(score, in_dims=(None, 0))
    per_shard_own = torch.func.vmap(score, in_dims=(0, 0))
    prior_scores = (torch.func.vmap(torch.func.grad(log_prior))
                    if log_prior is not None else None)

    def shared_scores(thetas, data):
        if data is None:
            return score(thetas, None).expand(num_lanes, *thetas.shape)
        return per_shard_shared(thetas, data)

    def own_scores(blocks, data):
        if data is None:
            return score(blocks.reshape(-1, blocks.shape[-1]), None).reshape(blocks.shape)
        return per_shard_own(blocks, data)

    return phi_fn, shared_scores, own_scores, prior_scores


def _with_prior(prior_scores, scores, thetas):
    """``scores`` plus the prior gradient of ``thetas`` row by row (nothing
    to add without a separate prior)."""
    if prior_scores is None:
        return scores
    return scores + prior_scores(thetas.reshape(-1, thetas.shape[-1])).reshape(thetas.shape)


def _step_data(mode: str, num_shards: int, shard_data: bool, batch_size: Optional[int],
               n_local_data: int, mesh: Optional[ParticleMesh] = None):
    """``(local, lik)``: ``local(data, t, idx)`` is each shard's data for
    step ``t`` — its slice after the ``partitions`` rotation, then its
    minibatch rows ``idx[r]`` (the draw is keyed by the shard, not the data
    rank) — and ``lik(scores)`` applies the minibatch scale
    ``n_local_data / B``.  One definition for the gather core, the ring and
    its hop chunks, so every piece of a step sees the step's one
    minibatch."""
    resolve_data = _shard_data_resolver(mode, num_shards, shard_data, mesh)
    mb_scale = n_local_data / batch_size if batch_size is not None else None

    def local(data, t: int, idx: Optional[torch.Tensor]):
        data_local = resolve_data(data, t)
        if mb_scale is not None:
            if idx is None:
                raise ValueError("a minibatched step needs the step's (L, B) indices")
            data_local = take_minibatch(data_local, idx)
        return data_local

    def lik(scores):
        return scores if mb_scale is None else mb_scale * scores

    return local, lik


def _build_core(logp, kernel, mode: str, num_shards: int, score_scale: float,
                phi_impl: str, shard_data: bool = False, batch_size: Optional[int] = None,
                log_prior=None, n_local_data: int = 0, ring: bool = False,
                kernel_approx=None, mesh: Optional[ParticleMesh] = None):
    """``core(blocks, data, t, idx) -> delta``: exchange, scores and φ for
    all local lanes at once (``blocks`` is ``(L, s, d)``, ``data`` the
    :func:`stack_shards` layout of all S shards, ``idx`` the step's
    ``(L, B)`` minibatch indices or ``None``).

    With a minibatch, each shard scores the rows ``idx[r]`` of its own data
    (after the ``partitions`` rotation — the draw is keyed by the shard, not
    by the data rank) scaled by ``n_local_data / B``; the prior gradient is
    added once, after that scale and after the psum or the importance
    scale, in every mode (JAX ``parallel/exchange.py:_build_core``).

    ``ring=True`` runs the ``all_*`` modes by ring hops (module docstring;
    no effect in ``partitions``, already block-local).  With
    ``kernel='median_step'`` the ring resolves the bandwidth once a step
    from the gathered strided subsample (:func:`_ring_median_bandwidth`,
    the gather's exact estimate) and applies the rescaling identity
    ``φ_h(y; x, s) = φ₁(y/√h; x/√h, √h·s)/√h`` to each hop (linear in the
    hop sum, JAX ``:538-546``)."""
    if mode not in MODES:
        raise ValueError(f"unknown exchange mode {mode!r}")
    mesh = _local_mesh(mesh, num_shards)
    ring = ring and mode != PARTITIONS
    ring_adaptive = ring and isinstance(kernel, AdaptiveRBF)
    phi_base, shared_scores, own_scores, prior_scores = _builder_prelude(
        logp, RBF(1.0) if ring_adaptive else kernel, phi_impl, mesh.shards_per_process,
        log_prior, batch_size, n_local_data, kernel_approx)
    local, lik = _step_data(mode, num_shards, shard_data, batch_size, n_local_data, mesh)

    def with_prior(scores, thetas):
        return _with_prior(prior_scores, scores, thetas)

    def core(blocks, data, t: int, idx: Optional[torch.Tensor] = None):
        data_local = local(data, t, idx)
        phi_fn = bind_phi_step(phi_base, t)  # a per-step bank folds t
        if mode == PARTITIONS:
            scores = with_prior(score_scale * lik(own_scores(blocks, data_local)), blocks)
            return phi_fn(blocks, blocks, scores)
        if ring:
            hop_phi = phi_fn
            if ring_adaptive:
                sh = torch.sqrt(_ring_median_bandwidth(blocks, kernel.max_points, mesh)
                                .to(blocks.dtype))
                hop_phi = lambda y, x, s_: phi_fn(y / sh, x / sh, s_ * sh) / sh  # noqa: E731
            if mode == ALL_SCORES:
                return _ring_phi_exact_scores(
                    blocks, lambda v: lik(own_scores(v, data_local)),
                    lambda v, vs: with_prior(vs, v), hop_phi, num_shards, mesh)
            return _ring_phi_local_scores(
                blocks, lambda v: with_prior(score_scale * lik(own_scores(v, data_local)), v),
                hop_phi, num_shards, mesh)
        interacting = mesh.all_gather(blocks)
        local_scores = lik(shared_scores(interacting, data_local))  # (L, n, d)
        if mode == ALL_SCORES:
            scores = with_prior(mesh.psum(local_scores), interacting).expand_as(local_scores)
        else:
            scores = with_prior(score_scale * local_scores, interacting)
        return phi_fn(blocks, interacting, scores)

    return core


def make_chunked_ring_step_fns(logp, kernel, mode: str, num_shards: int, score_scale: float,
                               phi_impl: str = "auto", shard_data: bool = False,
                               batch_size: Optional[int] = None, log_prior=None,
                               n_local_data: int = 0, kernel_approx=None) -> dict:
    """The pieces of a ring step for a host-driven chain of bounded
    dispatches (JAX ``make_chunked_ring_step_fns``): each piece resumes the
    hop loop from an explicit carry, so the chain replays the monolithic
    pass's accumulation order exactly.  A dict of:

    - ``'local_hops'``: ``factory(num_hops, rotate_last) -> fn(blocks,
      visiting, acc, data, t, idx) -> (visiting, acc)`` (``all_particles``);
      every chunk re-derives the step's one minibatch from ``(t, idx)``;
    - ``'score_hops'``: ``factory(num_hops) -> fn(visiting, vscores, data,
      t, idx) -> (visiting, vscores)`` (``all_scores`` score pass);
    - ``'exact_phi_hops'``: ``factory(num_hops, rotate_last) -> fn(blocks,
      visiting, vscores, acc) -> (visiting, vscores, acc)``;
    - ``'add_prior'``: ``fn(visiting, vscores) -> vscores``;
    - ``'finish'``: ``fn(blocks, acc, w_grad, step_size, h) -> new_blocks``
      — the hop mean plus the update (``w_grad`` may be ``None``).

    Fixed-bandwidth kernels only: ``'median_step'`` raises ``ValueError``
    (its per-step subsample is not carried across the chain), as in JAX.  A
    φ that redraws its bank every step is refused in ``all_scores``, whose
    φ-pass chunks carry no step index (JAX's refusal)."""
    if mode not in (ALL_PARTICLES, ALL_SCORES):
        raise ValueError(
            f"chunked ring stepping is defined for the all_* modes, got {mode!r}")
    if isinstance(kernel, AdaptiveRBF):
        raise ValueError(
            "chunked ring stepping requires a fixed-bandwidth kernel: "
            "kernel='median_step' resolves per step from a gathered subsample the "
            "bounded-dispatch chain does not carry — use kernel='median' (resolved "
            "once at construction) instead")
    mesh = ParticleMesh(num_shards)  # a single process's pieces
    phi_fn, _, own_scores, prior_scores = _builder_prelude(
        logp, kernel, phi_impl, num_shards, log_prior, batch_size, n_local_data,
        kernel_approx)
    if getattr(phi_fn, "needs_step", False) and mode == ALL_SCORES:
        raise ValueError(
            "chunked all_scores ring stepping does not thread the step index through "
            "its φ-pass chunks (exact_phi_hops carries only the rotating (block, score, "
            "acc) state), which rff_redraw='step' needs for its per-step bank — use "
            "rff_redraw='run', kernel_approx='nystrom', or the all_particles mode")
    local, lik = _step_data(mode, num_shards, shard_data, batch_size, n_local_data)

    def local_hops(num_hops: int, rotate_last: bool):
        def fn(blocks, visiting, acc, data, t, idx=None):
            data_local = local(data, t, idx)
            score_of = lambda v: _with_prior(  # noqa: E731
                prior_scores, score_scale * lik(own_scores(v, data_local)), v)
            return _ring_local_hops(blocks, (visiting, acc), score_of,
                                    bind_phi_step(phi_fn, t), num_hops, rotate_last, mesh)
        return fn

    def score_hops(num_hops: int):
        def fn(visiting, vscores, data, t, idx=None):
            data_local = local(data, t, idx)
            return _ring_exact_score_hops(
                (visiting, vscores), lambda v: lik(own_scores(v, data_local)), num_hops, mesh)
        return fn

    def exact_phi_hops(num_hops: int, rotate_last: bool):
        def fn(blocks, visiting, vscores, acc):
            return _ring_exact_phi_hops(blocks, (visiting, vscores, acc), phi_fn, num_hops,
                                        rotate_last, mesh)
        return fn

    def add_prior(visiting, vscores):
        return _with_prior(prior_scores, vscores, visiting)

    def finish(blocks, acc, w_grad, step_size: float, h: float):
        delta = acc / num_shards
        if w_grad is not None:
            delta = delta + h * w_grad
        return blocks + step_size * delta

    return {"local_hops": local_hops, "score_hops": score_hops,
            "exact_phi_hops": exact_phi_hops, "add_prior": add_prior, "finish": finish}


def make_shard_step_lagged(logp, kernel, num_shards: int, score_scale: float,
                           exchange_every: int, phi_impl: str = "auto",
                           shard_data: bool = False, batch_size: Optional[int] = None,
                           log_prior=None, n_local_data: int = 0, record: bool = False,
                           kernel_approx=None, mesh: Optional[ParticleMesh] = None):
    """The lagged (stale) ``all_particles`` exchange: one gather a
    macro-step of ``exchange_every`` SVGD steps (JAX
    ``make_shard_step_lagged``, "lagged-remote, live-local").  At the
    macro-step's start each shard takes the gathered set; for each sub-step
    its interaction set is that stale snapshot with its **own block patched
    live** — a per-lane view ``(L, n, d)`` — scored afresh on its data, and
    φ runs all L views in one call; the gather goes through the mesh.

    Returns ``macro(blocks, data, t, step_size, idx_of) -> new_blocks``
    (``(new_blocks, hist)`` with ``record=True``, ``hist`` the
    ``(exchange_every, L, s, d)`` pre-update blocks of each sub-step);
    ``t`` is the first sub-step's 1-based counter and ``idx_of(u)`` the
    ``(L, B)`` minibatch indices of absolute step ``u`` (``None`` without a
    minibatch).  The port's stream is keyed by ``(seed, u)``, so sub-step
    ``i`` draws from ``(seed, t + i)``; JAX folds ``(key_t, i)`` and then
    the shard instead — the same structure, another stream (parity tests
    inject JAX's indices through the samplers' ``_batch_index_seam``)."""
    if exchange_every < 1:
        raise ValueError(f"exchange_every must be >= 1, got {exchange_every}")
    mesh = _local_mesh(mesh, num_shards)
    phi_fn, _, own_scores, prior_scores = _builder_prelude(
        logp, kernel, phi_impl, mesh.shards_per_process, log_prior, batch_size,
        n_local_data, kernel_approx)
    local, lik = _step_data(ALL_PARTICLES, num_shards, shard_data, batch_size, n_local_data,
                            mesh)

    def macro(blocks, data, t: int, step_size: float, idx_of):
        L, s, d = blocks.shape
        stale = mesh.all_gather(blocks)  # the one gather of the macro-step
        local_lanes = torch.arange(L, device=blocks.device)
        lanes = mesh.lanes(blocks.device)
        hist = []
        blk = blocks
        for i in range(exchange_every):
            view = stale.expand(L, *stale.shape).clone()
            view.view(L, num_shards, s, d)[local_lanes, lanes] = blk  # own block live
            data_local = local(data, t + i, idx_of(t + i))
            scores = _with_prior(prior_scores, score_scale * lik(own_scores(view, data_local)),
                                 view)
            if record:
                hist.append(blk)
            # sub-step i is absolute step t + i: a per-step bank folds it
            blk = blk + step_size * bind_phi_step(phi_fn, t + i)(blk, view, scores)
        if record:
            return blk, torch.stack(hist)
        return blk

    return macro


def _build_gs_step(logp, kernel, mode: str, num_shards: int, score_scale: float,
                   phi_impl: str, shard_data: bool = False, batch_size: Optional[int] = None,
                   log_prior=None, n_local_data: int = 0, ring: bool = False,
                   kernel_approx=None, mesh: Optional[ParticleMesh] = None):
    """The reference's literal Gauss–Seidel step, all shards at once (JAX
    ``parallel/exchange.py:_build_gs_step``; reference
    dsvgd/distsampler.py:194-200, ``tests/_oracle.py``).

    Each shard holds a private view — the gathered set in the exchanged
    modes, its own block in ``partitions`` — and sweeps its owned rows in
    order inside it, row ``i + 1`` seeing row ``i``'s new value.  Every row
    re-scores the whole view at its current values on the shard's data
    (importance-scaled, prior added once), except in ``all_scores``, whose
    exchanged scores are frozen at their pre-update psum for the whole step.
    Only the shard's own block is committed: the other rows of a view stay
    at their pre-exchange values.  The S shards are independent, so row
    ``i`` of every shard moves in one φ call, ``phi_fn(y (S, 1, d), view
    (S, m, d), scores)``: one φ launch a row and step, not S.  A
    ``w_grad`` ``(S, s, d)`` (the W2 gradient, solved once from the
    pre-sweep blocks) is applied row by row, ``δ_i = φ + h·w_grad_i``.

    Minibatches, the ring and ``kernel_approx`` are refused (``ValueError``),
    as in JAX; so is a mesh over several processes (``NotImplementedError``,
    ROADMAP A10: the sweep runs on the single-process emulation).
    Returns ``gs(blocks, data, t, step_size, w_grad=None, h=1.0) ->
    new_blocks``."""
    if mode not in MODES:
        raise ValueError(f"unknown exchange mode {mode!r}")
    if mesh is not None and mesh.multiprocess:
        raise NotImplementedError(MULTIPROCESS_GS)
    if ring:
        raise ValueError("update_rule='gauss_seidel' requires exchange_impl='gather' "
                         "(the sweep mutates a materialised local view)")
    if batch_size is not None:
        raise ValueError("minibatching supports only the jacobi update rule")
    if kernel_approx is not None:
        raise ValueError(
            "kernel_approx requires update_rule='jacobi' (the GS sweep exists for "
            "literal reference parity, which an approximate kernel cannot provide)")
    phi_fn, shared_scores, own_scores, prior_scores = _builder_prelude(
        logp, kernel, phi_impl, num_shards, log_prior, None, n_local_data)
    resolve_data = _shard_data_resolver(mode, num_shards, shard_data)

    def gs(blocks, data, t: int, step_size: float, w_grad=None, h: float = 1.0):
        S, s, d = blocks.shape
        data_local = resolve_data(data, t)
        lanes = torch.arange(S, device=blocks.device)
        if mode == PARTITIONS:
            view, lo = blocks.clone(), torch.zeros_like(lanes)
        else:
            view, lo = all_gather(blocks).repeat(S, 1, 1), lanes * s  # (S, n, d)
        if mode == ALL_SCORES:
            gathered = view[0]
            frozen = _with_prior(prior_scores, psum(shared_scores(gathered, data_local)),
                                 gathered).expand_as(view)
        for i in range(s):
            if mode == ALL_SCORES:
                scores = frozen
            else:  # fresh scores of the view as it stands
                scores = _with_prior(prior_scores, score_scale * own_scores(view, data_local),
                                     view)
            rows = lo + i
            y = view[lanes, rows]  # (S, d), pre-update
            delta = phi_fn(y[:, None], view, scores)[:, 0]
            if w_grad is not None:
                delta = delta + h * w_grad[:, i]
            view[lanes, rows] = y + step_size * delta
        if mode == PARTITIONS:
            return view
        return view.view(S, S, s, d)[lanes, lanes]  # each shard's own block

    return gs


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
    update_rule: str = "jacobi",
    ring: bool = False,
    kernel_approx=None,
    mesh: Optional[ParticleMesh] = None,
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
        update_rule: ``'jacobi'`` (every shard moves its block against
            pre-update values) or ``'gauss_seidel'`` (the literal sweep,
            :func:`_build_gs_step`; no minibatch).
        ring: the ring implementation of the ``all_*`` exchanges (module
            docstring; Jacobi only).
        kernel_approx: the sub-quadratic φ (``ops/approx.py``; Jacobi
            only), resolved with ``phi_impl`` by
            :func:`~dist_svgd_torch.ops.cuda_svgd.resolve_phi_fn`.
        mesh: the :class:`~dist_svgd_torch.parallel.mesh.ParticleMesh` whose
            local lanes the step moves (``None``: all S, one process).

    Returns ``step(blocks, data, t, step_size, idx=None, w_grad=None,
    h=1.0) -> new_blocks``: one update of the local ``(L, s, d)`` blocks; ``t`` is
    the 1-based step counter that drives the ``partitions`` rotation;
    ``idx`` the step's ``(L, B)`` minibatch indices; ``w_grad`` a W2
    gradient solved outside the step (the chunked executor's), added as
    ``δ + h·w_grad``.
    """
    if update_rule == "gauss_seidel":
        gs = _build_gs_step(logp, kernel, mode, num_shards, score_scale, phi_impl,
                            shard_data, batch_size, log_prior, n_local_data, ring,
                            kernel_approx, mesh)
        return (lambda blocks, data, t, step_size, idx=None, w_grad=None, h=1.0:
                gs(blocks, data, t, step_size, w_grad, h))
    if update_rule != "jacobi":
        raise ValueError(f"unknown update_rule {update_rule!r}")
    core = _build_core(logp, kernel, mode, num_shards, score_scale, phi_impl,
                       shard_data, batch_size, log_prior, n_local_data, ring, kernel_approx,
                       mesh)

    def step(blocks, data, t: int, step_size: float, idx=None, w_grad=None, h: float = 1.0):
        delta = core(blocks, data, t, idx)
        if w_grad is not None:
            delta = delta + h * w_grad
        return blocks + step_size * delta

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
    update_rule: str = "jacobi",
    ring: bool = False,
    kernel_approx=None,
    mesh: Optional[ParticleMesh] = None,
) -> Callable:
    """The batched SVGD step with the Wasserstein/JKO term, solved inside the
    step from carried snapshot state (gather implementation).

    The W2 gradient pairs each shard's **pre-update** block with its
    ``previous`` snapshot, and the update is ``new = block + ε·(δ +
    h·w_grad)`` (reference dsvgd/distsampler.py:103-129,186-205).  The
    snapshot rules (``dist_svgd_tpu/parallel/exchange.py:
    make_shard_step_sinkhorn_w2``):

    - global pairing (exchanged modes): shard ``r``'s next snapshot is the
      pre-update gathered set with only its own block post-update — the
      reference's warty mixed snapshot, ``(L, n, d)`` on a process;
    - block pairing (``partitions``, or ``w2_pairing='block'`` in exchanged
      modes; S > 1): the snapshot is the shard's own post-update block,
      ``(L, n/S, d)``, and block ``b`` pairs with the snapshot of block
      ``(b + 1) mod S`` — JAX's ``ppermute``, the mesh's roll by −1.

    ``wasserstein_solver='sinkhorn'`` solves all lanes at once
    (:func:`~dist_svgd_torch.ops.ot.wasserstein_grad_sinkhorn`, route
    ``sinkhorn_impl``) and returns the lanes' dual ``g``, which warm-starts
    the next solve when ``sinkhorn_warm_start`` (a missing dual is zeros:
    the soft start from zero potentials).  ``'lp'`` solves each lane with
    the host LP (:func:`~dist_svgd_torch.ops.ot.wasserstein_grad_lp`) and
    carries no dual.  ``shard_data``, ``batch_size``, ``log_prior`` and
    ``n_local_data`` act as in :func:`make_shard_step`, so the W2 term
    composes with minibatches, and so does ``kernel_approx``; ``ring`` too (the snapshot rules are the
    same: under the emulation the global pairing's gathered set is at hand).

    ``update_rule='gauss_seidel'`` composes the term with the literal sweep
    as JAX does: the W2 gradient is solved once a step from the pre-sweep
    blocks and applied row by row (:func:`_build_gs_step`); the snapshot is
    built from the pre-sweep gather with the swept own block patched in, the
    same rule as the Jacobi step's.

    Returns ``step(blocks, prev, g_dual, data, t, step_size, h, idx=None) ->
    (new_blocks, new_prev, new_g)``; ``prev=None`` is a first-ever step,
    which has no W2 term (reference: the term waits for a snapshot) and
    passes ``g_dual`` through.
    """
    if w2_pairing not in ("global", "block"):
        raise ValueError(f"unknown w2_pairing {w2_pairing!r}")
    if wasserstein_solver not in ("lp", "sinkhorn"):
        raise ValueError(f"unknown wasserstein_solver {wasserstein_solver!r}")
    mesh = _local_mesh(mesh, num_shards)
    if update_rule == "gauss_seidel":
        gs = _build_gs_step(logp, kernel, mode, num_shards, score_scale, phi_impl,
                            shard_data, batch_size, log_prior, n_local_data, ring,
                            kernel_approx, mesh)
    elif update_rule == "jacobi":
        core = _build_core(logp, kernel, mode, num_shards, score_scale, phi_impl,
                           shard_data, batch_size, log_prior, n_local_data, ring,
                           kernel_approx, mesh)
    else:
        raise ValueError(f"unknown update_rule {update_rule!r}")
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
        w_grad, g_out = None, g_dual
        if prev is not None:
            prev_for = mesh.roll(prev, -1) if block_pair else prev
            w_grad, g_out = solve(blocks, prev_for, g_dual)
        if update_rule == "gauss_seidel":
            new = gs(blocks, data, t, step_size, w_grad, h)
        else:
            delta = core(blocks, data, t, idx)
            if w_grad is not None:
                delta = delta + h * w_grad
            new = blocks + step_size * delta
        return new, w2_snapshot(blocks, new, block_pair, mesh), g_out

    return step


def w2_snapshot(blocks: torch.Tensor, new: torch.Tensor, block_pair: bool,
                mesh: Optional[ParticleMesh] = None) -> torch.Tensor:
    """The next W2 ``previous`` stack from a step's pre-update ``blocks``
    and post-update ``new``: the own post-update block under block pairing,
    else each lane's mixed snapshot — the pre-update gathered set with
    only its own block post-update, ``(L, n, d)``."""
    if block_pair:
        return new
    L, s, d = blocks.shape
    mesh = mesh if mesh is not None else ParticleMesh(L)
    new_prev = mesh.all_gather(blocks).repeat(L, 1, 1)  # (L, n, d)
    local = torch.arange(L, device=blocks.device)
    new_prev.view(L, mesh.num_shards, s, d)[local, mesh.lanes(blocks.device)] = new
    return new_prev
