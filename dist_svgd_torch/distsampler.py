"""Sharded SVGD sampler on one card.

Counterpart of ``dist_svgd_tpu/distsampler.py:DistSampler``.  The global
``(n, d)`` particle array is split into S equal blocks, the shards; one
batched step moves every block (``parallel/exchange.py``), with the S shards
emulated on one device as a leading batch axis — as the JAX package
emulates them on one chip under ``vmap``.

Ported: the constructor with the JAX signature and defaults, the
drop-remainder policy (particles and data rows), the importance scale
``N_global / N_local``, the three exchange modes with the gather
implementation and the Jacobi update, per-shard per-step minibatches
(``batch_size``, drawn from a stream keyed by ``(seed, t)``), a separate
unscaled prior (``log_prior``), sharded data (``shard_data``), the
per-step median bandwidth (``kernel='median_step'``), the
Wasserstein/JKO term (host LP through ``make_step``, Sinkhorn through
``make_step`` and ``run_steps``, both W2 pairings, the carried Sinkhorn
dual), ``make_step``, monolithic ``run_steps(record=False)``, and
``state_dict`` / ``load_state_dict`` for the particles, the step counter,
the minibatch stream's seed, the W2 snapshots and duals and the topology
manifest.  Every other option raises ``NotImplementedError``
naming its ROADMAP item, so a call that runs here means what it means in
JAX.

The W2 snapshot semantics are the reference's (warty) ones: in exchanged
modes each shard's ``previous`` is the pre-update gathered set with only its
own block post-update; under block pairing (``partitions``, or
``w2_pairing='block'``) it is the shard's own post-update block, and block
``b`` pairs with the snapshot of block ``(b + 1) mod S``.
"""

from __future__ import annotations

import warnings
from typing import Callable, Optional

import numpy as np
import torch

from dist_svgd_torch.ops.kernels import RBF, AdaptiveRBF, median_bandwidth
from dist_svgd_torch.parallel.exchange import (
    ALL_PARTICLES,
    ALL_SCORES,
    PARTITIONS,
    make_shard_step,
    make_shard_step_sinkhorn_w2,
    stack_shards,
    tree_map,
    w2_block_pairing,
)
from dist_svgd_torch.parallel.mesh import merge, split
from dist_svgd_torch.utils import checkpoint as _ckpt
from dist_svgd_torch.utils.platform import resolve_device
from dist_svgd_torch.utils.rng import minibatch_indices


#: Above this global particle count, ``w2_pairing='auto'`` routes the
#: exchanged-mode W2 term to the block pairing (the JAX package's measured
#: memory cliff of the global pairing's per-shard ``(n, d)`` snapshots; kept
#: so that both packages resolve the same pairing for the same run).
W2_GLOBAL_PAIRING_MAX_N = 400_000

#: ``state_dict`` encoding of the resolved ``w2_pairing`` (an index).
W2_PAIRING_CODES = ("global", "block")


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported to PyTorch yet (ROADMAP {item})")


def _data_rows(data) -> int:
    rows = []
    tree_map(lambda a: rows.append(a.shape[0]), data)
    return rows[0] if rows else 0


class DistSampler:
    """Distributed SVGD sampler (see the JAX ``DistSampler`` for the full
    option semantics; the ported subset is listed in the module docstring).

    Args:
        num_shards: shard count S.
        logp: ``logp(theta, data_local)`` scalar log-density in torch.
        kernel: ``None`` (the reference's ``RBF(1)``), an :class:`RBF`,
            ``'median'`` — an RBF at the median-heuristic bandwidth of the
            initial particles, resolved once here — or ``'median_step'`` /
            an :class:`AdaptiveRBF`: the bandwidth re-estimated every step
            from each shard's interaction set (the gathered set in the
            exchanged modes, the shard's own block in ``partitions``).
        particles: ``(n, d)`` initial particles (tensor or array); truncated
            to ``S · (n // S)`` rows.  Their dtype is the run's dtype.
        data: optional tensor / tuple / list / dict of arrays with a common
            leading row axis, replicated and sliced per shard.  Floating
            leaves are cast to the particles' dtype.
        N_local / N_global: importance-scaling sizes (default: the per-shard
            slice ``rows // S`` and ``S`` times it).
        exchange_particles / exchange_scores: (True, True) = ``all_scores``,
            (True, False) = ``all_particles``, (False, False) =
            ``partitions``.
        include_wasserstein: add the W2/JKO proximal term each step (the
            JAX default ``True``); it waits for a previous snapshot, so the
            first-ever step has none.
        wasserstein_solver: ``'lp'`` (host LP, reference parity;
            :meth:`make_step` only) or ``'sinkhorn'`` (entropic OT on the
            device; ``sinkhorn_eps`` relative regulariser, ``sinkhorn_iters``
            cap, ``sinkhorn_tol`` early exit or ``None`` for the fixed count,
            ``sinkhorn_warm_start`` carries each shard's dual ``g``).  On the
            card float32 d ≤ 8 solves run the hand kernels (``ops/cuda_ot.py``:
            the fused route, or the streaming route from 2²⁸ pairs a shard);
            everything else the torch route.
        w2_pairing: ``'global'`` (each shard's block against its full mixed
            snapshot), ``'block'`` (block ``b`` against the snapshot of block
            ``(b+1) mod S``) or ``'auto'`` (global up to
            :data:`W2_GLOBAL_PAIRING_MAX_N` particles, then block, with a
            warning).  ``partitions`` is always block-paired (``'global'``
            raises there); the value is inert with the W2 term off.
        shard_data: shard the data rows instead of replicating them
            (``all_*`` modes only; ``partitions`` raises ``ValueError``).
            Rows are truncated to ``S · (rows // S)`` either way; under the
            emulation every shard already holds only its own slice.
        batch_size: per-step per-shard minibatch size B: each shard scores
            B of its ``rows // S`` rows, drawn without replacement for the
            step, scaled ``(rows // S) / B`` (unbiased).  BASELINE.json
            config 4.
        log_prior: optional separate prior ``log_prior(theta)``; ``logp`` is
            then the likelihood alone and the prior gradient is added once,
            unscaled.
        phi_impl: ``'auto'`` (the exact hand CUDA kernel on the card, its
            plain version on the CPU), ``'torch'`` (the plain
            ``ops.svgd.phi``), ``'cuda'`` (the exact kernel; refused on the
            CPU), ``'cuda_bf16'`` (the bf16 tiers — JAX's ``'pallas_bf16'``)
            or ``'torch_bf16'`` (their plain versions) — see
            :func:`dist_svgd_torch.ops.cuda_svgd.resolve_phi_fn`.
        seed: an int, the root of the minibatch stream: step ``t`` draws
            from ``(seed, t)`` alone, so a resume continues it.
        device: ``None`` → the card (raises without CUDA); ``'cpu'`` for the
            plain path.
        donate_carries: accepted for signature parity; it has no effect
            without a compiled scan.  Every other option outside the slice
            raises ``NotImplementedError``.
    """

    def __init__(
        self,
        num_shards: int,
        logp: Callable,
        kernel,
        particles,
        data=None,
        N_local: Optional[int] = None,
        N_global: Optional[int] = None,
        exchange_particles: bool = True,
        exchange_scores: bool = True,
        include_wasserstein: bool = True,
        update_rule: str = "jacobi",
        wasserstein_solver: str = "lp",
        sinkhorn_eps: float = 0.05,
        sinkhorn_iters: int = 200,
        sinkhorn_tol: Optional[float] = 1e-2,
        sinkhorn_warm_start: bool = True,
        mesh="auto",
        exchange_impl: str = "gather",
        exchange_every: int = 1,
        shard_data: bool = False,
        batch_size: Optional[int] = None,
        log_prior: Optional[Callable] = None,
        phi_impl: str = "auto",
        w2_pairing: str = "auto",
        seed=0,
        kernel_approx=None,
        donate_carries: bool = True,
        device=None,
    ):
        if exchange_scores and not exchange_particles:
            raise ValueError("must exchange particles to also exchange scores")
        if wasserstein_solver not in ("lp", "sinkhorn"):
            raise ValueError(f"unknown wasserstein_solver {wasserstein_solver!r}")
        if exchange_impl not in ("gather", "ring"):
            raise ValueError(f"unknown exchange_impl {exchange_impl!r}")
        if exchange_every < 1:
            raise ValueError(f"exchange_every must be >= 1, got {exchange_every}")
        if update_rule not in ("jacobi", "gauss_seidel"):
            raise ValueError(f"unknown update_rule {update_rule!r}")
        if w2_pairing not in ("auto", "global", "block"):
            raise ValueError(f"unknown w2_pairing {w2_pairing!r}")
        if update_rule == "gauss_seidel":
            raise _not_ported("update_rule='gauss_seidel'", "A10")
        if exchange_impl == "ring":
            raise _not_ported("exchange_impl='ring'", "A10")
        if exchange_every > 1:
            raise _not_ported("exchange_every > 1 (the lagged exchange)", "A10")
        if shard_data and not exchange_particles:
            raise ValueError("shard_data is unsupported in partitions mode")
        if isinstance(seed, bool) or not isinstance(seed, (int, np.integer)):
            raise ValueError(f"seed must be an int (the minibatch stream's root), got {seed!r}")
        if kernel_approx is not None:
            raise _not_ported("kernel_approx", "A11")
        if not (mesh is None or (isinstance(mesh, str) and mesh == "auto")):
            raise _not_ported(
                "an explicit mesh (the torch.distributed backend; the port "
                "emulates the shards on one device)", "A6")

        self._device = resolve_device(device)
        if phi_impl == "cuda" and self._device.type != "cuda":
            raise ValueError(
                "phi_impl='cuda' launches the hand kernel and needs the card; "
                "use phi_impl='auto' or 'torch' on the CPU"
            )
        self._num_shards = int(num_shards)
        self._logp = logp
        self._phi_impl = phi_impl
        self._shard_data = bool(shard_data)
        self._batch_size = None if batch_size is None else int(batch_size)
        self._log_prior = log_prior
        self._seed = int(seed)
        #: Private seam: ``fn(t) -> (S, B)`` minibatch indices for step
        #: ``t``, used instead of the sampler's own stream when set (tests
        #: inject the JAX stream's indices through it).
        self._batch_index_seam = None

        particles = torch.as_tensor(particles, device=self._device)
        if not particles.is_floating_point() or particles.dim() != 2:
            raise ValueError(
                f"particles must be a floating (n, d) array, got "
                f"{particles.dtype} {tuple(particles.shape)}")
        if isinstance(kernel, str) and kernel == "median":
            kernel = RBF(float(median_bandwidth(particles)))
        elif isinstance(kernel, str) and kernel == "median_step":
            kernel = AdaptiveRBF()
        self._kernel = kernel if kernel is not None else RBF(1.0)

        n, self._d = particles.shape
        self._particles_per_shard = n // self._num_shards
        # drop-remainder policy (reference dsvgd/distsampler.py:42-45)
        self._num_particles = self._particles_per_shard * self._num_shards
        self._particles = particles[: self._num_particles].clone()

        def to_device(a):
            a = torch.as_tensor(a, device=self._device)
            return a.to(particles.dtype) if a.is_floating_point() else a

        self._data = tree_map(to_device, data)
        rows = _data_rows(self._data)
        self._rows_per_shard = rows // self._num_shards
        self._N_local = int(N_local) if N_local is not None else self._rows_per_shard
        self._N_global = (int(N_global) if N_global is not None
                          else self._N_local * self._num_shards)
        self._score_scale = (float(self._N_global) / float(self._N_local)
                             if self._N_local else 1.0)
        self._data_stacked = stack_shards(self._data, self._num_shards,
                                          self._rows_per_shard)

        if exchange_particles:
            self._mode = ALL_SCORES if exchange_scores else ALL_PARTICLES
        else:
            self._mode = PARTITIONS
        self._step = make_shard_step(
            logp=logp,
            kernel=self._kernel,
            mode=self._mode,
            num_shards=self._num_shards,
            score_scale=self._score_scale,
            phi_impl=phi_impl,
            **self._data_kwargs(),
        )
        self._t = 0  # step counter (drives the partitions rotation)

        self._include_wasserstein = bool(include_wasserstein)
        self._wasserstein_solver = wasserstein_solver
        self._sinkhorn = dict(sinkhorn_eps=sinkhorn_eps, sinkhorn_iters=sinkhorn_iters,
                              sinkhorn_tol=sinkhorn_tol,
                              sinkhorn_warm_start=bool(sinkhorn_warm_start))
        self._w2_pairing = self._resolve_w2_pairing(w2_pairing)
        self._block_w2 = w2_block_pairing(self._mode, self._w2_pairing, self._num_shards)
        #: Sinkhorn route of the W2 step (``ops/ot.py:_resolve_sinkhorn_route``);
        #: internal — a run may pin ``'torch'`` or ``'cuda'`` before its first
        #: W2 step to compare the routes.
        self._sinkhorn_impl = "auto"
        self._w2_step = None  # built at the first W2 step
        # The W2 "previous" snapshot stack (_prev_shape()) and the carried
        # Sinkhorn dual per shard (_g_shape()); None until the first step /
        # the first solve, as in the reference (dsvgd/distsampler.py:50).
        self._previous = None
        self._w2_g = None

    def _data_kwargs(self) -> dict:
        """The minibatch, prior and data-layout arguments of both step
        builders."""
        return dict(shard_data=self._shard_data, batch_size=self._batch_size,
                    log_prior=self._log_prior, n_local_data=self._rows_per_shard)

    def _batch_indices(self, t: int):
        """Step ``t``'s ``(S, B)`` minibatch indices, or ``None`` for a
        full-batch run."""
        if self._batch_size is None:
            return None
        if self._batch_index_seam is not None:
            return torch.as_tensor(self._batch_index_seam(t), dtype=torch.int64,
                                   device=self._device)
        return minibatch_indices(self._seed, t, self._num_shards, self._rows_per_shard,
                                 self._batch_size, self._device)

    def _resolve_w2_pairing(self, w2_pairing: str) -> str:
        """The JAX constructor's pairing resolution (``'auto'`` routing,
        the partitions rule, the large-n warnings)."""
        if not self._include_wasserstein:  # inert: any valid value is accepted
            return "block" if self._mode == PARTITIONS else "global"
        if self._mode == PARTITIONS:
            if w2_pairing == "global":
                raise ValueError(
                    "w2_pairing='global' is undefined in partitions mode — its W2 "
                    "pairing is inherently block-level (the (b+1) ring roll)")
            return "block"
        n = self._num_particles
        if w2_pairing == "auto":
            if n > W2_GLOBAL_PAIRING_MAX_N and self._num_shards > 1:
                warnings.warn(
                    f"n={n} exceeds the exchanged-mode global-W2-pairing ceiling "
                    f"({W2_GLOBAL_PAIRING_MAX_N}): routing the Wasserstein term to "
                    "w2_pairing='block' (block snapshots; (n/S, n/S) solves).  Pass "
                    "w2_pairing='global' to force the reference pairing",
                    stacklevel=3)
                return "block"
            return "global"
        if w2_pairing == "global" and n > W2_GLOBAL_PAIRING_MAX_N:
            warnings.warn(
                f"w2_pairing='global' forced at n={n} > {W2_GLOBAL_PAIRING_MAX_N}: "
                "each shard carries an (n, d) snapshot and solves (n/S, n)",
                stacklevel=3)
        return w2_pairing

    # ------------------------------------------------------------------ #
    # State views

    @property
    def particles(self) -> torch.Tensor:
        """Global ``(n, d)`` particle tensor, logical block order."""
        return self._particles

    @property
    def t(self) -> int:
        """Absolute step counter (drives the ``partitions`` rotation)."""
        return int(self._t)

    @property
    def num_particles(self) -> int:
        return self._num_particles

    @property
    def mode(self) -> str:
        return self._mode

    @property
    def kernel(self):
        """The kernel the steps use (``'median'`` resolved at construction)."""
        return self._kernel

    @property
    def device(self) -> torch.device:
        return self._device

    @property
    def w2_pairing(self) -> str:
        """The resolved Wasserstein pairing, ``'global'`` or ``'block'``."""
        return self._w2_pairing

    def _prev_shape(self) -> tuple:
        """Shape of the ``previous`` snapshot stack: block-sized under block
        pairing, global-sized under the mixed-snapshot pairing."""
        if self._block_w2:
            return (self._num_shards, self._particles_per_shard, self._d)
        return (self._num_shards, self._num_particles, self._d)

    def _g_shape(self) -> tuple:
        """Shape of the carried Sinkhorn dual stack: one ``g`` per shard over
        its ``previous`` measure."""
        return self._prev_shape()[:2]

    # ------------------------------------------------------------------ #
    # Checkpoint / resume

    def state_dict(self) -> dict:
        """Resume state: particles, the step counter, the minibatch stream's
        seed (``rng_batch_seed``; JAX saves its key as ``rng_batch_key``),
        the resolved ``w2_pairing``, the W2 ``previous`` snapshots and the
        carried Sinkhorn duals (``None`` until they exist) and the topology
        manifest, in the JAX ``state_dict``'s keys and numpy encoding."""

        def host(t):
            return None if t is None else t.detach().cpu().numpy()

        state = {
            "particles": host(self._particles),
            "particles_start": np.asarray(0, dtype=np.int64),
            "t": np.asarray(self._t, dtype=np.int64),
            "rng_batch_seed": np.asarray(self._seed, dtype=np.int64),
            "w2_pairing": np.asarray(W2_PAIRING_CODES.index(self._w2_pairing),
                                     dtype=np.int8),
            "previous": host(self._previous),
            "w2_g": host(self._w2_g),
        }
        if self._previous is not None:
            state["previous_start"] = np.asarray(0, dtype=np.int64)
        if self._w2_g is not None:
            state["w2_g_start"] = np.asarray(0, dtype=np.int64)
        state.update(_ckpt.topology_manifest(
            self._num_shards, self._num_particles, self._d, self._rows_per_shard))
        return state

    def load_state_dict(self, state: dict) -> None:
        """Restore :meth:`state_dict` state (or a JAX save converted by
        :func:`dist_svgd_torch.utils.interop.state_from_jax`).  The manifest
        is checked first: a particle-count or dimension mismatch raises
        :class:`~dist_svgd_torch.utils.checkpoint.TopologyMismatch`.  A save
        at another shard count restores as is when it holds no W2 snapshot
        (the particle array is global); a snapshot stack of another layout
        would need JAX's reshard-on-restore (ROADMAP A8) and is refused.  A
        dual that does not match its snapshot raises ``ValueError``; a save
        under the other ``w2_pairing`` warns, as in JAX.  A saved
        ``rng_batch_seed`` replaces the constructed seed, so a minibatched
        resume continues the saved run's draws; a state without one (a JAX
        save) goes on from this sampler's own seed."""
        _ckpt.check_topology(
            state, {"n_particles": self._num_particles, "d": self._d})
        if state.get("approx_method") is not None:
            raise ValueError(
                "checkpoint was written with a kernel_approx but this sampler "
                "runs the exact kernel: resuming would switch φ backends "
                "mid-trajectory"
            )
        if int(np.asarray(state.get("particles_start", 0))) != 0:
            raise ValueError(
                "checkpoint holds one process's particle block (particles_start "
                "!= 0); assemble the full state first")
        particles = state["particles"]
        if not isinstance(particles, torch.Tensor):
            particles = torch.from_numpy(np.array(particles))
        if tuple(particles.shape) != (self._num_particles, self._d):
            raise ValueError(
                f"checkpoint particles {tuple(particles.shape)} != sampler "
                f"{(self._num_particles, self._d)}")
        previous = self._restore_w2("previous", state)
        w2_g = self._restore_w2("w2_g", state)
        if previous is not None and previous.shape != self._prev_shape():
            raise _not_ported(
                f"restoring a W2 snapshot stack {tuple(previous.shape)} saved under "
                f"another shard layout (this sampler's is {self._prev_shape()})", "A8")
        if w2_g is not None and w2_g.shape != self._g_shape():
            raise ValueError(
                f"checkpoint 'w2_g' dual {tuple(w2_g.shape)} != expected "
                f"{self._g_shape()} (corrupt or mismatched checkpoint?)")
        code = state.get("w2_pairing")
        if code is not None and self._include_wasserstein:
            saved = W2_PAIRING_CODES[int(np.asarray(code))]
            if saved != self._w2_pairing:
                warnings.warn(
                    f"checkpoint was written under w2_pairing='{saved}' but this "
                    f"sampler resolved '{self._w2_pairing}': the trajectory before "
                    "and after the restore optimises different W2 functionals",
                    stacklevel=2)
        self._particles = particles.to(device=self._device,
                                       dtype=self._particles.dtype).clone()
        self._previous, self._w2_g = previous, w2_g
        self._t = int(np.asarray(state["t"]))
        if state.get("rng_batch_seed") is not None:
            self._seed = int(np.asarray(state["rng_batch_seed"]))

    def _restore_w2(self, name: str, state: dict):
        """A W2 entry of ``state`` as a tensor of the run's dtype on its
        device (``None`` when absent); one process's block is refused."""
        value = state.get(name)
        if value is None:
            return None
        if int(np.asarray(state.get(f"{name}_start", 0))) != 0:
            raise ValueError(
                f"checkpoint {name} is one process's block ({name}_start != 0); "
                "assemble the full state first")
        if not isinstance(value, torch.Tensor):
            value = torch.from_numpy(np.array(value))
        return value.to(device=self._device, dtype=self._particles.dtype).clone()

    # ------------------------------------------------------------------ #
    # Stepping

    def _advance(self, step_size: float, h: float) -> None:
        self._t += 1
        blocks = split(self._particles, self._num_shards)
        idx = self._batch_indices(self._t)
        with torch.no_grad():
            if self._include_wasserstein:
                if self._w2_step is None:
                    self._w2_step = make_shard_step_sinkhorn_w2(
                        logp=self._logp, kernel=self._kernel, mode=self._mode,
                        num_shards=self._num_shards, score_scale=self._score_scale,
                        phi_impl=self._phi_impl, w2_pairing=self._w2_pairing,
                        wasserstein_solver=self._wasserstein_solver,
                        sinkhorn_impl=self._sinkhorn_impl, **self._sinkhorn,
                        **self._data_kwargs())
                blocks, self._previous, self._w2_g = self._w2_step(
                    blocks, self._previous, self._w2_g, self._data_stacked, self._t,
                    step_size, h, idx)
            else:
                blocks = self._step(blocks, self._data_stacked, self._t, step_size, idx)
        self._particles = merge(blocks)

    def make_step(self, step_size: float, h: float = 1.0) -> torch.Tensor:
        """Perform one distributed SVGD step; returns the global particles.
        ``h`` weights the W2 term (reference ``δ += h·w_grad``)."""
        self._advance(step_size, h)
        return self._particles

    def run_steps(
        self,
        num_steps: int,
        step_size: float,
        record: bool = False,
        h: float = 1.0,
        dispatch_budget: Optional[float] = None,
        pairs_per_sec: Optional[float] = None,
        hops_per_dispatch: Optional[int] = None,
        max_passes_per_dispatch: Optional[int] = None,
        time_dispatches: bool = False,
    ) -> torch.Tensor:
        """``num_steps`` distributed SVGD steps, monolithic — the same
        trajectory as ``num_steps`` calls of :meth:`make_step`.  Returns the
        final particles.  With the W2 term on, this requires
        ``wasserstein_solver='sinkhorn'`` (the host LP is ``make_step``-only,
        as in JAX).  ``record=True`` (history) and the chunking knobs
        (``dispatch_budget`` / ``hops_per_dispatch`` /
        ``max_passes_per_dispatch``) are not ported; ``pairs_per_sec`` and
        ``time_dispatches`` only act together with them in JAX."""
        if self._include_wasserstein and self._wasserstein_solver != "sinkhorn":
            raise ValueError(
                "run_steps with the Wasserstein term requires "
                "wasserstein_solver='sinkhorn'; the host-LP snapshot path is "
                "make_step-only")
        if record:
            raise _not_ported("run_steps(record=True) (history recording)", "A8")
        if (dispatch_budget is not None or hops_per_dispatch is not None
                or max_passes_per_dispatch is not None):
            raise _not_ported("chunked run_steps (dispatch_budget / hops / passes)", "A10")
        for _ in range(num_steps):
            self._advance(step_size, h)
        return self._particles
