"""Sharded SVGD sampler on one card.

Counterpart of ``dist_svgd_tpu/distsampler.py:DistSampler``.  The global
``(n, d)`` particle array is split into S equal blocks, the shards; one
batched step moves every block (``parallel/exchange.py``), with the S shards
emulated on one device as a leading batch axis — as the JAX package
emulates them on one chip under ``vmap``.

Ported: the constructor with the JAX signature and defaults, the
drop-remainder policy (particles and data rows), the importance scale
``N_global / N_local``, the three exchange modes with the gather and the
ring implementations (``exchange_impl='ring'``), the lagged exchange
(``exchange_every > 1``), the Jacobi update and the reference's literal
Gauss–Seidel sweep (``update_rule='gauss_seidel'``, with or without the W2
term; any kernel callable besides the RBF), per-shard per-step minibatches
(``batch_size``, drawn from a stream keyed by ``(seed, t)``), a separate
unscaled prior (``log_prior``), sharded data (``shard_data``), the
per-step median bandwidth (``kernel='median_step'``), the
Wasserstein/JKO term (host LP through ``make_step``, Sinkhorn through
``make_step`` and ``run_steps``, both W2 pairings, the carried Sinkhorn
dual), ``make_step``, ``run_steps`` monolithic or chunked into bounded
dispatches (``dispatch_budget``, ``hops_per_dispatch``,
``max_passes_per_dispatch``: whole-step chunks, ring-hop chunks and split
Sinkhorn solves), with or without the history (``record=True``, moved to
the host in :func:`~dist_svgd_torch.utils.history.record_chunk_steps`
chunks), the rotating ``partitions`` ownership
(:meth:`DistSampler.owned_block_index`), and ``state_dict`` /
``load_state_dict`` for the particles, the step counter, the minibatch
stream's seed, the W2 snapshots and duals, the kernel approximation's
identity and the topology manifest, with the W2 snapshots resharded when a
save's shard count differs, and the sub-quadratic φ (``kernel_approx``,
``ops/approx.py``) with its crossover pinned once from the global shape and
its residual probe (:meth:`DistSampler.approx_residual`).  An explicit mesh
raises ``NotImplementedError`` naming ROADMAP A10, so a call that runs here
means what it means in JAX.

A "dispatch" of the chunked executor is one host-driven segment of JAX's
plan (a chunk of steps, a chunk of ring hops, a dual-advance chunk of a
Sinkhorn solve, the finish); the seams are JAX's, so ``last_run_stats``
counts what JAX counts.  On the card each is a run of eager launches.  While
the telemetry tracer is enabled each is a span — ``train.step_chunk`` for a
chunk of whole steps (and the whole run when it is one), ``train.dispatch``
for an intra-step piece — tagged with whether it fenced.

The W2 snapshot semantics are the reference's (warty) ones: in exchanged
modes each shard's ``previous`` is the pre-update gathered set with only its
own block post-update; under block pairing (``partitions``, or
``w2_pairing='block'``) it is the shard's own post-update block, and block
``b`` pairs with the snapshot of block ``(b + 1) mod S``.
"""

from __future__ import annotations

import time
import warnings
from typing import Callable, Optional

import numpy as np
import torch

from dist_svgd_torch.ops.approx import (
    APPROX_METHOD_CODES,
    RFF_REDRAW_MODES,
    approx_preferred,
    as_kernel_approx,
    nystrom_landmark_indices,
)
from dist_svgd_torch.ops.cuda_svgd import resolve_phi_fn
from dist_svgd_torch.ops.kernels import RBF, AdaptiveRBF, median_bandwidth
from dist_svgd_torch.parallel.exchange import (
    ALL_PARTICLES,
    ALL_SCORES,
    PARTITIONS,
    make_chunked_ring_step_fns,
    make_shard_step,
    make_shard_step_lagged,
    make_shard_step_sinkhorn_w2,
    stack_shards,
    tree_map,
    w2_block_pairing,
    w2_snapshot,
)
from dist_svgd_torch.parallel.mesh import merge, split
from dist_svgd_torch.telemetry import trace as _trace
from dist_svgd_torch.utils import checkpoint as _ckpt
from dist_svgd_torch.utils import history as _history
from dist_svgd_torch.utils.platform import resolve_device
from dist_svgd_torch.utils.rng import approx_bank_seed, minibatch_indices


#: Above this global particle count, ``w2_pairing='auto'`` routes the
#: exchanged-mode W2 term to the block pairing (the JAX package's measured
#: memory cliff of the global pairing's per-shard ``(n, d)`` snapshots; kept
#: so that both packages resolve the same pairing for the same run).
W2_GLOBAL_PAIRING_MAX_N = 400_000

#: ``state_dict`` encoding of the resolved ``w2_pairing`` (an index).
W2_PAIRING_CODES = ("global", "block")

#: Pairwise interactions a second that the ``dispatch_budget`` planner
#: converts a step's work into time with (:meth:`DistSampler.run_steps`;
#: pass ``pairs_per_sec`` for other hardware).  Measured by
#: ``chip_smoke.py``'s ``dispatch_pairs_per_sec`` phase on an NVIDIA H100
#: 80GB HBM3 at a 700.00 W power limit: the 100,000-particle, 8-shard ring
#: step (banana, d = 3, no W2), n² pairs over its wall time — 15.10 ms a
#: step, 6.62e11 pairs/s.  (JAX's 2.4e11 is a TPU's rate and does not
#: carry over.)
DISPATCH_PAIRS_PER_SEC = 6.6e11


def _chunk_sizes(total: int, per: int):
    """``total`` units as full chunks of ``per`` plus a remainder (JAX's
    dispatch-chain schedule)."""
    per = max(1, min(int(per), total))
    sizes = [per] * (total // per)
    if total % per:
        sizes.append(total % per)
    return sizes


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
            initial particles, resolved once here — ``'median_step'`` /
            an :class:`AdaptiveRBF`: the bandwidth re-estimated every step
            from each shard's interaction set (the gathered set in the
            exchanged modes, the shard's own block in ``partitions``;
            Jacobi only) — or any scalar kernel callable ``kernel(a, b)``
            in torch, whose φ is the plain generic form (``phi_impl``
            ``'auto'`` or ``'torch'``).
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
        update_rule: ``'jacobi'`` (every shard moves its block against
            pre-update values) or ``'gauss_seidel'`` — the reference's
            literal in-place sweep (dsvgd/distsampler.py:194-200), each
            shard sweeping its own rows inside its private view, one φ call
            a row for all shards (``parallel/exchange.py:_build_gs_step``);
            for small-n parity with the reference.  It requires the gather
            implementation, no ``batch_size``, no ``kernel_approx`` and a
            fixed bandwidth, as in JAX.
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
        exchange_impl: ``'gather'`` (each shard gathers the ``(n, d)`` set)
            or ``'ring'`` (the blocks travel hop by hop, one φ call a hop of
            every block against its visiting block; the ``all_*`` modes, no
            effect in ``partitions``; Jacobi only; with the W2 term,
            ``run_steps`` needs the block pairing, as in JAX).  Same
            semantics, another summation order; the ring is the one with a
            seam inside a step for the chunked executor.
        exchange_every: the gather cadence T; T > 1 is the lagged exchange
            (``parallel/exchange.py:make_shard_step_lagged``): one gather a
            macro-step of T steps, each shard's view the stale set with its
            own block live; ``all_particles``, the gather implementation,
            Jacobi and no W2 term only (``ValueError`` otherwise), driven by
            :meth:`run_steps` with a multiple of T steps.
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
            plain version on float32 CPU tensors, the plain φ of ``'torch'``
            on wider ones), ``'torch'`` (the plain
            ``ops.svgd.phi``), ``'cuda'`` (the exact kernel; refused on the
            CPU), ``'cuda_bf16'`` (the bf16 tiers — JAX's ``'pallas_bf16'``)
            or ``'torch_bf16'`` (their plain versions) — see
            :func:`dist_svgd_torch.ops.cuda_svgd.resolve_phi_fn`.
        seed: an int, the root of the minibatch stream — step ``t`` draws
            from ``(seed, t)`` alone, so a resume continues it — and of the
            RFF bank stream (:func:`~dist_svgd_torch.utils.rng.
            approx_bank_seed`).
        kernel_approx: ``None`` (the exact φ), ``'rff'``, ``'nystrom'`` or a
            :class:`~dist_svgd_torch.ops.approx.KernelApprox`: the
            sub-quadratic φ on every φ call site (gather, ring hops, lagged
            views, the W2 step, the chunked pieces).  Under ``phi_impl=
            'auto'`` the crossover is decided ONCE from the global shape
            (``approx_preferred(n, m)``, m = n in the exchanged modes and
            n/S in ``partitions``) and pinned, so ring and gather, and 1 and
            S shards, pick the same backend; the pin rides ``state_dict``.
            ``'torch'`` forces the approximation; the kernel tiers are
            refused.  Jacobi only.
        device: ``None`` → the card (raises without CUDA); ``'cpu'`` for the
            plain path.
        donate_carries: accepted for signature parity; it has no effect
            without a compiled scan.  Every other option outside the port
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
            # the sweep exists for literal reference parity (JAX's rules)
            if exchange_impl == "ring":
                raise ValueError(
                    "update_rule='gauss_seidel' requires exchange_impl='gather' "
                    "(the sweep mutates a materialised local view)")
            if batch_size is not None:
                raise ValueError("minibatching supports only the jacobi update rule")
            if kernel_approx is not None:
                raise ValueError(
                    "kernel_approx requires update_rule='jacobi': the Gauss-Seidel "
                    "sweep exists for literal reference parity, which an approximate "
                    "kernel cannot provide")
            if (isinstance(kernel, str) and kernel == "median_step") or isinstance(
                    kernel, AdaptiveRBF):
                raise ValueError("kernel='median_step' requires update_rule='jacobi'")
        if exchange_every > 1:
            # JAX's rules: the lagged exchange is the gathered all_particles
            # step; the W2 snapshot bookkeeping is per step, not per refresh
            if not (exchange_particles and not exchange_scores):
                raise ValueError("exchange_every > 1 requires the all_particles mode")
            if exchange_impl != "gather":
                raise ValueError("exchange_every > 1 requires exchange_impl='gather'")
            if include_wasserstein:
                raise ValueError("exchange_every > 1 is incompatible with the Wasserstein term")
            if update_rule != "jacobi":
                raise ValueError("exchange_every > 1 requires update_rule='jacobi'")
        if shard_data and not exchange_particles:
            raise ValueError("shard_data is unsupported in partitions mode")
        if isinstance(seed, bool) or not isinstance(seed, (int, np.integer)):
            raise ValueError(f"seed must be an int (the minibatch stream's root), got {seed!r}")
        if not (mesh is None or (isinstance(mesh, str) and mesh == "auto")):
            raise _not_ported(
                "an explicit mesh (the torch.distributed backend; the port "
                "emulates the shards on one device)", "A10")

        self._device = resolve_device(device)
        self._num_shards = int(num_shards)
        self._update_rule = update_rule
        self._logp = logp
        self._phi_impl = phi_impl
        self._shard_data = bool(shard_data)
        self._batch_size = None if batch_size is None else int(batch_size)
        self._log_prior = log_prior
        self._seed = int(seed)
        self._exchange_impl = exchange_impl
        self._exchange_every = int(exchange_every)
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
        # The sub-quadratic φ: the 'auto' crossover is resolved ONCE from
        # the global shape and pinned, so the ring's per-hop blocks cannot
        # pick another backend than the gather's global set; validation
        # runs through the one policy seam
        self._approx = as_kernel_approx(kernel_approx)
        self._approx_active = False
        if self._approx is not None:
            if self._approx.method == "rff":
                self._approx = self._approx.with_seed(approx_bank_seed(seed))
            resolve_phi_fn(self._kernel, phi_impl, kernel_approx=self._approx)
            if phi_impl == "auto":
                m_interact = (self._num_particles if self._mode != PARTITIONS
                              else self._particles_per_shard)
                self._approx_active = approx_preferred(
                    self._num_particles, m_interact, self._approx.feature_count)
            else:
                self._approx_active = True  # 'torch' is always approximate
        self._build_step_programs()
        # after the step's build, which refuses a kernel the φ backend
        # cannot take
        if phi_impl == "cuda" and self._device.type != "cuda":
            raise ValueError(
                "phi_impl='cuda' launches the hand kernel and needs the card; "
                "use phi_impl='auto' or 'torch' on the CPU"
            )
        self._t = 0  # step counter (drives the partitions rotation)
        #: Execution report of the most recent :meth:`run_steps` call.
        self.last_run_stats = None

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
        # The W2 "previous" snapshot stack (_prev_shape()) and the carried
        # Sinkhorn dual per shard (_g_shape()); None until the first step /
        # the first solve, as in the reference (dsvgd/distsampler.py:50).
        self._previous = None
        self._w2_g = None

    def _phi_kwargs(self) -> dict:
        """The ``(phi_impl, kernel_approx)`` pair every step builder gets:
        the always-approximate ``'torch'`` combination while the
        approximation is pinned active, the exact configuration
        otherwise."""
        if self._approx is not None and self._approx_active:
            return {"phi_impl": "torch", "kernel_approx": self._approx}
        return {"phi_impl": self._phi_impl, "kernel_approx": None}

    def _build_step_programs(self) -> None:
        """(Re)build the step from the current kernel and approximation
        state, and drop the steps built at first use (the lagged macro-step,
        the ring's hop pieces, the W2 step) — at construction, and when a
        restored checkpoint's bank or crossover pin wins."""
        self._step = make_shard_step(
            logp=self._logp,
            kernel=self._kernel,
            mode=self._mode,
            num_shards=self._num_shards,
            score_scale=self._score_scale,
            update_rule=self._update_rule,
            ring=self._exchange_impl == "ring",
            **self._phi_kwargs(),
            **self._data_kwargs(),
        )
        self._lagged = {}  # record flag -> the lagged macro-step, built at first use
        self._chunk_builders = None  # the ring's hop pieces, built at first use
        self._w2_step = None  # built at the first W2 step

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

    @property
    def kernel_approx(self):
        """The resolved :class:`~dist_svgd_torch.ops.approx.KernelApprox`
        (RFF bank seed bound), or ``None`` for the exact kernel."""
        return self._approx

    @property
    def kernel_approx_active(self) -> bool:
        """Whether φ runs the approximation after the ``'auto'`` global-shape
        crossover (the constructor's pin, or a restored checkpoint's)."""
        return self._approx is not None and self._approx_active

    def approx_residual(self, max_points: int = 512, registry=None) -> dict:
        """The configured approximation's φ residual on the CURRENT ensemble
        (the exact against the approximate φ over a ≤ ``max_points`` strided
        subsample), published as ``svgd_diag_phi_approx_*`` gauges.  Probe
        scores are the full-data (unscaled) ``∇log p`` on the whole data
        plus the prior, as in JAX.  O(max_points²); run it at diagnostics
        cadence, not every step."""
        from dist_svgd_torch.ops.approx import phi_residual_report, record_phi_residual
        from dist_svgd_torch.ops.kernels import median_bandwidth_approx

        if self._approx is None:
            raise ValueError("approx_residual needs kernel_approx (exact runs have no "
                             "approximation residual to measure)")
        particles = self._particles
        n = particles.shape[0]
        if n > max_points:
            particles = particles[::-(-n // max_points)]
        with torch.no_grad():
            scores = torch.func.vmap(torch.func.grad(self._logp), in_dims=(0, None))(
                particles, self._data)
            if self._log_prior is not None:
                scores = scores + torch.func.vmap(torch.func.grad(self._log_prior))(particles)
        if isinstance(self._kernel, RBF):
            kernel = self._kernel
        else:  # AdaptiveRBF: probe at the current per-step median bandwidth
            kernel = RBF(float(median_bandwidth_approx(particles)))
        report = phi_residual_report(particles, scores, kernel, self._approx,
                                     max_points=max_points)
        report["active"] = bool(self._approx_active)
        record_phi_residual(report, registry=registry)
        return report

    def owned_block_index(self, rank: int, t: Optional[int] = None) -> int:
        """Logical block owned by (updated against the data slice of) shard
        ``rank`` at step counter ``t`` (default: now): ``(rank − t) mod S``
        under the ``partitions`` rotation (reference
        dsvgd/distsampler.py:148-150), ``rank`` otherwise.  An explicit
        ``t`` reads a recorded history: snapshot ``t`` of
        ``run_steps(record=True)`` was taken at counter ``t0 + t``."""
        if self._mode == PARTITIONS:
            return (rank - (self._t if t is None else t)) % self._num_shards
        return rank

    def owned_block(self, rank: int) -> torch.Tensor:
        """The block now updated against data shard ``rank`` — the
        reference's per-rank ``.particles`` view with the ring's rotating
        ownership (dsvgd/distsampler.py:53-56, 148-150)."""
        s = self._particles_per_shard
        b = self.owned_block_index(rank)
        return self._particles[b * s:(b + 1) * s]

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
        carried Sinkhorn duals (``None`` until they exist), the topology
        manifest and, with ``kernel_approx``, the approximation's identity —
        ``approx_method``, ``approx_dial``, ``approx_active`` and, for RFF,
        ``approx_rff_redraw`` and the bank stream's seed
        ``approx_bank_seed`` (JAX saves its threefry ``approx_bank_key``),
        for Nyström ``approx_landmark_idx`` — in the JAX ``state_dict``'s
        keys and numpy encoding."""

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
        if self._approx is not None:
            # layout-free: reshard_state passes these through verbatim
            state["approx_method"] = np.asarray(
                APPROX_METHOD_CODES.index(self._approx.method), dtype=np.int8)
            state["approx_dial"] = np.asarray(self._approx.accuracy_dial, dtype=np.int64)
            state["approx_active"] = np.asarray(int(self._approx_active), dtype=np.int8)
            if self._approx.method == "rff":
                state["approx_bank_seed"] = np.asarray(self._approx.seed, dtype=np.int64)
                state["approx_rff_redraw"] = np.asarray(
                    RFF_REDRAW_MODES.index(self._approx.rff_redraw), dtype=np.int8)
            else:
                m_interact = (self._num_particles if self._mode != PARTITIONS
                              else self._particles_per_shard)
                state["approx_landmark_idx"] = nystrom_landmark_indices(
                    m_interact, self._approx.num_landmarks).astype(np.int64)
        return state

    def load_state_dict(self, state: dict) -> None:
        """Restore :meth:`state_dict` state (or a JAX save converted by
        :func:`dist_svgd_torch.utils.interop.state_from_jax`).  The manifest
        is checked first: a particle-count or dimension mismatch raises
        :class:`~dist_svgd_torch.utils.checkpoint.TopologyMismatch`.  A save
        at another shard count restores too (reshard-on-restore, JAX's
        ``_reshard_previous``): the particle array is global, the W2
        snapshot stack is rebuilt exactly for this layout
        (:func:`~dist_svgd_torch.utils.checkpoint.reshard_previous_stack`),
        and the carried dual, whose pairing is per block, is dropped, so the
        first resumed solve starts cold.  A dual that does not match an
        unresharded snapshot raises ``ValueError``; a save under the other
        ``w2_pairing`` warns, as in JAX.  A saved ``rng_batch_seed``
        replaces the constructed seed, so a minibatched resume continues the
        saved run's draws; a state without one (a JAX save, whose
        ``rng_batch_key`` no torch stream can follow) goes on from this
        sampler's own seed.  JAX, given a port save, ignores
        ``rng_batch_seed`` (it reads only its own keys) and keeps its
        constructed key.

        The kernel approximation follows JAX's rules: a save with another
        method, another dial or another ``rff_redraw`` than this sampler's
        (or an approximate save into an exact sampler, or the reverse)
        raises ``ValueError``; the saved ``approx_active`` pin wins over
        this sampler's, so a resharded resume cannot switch φ backends.  A
        saved ``approx_bank_seed`` wins over the constructed bank, so an
        RFF resume is the saved run's trajectory.  A JAX save carries its
        bank as a threefry ``approx_bank_key``, which no torch stream can
        follow: it resumes on this sampler's own bank (the precedent of
        ``rng_batch_key``), and JAX, given a port save, keeps its own."""
        _ckpt.check_topology(
            state, {"n_particles": self._num_particles, "d": self._d})
        self._check_approx_identity(state)
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
            stack = _ckpt.reshard_previous_stack(previous.cpu().numpy(), self._num_particles,
                                                 self._d, self._prev_shape())
            previous = torch.from_numpy(stack).to(previous)
            w2_g = None  # the dual's per-block pairing does not survive it
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
        self._adopt_approx_state(state)

    def _check_approx_identity(self, state: dict) -> None:
        """JAX's refusals: the approximation's presence, method, dial and
        (RFF) bank lifetime must match the save's."""
        acode = state.get("approx_method")
        if (acode is None) != (self._approx is None):
            want = self._approx.method if self._approx is not None else "exact"
            saved = ("exact" if acode is None
                     else APPROX_METHOD_CODES[int(np.asarray(acode))])
            raise ValueError(
                f"checkpoint was written with kernel_approx={saved!r} but this sampler "
                f"runs {want!r}: resuming would silently switch φ backends "
                "mid-trajectory — construct the sampler with the checkpoint's "
                "kernel_approx (or retrain)")
        if acode is None:
            return
        saved_method = APPROX_METHOD_CODES[int(np.asarray(acode))]
        saved_dial = int(np.asarray(state["approx_dial"]))
        if saved_method != self._approx.method or saved_dial != self._approx.accuracy_dial:
            raise ValueError(
                f"checkpoint kernel_approx is {saved_method!r} at dial {saved_dial} but "
                f"this sampler runs {self._approx.method!r} at "
                f"{self._approx.accuracy_dial}: the accuracy dial is part of the "
                "trajectory — match the saved configuration")
        redraw_code = state.get("approx_rff_redraw")
        saved_redraw = (RFF_REDRAW_MODES[int(np.asarray(redraw_code))]
                        if redraw_code is not None else "run")
        if self._approx.method == "rff" and saved_redraw != self._approx.rff_redraw:
            raise ValueError(
                f"checkpoint was written with rff_redraw={saved_redraw!r} but this "
                f"sampler runs {self._approx.rff_redraw!r}: the bank lifetime is part "
                "of the trajectory — match the saved configuration")

    def _adopt_approx_state(self, state: dict) -> None:
        """The saved bank seed and the saved crossover pin win; the steps
        are rebuilt when either changes this sampler's φ."""
        if self._approx is None:
            return
        rebuild = False
        bank = state.get("approx_bank_seed")
        if bank is not None and int(np.asarray(bank)) != self._approx.seed:
            self._approx = self._approx.with_seed(int(np.asarray(bank)))
            rebuild = True
        active = state.get("approx_active")
        if active is not None and bool(int(np.asarray(active))) != self._approx_active:
            # in partitions the 'auto' decision depends on the block size, so
            # a resharded resume could otherwise re-pin the other backend
            self._approx_active = bool(int(np.asarray(active)))
            rebuild = True
        if rebuild:
            self._build_step_programs()

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

    def _w2_step_fn(self):
        """The step with the W2 term, built at the first W2 step (it reads
        the Sinkhorn route then)."""
        if self._w2_step is None:
            self._w2_step = make_shard_step_sinkhorn_w2(
                logp=self._logp, kernel=self._kernel, mode=self._mode,
                num_shards=self._num_shards, score_scale=self._score_scale,
                w2_pairing=self._w2_pairing, **self._phi_kwargs(),
                wasserstein_solver=self._wasserstein_solver,
                update_rule=self._update_rule, ring=self._exchange_impl == "ring",
                sinkhorn_impl=self._sinkhorn_impl, **self._sinkhorn,
                **self._data_kwargs())
        return self._w2_step

    def _advance(self, step_size: float, h: float) -> None:
        self._t += 1
        blocks = split(self._particles, self._num_shards)
        idx = self._batch_indices(self._t)
        with torch.no_grad():
            if self._include_wasserstein:
                blocks, self._previous, self._w2_g = self._w2_step_fn()(
                    blocks, self._previous, self._w2_g, self._data_stacked, self._t,
                    step_size, h, idx)
            else:
                blocks = self._step(blocks, self._data_stacked, self._t, step_size, idx)
        self._particles = merge(blocks)

    def _advance_lagged(self, step_size: float, record: bool):
        """One lagged macro-step of ``exchange_every`` steps; returns the
        pre-update global particles of each sub-step (``record=True``) or
        ``None``."""
        macro = self._lagged.get(record)
        if macro is None:
            macro = self._lagged[record] = make_shard_step_lagged(
                self._logp, self._kernel, self._num_shards, self._score_scale,
                self._exchange_every, record=record, **self._phi_kwargs(),
                **self._data_kwargs())
        blocks = split(self._particles, self._num_shards)
        with torch.no_grad():
            out = macro(blocks, self._data_stacked, self._t + 1, step_size,
                        self._batch_indices)
        self._t += self._exchange_every
        if record:
            blocks, hist = out
            self._particles = merge(blocks)
            return list(hist.reshape(self._exchange_every, self._num_particles, self._d))
        self._particles = merge(out)
        return None

    def make_step(self, step_size: float, h: float = 1.0) -> torch.Tensor:
        """Perform one distributed SVGD step; returns the global particles.
        ``h`` weights the W2 term (reference ``δ += h·w_grad``).  The lagged
        exchange refuses it (``ValueError``): drive it through
        :meth:`run_steps`."""
        if self._exchange_every > 1:
            raise ValueError(
                "exchange_every > 1 amortises one gather over a block of steps; drive "
                "it through run_steps(num_steps) with num_steps a multiple of "
                "exchange_every")
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
    ):
        """``num_steps`` distributed SVGD steps — the same trajectory as
        ``num_steps`` calls of :meth:`make_step` (a whole number of
        macro-steps under the lagged exchange).  Returns the final
        particles, or ``(final, history)`` with ``record=True``:
        ``history`` is the ``(num_steps, n, d)`` stack of pre-update
        snapshots (the state before each step — the reference's convention;
        append ``final`` for the last one).  The history goes to the host
        in chunks of :func:`~dist_svgd_torch.utils.history.
        record_chunk_steps` snapshots (looked up at run time; whole
        macro-steps under the lagged exchange), so the device never holds
        more than one chunk; a run longer than one chunk, or a chunked run,
        returns a numpy array, a shorter one a tensor on the device, as in
        JAX.  With the W2 term on, this requires
        ``wasserstein_solver='sinkhorn'`` (the host LP is ``make_step``-only)
        and, under the ring, the block pairing, as in JAX.

        Chunked execution (JAX's executor, :meth:`_plan_dispatches`):
        ``dispatch_budget`` (seconds) picks, from n, S and ``pairs_per_sec``
        (default :data:`DISPATCH_PAIRS_PER_SEC`), the coarsest plan whose
        largest dispatch fits — the whole run (``'monolithic'``), chunks of
        whole steps (``'scan_chunks'``) or chunks inside a step
        (``'intra_step'``: ring hops ``hops_per_dispatch`` at a time, each
        Sinkhorn solve split into ``max_passes_per_dispatch``-iteration
        dual advances, :func:`~dist_svgd_torch.ops.ot.sinkhorn_dual_advance`).
        ``hops_per_dispatch`` / ``max_passes_per_dispatch`` force the
        intra-step plan.  Hop chunks replay the monolithic accumulation
        order; split solves agree at convergence.  ``time_dispatches``
        fences each dispatch (``torch.cuda.synchronize`` on the card) and
        records the longest.  Each call writes :attr:`last_run_stats`
        (``execution``, ``num_dispatches``, ``dispatches_per_step``,
        ``max_dispatch_wall_s``, the resolved knobs and ``w2_pairing``)."""
        if self._include_wasserstein:
            if self._wasserstein_solver != "sinkhorn" or (
                    self._exchange_impl == "ring" and self._mode != PARTITIONS
                    and not self._block_w2 and self._num_shards > 1):
                raise ValueError(
                    "run_steps with the Wasserstein term requires "
                    "wasserstein_solver='sinkhorn', and the global W2 pairing "
                    "requires exchange_impl='gather' (its snapshot is the gathered "
                    "set; pass w2_pairing='block' to compose with the ring "
                    "implementation).  The host-LP snapshot path is make_step-only")
        if self._exchange_every > 1 and num_steps % self._exchange_every:
            raise ValueError(f"num_steps ({num_steps}) must be a multiple of "
                             f"exchange_every ({self._exchange_every})")
        explicit = hops_per_dispatch is not None or max_passes_per_dispatch is not None
        for name, val in (("hops_per_dispatch", hops_per_dispatch),
                          ("max_passes_per_dispatch", max_passes_per_dispatch)):
            if val is not None and val < 1:
                raise ValueError(f"{name} must be >= 1, got {val}")
        if dispatch_budget is not None and explicit:
            raise ValueError(
                "pass either dispatch_budget (auto-chunking) or explicit "
                "hops_per_dispatch / max_passes_per_dispatch, not both")
        if dispatch_budget is None and not explicit:
            with _trace.span("train.step_chunk",
                             {"steps": num_steps, "execution": "monolithic"}
                             if _trace.enabled() else None):
                return self._run_eager(num_steps, step_size, record, h)
        if explicit:
            plan = {"execution": "intra_step", "hops_per_dispatch": hops_per_dispatch,
                    "max_passes_per_dispatch": max_passes_per_dispatch}
        else:
            if dispatch_budget <= 0:
                raise ValueError(f"dispatch_budget must be positive, got {dispatch_budget}")
            plan = self._plan_dispatches(num_steps, dispatch_budget, pairs_per_sec)
        if plan["execution"] == "monolithic":
            run, rec = self._dispatch_runner(time_dispatches, "train.step_chunk")
            out = run(self._run_eager, num_steps, step_size, record, h)
            self.last_run_stats = self._stats(
                "monolithic", num_steps, rec["count"], rec["max_wall"],
                dispatch_budget_s=dispatch_budget,
                record_chunks_to_host=self.last_run_stats["record_chunks_to_host"])
            return out
        if plan["execution"] == "scan_chunks":
            return self._run_steps_scan_chunks(num_steps, step_size, record, h,
                                               plan["steps_per_dispatch"], time_dispatches,
                                               dispatch_budget)
        return self._run_steps_intra(num_steps, step_size, record, h,
                                     plan.get("hops_per_dispatch"),
                                     plan.get("max_passes_per_dispatch"), time_dispatches,
                                     dispatch_budget)

    def _record_chunk(self) -> int:
        """Snapshots a history chunk holds on the device
        (:func:`~dist_svgd_torch.utils.history.record_chunk_steps`, looked
        up at run time); under the lagged exchange a whole number of
        macro-steps, forced up to one with a warning (JAX's
        ``_record_chunk``)."""
        rc = _history.record_chunk_steps(self._num_particles, self._d,
                                         self._particles.element_size())
        T = self._exchange_every
        if T > 1 and rc < T:
            warnings.warn(
                f"record=True history chunk forced up from {rc} to the lagged exchange "
                f"cadence {T}: one macro-step's (T={T}, n={self._num_particles}, d) "
                "snapshot stack is the indivisible recording unit and exceeds the "
                "device history budget (utils/history.py:RECORD_HBM_BUDGET_BYTES) — "
                "expect elevated device memory, or drop exchange_every / record at "
                "this scale", stacklevel=4)
            return T
        return rc - rc % T if T > 1 else rc

    def _run_eager(self, num_steps: int, step_size: float, record: bool, h: float):
        """The run as one host loop of steps (macro-steps under the lagged
        exchange), the history moved to the host a chunk at a time."""
        chunk = self._record_chunk() if record else num_steps
        spill = num_steps > chunk  # a history longer than one chunk goes to the host
        held, host = [], []
        lagged = self._exchange_every > 1
        done = 0
        while done < num_steps:
            if lagged:
                snaps = self._advance_lagged(step_size, record)
                done += self._exchange_every
            else:
                snaps = [self._particles] if record else None
                self._advance(step_size, h)
                done += 1
            if record:
                held += snaps
                if spill and len(held) == chunk:
                    host.append(torch.stack(held).cpu().numpy())
                    held = []
        if host and held:  # the last, partial chunk
            host.append(torch.stack(held).cpu().numpy())
        self.last_run_stats = self._stats(
            "eager", num_steps, num_steps // self._exchange_every, None,
            record_chunks_to_host=len(host))
        if not record:
            return self._particles
        if host:
            return self._particles, np.concatenate(host, axis=0)
        if not held:  # no step: an empty history
            return self._particles, self._particles.new_empty((0, *self._particles.shape))
        return self._particles, torch.stack(held)

    def _stats(self, execution, num_steps, num_dispatches, max_wall, **extra) -> dict:
        stats = {"execution": execution, "num_steps": num_steps,
                 "num_dispatches": num_dispatches,
                 "dispatches_per_step": round(num_dispatches / max(num_steps, 1), 4),
                 "max_dispatch_wall_s": max_wall, "w2_pairing": self._w2_pairing}
        stats.update(extra)
        return stats

    def _plan_dispatches(self, num_steps: int, budget: float, pairs_per_sec) -> dict:
        """The ``dispatch_budget`` planner, JAX's arithmetic: a step's work
        in pairwise interactions (φ, plus ``iters + 3`` Sinkhorn passes with
        the W2 term), over the pairs/s rate, and the coarsest execution
        whose largest dispatch fits the budget."""
        pps = float(pairs_per_sec if pairs_per_sec is not None else DISPATCH_PAIRS_PER_SEC)
        if pps <= 0:
            raise ValueError(f"pairs_per_sec must be positive, got {pps}")
        n = float(self._num_particles)
        S = self._num_shards
        exchanged = self._mode != PARTITIONS
        phi_pairs = n * n if exchanged else n * n / S
        w2_pass_pairs, w2_passes = 0.0, 0
        if self._include_wasserstein and self._wasserstein_solver == "sinkhorn":
            # S solves of (n/S, n/S) under the block pairing, (n/S, n) under
            # the global one; the 2 start passes and ~1 finish a solve
            w2_pass_pairs = n * n / S if self._block_w2 else n * n
            w2_passes = self._sinkhorn["sinkhorn_iters"] + 3
        t_step = (phi_pairs + w2_pass_pairs * w2_passes) / pps
        if num_steps * t_step <= budget:
            return {"execution": "monolithic"}
        if t_step <= budget:
            k = max(1, int(budget // t_step))
            if self._exchange_every > 1:  # whole macro-steps
                k = max(self._exchange_every, k - k % self._exchange_every)
            return {"execution": "scan_chunks", "steps_per_dispatch": min(k, num_steps)}
        if self._exchange_every > 1:
            raise ValueError(
                f"one lagged macro-step (~{t_step:.1f} s estimated at {pps:.2e} pairs/s) "
                f"exceeds dispatch_budget={budget} s, and the lagged exchange has no "
                "intra-step seam (one macro-step IS the gather-amortisation unit) — "
                "raise the budget or drop exchange_every")
        hpd = None
        if self._exchange_impl == "ring" and exchanged:
            hpd = max(1, min(S, int(budget * pps // max(phi_pairs / S, 1.0))))
        elif phi_pairs / pps > budget:
            raise ValueError(
                f"one step's φ pass alone ({phi_pairs:.2e} pairs ≈ {phi_pairs / pps:.1f} s "
                f"at {pps:.2e} pairs/s) exceeds dispatch_budget={budget} s, and only the "
                "ring exchange has an intra-step seam to split at — construct with "
                "exchange_impl='ring' (all_* modes), raise num_shards, or raise the "
                "budget")
        max_passes = None
        if w2_pass_pairs:
            # every resumed chunk pays the 2 start passes (the last the finish)
            max_passes = max(1, min(self._sinkhorn["sinkhorn_iters"],
                                    int(budget * pps // w2_pass_pairs) - 3))
        return {"execution": "intra_step", "hops_per_dispatch": hpd,
                "max_passes_per_dispatch": max_passes}

    def _dispatch_runner(self, time_dispatches: bool, span_name: str = "train.dispatch"):
        """``(run, rec)``: ``run(fn, *args)`` calls one dispatch and counts
        it in ``rec['count']``; with ``time_dispatches`` it fences the card
        after the call and keeps the longest wall in ``rec['max_wall']``.
        While the tracer is enabled each dispatch is a ``span_name`` span
        tagged with the dispatched function and ``fenced`` — whether the
        span waits for the card (``time_dispatches``); unfenced, it shows
        the host's time, and chained dispatches keep the card busy."""
        rec = {"count": 0, "max_wall": None}
        on_card = self._device.type == "cuda"

        def run(fn, *args):
            tags = None
            if _trace.enabled():
                tags = {"fn": getattr(fn, "__name__", type(fn).__name__),
                        "fenced": bool(time_dispatches)}
            with _trace.span(span_name, tags):
                t0 = time.perf_counter() if time_dispatches else None
                out = fn(*args)
                rec["count"] += 1
                if time_dispatches:
                    if on_card:
                        torch.cuda.synchronize(self._device)
                    wall = time.perf_counter() - t0
                    rec["max_wall"] = (wall if rec["max_wall"] is None
                                       else max(rec["max_wall"], wall))
            return out

        return run, rec

    def _run_steps_scan_chunks(self, num_steps, step_size, record, h, steps_per_dispatch,
                               time_dispatches, budget):
        """Chunks of ``steps_per_dispatch`` whole steps (the history chunk
        bounds them too with ``record=True``); the step counter and the
        minibatch stream carry across chunks, and the chunks' histories
        join without duplicates (each holds pre-update snapshots only)."""
        if record:
            steps_per_dispatch = min(steps_per_dispatch, self._record_chunk())
        run, rec = self._dispatch_runner(time_dispatches, "train.step_chunk")
        hists = []
        for k in _chunk_sizes(num_steps, steps_per_dispatch):
            out = run(self._run_eager, k, step_size, record, h)
            if record:
                hist = out[1]
                hists.append(hist.cpu().numpy() if isinstance(hist, torch.Tensor) else hist)
        self.last_run_stats = self._stats(
            "scan_chunks", num_steps, rec["count"], rec["max_wall"],
            steps_per_dispatch=steps_per_dispatch, dispatch_budget_s=budget)
        if record:
            return self._particles, np.concatenate(hists, axis=0)
        return self._particles

    def _chunked_w2_grad(self, blocks, max_passes, run):
        """The step's W2 gradient as a chain of bounded solve dispatches:
        ``ceil(iters / max_passes) − 1`` dual advances threading ``g``, then
        one that pays the gradient finish; the carried dual is updated."""
        from dist_svgd_torch.ops.ot import sinkhorn_dual_advance, wasserstein_grad_sinkhorn

        sk = self._sinkhorn
        prev_for = torch.roll(self._previous, -1, dims=0) if self._block_w2 else self._previous
        g = self._w2_g if self._w2_g is not None else blocks.new_zeros(self._g_shape())
        total = sk["sinkhorn_iters"]
        splits = _chunk_sizes(total, max_passes) if max_passes is not None else [total]
        cold0 = not sk["sinkhorn_warm_start"]  # the first chunk starts cold
        kw = dict(eps=sk["sinkhorn_eps"], tol=sk["sinkhorn_tol"], impl=self._sinkhorn_impl)
        for i, k in enumerate(splits[:-1]):
            g = run(lambda g_, k_=k, cold=cold0 and i == 0: sinkhorn_dual_advance(
                blocks, prev_for, iters=k_, g_init=None if cold else g_, **kw), g)
        grad, g = run(lambda g_: wasserstein_grad_sinkhorn(
            blocks, prev_for, iters=splits[-1], return_g=True,
            g_init=None if (cold0 and len(splits) == 1) else g_, **kw), g)
        self._w2_g = g
        return grad

    def _chunked_phi_step(self, run, blocks, w_grad, t, idx, step_size, h, hops_per_dispatch):
        """One ring step as a chain of hop-chunk dispatches and the finish
        (:func:`~dist_svgd_torch.parallel.exchange.make_chunked_ring_step_fns`)."""
        if self._chunk_builders is None:
            self._chunk_builders = make_chunked_ring_step_fns(
                self._logp, self._kernel, self._mode, self._num_shards, self._score_scale,
                **self._phi_kwargs(), **self._data_kwargs())
        b = self._chunk_builders
        data = self._data_stacked
        sizes = _chunk_sizes(self._num_shards, hops_per_dispatch)
        last = len(sizes) - 1
        acc = torch.zeros_like(blocks)
        if self._mode == ALL_SCORES:
            visiting, vscores = blocks, torch.zeros_like(blocks)
            for k in sizes:  # the score pass: every hop rotates
                visiting, vscores = run(b["score_hops"](k), visiting, vscores, data, t, idx)
            vscores = run(b["add_prior"], visiting, vscores)
            for i, k in enumerate(sizes):
                visiting, vscores, acc = run(b["exact_phi_hops"](k, i < last), blocks,
                                             visiting, vscores, acc)
        else:
            visiting = blocks
            for i, k in enumerate(sizes):
                visiting, acc = run(b["local_hops"](k, i < last), blocks, visiting, acc, data,
                                    t, idx)
        return run(b["finish"], blocks, acc, w_grad, step_size, h)

    def _run_steps_intra(self, num_steps, step_size, record, h, hops_per_dispatch, max_passes,
                         time_dispatches, budget):
        """Each step as a host-driven chain of dispatches — the split W2
        solve, the ring hop chunks (or the whole gather step), the finish —
        with the carried state threaded between them (JAX's
        ``_run_steps_intra``; the history goes to the host a step at a
        time)."""
        if self._exchange_every > 1:
            raise ValueError(
                "intra-step chunking is undefined for the lagged exchange "
                "(exchange_every > 1): one macro-step IS the amortisation unit — use "
                "dispatch_budget, which chunks at whole-cadence granularity")
        ring_hops = self._exchange_impl == "ring" and self._mode != PARTITIONS
        if hops_per_dispatch is not None and not ring_hops:
            raise ValueError(
                "hops_per_dispatch requires exchange_impl='ring' in an all_* mode: the "
                "gather step has no hop seam to split at, and the partitions step is "
                "already block-local")
        if max_passes is not None and not (self._include_wasserstein
                                           and self._wasserstein_solver == "sinkhorn"):
            raise ValueError(
                "max_passes_per_dispatch splits the per-step Sinkhorn solve and requires "
                "include_wasserstein=True with wasserstein_solver='sinkhorn' (the "
                "host-LP solve has no pass seam)")
        if ring_hops and isinstance(self._kernel, AdaptiveRBF):
            raise ValueError(
                "chunked ring stepping requires a fixed-bandwidth kernel: "
                "kernel='median_step' resolves per step from a gathered subsample the "
                "bounded-dispatch chain does not carry — use kernel='median' instead")
        run, rec = self._dispatch_runner(time_dispatches)
        history = [] if record else None
        for _ in range(num_steps):
            self._t += 1
            t = self._t
            idx = self._batch_indices(t)
            if record:
                history.append(self._particles.cpu().numpy())
            blocks = split(self._particles, self._num_shards)
            with torch.no_grad():
                w_grad = None
                if self._include_wasserstein and self._previous is not None:
                    w_grad = self._chunked_w2_grad(blocks, max_passes, run)
                if ring_hops:
                    new = self._chunked_phi_step(
                        run, blocks, w_grad, t, idx, step_size, h,
                        hops_per_dispatch if hops_per_dispatch is not None
                        else self._num_shards)
                else:
                    new = run(self._step, blocks, self._data_stacked, t, step_size, idx,
                              w_grad, h)
                if self._include_wasserstein:
                    self._previous = w2_snapshot(blocks, new, self._block_w2)
            self._particles = merge(new)
        self.last_run_stats = self._stats(
            "intra_step", num_steps, rec["count"], rec["max_wall"],
            hops_per_dispatch=hops_per_dispatch, max_passes_per_dispatch=max_passes,
            dispatch_budget_s=budget)
        if record:
            return self._particles, np.stack(history)
        return self._particles
