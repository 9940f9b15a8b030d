"""Single-device SVGD sampler.

Counterpart of ``dist_svgd_tpu/sampler.py:Sampler`` — the reference's
public shape ``Sampler(d, logp, kernel).sample(n, num_iter, step_size)``,
returning a DataFrame with columns ``timestep / particle / value`` — run on
one card.  A step is the scores ``torch.func.vmap(torch.func.grad(logp))``
of all n particles (full data, or the step's minibatch scaled ``N / B``
with a separate unscaled prior), then φ through the φ-backend policy
(:func:`~dist_svgd_torch.ops.cuda_svgd.resolve_phi_fn`, one lane), then the
Jacobi update ``parts + ε·φ``.  ``update_rule='gauss_seidel'`` runs the
reference's literal sweep instead
(:func:`~dist_svgd_torch.ops.svgd.svgd_step_sequential`).

History follows the reference's timestep convention: a snapshot *before*
each update at timesteps ``0..num_iter-1`` plus the final state at
``num_iter``.

``run(dispatch_budget=...)`` splits a run into chunks of whole steps, each
estimated to fit the budget (JAX's ``Sampler.run``); each chunk is a
``train.step_chunk`` span while the telemetry tracer is enabled.

``kernel_approx`` runs the sub-quadratic φ (``ops/approx.py``): under
``phi_impl='auto'`` each run pins the (n, R) crossover once from its n, and
:meth:`Sampler.approx_residual` measures the approximation against the exact
φ into the ``svgd_diag_phi_approx_*`` gauges.

Each run's step is a tracked program (``analysis/registry.py``) under JAX's
label ``sampler.scan`` and its audit declarations (``gram_free`` from the
unresolved ``phi_impl``, ``expect_donation``): the body of JAX's scan,
``step(particles, step_size, seed, i0)``, called once a step (the card
spells the seed as JAX's key).  With ``donate_carries`` (the default) the
Jacobi step writes the update into the particles it was given — the run's
own carry, a copy of the caller's — as JAX donates the carry to XLA; the
Gauss–Seidel sweep allocates its result and declares no donation.
"""

from __future__ import annotations

import warnings
from typing import Callable, Optional

import numpy as np
import torch

from dist_svgd_torch.analysis.registry import default_registry
from dist_svgd_torch.distsampler import _chunk_sizes
from dist_svgd_torch.ops.approx import (
    approx_preferred,
    as_kernel_approx,
    bind_phi_step,
    is_gram_free,
)
from dist_svgd_torch.ops.cuda_svgd import resolve_phi_fn
from dist_svgd_torch.ops.kernels import RBF, AdaptiveRBF, median_bandwidth
from dist_svgd_torch.ops.svgd import svgd_step_sequential
from dist_svgd_torch.parallel.exchange import tree_map
from dist_svgd_torch.telemetry import trace as _trace
from dist_svgd_torch.utils import history as _history
from dist_svgd_torch.utils.history import history_to_dataframe
from dist_svgd_torch.utils.platform import resolve_device
from dist_svgd_torch.utils.rng import approx_bank_seed, init_particles, minibatch_indices


class Sampler:
    """Model-agnostic SVGD sampler on one device.

    Args:
        d: particle dimensionality.
        logp: scalar log-density ``logp(theta)`` in torch, ``theta`` of shape
            ``(d,)``; ``logp(theta, data_batch)`` when ``data`` is given.
        kernel: ``None`` (the reference's ``RBF(1)``), an :class:`RBF`,
            ``'median'`` (an RBF at the median-heuristic bandwidth of each
            run's initial particles), ``'median_step'`` / an
            :class:`AdaptiveRBF` (the bandwidth re-estimated from the current
            particles every step; Jacobi only) or any scalar kernel callable
            ``kernel(a, b)`` in torch (the plain φ's generic form).
        update_rule: ``'jacobi'`` or ``'gauss_seidel'``, the reference's
            in-place sweep (dsvgd/sampler.py:62-68) for small-n parity: row
            ``i`` moves against the particles as they stand, every row
            re-scoring all of them.  As in JAX, the sweep calls the plain
            :func:`~dist_svgd_torch.ops.svgd.phi` row by row, not the φ
            policy, so it launches no hand kernel on the card — the JAX
            program's design, not a fallback; ``phi_impl`` ``'cuda'`` /
            ``'cuda_bf16'``, ``batch_size``, ``'median_step'`` and
            ``kernel_approx`` are refused with it (``ValueError``).
        data: optional tensor / tuple / list / dict of arrays with a common
            leading row axis, passed to ``logp`` (full, or the step's
            minibatch).  Floating leaves are cast to the run's dtype.
        batch_size: per-step minibatch size B: each step scores B rows drawn
            without replacement, scaled ``N / B``.  Requires ``data``.
        log_prior: optional ``log_prior(theta)``; ``logp`` is then the
            likelihood alone, and only it takes the minibatch scale.
        phi_impl: the φ backend (``'auto'``, ``'torch'``, ``'cuda'``,
            ``'cuda_bf16'``, ``'torch_bf16'``) —
            :func:`~dist_svgd_torch.ops.cuda_svgd.resolve_phi_fn`.
        device: ``None`` → the card (raises without CUDA); ``'cpu'`` for the
            plain path.
        seed: the default ``seed`` of :meth:`run` and :meth:`sample`: it
            draws the initial particles and keys the minibatch stream, step
            ``t`` drawing from ``(seed, t)`` alone.
        kernel_approx: ``None`` (the exact φ), ``'rff'``, ``'nystrom'`` or a
            :class:`~dist_svgd_torch.ops.approx.KernelApprox` — the
            sub-quadratic φ with its ``num_features`` / ``num_landmarks``
            dial.  With ``phi_impl='auto'`` the (n, R) crossover picks exact
            or approximate once a :meth:`run`, from that run's n; ``'torch'``
            forces the approximation; the kernel tiers are refused.  The RFF
            bank is drawn from each run's ``seed``
            (:func:`~dist_svgd_torch.utils.rng.approx_bank_seed`) at the
            bandwidth frozen by then — ``kernel='median'`` resolves first;
            ``'median_step'`` + ``'rff'`` is refused unless
            ``KernelApprox('rff', rff_redraw='step')`` (a fresh bank every
            step).  Jacobi only.
        donate_carries: the Jacobi step writes each update into the
            run's particle carry (a copy of ``initial_particles``) in place
            of a new tensor, as JAX donates the carry to XLA; the recorded
            history copies each snapshot into its buffer before the step.
            Runs with it on and off are bitwise equal (``python -m
            dist_svgd_torch.tools.profile_step_floor --donate-ab`` pins
            that).
    """

    def __init__(
        self,
        d: int,
        logp: Callable,
        kernel=None,
        update_rule: str = "jacobi",
        data=None,
        batch_size: Optional[int] = None,
        log_prior: Optional[Callable] = None,
        phi_impl: str = "auto",
        kernel_approx=None,
        device=None,
        seed: int = 0,
        donate_carries: bool = True,
    ):
        if update_rule not in ("jacobi", "gauss_seidel"):
            raise ValueError(f"unknown update_rule {update_rule!r}")
        if batch_size is not None and data is None:
            raise ValueError("batch_size requires data")
        if batch_size is not None and update_rule != "jacobi":
            raise ValueError("minibatching supports only the jacobi update rule")
        if isinstance(kernel, str) and kernel not in ("median", "median_step"):
            raise ValueError(f"unknown kernel {kernel!r}")
        if update_rule != "jacobi":
            if (isinstance(kernel, str) and kernel == "median_step") or isinstance(
                    kernel, AdaptiveRBF):
                raise ValueError("kernel='median_step' requires update_rule='jacobi'")
            if phi_impl in ("cuda", "cuda_bf16"):
                # the sweep never calls the φ policy, so a forced kernel
                # would silently not run
                raise ValueError(f"phi_impl={phi_impl!r} requires update_rule='jacobi'")
            if kernel_approx is not None:
                raise ValueError(
                    "kernel_approx requires update_rule='jacobi': the Gauss-Seidel "
                    "sweep exists for literal reference parity, which an approximate "
                    "kernel cannot provide")
        if isinstance(seed, bool) or not isinstance(seed, (int, np.integer)):
            raise ValueError(f"seed must be an int, got {seed!r}")

        self._device = resolve_device(device)
        self._d = int(d)
        self._logp = logp
        self._log_prior = log_prior
        self._update_rule = update_rule
        self._phi_impl = phi_impl
        self._seed = int(seed)
        self._donate = bool(donate_carries)
        #: The most recent run's tracked step (``sampler.scan``).
        self._program = None
        self._median_kernel = isinstance(kernel, str) and kernel == "median"
        if self._median_kernel:
            kernel = RBF(1.0)  # placeholder until run() resolves the bandwidth
        elif isinstance(kernel, str):
            kernel = AdaptiveRBF()
        self._kernel = kernel if kernel is not None else RBF(1.0)
        self._approx = as_kernel_approx(kernel_approx)
        self._approx_active = False
        if self._approx is not None:
            # validate through the one policy seam (kernel tiers, AdaptiveRBF
            # + rff refusals); the real bank seed arrives with run()'s seed
            va = self._approx
            if va.method == "rff" and va.seed is None:
                va = va.with_seed(approx_bank_seed(0))
            resolve_phi_fn(self._kernel, phi_impl, kernel_approx=va)
        self._phi = self._resolve_phi()
        if phi_impl == "cuda" and self._device.type != "cuda":
            raise ValueError(
                "phi_impl='cuda' launches the hand kernel and needs the card; "
                "use phi_impl='auto' or 'torch' on the CPU")
        self._data = tree_map(lambda a: torch.as_tensor(a, device=self._device), data)
        rows = []
        tree_map(lambda a: rows.append(a.shape[0]), self._data)
        self._n_rows = rows[0] if rows else 0
        self._batch_size = None if batch_size is None else int(batch_size)
        if batch_size is not None and not 0 < batch_size <= self._n_rows:
            raise ValueError(f"batch_size {batch_size} not in (0, {self._n_rows}] rows")
        #: Private seam: ``fn(t) -> (B,)`` minibatch indices for step ``t``
        #: (0-based, absolute), used instead of the sampler's own stream when
        #: set (tests inject the JAX stream's indices through it).
        self._batch_index_seam = None
        #: Execution report of the most recent :meth:`run` call.
        self.last_run_stats = None

    # ------------------------------------------------------------------ #

    @property
    def kernel(self):
        """The kernel the next run steps with (``'median'`` resolves per run)."""
        return self._kernel

    @property
    def device(self) -> torch.device:
        return self._device

    @property
    def kernel_approx(self):
        """The resolved :class:`~dist_svgd_torch.ops.approx.KernelApprox`
        (RFF bank seed bound once a run has derived it), or ``None``."""
        return self._approx

    @property
    def kernel_approx_active(self) -> bool:
        """Whether the most recent :meth:`run`'s φ used the approximation
        (the per-run (n, R) crossover under ``phi_impl='auto'``; always with
        ``'torch'`` + ``kernel_approx``)."""
        return self._approx is not None and self._approx_active

    def _resolve_phi(self):
        """The φ backend of the current kernel and approximation state: the
        always-approximate ``'torch'`` combination while the approximation
        is pinned active, the exact configuration otherwise — one decision
        a run, like ``DistSampler``'s global-shape pin."""
        if self._approx is not None and self._approx_active:
            return resolve_phi_fn(self._kernel, "torch", kernel_approx=self._approx)
        return resolve_phi_fn(self._kernel, self._phi_impl)

    def _pin_approx(self, n: int, seed: int) -> None:
        """Per-run approximation resolution: bind the run's RFF bank seed
        and pin the (n, R) crossover, then rebuild φ if either changed.
        Nothing for exact samplers."""
        if self._approx is None:
            return
        changed = False
        if self._approx.method == "rff":
            bank = approx_bank_seed(seed)
            if self._approx.seed != bank:
                self._approx = self._approx.with_seed(bank)
                changed = True
        active = (approx_preferred(n, n, self._approx.feature_count)
                  if self._phi_impl == "auto" else True)
        if active != self._approx_active:
            self._approx_active = active
            changed = True
        if changed:
            self._phi = self._resolve_phi()

    def _set_kernel(self, kernel: RBF) -> None:
        self._kernel = kernel
        self._phi = self._resolve_phi()

    def set_data(self, data) -> None:
        """Swap the minibatch dataset in place (streaming ingest): minibatch
        mode only, and the replacement must have the same structure, leaf
        shapes and dtypes."""
        if self._batch_size is None:
            raise ValueError("set_data requires minibatch mode (batch_size)")
        new = tree_map(lambda a: torch.as_tensor(a, device=self._device), data)
        spec = []
        tree_map(lambda a: spec.append((tuple(a.shape), a.dtype)), self._data)
        new_spec = []
        tree_map(lambda a: new_spec.append((tuple(a.shape), a.dtype)), new)
        if (type(new) is not type(self._data)) or spec != new_spec:
            raise ValueError(
                f"set_data requires an identical data spec (shape/dtype); got "
                f"{new_spec} vs current {spec}")
        self._data = new

    def freeze_median_kernel(self, particles) -> float:
        """Resolve ``kernel='median'`` from ``particles`` now and keep that
        bandwidth for every later :meth:`run` (a segmented drive must not
        re-resolve it from each segment's start).  Returns the bandwidth; a
        fixed-bandwidth kernel returns its own; ``'median_step'`` raises."""
        if isinstance(self._kernel, AdaptiveRBF):
            raise ValueError(
                "kernel='median_step' re-resolves every step and needs no freezing")
        if self._median_kernel:
            parts = torch.as_tensor(particles, device=self._device)
            self._set_kernel(RBF(float(median_bandwidth(parts))))
            self._median_kernel = False
        return float(self._kernel.bandwidth)

    def pin_kernel_bandwidth(self, bandwidth: float) -> None:
        """Bind a fixed ``RBF(bandwidth)`` and drop any pending per-run
        ``'median'`` resolution (the restore path of
        :meth:`freeze_median_kernel`)."""
        self._median_kernel = False
        self._set_kernel(RBF(float(bandwidth)))

    def approx_residual(self, particles=None, max_points: int = 512,
                        seed: Optional[int] = None, registry=None) -> dict:
        """The configured approximation's φ residual — the exact against the
        approximate φ over a strided ≤ ``max_points`` subsample, scores from
        this sampler's own ``∇log p`` (full data) — published as
        ``svgd_diag_phi_approx_*`` gauges.  ``particles`` defaults to a
        fresh :func:`~dist_svgd_torch.utils.rng.init_particles` draw of
        ``max_points`` rows from ``seed`` (default: the constructor's), a
        pre-run probe; pass the current ensemble to probe a live run.  The
        probe binds its own bank seed and never re-pins the live run."""
        from dist_svgd_torch.ops.approx import phi_residual_report, record_phi_residual
        from dist_svgd_torch.ops.kernels import median_bandwidth_approx

        if self._approx is None:
            raise ValueError("approx_residual needs kernel_approx (exact runs have no "
                             "approximation residual to measure)")
        seed = self._seed if seed is None else int(seed)
        if particles is None:
            particles = init_particles(seed, max_points, self._d, device=self._device)
        particles = torch.as_tensor(particles, device=self._device)
        if particles.shape[0] > max_points:
            particles = particles[::-(-particles.shape[0] // max_points)]
        spec = self._approx
        if spec.method == "rff" and spec.seed is None:
            spec = spec.with_seed(approx_bank_seed(seed))
        data = tree_map(lambda a: a.to(particles.dtype) if a.is_floating_point() else a,
                        self._data)
        with torch.no_grad():
            scores = torch.func.vmap(torch.func.grad(self._full_logp(data)))(particles)
        if isinstance(self._kernel, RBF):
            kernel = self._kernel
        else:  # AdaptiveRBF: probe at the current per-step median bandwidth
            kernel = RBF(float(median_bandwidth_approx(particles)))
        report = phi_residual_report(particles, scores, kernel, spec, max_points=max_points)
        report["active"] = bool(self._approx_active)
        record_phi_residual(report, registry=registry)
        return report

    # ------------------------------------------------------------------ #

    def _batch_indices(self, seed: int, t: int) -> torch.Tensor:
        if self._batch_index_seam is not None:
            return torch.as_tensor(self._batch_index_seam(t), dtype=torch.int64,
                                   device=self._device)
        return minibatch_indices(seed, t, 1, self._n_rows, self._batch_size, self._device)[0]

    def _full_logp(self, data):
        """The full-data ``theta -> log p`` (prior included) on ``data``."""
        logp, log_prior = self._logp, self._log_prior
        if data is None:
            return logp if log_prior is None else (lambda th: logp(th) + log_prior(th))
        if log_prior is None:
            return lambda th: logp(th, data)
        return lambda th: logp(th, data) + log_prior(th)

    def _score_fns(self, dtype: torch.dtype):
        """``scores(parts, t, seed) -> (n, d)`` for the run's dtype."""
        data = tree_map(lambda a: a.to(dtype) if a.is_floating_point() else a, self._data)
        logp, log_prior = self._logp, self._log_prior
        prior = (torch.func.vmap(torch.func.grad(log_prior))
                 if log_prior is not None else None)
        if self._batch_size is not None:
            lik = torch.func.vmap(torch.func.grad(logp), in_dims=(0, None))
            scale = self._n_rows / self._batch_size

            def scores(parts, t, seed):
                idx = self._batch_indices(seed, t)
                s = scale * lik(parts, tree_map(lambda a: a[idx], data))
                return s if prior is None else s + prior(parts)

            return scores
        batched = torch.func.vmap(torch.func.grad(self._full_logp(data)))
        return lambda parts, t, seed: batched(parts)

    def run(
        self,
        n: int,
        num_iter: int,
        step_size: float,
        seed: Optional[int] = None,
        record: bool = True,
        initial_particles=None,
        dtype: Optional[torch.dtype] = None,
        dispatch_budget: Optional[float] = None,
        pairs_per_sec: Optional[float] = None,
        step_offset: int = 0,
    ):
        """Raw-tensor variant of :meth:`sample`.

        Returns ``(final_particles, history)``: ``history`` is the
        ``(num_iter + 1, n, d)`` stack of pre-update snapshots plus the
        final state, or ``None`` with ``record=False``.  A history that
        outgrows :func:`~dist_svgd_torch.utils.history.record_chunk_steps`
        snapshots is moved to the host chunk by chunk and returned as a
        numpy array; a shorter one stays a tensor on the device.

        ``seed`` (default: the constructor's) draws the initial particles
        when ``initial_particles`` is not given, and keys the minibatch
        stream; ``step_offset`` is the absolute index of this call's first
        step in a longer run (step ``step_offset + i`` draws from
        ``(seed, step_offset + i)``), so a segmented drive with a fixed seed
        draws the monolithic run's minibatches.  ``dtype`` defaults to that
        of ``initial_particles``, else float32.

        ``dispatch_budget`` (seconds) splits the run into chunks of
        ``budget // (n² / pairs_per_sec)`` whole steps (``pairs_per_sec``
        default :data:`~dist_svgd_torch.distsampler.DISPATCH_PAIRS_PER_SEC`),
        JAX's arithmetic; with ``record=True`` a chunk holds at most one
        history chunk.  Each chunk continues the step index, so the
        minibatch stream is the monolithic one, and the chunks' histories
        join without duplicate rows (returned on the host).  A single step
        over the budget warns and runs one step a chunk: one device has no
        seam inside a step.  :attr:`last_run_stats` reports ``'monolithic'``
        or ``'scan_chunks'`` with JAX's keys."""
        seed = self._seed if seed is None else int(seed)
        if initial_particles is not None:
            particles = torch.as_tensor(initial_particles, device=self._device)
            particles = particles.to(dtype or particles.dtype).clone()
        else:
            particles = init_particles(seed, n, self._d, dtype=dtype or torch.float32,
                                       device=self._device)
        if not particles.is_floating_point() or particles.dim() != 2:
            raise ValueError(f"particles must be a floating (n, d) array, got "
                             f"{particles.dtype} {tuple(particles.shape)}")
        if self._median_kernel:
            self._set_kernel(RBF(float(median_bandwidth(particles))))
        # the bandwidth is frozen by here; the RFF bank (if any) builds at it
        self._pin_approx(particles.shape[0], seed)
        step = self._track_step(self._step_fn(particles.dtype))
        chunk = _history.record_chunk_steps(*particles.shape, particles.element_size())
        spd = num_iter
        if dispatch_budget is not None:
            spd = self._steps_per_dispatch(particles.shape[0], num_iter, dispatch_budget,
                                           pairs_per_sec)
            if record:
                spd = min(spd, chunk)
        sizes = _chunk_sizes(num_iter, spd) if num_iter else []
        # every pre-update snapshot and the final state, a chunk at a time
        snaps = _history.SnapshotBuffer(num_iter + 1, chunk) if record else None
        parts = particles
        start = 0
        with torch.no_grad():
            for size in sizes:  # one dispatch a chunk
                # unfenced: the span shows the chunk's host time (JAX's tags)
                tags = None
                if _trace.enabled():
                    tags = {"steps": size, "fenced": False}
                    if len(sizes) == 1:
                        tags["execution"] = "monolithic"
                with _trace.span("train.step_chunk", tags):
                    for i in range(start, start + size):
                        if record:  # copied before the step, which may write over it
                            snaps.add(parts)
                        parts = step(parts, step_size, seed, step_offset + i)
                start += size
        to_host = len(snaps.host) if record else 0
        if dispatch_budget is None:
            self.last_run_stats = {"execution": "eager", "num_steps": num_iter,
                                   "num_dispatches": num_iter, "dispatches_per_step": 1.0,
                                   "steps_per_dispatch": 1,
                                   "record_chunks_to_host": to_host}
        else:
            chunked = spd < num_iter
            self.last_run_stats = {
                "execution": "scan_chunks" if chunked else "monolithic",
                "num_steps": num_iter, "num_dispatches": len(sizes),
                "dispatches_per_step": round(len(sizes) / max(num_iter, 1), 4),
                "steps_per_dispatch": spd, "record_chunks_to_host": to_host}
        if not record:
            return parts, None
        snaps.add(parts, spill=False)
        hist = snaps.held(parts)
        if snaps.host or (dispatch_budget is not None and spd < num_iter):
            hist = np.concatenate(snaps.host + [hist.cpu().numpy()], axis=0)
        return parts, hist

    def _step_fn(self, dtype: torch.dtype):
        """The run's step ``step(parts, step_size, seed, i0) -> parts``: one
        Jacobi update at the absolute step index ``i0`` of the minibatch
        stream ``seed``, written into ``parts`` under donation (or one
        Gauss–Seidel sweep)."""
        donate = self._donates
        if self._update_rule == "gauss_seidel":
            data = tree_map(lambda a: a.to(dtype) if a.is_floating_point() else a, self._data)
            score_fn = torch.func.grad(self._full_logp(data))
            kernel = self._kernel
            return lambda parts, step_size, seed, i0: svgd_step_sequential(
                parts, score_fn, step_size, kernel)
        scores = self._score_fns(dtype)
        phi_fn = self._phi

        def jacobi_step(parts, step_size, seed, i0):
            # a per-step RFF bank folds the step's absolute index, the one
            # the minibatch stream is keyed by (ops/approx.py:bind_phi_step)
            delta = step_size * bind_phi_step(phi_fn, i0)(
                parts[None], parts, scores(parts, i0, seed)[None])[0]
            return parts.add_(delta) if donate else parts + delta

        return jacobi_step

    def _track_step(self, fn):
        """Register a run's step as ``sampler.scan`` (JAX ``sampler.py``'s
        label and declarations) and keep it alive until the next run."""
        self._program = default_registry().track(
            fn, label="sampler.scan", donate_argnums=(0,) if self._donates else (),
            key_argnums=(2,),
            meta=dict(gram_free=is_gram_free(self._phi_impl, self.kernel_approx_active),
                      expect_donation=self._donates))
        return self._program

    @property
    def _donates(self) -> bool:
        """Whether a run's step writes into its carry (``donate_carries``
        and the Jacobi rule)."""
        return self._donate and self._update_rule == "jacobi"

    @staticmethod
    def _steps_per_dispatch(n: int, num_iter: int, budget: float, pairs_per_sec) -> int:
        """Whole steps a dispatch under ``budget`` seconds, from the n² pairs
        of a step at ``pairs_per_sec`` (JAX's arithmetic); warns when one
        step alone is over the budget."""
        if budget <= 0:
            raise ValueError(f"dispatch_budget must be positive, got {budget}")
        from dist_svgd_torch.distsampler import DISPATCH_PAIRS_PER_SEC

        pps = float(pairs_per_sec if pairs_per_sec is not None else DISPATCH_PAIRS_PER_SEC)
        t_step = float(n) * float(n) / pps
        if t_step > budget:
            warnings.warn(
                f"one {n}-particle step (~{t_step:.1f} s at {pps:.2e} pairs/s) exceeds "
                f"dispatch_budget={budget} s and the single-device step has no internal "
                "seam to split at; running one step per dispatch — shard over "
                "DistSampler's ring executor to chunk inside a step", stacklevel=3)
        return max(1, min(num_iter, int(budget // max(t_step, 1e-30))))

    def sample(self, n: int, num_iter: int, step_size: float, seed: Optional[int] = None,
               initial_particles=None):
        """Reference API: a pandas DataFrame with columns ``timestep``
        (0..num_iter), ``particle`` (0..n) and ``value`` (a numpy ``(d,)``
        vector)."""
        _, hist = self.run(n, num_iter, step_size, seed=seed, record=True,
                           initial_particles=initial_particles)
        if isinstance(hist, torch.Tensor):
            hist = hist.cpu().numpy()
        return history_to_dataframe(hist)
