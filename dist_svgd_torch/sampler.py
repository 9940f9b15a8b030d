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

Not ported yet, each refused with ``NotImplementedError`` naming its ROADMAP
item: ``kernel_approx`` and ``approx_residual`` (A6), and
``dispatch_budget`` (A5).
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from dist_svgd_torch.ops.cuda_svgd import resolve_phi_fn
from dist_svgd_torch.ops.kernels import RBF, AdaptiveRBF, median_bandwidth
from dist_svgd_torch.ops.svgd import svgd_step_sequential
from dist_svgd_torch.parallel.exchange import tree_map
from dist_svgd_torch.utils import history as _history
from dist_svgd_torch.utils.history import history_to_dataframe
from dist_svgd_torch.utils.platform import resolve_device
from dist_svgd_torch.utils.rng import init_particles, minibatch_indices


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported to PyTorch yet (ROADMAP {item})")


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
        kernel_approx: ROADMAP A6 (must be ``None``).
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
        if kernel_approx is not None:
            raise _not_ported("kernel_approx", "A6")
        if isinstance(seed, bool) or not isinstance(seed, (int, np.integer)):
            raise ValueError(f"seed must be an int, got {seed!r}")

        self._device = resolve_device(device)
        self._d = int(d)
        self._logp = logp
        self._log_prior = log_prior
        self._update_rule = update_rule
        self._phi_impl = phi_impl
        self._seed = int(seed)
        self._median_kernel = isinstance(kernel, str) and kernel == "median"
        if self._median_kernel:
            kernel = RBF(1.0)  # placeholder until run() resolves the bandwidth
        elif isinstance(kernel, str):
            kernel = AdaptiveRBF()
        self._kernel = kernel if kernel is not None else RBF(1.0)
        self._phi = resolve_phi_fn(self._kernel, phi_impl)
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

    def _set_kernel(self, kernel: RBF) -> None:
        self._kernel = kernel
        self._phi = resolve_phi_fn(kernel, self._phi_impl)

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

    def approx_residual(self, *args, **kwargs):
        raise _not_ported("approx_residual (kernel_approx)", "A6")

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
        of ``initial_particles``, else float32.  ``dispatch_budget`` is
        ROADMAP A5."""
        if dispatch_budget is not None:
            raise _not_ported("dispatch_budget (chunked dispatches)", "A5")
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
        if self._update_rule == "gauss_seidel":
            data = tree_map(lambda a: a.to(particles.dtype) if a.is_floating_point() else a,
                            self._data)
            score_fn = torch.func.grad(self._full_logp(data))
            kernel = self._kernel
            move = lambda parts, i: svgd_step_sequential(  # noqa: E731
                parts, score_fn, step_size, kernel)
        else:
            scores = self._score_fns(particles.dtype)
            move = lambda parts, i: parts + step_size * self._phi(  # noqa: E731
                parts[None], parts, scores(parts, step_offset + i, seed)[None])[0]
        chunk = _history.record_chunk_steps(*particles.shape, particles.element_size())
        held, host = [], []
        parts = particles
        with torch.no_grad():
            for i in range(num_iter):
                if record:
                    held.append(parts)
                    if len(held) == chunk:
                        host.append(torch.stack(held).cpu().numpy())
                        held = []
                parts = move(parts, i)
        self.last_run_stats = {"execution": "eager", "num_steps": num_iter,
                               "num_dispatches": num_iter, "dispatches_per_step": 1.0,
                               "steps_per_dispatch": 1, "record_chunks_to_host": len(host)}
        if not record:
            return parts, None
        held.append(parts)
        hist = torch.stack(held)
        if host:
            hist = np.concatenate(host + [hist.cpu().numpy()], axis=0)
        return parts, hist

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
