"""Sharded SVGD sampler on one card.

Counterpart of ``dist_svgd_tpu/distsampler.py:DistSampler``.  The global
``(n, d)`` particle array is split into S equal blocks, the shards; one
batched step moves every block (``parallel/exchange.py``), with the S shards
emulated on one device as a leading batch axis — as the JAX package
emulates them on one chip under ``vmap``.

Ported in this slice: the constructor with the JAX signature and defaults,
the drop-remainder policy (particles and data rows), the importance scale
``N_global / N_local``, the three exchange modes with the gather
implementation and the Jacobi update, ``make_step``, monolithic
``run_steps(record=False)``, and ``state_dict`` / ``load_state_dict`` for the
particles, the step counter and the topology manifest.  Every other option
raises ``NotImplementedError`` naming its ROADMAP item, so a call that runs
here means what it means in JAX.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from dist_svgd_torch.ops.kernels import RBF, median_bandwidth
from dist_svgd_torch.parallel.exchange import (
    ALL_PARTICLES,
    ALL_SCORES,
    PARTITIONS,
    make_shard_step,
    stack_shards,
    tree_map,
)
from dist_svgd_torch.parallel.mesh import merge, split
from dist_svgd_torch.utils import checkpoint as _ckpt
from dist_svgd_torch.utils.platform import resolve_device


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
        kernel: ``None`` (the reference's ``RBF(1)``), an :class:`RBF`, or
            ``'median'`` — an RBF at the median-heuristic bandwidth of the
            initial particles, resolved once here.
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
        include_wasserstein: must be ``False`` here (the W2/JKO term is
            ROADMAP A7); it defaults to ``True`` as in JAX, so a caller that
            does not opt out is refused rather than silently given another
            algorithm.
        phi_impl: ``'auto'`` (the hand CUDA kernel on the card, its plain
            version on the CPU), ``'torch'`` (the plain ``ops.svgd.phi``) or
            ``'cuda'`` (the kernel; refused on the CPU) — see
            :func:`dist_svgd_torch.ops.cuda_svgd.resolve_phi_fn`.
        device: ``None`` → the card (raises without CUDA); ``'cpu'`` for the
            plain path.
        wasserstein_solver, sinkhorn_*, w2_pairing, seed, donate_carries:
            accepted for signature parity and validated where JAX validates
            them; they have no effect with the W2 term off and no minibatch
            stream.  Every other option outside the slice raises
            ``NotImplementedError``.
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
        if include_wasserstein:
            raise _not_ported(
                "the Wasserstein/JKO term (include_wasserstein=True, the JAX "
                "default; pass include_wasserstein=False)", "A7")
        if update_rule == "gauss_seidel":
            raise _not_ported("update_rule='gauss_seidel'", "A10")
        if exchange_impl == "ring":
            raise _not_ported("exchange_impl='ring'", "A10")
        if exchange_every > 1:
            raise _not_ported("exchange_every > 1 (the lagged exchange)", "A10")
        if shard_data:
            raise _not_ported("shard_data=True", "A6")
        if batch_size is not None:
            raise _not_ported("batch_size (per-shard minibatches)", "A6")
        if log_prior is not None:
            raise _not_ported("log_prior (a separate prior)", "A6")
        if kernel_approx is not None:
            raise _not_ported("kernel_approx", "A11")
        if isinstance(kernel, str) and kernel == "median_step":
            raise _not_ported("kernel='median_step'", "A2")
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

        particles = torch.as_tensor(particles, device=self._device)
        if not particles.is_floating_point() or particles.dim() != 2:
            raise ValueError(
                f"particles must be a floating (n, d) array, got "
                f"{particles.dtype} {tuple(particles.shape)}")
        if isinstance(kernel, str) and kernel == "median":
            kernel = RBF(float(median_bandwidth(particles)))
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
        )
        self._t = 0  # step counter (drives the partitions rotation)

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
    def device(self) -> torch.device:
        return self._device

    # ------------------------------------------------------------------ #
    # Checkpoint / resume

    def state_dict(self) -> dict:
        """Resume state: particles, the step counter and the topology
        manifest, in the JAX ``state_dict``'s keys and numpy encoding."""
        state = {
            "particles": self._particles.detach().cpu().numpy(),
            "particles_start": np.asarray(0, dtype=np.int64),
            "t": np.asarray(self._t, dtype=np.int64),
        }
        state.update(_ckpt.topology_manifest(
            self._num_shards, self._num_particles, self._d, self._rows_per_shard))
        return state

    def load_state_dict(self, state: dict) -> None:
        """Restore :meth:`state_dict` state (or a JAX save converted by
        :func:`dist_svgd_torch.utils.interop.state_from_jax`).  The manifest
        is checked first: a particle-count or dimension mismatch raises
        :class:`~dist_svgd_torch.utils.checkpoint.TopologyMismatch`.  A save
        at another shard count restores as is (the particle array is
        global, and the W2 snapshots that would need resharding are not
        part of this slice)."""
        _ckpt.check_topology(
            state, {"n_particles": self._num_particles, "d": self._d})
        if state.get("previous") is not None or state.get("w2_g") is not None:
            raise _not_ported("restoring Wasserstein snapshots / Sinkhorn duals", "A7")
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
        self._particles = particles.to(device=self._device,
                                       dtype=self._particles.dtype).clone()
        self._t = int(np.asarray(state["t"]))

    # ------------------------------------------------------------------ #
    # Stepping

    def _advance(self, step_size: float) -> None:
        self._t += 1
        blocks = split(self._particles, self._num_shards)
        with torch.no_grad():
            blocks = self._step(blocks, self._data_stacked, self._t, step_size)
        self._particles = merge(blocks)

    def make_step(self, step_size: float, h: float = 1.0) -> torch.Tensor:
        """Perform one distributed SVGD step; returns the global particles.
        ``h`` weights the W2 term, which is off in this slice."""
        self._advance(step_size)
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
        final particles.  ``record=True`` (history) and the chunking knobs
        (``dispatch_budget`` / ``hops_per_dispatch`` /
        ``max_passes_per_dispatch``) are not ported; ``pairs_per_sec`` and
        ``time_dispatches`` only act together with them in JAX."""
        if record:
            raise _not_ported("run_steps(record=True) (history recording)", "A8")
        if (dispatch_budget is not None or hops_per_dispatch is not None
                or max_passes_per_dispatch is not None):
            raise _not_ported("chunked run_steps (dispatch_budget / hops / passes)", "A10")
        for _ in range(num_steps):
            self._advance(step_size)
        return self._particles
