"""Carrying a JAX run's state across to the port.

For this system the "weights" are the particles plus the step counter ``t``;
the data goes to both packages as the same numpy arrays.  A JAX
``DistSampler.state_dict()`` (as numpy: ``{k: np.asarray(v)}``) converts
with :func:`state_from_jax` into what the port's ``load_state_dict`` takes,
and the port continues the trajectory.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from dist_svgd_torch.utils import checkpoint as _ckpt


def state_from_jax(jax_state: Dict[str, Any], device, sampler=None) -> Dict[str, Any]:
    """Convert a JAX ``DistSampler.state_dict()`` to the port's layout.

    The particles become a tensor on ``device``; ``t`` and the topology
    manifest are kept as numpy.  The entries with no counterpart in a
    W2-free, minibatch-free run are dropped: the inert resolved
    ``w2_pairing`` and the minibatch stream's ``rng_batch_key``.  The manifest must describe the particle
    array it travels with; with ``sampler`` given, it is also checked
    against that port sampler's particle count and dimension
    (:class:`~dist_svgd_torch.utils.checkpoint.TopologyMismatch`).

    Raises ``NotImplementedError`` for state this slice does not carry (W2
    snapshots, Sinkhorn duals) and ``ValueError`` for a kernel-approximation
    save or one process's block of a multi-process save.
    """
    if jax_state.get("previous") is not None or jax_state.get("w2_g") is not None:
        raise NotImplementedError(
            "JAX state carries Wasserstein snapshots / Sinkhorn duals: the W2 "
            "term is not ported yet (ROADMAP A7)")
    if jax_state.get("approx_method") is not None:
        raise ValueError("JAX state was written with a kernel_approx; the port runs "
                         "the exact kernel only")
    particles = np.asarray(jax_state["particles"])
    man = _ckpt.read_manifest(jax_state)
    if man is None:
        raise ValueError("JAX state has no readable topology manifest")
    if (int(np.asarray(jax_state.get("particles_start", 0))) != 0
            or particles.shape != (man["n_particles"], man["d"])):
        raise ValueError(
            f"JAX particles {particles.shape} do not match the manifest's "
            f"({man['n_particles']}, {man['d']}) — one process's block of a "
            "multi-process save; assemble the full state first")
    if sampler is not None:
        _ckpt.check_topology(
            jax_state, {"n_particles": sampler.num_particles,
                        "d": sampler.particles.shape[1]}, context="JAX state")
    state = {
        "particles": torch.tensor(particles, device=device),
        "particles_start": np.asarray(0, dtype=np.int64),
        "t": np.asarray(jax_state["t"], dtype=np.int64),
    }
    state.update({k: np.asarray(jax_state[k]) for k in _ckpt.MANIFEST_KEYS
                  if k in jax_state})
    return state
