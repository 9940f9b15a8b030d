"""Carrying a JAX run's state across to the port.

For this system the "weights" are the particles plus the step counter ``t``,
and with the Wasserstein term on, the ``previous`` snapshot stack, the
carried Sinkhorn duals ``w2_g`` and the resolved ``w2_pairing``; the data goes
to both packages as the same numpy arrays.  A JAX
``DistSampler.state_dict()`` (as numpy: ``{k: np.asarray(v)}``) converts
with :func:`state_from_jax` into what the port's ``load_state_dict`` takes,
and the port continues the trajectory.  A Bayesian neural network's weights
are its particles: :func:`particles_from_jax` carries a JAX-trained
ensemble across, so that it predicts in the port what it predicts in JAX.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from dist_svgd_torch.utils import checkpoint as _ckpt

#: The kernel approximation's identity fields a JAX save carries across
#: (its threefry ``approx_bank_key`` stays behind).
APPROX_KEYS = ("approx_method", "approx_dial", "approx_active", "approx_rff_redraw",
               "approx_landmark_idx")


def state_from_jax(jax_state: Dict[str, Any], device, sampler=None) -> Dict[str, Any]:
    """Convert a JAX ``DistSampler.state_dict()`` to the port's layout.

    The particles, the W2 ``previous`` stack and the ``w2_g`` duals (where
    present) become tensors on ``device``; ``t``, the ``w2_pairing`` code and
    the topology manifest are kept as numpy.  JAX's minibatch-stream key
    ``rng_batch_key`` is dropped: threefry draws cannot be reproduced in
    torch.  In a minibatch-free run it has no counterpart at all; a
    minibatched JAX state converts all the same, and the port then goes on
    from step ``t`` on its own stream, seeded by the port sampler's
    ``seed`` (the state carries no ``rng_batch_seed``, so
    ``load_state_dict`` keeps the sampler's).  The manifest must describe
    the particle array it travels with; with ``sampler`` given, it is also
    checked against that port sampler's particle count and dimension
    (:class:`~dist_svgd_torch.utils.checkpoint.TopologyMismatch`).

    A kernel-approximation save keeps its identity (``approx_method``,
    ``approx_dial``, ``approx_active``, ``approx_rff_redraw``,
    ``approx_landmark_idx``), so ``load_state_dict`` refuses a mismatched
    sampler and adopts the saved crossover pin as JAX does; its RFF bank
    key ``approx_bank_key`` is dropped for the reason ``rng_batch_key`` is,
    and the port resumes on its own bank.

    Raises ``ValueError`` for one process's block of a multi-process save.
    """
    particles = np.asarray(jax_state["particles"])
    man = _ckpt.read_manifest(jax_state)
    if man is None:
        raise ValueError("JAX state has no readable topology manifest")
    if (any(int(np.asarray(jax_state.get(f"{k}_start", 0))) != 0
            for k in ("particles", "previous", "w2_g"))
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
    for key in ("previous", "w2_g"):
        if jax_state.get(key) is not None:
            state[key] = torch.tensor(np.asarray(jax_state[key]), device=device)
    if jax_state.get("w2_pairing") is not None:
        state["w2_pairing"] = np.asarray(jax_state["w2_pairing"], dtype=np.int8)
    state.update({k: np.asarray(jax_state[k]) for k in _ckpt.MANIFEST_KEYS
                  if k in jax_state})
    state.update({k: np.asarray(jax_state[k]) for k in APPROX_KEYS
                  if jax_state.get(k) is not None})
    return state


def particles_from_jax(particles, device, n_features: Optional[int] = None,
                       n_hidden: Optional[int] = None) -> torch.Tensor:
    """The JAX package's ``(n, d)`` particles (a numpy array, or anything
    ``np.asarray`` takes) as a tensor of the same dtype on ``device``.

    With ``n_features`` given, the particles are checked against the BNN's
    flat layout ``[vec(W1) | b1 | w2 | b2 | log γ | log λ]``:
    ``d == num_params(n_features, n_hidden)`` (``n_hidden`` defaults to 50,
    the model's default), else ``ValueError``."""
    arr = np.asarray(particles)
    if arr.ndim != 2 or not np.issubdtype(arr.dtype, np.floating):
        raise ValueError(f"particles must be a floating (n, d) array, got "
                         f"{arr.dtype} {arr.shape}")
    if n_features is not None:
        from dist_svgd_torch.models.bnn import num_params

        hidden = 50 if n_hidden is None else n_hidden
        want = num_params(n_features, hidden)
        if arr.shape[1] != want:
            raise ValueError(
                f"particles have d={arr.shape[1]}, but a BNN with {n_features} "
                f"features and {hidden} hidden units has d={want}")
    return torch.tensor(arr, device=device)
