"""The plain SVGD direction and step.

Counterpart of ``dist_svgd_tpu/ops/svgd.py:phi`` / ``svgd_step`` (reference
Algorithm 1):

    θ_i ← θ_i + ε · φ̂*(θ_i)
    φ̂*(y) = (1/m) Σ_j [ k(x_j, y) · ∇ log p(x_j) + ∇_{x_j} k(x_j, y) ]

For the RBF kernel the repulsive term takes the closed form
``Σ_j ∇_{x_j} k(x_j, y) = (2/h) (y·Σ_j K_j − Kᵀ x)``, so no ``(m, k, d)``
tensor is built.  This is ``phi_impl='torch'``: the same arithmetic as the
JAX ``phi`` (Gram from ``squared_distances``, two matmuls), batched over any
leading dimensions.  Any other scalar kernel callable takes the generic
form ``(Kᵀ s + Σ_j ∇_{x_j} k(x_j, y)) / m`` through
:func:`~dist_svgd_torch.ops.kernels.kernel_matrix` and
:func:`~dist_svgd_torch.ops.kernels.kernel_grad_matrix`, as JAX's ``phi``
does.  :func:`phi_chunked` and :func:`phi_blockwise` compute the same φ
with a bounded Gram block, for interaction sets whose whole Gram would not
fit in memory.  :func:`svgd_step_sequential` is the reference's literal
Gauss–Seidel sweep.  The hand CUDA kernels and their own plain versions
live in :mod:`dist_svgd_torch.ops.cuda_svgd`.
"""

from __future__ import annotations

from typing import Callable

import torch

from dist_svgd_torch.ops.kernels import RBF, kernel_grad_matrix, kernel_matrix


def _phi_generic(updated: torch.Tensor, interacting: torch.Tensor, scores: torch.Tensor,
                 kernel: Callable) -> torch.Tensor:
    """φ of one lane, ``(k, d)`` against ``(m, d)``, for a scalar kernel
    callable (JAX ``phi``'s generic branch)."""
    K = kernel_matrix(kernel, interacting, updated)  # (m, k)
    gK = kernel_grad_matrix(kernel, interacting, updated)  # (m, k, d)
    return (torch.matmul(K.T, scores) + torch.sum(gK, dim=0)) / interacting.shape[0]


def phi(
    updated: torch.Tensor,
    interacting: torch.Tensor,
    scores: torch.Tensor,
    kernel=None,
) -> torch.Tensor:
    """Stein variational direction φ̂* for each row of ``updated``.

    Args:
        updated: ``(..., k, d)`` particles being moved.
        interacting: ``(..., m, d)`` interaction set.
        scores: ``(..., m, d)`` scores ``∇ log p`` of the interaction set.
        kernel: an :class:`RBF` (the closed form) or any scalar kernel
            callable ``kernel(a, b)`` in torch (the generic form, one lane
            at a time); defaults to the reference's ``RBF(1)``.

    Leading dimensions broadcast (e.g. ``updated`` of shape ``(S, k, d)``
    against a shared ``(m, d)`` interaction set).  Returns ``(..., k, d)``.
    """
    if kernel is None:
        kernel = RBF(1.0)
    if not isinstance(kernel, RBF):
        lead = torch.broadcast_shapes(updated.shape[:-2], interacting.shape[:-2],
                                      scores.shape[:-2])
        if not lead:
            return _phi_generic(updated, interacting, scores, kernel)
        lanes = [t.expand(*lead, *t.shape[-2:]).reshape(-1, *t.shape[-2:])
                 for t in (updated, interacting, scores)]
        out = torch.stack([_phi_generic(y, x, s, kernel) for y, x, s in zip(*lanes)])
        return out.reshape(*lead, *updated.shape[-2:])
    m = interacting.shape[-2]
    K = kernel.matrix(interacting, updated)  # (..., m, k)
    Kt = K.transpose(-1, -2)
    drive = torch.matmul(Kt, scores)  # Σ_j k(x_j, y_i) s_j
    ksum = torch.sum(K, dim=-2)  # (..., k)
    repulse = (2.0 / kernel.bandwidth) * (
        updated * ksum[..., None] - torch.matmul(Kt, interacting)
    )
    return (drive + repulse) / m


def phi_chunked(
    updated: torch.Tensor,
    interacting: torch.Tensor,
    scores: torch.Tensor,
    kernel=None,
    chunk_size: int = 1024,
) -> torch.Tensor:
    """:func:`phi` accumulated over chunks of ``chunk_size`` interaction rows,
    so that no Gram block is larger than ``(..., chunk_size, k)``.

    Counterpart of JAX's ``phi_chunked``: chunk ``c`` contributes
    ``(len(c)/m)·phi(y, x_c, s_c)`` (``phi`` averages over its own chunk),
    summed in order, the ragged tail last.  Leading dimensions broadcast
    as in :func:`phi`."""
    m = interacting.shape[-2]
    acc = None
    for j in range(0, m, chunk_size):
        n = min(chunk_size, m - j)
        part = (n / m) * phi(updated, interacting[..., j:j + n, :],
                             scores[..., j:j + n, :], kernel)
        acc = part if acc is None else acc + part
    return acc


def phi_blockwise(
    updated: torch.Tensor,
    interacting: torch.Tensor,
    scores: torch.Tensor,
    kernel=None,
    chunk_k: int = 4096,
    chunk_m: int = 1024,
) -> torch.Tensor:
    """:func:`phi` over chunks of both axes: :func:`phi_chunked` on each
    block of ``chunk_k`` updated rows, so that the peak Gram block is
    ``(..., chunk_m, chunk_k)`` at any k and m (JAX's ``phi_blockwise``, a
    Python loop in place of ``lax.map``)."""
    k = updated.shape[-2]
    parts = [phi_chunked(updated[..., i:i + chunk_k, :], interacting, scores, kernel,
                         chunk_m)
             for i in range(0, k, chunk_k)]
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=-2)


def svgd_step(
    particles: torch.Tensor,
    scores: torch.Tensor,
    step_size: float,
    kernel=None,
) -> torch.Tensor:
    """One Jacobi SVGD step over the full particle set: every particle moves
    against the pre-update set and scores."""
    return particles + step_size * phi(particles, particles, scores, kernel)


def svgd_step_sequential(
    particles: torch.Tensor,
    score_fn: Callable[[torch.Tensor], torch.Tensor],
    step_size: float,
    kernel=None,
) -> torch.Tensor:
    """Gauss–Seidel SVGD sweep with the reference's in-place semantics (JAX
    ``svgd_step_sequential``, reference dsvgd/sampler.py:62-68).

    Particle ``i`` moves against the array as it stands, rows ``< i``
    already moved, and every row re-evaluates the scores of all particles
    at their current values: ``score_fn(theta (d,)) -> (d,)`` is the
    per-particle score, batched here with ``torch.func.vmap``.  O(n²)
    score evaluations a sweep — for small-n parity with the reference; the
    Jacobi step is the fast mode.  φ is the plain :func:`phi` of a
    ``(1, d)`` row, any kernel.  Returns a new ``(n, d)`` tensor."""
    if kernel is None:
        kernel = RBF(1.0)
    batched_score = torch.func.vmap(score_fn)
    parts = particles.clone()
    for i in range(parts.shape[0]):
        scores = batched_score(parts)
        y = parts[i:i + 1]
        parts[i] = (y + step_size * phi(y, parts, scores, kernel))[0]
    return parts
