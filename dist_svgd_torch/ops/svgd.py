"""The plain SVGD direction and step.

Counterpart of ``dist_svgd_tpu/ops/svgd.py:phi`` / ``svgd_step`` (reference
Algorithm 1):

    θ_i ← θ_i + ε · φ̂*(θ_i)
    φ̂*(y) = (1/m) Σ_j [ k(x_j, y) · ∇ log p(x_j) + ∇_{x_j} k(x_j, y) ]

For the RBF kernel the repulsive term takes the closed form
``Σ_j ∇_{x_j} k(x_j, y) = (2/h) (y·Σ_j K_j − Kᵀ x)``, so no ``(m, k, d)``
tensor is built.  This is ``phi_impl='torch'``: the same arithmetic as the
JAX ``phi`` (Gram from ``squared_distances``, two matmuls), batched over any
leading dimensions.  :func:`phi_chunked` and :func:`phi_blockwise` compute
the same φ with a bounded Gram block, for interaction sets whose whole Gram
would not fit in memory.  The hand CUDA kernels and their own plain versions
live in :mod:`dist_svgd_torch.ops.cuda_svgd`.
"""

from __future__ import annotations

from typing import Optional

import torch

from dist_svgd_torch.ops.kernels import RBF


def phi(
    updated: torch.Tensor,
    interacting: torch.Tensor,
    scores: torch.Tensor,
    kernel: Optional[RBF] = None,
) -> torch.Tensor:
    """Stein variational direction φ̂* for each row of ``updated``.

    Args:
        updated: ``(..., k, d)`` particles being moved.
        interacting: ``(..., m, d)`` interaction set.
        scores: ``(..., m, d)`` scores ``∇ log p`` of the interaction set.
        kernel: an :class:`RBF`; defaults to the reference's ``RBF(1)``.

    Leading dimensions broadcast (e.g. ``updated`` of shape ``(S, k, d)``
    against a shared ``(m, d)`` interaction set).  Returns ``(..., k, d)``.
    """
    if kernel is None:
        kernel = RBF(1.0)
    if not isinstance(kernel, RBF):
        raise NotImplementedError(
            "the port's phi supports the RBF kernel only; arbitrary kernel "
            "callables (kernel_matrix / kernel_grad_matrix) are ROADMAP A2"
        )
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
    kernel: Optional[RBF] = None,
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
    kernel: Optional[RBF] = None,
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
    kernel: Optional[RBF] = None,
) -> torch.Tensor:
    """One Jacobi SVGD step over the full particle set: every particle moves
    against the pre-update set and scores."""
    return particles + step_size * phi(particles, particles, scores, kernel)
