"""The RBF kernel for SVGD, on batched tensors.

Counterpart of ``dist_svgd_tpu/ops/kernels.py``: ``squared_distances`` (the
``x² + y² − 2·x·yᵀ`` form, clamped at 0), ``RBF`` and the median-heuristic
``median_bandwidth`` that ``kernel='median'`` resolves once at construction.
Every function accepts leading batch dimensions (the emulated shard axis).
"""

from __future__ import annotations

import math

import torch


def squared_distances(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Pairwise squared Euclidean distances ``(..., m, k)`` between the rows
    of ``x`` ``(..., m, d)`` and ``y`` ``(..., k, d)``, clamped at zero (the
    broadcasted form can go slightly negative in floating point)."""
    x2 = torch.sum(x * x, dim=-1)[..., :, None]
    y2 = torch.sum(y * y, dim=-1)[..., None, :]
    sq = x2 + y2 - 2.0 * torch.matmul(x, y.transpose(-1, -2))
    return torch.clamp(sq, min=0.0)


class RBF:
    """Gaussian RBF kernel ``k(x, y) = exp(-||x - y||^2 / bandwidth)``;
    ``bandwidth=1`` is the reference kernel."""

    def __init__(self, bandwidth: float = 1.0):
        if bandwidth <= 0:
            raise ValueError(f"bandwidth must be positive, got {bandwidth}")
        self.bandwidth = float(bandwidth)

    def matrix(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """Gram matrix ``K[..., i, j] = k(x_i, y_j)``."""
        return torch.exp(-squared_distances(x, y) / self.bandwidth)

    def __repr__(self) -> str:
        return f"RBF(bandwidth={self.bandwidth})"


#: Above this many particles, :func:`median_bandwidth` computes the median
#: over an evenly-strided subsample of at most this many rows.
MEDIAN_BANDWIDTH_MAX_POINTS = 4096


def median_bandwidth(particles: torch.Tensor,
                     max_points: int = MEDIAN_BANDWIDTH_MAX_POINTS) -> torch.Tensor:
    """Median heuristic ``h = med² / log(n + 1)`` (Liu & Wang 2016, eq. 13)
    over the off-diagonal pairwise squared distances; ``log(n + 1)`` uses the
    full particle count even when the median comes from the subsample.
    Returns a 0-dim tensor."""
    full_n = particles.shape[0]
    if full_n > max_points:
        stride = -(-full_n // max_points)  # ceil: at most max_points rows
        particles = particles[::stride]
    n = particles.shape[0]
    sq = squared_distances(particles, particles)
    eye = torch.eye(n, dtype=torch.bool, device=particles.device)
    sq = torch.where(eye, torch.full_like(sq, math.inf), sq)
    flat = torch.sort(sq.reshape(-1)).values
    m = n * n - n  # count of finite (off-diagonal) entries
    med_sq = 0.5 * (flat[(m - 1) // 2] + flat[m // 2])
    return med_sq / math.log(full_n + 1.0)
