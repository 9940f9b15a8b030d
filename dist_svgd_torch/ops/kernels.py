"""The RBF kernel for SVGD, on batched tensors.

Counterpart of ``dist_svgd_tpu/ops/kernels.py``: ``squared_distances`` (the
``x² + y² − 2·x·yᵀ`` form, clamped at 0), ``RBF``, the median-heuristic
``median_bandwidth`` that ``kernel='median'`` resolves once, and the
sort-free per-step estimate ``median_bandwidth_approx`` behind
``kernel='median_step'`` (:class:`AdaptiveRBF`) with its masked form for
the ring exchange (:func:`median_bandwidth_approx_masked`), the drivers' mapping
of ``--bandwidth`` onto these (:func:`resolve_bandwidth_kernel`), and
:func:`kernel_matrix` / :func:`kernel_grad_matrix` for any scalar kernel
callable.  Every RBF function accepts leading batch dimensions (the
emulated shard axis).
"""

from __future__ import annotations

import math
from typing import Callable, Optional

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


def median_bandwidth_approx(particles: torch.Tensor, max_points: int = 1024,
                            probes: int = 16) -> torch.Tensor:
    """Per-step estimate of the median bandwidth, sort-free: the median of
    the pairwise squared distances is bracketed by four counting passes of
    ``probes`` thresholds each (resolution ``max(d²)/probes⁴``), no sort
    and no host sync.  ``particles`` is ``(..., n, d)``; leading dimensions
    are independent sets, each with its own estimate.

    Returns ``max(med², 1e-12) / log(n + 1)`` with the shape of the leading
    dimensions; above ``max_points`` rows the median comes from an
    evenly-strided subsample, and ``log(n + 1)`` uses the full count.  It
    converges to the lower middle order statistic (no even-count
    interpolation, unlike :func:`median_bandwidth`)."""
    full_n = particles.shape[-2]
    if full_n > max_points:
        stride = -(-full_n // max_points)  # ceil: at most max_points rows
        particles = particles[..., ::stride, :]
    p = particles.shape[-2]
    sq = squared_distances(particles, particles)
    # rank of the off-diagonal median within the full p² count — the p
    # diagonal zeros always fall below any positive threshold, so they are
    # added to the target rank instead of being masked out
    target = p + (p * p - p + 1) // 2
    return _median_bracket(sq, target, probes) / math.log(full_n + 1.0)


def _median_bracket(sq: torch.Tensor, target: int, probes: int,
                    pair: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The four-pass counting bracket over the last two dims of ``sq``: each
    pass counts the entries at or below ``probes`` evenly spaced thresholds
    of the current bracket and keeps the first bucket whose count reaches
    ``target``; returns the final bracket's midpoint, floored at 1e-12.
    ``pair`` (a boolean matrix) restricts the counts and the initial width
    to the valid entries — one copy of the bracket for the plain and the
    masked estimator, so the ring's bandwidth cannot drift from the
    gather's."""
    ks = torch.arange(1, probes + 1, dtype=sq.dtype, device=sq.device)

    def refine(lo, width):
        t = lo[..., None] + width[..., None] * ks / probes           # (..., probes)
        hit = sq[..., None, :, :] <= t[..., None, None]
        if pair is not None:
            hit = hit & pair
        cnt = hit.sum(dim=(-2, -1))
        i = torch.argmax((cnt >= target).to(torch.int32), dim=-1)  # first bucket
        return lo + width * i.to(sq.dtype) / probes, width / probes

    w0 = torch.amax(sq if pair is None else torch.where(pair, sq, torch.zeros_like(sq)),
                    dim=(-2, -1))
    lo, w = refine(torch.zeros_like(w0), w0)
    for _ in range(3):
        lo, w = refine(lo, w)
    return torch.clamp(lo + 0.5 * w, min=1e-12)


def median_bandwidth_approx_masked(points: torch.Tensor, valid: torch.Tensor, n_valid: int,
                                   full_n: int, probes: int = 16) -> torch.Tensor:
    """:func:`median_bandwidth_approx` over the ``valid`` rows of an
    already-subsampled, padded point set ``(P, d)`` — the ring exchange's
    per-step bandwidth, where each shard contributes its ragged slice of
    the global strided subsample (JAX ``ops/kernels.py:
    median_bandwidth_approx_masked``).  ``n_valid`` is the subsample's true
    size and ``full_n`` the particle count of the ``log(n + 1)`` normaliser.
    Only valid × valid pairs are counted, against the same thresholds and
    target rank, so on the same point set it equals the unmasked estimate
    exactly (no sort, no host sync)."""
    sq = squared_distances(points, points)
    pair = valid[:, None] & valid[None, :]
    target = n_valid + (n_valid * n_valid - n_valid + 1) // 2
    return _median_bracket(sq, target, probes, pair) / math.log(full_n + 1.0)


class AdaptiveRBF:
    """Marker kernel: an RBF whose bandwidth is re-resolved **every step**
    from the current interaction set by :func:`median_bandwidth_approx`
    (``kernel='median_step'``).  The φ backends stay at bandwidth 1:
    ``resolve_phi_fn`` applies the exact rescaling identity
    ``φ_h(y; x, s) = φ₁(y/√h; x/√h, √h·s)/√h`` around them.  Jacobi
    update only."""

    def __init__(self, max_points: int = 1024):
        if max_points <= 0:
            raise ValueError(f"max_points must be positive, got {max_points}")
        self.max_points = int(max_points)

    def __repr__(self) -> str:
        return f"AdaptiveRBF(max_points={self.max_points})"


def resolve_bandwidth_kernel(bandwidth: str):
    """A driver's ``--bandwidth`` → the samplers' kernel argument:
    ``'median'`` (the heuristic, resolved from the initial particles),
    ``'median_step'`` (re-estimated from the current particles every step),
    a float → ``RBF(h)``, or the reference's 1.0 → ``None`` (RBF(1))."""
    if bandwidth in ("median", "median_step"):
        return bandwidth
    h = float(bandwidth)
    return None if h == 1.0 else RBF(h)


def kernel_matrix(kernel: Callable, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Gram matrix ``K[i, j] = k(x_i, y_j)`` ``(m, k)`` of the rows of ``x``
    ``(m, d)`` and ``y`` ``(k, d)`` for a scalar kernel callable
    ``kernel(a, b)`` written in torch, through ``torch.func.vmap``; a kernel
    with a ``matrix`` method (an :class:`RBF`) computes it itself."""
    if hasattr(kernel, "matrix"):
        return kernel.matrix(x, y)
    vmap = torch.func.vmap
    return vmap(lambda xi: vmap(lambda yj: kernel(xi, yj))(y))(x)


def kernel_grad_matrix(kernel: Callable, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``G[i, j] = ∇_{x_i} k(x_i, y_j)`` as an ``(m, k, d)`` tensor, by
    ``torch.func.grad`` of the scalar kernel callable (the reference's
    per-pair ``_dkernel``).  Only the generic φ builds it; the RBF φ never
    does."""
    vmap = torch.func.vmap
    dk = torch.func.grad(kernel, argnums=0)
    return vmap(lambda xi: vmap(lambda yj: dk(xi, yj))(y))(x)
