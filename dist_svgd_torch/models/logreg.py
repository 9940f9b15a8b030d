"""Bayesian logistic regression — the reference's flagship model.

Counterpart of ``dist_svgd_tpu/models/logreg.py``.  Particle layout:
``theta = (log α, w)`` with ``d = 1 + n_features``; priors ``α ~ Gamma(1, 1)``
(evaluated at α, no log-α Jacobian — the reference's parameterisation) and
``w | α ~ N(0, I/α)``; likelihood ``-Σ_i log(1 + exp(-t_i · x_i·w))`` on the
(local) data slice, computed as ``logaddexp(0, -z)``.

Scores are ``torch.func.vmap(torch.func.grad(logreg_logp))``, formed by
the step builder (``parallel/exchange.py``).
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

_LOG_2PI = math.log(2.0 * math.pi)


def logreg_logp(theta: torch.Tensor, data: Tuple[torch.Tensor, torch.Tensor]) -> torch.Tensor:
    """Log joint density for one particle on a data slice.

    Args:
        theta: ``(1 + k,)`` particle — ``theta[0] = log α``, ``theta[1:] = w``.
        data: ``(x, t)`` with ``x`` of shape ``(N, k)`` and labels ``t`` of
            shape ``(N,)`` or ``(N, 1)`` in ``{-1, +1}``.
    """
    x, t = data
    t = t.reshape(-1)
    alpha = torch.exp(theta[0])
    w = theta[1:]
    k = w.shape[0]
    lp = -alpha  # Gamma(1,1) prior on α
    lp = lp + 0.5 * k * theta[0] - 0.5 * k * _LOG_2PI - 0.5 * alpha * torch.dot(w, w)
    z = torch.matmul(x, w) * t
    return lp - torch.sum(torch.logaddexp(torch.zeros((), dtype=z.dtype, device=z.device), -z))


def make_logreg_logp(x_train: torch.Tensor, t_train: torch.Tensor):
    """Closure over a fixed dataset (the reference's ``lambda x: logp(rank,
    x)``)."""
    t_train = t_train.reshape(-1)

    def logp(theta, data=None):
        if data is None:
            data = (x_train, t_train)
        return logreg_logp(theta, data)

    return logp


def logreg_likelihood(theta: torch.Tensor, data: Tuple[torch.Tensor, torch.Tensor]) -> torch.Tensor:
    """Likelihood term only: ``-Σ_i log(1 + exp(-t_i·x_i·w))``."""
    x, t = data
    z = torch.matmul(x, theta[1:]) * t.reshape(-1)
    return -torch.sum(torch.logaddexp(torch.zeros((), dtype=z.dtype, device=z.device), -z))


def logreg_prior(theta: torch.Tensor) -> torch.Tensor:
    """Prior terms only: ``Gamma(1,1)`` on ``α = exp(θ₀)`` and ``N(0, I/α)``
    on ``w``."""
    alpha = torch.exp(theta[0])
    w = theta[1:]
    k = w.shape[0]
    return -alpha + 0.5 * k * theta[0] - 0.5 * k * _LOG_2PI - 0.5 * alpha * torch.dot(w, w)


def posterior_predictive_prob(particles: torch.Tensor, x_test: torch.Tensor) -> torch.Tensor:
    """Per-particle predictive probabilities ``σ(x_test · w)``, shape
    ``(n_particles, n_test)``.  As in the reference, the α component is
    decoded but unused — prediction uses ``w = theta[1:]`` only."""
    w = particles[:, 1:]
    return torch.sigmoid(torch.matmul(x_test, w.T)).T


def ensemble_test_accuracy(particles: torch.Tensor, x_test: torch.Tensor,
                           t_test: torch.Tensor) -> torch.Tensor:
    """Posterior-predictive-mean test accuracy: average σ(x·w) over
    particles, threshold at 0.5, compare against ``t > 0``."""
    probs = torch.mean(posterior_predictive_prob(particles, x_test), dim=0)
    pred = probs > 0.5
    truth = t_test.reshape(-1) > 0
    return torch.mean((pred == truth).to(probs.dtype))
