"""Two-layer Bayesian neural-network regression (weight-vector SVGD).

Counterpart of ``dist_svgd_tpu/models/bnn.py`` — BASELINE.json config 5,
"2-layer Bayesian NN regression (UCI), 500 particles, weight-vector SVGD":
the whole weight vector is one particle of dimension ``d``, so the model is
just another ``logp`` closure for the samplers.

Model (the SVGD BNN setup of Liu & Wang 2016, §5):

    hidden  h(x)   = relu(x W1 + b1)            (n_hidden units)
    output  ŷ(x)   = h(x) w2 + b2               (scalar regression)
    y | x, w, γ    ~ N(ŷ(x), 1/γ)
    w (all weights and biases) | λ ~ N(0, 1/λ)
    γ ~ Gamma(a0, b0),  λ ~ Gamma(a0, b0)       (a0 = 1, b0 = 0.1)

Particle layout — one flat ``(d,)`` vector per particle:

    theta = [vec(W1) | b1 | w2 | b2 | log γ | log λ]
    d = n_features·n_hidden + n_hidden + n_hidden + 1 + 2

The precisions are carried in log-space, and their prior density includes
the change-of-variables Jacobian ``+ log γ`` / ``+ log λ``.  Scores are
``torch.func.vmap(torch.func.grad(...))`` of these functions, formed by the
samplers.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple, Union

import torch

from dist_svgd_torch.utils.rng import _generator

_LOG_2PI = math.log(2.0 * math.pi)

#: Gamma hyperpriors on the likelihood precision γ and weight precision λ
#: (shape a0, rate b0) — the Liu & Wang 2016 BNN values.
A0 = 1.0
B0 = 0.1


class BNNParams(NamedTuple):
    """Unpacked view of one flat particle."""

    w1: torch.Tensor  # (n_features, n_hidden)
    b1: torch.Tensor  # (n_hidden,)
    w2: torch.Tensor  # (n_hidden,)
    b2: torch.Tensor  # ()
    log_gamma: torch.Tensor  # () — likelihood precision
    log_lambda: torch.Tensor  # () — weight-prior precision


def num_params(n_features: int, n_hidden: int = 50) -> int:
    """Flat particle dimensionality ``d``."""
    return n_features * n_hidden + n_hidden + n_hidden + 1 + 2


def unpack(theta: torch.Tensor, n_features: int, n_hidden: int = 50) -> BNNParams:
    """Split a flat ``(d,)`` particle into named network parameters."""
    k = n_features * n_hidden
    return BNNParams(
        theta[:k].reshape(n_features, n_hidden),
        theta[k:k + n_hidden],
        theta[k + n_hidden:k + 2 * n_hidden],
        theta[k + 2 * n_hidden],
        theta[-2],
        theta[-1],
    )


def predict(theta: torch.Tensor, x: torch.Tensor, n_features: int,
            n_hidden: int = 50) -> torch.Tensor:
    """Network output ``ŷ`` for one particle; ``x`` is ``(N, n_features)``,
    the result ``(N,)``."""
    p = unpack(theta, n_features, n_hidden)
    h = torch.relu(x @ p.w1 + p.b1)
    return h @ p.w2 + p.b2


def _log_gamma_prior(log_prec: torch.Tensor) -> torch.Tensor:
    """``log Gamma(prec; A0, B0) + log_prec`` — the density of the
    *log*-precision (change-of-variables Jacobian included)."""
    prec = torch.exp(log_prec)
    return A0 * math.log(B0) - math.lgamma(A0) + (A0 - 1.0) * log_prec - B0 * prec + log_prec


def _likelihood(theta, x, y, n_features, n_hidden):
    y = y.reshape(-1)
    log_gamma = theta[-2]
    pred = predict(theta, x, n_features, n_hidden)
    return (0.5 * y.shape[0] * (log_gamma - _LOG_2PI)
            - 0.5 * torch.exp(log_gamma) * torch.sum((pred - y) ** 2))


def _prior(theta):
    log_lambda = theta[-1]
    w = theta[:-2]
    lp = 0.5 * w.shape[0] * (log_lambda - _LOG_2PI) - 0.5 * torch.exp(log_lambda) * torch.dot(w, w)
    return lp + _log_gamma_prior(theta[-2]) + _log_gamma_prior(log_lambda)


def bnn_logp(theta: torch.Tensor, data: Tuple[torch.Tensor, torch.Tensor],
             n_features: int, n_hidden: int = 50) -> torch.Tensor:
    """Log joint density of one particle on a data slice ``(x, y)``:
    ``x`` ``(N, n_features)`` standardised features, ``y`` ``(N,)`` targets.
    The likelihood is a sum over rows, so the minibatch and data-sharding
    scales are unbiased for it."""
    x, y = data
    return _likelihood(theta, x, y, n_features, n_hidden) + _prior(theta)


def make_bnn_logp(n_features: int, n_hidden: int = 50):
    """``logp(theta, data)`` closure for the samplers' ``data=`` path."""

    def logp(theta, data):
        return bnn_logp(theta, data, n_features, n_hidden)

    return logp


def make_bnn_split(n_features: int, n_hidden: int = 50):
    """``(likelihood, prior)`` for the samplers' ``log_prior=`` path, so
    only the data term carries the minibatch scale;
    ``likelihood + prior == bnn_logp``."""

    def likelihood(theta, data):
        x, y = data
        return _likelihood(theta, x, y, n_features, n_hidden)

    return likelihood, _prior


def init_particles(seed: int, n: int, n_features: int, n_hidden: int = 50,
                   dtype: torch.dtype = torch.float32,
                   device: Optional[Union[str, torch.device]] = None) -> torch.Tensor:
    """Initial ``(n, d)`` particles: network weights ~ N(0, 1/(fan_in + 1))
    (the Liu & Wang init), log-precisions the log of a Gamma(A0, B0) draw
    (A0 = 1: an exponential of rate B0).

    Drawn on a CPU generator seeded with ``seed`` and then moved to
    ``device``; JAX's threefry draws cannot be reproduced, so the two
    packages agree in distribution only."""
    d = num_params(n_features, n_hidden)
    g = _generator(seed)
    theta = torch.randn(n, d, generator=g, dtype=torch.float64)
    k = n_features * n_hidden
    scale = torch.cat([
        torch.full((k + n_hidden,), 1.0 / math.sqrt(n_features + 1.0), dtype=torch.float64),
        torch.full((n_hidden + 1,), 1.0 / math.sqrt(n_hidden + 1.0), dtype=torch.float64),
        torch.zeros(2, dtype=torch.float64),
    ])
    theta = theta * scale
    # Gamma(A0, 1) at A0 = 1 is the unit exponential, which takes a generator
    theta[:, -2] = torch.log(torch.empty(n, dtype=torch.float64).exponential_(generator=g) / B0)
    theta[:, -1] = torch.log(torch.empty(n, dtype=torch.float64).exponential_(generator=g) / B0)
    out = theta.to(dtype)
    return out if device is None else out.to(device)


# --------------------------------------------------------------------- #
# Evaluation (ensemble posterior predictive)


def _predictions(particles, x_test, n_features, n_hidden):
    return torch.func.vmap(lambda t: predict(t, x_test, n_features, n_hidden))(particles)


def ensemble_rmse(particles: torch.Tensor, x_test: torch.Tensor, y_test: torch.Tensor,
                  n_features: int, n_hidden: int = 50, y_mean: float = 0.0,
                  y_std: float = 1.0) -> torch.Tensor:
    """RMSE of the posterior-predictive mean on the original target scale
    (``y_mean``/``y_std`` undo the driver's target standardisation)."""
    mean_pred = torch.mean(_predictions(particles, x_test, n_features, n_hidden), dim=0)
    mean_pred = mean_pred * y_std + y_mean
    truth = torch.as_tensor(y_test, dtype=mean_pred.dtype, device=mean_pred.device).reshape(-1)
    return torch.sqrt(torch.mean((mean_pred - truth) ** 2))


def ensemble_test_loglik(particles: torch.Tensor, x_test: torch.Tensor, y_test: torch.Tensor,
                         n_features: int, n_hidden: int = 50, y_mean: float = 0.0,
                         y_std: float = 1.0) -> torch.Tensor:
    """Average per-point predictive log-likelihood of the particle mixture,
    ``mean_i log (1/n) Σ_p N(y_i; ŷ_p(x_i), 1/γ_p)``, on the original
    scale."""
    pred = _predictions(particles, x_test, n_features, n_hidden) * y_std + y_mean
    truth = torch.as_tensor(y_test, dtype=pred.dtype, device=pred.device).reshape(-1)
    gamma = torch.exp(particles[:, -2:-1]) / (y_std ** 2)  # (n, 1), original scale
    lls = 0.5 * (torch.log(gamma) - _LOG_2PI) - 0.5 * gamma * (pred - truth) ** 2
    return torch.mean(torch.logsumexp(lls, dim=0) - math.log(particles.shape[0]))
