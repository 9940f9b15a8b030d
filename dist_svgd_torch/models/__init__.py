"""Model log-densities in torch: Bayesian logistic regression, the
two-layer Bayesian neural network (``models.bnn``) and the 1-D Gaussian
mixture (``models.gmm``)."""

from dist_svgd_torch.models.logreg import (
    ensemble_test_accuracy,
    logreg_likelihood,
    logreg_logp,
    logreg_prior,
    make_logreg_logp,
    make_logreg_split,
    posterior_predictive_prob,
)

__all__ = [
    "ensemble_test_accuracy",
    "logreg_likelihood",
    "logreg_logp",
    "logreg_prior",
    "make_logreg_logp",
    "make_logreg_split",
    "posterior_predictive_prob",
]
