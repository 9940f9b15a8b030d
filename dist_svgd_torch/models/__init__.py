"""Model log-densities in torch."""

from dist_svgd_torch.models.logreg import (
    ensemble_test_accuracy,
    logreg_likelihood,
    logreg_logp,
    logreg_prior,
    make_logreg_logp,
    posterior_predictive_prob,
)

__all__ = [
    "ensemble_test_accuracy",
    "logreg_likelihood",
    "logreg_logp",
    "logreg_prior",
    "make_logreg_logp",
    "posterior_predictive_prob",
]
