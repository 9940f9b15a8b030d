"""dist_svgd_torch — the PyTorch/CUDA port of dist_svgd_tpu.

A second package beside the JAX one, grown slice by slice (ROADMAP.md).  It
imports torch and never JAX or ``dist_svgd_tpu``; the JAX package is the
reference its tests hold it against.  Its entry points run on the card
(``device=None`` → CUDA, raising without it) unless the caller asks for the
CPU.

- ``Sampler``     — single-device SVGD (Jacobi; full data or minibatches;
  the fixed, per-run and per-step median bandwidths);
- ``DistSampler`` — sharded SVGD, the S shards emulated on one card, the
  three exchange modes (gather implementation, Jacobi update), with the
  Wasserstein/JKO term (host LP or Sinkhorn);
- ``ops``         — the RBF kernel, the plain φ, the sub-quadratic φ
                    (random features, Nyström), the W2 solvers, and the
                    hand-written CUDA φ and Sinkhorn kernels (``csrc/``)
                    with their plain versions;
- ``models``      — Bayesian logistic regression, the two-layer Bayesian
                    neural network (regression), the 1-D Gaussian mixture;
- ``telemetry``   — the metrics registry, the span tracer and flight
                    recorder, posterior diagnostics and SLOs (import
                    ``dist_svgd_torch.telemetry``);
- ``resilience``  — supervised runs (``RunSupervisor``: checkpoints, a
                    bitwise resume, retries, guards, elastic reshards),
                    fault injection and the federation loop (import
                    ``dist_svgd_torch.resilience``);
- ``serving``     — posterior-predictive serving of a checkpointed
                    ensemble: the engine (one CUDA graph a bucket on the
                    card, hot reload), the micro-batcher, the multi-tenant
                    registry and the HTTP server (import
                    ``dist_svgd_torch.serving``; the single-device ``Plan``
                    is ``dist_svgd_torch.parallel.plan``);
- ``utils``       — devices, datasets, RNG, checkpoint manifest, JAX interop.
"""

from dist_svgd_torch.distsampler import DistSampler
from dist_svgd_torch.models.bnn import (
    bnn_logp,
    ensemble_rmse,
    ensemble_test_loglik,
    make_bnn_logp,
    make_bnn_split,
    num_params,
)
from dist_svgd_torch.models.logreg import (
    ensemble_test_accuracy,
    logreg_likelihood,
    logreg_logp,
    logreg_prior,
    make_logreg_logp,
    make_logreg_split,
    posterior_predictive_prob,
)
from dist_svgd_torch.ops.approx import KernelApprox
from dist_svgd_torch.ops.kernels import RBF, AdaptiveRBF, median_bandwidth, median_bandwidth_approx
from dist_svgd_torch.sampler import Sampler

__version__ = "0.0.1"

__all__ = [
    "Sampler",
    "DistSampler",
    "RBF",
    "AdaptiveRBF",
    "KernelApprox",
    "median_bandwidth",
    "median_bandwidth_approx",
    "bnn_logp",
    "ensemble_rmse",
    "ensemble_test_loglik",
    "make_bnn_logp",
    "make_bnn_split",
    "num_params",
    "ensemble_test_accuracy",
    "logreg_likelihood",
    "logreg_logp",
    "logreg_prior",
    "make_logreg_logp",
    "make_logreg_split",
    "posterior_predictive_prob",
    "__version__",
]
