"""dist_svgd_torch — the PyTorch/CUDA port of dist_svgd_tpu.

A second package beside the JAX one, grown slice by slice (ROADMAP.md).  It
imports torch and never JAX or ``dist_svgd_tpu``; the JAX package is the
reference its tests hold it against.  Its entry points run on the card
(``device=None`` → CUDA, raising without it) unless the caller asks for the
CPU.

- ``DistSampler`` — sharded SVGD, the S shards emulated on one card, the
  three exchange modes (gather implementation, Jacobi update);
- ``ops``         — the RBF kernel, the plain φ, and the hand-written CUDA
                    φ kernels (``csrc/``) with their plain versions;
- ``models``      — Bayesian logistic regression;
- ``utils``       — devices, datasets, RNG, checkpoint manifest, JAX interop.
"""

from dist_svgd_torch.distsampler import DistSampler
from dist_svgd_torch.models.logreg import (
    ensemble_test_accuracy,
    logreg_likelihood,
    logreg_logp,
    logreg_prior,
    make_logreg_logp,
    posterior_predictive_prob,
)
from dist_svgd_torch.ops.kernels import RBF, median_bandwidth

__version__ = "0.0.1"

__all__ = [
    "DistSampler",
    "RBF",
    "median_bandwidth",
    "ensemble_test_accuracy",
    "logreg_likelihood",
    "logreg_logp",
    "logreg_prior",
    "make_logreg_logp",
    "posterior_predictive_prob",
    "__version__",
]
