"""1-D Gaussian-mixture target — the reference's sanity-check model.

Counterpart of ``dist_svgd_tpu/models/gmm.py``.  Reference quirk, kept: the
reference's comment describes the mixture as ``1/3·p1 + 2/3·p2`` but its code
weights *both* components 1/3; the code is what is replicated.
Unnormalised densities are fine for scores.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch

_LOG_SQRT_2PI = 0.5 * math.log(2.0 * math.pi)


def make_gmm_logp(
    means: Sequence[float] = (-2.0, 2.0),
    scales: Sequence[float] = (1.0, 1.0),
    weights: Sequence[float] = (1.0 / 3.0, 1.0 / 3.0),
):
    """``logp(theta, data=None)`` for a (possibly unnormalised) Gaussian
    mixture.  ``theta`` has shape ``(d,)``; dimensions are independent and
    summed, so ``d = 1`` is the reference's target.  The mixture's
    ``log Σ_i w_i exp(logpdf_i)`` is taken as a logsumexp."""
    means_t, scales_t = tuple(map(float, means)), tuple(map(float, scales))
    log_w = tuple(math.log(w) for w in weights)

    def column(values, like):
        # fills, not a host copy: the same values, and no pageable copy to
        # the card on every call (none at all inside a CUDA-graph capture,
        # where a pageable copy is refused)
        return torch.stack([like.new_full((), v) for v in values])[:, None]

    def logp(theta, data=None):
        del data  # no dataset — the target density is the model
        mu = column(means_t, theta)
        sc = column(scales_t, theta)
        lw = column(log_w, theta)
        z = (theta[None, :] - mu) / sc
        comp = lw + (-0.5 * z * z - torch.log(sc) - _LOG_SQRT_2PI)
        return torch.sum(torch.logsumexp(comp, dim=0))

    return logp


#: The reference's instance: 1/3·N(−2, 1) + 1/3·N(2, 1) (the code's
#: weights, not its comment's).
gmm_logp = make_gmm_logp()
