"""Progressive delivery of posterior generations.

Shadow traffic → staged canary hash-splits → SLO-gated automatic
promotion, with O(1) rollback to the still-resident incumbent.  See
:mod:`dist_svgd_torch.rollout.controller` (the counterpart of
``dist_svgd_tpu/rollout``).
"""

from dist_svgd_torch.rollout.controller import (
    DIVERGENCE_BUCKETS,
    RolloutController,
    RolloutPlan,
    prediction_divergence,
)

__all__ = [
    "DIVERGENCE_BUCKETS",
    "RolloutController",
    "RolloutPlan",
    "prediction_divergence",
]
