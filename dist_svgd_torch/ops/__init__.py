"""SVGD primitives on tensors: the RBF kernel, the plain φ, the hand CUDA φ
kernels with their plain versions, and the W2/JKO term (``ot``: the host LP
and the Sinkhorn solve, whose card routes run the hand kernels of
``cuda_ot``)."""

from dist_svgd_torch.ops.cuda_svgd import (
    BIG_D_MAX,
    SMALL_D,
    WIDE_D_MAX,
    phi_cuda,
    resolve_phi_fn,
)
from dist_svgd_torch.ops.kernels import (
    RBF,
    AdaptiveRBF,
    median_bandwidth,
    median_bandwidth_approx,
    squared_distances,
)
from dist_svgd_torch.ops.ot import (
    sinkhorn_plan,
    wasserstein_grad_lp,
    wasserstein_grad_sinkhorn,
)
from dist_svgd_torch.ops.svgd import phi, svgd_step

__all__ = [
    "BIG_D_MAX",
    "SMALL_D",
    "WIDE_D_MAX",
    "RBF",
    "AdaptiveRBF",
    "median_bandwidth",
    "median_bandwidth_approx",
    "phi",
    "phi_cuda",
    "resolve_phi_fn",
    "sinkhorn_plan",
    "squared_distances",
    "svgd_step",
    "wasserstein_grad_lp",
    "wasserstein_grad_sinkhorn",
]
