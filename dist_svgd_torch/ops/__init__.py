"""SVGD primitives on tensors: the RBF kernel, the plain φ, the hand CUDA φ
kernels with their plain versions, the sub-quadratic φ (``approx``: random
features and Nyström), and the W2/JKO term (``ot``: the host LP and the
Sinkhorn solve, whose card routes run the hand kernels of ``cuda_ot``)."""

from dist_svgd_torch.ops.approx import (
    KernelApprox,
    as_kernel_approx,
    default_error_budget,
    is_gram_free,
    phi_nystrom,
    phi_rff,
)
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
    kernel_grad_matrix,
    kernel_matrix,
    median_bandwidth,
    median_bandwidth_approx,
    squared_distances,
)
from dist_svgd_torch.ops.ot import (
    sinkhorn_plan,
    wasserstein_grad_lp,
    wasserstein_grad_sinkhorn,
)
from dist_svgd_torch.ops.svgd import (
    phi,
    phi_blockwise,
    phi_chunked,
    svgd_step,
    svgd_step_sequential,
)

__all__ = [
    "BIG_D_MAX",
    "SMALL_D",
    "WIDE_D_MAX",
    "RBF",
    "AdaptiveRBF",
    "KernelApprox",
    "as_kernel_approx",
    "default_error_budget",
    "is_gram_free",
    "phi_nystrom",
    "phi_rff",
    "kernel_matrix",
    "kernel_grad_matrix",
    "median_bandwidth",
    "median_bandwidth_approx",
    "phi",
    "phi_blockwise",
    "phi_chunked",
    "phi_cuda",
    "resolve_phi_fn",
    "sinkhorn_plan",
    "squared_distances",
    "svgd_step",
    "svgd_step_sequential",
    "wasserstein_grad_lp",
    "wasserstein_grad_sinkhorn",
]
