"""SVGD primitives on tensors: the RBF kernel, the plain φ, and the hand
CUDA φ kernels with their plain versions."""

from dist_svgd_torch.ops.cuda_svgd import (
    BIG_D_MAX,
    SMALL_D,
    phi_cuda,
    resolve_phi_fn,
)
from dist_svgd_torch.ops.kernels import RBF, median_bandwidth, squared_distances
from dist_svgd_torch.ops.svgd import phi, svgd_step

__all__ = [
    "BIG_D_MAX",
    "SMALL_D",
    "RBF",
    "median_bandwidth",
    "phi",
    "phi_cuda",
    "resolve_phi_fn",
    "squared_distances",
    "svgd_step",
]
