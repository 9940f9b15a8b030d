"""Utilities: device resolution, datasets, RNG, history records, checkpoint
manifest, and JAX-state interop."""

from dist_svgd_torch.utils.datasets import (
    DATASET_NAMES,
    UCI_REGRESSION_DIMS,
    Fold,
    RegressionSplit,
    load_benchmark,
    load_covertype,
    load_uci_regression,
)
from dist_svgd_torch.utils.platform import resolve_device
from dist_svgd_torch.utils.rng import init_particles, init_particles_per_shard

__all__ = [
    "DATASET_NAMES",
    "UCI_REGRESSION_DIMS",
    "Fold",
    "RegressionSplit",
    "load_benchmark",
    "load_covertype",
    "load_uci_regression",
    "resolve_device",
    "init_particles",
    "init_particles_per_shard",
]
