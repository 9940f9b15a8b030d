"""Utilities: device resolution, datasets, RNG, checkpoint manifest, and
JAX-state interop."""

from dist_svgd_torch.utils.datasets import DATASET_NAMES, Fold, load_benchmark
from dist_svgd_torch.utils.platform import resolve_device
from dist_svgd_torch.utils.rng import init_particles, init_particles_per_shard

__all__ = [
    "DATASET_NAMES",
    "Fold",
    "load_benchmark",
    "resolve_device",
    "init_particles",
    "init_particles_per_shard",
]
