"""Dataset loading — the port's own copy of the JAX package's numpy-only
loader (``dist_svgd_tpu/utils/datasets.py``), kept here because importing
anything from ``dist_svgd_tpu`` pulls in JAX.  The output is bitwise the JAX
package's (``tests/test_torch_datasets.py`` pins it).

The reference trains on the Rätsch/Cawley ``benchmarks.mat`` suite, loaded
with the convention

    mat[name][0, 0] → dataset struct with fields
        [0] X      — (N, d) instances
        [1] t      — (N, 1) labels in {-1, +1}
        [2] train  — (n_folds, n_train) 1-based indices
        [3] test   — (n_folds, n_test)  1-based indices
    x_train = X[train - 1][fold]

Without a real ``.mat`` file the loader falls back to a deterministic
synthetic generator with the same structural convention: banana-shaped 2-D
data for ``'banana'``, Gaussian blobs with each dataset's dimensionality for
the rest.
"""

from __future__ import annotations

import os
import zlib
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np

#: The reference CLI's dataset choices.
DATASET_NAMES = ("banana", "diabetis", "german", "image", "splice", "titanic", "waveform")

#: Feature dimensionalities of the real Rätsch benchmark datasets, used to
#: shape the synthetic fallbacks identically.
_DATASET_DIMS: Dict[str, int] = {
    "banana": 2,
    "diabetis": 8,
    "german": 20,
    "image": 18,
    "splice": 60,
    "titanic": 3,
    "waveform": 21,
    "covertype": 54,
}

_N_FOLDS = 101
_N_TRAIN = 400
_N_TEST = 1000


@dataclass
class Fold:
    """One train/test fold in reference layout."""

    x_train: np.ndarray
    t_train: np.ndarray
    x_test: np.ndarray
    t_test: np.ndarray


def _banana_points(rng: np.random.Generator, n: int) -> Tuple[np.ndarray, np.ndarray]:
    """Two interleaved crescents — the classic 'banana' binary task."""
    labels = rng.integers(0, 2, size=n)
    angle = rng.uniform(0.0, np.pi, size=n)
    radius = 2.0 + 0.35 * rng.normal(size=n)
    x = np.empty((n, 2))
    x[:, 0] = radius * np.cos(angle)
    x[:, 1] = radius * np.sin(angle)
    flip = labels == 1
    x[flip, 0] = 2.0 - x[flip, 0] * 1.0
    x[flip, 1] = 1.0 - x[flip, 1]
    x += 0.25 * rng.normal(size=(n, 2))
    t = np.where(labels > 0, 1.0, -1.0)
    return x / 2.0, t


def _blob_points(rng: np.random.Generator, n: int, dim: int) -> Tuple[np.ndarray, np.ndarray]:
    """Generic linearly-separable-ish Gaussian blobs for non-banana names."""
    labels = rng.integers(0, 2, size=n)
    direction = rng.normal(size=dim)
    direction /= np.linalg.norm(direction)
    x = rng.normal(size=(n, dim)) + np.outer(np.where(labels > 0, 1.0, -1.0), direction) * 1.2
    t = np.where(labels > 0, 1.0, -1.0)
    return x, t


def make_synthetic_mat_struct(name: str, seed: Optional[int] = None) -> tuple:
    """Build a synthetic dataset tuple in the .mat struct layout
    ``(X, t, train_idx_1based, test_idx_1based)``; deterministic per name.
    The default seed string is the JAX package's, so both packages draw the
    same data."""
    dim = _DATASET_DIMS.get(name, 10)
    if seed is None:
        seed = zlib.crc32(f"dist_svgd_tpu:{name}".encode())  # stable across processes
    rng = np.random.default_rng(seed)
    n_total = _N_TRAIN + _N_TEST
    if name == "banana":
        x, t = _banana_points(rng, n_total)
    else:
        x, t = _blob_points(rng, n_total, dim)
    train = np.empty((_N_FOLDS, _N_TRAIN), dtype=np.int64)
    test = np.empty((_N_FOLDS, _N_TEST), dtype=np.int64)
    for f in range(_N_FOLDS):
        perm = rng.permutation(n_total)
        train[f] = perm[:_N_TRAIN] + 1  # 1-based, like the .mat files
        test[f] = perm[_N_TRAIN:] + 1
    return x.astype(np.float32), t.reshape(-1, 1).astype(np.float64), train, test


def _is_lfs_pointer(path: str) -> bool:
    try:
        with open(path, "rb") as fh:
            head = fh.read(100)
        return head.startswith(b"version https://git-lfs")
    except OSError:
        return True


def load_benchmark(
    name: str,
    fold: int,
    mat_path: Optional[str] = None,
) -> Fold:
    """Load one train/test fold, from a real ``benchmarks.mat`` when available
    (reference indexing convention) or the synthetic fallback otherwise."""
    struct = None
    if mat_path is not None and os.path.exists(mat_path) and not _is_lfs_pointer(mat_path):
        from scipy.io import loadmat

        mat = loadmat(mat_path)
        dataset = mat[name][0, 0]
        struct = (dataset[0], dataset[1], dataset[2], dataset[3])
    if struct is None:
        struct = make_synthetic_mat_struct(name)

    x, t, train, test = struct
    # reference indexing: X[train - 1][fold]
    x_train = np.asarray(x[train - 1][fold], dtype=np.float32)
    t_train = np.asarray(t[train - 1][fold], dtype=np.float64)
    x_test = np.asarray(x[test - 1][fold], dtype=np.float32)
    t_test = np.asarray(t[test - 1][fold], dtype=np.float64)
    return Fold(x_train, t_train, x_test, t_test)
