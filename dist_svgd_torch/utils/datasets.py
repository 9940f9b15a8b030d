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

import math
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


#: Feature dimensionalities of the standard UCI regression suite used by the
#: SVGD BNN experiments (BASELINE.json config 5) — shapes the synthetic
#: fallbacks identically to the real datasets.
UCI_REGRESSION_DIMS: Dict[str, int] = {
    "boston": 13,
    "concrete": 8,
    "energy": 8,
    "kin8nm": 8,
    "naval": 16,
    "power": 4,
    "protein": 9,
    "wine": 11,
    "yacht": 6,
}

_UCI_ROWS = 1000


@dataclass
class RegressionSplit:
    """One 90/10 train/test split of a regression dataset (the standard UCI
    BNN protocol), with the train-set standardisation statistics needed to
    report metrics on the original target scale."""

    x_train: np.ndarray
    y_train: np.ndarray
    x_test: np.ndarray
    y_test: np.ndarray
    x_mean: np.ndarray
    x_std: np.ndarray
    y_mean: float
    y_std: float


def load_uci_regression(
    name: str,
    split: int = 0,
    standardize: bool = True,
    data_path: Optional[str] = None,
) -> RegressionSplit:
    """Load one train/test split of a UCI regression dataset.

    Reads ``<data_path>/<name>.npz`` (arrays ``x``, ``y``) when present;
    otherwise builds a deterministic synthetic nonlinear-regression
    stand-in with the real dataset's dimensionality:
    ``y = sin(2·x·a) + (x·b)²/2 + x·c + noise``, which a two-layer ReLU net
    fits well and a linear model cannot.  The seeds are the JAX package's,
    so both packages build the same arrays.

    ``standardize=True`` (the BNN protocol) z-scores features and targets by
    *train-split* statistics; ``y_test`` stays on the original scale and
    predictions are mapped back through ``y_mean``/``y_std``.
    """
    dim = UCI_REGRESSION_DIMS.get(name)
    if dim is None:
        raise ValueError(
            f"unknown UCI regression dataset {name!r}; choose from "
            f"{sorted(UCI_REGRESSION_DIMS)}"
        )
    x = y = None
    if data_path is not None:
        path = os.path.join(data_path, f"{name}.npz")
        if os.path.exists(path):
            arr = np.load(path)
            x = np.asarray(arr["x"], dtype=np.float64)
            y = np.asarray(arr["y"], dtype=np.float64).reshape(-1)
    if x is None:
        rng = np.random.default_rng(zlib.crc32(f"dist_svgd_tpu:uci:{name}".encode()))
        x = rng.normal(size=(_UCI_ROWS, dim))
        a, b, c = rng.normal(size=(3, dim)) / math.sqrt(dim)
        y = (np.sin(x @ a * 2.0) + 0.5 * (x @ b) ** 2 + x @ c
             + 0.1 * rng.normal(size=_UCI_ROWS))

    n = x.shape[0]
    perm = np.random.default_rng(zlib.crc32(f"{name}:split:{split}".encode())).permutation(n)
    n_train = int(round(0.9 * n))
    tr, te = perm[:n_train], perm[n_train:]
    x_train, y_train = x[tr], y[tr]
    x_test, y_test = x[te], y[te]

    if standardize:
        x_mean, x_std = x_train.mean(axis=0), x_train.std(axis=0) + 1e-8
        y_mean, y_std = float(y_train.mean()), float(y_train.std() + 1e-8)
        x_train = (x_train - x_mean) / x_std
        x_test = (x_test - x_mean) / x_std
        y_train = (y_train - y_mean) / y_std
    else:
        x_mean, x_std = np.zeros(x.shape[1]), np.ones(x.shape[1])
        y_mean, y_std = 0.0, 1.0

    return RegressionSplit(
        x_train.astype(np.float32),
        y_train.astype(np.float32),
        x_test.astype(np.float32),
        y_test.astype(np.float64),
        x_mean,
        x_std,
        y_mean,
        y_std,
    )


def load_covertype(n_rows: int = 50_000, seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Covertype-style binary task (BASELINE.json config 4): a deterministic
    synthetic stand-in for UCI Covertype with its shape — 54 features,
    labels in {-1, +1}, ``n_rows`` rows (``x`` float32, ``t`` float64).

    Labels are drawn before the features, so ``load_covertype(k)`` is not a
    prefix of ``load_covertype(n)``: held-out rows come from one load."""
    rng = np.random.default_rng(seed)
    x, t = _blob_points(rng, n_rows, _DATASET_DIMS["covertype"])
    return x.astype(np.float32), t.astype(np.float64)
