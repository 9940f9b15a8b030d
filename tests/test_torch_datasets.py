"""The port's own copies of the numpy-only helpers: datasets bitwise equal to
the JAX package's, and the torch.Generator particle streams."""

import numpy as np
import pytest
import torch

from dist_svgd_tpu.utils import datasets as jds

from dist_svgd_torch.utils import datasets as tds
from dist_svgd_torch.utils.rng import init_particles, init_particles_per_shard
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)


@pytest.mark.parametrize("name", jds.DATASET_NAMES)
def test_load_benchmark_bitwise_equal(name):
    assert tds.DATASET_NAMES == jds.DATASET_NAMES
    for fold in (0, 42):
        want, got = jds.load_benchmark(name, fold), tds.load_benchmark(name, fold)
        for field in ("x_train", "t_train", "x_test", "t_test"):
            a, b = getattr(got, field), getattr(want, field)
            assert a.dtype == b.dtype and a.shape == b.shape, field
            assert np.array_equal(a, b), (name, fold, field)


def test_synthetic_struct_with_explicit_seed_bitwise_equal():
    for name in ("banana", "covertype", "unknown-name"):
        for x, y in zip(tds.make_synthetic_mat_struct(name, seed=3),
                        jds.make_synthetic_mat_struct(name, seed=3)):
            assert x.dtype == y.dtype and np.array_equal(x, y)


def test_missing_or_lfs_mat_path_falls_back(tmp_path):
    pointer = tmp_path / "benchmarks.mat"
    pointer.write_bytes(b"version https://git-lfs.github.com/spec/v1\n")
    got = tds.load_benchmark("titanic", 1, mat_path=str(pointer))
    assert np.array_equal(got.x_train, jds.load_benchmark("titanic", 1).x_train)


def test_init_particles_streams():
    """A seed gives the same particles every time; shards draw independent
    blocks; a different seed gives different particles."""
    a = init_particles_per_shard(0, 40, 3, 4)
    assert a.shape == (40, 3) and a.dtype == torch.float32
    torch.testing.assert_close(a, init_particles_per_shard(0, 40, 3, 4), rtol=0, atol=0)
    blocks = a.reshape(4, 10, 3)
    assert not torch.equal(blocks[0], blocks[1])
    assert not torch.equal(a, init_particles_per_shard(1, 40, 3, 4))
    b = init_particles(5, 1000, 2, dtype=torch.float64, device="cpu")
    assert b.dtype == torch.float64 and abs(float(b.mean())) < 0.1
    assert abs(float(b.std()) - 1.0) < 0.1
    with pytest.raises(ValueError, match="divisible"):
        init_particles_per_shard(0, 41, 3, 4)
