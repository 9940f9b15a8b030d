"""The port's φ (dist_svgd_torch/ops) against the JAX package's.

The same numpy inputs go through ``dist_svgd_tpu.ops.svgd.phi`` (float64)
and ``phi_pallas`` under the Pallas interpreter (float32), and through the
port's plain ``phi`` and its two kernels' plain versions.  The CUDA kernels
themselves run only on the card; ``chip_smoke.py`` holds them against these
plain versions there."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from dist_svgd_tpu.ops.kernels import RBF as JRBF
from dist_svgd_tpu.ops.pallas_svgd import phi_pallas
from dist_svgd_tpu.ops.svgd import phi as jphi

from dist_svgd_torch.ops import cuda_svgd
from dist_svgd_torch.ops.cuda_svgd import (
    SMALL_D,
    WIDE_D_MAX,
    phi_big_d_plain,
    phi_cuda,
    phi_small_d_plain,
    resolve_phi_fn,
)
from dist_svgd_torch.ops.kernels import RBF
from dist_svgd_torch.ops.svgd import phi, svgd_step

# (S, k, m, d): the shapes of tests/test_pallas.py, both sides of the
# SMALL_D boundary, and a batched lane case.
SHAPES = [
    (1, 8, 8, 2),
    (1, 50, 37, 3),
    (1, 40, 100, 55),
    (1, 130, 257, 7),
    (1, 33, 45, SMALL_D),
    (1, 33, 45, SMALL_D + 1),
    (3, 21, 40, 4),
    (3, 21, 40, 12),
]


def _inputs(S, k, m, d, seed=41):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(S, k, d)), rng.normal(size=(m, d)),
            rng.normal(size=(S, m, d)))


def _jax_phi_f64(y, x, s, h):
    return np.stack([np.asarray(jphi(jnp.asarray(y[l]), jnp.asarray(x),
                                     jnp.asarray(s[l]), JRBF(h)))
                     for l in range(y.shape[0])])


def _t(a, dtype=torch.float64):
    return torch.as_tensor(a, dtype=dtype)


@pytest.mark.parametrize("S,k,m,d", SHAPES)
def test_plain_phi_f64_matches_jax_phi(S, k, m, d):
    """All three plain forms — ops.svgd.phi (phi_impl='torch') and both
    kernels' plain versions — equal the JAX XLA φ in float64."""
    y, x, s = _inputs(S, k, m, d)
    want = _jax_phi_f64(y, x, s, 1.0)
    plain = phi_small_d_plain if d <= SMALL_D else phi_big_d_plain
    for got in (phi(_t(y), _t(x), _t(s), RBF(1.0)),
                plain(_t(y), _t(x), _t(s), 1.0)):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("S,k,m,d", SHAPES)
def test_phi_cuda_cpu_f32_matches_phi_pallas_interpret(S, k, m, d):
    """On CPU tensors phi_cuda runs its kernel's plain version in float32;
    it matches the Pallas kernel under the interpreter at test_pallas.py's
    tolerance."""
    y, x, s = (a.astype(np.float32) for a in _inputs(S, k, m, d))
    want = np.stack([
        np.asarray(phi_pallas(jnp.asarray(y[l]), jnp.asarray(x), jnp.asarray(s[l]),
                              bandwidth=1.0, block_k=128, block_m=128, interpret=True))
        for l in range(S)])
    got = phi_cuda(_t(y, torch.float32), _t(x, torch.float32), _t(s, torch.float32), 1.0)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-6)


@pytest.mark.parametrize("d", [3, 12])
def test_per_lane_interaction_sets(d):
    """``interacting`` of shape (S, m, d) (the partitions mode) gives each
    lane its own set: lane l equals the JAX φ on (y_l, x_l, s_l)."""
    rng = np.random.default_rng(3)
    y, x, s = rng.normal(size=(3, 10, d)), rng.normal(size=(3, 14, d)), rng.normal(size=(3, 14, d))
    want = np.stack([np.asarray(jphi(jnp.asarray(y[l]), jnp.asarray(x[l]),
                                     jnp.asarray(s[l]), JRBF(1.5))) for l in range(3)])
    plain = phi_small_d_plain if d <= SMALL_D else phi_big_d_plain
    np.testing.assert_allclose(plain(_t(y), _t(x), _t(s), 1.5).numpy(), want,
                               rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(phi(_t(y), _t(x), _t(s), RBF(1.5)).numpy(), want,
                               rtol=1e-10, atol=1e-12)


def test_phi_cuda_casts_f64_down_and_back():
    """As phi_pallas: float64 in, float32 arithmetic, float64 out."""
    y, x, s = _inputs(2, 9, 11, 3)
    got = phi_cuda(_t(y), _t(x), _t(s), 2.0)
    assert got.dtype == torch.float64
    want = _jax_phi_f64(y, x, s, 2.0)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-6)


def test_svgd_step_matches_jax():
    from dist_svgd_tpu.ops.svgd import svgd_step as jstep

    rng = np.random.default_rng(8)
    p, sc = rng.normal(size=(20, 3)), rng.normal(size=(20, 3))
    want = np.asarray(jstep(jnp.asarray(p), jnp.asarray(sc), 0.1, JRBF(1.0)))
    np.testing.assert_allclose(svgd_step(_t(p), _t(sc), 0.1, RBF(1.0)).numpy(), want,
                               rtol=1e-10, atol=1e-12)


def test_resolve_phi_fn_policy():
    """'auto' → phi_cuda (plain version on the CPU), 'torch' → plain phi,
    'cuda' → the kernel, refused on CPU tensors; 'cuda_bf16' → the bf16
    tiers (their plain versions on the CPU); JAX's names raise naming the
    port's."""
    y, x, s = (_t(a, torch.float32) for a in _inputs(2, 6, 9, 3))
    auto = resolve_phi_fn(RBF(1.0), "auto")(y, x, s)
    torch.testing.assert_close(auto, phi_cuda(y, x, s, 1.0), rtol=0, atol=0)
    torch.testing.assert_close(resolve_phi_fn(RBF(1.0), "torch")(y, x, s),
                               phi(y, x, s, RBF(1.0)), rtol=0, atol=0)
    with pytest.raises(ValueError, match="CUDA tensors"):
        resolve_phi_fn(RBF(1.0), "cuda")(y, x, s)
    torch.testing.assert_close(resolve_phi_fn(RBF(1.0), "cuda_bf16")(y, x, s),
                               cuda_svgd.phi_small_d_bf16_plain(y, x, s, 1.0),
                               rtol=0, atol=0)
    with pytest.raises(ValueError, match="'cuda_bf16'"):
        resolve_phi_fn(RBF(1.0), "pallas_bf16")
    with pytest.raises(ValueError, match="unknown phi_impl"):
        resolve_phi_fn(RBF(1.0), "xla")
    with pytest.raises(NotImplementedError, match="RBF"):
        resolve_phi_fn(lambda a, b: a @ b, "torch")


def test_kernel_wrappers_refuse_cpu_tensors():
    """A kernel wrapper launches or raises: CPU tensors are refused before
    any build, never routed to the plain version."""
    y, x, s = (_t(a, torch.float32) for a in _inputs(1, 4, 5, 3))
    with pytest.raises(ValueError, match="CUDA tensor"):
        cuda_svgd.phi_small_d_cuda(y, x, s)
    y, x, s = (_t(a, torch.float32) for a in _inputs(1, 4, 5, 20))
    with pytest.raises(ValueError, match="CUDA tensor"):
        cuda_svgd.phi_big_d_cuda(y, x, s)
    with pytest.raises(ValueError, match="CUDA tensor"):
        cuda_svgd.phi_big_d_bf16x3_cuda(y, x, s)
    with pytest.raises(ValueError, match="phi_small_d takes"):
        cuda_svgd.phi_small_d_cuda(y, x, s)
    with pytest.raises(ValueError, match="phi_small_d_bf16 takes"):
        cuda_svgd.phi_small_d_bf16_cuda(y, x, s)
    assert cuda_svgd.launch_counts == {"phi_small_d": 0, "phi_big_d": 0,
                                       "phi_small_d_bf16": 0, "phi_big_d_bf16x3": 0,
                                       "phi_wide_d": 0, "phi_wide_d_bf16x3": 0}


def test_phi_cuda_refuses_d_above_cap_and_bad_shapes():
    y, x, s = (_t(a, torch.float32) for a in _inputs(1, 4, 5, WIDE_D_MAX + 1))
    with pytest.raises(ValueError, match="cap"):
        phi_cuda(y, x, s)
    y, x, s = (_t(a, torch.float32) for a in _inputs(2, 4, 5, 3))
    with pytest.raises(ValueError, match="scores must be"):
        phi_cuda(y, x, s[:, :4])
    with pytest.raises(ValueError, match="updated must be"):
        phi_cuda(y[0], x, s)


def test_drive_operand_and_epilogue_reproduce_the_direct_form():
    """The kernels' rearrangement K·(s − (2/h)x) + (2/h)·y·ksum equals the
    direct drive + repulsive sum (pallas_svgd.py docstring), in float64."""
    y, x, s = _inputs(1, 7, 9, 4, seed=5)
    h = 0.7
    K = np.exp(-((y[0][:, None, :] - x[None]) ** 2).sum(-1) / h)  # (k, m)
    direct = (K @ s[0] + (2.0 / h) * (y[0] * K.sum(1)[:, None] - K @ x)) / x.shape[0]
    np.testing.assert_allclose(phi_small_d_plain(_t(y), _t(x), _t(s), h)[0].numpy(),
                               direct, rtol=1e-12, atol=1e-14)
    assert jax.config.read("jax_enable_x64")
