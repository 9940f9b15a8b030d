"""Kernels other than the RBF in the port: ``ops/kernels.py:kernel_matrix``
/ ``kernel_grad_matrix`` (torch.func over a scalar kernel callable), the
generic φ (``ops/svgd.py:phi``), and both samplers with such a kernel —
against the JAX package in float64.

Tolerances: the Gram and gradient matrices at 1e-12 relative (the same
scalar arithmetic on both sides, only the autodiff differs in order); φ
and sampler trajectories at JAX's own 1e-10 (tests/test_svgd_step.py,
tests/test_distsampler.py); the generic φ of the RBF written as a plain
callable against the fused RBF φ at 1e-10 (JAX's
``test_phi_generic_kernel_equals_fused_rbf``)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import dist_svgd_tpu as jdt
from dist_svgd_tpu.models.logreg import logreg_logp as jlogreg_logp
from dist_svgd_tpu.ops import kernels as jkernels
from dist_svgd_tpu.ops.svgd import phi as jphi

import dist_svgd_torch as tdt
from dist_svgd_torch.models.gmm import gmm_logp
from dist_svgd_torch.models.logreg import logreg_logp
from dist_svgd_torch.ops.cuda_svgd import resolve_phi_fn
from dist_svgd_torch.ops.kernels import RBF, kernel_grad_matrix, kernel_matrix
from dist_svgd_torch.ops.svgd import phi

from _oracle import drbf_dx
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

RTOL, ATOL = 1e-10, 1e-12


def imq(a, b):
    """Inverse multiquadric k(a, b) = (1 + ‖a − b‖²)^(−1/2), in torch."""
    return (1.0 + torch.sum((a - b) ** 2)) ** -0.5


def jimq(a, b):
    return (1.0 + jnp.sum((a - b) ** 2)) ** -0.5


def rbf_plain(a, b):
    """The RBF(1) written as a plain callable (no ``matrix``)."""
    return torch.exp(-torch.sum((a - b) ** 2))


def jrbf_plain(a, b):
    return jnp.exp(-jnp.sum((a - b) ** 2))


KERNELS = [(imq, jimq), (rbf_plain, jrbf_plain)]


def _t(a):
    return torch.as_tensor(np.asarray(a, dtype=np.float64))


@pytest.mark.parametrize("k,jk", KERNELS, ids=["imq", "rbf_plain"])
def test_kernel_matrices_match_jax(k, jk):
    rng = np.random.default_rng(1)
    x, y = rng.normal(size=(5, 3)), rng.normal(size=(7, 3))
    np.testing.assert_allclose(kernel_matrix(k, _t(x), _t(y)).numpy(),
                               np.asarray(jkernels.kernel_matrix(jk, x, y)), rtol=1e-12)
    grad = kernel_grad_matrix(k, _t(x), _t(y))
    assert grad.shape == (5, 7, 3)
    np.testing.assert_allclose(grad.numpy(), np.asarray(jkernels.kernel_grad_matrix(jk, x, y)),
                               rtol=1e-12, atol=1e-15)


def test_kernel_grad_matrix_matches_analytic_rbf():
    """The generic autograd path equals the closed form −2(x − y)·k."""
    rng = np.random.default_rng(2)
    x, y = rng.normal(size=(3, 2)), rng.normal(size=(4, 2))
    g = kernel_grad_matrix(rbf_plain, _t(x), _t(y)).numpy()
    for i in range(3):
        for j in range(4):
            np.testing.assert_allclose(g[i, j], drbf_dx(x[i], y[j]), rtol=1e-10)


def test_kernel_matrix_takes_the_kernels_own_matrix():
    rng = np.random.default_rng(3)
    x, y = _t(rng.normal(size=(4, 2))), _t(rng.normal(size=(6, 2)))
    torch.testing.assert_close(kernel_matrix(RBF(2.5), x, y), RBF(2.5).matrix(x, y),
                               rtol=0, atol=0)
    torch.testing.assert_close(kernel_matrix(rbf_plain, x, y), RBF(1.0).matrix(x, y),
                               rtol=1e-12, atol=0)


@pytest.mark.parametrize("k,jk", KERNELS, ids=["imq", "rbf_plain"])
def test_generic_phi_matches_jax(k, jk):
    rng = np.random.default_rng(4)
    y, x, s = rng.normal(size=(5, 2)), rng.normal(size=(6, 2)), rng.normal(size=(6, 2))
    np.testing.assert_allclose(phi(_t(y), _t(x), _t(s), k).numpy(),
                               np.asarray(jphi(jnp.asarray(y), jnp.asarray(x),
                                               jnp.asarray(s), jk)), rtol=RTOL, atol=ATOL)


def test_generic_phi_equals_fused_rbf_on_lanes():
    """The RBF as a plain callable through the generic branch equals the
    fused RBF φ, on one lane and on batched lanes (shared and per-lane x)."""
    rng = np.random.default_rng(5)
    y, x, s = _t(rng.normal(size=(3, 5, 2))), _t(rng.normal(size=(6, 2))), _t(
        rng.normal(size=(3, 6, 2)))
    torch.testing.assert_close(phi(y[0], x, s[0], rbf_plain), phi(y[0], x, s[0], RBF(1.0)),
                               rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(phi(y, x, s, rbf_plain), phi(y, x, s, RBF(1.0)),
                               rtol=RTOL, atol=ATOL)
    xs = x.expand(3, 6, 2) + 0.1 * _t(rng.normal(size=(3, 6, 2)))
    torch.testing.assert_close(phi(y, xs, s, rbf_plain), phi(y, xs, s, RBF(1.0)),
                               rtol=RTOL, atol=ATOL)
    # the φ policy's plain route takes the same generic form
    torch.testing.assert_close(resolve_phi_fn(imq, "auto")(y, x, s), phi(y, x, s, imq),
                               rtol=0, atol=0)


MODES = [("all_particles", True, False), ("all_scores", True, True),
         ("partitions", False, False)]


@pytest.mark.parametrize("name,exch_p,exch_s", MODES)
def test_distsampler_with_generic_kernel_matches_jax(name, exch_p, exch_s):
    rng = np.random.default_rng(6)
    particles = rng.normal(size=(8, 3))
    x, t = rng.normal(size=(16, 2)), np.where(rng.normal(size=16) > 0, 1.0, -1.0)
    common = dict(exchange_particles=exch_p, exchange_scores=exch_s,
                  include_wasserstein=False)
    js = jdt.DistSampler(2, jlogreg_logp, jimq, jnp.asarray(particles),
                         data=(jnp.asarray(x), jnp.asarray(t)), **common)
    ps = tdt.DistSampler(2, logreg_logp, imq, particles, data=(x, t), device="cpu",
                         **common)
    for _ in range(2):
        np.testing.assert_allclose(ps.make_step(0.05).numpy(), np.asarray(js.make_step(0.05)),
                                   rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(ps.run_steps(2, 0.05).numpy(),
                               np.asarray(js.run_steps(2, 0.05)), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("update_rule", ["jacobi", "gauss_seidel"])
def test_sampler_with_generic_kernel_matches_jax(update_rule):
    from dist_svgd_tpu.models.gmm import gmm_logp as jgmm

    init = np.random.default_rng(7).normal(size=(12, 1))
    _, want = jdt.Sampler(1, jgmm, kernel=jimq, update_rule=update_rule).run(
        12, 4, 0.5, initial_particles=jnp.asarray(init))
    _, got = tdt.Sampler(1, gmm_logp, kernel=imq, update_rule=update_rule,
                         device="cpu").run(12, 4, 0.5, initial_particles=init)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    assert jax.config.read("jax_enable_x64")
