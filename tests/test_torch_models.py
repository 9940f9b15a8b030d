"""The port's RBF kernel and logistic-regression model against the JAX
package's, in float64 on the same numpy inputs."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from dist_svgd_tpu.models import logreg as jlr
from dist_svgd_tpu.ops import kernels as jk
from dist_svgd_tpu.utils.datasets import load_benchmark

from dist_svgd_torch.models import logreg as tlr
from dist_svgd_torch.ops import kernels as tk
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)


def _t(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.float64)


def test_squared_distances_and_rbf_match_jax():
    rng = np.random.default_rng(0)
    x, y = rng.normal(size=(13, 4)), rng.normal(size=(9, 4))
    np.testing.assert_allclose(tk.squared_distances(_t(x), _t(y)).numpy(),
                               np.asarray(jk.squared_distances(jnp.asarray(x), jnp.asarray(y))),
                               rtol=1e-12, atol=1e-12)
    assert float(tk.squared_distances(_t(x), _t(x)).min()) >= 0.0
    for h in (1.0, 2.5):
        np.testing.assert_allclose(
            tk.RBF(h).matrix(_t(x), _t(y)).numpy(),
            np.asarray(jk.RBF(h).matrix(jnp.asarray(x), jnp.asarray(y))), rtol=1e-12)
    with pytest.raises(ValueError, match="positive"):
        tk.RBF(0.0)


@pytest.mark.parametrize("n,max_points", [(30, 4096), (250, 64)])
def test_median_bandwidth_matches_jax(n, max_points):
    """Full and strided-subsample medians (the subsample path keeps the full
    n in the log(n + 1) normaliser)."""
    p = np.random.default_rng(n).normal(size=(n, 3))
    want = float(jk.median_bandwidth(jnp.asarray(p), max_points))
    assert float(tk.median_bandwidth(_t(p), max_points)) == pytest.approx(want, rel=1e-12)


def test_logp_prior_likelihood_match_jax():
    f = load_benchmark("titanic", 3)
    data_np = (f.x_train.astype(np.float64), f.t_train.astype(np.float64))
    theta = np.random.default_rng(1).normal(size=1 + f.x_train.shape[1])
    jdata = tuple(jnp.asarray(a) for a in data_np)
    tdata = tuple(_t(a) for a in data_np)
    got = float(tlr.logreg_logp(_t(theta), tdata))
    assert got == pytest.approx(float(jlr.logreg_logp(jnp.asarray(theta), jdata)), rel=1e-12)
    split = float(tlr.logreg_likelihood(_t(theta), tdata) + tlr.logreg_prior(_t(theta)))
    assert split == pytest.approx(got, rel=1e-12)
    closure = tlr.make_logreg_logp(*tdata)
    assert float(closure(_t(theta))) == pytest.approx(got, rel=1e-14)


@pytest.mark.parametrize("name", ["banana", "splice"])
def test_batched_scores_match_jax_vmap_grad(name):
    """torch.func.vmap(grad(logreg_logp)) equals jax.vmap(jax.grad(...)) on
    a benchmark fold (the scores every exchange mode is built from)."""
    f = load_benchmark(name, 0)
    x, t = f.x_train.astype(np.float64), f.t_train.reshape(-1)
    thetas = np.random.default_rng(2).normal(size=(17, 1 + x.shape[1]))
    want = jax.vmap(jax.grad(jlr.logreg_logp), in_axes=(0, None))(
        jnp.asarray(thetas), (jnp.asarray(x), jnp.asarray(t)))
    got = torch.func.vmap(torch.func.grad(tlr.logreg_logp), in_dims=(0, None))(
        _t(thetas), (_t(x), _t(t)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-10, atol=1e-12)


def test_predictive_and_accuracy_match_jax():
    f = load_benchmark("banana", 42)
    parts = np.random.default_rng(3).normal(size=(40, 3))
    x, t = f.x_test.astype(np.float64), f.t_test.astype(np.float64)
    np.testing.assert_allclose(
        tlr.posterior_predictive_prob(_t(parts), _t(x)).numpy(),
        np.asarray(jlr.posterior_predictive_prob(jnp.asarray(parts), jnp.asarray(x))),
        rtol=1e-12)
    got = float(tlr.ensemble_test_accuracy(_t(parts), _t(x), _t(t)))
    want = float(jlr.ensemble_test_accuracy(jnp.asarray(parts), jnp.asarray(x),
                                            jnp.asarray(t)))  # a float32 mean in JAX
    assert round(got * x.shape[0]) == round(want * x.shape[0])
