"""The port's BNN regression model (dist_svgd_torch/models/bnn.py, BASELINE.json
config 5) and the UCI loader against the JAX package's.

The same numpy particles and data go through ``dist_svgd_tpu.models.bnn``
and the port in float64, held at ``rtol=1e-10``: the log-density, the split
likelihood/prior pair, the scores (``jax.vmap(jax.grad)`` against
``torch.func.vmap(torch.func.grad)``), the network output and the two
ensemble metrics.  ``load_uci_regression`` is bitwise JAX's.  The port's
initial particles come from torch generators, so they are held to the
distribution JAX draws from, not to JAX's numbers."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dist_svgd_tpu.models import bnn as jbnn
from dist_svgd_tpu.utils import datasets as jds
from dist_svgd_tpu.utils.rng import as_key

from dist_svgd_torch.models import bnn as tbnn
from dist_svgd_torch.utils import datasets as tds
from dist_svgd_torch.utils.interop import particles_from_jax

RTOL = 1e-10


@pytest.mark.parametrize("name,split,standardize", [
    ("boston", 0, True), ("yacht", 3, True), ("protein", 1, True), ("wine", 0, False),
])
def test_load_uci_regression_bitwise_equal(name, split, standardize):
    got = tds.load_uci_regression(name, split, standardize)
    want = jds.load_uci_regression(name, split, standardize)
    for field in ("x_train", "y_train", "x_test", "y_test", "x_mean", "x_std"):
        a, b = getattr(got, field), getattr(want, field)
        assert a.dtype == b.dtype and np.array_equal(a, b), field
    assert (got.y_mean, got.y_std) == (want.y_mean, want.y_std)
    assert got.x_train.shape == (900, tds.UCI_REGRESSION_DIMS[name])


def test_load_uci_regression_reads_npz_and_refuses_unknown_names(tmp_path):
    rng = np.random.default_rng(0)
    np.savez(tmp_path / "yacht.npz", x=rng.normal(size=(40, 6)), y=rng.normal(size=40))
    got = tds.load_uci_regression("yacht", 0, data_path=str(tmp_path))
    want = jds.load_uci_regression("yacht", 0, data_path=str(tmp_path))
    assert got.x_train.shape == (36, 6) and np.array_equal(got.x_test, want.x_test)
    with pytest.raises(ValueError, match="unknown UCI regression dataset"):
        tds.load_uci_regression("mnist")


def _problem(n_features=5, n_hidden=7, n=6, rows=11, seed=2):
    rng = np.random.default_rng(seed)
    d = tbnn.num_params(n_features, n_hidden)
    theta = 0.5 * rng.normal(size=(n, d))
    theta[:, -2:] = rng.normal(size=(n, 2))  # log-precisions of order 1
    x = rng.normal(size=(rows, n_features))
    y = rng.normal(size=rows)
    return theta, x, y


def test_layout_and_num_params_match_jax():
    assert tbnn.num_params(13, 50) == jbnn.num_params(13, 50) == 753
    theta, _, _ = _problem()
    got = tbnn.unpack(torch.as_tensor(theta[0]), 5, 7)
    want = jbnn.unpack(jnp.asarray(theta[0]), 5, 7)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_logp_and_split_match_jax():
    theta, x, y = _problem()
    lik, prior = tbnn.make_bnn_split(5, 7)
    jlik, jprior = jbnn.make_bnn_split(5, 7)
    data, jdata = (torch.as_tensor(x), torch.as_tensor(y)), (jnp.asarray(x), jnp.asarray(y))
    for th in theta:
        t, j = torch.as_tensor(th), jnp.asarray(th)
        want = float(jbnn.bnn_logp(j, jdata, 5, 7))
        np.testing.assert_allclose(float(tbnn.bnn_logp(t, data, 5, 7)), want, rtol=RTOL)
        np.testing.assert_allclose(float(tbnn.make_bnn_logp(5, 7)(t, data)), want, rtol=RTOL)
        np.testing.assert_allclose(float(lik(t, data)), float(jlik(j, jdata)), rtol=RTOL)
        np.testing.assert_allclose(float(prior(t)), float(jprior(j)), rtol=RTOL)
        np.testing.assert_allclose(float(lik(t, data) + prior(t)), want, rtol=RTOL)


def test_scores_match_jax_vmap_grad():
    theta, x, y = _problem()
    data, jdata = (torch.as_tensor(x), torch.as_tensor(y)), (jnp.asarray(x), jnp.asarray(y))
    logp = tbnn.make_bnn_logp(5, 7)
    got = torch.func.vmap(torch.func.grad(logp), in_dims=(0, None))(torch.as_tensor(theta), data)
    want = jax.vmap(jax.grad(jbnn.make_bnn_logp(5, 7)), in_axes=(0, None))(
        jnp.asarray(theta), jdata)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=1e-12)


def test_predict_and_ensemble_metrics_match_jax():
    theta, x, y = _problem()
    t, j = torch.as_tensor(theta), jnp.asarray(theta)
    np.testing.assert_allclose(tbnn.predict(t[0], torch.as_tensor(x), 5, 7).numpy(),
                               np.asarray(jbnn.predict(j[0], jnp.asarray(x), 5, 7)), rtol=RTOL)
    for fn, jfn in ((tbnn.ensemble_rmse, jbnn.ensemble_rmse),
                    (tbnn.ensemble_test_loglik, jbnn.ensemble_test_loglik)):
        got = float(fn(t, torch.as_tensor(x), y, 5, 7, y_mean=0.3, y_std=2.5))
        want = float(jfn(j, jnp.asarray(x), y, 5, 7, y_mean=0.3, y_std=2.5))
        np.testing.assert_allclose(got, want, rtol=RTOL)


def test_particles_from_jax_predict_the_same():
    """A JAX-initialised ensemble carried into the port predicts there what
    it predicts in JAX; a layout that is not the BNN's is refused."""
    sp = jds.load_uci_regression("yacht", 0)
    jparts = np.asarray(jbnn.init_particles(as_key(4), 12, 6, 8, dtype=jnp.float64))
    parts = particles_from_jax(jparts, "cpu", n_features=6, n_hidden=8)
    assert parts.dtype == torch.float64 and parts.shape == (12, tbnn.num_params(6, 8))
    got = float(tbnn.ensemble_rmse(parts, torch.as_tensor(sp.x_test, dtype=torch.float64),
                                   sp.y_test, 6, 8, y_mean=sp.y_mean, y_std=sp.y_std))
    want = float(jbnn.ensemble_rmse(jparts, jnp.asarray(sp.x_test, jnp.float64), sp.y_test,
                                    6, 8, y_mean=sp.y_mean, y_std=sp.y_std))
    np.testing.assert_allclose(got, want, rtol=RTOL)
    with pytest.raises(ValueError, match="d=67, but .* has d=403"):
        particles_from_jax(jparts, "cpu", n_features=6)  # n_hidden defaults to 50
    with pytest.raises(ValueError, match="floating"):
        particles_from_jax(jparts[0], "cpu")


def test_init_particles_shape_scales_and_gamma_moments():
    """Weights N(0, 1/(fan_in + 1)) per block, log-precisions log(Gamma(1)/0.1):
    the same distribution as JAX's init, from a seed."""
    n, nf, nh = 4000, 6, 9
    parts = tbnn.init_particles(7, n, nf, nh, dtype=torch.float64)
    assert parts.shape == (n, tbnn.num_params(nf, nh)) and parts.dtype == torch.float64
    torch.testing.assert_close(parts, tbnn.init_particles(7, n, nf, nh, dtype=torch.float64))
    k = nf * nh
    for block, sd in ((parts[:, :k + nh], 1 / math.sqrt(nf + 1)),
                      (parts[:, k + nh:-2], 1 / math.sqrt(nh + 1))):
        assert abs(float(block.std()) - sd) < 0.03 * sd and abs(float(block.mean())) < 0.02
    for col in (-2, -1):  # Gamma(1, rate 0.1): mean 10, variance 100
        prec = torch.exp(parts[:, col])
        assert abs(float(prec.mean()) - 10.0) < 0.6 and abs(float(prec.var()) - 100.0) < 15.0
    jparts = np.asarray(jbnn.init_particles(as_key(7), n, nf, nh, dtype=jnp.float64))
    assert abs(np.exp(jparts[:, -2]).mean() - float(torch.exp(parts[:, -2]).mean())) < 1.0
    assert not torch.equal(parts[:, -2], parts[:, -1])
