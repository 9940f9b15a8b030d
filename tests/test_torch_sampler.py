"""The port's single-device Sampler (dist_svgd_torch/sampler.py) and the
per-step median bandwidth (kernel='median_step') against the JAX package.

The same numpy particles and data go to ``dist_svgd_tpu.Sampler`` and the
port.  Float64 ``'torch'`` is held against JAX's ``'xla'`` at
``rtol=1e-10``: full data, minibatches, the separate prior, the per-run and
per-step median bandwidths, ``step_offset``, the history's timestep
convention, and the GMM at d = 1.  JAX draws its minibatches from threefry
streams torch cannot reproduce, so the port takes JAX's own indices through
its private seam: step ``t`` (0-based, absolute) draws
``choice(fold_in(minibatch_key(seed), t), n_rows, (B,), replace=False)``,
with no per-shard fold.  The BNN at d = 753 runs the port's ``'auto'`` on
the CPU (the wide-d kernel's plain version, float32) against JAX's
``'pallas'`` under the Pallas interpreter at tests/test_pallas.py's
``rtol=2e-5, atol=2e-6``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dist_svgd_tpu as jdt
from dist_svgd_tpu.models import bnn as jbnn
from dist_svgd_tpu.models.gmm import gmm_logp as jgmm
from dist_svgd_tpu.models.logreg import logreg_likelihood as jlik
from dist_svgd_tpu.models.logreg import logreg_logp as jlogp
from dist_svgd_tpu.models.logreg import logreg_prior as jprior
from dist_svgd_tpu.utils.rng import minibatch_key

import dist_svgd_torch as tdt
from dist_svgd_torch.models import bnn as tbnn
from dist_svgd_torch.models.gmm import gmm_logp, make_gmm_logp
from dist_svgd_torch.models.logreg import logreg_likelihood, logreg_logp, logreg_prior
from dist_svgd_torch.ops import cuda_svgd
from dist_svgd_torch.utils import history
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)


RTOL, ATOL = 1e-10, 1e-12


def problem(d=6, n=20, rows=30, seed=3):
    rng = np.random.default_rng(seed)
    particles = 0.3 * rng.normal(size=(n, d))
    x = rng.normal(size=(rows, d - 1))
    t = np.where(rng.normal(size=rows) > 0, 1.0, -1.0)
    return particles, x, t


def jax_index(seed, n_rows, batch):
    """JAX's draw for step t of a single-device run (sampler.py)."""
    root = minibatch_key(seed)
    return lambda t: np.array(jax.random.choice(jax.random.fold_in(root, t), n_rows,
                                                  (batch,), replace=False))


@pytest.mark.parametrize("kernel,batch,prior", [
    (None, None, False),
    (None, 8, False),
    (None, 8, True),
    (None, None, True),
    ("median", None, False),
    ("median_step", None, False),
    ("median_step", 8, True),
    (jdt.RBF(2.5), 8, True),
])
def test_sampler_matches_jax(kernel, batch, prior):
    kernel = tdt.RBF(2.5) if isinstance(kernel, jdt.RBF) else kernel
    jk = jdt.RBF(2.5) if isinstance(kernel, tdt.RBF) else kernel
    particles, x, t = problem()
    seed = 5
    js = jdt.Sampler(6, jlik if prior else jlogp, kernel=jk,
                     data=(jnp.asarray(x), jnp.asarray(t)), batch_size=batch,
                     log_prior=jprior if prior else None, phi_impl="xla")
    ps = tdt.Sampler(6, logreg_likelihood if prior else logreg_logp, kernel=kernel,
                     data=(x, t), batch_size=batch,
                     log_prior=logreg_prior if prior else None, phi_impl="torch",
                     device="cpu", seed=seed)
    if batch is not None:
        ps._batch_index_seam = jax_index(seed, 30, batch)
    jf, jh = js.run(20, 4, 0.05, seed=seed, initial_particles=jnp.asarray(particles))
    pf, ph = ps.run(20, 4, 0.05, initial_particles=particles)
    np.testing.assert_allclose(pf.numpy(), np.asarray(jf), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(ph.numpy(), np.asarray(jh), rtol=RTOL, atol=ATOL)


def test_step_offset_continues_the_minibatch_stream():
    """A run split at step 3 with step_offset=3 is the 7-step run, in JAX and
    in the port alike."""
    particles, x, t = problem()
    seed = 9
    js = jdt.Sampler(6, jlik, data=(jnp.asarray(x), jnp.asarray(t)), batch_size=8,
                     log_prior=jprior, phi_impl="xla")
    ps = tdt.Sampler(6, logreg_likelihood, data=(x, t), batch_size=8, log_prior=logreg_prior,
                     phi_impl="torch", device="cpu", seed=seed)
    ps._batch_index_seam = jax_index(seed, 30, 8)
    jmid, _ = js.run(20, 3, 0.05, seed=seed, record=False,
                     initial_particles=jnp.asarray(particles))
    jend, _ = js.run(20, 4, 0.05, seed=seed, record=False, initial_particles=jmid,
                     step_offset=3)
    pmid, _ = ps.run(20, 3, 0.05, record=False, initial_particles=particles)
    pend, none = ps.run(20, 4, 0.05, record=False, initial_particles=pmid, step_offset=3)
    assert none is None
    np.testing.assert_allclose(pend.numpy(), np.asarray(jend), rtol=RTOL, atol=ATOL)
    whole, _ = ps.run(20, 7, 0.05, record=False, initial_particles=particles)
    torch.testing.assert_close(pend, whole, rtol=0, atol=0)


def test_history_timestep_convention_and_dataframe():
    """num_iter pre-update snapshots plus the final state; sample() gives the
    reference DataFrame, as JAX's."""
    particles, x, t = problem(d=3, n=5)
    ps = tdt.Sampler(3, logreg_logp, data=(x, t), phi_impl="torch", device="cpu")
    final, hist = ps.run(5, 3, 0.1, initial_particles=particles)
    assert hist.shape == (4, 5, 3)
    np.testing.assert_array_equal(hist[0].numpy(), particles)
    torch.testing.assert_close(hist[-1], final, rtol=0, atol=0)
    one, _ = ps.run(5, 1, 0.1, initial_particles=particles)
    torch.testing.assert_close(hist[1], one, rtol=0, atol=0)
    df = ps.sample(5, 3, 0.1, initial_particles=particles)
    jdf = jdt.Sampler(3, jlogp, data=(jnp.asarray(x), jnp.asarray(t)), phi_impl="xla").sample(
        5, 3, 0.1, initial_particles=jnp.asarray(particles))
    assert list(df.columns) == list(jdf.columns) == ["timestep", "particle", "value"]
    assert df.shape == jdf.shape == (20, 3) and df["timestep"].max() == 3
    np.testing.assert_allclose(np.stack(df["value"]), np.stack(jdf["value"]),
                               rtol=RTOL, atol=ATOL)


def test_long_history_moves_to_the_host_in_chunks(monkeypatch):
    """Past record_chunk_steps the history goes to the host chunk by chunk
    and comes back as one numpy array, equal to the device-held one."""
    particles, x, t = problem(d=3, n=5)
    ps = tdt.Sampler(3, logreg_logp, data=(x, t), phi_impl="torch", device="cpu")
    _, whole = ps.run(5, 7, 0.1, initial_particles=particles)
    monkeypatch.setattr(history, "RECORD_HBM_BUDGET_BYTES", 2 * 5 * 3 * 8)
    assert history.record_chunk_steps(5, 3, 8) == 2
    _, chunked = ps.run(5, 7, 0.1, initial_particles=particles)
    assert isinstance(chunked, np.ndarray) and ps.last_run_stats["record_chunks_to_host"] == 3
    np.testing.assert_array_equal(chunked, whole.numpy())


def test_gmm_d1_matches_jax():
    """The reference's GMM target at d = 1: the log-density and a 20-step
    run (f64), and the small-d plain version (f32) against 'pallas'."""
    theta = np.linspace(-4.0, 4.0, 9)[:, None]
    for th in theta:
        np.testing.assert_allclose(float(gmm_logp(torch.as_tensor(th))),
                                   float(jgmm(jnp.asarray(th))), rtol=RTOL)
    lp = make_gmm_logp((-1.0, 3.0), (0.5, 2.0), (0.2, 0.8))
    from dist_svgd_tpu.models.gmm import make_gmm_logp as jmake
    np.testing.assert_allclose(float(lp(torch.tensor([0.7], dtype=torch.float64))),
                               float(jmake((-1.0, 3.0), (0.5, 2.0), (0.2, 0.8))(jnp.asarray([0.7]))),
                               rtol=RTOL)
    init = np.random.default_rng(1).normal(size=(30, 1))
    jf, _ = jdt.Sampler(1, jgmm, phi_impl="xla").run(30, 20, 0.5, record=False,
                                                      initial_particles=jnp.asarray(init))
    pf, _ = tdt.Sampler(1, gmm_logp, phi_impl="torch", device="cpu").run(
        30, 20, 0.5, record=False, initial_particles=init)
    np.testing.assert_allclose(pf.numpy(), np.asarray(jf), rtol=RTOL, atol=ATOL)
    init32 = init.astype(np.float32)
    jf, _ = jdt.Sampler(1, jgmm, phi_impl="pallas").run(30, 5, 0.5, record=False,
                                                         initial_particles=jnp.asarray(init32))
    pf, _ = tdt.Sampler(1, gmm_logp, device="cpu").run(30, 5, 0.5, record=False,
                                                       initial_particles=init32)
    np.testing.assert_allclose(pf.numpy(), np.asarray(jf), rtol=2e-5, atol=2e-6)


@pytest.mark.parametrize("kernel,batch", [(None, None), ("median_step", 10)])
def test_bnn_d753_auto_f32_matches_pallas_interpret(kernel, batch):
    """The BNN at its full width d = 753 (24 particles, 40 rows, 3 steps):
    the port's 'auto' on the CPU runs the wide-d kernel's plain version in
    float32; JAX's 'pallas' runs _phi_kernel under the interpreter."""
    n_features, n = 13, 24
    rng = np.random.default_rng(6)
    x = rng.normal(size=(40, n_features)).astype(np.float32)
    y = rng.normal(size=40).astype(np.float32)
    parts = np.array(jbnn.init_particles(jax.random.PRNGKey(2), n, n_features))
    assert parts.shape == (n, 753) and parts.dtype == np.float32
    jl, jp = jbnn.make_bnn_split(n_features)
    tl, tp = tbnn.make_bnn_split(n_features)
    js = jdt.Sampler(753, jl, kernel=kernel, data=(jnp.asarray(x), jnp.asarray(y)),
                     batch_size=batch, log_prior=jp, phi_impl="pallas")
    ps = tdt.Sampler(753, tl, kernel=kernel, data=(x, y), batch_size=batch, log_prior=tp,
                     device="cpu", seed=4)
    if batch is not None:
        ps._batch_index_seam = jax_index(4, 40, batch)
    jf, _ = js.run(n, 3, 1e-3, seed=4, record=False, initial_particles=jnp.asarray(parts))
    cuda_svgd.reset_launch_counts()
    pf, _ = ps.run(n, 3, 1e-3, record=False, initial_particles=parts)
    assert pf.dtype == torch.float32 and not any(cuda_svgd.launch_counts.values())
    np.testing.assert_allclose(pf.numpy(), np.asarray(jf), rtol=2e-5, atol=2e-6)


def test_freeze_and_pin_bandwidth_match_jax():
    particles, x, t = problem()
    js = jdt.Sampler(6, jlogp, kernel="median", data=(jnp.asarray(x), jnp.asarray(t)),
                     phi_impl="xla")
    ps = tdt.Sampler(6, logreg_logp, kernel="median", data=(x, t), phi_impl="torch",
                     device="cpu")
    h = ps.freeze_median_kernel(particles)
    np.testing.assert_allclose(h, js.freeze_median_kernel(jnp.asarray(particles)), rtol=RTOL)
    assert ps.kernel.bandwidth == h and ps.freeze_median_kernel(particles + 5.0) == h
    ps.pin_kernel_bandwidth(0.75)
    assert ps.kernel.bandwidth == 0.75
    with pytest.raises(ValueError, match="needs no freezing"):
        tdt.Sampler(6, logreg_logp, kernel="median_step", data=(x, t),
                    device="cpu").freeze_median_kernel(particles)


def test_set_data_swaps_rows_and_refuses_other_specs():
    particles, x, t = problem()
    ps = tdt.Sampler(6, logreg_logp, data=(x, t), batch_size=8, phi_impl="torch",
                     device="cpu")
    ps._batch_index_seam = lambda step: np.arange(8)
    before, _ = ps.run(20, 1, 0.05, record=False, initial_particles=particles)
    ps.set_data((x[::-1].copy(), t[::-1].copy()))
    after, _ = ps.run(20, 1, 0.05, record=False, initial_particles=particles)
    assert not torch.equal(before, after)
    with pytest.raises(ValueError, match="identical data spec"):
        ps.set_data((x[:10], t[:10]))
    with pytest.raises(ValueError, match="minibatch mode"):
        tdt.Sampler(6, logreg_logp, data=(x, t), device="cpu").set_data((x, t))


@pytest.mark.parametrize("kw,err,match", [
    ({"update_rule": "gauss_seidel", "kernel_approx": "rff"}, ValueError, "kernel_approx requires"),
    ({"kernel_approx": "rff", "phi_impl": "cuda_bf16"}, ValueError, "no kernel tier"),
    ({"update_rule": "sor"}, ValueError, "unknown update_rule"),
    ({"batch_size": 8, "data": None}, ValueError, "requires data"),
    ({"batch_size": 31}, ValueError, "not in"),
    ({"batch_size": 8, "update_rule": "gauss_seidel"}, ValueError, "jacobi"),
    ({"kernel": "median_step", "update_rule": "gauss_seidel"}, ValueError, "jacobi"),
    ({"kernel": "mean"}, ValueError, "unknown kernel"),
    ({"phi_impl": "cuda"}, ValueError, "needs the card"),
    ({"phi_impl": "pallas"}, ValueError, "the port's is 'cuda'"),
    ({"seed": 1.5}, ValueError, "seed must be an int"),
])
def test_sampler_refusals(kw, err, match):
    _, x, t = problem()
    args = dict(data=(x, t), device="cpu")
    args.update(kw)
    with pytest.raises(err, match=match):
        tdt.Sampler(6, logreg_logp, **args)


def test_sampler_run_refusals_and_device_rule():
    particles, x, t = problem()
    ps = tdt.Sampler(6, logreg_logp, data=(x, t), device="cpu")
    ps.run(20, 2, 0.05, dispatch_budget=1.0)  # ported: chunks of whole steps
    assert ps.last_run_stats["execution"] == "monolithic"
    with pytest.raises(ValueError, match="positive"):
        ps.run(20, 2, 0.05, dispatch_budget=0.0)
    with pytest.raises(ValueError, match="needs kernel_approx"):
        ps.approx_residual()  # an exact sampler has no residual (JAX's refusal)
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tdt.Sampler(6, logreg_logp, data=(x, t))
    drawn, _ = ps.run(7, 0, 0.05, seed=3, record=False)
    assert drawn.shape == (7, 6) and drawn.dtype == torch.float32
    torch.testing.assert_close(drawn, tdt.utils.init_particles(3, 7, 6))


@pytest.mark.parametrize("exch_p,exch_s", [(True, False), (True, True), (False, False)])
def test_distsampler_median_step_matches_jax(exch_p, exch_s):
    """kernel='median_step' in the port's DistSampler (every exchange mode;
    partitions re-estimates h per shard from its own block) against JAX's,
    float64, 3 steps."""
    particles, x, t = problem(n=24, rows=48)
    js = jdt.DistSampler(4, jlogp, "median_step", jnp.asarray(particles),
                         data=(jnp.asarray(x), jnp.asarray(t)), exchange_particles=exch_p,
                         exchange_scores=exch_s, include_wasserstein=False, phi_impl="xla")
    ps = tdt.DistSampler(4, logreg_logp, "median_step", particles, data=(x, t),
                         exchange_particles=exch_p, exchange_scores=exch_s,
                         include_wasserstein=False, phi_impl="torch", device="cpu")
    assert isinstance(ps.kernel, tdt.AdaptiveRBF)
    for _ in range(3):
        np.testing.assert_allclose(ps.make_step(0.05).numpy(), np.asarray(js.make_step(0.05)),
                                   rtol=RTOL, atol=ATOL)
