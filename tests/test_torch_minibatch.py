"""Per-shard minibatches, the separate prior and sharded data in the port's
DistSampler, against the JAX DistSampler.

JAX draws its minibatches from threefry streams that torch cannot
reproduce, so the port takes JAX's own indices through its private index
seam: step ``t``'s shard ``r`` draws
``choice(fold_in(fold_in(minibatch_key(seed), t), r), n_local, (B,),
replace=False)``.  If that derivation were wrong the trajectories would
part.  The same numpy particles and data go to both packages; float64
``'torch'`` is held against JAX's ``'xla'`` at ``rtol=1e-10``
(tests/test_minibatch.py), and the float32 bf16 tier's plain versions
against JAX's ``'pallas_bf16'`` under the interpreter."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dist_svgd_tpu as jdt
from dist_svgd_tpu.models.logreg import logreg_likelihood as jlik
from dist_svgd_tpu.models.logreg import logreg_logp as jlogp
from dist_svgd_tpu.models.logreg import logreg_prior as jprior
from dist_svgd_tpu.utils.rng import minibatch_key

import dist_svgd_torch as tdt
from dist_svgd_torch.models.logreg import logreg_likelihood, logreg_logp, logreg_prior
from dist_svgd_torch.utils.interop import state_from_jax
from dist_svgd_torch.utils.rng import minibatch_indices
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)


MODES = [
    ("all_particles", True, False),
    ("all_scores", True, True),
    ("partitions", False, False),
]
S = 4


def problem(d=55, n=16, rows=50, seed=3):
    """Particles and a logreg dataset with d − 1 features, as numpy (50 rows
    over 4 shards: 12 a shard, 2 dropped)."""
    rng = np.random.default_rng(seed)
    particles = 0.3 * rng.normal(size=(n, d))
    x = rng.normal(size=(rows, d - 1))
    t = np.where(rng.normal(size=rows) > 0, 1.0, -1.0)
    return particles, x, t


def jax_indices(seed, t, n_local, batch):
    """JAX's draw for step t, every shard (parallel/exchange.py:_build_core)."""
    key = jax.random.fold_in(minibatch_key(seed), t)
    return np.stack([np.asarray(jax.random.choice(jax.random.fold_in(key, r), n_local,
                                                  (batch,), replace=False))
                     for r in range(S)])


def pair(exch_p, exch_s, batch, prior, shard_data, jax_phi="xla", port_phi="torch",
         dtype=np.float64, seed=5, **kw):
    particles, x, t = problem()
    common = dict(exchange_particles=exch_p, exchange_scores=exch_s,
                  include_wasserstein=kw.pop("include_wasserstein", False),
                  batch_size=batch, shard_data=shard_data, seed=seed, **kw)
    js = jdt.DistSampler(S, jlik if prior else jlogp, None,
                         jnp.asarray(particles.astype(dtype)),
                         data=(jnp.asarray(x.astype(dtype)), jnp.asarray(t.astype(dtype))),
                         log_prior=jprior if prior else None, phi_impl=jax_phi, **common)
    ps = tdt.DistSampler(S, logreg_likelihood if prior else logreg_logp, None,
                         particles.astype(dtype), data=(x, t),
                         log_prior=logreg_prior if prior else None, phi_impl=port_phi,
                         device="cpu", **common)
    if batch is not None:
        ps._batch_index_seam = lambda step: jax_indices(seed, step, 12, batch)
    return js, ps


def run_both(js, ps, rtol, atol, h=None):
    """2 make_step calls then run_steps(2); compare after each."""
    kw = {} if h is None else {"h": h}
    for _ in range(2):
        np.testing.assert_allclose(ps.make_step(0.05, **kw).numpy(),
                                   np.asarray(js.make_step(0.05, **kw)), rtol=rtol, atol=atol)
    np.testing.assert_allclose(ps.run_steps(2, 0.05, **kw).numpy(),
                               np.asarray(js.run_steps(2, 0.05, **kw)), rtol=rtol, atol=atol)
    assert ps.t == js.t == 4


@pytest.mark.parametrize("prior", [False, True])
@pytest.mark.parametrize("name,exch_p,exch_s,shard_data",
                         [m + (False,) for m in MODES] + [m + (True,) for m in MODES[:2]])
def test_minibatched_matches_jax_xla_f64(name, exch_p, exch_s, shard_data, prior):
    """Every mode, with and without the separate prior, with replicated and
    (all_* modes; partitions refuses it) sharded data."""
    js, ps = pair(exch_p, exch_s, 5, prior, shard_data)
    assert ps.mode == js.mode == name
    run_both(js, ps, rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("name,exch_p,exch_s", MODES)
def test_separate_prior_full_batch_matches_jax(name, exch_p, exch_s):
    """log_prior without minibatches: the prior is added once, after the
    psum or the importance scale, in every mode."""
    js, ps = pair(exch_p, exch_s, None, True, False)
    run_both(js, ps, rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("name,exch_p,exch_s", MODES)
def test_bf16_tier_minibatched_matches_jax_pallas_bf16(name, exch_p, exch_s):
    """phi_impl='cuda_bf16' on the CPU (the bf16x3 plain version, float32)
    against JAX's 'pallas_bf16' under the interpreter, with a minibatch and
    the prior: the φ of each step agrees to ~1e-5 of its size (float32 sums
    in other orders, under the Gram diagonal's cancellation), so four steps
    stay within 1e-4 of max|θ| — the card's trajectory bound."""
    js, ps = pair(exch_p, exch_s, 5, True, False, jax_phi="pallas_bf16",
                  port_phi="cuda_bf16", dtype=np.float32)
    for _ in range(2):
        ps.make_step(0.05)
        js.make_step(0.05)
    ps.run_steps(2, 0.05)
    js.run_steps(2, 0.05)
    want = np.asarray(js.particles)
    assert ps.particles.dtype == torch.float32
    assert np.abs(ps.particles.numpy() - want).max() <= 1e-4 * np.abs(want).max()


@pytest.mark.parametrize("name,exch_p,exch_s", MODES)
def test_w2_composes_with_minibatches(name, exch_p, exch_s):
    """The Sinkhorn W2 term on a minibatched, prior-separated run: particles,
    snapshots and duals after four steps, against JAX."""
    js, ps = pair(exch_p, exch_s, 5, True, False, include_wasserstein=True,
                  wasserstein_solver="sinkhorn", sinkhorn_iters=40)
    js.run_steps(4, 0.05, h=0.5)
    ps.run_steps(4, 0.05, h=0.5)
    np.testing.assert_allclose(ps.particles.numpy(), np.asarray(js.particles),
                               rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(ps._previous.numpy(), np.asarray(js._previous),
                               rtol=1e-10, atol=1e-12)


def test_full_batch_equals_unbatched_run():
    """B = n_local draws a permutation of each shard's rows at scale 1: the
    same trajectory as the run without minibatches."""
    particles, x, t = problem(d=5, rows=48)
    runs = []
    for batch in (None, 12):
        ds = tdt.DistSampler(S, logreg_likelihood, None, particles, data=(x, t),
                             exchange_particles=True, exchange_scores=False,
                             include_wasserstein=False, batch_size=batch,
                             log_prior=logreg_prior, phi_impl="torch", device="cpu")
        runs.append(ds.run_steps(4, 0.05).numpy())
    np.testing.assert_allclose(runs[1], runs[0], rtol=1e-12, atol=1e-14)


def test_resume_continues_the_minibatch_stream():
    """A run saved at step 2 and resumed by a sampler built with another
    seed draws what the uninterrupted run drew: the stream is keyed by
    (seed, t) and the seed rides state_dict."""
    particles, x, t = problem(d=7, rows=48)

    def make(seed, init=particles):
        return tdt.DistSampler(S, logreg_likelihood, None, init, data=(x, t),
                               exchange_particles=True, exchange_scores=False,
                               include_wasserstein=False, batch_size=4,
                               log_prior=logreg_prior, seed=seed, device="cpu")

    whole = make(11)
    whole.run_steps(5, 0.05)
    first = make(11)
    first.run_steps(2, 0.05)
    state = first.state_dict()
    assert int(state["rng_batch_seed"]) == 11
    resumed = make(99, np.zeros_like(particles))
    resumed.load_state_dict(state)
    torch.testing.assert_close(resumed.run_steps(3, 0.05), whole.particles, rtol=0, atol=0)
    other = make(12)
    other.run_steps(5, 0.05)
    assert not torch.equal(other.particles, whole.particles)


def test_minibatch_indices_stream():
    a = minibatch_indices(3, 7, 8, 5625, 256)
    assert a.shape == (8, 256) and a.dtype == torch.int64
    assert int(a.min()) >= 0 and int(a.max()) < 5625
    assert all(len(set(row.tolist())) == 256 for row in a)  # without replacement
    torch.testing.assert_close(a, minibatch_indices(3, 7, 8, 5625, 256), rtol=0, atol=0)
    assert not torch.equal(a, minibatch_indices(3, 8, 8, 5625, 256))
    assert not torch.equal(a, minibatch_indices(4, 7, 8, 5625, 256))
    assert not torch.equal(a[0], a[1])
    # every row is uniform over its local rows: first-position counts are flat
    firsts = torch.cat([minibatch_indices(0, t, 8, 10, 1)[:, 0] for t in range(500)])
    counts = torch.bincount(firsts, minlength=10).double()
    assert float(counts.min()) > 0.6 * 400 and float(counts.max()) < 1.4 * 400
    with pytest.raises(ValueError, match="local rows"):
        minibatch_indices(0, 1, 2, 10, 11)


def test_validation_matches_jax():
    """batch_size outside (0, n_local], shard_data in partitions and a
    non-int seed raise ValueError, as in JAX."""
    particles, x, t = problem(d=3)
    base = dict(exchange_particles=True, exchange_scores=False, include_wasserstein=False)
    for bad in (0, 13):
        with pytest.raises(ValueError, match="local rows"):
            jdt.DistSampler(S, jlogp, None, jnp.asarray(particles),
                            data=(jnp.asarray(x), jnp.asarray(t)), batch_size=bad, **base)
        with pytest.raises(ValueError, match="local rows"):
            tdt.DistSampler(S, logreg_logp, None, particles, data=(x, t), batch_size=bad,
                            device="cpu", **base)
    part = dict(base, exchange_particles=False)
    with pytest.raises(ValueError, match="partitions"):
        jdt.DistSampler(S, jlogp, None, jnp.asarray(particles),
                        data=(jnp.asarray(x), jnp.asarray(t)), shard_data=True, **part)
    with pytest.raises(ValueError, match="partitions"):
        tdt.DistSampler(S, logreg_logp, None, particles, data=(x, t), shard_data=True,
                        device="cpu", **part)
    with pytest.raises(ValueError, match="batch_size"):
        tdt.DistSampler(S, logreg_logp, None, particles, batch_size=2, device="cpu", **base)
    with pytest.raises(ValueError, match="seed must be an int"):
        tdt.DistSampler(S, logreg_logp, None, particles, data=(x, t), seed="0",
                        device="cpu", **base)


@pytest.mark.parametrize("name,exch_p,exch_s", MODES)
def test_minibatched_state_carried_from_jax(name, exch_p, exch_s):
    """A minibatched JAX run's state converts (its rng_batch_key is dropped):
    with JAX's indices through the seam the port continues JAX's trajectory;
    without them it continues on its own stream from its own seed."""
    js, ps = pair(exch_p, exch_s, 5, True, False)
    js.run_steps(3, 0.05)
    jstate = {k: (None if v is None else np.asarray(v)) for k, v in js.state_dict().items()}
    assert jstate["rng_batch_key"] is not None
    state = state_from_jax(jstate, "cpu", sampler=ps)
    assert "rng_batch_key" not in state and "rng_batch_seed" not in state
    ps.load_state_dict(state)
    assert ps.t == 3 and ps._seed == 5
    np.testing.assert_allclose(ps.run_steps(2, 0.05).numpy(),
                               np.asarray(js.run_steps(2, 0.05)), rtol=1e-10, atol=1e-12)
    _, own = pair(exch_p, exch_s, 5, True, False, seed=21)
    own._batch_index_seam = None
    own.load_state_dict(state)
    assert own._seed == 21
    twin = tdt.DistSampler(S, logreg_likelihood, None, np.array(jstate["particles"]),
                           data=own._data, exchange_particles=exch_p, exchange_scores=exch_s,
                           include_wasserstein=False, batch_size=5, log_prior=logreg_prior,
                           phi_impl="torch", seed=21, device="cpu")
    twin.load_state_dict({**twin.state_dict(), "t": np.asarray(3)})
    torch.testing.assert_close(own.run_steps(2, 0.05), twin.run_steps(2, 0.05),
                               rtol=0, atol=0)
