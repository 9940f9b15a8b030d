"""The port's lagged exchange (``DistSampler(exchange_every=T)``) against
JAX's (``tests/test_lagged.py``), on the CPU, float64.

JAX's lagged macro-step draws sub-step i's minibatch from
``fold_in(fold_in(fold_in(root, t), i), r)`` (t the macro-step's first
counter); the port draws step u from ``(seed, u)``.  The parity tests
inject JAX's indices through ``ds._batch_index_seam`` and hold the port to
JAX at 1e-10 (the 'torch' φ against 'xla', summation order only); the loop
oracle is JAX's own at 1e-10 here (float64 throughout)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import dist_svgd_tpu as jdt
from dist_svgd_tpu.models.gmm import gmm_logp as jgmm_logp
from dist_svgd_tpu.models.logreg import make_logreg_split as jmake_logreg_split
from dist_svgd_tpu.utils.rng import minibatch_key

import dist_svgd_torch as tdt
from dist_svgd_torch.models.gmm import gmm_logp
from dist_svgd_torch.models.logreg import make_logreg_split
from dist_svgd_torch.ops import cuda_svgd
from dist_svgd_torch.ops.kernels import RBF
from dist_svgd_torch.parallel.exchange import make_shard_step_lagged

from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

#: the port against JAX in float64 ('torch' φ against 'xla').
RTOL, ATOL = 1e-10, 1e-12


def _make(init, T, S=4, **kw):
    kw.setdefault("phi_impl", "torch")
    return tdt.DistSampler(S, lambda th, _=None: gmm_logp(th), None, init,
                           exchange_particles=True, exchange_scores=False,
                           include_wasserstein=False, exchange_every=T, device="cpu", **kw)


def _jmake(init, T, S=4, **kw):
    return jdt.DistSampler(S, lambda th, _=None: jgmm_logp(th), None, jnp.asarray(init),
                           exchange_particles=True, exchange_scores=False,
                           include_wasserstein=False, exchange_every=T, phi_impl="xla",
                           mesh=None, **kw)


def jax_lagged_indices(seed, T, S, n_local, batch):
    """JAX's indices of absolute step u under the lagged exchange."""
    root = minibatch_key(seed)

    def idx(u):
        t0 = u - (u - 1) % T  # the macro-step's first counter
        key = jax.random.fold_in(jax.random.fold_in(root, t0), u - t0)
        return np.stack([np.asarray(jax.random.choice(jax.random.fold_in(key, r), n_local,
                                                      (batch,), replace=False))
                         for r in range(S)])

    return idx


@pytest.mark.parametrize("T", [1, 2, 3])
def test_lagged_macro_at_t1_and_sampler_match_jax(T):
    """T = 1 is the per-step all_particles step; T = 2, 3 the lagged
    trajectory, in both packages."""
    init = np.random.default_rng(31).normal(size=(16, 2))
    if T == 1:
        macro = make_shard_step_lagged(lambda th, _=None: gmm_logp(th), RBF(1.0), 4, 1.0, 1,
                                       phi_impl="torch")
        got = macro(torch.from_numpy(init).reshape(4, 4, 2), None, 1, 0.2, lambda u: None)
        ref = tdt.DistSampler(4, lambda th, _=None: gmm_logp(th), None, init,
                              exchange_particles=True, exchange_scores=False,
                              include_wasserstein=False, phi_impl="torch", device="cpu")
        np.testing.assert_allclose(got.reshape(16, 2).numpy(), ref.make_step(0.2).numpy(),
                                   rtol=1e-12)
        return
    ps, js = _make(init, T), _jmake(init, T)
    np.testing.assert_allclose(ps.run_steps(2 * T, 0.1).numpy(),
                               np.asarray(js.run_steps(2 * T, 0.1)), rtol=RTOL, atol=ATOL)
    assert ps.t == js.t == 2 * T


def test_lagged_matches_loop_oracle():
    """T = 2: refresh the stale set every T steps, update each block against
    the stale set with its own block live (JAX test_lagged's oracle)."""
    S, n, d, T = 4, 16, 2, 2
    init = np.random.default_rng(31).normal(size=(n, d))
    ds = _make(init, T)
    got = ds.run_steps(4, 0.1).numpy()
    score = jax.vmap(jax.grad(jgmm_logp))
    blocks = [init[i * 4:(i + 1) * 4].copy() for i in range(S)]
    for _ in range(2):
        stale = np.concatenate(blocks)
        for _ in range(T):
            new = []
            for r in range(S):
                view = stale.copy()
                view[r * 4:(r + 1) * 4] = blocks[r]
                s = np.asarray(score(jnp.asarray(view)))
                kt = np.exp(-((view[None] - blocks[r][:, None]) ** 2).sum(-1))
                repulse = 2 * (blocks[r] * kt.sum(1, keepdims=True) - kt @ view)
                new.append(blocks[r] + 0.1 * (kt @ s + repulse) / n)
            blocks = new
    np.testing.assert_allclose(got, np.concatenate(blocks), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("T", [2, 4])
def test_lagged_minibatch_prior_matches_jax_with_its_indices(T):
    rng = np.random.default_rng(7)
    S, seed, batch = 4, 9, 3
    parts = rng.normal(size=(16, 3))
    x = rng.normal(size=(40, 2))
    t = np.where(rng.normal(size=40) > 0, 1.0, -1.0)
    lik, prior = make_logreg_split()
    jlik, jprior = jmake_logreg_split()
    common = dict(exchange_particles=True, exchange_scores=False, include_wasserstein=False,
                  exchange_every=T, batch_size=batch, seed=seed)
    js = jdt.DistSampler(S, jlik, None, jnp.asarray(parts),
                         data=(jnp.asarray(x), jnp.asarray(t)), log_prior=jprior,
                         phi_impl="xla", mesh=None, **common)
    ps = tdt.DistSampler(S, lik, None, parts, data=(x, t), log_prior=prior,
                         phi_impl="torch", device="cpu", **common)
    ps._batch_index_seam = jax_lagged_indices(seed, T, S, 10, batch)
    np.testing.assert_allclose(ps.run_steps(2 * T, 0.05).numpy(),
                               np.asarray(js.run_steps(2 * T, 0.05)), rtol=RTOL, atol=ATOL)


def test_lagged_record_history_matches_jax():
    """record=True: the per-sub-step pre-update global state, as JAX emits
    it; reruns without record reproduce it at the macro boundaries."""
    T, n = 2, 16
    init = np.random.default_rng(5).normal(size=(n, 2))
    final, hist = _make(init, T).run_steps(6, 0.1, record=True)
    jfinal, jhist = _jmake(init, T).run_steps(6, 0.1, record=True)
    assert hist.shape == (6, n, 2)
    np.testing.assert_allclose(hist.numpy(), np.asarray(jhist), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(final.numpy(), np.asarray(jfinal), rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(hist[0].numpy(), init)
    again = _make(init, T)
    for k in (2, 4):
        again.run_steps(2, 0.1)
        torch.testing.assert_close(hist[k], again.particles, rtol=0, atol=0)
    assert not torch.equal(hist[1], hist[0])


def test_lagged_record_chunks_whole_macro_steps(monkeypatch):
    """A history chunk of 4 rounds down to 3 (the cadence): 3 + 3 + 3 to
    the host, the same history (JAX test_record_chunking.py:73); a chunk
    under the cadence is forced up to it with a warning."""
    from dist_svgd_torch.utils import history

    init = np.random.default_rng(0).normal(size=(32, 2))
    want_final, want_hist = _make(init, 3).run_steps(9, 0.05, record=True)
    monkeypatch.setattr(history, "record_chunk_steps", lambda n, d, itemsize=4: 4)
    ds = _make(init, 3)
    got_final, got_hist = ds.run_steps(9, 0.05, record=True)
    assert ds.last_run_stats["record_chunks_to_host"] == 3
    np.testing.assert_array_equal(got_hist, want_hist.numpy())
    torch.testing.assert_close(got_final, want_final, rtol=0, atol=0)
    monkeypatch.setattr(history, "record_chunk_steps", lambda n, d, itemsize=4: 2)
    with pytest.warns(UserWarning, match="forced up"):
        _, small = _make(init, 3).run_steps(9, 0.05, record=True)
    np.testing.assert_array_equal(small, want_hist.numpy())


def test_lagged_one_gather_and_one_phi_call_a_step(monkeypatch):
    """One φ call a sub-step, all S per-lane views ``(S, n, d)`` at once."""
    init = np.random.default_rng(1).normal(size=(16, 3)).astype(np.float32)
    shapes = []
    real = cuda_svgd.phi_cuda

    def spy(y, x, s, *a, **k):
        shapes.append((tuple(y.shape), tuple(x.shape)))
        return real(y, x, s, *a, **k)

    monkeypatch.setattr(cuda_svgd, "phi_cuda", spy)
    ds = _make(init, 2, phi_impl="auto")
    ds.run_steps(4, 0.1)
    assert shapes == [((4, 4, 3), (4, 16, 3))] * 4
    assert ds.last_run_stats["num_dispatches"] == 2  # two macro-steps


def test_lagged_refusals_match_jax():
    init = np.random.default_rng(2).normal(size=(16, 2))
    for mod, kw in ((tdt, dict(device="cpu")), (jdt, {})):
        arr = init if mod is tdt else jnp.asarray(init)
        logp = (lambda th, _=None: gmm_logp(th)) if mod is tdt else (
            lambda th, _=None: jgmm_logp(th))
        for extra, match in ((dict(exchange_scores=True), "all_particles"),
                             (dict(exchange_impl="ring"), "gather"),
                             (dict(include_wasserstein=True, wasserstein_solver="sinkhorn"),
                              "Wasserstein"),
                             (dict(update_rule="gauss_seidel"), "jacobi")):
            args = dict(exchange_particles=True, exchange_scores=False,
                        include_wasserstein=False, exchange_every=2, **kw)
            args.update(extra)
            with pytest.raises(ValueError, match=match):
                mod.DistSampler(4, logp, None, arr, **args)
    with pytest.raises(ValueError, match=">= 1"):
        _make(init, 0)
    ds = _make(init, 2)
    with pytest.raises(ValueError, match="run_steps"):
        ds.make_step(0.1)
    with pytest.raises(ValueError, match="multiple"):
        ds.run_steps(3, 0.1)
    with pytest.raises(ValueError, match="lagged"):
        ds.run_steps(2, 0.1, hops_per_dispatch=1)
