"""The reference's literal Gauss–Seidel sweep in the port: the
single-device ``ops/svgd.py:svgd_step_sequential`` and
``Sampler(update_rule='gauss_seidel')``, and the distributed step
``parallel/exchange.py:_build_gs_step`` behind
``DistSampler(update_rule='gauss_seidel')`` — without the W2 term, with the
host-LP W2 (``make_step``) and with the Sinkhorn W2 (``run_steps``) —
against the JAX package and the float64 oracle ``tests/_oracle.py``.

Tolerances: trajectories at JAX's own 1e-10 (float64, the port's
``phi_impl='torch'`` against JAX's ``'xla'``: the same arithmetic); the
oracle at 1e-9 as tests/test_svgd_step.py (its loops sum in another
order); the host-LP W2 against the oracle at JAX's rtol=1e-6, atol=1e-8
(the LP's vertex solution, tests/test_distsampler.py); the scanned
Sinkhorn GS+W2 against the eager one at JAX's rtol=2e-6; the shared
fixed point at JAX's abs=0.05 on the moments."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import dist_svgd_tpu as jdt
from dist_svgd_tpu.models.gmm import gmm_logp as jgmm
from dist_svgd_tpu.models.logreg import logreg_logp as jlogreg_logp
from dist_svgd_tpu.ops.kernels import RBF as JRBF
from dist_svgd_tpu.ops.svgd import svgd_step_sequential as jsweep

import dist_svgd_torch as tdt
from dist_svgd_torch.models.gmm import gmm_logp
from dist_svgd_torch.models.logreg import logreg_logp
from dist_svgd_torch.ops import cuda_svgd
from dist_svgd_torch.ops.kernels import RBF
from dist_svgd_torch.ops.svgd import svgd_step, svgd_step_sequential

from _oracle import RefDistOracle, gauss_seidel_sweep
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

RTOL, ATOL = 1e-10, 1e-12
MODES = [("all_particles", True, False), ("all_scores", True, True),
         ("partitions", False, False)]


def gaussian_logp(mu, prec):
    return lambda th: -0.5 * prec * torch.sum((th - mu) ** 2)


def jgaussian_logp(mu, prec):
    return lambda th: -0.5 * prec * jnp.sum((th - mu) ** 2)


def test_sweep_matches_jax_and_oracle():
    """One sweep: row i sees rows < i moved, scores fresh at current values
    (reference dsvgd/sampler.py:62-68)."""
    parts = np.random.default_rng(7).normal(size=(5, 2))
    mu, prec = -0.5, 1.3
    got = svgd_step_sequential(torch.as_tensor(parts), torch.func.grad(gaussian_logp(mu, prec)),
                               0.05, RBF(1.0)).numpy()
    want = np.asarray(jsweep(jnp.asarray(parts), jax.grad(jgaussian_logp(mu, prec)), 0.05,
                             JRBF(1.0)))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    oracle = gauss_seidel_sweep(parts, lambda x: -prec * (np.asarray(x) - mu), 0.05)
    np.testing.assert_allclose(got, oracle, rtol=1e-9, atol=1e-11)


def test_sweep_leaves_its_input_alone_and_differs_from_jacobi():
    parts = torch.as_tensor(np.random.default_rng(8).normal(size=(6, 2)))
    before = parts.clone()
    score = torch.func.grad(gaussian_logp(1.0, 0.7))
    gs = svgd_step_sequential(parts, score, 0.1)
    torch.testing.assert_close(parts, before, rtol=0, atol=0)
    jac = svgd_step(parts, torch.func.vmap(score)(parts), 0.1)
    torch.testing.assert_close(gs[0], jac[0], rtol=1e-12, atol=0)  # row 0 sees no update
    assert not torch.allclose(gs, jac)


def test_gauss_seidel_and_jacobi_share_fixed_point():
    """Different trajectories, one fixed point (JAX's test: 30 particles on
    a 1-D Gaussian, 300 steps of 0.3, moments within 0.05)."""
    parts = torch.as_tensor(np.random.default_rng(7).normal(size=(30, 1)))
    score = torch.func.grad(gaussian_logp(2.0, 1.0))
    batched = torch.func.vmap(score)
    jac, gs = parts, parts
    for _ in range(300):
        jac = svgd_step(jac, batched(jac), 0.3)
        gs = svgd_step_sequential(gs, score, 0.3)
    assert float(jac.mean()) == pytest.approx(float(gs.mean()), abs=0.05)
    assert float(jac.std()) == pytest.approx(float(gs.std()), abs=0.05)


def _logreg_problem(n=10, d=3, rows=20, seed=9):
    rng = np.random.default_rng(seed)
    return (0.5 * rng.normal(size=(n, d)), rng.normal(size=(rows, d - 1)),
            np.where(rng.normal(size=rows) > 0, 1.0, -1.0))


@pytest.mark.parametrize("model", ["gmm", "logreg", "logreg_median"])
def test_sampler_gauss_seidel_matches_jax(model):
    """``Sampler(update_rule='gauss_seidel')``: the history of four sweeps
    on the GMM (d = 1) and on logreg with data (the fixed and the per-run
    median bandwidth)."""
    if model == "gmm":
        init = np.random.default_rng(10).normal(size=(12, 1))
        js, ps = jdt.Sampler(1, jgmm, update_rule="gauss_seidel"), tdt.Sampler(
            1, gmm_logp, update_rule="gauss_seidel", device="cpu")
    else:
        init, x, t = _logreg_problem()
        kernel = "median" if model == "logreg_median" else None
        js = jdt.Sampler(3, jlogreg_logp, kernel=kernel, update_rule="gauss_seidel",
                         data=(jnp.asarray(x), jnp.asarray(t)))
        ps = tdt.Sampler(3, logreg_logp, kernel=kernel, update_rule="gauss_seidel",
                         data=(x, t), device="cpu")
    _, want = js.run(len(init), 4, 0.05, initial_particles=jnp.asarray(init))
    _, got = ps.run(len(init), 4, 0.05, initial_particles=init)
    assert got.shape == (5, *init.shape)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


def test_sampler_gauss_seidel_launches_no_kernel(monkeypatch):
    """The single-device sweep calls the plain φ, never the φ policy."""
    calls = []
    monkeypatch.setattr(cuda_svgd, "phi_cuda", lambda *a, **k: calls.append(a))
    ps = tdt.Sampler(1, gmm_logp, update_rule="gauss_seidel", device="cpu")
    ps.run(6, 2, 0.5, initial_particles=np.linspace(-1.0, 1.0, 6)[:, None])
    assert calls == []


def _dist_problem(S, n=8, d=2, rows=24, seed=11):
    """Particles, data and the oracle's per-rank score (logreg on the
    rank's contiguous data slice)."""
    rng = np.random.default_rng(seed)
    particles = rng.normal(size=(n, d))
    x = rng.normal(size=(rows, d - 1))
    t = np.where(rng.normal(size=rows) > 0, 1.0, -1.0)
    per = rows // S
    grad = jax.grad(jlogreg_logp)

    def score_of(rank, theta):
        sl = slice(rank * per, (rank + 1) * per)
        return np.asarray(grad(jnp.asarray(theta), (jnp.asarray(x[sl]), jnp.asarray(t[sl]))))

    return particles, x, t, score_of


def _pair(S, particles, x, t, exch_p, exch_s, **kw):
    common = dict(exchange_particles=exch_p, exchange_scores=exch_s,
                  update_rule="gauss_seidel", **kw)
    js = jdt.DistSampler(S, jlogreg_logp, None, jnp.asarray(particles),
                         data=(jnp.asarray(x), jnp.asarray(t)), phi_impl="xla", **common)
    ps = tdt.DistSampler(S, logreg_logp, None, particles, data=(x, t), phi_impl="torch",
                         device="cpu", **common)
    return js, ps


@pytest.mark.parametrize("S", [1, 2, 4])
@pytest.mark.parametrize("name,exch_p,exch_s", MODES)
def test_distsampler_gauss_seidel_matches_jax_and_oracle(name, exch_p, exch_s, S):
    """Three GS steps of every mode, S ∈ {1, 2, 4}, no W2 (JAX
    ``test_modes_match_oracle``'s GS half).  At S = 1 ``all_scores`` has no
    exchange, and the oracle (like the reference, which reads an unfilled
    score buffer there) scores each pair fresh, where JAX and the port
    freeze the mode's scores for the step (JAX
    ``test_single_shard_equals_global_step``): there JAX alone is the
    reference."""
    particles, x, t, score_of = _dist_problem(S)
    js, ps = _pair(S, particles, x, t, exch_p, exch_s, include_wasserstein=False)
    oracle = RefDistOracle(S, score_of, particles, exchange_particles=exch_p,
                           exchange_scores=exch_s, score_scale=S if not exch_s else 1.0,
                           update_rule="gauss_seidel")
    for _ in range(3):
        got = ps.make_step(0.05).numpy()
        np.testing.assert_allclose(got, np.asarray(js.make_step(0.05)), rtol=RTOL, atol=ATOL)
        want = oracle.make_step(0.05)
        if S > 1 or not exch_s:
            np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-11)
    assert ps.mode == js.mode == name


@pytest.mark.parametrize("name,exch_p,exch_s", MODES)
def test_distsampler_gauss_seidel_lp_w2_matches_jax_and_oracle(name, exch_p, exch_s):
    """GS with the host-LP W2 term through make_step (JAX
    ``test_wasserstein_gauss_seidel_matches_oracle``): the gradient solved
    once from the pre-sweep block, applied row by row."""
    particles, x, t, score_of = _dist_problem(2, n=6, rows=8, seed=23)
    js, ps = _pair(2, particles, x, t, exch_p, exch_s, include_wasserstein=True,
                   wasserstein_solver="lp")
    oracle = RefDistOracle(2, score_of, particles, exchange_particles=exch_p,
                           exchange_scores=exch_s, include_wasserstein=True,
                           score_scale=2 if not exch_s else 1.0, update_rule="gauss_seidel")
    for _ in range(3):
        got = ps.make_step(0.05, h=0.5).numpy()
        np.testing.assert_allclose(got, np.asarray(js.make_step(0.05, h=0.5)), rtol=RTOL,
                                   atol=ATOL)
        np.testing.assert_allclose(got, oracle.make_step(0.05, h=0.5), rtol=1e-6, atol=1e-8)
    np.testing.assert_allclose(ps._previous.numpy(), np.asarray(js._previous), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("name,exch_p,exch_s", MODES)
def test_distsampler_gauss_seidel_sinkhorn_w2(name, exch_p, exch_s):
    """GS with the Sinkhorn W2 term: run_steps equals the eager make_step
    trajectory (snapshots too) and then keeps to it, as in JAX
    (``test_run_steps_wasserstein_gauss_seidel_matches_eager``), and
    equals JAX's scanned run."""
    particles, x, t, _ = _dist_problem(2, n=8, rows=8, seed=37)
    kw = dict(include_wasserstein=True, wasserstein_solver="sinkhorn", sinkhorn_eps=0.05,
              sinkhorn_iters=50)
    js, eager = _pair(2, particles, x, t, exch_p, exch_s, **kw)
    _, scanned = _pair(2, particles, x, t, exch_p, exch_s, **kw)
    for _ in range(4):
        want = eager.make_step(0.05, h=0.5)
    got = scanned.run_steps(4, 0.05, h=0.5)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-6)
    np.testing.assert_allclose(scanned._previous.numpy(), eager._previous.numpy(),
                               rtol=2e-6, atol=1e-12)
    np.testing.assert_allclose(got.numpy(), np.asarray(js.run_steps(4, 0.05, h=0.5)),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(scanned.make_step(0.05, h=0.5).numpy(),
                               eager.make_step(0.05, h=0.5).numpy(), rtol=2e-6)


def test_run_steps_equals_eager_gauss_seidel():
    particles, x, t, _ = _dist_problem(2, n=6, rows=8, seed=29)
    _, eager = _pair(2, particles, x, t, True, False, include_wasserstein=False)
    _, scanned = _pair(2, particles, x, t, True, False, include_wasserstein=False)
    for _ in range(4):
        eager.make_step(0.05)
    torch.testing.assert_close(scanned.run_steps(4, 0.05), eager.particles, rtol=0, atol=0)


@pytest.mark.parametrize("name,exch_p,exch_s", MODES)
def test_distsampler_gauss_seidel_one_phi_call_a_row(name, exch_p, exch_s, monkeypatch):
    """All S shards' row i move in one φ call: a step of s rows a shard
    makes s calls, each on (S, 1, d) against (S, m, d) — what reaches the
    hand kernel once a row and step on the card (phi_impl='auto')."""
    S, n = 4, 16
    particles, x, t, _ = _dist_problem(S, n=n, seed=41)
    shapes = []
    real = cuda_svgd.phi_cuda

    def spy(y, xi, s, *a, **k):
        shapes.append((tuple(y.shape), tuple(xi.shape)))
        return real(y, xi, s, *a, **k)

    monkeypatch.setattr(cuda_svgd, "phi_cuda", spy)
    ps = tdt.DistSampler(S, logreg_logp, None, particles.astype(np.float32), data=(x, t),
                         exchange_particles=exch_p, exchange_scores=exch_s,
                         include_wasserstein=False, update_rule="gauss_seidel",
                         device="cpu")
    ps.make_step(0.05)
    m = n if exch_p else n // S
    assert shapes == [((S, 1, 2), (S, m, 2))] * (n // S)


def test_gauss_seidel_constraints():
    """JAX's constraints: the gather implementation, no minibatch, no
    kernel_approx, a fixed bandwidth; and the single-device sweep refuses a
    forced hand kernel, which it would never launch."""
    parts = np.zeros((4, 1))
    kw = dict(include_wasserstein=False, update_rule="gauss_seidel", device="cpu")
    lp = lambda th, _: gmm_logp(th)  # noqa: E731
    with pytest.raises(ValueError, match="gather"):
        tdt.DistSampler(2, lp, None, parts, exchange_impl="ring", **kw)
    with pytest.raises(ValueError, match="jacobi"):
        tdt.DistSampler(2, lp, None, parts, data=np.zeros((8, 1)), batch_size=2, **kw)
    with pytest.raises(ValueError, match="kernel_approx requires"):
        tdt.DistSampler(2, lp, None, parts, kernel_approx="rff", **kw)
    with pytest.raises(ValueError, match="median_step"):
        tdt.DistSampler(2, lp, "median_step", parts, **kw)
    with pytest.raises(ValueError, match="update_rule"):
        tdt.DistSampler(2, lp, None, parts, include_wasserstein=False, update_rule="typo",
                        device="cpu")
    for impl in ("cuda", "cuda_bf16"):
        with pytest.raises(ValueError, match="requires update_rule='jacobi'"):
            tdt.Sampler(1, gmm_logp, update_rule="gauss_seidel", phi_impl=impl, device="cpu")
    with pytest.raises(ValueError, match="median_step"):
        tdt.Sampler(1, gmm_logp, kernel="median_step", update_rule="gauss_seidel",
                    device="cpu")
