"""The port's DistSampler against the JAX DistSampler and the float64
oracle (tests/_oracle.py), on the CPU.

The same numpy particles and data go to both packages.  phi_impl='torch'
(float64) is held against JAX's 'xla' at 1e-10; phi_impl='auto' on the
CPU — the hand kernels' plain versions, float32 — against JAX's 'pallas'
under the interpreter at test_pallas.py's tolerance."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import dist_svgd_tpu as jdt
from dist_svgd_tpu.models.logreg import logreg_logp as jlogreg_logp

import dist_svgd_torch as tdt
from dist_svgd_torch.models.logreg import logreg_logp
from dist_svgd_torch.utils.checkpoint import TopologyMismatch
from dist_svgd_torch.utils.interop import state_from_jax

from _oracle import RefDistOracle

MODES = [
    ("all_particles", True, False),
    ("all_scores", True, True),
    ("partitions", False, False),
]


def problem(d, n=64, rows=48, seed=11):
    """Particles and a logreg dataset with d−1 features, as numpy."""
    rng = np.random.default_rng(seed)
    particles = rng.normal(size=(n, d))
    x = rng.normal(size=(rows, d - 1))
    t = np.where(rng.normal(size=rows) > 0, 1.0, -1.0)
    return particles, x, t


def jax_sampler(S, particles, x, t, exch_p, exch_s, phi_impl, dtype=np.float64, **kw):
    return jdt.DistSampler(
        S, jlogreg_logp, None, jnp.asarray(particles.astype(dtype)),
        data=(jnp.asarray(x.astype(dtype)), jnp.asarray(t.astype(dtype))),
        exchange_particles=exch_p, exchange_scores=exch_s,
        include_wasserstein=False, phi_impl=phi_impl, **kw)


def port_sampler(S, particles, x, t, exch_p, exch_s, phi_impl, dtype=np.float64, **kw):
    return tdt.DistSampler(
        S, logreg_logp, None, particles.astype(dtype), data=(x, t),
        exchange_particles=exch_p, exchange_scores=exch_s,
        include_wasserstein=False, phi_impl=phi_impl, device="cpu", **kw)


def run_both(js, ps, rtol, atol):
    """3 make_step calls then run_steps(3) on both; compare after each."""
    for _ in range(3):
        np.testing.assert_allclose(ps.make_step(0.05).numpy(),
                                   np.asarray(js.make_step(0.05)), rtol=rtol, atol=atol)
    np.testing.assert_allclose(ps.run_steps(3, 0.05).numpy(),
                               np.asarray(js.run_steps(3, 0.05)), rtol=rtol, atol=atol)
    assert ps.t == js.t == 6


@pytest.mark.parametrize("d", [3, 12])
@pytest.mark.parametrize("S", [4, 8])
@pytest.mark.parametrize("name,exch_p,exch_s", MODES)
def test_torch_phi_matches_jax_xla_f64(name, exch_p, exch_s, S, d):
    particles, x, t = problem(d)
    js = jax_sampler(S, particles, x, t, exch_p, exch_s, "xla")
    ps = port_sampler(S, particles, x, t, exch_p, exch_s, "torch")
    assert ps.mode == js.mode == name
    run_both(js, ps, rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("d", [3, 12])
@pytest.mark.parametrize("name,exch_p,exch_s", MODES)
def test_auto_plain_kernels_match_jax_pallas_interpret_f32(name, exch_p, exch_s, d):
    particles, x, t = problem(d, n=32, rows=32)
    js = jax_sampler(4, particles, x, t, exch_p, exch_s, "pallas", dtype=np.float32)
    ps = port_sampler(4, particles, x, t, exch_p, exch_s, "auto", dtype=np.float32)
    assert ps.particles.dtype == torch.float32
    run_both(js, ps, rtol=2e-5, atol=2e-6)


def _numpy_logreg_score(theta, x, t):
    """∇_θ logreg_logp in closed form, float64."""
    alpha, w = np.exp(theta[0]), theta[1:]
    k = w.shape[0]
    z = (x @ w) * t
    sig = 1.0 / (1.0 + np.exp(z))  # σ(−z)
    g0 = -alpha + 0.5 * k - 0.5 * alpha * (w @ w)
    return np.concatenate([[g0], -alpha * w + (sig * t) @ x])


@pytest.mark.parametrize("name,exch_p,exch_s", MODES)
def test_modes_match_oracle(name, exch_p, exch_s):
    """Three steps of every mode equal the loopy float64 reference oracle
    (tests/test_distsampler.py's Jacobi cases, at S=4)."""
    S = 4
    particles, x, t = problem(3, n=16, rows=24, seed=5)
    per = x.shape[0] // S

    def score_of(rank, theta):
        sl = slice(rank * per, (rank + 1) * per)
        return _numpy_logreg_score(theta, x[sl], t[sl])

    oracle = RefDistOracle(S, score_of, particles, exchange_particles=exch_p,
                           exchange_scores=exch_s, score_scale=1.0 if exch_s else S)
    ps = port_sampler(S, particles, x, t, exch_p, exch_s, "torch")
    for _ in range(3):
        np.testing.assert_allclose(ps.make_step(0.05).numpy(), oracle.make_step(0.05),
                                   rtol=1e-10, atol=1e-12)


def test_drop_remainder_and_importance_scale_match_jax():
    """n and the data rows not divisible by S: both packages drop the same
    remainders and scale scores by N_global/N_local; kernel='median' is
    resolved from the untruncated particles in both."""
    particles, x, t = problem(5, n=67, rows=53, seed=2)
    js = jdt.DistSampler(8, jlogreg_logp, "median", jnp.asarray(particles),
                         data=(jnp.asarray(x), jnp.asarray(t)), N_global=60,
                         exchange_particles=True, exchange_scores=False,
                         include_wasserstein=False, phi_impl="xla")
    ps = tdt.DistSampler(8, logreg_logp, "median", particles, data=(x, t), N_global=60,
                         exchange_particles=True, exchange_scores=False,
                         include_wasserstein=False, phi_impl="torch", device="cpu")
    assert ps.num_particles == js.num_particles == 64
    run_both(js, ps, rtol=1e-10, atol=1e-12)


def test_run_steps_equals_make_step():
    particles, x, t = problem(3, seed=4)
    a = port_sampler(8, particles, x, t, False, False, "auto")
    b = port_sampler(8, particles, x, t, False, False, "auto")
    for _ in range(4):
        a.make_step(0.02)
    torch.testing.assert_close(b.run_steps(4, 0.02), a.particles, rtol=0, atol=0)


@pytest.mark.parametrize("name,exch_p,exch_s", MODES)
def test_state_carried_from_jax(name, exch_p, exch_s):
    """JAX runs 3 steps; its state_dict crosses over with state_from_jax;
    both packages run 3 more and agree (the partitions rotation needs t)."""
    particles, x, t = problem(4, seed=9)
    js = jax_sampler(8, particles, x, t, exch_p, exch_s, "xla")
    js.run_steps(3, 0.05)
    ps = port_sampler(8, np.zeros_like(particles), x, t, exch_p, exch_s, "torch")
    jstate = {k: (None if v is None else np.asarray(v)) for k, v in js.state_dict().items()}
    ps.load_state_dict(state_from_jax(jstate, "cpu", sampler=ps))
    assert ps.t == 3
    np.testing.assert_allclose(ps.run_steps(3, 0.05).numpy(),
                               np.asarray(js.run_steps(3, 0.05)), rtol=1e-10, atol=1e-12)


def test_port_state_dict_round_trip_and_topology_check():
    particles, x, t = problem(3, seed=1)
    a = port_sampler(4, particles, x, t, True, False, "auto")
    a.run_steps(2, 0.05)
    state = a.state_dict()
    assert int(state["topo_n_particles"]) == 64 and int(state["t"]) == 2
    b = port_sampler(8, np.zeros_like(particles), x, t, True, False, "auto")
    b.load_state_dict(state)  # another shard count: the particles are global
    torch.testing.assert_close(b.particles, a.particles, rtol=0, atol=0)
    c = port_sampler(4, particles[:32], x, t, True, False, "auto")
    with pytest.raises(TopologyMismatch, match="n_particles"):
        c.load_state_dict(state)
    with pytest.raises(TopologyMismatch):
        state_from_jax(state, "cpu", sampler=c)


def test_state_from_jax_refuses_unported_state():
    particles, x, t = problem(3)
    state = port_sampler(4, particles, x, t, True, False, "auto").state_dict()
    with pytest.raises(NotImplementedError, match="ROADMAP A7"):
        state_from_jax({**state, "previous": np.zeros((4, 64, 3))}, "cpu")
    with pytest.raises(ValueError, match="kernel_approx"):
        state_from_jax({**state, "approx_method": np.asarray(0)}, "cpu")
    with pytest.raises(ValueError, match="block"):
        state_from_jax({**state, "particles": state["particles"][:16]}, "cpu")


def test_device_rules():
    """No device → the card, raising without CUDA (never a quiet CPU run);
    phi_impl='cuda' is refused on the CPU."""
    particles, x, t = problem(3)
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tdt.DistSampler(4, logreg_logp, None, particles, data=(x, t),
                        include_wasserstein=False)
    with pytest.raises(ValueError, match="phi_impl='cuda'"):
        port_sampler(4, particles, x, t, True, False, "cuda")


@pytest.mark.parametrize("kw,item", [
    ({"include_wasserstein": True}, "A7"),
    ({"update_rule": "gauss_seidel"}, "A10"),
    ({"exchange_impl": "ring"}, "A10"),
    ({"exchange_every": 2}, "A10"),
    ({"shard_data": True}, "A6"),
    ({"batch_size": 4}, "A6"),
    ({"log_prior": lambda th: -(th * th).sum()}, "A6"),
    ({"kernel_approx": "rff"}, "A11"),
    ({"kernel": "median_step"}, "A2"),
    ({"phi_impl": "pallas_bf16"}, "B1/B2"),
    ({"mesh": object()}, "A6"),
])
def test_out_of_slice_options_raise(kw, item):
    particles, x, t = problem(3)
    args = dict(exchange_particles=True, exchange_scores=False,
                include_wasserstein=False, device="cpu")
    args.update(kw)
    kernel = args.pop("kernel", None)
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
        tdt.DistSampler(4, logreg_logp, kernel, particles, data=(x, t), **args)


def test_out_of_slice_run_options_raise():
    particles, x, t = problem(3)
    ps = port_sampler(4, particles, x, t, True, False, "auto")
    with pytest.raises(NotImplementedError, match="ROADMAP A8"):
        ps.run_steps(2, 0.05, record=True)
    with pytest.raises(NotImplementedError, match="ROADMAP A10"):
        ps.run_steps(2, 0.05, dispatch_budget=1.0)
    with pytest.raises(ValueError, match="exchange particles"):
        tdt.DistSampler(4, logreg_logp, None, particles, exchange_particles=False,
                        exchange_scores=True, include_wasserstein=False, device="cpu")
    assert jax.config.read("jax_enable_x64")
