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
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

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
    """W2 snapshots and duals cross over (round-trip below), and so does a
    kernel-approximation save's identity, without JAX's threefry bank key;
    one process's block is still refused."""
    particles, x, t = problem(3)
    state = port_sampler(4, particles, x, t, True, False, "auto").state_dict()
    prev = np.random.default_rng(0).normal(size=(4, 64, 3))
    g = np.random.default_rng(1).normal(size=(4, 64))
    carried = state_from_jax({**state, "previous": prev, "w2_g": g}, "cpu")
    np.testing.assert_array_equal(carried["previous"].numpy(), prev)
    np.testing.assert_array_equal(carried["w2_g"].numpy(), g)
    assert int(carried["w2_pairing"]) == 0
    approx = state_from_jax({**state, "approx_method": np.asarray(0, np.int8),
                             "approx_dial": np.asarray(64), "approx_active": np.asarray(1),
                             "approx_bank_key": np.asarray([0, 7], np.uint32)}, "cpu")
    assert int(approx["approx_method"]) == 0 and int(approx["approx_dial"]) == 64
    assert int(approx["approx_active"]) == 1 and "approx_bank_key" not in approx
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
    ({"update_rule": "gauss_seidel", "exchange_impl": "ring"}, "requires exchange_impl='gather'"),
    ({"update_rule": "gauss_seidel", "batch_size": 4}, "supports only the jacobi"),
    ({"exchange_impl": "ring", "update_rule": "gauss_seidel"}, "requires exchange_impl='gather'"),
    ({"exchange_every": 2, "exchange_scores": True}, "requires the all_particles mode"),
    ({"shard_data": True, "exchange_particles": False}, "partitions mode"),
    ({"batch_size": 13}, "local rows"),
    ({"log_prior": lambda th: -(th * th).sum(), "seed": 1.5}, "seed must be an int"),
    ({"kernel_approx": "rff", "phi_impl": "cuda"}, "no kernel tier"),
    ({"kernel": lambda a, b: (a - b).abs().sum(), "phi_impl": "cuda"}, "requires an RBF kernel"),
    ({"phi_impl": "pallas_bf16"}, "the port's is 'cuda_bf16'"),
    ({"mesh": object()}, "A10"),
])
def test_out_of_slice_options_raise(kw, item):
    """Options outside the port raise NotImplementedError naming their
    ROADMAP item; the ported minibatch, prior, shard_data and bf16 options
    raise JAX's ValueErrors on bad values (48 rows / 4 shards = 12 a
    shard), and so do JAX's constraints on the Gauss–Seidel sweep and on a
    kernel that is not an RBF."""
    particles, x, t = problem(3)
    args = dict(exchange_particles=True, exchange_scores=False,
                include_wasserstein=False, device="cpu")
    args.update(kw)
    kernel = args.pop("kernel", None)
    roadmap = item[0] in "AB" and item[1:2].isdigit()
    with pytest.raises(NotImplementedError if roadmap else ValueError,
                       match=f"ROADMAP {item}" if roadmap else item):
        tdt.DistSampler(4, logreg_logp, kernel, particles, data=(x, t), **args)


def test_out_of_slice_run_options_raise():
    particles, x, t = problem(3)
    ps = port_sampler(4, particles, x, t, True, False, "auto")
    ps.run_steps(2, 0.05, dispatch_budget=1.0)  # ported: the whole run fits
    assert ps.last_run_stats["execution"] == "monolithic"
    with pytest.raises(ValueError, match="hop seam"):  # the gather has no seam
        ps.run_steps(2, 0.05, hops_per_dispatch=1)
    with pytest.raises(ValueError, match="exchange particles"):
        tdt.DistSampler(4, logreg_logp, None, particles, exchange_particles=False,
                        exchange_scores=True, include_wasserstein=False, device="cpu")
    assert jax.config.read("jax_enable_x64")


# --------------------------------------------------------------------------
# The Wasserstein/JKO term


def w2_pair(S, particles, x, t, exch_p, exch_s, solver, **kw):
    """The JAX and the port DistSampler with the W2 term, float64, on the
    same inputs (JAX's 'xla' φ and, on the CPU, its 'xla' Sinkhorn route;
    the port's 'torch' φ and torch route)."""
    common = dict(exchange_particles=exch_p, exchange_scores=exch_s,
                  include_wasserstein=True, wasserstein_solver=solver, **kw)
    js = jdt.DistSampler(S, jlogreg_logp, None, jnp.asarray(particles),
                         data=(jnp.asarray(x), jnp.asarray(t)), phi_impl="xla", **common)
    ps = tdt.DistSampler(S, logreg_logp, None, particles, data=(x, t), phi_impl="torch",
                         device="cpu", **common)
    return js, ps


def assert_w2_state_close(js, ps, rtol=1e-10, atol=1e-12):
    np.testing.assert_allclose(ps.particles.numpy(), np.asarray(js.particles), rtol=rtol,
                               atol=atol)
    np.testing.assert_allclose(ps._previous.numpy(), np.asarray(js._previous), rtol=rtol,
                               atol=atol)
    if js._w2_g is None:
        assert ps._w2_g is None
    else:
        np.testing.assert_allclose(ps._w2_g.numpy(), np.asarray(js._w2_g), rtol=rtol,
                                   atol=1e-10)


@pytest.mark.parametrize("S", [2, 4])
@pytest.mark.parametrize("name,exch_p,exch_s", MODES)
def test_w2_lp_make_step_matches_jax(name, exch_p, exch_s, S):
    """The host-LP W2 term through make_step, with the reference's snapshot
    warts per mode: three steps (the first has no W2 term) on both."""
    particles, x, t = problem(2, n=8, rows=16, seed=21)
    js, ps = w2_pair(S, particles, x, t, exch_p, exch_s, "lp")
    assert ps.w2_pairing == js.w2_pairing
    for _ in range(3):
        np.testing.assert_allclose(ps.make_step(0.05, h=0.5).numpy(),
                                   np.asarray(js.make_step(0.05, h=0.5)), rtol=1e-9,
                                   atol=1e-11)
    assert_w2_state_close(js, ps, rtol=1e-9, atol=1e-11)


@pytest.mark.parametrize("entry", ["make_step", "run_steps"])
@pytest.mark.parametrize("S", [2, 4])
@pytest.mark.parametrize("name,exch_p,exch_s", MODES)
def test_w2_sinkhorn_matches_jax(name, exch_p, exch_s, S, entry):
    """The Sinkhorn W2 term (tol exit, warm-started carried dual) through
    make_step or run_steps on both packages: particles, snapshots and duals
    after four steps."""
    particles, x, t = problem(3, n=16, rows=24, seed=23)
    js, ps = w2_pair(S, particles, x, t, exch_p, exch_s, "sinkhorn", sinkhorn_iters=50)
    if entry == "make_step":
        for _ in range(4):
            js.make_step(0.05, h=0.5)
            ps.make_step(0.05, h=0.5)
    else:
        js.run_steps(4, 0.05, h=0.5)
        ps.run_steps(4, 0.05, h=0.5)
    assert ps.t == js.t == 4
    assert_w2_state_close(js, ps)


@pytest.mark.parametrize("name,exch_p,exch_s", MODES[:2])
def test_w2_block_pairing_matches_jax(name, exch_p, exch_s):
    """w2_pairing='block' in the exchanged modes: block-sized snapshots,
    block b paired with block (b+1) mod S, φ still global."""
    particles, x, t = problem(3, n=16, rows=24, seed=27)
    js, ps = w2_pair(4, particles, x, t, exch_p, exch_s, "sinkhorn", sinkhorn_iters=40,
                     w2_pairing="block")
    assert ps.w2_pairing == js.w2_pairing == "block"
    js.run_steps(4, 0.05, h=0.5)
    ps.run_steps(4, 0.05, h=0.5)
    assert tuple(ps._previous.shape) == (4, 4, 3)
    assert_w2_state_close(js, ps)


@pytest.mark.parametrize("name,exch_p,exch_s", MODES)
def test_w2_lp_matches_oracle(name, exch_p, exch_s):
    """Three LP W2 steps of every mode equal the loopy float64 reference
    oracle, snapshot warts included (tests/test_distsampler.py:
    test_wasserstein_modes_match_oracle, on the logreg target)."""
    S = 2
    particles, x, t = problem(3, n=8, rows=16, seed=31)
    per = x.shape[0] // S

    def score_of(rank, theta):
        sl = slice(rank * per, (rank + 1) * per)
        return _numpy_logreg_score(theta, x[sl], t[sl])

    oracle = RefDistOracle(S, score_of, particles, exchange_particles=exch_p,
                           exchange_scores=exch_s, include_wasserstein=True,
                           score_scale=1.0 if exch_s else S, update_rule="jacobi")
    _, ps = w2_pair(S, particles, x, t, exch_p, exch_s, "lp")
    for _ in range(3):
        np.testing.assert_allclose(ps.make_step(0.05, h=0.5).numpy(),
                                   oracle.make_step(0.05, h=0.5), rtol=1e-6, atol=1e-8)


@pytest.mark.parametrize("name,exch_p,exch_s", MODES)
def test_w2_state_carried_from_jax(name, exch_p, exch_s):
    """A JAX Sinkhorn-W2 run's state (particles, t, snapshots, duals, the
    resolved pairing) crosses over with state_from_jax, and the port goes
    on along JAX's trajectory."""
    particles, x, t = problem(3, n=16, rows=24, seed=33)
    js, ps = w2_pair(4, particles, x, t, exch_p, exch_s, "sinkhorn", sinkhorn_iters=50)
    js.run_steps(3, 0.05, h=0.5)
    jstate = {k: (None if v is None else np.asarray(v)) for k, v in js.state_dict().items()}
    ps.load_state_dict(state_from_jax(jstate, "cpu", sampler=ps))
    assert ps.t == 3
    js.run_steps(3, 0.05, h=0.5)
    ps.run_steps(3, 0.05, h=0.5)
    assert_w2_state_close(js, ps)


def test_w2_run_steps_refuses_lp_and_port_state_round_trips():
    particles, x, t = problem(3, n=16, rows=24, seed=35)
    js, ps = w2_pair(2, particles, x, t, True, False, "lp")
    with pytest.raises(ValueError, match="sinkhorn"):
        js.run_steps(2, 0.05)
    with pytest.raises(ValueError, match="sinkhorn"):
        ps.run_steps(2, 0.05)
    _, a = w2_pair(2, particles, x, t, True, False, "sinkhorn", sinkhorn_iters=30)
    a.run_steps(3, 0.05, h=0.5)
    state = a.state_dict()
    assert state["previous"].shape == (2, 16, 3) and state["w2_g"].shape == (2, 16)
    _, b = w2_pair(2, np.zeros_like(particles), x, t, True, False, "sinkhorn",
                   sinkhorn_iters=30)
    b.load_state_dict(state)
    torch.testing.assert_close(b.run_steps(2, 0.05, h=0.5), a.run_steps(2, 0.05, h=0.5),
                               rtol=0, atol=0)
    with pytest.raises(ValueError, match="w2_g"):
        b.load_state_dict({**state, "w2_g": state["w2_g"][:, :8]})
    _, c = w2_pair(4, particles, x, t, True, False, "sinkhorn")  # another layout
    c.load_state_dict(state)  # resharded; the dual restarts cold
    assert tuple(c._previous.shape) == (4, 16, 3) and c._w2_g is None
    _, blk = w2_pair(2, particles, x, t, True, False, "sinkhorn", w2_pairing="block")
    with pytest.warns(UserWarning, match="w2_pairing='global'"):
        blk.load_state_dict({k: v for k, v in state.items()
                             if k not in ("previous", "w2_g")})


def test_w2_pairing_resolution_matches_jax():
    """'global' is undefined in partitions; 'auto' switches to block past
    W2_GLOBAL_PAIRING_MAX_N particles, with a warning, in both packages."""
    particles, x, t = problem(3)
    with pytest.raises(ValueError, match="partitions"):
        w2_pair(4, particles, x, t, False, False, "sinkhorn", w2_pairing="global")
    big = np.zeros((tdt.distsampler.W2_GLOBAL_PAIRING_MAX_N + 2, 1))
    with pytest.warns(UserWarning, match="block"):
        ds = tdt.DistSampler(2, lambda th, _: -(th * th).sum(), None, big,
                             exchange_particles=True, exchange_scores=False, device="cpu")
    assert ds.w2_pairing == "block"
    assert tdt.distsampler.W2_GLOBAL_PAIRING_MAX_N == jdt.distsampler.W2_GLOBAL_PAIRING_MAX_N
