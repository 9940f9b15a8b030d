"""The port's sub-quadratic φ (``dist_svgd_torch/ops/approx.py``) against
the JAX package's (``tests/test_approx.py``), on the CPU.

JAX draws its RFF bank from threefry, which no torch stream reproduces:
the parity tests hand JAX's draws to the port through the private
``KernelApprox._bank_seam`` (as ``_batch_index_seam`` does for
minibatches) and hold the results at float64, 1e-10 — ``phi_rff`` and
``phi_nystrom``, the ``resolve_phi_fn`` routing at patched crossover
constants, and 10-step ``Sampler`` / ``DistSampler`` trajectories (gather,
ring, the three modes, ``rff_redraw='step'``, chunked against
monolithic).  The port's own draws are held to ``default_error_budget``
on JAX's calibration table.  Also: the refusals, checkpoint stamping and
refusals, JAX ↔ port saves, the residual gauges, and
``tools/large_n.py --kernel-approx`` at a tiny n."""

import importlib.util
import json
import pathlib

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import dist_svgd_tpu as jdt
from dist_svgd_tpu.models.gmm import gmm_logp as jgmm_logp
from dist_svgd_tpu.ops import approx as japprox
from dist_svgd_tpu.ops.kernels import RBF as JRBF
from dist_svgd_tpu.ops.kernels import AdaptiveRBF as JAdaptiveRBF
from dist_svgd_tpu.ops.pallas_svgd import resolve_phi_fn as jresolve
from dist_svgd_tpu.utils import checkpoint as jck
from dist_svgd_tpu.utils.rng import approx_bank_key

import dist_svgd_torch as tdt
from dist_svgd_torch.models.gmm import gmm_logp
from dist_svgd_torch.ops import approx as tapprox
from dist_svgd_torch.ops import cuda_svgd
from dist_svgd_torch.ops.approx import KernelApprox, bind_phi_step
from dist_svgd_torch.ops.kernels import RBF, AdaptiveRBF
from dist_svgd_torch.ops.svgd import phi as phi_exact
from dist_svgd_torch.parallel.exchange import make_chunked_ring_step_fns
from dist_svgd_torch.telemetry import MetricsRegistry
from dist_svgd_torch.tools import large_n
from dist_svgd_torch.utils import checkpoint as tck
from dist_svgd_torch.utils.interop import state_from_jax
from dist_svgd_torch.utils.rng import approx_bank_seed

from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

#: JAX against the port in float64: summation order only.
RTOL, ATOL = 1e-10, 1e-12
D, N = 2, 64


@pytest.fixture
def jax_factor(monkeypatch):
    """The port's crossover factor at JAX's value, for tests that hold the
    'auto' pin against JAX's (the port's own value was measured on the
    card; the routing logic is what they compare)."""
    monkeypatch.setattr(tapprox, "APPROX_CROSSOVER_FACTOR", japprox.APPROX_CROSSOVER_FACTOR)


def jax_bank_seam(seed):
    """JAX's banks for run seed ``seed``: a run's drawn eagerly from
    ``approx_bank_key`` (as JAX's compile-time draw), step ``t``'s from
    ``fold_in(key, t)`` inside a jitted program (as JAX draws it in its
    step program — XLA's fused scaling rounds one ulp apart from the eager
    one)."""
    key = approx_bank_key(seed)

    def seam(t, shape, bandwidth):
        if t is None:
            return np.asarray(japprox.rff_frequencies(key, shape[0], shape[1], bandwidth))
        draw = jax.jit(lambda t_: japprox.rff_frequencies(
            jax.random.fold_in(key, t_), shape[0], shape[1], bandwidth))
        return np.asarray(draw(jnp.asarray(t, jnp.int32)))

    return seam


def pair(method, seed=0, **kw):
    """(JAX spec with its bank key, port spec with JAX's bank injected)."""
    if method == "rff":
        jspec = japprox.KernelApprox("rff", **kw).with_key(approx_bank_key(seed))
        tspec = KernelApprox("rff", **kw).with_seed(approx_bank_seed(seed))
        tspec._bank_seam = jax_bank_seam(seed)
    else:
        jspec, tspec = japprox.KernelApprox("nystrom", **kw), KernelApprox("nystrom", **kw)
    return jspec, tspec


def spec_for(method, seed=0, **kw):
    """A port spec whose bank (RFF) is JAX's for ``seed``, unbound."""
    spec = KernelApprox(method, **kw)
    if method == "rff":
        spec._bank_seam = jax_bank_seam(seed)
    return spec


def close(a, b, rtol=RTOL, atol=ATOL):
    a = a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    np.testing.assert_allclose(a, np.asarray(b), rtol=rtol, atol=atol)


def probe(n, d, seed=0):
    rng = np.random.default_rng(seed)
    x = 2.5 * rng.normal(size=(n, d)) + 1.5
    return x, -x


def dist_logp(theta, _data=None):
    return gmm_logp(theta)


def jdist_logp(theta, _data=None):
    return jgmm_logp(theta)


def port_dist(S, p0, seed=0, **kw):
    kw.setdefault("exchange_particles", True)
    kw.setdefault("exchange_scores", False)
    kw.setdefault("include_wasserstein", False)
    kw.setdefault("phi_impl", "torch")
    return tdt.DistSampler(S, dist_logp, kw.pop("kernel", None), p0, seed=seed,
                           device="cpu", **kw)


def jax_dist(S, p0, seed=0, **kw):
    kw.setdefault("exchange_particles", True)
    kw.setdefault("exchange_scores", False)
    kw.setdefault("include_wasserstein", False)
    kw.setdefault("phi_impl", "xla")
    kernel = kw.pop("kernel", None)
    return jdt.DistSampler(S, jdist_logp, kernel, jnp.asarray(p0), seed=seed, mesh=None,
                           **kw)


# --------------------------------------------------------------------- #
# the two φ's against JAX's


@pytest.mark.parametrize("n,m,d,R,h", [(40, 40, 3, 64, 2.0), (17, 33, 5, 128, 0.7),
                                       (64, 64, 1, 16, 1.0)])
def test_phi_rff_matches_jax_with_its_bank(n, m, d, R, h):
    rng = np.random.default_rng(n + m)
    y, x, s = rng.normal(size=(n, d)), rng.normal(size=(m, d)), rng.normal(size=(m, d))
    freqs = japprox.rff_frequencies(approx_bank_key(3), R, d, h)
    want = japprox.phi_rff(jnp.asarray(y), jnp.asarray(x), jnp.asarray(s), freqs)
    tfreqs = tapprox._scale_bank(torch.from_numpy(np.array(
        jax.random.normal(approx_bank_key(3), (R, d), dtype=jnp.float32))), h)
    close(tfreqs, freqs, rtol=0, atol=0)  # the f32 bank, bitwise
    got = tapprox.phi_rff(*(torch.from_numpy(a) for a in (y, x, s)), tfreqs)
    close(got, want)


@pytest.mark.parametrize("n,m,d,L,h,ridge", [(40, 40, 3, 16, 2.0, 1e-4),
                                             (17, 33, 5, 8, 0.7, 1e-3),
                                             (20, 12, 2, 64, 1.0, 1e-4)])
def test_phi_nystrom_matches_jax(n, m, d, L, h, ridge):
    rng = np.random.default_rng(n * m)
    y, x, s = rng.normal(size=(n, d)), rng.normal(size=(m, d)), rng.normal(size=(m, d))
    want = japprox.phi_nystrom(jnp.asarray(y), jnp.asarray(x), jnp.asarray(s), h, L, ridge)
    got = tapprox.phi_nystrom(*(torch.from_numpy(a) for a in (y, x, s)), h, L, ridge)
    close(got, want)


@pytest.mark.parametrize("method", ["rff", "nystrom"])
def test_batched_lanes_equal_per_lane_calls(method):
    """Leading dimensions: a shared (m, d) set with per-lane scores, and
    per-lane (S, m, d) sets (each lane its own landmarks), as the
    exchange builders call it."""
    rng = np.random.default_rng(5)
    y = torch.from_numpy(rng.normal(size=(3, 7, 2)))
    x = torch.from_numpy(rng.normal(size=(3, 11, 2)))
    s = torch.from_numpy(rng.normal(size=(3, 11, 2)))
    spec = spec_for(method, num_features=32, num_landmarks=4).with_seed(1)
    fn = tapprox.make_approx_phi_fn(RBF(1.3), spec)
    for xs in (x, x[0]):
        got = fn(y, xs, s)
        for r in range(3):
            close(got[r], fn(y[r], xs if xs.dim() == 2 else xs[r], s[r]), rtol=1e-13,
                  atol=1e-14)


def test_nystrom_failed_factor_is_nan_not_an_error():
    """A landmark system that does not factor (duplicate landmarks, no
    ridge) gives NaN, decided on the device, as JAX's cho_factor does."""
    x = torch.zeros(8, 2, dtype=torch.float64)
    out = tapprox.phi_nystrom(x, x, x, 1.0, 8, ridge=0.0)
    assert torch.isnan(out).all()
    jout = japprox.phi_nystrom(jnp.zeros((8, 2)), jnp.zeros((8, 2)), jnp.zeros((8, 2)),
                               1.0, 8, 0.0)
    assert np.isnan(np.asarray(jout)).all()


@pytest.mark.parametrize("m,L", [(100, 32), (16, 32), (1000, 7), (9, 9)])
def test_landmark_indices_match_jax(m, L):
    np.testing.assert_array_equal(tapprox.nystrom_landmark_indices(m, L),
                                  japprox.nystrom_landmark_indices(m, L))


# --------------------------------------------------------------------- #
# the budget table on the port's own draws (tests/test_approx.py)


@pytest.mark.parametrize("n,d", [(256, 3), (512, 8)])
def test_rff_error_inside_budget_and_improves_with_dial(n, d):
    x, s, kernel = tapprox.error_pin_probe(n, d, seed=0, dtype=torch.float64, device="cpu")
    exact = phi_exact(x, x, s, kernel)
    errs = {}
    for num_features in (256, 4096):
        spec = KernelApprox("rff", num_features=num_features).with_seed(approx_bank_seed(0))
        err = tapprox.phi_rel_error(exact, tapprox.make_approx_phi_fn(kernel, spec)(x, x, s))
        assert err <= tapprox.default_error_budget(spec, d), (num_features, err)
        errs[num_features] = err
    assert errs[4096] < errs[256]


@pytest.mark.parametrize("n,d", [(256, 3), (512, 8)])
def test_nystrom_error_inside_budget_and_exact_at_full_rank(n, d):
    x, s, kernel = tapprox.error_pin_probe(n, d, seed=1, dtype=torch.float64, device="cpu")
    exact = phi_exact(x, x, s, kernel)
    errs = {}
    for num_landmarks in (64, n):
        spec = KernelApprox("nystrom", num_landmarks=num_landmarks)
        err = tapprox.phi_rel_error(exact, tapprox.make_approx_phi_fn(kernel, spec)(x, x, s))
        assert err <= tapprox.default_error_budget(spec, d), (num_landmarks, err)
        errs[num_landmarks] = err
    assert errs[n] < 1e-4 and errs[n] < errs[64]


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("R,d", [(256, 3), (1024, 8), (4096, 3)])
def test_rff_budget_holds_on_the_ports_float32_draws(seed, R, d):
    """The calibration sweep in float32, the card's dtype, on the port's
    own bank stream."""
    x, s, kernel = tapprox.error_pin_probe(512, d, seed=seed, device="cpu")
    spec = KernelApprox("rff", num_features=R).with_seed(approx_bank_seed(seed))
    err = tapprox.phi_rel_error(phi_exact(x, x, s, kernel),
                                tapprox.make_approx_phi_fn(kernel, spec)(x, x, s))
    assert err <= tapprox.default_error_budget(spec, d)


#: chip_smoke.py's approx_crossover ladder on an NVIDIA H100 80GB HBM3 at
#: 700.00 W, 10 reps a point (PERF.md §6): n → ms of the exact φ, then of
#: each series.
CARD_LADDER_SERIES = (("rff", 2048), ("nystrom", 2048), ("rff", 4096), ("nystrom", 4096))
CARD_LADDER = {
    8192: (0.07130, 0.97029, 3.21664, 1.42724, 7.27583),
    16_384: (0.14629, 1.52953, 4.06353, 3.24825, 8.84755),
    32_768: (0.51341, 2.99580, 5.79894, 6.36748, 12.08661),
    65_536: (1.98670, 5.66403, 9.16212, 12.47909, 18.47913),
    131_072: (7.71640, 12.97896, 15.95515, 24.26508, 31.53439),
    262_144: (30.52795, 25.85387, 29.55470, 40.94130, 57.47975),
}


def chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_committed_crossover_factor_keeps_auto_exact_where_the_ladder_did():
    """The card's factor against the card's ladder, by chip_smoke.py's own
    rule: 'auto' picks an approximation at no rung where it was not faster
    by the margin, and the committed factor is the smallest integer the
    ladder allows."""
    smoke = chip_smoke()
    margin = smoke.CROSSOVER["margin"]
    series, counts = {}, {}
    for n, (exact_ms, *ms) in CARD_LADDER.items():
        for (method, dial), t in zip(CARD_LADDER_SERIES, ms):
            spec = KernelApprox(method, num_features=dial, num_landmarks=dial)
            faster = t < (1.0 - margin) * exact_ms
            series.setdefault(f"{method}_{dial}", []).append((n, faster))
            counts[f"{method}_{dial}"] = spec.feature_count
            assert faster or not tapprox.approx_preferred(n, n, spec.feature_count)
    need, strict = smoke.crossover_factor_needed(series, counts)
    factor = tapprox.APPROX_CROSSOVER_FACTOR
    assert factor == int(factor)
    assert (factor > need) if strict else (factor >= need)
    assert not ((factor - 1 > need) if strict else (factor - 1 >= need))


@pytest.mark.parametrize("series,need,strict", [
    ({"a": [(8, False), (16, False)]}, 8.0, True),              # never faster
    ({"a": [(8, False), (16, True), (32, True)]}, 8.0, False),  # wins from 16 up
    ({"a": [(8, True), (16, False), (32, True)]}, 16.0, False),  # a win below a loss
    ({"a": [(8, True), (16, True)]}, 4.0, False),               # faster everywhere
    ({"a": [(8, False)], "b": [(4, False), (8, True)]}, 4.0, True),  # a tie: strict wins
])
def test_crossover_rule_takes_no_unmeasured_gap(series, need, strict):
    """chip_smoke.py's rule for the smallest factor, at one feature (the
    switch at n = 2·factor): the switch lands at or above the first rung
    of a series' wins up to the top, or above the top."""
    got = chip_smoke().crossover_factor_needed(series, dict.fromkeys(series, 1))
    assert got == (need, strict)


def test_budget_and_crossover_formulas_match_jax(monkeypatch):
    for method, dial in (("rff", 64), ("rff", 4096), ("nystrom", 1024)):
        jspec, tspec = pair(method, num_features=dial, num_landmarks=dial)
        assert tspec.feature_count == jspec.feature_count
        assert tspec.accuracy_dial == jspec.accuracy_dial
        for d in (1, 3, 55):
            assert tapprox.default_error_budget(tspec, d) == japprox.default_error_budget(
                jspec, d)
    for factor in (0.25, 1.0, 3.0):
        monkeypatch.setattr(tapprox, "APPROX_CROSSOVER_FACTOR", factor)
        monkeypatch.setattr(japprox, "APPROX_CROSSOVER_FACTOR", factor)
        for k, m, f in ((256, 256, 32), (4096, 4096, 8192), (8192, 1024, 2048), (3, 5, 1)):
            assert tapprox.approx_preferred(k, m, f) == japprox.approx_preferred(k, m, f)


def test_bank_stream_is_deterministic_and_seed_keyed():
    x, s, kernel = tapprox.error_pin_probe(64, 3, seed=0, device="cpu")
    a = tapprox.make_approx_phi_fn(kernel, KernelApprox("rff", 256).with_seed(7))(x, x, s)
    b = tapprox.make_approx_phi_fn(kernel, KernelApprox("rff", 256).with_seed(7))(x, x, s)
    c = tapprox.make_approx_phi_fn(kernel, KernelApprox("rff", 256).with_seed(8))(x, x, s)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert approx_bank_seed(3) == approx_bank_seed(3) != approx_bank_seed(4)


# --------------------------------------------------------------------- #
# resolve_phi_fn: routing and refusals


@pytest.mark.parametrize("factor", [0.05, 1.0, 20.0])
@pytest.mark.parametrize("method", ["rff", "nystrom"])
def test_resolve_routing_matches_jax_at_patched_crossover(monkeypatch, factor, method):
    """'auto' with an approximation against JAX's at the same crossover
    constant: the same side of the line at every shape, the same φ (the
    exact side is the 'torch' φ on float64 CPU tensors, JAX's 'xla')."""
    monkeypatch.setattr(tapprox, "APPROX_CROSSOVER_FACTOR", factor)
    monkeypatch.setattr(japprox, "APPROX_CROSSOVER_FACTOR", factor)
    jspec, tspec = pair(method, num_features=16, num_landmarks=8)
    rng = np.random.default_rng(11)
    for S, k, m in ((1, 32, 32), (4, 8, 32), (8, 4, 32)):
        y, x, s = (rng.normal(size=(S, k, 2)), rng.normal(size=(m, 2)),
                   rng.normal(size=(S, m, 2)))
        got = cuda_svgd.resolve_phi_fn(RBF(1.5), "auto", kernel_approx=tspec)(
            *(torch.from_numpy(a) for a in (y, x, s)))
        # the port reads the lanes from the shapes; JAX's per-lane φ needs
        # them as its batch_hint
        jfn = jresolve(JRBF(1.5), "auto", S, jspec)
        want = jax.vmap(jfn, in_axes=(0, None, 0))(jnp.asarray(y), jnp.asarray(x),
                                                  jnp.asarray(s))
        close(got, want)
        prefer = tapprox.approx_preferred(S * k, m, tspec.feature_count)
        exact = phi_exact(torch.from_numpy(y), torch.from_numpy(x), torch.from_numpy(s),
                          RBF(1.5))
        assert torch.equal(got, exact) != prefer


def test_resolve_torch_forces_the_approximation():
    jspec, tspec = pair("rff", num_features=4096)
    x, s = probe(16, 2)
    got = cuda_svgd.resolve_phi_fn(RBF(2.0), "torch", kernel_approx=tspec)(
        *(torch.from_numpy(a) for a in (x, x, s)))
    want = jresolve(JRBF(2.0), "xla", 1, jspec)(jnp.asarray(x), jnp.asarray(x),
                                                jnp.asarray(s))
    close(got, want)


def test_adaptive_bandwidth_composes_with_nystrom_and_rff_step():
    x, s = probe(24, 2, seed=3)
    for method, redraw in (("nystrom", "run"), ("rff", "step")):
        kw = dict(num_landmarks=6) if method == "nystrom" else dict(num_features=32,
                                                                      rff_redraw=redraw)
        jspec, tspec = pair(method, **kw)
        fn = cuda_svgd.resolve_phi_fn(AdaptiveRBF(), "torch", kernel_approx=tspec)
        jfn = jresolve(JAdaptiveRBF(), "xla", 1, jspec)
        args = tuple(torch.from_numpy(a) for a in (x, x, s))
        jargs = tuple(jnp.asarray(a) for a in (x, x, s))
        if method == "rff":  # JAX draws a per-step bank inside its step program
            assert fn.needs_step and jfn.needs_step
            close(bind_phi_step(fn, 4)(*args),
                  jax.jit(japprox.bind_phi_step(jfn, jnp.asarray(4, jnp.int32)))(*jargs))
        else:
            close(fn(*args), jfn(*jargs))


@pytest.mark.parametrize("call,match", [
    (lambda: cuda_svgd.resolve_phi_fn(AdaptiveRBF(), "auto",
                                      kernel_approx=KernelApprox("rff", seed=0)), "decalibrate"),
    (lambda: cuda_svgd.resolve_phi_fn(RBF(1.0), "cuda", kernel_approx="nystrom"), "no kernel tier"),
    (lambda: cuda_svgd.resolve_phi_fn(RBF(1.0), "cuda_bf16", kernel_approx="nystrom"), "no kernel tier"),
    (lambda: cuda_svgd.resolve_phi_fn(RBF(1.0), "torch_bf16", kernel_approx="nystrom"), "no kernel tier"),
    (lambda: cuda_svgd.resolve_phi_fn(RBF(1.0), "torch", kernel_approx="rff"), "bank seed"),
    (lambda: tapprox.as_kernel_approx("fourier"), "unknown kernel_approx"),
    (lambda: tapprox.as_kernel_approx(3), "must be None"),
    (lambda: tapprox.make_approx_phi_fn(lambda a, b: 1.0, KernelApprox("nystrom")), "RBF"),
    (lambda: KernelApprox("rff", rff_redraw="epoch"), "rff_redraw"),
    (lambda: KernelApprox("nystrom", rff_redraw="step"), "rff_redraw"),
    (lambda: KernelApprox("rff", num_features=0), "num_features"),
    (lambda: KernelApprox("nystrom", ridge=-1.0), "ridge"),
    (lambda: tdt.Sampler(D, gmm_logp, update_rule="gauss_seidel", kernel_approx="nystrom",
                         device="cpu"), "jacobi"),
    (lambda: port_dist(2, np.zeros((8, D)), update_rule="gauss_seidel",
                       kernel_approx="nystrom"), "jacobi"),
    (lambda: port_dist(2, np.zeros((8, D)), kernel="median_step", kernel_approx="rff"),
     "decalibrate"),
    (lambda: port_dist(2, np.zeros((8, D)), kernel_approx="rff", phi_impl="cuda_bf16"),
     "no kernel tier"),
])
def test_refusals(call, match):
    with pytest.raises(ValueError, match=match):
        call()


def test_rff_step_phi_needs_bound_index_and_draws_per_step():
    spec = KernelApprox("rff", num_features=128, rff_redraw="step").with_seed(5)
    fn = tapprox.make_approx_phi_fn(RBF(2.0), spec)
    x, s, _ = tapprox.error_pin_probe(64, D, device="cpu", dtype=torch.float64)
    with pytest.raises(ValueError, match="bind_phi_step"):
        fn(x, x, s)
    out0, out0b, out1 = (bind_phi_step(fn, t)(x, x, s) for t in (0, 0, 1))
    assert torch.equal(out0, out0b) and not torch.equal(out0, out1)
    exact = phi_exact(x, x, s, RBF(2.0))
    for t in (0, 1, 7):
        assert tapprox.phi_rel_error(exact, bind_phi_step(fn, t)(x, x, s)) <= \
            tapprox.default_error_budget(spec, D)
    run_fn = tapprox.make_approx_phi_fn(RBF(2.0), KernelApprox("rff", 128, seed=5))
    assert bind_phi_step(run_fn, 3) is run_fn


# --------------------------------------------------------------------- #
# the samplers against JAX's, JAX's bank injected


@pytest.mark.parametrize("method,phi_impl,redraw", [
    ("rff", "torch", "run"), ("rff", "torch", "step"), ("nystrom", "torch", "run"),
    ("rff", "auto", "run")])
def test_sampler_trajectory_matches_jax(jax_factor, method, phi_impl, redraw):
    """10 steps of ``Sampler`` against JAX's; the 'auto' case sits above
    the crossover (a 16-feature bank at n = 64)."""
    kw = (dict(num_features=16, rff_redraw=redraw) if method == "rff"
          else dict(num_landmarks=8))
    p0 = np.random.default_rng(2).normal(size=(N, D))
    jspec = japprox.KernelApprox(method, **kw)
    js = jdt.Sampler(D, jgmm_logp, kernel=JRBF(1.7), kernel_approx=jspec,
                     phi_impl="xla" if phi_impl == "torch" else "auto")
    want, _ = js.run(N, 10, 0.05, seed=3, record=False, initial_particles=jnp.asarray(p0))
    ts = tdt.Sampler(D, gmm_logp, kernel=RBF(1.7), kernel_approx=spec_for(method, 3, **kw),
                     phi_impl=phi_impl, device="cpu")
    got, _ = ts.run(N, 10, 0.05, seed=3, record=False, initial_particles=p0)
    assert ts.kernel_approx_active and js.kernel_approx_active
    close(got, want)


def test_sampler_auto_small_n_equals_exact_and_residual_probe():
    p0 = np.random.default_rng(4).normal(size=(N, D))
    a, _ = tdt.Sampler(D, gmm_logp, device="cpu").run(N, 3, 0.05, initial_particles=p0,
                                                     record=False)
    s = tdt.Sampler(D, gmm_logp, kernel_approx="rff", device="cpu")
    b, _ = s.run(N, 3, 0.05, initial_particles=p0, record=False)
    assert not s.kernel_approx_active and torch.equal(a, b)
    reg = MetricsRegistry()
    report = s.approx_residual(particles=b, max_points=32, registry=reg)
    assert report["n_eval"] == 32 and report["active"] is False
    assert report["phi_approx_within_budget"] == 1.0
    assert "svgd_diag_phi_residual_total 1" in reg.exposition()
    with pytest.raises(ValueError, match="kernel_approx"):
        tdt.Sampler(D, gmm_logp, device="cpu").approx_residual()


def test_sampler_residual_probe_matches_jax_and_keeps_live_state():
    """The probe on JAX's bank equals JAX's report, and it neither rebinds
    the live run's bank nor re-pins its crossover."""
    jspec = japprox.KernelApprox("rff", 64)
    js = jdt.Sampler(D, jgmm_logp, kernel=JRBF(2.0), kernel_approx=jspec, phi_impl="xla")
    ts = tdt.Sampler(D, gmm_logp, kernel=RBF(2.0), kernel_approx=spec_for("rff", 0,
                     num_features=64), phi_impl="torch", device="cpu")
    ts.run(N, 2, 0.05, seed=0, record=False)
    bank_before = ts.kernel_approx.seed
    x, _ = probe(48, D)
    got = ts.approx_residual(particles=x, max_points=48, seed=0)
    want = js.approx_residual(particles=jnp.asarray(x), max_points=48, seed=0)
    assert got["phi_approx_rel_err"] == pytest.approx(want["phi_approx_rel_err"], rel=1e-9)
    assert got["active"] and ts.kernel_approx.seed == bank_before


def test_sampler_median_freezes_bandwidth_before_bank():
    s = tdt.Sampler(D, gmm_logp, kernel="median", kernel_approx="rff", phi_impl="torch",
                    device="cpu")
    final, _ = s.run(N, 2, 0.05, seed=3, record=False)
    h = s.kernel.bandwidth
    assert h != 1.0
    parts = tdt.utils.init_particles(3, N, D)
    fn = tapprox.make_approx_phi_fn(RBF(h), KernelApprox("rff").with_seed(approx_bank_seed(3)))
    score = torch.func.vmap(torch.func.grad(gmm_logp))
    for _ in range(2):
        parts = parts + 0.05 * fn(parts, parts, score(parts))
    assert torch.equal(final, parts)


def test_sampler_step_redraw_segments_compose():
    step_spec = dict(num_features=64, rff_redraw="step")
    mk = lambda: tdt.Sampler(D, gmm_logp, kernel=RBF(2.0), phi_impl="torch",  # noqa: E731
                             kernel_approx=KernelApprox("rff", **step_spec), device="cpu")
    mono, _ = mk().run(N, 6, 1e-2, seed=0, record=False)
    seg = mk()
    p1, _ = seg.run(N, 3, 1e-2, seed=0, record=False)
    p2, _ = seg.run(N, 3, 1e-2, seed=0, record=False, initial_particles=p1, step_offset=3)
    assert torch.equal(mono, p2)
    chunked = mk()
    p3, _ = chunked.run(N, 6, 1e-2, seed=0, record=False, dispatch_budget=1.0,
                        pairs_per_sec=2 * N * N)
    assert chunked.last_run_stats["num_dispatches"] == 3 and torch.equal(mono, p3)


@pytest.mark.parametrize("method", ["rff", "nystrom"])
@pytest.mark.parametrize("mode,impl", [("all_particles", "gather"), ("all_scores", "gather"),
                                       ("partitions", "gather"), ("all_particles", "ring"),
                                       ("all_scores", "ring")])
def test_distsampler_trajectory_matches_jax(method, mode, impl):
    kw = dict(num_features=16) if method == "rff" else dict(num_landmarks=4)
    flags = {"all_particles": (True, False), "all_scores": (True, True),
             "partitions": (False, False)}[mode]
    p0 = np.random.default_rng(6).normal(size=(N, D))
    common = dict(exchange_particles=flags[0], exchange_scores=flags[1], exchange_impl=impl)
    jd = jax_dist(4, p0, seed=5, kernel=JRBF(1.3), kernel_approx=japprox.KernelApprox(
        method, **kw), **common)
    td = port_dist(4, p0, seed=5, kernel=RBF(1.3), kernel_approx=spec_for(method, 5, **kw),
                   **common)
    assert td.kernel_approx_active == jd.kernel_approx_active
    close(td.run_steps(10, 0.05), jd.run_steps(10, 0.05))


@pytest.mark.parametrize("impl", ["gather", "ring"])
def test_distsampler_step_redraw_matches_jax(impl):
    kw = dict(num_features=32, rff_redraw="step")
    p0 = np.random.default_rng(7).normal(size=(N, D))
    jd = jax_dist(4, p0, seed=2, kernel="median_step", exchange_impl=impl,
                  kernel_approx=japprox.KernelApprox("rff", **kw))
    td = port_dist(4, p0, seed=2, kernel="median_step", exchange_impl=impl,
                   kernel_approx=spec_for("rff", 2, **kw))
    close(td.run_steps(4, 1e-2), jd.run_steps(4, 1e-2))


@pytest.mark.parametrize("method", ["rff", "nystrom"])
def test_distsampler_auto_pin_matches_jax(jax_factor, method):
    """'auto' at a dial that puts the global shape above the crossover."""
    kw = dict(num_features=8) if method == "rff" else dict(num_landmarks=8)
    p0 = np.random.default_rng(8).normal(size=(N, D))
    jd = jax_dist(4, p0, seed=1, phi_impl="auto", kernel_approx=japprox.KernelApprox(
        method, **kw))
    td = port_dist(4, p0, seed=1, phi_impl="auto", kernel_approx=spec_for(method, 1, **kw))
    assert td.kernel_approx_active and jd.kernel_approx_active
    close(td.run_steps(10, 0.05), jd.run_steps(10, 0.05))


@pytest.mark.parametrize("spec_kw", [dict(num_features=16),
                                     dict(num_features=16, rff_redraw="step")])
def test_chunked_ring_equals_monolithic_run_steps(spec_kw):
    p0 = np.random.default_rng(9).normal(size=(N, D))
    mk = lambda: port_dist(4, p0, seed=3, exchange_impl="ring",  # noqa: E731
                           kernel_approx=KernelApprox("rff", **spec_kw))
    mono = mk().run_steps(4, 0.05)
    chunked = mk()
    out = chunked.run_steps(4, 0.05, hops_per_dispatch=1)
    assert chunked.last_run_stats["execution"] == "intra_step"
    close(out, mono, rtol=1e-12, atol=1e-13)
    budget = mk()
    out = budget.run_steps(4, 0.05, dispatch_budget=1.0, pairs_per_sec=2 * N * N)
    assert budget.last_run_stats["execution"] == "scan_chunks"
    assert torch.equal(out, mono)


def test_chunked_all_scores_refuses_step_redraw():
    with pytest.raises(ValueError, match="rff_redraw"):
        make_chunked_ring_step_fns(dist_logp, RBF(2.0), "all_scores", 2, 1.0,
                                   phi_impl="torch", kernel_approx=KernelApprox(
                                       "rff", 16, seed=0, rff_redraw="step"))


def test_lagged_and_w2_compose_with_the_approximation():
    p0 = np.random.default_rng(10).normal(size=(N, D))
    kw = dict(num_landmarks=8)
    jd = jax_dist(4, p0, seed=0, exchange_every=2,
                  kernel_approx=japprox.KernelApprox("nystrom", **kw))
    td = port_dist(4, p0, seed=0, exchange_every=2,
                   kernel_approx=KernelApprox("nystrom", **kw))
    close(td.run_steps(6, 0.05), jd.run_steps(6, 0.05))
    jw = jax_dist(4, p0, include_wasserstein=True, wasserstein_solver="sinkhorn",
                  sinkhorn_iters=20, kernel_approx=japprox.KernelApprox("nystrom", **kw))
    tw = port_dist(4, p0, include_wasserstein=True, wasserstein_solver="sinkhorn",
                   sinkhorn_iters=20, kernel_approx=KernelApprox("nystrom", **kw))
    close(tw.run_steps(3, 0.05, h=1.0), jw.run_steps(3, 0.05, h=1.0), rtol=1e-9, atol=1e-11)


def test_distsampler_residual_gauges_match_jax():
    jspec = japprox.KernelApprox("rff", 64)
    p0 = np.random.default_rng(12).normal(size=(N, D))
    jd = jax_dist(4, p0, seed=4, kernel=JRBF(2.0), kernel_approx=jspec)
    td = port_dist(4, p0, seed=4, kernel=RBF(2.0),
                   kernel_approx=spec_for("rff", 4, num_features=64))
    reg = MetricsRegistry()
    got = td.approx_residual(max_points=32, registry=reg)
    want = jd.approx_residual(max_points=32)
    for k in ("phi_approx_rel_err", "phi_approx_budget", "phi_approx_dial", "n_eval"):
        assert got[k] == pytest.approx(want[k], rel=1e-9)
    assert got["active"] is True
    text = reg.exposition()
    assert "svgd_diag_phi_approx_within_budget 1" in text
    with pytest.raises(ValueError, match="kernel_approx"):
        port_dist(4, p0).approx_residual()


# --------------------------------------------------------------------- #
# checkpoints: stamping, refusals, JAX ↔ port


def test_state_dict_stamps_identity_and_resume_is_bitwise():
    p0 = np.random.default_rng(13).normal(size=(N, D))
    a = port_dist(4, p0, seed=7, kernel_approx="rff")
    a.run_steps(3, 0.05)
    st = a.state_dict()
    assert int(st["approx_method"]) == 0 and int(st["approx_dial"]) == 2048
    assert int(st["approx_active"]) == 1 and int(st["approx_rff_redraw"]) == 0
    assert int(st["approx_bank_seed"]) == approx_bank_seed(7)
    want = a.run_steps(3, 0.05).clone()
    for seed in (7, 99):  # a foreign construction seed adopts the saved bank
        b = port_dist(4, p0, seed=seed, kernel_approx="rff")
        b.load_state_dict(st)
        assert torch.equal(b.run_steps(3, 0.05), want)
    ny = port_dist(4, p0, kernel_approx=KernelApprox("nystrom", num_landmarks=32)).state_dict()
    np.testing.assert_array_equal(ny["approx_landmark_idx"],
                                  tapprox.nystrom_landmark_indices(N, 32))


def test_state_dict_fields_match_jax_layout():
    p0 = np.random.default_rng(14).normal(size=(N, D))
    for spec_kw in (dict(method="rff", num_features=64, rff_redraw="step"),
                    dict(method="nystrom", num_landmarks=16)):
        method = spec_kw.pop("method")
        jst = jax_dist(4, p0, kernel_approx=japprox.KernelApprox(method, **spec_kw)
                       ).state_dict()
        tst = port_dist(4, p0, kernel_approx=KernelApprox(method, **spec_kw)).state_dict()
        jkeys = {k for k in jst if k.startswith("approx_")} - {"approx_bank_key"}
        tkeys = {k for k in tst if k.startswith("approx_")} - {"approx_bank_seed"}
        assert jkeys == tkeys
        for k in jkeys:
            np.testing.assert_array_equal(np.asarray(tst[k]), np.asarray(jst[k]))
            assert np.asarray(tst[k]).dtype == np.asarray(jst[k]).dtype


@pytest.mark.parametrize("saved,loader,match", [
    (dict(kernel_approx="rff"), dict(kernel_approx="nystrom"), "nystrom.*rff|rff.*nystrom"),
    (dict(kernel_approx="rff"), dict(kernel_approx=KernelApprox("rff", num_features=64)),
     "dial"),
    (dict(kernel_approx="rff"), dict(), "exact"),
    (dict(), dict(kernel_approx="rff"), "exact"),
    (dict(kernel_approx=KernelApprox("rff", 64, rff_redraw="step")),
     dict(kernel_approx=KernelApprox("rff", 64)), "rff_redraw"),
])
def test_approx_config_mismatches_refused(saved, loader, match):
    p0 = np.zeros((N, D))
    st = port_dist(4, p0, seed=7, **saved).state_dict()
    with pytest.raises(ValueError, match=match):
        port_dist(4, p0, **loader).load_state_dict(st)


def test_saved_crossover_pin_wins_across_a_reshard(jax_factor):
    spec = KernelApprox("rff", num_features=16)  # F = 32
    p0 = np.random.default_rng(15).normal(size=(128, D))
    mk = lambda S: port_dist(S, p0, exchange_particles=False,  # noqa: E731
                             kernel_approx=spec, phi_impl="auto")
    a = mk(2)
    assert a.kernel_approx_active  # 128·64 ≥ (128+64)·32
    st = a.state_dict()
    b = mk(8)
    assert not b.kernel_approx_active  # 128·16 < (128+16)·32
    resharded = tck.reshard_state(dict(st), 8)
    for k in ("approx_method", "approx_dial", "approx_active", "approx_bank_seed",
              "approx_rff_redraw"):
        np.testing.assert_array_equal(resharded[k], st[k])
    b.load_state_dict(resharded)
    assert b.kernel_approx_active
    assert torch.isfinite(b.run_steps(2, 0.05)).all()
    # JAX's reshard passes the port's fields through, as the port's passes JAX's
    jout = jck.reshard_state(dict(st), 8)
    np.testing.assert_array_equal(jout["approx_bank_seed"], st["approx_bank_seed"])


def test_jax_save_resumes_in_the_port_on_its_own_bank():
    """A JAX RFF save: method, dial, redraw and the active pin carry over and
    refuse or win as in JAX; the threefry bank key cannot be followed, so
    the port resumes on its own bank — pinned here by the JAX bank handed
    back through the seam, which then reproduces JAX's continuation."""
    p0 = np.random.default_rng(16).normal(size=(N, D))
    jd = jax_dist(4, p0, seed=6, kernel=JRBF(1.3), kernel_approx=japprox.KernelApprox("rff", 16))
    jd.run_steps(3, 0.05)
    jstate = {k: (None if v is None else np.asarray(v)) for k, v in jd.state_dict().items()}
    want = jd.run_steps(4, 0.05)
    carried = state_from_jax(jstate, "cpu")
    assert "approx_bank_key" not in carried and int(carried["approx_method"]) == 0
    td = port_dist(4, p0, seed=6, kernel=RBF(1.3),
                   kernel_approx=spec_for("rff", 6, num_features=16))
    td.load_state_dict(carried)
    assert td.kernel_approx.seed == approx_bank_seed(6)  # its own bank seed stays
    close(td.run_steps(4, 0.05), want)
    with pytest.raises(ValueError, match="dial"):
        port_dist(4, p0, kernel_approx=KernelApprox("rff", 32)).load_state_dict(carried)
    with pytest.raises(ValueError, match="exact"):
        port_dist(4, p0).load_state_dict(carried)


def test_port_save_resumes_in_jax_with_its_pin(jax_factor):
    """A port save in JAX: the identity fields are JAX's, so JAX refuses a
    mismatch and adopts the saved pin; it keeps its own bank key (the
    port's ``approx_bank_seed`` is not its field)."""
    p0 = np.random.default_rng(17).normal(size=(128, D))
    spec_kw = dict(num_features=16)
    td = port_dist(2, p0, seed=6, exchange_particles=False, phi_impl="auto",
                   kernel_approx=spec_for("rff", 6, **spec_kw))
    td.run_steps(2, 0.05)
    st = td.state_dict()
    jstate = {k: (v.cpu().numpy() if isinstance(v, torch.Tensor) else v)
              for k, v in st.items()}
    jd = jax_dist(8, p0, seed=6, exchange_particles=False, phi_impl="auto",
                  kernel_approx=japprox.KernelApprox("rff", **spec_kw))
    assert not jd.kernel_approx_active
    jd.load_state_dict(jck.reshard_state(dict(jstate), 8))
    assert jd.kernel_approx_active
    tresumed = port_dist(8, p0, seed=6, exchange_particles=False, phi_impl="auto",
                         kernel_approx=spec_for("rff", 6, **spec_kw))
    tresumed.load_state_dict(tck.reshard_state(dict(st), 8))
    close(tresumed.run_steps(2, 0.05), jd.run_steps(2, 0.05))
    with pytest.raises(ValueError, match="exact"):
        jax_dist(2, p0, exchange_particles=False).load_state_dict(jstate)


# --------------------------------------------------------------------- #
# tools/large_n.py --kernel-approx


@pytest.mark.parametrize("method,flag", [("rff", "--num-features"),
                                         ("nystrom", "--num-landmarks")])
def test_large_n_approx_row_on_the_cpu(capsys, method, flag):
    argv = ["--device", "cpu", "--kernel-approx", method, "--n", "128", flag, "32",
            "--approx-pin-n", "96", "--exact-probe-n", "48", "--steps", "2",
            "--samples", "1"]
    assert large_n.main(argv) == 0
    row = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert row["bench"] == "large_n_approx" and row["method"] == method
    assert row["dial"] == 32 and row["within_budget"] and row["kernel_approx_active"]
    assert row["recompiles"] is None and row["sentry_supported"] is False
    assert row["exact_probe_n"] == 48 and row["wall_per_step_s"] > 0
    assert large_n.approx_row_ok(row) == (True, [])


def test_approx_row_ok_gates_match_jax(monkeypatch):
    from test_torch_cadences import _load
    from pathlib import Path

    jtool = _load("_large_n_tool", Path(__file__).resolve().parents[1] / "tools"
                  / "large_n.py", monkeypatch)
    good = {"within_budget": True, "sentry_supported": True, "recompiles": 0,
            "wall_per_step_s": 0.5, "kernel_approx_active": True}
    for row in (good, dict(good, within_budget=False), dict(good, recompiles=2),
                dict(good, wall_per_step_s=float("nan")),
                dict(good, kernel_approx_active=False),
                dict(good, sentry_supported=False, recompiles=None)):
        assert large_n.approx_row_ok(row) == jtool.approx_row_ok(row)
