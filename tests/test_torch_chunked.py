"""The port's chunked execution against its monolithic one and against JAX
(``tests/test_chunked.py:50-354``, ``tests/test_record_chunking.py:123,
141``), on the CPU, float64 unless noted.

Pinned: ring-hop chunks (``hops_per_dispatch`` 1, 2, S) equal the
monolithic ring step at rtol 1e-12 in both ``all_*`` modes, with
minibatches and with the history; the dual advance split into chunks
equals the unsplit solve at rtol 1e-6 (the torch route; the fused and
streaming ``duals_only`` solves, float32, against JAX's under the Pallas
interpreter at ``tests/test_pallas_ot.py``'s 1e-4); ``iters == 0`` is the
bare start pair, on the streaming route without C; the chunked W2 step
tracks the monolithic one at JAX's 1e-4; the planner's three outcomes, its
errors and its dispatch counts match JAX's; ``Sampler.run``'s
``dispatch_budget`` chunks and its warning."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import dist_svgd_tpu as jdt
from dist_svgd_tpu.models.logreg import logreg_logp as jlogreg_logp
from dist_svgd_tpu.ops import pallas_ot as jpo

import dist_svgd_torch as tdt
from dist_svgd_torch.models.gmm import gmm_logp
from dist_svgd_torch.models.logreg import logreg_logp
from dist_svgd_torch.ops import cuda_ot, ot
from dist_svgd_torch.ops.ot import sinkhorn_dual_advance, wasserstein_grad_sinkhorn

from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

S = 4
#: hop chunks against the monolithic ring (the same accumulation order).
HOP_RTOL, HOP_ATOL = 1e-12, 1e-14


def problem(n=16, d=3, rows=24, seed=17):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(rows, d - 1))
    t = np.where(rng.normal(size=rows) > 0, 1.0, -1.0)
    return rng.normal(size=(n, d)), x, t


def build(parts, x, t, exch_s=False, w2=False, impl="ring", iters=40, **kw):
    return tdt.DistSampler(S, logreg_logp, None, parts, data=(x, t), exchange_particles=True,
                           exchange_scores=exch_s, include_wasserstein=w2,
                           wasserstein_solver="sinkhorn", sinkhorn_iters=iters,
                           exchange_impl=impl, phi_impl="torch", device="cpu", **kw)


# --------------------------------------------------------------------------
# Ring-hop chunks


@pytest.mark.parametrize("exch_s", [False, True])
@pytest.mark.parametrize("hpd", [1, 2, 3, S])
def test_ring_hop_chunks_match_monolithic(exch_s, hpd):
    parts, x, t = problem()
    want = build(parts, x, t, exch_s).run_steps(3, 0.05)
    chunked = build(parts, x, t, exch_s)
    got = chunked.run_steps(3, 0.05, hops_per_dispatch=hpd)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=HOP_RTOL, atol=HOP_ATOL)
    stats = chunked.last_run_stats
    assert stats["execution"] == "intra_step"
    hop_chunks = -(-S // hpd)
    per_step = (2 * hop_chunks + 2) if exch_s else (hop_chunks + 1)  # JAX's counts
    assert stats["num_dispatches"] == 3 * per_step
    assert stats["dispatches_per_step"] == per_step


def test_ring_hop_chunks_with_minibatch():
    """Every chunk of a step takes the step's one minibatch."""
    parts, x, t = problem(rows=32)
    want = build(parts, x, t, batch_size=4, seed=2).run_steps(3, 0.05)
    got = build(parts, x, t, batch_size=4, seed=2).run_steps(3, 0.05, hops_per_dispatch=1)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=HOP_RTOL, atol=HOP_ATOL)


def test_chunked_record_history_matches_and_is_host_side():
    """test_chunked.py's record case and test_record_chunking.py:141: the
    intra-step history is a host array equal to the monolithic one."""
    parts, x, t = problem()
    want_final, want_hist = build(parts, x, t).run_steps(4, 0.05, record=True)
    ds = build(parts, x, t)
    got_final, got_hist = ds.run_steps(4, 0.05, record=True, hops_per_dispatch=2)
    assert ds.last_run_stats["execution"] == "intra_step"
    assert isinstance(got_hist, np.ndarray)
    np.testing.assert_allclose(got_hist, want_hist.numpy(), rtol=HOP_RTOL, atol=HOP_ATOL)
    np.testing.assert_allclose(got_final.numpy(), want_final.numpy(), rtol=HOP_RTOL,
                               atol=HOP_ATOL)


def test_ring_hop_chunks_match_jax_ring():
    """The hop-chunked port against JAX's monolithic ring (vmap emulation)
    at the packages' float64 1e-10."""
    parts, x, t = problem()
    js = jdt.DistSampler(S, jlogreg_logp, None, jnp.asarray(parts),
                         data=(jnp.asarray(x), jnp.asarray(t)), exchange_particles=True,
                         exchange_scores=True, include_wasserstein=False, mesh=None,
                         exchange_impl="ring", phi_impl="xla")
    got = build(parts, x, t, True).run_steps(3, 0.05, hops_per_dispatch=1)
    np.testing.assert_allclose(got.numpy(), np.asarray(js.run_steps(3, 0.05)), rtol=1e-10,
                               atol=1e-12)


# --------------------------------------------------------------------------
# The resumable Sinkhorn solve


def test_sinkhorn_dual_advance_split_equals_unsplit():
    """240 iterations as 3 × 60 dual advances plus a 60-iteration finish
    against one 240-iteration solve: rtol 1e-6 (JAX's pin; each resume's
    start is one exact iteration, so the split solve is ahead)."""
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.normal(size=(30, 3)))
    y = torch.from_numpy(rng.normal(size=(30, 3)) + 0.1)
    g0 = torch.zeros(30, dtype=x.dtype)
    want, g_want = wasserstein_grad_sinkhorn(x, y, iters=240, tol=None, g_init=g0,
                                             return_g=True)
    g = g0
    for _ in range(3):
        g = sinkhorn_dual_advance(x, y, iters=60, tol=None, g_init=g)
    got, g_got = wasserstein_grad_sinkhorn(x, y, iters=60, tol=None, g_init=g, return_g=True)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6, atol=1e-8)
    np.testing.assert_allclose(g_got.numpy(), g_want.numpy(), rtol=1e-5, atol=1e-6)


def test_sinkhorn_dual_advance_matches_jax_and_its_iters_zero_start():
    """The torch route against JAX's 'xla' at 1e-10 (float64); iters=0 is
    the bare start pair's g (cold and warm), as in JAX."""
    from dist_svgd_tpu.ops.ot import sinkhorn_dual_advance as jadv

    rng = np.random.default_rng(7)
    x, y = rng.normal(size=(12, 2)), rng.normal(size=(12, 2))
    gi = rng.normal(size=12)
    for iters, g_init in ((0, None), (0, gi), (25, gi), (25, None)):
        got = sinkhorn_dual_advance(torch.from_numpy(x), torch.from_numpy(y), iters=iters,
                                    g_init=None if g_init is None else torch.from_numpy(g_init))
        want = jadv(jnp.asarray(x), jnp.asarray(y), iters=iters,
                    g_init=None if g_init is None else jnp.asarray(g_init))
        assert got.shape == (12,) and torch.isfinite(got).all()
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-10, atol=1e-12)
    with pytest.raises(ValueError, match="impl"):
        sinkhorn_dual_advance(torch.from_numpy(x), torch.from_numpy(y), impl="xla")


@pytest.mark.parametrize("route", ["fused", "streaming"])
@pytest.mark.parametrize("warm", [False, True])
def test_kernel_routes_duals_only_match_jax(route, warm):
    """The fused and streaming solves' duals_only mode (their plain versions
    on CPU float32) against JAX's under the Pallas interpreter, at
    tests/test_pallas_ot.py's 1e-4."""
    rng = np.random.default_rng(11)
    x = rng.normal(size=(24, 3)).astype(np.float32)
    y = (rng.normal(size=(40, 3)) + 0.3).astype(np.float32)
    g0 = (0.1 * rng.normal(size=40)).astype(np.float32) if warm else None
    port_fn = getattr(cuda_ot, f"sinkhorn_grad_{route}")
    jax_fn = getattr(jpo, f"sinkhorn_grad_{route}")
    got = port_fn(torch.from_numpy(x), torch.from_numpy(y), iters=30, tol=None,
                  g_init=None if g0 is None else torch.from_numpy(g0), duals_only=True)
    want = jax_fn(jnp.asarray(x), jnp.asarray(y), iters=30, tol=None,
                  g_init=None if g0 is None else jnp.asarray(g0), duals_only=True,
                  interpret=True)
    assert got.dtype == torch.float32 and got.shape == (40,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
    _, g_full = port_fn(torch.from_numpy(x), torch.from_numpy(y), iters=30, tol=None,
                        g_init=None if g0 is None else torch.from_numpy(g0), return_g=True)
    torch.testing.assert_close(got, g_full, rtol=0, atol=0)  # the same loop, no finish


def test_streaming_iters_zero_builds_no_cost_matrix(monkeypatch):
    """On the streaming route iters=0 is the start pair from the two
    c-transform passes: no C, no plan (JAX ops/ot.py:499-508)."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(size=(2, 10, 3)).astype(np.float32))
    y = torch.from_numpy(rng.normal(size=(2, 14, 3)).astype(np.float32))
    g = torch.from_numpy(rng.normal(size=(2, 14)).astype(np.float32))

    def no_cost(*a, **k):
        raise AssertionError("the streaming start built C")

    monkeypatch.setattr(ot, "_resolve_sinkhorn_route", lambda a, b, impl: "streaming")
    monkeypatch.setattr(ot, "squared_distances", no_cost)
    monkeypatch.setattr(ot, "sinkhorn_plan", no_cost)
    got = sinkhorn_dual_advance(x, y, iters=0, g_init=g)
    _, _, _, g0, _, reg, _ = cuda_ot._solve_setup(x, y, 0.05, g)
    torch.testing.assert_close(got, g0 * reg[:, None], rtol=0, atol=0)


@pytest.mark.parametrize("passes", [20, 40])
def test_chunked_w2_matches_monolithic(passes):
    """Ring hops of one and split solves against the monolithic W2 ring
    step: JAX's rtol 1e-4 (the split solves meet at convergence; measured
    there 7.4e-6), and one more step stays in lockstep."""
    parts, x, t = problem()
    kw = dict(w2=True, iters=80, w2_pairing="block", sinkhorn_tol=None)
    mono, chunked = build(parts, x, t, **kw), build(parts, x, t, **kw)
    want = mono.run_steps(4, 0.05, h=0.5)
    got = chunked.run_steps(4, 0.05, h=0.5, hops_per_dispatch=1,
                            max_passes_per_dispatch=passes)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4, atol=1e-8)
    split = -(-80 // passes)
    # per W2 step: split solve dispatches, S hops and the finish; step 1 has no W2
    assert chunked.last_run_stats["num_dispatches"] == 4 * (S + 1) + 3 * split
    np.testing.assert_allclose(
        chunked.run_steps(1, 0.05, h=0.5, hops_per_dispatch=1,
                          max_passes_per_dispatch=passes).numpy(),
        mono.run_steps(1, 0.05, h=0.5).numpy(), rtol=1e-4, atol=1e-8)


def test_chunked_w2_gather_and_cold_start_match_eager():
    """The gather step with a split solve (at sinkhorn_tol=None and 200
    iterations: under a tol exit, or short of convergence, a split and an
    unsplit solve legitimately differ by the solve's own fixpoint
    distance), and sinkhorn_warm_start=False (the first chunk of each solve
    cold; JAX's case, 60 iterations at its default tol), against the eager
    make_step."""
    for iters, kw in ((200, dict(impl="gather", sinkhorn_tol=None)),
                      (60, dict(sinkhorn_warm_start=False, w2_pairing="block"))):
        rng = np.random.default_rng(37)  # JAX's test_chunked.py problem
        parts, x = rng.normal(size=(8, 2)), rng.normal(size=(24, 1))
        t = np.where(rng.normal(size=24) > 0, 1.0, -1.0)
        eager = build(parts, x, t, w2=True, iters=iters, **kw)
        for _ in range(3):
            want = eager.make_step(0.05, h=0.5)
        chunked = build(parts, x, t, w2=True, iters=iters, **kw)
        got = chunked.run_steps(3, 0.05, h=0.5, max_passes_per_dispatch=iters // 2,
                                hops_per_dispatch=1 if kw.get("impl") != "gather" else None)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4, atol=1e-6)


# --------------------------------------------------------------------------
# The dispatch_budget planner


def test_budget_selects_monolithic_when_run_fits():
    parts, x, t = problem()
    ds = build(parts, x, t)
    ds.run_steps(2, 0.05, dispatch_budget=1e9)
    assert ds.last_run_stats["execution"] == "monolithic"
    assert ds.last_run_stats["num_dispatches"] == 1


def test_budget_selects_scan_chunks_when_step_fits():
    n = 8 * S
    parts, x, t = problem(n=n)
    want = build(parts, x, t).run_steps(5, 0.05)
    ds = build(parts, x, t)
    got = ds.run_steps(5, 0.05, dispatch_budget=2.0, pairs_per_sec=float(n * n))
    stats = ds.last_run_stats
    assert stats["execution"] == "scan_chunks" and stats["steps_per_dispatch"] == 2
    assert stats["num_dispatches"] == 3  # 2 + 2 + 1
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_budget_selects_intra_step_past_the_boundary():
    parts, x, t = problem()
    want = build(parts, x, t).run_steps(2, 0.05)
    ds = build(parts, x, t)
    got = ds.run_steps(2, 0.05, dispatch_budget=1.0, pairs_per_sec=1.0)
    assert ds.last_run_stats["execution"] == "intra_step"
    assert ds.last_run_stats["hops_per_dispatch"] == 1
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=HOP_RTOL, atol=HOP_ATOL)


@pytest.mark.parametrize("num_steps,budget,pps", [(5, 1e9, None), (5, 2.0, 1024.0),
                                                  (2, 1.0, 1.0), (6, 2.0, 1600.0)])
def test_plan_matches_jax_planner(num_steps, budget, pps):
    """The same arithmetic: the plan JAX's _plan_dispatches gives for the
    same sampler configuration, with and without the W2 term."""
    parts, x, t = problem(n=32)
    for w2 in (False, True):
        ours = build(parts, x, t, w2=w2, w2_pairing="block")
        theirs = jdt.DistSampler(S, jlogreg_logp, None, jnp.asarray(parts),
                                 data=(jnp.asarray(x), jnp.asarray(t)),
                                 exchange_particles=True, exchange_scores=False,
                                 include_wasserstein=w2, wasserstein_solver="sinkhorn",
                                 sinkhorn_iters=40, w2_pairing="block", mesh=None,
                                 exchange_impl="ring")
        assert ours._plan_dispatches(num_steps, budget, pps) == \
            theirs._plan_dispatches(num_steps, budget, pps)


def test_budget_scan_chunks_record_and_w2_state_flow():
    """Whole-step chunks with the history and the carried W2 state: the
    histories join without duplicates and equal one run."""
    parts, x, t = problem(n=8, d=2)
    kw = dict(w2=True, iters=40, w2_pairing="block")
    want_final, want_hist = build(parts, x, t, **kw).run_steps(6, 0.05, h=0.5, record=True)
    ds = build(parts, x, t, **kw)
    got_final, got_hist = ds.run_steps(6, 0.05, h=0.5, record=True, dispatch_budget=2.0,
                                       pairs_per_sec=float(64 + 43 * 64 / S))
    assert ds.last_run_stats["execution"] == "scan_chunks"
    assert isinstance(got_hist, np.ndarray) and got_hist.shape == (6, 8, 2)
    np.testing.assert_array_equal(got_hist, want_hist.numpy())
    torch.testing.assert_close(got_final, want_final, rtol=0, atol=0)


def test_lagged_budget_chunks_whole_macro_steps():
    parts, x, t = problem(n=16)
    kw = dict(impl="gather", exchange_every=2)
    want = build(parts, x, t, **kw).run_steps(6, 0.05)
    ds = build(parts, x, t, **kw)
    got = ds.run_steps(6, 0.05, dispatch_budget=3.0, pairs_per_sec=256.0)
    assert ds.last_run_stats["steps_per_dispatch"] == 2
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    with pytest.raises(ValueError, match="lagged macro-step"):
        ds.run_steps(2, 0.05, dispatch_budget=0.5, pairs_per_sec=256.0)


def test_executor_constraint_errors():
    parts, x, t = problem()
    ds = build(parts, x, t)
    with pytest.raises(ValueError, match="not both"):
        ds.run_steps(1, 0.05, dispatch_budget=1.0, hops_per_dispatch=1)
    with pytest.raises(ValueError, match="positive"):
        ds.run_steps(1, 0.05, dispatch_budget=0.0)
    with pytest.raises(ValueError, match=">= 1"):
        ds.run_steps(1, 0.05, hops_per_dispatch=0)
    with pytest.raises(ValueError, match="positive"):
        ds.run_steps(1, 0.05, dispatch_budget=1.0, pairs_per_sec=-1.0)
    gather = build(parts, x, t, impl="gather")
    with pytest.raises(ValueError, match="hop seam"):
        gather.run_steps(1, 0.05, hops_per_dispatch=1)
    with pytest.raises(ValueError, match="ring"):
        gather.run_steps(2, 0.05, dispatch_budget=1.0, pairs_per_sec=1.0)
    with pytest.raises(ValueError, match="sinkhorn"):
        ds.run_steps(1, 0.05, max_passes_per_dispatch=4)
    adaptive = tdt.DistSampler(S, logreg_logp, "median_step", parts, data=(x, t),
                               include_wasserstein=False, exchange_impl="ring",
                               phi_impl="torch", device="cpu")
    with pytest.raises(ValueError, match="median"):
        adaptive.run_steps(1, 0.05, hops_per_dispatch=1)


def test_time_dispatches_records_the_longest_wall():
    parts, x, t = problem()
    ds = build(parts, x, t)
    ds.run_steps(2, 0.05, hops_per_dispatch=2, time_dispatches=True)
    wall = ds.last_run_stats["max_dispatch_wall_s"]
    assert isinstance(wall, float) and wall > 0
    ds.run_steps(2, 0.05, hops_per_dispatch=2)
    assert ds.last_run_stats["max_dispatch_wall_s"] is None


# --------------------------------------------------------------------------
# Sampler.run(dispatch_budget=...)


def _gmm_sampler(**kw):
    return tdt.Sampler(1, lambda th: gmm_logp(th), phi_impl="torch", device="cpu", **kw)


def test_sampler_dispatch_budget_matches_monolithic():
    want_final, want_hist = _gmm_sampler().run(32, 7, 0.3, seed=0, dtype=torch.float64)
    s = _gmm_sampler()
    got_final, got_hist = s.run(32, 7, 0.3, seed=0, dtype=torch.float64, dispatch_budget=3.0,
                                pairs_per_sec=32.0 * 32.0)
    assert s.last_run_stats["execution"] == "scan_chunks"
    assert s.last_run_stats["num_dispatches"] == 3
    assert isinstance(got_hist, np.ndarray) and got_hist.shape == (8, 32, 1)
    torch.testing.assert_close(got_final, want_final, rtol=0, atol=0)
    np.testing.assert_array_equal(got_hist, want_hist.numpy())
    s.run(32, 7, 0.3, seed=0, dispatch_budget=1e9)
    assert s.last_run_stats["execution"] == "monolithic"
    assert s.last_run_stats["num_dispatches"] == 1


def test_sampler_budget_minibatch_stream_is_chunk_invariant():
    rng = np.random.default_rng(0)
    x, y = rng.normal(size=(40, 2)), rng.normal(size=40)

    def logp(th, data):
        xx, yy = data
        return -torch.sum((yy - xx @ th) ** 2) - 0.1 * torch.sum(th * th)

    a = tdt.Sampler(2, logp, data=(x, y), batch_size=8, phi_impl="torch", device="cpu")
    want, _ = a.run(24, 6, 1e-3, seed=3, record=False, dtype=torch.float64)
    b = tdt.Sampler(2, logp, data=(x, y), batch_size=8, phi_impl="torch", device="cpu")
    got, _ = b.run(24, 6, 1e-3, seed=3, record=False, dtype=torch.float64,
                   dispatch_budget=1.0, pairs_per_sec=24.0 * 24.0 * 2)
    assert b.last_run_stats["num_dispatches"] > 1
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_sampler_single_step_over_budget_warns():
    s = _gmm_sampler()
    with pytest.warns(UserWarning, match="no internal seam"):
        s.run(16, 2, 0.3, record=False, dispatch_budget=0.5, pairs_per_sec=1.0)
    assert s.last_run_stats["steps_per_dispatch"] == 1
    with pytest.raises(ValueError, match="positive"):
        s.run(16, 2, 0.3, dispatch_budget=0.0)


def test_sampler_dispatch_budget_record_returns_host_history():
    """test_record_chunking.py:123: a budget-chunked recorded run returns
    its history on the host, equal to the monolithic one."""
    want_final, want_hist = _gmm_sampler().run(8, 6, 0.1, seed=1)
    s = _gmm_sampler()
    got_final, got_hist = s.run(8, 6, 0.1, seed=1, dispatch_budget=1.0,
                                pairs_per_sec=8 * 8 / 0.5)
    assert s.last_run_stats["execution"] == "scan_chunks"
    assert isinstance(got_hist, np.ndarray)
    np.testing.assert_array_equal(got_hist, want_hist.numpy())
    torch.testing.assert_close(got_final, want_final, rtol=0, atol=0)
