"""The port's W2/JKO solvers (dist_svgd_torch/ops/ot.py) against the JAX
package's (dist_svgd_tpu/ops/ot.py) and the float64 oracle, on the CPU.

The same numpy point sets go to both.  The LP is held to the oracle at
tests/test_ot.py's 1e-8; the torch-route Sinkhorn in float64 to JAX's
impl='xla' at 1e-10 (same algorithm, same arithmetic, float64 roundoff
only)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from dist_svgd_tpu.ops import ot as jot

from dist_svgd_torch.ops import ot
from dist_svgd_torch.ops.kernels import squared_distances

from _oracle import wasserstein_grad as oracle_wgrad
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)


@pytest.fixture
def rng():
    return np.random.default_rng(13)


def _pts(rng, k, m, d=3, shift=0.3):
    return rng.normal(size=(k, d)), rng.normal(size=(m, d)) + shift


def _t(a):
    return None if a is None else torch.tensor(np.asarray(a))


def _j(a):
    return None if a is None else jnp.asarray(np.asarray(a))


@pytest.mark.parametrize("k,m", [(6, 6), (7, 4)])
def test_lp_matches_oracle_and_jax(rng, k, m):
    x, y = _pts(rng, k, m, d=2)
    got = ot.wasserstein_grad_lp(torch.tensor(x), torch.tensor(y))
    np.testing.assert_allclose(got, oracle_wgrad(x, y), atol=1e-8)
    np.testing.assert_allclose(got, jot.wasserstein_grad_lp(x, y), atol=1e-8)


def _warm_g(x, y):
    """A realistic carried dual: JAX's converged g for a nearby problem."""
    _, g = jot.wasserstein_grad_sinkhorn(jnp.asarray(x + 0.01), jnp.asarray(y), eps=0.05,
                                         iters=100, return_g=True, impl="xla")
    return np.asarray(g)


@pytest.mark.parametrize("tol", [None, 1e-2])
@pytest.mark.parametrize("warm", [False, True])
def test_sinkhorn_plan_matches_jax_f64(rng, tol, warm):
    x, y = _pts(rng, 9, 7)
    g0 = _warm_g(x, y) if warm else None
    want, (wf, wg) = jot.sinkhorn_plan(jnp.asarray(x), jnp.asarray(y), eps=0.05, iters=60,
                                      tol=tol, g_init=_j(g0), return_potentials=True)
    got, (gf, gg) = ot.sinkhorn_plan(_t(x), _t(y), eps=0.05, iters=60, tol=tol,
                                     g_init=_t(g0), return_potentials=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-10, atol=1e-14)
    np.testing.assert_allclose(gf.numpy(), np.asarray(wf), rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(gg.numpy(), np.asarray(wg), rtol=1e-10, atol=1e-12)
    # the last half-iteration fits the column marginal exactly
    np.testing.assert_allclose(got.sum(0).numpy(), np.full(7, 1 / 7), atol=1e-12)


@pytest.mark.parametrize("tol", [None, 1e-2])
@pytest.mark.parametrize("warm", [False, True])
def test_grad_sinkhorn_matches_jax_xla_f64(rng, tol, warm):
    x, y = _pts(rng, 24, 40)
    g0 = _warm_g(x, y) if warm else None
    want, want_g = jot.wasserstein_grad_sinkhorn(
        jnp.asarray(x), jnp.asarray(y), eps=0.05, iters=60, tol=tol, g_init=_j(g0),
        return_g=True, impl="xla")
    got, got_g = ot.wasserstein_grad_sinkhorn(_t(x), _t(y), eps=0.05, iters=60, tol=tol,
                                              g_init=_t(g0), return_g=True)
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-10, atol=1e-13)
    np.testing.assert_allclose(got_g.numpy(), np.asarray(want_g), rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("warm", [False, True])
def test_bare_start_iters_zero_matches_jax(rng, warm):
    x, y = _pts(rng, 8, 11)
    g0 = _warm_g(x, y) if warm else None
    want, want_g = jot.wasserstein_grad_sinkhorn(jnp.asarray(x), jnp.asarray(y), iters=0,
                                                 g_init=_j(g0), return_g=True)
    got, got_g = ot.wasserstein_grad_sinkhorn(_t(x), _t(y), iters=0, g_init=_t(g0),
                                              return_g=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-10, atol=1e-13)
    np.testing.assert_allclose(got_g.numpy(), np.asarray(want_g), rtol=1e-10, atol=1e-12)


def test_lanes_exit_at_different_blocks_match_jax_vmap(rng):
    """Lanes that meet the tol exit at different blocks: each lane is frozen
    at its own exit, as JAX's batched while_loop freezes it under vmap —
    not run on until the slowest lane converges."""
    S, k, m = 3, 10, 14
    x = rng.normal(size=(S, k, 2))
    y = rng.normal(size=(S, m, 2)) + 0.2
    x[1] *= 3.0  # a harder lane: more blocks to the exit
    y[2] = np.concatenate([x[2], x[2, :m - k]]) + 1e-2 * rng.normal(size=(m, 2))
    kw = dict(eps=0.05, iters=200, tol=1e-3, absorb_every=3, return_g=True)
    want, want_g = jax.vmap(lambda a, b: jot.wasserstein_grad_sinkhorn(
        a, b, impl="xla", **kw))(jnp.asarray(x), jnp.asarray(y))
    got, got_g = ot.wasserstein_grad_sinkhorn(_t(x), _t(y), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-10, atol=1e-13)
    np.testing.assert_allclose(got_g.numpy(), np.asarray(want_g), rtol=1e-10, atol=1e-12)
    # the lanes do exit at different blocks, so the freeze is what is pinned
    blocks = []
    for r in range(S):
        cost = squared_distances(_t(x[r:r + 1]), _t(y[r:r + 1]))
        f0, g0 = ot._sinkhorn_start(cost, 0.05, None)
        reg = ot._reg(cost, 0.05)
        count = []

        def make_ops(f, g, cost=cost, reg=reg, count=count):
            count.append(1)
            kmat = torch.exp((f[..., :, None] + g[..., None, :] - cost) / reg[:, None, None])
            return ((lambda v: torch.matmul(kmat, v[..., None])[..., 0]),
                    (lambda u: torch.matmul(kmat.transpose(-1, -2), u[..., None])[..., 0]),
                    kmat)

        ot._sinkhorn_scaling_loop(f0, g0, make_ops, reg[:, None], k, m, 200, 1e-3, 3)
        blocks.append(len(count))
    assert len(set(blocks)) > 1, blocks


def test_tol_respects_iteration_cap(rng):
    """tests/test_ot.py:test_sinkhorn_tol_respects_iteration_cap: an
    unreachable tol runs the capped number of blocks, equal to tol=None."""
    x, y = _pts(rng, 6, 5)
    capped = ot.sinkhorn_plan(_t(x), _t(y), eps=0.01, iters=30, tol=1e-30)
    fixed = ot.sinkhorn_plan(_t(x), _t(y), eps=0.01, iters=30)
    torch.testing.assert_close(capped, fixed, rtol=1e-12, atol=0)


def test_route_resolution_and_refusals(rng):
    """On the CPU 'auto' is the torch route (as JAX's 'auto' off-TPU); the
    forced kernel route refuses CPU tensors; unknown impls raise."""
    x, y = (torch.tensor(a, dtype=torch.float32) for a in _pts(rng, 5, 6))
    assert ot._resolve_sinkhorn_route(x[None], y[None], "auto") == "torch"
    assert ot._resolve_sinkhorn_route(x[None], y[None], "torch") == "torch"
    with pytest.raises(ValueError, match="CUDA tensors"):
        ot.wasserstein_grad_sinkhorn(x, y, iters=5, impl="cuda")
    with pytest.raises(ValueError, match="unknown sinkhorn impl"):
        ot.wasserstein_grad_sinkhorn(x, y, impl="xla")
    with pytest.raises(ValueError, match="absorb_every"):
        ot.sinkhorn_plan(x, y, absorb_every=0)
    # the streaming line is per lane: 8 lanes of 1250 × 10,000 stay fused
    assert 1250 * 10_000 < ot.FUSED_SINKHORN_STREAM_MIN_PAIRS <= 12_500 * 100_000


def test_sinkhorn_tracks_lp_at_small_eps(rng):
    """tests/test_ot.py:test_sinkhorn_approaches_lp on the torch route."""
    x, y = _pts(rng, 5, 5, d=2, shift=0.0)
    lp = ot.wasserstein_grad_lp(x, y)
    sk = ot.wasserstein_grad_sinkhorn(_t(x), _t(y), eps=0.002, iters=3000).numpy()
    np.testing.assert_allclose(sk, lp, atol=0.05)
