"""The Sinkhorn kernels' plain versions and the card's two Sinkhorn routes
(dist_svgd_torch/ops/cuda_ot.py) against the JAX package's Pallas kernels
and solves (dist_svgd_tpu/ops/pallas_ot.py) under the Pallas interpreter,
on the CPU — where every wrapper takes its kernel's plain version.

Tolerances are tests/test_pallas_ot.py's: the kernels rtol 1e-5 (hard
c-transform 1e-6), the solves rtol 1e-4 with atol 1e-5 on the gradient and
1e-4 on the dual (float32 on both sides, different reduction orders).  The
kernels themselves are held against these plain versions on the card by
chip_smoke.py."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from dist_svgd_tpu.ops import ot as jot
from dist_svgd_tpu.ops import pallas_ot as jpo

from dist_svgd_torch.ops import cuda_ot
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)


@pytest.fixture
def rng():
    return np.random.default_rng(7)


def _lanes(rng, S, k, m, d=3):
    """float32 lanes: rows (S, k, d), cols (S, m, d) + 0.3, and potentials."""
    x = rng.normal(size=(S, k, d)).astype(np.float32)
    y = (rng.normal(size=(S, m, d)) + 0.3).astype(np.float32)
    f = (0.5 * rng.normal(size=(S, k))).astype(np.float32)
    g = (0.5 * rng.normal(size=(S, m))).astype(np.float32)
    return x, y, f, g


def _per_lane(fn, *arrays):
    """JAX's unbatched kernel over each lane, stacked."""
    return np.stack([np.asarray(fn(*(jnp.asarray(a[s]) for a in arrays)))
                     for s in range(arrays[0].shape[0])])


def T(a):
    return torch.tensor(np.asarray(a))


@pytest.mark.parametrize("soft", [False, True])
@pytest.mark.parametrize("d", [1, 3, 8])
def test_ctransform_plain_matches_pallas(rng, soft, d):
    x, y, _, p = _lanes(rng, 2, 37, 53, d)
    got = cuda_ot.ctransform_reduce(T(x), T(y), T(p), soft=soft)
    want = _per_lane(lambda a, b, c: jpo.ctransform_reduce(a, b, c, 1.0, soft, interpret=True),
                     x, y, p)
    tol = 1e-5 if soft else 1e-6
    np.testing.assert_allclose(got.numpy(), want, rtol=tol, atol=tol)


def test_kexp_plain_matches_pallas(rng):
    x, y, f, g = _lanes(rng, 2, 21, 45)
    got = cuda_ot.kexp(T(x), T(y), T(f), T(g))
    want = _per_lane(lambda a, b, c, e: jpo.kexp(a, b, c, e, 1.0, interpret=True), x, y, f, g)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-7)


def test_kmat_vec_plain_matches_pallas(rng):
    """Vector and multi-column right-hand sides, and the transpose call
    convention (roles and potentials swapped)."""
    x, y, f, g = _lanes(rng, 2, 23, 41)
    v = rng.normal(size=(2, 41)).astype(np.float32)
    R = rng.normal(size=(2, 41, 3)).astype(np.float32)
    u = rng.normal(size=(2, 23)).astype(np.float32)
    for args, got in (
        ((x, y, f, g, v), cuda_ot.kmat_vec(T(x), T(y), T(f), T(g), T(v))),
        ((x, y, f, g, R), cuda_ot.kmat_vec(T(x), T(y), T(f), T(g), T(R))),
        ((y, x, g, f, u), cuda_ot.kmat_vec(T(y), T(x), T(g), T(f), T(u))),
    ):
        want = _per_lane(lambda a, b, c, e, r: jpo.kmat_vec(a, b, c, e, r, 1.0, interpret=True),
                         *args)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_plan_grad_plain_matches_pallas(rng):
    x, y, f, g = _lanes(rng, 2, 33, 27)
    got = cuda_ot.plan_grad(T(x), T(y), T(f), T(g))
    want = _per_lane(lambda a, b, c, e: jpo.plan_grad(a, b, c, e, 1.0, interpret=True),
                     x, y, f, g)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def test_plain_row_chunks_change_nothing(rng, monkeypatch):
    """The plain versions work through the rows in chunks (a 100k lane's
    plan does not fit at once); a chunk of a few rows gives the same
    values."""
    x, y, f, g = (T(a) for a in _lanes(rng, 2, 19, 23))
    v = T(rng.normal(size=(2, 23)).astype(np.float32))
    whole = (cuda_ot.ctransform_reduce(x, y, g, soft=True), cuda_ot.kmat_vec(x, y, f, g, v),
             cuda_ot.plan_grad(x, y, f, g))
    monkeypatch.setattr(cuda_ot, "_PLAIN_CHUNK", 2 * 23 * 4)  # 4 rows a chunk
    chunked = (cuda_ot.ctransform_reduce(x, y, g, soft=True), cuda_ot.kmat_vec(x, y, f, g, v),
               cuda_ot.plan_grad(x, y, f, g))
    for a, b in zip(whole, chunked):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


def _warm_g(x, y):
    """A realistic carried dual: the converged g of a nearby problem."""
    _, g = jot.wasserstein_grad_sinkhorn(jnp.asarray(x + 0.01), jnp.asarray(y), eps=0.05,
                                         iters=100, return_g=True)
    return np.asarray(g)


def _solve_both(port_fn, jax_fn, tol, warm):
    rng = np.random.default_rng(7)
    x = rng.normal(size=(24, 3)).astype(np.float32)
    y = (rng.normal(size=(40, 3)) + 0.3).astype(np.float32)
    g0 = _warm_g(x, y) if warm else None
    want, want_g = jax_fn(jnp.asarray(x), jnp.asarray(y), eps=0.05, iters=60, tol=tol,
                          g_init=None if g0 is None else jnp.asarray(g0), return_g=True,
                          interpret=True)
    got, got_g = port_fn(T(x), T(y), eps=0.05, iters=60, tol=tol,
                         g_init=None if g0 is None else T(g0), return_g=True)
    assert got.dtype == torch.float32 and tuple(got.shape) == (24, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got_g.numpy(), np.asarray(want_g), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("tol", [None, 1e-2])
@pytest.mark.parametrize("warm", [False, True])
def test_fused_route_matches_pallas(tol, warm):
    _solve_both(cuda_ot.sinkhorn_grad_fused, jpo.sinkhorn_grad_fused, tol, warm)


@pytest.mark.parametrize("tol", [None, 1e-2])
@pytest.mark.parametrize("warm", [False, True])
def test_streaming_route_matches_pallas(tol, warm):
    _solve_both(cuda_ot.sinkhorn_grad_streaming, jpo.sinkhorn_grad_streaming, tol, warm)


def test_streaming_warm_early_exit_at_converged_dual(rng, monkeypatch):
    """tests/test_pallas_ot.py:282: a carried dual whose start pair already
    meets the exit skips the scaling loop — no kmat_vec pass — and the
    result is the start pair's gradient, JAX's iters=0 warm gradient."""
    x = rng.normal(size=(24, 3)).astype(np.float32)
    y = (rng.normal(size=(40, 3)) + 0.3).astype(np.float32)
    _, g = jot.wasserstein_grad_sinkhorn(jnp.asarray(x), jnp.asarray(y), eps=0.05, iters=400,
                                         tol=1e-5, return_g=True)
    calls = []
    real = cuda_ot.kmat_vec
    monkeypatch.setattr(cuda_ot, "kmat_vec", lambda *a: calls.append(1) or real(*a))
    got = cuda_ot.sinkhorn_grad_streaming(T(x), T(y), eps=0.05, iters=60, tol=1e-2,
                                          g_init=T(g))
    want = jot.wasserstein_grad_sinkhorn(jnp.asarray(x), jnp.asarray(y), eps=0.05, iters=0,
                                         g_init=g)
    assert calls == []
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)


def test_streaming_lanes_match_jax_vmap(rng, monkeypatch):
    """Lanes through the streaming route, one of them starting at its
    converged dual (skips the loop) and the others not: JAX's vmap of the
    per-lane solve (lax.cond and while_loop become per-lane selects)."""
    from dist_svgd_tpu.ops import ot as jot_mod

    monkeypatch.setattr(jot_mod, "FUSED_SINKHORN_STREAM_MIN_PAIRS", 1)
    S = 3
    x = rng.normal(size=(S, 10, 3)).astype(np.float32)
    y = (rng.normal(size=(S, 20, 3)) + 0.2).astype(np.float32)
    g = np.zeros((S, 20), np.float32)
    _, g[0] = jot.wasserstein_grad_sinkhorn(jnp.asarray(x[0]), jnp.asarray(y[0]), eps=0.05,
                                            iters=400, tol=1e-6, return_g=True)
    want, want_g = jax.vmap(lambda c, p, gi: jot.wasserstein_grad_sinkhorn(
        c, p, eps=0.05, iters=40, tol=1e-2, g_init=gi, return_g=True, impl="pallas"))(
        jnp.asarray(x), jnp.asarray(y), jnp.asarray(g))
    got, got_g = cuda_ot.sinkhorn_grad_streaming(T(x), T(y), eps=0.05, iters=40, tol=1e-2,
                                                 g_init=T(g), return_g=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got_g.numpy(), np.asarray(want_g), rtol=1e-4, atol=1e-4)


def test_fused_lanes_match_jax_per_lane(rng):
    """Lanes through the fused route against JAX's fused solve lane by
    lane, with a tol exit: each lane keeps its own reg and its own exit."""
    S = 2
    x = rng.normal(size=(S, 12, 2)).astype(np.float32)
    y = (rng.normal(size=(S, 16, 2)) + 0.2).astype(np.float32)
    x[1] *= 2.5
    got, got_g = cuda_ot.sinkhorn_grad_fused(T(x), T(y), eps=0.05, iters=60, tol=1e-3,
                                             absorb_every=4, return_g=True)
    for s in range(S):
        want, want_g = jpo.sinkhorn_grad_fused(jnp.asarray(x[s]), jnp.asarray(y[s]), eps=0.05,
                                               iters=60, tol=1e-3, absorb_every=4,
                                               return_g=True, interpret=True)
        np.testing.assert_allclose(got[s].numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(got_g[s].numpy(), np.asarray(want_g), rtol=1e-4, atol=1e-4)


def test_kernel_wrappers_refuse_cpu_tensors_and_bad_shapes(rng):
    """The *_cuda wrappers launch or raise — a CPU tensor is refused, never
    served by the plain version — and shapes outside the kernels' domain
    raise; the plain versions launch nothing."""
    x, y, f, g = (T(a) for a in _lanes(rng, 2, 5, 6))
    for call in (lambda: cuda_ot.ctransform_reduce_cuda(x, y, g, soft=True),
                 lambda: cuda_ot.kexp_cuda(x, y, f, g),
                 lambda: cuda_ot.kmat_vec_cuda(x, y, f, g, g),
                 lambda: cuda_ot.plan_grad_cuda(x, y, f, g)):
        with pytest.raises(ValueError, match="CUDA tensors"):
            call()
    wide = torch.zeros((2, 5, 9))
    with pytest.raises(ValueError, match="d <= 8"):
        cuda_ot.kexp(wide, torch.zeros((2, 6, 9)), f, g)
    with pytest.raises(ValueError, match="cols must be"):
        cuda_ot.plan_grad(x, torch.zeros((3, 6, 3)), f, g)
    cuda_ot.reset_launch_counts()
    cuda_ot.sinkhorn_grad_fused(x, y, iters=5)
    assert set(cuda_ot.launch_counts.values()) == {0}
