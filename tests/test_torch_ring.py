"""The port's ring exchange against its gather exchange and against JAX's
ring (``tests/test_ring.py``), on the CPU, float64.

The ring differs from the gather in summation order only, so it is held to
it at ``tests/test_ring.py:49``'s rtol 1e-10, atol 1e-12, in both
``all_*`` modes, with ``median_step``, minibatches and a prior; against
JAX's ring (the ``vmap`` emulation, ``mesh=None``) at the port's usual
1e-10 with JAX's minibatch indices injected.  Also: ``ring_hops_per_step``
against JAX's, the masked median against the unmasked one (exactly), one
φ call a hop, and the C3 fix — ``phi_impl='auto'`` on float64 CPU tensors
equals ``'torch'`` within 1e-10."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import dist_svgd_tpu as jdt
from dist_svgd_tpu.models.logreg import logreg_logp as jlogreg_logp
from dist_svgd_tpu.models.logreg import make_logreg_split as jmake_logreg_split
from dist_svgd_tpu.ops.kernels import median_bandwidth_approx_masked as jmasked
from dist_svgd_tpu.parallel.exchange import ring_hops_per_step as jring_hops
from dist_svgd_tpu.utils.rng import minibatch_key

import dist_svgd_torch as tdt
from dist_svgd_torch.models.logreg import logreg_logp, make_logreg_split
from dist_svgd_torch.ops import cuda_svgd
from dist_svgd_torch.ops.kernels import (
    RBF,
    median_bandwidth_approx,
    median_bandwidth_approx_masked,
)
from dist_svgd_torch.parallel import exchange

from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

#: ring against gather and against JAX, float64 (tests/test_ring.py:49).
RTOL, ATOL = 1e-10, 1e-12

GATHER_MODES = [("all_scores", True), ("all_particles", False)]


def problem(n=16, d=3, rows=24, seed=17):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(rows, d - 1))
    t = np.where(rng.normal(size=rows) > 0, 1.0, -1.0)
    return rng.normal(size=(n, d)), x, t


def port(S, parts, x, t, exch_s, impl, **kw):
    return tdt.DistSampler(S, logreg_logp, kw.pop("kernel", None), parts, data=(x, t),
                           exchange_particles=True, exchange_scores=exch_s,
                           include_wasserstein=False, exchange_impl=impl,
                           phi_impl=kw.pop("phi_impl", "torch"), device="cpu", **kw)


def jax_indices(seed, t, S, n_local, batch):
    """JAX's per-shard draw for step t (parallel/exchange.py:_build_core)."""
    key = jax.random.fold_in(minibatch_key(seed), t)
    return np.stack([np.asarray(jax.random.choice(jax.random.fold_in(key, r), n_local,
                                                  (batch,), replace=False))
                     for r in range(S)])


@pytest.mark.parametrize("S", [2, 4, 8])
@pytest.mark.parametrize("name,exch_s", GATHER_MODES)
def test_ring_matches_gather(name, exch_s, S):
    parts, x, t = problem()
    outs = {}
    for impl in ("gather", "ring"):
        ds = port(S, parts, x, t, exch_s, impl)
        for _ in range(4):
            out = ds.make_step(0.05)
        outs[impl] = out.numpy()
    np.testing.assert_allclose(outs["ring"], outs["gather"], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name,exch_s", GATHER_MODES)
def test_ring_matches_gather_median_step(name, exch_s):
    """median_step under the ring: one bandwidth a step from the gathered
    strided subsample (max_points below n, so the stride is > 1)."""
    parts, x, t = problem(n=32)
    outs = {}
    for impl in ("gather", "ring"):
        ds = port(4, parts, x, t, exch_s, impl, kernel=tdt.AdaptiveRBF(max_points=7))
        outs[impl] = ds.run_steps(3, 0.05).numpy()
    np.testing.assert_allclose(outs["ring"], outs["gather"], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name,exch_s", GATHER_MODES)
def test_ring_matches_gather_minibatch_prior_shard_data(name, exch_s):
    parts, x, t = problem(rows=40)
    lik, prior = make_logreg_split()
    outs = {}
    for impl in ("gather", "ring"):
        ds = tdt.DistSampler(4, lik, None, parts, data=(x, t), exchange_particles=True,
                             exchange_scores=exch_s, include_wasserstein=False,
                             exchange_impl=impl, batch_size=4, log_prior=prior,
                             shard_data=True, phi_impl="torch", device="cpu", seed=3)
        outs[impl] = ds.run_steps(3, 0.05).numpy()
    np.testing.assert_allclose(outs["ring"], outs["gather"], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("batch", [None, 4])
@pytest.mark.parametrize("name,exch_s", GATHER_MODES)
def test_ring_matches_jax_ring(name, exch_s, batch):
    """JAX's ring under the vmap emulation against the port's, with JAX's
    minibatch indices injected."""
    S, seed = 4, 5
    parts, x, t = problem(rows=40)
    lik, prior = make_logreg_split()
    jlik, jprior = jmake_logreg_split()
    js = jdt.DistSampler(S, jlik, None, jnp.asarray(parts),
                         data=(jnp.asarray(x), jnp.asarray(t)), exchange_particles=True,
                         exchange_scores=exch_s, include_wasserstein=False, mesh=None,
                         exchange_impl="ring", batch_size=batch, log_prior=jprior,
                         phi_impl="xla", seed=seed)
    ps = tdt.DistSampler(S, lik, None, parts, data=(x, t), exchange_particles=True,
                         exchange_scores=exch_s, include_wasserstein=False,
                         exchange_impl="ring", batch_size=batch, log_prior=prior,
                         phi_impl="torch", device="cpu", seed=seed)
    if batch:
        ps._batch_index_seam = lambda step: jax_indices(seed, step, S, 10, batch)
    for _ in range(3):
        np.testing.assert_allclose(ps.make_step(0.05).numpy(),
                                   np.asarray(js.make_step(0.05)), rtol=RTOL, atol=ATOL)


def test_ring_single_shard_and_partitions():
    """S = 1: the ring is the plain step; in partitions the flag does
    nothing (already block-local)."""
    parts, x, t = problem()
    outs = {impl: port(1, parts, x, t, True, impl).make_step(0.05).numpy()
            for impl in ("gather", "ring")}
    np.testing.assert_allclose(outs["ring"], outs["gather"], rtol=1e-12)
    outs = {}
    for impl in ("gather", "ring"):
        ds = tdt.DistSampler(4, logreg_logp, None, parts, data=(x, t),
                             exchange_particles=False, exchange_scores=False,
                             include_wasserstein=False, exchange_impl=impl,
                             phi_impl="torch", device="cpu")
        outs[impl] = ds.run_steps(2, 0.05).numpy()
    np.testing.assert_array_equal(outs["ring"], outs["gather"])


@pytest.mark.parametrize("exch_s,hops", [(False, 4), (True, 4)])
def test_one_phi_call_a_hop(monkeypatch, exch_s, hops):
    """Each hop is ONE φ call of all S blocks against the per-lane visiting
    blocks ``(S, s, d)``: S calls a step, whatever the mode."""
    parts, x, t = problem()
    shapes = []
    real = cuda_svgd.phi_cuda

    def spy(y, xx, s, *a, **k):
        shapes.append((tuple(y.shape), tuple(xx.shape)))
        return real(y, xx, s, *a, **k)

    monkeypatch.setattr(cuda_svgd, "phi_cuda", spy)
    ds = port(4, parts.astype(np.float32), x, t, exch_s, "ring", phi_impl="auto")
    ds.run_steps(2, 0.05)
    assert shapes == [((4, 4, 3), (4, 4, 3))] * (2 * hops)


@pytest.mark.parametrize("name", ["all_particles", "all_scores", "partitions"])
@pytest.mark.parametrize("S", [1, 2, 8])
def test_ring_hops_per_step_matches_jax(name, S):
    assert exchange.ring_hops_per_step(name, S) == jring_hops(name, S)
    with pytest.raises(ValueError):
        exchange.ring_hops_per_step("bogus", 4)


@pytest.mark.parametrize("n,max_points", [(32, 7), (40, 1024), (96, 10)])
def test_ring_median_bandwidth_equals_gather_estimate(n, max_points):
    """The ring's gathered strided subsample gives the gather's estimate
    exactly, and the masked median equals JAX's."""
    rng = np.random.default_rng(n)
    parts = torch.from_numpy(rng.normal(size=(n, 3)))
    want = median_bandwidth_approx(parts, max_points)
    got = exchange._ring_median_bandwidth(parts.reshape(8, n // 8, 3), max_points)
    assert float(got) == float(want)


@pytest.mark.parametrize("pad", [0, 3, 11])
def test_masked_median_equals_unmasked_exactly(pad):
    """On the same point set and the same p / n, padded invalid rows change
    nothing; and the port's masked estimate equals JAX's."""
    rng = np.random.default_rng(pad)
    pts = rng.normal(size=(20, 3))
    padded = np.concatenate([pts, np.zeros((pad, 3))])
    perm = rng.permutation(len(padded))  # valid rows anywhere
    valid = np.arange(len(padded))[perm] < 20
    padded = padded[perm]
    got = median_bandwidth_approx_masked(torch.from_numpy(padded), torch.from_numpy(valid),
                                         20, 50)
    plain = median_bandwidth_approx(torch.from_numpy(padded[valid]), 1024) \
        * np.log(21.0) / np.log(51.0)
    assert float(got) == pytest.approx(float(plain), rel=1e-15)
    theirs = jmasked(jnp.asarray(padded), jnp.asarray(valid), 20, 50)
    np.testing.assert_allclose(float(got), float(theirs), rtol=1e-12)


def test_ring_with_wasserstein_and_refusals():
    """The ring composes with the W2 term (make_step either pairing,
    run_steps the block pairing, as in JAX); Gauss–Seidel refuses it."""
    parts, x, t = problem(n=8, d=2, rows=8)
    kw = dict(exchange_particles=True, exchange_scores=True, include_wasserstein=True,
              wasserstein_solver="sinkhorn", exchange_impl="ring", phi_impl="torch",
              device="cpu")
    ds = tdt.DistSampler(2, logreg_logp, None, parts, data=(x, t), **kw)
    for _ in range(3):
        out = ds.make_step(0.05, h=0.5)
    assert torch.isfinite(out).all()
    with pytest.raises(ValueError, match="block"):
        ds.run_steps(1, 0.05)
    blk = tdt.DistSampler(2, logreg_logp, None, parts, data=(x, t), w2_pairing="block", **kw)
    gat = tdt.DistSampler(2, logreg_logp, None, parts, data=(x, t), w2_pairing="block",
                          **{**kw, "exchange_impl": "gather"})
    np.testing.assert_allclose(blk.run_steps(3, 0.05, h=0.5).numpy(),
                               gat.run_steps(3, 0.05, h=0.5).numpy(), rtol=RTOL, atol=ATOL)
    with pytest.raises(ValueError, match="gather"):
        tdt.DistSampler(2, logreg_logp, None, parts, data=(x, t), exchange_impl="ring",
                        update_rule="gauss_seidel", include_wasserstein=False, device="cpu")
    with pytest.raises(ValueError, match="exchange_impl"):
        tdt.DistSampler(2, logreg_logp, None, parts, exchange_impl="bogus", device="cpu")


@pytest.mark.parametrize("shape", [(1, 100, 100, 3), (8, 50, 400, 3), (8, 50, 400, 61),
                                   (2, 20, 30, 753)])
def test_auto_phi_f64_cpu_equals_torch(shape):
    """C3: on CPU tensors wider than float32, 'auto' is the 'torch' φ at
    their dtype (JAX's 'auto' off the TPU is 'xla'), within 1e-10; float32
    CPU tensors still take the kernels' plain versions."""
    S, k, m, d = shape
    g = torch.Generator().manual_seed(sum(shape))
    x = torch.randn(S, m, d, generator=g, dtype=torch.float64)
    y, s = x[:, :k].clone(), torch.randn(S, m, d, generator=g, dtype=torch.float64)
    h = 2.0 * d
    auto = cuda_svgd.resolve_phi_fn(RBF(h), "auto")(y, x, s)
    want = cuda_svgd.resolve_phi_fn(RBF(h), "torch")(y, x, s)
    assert auto.dtype == torch.float64
    torch.testing.assert_close(auto, want, rtol=1e-10, atol=1e-10 * float(want.abs().max()))
    f32 = cuda_svgd.resolve_phi_fn(RBF(h), "auto")(y.float(), x.float(), s.float())
    plain = cuda_svgd.phi_cuda(y, x, s, h, plain=True)
    torch.testing.assert_close(f32, plain.float(), rtol=0, atol=0)
