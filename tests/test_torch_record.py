"""``DistSampler.run_steps(record=True)`` and the rotating ownership
(``owned_block_index`` / ``owned_block``) in the port, against the port's
own ``make_step`` loop (exactly: one code path) and the JAX package
(float64, 1e-10, as tests/test_torch_distsampler.py).

The history is the stack of pre-update snapshots (JAX
``distsampler.py:_run_steps_scan``); it goes to the host in
``utils/history.py:record_chunk_steps`` chunks, looked up at run time
(JAX ``tests/test_record_chunking.py`` patches it the same way).  The
port's sizing counts the card's dense ``n × d × itemsize`` bytes a
snapshot, where JAX counts the TPU's 128-lane padding: the counts differ
for d < 128 by design, and agree from d = 128."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import dist_svgd_tpu as jdt
from dist_svgd_tpu.models.gmm import gmm_logp as jgmm
from dist_svgd_tpu.models.logreg import logreg_logp as jlogreg_logp
from dist_svgd_tpu.utils import history as jhistory

import dist_svgd_torch as tdt
from dist_svgd_torch.models.gmm import gmm_logp
from dist_svgd_torch.models.logreg import logreg_logp
from dist_svgd_torch.utils import history

from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

RTOL, ATOL = 1e-10, 1e-12
MODES = [("all_particles", True, False), ("all_scores", True, True),
         ("partitions", False, False)]
W2 = dict(include_wasserstein=True, wasserstein_solver="sinkhorn", sinkhorn_iters=30)


def _problem(n=12, d=3, rows=18, seed=5):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, d)), rng.normal(size=(rows, d - 1)),
            np.where(rng.normal(size=rows) > 0, 1.0, -1.0))


def _port(S, exch_p, exch_s, w2=False, **kw):
    particles, x, t = _problem()
    w2kw = W2 if w2 else {"include_wasserstein": False}
    return tdt.DistSampler(S, logreg_logp, None, particles, data=(x, t),
                           exchange_particles=exch_p, exchange_scores=exch_s,
                           phi_impl="torch", device="cpu", **w2kw, **kw)


@pytest.mark.parametrize("w2", [False, True], ids=["no_w2", "sinkhorn_w2"])
@pytest.mark.parametrize("name,exch_p,exch_s", MODES)
def test_history_equals_make_step_snapshots(name, exch_p, exch_s, w2):
    """The recorded history is exactly the state before each of the
    make_step loop's steps, and the final state is that loop's."""
    loop = _port(3, exch_p, exch_s, w2)
    want = []
    for _ in range(5):
        want.append(loop.particles.clone())
        loop.make_step(0.05, h=0.5)
    rec = _port(3, exch_p, exch_s, w2)
    final, hist = rec.run_steps(5, 0.05, record=True, h=0.5)
    assert isinstance(hist, torch.Tensor) and hist.shape == (5, 12, 3)
    torch.testing.assert_close(hist, torch.stack(want), rtol=0, atol=0)
    torch.testing.assert_close(final, loop.particles, rtol=0, atol=0)
    assert rec.t == loop.t == 5
    assert rec.last_run_stats["record_chunks_to_host"] == 0


@pytest.mark.parametrize("update_rule", ["jacobi", "gauss_seidel"])
@pytest.mark.parametrize("name,exch_p,exch_s", MODES)
def test_history_matches_jax(name, exch_p, exch_s, update_rule):
    particles, x, t = _problem(n=8, rows=12, seed=7)
    common = dict(exchange_particles=exch_p, exchange_scores=exch_s,
                  include_wasserstein=False, update_rule=update_rule)
    js = jdt.DistSampler(2, jlogreg_logp, None, jnp.asarray(particles),
                         data=(jnp.asarray(x), jnp.asarray(t)), phi_impl="xla", **common)
    ps = tdt.DistSampler(2, logreg_logp, None, particles, data=(x, t), phi_impl="torch",
                         device="cpu", **common)
    jfinal, jhist = js.run_steps(4, 0.05, record=True)
    pfinal, phist = ps.run_steps(4, 0.05, record=True)
    np.testing.assert_allclose(phist.numpy(), np.asarray(jhist), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(pfinal.numpy(), np.asarray(jfinal), rtol=RTOL, atol=ATOL)


def _make_dist(**kw):
    """JAX test_record_chunking's sampler: 32 particles, 4 shards, the GMM
    at d = 2, all_particles."""
    parts = np.random.default_rng(0).normal(size=(32, 2))
    kw.setdefault("include_wasserstein", False)
    return tdt.DistSampler(4, lambda th, _: gmm_logp(th), None, parts,
                           exchange_particles=True, exchange_scores=False,
                           phi_impl="torch", device="cpu", **kw)


@pytest.mark.parametrize("w2", [False, True], ids=["no_w2", "sinkhorn_w2"])
def test_record_chunks_leave_the_history_unchanged(monkeypatch, w2):
    """A chunk of 4 snapshots: the 6-step history goes to the host in two
    chunks (4 + 2) and equals the one-chunk history exactly, with and
    without the W2 term (JAX ``test_distsampler_record_chunks_*``)."""
    kw = dict(W2) if w2 else {}
    want_final, want_hist = _make_dist(**kw).run_steps(6, 0.05, record=True, h=1.0)
    sizes = []

    def chunk(n, d, itemsize=4):
        sizes.append((n, d, itemsize))
        return 4

    monkeypatch.setattr(history, "record_chunk_steps", chunk)
    ds = _make_dist(**kw)
    got_final, got_hist = ds.run_steps(6, 0.05, record=True, h=1.0)
    assert sizes == [(32, 2, 8)]
    assert isinstance(got_hist, np.ndarray) and got_hist.shape == (6, 32, 2)
    assert ds.last_run_stats["record_chunks_to_host"] == 2
    np.testing.assert_array_equal(got_hist, want_hist.numpy())
    torch.testing.assert_close(got_final, want_final, rtol=0, atol=0)
    # a run of whole chunks: 8 = 4 + 4
    _, hist8 = _make_dist(**kw).run_steps(8, 0.05, record=True, h=1.0)
    assert isinstance(hist8, np.ndarray) and hist8.shape == (8, 32, 2)


def test_record_edges():
    ds = _make_dist()
    final, hist = ds.run_steps(0, 0.05, record=True)
    assert hist.shape == (0, 32, 2) and ds.t == 0
    assert isinstance(ds.run_steps(2, 0.05), torch.Tensor)  # record=False: the particles
    assert ds.last_run_stats["num_steps"] == 2


def test_record_chunk_steps_sizing():
    """Dense bytes a snapshot (n·d·itemsize), clamped to [1, 500]; at d ≥ 128
    the TPU's lane padding adds nothing, so JAX's count is the port's."""
    assert history.record_chunk_steps(100, 3) == history.RECORD_CHUNK_MAX
    assert history.record_chunk_steps(100_000, 3) == history.RECORD_CHUNK_MAX  # JAX: 41
    assert history.record_chunk_steps(10_000, 61) == 500
    assert (history.record_chunk_steps(100_000, 256)
            == jhistory.record_chunk_steps(100_000, 256)
            == history.RECORD_HBM_BUDGET_BYTES // (100_000 * 256 * 4))
    assert history.record_chunk_steps(100_000, 256, 8) == 10
    assert history.record_chunk_steps(10 ** 9, 3) == 1
    assert history.RECORD_HBM_BUDGET_BYTES == jhistory.RECORD_HBM_BUDGET_BYTES


@pytest.mark.parametrize("name,exch_p,exch_s", MODES)
def test_owned_block_index_matches_jax(name, exch_p, exch_s):
    """Every (rank, t): ``(rank − t) mod S`` in partitions, ``rank`` in the
    exchanged modes; the default t is the sampler's counter, and
    ``owned_block`` is that block of the current particles."""
    S = 4
    particles = np.random.default_rng(2).normal(size=(8, 1))
    common = dict(exchange_particles=exch_p, exchange_scores=exch_s,
                  include_wasserstein=False)
    js = jdt.DistSampler(S, lambda th, _: jgmm(th), None, jnp.asarray(particles), **common)
    ps = tdt.DistSampler(S, lambda th, _: gmm_logp(th), None, particles, device="cpu",
                         phi_impl="torch", **common)
    for t in range(-1, 2 * S + 2):
        for r in range(S):
            assert ps.owned_block_index(r, t) == js.owned_block_index(r, t)
    for _ in range(3):
        js.make_step(0.1)
        ps.make_step(0.1)
        for r in range(S):
            assert ps.owned_block_index(r) == js.owned_block_index(r)
            np.testing.assert_allclose(ps.owned_block(r).numpy(),
                                       np.asarray(js.owned_block(r)), rtol=RTOL, atol=ATOL)
