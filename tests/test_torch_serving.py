"""The port's serving layer (``dist_svgd_torch/serving/``) against JAX's
(``dist_svgd_tpu/serving/``), case for case with ``tests/test_serving.py``,
on the CPU.

The same numpy ensembles, checkpoints and request sequences go through
both engines: float64 outputs agree within 1e-12 (the tests run JAX with
x64), float32 within 1e-6 relative; the bf16 engine is held against the
port's own f32 at JAX's tolerances (``tests/test_plan.py``).  Padding is
bitwise-invisible on the CPU: a served row equals a direct
``posterior_predictive_prob`` call on the same rows.  The batcher's edge
cases run through its injectable clock; the HTTP server, the hot reloader,
the candidate generation and the mesh options (``mesh=``, ``Plan(mesh)``,
``make_plan(n)`` and ``serving.server --shards 2`` where the devices exist)
are checked too, and ``serving.server --shards 2`` and ``serve_bench
--devices 2`` on a one-device host serve from the single-device plan."""

import json
import math
import os
import threading
import urllib.error
import urllib.request
from concurrent.futures import CancelledError

import numpy as np
import pytest
import torch

from dist_svgd_torch.models import bnn as tbnn
from dist_svgd_torch.models.logreg import posterior_predictive_prob
from dist_svgd_torch.serving import (
    CheckpointHotReloader,
    EnsembleRejected,
    MicroBatcher,
    Overloaded,
    PredictionServer,
    PredictiveEngine,
)
from dist_svgd_torch.serving.engine import bucket_for
from dist_svgd_torch.telemetry.diagnostics import ReloadPolicy
from dist_svgd_torch.utils.checkpoint import CheckpointManager, save_state

from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

#: float32 outputs of the two engines agree within this, relative.
F32_RTOL = 1e-6
#: float64 outputs agree within this.
F64_TOL = 1e-12
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def rng():
    return np.random.default_rng(7)


def _engine(model, parts, **kw):
    kw.setdefault("min_bucket", 4)
    kw.setdefault("max_bucket", 64)
    return PredictiveEngine(model, parts, device="cpu", **kw)


def _jax_engine(model, parts, **kw):
    from dist_svgd_tpu.serving import PredictiveEngine as JEngine

    kw.setdefault("min_bucket", 4)
    kw.setdefault("max_bucket", 64)
    return JEngine(model, parts, **kw)


def _logreg_engine(rng, n=32, k=4, **kw):
    parts = rng.normal(size=(n, 1 + k)).astype(np.float32)
    return _engine("logreg", parts, **kw), parts


def _assert_close(ours, theirs, dtype):
    ours, theirs = np.asarray(ours), np.asarray(theirs)
    if dtype == np.float64:
        np.testing.assert_allclose(ours, theirs, rtol=0, atol=F64_TOL)
    else:
        np.testing.assert_allclose(ours, theirs, rtol=F32_RTOL,
                                   atol=F32_RTOL * float(np.max(np.abs(theirs))))


# --------------------------------------------------------------------- #
# injectable time: tests drive max_wait_ms expiry without real sleeps


class ManualClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def make_fake_wait(clock):
    """Timed condition waits advance the fake clock instead of sleeping;
    untimed waits stay real (they wake on submit's notify)."""

    def wait(cond, timeout):
        if timeout is None:
            return threading.Condition.wait(cond)
        clock.t += timeout
        return False

    return wait


def make_batcher(dispatch, **kw):
    clock = ManualClock()
    kw.setdefault("clock", clock)
    kw.setdefault("wait", make_fake_wait(clock))
    kw.setdefault("autostart", False)
    return MicroBatcher(dispatch, **kw), clock


# --------------------------------------------------------------------- #
# engine: buckets, programs, the three models against JAX's


def test_bucket_for():
    from dist_svgd_tpu.serving.engine import bucket_for as jbucket_for

    for mb in (1, 4, 8):
        assert [bucket_for(b, mb) for b in range(1, 70)] == [
            jbucket_for(b, mb) for b in range(1, 70)]
    assert [bucket_for(b, 4) for b in (1, 3, 4, 5, 8, 9, 17)] == [4, 4, 4, 8, 8, 16, 32]
    with pytest.raises(ValueError):
        bucket_for(0, 4)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_engine_pads_exactly(rng, dtype):
    """Padding to the bucket and slicing back is bitwise-invisible: every
    request size gives the rows of one direct full-batch call; and the
    served rows are JAX's within the dtype's tolerance."""
    parts = rng.normal(size=(32, 5)).astype(dtype)
    eng, jeng = _engine("logreg", parts), _jax_engine("logreg", parts)
    x = rng.normal(size=(11, 4)).astype(dtype)
    ref = posterior_predictive_prob(torch.from_numpy(parts), torch.from_numpy(x)).mean(0)
    for a, b in ((0, 1), (1, 4), (4, 11)):
        out, jout = eng.predict(x[a:b]), jeng.predict(x[a:b])
        assert out["mean"].shape == (b - a,) and out["mean"].dtype == dtype
        np.testing.assert_array_equal(out["mean"], ref.numpy()[a:b])
        for key in ("mean", "var"):
            _assert_close(out[key], jout[key], dtype)


def test_engine_bucket_cache_hits_and_misses(rng):
    eng, parts = _logreg_engine(rng)
    jeng = _jax_engine("logreg", parts)
    for e in (eng, jeng):
        for b in (1, 2, 3, 4):  # all land in bucket 4: 1 miss, 3 hits
            e.predict(np.zeros((b, 4), np.float32))
    st = eng.stats()
    assert st["compiled_buckets"] == [4]
    assert (st["bucket_misses"], st["bucket_hits"]) == (1, 3)
    eng.predict(np.zeros((5, 4), np.float32))  # bucket 8: second miss
    assert eng.stats()["compiled_buckets"] == [4, 8]
    for b in range(1, 65):
        eng.predict(np.zeros((b, 4), np.float32))
        jeng.predict(np.zeros((b, 4), np.float32))
    assert len(eng.stats()["compiled_buckets"]) <= math.ceil(math.log2(64)) + 1
    ours, theirs = eng.stats(), jeng.stats()
    assert set(ours) == set(theirs)
    for key in ("compiled_buckets", "bucket_cache_size", "n_particles", "feature_dim",
                "dtype", "plan", "generation_id", "reloads", "model"):
        assert ours[key] == theirs[key], key
    # the port ran one more request (5 rows: bucket 8's miss came earlier)
    assert ours["bucket_misses"] == theirs["bucket_misses"]
    assert ours["bucket_hits"] == theirs["bucket_hits"] + 1


def test_engine_rejects_oversize_and_bad_shapes(rng):
    eng, _ = _logreg_engine(rng, max_bucket=16)
    with pytest.raises(ValueError, match="max_bucket"):
        eng.predict(np.zeros((17, 4), np.float32))
    with pytest.raises(ValueError, match="expected"):
        eng.predict(np.zeros((3, 5), np.float32))
    with pytest.raises(ValueError, match="unknown model"):
        PredictiveEngine("mystery", np.zeros((4, 3)), device="cpu")
    with pytest.raises(ValueError, match="generation"):
        eng.predict(np.zeros((1, 4), np.float32), generation="nope")


def test_engine_warmup_precompiles(rng):
    eng, _ = _logreg_engine(rng, min_bucket=4, max_bucket=32)
    assert eng.warmup() == [4, 8, 16, 32]
    misses = eng.stats()["bucket_misses"]
    eng.predict(np.zeros((13, 4), np.float32))
    assert eng.stats()["bucket_misses"] == misses  # steady state: no builds
    assert eng.warmup([1, 3, 13]) == [4, 16]


def test_engine_non_pow2_max_bucket_normalised(rng):
    eng, _ = _logreg_engine(rng, min_bucket=4, max_bucket=100)
    assert eng.max_bucket == 128
    assert eng.warmup()[-1] == 128
    misses = eng.stats()["bucket_misses"]
    eng.predict(np.zeros((100, 4), np.float32))
    assert eng.stats()["bucket_misses"] == misses
    with pytest.raises(ValueError, match="max_bucket"):
        eng.predict(np.zeros((129, 4), np.float32))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_engine_bnn_kernel_matches_jax(rng, dtype):
    nf, nh, n = 3, 4, 10
    parts = rng.normal(size=(n, tbnn.num_params(nf, nh))).astype(dtype)
    x = rng.normal(size=(5, nf)).astype(dtype)
    kw = dict(n_features=nf, n_hidden=nh, y_mean=2.0, y_std=3.0)
    out = _engine("bnn", parts, **kw).predict(x)
    jout = _jax_engine("bnn", parts, **kw).predict(x)
    for key in ("mean", "std"):
        _assert_close(out[key], jout[key], dtype)
    # and the numpy formula of JAX's test (an unbiased var would fail this)
    preds = np.stack([tbnn.predict(torch.from_numpy(p), torch.from_numpy(x), nf, nh).numpy()
                      for p in parts])
    var = preds.var(0) * 9.0 + np.mean(np.exp(-parts[:, -2])) * 9.0
    np.testing.assert_allclose(out["std"], np.sqrt(var), rtol=1e-5)


def test_engine_bnn_requires_layout():
    with pytest.raises(ValueError, match="requires n_features"):
        PredictiveEngine("bnn", np.zeros((4, 10), np.float32), device="cpu")
    with pytest.raises(ValueError, match="num_params"):
        PredictiveEngine("bnn", np.zeros((4, 10), np.float32), n_features=3, device="cpu")


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_engine_gmm_kde_matches_jax(rng, dtype):
    n, d, h = 20, 2, 0.7
    parts = rng.normal(size=(n, d)).astype(dtype)
    x = rng.normal(size=(6, d)).astype(dtype)
    out = _engine("gmm", parts, kde_bandwidth=h).predict(x)
    jout = _jax_engine("gmm", parts, kde_bandwidth=h).predict(x)
    _assert_close(out["log_density"], jout["log_density"], dtype)
    with pytest.raises(ValueError, match="kde_bandwidth"):
        PredictiveEngine("gmm", parts, kde_bandwidth=0.0, device="cpu")


@pytest.mark.parametrize("model", ["logreg", "bnn", "gmm"])
def test_bf16_engine_numerics_pinned_vs_f32(rng, model):
    """The low-precision path keeps an f32 wire format and lands within
    JAX's documented bf16 tolerances of the port's own f32 engine
    (``tests/test_plan.py``: rtol 5e-2, atol 2e-2 on means; rtol 2e-1 on
    the second moment); every model, and the output dtype upcast."""
    if model == "logreg":
        parts, kw, x = rng.normal(size=(128, 5)), {}, rng.normal(size=(7, 4))
    elif model == "bnn":
        parts = rng.normal(size=(64, tbnn.num_params(3, 4))) * 0.3
        kw, x = dict(n_features=3, n_hidden=4), rng.normal(size=(7, 3))
    else:
        parts, kw, x = rng.normal(size=(128, 3)), {}, rng.normal(size=(7, 3))
    parts, x = parts.astype(np.float32), x.astype(np.float32)
    f32 = _engine(model, parts, max_bucket=8, **kw)
    bf16 = _engine(model, parts, max_bucket=8, dtype=torch.bfloat16, **kw)
    assert bf16.stats()["dtype"] == "bfloat16" and bf16.particles.dtype == torch.bfloat16
    a, b = f32.predict(x), bf16.predict(x)
    first, second = {"logreg": ("mean", "var"), "bnn": ("mean", "std"),
                     "gmm": ("log_density", None)}[model]
    assert b[first].dtype == np.float32 and b[first].shape == (7,)
    np.testing.assert_allclose(b[first], a[first], rtol=5e-2, atol=2e-2)
    if second:
        np.testing.assert_allclose(b[second], a[second], rtol=2e-1, atol=2e-2)
    # the named and numpy spellings resolve to the same dtype; ints refuse
    assert _engine(model, parts, dtype="bfloat16", **kw).stats()["dtype"] == "bfloat16"
    with pytest.raises(ValueError, match="float dtype"):
        _engine(model, parts, dtype=torch.int32, **kw)


#: bf16 has an 8-bit significand: one unit in the last place is at most
#: 2**-7 of a value.  The two bf16 engines round their intermediates in
#: different orders, so they may land one such unit apart.
BF16_ULP = 2.0 ** -7


@pytest.mark.parametrize("model", ["logreg", "bnn", "gmm"])
def test_bf16_engine_matches_jax_bf16(rng, model):
    """The port's bf16 programs against JAX's ``PredictiveEngine(dtype=
    bfloat16)`` on the same ensemble and rows: f32 in, bf16 compute with the
    reductions accumulated in f32, f32 out.  Each output lies within one bf16
    unit in the last place of JAX's, relative to the value and to the
    output's largest magnitude; 1,024 particles make the reductions long."""
    import jax.numpy as jnp

    if model == "logreg":
        parts, kw, x = rng.normal(size=(1024, 5)), {}, rng.normal(size=(7, 4))
    elif model == "bnn":
        parts = rng.normal(size=(1024, tbnn.num_params(3, 4))) * 0.3
        kw, x = dict(n_features=3, n_hidden=4), rng.normal(size=(7, 3))
    else:
        parts, kw, x = rng.normal(size=(1024, 3)), {}, rng.normal(size=(7, 3))
    parts, x = parts.astype(np.float32), x.astype(np.float32)
    ours = _engine(model, parts, max_bucket=8, dtype=torch.bfloat16, **kw)
    theirs = _jax_engine(model, parts, max_bucket=8, dtype=jnp.bfloat16, **kw)
    assert ours.stats()["dtype"] == theirs.stats()["dtype"] == "bfloat16"
    got, want = ours.predict(x), theirs.predict(x)
    assert sorted(got) == sorted(want)
    for k in want:
        w = np.asarray(want[k])
        assert got[k].dtype == w.dtype == np.float32 and got[k].shape == w.shape
        np.testing.assert_allclose(got[k], w, rtol=BF16_ULP,
                                   atol=BF16_ULP * float(np.max(np.abs(w))), err_msg=k)


# --------------------------------------------------------------------- #
# engine: checkpoint cold start (all three layouts)


def test_from_checkpoint_single_save(tmp_path, rng):
    parts = rng.normal(size=(8, 3)).astype(np.float32)
    save_state(str(tmp_path / "c"), {"particles": parts, "t": 3})
    eng = PredictiveEngine.from_checkpoint(str(tmp_path / "c"), "logreg", device="cpu")
    np.testing.assert_array_equal(eng.particles.numpy(), parts)
    assert eng.checkpoint_step is None


def test_from_checkpoint_manager_root_skips_corrupt_newest(tmp_path, rng):
    parts = rng.normal(size=(8, 3)).astype(np.float32)
    mgr = CheckpointManager(str(tmp_path / "root"), every=1)
    mgr.save(1, {"particles": parts, "t": 1})
    os.makedirs(os.path.join(mgr.root, "step_2"))  # partial write
    with pytest.warns(UserWarning, match="skipping unloadable"):
        eng = PredictiveEngine.from_checkpoint(str(tmp_path / "root"), "logreg",
                                               device="cpu")
    np.testing.assert_array_equal(eng.particles.numpy(), parts)
    assert eng.checkpoint_step == 1


def test_from_checkpoint_multiprocess_blocks(tmp_path, rng):
    rows = rng.normal(size=(8, 3)).astype(np.float32)
    a, b = str(tmp_path / "p0"), str(tmp_path / "p1")
    save_state(a, {"particles": rows[:4], "particles_start": np.int64(0), "t": np.int64(2)})
    save_state(b, {"particles": rows[4:], "particles_start": np.int64(4), "t": np.int64(2)})
    eng = PredictiveEngine.from_checkpoint([b, a], "logreg", device="cpu")
    np.testing.assert_array_equal(eng.particles.numpy(), rows)


def test_from_checkpoint_errors(tmp_path):
    with pytest.raises(FileNotFoundError):
        PredictiveEngine.from_checkpoint(str(tmp_path / "nope"), "logreg", device="cpu")
    save_state(str(tmp_path / "c"), {"other": np.ones((2, 2))})
    with pytest.raises(KeyError, match="particles"):
        PredictiveEngine.from_checkpoint(str(tmp_path / "c"), "logreg", device="cpu")
    CheckpointManager(str(tmp_path / "empty_root"), every=1)
    with pytest.raises(ValueError, match="empty"):
        PredictiveEngine.from_checkpoint(str(tmp_path / "empty_root"), "logreg",
                                         device="cpu")


def test_from_checkpoint_jax_save_serves_like_jax(tmp_path, rng):
    """A JAX manager root (JAX's npz save) cold-starts the port's engine,
    which then serves what JAX's engine serves from the same root."""
    from dist_svgd_tpu.utils.checkpoint import CheckpointManager as JManager

    parts = rng.normal(size=(24, 5))
    JManager(str(tmp_path / "root"), every=1, backend="npz").save(
        3, {"particles": parts, "t": 3})
    eng = PredictiveEngine.from_checkpoint(str(tmp_path / "root"), "logreg",
                                           min_bucket=4, max_bucket=16, device="cpu")
    jeng = _jax_engine("logreg", parts, max_bucket=16)
    x = rng.normal(size=(6, 4))
    assert eng.checkpoint_step == 3
    _assert_close(eng.predict(x)["mean"], jeng.predict(x)["mean"], np.float64)


# --------------------------------------------------------------------- #
# batcher edge cases, through the injectable clock


def _echo_dispatch(calls):
    def dispatch(x):
        calls.append(x.shape[0])
        return {"val": x[:, 0].copy()}

    return dispatch


def test_partial_flush_on_max_wait_expiry():
    calls = []
    bat, clock = make_batcher(_echo_dispatch(calls), max_batch=64, max_wait_ms=5.0)
    fut = bat.submit(np.arange(3, dtype=np.float32)[:, None])
    bat.start()
    np.testing.assert_array_equal(fut.result(timeout=10)["val"], [0, 1, 2])
    assert calls == [3] and clock.t >= 5e-3
    bat.close()


def test_oversize_request_splits_not_deadlocks():
    calls = []
    bat, _ = make_batcher(_echo_dispatch(calls), max_batch=8, max_wait_ms=1.0)
    fut = bat.submit(np.arange(20, dtype=np.float32)[:, None])
    bat.start()
    np.testing.assert_array_equal(fut.result(timeout=10)["val"], np.arange(20))
    assert calls == [8, 8, 4]
    bat.close()


def test_bucket_boundary_batches(rng):
    eng, _ = _logreg_engine(rng, min_bucket=4, max_bucket=32)
    bat, _ = make_batcher(eng.predict, max_batch=16, max_wait_ms=1.0)
    futs = [bat.submit(np.zeros((8, 4), np.float32)) for _ in range(2)]
    bat.start()
    for f in futs:
        f.result(timeout=10)
    st = bat.stats()
    assert (st["batches"], st["batch_occupancy_max"]) == (1, 16)
    assert eng.stats()["compiled_buckets"] == [16]
    bat.submit(np.zeros((17, 4), np.float32)).result(timeout=10)
    st = bat.stats()
    assert st["batches"] == 3 and st["batch_occupancy_max"] == 16
    assert eng.stats()["compiled_buckets"] == [4, 16]
    bat.close()


def test_shed_on_overflow_is_clean():
    bat, _ = make_batcher(_echo_dispatch([]), max_batch=4, max_wait_ms=1.0,
                          max_queue_rows=8)
    f1 = bat.submit(np.ones((4, 1), np.float32))
    f2 = bat.submit(np.ones((4, 1), np.float32))
    with pytest.raises(Overloaded, match="queue full"):
        bat.submit(np.ones((1, 1), np.float32))
    assert bat.stats()["shed"] == 1
    bat.start()
    for f in (f1, f2):
        assert f.result(timeout=10)["val"].shape == (4,)
    bat.close()


def test_close_drains_queued_requests():
    bat, _ = make_batcher(_echo_dispatch([]), max_batch=4, max_wait_ms=1.0)
    futs = [bat.submit(np.full((2, 1), i, np.float32)) for i in range(3)]
    bat.start()
    bat.close(drain=True)
    for i, f in enumerate(futs):
        np.testing.assert_array_equal(f.result(timeout=1)["val"], [i, i])
    with pytest.raises(RuntimeError, match="closed"):
        bat.submit(np.ones((1, 1), np.float32))


def test_close_without_drain_cancels():
    bat, _ = make_batcher(_echo_dispatch([]), max_batch=4, max_wait_ms=1.0)
    fut = bat.submit(np.ones((2, 1), np.float32))
    bat.close(drain=False)
    with pytest.raises(CancelledError):
        fut.result(timeout=1)


def test_dispatch_error_propagates_to_futures():
    def boom(x):
        raise RuntimeError("device on fire")

    bat, _ = make_batcher(boom, max_batch=4, max_wait_ms=1.0)
    fut = bat.submit(np.ones((2, 1), np.float32))
    bat.start()
    with pytest.raises(RuntimeError, match="device on fire"):
        fut.result(timeout=10)
    assert bat.stats()["dispatch_errors"] == 1
    bat.close()


def test_batcher_validates_args():
    with pytest.raises(ValueError, match="max_batch"):
        MicroBatcher(lambda x: {}, max_batch=0, autostart=False)
    with pytest.raises(ValueError, match="max_queue_rows"):
        MicroBatcher(lambda x: {}, max_batch=8, max_queue_rows=4, autostart=False)
    bat = MicroBatcher(lambda x: {}, autostart=False)
    with pytest.raises(ValueError, match="non-empty"):
        bat.submit(np.zeros((0, 3), np.float32))
    bat.close()


def test_batcher_stats_keys_and_coalescing_equal_jax(rng):
    """One pre-filled queue through both batchers: the same stats keys, the
    same batches, occupancy and per-request results."""
    from dist_svgd_tpu.serving import MicroBatcher as JBatcher

    calls = {"ours": [], "jax": []}
    bat, _ = make_batcher(_echo_dispatch(calls["ours"]), max_batch=8, max_wait_ms=1.0)
    jclock = ManualClock()
    jbat = JBatcher(_echo_dispatch(calls["jax"]), max_batch=8, max_wait_ms=1.0,
                    clock=jclock, wait=make_fake_wait(jclock), autostart=False)
    sizes = [1, 3, 4, 7, 2, 16, 1]
    xs = [rng.normal(size=(s, 2)).astype(np.float32) for s in sizes]
    outs = {}
    for name, b in (("ours", bat), ("jax", jbat)):
        futs = [b.submit(x) for x in xs]
        b.start()
        outs[name] = [f.result(timeout=10)["val"] for f in futs]
        b.close()
    assert calls["ours"] == calls["jax"]
    for a, b in zip(outs["ours"], outs["jax"]):
        np.testing.assert_array_equal(a, b)
    ours, theirs = bat.stats(), jbat.stats()
    assert set(ours) == set(theirs)
    for key in ("requests", "rows", "batches", "batch_occupancy_mean",
                "batch_occupancy_max", "requests_per_batch_mean", "lane_batches"):
        assert ours[key] == theirs[key], key


def test_batcher_dispatches_a_one_chunk_batch_without_a_copy(rng):
    """A batch of one chunk hands the dispatch that chunk itself (a view of
    the request); a coalesced batch hands it the chunks' concatenation."""
    seen = []

    def dispatch(x):
        seen.append(x)
        return {"val": x.sum(axis=1)}

    bat, _ = make_batcher(dispatch, max_batch=8, max_wait_ms=1.0)
    whole = rng.normal(size=(8, 2)).astype(np.float32)
    parts = [rng.normal(size=(3, 2)).astype(np.float32) for _ in range(2)]
    futs = [bat.submit(whole)] + [bat.submit(p) for p in parts]
    bat.start()
    outs = [f.result(timeout=10)["val"] for f in futs]
    bat.close()
    assert len(seen) == 2
    assert np.shares_memory(seen[0], whole)
    np.testing.assert_array_equal(seen[1], np.concatenate(parts))
    assert not any(np.shares_memory(seen[1], p) for p in parts)
    for out, x in zip(outs, [whole] + parts):
        np.testing.assert_array_equal(out, x.sum(axis=1))


# --------------------------------------------------------------------- #
# the end-to-end acceptance test: train -> checkpoint -> serve


def test_end_to_end_bitwise(tmp_path, rng):
    """A small logreg ensemble (JAX's Sampler) checkpointed, served
    through the batcher under concurrent mixed-size requests: (a) the
    served means equal a direct ``posterior_predictive_prob`` call on the
    same ensemble bitwise, and JAX's engine within the ensemble dtype's
    tolerance; (b) at most
    ceil(log2(max_batch)) + 1 bucket programs; (c) batch occupancy > 1."""
    from dist_svgd_tpu import Sampler
    from dist_svgd_tpu.models.logreg import make_logreg_logp

    k = 6
    x_train = rng.normal(size=(40, k))
    t_train = np.where(rng.normal(size=40) > 0, 1.0, -1.0)
    sampler = Sampler(1 + k, make_logreg_logp(x_train, t_train))
    final, _ = sampler.run(48, 15, 1e-2, seed=3, record=False)
    final = np.asarray(final)

    mgr = CheckpointManager(str(tmp_path / "ckpt"), every=5)
    mgr.save(15, {"particles": final, "t": 15})
    max_batch = 32
    engine = PredictiveEngine.from_checkpoint(
        str(tmp_path / "ckpt"), "logreg", min_bucket=4, max_bucket=max_batch,
        device="cpu")
    bat, _ = make_batcher(engine.predict, max_batch=max_batch, max_wait_ms=2.0)
    x_test = rng.normal(size=(37, k)).astype(final.dtype)
    sizes = [1, 3, 4, 7, 2, 16, 1, 3]
    offsets = np.cumsum([0] + sizes)
    futs = [bat.submit(x_test[offsets[i]:offsets[i + 1]]) for i in range(len(sizes))]
    bat.start()
    served = np.concatenate([f.result(timeout=30)["mean"] for f in futs])
    bat.close()

    direct = posterior_predictive_prob(engine.particles, torch.from_numpy(x_test)).mean(0)
    np.testing.assert_array_equal(served, direct.numpy())
    jeng = _jax_engine("logreg", final, max_bucket=64)
    _assert_close(served, jeng.predict(x_test)["mean"], final.dtype)

    st = engine.stats()
    assert st["bucket_misses"] == len(st["compiled_buckets"])
    assert st["bucket_misses"] <= math.ceil(math.log2(max_batch)) + 1
    bst = bat.stats()
    assert bst["requests"] == len(sizes)
    assert bst["batch_occupancy_mean"] > 1 and bst["requests_per_batch_mean"] > 1


# --------------------------------------------------------------------- #
# HTTP front end


def _get(url, path):
    return json.loads(urllib.request.urlopen(url + path, timeout=10).read())


def _post(url, path, doc):
    req = urllib.request.Request(url + path, json.dumps(doc).encode(),
                                 {"Content-Type": "application/json"})
    return json.loads(urllib.request.urlopen(req, timeout=10).read())


def test_server_routes_and_drain(rng):
    eng, parts = _logreg_engine(rng)
    jeng = _jax_engine("logreg", parts)
    with PredictionServer(eng, port=0, max_batch=16, max_wait_ms=2.0) as srv:
        health = _get(srv.url, "/healthz")
        assert health["status"] == "ok"
        assert health["n_particles"] == 32 and health["feature_dim"] == 4
        assert health["devices"] == 1 and health["generation_id"] == 1
        x = rng.normal(size=(3, 4)).astype(np.float32)
        out = _post(srv.url, "/predict", {"inputs": x.tolist()})["outputs"]
        _assert_close(out["mean"], jeng.predict(x)["mean"], np.float32)
        assert len(out["var"]) == 3
        one = _post(srv.url, "/predict", {"inputs": x[0].tolist()})["outputs"]
        assert len(one["mean"]) == 1
        metrics = _get(srv.url, "/metrics.json")
        assert metrics["http_requests"] == 2
        assert metrics["batcher"]["requests"] == 2
        assert metrics["engine"]["model"] == "logreg"
        prom = urllib.request.urlopen(srv.url + "/metrics", timeout=10)
        assert prom.headers["Content-Type"].startswith("text/plain")
        text = prom.read().decode()
        assert "# TYPE svgd_serve_requests_total counter" in text
        assert "svgd_serve_request_latency_seconds_bucket" in text
        assert "metrics" in _get(srv.url, "/metrics.dump")
        assert _get(srv.url, "/slo")["status"] in ("ok", "breach")
        assert _get(srv.url, "/usage")["metering"] in (True, False)
        for path in ("/autoscale", "/tenants", "/healthz/x"):
            with pytest.raises(urllib.error.HTTPError) as ei:
                urllib.request.urlopen(srv.url + path, timeout=10)
            assert ei.value.code == 404, path
    with pytest.raises(RuntimeError, match="closed"):
        srv.batcher.submit(x)


def test_server_error_codes(rng):
    eng, _ = _logreg_engine(rng)
    with PredictionServer(eng, port=0, max_wait_ms=1.0) as srv:
        for body, want in ((b"not json", 400), (b'{"no_inputs": 1}', 400),
                           (b'{"inputs": [[1, 2]]}', 400),
                           (b'{"inputs": [[1, 2, 3, 4]], "tenant": "a"}', 400)):
            req = urllib.request.Request(srv.url + "/predict", body,
                                         {"Content-Type": "application/json"})
            with pytest.raises(urllib.error.HTTPError) as ei:
                urllib.request.urlopen(req, timeout=10)
            assert ei.value.code == want, body
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(srv.url + "/nope", timeout=10)
        assert ei.value.code == 404
        assert _get(srv.url, "/metrics.json")["http_errors"] == 4


def test_server_concurrent_load_coalesces(rng):
    eng, _ = _logreg_engine(rng)
    with PredictionServer(eng, port=0, max_batch=64, max_wait_ms=80.0) as srv:
        barrier = threading.Barrier(8)
        errs = []

        def fire():
            try:
                barrier.wait(timeout=10)
                _post(srv.url, "/predict", {"inputs": np.zeros((2, 4)).tolist()})
            except Exception as e:  # pragma: no cover - diagnostic
                errs.append(e)

        threads = [threading.Thread(target=fire) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert not errs
        m = _get(srv.url, "/metrics.json")
        assert m["batcher"]["requests"] == 8
        assert m["batcher"]["batch_occupancy_mean"] > 1
        assert m["batcher"]["requests_per_batch_mean"] > 1


def test_server_sheds_with_429_retry_after(rng):
    eng, _ = _logreg_engine(rng)
    bat, _ = make_batcher(eng.predict, max_batch=4, max_queue_rows=4, max_wait_ms=1.0)
    srv = PredictionServer(eng, port=0, batcher=bat).start()
    try:
        t = threading.Thread(target=lambda: _post(
            srv.url, "/predict", {"inputs": np.zeros((4, 4)).tolist()}))
        t.start()
        poll = threading.Event()
        for _ in range(1000):
            if bat.stats()["queued_rows"] >= 4:
                break
            poll.wait(0.005)
        assert bat.stats()["queued_rows"] >= 4
        with pytest.raises(urllib.error.HTTPError) as ei:
            req = urllib.request.Request(
                srv.url + "/predict",
                json.dumps({"inputs": np.zeros((4, 4)).tolist()}).encode(),
                {"Content-Type": "application/json"})
            urllib.request.urlopen(req, timeout=10)
        assert ei.value.code == 429
        assert int(ei.value.headers["Retry-After"]) >= 1
        assert json.loads(ei.value.read())["retry_after_s"] > 0
        bat.start()
        t.join(timeout=10)
    finally:
        bat.start()
        srv.shutdown()


def test_overloaded_retry_after_scales_with_queue_depth(rng):
    eng, _ = _logreg_engine(rng)
    bat, _ = make_batcher(eng.predict, max_batch=4, max_queue_rows=8, max_wait_ms=10.0)
    bat.submit(np.zeros((8, 4), np.float32))
    with pytest.raises(Overloaded) as ei:
        bat.submit(np.zeros((1, 4), np.float32))
    assert ei.value.retry_after_s == pytest.approx(0.030)
    bat.start()
    bat.close(drain=True)


def test_shutdown_flips_healthz_before_socket_close(rng):
    eng, _ = _logreg_engine(rng)
    srv = PredictionServer(eng, port=0, max_wait_ms=1.0).start()
    seen = {}
    orig_shutdown = srv._httpd.shutdown

    def spy():
        try:
            urllib.request.urlopen(srv.url + "/healthz", timeout=10)
            seen["code"] = 200
        except urllib.error.HTTPError as e:
            seen["code"] = e.code
            seen["body"] = json.loads(e.read())
        orig_shutdown()

    srv._httpd.shutdown = spy
    srv.shutdown()
    assert seen["code"] == 503 and seen["body"]["status"] == "draining"


def test_format_retry_after_equals_jax():
    from dist_svgd_tpu.serving.fleet import format_retry_after as jfmt

    from dist_svgd_torch.serving.server import format_retry_after

    for s in (0.0, 0.001, 0.5, 1.0, 1.0001, 2.5, 30.0):
        assert format_retry_after(s) == jfmt(s)


# --------------------------------------------------------------------- #
# serve_bench rows carry JAX's keys


@pytest.fixture(scope="module")
def jax_serve_bench():
    import importlib.util
    import sys

    sys.path.insert(0, os.path.join(ROOT, "tools"))
    spec = importlib.util.spec_from_file_location(
        "jax_serve_bench", os.path.join(ROOT, "tools", "serve_bench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


BENCH_KW = dict(model="logreg", n_particles=64, n_features=4, clients=4, requests=40,
                rows=(1, 4), max_batch=16, max_wait_ms=1.0, open_rate=2000.0,
                open_requests=20)


def test_serve_bench_row_schema(jax_serve_bench):
    from dist_svgd_torch.tools import serve_bench

    row = serve_bench.run_bench(device="cpu", **BENCH_KW)
    want = jax_serve_bench.run_bench(**BENCH_KW)
    assert set(row) == set(want)
    for key in ("telemetry", "lane_fairness", "open_loop", "latency_hist_ms", "slo"):
        assert set(row[key]) == set(want[key]), key
    assert row["metric"] == "serve_throughput" and row["platform"] == "cpu"
    assert row["value"] > 0
    assert row["recompiles"] == 0 and row["sentry_compiles"] == 0
    assert row["latency_hist_ms"]["count"] == 60
    assert row["serve_latency_p99"] == row["latency_hist_ms"]["p99"] > 0
    assert row["open_loop"]["completed"] == 20
    assert row["ksd"] is None and row["ess"] > 1 and 0 < row["ess_frac"] <= 1
    assert row["slo_status"] == "ok" and 0 <= row["diagnostics_overhead"] < 1
    for key in ("n_particles", "feature_dim", "devices", "lanes", "dtype", "clients",
                "requests", "rows_per_request", "max_batch", "max_wait_ms", "transport"):
        assert row[key] == want[key], key
    json.dumps(row)


def test_serve_bench_bf16_row_and_sentry(jax_serve_bench):
    """``--dtype bfloat16`` stamps JAX's ``f32_rps`` / ``dtype_speedup``; the
    capture sentry counts a request shape that escapes the buckets."""
    from dist_svgd_torch.parallel.plan import capture_sentry
    from dist_svgd_torch.tools import serve_bench

    kw = dict(BENCH_KW, open_rate=0.0, lanes=2)
    row = serve_bench.run_bench(device="cpu", dtype="bfloat16", **kw)
    want = jax_serve_bench.run_bench(dtype="bfloat16", **kw)
    assert set(row) == set(want) and row["dtype"] == "bfloat16" == want["dtype"]
    assert row["dtype_speedup"] > 0 and row["recompiles"] == row["sentry_compiles"] == 0
    assert set(row["lane_fairness"]["requests"]) == {"l0", "l1"}
    eng = serve_bench.build_engine(n_particles=16, n_features=3, max_bucket=8,
                                   device="cpu")
    eng.warmup()
    with capture_sentry() as sentry:
        eng.predict(np.zeros((3, 3), np.float32))
        eng._kernels[8](torch.zeros((3, 3)))  # a device-side shape: a capture
    assert sentry.compiles == 1 and sentry.captures == 1


def test_serve_bench_cli(capsys):
    from dist_svgd_torch.tools import serve_bench

    assert serve_bench.main(["--device", "cpu", "--n-particles", "32", "--n-features", "3",
                             "--requests", "12", "--clients", "2"]) == 0
    row = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert row["metric"] == "serve_throughput" and row["recompiles"] == 0
    # --devices 2 on a host with one device serves from it (make_plan's
    # degradation, as in JAX), and the row says so
    assert serve_bench.main(["--device", "cpu", "--devices", "2", "--n-particles", "32",
                             "--n-features", "3", "--requests", "12", "--clients", "2"]) == 0
    row = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert row["devices"] == 1 and row["recompiles"] == 0


def test_server_shards_beyond_the_host_serve_from_one_device(tmp_path, rng, monkeypatch):
    """``serving.server --shards 2`` on a one-device host serves from the
    single-device plan (JAX: "falls back gracefully"): a request through
    the HTTP server equals a direct engine on make_plan(1), bit for bit."""
    from dist_svgd_torch.parallel.plan import make_plan
    from dist_svgd_torch.serving import server

    parts = rng.normal(size=(16, 4)).astype(np.float32)
    save_state(str(tmp_path / "c"), {"particles": parts, "t": 1})
    x = rng.normal(size=(3, 3)).astype(np.float32)
    got = {}

    def serve(self):  # one request instead of the blocking loop
        self.start()
        try:
            got["plan"] = self.engine.plan.describe()
            got["health"] = _get(self.url, "/healthz")
            got["out"] = _post(self.url, "/predict", {"inputs": x.tolist()})["outputs"]
        finally:
            self.shutdown()

    monkeypatch.setattr(server.PredictionServer, "serve_forever", serve)
    server.main(["--checkpoint", str(tmp_path / "c"), "--device", "cpu", "--shards", "2",
                 "--port", "0", "--max-batch", "8", "--no-usage-metering"])
    direct = PredictiveEngine.from_checkpoint(str(tmp_path / "c"), "logreg", max_bucket=8,
                                              plan=make_plan(1, device="cpu"))
    assert got["plan"] == direct.plan.describe() == {"sharded": False, "num_shards": 1,
                                                     "devices": None}
    assert got["health"]["devices"] == 1
    want = direct.predict(x)
    for k in ("mean", "var"):
        np.testing.assert_array_equal(np.asarray(got["out"][k], np.float32), want[k])


# --------------------------------------------------------------------- #
# hot reload, generations, candidates


def test_engine_reload_swaps_atomically(rng):
    eng, parts1 = _logreg_engine(rng)
    x = rng.normal(size=(5, 4)).astype(np.float32)
    before = eng.predict(x)
    parts2 = rng.normal(size=(48, 5)).astype(np.float32)
    info = eng.reload(parts2, tag="gen2")
    assert info["n_particles"] == 48 and info["generation_id"] == 2
    misses = eng.stats()["bucket_misses"]
    after = eng.predict(x)
    assert eng.stats()["bucket_misses"] == misses  # rebuilt before the swap
    np.testing.assert_array_equal(after["mean"], _engine("logreg", parts2).predict(x)["mean"])
    assert not np.array_equal(before["mean"], after["mean"])
    st = eng.stats()
    assert st["reloads"] == 1 and st["ensemble_tag"] == "gen2"


def test_engine_reload_rejects_layout_change(rng):
    eng, _ = _logreg_engine(rng)
    with pytest.raises(ValueError, match="incompatible"):
        eng.reload(rng.normal(size=(32, 9)).astype(np.float32))
    with pytest.raises(ValueError, match="incompatible"):
        eng.reload(rng.normal(size=(32,)).astype(np.float32))
    with pytest.raises(ValueError, match="incompatible"):
        eng.stage_candidate(rng.normal(size=(32, 9)).astype(np.float32))


def test_engine_reload_under_concurrent_predicts(rng):
    """Predicts racing a reload — direct callers and two batcher lanes —
    each see ONE consistent ensemble (old or new), with no errors; the
    swapped ensemble serves afterwards."""
    eng, parts1 = _logreg_engine(rng, n=64)
    parts2 = rng.normal(size=(64, 5)).astype(np.float32)
    x = rng.normal(size=(4, 4)).astype(np.float32)
    want_old = eng.predict(x)["mean"]
    want_new = _engine("logreg", parts2).predict(x)["mean"]
    bat = MicroBatcher(eng.predict, max_batch=8, lanes=2, max_wait_ms=0.5)
    results, errors = [], []

    def hammer(direct):
        try:
            for _ in range(30):
                out = eng.predict(x) if direct else bat.submit(x).result(timeout=10)
                results.append(out["mean"])
        except Exception as e:  # pragma: no cover - failure surface
            errors.append(e)

    threads = [threading.Thread(target=hammer, args=(i % 2 == 0,)) for i in range(4)]
    for t in threads:
        t.start()
    eng.reload(parts2)
    for t in threads:
        t.join()
    bat.close()
    assert not errors and len(results) == 120
    for mean in results:
        assert np.array_equal(mean, want_old) or np.array_equal(mean, want_new)
    np.testing.assert_array_equal(eng.predict(x)["mean"], want_new)


def test_generations_follow_jax_call_sequence(rng):
    """Reload, rollback (twice), stage / candidate predict / promote, stage
    / drop: the port's generation ids, counters and outputs after every
    call equal JAX's engine on the same sequence."""
    gens = [rng.normal(size=(24, 5)) for _ in range(4)]
    x = rng.normal(size=(3, 4))
    eng, jeng = _engine("logreg", gens[0]), _jax_engine("logreg", gens[0])
    keys = ("generation_id", "previous_generation_id", "candidate_generation_id",
            "candidate_tag", "ensemble_tag", "reloads", "rollbacks", "compiled_buckets")

    def same(generation="serving"):
        st, jst = eng.stats(), jeng.stats()
        assert {k: st[k] for k in keys} == {k: jst[k] for k in keys}
        _assert_close(eng.predict(x, generation)["mean"],
                      jeng.predict(x, generation)["mean"], np.float64)

    same()
    for e in (eng, jeng):
        with pytest.raises(RuntimeError, match="no previous generation"):
            e.rollback()
        with pytest.raises(RuntimeError, match="no candidate"):
            e.predict(x, generation="candidate")
        with pytest.raises(RuntimeError, match="no candidate"):
            e.promote_candidate()
    assert eng.reload(gens[1], tag="g2") == jeng.reload(gens[1], tag="g2")
    same()
    assert eng.rollback() == jeng.rollback()
    same()
    assert eng.rollback() == jeng.rollback()  # a mistaken rollback recovers
    same()
    assert eng.stage_candidate(gens[2], tag="c3") == jeng.stage_candidate(gens[2], tag="c3")
    same("candidate")
    same()
    assert eng.promote_candidate() == jeng.promote_candidate()
    same()
    assert eng.stage_candidate(gens[3], tag="c4") == jeng.stage_candidate(gens[3], tag="c4")
    assert eng.drop_candidate() is jeng.drop_candidate() is True
    assert eng.drop_candidate() is jeng.drop_candidate() is False
    same()


def test_reload_policy_rejects_like_jax(rng, tmp_path):
    """A collapsed candidate (every particle one point) is refused by both
    engines' ReloadPolicy with the same reasons; a healthy one is admitted
    and becomes the baseline; the reloader keeps serving past a refusal."""
    from dist_svgd_tpu.telemetry.diagnostics import ReloadPolicy as JPolicy

    healthy = rng.normal(size=(64, 5))
    collapsed = np.tile(rng.normal(size=(1, 5)), (64, 1)) + 1e-9 * rng.normal(size=(64, 5))
    eng = _engine("logreg", healthy, reload_policy=ReloadPolicy(min_ess_frac=0.2))
    jeng = _jax_engine("logreg", healthy, reload_policy=JPolicy(min_ess_frac=0.2))
    with pytest.raises(EnsembleRejected) as ours:
        eng.reload(collapsed, tag="bad")
    from dist_svgd_tpu.serving import EnsembleRejected as JRejected

    with pytest.raises(JRejected) as theirs:
        jeng.reload(collapsed, tag="bad")
    assert [r.split()[0] for r in ours.value.reasons] == [
        r.split()[0] for r in theirs.value.reasons]
    assert eng.stats()["reload_rejects"] == 1 and eng.stats()["generation_id"] == 1
    info = eng.reload(rng.normal(size=(64, 5)), tag="good")
    assert info["generation_id"] == 2 and eng.stats()["ensemble_health"]["ess_frac"] > 0.2

    root = str(tmp_path / "root")
    mgr = CheckpointManager(root, every=1)
    mgr.save(1, {"particles": healthy})
    served = PredictiveEngine.from_checkpoint(root, "logreg", min_bucket=4, max_bucket=8,
                                              reload_policy=ReloadPolicy(min_ess_frac=0.2),
                                              device="cpu")
    hr = CheckpointHotReloader(served, root)
    mgr.save(2, {"particles": collapsed})
    assert hr.poll_once() is None and hr.loaded_step == 2
    assert served.stats()["reload_rejects"] == 1 and served.stats()["reloads"] == 0


def test_hot_reloader_polls_and_swaps(tmp_path, rng):
    parts1 = rng.normal(size=(16, 5)).astype(np.float32)
    parts2 = rng.normal(size=(16, 5)).astype(np.float32)
    root = str(tmp_path / "root")
    mgr = CheckpointManager(root, every=1, backend="npz")
    mgr.save(10, {"particles": parts1})
    eng = PredictiveEngine.from_checkpoint(root, "logreg", min_bucket=4, max_bucket=16,
                                           device="cpu")
    hr = CheckpointHotReloader(eng, root)
    assert hr.loaded_step == 10 and hr.poll_once() is None
    mgr.save(20, {"particles": parts2, "stream_watermark": np.float64(7.5)})
    assert hr.poll_once() == 20 and hr.poll_once() is None
    x = rng.normal(size=(3, 4)).astype(np.float32)
    np.testing.assert_array_equal(eng.predict(x)["mean"],
                                  _engine("logreg", parts2, max_bucket=16).predict(x)["mean"])
    assert eng.stats()["ensemble_tag"] == "step_20"
    assert eng.registry.gauge("svgd_serving_watermark").value(generation="2") == 7.5


def test_hot_reloader_thread_starts_and_stops(tmp_path, rng):
    root = str(tmp_path / "root")
    mgr = CheckpointManager(root, every=1)
    mgr.save(1, {"particles": rng.normal(size=(8, 5))})
    eng = PredictiveEngine.from_checkpoint(root, "logreg", min_bucket=4, max_bucket=8,
                                           device="cpu")
    mgr.save(2, {"particles": rng.normal(size=(8, 5))})
    with CheckpointHotReloader(eng, root, interval_s=0.01) as hr:
        for _ in range(1000):
            if hr.loaded_step == 2:
                break
            threading.Event().wait(0.005)
    assert hr.loaded_step == 2 and eng.stats()["reloads"] == 1 and hr._thread is None


def test_hot_reloader_corrupt_newest_keeps_serving(tmp_path, rng):
    root = str(tmp_path / "root")
    mgr = CheckpointManager(root, every=1, backend="npz")
    mgr.save(1, {"particles": rng.normal(size=(16, 5)).astype(np.float32)})
    eng = PredictiveEngine.from_checkpoint(root, "logreg", min_bucket=4, max_bucket=16,
                                           device="cpu")
    hr = CheckpointHotReloader(eng, root)
    bad = os.path.join(root, "step_2")
    os.makedirs(bad)
    with open(os.path.join(bad, "junk"), "w") as fh:
        fh.write("partial write")
    with pytest.warns(UserWarning, match="skipping unloadable"):
        assert hr.poll_once() is None
    assert hr.loaded_step == 1 and eng.stats()["reloads"] == 0


def test_hot_reloader_missing_key_raises(tmp_path, rng):
    root = str(tmp_path / "root")
    mgr = CheckpointManager(root, every=1, backend="npz")
    mgr.save(1, {"particles": rng.normal(size=(8, 5)).astype(np.float32)})
    eng = PredictiveEngine.from_checkpoint(root, "logreg", min_bucket=4, max_bucket=16,
                                           device="cpu")
    hr = CheckpointHotReloader(eng, root)
    mgr.save(2, {"other": np.zeros((8, 5), np.float32)})
    with pytest.raises(KeyError, match="particles"):
        hr.poll_once()


def test_hot_reloader_baseline_is_engine_loaded_step(tmp_path, rng):
    root = str(tmp_path / "root")
    mgr = CheckpointManager(root, every=1, backend="npz")
    mgr.save(10, {"particles": rng.normal(size=(16, 5)).astype(np.float32)})
    eng = PredictiveEngine.from_checkpoint(root, "logreg", min_bucket=4, max_bucket=16,
                                           device="cpu")
    assert eng.checkpoint_step == 10
    mgr.save(20, {"particles": rng.normal(size=(16, 5)).astype(np.float32)})
    hr = CheckpointHotReloader(eng, root)
    assert hr.loaded_step == 10 and hr.poll_once() == 20


# --------------------------------------------------------------------- #
# what is not ported raises, naming its label


def test_unported_options_raise_naming_their_label(rng, monkeypatch, tmp_path):
    """Every option that once raised for want of a port now runs: the
    mesh (``mesh=``, ``Plan(mesh)``, ``make_plan(2)`` where two devices
    exist, ``server --shards 2``), the fleet's names and the autoscale
    controller.  (The test's name is from when they raised.)"""
    import dist_svgd_torch.serving as tserving
    from dist_svgd_torch.parallel import plan as tplan
    from dist_svgd_torch.parallel.plan import AXIS, Mesh, Plan, make_plan
    from dist_svgd_torch.serving import server

    parts = rng.normal(size=(8, 3)).astype(np.float32)
    meshed = PredictiveEngine("logreg", parts, mesh=Mesh(["cpu"] * 2), max_bucket=8)
    assert meshed.particles.spec == (AXIS, None)
    assert Plan(Mesh(["cpu"] * 2)).num_shards == 2
    monkeypatch.setattr(tplan, "visible_devices", lambda device: 4)
    assert make_plan(2, device="cpu").num_shards == 2  # where 2 devices exist
    # the serving fleet is ported: its six names resolve to the port's classes
    from dist_svgd_torch.serving import fleet as tfleet

    for name in ("FleetRouter", "MetricsFederation", "ReplicaSet", "HttpTransport",
                 "FakeTransport", "LoopbackReplica"):
        assert getattr(tserving, name) is getattr(tfleet, name)
        assert getattr(tserving, name).__module__ == "dist_svgd_torch.serving.fleet"
    from dist_svgd_tpu import serving as jserving

    assert tserving.__all__ == jserving.__all__
    # the autoscale controller is ported: its names resolve, and the server
    # builds one over its own batcher
    from dist_svgd_torch.serving.autoscale import AutoscaleController, AutoscalePolicy

    assert tserving.AutoscaleController is AutoscaleController
    assert tserving.AutoscalePolicy is AutoscalePolicy
    eng = _engine("logreg", parts)
    srv = PredictionServer(eng, port=0, autoscale=True).start()
    try:
        assert isinstance(srv.autoscale, AutoscaleController)
        assert srv.autoscale.batcher is srv.batcher
    finally:
        srv.shutdown()
    save_state(str(tmp_path / "c"), {"particles": parts, "t": 1})
    x = rng.normal(size=(3, 2)).astype(np.float32)
    got = {}

    def serve(self):  # one request instead of the blocking loop
        self.start()
        try:
            got["plan"] = self.engine.plan.describe()
            got["health"] = _get(self.url, "/healthz")
            got["out"] = _post(self.url, "/predict", {"inputs": x.tolist()})["outputs"]
        finally:
            self.shutdown()

    monkeypatch.setattr(server.PredictionServer, "serve_forever", serve)
    server.main(["--checkpoint", str(tmp_path / "c"), "--device", "cpu", "--shards", "2",
                 "--port", "0", "--max-batch", "8", "--no-usage-metering"])
    assert got["plan"] == {"sharded": True, "num_shards": 2, "devices": ["cpu", "cpu"]}
    assert got["health"]["devices"] == 2
    want = _engine("logreg", parts, max_bucket=8).predict(x)
    for k in ("mean", "var"):
        np.testing.assert_allclose(np.asarray(got["out"][k], np.float32), want[k],
                                   rtol=1e-5, atol=1e-7)


# --------------------------------------------------------------------- #
# the Covertype train → checkpoint → serve driver against JAX's

SERVE_CT = dict(nrows=2000, nproc=2, nparticles=64, niter=5, requests=16, max_batch=32)


@pytest.fixture(scope="module")
def jax_serve_covertype_line(tmp_path_factory):
    """JAX's ``experiments/serve_covertype.py``, in process, shrunk."""
    import contextlib
    import importlib.util
    import io
    import sys

    with pytest.MonkeyPatch.context() as mp:
        mp.syspath_prepend(os.path.join(ROOT, "experiments"))
        spec = importlib.util.spec_from_file_location(
            "jax_serve_covertype", os.path.join(ROOT, "experiments", "serve_covertype.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        args = [f"--{k.replace('_', '-')}={v}" for k, v in SERVE_CT.items()]
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            mod.cli.main(args + ["--backend", "cpu", "--checkpoint-dir",
                                 str(tmp_path_factory.mktemp("jax_sc") / "ckpt")],
                         standalone_mode=False)
        sys.modules.pop("covertype", None)
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def test_serve_covertype_line_equals_jax(tmp_path, jax_serve_covertype_line, capsys):
    """Train, cold-start from the manager root, serve the held-out rows over
    concurrent HTTP: JAX's keys, every row served without a request error,
    the served means at the direct call's; ``--no-train`` serves the same
    checkpoint again."""
    from dist_svgd_torch.experiments import serve_covertype as tsc

    want = jax_serve_covertype_line
    out = tsc.run(checkpoint_dir=str(tmp_path / "ckpt"), device="cpu", **SERVE_CT)
    train = out.pop("train")
    assert set(out) == set(want)
    assert set(out["metrics"]) == set(want["metrics"])
    for part in ("batcher", "engine"):
        assert set(out["metrics"][part]) == set(want["metrics"][part]), part
    assert out["request_errors"] == want["request_errors"] == []
    assert out["rows_served"] == want["rows_served"]
    assert out["served_vs_direct_max_abs_dev"] <= 1e-6
    assert 0.0 <= out["served_test_acc"] <= 1.0 and train["niter"] == 5
    assert out["metrics"]["engine"]["bucket_misses"] == len(
        out["metrics"]["engine"]["compiled_buckets"])
    assert tsc.main(["--no-train", "--device", "cpu", "--checkpoint-dir",
                     str(tmp_path / "ckpt"), "--nrows", "2000", "--requests", "4"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(line) == set(want) and line["request_errors"] == []
