"""The port's multi-tenant registry (``dist_svgd_torch/serving/
registry.py``) against JAX's, case for case with ``tests/test_registry.py``,
on the CPU: the KernelBucketLRU's bounds and hot-tenant protection (under
the port's capture sentry), quota shed priorities, tenant lifecycle, the
shared scanner's isolation, HTTP routing on the tenant field, the
``serve_multitenant`` row's keys against JAX's, and ``begin_rollout``'s
arguments (its lifecycle is ``test_torch_rollout.py``'s)."""

import json
import os
import threading
import urllib.error
import urllib.request
from concurrent.futures import CancelledError

import numpy as np
import pytest

from dist_svgd_torch.models.bnn import num_params
from dist_svgd_torch.parallel.plan import capture_sentry
from dist_svgd_torch.serving import (
    KernelBucketLRU,
    MicroBatcher,
    ModelRegistry,
    Overloaded,
    PredictionServer,
    PredictiveEngine,
)
from dist_svgd_torch.telemetry import MetricsRegistry, ReloadPolicy
from dist_svgd_torch.utils.checkpoint import CheckpointManager

from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def rng():
    return np.random.default_rng(11)


def _registry(**kw):
    kw.setdefault("metrics", MetricsRegistry())
    kw.setdefault("max_wait_ms", 0.5)
    return ModelRegistry(**kw)


def _add_logreg(reg, name, rng, n=16, k=4, **kw):
    parts = rng.normal(size=(n, 1 + k)).astype(np.float32)
    kw.setdefault("min_bucket", 4)
    kw.setdefault("max_bucket", 16)
    tenant = reg.add_tenant(name, "logreg", particles=parts, device="cpu", **kw)
    return tenant, parts


def _standalone(model, parts, **kw):
    kw.setdefault("min_bucket", 4)
    kw.setdefault("max_bucket", 16)
    return PredictiveEngine(model, parts, registry=MetricsRegistry(), device="cpu", **kw)


# --------------------------------------------------------------------- #
# KernelBucketLRU


def test_lru_bounds_total_buckets_and_counts_evictions(rng):
    met = MetricsRegistry()
    cache = KernelBucketLRU(max_buckets=3)
    engines = [
        PredictiveEngine("logreg", rng.normal(size=(8, 5)).astype(np.float32),
                         min_bucket=4, max_bucket=32, registry=met, tenant=f"t{i}",
                         kernel_cache=cache, device="cpu")
        for i in range(2)
    ]
    x4 = rng.normal(size=(4, 4)).astype(np.float32)
    x8 = rng.normal(size=(8, 4)).astype(np.float32)
    x16 = rng.normal(size=(16, 4)).astype(np.float32)
    engines[0].predict(x4)
    engines[0].predict(x8)
    engines[1].predict(x4)
    assert cache.stats() == {"size": 3, "max_buckets": 3, "evictions": 0}
    engines[1].predict(x8)  # a 4th distinct bucket evicts engine0's bucket 4
    st = cache.stats()
    assert st["size"] == 3 and st["evictions"] == 1
    e0 = engines[0].stats()
    assert e0["bucket_evictions"] == 1 and e0["compiled_buckets"] == [8]
    assert e0["bucket_cache_size"] == 1
    assert met.counter("svgd_registry_evictions_total").value(tenant="t0") == 1
    before = engines[0].stats()["bucket_misses"]
    engines[0].predict(x4)  # the evicted bucket is built again: a counted miss
    assert engines[0].stats()["bucket_misses"] == before + 1
    direct = _standalone("logreg", engines[0].particles.numpy(), max_bucket=32)
    np.testing.assert_array_equal(engines[0].predict(x16)["mean"],
                                  direct.predict(x16)["mean"])


def test_lru_eviction_sequence_equals_jax(rng):
    """The same touches through both LRUs (three engines, random buckets):
    the same evictions, sizes and per-engine compiled buckets after every
    request."""
    from dist_svgd_tpu.serving import KernelBucketLRU as JLRU
    from dist_svgd_tpu.serving import PredictiveEngine as JEngine
    from dist_svgd_tpu.telemetry import MetricsRegistry as JMetrics

    cache, jcache = KernelBucketLRU(max_buckets=4), JLRU(max_buckets=4)
    parts = [rng.normal(size=(8, 5)).astype(np.float32) for _ in range(3)]
    ours = [PredictiveEngine("logreg", p, min_bucket=2, max_bucket=16, tenant=f"t{i}",
                             registry=MetricsRegistry(), kernel_cache=cache, device="cpu")
            for i, p in enumerate(parts)]
    theirs = [JEngine("logreg", p, min_bucket=2, max_bucket=16, tenant=f"t{i}",
                      registry=JMetrics(), kernel_cache=jcache)
              for i, p in enumerate(parts)]
    for step in range(24):
        i, rows = int(rng.integers(3)), int(rng.integers(1, 17))
        x = rng.normal(size=(rows, 4)).astype(np.float32)
        ours[i].predict(x)
        theirs[i].predict(x)
        assert cache.stats() == jcache.stats(), step
        assert ([e.stats()["compiled_buckets"] for e in ours]
                == [e.stats()["compiled_buckets"] for e in theirs]), step
    assert cache.stats()["evictions"] > 0


def test_lru_forget_drops_without_counting(rng):
    cache = KernelBucketLRU(max_buckets=8)
    eng = PredictiveEngine("logreg", rng.normal(size=(8, 5)).astype(np.float32),
                           min_bucket=4, max_bucket=16, registry=MetricsRegistry(),
                           kernel_cache=cache, device="cpu")
    eng.warmup()
    assert cache.stats()["size"] == 3
    assert cache.forget(eng) == 3
    assert cache.stats() == {"size": 0, "max_buckets": 8, "evictions": 0}


def test_lru_validates_capacity():
    with pytest.raises(ValueError, match="max_buckets"):
        KernelBucketLRU(max_buckets=0)


def test_hot_tenant_never_recompiles_while_cold_tenants_churn(rng):
    met = MetricsRegistry()
    cache = KernelBucketLRU(max_buckets=3)
    hot = PredictiveEngine("logreg", rng.normal(size=(8, 5)).astype(np.float32),
                           min_bucket=8, max_bucket=8, registry=met, tenant="hot",
                           kernel_cache=cache, device="cpu")
    colds = [PredictiveEngine("logreg", rng.normal(size=(8, 3 + i)).astype(np.float32),
                              min_bucket=8, max_bucket=8, registry=met, tenant=f"cold{i}",
                              kernel_cache=cache, device="cpu")
             for i in range(4)]
    xh = rng.normal(size=(5, 4)).astype(np.float32)
    hot.warmup([5])
    for round_i in range(8):
        hot.predict(xh)
        cold = colds[round_i % len(colds)]
        cold.predict(rng.normal(size=(3, cold.feature_dim)).astype(np.float32))
    assert cache.stats()["evictions"] >= 4
    assert hot.stats()["bucket_evictions"] == 0
    misses_before = hot.stats()["bucket_misses"]
    with capture_sentry("hot tenant steady state") as sentry:
        for _ in range(16):
            hot.predict(xh)
    assert hot.stats()["bucket_misses"] == misses_before
    assert sentry.compiles == 0


# --------------------------------------------------------------------- #
# quota shed priorities (deterministic: paused batcher)


def test_quota_priority_shed_hog_before_polite(rng):
    reg = _registry(max_batch=8, max_queue_rows=32, batcher_autostart=False)
    _add_logreg(reg, "hog", rng, quota_rows=8, min_bucket=8, max_bucket=8)
    _add_logreg(reg, "polite", rng, min_bucket=8, max_bucket=8)
    x = rng.normal(size=(8, 4)).astype(np.float32)
    hog_futs = [reg.submit("hog", x) for _ in range(4)]
    polite_fut = reg.submit("polite", x)
    stats = reg.batcher.stats()
    assert stats["quota_sheds"] == {"hog": 1}
    assert stats["tenant_queued"] == {"hog": 24, "polite": 8}
    assert isinstance(hog_futs[3].exception(timeout=1), Overloaded)
    assert "quota" in str(hog_futs[3].exception())
    with pytest.raises(Overloaded, match="over its inflight-rows quota"):
        reg.submit("hog", x)
    assert reg.batcher.stats()["quota_sheds"] == {"hog": 2}
    met = reg.metrics
    assert met.counter("svgd_serve_quota_sheds_total").value(tenant="hog") == 2
    assert met.counter("svgd_serve_quota_sheds_total").value(tenant="polite") == 0
    reg.batcher.start()
    assert polite_fut.result(timeout=30)["mean"].shape == (8,)
    for fut in hog_futs[:3]:
        assert fut.result(timeout=30)["mean"].shape == (8,)
    reg.close()


def test_quotas_inert_while_queue_has_room(rng):
    reg = _registry(max_batch=8, max_queue_rows=64, batcher_autostart=False)
    _add_logreg(reg, "hog", rng, quota_rows=8, min_bucket=8, max_bucket=8)
    x = rng.normal(size=(8, 4)).astype(np.float32)
    futs = [reg.submit("hog", x) for _ in range(4)]
    assert reg.batcher.stats()["quota_sheds"] == {}
    reg.batcher.start()
    for fut in futs:
        assert fut.result(timeout=30)["mean"].shape == (8,)
    reg.close()


def test_admission_quota_mode_refuses_before_queueing(rng):
    """``set_quota_mode('admission')`` refuses an over-quota tenant at
    submit time even with queue room; 'overflow' restores the default."""
    reg = _registry(max_batch=8, max_queue_rows=64, batcher_autostart=False)
    _add_logreg(reg, "hog", rng, quota_rows=8, min_bucket=8, max_bucket=8)
    x = rng.normal(size=(8, 4)).astype(np.float32)
    assert reg.batcher.set_quota_mode("admission") == "overflow"
    first = reg.submit("hog", x)
    with pytest.raises(Overloaded, match="admission-enforced"):
        reg.submit("hog", x)
    with pytest.raises(ValueError, match="quota mode"):
        reg.batcher.set_quota_mode("nope")
    assert reg.batcher.set_quota_mode("overflow") == "admission"
    second = reg.submit("hog", x)
    reg.batcher.start()
    for fut in (first, second):
        assert fut.result(timeout=30)["mean"].shape == (8,)
    reg.close()


def test_batches_never_mix_tenants():
    seen = []

    def dispatch(x, tenant):
        seen.append((tenant, x.shape[0]))
        return {"v": np.zeros(x.shape[0], np.float32)}

    bat = MicroBatcher(dispatch, max_batch=64, max_wait_ms=0.0,
                       registry=MetricsRegistry(), autostart=False)
    xa = np.zeros((2, 3), np.float32)
    futs = [bat.submit(xa, tenant="a" if i % 2 == 0 else "b") for i in range(6)]
    bat.start()
    for fut in futs:
        assert fut.result(timeout=10)["v"].shape == (2,)
    bat.close()
    assert sum(rows for _, rows in seen) == 12
    assert all(t in ("a", "b") for t, _ in seen) and len(seen) == 6


# --------------------------------------------------------------------- #
# registry lifecycle


def test_registry_validates_names_and_args(rng):
    reg = _registry()
    with pytest.raises(ValueError, match="invalid tenant name"):
        reg.add_tenant("bad name!", "logreg", particles=np.zeros((4, 3), np.float32))
    with pytest.raises(ValueError, match="reserved"):
        reg.add_tenant("other", "logreg", particles=np.zeros((4, 3), np.float32))
    with pytest.raises(ValueError, match="exactly one of"):
        reg.add_tenant("t", "logreg")
    _add_logreg(reg, "t", rng)
    with pytest.raises(ValueError, match="already registered"):
        _add_logreg(reg, "t", rng)
    with pytest.raises(KeyError, match="unknown tenant"):
        reg.submit("ghost", np.zeros((1, 4), np.float32))
    with pytest.raises(KeyError, match="unknown tenant"):
        reg.remove_tenant("ghost")
    with pytest.raises(ValueError, match="watch=True"):
        _add_logreg(reg, "w", rng, watch=True)
    from dist_svgd_tpu.serving import ModelRegistry as JRegistry

    jreg = JRegistry(max_wait_ms=0.5)
    try:
        for r in (reg, jreg):  # JAX's refusal, word for word
            with pytest.raises(KeyError, match="unknown tenant 'ghost'"):
                r.begin_rollout("ghost")
    finally:
        jreg.close()
    assert reg.rollout_status() is None
    ro = reg.begin_rollout("t")
    assert reg.rollout_status()["tenant"] == "t" and reg.batcher.rollout is ro
    reg.close()
    assert reg.rollout_status() is None and reg.batcher.rollout is None
    with pytest.raises(RuntimeError, match="closed"):
        _add_logreg(reg, "late", rng)


def test_ten_tenants_mixed_shapes_concurrent_zero_churn(rng):
    """12 tenants of mixed kinds and shapes serve concurrently from one
    process with zero steady-state captures (the capture sentry), and
    every tenant's answers are bitwise those of a standalone engine."""
    met = MetricsRegistry()
    reg = _registry(metrics=met, max_batch=32, max_wait_ms=0.2)
    specs = []
    for i in range(12):
        kind = ("logreg", "bnn", "gmm")[i % 3]
        name = f"{kind}-{i}"
        if kind == "logreg":
            k = 3 + (i % 4)
            parts = rng.normal(size=(12 + i, 1 + k)).astype(np.float32)
            kw = {}
        elif kind == "bnn":
            nf = 3 + (i % 2)
            parts = rng.normal(size=(8, num_params(nf, 8))).astype(np.float32)
            kw = dict(n_features=nf, n_hidden=8)
        else:
            parts = rng.normal(size=(10 + i, 2 + (i % 3))).astype(np.float32)
            kw = {}
        reg.add_tenant(name, kind, particles=parts, min_bucket=4, max_bucket=8,
                       device="cpu", **kw)
        ref = _standalone(kind, parts, max_bucket=8, **kw)
        specs.append((name, ref, rng.normal(size=(3, ref.feature_dim)).astype(np.float32)))
    assert len(reg) == 12
    reg.warm([3])
    misses = {n: reg.tenant(n).engine.stats()["bucket_misses"] for n, _, _ in specs}
    errors = []

    def hammer(name, x):
        try:
            for _ in range(6):
                reg.predict(name, x, timeout=60)
        except Exception as e:  # surfaced after join
            errors.append((name, e))

    with capture_sentry("12-tenant concurrent window") as sentry:
        threads = [threading.Thread(target=hammer, args=(n, x)) for n, _, x in specs]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    assert errors == [] and sentry.compiles == 0
    for n, _, _ in specs:
        assert reg.tenant(n).engine.stats()["bucket_misses"] == misses[n]
    for n, ref, x in specs:
        got, want = reg.predict(n, x), ref.predict(x)
        assert sorted(got) == sorted(want)
        for key in got:
            np.testing.assert_array_equal(got[key], want[key])
    expo = met.exposition()
    for n, _, _ in specs:
        assert f'tenant="{n}"' in expo
    reg.close()


def test_corrupt_newest_checkpoint_isolated_to_its_tenant(tmp_path, rng):
    roots, gens = {}, {}
    for name in ("alpha", "beta"):
        root = str(tmp_path / name)
        mgr = CheckpointManager(root, every=1, backend="npz")
        parts = rng.normal(size=(12, 5)).astype(np.float32)
        mgr.save(1, {"particles": parts})
        roots[name], gens[name] = (root, mgr), parts
    reg = _registry()
    for name, (root, _) in roots.items():
        reg.add_tenant(name, "logreg", checkpoint=root, watch=True, min_bucket=4,
                       max_bucket=8, device="cpu")
    alpha_new = rng.normal(size=(12, 5)).astype(np.float32)
    roots["alpha"][1].save(2, {"particles": alpha_new})
    bad = os.path.join(roots["beta"][0], "step_2")
    os.makedirs(bad)
    with open(os.path.join(bad, "junk"), "w") as fh:
        fh.write("partial write")
    with pytest.warns(UserWarning, match="skipping unloadable"):
        swapped = reg.poll_once()
    assert swapped == {"alpha": 2, "beta": None}
    x = rng.normal(size=(2, 4)).astype(np.float32)
    np.testing.assert_array_equal(reg.predict("alpha", x)["mean"],
                                  _standalone("logreg", alpha_new, max_bucket=8).predict(x)["mean"])
    np.testing.assert_array_equal(reg.predict("beta", x)["mean"],
                                  _standalone("logreg", gens["beta"], max_bucket=8).predict(x)["mean"])
    reg.close()


def test_rejected_reload_isolated_to_its_tenant(tmp_path, rng):
    roots = {}
    for name in ("guarded", "plain"):
        root = str(tmp_path / name)
        mgr = CheckpointManager(root, every=1, backend="npz")
        mgr.save(1, {"particles": rng.normal(size=(32, 5)).astype(np.float32)})
        roots[name] = (root, mgr)
    reg = _registry()
    reg.add_tenant("guarded", "logreg", checkpoint=roots["guarded"][0], watch=True,
                   min_bucket=4, max_bucket=8, device="cpu",
                   reload_policy=ReloadPolicy(min_ess_frac=0.05, max_points=32))
    reg.add_tenant("plain", "logreg", checkpoint=roots["plain"][0], watch=True,
                   min_bucket=4, max_bucket=8, device="cpu")
    collapsed = np.tile(rng.normal(size=(1, 5)).astype(np.float32), (32, 1))
    roots["guarded"][1].save(2, {"particles": collapsed})
    roots["plain"][1].save(2, {"particles": rng.normal(size=(32, 5)).astype(np.float32)})
    swapped = reg.poll_once()
    assert swapped == {"guarded": None, "plain": 2}
    st = reg.stats()["tenants"]
    assert st["guarded"]["reload_rejects"] == 1 and st["guarded"]["loaded_step"] == 2
    assert st["guarded"]["reloads"] == 0 and st["plain"]["reloads"] == 1
    assert st["guarded"]["reload_errors"] == 0
    x = rng.normal(size=(2, 4)).astype(np.float32)
    assert reg.predict("guarded", x)["mean"].shape == (2,)
    assert reg.predict("plain", x)["mean"].shape == (2,)
    reg.close()


def test_scanner_error_isolated_and_counted(tmp_path, rng):
    mgrs = {}
    reg = _registry()
    for name in ("ok", "bad"):
        root = str(tmp_path / name)
        mgrs[name] = CheckpointManager(root, every=1, backend="npz")
        mgrs[name].save(1, {"particles": rng.normal(size=(8, 5)).astype(np.float32)})
        reg.add_tenant(name, "logreg", checkpoint=root, watch=True, min_bucket=4,
                       max_bucket=8, device="cpu")
    mgrs["ok"].save(2, {"particles": rng.normal(size=(8, 5)).astype(np.float32)})
    mgrs["bad"].save(2, {"wrong_key": np.zeros((8, 5), np.float32)})
    assert reg.poll_once() == {"ok": 2, "bad": None}
    st = reg.stats()["tenants"]
    assert st["bad"]["reload_errors"] == 1 and st["ok"]["reload_errors"] == 0
    assert reg.metrics.counter("svgd_registry_reload_errors_total").value(tenant="bad") == 1
    reg.close()


def test_scanner_thread_swaps_and_stops(tmp_path, rng):
    root = str(tmp_path / "root")
    mgr = CheckpointManager(root, every=1)
    mgr.save(1, {"particles": rng.normal(size=(8, 5)).astype(np.float32)})
    reg = _registry(scan_interval_s=0.01)
    tenant = reg.add_tenant("w", "logreg", checkpoint=root, watch=True, min_bucket=4,
                            max_bucket=8, device="cpu")
    mgr.save(2, {"particles": rng.normal(size=(8, 5)).astype(np.float32)})
    reg.start_scanner()
    for _ in range(1000):
        if tenant.reloader.loaded_step == 2:
            break
        threading.Event().wait(0.005)
    reg.close()
    assert tenant.reloader.loaded_step == 2 and reg._scan_thread is None


def test_add_remove_under_load_drains_cleanly(rng):
    reg = _registry(max_batch=16, max_wait_ms=0.2)
    _add_logreg(reg, "stay", rng)
    _add_logreg(reg, "go", rng)
    x = rng.normal(size=(2, 4)).astype(np.float32)
    reg.warm([2])
    stop = threading.Event()
    errors = []

    def stay_traffic():
        while not stop.is_set():
            try:
                reg.predict("stay", x, timeout=30)
            except Exception as e:
                errors.append(e)
                return

    t = threading.Thread(target=stay_traffic)
    t.start()
    futs = [reg.submit("go", x) for _ in range(20)]
    reg.remove_tenant("go", drain=True, timeout=30)
    for fut in futs:
        assert fut.result(timeout=30)["mean"].shape == (2,)
    assert "go" not in reg
    with pytest.raises(KeyError, match="unknown tenant"):
        reg.submit("go", x)
    _, parts = _add_logreg(reg, "late", rng)
    np.testing.assert_array_equal(reg.predict("late", x)["mean"],
                                  _standalone("logreg", parts).predict(x)["mean"])
    stop.set()
    t.join(timeout=30)
    assert errors == [] and reg.tenant_names() == ["late", "stay"]
    reg.close()


def test_tenant_pending_rows_covers_collected_batches():
    release, entered = threading.Event(), threading.Event()

    def slow_dispatch(x, tenant):
        entered.set()
        release.wait(10)
        return {"v": np.zeros(x.shape[0], np.float32)}

    bat = MicroBatcher(slow_dispatch, max_batch=8, max_wait_ms=0.0,
                       registry=MetricsRegistry())
    fut = bat.submit(np.zeros((4, 3), np.float32), tenant="t")
    assert entered.wait(10)
    assert bat.tenant_queued_rows("t") == 0 and bat.tenant_pending_rows("t") == 4
    release.set()
    assert fut.result(timeout=10)["v"].shape == (4,)
    assert bat.tenant_pending_rows("t") == 0
    bat.close()


def test_remove_without_drain_cancels_queued(rng):
    reg = _registry(max_batch=8, batcher_autostart=False)
    _add_logreg(reg, "doomed", rng, min_bucket=8, max_bucket=8)
    x = rng.normal(size=(8, 4)).astype(np.float32)
    futs = [reg.submit("doomed", x) for _ in range(3)]
    reg.remove_tenant("doomed", drain=False)
    for fut in futs:
        assert isinstance(fut.exception(timeout=1), CancelledError)
    assert reg.kernel_cache.stats()["size"] == 0
    reg.batcher.start()
    reg.close()


def test_remove_tenant_drain_wins_scanner_reload_race(tmp_path, rng):
    root = str(tmp_path / "race")
    mgr = CheckpointManager(root, every=1, backend="npz")
    mgr.save(1, {"particles": rng.normal(size=(16, 5)).astype(np.float32)})
    reg = _registry()
    tenant = reg.add_tenant("victim", "logreg", checkpoint=root, watch=True,
                            min_bucket=4, max_bucket=4, device="cpu")
    eng = tenant.engine
    x = rng.normal(size=(3, 4)).astype(np.float32)
    reg.predict("victim", x)
    assert reg.kernel_cache.stats()["size"] == 1
    stop = threading.Event()
    reload_errors = []

    def scanner():
        step = 2
        while not stop.is_set():
            try:
                mgr.save(step, {"particles": rng.normal(size=(16, 5)).astype(np.float32)})
                tenant.reloader.poll_once()
                step += 1
            except Exception as e:  # pragma: no cover - the race's loser
                reload_errors.append(e)
                return

    t = threading.Thread(target=scanner)
    t.start()
    reg.remove_tenant("victim", drain=True, timeout=30)
    stop.set()
    t.join(timeout=30)
    assert reload_errors == [] and "victim" not in reg
    with pytest.raises(KeyError, match="unknown tenant"):
        reg.submit("victim", x)
    assert reg.kernel_cache.stats()["size"] == 0
    mgr.save(99, {"particles": rng.normal(size=(16, 5)).astype(np.float32)})
    tenant.reloader.poll_once()
    assert eng.stats()["generation_id"] >= 2
    assert "victim" not in reg and reg.kernel_cache.stats()["size"] == 0
    reg.close()


def test_set_quota_live(rng):
    reg = _registry(batcher_autostart=False, max_batch=8, max_queue_rows=16)
    _add_logreg(reg, "t", rng, min_bucket=8, max_bucket=8)
    x = rng.normal(size=(8, 4)).astype(np.float32)
    reg.submit("t", x)
    reg.submit("t", x)
    with pytest.raises(Overloaded, match="queue full \\("):
        reg.submit("t", x)
    reg.set_quota("t", 8)
    assert reg.quota_snapshot() == {"t": 8}
    with pytest.raises(Overloaded, match="over its inflight-rows quota"):
        reg.submit("t", x)
    with pytest.raises(KeyError):
        reg.set_quota("ghost", 1)
    reg.batcher.start()
    reg.close()


# --------------------------------------------------------------------- #
# HTTP front end over a registry


def _post(url, body, timeout=10):
    req = urllib.request.Request(url + "/predict", json.dumps(body).encode(),
                                 {"Content-Type": "application/json"})
    try:
        return 200, json.loads(urllib.request.urlopen(req, timeout=timeout).read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _get(url, path, timeout=10):
    try:
        return 200, json.loads(urllib.request.urlopen(url + path, timeout=timeout).read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_server_routes_tenants(rng):
    met = MetricsRegistry()
    reg = _registry(metrics=met)
    _, parts_a = _add_logreg(reg, "a", rng)
    _add_logreg(reg, "b", rng)
    reg.warm([1])
    with PredictionServer(reg, port=0) as srv:
        url = srv.url
        code, body = _post(url, {"tenant": "a", "inputs": [[0.1] * 4]})
        assert code == 200 and body["tenant"] == "a"
        want = _standalone("logreg", parts_a).predict(
            np.asarray([[0.1] * 4], np.float32))["mean"][0]
        assert body["outputs"]["mean"][0] == pytest.approx(want, abs=0)
        code, body = _post(url, {"tenant": "ghost", "inputs": [[0.1] * 4]})
        assert code == 404 and "unknown tenant" in body["error"]
        code, body = _post(url, {"inputs": [[0.1] * 4]})
        assert code == 400 and "tenant" in body["error"]
        code, body = _get(url, "/tenants")
        assert code == 200 and sorted(body["tenants"]) == ["a", "b"]
        assert body["tenants"]["a"]["model"] == "logreg"
        code, body = _get(url, "/healthz")
        assert code == 200 and sorted(body["tenants"]) == ["a", "b"]
        code, body = _get(url, "/healthz/a")
        assert code == 200 and body["tenant"] == "a" and body["bucket_cache_size"] >= 1
        assert _get(url, "/healthz/ghost")[0] == 404
        code, body = _get(url, "/metrics.json")
        assert code == 200 and sorted(body["registry"]["tenants"]) == ["a", "b"]
        text = urllib.request.urlopen(url + "/metrics", timeout=10).read().decode()
        assert 'svgd_http_requests_total{route="/predict",status="200",tenant="a"}' in text
        assert 'tenant="a"' in text and 'tenant="b"' in text


def test_server_single_tenant_default_and_guard(rng):
    reg = _registry()
    _add_logreg(reg, "only", rng)
    with PredictionServer(reg, port=0) as srv:
        code, body = _post(srv.url, {"inputs": [[0.1] * 4]})
        assert code == 200 and body["tenant"] == "only"
    with pytest.raises(ValueError, match="shared batcher"):
        PredictionServer(_registry(), port=0, batcher=MicroBatcher(lambda x: {},
                                                                   autostart=False))
    eng = _standalone("logreg", rng.normal(size=(8, 5)).astype(np.float32))
    with PredictionServer(eng, port=0, registry=MetricsRegistry()) as srv:
        code, body = _post(srv.url, {"tenant": "x", "inputs": [[0.1] * 4]})
        assert code == 400 and "single-tenant" in body["error"]


def test_server_main_tenants_config(tmp_path, rng, monkeypatch, capsys):
    """``main --tenants-config`` builds the registry from JAX's spec format,
    warms it, and serves until interrupted (the serve loop is stubbed)."""
    from dist_svgd_torch.serving import server

    root = str(tmp_path / "t1")
    CheckpointManager(root, every=1).save(1, {"particles": rng.normal(size=(8, 5))})
    cfg = tmp_path / "tenants.json"
    cfg.write_text(json.dumps([{"name": "t1", "model": "logreg", "checkpoint": root,
                                "quota_rows": 64, "watch": True, "max_bucket": 8}]))
    served = {}

    def fake_serve_forever(self):
        self.start()  # the background loop shutdown() stops
        served["health"] = self.health()
        self.shutdown()

    monkeypatch.setattr(server.PredictionServer, "serve_forever", fake_serve_forever)
    server.main(["--tenants-config", str(cfg), "--port", "0", "--device", "cpu",
                 "--no-usage-metering", "--max-batch", "8"])
    lines = [json.loads(ln) for ln in capsys.readouterr().out.strip().splitlines()]
    assert lines[0] == {"warmup_buckets": {"t1": [8]}}
    assert lines[1]["tenants"]["t1"]["watched"] is True
    assert served["health"]["status"] == "ok"


# --------------------------------------------------------------------- #
# serve_multitenant bench row


def test_multitenant_bench_row_schema():
    import importlib.util
    import sys

    from dist_svgd_torch.tools import serve_bench

    sys.path.insert(0, os.path.join(ROOT, "tools"))
    spec = importlib.util.spec_from_file_location(
        "jax_serve_bench_mt", os.path.join(ROOT, "tools", "serve_bench.py"))
    jsb = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jsb)
    kw = dict(tenants=3, clients=4, requests=48, rows=(1, 2), max_batch=32, max_wait_ms=0.5)
    row = serve_bench.run_multitenant_bench(device="cpu", **kw)
    want = jsb.run_multitenant_bench(**kw)
    assert set(row) == set(want)
    assert set(row["quota_probe"]) == set(want["quota_probe"])
    assert set(row["eviction_probe"]) == set(want["eviction_probe"])
    assert sorted(row["per_tenant"]) == sorted(want["per_tenant"]) == [
        "bnn-1", "gmm-2", "logreg-0"]
    for name, pt in row["per_tenant"].items():
        assert set(pt) == set(want["per_tenant"][name]) and pt["requests"] == 16
    assert row["metric"] == "serve_multitenant" and row["completed"] == 48
    assert 0 < row["tenant_fairness"] <= 1.0
    assert row["recompiles"] == 0 and row["sentry_compiles"] == 0
    assert row["evictions"] >= 1
    assert row["eviction_probe"]["evictions_after"] > row["eviction_probe"]["evictions_before"]
    assert row["quota_sheds"] >= 1 and row["quota_probe"]["polite_served"] is True
    for key in ("quota_sheds", "evictions"):
        assert row[key] == want[key], key
    assert row["quota_probe"] == want["quota_probe"]
    assert row["p99_worst_tenant_ms"] >= row["p50_ms"]
