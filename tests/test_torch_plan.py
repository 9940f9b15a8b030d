"""The port's single-device ``Plan`` (``dist_svgd_torch/parallel/plan.py``)
against JAX's (``dist_svgd_tpu/parallel/plan.py``), case for case with the
single-device cases of ``tests/test_plan.py``, on the CPU: construction,
placement, ``compile`` against JAX's ``Plan(None).compile`` at float64, the
program tracking the profiler reads (``ProgramEntry``) and the capture
sentry, the engine's dtype and donation surfaces, and the multi-lane
``MicroBatcher``.  ``make_plan(n)`` with fewer than n visible devices
degrades to the single-device plan, as JAX's does; where n exist it builds
the mesh (``tests/test_torch_plan_mesh.py`` holds the mesh cases).  (On
the card a program captures one CUDA graph per input shape;
``chip_smoke.py`` holds that path.)"""

import json
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch

from dist_svgd_torch.parallel import plan as tplan
from dist_svgd_torch.parallel.plan import Plan, capture_sentry, make_plan, use_registry
from dist_svgd_torch.serving import MicroBatcher, PredictionServer, PredictiveEngine
from dist_svgd_torch.telemetry import MetricsRegistry

from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)


@pytest.fixture
def rng():
    return np.random.default_rng(11)


def _engine(parts, **kw):
    kw.setdefault("min_bucket", 4)
    kw.setdefault("max_bucket", 8)
    return PredictiveEngine("logreg", parts, device="cpu", **kw)


# --------------------------------------------------------------------- #
# Plan: construction, placement, compile


def test_make_plan_single_device_and_multi_raises(monkeypatch):
    """One device, or more shards than the host has devices (the CPU is
    one): the single-device plan, JAX's ``make_mesh`` → ``None``
    degradation (``tests/test_plan.py::test_make_plan_degrades_gracefully``).
    More shards where that many devices exist build the mesh (the test's
    name is from when they raised)."""
    from dist_svgd_tpu.parallel.plan import Plan as JPlan
    from dist_svgd_tpu.parallel.plan import make_plan as jmake_plan

    assert make_plan(1, device="cpu").num_shards == 1
    assert not make_plan(1, device="cpu").is_sharded
    assert make_plan(device="cpu").num_shards == 1
    assert make_plan(device="cpu").device == torch.device("cpu")
    assert make_plan(device="cpu").describe() == JPlan(None).describe()
    with pytest.raises(ValueError, match="num_shards"):
        make_plan(0, device="cpu")
    assert tplan.visible_devices("cpu") == 1
    for n in (2, 10_000):
        plan = make_plan(n, device="cpu")
        assert plan.num_shards == 1 and not plan.is_sharded
        assert plan.device == torch.device("cpu")
        assert plan.describe() == jmake_plan(10_000).describe()
    monkeypatch.setattr(tplan, "visible_devices", lambda device: 4)
    for n in (2, 4):
        plan = make_plan(n, device="cpu")
        assert plan.is_sharded and plan.num_shards == n
        assert plan.describe() == {"sharded": True, "num_shards": n, "devices": ["cpu"] * n}
    assert make_plan(device="cpu").num_shards == 4
    assert make_plan(5, device="cpu").num_shards == 1


def test_plan_rejects_a_mesh_naming_a10():
    """A mesh on another axis is refused naming the plan's axis (JAX's
    ``test_plan_rejects_foreign_axis``); one on it makes a sharded plan."""
    from dist_svgd_torch.parallel.plan import AXIS, Mesh

    with pytest.raises(ValueError, match=AXIS):
        Plan(Mesh(["cpu"] * 2, ("replicas",)))
    meshed = Plan(Mesh(["cpu"] * 2))
    assert meshed.num_shards == 2 and meshed.is_sharded and meshed.device.type == "cpu"
    plan = Plan(device="cpu")
    assert plan.num_shards == 1 and not plan.is_sharded
    assert "num_shards=1" in repr(plan)


def test_plan_device_defaults_to_the_card():
    if torch.cuda.is_available():
        assert Plan().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            Plan()


def test_shard_ensemble_placement(rng):
    parts = rng.normal(size=(64, 3)).astype(np.float32)
    plan = Plan(device="cpu")
    placed = plan.shard_ensemble(parts)
    assert isinstance(placed, torch.Tensor) and placed.device.type == "cpu"
    np.testing.assert_array_equal(placed.numpy(), parts)
    np.testing.assert_array_equal(plan.shard_ensemble(torch.from_numpy(parts)).numpy(), parts)
    np.testing.assert_array_equal(plan.replicate(parts).numpy(), parts)
    assert plan.replicate(3) == 3


def test_plan_compile_matches_jax(rng):
    """The same closed-over ensemble reduction through both plans' compile
    at float64."""
    import jax.numpy as jnp

    from dist_svgd_tpu.parallel.plan import Plan as JPlan

    parts = rng.normal(size=(32, 4))
    x = rng.normal(size=(6, 4))

    def ours_fn(x):
        p = torch.from_numpy(parts)
        return {"m": torch.mean(x @ p.T, dim=1), "v": torch.var(x @ p.T, dim=1, correction=0)}

    def theirs_fn(x):
        p = jnp.asarray(parts)
        return {"m": jnp.mean(x @ p.T, axis=1), "v": jnp.var(x @ p.T, axis=1)}

    got = Plan(device="cpu").compile(ours_fn)(torch.from_numpy(x))
    want = JPlan(None).compile(theirs_fn)(jnp.asarray(x))
    for k in ("m", "v"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=0, atol=1e-12)
    tuple_out = Plan(device="cpu").compile(lambda a: (a * 2, a + 1))(torch.ones(2))
    assert isinstance(tuple_out, tuple) and float(tuple_out[1][0]) == 2.0
    with pytest.raises(ValueError, match="out_specs"):
        Plan(device="cpu").compile_sharded(ours_fn, in_specs=(None,))


def test_program_entry_tracks_like_jax(rng):
    """Each compiled program registers a ProgramEntry with JAX's label,
    kind, shard count and donation, its call count, the first call's
    shapes and dtypes, and every distinct argument signature."""
    import jax.numpy as jnp

    from dist_svgd_tpu.analysis.registry import use_registry as juse
    from dist_svgd_tpu.parallel.plan import Plan as JPlan

    with use_registry() as reg, juse() as jreg:
        prog = Plan(device="cpu").compile(lambda x: x * 2.0, label="t.double",
                                          donate_argnums=(0,), audit={"pinned_f32": True})
        jprog = JPlan(None).compile(lambda x: x * 2.0, label="t.double", donate_argnums=(0,),
                                    audit={"pinned_f32": True})
        sharded = Plan(device="cpu").compile_sharded(lambda x: x, label="t.step")
        (entry,) = reg.entries(label_prefix="t.double")
        (jentry,) = jreg.entries(label_prefix="t.double")
        for key in ("label", "kind", "num_shards", "donate_argnums", "meta"):
            assert getattr(entry, key) == getattr(jentry, key), key
        assert prog.program_entry is entry and not entry.captured
        for rows in (3, 3, 5):
            prog(torch.ones(rows, 2))
            jprog(jnp.ones((rows, 2)))
        assert entry.calls == jentry.calls == 3
        assert entry.avals == (((3, 2), torch.float32),)
        assert [tuple(a.shape) for a in jentry.avals] == [s[0] for s in entry.avals]
        assert entry.shapes == [(((3, 2), torch.float32),), (((5, 2), torch.float32),)]
        assert reg.entries(captured_only=True) == [entry]
        assert sharded.program_entry.kind == "compile_sharded"
        assert len(reg) == 2
        del sharded
        import gc

        gc.collect()
        assert len(reg) == 1  # a dead program drops out
        reg.clear()
        assert len(reg) == 0
    assert tplan.default_registry() is not reg


def test_capture_sentry_counts_new_shapes_and_kernel_builds(monkeypatch):
    prog = Plan(device="cpu").compile(lambda x: x + 1, label="t.sentry")
    prog(torch.zeros(2, 2))
    with capture_sentry("window") as sentry:
        prog(torch.zeros(2, 2))  # a seen shape: nothing
        prog(torch.zeros(3, 2))  # a new shape: a capture on the card
        prog(torch.zeros(3, 2, dtype=torch.float64))  # a new dtype too
    assert (sentry.captures, sentry.kernel_builds, sentry.compiles) == (2, 0, 2)
    from dist_svgd_torch.ops import _build

    with capture_sentry() as sentry:
        _build._note_build()  # what a real nvcc build records
    assert sentry.compiles == 1 and sentry.supported


def test_capture_counts_only_a_program_that_was_built():
    """A first call that raises records no signature, so its retry is
    counted as the capture it is (on the card the graph is built on the
    retry; on the CPU the eager call stands for it)."""
    calls = []

    def flaky(x):
        calls.append(1)
        if len(calls) == 1:
            raise RuntimeError("first call fails")
        return x + 1

    prog = Plan(device="cpu").compile(flaky, label="t.flaky")
    with capture_sentry() as failed:
        with pytest.raises(RuntimeError, match="first call fails"):
            prog(torch.zeros(2, 2))
    assert failed.captures == 0
    assert prog.program_entry.shapes == [] and prog.program_entry.avals is None
    with capture_sentry() as retried:
        prog(torch.zeros(2, 2))
        prog(torch.zeros(2, 2))
    assert retried.captures == 1
    assert prog.program_entry.shapes == [(((2, 2), torch.float32),)]
    assert prog.program_entry.calls == 3


# --------------------------------------------------------------------- #
# the engine's dtype and donation surfaces


def test_reload_preserves_compute_dtype(rng):
    eng = _engine(rng.normal(size=(32, 5)).astype(np.float32), dtype=torch.bfloat16)
    eng.reload(rng.normal(size=(32, 5)).astype(np.float32))
    assert eng.stats()["dtype"] == "bfloat16" and eng.particles.dtype == torch.bfloat16
    eng.stage_candidate(rng.normal(size=(32, 5)).astype(np.float32))
    assert eng._cand_particles.dtype == torch.bfloat16


def test_donated_dispatch_unchanged_and_repeatable(rng):
    parts = rng.normal(size=(32, 5)).astype(np.float32)
    donated, plain = _engine(parts), _engine(parts, donate=False)
    assert donated.stats()["donate_inputs"] is True
    assert plain.stats()["donate_inputs"] is False
    assert donated._kernel_for(8)[0].program_entry.donate_argnums == (0,)
    assert plain._kernel_for(8)[0].program_entry.donate_argnums == ()
    x = rng.normal(size=(5, 4)).astype(np.float32)
    first = donated.predict(x)
    for _ in range(3):
        np.testing.assert_array_equal(donated.predict(x)["mean"], first["mean"])
    np.testing.assert_array_equal(plain.predict(x)["mean"], first["mean"])


def test_bf16_engine_composes(rng):
    eng = _engine(rng.normal(size=(64, 5)).astype(np.float32), dtype="bfloat16")
    assert eng.particles.dtype == torch.bfloat16
    assert eng._kernel_for(4)[0].program_entry.meta == {"pinned_f32": False}
    out = eng.predict(rng.normal(size=(3, 4)).astype(np.float32))
    assert out["mean"].dtype == np.float32 and out["mean"].shape == (3,)


def test_engine_rejects_non_float_dtype_and_foreign_plans(rng):
    parts = rng.normal(size=(8, 3)).astype(np.float32)
    with pytest.raises(ValueError, match="float dtype"):
        _engine(parts, dtype=torch.int32)
    with pytest.raises(ValueError, match="float dtype"):
        _engine(parts, dtype="int32")
    with pytest.raises(ValueError, match="plan= or mesh="):
        PredictiveEngine("logreg", parts, plan=Plan(device="cpu"), mesh=object())
    with pytest.raises(ValueError, match="differs"):
        PredictiveEngine("logreg", parts, plan=Plan(device="cpu"), device="meta")
    eng = PredictiveEngine("logreg", parts, plan=make_plan(1, device="cpu"))
    assert eng.plan.device.type == "cpu" and eng.device.type == "cpu"


# --------------------------------------------------------------------- #
# multi-lane batcher


def _echo(calls):
    def dispatch(x):
        calls.append(x.shape[0])
        return {"val": x[:, 0].copy()}
    return dispatch


def test_batcher_lanes_drain_shared_queue():
    bat = MicroBatcher(_echo([]), max_batch=4, lanes=3, max_wait_ms=1.0, autostart=False)
    futs = [bat.submit(np.full((2, 1), i, np.float32)) for i in range(6)]
    bat.start()
    for i, f in enumerate(futs):
        np.testing.assert_array_equal(f.result(timeout=10)["val"], [i, i])
    st = bat.stats()
    assert st["lanes"] == 3
    assert sum(st["lane_batches"].values()) == st["batches"]
    assert sum(st["lane_requests"].values()) == st["requests"] == 6
    assert sum(st["lane_rows"].values()) == st["rows"] == 12
    bat.close()


def test_batcher_lane_metrics_labelled():
    reg = MetricsRegistry()
    bat = MicroBatcher(_echo([]), max_batch=8, lanes=2, max_wait_ms=1.0, registry=reg,
                       autostart=False)
    futs = [bat.submit(np.ones((2, 1), np.float32)) for _ in range(4)]
    bat.start()
    for f in futs:
        f.result(timeout=10)
    bat.close()
    total = sum(reg.counter("svgd_serve_lane_batches_total").value(
        batcher=bat.metrics_instance, lane=f"l{i}") for i in range(2))
    assert total == bat.stats()["batches"] > 0
    for i in range(2):
        if reg.gauge("svgd_serve_lane_inflight_rows").has(batcher=bat.metrics_instance,
                                                          lane=f"l{i}"):
            assert reg.gauge("svgd_serve_lane_inflight_rows").value(
                batcher=bat.metrics_instance, lane=f"l{i}") == 0


def test_batcher_validates_lanes():
    with pytest.raises(ValueError, match="lanes"):
        MicroBatcher(lambda x: {}, lanes=0, autostart=False)


def test_batcher_live_retune():
    """``set_lanes`` grows and retires lanes while serving; ``set_max_wait_ms``
    changes the window; both land on their gauges."""
    reg = MetricsRegistry()
    bat = MicroBatcher(_echo([]), max_batch=4, lanes=1, max_wait_ms=1.0, registry=reg)
    assert bat.set_lanes(3) == 1 and bat.lanes == 3
    futs = [bat.submit(np.ones((2, 1), np.float32)) for _ in range(6)]
    for f in futs:
        f.result(timeout=10)
    assert bat.set_lanes(1) == 3
    assert bat.set_max_wait_ms(0.5) == 1.0 and bat.max_wait_ms == 0.5
    assert reg.gauge("svgd_serve_lanes").value(batcher=bat.metrics_instance) == 1
    assert bat.submit(np.ones((1, 1), np.float32)).result(timeout=10)["val"].shape == (1,)
    with pytest.raises(ValueError, match="lanes"):
        bat.set_lanes(0)
    with pytest.raises(ValueError, match="max_wait_ms"):
        bat.set_max_wait_ms(-1)
    assert bat.queued_rows() == 0
    bat.close()


def test_split_requests_across_lanes_resolve_once():
    def slow_echo(x):
        time.sleep(0.002)
        return {"val": x[:, 0].copy()}

    n_req = 24
    bat = MicroBatcher(slow_echo, max_batch=8, lanes=2, max_wait_ms=0.0, autostart=False)
    futs = [bat.submit(np.arange(16, dtype=np.float32)[:, None]) for _ in range(n_req)]
    bat.start()
    for f in futs:
        np.testing.assert_array_equal(f.result(timeout=30)["val"], np.arange(16))
    st = bat.stats()
    assert st["requests"] == n_req and sum(st["lane_requests"].values()) == n_req
    assert all(t.is_alive() for t in bat._threads)
    bat.close()


def test_lanes_over_engine_concurrent_correctness(rng):
    parts = rng.normal(size=(64, 5)).astype(np.float32)
    eng = _engine(parts, max_bucket=16)
    eng.warmup()
    ref = _engine(parts, max_bucket=16)
    bat = MicroBatcher(eng.predict, max_batch=16, lanes=2, max_wait_ms=1.0)
    xs = [rng.normal(size=(1 + i % 5, 4)).astype(np.float32) for i in range(12)]
    errs, outs = [], [[] for _ in xs]

    def fire(x, out):
        try:
            out.append(bat.submit(x).result(timeout=30))
        except Exception as e:  # pragma: no cover - failure surface
            errs.append(e)

    threads = [threading.Thread(target=fire, args=(x, o)) for x, o in zip(xs, outs)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    bat.close()
    assert not errs
    for x, o in zip(xs, outs):
        np.testing.assert_array_equal(o[0]["mean"], ref.predict(x)["mean"])


def test_server_reports_topology(rng):
    parts = rng.normal(size=(64, 5)).astype(np.float32)
    eng, ref = _engine(parts, max_bucket=16), _engine(parts, max_bucket=16)
    x = rng.normal(size=(3, 4)).astype(np.float32)
    with PredictionServer(eng, port=0, lanes=2, max_batch=16, max_wait_ms=1.0) as srv:
        health = json.loads(urllib.request.urlopen(srv.url + "/healthz", timeout=10).read())
        assert health["devices"] == 1 and health["lanes"] == 2
        req = urllib.request.Request(srv.url + "/predict",
                                     json.dumps({"inputs": x.tolist()}).encode(),
                                     {"Content-Type": "application/json"})
        out = json.loads(urllib.request.urlopen(req, timeout=10).read())["outputs"]
        np.testing.assert_allclose(out["mean"], ref.predict(x)["mean"], rtol=1e-7)


def test_serve_bench_lanes_row_and_devices_a10(monkeypatch):
    """The lanes row; ``devices=8`` on the one CPU degrades; where 8
    devices exist (``visible_devices`` patched) it emits JAX's
    ``serve_sharded`` row (``tests/test_plan.py::
    test_serve_bench_sharded_row_schema``)."""
    from dist_svgd_torch.tools import serve_bench

    row = serve_bench.run_bench(model="logreg", n_particles=64, n_features=4, clients=4,
                                requests=30, rows=(1, 4), max_batch=16, max_wait_ms=1.0,
                                lanes=2, device="cpu")
    assert row["metric"] == "serve_throughput" and row["devices"] == 1
    assert row["lanes"] == 2 and row["recompiles"] == row["sentry_compiles"] == 0
    fairness = row["lane_fairness"]
    assert set(fairness["requests"]) == {"l0", "l1"}
    assert sum(fairness["requests"].values()) >= 30
    assert set(fairness["inflight_rows_last"]) == {"l0", "l1"}
    json.dumps(row)
    eight = serve_bench.build_engine(n_particles=64, n_features=4, max_bucket=8, devices=8,
                                     device="cpu")  # degrades: one device on the CPU
    assert eight.plan.num_shards == 1 and eight.device == torch.device("cpu")
    monkeypatch.setattr(tplan, "visible_devices", lambda device: 8)
    row = serve_bench.run_bench(model="logreg", n_particles=64, n_features=4, clients=4,
                                requests=30, rows=(1, 4), max_batch=16, max_wait_ms=1.0,
                                devices=8, lanes=2, device="cpu")
    assert row["metric"] == "serve_sharded"
    assert row["devices"] == 8 and row["lanes"] == 2
    assert row["value"] > 0
    assert row["recompiles"] == 0 and row["sentry_compiles"] == 0
    fairness = row["lane_fairness"]
    assert fairness["lanes"] == 2
    assert set(fairness["requests"]) == {"l0", "l1"}
    assert sum(fairness["requests"].values()) >= 30
    assert set(fairness["inflight_rows_last"]) == {"l0", "l1"}
    json.dumps(row)
