"""The trace core of the port's workload replay
(``dist_svgd_torch/tools/workload_replay.py``) against JAX's
``tools/workload_replay.py``, case for case with
``tests/test_workload_replay.py:35-143``, on the CPU.

The same config draws the same trace in both packages, event for event
(arrival times, sizes, tenants, pool picks); the replayer classifies the
same futures the same way; the window aggregates equal JAX's on the same
records; ``serve_bench.request_pool_by_size`` builds JAX's arrays.  The
``serve_storm`` half raises naming ROADMAP A9."""

import importlib.util
import os
import sys
from concurrent.futures import Future

import numpy as np
import pytest

from dist_svgd_torch.serving.batcher import Overloaded
from dist_svgd_torch.tools import serve_bench
from dist_svgd_torch.tools import workload_replay as wr

from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_tool(name):
    tools = os.path.join(ROOT, "tools")
    if tools not in sys.path:
        sys.path.insert(0, tools)
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", os.path.join(tools, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jwr():
    return _jax_tool("workload_replay")


CFG = dict(duration_s=5.0, base_rps=120.0, seed=3, bursts=((2.0, 1.0, 2.5),),
           tenants=("a", "b", "c"), flash_crowds=((2.0, 1.0, 2, 0.7),))


def _events(mod, **kw):
    return mod.generate_trace(mod.TraceConfig(**{**CFG, **kw}))


def _same(ours, theirs):
    return len(ours) == len(theirs) and all(
        (a.t, a.rows, a.tenant, a.pick) == (b.t, b.rows, b.tenant, b.pick)
        for a, b in zip(ours, theirs))


# --------------------------------------------------------------------- #
# trace model


@pytest.mark.parametrize("kw", [{}, {"seed": 4}, {"arrival": "regular"},
                                {"duration_s": 6.0, "base_rps": 200.0},
                                {"tenants": (), "flash_crowds": (), "diurnal_amp": 0.0}])
def test_trace_determinism_and_seed_sensitivity(jwr, kw):
    """Same config ⇒ the same trace as JAX's, event for event, and as
    itself on a second draw; a different seed ⇒ a different trace."""
    ours = _events(wr, **kw)
    assert _same(ours, _events(jwr, **kw))
    assert _same(ours, _events(wr, **kw))
    other = _events(wr, **{**kw, "seed": kw.get("seed", 3) + 10})
    assert not _same(ours, other)
    assert wr.TraceConfig(**{**CFG, **kw}).to_dict() == jwr.TraceConfig(
        **{**CFG, **kw}).to_dict()


def test_trace_shape_burst_flash_and_heavy_tail():
    events = _events(wr, duration_s=6.0, base_rps=200.0)
    pre = sum(1 for e in events if e.t < 2.0) / 2.0
    burst = sum(1 for e in events if 2.0 <= e.t < 3.0)
    assert burst > 1.6 * pre  # the 2.5x burst window is denser
    crowd = [e.tenant for e in events if 2.0 <= e.t < 3.0]
    assert crowd.count("c") / len(crowd) > 0.5  # flash mass shifted to c
    outside = [e.tenant for e in events if e.t < 2.0]
    assert outside.count("a") > outside.count("c")  # zipf rank order
    sizes = [e.rows for e in events]
    assert sizes.count(1) > sizes.count(32)  # power-law tail


def test_trace_regular_arrivals_and_rate_envelope(jwr):
    kw = dict(CFG, arrival="regular", tenants=(), flash_crowds=(), diurnal_amp=0.0)
    cfg, jcfg = wr.TraceConfig(**kw), jwr.TraceConfig(**kw)
    events = wr.generate_trace(cfg)
    assert abs(sum(1 for e in events if e.t < 2.0) - 240) <= 2
    for t in np.linspace(0.0, 5.0, 41):
        assert cfg.rate_at(t) == jcfg.rate_at(t)
    assert cfg.rate_at(2.5) == pytest.approx(300.0)
    assert cfg.rate_at(4.0) == pytest.approx(120.0)
    assert cfg.peak_rate() == jcfg.peak_rate() == pytest.approx(300.0)
    diurnal = dict(CFG, diurnal_amp=0.4, diurnal_period_s=2.0)
    assert [wr.TraceConfig(**diurnal).rate_at(t) for t in (0.3, 1.7, 2.4)] == [
        jwr.TraceConfig(**diurnal).rate_at(t) for t in (0.3, 1.7, 2.4)]


@pytest.mark.parametrize("kw", [
    {"duration_s": 0}, {"base_rps": -1.0}, {"arrival": "bursty"}, {"diurnal_amp": 1.0},
    {"rows_sizes": ()}, {"bursts": ((0.0, -1.0, 2.0),)},
    {"flash_crowds": ((0.0, 1.0, 0, 0.5),)},  # no tenants
    {"tenants": ("a",), "flash_crowds": ((0.0, 1.0, 3, 0.5),)},  # bad index
])
def test_trace_config_validation(jwr, kw):
    """The port refuses what JAX refuses, with JAX's message."""
    with pytest.raises(ValueError) as ours:
        wr.TraceConfig(**kw)
    with pytest.raises(ValueError) as theirs:
        jwr.TraceConfig(**kw)
    assert str(ours.value) == str(theirs.value)


# --------------------------------------------------------------------- #
# replay mechanics


def test_replay_classifies_ok_shed_error_lost(jwr):
    """Each package's replayer over its own ``Overloaded``: ok, shed,
    error and lost land where JAX's land."""
    from dist_svgd_tpu.serving.batcher import Overloaded as JOverloaded

    def statuses(mod, overloaded):
        events = [mod.ReplayEvent(0.001 * i, 1, None, i) for i in range(4)]

        def submit(ev):
            fut = Future()
            if ev.pick == 0:
                fut.set_result({"y": np.zeros((1, 1))})
            elif ev.pick == 1:
                raise overloaded("full")
            elif ev.pick == 2:
                fut.set_exception(RuntimeError("boom"))
            return fut  # pick == 3: never resolves -> lost

        return mod.replay(events, submit, drain_timeout_s=0.2)

    records = statuses(wr, Overloaded)
    theirs = statuses(jwr, JOverloaded)
    assert [r["status"] for r in records] == [r["status"] for r in theirs] == [
        "ok", "shed", "error", "lost"]
    assert records[0]["lat_ms"] >= 0.0
    assert records[1]["lat_ms"] is None
    assert records[2]["error"] == theirs[2]["error"] and "boom" in records[2]["error"]


def test_window_metrics_and_breach_and_recover(jwr):
    records = [
        {"t": 0.2, "rows": 1, "tenant": None, "status": "ok", "lat_ms": 5.0},
        {"t": 0.7, "rows": 1, "tenant": None, "status": "ok", "lat_ms": 8.0},
        {"t": 1.2, "rows": 1, "tenant": None, "status": "ok", "lat_ms": 90.0},
        {"t": 1.5, "rows": 2, "tenant": None, "status": "shed", "lat_ms": None},
        {"t": 2.5, "rows": 1, "tenant": None, "status": "shed", "lat_ms": None},
        {"t": 3.4, "rows": 1, "tenant": None, "status": "ok", "lat_ms": 6.0},
        {"t": 0.5, "rows": 1, "tenant": None, "status": "mirror", "lat_ms": 1.0},
    ]
    rng = np.random.default_rng(12)
    noisy = [{"t": float(t), "rows": 1, "tenant": None,
              "status": str(rng.choice(["ok", "ok", "ok", "shed", "error", "lost"])),
              "lat_ms": float(rng.exponential(20.0))} for t in rng.uniform(0, 6, 200)]
    for recs in (records, noisy):
        for t0, t1 in ((0.0, 4.0), (1.0, 3.0), (0.0, 6.0)):
            assert wr.window_metrics(recs, t0, t1, 25.0) == jwr.window_metrics(
                recs, t0, t1, 25.0)
        assert wr.p99_breach_seconds(recs, 25.0, 6.0) == jwr.p99_breach_seconds(
            recs, 25.0, 6.0)
        assert wr.time_to_recover(recs, 1.0, 25.0, 6.0) == jwr.time_to_recover(
            recs, 1.0, 25.0, 6.0)
    m = wr.window_metrics(records, 0.0, 4.0, good_ms=25.0)
    assert m["offered"] == 6 and m["completed"] == 4 and m["mirrors"] == 1
    assert m["good"] == 3 and m["shed"] == 2
    assert m["goodput_rps"] == pytest.approx(0.8)
    assert wr.p99_breach_seconds(records, 25.0, 4.0) == 2
    assert wr.time_to_recover(records, 1.0, 25.0, 4.0) == pytest.approx(2.0)
    bad = [dict(r, lat_ms=500.0) for r in records if r["status"] == "ok"]
    assert wr.time_to_recover(bad, 1.0, 25.0, 4.0) == pytest.approx(3.0)


# --------------------------------------------------------------------- #
# the request pools, and what stays unported


def test_request_pool_by_size_equals_jax():
    jsb = _jax_tool("serve_bench")
    ours = serve_bench.request_pool_by_size(5, (4, 1, 4, 16), per_size=3, seed=7)
    theirs = jsb.request_pool_by_size(5, (4, 1, 4, 16), per_size=3, seed=7)
    assert list(ours) == list(theirs) == [1, 4, 16]
    for r in ours:
        for a, b in zip(ours[r], theirs[r]):
            np.testing.assert_array_equal(a, b)
            assert a.dtype == np.float32 and a.shape == (r, 5)


@pytest.mark.parametrize("name,args", [
    ("run_storm", ()), ("storm_ok", ({},)), ("default_lanes_max", ()),
    ("build_fake_fleet", ()), ("make_router_submit", (None,)), ("main", ([],)),
])
def test_storm_half_raises_naming_a9(name, args):
    with pytest.raises(NotImplementedError, match="ROADMAP A9"):
        getattr(wr, name)(*args)
