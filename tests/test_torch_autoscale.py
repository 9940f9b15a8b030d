"""The port's autoscale controller (``dist_svgd_torch/serving/autoscale.py``)
against JAX's (``dist_svgd_tpu/serving/autoscale.py``), on the CPU.

Each package's controller runs over its own ``MicroBatcher`` (an echo
dispatch, not started) or ``ModelRegistry`` and its own metrics registry,
as in ``tests/test_autoscale.py:244-257``.  Both are fed the same scripted
latency observations, request and shed counts and queue depth under one
injected clock: their ``step()`` records are equal key for key, action
strings included, step by step, and so is ``status()``.  Then JAX's
controller cases (``tests/test_autoscale.py:261-503``) on the port alone,
the policy's validation, ``/autoscale`` on a live ``PredictionServer`` and
the ``--autoscale*`` flags reaching the policy."""

import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from dist_svgd_tpu import serving as jserving
from dist_svgd_tpu.telemetry import metrics as jmetrics

from dist_svgd_torch import serving as tserving
from dist_svgd_torch.serving import (
    AutoscaleController,
    AutoscalePolicy,
    MicroBatcher,
    ModelRegistry,
    PredictionServer,
    PredictiveEngine,
)
from dist_svgd_torch.telemetry import metrics as _metrics
from dist_svgd_torch.utils.checkpoint import save_state

from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)


@pytest.fixture
def rng():
    return np.random.default_rng(11)


def _echo(x):
    return {"y": np.asarray(x).sum(axis=1, keepdims=True)}


POLICY = dict(lanes_max=4, max_wait_ms_max=16.0, p99_target_ms=50.0, cooldown_s=1.0,
              up_consecutive=1, down_consecutive=3)

#: each package: its serving module, its metrics module, and what its
#: registry's tenants need besides JAX's arguments
PACKAGES = {"jax": (jserving, jmetrics, {}), "port": (tserving, _metrics, {"device": "cpu"})}


class Rig:
    """One package's controller over its own batcher (or registry) and
    metrics registry, on a manual clock; every signal is written by the
    script through the same calls in both packages."""

    def __init__(self, pkg, policy=None, *, registry=False, history=False,
                 max_queue_rows=100):
        serving, metrics, self.tenant_kw = PACKAGES[pkg]
        self.serving = serving
        self.metrics = metrics.MetricsRegistry()
        self.hist = self.metrics.histogram("svgd_serve_request_latency_seconds", "t")
        self.reqs = self.metrics.counter("svgd_serve_requests_total", "t")
        self.shed = self.metrics.counter("svgd_serve_shed_total", "t")
        if history:  # ancient awful history the first step must not judge
            for _ in range(500):
                self.hist.observe(5.0)
            self.shed.inc(100)
        self.registry = None
        if registry:
            self.registry = serving.ModelRegistry(metrics=self.metrics,
                                                  batcher_autostart=False)
            parts = np.random.default_rng(3).normal(size=(16, 5)).astype(np.float32)
            self.registry.add_tenant("a", "logreg", particles=parts, quota_rows=10,
                                     **self.tenant_kw)
            self.registry.add_tenant("b", "logreg", particles=parts.copy(),
                                     **self.tenant_kw)
            self.batcher = self.registry.batcher
        else:
            self.batcher = serving.MicroBatcher(
                _echo, max_batch=8, max_wait_ms=2.0, max_queue_rows=max_queue_rows,
                registry=self.metrics, autostart=False)
        self.clock = [0.0]
        self.controller = serving.AutoscaleController(
            self.batcher, metrics=self.metrics, model_registry=self.registry,
            policy=serving.AutoscalePolicy(**(POLICY if policy is None else policy)),
            clock=lambda: self.clock[0])

    def observe(self, lat_s, n):
        for _ in range(n):
            self.hist.observe(lat_s)

    def close(self):
        if self.registry is not None:
            self.registry.close(drain=False)
        else:
            self.batcher.close(drain=False)


def _run(script, **rig_kw):
    """The script on both packages: ``(records, status)`` each."""
    out = {}
    for pkg in PACKAGES:
        rig = Rig(pkg, **rig_kw)
        try:
            records = script(rig)
            out[pkg] = (records, rig.controller.status())
        finally:
            rig.close()
    return out["port"], out["jax"]


def _burn_ramp(rig):
    """Quiet, then a sustained burn: one notch a cooldown to the bounds,
    and a same-instant repeat that the cooldown holds."""
    recs = []
    rig.observe(0.005, 50)
    recs.append(rig.controller.step())
    rig.observe(0.300, 50)
    recs.append(rig.controller.step())  # same instant as the first: cooldown
    for _ in range(12):
        rig.clock[0] += 1.1
        rig.observe(0.300, 50)
        recs.append(rig.controller.step())
        rig.observe(0.300, 50)
        recs.append(rig.controller.step())  # again within the cooldown
    return recs


def _hysteresis(rig):
    """Up to 2 lanes, calm windows, a boundary window that resets the down
    streak, then calm to the construction baseline and no further."""
    recs = []
    rig.reqs.inc(500)
    rig.observe(0.300, 50)
    rig.clock[0] += 1.1
    recs.append(rig.controller.step())
    for _ in range(2):
        rig.clock[0] += 1.1
        rig.reqs.inc(10)
        rig.observe(0.004, 5)
        recs.append(rig.controller.step())
    rig.clock[0] += 1.1
    rig.reqs.inc(450)
    rig.observe(0.004, 295)
    rig.observe(0.020, 4)
    rig.observe(0.060, 2)
    recs.append(rig.controller.step())
    for _ in range(3):
        rig.clock[0] += 1.1
        rig.reqs.inc(10)
        rig.observe(0.004, 5)
        recs.append(rig.controller.step())
    for _ in range(5):
        rig.clock[0] += 1.1
        rig.observe(0.004, 5)
        recs.append(rig.controller.step())
    return recs


def _demand_guard(rig):
    """A burst served well holds the wide window until demand falls; the
    decay then releases it."""
    recs = []
    for _ in range(2):
        rig.clock[0] += 1.1
        rig.reqs.inc(500)
        rig.observe(0.300, 50)
        recs.append(rig.controller.step())
    for _ in range(6):
        rig.clock[0] += 1.1
        rig.reqs.inc(500)
        rig.observe(0.004, 50)
        recs.append(rig.controller.step())
    for _ in range(10):
        rig.clock[0] += 1.1
        rig.reqs.inc(50)
        rig.observe(0.004, 5)
        recs.append(rig.controller.step())
    return recs


def _shed_then_window_floor(rig):
    """A shed reads as overload; a p99 within the widened window's floor
    reads as the controller's own latency, not as burn overload."""
    recs = []
    rig.shed.inc(3)
    recs.append(rig.controller.step())
    for _ in range(3):
        rig.clock[0] += 1.1
        rig.reqs.inc(100)
        rig.observe(0.040, 50)  # under a 50 ms objective, over a 10 ms one
        recs.append(rig.controller.step())
    rig.batcher.set_max_wait_ms(16.0)
    rig.clock[0] += 1.1
    rig.observe(0.020, 50)
    recs.append(rig.controller.step())
    return recs


def _queue_depth(rig):
    """Queued rows past queue_high_frac of the bound read as overload
    before any latency arrives; a near-empty queue never does."""
    recs = []
    rig.batcher.submit(np.zeros((10, 3), np.float32))
    recs.append(rig.controller.step())
    rig.batcher.submit(np.zeros((20, 3), np.float32))
    rig.clock[0] += 1.1
    recs.append(rig.controller.step())
    rig.clock[0] += 0.5
    recs.append(rig.controller.step())
    return recs


def _quota_retune(rig):
    """Overload tightens the quota'd tenant and flips admission; calm
    restores both; a tenant removed while tightened is forgotten."""
    recs = []
    rig.observe(0.300, 50)
    rig.clock[0] += 1.0
    recs.append(rig.controller.step())
    recs.append((rig.registry.tenant("a").quota_rows, rig.registry.tenant("b").quota_rows,
                 rig.batcher.quota_mode, rig.controller.quota_scale))
    for _ in range(6):
        rig.clock[0] += 1.0
        rig.observe(0.002, 3)
        recs.append(rig.controller.step())
    recs.append((rig.registry.tenant("a").quota_rows, rig.batcher.quota_mode,
                 rig.controller.quota_scale))
    rig.registry.set_quota("b", 40)
    rig.clock[0] += 1.0
    rig.observe(0.300, 50)
    recs.append(rig.controller.step())
    recs.append(rig.registry.quota_snapshot())
    rig.registry.remove_tenant("a")
    for _ in range(6):
        rig.clock[0] += 1.0
        rig.observe(0.002, 3)
        recs.append(rig.controller.step())
    recs.append((rig.registry.quota_snapshot(), sorted(rig.controller._base_quotas)))
    return recs


def _primed(rig):
    recs = [rig.controller.step()]
    rig.clock[0] += 1.1
    rig.observe(0.005, 10)
    recs.append(rig.controller.step())
    return recs


@pytest.mark.parametrize("script,rig_kw", [
    (_burn_ramp, {}),
    (_hysteresis, {}),
    (_demand_guard, {}),
    (_shed_then_window_floor, {}),
    (_shed_then_window_floor, {"policy": dict(lanes_max=4, max_wait_ms_max=16.0,
                                              p99_target_ms=10.0, cooldown_s=1.0)}),
    (_queue_depth, {}),
    (_quota_retune, {"registry": True,
                     "policy": dict(p99_target_ms=50.0, cooldown_s=0.0, down_consecutive=2,
                                    quota_tighten_frac=0.5)}),
    (_primed, {"history": True}),
], ids=["burn_ramp", "hysteresis", "demand_guard", "shed_floor", "shed_floor_10ms",
        "queue_depth", "quota_retune", "primed"])
def test_decisions_equal_jax(script, rig_kw):
    """The same scripted signals give JAX's decision records, step by
    step, and JAX's status document."""
    (ours, our_status), (theirs, their_status) = _run(script, **rig_kw)
    assert len(ours) == len(theirs)
    for i, (a, b) in enumerate(zip(ours, theirs)):
        assert a == b, (i, a, b)
    assert our_status == their_status
    records = [r for r in ours if isinstance(r, dict)]
    assert any(r["actions"] for r in records) or script is _primed


def test_policy_defaults_and_validation_equal_jax():
    assert vars(AutoscalePolicy()) == vars(jserving.AutoscalePolicy())
    for bad in (dict(lanes_max=0), dict(lanes_min=5), dict(lanes_min=0),
                dict(max_wait_ms_max=-1.0), dict(burn_down=2.0), dict(burn_down=-0.1),
                dict(up_consecutive=0), dict(down_consecutive=0),
                dict(quota_tighten_frac=0.0), dict(quota_tighten_frac=1.5),
                dict(floor_slack_ms=-1.0), dict(demand_release_frac=0.0),
                dict(demand_release_frac=1.2)):
        with pytest.raises(ValueError) as ours:
            AutoscalePolicy(**bad)
        with pytest.raises(ValueError) as theirs:
            jserving.AutoscalePolicy(**bad)
        assert str(ours.value) == str(theirs.value), bad


def test_metric_names_equal_jax():
    names = {}
    for pkg in PACKAGES:
        rig = Rig(pkg)
        try:
            rig.observe(0.300, 50)
            rig.controller.step()
            names[pkg] = {k: v for k, v in rig.metrics.dump()["metrics"].items()
                          if k.startswith("svgd_autoscale")}
        finally:
            rig.close()
    assert set(names["port"]) == {"svgd_autoscale_actions_total", "svgd_autoscale_overload",
                                  "svgd_autoscale_quota_scale"}
    assert names["port"] == names["jax"]


# --------------------------------------------------------------------- #
# JAX's controller cases on the port (tests/test_autoscale.py:261-503)


def _make_controller(policy=None, **kw):
    reg = _metrics.MetricsRegistry()
    bat = MicroBatcher(_echo, max_batch=8, max_wait_ms=2.0,
                       max_queue_rows=100, registry=reg, autostart=False)
    clock = [0.0]
    c = AutoscaleController(
        bat, metrics=reg,
        policy=policy or AutoscalePolicy(**POLICY),
        clock=lambda: clock[0], **kw)
    hist = reg.histogram("svgd_serve_request_latency_seconds", "t")
    return c, bat, hist, clock


def _finish(*batchers):
    for b in batchers:
        b.start()
        b.close(drain=True)


def test_scale_up_on_burn_then_bounded():
    c, bat, hist, clock = _make_controller()
    for _ in range(50):
        hist.observe(0.005)
    r = c.step()
    assert not r["overload"] and r["actions"] == []
    for _ in range(12):
        clock[0] += 1.1
        for _ in range(50):
            hist.observe(0.300)
        c.step()
    assert bat.lanes == 4 and bat.max_wait_ms == 16.0  # bounded, no runaway
    st = c.status()
    assert st["bounds"] == {"lanes": [1, 4], "max_wait_ms": [2.0, 16.0]}
    assert st["actions"] >= 2
    _finish(bat)


def test_cooldown_blocks_immediate_repeat():
    c, bat, hist, clock = _make_controller()
    for _ in range(50):
        hist.observe(0.300)
    r = c.step()
    assert r["overload"] and any("lanes" in a for a in r["actions"])
    for _ in range(50):
        hist.observe(0.300)
    r = c.step()  # same instant: cooldown holds
    assert r["overload"] and r["actions"] == []
    _finish(bat)


def test_hysteresis_no_flap_and_baseline_floor():
    c, bat, hist, clock = _make_controller()
    reqs = c.metrics.counter("svgd_serve_requests_total", "t")
    reqs.inc(500)
    for _ in range(50):
        hist.observe(0.300)
    clock[0] += 1.1
    c.step()
    assert bat.lanes == 2
    for _ in range(2):
        clock[0] += 1.1
        reqs.inc(10)
        for _ in range(5):
            hist.observe(0.004)
        r = c.step()
        assert r["calm"]
        assert r["actions"] == []  # streak not yet at down_consecutive
    # a boundary window: burn between the thresholds and the p99 past the
    # window floor — neither overload nor calm
    clock[0] += 1.1
    reqs.inc(450)
    for _ in range(295):
        hist.observe(0.004)
    for _ in range(4):
        hist.observe(0.020)
    for _ in range(2):
        hist.observe(0.060)
    r = c.step()
    assert not r["overload"] and not r["calm"], r
    assert r["actions"] == []
    for _ in range(2):  # the reset: two calm windows still do not act
        clock[0] += 1.1
        reqs.inc(10)
        for _ in range(5):
            hist.observe(0.004)
        r = c.step()
        assert r["actions"] == [], r
    clock[0] += 1.1
    reqs.inc(10)
    for _ in range(5):
        hist.observe(0.004)
    r = c.step()
    assert any("lanes 2->1" in a for a in r["actions"])
    assert bat.lanes == 1
    for _ in range(5):  # at the baseline: never below
        clock[0] += 1.1
        for _ in range(5):
            hist.observe(0.004)
        c.step()
    assert bat.lanes == 1 and bat.max_wait_ms == 2.0
    _finish(bat)


def test_demand_guard_holds_wide_window_while_burst_serves_well():
    c, bat, hist, clock = _make_controller()
    reqs = c.metrics.counter("svgd_serve_requests_total", "t")
    for _ in range(2):
        clock[0] += 1.1
        reqs.inc(500)
        for _ in range(50):
            hist.observe(0.300)
        c.step()
    assert bat.max_wait_ms > 2.0
    wide = bat.max_wait_ms
    for _ in range(6):  # the burst served well: NOT calm — the guard holds
        clock[0] += 1.1
        reqs.inc(500)
        for _ in range(50):
            hist.observe(0.004)
        r = c.step()
        assert not r["calm"], r
    assert bat.max_wait_ms == wide
    for _ in range(10):  # demand falls: released
        clock[0] += 1.1
        reqs.inc(50)
        for _ in range(5):
            hist.observe(0.004)
        c.step()
    assert bat.max_wait_ms < wide
    _finish(bat)


def test_shed_signal_is_overload_and_window_floor_is_not():
    c, bat, hist, clock = _make_controller()
    shed = c.metrics.counter("svgd_serve_shed_total", "t")
    shed.inc(3)
    r = c.step()
    assert r["overload"] and r["shed_delta"] == 3.0
    c2, bat2, hist2, clock2 = _make_controller(
        policy=AutoscalePolicy(lanes_max=4, max_wait_ms_max=16.0,
                               p99_target_ms=10.0, cooldown_s=1.0))
    bat2.set_max_wait_ms(16.0)
    for _ in range(50):
        hist2.observe(0.020)  # every observation over the 10 ms target
    r = c2.step()
    assert r["burn"] > 1.0
    assert not r["overload"] and r["window_floor_ok"]
    _finish(bat, bat2)


def test_quota_retune_tightens_and_restores(rng):
    metrics = _metrics.MetricsRegistry()
    reg = ModelRegistry(metrics=metrics, batcher_autostart=False)
    parts = rng.normal(size=(16, 5)).astype(np.float32)
    reg.add_tenant("a", "logreg", particles=parts, quota_rows=10, device="cpu")
    reg.add_tenant("b", "logreg", particles=parts.copy(), device="cpu")  # no quota
    clock = [0.0]
    c = AutoscaleController(
        reg.batcher, metrics=metrics, model_registry=reg,
        policy=AutoscalePolicy(p99_target_ms=50.0, cooldown_s=0.0,
                               down_consecutive=2, quota_tighten_frac=0.5),
        clock=lambda: clock[0])
    hist = metrics.histogram("svgd_serve_request_latency_seconds", "t")
    for _ in range(50):
        hist.observe(0.300)
    clock[0] += 1.0
    c.step()
    assert reg.tenant("a").quota_rows == 5
    assert reg.tenant("b").quota_rows is None
    assert reg.batcher.quota_mode == "admission"
    assert c.quota_scale == 0.5
    assert metrics.gauge("svgd_autoscale_quota_scale").value() == 0.5
    for _ in range(6):
        clock[0] += 1.0
        for _ in range(3):
            hist.observe(0.002)
        c.step()
    assert reg.tenant("a").quota_rows == 10
    assert reg.batcher.quota_mode == "overflow"
    assert c.quota_scale == 1.0
    reg.close(drain=False)


def test_controller_primes_windows_on_existing_registry():
    reg = _metrics.MetricsRegistry()
    h = reg.histogram("svgd_serve_request_latency_seconds", "t")
    shed = reg.counter("svgd_serve_shed_total", "t")
    for _ in range(500):
        h.observe(5.0)
    shed.inc(100)
    bat = MicroBatcher(_echo, max_batch=8, max_wait_ms=2.0,
                       max_queue_rows=64, registry=reg, autostart=False)
    c = AutoscaleController(bat, metrics=reg, clock=lambda: 0.0)
    r = c.step()
    assert not r["overload"]
    assert r["shed_delta"] == 0.0 and r["window_count"] == 0
    _finish(bat)


def test_loop_survives_a_failing_step_and_stops():
    """A control bug must not kill serving: the background loop keeps
    running past a raising step (JAX's loop), and stop() joins it."""
    c, bat, hist, clock = _make_controller()
    calls = [0]

    def broken(now=None):
        calls[0] += 1
        raise RuntimeError("control bug")

    c.step = broken
    with pytest.raises(ValueError):
        c.start(0)
    with c.start(0.01):
        deadline = time.monotonic() + 5
        while calls[0] < 3 and time.monotonic() < deadline:
            time.sleep(0.005)
        assert c._thread.is_alive()
    assert calls[0] >= 3 and c._thread is None
    _finish(bat)


def test_status_and_server_route(rng):
    """/autoscale serves the controller's status; 404 without one; the
    server's lifecycle starts and stops the control thread."""
    parts = rng.normal(size=(16, 5)).astype(np.float32)
    eng = PredictiveEngine("logreg", parts, min_bucket=4, max_bucket=16, device="cpu")
    srv = PredictionServer(eng, port=0, max_wait_ms=1.0).start()
    try:
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(srv.url + "/autoscale", timeout=10)
        assert ei.value.code == 404
    finally:
        srv.shutdown()

    eng2 = PredictiveEngine("logreg", parts.copy(), min_bucket=4, max_bucket=16,
                            device="cpu")
    srv2 = PredictionServer(eng2, port=0, max_wait_ms=1.0, slo_p99_ms=40.0,
                            autoscale=True).start()
    try:
        assert srv2.autoscale._thread is not None  # started with serve
        assert srv2.autoscale.policy.p99_target_ms == 40.0
        body = json.dumps({"inputs": parts[:3, 1:].tolist()}).encode()
        req = urllib.request.Request(srv2.url + "/predict", body,
                                     {"Content-Type": "application/json"})
        assert urllib.request.urlopen(req, timeout=10).status == 200
        deadline = time.monotonic() + 10
        while srv2.autoscale.status()["steps"] < 1 and time.monotonic() < deadline:
            time.sleep(0.02)
        doc = json.loads(urllib.request.urlopen(srv2.url + "/autoscale", timeout=10).read())
        assert doc["lanes"] == 1
        assert doc["bounds"] == {"lanes": [1, 4], "max_wait_ms": [1.0, 16.0]}
        assert doc["steps"] >= 1 and "last_signals" in doc
    finally:
        srv2.shutdown()
    assert srv2.autoscale._thread is None  # stopped on shutdown


def test_autoscale_flags_reach_the_policy(tmp_path, rng, monkeypatch):
    """``--autoscale`` and its four settings build and start the controller
    over the server's batcher; without the flag there is none."""
    from dist_svgd_torch.serving import server

    parts = rng.normal(size=(16, 5)).astype(np.float32)
    save_state(str(tmp_path / "c"), {"particles": parts, "t": 3})
    seen = []
    serve_forever = server.PredictionServer.serve_forever

    def serve_once(self):
        seen.append((self, self.autoscale, self.autoscale and self.autoscale._thread))
        # ask the serve loop to stop, then run it: it drains on the way out
        threading.Thread(target=self._httpd.shutdown, daemon=True).start()
        serve_forever(self)

    monkeypatch.setattr(server.PredictionServer, "serve_forever", serve_once)
    base = ["--checkpoint", str(tmp_path / "c"), "--device", "cpu", "--port", "0",
            "--max-batch", "16", "--no-warmup", "--no-usage-metering"]
    server.main(base + ["--autoscale", "--autoscale-lanes-max", "3",
                        "--autoscale-wait-max-ms", "8", "--autoscale-p99-ms", "60",
                        "--autoscale-interval-s", "0.5"])
    server.main(base)
    (srv, ctl, thread), (_, none, _) = seen
    assert none is None
    assert isinstance(ctl, AutoscaleController) and ctl.batcher is srv.batcher
    p = ctl.policy
    assert (p.lanes_max, p.max_wait_ms_max, p.p99_target_ms) == (3, 8.0, 60.0)
    assert thread is not None and ctl.interval_s == 0.5
    assert ctl._thread is None  # stopped with the server


def test_concurrent_load_steps_and_records():
    """A live controller over a started batcher under concurrent submits:
    it steps on its cadence and logs its overload records."""
    reg = _metrics.MetricsRegistry()
    bat = MicroBatcher(lambda x: (time.sleep(0.002), _echo(x))[1], max_batch=8,
                       max_wait_ms=1.0, max_queue_rows=64, registry=reg)
    c = AutoscaleController(bat, metrics=reg, policy=AutoscalePolicy(
        p99_target_ms=1.0, cooldown_s=0.0, lanes_max=2, max_wait_ms_max=4.0))
    stop = [False]

    def pound():
        while not stop[0]:
            try:
                bat.submit(np.ones((4, 3), np.float32)).result(timeout=10)
            except tserving.Overloaded:
                pass

    threads = [threading.Thread(target=pound) for _ in range(6)]
    with c.start(0.02):
        for t in threads:
            t.start()
        deadline = time.monotonic() + 10
        while c.status()["steps"] < 10 and time.monotonic() < deadline:
            time.sleep(0.02)
        stop[0] = True
        for t in threads:
            t.join(timeout=10)
    st = c.status()
    bat.close(drain=True)
    assert st["steps"] >= 10
    assert st["actions"] >= 1 and st["recent"]
    assert 1 <= st["lanes"] <= 2
