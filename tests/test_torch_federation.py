"""The port's ``FederationSupervisor`` (``dist_svgd_torch/resilience/
federation.py``) against JAX's on scripted ``FakeWorker`` generations
(``tests/test_multihost_train.py``'s federation cases), on the CPU.

Both coordinators get the same launcher scripts and the same fake clock;
their launches, reports (transition by transition, restart walls included),
raised errors and ``svgd_elastic_*`` metrics are equal.  Then the
``WorkerLossAt`` fault's process-to-shard mapping and ``SubprocessWorker``
over a real child process."""

import subprocess
import sys
import types

import pytest

from dist_svgd_tpu import resilience as jres
from dist_svgd_tpu import telemetry as jtel

from dist_svgd_torch import resilience as tres
from dist_svgd_torch import telemetry as ttel
from dist_svgd_torch.resilience import (
    FakeWorker,
    FederationDead,
    FederationSupervisor,
    SubprocessWorker,
    TopologyFault,
    WorkerLossAt,
)
from dist_svgd_torch.telemetry import FlightRecorder, MetricsRegistry

from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)


def _fake_clock():
    state = {"t": 0.0}

    def clock():
        state["t"] += 0.01
        return state["t"]

    return clock


#: Launcher scripts: ``script(width, attempt, i) -> poll() results``.
SCRIPTS = {
    "clean": lambda width, attempt, i: [None, 0],
    "kill_one": lambda width, attempt, i: (
        [None, -9 if i == 1 else None, None, 0] if attempt == 0 else [None, 0]),
    "kill_two_then_one": lambda width, attempt, i: (
        [None, None, -9 if i in (0, 3) else None, None, 0] if attempt == 0
        else [None, 1 if i == 0 else None, 0] if attempt == 1 else [None, None, 0]),
    "budget": lambda width, attempt, i: [None, -9 if i == width - 1 else None, None],
    "floor": lambda width, attempt, i: [None, -9 if i else None, None],
    "early_finisher": lambda width, attempt, i: [0] if i == 0 else [None, None, 0],
}
CASES = [("clean", dict(processes=3)),
         ("kill_one", dict(processes=4, restart_budget=1)),
         ("kill_two_then_one", dict(processes=6, restart_budget=2)),
         ("budget", dict(processes=4, restart_budget=1)),
         ("floor", dict(processes=2, min_processes=2, restart_budget=5)),
         ("early_finisher", dict(processes=3))]


def _drive(mod, tel, script, kw):
    launches = []

    def launcher(width, attempt):
        launches.append((width, attempt))
        return [mod.FakeWorker(f"w{i}", script(width, attempt, i)) for i in range(width)]

    reg = tel.MetricsRegistry()
    rec = tel.FlightRecorder(capacity=32, registry=reg)
    sup = mod.FederationSupervisor(launcher, registry=reg, recorder=rec,
                                   clock=_fake_clock(), sleep=lambda s: None, **kw)
    try:
        out = ("ok", sup.run())
    except mod.FederationDead as e:
        out = ("dead", str(e), e.report)
    metrics = {name: reg.dump()["metrics"].get(name) for name in (
        "svgd_elastic_worker_losses_total", "svgd_elastic_federation_restarts_total",
        "svgd_elastic_processes", "svgd_elastic_federation_restart_seconds")}
    records = [{k: v for k, v in e.items() if k != "ts"} for e in rec.events()]
    return launches, out, metrics, records


@pytest.mark.parametrize("name,kw", CASES)
def test_federation_transitions_equal_jax(name, kw):
    """Transition by transition: the launches, the report or the
    FederationDead message and report, the metrics and the flight records
    are JAX's."""
    want = _drive(jres, jtel, SCRIPTS[name], kw)
    got = _drive(tres, ttel, SCRIPTS[name], kw)
    assert got[0] == want[0]
    assert got[1] == want[1]
    assert got[2] == want[2]
    assert got[3] == want[3]


def test_federation_clean_finish_no_restarts():
    launches = []

    def launcher(width, attempt):
        launches.append((width, attempt))
        return [FakeWorker(f"w{i}", [None, 0]) for i in range(width)]

    report = FederationSupervisor(launcher, processes=3, registry=MetricsRegistry(),
                                  clock=_fake_clock(), sleep=lambda s: None).run()
    assert report["status"] == "ok" and report["processes"] == 3
    assert report["restarts"] == 0 and report["transitions"] == []
    assert launches == [(3, 0)]


def test_federation_kill_one_relaunches_at_w_minus_1():
    launches = []

    def launcher(width, attempt):
        launches.append((width, attempt))
        if attempt == 0:
            return [FakeWorker(f"w{i}", [None, -9 if i == 1 else None, None, 0])
                    for i in range(width)]
        return [FakeWorker(f"w{i}", [None, 0]) for i in range(width)]

    reg = MetricsRegistry()
    rec = FlightRecorder(capacity=8, registry=reg)
    report = FederationSupervisor(launcher, processes=4, restart_budget=1, registry=reg,
                                  recorder=rec, clock=_fake_clock(),
                                  sleep=lambda s: None).run()
    assert report["status"] == "ok" and report["processes"] == 3
    assert report["restarts"] == 1 and launches == [(4, 0), (3, 1)]
    (tr,) = report["transitions"]
    assert (tr["from_processes"], tr["to_processes"], tr["lost"]) == (4, 3, {"w1": -9})
    assert tr["restart_wall_s"] is not None and tr["restart_wall_s"] > 0
    assert reg.gauge("svgd_elastic_processes").value() == 3
    assert reg.counter("svgd_elastic_worker_losses_total").value() == 1
    assert reg.counter("svgd_elastic_federation_restarts_total").value() == 1
    assert [e["kind"] for e in rec.events()] == ["federation_transition"]


def test_federation_restart_budget_exhaustion_raises():
    def launcher(width, attempt):
        return [FakeWorker(f"w{i}", [None, -9 if i == width - 1 else None, None])
                for i in range(width)]

    sup = FederationSupervisor(launcher, processes=4, restart_budget=1,
                               registry=MetricsRegistry(), clock=_fake_clock(),
                               sleep=lambda s: None)
    with pytest.raises(FederationDead, match="budget"):
        sup.run()


def test_federation_min_processes_floor_raises():
    def launcher(width, attempt):
        return [FakeWorker(f"w{i}", [None, -9 if i else None, None]) for i in range(width)]

    sup = FederationSupervisor(launcher, processes=2, min_processes=2, restart_budget=5,
                               registry=MetricsRegistry(), clock=_fake_clock(),
                               sleep=lambda s: None)
    with pytest.raises(FederationDead, match="min_processes") as ei:
        sup.run()
    assert ei.value.report["losses"] == {"w1": -9}


def test_federation_launcher_width_mismatch_raises():
    sup = FederationSupervisor(lambda width, attempt: [FakeWorker("only")], processes=3,
                               registry=MetricsRegistry(), clock=_fake_clock(),
                               sleep=lambda s: None)
    with pytest.raises(ValueError, match="returned 1 workers"):
        sup.run()


def test_federation_argument_validation():
    for kw, match in ((dict(processes=0), "processes"),
                      (dict(processes=2, min_processes=3), "min_processes"),
                      (dict(processes=2, restart_budget=-1), "restart_budget")):
        with pytest.raises(ValueError, match=match):
            FederationSupervisor(lambda w, a: [], registry=MetricsRegistry(), **kw)


def test_worker_loss_fault_maps_processes_to_shards():
    fault = WorkerLossAt(5, processes=4, lost=1)
    with pytest.raises(TopologyFault) as ei:
        fault.fire(types.SimpleNamespace(t=5, num_shards=8))
    assert ei.value.surviving == 6 and ei.value.lost_devices == 2
    with pytest.raises(ValueError, match="granule layout"):
        fault.fire(types.SimpleNamespace(t=5, num_shards=6))
    with pytest.raises(ValueError, match="processes"):
        WorkerLossAt(5, processes=1)
    with pytest.raises(ValueError, match="lost"):
        WorkerLossAt(5, processes=4, lost=4)
    jfault = jres.WorkerLossAt(5, processes=4, lost=2)
    with pytest.raises(jres.TopologyFault) as je:
        jfault.fire(types.SimpleNamespace(t=5, num_shards=8))
    with pytest.raises(TopologyFault) as te:
        WorkerLossAt(5, processes=4, lost=2).fire(types.SimpleNamespace(t=5, num_shards=8))
    assert (str(te.value), te.value.surviving, te.value.lost_devices) == \
        (str(je.value), je.value.surviving, je.value.lost_devices)


def test_fake_worker_playback_and_kill():
    w = FakeWorker("w", [None, None, 3])
    assert [w.poll() for _ in range(4)] == [None, None, 3, 3]
    k = FakeWorker("k")
    assert k.poll() is None and k.wait(0.0) is None
    k.kill()
    assert k.killed and k.poll() == -9


def test_subprocess_worker_over_a_real_child():
    p = subprocess.Popen([sys.executable, "-c", "import time; time.sleep(30)"])
    w = SubprocessWorker("child", p)
    try:
        assert w.pid == p.pid and w.poll() is None
        assert w.wait(0.05) is None  # still running: the wait times out
        w.kill()
        assert w.wait(10.0) == -9 and w.poll() == -9
        w.kill()  # a dead worker's kill is a no-op
    finally:
        if p.poll() is None:
            p.kill()
            p.wait()
