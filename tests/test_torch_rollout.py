"""The port's progressive delivery (``dist_svgd_torch/rollout/``, the
registry's and the hot reloader's rollout seams, and
``tools/rollout_drill.py``) against JAX's, case for case with
``tests/test_rollout.py``, on the CPU.

The plan refuses what JAX's refuses, with JAX's messages; the crc32 split
sends every key where JAX's sends it; divergences agree within 1e-6; under
one manual clock and the same observations, each package's controller over
its own engine writes the same decisions, decision log and ``status()``.
Rollback reads no checkpoint and leaves the incumbent bitwise; the registry
arms and disarms the batcher's hook as JAX's does; the hot reloader offers
a newer step instead of swapping it; live traffic through the batcher
splits on JAX's hash and labels the candidate's series.  The rollout drill
runs at shrunk durations: its row carries JAX's keys and passes every gate
but the timing one, and ``row_ok`` gives JAX's verdicts on synthetic rows."""

import importlib.util
import os
import sys
import time
from types import SimpleNamespace

import numpy as np
import pytest

from dist_svgd_torch.resilience import BadGenerationAt
from dist_svgd_torch.rollout import (
    DIVERGENCE_BUCKETS,
    RolloutController,
    RolloutPlan,
    prediction_divergence,
)
from dist_svgd_torch.rollout.controller import _hash_unit
from dist_svgd_torch.serving import ModelRegistry, PredictiveEngine
from dist_svgd_torch.serving.engine import CheckpointHotReloader
from dist_svgd_torch.telemetry import MetricsRegistry
from dist_svgd_torch.utils.checkpoint import CheckpointManager

from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: float32 predictions of the two engines agree within this, relative.
F32_RTOL = 1e-6


class ManualClock:
    def __init__(self, t=0.0):
        self.t = float(t)

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


def _port():
    return SimpleNamespace(
        Controller=RolloutController, Plan=RolloutPlan, Registry=MetricsRegistry,
        Engine=lambda *a, **kw: PredictiveEngine(*a, device="cpu", **kw),
        Manager=CheckpointManager, Reloader=CheckpointHotReloader,
        BadGenerationAt=BadGenerationAt)


def _jax():
    from dist_svgd_tpu.resilience import BadGenerationAt as JBad
    from dist_svgd_tpu.rollout import RolloutController as JController
    from dist_svgd_tpu.rollout import RolloutPlan as JPlan
    from dist_svgd_tpu.serving import PredictiveEngine as JEngine
    from dist_svgd_tpu.serving.engine import CheckpointHotReloader as JReloader
    from dist_svgd_tpu.telemetry import MetricsRegistry as JRegistry
    from dist_svgd_tpu.utils.checkpoint import CheckpointManager as JManager

    return SimpleNamespace(Controller=JController, Plan=JPlan, Registry=JRegistry,
                           Engine=JEngine, Manager=JManager, Reloader=JReloader,
                           BadGenerationAt=JBad)


PKGS = {"port": _port, "jax": _jax}


def _engine(pkg, parts):
    eng = pkg.Engine("logreg", parts, min_bucket=4, max_bucket=4,
                     registry=pkg.Registry())
    eng.warmup()
    return eng


def _controller(pkg, eng, clock, **plan_kw):
    plan_kw.setdefault("shadow_fraction", 0.5)
    plan_kw.setdefault("shadow_min_mirrors", 2)
    plan_kw.setdefault("shadow_hold_s", 1.0)
    plan_kw.setdefault("canary_stages", (0.5, 1.0))
    plan_kw.setdefault("stage_hold_s", 1.0)
    plan_kw.setdefault("stage_min_requests", 1)
    return pkg.Controller(eng, plan=pkg.Plan(**plan_kw), clock=clock)


def _observe_divergence(reg, value, times=1):
    h = reg.histogram("svgd_rollout_divergence")
    for _ in range(times):
        h.observe(value)


def _observe_candidate_latency(reg, seconds, times=1):
    h = reg.histogram("svgd_serve_request_latency_seconds")
    for _ in range(times):
        h.observe(seconds, generation="candidate")


def _both(scenario, parts, **kw):
    """Run ``scenario(pkg, eng, ro, clock) -> decisions`` on each package's
    controller over its own engine; returns ``{name: (decisions, log,
    status, engine)}``."""
    out = {}
    for name, make in PKGS.items():
        pkg = make()
        eng = _engine(pkg, parts)
        clock = ManualClock()
        ro = _controller(pkg, eng, clock, **kw)
        try:
            decisions = scenario(pkg, eng, ro, clock)
            out[name] = (decisions, list(ro.log), ro.status(), eng)
        finally:
            ro.close()
    return out


def _assert_same_controller(runs):
    (d1, log1, st1, _), (d2, log2, st2, _) = runs["port"], runs["jax"]
    assert d1 == d2
    assert log1 == log2
    assert st1 == st2


def _parts(seed=21, n=16, k=4):
    return np.random.default_rng(seed).normal(size=(n, 1 + k)).astype(np.float32)


# --------------------------------------------------------------------- #
# plan validation, hash split, divergence


@pytest.mark.parametrize("kw", [
    {"shadow_fraction": 0.0}, {"shadow_fraction": 1.5}, {"shadow_min_mirrors": 0},
    {"shadow_hold_s": -1.0}, {"canary_stages": ()}, {"canary_stages": (0.0, 1.0)},
    {"canary_stages": (0.5, 0.5, 1.0)}, {"canary_stages": (0.1, 0.5)},
    {"stage_hold_s": -1.0}, {"stage_min_requests": 0}, {"max_divergence": 0.0},
    {"divergence_budget": 1.0}, {"p99_ms": 0.0}, {"error_budget": 1.0},
    {"breach_streak": 0}, {"mirror_inflight_limit": 0}, {"on_active": "explode"},
])
def test_plan_validates(kw):
    """Each bad plan raises JAX's ValueError with JAX's message; the
    default and a custom plan describe themselves as JAX's do."""
    jplan = _jax().Plan
    with pytest.raises(ValueError) as ours:
        RolloutPlan(**kw)
    with pytest.raises(ValueError) as theirs:
        jplan(**kw)
    assert str(ours.value) == str(theirs.value)
    assert RolloutPlan().describe() == jplan().describe()
    assert RolloutPlan().describe()["canary_stages"] == [0.01, 0.10, 0.50, 1.0]
    custom = dict(canary_stages=[0.2, 1], seed=9, on_active="defer", p99_ms=7)
    assert RolloutPlan(**custom).describe() == jplan(**custom).describe()


def test_hash_split_deterministic_and_monotone():
    """The crc32 split equals JAX's on 10,000 keys (ints and strings) for
    ``assign`` and ``should_mirror`` at every stage fraction; it is stable,
    roughly uniform, salted apart, and nested as stages widen."""
    from dist_svgd_tpu.rollout.controller import _hash_unit as j_hash_unit

    keys = list(range(10_000))
    units = [_hash_unit(7, "split", k) for k in keys]
    assert units == [j_hash_unit(7, "split", k) for k in keys]
    assert [_hash_unit(0x5F6D, "mirror", f"req-{k}") for k in keys[:2000]] == [
        j_hash_unit(0x5F6D, "mirror", f"req-{k}") for k in keys[:2000]]
    assert all(0.0 <= u < 1.0 for u in units)
    assert 0.08 < sum(u < 0.1 for u in units) / len(units) < 0.12
    mirrors = [_hash_unit(7, "mirror", k) for k in keys]
    assert mirrors != units
    for f_lo, f_hi in ((0.01, 0.10), (0.10, 0.50), (0.50, 1.0)):
        lo = {k for k, u in enumerate(units) if u < f_lo}
        hi = {k for k, u in enumerate(units) if u < f_hi}
        assert lo <= hi
    # the controllers' own seams, driven through a shadow and a canary stage
    parts = _parts()
    runs = {}
    for name, make in PKGS.items():
        pkg = make()
        eng = _engine(pkg, parts)
        clock = ManualClock()
        ro = _controller(pkg, eng, clock, shadow_fraction=0.3, canary_stages=(0.05, 1.0),
                         shadow_min_mirrors=1, shadow_hold_s=0.0, seed=7)
        seen = [[ro.assign(k) for k in keys[:10]]]
        ro.offer(parts + np.float32(1e-3))
        seen.append([ro.should_mirror(k) for k in keys])
        _observe_divergence(eng.registry, 1e-4)
        clock.advance(0.1)
        assert ro.step()["action"] == "advance"
        seen.append([ro.assign(k) for k in keys])
        runs[name] = seen
        ro.close()
    assert runs["port"] == runs["jax"]
    assert 0.04 < runs["port"][2].count("candidate") / len(keys) < 0.06


def test_prediction_divergence():
    """Mean |Δ| over the shared fields, within 1e-6 of JAX's on random
    dicts; NaN for no shared keys or a NaN prediction, as JAX's."""
    from dist_svgd_tpu.rollout import DIVERGENCE_BUCKETS as J_BUCKETS
    from dist_svgd_tpu.rollout import prediction_divergence as jdiv

    assert DIVERGENCE_BUCKETS == J_BUCKETS
    rng = np.random.default_rng(3)
    for _ in range(20):
        a = {"mean": rng.uniform(size=7).astype(np.float32),
             "var": rng.uniform(0, 0.1, size=7).astype(np.float32),
             "only_a": rng.normal(size=3)}
        b = {"mean": rng.uniform(size=7).astype(np.float32),
             "var": rng.uniform(0, 0.1, size=7).astype(np.float32)}
        assert abs(prediction_divergence(a, b) - jdiv(a, b)) <= 1e-6
    a = {"mean": np.array([0.5, 0.5]), "var": np.array([0.1, 0.1])}
    b = {"mean": np.array([0.5, 0.7]), "var": np.array([0.1, 0.1])}
    assert prediction_divergence(a, a) == 0.0
    assert prediction_divergence(a, b) == pytest.approx(0.05)
    assert np.isnan(prediction_divergence({"x": np.ones(2)}, {"y": np.ones(2)}))
    bad = {"mean": np.array([np.nan, 0.5]), "var": np.array([0.1, 0.1])}
    assert np.isnan(prediction_divergence(bad, a)) and np.isnan(jdiv(bad, a))


# --------------------------------------------------------------------- #
# the controller state machine (manual clock, metrics-driven windows)


def test_controller_promotes_through_stages():
    """shadow → 0.5 → 1.0 → promote on both packages: the same decisions,
    log and status; the watermark stamped on both series at promotion; the
    promoted ensemble serves JAX's predictions."""
    parts = _parts()
    cand = parts + np.float32(1e-3)

    def scenario(pkg, eng, ro, clock):
        reg = eng.registry
        out = [ro.offer(cand, tag="good", watermark=123.0), ro.state, ro.active]
        clock.advance(1.5)
        out.append(ro.step())  # held but starved: no mirrors yet
        _observe_divergence(reg, 1e-4, times=3)
        clock.advance(0.1)
        out.append(ro.step())
        _observe_candidate_latency(reg, 0.002, times=2)
        clock.advance(1.1)
        out.append(ro.step())
        _observe_candidate_latency(reg, 0.002, times=2)
        clock.advance(1.1)
        out.append(ro.step())
        g = reg.gauge("svgd_serving_watermark")
        st = eng.stats()
        out += [g.value(), g.value(generation="2"), st["generation_id"],
                st["previous_generation_id"], st["candidate_generation_id"], ro.active]
        return out

    runs = _both(scenario, parts)
    _assert_same_controller(runs)
    d = runs["port"][0]
    assert [x["action"] for x in d[3:7]] == ["hold", "advance", "advance", "promote"]
    assert d[4]["fraction"] == 0.5 and d[5]["fraction"] == 1.0
    assert d[6]["watermark"] == 123.0
    assert d[6]["promote_s"] == pytest.approx(3.8, abs=0.2)
    assert d[7:] == [123.0, 123.0, 2, 1, None, False]
    x = np.random.default_rng(1).normal(size=(3, 4)).astype(np.float32)
    ours, theirs = runs["port"][3].predict(x), runs["jax"][3].predict(x)
    for k in theirs:
        np.testing.assert_allclose(ours[k], theirs[k], rtol=F32_RTOL, atol=1e-7)
    ref = PredictiveEngine("logreg", cand, min_bucket=4, max_bucket=4,
                           registry=MetricsRegistry(), device="cpu")
    np.testing.assert_array_equal(runs["port"][3].predict(x)["mean"], ref.predict(x)["mean"])


def test_controller_rolls_back_on_divergence_without_checkpoint_io():
    """A breaching candidate is dropped in O(1) on both packages with the
    same log: the resident incumbent keeps serving bitwise and
    ``engine.reload`` (the checkpoint-consuming seam) is never called."""
    parts = _parts()
    x = np.random.default_rng(2).normal(size=(3, 4)).astype(np.float32)

    def scenario(pkg, eng, ro, clock):
        before = {k: np.array(v, copy=True) for k, v in eng.predict(x).items()}
        reloads = []
        orig = eng.reload
        eng.reload = lambda *a, **k: (reloads.append(1), orig(*a, **k))[1]
        assert ro.offer(parts * np.float32(1e6), tag="bad")
        _observe_divergence(eng.registry, 0.9, times=3)
        clock.advance(0.1)
        d = ro.step()
        after = eng.predict(x)
        del eng.reload
        st = eng.stats()
        assert not reloads
        for k in before:
            np.testing.assert_array_equal(before[k], after[k])
        return [d, ro.active, st["generation_id"], st["candidate_generation_id"]]

    runs = _both(scenario, parts, max_divergence=0.05, breach_streak=1)
    _assert_same_controller(runs)
    d, active, gen, cand_gen = runs["port"][0]
    assert d["action"] == "rollback" and d["objectives"] == ["shadow_divergence"]
    assert d["at_stage"] == "shadow"
    assert (active, gen, cand_gen) == (False, 1, None)
    assert runs["port"][2]["rollbacks"] == 1


def test_controller_breach_streak_rides_out_one_bad_window():
    parts = _parts()

    def scenario(pkg, eng, ro, clock):
        ro.offer(parts + np.float32(1e-3))
        _observe_divergence(eng.registry, 0.9)
        clock.advance(0.1)
        out = [ro.step(), ro.active]  # streak 1 of 2: no rollback
        _observe_divergence(eng.registry, 1e-4, times=2)  # window recovers
        clock.advance(1.0)
        out.append(ro.step())  # streak reset by green
        return out

    runs = _both(scenario, parts, max_divergence=0.05, breach_streak=2)
    _assert_same_controller(runs)
    d = runs["port"][0]
    assert d[0]["action"] == "breach" and d[1] and d[2]["action"] == "advance"


@pytest.mark.parametrize("on_active", ["supersede", "defer"])
def test_offer_supersede_and_defer(on_active):
    parts = _parts()

    def scenario(pkg, eng, ro, clock):
        out = [ro.offer(parts + np.float32(1e-3), tag="first"),
               eng.stats()["candidate_generation_id"]]
        clock.advance(0.5)
        out += [ro.offer(parts + np.float32(2e-3), tag="second"),
                eng.stats()["candidate_generation_id"]]
        return out

    runs = _both(scenario, parts, on_active=on_active)
    _assert_same_controller(runs)
    first, gen1, second, gen2 = runs["port"][0]
    st = runs["port"][2]
    assert first
    if on_active == "supersede":
        assert second and gen2 != gen1 and st["supersedes"] == 1 and st["tag"] == "second"
    else:
        assert not second and gen2 == gen1 and st["tag"] == "first"


def test_engine_rollback_is_a_pair_exchange():
    """The previous generation stays resident; rollback is a swap on both
    packages (a second rollback recovers the newer generation), with JAX's
    generation ids and predictions."""
    parts = _parts()
    new = parts + np.float32(0.5)
    x = np.random.default_rng(4).normal(size=(2, 4)).astype(np.float32)
    seqs = {}
    for name, make in PKGS.items():
        eng = _engine(make(), parts)
        eng.reload(new, tag="gen2")
        seq = [(eng.stats()["generation_id"], eng.stats()["previous_generation_id"])]
        out_gen2 = {k: np.array(v, copy=True) for k, v in eng.predict(x).items()}
        seq.append(eng.rollback()["generation_id"])
        seq.append(eng.stats()["previous_generation_id"])
        seq.append(eng.rollback()["generation_id"])
        after = eng.predict(x)
        for k in out_gen2:
            np.testing.assert_array_equal(out_gen2[k], after[k])
        seqs[name] = (seq, out_gen2)
    assert seqs["port"][0] == seqs["jax"][0] == [(2, 1), 1, 2, 2]
    for k in seqs["jax"][1]:
        np.testing.assert_allclose(seqs["port"][1][k], seqs["jax"][1][k],
                                   rtol=F32_RTOL, atol=1e-7)


# --------------------------------------------------------------------- #
# batcher split/mirror seam + registry lifecycle


def _wait(pred, timeout_s=10.0):
    deadline = time.monotonic() + timeout_s
    while not pred():
        if time.monotonic() > deadline:
            return False
        time.sleep(0.01)
    return True


def test_batcher_split_mirror_and_generation_labels():
    """Live traffic through the port's registry: mirrors flow off the
    client path and are never client requests; the canary split sends
    exactly the submit ordinals JAX's hash sends to the candidate, on the
    candidate's own label set; promotion serves the candidate ensemble."""
    from dist_svgd_tpu.rollout.controller import _hash_unit as j_hash_unit

    rng = np.random.default_rng(21)
    metrics = MetricsRegistry()
    reg = ModelRegistry(metrics=metrics, max_batch=4, max_wait_ms=0.5)
    parts = rng.normal(size=(16, 5)).astype(np.float32)
    reg.add_tenant("prod", "logreg", particles=parts, min_bucket=4, max_bucket=4,
                   device="cpu")
    reg.warm()
    clock = ManualClock()
    plan = RolloutPlan(shadow_fraction=0.9, shadow_min_mirrors=1, shadow_hold_s=0.0,
                       canary_stages=(0.5, 1.0), stage_hold_s=0.0, stage_min_requests=1,
                       max_divergence=1.0, p99_ms=1e5)
    ro = reg.begin_rollout("prod", controller=RolloutController(
        reg.tenant("prod").engine, metrics=metrics, clock=clock, plan=plan))
    cand = parts + np.float32(1e-3)
    assert ro.offer(cand, tag="good")
    x = rng.normal(size=(4, 4)).astype(np.float32)
    n_client = 0
    for _ in range(12):
        reg.submit("prod", x).result(timeout=10)
        n_client += 1
    m_mirrors = metrics.counter("svgd_rollout_mirrors_total")
    assert _wait(lambda: m_mirrors.value(tenant="prod") >= 1)
    req_counter = metrics.counter("svgd_serve_requests_total")
    assert req_counter.value(tenant="prod") == n_client
    assert req_counter.value(tenant="prod", generation="candidate") == 0
    clock.advance(0.1)
    assert ro.step()["action"] == "advance"  # canary 0.5
    for _ in range(24):
        reg.submit("prod", x).result(timeout=10)
        n_client += 1
    cand_served = req_counter.value(tenant="prod", generation="candidate")
    # ordinals 12..35 were split at 0.5: JAX's hash picks the same ones
    want = sum(j_hash_unit(plan.seed, "split", k) < 0.5 for k in range(12, 36))
    assert cand_served == want > 0
    assert req_counter.value(tenant="prod") + cand_served == n_client
    clock.advance(0.1)
    assert ro.step()["action"] == "advance"  # canary 1.0
    reg.submit("prod", x).result(timeout=10)
    assert _wait(lambda: req_counter.value(
        tenant="prod", generation="candidate") > cand_served)
    clock.advance(0.1)
    assert ro.step()["action"] == "promote"
    ref = PredictiveEngine("logreg", cand, min_bucket=4, max_bucket=4,
                           registry=MetricsRegistry(), device="cpu")
    np.testing.assert_array_equal(reg.submit("prod", x).result(timeout=10)["mean"],
                                  ref.predict(x)["mean"])
    reg.end_rollout("prod")
    reg.close()


def test_registry_rollout_lifecycle():
    """Arm, re-arm, refuse a second tenant, disarm, and disarm on tenant
    removal — each step's observable state equal to JAX's registry's."""
    from dist_svgd_tpu.serving import ModelRegistry as JRegistry

    def lifecycle(Registry, kw):
        rng = np.random.default_rng(21)
        reg = Registry(max_wait_ms=0.5)
        for name in ("a", "b"):
            reg.add_tenant(name, "logreg", particles=rng.normal(size=(8, 5)).astype(
                np.float32), min_bucket=4, max_bucket=4, **kw)
        out = []
        ro = reg.begin_rollout("a")
        out.append(reg.begin_rollout("a") is ro)  # idempotent for the same tenant
        with pytest.raises(RuntimeError, match="already armed") as err:
            reg.begin_rollout("b")
        out.append(str(err.value))
        out.append({k: v for k, v in reg.rollout_status().items() if k != "plan"})
        eng = reg.tenant("a").engine
        ro.offer(np.asarray(eng.particles) + np.float32(1e-3))
        out.append(eng.stats()["candidate_generation_id"])
        reg.end_rollout("a")  # disarm drops the in-flight candidate
        out += [eng.stats()["candidate_generation_id"], reg.rollout_status(),
                reg.batcher.rollout]
        ro2 = reg.begin_rollout("b")
        out.append(reg.rollout_status()["tenant"])
        reg.remove_tenant("b")  # removing the rollout tenant disarms too
        out += [reg.rollout_status(), reg.batcher.rollout, ro2.active]
        reg.close()
        return out

    ours = lifecycle(ModelRegistry, {"device": "cpu"})
    theirs = lifecycle(JRegistry, {})
    assert ours == theirs
    assert ours[0] and ours[2]["tenant"] == "a" and ours[3] is not None
    assert ours[4:7] == [None, None, None] and ours[7] == "b"
    assert ours[8:] == [None, None, False]


def test_tenant_summary_and_stats_carry_generation_identity():
    from dist_svgd_tpu.serving import ModelRegistry as JRegistry

    rows = []
    for Registry, kw in ((ModelRegistry, {"device": "cpu"}), (JRegistry, {})):
        rng = np.random.default_rng(21)
        reg = Registry(metrics=None, max_wait_ms=0.5)
        reg.add_tenant("prod", "logreg", particles=rng.normal(size=(8, 5)).astype(
            np.float32), min_bucket=4, max_bucket=4, **kw)
        keys = ("generation_id", "previous_generation_id", "candidate_generation_id")
        row = [reg.tenant("prod").summary()[k] for k in keys]
        reg.tenant("prod").engine.reload(
            rng.normal(size=(8, 5)).astype(np.float32), tag="gen2")
        row += [reg.tenant("prod").summary()[k] for k in keys]
        rows.append(row)
        reg.close()
    assert rows[0] == rows[1] == [1, None, None, 2, 1, None]


# --------------------------------------------------------------------- #
# hot-reloader offer path


def test_reloader_offers_candidate_instead_of_swapping(tmp_path):
    """A newer step is offered, not swapped: the serving generation stays,
    the step is marked seen, the watermark waits for promotion — and the
    walk to promotion logs what JAX's logs."""
    parts = _parts()
    new = parts + np.float32(0.25)

    def scenario(pkg, eng, ro, clock):
        root = str(tmp_path / f"ckpt_{pkg.Controller.__module__}")
        mgr = pkg.Manager(root, every=1, backend="npz")
        mgr.save(2, {"particles": new, "stream_watermark": np.float64(777.0)})
        reloader = pkg.Reloader(eng, root, rollout=ro, baseline_step=1)
        out = [reloader.poll_once()]
        st = eng.stats()
        out += [st["generation_id"], st["candidate_generation_id"], reloader.loaded_step,
                eng.registry.gauge("svgd_serving_watermark").has(), reloader.poll_once()]
        _observe_divergence(eng.registry, 1e-4, times=3)
        clock.advance(1.1)
        out.append(ro.step())
        _observe_candidate_latency(eng.registry, 0.001)
        clock.advance(1.1)
        out.append(ro.step())
        _observe_candidate_latency(eng.registry, 0.001)
        clock.advance(1.1)
        out.append(ro.step())
        out.append(eng.registry.gauge("svgd_serving_watermark").value())
        return out

    runs = _both(scenario, parts)
    _assert_same_controller(runs)
    d = runs["port"][0]
    assert d[:6] == [2, 1, 2, 2, False, None]
    assert [x["action"] for x in d[6:9]] == ["advance", "advance", "promote"]
    assert d[8]["watermark"] == 777.0 and d[9] == 777.0
    assert runs["port"][2]["recent"][0]["tag"] == "step_2"


# --------------------------------------------------------------------- #
# BadGenerationAt


@pytest.mark.parametrize("args,kw,frag", [
    ((0,), {"kind": "melt"}, "kind"), ((5,), {"until": 5}, "until"),
    ((0,), {"kind": "saturate", "magnitude": 1.0}, "magnitude"), ((-1,), {}, "step"),
])
def test_bad_generation_at_validates(args, kw, frag):
    jbad = _jax().BadGenerationAt
    with pytest.raises(ValueError, match=frag) as ours:
        BadGenerationAt(*args, **kw)
    with pytest.raises(ValueError) as theirs:
        jbad(*args, **kw)
    assert str(ours.value) == str(theirs.value)


def test_bad_generation_at_window_and_purity():
    jbad = _jax().BadGenerationAt
    fault = BadGenerationAt(2, kind="saturate", magnitude=1e6, until=4)
    jfault = jbad(2, kind="saturate", magnitude=1e6, until=4)
    assert [fault.active(i) for i in range(6)] == [jfault.active(i) for i in range(6)] == [
        False, False, True, True, False, False]
    parts = np.random.default_rng(21).normal(size=(8, 5)).astype(np.float32)
    ref = parts.copy()
    out1, out2 = fault.apply(parts), fault.apply(parts)
    np.testing.assert_array_equal(parts, ref)  # pure: input untouched
    np.testing.assert_array_equal(out1, out2)  # deterministic
    np.testing.assert_array_equal(out1, np.asarray(jfault.apply(parts)))
    assert np.all(np.isfinite(out1))
    np.testing.assert_allclose(out1, parts * 1e6, rtol=1e-6)
    scr = BadGenerationAt(0, kind="scramble").apply(parts)
    np.testing.assert_array_equal(scr, np.asarray(jbad(0, kind="scramble").apply(parts)))
    np.testing.assert_array_equal(scr, -parts[:, ::-1])


# --------------------------------------------------------------------- #
# the rollout drill

#: A CPU run at shrunk durations: the good candidate walks every stage
#: inside its trace at this rate.
DRILL_KW = dict(n_particles=64, dim=4, rows=8, base_rps=400.0, duration_s=0.4,
                good_duration_s=2.0, bad_duration_s=0.3, overhead_pairs=2,
                control_interval_s=0.05)


def _jax_drill():
    tools = os.path.join(ROOT, "tools")
    if tools not in sys.path:
        sys.path.insert(0, tools)
    spec = importlib.util.spec_from_file_location(
        "jax_rollout_drill", os.path.join(tools, "rollout_drill.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def drill_row():
    from dist_svgd_torch.tools import rollout_drill

    return rollout_drill.run_drill(device="cpu", **DRILL_KW)


@pytest.fixture(scope="module")
def jax_drill_row():
    return _jax_drill().run_drill(**DRILL_KW)


def test_rollout_drill_row_and_gates_at_shrunk_durations(drill_row):
    """At shrunk durations on the CPU the port's row passes every gate but
    the shadow-overhead one, a timing that only the card's run decides."""
    from dist_svgd_torch.tools import rollout_drill

    row = drill_row
    assert row["metric"] == "canary_rollout" and row["platform"] == "cpu"
    ok, why = rollout_drill.row_ok(row)
    assert all("shadow mirroring" in w for w in why), why
    assert row["mirror_us_per_request"] > 0.0 and row["requests_per_s"] == DRILL_KW["base_rps"]
    assert row["mirror_us_per_request_busy"] > 0.0
    assert row["mirror_dispatch_frac"] == pytest.approx(
        row["mirror_us_per_request"] * 1e-6 * row["requests_per_s"], rel=1e-3, abs=1e-6)
    assert row["good"]["promoted"] and row["good"]["stages"] == [0.02, 0.10, 0.50, 1.0]
    assert row["bad"]["rolled_back"] and row["bad"]["checkpoint_reloads"] == 0
    assert row["bad"]["incumbent_bitwise"] and row["bad"]["peak_fraction"] <= 0.10
    assert row["steady_state_recompiles"] == 0 and row["sentry_supported"]
    client = row["client"]
    assert client["offered"] == client["completed"] > 0
    assert row["mirror_errors"] == 0 and row["shadow_mirrors"] > 0


def test_rollout_drill_row_keys_equal_jax(drill_row, jax_drill_row):
    """The port's row has JAX's keys plus its own four (the shadow-overhead
    gate's three and the busy thread's hand-off cost), and the good / bad /
    client / plan documents JAX's, at the same arguments."""
    from dist_svgd_torch.tools import rollout_drill

    row, want = drill_row, jax_drill_row
    assert set(row) == set(want) | set(rollout_drill.PORT_OVERHEAD_KEYS)
    for key in ("good", "bad", "client", "plan"):
        assert set(row[key]) == set(want[key]), key
    assert row["plan"] == want["plan"]
    for key in ("metric", "unit", "platform", "n", "dim", "rows", "base_rps",
                "duration_s", "good_duration_s", "bad_duration_s", "shadow_overhead_max"):
        assert row[key] == want[key], key
    assert row["bad"]["max_exposure"] == want["bad"]["max_exposure"]


def test_rollout_drill_row_ok_verdicts_equal_jax():
    from dist_svgd_torch.tools import rollout_drill

    jdrill = _jax_drill()
    good = {"good": {"promoted": True, "stages": [0.02, 0.1, 0.5, 1.0]},
            "bad": {"rolled_back": True, "peak_fraction": 0.0, "max_exposure": 0.1,
                    "checkpoint_reloads": 0, "incumbent_bitwise": True,
                    "serving_generation_unchanged": True},
            "client": {"lost": 0, "errors": 0}, "steady_state_recompiles": 0,
            "shadow_overhead_frac": 0.01, "shadow_overhead_max": 0.05}
    bads = [
        {"good": {"promoted": False, "stages": [0.02]}},
        {"client": {"lost": 2, "errors": 0}}, {"client": {"lost": 0, "errors": 1}},
        {"steady_state_recompiles": 3},
        {"bad": {**good["bad"], "rolled_back": False}},
        {"bad": {**good["bad"], "peak_fraction": 0.5}},
        {"bad": {**good["bad"], "checkpoint_reloads": 1}},
        {"bad": {**good["bad"], "incumbent_bitwise": False}},
        {"bad": {**good["bad"], "serving_generation_unchanged": False}},
        {"shadow_overhead_frac": 0.05}, {"shadow_overhead_frac": None},
        {"shadow_overhead_frac": 0.2, "steady_state_recompiles": 1},
    ]
    for change in [{}] + bads:
        row = {**good, **change}
        ok, why = rollout_drill.row_ok(row)
        jok, jwhy = jdrill.row_ok(row)
        assert ok == jok and len(why) == len(jwhy), change
    assert rollout_drill.row_ok(good) == (True, [])
    # the port's gate: the direct mirror share decides where the row has it
    noisy = {**good, "shadow_overhead_frac": 0.2}
    assert rollout_drill.row_ok({**noisy, "mirror_dispatch_frac": 0.001}) == (True, [])
    ok, why = rollout_drill.row_ok({**good, "mirror_dispatch_frac": 0.06})
    assert not ok and len(why) == 1 and "client path" in why[0]
