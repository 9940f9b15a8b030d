"""Elastic resharding under the port's ``RunSupervisor`` against JAX's
meshless cases (``tests/test_elastic.py``, ``make_dist`` with
``mesh=None``), on the CPU.

A run checkpointed at N shards and resumed at M after an injected topology
fault (shrink to M ∈ {4, 2, 1}, grow 2 → 8) reproduces the never-resharded
run within JAX's ``ATOL`` = 1e-5 (the per-shard φ sums re-associate across
shard counts), with the replicated hyperparameters (step counter, step
size, minibatch stream seed, pairing code) equal and KSD / ESS within
1e-4.  On the same float64 particles the port's elastic runs equal JAX's:
final particles at 1e-10 and every ``reshard_events`` value but the walls.
Then the device-loss divisor and the replicate strategy, back-to-back
faults, same-count duals, no policy, the shared budget, the elastic
telemetry and flight record, the RFF bank across a reshard, a corrupt
manifest, and policy validation."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dist_svgd_tpu as jdt
from dist_svgd_tpu import resilience as jres
from dist_svgd_tpu.models.gmm import gmm_logp as jgmm_logp

import dist_svgd_torch as tdt
from dist_svgd_torch import resilience as tres
from dist_svgd_torch.models.gmm import gmm_logp
from dist_svgd_torch.resilience import (
    DeviceLossAt,
    FaultPlan,
    MeshGrowAt,
    MeshShrinkAt,
    ReshardPolicy,
    RestartBudgetExhausted,
    RetryPolicy,
    RunSupervisor,
    TopologyFault,
)
from dist_svgd_torch.telemetry import MetricsRegistry
from dist_svgd_torch.telemetry.diagnostics import DiagnosticsConfig, PosteriorDiagnostics
from dist_svgd_torch.telemetry.trace import FlightRecorder
from dist_svgd_torch.utils import checkpoint as ck

from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

N = 64
D = 2
#: particle tolerance across shard counts (JAX's: accumulation-order float
#: noise; the replicated hyperparameters are pinned exactly instead)
ATOL = 1e-5
#: the port against JAX in float64 ('torch' against 'xla')
RTOL_JAX, ATOL_JAX = 1e-10, 1e-12
#: reshard_events keys that are walls, not values to compare
WALLS = ("reshard_wall_s", "recovery_wall_s")


def _parts(dtype=np.float32, seed=0):
    return np.random.default_rng(seed).normal(size=(N, D)).astype(dtype)


def make_dist(num_shards, parts=None, **kw):
    kw.setdefault("exchange_particles", True)
    kw.setdefault("exchange_scores", False)
    kw.setdefault("include_wasserstein", False)
    return tdt.DistSampler(num_shards, lambda th, _=None: gmm_logp(th), None,
                           _parts() if parts is None else parts, device="cpu", **kw)


def make_jdist(num_shards, parts, **kw):
    kw.setdefault("exchange_particles", True)
    kw.setdefault("exchange_scores", False)
    kw.setdefault("include_wasserstein", False)
    return jdt.DistSampler(num_shards, lambda th, _: jgmm_logp(th), None, jnp.asarray(parts),
                           mesh=None, phi_impl="xla", **kw)


def factory(num_shards):
    return make_dist(num_shards)


def supervise(sampler, tmp_path, name, steps=12, every=4, seg=2, mod=tres, **kw):
    kw.setdefault("segment_steps", seg)
    kw.setdefault("sleep", lambda s: None)
    return mod.RunSupervisor(sampler, steps, 0.05,
                             checkpoint_dir=os.path.join(str(tmp_path), name),
                             checkpoint_every=every, **kw)


def run_supervised(sampler, tmp_path, name, steps=12, **kw):
    sup = supervise(sampler, tmp_path, name, steps=steps, **kw)
    report = sup.run()
    assert report["status"] == "completed"
    return sup, report


def diag_stats(particles, num_shards):
    diag = PosteriorDiagnostics(
        DiagnosticsConfig(every_steps=1, score_fn=torch.func.grad(gmm_logp),
                          row_chunk=64, max_points=64),
        registry=MetricsRegistry())
    return diag.compute(particles, num_shards=num_shards, step=0)


# --------------------------------------------------------------------------
# reshard equivalence against the never-resharded run


@pytest.mark.parametrize("m", [4, 2, 1])
def test_reshard_equivalence_shrink(tmp_path, m):
    base, rb = run_supervised(make_dist(8), tmp_path, "base")
    sup, r = run_supervised(make_dist(8), tmp_path, f"m{m}",
                            reshard=ReshardPolicy(factory),
                            faults=FaultPlan(MeshShrinkAt(6, m)))
    assert r["num_shards"] == m and r["reshards"] == 1
    ev = r["reshard_events"][0]
    assert ev["from_shards"] == 8 and ev["to_shards"] == m
    assert ev["t_detected"] == 6 and ev["resumed_from"] == 4 and ev["steps_lost"] == 2
    assert ev["reshard_wall_s"] >= 0 and ev["recovery_wall_s"] is not None
    np.testing.assert_allclose(base.particles.numpy(), sup.particles.numpy(), rtol=0,
                               atol=ATOL)
    # replicated hyperparameters: exactly
    assert r["t"] == rb["t"] and sup.step_size == base.step_size
    st_b, st_e = base._harness.state_dict(), sup._harness.state_dict()
    np.testing.assert_array_equal(st_b["rng_batch_seed"], st_e["rng_batch_seed"])
    np.testing.assert_array_equal(st_b["w2_pairing"], st_e["w2_pairing"])
    db, de = diag_stats(base.particles, 8), diag_stats(sup.particles, m)
    assert np.isclose(db["ksd"], de["ksd"], rtol=1e-4)
    assert np.isclose(db["ess"], de["ess"], rtol=1e-4)


def test_reshard_equivalence_grow(tmp_path):
    base, _ = run_supervised(make_dist(2), tmp_path, "gbase")
    sup, r = run_supervised(make_dist(2), tmp_path, "grow", reshard=ReshardPolicy(factory),
                            faults=FaultPlan(MeshGrowAt(6, 8)))
    assert r["num_shards"] == 8 and r["reshards"] == 1
    np.testing.assert_allclose(base.particles.numpy(), sup.particles.numpy(), rtol=0,
                               atol=ATOL)
    db, de = diag_stats(base.particles, 2), diag_stats(sup.particles, 8)
    assert np.isclose(db["ksd"], de["ksd"], rtol=1e-4)
    assert np.isclose(db["ess"], de["ess"], rtol=1e-4)


@pytest.mark.parametrize("start,fault", [
    (8, ("shrink", 4)), (8, ("shrink", 2)), (8, ("shrink", 1)), (2, ("grow", 8)),
    (8, ("loss", 1)), (8, ("loss", 3)),
])
def test_elastic_run_matches_jax(tmp_path, start, fault):
    """The same float64 particles through JAX's and the port's elastic
    supervisors: final particles at 1e-10, and the reports' reshard events
    equal in every value but the walls."""
    parts = _parts(np.float64, seed=5)
    kind, arg = fault

    def plan(mod):
        return mod.FaultPlan({"shrink": lambda: mod.MeshShrinkAt(6, arg),
                              "grow": lambda: mod.MeshGrowAt(6, arg),
                              "loss": lambda: mod.DeviceLossAt(6, lost=arg)}[kind]())

    js, jr = run_supervised(make_jdist(start, parts), tmp_path, "jax", mod=jres,
                            reshard=jres.ReshardPolicy(lambda s: make_jdist(s, parts)),
                            faults=plan(jres))
    ps, pr = run_supervised(make_dist(start, parts, phi_impl="torch"), tmp_path, "port",
                            reshard=ReshardPolicy(lambda s: make_dist(s, parts,
                                                                      phi_impl="torch")),
                            faults=plan(tres))
    assert set(pr) == set(jr)
    for key in ("status", "t", "num_shards", "reshards", "restarts", "checkpoints",
                "segments", "step_size"):
        assert pr[key] == jr[key], key
    assert len(pr["reshard_events"]) == len(jr["reshard_events"]) == 1
    for ours, theirs in zip(pr["reshard_events"], jr["reshard_events"]):
        assert ours.keys() == theirs.keys()
        assert {k: v for k, v in ours.items() if k not in WALLS} == \
            {k: v for k, v in theirs.items() if k not in WALLS}
    np.testing.assert_allclose(ps.particles.numpy(), np.asarray(js.particles),
                               rtol=RTOL_JAX, atol=ATOL_JAX)


def test_reshard_equivalence_with_kernel_approx(tmp_path):
    """An RFF run checkpointed at 8 shards and resumed at 4 after a shrink
    stays the never-resharded run: the bank's seed rides the checkpoint
    through reshard_state, so the resumed φ uses the same feature bank."""
    kw = dict(kernel_approx="rff", phi_impl="torch")
    base, _ = run_supervised(make_dist(8, **kw), tmp_path, "abase")
    sup, r = run_supervised(make_dist(8, **kw), tmp_path, "am4",
                            reshard=ReshardPolicy(lambda s: make_dist(s, **kw)),
                            faults=FaultPlan(MeshShrinkAt(6, 4)))
    assert r["num_shards"] == 4 and r["reshards"] == 1
    np.testing.assert_allclose(base.particles.numpy(), sup.particles.numpy(), rtol=0,
                               atol=ATOL)
    st_b, st_e = base._harness.state_dict(), sup._harness.state_dict()
    np.testing.assert_array_equal(st_b["approx_bank_seed"], st_e["approx_bank_seed"])
    assert int(st_e["approx_method"]) == int(st_b["approx_method"])


def test_reshard_equivalence_corrupt_manifest_fallback(tmp_path):
    base, _ = run_supervised(make_dist(8), tmp_path, "cbase")
    st = ck.load_state(os.path.join(str(tmp_path), "cbase", "step_4"))
    st["topo_particles_per_shard"] = np.asarray([1, 2, 3])  # corrupt
    assert ck.read_manifest(st) is None
    with pytest.warns(UserWarning, match="no readable topology manifest"):
        rs = ck.reshard_state(st, 4)
    ds = make_dist(4)
    ds.load_state_dict(rs)
    for _ in range(4):
        ds.run_steps(2, float(np.asarray(st["sup_step_size"])))
    np.testing.assert_allclose(base.particles.numpy(), ds.particles.numpy(), rtol=0,
                               atol=ATOL)


# --------------------------------------------------------------------------
# the elastic supervisor


def test_device_loss_picks_largest_divisor(tmp_path):
    """Losing 1 of 8 devices leaves 7, which doesn't divide n = 64: the
    default policy lands on 4, keeping every particle sharded."""
    _, r = run_supervised(make_dist(8), tmp_path, "loss", reshard=ReshardPolicy(factory),
                          faults=FaultPlan(DeviceLossAt(6)))
    assert r["num_shards"] == 4 and r["reshard_events"][0]["requested_shards"] == 4


def test_device_loss_surviving_strategy_replicates(tmp_path):
    """The 'surviving' strategy asks for the raw survivor count (7), which
    takes the replicate-and-warn fallback down to 1 shard."""
    with pytest.warns(UserWarning, match="replicating instead of sharding"):
        _, r = run_supervised(
            make_dist(8), tmp_path, "surv",
            reshard=ReshardPolicy(factory, device_loss_strategy="surviving"),
            faults=FaultPlan(DeviceLossAt(6)))
    assert r["num_shards"] == 1 and r["reshard_events"][0]["requested_shards"] == 7


def test_back_to_back_topology_faults_close_superseded_window(tmp_path):
    _, r = run_supervised(make_dist(8), tmp_path, "double", every=4, seg=4,
                          reshard=ReshardPolicy(factory),
                          faults=FaultPlan(MeshShrinkAt(6, 4), MeshShrinkAt(8, 2)))
    assert r["reshards"] == 2 and r["num_shards"] == 2
    first, second = r["reshard_events"]
    assert first["to_shards"] == 4 and second["to_shards"] == 2
    assert first["recovery_wall_s"] is None  # superseded before regaining
    assert second["recovery_wall_s"] is not None
    assert all("_clock0" not in ev for ev in (first, second))


def test_same_count_reshard_keeps_duals():
    ds = make_dist(4, include_wasserstein=True, wasserstein_solver="sinkhorn")
    ds.run_steps(4, 0.05, h=1.0)
    st = ds.state_dict()
    rs = ck.reshard_state(st, 4)
    np.testing.assert_array_equal(np.asarray(rs["w2_g"]), np.asarray(st["w2_g"]))
    assert ck.read_manifest(rs)["n_shards"] == 4


def test_topology_fault_without_policy_propagates(tmp_path):
    sup = supervise(make_dist(8), tmp_path, "nopol", faults=FaultPlan(MeshShrinkAt(6, 4)))
    with pytest.raises(TopologyFault):
        sup.run()


def test_topology_fault_on_a_sampler_propagates(tmp_path):
    """A single-device Sampler has no topology to reshard: the fault
    propagates even with a policy installed."""
    s = tdt.Sampler(D, lambda th: gmm_logp(th), device="cpu")
    sup = RunSupervisor(s, 8, 0.05, n=16, segment_steps=2, sleep=lambda _: None,
                        reshard=ReshardPolicy(factory), faults=FaultPlan(MeshShrinkAt(4, 1)))
    with pytest.raises(TopologyFault):
        sup.run()


def test_reshard_spends_shared_restart_budget(tmp_path):
    sup = supervise(make_dist(8), tmp_path, "budget", reshard=ReshardPolicy(factory),
                    retry=RetryPolicy(max_restarts=0, backoff_base_s=0),
                    faults=FaultPlan(MeshShrinkAt(6, 4)))
    with pytest.raises(RestartBudgetExhausted):
        sup.run()


def test_elastic_telemetry_and_flight_record(tmp_path):
    reg = MetricsRegistry()
    rec = FlightRecorder(capacity=32, registry=reg)
    run_supervised(make_dist(8), tmp_path, "telem", registry=reg, recorder=rec,
                   reshard=ReshardPolicy(factory), faults=FaultPlan(MeshShrinkAt(6, 4)))
    assert reg.counter("svgd_elastic_reshards_total").value(direction="shrink") == 1
    assert reg.counter("svgd_elastic_steps_lost_total").value() == 2
    assert reg.gauge("svgd_elastic_shards").value() == 4
    assert reg.gauge("svgd_elastic_processes").value() == 1
    assert reg.counter("svgd_train_restarts_total").value(kind="topology") == 1
    (tt,) = [e for e in rec.events() if e["kind"] == "topology_transition"]
    assert (tt["t"], tt["from_shards"], tt["to_shards"], tt["steps_lost"]) == (6, 8, 4, 2)
    assert (tt["from_processes"], tt["to_processes"]) == (1, 1)


def test_reshard_policy_validation():
    with pytest.raises(ValueError, match="device_loss_strategy"):
        ReshardPolicy(factory, device_loss_strategy="bogus")
    pol = ReshardPolicy(factory)
    jpol = jres.ReshardPolicy(factory)
    for surviving, n in ((7, 64), (0, 64), (6, 60), (7, 10_000), (5, 7), (3, 1)):
        assert pol.target_for_device_loss(surviving, n) == \
            jpol.target_for_device_loss(surviving, n)
    assert pol.target_for_device_loss(7, 10_000) == 5
    with pytest.raises(TypeError, match="DistSampler"):
        ReshardPolicy(lambda s: tdt.Sampler(D, gmm_logp, device="cpu")).build(2)
    with pytest.raises(ValueError, match="honour"):
        ReshardPolicy(lambda s: make_dist(2)).build(4)
