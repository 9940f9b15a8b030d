"""The port's resilience package (``dist_svgd_torch/resilience/``) against
JAX's (``tests/test_resilience.py``), on the CPU.

Every case of JAX's file is held here on the port: supervised segmented
runs, preempt and resume (both sampler kinds, the port's own resumes
compared with ``torch.equal``), the ``step_offset`` stream and the frozen
median kernel, the host-LP W2 resume, retry with capped backoff and the
restart budget, NaN rollback with step-size backoff, the displacement
guard, the hard kill, the corrupt-newest fallback, the slow-segment
watchdog, the logged events, the stale root, argument validation, the fault
plan and the shared backoff (jitter value for value with JAX's under the
same seeded ``random.Random``).  Then the port against JAX on the same
injected float64 GMM particles: final particles at 1e-10 and the report's
status, t, restarts, checkpoints, ``resumed_from`` and step size equal;
``check_state`` reports at 1e-12; metric, span, instant and flight-record
names letter for letter.  The port's own rules: a ``RuntimeError`` outside
the retry set propagates, a sticky device error spends the budget into
``RestartBudgetExhausted`` with a postmortem, and the installed signal
handler (invoked from a fault at a boundary, no real signal) preempts."""

import json
import os
import random
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dist_svgd_tpu as jdt
from dist_svgd_tpu import resilience as jres
from dist_svgd_tpu import telemetry as jtel
from dist_svgd_tpu.models.gmm import gmm_logp as jgmm_logp
from dist_svgd_tpu.utils.rng import minibatch_key

import dist_svgd_torch as tdt
from dist_svgd_torch import resilience as tres
from dist_svgd_torch import telemetry as ttel
from dist_svgd_torch.models.gmm import gmm_logp
from dist_svgd_torch.resilience import (
    Backoff,
    FaultPlan,
    GuardConfig,
    GuardViolation,
    HardKillAt,
    InjectNaNAt,
    PreemptAt,
    RaiseAt,
    RestartBudgetExhausted,
    RetryPolicy,
    RunSupervisor,
    SimulatedHardKill,
    SlowSegmentAt,
    TransientDispatchError,
    capped_delay,
    check_state,
)
from dist_svgd_torch.resilience.faults import Fault
from dist_svgd_torch.utils.checkpoint import CheckpointManager
from dist_svgd_torch.utils.metrics import JsonlLogger

from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

#: JAX against the port in float64 ('xla' against 'torch'): summation order
#: only (tests/test_torch_distsampler.py's tolerance).
RTOL, ATOL = 1e-10, 1e-12
#: The guards' three scalars: one reduction each, in float64.
GUARD_RTOL = 1e-12


def no_sleep(_s):
    pass


class ManualClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def advance(self, s):
        self.t += s


def gmm_parts(n=32, seed=0):
    return np.random.default_rng(seed).normal(size=(n, 2))


def make_dist(n=32, num_shards=4, parts=None, **kw):
    kw.setdefault("exchange_particles", True)
    kw.setdefault("exchange_scores", False)
    kw.setdefault("include_wasserstein", False)
    parts = gmm_parts(n) if parts is None else parts
    return tdt.DistSampler(num_shards, lambda th, _=None: gmm_logp(th), None, parts,
                           device="cpu", **kw)


def make_jdist(n=32, num_shards=4, parts=None, **kw):
    kw.setdefault("exchange_particles", True)
    kw.setdefault("exchange_scores", False)
    kw.setdefault("include_wasserstein", False)
    parts = gmm_parts(n) if parts is None else parts
    return jdt.DistSampler(num_shards, lambda th, _: jgmm_logp(th), None,
                           jnp.asarray(parts), phi_impl="xla", **kw)


def supervise(sampler, tmp_path, name, steps=12, eps=0.05, every=4, **kw):
    kw.setdefault("segment_steps", every)
    kw.setdefault("sleep", no_sleep)
    return RunSupervisor(sampler, steps, eps, checkpoint_dir=os.path.join(str(tmp_path), name),
                         checkpoint_every=every, **kw)


def reference_final(tmp_path, steps=12, **kw):
    sup = supervise(make_dist(), tmp_path, "reference", steps=steps, **kw)
    assert sup.run()["status"] == "completed"
    return sup.particles


# --------------------------------------------------------------------------
# resume exactness (both sampler kinds)


@pytest.mark.parametrize("preempt_step", [3, 4, 7])
def test_distsampler_preempt_resume_bitwise(tmp_path, preempt_step):
    """An injected preemption at any step (honoured at the next boundary)
    then resume-from-latest is the uninterrupted supervised run, bitwise."""
    want = reference_final(tmp_path)
    r1 = (sup1 := supervise(make_dist(), tmp_path, "killed",
                            faults=FaultPlan(PreemptAt(preempt_step)))).run()
    assert r1["status"] == "preempted"
    assert preempt_step <= r1["t"] < 12 and r1["t"] == sup1.t
    mgr = CheckpointManager(os.path.join(str(tmp_path), "killed"))
    assert mgr.latest_step() == r1["t"]  # the signal-triggered checkpoint
    sup2 = supervise(make_dist(), tmp_path, "killed")
    r2 = sup2.run(resume=True)
    assert r2["status"] == "completed" and r2["resumed_from"] == r1["t"]
    assert torch.equal(want, sup2.particles)


def test_sampler_minibatched_preempt_resume_bitwise(tmp_path):
    """Single-device path: the minibatch stream continues across segments
    (step_offset), so supervised == monolithic and the resumed run matches
    both bitwise."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(64, 3)).astype(np.float32)
    t = (rng.random(64) > 0.5).astype(np.float32)

    def make_s():
        return tdt.Sampler(4, lambda th, batch: -0.5 * torch.sum(th ** 2)
                           + 0.0 * torch.sum(batch[0]), data=(x, t), batch_size=8,
                           device="cpu")

    mono, _ = make_s().run(16, 12, 1e-2, seed=3, record=False)
    sup1 = supervise(make_s(), tmp_path, "a", n=16, seed=3, eps=1e-2)
    sup1.run()
    assert torch.equal(mono, sup1.particles)
    sup2 = supervise(make_s(), tmp_path, "b", n=16, seed=3, eps=1e-2,
                     faults=FaultPlan(PreemptAt(5)))
    assert sup2.run()["status"] == "preempted"
    sup3 = supervise(make_s(), tmp_path, "b", n=16, seed=3, eps=1e-2)
    assert sup3.run(resume=True)["status"] == "completed"
    assert torch.equal(mono, sup3.particles)


def test_sampler_step_offset_continues_stream():
    """Sampler.run(step_offset=k) is the resumable-drive primitive: two
    chunked calls reproduce the monolithic minibatch trajectory bitwise."""
    x = np.random.default_rng(1).normal(size=(40, 2)).astype(np.float32)
    s = tdt.Sampler(3, lambda th, b: -0.5 * torch.sum(th ** 2) + 0.0 * torch.sum(b),
                    data=x, batch_size=5, device="cpu")
    whole, _ = s.run(8, 10, 1e-2, seed=7, record=False)
    part, _ = s.run(8, 6, 1e-2, seed=7, record=False)
    part, _ = s.run(8, 4, 1e-2, seed=7, record=False, initial_particles=part,
                    step_offset=6)
    assert torch.equal(whole, part)


def test_sampler_median_kernel_frozen_across_segments(tmp_path):
    """kernel='median' resolves ONCE from the run-initial particles: the
    segmented run matches the monolithic one, and a resumed run re-pins the
    checkpointed bandwidth instead of re-resolving."""
    def make_s():
        return tdt.Sampler(2, lambda th: -0.5 * torch.sum(th ** 2), kernel="median",
                           device="cpu")

    mono, _ = make_s().run(10, 12, 0.1, seed=0, record=False)
    sup = supervise(make_s(), tmp_path, "m", n=10, seed=0, eps=0.1)
    sup.run()
    assert torch.equal(mono, sup.particles)
    supervise(make_s(), tmp_path, "m2", n=10, seed=0, eps=0.1,
              faults=FaultPlan(PreemptAt(5))).run()
    fresh = make_s()
    sup3 = supervise(fresh, tmp_path, "m2", n=10, seed=0, eps=0.1)
    sup3.run(resume=True)
    assert torch.equal(mono, sup3.particles)
    assert fresh.kernel.bandwidth == sup._harness._bandwidth


def test_distsampler_w2_lp_supervised_resume(tmp_path):
    """The host-LP W2 path (make_step-only) supervises through the
    harness's make_step loop; preempt + resume stays bitwise (the W2
    previous-snapshot and step counter ride state_dict)."""
    def make_w2():
        return make_dist(n=8, num_shards=2, include_wasserstein=True,
                         wasserstein_solver="lp")

    ref = supervise(make_w2(), tmp_path, "wref", steps=6, every=2)
    ref.run()
    k1 = supervise(make_w2(), tmp_path, "wkill", steps=6, every=2,
                   faults=FaultPlan(PreemptAt(3)))
    assert k1.run()["status"] == "preempted"
    k2 = supervise(make_w2(), tmp_path, "wkill", steps=6, every=2)
    assert k2.run(resume=True)["status"] == "completed"
    assert torch.equal(ref.particles, k2.particles)


# --------------------------------------------------------------------------
# retry / backoff / budget


def test_retry_exponential_backoff_and_replay(tmp_path):
    want = reference_final(tmp_path)
    slept = []
    sup = supervise(make_dist(), tmp_path, "retry",
                    faults=FaultPlan(RaiseAt(4), RaiseAt(4)), sleep=slept.append,
                    retry=RetryPolicy(max_restarts=3, backoff_base_s=0.5,
                                      backoff_factor=2.0))
    r = sup.run()
    assert r["status"] == "completed" and r["restarts"] == 2
    assert slept == [0.5, 1.0]  # exponential in consecutive failures
    assert torch.equal(want, sup.particles)


def test_restart_budget_exhausted(tmp_path):
    sup = supervise(make_dist(), tmp_path, "budget",
                    faults=FaultPlan(RaiseAt(0), RaiseAt(0), RaiseAt(0)),
                    retry=RetryPolicy(max_restarts=2, backoff_base_s=0.0))
    with pytest.raises(RestartBudgetExhausted) as ei:
        sup.run()
    assert isinstance(ei.value.last_error, TransientDispatchError)


def test_backoff_delay_capped():
    rp = RetryPolicy(backoff_base_s=1.0, backoff_factor=10.0, max_backoff_s=5.0)
    assert rp.delay_s(1) == 1.0
    assert rp.delay_s(2) == 5.0


def test_default_retry_set_is_the_transient_failures(tmp_path):
    """TransientDispatchError and torch.AcceleratorError are retried; a
    plain RuntimeError (a failed kernel build, a shape error) is not: it
    propagates at once, after a postmortem, with no restart spent."""
    assert RetryPolicy().retryable == (TransientDispatchError, torch.AcceleratorError)
    want = reference_final(tmp_path)
    sup = supervise(make_dist(), tmp_path, "accel",
                    faults=FaultPlan(RaiseAt(4, torch.AcceleratorError("async fault"))))
    r = sup.run()
    assert r["restarts"] == 1 and torch.equal(want, sup.particles)
    rec = ttel.FlightRecorder(capacity=16, dump_dir=str(tmp_path / "pm"))
    sup = supervise(make_dist(), tmp_path, "build", recorder=rec,
                    faults=FaultPlan(RaiseAt(4, RuntimeError("CUDA kernel build failed"))))
    with pytest.raises(RuntimeError, match="kernel build failed"):
        sup.run()
    assert sup.t == 4 and rec.dumps == 1
    assert os.listdir(tmp_path / "pm") == ["postmortem_001_fault.jsonl"]


def test_sticky_device_error_exhausts_the_budget(tmp_path):
    """A sticky CUDA error fails the segment and every rollback's copy to
    the card: each failed attempt spends a restart, and the run ends in
    RestartBudgetExhausted with its postmortem — never in a plain path."""
    rec = ttel.FlightRecorder(capacity=16, dump_dir=str(tmp_path / "pm"))
    ds = make_dist()
    sup = supervise(ds, tmp_path, "sticky", recorder=rec,
                    retry=RetryPolicy(max_restarts=3, backoff_base_s=0.0),
                    faults=FaultPlan(RaiseAt(4, torch.AcceleratorError("illegal address"))))

    def poisoned(state):
        raise torch.AcceleratorError("CUDA error: an illegal memory access")

    calls = []
    real = ds.run_steps

    def counting(*a, **kw):
        calls.append(a)
        out = real(*a, **kw)
        if len(calls) == 1:  # the context goes bad after the first segment
            ds.load_state_dict = poisoned
        return out

    ds.run_steps = counting
    with pytest.raises(RestartBudgetExhausted) as ei:
        sup.run()
    assert isinstance(ei.value.last_error, torch.AcceleratorError)
    assert "illegal memory access" in str(ei.value.last_error)
    assert len(calls) == 1  # no segment ran after the fault
    assert rec.dumps == 1
    assert os.listdir(tmp_path / "pm") == ["postmortem_001_restart_budget_exhausted.jsonl"]


# --------------------------------------------------------------------------
# guards: NaN rollback + step-size backoff


def test_nan_injection_rolls_back_and_backs_off(tmp_path):
    log_path = os.path.join(str(tmp_path), "events.jsonl")
    with JsonlLogger(path=log_path) as logger:
        sup = supervise(make_dist(), tmp_path, "nan", guard=GuardConfig(backoff_factor=0.5),
                        faults=FaultPlan(InjectNaNAt(4)), logger=logger)
        r = sup.run()
    assert r["status"] == "completed" and r["restarts"] == 1
    assert r["step_size"] == pytest.approx(0.025)  # 0.05 backed off once
    assert bool(torch.isfinite(sup.particles).all())
    events = [json.loads(ln) for ln in open(log_path)]
    kinds = [e["event"] for e in events]
    assert "guard_violation" in kinds and "rollback" in kinds
    gv = next(e for e in events if e["event"] == "guard_violation")
    assert gv["nonfinite_entries"] > 0
    assert gv["new_step_size"] == pytest.approx(0.025)


def test_check_state_unit():
    ok = np.zeros((4, 2)) + 0.5
    report = check_state(ok, config=GuardConfig(max_particle_norm=10.0))
    assert report["nonfinite_entries"] == 0
    with pytest.raises(GuardViolation, match="non-finite"):
        check_state(np.array([[np.nan, 1.0]]))
    with pytest.raises(GuardViolation, match="norm exceeds"):
        check_state(np.full((3, 2), 100.0), config=GuardConfig(max_particle_norm=1.0))
    # per-step displacement: 4 units over 2 steps = 2/step > 1
    with pytest.raises(GuardViolation, match="displacement"):
        check_state(np.full((2, 2), 4.0), prev=np.zeros((2, 2)), steps=2,
                    config=GuardConfig(max_step_norm=1.0))
    # NaN norms trip the norm guard even with the finite check off
    with pytest.raises(GuardViolation, match="norm exceeds"):
        check_state(np.array([[np.nan, 1.0]]),
                    config=GuardConfig(check_finite=False, max_particle_norm=10.0))


@pytest.mark.parametrize("case", ["finite", "with_prev", "nan", "inf", "f32"])
def test_check_state_reports_equal_jax(case):
    """The port's one-pass report against JAX's jitted one on the same
    arrays: non-finite count exact, norms and displacement at 1e-12."""
    rng = np.random.default_rng(11)
    parts = rng.normal(size=(64, 5)) * 3.0
    prev, steps = None, 1
    cfg = dict(check_finite=False)
    if case == "with_prev":
        prev, steps = parts + rng.normal(size=parts.shape), 3
    elif case == "nan":
        parts[3, 1] = parts[7, 4] = np.nan
    elif case == "inf":
        parts[0, 0] = np.inf
    elif case == "f32":
        parts = parts.astype(np.float32)
    want = jres.check_state(jnp.asarray(parts), prev=None if prev is None else jnp.asarray(prev),
                            steps=steps, config=jres.GuardConfig(**cfg))
    got = check_state(torch.as_tensor(parts), prev=prev, steps=steps,
                      config=GuardConfig(**cfg))
    assert got.keys() == want.keys()
    assert got["nonfinite_entries"] == want["nonfinite_entries"]
    for key in ("max_particle_norm", "max_step_norm"):
        if np.isnan(want[key]):
            assert np.isnan(got[key])
        else:
            np.testing.assert_allclose(got[key], want[key], rtol=GUARD_RTOL,
                                       atol=GUARD_RTOL if case != "f32" else 1e-5)


def test_check_state_reads_the_host_once(monkeypatch):
    """The three scalars come back in one transfer: one ``.tolist()`` of the
    device vector, no other host read of the particles."""
    calls = []
    real = torch.Tensor.tolist

    def tolist(self):
        calls.append(tuple(self.shape))
        return real(self)

    monkeypatch.setattr(torch.Tensor, "tolist", tolist)
    check_state(torch.ones(8, 3), prev=torch.zeros(8, 3), steps=2,
                config=GuardConfig(max_step_norm=10.0))
    assert calls == [(3,)]


def test_check_diagnostics_equal_jax():
    """The drift/collapse verdicts (NaN-safe comparisons) equal JAX's."""
    cfg = dict(max_ksd=1.0, min_ess_frac=0.2, min_dim_var=1e-3, max_shard_mean_div=0.5)
    reports = [{"ksd": 0.5, "ess_frac": 0.3, "min_dim_var": 0.1, "shard_mean_div": 0.1},
               {"ksd": float("nan"), "ess_frac": 0.3},
               {"ksd": 0.5, "ess_frac": 0.1},
               {"min_dim_var": 1e-4},
               {"shard_mean_div": float("nan")},
               {}]
    for rep in reports:
        def verdict(mod, config):
            try:
                mod.check_diagnostics(dict(rep), config)
                return None
            except Exception as e:  # noqa: BLE001 — the verdict is the message
                return (type(e).__name__, e.reason)

        from dist_svgd_tpu.resilience import guards as jguards
        from dist_svgd_torch.resilience import guards as tguards

        assert verdict(tguards, GuardConfig(**cfg)) == verdict(jguards, jres.GuardConfig(**cfg))


def test_guard_displacement_via_supervisor(tmp_path):
    """max_step_norm snapshots the pre-segment state and trips on a huge
    step size, backing ε off until the run completes."""
    sup = supervise(make_dist(), tmp_path, "diverge", eps=50.0, steps=4,
                    guard=GuardConfig(max_step_norm=1.0, backoff_factor=0.1),
                    retry=RetryPolicy(max_restarts=5, backoff_base_s=0.0))
    r = sup.run()
    assert r["status"] == "completed" and r["restarts"] >= 1 and r["step_size"] < 50.0


# --------------------------------------------------------------------------
# hard kill, corrupt-newest resume, slow-segment watchdog


def test_hard_kill_propagates_then_resume_bitwise(tmp_path):
    want = reference_final(tmp_path)
    sup = supervise(make_dist(), tmp_path, "hk", faults=FaultPlan(HardKillAt(6)))
    with pytest.raises(SimulatedHardKill):
        sup.run()
    killed_at = sup.t
    assert killed_at < 12
    sup2 = supervise(make_dist(), tmp_path, "hk")
    r2 = sup2.run(resume=True)
    assert r2["resumed_from"] <= killed_at  # steps since the last save replay
    assert torch.equal(want, sup2.particles)


def test_resume_skips_corrupt_newest_checkpoint(tmp_path):
    want = reference_final(tmp_path)
    r = supervise(make_dist(), tmp_path, "cc", faults=FaultPlan(PreemptAt(6))).run()
    assert r["status"] == "preempted" and r["t"] == 8
    newest = os.path.join(str(tmp_path), "cc", "step_8")
    for name in os.listdir(newest):
        os.remove(os.path.join(newest, name))
    with open(os.path.join(newest, "garbage"), "w") as fh:
        fh.write("not a checkpoint")
    sup2 = supervise(make_dist(), tmp_path, "cc")
    with pytest.warns(UserWarning, match="skipping unloadable checkpoint"):
        r2 = sup2.run(resume=True)
    assert r2["status"] == "completed" and r2["resumed_from"] == 4
    assert torch.equal(want, sup2.particles)


def test_slow_segment_watchdog_manual_clock(tmp_path):
    clock = ManualClock()
    log_path = os.path.join(str(tmp_path), "slow.jsonl")
    with JsonlLogger(path=log_path) as logger:
        r = supervise(make_dist(), tmp_path, "slow", faults=FaultPlan(SlowSegmentAt(4, 9.0)),
                      clock=clock, slow_segment_warn_s=5.0, logger=logger).run()
    assert r["status"] == "completed"
    slow = [e for e in map(json.loads, open(log_path)) if e["event"] == "slow_segment"]
    assert len(slow) == 1 and slow[0]["wall_s"] >= 9.0
    assert r["max_segment_wall_s"] >= 9.0


# --------------------------------------------------------------------------
# supervisor plumbing


def test_segment_and_checkpoint_events_logged(tmp_path):
    log_path = os.path.join(str(tmp_path), "ev.jsonl")
    with JsonlLogger(path=log_path) as logger:
        r = supervise(make_dist(), tmp_path, "ev", logger=logger).run()
    kinds = [e["event"] for e in map(json.loads, open(log_path))]
    assert kinds.count("segment") == r["segments"] == 3
    assert kinds.count("checkpoint") == r["checkpoints"] == 4  # initial + 4, 8, 12
    assert kinds[-1] == "completed" and r["checkpoint_overhead_frac"] >= 0


def test_fresh_run_clears_stale_root(tmp_path):
    root = os.path.join(str(tmp_path), "stale")
    CheckpointManager(root, every=4).save(999, {"particles": np.zeros((4, 2)),
                                                "t": np.asarray(999)})
    supervise(make_dist(), tmp_path, "stale").run()  # resume=False clears step_999
    assert CheckpointManager(root).latest_step() == 12


def test_supervisor_argument_validation(tmp_path):
    with pytest.raises(ValueError, match="num_steps"):
        RunSupervisor(make_dist(), 0, 0.05)
    with pytest.raises(ValueError, match="requires n"):
        RunSupervisor(tdt.Sampler(2, lambda th: -torch.sum(th ** 2), device="cpu"), 4, 0.05)
    with pytest.raises(ValueError, match="not both"):
        RunSupervisor(make_dist(), 4, 0.05, checkpoint_dir=str(tmp_path),
                      manager=CheckpointManager(str(tmp_path)))
    with pytest.raises(ValueError, match="segment_steps"):
        RunSupervisor(make_dist(), 4, 0.05, segment_steps=0)


def test_unmanaged_run_rolls_back_to_start(tmp_path):
    want = reference_final(tmp_path)
    sup = RunSupervisor(make_dist(), 12, 0.05, segment_steps=4,
                        faults=FaultPlan(RaiseAt(8)), sleep=no_sleep)
    r = sup.run()
    assert r["status"] == "completed" and r["restarts"] == 1
    assert torch.equal(want, sup.particles)


def test_fault_plan_fire_once_and_order():
    fired = []

    class Probe:
        def __init__(self, step, tag):
            self.step, self.fired, self.tag = step, False, tag

        def fire(self, ctx):
            fired.append(self.tag)

    class Ctx:
        t = 10

    plan = FaultPlan(Probe(5, "b"), Probe(1, "a"))
    plan.fire_due(Ctx())
    plan.fire_due(Ctx())  # spent faults stay spent
    assert fired == ["a", "b"] and plan.exhausted


def test_rerun_resets_counters_and_budget(tmp_path):
    sup = supervise(make_dist(), tmp_path, "rerun",
                    faults=FaultPlan(RaiseAt(0), PreemptAt(5)),
                    retry=RetryPolicy(max_restarts=1, backoff_base_s=0.0))
    r1 = sup.run()
    assert r1["status"] == "preempted" and r1["restarts"] == 1
    sup._faults = FaultPlan(RaiseAt(8))
    r2 = sup.run(resume=True)
    assert r2["status"] == "completed" and r2["restarts"] == 1
    assert r2["segments"] == 1 and r2["resumed_from"] == 8


def test_signal_handler_preempts_at_a_boundary(tmp_path):
    """install_signal_handlers maps SIGTERM onto request_stop: a fault at
    step 5 invokes the installed handler as a delivered signal would, the
    run checkpoints at that boundary and reports 'preempted'; the previous
    handlers come back untouched.  No real signal is sent."""
    want = reference_final(tmp_path)

    class HandlerAt(Fault):
        def fire(self, ctx):
            signal.getsignal(signal.SIGTERM)(signal.SIGTERM, None)

    sup = supervise(make_dist(), tmp_path, "sig", faults=FaultPlan(HandlerAt(5)))
    before = {s: signal.getsignal(s) for s in (signal.SIGTERM, signal.SIGINT)}
    previous = sup.install_signal_handlers()
    try:
        assert previous == before
        r = sup.run()
    finally:
        for s, h in previous.items():
            signal.signal(s, h)
    assert r["status"] == "preempted" and r["t"] == 8
    assert r["stop_reason"] == f"signal {int(signal.SIGTERM)}"
    assert CheckpointManager(os.path.join(str(tmp_path), "sig")).latest_step() == 8
    r2 = (sup2 := supervise(make_dist(), tmp_path, "sig")).run(resume=True)
    assert r2["resumed_from"] == 8 and torch.equal(want, sup2.particles)


# --------------------------------------------------------------------------
# shared backoff


def test_capped_delay_is_the_retrypolicy_schedule():
    from dist_svgd_tpu.resilience.backoff import capped_delay as jcapped

    rp = RetryPolicy(backoff_base_s=0.5, backoff_factor=3.0, max_backoff_s=10.0)
    for k in range(0, 12):
        assert rp.delay_s(max(k, 1)) == capped_delay(max(k, 1), 0.5, 3.0, 10.0)
        assert capped_delay(k, 1.0, 2.0, 60.0) == jcapped(k, 1.0, 2.0, 60.0)
    assert capped_delay(50, 1.0, 2.0, 60.0) == 60.0


@pytest.mark.parametrize("jitter,seed", [(0.25, 7), (0.3, 3), (0.0, 1), (0.9, 11)])
def test_backoff_jitter_equals_jax(jitter, seed):
    """With the same seeded random.Random the port's jittered delays are
    JAX's value for value, inside the band and under the cap."""
    from dist_svgd_tpu.resilience.backoff import Backoff as JBackoff

    ours = Backoff(base_s=0.1, factor=2.0, max_s=5.0, jitter_frac=jitter,
                   rng=random.Random(seed))
    theirs = JBackoff(base_s=0.1, factor=2.0, max_s=5.0, jitter_frac=jitter,
                      rng=random.Random(seed))
    got = [ours.delay_s(k) for k in range(1, 14)]
    assert got == [theirs.delay_s(k) for k in range(1, 14)]
    for k, d in enumerate(got, start=1):
        exact = capped_delay(k, 0.1, 2.0, 5.0)
        assert (1 - jitter) * exact <= d <= min((1 + jitter) * exact, 5.0)
    assert repr(ours) == repr(theirs)


def test_backoff_validation():
    with pytest.raises(ValueError, match="jitter_frac"):
        Backoff(jitter_frac=1.0)
    with pytest.raises(ValueError, match="factor"):
        Backoff(factor=0.5)
    with pytest.raises(ValueError, match="max_s"):
        Backoff(base_s=2.0, max_s=1.0)
    with pytest.raises(ValueError, match="base_s"):
        Backoff(base_s=-1.0)


# --------------------------------------------------------------------------
# the port against JAX on the same injected particles


REPORT_KEYS = ("status", "t", "restarts", "checkpoints", "resumed_from", "step_size")


def _scenario(kind):
    """(faults factory, guard, resume-after-preempt?) of each compared run."""
    return {
        "plain": (lambda m: None, None, False),
        "preempt_resume": (lambda m: m.FaultPlan(m.PreemptAt(5)), None, True),
        "nan_rollback": (lambda m: m.FaultPlan(m.InjectNaNAt(4)), "guard", False),
        "retry": (lambda m: m.FaultPlan(m.RaiseAt(4), m.RaiseAt(8)), None, False),
        "hard_kill_resume": (lambda m: m.FaultPlan(m.HardKillAt(6)), None, True),
    }[kind]


def _drive(mod, make, tmp_path, name, faults, guard, resume):
    def sup(faults=None):
        return mod.RunSupervisor(make(), 12, 0.05,
                                 checkpoint_dir=os.path.join(str(tmp_path), name),
                                 checkpoint_every=4, segment_steps=2, sleep=no_sleep,
                                 faults=faults,
                                 guard=mod.GuardConfig() if guard else None)

    first = sup(faults(mod))
    try:
        report = first.run()
    except mod.SimulatedHardKill:
        report = None
    if not resume:
        return first, report
    second = sup()
    return second, second.run(resume=True)


@pytest.mark.parametrize("kind", ["plain", "preempt_resume", "nan_rollback", "retry",
                                  "hard_kill_resume"])
def test_supervised_distsampler_matches_jax(tmp_path, kind):
    """Port and JAX supervisors on the same float64 GMM particles: the
    final particles at 1e-10 and the report's status, t, restarts,
    checkpoints, resumed_from and step size equal."""
    parts = gmm_parts(32, seed=4)
    faults, guard, resume = _scenario(kind)
    js, jr = _drive(jres, lambda: make_jdist(parts=parts), tmp_path, "jax", faults, guard,
                    resume)
    ps, pr = _drive(tres, lambda: make_dist(parts=parts, phi_impl="torch"), tmp_path, "port",
                    faults, guard, resume)
    assert {k: pr[k] for k in REPORT_KEYS} == {k: jr[k] for k in REPORT_KEYS}
    assert set(pr) == set(jr)
    np.testing.assert_allclose(ps.particles.numpy(), np.asarray(js.particles),
                               rtol=RTOL, atol=ATOL)


def _jax_sampler_index(seed, n_rows, batch):
    root = minibatch_key(seed)
    return lambda t: np.array(jax.random.choice(jax.random.fold_in(root, t), n_rows,
                                                (batch,), replace=False))


@pytest.mark.parametrize("kernel", [None, "median"])
def test_supervised_sampler_matches_jax(tmp_path, kernel):
    """The single-device harness: JAX's minibatch indices injected through
    the port's seam, a preempt at 5 and a resume, diagnostics on the
    harness's own score closure — particles at 1e-10, the reports' keys and
    values equal, the last KSD / ESS at 1e-10."""
    rng = np.random.default_rng(6)
    x, t = rng.normal(size=(30, 3)), np.where(rng.normal(size=30) > 0, 1.0, -1.0)
    init = 0.3 * rng.normal(size=(16, 4))

    from dist_svgd_tpu.models.logreg import logreg_logp as jlogreg
    from dist_svgd_torch.models.logreg import logreg_logp

    def jmake():
        return jdt.Sampler(4, jlogreg, kernel=kernel, data=(jnp.asarray(x), jnp.asarray(t)),
                           batch_size=8, phi_impl="xla")

    def pmake():
        s = tdt.Sampler(4, logreg_logp, kernel=kernel, data=(x, t), batch_size=8,
                        phi_impl="torch", device="cpu", seed=2)
        s._batch_index_seam = _jax_sampler_index(2, 30, 8)
        return s

    def drive(mod, make, name, diag):
        kw = dict(checkpoint_dir=os.path.join(str(tmp_path), name), checkpoint_every=4,
                  segment_steps=2, sleep=no_sleep, n=16, seed=2, initial_particles=init)
        mod.RunSupervisor(make(), 12, 0.05, faults=mod.FaultPlan(mod.PreemptAt(5)),
                          **kw).run()
        sup = mod.RunSupervisor(make(), 12, 0.05, diagnostics=diag, **kw)
        return sup, sup.run(resume=True)

    jdiag = jtel.PosteriorDiagnostics(jtel.DiagnosticsConfig(every_steps=4, max_points=16),
                                      registry=jtel.MetricsRegistry())
    tdiag = ttel.PosteriorDiagnostics(ttel.DiagnosticsConfig(every_steps=4, max_points=16),
                                      registry=ttel.MetricsRegistry())
    js, jr = drive(jres, jmake, "jax", jdiag)
    ps, pr = drive(tres, pmake, "port", tdiag)
    assert {k: pr[k] for k in REPORT_KEYS} == {k: jr[k] for k in REPORT_KEYS}
    assert pr["resumed_from"] == 6 and pr["t"] == 12
    np.testing.assert_allclose(ps.particles.numpy(), np.asarray(js.particles),
                               rtol=RTOL, atol=ATOL)
    for key in ("ksd", "ess", "ess_frac", "min_dim_var"):
        np.testing.assert_allclose(pr["last_diagnostics"][key], jr["last_diagnostics"][key],
                                   rtol=RTOL, atol=ATOL)


def test_metric_span_and_record_names_equal_jax(tmp_path):
    """A NaN rollback, a retry and a preempt under the tracer and a flight
    recorder: the registry's metric names and label sets, the span and
    instant names, the flight-record kinds and the postmortem reasons are
    JAX's, letter for letter."""
    parts = gmm_parts(32, seed=1)

    def drive(mod, tel, make, name):
        reg = tel.MetricsRegistry()
        rec = tel.FlightRecorder(capacity=256, dump_dir=str(tmp_path / f"pm_{name}"),
                                 registry=reg)
        tracer = tel.enable()
        try:
            mod.RunSupervisor(make(), 12, 0.05, checkpoint_dir=str(tmp_path / name),
                              checkpoint_every=4, segment_steps=2, sleep=no_sleep,
                              registry=reg, recorder=rec, guard=mod.GuardConfig(),
                              faults=mod.FaultPlan(mod.InjectNaNAt(2), mod.RaiseAt(6),
                                                   mod.PreemptAt(9))).run()
        finally:
            tel.disable()
        series = {(m, tuple(sorted(s.get("labels", {}).items())))
                  for m, entry in reg.dump()["metrics"].items()
                  for s in entry.get("series", [])}
        names = sorted({e["name"] for e in tracer.chrome_events() if e.get("ph") in "Xi"})
        kinds = [e["kind"] for e in rec.events() if e["kind"] not in ("span", "instant")]
        return series, names, kinds, sorted(os.listdir(tmp_path / f"pm_{name}"))

    want = drive(jres, jtel, lambda: make_jdist(parts=parts), "jax")
    got = drive(tres, ttel, lambda: make_dist(parts=parts, phi_impl="torch"), "port")
    # the port's dispatch spans sit inside each segment as JAX's do; the
    # supervisor's own names must match exactly
    sup_names = {"train.segment", "train.checkpoint", "train.rollback", "train.retry",
                 "train.guard_violation", "train.preempt"}
    assert [n for n in got[1] if n in sup_names] == [n for n in want[1] if n in sup_names]
    assert sup_names <= set(got[1])
    ours = {s for s in got[0] if s[0].startswith(("svgd_train_", "svgd_elastic_",
                                                  "svgd_flight_"))}
    theirs = {s for s in want[0] if s[0].startswith(("svgd_train_", "svgd_elastic_",
                                                     "svgd_flight_"))}
    assert ours == theirs
    assert got[2] == want[2] and got[3] == want[3]
