"""The step-anatomy tools of the port — ``tools/step_timing.py``,
``profile_step_floor.py``, ``profile_emulation.py`` and
``record_overhead.py`` under ``dist_svgd_torch/`` — against the JAX
package on the CPU.

Every parity case feeds both packages the same particles, drawn with numpy
from a seed (JAX's threefry streams cannot be reproduced in torch), and
the same banana fold 42.  Tolerances, all on the largest entry of the
reference: ``max|port − JAX| ≤ rtol · max|JAX|`` (:func:`assert_rel`) —
1e-5 in float32 (the port's float32 φ on the CPU is the hand kernels'
plain versions, JAX's the XLA φ: two summation orders), 1e-10 in float64
(both the plain φ).  The emulation variants reach the step through other
lane splits and sum orders than the sampler's, so they are held at the
same relative tolerance, not bitwise."""

import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dist_svgd_tpu as jdt
from dist_svgd_tpu.models.logreg import logreg_logp as jlogreg_logp
from dist_svgd_tpu.ops.kernels import RBF as JRBF
from dist_svgd_tpu.ops.pallas_svgd import resolve_phi_fn as jresolve_phi_fn
from dist_svgd_tpu.utils import history as jhistory
from dist_svgd_tpu.utils import rng as jrng
from dist_svgd_tpu.utils.datasets import load_benchmark as jload_benchmark

from dist_svgd_torch.experiments import logreg as tlogreg
from dist_svgd_torch.sampler import Sampler
from dist_svgd_torch.tools import (
    profile_emulation,
    profile_step_floor,
    record_overhead,
    step_timing,
)
from dist_svgd_torch.utils import history as thistory
from dist_svgd_torch.utils.datasets import load_benchmark

from test_torch_port_rules import _run_with_jax_blocked
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import bench  # noqa: E402  (the JAX package's bench helpers)

RTOL = {np.float32: 1e-5, np.float64: 1e-10}
DTYPES = [np.float32, np.float64]
IDS = ["f32", "f64"]


def assert_rel(got, want, rtol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    err, scale = np.max(np.abs(got - want)), np.max(np.abs(want))
    assert err <= rtol * scale, (err, rtol * scale)


def particles(n, dtype=np.float64, d=3, seed=0):
    return np.random.default_rng(seed).normal(size=(n, d)).astype(dtype)


def jax_data(dtype, rows=None):
    fold = jload_benchmark("banana", 42)
    rows = rows or fold.x_train.shape[0]
    return (jnp.asarray(fold.x_train[:rows], dtype),
            jnp.asarray(fold.t_train.reshape(-1)[:rows], dtype))


def test_same_banana_fold_in_both_packages():
    mine, theirs = load_benchmark("banana", 42), jload_benchmark("banana", 42)
    np.testing.assert_array_equal(mine.x_train, theirs.x_train)
    np.testing.assert_array_equal(mine.t_train, theirs.t_train)


# --------------------------------------------------------------------------
# step_timing: the fence, the chained timing, the flagship sampler


class FakeClock:
    def __init__(self):
        self.now = 0.0

    def __call__(self):
        return self.now


def test_make_sharded_step_matches_jax_make_sharded(monkeypatch):
    """One step of the flagship sampler equals one step of JAX's
    ``bench._make_sharded`` sampler from the same particles (float32,
    ``'auto'``), rtol 1e-5."""
    p = particles(64, np.float32, seed=1)
    monkeypatch.setattr(jrng, "init_particles_per_shard",
                        lambda key, n, d, S, dtype=jnp.float32: jnp.asarray(p))
    js = bench._make_sharded(jload_benchmark("banana", 42), n=64)
    ts = step_timing.make_sharded(load_benchmark("banana", 42), n=64, device="cpu",
                                  particles=p)
    assert ts.num_particles == js.num_particles == 64
    assert ts.particles.dtype == torch.float32
    assert_rel(ts.make_step(3e-3).numpy(), js.make_step(3e-3), RTOL[np.float32])


def test_make_sharded_defaults_are_bench_s(monkeypatch):
    """bench.py's particle and shard counts; the mode and the W2 term pass
    through; no device is the card, which raises without CUDA."""
    assert (step_timing.N_PARTICLES, step_timing.NUM_SHARDS) == (bench.N_PARTICLES,
                                                                  bench.NUM_SHARDS)
    ts = step_timing.make_sharded(load_benchmark("banana", 42), n=16, device="cpu",
                                  mode="partitions", wasserstein=True)
    assert ts.mode == "partitions" and ts._include_wasserstein and ts.num_particles == 16
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        step_timing.make_sharded(load_benchmark("banana", 42), n=16)


@pytest.mark.parametrize("fence_s,call_s,target_s,reps", [
    (0.0, 0.010, 1.0, 100),      # no fence cost: target over the call
    (0.004, 0.010, 1.0, 100),    # the fence's cost is taken off the estimate
    (0.0, 0.0005, 1.0, 500),     # below the marginal floor: timed at 2 ms
    (0.0, 0.0005, 10.0, 512),    # capped
    (0.0, 1.0, 1.0, 2),          # at least two calls
])
def test_timed_chain_sizes_its_chain_from_the_measured_fence(monkeypatch, fence_s, call_s,
                                                             target_s, reps):
    """``timed_chain(reps=None)`` estimates a call from two fenced calls,
    subtracts the fence cost it measures with nothing in flight, and
    chains ``target_s`` over the rest; the sample's per-call wall is the
    call's cost plus the fence spread over the chain."""
    clock = FakeClock()
    calls = []

    def fake_fence(x):
        clock.now += fence_s

    def fn():
        calls.append(1)
        clock.now += call_s
        return torch.zeros(1)

    monkeypatch.setattr(step_timing, "fence", fake_fence)
    best = step_timing.timed_chain(fn, samples=2, target_s=target_s, clock=clock)
    assert len(calls) == 2 + 2 * reps
    assert best == pytest.approx(call_s + fence_s / reps)
    assert step_timing.chain_reps(call_s + fence_s, fence_s, target_s) == reps


def test_timed_chain_fixed_reps_and_real_fence():
    state = {"x": torch.zeros(2, 2)}

    def fn():
        state["x"] = state["x"] + 1
        return state["x"]

    assert step_timing.timed_chain(fn, reps=3, samples=2) > 0
    assert float(state["x"][0, 0]) == 6
    step_timing.fence(state["x"])  # a CPU tensor: the fetch alone
    assert step_timing.fence_cost_s(state["x"]) >= 0
    assert step_timing.describe_device(torch.device("cpu")) == "cpu"


# --------------------------------------------------------------------------
# profile_step_floor: the five bodies, the sweeps, the donation A/B


def jax_bodies(x, t, dtype):
    """JAX's five bodies (``tools/profile_step_floor.py:150-162``), built as
    the tool builds them; its float32 literals taken at ``dtype``."""
    eps = jnp.asarray(3e-3, dtype)
    phi_fn = jresolve_phi_fn(JRBF(1.0), "auto")
    batched_score = jax.vmap(jax.grad(jlogreg_logp, argnums=0), in_axes=(0, None))
    key = jrng.as_key(0)
    return {
        "empty (axpy only)": lambda p, i: p * jnp.asarray(1.0 + 1e-7, dtype),
        "fold_in + axpy": lambda p, i: p * (
            1.0 + 1e-7 * jax.random.fold_in(key, i)[0].astype(dtype)),
        "score only": lambda p, i: p + eps * batched_score(p, (x, t)),
        "phi only": lambda p, i: p + eps * phi_fn(p, p, p),
        "full step (score+phi)": lambda p, i: p + eps * phi_fn(p, p, batched_score(p, (x, t))),
    }


@pytest.mark.parametrize("dtype", DTYPES, ids=IDS)
@pytest.mark.parametrize("body", ["empty (axpy only)", "score only", "phi only",
                                  "full step (score+phi)"])
def test_floor_body_matches_jax(body, dtype):
    """One application of each deterministic body at config 1's shape
    (n = 100, d = 3) equals JAX's."""
    p = particles(100, dtype, seed=2)
    p0, data = profile_step_floor.config1(100, torch.device("cpu"), p)
    got = profile_step_floor.floor_bodies(data)[body](p0, 0)
    want = jax_bodies(*jax_data(dtype), dtype)[body](jnp.asarray(p), 0)
    assert got.dtype == p0.dtype
    assert_rel(got.numpy(), want, RTOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES, ids=IDS)
def test_floor_draw_body_shape_and_finiteness(dtype):
    """The draw body against JAX's ``fold_in + axpy`` on shape and
    finiteness only: JAX multiplies by a word of its threefry key, which
    torch cannot reproduce; the port draws one uniform from its per-step
    generator ``_generator(seed, i)``, the same for a step on any device."""
    p = particles(100, dtype, seed=3)
    p0, data = profile_step_floor.config1(100, torch.device("cpu"), p)
    body = profile_step_floor.floor_bodies(data)["draw + axpy"]
    got = [body(p0, i) for i in (0, 1, 0)]
    want = jax_bodies(*jax_data(dtype), dtype)["fold_in + axpy"](jnp.asarray(p), 0)
    assert got[0].shape == tuple(want.shape) == (100, 3)
    assert all(bool(torch.isfinite(g).all()) for g in got)
    assert torch.equal(got[0], got[2])  # a step's draw is keyed by (seed, step)
    assert_rel(got[1].numpy(), p, 1e-6)  # p·(1 + 1e-7·u), u in [0, 1)


def test_chain_sweep_marginal_arithmetic(monkeypatch):
    """The chain sweep's rows on a clock the body and the fence advance:
    a fixed 50 ms a fenced sample, 1 ms a step — the total, the wall a
    dispatch, the rate and the marginal cost of a dispatch (the fixed part
    cancels: exactly 10 ms a 10-step dispatch)."""
    clock = FakeClock()
    monkeypatch.setattr(profile_step_floor, "fence",
                        lambda x: setattr(clock, "now", clock.now + 0.05))

    def body(p, i):
        clock.now += 0.001
        return p

    rows = profile_step_floor.chain_sweep(body, torch.zeros(4, 3), (1, 8, 32), samples=2,
                                          iters=10, clock=clock)
    assert [r["chain"] for r in rows] == [1, 8, 32]
    assert rows[0]["total_ms"] == pytest.approx(60.0)
    assert rows[1]["total_ms"] == pytest.approx(130.0)
    assert rows[1]["ms_per_dispatch"] == pytest.approx(130.0 / 8)
    assert rows[1]["updates_per_s"] == pytest.approx(4 * 10 / (0.13 / 8))
    assert "marginal_ms_per_dispatch" not in rows[0]
    assert rows[1]["marginal_ms_per_dispatch"] == pytest.approx(10.0)
    assert rows[2]["marginal_ms_per_dispatch"] == pytest.approx(10.0)
    assert profile_step_floor.marginal_ms((1, 0.06), (8, 0.13)) == pytest.approx(10.0)


def test_timed_dispatch_protocol(monkeypatch):
    """JAX's protocol: one untimed dispatch, then the best of ``samples``
    samples of ``reps`` chained dispatches under one fence."""
    clock = FakeClock()
    fences = []
    monkeypatch.setattr(step_timing, "fence", lambda x: fences.append(float(x[0, 0])))
    steps = []

    def body(p, i):
        steps.append(i)
        clock.now += 0.002
        return p + 1

    wall = step_timing.timed_dispatch(body, torch.zeros(2, 3), iters=5, reps=3, samples=2,
                                      clock=clock)
    assert wall == pytest.approx(0.010)
    assert len(steps) == 5 * (1 + 2 * 3) and steps[:5] == [0, 1, 2, 3, 4]
    assert fences == [5.0, 15.0, 15.0]  # each sample chains from the start


def test_floor_rows_on_the_cpu(tmp_path):
    """The composition and the sweep end to end at a tiny size, with the
    trace: the rows' keys, the composition against the empty body and a
    Chrome trace a section."""
    out = profile_step_floor.floor_rows(
        n=8, reps=1, dispatch_lengths=(1, 2), chains=(1, 2), samples=1,
        trace=str(tmp_path / "tr"), device="cpu", chain_dispatch=2)
    assert list(out["ms_per_step"]) == list(profile_step_floor.floor_bodies(
        profile_step_floor.config1(8, torch.device("cpu"))[1]))
    comp = out["composition"]
    assert comp["empty (axpy only)"]["over_empty_ms"] == 0.0
    for name, row in comp.items():
        assert row["ms_per_step"] == out["ms_per_step"][name][2] > 0
    assert [r["chain"] for r in out["chain"]] == [1, 2]
    assert "marginal_ms_per_dispatch" in out["chain"][1]
    for section in ("bodies", "chain"):
        doc = json.loads((tmp_path / "tr" / section / "trace.json").read_text())
        assert doc["traceEvents"]


def test_sampler_accepts_donate_carries_without_effect():
    """JAX's ``Sampler(donate_carries=...)``: accepted, no effect — the
    same particles either way."""
    p = particles(12, np.float64, seed=4)
    x, t = jax_data(np.float64, rows=40)
    outs = []
    for donate in (True, False):
        s = Sampler(3, tlogreg.logreg_logp, data=(np.array(x), np.array(t)),
                    device="cpu", donate_carries=donate)
        outs.append(s.run(12, 3, 3e-3, record=False, initial_particles=p)[0])
    assert torch.equal(outs[0], outs[1])


def test_donate_ab_row_keys_and_bitwise():
    row = profile_step_floor.donate_ab(16, iters=2, chain=2, samples=1, device="cpu")
    assert list(row) == ["bench", "n", "iters_per_dispatch", "chain",
                         "donated_ms_per_dispatch", "undonated_ms_per_dispatch",
                         "speedup", "bitwise_equal"]
    assert row["bitwise_equal"] is True and row["bench"] == "donate_ab"


def test_profile_step_floor_cli(capsys):
    profile_step_floor.main(["--device", "cpu", "--n", "8", "--dispatch-lengths", "1", "2",
                             "--chains", "1", "2", "--chain-dispatch", "2", "--reps", "1",
                             "--samples", "1"])
    text = capsys.readouterr().out
    for line in ("devices: cpu", "config-1 shape: n=8, d=3, rows=400",
                 "per-iteration composition at the 2-iter dispatch:",
                 "chain-length sweep, full 2-step config-1 dispatches:", "marginal"):
        assert line in text
    row = profile_step_floor.main(["--device", "cpu", "--donate-ab", "--n", "8",
                                   "--chain-dispatch", "2", "--samples", "1"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == row


# --------------------------------------------------------------------------
# profile_emulation: variants A–F against JAX's steps


EMU = dict(n=64, shards=4)
SAMPLER_VARIANTS = ["B:lanes_all_particles", "B2:lanes_torch_phi", "C:unrolled_phi",
                    "D:lanes_scores_outside", "F:lanes_split_bps4"]
GLOBAL_VARIANTS = ["A:unsharded", "E:all_scores_special"]


def jax_global_step(p, dtype, variant):
    """JAX's variants A and E (``tools/profile_emulation.py:84-89,
    159-165``): one φ over all n, with A's scores of all n on all rows, or
    E's scores summed over the S lanes' row slices.  Every lane's score
    carries the prior's gradient, so E's sum counts the prior S times: E
    is not A's step (it differs by (S − 1)·∇log prior), in JAX as in the
    port, and each is held against its own JAX step."""
    x, t = jax_data(dtype)
    S = EMU["shards"]
    phi_fn = jresolve_phi_fn(JRBF(1.0), "auto", S)
    batched_score = jax.vmap(jax.grad(jlogreg_logp, argnums=0), in_axes=(0, None))
    if variant == "A:unsharded":
        scores = batched_score(p, (x, t))
    else:
        stack = (x.reshape(S, x.shape[0] // S, -1), t.reshape(S, -1))
        scores = jnp.sum(jax.vmap(lambda dl: batched_score(p, dl))(stack), axis=0)
    return p + jnp.asarray(3e-3, dtype) * phi_fn(p, p, scores)


@pytest.mark.parametrize("dtype", DTYPES, ids=IDS)
@pytest.mark.parametrize("variant", SAMPLER_VARIANTS + GLOBAL_VARIANTS)
def test_emulation_variant_matches_jax(variant, dtype):
    """B, B2, C, D and F equal one JAX ``DistSampler`` ``all_particles``
    step from the same particles at N = 64, S = 4; A equals JAX's unsharded
    step and E JAX's E (:func:`jax_global_step`).  Tolerance: :data:`RTOL`
    of the dtype."""
    p = particles(EMU["n"], dtype, seed=5)
    p0, variants = profile_emulation.build_variants(device="cpu", particles=p, **EMU)
    got = variants[variant](p0, 0)
    if variant == "E:all_scores_special":  # not A's step: the prior S times
        a = variants["A:unsharded"](p0, 0)
        assert float((got - a).abs().max()) > 1e-3 * float(a.abs().max())
    if variant in GLOBAL_VARIANTS:
        want = jax_global_step(jnp.asarray(p), dtype, variant)
    else:
        js = jdt.DistSampler(EMU["shards"], jlogreg_logp, None, jnp.asarray(p),
                             data=jax_data(dtype), exchange_particles=True,
                             exchange_scores=False, include_wasserstein=False)
        want = js.make_step(3e-3)
    assert got.dtype == p0.dtype and got.shape == p0.shape
    assert_rel(got.numpy(), want, RTOL[dtype])


def test_emulation_variants_and_launch_table():
    assert tuple(profile_emulation.phi_launches(8)) == profile_emulation.VARIANTS
    assert profile_emulation.phi_launches(8)["C:unrolled_phi"] == 8
    assert profile_emulation.phi_launches(8)["B2:lanes_torch_phi"] == 0
    assert profile_emulation.F_BLOCKS_PER_SM != profile_emulation.cuda_svgd.blocks_per_sm(
        "phi_small_d")
    assert (profile_emulation.N, profile_emulation.S) == (10_000, 8)


def test_emulation_rows_and_cli(capsys):
    out = profile_emulation.main(["--device", "cpu", "--n", "32", "--shards", "4",
                                  "--iters", "1", "--reps", "1"])
    assert list(out["variants"]) == list(profile_emulation.VARIANTS)
    assert all(r["updates_per_s"] > 0 and r["wall_s"] > 0 for r in out["variants"].values())
    text = capsys.readouterr().out
    assert "devices: cpu" in text and "F:lanes_split_bps4" in text and "M up/s" in text


# --------------------------------------------------------------------------
# record_overhead: the driver's recorded stack


def test_recorded_stack_matches_jax_record(monkeypatch):
    """The recorded arm's stack equals JAX's ``run_steps(record=True)``
    history plus its final state, at n = 64 with the history chunk forced
    to 3 steps in both packages (2 chunks: 6 steps, two host moves); its
    last snapshot equals the plain arm's final particles bitwise.
    float32, rtol 1e-5."""
    p = particles(64, np.float32, seed=6)
    monkeypatch.setattr(thistory, "record_chunk_steps", lambda n, d, itemsize=4: 3)
    monkeypatch.setattr(jhistory, "record_chunk_steps", lambda n, d: 3)
    monkeypatch.setattr(tlogreg, "init_particles_per_shard",
                        lambda seed, n, d, S: torch.as_tensor(p))
    monkeypatch.setattr(step_timing, "init_particles_per_shard",
                        lambda seed, n, d, S: torch.as_tensor(p))
    out = record_overhead.overhead_rows(n=64, chunks=2, rounds=1, device="cpu",
                                        keep_stack=True)
    assert (out["chunk"], out["niter"], out["stack_shape"]) == (3, 6, [7, 64, 3])
    assert out["last_equals_plain"] and out["last_max_abs_dev"] == 0.0
    js = jdt.DistSampler(8, jlogreg_logp, None, jnp.asarray(p), data=jax_data(np.float32),
                         exchange_particles=True, exchange_scores=False,
                         include_wasserstein=False)
    final, hist = js.run_steps(6, 3e-3, record=True)
    want = np.concatenate([np.asarray(hist), np.asarray(final)[None]])
    assert_rel(out["stack"], want, RTOL[np.float32])


def test_record_overhead_cli(monkeypatch, capsys):
    monkeypatch.setattr(thistory, "record_chunk_steps", lambda n, d, itemsize=4: 2)
    out = record_overhead.main(["--device", "cpu", "--n", "16", "--chunks", "1",
                                "--rounds", "1"])
    assert out["stack_shape"] == [3, 16, 3] and out["last_equals_plain"]
    assert "stack" not in out
    text = capsys.readouterr().out
    assert "n=16 d=3: chunk=2 steps (2 steps per trajectory)" in text
    assert "history overhead:" in text and "vs the <10% target" in text


# --------------------------------------------------------------------------
# the device rule and the import rule


@pytest.mark.parametrize("tool", ["profile_step_floor", "profile_emulation",
                                  "record_overhead"])
def test_tools_default_to_the_card(monkeypatch, tool):
    """With no ``--device`` a tool asks for the card and raises without
    CUDA; it never falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    module = {"profile_step_floor": profile_step_floor,
              "profile_emulation": profile_emulation,
              "record_overhead": record_overhead}[tool]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        module.main([])


def test_step_tools_run_with_jax_blocked():
    """A process where ``import jax`` fails imports the four tools and runs
    each at a tiny size on the CPU."""
    code = (
        "import sys; sys.modules['jax'] = None; sys.modules['dist_svgd_tpu'] = None\n"
        "from dist_svgd_torch.tools import (profile_emulation, profile_step_floor,\n"
        "    record_overhead, step_timing, w2_bench)\n"
        "from dist_svgd_torch.utils import history\n"
        "history.record_chunk_steps = lambda n, d, itemsize=4: 2\n"
        "profile_step_floor.main(['--device', 'cpu', '--n', '8', '--dispatch-lengths', '1',\n"
        "    '--chains', '1', '--chain-dispatch', '1', '--reps', '1', '--samples', '1'])\n"
        "profile_emulation.main(['--device', 'cpu', '--n', '16', '--shards', '2',\n"
        "    '--iters', '1', '--reps', '1'])\n"
        "assert record_overhead.main(['--device', 'cpu', '--n', '16', '--chunks', '1',\n"
        "    '--rounds', '1'])['last_equals_plain']\n"
        "w2_bench.main(['--device', 'cpu', '--n', '16', '--shards', '2',\n"
        "    '--iters-per-dispatch', '1', '--samples', '1', '--no-fixed'])\n"
        "assert 'jax' not in [m.split('.')[0] for m in sys.modules if sys.modules[m]]\n"
        "print('ok')\n"
    )
    _run_with_jax_blocked(code)
