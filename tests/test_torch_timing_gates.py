"""The measurements behind ``chip_smoke.py``'s three timing gates, on the
CPU: the profiler gate's estimator over synthetic timings
(``tools/serve_bench.py:_instrument_estimate``), the card's capacity probe
for the storm (``tools/workload_replay.py:_steady_window``,
``_steady_sample``, ``_steady_rows_capacity``; the CPU keeps JAX's probe,
which ``test_torch_workload_replay.py`` holds equal), a hot reload's parts
record (``serving/engine.py:PredictiveEngine.last_reload_parts``), the
collector kept off across a graph capture (``parallel/plan.py:_capture``)
and the collector-pause recorder (``utils/collector.py``).  The card runs
of these gates are ``chip_smoke.py``'s sections 19, 21 and 22 and its
``--gate-load`` harness."""

import concurrent.futures
import gc
import importlib.util
import itertools
import time
import weakref
from pathlib import Path

import numpy as np
import pytest
import torch

from dist_svgd_torch.parallel import plan as tplan
from dist_svgd_torch.serving import PredictiveEngine
from dist_svgd_torch.serving.batcher import Overloaded
from dist_svgd_torch.telemetry import profile as profile_mod
from dist_svgd_torch.telemetry import usage as usage_mod
from dist_svgd_torch.tools import serve_bench
from dist_svgd_torch.tools import workload_replay as wr
from dist_svgd_torch.utils.collector import CollectorPauses

from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

#: The profiler phase's closed-loop batch rate in an H100 smoke run that
#: read 3.1% (143 µs a batch), and the instruments' own cost a batch in
#: passing runs (14–56 µs; PERF.md §6).
BATCH_RATE = 216.0
OWN_COST_S = 20e-6
#: A round's arm: ``calls`` batches of ~300 µs.
ARM_S = 500 * 300e-6


def _timings(cost_s, rounds=8, base_s=300e-6, drift_per_s=0.0, alternate=True):
    """Per-batch seconds as ``_instrument_timings`` reports them, for a host
    whose batch takes ``base_s · (1 + drift_per_s · t)`` at time t and
    instruments that add ``cost_s``: the arms run back to back, off first
    in every round (``alternate=False``, the old order) or in alternating
    order."""
    t, out = 0.0, []
    for i in range(rounds):
        order = ("off", "on") if not alternate or i % 2 == 0 else ("on", "off")
        timing = {"order": "/".join(order)}
        for arm in order:
            mid = t + ARM_S / 2
            timing[f"{arm}_s"] = base_s * (1 + drift_per_s * mid) + (cost_s if arm == "on" else 0.0)
            t += ARM_S
        out.append(timing)
    return out


def _fixed_order_reading(timings):
    """The estimator before the order alternated: the median of on − off."""
    return float(np.median([t["on_s"] - t["off_s"] for t in timings]))


def test_estimator_reads_the_injected_cost_on_a_steady_host():
    for cost in (0.0, OWN_COST_S, 143e-6):
        assert serve_bench._instrument_estimate(_timings(cost)) == pytest.approx(cost, abs=1e-12)


def test_alternating_order_cancels_a_host_that_slows_within_rounds():
    """A host slowing 10% a second: off-first rounds charge the slow-down to
    'on' (the old reading is biased up by base · drift · arm), the
    alternating order's adjacent pairs cancel it."""
    drift = 0.10
    fixed = _fixed_order_reading(_timings(OWN_COST_S, drift_per_s=drift, alternate=False))
    bias = 300e-6 * drift * ARM_S
    assert fixed == pytest.approx(OWN_COST_S + bias, rel=1e-9)
    assert fixed - OWN_COST_S > 0.05 * OWN_COST_S
    new = serve_bench._instrument_estimate(_timings(OWN_COST_S, drift_per_s=drift))
    assert new == pytest.approx(OWN_COST_S, abs=1e-12)
    # a host that speeds up: the old order under-reads, the new one does not
    assert _fixed_order_reading(_timings(OWN_COST_S, drift_per_s=-drift,
                                         alternate=False)) < OWN_COST_S
    assert serve_bench._instrument_estimate(
        _timings(OWN_COST_S, drift_per_s=-drift)) == pytest.approx(OWN_COST_S, abs=1e-12)


@pytest.mark.parametrize("spiked_round", [0, 3, 7])
@pytest.mark.parametrize("arm", ["on", "off"])
def test_a_single_spiked_round_does_not_move_the_median(spiked_round, arm):
    """A collection or a preemption inside one arm of one round (1 ms a
    batch) moves two adjacent-pair means of seven, not the median."""
    timings = _timings(OWN_COST_S)
    timings[spiked_round][f"{arm}_s"] += 1e-3
    assert serve_bench._instrument_estimate(timings) == pytest.approx(OWN_COST_S, abs=1e-12)


@pytest.mark.parametrize("drift", [0.0, 0.10, -0.10])
def test_a_real_three_percent_cost_fails_the_gate(drift):
    """A cost of 3% of a batch interval at the phase's batch rate, on top of
    the instruments' own, reads over PROFILER_OVERHEAD_GATE; their own cost
    alone reads under it."""
    gate = serve_bench.PROFILER_OVERHEAD_GATE
    assert gate == 0.03
    injected = gate / BATCH_RATE
    loaded = serve_bench._instrument_estimate(
        _timings(OWN_COST_S + injected, drift_per_s=drift))
    assert loaded * BATCH_RATE > gate
    own = serve_bench._instrument_estimate(_timings(OWN_COST_S, drift_per_s=drift))
    assert own * BATCH_RATE <= gate


def test_profiler_row_prints_alternating_rounds_pauses_and_the_hook_time():
    """The card row's additions: each round's order and arms, the
    collector's pauses by arm and the instruments' time inside their hooks;
    the hooks are unpatched and both instruments off after."""
    call, record = profile_mod.DispatchProfiler.call, usage_mod.UsageMeter.record_batch
    row = serve_bench.measure_profiler_overhead(
        rounds=4, dispatch_calls=20, requests=24, clients=2, n_particles=64,
        n_features=4, max_batch=16, device="cpu")
    assert [r["order"] for r in row["instrument_rounds"]] == ["off/on", "on/off"] * 2
    assert all(r["off_us"] > 0 and r["on_us"] > 0 for r in row["instrument_rounds"])
    assert set(row["gc_pauses"]) == {"off", "on"}
    assert set(row["gc_pauses"]["on"]) == {"count", "sum_ms", "max_ms"}
    assert row["instrument_hook_us_per_batch"] > 0
    assert profile_mod.DispatchProfiler.call is call
    assert usage_mod.UsageMeter.record_batch is record
    assert profile_mod._PROFILER is None and not usage_mod.usage_enabled()


def test_hook_time_sees_a_cost_added_inside_the_profiler(monkeypatch):
    """The cross-check times what runs inside the instruments' hooks: 200 µs
    of busy work added to the profiler's call shows up in it."""
    engine = serve_bench.build_engine(n_particles=32, n_features=3, max_bucket=8,
                                      device="cpu")
    base = serve_bench._instrument_hook_s(engine, calls=30, rows=8)
    call = profile_mod.DispatchProfiler.call

    def costly(self, *a, **k):
        end = time.perf_counter() + 200e-6
        while time.perf_counter() < end:
            pass
        return call(self, *a, **k)

    monkeypatch.setattr(profile_mod.DispatchProfiler, "call", costly)
    loaded = serve_bench._instrument_hook_s(engine, calls=30, rows=8)
    assert loaded - base > 150e-6


# --------------------------------------------------------------------- #
# the storm's capacity probe on the card


def test_steady_window_counts_only_between_the_last_start_and_first_finish():
    """Clients that start 0.1 s apart and stop raggedly: over the steady
    window the reading is the pipeline's 100 rows a second; rows over the
    whole wall (a fixed-count sample's reading) under-read it."""
    starts, finishes = [0.0, 0.1, 0.2], [1.25, 1.3, 1.2]
    # 100 rows/s once all three run, 20 rows/s while they start and finish
    completions = [(t, 1) for t in np.arange(0.2, 1.2, 0.01)]
    completions += [(t, 1) for t in np.arange(0.0, 0.2, 0.05)]
    completions += [(t, 1) for t in np.arange(1.2001, 1.3, 0.05)]
    rate, window, rows = wr._steady_window(starts, finishes, completions)
    assert window == pytest.approx(1.0)
    assert rows == 100 and rate == pytest.approx(100.0)
    whole = sum(r for _, r in completions) / (max(finishes) - min(starts))
    assert whole < 0.9 * rate


def _resolved(rows):
    fut = concurrent.futures.Future()
    fut.set_result({"mean": np.zeros(rows)})
    return fut


def test_steady_sample_on_a_fake_submit_and_clock():
    """Every tick of a counting clock inside the window is one completion
    stamp (the starts precede it, the finishes follow it), so it holds
    exactly window − 1 completions of 2 rows; shed requests count nothing
    and every client is stopped and joined."""
    ticks = itertools.count()
    pool = [np.zeros((2, 3), np.float32), "shed", np.zeros((2, 3), np.float32)]
    submitted = []

    def submit(item):
        submitted.append(item)
        if isinstance(item, str):
            raise Overloaded("full")
        return _resolved(item.shape[0])

    sample = wr._steady_sample(submit, pool, clients=4, window_s=0.05,
                               clock=lambda: next(ticks))
    assert sample["window_s"] > 1
    assert sample["rows"] == 2 * (sample["window_s"] - 1)
    assert sample["rows_per_s"] == sample["rows"] / sample["window_s"]
    assert sample["completed"] >= sample["rows"] // 2 > 0
    assert sample["shed"] == sum(isinstance(i, str) for i in submitted) > 0


def test_steady_probe_anchors_on_the_median_sample(monkeypatch):
    monkeypatch.setattr(wr, "PROBE_GAP_S", 0.0)
    log = []
    anchor = wr._steady_rows_capacity(lambda item: _resolved(item.shape[0]),
                                      [np.zeros((4, 3), np.float32)], clients=3,
                                      window_s=0.02, samples=3, log=log)
    rates = [s["rows_per_s"] for s in log[0]["samples"]]
    assert len(rates) == 3 and min(rates) > 0
    assert anchor == log[0]["anchor_rows_per_s"] == pytest.approx(0.55 * np.median(rates))


def test_capacity_probe_is_jax_on_the_cpu_and_the_steady_window_on_the_card(monkeypatch):
    seen = []
    monkeypatch.setattr(wr, "_saturated_rows_capacity",
                        lambda submit, pool, **kw: seen.append(kw) or 1.0)
    cpu = wr.default_capacity_probe(torch.device("cpu"), 240)
    assert cpu(None, []) == 1.0 and seen == [{"requests": 240}]
    assert wr.default_capacity_probe(torch.device("cuda"), 240) is wr._steady_rows_capacity


# --------------------------------------------------------------------- #
# a hot reload's parts, and the capture's collector


def test_reload_parts_are_recorded_and_sum_to_the_reload_wall():
    rng = np.random.default_rng(0)
    reg = serve_bench.telemetry.MetricsRegistry()
    eng = PredictiveEngine("logreg", rng.normal(size=(32, 5)).astype(np.float32),
                           min_bucket=4, max_bucket=16, registry=reg, device="cpu")
    assert eng.last_reload_parts is None
    eng.warmup()
    first = weakref.ref(eng._kernels[4])
    hist = reg.histogram("svgd_engine_reload_wall_s")
    resolution = time.get_clock_info("perf_counter").resolution
    for i in range(3):
        before = hist.summary()["sum"]
        eng.reload(rng.normal(size=(32, 5)).astype(np.float32), tag=f"g{i}")
        parts = eng.last_reload_parts
        steps = {k: v for k, v in parts.items() if k not in ("wall_s", "captures")}
        assert set(steps) == {"check", "place", "build", "warm", "swap", "teardown", "finish"}
        assert min(steps.values()) >= 0
        assert abs(sum(steps.values()) - parts["wall_s"]) <= resolution
        assert hist.summary()["sum"] - before == pytest.approx(parts["wall_s"], abs=1e-3)
        assert parts["captures"] == {**dict.fromkeys(tplan.CAPTURE_PARTS, 0.0), "captures": 0}
    # the cold generation's programs went with the reload that dropped them
    gc.collect()
    assert first() is None


class _FakeGraph:
    def __init__(self, log):
        self.log = log

    def capture_begin(self, capture_error_mode):
        self.log.append(("begin", gc.isenabled(), capture_error_mode))

    def capture_end(self):
        self.log.append(("end", gc.isenabled()))


@pytest.mark.parametrize("enabled", [True, False])
def test_capture_runs_with_the_collector_off_and_restores_it(enabled):
    """C10: no cyclic collection between capture_begin and capture_end —
    one that frees a dropped program's graph there invalidates the
    capture — and the collector as it was after, on success and when the
    captured function raises (the broken capture still ended)."""
    (gc.enable if enabled else gc.disable)()
    try:
        log = []

        def fn(x):
            log.append(("fn", gc.isenabled()))
            return 2 * x

        assert tplan._capture(_FakeGraph(log), None, fn, [3]) == 6
        assert log == [("begin", False, "thread_local"), ("fn", False), ("end", False)]
        assert gc.isenabled() is enabled

        def broken(x):
            log.append(("fn", gc.isenabled()))
            raise RuntimeError("kernel refused")

        log.clear()
        with pytest.raises(RuntimeError, match="refused"):
            tplan._capture(_FakeGraph(log), None, broken, [3])
        assert log == [("begin", False, "thread_local"), ("fn", False), ("end", False)]
        assert gc.isenabled() is enabled
    finally:
        gc.enable()


def test_collector_pauses_records_a_collection_and_unhooks():
    with CollectorPauses() as pauses:
        gc.collect()
    summary = pauses.summary()
    assert summary["count"] >= 1 and summary["full"] >= 1
    assert summary["max_ms"] > 0 and summary["sum_ms"] >= summary["max_ms"]
    assert pauses._callback not in gc.callbacks
    assert CollectorPauses().summary() == {"count": 0, "sum_ms": 0.0, "max_ms": 0.0, "full": 0}


def test_chip_smoke_burst_rates_read_the_arms_records():
    """``chip_smoke.py``'s storm premise figures: the hog's offered rows a
    second in the burst window, and every tenant's rows completed inside
    it."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_for_test", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    row = {"trace": {"steady_s": 1.0, "burst_s": 2.0}, "arms": {"a": {}, "b": {}}}
    records = [
        {"t": 0.5, "rows": 8, "tenant": "hog", "status": "ok", "lat_ms": 100.0},
        {"t": 1.0, "rows": 64, "tenant": "hog", "status": "ok", "lat_ms": 10.0},
        {"t": 2.5, "rows": 32, "tenant": "hog", "status": "shed", "lat_ms": None},
        {"t": 2.9, "rows": 16, "tenant": "hog", "status": "ok", "lat_ms": 200.0},
        {"t": 1.5, "rows": 4, "tenant": "svc-0", "status": "ok", "lat_ms": 5.0},
    ]
    rates = smoke._storm_burst_rates(row, [records, records[:2]])
    assert rates["a"] == {"hog_offered_rows_per_s": (64 + 32 + 16) / 2.0,
                          "served_rows_per_s": (64 + 4) / 2.0}
    assert rates["b"] == {"hog_offered_rows_per_s": 32.0, "served_rows_per_s": 32.0}
