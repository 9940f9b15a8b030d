"""The port's SLO engine (``dist_svgd_torch/telemetry/slo.py``) against
the JAX package's (``tests/test_slo.py``, ``test_diagnostics.py``'s SLO
tests), on the CPU: the same call sequences with injected clocks give the
same evaluation documents and the same registry series."""

import json

import pytest

from dist_svgd_tpu.telemetry import metrics as jmetrics
from dist_svgd_tpu.telemetry import slo as jslo

from dist_svgd_torch.telemetry import metrics as tmetrics
from dist_svgd_torch.telemetry import slo as tslo

from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

PAIRS = ((jmetrics, jslo), (tmetrics, tslo))


def slo_script(mmod, smod):
    """Every objective kind through windows of traffic, a reset and an
    outage; returns the evaluation documents and the final exposition."""
    reg = mmod.MetricsRegistry()
    now = {"t": 100.0}
    h = reg.histogram("t_lat_seconds", buckets=(0.001, 0.01, 0.1, 1.0))
    shed, seg = reg.counter("t_shed_total"), reg.histogram("t_seg_seconds")
    eng = smod.SloEngine(reg, [
        smod.LatencyObjective("p99", "t_lat_seconds", threshold_s=0.1, target=0.9),
        smod.LatencyObjective("p99_a", "t_lat_seconds", 0.01, labels={"tenant": "a"}),
        smod.LatencyObjective("p99_all", "t_lat_seconds", 0.01, aggregate=True),
        smod.RatioObjective("shed", "t_shed_total", "t_seg_seconds", max_ratio=0.5),
        smod.GaugeCeiling("ksd", "svgd_diag_ksd", ceiling=1.0),
        smod.StalenessObjective("fresh", "svgd_diag_last_update_ts", max_age_s=60.0),
        smod.FreshnessObjective("freshness", 30.0),
    ], clock=lambda: now["t"])
    docs = [eng.evaluate()]
    for i in range(98):
        h.observe(0.005)
        h.observe(0.002 * (i % 7), tenant="a")
    h.observe(0.5)
    h.observe(0.5)
    for _ in range(4):
        seg.observe(0.1)
    shed.inc(1)
    reg.gauge("svgd_diag_ksd").set(0.4)
    reg.gauge("svgd_diag_last_update_ts").set(90.0)
    reg.gauge("svgd_stream_watermark").set(100.0)
    reg.gauge("svgd_serving_watermark").set(80.0)
    docs.append(eng.evaluate())
    for _ in range(10):
        h.observe(0.5)
    reg.gauge("svgd_diag_ksd").set(2.0)
    reg.gauge("svgd_stream_watermark").set(140.0)
    now["t"] = 200.0
    shed.inc(3)
    seg.observe(0.1)
    docs.append(eng.evaluate())
    shed.inc(5)  # bad events with a zero base window: a breach, not no_data
    docs.append(eng.evaluate())
    docs.append(eng.burn_rates())
    return docs, reg.exposition()


def test_slo_engine_documents_equal_jax():
    (jdocs, jexpo), (tdocs, texpo) = (slo_script(*p) for p in PAIRS)
    assert tdocs == jdocs and texpo == jexpo
    assert [d["status"] for d in tdocs[:4]] == ["ok", "breach", "breach", "breach"]
    json.dumps(tdocs)


@pytest.mark.parametrize("factory,kw", [
    ("default_serving_slos", dict(p99_ms=50.0)),
    ("default_training_slos", dict(max_ksd=2.0, diag_max_age_s=300.0)),
    ("default_streaming_slos", dict(max_lag_s=60.0)),
    ("default_rollout_slos", dict()),
])
def test_default_objective_sets_equal_jax(factory, kw):
    outs = []
    for mmod, smod in PAIRS:
        reg = mmod.MetricsRegistry()
        reg.gauge("svgd_stream_watermark").set(10.0)
        reg.gauge("svgd_serving_watermark").set(10.0)
        reg.counter("svgd_stream_batches_total").inc(10)
        reg.gauge("svgd_diag_ksd").set(3.0)
        eng = getattr(smod, factory)(reg, clock=lambda: 1000.0, **kw)
        outs.append(([o.name for o in eng.objectives], eng.evaluate(), reg.exposition()))
    assert outs[0] == outs[1]


def test_staleness_and_freshness_edges_equal_jax():
    for args in ((0.0, 1000.0), (2000.0, 1000.0), (1000.0, 1060.0), (1000.0, 1060.5)):
        rows = []
        for mmod, smod in PAIRS:
            reg = mmod.MetricsRegistry()
            obj = smod.StalenessObjective("ckpt", "svgd_ckpt_ts", max_age_s=60.0)
            if args[0]:
                reg.gauge("svgd_ckpt_ts").set(args[0])
            rows.append(obj.evaluate(reg, now_s=args[1]))
        assert rows[0] == rows[1]
    with pytest.raises(ValueError, match="max_age_s"):
        tslo.StalenessObjective("x", "g", max_age_s=0.0)
    with pytest.raises(ValueError, match="max_lag_s"):
        tslo.FreshnessObjective("x", 0.0)
    with pytest.raises(ValueError, match="duplicate"):
        tslo.SloEngine(tmetrics.MetricsRegistry(), [tslo.GaugeCeiling("x", "g", 1.0),
                                                    tslo.GaugeCeiling("x", "g2", 1.0)])


def test_windows_and_bucket_helpers_equal_jax():
    outs = []
    for mmod, smod in PAIRS:
        reg = mmod.MetricsRegistry()
        h = reg.histogram("t_lat_seconds", buckets=(0.01, 0.1, 1.0))
        c = reg.counter("t_req_total")
        hw, cw = smod.HistogramWindow(reg, "t_lat_seconds"), smod.CounterWindow(reg,
                                                                                "t_req_total")
        polls = [hw.poll(0.1), cw.poll()]
        for v in (0.005, 0.05, 0.5, 5.0):
            h.observe(v)
            c.inc(2)
        polls += [hw.poll(0.1), cw.poll(), hw.poll(0.1), cw.poll()]
        polls += [smod.bucket_frac_over((0.01, 0.1, 1.0), [1, 2, 3, 4], 0.1),
                  smod.bucket_quantile((0.01, 0.1, 1.0), [1, 2, 3, 4], 0.5)]
        outs.append(polls)
    assert outs[0] == outs[1]
