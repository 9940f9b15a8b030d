"""The port's posterior diagnostics (``dist_svgd_torch/telemetry/
diagnostics.py``) against the JAX package's (``tests/test_diagnostics.py``)
and the float64 oracle (``tests/_oracle.py``), on the CPU.

The statistics — ``_ksd_stats``, ``_kernel_stats``, ``_shard_stats`` and
``_dim_var_stats``, with a fixed and a median bandwidth — equal JAX's at
1e-10 on the same float64 inputs, and ``_oracle.ksd_u_stat`` /
``kernel_ess``; the chunked pass is invariant to the row chunk (1, 7 and
n); the subsample stride, the report's keys, the ``svgd_diag_*`` gauges,
``ensemble_health``, ``ReloadPolicy.judge`` and a ``GaugeCeiling`` SLO on
``svgd_diag_ksd`` behave as JAX's."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import _oracle
from dist_svgd_tpu.telemetry import diagnostics as jdiag
from dist_svgd_tpu.telemetry import metrics as jmetrics

from dist_svgd_torch import telemetry as ttel
from dist_svgd_torch.telemetry import diagnostics as tdiag
from dist_svgd_torch.telemetry import slo as tslo
from dist_svgd_torch.telemetry.metrics import MetricsRegistry

from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

RTOL = 1e-10


@pytest.fixture
def rng():
    return np.random.default_rng(3)


def floats(block):
    return {k: float(v) for k, v in block.items()}


def assert_stats_equal(got, want, rtol=RTOL):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=rtol, atol=1e-14,
                                   err_msg=k)


@pytest.mark.parametrize("n,d,bw,chunk", [(14, 3, 1.7, 5), (31, 2, 0.6, 7), (9, 5, 3.0, 9)])
@pytest.mark.parametrize("median_bw", [False, True])
def test_ksd_stats_equal_jax_and_oracle(rng, n, d, bw, chunk, median_bw):
    x = rng.normal(size=(n, d))
    s = -x + 0.1 * rng.normal(size=(n, d))
    got = tdiag._ksd_stats(torch.from_numpy(x), torch.from_numpy(s), bw, chunk, median_bw)
    want = jdiag._ksd_stats(jnp.asarray(x), jnp.asarray(s), bw, chunk, median_bw)
    assert_stats_equal(got, want)
    h = float(got["bandwidth"])
    np.testing.assert_allclose(float(got["ksd_sq"]), _oracle.ksd_u_stat(x, s, bandwidth=h),
                               rtol=RTOL)
    np.testing.assert_allclose(float(got["ess"]), _oracle.kernel_ess(x, bandwidth=h),
                               rtol=RTOL)


@pytest.mark.parametrize("n,d,bw,chunk", [(12, 2, 1.0, 5), (40, 4, 2.5, 16)])
@pytest.mark.parametrize("median_bw", [False, True])
def test_kernel_stats_equal_jax_and_oracle(rng, n, d, bw, chunk, median_bw):
    x = rng.normal(size=(n, d))
    got = tdiag._kernel_stats(torch.from_numpy(x), bw, chunk, median_bw)
    assert_stats_equal(got, jdiag._kernel_stats(jnp.asarray(x), bw, chunk, median_bw))
    np.testing.assert_allclose(float(got["ess"]),
                               _oracle.kernel_ess(x, bandwidth=float(got["bandwidth"])),
                               rtol=RTOL)


@pytest.mark.parametrize("S,per,d", [(4, 16, 2), (8, 5, 3), (2, 33, 1)])
def test_shard_and_dim_var_stats_equal_jax(rng, S, per, d):
    x = rng.normal(size=(S * per, d))
    x[per:2 * per] += 3.0  # one drifted shard
    assert_stats_equal(tdiag._shard_stats(torch.from_numpy(x), S),
                       jdiag._shard_stats(jnp.asarray(x), S))
    np.testing.assert_allclose(float(tdiag._dim_var_stats(torch.from_numpy(x))),
                               float(jdiag._dim_var_stats(jnp.asarray(x))), rtol=RTOL)


@pytest.mark.parametrize("chunk", [1, 7, 23])
def test_row_chunk_invariance(rng, chunk):
    """Chunks of 1, 7 and n rows give the unchunked sums (the ragged last
    block holds only real rows)."""
    x = rng.normal(size=(23, 3))
    s = rng.normal(size=(23, 3))
    whole = floats(tdiag._ksd_stats(torch.from_numpy(x), torch.from_numpy(s), 1.3, 23, False))
    got = floats(tdiag._ksd_stats(torch.from_numpy(x), torch.from_numpy(s), 1.3, chunk, False))
    for k in whole:
        assert got[k] == pytest.approx(whole[k], rel=1e-12, abs=1e-15), k


def test_collapse_indicators_and_separation(rng):
    x = rng.normal(size=(16, 3))
    x[7] = x[3]
    x[:, 1] = 0.25
    out = tdiag._kernel_stats(torch.from_numpy(x), 1.0, 8, False)
    assert float(out["min_pairwise_dist"]) == 0.0
    assert float(tdiag._dim_var_stats(torch.from_numpy(x))) == 0.0
    good = rng.normal(size=(64, 2))
    bad = good + 3.0
    k_good = float(tdiag._ksd_stats(torch.from_numpy(good), torch.from_numpy(-good), 1.0, 32,
                                    False)["ksd"])
    k_bad = float(tdiag._ksd_stats(torch.from_numpy(bad), torch.from_numpy(-bad), 1.0, 32,
                                   False)["ksd"])
    assert k_bad > 3 * k_good


def test_subsample_stride_matches_jax(rng):
    x = rng.normal(size=(97, 2))
    for cap in (2, 32, 96, 97, 200):
        np.testing.assert_array_equal(tdiag._subsample(torch.from_numpy(x), cap).numpy(),
                                      np.asarray(jdiag._subsample(jnp.asarray(x), cap)))


@pytest.mark.parametrize("bandwidth,scores", [(1.0, "fn"), ("median", "array"),
                                              (2.0, None)])
def test_compute_report_and_gauges_equal_jax(rng, bandwidth, scores):
    """``PosteriorDiagnostics.compute`` on both packages: the same report
    (wall aside) and the same ``svgd_diag_*`` gauges, with the score
    closure, passed scores, or none; past max_points on the subsample."""
    x = rng.normal(size=(96, 2))
    s = -x + 0.05
    jreg, treg = jmetrics.MetricsRegistry(), MetricsRegistry()
    jcfg = jdiag.DiagnosticsConfig(every_steps=4, bandwidth=bandwidth, max_points=32,
                                   row_chunk=16,
                                   score_fn=(lambda th: -th + 0.05) if scores == "fn" else None)
    tcfg = tdiag.DiagnosticsConfig(every_steps=4, bandwidth=bandwidth, max_points=32,
                                   row_chunk=16,
                                   score_fn=(lambda th: -th + 0.05) if scores == "fn" else None)
    jpd = jdiag.PosteriorDiagnostics(jcfg, registry=jreg, wall_clock=lambda: 7.0)
    tpd = tdiag.PosteriorDiagnostics(tcfg, registry=treg, wall_clock=lambda: 7.0)
    kw = dict(num_shards=4, step=8)
    want = jpd.compute(jnp.asarray(x), scores=jnp.asarray(s) if scores == "array" else None, **kw)
    got = tpd.compute(torch.from_numpy(x), scores=torch.from_numpy(s) if scores == "array"
                      else None, **kw)
    assert set(got) == set(want)
    for k, v in want.items():
        if k != "wall_s":
            assert got[k] == pytest.approx(v, rel=RTOL, abs=1e-14), k
    assert got["n"] == 96 and got["n_eval"] == 32 and ("ksd" in got) == (scores is not None)
    for name in ("ess", "ess_frac", "min_pairwise_dist", "median_pairwise_dist",
                 "min_dim_var", "shard_mean_div", "shard_var_div", "last_step",
                 "last_update_ts", "ksd"):
        g = f"svgd_diag_{name}"
        assert treg.gauge(g).value() == pytest.approx(jreg.gauge(g).value(), rel=RTOL), g
    assert treg.counter("svgd_diag_computations_total").value() == 1
    assert treg.histogram("svgd_diag_compute_seconds").summary()["count"] == 1
    assert tpd.last_report is got and not tpd.should_run(5) and tpd.should_run(8)


def test_score_closure_adopted_per_instance_and_traced(rng):
    x = rng.normal(size=(20, 2))
    cfg = tdiag.DiagnosticsConfig(every_steps=1, max_points=20)
    pd = tdiag.PosteriorDiagnostics(cfg, registry=MetricsRegistry())
    assert "ksd" not in pd.compute(x)
    score = torch.func.grad(lambda th: -0.5 * (th * th).sum())
    pd.ensure_score_fn(score)
    assert cfg.score_fn is None  # the shared config is never mutated
    tracer = ttel.enable()
    rec = ttel.install_flight_recorder(ttel.FlightRecorder(registry=MetricsRegistry()))
    try:
        rep = pd.compute(torch.from_numpy(x), step=3)
    finally:
        ttel.disable()
        ttel.uninstall_flight_recorder()
    want = _oracle.ksd_u_stat(x, -x, bandwidth=1.0)
    assert rep["ksd_sq"] == pytest.approx(want, rel=RTOL)
    spans = [e for e in tracer.chrome_events() if e["ph"] == "X"]
    assert [e["name"] for e in spans] == ["train.diagnostics"]
    assert spans[0]["args"] == {"step": 3, "n": 20}
    assert rec.last_diagnostics["ksd_sq"] == rep["ksd_sq"]


def test_float32_long_sum_held_against_float64(rng):
    """At float32 the chunked sums stay near the float64 value of the same
    function (the card's dtype against its own f64, not itself)."""
    x = rng.normal(size=(600, 3))
    s = -x
    f64 = floats(tdiag._ksd_stats(torch.from_numpy(x), torch.from_numpy(s), 1.0, 128, False))
    f32 = floats(tdiag._ksd_stats(torch.from_numpy(x).float(), torch.from_numpy(s).float(),
                                  1.0, 128, False))
    for k in ("ksd", "ess", "min_pairwise_dist"):
        assert f32[k] == pytest.approx(f64[k], rel=1e-4), k


def test_ensemble_health_equal_jax_and_reload_policy(rng):
    x = rng.normal(size=(200, 3))
    got = tdiag.ensemble_health(x, max_points=50)
    want = jdiag.ensemble_health(jnp.asarray(x), max_points=50)
    assert set(got) == set(want)
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=RTOL), k
    pol, jpol = (mod.ReloadPolicy(min_ess_frac=0.05, max_ess_drop_frac=0.5, min_dim_var=1e-8,
                                  max_points=50) for mod in (tdiag, jdiag))
    assert pol.evaluate(x) == pytest.approx(got)
    cases = [(got, None), (dict(got, ess_frac=got["ess_frac"] * 0.3), got),
             (dict(got, ess_frac=float("nan")), None), (dict(got, min_dim_var=0.0), got),
             (dict(got, ess_frac=0.01), None)]
    for cand, base in cases:
        assert pol.judge(cand, base) == jpol.judge(cand, base)
    assert pol.judge(*cases[1]) and "dropped past" in pol.judge(*cases[1])[0]
    assert pol.judge(got, None) == []


def test_ksd_gauge_ceiling_slo(rng):
    """The posterior-convergence SLO: a GaugeCeiling on svgd_diag_ksd over
    the diagnostics' own gauge, with a diagnostics-freshness bound."""
    reg = MetricsRegistry()
    now = {"t": 100.0}
    eng = tslo.default_training_slos(reg, max_ksd=0.5, diag_max_age_s=60.0,
                                     clock=lambda: now["t"])
    assert eng.evaluate()["objectives"]["ksd_ceiling"]["status"] == "no_data"
    pd = tdiag.PosteriorDiagnostics(tdiag.DiagnosticsConfig(score_fn=lambda th: -th),
                                    registry=reg, wall_clock=lambda: 90.0)
    good = rng.normal(size=(64, 2))
    pd.compute(good, step=1)
    doc = eng.evaluate()["objectives"]
    assert doc["ksd_ceiling"]["status"] == "ok" and doc["diag_freshness"]["status"] == "ok"
    pd.compute(good + 4.0, step=2)
    now["t"] = 200.0
    doc = eng.evaluate()["objectives"]
    assert doc["ksd_ceiling"]["status"] == "breach"
    assert doc["diag_freshness"]["status"] == "breach"


def test_config_validation_and_disabled_singleton():
    for kw, match in ((dict(every_steps=0), "every_steps"), (dict(bandwidth=-1.0), "bandwidth"),
                      (dict(row_chunk=0), "row_chunk"), (dict(max_points=1), "max_points")):
        with pytest.raises(ValueError, match=match):
            tdiag.DiagnosticsConfig(**kw)
    with pytest.raises(ValueError, match="n >= 2"):
        tdiag.PosteriorDiagnostics(registry=MetricsRegistry()).compute(np.zeros((1, 2)))
    with pytest.raises(ValueError, match="n>=2"):
        tdiag.ensemble_health(np.zeros((1, 2)))
    d = tdiag.DISABLED
    assert not d.enabled and d.last_report is None and not d.should_run(50)
    assert d.compute(np.zeros((4, 2))) is None and d.ensure_score_fn(None) is d


def test_default_device_rule_not_needed_for_cpu_tensors(rng):
    """The statistics run on the tensors' device: CPU tensors stay on the
    CPU (no card is asked for)."""
    x = torch.from_numpy(rng.normal(size=(10, 2)))
    out = tdiag._kernel_stats(x, 1.0, 4, False)
    assert all(v.device.type == "cpu" for v in out.values())
    assert jax.devices()[0].platform == "cpu"
