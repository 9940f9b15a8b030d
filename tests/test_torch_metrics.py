"""The port's metrics (``dist_svgd_torch/utils/metrics.py``) against the JAX
package's (``tests/test_metrics.py``), on the CPU: ``particle_stats``
against JAX's at 1e-12 (float64, the same reductions), the JSONL lines
byte for byte apart from the timestamp, the fenced timer and the profiler
trace."""

import io
import json
import os
import time

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from dist_svgd_tpu.utils import metrics as jm

from dist_svgd_torch.utils import metrics as tm

from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

#: particle_stats against JAX's in float64: the same norms and means.
RTOL = 1e-12


def test_jsonl_logger_file_and_stream(tmp_path):
    path = str(tmp_path / "m.jsonl")
    buf = io.StringIO()
    with tm.JsonlLogger(path=path, stream=buf) as lg:
        lg.log(step=1, value=2.5)
        lg.log(step=2, arr=np.arange(3), npfloat=np.float32(1.5),
               tensor=torch.tensor([1.0, 2.0]), scalar=torch.tensor(3.0))
    lines = open(path).read().strip().splitlines()
    assert len(lines) == 2 and buf.getvalue().strip().splitlines() == lines
    rec = json.loads(lines[1])
    assert rec["arr"] == [0, 1, 2] and rec["npfloat"] == 1.5
    assert rec["tensor"] == [1.0, 2.0] and rec["scalar"] == 3.0
    assert "ts" in rec


def test_jsonl_lines_equal_jax_lines(tmp_path, monkeypatch):
    """The same records give the same bytes in both loggers (the clock
    pinned: ``ts`` is the one field that differs between two calls)."""
    monkeypatch.setattr(time, "time", lambda: 1234.56789)
    record = dict(step=7, wall_s=0.0123, updates_per_sec=4567.8, arr=np.arange(2),
                  x=np.float64(0.25))
    out = {}
    for name, mod in (("port", tm), ("jax", jm)):
        path = str(tmp_path / f"{name}.jsonl")
        with mod.JsonlLogger(path=path) as lg:
            lg.log(**record)
        out[name] = open(path, "rb").read()
    assert out["port"] == out["jax"]


def test_jsonl_logger_appends_closes_and_refuses_after_close(tmp_path):
    path = str(tmp_path / "m.jsonl")
    for a in (1, 2):
        with tm.JsonlLogger(path=path, fsync=True) as lg:
            lg.log(a=a)
            lg.flush()
    assert len(open(path).read().strip().splitlines()) == 2
    lg.close()  # idempotent
    assert lg.closed
    with pytest.raises(ValueError, match="after close"):
        lg.log(a=3)
    with pytest.raises(TypeError):
        tm._json_default(object())


@pytest.mark.parametrize("with_prev", [True, False])
def test_particle_stats_match_jax(with_prev):
    rng = np.random.default_rng(3)
    parts, prev = rng.normal(size=(32, 5)), rng.normal(size=(32, 5))
    ours = tm.particle_stats(torch.from_numpy(parts),
                             torch.from_numpy(prev) if with_prev else None)
    theirs = jm.particle_stats(jnp.asarray(parts), jnp.asarray(prev) if with_prev else None)
    assert ours.keys() == theirs.keys()
    for k in ours:
        assert isinstance(ours[k], float)
        np.testing.assert_allclose(ours[k], theirs[k], rtol=RTOL)
    assert ("mean_update" in ours) == with_prev


def test_particle_stats_values():
    out = tm.particle_stats(torch.tensor([[3.0, 4.0], [0.0, 0.0]]),
                            torch.tensor([[3.0, 4.0], [1.0, 0.0]]))
    assert out["particle_mean_norm"] == pytest.approx(2.5)
    assert out["particle_norm_std"] == pytest.approx(2.5)
    assert out["particle_mean"] == pytest.approx(7.0 / 4)
    assert out["mean_update"] == pytest.approx(0.5)
    assert out["max_update"] == pytest.approx(1.0)


def test_step_timer_rates():
    from dist_svgd_torch import telemetry

    tracer = telemetry.enable()
    t = tm.StepTimer(span_name="train.step")  # a lap starts after the tracer's epoch
    try:
        time.sleep(0.01)
        lap = t.mark(torch.ones(4))  # a CPU tensor: no fence
    finally:
        telemetry.disable()
    assert lap >= 0.01
    assert tracer.counts() == {"train.step": 1}  # each lap is a completed span
    (span,) = [e for e in tracer.chrome_events() if e["ph"] == "X"]
    assert span["dur"] == pytest.approx(lap * 1e6, rel=1e-3, abs=1.0)
    t.mark()
    assert t.total == pytest.approx(sum(t.laps))
    assert t.updates_per_sec(100) == pytest.approx(len(t.laps) * 100 / t.total)
    assert tm.StepTimer().updates_per_sec(10) == 0.0


def test_profiler_trace_noop_and_real(tmp_path):
    with tm.profiler_trace(None):
        pass
    logdir = str(tmp_path / "trace")
    with tm.profiler_trace(logdir):
        torch.ones(8).sum()
    trace = json.load(open(os.path.join(logdir, "trace.json")))
    assert "traceEvents" in trace
