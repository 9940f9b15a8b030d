"""The port's streaming Covertype driver
(``dist_svgd_torch/experiments/streaming_covertype.py``) and freshness drill
(``dist_svgd_torch/tools/freshness_drill.py``) against JAX's
``experiments/streaming_covertype.py`` and ``tools/freshness_drill.py``,
each run in process at a shrunk size, on the CPU.

The driver's line carries JAX's keys, and its stream counters (segments,
ordinals, rows ingested, dropped, watermark) equal JAX's: they depend on
the stream's schedule, not on the trajectory.  The drill's row carries
JAX's keys, its kill → cold resume is bitwise, its capture accounting
balances, ``row_ok`` gives JAX's verdicts on the same rows, and ``main``
exits by it.  Without CUDA both entry points raise unless asked for the
CPU."""

import contextlib
import importlib.util
import io
import json
from pathlib import Path

import pytest

from dist_svgd_torch.experiments import streaming_covertype as tsc
from dist_svgd_torch.tools import freshness_drill as tfd

from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

ROOT = Path(__file__).resolve().parents[1]

#: The shrunk driver (JAX's flags; the port's ``run`` takes the same names).
DRIVER = dict(nrows=2000, nparticles=32, batch_rows=128, corpus_rows=256, batch_size=64,
              steps_per_segment=4, refit_factor=2, segments=4, warmup_segments=4,
              drift_at=1)
#: The shrunk drill (``run_drill``'s arguments, both packages).
DRILL = dict(n_particles=64, dim=3, batch_rows=32, corpus_rows=128, batch_size=32,
             steps_per_segment=4, refit_factor=2, period_s=0.05, steady_segments=6,
             warmup_segments=4, drift_after=1)
#: The same as ``main``'s flags.
DRILL_ARGS = ["--n", "64", "--dim", "3", "--batch-rows", "32", "--corpus-rows", "128",
              "--batch-size", "32", "--steps-per-segment", "4", "--refit-factor", "2",
              "--period", "0.05", "--steady-segments", "6", "--warmup-segments", "4",
              "--drift-after", "1"]


def _load(name, path, monkeypatch, extra_path):
    monkeypatch.syspath_prepend(str(extra_path))
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _keys(doc, prefix=""):
    """Every key path of a nested dict (values of leaf dicts included)."""
    out = set()
    for k, v in doc.items():
        out.add(prefix + k)
        if isinstance(v, dict):
            out |= _keys(v, prefix + k + ".")
    return out


@pytest.fixture(scope="module")
def jax_driver_line(tmp_path_factory):
    """JAX's streaming Covertype CLI, in process, at the shrunk size."""
    with pytest.MonkeyPatch.context() as mp:
        jmod = _load("jax_streaming_covertype", ROOT / "experiments" / "streaming_covertype.py",
                     mp, ROOT / "experiments")
        args = [f"--{k.replace('_', '-')}={v}" for k, v in DRIVER.items()]
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            jmod.cli.main(args + ["--backend", "cpu",
                                  "--root", str(tmp_path_factory.mktemp("jax_sc"))],
                          standalone_mode=False)
    return json.loads(buf.getvalue().strip().splitlines()[-1])


@pytest.fixture(scope="module")
def jax_drill():
    with pytest.MonkeyPatch.context() as mp:
        yield _load("jax_freshness_drill", ROOT / "tools" / "freshness_drill.py", mp, ROOT)


@pytest.fixture(scope="module")
def jax_drill_row(jax_drill, tmp_path_factory):
    return jax_drill.run_drill(root=str(tmp_path_factory.mktemp("jax_fd")), **DRILL)


@pytest.fixture(scope="module")
def port_drill_row(tmp_path_factory):
    return tfd.run_drill(root=str(tmp_path_factory.mktemp("port_fd")), device="cpu", **DRILL)


def test_driver_line_matches_jax(tmp_path, jax_driver_line):
    """The port's line: JAX's keys, and the stream's schedule counters equal
    JAX's; one reload a segment, nothing dropped, the SLOs ok."""
    out = tsc.run(root=str(tmp_path / "port"), device="cpu", **DRIVER)
    want = jax_driver_line
    assert _keys(out) == _keys(want)
    for key in ("segments", "ordinals", "rows_ingested", "dropped", "watermark"):
        assert out["stream"][key] == want["stream"][key], key
    for key in ("nrows", "nparticles", "batch_rows", "corpus_rows", "period_s",
                "steps_per_segment"):
        assert out[key] == want[key], key
    assert out["serve"]["reloads"] == out["stream"]["segments"] == want["serve"]["reloads"]
    assert out["serve"]["ensemble_tag"] == f"step_{out['stream']['t']}"
    assert out["stream"]["dropped"] == 0 and out["slo_status"] == "ok"
    acc, flipped = (out["serve"]["served_test_acc"],
                    out["serve"]["served_test_acc_flipped_concept"])
    assert acc + flipped == pytest.approx(1.0)
    assert out["calibration"]["ksd_threshold"] == pytest.approx(
        2.0 * out["calibration"]["ksd_baseline"], abs=2e-3)


def test_driver_main_prints_one_json_line(tmp_path, capsys):
    """``main`` with ``--device cpu`` prints the line and exits 0; its flag
    names are JAX's (less ``--backend``)."""
    args = [f"--{k.replace('_', '-')}={v}" for k, v in DRIVER.items()]
    assert tsc.main(args + ["--device", "cpu", "--root", str(tmp_path)]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert line["root"] == str(tmp_path) and line["stream"]["segments"] > 0


def test_drill_row_has_jax_keys_and_resumes_bitwise(port_drill_row, jax_drill_row):
    """The drill's row: JAX's keys (nested included), the bitwise
    kill → cold resume, no drop, the shrunk geometry, and the capture
    accounting: every capture in the steady window is a reload's staged
    program."""
    row, want = port_drill_row, jax_drill_row
    assert _keys(row) == _keys(want)
    assert row["resumed_bitwise_identical"] is True and want["resumed_bitwise_identical"]
    assert row["platform"] == "cpu" and row["dropped_total"] == 0
    for key in ("metric", "n", "dim", "batch_rows", "corpus_rows", "batch_size",
                "steps_per_segment", "refit_steps", "period_s", "bitwise_segments",
                "segments", "sentry_supported"):
        assert row[key] == want[key], key
    assert row["steady_state_recompiles"] == 0
    assert row["sentry_compiles"] == row["expected_reload_compiles"] == row["reloads"]
    assert row["freshness_count"] >= 1 and row["reload_wall_ms_hist"]["count"] >= 1
    json.dumps(row)


def _variants(row):
    yield row
    for key, value in (("dropped_total", 2), ("resumed_bitwise_identical", False),
                       ("drift_detected", False), ("drift_retrained", False),
                       ("steady_state_recompiles", 3), ("slo_status", "breach"),
                       ("freshness_p99_s", None)):
        yield {**row, key: value}
    yield {**row, "drift_detected": True, "drift_retrained": True}


def test_row_ok_gives_jax_verdicts(jax_drill, port_drill_row, jax_drill_row):
    """On the same rows — both drills' and each gate broken in turn — the
    port's ``row_ok`` gives JAX's ``(ok, why)``."""
    for base in (port_drill_row, jax_drill_row):
        for row in _variants(base):
            assert tfd.row_ok(row) == jax_drill.row_ok(row)


def test_drill_main_exits_by_row_ok(tmp_path, capsys):
    """``main --device cpu``: one row on stdout, exit 0 exactly when
    ``row_ok`` passes it (the failing gates on stderr otherwise)."""
    code = tfd.main(DRILL_ARGS + ["--device", "cpu", "--root", str(tmp_path)])
    captured = capsys.readouterr()
    row = json.loads(captured.out.strip().splitlines()[-1])
    ok, why = tfd.row_ok(row)
    assert code == (0 if ok else 1)
    if not ok:
        assert json.loads(captured.err.strip().splitlines()[-1])["why"] == why


def test_entry_points_refuse_the_cpu_without_asking(monkeypatch):
    """Without CUDA and without ``--device cpu``, the driver and the drill
    raise before any work instead of running on the CPU."""
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tsc.main([])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tfd.main([])
