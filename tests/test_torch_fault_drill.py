"""The port's fault drill (``dist_svgd_torch/tools/fault_drill.py``) and
resilient Covertype driver (``dist_svgd_torch/experiments/
resilient_covertype.py``) against JAX's (``tools/fault_drill.py``,
``experiments/resilient_covertype.py``), on the CPU at shrunk sizes.

The drill's ``fault_recovery`` row has JAX's keys and passes its own
correctness gates, with the same kill step, last checkpoint, steps lost and
checkpoint counts as JAX's row at the same size; the diagnostics A/B row
has JAX's keys.  The driver's stages 1–3 give JAX's ``status``, ``t``,
``checkpoints`` and ``resumed_from`` and a bitwise resume, and its serving
stages 4–5 JAX's ``serve`` keys, cold-start size and hot-reload step; JAX's
driver is imported from ``experiments/`` and run in process."""

import contextlib
import importlib.util
import io
import json
import sys
from pathlib import Path

import pytest

from dist_svgd_torch.experiments import resilient_covertype as trc
from dist_svgd_torch.tools import fault_drill as tdrill

from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

ROOT = Path(__file__).resolve().parents[1]
#: The shrunk drill: n = 64 on 2 shards, 12 steps, checkpoints every 4.
DRILL = dict(n=64, num_shards=2, num_steps=12, checkpoint_every=4, segment_steps=2)
#: The shrunk driver's command line (port and JAX alike, less the device).
DRIVER_ARGS = ["--nrows", "2000", "--nproc", "2", "--nparticles", "64", "--niter", "12",
               "--checkpoint-every", "4", "--segment-steps", "2", "--kill-step", "6"]
#: The shrunk diagnostics-on/off A/B.
DIAG_AB = dict(n=32, num_shards=2, num_steps=8, segment_steps=2, every_steps=4, rounds=1)


def _load(name, path, monkeypatch, extra_path):
    monkeypatch.syspath_prepend(str(extra_path))
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jax_drill():
    with pytest.MonkeyPatch.context() as mp:
        yield _load("jax_fault_drill", ROOT / "tools" / "fault_drill.py", mp, ROOT / "tools")


@pytest.fixture(scope="module")
def jax_rows(jax_drill, tmp_path_factory):
    """JAX's drill row and diagnostics A/B row at the shrunk sizes."""
    row = jax_drill.run_drill(root=str(tmp_path_factory.mktemp("jax_drill")),
                              diag_overhead=False, **DRILL)
    return row, jax_drill.measure_diagnostics_overhead(**DIAG_AB)


@pytest.fixture(scope="module")
def jax_driver_line(tmp_path_factory):
    """JAX's resilient Covertype driver, in process, at the shrunk size."""
    with pytest.MonkeyPatch.context() as mp:
        jmod = _load("jax_resilient_covertype", ROOT / "experiments" / "resilient_covertype.py",
                     mp, ROOT / "experiments")
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            jmod.cli.main(DRIVER_ARGS + ["--backend", "cpu",
                                         "--root", str(tmp_path_factory.mktemp("jax_rc"))],
                          standalone_mode=False)
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def test_drill_row_has_jax_keys_and_passes_its_gates(tmp_path, jax_rows):
    row = tdrill.run_drill(root=str(tmp_path / "port"), diag_overhead=False, device="cpu",
                           **DRILL)
    want = jax_rows[0]
    assert set(row) == set(want)
    assert row["metric"] == "fault_recovery" and row["platform"] == "cpu"
    for key in ("sampler", "n", "num_shards", "num_steps", "checkpoint_every",
                "segment_steps", "checkpoints", "kill_step", "last_checkpoint_step",
                "steps_lost", "resumed_bitwise_identical", "retry_backoff_recovered",
                "nan_rollback_recovered", "diagnostics_per_run", "diagnostics_overhead",
                "slo_status"):
        assert row[key] == want[key], key
    assert row["kill_step"] == 10 and row["last_checkpoint_step"] == 8
    assert row["steps_lost"] == 2
    assert row["resumed_bitwise_identical"] and row["retry_backoff_recovered"]
    assert row["nan_rollback_recovered"]
    assert row["ksd"] > 0 and row["ess"] > 1 and 0 < row["ess_frac"] <= 1
    assert row["slo_status"] == "ok" and set(row["slo"]) == set(want["slo"])
    assert set(row["checkpoint_ms_hist"]) == set(want["checkpoint_ms_hist"])
    assert row["restarts_total"] == want["restarts_total"] == 2
    json.dumps(row)


def test_drill_kill_step_validation_matches_jax(tmp_path, jax_drill):
    kw = dict(DRILL, kill_step=12)
    with pytest.raises(ValueError, match="kill_step") as ours:
        tdrill.run_drill(root=str(tmp_path), diag_overhead=False, device="cpu", **kw)
    with pytest.raises(ValueError, match="kill_step") as theirs:
        jax_drill.run_drill(root=str(tmp_path), diag_overhead=False, **kw)
    assert str(ours.value) == str(theirs.value)


def test_diagnostics_overhead_row_has_jax_keys(jax_rows):
    row = tdrill.measure_diagnostics_overhead(device="cpu", **DIAG_AB)
    want = jax_rows[1]
    assert set(row) == set(want) and row["metric"] == "diagnostics_overhead"
    assert row["overhead_frac"] >= 0 and row["wall_on_s"] > 0


def test_drill_cli_prints_the_row_and_exits_on_its_gates(tmp_path, capsys):
    rc = tdrill.main(["--device", "cpu", "--n", "64", "--shards", "2", "--steps", "12",
                      "--checkpoint-every", "4", "--segment-steps", "2",
                      "--no-diag-overhead", "--root", str(tmp_path)])
    row = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and row["metric"] == "fault_recovery" and row["n"] == 64


def test_resilient_covertype_stages_equal_jax(tmp_path, jax_driver_line):
    """The five stages at the shrunk size: JAX's status, t, checkpoints and
    resumed_from, a bitwise resume; the serve key with JAX's keys, the kill
    run's cold start hot-reloaded to the resumed run's last step, served
    means at the direct call's, the final accuracy."""
    want = jax_driver_line
    out, reports = trc.run(nrows=2000, nproc=2, nparticles=64, niter=12, checkpoint_every=4,
                           segment_steps=2, kill_step=6, root=str(tmp_path / "port"),
                           device="cpu")
    for stage, keys in (("reference", ("status", "t", "checkpoints")),
                        ("kill", ("status", "t")),
                        ("resume", ("status", "resumed_from", "bitwise_identical",
                                    "max_abs_dev_vs_uninterrupted"))):
        assert set(out[stage]) == set(want[stage]), stage
        assert {k: out[stage][k] for k in keys} == {k: want[stage][k] for k in keys}, stage
    assert out["kill"] == {"status": "preempted", "t": 6}
    assert out["resume"]["resumed_from"] == 6 and out["resume"]["bitwise_identical"]
    assert set(out) == set(want) and set(out["serve"]) == set(want["serve"])
    serve = out["serve"]
    for key in ("cold_start_particles", "hot_reload_step", "reloads", "ensemble_tag"):
        assert serve[key] == want["serve"][key], key
    assert serve["hot_reload_step"] == 12 and serve["reloads"] == 1
    assert serve["served_vs_direct_max_abs_dev"] <= 1e-6
    assert 0.0 <= serve["test_acc_final"] <= 1.0 and 0.0 <= serve["served_test_acc"] <= 1.0
    assert reports["engine"].stats()["ensemble_tag"] == "step_12"
    for key in ("nrows", "nproc", "nparticles", "niter", "checkpoint_every", "segment_steps"):
        assert out[key] == want[key], key
    assert reports["reference"]["steps_run"] == 12 and reports["resume"]["steps_run"] == 6


def test_resilient_covertype_cli(tmp_path, capsys):
    rc = trc.main(DRIVER_ARGS + ["--device", "cpu", "--root", str(tmp_path), "--requests", "8"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and out["resume"]["bitwise_identical"] and out["root"] == str(tmp_path)
    assert out["serve"]["hot_reload_step"] == 12
    assert sorted(p.name for p in tmp_path.iterdir()) == ["killed", "reference"]
    with pytest.raises(SystemExit):
        trc.main(["--nproc", "0", "--device", "cpu"])
    assert sys.modules["dist_svgd_torch.experiments.resilient_covertype"] is trc
