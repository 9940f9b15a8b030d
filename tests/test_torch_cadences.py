"""The port's drivers with their checkpoint, metrics and lagged options, on
the CPU at small sizes:
the Covertype cadences (checkpoints, JSONL metrics, the profiler trace,
resume) against JAX's driver (``experiments/covertype.py``), its lagged
exchange, the BNN driver's lagged exchange, and the port's
``tools/large_n.py`` record against JAX's tool.

Tolerances: a resume is bitwise the uninterrupted run (rtol 0); the
Covertype driver's lagged run equals a ``DistSampler`` driven directly,
bitwise; the BNN driver's lagged run is deterministic, bitwise."""

import importlib.util
import json
import os
from pathlib import Path

import numpy as np
import pytest
import torch

from dist_svgd_torch.distsampler import W2_GLOBAL_PAIRING_MAX_N
from dist_svgd_torch.experiments import bnn as tbnn_drv
from dist_svgd_torch.experiments import covertype as tcov
from dist_svgd_torch.tools import large_n

from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

ROOT = Path(__file__).resolve().parents[1]
SMALL = dict(nrows=1200, nproc=4, nparticles=32, batch_size=64, device="cpu")
#: The keys of a line of JAX's Covertype metrics log.
JSONL_KEYS = {"ts", "step", "wall_s", "updates_per_sec", "particle_mean_norm",
              "particle_norm_std", "particle_mean", "mean_update", "max_update"}


def _load(name, path, monkeypatch, extra_path=None):
    if extra_path is not None:
        monkeypatch.syspath_prepend(str(extra_path))
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_covertype(monkeypatch):
    return _load("jax_covertype", ROOT / "experiments" / "covertype.py", monkeypatch,
                 ROOT / "experiments")


@pytest.mark.parametrize("kw", [dict(), dict(phi_impl="torch"), dict(bandwidth="median"),
                                dict(exchange_every=2)])
def test_results_and_checkpoint_names_match_jax(tmp_path, monkeypatch, kw):
    """The results directory, and so the default checkpoint directory
    ``<results>-ckpt``, is named as JAX names it (``-T=`` included)."""
    jmod = _jax_covertype(monkeypatch)
    monkeypatch.setattr(jmod, "RESULTS_DIR", str(tmp_path / "jax"))
    args = (50_000, 8, 10_000, 200, 1e-4, 256, "all_particles", True, 0)
    extra = (kw.get("phi_impl", "auto"), kw.get("bandwidth", "1.0"),
             kw.get("exchange_every", 1))
    ours = tcov.get_results_dir(tmp_path / "port", *args, *extra)
    theirs = jmod.get_results_dir(*args, *extra)
    assert ours.name == os.path.basename(theirs)


def test_cadences_log_checkpoint_and_resume_bitwise(tmp_path, monkeypatch):
    """--checkpoint-every 4 --log-every 2 over 8 steps: JAX's JSONL keys at
    JAX's steps, checkpoints at 4 and 8, the trajectory unchanged by the
    cadences, and a resume from step 4 bitwise the uninterrupted run."""
    plain, _ = tcov.run(niter=8, **SMALL)
    ck = str(tmp_path / "ck")
    final, m = tcov.run(niter=8, checkpoint_every=4, checkpoint_dir=ck, log_every=2,
                        metrics_path=str(tmp_path / "m.jsonl"), **SMALL)
    np.testing.assert_array_equal(final, plain)
    lines = [json.loads(ln) for ln in open(tmp_path / "m.jsonl")]
    assert [ln["step"] for ln in lines] == [2, 4, 6, 8]
    assert all(set(ln) == JSONL_KEYS for ln in lines)
    jmod = _jax_covertype(monkeypatch)
    jmod.run(nrows=1200, nproc=4, nparticles=32, batch_size=64, niter=4, log_every=2,
             metrics_path=str(tmp_path / "j.jsonl"))
    jlines = [json.loads(ln) for ln in open(tmp_path / "j.jsonl")]
    assert [set(ln) for ln in jlines] == [JSONL_KEYS] * 2
    assert sorted(os.listdir(ck)) == ["step_4", "step_8"]
    os.rename(os.path.join(ck, "step_8"), str(tmp_path / "moved"))  # newest: step 4
    resumed, m2 = tcov.run(niter=8, resume=True, checkpoint_dir=ck, **SMALL)
    assert m2["resumed_from"] == 4 and m2["steps_run"] == 4
    np.testing.assert_array_equal(resumed, plain)
    assert m["resumed_from"] == 0 and m["steps_run"] == 8


def test_cli_default_checkpoint_dir_resume_and_profile(tmp_path, capsys):
    """The CLI's checkpoints go to ``<results dir>-ckpt``; --resume there
    finds the newest; --profile-dir writes a Chrome trace."""
    base = ["--device", "cpu", "--nrows", "1200", "--nproc", "4", "--nparticles", "32",
            "--niter", "6", "--batch-size", "64", "--results-dir", str(tmp_path)]
    assert tcov.main(base + ["--checkpoint-every", "3", "--log-every", "3",
                             "--profile-dir", str(tmp_path / "prof")]) == 0
    first = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    name = "covertype-1200-4-32-6-0.0001-64-all_particles-shard-0"
    assert sorted(os.listdir(tmp_path / f"{name}-ckpt")) == ["step_3", "step_6"]
    assert len(open(tmp_path / name / "metrics.jsonl").read().splitlines()) == 2
    assert os.path.exists(tmp_path / "prof" / "trace.json")
    assert tcov.main(base + ["--resume"]) == 0
    again = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert again["resumed_from"] == 6 and again["steps_run"] == 0
    assert again["test_acc"] == first["test_acc"]


def test_covertype_lagged_equals_the_sampler_driven_directly():
    final, m = tcov.run(niter=4, exchange_every=2, **SMALL)
    sampler, _, info = tcov.make_sampler(1200, 4, 32, 64, device="cpu", exchange_every=2)
    want = sampler.run_steps(4, 1e-4)
    np.testing.assert_array_equal(final, want.numpy())
    assert m["exchange_every"] == 2 and sampler.last_run_stats["num_dispatches"] == 2


def test_bnn_lagged_driver_is_deterministic_and_lagged():
    kw = dict(dataset="yacht", nparticles=16, n_hidden=4, device="cpu", nproc=2,
              batch_size=10, niter=4)
    final, m = tbnn_drv.run(exchange_every=2, **kw)
    assert np.isfinite(final).all() and m["exchange_every"] == 2
    again, _ = tbnn_drv.run(exchange_every=2, **kw)
    np.testing.assert_array_equal(final, again)
    fresh, _ = tbnn_drv.run(exchange_every=1, **kw)
    assert not np.array_equal(final, fresh)  # the stale views move it elsewhere


def test_large_n_w2_record_at_tiny_n(tmp_path, capsys):
    out = str(tmp_path / "rows.jsonl")
    assert large_n.main(["--device", "cpu", "--n", "32", "--shards", "4", "--w2",
                         "--exchange-impl", "ring", "--hops-per-dispatch", "2",
                         "--max-passes-per-dispatch", "20", "--sinkhorn-iters", "40",
                         "--steps", "2", "--samples", "1", "--ab", "--json-out", out]) == 0
    rows = [json.loads(ln) for ln in open(out)]
    assert [r["execution"] for r in rows] == ["chunked", "monolithic"]
    chunked = rows[0]
    assert chunked["w2_pairing"] == "block" and chunked["plan"] == "intra_step"
    # per step: 2 solve chunks + 2 hop chunks + the finish
    assert chunked["dispatches_per_step"] == 5.0
    assert chunked["max_dispatch_wall_s"] > 0 and chunked["device"] == "cpu"
    assert rows[1]["dispatches_per_step"] == 1.0
    printed = [json.loads(ln) for ln in capsys.readouterr().out.strip().splitlines()]
    assert printed == rows


def test_large_n_phi_record_and_refusals(capsys):
    assert large_n.main(["--device", "cpu", "--n", "24", "--steps", "2", "--samples", "1",
                         "--dispatch-budget", "1", "--pairs-per-sec", "576"]) == 0
    row = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert row["bench"] == "large_n_phi" and row["execution"] == "scan_chunks"
    assert row["dispatches_per_step"] == 1.0 and row["pairs_per_sec"] > 0
    # the approximation's knobs: a dial without --kernel-approx leaves the
    # exact row as it is (JAX ignores it too); with it, the approx row runs
    assert large_n.main(["--device", "cpu", "--n", "24", "--steps", "2", "--samples", "1",
                         "--num-features", "64"]) == 0
    row = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert row["bench"] == "large_n_phi"
    assert large_n.main(["--device", "cpu", "--n", "24", "--steps", "2", "--samples", "1",
                         "--kernel-approx", "rff", "--num-features", "64",
                         "--approx-pin-n", "32", "--exact-probe-n", "16"]) == 0
    row = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert row["bench"] == "large_n_approx" and row["kernel_approx_active"]


def test_large_n_ring_pairing_resolution_matches_jax_tool(monkeypatch):
    jtool = _load("_large_n_tool", ROOT / "tools" / "large_n.py", monkeypatch)
    for args in ((W2_GLOBAL_PAIRING_MAX_N, "all_particles", "ring", "auto"),
                 (W2_GLOBAL_PAIRING_MAX_N + 1, "all_particles", "ring", "auto"),
                 (5, "all_particles", "gather", "auto"), (5, "partitions", "ring", "auto"),
                 (5, "all_particles", "ring", "block")):
        assert large_n.resolve_ring_pairing(*args) == jtool.resolve_ring_pairing(*args)
    assert torch.__version__
