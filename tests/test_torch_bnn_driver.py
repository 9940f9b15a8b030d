"""The port's BNN driver (``dist_svgd_torch/experiments/bnn.py``,
BASELINE.json config 5) and the Covertype driver's ``--nproc 1`` path
through the single-device ``Sampler``, on the CPU at small sizes.

The BNN run must beat the predict-the-train-mean RMSE and the untrained
ensemble, as tests/test_bnn.py requires of the JAX driver (yacht, 64
particles, 16 hidden units, 200 full-data steps of 5e-3)."""

import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from dist_svgd_torch.experiments import bnn as tbnn_drv
from dist_svgd_torch.experiments import covertype as tcov
from dist_svgd_torch.ops.kernels import RBF, resolve_bandwidth_kernel
from dist_svgd_torch.sampler import Sampler
from dist_svgd_torch.utils.datasets import load_uci_regression
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)


ROOT = Path(__file__).resolve().parents[1]
SMALL = dict(dataset="yacht", nparticles=64, n_hidden=16, device="cpu")


def test_bnn_driver_beats_the_baselines():
    sp = load_uci_regression("yacht", 0)
    baseline = float(np.sqrt(np.mean((sp.y_test - sp.y_mean) ** 2)))
    _, m0 = tbnn_drv.run(**SMALL, niter=0, batch_size=0)
    final, m = tbnn_drv.run(**SMALL, niter=200, stepsize=5e-3, batch_size=0)
    assert m["test_rmse"] < baseline and m["test_rmse"] < m0["test_rmse"]
    assert final.shape == (64, 6 * 16 + 16 + 16 + 1 + 2) and np.isfinite(final).all()
    assert np.isfinite(m["test_loglik"]) and m["batch_size"] is None


def _jax_driver(monkeypatch):
    monkeypatch.syspath_prepend(str(ROOT / "experiments"))
    spec = importlib.util.spec_from_file_location("jax_bnn", ROOT / "experiments" / "bnn.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_bnn_driver_emits_the_jax_metrics_keys(monkeypatch):
    """The port's metrics carry every key of the JAX driver's, plus the
    device."""
    kw = dict(dataset="yacht", nparticles=16, n_hidden=8, niter=2, batch_size=32)
    _, metrics = tbnn_drv.run(**kw, device="cpu")
    _, jmetrics = _jax_driver(monkeypatch).run(**kw)
    assert set(jmetrics) <= set(metrics) and metrics["device"] == "cpu"


@pytest.mark.parametrize("nproc,bandwidth,resolved", [
    (1, "median_step", None), (4, "median", "positive"), (4, "2.5", 2.5), (2, "1.0", 1.0)])
def test_bnn_driver_paths(nproc, bandwidth, resolved):
    """The Sampler (nproc 1) and DistSampler (nproc > 1) paths, each
    bandwidth spelling, minibatched."""
    final, metrics = tbnn_drv.run(dataset="yacht", nproc=nproc, nparticles=16, n_hidden=8,
                                  niter=2, batch_size=32, bandwidth=bandwidth, device="cpu")
    assert metrics["nproc"] == nproc and metrics["batch_size"] == 32
    assert final.shape == (16, 6 * 8 + 8 + 8 + 1 + 2) and np.isfinite(final).all()
    if resolved == "positive":
        assert metrics["resolved_bandwidth"] > 0
    else:
        assert metrics["resolved_bandwidth"] == resolved


def test_resolve_bandwidth_kernel():
    assert resolve_bandwidth_kernel("1.0") is None
    assert resolve_bandwidth_kernel("1") is None
    assert resolve_bandwidth_kernel("median") == "median"
    assert resolve_bandwidth_kernel("median_step") == "median_step"
    k = resolve_bandwidth_kernel("3.5")
    assert isinstance(k, RBF) and k.bandwidth == 3.5


@pytest.mark.parametrize("kw,err,match", [
    ({"exchange_every": 2}, ValueError, "requires --nproc > 1"),
    ({"exchange_every": 2, "nproc": 2, "exchange": "all_scores"}, ValueError, "all_particles"),
    ({"exchange_every": 3, "nproc": 2, "niter": 4}, ValueError, "multiple"),
    ({"exchange_every": 2, "nproc": 2, "niter": 4}, NotImplementedError, "ROADMAP A5"),
    ({"phi_impl": "pallas"}, ValueError, "unknown phi_impl"),
])
def test_bnn_driver_refusals(kw, err, match):
    with pytest.raises(err, match=match):
        tbnn_drv.run(**{**SMALL, "niter": 2, **kw})


def test_bnn_driver_runs_on_the_card_by_default():
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tbnn_drv.run(dataset="yacht", nparticles=8, n_hidden=4, niter=1)


def test_bnn_cli_writes_results(tmp_path, capsys):
    assert tbnn_drv.main(["--device", "cpu", "--dataset", "yacht", "--nparticles", "8",
                          "--n-hidden", "4", "--niter", "2", "--bandwidth", "median_step",
                          "--phi-impl", "torch", "--results-dir", str(tmp_path)]) == 0
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    (out,) = tmp_path.iterdir()
    assert out.name == ("bnn-yacht-0-1-8-4-2-0.001-100-all_particles-0-h=median_step"
                        "-phi=torch")
    assert json.loads((out / "metrics.json").read_text()) == printed
    assert np.load(out / "particles.npy").shape == (8, 6 * 4 + 4 + 4 + 1 + 2)


def test_covertype_nproc1_runs_the_sampler():
    """--nproc 1 builds a Sampler over all the training rows, and the
    driver's run is that Sampler's run from the driver's initial
    particles."""
    kw = dict(nrows=1200, nproc=1, nparticles=32, batch_size=64, device="cpu")
    sampler, _, info = tcov.make_sampler(**kw)
    assert isinstance(sampler, Sampler) and info["batch_size"] == 64
    final, metrics = tcov.run(**kw, niter=3, bandwidth="median_step")
    assert final.shape == (32, 55) and np.isfinite(final).all()
    assert metrics["nproc"] == 1 and metrics["steps_run"] == 3
    assert 0.0 <= metrics["test_acc"] <= 1.0
    direct = tcov.make_sampler(**kw, bandwidth="median_step")
    want, _ = direct[0].run(32, 3, 1e-4, record=False, initial_particles=direct[2]["init"])
    np.testing.assert_array_equal(final, want.numpy())


def test_covertype_cli_takes_median_step(tmp_path, capsys):
    assert tcov.main(["--device", "cpu", "--nrows", "1200", "--nproc", "1",
                      "--nparticles", "16", "--niter", "2", "--batch-size", "32",
                      "--bandwidth", "median_step", "--results-dir", str(tmp_path)]) == 0
    (out,) = tmp_path.iterdir()
    assert out.name == "covertype-1200-1-16-2-0.0001-32-all_particles-shard-0-h=median_step"
