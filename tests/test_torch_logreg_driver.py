"""The port's experiment drivers against the JAX package's: the logreg
driver (``dist_svgd_torch/experiments/logreg.py`` against
``experiments/logreg.py``, BASELINE.json config 1 and the ``grid.sh``
sweep), its evaluation (``logreg_plots.py``) and the GMM driver
(``experiments/gmm.py``, config 2), all run in process on the CPU.

JAX's threefry initial draws cannot be reproduced in torch, so both
drivers get the same numpy particles: ``init_particles_per_shard`` is
patched in both namespaces (the GMM's ``init_particles`` in both
samplers).  Tolerances: the pickles and the GMM history at 1e-10 in
float64 (the port's ``phi_impl='torch'`` against JAX's ``'xla'`` φ, the
same arithmetic; the host LP solves the same program); the
Sinkhorn-against-LP pins at JAX's own ``atol=2e-2``
(tests/test_experiments.py); the accuracy curve and the results names
exactly."""

import os
import sys

import numpy as np
import pandas as pd
import pytest
import torch

import dist_svgd_tpu.utils.rng as jrng

import dist_svgd_torch as tdt
from dist_svgd_torch.experiments import gmm as tgmm
from dist_svgd_torch.experiments import logreg as tlogreg
from dist_svgd_torch.experiments import logreg_plots as tplots
from dist_svgd_torch.models.logreg import ensemble_test_accuracy, logreg_logp
from dist_svgd_torch.utils import history
from dist_svgd_torch.utils.datasets import load_benchmark
from dist_svgd_torch.utils.rng import init_particles_per_shard

from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL, ATOL = 1e-10, 1e-12


@pytest.fixture(scope="module")
def jax_drivers():
    """JAX's driver modules (experiments/ is a script directory)."""
    sys.path.insert(0, os.path.join(REPO, "experiments"))
    import gmm as jgmm_driver
    import logreg as jlogreg
    import logreg_plots as jplots

    return jlogreg, jplots, jgmm_driver


def _inject(monkeypatch, tmp_path, jlogreg, seed=3):
    """Both drivers draw the same numpy particles; JAX's writes under
    ``tmp_path/jax``."""
    def init(_seed, n, d, num_shards, **kw):
        return np.random.default_rng(seed).normal(size=(n, d))

    monkeypatch.setattr(jrng, "init_particles_per_shard", init)
    monkeypatch.setattr(tlogreg, "init_particles_per_shard", init)
    real = jlogreg.get_results_dir

    def jax_dir(*args):
        out = os.path.join(str(tmp_path / "jax"), os.path.basename(real(*args)))
        os.makedirs(out, exist_ok=True)
        return out

    monkeypatch.setattr(jlogreg, "get_results_dir", jax_dir)


def _run_both(jlogreg, tmp_path, **over):
    cfg = dict(num_shards=2, dataset_name="banana", fold=7, nparticles=8, niter=4,
               stepsize=3e-3, exchange="all_particles", wasserstein=False,
               wasserstein_solver="lp", update_rule="jacobi")
    cfg.update(over)
    jlogreg.run(**cfg)
    tlogreg.run(**cfg, phi_impl="torch", device="cpu", results_dir=str(tmp_path / "port"))
    name = os.path.basename(tplots.get_results_dir(
        cfg["dataset_name"], cfg["fold"], cfg["num_shards"], cfg["nparticles"],
        cfg["stepsize"], cfg["exchange"], cfg["wasserstein"], cfg["update_rule"]))
    return [(pd.read_pickle(tmp_path / "jax" / name / f"shard-{r}.pkl"),
             pd.read_pickle(tmp_path / "port" / name / f"shard-{r}.pkl"))
            for r in range(cfg["num_shards"])]


def _assert_frames_close(jdf, pdf, rtol=RTOL, atol=ATOL):
    assert list(pdf.columns) == list(jdf.columns) == ["timestep", "value"]
    assert pdf["timestep"].dtype == jdf["timestep"].dtype
    np.testing.assert_array_equal(pdf["timestep"].values, jdf["timestep"].values)
    np.testing.assert_allclose(np.stack(pdf["value"].values), np.stack(jdf["value"].values),
                               rtol=rtol, atol=atol)


@pytest.mark.parametrize("update_rule", ["jacobi", "gauss_seidel"])
@pytest.mark.parametrize("wasserstein", [False, True], ids=["no_w2", "lp_w2"])
@pytest.mark.parametrize("exchange", ["partitions", "all_particles", "all_scores"])
def test_pickles_match_jax_driver(jax_drivers, monkeypatch, tmp_path, exchange,
                                  wasserstein, update_rule):
    """Every exchange mode × ±W2 (host LP, the eager loop) × both update
    rules at S = 2: the per-shard pickles (rotating ownership in
    partitions) equal JAX's row for row."""
    jlogreg = jax_drivers[0]
    _inject(monkeypatch, tmp_path, jlogreg)
    frames = _run_both(jlogreg, tmp_path, exchange=exchange, wasserstein=wasserstein,
                       update_rule=update_rule)
    for jdf, pdf in frames:
        assert len(pdf) == 4 * 5  # 4 particles a shard, niter + 1 snapshots
        _assert_frames_close(jdf, pdf)


def _final(frames):
    return np.stack([np.stack(df[df["timestep"] == df["timestep"].max()]["value"].values)
                     for df in frames])


def _port_final(tmp_path, tag, **over):
    cfg = dict(num_shards=2, dataset_name="banana", fold=7, nparticles=8, niter=6,
               stepsize=3e-3, exchange="all_particles", wasserstein=True)
    cfg.update(over)
    root = tmp_path / tag
    tlogreg.run(**cfg, phi_impl="torch", device="cpu", results_dir=str(root))
    name = os.path.basename(tplots.get_results_dir(
        cfg["dataset_name"], cfg["fold"], cfg["num_shards"], cfg["nparticles"],
        cfg["stepsize"], cfg["exchange"], cfg["wasserstein"],
        cfg.get("update_rule", "jacobi")))
    return _final([pd.read_pickle(root / name / f"shard-{r}.pkl") for r in range(2)])


@pytest.mark.parametrize("update_rule", ["jacobi", "gauss_seidel"])
def test_sinkhorn_solver_tracks_lp(tmp_path, update_rule):
    """--wasserstein-solver sinkhorn (one run_steps, the W2 state carried)
    stays within JAX's atol=2e-2 of the eager host-LP path (JAX
    ``test_logreg_driver_sinkhorn_solver_tracks_lp`` and
    ``test_logreg_driver_gs_sinkhorn_scanned_tracks_lp``)."""
    lp = _port_final(tmp_path, "lp", wasserstein_solver="lp", update_rule=update_rule)
    sk = _port_final(tmp_path, "sk", wasserstein_solver="sinkhorn", update_rule=update_rule)
    assert lp.shape == sk.shape == (2, 4, 3)
    np.testing.assert_allclose(sk, lp, atol=2e-2)
    assert not np.allclose(sk, 0.0)


def test_record_chunking_leaves_the_pickles_unchanged(tmp_path, monkeypatch):
    whole = _port_final(tmp_path, "whole", wasserstein=False)
    monkeypatch.setattr(history, "record_chunk_steps", lambda n, d, itemsize=4: 4)
    chunked = _port_final(tmp_path, "chunked", wasserstein=False)  # 6 = 4 + 2
    np.testing.assert_array_equal(whole, chunked)


def test_snapshots_are_the_pickles_rows(tmp_path):
    """run_snapshots' arrays are what the pickles hold (the card path
    returns them without pandas), in partitions' rotating ownership."""
    sampler, blocks = tlogreg.run_snapshots(4, "titanic", 1, 10, 3, 1e-3, "partitions",
                                            False, device="cpu")
    assert sampler.num_particles == 8 and [b.shape for b in blocks] == [(4, 2, 4)] * 4
    tlogreg.write_pickles(str(tmp_path), blocks)
    for r, block in enumerate(blocks):
        df = pd.read_pickle(tmp_path / f"shard-{r}.pkl")
        np.testing.assert_array_equal(np.stack(df["value"].values), block.reshape(-1, 4))
        np.testing.assert_array_equal(df["timestep"].values, np.repeat(np.arange(4), 2))
    final = sampler.particles.numpy().reshape(4, 2, 4)
    for r in range(4):  # the last snapshot: the block rank r owns now
        np.testing.assert_array_equal(blocks[r][-1], final[sampler.owned_block_index(r)])


def test_results_dir_names_match_jax(jax_drivers):
    jplots = jax_drivers[1]
    for cfg in [("banana", 42, 1, 10, 1e-3, "partitions", False, "jacobi"),
                ("banana", 3, 4, 50, 3e-3, "all_particles", False, "jacobi"),
                ("splice", 1, 8, 50, 1e-4, "all_scores", True, "jacobi"),
                ("titanic", 1, 1, 6, 1e-3, "partitions", False, "gauss_seidel"),
                ("german", 0, 2, 48, 0.05, "all_particles", True, "gauss_seidel")]:
        want = os.path.basename(jplots.get_results_dir(*cfg))
        assert os.path.basename(tplots.get_results_dir(*cfg)) == want
        assert tplots.get_results_dir(*cfg, root="/x") == os.path.join("/x", want)


def test_accuracy_curve_and_baseline_match_jax(jax_drivers, tmp_path):
    pytest.importorskip("sklearn")
    jplots = jax_drivers[1]
    _, blocks = tlogreg.run_snapshots(2, "banana", 42, 16, 5, 1e-2, "partitions", False,
                                      phi_impl="torch", device="cpu")
    tlogreg.write_pickles(str(tmp_path), blocks)
    df = pd.concat(pd.read_pickle(tmp_path / f"shard-{r}.pkl") for r in range(2))
    fold = load_benchmark("banana", 42)
    got = tplots.test_accuracy_curve(df, fold)
    assert got.shape == (6, 2)
    np.testing.assert_array_equal(got, jplots.test_accuracy_curve(df, fold))
    assert tplots.sklearn_baseline_accuracy(fold) == jplots.sklearn_baseline_accuracy(fold)


def test_cli_nproc_zero_normalised_and_plots(tmp_path):
    """--nproc 0 runs one shard under the nshards=1 name (JAX
    ``test_logreg_cli_nproc_zero_normalised``); --plots writes the figures."""
    pytest.importorskip("matplotlib")
    pytest.importorskip("sklearn")
    res = tmp_path / "results"
    assert tlogreg.main(["--device", "cpu", "--dataset", "banana", "--fold", "1",
                         "--nproc", "0", "--nparticles", "6", "--niter", "12",
                         "--results-dir", str(res), "--figures-dir",
                         str(tmp_path / "fig")]) == 0
    name = ("logreg_banana_1-nshards=1-nparticles=6-exchange=partitions-"
            "wasserstein=False-stepsize=1e-03")
    assert sorted(os.listdir(res / name)) == ["shard-0.pkl"]
    assert len(pd.read_pickle(res / name / "shard-0.pkl")) == 6 * 13
    assert (tmp_path / "fig" / f"{name}-test_acc.png").stat().st_size > 0
    assert (tmp_path / "fig" / name / "particles_w1_w2_t10.png").exists()
    with pytest.raises(SystemExit):
        tlogreg.main(["--device", "cpu", "--nproc", "33"])


def test_driver_runs_on_the_card_by_default():
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tlogreg.run_snapshots(1, "banana", 42, 4, 1, 1e-3, "partitions", False)


@pytest.mark.parametrize("kw,h", [pytest.param({"include_wasserstein": False}, 1.0,
                                               id="north_star")])
def test_logreg_convergence_reaches_sklearn_baseline(kw, h):
    """The convergence half of the primary metric (JAX's
    ``test_logreg_convergence_reaches_sklearn_baseline``, north_star): 256
    particles on 4 shards, all_particles, 200 steps of 0.1 reach sklearn's
    accuracy − 0.01 on banana fold 42 — from the port's own initial
    draw."""
    sklearn = pytest.importorskip("sklearn.linear_model")
    fold = load_benchmark("banana", 42)
    clf = sklearn.LogisticRegression()
    clf.fit(fold.x_train, fold.t_train.reshape(-1))
    baseline = float(clf.score(fold.x_test, fold.t_test.reshape(-1)))
    d = 1 + fold.x_train.shape[1]
    ds = tdt.DistSampler(4, logreg_logp, None, init_particles_per_shard(0, 256, d, 4),
                         data=(fold.x_train, fold.t_train.reshape(-1)),
                         exchange_particles=True, exchange_scores=False, device="cpu", **kw)
    ds.run_steps(200, 0.1, h=h)
    acc = float(ensemble_test_accuracy(ds.particles, torch.as_tensor(fold.x_test),
                                       torch.as_tensor(fold.t_test.reshape(-1))))
    assert acc >= baseline - 0.01, (acc, baseline)


# --------------------------------------------------------------------------
# The GMM driver (BASELINE.json config 2)


def test_gmm_run_matches_jax(jax_drivers, monkeypatch):
    """The driver's whole run (50 particles, 500 steps of 1.0) from the same
    initial particles: the reference DataFrame, row for row."""
    import dist_svgd_tpu.sampler as jsampler
    import dist_svgd_torch.sampler as tsampler

    jgmm_driver = jax_drivers[2]
    init = np.random.default_rng(4).normal(size=(tgmm.N, tgmm.D))
    monkeypatch.setattr(jsampler, "init_particles", lambda *a, **k: init)
    monkeypatch.setattr(tsampler, "init_particles",
                        lambda *a, **k: torch.as_tensor(init))
    want = jgmm_driver.run()
    got = tgmm.run(device="cpu", phi_impl="torch")
    assert list(got.columns) == list(want.columns) == ["timestep", "particle", "value"]
    assert len(got) == len(want) == 501 * 50
    np.testing.assert_array_equal(got["timestep"].values, want["timestep"].values)
    np.testing.assert_allclose(np.stack(got["value"].values), np.stack(want["value"].values),
                               rtol=RTOL, atol=ATOL)
    final = np.stack(got[got["timestep"] == tgmm.NUM_ITER]["value"].values)
    assert abs(final.mean()) < 0.5 and 1.5 < final.std() < 3.0  # truth: 0, ~2.24


def test_gmm_plot_writes_a_png(tmp_path, capsys):
    pytest.importorskip("matplotlib")
    pytest.importorskip("scipy")
    assert tgmm.main(["--device", "cpu", "--seed", "1", "--figures-dir",
                      str(tmp_path)]) == 0
    assert (tmp_path / "gmm.png").stat().st_size > 0
    assert "final particles: mean=" in capsys.readouterr().out
