"""Evaluation and figures of the Bayesian-logreg experiment.

Counterpart of ``experiments/logreg_plots.py``: the config-encoded results
directory (byte-identical names), the sklearn ``LogisticRegression``
baseline, the ensemble test-accuracy curve over the per-shard pickles, and
the matplotlib PNGs (the accuracy curve against the baseline; for banana
the particle scatters and the α histograms), which the driver
(:mod:`dist_svgd_torch.experiments.logreg`) writes after a run.

pandas, sklearn and matplotlib are imported inside the functions that need
them: the card's machine has none of them, and nothing on the sampling path
needs this module's plotting half.
"""

from __future__ import annotations

import os
from glob import glob
from pathlib import Path

import numpy as np
import torch

from dist_svgd_torch.models.logreg import posterior_predictive_prob
from dist_svgd_torch.utils.datasets import load_benchmark

_ROOT = Path(__file__).resolve().parents[2]
#: Where results and figures go unless told otherwise (ignored by git).
DEFAULT_RESULTS_DIR = _ROOT / "build" / "results"
DEFAULT_FIGURES_DIR = _ROOT / "build" / "figures"
#: Where a real ``benchmarks.mat`` is read from when present — the JAX
#: drivers' data directory; without it the loader's synthetic stand-ins.
DEFAULT_DATA_DIR = _ROOT / "experiments" / "data"

TIMESTEPS_BETWEEN_KDE_PLOTS = 10


def get_results_dir(dataset_name, fold, nproc, nparticles, stepsize, exchange, wasserstein,
                    update_rule="jacobi", root=None) -> str:
    """``root/<name>``: the reference's config-encoded name, byte for byte
    the JAX driver's (``-update_rule=…`` appended only when not Jacobi).
    ``root`` defaults to :data:`DEFAULT_RESULTS_DIR`."""
    subdir = ("logreg_{}_{}-nshards={}-nparticles={}-exchange={}-wasserstein={}-"
              "stepsize={:.0e}").format(dataset_name, fold, nproc, nparticles, exchange,
                                        wasserstein, stepsize)
    if update_rule != "jacobi":
        subdir += f"-update_rule={update_rule}"
    return os.path.join(str(DEFAULT_RESULTS_DIR if root is None else root), subdir)


def load_fold(dataset_name, fold):
    """The train/test fold, from ``benchmarks.mat`` in
    :data:`DEFAULT_DATA_DIR` when it is there, else the synthetic stand-in
    (as the JAX driver loads it)."""
    return load_benchmark(dataset_name, fold,
                          mat_path=os.path.join(str(DEFAULT_DATA_DIR), "benchmarks.mat"))


def sklearn_baseline_accuracy(fold_data) -> float:
    """The reference baseline: sklearn's ``LogisticRegression`` fit on the
    same fold, scored on its test rows."""
    from sklearn.linear_model import LogisticRegression

    clf = LogisticRegression()
    clf.fit(fold_data.x_train, fold_data.t_train.reshape(-1))
    return float(clf.score(fold_data.x_test, fold_data.t_test.reshape(-1)))


def test_accuracy_curve(df, fold_data) -> np.ndarray:
    """``(T, 2)`` rows ``(timestep, accuracy)``: the ensemble's
    posterior-predictive-mean accuracy at each timestep of ``df`` (mean
    σ(x·w) over the particles, threshold 0.5, against t > 0), in float64."""
    x_test = torch.as_tensor(fold_data.x_test, dtype=torch.float64)
    t_test = fold_data.t_test.reshape(-1) > 0
    rows = []
    for t, group in df.groupby("timestep"):
        particles = torch.as_tensor(np.stack(group["value"].values), dtype=torch.float64)
        probs = posterior_predictive_prob(particles, x_test).numpy()
        rows.append((int(t), float(((probs.mean(axis=0) > 0.5) == t_test).mean())))
    rows.sort()
    return np.asarray(rows)


def _pyplot():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_test_acc(df, plot_title, fold_data, out_path):
    """The accuracy curve against the sklearn baseline, as a PNG; returns
    ``(curve, baseline)``."""
    baseline = sklearn_baseline_accuracy(fold_data)
    curve = test_accuracy_curve(df, fold_data)
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(6, 4))
    ax.plot(curve[:, 0], curve[:, 1], label="dsvgd")
    ax.axhline(baseline, color="tab:orange", ls="--", label="sklearn logreg")
    ax.set_xlabel("Iteration")
    ax.set_ylabel("Test accuracy")
    ax.set_title(plot_title, fontsize=8)
    ax.legend()
    fig.tight_layout()
    fig.savefig(out_path, dpi=150)
    plt.close(fig)
    return curve, baseline


def _per_timestep_pngs(df, out_dir, stem, draw):
    """One PNG a sampled timestep: ``draw(ax, values (n, d))``."""
    plt = _pyplot()
    for t in range(0, int(df["timestep"].max()), TIMESTEPS_BETWEEN_KDE_PLOTS):
        vals = np.stack(df[df["timestep"] == t]["value"].values)
        fig, ax = plt.subplots(figsize=(4, 4))
        draw(ax, vals)
        ax.set_title(f"{os.path.basename(out_dir)} {stem} t={t}", fontsize=7)
        fig.tight_layout()
        fig.savefig(os.path.join(out_dir, f"{stem}_t{t}.png"), dpi=120)
        plt.close(fig)


def plot_w_scatters(df, out_dir):
    """The particles' (w1, w2) scatter at every tenth timestep."""
    def draw(ax, vals):
        ax.scatter(vals[:, 1], vals[:, 2], s=8)
        ax.set_xlim(-1.5, 1.5)
        ax.set_ylim(-3, 2)
        ax.set_xlabel("w1")
        ax.set_ylabel("w2")

    _per_timestep_pngs(df, out_dir, "particles_w1_w2", draw)


def plot_alpha_hist(df, out_dir):
    """A histogram of the log-α component at every tenth timestep."""
    def draw(ax, vals):
        ax.hist(vals[:, 0], bins=20, range=(-2, 2))
        ax.set_xlabel("alpha")

    _per_timestep_pngs(df, out_dir, "particles_alpha", draw)


def make_plots(dataset, fold, nproc, nparticles, stepsize, exchange, wasserstein,
               update_rule="jacobi", results_dir=None, figures_dir=None) -> dict:
    """Read a run's ``shard-*.pkl`` and write its figures under
    ``figures_dir`` (default :data:`DEFAULT_FIGURES_DIR`): the accuracy
    curve, and for banana the scatters and histograms (the reference's
    banana gate compared a string literal and never fired; this one
    compares the dataset).  Returns the final accuracy and the baseline."""
    import pandas as pd

    run_dir = get_results_dir(dataset, fold, nproc, nparticles, stepsize, exchange,
                              wasserstein, update_rule, results_dir)
    df = pd.concat(map(pd.read_pickle, sorted(glob(os.path.join(run_dir, "shard-*.pkl")))))
    figures = Path(DEFAULT_FIGURES_DIR if figures_dir is None else figures_dir)
    figures.mkdir(parents=True, exist_ok=True)
    fig_base = os.path.basename(run_dir)
    title = ("logreg_{}_{} test_acc nshards={} nparticles={} exchange={} wasserstein={} "
             "stepsize={:.0e}").format(dataset, fold, nproc, nparticles, exchange,
                                       wasserstein, stepsize)
    curve, baseline = plot_test_acc(df, title, load_fold(dataset, fold),
                                    str(figures / f"{fig_base}-test_acc.png"))
    if dataset == "banana":
        out_dir = figures / fig_base
        out_dir.mkdir(parents=True, exist_ok=True)
        plot_w_scatters(df, str(out_dir))
        plot_alpha_hist(df, str(out_dir))
    return {"final_accuracy": float(curve[-1, 1]), "sklearn_accuracy": baseline}
