"""The 1-D Gaussian-mixture experiment — the reference's minimum end-to-end
run (BASELINE.json config 2) on the card.

Counterpart of ``experiments/gmm.py``: 50 particles, 500 steps of 1.0 from
the (unnormalised, code-weighted 1/3 + 1/3) mixture of N(−2, 1) and
N(2, 1) with the reference's RBF(1), seed 42, then KDE snapshots at
timesteps {0, 50, 75, 100, 150, 500} in one figure.  Run it as

    python -m dist_svgd_torch.experiments.gmm                  # the card
    python -m dist_svgd_torch.experiments.gmm --device cpu     # the CPU

It prints the final particles' mean and standard deviation (the mixture's
are 0 and ~2.24) and writes ``gmm.png`` under ``--figures-dir`` (default
``build/figures/``; ``--no-plot`` skips it — the figure needs pandas,
matplotlib and scipy).
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import Optional

import numpy as np

from dist_svgd_torch.experiments.logreg_plots import DEFAULT_FIGURES_DIR
from dist_svgd_torch.models.gmm import gmm_logp
from dist_svgd_torch.sampler import Sampler

SEED = 42  # the reference's torch.manual_seed(42)
D = 1
N = 50
NUM_ITER = 500
STEP_SIZE = 1.0
SNAPSHOT_TIMESTEPS = (0, 50, 75, 100, 150, 500)


def make_sampler(device=None, update_rule: str = "jacobi", phi_impl: str = "auto") -> Sampler:
    """The experiment's sampler: d = 1, the mixture, RBF(1); ``phi_impl``
    is the φ backend (``'auto'``: the hand kernel on the card)."""
    return Sampler(D, gmm_logp, update_rule=update_rule, phi_impl=phi_impl, device=device)


def run(seed: int = SEED, device=None, phi_impl: str = "auto"):
    """``Sampler(1, gmm_logp).sample(50, 500, 1.0, seed=seed)``: the
    reference's DataFrame (``timestep`` 0..500, ``particle``, ``value``)."""
    return make_sampler(device, phi_impl=phi_impl).sample(N, NUM_ITER, STEP_SIZE, seed=seed)


def plot(df, out_path: str) -> str:
    """KDE snapshots (scipy's ``gaussian_kde``) of ``df`` at
    :data:`SNAPSHOT_TIMESTEPS`, one panel each, as a PNG."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from scipy.stats import gaussian_kde

    fig, axes = plt.subplots(1, len(SNAPSHOT_TIMESTEPS), figsize=(9, 2))
    for ax, t in zip(axes, SNAPSHOT_TIMESTEPS):
        vals = np.stack(df[df["timestep"] == t]["value"].values)[:, 0]
        grid = np.linspace(vals.min() - 1.5, vals.max() + 1.5, 200)
        dens = gaussian_kde(vals)(grid)
        ax.fill_between(grid, dens, alpha=0.4)
        ax.plot(grid, dens)
        ax.set_title(f"Timestep {t}", fontsize=8)
        ax.set_yticks([])
    fig.tight_layout()
    fig.savefig(out_path, dpi=150)
    plt.close(fig)
    return out_path


def main(argv: Optional[list] = None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m dist_svgd_torch.experiments.gmm",
        description="SVGD on the reference's 1-D Gaussian mixture with the "
                    "PyTorch/CUDA port.")
    p.add_argument("--seed", type=int, default=SEED)
    p.add_argument("--plot", action=argparse.BooleanOptionalAction, default=True)
    p.add_argument("--figures-dir", default=str(DEFAULT_FIGURES_DIR))
    p.add_argument("--device", choices=("cuda", "cpu"), default=None,
                   help="default: the card (fails without CUDA)")
    a = p.parse_args(argv)
    final, hist = make_sampler(a.device).run(N, NUM_ITER, STEP_SIZE, seed=a.seed,
                                             record=a.plot)
    final = final.detach().cpu().numpy()
    if a.plot:
        from dist_svgd_torch.utils.history import history_to_dataframe

        out = Path(a.figures_dir)
        out.mkdir(parents=True, exist_ok=True)
        hist = hist.cpu().numpy() if hasattr(hist, "cpu") else hist
        print(f"wrote {plot(history_to_dataframe(hist), str(out / 'gmm.png'))}")
    print(f"final particles: mean={final.mean():+.3f} std={final.std():.3f} "
          f"(mixture truth: 0, ~2.24)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
