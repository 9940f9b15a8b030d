"""Distributed Bayesian logistic regression — the reference's flagship
experiment (BASELINE.json configs 1 and the ``grid.sh`` sweep) on the card.

Counterpart of ``experiments/logreg.py``: the same flags and defaults (one
shard, 10 particles, 100 steps of 1e-3, ``partitions``, no W2, the host-LP
solver, Jacobi), the same drop policy (particles that do not divide by
``--nproc`` are dropped, the results name keeps the requested count), the
same per-shard initial streams, and the same outputs: one pandas pickle
``shard-<rank>.pkl`` a shard with ``timestep`` / ``value`` rows of the
block that shard owns — under ``partitions`` a rotating one
(:meth:`~dist_svgd_torch.distsampler.DistSampler.owned_block_index`) —
before every step, plus the final state.  Run it as

    python -m dist_svgd_torch.experiments.logreg                     # the card
    python -m dist_svgd_torch.experiments.logreg --device cpu --dataset banana \\
        --nproc 4 --nparticles 48 --niter 10 [--update-rule gauss_seidel] [--wasserstein]

The shards are emulated on one device (``DistSampler``), so
``--master_addr`` / ``--master_port`` are kept as documented no-ops.  With
``--wasserstein --wasserstein-solver lp`` the run is the eager loop of
``make_step(stepsize, h=10.0)`` (the host LP needs each step's snapshot);
every other combination is one ``run_steps(niter, stepsize, record=True)``.
Results go under ``--results-dir`` (default ``build/results/``), figures
under ``build/figures/`` (``--no-plots`` skips them).  The pickles need
pandas and the figures matplotlib and sklearn; :func:`run_snapshots` needs
neither and returns the snapshots as numpy arrays.
"""

from __future__ import annotations

import argparse
import os
import shutil
from typing import List, Optional, Tuple

import numpy as np
import torch

from dist_svgd_torch.distsampler import DistSampler
from dist_svgd_torch.experiments import logreg_plots
from dist_svgd_torch.experiments.logreg_plots import get_results_dir, load_fold
from dist_svgd_torch.models.logreg import logreg_logp
from dist_svgd_torch.utils.platform import resolve_device
from dist_svgd_torch.utils.rng import init_particles_per_shard

#: The reference's W2 weight in its driver (``delta += h·w_grad``).
W2_H = 10.0


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def run_snapshots(num_shards, dataset_name, fold, nparticles, niter, stepsize, exchange,
                  wasserstein, wasserstein_solver="lp", update_rule="jacobi",
                  phi_impl="auto", device=None) -> Tuple[DistSampler, List[np.ndarray]]:
    """One run over ``num_shards`` emulated shards; returns ``(sampler,
    blocks)`` with ``blocks[r]`` the ``(niter + 1, n_used / S, d)`` numpy
    snapshots of the block rank ``r`` owned at each step counter (before
    each step, then the final state).  ``phi_impl`` is the samplers' φ
    backend (``'auto'``: the hand kernel on the card)."""
    fold_data = load_fold(dataset_name, fold)
    d = 1 + fold_data.x_train.shape[1]  # particle layout (log α, w)
    n_used = (nparticles // num_shards) * num_shards
    per = n_used // num_shards
    dev = resolve_device(device)
    sampler = DistSampler(
        num_shards, logreg_logp, None, init_particles_per_shard(0, n_used, d, num_shards),
        data=(fold_data.x_train, fold_data.t_train.reshape(-1)),
        exchange_particles=exchange in ("all_particles", "all_scores"),
        exchange_scores=exchange == "all_scores", include_wasserstein=wasserstein,
        wasserstein_solver=wasserstein_solver, update_rule=update_rule,
        phi_impl=phi_impl, device=dev)
    if wasserstein and wasserstein_solver == "lp":
        # eager: the host LP solves from each step's snapshot
        snaps, ts = [], []
        for _ in range(niter):
            snaps.append(_host(sampler.particles))
            ts.append(sampler.t)
            sampler.make_step(stepsize, h=W2_H)
        snaps, ts = np.stack(snaps + [_host(sampler.particles)]), ts + [sampler.t]
    else:
        t0 = sampler.t
        if niter:
            final, hist = sampler.run_steps(niter, stepsize, record=True,
                                            h=W2_H if wasserstein else 1.0)
            snaps = np.concatenate([_host(hist), _host(final)[None]])
        else:  # one snapshot, no step
            snaps = _host(sampler.particles)[None]
        ts = [t0 + t for t in range(niter + 1)]
    by_block = snaps.reshape(len(ts), num_shards, per, d)
    steps = np.arange(len(ts))
    blocks = [by_block[steps, [sampler.owned_block_index(r, t) for t in ts]]
              for r in range(num_shards)]
    return sampler, blocks


def write_pickles(results_dir: str, blocks: List[np.ndarray]) -> None:
    """``shard-<r>.pkl`` a rank: a DataFrame of ``timestep`` (int) and
    ``value`` (a ``(d,)`` numpy vector) rows, timestep-major, built in one
    go — the rows the JAX driver writes one ``pd.Series`` at a time."""
    import pandas as pd

    for r, block in enumerate(blocks):
        T, per, d = block.shape
        pd.DataFrame({"timestep": np.repeat(np.arange(T), per),
                      "value": list(block.reshape(T * per, d))}).to_pickle(
            os.path.join(results_dir, f"shard-{r}.pkl"))


def run(num_shards, dataset_name, fold, nparticles, niter, stepsize, exchange, wasserstein,
        wasserstein_solver="lp", update_rule="jacobi", phi_impl="auto", device=None,
        results_dir=None) -> DistSampler:
    """:func:`run_snapshots`, then the pickles into the run's results
    directory under ``results_dir`` (created if missing); returns the
    sampler, as the JAX driver's ``run`` does."""
    sampler, blocks = run_snapshots(num_shards, dataset_name, fold, nparticles, niter,
                                    stepsize, exchange, wasserstein, wasserstein_solver,
                                    update_rule, phi_impl, device)
    out = get_results_dir(dataset_name, fold, num_shards, nparticles, stepsize, exchange,
                          wasserstein, update_rule, results_dir)
    os.makedirs(out, exist_ok=True)
    write_pickles(out, blocks)
    return sampler


def main(argv: Optional[list] = None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m dist_svgd_torch.experiments.logreg",
        description="Distributed Bayesian logistic regression (the reference's "
                    "experiments/logreg.py) with the PyTorch/CUDA port.")
    p.add_argument("--dataset", choices=("banana", "diabetis", "german", "image", "splice",
                                         "titanic", "waveform"), default="banana")
    p.add_argument("--fold", type=int, default=42)
    p.add_argument("--nproc", type=int, default=1,
                   help="number of shards (the reference's world size), 0..32")
    p.add_argument("--nparticles", type=int, default=10)
    p.add_argument("--niter", type=int, default=100)
    p.add_argument("--stepsize", type=float, default=1e-3)
    p.add_argument("--exchange", choices=("partitions", "all_particles", "all_scores"),
                   default="partitions")
    p.add_argument("--wasserstein", action=argparse.BooleanOptionalAction, default=False)
    p.add_argument("--update-rule", choices=("jacobi", "gauss_seidel"), default="jacobi",
                   help="jacobi: every particle moves against pre-update values; "
                        "gauss_seidel: the reference's in-place sweep (small-n parity)")
    p.add_argument("--wasserstein-solver", choices=("lp", "sinkhorn"), default="lp",
                   help="'lp': the host LP, one make_step a step; 'sinkhorn': on the "
                        "device, one run_steps")
    p.add_argument("--master_addr", default="127.0.0.1",
                   help="no-op: the shards are emulated in one process")
    p.add_argument("--master_port", type=int, default=29500,
                   help="no-op: the shards are emulated in one process")
    p.add_argument("--plots", action=argparse.BooleanOptionalAction, default=True)
    p.add_argument("--results-dir", default=str(logreg_plots.DEFAULT_RESULTS_DIR))
    p.add_argument("--figures-dir", default=str(logreg_plots.DEFAULT_FIGURES_DIR))
    p.add_argument("--device", choices=("cuda", "cpu"), default=None,
                   help="default: the card (fails without CUDA)")
    a = p.parse_args(argv)
    if not 0 <= a.nproc <= 32:
        p.error("--nproc must be in 0..32")
    nproc = max(a.nproc, 1)  # one name for the run, the pickles and the plots
    # a fresh results directory, as the reference's driver leaves it
    out = get_results_dir(a.dataset, a.fold, nproc, a.nparticles, a.stepsize, a.exchange,
                          a.wasserstein, a.update_rule, a.results_dir)
    if os.path.isdir(out):
        shutil.rmtree(out)
    run(nproc, a.dataset, a.fold, a.nparticles, a.niter, a.stepsize, a.exchange,
        a.wasserstein, a.wasserstein_solver, a.update_rule, device=a.device,
        results_dir=a.results_dir)
    print(f"wrote {out}")
    if a.plots:
        res = logreg_plots.make_plots(a.dataset, a.fold, nproc, a.nparticles, a.stepsize,
                                      a.exchange, a.wasserstein, a.update_rule,
                                      a.results_dir, a.figures_dir)
        print(f"final dsvgd accuracy {res['final_accuracy']:.4f} vs sklearn "
              f"{res['sklearn_accuracy']:.4f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
