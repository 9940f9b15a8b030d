"""Two-layer Bayesian-NN regression on the UCI suite — BASELINE.json config 5
("2-layer Bayesian NN regression (UCI), 500 particles, weight-vector SVGD")
— on the card.

Counterpart of ``experiments/bnn.py``: the same defaults (boston, split 0,
one shard, 500 particles, 50 hidden units — d = 753 — 1000 steps of 1e-3,
minibatches of 100 rows with a separate unscaled prior, the reference's
RBF(1)), the same metrics keys, the same results-directory naming and the
same ``--bandwidth`` mapping (``ops.kernels.resolve_bandwidth_kernel``;
the reference's h = 1 puts every off-diagonal kernel value at d = 753 near
exp(−d)).  Protocol:
90/10 train/test split, features and targets z-scored by train statistics,
ensemble posterior-predictive RMSE and log-likelihood on the original
target scale.  ``--nproc 1`` runs the single-device ``Sampler``; more
shards run ``DistSampler`` without the Wasserstein term.  Run it as

    python -m dist_svgd_torch.experiments.bnn                  # the card
    python -m dist_svgd_torch.experiments.bnn --device cpu --dataset yacht \\
        --nparticles 64 --n-hidden 16 --niter 20               # the CPU

It prints the metrics as one JSON line and writes ``metrics.json`` and
``particles.npy`` under ``--results-dir`` (default ``build/results/``).
Without ``--data-dir`` (or without ``<name>.npz`` there) the datasets are
the loader's deterministic synthetic stand-ins with the real feature
counts.  ``--exchange-every > 1`` (the lagged exchange) is ROADMAP A5.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np
import torch

from dist_svgd_torch.distsampler import DistSampler
from dist_svgd_torch.models import bnn
from dist_svgd_torch.ops import cuda_svgd
from dist_svgd_torch.ops.cuda_svgd import PHI_IMPLS
from dist_svgd_torch.ops.kernels import resolve_bandwidth_kernel
from dist_svgd_torch.sampler import Sampler
from dist_svgd_torch.utils.datasets import load_uci_regression
from dist_svgd_torch.utils.platform import resolve_device

#: Where results go unless ``--results-dir`` says otherwise (ignored by git).
DEFAULT_RESULTS_DIR = Path(__file__).resolve().parents[2] / "build" / "results"


def get_results_dir(root, dataset, split, nproc, nparticles, n_hidden, niter, stepsize,
                    batch_size, exchange, seed, bandwidth="1.0", phi_impl="auto",
                    exchange_every=1) -> Path:
    """``root/<name>``, the name carrying every run-changing option (the
    JAX driver's naming), created if missing."""
    name = (f"bnn-{dataset}-{split}-{nproc}-{nparticles}-{n_hidden}-{niter}-"
            f"{stepsize}-{batch_size}-{exchange}-{seed}")
    if bandwidth in ("median", "median_step") or float(bandwidth) != 1.0:
        name += f"-h={bandwidth}"
    if phi_impl != "auto":
        name += f"-phi={phi_impl}"
    if exchange_every != 1:
        name += f"-T={exchange_every}"
    path = Path(root) / name
    path.mkdir(parents=True, exist_ok=True)
    return path


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(dataset="boston", split=0, nproc=1, nparticles=500, n_hidden=50, niter=1000,
        stepsize=1e-3, batch_size=100, exchange="all_particles", seed=0, bandwidth="1.0",
        phi_impl="auto", exchange_every=1, device=None, data_dir=None):
    """Train; returns ``(final particles as numpy, metrics dict)``.

    The metrics carry the JAX driver's keys plus ``device`` (the card's
    name, or ``'cpu'``) and ``compile_excluded``: the φ kernel of the run's
    d and tier is built and loaded before the clock starts (without a
    launch, so a run of ``niter`` steps launches it ``niter`` times)."""
    if exchange not in ("all_particles", "all_scores"):
        raise ValueError(f"unknown exchange {exchange!r}")
    if exchange_every > 1:  # the JAX driver's checks, before any data load
        if nproc == 1:
            raise ValueError("--exchange-every > 1 is a distributed exchange cadence; "
                             "it requires --nproc > 1")
        if exchange != "all_particles":
            raise ValueError("--exchange-every > 1 requires --exchange all_particles")
        if niter % exchange_every:
            raise ValueError(f"--niter ({niter}) must be a multiple of "
                             f"--exchange-every ({exchange_every})")
        raise NotImplementedError(
            "--exchange-every > 1 (the lagged exchange) is not ported to PyTorch yet "
            "(ROADMAP A5)")
    dev = resolve_device(device)
    sp = load_uci_regression(dataset, split, data_path=data_dir)
    n_features = sp.x_train.shape[1]
    d = bnn.num_params(n_features, n_hidden)
    n_used = (nparticles // nproc) * nproc
    particles = bnn.init_particles(seed, n_used, n_features, n_hidden, device=dev)
    likelihood, prior = bnn.make_bnn_split(n_features, n_hidden)
    batch = min(batch_size, sp.x_train.shape[0] // nproc) if batch_size else None
    kernel = resolve_bandwidth_kernel(bandwidth)
    data = (torch.as_tensor(sp.x_train, device=dev), torch.as_tensor(sp.y_train, device=dev))

    if dev.type == "cuda":
        cuda_svgd.load_kernel(d, phi_impl)
    if nproc == 1:
        sampler = Sampler(d, likelihood, kernel=kernel, data=data, batch_size=batch,
                          log_prior=prior, phi_impl=phi_impl, device=dev, seed=seed)
        _sync(dev)
        t0 = time.perf_counter()
        final, _ = sampler.run(n_used, niter, stepsize, record=False,
                               initial_particles=particles)
    else:
        sampler = DistSampler(
            nproc, likelihood, kernel, particles, data=data,
            exchange_particles=True, exchange_scores=exchange == "all_scores",
            include_wasserstein=False, batch_size=batch, log_prior=prior,
            phi_impl=phi_impl, seed=seed, device=dev)
        _sync(dev)
        t0 = time.perf_counter()
        final = sampler.run_steps(niter, stepsize)
    _sync(dev)
    wall = time.perf_counter() - t0

    x_test = torch.as_tensor(sp.x_test, device=dev)
    metrics = {
        "dataset": dataset,
        "split": split,
        "nproc": nproc,
        "nparticles": n_used,
        "n_hidden": n_hidden,
        "niter": niter,
        "stepsize": stepsize,
        "batch_size": batch,
        "exchange": exchange,
        "bandwidth": bandwidth,
        "phi_impl": phi_impl,
        "exchange_every": exchange_every,
        "resolved_bandwidth": getattr(sampler.kernel, "bandwidth", None),
        "test_rmse": float(bnn.ensemble_rmse(final, x_test, sp.y_test, n_features, n_hidden,
                                             y_mean=sp.y_mean, y_std=sp.y_std)),
        "test_loglik": float(bnn.ensemble_test_loglik(final, x_test, sp.y_test, n_features,
                                                      n_hidden, y_mean=sp.y_mean,
                                                      y_std=sp.y_std)),
        "wall_s": round(wall, 3),
        "updates_per_sec": round(n_used * niter / wall, 1) if niter else 0.0,
        "compile_excluded": True,
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
    }
    return final.detach().cpu().numpy(), metrics


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m dist_svgd_torch.experiments.bnn",
        description="Two-layer Bayesian-NN regression on the UCI suite "
                    "(BASELINE.json config 5) with the PyTorch/CUDA port.")
    p.add_argument("--dataset", default="boston")
    p.add_argument("--split", type=int, default=0)
    p.add_argument("--nproc", type=int, default=1,
                   help="number of shards (1: the single-device Sampler)")
    p.add_argument("--nparticles", type=int, default=500)
    p.add_argument("--n-hidden", type=int, default=50)
    p.add_argument("--niter", type=int, default=1000)
    p.add_argument("--stepsize", type=float, default=1e-3)
    p.add_argument("--batch-size", type=int, default=100,
                   help="minibatch rows a step (0 = full data)")
    p.add_argument("--exchange", choices=("all_particles", "all_scores"),
                   default="all_particles")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--bandwidth", default="1.0",
                   help="RBF bandwidth: a float (reference 1.0), 'median' (per-run "
                        "heuristic) or 'median_step' (re-estimated every step)")
    p.add_argument("--phi-impl", choices=PHI_IMPLS, default="auto",
                   help="φ backend (dist_svgd_torch/ops/cuda_svgd.py:resolve_phi_fn)")
    p.add_argument("--exchange-every", type=int, default=1)
    p.add_argument("--device", choices=("cuda", "cpu"), default=None,
                   help="default: the card (fails without CUDA)")
    p.add_argument("--data-dir", default=None,
                   help="directory of <dataset>.npz files (arrays x, y); "
                        "default: the synthetic stand-ins")
    p.add_argument("--results-dir", default=str(DEFAULT_RESULTS_DIR))
    a = p.parse_args(argv)
    if a.nproc < 1:
        p.error("--nproc must be >= 1")
    if a.exchange_every < 1:
        p.error("--exchange-every must be >= 1")
    final, metrics = run(a.dataset, a.split, a.nproc, a.nparticles, a.n_hidden, a.niter,
                         a.stepsize, a.batch_size, a.exchange, a.seed, a.bandwidth,
                         a.phi_impl, a.exchange_every, a.device, a.data_dir)
    out = get_results_dir(a.results_dir, a.dataset, a.split, a.nproc, a.nparticles,
                          a.n_hidden, a.niter, a.stepsize, a.batch_size, a.exchange, a.seed,
                          a.bandwidth, a.phi_impl, a.exchange_every)
    np.save(out / "particles.npy", final)
    (out / "metrics.json").write_text(json.dumps(metrics, indent=2))
    print(json.dumps(metrics))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
