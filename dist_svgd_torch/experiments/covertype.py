"""Large-scale Bayesian logistic regression on Covertype with minibatched
stochastic scores — BASELINE.json config 4 — on the card.

Counterpart of ``experiments/covertype.py``: the same defaults (50,000 rows
of the 54-feature Covertype stand-in, 45,000 to train and 5,000 to test;
10,000 particles over 8 shards, ``all_particles``; per-shard per-step
minibatches of 256 rows; data sharded over the shards; a separate,
unscaled prior; 200 steps of 1e-4), the same metrics keys, and the same φ
policy for ``'auto'`` (:func:`resolve_phi_impl`).  Run it as

    python -m dist_svgd_torch.experiments.covertype            # the card
    python -m dist_svgd_torch.experiments.covertype --device cpu --nrows 2000 \\
        --nparticles 64 --niter 5                               # the CPU

It prints the metrics as one JSON line and writes ``metrics.json`` and
``particles.npy`` under ``--results-dir`` (default ``build/results/``), in
a directory named by every run-changing option.  The particle layout is the
reference's ``(log α, w)``, d = 55.

``--nproc 1`` runs the single-device ``Sampler`` on all the training rows.
Not ported yet, each refused with ``NotImplementedError`` naming its
ROADMAP item: the checkpoint, log and profile cadences (A8) and
``--exchange-every > 1`` (A10).
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from dist_svgd_torch.distsampler import DistSampler
from dist_svgd_torch.models.logreg import ensemble_test_accuracy, make_logreg_split
from dist_svgd_torch.ops import cuda_svgd
from dist_svgd_torch.ops.kernels import resolve_bandwidth_kernel
from dist_svgd_torch.sampler import Sampler
from dist_svgd_torch.utils.datasets import load_covertype
from dist_svgd_torch.utils.platform import resolve_device
from dist_svgd_torch.utils.rng import init_particles_per_shard

#: Where results go unless ``--results-dir`` says otherwise (ignored by git).
DEFAULT_RESULTS_DIR = Path(__file__).resolve().parents[2] / "build" / "results"

PHI_CHOICES = ("auto", "torch", "cuda", "cuda_bf16")


def resolve_phi_impl(phi_impl: str, batch_size: Optional[int], device: torch.device) -> str:
    """The driver's φ policy: ``'auto'`` resolves to the bf16 tiers
    (``'cuda_bf16'``) when, and only when, the run is minibatched and runs
    on the card — the stochastic score's sampling noise (~6% an entry at
    B = 256 of 5,625 rows a shard) is far above the bf16x3 tier's φ error.
    JAX's further gate on the per-shard pair count (its TPU-measured
    ``PALLAS_MIN_PAIRS_BIG_D``) is not carried over (ROADMAP B8).  Full-batch
    runs, the CPU and the library-level ``'auto'`` stay exact f32."""
    if phi_impl != "auto" or not batch_size:
        return phi_impl
    return "cuda_bf16" if device.type == "cuda" else phi_impl


def get_results_dir(root, nrows, nproc, nparticles, niter, stepsize, batch_size, exchange,
                    shard_data, seed, phi_impl="auto", bandwidth="1.0") -> Path:
    """``root/<name>``, the name carrying every run-changing option (the
    JAX driver's naming), created if missing."""
    name = (f"covertype-{nrows}-{nproc}-{nparticles}-{niter}-{stepsize}-{batch_size}-"
            f"{exchange}-{'shard' if shard_data else 'repl'}-{seed}")
    if phi_impl != "auto":
        name += f"-phi={phi_impl}"
    if bandwidth in ("median", "median_step") or float(bandwidth) != 1.0:
        name += f"-h={bandwidth}"
    path = Path(root) / name
    path.mkdir(parents=True, exist_ok=True)
    return path


def make_sampler(nrows=50_000, nproc=8, nparticles=10_000, batch_size=256,
                 exchange="all_particles", shard_data=True, seed=0, phi_impl="auto",
                 bandwidth="1.0", device=None):
    """The configured sampler and what :func:`run` reports with it:
    ``(sampler, (x_test, t_test), info)``, the test data on the sampler's
    device and ``info`` holding ``n_used``, ``batch_size`` (clamped to the
    per-shard rows; ``None`` when 0), the resolved ``phi_impl`` and the
    initial particles ``init``.  ``nproc == 1`` builds a :class:`Sampler`
    (which takes ``init`` through ``run(initial_particles=...)``), more
    shards a :class:`DistSampler`."""
    if exchange not in ("all_particles", "all_scores"):
        raise ValueError(f"unknown exchange {exchange!r}")
    dev = resolve_device(device)
    kernel = resolve_bandwidth_kernel(bandwidth)
    x, t = load_covertype(nrows, seed=0)
    n_test = max(nrows // 10, 1)
    x_train, t_train = x[:-n_test], t[:-n_test]
    x_test = torch.as_tensor(x[-n_test:], device=dev)
    t_test = torch.as_tensor(t[-n_test:], device=dev)
    d = 1 + x.shape[1]
    n_used = (nparticles // nproc) * nproc
    rows_per_shard = x_train.shape[0] // nproc
    batch = min(batch_size, rows_per_shard) if batch_size else None
    phi_impl = resolve_phi_impl(phi_impl, batch, dev)
    likelihood, prior = make_logreg_split()
    init = init_particles_per_shard(seed, n_used, d, nproc, device=dev)
    if nproc == 1:
        sampler = Sampler(d, likelihood, kernel=kernel, data=(x_train, t_train),
                          batch_size=batch, log_prior=prior, phi_impl=phi_impl,
                          device=dev, seed=seed)
    else:
        sampler = DistSampler(
            nproc, likelihood, kernel, init, data=(x_train, t_train),
            exchange_particles=True, exchange_scores=exchange == "all_scores",
            include_wasserstein=False, shard_data=shard_data, batch_size=batch,
            log_prior=prior, phi_impl=phi_impl, seed=seed, device=dev)
    return sampler, (x_test, t_test), {"n_used": n_used, "batch_size": batch,
                                       "phi_impl": phi_impl, "init": init}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(nrows=50_000, nproc=8, nparticles=10_000, niter=200, stepsize=1e-4, batch_size=256,
        exchange="all_particles", shard_data=True, seed=0, checkpoint_every=0,
        checkpoint_dir=None, resume=False, log_every=0, metrics_path=None, profile_dir=None,
        phi_impl="auto", bandwidth="1.0", exchange_every=1, device=None):
    """Train; returns ``(final particles as numpy, metrics dict)``.

    The metrics carry the JAX driver's keys plus ``device`` (the card's name,
    or ``'cpu'``).  The φ kernel of the run's d and tier is built and loaded
    before the clock starts (without a launch), so ``wall_s`` excludes its
    first-use build, as the BNN driver's does."""
    if checkpoint_every or resume or log_every or profile_dir or checkpoint_dir or metrics_path:
        raise NotImplementedError(
            "checkpoint / log / profile cadences are not ported to PyTorch yet "
            "(ROADMAP A8)")
    if exchange_every != 1:
        raise NotImplementedError(
            "--exchange-every > 1 (the lagged exchange) is not ported to PyTorch "
            "yet (ROADMAP A10)")
    sampler, (x_test, t_test), info = make_sampler(
        nrows, nproc, nparticles, batch_size, exchange, shard_data, seed, phi_impl,
        bandwidth, device)
    dev = sampler.device
    if dev.type == "cuda":
        cuda_svgd.load_kernel(info["init"].shape[1], info["phi_impl"])
    _sync(dev)
    t0 = time.perf_counter()
    if nproc == 1:
        final, _ = sampler.run(info["n_used"], niter, stepsize, record=False,
                               initial_particles=info["init"])
    else:
        final = sampler.run_steps(niter, stepsize)
    _sync(dev)
    wall = time.perf_counter() - t0
    n_used = info["n_used"]
    metrics = {
        "dataset": "covertype",
        "nrows": nrows,
        "nproc": nproc,
        "nparticles": n_used,
        "niter": niter,
        "stepsize": stepsize,
        "batch_size": info["batch_size"],
        "exchange": exchange,
        "shard_data": shard_data,
        "phi_impl": info["phi_impl"],
        "bandwidth": bandwidth,
        "exchange_every": exchange_every,
        "test_acc": float(ensemble_test_accuracy(final, x_test, t_test)),
        "wall_s": round(wall, 3),
        "compile_excluded": True,
        "steps_run": niter,
        "resumed_from": 0,
        "updates_per_sec": round(n_used * niter / wall, 1) if niter else 0.0,
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
    }
    return final.detach().cpu().numpy(), metrics


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m dist_svgd_torch.experiments.covertype",
        description="Minibatched Bayesian logistic regression on Covertype "
                    "(BASELINE.json config 4) with the PyTorch/CUDA port.")
    p.add_argument("--nrows", type=int, default=50_000)
    p.add_argument("--nproc", type=int, default=8,
                   help="number of shards (1: the single-device Sampler)")
    p.add_argument("--nparticles", type=int, default=10_000)
    p.add_argument("--niter", type=int, default=200)
    p.add_argument("--stepsize", type=float, default=1e-4)
    p.add_argument("--batch-size", type=int, default=256,
                   help="per-shard per-step minibatch rows (0 = the full slice)")
    p.add_argument("--exchange", choices=("all_particles", "all_scores"),
                   default="all_particles")
    p.add_argument("--shard-data", dest="shard_data", action="store_true", default=True)
    p.add_argument("--replicate-data", dest="shard_data", action="store_false")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--checkpoint-every", type=int, default=0)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--log-every", type=int, default=0)
    p.add_argument("--profile-dir", default=None)
    p.add_argument("--phi-impl", choices=PHI_CHOICES, default="auto",
                   help="φ backend; this driver's 'auto' is 'cuda_bf16' on the card "
                        "when minibatching (resolve_phi_impl)")
    p.add_argument("--bandwidth", default="1.0",
                   help="RBF bandwidth: a float (reference 1.0), 'median' (per-run "
                        "heuristic) or 'median_step' (re-estimated every step)")
    p.add_argument("--exchange-every", type=int, default=1)
    p.add_argument("--device", choices=("cuda", "cpu"), default=None,
                   help="default: the card (fails without CUDA)")
    p.add_argument("--results-dir", default=str(DEFAULT_RESULTS_DIR))
    a = p.parse_args(argv)
    if a.nproc < 1:
        p.error("--nproc must be >= 1")
    final, metrics = run(
        a.nrows, a.nproc, a.nparticles, a.niter, a.stepsize, a.batch_size, a.exchange,
        a.shard_data, a.seed, a.checkpoint_every, None, a.resume, a.log_every, None,
        a.profile_dir, a.phi_impl, a.bandwidth, a.exchange_every, a.device)
    out = get_results_dir(a.results_dir, a.nrows, a.nproc, a.nparticles, a.niter,
                          a.stepsize, a.batch_size, a.exchange, a.shard_data, a.seed,
                          metrics["phi_impl"], a.bandwidth)
    np.save(out / "particles.npy", final)
    (out / "metrics.json").write_text(json.dumps(metrics, indent=2))
    print(json.dumps(metrics))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
