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
Over the shards, the JAX driver's cadences: ``--checkpoint-every K`` saves
the sampler state every K steps (``utils/checkpoint.py:CheckpointManager``,
in ``<results dir>-ckpt`` unless ``checkpoint_dir`` says otherwise) and
``--resume`` continues from the newest loadable one, bitwise the
uninterrupted run; ``--log-every K`` writes a JSON line of
``utils/metrics.py:particle_stats`` every K steps (``metrics.jsonl`` in the
results directory); ``--profile-dir DIR`` writes a ``torch.profiler``
trace of the run.  ``--exchange-every T > 1`` runs the lagged exchange (one
gather a macro-step of T steps), as one ``run_steps`` and without the
cadences, as in JAX.
"""

from __future__ import annotations

import argparse
import json
import sys
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
from dist_svgd_torch.utils.checkpoint import CheckpointManager
from dist_svgd_torch.utils.datasets import load_covertype
from dist_svgd_torch.utils.metrics import JsonlLogger, StepTimer, particle_stats, profiler_trace
from dist_svgd_torch.utils.platform import resolve_device
from dist_svgd_torch.utils.rng import init_particles_per_shard

#: Where results go unless ``--results-dir`` says otherwise (ignored by git).
DEFAULT_RESULTS_DIR = Path(__file__).resolve().parents[2] / "build" / "results"

PHI_CHOICES = ("auto", "torch", "cuda", "cuda_bf16")


def resolve_phi_impl(phi_impl: str, batch_size: Optional[int], nparticles: int, nproc: int,
                     device: torch.device) -> str:
    """The driver's φ policy: ``'auto'`` resolves to the bf16 tiers
    (``'cuda_bf16'``) when, and only when, all three hold (JAX's gates):

    (a) the run is minibatched: the stochastic score's sampling noise (~6%
        an entry at B = 256 of 5,625 rows a shard) is far above the bf16x3
        tier's φ error;
    (b) it runs on the card;
    (c) a shard's φ clears the library's big-d line,
        ``(n // nproc) · n >= CUDA_MIN_PAIRS_BIG_D`` with
        ``n = (nparticles // nproc) · nproc`` (JAX's formula) — Covertype's
        d = 55 is a big-d shape.

    Full-batch runs, the CPU and the library-level ``'auto'`` stay exact
    f32."""
    if phi_impl != "auto" or not batch_size:
        return phi_impl
    n = (nparticles // nproc) * nproc
    if device.type == "cuda" and (n // nproc) * n >= cuda_svgd.CUDA_MIN_PAIRS_BIG_D:
        return "cuda_bf16"
    return phi_impl


def get_results_dir(root, nrows, nproc, nparticles, niter, stepsize, batch_size, exchange,
                    shard_data, seed, phi_impl="auto", bandwidth="1.0",
                    exchange_every=1) -> Path:
    """``root/<name>``, the name carrying every run-changing option (the
    JAX driver's naming), created if missing."""
    name = (f"covertype-{nrows}-{nproc}-{nparticles}-{niter}-{stepsize}-{batch_size}-"
            f"{exchange}-{'shard' if shard_data else 'repl'}-{seed}")
    if phi_impl != "auto":
        name += f"-phi={phi_impl}"
    if bandwidth in ("median", "median_step") or float(bandwidth) != 1.0:
        name += f"-h={bandwidth}"
    if exchange_every != 1:
        name += f"-T={exchange_every}"
    path = Path(root) / name
    path.mkdir(parents=True, exist_ok=True)
    return path


def make_sampler(nrows=50_000, nproc=8, nparticles=10_000, batch_size=256,
                 exchange="all_particles", shard_data=True, seed=0, phi_impl="auto",
                 bandwidth="1.0", device=None, exchange_every=1):
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
    phi_impl = resolve_phi_impl(phi_impl, batch, nparticles, nproc, dev)
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
            log_prior=prior, phi_impl=phi_impl, exchange_every=exchange_every, seed=seed,
            device=dev)
    return sampler, (x_test, t_test), {"n_used": n_used, "batch_size": batch,
                                       "phi_impl": phi_impl, "init": init}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def schedule(start: int, niter: int, log_every: int, checkpoint_every: int):
    """The sharded loop's decomposition from step index ``start`` (JAX's
    ``schedule``): everything up to the next log or checkpoint event as
    ``('chunk', k)`` runs of k steps (powers of two), the event step itself
    as an eager ``('event', i)``, so that ``prev`` keeps its per-step
    meaning."""
    def next_after(i, every):  # the first multiple of every past step index i
        return (i // every + 1) * every if every else niter

    i = start
    while i < niter:
        event = min(niter, next_after(i, log_every), next_after(i, checkpoint_every))
        gap = event - i - 1
        while gap > 0:
            chunk = 1 << (gap.bit_length() - 1)
            yield ("chunk", chunk)
            i += chunk
            gap -= chunk
        yield ("event", i)
        i += 1


def run(nrows=50_000, nproc=8, nparticles=10_000, niter=200, stepsize=1e-4, batch_size=256,
        exchange="all_particles", shard_data=True, seed=0, checkpoint_every=0,
        checkpoint_dir=None, resume=False, log_every=0, metrics_path=None, profile_dir=None,
        phi_impl="auto", bandwidth="1.0", exchange_every=1, device=None,
        results_dir=DEFAULT_RESULTS_DIR):
    """Train; returns ``(final particles as numpy, metrics dict)``.

    The metrics carry the JAX driver's keys plus ``device`` (the card's name,
    or ``'cpu'``).  The φ kernel of the run's d and tier is built and loaded
    before the clock starts (without a launch), so ``wall_s`` excludes its
    first-use build, as the BNN driver's does.

    Over the shards (``nproc > 1``), as in JAX: ``checkpoint_every > 0``
    saves the sampler state every K steps under ``checkpoint_dir`` (default
    ``<results dir>-ckpt``, the results directory under ``results_dir``
    named by every option) and ``resume`` restores the newest loadable one
    there and continues the uninterrupted trajectory; ``log_every > 0``
    writes a JSON line of particle statistics every K steps to
    ``metrics_path`` (stdout when ``None``); ``profile_dir`` traces the loop
    with ``torch.profiler``.  The loop runs :func:`schedule`'s chunks and
    eager event steps; one warm-up step before the clock, from a saved and
    restored state, leaves the trajectory as it was.  ``exchange_every >
    1`` (the lagged exchange) runs as one ``run_steps`` and refuses the
    cadences (``ValueError``)."""
    if exchange_every > 1:  # the JAX driver's checks, before any data load
        if nproc == 1:
            raise ValueError("--exchange-every > 1 is a distributed exchange cadence; it "
                             "requires --nproc > 1")
        if checkpoint_every or resume or log_every or profile_dir:
            raise ValueError("--exchange-every > 1 runs as one scanned dispatch; "
                             "checkpointing/logging/profiling cadences are unsupported "
                             "with it")
        if niter % exchange_every:
            raise ValueError(f"--niter ({niter}) must be a multiple of "
                             f"--exchange-every ({exchange_every})")
    sampler, (x_test, t_test), info = make_sampler(
        nrows, nproc, nparticles, batch_size, exchange, shard_data, seed, phi_impl,
        bandwidth, device, exchange_every)
    dev = sampler.device
    n_used = info["n_used"]
    if dev.type == "cuda":
        cuda_svgd.load_kernel(info["init"].shape[1], info["phi_impl"])
    start = 0
    if nproc == 1:
        _sync(dev)
        t0 = time.perf_counter()
        final, _ = sampler.run(n_used, niter, stepsize, record=False,
                               initial_particles=info["init"])
    elif exchange_every > 1:
        _sync(dev)
        t0 = time.perf_counter()
        final = sampler.run_steps(niter, stepsize)
    else:
        mgr = None
        if checkpoint_every or resume:
            if checkpoint_dir is None:
                checkpoint_dir = str(get_results_dir(
                    results_dir, nrows, nproc, nparticles, niter, stepsize, batch_size,
                    exchange, shard_data, seed, info["phi_impl"], bandwidth)) + "-ckpt"
            # every=0 with resume: restore only, no new checkpoints
            mgr = CheckpointManager(checkpoint_dir, every=checkpoint_every or max(niter, 1))
            if resume:
                state = mgr.restore_latest()
                if state is not None:
                    sampler.load_state_dict(state)
                    start = int(state["t"])
            else:
                mgr.clear()  # an older run's step dirs would poison retention and resume
        if start < niter:  # warm-up, then back to the same state
            state0 = sampler.state_dict()
            sampler.make_step(stepsize)
            sampler.load_state_dict(state0)
        _sync(dev)
        t0 = time.perf_counter()
        timer = StepTimer()
        last_logged = start
        stream = None if metrics_path or not log_every else sys.stdout
        with JsonlLogger(path=metrics_path, stream=stream) as logger, \
                profiler_trace(profile_dir):
            for kind, val in schedule(start, niter, log_every, checkpoint_every):
                if kind == "chunk":
                    sampler.run_steps(val, stepsize)
                    continue
                i = val
                log_now = log_every and (i + 1) % log_every == 0
                prev = sampler.particles if log_now else None
                out = sampler.make_step(stepsize)
                i += 1
                if log_now:
                    lap = timer.mark(out)
                    steps_in_lap = i - last_logged
                    last_logged = i
                    logger.log(step=i, wall_s=round(lap, 4),
                               updates_per_sec=round(n_used * steps_in_lap / lap, 1),
                               **particle_stats(out, prev))
                if checkpoint_every and mgr.should_save(i):
                    mgr.save(i, sampler.state_dict())
        final = sampler.particles
    _sync(dev)
    wall = time.perf_counter() - t0
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
        "steps_run": niter - start,
        "resumed_from": start,
        "updates_per_sec": (round(n_used * max(niter - start, 0) / wall, 1)
                            if niter > start else 0.0),
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
    p.add_argument("--checkpoint-every", type=int, default=0,
                   help="save sampler state every K steps (0 = off; --nproc > 1 only)")
    p.add_argument("--resume", action="store_true",
                   help="restore the newest checkpoint and continue")
    p.add_argument("--log-every", type=int, default=0,
                   help="write per-step JSONL metrics every K steps (0 = off)")
    p.add_argument("--profile-dir", default=None,
                   help="torch.profiler trace output directory (Chrome trace)")
    p.add_argument("--phi-impl", choices=PHI_CHOICES, default="auto",
                   help="φ backend; this driver's 'auto' is 'cuda_bf16' on the card "
                        "when minibatching (resolve_phi_impl)")
    p.add_argument("--bandwidth", default="1.0",
                   help="RBF bandwidth: a float (reference 1.0), 'median' (per-run "
                        "heuristic) or 'median_step' (re-estimated every step)")
    p.add_argument("--exchange-every", type=int, default=1,
                   help="gather cadence T: T > 1 = the lagged exchange (all_particles, "
                        "--nproc > 1, --niter a multiple of T, no cadences)")
    p.add_argument("--device", choices=("cuda", "cpu"), default=None,
                   help="default: the card (fails without CUDA)")
    p.add_argument("--results-dir", default=str(DEFAULT_RESULTS_DIR))
    a = p.parse_args(argv)
    if a.nproc < 1:
        p.error("--nproc must be >= 1")
    if a.exchange_every < 1:
        p.error("--exchange-every must be >= 1")
    # resolved before the names, as in JAX: results and checkpoints are keyed
    # by the backend that runs
    phi_impl = resolve_phi_impl(a.phi_impl, a.batch_size, a.nparticles, a.nproc,
                                resolve_device(a.device))
    out = get_results_dir(a.results_dir, a.nrows, a.nproc, a.nparticles, a.niter,
                          a.stepsize, a.batch_size, a.exchange, a.shard_data, a.seed,
                          phi_impl, a.bandwidth, a.exchange_every)
    final, metrics = run(
        a.nrows, a.nproc, a.nparticles, a.niter, a.stepsize, a.batch_size, a.exchange,
        a.shard_data, a.seed, a.checkpoint_every,
        str(out) + "-ckpt" if a.checkpoint_every else None, a.resume, a.log_every,
        str(out / "metrics.jsonl") if a.log_every else None, a.profile_dir, phi_impl,
        a.bandwidth, a.exchange_every, a.device, a.results_dir)
    np.save(out / "particles.npy", final)
    (out / "metrics.json").write_text(json.dumps(metrics, indent=2))
    print(json.dumps(metrics))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
