"""Resilient Covertype training: kill mid-run → resume, with zero trajectory
deviation, on the card.

Counterpart of ``experiments/resilient_covertype.py``, all five stages:

1. **reference** — an uninterrupted *supervised* run
   (``resilience.RunSupervisor`` driving a sharded minibatched Covertype
   ``DistSampler`` with periodic checkpointing) to ``--niter`` steps;
2. **kill** — the identical run is interrupted by an injected preemption at
   ``--kill-step`` (pass ``--real-signals`` to instead install SIGTERM/
   SIGINT handlers and send the signal yourself): the supervisor
   checkpoints at the boundary and reports ``preempted``;
3. **resume** — a fresh supervisor restores the latest checkpoint and runs
   to completion; the final particle state must be **bitwise identical** to
   the reference run's (``max_abs_dev_vs_uninterrupted`` printed, asserted
   0.0);
4. **serve** — started before 3 resumes: a ``serving.PredictiveEngine``
   cold-starts from the kill run's checkpoint root (its newest step, the
   preemption's save), builds its buckets, answers ``--requests`` test
   rows, and a ``CheckpointHotReloader`` watches that root while the
   resumed trainer writes into it — train-while-serving;
5. **hot reload** — one ``poll_once`` after the resume swaps the resumed
   run's newest checkpoint in; the served means are held against a direct
   ``posterior_predictive_prob`` call on the final ensemble.

The JSON line carries JAX's keys, ``serve`` among them
(``test_acc_final`` inside it: the resumed ensemble's test accuracy).
JAX's ``--backend`` is ``--device`` here: the card unless ``--device
cpu``.  Run it as

    python -m dist_svgd_torch.experiments.resilient_covertype      # the card
    python -m dist_svgd_torch.experiments.resilient_covertype --device cpu \\
        --nrows 2000 --nproc 2 --nparticles 64 --niter 12 \\
        --checkpoint-every 4 --segment-steps 2 --kill-step 6

It prints one JSON line with the per-stage evidence (JAX's keys).  The
sampler is JAX's: ``all_particles``, data sharded over the shards, per-shard
minibatches, a separate unscaled prior, no W2 term, the library's φ policy
(on the card the exact big-d kernel at d = 55).
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile

import numpy as np
import torch

from dist_svgd_torch.distsampler import DistSampler
from dist_svgd_torch.models.logreg import (
    ensemble_test_accuracy,
    make_logreg_split,
    posterior_predictive_prob,
)
from dist_svgd_torch.resilience import FaultPlan, PreemptAt, RunSupervisor
from dist_svgd_torch.serving import CheckpointHotReloader, PredictiveEngine
from dist_svgd_torch.utils.datasets import load_covertype
from dist_svgd_torch.utils.platform import resolve_device
from dist_svgd_torch.utils.rng import init_particles_per_shard


def build(nrows=20_000, nproc=4, nparticles=512, batch_size=256, seed=0, device=None):
    """The driver's sampler factory and test split: ``(make_sampler,
    (x_test, t_test), n_used)``.  Each ``make_sampler()`` call builds a
    fresh, identical ``DistSampler`` (JAX's driver's), its data on the
    device."""
    dev = resolve_device(device)
    x, t = load_covertype(nrows, seed=0)
    n_test = max(nrows // 10, 1)
    x_train = torch.as_tensor(x[:-n_test], device=dev)
    t_train = torch.as_tensor(t[:-n_test], device=dev)
    x_test = torch.as_tensor(x[-n_test:].astype(np.float32), device=dev)
    t_test = torch.as_tensor(t[-n_test:], device=dev)
    d = 1 + x.shape[1]
    likelihood, prior = make_logreg_split()
    n_used = (nparticles // nproc) * nproc
    rows_per_shard = x_train.shape[0] // nproc
    batch = min(batch_size, rows_per_shard) if batch_size else None

    def make_sampler():
        return DistSampler(
            nproc, likelihood, None, init_particles_per_shard(seed, n_used, d, nproc),
            data=(x_train, t_train), exchange_particles=True, exchange_scores=False,
            include_wasserstein=False, shard_data=True, batch_size=batch,
            log_prior=prior, seed=seed, device=dev)

    return make_sampler, (x_test, t_test), n_used


def run(nrows=20_000, nproc=4, nparticles=512, niter=60, stepsize=1e-4, batch_size=256,
        checkpoint_every=20, segment_steps=10, kill_step=30, seed=0, root=None,
        real_signals=False, device=None, requests=32):
    """The five stages; returns ``(out, reports)``: ``out`` the JSON line's
    dict, ``reports`` the three supervisor reports (``reference``,
    ``kill``, ``resume``) and ``"engine"``, the serving engine of stages
    4–5.  ``root`` (default: a temporary directory, removed on
    return) holds ``reference/`` and ``killed/``, one checkpoint root each.
    Raises ``AssertionError`` when the resumed run is not bitwise the
    reference."""
    make_sampler, (x_test, t_test), n_used = build(nrows, nproc, nparticles, batch_size,
                                                   seed, device)
    cleanup = root is None
    root = root or tempfile.mkdtemp(prefix="resilient_covertype_")
    out = {"nrows": nrows, "nproc": nproc, "nparticles": n_used, "niter": niter,
           "checkpoint_every": checkpoint_every, "segment_steps": segment_steps,
           "root": root}
    reports = {}
    try:
        # 1. reference: uninterrupted supervised run
        sup_ref = RunSupervisor(
            make_sampler(), niter, stepsize, checkpoint_dir=os.path.join(root, "reference"),
            checkpoint_every=checkpoint_every, segment_steps=segment_steps)
        reports["reference"] = sup_ref.run()
        out["reference"] = {k: reports["reference"][k] for k in ("status", "t", "checkpoints")}
        final_ref = sup_ref.particles.detach().cpu().numpy()

        # 2. kill mid-run (injected preemption, or real signals + your kill)
        kill_root = os.path.join(root, "killed")
        sup_kill = RunSupervisor(
            make_sampler(), niter, stepsize, checkpoint_dir=kill_root,
            checkpoint_every=checkpoint_every, segment_steps=segment_steps,
            faults=None if real_signals else FaultPlan(PreemptAt(kill_step)))
        if real_signals:
            sup_kill.install_signal_handlers()
            print(f"PID {os.getpid()}: send SIGTERM to preempt", file=sys.stderr, flush=True)
        reports["kill"] = sup_kill.run()
        out["kill"] = {k: reports["kill"][k] for k in ("status", "t")}

        # 4 (starts before 3 — that is the point): serve the preemption
        # checkpoint while the resumed trainer is still to come.  Cold start
        # from the kill root's newest step (the signal-triggered save), build
        # the buckets, attach the watcher with that step as its baseline.
        x_req = x_test[:requests].cpu().numpy()
        engine = PredictiveEngine.from_checkpoint(kill_root, "logreg", max_bucket=64,
                                                  device=x_test.device)
        engine.warmup()
        served_before = engine.predict(x_req)["mean"]
        reloader = CheckpointHotReloader(engine, kill_root)
        reports["engine"] = engine

        # 3. resume → bitwise-identical final state.  The supervisor writes
        # its periodic checkpoints into the SAME root the engine watches
        sup_res = RunSupervisor(
            make_sampler(), niter, stepsize, checkpoint_dir=kill_root,
            checkpoint_every=checkpoint_every, segment_steps=segment_steps)
        reports["resume"] = sup_res.run(resume=True)
        final_res = sup_res.particles.detach().cpu().numpy()
        max_dev = float(np.max(np.abs(final_ref - final_res)))
        out["resume"] = {
            "status": reports["resume"]["status"],
            "resumed_from": reports["resume"]["resumed_from"],
            "max_abs_dev_vs_uninterrupted": max_dev,
            "bitwise_identical": bool(np.array_equal(final_ref, final_res)),
        }
        assert out["resume"]["bitwise_identical"], (
            f"resumed trajectory deviates: max abs dev {max_dev}")

        # 5. hot reload: the watcher sees the resumed run's newer
        # checkpoints and swaps the served ensemble between micro-batches
        swapped_step = reloader.poll_once()
        served_after = engine.predict(x_req)["mean"]
        with torch.no_grad():
            direct = posterior_predictive_prob(
                sup_res.particles, x_test[:requests]).mean(0).cpu().numpy()
        stats = engine.stats()
        t_req = t_test[:requests].cpu().numpy()
        out["serve"] = {
            "cold_start_particles": engine.n_particles,
            "hot_reload_step": swapped_step,
            "reloads": stats["reloads"],
            "ensemble_tag": stats["ensemble_tag"],
            "served_vs_direct_max_abs_dev": float(np.max(np.abs(served_after - direct))),
            "served_drift_on_reload": float(np.max(np.abs(served_after - served_before))),
            "served_test_acc": float(np.mean((served_after > 0.5) == (t_req > 0))),
            "test_acc_final": float(ensemble_test_accuracy(sup_res.particles, x_test,
                                                           t_test)),
        }
    finally:
        if cleanup:
            shutil.rmtree(root, ignore_errors=True)
    return out, reports


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m dist_svgd_torch.experiments.resilient_covertype",
        description="Supervised Covertype training: kill mid-run, resume, and check the "
                    "resumed run is bitwise the uninterrupted one.")
    p.add_argument("--nrows", type=int, default=20_000)
    p.add_argument("--nproc", type=int, default=4, help="number of shards (1-32)")
    p.add_argument("--nparticles", type=int, default=512)
    p.add_argument("--niter", type=int, default=60)
    p.add_argument("--stepsize", type=float, default=1e-4)
    p.add_argument("--batch-size", type=int, default=256)
    p.add_argument("--checkpoint-every", type=int, default=20)
    p.add_argument("--segment-steps", type=int, default=10)
    p.add_argument("--kill-step", type=int, default=30,
                   help="injected preemption step (honoured at the next segment "
                        "boundary, like a real SIGTERM)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--root", default=None,
                   help="checkpoint root (default: a temp dir, removed on exit)")
    p.add_argument("--real-signals", dest="real_signals", action="store_true",
                   default=False,
                   help="install real SIGTERM/SIGINT handlers on the kill run instead "
                        "of injecting the preemption")
    p.add_argument("--injected-signals", dest="real_signals", action="store_false")
    p.add_argument("--requests", type=int, default=32,
                   help="test rows the engine answers before and after the hot reload")
    p.add_argument("--device", choices=("cuda", "cpu"), default=None,
                   help="default: the card (fails without CUDA)")
    a = p.parse_args(argv)
    if not 1 <= a.nproc <= 32:
        p.error("--nproc must be in [1, 32]")
    out, _ = run(a.nrows, a.nproc, a.nparticles, a.niter, a.stepsize, a.batch_size,
                 a.checkpoint_every, a.segment_steps, a.kill_step, a.seed, a.root,
                 a.real_signals, a.device, a.requests)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
