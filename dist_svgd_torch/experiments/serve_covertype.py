"""Covertype train → checkpoint → serve: the full posterior-predictive
serving path on the flagship minibatched workload.

Counterpart of ``experiments/serve_covertype.py``.  Three stages, one
command:

1. **train**: a sharded Covertype logreg ensemble through the port's
   Covertype driver (``experiments/covertype.py:run``) with one checkpoint
   at the final step (skipped with ``--no-train`` when the checkpoint root
   already holds a restorable step).  On the card the driver's ``'auto'``
   φ is the bf16 tier at these sizes (``phi_big_d_bf16x3``);
2. **cold start**: ``PredictiveEngine.from_checkpoint`` on the
   ``CheckpointManager`` root — the newest *loadable* step wins — and every
   padding bucket built (one CUDA graph each on the card);
3. **serve**: an in-process :class:`PredictionServer` self-test —
   concurrent mixed-size HTTP requests over the held-out rows, the served
   class-probability means held against a direct
   ``posterior_predictive_prob`` call on the restored ensemble — then, with
   ``--serve``, it stays up for external traffic until interrupted.

Prints one JSON line with JAX's keys: the test accuracy of the *served*
predictions, their largest distance from the direct call, the serving
metrics snapshot, and the bound URL.  JAX's ``--backend`` is ``--device``
here: the card unless ``--device cpu``.  Run it as

    python -m dist_svgd_torch.experiments.serve_covertype          # the card
    python -m dist_svgd_torch.experiments.serve_covertype --device cpu \\
        --nrows 2000 --nproc 2 --nparticles 64 --niter 5 --requests 16
"""

from __future__ import annotations

import argparse
import json
import sys
import threading
import urllib.request

import numpy as np
import torch

from dist_svgd_torch.experiments import covertype
from dist_svgd_torch.models.logreg import posterior_predictive_prob
from dist_svgd_torch.serving import PredictionServer, PredictiveEngine
from dist_svgd_torch.utils.datasets import load_covertype
from dist_svgd_torch.utils.platform import resolve_device


def default_checkpoint_dir(nrows, nproc, nparticles, niter, stepsize, batch_size, seed,
                           device) -> str:
    """The Covertype driver's results-dir convention + ``-ckpt``."""
    phi_impl = covertype.resolve_phi_impl("auto", batch_size, nparticles, nproc, device)
    return str(covertype.get_results_dir(
        covertype.DEFAULT_RESULTS_DIR, nrows, nproc, nparticles, niter, stepsize,
        batch_size, "all_particles", True, seed, phi_impl)) + "-ckpt"


def run(nrows=20_000, nproc=8, nparticles=1024, niter=100, stepsize=1e-4, batch_size=256,
        seed=0, train=True, checkpoint_dir=None, requests=64, max_batch=128,
        max_wait_ms=2.0, port=0, serve=False, device=None) -> dict:
    """The three stages; returns the JSON line's dict (JAX's keys) plus
    ``"train"``, the training run's metrics (``None`` with
    ``train=False``)."""
    dev = resolve_device(device)
    if checkpoint_dir is None:
        checkpoint_dir = default_checkpoint_dir(nrows, nproc, nparticles, niter, stepsize,
                                                batch_size, seed, dev)
    train_metrics = None
    if train:
        # checkpoint_every=niter → exactly one save, at the final step
        _, train_metrics = covertype.run(
            nrows=nrows, nproc=nproc, nparticles=nparticles, niter=niter,
            stepsize=stepsize, batch_size=batch_size, seed=seed,
            checkpoint_every=niter, checkpoint_dir=checkpoint_dir, device=dev)

    engine = PredictiveEngine.from_checkpoint(checkpoint_dir, "logreg",
                                              max_bucket=max_batch, device=dev)
    engine.warmup()

    # the same held-out convention as covertype.run
    x, t = load_covertype(nrows, seed=0)
    n_test = max(nrows // 10, 1)
    x_test, t_test = x[-n_test:].astype(np.float32), t[-n_test:]

    with PredictionServer(engine, port=port, max_batch=max_batch,
                          max_wait_ms=max_wait_ms) as srv:
        # self-test: concurrent mixed-size requests covering the test rows
        rng = np.random.default_rng(seed)
        sizes = rng.choice((1, 4, 16), size=requests).tolist()
        slices, cursor = [], 0
        for s in sizes:
            slices.append((cursor, min(cursor + s, len(x_test))))
            cursor = min(cursor + s, len(x_test))
        slices = [(a, b) for a, b in slices if b > a]
        served = np.full(len(x_test), np.nan, np.float64)
        request_errors = []

        def fire(a, b):
            try:
                req = urllib.request.Request(
                    srv.url + "/predict",
                    json.dumps({"inputs": x_test[a:b].tolist()}).encode(),
                    {"Content-Type": "application/json"},
                )
                out = json.loads(urllib.request.urlopen(req, timeout=60).read())
                served[a:b] = out["outputs"]["mean"]
            except Exception as e:  # surfaced below — a quiet thread death
                request_errors.append(f"rows {a}:{b}: {type(e).__name__}: {e}")

        threads = [threading.Thread(target=fire, args=ab) for ab in slices]
        for th in threads:
            th.start()
        for th in threads:
            th.join()

        covered = ~np.isnan(served)
        if not covered.any():
            raise RuntimeError(json.dumps({
                "error": "every self-test request failed",
                "request_errors": request_errors[:5],
            }))
        with torch.no_grad():
            direct = posterior_predictive_prob(
                engine.particles, torch.as_tensor(x_test[covered], device=dev)
            ).mean(0).cpu().numpy()
        # the wire is JSON floats of the served f32 values
        max_dev = float(np.max(np.abs(served[covered] - direct)))
        acc = float(np.mean((served[covered] > 0.5) == (t_test[covered] > 0)))
        out = {
            "checkpoint_dir": checkpoint_dir,
            "url": srv.url,
            "rows_served": int(covered.sum()),
            "request_errors": request_errors,
            "served_test_acc": round(acc, 4),
            "served_vs_direct_max_abs_dev": max_dev,
            "metrics": srv.metrics(),
        }
        if serve:
            print(json.dumps(out), flush=True)
            print(f"serving on {srv.url} — Ctrl-C to drain and exit", file=sys.stderr,
                  flush=True)
            try:
                threading.Event().wait()
            except KeyboardInterrupt:
                pass
    out["train"] = train_metrics
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m dist_svgd_torch.experiments.serve_covertype",
        description="Covertype train → checkpoint → serve, with a concurrent HTTP "
                    "self-test of the served predictions.")
    p.add_argument("--nrows", type=int, default=20_000)
    p.add_argument("--nproc", type=int, default=8, help="number of shards (1-32)")
    p.add_argument("--nparticles", type=int, default=1024)
    p.add_argument("--niter", type=int, default=100)
    p.add_argument("--stepsize", type=float, default=1e-4)
    p.add_argument("--batch-size", type=int, default=256)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--train", dest="train", action="store_true", default=True,
                   help="train first (the default)")
    p.add_argument("--no-train", dest="train", action="store_false",
                   help="serve the existing checkpoint as-is")
    p.add_argument("--checkpoint-dir", default=None,
                   help="CheckpointManager root (default: the Covertype driver's "
                        "results dir + '-ckpt')")
    p.add_argument("--requests", type=int, default=64,
                   help="self-test request count (concurrent, mixed sizes)")
    p.add_argument("--max-batch", type=int, default=128)
    p.add_argument("--max-wait-ms", type=float, default=2.0)
    p.add_argument("--port", type=int, default=0,
                   help="0 binds an ephemeral port for the self-test")
    p.add_argument("--serve", dest="serve", action="store_true", default=False,
                   help="stay up for external traffic after the self-test")
    p.add_argument("--no-serve", dest="serve", action="store_false")
    p.add_argument("--device", choices=("cuda", "cpu"), default=None,
                   help="default: the card (fails without CUDA)")
    a = p.parse_args(argv)
    if not 1 <= a.nproc <= 32:
        p.error("--nproc must be in [1, 32]")
    out = run(a.nrows, a.nproc, a.nparticles, a.niter, a.stepsize, a.batch_size, a.seed,
              a.train, a.checkpoint_dir, a.requests, a.max_batch, a.max_wait_ms, a.port,
              a.serve, a.device)
    out.pop("train")
    if not a.serve:
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
