"""Benchmark suite over BASELINE.json's five configs, on the card.

Counterpart of ``experiments/bench_suite.py``: every BASELINE.json config
plus a world-size scaling table shaped like the reference's only published
timing table (reference ``notes.md:120-135``, reproduced in BASELINE.md):

1. Bayesian logistic regression, 100 particles, single process.
2. 1-D Gaussian-mixture posterior, 256 particles.
3. Bayesian logistic regression, 10k particles, sharded over 8 shards.
4. Bayesian logistic regression, 10k particles, Covertype, minibatched
   scores, data sharded over the shards.
5. 2-layer Bayesian NN regression (UCI), 500 particles, weight-vector SVGD.

Each config prints one JSON line ``{"config": ..., "updates_per_sec": ...}``
with JAX's keys plus ``device`` (the card's name, or ``'cpu'``); ``--table``
also prints markdown tables.  A ``DistSampler`` without a mesh runs all its
shards on one device, so every row of more than one shard is labelled
``"emulated": true`` — single-card numbers, not a multi-card claim.

Timing protocol: warm up with the same shapes first, then time execution
only — state-chained calls under one trailing fence
(``tools/step_timing.py:timed_chain``, the best of :data:`CHAIN`'s samples).

The acceptance rows (configs 4 and 5) compare against sklearn baselines on
the same splits.  The card has no sklearn, so those baselines were computed
off the card and committed: ``acceptance_targets.json`` beside this file,
which names its loaders and sklearn version.  The suite always reads that
file.

Run ``python -m dist_svgd_torch.experiments.bench_suite`` on the card;
``--device cpu`` runs the plain PyTorch path (a smoke run: acceptance is
off there unless ``--acceptance on``).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Optional

import torch

from dist_svgd_torch.distsampler import DistSampler
from dist_svgd_torch.experiments.covertype import resolve_phi_impl
from dist_svgd_torch.models import bnn
from dist_svgd_torch.models.gmm import gmm_logp
from dist_svgd_torch.models.logreg import (
    ensemble_test_accuracy,
    logreg_likelihood,
    logreg_logp,
    logreg_prior,
    make_logreg_split,
)
from dist_svgd_torch.sampler import Sampler
from dist_svgd_torch.tools.step_timing import (
    REFERENCE_BEST_UPDATES_PER_SEC,
    describe_device,
    fence,
    timed_chain,
)
from dist_svgd_torch.utils.datasets import load_benchmark, load_covertype, load_uci_regression
from dist_svgd_torch.utils.platform import resolve_device
from dist_svgd_torch.utils.rng import init_particles_per_shard

#: The committed sklearn baselines of the acceptance rows.
TARGETS_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "acceptance_targets.json")

#: ``timed_chain``'s samples and work a sample (seconds), read at each
#: timing; a caller with a wall budget may shrink them.
CHAIN = {"samples": 3, "target_s": 1.0}

#: The reference's wall at its 50-particle table's world sizes, 500
#: iterations (reference ``notes.md:128-132``): its own numbers.
REFERENCE_WALL_S = {1: 2007.11, 2: 538.59, 4: 157.17, 8: 59.353}


def _platform(dev: torch.device) -> str:
    return "gpu" if dev.type == "cuda" else "cpu"


def _emulated(num_shards: int) -> bool:
    """A ``DistSampler`` without a mesh runs every shard on one device:
    more than one shard is an emulation, whatever cards the host has."""
    return num_shards > 1


def acceptance_targets() -> dict:
    with open(TARGETS_PATH) as fh:
        return json.load(fh)


def _time_sampler_run(sampler, n, iters, step_size, initial_particles=None):
    """Warm up, then time with the chained protocol: each ``run`` continues
    from the previous output, one fence at a sample's end."""
    state = {"out": initial_particles}

    def run_one():
        state["out"] = sampler.run(
            n, iters, step_size, seed=0, record=False,
            initial_particles=state["out"],
        )[0]
        return state["out"]

    fence(run_one())
    return timed_chain(run_one, **CHAIN)


def _time_dist_steps(sampler, iters, step_size, **run_kwargs):
    """Time ``DistSampler.run_steps`` with the same protocol (``run_steps``
    is stateful, so calls chain); ``run_kwargs`` pass through (e.g. the W2
    weight ``h``)."""
    fence(sampler.run_steps(iters, step_size, **run_kwargs))  # warm-up, untimed
    return timed_chain(lambda: sampler.run_steps(iters, step_size, **run_kwargs), **CHAIN)


def _result(config, n, iters, wall, dev, **extra):
    res = {
        "config": config,
        "n_particles": n,
        "n_iters": iters,
        "wall_s": round(wall, 4),
        "updates_per_sec": round(n * iters / wall, 1),
        "vs_reference_best": round(n * iters / wall / REFERENCE_BEST_UPDATES_PER_SEC, 2),
        "platform": _platform(dev),
        "device": describe_device(dev),
    }
    res.update(extra)
    return res


def _banana():
    """Banana fold 42's training rows and the logistic model's d."""
    fold = load_benchmark("banana", 42)
    return (fold.x_train, fold.t_train.reshape(-1)), 1 + fold.x_train.shape[1]


# --------------------------------------------------------------------- #
# The five BASELINE.json configs


def bench_logreg_single(iters, device=None):
    """Config 1: BayesLR banana, 100 particles, single process.  The data
    rides the sampler (cast to the particles' dtype) where JAX's logp
    closes over it: the same full-batch score."""
    dev = resolve_device(device)
    data, d = _banana()
    sampler = Sampler(d, logreg_logp, data=data, device=dev)
    wall = _time_sampler_run(sampler, 100, iters, 3e-3)
    return _result("1:logreg-single-100p", 100, iters, wall, dev, dataset="banana")


def bench_gmm(iters, device=None):
    """Config 2: 1-D GMM posterior, 256 particles."""
    dev = resolve_device(device)
    sampler = Sampler(1, gmm_logp, device=dev)
    wall = _time_sampler_run(sampler, 256, iters, 1.0)
    return _result("2:gmm-256p", 256, iters, wall, dev)


def bench_logreg_sharded(iters, num_shards=8, n_particles=10_000, device=None):
    """Config 3: BayesLR, 10k particles sharded over 8 shards
    (``all_particles`` exchange — the BASELINE.json north-star mode)."""
    dev = resolve_device(device)
    data, d = _banana()
    particles = init_particles_per_shard(0, n_particles, d, num_shards)
    sampler = DistSampler(
        num_shards, logreg_logp, None, particles, data=data,
        exchange_particles=True, exchange_scores=False,
        include_wasserstein=False, device=dev,
    )
    wall = _time_dist_steps(sampler, iters, 3e-3)
    return _result(
        "3:logreg-sharded-10kp", sampler.num_particles, iters, wall, dev,
        num_shards=num_shards, emulated=_emulated(num_shards), dataset="banana",
    )


def bench_covertype_minibatch(iters, num_shards=8, n_particles=10_000,
                              n_rows=50_000, batch_size=256,
                              acceptance=False, device=None):
    """Config 4: BayesLR, 10k particles, Covertype, minibatched scores,
    data sharded (not replicated) over the shards.

    ``acceptance=True`` also runs the sklearn-baseline acceptance (mirroring
    the reference's LogisticRegression line, reference
    ``experiments/logreg_plots.py:37-39``): the target is the sklearn
    accuracy on the driver's train/test split − 0.01 (committed in
    :data:`TARGETS_PATH` for ``n_rows = 50,000``; other sizes have no
    target and raise), and the row reports steps-to-target at the driver's
    step size with the ``median_step`` kernel, evaluated every 100 steps up
    to 1500.  A change that trades accuracy for updates/s turns
    ``steps_to_target`` into ``null``.
    """
    dev = resolve_device(device)
    x, t = load_covertype(n_rows)
    d = 1 + x.shape[1]
    particles = init_particles_per_shard(0, n_particles, d, num_shards)
    # the covertype driver's φ policy: the bf16x3 tier only when
    # minibatched, on the card and past the big-d line
    phi_impl = resolve_phi_impl("auto", batch_size, n_particles, num_shards, dev)
    sampler = DistSampler(
        num_shards, logreg_likelihood, None, particles, data=(x, t),
        exchange_particles=True, exchange_scores=False,
        include_wasserstein=False, shard_data=True,
        batch_size=batch_size, log_prior=logreg_prior, phi_impl=phi_impl,
        device=dev,
    )
    wall = _time_dist_steps(sampler, iters, 1e-4)
    extra = {}
    if acceptance:
        # same split as experiments/covertype.py:run (last tenth is test)
        n_test = max(n_rows // 10, 1)
        tgt = acceptance_targets()["covertype"]
        if (tgt["n_rows"], tgt["n_test"]) != (n_rows, n_test):
            raise ValueError(
                f"the committed Covertype target is for n_rows={tgt['n_rows']}, "
                f"not {n_rows}; see {TARGETS_PATH}")
        baseline, target = tgt["sklearn_acc"], tgt["target_acc"]
        lik, prior = make_logreg_split()
        acc_sampler = DistSampler(
            num_shards, lik, "median_step",
            init_particles_per_shard(0, n_particles, d, num_shards),
            data=(x[:-n_test], t[:-n_test]),
            exchange_particles=True, exchange_scores=False,
            include_wasserstein=False, shard_data=True,
            batch_size=batch_size, log_prior=prior, phi_impl=phi_impl,
            device=dev,
        )
        xte = torch.as_tensor(x[-n_test:], device=dev)
        tte = torch.as_tensor(t[-n_test:], device=dev, dtype=xte.dtype)
        eval_every, cap, steps, acc = 100, 1500, 0, 0.0
        reached = None
        while steps < cap:
            acc_sampler.run_steps(eval_every, 1e-4)
            steps += eval_every
            acc = float(ensemble_test_accuracy(acc_sampler.particles, xte, tte))
            if acc >= target:
                reached = steps
                break
        extra = {
            "sklearn_acc": round(baseline, 4),
            "target_acc": round(target, 4),
            "steps_to_target": reached,
            "final_acc": round(acc, 4),
            "acceptance_kernel": "median_step",
        }
    return _result(
        "4:covertype-minibatch-10kp", sampler.num_particles, iters, wall, dev,
        num_shards=num_shards, emulated=_emulated(num_shards),
        n_rows=n_rows, batch_size=batch_size, phi_impl=phi_impl, **extra,
    )


def bench_bnn(iters, n_particles=500, dataset="boston", batch_size=100,
              acceptance=False, device=None):
    """Config 5: 2-layer Bayesian NN regression (UCI), 500 particles.

    ``acceptance=True`` adds the sklearn-baseline acceptance: the target is
    the ``BayesianRidge`` test RMSE on the same split (committed in
    :data:`TARGETS_PATH` for boston's split 0; another set raises) — the
    Bayesian *linear* baseline, the regression analog of the reference's
    LogisticRegression line — and the row reports the first step, in
    chunks of 50 up to 2000, at which the ensemble's posterior-predictive
    RMSE beats it.  The committed ``GradientBoostingRegressor`` RMSE rides
    along as stretch context.
    """
    dev = resolve_device(device)
    split = load_uci_regression(dataset, 0)
    n_features = split.x_train.shape[1]
    likelihood, prior = bnn.make_bnn_split(n_features)
    d = bnn.num_params(n_features)
    init = bnn.init_particles(0, n_particles, n_features, device=dev)
    data = (split.x_train, split.y_train)
    batch = min(batch_size, split.x_train.shape[0])
    sampler = Sampler(d, likelihood, data=data, batch_size=batch, log_prior=prior, device=dev)
    wall = _time_sampler_run(sampler, n_particles, iters, 1e-3, initial_particles=init)
    extra = {}
    if acceptance:
        tgt = acceptance_targets()["bnn"]
        if (tgt["dataset"], tgt["split"]) != (dataset, 0):
            raise ValueError(
                f"the committed BNN target is for {tgt['dataset']!r} split {tgt['split']}, "
                f"not {dataset!r}; see {TARGETS_PATH}")
        target, gbr = tgt["bayesridge_rmse"], tgt["gbr_rmse_context"]
        acc_sampler = Sampler(d, likelihood, data=data, batch_size=batch, log_prior=prior,
                              kernel="median_step", device=dev)
        x_test = torch.as_tensor(split.x_test, device=dev)
        parts = bnn.init_particles(1, n_particles, n_features, device=dev)
        eval_every, cap, steps, rmse = 50, 2000, 0, float("inf")
        reached = None
        while steps < cap:
            # seed=steps: each chunk draws fresh minibatch streams — a fixed
            # seed would replay the same eval_every draws every chunk
            parts, _ = acc_sampler.run(
                n_particles, eval_every, 1e-3, record=False,
                initial_particles=parts, seed=steps,
            )
            steps += eval_every
            rmse = float(bnn.ensemble_rmse(
                parts, x_test, split.y_test, n_features,
                y_mean=split.y_mean, y_std=split.y_std,
            ))
            if rmse <= target:
                reached = steps
                break
        extra = {
            "bayesridge_rmse": round(target, 4),
            "gbr_rmse_context": round(gbr, 4),
            "steps_to_target": reached,
            "final_rmse": round(rmse, 4),
            "acceptance_kernel": "median_step",
        }
    return _result(
        "5:bnn-uci-500p", n_particles, iters, wall, dev,
        dataset=dataset, d=d, batch_size=batch_size, **extra,
    )


# --------------------------------------------------------------------- #
# World-size scaling tables (the reference table's shape, notes.md:128-132)


def scaling_table_10k(iters, world_sizes=(1, 2, 4, 8), n_particles=10_000,
                      wasserstein=False, device=None):
    """Compute-bound scaling curve: banana logreg at 10k particles in
    ``partitions`` mode, world sizes 1/2/4/8 (``wasserstein=True`` adds the
    Sinkhorn W2 term at h = 10 — :func:`scaling_table_w2`).

    The ``partitions`` interaction set is the owned block (n/S particles),
    so a step's pair count is n²/S — shards help even on one card, the
    mechanism behind the reference's superlinear table (its per-pair inner
    loop shrank with S, notes.md:120-135).  The ``all_*`` modes are
    work-conserving on one card (each shard still meets all n particles),
    hence flat there."""
    dev = resolve_device(device)
    data, d = _banana()
    rows = []
    for ws in world_sizes:
        particles = init_particles_per_shard(0, n_particles, d, ws)
        sampler = DistSampler(
            ws, logreg_logp, None, particles, data=data,
            exchange_particles=False, exchange_scores=False,
            include_wasserstein=wasserstein, wasserstein_solver="sinkhorn",
            device=dev,
        )
        wall = _time_dist_steps(sampler, iters, 3e-3, h=10.0 if wasserstein else 1.0)
        label = "scaling10k-w2" if wasserstein else "scaling10k"
        rows.append(_result(
            f"{label}:ws{ws}", sampler.num_particles, iters, wall, dev,
            num_shards=ws, emulated=_emulated(ws), exchange="partitions",
            **({"wasserstein": True, "w2_pairing": sampler.w2_pairing}
               if wasserstein else {}),
        ))
    return rows


# --------------------------------------------------------------------- #
# Chunked-vs-monolithic A/B (bounded multi-dispatch stepping)


def bench_chunked_ab(iters, num_shards=8, n_particles=10_000, device=None):
    """A/B of the bounded multi-dispatch executor against the monolithic
    run at a size where both fit a dispatch — the pure *chunking overhead*
    (a dispatch's fixed cost × dispatches a step).

    Config: banana logreg, ring ``all_particles`` exchange (the exchange
    with a seam inside a step), ``hops_per_dispatch=1`` — the finest
    chunking, hence the worst-case overhead.  One row an execution; the
    chunked row records ``dispatches_per_step`` and
    ``max_dispatch_wall_s`` from ``DistSampler.last_run_stats``."""
    dev = resolve_device(device)
    data, d = _banana()

    def build():
        return DistSampler(
            num_shards, logreg_logp, None,
            init_particles_per_shard(0, n_particles, d, num_shards),
            data=data, exchange_particles=True, exchange_scores=False,
            include_wasserstein=False, exchange_impl="ring", device=dev,
        )

    rows = []
    for label, kwargs in (
        ("monolithic", {}),
        ("chunked", dict(hops_per_dispatch=1)),
    ):
        sampler = build()
        # the timed runs never fence a dispatch (that would serialise the
        # chained dispatches and bill the fences to the chunked leg); the
        # dispatch walls come from one extra fenced run below
        wall = _time_dist_steps(sampler, iters, 3e-3, **kwargs)
        extra = {"execution": label, "exchange_impl": "ring"}
        if label == "chunked":
            sampler.run_steps(iters, 3e-3, hops_per_dispatch=1, time_dispatches=True)
            stats = sampler.last_run_stats or {}
            extra.update(
                dispatches_per_step=stats.get("dispatches_per_step"),
                max_dispatch_wall_s=stats.get("max_dispatch_wall_s"),
                hops_per_dispatch=1,
            )
        rows.append(_result(
            f"chunked-ab:{label}", sampler.num_particles, iters, wall, dev,
            num_shards=num_shards, emulated=_emulated(num_shards), **extra,
        ))
    return rows


def scaling_table_w2(iters, world_sizes=(1, 2, 4, 8), n_particles=10_000, device=None):
    """World-size scaling of the **Wasserstein step itself**: the
    10k-particle ``partitions`` table with the Sinkhorn W2 term on (h = 10,
    the reference driver's weight).  Under the block pairing both the φ
    interaction set and each W2 solve are block-sized, so a step's work is
    n²/S for both terms — the whole step scales with S on one card."""
    return scaling_table_10k(iters, world_sizes, n_particles, wasserstein=True,
                             device=device)


def scaling_table(iters, world_sizes=(1, 2, 4, 8), n_particles=50, device=None):
    """Banana logreg, 50 particles — the reference's headline workload — at
    world sizes 1/2/4/8, mirroring reference ``notes.md:128-132``
    (:data:`REFERENCE_WALL_S`: the reference's walls for 500 iterations)."""
    dev = resolve_device(device)
    data, d = _banana()
    rows = []
    for ws in world_sizes:
        # reference drop policy: 50 particles on 4/8 shards truncates
        # (reference dsvgd/distsampler.py:42-45)
        n_used = (n_particles // ws) * ws
        particles = init_particles_per_shard(0, n_used, d, ws)
        sampler = DistSampler(
            ws, logreg_logp, None, particles, data=data,
            exchange_particles=True, exchange_scores=False,
            include_wasserstein=False, device=dev,
        )
        wall = _time_dist_steps(sampler, iters, 3e-3)
        rows.append(_result(
            f"scaling:ws{ws}", sampler.num_particles, iters, wall, dev,
            num_shards=ws, emulated=_emulated(ws),
        ))
    return rows


# --------------------------------------------------------------------- #


def _markdown(results, scaling):
    lines = [
        "| config | n | iters | wall (s) | updates/sec | × ref best (421/s) |",
        "|---|---|---|---|---|---|",
    ]
    for r in results:
        lines.append(
            f"| {r['config']} | {r['n_particles']} | {r['n_iters']} "
            f"| {r['wall_s']} | {r['updates_per_sec']} | {r['vs_reference_best']} |"
        )
    acc = [r for r in results if "steps_to_target" in r]
    if acc:
        lines += [
            "",
            "| config | baseline target | steps-to-target | final |",
            "|---|---|---|---|",
        ]
        for r in acc:
            tgt = r.get("target_acc", r.get("bayesridge_rmse"))
            fin = r.get("final_acc", r.get("final_rmse"))
            reached = r["steps_to_target"]
            lines.append(
                f"| {r['config']} | {tgt} "
                f"| {'UNREACHED' if reached is None else reached} | {fin} |"
            )
    if scaling:
        lines += [
            "",
            "| world size | wall (s) | updates/sec | reference wall (s) |",
            "|---|---|---|---|",
        ]
        for r in scaling:
            ws = r["num_shards"]
            lines.append(
                f"| {ws} | {r['wall_s']} | {r['updates_per_sec']} "
                f"| {REFERENCE_WALL_S.get(ws, '—')} |"
            )
    return "\n".join(lines)


_CONFIGS = {
    "1": bench_logreg_single,
    "2": bench_gmm,
    "3": bench_logreg_sharded,
    "4": bench_covertype_minibatch,
    "5": bench_bnn,
}


def build_parser() -> argparse.ArgumentParser:
    """JAX's click options, ``--backend`` read as ``--device``."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--configs", default="1,2,3,4,5",
                    help="comma-separated subset of {1..5}, or 'all'")
    ap.add_argument("--iters", type=int, default=100, help="timed iterations per config")
    ap.add_argument("--scaling", action=argparse.BooleanOptionalAction, default=True,
                    help="also run the world-size scaling table")
    ap.add_argument("--scaling-iters", type=int, default=500,
                    help="iterations for the scaling table (reference used 500)")
    ap.add_argument("--scaling-10k", action=argparse.BooleanOptionalAction, default=False,
                    help="also run the compute-bound 10k-particle partitions-mode "
                         "scaling table")
    ap.add_argument("--scaling-w2", action=argparse.BooleanOptionalAction, default=False,
                    help="also run the 10k-particle partitions+W2 scaling table")
    ap.add_argument("--chunked-ab", action=argparse.BooleanOptionalAction, default=False,
                    help="also run the chunked-vs-monolithic A/B (ring exchange, "
                         "hops_per_dispatch=1 — the chunking-overhead measurement)")
    ap.add_argument("--table", action="store_true", help="print markdown tables at the end")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' runs the plain path)")
    ap.add_argument("--acceptance", default="auto", choices=["auto", "on", "off"],
                    help="sklearn-baseline acceptance (target + steps-to-target) for "
                         "configs 4/5; 'auto' runs it on the card only (the CPU run is "
                         "a smoke run, not an acceptance run)")
    return ap


def main(argv: Optional[list] = None) -> int:
    ap = build_parser()
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    acc_on = args.acceptance == "on" or (args.acceptance == "auto" and dev.type == "cuda")
    wanted = list(_CONFIGS) if args.configs == "all" else args.configs.split(",")
    for key in wanted:
        if key.strip() not in _CONFIGS:
            ap.error(f"unknown config {key.strip()!r}")
    results = []
    for key in wanted:
        key = key.strip()
        fn = _CONFIGS[key]
        if key in ("4", "5"):
            res = fn(args.iters, acceptance=acc_on, device=dev)
        else:
            res = fn(args.iters, device=dev)
        results.append(res)
        print(json.dumps(res), flush=True)
    srows = []
    if args.scaling:
        srows = scaling_table(args.scaling_iters, device=dev)
        for r in srows:
            print(json.dumps(r), flush=True)
    if args.scaling_10k:
        for r in scaling_table_10k(args.iters, device=dev):
            print(json.dumps(r), flush=True)
    if args.scaling_w2:
        for r in scaling_table_w2(args.iters, device=dev):
            print(json.dumps(r), flush=True)
    if args.chunked_ab:
        for r in bench_chunked_ab(args.iters, device=dev):
            print(json.dumps(r), flush=True)
    if args.table:
        print()
        print(_markdown(results, srows))
    return 0


if __name__ == "__main__":
    sys.exit(main())
