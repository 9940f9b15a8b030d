"""The large-n rows on the card: the sampler step at 100k+ particles, and
the sharded Sinkhorn-W2 step with its chunked execution.

Counterpart of ``tools/large_n.py`` (same flags, same JSON record a row).
Without ``--w2`` it times the single-device ``Sampler`` step (banana
logistic regression, d = 3) at ``--n`` particles; ``--w2`` times the
sharded ``DistSampler`` step with the Sinkhorn W2 term on the streaming
route (no ``(n/S, n)`` kernel matrix exists), warm duals, ``--shards``
emulated shards.  ``--dispatch-budget`` (with ``--pairs-per-sec``) or the
explicit ``--hops-per-dispatch`` / ``--max-passes-per-dispatch`` run the
same trajectory as a chain of bounded dispatches
(``DistSampler.run_steps``); ``--ab`` measures that and the monolithic
execution at the same configuration.  Every row is one JSON line on
stdout (``--json-out`` appends it to a file too), with the resolved
``w2_pairing``, ``dispatches_per_step`` and ``max_dispatch_wall_s``.

    python -m dist_svgd_torch.tools.large_n --w2 --exchange-impl ring \\
        --dispatch-budget 0.05 --ab                    # the card
    python -m dist_svgd_torch.tools.large_n --device cpu --n 64 --shards 4 \\
        --w2 --exchange-impl ring --hops-per-dispatch 1 --steps 2 --samples 1

Timing: host clock around ``--steps`` steps that end in
``torch.cuda.synchronize``, best of ``--samples``, after an untimed run
of the same length; the per-dispatch wall comes from one more run with
``time_dispatches=True``.  ``--kernel-approx`` (the sub-quadratic φ row)
is ROADMAP A6.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Optional

import torch

from dist_svgd_torch.distsampler import W2_GLOBAL_PAIRING_MAX_N, DistSampler
from dist_svgd_torch.models.logreg import logreg_logp
from dist_svgd_torch.sampler import Sampler
from dist_svgd_torch.utils.datasets import load_benchmark
from dist_svgd_torch.utils.platform import resolve_device
from dist_svgd_torch.utils.rng import init_particles, init_particles_per_shard


def resolve_ring_pairing(n: int, exchange: str, exchange_impl: str, w2_pairing: str) -> str:
    """``--w2-pairing auto`` under the ring, resolved ahead (JAX's
    ``resolve_ring_pairing``): at or below
    :data:`~dist_svgd_torch.distsampler.W2_GLOBAL_PAIRING_MAX_N` ``'auto'``
    would be the global pairing, which the ring's ``run_steps`` refuses, so
    it is ``'block'``; anything else passes through."""
    if (exchange_impl == "ring" and exchange != "partitions" and w2_pairing == "auto"
            and n <= W2_GLOBAL_PAIRING_MAX_N):
        return "block"
    return w2_pairing


def emit(record: dict, json_out: Optional[str]) -> None:
    line = json.dumps(record)
    print(line, flush=True)
    if json_out:
        with open(json_out, "a") as f:
            f.write(line + "\n")


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def chunk_kwargs(args) -> dict:
    """The ``run_steps`` chunking arguments the flags ask for."""
    if args.dispatch_budget is not None:
        return dict(dispatch_budget=args.dispatch_budget, pairs_per_sec=args.pairs_per_sec)
    if args.hops_per_dispatch is not None or args.max_passes_per_dispatch is not None:
        return dict(hops_per_dispatch=args.hops_per_dispatch,
                    max_passes_per_dispatch=args.max_passes_per_dispatch)
    return {}


def w2_sampler(args, device) -> DistSampler:
    """The ``--w2`` row's sampler: banana logistic regression over
    ``--shards`` shards, the Sinkhorn W2 term, float32."""
    fold = load_benchmark("banana", 42)
    d = 1 + fold.x_train.shape[1]
    return DistSampler(
        args.shards, logreg_logp, None, init_particles_per_shard(0, args.n, d, args.shards),
        data=(fold.x_train, fold.t_train.reshape(-1)),
        exchange_particles=args.exchange != "partitions", exchange_scores=False,
        include_wasserstein=True, wasserstein_solver="sinkhorn",
        sinkhorn_iters=args.sinkhorn_iters, w2_pairing=args.w2_pairing,
        exchange_impl=args.exchange_impl, device=device)


def run_w2(args, device) -> list:
    """The ``--w2`` rows: warm-up single steps (the first solve is cold),
    then each variant timed; returns the records."""
    args.w2_pairing = resolve_ring_pairing(args.n, args.exchange, args.exchange_impl,
                                           args.w2_pairing)
    ds = w2_sampler(args, device)
    kw_chunked = chunk_kwargs(args)

    def run_block(num_steps, **kw):
        ds.run_steps(num_steps, args.stepsize, h=10.0, **kw)
        _sync(device)

    for _ in range(max(args.steps, 2)):
        run_block(1, **kw_chunked)

    variants = []
    if kw_chunked:
        variants.append(("chunked", kw_chunked))
        if args.ab:
            variants.append(("monolithic", {}))
    else:
        variants.append(("monolithic", {}))
        if args.ab:
            variants.append(("chunked", dict(hops_per_dispatch=1)))
    records = []
    for label, kw in variants:
        run_block(args.steps, **kw)  # untimed
        best = float("inf")
        for _ in range(args.samples):
            t0 = time.perf_counter()
            run_block(args.steps, **kw)
            best = min(best, (time.perf_counter() - t0) / args.steps)
        run_block(args.steps, **dict(kw, time_dispatches=True))
        stats = ds.last_run_stats
        record = {
            "bench": "large_n_w2", "n": args.n, "num_shards": args.shards,
            "execution": label, "exchange": args.exchange,
            "exchange_impl": args.exchange_impl, "w2_pairing": ds.w2_pairing,
            "sinkhorn_iters": args.sinkhorn_iters, "stepsize": args.stepsize,
            "wall_per_step_s": best, "updates_per_sec": args.n / best,
            "plan": stats["execution"],
            "dispatches_per_step": stats["dispatches_per_step"],
            "num_dispatches": stats["num_dispatches"],
            "max_dispatch_wall_s": stats["max_dispatch_wall_s"],
            "hops_per_dispatch": stats.get("hops_per_dispatch"),
            "max_passes_per_dispatch": stats.get("max_passes_per_dispatch"),
            "dispatch_budget_s": stats.get("dispatch_budget_s"),
            "device": _device_name(device),
        }
        emit(record, args.json_out)
        records.append(record)
    return records


def run_phi(args, device) -> dict:
    """The row without ``--w2``: the single-device ``Sampler`` step at
    ``--n`` particles, chained runs of ``--steps`` steps."""
    fold = load_benchmark("banana", 42)
    d = 1 + fold.x_train.shape[1]
    sampler = Sampler(d, logreg_logp, data=(fold.x_train, fold.t_train.reshape(-1)),
                      device=device)

    def run_once(parts):
        out, _ = sampler.run(args.n, args.steps, args.stepsize, record=False,
                             initial_particles=parts, dispatch_budget=args.dispatch_budget,
                             pairs_per_sec=args.pairs_per_sec)
        _sync(device)
        return out

    out = run_once(init_particles(0, args.n, d, device=device))  # untimed
    best = float("inf")
    for _ in range(args.samples):
        t0 = time.perf_counter()
        out = run_once(out)
        best = min(best, (time.perf_counter() - t0) / args.steps)
    stats = sampler.last_run_stats or {}
    record = {
        "bench": "large_n_phi", "n": args.n, "stepsize": args.stepsize,
        "execution": stats.get("execution"), "num_dispatches": stats.get("num_dispatches"),
        "dispatches_per_step": stats.get("dispatches_per_step"),
        "max_dispatch_wall_s": None,
        "wall_per_step_s": best, "pairs_per_sec": args.n * args.n / best,
        "updates_per_sec": args.n / best, "device": _device_name(device),
    }
    emit(record, args.json_out)
    return record


def _device_name(device: torch.device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m dist_svgd_torch.tools.large_n",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=100_000)
    ap.add_argument("--steps", type=int, default=10, help="steps a timed run")
    ap.add_argument("--samples", type=int, default=3)
    ap.add_argument("--shards", type=int, default=8, help="shards S of --w2")
    ap.add_argument("--w2", action="store_true",
                    help="time the sharded Sinkhorn-W2 step instead of the plain one")
    ap.add_argument("--exchange", default="all_particles",
                    choices=["all_particles", "partitions"])
    ap.add_argument("--exchange-impl", default="gather", choices=["gather", "ring"])
    ap.add_argument("--w2-pairing", default="auto", choices=["auto", "global", "block"])
    ap.add_argument("--stepsize", type=float, default=3e-3)
    ap.add_argument("--sinkhorn-iters", type=int, default=200)
    ap.add_argument("--dispatch-budget", type=float, default=None,
                    help="per-dispatch wall budget (s): run_steps(dispatch_budget=...)")
    ap.add_argument("--pairs-per-sec", type=float, default=None,
                    help="pair rate of the budget planner (default: "
                         "distsampler.DISPATCH_PAIRS_PER_SEC)")
    ap.add_argument("--hops-per-dispatch", type=int, default=None)
    ap.add_argument("--max-passes-per-dispatch", type=int, default=None)
    ap.add_argument("--ab", action="store_true",
                    help="time the chunked and the monolithic execution")
    ap.add_argument("--kernel-approx", default=None, choices=["rff", "nystrom"],
                    help="the sub-quadratic φ row: ROADMAP A6, not ported")
    ap.add_argument("--num-features", type=int, default=None)
    ap.add_argument("--num-landmarks", type=int, default=None)
    ap.add_argument("--approx-pin-n", type=int, default=None)
    ap.add_argument("--exact-probe-n", type=int, default=None)
    ap.add_argument("--json-out", default=None, help="append one JSON record a row here")
    ap.add_argument("--device", choices=("cuda", "cpu"), default=None,
                    help="default: the card (fails without CUDA)")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    approx = [f for f in ("kernel_approx", "num_features", "num_landmarks", "approx_pin_n",
                          "exact_probe_n") if getattr(args, f) is not None]
    if approx:
        raise NotImplementedError(
            f"--{approx[0].replace('_', '-')} (the kernel-approximation row) is not "
            "ported to PyTorch yet (ROADMAP A6)")
    device = resolve_device(args.device)
    if args.w2:
        run_w2(args, device)
    else:
        run_phi(args, device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
