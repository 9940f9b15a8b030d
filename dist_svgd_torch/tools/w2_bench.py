"""The Sinkhorn-W2 cost table and the budgeted solve's fidelity band.

Counterpart of ``tools/w2_bench.py``.  Times the W2 trajectory
(``DistSampler.run_steps`` with the carried-snapshot Sinkhorn term, h = 10)
at ``--n`` particles over ``--shards`` lanes in three configurations, the
incumbent first: a fixed ``--sinkhorn-iters`` solve from a cold start, the
adaptive ``sinkhorn_tol=1e-2`` exit from a cold start, and the tol exit
with warm-started (carried) duals, the default.  Each is an untimed
dispatch of ``--iters-per-dispatch`` steps, then the best of ``--samples``
state-chained dispatches under one fence; the ratios are the point.
``--no-fixed`` skips the fixed solve (minutes a dispatch at streaming
sizes).

The lanes take the hand kernels of the route ``ops/ot.py`` picks from one
lane's pairs: at the default n = 10,000 (8 lanes of 1,250 rows against
10,000 columns) the fused route, ``ot_ctransform`` and ``ot_kexp``; at
``--n 100000 --no-fixed`` (12,500 × 100,000 a lane, past 2²⁸ pairs) the
streaming route, ``ot_kmat_vec``, ``ot_plan_grad`` and ``ot_ctransform``.

``--fidelity`` instead measures the budgeted large-n solve's trajectory
deviation: two samplers from the same start, the budget
(``--budget-iters``, default 8, the 1M protocol) and a reference
(``--ref-iters``, default 200, tol exit on: converged), step together one
step a dispatch at ``--stepsize`` and h = 10, and each step prints the max
particle deviation, then the band over the run.  ``--exchange partitions``
is the 1M spot-check pairing (block pairing, 1,250 × 1,250 lanes at 10k).

Usage (the card unless ``--device cpu``)::

    python -m dist_svgd_torch.tools.w2_bench [--n 10000] [--iters-per-dispatch 50]
    python -m dist_svgd_torch.tools.w2_bench --n 100000 --no-fixed
    python -m dist_svgd_torch.tools.w2_bench --fidelity --exchange partitions
    python -m dist_svgd_torch.tools.w2_bench --device cpu --n 64 --shards 4 \\
        --iters-per-dispatch 2 --samples 1
"""

from __future__ import annotations

import argparse
import time
from typing import Optional

import numpy as np

from dist_svgd_torch.distsampler import DistSampler
from dist_svgd_torch.models.logreg import logreg_logp
from dist_svgd_torch.tools.step_timing import describe_device, fence
from dist_svgd_torch.utils.datasets import load_benchmark
from dist_svgd_torch.utils.platform import resolve_device
from dist_svgd_torch.utils.rng import init_particles_per_shard

#: The W2 weight and the timing rows' step size (JAX's).
H = 10.0
STEP_SIZE = 3e-3


def w2_sampler(n: int, shards: int, device, init=None, exchange: str = "all_particles",
               **sinkhorn) -> DistSampler:
    """A sampler of the table (JAX ``w2_bench.py:84-96, 123-134``): banana
    fold 42, ``shards`` lanes, scores not exchanged, the Sinkhorn W2 term
    with ``sinkhorn`` (``sinkhorn_iters``, ``sinkhorn_tol``,
    ``sinkhorn_warm_start``).  ``init`` (default: the per-shard draw of
    ``n`` from seed 0) is the start."""
    fold = load_benchmark("banana", 42)
    d = 1 + fold.x_train.shape[1]
    if init is None:
        init = init_particles_per_shard(0, n, d, shards)
    return DistSampler(
        shards, logreg_logp, None, init, data=(fold.x_train, fold.t_train.reshape(-1)),
        exchange_particles=(exchange != "partitions"), exchange_scores=False,
        include_wasserstein=True, wasserstein_solver="sinkhorn", device=device, **sinkhorn)


def bench_rows(n: int = 10_000, shards: int = 8, iters_per_dispatch: int = 50,
               sinkhorn_iters: int = 200, samples: int = 3, no_fixed: bool = False,
               device=None, init=None) -> dict:
    """The timing rows, incumbent first; prints JAX's lines and returns
    ``{"rows": {label: {"ms_per_step", "final"}}, ...}`` with the ratios and
    the final-particle deviations (``final``: numpy)."""
    dev = resolve_device(device)
    K = iters_per_dispatch

    def bench(tol, warm, label):
        s = w2_sampler(n, shards, dev, init, sinkhorn_iters=sinkhorn_iters, sinkhorn_tol=tol,
                       sinkhorn_warm_start=warm)
        fence(s.run_steps(K, STEP_SIZE, h=H))  # untimed
        best = float("inf")
        for _ in range(samples):
            t0 = time.perf_counter()
            out = s.run_steps(K, STEP_SIZE, h=H)  # state-chained
            fence(out)
            best = min(best, (time.perf_counter() - t0) / K)
        print(f"{label:52s} {best*1e3:8.2f} ms/step", flush=True)
        return {"ms_per_step": best * 1e3, "final": s.particles.cpu().numpy()}

    rows = {}
    if not no_fixed:
        rows["fixed"] = bench(None, False, f"W2 fixed {sinkhorn_iters} iters, cold (round-1 ref)")
    rows["tol"] = bench(1e-2, False, "W2 tol=1e-2, cold start (round-2 incumbent)")
    rows["warm"] = bench(1e-2, True, "W2 tol=1e-2 + warm-started duals (default)")
    out = {"n": n, "shards": shards, "iters_per_dispatch": K, "samples": samples,
           "device": str(dev), "rows": rows,
           "warm_vs_cold_tol": rows["tol"]["ms_per_step"] / rows["warm"]["ms_per_step"],
           "dev_warm_vs_cold_tol": float(np.max(np.abs(rows["tol"]["final"]
                                                       - rows["warm"]["final"])))}
    if no_fixed:
        print(f"warm vs cold-tol: {out['warm_vs_cold_tol']:.2f}x", flush=True)
        print(f"max final-particle deviation warm vs cold-tol: "
              f"{out['dev_warm_vs_cold_tol']:.2e}", flush=True)
        return out
    fixed, tol, warm = (rows[k]["ms_per_step"] for k in ("fixed", "tol", "warm"))
    out.update(tol_vs_fixed=fixed / tol, total=fixed / warm,
               dev_cold_tol_vs_fixed=float(np.max(np.abs(rows["fixed"]["final"]
                                                         - rows["tol"]["final"]))),
               dev_warm_vs_fixed=float(np.max(np.abs(rows["fixed"]["final"]
                                                     - rows["warm"]["final"]))))
    print(f"tol vs fixed: {fixed/tol:.2f}x; warm vs cold-tol: {tol/warm:.2f}x; total "
          f"{fixed/warm:.2f}x", flush=True)
    print(f"max final-particle deviation vs fixed-{sinkhorn_iters}: "
          f"cold-tol {out['dev_cold_tol_vs_fixed']:.2e}, "
          f"warm {out['dev_warm_vs_fixed']:.2e}", flush=True)
    return out


def fidelity_rows(n: int = 10_000, shards: int = 8, steps: int = 20, budget_iters: int = 8,
                  ref_iters: int = 200, stepsize: float = 3e-4,
                  exchange: str = "all_particles", device=None, init=None) -> dict:
    """The budgeted solve against the reference, one step a dispatch;
    prints JAX's lines and returns the per-step deviations, the band and
    both trajectories (``budget_traj`` / ``ref_traj``: numpy, one array a
    step)."""
    dev = resolve_device(device)
    budget, ref = (w2_sampler(n, shards, dev, init, exchange, sinkhorn_iters=iters,
                              sinkhorn_tol=1e-2, sinkhorn_warm_start=True)
                   for iters in (budget_iters, ref_iters))
    print(f"fidelity: n={n} {exchange} (pairing {budget.w2_pairing}), budget {budget_iters} "
          f"vs ref {ref_iters} iters, stepsize {stepsize}, h=10, {steps} steps", flush=True)
    out = {"n": n, "shards": shards, "exchange": exchange, "pairing": budget.w2_pairing,
           "budget_iters": budget_iters, "ref_iters": ref_iters, "device": str(dev),
           "steps": [], "budget_traj": [], "ref_traj": []}
    max_dev = max_rel = 0.0
    for k in range(1, steps + 1):
        pb = budget.run_steps(1, stepsize, h=H).cpu().numpy()
        pr = ref.run_steps(1, stepsize, h=H).cpu().numpy()
        dev_k = float(np.max(np.abs(pb - pr)))
        scale = float(np.max(np.abs(pr)))
        max_dev, max_rel = max(max_dev, dev_k), max(max_rel, dev_k / scale)
        out["steps"].append({"step": k, "max_dev": dev_k, "rel": dev_k / scale})
        out["budget_traj"].append(pb)
        out["ref_traj"].append(pr)
        print(f"  step {k:3d}: max|Δx| {dev_k:.3e} (rel {dev_k/scale:.3e})", flush=True)
    out.update(max_dev=max_dev, max_rel=max_rel)
    print(f"fidelity band over {steps} steps: max deviation {max_dev:.3e} (relative "
          f"{max_rel:.3e}); a band near the solver tol means the budgeted solve is "
          "converging across steps via the carried duals (inexact-JKO argument, "
          "docs/theory.md §4), not drifting", flush=True)
    return out


def main(argv: Optional[list] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=10_000)
    ap.add_argument("--shards", type=int, default=8)
    ap.add_argument("--iters-per-dispatch", type=int, default=50)
    ap.add_argument("--sinkhorn-iters", type=int, default=200)
    ap.add_argument("--samples", type=int, default=3)
    ap.add_argument("--no-fixed", action="store_true",
                    help="skip the fixed-iteration reference variant (minutes a dispatch "
                         "at streaming sizes, e.g. --n 100000)")
    ap.add_argument("--fidelity", action="store_true",
                    help="measure the budgeted-solver trajectory deviation instead of "
                         "timing (module docstring)")
    ap.add_argument("--fidelity-steps", type=int, default=20)
    ap.add_argument("--budget-iters", type=int, default=8,
                    help="per-step Sinkhorn budget under test (the 1M row's protocol)")
    ap.add_argument("--ref-iters", type=int, default=200,
                    help="reference solve cap (tol exit active, so this is 'converged')")
    ap.add_argument("--stepsize", type=float, default=3e-4,
                    help="SVGD stepsize for --fidelity (the large-n protocol's 3e-4)")
    ap.add_argument("--exchange", default="all_particles",
                    choices=["all_particles", "partitions"],
                    help="--fidelity exchange mode (partitions = the 1M spot-check pairing)")
    ap.add_argument("--device", default=None,
                    help="'cpu' for the plain path; default: the card (raises without CUDA)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    print("devices:", describe_device(dev), flush=True)
    if args.fidelity:
        return fidelity_rows(args.n, args.shards, args.fidelity_steps, args.budget_iters,
                             args.ref_iters, args.stepsize, args.exchange, dev)
    return bench_rows(args.n, args.shards, args.iters_per_dispatch, args.sinkhorn_iters,
                      args.samples, args.no_fixed, dev)


if __name__ == "__main__":
    main()
