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

``--kernel-approx rff|nystrom`` is the ``large_n_approx`` row
(:func:`run_approx_row`): the single-device step with the sub-quadratic φ
at ``--n`` (``--num-features`` / ``--num-landmarks`` the dial), its error
pinned against the exact φ at ``--approx-pin-n`` particles, and the exact
step timed at ``--exact-probe-n`` to extrapolate the exact wall to n; the
exit code is 1 when :func:`approx_row_ok` fails the row::

    python -m dist_svgd_torch.tools.large_n --kernel-approx rff   # the card
    python -m dist_svgd_torch.tools.large_n --device cpu --kernel-approx rff \\
        --n 256 --num-features 64 --approx-pin-n 128 --exact-probe-n 64 \\
        --steps 2 --samples 1

Timing: host clock around ``--steps`` steps that end in
``torch.cuda.synchronize``, best of ``--samples``, after an untimed run
of the same length; the per-dispatch wall comes from one more run with
``time_dispatches=True``.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time
from typing import Optional

import torch

from dist_svgd_torch.distsampler import W2_GLOBAL_PAIRING_MAX_N, DistSampler
from dist_svgd_torch.models.logreg import logreg_logp
from dist_svgd_torch.ops.approx import (
    KernelApprox,
    default_error_budget,
    error_pin_probe,
    make_approx_phi_fn,
    phi_rel_error,
)
from dist_svgd_torch.ops.svgd import phi as phi_exact
from dist_svgd_torch.sampler import Sampler
from dist_svgd_torch.utils.datasets import load_benchmark
from dist_svgd_torch.utils.platform import resolve_device
from dist_svgd_torch.utils.rng import approx_bank_seed, init_particles, init_particles_per_shard


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


def run_approx_row(n: int, method: str = "rff", num_features: int = 4096,
                   num_landmarks: int = 4096, steps: int = 5, samples: int = 2,
                   stepsize: float = 3e-3, pin_n: int = 2048, exact_probe_n: int = 0,
                   seed: int = 0, device=None) -> dict:
    """The ``large_n_approx`` row (JAX's ``run_approx_row``, the same
    record keys): the sampler step with the sub-quadratic φ at a particle
    count the exact O(n²) step cannot touch on the same budget.  Three
    measurements in one record:

    - **throughput** — full sampler steps (banana logistic regression
      scores + approximate φ, ``phi_impl='torch'``) at ``n``, best of
      ``samples`` runs of ``steps`` after an untimed one;
    - **error pin** — the relative φ error of THIS configuration (method,
      dial and, for RFF, the bank of ``seed``) against the exact φ on
      :func:`~dist_svgd_torch.ops.approx.error_pin_probe` at ``pin_n``,
      judged against ``default_error_budget``;
    - **exact extrapolation** — the exact step (``'auto'``: the hand kernel
      on the card) at ``exact_probe_n`` (default ``min(n, 65536)``), a
      pairs/s rate extrapolated quadratically to ``n``.

    Eager PyTorch has no retrace sentry: ``recompiles`` is ``None`` and
    ``sentry_supported`` false."""
    device = resolve_device(device)
    if method == "rff":
        spec, dial = KernelApprox("rff", num_features=num_features), num_features
    else:
        spec, dial = KernelApprox("nystrom", num_landmarks=num_landmarks), num_landmarks
    fold = load_benchmark("banana", 42)
    d = 1 + fold.x_train.shape[1]
    data = (fold.x_train, fold.t_train.reshape(-1))
    sampler = Sampler(d, logreg_logp, data=data, kernel_approx=spec, phi_impl="torch",
                      device=device)

    def timed(s, parts):
        def chain(p):
            out, _ = s.run(p.shape[0], steps, stepsize, seed=seed, record=False,
                           initial_particles=p)
            _sync(device)
            return out

        parts = chain(parts)  # untimed
        best = float("inf")
        for _ in range(samples):
            t0 = time.perf_counter()
            parts = chain(parts)
            best = min(best, (time.perf_counter() - t0) / steps)
        return best

    best = timed(sampler, init_particles(seed, n, d, device=device))

    # error pin at small n: the measured configuration's method, dial, bank
    pin_spec = spec.with_seed(approx_bank_seed(seed)) if method == "rff" else spec
    px, ps, pk = error_pin_probe(pin_n, d, seed, device=device)
    with torch.no_grad():
        err = phi_rel_error(phi_exact(px, px, ps, pk),
                            make_approx_phi_fn(pk, pin_spec)(px, px, ps))
    budget = default_error_budget(pin_spec, d)

    # the exact step at the probe size → quadratic extrapolation to n
    probe_n = exact_probe_n or min(n, 65_536)
    exact = Sampler(d, logreg_logp, data=data, device=device)
    ebest = timed(exact, init_particles(seed, probe_n, d, device=device))
    pairs_per_sec = probe_n * probe_n / ebest
    exact_est = n * n / pairs_per_sec
    return {
        "bench": "large_n_approx", "n": n, "method": method, "dial": dial,
        "d": d, "stepsize": stepsize, "steps_per_dispatch": steps,
        "wall_per_step_s": round(best, 6),
        "updates_per_sec": round(n / best, 1),
        "approx_rel_err": round(err, 6),
        "error_budget": round(budget, 6),
        "within_budget": bool(err <= budget),
        "pin_n": pin_n,
        "recompiles": None,
        "sentry_supported": False,
        "exact_probe_n": probe_n,
        "exact_probe_wall_per_step_s": round(ebest, 6),
        "exact_pairs_per_sec": round(pairs_per_sec, 1),
        "exact_est_wall_per_step_s": round(exact_est, 3),
        "est_speedup_vs_exact": round(exact_est / best, 1),
        "kernel_approx_active": sampler.kernel_approx_active,
        "device": _device_name(device),
    }


def approx_row_ok(row: dict) -> tuple:
    """The ``large_n_approx`` row's correctness gates (JAX's): the error
    inside its budget at the small-n pin, no steady-state recompile where a
    sentry exists, a finite positive wall, and the approximation active.
    Returns ``(ok, reasons)``."""
    why = []
    if not row.get("within_budget"):
        why.append(f"approximation error {row.get('approx_rel_err')} exceeds the declared "
                   f"budget {row.get('error_budget')} at the small-n pin")
    if row.get("sentry_supported") and row.get("recompiles"):
        why.append(f"{row['recompiles']} steady-state recompile(s) in the timed window — "
                   "a retrace bug contaminating the measurement")
    wall = row.get("wall_per_step_s")
    if not (isinstance(wall, (int, float)) and math.isfinite(wall) and wall > 0):
        why.append(f"non-finite wall_per_step_s {wall!r}")
    if not row.get("kernel_approx_active"):
        why.append("the approximate backend was not active — the row measured the exact "
                   "kernel")
    return (not why), why


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
                    help="the large_n_approx row: the sub-quadratic φ step at --n, its "
                         "small-n error pin and the exact wall extrapolated to n")
    ap.add_argument("--num-features", type=int, default=4096,
                    help="RFF accuracy dial R (--kernel-approx rff)")
    ap.add_argument("--num-landmarks", type=int, default=4096,
                    help="Nyström accuracy dial L (--kernel-approx nystrom)")
    ap.add_argument("--approx-pin-n", type=int, default=2048,
                    help="small-n size of the exact-against-approximate error pin")
    ap.add_argument("--exact-probe-n", type=int, default=0,
                    help="exact-step probe size of the extrapolation (0 = min(n, 65536))")
    ap.add_argument("--json-out", default=None, help="append one JSON record a row here")
    ap.add_argument("--device", choices=("cuda", "cpu"), default=None,
                    help="default: the card (fails without CUDA)")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    if args.kernel_approx is not None:
        record = run_approx_row(
            args.n, method=args.kernel_approx, num_features=args.num_features,
            num_landmarks=args.num_landmarks, steps=args.steps, samples=args.samples,
            stepsize=args.stepsize, pin_n=args.approx_pin_n,
            exact_probe_n=args.exact_probe_n, device=device)
        emit(record, args.json_out)
        ok, why = approx_row_ok(record)
        if not ok:
            print("GATE: " + "; ".join(why), file=sys.stderr, flush=True)
        return 0 if ok else 1
    if args.w2:
        run_w2(args, device)
    else:
        run_phi(args, device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
