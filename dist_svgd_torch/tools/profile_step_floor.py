"""Split the small-config step's floor on the card.

Counterpart of ``tools/profile_step_floor.py``.  Config 1 (banana logistic
regression, n = 100 particles, step size 3e-3) runs a few milliseconds a
step on the card while its φ is a few microseconds of device work (PERF.md
§5): the step is host-bound.  This tool separates the parts of that floor:

- **per-dispatch cost** — what one fenced run costs whatever its length,
  from the same body timed at several dispatch lengths, and the marginal
  cost of a dispatch from the chain-length sweep;
- **per-step cost** — the body itself, the asymptote of ms/step as the
  dispatch grows;

and builds the config-1 step up part by part — an empty body (one axpy),
the per-step draw plus the axpy, the scores alone
(``torch.func.vmap(torch.func.grad(logreg_logp))``, as the samplers build
them), φ alone (``resolve_phi_fn(RBF(1.0), 'auto')``: ``phi_small_d`` on the
card) and the full step — so the host step's composition is measured, not
guessed.

**What a dispatch is.**  The port has no compiled scan: a dispatch is
``iters`` body calls in a Python loop, which is what ``run_steps``
(``distsampler.py``) does.  A warm-up dispatch ends in one
:func:`~dist_svgd_torch.tools.step_timing.fence`; a timed sample chains
``reps`` dispatches, each feeding the next its particles, and ends in one
fence.  JAX's per-step ``fold_in`` becomes the port's per-step generator
(``utils/rng.py:_generator(seed, t)``) drawing one uniform.

Usage (the card unless ``--device cpu``)::

    python -m dist_svgd_torch.tools.profile_step_floor [--n 100]
    python -m dist_svgd_torch.tools.profile_step_floor --trace DIR
    python -m dist_svgd_torch.tools.profile_step_floor --donate-ab
    python -m dist_svgd_torch.tools.profile_step_floor --device cpu \\
        --dispatch-lengths 1 2 --chains 1 2 --chain-dispatch 2 --reps 1 --samples 1

``--trace DIR`` wraps the measured sections in
``utils/metrics.py:profiler_trace`` (``torch.profiler``; the host and the
card): ``DIR/bodies/trace.json`` and ``DIR/chain/trace.json``, Chrome's
trace format, readable in Perfetto — the counterpart of JAX's
``--jax-trace``.

``--donate-ab`` runs two identical ``Sampler`` schedules with
``donate_carries`` on and off and pins their final particles bitwise.
Torch has no buffer donation: with the flag on, the port's step writes each
update into the run's particle carry in place of a new tensor (the same
kernel, the same bits), so the A/B is a determinism pin and its
``speedup`` is expected near 1.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Callable, Dict, Optional, Sequence

import torch

from dist_svgd_torch.models.logreg import logreg_logp
from dist_svgd_torch.ops.cuda_svgd import resolve_phi_fn
from dist_svgd_torch.ops.kernels import RBF
from dist_svgd_torch.sampler import Sampler
from dist_svgd_torch.tools.step_timing import describe_device, dispatch, fence, timed_dispatch
from dist_svgd_torch.utils.datasets import load_benchmark
from dist_svgd_torch.utils.metrics import profiler_trace
from dist_svgd_torch.utils.platform import resolve_device
from dist_svgd_torch.utils.rng import _generator, init_particles

#: Config 1's step size and the defaults of the sweeps (JAX's).
STEP_SIZE = 3e-3
DISPATCH_LENGTHS = (100, 1000)
CHAINS = (1, 8, 32, 128)
#: Steps in a dispatch of the chain-length sweep and of the donation A/B.
CHAIN_DISPATCH = 100

EMPTY = "empty (axpy only)"
FULL = "full step (score+phi)"


def config1(n: int, device, particles=None, seed: int = 0):
    """Config 1's start and data: ``particles`` (default: the
    ``init_particles(seed, n, d)`` draw) and the banana fold 42's training
    rows ``(x, t)``, both on ``device``, the data at the particles' dtype as
    the samplers cast it."""
    fold = load_benchmark("banana", 42)
    if particles is None:
        particles = init_particles(seed, n, 1 + fold.x_train.shape[1])
    p0 = torch.as_tensor(particles, device=device)
    return p0, (torch.as_tensor(fold.x_train, device=device, dtype=p0.dtype),
                torch.as_tensor(fold.t_train.reshape(-1), device=device, dtype=p0.dtype))


def floor_bodies(data, step_size: float = STEP_SIZE,
                 seed: int = 0) -> Dict[str, Callable[[torch.Tensor, int], torch.Tensor]]:
    """The five bodies ``body(p, i) -> p'`` of the composition, in JAX's
    order (``tools/profile_step_floor.py:150-162``): the empty axpy; the
    per-step draw (one uniform from ``_generator(seed, i)``, JAX's
    ``fold_in``) plus the axpy; the scores alone; φ alone (the particles
    as their own scores); the full step."""
    phi_fn = resolve_phi_fn(RBF(1.0), "auto")
    batched_score = torch.func.vmap(torch.func.grad(logreg_logp), in_dims=(0, None))

    def phi1(p, s):  # one lane: the single-device step's φ call
        return phi_fn(p[None], p, s[None])[0]

    def draw(i):
        return torch.rand((), generator=_generator(seed, i))

    return {
        EMPTY: lambda p, i: p * (1.0 + 1e-7),
        "draw + axpy": lambda p, i: p * (1.0 + 1e-7 * draw(i)),
        "score only": lambda p, i: p + step_size * batched_score(p, data),
        "phi only": lambda p, i: p + step_size * phi1(p, p),
        FULL: lambda p, i: p + step_size * phi1(p, batched_score(p, data)),
    }


def chain_sweep(body, particles: torch.Tensor, chains: Sequence[int], samples: int = 3,
                iters: int = CHAIN_DISPATCH, clock=time.perf_counter) -> list:
    """For each chain length, the best of ``samples`` fenced samples of
    that many chained dispatches of ``iters`` steps: the total, the wall a
    dispatch, the particle-updates a second and, from the second length on,
    the marginal cost of a dispatch against the previous length."""
    run = dispatch(body, iters)
    fence(run(particles))
    n = particles.shape[0]
    rows, prev = [], None
    for chain in chains:
        best = float("inf")
        for _ in range(samples):
            out = particles
            t0 = clock()
            for _ in range(chain):
                out = run(out)
            fence(out)
            best = min(best, clock() - t0)
        row = {"chain": chain, "total_ms": best * 1e3, "ms_per_dispatch": best / chain * 1e3,
               "updates_per_s": n * iters / (best / chain)}
        if prev is not None:
            row["marginal_ms_per_dispatch"] = marginal_ms(prev, (chain, best))
        rows.append(row)
        prev = (chain, best)
    return rows


def marginal_ms(prev, cur) -> float:
    """The marginal ms a dispatch between two ``(chain, total seconds)``
    samples: the fixed cost of a fenced sample cancels."""
    return (cur[1] - prev[1]) / (cur[0] - prev[0]) * 1e3


def _trace_dir(trace: Optional[str], section: str) -> Optional[str]:
    return os.path.join(trace, section) if trace else None


def floor_rows(n: int = 100, reps: int = 3, dispatch_lengths: Sequence[int] = DISPATCH_LENGTHS,
               chains: Sequence[int] = CHAINS, samples: int = 3, trace: Optional[str] = None,
               device=None, particles=None, chain_dispatch: int = CHAIN_DISPATCH) -> dict:
    """The floor's composition at config 1 and the chain-length sweep;
    prints JAX's lines and returns them as a dict.  ``particles`` (default:
    ``init_particles(0, n, d)``) fixes the start."""
    dev = resolve_device(device)
    p0, data = config1(n, dev, particles)
    n, d = p0.shape
    bodies = floor_bodies(data)
    print(f"\nconfig-1 shape: n={n}, d={d}, rows={data[0].shape[0]}", flush=True)
    print(f"{'body':26s} " + "".join(f"{k:>10d}it" for k in dispatch_lengths), flush=True)
    per_step: Dict[str, Dict[int, float]] = {}
    with profiler_trace(_trace_dir(trace, "bodies")):
        for name, body in bodies.items():
            walls = {L: timed_dispatch(body, p0, L, reps, samples) / L * 1e3
                     for L in dispatch_lengths}
            per_step[name] = walls
            print(f"{name:26s} " + "".join(f"{w:11.4f}" for w in walls.values())
                  + "   ms/step", flush=True)

    longest = dispatch_lengths[-1]
    print(f"\nper-iteration composition at the {longest}-iter dispatch:", flush=True)
    base = per_step[EMPTY][longest]
    composition = {}
    for name, walls in per_step.items():
        v = walls[longest]
        composition[name] = {"ms_per_step": v, "over_empty_ms": v - base}
        print(f"  {name:26s} {v:8.4f} ms/step  (+{v - base:7.4f} over empty)", flush=True)

    print(f"\nchain-length sweep, full {chain_dispatch}-step config-1 dispatches:", flush=True)
    with profiler_trace(_trace_dir(trace, "chain")):
        sweep = chain_sweep(bodies[FULL], p0, chains, samples, chain_dispatch)
    for row in sweep:
        line = (f"  chain={row['chain']:4d}: {row['total_ms']:9.1f} ms total, "
                f"{row['ms_per_dispatch']:8.3f} ms/dispatch, "
                f"{row['updates_per_s']:12.0f} up/s")
        if "marginal_ms_per_dispatch" in row:
            line += f"   marginal {row['marginal_ms_per_dispatch']:7.3f} ms/dispatch"
        print(line, flush=True)
    return {"n": n, "d": d, "rows": int(data[0].shape[0]), "device": str(dev),
            "dispatch_lengths": list(dispatch_lengths), "ms_per_step": per_step,
            "composition": composition, "chain_dispatch": chain_dispatch, "chain": sweep}


def donate_ab(n: int, iters: int = CHAIN_DISPATCH, chain: int = 32, samples: int = 3,
              seed: int = 0, device=None, particles=None) -> dict:
    """Two ``Sampler`` schedules, ``donate_carries`` on then off, each an
    untimed run and ``samples`` samples of ``chain`` chained runs of
    ``iters`` steps from the previous run's particles; JAX's row keys, with
    the two walls, their ratio and whether the final particles agree
    bitwise.  The flag decides only where the update is written (module
    docstring)."""
    dev = resolve_device(device)
    p0, data = config1(n, dev, particles, seed)
    n, d = p0.shape
    walls, finals = {}, {}
    for donate in (True, False):
        s = Sampler(d, logreg_logp, data=data, device=dev, donate_carries=donate)
        out, _ = s.run(n, iters, STEP_SIZE, seed=seed, record=False, initial_particles=p0)
        best = float("inf")
        for _ in range(samples):
            t0 = time.perf_counter()
            for _ in range(chain):
                out, _ = s.run(n, iters, STEP_SIZE, seed=seed, record=False,
                               initial_particles=out)
            fence(out)
            best = min(best, (time.perf_counter() - t0) / chain)
        walls[donate] = best
        finals[donate] = out.cpu()
    return {
        "bench": "donate_ab", "n": n, "iters_per_dispatch": iters, "chain": chain,
        "donated_ms_per_dispatch": round(walls[True] * 1e3, 4),
        "undonated_ms_per_dispatch": round(walls[False] * 1e3, 4),
        "speedup": round(walls[False] / walls[True], 4),
        "bitwise_equal": bool(torch.equal(finals[True], finals[False])),
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=100)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--samples", type=int, default=3,
                    help="fenced samples a timing (the best is kept)")
    ap.add_argument("--dispatch-lengths", type=int, nargs="+", default=list(DISPATCH_LENGTHS),
                    help="steps a dispatch of the composition (the last is the asymptote)")
    ap.add_argument("--chains", type=int, nargs="+", default=list(CHAINS),
                    help="chain lengths of the sweep")
    ap.add_argument("--chain-dispatch", type=int, default=CHAIN_DISPATCH,
                    help="steps a dispatch of the chain sweep and of --donate-ab")
    ap.add_argument("--trace", default=None, metavar="DIR",
                    help="capture a torch.profiler trace of the measured sections into "
                         "DIR/bodies and DIR/chain (Chrome's format); off when omitted")
    ap.add_argument("--donate-ab", action="store_true",
                    help="run the donate_carries on/off A/B (identical schedules) and "
                         "pin the final states bitwise; skips the floor decomposition")
    ap.add_argument("--device", default=None,
                    help="'cpu' for the plain path; default: the card (raises without CUDA)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if args.donate_ab:
        row = donate_ab(args.n, args.chain_dispatch, samples=args.samples, device=dev)
        print(json.dumps(row), flush=True)
        if not row["bitwise_equal"]:
            raise SystemExit("donate_carries changed the numerics — bug")
        return row
    print("devices:", describe_device(dev), flush=True)
    return floor_rows(args.n, args.reps, args.dispatch_lengths, args.chains, args.samples,
                      args.trace, dev, chain_dispatch=args.chain_dispatch)


if __name__ == "__main__":
    main()
