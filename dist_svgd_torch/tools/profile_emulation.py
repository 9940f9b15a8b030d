"""Isolate the one-card emulation penalty of the sharded step.

Counterpart of ``tools/profile_emulation.py``.  The 8-shard
``all_particles`` north star runs its shards as lanes of one process on the
one card, where the unsharded step does the same work as one lane: each
lane scores all n particles on 1/S of the data rows, and the φ pairs tile
to the same n².  This tool times hand-built variants of the step at
N = 10,000 particles over S = 8 lanes (``--n``, ``--shards``) to find where
the emulated step's time goes (JAX's letters; vmap's lanes are the port's
leading lane axis):

- **A** — the unsharded step: scores of all n on all rows, one φ call;
- **B** — the emulated ``all_particles`` step, built by
  ``parallel/exchange.py:make_shard_step`` as ``DistSampler`` builds it
  (``_build_core``'s gather path: one lane-batched score call, one φ call
  over the ``(S, n/S, d)`` blocks);
- **B2** — B with the ``'torch'`` φ (``ops/svgd.py``);
- **C** — the lanes' scores stacked, then S φ calls, one a lane, unrolled;
- **D** — the lanes' scores outside, then one lane-batched φ call;
- **E** — ``all_scores`` specialised: the lanes' scores summed (the psum),
  one global φ call, the unsharded step's arithmetic with lane-sliced
  scores;
- **F** — D's step with the φ kernel's m-split pinned at
  :data:`F_BLOCKS_PER_SM` blocks an SM instead of ``phi_small_d``'s own 32
  (``ops/cuda_svgd.py:launch``, the counterpart of ``phi_pallas``'s
  ``block_k``/``block_m``; no sampler path passes a split).

Each variant is one dispatch of ``--iters`` steps in a Python loop, timed
as JAX's ``timed_scan`` (``step_timing.timed_dispatch``): one untimed
dispatch and fence, then ``--reps`` chained dispatches under one fence.
Each row prints M up/s and the wall of a dispatch.

Usage (the card unless ``--device cpu``)::

    python -m dist_svgd_torch.tools.profile_emulation [--iters 100]
    python -m dist_svgd_torch.tools.profile_emulation --device cpu --n 64 --shards 4 \\
        --iters 2 --reps 1
"""

from __future__ import annotations

import argparse
from typing import Callable, Dict, Tuple

import torch

from dist_svgd_torch.models.logreg import logreg_logp
from dist_svgd_torch.ops import cuda_svgd
from dist_svgd_torch.ops.cuda_svgd import resolve_phi_fn
from dist_svgd_torch.ops.kernels import RBF
from dist_svgd_torch.parallel.exchange import ALL_PARTICLES, make_shard_step, stack_shards
from dist_svgd_torch.tools.step_timing import describe_device, timed_dispatch
from dist_svgd_torch.utils.datasets import load_benchmark
from dist_svgd_torch.utils.platform import resolve_device
from dist_svgd_torch.utils.rng import init_particles_per_shard

N = 10_000
S = 8
STEP_SIZE = 3e-3

#: F's pinned m-split target of blocks an SM.  ``phi_small_d``'s own is 32
#: (``SD_BLOCKS_PER_SM``); at the 8 × 1250 × 10,000 lanes on a 132-SM H100
#: the default takes 40 m-chunks of 256 columns and this one 20 of 512.
F_BLOCKS_PER_SM = 4

VARIANTS = ("A:unsharded", "B:lanes_all_particles", "B2:lanes_torch_phi", "C:unrolled_phi",
            "D:lanes_scores_outside", "E:all_scores_special", "F:lanes_split_bps4")


def phi_launches(shards: int) -> Dict[str, int]:
    """Hand-kernel φ launches a step of each variant on the card (d = 3:
    ``'auto'`` launches ``phi_small_d`` on every call)."""
    return {"A:unsharded": 1, "B:lanes_all_particles": 1, "B2:lanes_torch_phi": 0,
            "C:unrolled_phi": shards, "D:lanes_scores_outside": 1,
            "E:all_scores_special": 1, "F:lanes_split_bps4": 1}


def pinned_phi(y: torch.Tensor, x: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """``phi_small_d`` at h = 1 with its m-split pinned at
    :data:`F_BLOCKS_PER_SM` (its plain version on CPU tensors)."""
    return cuda_svgd.launch("phi_small_d", y.contiguous(), x.contiguous(), s.contiguous(),
                            1.0, blocks_per_sm=F_BLOCKS_PER_SM)


def build_variants(n: int = N, shards: int = S, device=None, particles=None,
                   step_size: float = STEP_SIZE
                   ) -> Tuple[torch.Tensor, Dict[str, Callable[[torch.Tensor, int], torch.Tensor]]]:
    """``(P0, {name: step(P, i) -> P'})``: the start (``particles``, default
    the per-shard draw of ``n`` from seed 0) and the seven variants on the
    banana fold 42's training rows, cut to a multiple of ``shards`` and cast
    to the particles' dtype, the importance scale ``shards``."""
    dev = resolve_device(device)
    fold = load_benchmark("banana", 42)
    d = 1 + fold.x_train.shape[1]
    if particles is None:
        particles = init_particles_per_shard(0, n, d, shards)
    p0 = torch.as_tensor(particles, device=dev)
    n = p0.shape[0]
    rows = (fold.x_train.shape[0] // shards) * shards
    x = torch.as_tensor(fold.x_train[:rows], device=dev, dtype=p0.dtype)
    t = torch.as_tensor(fold.t_train.reshape(-1)[:rows], device=dev, dtype=p0.dtype)
    rows_per = rows // shards
    scale = float(shards)
    eps = step_size
    kernel = RBF(1.0)
    phi_auto = resolve_phi_fn(kernel, "auto")
    score = torch.func.vmap(torch.func.grad(logreg_logp), in_dims=(0, None))
    lane_scores = torch.func.vmap(score, in_dims=(None, 0))  # (S, n, d): each lane its rows
    stacked = stack_shards((x, t), shards, rows_per)
    sampler_step = {
        impl: make_shard_step(logreg_logp, kernel, ALL_PARTICLES, shards, scale,
                              phi_impl=impl, n_local_data=rows_per)
        for impl in ("auto", "torch")}

    def blocks_of(P):
        return P.reshape(shards, n // shards, d)

    def unsharded(P, i):
        return P + eps * phi_auto(P[None], P, score(P, (x, t))[None])[0]

    def sampler(impl):
        def step(P, i):
            return sampler_step[impl](blocks_of(P), stacked, i + 1, eps).reshape(n, d)
        return step

    def unrolled(P, i):
        scores = scale * lane_scores(P, stacked)
        blocks = blocks_of(P)
        return torch.cat([blocks[r] + eps * phi_auto(blocks[r][None], P, scores[r][None])[0]
                          for r in range(shards)])

    def scores_outside(phi_fn):
        def step(P, i):
            blocks = blocks_of(P)
            return (blocks + eps * phi_fn(blocks, P, scale * lane_scores(P, stacked))
                    ).reshape(n, d)
        return step

    def all_scores(P, i):
        return P + eps * phi_auto(P[None], P, lane_scores(P, stacked).sum(0)[None])[0]

    fns = (unsharded, sampler("auto"), sampler("torch"), unrolled, scores_outside(phi_auto),
           all_scores, scores_outside(pinned_phi))
    return p0, dict(zip(VARIANTS, fns))


def emulation_rows(n: int = N, shards: int = S, iters: int = 100, reps: int = 3,
                   device=None, particles=None) -> dict:
    """Every variant timed in JAX's order; prints JAX's lines and returns
    ``{"n", "shards", "iters", "variants": {name: {"updates_per_s",
    "wall_s"}}}`` (on the card also F's split against the default's)."""
    dev = resolve_device(device)
    p0, variants = build_variants(n, shards, dev, particles)
    out = {"n": p0.shape[0], "shards": shards, "iters": iters, "reps": reps,
           "device": str(dev), "variants": {}}
    for name, step in variants.items():
        wall = timed_dispatch(step, p0, iters, reps, samples=1)  # JAX's one sample
        ups = p0.shape[0] * iters / wall
        out["variants"][name] = {"updates_per_s": ups, "wall_s": wall}
        print(name, (ups, wall), flush=True)
    if dev.type == "cuda":
        S_, k, m = shards, p0.shape[0] // shards, p0.shape[0]
        out["f_split"] = {
            "blocks_per_sm": F_BLOCKS_PER_SM,
            "m_splits": cuda_svgd.split_count("phi_small_d", S_, k, m, dev, F_BLOCKS_PER_SM),
            "default_blocks_per_sm": cuda_svgd.blocks_per_sm("phi_small_d"),
            "default_m_splits": cuda_svgd.split_count("phi_small_d", S_, k, m, dev)}
    print(flush=True)
    for name, row in out["variants"].items():
        print(f"{name:28s} {row['updates_per_s'] / 1e6:8.2f} M up/s   "
              f"wall {row['wall_s']:.3f}s", flush=True)
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=100)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--n", type=int, default=N)
    ap.add_argument("--shards", type=int, default=S)
    ap.add_argument("--device", default=None,
                    help="'cpu' for the plain path; default: the card (raises without CUDA)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    print("devices:", describe_device(dev), flush=True)
    return emulation_rows(args.n, args.shards, args.iters, args.reps, dev)


if __name__ == "__main__":
    main()
