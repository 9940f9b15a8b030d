"""One rank of the multi-process training drill
(``dist_svgd_torch/tools/multihost_train.py --mode real``).

Counterpart of ``tools/multihost_worker.py``.  Invoked as::

    python -m dist_svgd_torch.tools.multihost_worker --rank R --nprocs W \\
        --coordinator HOST:PORT --root DIR [--devcount K] [--resume] \\
        [--device cpu] [--backend gloo|nccl] ...

with the checkout on ``PYTHONPATH``.  The worker joins the
``torch.distributed`` group (``parallel/multihost.py:initialize``, which
refuses up front what :func:`~dist_svgd_torch.parallel.multihost.
multiprocess_gap` refuses: exit 3), builds the granule-major particle mesh
of ``W·K`` shards (``--devcount`` K shards a process, JAX's devices a
process) and drives the drill's ``DistSampler`` — the GMM posterior,
``all_particles``, no W2 term — in ``--checkpoint-every``-step segments on
the absolute step grid, saving ONLY its own block each segment
(``state_dict``'s per-process blocks) to ``<root>/step_<t>/rank_<r>``.

``--resume`` is the elastic path: the newest COMPLETE step save (every rank
file of the federation that wrote it — its manifest's
``topo_process_count`` says how many) is assembled
(``utils/checkpoint.py:assemble_full_state``), resharded to this
federation's shard count (``reshard_state``) and loaded; no complete save
exits 4.  ``--hold-at T`` parks the rank after its step-T save until
``<root>/release`` appears, so a launcher can kill a rank at a known step
(the hold ends after :data:`HOLD_TIMEOUT_S` without one).

At the end it writes ``final_rows_<r>.npy`` and ``done_rank<r>.json``
(JAX's keys, plus the backend, the device, the φ launches of its steps, the
mesh's collectives and its host-staged bytes).  The device is the card
(``cuda:(rank mod cards)``) unless ``--device cpu``; the backend NCCL on the
card and gloo on the CPU unless ``--backend`` names one.
"""

import argparse
import glob
import json
import os
import re
import sys
import time


#: Longest a ``--hold-at`` rank waits for its release or its kill.
HOLD_TIMEOUT_S = 300.0


def drill_init(n: int, seed: int):
    """The drill's initial particles: one seeded ``(n, 2)`` float32 draw that
    every process makes in full and slices (JAX's worker's)."""
    import numpy as np

    return np.random.default_rng(seed).normal(size=(n, 2)).astype(np.float32)


def latest_complete_save(root: str):
    """Newest ``step_<t>`` directory whose rank files are complete for the
    federation that wrote it: ``(t, [rank paths])``, or ``None``."""
    from dist_svgd_torch.utils.checkpoint import load_state, read_manifest

    best = None
    for d in glob.glob(os.path.join(root, "step_*")):
        m = re.match(r"^step_(\d+)$", os.path.basename(d))
        if not m:
            continue
        ranks = sorted(p for p in glob.glob(os.path.join(d, "rank_*"))
                       if not p.endswith(".tmp"))
        if not ranks:
            continue
        try:
            man = read_manifest(load_state(ranks[0]))
        except (OSError, ValueError):
            continue  # a rank died mid-save
        if man is None or len(ranks) != man["process_count"]:
            continue
        t = int(m.group(1))
        if best is None or t > best[0]:
            best = (t, ranks)
    return best


def _hold(root: str, rank: int) -> None:
    open(os.path.join(root, f"held_rank{rank}"), "w").close()
    deadline = time.monotonic() + HOLD_TIMEOUT_S
    while not os.path.exists(os.path.join(root, "release")) and time.monotonic() < deadline:
        time.sleep(0.05)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m dist_svgd_torch.tools.multihost_worker",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--nprocs", type=int, required=True)
    ap.add_argument("--coordinator", required=True)
    ap.add_argument("--root", required=True)
    ap.add_argument("--devcount", type=int, default=2, help="shards a process")
    ap.add_argument("--n", type=int, default=288)
    ap.add_argument("--steps", type=int, default=24)
    ap.add_argument("--checkpoint-every", type=int, default=8)
    ap.add_argument("--step-size", type=float, default=0.05)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--exchange-impl", choices=("gather", "ring"), default="gather")
    ap.add_argument("--resume", action="store_true",
                    help="resume from the newest complete per-rank save (assemble + "
                         "reshard to this federation's size)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default=None,
                    help="default: the card (cuda:(rank mod cards))")
    ap.add_argument("--backend", choices=("nccl", "gloo"), default=None,
                    help="default: nccl on the card, gloo on the CPU")
    ap.add_argument("--hold-at", type=int, default=None,
                    help="after the step-T save, wait for <root>/release")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from dist_svgd_torch import DistSampler
    from dist_svgd_torch.models.gmm import gmm_logp
    from dist_svgd_torch.ops import cuda_svgd
    from dist_svgd_torch.parallel import multihost
    from dist_svgd_torch.utils.checkpoint import (
        assemble_full_state,
        read_manifest,
        reshard_state,
        save_state,
    )

    if args.device == "cpu":
        torch.set_num_threads(1)
    gap = multihost.multiprocess_gap(args.nprocs, args.backend, args.device)
    if gap is not None:  # the launcher refuses earlier; a worker checks again
        print(f"multihost_worker: {gap}", file=sys.stderr)
        return 3
    multihost.initialize(args.coordinator, args.nprocs, args.rank, backend=args.backend,
                         device=args.device)
    try:
        mesh = multihost.make_particle_mesh(args.nprocs * args.devcount, device=args.device)
        n = args.n
        start, count = multihost.process_local_rows(n, mesh)
        particles = multihost.make_global_particles(
            drill_init(n, args.seed)[start:start + count], mesh, n_global=n)
        ds = DistSampler(mesh.num_shards, lambda th, _: gmm_logp(th), None, particles,
                         exchange_particles=True, exchange_scores=False,
                         include_wasserstein=False, exchange_impl=args.exchange_impl,
                         mesh=mesh)
        if args.resume:
            found = latest_complete_save(args.root)
            if found is None:
                print(f"multihost_worker: --resume but no complete save under {args.root}",
                      file=sys.stderr)
                return 4
            state = assemble_full_state(found[1])
            if read_manifest(state)["n_shards"] != mesh.num_shards:
                state = reshard_state(state, mesh.num_shards)
            ds.load_state_dict(state)
        resumed_from = ds.t

        on_card = ds.device.type == "cuda"
        cuda_svgd.reset_launch_counts()
        mesh.reset_counts()
        step_walls = []
        while ds.t < args.steps:
            seg = min(args.checkpoint_every, args.steps - ds.t)
            w0 = time.perf_counter()
            ds.run_steps(seg, args.step_size)
            if on_card:
                torch.cuda.synchronize(ds.device)
            step_walls.append((time.perf_counter() - w0) / seg)
            save_state(os.path.join(args.root, f"step_{ds.t}", f"rank_{args.rank}"),
                       ds.state_dict())
            if args.hold_at is not None and ds.t == args.hold_at:
                _hold(args.root, args.rank)

        rows, r_start = multihost.host_addressable_block(ds.particles)
        np.save(os.path.join(args.root, f"final_rows_{args.rank}.npy"), rows)
        steps_run = ds.t - resumed_from
        with open(os.path.join(args.root, f"done_rank{args.rank}.json"), "w") as fh:
            json.dump({
                "rank": args.rank,
                "nprocs": args.nprocs,
                "t": int(ds.t),
                "resumed_from": int(resumed_from),
                "row_start": int(r_start),
                "rows": int(rows.shape[0]),
                "step_wall_s": float(np.median(step_walls)) if step_walls else None,
                "updates_per_s": (float(n / np.median(step_walls)) if step_walls else None),
                "dcn_crossings_per_hop": multihost.dcn_boundary_crossings(mesh),
                "backend": mesh.backend,
                "device": str(ds.device),
                "phi_launches": dict(cuda_svgd.launch_counts),
                "steps_run": int(steps_run),
                "mesh_counts": mesh.counts(),
            }, fh)
    finally:
        multihost.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
