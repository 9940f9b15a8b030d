"""Elastic-capacity drill: device-loss → reshard → resume → serve, emitting
ONE ``elastic_resume`` JSON row.

Counterpart of ``tools/elastic_drill.py`` (same phases, same row keys).  The
fault drill (``tools/fault_drill.py``) measures recovery at the SAME
topology; this one measures losing a device and coming back on a *smaller*
layout instead of dying with the restart budget.  Phases (the GMM posterior,
d = 2; every fault is injected through ``resilience/faults.py``):

1. **baseline** — a supervised, checkpointed run at ``shards_from`` to
   completion (after an untimed warm-up), with posterior diagnostics at the
   checkpoint cadence: the reference trajectory and its final KSD/ESS;
2. **shrink** — the same run with an injected ``MeshShrinkAt`` mid-way
   between checkpoints: the supervisor's ``ReshardPolicy`` reshards the
   latest checkpoint to ``shards_to`` (``utils/checkpoint.py:
   reshard_state``) and continues inside the restart budget.  The row
   records **steps lost** (replayed since the last checkpoint), **reshard
   wall** (restore + reshard + rebuild + load) and **recovery wall**
   (reshard + backoff + replay to the detection step), the post-reshard
   KSD/ESS deltas and the max particle deviation from the baseline;
3. **steady state** — a continuation run on the resharded sampler under
   ``parallel/plan.py:capture_sentry``: at the new layout, steady-state
   segments must capture no CUDA graph and build no kernel
   (``post_reshard_recompiles``);
4. **grow** — the recovery direction: a ``shards_grow_from``-shard run hit
   by ``MeshGrowAt`` back to ``shards_from``, held against its own
   uninterrupted baseline;
5. **fallback** — a shrink to a shard count that does NOT divide n takes
   ``reshard_state``'s replicate-and-warn fallback (the run lands at 1
   shard, correct but undistributed) instead of crashing;
6. **serve** — ``PredictiveEngine.from_checkpoint`` cold-starts from the
   post-reshard manager root and must serve finite predictions from the
   full ensemble.

Usage (the card unless ``--device cpu``)::

    python -m dist_svgd_torch.tools.elastic_drill            # n=2048, 8 -> 4, 48 steps
    python -m dist_svgd_torch.tools.elastic_drill --device cpu --n 64 --steps 12 \\
        --checkpoint-every 4 --segment-steps 2
"""

import argparse
import json
import os
import sys
import tempfile
import time
import warnings

import numpy as np

from dist_svgd_torch.parallel.plan import capture_sentry
from dist_svgd_torch.resilience import (
    FaultPlan,
    MeshGrowAt,
    MeshShrinkAt,
    ReshardPolicy,
    RunSupervisor,
)
from dist_svgd_torch.serving.engine import PredictiveEngine
from dist_svgd_torch.telemetry import MetricsRegistry
from dist_svgd_torch.telemetry.diagnostics import DiagnosticsConfig, PosteriorDiagnostics
from dist_svgd_torch.tools.fault_drill import build_sampler, gmm_score_fn
from dist_svgd_torch.utils.platform import resolve_device


def _delta_frac(a, b):
    if a is None or b is None:
        return None
    return round(abs(b - a) / max(abs(a), 1e-12), 6)


def _host(t):
    return t.detach().cpu().numpy()


def run_drill(n=2048, shards_from=8, shards_to=4, num_steps=48,
              step_size=0.05, checkpoint_every=16, segment_steps=4,
              reshard_step=None, shards_grow_from=2, fallback_to=None,
              reshard_tol=1e-4, root=None, seed=0, device=None):
    """Run the six drill phases; returns the ``elastic_resume`` row."""
    dev = resolve_device(device)
    if root is None:
        root = tempfile.mkdtemp(prefix="elastic_drill_")
    if reshard_step is None:
        # strictly between two checkpoints, like fault_drill's kill step:
        # the interesting case, where the reshard actually replays steps
        reshard_step = 2 * checkpoint_every + segment_steps
    if reshard_step >= num_steps:
        raise ValueError(
            f"reshard_step ({reshard_step}) must land before num_steps "
            f"({num_steps}) or the topology fault never fires"
        )
    if fallback_to is None:
        # smallest count > 1 that does not divide n (3 at the n=2048 default)
        fallback_to = next(m for m in range(2, n + 2) if n % m)

    registry = MetricsRegistry()
    diag = PosteriorDiagnostics(
        DiagnosticsConfig(every_steps=checkpoint_every,
                          score_fn=gmm_score_fn(),
                          row_chunk=512, max_points=512),
        registry=registry,
    )

    def factory(num_shards):
        return build_sampler(n, num_shards, seed, dev)

    def supervise(sampler, steps, **kw):
        kw.setdefault("segment_steps", segment_steps)
        kw.setdefault("sleep", lambda s: None)  # injected faults only
        kw.setdefault("registry", registry)
        return RunSupervisor(sampler, steps, step_size, **kw)

    # -------- phase 1: baseline at shards_from ------------------------- #
    ds = factory(shards_from)
    state0 = ds.state_dict()
    supervise(ds, num_steps, manager=None, diagnostics=diag).run()  # warm-up
    ds.load_state_dict(state0)
    sup_b = supervise(ds, num_steps, checkpoint_dir=os.path.join(root, "base"),
                      checkpoint_every=checkpoint_every, diagnostics=diag)
    base = sup_b.run()
    final_baseline = _host(sup_b.particles)
    step_wall_s = base["segment_wall_s"] / max(base["steps_run"], 1)
    diag_b = base["last_diagnostics"] or {}

    # -------- phase 2: shrink mid-run ---------------------------------- #
    ds2 = factory(shards_from)
    elastic_dir = os.path.join(root, "elastic")
    sup_e = supervise(ds2, num_steps, checkpoint_dir=elastic_dir,
                      checkpoint_every=checkpoint_every, diagnostics=diag,
                      reshard=ReshardPolicy(factory),
                      faults=FaultPlan(MeshShrinkAt(reshard_step, shards_to)))
    elastic = sup_e.run()
    if elastic["reshards"] != 1:
        raise RuntimeError(f"the shrink did not reshard once: {elastic}")
    event = elastic["reshard_events"][0]
    final_elastic = _host(sup_e.particles)
    max_dev = float(np.abs(final_baseline - final_elastic).max())
    diag_e = elastic["last_diagnostics"] or {}
    # the replicated hyperparameters must survive the reshard bitwise:
    # step counter, (possibly backed-off) step size, minibatch stream seed,
    # resolved W2 pairing code — everything the row's name promises
    st_b, st_e = sup_b._harness.state_dict(), sup_e._harness.state_dict()
    hyper_bitwise = (
        elastic["t"] == base["t"]
        and sup_e.step_size == sup_b.step_size
        and np.array_equal(st_b["rng_batch_seed"], st_e["rng_batch_seed"])
        and np.array_equal(st_b["w2_pairing"], st_e["w2_pairing"])
    )

    # -------- phase 3: post-reshard steady state (capture sentry) ------ #
    # the resharded sampler's kernels were built before phase 2's replay —
    # further segments at the new layout must capture and build nothing
    sup_c = supervise(sup_e.sampler, num_steps + 2 * segment_steps,
                      manager=None)
    with capture_sentry("post-reshard steady state") as sentry:
        cont = sup_c.run()
    if cont["status"] != "completed":
        raise RuntimeError(f"the post-reshard continuation failed: {cont}")

    # -------- phase 4: grow back --------------------------------------- #
    grow_steps = max(2 * checkpoint_every, 4 * segment_steps)
    grow_at = max(checkpoint_every // 2 + 1, segment_steps)
    gs = factory(shards_grow_from)
    sup_g0 = supervise(gs, grow_steps,
                       checkpoint_dir=os.path.join(root, "grow_base"),
                       checkpoint_every=checkpoint_every)
    sup_g0.run()
    gs2 = factory(shards_grow_from)
    sup_g = supervise(gs2, grow_steps,
                      checkpoint_dir=os.path.join(root, "grow"),
                      checkpoint_every=checkpoint_every,
                      reshard=ReshardPolicy(factory),
                      faults=FaultPlan(MeshGrowAt(grow_at, shards_from)))
    grow = sup_g.run()
    grow_dev = float(np.abs(_host(sup_g0.particles) - _host(sup_g.particles)).max())
    grow_ok = (grow["num_shards"] == shards_from and grow["reshards"] == 1
               and grow_dev <= reshard_tol)

    # -------- phase 5: non-dividing fallback --------------------------- #
    fs = factory(shards_from)
    sup_f = supervise(fs, grow_steps,
                      checkpoint_dir=os.path.join(root, "fallback"),
                      checkpoint_every=checkpoint_every,
                      reshard=ReshardPolicy(factory),
                      faults=FaultPlan(MeshShrinkAt(grow_at, fallback_to)))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        fb = sup_f.run()
    fallback_warned = any("replicating instead of sharding" in str(w.message)
                          for w in caught)
    fallback_ok = (fb["status"] == "completed" and fb["num_shards"] == 1
                   and fallback_warned)

    # -------- phase 6: serve from the post-reshard checkpoint ---------- #
    serve_wall0 = time.perf_counter()
    engine = PredictiveEngine.from_checkpoint(elastic_dir, model="gmm", device=dev)
    out = engine.predict(final_elastic[:8])
    serve_wall_s = time.perf_counter() - serve_wall0
    serve_ok = (engine.n_particles == n
                and engine.checkpoint_step == num_steps
                and bool(np.isfinite(out["log_density"]).all()))

    recovery_wall = event.get("recovery_wall_s")
    reshards = registry.counter("svgd_elastic_reshards_total")
    return {
        "metric": "elastic_resume",
        "platform": "gpu" if dev.type == "cuda" else "cpu",
        "n": n,
        "shards_from": shards_from,
        "shards_to": event["to_shards"],
        "num_steps": num_steps,
        "checkpoint_every": checkpoint_every,
        "segment_steps": segment_steps,
        "reshard_step": event["t_detected"],
        "resumed_from": event["resumed_from"],
        "steps_lost": event["steps_lost"],
        "step_wall_ms": round(step_wall_s * 1e3, 3),
        "reshard_wall_s": event["reshard_wall_s"],
        "recovery_wall_s": recovery_wall,
        "recovery_vs_step_wall": (
            round(recovery_wall / max(step_wall_s, 1e-9), 1)
            if recovery_wall is not None else None),
        "elastic_final_max_dev": max_dev,
        "resumed_within_tolerance": bool(max_dev <= reshard_tol),
        "hyperparams_bitwise": bool(hyper_bitwise),
        "ksd_baseline": diag_b.get("ksd"),
        "ksd_elastic": diag_e.get("ksd"),
        "ksd_delta_frac": _delta_frac(diag_b.get("ksd"), diag_e.get("ksd")),
        "ess_frac_baseline": diag_b.get("ess_frac"),
        "ess_frac_elastic": diag_e.get("ess_frac"),
        "ess_frac_delta": _delta_frac(diag_b.get("ess_frac"),
                                      diag_e.get("ess_frac")),
        # the port's sentry counts CUDA-graph captures and hand-kernel
        # builds where JAX's counts XLA compiles
        "post_reshard_recompiles": sentry.compiles,
        "sentry_supported": sentry.supported,
        "grow_from": shards_grow_from,
        "grow_to": shards_from,
        "grow_max_dev": grow_dev,
        "grow_ok": bool(grow_ok),
        "fallback_requested": fallback_to,
        "fallback_to_shards": fb["num_shards"],
        "fallback_warned": bool(fallback_warned),
        "fallback_ok": bool(fallback_ok),
        "serve_wall_s": round(serve_wall_s, 4),
        "serve_ok": bool(serve_ok),
        "restarts": elastic["restarts"],
        "elastic_reshards_total": reshards.value(direction="shrink")
        + reshards.value(direction="grow"),
        "elastic_steps_lost_total": registry.counter(
            "svgd_elastic_steps_lost_total").value(),
    }


def drill_ok(row) -> bool:
    """The drill's own acceptance: exact-enough resume, clean steady state,
    both directions, graceful fallback, serving from the resharded save."""
    return bool(
        row["resumed_within_tolerance"]
        and row["hyperparams_bitwise"]
        and (not row["sentry_supported"] or row["post_reshard_recompiles"] == 0)
        and row["grow_ok"]
        and row["fallback_ok"]
        and row["serve_ok"]
    )


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m dist_svgd_torch.tools.elastic_drill",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=2048)
    ap.add_argument("--shards-from", type=int, default=8)
    ap.add_argument("--shards-to", type=int, default=4)
    ap.add_argument("--steps", type=int, default=48)
    ap.add_argument("--stepsize", type=float, default=0.05)
    ap.add_argument("--checkpoint-every", type=int, default=16)
    ap.add_argument("--segment-steps", type=int, default=4)
    ap.add_argument("--reshard-step", type=int, default=None)
    ap.add_argument("--grow-from", type=int, default=2)
    ap.add_argument("--fallback-to", type=int, default=None,
                    help="non-dividing shard target for the fallback phase "
                         "(default: smallest count > 1 that doesn't divide n)")
    ap.add_argument("--tol", type=float, default=1e-4,
                    help="max particle deviation accepted vs the "
                         "never-resharded run (float accumulation-order "
                         "noise across shard counts; bitwise is not "
                         "expected, exactness is pinned by the tests)")
    ap.add_argument("--root", default=None,
                    help="checkpoint scratch root (default: a temp dir)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default=None,
                    help="default: the card (fails without CUDA)")
    args = ap.parse_args(argv)

    row = run_drill(
        n=args.n, shards_from=args.shards_from, shards_to=args.shards_to,
        num_steps=args.steps, step_size=args.stepsize,
        checkpoint_every=args.checkpoint_every,
        segment_steps=args.segment_steps, reshard_step=args.reshard_step,
        shards_grow_from=args.grow_from, fallback_to=args.fallback_to,
        reshard_tol=args.tol, root=args.root, device=args.device,
    )
    print(json.dumps(row), flush=True)
    return 0 if drill_ok(row) else 1


if __name__ == "__main__":
    sys.exit(main())
